"""No run loads JAX, flax or the JAX package (top-level names compared
whole), the reference and the yardstick import nothing of the port, and the
entry refuses to run without a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from bench_fixtures import BENCH, ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    from harness.manifest import forbidden_loaded

    before = forbidden_loaded()
    for name in ("sparse_pooling_tpu_torch_extra", "jaxtyping", "flax_like.sub"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_loaded() == before
    monkeypatch.setitem(sys.modules, "sparse_pooling_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(forbidden_loaded()) - set(before) == {"sparse_pooling_tpu", "jaxlib"}


def _only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_yardstick_imports_nothing_of_the_program(tmp_path):
    """The reference, the judge, the counts, the traffic, every family file
    and every hand kernel's bound file."""

    root = _only_the_benchmark(tmp_path)
    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "import reference.pipeline, harness.judge, harness.flops, harness.roofline, harness.devtrace, traffic; "
            "import families; from harness.manifest import Cell; families.every(); Cell('rcnn-serve-b8').kernels(); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sparse_pooling_tpu_torch', 'sparse_pooling_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_program(tmp_path):
    root = _only_the_benchmark(tmp_path)
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "sys.exit(run.main(['--workload', 'rcnn-serve-b8', '--seed', '1', '--seconds', '1', '--trace', '0'], "
            "device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "sparse_pooling_tpu_torch" in out.stderr
    assert '"correct"' not in out.stdout


def test_entry_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rcnn-serve-b8", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    assert out.stdout == "" and "CUDA card" in out.stderr
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["command"] == ["python3", "benchmark/run.py"]
