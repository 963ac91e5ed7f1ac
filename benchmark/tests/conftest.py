"""Fixtures of the benchmark's tests (helpers in ``bench_fixtures.py``)."""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from bench_fixtures import BENCH, ROOT, add_tiny_cell


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark folder with the tiny
    cell added; returns the copy's root."""

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cell(tmp_path)
    return tmp_path


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
