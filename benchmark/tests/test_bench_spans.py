"""The program's spans in a traced run (``harness/spans.py``, read by
``run.py --trace 1``) rehearsed on the CPU at a tiny size: every span reading
of both families, and nothing where the program has no spans; the traced
run's other numbers read as they do without the spans."""

from __future__ import annotations

import json
import statistics

import pytest
import torch

from bench_fixtures import TINY, add_tiny_cell

READINGS = {"upload_ms.serve", "encode_ms.serve", "fusion_ms.serve", "rpn_nms_ms.serve", "stage2_ms.serve",
            "final_nms_ms.serve", "nms_round_us.serve", "nms_idle_share.serve"}
TREE = {"upload": None, "inputs": None, "detector": None, "detector.encode": "detector",
        "detector.fusion": "detector", "detector.rpn_nms": "detector", "detector.decode_maps": "detector",
        "detector.stage2": "detector", "decode": None, "decode.nms": "decode"}


def _without_spans(monkeypatch):
    """The program as it was before its spans: no ``profiling.span``, and
    the model modules' spans, bound at their import, no-ops."""

    import contextlib

    from sparse_pooling_tpu_torch.models import detector, fusion_rcnn, pipeline
    from sparse_pooling_tpu_torch.runtime import profiling

    monkeypatch.delattr(profiling, "span")
    for module in (detector, fusion_rcnn, pipeline):
        monkeypatch.setattr(module, "span", lambda _name: contextlib.nullcontext())


def _served(root, name=TINY, seed=3_000_000_019):
    """A traced run's data (``harness/serve.run``, as ``run.py`` gets it) and
    its cell."""

    from harness import serve
    from harness.manifest import Cell

    cell = Cell(name, root / "benchmark")
    torch.set_num_threads(1)
    return serve.run(cell, seed, 1.0, True, torch.device("cpu"), lambda: 0.0)["run"], cell


def _traced(root, capsys, name=TINY, seconds="1"):
    import run

    rc = run.main(["--workload", name, "--seed", "3000000007", "--seconds", seconds, "--trace", "1"],
                  device="cpu", bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("architecture", ["avod", "rcnn"])
def test_every_span_reading_of_both_families(bench_copy, architecture):
    name = TINY
    if architecture == "rcnn":
        name = "tiny-rcnn"
        add_tiny_cell(bench_copy, name=name, architecture="rcnn", limits_from="rcnn-serve-b8")
    run, cell = _served(bench_copy, name)
    got = {m: cell.reader(m)(run) for m in READINGS}
    assert READINGS <= {m["name"] for m in cell.per_layer()}
    assert all(v is not None and v >= 0 for v in got.values()), got
    spans = run["spans"]["collected"]["spans"]
    assert {k: v["parent"] for k, v in spans.items()} == TREE
    assert 0 < got["nms_idle_share.serve"] <= 100
    med = {k: statistics.median(v["device_ms"]) for k, v in spans.items()}
    parts = sum(got[f"{k}.serve"] for k in ("encode_ms", "fusion_ms", "rpn_nms_ms", "stage2_ms"))
    assert parts <= med["detector"]
    assert got["final_nms_ms.serve"] <= med["decode"]
    prof = run["spans"]["profiled"]
    assert sum(prof["launches"].values()) > 0 and prof["requests"] == cell.workload["profiled_requests"]
    assert statistics.median(run["spans"]["collected"]["latency_ms"]) > 0 < statistics.median(
        run["window"]["latency_ms"])
    assert run["window"]["stage_ms"] == {}  # CUDA events time the window's stages on a card alone


def test_a_program_without_spans_gives_no_reading(bench_copy, monkeypatch):
    with_spans, cell = _served(bench_copy)
    _without_spans(monkeypatch)
    without, _ = _served(bench_copy)
    assert all(cell.reader(m)(without) is None for m in READINGS)
    assert all(cell.reader(m)(with_spans) is not None for m in READINGS)
    assert without["spans"] == {"collected": None, "profiled": {}}
    assert statistics.median(without["window"]["latency_ms"]) > 0


def test_the_traced_run_reads_as_before(bench_copy, capsys, monkeypatch):
    """The benchmark's own ``--trace 1`` line is the same with the program's
    spans and without them (the parent program), its timings apart, and
    with them adds the span readings. A window of one request: the judge
    samples the same requests on both sides."""

    got = _traced(bench_copy, capsys, seconds="0")
    _without_spans(monkeypatch)
    parent = _traced(bench_copy, capsys, seconds="0")
    assert got["attempted"] == parent["attempted"] == 1
    assert set(got["metrics"]) - set(parent["metrics"]) == READINGS
    assert not READINGS & set(parent["metrics"]) and "mfu.serve" in parent["metrics"]
    # the judge's numbers, each beside its limit: the same sampled requests, the same outputs
    assert got["checks"] == parent["checks"] and got["checks"]
    assert set(got["breakdown"]) == set(parent["breakdown"]) == {"device_ops", "idle_gaps"}
    assert got["correct"] is parent["correct"] is True
    assert got["failed"] == parent["failed"] == 0
    assert got["breakdown"]["device_ops"] == parent["breakdown"]["device_ops"]
