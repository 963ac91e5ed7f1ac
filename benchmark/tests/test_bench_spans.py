"""The span split (``span_split.py``, ``harness/spans.py``) rehearsed on the
CPU at a tiny size: every span reading of both families, and nothing where
the program has no spans; the benchmark's own traced run reads as before."""

from __future__ import annotations

import json

import pytest

from bench_fixtures import TINY, add_tiny_cell

READINGS = {"upload_ms.serve", "encode_ms.serve", "fusion_ms.serve", "rpn_nms_ms.serve", "stage2_ms.serve",
            "final_nms_ms.serve", "nms_round_us.serve", "nms_idle_share.serve"}
TREE = {"upload": None, "inputs": None, "detector": None, "detector.encode": "detector",
        "detector.fusion": "detector", "detector.rpn_nms": "detector", "detector.decode_maps": "detector",
        "detector.stage2": "detector", "decode": None, "decode.nms": "decode"}


def _without_spans(monkeypatch):
    """The program as its parent was: no ``profiling.span``, and the model
    modules' spans, bound at their import, no-ops."""

    import contextlib

    from sparse_pooling_tpu_torch.models import detector, fusion_rcnn, pipeline
    from sparse_pooling_tpu_torch.runtime import profiling

    monkeypatch.delattr(profiling, "span")
    for module in (detector, fusion_rcnn, pipeline):
        monkeypatch.setattr(module, "span", lambda _name: contextlib.nullcontext())


def _split(root, capsys, name=TINY, seed=3_000_000_019):
    import span_split

    rc = span_split.main(["--workload", name, "--seed", str(seed), "--seconds", "1"], device="cpu",
                         bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def _traced(root, capsys, name=TINY, seconds="1"):
    import run

    rc = run.main(["--workload", name, "--seed", "3000000007", "--seconds", seconds, "--trace", "1"],
                  device="cpu", bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("architecture", ["avod", "rcnn"])
def test_every_span_reading_of_both_families(bench_copy, capsys, architecture):
    name = TINY
    if architecture == "rcnn":
        name = "tiny-rcnn"
        add_tiny_cell(bench_copy, name=name, architecture="rcnn", limits_from="rcnn-serve-b8")
    got = _split(bench_copy, capsys, name)
    assert set(got["spans"]) == READINGS
    assert all(v is not None and v >= 0 for v in got["spans"].values()), got["spans"]
    assert {k: v["parent"] for k, v in got["span_ms"].items()} == TREE
    assert 0 < got["spans"]["nms_idle_share.serve"] <= 100
    parts = sum(got["spans"][f"{k}.serve"] for k in ("encode_ms", "fusion_ms", "rpn_nms_ms", "stage2_ms"))
    assert parts <= got["span_ms"]["detector"]["device_ms"]
    assert got["spans"]["final_nms_ms.serve"] <= got["span_ms"]["decode"]["device_ms"]
    assert sum(got["launches_by_span"].values()) > 0 and got["span_p50_ms"] > 0 < got["window_p50_ms"]
    assert got["stage_ms"] == {}  # CUDA events time the window's stages on a card alone


def test_a_program_without_spans_gives_no_reading(bench_copy, capsys, monkeypatch):
    with_spans = _split(bench_copy, capsys)
    _without_spans(monkeypatch)
    without = _split(bench_copy, capsys)
    assert set(without["spans"]) == READINGS and all(v is None for v in without["spans"].values())
    assert "span_ms" not in without and without["window_p50_ms"] > 0
    assert set(with_spans) - set(without) == {"span_p50_ms", "span_ms", "launches_by_span", "idle_ms_by_span",
                                              "busy_ms", "launch_found"}


def test_the_traced_run_reads_as_before(bench_copy, capsys, monkeypatch):
    """The benchmark's own ``--trace 1`` line is the same with the program's
    spans and without them (the parent), its timings apart. A window of one
    request: the judge samples the same requests on both sides."""

    got = _traced(bench_copy, capsys, seconds="0")
    _without_spans(monkeypatch)
    parent = _traced(bench_copy, capsys, seconds="0")
    assert got["attempted"] == parent["attempted"] == 1
    assert set(got["metrics"]) == set(parent["metrics"]) and "mfu.serve" in got["metrics"]
    assert not READINGS & set(got["metrics"])
    # the judge's numbers, each beside its limit: the same sampled requests, the same outputs
    assert got["checks"] == parent["checks"] and got["checks"]
    assert set(got["breakdown"]) == set(parent["breakdown"]) == {"device_ops", "idle_gaps"}
    assert got["correct"] is parent["correct"] is True
    assert got["failed"] == parent["failed"] == 0
    assert got["breakdown"]["device_ops"] == parent["breakdown"]["device_ops"]
