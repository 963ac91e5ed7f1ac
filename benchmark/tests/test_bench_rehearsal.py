"""The whole run rehearsed on the CPU at a tiny size through the test-only
``device`` argument (the command line always asks for a card): the result
line, the traced run's metrics, the control failing the cell's limits, and
runs with the timed path broken underneath (``harness/faults.py``) coming out
not correct."""

from __future__ import annotations

import json

import pytest
import torch

from bench_fixtures import TINY, add_tiny_cell


def _run(root, capsys, trace=0, seed=3_000_000_007, name=TINY):
    import run

    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                  device="cpu", bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err.strip().splitlines()


def test_result_line_and_checks(bench_copy, capsys):
    res, err = _run(bench_copy, capsys)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"serve_ms_p50", "serve_ms_p95", "setup_s"}
    assert res["metrics"]["serve_ms_p95"]["value"] >= res["metrics"]["serve_ms_p50"]["value"] > 0
    assert list(res)[-1] == "checks" and set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    limits = json.loads((bench_copy / "benchmark" / "workloads" / f"{TINY}.json").read_text())["limits"]
    assert set(res["checks"]) == set(limits)
    assert err[-len(limits):] == [f"check {k} {res['checks'][k]['value']!r} limit {v!r}"
                                  for k, v in limits.items()]


def test_traced_run(bench_copy, capsys):
    res, _ = _run(bench_copy, capsys, trace=1)
    assert res["correct"] is True
    assert "mfu.serve" in res["metrics"] and "serve_ms_p50" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_rcnn_family(bench_copy, capsys):
    add_tiny_cell(bench_copy, name="tiny-rcnn", architecture="rcnn", limits_from="rcnn-serve-b8")
    res, _ = _run(bench_copy, capsys, name="tiny-rcnn")
    assert res["correct"] is True


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_fails_the_limits(bench_copy, seed):
    import control
    from harness.judge import verdict
    from harness.manifest import Cell

    cell = Cell(TINY, bench_copy / "benchmark")
    row = control.readings(cell, seed, 1.0, torch.device("cpu"), control=True)
    limits = cell.workload["limits"]
    assert row["port_correct"] is True and verdict(row["port"], limits)[0], row["port"]
    assert row["control_correct"] is False and not verdict(row["control"], limits)[0], row["control"]


# each fault planted underneath the timed path, and the number that has to
# catch it (None: any)
FAULTS = [("half_batch", None), ("moved_boxes", "boxes"), ("wrong_pick", "final_nms"),
          ("mirrored_heading", "heading"), ("flipped_side", "flip")]


@pytest.mark.parametrize("fault,number", FAULTS, ids=[f for f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(bench_copy, capsys, fault, number):
    from harness.faults import planted

    with planted(fault):
        res, _ = _run(bench_copy, capsys)
    assert res["correct"] is False
    if number:
        check = res["checks"][number]
        assert check["value"] > check["limit"], res["checks"]


@pytest.mark.parametrize("fault,number", [("mirrored_heading", "heading"), ("wrong_pick", "final_nms")])
def test_a_planted_fault_is_not_correct_rcnn(bench_copy, capsys, fault, number):
    from harness.faults import planted

    add_tiny_cell(bench_copy, name="tiny-rcnn", architecture="rcnn", limits_from="rcnn-serve-b8")
    with planted(fault):
        res, _ = _run(bench_copy, capsys, name="tiny-rcnn")
    assert res["correct"] is False and res["checks"][number]["value"] > res["checks"][number]["limit"]
