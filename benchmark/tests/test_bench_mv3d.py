"""The mv3d family in the benchmark: its file loads and names what the
harness needs, its configuration parses alike in the port and the
reference, and a tiny cell of it, added to a copy of the benchmark as new
files and manifest entries, runs on the CPU to a correct result line whose
traced run reads each of the family's spans."""

from __future__ import annotations

import json
import shutil

import pytest

from bench_fixtures import BENCH, ROOT, tiny_pipeline

CELL = "tiny-mv3d"
NEW_METRICS = ("front_view_ms.serve", "roi_crops_ms.serve", "deep_fusion_ms.serve")
WIDE = ("boxes", "heading", "scores")  # read from the final boxes of the tiny lattice


def tiny_mv3d_pipeline() -> dict:
    """The tiny lattice of ``tiny_pipeline`` with MV3D's model: two anchor
    sizes on a stride-1 proposal lattice (the two-stage backbone's fusion
    stride 2, upsampled 2x), a 16x64 front view, deep fusion, box_8c."""

    pipe = tiny_pipeline("mv3d")
    model = pipe["model"]
    model["anchors"].update(stride=model["bev"]["voxel_size"], sizes=[[3.9, 1.6, 1.56], [1.0, 0.6, 1.56]])
    model["avod"].update(fusion_type="deep", box_rep="box_8c", fc_layers=[2048, 2048, 2048])
    model["mv3d"] = {"fv_height": 16, "fv_width": 64, "fv_azimuth_deg": 81.0, "fv_elevation_up_deg": 2.0,
                     "fv_elevation_deg": 26.8, "proposal_upsample": 2}
    return pipe


def add_tiny_mv3d_cell(root) -> None:
    """A configuration, traffic mix and cell of the mv3d family in the
    benchmark copy at ``root``, new files and manifest entries alone; it
    reports the full cell's metrics. Its limits are the full cell's doubled
    (as ``bench_fixtures.add_tiny_cell`` sets them), the final boxes' three
    numbers eightfold: the tiny lattice's proposals, decoded from random
    offsets over 0.8 m cells, are larger and read the served dtype's
    rounding of the 24 corner offsets at 2-6x the full cell's widest."""

    bench = root / "benchmark"
    (bench / "configs" / "tiny_mv3d.json").write_text(json.dumps({
        "name": "tiny_mv3d", "preset": "mv3d_cars", "source": "https://arxiv.org/abs/1611.07759",
        "deployment": "test only", "reduced": [], "assumed": {},
        "extents": {"x_min": -40.0, "x_max": 40.0, "y_min": -5.0, "y_max": 3.0, "z_min": 0.0, "z_max": 70.0},
        "pipeline": tiny_mv3d_pipeline()}))
    (bench / "traffic" / "tiny_b2.json").write_text(json.dumps({
        "kind": "serve", "generator": "frames", "loop": "closed", "clients": 1, "batch": 2,
        "pool_frames": 4, "points_min": 600, "points_max": 1000, "image": "noise"}))
    full = json.loads((bench / "workloads" / "mv3d-serve-b8.json").read_text())
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "name": CELL, "config": "tiny_mv3d", "traffic": "tiny_b2", "chips": 1, "why": "test only",
        "judge_requests": 2, "profiled_requests": 1,
        "limits": {k: (8 if k in WIDE else 2) * v for k, v in full["limits"].items()}}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": CELL, "config": "tiny_mv3d", "traffic": "tiny_b2", "chips": 1,
                                  "why": "test only"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "mv3d-serve-b8" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def mv3d_copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_mv3d_cell(tmp_path)
    return tmp_path


def _run(root, capsys, trace: int, seed: int = 3_000_000_019):
    import run

    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                  device="cpu", bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_family_file_loads():
    from families import REQUIRED, load

    family = load("mv3d")
    for name in REQUIRED + ("MODEL_KEYS", "INPUTS", "extra_inputs", "frame"):
        assert hasattr(family, name), name
    assert family.INPUTS == ("fv_input", "bev_intensity") and set(family.MODEL_KEYS) == {"mv3d"}
    assert family.feature_layers(set()) == {"rpn": "rpn_head.rpn_conv", "s2": "stage2_head.join"}


def test_config_parses_alike_in_port_and_reference():
    from reference.config import pipeline_config_from_dict as ref_build
    from sparse_pooling_tpu_torch.configs import presets
    from sparse_pooling_tpu_torch.configs.config import pipeline_config_from_dict as port_build

    data = json.loads((BENCH / "configs" / "mv3d_cars.json").read_text())
    port, ref = port_build(data["pipeline"]), ref_build(data["pipeline"])
    assert port.to_json() == ref.to_json()
    assert port == presets.mv3d_cars_config()
    assert ref.model.mv3d.fv_steps == port.model.mv3d.fv_steps and ref.model.mv3d.fv_top == port.model.mv3d.fv_top


def test_flops_per_frame():
    """The analytic count at the published sizes: about 290 GFLOP a frame
    (the three encoders 181.7, the stride-4 proposal head 42.1, the deep
    head 61.4, SHPL 4.3)."""

    from harness.flops import forward_flops
    from harness.manifest import Cell
    from reference.config import AreaExtents

    cell = Cell("mv3d-serve-b8")
    assert forward_flops(cell.model_cfg, AreaExtents(), cell.family) == 289_531_211_776


def test_frames_carry_a_seeded_intensity():
    import numpy as np

    from harness.manifest import Cell
    from traffic import frame_pool

    cell = Cell("mv3d-serve-b8")
    mix = dict(cell.traffic, pool_frames=2, points_min=50, points_max=60)
    a = frame_pool(mix, cell.model_cfg, 7, cell.family)
    b = frame_pool(mix, cell.model_cfg, 7, cell.family)
    for fa, fb in zip(a, b):
        assert fa["points"].shape[1] == 4 and np.array_equal(fa["points"], fb["points"])
        inten = fa["points"][:, 3]
        assert (inten[fa["points_mask"]] >= 0).all() and (inten[fa["points_mask"]] < 1).all()
        assert (inten[~fa["points_mask"]] == 0).all()


def test_analytic_flops_match_the_flop_counter_tiny():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from harness.flops import forward_flops
    from harness.weights import seeded_state
    from reference import pipeline as rpl
    from reference.config import AreaExtents, pipeline_config_from_dict
    from reference.layers import Conv, ConvTransposeSame, Dense
    from families import load
    from traffic import frame_pool

    family = load("mv3d")
    cfg = pipeline_config_from_dict(tiny_mv3d_pipeline()).model
    ext = AreaExtents()
    model = rpl.make_model(cfg, ext, "cpu", family)
    model.load_state_dict(seeded_state(model, 5, "cpu"))
    frames = frame_pool({"pool_frames": 2, "points_min": 600, "points_max": 1000, "image": "noise"}, cfg, 5, family)
    batch = rpl.stack_frames(frames, cfg.sparse_pool.buckets, "cpu")
    inputs = rpl.build_model_inputs_batch(batch, rpl.static_anchor_grid(cfg, ext, "cpu", family), torch.ones(2, 2),
                                          cfg, ext, family)
    layers = {name for name, m in model.named_modules() if isinstance(m, (Conv, ConvTransposeSame, Dense))}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(inputs)
    root = type(model).__name__
    counted = sum(sum(ops.values()) for key, ops in counter.get_flop_counts().items()
                  if key.startswith(root + ".") and key[len(root) + 1:] in layers)
    assert counted == 2 * forward_flops(cfg, ext, family)


def test_tiny_cell_is_correct_and_reads_its_spans(mv3d_copy, capsys):
    res = _run(mv3d_copy, capsys, trace=1)
    assert res["correct"] is True, res["checks"]
    for name in NEW_METRICS + ("stage2_ms.serve", "encode_ms.serve", "mfu.serve"):
        assert res["metrics"][name]["value"] > 0, name


def test_tiny_cell_end_to_end(mv3d_copy, capsys):
    res = _run(mv3d_copy, capsys, trace=0)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"serve_ms_p50", "serve_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault,number", [("wrong_pick", "final_nms"), ("mirrored_heading", "heading"),
                                          ("flipped_side", "flip")])
def test_a_planted_fault_is_not_correct(mv3d_copy, capsys, fault, number):
    from harness.faults import planted

    with planted(fault):
        res = _run(mv3d_copy, capsys, trace=0)
    assert res["correct"] is False and res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_a_front_view_that_differs_is_not_correct(mv3d_copy, capsys, monkeypatch):
    """The family's own inputs are compared: a port whose front view moves
    one cell fails ``inputs``."""

    from sparse_pooling_tpu_torch.models import pipeline as port_pl

    build = port_pl.build_model_inputs_batch

    def build_other(*args, **kwargs):
        out = build(*args, **kwargs)
        out["fv_input"] = out["fv_input"].roll(1, dims=2)
        return out

    monkeypatch.setattr(port_pl, "build_model_inputs_batch", build_other)
    res = _run(mv3d_copy, capsys, trace=0)
    assert res["correct"] is False and res["checks"]["inputs"]["value"] > res["checks"]["inputs"]["limit"]


def test_control_fails_the_limits(mv3d_copy):
    import torch

    import control
    from harness.judge import verdict
    from harness.manifest import Cell

    cell = Cell(CELL, mv3d_copy / "benchmark")
    row = control.readings(cell, 21, 1.0, torch.device("cpu"), control=True)
    limits = cell.workload["limits"]
    assert row["port_correct"] is True and verdict(row["port"], limits)[0], row["port"]
    assert row["control_correct"] is False, row["control"]
