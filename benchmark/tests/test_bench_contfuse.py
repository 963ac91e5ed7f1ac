"""The contfuse family in the benchmark: its file loads and names what the
harness needs (one stage, no SHPL table), its configuration parses alike in
the port and the reference, its FLOPs equal PyTorch's flop counter, and a
tiny cell of it, added to a copy of the benchmark as new files and manifest
entries, runs on the CPU to a correct result line reading the 8 one-stage
numbers, whose traced run reads the KNN span; the planted faults that reach
a one-stage family are not correct on it."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from bench_fixtures import BENCH, ROOT, tiny_pipeline

CELL = "tiny-contfuse"
# the tiny cell's limits: three to eight times the widest reading of the served dtype's
# rounding at this size over four seeds (fusion 0.011, rpn 0.015, final_nms 0.0020, boxes
# 0.0055 m, heading 0.00063 rad, scores 0.0026), far below the faults' (0.5 m, 0.10 rad, 0.65)
TINY_LIMITS = {"inputs": 1e-4, "fusion": 0.05, "rpn": 0.05, "final_nms": 0.012, "boxes": 0.05, "heading": 0.005,
               "flip": 0.001, "scores": 0.015}


def tiny_contfuse_pipeline() -> dict:
    """The unittest preset's caps in bf16 with ContFuse's model at widths
    of 4-16: an 80x80 BEV at 1 m (70 rows and 10 of padding, so that it
    halves four times), a 64x160 canvas, 800 anchors a frame, 8 picks."""

    pipe = tiny_pipeline("contfuse")
    model = pipe["model"]
    model["bev"].update(voxel_size=1.0, pad_h=10)
    model["image"].update(height=64, width=160)
    model["anchors"].update(stride=4.0)
    model["avod"].update(nms_iou_thresh=0.1, nms_size=8)
    model["contfuse"] = {"height_lo": -0.8, "height_hi": 2.7, "bev_layers": [1, 2, 2, 2, 4],
                         "bev_channels": [4, 8, 8, 12, 16], "fpn_channels": 8, "image_blocks": [1, 1, 1, 1],
                         "image_channels": [8, 8, 12, 16], "image_feature_channels": 8, "neighbours": 3,
                         "max_distance": 10.0}
    return pipe


def add_tiny_contfuse_cell(root) -> None:
    """A configuration, traffic mix and cell of the contfuse family in the
    benchmark copy at ``root``, new files and manifest entries alone; it
    reports the full cell's metrics."""

    bench = root / "benchmark"
    (bench / "configs" / "tiny_contfuse.json").write_text(json.dumps({
        "name": "tiny_contfuse", "preset": "contfuse_cars", "source": "test only", "deployment": "test only",
        "reduced": [], "assumed": {},
        "extents": {"x_min": -40.0, "x_max": 40.0, "y_min": -5.0, "y_max": 3.0, "z_min": 0.0, "z_max": 70.0},
        "pipeline": tiny_contfuse_pipeline()}))
    (bench / "traffic" / "tiny_b2.json").write_text(json.dumps({
        "kind": "serve", "generator": "frames", "loop": "closed", "clients": 1, "batch": 2,
        "pool_frames": 4, "points_min": 600, "points_max": 1000, "image": "noise"}))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps({
        "name": CELL, "config": "tiny_contfuse", "traffic": "tiny_b2", "chips": 1, "why": "test only",
        "judge_requests": 2, "profiled_requests": 1, "limits": TINY_LIMITS}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": CELL, "config": "tiny_contfuse", "traffic": "tiny_b2", "chips": 1,
                                  "why": "test only"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "contfuse-serve-b8" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def contfuse_copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_contfuse_cell(tmp_path)
    return tmp_path


def _run(root, capsys, trace: int, seed: int = 3_000_000_071):
    import run

    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                  device="cpu", bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_family_file_loads():
    from families import REQUIRED, load
    from harness.judge import input_keys

    family = load("contfuse")
    for name in REQUIRED + ("MODEL_KEYS", "INPUTS", "extra_inputs", "frame", "STAGES", "SHARED_INPUTS"):
        assert hasattr(family, name), name
    assert family.STAGES == 1 and set(family.MODEL_KEYS) == {"contfuse"}
    assert "m_bev" not in input_keys(family) and "m_fv" not in input_keys(family)
    assert family.INPUTS == ("bev_occupancy", "points_uv", "knn_centres", "knn")
    assert family.feature_layers(set()) == {"rpn": "head_input"}
    assert family.FUSION_LAYERS == ("fusion1", "fusion2", "fusion3", "fusion4")


def test_config_parses_alike_in_port_and_reference():
    from reference.config import pipeline_config_from_dict as ref_build
    from sparse_pooling_tpu_torch.configs import presets
    from sparse_pooling_tpu_torch.configs.config import pipeline_config_from_dict as port_build

    data = json.loads((BENCH / "configs" / "contfuse_cars.json").read_text())
    port, ref = port_build(data["pipeline"]), ref_build(data["pipeline"])
    assert port.to_json() == ref.to_json()
    assert port == presets.contfuse_cars_config()
    assert data["reduced"] == [] and data["source"].startswith("Liang, Yang, Wang, Urtasun")
    for key in ("neighbours", "few_points", "pixel_height", "mlp", "box_coding", "final_nms", "image_stream"):
        assert key in data["assumed"], key


def test_flops_per_frame():
    """The analytic count at the published sizes: about 307 GFLOP a frame,
    22.1 of them the four fusion MLPs at every neighbour slot."""

    from harness.flops import forward_flops
    from harness.manifest import Cell
    from reference.config import AreaExtents

    cell = Cell("contfuse-serve-b8")
    assert forward_flops(cell.model_cfg, AreaExtents(), cell.family) == 306_633_261_056


def test_flops_equal_the_flop_counter(contfuse_copy):
    """``flops`` against PyTorch's flop counter over the reference model at
    the tiny size (convs, the fusion MLPs over every neighbour slot)."""

    from torch.utils.flop_counter import FlopCounterMode

    from harness.manifest import Cell
    from reference import pipeline as ref_pl
    from reference.config import AreaExtents

    cell = Cell(CELL, contfuse_copy / "benchmark")
    cfg, ext, b, p = cell.model_cfg, AreaExtents(**cell.config["extents"]), 2, 64
    model = ref_pl.make_model(cfg, ext, "cpu", cell.family)
    s = cfg.contfuse
    q = sum(h * w for h, w in model.lattices)
    n_anchors = len(cell.family.anchor_grid(cfg, ext))
    inputs = {"bev_occupancy": torch.rand(b, 80, 80, 5), "image": torch.rand(b, 64, 160, 3),
              "points": torch.rand(b, p, 3), "points_uv": torch.rand(b, p, 2) * 60,
              "knn": torch.randint(0, p + 1, (b, q, s.neighbours)), "knn_centres": torch.rand(b, q, 3),
              "anchors": torch.rand(b, n_anchors, 8), "anchor_valid": torch.ones(b, n_anchors, dtype=torch.bool)}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(inputs)
    assert counter.get_total_flops() == b * cell.family.flops(cfg, ext)


def test_frames_carry_a_seeded_intensity():
    from families import load

    import numpy as np

    family = load("contfuse")
    frame = {"points": np.ones((10, 3), np.float32), "points_mask": np.arange(10) < 6}
    a, b = family.frame(frame, 5), family.frame(frame, 5)
    assert a["points"].shape == (10, 4) and np.array_equal(a["points"], b["points"])
    assert (a["points"][6:, 3] == 0).all() and (a["points"][:6, 3] > 0).all()


def test_a_tiny_contfuse_cell_runs_from_new_files_alone(contfuse_copy, capsys):
    from harness.judge import STAGE_NUMBERS

    res = _run(contfuse_copy, capsys, trace=1)
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == list(STAGE_NUMBERS[1]) and len(res["checks"]) == 8
    assert res["checks"]["inputs"]["value"] == 0.0 and res["checks"]["flip"]["value"] == 0.0
    metrics = res["metrics"]
    for name in ("knn_ms.serve", "fusion_ms.serve", "encode_ms.serve", "final_nms_ms.serve", "mfu.serve"):
        assert metrics[name]["value"] > 0, name
    assert "stage2_ms.serve" not in metrics and "rpn_nms_ms.serve" not in metrics


@pytest.mark.parametrize("fault,number", [("wrong_pick", "final_nms"), ("mirrored_heading", "heading"),
                                          ("moved_boxes", "boxes")])
def test_a_planted_fault_is_not_correct(contfuse_copy, capsys, fault, number):
    from harness.faults import planted

    with planted(fault):
        res = _run(contfuse_copy, capsys, trace=0)
    assert res["correct"] is False and res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]
