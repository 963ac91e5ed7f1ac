"""A detector family enters the benchmark by new files alone: a probe family
(the rcnn family under another architecture name, with a model key and an
input of its own), its configuration, traffic and cell, a hand kernel's
bound and a metric of one of its spans, all new files and manifest entries
in a copy of the benchmark, run on the CPU to a correct result line. A
one-stage probe family (``STAGES = 1``) enters the same way and is judged
by its 8 numbers; a cell's limits that name another number, or leave one
out, are refused at load. Without its family file a cell names the file it
misses."""

from __future__ import annotations

import copy
import filecmp
import json
import shutil

import pytest
import torch

from bench_fixtures import BENCH, ROOT, tiny_pipeline

PROBE_FAMILY = '''"""A probe family: the rcnn family under another name, with the model key
``probe``, the input ``probe_points`` and the frame field ``probe_seed`` of
its own, and only the RPN's NMS span counted as NMS."""

import dataclasses
from pathlib import Path

import numpy as np
import torch

from families import load
from reference.config import from_dict

_rcnn = load("rcnn", Path(__file__).resolve().parents[1])
MODEL, PORT_NMS_MODULES, FUSION_LAYERS = _rcnn.MODEL, _rcnn.PORT_NMS_MODULES, _rcnn.FUSION_LAYERS
feature_layers, anchor_grid, frame_anchors = _rcnn.feature_layers, _rcnn.anchor_grid, _rcnn.frame_anchors
decode, flops = _rcnn.decode, _rcnn.flops
NMS_SPANS = ("detector.rpn_nms",)


@dataclasses.dataclass(frozen=True)
class Probe:
    points_scale: float = 1.0
    rpn_rounds_only: bool = False


MODEL_KEYS = {"probe": lambda value: from_dict(Probe, value)}
INPUTS = ("probe_points",)


def extra_inputs(batch, cfg, extents):
    return {"probe_points": batch.points_mask.sum(dim=1).to(torch.float32) * cfg.probe.points_scale}


def nms_rounds(cfg):
    return cfg.rpn.eval_nms_size if cfg.probe.rpn_rounds_only else _rcnn.nms_rounds(cfg)


def frame(frame, seed):
    return dict(frame, probe_seed=np.int64(seed))
'''

PROBE_KERNEL = '''"""A probe op: the plain SHPL pool, which the CPU's operator calls."""

from harness.roofline import least_time, nbytes

PORT = ("sparse_pooling_tpu_torch.ops.sparse_pool", "sparse_pool_patch_plain")


def bound(src, rows, cols, vals, *_):
    return least_time(nbytes(src, rows, cols, vals), 0)
'''

PROBE_METRIC = '''def read(run):
    from harness.spans import reading

    return reading(run, "detector.rpn_nms", "device_ms")
'''

PROBE_SCALE = 0.5
CELL, METRIC = "probe-serve", "probe_rpn_nms_ms.serve"


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def _add_probe(root) -> list:
    """The probe's files and manifest entries; returns the files added."""

    bench = root / "benchmark"
    pipe = tiny_pipeline("rcnn")
    pipe["model"]["architecture"] = "probe"
    pipe["model"]["probe"] = {"points_scale": PROBE_SCALE, "rpn_rounds_only": True}
    files = {
        "families/probe.py": PROBE_FAMILY,
        "kernels/probe_pool.py": PROBE_KERNEL,
        f"metrics/{METRIC}.py": PROBE_METRIC,
        "configs/tiny_probe.json": json.dumps({
            "name": "tiny_probe", "preset": "unittest", "source": "https://arxiv.org/abs/1611.07759",
            "deployment": "test only", "reduced": [], "assumed": {},
            "extents": {"x_min": -40.0, "x_max": 40.0, "y_min": -5.0, "y_max": 3.0, "z_min": 0.0, "z_max": 70.0},
            "pipeline": pipe}),
        "traffic/tiny_probe_b2.json": json.dumps({
            "kind": "serve", "generator": "frames", "loop": "closed", "clients": 1, "batch": 2,
            "pool_frames": 4, "points_min": 600, "points_max": 1000, "image": "noise"}),
        f"workloads/{CELL}.json": json.dumps({
            "name": CELL, "config": "tiny_probe", "traffic": "tiny_probe_b2", "chips": 1, "why": "test only",
            "judge_requests": 2, "profiled_requests": 1,
            "limits": {k: 2 * v for k, v in json.loads(
                (bench / "workloads" / "rcnn-serve-b8.json").read_text())["limits"].items()}}),
    }
    for rel, text in files.items():
        (bench / rel).write_text(text)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny_probe", "source": "https://arxiv.org/abs/1611.07759",
                                "file": "benchmark/configs/tiny_probe.json", "reduced": [], "why": "test only"})
    manifest["workloads"].append({"name": CELL, "config": "tiny_probe", "traffic": "tiny_probe_b2", "chips": 1,
                                  "why": "test only"})
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    manifest["per_layer"].append({"name": METRIC, "unit": "ms", "better": "lower", "source": "program_span",
                                  "layer": "detector", "moves": "serve_ms_p50", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return sorted(files)


def _teach_the_port(monkeypatch):
    """The port's share of a new family, in process: its configuration
    parses the probe as the rcnn family, and its input build adds the
    probe's input."""

    from sparse_pooling_tpu_torch.configs import config as port_config
    from sparse_pooling_tpu_torch.models import pipeline as port_pl

    parse, build = port_config.pipeline_config_from_dict, port_pl.build_model_inputs_batch

    def parse_probe(data):
        data = copy.deepcopy(data)
        model = data.get("model", {})
        if model.get("architecture") == "probe":
            model.pop("probe", None)
            model["architecture"] = "rcnn"
        return parse(data)

    def build_probe(batch, *args, **kwargs):
        out = build(batch, *args, **kwargs)
        out["probe_points"] = batch.points_mask.sum(dim=1).to(torch.float32) * PROBE_SCALE
        return out

    monkeypatch.setattr(port_config, "pipeline_config_from_dict", parse_probe)
    monkeypatch.setattr(port_pl, "build_model_inputs_batch", build_probe)


def _differing(root) -> list:
    """Files of the copy's benchmark folder that differ from the repo's or
    are not in it."""

    out = []
    for path in sorted((root / "benchmark").rglob("*")):
        rel = path.relative_to(root / "benchmark")
        if path.is_dir() or "__pycache__" in rel.parts:
            continue
        if not (BENCH / rel).is_file() or not filecmp.cmp(path, BENCH / rel, shallow=False):
            out.append(str(rel))
    return sorted(out)


def _without_probe(manifest: dict) -> dict:
    manifest = copy.deepcopy(manifest)
    manifest["configs"] = [c for c in manifest["configs"] if c["name"] != "tiny_probe"]
    manifest["workloads"] = [w for w in manifest["workloads"] if w["name"] != CELL]
    manifest["per_layer"] = [m for m in manifest["per_layer"] if m["name"] != METRIC]
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return manifest


def test_a_probe_family_runs_from_new_files_alone(tmp_path, capsys, monkeypatch):
    import run
    from harness.manifest import Cell

    root = _copy(tmp_path)
    added = _add_probe(root)
    _teach_the_port(monkeypatch)
    cell = Cell(CELL, root / "benchmark")
    assert cell.model_cfg.architecture == "probe" and cell.model_cfg.probe.points_scale == PROBE_SCALE
    assert cell.family.nms_rounds(cell.model_cfg) == cell.model_cfg.rpn.eval_nms_size
    from traffic import frame_pool, frame_seeds

    frames = frame_pool(cell.traffic, cell.model_cfg, 5, cell.family)
    assert sorted(int(f["probe_seed"]) for f in frames) == sorted(frame_seeds(5, len(frames)).tolist())
    rc = run.main(["--workload", CELL, "--seed", "3000000023", "--seconds", "1", "--trace", "1"], device="cpu",
                  bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["metrics"][METRIC]["value"] > 0
    assert "trace probe_pool: 2 calls" in err  # the probe op's bound, one call a fusion layer
    assert _differing(root) == added
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert _without_probe(json.loads((root / "BENCHMARK.json").read_text())) == manifest


def test_a_probe_input_that_differs_is_not_correct(tmp_path, capsys, monkeypatch):
    """The probe's own input is compared: a port that builds it otherwise
    fails ``inputs``."""

    import run

    root = _copy(tmp_path)
    _add_probe(root)
    _teach_the_port(monkeypatch)
    from sparse_pooling_tpu_torch.models import pipeline as port_pl

    build = port_pl.build_model_inputs_batch

    def build_other(*args, **kwargs):
        out = build(*args, **kwargs)
        out["probe_points"] = out["probe_points"] + 1.0
        return out

    monkeypatch.setattr(port_pl, "build_model_inputs_batch", build_other)
    rc = run.main(["--workload", CELL, "--seed", "3000000023", "--seconds", "0", "--trace", "0"], device="cpu",
                  bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False and res["checks"]["inputs"]["value"] > res["checks"]["inputs"]["limit"]


def test_a_missing_family_file_is_named(tmp_path):
    import run

    root = _copy(tmp_path)
    (root / "benchmark" / "families" / "rcnn.py").unlink()
    with pytest.raises(FileNotFoundError, match="families/rcnn.py is missing"):
        run.main(["--workload", "rcnn-serve-b8", "--seed", "1", "--seconds", "1", "--trace", "0"], device="cpu",
                 bench_dir=root / "benchmark")


def test_an_unclaimed_model_key_still_raises():
    from reference.config import pipeline_config_from_dict

    pipe = tiny_pipeline("rcnn")
    pipe["model"]["front_view"] = {"height": 64}
    with pytest.raises(KeyError, match="ModelConfig.front_view"):
        pipeline_config_from_dict(pipe)
    pipe = tiny_pipeline("rcnn")
    pipe["model"]["bev"]["front_view"] = 1
    with pytest.raises(KeyError, match="BevConfig.front_view"):
        pipeline_config_from_dict(pipe)


# ---- a one-stage family ------------------------------------------------------

ONE_STAGE_FAMILY = '''"""A one-stage probe family: the rcnn family's encoders, its BEV-side SHPL
fusion and its dense conv RPN head, with a 1x1 orientation head beside it on
the fused map; the head's boxes and scores at every anchor are the
detections, through the per-class final NMS. No stage 2, no RPN NMS, no
image-side fusion (so no ``m_fv``). Its reference model is here."""

from pathlib import Path

import torch

from families import load
from harness.flops import _conv, fusion_flops
from reference import encoders, projection
from reference.detector import per_class_nms
from reference.fusion_rcnn import FusionRcnn
from reference.layers import Conv

_bench = Path(__file__).resolve().parents[1]
_rcnn, _mv3d = load("rcnn", _bench), load("mv3d", _bench)
anchor_grid, frame_anchors = _rcnn.anchor_grid, _rcnn.frame_anchors
STAGES = 1
SHARED_INPUTS = ("bev_input", "bev_pre_packed", "image", "anchors", "anchor_valid", "m_bev")
PORT_NMS_MODULES = ("sparse_pooling_tpu_torch.models.detector",)
FUSION_LAYERS = ("bev_fusion",)
NMS_SPANS = ("decode.nms",)


def feature_layers(names):
    return {"rpn": "rpn_head.rpn_conv"}


class OneStage(FusionRcnn):
    def __init__(self, cfg, extents):
        super().__init__(cfg, extents)
        del self.img_fusion, self.stage2_head
        self.heading = Conv(cfg.backbone.channels[-1], 2 * len(cfg.anchors.sizes) * len(cfg.anchors.rotations), 1)

    def forward(self, inputs):
        bev_mid, _ = self.bev_extractor.encode(inputs["bev_input"], pre_packed=inputs["bev_pre_packed"])
        img_mid, _ = self.img_extractor.encode(inputs["image"])
        fused = self.bev_fusion(bev_mid, img_mid, inputs["m_bev"])
        objectness, offsets = self.rpn_head(fused)
        return {"objectness": objectness, "rpn_offsets": offsets, "anchors": inputs["anchors"],
                "anchor_valid": inputs["anchor_valid"],
                "orientation": self.heading(fused).reshape(*objectness.shape).float()}


MODEL = OneStage


def decode(outputs, ground_plane, cfg, extents, picks=None):
    boxes = encoders.offset_to_anchor(outputs["anchors"][..., :6], outputs["rpn_offsets"])
    ry = encoders.vector_to_angle(outputs["orientation"])
    head = {"cls_logits": outputs["objectness"], "proposal_valid": outputs["anchor_valid"]}
    return per_class_nms(encoders.anchor_to_box_3d(boxes, ry), projection.project_to_bev(boxes, extents), head,
                         cfg, picks)


def flops(cfg, extents):
    """Both encoders, the BEV fusion, the RPN conv head and the
    orientation conv over the fused lattice."""

    bh, bw = cfg.bev.padded_hw(extents)
    s, mid = cfg.sparse_pool.fusion_stride, cfg.backbone.channels[-1]
    n, fc = len(cfg.anchors.sizes) * len(cfg.anchors.rotations), cfg.rpn.fusion_channels
    total = (_mv3d._encoder_flops(cfg, cfg.bev.num_channels, bh, bw)
             + _mv3d._encoder_flops(cfg, cfg.image.channels, cfg.image.height, cfg.image.width))
    h, w = bh // s, bw // s
    total += fusion_flops(cfg, mid, [((h, w), (cfg.image.height // s, cfg.image.width // s))])
    return total + _conv(3, mid, fc, h, w) + _conv(1, fc, 8 * n, h, w) + _conv(1, mid, 2 * n, h, w)


def nms_rounds(cfg):
    return cfg.num_classes * cfg.avod.nms_size
'''

ONE_STAGE, ONE_STAGE_CELL = "onestage", "onestage-serve"


def _add_one_stage(root, limits=None) -> list:
    """The one-stage probe's family file, configuration, traffic and cell,
    and its manifest entries; returns the files added. Its limits: the
    full rcnn cell's doubled (as ``bench_fixtures.add_tiny_cell`` sets a
    tiny cell's) for the 8 numbers a one-stage family reads."""

    bench = root / "benchmark"
    pipe = tiny_pipeline("rcnn")
    pipe["model"]["architecture"] = ONE_STAGE
    if limits is None:
        full = json.loads((bench / "workloads" / "rcnn-serve-b8.json").read_text())["limits"]
        limits = {k: 2 * v for k, v in full.items() if k not in ("rpn_nms", "proposals", "stage2")}
    files = {
        f"families/{ONE_STAGE}.py": ONE_STAGE_FAMILY,
        "configs/tiny_onestage.json": json.dumps({
            "name": "tiny_onestage", "preset": "unittest", "source": "https://arxiv.org/abs/1611.07759",
            "deployment": "test only", "reduced": [], "assumed": {},
            "extents": {"x_min": -40.0, "x_max": 40.0, "y_min": -5.0, "y_max": 3.0, "z_min": 0.0, "z_max": 70.0},
            "pipeline": pipe}),
        "traffic/tiny_onestage_b2.json": json.dumps({
            "kind": "serve", "generator": "frames", "loop": "closed", "clients": 1, "batch": 2,
            "pool_frames": 4, "points_min": 600, "points_max": 1000, "image": "noise"}),
        f"workloads/{ONE_STAGE_CELL}.json": json.dumps({
            "name": ONE_STAGE_CELL, "config": "tiny_onestage", "traffic": "tiny_onestage_b2", "chips": 1,
            "why": "test only", "judge_requests": 2, "profiled_requests": 1, "limits": limits}),
    }
    for rel, text in files.items():
        (bench / rel).write_text(text)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny_onestage", "source": "https://arxiv.org/abs/1611.07759",
                                "file": "benchmark/configs/tiny_onestage.json", "reduced": [], "why": "test only"})
    manifest["workloads"].append({"name": ONE_STAGE_CELL, "config": "tiny_onestage", "traffic": "tiny_onestage_b2",
                                  "chips": 1, "why": "test only"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "rcnn-serve-b8" in m.get("workloads", []):
            m["workloads"].append(ONE_STAGE_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return sorted(files)


def _teach_the_port_one_stage(monkeypatch, rpn_call: bool = False):
    """The port's share of the one-stage probe, in process: its model (the
    port's rcnn parts, as the family file's reference has them) and decode
    through ``detector.per_class_nms``, one entry in ``pipeline.FAMILIES``.
    With ``rpn_call`` its forward also calls the RPN's NMS, as a one-stage
    family may not."""

    from sparse_pooling_tpu_torch.models import detector, fusion_rcnn
    from sparse_pooling_tpu_torch.models import pipeline as port_pl
    from sparse_pooling_tpu_torch.models.layers import Conv
    from sparse_pooling_tpu_torch.ops import encoders, projection

    class OneStage(fusion_rcnn.FusionRcnn):
        def __init__(self, cfg, extents):
            super().__init__(cfg, extents)
            del self.img_fusion, self.stage2_head
            self.heading = Conv(cfg.backbone.channels[-1], 2 * len(cfg.anchors.sizes) * len(cfg.anchors.rotations), 1)

        def forward(self, inputs):
            bev_mid, _ = self.bev_extractor.encode(inputs["bev_input"], pre_packed=inputs["bev_pre_packed"])
            img_mid, _ = self.img_extractor.encode(inputs["image"])
            fused = self.bev_fusion(bev_mid, img_mid, inputs["m_bev"])
            objectness, offsets = self.rpn_head(fused)
            if rpn_call:
                detector.rpn_proposals(inputs, objectness, offsets, self.cfg, self.extents)
            return {"objectness": objectness, "rpn_offsets": offsets, "anchors": inputs["anchors"],
                    "anchor_valid": inputs["anchor_valid"],
                    "orientation": self.heading(fused).reshape(*objectness.shape).float()}

    def decode(outputs, ground_plane, cfg, extents):
        boxes = encoders.offset_to_anchor(outputs["anchors"][..., :6], outputs["rpn_offsets"])
        ry = encoders.vector_to_angle(outputs["orientation"])
        head = {"cls_logits": outputs["objectness"], "proposal_valid": outputs["anchor_valid"]}
        return detector.per_class_nms(encoders.anchor_to_box_3d(boxes, ry), projection.project_to_bev(boxes, extents),
                                      head, cfg)

    monkeypatch.setitem(port_pl.FAMILIES, ONE_STAGE, detector.Family(
        OneStage, fusion_rcnn.rcnn_anchor_grid, fusion_rcnn.rcnn_frame_inputs, decode, frame_inputs_wait_free=True))


@pytest.fixture
def one_stage(tmp_path, monkeypatch):
    root = _copy(tmp_path)
    added = _add_one_stage(root)
    _teach_the_port_one_stage(monkeypatch)
    return root, added


def _run_one_stage(root, capsys, trace: int = 0, seed: int = 3_000_000_041):
    import run

    rc = run.main(["--workload", ONE_STAGE_CELL, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                  device="cpu", bench_dir=root / "benchmark")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_a_one_stage_family_runs_from_new_files_alone(one_stage, capsys):
    from harness.judge import STAGE_NUMBERS, input_keys
    from harness.manifest import Cell

    root, added = one_stage
    cell = Cell(ONE_STAGE_CELL, root / "benchmark")
    assert cell.family.STAGES == 1 and "m_fv" not in input_keys(cell.family)
    res = _run_one_stage(root, capsys, trace=1)
    assert res["correct"] is True, res["checks"]
    assert list(res["checks"]) == list(STAGE_NUMBERS[1]) and len(res["checks"]) == 8
    assert res["metrics"]["final_nms_ms.serve"]["value"] > 0 and "stage2_ms.serve" not in res["metrics"]
    assert _differing(root) == added


@pytest.mark.parametrize("fault,number", [("wrong_pick", "final_nms"), ("mirrored_heading", "heading")])
def test_a_planted_fault_is_not_correct_one_stage(one_stage, capsys, fault, number):
    from harness.faults import planted

    root, _ = one_stage
    with planted(fault):
        res = _run_one_stage(root, capsys)
    assert res["correct"] is False and res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_control_runs_on_a_one_stage_family(one_stage):
    import control
    from harness.judge import STAGE_NUMBERS
    from harness.manifest import Cell

    root, _ = one_stage
    cell = Cell(ONE_STAGE_CELL, root / "benchmark")
    row = control.readings(cell, 21, 1.0, torch.device("cpu"), control=True)
    assert list(row["port"]) == list(STAGE_NUMBERS[1]) and list(row["control"]) == list(STAGE_NUMBERS[1])
    assert row["port_correct"] is True, row["port"]


@pytest.mark.parametrize("change,named", [("add", "stage2"), ("drop", "heading")])
def test_limits_that_differ_from_the_family_numbers_are_refused(tmp_path, change, named):
    from harness.manifest import Cell

    root = _copy(tmp_path)
    full = json.loads((root / "benchmark" / "workloads" / "rcnn-serve-b8.json").read_text())["limits"]
    limits = {k: 2 * v for k, v in full.items() if k not in ("rpn_nms", "proposals", "stage2")}
    if change == "add":
        limits["stage2"] = 2 * full["stage2"]
    else:
        del limits["heading"]
    _add_one_stage(root, limits)
    with pytest.raises(ValueError, match=f"cell {ONE_STAGE_CELL}: family 'onestage' .* {named}"):
        Cell(ONE_STAGE_CELL, root / "benchmark")


@pytest.mark.parametrize("stages,message", [
    (1, "family 'onestage' has one stage, yet its timed path called top_k_nms_batch"),
    (2, "family 'onestage' \\(2 stage\\(s\\)\\) made no top_k_nms_batch call .* misses the 'rpn' slot")])
def test_a_record_without_its_stages_slots_fails_the_run(tmp_path, monkeypatch, stages, message):
    """A one-stage family whose port calls the RPN's NMS, and a family file
    that says two stages of a port that makes no RPN call, fail the run at
    the first record, naming the family and the slot."""

    import run

    root = _copy(tmp_path)
    full = json.loads((root / "benchmark" / "workloads" / "rcnn-serve-b8.json").read_text())["limits"]
    _add_one_stage(root, None if stages == 1 else full)
    if stages == 2:
        family = root / "benchmark" / "families" / f"{ONE_STAGE}.py"
        family.write_text(family.read_text().replace("STAGES = 1", "STAGES = 2"))
    _teach_the_port_one_stage(monkeypatch, rpn_call=stages == 1)
    with pytest.raises(RuntimeError, match=message):
        run.main(["--workload", ONE_STAGE_CELL, "--seed", "3000000043", "--seconds", "0", "--trace", "0"],
                 device="cpu", bench_dir=root / "benchmark")
