"""The port's IoU decomposition tools against the JAX package's, on the CPU.

* ``experiments.analyze_2d_gap.analyze`` and ``tools/analyze_2d_gap.py``'s
  (loaded by path; ``tools/`` stays as it is) over the same synthetic GT,
  calib and prediction dirs (detections jittered in each box parameter
  group, spurious, low-score and other-class rows): the same rows, every
  field within 1e-6, and the same printed tables;
* a known answer: a detection that is its ground truth with y and h moved
  keeps BEV IoU 1, loses 3D IoU, and ``3d|gt_hy`` gives it back;
* ``experiments.rcnn_2d_gap_check`` for a few steps on the CPU: both arms'
  prediction dirs written, the decomposition printed; its training config
  of each default arm equal to the JAX tool's;
* the two new modules are under the port's import check.
"""

import dataclasses
import importlib.util
import math
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX tool imports the JAX package

from sparse_pooling_tpu_torch.data import synthetic  # noqa: E402
from sparse_pooling_tpu_torch.data.labels import read_labels, write_labels  # noqa: E402
from sparse_pooling_tpu_torch.experiments import analyze_2d_gap as port_tool  # noqa: E402
from sparse_pooling_tpu_torch.experiments import rcnn_2d_gap_check  # noqa: E402
from test_torch_port import FORBIDDEN, REPO, _imported_roots, _port_files  # noqa: E402

HW = (375, 1242)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_2d_gap", os.path.join(REPO, "tools", "analyze_2d_gap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gt_tree(tmp_path_factory):
    """Ground truth and calib of eight car frames (the port's tree writer)."""

    root = str(tmp_path_factory.mktemp("gap_tree"))
    synthetic.write_kitti_tree(root, num_frames=8, n_ground=256, n_obj=64, val_frames=(), scene="cars_hard")
    return os.path.join(root, "training", "label_2")


def _write_predictions(gt_dir, out_dir, seed):
    """Each GT car detected with one parameter group off (or none), scored;
    a missed car now and then, a spurious box, a low-score box and a
    pedestrian a frame."""

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir)
    for fname in sorted(os.listdir(gt_dir)):
        dets = []
        for g in read_labels(os.path.join(gt_dir, fname)):
            if g.type != "Car" or rng.random() < 0.1:
                continue
            x, y, z = g.t
            jit = {"hy": ("h", "y"), "lw": ("l", "w"), "xz": ("x", "z"), "ry": ("ry",), "none": ()}[
                rng.choice(["hy", "lw", "xz", "ry", "none"])]
            d = {"x": x, "y": y, "z": z, "l": g.l, "w": g.w, "h": g.h, "ry": g.ry}
            for k in jit:
                d[k] += rng.uniform(-0.4, 0.4)
            box = [g.x1 + rng.uniform(-8, 8), g.y1 + rng.uniform(-8, 8), g.x2 + rng.uniform(-8, 8),
                   g.y2 + rng.uniform(-8, 8)]
            dets.append(dataclasses.replace(g, t=(d["x"], d["y"], d["z"]), l=d["l"], w=d["w"], h=d["h"],
                                            ry=math.remainder(d["ry"], 2 * math.pi), x1=box[0], y1=box[1],
                                            x2=box[2], y2=box[3], score=float(rng.uniform(0.15, 1.0))))
        if dets:
            base = dets[0]
            dets.append(dataclasses.replace(base, t=(base.t[0], base.t[1], base.t[2] + 60.0)))  # aimed at nothing
            dets.append(dataclasses.replace(base, score=0.05))  # below min_score
            dets.append(dataclasses.replace(base, type="Pedestrian"))
        write_labels(os.path.join(out_dir, fname), [dets[i] for i in rng.permutation(len(dets))])
    return out_dir


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_matches_the_jax_tool(gt_tree, tmp_path, capsys, monkeypatch, seed):
    pred_a = _write_predictions(gt_tree, str(tmp_path / "a"), seed)
    pred_b = _write_predictions(gt_tree, str(tmp_path / "b"), seed + 10)
    calib_dir = port_tool.calib_dir_of(gt_tree)
    jax_tool = _jax_tool()
    for cls, min_score in (("Car", 0.1), ("Car", 0.5), ("Pedestrian", 0.1)):
        for pred in (pred_a, pred_b):
            ours = port_tool.analyze(gt_tree, pred, calib_dir, cls, min_score, HW)
            theirs = jax_tool.analyze(gt_tree, pred, calib_dir, cls, min_score, HW)
            assert len(ours) == len(theirs)
            assert (len(ours) > 10) == (cls == "Car")
            for got, want in zip(ours, theirs):
                assert got.keys() == want.keys()
                for k in want:
                    assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
        args = [gt_tree, pred_a, pred_b, "--cls", cls, "--min_score", str(min_score)]
        port_tool.main(args)
        ours_out = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["analyze_2d_gap.py", *args])
        jax_tool.main()
        assert ours_out == capsys.readouterr().out


def test_vertical_error_is_what_gt_hy_gives_back(gt_tree, tmp_path):
    out = tmp_path / "moved"
    out.mkdir()
    for fname in sorted(os.listdir(gt_tree)):
        dets = [dataclasses.replace(g, t=(g.t[0], g.t[1] + 0.3, g.t[2]), h=g.h * 0.8, score=0.9)
                for g in read_labels(os.path.join(gt_tree, fname)) if g.type == "Car"]
        write_labels(str(out / fname), dets)
    rows = port_tool.analyze(gt_tree, str(out), port_tool.calib_dir_of(gt_tree), "Car", 0.1, HW)
    assert rows
    s = port_tool.summarize(rows)
    assert s["bev"]["median"] == pytest.approx(1.0) and s["3d|gt_hy"]["median"] == pytest.approx(1.0)
    assert s["iou3d"]["median"] < 0.8 and s["2d|gt_lw"]["median"] < s["2d|gt_hy"]["median"]
    assert set(s) == set(port_tool.KEYS)


def test_rcnn_2d_gap_check_runs_on_the_cpu(tmp_path, capsys):
    runs = rcnn_2d_gap_check.main(["--steps", "2", "--train_frames", "4", "--val_frames", "2", "--device", "cpu",
                                   "--workdir", str(tmp_path), "--arms", "avod,rcnn:offsets"])
    out = capsys.readouterr().out
    assert list(runs) == ["avod", "rcnn:offsets"]
    for arm, run in runs.items():
        assert run["step"] == 2 and sorted(os.listdir(run["pred_dir"])) == ["000004.txt", "000005.txt"]
        assert f"[{arm}] held-out moderate Car AP (40-pt): 2d=" in out
        assert f"== {run['pred_dir']}" in out or f"{run['pred_dir']}: no matched detections" in out
    assert "[decomposition] per-axis counterfactual IoUs" in out
    assert os.path.isdir(tmp_path / "exp" / "gap_avod") and os.path.isdir(tmp_path / "exp" / "gap_rcnn_offsets")


@pytest.mark.parametrize("arch", ["avod", "rcnn"])
def test_arm_config_is_the_jax_tools(arch):
    """The port's training config of a default arm is the one
    ``tools/rcnn_2d_gap_check.py`` builds (its ``main``, written out)."""

    from sparse_pooling_tpu.configs import unittest_config as j_unittest_config
    from sparse_pooling_tpu.configs.config import EvalConfig, OptimizerConfig, pipeline_config_from_dict

    root, workdir, steps = "/tree", "/work", 2000
    base = j_unittest_config(dataset_root=root)
    want = dataclasses.replace(
        base, checkpoint_name=f"gap_{arch}", experiments_dir=f"{workdir}/exp",
        model=dataclasses.replace(base.model, architecture=arch),
        train=dataclasses.replace(
            base.train, batch_size=4, max_iterations=steps, checkpoint_interval=steps,
            summary_interval=max(steps // 10, 1),
            optimizer=OptimizerConfig(initial_lr=8e-4, decay_steps=steps // 2, decay_rate=0.5)),
        eval=EvalConfig(kitti_score_threshold=0.05, batch_size=4, ap_n_points=40),
        dataset=dataclasses.replace(base.dataset, split="train", aug_flip=True, shuffle=True))
    got = rcnn_2d_gap_check.arm_config(root, workdir, steps, arch)
    assert pipeline_config_from_dict(dataclasses.asdict(got)) == want


def test_arm_model_sets_the_stage_2_options():
    from sparse_pooling_tpu_torch.configs import unittest_config

    model = unittest_config().model
    m = rcnn_2d_gap_check.arm_model(model, "avod:box_4c:4")
    assert (m.architecture, m.avod.box_rep, m.avod.bev_roi_stride) == ("avod", "box_4c", 4)
    m = rcnn_2d_gap_check.arm_model(model, "rcnn")
    assert (m.architecture, m.avod.box_rep, m.avod.bev_roi_stride) == ("rcnn", model.avod.box_rep, 1)


def test_import_check_covers_the_gap_tools():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("experiments/analyze_2d_gap.py", "experiments/rcnn_2d_gap_check.py"):
        assert f"sparse_pooling_tpu_torch/{module}" in names, module
        assert not _imported_roots(REPO / "sparse_pooling_tpu_torch" / module) & set(FORBIDDEN), module
