"""The port's heading-flip analysis against the JAX package's tool, on the CPU.

A small synthetic prediction tree (ground truth, two prediction dirs with
jittered boxes, pi-flipped headings, missed and spurious detections, low
scores and another class) goes through ``tools/analyze_heading_flips.py``
and ``sparse_pooling_tpu_torch.experiments.analyze_heading_flips``: the
results and the printed lines must be the same, and the flip rates the
ones the tree was built with.
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

from sparse_pooling_tpu_torch.data.labels import ObjectLabel, write_labels  # noqa: E402
from sparse_pooling_tpu_torch.experiments import analyze_heading_flips as port_tool  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_heading_flips", os.path.join(ROOT, "tools", "analyze_heading_flips.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrap(a):
    return math.remainder(a, 2 * math.pi)


def _box(rng, cls):
    size = {"Car": (1.5, 1.6, 3.9), "Pedestrian": (1.7, 0.6, 0.8)}[cls]
    x, z = rng.uniform(-20, 20), rng.uniform(5, 60)
    ry = rng.uniform(-math.pi, math.pi)
    return ObjectLabel(type=cls, truncation=0.0, occlusion=0, alpha=_wrap(ry - math.atan2(x, z)),
                       x1=100.0, y1=150.0, x2=200.0, y2=220.0, h=size[0], w=size[1], l=size[2],
                       t=(x, 1.6, z), ry=ry)


def _detect(rng, gt, flip):
    """A detection of ``gt``: a few cm and degrees off, turned by pi if ``flip``."""

    ry = _wrap(gt.ry + rng.uniform(-0.1, 0.1) + (math.pi if flip else 0.0))
    t = (gt.t[0] + rng.uniform(-0.1, 0.1), gt.t[1], gt.t[2] + rng.uniform(-0.1, 0.1))
    return dataclasses.replace(gt, t=t, ry=ry, alpha=_wrap(ry - math.atan2(t[0], t[2])),
                               score=float(rng.uniform(0.35, 1.0)))


def _write_tree(base, seed, frames=6):
    """-> (gt_dir, dir_a, dir_b, the Car flips vs GT built into a and b: (flipped, matched))."""

    rng = np.random.default_rng(seed)
    dirs = [os.path.join(base, d) for d in ("gt", "a", "b")]
    for d in dirs:
        os.makedirs(d)
    counts = {"a": [0, 0], "b": [0, 0]}
    for i in range(frames):
        name = f"{i:06d}.txt"
        gts = [_box(rng, "Car") for _ in range(rng.integers(0, 6))] + [_box(rng, "Pedestrian")]
        preds = {"a": [], "b": []}
        for g in gts:
            # not too near another box, so each detection matches its own ground truth
            alone = all(o is g or math.hypot(o.t[0] - g.t[0], o.t[2] - g.t[2]) > 6 for o in gts)
            for tag in ("a", "b"):
                if not alone or rng.random() < 0.15:  # missed
                    continue
                flip = bool(rng.random() < 0.3)
                preds[tag].append(_detect(rng, g, flip))
                if g.type == "Car":
                    counts[tag][0] += flip
                    counts[tag][1] += 1
        for tag in ("a", "b"):
            spurious = _box(rng, "Car")
            spurious.t = (spurious.t[0], spurious.t[1], 80.0 + i)  # behind every ground truth
            preds[tag].append(spurious)
            low = _detect(rng, gts[-1], False)
            low.type, low.score = "Car", 0.1  # below min_score
            preds[tag].append(low)
            order = rng.permutation(len(preds[tag]))
            write_labels(os.path.join(base, tag, name), [preds[tag][j] for j in order])
        write_labels(os.path.join(dirs[0], name), gts)
    return (*dirs, counts)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("two_dirs", [False, True])
def test_heading_flips_match_the_jax_tool(tmp_path, capsys, monkeypatch, seed, two_dirs):
    gt_dir, dir_a, dir_b, counts = _write_tree(str(tmp_path), seed)
    dirs = [gt_dir, dir_a] + ([dir_b] if two_dirs else [])
    jax_tool = _jax_tool()
    for cls in ("Car", "Pedestrian"):
        for min_score in (0.3, 0.05):
            args = [*dirs, "--cls", cls, "--min_score", str(min_score)]
            ours = port_tool.main(args)
            ours_out = capsys.readouterr().out
            monkeypatch.setattr(sys, "argv", ["analyze_heading_flips.py", *args])
            jax_tool.main()
            theirs_out = capsys.readouterr().out
            assert ours == jax_tool.compare(*dirs, cls=cls, min_score=min_score)
            assert ours_out == theirs_out
    r = port_tool.compare(*dirs)
    assert r["gt_matched_a"] == counts["a"][1] > 0
    assert r["gt_flip_rate_a"] == counts["a"][0] / counts["a"][1]
    if two_dirs:
        assert r["gt_flip_rate_b"] == counts["b"][0] / counts["b"][1]
        assert r["pairs"] > 0 and r["fine_angle_median_deg"] < 12.0
    else:
        assert r["pairs"] == 0 and r["gt_flip_rate_b"] is None
