"""The port's drawing (``demos/raster.py``, ``demos/vis_utils.py``), its
``show_predictions`` CLI and the evaluator's prediction image against
Pillow and the JAX package.

Each primitive is byte-equal to Pillow's ``ImageDraw`` at widths 1, 2 and 3
(``hypothesis`` over segments, rectangles and polygons, off the canvas
too). ``draw_boxes_3d`` and ``render_bev`` equal the JAX package's,
``draw_boxes_2d`` outside its score text (the port draws its own digit
glyphs, Pillow its font); ``show_predictions`` writes the JAX CLI's pixels
on the same tree and predictions, and the port's ``Evaluator`` sweep writes
the image the JAX evaluator draws from the same prediction files.
"""

import dataclasses
import glob
import math
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax
PIL = pytest.importorskip("PIL")

from PIL import Image, ImageDraw  # noqa: E402

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import labels as j_labels  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu.demos import show_predictions as j_show  # noqa: E402
from sparse_pooling_tpu.demos import vis_utils as j_vis  # noqa: E402
from sparse_pooling_tpu.runtime import evaluator as j_evaluator  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.data import calib as t_calib  # noqa: E402
from sparse_pooling_tpu_torch.data import labels as t_labels  # noqa: E402
from sparse_pooling_tpu_torch.demos import raster  # noqa: E402
from sparse_pooling_tpu_torch.demos import show_predictions as t_show  # noqa: E402
from sparse_pooling_tpu_torch.demos import vis_utils as t_vis  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator  # noqa: E402
from test_torch_eval import T_EXT, eval_config  # noqa: E402

H, W = 48, 64
COORD = st.floats(-40.0, 110.0, allow_nan=False, allow_infinity=False)
POINT = st.tuples(COORD, COORD)


def _pillow(draw_fn) -> np.ndarray:
    img = Image.new("RGB", (W, H))
    draw_fn(ImageDraw.Draw(img))
    return np.asarray(img)


def _port(draw_fn) -> np.ndarray:
    img = np.zeros((H, W, 3), np.uint8)
    draw_fn(img)
    return img


@settings(max_examples=300, deadline=None)
@given(st.lists(POINT, min_size=2, max_size=4), st.sampled_from([1, 2, 3]))
def test_lines_are_pillows(xy, width):
    want = _pillow(lambda d: d.line(xy, fill=(255, 40, 7), width=width))
    np.testing.assert_array_equal(_port(lambda img: raster.line(img, xy, (255, 40, 7), width)), want)


@settings(max_examples=300, deadline=None)
@given(POINT, POINT, st.sampled_from([1, 2, 3]))
def test_rectangles_are_pillows(a, b, width):
    box = [min(a[0], b[0]), min(a[1], b[1]), max(a[0], b[0]), max(a[1], b[1])]
    want = _pillow(lambda d: d.rectangle(box, outline=(9, 200, 30), width=width))
    np.testing.assert_array_equal(_port(lambda img: raster.rectangle(img, box, (9, 200, 30), width)), want)


@settings(max_examples=300, deadline=None)
@given(st.lists(POINT, min_size=3, max_size=6))
def test_polygon_outlines_are_pillows(xy):
    want = _pillow(lambda d: d.polygon(xy, outline=(3, 4, 250)))
    np.testing.assert_array_equal(_port(lambda img: raster.polygon(img, xy, (3, 4, 250))), want)


def test_rectangle_refuses_a_reversed_box():
    with pytest.raises(ValueError):
        raster.rectangle(np.zeros((H, W, 3), np.uint8), [5, 5, 2, 9], (1, 1, 1))
    with pytest.raises(ValueError):
        ImageDraw.Draw(Image.new("RGB", (W, H))).rectangle([5, 5, 2, 9], outline=(1, 1, 1))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A JAX-written tree and one prediction file per frame: each frame's
    labels moved and scored, a box behind the camera, one off the image."""

    root = str(tmp_path_factory.mktemp("demo_tree"))
    j_syn.write_kitti_tree(root, num_frames=3, n_ground=4096, n_obj=256, val_frames=(1, 2))
    pred_dir = os.path.join(root, "preds")
    os.makedirs(pred_dir)
    rng = np.random.RandomState(0)
    for i in range(3):
        sid = f"{i:06d}"
        obs = j_labels.read_labels(os.path.join(root, "training", "label_2", sid + ".txt"))
        rows = []
        for ob in obs + obs[:1]:
            x, y, z = ob.t
            ob = dataclasses.replace(ob, t=(x + rng.uniform(-0.5, 0.5), y, z + rng.uniform(-0.5, 0.5)),
                                     ry=ob.ry + rng.uniform(-0.3, 0.3), score=float(rng.uniform(0.2, 0.99)))
            rows.append(ob)
        x, y, z = obs[0].t
        rows.append(dataclasses.replace(obs[0], t=(x, y, -3.0), score=0.5))  # behind the camera: skipped
        rows.append(dataclasses.replace(obs[0], t=(x + 40.0, y, z), score=0.6))  # projects off the image
        j_labels.write_labels(os.path.join(pred_dir, sid + ".txt"), rows)
    return root, pred_dir


def _both_labels(path):
    return t_labels.read_labels(path), j_labels.read_labels(path)


def _frame(root, sid):
    base = os.path.join(root, "training")
    image = np.asarray(Image.open(os.path.join(base, "image_2", sid + ".png")).convert("RGB"))
    cal = t_calib.read_calibration(os.path.join(base, "calib", sid + ".txt"))
    return image, cal.p2


@pytest.mark.parametrize("sid", ["000000", "000001"])
def test_draw_boxes_3d_matches_jax(tree, sid):
    root, pred_dir = tree
    t_obs, j_obs = _both_labels(os.path.join(pred_dir, sid + ".txt"))
    image, p2 = _frame(root, sid)
    for width in (1, 2):
        got = t_vis.draw_boxes_3d(image, t_obs, p2, width=width)
        np.testing.assert_array_equal(got, j_vis.draw_boxes_3d(image, j_obs, p2, width=width))
        assert (got != image).any()
    gt_t, gt_j = _both_labels(os.path.join(root, "training", "label_2", sid + ".txt"))
    np.testing.assert_array_equal(t_vis.draw_boxes_3d(image, gt_t, p2, color_key="gt"),
                                  j_vis.draw_boxes_3d(image, gt_j, p2, color_key="gt"))


def test_draw_boxes_2d_matches_jax_outside_the_score_text(tree):
    root, pred_dir = tree
    t_obs, j_obs = _both_labels(os.path.join(pred_dir, "000000.txt"))
    image, _ = _frame(root, "000000")
    for width in (1, 2):
        got, want = t_vis.draw_boxes_2d(image, t_obs, width=width), j_vis.draw_boxes_2d(image, j_obs, width=width)
        outside = np.ones(image.shape[:2], bool)
        probe = ImageDraw.Draw(Image.new("RGB", (10, 10)))
        for ob in t_obs:
            if ob.score < 1.0:
                origin, text = t_vis.score_text_origin(ob), f"{ob.score:.2f}"
                for x0, y0, x1, y1 in (probe.textbbox(origin, text), raster.text_bbox(origin, text)):
                    # Pillow places its glyphs at the rounded origin: one pixel of margin
                    x0, y0 = max(math.floor(x0) - 1, 0), max(math.floor(y0) - 1, 0)
                    outside[y0:max(math.ceil(y1) + 1, 0), x0:max(math.ceil(x1) + 1, 0)] = False
                x0, y0, x1, y1 = raster.text_bbox(origin, text)
                assert (got[max(y0, 0):y1, max(x0, 0):x1] != image[max(y0, 0):y1, max(x0, 0):x1]).any()
        np.testing.assert_array_equal(got[outside], want[outside])
        assert outside.mean() > 0.97 and (got[outside] != image[outside]).any()


def test_render_bev_matches_jax(tree):
    root, pred_dir = tree
    t_obs, j_obs = _both_labels(os.path.join(pred_dir, "000001.txt"))
    gt_t, gt_j = _both_labels(os.path.join(root, "training", "label_2", "000001.txt"))
    rng = np.random.RandomState(1)
    maps = rng.rand(704, 800, 6).astype(np.float32) * (rng.rand(704, 800, 1) > 0.9)
    got = t_vis.render_bev(maps, boxes_3d=t_labels.labels_to_box3d_array(t_obs),
                           gt_boxes_3d=t_labels.labels_to_box3d_array(gt_t))
    want = j_vis.render_bev(maps, boxes_3d=j_labels.labels_to_box3d_array(j_obs),
                            gt_boxes_3d=j_labels.labels_to_box3d_array(gt_j), extents=jcfg_mod.AreaExtents())
    np.testing.assert_array_equal(got, want)
    assert got.flags.c_contiguous and (got == t_vis.CLASS_COLORS["gt"]).all(-1).any()


def test_show_predictions_writes_the_jax_pixels(tree, tmp_path):
    root, pred_dir = tree
    outs = {}
    for name, mod in (("port", t_show), ("jax", j_show)):
        outs[name] = str(tmp_path / name)
        mod.main(["--dataset_root", root, "--pred_dir", pred_dir, "--out_dir", outs[name], "--draw_gt"])
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == files and len(files) == 6
    for f in files:
        got = np.asarray(Image.open(os.path.join(outs["port"], f)).convert("RGB"))
        np.testing.assert_array_equal(got, np.asarray(Image.open(os.path.join(outs["jax"], f)).convert("RGB")), f)


class _Stub:
    """What ``_image_summary`` reads of an evaluator: the tree and a writer
    that keeps the image."""

    def __init__(self, base):
        self.dataset = type("D", (), {"base": base})()
        self.summary = self
        self.images = []

    def image(self, step, tag, image_hwc):
        self.images.append((step, tag, np.asarray(image_hwc)))


def test_evaluator_writes_the_jax_prediction_image(tree, tmp_path, monkeypatch, capsys):
    """A sweep on the CPU writes ``eval_summaries/images/predictions_<sid>_<step>.png``,
    the JAX evaluator's drawing of the same prediction file; a drawing that
    raises prints and the sweep goes on."""

    root, _ = tree
    cfg = eval_config(root)
    ev = Evaluator(cfg, extents=T_EXT, workdir=str(tmp_path), device="cpu")
    model = t_pl.make_model(cfg.model, T_EXT, device="cpu")
    weights.init_like_flax(model, seed=0)
    res = ev.run_checkpoint_once(1, state_dict=model.state_dict())
    sid = ev.dataset.sample_ids[0]
    png = os.path.join(str(tmp_path), "eval_summaries", "images", f"predictions_{sid}_{1:08d}.png")
    assert os.path.exists(png) and res["num_frames"] == 2
    pred_dir = glob.glob(os.path.join(str(tmp_path), "predictions", "kitti_native_eval", "*", "1", "data"))[0]
    stub = _Stub(ev.dataset.base)
    j_evaluator.Evaluator._image_summary(stub, 1, pred_dir, sid)
    (_, tag, want), = stub.images
    assert tag == f"predictions/{sid}"
    np.testing.assert_array_equal(np.asarray(Image.open(png).convert("RGB")), want)

    def broken(*args, **kwargs):
        raise RuntimeError("no drawing")

    monkeypatch.setattr(t_vis, "draw_boxes_3d", broken)
    res = ev.run_checkpoint_once(2, state_dict=model.state_dict())
    assert res["num_frames"] == 2 and "image summary failed: no drawing" in capsys.readouterr().out
    assert torch.isfinite(torch.tensor(res["ap"]["Car"]["3d"]["moderate"]))
