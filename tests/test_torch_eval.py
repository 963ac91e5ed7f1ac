"""The port's KITTI evaluation against the JAX package's, on the CPU.

Inputs are seeded: a tree written by the JAX package's ``write_kitti_tree``
(five frames, three in ``val``), label and detection directories drawn with
numpy, the JAX model's own init carried over by ``weights.from_flax``.

* ``runtime.metrics`` (the numpy oracle): the overlaps on random boxes and
  ``evaluate_frames`` on the cases of tests/test_metrics.py equal the JAX
  oracle exactly, at 11 and 40 points; ``evaluate_dirs`` too, on seeded
  directories with don't-care, occluded, truncated and small boxes and Vans
  among the cars;
* ``native/kitti_eval``: the library equals the oracle and the JAX package's
  library to 1e-12 (the tolerance of tests/test_native_eval.py), and its
  ``evaluate_object_3d`` CLI prints what the library returns;
* ``runtime.predictions``: ``write_predictions`` writes the JAX writer's
  bytes, and the native formatter the Python formatter's, for boxes behind
  the camera, boxes clipped to the image, scores on the threshold and frames
  with nothing valid;
* ``runtime.evaluator``: the port's ``Evaluator`` and the JAX one over the
  same tree and weights at eval batch 2 (three frames: the tail batch is
  padded) write the same files with the same rows and classes, numbers
  within 1e-3 px for the 2D box and 1e-4 for the 3D box and score (the
  slice test's tolerances of tests/test_torch_model.py carried through the
  projection), proposals within 1e-4, AP within 1e-6; the readback groups
  and the inline writer give the same bytes; a sweep over two f32
  checkpoints into a bf16 serving model is idempotent;
* the evaluation and inference CLIs on the CPU; inference at batch 1 writes
  the evaluator's rows.

The evaluator on the card is held against the CPU in tests/test_torch_port.py
(which needs no JAX).
"""

import dataclasses
import glob
import hashlib
import json
import os
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import labels as j_labels  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu.native import kitti_eval as j_keval  # noqa: E402
from sparse_pooling_tpu.native import pred_format as j_pred_format  # noqa: E402
from sparse_pooling_tpu.runtime import evaluator as j_evaluator  # noqa: E402
from sparse_pooling_tpu.runtime import metrics as j_metrics  # noqa: E402
from sparse_pooling_tpu.runtime import predictions as j_pred  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import cars_pyramid_config  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data import labels as t_labels  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.native import kitti_eval as t_keval  # noqa: E402
from sparse_pooling_tpu_torch.native import pred_format as t_pred_format  # noqa: E402
from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod  # noqa: E402
from sparse_pooling_tpu_torch.runtime import metrics as t_metrics  # noqa: E402
from sparse_pooling_tpu_torch.runtime import predictions as t_pred  # noqa: E402
from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator  # noqa: E402
from sparse_pooling_tpu_torch.runtime.summary import read_scalars  # noqa: E402

METRICS, DIFFS = ("2d", "bev", "3d", "aos"), ("easy", "moderate", "hard")
N_FRAMES, VAL = 5, (2, 3, 4)
STEP = 1
TOL_2D, TOL_3D = 1e-3, 1e-4  # px; m, rad and score


def _assert_ap_close(got, want, tol):
    assert got.keys() == want.keys()
    for cls in want:
        assert got[cls].keys() == want[cls].keys() == set(METRICS)
        for m in METRICS:
            assert got[cls][m].keys() == set(DIFFS)
            for d in DIFFS:
                assert abs(got[cls][m][d] - want[cls][m][d]) <= tol, (cls, m, d)


# ---------------------------------------------------------------- the oracle

def test_overlaps_match_jax_exactly():
    rng = np.random.RandomState(0)
    def boxes(n):
        xy = rng.uniform(0, 400, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(5, 100, (n, 2))], axis=1)  # x1, y1, x2, y2

    a, b = boxes(9), boxes(7)
    b[:3] = a[:3] + rng.normal(0, 10, (3, 4))  # overlapping pairs
    np.testing.assert_array_equal(t_metrics.bbox2d_iou(a, b), j_metrics.bbox2d_iou(a, b))
    assert (t_metrics.bbox2d_iou(a, b) > 0).any()
    assert t_metrics.bbox2d_iou(a[:0], b).shape == (0, 7)
    for _ in range(200):
        box = np.concatenate([rng.uniform(-5, 5, 1), rng.uniform(1, 2, 1), rng.uniform(10, 20, 1),
                              rng.uniform(0.5, 5, 3), rng.uniform(-np.pi, np.pi, 1)])
        other = box + np.concatenate([rng.normal(0, 1.5, 3), rng.normal(0, 0.5, 3), rng.normal(0, 1, 1)])
        other[3:6] = np.abs(other[3:6]) + 0.1
        a5, b5 = box[[0, 2, 3, 4, 6]], other[[0, 2, 3, 4, 6]]
        assert t_metrics.rotated_overlap_bev(a5, b5) == j_metrics.rotated_overlap_bev(a5, b5)
        assert t_metrics.bev_iou(a5, b5) == j_metrics.bev_iou(a5, b5)
        assert t_metrics.iou_3d(box, other) == j_metrics.iou_3d(box, other)


def _obj(L, cls="Car", x=0.0, y=1.65, z=20.0, l=4.0, w=2.0, h=1.5, ry=0.0,
         x1=100, y1=100, x2=200, y2=160, score=1.0, occ=0, trunc=0.0):
    return L.ObjectLabel(type=cls, truncation=trunc, occlusion=occ, alpha=0.0, x1=x1, y1=y1, x2=x2,
                         y2=y2, h=h, w=w, l=l, t=(x, y, z), ry=ry, score=score)


def _like(ob, **kw):
    return dataclasses.replace(ob, **kw)


def _perfect(L, n=5):
    frames = []
    for i in range(n):
        gt = [_obj(L, z=10.0 + i), _obj(L, x=5.0, z=30.0 + i, x1=300, x2=400, y1=100, y2=150)]
        frames.append((gt, [_like(g, score=0.9 - 0.1 * j) for j, g in enumerate(gt)]))
    return frames


def _with_fps(L):
    frames = _perfect(L, 2)
    for _, det in frames:
        det.append(_obj(L, x=-20.0, z=60.0, x1=0, x2=30, y1=0, y2=30, score=0.95))
    return frames


def _small_gt(L):
    gt = [_obj(L, y1=100, y2=130)]
    return [(gt, [_like(gt[0], score=0.9)])]


def _van(L):
    van, car = _obj(L, cls="Van"), _obj(L, x=5.0, z=30.0, x1=300, x2=400)
    return [([van, car], [_like(van, type="Car", score=0.95), _like(car, score=0.9)])]


def _small_det(L):
    easy, hard = _obj(L, y1=100, y2=160), _obj(L, x=6.0, z=60.0, x1=500, x2=530, y1=100, y2=130)
    return [([easy, hard], [_like(hard, score=0.95), _like(easy, score=0.9)])]


def _small_unmatched(L):
    easy = _obj(L, y1=100, y2=160)
    spurious = _obj(L, x=7.0, z=65.0, x1=600, x2=620, y1=100, y2=120, score=0.99)
    return [([easy], [spurious, _like(easy, score=0.9)])]


def _headings(L, d_alpha, d_ry):
    return [(gt, [_like(d, alpha=d.alpha + d_alpha, ry=d.ry + d_ry) for d in det]) for gt, det in _perfect(L)]


# the AP cases of tests/test_metrics.py, each a function of the labels module
AP_CASES = {
    "perfect": _perfect,
    "no_detections": lambda L: [([_obj(L)], [])],
    "false_positives": _with_fps,
    "easy_band_excludes_small_gt": _small_gt,
    "van_gt_ignored_for_car": _van,
    "small_detection_not_fp_in_easy": _small_det,
    "small_unmatched_detection_not_fp": _small_unmatched,
    "localization_threshold": lambda L: [([_obj(L)], [_obj(L, x=1.5, score=0.9)])],
    "aos_flipped_headings": lambda L: _headings(L, np.pi, np.pi),
    "aos_partial_heading_error": lambda L: _headings(L, np.pi / 2, 0.0),
    "dontcare_occluded_truncated": lambda L: [(
        [_obj(L), _obj(L, cls="DontCare", x=5.0, z=30.0, x1=300, x2=400),
         _obj(L, x=-6.0, z=25.0, x1=500, x2=600, occ=2), _obj(L, x=8.0, z=40.0, x1=700, x2=790, trunc=0.4)],
        [_obj(L, score=0.8), _obj(L, x=5.0, z=30.0, x1=300, x2=400, score=0.7),
         _obj(L, x=-6.1, z=25.2, x1=502, x2=601, score=0.6), _obj(L, x=8.0, z=40.3, x1=700, x2=788, score=0.5)])],
}


@pytest.mark.parametrize("n_points", [11, 40])
@pytest.mark.parametrize("case", sorted(AP_CASES))
def test_ap_cases_match_jax_exactly(case, n_points, tmp_path):
    """``evaluate_frames`` of both oracles, and the port's native evaluator
    against its oracle over the case written as label files."""

    def run(L, M):
        return M.evaluate_frames([M.FrameData(gt=g, det=d) for g, d in AP_CASES[case](L)],
                                 ["Car", "Pedestrian"], n_points)

    got = run(t_labels, t_metrics)
    assert got == run(j_labels, j_metrics)
    gt_dir, det_dir = tmp_path / "gt", tmp_path / "det"
    gt_dir.mkdir()
    det_dir.mkdir()
    for i, (gt, det) in enumerate(AP_CASES[case](t_labels)):
        t_labels.write_labels(str(gt_dir / f"{i:06d}.txt"), gt)
        t_labels.write_labels(str(det_dir / f"{i:06d}.txt"), det)
    oracle = t_metrics.evaluate_dirs(str(gt_dir), str(det_dir), ["Car"], n_points)
    _assert_ap_close(t_keval.evaluate_dirs(str(gt_dir), str(det_dir), ["Car"], n_points), oracle, 1e-12)


@pytest.fixture(scope="module")
def label_dirs(tmp_path_factory):
    """Seeded label and detection directories: Cars, Vans, Pedestrians,
    Cyclists, don't-care boxes, occlusion 0-2, truncation up to 0.6, boxes
    from 15 px tall, and one frame with no detections."""

    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("apdirs")
    gt_dir, det_dir = d / "gt", d / "det"
    gt_dir.mkdir()
    det_dir.mkdir()
    classes = ["Car", "Car", "Van", "Pedestrian", "Cyclist", "DontCare"]
    for i in range(16):
        gts, dets = [], []
        for _ in range(rng.randint(1, 9)):
            cls = classes[rng.randint(0, len(classes))]
            x, z = rng.uniform(-20, 20), rng.uniform(5, 60)
            l, w, h = rng.uniform(1, 4.5), rng.uniform(0.5, 2), rng.uniform(1, 2)
            ry, alpha = rng.uniform(-np.pi, np.pi), float(rng.uniform(-np.pi, np.pi))
            y1 = rng.uniform(80, 200)
            y2, x1 = y1 + rng.uniform(15, 120), rng.uniform(0, 1000)
            x2 = x1 + rng.uniform(20, 200)
            gts.append(t_labels.ObjectLabel(cls, float(rng.uniform(0, 0.6)), int(rng.randint(0, 3)), alpha,
                                            x1, y1, x2, y2, h, w, l, (x, 1.65, z), ry))
            if i != 5 and rng.rand() < 0.8:
                n = rng.normal(0, 0.1, 3)
                det_cls = {"Van": "Car", "DontCare": "Car"}.get(cls, cls)
                dets.append(t_labels.ObjectLabel(
                    det_cls, 0, 0, alpha + float(rng.normal(0, 0.5)), x1 + rng.normal(0, 2),
                    y1 + rng.normal(0, 2), x2 + rng.normal(0, 2), y2 + rng.normal(0, 2), h + n[0] * 0.1,
                    w + n[1] * 0.1, l + n[2] * 0.1, (x + n[0], 1.65, z + n[2]), ry + rng.normal(0, 0.05),
                    score=float(rng.rand())))
        t_labels.write_labels(str(gt_dir / f"{i:06d}.txt"), gts)
        t_labels.write_labels(str(det_dir / f"{i:06d}.txt"), dets)
    return str(gt_dir), str(det_dir)


CLASSES = ["Car", "Pedestrian", "Cyclist"]


@pytest.mark.parametrize("n_points", [11, 40])
def test_evaluate_dirs_matches_jax_exactly(label_dirs, n_points):
    got = t_metrics.evaluate_dirs(*label_dirs, CLASSES, n_points)
    assert got == j_metrics.evaluate_dirs(*label_dirs, CLASSES, n_points)
    assert got["Car"]["3d"]["moderate"] > 0 and got["Car"]["aos"]["moderate"] > 0


# ---------------------------------------------------------------- native evaluator

@pytest.mark.parametrize("n_points", [11, 40])
def test_native_evaluator_matches_the_oracle_and_jax(label_dirs, n_points):
    got = t_keval.evaluate_dirs(*label_dirs, CLASSES, n_points)
    _assert_ap_close(got, t_metrics.evaluate_dirs(*label_dirs, CLASSES, n_points), 1e-12)
    _assert_ap_close(got, j_keval.evaluate_dirs(*label_dirs, CLASSES, n_points), 1e-12)
    for cls in CLASSES:
        for d in DIFFS:
            assert got[cls]["aos"][d] <= got[cls]["2d"][d] + 1e-12


def test_native_evaluator_of_an_empty_directory_is_zero(label_dirs, tmp_path):
    ap = t_keval.evaluate_dirs(label_dirs[0], str(tmp_path), CLASSES)
    assert ap == t_metrics.evaluate_dirs(label_dirs[0], str(tmp_path), CLASSES)
    assert all(v == 0.0 for m in ap.values() for ds in m.values() for v in ds.values())


def test_evaluate_object_3d_cli_prints_the_library(label_dirs):
    out = subprocess.run([str(t_keval.build_cli()), *label_dirs, ",".join(CLASSES), "40"],
                         capture_output=True, text=True, check=True).stdout.splitlines()
    assert out[0] == "evaluated 16 frames"
    lib = t_keval.evaluate_dirs(*label_dirs, CLASSES, 40)
    want = [f"{cls} AP_{m}: " + " ".join(f"{d}={lib[cls][m][d]:.4f}" for d in DIFFS)
            for cls in CLASSES for m in METRICS]
    assert out[1:] == want


def test_native_evaluator_built_with_a_static_cxx_runtime(label_dirs, tmp_path, monkeypatch):
    """A compiler that links the C++ runtime statically (as the card
    machine's ``$CXX`` does) into a library loaded beside the process's
    shared runtime: the library keeps its own symbols and still equals the
    oracle (mixed, its iostreams parsed no row)."""

    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nexec g++ "$@" -static-libstdc++ -static-libgcc\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(t_keval, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_keval, "_lib", None)
    monkeypatch.setenv("CXX", str(cxx))
    got = t_keval.evaluate_dirs(*label_dirs, CLASSES, 40)
    _assert_ap_close(got, t_metrics.evaluate_dirs(*label_dirs, CLASSES, 40), 1e-12)
    assert got["Car"]["3d"]["moderate"] > 0


@pytest.mark.parametrize("module", [t_keval, t_pred_format])
def test_failed_native_build_raises_with_the_compiler_output(module, tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'native.cpp:1: error: no luck' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(module, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="no luck"):
        module.library()
    monkeypatch.setenv("CXX", str(tmp_path / "missing-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        module.build()
    assert not list((tmp_path / "build").iterdir())


# ---------------------------------------------------------------- the writer

P2_RAW = np.array([[721.5377, 0.0, 609.5593, 44.85728], [0.0, 721.5377, 172.854, 0.2163791],
                   [0.0, 0.0, 1.0, 0.002745884]])


def _detections(seed, c=2, k=24):
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(-30, 30, (c, k)), rng.uniform(0.5, 2.5, (c, k)), rng.uniform(2, 70, (c, k)),
                      rng.uniform(0.5, 4.5, (c, k)), rng.uniform(0.4, 2.0, (c, k)), rng.uniform(0.8, 2.0, (c, k)),
                      rng.uniform(-np.pi, np.pi, (c, k))], axis=-1).astype(np.float32)
    boxes[0, 0, 2] = -5.0  # behind the camera: non-finite projections
    boxes[0, 1, 2] = 0.3  # straddles the image plane
    boxes[1, 0, [0, 2]] = (-28.0, 3.0)  # clipped at the image's left edge
    scores = rng.uniform(0, 1, (c, k)).astype(np.float32)
    scores[:, 2] = 0.25  # on the threshold: kept
    valid = rng.rand(c, k) < 0.8
    return {"boxes_3d": boxes, "scores": scores, "valid": valid}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_predictions_matches_jax_bytes(seed, tmp_path):
    det = _detections(seed)
    classes = ["Car", "Pedestrian"]
    for thresh in (0.0, 0.25):
        t_pred.write_predictions(str(tmp_path / "t"), "000007", det, classes, P2_RAW, (375, 1242), thresh)
        j_pred.write_predictions(str(tmp_path / "j"), "000007", det, classes, P2_RAW, (375, 1242), thresh)
        got = (tmp_path / "t" / "000007.txt").read_bytes()
        assert got == (tmp_path / "j" / "000007.txt").read_bytes()
        rows = t_pred.detections_to_kitti_rows(det, classes, P2_RAW, (375, 1242), thresh)
        assert got == "".join(r + "\n" for r in rows).encode()
        assert 0 < len(rows) < int(det["valid"].sum())  # the non-finite and off-image boxes are gone
        x1, x2 = (np.array([float(r.split()[i]) for r in rows]) for i in (4, 6))
        assert x1.min() == 0.0 and x2.max() <= 1241
    nothing = dict(det, valid=np.zeros_like(det["valid"]))
    t_pred.write_predictions(str(tmp_path / "t"), "000008", nothing, classes, P2_RAW, (375, 1242), 0.0)
    assert (tmp_path / "t" / "000008.txt").read_bytes() == b""


def test_native_formatter_matches_the_python_formatter():
    rng = np.random.RandomState(7)
    num = rng.uniform(-100, 1500, (257, 13))
    num[0] = [0.0, -0.0, 1e-7, 1241.0, 374.999999, 0.5, 0.5, 0.5, -39.9999995, 1.5, 69.999999, -3.14159265, 1.0]
    cls = rng.randint(0, 3, 257).astype(np.int32)
    names = ["Car", "Pedestrian", "Cyclist"]
    fmt = " ".join(["%.6f"] * 13)
    want = "".join(f"{names[c]} -1 -1 " + fmt % tuple(r) + "\n" for c, r in zip(cls, num)).encode()
    assert t_pred_format.format_rows(num, cls, names) == want == j_pred_format.format_rows(num, cls, names)
    assert t_pred_format.format_rows(np.zeros((0, 13)), np.zeros((0,), np.int32), names) == b""
    with pytest.raises(ValueError):
        t_pred_format.format_rows(num, np.full(257, 3, np.int32), names)  # a class out of range
    with pytest.raises(ValueError):
        t_pred_format.format_rows(num, cls, [f"c{i}" for i in range(65)])


def test_corner_twin_matches_the_port_encoder():
    from sparse_pooling_tpu_torch.ops import encoders

    boxes = _detections(3)["boxes_3d"].reshape(-1, 7).astype(np.float64)
    want = encoders.box_3d_to_corners(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(t_pred._box_3d_to_corners_np(boxes), want, atol=1e-12)
    np.testing.assert_array_equal(t_pred._box_3d_to_corners_np(boxes), j_pred._box_3d_to_corners_np(boxes))


# ---------------------------------------------------------------- the evaluator

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_tree"))
    j_syn.write_kitti_tree(root, num_frames=N_FRAMES, n_ground=6000, n_obj=300, val_frames=VAL)
    return root


def eval_config(root, dtype="float32", **evals):
    """The narrow parity config of tests/test_torch_data.py (the cars
    preset's 384x1248 canvas over the 375x1242 raw images, thin layers,
    1024 points) over the ``val`` split, eval batch 2, every detection
    written (score thresholds 0: random weights score low), RPN proposals
    saved."""

    cfg = cars_pyramid_config()
    m = cfg.model
    r = dataclasses.replace
    model = r(
        m,
        sparse_pool=r(m.sparse_pool, max_points=1024, point_buckets=(512,), pool_channels=4),
        anchors=r(m.anchors, max_anchors=256),
        backbone=r(m.backbone, channels=(4, 4, 4, 4), blocks=(1, 1, 1, 1), out_channels=4, compute_dtype=dtype),
        rpn=r(m.rpn, roi_channels=4, fusion_channels=8, pre_nms_top_k=128, eval_nms_size=16, train_nms_size=16),
        avod=r(m.avod, fc_layers=(16,), nms_size=8, keep_dropout_prob=1.0),
        path_drop=r(m.path_drop, enabled=False),
    )
    ev = r(cfg.eval, **{"batch_size": 2, "kitti_score_threshold": 0.0, "score_threshold": 0.0,
                        "save_rpn_proposals": True, "num_workers": 2, **evals})
    return r(cfg, model=model, dataset=r(cfg.dataset, root=root, split="val"), eval=ev)


T_EXT = tcfg_mod.AreaExtents(x_min=-20.0, x_max=20.0, z_min=0.0, z_max=39.6)  # a 400x400 lattice


def _pred_files(workdir, step=STEP):
    return sorted(glob.glob(os.path.join(workdir, "predictions", "kitti_native_eval", "0", str(step), "data",
                                         "*.txt")))


def _rows(path):
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[3:]] for r in rows]).reshape(-1, 13)


def _assert_rows_close(got_files, want_files):
    assert [os.path.basename(p) for p in got_files] == [os.path.basename(p) for p in want_files]
    n = 0
    for g, w in zip(got_files, want_files):
        gc, gv = _rows(g)
        wc, wv = _rows(w)
        assert gc == wc, os.path.basename(g)
        np.testing.assert_allclose(gv[:, 1:5], wv[:, 1:5], atol=TOL_2D, rtol=0)  # 2D box, px
        np.testing.assert_allclose(gv[:, [0, *range(5, 13)]], wv[:, [0, *range(5, 13)]], atol=TOL_3D, rtol=0)
        n += len(gc)
    assert n > 0, "no rows written"


@pytest.fixture(scope="module")
def eval_runs(tree, tmp_path_factory):
    """The JAX ``Evaluator`` and the port's over the tree's val split with
    the same weights (JAX's init, carried over and saved as the port's
    checkpoint of step 1)."""

    tcfg = eval_config(tree)
    jcfg = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(tcfg))
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
    jwork, twork = (str(tmp_path_factory.mktemp(n)) for n in ("jax_eval", "port_eval"))
    jev = j_evaluator.Evaluator(jcfg, extents=jext, workdir=jwork)
    params = jev._params_template()
    jres = jev.run_checkpoint_once(STEP, params=params)
    sd = weights.from_flax(jax.tree.map(np.asarray, params), tcfg.model)
    ckpt_mod.save(os.path.join(twork, "checkpoints"), STEP, {"model": sd, "step": STEP})
    tev = Evaluator(tcfg, extents=T_EXT, workdir=twork, device="cpu")
    tres = tev.run_checkpoint_once(STEP)
    return {"cfg": tcfg, "sd": sd, "jwork": jwork, "twork": twork, "jres": jres, "tres": tres, "tev": tev}


def test_evaluator_writes_the_jax_rows(eval_runs):
    files = _pred_files(eval_runs["twork"])
    assert [os.path.basename(p) for p in files] == [f"{i:06d}.txt" for i in VAL]  # the padded row is not
    _assert_rows_close(files, _pred_files(eval_runs["jwork"]))
    assert eval_runs["tres"]["num_frames"] == eval_runs["jres"]["num_frames"] == len(VAL)


def test_evaluator_ap_matches_jax(eval_runs):
    tres, jres = eval_runs["tres"], eval_runs["jres"]
    assert tres["ap_backend"] == "native_cpp"
    _assert_ap_close(tres["ap"], jres["ap"], 1e-6)
    pred_dir = os.path.dirname(_pred_files(eval_runs["twork"])[0])
    gt_dir = os.path.join(eval_runs["tev"].dataset.base, "label_2")
    _assert_ap_close(tres["ap"], t_metrics.evaluate_dirs(gt_dir, pred_dir, ["Car"]), 1e-12)


def test_evaluator_proposals_match_jax(eval_runs):
    def files(work):
        return sorted(glob.glob(os.path.join(work, "predictions", "proposals_and_scores", str(STEP), "*.txt")))

    got, want = files(eval_runs["twork"]), files(eval_runs["jwork"])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] and len(got) == len(VAL)
    for g, w in zip(got, want):
        gv, wv = np.loadtxt(g, ndmin=2), np.loadtxt(w, ndmin=2)
        assert gv.shape == wv.shape and gv.shape[0] > 0
        np.testing.assert_allclose(gv, wv, atol=TOL_3D, rtol=0)


def test_evaluator_writes_its_record(eval_runs):
    tres, twork = eval_runs["tres"], eval_runs["twork"]
    with open(os.path.join(twork, f"eval_{STEP}.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(tres))
    rec = read_scalars(os.path.join(twork, "eval_summaries"))[-1]
    assert rec["step"] == STEP and rec["eval_fps"] > 0
    assert rec["AP_Car_3d_moderate"] == tres["ap"]["Car"]["3d"]["moderate"]
    ph = eval_runs["tev"].phases
    assert set(ph) == {"wait", "dispatch", "submit", "readback", "write", "load", "put"}
    assert eval_runs["tev"].loader_timings["load_wall"] > 0


def _digest(work):
    files = sorted(glob.glob(os.path.join(work, "predictions", "**", "*.txt"), recursive=True))
    return len(files), hashlib.sha256(b"".join(open(p, "rb").read() for p in files)).hexdigest()


@pytest.mark.parametrize("group, inflight, async_writer", [(2, 1, True), (1, 2, False)])
def test_readback_groups_and_inline_writer_write_the_same_bytes(eval_runs, tmp_path, group, inflight,
                                                                async_writer):
    cfg = eval_runs["cfg"]
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, readback_group=group, inflight_batches=inflight, async_writer=async_writer, num_workers=1))
    ev = Evaluator(cfg, extents=T_EXT, workdir=str(tmp_path), device="cpu")
    res = ev.run_checkpoint_once(STEP, state_dict=eval_runs["sd"])
    assert _digest(str(tmp_path)) == _digest(eval_runs["twork"])
    assert res["ap"] == eval_runs["tres"]["ap"]


def test_sweep_of_f32_checkpoints_into_bf16_is_idempotent(tree, tmp_path):
    """Two trainer-style checkpoints (f32 parameters) restored into a bf16
    serving model with ``strict`` loading; a second sweep evaluates none."""

    cfg = eval_config(tree, dtype="bfloat16", save_rpn_proposals=False)
    for step, seed in ((3, 0), (5, 1)):
        model = t_pl.make_model(cfg.model, T_EXT, device="cpu").float()
        weights.init_like_flax(model, seed=seed)
        ckpt_mod.save(str(tmp_path / "checkpoints"), step, {"model": model.state_dict(), "step": step})
    assert {v.dtype for v in ckpt_mod.restore(str(tmp_path / "checkpoints"), 3)["model"].values()} == {torch.float32}
    ev = Evaluator(cfg, extents=T_EXT, workdir=str(tmp_path), device="cpu")
    serving = {n: p.dtype for n, p in ev.model.named_parameters()}
    assert torch.bfloat16 in serving.values()
    results = ev.repeated_checkpoint_run(max_wait=0)
    assert {n: p.dtype for n, p in ev.model.named_parameters()} == serving  # load_state_dict cast
    assert [r["step"] for r in results] == [3, 5]
    assert ev.repeated_checkpoint_run(max_wait=0) == []
    assert (tmp_path / "evaluated_steps.txt").read_text() == "3\n5\n"
    for step in (3, 5):
        with open(tmp_path / f"eval_{step}.json") as f:
            rec = json.load(f)
        assert rec["ap_backend"] == "native_cpp" and rec["num_frames"] == len(VAL)
        assert {m: set(d) for m, d in rec["ap"]["Car"].items()} == {m: set(DIFFS) for m in METRICS}
        assert len(_pred_files(str(tmp_path), step)) == len(VAL)
    assert [r["step"] for r in read_scalars(str(tmp_path / "eval_summaries"))] == [3, 5]


def test_evaluator_on_cuda_without_a_card_raises(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(eval_config(tree), extents=T_EXT, workdir="unused")


def test_multi_card_evaluator_says_it_evaluates_on_one(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    Evaluator(eval_config(tree), extents=T_EXT, workdir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "4 cards" in out and "evaluates on one" in out


# ---------------------------------------------------------------- the CLIs

def test_cli_evaluation_and_inference(eval_runs, tree, tmp_path):
    """``run_evaluation --ckpt_step`` and ``run_inference`` on the CPU over
    the same checkpoint (both CLIs at the default extents): inference at
    batch 1 writes the rows that the evaluation wrote at batch 2, within the
    slice's tolerances."""

    from sparse_pooling_tpu_torch.experiments import run_evaluation, run_inference

    cfg = eval_runs["cfg"]
    path = tmp_path / "pipeline.json"
    path.write_text(cfg.to_json())
    exp = tmp_path / "exp"
    workdir = exp / cfg.checkpoint_name
    ckpt_mod.save(str(workdir / "checkpoints"), STEP, {"model": eval_runs["sd"], "step": STEP})
    common = ["--pipeline_config", str(path), "--dataset_root", tree, "--experiments_dir", str(exp),
              "--device", "cpu"]
    (res,) = run_evaluation.main(common + ["--ckpt_step", str(STEP)])
    assert res["num_frames"] == len(VAL) and res["ap_backend"] == "native_cpp"
    assert (workdir / f"eval_{STEP}.json").exists()
    out_dir = run_inference.main(common + ["--save_npy"])  # the latest checkpoint: step 1
    assert out_dir == str(workdir / "inference" / str(STEP))
    _assert_rows_close(sorted(glob.glob(os.path.join(out_dir, "*.txt"))), _pred_files(str(workdir)))
    boxes = np.load(os.path.join(out_dir, f"{VAL[0]:06d}.npy"))
    assert boxes.shape == (cfg.model.num_classes, cfg.model.avod.nms_size, 7)
