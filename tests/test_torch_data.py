"""The port's KITTI data path against the JAX package's, on the CPU.

Inputs are seeded: trees written by both packages' ``write_kitti_tree``,
arrays drawn with numpy, augmentation draws from the same
``np.random.RandomState``. Every comparison is exact (the port copies the
numpy arithmetic in its order), except where noted:

* ``labels`` and ``calib``: parsing, round trips, the same arrays;
* ``pointcloud`` and ``augmentation``: bit for bit, including the seeded
  subsample and the PCA jitter's draws;
* ``write_kitti_tree``: text and ``.bin`` files byte-equal, PNGs equal once
  decoded (the port encodes with zlib, the JAX package with PIL), for every
  scene;
* ``KittiDataset``: ``load_sample`` and ``batches`` over two epochs with
  shuffle and augmentation, without augmentation, and with the image cache;
  the host resize (a canvas smaller than the raw image, ``device_resize``
  off) against JAX's PIL resize;
* ``DevicePrefetcher`` on the CPU: order, ``close`` mid-epoch, a loader
  error reaching the consumer (its card test, which needs no JAX, is in
  tests/test_torch_port.py);
* ``Trainer`` over a tree: two steps across an epoch boundary with a resume,
  consuming the ids JAX's ``batches`` yields; the training CLI; the one-card
  line of a multi-card ``Trainer``.
"""

import dataclasses
import filecmp
import os
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax
PIL_Image = pytest.importorskip("PIL.Image")

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import augmentation as j_aug  # noqa: E402
from sparse_pooling_tpu.data import calib as j_calib  # noqa: E402
from sparse_pooling_tpu.data import dataset as j_dataset  # noqa: E402
from sparse_pooling_tpu.data import labels as j_labels  # noqa: E402
from sparse_pooling_tpu.data import pointcloud as j_pc  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu_torch.configs import cars_pyramid_config  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data import augmentation as t_aug  # noqa: E402
from sparse_pooling_tpu_torch.data import calib as t_calib  # noqa: E402
from sparse_pooling_tpu_torch.data import dataset as t_dataset  # noqa: E402
from sparse_pooling_tpu_torch.data import labels as t_labels  # noqa: E402
from sparse_pooling_tpu_torch.data import pointcloud as t_pc  # noqa: E402
from sparse_pooling_tpu_torch.data import synthetic as t_syn  # noqa: E402
from sparse_pooling_tpu_torch.data.prefetch import DevicePrefetcher  # noqa: E402

N_FRAMES, VAL = 7, (6,)  # 6 training frames: 3 batches of 2, or 2 of 3 (dropping none)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tree written by the JAX package (PIL PNGs)."""

    root = str(tmp_path_factory.mktemp("jax_tree"))
    j_syn.write_kitti_tree(root, num_frames=N_FRAMES, n_ground=6000, n_obj=300, val_frames=VAL)
    return root


def _paths(root, sid):
    base = os.path.join(root, "training")
    return {k: os.path.join(base, d, sid + ext) for k, d, ext in (
        ("calib", "calib", ".txt"), ("velo", "velodyne", ".bin"), ("image", "image_2", ".png"),
        ("label", "label_2", ".txt"), ("plane", "planes", ".txt"))}


def data_config(root, max_points=4096, buckets=(1024, 2048), **dataset):
    """The cars preset (384x1248 canvas over the 375x1242 raw images) with a
    small point cap so frames subsample and batches pick buckets."""

    cfg = cars_pyramid_config()
    sp = dataclasses.replace(cfg.model.sparse_pool, max_points=max_points, point_buckets=buckets)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, sparse_pool=sp),
                               dataset=dataclasses.replace(cfg.dataset, root=root, **dataset))


def jax_config(tcfg):
    return jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(tcfg))


def _extents(tcfg_ext):
    return jcfg_mod.AreaExtents(**dataclasses.asdict(tcfg_ext))


# ---------------------------------------------------------------- labels, calib

def test_labels_match_jax_and_round_trip(tree, tmp_path):
    for i in range(N_FRAMES):
        p = _paths(tree, f"{i:06d}")
        got = t_labels.read_labels(p["label"])
        want = j_labels.read_labels(p["label"])
        assert [dataclasses.asdict(g) for g in got] == [dataclasses.asdict(w) for w in want]
        np.testing.assert_array_equal(t_labels.labels_to_box3d_array(got), j_labels.labels_to_box3d_array(want))
        cars = t_labels.filter_labels_by_class(got, ("Car",))
        assert [o.type for o in cars] == [o.type for o in j_labels.filter_labels_by_class(want, ("Car",))]
        out = tmp_path / f"{i}.txt"
        t_labels.write_labels(str(out), got)
        j_labels.write_labels(str(tmp_path / f"{i}_j.txt"), want)
        assert out.read_text() == (tmp_path / f"{i}_j.txt").read_text()
        back = t_labels.read_labels(str(out))
        np.testing.assert_allclose(t_labels.labels_to_box3d_array(back), t_labels.labels_to_box3d_array(got),
                                   atol=1e-6)
        np.testing.assert_array_equal(t_labels.read_ground_plane(p["plane"]), j_labels.read_ground_plane(p["plane"]))
    assert t_labels.read_labels(str(tmp_path / "missing.txt")) == []
    assert t_labels.labels_to_box3d_array([]).shape == (0, 7)
    np.testing.assert_array_equal(t_labels.default_ground_plane(), j_labels.default_ground_plane())


def test_calibration_matches_jax(tree):
    p = _paths(tree, "000001")
    got, want = t_calib.read_calibration(p["calib"]), j_calib.read_calibration(p["calib"])
    for f in ("p2", "r0_rect", "tr_velo_to_cam"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.velo_to_rect(), want.velo_to_rect())
    velo = j_pc.load_velodyne(p["velo"])
    np.testing.assert_array_equal(t_calib.lidar_to_cam_frame(velo, got), j_calib.lidar_to_cam_frame(velo, want))
    corners = np.random.RandomState(0).uniform(-5, 30, (8, 3))
    np.testing.assert_array_equal(t_calib.project_box3d_to_image(corners, got.p2),
                                  j_calib.project_box3d_to_image(corners, want.p2))


# ---------------------------------------------------------------- pointcloud, augmentation

def test_pointcloud_matches_jax(tree):
    p = _paths(tree, "000002")
    cal_t, cal_j = t_calib.read_calibration(p["calib"]), j_calib.read_calibration(p["calib"])
    ext_t = tcfg_mod.AreaExtents()
    ext_j = _extents(ext_t)
    hw = (375, 1242)
    np.testing.assert_array_equal(t_pc.load_velodyne(p["velo"]), j_pc.load_velodyne(p["velo"]))
    np.testing.assert_array_equal(t_pc.get_lidar_point_cloud(p["velo"], cal_t, hw),
                                  j_pc.get_lidar_point_cloud(p["velo"], cal_j, hw))
    pts = t_pc.load_points_filtered(p["velo"], cal_t, hw, ext_t)
    np.testing.assert_array_equal(pts, j_pc.load_points_filtered(p["velo"], cal_j, hw, ext_j))
    assert len(pts) > 1000
    cam = t_pc.get_lidar_point_cloud(p["velo"], cal_t)
    np.testing.assert_array_equal(t_pc.filter_to_area_extents(cam, ext_t), j_pc.filter_to_area_extents(cam, ext_j))
    plane = t_labels.read_ground_plane(p["plane"])
    np.testing.assert_array_equal(t_pc.distance_to_plane(cam, plane), j_pc.distance_to_plane(cam, plane))
    np.testing.assert_array_equal(t_pc.filter_ground_offset(cam, plane, 0.2, 2.0),
                                  j_pc.filter_ground_offset(cam, plane, 0.2, 2.0))
    for cap, seed in ((len(pts) + 10, 0), (len(pts) // 3, 2), (500, 7)):  # pad, then subsample
        for a, b in zip(t_pc.pad_or_subsample(pts, cap, seed), j_pc.pad_or_subsample(pts, cap, seed)):
            np.testing.assert_array_equal(a, b)
    buckets = (1024, 2048, 4096)
    for n in (0, 1, 1024, 1025, 4096, 5000):
        assert t_pc.pick_bucket(n, buckets, 8192) == j_pc.pick_bucket(n, buckets, 8192)
    padded = np.stack([t_pc.pad_or_subsample(pts[: 900 + 700 * k], 4096)[0] for k in range(3)])
    mask = np.stack([t_pc.pad_or_subsample(pts[: 900 + 700 * k], 4096)[1] for k in range(3)])
    for a, b in zip(t_pc.trim_points_to_bucket(padded, mask, buckets), j_pc.trim_points_to_bucket(padded, mask, buckets)):
        np.testing.assert_array_equal(a, b)


def test_augmentation_matches_jax(tree):
    p = _paths(tree, "000000")
    img = np.asarray(PIL_Image.open(p["image"]).convert("RGB"))
    cal_t, cal_j = t_calib.read_calibration(p["calib"]), j_calib.read_calibration(p["calib"])
    lab_t, lab_j = t_labels.read_labels(p["label"]), j_labels.read_labels(p["label"])
    pts = t_pc.load_points_filtered(p["velo"], cal_t, img.shape[:2], tcfg_mod.AreaExtents())
    np.testing.assert_array_equal(t_aug.flip_points(pts), j_aug.flip_points(pts))
    np.testing.assert_array_equal(t_aug.flip_calib_p2(cal_t.p2, 1242), j_aug.flip_calib_p2(cal_j.p2, 1242))
    got = t_aug.flip_sample(img, pts, cal_t, lab_t)
    want = j_aug.flip_sample(img, pts, cal_j, lab_j)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2].p2, want[2].p2)
    assert [dataclasses.asdict(o) for o in got[3]] == [dataclasses.asdict(o) for o in want[3]]
    for seed in (0, 5, 99):
        rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(t_aug.pca_jitter(img, rt), j_aug.pca_jitter(img, rj))
        assert rt.rand() == rj.rand()  # the same draws consumed


# ---------------------------------------------------------------- the tree writer

def test_write_kitti_tree_matches_jax(tmp_path):
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    kw = dict(num_frames=3, n_ground=3000, n_obj=200, val_frames=(2,))
    j_syn.write_kitti_tree(jroot, **kw)
    t_syn.write_kitti_tree(troot, **kw)
    for split in ("train", "val", "trainval"):
        assert filecmp.cmp(f"{jroot}/{split}.txt", f"{troot}/{split}.txt", shallow=False)
    for i in range(3):
        pj, pt = _paths(jroot, f"{i:06d}"), _paths(troot, f"{i:06d}")
        for kind in ("calib", "velo", "label", "plane"):
            assert filecmp.cmp(pj[kind], pt[kind], shallow=False), kind
        a = np.asarray(PIL_Image.open(pt["image"]))
        assert a.shape == (375, 1242, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.asarray(PIL_Image.open(pj["image"])))
    with pytest.raises(ValueError, match="scene"):
        t_syn.make_frame(0, scene="trucks")


@pytest.mark.parametrize("scene", ["cars_hard", "people", "people_hard"])
def test_write_kitti_tree_scenes_match_jax(tmp_path, scene):
    """The other scenes: hard scenes (occlusion, truncation, clutter) and
    the people street scene, every file byte-equal but the PNGs, which
    decode to the same pixels."""

    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    kw = dict(num_frames=3, n_ground=2000, n_obj=400, val_frames=(1,), scene=scene)
    j_syn.write_kitti_tree(jroot, **kw)
    t_syn.write_kitti_tree(troot, **kw)
    for split in ("train", "val", "trainval"):
        assert filecmp.cmp(f"{jroot}/{split}.txt", f"{troot}/{split}.txt", shallow=False)
    for i in range(3):
        pj, pt = _paths(jroot, f"{i:06d}"), _paths(troot, f"{i:06d}")
        for kind in ("calib", "velo", "label", "plane"):
            assert filecmp.cmp(pj[kind], pt[kind], shallow=False), kind
        np.testing.assert_array_equal(np.asarray(PIL_Image.open(pt["image"])),
                                      np.asarray(PIL_Image.open(pj["image"])))
    types = {line.split()[0] for i in range(3) for line in open(_paths(troot, f"{i:06d}")["label"])}
    assert types & ({"Pedestrian", "Cyclist"} if scene.startswith("people") else {"Car"})


# ---------------------------------------------------------------- KittiDataset

def _datasets(root, **kw):
    tcfg = data_config(root, **kw)
    jcfg = jax_config(tcfg)
    ext = tcfg_mod.AreaExtents()
    return (t_dataset.KittiDataset(tcfg.dataset, tcfg.model, ext),
            j_dataset.KittiDataset(jcfg.dataset, jcfg.model, _extents(ext)))


def _assert_samples_equal(got, want):
    assert got.sample_id == want.sample_id and tuple(got.raw_image_hw) == tuple(want.raw_image_hw)
    for a, b in zip(got.as_arrays(), want.as_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_sample_matches_jax(tree):
    tds, jds = _datasets(tree)
    assert tds.sample_ids == jds.sample_ids and len(tds) == N_FRAMES - len(VAL)
    for sid in tds.sample_ids:
        _assert_samples_equal(tds.load_sample(sid), jds.load_sample(sid))
        seed = t_dataset.augment_seed(0, 1, sid)
        _assert_samples_equal(tds.load_sample(sid, augment_seed=seed), jds.load_sample(sid, augment_seed=seed))
    samples = [tds.load_sample(sid) for sid in tds.sample_ids[:3]]
    stacked = tuple(np.stack([x.as_arrays()[i] for x in samples]) for i in range(9))
    for a, b in zip(tds._bucket(stacked), jds._bucket(stacked)):  # cap-stacked, trimmed after
        np.testing.assert_array_equal(a, b)
    s = tds.load_sample("000000")
    assert s.points_mask.sum() == 4096  # the cap: subsampled with the id's seed
    np.testing.assert_array_equal(s.image[375:], 0)  # the canvas below the raw image
    np.testing.assert_array_equal(s.image[:, 1242:], 0)


@pytest.mark.parametrize("augment", [True, False])
def test_batches_match_jax_over_two_epochs(tree, augment):
    tds, jds = _datasets(tree, max_points=8192, buckets=(2048, 4096))
    for epoch in (0, 1):
        assert tds.epoch_ids(epoch) == jds.epoch_ids(epoch)
        got = list(tds.batches(2, epoch, augment=augment))
        want = list(jds.batches(2, epoch, augment=augment))
        assert len(got) == len(want) == 3
        for (ga, gids), (wa, wids) in zip(got, want):
            assert gids == wids
            assert len(ga) == len(wa) == 9
            for a, b in zip(ga, wa):
                assert a.shape == b.shape and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert tds.epoch_ids(0) != tds.epoch_ids(1)  # shuffled anew each epoch


def test_batches_with_the_image_cache_match_jax(tree, tmp_path):
    tds, jds = _datasets(tree, image_cache_dir=str(tmp_path / "t_cache"))
    _, jds = _datasets(tree, image_cache_dir=str(tmp_path / "j_cache"))
    for _ in range(2):  # the first pass writes the caches, the second reads them
        for (ga, gids), (wa, wids) in zip(tds.batches(3, 0), jds.batches(3, 0)):
            assert gids == wids
            for a, b in zip(ga, wa):
                np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(tmp_path / "t_cache")) == sorted(os.listdir(tmp_path / "j_cache"))
    sid = tds.sample_ids[0]
    _assert_samples_equal(tds.load_sample(sid, augment_seed=3), jds.load_sample(sid, augment_seed=3))


@pytest.mark.parametrize("image,cache", [
    (dict(height=192, width=624), False),  # the raw image does not fit the canvas
    (dict(height=96, width=320), True),  # ... and through the image cache
    (dict(device_resize=False), False),  # it fits, but the host resizes it
])
def test_host_resize_matches_jax(tree, tmp_path, image, cache):
    """Where the host resizes (a raw image larger than the canvas, or
    ``device_resize`` off), ``load_sample`` equals JAX's: the resized canvas
    byte for byte (PIL's bilinear there), P2 scaled, ``image_scale`` ones,
    with and without augmentation and a caller's canvas."""

    kw = dict(image_cache_dir=str(tmp_path / "cache")) if cache else {}
    tcfg = data_config(tree, **kw)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, image=dataclasses.replace(tcfg.model.image, **image)))
    jcfg = jax_config(tcfg)
    ext = tcfg_mod.AreaExtents()
    tds = t_dataset.KittiDataset(tcfg.dataset, tcfg.model, ext)
    jds = j_dataset.KittiDataset(jcfg.dataset, jcfg.model, _extents(ext))
    h, w = tcfg.model.image.height, tcfg.model.image.width
    for sid in tds.sample_ids[:3]:
        for seed in (None, t_dataset.augment_seed(0, 1, sid)):
            for _ in range(2 if cache else 1):  # the first pass writes the cache, the second reads it
                got = tds.load_sample(sid, augment_seed=seed)
                _assert_samples_equal(got, jds.load_sample(sid, augment_seed=seed))
                np.testing.assert_array_equal(got.image_scale, np.ones(2, np.float32))
        out = np.zeros((h, w, 3), np.uint8)
        got = tds.load_sample(sid, image_out=out)
        assert got.image is out
        _assert_samples_equal(got, jds.load_sample(sid, image_out=np.zeros((h, w, 3), np.uint8)))


# ---------------------------------------------------------------- DevicePrefetcher

def _host_batches(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"frame {i} is missing")
        yield (np.full((2, 3), i, np.float32), None, np.arange(4) + i), [f"{i:06d}"]


def test_prefetcher_keeps_order_on_cpu():
    with DevicePrefetcher(_host_batches(5), depth=2, device="cpu") as pf:
        got = list(pf)
    assert [ids for _, ids in got] == [[f"{i:06d}"] for i in range(5)]
    for i, (t, _) in enumerate(got):
        assert isinstance(t, tuple) and t[1] is None
        assert torch.equal(t[0], torch.full((2, 3), float(i))) and t[2].tolist() == [i, i + 1, i + 2, i + 3]
    assert pf.timings["load"] > 0 and set(pf.timings) == {"load", "put", "wait"}


def test_prefetcher_close_mid_epoch_joins_the_worker():
    def slow():
        for i in range(1000):
            time.sleep(0.001)
            yield (np.zeros(3),), [i]

    pf = DevicePrefetcher(slow(), depth=2, device="cpu")
    first = next(pf)
    assert first[1] == [0]
    pf.close(timeout=5.0)
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()  # idempotent


def test_prefetcher_passes_loader_errors_to_the_consumer():
    pf = DevicePrefetcher(_host_batches(5, fail_at=2), depth=2, device="cpu")
    with pf, pytest.raises(KeyError, match="frame 2"):
        for _ in pf:
            pass
    assert not pf._thread.is_alive()


def test_prefetcher_transform_keeps_namedtuples():
    from sparse_pooling_tpu_torch.models.pipeline import RawSample

    items = ((tuple(np.full(1, k) for k in range(9)), "m") for _ in range(2))
    with DevicePrefetcher(items, device="cpu", transform=lambda it: (RawSample(*it[0]), it[1])) as pf:
        batch, meta = next(pf)
    assert isinstance(batch, RawSample) and meta == "m" and batch.image_scale.tolist() == [8]


# ---------------------------------------------------------------- Trainer, CLI

def train_config(root):
    """The narrow parity config of tests/test_torch_train.py over a tree: the
    cars preset's canvas and BEV, thin layers, f32, 1024 points, batch 2."""

    cfg = data_config(root, max_points=1024, buckets=(512,))
    m = cfg.model
    r = dataclasses.replace
    model = r(
        m,
        sparse_pool=r(m.sparse_pool, pool_channels=4),
        anchors=r(m.anchors, max_anchors=256),
        backbone=r(m.backbone, channels=(4, 4, 4, 4), blocks=(1, 1, 1, 1), out_channels=4,
                   compute_dtype="float32"),
        rpn=r(m.rpn, roi_channels=4, fusion_channels=8, pre_nms_top_k=128, eval_nms_size=16,
              train_nms_size=16),
        avod=r(m.avod, fc_layers=(16,), nms_size=8, keep_dropout_prob=1.0),
        path_drop=r(m.path_drop, enabled=False),
    )
    return r(cfg, model=model, train=r(cfg.train, batch_size=3, checkpoint_interval=1, summary_interval=1))


def test_trainer_trains_from_a_tree_and_resumes(tree, tmp_path, monkeypatch):
    from sparse_pooling_tpu_torch.runtime import trainer as tr
    from sparse_pooling_tpu_torch.runtime.summary import read_scalars

    cfg = train_config(tree)
    ext = tcfg_mod.AreaExtents(x_min=-20.0, x_max=20.0, z_min=0.0, z_max=39.6)  # a 400x400 lattice
    seen = []
    orig = t_dataset.KittiDataset.batches

    def recorded(self, *args, **kwargs):
        for arrays, ids in orig(self, *args, **kwargs):
            seen.append(ids)
            yield arrays, ids

    monkeypatch.setattr(t_dataset.KittiDataset, "batches", recorded)
    trainer = tr.Trainer(cfg, None, ext, workdir=str(tmp_path), device="cpu")
    assert isinstance(trainer.dataset, t_dataset.KittiDataset)
    state = trainer.train(max_steps=2)  # epoch 0: 2 batches of 3
    assert state.step == 2
    trainer2 = tr.Trainer(cfg, None, ext, workdir=str(tmp_path), device="cpu")
    state2 = trainer2.train(max_steps=3)  # resumes at step 2: epoch 1's first batch
    assert state2.step == 3
    jds = j_dataset.KittiDataset(jax_config(cfg).dataset, jax_config(cfg).model, _extents(ext))
    want = [ids for _, ids in jds.batches(3, 0)] + [ids for _, ids in jds.batches(3, 1)][:1]
    assert seen[:3] == want  # (the prefetcher may also have loaded epoch 1's second batch)
    recs = read_scalars(str(tmp_path / "summaries"))
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in recs for k in ("total", "grad_norm"))
    assert trainer.input_timings["load"] > 0


def test_run_training_cli_on_a_tree(tree, tmp_path, monkeypatch):
    from sparse_pooling_tpu_torch.experiments import run_training

    cfg = train_config(tree)
    path = tmp_path / "pipeline.json"
    path.write_text(cfg.to_json())
    state = run_training.main(["--pipeline_config", str(path), "--dataset_root", tree,
                               "--experiments_dir", str(tmp_path / "exp"), "--max_steps", "1",
                               "--batch_size", "2", "--device", "cpu"])
    assert state.step == 1
    assert os.path.isdir(tmp_path / "exp" / cfg.checkpoint_name / "checkpoints" / "1")
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no world given"):  # --multihost without a world
        run_training.main(["--multihost", "--device", "cpu"])


def test_multi_card_trainer_says_it_trains_on_one(tree, tmp_path, monkeypatch, capsys):
    from sparse_pooling_tpu_torch.runtime import trainer as tr

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = train_config(tree)
    tr.Trainer(cfg, None, workdir=str(tmp_path / "a"), device="cpu")
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "4 cards" in out and "trains on one" in out and "run_training" in out
    no_dp = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_parallel=False))
    tr.Trainer(no_dp, None, workdir=str(tmp_path / "b"), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tr.Trainer(cfg, None, workdir=str(tmp_path / "c"), device="cpu")
    assert capsys.readouterr().out == ""
