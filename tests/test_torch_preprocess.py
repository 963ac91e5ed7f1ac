"""The port's offline preprocessing against the JAX package's.

``data/voxel_grid.py``, ``data/integral_image.py`` and ``data/bev.py`` equal
to JAX's on seeded clouds (the BEV maps also within 1e-5 of the port's
device voxelizer, ``ops/bev_device.py``); ``runtime/preprocess.py``'s label
clusters within 1e-6 of JAX's, and every array of every ``gen_mini_batches``
``.npz`` equal to JAX's on a tree the JAX package writes (the targets of
``tests/test_runtime.py``'s preprocessing tests).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import bev as j_bev  # noqa: E402
from sparse_pooling_tpu.data import integral_image as j_ii  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu.data import voxel_grid as j_vg  # noqa: E402
from sparse_pooling_tpu.data.dataset import KittiDataset as JDataset  # noqa: E402
from sparse_pooling_tpu.runtime import preprocess as j_pre  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.configs import unittest_config  # noqa: E402
from sparse_pooling_tpu_torch.configs.presets import people_pyramid_config  # noqa: E402
from sparse_pooling_tpu_torch.data import bev as t_bev  # noqa: E402
from sparse_pooling_tpu_torch.data import integral_image as t_ii  # noqa: E402
from sparse_pooling_tpu_torch.data import voxel_grid as t_vg  # noqa: E402
from sparse_pooling_tpu_torch.data.dataset import KittiDataset as TDataset  # noqa: E402
from sparse_pooling_tpu_torch.ops import bev_device  # noqa: E402
from sparse_pooling_tpu_torch.runtime import preprocess as t_pre  # noqa: E402

EXTENTS = [tcfg_mod.AreaExtents(), tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)]


def _jext(ext):
    return jcfg_mod.AreaExtents(**dataclasses.asdict(ext))


def _cloud(ext, n, seed):
    """Points inside ``ext`` (a quarter stacked into a few columns, so cells
    hold several points), heights about the default ground plane."""

    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(ext.x_min, ext.x_max, n), rng.uniform(-1.0, 2.5, n),
                    rng.uniform(ext.z_min, ext.z_max, n)], 1)
    pts[: n // 4, [0, 2]] = pts[rng.randint(0, 8, n // 4)][:, [0, 2]]
    return pts


@pytest.mark.parametrize("ext", EXTENTS)
@pytest.mark.parametrize("voxel", [0.1, 0.4])
@pytest.mark.parametrize("n", [0, 1, 5000])
def test_voxel_grids_match_jax(ext, voxel, n):
    pts = _cloud(ext, n, seed=n)
    got, want = t_vg.voxelize_2d(pts, ext, voxel), j_vg.voxelize_2d(pts, _jext(ext), voxel)
    assert got.grid_hw == want.grid_hw
    for name in ("cell_rc", "counts", "min_y", "max_y"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    np.testing.assert_array_equal(got.occupancy(), want.occupancy())
    np.testing.assert_array_equal(got.count_map(), want.count_map())
    if n:
        np.testing.assert_array_equal(t_vg.point_cell_rc(pts, ext, voxel), j_vg.point_cell_rc(pts, _jext(ext), voxel))
    for g, w in zip(t_vg.voxelize_3d(pts, ext, voxel), j_vg.voxelize_3d(pts, _jext(ext), voxel)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_integral_images_match_jax(seed):
    rng = np.random.RandomState(seed)
    g2 = rng.randint(0, 5, (23, 31))
    ii2 = t_ii.integral_image_2d(g2)
    np.testing.assert_array_equal(ii2, j_ii.integral_image_2d(g2))
    boxes2 = rng.randint(-3, 35, (200, 4))  # off the grid and empty boxes included
    np.testing.assert_array_equal(t_ii.query_boxes_2d(ii2, boxes2), j_ii.query_boxes_2d(ii2, boxes2))
    g3 = rng.randint(0, 3, (7, 5, 9))
    ii3 = t_ii.integral_image_3d(g3)
    np.testing.assert_array_equal(ii3, j_ii.integral_image_3d(g3))
    boxes3 = rng.randint(-2, 11, (200, 6))
    np.testing.assert_array_equal(t_ii.query_boxes_3d(ii3, boxes3), j_ii.query_boxes_3d(ii3, boxes3))


@pytest.mark.parametrize("ext", EXTENTS)
@pytest.mark.parametrize("people", [False, True])
def test_bev_maps_match_jax_and_the_device_voxelizer(ext, people):
    cfg = (people_pyramid_config() if people else unittest_config()).model.bev
    pts = _cloud(ext, 6000, seed=7)
    plane = np.array([0.01, -1.0, 0.02, 1.65])
    got = t_bev.generate_bev_maps(pts, plane, ext, cfg)
    jcfg = jcfg_mod.BevConfig(**dataclasses.asdict(cfg))
    np.testing.assert_array_equal(got, j_bev.generate_bev_maps(pts, plane, _jext(ext), jcfg))
    assert got.dtype == np.float32 and got[..., -1].max() > 0 and got[..., :-1].max() > 0
    dev = bev_device.bev_maps_from_points_batch(
        torch.from_numpy(pts[None].astype(np.float32)), torch.ones(1, len(pts), dtype=torch.bool),
        torch.from_numpy(plane[None].astype(np.float32)), ext, cfg)[0].numpy()
    np.testing.assert_allclose(got, dev, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pre_tree"))
    j_syn.write_kitti_tree(root, num_frames=3, n_ground=2048, n_obj=128, val_frames=(2,))
    return root


def _datasets(root, cfg):
    jcfg = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(cfg))
    return TDataset(cfg.dataset, cfg.model), JDataset(jcfg.dataset, jcfg.model)


def test_label_clusters_match_jax(tree):
    rng = np.random.RandomState(3)
    dims = np.concatenate([rng.normal([3.9, 1.6, 1.5], 0.2, (40, 3)), rng.normal([0.8, 0.6, 1.7], 0.1, (30, 3))])
    for k in (1, 2, 3):
        np.testing.assert_allclose(t_pre.cluster_label_dimensions(dims, k), j_pre.cluster_label_dimensions(dims, k),
                                   atol=1e-6, rtol=0)
    assert t_pre.cluster_label_dimensions(np.zeros((0, 3)), 2).shape == (0, 3)
    tds, jds = _datasets(tree, unittest_config(dataset_root=tree))
    got = t_pre.cluster_dataset_labels(tds, num_clusters=2)
    want = j_pre.cluster_dataset_labels(jds, num_clusters=2)
    assert got.keys() == want.keys() and got["Car"]
    for cls in want:
        np.testing.assert_allclose(np.array(got[cls]), np.array(want[cls]), atol=1e-6, rtol=0)


def test_gen_mini_batches_match_jax(tree, tmp_path):
    """Every array of every sample's cache equal to JAX's (2 spawned
    workers each)."""

    tds, jds = _datasets(tree, unittest_config(dataset_root=tree))
    got = t_pre.gen_mini_batches(tds, str(tmp_path / "port"), num_workers=2)
    want = j_pre.gen_mini_batches(jds, str(tmp_path / "jax"), num_workers=2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] and len(got) == len(tds)
    for g, w in zip(got, want):
        gd, wd = np.load(g), np.load(w)
        assert sorted(gd.files) == sorted(wd.files) and "Car" in gd.files
        for name in wd.files:
            assert gd[name].dtype == wd[name].dtype, name
            np.testing.assert_array_equal(gd[name], wd[name], err_msg=f"{os.path.basename(g)}: {name}")
    assert max(np.load(g)["Car"][:, 0].max() for g in got) > 0.3  # some anchor overlaps a GT car
