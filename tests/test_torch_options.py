"""The ops behind the AVOD detector's model options, PyTorch port against the
JAX package on the CPU.

Inputs come from a numpy seed and go through both packages; tolerances are
the port's: f32 values to 1e-5 (the same arithmetic, summed in another order
at most), indices, validity and kept sets equal.

* the unpacked voxelizer (``bev_maps_from_points_batch``) and the per-cell
  counts (``bev_counts_from_points``); the packed voxelizer equals
  ``space_to_depth`` of the unpacked one bit for bit on an even lattice;
* the position-granular anchor filter on both routes: strided slices where
  the anchor stride is a whole number of cells, the gather fallback where it
  is not; kept anchors, their order and validity, with and without cap
  overflow;
* ``crop_and_resize_batch`` (normalised boxes), the strided patch crop
  ``crop_and_resize_patch_einsum_px`` and their gradients (images and boxes)
  against ``jax.vjp``; the grouped crop's box gradient against ``jax.vjp``;
* kernel A's weight gradient (the plain ``sparse_pool_patch_vals_grad``)
  against ``jax.vjp``, with and without the weight-sum division.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.ops import anchors as j_anchors  # noqa: E402
from sparse_pooling_tpu.ops import bev_device as j_bev  # noqa: E402
from sparse_pooling_tpu.ops import crop_resize as j_crop  # noqa: E402
from sparse_pooling_tpu.ops import sparse_pool as j_sp  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.models.backbone import space_to_depth  # noqa: E402
from sparse_pooling_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from sparse_pooling_tpu_torch.ops import bev_device as t_bev  # noqa: E402
from sparse_pooling_tpu_torch.ops import crop_resize as t_crop  # noqa: E402
from sparse_pooling_tpu_torch.ops import sparse_pool as t_sp  # noqa: E402
from test_torch_kernels import _group_boxes, _patch_inputs  # noqa: E402
from test_torch_ops import _jcfg, _points  # noqa: E402

T_EXT = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
J_EXT = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
PLANES = np.array([[0.0, -1.0, 0.0, 1.65], [0.02, -0.99, 0.01, 1.6]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud():
    pts, mask = zip(*(_points(s) for s in (0, 1)))
    return np.stack(pts), np.stack(mask)


# ---------------------------------------------------------------- voxelizer

@pytest.mark.parametrize("pad_h", [4, 0])
def test_unpacked_voxelizer_matches_jax(pad_h):
    """[B, H+pad, W, slices+1] to 1e-5 (heights round within a few ulps, as
    ``test_voxelizer_packed_matches_jax`` works out), the counts equal."""

    bev = tcfg_mod.BevConfig(pad_h=pad_h)
    pts, mask = _cloud()
    want = np.asarray(j_bev.bev_maps_batch(jnp.array(pts), jnp.array(mask), jnp.array(PLANES),
                                           J_EXT, _jcfg(bev)))
    got = t_bev.bev_maps_batch(_t(pts), _t(mask), _t(PLANES), T_EXT, bev).numpy()
    h, w = bev.grid_hw(T_EXT)
    assert got.shape == want.shape == (2, h + pad_h, w, bev.height_slices + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[:, h:] == 0).all() and (got[..., -1] > 0).sum() > 300
    want_n = np.stack([np.asarray(j_bev.bev_counts_from_points(jnp.array(p), jnp.array(m), J_EXT,
                                                               bev.voxel_size))
                       for p, m in zip(pts, mask)])
    got_n = t_bev.bev_counts_from_points(_t(pts), _t(mask), T_EXT, bev.voxel_size).numpy()
    np.testing.assert_array_equal(got_n, want_n)
    assert got_n.max() > 1


def test_packed_voxelizer_is_space_to_depth_of_unpacked():
    """The promise behind the packed path (the JAX pipeline's note at the
    voxelizer): the same model inputs bit for bit on an even lattice."""

    bev = tcfg_mod.BevConfig()
    pts, mask = _cloud()
    args = (_t(pts), _t(mask), _t(PLANES), T_EXT, bev)
    packed, counts = t_bev.bev_maps_packed_batch(*args)
    full = t_bev.bev_maps_from_points_batch(*args)
    assert torch.equal(space_to_depth(full), packed)
    h = bev.grid_hw(T_EXT)[0]
    assert torch.equal(t_bev.unpack_s2d_raster(counts, h),
                       t_bev.bev_counts_from_points(_t(pts), _t(mask), T_EXT, bev.voxel_size))


# ---------------------------------------------------------------- position filter

@pytest.mark.parametrize("stride", [0.5, 0.45])  # 5 cells; 4.5 cells: the gather fallback
@pytest.mark.parametrize("max_anchors,threshold", [(64, 1), (512, 2), (4096, 1)])
def test_position_filter_matches_jax(stride, max_anchors, threshold):
    """Two classes x two rotations; 64 and 512 anchors overflow the ~1k
    nonempty ones (the densest count tiers kept first, array order within a
    tier), 4096 does not."""

    acfg = tcfg_mod.AnchorConfig(sizes=((3.913, 1.629, 1.526), (0.8, 0.6, 1.7)), stride=stride,
                                 max_anchors=max_anchors)
    bev = tcfg_mod.BevConfig()
    h, w = bev.grid_hw(T_EXT)
    rng = np.random.RandomState(max_anchors + threshold)
    occ = (rng.rand(2, h, w) < 0.01).astype(np.float32) * rng.randint(1, 9, (2, h, w))
    plane = np.array([0.0, -1.0, 0.0, 1.65])
    grid = t_anchors.generate_anchors_np(acfg, T_EXT, plane)
    anchors = np.broadcast_to(grid.astype(np.float32), (2,) + grid.shape).copy()
    want = j_anchors.filter_anchor_positions_grid(
        jnp.array(anchors), jnp.array(occ), J_EXT, _jcfg(bev), _jcfg(acfg),
        max_anchors=max_anchors, density_threshold=threshold,
    )
    got = t_anchors.filter_anchor_positions_grid(
        _t(anchors), _t(occ), T_EXT, bev, acfg, max_anchors=max_anchors, density_threshold=threshold,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.anchors.numpy(), np.asarray(want.anchors))
    kept = got.valid.reshape(2, -1, 4).any(-1).sum(-1)
    assert (kept > 0).all()
    if max_anchors < 4096:
        assert (kept == max_anchors // 4).all()  # the cap is full
    if stride == 0.5:  # the grid route agrees with the gather route it replaces
        gather = t_anchors.filter_anchor_positions_batch(
            _t(anchors), _t(occ), T_EXT, bev, max_anchors=max_anchors, variants=4,
            density_threshold=threshold)
        assert torch.equal(gather.anchors, got.anchors) and torch.equal(gather.valid, got.valid)


# ---------------------------------------------------------------- crops

def _vjp(j_fn, args, cot):
    _, vjp = jax.vjp(j_fn, *[jnp.array(a) for a in args])
    return [np.asarray(g) for g in vjp(jnp.array(cot))]


def _port_grads(fn, img, boxes, cot):
    ti, tb = _t(img).requires_grad_(True), _t(boxes).requires_grad_(True)
    out = fn(ti, tb)
    out.backward(_t(cot))
    return out.detach().numpy(), ti.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("hw", [(12, 17), (5, 1)])
def test_crop_and_resize_batch_and_its_gradients_match_jax(hw):
    h, w = hw
    rng = np.random.RandomState(h + w)
    img = rng.randn(2, h, w, 4).astype(np.float32)
    lo = rng.uniform(-0.1, 0.8, (2, 9, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (2, 9, 2))], -1).astype(np.float32)
    cot = rng.randn(2, 9, 3, 3, 4).astype(np.float32)

    def j_fn(i, b):
        return j_crop.crop_and_resize_batch(i, b, (3, 3))

    want = np.asarray(j_fn(jnp.array(img), jnp.array(boxes)))
    got, g_img, g_box = _port_grads(lambda i, b: t_crop.crop_and_resize_batch(i, b, (3, 3)), img, boxes, cot)
    np.testing.assert_allclose(got, want, atol=1e-5)
    w_img, w_box = _vjp(j_fn, (img, boxes), cot)
    np.testing.assert_allclose(g_img, w_img, atol=1e-5)
    np.testing.assert_allclose(g_box, w_box, atol=1e-4 * max(np.abs(w_box).max(), 1.0))
    assert np.abs(w_box).max() > 0


@pytest.mark.parametrize("hw,patch", [((20, 26), 8), ((9, 12), 16)])
def test_patch_crop_and_its_gradients_match_jax(hw, patch):
    """Boxes spanning up to 8 cells: exact where they fit patch - 2, a
    centred context crop where not (patch 16 exceeds the 9-row map)."""

    h, w = hw
    rng = np.random.RandomState(patch + h)
    img = rng.randn(2, h, w, 5).astype(np.float32)
    lo = np.stack([rng.uniform(-2, h, (2, 11)), rng.uniform(-2, w, (2, 11))], -1)
    boxes = np.concatenate([lo, lo + rng.uniform(0.3, 8, (2, 11, 2))], -1).astype(np.float32)
    cot = rng.randn(2, 11, 7, 7, 5).astype(np.float32)

    def j_fn(i, b):
        return j_crop.crop_and_resize_patch_einsum_px(i, b, (7, 7), patch=patch)

    want = np.asarray(j_fn(jnp.array(img), jnp.array(boxes)))
    got, g_img, g_box = _port_grads(
        lambda i, b: t_crop.crop_and_resize_patch_einsum_px(i, b, (7, 7), patch=patch), img, boxes, cot)
    assert got.shape == (2, 11, 7, 7, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    w_img, w_box = _vjp(j_fn, (img, boxes), cot)
    np.testing.assert_allclose(g_img, w_img, atol=1e-5)
    np.testing.assert_allclose(g_box, w_box, atol=1e-4 * max(np.abs(w_box).max(), 1.0))
    assert np.abs(w_box).max() > 0


@pytest.mark.parametrize("v", [2, 8])
def test_group_crop_box_gradient_matches_jax(v):
    h, w, patch = 16, 20, 10
    img = np.random.RandomState(v).randn(2, h, w, 4).astype(np.float32)
    boxes = _group_boxes(patch + v, 2, 6, v, h, w)
    cot = np.random.RandomState(v + 1).randn(2, 6, v, 3, 3, 4).astype(np.float32)

    def j_fn(i, b):
        return j_crop.crop_and_resize_group_einsum_px(i, b, (3, 3), patch=patch)

    _, g_img, g_box = _port_grads(
        lambda i, b: t_crop.crop_and_resize_group_einsum_px(i, b, (3, 3), patch=patch), img, boxes, cot)
    w_img, w_box = _vjp(j_fn, (img, boxes), cot)
    np.testing.assert_allclose(g_img, w_img, atol=1e-5)
    np.testing.assert_allclose(g_box, w_box, atol=1e-4 * max(np.abs(w_box).max(), 1.0))
    assert np.abs(w_box).max() > 0


# ---------------------------------------------------------------- kernel A's weights

@pytest.mark.parametrize("divide", [True, False])
def test_patch_pool_vals_gradient_matches_jax(divide):
    b, hs, ws, c, t = 2, 6, 9, 8, 23
    src, rows, cols, vals = _patch_inputs(5, b, hs, ws, c, 200, t)
    rows = np.clip(rows, 0, t - 1)  # in range, as the device COO builder emits them
    vals[0, 10] = 0.0  # a point with no weight
    cot = np.random.RandomState(6).randn(b, t, c).astype(np.float32)

    def j_fn(s, v):
        return j_sp.sparse_pool_patch_major_batch(s, jnp.array(rows), jnp.array(cols), v, t,
                                                  divide_by_weight_sum=divide)

    w_src, w_vals = _vjp(j_fn, (src, vals), cot)
    ts, tv = _t(src).requires_grad_(True), _t(vals).requires_grad_(True)
    out = t_sp.sparse_pool_patch_major_batch(ts, _t(rows), _t(cols), tv, t, divide_by_weight_sum=divide)
    out.backward(_t(cot))
    np.testing.assert_allclose(ts.grad.numpy(), w_src, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), w_vals, atol=1e-5 * max(np.abs(w_vals).max(), 1.0))
    assert tv.grad.dtype == torch.float32 and np.abs(w_vals).max() > 0
