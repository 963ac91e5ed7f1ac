"""Parity of the PyTorch port's plain ops with the JAX package on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerances:
gathers, scatters and elementwise f32 ops agree to 1e-5 (same arithmetic,
different summation order at most); integer outputs (indices, validity,
COO taps) must be equal.
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
from sparse_pooling_tpu.ops import image_resize as j_resize  # noqa: E402
from sparse_pooling_tpu.ops import nms as j_nms  # noqa: E402
from sparse_pooling_tpu.ops import projection as j_proj  # noqa: E402
from sparse_pooling_tpu.ops import sparse_build as j_build  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from sparse_pooling_tpu_torch.ops import bev_device as t_bev  # noqa: E402
from sparse_pooling_tpu_torch.ops import crop_resize as t_crop  # noqa: E402
from sparse_pooling_tpu_torch.ops import image_resize as t_resize  # noqa: E402
from sparse_pooling_tpu_torch.ops import nms as t_nms  # noqa: E402
from sparse_pooling_tpu_torch.ops import projection as t_proj  # noqa: E402
from sparse_pooling_tpu_torch.ops import sparse_build as t_build  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402

T_EXT = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
J_EXT = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))


def _jcfg(tcfg):
    """The JAX package's twin of a port config dataclass."""

    return type(getattr(jcfg_mod, type(tcfg).__name__)())(**{
        f.name: (_jcfg(getattr(tcfg, f.name)) if dataclasses.is_dataclass(getattr(tcfg, f.name))
                 else getattr(tcfg, f.name))
        for f in dataclasses.fields(tcfg)
    })


def _points(seed, n=600, pad=40):
    rng = np.random.RandomState(seed)
    pts = np.stack([
        rng.uniform(-10, 10, n), rng.uniform(-1.0, 2.5, n), rng.uniform(-1, 14, n)
    ], -1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-pad:] = False
    return pts, mask


def _packed_heights_f64(pts, mask, plane, bev):
    """The packed voxelizer's height channels, [B, H2, W2, 4, slices],
    evaluated in float64 from the same float32 inputs (numpy, no framework)."""

    h, w = bev.grid_hw(T_EXT)
    ns = bev.height_slices
    slice_h = (bev.height_hi - bev.height_lo) / ns
    x, y, z = (pts[..., i].astype(np.float64) for i in range(3))
    e = T_EXT
    valid = (mask & (x >= e.x_min) & (x < e.x_max) & (y >= e.y_min) & (y < e.y_max)
             & (z >= e.z_min) & (z < e.z_max))
    col = np.clip(np.floor((x - e.x_min) / bev.voxel_size), 0, w - 1).astype(np.int64)
    row = np.clip(np.floor((z - e.z_min) / bev.voxel_size), 0, h - 1).astype(np.int64)
    gp = plane.astype(np.float64)[:, :, None]
    heights = x * gp[:, 0] + y * gp[:, 1] + z * gp[:, 2] + gp[:, 3] - bev.height_lo
    s = np.floor(heights / slice_h).astype(np.int64)
    keep = valid & (s >= 0) & (s < ns)
    out = np.zeros((pts.shape[0], (h + bev.pad_h) // 2, w // 2, 4, ns))
    b = np.broadcast_to(np.arange(pts.shape[0])[:, None], keep.shape)
    np.maximum.at(out, (b[keep], row[keep] // 2, col[keep] // 2, (row[keep] % 2) * 2 + col[keep] % 2,
                        s[keep]), ((heights - s * slice_h) / slice_h)[keep])
    return out, heights, valid


def test_voxelizer_packed_matches_jax():
    """Both voxelizers against a float64 evaluation of the same inputs, so a
    failure names the side that moved, and against each other.

    Tolerance, from the float32 rounding of a height: each side forms
    x*a + y*b + z*c + d - lo in 3 products and 4 sums, then the slice offset
    (one more difference), 8 roundings of at most half an ulp of the largest
    partial sum h_max, in whatever order its compiler fuses them; the packed
    value divides by slice_h. So each side lies within 4 ulp(h_max) /
    slice_h of the float64 value, and the two within twice that (7.6e-6
    here, where h_max < 8; the largest difference seen is 4.8e-7, one ulp of
    a height in [2, 4) over slice_h = 0.5). The nearest height lies 1e-4
    slice units from a slice edge, and the nearest point 2e-4 cells from a
    cell edge, far outside this envelope, so no point may change slice or
    cell. The density channel, log(n + 1) / log(16) of the same integer
    counts, rounds within a few ulps of 1, inside the same bound."""

    bev = tcfg_mod.BevConfig()
    pts, mask = zip(*(_points(s) for s in (0, 1)))
    pts, mask = np.stack(pts), np.stack(mask)
    plane = np.array([[0.0, -1.0, 0.0, 1.65], [0.02, -0.99, 0.01, 1.6]], np.float32)
    jp, jc = j_bev.bev_maps_packed_batch(
        jnp.array(pts), jnp.array(mask), jnp.array(plane), J_EXT, _jcfg(bev)
    )
    tp, tc = t_bev.bev_maps_packed_batch(
        torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(plane), T_EXT, bev
    )
    want, heights, valid = _packed_heights_f64(pts, mask, plane, bev)
    ns = bev.height_slices
    slice_h = (bev.height_hi - bev.height_lo) / ns
    gp = np.abs(plane.astype(np.float64))[:, :, None]
    h_max = (np.abs(pts[..., 0]) * gp[:, 0] + np.abs(pts[..., 1]) * gp[:, 1]
             + np.abs(pts[..., 2]) * gp[:, 2] + gp[:, 3] + abs(bev.height_lo))[valid].max()
    side_tol = 4 * float(np.spacing(np.float32(h_max))) / slice_h
    edge = np.abs(heights / slice_h - np.round(heights / slice_h))[valid].min()
    assert edge > 2 * side_tol, f"a height lies {edge:.2e} slice units from a slice edge"
    jn, tn = np.asarray(jp), tp.numpy()
    for side, got in (("JAX", jn), ("port", tn)):
        np.testing.assert_allclose(got.reshape(want.shape[:4] + (ns + 1,))[..., :ns], want,
                                   rtol=0, atol=side_tol, err_msg=f"{side} heights vs float64")
    np.testing.assert_allclose(tn, jn, rtol=0, atol=2 * side_tol)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    h = bev.grid_hw(T_EXT)[0]
    np.testing.assert_array_equal(
        t_bev.unpack_s2d_raster(tc, h).numpy(), np.asarray(j_bev.unpack_s2d_raster(jc, h))
    )
    assert (tp.numpy() >= 0).all()  # empty height cells are 0, not -inf


@pytest.mark.parametrize("scale", [(1.0, 1.0), (1.25, 1.1), (2.0, 1.5)])
def test_image_resize_matches_jax(scale):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (2, 24, 40, 3)).astype(np.uint8)
    sc = np.array([scale, (1.0, 1.0)], np.float32)
    want = np.asarray(j_resize.resize_bilinear_batch(jnp.array(img), jnp.array(sc)))
    got = t_resize.resize_bilinear_batch(torch.from_numpy(img), torch.from_numpy(sc)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_coo_build_matches_jax():
    cfg = tcfg_mod.ModelConfig(image=tcfg_mod.ImageConfig(height=64, width=192))
    frames = [synthetic_frame(cfg, n_points=3000, seed=s) for s in (0, 1)]
    pts = np.stack([f["points"][:3072] for f in frames])
    mask = np.stack([f["points_mask"][:3072] for f in frames])
    p2 = np.stack([f["p2"] for f in frames])
    jm = j_build.build_coo_device(
        jnp.array(pts), jnp.array(mask), jnp.array(p2), J_EXT, _jcfg(cfg.bev),
        _jcfg(cfg.image), _jcfg(cfg.sparse_pool),
    )
    tm = t_build.build_coo_device(
        torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(p2), T_EXT,
        cfg.bev, cfg.image, cfg.sparse_pool,
    )
    for j, t in zip(jm, tm):
        assert t.target_hw == j.target_hw and t.source_hw == j.source_hw
        assert t.defer_row_norm == j.defer_row_norm
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
        # weights are fractional parts of lattice coords up to ~156, where
        # one f32 ulp is 1.5e-5; the two compilers may round the projection
        # at different places (fused multiply-add), so allow two ulps
        np.testing.assert_allclose(t.vals.numpy(), np.asarray(j.vals), atol=3e-5)
    assert (tm[0].vals.sum(-1) > 0).sum() > 100  # the frame really lands in range


@pytest.mark.parametrize("max_anchors,threshold", [(64, 1), (256, 1), (1792, 1), (256, 3)])
def test_quad_anchor_filter_matches_jax(max_anchors, threshold):
    """Includes cap overflow (64/256 of ~1.8k anchors) and the no-overflow case."""

    acfg = tcfg_mod.AnchorConfig(sizes=((3.913, 1.629, 1.526),), max_anchors=max_anchors)
    bev = tcfg_mod.BevConfig()
    h, w = bev.grid_hw(T_EXT)
    rng = np.random.RandomState(max_anchors + threshold)
    occ = (rng.rand(2, h, w) < 0.02).astype(np.float32) * rng.randint(1, 9, (2, h, w))
    grid = t_anchors.generate_anchors_np(acfg, T_EXT, np.array([0.0, -1.0, 0.0, 1.65]))
    np.testing.assert_array_equal(
        grid, j_anchors.generate_anchors_np(_jcfg(acfg), J_EXT, np.array([0.0, -1.0, 0.0, 1.65]))
    )
    anchors = np.broadcast_to(grid.astype(np.float32), (2,) + grid.shape).copy()
    assert t_anchors.quad_supported(acfg, bev, T_EXT, max_anchors, 4)
    want = j_anchors.filter_anchor_quads_grid(
        jnp.array(anchors), jnp.array(occ), J_EXT, _jcfg(bev), _jcfg(acfg),
        max_anchors=max_anchors, quad=4, density_threshold=threshold,
    )
    got = t_anchors.filter_anchor_quads_grid(
        torch.from_numpy(anchors), torch.from_numpy(occ), T_EXT, bev, acfg,
        max_anchors=max_anchors, quad=4, density_threshold=threshold,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.anchors.numpy(), np.asarray(want.anchors))
    assert got.valid.any()


@pytest.mark.parametrize("hw", [(9, 11), (1, 6), (5, 1)])
def test_exact_crop_matches_jax(hw):
    h, w = hw
    rng = np.random.RandomState(h * 31 + w)
    img = rng.randn(2, h, w, 3).astype(np.float32)
    lo = rng.uniform(-2, max(h, w), (2, 5, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0, 6, (2, 5, 2))], -1)[..., [0, 1, 2, 3]].astype(np.float32)
    want = np.asarray(j_crop.crop_and_resize_px_batch(jnp.array(img), jnp.array(boxes), (7, 7)))
    got = t_crop.crop_and_resize_px_batch(torch.from_numpy(img), torch.from_numpy(boxes), (7, 7))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _nms_inputs(seed, n=64, n_inf=10, ties=True):
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, 10, (2, n, 2))
    s = rng.uniform(0.5, 2.0, (2, n, 2))
    boxes = np.concatenate([c - s, c + s], -1).astype(np.float32)
    scores = rng.rand(2, n).astype(np.float32)
    if ties:
        scores[:, 5:9] = scores[:, 4:5]  # equal finite scores
    scores[:, rng.choice(n, n_inf, replace=False)] = -np.inf
    return boxes, scores


@pytest.mark.parametrize("iou", [0.1, 0.5])
def test_nms_batch_matches_jax(iou):
    boxes, scores = _nms_inputs(0)
    scores[1, :] = -np.inf  # a frame with no valid box: index 0, valid False
    want = j_nms.nms_batch(jnp.array(boxes), jnp.array(scores), 40, iou)
    got = t_nms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), 40, iou)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.valid[1].any() and (got.indices[1] == 0).all()
    ref_idx, ref_valid = j_nms.nms_numpy(boxes[0], scores[0], 40, iou)
    np.testing.assert_array_equal(got.indices[0].numpy(), ref_idx)
    np.testing.assert_array_equal(got.valid[0].numpy(), ref_valid)


@pytest.mark.parametrize("iou", [0.1, 0.5])
@pytest.mark.parametrize("max_outputs", [40, 70])
def test_greedy_nms_operator_matches_jax(iou, max_outputs):
    """``torch.ops.spt.greedy_nms`` on CPU tensors (the plain loop) gives the
    JAX ``nms_batch``'s indices and validity, also past the valid picks."""

    boxes, scores = _nms_inputs(0)
    scores[1, :] = -np.inf
    want = j_nms.nms_batch(jnp.array(boxes), jnp.array(scores), max_outputs, iou)
    idx, valid = torch.ops.spt.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), max_outputs, iou)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("pre_top_k", [16, 48, 64])
def test_top_k_nms_matches_jax(pre_top_k):
    """-inf entries tie inside the top-k prefilter when it reaches past the
    valid boxes (48 and 64 of 64 with 20 masked)."""

    boxes, scores = _nms_inputs(1, n_inf=20)
    want = j_nms.top_k_nms_batch(jnp.array(boxes), jnp.array(scores), 24, 0.3, pre_top_k)
    got = t_nms.top_k_nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), 24, 0.3, pre_top_k)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("n_points,seed", [(3000, 0), (16384, 5)])
def test_synthetic_frame_matches_graft_entry(n_points, seed):
    """The port's frame generator is the JAX package's bench generator."""

    from __graft_entry__ import _synthetic_raw

    cfg = tcfg_mod.ModelConfig(image=tcfg_mod.ImageConfig(height=64, width=192))
    want = _synthetic_raw(_jcfg(cfg), J_EXT, n_points=n_points, seed=seed)
    got = synthetic_frame(cfg, n_points=n_points, seed=seed)
    for name in want._fields:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)), err_msg=name)
    noise = synthetic_frame(cfg, n_points=n_points, seed=seed, image="noise")["image"]
    assert noise.dtype == np.uint8 and noise.shape == got["image"].shape and noise.std() > 50


def test_projection_matches_jax():
    rng = np.random.RandomState(5)
    anchors = np.concatenate([
        rng.uniform(-8, 8, (2, 30, 1)), rng.uniform(1, 2, (2, 30, 1)),
        rng.uniform(2, 12, (2, 30, 1)), rng.uniform(1, 4, (2, 30, 3)),
    ], -1).astype(np.float32)
    p2 = np.stack([synthetic_frame(tcfg_mod.ModelConfig(), 16, s)["p2"] for s in (0, 1)])
    np.testing.assert_allclose(
        t_proj.project_to_bev(torch.from_numpy(anchors), T_EXT).numpy(),
        np.asarray(j_proj.project_to_bev(jnp.array(anchors), J_EXT)), atol=1e-6,
    )
    np.testing.assert_allclose(
        t_proj.project_to_image_space(torch.from_numpy(anchors), torch.from_numpy(p2), (384, 1248)).numpy(),
        np.asarray(j_proj.project_to_image_space(jnp.array(anchors), jnp.array(p2), (384, 1248))),
        atol=1e-6,
    )
