"""Parity with the JAX package of the plain twins of the port's three
kernels, on the CPU (a CPU tensor runs the twin):

  A  ops.sparse_pool.sparse_pool_patch_major_batch  (SHPL patch pool)
  B  ops.ell_sparse_pool.sparse_pool_fused           (ELL pool; held against
     the Pallas kernel in interpret mode, as tests/test_device_ops.py does)
  C  ops.crop_resize.crop_and_resize_group_einsum_px (grouped RPN crop)

Tolerance 1e-5 absolute in f32: the same products, summed in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import sparse_matrix as j_sm  # noqa: E402
from sparse_pooling_tpu.ops import crop_resize as j_crop  # noqa: E402
from sparse_pooling_tpu.ops import sparse_pool as j_sp  # noqa: E402
from sparse_pooling_tpu.ops.pallas_sparse_pool import sparse_pool_ell_pallas  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data import sparse_matrix as t_sm  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.ops import crop_resize as t_crop  # noqa: E402
from sparse_pooling_tpu_torch.ops import ell_sparse_pool as t_ell  # noqa: E402
from sparse_pooling_tpu_torch.ops import sparse_pool as t_sp  # noqa: E402


def _patch_inputs(seed, b, hs, ws, c, p, t):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, hs, ws, c).astype(np.float32)
    v0 = rng.randint(0, max(hs - 1, 1), (b, p))
    u0 = rng.randint(0, max(ws - 1, 1), (b, p))
    v1 = np.minimum(v0 + 1, hs - 1)
    u1 = np.minimum(u0 + 1, ws - 1)
    cols = np.stack([v0 * ws + u0, v0 * ws + u1, v1 * ws + u0, v1 * ws + u1], -1).astype(np.int32)
    vals = rng.rand(b, p, 4).astype(np.float32)
    vals[:, -5:] = 0.0  # padding points
    rows = rng.randint(0, t, (b, p)).astype(np.int32)
    rows[0, :3] = [-1, t, t + 7]  # flat ids b*T + row: the first drops, the others spill
    rows[-1, -3:] = [t, t + 3, -2]  # into the next frame, as segment_sum over B*T does
    return src, rows, cols, vals


@pytest.mark.parametrize("shape", [(2, 6, 9, 8), (2, 1, 7, 4), (1, 5, 1, 4)])
@pytest.mark.parametrize("divide", [True, False])
def test_kernel_a_plain_matches_jax(shape, divide):
    b, hs, ws, c = shape
    t = 23
    src, rows, cols, vals = _patch_inputs(hs * 10 + ws, b, hs, ws, c, 200, t)
    want = np.asarray(j_sp.sparse_pool_patch_major_batch(
        jnp.array(src), jnp.array(rows), jnp.array(cols), jnp.array(vals), t,
        divide_by_weight_sum=divide,
    ))
    got = t_sp.sparse_pool_patch_major_batch(
        torch.from_numpy(src), torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), t, divide_by_weight_sum=divide,
    )
    assert got.dtype == torch.float32 and got.shape == (b, t, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_kernel_a_bf16_accumulator_matches_jax():
    """accum_dtype="bfloat16" (a config option; kernel A runs it on the card,
    held against this twin in tests/test_torch_kernel_edges.py)."""

    src, rows, cols, vals = _patch_inputs(3, 2, 6, 9, 8, 200, 23)
    want = np.asarray(j_sp.sparse_pool_patch_major_batch(
        jnp.array(src), jnp.array(rows), jnp.array(cols), jnp.array(vals), 23,
        divide_by_weight_sum=True, accum_dtype="bfloat16",
    ))
    got = t_sp.sparse_pool_patch_major_batch(
        torch.from_numpy(src), torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), 23, divide_by_weight_sum=True, accum_dtype="bfloat16",
    )
    # bf16 sums of <= ~10 entries: a few bf16 ulps of values of order 1
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


@pytest.mark.parametrize("s,c,t,k", [(640, 16, 520, 4), (300, 8, 77, 8)])
def test_kernel_b_plain_matches_pallas_interpret(s, c, t, k):
    rng = np.random.RandomState(s + t)
    x = rng.randn(s, c).astype(np.float32)
    ell_src = rng.randint(0, s, (t, k)).astype(np.int32)
    ell_w = rng.rand(t, k).astype(np.float32)
    want = np.asarray(sparse_pool_ell_pallas(
        jnp.array(x), jnp.array(ell_src), jnp.array(ell_w), tile_t=128, interpret=True
    ))
    np.testing.assert_allclose(
        np.asarray(j_sp.sparse_pool_ell(jnp.array(x), jnp.array(ell_src), jnp.array(ell_w))),
        want, atol=1e-5,
    )
    got = t_ell.sparse_pool_fused(
        torch.from_numpy(x), torch.from_numpy(ell_src), torch.from_numpy(ell_w)
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_host_ell_tables_match_jax_builder():
    """The port's host ELL/COO builder is the JAX package's, bit for bit."""

    cfg = tcfg_mod.ModelConfig(image=tcfg_mod.ImageConfig(height=64, width=192))
    ext = tcfg_mod.AreaExtents()
    fr = synthetic_frame(cfg, n_points=3000, seed=4)
    pts = fr["points"][fr["points_mask"]]
    in_ext = (pts[:, 2] > 0.5) & (pts[:, 2] < 69) & (np.abs(pts[:, 0]) < 39)
    pts = pts[in_ext]
    uv = t_sm.project_to_image(pts, fr["p2"])
    pts = pts[(uv[:, 0] >= 0) & (uv[:, 0] <= 191) & (uv[:, 1] >= 0) & (uv[:, 1] <= 63)]
    got = t_sm.build_sparse_pooling_input(pts, fr["p2"], ext, cfg.bev, cfg.image, cfg.sparse_pool)
    jx = dataclasses.asdict
    want = j_sm.build_sparse_pooling_input(
        pts, fr["p2"], jcfg_mod.AreaExtents(**jx(ext)), jcfg_mod.BevConfig(**jx(cfg.bev)),
        jcfg_mod.ImageConfig(**jx(cfg.image)), jcfg_mod.SparsePoolConfig(**jx(cfg.sparse_pool)),
    )
    for g, w in zip(got, want):
        for f in ("rows", "cols", "vals", "ell_src", "ell_w"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert g.nnz == w.nnz > 0


def _group_boxes(seed, b, p, v, h, w, spread=3.0):
    """[B, P, V, 4] pixel boxes sharing a centre per unit (as grid anchors do)."""

    rng = np.random.RandomState(seed)
    cy = rng.uniform(-1, h + 1, (b, p, 1))
    cx = rng.uniform(-1, w + 1, (b, p, 1))
    hy = rng.uniform(0.2, spread, (b, p, v))
    hx = rng.uniform(0.2, spread, (b, p, v))
    jit_y = rng.uniform(-0.5, 0.5, (b, p, v))  # image-view centres differ a little
    return np.stack([cy + jit_y - hy, cx - hx, cy + jit_y + hy, cx + hx], -1).astype(np.float32)


@pytest.mark.parametrize("hw,patch,v", [((16, 20), 10, 8), ((12, 30), 12, 4), ((6, 9), 10, 3)])
def test_kernel_c_plain_matches_jax(hw, patch, v):
    h, w = hw
    rng = np.random.RandomState(h + w + patch)
    img = rng.randn(2, h, w, 5).astype(np.float32)
    boxes = _group_boxes(patch, 2, 7, v, h, w)
    want = np.asarray(j_crop.crop_and_resize_group_einsum_px(
        jnp.array(img), jnp.array(boxes), (3, 3), patch=patch
    ))
    got = t_crop.crop_and_resize_group_einsum_px(
        torch.from_numpy(img), torch.from_numpy(boxes), (3, 3), patch=patch
    )
    assert got.shape == (2, 7, v, 3, 3, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("patch", [6, 10])
def test_kernel_c_equals_bilinear_at_window_clamped_coords(patch):
    """The identity kernel C is built on: the tent contraction inside the
    window equals bilinear sampling (two taps per axis) at the
    window-clamped coordinates y_start + clip(ys - y_start, 0, py - 1)."""

    h, w = 14, 17
    img = np.random.RandomState(9).randn(2, h, w, 3).astype(np.float32)
    boxes = _group_boxes(11, 2, 5, 6, h, w, spread=5.0)
    tb = torch.from_numpy(boxes)
    ys, xs, y0, x0 = t_crop._group_starts(tb, h, w, (3, 3), patch)
    py, px = min(patch, h), min(patch, w)
    ys_eff = y0[..., None, None] + torch.clamp(ys - y0[..., None, None], 0.0, py - 1.0)
    xs_eff = x0[..., None, None] + torch.clamp(xs - x0[..., None, None], 0.0, px - 1.0)
    y0i = torch.clamp(torch.floor(ys_eff).long(), 0, h - 2)  # [B, P, V, ch]
    x0i = torch.clamp(torch.floor(xs_eff).long(), 0, w - 2)  # [B, P, V, cw]
    dy = (ys_eff - y0i)[..., :, None, None]
    dx = (xs_eff - x0i)[..., None, :, None]
    im = torch.from_numpy(img)
    bi = torch.arange(2)[:, None, None, None, None]

    def at(yy, xx):
        return im[bi, yy[..., :, None], xx[..., None, :]]  # [B, P, V, ch, cw, C]

    want = (at(y0i, x0i) * (1 - dx) + at(y0i, x0i + 1) * dx) * (1 - dy) + (
        at(y0i + 1, x0i) * (1 - dx) + at(y0i + 1, x0i + 1) * dx
    ) * dy
    got = t_crop.crop_and_resize_group_plain(im, tb, (3, 3), patch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_bf16_segment_sum_rounds_after_every_add_in_point_order():
    """Kernel A's bf16 twin sums each row's entries in bf16, rounding after
    every add, in the points' order: equal to a loop over the points."""

    rng = np.random.RandomState(11)
    ids = torch.from_numpy(rng.randint(0, 7, 300))
    ids[:40] = 3  # a long row
    entries = torch.from_numpy(rng.randn(300, 5).astype(np.float32) * 3).to(torch.bfloat16)
    want = torch.zeros(9, 5, dtype=torch.bfloat16)
    for i, e in zip(ids.tolist(), entries):
        want[i] = want[i] + e
    got = t_sp._ordered_segment_sum(ids, entries, 9)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    f32 = torch.zeros(9, 5).index_add_(0, ids, entries.float()).to(torch.bfloat16)
    assert not torch.equal(got, f32)  # one rounding at the end differs here
