"""Kernels A (patch pool), B (ELL pool) and C (grouped crop) at their edge
cases.

The same seeded inputs go two ways:

* on the CPU, the plain twins against the JAX package (f32, 1e-5 absolute,
  as tests/test_torch_kernels.py holds them), so the twins are a trusted
  yardstick at these inputs too;
* on the card (marker ``cuda``), each CUDA kernel against its twin in f32
  and bf16, with chip_smoke.py's tolerances: A 1e-4, B 1e-5 (f32) or 1e-2
  (bf16), C 1e-5 (f32) or 2e-2 (bf16), relative to max(|twin|, 1). A sums a
  row's terms in an order that atomics decide; B and C round once in bf16
  from f32 sums taken in another order than the twin's (C's twin also
  rounds after each of its two products).

A: target rows of 250, 40 and 24 points (whose points the gather's
sub-groups share) among many empty rows, ids -1, T and T + 7 (dropped or
spilled into the next frame), window starts below 0 and past Hs * Ws, a
source side of 1, points whose four weights are all 0, C = 4, 6, 33 and 64
(8 channels a lane in the gather at C = 64, else 1), and a source that is
not 16-byte aligned. C: C = 3, 5 and 8, H or W
below the patch, V = 1, 8 and 32, boxes running off the map's edges, and an
image that is not 16-byte aligned (the generic path at C = 8). B: batches
of 1 and 3 frames (one launch each), C = 3, 5, 8, 32, 64 and 72 (vector and
scalar paths), K = 1, 3, 8 and 16 (the K = 8 path and any K), T = 37 (a
ragged last block), rows that are all padding or padded past their first
slots, tensors that are not 16-byte aligned, and indices outside [0, S),
which the kernel drops.

JAX is imported inside a fixture, so this file runs where JAX or flax is
missing: there the CPU parity tests skip and the card tests still run
(``python3 -m pytest --noconftest -m cuda tests/test_torch_kernel_edges.py``).
"""

import numpy as np
import pytest
import torch

from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, sparse_pool


@pytest.fixture
def jax_ops():
    pytest.importorskip("jax")
    pytest.importorskip("flax")  # the JAX package imports flax
    import jax.numpy as jnp
    from sparse_pooling_tpu.ops import crop_resize as j_crop
    from sparse_pooling_tpu.ops import sparse_pool as j_sp

    return jnp, j_sp, j_crop


@pytest.fixture
def jax_ell():
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp
    from sparse_pooling_tpu.ops import sparse_pool as j_sp
    from sparse_pooling_tpu.ops.pallas_sparse_pool import sparse_pool_ell_pallas

    return jnp, j_sp.sparse_pool_ell_batch, sparse_pool_ell_pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on_card(x: np.ndarray, dev, dtype=None, misaligned=False) -> torch.Tensor:
    """Copy to the card; ``misaligned`` places it one element past a 16-byte
    boundary (still contiguous), which sends the kernels to their scalar
    paths."""

    t = torch.from_numpy(x)
    dtype = dtype or t.dtype
    if not misaligned:
        return t.to(dev, dtype)
    buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t.to(dtype))
    return view


def _assert_rel(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    assert err <= rel * scale, f"max abs err {err:.3e} > {rel:g} * {scale:.3g}"


# ------------------------------------------------------------ kernel A

A_CASES = {  # name: (B, Hs, Ws, C)
    "c4": (2, 6, 9, 4),
    "c6": (2, 6, 9, 6),
    "c33": (2, 6, 9, 33),
    "c64": (2, 6, 9, 64),
    "hs1_c64": (2, 1, 7, 64),
    "ws1_c33": (2, 5, 1, 33),
}
A_POINTS, A_TARGETS, A_HOT = 600, 2000, 250


def _a_inputs(case: str):
    """Seeded inputs: 600 points a frame over 2000 targets (most rows empty),
    250 of frame 0's points on row 5, ids that drop or spill, and padding."""

    b, hs, ws, c = A_CASES[case]
    p, t = A_POINTS, A_TARGETS
    rng = np.random.RandomState(sum(A_CASES[case]))
    src = rng.randn(b, hs, ws, c).astype(np.float32)
    c00 = rng.randint(0, hs * ws, (b, p))  # the kernel reads cols[..., 0] and clamps
    # window starts off the map: floor division and remainder (JAX's // and %)
    # place a negative one, and the clamp moves both kinds back inside
    n = hs * ws
    c00[:, 400:410] = [-1, -2, -ws, -ws - 1, -n + 1, -n - 3, n, n + 1, n + ws + 2, 3 * n - 1]
    cols = np.stack([c00, c00 + 1, c00 + ws, c00 + ws + 1], -1).astype(np.int32)
    vals = rng.rand(b, p, 4).astype(np.float32)
    rows = rng.randint(0, t, (b, p)).astype(np.int32)
    rows[0, 10:10 + A_HOT] = 5
    rows[0, 300:340] = 6  # a second long row in the same tile of 64 rows
    rows[1, 300:324] = 7
    vals[0, 20:30] = 0.0  # all-zero weights inside the hot row
    vals[:, -20:] = 0.0  # padding points
    rows[0, :3] = [-1, t, t + 7]  # flat ids b*T + row: -1 drops, the others spill
    # last frame: t and t + 3 fall past B*T and drop; -2 spills back to row T - 2
    rows[-1, -23:-20] = [t, t + 3, -2]
    return src, rows, cols, vals


@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("case", sorted(A_CASES))
def test_kernel_a_plain_matches_jax_at_edges(jax_ops, case, divide):
    jnp, j_sp, _ = jax_ops
    src, rows, cols, vals = _a_inputs(case)
    want = np.asarray(j_sp.sparse_pool_patch_major_batch(
        jnp.array(src), jnp.array(rows), jnp.array(cols), jnp.array(vals), A_TARGETS,
        divide_by_weight_sum=divide,
    ))
    got = sparse_pool.sparse_pool_patch_plain(
        torch.from_numpy(src), torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), A_TARGETS, divide,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("case", sorted(A_CASES))
def test_kernel_a_matches_plain_on_card_at_edges(cuda, case, divide, dtype, misaligned):
    src, rows, cols, vals = _a_inputs(case)
    x = _on_card(src, cuda, dtype, misaligned)
    r, cl, v = (torch.from_numpy(a).to(cuda) for a in (rows, cols, vals))
    before = sparse_pool.sparse_pool_patch_kernel.launches
    got = sparse_pool.sparse_pool_patch_kernel(x, r, cl, v, A_TARGETS, divide)
    want = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, A_TARGETS, divide)
    torch.cuda.synchronize()
    assert sparse_pool.sparse_pool_patch_kernel.launches == before + 1
    assert got.shape == want.shape == (src.shape[0], A_TARGETS, src.shape[-1])
    _assert_rel(got, want, 1e-4)
    empty = want.abs().sum(-1) == 0  # rows no live point reaches stay exactly 0
    assert bool((got[empty] == 0).all())


# ------------------------------------------------------------ kernel C

C_CASES = {  # name: (H, W, C, patch, V)
    "c8_v32": (16, 20, 8, 10, 32),
    "c3_v8": (16, 20, 3, 10, 8),
    "c5_v1": (16, 20, 5, 12, 1),
    "c8_h_below_patch": (7, 20, 8, 10, 8),
    "c5_w_below_patch": (16, 6, 5, 10, 32),
    "c3_both_below_patch": (5, 4, 3, 12, 8),
}
C_BATCH, C_UNITS = 2, 37


def _c_inputs(case: str):
    """Seeded image and grouped boxes; centres run 3 px past every edge and
    some boxes lie wholly off the map, so samples and windows clamp."""

    h, w, c, patch, v = C_CASES[case]
    rng = np.random.RandomState(h * w + c + v)
    img = rng.randn(C_BATCH, h, w, c).astype(np.float32)
    shape = (C_BATCH, C_UNITS, 1)
    cy, cx = rng.uniform(-3, h + 3, shape), rng.uniform(-3, w + 3, shape)
    cy[:, :3, 0] = [-9.0, h + 9.0, h / 2]
    cx[:, :3, 0] = [w / 2, -9.0, w + 9.0]
    hy = rng.uniform(0.2, 4.0, (C_BATCH, C_UNITS, v))
    hx = rng.uniform(0.2, 4.0, (C_BATCH, C_UNITS, v))
    jit_y = rng.uniform(-0.5, 0.5, (C_BATCH, C_UNITS, v))
    boxes = np.stack([cy + jit_y - hy, cx - hx, cy + jit_y + hy, cx + hx], -1).astype(np.float32)
    return img, boxes, patch


@pytest.mark.parametrize("case", sorted(C_CASES))
def test_kernel_c_plain_matches_jax_at_edges(jax_ops, case):
    jnp, _, j_crop = jax_ops
    img, boxes, patch = _c_inputs(case)
    want = np.asarray(j_crop.crop_and_resize_group_einsum_px(
        jnp.array(img), jnp.array(boxes), (3, 3), patch=patch
    ))
    got = crop_resize.crop_and_resize_group_plain(
        torch.from_numpy(img), torch.from_numpy(boxes), (3, 3), patch
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(C_CASES))
def test_kernel_c_matches_plain_on_card_at_edges(cuda, case, dtype, rel, misaligned):
    img, boxes, patch = _c_inputs(case)
    x = _on_card(img, cuda, dtype, misaligned)
    bx = torch.from_numpy(boxes).to(cuda)
    before = crop_resize.crop_and_resize_group_kernel.launches
    got = crop_resize.crop_and_resize_group_kernel(x, bx, (3, 3), patch)
    want = crop_resize.crop_and_resize_group_plain(x, bx, (3, 3), patch)
    torch.cuda.synchronize()
    assert crop_resize.crop_and_resize_group_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    _assert_rel(got, want, rel)


# ------------------------------------------------------------ kernel B

B_CHANNELS = (3, 5, 8, 32, 64, 72)
B_SLOTS = (1, 3, 8, 16)
B_SOURCE, B_TARGETS = 50, 37


def _b_inputs(b: int, c: int, k: int):
    """Seeded batch: T = 37 rows a frame, indices local to each frame, rows
    2-4 all padding (index 0, weight 0, as the host builder pads) and row 7
    padded past its first half."""

    rng = np.random.RandomState(100 * b + 10 * k + c)
    src = rng.randn(b, B_SOURCE, c).astype(np.float32)
    idx = rng.randint(0, B_SOURCE, (b, B_TARGETS, k)).astype(np.int32)
    w = rng.rand(b, B_TARGETS, k).astype(np.float32)
    idx[:, 2:5], w[:, 2:5] = 0, 0.0
    idx[:, 7, k // 2:], w[:, 7, k // 2:] = 0, 0.0
    return src, idx, w


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("c", [5, 32])
@pytest.mark.parametrize("b", [1, 3])
def test_kernel_b_plain_matches_jax_batch(jax_ell, b, c, k):
    """The batched twin against JAX ``sparse_pool_ell_batch``, and each frame
    against the Pallas kernel in interpret mode."""

    jnp, ell_batch, ell_pallas = jax_ell
    src, idx, w = _b_inputs(b, c, k)
    got = sparse_pool.sparse_pool_ell_batch_plain(
        torch.from_numpy(src), torch.from_numpy(idx), torch.from_numpy(w)
    )
    assert got.dtype == torch.float32 and got.shape == (b, B_TARGETS, c)
    want = np.asarray(ell_batch(jnp.array(src), jnp.array(idx), jnp.array(w)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    for f in range(b):
        frame = np.asarray(ell_pallas(jnp.array(src[f]), jnp.array(idx[f]), jnp.array(w[f]),
                                      tile_t=16, interpret=True))
        np.testing.assert_allclose(got[f].numpy(), frame, atol=1e-5)
    assert (got[:, 2:5] == 0).all()  # all-padding rows pool to 0


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", B_SLOTS)
@pytest.mark.parametrize("c", B_CHANNELS)
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_kernel_b_matches_plain_on_card_at_edges(cuda, dtype, rel, misaligned, c, k, b):
    src, idx, w = _b_inputs(b, c, k)
    x = _on_card(src, cuda, dtype, misaligned)
    i, wt = (_on_card(a, cuda, misaligned=misaligned) for a in (idx, w))
    before = ell_sparse_pool.sparse_pool_ell_kernel.launches
    got = ell_sparse_pool.sparse_pool_ell_batch(x, i, wt)
    want = sparse_pool.sparse_pool_ell_batch_plain(x, i, wt)
    torch.cuda.synchronize()
    assert ell_sparse_pool.sparse_pool_ell_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == (b, B_TARGETS, c)
    _assert_rel(got, want, rel)
    assert bool((got[:, 2:5] == 0).all())
    if b == 1:  # the one-frame entry point is the same kernel at B = 1
        _assert_rel(ell_sparse_pool.sparse_pool_fused(x[0], i[0], wt[0]), want[0], rel)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_kernel_b_drops_indices_outside_the_frame(cuda, dtype, rel, k):
    """An index outside [0, S) adds nothing, in every frame: the kernel equals
    the twin given those slots as padding (index 0, weight 0)."""

    src, idx, w = _b_inputs(3, 64, k)
    bad = np.array([-1, -B_SOURCE, B_SOURCE, B_SOURCE + 3, 2**30, -2**31], np.int32)
    idx[:, 10:16, 0] = bad
    idx[1, 20, :] = B_SOURCE  # a whole row out of range
    ok = (idx >= 0) & (idx < B_SOURCE)
    x = torch.from_numpy(src).to(cuda, dtype)
    got = ell_sparse_pool.sparse_pool_ell_kernel(
        x, torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda))
    want = sparse_pool.sparse_pool_ell_batch_plain(
        x, torch.from_numpy(np.where(ok, idx, 0)).to(cuda), torch.from_numpy(np.where(ok, w, 0.0)).to(cuda))
    torch.cuda.synchronize()
    _assert_rel(got, want, rel)
    assert bool((got[1, 20] == 0).all())
