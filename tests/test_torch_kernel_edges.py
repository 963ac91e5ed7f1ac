"""Kernels A (patch pool), B (ELL pool) and C (grouped crop), and the
backward kernels A-bwd and C-bwd, at their edge cases.

The same seeded inputs go two ways:

* on the CPU, the plain twins against the JAX package (f32, 1e-5 absolute,
  as tests/test_torch_kernels.py holds them), so the twins are a trusted
  yardstick at these inputs too;
* on the card (marker ``cuda``), each CUDA kernel against its twin in f32
  and bf16, with chip_smoke.py's tolerances: A 1e-4, B 1e-5 (f32) or 1e-2
  (bf16), C 1e-5 (f32) or 2e-2 (bf16), relative to max(|twin|, 1). A sums a
  row's terms in point order, the twin's ``index_add_`` in its own; B and C
  round once in bf16 from f32 sums taken in another order than the twin's
  (C's twin also rounds after each of its two products).

A: target rows of 250, 40 and 24 points (whose points the gather's
sub-groups share) among many empty rows, ids -1, T and T + 7 (dropped or
spilled into the next frame), window starts below 0 and past Hs * Ws, a
source side of 1, points whose four weights are all 0, C = 4, 6, 33 and 64
(8 channels a lane in the gather at C = 64, else 1), and a source that is
not 16-byte aligned; on the card also A's bf16 accumulation mode against
its twin (the same bf16 sums in the same order). C: C = 3, 5, 8 and 32, H
or W below the patch, a unit above 48 KB of shared memory (C = 32 at
patch 20 in f32), V = 1, 8 and 32, boxes running off the map's edges, and an
image that is not 16-byte aligned (the generic path at C = 8). B: batches
of 1 and 3 frames (one launch each), C = 3, 5, 8, 32, 64 and 72 (vector and
scalar paths), K = 1, 3, 8 and 16 (the K = 8 path and any K), T = 37 (a
ragged last block), rows that are all padding or padded past their first
slots, tensors that are not 16-byte aligned, and indices outside [0, S),
which the kernel drops.

A-bwd and C-bwd: on the CPU the backward twins against ``jax.vjp`` of the
JAX package's custom VJPs (A and the f32 crops 1e-5 relative to max(|JAX|,
1); the bf16 crops 2e-2, the twin summing in bf16 as the reference does),
the exact crop's plain backward too; on the card each kernel against its
twin summing in f32 (1e-5 in f32, 1e-2 in bf16: both round one f32 sum,
taken in another order), over A's cases above (odd C, empty rows, dropped
ids), every point in one cell and a hot cell of 1200 entries among ordinary
ones, C's cases above (windows at the map's edges; at C = 32, patch 16 a
unit of C-bwd needs more than 48 KB of shared memory), batches of 1 and 3,
gradients that are not 16-byte aligned, and C-bwd at the main path's two
views (512 units a frame of 32 variants, spread over the map or all on one
window). C-bwd also runs twice on the same inputs in each of these cases,
and the two gradients must be the same bits (its sums meet in an integer
fixed point, so the order of its atomics does not show); so do A (f32
accumulation) and A-bwd, over A's cases and at the main path's two calls
(8 frames of 16384 points, rows of hundreds of points): both put each row's
or cell's terms in index order before they sum them.

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
    got, _ = sparse_pool.sparse_pool_patch_plain(
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
    got, got_den = sparse_pool.sparse_pool_patch_kernel(x, r, cl, v, A_TARGETS, divide)
    want, want_den = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, A_TARGETS, divide)
    torch.cuda.synchronize()
    assert sparse_pool.sparse_pool_patch_kernel.launches == before + 1
    assert got.shape == want.shape == (src.shape[0], A_TARGETS, src.shape[-1])
    _assert_rel(got, want, 1e-4)
    assert (got_den is None) == (want_den is None) == (not divide)
    if divide:
        _assert_rel(got_den, want_den, 1e-5)
    empty = want.abs().sum(-1) == 0  # rows no live point reaches stay exactly 0
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("case", sorted(A_CASES))
def test_kernel_a_bf16_accumulation_matches_plain_on_card(cuda, case, divide, dtype):
    """``accum_dtype="bfloat16"``: kernel and twin take the same bf16 sums in
    the points' order; only the f32 order of a point's four products and of
    its four weights differs, which can flip one rounding (2e-2, as C's bf16)."""

    src, rows, cols, vals = _a_inputs(case)
    x = torch.from_numpy(src).to(cuda, dtype)
    r, cl, v = (torch.from_numpy(a).to(cuda) for a in (rows, cols, vals))
    before = sparse_pool.sparse_pool_patch_kernel.launches
    got, got_den = sparse_pool.sparse_pool_patch_kernel(x, r, cl, v, A_TARGETS, divide, "bfloat16")
    want, want_den = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, A_TARGETS, divide, "bfloat16")
    torch.cuda.synchronize()
    assert sparse_pool.sparse_pool_patch_kernel.launches == before + 1
    _assert_rel(got, want, 2e-2)
    f32, _ = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, A_TARGETS, divide)
    assert (want - f32).abs().max() > 0  # the mode differs from f32 sums at these inputs
    if divide:
        _assert_rel(got_den, want_den, 2e-2)
    empty = want.abs().sum(-1) == 0
    assert bool((got[empty] == 0).all())


# ------------------------------------------------------------ kernel C

C_CASES = {  # name: (H, W, C, patch, V)
    "c8_v32": (16, 20, 8, 10, 32),
    "c3_v8": (16, 20, 3, 10, 8),
    "c5_v1": (16, 20, 5, 12, 1),
    "c8_h_below_patch": (7, 20, 8, 10, 8),
    "c5_w_below_patch": (16, 6, 5, 10, 32),
    "c3_both_below_patch": (5, 4, 3, 12, 8),
    # C-bwd needs 68 KB of shared memory for one unit here (f32), above 48 KB
    "c32_p16_v32": (24, 28, 32, 16, 32),
    # kernel C needs 52 KB for one f32 unit here (its window alone is 51 KB)
    "c32_p20_v32": (28, 32, 32, 20, 32),
    # the people preset's unit: 4x4 positions of 4 variants, an 11-pixel window
    "c8_p11_v64": (24, 28, 8, 11, 64),
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


# ------------------------------------------------------------ A-bwd and C-bwd


def _jit_vjp(jax, fn, x, g):
    """The cotangent of ``fn`` at ``x`` for ``g``, jitted (eager tracing of
    the crops' custom VJPs takes seconds a call)."""

    return jax.jit(lambda xx, gg: jax.vjp(fn, xx)[1](gg)[0])(x, g)


def _a_grad(src, t, seed=7):
    return np.random.RandomState(seed).randn(src.shape[0], t, src.shape[-1]).astype(np.float32)


@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("case", sorted(A_CASES) + ["hot_cell", "one_cell"])
def test_kernel_a_bwd_plain_matches_jax_vjp_at_edges(jax_ops, case, divide):
    """Rows whose flat id falls outside the batch are moved to 0 here: JAX's
    backward reads the gradient there with ``jnp.take``'s out-of-range fill
    (NaN); the port drops them (the card tests below keep them)."""

    import jax

    jnp, j_sp, _ = jax_ops
    src, rows, cols, vals = _a_bwd_case(case, 2)
    b = src.shape[0]
    flat = rows + np.arange(b)[:, None] * A_TARGETS
    rows = np.where((flat >= 0) & (flat < b * A_TARGETS), rows, 0).astype(np.int32)
    g = _a_grad(src, A_TARGETS)
    want = np.array(_jit_vjp(jax, lambda s: j_sp.sparse_pool_patch_major_batch(
        s, jnp.array(rows), jnp.array(cols), jnp.array(vals), A_TARGETS, divide_by_weight_sum=divide),
        jnp.array(src), jnp.array(g)))
    x = torch.from_numpy(src).requires_grad_(True)
    sparse_pool.sparse_pool_patch_major_batch(
        x, torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), A_TARGETS, divide
    ).backward(torch.from_numpy(g))
    _assert_rel(x.grad, torch.from_numpy(want), 1e-5)


def _c_grad(img, boxes, seed=8):
    shape = (img.shape[0], boxes.shape[1], boxes.shape[2], 3, 3, img.shape[-1])
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(C_CASES))
def test_kernel_c_bwd_plain_matches_jax_vjp_at_edges(jax_ops, case, dtype):
    import jax

    jnp, _, j_crop = jax_ops
    img, boxes, patch = _c_inputs(case)
    g = _c_grad(img, boxes)
    jdt = getattr(jnp, dtype)
    want = _jit_vjp(jax, lambda im: j_crop.crop_and_resize_group_einsum_px(
        im, jnp.array(boxes), (3, 3), patch=patch), jnp.array(img).astype(jdt), jnp.array(g).astype(jdt))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tdt = getattr(torch, dtype)
    got = crop_resize.crop_and_resize_group_bwd_plain(
        torch.from_numpy(g).to(tdt), torch.from_numpy(boxes), img.shape, (3, 3), patch, tdt, tdt)
    assert got.dtype == tdt
    _assert_rel(got, want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_crop_bwd_matches_jax_vjp(jax_ops, dtype):
    """The stage-2 crop's plain backward (autograd of
    ``crop_and_resize_px_batch``) against ``_crop_with_vjp``; boxes off the
    map's edges and a map side of 1."""

    import jax

    jnp, _, j_crop = jax_ops
    for h, w in ((9, 11), (1, 6)):
        rng = np.random.RandomState(h + w)
        img = rng.randn(2, h, w, 5).astype(np.float32)
        boxes = rng.uniform(-2, max(h, w) + 2, (2, 6, 4)).astype(np.float32)
        g = rng.randn(2, 6, 7, 7, 5).astype(np.float32)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        want = _jit_vjp(jax, lambda im: j_crop.crop_and_resize_px_batch(im, jnp.array(boxes), (7, 7)),
                        jnp.array(img).astype(jdt), jnp.array(g).astype(jdt))
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        x = torch.from_numpy(img).to(tdt).requires_grad_(True)
        crop_resize.crop_and_resize_px_batch(x, torch.from_numpy(boxes), (7, 7)).backward(
            torch.from_numpy(g).to(tdt))
        assert x.grad.dtype == tdt
        _assert_rel(x.grad, want, 1e-5 if dtype == "float32" else 2e-2)


BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _a_bwd_case(case: str, batch: int):
    """A's edge inputs, cut or tiled to ``batch`` frames; "one_cell" sends
    every point's four corners to one source cell of each frame; "hot_cell"
    sends the four corners of frame 0's first 300 points to cell 7, 1200
    entries (more than A-bwd's gather holds in one block), among ordinary
    cells."""

    src, rows, cols, vals = _a_inputs("c64" if case in ("one_cell", "hot_cell") else case)
    if case == "one_cell":
        cols[:] = 7
    if case == "hot_cell":
        cols[0, :300] = 7
    reps = -(-batch // src.shape[0])
    cut = lambda a: np.concatenate([a] * reps)[:batch]  # noqa: E731
    return cut(src), cut(rows), cut(cols), cut(vals)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("case", sorted(A_CASES) + ["hot_cell", "one_cell"])
def test_kernel_a_bwd_matches_plain_on_card_at_edges(cuda, case, batch, divide, dtype, misaligned):
    src, rows, cols, vals = _a_bwd_case(case, batch)
    r, cl, v = (torch.from_numpy(a).to(cuda) for a in (rows, cols, vals))
    x = torch.from_numpy(src).to(cuda, dtype)
    _, den = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, A_TARGETS, divide)
    g = _on_card(_a_grad(src, A_TARGETS), cuda, misaligned=misaligned)
    before = sparse_pool.sparse_pool_patch_bwd_kernel.launches
    got = sparse_pool.sparse_pool_patch_bwd_kernel(g, r, cl, v, src.shape[1:3], den, dtype)
    want = sparse_pool.sparse_pool_patch_bwd_plain(g, r, cl, v, src.shape[1:3], den, dtype)
    torch.cuda.synchronize()
    assert sparse_pool.sparse_pool_patch_bwd_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == src.shape
    _assert_rel(got, want, BWD_TOL[dtype])
    untouched = want.float().abs().sum(-1) == 0  # cells no live corner reaches stay exactly 0
    assert bool((got[untouched] == 0).all())


@pytest.mark.cuda
def test_kernel_a_forward_writes_the_weight_sums(cuda):
    src, rows, cols, vals = (torch.from_numpy(a).to(cuda) for a in _a_inputs("c33"))
    out, den = sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, A_TARGETS, True)
    want_out, want_den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, A_TARGETS, True)
    torch.cuda.synchronize()
    _assert_rel(out, want_out, 1e-4)
    _assert_rel(den, want_den, 1e-5)
    assert bool((den[want_den == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("case", sorted(C_CASES))
def test_kernel_c_bwd_matches_plain_on_card_at_edges(cuda, case, batch, dtype, misaligned):
    img, boxes, patch = _c_inputs(case)
    img = np.concatenate([img, img[::-1]])[:batch]
    boxes = np.concatenate([boxes, boxes + 1.5])[:batch]
    bx = torch.from_numpy(np.ascontiguousarray(boxes)).to(cuda)
    g = _on_card(_c_grad(img, boxes), cuda, dtype, misaligned)
    before = crop_resize.crop_and_resize_group_bwd_kernel.launches
    got = crop_resize.crop_and_resize_group_bwd_kernel(g, bx, img.shape, (3, 3), patch, dtype)
    want = crop_resize.crop_and_resize_group_bwd_plain(g, bx, img.shape, (3, 3), patch, dtype)
    torch.cuda.synchronize()
    assert crop_resize.crop_and_resize_group_bwd_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == img.shape
    _assert_rel(got, want, BWD_TOL[dtype])


# C-bwd at the main path's shapes: 512 units a frame of V = 32 variants, the
# BEV view [88, 100, 8] with patch 10 and the image view [96, 312, 8] with
# patch 12; "spread" scatters the units over the map, "one_window" puts every
# unit of a frame on one window (the worst overlap: every unit adds into the
# same cells).
C_MAIN = {"bev": (88, 100, 8, 10), "image": (96, 312, 8, 12)}  # H, W, C, patch
C_MAIN_UNITS, C_MAIN_V = 512, 32


def _c_main_inputs(view: str, layout: str):
    h, w, c, patch = C_MAIN[view]
    rng = np.random.RandomState(h + w + (layout == "one_window"))
    img = rng.randn(C_BATCH, h, w, c).astype(np.float32)
    shape = (C_BATCH, C_MAIN_UNITS, 1)
    if layout == "one_window":
        cy, cx = np.full(shape, h / 3), np.full(shape, w / 2)
    else:
        cy, cx = rng.uniform(0, h, shape), rng.uniform(0, w, shape)
    v = (C_BATCH, C_MAIN_UNITS, C_MAIN_V)
    # variants: jittered centres and sizes around the unit's centre
    cy = cy + rng.uniform(-1.5, 1.5, v)
    cx = cx + rng.uniform(-1.5, 1.5, v)
    hy, hx = rng.uniform(0.5, 3.0, v), rng.uniform(0.5, 3.0, v)
    boxes = np.stack([cy - hy, cx - hx, cy + hy, cx + hx], -1).astype(np.float32)
    grad = rng.randn(C_BATCH, C_MAIN_UNITS, C_MAIN_V, 3, 3, c).astype(np.float32)
    return img, boxes, patch, grad


# one_window in bf16 is left out of the JAX parity: 512 units sum into each
# cell in bf16 on both sides, in orders that differ, so the two sums part by
# several bf16 ulps whatever the code; in f32 they agree
@pytest.mark.parametrize("view,layout,dtype", [
    (view, layout, dtype) for view in sorted(C_MAIN) for layout, dtype in
    (("spread", "float32"), ("spread", "bfloat16"), ("one_window", "float32"))])
def test_kernel_c_bwd_plain_matches_jax_vjp_at_main_shapes(jax_ops, view, layout, dtype):
    import jax

    jnp, _, j_crop = jax_ops
    img, boxes, patch, g = _c_main_inputs(view, layout)
    jdt = getattr(jnp, dtype)
    want = _jit_vjp(jax, lambda im: j_crop.crop_and_resize_group_einsum_px(
        im, jnp.array(boxes), (3, 3), patch=patch), jnp.array(img).astype(jdt), jnp.array(g).astype(jdt))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tdt = getattr(torch, dtype)
    got = crop_resize.crop_and_resize_group_bwd_plain(
        torch.from_numpy(g).to(tdt), torch.from_numpy(boxes), img.shape, (3, 3), patch, tdt, tdt)
    assert got.dtype == tdt
    _assert_rel(got, want, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["spread", "one_window"])
@pytest.mark.parametrize("view", sorted(C_MAIN))
def test_kernel_c_bwd_matches_plain_on_card_at_main_shapes(cuda, view, layout, dtype):
    img, boxes, patch, g = _c_main_inputs(view, layout)
    bx = torch.from_numpy(boxes).to(cuda)
    gd = torch.from_numpy(g).to(cuda, dtype)
    before = crop_resize.crop_and_resize_group_bwd_kernel.launches
    got = crop_resize.crop_and_resize_group_bwd_kernel(gd, bx, img.shape, (3, 3), patch, dtype)
    want = crop_resize.crop_and_resize_group_bwd_plain(gd, bx, img.shape, (3, 3), patch, dtype)
    torch.cuda.synchronize()
    assert crop_resize.crop_and_resize_group_bwd_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == img.shape
    _assert_rel(got, want, BWD_TOL[dtype])
    untouched = want.float().abs().sum(-1) == 0  # cells no window reaches stay exactly 0
    assert bool((got[untouched] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(C_CASES) + [f"{v}_{l}" for v in sorted(C_MAIN)
                                                    for l in ("spread", "one_window")])
def test_kernel_c_bwd_is_deterministic_on_card(cuda, case, dtype):
    """Two launches on the same inputs give the same bits: every edge case,
    and the main path's views (one_window: 512 units add into each cell)."""

    if case in C_CASES:
        img, boxes, patch = _c_inputs(case)
        g = _c_grad(img, boxes)
    else:
        img, boxes, patch, g = _c_main_inputs(*case.split("_", 1))
    bx = torch.from_numpy(boxes).to(cuda)
    gd = torch.from_numpy(g).to(cuda, dtype)
    first, second = (crop_resize.crop_and_resize_group_bwd_kernel(gd, bx, img.shape, (3, 3), patch, dtype)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert first.abs().max() > 0
    assert torch.equal(first.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       second.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


# Kernel A's and A-bwd's main-path shapes: BEV<-FV pools the 1/8 image map
# into the 88x100 BEV lattice, FV<-BEV the BEV map into the 48x156 image
# lattice; 16384 points a frame, 8 frames, 64 channels.
A_MAIN = {"bev_from_fv": (48, 156, 88 * 100), "fv_from_bev": (88, 100, 48 * 156)}  # Hs, Ws, T
A_MAIN_BATCH, A_MAIN_POINTS, A_MAIN_C = 8, 16384, 64


def _a_main_inputs(view: str):
    """Seeded inputs at a main-path call's shapes, skewed as the path's are:
    about 30% of the points padding, a quarter of the rest spread
    geometrically over the rows (its first rows take ~40 points), one row
    of ~400, the others uniform."""

    hs, ws, t = A_MAIN[view]
    b, p, c = A_MAIN_BATCH, A_MAIN_POINTS, A_MAIN_C
    rng = np.random.RandomState(hs + ws)
    src = rng.randn(b, hs, ws, c).astype(np.float32)
    c00 = rng.randint(0, hs * ws - ws - 1, (b, p))
    cols = np.stack([c00, c00 + 1, c00 + ws, c00 + ws + 1], -1).astype(np.int32)
    vals = rng.rand(b, p, 4).astype(np.float32)
    vals[rng.rand(b, p) < 0.3] = 0.0
    rows = rng.randint(0, t, (b, p))
    order = rng.permutation(t)  # which rows the geometric spread favours
    rows[:, :4000] = order[np.minimum(rng.geometric(0.01, (b, 4000)) - 1, t - 1)]
    rows[:, 4000:4550] = order[0]  # ~400 live points: the path's longest row has 493
    return src, rows.astype(np.int32), cols, vals, t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("case", sorted(A_CASES) + sorted(A_MAIN))
def test_kernel_a_is_deterministic_on_card(cuda, case, divide, dtype):
    """Kernel A in its default f32 accumulation: two launches on the same
    inputs give the same bits (rows and weight sums), at every edge case and
    at the main path's two calls, where rows take hundreds of points that
    span the gather's sub-groups and blocks."""

    if case in A_CASES:
        src, rows, cols, vals = _a_inputs(case)
        t = A_TARGETS
    else:
        src, rows, cols, vals, t = _a_main_inputs(case)
    x = torch.from_numpy(src).to(cuda, dtype)
    r, cl, v = (torch.from_numpy(a).to(cuda) for a in (rows, cols, vals))
    (out1, den1), (out2, den2) = (sparse_pool.sparse_pool_patch_kernel(x, r, cl, v, t, divide)
                                  for _ in range(2))
    want, _ = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, t, divide)
    torch.cuda.synchronize()
    _assert_rel(out1, want, 1e-4)
    assert out1.abs().max() > 0
    assert torch.equal(out1.view(torch.int32), out2.view(torch.int32))
    if divide:
        assert torch.equal(den1.view(torch.int32), den2.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("divide", [True, False])
@pytest.mark.parametrize("case", sorted(A_CASES) + ["hot_cell", "one_cell"] + sorted(A_MAIN))
def test_kernel_a_bwd_is_deterministic_on_card(cuda, case, divide, dtype):
    """A-bwd: two launches on the same inputs give the same bits, at every
    edge case (a cell of 1200 entries, every corner in one cell) and at the
    main path's two calls."""

    if case in A_MAIN:
        src, rows, cols, vals, t = _a_main_inputs(case)
    else:
        src, rows, cols, vals = _a_bwd_case(case, 3)
        t = A_TARGETS
    r, cl, v = (torch.from_numpy(a).to(cuda) for a in (rows, cols, vals))
    x = torch.from_numpy(src).to(cuda, dtype)
    _, den = sparse_pool.sparse_pool_patch_plain(x, r, cl, v, t, divide)
    g = torch.from_numpy(_a_grad(src, t)).to(cuda)
    first, second = (sparse_pool.sparse_pool_patch_bwd_kernel(g, r, cl, v, src.shape[1:3], den, dtype)
                     for _ in range(2))
    want = sparse_pool.sparse_pool_patch_bwd_plain(g, r, cl, v, src.shape[1:3], den, dtype)
    torch.cuda.synchronize()
    _assert_rel(first, want, BWD_TOL[dtype])
    assert first.abs().max() > 0
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(first.view(bits), second.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("view", sorted(A_MAIN))
def test_kernel_a_frame_rows_do_not_depend_on_the_batch_on_card(cuda, view):
    """A frame's pooled rows are the same bits whether it is pooled in a batch
    of 8 or with only the frames after it (each frame's slots start at a
    gather block), as the evaluator's data ranks need: a rank pools half of
    one process's batch."""

    src, rows, cols, vals, t = _a_main_inputs(view)
    x = torch.from_numpy(src).to(cuda, torch.bfloat16)
    r, cl, v = (torch.from_numpy(a).to(cuda) for a in (rows, cols, vals))
    whole, whole_den = sparse_pool.sparse_pool_patch_kernel(x, r, cl, v, t, True)
    tail, tail_den = sparse_pool.sparse_pool_patch_kernel(x[3:], r[3:], cl[3:], v[3:], t, True)
    torch.cuda.synchronize()
    assert torch.equal(whole[3:].view(torch.int32), tail.view(torch.int32))
    assert torch.equal(whole_den[3:].view(torch.int32), tail_den.view(torch.int32))
