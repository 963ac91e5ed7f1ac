"""SHPL sparse cross-view pooling — kernel A, its backward, and the ELL twin.

Port of ``sparse_pooling_tpu.ops.sparse_pool``:

* ``sparse_pool_patch_major_batch`` — the fusion layer's pool, with its
  gradient (a ``torch.autograd.Function``). Each point gathers one 2x2xC
  source window at ``cols[..., 0]``, combines the 4 taps with its f32
  bilinear weights and scatter-adds into its target cell; with
  ``divide_by_weight_sum`` the weight sum rides the same scatter as channel
  C+1 and the result is divided by it where it exceeds 1e-12. On a CUDA
  tensor the forward launches kernel A (``csrc/sparse_pool_patch.cu``, which
  sorts the points by target row and gathers each row once instead of
  scattering per point) and the backward kernel A-bwd (the same file: the
  points' corners sorted by source cell, then a gather by cell); on a CPU
  tensor they run ``sparse_pool_patch_plain`` and
  ``sparse_pool_patch_bwd_plain``. Only the source map takes a gradient:
  the COO comes from the points, not from parameters.
* ``sparse_pool_ell_batch_plain`` — the plain ELL pool of a batch,
  ``out[b, t] = sum_k w[b,t,k] * src[b, idx[b,t,k]]``, twin of kernel B
  (``ops/ell_sparse_pool.py``, whose ``sparse_pool_ell_batch`` dispatches on
  the tensor's device); ``sparse_pool_ell`` is its one-frame case.
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch import kernels


def _gather_point_patches(src_map: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[B, Hs, Ws, C] + corner indices [B, P, 4] -> corner values [B, P, 4, C]
    from the 2x2 window at ``cols[..., 0]`` (start clamped so it fits; a dim
    of 1 duplicates its row/column)."""

    b, hs, ws, c = src_map.shape
    c00 = cols[..., 0].to(torch.int64)
    sh, sw = (2 if hs > 1 else 1), (2 if ws > 1 else 1)
    v0 = torch.clamp(torch.div(c00, ws, rounding_mode="floor"), 0, hs - sh)
    u0 = torch.clamp(torch.remainder(c00, ws), 0, ws - sw)
    v1, u1 = v0 + sh - 1, u0 + sw - 1
    flat = src_map.reshape(b * hs * ws, c)
    base = (torch.arange(b, device=src_map.device, dtype=torch.int64) * (hs * ws))[:, None]
    idx = torch.stack(
        [base + v0 * ws + u0, base + v0 * ws + u1, base + v1 * ws + u0, base + v1 * ws + u1],
        dim=-1,
    )  # [B, P, 4]
    return flat[idx.reshape(-1)].reshape(b, cols.shape[1], 4, c)


def sparse_pool_patch_plain(
    src_map: torch.Tensor,  # [B, Hs, Ws, C]
    rows: torch.Tensor,  # [B, P] int32
    cols: torch.Tensor,  # [B, P, 4] int32
    vals: torch.Tensor,  # [B, P, 4] f32
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
):
    """Plain PyTorch twin of kernel A -> ([B, T, C] f32 accumulated in
    ``accum_dtype``, the weight sums [B, T] f32 or None without
    ``divide_by_weight_sum``)."""

    acc = getattr(torch, accum_dtype)
    b, _, _, c = src_map.shape
    patches = _gather_point_patches(src_map, cols)
    g = torch.sum(patches.to(acc) * vals[..., None].to(acc), dim=2)  # [B, P, C]
    if divide_by_weight_sum:
        g = torch.cat([g, torch.sum(vals, dim=-1, keepdim=True).to(acc)], dim=-1)
    n_ch = g.shape[-1]
    # flat ids over the batch; segment_sum drops ids outside [0, B*T)
    ids = (rows.to(torch.int64) + (torch.arange(b, device=rows.device) * num_targets)[:, None]).reshape(-1)
    keep = (ids >= 0) & (ids < b * num_targets)
    flat = torch.zeros(b * num_targets, n_ch, dtype=acc, device=src_map.device)
    flat.index_add_(0, ids[keep], g.reshape(-1, n_ch)[keep])
    flat = flat.reshape(b, num_targets, n_ch)
    if not divide_by_weight_sum:
        return flat.to(torch.float32), None
    out = flat[..., :c].to(torch.float32)
    den = flat[..., c:].to(torch.float32)
    out = torch.where(den > 1e-12, out / torch.clamp_min(den, 1e-12), 0.0)
    return out, den[..., 0].contiguous()


@kernels.counted
def sparse_pool_patch_kernel(
    src_map: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
):
    """Kernel A on CUDA tensors -> ([B, T, C] f32, the weight sums [B, T]
    f32 or None), as ``sparse_pool_patch_plain``. Accumulates in f32 only;
    the backward reads the weight sums the kernel writes."""

    what = "sparse_pool_patch"
    if accum_dtype != "float32":
        raise NotImplementedError(f"{what}: kernel accumulates in float32 only, got {accum_dtype}")
    device = kernels.require_cuda(src_map, rows, cols, vals, what=what)
    b, hs, ws, c = src_map.shape
    p = rows.shape[1]
    if rows.dtype != torch.int32 or cols.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"{what}: rows/cols int32 and vals float32 required")
    if rows.shape != (b, p) or cols.shape != (b, p, 4) or vals.shape != (b, p, 4):
        raise ValueError(f"{what}: rows [B,P], cols/vals [B,P,4] required")
    if b * hs * ws >= 2**31 or b * max(p, num_targets) >= 2**31:
        raise ValueError(f"{what}: B*Hs*Ws, B*P and B*T must stay below 2**31")
    dt = kernels.dtype_code(src_map, what)
    lib = kernels.library("sparse_pool_patch")
    # int32 counts, offsets, slots and carries of the CSR gather; new_empty
    # takes the int32 of rows and the f32 of vals at less host cost than
    # torch.empty's keywords
    scratch = rows.new_empty(lib.sparse_pool_patch_scratch_ints(b, p, int(num_targets), c))
    out = vals.new_empty((b, int(num_targets), c))
    den = vals.new_empty((b, int(num_targets))) if divide_by_weight_sum else None
    rc = lib.sparse_pool_patch_launch(
        src_map.data_ptr(), dt, b, hs, ws, c, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        p, int(num_targets), int(divide_by_weight_sum), scratch.data_ptr(), out.data_ptr(),
        None if den is None else den.data_ptr(), kernels.stream_ptr(device),
    )
    kernels.check(lib, rc, what)
    return out, den


def _bwd_row_grad(grad_out: torch.Tensor, den) -> torch.Tensor:
    """The gradient reaching the undivided sums: g / den where den > 1e-12,
    else 0 (the reference differentiates its quotient)."""

    if den is None:
        return grad_out.to(torch.float32)
    d = den[..., None]
    return torch.where(d > 1e-12, grad_out.to(torch.float32) / torch.clamp_min(d, 1e-12), 0.0)


def sparse_pool_patch_bwd_plain(
    grad_out: torch.Tensor,  # [B, T, C] gradient of the pooled output
    rows: torch.Tensor,  # [B, P] int32
    cols: torch.Tensor,  # [B, P, 4] int32
    vals: torch.Tensor,  # [B, P, 4] f32
    src_hw,  # (Hs, Ws)
    den=None,  # [B, T] f32 weight sums of the forward, or None (no division)
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain twin of kernel A-bwd, the source gradient of the reference's
    ``_patch_pool_denom_with_vjp.bwd``: ``g_src[b, cols[b,p,k]] +=
    vals[b,p,k] * g[b, rows[b,p]] (/ den[b, rows[b,p]])``, one f32
    ``index_add_`` over the 4P corners, cast to ``dtype`` -> [B, Hs, Ws, C].
    Flat ids (b * T + row, b * Hs * Ws + col) outside the batch add nothing,
    as the reference's segment sums drop them."""

    b, t, c = grad_out.shape
    hs, ws = int(src_hw[0]), int(src_hw[1])
    dev = grad_out.device
    g = _bwd_row_grad(grad_out, den).reshape(b * t, c)
    rid = (rows.to(torch.int64) + (torch.arange(b, device=dev) * t)[:, None]).reshape(-1)
    row_ok = (rid >= 0) & (rid < b * t)
    gp = torch.where(row_ok[:, None], g[torch.clamp(rid, 0, b * t - 1)], 0.0)  # [B*P, C]
    entries = vals.reshape(-1, 4, 1).to(torch.float32) * gp[:, None, :]  # [B*P, 4, C]
    cid = (cols.to(torch.int64) + (torch.arange(b, device=dev) * (hs * ws))[:, None, None]).reshape(-1)
    keep = (cid >= 0) & (cid < b * hs * ws)
    g_src = torch.zeros(b * hs * ws, c, dtype=torch.float32, device=dev)
    g_src.index_add_(0, cid[keep], entries.reshape(-1, c)[keep])
    return g_src.reshape(b, hs, ws, c).to(dtype)


@kernels.counted
def sparse_pool_patch_bwd_kernel(
    grad_out: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    src_hw,
    den=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Kernel A-bwd on CUDA tensors -> [B, Hs, Ws, C] in ``dtype``, summed in
    f32 and rounded once."""

    what = "sparse_pool_patch_bwd"
    tensors = (grad_out, rows, cols, vals) if den is None else (grad_out, rows, cols, vals, den)
    device = kernels.require_cuda(*tensors, what=what)
    b, t, c = grad_out.shape
    hs, ws = int(src_hw[0]), int(src_hw[1])
    p = rows.shape[1]
    if grad_out.dtype != torch.float32 or (den is not None and den.dtype != torch.float32):
        raise TypeError(f"{what}: grad_out and den must be float32")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"{what}: rows/cols int32 and vals float32 required")
    if rows.shape != (b, p) or cols.shape != (b, p, 4) or vals.shape != (b, p, 4):
        raise ValueError(f"{what}: rows [B,P], cols/vals [B,P,4] required")
    if den is not None and den.shape != (b, t):
        raise ValueError(f"{what}: den [B, T] required")
    if b * hs * ws >= 2**31 or 4 * b * p >= 2**31 or b * t >= 2**31:
        raise ValueError(f"{what}: B*Hs*Ws, 4*B*P and B*T must stay below 2**31")
    g_src = grad_out.new_empty((b, hs, ws, c), dtype=dtype)
    dt = kernels.dtype_code(g_src, what)
    lib = kernels.library("sparse_pool_patch")
    scratch = rows.new_empty(lib.sparse_pool_patch_bwd_scratch_ints(b, p, hs * ws, c))
    rc = lib.sparse_pool_patch_bwd_launch(
        grad_out.data_ptr(), None if den is None else den.data_ptr(), b, t, c, rows.data_ptr(),
        cols.data_ptr(), vals.data_ptr(), p, hs, ws, dt, scratch.data_ptr(), g_src.data_ptr(),
        kernels.stream_ptr(device),
    )
    kernels.check(lib, rc, what)
    return g_src


class _PatchPool(torch.autograd.Function):
    """Kernel A (or its twin) forward; A-bwd (or its twin) for the source
    map's gradient. Saves the COO and the weight sums, not the map."""

    @staticmethod
    def forward(ctx, src_map, rows, cols, vals, num_targets, divide, accum_dtype):
        fn = sparse_pool_patch_kernel if src_map.is_cuda else sparse_pool_patch_plain
        out, den = fn(src_map, rows, cols, vals, num_targets, divide, accum_dtype)
        ctx.save_for_backward(rows, cols, vals, den)
        ctx.src_hw, ctx.src_dtype = tuple(src_map.shape[1:3]), src_map.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rows, cols, vals, den = ctx.saved_tensors
        fn = sparse_pool_patch_bwd_kernel if grad_out.is_cuda else sparse_pool_patch_bwd_plain
        g_src = fn(grad_out.contiguous(), rows, cols, vals, ctx.src_hw, den, ctx.src_dtype)
        return g_src, None, None, None, None, None, None


def sparse_pool_patch_major_batch(
    src_map: torch.Tensor,  # [B, Hs, Ws, C] source feature map
    rows: torch.Tensor,  # [B, P] int32 target row per point
    cols: torch.Tensor,  # [B, P, 4] int32 bilinear-corner indices
    vals: torch.Tensor,  # [B, P, 4] f32 weights (0 on padding)
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Point-major pooling with one 2x2 window per point -> [B, T, C] f32.
    Kernel A on a CUDA tensor, the plain version on a CPU tensor; the
    gradient reaches ``src_map`` only (A-bwd, or its twin)."""

    if vals.requires_grad:
        raise NotImplementedError(
            "sparse_pool_patch_major_batch: the gradient of vals is not ported (the COO "
            "comes from the points, not from parameters)"
        )
    return _PatchPool.apply(src_map, rows, cols, vals, int(num_targets), divide_by_weight_sum,
                            accum_dtype)


def sparse_pool_ell_batch_plain(
    src_feat: torch.Tensor,  # [B, S, C]
    ell_src: torch.Tensor,  # [B, T, K] int32, local to each frame
    ell_w: torch.Tensor,  # [B, T, K] f32 (0 on padding)
) -> torch.Tensor:
    """Plain twin of kernel B and of the JAX ``sparse_pool_ell_batch``:
    [B, S, C] x ([B, T, K], [B, T, K]) -> [B, T, C], each frame pooled from
    its own source; f32 products summed over K, cast to the source dtype.

    Indices outside [0, S): this twin wraps a negative one and raises on one
    >= S (torch indexing); kernel B drops both; JAX's ``jnp.take`` wraps -1
    and returns NaN for >= S. The host builder emits only [0, S)."""

    b, t, k = ell_src.shape
    frames = torch.arange(b, device=ell_src.device)[:, None]
    g = src_feat[frames, ell_src.reshape(b, t * k).to(torch.int64)].reshape(b, t, k, -1)
    return torch.sum(g.to(torch.float32) * ell_w[..., None], dim=2).to(src_feat.dtype)


def sparse_pool_ell(src_feat: torch.Tensor, ell_src: torch.Tensor, ell_w: torch.Tensor) -> torch.Tensor:
    """ELL sparse-dense product of one frame [S, C] x ([T, K], [T, K]) ->
    [T, C]: the B = 1 case of ``sparse_pool_ell_batch_plain``."""

    return sparse_pool_ell_batch_plain(src_feat[None], ell_src[None], ell_w[None])[0]
