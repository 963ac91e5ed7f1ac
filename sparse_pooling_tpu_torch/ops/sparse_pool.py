"""SHPL sparse cross-view pooling — kernel A, its backward, and the ELL twin.

Port of ``sparse_pooling_tpu.ops.sparse_pool``:

* ``sparse_pool_patch_major_batch`` — the fusion layer's pool, with its
  gradient: the operators ``torch.ops.spt.sparse_pool_patch`` and
  ``torch.ops.spt.sparse_pool_patch_bwd``. Each point gathers one 2x2xC
  source window at ``cols[..., 0]``, combines the 4 taps with its f32
  bilinear weights and scatter-adds into its target cell; with
  ``divide_by_weight_sum`` the weight sum rides the same scatter as channel
  C+1 and the result is divided by it where it exceeds 1e-12. The
  dispatcher goes by the tensors' device: on a CUDA tensor the forward
  launches kernel A (``csrc/sparse_pool_patch.cu``, which
  sorts the points by target row and gathers each row once instead of
  scattering per point) and the backward kernel A-bwd (the same file: the
  points' corners sorted by source cell, then a gather by cell); on a CPU
  tensor they run ``sparse_pool_patch_plain`` and
  ``sparse_pool_patch_bwd_plain``. Where the weights require it, their
  gradient is ``sparse_pool_patch_vals_grad`` (the reference's ``g_vals``),
  plain PyTorch on both devices.
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


def _ordered_segment_sum(ids: torch.Tensor, entries: torch.Tensor, n_seg: int) -> torch.Tensor:
    """[N] segment ids + [N, C] entries -> [n_seg, C] in the entries' dtype,
    each segment's entries added in their order and rounded after every add
    (XLA's scatter-add in bf16; ``index_add_`` on the CPU sums in f32 and
    rounds once, on a card in the atomics' order). One vectorised add per
    depth: the k-th entries of all segments together."""

    order = torch.argsort(ids, stable=True)
    ids_s, ent_s = ids[order], entries[order]
    counts = torch.bincount(ids_s, minlength=n_seg)
    starts = torch.cumsum(counts, 0) - counts
    depth = torch.arange(ids_s.numel(), device=ids.device) - starts[ids_s]
    by_depth = torch.argsort(depth, stable=True)
    out = torch.zeros(n_seg, entries.shape[1], dtype=entries.dtype, device=entries.device)
    lo = 0
    for n in torch.bincount(depth).tolist() if depth.numel() else []:
        pick = by_depth[lo:lo + n]
        seg = ids_s[pick]
        out[seg] = out[seg] + ent_s[pick]
        lo += n
    return out


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
    ``divide_by_weight_sum``). In f32 one ``index_add_``; in bf16 each row's
    sum rounds after every add, in the points' order, as the reference's
    ``segment_sum`` does (``_ordered_segment_sum``)."""

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
    if acc == torch.float32:
        flat = torch.zeros(b * num_targets, n_ch, dtype=acc, device=src_map.device)
        flat.index_add_(0, ids[keep], g.reshape(-1, n_ch)[keep])
    else:
        flat = _ordered_segment_sum(ids[keep], g.reshape(-1, n_ch)[keep], b * num_targets)
    flat = flat.reshape(b, num_targets, n_ch)
    if not divide_by_weight_sum:
        return flat.to(torch.float32), None
    out = flat[..., :c].to(torch.float32)
    den = flat[..., c:].to(torch.float32)
    out = torch.where(den > 1e-12, out / torch.clamp_min(den, 1e-12), 0.0)
    return out, den[..., 0].clone(memory_format=torch.contiguous_format)  # storage of its own


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
    f32 or None), as ``sparse_pool_patch_plain``: sums in f32, or with
    ``accum_dtype="bfloat16"`` in bf16 in the points' order (the ordered
    gather). Either way each row's sum is taken in an order its frame's
    inputs fix: the same bits every launch, whatever the other frames of
    the batch. The backward reads the weight sums the kernel writes."""

    what = "sparse_pool_patch"
    if accum_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"{what}: accum_dtype float32 or bfloat16, got {accum_dtype}")
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
        p, int(num_targets), int(divide_by_weight_sum), int(accum_dtype == "bfloat16"),
        scratch.data_ptr(), out.data_ptr(),
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
    f32 in the entries' order and rounded once: the same bits every launch."""

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


def sparse_pool_patch_vals_grad(
    grad_out: torch.Tensor,  # [B, T, C] gradient of the pooled output
    src_map: torch.Tensor,  # [B, Hs, Ws, C]
    rows: torch.Tensor,  # [B, P] int32
    cols: torch.Tensor,  # [B, P, 4] int32
    out: torch.Tensor,  # [B, T, C] f32 the pooled output
    den=None,  # [B, T] f32 weight sums of the forward, or None (no division)
) -> torch.Tensor:
    """Gradient of the weights [B, P, 4] f32, the reference's ``g_vals``:
    the corner values re-gathered in f32, contracted over the channels with
    the gradient of their row's undivided sum; in the division form plus the
    row's weight-sum gradient, -sum_c(g * out) / den where den > 1e-12."""

    b, t, c = grad_out.shape
    dev = grad_out.device
    g = grad_out.to(torch.float32)
    rid = (rows.to(torch.int64) + (torch.arange(b, device=dev) * t)[:, None]).reshape(-1)
    row_ok = ((rid >= 0) & (rid < b * t))[:, None]
    rid = torch.clamp(rid, 0, b * t - 1)
    gp = torch.where(row_ok, _bwd_row_grad(g, den).reshape(b * t, c)[rid], 0.0)
    patches = _gather_point_patches(src_map, cols).to(torch.float32)  # [B, P, 4, C]
    g_vals = torch.sum(patches * gp.reshape(b, -1, 1, c), dim=-1)
    if den is not None:
        g_den = torch.where(den > 1e-12, -torch.sum(g * out, dim=-1) / torch.clamp_min(den, 1e-12), 0.0)
        g_vals = g_vals + torch.where(row_ok, g_den.reshape(-1)[rid][:, None], 0.0).reshape(b, -1, 1)
    return g_vals


# Kernels A and A-bwd as operators: the dispatcher takes the kernel for a
# CUDA tensor and the twin for a CPU one. Without ``divide_by_weight_sum``
# the weight sums come back as an empty tensor [0] (an operator returns no
# None).
kernels.OPS.define("sparse_pool_patch(Tensor src_map, Tensor rows, Tensor cols, Tensor vals, "
                   "SymInt num_targets, bool divide_by_weight_sum, str accum_dtype) -> (Tensor, Tensor)")
kernels.OPS.define("sparse_pool_patch_bwd(Tensor grad_out, Tensor rows, Tensor cols, Tensor vals, "
                   "SymInt src_h, SymInt src_w, Tensor? den, ScalarType dtype) -> Tensor")


def _with_den(out: torch.Tensor, den):
    return out, out.new_empty((0,)) if den is None else den


# the wrappers are looked up when called, so a patched module name is seen
kernels.OPS.impl("sparse_pool_patch", lambda *a: _with_den(*sparse_pool_patch_kernel(*a)), "CUDA")
kernels.OPS.impl("sparse_pool_patch", lambda *a: _with_den(*sparse_pool_patch_plain(*a)), "CPU")
kernels.OPS.impl("sparse_pool_patch_bwd", lambda g, rows, cols, vals, h, w, den, dtype:
                 sparse_pool_patch_bwd_kernel(g, rows, cols, vals, (h, w), den, dtype), "CUDA")
kernels.OPS.impl("sparse_pool_patch_bwd", lambda g, rows, cols, vals, h, w, den, dtype:
                 sparse_pool_patch_bwd_plain(g, rows, cols, vals, (h, w), den, dtype), "CPU")


@torch.library.register_fake("spt::sparse_pool_patch", lib=kernels.OPS)
def _patch_pool_fake(src_map, rows, cols, vals, num_targets, divide_by_weight_sum, accum_dtype):
    b, c = src_map.shape[0], src_map.shape[3]
    return vals.new_empty((b, num_targets, c)), vals.new_empty((b, num_targets) if divide_by_weight_sum else (0,))


@torch.library.register_fake("spt::sparse_pool_patch_bwd", lib=kernels.OPS)
def _patch_pool_bwd_fake(grad_out, rows, cols, vals, src_h, src_w, den, dtype):
    return grad_out.new_empty((grad_out.shape[0], src_h, src_w, grad_out.shape[2]), dtype=dtype)


def _patch_pool_setup(ctx, inputs, output):
    """Saves the COO and the weight sums, and the map and the output only
    where the weights require a gradient."""

    src_map, rows, cols, vals, _, divide, _ = inputs
    out, den = output
    ctx.mark_non_differentiable(den)
    keep = vals.requires_grad
    ctx.save_for_backward(rows, cols, vals, den if divide else None, src_map if keep else None,
                          out if keep else None)
    ctx.src_hw, ctx.src_dtype = tuple(src_map.shape[1:3]), src_map.dtype


def _patch_pool_backward(ctx, grad_out, _grad_den):
    """A-bwd (or its twin) for the source map's gradient,
    ``sparse_pool_patch_vals_grad`` for the weights'."""

    rows, cols, vals, den, src_map, out = ctx.saved_tensors
    g_src = g_vals = None
    if ctx.needs_input_grad[0]:
        g_src = torch.ops.spt.sparse_pool_patch_bwd(grad_out.contiguous(), rows, cols, vals, *ctx.src_hw,
                                                    den, ctx.src_dtype)
    if ctx.needs_input_grad[3]:
        g_vals = sparse_pool_patch_vals_grad(grad_out, src_map, rows, cols, out, den).to(vals.dtype)
    return g_src, None, None, g_vals, None, None, None


torch.library.register_autograd("spt::sparse_pool_patch", _patch_pool_backward,
                                setup_context=_patch_pool_setup, lib=kernels.OPS)


def sparse_pool_patch_major_batch(
    src_map: torch.Tensor,  # [B, Hs, Ws, C] source feature map
    rows: torch.Tensor,  # [B, P] int32 target row per point
    cols: torch.Tensor,  # [B, P, 4] int32 bilinear-corner indices
    vals: torch.Tensor,  # [B, P, 4] f32 weights (0 on padding)
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Point-major pooling with one 2x2 window per point -> [B, T, C] f32,
    ``torch.ops.spt.sparse_pool_patch``: kernel A on a CUDA tensor, the plain
    version on a CPU tensor; the gradient reaches ``src_map`` (A-bwd, or its
    twin) and, where they require it, ``vals``."""

    return torch.ops.spt.sparse_pool_patch(src_map, rows, cols, vals, int(num_targets),
                                           bool(divide_by_weight_sum), accum_dtype)[0]


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
