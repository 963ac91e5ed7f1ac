"""Fused ELL sparse pool — kernel B.

Port of ``sparse_pooling_tpu.ops.pallas_sparse_pool`` and of the JAX
``ops.sparse_pool.sparse_pool_ell_batch``: the host builder
(``data.sparse_matrix.build_sparse_pooling_input``) compiles each frame's
correspondence to fixed-K ELL tables, and the pool computes
``out[b, t] = sum_k w[b,t,k] * src[b, idx[b,t,k]]`` with them. The operator
``torch.ops.spt.ell_sparse_pool`` dispatches by tensor device: a CUDA tensor
launches ``csrc/ell_sparse_pool.cu`` (one launch for a whole batch), a CPU
tensor runs the plain ``ops.sparse_pool.sparse_pool_ell_batch_plain``.

* ``sparse_pool_ell_batch`` — [B, S, C] x [B, T, K] -> [B, T, C];
* ``sparse_pool_fused`` — one frame, [S, C] x [T, K] -> [T, C] (B = 1).
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch import kernels
from sparse_pooling_tpu_torch.ops.sparse_pool import sparse_pool_ell_batch_plain


@kernels.counted
def sparse_pool_ell_kernel(
    src_feat: torch.Tensor,  # [B, S, C] f32 or bf16
    ell_src: torch.Tensor,  # [B, T, K] int32
    ell_w: torch.Tensor,  # [B, T, K] f32
) -> torch.Tensor:
    """Kernel B on CUDA tensors, one launch for the whole batch -> [B, T, C]
    in the source dtype."""

    what = "ell_sparse_pool"
    device = kernels.require_cuda(src_feat, ell_src, ell_w, what=what)
    if src_feat.dim() != 3 or ell_src.dim() != 3 or ell_w.shape != ell_src.shape:
        raise ValueError(f"{what}: src [B,S,C] with ell_src and ell_w [B,T,K] required")
    if ell_src.dtype != torch.int32 or ell_w.dtype != torch.float32:
        raise TypeError(f"{what}: ell_src int32 and ell_w float32 required")
    b, s, c = src_feat.shape
    _, t, k = ell_src.shape
    if ell_src.shape[0] != b:
        raise ValueError(f"{what}: {b} source frames, {ell_src.shape[0]} table frames")
    if b * t >= 2**31 or s >= 2**31:
        raise ValueError(f"{what}: B*T and S must stay below 2**31")
    dt = kernels.dtype_code(src_feat, what)
    out = src_feat.new_empty((b, t, c))
    lib = kernels.library("ell_sparse_pool")
    rc = lib.ell_sparse_pool_launch(src_feat.data_ptr(), dt, b, s, c, ell_src.data_ptr(),
                                    ell_w.data_ptr(), t, k, out.data_ptr(), kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out


kernels.OPS.define("ell_sparse_pool(Tensor src_feat, Tensor ell_src, Tensor ell_w) -> Tensor")
kernels.OPS.impl("ell_sparse_pool", lambda *a: sparse_pool_ell_kernel(*a), "CUDA")
kernels.OPS.impl("ell_sparse_pool", lambda *a: sparse_pool_ell_batch_plain(*a), "CPU")


@torch.library.register_fake("spt::ell_sparse_pool", lib=kernels.OPS)
def _ell_fake(src_feat, ell_src, ell_w):
    return src_feat.new_empty((src_feat.shape[0], ell_src.shape[1], src_feat.shape[2]))


def sparse_pool_ell_batch(src_feat: torch.Tensor, ell_src: torch.Tensor, ell_w: torch.Tensor) -> torch.Tensor:
    """ELL sparse pool of a batch [B, S, C] -> [B, T, C], each frame's
    indices local to it, ``torch.ops.spt.ell_sparse_pool``: kernel B (one
    launch) on a CUDA tensor, the plain version on a CPU tensor."""

    return torch.ops.spt.ell_sparse_pool(src_feat, ell_src, ell_w)


def sparse_pool_fused(src_feat: torch.Tensor, ell_src: torch.Tensor, ell_w: torch.Tensor) -> torch.Tensor:
    """ELL sparse pool of one frame [S, C] -> [T, C]: the B = 1 case of
    ``sparse_pool_ell_batch``."""

    return sparse_pool_ell_batch(src_feat[None], ell_src[None], ell_w[None])[0]
