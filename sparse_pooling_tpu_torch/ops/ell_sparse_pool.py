"""Fused ELL sparse pool — kernel B.

Port of ``sparse_pooling_tpu.ops.pallas_sparse_pool``: the host builder
(``data.sparse_matrix.build_sparse_pooling_input``) compiles each frame's
correspondence to fixed-K ELL tables, and ``sparse_pool_fused`` pools
``out[t] = sum_k w[t,k] * src[idx[t,k]]`` with them. Dispatch is by tensor
device: a CUDA tensor launches ``csrc/ell_sparse_pool.cu``, a CPU tensor runs
the plain ``ops.sparse_pool.sparse_pool_ell``.
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch import kernels
from sparse_pooling_tpu_torch.ops.sparse_pool import sparse_pool_ell


@kernels.counted
def sparse_pool_ell_kernel(
    src_feat: torch.Tensor,  # [S, C] f32 or bf16
    ell_src: torch.Tensor,  # [T, K] int32
    ell_w: torch.Tensor,  # [T, K] f32
) -> torch.Tensor:
    """Kernel B on CUDA tensors -> [T, C] in the source dtype."""

    what = "ell_sparse_pool"
    device = kernels.require_cuda(src_feat, ell_src, ell_w, what=what)
    s, c = src_feat.shape
    t, k = ell_src.shape
    if ell_src.dtype != torch.int32 or ell_w.dtype != torch.float32 or ell_w.shape != (t, k):
        raise TypeError(f"{what}: ell_src int32 [T,K] and ell_w float32 [T,K] required")
    dt = kernels.dtype_code(src_feat, what)
    out = src_feat.new_empty((t, c))
    lib = kernels.library("ell_sparse_pool")
    rc = lib.ell_sparse_pool_launch(src_feat.data_ptr(), dt, s, c, ell_src.data_ptr(),
                                    ell_w.data_ptr(), t, k, out.data_ptr(), kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out


def sparse_pool_fused(src_feat: torch.Tensor, ell_src: torch.Tensor, ell_w: torch.Tensor) -> torch.Tensor:
    """ELL sparse pool [S, C] -> [T, C]: kernel B on a CUDA tensor, the plain
    version on a CPU tensor."""

    if src_feat.is_cuda:
        return sparse_pool_ell_kernel(src_feat, ell_src, ell_w)
    return sparse_pool_ell(src_feat, ell_src, ell_w)
