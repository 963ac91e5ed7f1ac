"""The port's hand kernels as PyTorch operators (``torch.ops.spt.*``).

``torch.library.opcheck`` on each of the seven operators with CPU inputs at
edge shapes: the schema (no aliasing, no mutation), the fake implementation
against the plain one (the CPU implementation) under fake tensors and
dynamic shapes, and for kernels A and C the registered autograd (their
inputs require gradients, so ``opcheck`` differentiates through them). No
JAX: the twins' parity with the JAX package is held in the other files.
"""

import numpy as np
import pytest
import torch

from sparse_pooling_tpu_torch import kernels
from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, knn, nms, sparse_pool  # noqa: F401 (registers)

OPS = ("sparse_pool_patch", "sparse_pool_patch_bwd", "ell_sparse_pool", "group_crop", "group_crop_bwd", "greedy_nms",
       "bev_knn")


def _coo(b, hs, ws, p, t, seed):
    """Rows in [-1, t] (one past each end: dropped), windows anywhere on the
    map, weights in [0, 1)."""

    rng = np.random.RandomState(seed)
    rows = torch.from_numpy(rng.randint(-1, t + 1, (b, p)).astype(np.int32))
    c00 = rng.randint(0, hs, (b, p)) * ws + rng.randint(0, ws, (b, p))
    cols = torch.from_numpy(np.stack([c00, c00 + 1, c00 + ws, c00 + ws + 1], -1).astype(np.int32))
    vals = torch.from_numpy(rng.rand(b, p, 4).astype(np.float32))
    return rows, cols, vals


# (B, Hs, Ws, C, P, T): one frame, a map of one row, one column, one
# channel, a single point, more targets than points
A_SHAPES = [(1, 3, 4, 2, 5, 6), (2, 1, 5, 3, 7, 4), (2, 4, 1, 1, 9, 3), (1, 2, 2, 4, 1, 1), (3, 5, 6, 8, 40, 50)]


@pytest.mark.parametrize("shape", A_SHAPES)
@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_kernel_a_operator(shape, divide, accum):
    b, hs, ws, c, p, t = shape
    rows, cols, vals = _coo(b, hs, ws, p, t, seed=sum(shape))
    src = torch.randn(b, hs, ws, c, generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    vals.requires_grad_(True)
    torch.library.opcheck(torch.ops.spt.sparse_pool_patch.default, (src, rows, cols, vals, t, divide, accum))
    out, den = torch.ops.spt.sparse_pool_patch(src, rows, cols, vals, t, divide, accum)
    want, want_den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, t, divide, accum)
    assert torch.equal(out, want)
    assert torch.equal(den, want_den) if divide else den.shape == (0,)


@pytest.mark.parametrize("shape", A_SHAPES)
@pytest.mark.parametrize("with_den", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_a_bwd_operator(shape, with_den, dtype):
    b, hs, ws, c, p, t = shape
    rows, cols, vals = _coo(b, hs, ws, p, t, seed=sum(shape) + 1)
    g = torch.randn(b, t, c, generator=torch.Generator().manual_seed(2))
    den = torch.rand(b, t, generator=torch.Generator().manual_seed(3)) if with_den else None
    args = (g, rows, cols, vals, hs, ws, den, dtype)
    torch.library.opcheck(torch.ops.spt.sparse_pool_patch_bwd.default, args)
    assert torch.equal(torch.ops.spt.sparse_pool_patch_bwd(*args),
                       sparse_pool.sparse_pool_patch_bwd_plain(g, rows, cols, vals, (hs, ws), den, dtype))


# (B, S, C, T, K)
@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 1), (2, 7, 3, 5, 4), (3, 30, 8, 12, 8), (1, 4, 2, 9, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_b_operator(shape, dtype):
    b, s, c, t, k = shape
    rng = np.random.RandomState(sum(shape))
    src = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, s, (b, t, k)).astype(np.int32))
    w = torch.from_numpy((rng.rand(b, t, k) * (rng.rand(b, t, k) > 0.3)).astype(np.float32))
    torch.library.opcheck(torch.ops.spt.ell_sparse_pool.default, (src, idx, w))
    assert torch.equal(torch.ops.spt.ell_sparse_pool(src, idx, w),
                       sparse_pool.sparse_pool_ell_batch_plain(src, idx, w))


# (B, H, W, C, P, V, (ch, cw), patch): a map smaller than the patch, one box
# a unit, one sample a crop, boxes off the map
C_SHAPES = [(1, 3, 3, 2, 1, 1, (1, 1), 4), (2, 9, 11, 3, 2, 3, (3, 3), 4), (1, 6, 20, 1, 3, 2, (2, 5), 8),
            (2, 12, 10, 4, 4, 4, (3, 3), 6)]


def _boxes(b, h, w, p, v, seed):
    g = torch.Generator().manual_seed(seed)
    y1 = torch.rand(b, p, v, generator=g) * (h + 2) - 2
    x1 = torch.rand(b, p, v, generator=g) * (w + 2) - 2
    return torch.stack([y1, x1, y1 + torch.rand(b, p, v, generator=g) * 3,
                        x1 + torch.rand(b, p, v, generator=g) * 3], -1)


@pytest.mark.parametrize("shape", C_SHAPES)
@pytest.mark.parametrize("boxes_grad", [False, True])
def test_kernel_c_operator(shape, boxes_grad):
    b, h, w, c, p, v, (ch, cw), patch = shape
    images = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(4)).requires_grad_(True)
    boxes = _boxes(b, h, w, p, v, seed=5).requires_grad_(boxes_grad)
    torch.library.opcheck(torch.ops.spt.group_crop.default, (images, boxes, ch, cw, patch))
    assert torch.equal(torch.ops.spt.group_crop(images, boxes, ch, cw, patch),
                       crop_resize.crop_and_resize_group_plain(images, boxes, (ch, cw), patch))


@pytest.mark.parametrize("shape", C_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_c_bwd_operator(shape, dtype):
    b, h, w, c, p, v, (ch, cw), patch = shape
    boxes = _boxes(b, h, w, p, v, seed=6)
    grad = torch.randn(b, p, v, ch, cw, c, generator=torch.Generator().manual_seed(7)).to(dtype)
    args = (grad, boxes, h, w, ch, cw, patch, dtype)
    torch.library.opcheck(torch.ops.spt.group_crop_bwd.default, args)
    assert torch.equal(torch.ops.spt.group_crop_bwd(*args), crop_resize.crop_and_resize_group_bwd_plain(
        grad, boxes, (b, h, w, c), (ch, cw), patch, dtype))


# (B, N, max_outputs, iou_threshold): one candidate, more outputs than
# candidates, a frame with none valid, no output
NMS_SHAPES = [(1, 1, 3, 0.5), (2, 9, 12, 0.3), (3, 40, 10, 0.01), (2, 5, 0, 0.5)]


@pytest.mark.parametrize("shape", NMS_SHAPES)
def test_greedy_nms_operator(shape):
    b, n, k, thr = shape
    rng = np.random.RandomState(b * n + k)
    c = rng.uniform(0, 4, (b, n, 2))
    boxes = torch.from_numpy(np.concatenate([c - 0.8, c + 0.8], -1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(b, n).astype(np.float32))
    scores[-1, : n // 2 + 1] = -torch.inf
    if b == 3:
        scores[0] = -torch.inf
    torch.library.opcheck(torch.ops.spt.greedy_nms.default, (boxes, scores, k, thr))
    idx, valid = torch.ops.spt.greedy_nms(boxes, scores, k, thr)
    want = nms.nms_batch_plain(boxes, scores, k, thr)
    assert torch.equal(idx, want.indices) and torch.equal(valid, want.valid)


# (B, P, valid points, Q, K, limit): one point, no valid point, fewer points than K, a limit under the
# points' spacing (K = 3 and a finite limit: what the operator takes)
KNN_SHAPES = [(1, 1, 1, 3, 3, 200.0), (2, 9, 0, 4, 3, 10.0), (3, 20, 2, 7, 3, 200.0), (2, 40, 35, 11, 3, 6.0)]


@pytest.mark.parametrize("shape", KNN_SHAPES)
def test_bev_knn_operator(shape):
    b, p, n, q, k, limit = shape
    rng = np.random.RandomState(b * p + q)
    points = torch.from_numpy(rng.uniform(-20, 20, (b, p, 4)).astype(np.float32))
    valid = torch.zeros(b, p, dtype=torch.bool)
    valid[:, :n] = True
    queries = torch.from_numpy(rng.uniform(-20, 20, (q, 2)).astype(np.float32))
    area = (-40.0, 40.0, 0.0, 70.4)
    torch.library.opcheck(torch.ops.spt.bev_knn.default, (points, valid, queries, k, limit, *area))
    assert torch.equal(torch.ops.spt.bev_knn(points, valid, queries, k, limit, *area),
                       knn.bev_knn_plain(points, valid, queries, k, limit, *area))


def test_every_kernel_is_an_operator_of_one_namespace():
    """Seven operators under ``spt``, each with CPU and CUDA kernels and a
    fake one; A and C with autograd. The raw launchers still refuse CPU
    tensors (``tests/test_torch_port.py``)."""

    for name in OPS:
        qualname = f"spt::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), (name, key)
        autograd = torch._C._dispatch_has_kernel_for_dispatch_key(qualname, "Autograd")
        assert autograd == (name in ("sparse_pool_patch", "group_crop")), name
    assert kernels.OPS.ns == "spt"


def test_operators_need_no_card_to_trace():
    """``torch.export`` sees each forward operator as one node with the
    fake implementation's shapes (the plain twin's data-dependent masks stay
    inside the CPU implementation)."""

    class Both(torch.nn.Module):
        def forward(self, src, rows, cols, vals, images, boxes):
            pooled = sparse_pool.sparse_pool_patch_major_batch(src, rows, cols, vals, 6, True)
            return pooled, crop_resize.crop_and_resize_group_einsum_px(images, boxes, (3, 3), 4)

    rows, cols, vals = _coo(2, 3, 4, 5, 6, seed=8)
    args = (torch.randn(2, 3, 4, 2), rows, cols, vals, torch.randn(2, 9, 11, 3), _boxes(2, 9, 11, 2, 3, 9))
    ep = torch.export.export(Both(), args)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert "spt.sparse_pool_patch.default" in targets and "spt.group_crop.default" in targets
    for got, want in zip(ep.module()(*args), Both()(*args)):
        assert torch.equal(got, want)
