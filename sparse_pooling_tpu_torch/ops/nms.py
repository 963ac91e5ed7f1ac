"""Fixed-size greedy non-maximum suppression, one hand kernel a call.

Port of ``sparse_pooling_tpu.ops.nms``. Conventions kept exactly:
  * always ``max_outputs`` indices plus a validity mask;
  * each step picks the first maximum of the live scores (argmax); when all
    live scores are -inf the pick is index 0 with ``valid=False``;
  * suppression where IoU > threshold (and the pick itself) sets -inf;
  * the top-k prefilter is a stable descending sort, so ties (including the
    -inf of masked anchors) keep array order as ``lax.top_k`` does.

``nms_batch`` is the operator ``torch.ops.spt.greedy_nms``: a CUDA tensor
launches ``csrc/greedy_nms.cu`` (one launch a call, a thread block a frame
running every greedy round), a CPU tensor runs ``nms_batch_plain``, the
greedy loop in plain PyTorch. The JAX package's loop is a ``lax.fori_loop``
that XLA runs on the device; in eager PyTorch the plain loop dispatches about
32 small ops a round from the host. The kernel gives the plain loop's
indices and validity bit for bit (its f32 arithmetic rounds where the plain
loop's ops round; ``csrc/greedy_nms.cu`` states the contract). Boxes and
scores reach it in float32; the kernel takes no other dtype.

The kernel keeps a frame's scores in shared memory, so a call takes at most
``max_candidates()`` candidates a frame. Above that (``candidate_limit``),
``nms_batch`` first keeps the frame's ``max_candidates()`` best scores (a
stable descending sort on the device, no wait on the host: of equal scores
the lower index is kept), in their original order, runs the kernel on them
and returns indices into the full set. That is the full set's greedy NMS
while a kept candidate is still live: each round's best live score is then
a kept one, and among equal scores the lower index comes first, as the
plain loop picks. Where the kept set runs dry, fewer picks than asked while
a candidate outside it still has a score, the answer may differ from the
full set's: the call adds each such frame to a device counter, which
``short_frames()`` reads.
"""

from __future__ import annotations

import functools
import sys
from typing import Dict, NamedTuple

import torch

from sparse_pooling_tpu_torch import kernels


# frames a call over more candidates than the kernel holds answered from a kept set that ran dry, a
# counter on each device (added to on the device, read by short_frames)
_SHORT: Dict[str, torch.Tensor] = {}


class NmsResult(NamedTuple):
    indices: torch.Tensor  # [B, max_outputs] int64 into the input boxes
    valid: torch.Tensor  # [B, max_outputs] bool


def nms_batch_plain(
    boxes: torch.Tensor,  # [B, N, 4] [y1, x1, y2, x2]
    scores: torch.Tensor,  # [B, N]; -inf marks invalid boxes
    max_outputs: int,
    iou_threshold: float = 0.5,
) -> NmsResult:
    """Batch-native greedy NMS in plain PyTorch (the kernel's twin)."""

    b, n, _ = boxes.shape
    dev = boxes.device
    arange_n = torch.arange(n, device=dev)
    y1, x1, y2, x2 = boxes.unbind(-1)
    areas = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    live = scores.to(torch.float32).clone()
    out_idx = torch.zeros((b, max_outputs), dtype=torch.int64, device=dev)
    out_valid = torch.zeros((b, max_outputs), dtype=torch.bool, device=dev)
    for i in range(max_outputs):
        best = torch.argmax(live, dim=1)  # first maximum
        bi = best[:, None]
        ok = torch.gather(live, 1, bi)[:, 0] > -torch.inf
        out_idx[:, i] = best
        out_valid[:, i] = ok
        py1, px1 = torch.gather(y1, 1, bi), torch.gather(x1, 1, bi)
        py2, px2 = torch.gather(y2, 1, bi), torch.gather(x2, 1, bi)
        inter = torch.clamp_min(torch.minimum(py2, y2) - torch.maximum(py1, y1), 0) * (
            torch.clamp_min(torch.minimum(px2, x2) - torch.maximum(px1, x1), 0)
        )
        union = torch.gather(areas, 1, bi) + areas - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)
        suppress = (iou > iou_threshold) | (arange_n[None, :] == bi)
        live = torch.where(ok[:, None] & suppress, -torch.inf, live)
    return NmsResult(out_idx, out_valid)


@functools.cache
def max_candidates() -> int:
    """The most candidates a frame the kernel takes (it keeps a frame's
    scores in shared memory, 4 bytes a candidate; the presets pass at most
    17600, the rcnn dense grid). Read from the built library."""

    return kernels.library("greedy_nms").greedy_nms_max_candidates()


@kernels.counted
def greedy_nms_kernel(
    boxes: torch.Tensor,  # [B, N, 4] f32
    scores: torch.Tensor,  # [B, N] f32
    max_outputs: int,
    iou_threshold: float,
):
    """The greedy NMS kernel on CUDA tensors, one launch for the batch ->
    (indices int64 [B, max_outputs], valid bool [B, max_outputs]). B and
    max_outputs are at least 1: an empty call launches nothing, and the
    operator answers it without this wrapper."""

    what = "greedy_nms"
    device = kernels.require_cuda(boxes, scores, what=what)
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"{what}: boxes [B,N,4] and scores [B,N] required")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"{what}: boxes and scores float32 required")
    b, n, _ = boxes.shape
    if b < 1 or max_outputs < 1:
        raise ValueError(f"{what}: B = {b} and max_outputs = {max_outputs}, both must be >= 1")
    limit = max_candidates()
    if not 1 <= n <= limit:
        raise ValueError(f"{what}: {n} candidates a frame, the kernel takes 1 to {limit}")
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()  # each box is one 16-byte load
    out_idx = boxes.new_empty((b, max_outputs), dtype=torch.int64)
    out_valid = boxes.new_empty((b, max_outputs), dtype=torch.bool)
    lib = kernels.library("greedy_nms")
    rc = lib.greedy_nms_launch(boxes.data_ptr(), scores.data_ptr(), b, n, max_outputs, iou_threshold,
                               out_idx.data_ptr(), out_valid.data_ptr(), kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out_idx, out_valid


def _greedy_nms_cuda(boxes, scores, max_outputs, iou_threshold):
    """The operator on CUDA tensors: the kernel, or with no frame or no
    output nothing to launch."""

    if boxes.shape[0] and max_outputs:
        return greedy_nms_kernel(boxes, scores, max_outputs, iou_threshold)
    shape = (boxes.shape[0], max_outputs)
    return boxes.new_zeros(shape, dtype=torch.int64), boxes.new_zeros(shape, dtype=torch.bool)


kernels.OPS.define("greedy_nms(Tensor boxes, Tensor scores, int max_outputs, float iou_threshold) -> (Tensor, Tensor)")
kernels.OPS.impl("greedy_nms", _greedy_nms_cuda, "CUDA")
kernels.OPS.impl("greedy_nms", lambda *a: tuple(nms_batch_plain(*a)), "CPU")


@torch.library.register_fake("spt::greedy_nms", lib=kernels.OPS)
def _greedy_nms_fake(boxes, scores, max_outputs, iou_threshold):
    shape = (boxes.shape[0], max_outputs)
    return boxes.new_empty(shape, dtype=torch.int64), boxes.new_empty(shape, dtype=torch.bool)


def candidate_limit(boxes: torch.Tensor) -> int:
    """The most candidates a frame one ``greedy_nms`` call takes on the
    device of ``boxes``: the kernel's on a card, any number off it."""

    return max_candidates() if boxes.is_cuda else sys.maxsize


def nms_batch(
    boxes: torch.Tensor,  # [B, N, 4] [y1, x1, y2, x2]
    scores: torch.Tensor,  # [B, N]; -inf marks invalid boxes
    max_outputs: int,
    iou_threshold: float = 0.5,
) -> NmsResult:
    """Batch-native greedy NMS, ``torch.ops.spt.greedy_nms``: the kernel (one
    launch) on CUDA tensors, ``nms_batch_plain`` on CPU tensors. Over more
    candidates than ``candidate_limit``, on the best of them (the module's
    docstring)."""

    limit = candidate_limit(boxes)
    scores = scores.to(torch.float32)
    if boxes.shape[1] <= limit:
        return NmsResult(*torch.ops.spt.greedy_nms(boxes.contiguous(), scores.contiguous(), max_outputs,
                                                   iou_threshold))
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    kept = torch.sort(order[:, :limit], dim=1).values
    idx, valid = torch.ops.spt.greedy_nms(torch.gather(boxes, 1, kept[..., None].expand(-1, -1, 4)).contiguous(),
                                          torch.gather(scores, 1, kept).contiguous(), max_outputs, iou_threshold)
    outside = torch.gather(scores, 1, order[:, limit:limit + 1])[:, 0] > -torch.inf
    short = (valid.sum(dim=1) < max_outputs) & outside
    counter = _SHORT.get(str(boxes.device))
    if counter is None:
        counter = _SHORT[str(boxes.device)] = torch.zeros((), dtype=torch.int64, device=boxes.device)
    counter.add_(short.sum())
    # an invalid pick is index 0, as over the full set
    return NmsResult(torch.where(valid, torch.gather(kept, 1, idx), 0), valid)


def short_frames() -> int:
    """The frames of this process's calls over more candidates than the
    kernel holds whose kept set ran dry (the module's docstring), on every
    device. Reads the counters (a wait for the card)."""

    return sum(int(c.item()) for c in _SHORT.values())


def top_k_nms_batch(
    boxes: torch.Tensor,  # [B, N, 4]
    scores: torch.Tensor,  # [B, N]
    max_outputs: int,
    iou_threshold: float = 0.5,
    pre_top_k: int = 1024,
) -> NmsResult:
    """Top-k prefilter then NMS; indices in the original box indexing."""

    order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = order.values[:, :pre_top_k], order.indices[:, :pre_top_k]
    boxes_k = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, boxes.shape[-1]))
    sub = nms_batch(boxes_k, top_scores, max_outputs, iou_threshold)
    return NmsResult(torch.gather(top_idx, 1, sub.indices), sub.valid)
