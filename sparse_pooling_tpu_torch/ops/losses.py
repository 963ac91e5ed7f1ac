"""Detection losses: smooth-L1 and softmax cross-entropy over masked samples.

Port of ``sparse_pooling_tpu.ops.losses``. The minibatch is a weight mask,
not a gathered subset; an empty minibatch gives 0 (the normalizer is
``max(sum(weights), 1)``). Samples lie along the second-to-last axis of the
predictions and the last of the weights; leading dims are kept, so a batch
of frames [B, N, D] gives one loss per frame [B], as the reference's vmap.
"""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise: 0.5 d^2 / delta where |d| < delta, else |d| - 0.5 delta."""

    d = torch.abs(pred - target)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


def _normalized(per: torch.Tensor, weights: torch.Tensor, normalizer) -> torch.Tensor:
    if normalizer is None:
        normalizer = torch.sum(weights, dim=-1)
    return torch.sum(per, dim=-1) / torch.clamp_min(torch.as_tensor(normalizer, dtype=per.dtype), 1.0)


def weighted_smooth_l1(pred, target, weights, normalizer=None) -> torch.Tensor:
    """Smooth-L1 summed over the last axis, weighted per sample, divided by
    the weight sum (or ``normalizer``), at least 1."""

    return _normalized(torch.sum(smooth_l1(pred, target), dim=-1) * weights, weights, normalizer)


def weighted_softmax_ce(logits, labels_onehot, weights, normalizer=None) -> torch.Tensor:
    """Softmax cross-entropy per sample, weighted and normalized as above."""

    m = torch.amax(logits, dim=-1, keepdim=True)
    log_probs = logits - (m + torch.log(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True)))
    per = -torch.sum(labels_onehot * log_probs, dim=-1) * weights
    return _normalized(per, weights, normalizer)
