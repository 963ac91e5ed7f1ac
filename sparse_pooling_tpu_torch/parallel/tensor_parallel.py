"""Megatron's conjugate pair for a column-split linear layer.

A layer whose output features are split over the model group computes
``y_m = x W_m`` on each model rank ``m``. The full ``x`` goes in
(:func:`copy_to_model`: identity forward, all-reduce of the input gradient
backward, since each rank's shard contributes a part of it) and the full
``y`` comes out (:func:`gather_from_model`: all-gather forward, this rank's
slice of the gradient backward). Every model rank computes the same loss
from the gathered ``y``, so the backward takes its slice and does not sum
(``torch.distributed.nn.functional.all_gather`` would sum the ``n_model``
equal gradients). Collectives run in f32 (the cast of a bf16 activation is
exact; the input gradient's partial sums add in f32 and round once).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32).contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, ctx.index, ctx.width = dist.get_world_size(group), dist.get_rank(group), x.shape[-1]
        local = x.to(torch.float32).contiguous()
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromModel.apply(x, group)
