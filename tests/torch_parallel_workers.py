"""Rank functions for the port's multi-process tests (``parallel.launch.spawn``
imports them by name in each rank). They import torch and the port only, so
a rank starts without JAX."""

from __future__ import annotations

import torch
import torch.distributed as dist

from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.models.detector import Stage2Head
from sparse_pooling_tpu_torch.parallel import mesh as mesh_mod


def head_for(fusion_type: str, fusion_method: str = "mean") -> torch.nn.ModuleDict:
    """A seeded ``Stage2Head`` under the name the sharding rule reads."""

    torch.manual_seed(0)
    n_views = 1 if fusion_type == "single" else 2
    return torch.nn.ModuleDict({"stage2_head": Stage2Head(
        2 * 2 * 6, (16, 8), 2, torch.float32, box_dim=10, flip_head=True,
        fusion_type="early" if fusion_type == "single" else fusion_type,
        fusion_method=fusion_method, n_views=n_views)})


def head_inputs(fusion_type: str):
    g = torch.Generator().manual_seed(1)
    n_views = 1 if fusion_type == "single" else 2
    views = [torch.randn(2, 5, 2, 2, 6, generator=g) for _ in range(n_views)]
    denom = torch.full((2, 1, 1), 2.0)
    return views, denom


def head_outputs(head, views, denom, keep_prob: float, seed: int):
    views = [v.clone().requires_grad_(True) for v in views]
    outs = head["stage2_head"](views, denom, keep_prob=keep_prob, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in head.named_parameters()}
    return [o.detach() for o in outs], grads, [v.grad.clone() for v in views]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def tp_head_rank(rank: int, cases):
    """Each case's ``Stage2Head`` unsharded and column-sharded over the 2
    ranks' model group, on the same inputs and dropout seed: the largest
    difference of every output, every parameter gradient (the shard's
    against its slice of the full one) and the input gradients, relative to
    the larger of 1 and the tensor's largest magnitude."""

    mesh = mesh_mod.make_mesh(1, dist.get_world_size())
    errs = {}
    for fusion_type, fusion_method, keep_prob in cases:
        views, denom = head_inputs(fusion_type)
        full = head_for(fusion_type, fusion_method)
        want_out, want_grads, want_in = head_outputs(full, views, denom, keep_prob, seed=3)
        shard = head_for(fusion_type, fusion_method)
        mesh_mod.shard_module(shard, mesh)
        got_out, got_grads, got_in = head_outputs(shard, views, denom, keep_prob, seed=3)
        sliced = mesh_mod.shard_params(want_grads, mesh)
        key = f"{fusion_type}-{fusion_method}-{keep_prob}"
        errs[key] = {  # each relative to the larger of 1 and the tensor's largest magnitude
            "outputs": max(_rel(a, b) for a, b in zip(got_out, want_out)),
            "inputs": max(_rel(a, b) for a, b in zip(got_in, want_in)),
            "params": max(_rel(got_grads[n], sliced[n]) for n in sliced),
            "shape_fc1": tuple(dict(shard.named_parameters())[
                "stage2_head.fc1.weight" if fusion_type in ("early", "single") else "stage2_head.fc1_v0.weight"].shape),
        }
    return errs


def dp_step_rank(rank: int, cfg, extents, state_dict, frames, noise):
    """One data-parallel training step's forward and backward on this rank's
    rows of ``frames`` (no draws: path drop off, keep probability 1, the
    priorities ``noise`` sliced to the rows): the rank's loss terms and the
    gradients ``DistributedDataParallel`` averaged over the data ranks."""

    from torch.nn.parallel import DistributedDataParallel

    world = dist.get_world_size()
    mesh = mesh_mod.make_mesh(world, 1)
    rows = mesh_mod.batch_rows(mesh, len(frames))
    model = pl.make_model(cfg, extents, device="cpu")
    model.load_state_dict(state_dict)
    ddp = DistributedDataParallel(model, process_group=mesh.data_group)
    batch = pl.stack_frames(frames[rows], device="cpu")
    anchors = pl.static_anchor_grid(cfg, extents, device="cpu")
    out = pl.forward_batch_fn(ddp, batch, anchors, cfg, extents, train=True)
    losses = pl.loss_batch(out, batch, cfg, extents, noise=tuple(n[rows] for n in noise))
    losses["total"].backward()
    return {"losses": {k: v.item() for k, v in losses.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()} if rank == 0 else None}


def mesh_train_resume_rank(rank: int, cfg, first: int, second: int):
    """``Trainer(cfg).train(first)`` on the mesh, then a fresh ``Trainer``
    over the same workdir that resumes and trains to ``second``."""

    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    Trainer(cfg, device="cpu").train(max_steps=first)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.train(max_steps=second)
    return {"mesh": trainer.mesh.shape, "step": state.step}


def evaluate_rank(rank: int, cfg, workdir: str, step: int):
    """The ``Evaluator`` of ``cfg`` over ``workdir``'s checkpoint of ``step``
    on this rank's rows; its result (rank 0's on every rank) and mesh."""

    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator

    ev = Evaluator(cfg, workdir=workdir, device="cpu")
    result = ev.run_checkpoint_once(step)
    return {"result": result, "mesh": None if ev.mesh is None else ev.mesh.shape}


def failing_rank(rank: int):
    """Rank 1 raises at once; rank 0 waits in a barrier that rank 1 never
    joins."""

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    return rank
