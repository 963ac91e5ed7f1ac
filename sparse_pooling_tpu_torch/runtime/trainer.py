"""Training runtime: optimizer, train step, checkpoint loop, on one card or
a ``(data, model)`` mesh of ranks.

Port of ``sparse_pooling_tpu.runtime.trainer``. In a process without a
process group the trainer runs on one card (with ``train.data_parallel``
set and more cards visible it says so, and names ``run_training``, which
starts one rank per card, or torchrun). In a process group with
``train.data_parallel`` set it lays ``parallel.mesh.auto_mesh`` over the
world: each rank loads only its rows of every global batch, draws its
random numbers at the global batch's shape and keeps its rows
(``models.draws``), cuts the stage-2 FCs to its column shard on the model
axis, averages gradients over the data axis (``DistributedDataParallel``)
and clips by the global norm; rank 0 writes the summaries (means over the
data ranks) and the checkpoints, gathered to the single-card layout.

Adam, SGD or RMSprop with optax's staircase ``exponential_decay`` as a
``LambdaLR`` and optax's global-norm clip; a step is the train-mode forward
(path drop and dropout from the trainer's generator), the losses with
in-graph sampling, the backward through kernels A-bwd and C-bwd on the card,
and the update. Parameters are kept in f32 and the layers compute in the
config's dtype, as flax's ``param_dtype`` and ``dtype``. Batches come from a
``KittiDataset`` over ``cfg.dataset`` unless another dataset is given, one
epoch at a time through a ``DevicePrefetcher`` of ``train.prefetch_depth``.
Checkpoints are ``{"model", "optimizer", "step"}`` under
``<workdir>/checkpoints/<step>/``; a new trainer resumes from the latest.
The generator is seeded anew on resume, as the reference re-derives its key.
A single-card trainer or evaluator loads a mesh's checkpoint unchanged, and
a mesh slices a single card's.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from sparse_pooling_tpu_torch import resolve_device, weights
from sparse_pooling_tpu_torch.configs.config import AreaExtents, PipelineConfig
from sparse_pooling_tpu_torch.data.dataset import KittiDataset
from sparse_pooling_tpu_torch.data.pointcloud import trim_points_to_bucket
from sparse_pooling_tpu_torch.data.prefetch import DevicePrefetcher
from sparse_pooling_tpu_torch.models import draws
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.parallel import mesh as mesh_mod
from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
from sparse_pooling_tpu_torch.runtime.summary import SummaryWriter


class RmsProp(torch.optim.Optimizer):
    """optax's ``rmsprop`` (no momentum, not centred): nu = decay * nu +
    (1 - decay) * g^2, p -= lr * g / sqrt(nu + eps), eps inside the root
    (``torch.optim.RMSprop`` adds it outside)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.addcdiv_(p.grad, torch.sqrt(nu + group["eps"]), value=-group["lr"])


def lr_factor(cfg: PipelineConfig) -> Callable[[int], float]:
    """optax ``exponential_decay`` over the update count, as a factor of the
    initial rate: ``decay_rate ** (step / decay_steps)``, floored where
    ``staircase``."""

    oc = cfg.train.optimizer

    def factor(step: int) -> float:
        p = step / oc.decay_steps
        return oc.decay_rate ** (math.floor(p) if oc.staircase else p)

    return factor


def build_optimizer(params, cfg: PipelineConfig):
    """(optimizer, scheduler) for ``params``: Adam, SGD or RMSprop as optax
    builds them (defaults b1 0.9, b2 0.999, eps 1e-8 outside the root for
    Adam; no momentum for SGD), the rate from ``lr_factor``."""

    oc = cfg.train.optimizer
    makers = {
        "adam": lambda p: torch.optim.Adam(p, lr=oc.initial_lr, betas=(0.9, 0.999), eps=1e-8),
        "sgd": lambda p: torch.optim.SGD(p, lr=oc.initial_lr),
        "rmsprop": lambda p: RmsProp(p, lr=oc.initial_lr),
    }
    if oc.name not in makers:
        raise ValueError(f"unknown optimizer '{oc.name}'")
    opt = makers[oc.name](params)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(cfg))


def global_norm(grads: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm).
    With a model ``group``, the gradients flagged in ``sharded`` are column
    shards: their squares are summed over the group, and the replicated ones
    (equal on every model rank) counted once."""

    squares = [torch.sum(g.to(torch.float32) ** 2) for g in grads]
    if group is None:
        return torch.sqrt(sum(squares))
    zero = squares[0].new_zeros(())
    split = sum((q for q, s in zip(squares, sharded) if s), zero)
    dist.all_reduce(split, group=group)
    return torch.sqrt(sum((q for q, s in zip(squares, sharded) if not s), zero) + split)


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """optax's rule in place: leave the gradients where norm < max_norm, else
    scale each by max_norm / norm (``clip_grad_norm_`` adds 1e-6 to the norm)."""

    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_train_step(model, optimizer, scheduler, anchors_static, cfg: PipelineConfig,
                    extents: AreaExtents, mesh: Optional[mesh_mod.Mesh] = None, forward_model=None):
    """``step(batch, generator, noise=None) -> metrics``: forward in train
    mode, ``loss_batch``, backward, clip, update. Metrics are 0-d tensors
    (every loss term, the sampled positives, ``grad_norm`` before the clip
    and ``lr``), read without a sync. On a ``mesh`` the forward runs through
    ``forward_model`` (``model`` wrapped in ``DistributedDataParallel`` over
    the data group) and the norm is the global one over the model group."""

    mc = cfg.model
    clip = cfg.train.optimizer.grad_clip_norm
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    forward_model = model if forward_model is None else forward_model
    group = mesh.model_group if mesh is not None and mesh.n_model > 1 else None
    sharded = [mesh_mod.param_sharding_rules(n) is not None for n, _ in named]

    def step(batch: pl.RawSample, generator: Optional[torch.Generator], noise=None):
        lr = optimizer.param_groups[0]["lr"]
        out = pl.forward_batch_fn(forward_model, batch, anchors_static, mc, extents, train=True,
                                  generator=generator)
        losses = pl.loss_batch(out, batch, mc, extents, generator=generator, noise=noise)
        optimizer.zero_grad(set_to_none=True)
        losses["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = global_norm(grads, sharded, group)
        if clip > 0:
            clip_by_global_norm([p.grad for p in params if p.grad is not None], clip, norm)
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = norm.detach()
        metrics["lr"] = torch.tensor(lr)
        return metrics

    return step


class FrameDataset:
    """A dataset over frames held in memory (dicts of numpy arrays keyed like
    ``pipeline.RawSample``, e.g. ``data.synthetic_frame``), with
    ``KittiDataset``'s ``batches`` and ``__len__``: each epoch takes the
    frames in order, drops the ragged tail and ignores ``augment``; with
    ``rows`` it yields only those rows of each batch. With ``buckets`` a
    batch's points are cut to the smallest bucket that holds them, as
    ``KittiDataset`` stacks them."""

    def __init__(self, frames: List[Dict[str, np.ndarray]], buckets: Optional[Sequence[int]] = None):
        self.frames, self.buckets = list(frames), buckets

    def __len__(self) -> int:
        return len(self.frames)

    def batches(self, batch_size: int, epoch: int = 0, augment: bool = True,
                rows: Optional[slice] = None) -> Iterator[tuple]:
        del epoch, augment
        for start in range(0, len(self.frames) - batch_size + 1, batch_size):
            chunk = self.frames[start : start + batch_size]
            names = [str(start + i) for i in range(batch_size)]
            if rows is not None:
                chunk, names = chunk[rows], names[rows]
            arrays = {
                name: None if chunk[0].get(name) is None else np.stack([f[name] for f in chunk])
                for name in pl.RawSample._fields
            }
            if self.buckets:
                arrays["points"], arrays["points_mask"] = trim_points_to_bucket(
                    arrays["points"], arrays["points_mask"], self.buckets)
            yield tuple(arrays.values()), names


@dataclasses.dataclass
class TrainState:
    model: Any
    optimizer: Any
    scheduler: Any
    step: int
    generator: Any


class Trainer:
    """Workdir-owning train loop (reference ``Trainer``) on one device or,
    in a process group with ``train.data_parallel``, on ``auto_mesh`` over
    the world (``mesh``; every rank of the world builds its trainer at once,
    since the mesh's groups are made collectively). ``dataset`` is any object
    with ``batches(batch_size, epoch, augment, rows=None)`` yielding (arrays
    in ``RawSample`` field order, ids) and ``__len__``; by default a
    ``KittiDataset`` over ``cfg.dataset``. ``input_timings`` sums the
    prefetchers' ``timings`` and ``waits`` over the epochs trained;
    ``step_ms`` holds this rank's time of each summarised step, and
    ``train_step`` and ``generator`` the last ``train``'s step and the
    generator it draws from (to run one more step, e.g. under a profiler).
    A rank with no work (outside the mesh, or beside rank 0 where no mesh
    is made) is ``idle``: its ``train`` returns None at once."""

    def __init__(self, cfg: PipelineConfig, dataset=None, extents: AreaExtents = AreaExtents(),
                 workdir: Optional[str] = None, device="cuda", seed: int = 0):
        self.cfg, self.extents, self.seed = cfg, extents, seed
        self.device = resolve_device(device)
        self.dataset = KittiDataset(cfg.dataset, cfg.model, extents) if dataset is None else dataset
        self.mesh: Optional[mesh_mod.Mesh] = None
        self.rank, self.idle = 0, False
        if dist.is_available() and dist.is_initialized():
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.rank = dist.get_rank()
            if cfg.train.data_parallel:
                self.mesh = mesh_mod.auto_mesh(cfg.train.batch_size, cfg.train.model_parallel)
            self.idle = not self.mesh.member if self.mesh is not None else self.rank != 0
            if self.mesh is not None and self.rank == 0:
                print(f"[trainer] mesh {self.mesh.shape} over {self.mesh.size} of {dist.get_world_size()} "
                      f"ranks ({dist.get_backend()})")
        elif cfg.train.data_parallel and torch.cuda.device_count() > 1:
            print(f"[trainer] train.data_parallel is set and {torch.cuda.device_count()} cards are visible, "
                  f"but this process has no process group: it trains on one ({self.device}). To train on "
                  "all of them, run experiments.run_training (it starts one rank per card) or torchrun "
                  "with run_training --multihost")
        self.input_timings = {"load": 0.0, "put": 0.0, "wait": 0.0, "waits": 0}
        self.step_ms: List[float] = []
        self.workdir = workdir or os.path.join(cfg.experiments_dir, cfg.checkpoint_name)
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self.rank == 0:
            with open(os.path.join(self.workdir, "pipeline_config.json"), "w") as f:
                f.write(cfg.to_json())
        # f32 master parameters; the layers compute in cfg's dtype
        self.model = pl.make_model(cfg.model, extents, device=self.device).float()
        if self.mesh is not None and self.mesh.member:
            mesh_mod.shard_module(self.model, self.mesh)
        self.param_names = [n for n, _ in self.model.named_parameters()]
        self.anchors_static = pl.static_anchor_grid(cfg.model, extents, device=self.device)
        self.summary = SummaryWriter(os.path.join(self.workdir, "summaries")) if self.rank == 0 else None

    # ------------------------------------------------------------ state
    def init_state(self) -> TrainState:
        if self.mesh is None:
            weights.init_like_flax(self.model, seed=self.seed)
        else:  # the full model's init on every rank, then this rank's shard
            full = pl.make_model(self.cfg.model, self.extents, device="cpu").float()
            weights.init_like_flax(full, seed=self.seed)
            self.model.load_state_dict(mesh_mod.shard_params(full.state_dict(), self.mesh))
        opt, sched = build_optimizer(self.model.parameters(), self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return TrainState(self.model, opt, sched, 0, gen)

    def restore_or_init(self) -> TrainState:
        state = self.init_state()
        latest = ckpt_mod.latest_step(self.ckpt_dir)
        if latest is not None:
            saved = ckpt_mod.restore(self.ckpt_dir, latest, map_location=self.device)
            if self.mesh is None:
                self.model.load_state_dict(saved["model"])
                state.optimizer.load_state_dict(saved["optimizer"])
            else:  # a single card's layout, sliced
                self.model.load_state_dict(mesh_mod.shard_params(saved["model"], self.mesh))
                state.optimizer.load_state_dict(
                    mesh_mod.optimizer_state(saved["optimizer"], self.param_names, self.mesh, gather=False))
            state.step = int(saved["step"])
            # the schedule continues at the restored update count
            state.scheduler = torch.optim.lr_scheduler.LambdaLR(
                state.optimizer, lr_factor(self.cfg), last_epoch=state.step - 1
            )
            if self.rank == 0:
                print(f"[trainer] resumed from step {state.step}")
        return state

    def _save(self, writer, state: TrainState) -> None:
        """The checkpoint of ``state``: on a mesh, gathered to the single-card
        layout (parameters and optimizer moments), written by rank 0, then
        a barrier, so no rank goes on before it is on disk."""

        if self.mesh is None:
            writer.save(state.step, {"model": state.model.state_dict(),
                                     "optimizer": state.optimizer.state_dict(), "step": state.step})
            return
        model_sd = mesh_mod.gather_params(state.model.state_dict(), self.mesh)
        opt_sd = mesh_mod.optimizer_state(state.optimizer.state_dict(), self.param_names, self.mesh, gather=True)
        if self.rank == 0:
            writer.save(state.step, {"model": model_sd, "optimizer": opt_sd, "step": state.step})
        dist.barrier(group=self.mesh.group)

    def _data_mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric's mean over the data ranks (the global batch's mean:
        the shards are of equal size)."""

        if self.mesh is None or self.mesh.n_data == 1:
            return metrics
        keys = sorted(metrics)
        dev = metrics["total"].device
        v = torch.stack([metrics[k].to(device=dev, dtype=torch.float32) for k in keys])
        dist.all_reduce(v, group=self.mesh.data_group)
        return dict(zip(keys, v / self.mesh.n_data))

    # ------------------------------------------------------------ loop
    def train(self, max_steps: Optional[int] = None) -> Optional[TrainState]:
        cfg = self.cfg
        if self.idle:
            print(f"[trainer] rank {self.rank} has no rows of the batch of {cfg.train.batch_size}: it leaves")
            return None
        max_steps = max_steps or cfg.train.max_iterations
        state = self.restore_or_init()
        mesh, forward_model, generator, rows = self.mesh, state.model, state.generator, None
        if mesh is not None:
            rows = mesh_mod.batch_rows(mesh, cfg.train.batch_size)
            generator = draws.BatchRows(state.generator, rows, cfg.train.batch_size)
            if mesh.n_data > 1:
                # path drop keeps every parameter in the graph (it scales a
                # branch by 0), so each one has a gradient every step
                forward_model = DistributedDataParallel(state.model, process_group=mesh.data_group)
        train_step = make_train_step(state.model, state.optimizer, state.scheduler,
                                     self.anchors_static, cfg, self.extents, mesh, forward_model)
        self.train_step, self.generator = train_step, generator
        bsz = cfg.train.batch_size
        epoch = state.step * bsz // max(len(self.dataset), 1)
        writer = ckpt_mod.CheckpointWriter(self.ckpt_dir, keep=cfg.train.max_checkpoints_to_keep)
        cuda = self.device.type == "cuda"
        t_last = time.time()
        while state.step < max_steps:
            first = state.step
            host = (self.dataset.batches(bsz, epoch, augment=True) if rows is None
                    else self.dataset.batches(bsz, epoch, augment=True, rows=rows))
            prefetch = DevicePrefetcher(
                host, depth=cfg.train.prefetch_depth,
                device=self.device, transform=lambda item: (pl.RawSample(*item[0]), item[1]))
            with prefetch:  # an early break must release the worker and its batches
                for batch, _ids in prefetch:
                    if cuda:
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                    t0 = time.perf_counter()
                    metrics = train_step(batch, generator)
                    if cuda:
                        end.record()
                    state.step += 1
                    if state.step % cfg.train.summary_interval == 0:
                        metrics = {k: float(v) for k, v in self._data_mean(metrics).items()}
                        if cuda:
                            end.synchronize()
                            metrics["step_ms"] = start.elapsed_time(end)
                        else:
                            metrics["step_ms"] = 1e3 * (time.perf_counter() - t0)
                        self.step_ms.append(metrics["step_ms"])
                        dt = time.time() - t_last
                        t_last = time.time()
                        rate = cfg.train.summary_interval * bsz / max(dt, 1e-9)
                        if self.summary is not None:
                            self.summary.scalars(state.step, {**metrics, "frames_per_sec": rate})
                            print(f"[trainer] step {state.step} total={metrics['total']:.4f} "
                                  f"rpn_obj={metrics['rpn_objectness']:.4f} cls={metrics['cls']:.4f} "
                                  f"fps={rate:.1f}")
                    if state.step % cfg.train.checkpoint_interval == 0 or state.step >= max_steps:
                        self._save(writer, state)
                    if state.step >= max_steps:
                        break
            for key, value in prefetch.timings.items():
                self.input_timings[key] += value
            self.input_timings["waits"] += prefetch.waits
            if state.step == first:
                raise ValueError(f"the dataset yields no batch of {bsz} frames")
            epoch += 1
        return state
