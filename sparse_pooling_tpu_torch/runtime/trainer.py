"""Training runtime on one card: optimizer, train step, checkpoint loop.

Port of ``sparse_pooling_tpu.runtime.trainer`` for a single device (the
mesh of ``parallel/`` is not ported). Adam, SGD or RMSprop with optax's
staircase ``exponential_decay`` as a ``LambdaLR`` and optax's global-norm
clip; a step is the train-mode forward (path drop and dropout from the
trainer's generator), the losses with in-graph sampling, the backward
through kernels A-bwd and C-bwd on the card, and the update. Parameters are
kept in f32 and the layers compute in the config's dtype, as flax's
``param_dtype`` and ``dtype``. Checkpoints are ``{"model", "optimizer",
"step"}`` under ``<workdir>/checkpoints/<step>/``; a new trainer resumes
from the latest. The generator is seeded anew on resume, as the reference
re-derives its key.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from sparse_pooling_tpu_torch import resolve_device, weights
from sparse_pooling_tpu_torch.configs.config import AreaExtents, PipelineConfig
from sparse_pooling_tpu_torch.data.synthetic_frame import trim_points_to_bucket
from sparse_pooling_tpu_torch.models import pipeline as pl
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


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""

    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """optax's rule in place: leave the gradients where norm < max_norm, else
    scale each by max_norm / norm (``clip_grad_norm_`` adds 1e-6 to the norm)."""

    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_train_step(model, optimizer, scheduler, anchors_static, cfg: PipelineConfig,
                    extents: AreaExtents):
    """``step(batch, generator, noise=None) -> metrics``: forward in train
    mode, ``loss_batch``, backward, clip, update. Metrics are 0-d tensors
    (every loss term, the sampled positives, ``grad_norm`` before the clip
    and ``lr``), read without a sync."""

    mc = cfg.model
    clip = cfg.train.optimizer.grad_clip_norm
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: pl.RawSample, generator: Optional[torch.Generator], noise=None):
        lr = optimizer.param_groups[0]["lr"]
        out = pl.forward_batch_fn(model, batch, anchors_static, mc, extents, train=True,
                                  generator=generator)
        losses = pl.loss_batch(out, batch, mc, extents, generator=generator, noise=noise)
        optimizer.zero_grad(set_to_none=True)
        losses["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = global_norm(grads)
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
    ``pipeline.RawSample``, e.g. ``data.synthetic_frame``), with the JAX
    ``KittiDataset``'s ``batches`` and ``__len__``: each epoch takes the
    frames in order, drops the ragged tail and ignores ``augment`` (the
    augmentation is not ported yet). With ``buckets`` a batch's points are
    cut to the smallest bucket that holds them, as the reference stacks
    them."""

    def __init__(self, frames: List[Dict[str, np.ndarray]], buckets: Optional[Sequence[int]] = None):
        self.frames, self.buckets = list(frames), buckets

    def __len__(self) -> int:
        return len(self.frames)

    def batches(self, batch_size: int, epoch: int = 0, augment: bool = True) -> Iterator[tuple]:
        del epoch, augment
        for start in range(0, len(self.frames) - batch_size + 1, batch_size):
            chunk = self.frames[start : start + batch_size]
            arrays = {
                name: None if chunk[0].get(name) is None else np.stack([f[name] for f in chunk])
                for name in pl.RawSample._fields
            }
            if self.buckets:
                arrays["points"], arrays["points_mask"] = trim_points_to_bucket(
                    arrays["points"], arrays["points_mask"], self.buckets)
            yield tuple(arrays.values()), [str(start + i) for i in range(batch_size)]


def to_device(arrays, device) -> pl.RawSample:
    """One batch of a dataset (stacked arrays in ``RawSample`` field order)
    on ``device``, through ``pipeline.stack_frames``."""

    b = next(a for a in arrays if a is not None).shape[0]
    frames = [
        {name: a[i] for name, a in zip(pl.RawSample._fields, arrays) if a is not None}
        for i in range(b)
    ]
    return pl.stack_frames(frames, device=device)


@dataclasses.dataclass
class TrainState:
    model: Any
    optimizer: Any
    scheduler: Any
    step: int
    generator: Any


class Trainer:
    """Workdir-owning train loop on one device (reference ``Trainer``).
    ``dataset`` is any object with ``batches(batch_size, epoch, augment)``
    yielding (arrays in ``RawSample`` field order, ids) and ``__len__``."""

    def __init__(self, cfg: PipelineConfig, dataset, extents: AreaExtents = AreaExtents(),
                 workdir: Optional[str] = None, device="cuda", seed: int = 0):
        self.cfg, self.extents, self.dataset, self.seed = cfg, extents, dataset, seed
        self.device = resolve_device(device)
        self.workdir = workdir or os.path.join(cfg.experiments_dir, cfg.checkpoint_name)
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(os.path.join(self.workdir, "pipeline_config.json"), "w") as f:
            f.write(cfg.to_json())
        # f32 master parameters; the layers compute in cfg's dtype
        self.model = pl.make_model(cfg.model, extents, device=self.device).float()
        self.anchors_static = pl.static_anchor_grid(cfg.model, extents, device=self.device)
        self.summary = SummaryWriter(os.path.join(self.workdir, "summaries"))

    # ------------------------------------------------------------ state
    def init_state(self) -> TrainState:
        weights.init_like_flax(self.model, seed=self.seed)
        opt, sched = build_optimizer(self.model.parameters(), self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return TrainState(self.model, opt, sched, 0, gen)

    def restore_or_init(self) -> TrainState:
        state = self.init_state()
        latest = ckpt_mod.latest_step(self.ckpt_dir)
        if latest is not None:
            saved = ckpt_mod.restore(self.ckpt_dir, latest, map_location=self.device)
            self.model.load_state_dict(saved["model"])
            state.optimizer.load_state_dict(saved["optimizer"])
            state.step = int(saved["step"])
            # the schedule continues at the restored update count
            state.scheduler = torch.optim.lr_scheduler.LambdaLR(
                state.optimizer, lr_factor(self.cfg), last_epoch=state.step - 1
            )
            print(f"[trainer] resumed from step {state.step}")
        return state

    # ------------------------------------------------------------ loop
    def train(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        max_steps = max_steps or cfg.train.max_iterations
        state = self.restore_or_init()
        train_step = make_train_step(state.model, state.optimizer, state.scheduler,
                                     self.anchors_static, cfg, self.extents)
        bsz = cfg.train.batch_size
        epoch = state.step * bsz // max(len(self.dataset), 1)
        writer = ckpt_mod.CheckpointWriter(self.ckpt_dir, keep=cfg.train.max_checkpoints_to_keep)
        cuda = self.device.type == "cuda"
        t_last = time.time()
        while state.step < max_steps:
            first = state.step
            for arrays, _ids in self.dataset.batches(bsz, epoch, augment=True):
                if cuda:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                metrics = train_step(to_device(arrays, self.device), state.generator)
                if cuda:
                    end.record()
                state.step += 1
                if state.step % cfg.train.summary_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if cuda:
                        end.synchronize()
                        metrics["step_ms"] = start.elapsed_time(end)
                    else:
                        metrics["step_ms"] = 1e3 * (time.perf_counter() - t0)
                    dt = time.time() - t_last
                    t_last = time.time()
                    rate = cfg.train.summary_interval * bsz / max(dt, 1e-9)
                    self.summary.scalars(state.step, {**metrics, "frames_per_sec": rate})
                    print(f"[trainer] step {state.step} total={metrics['total']:.4f} "
                          f"rpn_obj={metrics['rpn_objectness']:.4f} cls={metrics['cls']:.4f} "
                          f"fps={rate:.1f}")
                if state.step % cfg.train.checkpoint_interval == 0 or state.step >= max_steps:
                    writer.save(state.step, {"model": state.model.state_dict(),
                                             "optimizer": state.optimizer.state_dict(),
                                             "step": state.step})
                if state.step >= max_steps:
                    break
            if state.step == first:
                raise ValueError(f"the dataset yields no batch of {bsz} frames")
            epoch += 1
        return state
