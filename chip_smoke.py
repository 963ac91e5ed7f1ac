"""Chip smoke for the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--ell-baseline CU] [--a-baseline DIR]

Needs one CUDA card; exits non-zero without one. Phases (any failure exits
non-zero):

1. build the hand kernels from ``sparse_pooling_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit;
2. kernels against their plain PyTorch twins on the card, at the shapes the
   main path gives them (inputs recorded from a warm-up request), in bf16
   features and in f32: max error against a stated tolerance; median times
   (CUDA events around the call) of kernel, twin and one PyTorch library
   call, and for kernel and library call also their device time (after a
   spin that covers the host's launches), their device time with the L2
   flushed before each run, and the host's enqueue time; the bound (bytes
   over 3.35 TB/s vs operations over 67 TFLOP/s f32); each kernel's host
   time through its ``torch.ops.spt`` operator beside the raw launcher's
   (and kernel A's through a ``torch.library.custom_op``, the route the
   port does not take); A's live-point share
   and points per target row, and C's window gather alone (TPU kernels 3
   and 4); the device time of an empty kernel, the floor of any launch;
   kernel B at one frame, at the probe's shapes and at batch 8 (request 0's
   frames, each with its own host ELL tables), with its share of live ELL
   slots and its tap reads, and with ``--ell-baseline`` the given earlier
   kernel B source timed on the same work; the greedy NMS kernel at the
   warm-up request's two calls (the RPN's 8 x 4096 candidates to 128 picks,
   the final 8 x 128 to 100; ``nms_phase``): its picks equal to the plain
   loop's bit for bit on the card and the CPU, its times, the plain loop's,
   its bound (no library computes greedy NMS: its library times print null);
3. the main path: the cars preset at full width (bf16 compute) answers 3
   requests of batch 8 synthetic frames (16384 points, seeded) through
   ``forward_batch_fn`` + ``decode_batch``; launch counts of kernels A, C
   and NMS (2 each a request) are read around exactly these 3 requests;
   then where the time goes: the
   stage times of one more request and a torch.profiler split of another;
4. the ELL path: the host ELL tables (K=8) of request 0's 8 frames pool
   their post-projection mid features through ``sparse_pool_ell_batch``,
   one launch of kernel B per direction (counted), held against the plain
   ELL pool; the gap to kernel A's exact pool on rows with <= 8 sources is
   printed for information;
5. the narrow parity config on the card against the same model on the CPU
   (f32, TF32 off): the RPN outputs must agree;
6. training, the cars preset at full width (bf16 compute, f32 parameters),
   batch 8 synthetic frames with ``gt_boxes_3d[0]`` moved onto a point
   cluster: the backward kernels A-bwd and C-bwd against their twins at the
   shapes of one real training step (inputs recorded from it), timed as the
   forwards are, against ``torch.sparse.mm`` with the transposed matrix and
   ``F.grid_sample``'s input gradient, each through its operator beside
   the raw launcher (host time); ``Trainer.train(6)`` with a
   checkpoint at step 6 (counts read around exactly these 6 steps: A, C,
   A-bwd and C-bwd twice a step), every step's losses, grad norm, sampled
   positives and time, peak memory, a torch.profiler split of one more step,
   a fresh ``Trainer`` that restores step 6 exactly and takes step 7, and 10
   steps on one fixed batch (no path drop, no dropout, fixed sampling noise)
   that must lower its loss;
7. one training step of the narrow parity config on the card against the
   CPU, with stage-2 positives sampled: losses and every parameter's
   gradient;
8. the KITTI data path: a tree of 36 frames written from seeds under the
   git-ignored ``build/`` (16 training, 20 val); for each training frame
   the native PNG decode against the image drawn (byte for byte) and the
   native points against ``load_points_filtered``; one batch's host load
   split by part; then ``Trainer(cfg)`` at full width over the tree (its
   ``KittiDataset`` with shuffle and augmentation, a ``DevicePrefetcher`` of
   depth 2) for 4 steps, 2 epochs: finite losses, the ids in epoch order, A,
   C, A-bwd and C-bwd twice a step (counts read around exactly these
   steps), each step's time beside phase 6's, the prefetcher's load, put
   and wait;
9. evaluation: ``Evaluator`` at full width over the tree's 20 val frames
   (batch 8, the tail batch of 4 padded) through
   ``repeated_checkpoint_run`` on the step-4 checkpoint of phase 8: one
   step evaluated, one prediction file per val frame, A and C twice a
   batch (counts read around exactly the sweep), every AP finite, the
   native AP equal to the numpy oracle's to 1e-12, ``eval_<step>.json``
   written, the prediction image of the first val frame written and drawn
   on; frames/s with host IO and the phase breakdown; one profiled
   eval batch (device busy, launches, A's and C's device time beside phase
   3's profiled request); then ``run_evaluation --ckpt_step 4`` and
   ``run_inference`` on two frames;
10. the rcnn family (``rcnn_cars_config()``: ``FusionRcnn``, a dense conv
   RPN over 17600 anchors a frame, no kernel C) at full width: kernel A
   against its twin at the inputs of a warm-up request, the greedy NMS
   kernel as in phase 2 at its two calls (8 x 4096 to 300 picks at IoU 0.8,
   8 x 300 to 100 at 0.01) and off the serving path at the training size
   (1024 picks) and over every anchor (8 x 17600 to 256, the parity
   training step's NMS), then 3 requests of
   batch 8 (phase 3's frames, ``eval_nms_size`` 300) with the counts read
   around exactly these (A and NMS twice a request, nothing else), latency, peak
   memory, a profiled request (busy, launches, A's device time beside phase
   3's);
11. rcnn training at full width, batch 8, Adam: A-bwd against its twin at
   one real step's inputs, ``Trainer.train(4)`` from memory (A and A-bwd
   twice a step, C and C-bwd never), losses, step times, peak memory, a
   profiled step;
12. the rcnn family's narrow parity config on the card against the CPU;
13. one full-width request of ``people_pyramid_config()`` (two classes, the
   233x267 anchor grid padded to 4x4 blocks, 64 boxes a unit of kernel C):
   C (``kernel_c_phase``: bf16 and f32, times, bound, ``F.grid_sample``)
   and A against their twins at its inputs, then the request (A and C
   twice, NMS three times: the RPN's and one a class; counted) and a
   profiled one; then one training step of the preset
   (A, C, A-bwd and C-bwd twice each, counted), C-bwd at 64 boxes a unit
   (``kernel_c_bwd_phase``: its twins, the same bits twice, times, bound,
   ``F.grid_sample``'s input gradient);
14-18. the AVOD detector's model options at full width (the cars preset
   with one switch each, batch 8, phase 3's frames for requests and phase
   6's for steps; counts read around exactly each path's requests or
   steps):
   P1 (14) ``rpn.roi_quad`` 1, the position filter: kernel C at 8192 units
   of 2 boxes a view and frame (patch 8), held against its twins at a
   warm-up request's inputs, and C-bwd at a warm-up step's, as phases 2 and
   6 hold them (bf16 and f32, C-bwd the same bits twice, times, bounds,
   ``F.grid_sample``); 3 requests (A and C twice each) and 2 training steps
   (A, C, A-bwd, C-bwd twice each);
   P2 (15) ``rpn.dense_grid``: 44800 anchors a frame under the occupancy
   mask; C and C-bwd at 1400 units of 32 boxes, patch 10 (BEV) and 22400
   units of 2, patch 8 (image), held as in P1; 1 request, 1 step;
   P3 (16) reference-exact: ``roi_quad`` 1, stride-1 RPN crops,
   ``decode_stride`` 1 without space-to-depth (the unpacked voxelizer at
   704x800, full-resolution decoders, exact 3x3 crops of 16384 anchors in
   both views): 1 request and 1 step, A twice each and C never; the step's
   peak memory beside phase 6's; the spread of two steps' gradients (the
   exact crops' bf16 ``index_add_`` sums in CUDA's atomic order);
   P4 (17) ``avod.bev_roi_stride`` 4, the strided stage-2 BEV crop: 1
   request;
   P5 (18) ``avod.fusion_type`` late, and deep with ``fusion_method``
   concat: 1 request each; ``backbone.remat``: one step's forward and
   backward (A, C, A-bwd, C-bwd twice each) with its peak memory beside the
   same step without remat and phase 6's, its gradients within 2^-6 of each
   parameter's largest of the step without it (same weights, batch,
   generator seed and noise; deterministic algorithms and kernel A's
   default f32 accumulation, so that the forward gives the same bits twice), beside
   the spread of two steps without it.
   Each path prints its launches, latency or step time, busy share (a
   profiled request or step) and peak memory; one ``[model options P1-P5]``
   JSON line holds them;
19. ``parallel/``: first ``parallel/dryrun.py``'s ``dryrun_multichip(4)``
   (4 CPU ranks over gloo, data 2 x model 2, the production ``Trainer``
   for 2 steps against one process, losses at rtol 1e-5); then on the one
   card: (a) ``run_training --multihost`` as a
   subprocess, a world of 1 over NCCL (torchrun's environment set by the
   script) on phase 8's tree for 2 steps: ``process_info``, an NCCL
   all-reduce of a CUDA tensor, no mesh at one rank, finite losses, the
   checkpoint; (b) two data ranks sharing the card over gloo (NCCL refuses
   two ranks on one device), the cars preset at full width with kernel A's
   bf16 accumulation under deterministic algorithms, phase 6's frames, a
   global batch of 8 (4 a rank), against one process at batch 8: step 1
   from the same seeded init (its total within 2^-6 relative, its
   gradients within 2^-6 in relative L2 over the model, each tensor's
   largest gap printed), then step 2 from one
   process's step-1 checkpoint, which the mesh slices (its total within
   2^-6 relative, every weight after it within 2^-6 of its tensor's
   largest, and each tensor's step-2 update, biases included, within 2^-4
   in relative L2 of one process's; the biases, 0 at init, also print
   their gap in units of lr); A, C, A-bwd and C-bwd twice a step in each rank, each rank's
   step times beside phase 6's, one more step profiled (busy, launches, the
   collectives' spans, the all-reduce's beside the step) and the
   all-reduce of a step's gradients timed alone;
   (c) the same at data 1 x model 2 (the stage-2 FCs split), if gloo's
   all_gather takes CUDA tensors here (else it says that it is left out);
   (d) the ``Evaluator`` on two ranks over gloo, phase 9's tree and step-4
   checkpoint, swept twice (the first pays the fresh processes' warm-up):
   every prediction row within 1e-3 px (2D box) and 1e-4 (3D box, score)
   of one process's sweep of that checkpoint (both in kernel A's default
   f32 accumulation under deterministic algorithms), A and C twice a batch in each rank, both APs,
   frames/s beside phase 9's; one ``[parallel/ phase 19]`` JSON line;
20. the learning checks' path: 2-frame ``cars_hard`` and ``people`` trees
   from the port's tree writer, each loaded through ``KittiDataset`` (the
   cars preset's canvas; ``people_check``'s 96x320 through the host
   resize), ``runtime.preprocess.gen_mini_batches`` (2 spawned workers)
   and ``demos.show_predictions`` (labels drawn as predictions and ground
   truth) on each tree, then ``overfit_check.main`` on the card for 150 steps (the
   unittest preset over its tree, through the host resize, training, the
   sweep of its 5 checkpoints, the native AP): its AP table, finite losses
   and parameters, each ``eval_<step>.json``, A and A-bwd launched (C and
   C-bwd not: exact RPN crops), counts read around exactly the check;
   ``experiments.analyze_2d_gap`` over each checkpoint's predictions (its
   medians printed; a checkpoint with AP above 0 must match detections); one
   ``[learning path, phase 20]`` JSON line;
21. the serving export: ``runtime.export.export_inference`` of the cars
   preset at full width, batch 8, on the card (phase 3's seeded weights and
   requests, padded to the serving layout), its export seconds, graph size
   and the kernels' operators in it; the program within 1e-5 of the live
   pipeline in this process; saved (MB), then a fresh process loads it with
   ``load_serving_fn`` and serves the 3 requests after a warm-up: within
   1e-5 of the live detections, A, C and NMS launched twice each a request,
   each request's latency beside the live pipeline's at the same size and
   phase 3's; one ``[serving export, phase 21]`` JSON line;
22. ContFuse (``contfuse_cars_config()``: one stage, continuous fusion, the
   ``contfuse-serve-b8`` cell's model) at full width, batch 8, frames of
   20,000 points (32,768 slots) with a seeded intensity: the KNN kernel
   (``ops.knn.bev_knn_kernel``) at the served shapes (the four lattices'
   187,000 query points, K = 3, 10 m) against its plain twin on the card,
   bit for bit, with no host sync, its times, the twin's, its bound (its
   bytes once) and the distances a query examined; the NMS over the
   header's 70,400 candidates a frame (more than the kernel holds: the kept
   set, ``nms.nms_batch``) at a warm-up request's call against the plain
   loop over all of them, bit for bit, with no frame's kept set run dry;
   then 3 requests with the counts read around exactly these (the KNN
   once a request, from its device counters: it runs inside the input
   graphs' replays, where no Python runs; the NMS once; A, B, C never),
   latency, peak memory and a profiled request;
23. one ``{"kernels": [...]}`` line (with each kernel's ``op_host_us``
   beside ``host_us``), the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

Phase 2 also holds kernel A's bf16 accumulation mode against its twin at
the main path's inputs and kernel C on a unit above 48 KB of shared memory,
launches A (f32 accumulation) twice on each recorded input and requires the
same bits, and requires the same bits of the batch's last 4 frames pooled
alone; phase 6 launches A-bwd and C-bwd twice on each recorded input and
requires the same bits. With ``--a-baseline DIR`` phases 2 and 6 also time
another commit's kernel A and A-bwd (``DIR/sparse_pool_patch.cu``) on the
same inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time
import zipfile

import numpy as np
import torch

from sparse_pooling_tpu_torch import kernels, weights
from sparse_pooling_tpu_torch.configs import AreaExtents, cars_pyramid_config
from sparse_pooling_tpu_torch.configs.presets import people_pyramid_config, rcnn_cars_config
from sparse_pooling_tpu_torch.data.sparse_matrix import build_sparse_pooling_input
from sparse_pooling_tpu_torch.data.pointcloud import trim_points_to_bucket
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import detector
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, nms, sparse_pool
from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
from sparse_pooling_tpu_torch.runtime import trainer as tr
from sparse_pooling_tpu_torch.runtime.summary import read_scalars

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SM_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock, to size the pre-run spin
SPIN_MIN_S = 50e-6
FLUSH_BYTES = 128 * 2**20  # written between cold runs: over twice the 50 MB L2
BATCH, REQUESTS, N_POINTS = 8, 3, 16384
TRAIN_STEPS, FIXED_STEPS = 6, 10
RCNN_STEPS = 4
REPS = 20
HOST_BURST = 20  # calls per round of host_us: under 200 launches, far from a full queue


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps: int = REPS, warmup: int = 3, spin: bool = False,
              flush: torch.Tensor | None = None) -> float:
    """Median time of ``fn`` over ``reps`` runs, CUDA events recorded just
    before and just after the call.

    By default the events time the call as its caller sees it on an idle
    card: where the host's enqueue outlasts the device's work, that is the
    host's time. With ``spin``, the stream first spins
    (``torch.cuda._sleep``) for three times the host's enqueue time (at least
    50 µs), so the
    start event fires only once the whole run is queued and the events time
    the device's work alone (a function that synchronises inside still
    stalls). With ``flush``, the buffer is overwritten before each run so
    the inputs come from device memory, not from the L2 (L2-cold)."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    # at least SPIN_MIN_S: for a call of a few µs the events' own enqueue
    # outlasts three times the call
    cycles = int(max(3 * (time.perf_counter() - t0), SPIN_MIN_S) * SM_CYCLES_PER_S) if spin else 0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, rounds: int = 10, burst: int = HOST_BURST, warmup: int = 3) -> float:
    """Host time of one call of ``fn`` in µs: its Python, its ctypes calls
    and its enqueues. Each round times ``burst`` calls back to back, the
    host running ahead of the card as it does in a request, and divides by
    ``burst``; the median over rounds is returned. In a request that keeps
    the card waiting on the host, this is what the call costs the request.
    One call timed alone spreads by 2x on a shared host; a burst averages
    that out."""

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(burst):
            fn()
        times.append((time.perf_counter() - t0) / burst)
    torch.cuda.synchronize()
    return 1e6 * float(np.median(times))


def timings(fn, flush: torch.Tensor | None = None) -> dict:
    """``fn`` timed as a caller sees it (``ms``), as device work
    (``device_ms``), L2-cold device work (``cold_ms``, with ``flush``) and
    host enqueue (``host_us``)."""

    out = {"ms": median_ms(fn), "device_ms": median_ms(fn, spin=True), "host_us": host_us(fn)}
    if flush is not None:
        out["cold_ms"] = median_ms(fn, spin=True, flush=flush)
    return out


def timing_text(t: dict) -> str:
    cold = f", {t['cold_ms']:.4f} L2-cold device" if "cold_ms" in t else ""
    return (f"{t['ms']:.4f} ms call, {t['device_ms']:.4f} device{cold}, "
            f"host enqueue {t['host_us']:.1f} us")


def add_bound(res: dict, n_bytes: float, flops: float) -> float:
    """Accumulate the least time for one call (bytes over the memory rate or
    operations over the f32 rate, the larger) into ``res``; returns it."""

    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    res["bound_ms"] += max(by_bytes, by_ops)
    res["bytes_ms"] += by_bytes
    res["ops_ms"] += by_ops
    return max(by_bytes, by_ops)


def new_result() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "cold_ms": 0.0, "host_us": 0.0, "op_host_us": 0.0,
            "plain_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0,
            "library_host_us": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}


def add_times(res: dict, kernel: dict, plain: float, library: dict | None) -> None:
    """Accumulate one call's times into ``res``. ``library`` None: the kernel
    has no library yardstick, and its library times stay unmeasured (null)."""

    for key, value in kernel.items():
        res[key] = res.get(key, 0.0) + value
    res["plain_ms"] += plain
    if library is None:
        res["library_ms"] = res["library_device_ms"] = res["library_host_us"] = None
        return
    res["library_ms"] += library["ms"]
    res["library_device_ms"] += library["device_ms"]
    res["library_host_us"] += library["host_us"]


def op_host(res: dict, label: str, op_call, raw_call) -> None:
    """The host time of one call through the ``torch.ops.spt`` operator (the
    dispatcher, its Python kernels, the launcher) beside the raw launcher's,
    both ``host_us`` back to back; the operator's summed into
    ``res["op_host_us"]``."""

    raw, op = host_us(raw_call), host_us(op_call)
    res["op_host_us"] += op
    print(f"  {label}: host per call through the operator {op:.1f} us, the raw launcher {raw:.1f} us "
          f"(+{op - raw:.1f} us)")


@functools.cache
def custom_op_a():
    """Kernel A registered by ``torch.library.custom_op``: the higher-level
    route, which the port does not take (``kernels.OPS`` is a
    ``torch.library.Library``), timed for the record beside ``op_host``."""

    return torch.library.custom_op(
        "spt_probe::sparse_pool_patch",
        lambda src, rows, cols, vals, t: sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True),
        mutates_args=(), schema="(Tensor src, Tensor rows, Tensor cols, Tensor vals, SymInt t) -> (Tensor, Tensor)")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def recording(module, name: str, store: list):
    """Record the arguments of ``module.name`` while the block runs (the
    keyword arguments' values after the positional ones)."""

    orig = getattr(module, name)

    def rec(*args, **kwargs):
        store.append(args + tuple(kwargs.values()))
        return orig(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


COUNTED = {
    "A": sparse_pool.sparse_pool_patch_kernel,
    "B": ell_sparse_pool.sparse_pool_ell_kernel,
    "C": crop_resize.crop_and_resize_group_kernel,
    "A-bwd": sparse_pool.sparse_pool_patch_bwd_kernel,
    "C-bwd": crop_resize.crop_and_resize_group_bwd_kernel,
    "NMS": nms.greedy_nms_kernel,
}


def reset_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def make_batch(cfg, request: int, device):
    frames = [
        synthetic_frame(cfg, n_points=N_POINTS, seed=request * BATCH + i, image="noise")
        for i in range(BATCH)
    ]
    pts, mask = trim_points_to_bucket(
        np.stack([f["points"] for f in frames]), np.stack([f["points_mask"] for f in frames]),
        cfg.sparse_pool.buckets,
    )
    for f, p, m in zip(frames, pts, mask):
        f["points"], f["points_mask"] = p, m
    return frames, pl.stack_frames(frames, device=device)


def run_request(model, batch, anchors, cfg, ext):
    out = pl.forward_batch_fn(model, batch, anchors, cfg, ext)
    return out, pl.decode_batch(out, batch.ground_plane, cfg, ext)


# name substrings -> category, first match wins (kernel names on the card)
KERNEL_CATEGORIES = (
    ("hand kernels A, B, C, A-bwd, C-bwd, NMS", ("patch_pool", "group_crop", "ell_pool", "greedy_nms")),
    ("convolution (cuDNN)", ("fprop", "conv", "nhwckrsc")),
    ("matmul (cuBLAS)", ("gemm",)),
    ("gather/scatter/index", ("scatter", "gather", "index")),
    ("reduce/sort/argmax", ("reduce", "sort", "radix", "argmax", "scan")),
    ("other (elementwise, copy, fill)", ("",)),
)


def staged_request(model, batch, anchors, cfg, ext):
    """One request split at the pipeline's stages; CUDA-event times (ms) of
    input build, detector and decode."""

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    keep = torch.ones((batch.points.shape[0], 2), device=batch.points.device)
    with torch.no_grad():
        ev[0].record()
        inputs = pl.build_model_inputs_batch(batch, anchors, keep, cfg, ext)
        ev[1].record()
        out = model(inputs)
        ev[2].record()
        pl.decode_batch(out, batch.ground_plane, cfg, ext)
        ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def hand_kernel_rows(rows) -> dict:
    """Kernels A's and C's forward launches among torch.profiler rows
    (name, ms, count): {"A": [(name, ms, count), ...], "C": [...]}."""

    return {label: [r for r in rows if key in r[0] and "bwd" not in r[0]]
            for label, key in (("A", "patch_pool"), ("C", "group_crop"))}


def profile_phase(model, batch, anchors, cfg, ext, request_ms: float, label: str = "where the time goes"):
    """Where the time goes: stage times of one more request (CUDA events),
    then, from torch.profiler over another, device time by kernel category
    and name, the launch count and the device's busy share. Returns
    ``hand_kernel_rows`` of the profiled request, or None without device
    time."""

    from torch.profiler import ProfilerActivity, profile

    stages = staged_request(model, batch, anchors, cfg, ext)
    print(f"[{label}] stages of one request (CUDA events): input build "
          f"{stages[0]:.2f} ms, detector {stages[1]:.2f} ms, decode {stages[2]:.2f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        staged_request(model, batch, anchors, cfg, ext)
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    if not rows:
        print("  torch.profiler recorded no device time: kernel split not measured")
        return None
    busy = sum(r[1] for r in rows)
    print(f"  device busy {busy:.2f} ms in {sum(r[2] for r in rows)} kernel launches "
          f"({len(rows)} distinct kernels); busy share {busy / request_ms:.3f} of the "
          f"median unprofiled request latency {request_ms:.2f} ms")
    totals = {cat: [0.0, 0] for cat, _ in KERNEL_CATEGORIES}
    for name, ms, n in rows:
        cat = next(c for c, keys in KERNEL_CATEGORIES if any(k in name for k in keys))
        totals[cat][0] += ms
        totals[cat][1] += n
    for cat, (ms, n) in totals.items():
        print(f"  {ms:9.3f} ms {n:6d}x  [{cat}]")
    for name, ms, n in rows[:15]:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:110]}")
    return {**hand_kernel_rows(rows), "busy_ms": busy, "launches": sum(r[2] for r in rows)}


def compare(got, want, tol_rel: float, what: str):
    """Max abs error and its ratio to max |want|; fails above tol_rel."""

    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    check(err <= tol_rel * scale, f"{what}: max abs err {err:.3e} > {tol_rel:g} * {scale:.3g}")
    return err, err / scale


# ------------------------------------------------------------ kernel checks


def short_name(key: str) -> str:
    """A kernel's name from its torch.profiler key, without return type,
    namespace and arguments."""

    return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:48]


def kernel_parts(fn, reps: int = 10) -> list:
    """(name, µs) per call of each kernel (and memset) that ``fn`` launches,
    from torch.profiler over ``reps`` calls: the kernels' own execution,
    without the launch latency that CUDA events around a call include."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [
        (short_name(e.key), e.self_device_time_total / reps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]


def device_split(fn, reps: int = 10) -> str:
    parts = kernel_parts(fn, reps)
    if not parts:
        return "torch.profiler recorded no device time: not measured"
    return "; ".join(f"{name} {us:.2f} us" for name, us in parts)


def patch_pool_stats(rows, vals, t: int) -> str:
    """What kernel A's gather sees: the share of points with a non-zero
    weight, and the points per non-empty target row (ids in [0, B*T))."""

    b, p = rows.shape
    ids = (rows.long() + torch.arange(b, device=rows.device)[:, None] * t).reshape(-1)
    live = (vals != 0).any(-1).reshape(-1)
    counts = torch.bincount(ids[live & (ids >= 0) & (ids < b * t)], minlength=b * t)
    filled = counts[counts > 0].float()
    return (f"live points {int(live.sum())} of {b * p} ({live.float().mean().item():.4f}); "
            f"non-empty rows {filled.numel()} of {b * t}; points per non-empty row: mean "
            f"{filled.mean().item():.3f}, max {int(filled.max().item()) if filled.numel() else 0}")


def check_a(src, rows, cols, vals, t, tol: float, what: str):
    """Kernel A against its twin (pooled rows and weight sums); (max abs
    error, relative error) of the pooled rows."""

    got, got_den = sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True)
    want, want_den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, t, True)
    err, rel = compare(got, want, tol, f"{what}: kernel A {tuple(src.shape)} {src.dtype}")
    compare(got_den, want_den, 1e-5, f"{what}: kernel A {tuple(src.shape)} {src.dtype} weight sums")
    return err, rel


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


def check_a_repeats(src, rows, cols, vals, t, what: str) -> None:
    """Kernel A in its default f32 accumulation twice on the same inputs:
    the same bits (rows and weight sums); and the batch's second half pooled
    alone: the same bits as its frames in the whole batch."""

    (o1, d1), (o2, d2) = (sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True)
                          for _ in range(2))
    h = src.shape[0] // 2
    oh, dh = sparse_pool.sparse_pool_patch_kernel(src[h:], rows[h:], cols[h:], vals[h:], t, True)
    torch.cuda.synchronize()
    check(same_bits(o1, o2) and same_bits(d1, d2), f"{what}: kernel A gave other bits on a second launch")
    check(same_bits(o1[h:], oh) and same_bits(d1[h:], dh),
          f"{what}: kernel A's rows of frames {h}.. changed with the frames before them")
    print(f"  A {tuple(src.shape)}->T={t} {what}: two launches the same bits; frames {h}.. alone the "
          "same bits as in the whole batch")


def kernel_a_phase(calls, flush, baseline=None):
    """Kernel A at the two recorded main-path calls (BEV<-FV, FV<-BEV); with
    ``baseline`` (``load_baseline``) an earlier kernel A on the same
    inputs, summed into ``res["earlier_*"]``."""

    res = new_result()
    for args in calls:
        src, rows, cols, vals, t = args[:5]
        b, hs, ws, c = src.shape
        print(f"  A {tuple(src.shape)}->T={t}: {patch_pool_stats(rows, vals, t)}")
        check_a_repeats(src, rows, cols, vals, t, "main path")
        for dtype, tol in ((torch.bfloat16, 1e-4), (torch.float32, 1e-4)):
            err, rel = check_a(src.to(dtype), rows, cols, vals, t, tol, "main path")
            print(f"  A {tuple(src.shape)}->T={t} {str(dtype):15s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g} rel)")
            if dtype == src.dtype:
                res["max_abs_err"] = max(res["max_abs_err"], err)
        # accum_dtype="bfloat16": the same bf16 sums in the same (points')
        # order as the twin; a point's four products and weights sum in
        # another f32 order, which can flip one rounding
        got, got_den = sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True, "bfloat16")
        want, want_den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, t, True, "bfloat16")
        err, rel = compare(got, want, 2e-2, f"kernel A {tuple(src.shape)} bf16 accumulation")
        compare(got_den, want_den, 2e-2, f"kernel A {tuple(src.shape)} bf16 accumulation weight sums")
        same = (got == want).float().mean().item()
        bf16_ms = median_ms(lambda: sparse_pool.sparse_pool_patch_kernel(
            src, rows, cols, vals, t, True, "bfloat16"), spin=True)
        print(f"  A {tuple(src.shape)}->T={t} accum_dtype=bfloat16 max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol 2e-2 rel); {same:.6f} of the outputs equal the twin's bit for bit; "
              f"{bf16_ms:.4f} ms device (off the main path)")

        def kernel_call():
            return sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True)

        kern = timings(kernel_call, flush)
        op_host(res, f"A {tuple(src.shape)}", lambda: torch.ops.spt.sparse_pool_patch(
            src, rows, cols, vals, t, True, "float32"), kernel_call)
        custom_us = host_us(lambda: custom_op_a()(src, rows, cols, vals, t))
        print(f"  A {tuple(src.shape)}: host per call through torch.library.custom_op (not the port's "
              f"route) {custom_us:.1f} us")
        print(f"  A {tuple(src.shape)} device split per call (L2-warm): {device_split(kernel_call)}")
        if baseline is not None:
            earlier(res, f"A {tuple(src.shape)}", lambda: baseline[0](src, rows, cols, vals, t),
                    sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, t, True)[0], 1e-4, flush)
        plain = median_ms(lambda: sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, t, True))
        # library: cuSPARSE CSR x dense on the same entries, weight sum as an extra column
        p = rows.shape[1]
        boff = torch.arange(b, device=src.device)[:, None] * t
        soff = torch.arange(b, device=src.device)[:, None, None] * (hs * ws)
        csr = torch.sparse_coo_tensor(
            torch.stack([(rows.long() + boff)[..., None].expand(b, p, 4).reshape(-1),
                         (cols.long() + soff).reshape(-1)]),
            vals.reshape(-1), (b * t, b * hs * ws),
        ).coalesce().to_sparse_csr()
        dense = torch.cat([src.reshape(b * hs * ws, c).float(),
                           torch.ones(b * hs * ws, 1, device=src.device)], -1)
        lib_out = torch.sparse.mm(csr, dense)
        den = lib_out[:, c:]
        lib_pool = torch.where(den > 1e-12, lib_out[:, :c] / den.clamp_min(1e-12), 0.0)
        lib_err = (lib_pool.reshape(b, t, c) - sparse_pool.sparse_pool_patch_kernel(
            src, rows, cols, vals, t, True)[0]).abs().max().item()
        lib = timings(lambda: torch.sparse.mm(csr, dense), flush)
        # source cells the live points' windows need, each once
        live = (vals != 0).any(-1)
        touched = torch.unique((cols.long() + soff)[live]).numel()
        need = touched * c * src.element_size() + nbytes(rows, cols, vals) + b * t * c * 4
        bnd = add_bound(res, need, int(live.sum()) * (8 * c + 4))
        print(f"  A {tuple(src.shape)}: kernel {timing_text(kern)}; plain {plain:.4f} ms call; "
              f"torch.sparse.mm(CSR) {timing_text(lib)} (max diff {lib_err:.2e}); bound "
              f"{bnd:.4f} ({need / 1e6:.2f} MB, {touched} distinct source cells)")
        add_times(res, kern, plain, lib)
    return res


def window_clamped_grid(boxes, h: int, w: int, crop_hw, patch: int) -> torch.Tensor:
    """``F.grid_sample``'s grid [B, P*V*ch, cw, 2] (x, y in [-1, 1],
    align_corners) at kernel C's window-clamped sample coordinates, where
    bilinear sampling equals the crop."""

    ye, xe = crop_resize._group_coords(boxes, h, w, crop_hw, patch)  # [B, P*V, ch|cw]
    b, n, ch = ye.shape
    cw = xe.shape[-1]
    gy = (2 * ye / (h - 1) - 1)[..., :, None].expand(b, n, ch, cw)
    gx = (2 * xe / (w - 1) - 1)[..., None, :].expand(b, n, ch, cw)
    return torch.stack([gx, gy], -1).reshape(b, n * ch, cw, 2)


def kernel_c_phase(calls, flush):
    """Kernel C at the two recorded main-path calls (BEV, image). Also the
    window gather alone (rows 3 and 4 of PERF.md's table: the TPU probes
    ``make_window_slice_kernel`` and ``make_rowslab_kernel``, carried by C's
    window load), timed as the one index gather of ``crop_and_resize_group_plain``.
    Returns the summed result and one record per call of the gather alone."""

    res = new_result()
    windows = []
    for args in calls:
        img, boxes, crop_hw, patch = args[:4]
        b, h, w, c = img.shape
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
            x = img.to(dtype)
            got = crop_resize.crop_and_resize_group_kernel(x, boxes, crop_hw, patch)
            want = crop_resize.crop_and_resize_group_plain(x, boxes, crop_hw, patch)
            err, rel = compare(got, want, tol, f"kernel C {tuple(img.shape)} {dtype}")
            print(f"  C {tuple(img.shape)} patch {patch} {str(dtype):15s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g} rel)")
            if dtype == img.dtype:
                res["max_abs_err"] = max(res["max_abs_err"], err)
        f32_truth = crop_resize.crop_and_resize_group_plain(img.float(), boxes, crop_hw, patch)
        k_err = (crop_resize.crop_and_resize_group_kernel(img, boxes, crop_hw, patch).float()
                 - f32_truth).abs().max().item()
        p_err = (crop_resize.crop_and_resize_group_plain(img, boxes, crop_hw, patch).float()
                 - f32_truth).abs().max().item()
        print(f"  C {tuple(img.shape)}: vs f32 evaluation of the same bf16 inputs: kernel {k_err:.3e}, twin {p_err:.3e}")
        def kernel_call():
            return crop_resize.crop_and_resize_group_kernel(img, boxes, crop_hw, patch)

        kern = timings(kernel_call, flush)
        op_host(res, f"C {tuple(img.shape)}", lambda: torch.ops.spt.group_crop(img, boxes, *crop_hw, patch),
                kernel_call)
        plain = median_ms(lambda: crop_resize.crop_and_resize_group_plain(img, boxes, crop_hw, patch))
        # library: grid_sample (bilinear, align_corners) at the window-clamped coords
        _, pu, v, _ = boxes.shape
        ch, cw = crop_hw
        grid = window_clamped_grid(boxes, h, w, crop_hw, patch)
        nchw = img.float().permute(0, 3, 1, 2).contiguous()

        def lib_call():
            return torch.nn.functional.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="border", align_corners=True
            )

        lib_out = lib_call().permute(0, 2, 3, 1).reshape(b, pu, v, ch, cw, c)
        lib_err = (lib_out - f32_truth).abs().max().item()
        lib = timings(lib_call, flush)
        _, _, y0, x0 = crop_resize._group_starts(boxes, h, w, crop_hw, patch)
        py, px = min(patch, h), min(patch, w)
        py_idx = torch.arange(py, device=img.device)
        px_idx = torch.arange(px, device=img.device)
        pix = ((torch.arange(b, device=img.device)[:, None, None, None] * h + y0[..., None, None]
                + py_idx[:, None]) * w + x0[..., None, None] + px_idx)
        touched = torch.unique(pix).numel()
        n_out = b * pu * v * ch * cw * c
        need = touched * c * img.element_size() + nbytes(boxes) + n_out * img.element_size()
        bnd = add_bound(res, need, 8 * n_out)
        print(f"  C {tuple(img.shape)}: kernel {timing_text(kern)}; plain {plain:.4f} ms call; "
              f"grid_sample(f32) {timing_text(lib)} (max diff to f32 evaluation {lib_err:.2e}); "
              f"bound {bnd:.4f} ({need / 1e6:.2f} MB)")
        # the window gather alone: the index gather of crop_and_resize_group_plain
        flat, lin = img.reshape(b * h * w, c), pix.reshape(-1)
        gather_ms = median_ms(lambda: flat[lin])
        win_bytes = touched * c * img.element_size() + lin.numel() * c * img.element_size()
        win_bound = 1e3 * win_bytes / HBM_BYTES_PER_S
        windows.append({"view": list(img.shape), "patch": patch, "library_ms": gather_ms,
                        "bound_ms": win_bound, "bytes": win_bytes})
        print(f"  C {tuple(img.shape)} window gather alone: torch index gather {gather_ms:.4f} ms "
              f"L2-warm, bound {win_bound:.4f} ({win_bytes / 1e6:.3f} MB: {touched} distinct "
              f"pixels read, {lin.numel()} window pixels written)")
        add_times(res, kern, plain, lib)
    return res, windows


def kernel_c_wide_unit(device) -> None:
    """Kernel C where one f32 unit needs more than 48 KB of shared memory
    (C = 32, patch 20, V = 32: a 51 KB window): it must launch and agree with
    its twin to 1e-5 relative."""

    h, w, c, patch, v = 28, 32, 32, 20, 32
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, h, w, c, generator=g).to(device)
    centre = torch.rand(2, 37, 1, 2, generator=g) * torch.tensor([h + 6.0, w + 6.0]) - 3.0
    half = 0.2 + torch.rand(2, 37, v, 2, generator=g) * 3.8
    boxes = torch.cat([centre - half, centre + half], -1).contiguous().to(device)
    got = crop_resize.crop_and_resize_group_kernel(img, boxes, (3, 3), patch)
    want = crop_resize.crop_and_resize_group_plain(img, boxes, (3, 3), patch)
    err, rel = compare(got, want, 1e-5, "kernel C, a unit above 48 KB")
    print(f"  C {tuple(img.shape)} patch {patch} V {v} float32 (a {patch * patch * c * 4} B window a "
          f"unit, above 48 KB): max_abs_err {err:.3e} rel {rel:.3e} (tol 1e-5 rel)")


ELL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}  # relative to max(|twin|, 1)


def nms_phase(shapes, flush) -> dict:
    """The greedy NMS kernel (``csrc/greedy_nms.cu``) at ``shapes``, a list of
    (label, boxes, scores, max_outputs, iou_threshold) recorded from a
    request: its indices and validity equal to the plain loop's on the card
    and on the CPU, bit for bit; its times as the other kernels', the plain
    loop's call time on the card, and the bound (its inputs read and its
    outputs written once). No PyTorch call computes greedy NMS, so there is
    no library yardstick. Returns the results summed over ``shapes``."""

    res = new_result()
    for label, boxes, scores, k, thr in shapes:
        def kernel_call():
            return nms.greedy_nms_kernel(boxes, scores, k, thr)

        got = kernel_call()
        torch.cuda.synchronize()
        for dev in (boxes.device, torch.device("cpu")):
            want = nms.nms_batch_plain(boxes.to(dev), scores.to(dev), k, thr)
            check(torch.equal(got[0].cpu(), want.indices.cpu()) and torch.equal(got[1].cpu(), want.valid.cpu()),
                  f"greedy NMS {label}: picks other than the plain loop's on {dev}")
        kern = timings(kernel_call, flush)
        op_host(res, f"NMS {label}", lambda: torch.ops.spt.greedy_nms(boxes, scores, k, thr), kernel_call)
        plain = median_ms(lambda: nms.nms_batch_plain(boxes, scores, k, thr), reps=5, warmup=1)
        need = nbytes(boxes, scores, *got)
        bnd = add_bound(res, need, 0)
        valid = got[1].sum(1)
        print(f"  NMS {label} {tuple(scores.shape)} -> {k} at IoU {thr:g}: {int(valid.min())}-{int(valid.max())} "
              f"valid picks a frame, the plain loop's bit for bit (card and CPU); kernel {timing_text(kern)} "
              f"({1e3 * kern['device_ms'] / max(k, 1):.2f} us device a round); plain loop {plain:.4f} ms call; "
              f"bound {bnd:.6f} ms ({need / 1e6:.3f} MB once)")
        add_times(res, kern, plain, None)
    return res


def load_ell_baseline(path: str):
    """Build another kernel B source with the one-frame C interface
    ``ell_sparse_pool_launch(src, dtype, S, C, idx, w, T, K, out, stream)``
    (the kernel before the batched redesign) with the port's flags, and
    return a caller of it that pools a batch as one frame: the source
    flattened to [B*S, C] and each frame's indices offset by b*S."""

    import ctypes
    import hashlib

    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()[:16]
    lib_path = kernels.BUILD_DIR / f"ell_baseline-{digest}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path), path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ell_sparse_pool_launch.argtypes = [P, I, I, I, P, P, I, I, P, P]
    lib.ell_sparse_pool_launch.restype = I

    def prepare(src, idx, w):
        b, s, c = src.shape
        t, k = idx.shape[1:]
        flat_src = src.reshape(b * s, c)
        flat_idx = (idx + (torch.arange(b, device=idx.device, dtype=torch.int32) * s)[:, None, None])
        flat_idx, flat_w = flat_idx.reshape(b * t, k).contiguous(), w.reshape(b * t, k)
        dt = kernels.DTYPE_CODES[src.dtype]
        dev = src.get_device()

        def call():
            out = flat_src.new_empty((b * t, c))
            rc = lib.ell_sparse_pool_launch(flat_src.data_ptr(), dt, b * s, c, flat_idx.data_ptr(),
                                            flat_w.data_ptr(), b * t, k, out.data_ptr(),
                                            kernels.stream_ptr(dev))
            check(rc == 0, f"baseline kernel B launch failed: CUDA error {rc}")
            return out.reshape(b, t, c)

        return call

    return prepare


def ell_timing(res, src, idx, w, label, flush, baseline=None):
    """Kernel B vs its twin, cuSPARSE and (if given) the earlier kernel at one
    shape, accumulated into res: src [B, S, C] with tables [B, T, K]."""

    b, s, c = src.shape
    t, k = idx.shape[1:]
    for dtype in (torch.bfloat16, torch.float32):
        x, tol = src.to(dtype), ELL_TOL[dtype]
        err, rel = compare(ell_sparse_pool.sparse_pool_ell_kernel(x, idx, w),
                           sparse_pool.sparse_pool_ell_batch_plain(x, idx, w), tol, f"kernel B {label} {dtype}")
        print(f"  B {label} {str(dtype):15s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g} rel)")
        if dtype == src.dtype:
            res["max_abs_err"] = max(res["max_abs_err"], err)
    def kernel_call():
        return ell_sparse_pool.sparse_pool_ell_kernel(src, idx, w)

    kern = timings(kernel_call, flush)
    op_host(res, f"B {label}", lambda: torch.ops.spt.ell_sparse_pool(src, idx, w), kernel_call)
    kern["profiled_us"] = sum(us for _, us in kernel_parts(kernel_call))
    plain = median_ms(lambda: sparse_pool.sparse_pool_ell_batch_plain(src, idx, w))
    # library: cuSPARSE CSR x dense over the flattened batch (row b*T + t, column b*S + idx)
    rows = torch.arange(b * t, device=src.device).repeat_interleave(k)
    cols = (idx.long() + (torch.arange(b, device=src.device) * s)[:, None, None]).reshape(-1)
    csr = torch.sparse_coo_tensor(torch.stack([rows, cols]), w.reshape(-1), (b * t, b * s)
                                  ).coalesce().to_sparse_csr()
    dense = src.reshape(b * s, c).float()
    lib = timings(lambda: torch.sparse.mm(csr, dense), flush)
    lib_us = sum(us for _, us in kernel_parts(lambda: torch.sparse.mm(csr, dense)))
    res["library_profiled_us"] = res.get("library_profiled_us", 0.0) + lib_us
    live = (w != 0).reshape(-1)
    n_live = int(live.sum())
    touched = torch.unique(cols[live]).numel()
    need = touched * c * src.element_size() + nbytes(idx, w) + b * t * c * src.element_size()
    bnd = add_bound(res, need, 2 * n_live * c)
    taps = n_live * c * src.element_size()
    print(f"  B {label}: kernel {timing_text(kern)}, {kern['profiled_us']:.2f} us kernel execution "
          f"(torch.profiler); plain {plain:.4f} ms call; "
          f"torch.sparse.mm(CSR) {timing_text(lib)}, {lib_us:.2f} us kernel execution; "
          f"bound {bnd:.4f} ({need / 1e6:.2f} MB: "
          f"{touched} distinct source rows); live slots {n_live} of {b * t * k} "
          f"({n_live / (b * t * k):.4f}), {n_live / (b * t):.3f} a row; tap reads "
          f"{taps / 1e6:.2f} MB ({taps / need:.2f} x the bound's bytes)")
    add_times(res, kern, plain, lib)
    if baseline is not None:
        call = baseline(src, idx, w)
        err = (call().float() - sparse_pool.sparse_pool_ell_batch_plain(src, idx, w).float()
               ).abs().max().item()
        base = timings(call, flush)
        base["profiled_us"] = sum(us for _, us in kernel_parts(call))
        print(f"  B {label}: earlier kernel (one launch over the flattened batch) {timing_text(base)}, "
              f"{base['profiled_us']:.2f} us kernel execution (torch.profiler); "
              f"max abs diff to the twin {err:.2e}")
        for key, value in base.items():
            res[f"earlier_{key}"] = res.get(f"earlier_{key}", 0.0) + value
    return res


def ell_tables(frame, cfg, ext):
    """Host ELL tables (both directions) for one frame's valid points,
    filtered to the area extents and the canvas as the device builder does."""

    pts = frame["points"][frame["points_mask"]].astype(np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    keep = ((x >= ext.x_min) & (x < ext.x_max) & (y >= ext.y_min) & (y < ext.y_max)
            & (z >= ext.z_min) & (z < ext.z_max))
    pts = pts[keep]
    uvw = pts @ frame["p2"][:, :3].T + frame["p2"][:, 3]
    depth = uvw[:, 2]
    ok = depth > 1e-3
    pts, uvw = pts[ok], uvw[ok]
    s = cfg.sparse_pool.fusion_stride  # canvas bounds on the fusion lattice, as on the device
    u, v = uvw[:, 0] / uvw[:, 2] / s, uvw[:, 1] / uvw[:, 2] / s
    on = (u >= 0) & (u <= cfg.image.width // s - 1) & (v >= 0) & (v <= cfg.image.height // s - 1)
    return build_sparse_pooling_input(pts[on], frame["p2"], ext, cfg.bev, cfg.image, cfg.sparse_pool)


def parity_config():
    """The narrow cars config of tests/test_torch_model.py (f32)."""

    cfg = cars_pyramid_config().model
    r = dataclasses.replace
    return r(
        cfg,
        image=r(cfg.image, height=64, width=192),
        sparse_pool=r(cfg.sparse_pool, max_points=1024, pool_channels=4),
        anchors=r(cfg.anchors, max_anchors=512),
        backbone=r(cfg.backbone, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1),
                   out_channels=8, compute_dtype="float32"),
        rpn=r(cfg.rpn, roi_channels=4, fusion_channels=32, pre_nms_top_k=256, eval_nms_size=32),
        avod=r(cfg.avod, fc_layers=(32, 32, 32), nms_size=16),
    )


def rcnn_parity_config():
    """The narrow parity config as the rcnn family (tests/test_torch_rcnn.py,
    f32): a 16x20 fusion lattice over the narrow extents, 640 anchors."""

    cfg = rcnn_cars_config().model
    r = dataclasses.replace
    return r(
        cfg,
        image=r(cfg.image, height=64, width=192),
        sparse_pool=r(cfg.sparse_pool, max_points=1024, pool_channels=4),
        backbone=r(cfg.backbone, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1),
                   out_channels=8, compute_dtype="float32"),
        rpn=r(cfg.rpn, fusion_channels=16, pre_nms_top_k=640, eval_nms_size=32, train_nms_size=640),
        avod=r(cfg.avod, fc_layers=(32, 32, 32), nms_size=16),
    )


def card_vs_cpu_phase(cfg=None):
    """A narrow config (default the cars parity config) on the card and on
    the CPU, same weights and frames."""

    cfg = cfg or parity_config()
    ext = AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
    frames = [synthetic_frame(cfg, n_points=1024, seed=s, image="noise") for s in (0, 1)]
    outs = {}
    for dev in ("cuda", "cpu"):
        model = pl.make_model(cfg, ext, device=dev)
        weights.init_like_flax(model, seed=0)
        batch = pl.stack_frames(frames, device=dev)
        anchors = pl.static_anchor_grid(cfg, ext, device=dev)
        outs[dev] = run_request(model, batch, anchors, cfg, ext)
    (g_out, g_det), (c_out, c_det) = outs["cuda"], outs["cpu"]
    for key in ("anchor_valid",):
        check(torch.equal(g_out[key].cpu(), c_out[key]), f"card vs cpu: {key} differs")
    for key in ("objectness", "rpn_offsets"):
        err = (g_out[key].cpu() - c_out[key]).abs().max().item()
        print(f"  {cfg.architecture} parity config card vs CPU: {key} max abs diff {err:.3e} (tol 1e-4)")
        check(err <= 1e-4, f"card vs cpu: {key} differs by {err:.3e}")
    agree = (g_det["valid"].cpu() == c_det["valid"]).float().mean().item()
    print(f"  {cfg.architecture} parity config card vs CPU: detection validity agrees on {agree:.3f} of slots "
          f"(info: greedy NMS may reorder near-equal scores)")


# ------------------------------------------------------------ training


# relative to max |twin| (a step's gradients are far below 1): bf16 2**-6,
# two ulps of the largest value (kernel and twin each round an f32 sum once);
# f32 1e-5
BWD_TOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}


def compare_grad(got, want, tol_rel: float, what: str):
    """Max abs error and its ratio to max |want|, with no floor on the
    scale; fails above tol_rel, and fails if the check would also pass a
    zeroed or a halved output."""

    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    scale = want.abs().max().item()
    check(scale > 0, f"{what}: the twin's gradient is all zero, the check would say nothing")
    err = (got - want).abs().max().item()
    check(err <= tol_rel * scale, f"{what}: max abs err {err:.3e} > {tol_rel:g} * {scale:.3g}")
    for broken in (torch.zeros_like(got), 0.5 * got):
        check((broken - want).abs().max().item() > tol_rel * scale,
              f"{what}: the check would pass a zeroed or halved output")
    return err, err / scale, scale


def load_baseline(directory: str):
    """Build another commit's ``sparse_pool_patch.cu`` from ``directory``
    (with its ``common.cuh``; the C interface of the port's kernel A and
    A-bwd) with the port's flags under another library name, and return
    callers of its kernels that take the wrappers' arguments: ``(a, a_bwd)``,
    A with the weight sums, in f32 accumulation."""

    import ctypes
    import hashlib

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = f"{directory}/sparse_pool_patch.cu"
    digest = hashlib.sha256(open(path, "rb").read() + open(f"{directory}/common.cuh", "rb").read())
    lib_path = kernels.BUILD_DIR / f"baseline_sparse_pool_patch-{digest.hexdigest()[:16]}.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path), path],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"baseline sparse_pool_patch.cu did not build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for symbol, (args, ret) in kernels.SIGNATURES["sparse_pool_patch"].items():
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = args, ret

    def a(src, rows, cols, vals, t):
        b, hs, ws, c = src.shape
        p = rows.shape[1]
        scratch = rows.new_empty(lib.sparse_pool_patch_scratch_ints(b, p, t, c))
        out, den = vals.new_empty((b, t, c)), vals.new_empty((b, t))
        rc = lib.sparse_pool_patch_launch(
            src.data_ptr(), kernels.DTYPE_CODES[src.dtype], b, hs, ws, c, rows.data_ptr(),
            cols.data_ptr(), vals.data_ptr(), p, t, 1, 0, scratch.data_ptr(), out.data_ptr(),
            den.data_ptr(), kernels.stream_ptr(src.get_device()))
        check(rc == 0, f"baseline A launch failed: CUDA error {rc}")
        return out

    def a_bwd(g, rows, cols, vals, src_hw, den, dtype):
        b, t, c = g.shape
        hs, ws = src_hw
        p = rows.shape[1]
        out = g.new_empty((b, hs, ws, c), dtype=dtype)
        scratch = rows.new_empty(lib.sparse_pool_patch_bwd_scratch_ints(b, p, hs * ws, c))
        rc = lib.sparse_pool_patch_bwd_launch(
            g.data_ptr(), None if den is None else den.data_ptr(), b, t, c, rows.data_ptr(),
            cols.data_ptr(), vals.data_ptr(), p, hs, ws, kernels.DTYPE_CODES[dtype],
            scratch.data_ptr(), out.data_ptr(), kernels.stream_ptr(g.get_device()))
        check(rc == 0, f"baseline A-bwd launch failed: CUDA error {rc}")
        return out

    return a, a_bwd


def c_bwd_phases(grad, boxes, image_shape, crop_hw, patch, dtype) -> str:
    """C-bwd's device execution by phase (torch.profiler, L2-warm): the
    kernel run whole and cut short after its loads, window starts and row
    sort (stop 1) and after both contractions (stop 2,
    ``group_crop_bwd_split_launch``); the phases are the differences, the
    memset, the max |g| pass and the pass out of the fixed point their own
    launches."""

    lib = kernels.library("group_crop")
    b, h, w, c = image_shape
    p, v = boxes.shape[1:3]
    acc = grad.new_empty((b * h * w * c + 1,), dtype=torch.int64)
    out = grad.new_empty((b, h, w, c))
    dev = grad.get_device()

    def run(stop):
        def call():
            rc = lib.group_crop_bwd_split_launch(
                grad.data_ptr(), kernels.DTYPE_CODES[dtype], b, h, w, c, boxes.data_ptr(), p, v,
                int(crop_hw[0]), int(crop_hw[1]), int(patch), acc.data_ptr(), out.data_ptr(), stop,
                kernels.stream_ptr(dev))
            check(rc == 0, f"C-bwd split launch (stop {stop}) failed: CUDA error {rc}")
        return dict(kernel_parts(call))

    parts = {stop: run(stop) for stop in (0, 1, 2)}
    if not parts[0]:
        return "torch.profiler recorded no device time: not measured"

    def kernel(d):
        return sum(us for name, us in d.items() if name.startswith("group_crop_bwd"))

    k0, k1, k2 = kernel(parts[0]), kernel(parts[1]), kernel(parts[2])
    rest = "; ".join(f"{name} {us:.2f} us" for name, us in parts[0].items()
                     if not name.startswith("group_crop_bwd"))
    return (f"kernel {k0:.2f} us = load, window starts and row sort {k1:.2f} + both contractions "
            f"{k2 - k1:.2f} + global reduction (int64 atomics) {k0 - k2:.2f}; {rest}")


def earlier(res, label, call, want, tol: float, flush, held=compare) -> None:
    """An earlier kernel (``--a-baseline``) on the same inputs: its gap to the
    twin (``held``: ``compare`` or ``compare_grad``), its times and
    per-launch split, summed into ``res["earlier_*"]``."""

    err, rel = held(call(), want, tol, f"earlier kernel {label}")[:2]
    base = timings(call, flush)
    base["profiled_us"] = sum(us for _, us in kernel_parts(call))
    print(f"  {label}: earlier kernel {timing_text(base)}, {base['profiled_us']:.2f} us kernel "
          f"execution (torch.profiler: {device_split(call)}); max abs err to the twin {err:.3e} "
          f"(rel {rel:.3e})")
    for key, value in base.items():
        res[f"earlier_{key}"] = res.get(f"earlier_{key}", 0.0) + value


def check_a_bwd(g, rows, cols, vals, src_hw, den, dtype, what: str):
    """A-bwd against its twin in ``dtype``; (max abs error, relative error,
    max |twin|)."""

    got = sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, src_hw, den, dtype)
    want = sparse_pool.sparse_pool_patch_bwd_plain(g, rows, cols, vals, src_hw, den, dtype)
    return compare_grad(got, want, BWD_TOL[dtype], f"{what}: A-bwd {tuple(g.shape)} {dtype}")


def kernel_a_bwd_phase(calls, flush, baseline=None):
    """A-bwd at the two recorded calls of one training step (BEV<-FV and
    FV<-BEV: the gradients of the image and BEV mid maps), in the main path's
    bf16 and in f32, against its twin (f32 sums, rounded once); the library
    yardstick is ``torch.sparse.mm`` of the transposed CSR (weights over the
    row's weight sum) with the output gradient."""

    res = new_result()
    for args in calls:
        g, rows, cols, vals, src_hw, den, dtype = args[:7]
        b, t, c = g.shape
        hs, ws = src_hw
        label = f"A-bwd [{b},{t},{c}]->[{b},{hs},{ws},{c}]"
        for dt in (dtype, torch.float32):
            err, rel, scale = check_a_bwd(g, rows, cols, vals, src_hw, den, dt, label)
            print(f"  {label} {str(dt):15s} max_abs_err {err:.3e} rel {rel:.3e} of max |twin| "
                  f"{scale:.3e} (tol {BWD_TOL[dt]:g} rel; a zeroed or halved output fails)")
            if dt == dtype:
                res["max_abs_err"] = max(res["max_abs_err"], err)
            runs = [sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, src_hw, den, dt)
                    for _ in range(2)]
            check(same_bits(*runs), f"{label} {dt}: two launches on the same inputs differ")
        print(f"  {label}: two launches on the same inputs give the same bits, in {dtype} and float32")

        def kernel_call():
            return sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, src_hw, den, dtype)

        kern = timings(kernel_call, flush)
        op_host(res, label, lambda: torch.ops.spt.sparse_pool_patch_bwd(g, rows, cols, vals, hs, ws, den, dtype),
                kernel_call)
        print(f"  {label} device split per call (L2-warm): {device_split(kernel_call)}")
        if baseline is not None:
            earlier(res, label, lambda: baseline[1](g, rows, cols, vals, src_hw, den, dtype),
                    sparse_pool.sparse_pool_patch_bwd_plain(g, rows, cols, vals, src_hw, den, dtype),
                    BWD_TOL[dtype], flush, compare_grad)
        plain = median_ms(lambda: sparse_pool.sparse_pool_patch_bwd_plain(
            g, rows, cols, vals, src_hw, den, dtype))
        # library: cuSPARSE, the transposed matrix (source cell x target row)
        # with each weight over its row's weight sum, times g
        rid = (rows.long() + torch.arange(b, device=g.device)[:, None] * t)[..., None].expand(b, -1, 4)
        cid = cols.long() + torch.arange(b, device=g.device)[:, None, None] * (hs * ws)
        scale = torch.ones(b * t, device=g.device) if den is None else torch.where(
            den.reshape(-1) > 1e-12, 1.0 / den.reshape(-1).clamp_min(1e-12), 0.0)
        wt = vals * scale[rid.clamp(0, b * t - 1)]
        live = (wt != 0) & (rid >= 0) & (rid < b * t) & (cid >= 0) & (cid < b * hs * ws)
        csr_t = torch.sparse_coo_tensor(torch.stack([cid[live], rid[live]]), wt[live],
                                        (b * hs * ws, b * t)).coalesce().to_sparse_csr()
        g_flat = g.reshape(b * t, c)
        lib_out = torch.sparse.mm(csr_t, g_flat)
        lib_err = (lib_out.reshape(b, hs, ws, c) - sparse_pool.sparse_pool_patch_bwd_plain(
            g, rows, cols, vals, src_hw, den, torch.float32)).abs().max().item()
        lib = timings(lambda: torch.sparse.mm(csr_t, g_flat), flush)
        n_live = int(live.sum())
        rows_read = torch.unique(rid[live]).numel()
        per_cell = torch.bincount(cid[live], minlength=b * hs * ws)
        filled = per_cell[per_cell > 0].float()
        need = (rows_read * (c + (den is not None)) * 4 + nbytes(rows, cols, vals)
                + b * hs * ws * c * torch.empty((), dtype=dtype).element_size())
        bnd = add_bound(res, need, 2 * n_live * c)
        print(f"  {label}: live corner entries {n_live} of {4 * rows.numel()}; source cells "
              f"reached {filled.numel()} of {b * hs * ws}, entries per reached cell mean "
              f"{filled.mean().item():.2f} max {int(filled.max().item())}; kernel {timing_text(kern)}; "
              f"plain {plain:.4f} ms call; torch.sparse.mm(transposed CSR) {timing_text(lib)} "
              f"(max diff {lib_err:.2e}); bound {bnd:.4f} ({need / 1e6:.2f} MB: {rows_read} "
              f"distinct rows of g read)")
        add_times(res, kern, plain, lib)
    return res


def kernel_c_bwd_phase(calls, flush):
    """C-bwd at the two recorded calls of one training step (BEV and image
    RPN crops) in the main path's bf16 and in f32, against the twin summing
    in f32; the gap to the twin summing in bf16 (the reference's
    accumulator) is printed. Library yardstick: the input gradient of
    ``F.grid_sample`` (f32, bilinear, border) at the window-clamped samples,
    its backward alone (autograd over a kept graph)."""

    res = new_result()
    for args in calls:
        grad, boxes, image_shape, crop_hw, patch, dtype = args[:6]
        b, h, w, c = image_shape
        label = f"C-bwd {tuple(grad.shape)}->{tuple(image_shape)} patch {patch}"
        for dt in (dtype, torch.float32):
            gd = grad.to(dt)
            got = crop_resize.crop_and_resize_group_bwd_kernel(gd, boxes, image_shape, crop_hw, patch, dt)
            want = crop_resize.crop_and_resize_group_bwd_plain(gd, boxes, image_shape, crop_hw, patch, dt)
            err, rel, scale = compare_grad(got, want, BWD_TOL[dt], f"kernel {label} {dt}")
            print(f"  {label} {str(dt):15s} max_abs_err {err:.3e} rel {rel:.3e} of max |twin| "
                  f"{scale:.3e} (tol {BWD_TOL[dt]:g} rel; a zeroed or halved output fails)")
            if dt == dtype:
                res["max_abs_err"] = max(res["max_abs_err"], err)
        kern_out = crop_resize.crop_and_resize_group_bwd_kernel(grad, boxes, image_shape, crop_hw, patch, dtype)
        acc_twin = crop_resize.crop_and_resize_group_bwd_plain(grad, boxes, image_shape, crop_hw, patch,
                                                               dtype, crop_resize.acc_dtype(dtype))
        f32_truth = crop_resize.crop_and_resize_group_bwd_plain(grad.float(), boxes, image_shape, crop_hw,
                                                                patch, torch.float32)
        print(f"  {label}: info, against the f32 sum of the same gradients: kernel "
              f"{(kern_out.float() - f32_truth).abs().max().item():.3e}, twin summing in "
              f"{crop_resize.acc_dtype(dtype)} (the reference's accumulator) "
              f"{(acc_twin.float() - f32_truth).abs().max().item():.3e}; kernel vs that twin "
              f"{(kern_out.float() - acc_twin.float()).abs().max().item():.3e} (max |grad| "
              f"{f32_truth.abs().max().item():.3e})")

        def kernel_call():
            return crop_resize.crop_and_resize_group_bwd_kernel(grad, boxes, image_shape, crop_hw, patch, dtype)

        for dt in (dtype, torch.float32):  # two launches, the same bits
            gd = grad.to(dt)
            runs = [crop_resize.crop_and_resize_group_bwd_kernel(gd, boxes, image_shape, crop_hw, patch, dt)
                    for _ in range(2)]
            check(same_bits(*runs), f"{label} {dt}: two launches on the same inputs differ")
        print(f"  {label}: two launches on the same inputs give the same bits, in {dtype} and float32")
        kern = timings(kernel_call, flush)
        op_host(res, label, lambda: torch.ops.spt.group_crop_bwd(grad, boxes, h, w, *crop_hw, patch, dtype),
                kernel_call)
        print(f"  {label} device split per call (L2-warm): {device_split(kernel_call)}")
        print(f"  {label} phases per call (L2-warm): "
              f"{c_bwd_phases(grad, boxes, image_shape, crop_hw, patch, dtype)}")
        plain = median_ms(lambda: crop_resize.crop_and_resize_group_bwd_plain(
            grad, boxes, image_shape, crop_hw, patch, dtype))
        _, pu, v, _ = boxes.shape
        ch, cw = crop_hw
        grid = window_clamped_grid(boxes, h, w, crop_hw, patch)
        x_req = torch.zeros((b, c, h, w), device=grad.device, requires_grad=True)
        lib_fwd = torch.nn.functional.grid_sample(x_req, grid, mode="bilinear", padding_mode="border",
                                                  align_corners=True)
        g_nchw = grad.float().reshape(b, pu * v * ch, cw, c).permute(0, 3, 1, 2).contiguous()

        def lib_call():
            return torch.autograd.grad(lib_fwd, x_req, g_nchw, retain_graph=True)[0]

        lib_err = (lib_call().permute(0, 2, 3, 1) - f32_truth).abs().max().item()
        lib = timings(lib_call, flush)
        n_grad = grad.numel()
        need = n_grad * grad.element_size() + nbytes(boxes) + b * h * w * c * grad.element_size()
        bnd = add_bound(res, need, 8 * n_grad)
        print(f"  {label}: kernel {timing_text(kern)}; plain {plain:.4f} ms call; grid_sample input "
              f"gradient (f32) {timing_text(lib)} (max diff to the f32 sum {lib_err:.2e}); bound "
              f"{bnd:.4f} ({need / 1e6:.2f} MB)")
        add_times(res, kern, plain, lib)
    return res


def gt_on_cluster(frame, ext):
    """Move ``gt_boxes_3d[0]`` onto the synthetic frame's densest car-like
    cluster inside ``ext`` (above the ground, off the lateral walls), so the
    minibatches hold positives (the generator's own box lies on no points)."""

    pts = frame["points"][frame["points_mask"]]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    ok = ((y < 1.5) & (np.abs(x) < 0.45 * z + 2) & (x > ext.x_min + 2) & (x < ext.x_max - 2)
          & (z > ext.z_min + 1) & (z < ext.z_max - 2))
    cx, cz = x[ok], z[ok]
    near = (np.abs(cx[:, None] - cx[None]) < 2.0) & (np.abs(cz[:, None] - cz[None]) < 1.0)
    members = near[np.argmax(near.sum(1))]
    check(members.sum() >= 8, "no point cluster inside the extents")
    frame["gt_boxes_3d"][0] = [cx[members].mean(), 1.65, cz[members].min() + 0.8, 3.9, 1.6, 1.5, 0.0]
    return frame


def train_frames(cfg_model, ext, seeds, n_points):
    return [gt_on_cluster(synthetic_frame(cfg_model, n_points=n_points, seed=s, image="noise"), ext)
            for s in seeds]


def train_config(cfg_model, **train):
    base = cars_pyramid_config()
    return dataclasses.replace(base, model=cfg_model, train=dataclasses.replace(base.train, **train))


def finite_grads(model) -> bool:
    return all(p.grad is None or bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def profile_train_step(step, batch, gen, step_ms: float):
    """torch.profiler over one more step: device busy, launches, busy share,
    the split by category. Returns (busy ms, launches), or None without
    device time."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch, gen)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    if not rows:
        print("  torch.profiler recorded no device time: training step split not measured")
        return None
    busy = sum(r[1] for r in rows)
    print(f"  [profile] one training step: device busy {busy:.2f} ms in {sum(r[2] for r in rows)} "
          f"kernel launches ({len(rows)} distinct kernels); busy share {busy / step_ms:.3f} of the "
          f"median unprofiled step {step_ms:.2f} ms")
    totals = {cat: [0.0, 0] for cat, _ in KERNEL_CATEGORIES}
    for name, ms, n in rows:
        cat = next(c for c, keys in KERNEL_CATEGORIES if any(k in name for k in keys))
        totals[cat][0] += ms
        totals[cat][1] += n
    for cat, (ms, n) in totals.items():
        print(f"  {ms:9.3f} ms {n:6d}x  [{cat}]")
    for name, ms, n in rows[:12]:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:110]}")
    return busy, sum(r[2] for r in rows)


LOSS_KEYS = ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip")


def training_phase(device, flush, baseline=None):
    """Phase 6; returns the A-bwd and C-bwd results, their launches in the
    Trainer's 6 steps and the median CUDA-event time of steps 2-6."""

    ext = AreaExtents()
    cfg = train_config(cars_pyramid_config().model, batch_size=BATCH, checkpoint_interval=TRAIN_STEPS,
                       summary_interval=1)
    frames = train_frames(cfg.model, ext, range(100, 100 + 2 * BATCH), N_POINTS)
    dataset = tr.FrameDataset(frames, buckets=cfg.model.sparse_pool.buckets)

    # one real training step, recording the backward kernels' inputs
    model = pl.make_model(cfg.model, ext, device=device).float()
    weights.init_like_flax(model, seed=0)
    opt, sched = tr.build_optimizer(model.parameters(), cfg)
    anchors = pl.static_anchor_grid(cfg.model, ext, device=device)
    step = tr.make_train_step(model, opt, sched, anchors, cfg, ext)
    batch = pl.RawSample(*(None if a is None else torch.from_numpy(a).to(device)
                           for a in next(dataset.batches(BATCH))[0]))
    gen = torch.Generator(device=device).manual_seed(0)
    a_bwd, c_bwd = [], []
    with recording(sparse_pool, "sparse_pool_patch_bwd_kernel", a_bwd), \
            recording(crop_resize, "crop_and_resize_group_bwd_kernel", c_bwd):
        step(batch, gen)
    torch.cuda.synchronize()
    check(len(a_bwd) == 2 and len(c_bwd) == 2, "a training step did not reach A-bwd and C-bwd twice")
    print("[backward kernels vs plain] (as above; inputs of one full-width training step, batch 8)")
    res_a_bwd = kernel_a_bwd_phase(a_bwd, flush, baseline)
    res_c_bwd = kernel_c_bwd_phase(c_bwd, flush)
    del a_bwd, c_bwd

    # the Trainer: 6 steps, counts read around exactly these; its workdir
    # lies under the git-ignored build/ of the checkout
    workdir = str(kernels.BUILD_DIR.parent / "chip_smoke_train")
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = tr.Trainer(cfg, dataset, ext, workdir=workdir, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = trainer.train(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = read_scalars(f"{workdir}/summaries")
    check([r["step"] for r in recs] == list(range(1, TRAIN_STEPS + 1)), "missing step summaries")
    for r in recs:
        terms = ", ".join(f"{k} {r[k]:.5f}" for k in LOSS_KEYS)
        print(f"[training] step {r['step']}: {terms}; grad_norm {r['grad_norm']:.4f}; num_rpn_pos "
              f"{r['num_rpn_pos']:.2f} num_s2_pos {r['num_s2_pos']:.2f} (means over the batch); "
              f"lr {r['lr']:.3g}; step {r['step_ms']:.2f} ms (CUDA events) = "
              f"{1e3 * BATCH / r['step_ms']:.1f} frames/s")
        check(all(np.isfinite(r[k]) for k in (*LOSS_KEYS, "grad_norm")), f"step {r['step']}: non-finite")
    check(finite_grads(trainer.model), "non-finite gradients after the last step")
    check(sum(r["num_rpn_pos"] for r in recs) > 0, "no RPN positives sampled in training")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"[training] {TRAIN_STEPS} steps of batch {BATCH}: launches per step "
          + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
          + f"; peak memory {peak:.2f} GiB (a second model and its Adam state, kept for the "
          f"profile and the fixed batch, included)")
    for name in ("A", "C", "A-bwd", "C-bwd"):
        check(launches[name] == 2 * TRAIN_STEPS, f"kernel {name}: {launches[name]} launches in "
              f"{TRAIN_STEPS} steps, not 2 a step")
    step_ms = float(np.median([r["step_ms"] for r in recs[1:]]))
    profile_train_step(step, batch, gen, step_ms)

    # parameters moved; a fresh trainer restores step 6 exactly and takes step 7
    check(ckpt_mod.all_steps(trainer.ckpt_dir) == [TRAIN_STEPS], "no checkpoint at step 6")
    saved = ckpt_mod.restore(trainer.ckpt_dir, TRAIN_STEPS, map_location=device)
    trainer2 = tr.Trainer(cfg, dataset, ext, workdir=workdir, device=device)
    init = trainer2.init_state().model.state_dict()
    moved = sum(not torch.equal(init[k], v) for k, v in state.model.state_dict().items())
    print(f"[training] parameters changed by training: {moved} of {len(init)} tensors")
    check(moved == len(init), "some parameters did not change")
    restored = trainer2.restore_or_init()
    check(restored.step == TRAIN_STEPS, "resume did not start at step 6")
    for k, v in saved["model"].items():
        check(torch.equal(restored.model.state_dict()[k], v), f"restored parameter {k} differs")
    opt_saved, opt_now = saved["optimizer"]["state"], restored.optimizer.state_dict()["state"]
    check(opt_saved.keys() == opt_now.keys() and all(
        torch.equal(opt_saved[i][n], opt_now[i][n]) for i in opt_saved for n in ("exp_avg", "exp_avg_sq")),
        "restored optimizer state differs")
    state2 = trainer2.train(max_steps=TRAIN_STEPS + 1)
    r7 = read_scalars(f"{workdir}/summaries")[-1]
    check(state2.step == TRAIN_STEPS + 1 and r7["step"] == TRAIN_STEPS + 1, "resume did not take step 7")
    print(f"[training] resumed from step {TRAIN_STEPS}: restored parameters and Adam moments equal "
          f"the checkpoint; step 7 total {r7['total']:.5f}, grad_norm {r7['grad_norm']:.4f}, "
          f"{r7['step_ms']:.2f} ms")
    del trainer, trainer2, state, state2, restored, saved, init

    # one fixed batch: no path drop, no dropout, fixed sampling noise
    fixed_model_cfg = dataclasses.replace(
        cfg.model, path_drop=dataclasses.replace(cfg.model.path_drop, enabled=False),
        avod=dataclasses.replace(cfg.model.avod, keep_dropout_prob=1.0),
    )
    fixed_cfg = dataclasses.replace(cfg, model=fixed_model_cfg)
    weights.init_like_flax(model, seed=0)
    opt, sched = tr.build_optimizer(model.parameters(), fixed_cfg)
    step = tr.make_train_step(model, opt, sched, anchors, fixed_cfg, ext)
    g = torch.Generator(device=device).manual_seed(1)
    noise = (torch.rand((BATCH, cfg.model.anchors.max_anchors), generator=g, device=device),
             torch.rand((BATCH, cfg.model.rpn.train_nms_size), generator=g, device=device))
    totals = [float(step(batch, g, noise)["total"]) for _ in range(FIXED_STEPS + 1)]
    print(f"[training] fixed batch, {FIXED_STEPS} steps: total loss {totals[0]:.5f} before, "
          f"{totals[-1]:.5f} after; trace " + " ".join(f"{t:.4f}" for t in totals))
    check(totals[-1] < totals[0], "the loss on the fixed batch did not fall")
    shutil.rmtree(workdir)
    return res_a_bwd, res_c_bwd, launches, step_ms, peak


def train_card_vs_cpu_phase() -> None:
    """Phase 7: one training step of the narrow parity config (f32) on the
    card and on the CPU, same weights, frames and sampling noise. Every
    anchor enters the RPN's NMS and up to 256 proposals leave it, so the
    stage-2 minibatch holds positives whatever order the random weights'
    near-equal scores take (with 32 proposals of the top 256 it may hold
    none, and the stage-2 box losses and their gradients are then 0)."""

    model_cfg = parity_config()
    model_cfg = dataclasses.replace(
        model_cfg,
        rpn=dataclasses.replace(model_cfg.rpn, train_nms_size=256,
                                pre_nms_top_k=model_cfg.anchors.max_anchors),
        path_drop=dataclasses.replace(model_cfg.path_drop, enabled=False),
        avod=dataclasses.replace(model_cfg.avod, keep_dropout_prob=1.0),
    )
    cfg = train_config(model_cfg)
    ext = AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
    frames = train_frames(model_cfg, ext, (2, 3), 1024)
    g = torch.Generator().manual_seed(2)
    noise = (torch.rand((2, model_cfg.anchors.max_anchors), generator=g),
             torch.rand((2, model_cfg.rpn.train_nms_size), generator=g))
    runs = {}
    for dev in ("cuda", "cpu"):
        model = pl.make_model(model_cfg, ext, device=dev).float()
        weights.init_like_flax(model, seed=0)
        batch = pl.stack_frames(frames, device=dev)
        out = pl.forward_batch_fn(model, batch, pl.static_anchor_grid(model_cfg, ext, device=dev),
                                  model_cfg, ext, train=True)
        losses = pl.loss_batch(out, batch, model_cfg, ext, noise=tuple(n.to(dev) for n in noise))
        losses["total"].backward()
        runs[dev] = ({k: v.item() for k, v in losses.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()})
    (gl, gg), (cl, cg) = runs["cuda"], runs["cpu"]
    worst = max(abs(gl[k] - cl[k]) for k in cl)
    print(f"  training card vs CPU: loss terms max abs diff {worst:.3e} (tol 1e-4); total "
          f"{gl['total']:.6f} vs {cl['total']:.6f}; num_rpn_pos {gl['num_rpn_pos']:.1f}, "
          f"num_s2_pos {gl['num_s2_pos']:.1f}")
    check(worst <= 1e-4, f"training card vs cpu: losses differ by {worst:.3e}")
    check(cl["num_s2_pos"] > 0 and gl["num_s2_pos"] > 0 and cl["reg"] > 0,
          "training card vs cpu: no stage-2 positives, the positive branch is not compared")
    rel = max((gg[n] - cg[n]).abs().max().item() / max(cg[n].abs().max().item(), 1e-8) for n in cg)
    print(f"  training card vs CPU: every parameter's gradient within {rel:.3e} of its largest "
          f"CPU gradient (tol 1e-4: f32 sums in other orders, atomics in kernels A and C-bwd)")
    check(rel <= 1e-4, f"training card vs cpu: gradients differ by {rel:.3e} relative")


KITTI_FRAMES, KITTI_VAL, KITTI_STEPS = 36, range(16, 36), 4  # 16 training frames: 2 batches an epoch;
# 20 val frames: 2 full eval batches and a tail of 4, padded


def host_load_split(ds, ids, epoch: int) -> str:
    """One batch's host load per frame (ms), by part: the PNG decode into a
    canvas, the points (calibration, native filter, pad or subsample), the
    augmentation (``load_sample`` with it less without), the rest of
    ``load_sample``; and the whole batch as ``batches`` yields it."""

    from sparse_pooling_tpu_torch.data import calib as calib_mod
    from sparse_pooling_tpu_torch.data import pointcloud
    from sparse_pooling_tpu_torch.data.dataset import augment_seed
    from sparse_pooling_tpu_torch.native import sample_loader

    mc = ds.model_cfg
    canvas = ds.alloc_image_batch(1)[0]

    def per_frame(fn) -> float:
        t0 = time.perf_counter()
        for sid in ids:
            fn(sid)
        return 1e3 * (time.perf_counter() - t0) / len(ids)

    def points(sid):
        cal = calib_mod.read_calibration(ds._path("calib", sid, ".txt"))
        pts = sample_loader.load_points(ds._path("velodyne", sid, ".bin"), cal.velo_to_rect(), cal.p2,
                                        (375, 1242), ds.extents)
        pointcloud.pad_or_subsample(pts, mc.sparse_pool.max_points, seed=int(sid))

    decode = per_frame(lambda sid: sample_loader.decode_png_canvas(
        ds._path("image_2", sid, ".png"), mc.image.height, mc.image.width, out=canvas))
    pts = per_frame(points)
    plain = per_frame(lambda sid: ds.load_sample(sid, None, image_out=canvas))
    augmented = per_frame(lambda sid: ds.load_sample(sid, augment_seed(ds.cfg.seed, epoch, sid),
                                                     image_out=canvas))
    t0 = time.perf_counter()
    next(ds.batches(len(ids), epoch))
    whole = 1e3 * (time.perf_counter() - t0) / len(ids)
    return (f"decode {decode:.2f}, points {pts:.2f}, augmentation {augmented - plain:.2f}, rest "
            f"{plain - decode - pts:.2f}; load_sample with augmentation {augmented:.2f}; a whole batch "
            f"from batches() {whole:.2f} ms a frame (host clock, one thread, {len(ids)} frames)")


def kitti_phase(device, frame_step_ms: float):
    """Phase 8: a KITTI tree written from seeds, the native loader against
    what was drawn and its numpy twin, then ``Trainer(cfg)`` at full width
    over the tree (its own ``KittiDataset``, shuffle and augmentation,
    ``DevicePrefetcher`` of depth 2) for 4 steps, 2 epochs. Returns (cfg,
    tree root, the trainer's workdir) for phase 9, which removes both."""

    from sparse_pooling_tpu_torch.data import calib as calib_mod
    from sparse_pooling_tpu_torch.data import pointcloud, synthetic
    from sparse_pooling_tpu_torch.data.dataset import KittiDataset
    from sparse_pooling_tpu_torch.native import sample_loader

    root = str(kernels.BUILD_DIR.parent / "chip_smoke_kitti")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.write_kitti_tree(root, num_frames=KITTI_FRAMES, val_frames=KITTI_VAL)
    print(f"[kitti] wrote a tree of {KITTI_FRAMES} frames (val {KITTI_VAL.start}-{KITTI_VAL.stop - 1}) "
          f"under build/ in {time.perf_counter() - t0:.2f} s")
    base = cars_pyramid_config()
    cfg = dataclasses.replace(
        base, dataset=dataclasses.replace(base.dataset, root=root),
        train=dataclasses.replace(base.train, batch_size=BATCH, summary_interval=1, prefetch_depth=2))
    check(cfg.dataset.shuffle and cfg.dataset.aug_flip and cfg.dataset.aug_pca_jitter,
          "the cars preset no longer shuffles and augments")
    ext = AreaExtents()
    ds = KittiDataset(cfg.dataset, cfg.model, ext)
    check(len(ds) == KITTI_FRAMES - len(KITTI_VAL), f"{len(ds)} training frames")
    n_points = []
    for sid in ds.sample_ids:
        _, _, img = synthetic.make_frame(int(sid))
        canvas, (h, w) = sample_loader.decode_png_canvas(ds._path("image_2", sid, ".png"),
                                                         cfg.model.image.height, cfg.model.image.width)
        check((h, w) == img.shape[:2] and np.array_equal(canvas[:h, :w], img)
              and not canvas[h:].any() and not canvas[:, w:].any(),
              f"frame {sid}: the native decode differs from the image drawn")
        cal = calib_mod.read_calibration(ds._path("calib", sid, ".txt"))
        velo = ds._path("velodyne", sid, ".bin")
        nat = sample_loader.load_points(velo, cal.velo_to_rect(), cal.p2, (h, w), ext)
        ref = pointcloud.load_points_filtered(velo, cal, (h, w), ext)
        check(nat is not None and nat.dtype == ref.dtype and np.array_equal(nat, ref),
              f"frame {sid}: native points differ from load_points_filtered")
        n_points.append(len(nat))
    print(f"[kitti] {len(ds)} training frames: native decode equals the drawn image byte for byte, "
          f"native points equal load_points_filtered ({min(n_points)}-{max(n_points)} points a frame)")
    print(f"[kitti] host load of one batch: {host_load_split(ds, ds.epoch_ids(0)[:BATCH], 0)}")

    workdir = str(kernels.BUILD_DIR.parent / "chip_smoke_kitti_train")
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = tr.Trainer(cfg, extents=ext, workdir=workdir, device=device)
    check(isinstance(trainer.dataset, KittiDataset), "Trainer(cfg) did not build a KittiDataset")
    seen = []
    batches = trainer.dataset.batches

    def recorded(*args, **kwargs):
        for arrays, ids in batches(*args, **kwargs):
            seen.append(list(ids))
            yield arrays, ids

    trainer.dataset.batches = recorded
    torch.cuda.synchronize()
    reset_counts()
    state = trainer.train(max_steps=KITTI_STEPS)
    torch.cuda.synchronize()
    launches = counts()
    check(state.step == KITTI_STEPS, f"the KITTI trainer stopped at step {state.step}")
    recs = read_scalars(f"{workdir}/summaries")
    check([r["step"] for r in recs] == list(range(1, KITTI_STEPS + 1)), "missing KITTI step summaries")
    for r in recs:
        terms = ", ".join(f"{k} {r[k]:.5f}" for k in LOSS_KEYS)
        print(f"[kitti] step {r['step']}: {terms}; grad_norm {r['grad_norm']:.4f}; num_rpn_pos "
              f"{r['num_rpn_pos']:.2f} num_s2_pos {r['num_s2_pos']:.2f}; step {r['step_ms']:.2f} ms "
              f"(CUDA events) against the FrameDataset step's {frame_step_ms:.2f} ms (phase 6 median); "
              + ("the worker loaded the epoch's next batch during this step" if r["step"] % 2
                 else "the worker was idle (its epoch loaded)"))
        check(all(np.isfinite(r[k]) for k in (*LOSS_KEYS, "grad_norm")), f"KITTI step {r['step']}: non-finite")
    expected = [ids[i:i + BATCH] for ids in (ds.epoch_ids(0), ds.epoch_ids(1)) for i in (0, BATCH)]
    check(ds.epoch_ids(0) != ds.epoch_ids(1), "the epochs were not shuffled")
    check(seen == expected, f"ids consumed {seen}, not epoch_ids(0) then epoch_ids(1) in batches of {BATCH}")
    for name in ("A", "C", "A-bwd", "C-bwd"):
        check(launches[name] == 2 * KITTI_STEPS,
              f"kernel {name}: {launches[name]} launches in {KITTI_STEPS} KITTI steps, not 2 a step")
    t = trainer.input_timings
    kitti_ms = float(np.median([r["step_ms"] for r in recs[1:]]))
    print(f"[kitti] {KITTI_STEPS} steps of batch {BATCH} over 2 epochs; ids in epoch order; launches "
          f"per step " + ", ".join(f"{k} {v / KITTI_STEPS:g}" for k, v in launches.items()))
    print(f"[kitti] step time, median of steps 2-{KITTI_STEPS}: {kitti_ms:.2f} ms from the tree vs "
          f"{frame_step_ms:.2f} ms from frames in memory (phase 6), {kitti_ms - frame_step_ms:+.2f} ms")
    print(f"[kitti] prefetcher over {len(seen)} batches: load {t['load']:.3f} s, put {t['put']:.3f} s "
          f"(worker thread); the step waited on the queue {t['waits']} times, {t['wait']:.3f} s in all "
          f"(each epoch's first batch waits for its loader to start)")
    del trainer, state
    return cfg, root, workdir


def eval_batch_profile(ev, batch, serving, sweep_s: float, n_batches: int) -> None:
    """One eval batch (``Evaluator.eval_batch``: forward, decode, packing)
    under torch.profiler: device busy time, launches, the device's busy
    share of the sweep (n_batches such batches over its wall time), and
    kernels A's and C's device time by kernel beside those of phase 3's
    profiled serving request (``serving``, from ``hand_kernel_rows``), with
    what A's gather sees in each."""

    from torch.profiler import ProfilerActivity, profile

    a_calls = []
    with torch.inference_mode():
        with recording(sparse_pool, "sparse_pool_patch_kernel", a_calls):
            ev.eval_batch(batch)  # warm
        torch.cuda.synchronize()
        for args in a_calls:
            src, rows, _, vals, t = args[:5]
            print(f"[eval] A {tuple(src.shape)}->T={t} in the eval batch: {patch_pool_stats(rows, vals, t)}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ev.eval_batch(batch)
        end.record()
        end.synchronize()
        call_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev.eval_batch(batch)
            torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"[eval] one eval batch: {call_ms:.2f} ms (CUDA events); torch.profiler recorded no device "
              "time: busy time, launches and kernel times not measured")
        return
    busy = sum(r[1] for r in rows)
    print(f"[eval] one profiled eval batch of {BATCH}: device busy {busy:.2f} ms in {sum(r[2] for r in rows)} "
          f"kernel launches ({len(rows)} distinct kernels); the batch's call {call_ms:.2f} ms (CUDA events, "
          f"host enqueue included), busy share {busy / call_ms:.3f}; over the sweep ({n_batches} batches in "
          f"{sweep_s:.3f} s) the device is busy {n_batches * busy / (1e3 * sweep_s):.3f} of the time")
    def split(kernel_rows):
        total = sum(ms for _, ms, _ in kernel_rows)
        return (f"{total:.4f} ms in {sum(n for _, _, n in kernel_rows)} launches ("
                + "; ".join(f"{short_name(name)} {1e3 * ms:.1f} us" for name, ms, _ in sorted(kernel_rows)) + ")")

    for label, kernel_rows in hand_kernel_rows(rows).items():
        ref = "not measured" if serving is None else split(serving[label])
        print(f"[eval] kernel {label} device time (torch.profiler), the eval batch: {split(kernel_rows)}; "
              f"phase 3's profiled serving request: {ref}")


def eval_phase(device, cfg, root: str, workdir: str, serving) -> dict:
    """Phase 9: ``Evaluator`` at full width over the tree's val split (20
    frames at batch 8: the tail batch of 4 padded) through
    ``repeated_checkpoint_run``, on the checkpoint of step 4 that phase 8's
    ``Trainer`` wrote; then one profiled eval batch and the evaluation and
    inference CLIs. Returns the sweep's result; phase 19 reads the tree and
    the workdir, then removes them."""

    from sparse_pooling_tpu_torch.experiments import run_evaluation, run_inference
    from sparse_pooling_tpu_torch.runtime import metrics
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator

    ecfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, split="val"))
    check(ecfg.eval.batch_size == BATCH, f"eval batch {ecfg.eval.batch_size}, not {BATCH}")
    ext = AreaExtents()
    ev = Evaluator(ecfg, extents=ext, workdir=workdir, device=device)
    val_ids = [f"{i:06d}" for i in KITTI_VAL]
    check(ev.dataset.sample_ids == val_ids, "the val split is not frames 16-35")
    check(ckpt_mod.all_steps(ev.ckpt_dir) == [KITTI_STEPS], f"checkpoints {ckpt_mod.all_steps(ev.ckpt_dir)}")
    torch.cuda.synchronize()
    reset_counts()
    results = ev.repeated_checkpoint_run(max_wait=0)
    torch.cuda.synchronize()
    launches = counts()
    check([r["step"] for r in results] == [KITTI_STEPS], f"evaluated steps {[r['step'] for r in results]}")
    res = results[0]
    n_batches = math.ceil(len(val_ids) / BATCH)
    print(f"[eval] launches over the sweep's {n_batches} batches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for name in ("A", "C"):
        check(launches[name] == 2 * n_batches,
              f"kernel {name}: {launches[name]} launches in {n_batches} eval batches, not 2 a batch")
    check(launches["A-bwd"] == launches["C-bwd"] == launches["B"] == 0, "the sweep launched B or a backward")
    pred_dir = f"{workdir}/predictions/kitti_native_eval/{ecfg.eval.kitti_score_threshold:g}/{KITTI_STEPS}/data"
    files = sorted(f for f in os.listdir(pred_dir) if f.endswith(".txt"))
    check(files == [f"{sid}.txt" for sid in val_ids] and res["num_frames"] == len(val_ids),
          f"{len(files)} prediction files for {len(val_ids)} val frames ({res['num_frames']} counted)")
    n_rows = 0
    for name in files:
        with open(f"{pred_dir}/{name}") as f:
            n_rows += len(f.read().splitlines())
    ap = res["ap"]
    values = [v for m in ap.values() for d in m.values() for v in d.values()]
    check(all(np.isfinite(v) for v in values), "non-finite AP")
    check(res["ap_backend"] == "native_cpp", f"AP backend {res['ap_backend']}")
    oracle = metrics.evaluate_dirs(f"{ev.dataset.base}/label_2", pred_dir, ecfg.model.classes,
                                   n_points=ecfg.eval.ap_n_points)
    gap = max(abs(ap[c][m][d] - oracle[c][m][d]) for c in ap for m in ap[c] for d in ap[c][m])
    check(gap <= 1e-12, f"the native AP differs from the numpy oracle's by {gap:.3e}")
    with open(f"{workdir}/eval_{KITTI_STEPS}.json") as f:
        check(json.load(f)["ap"] == ap, "eval_<step>.json does not hold the sweep's AP")
    png = f"{workdir}/eval_summaries/images/predictions_{val_ids[0]}_{KITTI_STEPS:08d}.png"
    check(os.path.exists(png), f"the sweep wrote no prediction image {png}")
    from sparse_pooling_tpu_torch.native.sample_loader import decode_png

    drawn = decode_png(png)
    raw = decode_png(f"{ev.dataset.base}/image_2/{val_ids[0]}.png")
    check(drawn.shape == raw.shape and bool((drawn != raw).any()), "the prediction image draws nothing")
    print(f"[eval] prediction image {os.path.relpath(png, workdir)}: {drawn.shape[1]}x{drawn.shape[0]}, "
          f"{int((drawn != raw).any(-1).sum())} pixels drawn (predictions and ground truth)")
    print(f"[eval] step {KITTI_STEPS}: {res['num_frames']} val frames ({n_rows} KITTI rows at score >= "
          f"{ecfg.eval.kitti_score_threshold:g}) in {res['seconds']:.3f} s = {res['frames_per_sec']:.2f} "
          f"frames/s at batch {BATCH} with host IO (loader threads {ecfg.eval.num_workers}, prefetch 2, "
          f"inflight {ecfg.eval.inflight_batches}, readback group {ecfg.eval.readback_group}, async writer "
          f"{ecfg.eval.async_writer}; {os.cpu_count()} host cores)")
    ph, lt = ev.phases, ev.loader_timings
    print("[eval] phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in ph.items())
          + "; loader: " + ", ".join(f"{k} {v:.3f}" for k, v in lt.items()))
    print(f"[eval] native AP equals the numpy oracle (max gap {gap:.1e}, tol 1e-12); AP of a 4-step model on "
          f"synthetic frames (it proves the path, not quality): {json.dumps(ap)}")

    arrays, _ = next(ev._host_batches(BATCH))
    batch = pl.RawSample(*(None if a is None else torch.from_numpy(a).to(device) for a in arrays))
    eval_batch_profile(ev, batch, serving, res["seconds"], n_batches)
    del ev, batch

    exp, name = os.path.split(workdir)
    cfg_path = f"{root}/eval_pipeline.json"
    with open(cfg_path, "w") as f:
        f.write(dataclasses.replace(ecfg, experiments_dir=exp, checkpoint_name=name).to_json())
    common = ["--pipeline_config", cfg_path, "--dataset_root", root, "--ckpt_step", str(KITTI_STEPS),
              "--device", str(device)]
    t0 = time.perf_counter()
    (cli,) = run_evaluation.main(common)
    check(cli["num_frames"] == len(val_ids) and all(np.isfinite(v) for m in cli["ap"].values()
                                                    for d in m.values() for v in d.values()),
          "run_evaluation --ckpt_step did not evaluate the val split")
    print(f"[eval] run_evaluation --ckpt_step {KITTI_STEPS}: {cli['num_frames']} frames, "
          f"{time.perf_counter() - t0:.2f} s with the model's build")
    with open(f"{root}/val2.txt", "w") as f:
        f.write("".join(f"{sid}\n" for sid in val_ids[:2]))
    out_dir = run_inference.main(common + ["--data_split", "val2", "--out_dir", f"{root}/inference"])
    for sid in val_ids[:2]:
        with open(f"{out_dir}/{sid}.txt") as f:
            got = [line.split() for line in f]
        with open(f"{pred_dir}/{sid}.txt") as f:
            want = [line.split() for line in f]
        check(all(np.isfinite(float(v)) for row in got for v in row[3:]), f"inference {sid}: non-finite")
        same = len(got) == len(want) and all(g[0] == w[0] for g, w in zip(got, want))
        diffs = [abs(float(a) - float(b)) for g, w in zip(got, want) for a, b in zip(g[3:], w[3:])]
        gap = f"max abs difference {max(diffs, default=0.0):.3e}" if same else "the rows differ"
        print(f"[eval] run_inference {sid} at batch 1: {len(got)} rows, the sweep at batch {BATCH} {len(want)}; "
              f"{gap} (info: bf16 convolutions at another batch size)")
    return res


# ------------------------------------------------------------ the rcnn family and the people preset


def hold_a(calls, what: str) -> float:
    """Kernel A against its twin on recorded calls, in the path's dtype
    (tolerance as phase 2); its device time. Returns the max abs error."""

    worst = 0.0
    for args in calls:
        src, rows, cols, vals, t = args[:5]
        err, rel = check_a(src, rows, cols, vals, t, 1e-4, what)
        ms = median_ms(lambda: sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True), spin=True)
        print(f"  {what}: A {tuple(src.shape)}->T={t} {src.dtype} max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol 1e-4 rel); {ms:.4f} ms device; {patch_pool_stats(rows, vals, t)}")
        worst = max(worst, err)
    return worst


def serve_requests(model, requests, anchors, cfg, ext, label: str):
    """``REQUESTS`` timed requests with the counts set to 0 just before and
    read just after; finite outputs of the expected shapes. Returns (the
    launches, the request times in ms)."""

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    request_ms = []
    for r, (_, batch) in enumerate(requests):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, det = run_request(model, batch, anchors, cfg, ext)
        end.record()
        end.synchronize()
        request_ms.append(start.elapsed_time(end))
        check(all(bool(torch.isfinite(v).all()) for v in (det["boxes_3d"], det["scores"], out["cls_logits"],
                                                          out["proposals"])), f"{label} request {r}: non-finite")
        check(det["boxes_3d"].shape == (BATCH, cfg.num_classes, cfg.avod.nms_size, 7)
              and out["proposals"].shape == (BATCH, cfg.rpn.eval_nms_size, 6),
              f"{label} request {r}: detections {tuple(det['boxes_3d'].shape)}, proposals "
              f"{tuple(out['proposals'].shape)}")
        per_class = det["valid"].sum(dim=(0, 2)).tolist()
        print(f"[{label}] request {r}: {request_ms[-1]:.2f} ms for batch {BATCH} = "
              f"{1e3 * BATCH / request_ms[-1]:.1f} frames/s; valid detections per class {per_class}; "
              f"all outputs finite")
        check(sum(per_class) > 0, f"{label} request {r}: no valid detections")
    torch.cuda.synchronize()
    launches = counts()
    print(f"[{label}] launches over {len(requests)} requests: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, request_ms


def rcnn_serving_phase(device, cars_serving):
    """Phase 10: ``rcnn_cars_config()`` at full width answers ``REQUESTS``
    requests of batch 8 (the phase-3 frames); A against its twin at this
    path's inputs; where the time goes, and A's device time beside the cars
    request's (``cars_serving``: phase 3's profiled rows)."""

    cfg = rcnn_cars_config().model
    ext = AreaExtents()
    model = pl.make_model(cfg, ext, device=device)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, ext, device=device)
    check(anchors.shape[0] == 17600, f"{anchors.shape[0]} dense anchors a frame, not 88x100x2")
    requests = [make_batch(cfg, r, device) for r in range(REQUESTS)]
    a_calls, nms_calls, rpn_calls = [], [], []
    with recording(sparse_pool, "sparse_pool_patch_kernel", a_calls), \
            recording(nms, "greedy_nms_kernel", nms_calls), recording(detector, "top_k_nms_batch", rpn_calls):
        run_request(model, requests[0][1], anchors, cfg, ext)
    torch.cuda.synchronize()
    check(len(a_calls) == 2, f"an rcnn request reached kernel A {len(a_calls)} times, not twice")
    check(len(nms_calls) == 2, f"an rcnn request reached the NMS kernel {len(nms_calls)} times, not twice")
    err = hold_a(a_calls, "rcnn serving")
    del a_calls
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    print("  rcnn serving: the greedy NMS kernel at the request's two calls")
    res_nms = nms_phase([(name, *args) for name, args in zip(("rcnn RPN", "rcnn final"), nms_calls)], flush)
    # off the serving path: the RPN's training size over the same candidates,
    # and every anchor a candidate (the parity training step's NMS)
    rpn_boxes, rpn_scores, _, rpn_thr = nms_calls[0]
    all_boxes, all_scores = (t.contiguous() for t in rpn_calls[0][:2])
    print("  rcnn: the greedy NMS kernel off the serving path")
    res_nms_more = nms_phase([("rcnn training RPN", rpn_boxes, rpn_scores, cfg.rpn.train_nms_size, rpn_thr),
                              ("every anchor", all_boxes, all_scores, 256, rpn_thr)], flush)
    del nms_calls, rpn_calls, flush
    launches, request_ms = serve_requests(model, requests, anchors, cfg, ext, "rcnn serving")
    check(launches["A"] == 2 * REQUESTS, f"kernel A: {launches['A']} launches in {REQUESTS} rcnn requests")
    check(launches["NMS"] == 2 * REQUESTS, f"the NMS kernel: {launches['NMS']} launches in {REQUESTS} rcnn requests")
    check(launches["C"] == launches["B"] == launches["A-bwd"] == launches["C-bwd"] == 0,
          "an rcnn request launched B, C or a backward")
    rows = profile_phase(model, requests[0][1], anchors, cfg, ext, float(np.median(request_ms)),
                         label="rcnn serving: where the time goes")
    if rows is not None and cars_serving is not None:
        a_ms = sum(ms for _, ms, _ in rows["A"])
        cars_a = sum(ms for _, ms, _ in cars_serving["A"])
        print(f"[rcnn serving] kernel A in the profiled rcnn request {a_ms:.4f} ms of device time "
              f"({sum(n for *_, n in rows['A'])} device kernels: count, scan, place and gather a call); in "
              f"phase 3's cars request {cars_a:.4f} ms")
    return {"launches": launches, "max_abs_err": err, "request_ms": request_ms, "NMS": res_nms,
            "NMS_off_path": res_nms_more}


# ------------------------------------------------------------ ContFuse

CONTFUSE_POINTS = 20_000  # the cell's largest frames: 32,768 point slots


def contfuse_batch(cfg, request: int, device):
    """Phase 3's seeds at ``CONTFUSE_POINTS`` points, each point with an
    intensity in [0, 1) drawn from its frame's seed (0 on padding), trimmed
    to the bucket."""

    frames = []
    for i in range(BATCH):
        seed = request * BATCH + i
        f = synthetic_frame(cfg, n_points=CONTFUSE_POINTS, seed=seed, image="noise")
        intensity = np.random.default_rng([seed, 4]).random(f["points"].shape[0], dtype=np.float32)
        frames.append(dict(f, points=np.concatenate([f["points"], (intensity * f["points_mask"])[:, None]], 1)))
    pts, mask = trim_points_to_bucket(
        np.stack([f["points"] for f in frames]), np.stack([f["points_mask"] for f in frames]),
        cfg.sparse_pool.buckets,
    )
    for f, p, m in zip(frames, pts, mask):
        f["points"], f["points_mask"] = p, m
    return frames, pl.stack_frames(frames, device=device)


def knn_phase(cfg, ext, batch, flush) -> tuple:
    """The KNN kernel at the served shapes (``batch``'s frames, the four
    lattices' centres): its indices equal to the plain twin's on the card,
    no host sync, its times as the other kernels', the twin's call time and
    the bound (``benchmark/kernels/bev_knn.py``'s bytes: the points' x, z
    and validity, the queries, the tables, once). Returns (the results, the
    queries a call)."""

    from sparse_pooling_tpu_torch.models import contfuse
    from sparse_pooling_tpu_torch.ops import bev_device, knn

    res = new_result()
    cf = cfg.contfuse
    points = batch.points.to(torch.float32).contiguous()
    valid = bev_device.points_in_extents(batch.points, batch.points_mask, ext).contiguous()
    queries = contfuse.knn_centres(batch.ground_plane, cfg, ext)[0, :, 0::2].contiguous()
    area = contfuse.knn_area(cfg, ext)
    b, p = valid.shape
    q = queries.shape[0]
    check(p == 32_768 and q == 187_000, f"KNN at {p} point slots and {q} queries, not the served 32,768 and 187,000")

    def kernel_call():
        return knn.bev_knn_kernel(points, valid, queries, cf.neighbours, cf.max_distance, *area)

    def plain_call():
        return knn.bev_knn_plain(points, valid, queries, cf.neighbours, cf.max_distance, *area)

    before = knn.knn_counts()
    got = kernel_call()
    after = knn.knn_counts()
    want = plain_call()
    check(torch.equal(got, want), "KNN: indices other than the plain twin's at the served shapes")
    found = (got < p).float().mean().item()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = kernel_call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(again, want), "KNN: other indices on a second call")
    kern = timings(kernel_call, flush)
    op_host(res, "KNN", lambda: torch.ops.spt.bev_knn(points, valid, queries, cf.neighbours, cf.max_distance,
                                                      *area), kernel_call)
    plain = median_ms(plain_call, reps=3, warmup=1)
    need = b * p * (2 * 4 + 1) + q * 2 * 4 + b * q * cf.neighbours * 8
    bnd = add_bound(res, need, 0)
    examined = (after["examined"] - before["examined"]) / max(after["queries"] - before["queries"], 1)
    print(f"  KNN {b} frames x {p} slots, {q} queries, K={cf.neighbours}, {cf.max_distance:g} m: the plain "
          f"twin's indices bit for bit, no host sync; {found:.3f} of the slots hold a point; {examined:.1f} "
          f"distances examined a query; kernel {timing_text(kern)}; twin {plain:.2f} ms call; bound {bnd:.6f} ms "
          f"({need / 1e6:.1f} MB once)")
    add_times(res, kern, plain, None)
    return res, q


def contfuse_phase(device, flush) -> dict:
    """Phase 22: ``contfuse_cars_config()`` at full width: the KNN kernel
    (``knn_phase``) and the NMS's kept set at the served shapes against
    their plain twins, then ``REQUESTS`` requests of batch 8 with the counts
    read around exactly these, and a profiled one."""

    from sparse_pooling_tpu_torch.configs.presets import contfuse_cars_config
    from sparse_pooling_tpu_torch.ops import knn

    cfg = contfuse_cars_config().model
    ext = AreaExtents()
    model = pl.make_model(cfg, ext, device=device)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, ext, device=device)
    requests = [contfuse_batch(cfg, r, device) for r in range(REQUESTS)]
    res_knn, queries = knn_phase(cfg, ext, requests[0][1], flush)

    nms_calls = []
    with recording(detector, "nms_batch", nms_calls):
        run_request(model, requests[0][1], anchors, cfg, ext)
    torch.cuda.synchronize()
    check(len(nms_calls) == cfg.num_classes == 1, f"a ContFuse request made {len(nms_calls)} NMS calls, not 1")
    boxes, scores, k, thr = nms_calls[0]
    boxes, scores = boxes.contiguous(), scores.to(torch.float32).contiguous()
    n = scores.shape[1]
    check(n == 70_400 > nms.max_candidates(), f"{n} NMS candidates a frame, not 70,400 over the kernel's limit")
    short = nms.short_frames()
    got = nms.nms_batch(boxes, scores, k, thr)
    want = nms.nms_batch_plain(boxes, scores, k, thr)
    check(torch.equal(got.indices, want.indices) and torch.equal(got.valid, want.valid),
          "NMS over ContFuse's 70,400 candidates: picks other than the plain loop's over the full set")
    check(nms.short_frames() == short, "NMS over ContFuse's candidates: a frame's kept set ran dry")
    res_nms = new_result()
    kern = timings(lambda: nms.nms_batch(boxes, scores, k, thr), flush)
    plain = median_ms(lambda: nms.nms_batch_plain(boxes, scores, k, thr), reps=3, warmup=1)
    need = nbytes(boxes, scores, got.indices, got.valid)
    bnd = add_bound(res_nms, need, 0)
    valid = got.valid.sum(1)
    print(f"  NMS {tuple(scores.shape)} -> {k} at IoU {thr:g} through the kept {nms.max_candidates()}: "
          f"{int(valid.min())}-{int(valid.max())} valid picks a frame, the plain loop's over all {n} bit for "
          f"bit (card), no kept set run dry; {timing_text(kern)}; plain loop {plain:.4f} ms call; bound {bnd:.6f} "
          f"ms ({need / 1e6:.3f} MB once)")
    add_times(res_nms, kern, plain, None)
    del nms_calls, boxes, scores

    reset_counts()
    before, graphs, short = knn.knn_counts(), pl.input_graph_counts(), nms.short_frames()
    torch.cuda.reset_peak_memory_stats()
    request_ms = []
    for r, (_, batch) in enumerate(requests):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, det = run_request(model, batch, anchors, cfg, ext)
        end.record()
        end.synchronize()
        request_ms.append(start.elapsed_time(end))
        check(all(bool(torch.isfinite(v).all()) for v in (det["boxes_3d"], det["scores"], out["cls_logits"],
                                                          out["box_deltas"])), f"contfuse request {r}: non-finite")
        check(det["boxes_3d"].shape == (BATCH, 1, cfg.avod.nms_size, 7),
              f"contfuse request {r}: detections {tuple(det['boxes_3d'].shape)}")
        n_valid = int(det["valid"].sum())
        check(n_valid > 0, f"contfuse request {r}: no valid detections")
        print(f"[contfuse serving] request {r}: {request_ms[-1]:.2f} ms for batch {BATCH}; {n_valid} valid "
              f"detections; all outputs finite")
    torch.cuda.synchronize()
    launches = counts()
    after, graphs_after = knn.knn_counts(), pl.input_graph_counts()
    launches["KNN"] = (after["queries"] - before["queries"]) / (BATCH * queries)
    replays = graphs_after["replays"] - graphs["replays"]
    print(f"[contfuse serving] launches over {len(requests)} requests: "
          + ", ".join(f"{k} {v:g}" for k, v in launches.items())
          + f" (KNN from its device counters: {after['queries'] - before['queries']} queries; its Python wrapper "
            f"{after['calls'] - before['calls']} times, the input graphs replayed {replays} times); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches["KNN"] == REQUESTS, f"the KNN kernel: {launches['KNN']:g} launches in {REQUESTS} requests")
    check(launches["NMS"] == REQUESTS, f"the NMS kernel: {launches['NMS']} launches in {REQUESTS} requests")
    check(launches["A"] == launches["B"] == launches["C"] == 0, "a ContFuse request launched A, B or C")
    check(nms.short_frames() == short, "a served ContFuse request's NMS kept set ran dry")
    profile_phase(model, requests[0][1], anchors, cfg, ext, float(np.median(request_ms)),
                  label="contfuse serving: where the time goes")
    return {"launches": launches, "request_ms": request_ms, "KNN": res_knn, "NMS": res_nms}


def kernel_rows(entries) -> list:
    """The ``kernels`` line's rows: (name, source, what it replaces,
    launches, results) each."""

    return [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"],
         "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
         "library_ms": r["library_ms"], "device_ms": r["device_ms"], "cold_ms": r["cold_ms"],
         "host_us": r["host_us"], "op_host_us": r["op_host_us"], "library_device_ms": r["library_device_ms"],
         "library_host_us": r["library_host_us"]}
        for name, src, rep, n, r in entries
    ]


def contfuse_entry(contfuse: dict) -> tuple:
    """The KNN kernel's row: launches over phase 22's requests."""

    return ("bev_knn", "sparse_pooling_tpu_torch/csrc/bev_knn.cu", None, contfuse["launches"]["KNN"],
            contfuse["KNN"])


def rcnn_training_phase(device):
    """Phase 11: ``rcnn_cars_config()`` at full width, batch 8, Adam; A-bwd
    against its twin at one real step's inputs; ``Trainer.train`` for
    ``RCNN_STEPS`` steps from memory (counts read around exactly these: A
    and A-bwd twice a step, C and C-bwd never), finite losses and
    gradients, step times, peak memory, a profiled step."""

    ext = AreaExtents()
    base = rcnn_cars_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=BATCH, checkpoint_interval=RCNN_STEPS, summary_interval=1))
    frames = train_frames(cfg.model, ext, range(100, 100 + 2 * BATCH), N_POINTS)
    dataset = tr.FrameDataset(frames, buckets=cfg.model.sparse_pool.buckets)
    workdir = str(kernels.BUILD_DIR.parent / "chip_smoke_rcnn_train")
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = tr.Trainer(cfg, dataset, ext, workdir=workdir, device=device)
    state = trainer.init_state()
    step = tr.make_train_step(state.model, state.optimizer, state.scheduler, trainer.anchors_static, cfg, ext)
    batch = pl.RawSample(*(None if a is None else torch.from_numpy(a).to(device)
                           for a in next(dataset.batches(BATCH))[0]))
    a_bwd = []
    with recording(sparse_pool, "sparse_pool_patch_bwd_kernel", a_bwd):
        step(batch, state.generator)
    torch.cuda.synchronize()
    check(len(a_bwd) == 2, f"an rcnn training step reached A-bwd {len(a_bwd)} times, not twice")
    worst = 0.0
    for g, rows, cols, vals, src_hw, den, dtype in (args[:7] for args in a_bwd):
        err, rel, scale = check_a_bwd(g, rows, cols, vals, src_hw, den, dtype, "rcnn training")
        ms = median_ms(lambda: sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, src_hw, den, dtype),
                       spin=True)
        print(f"  rcnn training: A-bwd {tuple(g.shape)}->{tuple(src_hw)} {dtype} max_abs_err {err:.3e} rel "
              f"{rel:.3e} of max |twin| {scale:.3e} (tol {BWD_TOL[dtype]:g} rel); {ms:.4f} ms device")
        worst = max(worst, err)
    del a_bwd, state, step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = trainer.train(max_steps=RCNN_STEPS)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = read_scalars(f"{workdir}/summaries")
    check([r["step"] for r in recs] == list(range(1, RCNN_STEPS + 1)), "missing rcnn step summaries")
    for r in recs:
        terms = ", ".join(f"{k} {r[k]:.5f}" for k in LOSS_KEYS)
        print(f"[rcnn training] step {r['step']}: {terms}; grad_norm {r['grad_norm']:.4f}; num_rpn_pos "
              f"{r['num_rpn_pos']:.2f} num_s2_pos {r['num_s2_pos']:.2f}; step {r['step_ms']:.2f} ms (CUDA "
              f"events) = {1e3 * BATCH / r['step_ms']:.1f} frames/s")
        check(all(np.isfinite(r[k]) for k in (*LOSS_KEYS, "grad_norm")), f"rcnn step {r['step']}: non-finite")
    check(finite_grads(state.model), "non-finite rcnn gradients after the last step")
    check(sum(r["num_rpn_pos"] for r in recs) > 0, "no RPN positives sampled in rcnn training")
    print(f"[rcnn training] {RCNN_STEPS} steps of batch {BATCH}: launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()) + f"; peak memory {peak:.2f} GiB")
    for name, per_step in (("A", 2), ("A-bwd", 2), ("B", 0), ("C", 0), ("C-bwd", 0)):
        check(launches[name] == per_step * RCNN_STEPS,
              f"kernel {name}: {launches[name]} launches in {RCNN_STEPS} rcnn steps, not {per_step} a step")
    check(ckpt_mod.all_steps(trainer.ckpt_dir) == [RCNN_STEPS], "no rcnn checkpoint")
    step_ms = float(np.median([r["step_ms"] for r in recs[1:]]))
    step = tr.make_train_step(state.model, state.optimizer, state.scheduler, trainer.anchors_static, cfg, ext)
    profile_train_step(step, batch, state.generator, step_ms)
    shutil.rmtree(workdir)
    return {"launches": launches, "max_abs_err": worst, "step_ms": step_ms}


def people_phase(device):
    """Phase 13: one full-width request of ``people_pyramid_config()`` (two
    classes, a 0.3 m anchor stride over the 233x267 grid that 4x4 blocks pad,
    64 anchors a unit of kernel C): C and A against their twins at its
    inputs, then the request with the counts read around it; then one
    training step, whose C-bwd calls are held and timed. C and C-bwd take
    ``kernel_c_phase`` and ``kernel_c_bwd_phase`` (times, bound and the
    ``F.grid_sample`` yardstick at this preset's shapes)."""

    cfg = people_pyramid_config().model
    ext = AreaExtents()
    model = pl.make_model(cfg, ext, device=device)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, ext, device=device)
    requests = [make_batch(cfg, 0, device)]
    a_calls, c_calls = [], []
    with recording(sparse_pool, "sparse_pool_patch_kernel", a_calls), \
            recording(crop_resize, "crop_and_resize_group_kernel", c_calls):
        run_request(model, requests[0][1], anchors, cfg, ext)
    torch.cuda.synchronize()
    check(len(a_calls) == 2 and len(c_calls) == 2, "a people request did not reach A and C twice")
    for boxes in (args[1] for args in c_calls):
        check(boxes.shape[2] == 64, f"kernel C unit of {boxes.shape[2]} boxes, not 4*4*4")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    print("  people: kernel C at the request's inputs")
    res_c, _ = kernel_c_phase(c_calls, flush)
    worst_a = hold_a(a_calls, "people")
    del a_calls, c_calls
    launches, request_ms = serve_requests(model, requests, anchors, cfg, ext, "people")
    check(launches["A"] == 2 and launches["C"] == 2, "the people request did not launch A and C twice")
    check(launches["NMS"] == 3, f"the people request launched the NMS kernel {launches['NMS']} times, not 3 "
          "(the RPN's and one a class)")
    profile_phase(model, requests[0][1], anchors, cfg, ext, request_ms[0], label="people: where the time goes")

    # one training step of the preset (f32 parameters): C-bwd at 64 boxes a unit
    base = people_pyramid_config()
    tcfg = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=BATCH))
    model = model.float()
    opt, sched = tr.build_optimizer(model.parameters(), tcfg)
    step = tr.make_train_step(model, opt, sched, anchors, tcfg, ext)
    batch = pl.stack_frames(train_frames(cfg, ext, range(100, 100 + BATCH), N_POINTS), device=device)
    c_bwd = []
    reset_counts()
    with recording(crop_resize, "crop_and_resize_group_bwd_kernel", c_bwd):
        metrics = step(batch, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    train_launches = counts()
    check(all(bool(torch.isfinite(v)) for v in metrics.values()) and finite_grads(model),
          "people training step: non-finite losses or gradients")
    check(all(train_launches[k] == 2 for k in ("A", "C", "A-bwd", "C-bwd")),
          f"people training step launches {train_launches}, not 2 each of A, C, A-bwd and C-bwd")
    print("  people training: kernel C-bwd at the step's inputs")
    res_c_bwd = kernel_c_bwd_phase(c_bwd, flush)
    del flush
    print(f"[people] one training step of batch {BATCH}: total {float(metrics['total']):.5f}; launches "
          + ", ".join(f"{k} {v}" for k, v in train_launches.items()))
    return {"launches": launches, "train_launches": train_launches, "request_ms": request_ms,
            "max_abs_err": {"A": worst_a, "C": res_c["max_abs_err"], "C-bwd": res_c_bwd["max_abs_err"]},
            "C": res_c, "C-bwd": res_c_bwd}


# ------------------------------------------------------------ model options


def cars_option(**switches):
    """``cars_pyramid_config().model`` with ``switches``: {section: {field:
    value}}."""

    cfg = cars_pyramid_config().model
    for section, fields in switches.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **fields)})
    return cfg


def option_serving(device, label: str, cfg, n_requests: int, per_request: dict, flush=None,
                   want_units=None):
    """``n_requests`` requests of batch 8 of ``cfg`` at full width (phase 3's
    frames, seeded weights): with ``want_units`` kernel C against its twins
    at the warm-up request's inputs (``kernel_c_phase``: bf16 and f32, times,
    bound, ``F.grid_sample``) after checking its units; the launches counted
    around exactly the requests (``per_request`` of each kernel), latency,
    peak memory, a profiled request. Returns (model, anchors, record)."""

    ext = AreaExtents()
    model = pl.make_model(cfg, ext, device=device)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, ext, device=device)
    requests = [make_batch(cfg, r, device) for r in range(n_requests)]
    c_calls = []
    with recording(crop_resize, "crop_and_resize_group_kernel", c_calls):
        run_request(model, requests[0][1], anchors, cfg, ext)
    torch.cuda.synchronize()
    units = [(tuple(a[0].shape), a[1].shape[1], a[1].shape[2], a[3]) for a in c_calls]
    print(f"[{label}] anchors a frame {anchors.shape[0]} in the grid; kernel C calls (map, units a frame, "
          f"boxes a unit, patch): {units}")
    rec = {"c_units": units}
    if want_units is not None:
        check([u[1:] for u in units] == want_units, f"{label}: kernel C units {units}, not {want_units}")
        rec["C"], _ = kernel_c_phase(c_calls, flush)
    del c_calls
    launches, request_ms = serve_requests(model, requests, anchors, cfg, ext, label)
    rec.update(launches=launches, request_ms=request_ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    for name, n in per_request.items():
        check(launches[name] == n * n_requests,
              f"{label}: kernel {name} {launches[name]} launches in {n_requests} requests, not {n} a request")
    rows = profile_phase(model, requests[0][1], anchors, cfg, ext, float(np.median(request_ms)),
                         label=f"{label}: where the time goes")
    if rows is not None:
        rec.update(busy_ms=rows["busy_ms"], device_launches=rows["launches"],
                   busy_share=rows["busy_ms"] / float(np.median(request_ms)))
    return model, anchors, rec


def option_training(device, label: str, cfg, model, anchors, n_steps: int, per_step: dict, flush=None):
    """``n_steps`` timed training steps of batch 8 (f32 parameters, Adam)
    after one warm-up step whose C-bwd inputs, with ``flush``, hold C-bwd
    against its twins (``kernel_c_bwd_phase``: bf16 and f32, the same bits
    twice, times, bound, ``F.grid_sample``'s input gradient); the launches
    counted around exactly the timed steps, their losses, peak memory, a
    profiled step. Returns a record."""

    ext = AreaExtents()
    base = cars_pyramid_config()
    tcfg = dataclasses.replace(base, model=cfg, train=dataclasses.replace(base.train, batch_size=BATCH))
    model = model.float()
    opt, sched = tr.build_optimizer(model.parameters(), tcfg)
    step = tr.make_train_step(model, opt, sched, anchors, tcfg, ext)
    batch = pl.stack_frames(train_frames(cfg, ext, range(100, 100 + BATCH), N_POINTS), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    c_bwd = []
    with recording(crop_resize, "crop_and_resize_group_bwd_kernel", c_bwd):
        step(batch, gen)
    torch.cuda.synchronize()
    rec = {}
    if flush is not None:
        rec["C-bwd"] = kernel_c_bwd_phase(c_bwd, flush)
    del c_bwd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for i in range(n_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch, gen)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        check(all(bool(torch.isfinite(v)) for v in metrics.values()) and finite_grads(model),
              f"{label} step {i}: non-finite losses or gradients")
        print(f"[{label}] step {i}: " + ", ".join(f"{k} {float(metrics[k]):.5f}" for k in LOSS_KEYS)
              + f"; num_rpn_pos {float(metrics['num_rpn_pos']):.2f}; {step_ms[-1]:.2f} ms (CUDA events)")
    launches = counts()
    rec.update(launches=launches, step_ms=step_ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[{label}] {n_steps} steps of batch {BATCH}: launches " + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; peak memory {rec['peak_gib']:.2f} GiB")
    for name, n in per_step.items():
        check(launches[name] == n * n_steps,
              f"{label}: kernel {name} {launches[name]} launches in {n_steps} steps, not {n} a step")
    prof = profile_train_step(step, batch, gen, float(np.median(step_ms)))
    if prof is not None:
        rec.update(busy_ms=prof[0], device_launches=prof[1], busy_share=prof[0] / float(np.median(step_ms)))
    return rec


def step_gradients(model, cfg, batch, anchors, seed: int, noise):
    """One training step's forward and backward (no update) with the path
    drop and dropout drawn from a generator seeded ``seed``: (total loss,
    {parameter: gradient})."""

    ext = AreaExtents()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=batch.points.device).manual_seed(seed)
    out = pl.forward_batch_fn(model, batch, anchors, cfg, ext, train=True, generator=gen)
    losses = pl.loss_batch(out, batch, cfg, ext, noise=noise)
    losses["total"].backward()
    return losses["total"].item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def grad_gap(a: dict, b: dict) -> tuple:
    """Largest gap between two gradient sets relative to each parameter's
    largest gradient in ``a``: (gap, parameter)."""

    return max(((b[n] - a[n]).abs().max().item() / max(a[n].abs().max().item(), 1e-12), n) for n in a)


def options_phase(device, train_peak: float):
    """Phases 14-18, the AVOD detector's model options at full width, batch 8
    (``cars_option``): P1 the position filter (``rpn.roi_quad`` 1), P2 the
    dense grid, P3 reference-exact crops, P4 the strided stage-2 BEV crop, P5
    late and deep-concat fusion and remat. Returns one record a path."""

    out = {}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    both = {"A": 2, "C": 2, "B": 0, "A-bwd": 0, "C-bwd": 0}
    train = {"A": 2, "C": 2, "A-bwd": 2, "C-bwd": 2, "B": 0}

    print("[P1: the position filter, rpn.roi_quad 1]")
    cfg = cars_option(rpn=dict(roi_quad=1))
    model, anchors, rec = option_serving(device, "P1 serving", cfg, REQUESTS, both, flush,
                                         want_units=[(8192, 2, 8), (8192, 2, 8)])
    rec["train"] = option_training(device, "P1 training", cfg, model, anchors, 2, train, flush)
    out["P1"] = rec
    del model, anchors

    print("[P2: the dense grid, rpn.dense_grid with bev_roi_group 4]")
    cfg = cars_option(rpn=dict(dense_grid=True))
    model, anchors, rec = option_serving(device, "P2 serving", cfg, 1, both, flush,
                                         want_units=[(1400, 32, 10), (22400, 2, 8)])
    check(anchors.shape[0] == 44800, f"P2: {anchors.shape[0]} anchors a frame, not 140 x 160 x 2")
    rec["train"] = option_training(device, "P2 training", cfg, model, anchors, 1, train, flush)
    out["P2"] = rec
    del model, anchors

    print("[P3: reference-exact crops, the unpacked voxelizer, full-resolution decoders]")
    cfg = cars_option(rpn=dict(roi_quad=1, bev_roi_stride=1, img_roi_stride=1),
                      backbone=dict(decode_stride=1, space_to_depth=False))
    exact = {"A": 2, "C": 0, "B": 0, "A-bwd": 0, "C-bwd": 0}
    model, anchors, rec = option_serving(device, "P3 serving", cfg, 1, exact)
    rec["train"] = option_training(device, "P3 training", cfg, model, anchors, 1,
                                   {"A": 2, "A-bwd": 2, "C": 0, "C-bwd": 0, "B": 0})
    print(f"[P3 training] peak memory {rec['train']['peak_gib']:.2f} GiB; phase 6's (cars, decode "
          f"stride 2, a second model and its Adam state besides) {train_peak:.2f} GiB")
    # the exact crops' plain backward sums bf16 in CUDA's atomic order: the
    # spread of two steps' gradients on the same inputs (kernel A and A-bwd
    # give the same bits twice; see remat_step)
    twin = pl.make_model(cfg, AreaExtents(), device=device).float()
    twin.load_state_dict(model.state_dict())
    del model
    batch = pl.stack_frames(train_frames(cfg, AreaExtents(), range(100, 100 + BATCH), N_POINTS), device=device)
    g = torch.Generator(device=device).manual_seed(1)
    noise = (torch.rand((BATCH, cfg.anchors.max_anchors), generator=g, device=device),
             torch.rand((BATCH, cfg.rpn.train_nms_size), generator=g, device=device))
    l1, g1 = step_gradients(twin, cfg, batch, anchors, 0, noise)
    l2, g2 = step_gradients(twin, cfg, batch, anchors, 0, noise)
    spread, where = grad_gap(g1, g2)
    print(f"[P3 training] two steps on the same inputs: total {l1!r} / {l2!r}; gradients differ by up to "
          f"{spread:.3e} of a parameter's largest ({where}): the exact crops' bf16 index_add_ in the order "
          f"of CUDA's atomics (information, not a check)")
    rec["train"]["grad_spread"] = spread
    out["P3"] = rec
    del twin, anchors, batch, g1, g2

    print("[P4: the strided stage-2 BEV crop, avod.bev_roi_stride 4]")
    _, _, rec = option_serving(device, "P4 serving", cars_option(avod=dict(bev_roi_stride=4)), 1, both)
    out["P4"] = rec

    print("[P5: stage-2 fusion types and remat]")
    for name, switches in (("late", dict(fusion_type="late")),
                           ("deep_concat", dict(fusion_type="deep", fusion_method="concat"))):
        _, _, out[f"P5 {name}"] = option_serving(device, f"P5 {name} serving", cars_option(avod=switches), 1, both)
    out["P5 remat"] = remat_step(device, train_peak)
    del flush
    return out


def remat_step(device, train_peak: float) -> dict:
    """P5's remat step: the cars model with and without ``backbone.remat``
    on the same weights, batch, generator seed and sampling noise: peak
    memory of each step, the launches of the remat step, and its gradients
    against the step without it, to ``BWD_TOL[bf16]`` (2^-6) of each
    parameter's largest, beside two steps without it.

    The forward must give the same bits twice for the comparison to mean
    anything: the RPN's NMS and the minibatch sampling turn a last-bit
    difference into other proposals and other gradients. So the steps run
    under deterministic algorithms (cuDNN, the exact crops' ``index_add_``),
    with kernel A in its default f32 accumulation, which sums each row in
    the points' order."""

    ext = AreaExtents()
    plain_cfg = cars_option()
    remat_cfg = cars_option(backbone=dict(remat=True))
    batch = pl.stack_frames(train_frames(plain_cfg, ext, range(100, 100 + BATCH), N_POINTS), device=device)
    anchors = pl.static_anchor_grid(plain_cfg, ext, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    noise = (torch.rand((BATCH, plain_cfg.anchors.max_anchors), generator=g, device=device),
             torch.rand((BATCH, plain_cfg.rpn.train_nms_size), generator=g, device=device))
    models = {}
    for name, cfg in (("plain", plain_cfg), ("remat", remat_cfg)):
        models[name] = pl.make_model(cfg, ext, device=device).float()
    weights.init_like_flax(models["plain"], seed=0)
    models["remat"].load_state_dict(models["plain"].state_dict())
    rec, grads = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, cfg in (("plain", plain_cfg), ("remat", remat_cfg), ("plain again", plain_cfg)):
            model = models[name.split()[0]]
            step_gradients(model, cfg, batch, anchors, 0, noise)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            total, grads[name] = step_gradients(model, cfg, batch, anchors, 0, noise)
            end.record()
            end.synchronize()
            rec[name] = {"total": total, "ms": start.elapsed_time(end), "launches": counts(),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    finally:
        torch.use_deterministic_algorithms(False)
    for name, r in rec.items():
        print(f"[P5 remat] {name}: forward and backward {r['ms']:.2f} ms (CUDA events, no update); total "
              f"{r['total']:.6f}; peak memory {r['peak_gib']:.2f} GiB; launches "
              + ", ".join(f"{k} {v}" for k, v in r["launches"].items()))
    print(f"[P5 remat] totals: without {rec['plain']['total']!r}, with {rec['remat']['total']!r}, without "
          f"again {rec['plain again']['total']!r}")
    print(f"[P5 remat] peak memory with remat {rec['remat']['peak_gib']:.2f} GiB, without "
          f"{rec['plain']['peak_gib']:.2f} GiB; phase 6's {train_peak:.2f} GiB (a second model and its "
          f"Adam state besides)")
    check(all(rec["remat"]["launches"][k] == 2 for k in ("A", "C", "A-bwd", "C-bwd")),
          f"P5 remat step launches {rec['remat']['launches']}, not 2 each of A, C, A-bwd and C-bwd")
    gap, where = grad_gap(grads["plain"], grads["remat"])
    spread, s_where = grad_gap(grads["plain"], grads["plain again"])
    print(f"[P5 remat] gradients with remat against without: up to {gap:.3e} of a parameter's largest "
          f"({where}); two steps without remat: {spread:.3e} ({s_where}); tol {BWD_TOL[torch.bfloat16]:g}")
    check(gap <= BWD_TOL[torch.bfloat16], f"P5 remat: gradients differ by {gap:.3e} relative ({where})")
    out = {**rec, "grad_gap": gap, "grad_spread": spread}
    print("[P5 remat] the remat step profiled:")
    prof = profile_train_step(lambda b, _: step_gradients(models["remat"], remat_cfg, b, anchors, 0, noise),
                              batch, None, rec["remat"]["ms"])
    if prof is not None:
        out.update(busy_ms=prof[0], device_launches=prof[1], busy_share=prof[0] / rec["remat"]["ms"])
    return out


# ------------------------------------------------------------ 20. the learning checks' path

LEARN_STEPS = 150


def cpu_name() -> str:
    with open("/proc/cpuinfo") as f:
        names = [line.split(":", 1)[1].strip() for line in f if line.startswith("model name")]
    return f"{names[0] if names else 'unknown'} ({os.cpu_count()} cores visible)"


def host_resize_ms(root: str) -> dict:
    """The host resize (``data/pil_resize.py``) of one of the tree's
    375x1242 images onto the checks' canvases: ms a frame on this host's
    CPU, median of 20 after a warm-up (the taps are cached by size)."""

    from sparse_pooling_tpu_torch.data.pil_resize import resize_bilinear
    from sparse_pooling_tpu_torch.native import sample_loader

    img = sample_loader.decode_png(f"{root}/training/image_2/000000.png")
    out = {}
    for h, w in ((48, 160), (96, 320)):
        resize_bilinear(img, h, w)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            resize_bilinear(img, h, w)
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"{img.shape[0]}x{img.shape[1]}->{h}x{w}"] = float(np.median(times))
    print(f"[learning path] host resize, ms a frame (median of 20) on {cpu_name()}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def offline_tools(base: str, cfgs: dict) -> dict:
    """Phase 20's host tools on each 2-frame tree: ``gen_mini_batches``
    (2 spawned workers, which see no card) writes one cache a frame with an
    entry of IoU and GT index per kept anchor and class; ``show_predictions``
    draws the frames' labels as predictions (and as ground truth) into an
    image and a BEV PNG each, which must differ from the raw image and be
    the BEV lattice's size."""

    from sparse_pooling_tpu_torch.configs.config import BevConfig
    from sparse_pooling_tpu_torch.data.dataset import KittiDataset
    from sparse_pooling_tpu_torch.demos import show_predictions
    from sparse_pooling_tpu_torch.native.sample_loader import decode_png
    from sparse_pooling_tpu_torch.runtime import preprocess

    out = {}
    for scene, cfg in cfgs.items():
        root = f"{base}/{scene}"
        ds = KittiDataset(dataclasses.replace(cfg.dataset, root=root, split="train"), cfg.model)
        t0 = time.perf_counter()
        paths = preprocess.gen_mini_batches(ds, f"{root}/mini_batches", num_workers=2)
        mb_s = time.perf_counter() - t0
        check(len(paths) == len(ds), f"{scene}: {len(paths)} mini-batch caches for {len(ds)} frames")
        kept = []
        for path in paths:
            data = np.load(path)
            n = data["anchor_indices"].shape[0]
            check(n > 0 and all(data[c].shape == (n, 2) for c in cfg.model.classes),
                  f"{scene}: {os.path.basename(path)} holds {sorted(data.files)}")
            kept.append(n)
        t0 = time.perf_counter()
        show_predictions.main(["--dataset_root", root, "--pred_dir", f"{root}/training/label_2",
                               "--out_dir", f"{root}/shown", "--draw_gt"])
        show_s = time.perf_counter() - t0
        bev_hw = BevConfig().padded_hw(AreaExtents())
        for sid in ds.sample_ids:
            img = decode_png(f"{root}/shown/{sid}_image.png")
            check(bool((img != decode_png(f"{ds.base}/image_2/{sid}.png")).any()),
                  f"{scene} {sid}: show_predictions drew nothing on the image")
            check(decode_png(f"{root}/shown/{sid}_bev.png").shape[:2] == tuple(bev_hw),
                  f"{scene} {sid}: the BEV image is not the lattice's size")
        out[scene] = {"anchors_kept": kept, "gen_mini_batches_s": mb_s, "show_predictions_s": show_s}
        print(f"[learning path] {scene}: gen_mini_batches {mb_s:.2f} s ({kept} anchors kept a frame); "
              f"show_predictions {show_s:.2f} s ({2 * len(ds)} PNGs)")
    return out


def gap_phase(work: str, exp: str, results) -> dict:
    """Phase 20's IoU decomposition: ``experiments.analyze_2d_gap`` over
    each swept checkpoint's predictions of ``overfit_check`` against its
    tree's labels; a checkpoint whose AP is above 0 must match detections.
    -> {step: {"matched": n, "medians": {key: median}}}."""

    from sparse_pooling_tpu_torch.experiments import analyze_2d_gap

    gt_dir = f"{work}/kitti/training/label_2"
    out = {}
    for r in results:
        (pred_dir,) = glob.glob(f"{exp}/predictions/kitti_native_eval/*/{r['step']}/data")
        rows = analyze_2d_gap.analyze(gt_dir, pred_dir, analyze_2d_gap.calib_dir_of(gt_dir), "Car", 0.1,
                                      (375, 1242))
        ap = max(r["ap"]["Car"][m]["moderate"] for m in ("2d", "bev", "3d"))
        check(bool(rows) or ap == 0, f"analyze_2d_gap matched no detection at step {r['step']} (AP {ap:.3f})")
        medians = {k: v["median"] for k, v in analyze_2d_gap.summarize(rows).items()} if rows else {}
        out[r["step"]] = {"matched": len(rows), "medians": medians}
    keys = ("bev", "iou3d", "3d|gt_hy", "iou2d")
    print(f"[learning path] analyze_2d_gap by step (matched; medians {' / '.join(keys)}): " + "; ".join(
        f"{s}: {v['matched']}; " + " / ".join(f"{v['medians'][k]:.3f}" for k in keys if k in v["medians"])
        for s, v in out.items()))
    return out


def learning_phase(device) -> dict:
    """Phase 20: small ``cars_hard`` and ``people`` trees written by the
    port's tree writer load through ``KittiDataset`` (the cars preset's
    384x1248 canvas; ``people_check``'s 96x320 one through the host
    resize), then ``overfit_check.main`` trains the unittest preset on the
    card for ``LEARN_STEPS`` steps over its 2-frame tree (the host resize
    onto 48x160), sweeps its 5 checkpoints and scores them with the native
    evaluator: every summary's losses finite, the last checkpoint's
    parameters finite, one ``eval_<step>.json`` per checkpoint, and A and
    A-bwd launched, C and C-bwd not (the preset's exact RPN crops; counts
    read around exactly the check)."""

    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.data.dataset import KittiDataset
    from sparse_pooling_tpu_torch.experiments import overfit_check, people_check

    base = str(kernels.BUILD_DIR.parent / "chip_smoke_learning")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    trees = {}
    people_args = people_check.parse_args([])
    for scene, cfg, n_ground, n_obj in (
            ("cars_hard", cars_pyramid_config(), 12288, 4096),
            ("people", people_check.build_config(people_args, f"{base}/people", base), 1024, 192)):
        root = f"{base}/{scene}"
        synthetic.write_kitti_tree(root, num_frames=2, n_ground=n_ground, n_obj=n_obj, val_frames=(), scene=scene)
        ds = KittiDataset(dataclasses.replace(cfg.dataset, root=root, split="train"), cfg.model)
        sample = ds.load_sample("000001", augment_seed=1)
        n_gt = int(sample.gt_valid.sum())
        check(sample.image.shape == (cfg.model.image.height, cfg.model.image.width, 3) and n_gt > 0
              and bool(np.isfinite(sample.points).all()), f"the {scene} tree did not load through the port")
        trees[scene] = {"gt_boxes": n_gt, "points": int(sample.points_mask.sum()),
                        "canvas": list(sample.image.shape[:2]), "image_scale": sample.image_scale.tolist()}
        print(f"[learning path] {scene} tree: frame 000001 loads with {n_gt} boxes of {cfg.model.classes}, "
              f"{trees[scene]['points']} points, canvas {trees[scene]['canvas']}, image_scale "
              f"{trees[scene]['image_scale']}")
    trees_s = time.perf_counter() - t0
    resize_ms = host_resize_ms(f"{base}/people")
    offline = offline_tools(base, {"cars_hard": cars_pyramid_config(),
                                   "people": people_check.build_config(people_args, f"{base}/people", base)})

    work = f"{base}/overfit"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = overfit_check.main(["--steps", str(LEARN_STEPS), "--device", str(device), "--workdir", work])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    exp = f"{work}/exp/overfit_check"
    recs = read_scalars(f"{exp}/summaries")
    steps = [r["step"] for r in results]
    check(steps == [LEARN_STEPS // 5 * (k + 1) for k in range(5)], f"overfit_check swept steps {steps}")
    check(all(math.isfinite(r[k]) for r in recs for k in LOSS_KEYS if k in r),
          "overfit_check: a non-finite loss in the summaries")
    final = ckpt_mod.restore(f"{exp}/checkpoints", LEARN_STEPS)["model"]
    check(all(bool(torch.isfinite(v).all()) for v in final.values() if v.is_floating_point()),
          "overfit_check: non-finite parameters after the last step")
    missing = [s for s in steps if not os.path.exists(f"{exp}/eval_{s}.json")]
    check(not missing, f"overfit_check: eval_<step>.json missing for steps {missing}")
    # the unittest preset's exact RPN crops take no kernel C
    for name, ran in (("A", True), ("A-bwd", True), ("C", False), ("C-bwd", False), ("B", False)):
        check((launches[name] > 0) == ran, f"overfit_check launched kernel {name} {launches[name]} times")
    step_ms = [r["step_ms"] for r in recs]
    table = {r["step"]: {m: r["ap"]["Car"][m]["moderate"] for m in ("2d", "bev", "3d")} for r in results}
    print(f"[learning path] overfit_check --steps {LEARN_STEPS} on the card: {wall:.1f} s with 5 sweeps; "
          f"summaries at steps {[r['step'] for r in recs]}, total loss {recs[0]['total']:.4f} -> "
          f"{recs[-1]['total']:.4f}; step {np.median(step_ms):.2f} ms (median, CUDA events); launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    print("[learning path] moderate Car AP by step (2d / bev / 3d): " + "; ".join(
        f"{s}: {v['2d']:.3f} / {v['bev']:.3f} / {v['3d']:.3f}" for s, v in table.items()))
    t0 = time.perf_counter()
    gap = gap_phase(work, exp, results)
    gap_s = time.perf_counter() - t0
    shutil.rmtree(base)
    return {"trees": trees, "trees_s": trees_s, "host_resize_ms": resize_ms, "offline": offline,
            "gap": gap, "gap_s": gap_s,
            "overfit_steps": LEARN_STEPS,
            "overfit_s": wall,
            "step_ms": float(np.median(step_ms)), "loss_first": recs[0]["total"], "loss_last": recs[-1]["total"],
            "launches": launches, "ap_moderate": table}


# ------------------------------------------------------------ 21. the serving export

EXPORT_TOL = 1e-5  # the artifact's detections against the live pipeline's (absolute)

# A fresh process that loads the artifact and serves the saved requests: it
# imports the export module (which registers the kernels' operators) and
# reads the kernels' launch counts, no model code of its own. Prints one
# JSON line; the detections go to argv[3].
EXPORT_CHILD = """
import json, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from sparse_pooling_tpu_torch.runtime import export
from sparse_pooling_tpu_torch.models.pipeline import RawSample
from sparse_pooling_tpu_torch.ops import crop_resize, nms, sparse_pool
t0 = time.perf_counter()
fn = export.load_serving_fn(sys.argv[1])
load_s = time.perf_counter() - t0
requests = [RawSample(*(t.cuda() for t in r)) for r in torch.load(sys.argv[2])]
t0 = time.perf_counter()
fn(requests[0])
torch.cuda.synchronize()
warm_s = time.perf_counter() - t0
outs, ms, launches = [], [], []
for batch in requests:
    a0, c0 = sparse_pool.sparse_pool_patch_kernel.launches, crop_resize.crop_and_resize_group_kernel.launches
    n0 = nms.greedy_nms_kernel.launches
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    det = fn(batch)
    end.record()
    end.synchronize()
    ms.append(start.elapsed_time(end))
    launches.append({"A": sparse_pool.sparse_pool_patch_kernel.launches - a0,
                     "C": crop_resize.crop_and_resize_group_kernel.launches - c0,
                     "NMS": nms.greedy_nms_kernel.launches - n0})
    outs.append({k: v.cpu() for k, v in det.items()})
torch.save(outs, sys.argv[3])
print(json.dumps({"load_s": load_s, "warm_s": warm_s, "request_ms": ms, "launches": launches}))
"""


def detection_gap(got: dict, want: dict, what: str) -> float:
    """Largest absolute difference of two detection dicts (boxes, scores;
    the valid masks must be equal)."""

    check(sorted(got) == sorted(want), f"{what}: keys {sorted(got)} against {sorted(want)}")
    check(torch.equal(got["valid"].cpu(), want["valid"].cpu()), f"{what}: other valid detections")
    return max(float((got[k].cpu().double() - want[k].cpu().double()).abs().max()) for k in want
               if want[k].is_floating_point())


def export_phase(device, phase3_ms: list, phase3_launches: dict) -> dict:
    """Phase 21: ``runtime.export.export_inference`` of the cars preset at
    full width, batch 8, on the card (phase 3's seeded weights), saved with
    ``save_exported``; the program in this process against the live
    pipeline on phase 3's requests (their gt fields padded to the serving
    layout: points padded to ``max_points``, gt to ``MAX_GT_BOXES``, and
    timed live at that size); then a fresh process loads the file with
    ``load_serving_fn``
    and serves the 3 requests after one warm-up: each within
    ``EXPORT_TOL`` of the live detections, A and C launched twice each a
    request; latency beside phase 3's."""

    from sparse_pooling_tpu_torch.data.dataset import MAX_GT_BOXES
    from sparse_pooling_tpu_torch.runtime import export as export_mod

    cfg = cars_pyramid_config()
    ext = AreaExtents()
    model = pl.make_model(cfg.model, ext, device=device)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg.model, ext, device=device)

    def pad(t, n):
        return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1]) + t.shape[2:])], 1)

    # the serving layout: points padded to max_points (masked), gt to MAX_GT_BOXES
    p_max = cfg.model.sparse_pool.max_points
    requests = []
    for r in range(REQUESTS):
        batch = make_batch(cfg.model, r, device)[1]
        requests.append(batch._replace(
            points=pad(batch.points, p_max), points_mask=pad(batch.points_mask, p_max),
            gt_boxes_3d=pad(batch.gt_boxes_3d, MAX_GT_BOXES), gt_valid=pad(batch.gt_valid, MAX_GT_BOXES),
            gt_classes=pad(batch.gt_classes, MAX_GT_BOXES)))
    run_request(model, requests[0], anchors, cfg.model, ext)  # warm-up at the padded size
    live, live_ms = [], []
    for batch in requests:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        live.append(run_request(model, batch, anchors, cfg.model, ext)[1])
        end.record()
        end.synchronize()
        live_ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = export_mod.export_inference(cfg, model, batch_size=BATCH, extents=ext, device=device)
    export_s = time.perf_counter() - t0
    # the graph and its subgraphs (the serving path's no_grad regions)
    calls = [n for gm in ep.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
             for n in gm.graph.nodes if n.op == "call_function"]
    n_nodes = len(calls)
    ops = sorted({str(n.target) for n in calls if str(n.target).startswith("spt.")})
    check(ops == ["spt.greedy_nms.default", "spt.group_crop.default", "spt.sparse_pool_patch.default"],
          f"the exported graph calls the kernels' operators {ops}")
    module = ep.module()
    in_process = max(detection_gap(module(*batch), want, f"exported request {r} in this process")
                     for r, (batch, want) in enumerate(zip(requests, live)))
    base = str(kernels.BUILD_DIR.parent / "chip_smoke_export")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    path = f"{base}/cars_b{BATCH}.pt2"
    t0 = time.perf_counter()
    n_bytes = export_mod.save_exported(ep, path)
    save_s = time.perf_counter() - t0
    parts: dict = {}  # the file's MB by part: the graph, the weights, the constants, the example inputs
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            key = "/".join(info.filename.split("/")[1:3])
            parts[key] = parts.get(key, 0.0) + info.file_size / 1e6
    del ep, module
    torch.save([tuple(t.cpu() for t in batch) for batch in requests], f"{base}/requests.pt")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.dirname(os.path.abspath(__file__)),
                                                        os.environ.get("PYTHONPATH", "")])}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, f"{base}/requests.pt", f"{base}/out.pt"],
                          capture_output=True, text=True, env=env, timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the fresh process failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    outs = torch.load(f"{base}/out.pt")
    gaps = [detection_gap(got, want, f"served request {r}") for r, (got, want) in enumerate(zip(outs, live))]
    check(max(gaps) <= EXPORT_TOL and in_process <= EXPORT_TOL,
          f"exported detections {max(gaps):.3e} (fresh process), {in_process:.3e} (this process) from the live "
          f"pipeline's, above {EXPORT_TOL:g}")
    for r, n in enumerate(child["launches"]):
        check(n == {"A": 2, "C": 2, "NMS": 2}, f"served request {r}: launches {n}, not 2 of A, C and NMS")
    print(f"[serving export] export_inference at full width, batch {BATCH}: {export_s:.1f} s, {n_nodes} graph "
          f"calls, the kernels' operators {ops}; saved {n_bytes / 1e6:.1f} MB in "
          f"{save_s:.1f} s (" + ", ".join(f"{k} {v:.1f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])
                                           if v >= 0.05)
          + f" MB); this process's program within {in_process:.3e} of the live detections")
    print(f"[serving export] a fresh process ({child_s:.1f} s with its start): load {child['load_s']:.1f} s, "
          f"warm-up request {child['warm_s']:.2f} s; requests "
          + ", ".join(f"{ms:.2f} ms (A {n['A']}, C {n['C']}, NMS {n['NMS']})"
                      for ms, n in zip(child["request_ms"], child["launches"]))
          + "; the live pipeline on the same padded requests in this process "
          + ", ".join(f"{ms:.2f}" for ms in live_ms) + " ms; phase 3's live requests (points trimmed to their "
          "bucket) " + ", ".join(f"{ms:.2f}" for ms in phase3_ms)
          + f" ms ({', '.join(f'{k} {v // REQUESTS}' for k, v in phase3_launches.items() if v)} a request); "
          f"largest difference from the live detections {max(gaps):.3e} (tol {EXPORT_TOL:g})")
    shutil.rmtree(base)
    return {"export_s": export_s, "mb": n_bytes / 1e6, "mb_parts": parts, "graph_calls": n_nodes,
            "max_abs_diff": max(gaps),
            "max_abs_diff_in_process": in_process, "load_s": child["load_s"], "request_ms": child["request_ms"],
            "launches": child["launches"], "live_padded_ms": live_ms, "phase3_request_ms": phase3_ms}


# ------------------------------------------------------------ 19. parallel/ on the card

PAR_STEPS = 2
PAR_TOL = 2.0**-6  # losses (relative), gradients and parameters (of each tensor's largest): ranks against one process
# each tensor's step-2 update (its weights after step 2 less the shared step-1
# checkpoint's) against one process's, in relative L2: a skipped update reads
# 1, a halved one 0.5; Adam divides each element's gradient by its own size,
# so an element whose gradient sits near the bf16 noise moves by a fraction
# of lr that its last bits decide
UPDATE_TOL = 2.0**-4
COLLECTIVES = ("gloo:", "nccl:", "all_reduce", "all_gather", "allreduce", "allgather", "broadcast")


def parallel_config(model_parallel: int = 1, data_parallel: bool = True):
    """Phase 19's training config: the cars preset at full width with kernel
    A's bf16 accumulation (it sums each row in the points' order), batch 8,
    a summary and a checkpoint every step."""

    return train_config(cars_option(sparse_pool=dict(accum_dtype="bfloat16")), batch_size=BATCH,
                        checkpoint_interval=1, summary_interval=1, model_parallel=model_parallel,
                        data_parallel=data_parallel)


def phase6_frames(cfg):
    return train_frames(cfg.model, AreaExtents(), range(100, 100 + 2 * BATCH), N_POINTS)


def gather_probe(device) -> str:
    """'' if gloo's all_gather takes CUDA tensors in this PyTorch, else why
    not (the one capability the tensor-parallel phase needs and the data
    phase does not: DDP reduces with all_reduce only)."""

    import torch.distributed as dist

    x = torch.full((3,), float(dist.get_rank()), device=device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    try:
        dist.all_gather(parts, x)
    except RuntimeError as e:  # the probe: a refusal is reported, the phase does not carry on quietly
        return f"{type(e).__name__}: {e}"
    check(all(bool((p == r).all()) for r, p in enumerate(parts)), f"all_gather of CUDA tensors gave {parts}")
    return ""


def is_annotation(e) -> bool:
    """A profiler range (record_function, a collective's span) rather than a
    kernel: newer PyTorch puts such ranges on the device's timeline."""

    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag)
    return "." in e.key.split("<")[0] or "#" in e.key or e.key.startswith(("gloo:", "nccl:"))


def profile_rank_step(step, batch, gen, label: str) -> dict:
    """One step under torch.profiler: device busy (kernels and copies only),
    launches, and the collectives' spans (ms) by name."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not is_annotation(e)]
    spans = {}
    for e in events:
        if any(c in e.key.lower() for c in COLLECTIVES):
            ms = max(e.device_time_total, e.cpu_time_total) / 1e3
            spans[e.key] = max(spans.get(e.key, 0.0), ms)
    busy = sum(ms for _, ms, _ in kernels)
    print(f"[parallel {label}] rank 0, one more step profiled: device busy {busy:.2f} ms in "
          f"{sum(n for _, _, n in kernels)} kernel launches; collectives' spans (ms): "
          + (", ".join(f"{k} {v:.2f}" for k, v in sorted(spans.items())) or "none recorded"))
    return {"busy_ms": busy if kernels else None, "device_launches": sum(n for _, _, n in kernels),
            "collective_ms": spans}


def parallel_rank(rank: int, root: str, frames) -> dict:
    """One of two ranks on the one card over gloo (phase 19 b and c), with
    deterministic algorithms: the Trainer on a data-2 mesh, then on a
    model-2 mesh. Each takes step 1 from the seeded init (its gradients
    kept, gathered to the full layout), then, as a fresh trainer over a
    workdir that holds one process's step-1 checkpoint, step 2 (the mesh
    slices the single-card layout); launches counted around exactly these 2
    steps; one more step profiled (rank 0); the all-reduce of a step's
    gradients timed on the data group."""

    import torch.distributed as dist

    from sparse_pooling_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    device = torch.device("cuda", torch.cuda.current_device())
    ext = AreaExtents()
    out = {}
    for label, mp in (("data", 1), ("model", 2)):
        if label == "model":
            why = gather_probe(device)
            if why:
                out[label] = {"left_out": why}
                continue
        cfg = parallel_config(mp)
        dataset = tr.FrameDataset(frames, buckets=cfg.model.sparse_pool.buckets)
        first = tr.Trainer(cfg, dataset, ext, workdir=f"{root}/{label}", device=device)
        torch.cuda.synchronize()
        reset_counts()
        first.train(max_steps=1)
        grads = mesh_mod.gather_params({n: p.grad for n, p in first.model.named_parameters()}, first.mesh)
        grads = {n: g.float().cpu() for n, g in grads.items()} if rank == 0 else None
        second = tr.Trainer(cfg, dataset, ext, workdir=f"{root}/{label}_resumed", device=device)
        state = second.train(max_steps=PAR_STEPS)
        torch.cuda.synchronize()
        rows = mesh_mod.batch_rows(second.mesh, BATCH)
        rec = {"mesh": second.mesh.shape, "launches": counts(), "step_ms": first.step_ms + second.step_ms,
               "rows": f"{rows.start}-{rows.stop - 1}", "grads": grads}
        check(state.step == PAR_STEPS, f"rank {rank} {label}: stopped at step {state.step}")
        arrays = next(dataset.batches(BATCH, rows=rows))[0]
        batch = pl.RawSample(*(None if a is None else torch.from_numpy(a).to(device) for a in arrays))
        if rank == 0:
            rec.update(profile_rank_step(second.train_step, batch, second.generator, label))
        else:
            second.train_step(batch, second.generator)
        torch.cuda.synchronize()
        if second.mesh.n_data > 1:
            n = sum(p.numel() for p in second.model.parameters())
            buf = torch.ones(n, device=device)
            times = []
            for _ in range(6):
                dist.barrier(group=second.mesh.data_group)
                t0 = time.perf_counter()
                dist.all_reduce(buf, group=second.mesh.data_group)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            rec["all_reduce_ms"], rec["all_reduce_mb"] = float(np.median(times[1:])), 4 * n / 2**20
        out[label] = rec
        del first, second, state
    return out


def evaluate_rank(rank: int, ecfg, workdir: str) -> dict:
    """One of two evaluation ranks on the one card over gloo (phase 19 d),
    under deterministic algorithms: the sweep of the step-4 checkpoint twice (the first pays the fresh
    process's warm-up); launches counted around the second."""

    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    device = torch.device("cuda", torch.cuda.current_device())
    ev = Evaluator(ecfg, extents=AreaExtents(), workdir=workdir, device=device)
    cold = ev.run_checkpoint_once(KITTI_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    res = ev.run_checkpoint_once(KITTI_STEPS)
    torch.cuda.synchronize()
    return {"result": res, "cold": cold, "launches": counts(), "mesh": ev.mesh.shape, "phases": dict(ev.phases)}


def read_rows(pred_dir: str) -> dict:
    rows = {}
    for name in sorted(os.listdir(pred_dir)):
        with open(f"{pred_dir}/{name}") as f:
            parts = [line.split() for line in f if line.strip()]
        rows[name] = ([p[0] for p in parts], np.array([[float(v) for v in p[3:]] for p in parts]).reshape(-1, 13))
    return rows


def rows_gap(got: dict, want: dict) -> tuple:
    """(files and classes equal, largest 2D box gap in px, largest gap of the
    3D box and score) between two prediction directories' rows."""

    same = sorted(got) == sorted(want) and all(got[k][0] == want[k][0] for k in want)
    if not same:
        return False, float("inf"), float("inf")
    gap2d = max((float(np.abs(got[k][1][:, 1:5] - want[k][1][:, 1:5]).max()) for k in want if len(want[k][0])),
                default=0.0)
    cols = [0, *range(5, 13)]
    gap3d = max((float(np.abs(got[k][1][:, cols] - want[k][1][:, cols]).max()) for k in want if len(want[k][0])),
                default=0.0)
    return True, gap2d, gap3d


def tensor_gap(got: dict, want: dict) -> tuple:
    """The largest of |got - want| over each tensor's largest |want|, and
    its tensor's name."""

    check(got.keys() == want.keys(), "tensor names differ")
    return max((float((got[k].float() - v.float()).abs().max()) / max(float(v.abs().max()), 1e-30), k)
               for k, v in want.items())


def multihost_phase(cfg) -> None:
    """19a: ``run_training --multihost`` as a subprocess, world 1 over NCCL,
    on phase 8's tree for 2 steps."""

    from sparse_pooling_tpu_torch.parallel import launch

    exp = str(kernels.BUILD_DIR.parent / "chip_smoke_multihost")
    shutil.rmtree(exp, ignore_errors=True)
    os.makedirs(exp)
    mcfg = dataclasses.replace(cfg, experiments_dir=exp, checkpoint_name="multihost")
    path = f"{exp}/pipeline.json"
    with open(path, "w") as f:
        f.write(mcfg.to_json())
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(launch.free_port()), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0", PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sparse_pooling_tpu_torch.experiments.run_training", "--multihost",
                           "--pipeline_config", path, "--max_steps", str(PAR_STEPS)],
                          env=env, cwd=here, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("[run_training]", "[trainer]"))]
    for ln in lines:
        print(f"  | {ln}")
    check(proc.returncode == 0, f"run_training --multihost exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                f"{proc.stderr[-3000:]}")
    check("process 0/1 (nccl) on cuda:0" in proc.stdout, "run_training --multihost did not report process 0/1 on nccl")
    check("all_reduce of ones = 1" in proc.stdout, "the NCCL all_reduce of a CUDA tensor did not give 1")
    check("[trainer] mesh" not in proc.stdout, "a world of 1 built a mesh (auto_mesh gives None at one rank)")
    workdir = f"{exp}/multihost"
    recs = read_scalars(f"{workdir}/summaries")
    check([r["step"] for r in recs] == list(range(1, PAR_STEPS + 1)), f"steps {[r['step'] for r in recs]}")
    check(all(np.isfinite(r[k]) for r in recs for k in (*LOSS_KEYS, "grad_norm")), "non-finite multihost losses")
    check(ckpt_mod.all_steps(f"{workdir}/checkpoints") == [PAR_STEPS], "no multihost checkpoint at step 2")
    print(f"[parallel a] run_training --multihost, world 1 over NCCL: process_info and the all_reduce of a CUDA "
          f"tensor as printed; auto_mesh gave None (single-card path); {PAR_STEPS} steps over the KITTI tree, "
          f"totals {[round(r['total'], 5) for r in recs]}, step times "
          f"{[round(r['step_ms'], 2) for r in recs]} ms (CUDA events); checkpoint {PAR_STEPS}; "
          f"{wall:.1f} s with the process's start")
    shutil.rmtree(exp)


def training_parallel_phase(device, frame_step_ms: float) -> dict:
    """19b and 19c: two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), data 2 then model 2, against one process: step 1
    from the same seeded init (losses, every gradient), step 2 from the same
    step-1 checkpoint, one process's (losses, every parameter after it)."""

    from sparse_pooling_tpu_torch.parallel import launch

    ext = AreaExtents()
    root = str(kernels.BUILD_DIR.parent / "chip_smoke_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # one process, under the same deterministic algorithms: step 1, its
    # gradients, then step 2 resumed from its step-1 checkpoint
    cfg1 = parallel_config(data_parallel=False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        frames = phase6_frames(cfg1)
        dataset = tr.FrameDataset(frames, buckets=cfg1.model.sparse_pool.buckets)
        single = tr.Trainer(cfg1, dataset, ext, workdir=f"{root}/single", device=device)
        single.train(max_steps=1)
        ref_grads = {n: p.grad.float().cpu() for n, p in single.model.named_parameters()}
        start = ckpt_mod.restore(f"{root}/single/checkpoints", 1, map_location="cpu")["model"]
        for label in ("data", "model"):
            shutil.copytree(f"{root}/single/checkpoints/1", f"{root}/{label}_resumed/checkpoints/1")
        single = tr.Trainer(cfg1, dataset, ext, workdir=f"{root}/single", device=device)
        single.train(max_steps=PAR_STEPS)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    ref = read_scalars(f"{root}/single/summaries")
    ref_params = ckpt_mod.restore(f"{root}/single/checkpoints", PAR_STEPS, map_location="cpu")["model"]
    t0 = time.perf_counter()
    ranks = launch.spawn(parallel_rank, 2, (root, frames), backend="gloo", device=device.type,
                         timeout_s=600)
    wall = time.perf_counter() - t0
    out = {"single_step_ms": [r["step_ms"] for r in ref], "wall_s": wall}
    for label in ("data", "model"):
        if "left_out" in ranks[0][label]:
            print(f"[parallel c] the card phase of tensor parallelism is left out: gloo's all_gather refused "
                  f"CUDA tensors ({ranks[0][label]['left_out']}); the CPU tests hold it")
            out[label] = {"left_out": ranks[0][label]["left_out"]}
            continue
        tag = "b" if label == "data" else "c"
        recs = read_scalars(f"{root}/{label}/summaries") + read_scalars(f"{root}/{label}_resumed/summaries")
        check([r["step"] for r in recs] == list(range(1, PAR_STEPS + 1)), f"{label}: steps {recs}")
        loss_gap = max(abs(r["total"] - w["total"]) / abs(w["total"]) for r, w in zip(recs, ref))
        terms = {k: max(abs(r[k] - w[k]) for r, w in zip(recs, ref)) for k in LOSS_KEYS}
        # the step-1 gradients over the whole model (relative L2), and the
        # largest gap of one tensor, for information: a small tensor whose
        # gradient sums millions of cancelling bf16 terms (the first conv's
        # bias) moves by percents of its largest under any bf16 rounding
        got_grads = ranks[0][label]["grads"]
        grad_l2 = math.sqrt(sum(float((got_grads[k] - v).square().sum()) for k, v in ref_grads.items())
                            / sum(float(v.square().sum()) for v in ref_grads.values()))
        grad_gap, grad_where = tensor_gap(got_grads, ref_grads)
        params = ckpt_mod.restore(f"{root}/{label}_resumed/checkpoints", PAR_STEPS, map_location="cpu")["model"]
        # weights against their largest, as the gradients; the biases start
        # at 0, so after two Adam steps each is a few lr in size, and an
        # element whose gradient is near 0 in both steps moves by a fraction
        # of lr that the last bits of its gradient decide: their gap is
        # reported in units of lr
        weight_names = [k for k, v in ref_params.items() if v.dim() > 1]
        param_gap, param_where = tensor_gap({k: params[k] for k in weight_names},
                                            {k: ref_params[k] for k in weight_names})
        lr = cfg1.train.optimizer.initial_lr
        bias_gap, bias_where = max((float((params[k] - v).abs().max()) / lr, k)
                                   for k, v in ref_params.items() if v.dim() == 1)
        # each tensor's step-2 update against one process's (both from the
        # same step-1 checkpoint), biases included
        updates = {k: float((params[k].float() - v.float()).norm())
                   / max(float((v.float() - start[k].float()).norm()), 1e-30) for k, v in ref_params.items()}
        worst = sorted(updates.items(), key=lambda kv: -kv[1])[:3]
        update_gap, update_where = worst[0][1], worst[0][0]
        mesh = ranks[0][label]["mesh"]
        print(f"[parallel {tag}] {mesh} over 2 ranks on one card (gloo, CUDA tensors), batch {BATCH} "
              f"({BATCH // mesh['data']} rows a rank), deterministic algorithms: totals "
              f"{[r['total'] for r in recs]} against one process's {[w['total'] for w in ref]} (step 1 from "
              f"the same init, step 2 from one process's step-1 checkpoint, sliced by the mesh): largest "
              f"relative gap {loss_gap:.3e} (tol {PAR_TOL:g}); every term's largest abs gap "
              + ", ".join(f"{k} {v:.2e}" for k, v in terms.items())
              + f"; step-1 gradients: relative L2 gap over the model {grad_l2:.3e} (tol {PAR_TOL:g}), largest "
              f"gap of one tensor {grad_gap:.3e} of its largest ({grad_where}); weights after step {PAR_STEPS}: largest gap {param_gap:.3e} of a tensor's largest "
              f"({param_where}; tol {PAR_TOL:g}); biases (0 at init): largest gap {bias_gap:.3f} lr ({bias_where}); step-2 "
              f"update of each tensor against one process's, relative L2 over {len(updates)} tensors (biases "
              f"included): largest " + ", ".join(f"{k} {v:.3e}" for k, v in worst) + f" (tol {UPDATE_TOL:g})")
        for rank, rr in enumerate(ranks):
            rec = rr[label]
            per_step = {k: v / PAR_STEPS for k, v in rec["launches"].items()}
            span = rec.get("collective_ms", {}).get("gloo:all_reduce")
            print(f"[parallel {tag}] rank {rank} rows {rec['rows']}: launches a step "
                  + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
                  + f"; step times {[round(t, 2) for t in rec['step_ms']]} ms (CUDA events; step 1 pays the "
                  f"process's warm-up) against phase 6's median {frame_step_ms:.2f} ms (batch {BATCH}, one "
                  f"process) and this phase's one process {[round(r['step_ms'], 2) for r in ref]} ms"
                  + (f"; all_reduce of the step's {rec['all_reduce_mb']:.1f} MB of f32 gradients on the data "
                     f"group {rec['all_reduce_ms']:.2f} ms = {rec['all_reduce_ms'] / rec['step_ms'][-1]:.3f} of "
                     f"step {PAR_STEPS}" if "all_reduce_ms" in rec else "")
                  + (f"; the profiled step's gloo:all_reduce span {span:.2f} ms = "
                     f"{span / rec['step_ms'][-1]:.3f} of step {PAR_STEPS} (summed over the "
                     f"step's all-reduces, each from its start to its end: the backward and the wait for the "
                     f"other rank overlap it)" if span is not None else ""))
        check(loss_gap <= PAR_TOL, f"{label}: losses differ from one process's by {loss_gap:.3e} relative")
        check(grad_l2 <= PAR_TOL, f"{label}: step-1 gradients differ by {grad_l2:.3e} (relative L2)")
        check(param_gap <= PAR_TOL, f"{label}: weight {param_where} differs by {param_gap:.3e} of its largest")
        check(update_gap <= UPDATE_TOL, f"{label}: the step-2 update of {update_where} differs from one "
                                        f"process's by {update_gap:.3e} (relative L2)")
        for rank, rr in enumerate(ranks):
            for name in ("A", "C", "A-bwd", "C-bwd"):
                check(rr[label]["launches"][name] == 2 * PAR_STEPS,
                      f"{label} rank {rank}: kernel {name} launched {rr[label]['launches'][name]} times in "
                      f"{PAR_STEPS} steps, not 2 a step")
        out[label] = {"loss_gap": loss_gap, "grad_l2_gap": grad_l2, "grad_gap": grad_gap, "weight_gap": param_gap,
                      "bias_gap_lr": bias_gap, "update_gap": update_gap, "update_where": update_where,
                      "ranks": [{k: v for k, v in rr[label].items() if k not in ("rows", "grads")} for rr in ranks]}
    print(f"[parallel b-c] both meshes in {wall:.1f} s with the ranks' start")
    shutil.rmtree(root)
    return out


def eval_parallel_phase(device, cfg, root: str, workdir: str, sweep: dict) -> dict:
    """19d: the ``Evaluator`` on two ranks over gloo on the one card, phase 9's
    tree and step-4 checkpoint, against one process's sweep of the same
    checkpoint, both under deterministic algorithms, with kernel A in its
    default f32 accumulation (a frame's rows the same bits whatever frames
    share its batch): the NMS can turn a last-bit difference into other
    rows. Frames/s beside phase 9's."""

    from sparse_pooling_tpu_torch.parallel import launch
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator

    check(cfg.model.sparse_pool.accum_dtype == "float32", "phase 19 (d) runs kernel A's default f32 mode")
    ecfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, split="val"))
    one, two = (str(kernels.BUILD_DIR.parent / f"chip_smoke_parallel_eval{k}") for k in ("_one", ""))
    for w in (one, two):
        shutil.rmtree(w, ignore_errors=True)
        shutil.copytree(f"{workdir}/checkpoints", f"{w}/checkpoints")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = Evaluator(ecfg, extents=AreaExtents(), workdir=one, device=device).run_checkpoint_once(KITTI_STEPS)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    t0 = time.perf_counter()
    ranks = launch.spawn(evaluate_rank, 2, (ecfg, two), backend="gloo", device=device.type,
                         timeout_s=600)
    wall = time.perf_counter() - t0
    sub = f"predictions/kitti_native_eval/{ecfg.eval.kitti_score_threshold:g}/{KITTI_STEPS}/data"
    same, gap2d, gap3d = rows_gap(read_rows(f"{two}/{sub}"), read_rows(f"{one}/{sub}"))
    res, cold = ranks[0]["result"], ranks[0]["cold"]
    n_batches = -(-len(KITTI_VAL) // BATCH)
    for rank, rr in enumerate(ranks):
        print(f"[parallel d] rank {rank}: mesh {rr['mesh']}, launches in the second sweep " + ", ".join(
            f"{k} {v}" for k, v in rr["launches"].items()) + "; its phases (s) " + ", ".join(
            f"{k} {v:.3f}" for k, v in rr["phases"].items()))
    print(f"[parallel d] 2 ranks, {res['num_frames']} val frames at batch {BATCH} ({BATCH // 2} rows a rank): "
          f"{res['frames_per_sec']:.2f} frames/s with host IO ({res['seconds']:.3f} s; the first sweep, with the "
          f"fresh processes' warm-up, {cold['frames_per_sec']:.2f}) against phase 9's one process "
          f"{sweep['frames_per_sec']:.2f} frames/s ({sweep['seconds']:.3f} s) and this phase's one process, cold, "
          f"{ref['frames_per_sec']:.2f}; {wall:.1f} s with the ranks' start")
    print(f"[parallel d] rows against one process's sweep (kernel A's f32 accumulation, deterministic "
          f"algorithms on both sides): files and classes equal {same}; largest gap 2D box {gap2d:.3e} px "
          f"(tol 1e-3), 3D box and score {gap3d:.3e} (tol 1e-4)")
    print(f"[parallel d] AP two ranks {json.dumps(res['ap'])}; one process {json.dumps(ref['ap'])}")
    check(res["num_frames"] == len(KITTI_VAL) and all(rr["result"] == res for rr in ranks),
          "the ranks' results differ or miss frames")
    check(same and gap2d <= 1e-3 and gap3d <= 1e-4, "the two-rank rows differ from the one-process sweep's")
    for rank, rr in enumerate(ranks):
        for name in ("A", "C"):
            check(rr["launches"][name] == 2 * n_batches,
                  f"eval rank {rank}: kernel {name} launched {rr['launches'][name]} times in {n_batches} batches")
    for w in (one, two):
        shutil.rmtree(w)
    return {"frames_per_sec": res["frames_per_sec"], "cold_frames_per_sec": cold["frames_per_sec"],
            "gap_2d": gap2d, "gap_3d": gap3d}


def parallel_phase(device, kitti_cfg, kitti_root: str, kitti_workdir: str, sweep: dict,
                   frame_step_ms: float) -> dict:
    """Phase 19: parallel/ on the one card (a)-(d), after the dry run of
    ``parallel/dryrun.py`` (4 CPU ranks over gloo against one process)."""

    from sparse_pooling_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(4)
    print(f"[parallel dryrun] dryrun_multichip(4): mesh {dry['mesh']}, losses {dry['sharded_losses']} equal one "
          f"process's {dry['single_losses']} at rtol {dryrun.LOSS_RTOL:g} (CPU ranks, the unittest preset); "
          f"{time.perf_counter() - t0:.1f} s")
    multihost_phase(kitti_cfg)
    out = {"training": training_parallel_phase(device, frame_step_ms)}
    out["eval"] = eval_parallel_phase(device, kitti_cfg, kitti_root, kitti_workdir, sweep)
    out["seconds"] = time.perf_counter() - t0
    print(f"[parallel] phase 19 in {out['seconds']:.1f} s")
    return out


def main(device: str = "cuda", ell_baseline: str | None = None, a_baseline: str | None = None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    device = torch.device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    # 1. build
    t0 = time.perf_counter()
    built = kernels.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall; per source: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in built.items()))
    for name in kernels.KERNEL_SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[1].strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    cfg = cars_pyramid_config().model
    ext = AreaExtents()
    model = pl.make_model(cfg, ext, device=device)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, ext, device=device)
    requests = [make_batch(cfg, r, device) for r in range(REQUESTS)]

    # 2. warm-up request 0, recording the kernels' main-path inputs
    a_calls, c_calls, nms_calls = [], [], []
    with recording(sparse_pool, "sparse_pool_patch_kernel", a_calls), \
            recording(crop_resize, "crop_and_resize_group_kernel", c_calls), \
            recording(nms, "greedy_nms_kernel", nms_calls):
        run_request(model, requests[0][1], anchors, cfg, ext)
    torch.cuda.synchronize()
    check(len(a_calls) == 2 and len(c_calls) == 2, "warm-up did not reach kernels A and C twice")
    check(len(nms_calls) == 2, f"warm-up reached the NMS kernel {len(nms_calls)} times, not twice")
    print("[kernels vs plain] (medians of 20, L2-warm unless marked L2-cold: a 128 MB write "
          "first; 'call': CUDA events around the call, as the caller sees it; 'device': the "
          f"same after a spin that covers the host's launches; 'host enqueue': host time per "
          f"call over {HOST_BURST} calls back to back, median of 10 such rounds)")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    earlier_a = load_baseline(a_baseline) if a_baseline else None
    res_a = kernel_a_phase(a_calls, flush, earlier_a)
    res_c, windows = kernel_c_phase(c_calls, flush)
    kernel_c_wide_unit(device)
    res_nms_cars = nms_phase([(name, *args) for name, args in zip(("cars RPN", "cars final"), nms_calls)], flush)
    del nms_calls
    floor = timings(lambda: torch.cuda._sleep(0))
    print(f"  launch floor: an empty kernel (torch.cuda._sleep(0)) {timing_text(floor)}; "
          f"{device_split(lambda: torch.cuda._sleep(0))} kernel execution (torch.profiler)")
    baseline = load_ell_baseline(ell_baseline) if ell_baseline else None
    # kernel B's tables: request 0's 8 frames, each its own host ELL tables;
    # its sources: the post-projection mid features that kernel A pools
    frame_tables = [ell_tables(f, cfg, ext) for f in requests[0][0]]
    b_dirs = []
    for d, label in enumerate(("BEV<-FV", "FV<-BEV")):
        src = a_calls[d][0]
        b_dirs.append((label, src.reshape(src.shape[0], -1, src.shape[-1]),
                       torch.from_numpy(np.stack([m[d].ell_src for m in frame_tables])).to(device),
                       torch.from_numpy(np.stack([m[d].ell_w for m in frame_tables])).to(device)))
    one_frame = new_result()
    for label, src, idx, w in b_dirs:
        ell_timing(one_frame, src[:1], idx[:1], w[:1],
                   f"one frame {label} S={src.shape[1]} T={idx.shape[1]} K={idx.shape[2]} C={src.shape[2]}",
                   flush, baseline)
    g = torch.Generator().manual_seed(0)
    probe = ell_timing(
        new_result(),
        torch.rand(1, 7488, 32, generator=g).to(device),
        torch.randint(0, 7488, (1, 8832, 8), generator=g, dtype=torch.int32).to(device),
        torch.rand(1, 8832, 8, generator=g).to(device),
        "probe S=7488 T=8832 K=8 C=32 f32", flush, baseline,
    )
    res_b = new_result()
    for label, src, idx, w in b_dirs:
        ell_timing(res_b, src, idx, w,
                   f"batch {src.shape[0]} {label} S={src.shape[1]} T={idx.shape[1]} K={idx.shape[2]} C={src.shape[2]}",
                   flush, baseline)
    del flush

    # 3. main path: 3 requests of batch 8, counts read around exactly these
    launches, request_ms = serve_requests(model, requests, anchors, cfg, ext, "main path")
    for name, per_request in (("A", 2), ("C", 2), ("B", 0), ("A-bwd", 0), ("C-bwd", 0), ("NMS", 2)):
        check(launches[name] == per_request * REQUESTS,
              f"kernel {name}: {launches[name]} launches in {REQUESTS} requests, not {per_request} a request")
    launches_a, launches_c = launches["A"], launches["C"]
    serving_kernels = profile_phase(model, requests[0][1], anchors, cfg, ext, float(np.median(request_ms)))

    # 4. the ELL path (kernel B): request 0's 8 frames, one launch per direction
    exact_a = [sparse_pool.sparse_pool_patch_plain(*args[:5], True)[0] for args in a_calls]
    reset_counts()
    outs = [ell_sparse_pool.sparse_pool_ell_batch(src, idx, w) for _, src, idx, w in b_dirs]
    torch.cuda.synchronize()
    launches_b = ell_sparse_pool.sparse_pool_ell_kernel.launches
    print(f"[ELL path] batch {BATCH}, both directions: kernel B launches {launches_b}")
    check(launches_b == 2, f"kernel B launched {launches_b} times on the ELL path, not once per direction")
    for d, ((label, src, idx, w), got, exact) in enumerate(zip(b_dirs, outs, exact_a)):
        tol = ELL_TOL[src.dtype]
        err, rel = compare(got, sparse_pool.sparse_pool_ell_batch_plain(src, idx, w), tol, f"ELL path {label}")
        # rows whose every source fits the K slots: the ELL pool is exact there
        n_src = np.stack([np.bincount(m[d].rows[: m[d].nnz], minlength=idx.shape[1]) for m in frame_tables])
        small = torch.from_numpy((n_src > 0) & (n_src <= idx.shape[2])).to(device)
        gap = (got.float()[small] - exact[small]).abs().max().item() if bool(small.any()) else 0.0
        print(f"[ELL path] {label}: kernel B vs plain ELL over {src.shape[0]} frames max_abs_err {err:.3e} "
              f"rel {rel:.3e} (tol {tol:g} rel); info: gap to kernel A's exact pool on "
              f"{int(small.sum())} rows with <= {idx.shape[2]} sources {gap:.3e}")

    # 5. end to end on the card against the CPU at the narrow parity config
    print("[card vs CPU]")
    card_vs_cpu_phase()
    del model, requests

    # 6. training at full width: backward kernels, Trainer, resume, fixed batch
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    res_a_bwd, res_c_bwd, train_launches, frame_step_ms, train_peak = training_phase(device, flush, earlier_a)
    del flush

    # 7. one training step on the card against the CPU
    print("[training card vs CPU]")
    train_card_vs_cpu_phase()

    # 8. training from a KITTI tree through the native loader and the prefetcher
    print("[kitti data path]")
    kitti_cfg, kitti_root, kitti_workdir = kitti_phase(device, frame_step_ms)

    # 9. evaluation: the checkpoint phase 8 wrote, over the tree's val split
    print("[evaluation]")
    sweep = eval_phase(device, kitti_cfg, kitti_root, kitti_workdir, serving_kernels)

    # 10-13. the rcnn family: serving, training, card vs CPU; the people preset
    print("[rcnn serving]")
    rcnn_serving = rcnn_serving_phase(device, serving_kernels)
    print("[rcnn training]")
    rcnn_training = rcnn_training_phase(device)
    print("[rcnn card vs CPU]")
    card_vs_cpu_phase(rcnn_parity_config())
    print("[people]")
    people = people_phase(device)

    # 14-18. the AVOD detector's model options at full width
    options = options_phase(device, train_peak)

    # 19. parallel/: run_training --multihost over NCCL, data and tensor
    # parallelism and the evaluator on two ranks sharing the card over gloo
    print("[parallel]")
    parallel = parallel_phase(device, kitti_cfg, kitti_root, kitti_workdir, sweep, frame_step_ms)
    shutil.rmtree(kitti_workdir)
    shutil.rmtree(kitti_root)

    # 20. the learning checks' path: the other scenes' trees, overfit_check
    print("[learning path]")
    learning = learning_phase(device)

    # 21. the serving export: the cars preset at full width, served from a fresh process
    print("[serving export]")
    exported = export_phase(device, request_ms, {"A": launches_a, "C": launches_c})

    # 22. ContFuse: the KNN kernel, the NMS's kept set, the served requests
    print("[contfuse serving]")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    contfuse = contfuse_phase(device, flush)
    del flush

    entries = [
        ("sparse_pool_patch", "sparse_pooling_tpu_torch/csrc/sparse_pool_patch.cu",
         "sparse_pooling_tpu/ops/sparse_pool.py:176", launches_a, res_a),
        ("ell_sparse_pool", "sparse_pooling_tpu_torch/csrc/ell_sparse_pool.cu",
         "sparse_pooling_tpu/ops/pallas_sparse_pool.py:70", launches_b, res_b),
        ("group_crop", "sparse_pooling_tpu_torch/csrc/group_crop.cu",
         "tools/probe_pallas_roi.py:121", launches_c, res_c),
        # the backwards: launches over the Trainer's 6 steps
        ("sparse_pool_patch_bwd", "sparse_pooling_tpu_torch/csrc/sparse_pool_patch.cu",
         "sparse_pooling_tpu/ops/sparse_pool.py:196", train_launches["A-bwd"], res_a_bwd),
        ("group_crop_bwd", "sparse_pooling_tpu_torch/csrc/group_crop.cu",
         "sparse_pooling_tpu/ops/crop_resize.py:789", train_launches["C-bwd"], res_c_bwd),
        # no pallas_call: the lax.fori_loop of _nms_batch; an rcnn request's
        # two calls, launches over phase 10's requests
        ("greedy_nms", "sparse_pooling_tpu_torch/csrc/greedy_nms.cu",
         "sparse_pooling_tpu/ops/nms.py:_nms_batch", rcnn_serving["launches"]["NMS"], rcnn_serving["NMS"]),
        # no JAX counterpart: the JAX package has no ContFuse
        contfuse_entry(contfuse),
    ]
    print("[ell one frame] " + json.dumps({"replaces": "sparse_pooling_tpu/ops/pallas_sparse_pool.py:70",
                                           **one_frame}))
    print("[ell probe shapes] " + json.dumps({"replaces": "tools/probe_pallas_shpl.py:66", **probe}))
    print(f"[ell batch {BATCH}] " + json.dumps(res_b))
    print("[A-bwd, both calls] " + json.dumps(res_a_bwd))
    print("[C-bwd, both calls] " + json.dumps(res_c_bwd))
    print("[greedy NMS, cars request's two calls] " + json.dumps(res_nms_cars))
    print("[greedy NMS, rcnn off the serving path] " + json.dumps(rcnn_serving["NMS_off_path"]))
    print("[rcnn and people paths] " + json.dumps({
        "rcnn_serving": {"launches": rcnn_serving["launches"], "max_abs_err_A": rcnn_serving["max_abs_err"],
                         "request_ms": rcnn_serving["request_ms"]},
        "rcnn_training": {"launches": rcnn_training["launches"], "max_abs_err_A_bwd": rcnn_training["max_abs_err"],
                          "step_ms": rcnn_training["step_ms"]},
        "people": {"launches": people["launches"], "train_launches": people["train_launches"],
                   "max_abs_err": people["max_abs_err"], "request_ms": people["request_ms"],
                   "C": people["C"], "C-bwd": people["C-bwd"]}}))
    print("[model options P1-P5] " + json.dumps(options))
    print("[parallel/ phase 19] " + json.dumps(parallel))
    print("[learning path, phase 20] " + json.dumps(learning))
    print("[serving export, phase 21] " + json.dumps(exported))
    print("[greedy NMS, contfuse kept set] " + json.dumps(contfuse["NMS"]))
    print("[contfuse serving, phase 22] " + json.dumps({"launches": contfuse["launches"],
                                                        "request_ms": contfuse["request_ms"]}))
    print("[window gather, rows 3-4] " + json.dumps({
        "replaces": ["tools/probe_pallas_roi.py:60", "tools/probe_pallas_roi.py:88"],
        "carried_by": "group_crop", "calls": windows}))
    # ms, plain_ms and library_ms: as the caller sees a call; device_ms,
    # cold_ms and library_device_ms: device work; host_us and
    # library_host_us: host enqueue. Each sums the kernel's two calls (B: its
    # two directions at batch 8, the ELL path's calls; A-bwd and C-bwd: the
    # two calls of one training step; the KNN: one call).
    print(json.dumps({"kernels": kernel_rows(entries)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ell-baseline", metavar="CU", default=None,
                        help="also time this kernel B source with the one-frame C interface "
                             "(the kernel before the batched redesign) on the same work")
    parser.add_argument("--a-baseline", metavar="DIR", default=None,
                        help="also build this directory's sparse_pool_patch.cu (with its common.cuh; "
                             "the port's C interface of kernels A and A-bwd) and time its A and A-bwd "
                             "on the same recorded inputs")
    args = parser.parse_args()
    sys.exit(main(ell_baseline=args.ell_baseline, a_baseline=args.a_baseline))
