"""Chip smoke for the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--ell-baseline CU] [--bwd-baseline DIR]

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
   over 3.35 TB/s vs operations over 67 TFLOP/s f32); A's live-point share
   and points per target row, and C's window gather alone (TPU kernels 3
   and 4); the device time of an empty kernel, the floor of any launch;
   kernel B at one frame, at the probe's shapes and at batch 8 (request 0's
   frames, each with its own host ELL tables), with its share of live ELL
   slots and its tap reads, and with ``--ell-baseline`` the given earlier
   kernel B source timed on the same work;
3. the main path: the cars preset at full width (bf16 compute) answers 3
   requests of batch 8 synthetic frames (16384 points, seeded) through
   ``forward_batch_fn`` + ``decode_batch``; launch counts of kernels A and C
   are read around exactly these 3 requests; then where the time goes: the
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
   ``F.grid_sample``'s input gradient; ``Trainer.train(6)`` with a
   checkpoint at step 6 (counts read around exactly these 6 steps: A, C,
   A-bwd and C-bwd twice a step), every step's losses, grad norm, sampled
   positives and time, peak memory, a torch.profiler split of one more step,
   a fresh ``Trainer`` that restores step 6 exactly and takes step 7, and 10
   steps on one fixed batch (no path drop, no dropout, fixed sampling noise)
   that must lower its loss;
7. one training step of the narrow parity config on the card against the
   CPU, with stage-2 positives sampled: losses and every parameter's
   gradient;
8. one ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from sparse_pooling_tpu_torch import kernels, weights
from sparse_pooling_tpu_torch.configs import AreaExtents, cars_pyramid_config
from sparse_pooling_tpu_torch.data.sparse_matrix import build_sparse_pooling_input
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame, trim_points_to_bucket
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, sparse_pool
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
    return {"max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "cold_ms": 0.0, "host_us": 0.0,
            "plain_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0,
            "library_host_us": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}


def add_times(res: dict, kernel: dict, plain: float, library: dict) -> None:
    """Accumulate one call's times into ``res``."""

    for key, value in kernel.items():
        res[key] = res.get(key, 0.0) + value
    res["plain_ms"] += plain
    res["library_ms"] += library["ms"]
    res["library_device_ms"] += library["device_ms"]
    res["library_host_us"] += library["host_us"]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def recording(module, name: str, store: list):
    """Record the arguments of ``module.name`` while the block runs."""

    orig = getattr(module, name)

    def rec(*args, **kwargs):
        store.append(args)
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
    ("hand kernels A, B, C, A-bwd, C-bwd", ("patch_pool", "group_crop", "ell_pool")),
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


def profile_phase(model, batch, anchors, cfg, ext, request_ms: float) -> None:
    """Where the time goes: stage times of one more request (CUDA events),
    then, from torch.profiler over another, device time by kernel category
    and name, the launch count and the device's busy share."""

    from torch.profiler import ProfilerActivity, profile

    stages = staged_request(model, batch, anchors, cfg, ext)
    print(f"[where the time goes] stages of one request (CUDA events): input build "
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
        return
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


def compare(got, want, tol_rel: float, what: str):
    """Max abs error and its ratio to max |want|; fails above tol_rel."""

    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    check(err <= tol_rel * scale, f"{what}: max abs err {err:.3e} > {tol_rel:g} * {scale:.3g}")
    return err, err / scale


# ------------------------------------------------------------ kernel checks


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
        (e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:48],
         e.self_device_time_total / reps)
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


def kernel_a_phase(calls, flush):
    """Kernel A at the two recorded main-path calls (BEV<-FV, FV<-BEV)."""

    res = new_result()
    for args in calls:
        src, rows, cols, vals, t = args[:5]
        b, hs, ws, c = src.shape
        print(f"  A {tuple(src.shape)}->T={t}: {patch_pool_stats(rows, vals, t)}")
        for dtype, tol in ((torch.bfloat16, 1e-4), (torch.float32, 1e-4)):
            x = src.to(dtype)
            got, got_den = sparse_pool.sparse_pool_patch_kernel(x, rows, cols, vals, t, True)
            want, want_den = sparse_pool.sparse_pool_patch_plain(x, rows, cols, vals, t, True)
            err, rel = compare(got, want, tol, f"kernel A {tuple(src.shape)} {dtype}")
            compare(got_den, want_den, 1e-5, f"kernel A {tuple(src.shape)} {dtype} weight sums")
            print(f"  A {tuple(src.shape)}->T={t} {str(dtype):15s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g} rel)")
            if dtype == src.dtype:
                res["max_abs_err"] = max(res["max_abs_err"], err)
        def kernel_call():
            return sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, t, True)

        kern = timings(kernel_call, flush)
        print(f"  A {tuple(src.shape)} device split per call (L2-warm): {device_split(kernel_call)}")
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
        plain = median_ms(lambda: crop_resize.crop_and_resize_group_plain(img, boxes, crop_hw, patch))
        # library: grid_sample (bilinear, align_corners) at the window-clamped coords
        ys, xs, y0, x0 = crop_resize._group_starts(boxes, h, w, crop_hw, patch)
        py, px = min(patch, h), min(patch, w)
        ye = y0[..., None, None] + torch.clamp(ys - y0[..., None, None], 0.0, py - 1.0)
        xe = x0[..., None, None] + torch.clamp(xs - x0[..., None, None], 0.0, px - 1.0)
        _, pu, v, ch = ys.shape
        cw = xs.shape[-1]
        gy = (2 * ye / (h - 1) - 1)[..., :, None].expand(b, pu, v, ch, cw)
        gx = (2 * xe / (w - 1) - 1)[..., None, :].expand(b, pu, v, ch, cw)
        grid = torch.stack([gx, gy], -1).reshape(b, pu * v * ch, cw, 2)
        nchw = img.float().permute(0, 3, 1, 2).contiguous()

        def lib_call():
            return torch.nn.functional.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="border", align_corners=True
            )

        lib_out = lib_call().permute(0, 2, 3, 1).reshape(b, pu, v, ch, cw, c)
        lib_err = (lib_out - f32_truth).abs().max().item()
        lib = timings(lib_call, flush)
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
        # the window gather alone: the twin's index gather (ops/crop_resize.py:107-108)
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


ELL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}  # relative to max(|twin|, 1)


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


def card_vs_cpu_phase():
    """The parity config on the card and on the CPU, same weights and frames."""

    cfg = parity_config()
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
        print(f"  parity config card vs CPU: {key} max abs diff {err:.3e} (tol 1e-4)")
        check(err <= 1e-4, f"card vs cpu: {key} differs by {err:.3e}")
    agree = (g_det["valid"].cpu() == c_det["valid"]).float().mean().item()
    print(f"  parity config card vs CPU: detection validity agrees on {agree:.3f} of slots "
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


def load_bwd_baseline(directory: str):
    """Build another commit's ``sparse_pool_patch.cu`` and ``group_crop.cu``
    from ``directory`` (with its ``common.cuh``; the backward C interface
    ``sparse_pool_patch_bwd_launch`` / ``group_crop_bwd_launch`` of the
    port) with the port's flags under other library names, both compiles at
    once, and return callers of those backward kernels that take the
    wrappers' arguments: ``(a_bwd, c_bwd)``."""

    import ctypes
    import hashlib

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    common = open(f"{directory}/common.cuh", "rb").read()
    procs = {}
    for name in ("sparse_pool_patch", "group_crop"):
        path = f"{directory}/{name}.cu"
        digest = hashlib.sha256(open(path, "rb").read() + common).hexdigest()[:16]
        lib_path = kernels.BUILD_DIR / f"bwd_baseline_{name}-{digest}.so"
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path), path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       lib_path)
    libs = {}
    for name, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"baseline {name}.cu did not build:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        for symbol in ("sparse_pool_patch_bwd_scratch_ints", "sparse_pool_patch_bwd_launch",
                       "group_crop_bwd_launch"):
            if symbol in kernels.SIGNATURES[name]:
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = kernels.SIGNATURES[name][symbol]
        libs[name] = lib

    def a_bwd(g, rows, cols, vals, src_hw, den, dtype):
        b, t, c = g.shape
        hs, ws = src_hw
        p = rows.shape[1]
        lib = libs["sparse_pool_patch"]
        out = g.new_empty((b, hs, ws, c), dtype=dtype)
        scratch = rows.new_empty(lib.sparse_pool_patch_bwd_scratch_ints(b, p, hs * ws, c))
        rc = lib.sparse_pool_patch_bwd_launch(
            g.data_ptr(), None if den is None else den.data_ptr(), b, t, c, rows.data_ptr(),
            cols.data_ptr(), vals.data_ptr(), p, hs, ws, kernels.DTYPE_CODES[dtype],
            scratch.data_ptr(), out.data_ptr(), kernels.stream_ptr(g.get_device()))
        check(rc == 0, f"baseline A-bwd launch failed: CUDA error {rc}")
        return out

    def c_bwd(grad, boxes, image_shape, crop_hw, patch, dtype):
        b, h, w, c = image_shape
        p, v = boxes.shape[1:3]
        acc = grad.new_empty((b, h, w, c), dtype=torch.float32)
        out = acc if dtype == torch.float32 else grad.new_empty((b, h, w, c))
        rc = libs["group_crop"].group_crop_bwd_launch(
            grad.data_ptr(), kernels.DTYPE_CODES[dtype], b, h, w, c, boxes.data_ptr(), p, v,
            int(crop_hw[0]), int(crop_hw[1]), int(patch), acc.data_ptr(), out.data_ptr(),
            kernels.stream_ptr(grad.get_device()))
        check(rc == 0, f"baseline C-bwd launch failed: CUDA error {rc}")
        return out

    return a_bwd, c_bwd


def c_bwd_phases(grad, boxes, image_shape, crop_hw, patch, dtype) -> str:
    """C-bwd's device execution by phase (torch.profiler, L2-warm): the
    kernel run whole and cut short after its loads, window starts and row
    sort (stop 1) and after both contractions (stop 2,
    ``group_crop_bwd_split_launch``); the phases are the differences, the
    memset and the bf16 rounding pass their own launches."""

    lib = kernels.library("group_crop")
    b, h, w, c = image_shape
    p, v = boxes.shape[1:3]
    acc = grad.new_empty((b, h, w, c), dtype=torch.float32)
    out = acc if dtype == torch.float32 else grad.new_empty((b, h, w, c))
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
            f"{k2 - k1:.2f} + global reduction (atomics) {k0 - k2:.2f}; {rest}")


def earlier_bwd(res, label, call, want, flush) -> None:
    """An earlier backward kernel (``--bwd-baseline``) on the same inputs:
    its gap to the twin, its times and per-launch split, summed into
    ``res["earlier_*"]``."""

    dtype = want.dtype
    err, rel, _ = compare_grad(call(), want, BWD_TOL[dtype], f"earlier kernel {label} {dtype}")
    base = timings(call, flush)
    base["profiled_us"] = sum(us for _, us in kernel_parts(call))
    print(f"  {label}: earlier kernel {timing_text(base)}, {base['profiled_us']:.2f} us kernel "
          f"execution (torch.profiler: {device_split(call)}); max abs err to the twin {err:.3e} "
          f"(rel {rel:.3e})")
    for key, value in base.items():
        res[f"earlier_{key}"] = res.get(f"earlier_{key}", 0.0) + value


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
            got = sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, src_hw, den, dt)
            want = sparse_pool.sparse_pool_patch_bwd_plain(g, rows, cols, vals, src_hw, den, dt)
            err, rel, scale = compare_grad(got, want, BWD_TOL[dt], f"kernel {label} {dt}")
            print(f"  {label} {str(dt):15s} max_abs_err {err:.3e} rel {rel:.3e} of max |twin| "
                  f"{scale:.3e} (tol {BWD_TOL[dt]:g} rel; a zeroed or halved output fails)")
            if dt == dtype:
                res["max_abs_err"] = max(res["max_abs_err"], err)

        def kernel_call():
            return sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, src_hw, den, dtype)

        kern = timings(kernel_call, flush)
        print(f"  {label} device split per call (L2-warm): {device_split(kernel_call)}")
        if baseline is not None:
            earlier_bwd(res, label, lambda: baseline(g, rows, cols, vals, src_hw, den, dtype),
                        sparse_pool.sparse_pool_patch_bwd_plain(g, rows, cols, vals, src_hw, den, dtype),
                        flush)
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


def kernel_c_bwd_phase(calls, flush, baseline=None):
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

        kern = timings(kernel_call, flush)
        print(f"  {label} device split per call (L2-warm): {device_split(kernel_call)}")
        print(f"  {label} phases per call (L2-warm): "
              f"{c_bwd_phases(grad, boxes, image_shape, crop_hw, patch, dtype)}")
        if baseline is not None:
            earlier_bwd(res, label, lambda: baseline(grad, boxes, image_shape, crop_hw, patch, dtype),
                        crop_resize.crop_and_resize_group_bwd_plain(grad, boxes, image_shape, crop_hw,
                                                                    patch, dtype), flush)
        plain = median_ms(lambda: crop_resize.crop_and_resize_group_bwd_plain(
            grad, boxes, image_shape, crop_hw, patch, dtype))
        ys, xs, y0, x0 = crop_resize._group_starts(boxes, h, w, crop_hw, patch)
        py, px = min(patch, h), min(patch, w)
        ye = y0[..., None, None] + torch.clamp(ys - y0[..., None, None], 0.0, py - 1.0)
        xe = x0[..., None, None] + torch.clamp(xs - x0[..., None, None], 0.0, px - 1.0)
        _, pu, v, ch = ys.shape
        cw = xs.shape[-1]
        gy = (2 * ye / (h - 1) - 1)[..., :, None].expand(b, pu, v, ch, cw)
        gx = (2 * xe / (w - 1) - 1)[..., None, :].expand(b, pu, v, ch, cw)
        grid = torch.stack([gx, gy], -1).reshape(b, pu * v * ch, cw, 2)
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


def profile_train_step(step, batch, gen, step_ms: float) -> None:
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
        return
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


LOSS_KEYS = ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip")


def training_phase(device, flush, bwd_baseline=None):
    """Phase 6; returns the A-bwd and C-bwd results and their launches in
    the Trainer's 6 steps."""

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
    batch = tr.to_device(next(dataset.batches(BATCH))[0], device)
    gen = torch.Generator(device=device).manual_seed(0)
    a_bwd, c_bwd = [], []
    with recording(sparse_pool, "sparse_pool_patch_bwd_kernel", a_bwd), \
            recording(crop_resize, "crop_and_resize_group_bwd_kernel", c_bwd):
        step(batch, gen)
    torch.cuda.synchronize()
    check(len(a_bwd) == 2 and len(c_bwd) == 2, "a training step did not reach A-bwd and C-bwd twice")
    print("[backward kernels vs plain] (as above; inputs of one full-width training step, batch 8)")
    a_base, c_base = load_bwd_baseline(bwd_baseline) if bwd_baseline else (None, None)
    res_a_bwd = kernel_a_bwd_phase(a_bwd, flush, a_base)
    res_c_bwd = kernel_c_bwd_phase(c_bwd, flush, c_base)
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
    return res_a_bwd, res_c_bwd, launches


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


def main(device: str = "cuda", ell_baseline: str | None = None, bwd_baseline: str | None = None) -> int:
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
    a_calls, c_calls = [], []
    with recording(sparse_pool, "sparse_pool_patch_kernel", a_calls), \
            recording(crop_resize, "crop_and_resize_group_kernel", c_calls):
        run_request(model, requests[0][1], anchors, cfg, ext)
    torch.cuda.synchronize()
    check(len(a_calls) == 2 and len(c_calls) == 2, "warm-up did not reach kernels A and C twice")
    print("[kernels vs plain] (medians of 20, L2-warm unless marked L2-cold: a 128 MB write "
          "first; 'call': CUDA events around the call, as the caller sees it; 'device': the "
          f"same after a spin that covers the host's launches; 'host enqueue': host time per "
          f"call over {HOST_BURST} calls back to back, median of 10 such rounds)")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    res_a = kernel_a_phase(a_calls, flush)
    res_c, windows = kernel_c_phase(c_calls, flush)
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
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    n_valid = 0
    request_ms = []
    for r, (_, batch) in enumerate(requests):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, det = run_request(model, batch, anchors, cfg, ext)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        request_ms.append(ms)
        finite = all(bool(torch.isfinite(v).all()) for v in (det["boxes_3d"], det["scores"],
                                                             out["cls_logits"], out["proposals"]))
        check(finite, f"request {r}: non-finite outputs")
        check(det["boxes_3d"].shape == (BATCH, cfg.num_classes, cfg.avod.nms_size, 7),
              f"request {r}: detections of shape {tuple(det['boxes_3d'].shape)}")
        nv = int(det["valid"].sum())
        n_valid += nv
        print(f"[main path] request {r}: {ms:.2f} ms for batch {BATCH} = {1e3 * BATCH / ms:.1f} frames/s; "
              f"{nv} valid detections; all outputs finite")
    launches_a = sparse_pool.sparse_pool_patch_kernel.launches
    launches_c = crop_resize.crop_and_resize_group_kernel.launches
    print(f"[main path] launches over {REQUESTS} requests: A {launches_a}, C {launches_c}, "
          f"B {ell_sparse_pool.sparse_pool_ell_kernel.launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches_a >= 2 * REQUESTS, "kernel A was not launched twice per request")
    check(launches_c >= 2 * REQUESTS, "kernel C was not launched twice per request")
    check(n_valid > 0, "no valid detections")
    profile_phase(model, requests[0][1], anchors, cfg, ext, float(np.median(request_ms)))

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
    res_a_bwd, res_c_bwd, train_launches = training_phase(device, flush, bwd_baseline)
    del flush

    # 7. one training step on the card against the CPU
    print("[training card vs CPU]")
    train_card_vs_cpu_phase()

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
    ]
    print("[ell one frame] " + json.dumps({"replaces": "sparse_pooling_tpu/ops/pallas_sparse_pool.py:70",
                                           **one_frame}))
    print("[ell probe shapes] " + json.dumps({"replaces": "tools/probe_pallas_shpl.py:66", **probe}))
    print(f"[ell batch {BATCH}] " + json.dumps(res_b))
    print("[A-bwd, both calls] " + json.dumps(res_a_bwd))
    print("[C-bwd, both calls] " + json.dumps(res_c_bwd))
    print("[window gather, rows 3-4] " + json.dumps({
        "replaces": ["tools/probe_pallas_roi.py:60", "tools/probe_pallas_roi.py:88"],
        "carried_by": "group_crop", "calls": windows}))
    # ms, plain_ms and library_ms: as the caller sees a call; device_ms,
    # cold_ms and library_device_ms: device work; host_us and
    # library_host_us: host enqueue. Each sums the kernel's two calls (B: its
    # two directions at batch 8, the ELL path's calls; A-bwd and C-bwd: the
    # two calls of one training step).
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"],
         "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
         "library_ms": r["library_ms"], "device_ms": r["device_ms"], "cold_ms": r["cold_ms"],
         "host_us": r["host_us"], "library_device_ms": r["library_device_ms"],
         "library_host_us": r["library_host_us"]}
        for name, src, rep, n, r in entries
    ]}))
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
    parser.add_argument("--bwd-baseline", metavar="DIR", default=None,
                        help="also build this directory's sparse_pool_patch.cu and group_crop.cu "
                             "(with its common.cuh; the backward C interface of the port) and time "
                             "their backward kernels A-bwd and C-bwd on the same recorded inputs")
    args = parser.parse_args()
    sys.exit(main(ell_baseline=args.ell_baseline, bwd_baseline=args.bwd_baseline))
