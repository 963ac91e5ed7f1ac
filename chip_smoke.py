"""Chip smoke for the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one. Phases (any failure exits
non-zero):

1. build the hand kernels from ``sparse_pooling_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit;
2. kernels against their plain PyTorch twins on the card, at the shapes the
   main path gives them (inputs recorded from a warm-up request), in bf16
   features and in f32: max error against a stated tolerance; median times
   (CUDA events around the call) of kernel, twin and one PyTorch library
   call, and for kernel and library call also their device time (after a
   spin that covers the host's launches) and the host's enqueue time; the
   bound (bytes over 3.35 TB/s vs operations over 67 TFLOP/s f32); A and C
   also with the L2 flushed before each run, A's live-point share and points
   per target row, and C's window gather alone (TPU kernels 3 and 4);
3. the main path: the cars preset at full width (bf16 compute) answers 3
   requests of batch 8 synthetic frames (16384 points, seeded) through
   ``forward_batch_fn`` + ``decode_batch``; launch counts of kernels A and C
   are read around exactly these 3 requests; then where the time goes: the
   stage times of one more request and a torch.profiler split of another;
4. the ELL path: host ELL tables (K=8) of request 0 frame 0 pool that
   frame's post-projection mid features through ``sparse_pool_fused``
   (kernel B), held against the plain ELL pool; the gap to kernel A's exact
   pool on rows with <= 8 sources is printed for information;
5. the narrow parity config on the card against the same model on the CPU
   (f32, TF32 off): the RPN outputs must agree;
6. one ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SM_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock, to size the pre-run spin
FLUSH_BYTES = 128 * 2**20  # written between cold runs: over twice the 50 MB L2
BATCH, REQUESTS, N_POINTS = 8, 3, 16384
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
    (``torch.cuda._sleep``) for three times the host's enqueue time, so the
    start event fires only once the whole run is queued and the events time
    the device's work alone (a function that synchronises inside still
    stalls). With ``flush``, the buffer is overwritten before each run so
    the inputs come from device memory, not from the L2 (L2-cold)."""

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = int(3 * (time.perf_counter() - t0) * SM_CYCLES_PER_S) if spin else 0
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
        res[key] += value
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


def reset_counts() -> None:
    sparse_pool.sparse_pool_patch_kernel.launches = 0
    ell_sparse_pool.sparse_pool_ell_kernel.launches = 0
    crop_resize.crop_and_resize_group_kernel.launches = 0


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
    ("hand kernels A/B/C", ("patch_pool", "group_crop", "ell_pool")),
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


def device_split(fn, reps: int = 10) -> str:
    """Device time per call of each kernel (and memset) that ``fn``
    launches, from torch.profiler over ``reps`` calls."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = [
        (e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:48],
         e.self_device_time_total / reps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
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
            got = sparse_pool.sparse_pool_patch_kernel(x, rows, cols, vals, t, True)
            want = sparse_pool.sparse_pool_patch_plain(x, rows, cols, vals, t, True)
            err, rel = compare(got, want, tol, f"kernel A {tuple(src.shape)} {dtype}")
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
            src, rows, cols, vals, t, True)).abs().max().item()
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


def ell_timing(res, src, idx, w, label):
    """Kernel B vs its twin and cuSPARSE at one shape, accumulated into res."""

    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        x = src.to(dtype)
        err, rel = compare(ell_sparse_pool.sparse_pool_ell_kernel(x, idx, w),
                           ell_sparse_pool.sparse_pool_ell(x, idx, w), tol, f"kernel B {label} {dtype}")
        print(f"  B {label} {str(dtype):15s} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g} rel)")
        if dtype == src.dtype:
            res["max_abs_err"] = max(res["max_abs_err"], err)
    s, c = src.shape
    t, k = idx.shape
    kern = timings(lambda: ell_sparse_pool.sparse_pool_ell_kernel(src, idx, w))
    plain = median_ms(lambda: ell_sparse_pool.sparse_pool_ell(src, idx, w))
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.arange(t, device=src.device).repeat_interleave(k), idx.long().reshape(-1)]),
        w.reshape(-1), (t, s),
    ).coalesce().to_sparse_csr()
    dense = src.float()
    lib = timings(lambda: torch.sparse.mm(csr, dense))
    live = w.reshape(-1) != 0
    touched = torch.unique(idx.reshape(-1)[live]).numel()
    need = touched * c * src.element_size() + nbytes(idx, w) + t * c * src.element_size()
    bnd = add_bound(res, need, 2 * int(live.sum()) * c)
    print(f"  B {label}: kernel {timing_text(kern)}; plain {plain:.4f} ms call; "
          f"torch.sparse.mm(CSR) {timing_text(lib)}; bound {bnd:.4f} ({need / 1e6:.2f} MB)")
    add_times(res, kern, plain, lib)
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


def main(device: str = "cuda") -> int:
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
    del flush
    frame0 = requests[0][0][0]
    m_bev, m_fv = ell_tables(frame0, cfg, ext)
    src_fv = a_calls[0][0][0].reshape(-1, a_calls[0][0].shape[-1])  # FV feats feeding BEV cells
    src_bev = a_calls[1][0][0].reshape(-1, a_calls[1][0].shape[-1])
    tables = [(src_fv, m_bev), (src_bev, m_fv)]
    res_b = new_result()
    for src, m in tables:
        idx = torch.from_numpy(m.ell_src).to(device)
        w = torch.from_numpy(m.ell_w).to(device)
        ell_timing(res_b, src, idx, w, f"S={src.shape[0]} T={idx.shape[0]} K={idx.shape[1]} C={src.shape[1]}")
    g = torch.Generator().manual_seed(0)
    probe = ell_timing(
        new_result(),
        torch.rand(7488, 32, generator=g).to(device),
        torch.randint(0, 7488, (8832, 8), generator=g, dtype=torch.int32).to(device),
        torch.rand(8832, 8, generator=g).to(device),
        "probe S=7488 T=8832 K=8 C=32 f32",
    )

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

    # 4. the ELL path (kernel B) on request 0 frame 0
    reset_counts()
    exact_a = [sparse_pool.sparse_pool_patch_plain(*args[:5], True)[0] for args in a_calls]
    for (src, m), exact, label in zip(tables, exact_a, ("BEV<-FV", "FV<-BEV")):
        idx = torch.from_numpy(m.ell_src).to(device)
        w = torch.from_numpy(m.ell_w).to(device)
        got = ell_sparse_pool.sparse_pool_fused(src, idx, w)
        want = ell_sparse_pool.sparse_pool_ell(src, idx, w)
        err, rel = compare(got, want, 1e-2, f"ELL path {label}")
        n_src = np.bincount(m.rows[: m.nnz], minlength=idx.shape[0])
        small = torch.from_numpy((n_src > 0) & (n_src <= idx.shape[1])).to(device)
        gap = (got.float()[small] - exact[small]).abs().max().item() if bool(small.any()) else 0.0
        print(f"[ELL path] {label}: kernel B vs plain ELL max_abs_err {err:.3e} rel {rel:.3e} (tol 1e-2 rel); "
              f"info: gap to kernel A's exact pool on {int(small.sum())} rows with <= 8 sources {gap:.3e}")
    launches_b = ell_sparse_pool.sparse_pool_ell_kernel.launches
    check(launches_b >= 2, "kernel B was not launched on the ELL path")

    # 5. end to end on the card against the CPU at the narrow parity config
    print("[card vs CPU]")
    card_vs_cpu_phase()

    entries = [
        ("sparse_pool_patch", "sparse_pooling_tpu_torch/csrc/sparse_pool_patch.cu",
         "sparse_pooling_tpu/ops/sparse_pool.py:176", launches_a, res_a),
        ("ell_sparse_pool", "sparse_pooling_tpu_torch/csrc/ell_sparse_pool.cu",
         "sparse_pooling_tpu/ops/pallas_sparse_pool.py:70", launches_b, res_b),
        ("group_crop", "sparse_pooling_tpu_torch/csrc/group_crop.cu",
         "tools/probe_pallas_roi.py:121", launches_c, res_c),
    ]
    print("[ell probe shapes] " + json.dumps({"replaces": "tools/probe_pallas_shpl.py:66", **probe}))
    print("[window gather, rows 3-4] " + json.dumps({
        "replaces": ["tools/probe_pallas_roi.py:60", "tools/probe_pallas_roi.py:88"],
        "carried_by": "group_crop", "calls": windows}))
    print("[L2-cold] " + json.dumps({"sparse_pool_patch_ms": res_a["cold_ms"],
                                     "group_crop_ms": res_c["cold_ms"]}))
    # ms, plain_ms and library_ms: as the caller sees a call; device_ms,
    # cold_ms (A and C) and library_device_ms: device work; host_us and
    # library_host_us: host enqueue. Each sums the kernel's two calls.
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n,
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"],
         "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
         "library_ms": r["library_ms"], "device_ms": r["device_ms"],
         **({"cold_ms": r["cold_ms"]} if name != "ell_sparse_pool" else {}),
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
    sys.exit(main())
