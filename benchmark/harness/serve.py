"""Serving cells: one client in a closed loop, each request a batch of host
frames through the port's serving path, timed from the frames on the host to
the detections back on the host.

A request is the port's ``data.pointcloud.trim_points_to_bucket`` and
``models.pipeline.stack_frames``, then ``build_model_inputs_batch``, the
detector and ``decode_batch`` (``forward_batch_fn``'s serving body, called in
its parts so that the traced run can time each), then the detections copied to
the host. Set-up builds the kernels, the model and its seeded weights, the
traffic's frames, and runs two requests of every point bucket the traffic
will ask for. The window then runs requests back to back for ``--seconds``;
every request it finishes counts. With ``--trace 1`` CUDA events time each
request's stages, and a few more requests after the window run under
``torch.profiler``.

The judge needs the port's intermediate results: ``Recorder`` keeps a
reference to what the NMS calls, the fusion layers and the layers feeding the
heads return (wrappers of the family's port modules' NMS calls and a forward
hook a layer, a few microseconds a request), and a seeded reservoir keeps
the records of ``judge_requests`` requests, and the one with the most points,
copied to the host so that they do not raise the device's peak. A record's
slots: ``fused`` and ``features`` (the hooks' outputs, by the judge's keys),
``final`` (each ``nms_batch`` call's picks, a class each, in order) and, for
a two-stage family alone, ``rpn`` (its one ``top_k_nms_batch`` call's
picks); a request whose calls do not fill exactly the slots of the family's
``STAGES`` fails the run, naming the family and the slot. What differs
by detector family comes from the cell's family file
(``families/<architecture>.py``); each hand kernel whose calls the profiled
requests record has a file ``kernels/<op>.py``. With ``--trace 1`` the
program's own spans are read too (``spans.py``): after the window, before
any profiler.
"""

from __future__ import annotations

import importlib
import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch

from traffic import ServeSchedule, frame_pool

from . import devtrace, judge, spans, weights
from .flops import forward_flops
from .peaks import BF16_FLOPS


class Recorder:
    """Keeps what the port's timed path returns at the NMS calls and the
    fusion layers of the current request."""

    def __init__(self, model, family, architecture: str):
        self.current: Dict = {}
        self.stages, self.architecture = family.STAGES, architecture
        self._undo = []
        self._modules = family.PORT_NMS_MODULES
        for module in map(importlib.import_module, family.PORT_NMS_MODULES):
            for name in ("top_k_nms_batch", "nms_batch"):
                if hasattr(module, name):
                    self._wrap(module, name)
        modules = dict(model.named_modules())
        for group, layers in (("fused", judge.fusion_layers(model, family)),
                              ("features", judge.feature_layers(model, family))):
            for key, name in layers.items():
                self._undo.append(modules[name].register_forward_hook(self._hook(group, key)).remove)

    def _wrap(self, module, name):
        orig = getattr(module, name)
        slot = "rpn" if name == "top_k_nms_batch" else "final"

        def wrapper(*args, **kwargs):
            res = orig(*args, **kwargs)
            if slot == "rpn":
                self.current["rpn"] = (res.indices, res.valid)
            else:
                self.current.setdefault("final", []).append((res.indices, res.valid))
            return res

        setattr(module, name, wrapper)
        self._undo.append(lambda: setattr(module, name, orig))

    def _hook(self, group, key):
        def hook(_module, _args, output):
            self.current.setdefault(group, {})[key] = output
        return hook

    def picks(self) -> Dict:
        """The current request's pick slots: ``final``, and ``rpn`` for two
        stages; raises where the calls made other slots."""

        cur = self.current
        if self.stages == 1 and "rpn" in cur:
            raise RuntimeError(f"family {self.architecture!r} has one stage, yet its timed path called "
                               "top_k_nms_batch: a one-stage record has no 'rpn' slot")
        for slot in ("rpn", "final") if self.stages == 2 else ("final",):
            if slot not in cur:
                call = "top_k_nms_batch" if slot == "rpn" else "nms_batch"
                raise RuntimeError(f"family {self.architecture!r} ({self.stages} stage(s)) made no {call} call "
                                   f"in {', '.join(self._modules)}: its record misses the {slot!r} slot")
        return {slot: cur[slot] for slot in ("rpn", "final") if slot in cur}

    def close(self):
        for undo in reversed(self._undo):
            undo()


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


class Reservoir:
    """A seeded uniform sample of ``k`` requests, and the request with the
    most points."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([int(seed), 3])
        self.slots: List[Dict] = []
        self.longest, self.longest_points = None, -1

    def offer(self, i: int, points: int, make):
        j = i if i < self.k else int(self.rng.integers(0, i + 1))
        if j >= self.k and points <= self.longest_points:
            return
        rec = make()
        if j < self.k:
            if i < self.k:
                self.slots.append(rec)
            else:
                self.slots[j] = rec
        if points > self.longest_points:
            self.longest, self.longest_points = rec, points

    def records(self) -> List[Dict]:
        seen = {r["request"] for r in self.slots}
        return self.slots + ([self.longest] if self.longest["request"] not in seen else [])


class ServeRun:
    def __init__(self, cell, seed: int, device, trace: bool):
        from sparse_pooling_tpu_torch import kernels
        from sparse_pooling_tpu_torch.configs.config import AreaExtents, pipeline_config_from_dict
        from sparse_pooling_tpu_torch.data.pointcloud import trim_points_to_bucket
        from sparse_pooling_tpu_torch.models import pipeline as pl

        self.cell, self.seed, self.device, self.trace = cell, int(seed), device, trace
        self.family = cell.family
        self.pl, self.trim = pl, trim_points_to_bucket
        # op -> (port module, launcher attribute, bound) of each hand kernel's file
        self.hand_modules = {op: (importlib.import_module(k.PORT[0]), k.PORT[1], k.bound)
                             for op, k in cell.kernels().items()}
        if device.type == "cuda":
            kernels.build_all()
        self.cfg = pipeline_config_from_dict(cell.config["pipeline"]).model
        self.ext = AreaExtents(**cell.config["extents"])
        self.model = pl.make_model(self.cfg, self.ext, device=device)
        self.state = weights.seeded_state(self.model, self.seed, device)
        self.model.load_state_dict(self.state)
        self.anchors = pl.static_anchor_grid(self.cfg, self.ext, device=device)
        self.mix = cell.traffic
        self.frames = frame_pool(self.mix, self.cfg, self.seed, self.family)
        self.schedule = ServeSchedule(self.mix, self.seed)
        self.recorder = Recorder(self.model, self.family, cell.model_cfg.architecture)
        self.reservoir = Reservoir(int(cell.workload["judge_requests"]), self.seed)
        self.inputs = judge.input_keys(self.family)
        # the yardstick's counts read the reference's parse of the configuration
        self.flops_per_frame = forward_flops(cell.model_cfg, self.ext, self.family)
        self.nms_rounds = int(self.family.nms_rounds(cell.model_cfg))

    # one request ---------------------------------------------------------
    def request(self, ids: List[int], events=None, ranges=False) -> Dict[str, np.ndarray]:
        pl = self.pl

        def stage(name):
            return torch.profiler.record_function(devtrace.STAGE_PREFIX + name) if ranges else nullcontext()

        with stage("host"):
            frames = [self.frames[i] for i in ids]
            pts, mask = self.trim(np.stack([f["points"] for f in frames]),
                                  np.stack([f["points_mask"] for f in frames]), self.cfg.sparse_pool.buckets)
            batch = pl.stack_frames([dict(f, points=p, points_mask=m) for f, p, m in zip(frames, pts, mask)],
                                    device=self.device)
            keep = torch.ones((len(ids), 2), dtype=torch.float32, device=self.device)
        self.recorder.current = {}
        with torch.no_grad():
            if events:
                events[0].record()
            with stage("inputs"):
                inputs = pl.build_model_inputs_batch(batch, self.anchors, keep, self.cfg, self.ext)
            if events:
                events[1].record()
            with stage("detector"):
                out = self.model(inputs)
            if events:
                events[2].record()
            with stage("decode"):
                det = pl.decode_batch(out, batch.ground_plane, self.cfg, self.ext)
            if events:
                events[3].record()
        with stage("readback"):
            host = {k: det[k].cpu().numpy() for k in ("boxes_3d", "scores", "valid")}
        self._last = (inputs, out, host)
        return host

    def _record(self, i: int, ids: List[int]) -> Dict:
        inputs, out, host = self._last
        cur = self.recorder.current
        return _host({
            "request": i, "ids": list(ids),
            "inputs": {k: judge.recorded_input(inputs[k]) for k in self.inputs},
            "fused": cur["fused"], "features": cur["features"], **self.recorder.picks(),
            "out": {k: out[k] for k in judge.OUT_KEYS if k in out},
            "det": {k: torch.from_numpy(v) for k, v in host.items()},
        })

    def segments(self) -> int:
        """Device memory segments the caching allocator has reserved so far
        (one ``cudaMalloc`` each); 0 off the card."""

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_stats(self.device).get("segment.all.allocated", 0))

    def warm_up(self, horizon: int = 4096, settle: int = 8, most: int = 256) -> None:
        """Two requests of every point bucket the first ``horizon`` requests
        of the schedule use; then the schedule's own requests in order, the
        buckets alternating as the window will have them, for one pass over
        the frame pool and on until ``settle`` requests in a row have made
        the allocator reserve no new segment (at most ``most``)."""

        by_bucket = {}
        for i in range(horizon):
            ids = self.schedule.request(i)
            n = max(int(self.frames[j]["points_mask"].sum()) for j in ids)
            bucket = next(b for b in self.cfg.sparse_pool.buckets if b >= n)
            by_bucket.setdefault(bucket, ids)
        for ids in by_bucket.values():
            for _ in range(2):
                self.request(ids)
        one_pass = -(-len(self.frames) // self.schedule.batch)
        quiet, i = 0, 0
        while i < most and (i < one_pass or quiet < settle):
            before = self.segments()
            self.request(self.schedule.request(i))
            quiet = quiet + 1 if self.segments() == before else 0
            i += 1
        self.warm_requests = i

    # the window ----------------------------------------------------------
    def window(self, seconds: float) -> Dict:
        lat, spans, failed, kept_s = [], [], 0, 0.0
        timed = self.trace and self.device.type == "cuda"
        i = 0
        segments = self.segments()
        t0 = time.perf_counter()
        while True:
            ids = self.schedule.request(i)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else None
            s = time.perf_counter()
            host = self.request(ids, events)
            e = time.perf_counter()
            lat.append((e - s) * 1e3)
            if not all(np.isfinite(v).all() for v in host.values()):
                failed += 1
            if events:
                spans.append(events)
            points = sum(int(self.frames[j]["points_mask"].sum()) for j in ids)
            k0 = time.perf_counter()
            self.reservoir.offer(i, points, lambda: self._record(i, ids))
            kept_s += time.perf_counter() - k0
            i += 1
            if e - t0 >= seconds:
                break
        t1 = time.perf_counter()
        stage_ms = {}
        if spans:
            torch.cuda.synchronize(self.device)
            for k, name in enumerate(("inputs", "detector", "decode")):
                stage_ms[name] = [ev[k].elapsed_time(ev[k + 1]) for ev in spans]
        return {"latency_ms": lat, "requests": i, "failed": failed, "seconds": t1 - t0, "kept_s": kept_s,
                "frames": i * self.schedule.batch, "stage_ms": stage_ms,
                "new_segments": self.segments() - segments}

    def profile(self, n_requests: int, first: int) -> Dict:
        """``n_requests`` more requests under torch.profiler, with each hand
        kernel's calls recorded for its bound."""

        from torch.profiler import ProfilerActivity, profile

        calls = {name: [] for name in self.hand_modules}
        originals = {}
        for name, (module, attr, _) in self.hand_modules.items():
            orig = originals[name] = getattr(module, attr)

            def rec(*args, _orig=orig, _store=calls[name], **kwargs):
                _store.append(args)
                return _orig(*args, **kwargs)
            setattr(module, attr, rec)
        try:
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            with profile(activities=activities) as prof:
                with torch.profiler.record_function(devtrace.WINDOW):
                    for k in range(n_requests):
                        self.request(self.schedule.request(first + k), ranges=True)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        finally:
            for name, (module, attr, _) in reversed(list(self.hand_modules.items())):
                setattr(module, attr, originals[name])
        trace = devtrace.reduce(prof.events())
        trace["requests"] = n_requests
        trace["bounds"] = {name: [self.hand_modules[name][2](*args) for args in store]
                           for name, store in calls.items()}
        return trace

    def release(self) -> None:
        """Frees the program's state; the records and weights stay."""

        self.recorder.close()
        del self.model, self.anchors, self._last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock) -> Dict:
    """One run of a serving cell -> the harness's result pieces."""

    srv = ServeRun(cell, seed, device, trace)
    srv.warm_up()
    setup_s = setup_clock()
    win = srv.window(seconds)
    prof, span_data = {}, None
    if trace:
        profiled = int(cell.workload["profiled_requests"])
        # the spans before any profiler session: one slows the requests after it
        collected = spans.collected(srv, win["requests"])
        prof = srv.profile(profiled, win["requests"])
        span_data = {"collected": collected,
                     "profiled": spans.profiled(srv, win["requests"] + spans.SPAN_REQUESTS, profiled)}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    srv.release()
    ref = judge.Reference(cell, srv.state, device)
    readings = judge.judge(srv.reservoir.records(), srv.frames, ref)
    run_data = {
        "kind": "serve", "window": win, "profile": prof, "spans": span_data, "setup_s": setup_s,
        "warm_requests": srv.warm_requests,
        "flops_per_frame": srv.flops_per_frame, "peak_flops": BF16_FLOPS,
        "serve_ms_p50": percentile(win["latency_ms"], 50), "serve_ms_p95": percentile(win["latency_ms"], 95),
    }
    return {"run": run_data, "readings": readings, "attempted": win["requests"], "failed": win["failed"],
            "memory_peak_bytes": int(peak)}
