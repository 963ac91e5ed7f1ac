"""Evaluation on one card or a data-parallel mesh: checkpoint sweep ->
KITTI predictions -> AP.

Port of ``sparse_pooling_tpu.runtime.evaluator``. ``run_checkpoint_once``
restores one checkpoint into the serving model (parameters in the compute
dtype: ``load_state_dict`` casts the trainer's f32 ones), runs the dataset's
split in batches of ``eval.batch_size`` through ``forward_batch_fn`` +
``decode_batch``, writes one KITTI txt per frame in raw image coordinates
under ``<workdir>/predictions/kitti_native_eval/<thresh>/<step>/data/``
(with ``eval.save_rpn_proposals`` also
``predictions/proposals_and_scores/<step>/<sid>.txt``) and scores AP with
the native evaluator (``native/kitti_eval``); ``repeated_checkpoint_run``
evaluates every checkpoint not yet listed in ``evaluated_steps.txt``.

The sweep's threads: ``eval.num_workers`` loader threads within a batch
(the tail batch padded by repeating its last sample), the
``DevicePrefetcher``'s worker (depth 2), the dispatch thread, which packs
each batch's detections on the card and copies them into a pinned host
buffer without blocking, with an event after the copy, and a writer thread
(``eval.async_writer``) that waits on each event before it reads the buffer
and writes the files. ``eval.inflight_batches`` batches are dispatched
before the dispatch thread hands a group of ``eval.readback_group`` batches
to the writer; a pinned buffer is reused only after the writer has read it.

The AP backend is always the native evaluator: a failed build or load
raises (the numpy oracle, ``runtime.metrics``, is its twin in the tests).
Before the AP, the first val frame's predictions and ground truth are drawn
on its image (``demos.vis_utils.draw_boxes_3d``) into the image summary
``eval_summaries/images/predictions_<sid>_<step>.png``; a drawing that fails
prints and never fails the sweep.

In a process group with ``eval.data_parallel`` set, the evaluator lays
``parallel.mesh.auto_mesh(eval.batch_size)`` over the world (data axis
only, the model replicated on every rank, as the JAX evaluator's mesh):
each rank loads and runs its rows of every global val batch, the tail batch
padded as one process pads it, and writes its own frames' files; after a
barrier rank 0 scores AP and writes ``eval_<step>.json`` and
``evaluated_steps.txt``, and every rank returns its result. Rank 0 decides
which checkpoints a sweep takes, so the ranks never disagree on them.
Without a process group, with ``eval.data_parallel`` set and more cards
visible, the evaluator says that it evaluates on one and names
``run_evaluation``, which starts one rank per card.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sparse_pooling_tpu_torch import resolve_device
from sparse_pooling_tpu_torch.configs.config import AreaExtents, PipelineConfig
from sparse_pooling_tpu_torch.data.dataset import KittiDataset
from sparse_pooling_tpu_torch.data.prefetch import DevicePrefetcher
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.native import kitti_eval, pred_format
from sparse_pooling_tpu_torch.parallel import mesh as mesh_mod
from sparse_pooling_tpu_torch.parallel import multihost
from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
from sparse_pooling_tpu_torch.runtime import predictions as pred_mod
from sparse_pooling_tpu_torch.runtime.summary import SummaryWriter


class _PinnedPool:
    """Host buffers for the readback, pinned on a card, reused by shape once
    their reader gives them back."""

    def __init__(self, pin: bool):
        self._pin, self._free, self._lock = pin, {}, threading.Lock()

    def take(self, shape) -> torch.Tensor:
        with self._lock:
            free = self._free.get(tuple(shape))
            if free:
                return free.pop()
        return torch.empty(tuple(shape), dtype=torch.float32, pin_memory=self._pin)

    def give(self, bufs) -> None:
        with self._lock:
            for b in bufs:
                self._free.setdefault(tuple(b.shape), []).append(b)


def raw_p2(sample, canvas_hw) -> np.ndarray:
    """The frame's P2 for raw image coordinates: the canvas-scaled P2 with
    its rows divided by the canvas / raw ratios, in float64."""

    sy = canvas_hw[0] / sample.raw_image_hw[0]
    sx = canvas_hw[1] / sample.raw_image_hw[1]
    p2 = sample.p2.astype(np.float64).copy()
    p2[0] /= sx
    p2[1] /= sy
    return p2


class Evaluator:
    def __init__(self, cfg: PipelineConfig, dataset: Optional[KittiDataset] = None,
                 extents: AreaExtents = AreaExtents(), workdir: Optional[str] = None, device="cuda"):
        self.cfg, self.extents = cfg, extents
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.dataset = KittiDataset(cfg.dataset, cfg.model, extents) if dataset is None else dataset
        self.workdir = workdir or os.path.join(cfg.experiments_dir, cfg.checkpoint_name)
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        self.mesh: Optional[mesh_mod.Mesh] = None
        self.rank, self.idle = 0, False
        if dist.is_available() and dist.is_initialized():
            self.rank = dist.get_rank()
            if cfg.eval.data_parallel:
                self.mesh = mesh_mod.auto_mesh(max(cfg.eval.batch_size, 1))
            self.idle = not self.mesh.member if self.mesh is not None else self.rank != 0
            if self.mesh is not None and self.rank == 0:
                print(f"[evaluator] mesh data={self.mesh.n_data} (batch {cfg.eval.batch_size} split) over "
                      f"{self.mesh.size} of {dist.get_world_size()} ranks")
        elif cfg.eval.data_parallel and torch.cuda.device_count() > 1:
            print(f"[evaluator] eval.data_parallel is set and {torch.cuda.device_count()} cards are visible, "
                  f"but this process has no process group: it evaluates on one ({self.device}). To use all "
                  "of them, run experiments.run_evaluation (it starts one rank per card)")
        # built now: a failed build raises before a sweep, and no sweep's clock pays for it
        pred_format.library()
        kitti_eval.library()
        self.model = pl.make_model(cfg.model, extents, device=self.device)
        self.anchors_static = pl.static_anchor_grid(cfg.model, extents, device=self.device)
        self.summary = SummaryWriter(os.path.join(self.workdir, "eval_summaries")) if self.rank == 0 else None
        # the last run's phase breakdown (seconds): consumer, writer, worker, loader
        self.phases: Dict[str, float] = {}
        self.loader_timings: Dict[str, float] = {}

    # ------------------------------------------------------------ forward
    def eval_batch(self, batch: pl.RawSample, with_proposals: bool = False) -> List[torch.Tensor]:
        """Forward + decode of one batch on its device, packed there:
        detections [B, C, K, 9] f32 (boxes_3d, score, valid) and, with
        proposals, [B, P, 8] (anchor form, objectness score, valid)."""

        mc = self.cfg.model
        out = pl.forward_batch_fn(self.model, batch, self.anchors_static, mc, self.extents)
        det = pl.decode_batch(out, batch.ground_plane, mc, self.extents)
        packed = [torch.cat([det["boxes_3d"].float(), det["scores"].float()[..., None],
                             det["valid"].float()[..., None]], dim=-1)]
        if with_proposals:
            packed.append(torch.cat([out["proposals"].float(), out["proposal_scores"].float()[..., None],
                                     out["proposal_valid"].float()[..., None]], dim=-1))
        return packed

    @staticmethod
    def _unpack_det(packed: np.ndarray) -> Dict[str, np.ndarray]:
        """Host inverse of the packing of :meth:`eval_batch`."""

        return {"boxes_3d": packed[..., :7], "scores": packed[..., 7], "valid": packed[..., 8] > 0.5}

    def _host_batches(self, batch_size: int, rows: Optional[slice] = None):
        """Yield (stacked arrays in ``RawSample`` order, (ids, samples)) over
        the split in order, without augmentation. The samples of a batch load
        on ``eval.num_workers`` threads (at most the host's cores): the PNG
        inflate and the native decode and point filter release the GIL. The
        tail batch is padded by repeating its last sample and its canvas
        row; ``ids`` holds only the real frames, and the writer skips the
        rest. With ``rows`` only those rows of each padded batch load (a
        data-parallel rank's; rows wholly past the real frames load the
        last real frame once). ``loader_timings``: the loads' wall time and
        their CPU time summed over threads (wall far above CPU / threads
        means the threads wait, on the GIL or the scheduler), and the same
        for stacking."""

        ids = list(self.dataset.sample_ids)
        workers = max(min(int(self.cfg.eval.num_workers), os.cpu_count() or 1), 1)
        lt = self.loader_timings = {"load_wall": 0.0, "load_cpu": 0.0, "stack_wall": 0.0, "stack_cpu": 0.0}

        def load(sid, canvas):
            c0 = time.thread_time()
            sample = self.dataset.load_sample(sid, augment_seed=None, image_out=canvas)
            return sample, time.thread_time() - c0

        with ThreadPoolExecutor(max_workers=workers) as pool:
            for start in range(0, len(ids), batch_size):
                chunk = ids[start:start + batch_size]
                last, n_rows = chunk[-1], batch_size
                if rows is not None:  # the real frames among this rank's rows of the padded batch
                    chunk, n_rows = chunk[rows], len(range(batch_size)[rows])
                t0 = time.perf_counter()
                canvas_b = self.dataset.alloc_image_batch(n_rows)
                loaded = list(pool.map(load, chunk or [last], canvas_b))
                lt["load_wall"] += time.perf_counter() - t0
                lt["load_cpu"] += sum(cpu for _, cpu in loaded)
                samples = [s for s, _ in loaded]
                for j in range(len(samples), n_rows):
                    canvas_b[j] = canvas_b[len(samples) - 1]
                samples += [samples[-1]] * (n_rows - len(samples))
                t0, c0 = time.perf_counter(), time.thread_time()
                arrays = self.dataset.stack_samples(samples, image_batch=canvas_b)
                lt["stack_wall"] += time.perf_counter() - t0
                lt["stack_cpu"] += time.thread_time() - c0
                yield arrays, (chunk, samples)

    # ------------------------------------------------------------ one ckpt
    def run_checkpoint_once(self, step: int, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """Evaluate the checkpoint of ``step`` (or ``state_dict``, a model
        state dict, in its place): write its predictions, score AP, write
        ``eval_<step>.json`` and the scalars; returns the result. On a mesh
        each rank writes its rows' frames and rank 0 scores the whole split
        (every rank returns rank 0's result); a rank with no rows returns None."""

        cfg = self.cfg
        if self.idle:
            return None
        if state_dict is None:
            state_dict = ckpt_mod.restore(self.ckpt_dir, step, map_location="cpu")["model"]
        self.model.load_state_dict(state_dict)
        save_props = bool(cfg.eval.save_rpn_proposals)
        thresh = cfg.eval.kitti_score_threshold
        pred_dir = os.path.join(self.workdir, "predictions", "kitti_native_eval", f"{thresh:g}", str(step), "data")
        os.makedirs(pred_dir, exist_ok=True)
        prop_dir = os.path.join(self.workdir, "predictions", "proposals_and_scores", str(step))
        if save_props:
            os.makedirs(prop_dir, exist_ok=True)
        canvas_hw = (cfg.model.image.height, cfg.model.image.width)
        cuda = self.device.type == "cuda"
        bsz = max(cfg.eval.batch_size, 1)
        ph = self.phases = {"wait": 0.0, "dispatch": 0.0, "submit": 0.0, "readback": 0.0, "write": 0.0}
        pool = _PinnedPool(pin=cuda)
        n = 0
        t0 = time.time()

        def drain(entries):
            """Wait for a group's copies, then write its frames' files."""

            nonlocal n
            t_ph = time.perf_counter()
            for event, _, _, _ in entries:
                if event is not None:
                    event.synchronize()
            ph["readback"] += time.perf_counter() - t_ph
            t_ph = time.perf_counter()
            for _, bufs, chunk, samples in entries:
                det_b = self._unpack_det(bufs[0].numpy())
                props = bufs[1].numpy() if save_props else None
                for i, sid in enumerate(chunk):
                    det = {k: v[i] for k, v in det_b.items()}
                    pred_mod.write_predictions(pred_dir, sid, det, cfg.model.classes,
                                               raw_p2(samples[i], canvas_hw), samples[i].raw_image_hw,
                                               score_threshold=thresh)
                    if props is not None:
                        rows = props[i]  # [P, 8]: anchor form, score, valid
                        np.savetxt(os.path.join(prop_dir, sid + ".txt"), rows[rows[:, 7] > 0.5, :7],
                                   fmt="%.6f")
                    n += 1
                pool.give(bufs)
            ph["write"] += time.perf_counter() - t_ph

        group = max(int(cfg.eval.readback_group), 1)
        depth = max(int(cfg.eval.inflight_batches), 1) + group - 1
        writer_q: queue.Queue = queue.Queue(maxsize=2)
        writer_err: list = []

        def writer_loop():
            while True:
                entries = writer_q.get()
                if entries is None:
                    return
                if not writer_err:
                    try:
                        drain(entries)
                    except BaseException as e:  # re-raised on the dispatch thread
                        writer_err.append(e)

        writer = threading.Thread(target=writer_loop, daemon=True) if cfg.eval.async_writer else None

        def emit(entries):
            if writer is None:
                drain(entries)
                return
            t_ph = time.perf_counter()
            writer_q.put(entries)
            ph["submit"] += time.perf_counter() - t_ph
            if writer_err:
                raise writer_err[0]

        rows = None if self.mesh is None else mesh_mod.batch_rows(self.mesh, bsz)
        prefetch = DevicePrefetcher(self._host_batches(bsz, rows), depth=2, device=self.device,
                                    transform=lambda item: (pl.RawSample(*item[0]), item[1]))
        inflight: deque = deque()
        if writer is not None:
            writer.start()
        try:
            with prefetch, torch.inference_mode():  # the worker is released if a batch raises
                t_it = time.perf_counter()
                for batch, (chunk, samples) in prefetch:
                    ph["wait"] += time.perf_counter() - t_it
                    t_ph = time.perf_counter()
                    packed = self.eval_batch(batch, with_proposals=save_props)
                    bufs = [pool.take(p.shape) for p in packed]
                    for buf, p in zip(bufs, packed):
                        buf.copy_(p, non_blocking=cuda)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(torch.cuda.current_stream(self.device))
                    inflight.append((event, bufs, chunk, samples))
                    ph["dispatch"] += time.perf_counter() - t_ph
                    if len(inflight) >= depth:
                        emit([inflight.popleft() for _ in range(group)])
                    t_it = time.perf_counter()
                while inflight:
                    emit([inflight.popleft() for _ in range(min(group, len(inflight)))])
        finally:
            if writer is not None:
                writer_q.put(None)
                writer.join()
        if writer_err:
            raise writer_err[0]
        n_here = n
        if self.mesh is not None:  # every rank's files are written before rank 0 scores
            dist.barrier(group=self.mesh.group)
            total = torch.tensor([float(n)], device=multihost.collective_device())
            dist.all_reduce(total, group=self.mesh.group)
            n = int(total.item())
        dt = time.time() - t0
        if self.rank != 0:
            return self._from_rank0(None)
        wk, lt = prefetch.timings, self.loader_timings
        self.phases.update(load=wk["load"], put=wk["put"])
        print(f"[evaluator] phase breakdown over {dt:.2f}s: consumer wait {ph['wait']:.2f} / dispatch "
              f"{ph['dispatch']:.2f} / submit {ph['submit']:.2f}; writer readback {ph['readback']:.2f} / "
              f"txt write {ph['write']:.2f}; worker load {wk['load']:.2f} / put {wk['put']:.2f}")
        print(f"[evaluator] loader detail: load wall {lt['load_wall']:.2f} cpu {lt['load_cpu']:.2f} "
              f"(summed over threads); stack wall {lt['stack_wall']:.2f} cpu {lt['stack_cpu']:.2f}")

        # image summary: the first val frame with drawn predictions (reference:
        # prediction-image summaries in summary_utils)
        try:
            self._image_summary(step, pred_dir, self.dataset.sample_ids[0])
        except Exception as e:  # rendering must never fail an eval sweep
            print(f"[evaluator] image summary failed: {e}")

        ap = kitti_eval.evaluate_dirs(os.path.join(self.dataset.base, "label_2"), pred_dir,
                                      cfg.model.classes, n_points=cfg.eval.ap_n_points)
        fps = n / max(dt, 1e-9)
        where = "" if self.mesh is None else f" over {self.mesh.n_data} ranks ({n_here} on rank 0)"
        print(f"[evaluator] step {step}: {n} frames in {dt:.2f}s = {fps:.1f} fps (batch {bsz}{where}, incl. "
              f"host IO), AP backend: native_cpp")
        result = {"step": step, "num_frames": n, "seconds": dt, "frames_per_sec": fps,
                  "ap_backend": "native_cpp", "ap": ap}
        flat = {"eval_fps": fps}
        for cls, metrics in ap.items():
            for metric, diffs in metrics.items():
                for dname, v in diffs.items():
                    flat[f"AP_{cls}_{metric}_{dname}"] = v
        self.summary.scalars(step, flat)
        with open(os.path.join(self.workdir, f"eval_{step}.json"), "w") as f:
            json.dump(result, f, indent=2)
        return self._from_rank0(result)

    def _image_summary(self, step: int, pred_dir: str, sid: str) -> None:
        from sparse_pooling_tpu_torch.data import calib as calib_mod
        from sparse_pooling_tpu_torch.data import labels as labels_mod
        from sparse_pooling_tpu_torch.demos import vis_utils
        from sparse_pooling_tpu_torch.native.sample_loader import decode_png

        base = self.dataset.base
        preds = labels_mod.read_labels(os.path.join(pred_dir, sid + ".txt"))
        cal = calib_mod.read_calibration(os.path.join(base, "calib", sid + ".txt"))
        img = decode_png(os.path.join(base, "image_2", sid + ".png"))
        gt = labels_mod.read_labels(os.path.join(base, "label_2", sid + ".txt"))
        out = vis_utils.draw_boxes_3d(img, preds, cal.p2)
        out = vis_utils.draw_boxes_3d(out, gt, cal.p2, color_key="gt")
        self.summary.image(step, f"predictions/{sid}", out)

    def _from_rank0(self, value):
        """Rank 0's ``value`` on every rank of the mesh (as is without one)."""

        if self.mesh is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.mesh.group)
        return box[0]

    # ------------------------------------------------------------ sweep
    def repeated_checkpoint_run(self, poll_seconds: float = 30.0, max_wait: float = 0.0) -> List[Dict]:
        """Evaluate every checkpoint as it appears. ``max_wait`` 0 evaluates
        what exists and returns; above 0 it keeps polling until that many
        seconds pass with no new checkpoint."""

        done_path = os.path.join(self.workdir, "evaluated_steps.txt")
        done = set()
        if os.path.exists(done_path):
            with open(done_path) as f:
                done = {int(line) for line in f if line.strip()}
        idle_since = time.time()
        results = []
        if self.idle:
            return results
        while True:
            new = self._from_rank0([s for s in ckpt_mod.all_steps(self.ckpt_dir) if s not in done])
            for step in new:
                results.append(self.run_checkpoint_once(step))
                done.add(step)
                if self.rank == 0:
                    with open(done_path, "a") as f:
                        f.write(f"{step}\n")
                idle_since = time.time()
            if not new:
                if self._from_rank0(max_wait <= 0 or time.time() - idle_since > max_wait):
                    break
                time.sleep(poll_seconds)
        return results
