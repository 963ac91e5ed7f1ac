"""Exact K nearest points in the BEV plane: ContFuse's neighbour search.

``bev_knn(points, valid, queries, k, max_distance, area)`` gives, for every
frame and query point (x, z), the indices of the ``K`` = 3 valid points of
least squared BEV distance ``d2 = (px - qx)^2 + (pz - qz)^2`` within the
finite ``max_distance``, nearest first, ties to the lower point index; a slot beyond a query's candidates holds P, the frame's point slots
(an index one past the last, as ``bev_device.gather_points`` reads it). d2
is rounded in float32 at each operation, so the distances are the ones
these tensor ops give; ``r2``, the squared limit, is rounded to float32 once.

It is the operator ``torch.ops.spt.bev_knn``: a CUDA tensor launches
``csrc/bev_knn.cu`` (a counting sort of the points into square bins over
``area``, then one thread a query reading rings of bins until no nearer
point can remain; two kernels, one call), a CPU tensor runs
``bev_knn_plain``, every distance and K rounds of argmin. The two give the
same indices bit for bit; ``area`` sets only the bins, which decide the
kernel's work and never its answer. Nothing waits on the host, so a CUDA
graph captures it (``models.pipeline``'s input graphs).

``knn_counts()`` reads what the searches did in this process: the calls, the
queries and the distances they examined (on a card the kernel adds both to
two device counters; reading them waits for the card).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from sparse_pooling_tpu_torch import kernels

K = 3  # the one neighbour count the operator takes: ContFuse's (csrc/bev_knn.cu, kK)
BIN_M = 0.8  # the bins' side (m)
_CHUNK = 1 << 25  # the plain twin's distances a step

# the plain twin's queries and examined distances; the card's live in _DEVICE_COUNTS
_PLAIN_COUNTS = {"calls": 0, "queries": 0, "examined": 0}
_DEVICE_COUNTS: Dict[int, torch.Tensor] = {}


def squared_limit(k: int, max_distance: float) -> float:
    """The squared distance limit as float32 rounds it. Refuses a ``k``
    other than ``K`` and a limit that is not finite and positive."""

    if k != K:
        raise ValueError(f"bev_knn: k = {k}; the operator takes k = {K} only")
    if not 0 < max_distance < math.inf:
        raise ValueError(f"bev_knn: max_distance = {max_distance}; a finite limit above 0 is required")
    return float(np.float32(float(max_distance) ** 2))


def bev_knn_plain(points: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, k: int, max_distance: float,
                  x_min: float, x_max: float, z_min: float, z_max: float) -> torch.Tensor:
    """The kernel's twin in plain PyTorch: points [B, P, >=3] f32 (x at 0, z
    at 2), valid [B, P] bool, queries [Q, 2] f32 (x, z) -> [B, Q, k] int64.
    Every distance, a chunk of queries at a time, then k rounds of argmin
    (its first minimum: the lower index among equals)."""

    del x_min, x_max, z_min, z_max  # the kernel's bins; the answer does not depend on them
    r2 = squared_limit(k, max_distance)
    b, p = valid.shape
    q = queries.shape[0]
    out = torch.full((b, q, k), p, dtype=torch.int64, device=points.device)
    px, pz = points[..., 0], points[..., 2]
    step = max(1, _CHUNK // max(b * p, 1))
    for s in range(0, q if p else 0, step):
        qx, qz = queries[s:s + step, 0], queries[s:s + step, 1]
        dx = px[:, None, :] - qx[None, :, None]
        dz = pz[:, None, :] - qz[None, :, None]
        d2 = dx * dx + dz * dz
        d2 = torch.where(valid[:, None, :] & (d2 <= r2), d2, torch.inf)
        for kk in range(k):
            j = torch.argmin(d2, dim=-1)
            hit = torch.gather(d2, -1, j[..., None])[..., 0] < torch.inf
            out[:, s:s + step, kk] = torch.where(hit, j, p)
            d2.scatter_(-1, j[..., None], torch.inf)
    _PLAIN_COUNTS["calls"] += 1
    _PLAIN_COUNTS["queries"] += b * q
    _PLAIN_COUNTS["examined"] += q * int(valid.sum())
    return out


def bins(x_min: float, x_max: float, z_min: float, z_max: float) -> Tuple[int, int]:
    """(columns, rows) of the kernel's ``BIN_M`` bins over the area; refuses
    an area whose bins overflow the kernel's shared memory."""

    nbx, nbz = max(1, math.ceil((x_max - x_min) / BIN_M)), max(1, math.ceil((z_max - z_min) / BIN_M))
    if nbx * nbz > max_bins():
        raise ValueError(f"bev_knn: the area's {nbx}x{nbz} bins of {BIN_M} m exceed the kernel's {max_bins()}")
    return nbx, nbz


@functools.cache
def max_bins() -> int:
    """The most bins a frame the kernel takes. Read from the built library."""

    return kernels.library("bev_knn").bev_knn_max_bins()


def _device_counts(device: int) -> torch.Tensor:
    """The card's two counters (queries, examined distances), made at the
    first call on it (an eager call: a graph's capture runs the function
    eagerly first)."""

    counts = _DEVICE_COUNTS.get(device)
    if counts is None:
        counts = _DEVICE_COUNTS[device] = torch.zeros(2, dtype=torch.int64, device=torch.device("cuda", device))
    return counts


@kernels.counted
def bev_knn_kernel(points: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, k: int, max_distance: float,
                   x_min: float, x_max: float, z_min: float, z_max: float) -> torch.Tensor:
    """The KNN kernel on CUDA tensors, one call for the batch -> [B, Q, k]
    int64. B, P and Q are at least 1: an empty call launches nothing, and
    the operator answers it without this wrapper."""

    what = "bev_knn"
    device = kernels.require_cuda(points, valid, queries, what=what)
    if points.dim() != 3 or points.shape[2] < 3 or valid.shape != points.shape[:2]:
        raise ValueError(f"{what}: points [B,P,>=3] and valid [B,P] required")
    if queries.dim() != 2 or queries.shape[1] != 2:
        raise ValueError(f"{what}: queries [Q,2] required")
    if points.dtype != torch.float32 or queries.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{what}: points and queries float32, valid bool required")
    b, p, c = points.shape
    q = queries.shape[0]
    r2 = squared_limit(k, max_distance)
    nbx, nbz = bins(x_min, x_max, z_min, z_max)
    sorted_xz = points.new_empty((b, p, 2))
    sorted_id = points.new_empty((b, p), dtype=torch.int32)
    starts = points.new_empty((b, nbx * nbz + 1), dtype=torch.int32)
    out = points.new_empty((b, q, k), dtype=torch.int64)
    lib = kernels.library("bev_knn")
    rc = lib.bev_knn_launch(points.data_ptr(), b, p, c, valid.data_ptr(), queries.data_ptr(), q, k, x_min, z_min,
                            BIN_M, nbx, nbz, r2, math.sqrt(r2), sorted_xz.data_ptr(), sorted_id.data_ptr(),
                            starts.data_ptr(), out.data_ptr(), _device_counts(device).data_ptr(),
                            kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out


def _bev_knn_cuda(points, valid, queries, k, max_distance, x_min, x_max, z_min, z_max):
    """The operator on CUDA tensors: the kernel, or with no frame, point or
    query nothing to launch."""

    squared_limit(k, max_distance)
    b, p = valid.shape
    if b and p and queries.shape[0]:
        return bev_knn_kernel(points, valid, queries, k, max_distance, x_min, x_max, z_min, z_max)
    return torch.full((b, queries.shape[0], k), p, dtype=torch.int64, device=points.device)


kernels.OPS.define("bev_knn(Tensor points, Tensor valid, Tensor queries, int k, float max_distance, float x_min, "
                   "float x_max, float z_min, float z_max) -> Tensor")
kernels.OPS.impl("bev_knn", _bev_knn_cuda, "CUDA")
kernels.OPS.impl("bev_knn", lambda *a: bev_knn_plain(*a), "CPU")


@torch.library.register_fake("spt::bev_knn", lib=kernels.OPS)
def _bev_knn_fake(points, valid, queries, k, max_distance, x_min, x_max, z_min, z_max):
    return points.new_empty((valid.shape[0], queries.shape[0], k), dtype=torch.int64)


def bev_knn(points: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, k: int, max_distance: float,
            area: Tuple[float, float, float, float]) -> torch.Tensor:
    """``torch.ops.spt.bev_knn``: points [B, P, >=3] (x at 0, z at 2),
    valid [B, P], queries [Q, 2] (x, z), ``area`` (x_min, x_max, z_min,
    z_max) the kernel's bins cover -> [B, Q, k] int64 (k = ``K``), P where
    a query has fewer than k candidates within the finite ``max_distance``."""

    return torch.ops.spt.bev_knn(points.to(torch.float32).contiguous(), valid.contiguous(),
                                 queries.to(torch.float32).contiguous(), int(k), float(max_distance),
                                 *map(float, area))


def knn_counts() -> Dict[str, float]:
    """The searches of this process: ``calls`` (kernel launches and plain
    calls), ``queries`` (a frame's query points count once a frame),
    ``examined`` (the distances computed) and ``examined_per_query``. Reads
    the card's counters (a wait for the card)."""

    calls = _PLAIN_COUNTS["calls"] + bev_knn_kernel.launches
    queries, examined = _PLAIN_COUNTS["queries"], _PLAIN_COUNTS["examined"]
    for counts in _DEVICE_COUNTS.values():
        a, e = counts.tolist()
        queries, examined = queries + a, examined + e
    return {"calls": calls, "queries": queries, "examined": examined,
            "examined_per_query": examined / queries if queries else 0.0}
