"""Start a group of ranks on this host and wait for all of them, or none.

``spawn(fn, world, ...)`` starts ``world`` processes (``torch.multiprocessing``,
the ``spawn`` start method), joins them into one process group on a free
local port and calls ``fn(rank, *args)`` in each. The parent waits with a
deadline: when a rank exits non-zero or the deadline passes, it kills the
survivors (a rank left alone would wait in a collective until the group's
timeout) and raises. Each rank's return value comes back through a file.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from sparse_pooling_tpu_torch.parallel import multihost


def free_port() -> int:
    """A TCP port free on localhost now (bound to port 0 and released)."""

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn, rank: int, world: int, port: int, backend: str, device: Optional[str], threads: int,
            timeout_s: float, out_dir: str, args) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank % max(torch.cuda.device_count(), 1)))
    if threads > 0:
        torch.set_num_threads(threads)
    multihost.initialize(backend=backend, device=device,
                         timeout_s=min(timeout_s, multihost.DEFAULT_TIMEOUT_S))
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        multihost.shutdown()


def _exits(bad) -> str:
    return "; ".join(f"rank {r} exited with code {code}" for r, code in bad)


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), backend: str = "gloo", device: Optional[str] = None,
          timeout_s: float = 300.0, threads: int = 0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` ranks; returns their results in
    rank order. ``fn`` must be importable (a module-level function).
    ``device`` "cuda" puts rank r on card ``r`` modulo the cards visible
    (``LOCAL_RANK``; ranks share a card only over gloo); ``threads`` > 0 sets each
    rank's intra-op threads. The parent's deadline is ``timeout_s``; a
    collective gives up after the smaller of it and
    ``multihost.DEFAULT_TIMEOUT_S``."""

    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="spt_ranks_") as out_dir:
        procs = [ctx.Process(target=_worker, args=(fn, r, world, port, backend, device, threads, timeout_s,
                                                   out_dir, tuple(args)), daemon=False)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    failure = _exits(bad)
                    break
                if time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        if failure is None:
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failure = _exits(bad)
        if failure is not None:
            raise RuntimeError(f"spawn of {world} ranks of {getattr(fn, '__name__', fn)} failed: {failure}")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False) for r in range(world)]
