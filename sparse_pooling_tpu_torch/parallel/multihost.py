"""Process-group initialization for multi-card and multi-host training.

Port of ``sparse_pooling_tpu.parallel.multihost``. The JAX package joins
its processes through ``jax.distributed.initialize``; here each card is one
process, joined through ``torch.distributed.init_process_group``.
``run_training --multihost`` calls :func:`initialize` (in each process that
torchrun or another launcher starts), after which ``parallel.mesh`` lays
the ``(data, model)`` grid over the world's ranks.

The backend is chosen up front from the device, never after a failure:
``nccl`` for a card, ``gloo`` for the CPU. A caller may name ``gloo`` for
CUDA tensors (two ranks that share one card: NCCL refuses that). The group
has a finite timeout, so a rank whose peer died raises instead of waiting
for ever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def default_backend(device=None) -> str:
    """``nccl`` for a CUDA device (default: a card if one is present),
    ``gloo`` for the CPU."""

    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join (or start) the process group.

    Arguments default to torchrun's environment: ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``. On a card, the process takes the card of
    ``LOCAL_RANK`` (default: its rank modulo the cards visible) through
    ``torch.cuda.set_device``. ``backend`` defaults to
    ``default_backend(device)``. Raises ``RuntimeError`` naming what is
    missing when neither the arguments nor the environment give a world.
    """

    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    missing = [name for name, value in (("coordinator address (MASTER_ADDR and MASTER_PORT)", coordinator_address),
                                        ("world size (WORLD_SIZE)", world), ("rank (RANK)", rank))
               if value is None]
    if missing:
        raise RuntimeError(
            "multihost.initialize: no world given; pass coordinator_address, num_processes and "
            "process_id, or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (torchrun sets them). "
            "Missing: " + ", ".join(missing))
    backend = backend or default_backend(device)
    if backend == "nccl" or (device is not None and torch.device(device).type == "cuda"):
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def process_info() -> str:
    """This process's rank in the world and the cards it sees."""

    local_cards = torch.cuda.device_count()
    if not (dist.is_available() and dist.is_initialized()):
        return f"process 0/1 (no process group): {local_cards} local cards"
    card = f"cuda:{torch.cuda.current_device()}" if local_cards else "cpu"
    return (f"process {dist.get_rank()}/{dist.get_world_size()} ({dist.get_backend()}) on {card}: "
            f"{local_cards} local cards, {dist.get_world_size()} ranks in the world")


def collective_device() -> torch.device:
    """The device of the tensors the world's backend reduces: this process's
    card under NCCL, else the CPU."""

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_collective(device=None) -> float:
    """One all-reduce of ones over the world on ``device`` (default
    ``collective_device()``); raises unless it sums to the world size.
    Returns the sum."""

    device = collective_device() if device is None else torch.device(device)
    t = torch.ones(4, device=device)
    dist.all_reduce(t)
    got = t.tolist()
    if any(v != dist.get_world_size() for v in got):
        raise RuntimeError(f"all_reduce of ones over {dist.get_world_size()} ranks gave {got}")
    return got[0]


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
