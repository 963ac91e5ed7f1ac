"""The ``(data, model)`` grid of ranks and the sharding layout.

Port of ``sparse_pooling_tpu.parallel.mesh``. In the JAX package one
process lays its devices out as a ``(data, model)`` mesh and XLA inserts the
collectives; here every rank is one process with one card (or one CPU
share), and the grid is a set of ``torch.distributed`` process groups:

  * **data axis**: the batch is split over it; ``DistributedDataParallel``
    averages the gradients over the data group;
  * **model axis**: tensor parallelism for the stage-2 FC stack (the
    detector's only wide matmuls); each model rank keeps a column shard of
    every FC and gathers the full width after it
    (``parallel.tensor_parallel``).

Global rank ``r = d * n_model + m`` sits at data index ``d`` and model index
``m``, the order of the JAX mesh's ``reshape(n_data, n_model)``. The
collectives (all-reduce, all-gather, broadcast) are PyTorch's.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the stage-2 FCs of either family: ``fc{i}`` (early fusion) and
# ``fc{i}_v{vi}`` (late and deep); DistributedDataParallel adds ``module.``
_SHARDED = re.compile(r"(^|\.)stage2_head\.fc\d+(_v\d+)?\.(weight|bias)$")


@dataclasses.dataclass
class Mesh:
    """``n_data`` x ``n_model`` ranks (the first ``size`` of the world).
    ``rank`` is this process's global rank, None where it lies outside the
    mesh. The groups exist where a process group does: ``group`` holds every
    rank of the mesh, ``data_group`` the ranks of this rank's model index,
    ``model_group`` those of its data index."""

    n_data: int
    n_model: int
    rank: Optional[int]
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def member(self) -> bool:
        return self.rank is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def _world(world_size: Optional[int], rank: Optional[int]):
    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    return world_size, rank, live


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The ``(n_data, n_model)`` grid over the first ranks of the world
    (``world_size`` and ``rank`` default to the process group's, else 1 and
    0). With a process group, every rank of the world must call this, in the
    same order: it creates the groups, and ranks outside the mesh get
    ``rank=None``."""

    world_size, rank, live = _world(world_size, rank)
    if n_data is None:
        n_data = world_size // n_model
    used = n_data * n_model
    if used < 1 or used > world_size:
        raise ValueError(f"mesh {n_data}x{n_model} does not fit {world_size} ranks")
    mesh = Mesh(n_data, n_model, rank if rank < used else None)
    if live:
        grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
        mesh.group = dist.new_group(list(range(used)))
        for m in range(n_model):
            g = dist.new_group([row[m] for row in grid])
            if mesh.member and mesh.model_index == m:
                mesh.data_group = g
        for d in range(n_data):
            g = dist.new_group(grid[d])
            if mesh.member and mesh.data_index == d:
                mesh.model_group = g
        if not mesh.member:
            mesh.group = None
    return mesh


def mesh_shape(batch_size: int, n_model: int = 1, world_size: int = 1) -> tuple:
    """``auto_mesh``'s rule: (n_data, n_model) with the largest data size
    that divides the global batch (so every shard gets equal work), warning
    when ranks would sit idle."""

    avail = max(world_size // max(n_model, 1), 1)
    n_data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    if n_data * n_model < world_size:
        # never silently idle cards: an indivisible batch (e.g. batch 4 on
        # 8 cards) strands the remainder with zero work
        good = sorted(b for b in (avail * k for k in range(1, 5)) if b >= batch_size)
        suggestion = f"; use batch_size {good[0]} (or any multiple of {avail}) to fill the mesh" if good else ""
        warnings.warn(
            f"auto_mesh uses {n_data * n_model} of {world_size} devices: batch_size {batch_size} has no "
            f"larger divisor <= {avail} (model_parallel={n_model}){suggestion}",
            stacklevel=3,
        )
    return n_data, n_model


def auto_mesh(batch_size: int, n_model: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Optional[Mesh]:
    """The trainer's mesh (``mesh_shape``'s rule over the world), or None
    when it would hold one rank: the caller then runs the single-card path.
    Collective over the world like ``make_mesh``."""

    world_size, rank, _ = _world(world_size, rank)
    n_data, n_model = mesh_shape(batch_size, n_model, world_size)
    if n_data * n_model <= 1:
        return None
    return make_mesh(n_data, n_model, world_size, rank)


def batch_rows(mesh: Optional[Mesh], global_batch: int) -> slice:
    """This rank's rows of a global batch: the ``data_index``-th of
    ``n_data`` equal blocks (the counterpart of ``batch_sharding``)."""

    if mesh is None:
        return slice(0, global_batch)
    if global_batch % mesh.n_data:
        raise ValueError(f"global batch {global_batch} does not split over {mesh.n_data} data ranks")
    n = global_batch // mesh.n_data
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def param_sharding_rules(name: str, shape=None) -> Optional[int]:
    """Tensor-parallel layout: the dimension of parameter ``name`` split over
    the model axis, or None where it is replicated. Stage-2 FC weights
    ([out, in]) split on the output features, their biases likewise;
    everything else is replicated."""

    del shape
    return 0 if _SHARDED.search(name) else None


def sharded_names(names) -> List[str]:
    return [n for n in names if param_sharding_rules(n) is not None]


def _shard(t: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    if t.shape[0] % mesh.n_model:
        raise ValueError(f"{name}: {t.shape[0]} output features do not split over {mesh.n_model} model ranks")
    n = t.shape[0] // mesh.n_model
    return t[mesh.model_index * n:(mesh.model_index + 1) * n]


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A full state dict -> this rank's shard (views of the full tensors)."""

    return {k: _shard(v, mesh, k) if param_sharding_rules(k) is not None else v
            for k, v in state_dict.items()}


def gather_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard -> the full state dict: each sharded tensor gathered
    over the model group (a collective: every rank of the group calls it)."""

    return {k: _gather(v, mesh) if param_sharding_rules(k) is not None else v
            for k, v in state_dict.items()}


def _gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.n_model == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=0)


def shard_module(model: torch.nn.Module, mesh: Mesh) -> None:
    """Cut a full-width model's stage-2 FCs to this rank's column shard in
    place and hand each module with a ``model_group`` (``Stage2Head``) the
    mesh's model group. A no-op on one model rank."""

    if mesh.n_model == 1:
        return
    with torch.no_grad():
        for name, p in model.named_parameters():
            if param_sharding_rules(name) is not None:
                p.data = _shard(p.data, mesh, name).clone()
    for module in model.modules():
        if hasattr(module, "model_group"):
            module.model_group = mesh.model_group


def optimizer_state(opt_state: Dict[str, Any], names: List[str], mesh: Mesh, gather: bool) -> Dict[str, Any]:
    """An optimizer state dict (parameters indexed in ``names`` order) with
    every state tensor of a sharded parameter gathered to the full layout
    (``gather``) or sliced to this rank's shard; scalars (Adam's step) stay."""

    if mesh.n_model == 1:
        return opt_state
    state = {}
    for i, per_param in opt_state["state"].items():
        name = names[int(i)]
        if param_sharding_rules(name) is None:
            state[i] = per_param
            continue
        state[i] = {k: (_gather(v, mesh) if gather else _shard(v, mesh, name))
                    if torch.is_tensor(v) and v.dim() > 0 else v
                    for k, v in per_param.items()}
    return {**opt_state, "state": state}
