"""Random draws that do not depend on how the batch is split.

The trainer draws path drop, dropout and the minibatch priorities at the
batch's shape from one generator. A data-parallel rank holds only its rows
of the global batch; it draws at the global shape from a generator seeded as
every other rank's and keeps its own rows (``BatchRows``), as XLA does for a
sharded global array. The draws of a row are then those of one process over
the whole batch. A plain ``torch.Generator`` draws at the given shape, as
before.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class BatchRows:
    """``generator`` for a rank that holds rows ``rows`` of a global batch of
    ``total``."""

    def __init__(self, generator: torch.Generator, rows: slice, total: int):
        self.generator, self.rows, self.total = generator, rows, total

    @property
    def device(self) -> torch.device:
        return self.generator.device


def rand(shape: Sequence[int], generator, device: Optional[torch.device] = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; for ``BatchRows``, the
    generator's rows of the draw at the global batch's shape."""

    if isinstance(generator, BatchRows):
        full = torch.rand((generator.total, *shape[1:]), generator=generator.generator, device=device)
        part = full[generator.rows]
        if part.shape[0] != shape[0]:
            raise ValueError(f"rows {generator.rows} of {generator.total} hold {part.shape[0]} rows, "
                             f"the batch {shape[0]}")
        return part
    return torch.rand(tuple(shape), generator=generator, device=device)
