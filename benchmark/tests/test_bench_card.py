"""On the card (marked ``cuda``; skips here): the control at a cell's own
size serves the same requests as the port and fails the cell's limits, while
the port passes them (the manifest's cell, and the cars cell whose files are
kept outside it). Run on the card with
``python -m pytest -q -m cuda benchmark/tests``."""

from __future__ import annotations

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cars-serve-b8", "rcnn-serve-b8"])
def test_control_fails_at_the_cells_size(cuda_device, cell):
    import control
    from harness.manifest import Cell

    c = Cell(cell)
    row = control.readings(c, 3_000_000_101, 2.0, cuda_device, control=True)
    assert row["port_correct"] is True, row["port"]
    assert row["control_correct"] is False, row["control"]
