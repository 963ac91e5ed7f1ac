"""The hand kernels' byte and operation counts (``kernels/<op>.py``) against
hand-worked shapes."""

from __future__ import annotations

import pytest
import torch


def _bound(op):
    from harness.manifest import Cell

    return Cell("rcnn-serve-b8").kernels()[op].bound


def test_sparse_pool_bound_by_hand():
    from harness.peaks import F32_FLOPS, HBM_BYTES_PER_S

    src = torch.zeros(1, 2, 2, 1)
    rows = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    cols = torch.tensor([[[0, 1, 2, 3], [0, 1, 2, 3], [3, 3, 3, 3]]], dtype=torch.int32)
    vals = torch.tensor([[[0.25] * 4, [0.0] * 4, [1.0, 0, 0, 0]]])
    got = _bound("sparse_pool_patch")(src, rows, cols, vals, 2)
    # live points 0 and 2 touch cells {0, 1, 2, 3} once: 4 x 1 x 4 bytes;
    # rows 12, cols 48, vals 48 bytes; the [1, 2, 1] f32 output 8 bytes
    assert got["bytes"] == 16 + 12 + 48 + 48 + 8
    assert got["flops"] == 2 * (8 * 1 + 4)
    assert got["by"] == "bytes" and got["s"] == pytest.approx(132 / HBM_BYTES_PER_S)
    assert got["s"] > got["flops"] / F32_FLOPS


def test_group_crop_bound_by_hand():
    from harness.peaks import HBM_BYTES_PER_S

    images = torch.zeros(1, 4, 4, 2, dtype=torch.bfloat16)
    boxes = torch.tensor([[[[0.0, 0.0, 1.0, 1.0]], [[2.0, 2.0, 3.0, 3.0]]]])  # two units of one box
    got = _bound("group_crop")(images, boxes, (2, 2), 2)
    # each unit's 2x2 window at its box, 8 distinct pixels of 2 bf16
    # channels; 32 bytes of boxes; 2 x 2 x 2 x 2 bf16 outputs
    assert got["bytes"] == 8 * 2 * 2 + 32 + 16 * 2
    assert got["flops"] == 8 * 16
    assert got["s"] == pytest.approx(got["bytes"] / HBM_BYTES_PER_S)


def test_group_crop_shared_window_counts_once():

    images = torch.zeros(1, 8, 8, 1)
    boxes = torch.tensor([[[[1.0, 1.0, 2.0, 2.0], [1.0, 1.0, 2.0, 2.0]]]])  # one unit, two variants
    got = _bound("group_crop")(images, boxes, (3, 3), 4)
    assert got["bytes"] == 16 * 4 + 32 + 2 * 9 * 4
