"""Faults planted in the port's timed path underneath a run: each breaks one
thing that the comparison for ``correct`` has to catch. ``control.py``
reads them on the card, the rehearsal tests on the CPU.

    with planted("wrong_pick"):
        ...  # build and serve the cell as a run does

  half_batch        the second half of each batch's detections are the
                    first half's (half of the batch left out);
  moved_boxes       every final box moved 0.5 m along x where decode makes it;
  wrong_pick        each final per-class NMS answers, in its first slot, its
                    last valid pick again: one pick altered where it is made;
  mirrored_heading  every final heading negated (``ry`` -> ``-ry``);
  flipped_side      every final heading turned by pi (the flip head's side
                    inverted).

Each reaches a one-stage family as it reaches a two-stage one: its
detections are its final per-class NMS's picks (``wrong_pick``'s
``nms_batch``), and the other four alter ``decode_batch``'s output, which
every family's detections leave through.
"""

from __future__ import annotations

import importlib
import math
from contextlib import contextmanager
from typing import Callable, Dict

import torch


def _alter_decode(alter: Callable) -> Callable:
    from sparse_pooling_tpu_torch.models import pipeline as pl

    orig = pl.decode_batch

    def broken(*args, **kwargs):
        return alter(orig(*args, **kwargs))

    pl.decode_batch = broken
    return lambda: setattr(pl, "decode_batch", orig)


def _half_batch(det: Dict) -> Dict:
    h = det["boxes_3d"].shape[0] // 2
    return {k: torch.cat([v[:h], v[:h]]) if isinstance(v, torch.Tensor) else v for k, v in det.items()}


def _moved_boxes(det: Dict) -> Dict:
    boxes = det["boxes_3d"].clone()
    boxes[..., 0] += 0.5
    return dict(det, boxes_3d=boxes)


def _heading(turn: Callable) -> Callable:
    def alter(det: Dict) -> Dict:
        boxes = det["boxes_3d"].clone()
        ry = turn(boxes[..., 6])
        boxes[..., 6] = torch.remainder(ry + math.pi, 2 * math.pi) - math.pi
        return dict(det, boxes_3d=boxes)
    return alter


def _wrong_pick() -> Callable:
    """Wraps the final NMS, ``nms_batch``, of every family's port modules."""

    from families import every

    modules = {}
    for family in every():
        for name in family.PORT_NMS_MODULES:
            module = importlib.import_module(name)
            if hasattr(module, "nms_batch"):
                modules[name] = module
    originals = {name: m.nms_batch for name, m in modules.items()}

    def broken(orig):
        def call(*args, **kwargs):
            res = orig(*args, **kwargs)
            last = torch.clamp_min(res.valid.sum(dim=1) - 1, 0)
            first = torch.gather(res.indices, 1, last[:, None])[:, 0]
            indices = res.indices.clone()
            indices[:, 0] = torch.where(res.valid[:, 0], first, indices[:, 0])
            return type(res)(indices, res.valid)
        return call

    for name, module in modules.items():
        module.nms_batch = broken(originals[name])

    def undo():
        for name, module in modules.items():
            module.nms_batch = originals[name]
    return undo


FAULTS: Dict[str, Callable[[], Callable]] = {
    "half_batch": lambda: _alter_decode(_half_batch),
    "moved_boxes": lambda: _alter_decode(_moved_boxes),
    "wrong_pick": _wrong_pick,
    "mirrored_heading": lambda: _alter_decode(_heading(lambda ry: -ry)),
    "flipped_side": lambda: _alter_decode(_heading(lambda ry: ry + math.pi)),
}


@contextmanager
def planted(name: str):
    """The port with fault ``name`` planted, for the ``with`` block."""

    undo = FAULTS[name]()
    try:
        yield
    finally:
        undo()
