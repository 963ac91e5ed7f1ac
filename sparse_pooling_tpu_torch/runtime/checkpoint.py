"""Checkpoints: ``torch.save`` of ``{"model", "optimizer", "step"}``.

Port of ``sparse_pooling_tpu.runtime.checkpoint`` (orbax there): one
checkpoint per step under ``<ckpt_dir>/<step>/state.pt``, written to a
temporary file and renamed, so a reader never sees half a checkpoint; the
oldest beyond ``keep`` are deleted. Writes are synchronous.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

_FILE = "state.pt"


def save(ckpt_dir: str, step: int, state: Dict[str, Any], keep: int = 10000) -> None:
    step_dir = os.path.join(ckpt_dir, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, f".{_FILE}.tmp{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(step_dir, _FILE))
    if keep > 0:
        for old in all_steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)))


class CheckpointWriter:
    """The train loop's writer: ``save`` with the loop's directory and keep
    count (synchronous; the reference's writes in the background)."""

    def __init__(self, ckpt_dir: str, keep: int = 10000):
        self.ckpt_dir, self.keep = ckpt_dir, keep

    def save(self, step: int, state: Dict[str, Any]) -> None:
        save(self.ckpt_dir, step, state, self.keep)


def restore(ckpt_dir: str, step: int, map_location=None) -> Dict[str, Any]:
    return torch.load(os.path.join(ckpt_dir, str(int(step)), _FILE), map_location=map_location,
                      weights_only=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name) for name in os.listdir(ckpt_dir)
        if name.isdigit() and os.path.exists(os.path.join(ckpt_dir, name, _FILE))
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None
