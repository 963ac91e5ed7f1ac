"""Scalar and image summaries.

Port of ``sparse_pooling_tpu.runtime.summary`` (capability parity with
``avod/core/summary_utils.py``): scalars go to a JSONL stream, one record
per call, ``{"step", "time", <name>: <float>, ...}``, appended to
``<logdir>/scalars.jsonl``; an image (a prediction overlay) to a PNG,
``<logdir>/images/<tag>_<step:08d>.png`` (``/`` in the tag becomes ``_``).
Where ``torch.utils.tensorboard`` imports, images are mirrored to
TensorBoard events in ``logdir`` too, as the JAX writer mirrors its
summaries. The mirror is opened at the first image, not for scalars: its
import can pull in TensorFlow (seconds and a large heap), which a training
loop that writes only scalars should not pay.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._logdir = logdir
        self._path = os.path.join(logdir, "scalars.jsonl")
        self._tb, self._tb_tried = None, False

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in values.items()}}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _mirror(self):
        """The TensorBoard writer, opened once; None where it does not import."""

        if not self._tb_tried:
            self._tb_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter as TbWriter

                self._tb = TbWriter(self._logdir)
            except Exception:
                self._tb = None
        return self._tb

    def image(self, step: int, tag: str, image_hwc) -> str:
        """Save an [H, W, 3] uint8 image (reference: image summaries with
        drawn boxes) as a PNG; returns its path."""

        from sparse_pooling_tpu_torch.data.synthetic import encode_png

        img_dir = os.path.join(self._logdir, "images")
        os.makedirs(img_dir, exist_ok=True)
        arr = np.asarray(image_hwc, dtype=np.uint8)
        path = os.path.join(img_dir, f"{tag.replace('/', '_')}_{step:08d}.png")
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        tb = self._mirror()
        if tb is not None:
            tb.add_image(tag, arr, step, dataformats="HWC")
        return path

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


def read_scalars(logdir: str) -> List[dict]:
    path = os.path.join(logdir, "scalars.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
