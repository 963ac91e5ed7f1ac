"""Scalar summaries as a JSONL stream.

Port of ``sparse_pooling_tpu.runtime.summary`` (scalars only): one JSON
record per call, ``{"step", "time", <name>: <float>, ...}``, appended to
``<logdir>/scalars.jsonl``. The image summaries are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, "scalars.jsonl")

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in values.items()}}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def read_scalars(logdir: str) -> List[dict]:
    path = os.path.join(logdir, "scalars.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
