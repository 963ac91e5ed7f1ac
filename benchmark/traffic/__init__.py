"""The benchmark's traffic: one general generator a kind of traffic reads its
mix from a data file of this folder (``<traffic>.json``).

``serve_schedule`` is the serving generator: a pool of ``pool_frames``
synthetic frames (``frames.synthetic_frame``) whose point counts are the same
evenly spaced set from ``points_min`` to ``points_max`` for every seed, in an
order the seed draws, and a closed loop of requests of ``batch`` distinct
frames, each pass over the pool in a new order the seed draws. Every seed
therefore asks for the same sizes; only their order and the frames' content
differ.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .frames import synthetic_frame


def frame_seeds(seed: int, n: int) -> np.ndarray:
    """``n`` frame seeds below 2**31 from a run seed of any size."""

    return np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint32) % (2**31 - 2**16)


def frame_pool(mix: Dict, cfg_model, seed: int, family=None) -> List[Dict[str, np.ndarray]]:
    """The run's frames, host numpy dicts keyed like the port's ``RawSample``;
    a detector family's ``frame(frame, seed)`` (``families/``) adds what its
    frames carry beyond them, from the frame's own seed."""

    n = int(mix["pool_frames"])
    counts = np.rint(np.linspace(mix["points_min"], mix["points_max"], n)).astype(int)
    counts = np.random.default_rng([int(seed), 1]).permutation(counts)
    frames = [(synthetic_frame(cfg_model, n_points=int(c), seed=int(s), image=mix["image"]), int(s))
              for c, s in zip(counts, frame_seeds(seed, n))]
    return [family.frame(f, s) if family is not None else f for f, s in frames]


class ServeSchedule:
    """Requests of ``batch`` distinct pool frames, pass after pass over the
    pool, each pass in an order drawn from the seed."""

    def __init__(self, mix: Dict, seed: int):
        self.batch, self.pool = int(mix["batch"]), int(mix["pool_frames"])
        if self.pool % self.batch:
            raise ValueError(f"pool_frames {self.pool} is not a multiple of batch {self.batch}")
        self.rng = np.random.default_rng([int(seed), 2])
        self.requests: List[List[int]] = []

    def request(self, i: int) -> List[int]:
        """The frame ids of request ``i`` (0-based)."""

        while len(self.requests) <= i:
            order = self.rng.permutation(self.pool)
            self.requests.extend(order.reshape(-1, self.batch).tolist())
        return self.requests[i]
