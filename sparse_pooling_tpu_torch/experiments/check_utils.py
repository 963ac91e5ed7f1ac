"""Shared helpers of the learning checks (a copy of
``sparse_pooling_tpu.experiments.check_utils``, and ``seed_config``, the
per-seed config both production checks derive).

A check's AP on 16 val frames from one seed cannot resolve differences below
~0.06 (seeds spread up to 0.12 easy / 0.06 moderate); 48 val frames cut the
spread to 0.015-0.023. So the checks train 2+ seeds on 48+ held-out frames
by default and report each metric's mean and half-spread over the seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

BANDS = ("easy", "moderate", "hard")
METRICS = ("2d", "bev", "3d", "aos")


def best_result(results: List[dict], classes: Sequence[str]) -> dict:
    """The checkpoint with the highest mean 3D moderate AP over classes
    (the sweep over every checkpoint gives the candidates)."""

    def score(r):
        return sum(r["ap"][c]["3d"]["moderate"] for c in classes) / len(classes)

    return max(results, key=score)


def aggregate_aps(per_seed_aps: List[Dict], classes: Sequence[str]) -> Dict:
    """per-seed {class: {metric: {band: ap}}} -> {class: {metric: {band:
    {mean, spread, values}}}} where spread is the half-range."""

    agg: Dict = {}
    for cls in classes:
        agg[cls] = {}
        for metric in METRICS:
            if metric not in per_seed_aps[0][cls]:
                continue
            agg[cls][metric] = {}
            for band in BANDS:
                vals = [ap[cls][metric][band] for ap in per_seed_aps]
                agg[cls][metric][band] = {
                    "mean": sum(vals) / len(vals),
                    "spread": (max(vals) - min(vals)) / 2.0,
                    "values": vals,
                }
    return agg


def print_aggregate(agg: Dict, classes: Sequence[str], seeds: Sequence[int], label: str) -> None:
    print(f"\n[{label}] mean +/- half-spread over seeds {list(seeds)} (easy / moderate / hard)")
    for cls in classes:
        for metric in METRICS:
            if metric not in agg[cls]:
                continue
            cells = [
                f"{agg[cls][metric][b]['mean']:.3f}+/-{agg[cls][metric][b]['spread']:.3f}"
                for b in BANDS
            ]
            print(f"  {cls:<10} {metric:<4} " + "   ".join(cells))


def parse_seeds(seeds_arg: str, legacy_seed) -> List[int]:
    """``--seeds '0,7'`` (the default of the checks), or ``--seed N`` for a
    single seed."""

    if legacy_seed is not None:
        return [int(legacy_seed)]
    return [int(s) for s in str(seeds_arg).split(",") if s != ""]


def seed_config(cfg, seed: int):
    """A check's pipeline config for one dataset seed (seed 0 keeps the
    checkpoint name), as the JAX checks derive it."""

    return dataclasses.replace(
        cfg, checkpoint_name=cfg.checkpoint_name + (f"_seed{seed}" if seed else ""),
        dataset=dataclasses.replace(cfg.dataset, seed=seed))
