"""Helpers of the benchmark's CPU tests: the benchmark folder on ``sys.path``,
and a tiny cell added to a copy of the benchmark as new files and manifest
entries alone."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = "tiny-serve"


def tiny_pipeline(architecture: str = "avod") -> dict:
    """The port's ``unittest`` preset computed in bf16 (the served dtype):
    an 88x100 BEV lattice, a 48x160 canvas, a two-stage backbone."""

    from sparse_pooling_tpu_torch.configs import presets

    cfg = dataclasses.asdict(presets.unittest_config())
    cfg["model"]["backbone"]["compute_dtype"] = "bfloat16"
    cfg["model"]["architecture"] = architecture
    if architecture == "rcnn":
        cfg["model"]["avod"]["box_rep"] = "offsets"
    return cfg


def add_tiny_cell(root: Path, name: str = TINY, architecture: str = "avod", batch: int = 2,
                  limits_from: str = "cars-serve-b8", metrics_from: str = "rcnn-serve-b8") -> None:
    """Adds a configuration, a traffic mix and a cell to the benchmark copy
    at ``root`` as new files and manifest entries. Its limits are those of
    the cell file ``limits_from`` (of its own family) doubled: the tiny
    lattice's few, small proposals read the served dtype's rounding up to
    about 1.1x the full cell's widest. It reports the metrics that the
    manifest's cell ``metrics_from`` reports."""

    bench = root / "benchmark"
    config = f"tiny_{architecture}"
    (bench / "configs" / f"{config}.json").write_text(json.dumps({
        "name": config, "preset": "unittest", "source": "https://arxiv.org/abs/1712.02294",
        "deployment": "test only", "reduced": [], "assumed": {},
        "extents": {"x_min": -40.0, "x_max": 40.0, "y_min": -5.0, "y_max": 3.0, "z_min": 0.0, "z_max": 70.0},
        "pipeline": tiny_pipeline(architecture)}))
    traffic = f"tiny_b{batch}"
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps({
        "kind": "serve", "generator": "frames", "loop": "closed", "clients": 1, "batch": batch,
        "pool_frames": 2 * batch, "points_min": 600, "points_max": 1000, "image": "noise"}))
    limits = {k: 2 * v for k, v in json.loads(
        (bench / "workloads" / f"{limits_from}.json").read_text())["limits"].items()}
    (bench / "workloads" / f"{name}.json").write_text(json.dumps({
        "name": name, "config": config, "traffic": traffic, "chips": 1, "why": "test only",
        "judge_requests": 2, "profiled_requests": 1, "limits": limits}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                                  "why": "test only"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if metrics_from in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
