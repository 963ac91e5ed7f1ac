"""Where the benchmark's data lives, and how a cell's files are read.

Everything that belongs to one configuration, traffic mix, cell, per-layer
metric, detector family or hand kernel is a file of its own, found by the
name ``BENCHMARK.json`` or a configuration gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``,
``families/<architecture>.py``, ``kernels/<op>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

from families import load
from harness.judge import numbers
from reference.config import pipeline_config_from_dict

BENCH_DIR = Path(__file__).resolve().parent.parent
# top-level module names a run may not load, compared whole: the port's name
# begins with the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sparse_pooling_tpu")


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell's files, read from ``bench_dir`` (the benchmark folder) and
    the ``BENCHMARK.json`` beside it."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR):
        self.bench_dir = Path(bench_dir)
        self.manifest = read_json(self.bench_dir.parent / "BENCHMARK.json")
        self.workload = read_json(self.bench_dir / "workloads" / f"{name}.json")
        if self.workload["name"] != name:
            raise ValueError(f"workloads/{name}.json names itself {self.workload['name']!r}")
        self.name = name
        self.config = read_json(self.bench_dir / "configs" / f"{self.workload['config']}.json")
        self.traffic = read_json(self.bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        # the reference's parse of the configuration, and its family's file
        self.model_cfg = pipeline_config_from_dict(self.config["pipeline"], self.bench_dir).model
        self.family = load(self.model_cfg.architecture, self.bench_dir)
        check_limits(name, self.model_cfg.architecture, self.family, self.workload["limits"])

    def end_to_end(self) -> List[Dict]:
        """The manifest's end-to-end metrics this cell reports."""

        return [m for m in self.manifest["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        """The manifest's per-layer metrics this cell reports."""

        return [m for m in self.manifest["per_layer"] if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable:
        """``read`` of ``metrics/<metric>.py``."""

        return _load(self.bench_dir / "metrics" / f"{metric}.py", "bench_metric").read

    def kernels(self) -> Dict[str, ModuleType]:
        """Each hand kernel's file ``kernels/<op>.py`` by its op: ``PORT``,
        the port's (module, attribute) to record, and ``bound``."""

        return {p.stem: _load(p, "bench_kernel") for p in sorted((self.bench_dir / "kernels").glob("*.py"))}


def check_limits(cell: str, architecture: str, family: ModuleType, limits: Dict) -> None:
    """Raises where a cell's limits name a number its family's judge does
    not read, or leave out one it reads: no limit is vacuous, no number
    unheld."""

    reads = numbers(family)
    extra = [k for k in limits if k not in reads]
    missing = [k for k in reads if k not in limits]
    faults = ([f"name {', '.join(extra)}, which it does not read"] if extra else []) + (
        [f"leave out {', '.join(missing)}"] if missing else [])
    if faults:
        raise ValueError(f"cell {cell}: family {architecture!r} ({family.STAGES} stage(s)) reads "
                         f"{', '.join(reads)}; its limits {' and '.join(faults)}")


def _load(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name is forbidden."""

    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))
