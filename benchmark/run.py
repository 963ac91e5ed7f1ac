#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``sparse_pooling_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints, as the last line of standard output, one JSON object: whether
the timed path's outputs were correct (``correct``), the requests attempted
and failed, the metrics (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), the device, and last the numbers
compared for ``correct`` beside their limits (``checks``), which also end
standard error. Exits non-zero, printing no result, where the cards are
missing or the process has loaded JAX, flax or the JAX package.

The cell's files say what runs: ``workloads/<cell>.json`` names the
configuration (``configs/``), the traffic mix (``traffic/``) and the limits
of the comparison; the traffic's ``kind`` names the module that runs it (``harness/``);
the configuration's architecture names its family file
(``families/<architecture>.py``: the reference model, anchors, decode, FLOPs
and what the judge and the spans read of it); ``kernels/<op>.py`` gives each
hand kernel's bound and the launcher to record; ``metrics/<metric>.py``
reads each per-layer metric of ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``); the harness's
    own clock start where ``/proc`` cannot say."""

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), time.perf_counter() - _T0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()
_AGE0 = process_age_s()


def setup_clock() -> float:
    return _AGE0 + time.perf_counter() - _T0


# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
for path in (str(ROOT), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, bench_dir: Path = BENCH) -> int:
    """The run; ``device`` is for the CPU rehearsal of the tests alone
    (the command line always asks for the cards)."""

    import importlib

    import torch

    from harness.judge import verdict
    from harness.manifest import Cell, forbidden_loaded

    args = parse(argv)
    cell = Cell(args.workload, bench_dir)
    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"run: cell {cell.name} needs {chips} CUDA card(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(1)  # one process, one intra-op thread: a steadier host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = importlib.import_module(f"harness.{cell.traffic['kind']}")
    res = kind.run(cell, args.seed, args.seconds, bool(args.trace), device, setup_clock)
    run = res["run"]

    metrics = {}
    if args.trace:
        for m in cell.per_layer():
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(run[m["name"]]), "unit": m["unit"]}

    correct, checks = verdict(res["readings"], cell.workload["limits"])

    found = forbidden_loaded()
    if found:
        print(f"run: the process has loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3

    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": info}
    if args.trace and run.get("profile"):
        prof = run["profile"]
        for op, bounds in prof["bounds"].items():
            if bounds:
                print(f"trace {op}: {len(bounds)} calls, device {prof['op_device_s'].get('spt::' + op, 0.0)!r} s "
                      f"(operator rows), least {sum(b['s'] for b in bounds)!r} s, bound by "
                      f"{sorted({b['by'] for b in bounds})}, {sum(b['bytes'] for b in bounds)!r} bytes",
                      file=sys.stderr)
        info["busy_s"], info["window_s"] = prof["busy_s"], prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    win = run.get("window", {})
    if "new_segments" in win:
        print(f"window: {win['requests']} requests, {win['new_segments']} new allocator segments "
              f"(warm-up {run.get('warm_requests')} schedule requests)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
