#!/usr/bin/env python3
"""Readings that set a cell's limits: the port's, over many seeds; the
control's, the float32 reference computed one precision lower in the port's
place (every conv and dense layer through float8 e4m3 with a per-tensor
scale, the float32 input stages in bfloat16), on the same requests; and the
port's with a fault planted underneath (``harness/faults.py``).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... [--control 1 2 3]
        [--fault NAME --fault-seeds 4 5 6] [--shares 0 0.5 1 2] [--seconds 3] [--out FILE]

Each seed builds the cell as a run does, serves it for ``--seconds``, and
judges the sampled requests with the port's records; for the seeds of
``--control`` the control then serves the same requests and is judged by the
same reference. Each fault of ``--fault`` is planted alone, on each seed of
``--fault-seeds``. Every reading is held against the cell's limits
(``judge.verdict``, as a run holds it) and printed with its ``correct``;
``--shares`` adds the heading's line read at other vector shares. One JSON
line a reading; with ``--out`` all of them in one file. The benchmark's runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def readings(cell, seed: int, seconds: float, device, control: bool, fault: str = None, shares=()) -> dict:
    import torch

    from harness import faults, judge
    from harness.serve import ServeRun

    with faults.planted(fault) if fault else nullcontext():
        srv = ServeRun(cell, seed, device, trace=False)
        srv.warm_up()
        win = srv.window(seconds)
        srv.release()
    records = srv.reservoir.records()
    ref = judge.Reference(cell, srv.state, device)
    limits = cell.workload["limits"]
    side = "fault" if fault else "port"
    out = {"seed": seed, "requests": win["requests"], "judged": len(records)}
    if fault:
        out["planted"] = fault
    out[side] = judge.judge(records, srv.frames, ref, shares)
    out[f"{side}_correct"] = judge.verdict(out[side], limits)[0]
    if control:
        low = judge.Reference(cell, srv.state, device, lower=torch.float8_e4m3fn)
        ctl = [low.record(r["request"], r["ids"], [srv.frames[i] for i in r["ids"]]) for r in records]
        del low
        out["control"] = judge.judge(ctl, srv.frames, ref, shares)
        out["control_correct"] = judge.verdict(out["control"], limits)[0]
    return out


def main(argv=None, device=None, bench_dir: Path = BENCH) -> int:
    import torch

    from harness.faults import FAULTS
    from harness.manifest import Cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--fault", nargs="*", default=[], choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--shares", type=float, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("control: needs a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload, bench_dir)
    jobs = [(seed, None) for seed in args.seeds] + [(seed, f) for f in args.fault for seed in args.fault_seeds]
    rows = []
    for seed, fault in jobs:
        t0 = time.perf_counter()
        row = readings(cell, seed, args.seconds, device, fault is None and seed in args.control, fault, args.shares)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
