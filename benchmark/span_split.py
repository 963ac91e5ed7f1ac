#!/usr/bin/env python3
"""Where a serving cell's request goes, by the program's own spans: the
detector and the decode split by what they do, the host's cost of a greedy
NMS round, and the device's idle time put down to the span open when each
gap began.

    python3 benchmark/span_split.py --workload <cell> --seed <n> [--seconds 20] [--out FILE]

Builds and warms the cell as ``run.py`` does and serves its window with the
stages timed (``--trace 1``'s CUDA events). Then, from the schedule's next
request on, ``harness/spans.py``: 48 requests with the program's spans
collected, and the profiled requests with the spans as ``torch.profiler``
ranges. Prints one JSON line: the window's p50 and stage medians (what
``inputs_ms.serve``, ``detector_ms.serve`` and ``decode_ms.serve`` read),
the span readings (``upload_ms.serve``, ``encode_ms.serve``,
``fusion_ms.serve``, ``rpn_nms_ms.serve``, ``stage2_ms.serve``,
``final_nms_ms.serve``, ``nms_round_us.serve``, ``nms_idle_share.serve``),
the collected requests' p50, every span's median host, device-stream and
self ms, and launches and idle ms a request by span. Outputs are not judged
here: ``run.py`` does that. The benchmark's runs do not run this; it goes
once ``harness/serve.py::run`` reads the spans itself.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", help="also append the line to this file")
    return p.parse_args(argv)


def split(cell, seed: int, seconds: float, device) -> dict:
    import numpy as np
    import torch

    from harness import spans
    from harness.serve import ServeRun

    srv = ServeRun(cell, seed, device, trace=True)
    srv.warm_up()
    win = srv.window(seconds)
    profiled = int(cell.workload["profiled_requests"])
    data = spans.collected(srv, win["requests"])
    prof = spans.profiled(srv, win["requests"] + spans.SPAN_REQUESTS, profiled)
    srv.release()
    med = lambda xs: float(np.median(xs))  # noqa: E731
    out = {"workload": cell.name, "seed": seed, "window_requests": win["requests"],
           "window_p50_ms": med(win["latency_ms"]),
           "stage_ms": {name: med(ms) for name, ms in win["stage_ms"].items()},
           "spans": {f"{k}.serve": v for k, v in spans.readings(data, prof).items()}}
    if data:
        out["span_p50_ms"] = med(data["latency_ms"])
        out["span_ms"] = {name: {k: med(s[k]) for k in ("host_ms", "device_ms", "self_ms")} | {"parent": s["parent"]}
                          for name, s in data["spans"].items()}
        out["launches_by_span"] = {k: v / profiled for k, v in prof.get("launches", {}).items()}
        out["idle_ms_by_span"] = {k: 1e3 * v / profiled for k, v in prof.get("idle_s", {}).items()}
        out["busy_ms"] = 1e3 * prof.get("busy_s", 0.0) / profiled
        out["launch_found"] = prof.get("launch_found", 0) / profiled
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None, device=None, bench_dir: Path = BENCH) -> int:
    """``device`` is for the CPU rehearsal of the tests alone."""

    import torch

    from harness.manifest import Cell

    args = parse(argv)
    cell = Cell(args.workload, bench_dir)
    if device is None:
        if not torch.cuda.is_available():
            print("span_split: needs a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    # as run.py serves the cell
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = json.dumps(split(cell, args.seed, args.seconds, torch.device(device)))
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
