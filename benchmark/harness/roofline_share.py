"""A hand kernel's share of its roofline in a traced run."""

from __future__ import annotations


def share(run, op: str, kernel_prefix: str):
    """100 x (the least time of the op's calls) / (their device time), or
    None where the profiled requests made no call. The device time is the
    operator's (``spt::<op>``); where the trace attributes none to it, the
    forward kernels whose names carry ``kernel_prefix``."""

    prof = run["profile"]
    bounds = prof.get("bounds", {}).get(op) if prof else None
    if not bounds:
        return None
    device_s = prof["op_device_s"].get(f"spt::{op}", 0.0)
    if device_s <= 0:
        device_s = sum(s for name, s in prof["kernel_s"].items()
                       if kernel_prefix in name and "bwd" not in name)
    if device_s <= 0:
        return None
    return 100.0 * sum(b["s"] for b in bounds) / device_s
