"""The least time of a hand kernel's call, from the call's own inputs.

Each hand kernel has a file of its own, ``kernels/<op>.py``: ``bound``, the
call's arguments -> :func:`least_time` of its bytes and operations, and
``PORT``, the port's (module, attribute) of the launcher whose calls
``ServeRun.profile`` records. Bytes count each input byte read once and each
output byte written once; a data-dependent input counts what these inputs
need (the live points' source cells, the windows' distinct pixels). The
least time is the larger of bytes over the HBM rate and operations over the
float32 rate outside the tensor cores (the kernels compute in f32 on the
CUDA cores). The bounds are copied from the port's ``chip_smoke.py``, so that
later changes to the port leave them as they are.
"""

from __future__ import annotations

from typing import Dict

from .peaks import F32_FLOPS, HBM_BYTES_PER_S


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def least_time(n_bytes: float, flops: float) -> Dict[str, float]:
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"s": max(by_bytes, by_ops), "bytes": float(n_bytes), "flops": float(flops),
            "by": "bytes" if by_bytes >= by_ops else "flops"}
