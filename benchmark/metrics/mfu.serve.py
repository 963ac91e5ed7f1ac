"""The model FLOPs of the frames served in the traced run's window (counted
from the configuration's shapes, ``harness/flops.py``), over the window's
seconds and the H100 SXM's dense bf16 peak. The window runs without the
profiler; the seconds in which the harness copied the judge's sampled records
to the host are not the program's and are left out."""


def read(run):
    win = run["window"]
    seconds = win["seconds"] - win["kept_s"]
    if seconds <= 0 or not win["frames"]:
        return None
    return 100.0 * run["flops_per_frame"] * win["frames"] / seconds / run["peak_flops"]
