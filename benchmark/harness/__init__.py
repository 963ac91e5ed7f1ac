"""The benchmark harness: one run of one cell, driven by the data files
beside it (``configs/``, ``workloads/``, ``traffic/``, ``metrics/``)."""
