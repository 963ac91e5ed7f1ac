"""Median device-stream time of the program's ``inputs.knn`` span (ContFuse's
points' canvas coordinates, lattice centres and the KNN tables of the four
fused lattices, replayed as their own CUDA graph) over the traced run's
collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "inputs.knn", "device_ms")
