"""ctypes binding for the native KITTI AP evaluator
(``native/kitti_eval.cpp``, the port's copy of the JAX package's).

The library (``-DKITTI_EVAL_NO_MAIN``, the ``spt_evaluate_v2`` ABI) and the
``evaluate_object_3d`` CLI compile from the same source with ``g++`` at
first use into the git-ignored ``build/kitti_eval/`` (``native/cxx.py``:
keyed by a hash of the source and flags; a failed build raises with the
compiler's output). :func:`evaluate_dirs` has the signature and return
shape of the numpy oracle ``runtime.metrics.evaluate_dirs``, its twin in
the tests: ``{class: {"2d" | "bev" | "3d" | "aos": {"easy" | "moderate" |
"hard": AP}}}``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

from sparse_pooling_tpu_torch.native import cxx

SOURCE = Path(__file__).resolve().parent / "kitti_eval.cpp"
BUILD_DIR = cxx.BUILD_ROOT / "kitti_eval"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall")
METRICS = ("2d", "bev", "3d", "aos")
DIFFICULTY_NAMES = ("easy", "moderate", "hard")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """The shared library's path, compiled first if missing."""

    return cxx.build(SOURCE, BUILD_DIR, "kitti_eval", (*CXX_FLAGS, "-DKITTI_EVAL_NO_MAIN"))


def build_cli() -> Path:
    """The ``evaluate_object_3d`` executable's path, compiled first if
    missing: ``evaluate_object_3d <gt_dir> <det_dir> [classes_csv]
    [n_points]`` prints ``<cls> AP_<metric>: easy=.. moderate=.. hard=..``."""

    return cxx.build(SOURCE, BUILD_DIR, "evaluate_object_3d", CXX_FLAGS, shared=False)


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = cxx.load(build(), {"spt_evaluate_v2": (
                [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                 ctypes.POINTER(ctypes.c_double)], ctypes.c_int)})
    return _lib


def evaluate_dirs(gt_dir: str, det_dir: str, classes: Sequence[str],
                  n_points: int = 11) -> Dict[str, Dict[str, Dict[str, float]]]:
    """AP of the prediction txt files in ``det_dir`` against the labels of
    the same names in ``gt_dir`` (every value 0 when ``det_dir`` holds no
    txt file, as the oracle returns)."""

    out = (ctypes.c_double * (len(classes) * 12))()
    n = library().spt_evaluate_v2(gt_dir.encode(), det_dir.encode(), ",".join(classes).encode(),
                                  n_points, out)
    if n < 0:
        raise RuntimeError(f"spt_evaluate_v2 failed: {n}")
    values = iter(out)
    return {cls: {m: {d: next(values) for d in DIFFICULTY_NAMES} for m in METRICS} for cls in classes}
