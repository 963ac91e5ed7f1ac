"""ctypes binding for the native KITTI prediction-row formatter
(``native/pred_format.cpp``, the port's copy of the JAX package's).

:func:`format_rows` renders the prediction writer's ``[N, 13]`` numeric
block into the txt file's bytes, byte-identical to the Python ``%.6f``
formatter in ``runtime.predictions`` (glibc's ``snprintf`` and CPython both
round correctly). The library compiles with ``g++`` at first use into the
git-ignored ``build/pred_format/`` (``native/cxx.py``); a failed build
raises with the compiler's output, and nothing falls back to the Python
formatter. The call releases the GIL.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from sparse_pooling_tpu_torch.native import cxx

SOURCE = Path(__file__).resolve().parent / "pred_format.cpp"
BUILD_DIR = cxx.BUILD_ROOT / "pred_format"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall")
MAX_CLASSES = 64  # the formatter's table of class names

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """The library's path, compiled first if missing."""

    return cxx.build(SOURCE, BUILD_DIR, "pred_format", CXX_FLAGS)


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            _lib = cxx.load(build(), {"spt_format_kitti_rows": (
                [f64p, i32p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int],
                ctypes.c_int)})
    return _lib


def format_rows(num: np.ndarray, cls: np.ndarray, class_names: Sequence[str]) -> bytes:
    """``num`` [N, 13] f64 (alpha x1 y1 x2 y2 h w l x y z ry score) and
    ``cls`` [N] indices into ``class_names`` -> the file's bytes, one
    ``<name> -1 -1 <13 x %.6f>\\n`` row each."""

    if len(class_names) > MAX_CLASSES or any("\n" in c for c in class_names):
        raise ValueError(f"the formatter takes up to {MAX_CLASSES} class names without newlines")
    num = np.ascontiguousarray(num, np.float64)
    cls = np.ascontiguousarray(cls, np.int32)
    n = int(num.shape[0])
    if num.shape != (n, 13) or cls.shape != (n,):
        raise ValueError(f"num must be [N, 13] and cls [N], got {num.shape} and {cls.shape}")
    if n == 0:
        return b""
    # a field's " %.6f" of an image coordinate or box value stays well under
    # 32 bytes; the name, " -1 -1" and the newline under 80
    cap = n * (13 * 32 + 80)
    out = ctypes.create_string_buffer(cap)
    rc = library().spt_format_kitti_rows(num, cls, n, "\n".join(class_names).encode(), out, cap)
    if rc < 0:
        raise ValueError("a row overflows the formatter's buffer or names a class out of range")
    return out.raw[:rc]
