"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by one ``nvcc`` call into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries go to ``build/torch_kernels/`` at the
repository root, named by a hash of the sources and flags, so an edited
source is rebuilt on first use and an unchanged one is loaded as is.
``build_all`` starts every compile at once, under a file lock, so ranks
that start together build each library once.

Each kernel is also a PyTorch operator of the ``spt`` namespace
(``torch.ops.spt.*``, defined on ``OPS`` by the ops module that wraps it):
its CUDA implementation launches the kernel through the counted wrapper, its
CPU implementation is the plain twin, and a fake implementation gives the
output shapes to ``torch.export`` and the compilers, which cannot see into
a ``ctypes`` call. ``OPS`` is the lower-level ``torch.library.Library``
route, which ``torch.library.custom_op`` wraps in more Python per call.

Nothing here builds at import: the CPU tests import every module, and a
machine without a card need not have ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNEL_SOURCES = ("sparse_pool_patch", "ell_sparse_pool", "group_crop", "greedy_nms", "bev_knn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: the kernels' f32 geometry rounds at
    # the same places as the reference's separate multiplies and adds
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (argument types, result type) of each C export, set once when its library
# loads, so a wrapper's call pays no ctypes set-up
SIGNATURES = {
    "sparse_pool_patch": {
        "sparse_pool_patch_scratch_ints": ([_I] * 4, ctypes.c_longlong),
        "sparse_pool_patch_launch": ([_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
        "sparse_pool_patch_bwd_scratch_ints": ([_I] * 4, ctypes.c_longlong),
        "sparse_pool_patch_bwd_launch": ([_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
    },
    "ell_sparse_pool": {
        "ell_sparse_pool_launch": ([_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P], _I),
    },
    "group_crop": {
        "group_crop_launch": ([_P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P], _I),
        "group_crop_bwd_launch": ([_P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I),
        "group_crop_bwd_split_launch": (
            [_P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P], _I),
    },
    "greedy_nms": {
        "greedy_nms_max_candidates": ([], _I),
        "greedy_nms_launch": ([_P, _P, _I, _I, _I, ctypes.c_float, _P, _P, _P], _I),
    },
    "bev_knn": {
        "bev_knn_max_bins": ([], _I),
        "bev_knn_k": ([], _I),
        "bev_knn_launch": ([_P, _I, _I, _I, _P, _P, _I, _I] + [ctypes.c_float] * 3 + [_I, _I]
                           + [ctypes.c_float] * 2 + [_P] * 6, _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}

# the port's operators; kept alive as long as the process (a Library
# unregisters its operators when it is collected)
OPS = torch.library.Library("spt", "DEF")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every kernel library that is missing, all in parallel.
    Returns {name: seconds} for the libraries built (0.0 if up to date);
    raises with the compiler's output if any compile fails."""

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return _build_missing(names)


def _build_missing(names) -> Dict[str, float]:
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` (ptxas resources)."""

    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""

    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        for symbol, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""

    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_ptr(device_index: int) -> int:
    """The raw handle of the device's current stream. This is the accessor
    Triton's launcher uses: ``torch.cuda.current_stream()`` builds a Python
    Stream object on every call, which costs the host more than the ctypes
    launch it feeds."""

    return torch._C._cuda_getCurrentRawStream(device_index)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32, bfloat16)")
    return DTYPE_CODES[t.dtype]


def require_cuda(*tensors: torch.Tensor, what: str) -> int:
    """Every tensor on the current CUDA device and contiguous; returns the
    device's index."""

    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{what}: tensor on {t.device}, expected cuda")
    index = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != index:
            raise ValueError(f"{what}: tensor on {t.device}, expected cuda:{index}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return index


def counted(launcher):
    """Give a kernel wrapper its launch count: ``wrapper.launches`` grows by
    one each time the launcher returns, i.e. each time the kernel launched
    (a refused launch raises first and is not counted)."""

    @functools.wraps(launcher)
    def wrapper(*args, **kwargs):
        out = launcher(*args, **kwargs)
        wrapper.launches += 1
        return out

    wrapper.launches = 0
    return wrapper
