"""The g++ build of the port's native host libraries and tools.

Each native source under ``native/`` compiles at first use into its own
git-ignored directory ``build/<name>/`` at the repository root, named by a
hash of the source and the flags: an edited source is rebuilt, an unchanged
one reused. A failed compile raises with the compiler's output; nothing
falls back to another path. The compiler is ``$CXX``, else ``g++``.

A shared library keeps its symbols to itself (``SHARED_FLAGS``): a
compiler may link the C++ runtime statically (the card machine's ``$CXX``
does), and a library loaded into a Python process that already holds the
shared C++ runtime must not mix the two copies' symbols (iostreams then
crash inside the call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"

SHARED_FLAGS = ("-fPIC", "-shared", "-Wl,--exclude-libs,ALL", "-Wl,-Bsymbolic")

# argtypes and restype of one exported function
Signature = Tuple[Sequence, object]


def build(source: Path, out_dir: Path, stem: str, flags: Sequence[str], shared: bool = True) -> Path:
    """Compile ``source`` with ``flags`` into ``out_dir/<stem>-<hash>.so``
    (``shared``, with ``SHARED_FLAGS``) or the executable
    ``out_dir/<stem>-<hash>`` unless it exists; returns its path. Raises
    ``RuntimeError`` with the compiler's output if the compile fails or the
    compiler is missing."""

    flags = (*flags, *SHARED_FLAGS) if shared else tuple(flags)
    suffix = ".so" if shared else ""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(flags).encode())
    out = Path(out_dir) / f"{stem}-{h.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [os.environ.get("CXX", "g++"), *flags, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{stem} build failed: {cmd[0]} not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{stem} build failed (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: processes that build at once agree
    return out


def load(path: Path, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """``ctypes.CDLL`` of ``path`` with each named function's argtypes and
    restype set."""

    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), restype
    return lib
