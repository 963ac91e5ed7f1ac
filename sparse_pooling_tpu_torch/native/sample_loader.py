"""ctypes binding for the native per-frame sample loader
(``native/sample_loader.cpp``).

The library is compiled with ``g++`` at first use into the git-ignored
``build/sample_loader/`` at the repository root (``native/cxx.py``: named by
a hash of the source and flags; a failed build raises with the compiler's
output). It needs no library beyond the C++ runtime. ctypes releases the
GIL during each call, as ``zlib.decompress`` does while it inflates, so a
loader thread overlaps the training step.

- :func:`decode_png_canvas`: a PNG (8-bit RGB or RGBA, not interlaced) into
  the top left of a zeroed [H, W, 3] u8 canvas: Python reads the chunks and
  inflates the IDAT stream with ``zlib``, the library undoes the row filters
  straight into the canvas. Pixel-equal to a PIL decode of the same file.
  :func:`decode_png` decodes the raw [h, w, 3] image alone (for the host
  resize, ``data/pil_resize.py``); :func:`png_size` reads the header only.
- :func:`load_points`: ``data.pointcloud.load_points_filtered`` in one pass,
  the same f32 operations in the same order.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sparse_pooling_tpu_torch.native import cxx

SOURCE = Path(__file__).resolve().parent / "sample_loader.cpp"
BUILD_DIR = cxx.BUILD_ROOT / "sample_loader"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the library if it is missing; raises with the compiler's
    output if the compile fails. Returns its path."""

    return cxx.build(SOURCE, BUILD_DIR, "sample_loader", CXX_FLAGS)


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""

    global _lib
    with _lock:
        if _lib is None:
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            _lib = cxx.load(build(), {
                "spt_unfilter_png": ([u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
                                      ctypes.c_int], ctypes.c_int),
                "spt_load_points": ([ctypes.c_char_p, f32p, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
                                     ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
            })
    return _lib


def read_png(path: str) -> Tuple[int, int, int, bytes]:
    """(height, width, channels, inflated IDAT stream) of an 8-bit RGB or
    RGBA PNG that is not interlaced; raises ``NotImplementedError`` for
    other kinds and ``ValueError`` for a damaged file (signature, chunk CRC,
    stream length)."""

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: damaged {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, color type {color}, interlace {interlace}; "
            "the loader reads 8-bit RGB or RGBA that is not interlaced")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (1 + width * channels):
        raise ValueError(f"{path}: IDAT holds {len(raw)} bytes, not {height} rows of {width} pixels")
    return height, width, channels, raw


def decode_png_canvas(path: str, canvas_h: int, canvas_w: int,
                      out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode ``path`` into a zeroed canvas [canvas_h, canvas_w, 3] u8 (raw
    content top left) -> (canvas, (raw_h, raw_w)).

    ``out``: a caller's ZERO-FILLED C-contiguous canvas of that shape (e.g.
    one row of a batch array), written in place; only the raw image's region
    is written. A raw image larger than the canvas raises ``ValueError``
    (``decode_png`` takes it whole, for the host resize)."""

    if out is None:
        out = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    elif out.shape != (canvas_h, canvas_w, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 [{canvas_h}, {canvas_w}, 3] array")
    h, w, channels, raw = read_png(path)
    if h > canvas_h or w > canvas_w:
        raise ValueError(f"{path}: raw image {h}x{w} exceeds the {canvas_h}x{canvas_w} canvas")
    _unfilter(path, raw, h, w, channels, out)
    return out, (h, w)


def decode_png(path: str) -> np.ndarray:
    """Decode ``path`` into a new [h, w, 3] u8 array (its own size)."""

    h, w, channels, raw = read_png(path)
    out = np.empty((h, w, 3), np.uint8)
    _unfilter(path, raw, h, w, channels, out)
    return out


def _unfilter(path: str, raw: bytes, h: int, w: int, channels: int, out: np.ndarray) -> None:
    scratch = np.frombuffer(bytearray(raw), np.uint8)  # unfiltered in place
    rc = library().spt_unfilter_png(scratch, h, w, channels, out, out.shape[0], out.shape[1])
    if rc != 0:
        raise ValueError(f"{path}: malformed PNG rows (rc {rc})")


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) from a PNG's header, without decoding it."""

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def load_points(
    velo_path: str,
    velo_to_rect: np.ndarray,  # [3+, 4] (FrameCalib.velo_to_rect)
    p2: np.ndarray,  # [3, 4]
    image_shape: Tuple[int, int],
    extents,  # AreaExtents
    cap: int = 1 << 18,
) -> Optional[np.ndarray]:
    """Fused scan load + frustum + area-extents filter -> (N, 3) f32 in scan
    order, or None when more than ``cap`` points survive (the numpy twin then
    takes its seeded subsample of the full set). Raises ``OSError`` if the
    scan cannot be read."""

    m = np.ascontiguousarray(velo_to_rect[:3], np.float32)
    p = np.ascontiguousarray(p2, np.float32)
    ext = np.array([extents.x_min, extents.x_max, extents.y_min, extents.y_max,
                    extents.z_min, extents.z_max], np.float32)
    out = np.empty((cap, 3), np.float32)
    n = ctypes.c_int()
    rc = library().spt_load_points(velo_path.encode(), m, p, image_shape[0], image_shape[1], ext,
                                   out, cap, ctypes.byref(n))
    if rc != 0:
        raise OSError(f"cannot read the scan {velo_path}")
    if n.value > cap:
        return None
    return out[: n.value]
