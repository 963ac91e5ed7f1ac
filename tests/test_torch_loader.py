"""The port's native sample loader (``native/sample_loader``) on the CPU.

* ``load_points`` against the numpy ``load_points_filtered`` of both
  packages, bit for bit, and its cap;
* ``decode_png_canvas`` against a PIL decode: the JAX package's PNGs, the
  port's own, and PNGs built here whose rows use all five filter types, in
  RGB and RGBA; images larger than the canvas, kinds it does not read and
  damaged files raise; ``decode_png`` (the raw image alone) and
  ``png_size`` against PIL;
* a build that fails raises with the compiler's output.
"""

import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax
PIL_Image = pytest.importorskip("PIL.Image")

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import calib as j_calib  # noqa: E402
from sparse_pooling_tpu.data import pointcloud as j_pc  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data import calib as t_calib  # noqa: E402
from sparse_pooling_tpu_torch.data import pointcloud as t_pc  # noqa: E402
from sparse_pooling_tpu_torch.data import synthetic as t_syn  # noqa: E402
from sparse_pooling_tpu_torch.native import sample_loader as nl  # noqa: E402


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same 3 frames written by both packages' writers."""

    out = {}
    for name, writer in (("jax", j_syn.write_kitti_tree), ("port", t_syn.write_kitti_tree)):
        root = str(tmp_path_factory.mktemp(name))
        writer(root, num_frames=3, n_ground=5000, n_obj=300, val_frames=())
        out[name] = root
    return out


def _frame(root, sid):
    base = os.path.join(root, "training")
    return (os.path.join(base, "velodyne", sid + ".bin"), os.path.join(base, "calib", sid + ".txt"),
            os.path.join(base, "image_2", sid + ".png"))


@pytest.mark.parametrize("extents", [tcfg_mod.AreaExtents(),
                                     tcfg_mod.AreaExtents(x_min=-10.0, x_max=7.5, z_min=3.0, z_max=30.0)])
def test_points_match_the_numpy_twins(trees, extents):
    for i in range(3):
        velo, cal_path, _ = _frame(trees["jax"], f"{i:06d}")
        cal = t_calib.read_calibration(cal_path)
        got = nl.load_points(velo, cal.velo_to_rect(), cal.p2, (375, 1242), extents)
        want = t_pc.load_points_filtered(velo, cal, (375, 1242), extents)
        assert got.dtype == np.float32 and len(got) > 100
        np.testing.assert_array_equal(got, want)
        jext = jcfg_mod.AreaExtents(**dataclasses.asdict(extents))
        np.testing.assert_array_equal(got, j_pc.load_points_filtered(velo, j_calib.read_calibration(cal_path),
                                                                     (375, 1242), jext))
        # over the cap: None, and the caller takes the numpy twin's full set
        assert nl.load_points(velo, cal.velo_to_rect(), cal.p2, (375, 1242), extents, cap=len(got) - 1) is None
        np.testing.assert_array_equal(
            nl.load_points(velo, cal.velo_to_rect(), cal.p2, (375, 1242), extents, cap=len(got)), got)
    with pytest.raises(OSError, match="scan"):
        nl.load_points("/nonexistent.bin", cal.velo_to_rect(), cal.p2, (375, 1242), extents)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decode_matches_pil(trees, writer):
    for i in range(3):
        png = _frame(trees[writer], f"{i:06d}")[2]
        pil = np.asarray(PIL_Image.open(png).convert("RGB"))
        canvas, raw_hw = nl.decode_png_canvas(png, 384, 1248)
        assert raw_hw == pil.shape[:2] == (375, 1242)
        np.testing.assert_array_equal(canvas[:375, :1242], pil)
        assert not canvas[375:].any() and not canvas[:, 1242:].any()
        out = np.zeros((2, 384, 1248, 3), np.uint8)  # into a row of a batch, in place
        res, _ = nl.decode_png_canvas(png, 384, 1248, out=out[1])
        assert res is out[1] or np.shares_memory(res, out)
        np.testing.assert_array_equal(out[1], canvas)
        assert not out[0].any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_raw_decode_and_size_match_pil(trees, writer):
    """``decode_png`` (the raw image alone, for the host resize) and
    ``png_size`` (the header only) against PIL."""

    for i in range(3):
        png = _frame(trees[writer], f"{i:06d}")[2]
        pil = np.asarray(PIL_Image.open(png).convert("RGB"))
        assert nl.png_size(png) == pil.shape[:2] == (375, 1242)
        raw = nl.decode_png(png)
        assert raw.shape == pil.shape and raw.dtype == np.uint8 and raw.flags.c_contiguous
        np.testing.assert_array_equal(raw, pil)


def _png(img: np.ndarray, filters, color: int) -> bytes:
    """PNG bytes of ``img`` whose row y uses filter ``filters[y % len]``."""

    h, w, c = img.shape
    bpp = c
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
            enc = cur - pred
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,color", [(3, 2), (4, 6)])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_decode_undoes_every_row_filter(tmp_path, channels, color, filters):
    img = np.random.RandomState(sum(filters) + channels).randint(0, 256, (23, 31, channels)).astype(np.uint8)
    img[5:9] = 250  # runs where the predictors wrap past 255
    path = tmp_path / "f.png"
    path.write_bytes(_png(img, filters, color))
    pil = np.asarray(PIL_Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(pil, img[..., :3])
    canvas, raw_hw = nl.decode_png_canvas(str(path), 24, 40)
    assert raw_hw == (23, 31)
    np.testing.assert_array_equal(canvas[:23, :31], pil)


def test_decode_refuses_what_it_does_not_read(trees, tmp_path):
    png = _frame(trees["port"], "000000")[2]
    with pytest.raises(ValueError, match="exceeds the 375x1241 canvas"):
        nl.decode_png_canvas(png, 375, 1241)  # decode_png takes it whole
    with pytest.raises(ValueError, match="uint8"):
        nl.decode_png_canvas(png, 384, 1248, out=np.zeros((384, 1248, 3), np.float32))
    gray = tmp_path / "gray.png"
    PIL_Image.fromarray(np.zeros((4, 5), np.uint8)).save(gray)
    with pytest.raises(NotImplementedError, match="color type 0"):
        nl.decode_png_canvas(str(gray), 8, 8)
    broken = tmp_path / "broken.png"
    data = bytearray(open(png, "rb").read())
    data[40] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    broken.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="damaged"):
        nl.decode_png_canvas(str(broken), 384, 1248)
    bad_filter = tmp_path / "filter7.png"
    good = _png(np.zeros((3, 4, 3), np.uint8), (0,), 2)
    raw = zlib.decompress(good[8 + 25 + 8:-12 - 4])
    raw = bytes([7]) + raw[1:]
    idat = zlib.compress(raw)
    head = good[: 8 + 25]
    bad_filter.write_bytes(head + struct.pack(">I", len(idat)) + b"IDAT" + idat
                           + struct.pack(">I", zlib.crc32(b"IDAT" + idat)) + good[-12:])
    with pytest.raises(ValueError, match="malformed"):
        nl.decode_png_canvas(str(bad_filter), 4, 4)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'sample_loader.cpp:1: error: no luck' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="no luck"):
        nl.build()
    monkeypatch.setenv("CXX", str(tmp_path / "missing-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        nl.build()
    assert not list((tmp_path / "build").glob("*.so"))
