"""Drawing on uint8 RGB arrays (numpy), after Pillow's ``ImageDraw``.

The JAX package draws its overlays with Pillow; the port may not import it,
so these primitives follow Pillow's rasterization (its ``libImaging/Draw.c``)
on an [H, W, 3] uint8 array, in place:

* coordinates are truncated toward zero to integers (``int``), as Pillow's
  C casts do;
* a line of width 1 is integer Bresenham between the truncated endpoints,
  its last point drawn too (``line``);
* a wider line is Pillow's wide line: a 4-vertex polygon around the segment,
  filled by its scanline polygon filler in single precision (``line``);
* a rectangle's outline of width w is drawn inward: w rows at the top and
  bottom, w columns at each side (``rectangle``);
* a polygon's outline of width 1 is Bresenham from each vertex to the next,
  closed (``polygon``);
* text is drawn with the port's own 3x5 digit glyphs (``text``), not
  Pillow's font.

Everything off the canvas is clipped.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]


def _point(img: np.ndarray, x: int, y: int, color: Color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img: np.ndarray, x0: int, y: int, x1: int, color: Color) -> None:
    """Pixels x0..x1 of row y, clipped (Pillow's ``hline``)."""

    if not 0 <= y < img.shape[0]:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    x0, x1 = max(x0, 0), min(x1, img.shape[1] - 1)
    if x0 <= x1:
        img[y, x0:x1 + 1] = color


def _bresenham(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color: Color) -> None:
    """Pillow's ``line``: from (x0, y0) up to, not including, (x1, y1)."""

    dx, xs = (x1 - x0, 1) if x1 >= x0 else (x0 - x1, -1)
    dy, ys = (y1 - y0, 1) if y1 >= y0 else (y0 - y1, -1)
    if dx == 0:
        for _ in range(dy):
            _point(img, x0, y0, color)
            y0 += ys
    elif dy == 0:
        for _ in range(dx):
            _point(img, x0, y0, color)
            x0 += xs
    elif dx > dy:
        e = 2 * dy - dx
        for _ in range(dx):
            _point(img, x0, y0, color)
            if e >= 0:
                y0 += ys
                e -= 2 * dx
            e += 2 * dy
            x0 += xs
    else:
        e = 2 * dx - dy
        for _ in range(dy):
            _point(img, x0, y0, color)
            if e >= 0:
                x0 += xs
                e -= 2 * dy
            e += 2 * dx
            y0 += ys


_F = np.float32


def _round_up(f) -> int:
    """Pillow's ``ROUND_UP``: half away from zero. A float32 ``f`` adds its
    half in float32, as C's float arithmetic does."""

    half = _F(0.5) if isinstance(f, np.float32) else 0.5
    return int(math.floor(f + half) if f >= 0 else -math.floor(abs(f) + half))


def _round_down(f) -> int:
    """Pillow's ``ROUND_DOWN``: half toward zero (float32 as above)."""

    half = _F(0.5) if isinstance(f, np.float32) else 0.5
    return int(math.ceil(f - half) if f >= 0 else -math.ceil(abs(f) - half))


def _roundf(f: np.float32) -> np.float32:
    """C's ``roundf``: half away from zero."""

    return _F(math.copysign(math.floor(abs(f) + 0.5), f))


def _edge(x0: int, y0: int, x1: int, y1: int) -> dict:
    dx = _F(0.0) if y0 == y1 else _F(_F(x1 - x0) / _F(y1 - y0))
    return {"x0": x0, "y0": y0, "xmin": min(x0, x1), "xmax": max(x0, x1), "ymin": min(y0, y1),
            "ymax": max(y0, y1), "dx": dx}


def _edge_x(e: dict, y: int) -> np.float32:
    """The edge's x at row y in single precision, as Pillow computes it."""

    return _F(_F(_F(y - e["y0"]) * e["dx"]) + _F(e["x0"]))


def _fill_polygon(img: np.ndarray, edges: Sequence[dict], color: Color) -> None:
    """Pillow's scanline polygon fill (``polygon_generic``, no alpha)."""

    ymin, ymax, table = img.shape[0] - 1, 0, []
    for e in edges:
        ymin, ymax = min(ymin, e["ymin"]), max(ymax, e["ymax"])
        if e["ymin"] == e["ymax"]:
            _hline(img, e["xmin"], e["ymin"], e["xmax"], color)
        else:
            table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, img.shape[0])
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur["ymin"] <= y <= cur["ymax"]:
                continue
            xx.append(_edge_x(cur, y))
            if y == cur["ymax"] and y < ymax:
                xx.append(xx[-1])  # consistent polygons
            elif cur["dx"] != 0 and len(xx) % 2 == 1 and _roundf(xx[-1]) == xx[-1]:
                for k in range(i):  # discontiguous corners
                    other = table[k]
                    if (cur["dx"] > 0 and other["dx"] <= 0) or (cur["dx"] < 0 and other["dx"] >= 0):
                        continue
                    if _roundf(xx[-1]) == _roundf(_edge_x(other, y)):
                        off = -1 if y == ymax else 1
                        a, b = _edge_x(cur, y + off), _edge_x(other, y + off)
                        if y == cur["ymax"]:
                            xx[k] = _F(max(a, b) + 1) if cur["dx"] > 0 else _F(min(a, b) - 1)
                        else:
                            xx[k] = _F(min(a, b)) if cur["dx"] > 0 else _F(max(a, b) + 1)
                        break
        xx.sort()
        for i in range(1, len(xx), 2):
            _hline(img, _round_up(xx[i - 1]), y, _round_down(xx[i]), color)


def _wide_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color: Color, width: int) -> None:
    """Pillow's ``ImagingDrawWideLine``: the 4-vertex polygon around the
    segment, filled."""

    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        _point(img, x0, y0, color)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max, ratio_min = _round_up(small) / big, _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax), (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
    _fill_polygon(img, [_edge(*v[i], *v[(i + 1) % 4]) for i in range(4)], color)


def line(img: np.ndarray, xy: Sequence[Tuple[float, float]], color: Color, width: int = 1) -> None:
    """``ImageDraw.line`` through the points ``xy``."""

    p = [(int(x), int(y)) for x, y in xy]
    if width <= 1:
        for a, b in zip(p[:-1], p[1:]):
            _bresenham(img, *a, *b, color)
        if len(p) > 1:
            _point(img, *p[-1], color)
    else:
        for a, b in zip(p[:-1], p[1:]):
            _wide_line(img, *a, *b, color, width)


def rectangle(img: np.ndarray, box: Sequence[float], color: Color, width: int = 1) -> None:
    """``ImageDraw.rectangle`` outline of [x0, y0, x1, y1] (x1 >= x0,
    y1 >= y0), ``width`` pixels drawn inward."""

    x0, y0, x1, y1 = (int(v) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"rectangle {tuple(box)}: x1 must be >= x0 and y1 >= y0")
    width = max(width, 1)
    for i in range(width):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _bresenham(img, x1 - i, y0 + width, x1 - i, y1 - width + 1, color)
        _bresenham(img, x0 + i, y0 + width, x0 + i, y1 - width + 1, color)


def polygon(img: np.ndarray, xy: Sequence[Tuple[float, float]], color: Color) -> None:
    """``ImageDraw.polygon`` outline of width 1: Bresenham from each vertex
    to the next, back to the first."""

    p = [(int(x), int(y)) for x, y in xy]
    for i in range(len(p)):
        _bresenham(img, *p[i], *p[(i + 1) % len(p)], color)


# 3x5 glyphs, rows top to bottom, "#" lit
GLYPHS = {
    "0": ("###", "#.#", "#.#", "#.#", "###"), "1": (".#.", "##.", ".#.", ".#.", "###"),
    "2": ("###", "..#", "###", "#..", "###"), "3": ("###", "..#", "###", "..#", "###"),
    "4": ("#.#", "#.#", "###", "..#", "..#"), "5": ("###", "#..", "###", "..#", "###"),
    "6": ("###", "#..", "###", "#.#", "###"), "7": ("###", "..#", "..#", "..#", "..#"),
    "8": ("###", "#.#", "###", "#.#", "###"), "9": ("###", "#.#", "###", "..#", "###"),
    ".": ("...", "...", "...", "...", ".#."),
}
GLYPH_ADVANCE = 4  # 3 columns and a gap


def text_bbox(xy: Tuple[float, float], s: str) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), exclusive, of ``text``'s cells."""

    x, y = int(xy[0]), int(xy[1])
    return x, y, x + GLYPH_ADVANCE * len(s) - 1, y + 5


def text(img: np.ndarray, xy: Tuple[float, float], s: str, color: Color) -> None:
    """``s`` (digits and '.') in the 3x5 glyphs, its top-left at ``xy``."""

    x, y = int(xy[0]), int(xy[1])
    for ch in s:
        for r, row in enumerate(GLYPHS[ch]):
            for c, lit in enumerate(row):
                if lit == "#":
                    _point(img, x + c, y + r, color)
        x += GLYPH_ADVANCE
