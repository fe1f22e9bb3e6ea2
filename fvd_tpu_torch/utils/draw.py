"""Drawing on uint8 RGB images with numpy masks, in place of the OpenCV
drawing calls of the JAX package (the V3 and V4 viz and the synthetic face
clips).

Shapes are rasterised by testing pixel centres; the outlines differ from
OpenCV's by a pixel here and there, which no output of the pipeline reads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _window(img: np.ndarray, x0: float, y0: float, x1: float, y1: float):
    """Integer pixel window of ``img`` covering [x0, x1] x [y0, y1], clipped,
    and the pixel-centre coordinates inside it; None if empty."""
    h, w = img.shape[:2]
    xa, xb = max(0, int(np.floor(x0))), min(w, int(np.ceil(x1)) + 1)
    ya, yb = max(0, int(np.floor(y0))), min(h, int(np.ceil(y1)) + 1)
    if xa >= xb or ya >= yb:
        return None
    ys, xs = np.mgrid[ya:yb, xa:xb]
    return (slice(ya, yb), slice(xa, xb)), xs.astype(np.float64), ys.astype(np.float64)


def fill_ellipse(img: np.ndarray, center, axes, color) -> None:
    """Filled axis-aligned ellipse (``cv2.ellipse(..., 0, 0, 360, color, -1)``)."""
    cx, cy = center
    ax, ay = max(float(axes[0]), 0.5), max(float(axes[1]), 0.5)
    win = _window(img, cx - ax, cy - ay, cx + ax, cy + ay)
    if win is None:
        return
    sl, xs, ys = win
    inside = ((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0
    img[sl][inside] = color


def fill_disc(img: np.ndarray, center, radius: float, color) -> None:
    """Filled circle (``cv2.circle(..., -1)``)."""
    fill_ellipse(img, center, (radius, radius), color)


def line(img: np.ndarray, p0, p1, thickness: float, color) -> None:
    """A segment ``thickness`` pixels wide with round ends."""
    (x0, y0), (x1, y1) = (float(v) for v in p0), (float(v) for v in p1)
    r = max(thickness, 1.0) / 2.0
    win = _window(img, min(x0, x1) - r, min(y0, y1) - r, max(x0, x1) + r, max(y0, y1) + r)
    if win is None:
        return
    sl, xs, ys = win
    dx, dy = x1 - x0, y1 - y0
    denom = dx * dx + dy * dy
    t = np.clip(((xs - x0) * dx + (ys - y0) * dy) / denom, 0.0, 1.0) if denom else np.zeros_like(xs)
    dist2 = (xs - (x0 + t * dx)) ** 2 + (ys - (y0 + t * dy)) ** 2
    img[sl][dist2 <= r * r] = color


def polyline(img: np.ndarray, pts: Sequence, thickness: float, color) -> None:
    """An open polyline (``cv2.polylines(..., False, color, thickness)``)."""
    pts = np.asarray(pts, np.float64)
    for a, b in zip(pts[:-1], pts[1:]):
        line(img, a, b, thickness, color)


def rectangle(img: np.ndarray, p0, p1, thickness: int, color) -> None:
    """Rectangle outline (``cv2.rectangle``) with corners ``p0``, ``p1``."""
    (x0, y0), (x1, y1) = p0, p1
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)),
                 ((x0, y1), (x0, y0))):
        line(img, a, b, thickness, color)


#: 5x7 bitmaps of the glyphs the viz labels use (V4's ``"EAR: 0.27"``); a
#: character not listed draws as a space
_GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    "E": ("11111", "10000", "10000", "11110", "10000", "10000", "11111"),
    "A": ("01110", "10001", "10001", "11111", "10001", "10001", "10001"),
    "R": ("11110", "10001", "10001", "11110", "10100", "10010", "10001"),
    ":": ("00000", "01100", "01100", "00000", "01100", "01100", "00000"),
    ".": ("00000", "00000", "00000", "00000", "00000", "01100", "01100"),
    "-": ("00000", "00000", "00000", "11111", "00000", "00000", "00000"),
}


def put_text(img: np.ndarray, text: str, origin, scale: int, color) -> None:
    """``text`` in a 5x7 bitmap font, each font pixel ``scale`` pixels wide,
    with the bottom-left corner of the first glyph at ``origin`` (as
    ``cv2.putText`` places it); clipped to the image."""
    h, w = img.shape[:2]
    x0, bottom = int(origin[0]), int(origin[1])
    top = bottom - 7 * scale
    for ch in text:
        glyph = _GLYPHS.get(ch)
        if glyph is not None:
            mask = np.repeat(np.repeat(np.array([[c == "1" for c in row] for row in glyph]), scale, 0),
                             scale, 1)
            ya, xa = max(0, top), max(0, x0)
            yb, xb = min(h, top + mask.shape[0]), min(w, x0 + mask.shape[1])
            if ya < yb and xa < xb:
                img[ya:yb, xa:xb][mask[ya - top:yb - top, xa - x0:xb - x0]] = color
        x0 += 6 * scale
