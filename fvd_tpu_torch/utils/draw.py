"""Drawing on uint8 images with numpy, in place of the OpenCV drawing calls of
the JAX package (the V3 and V4 viz, the synthetic face clips and the
training images of :mod:`fvd_tpu_torch.models.synthetic_faces`).

The shapes are OpenCV's ``LINE_8`` rasterisation (``imgproc/src/drawing.cpp``)
in integer arithmetic: ellipses as the polygon of ``ellipse2Poly`` (its
whole-degree sine table, vertices in 16.16 fixed point) filled by
``FillConvexPoly`` or, for an arc, by the edge-list fill; lines by the
8-connected Bresenham walk, or for ``thickness > 1`` as a filled quad with
round caps (``ThickLine``); one-pixel circles by the midpoint walk.  As
OpenCV does, an ellipse rounds its rotation and arc angles to whole degrees.
``put_text`` is not OpenCV's font.  ``fill_ellipse_centres`` and
``polyline_centres`` test pixel centres instead: the synthetic clips keep
the faces they were measured with.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1
#: OpenCV's ``SinTable``: sin of each whole degree 0..450, to 7 decimals, as float32
_SIN = np.array(["%.7f" % np.sin(np.deg2rad(k)) for k in range(451)], np.float64).astype(np.float32)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round(x: float) -> int:
    """``cvRound``: to nearest, ties to even (as Python's ``round``)."""
    return round(x)


def _put(img: np.ndarray, xs, ys, color) -> None:
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h and x2 >= 0 and x1 < w:
        img[y, max(x1, 0):min(x2, w - 1) + 1] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """``clipLine`` of a segment to [0, w-1] x [0, h-1] -> (inside, x1, y1, x2, y2)."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """One-pixel line between integer points (``LineIterator``, 8-connected,
    left to right)."""
    pts = _line8_points(img.shape[1], img.shape[0], x1, y1, x2, y2)
    if pts is not None:
        _put(img, *pts, color)


def _line8_points(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels of :func:`_line8` as (xs, ys), or None."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return None
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # the walk's error term starts at major - 2 minor and steps across when
    # negative: point k is ceil((2 minor k - major) / (2 major)) across
    along = np.arange(major + 1, dtype=np.int64)
    across = np.maximum(-((major - 2 * minor * along) // (2 * major)), 0) if major else along
    if vert:
        return x1 + across, y1 + sy * along
    return x1 + along, y1 + sy * across


def _line2_points(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """The pixels of OpenCV's ``Line2`` (a one-pixel line between 16.16
    fixed-point points) as (xs, ys), the end point first, or None."""
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return None
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        step = _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        step = _cdiv(dx * XY_ONE, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    k = np.arange(-1, ecount + 1, dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    xs[0], ys[0] = (x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT
    return xs, ys


def _fill_convex(img: np.ndarray, v, color, shift: int = XY_SHIFT) -> None:
    """``FillConvexPoly`` of integer vertices with ``shift`` fraction bits:
    the outline by ``Line2``, then one span per row between two edges."""
    h, w = img.shape[:2]
    n = len(v)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    outline = []
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << up, y << up)
        if shift == 0:
            outline.append(_line8_points(w, h, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT,
                                         p[0] >> XY_SHIFT, p[1] >> XY_SHIFT))
        else:
            outline.append(_line2_points(w, h, p0[0], p0[1], p[0], p[1]))
        p0 = p
    outline = [pts for pts in outline if pts is not None]
    if outline:
        _put(img, np.concatenate([p[0] for p in outline]), np.concatenate([p[1] for p in outline]), color)
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx_, di_ = [imin, imin], [1, n - 1]
    ex, edx, eye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y >= eye[i]:
                idx0, di = idx_[i], di_[i]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        eye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        ex[i] = xs
                        idx_[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            _hline(img, y, (ex[left] + _HALF) >> XY_SHIFT, (ex[right] + _HALF) >> XY_SHIFT, color)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _fill_edges(img: np.ndarray, v, color, shift: int = XY_SHIFT) -> None:
    """``CollectPolyEdges`` + ``FillEdgeCollection`` of a polygon with
    ``shift`` fraction bits (the fill of an elliptic arc and its centre)."""
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    edges = []
    pt0 = (v[-1][0] << up, (v[-1][1] + delta) >> shift)
    for x, y in v:
        pt1 = (x << up, (y + delta) >> shift)
        t0 = [(pt0[0] + _HALF) >> XY_SHIFT, pt0[1]]
        t1 = [(pt1[0] + _HALF) >> XY_SHIFT, pt1[1]]
        _line8(img, t0[0], t0[1], t1[0], t1[1], color)
        c0, c1 = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            _, t0[0], t0[1], t1[0], t1[1] = _clip_line(w, h, t0[0], t0[1], t1[0], t1[1])
            if t0[1] != t1[1]:
                c0, c1 = [t0[0] << XY_SHIFT, t0[1]], [t1[0] << XY_SHIFT, t1[1]]
        if pt0[1] != pt1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append((pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
            else:
                edges.append((pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
        pt0 = pt1
    if len(edges) < 2:
        return
    y0s = [e[0] for e in edges]
    ends = [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    y_min, y_max = min(y0s), max(e[1] for e in edges)
    xs_all = [e[2] for e in edges] + ends
    if y_max < 0 or y_min >= h or max(xs_all) < 0 or min(xs_all) >= (w << XY_SHIFT):
        return
    for y in range(max(y_min, 0), min(y_max, h)):
        xs = sorted(e[2] + (y - e[0]) * e[3] for e in edges if e[0] <= y < e[1])
        for a, b in zip(xs[0::2], xs[1::2]):
            _hline(img, y, (a + XY_ONE - 1) >> XY_SHIFT, b >> XY_SHIFT, color)


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, color, fill: bool) -> None:
    """OpenCV's midpoint ``Circle``: a one-pixel ring, or filled spans."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    xs, ys = [], []
    while dx >= dy:
        if fill:
            for yy, a, b in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                             (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
                _hline(img, yy, a, b, color)
        else:
            xs += [cx - dx, cx - dx, cx + dx, cx + dx, cx - dy, cx - dy, cx + dy, cx + dy]
            ys += [cy - dy, cy + dy, cy - dy, cy + dy, cy - dx, cy + dx, cy - dx, cy + dx]
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    if xs:
        _put(img, xs, ys, color)


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int, shift: int) -> None:
    """``ThickLine``: a one-pixel line, or a filled quad ``thickness`` wide
    with a filled circle at the ends that ``flags`` names (1 start, 2 end)."""
    up = XY_SHIFT - shift
    p0, p1 = (p0[0] << up, p0[1] << up), (p1[0] << up, p1[1] << up)
    if thickness <= 1:
        # OpenCV 5 draws a one-pixel LINE_8 line between the rounded end
        # points whatever its fraction bits
        _line8(img, (p0[0] + _HALF) >> XY_SHIFT, (p0[1] + _HALF) >> XY_SHIFT,
               (p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT, color)
        return
    dx, dy = (p0[0] - p1[0]) / XY_ONE, (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = _round(dy * r), _round(dx * r)
        _fill_convex(img, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                           (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)], color)
    for i in range(2):
        if flags & (i + 1):
            _circle(img, (p0[0] + _HALF) >> XY_SHIFT, (p0[1] + _HALF) >> XY_SHIFT,
                    (thickness + _HALF) >> XY_SHIFT, color, fill=True)
        p0 = p1


def _polyline(img: np.ndarray, v, color, thickness: int, shift: int) -> None:
    """``PolyLine`` of an open polyline."""
    flags = 3
    for a, b in zip(v[:-1], v[1:]):
        _thick_line(img, a, b, color, thickness, flags, shift)
        flags = 2


def _ellipse_poly(cx: float, cy: float, ax: float, ay: float, angle: int, start: int, end: int, delta: int):
    """``ellipse2Poly`` (double): the arc's vertices, every ``delta`` degrees."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if start > end:
        start, end = end, start
    while start < 0:
        start, end = start + 360, end + 360
    while end > 360:
        start, end = start - 360, end - 360
    if end - start > 360:
        start, end = 0, 360
    alpha, beta = float(_SIN[450 - angle]), float(_SIN[angle])
    pts = []
    for i in range(start, end + delta, delta):
        a = min(i, end)
        if a < 0:
            a += 360
        x, y = ax * float(_SIN[450 - a]), ay * float(_SIN[a])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    return pts if len(pts) != 1 else [(cx, cy), (cx, cy)]


def _ellipse(img: np.ndarray, center, axes, angle, start, end, color, thickness: int) -> None:
    """``cv2.ellipse`` (``EllipseEx``) with integer centre and axes."""
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    ax, ay = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    angle, start, end = _round(angle), _round(start), _round(end)
    delta = (max(ax, ay) + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v, prev = [], None
    for x, y in _ellipse_poly(float(cx), float(cy), float(ax), float(ay), angle, start, end, delta):
        px, py = _round(x / XY_ONE) << XY_SHIFT, _round(y / XY_ONE) << XY_SHIFT
        pt = (px + _round(x - px), py + _round(y - py))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    if thickness >= 0:
        _polyline(img, v, color, thickness, XY_SHIFT)
    elif end - start >= 360:
        _fill_convex(img, v, color)
    else:
        _fill_edges(img, v + [(cx, cy)], color)


def fill_ellipse(img: np.ndarray, center, axes, color, angle: float = 0.0, start: float = 0.0,
                 end: float = 360.0) -> None:
    """``cv2.ellipse(img, center, axes, angle, start, end, color, -1)``: a
    filled ellipse rotated by ``angle`` degrees; an arc shorter than 360
    degrees fills the sector between the arc and the centre (``0, 180`` the
    lower half, ``180, 360`` the upper)."""
    _ellipse(img, center, axes, angle, start, end, color, -1)


def ellipse(img: np.ndarray, center, axes, angle: float, start: float, end: float, color,
            thickness: int) -> None:
    """``cv2.ellipse(img, center, axes, angle, start, end, color,
    thickness)``: an arc outline ``thickness`` wide, or filled where
    ``thickness`` < 0."""
    _ellipse(img, center, axes, angle, start, end, color, int(thickness))


def circle(img: np.ndarray, center, radius: int, color, thickness: int) -> None:
    """``cv2.circle(img, center, radius, color, thickness)``; a negative
    ``thickness`` fills it."""
    cx, cy, r = int(center[0]), int(center[1]), int(radius)
    if thickness > 1:
        _ellipse(img, (cx, cy), (r, r), 0, 0, 360, color, thickness)
    else:
        _circle(img, cx, cy, r, color, fill=thickness < 0)


def fill_disc(img: np.ndarray, center, radius: int, color) -> None:
    """Filled circle (``cv2.circle(..., -1)``)."""
    circle(img, center, radius, color, -1)


def fill_rectangle(img: np.ndarray, p0, p1, color) -> None:
    """``cv2.rectangle(img, p0, p1, color, -1)``: every pixel with both
    corners' coordinates inclusive, clipped to the image."""
    h, w = img.shape[:2]
    xa, xb = max(0, min(p0[0], p1[0])), min(w - 1, max(p0[0], p1[0]))
    ya, yb = max(0, min(p0[1], p1[1])), min(h - 1, max(p0[1], p1[1]))
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = color


def line(img: np.ndarray, p0, p1, thickness: int, color) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` between integer points."""
    _thick_line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), color, int(thickness), 3, 0)


def polyline(img: np.ndarray, pts: Sequence, thickness: int, color) -> None:
    """An open polyline (``cv2.polylines(img, [pts], False, color, thickness)``)."""
    _polyline(img, [(int(x), int(y)) for x, y in np.asarray(pts)], color, int(thickness), 0)


def rectangle(img: np.ndarray, p0, p1, thickness: int, color) -> None:
    """Rectangle outline (``cv2.rectangle``) with corners ``p0``, ``p1``."""
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    corners = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    if thickness <= 1:
        for a, b in zip(corners, corners[1:] + corners[:1]):
            _line8(img, *a, *b, color)
    else:
        _polyline(img, corners + corners[:1], color, int(thickness), 0)


# pixel-centre shapes: the synthetic clips of ``synthetic.make_face_video``
# keep the faces they were drawn with before the OpenCV rasterisation above
def _centres(img: np.ndarray, x0: float, y0: float, x1: float, y1: float):
    """Integer pixel window of ``img`` covering [x0, x1] x [y0, y1], clipped,
    and the pixel-centre coordinates inside it; None if empty."""
    h, w = img.shape[:2]
    xa, xb = max(0, int(np.floor(x0))), min(w, int(np.ceil(x1)) + 1)
    ya, yb = max(0, int(np.floor(y0))), min(h, int(np.ceil(y1)) + 1)
    if xa >= xb or ya >= yb:
        return None
    ys, xs = np.mgrid[ya:yb, xa:xb]
    return (slice(ya, yb), slice(xa, xb)), xs.astype(np.float64), ys.astype(np.float64)


def fill_ellipse_centres(img: np.ndarray, center, axes, color) -> None:
    """The pixels whose centres lie in an axis-aligned ellipse."""
    cx, cy = center
    ax, ay = max(float(axes[0]), 0.5), max(float(axes[1]), 0.5)
    win = _centres(img, cx - ax, cy - ay, cx + ax, cy + ay)
    if win is not None:
        sl, xs, ys = win
        img[sl][((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0] = color


def polyline_centres(img: np.ndarray, pts: Sequence, thickness: float, color) -> None:
    """The pixels whose centres lie within ``thickness / 2`` of an open
    polyline (round ends)."""
    pts = np.asarray(pts, np.float64)
    r = max(thickness, 1.0) / 2.0
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        win = _centres(img, min(x0, x1) - r, min(y0, y1) - r, max(x0, x1) + r, max(y0, y1) + r)
        if win is None:
            continue
        sl, xs, ys = win
        dx, dy = x1 - x0, y1 - y0
        denom = dx * dx + dy * dy
        t = np.clip(((xs - x0) * dx + (ys - y0) * dy) / denom, 0.0, 1.0) if denom else np.zeros_like(xs)
        img[sl][(xs - (x0 + t * dx)) ** 2 + (ys - (y0 + t * dy)) ** 2 <= r * r] = color


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
