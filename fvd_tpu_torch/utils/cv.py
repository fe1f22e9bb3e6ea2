"""OpenCV-exact host image helpers: the calls of ``cv2`` that the JAX
package's OCR, CLIP, recorded LLM and training-data generators make on the
host, for a machine without OpenCV.

* :func:`resize_linear_u8` is ``cv2.resize(img, (w, h))`` (INTER_LINEAR) on
  uint8: 11-bit fixed-point tap weights, a horizontal pass kept as integers
  and a vertical pass that rounds, as OpenCV's generic resize does for 8-bit
  images; not float bilinear.
* :func:`rgb_to_gray_u8` is ``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``: 15-bit
  fixed-point luma weights, rounded.
* :func:`component_boxes` is the stats table of
  ``cv2.connectedComponentsWithStats(mask)`` (8-connectivity) without the
  background row, in OpenCV's label order, on ``scipy.ndimage.label``.
* :func:`laplacian_f32` is ``cv2.Laplacian(img.astype(np.float32),
  cv2.CV_32F)``: ksize 1, the kernel ``[[0, 1, 0], [1, -4, 1], [0, 1, 0]]``
  with ``BORDER_REFLECT_101``.  On uint8 input every value is an integer
  below 2^24, so float32 holds each sum exactly in any order.
* :func:`rotation_matrix_2d` is ``cv2.getRotationMatrix2D``, bit for bit
  (the centre passes through float32, as OpenCV's ``Point2f`` takes it).
* :func:`warp_affine_u8` is ``cv2.warpAffine(img, M, (w, h),
  flags=cv2.INTER_LINEAR)`` with its constant 0 border, and
  :func:`warp_perspective_u8` is ``cv2.warpPerspective(img, M, (w, h),
  borderMode=cv2.BORDER_REPLICATE)``, both as OpenCV 5 computes them for
  uint8: the inverse map in double, the source coordinates in float32 (a
  fused multiply-add along the row), the bilinear blend in float32 fused
  multiply-adds, rounded half to even.  The columns past the affine warp's
  16-pixel vector loop (all of them in an image under 16 wide) take their
  source coordinates as its scalar C++ does, ``fma(x, m0, y * m1) + m2``.
  Both warps match bit for bit.
* :func:`perspective_transform` is ``cv2.getPerspectiveTransform``: the same
  8x8 system, solved by LAPACK instead of OpenCV's own LU (the matrices
  agree to rounding; the warps of ``synthetic_pose`` come out bit-equal).
* :func:`warp_affine_f32` is ``cv2.warpAffine(img, M, (w, h),
  borderMode=cv2.BORDER_REPLICATE)`` on float32: the same map and blend as
  the uint8 warp without the final rounding, bit for bit on the OCR's
  ``[32, 256]`` lines.
* :func:`blur_u8` is ``cv2.blur(img, (k, k))`` on uint8: the integer window
  sum over ``BORDER_REFLECT_101``, divided by ``k * k`` and rounded (no ties
  for odd ``k``), bit for bit.
* :func:`gaussian_blur_f32` is ``cv2.GaussianBlur(img, (k, k), sigma)`` on
  float32 for any odd ``k``:
  the kernel of ``cv2.getGaussianKernel(k, sigma, cv2.CV_32F)``
  (:func:`gaussian_kernel_f32`), a row pass and a column pass over
  ``BORDER_REFLECT_101`` in the orders of OpenCV's separable filters.  The
  row pass of ``k = 3`` is ``fma(s0, g0, g1 * (s-1 + s+1))``, of ``k = 5``
  ``fma(g2, s-2 + s+2, fma(s0, g0, g1 * (s-1 + s+1)))`` (its small
  symmetric row filter), of ``k >= 7`` every tap left to right; the column
  pass is ``g0 * s0`` and then ``g_j * (s-j + s+j)`` added for ``j = 1 ..
  k // 2``.  Each step is a fused multiply-add in OpenCV's 8-lane vector
  loop and in the 2- (``k <= 5``) or 4-wide steps of its scalar row tail,
  a rounded product and sum in the rest of a row's tail.  Bit for bit
  where a row's values (pixels times channels) are a multiple of 4, as at
  every shape of the realism levers; otherwise the last one to three values
  of a row's pass at some ``k >= 7`` are summed in an order not ported
  (a few units in the last place).
* :func:`filter2d` is ``cv2.filter2D(img, -1, kernel)`` on float32 or float64
  for kernels under 130 taps, over ``BORDER_REFLECT_101``.  On float32
  (OpenCV's direct filter) the nonzero taps in row-major order, each a
  fused multiply-add in the vector loop and a rounded product and sum in a
  row's last ``n % 8`` values: bit for bit.  On float64 the same taps as
  rounded products and sums, which is OpenCV's direct filter for kernels
  under 50 taps (bit for bit); from 50 taps OpenCV filters float64 through
  the DFT and agrees within 2e-13 at 255.
* :func:`resize_linear_f32` is ``cv2.resize(img, (w, h))`` (INTER_LINEAR) on
  float32, which OpenCV 5 computes as its warps do: float32 source
  coordinates ``fma(src / dst, x, (src / dst - 1) / 2)`` and the float32
  fused-multiply-add blend of :func:`warp_affine_f32`, edges replicated.  Bit
  for bit where ``src / dst`` is exact in float32 (the 2x shrink of 256-px
  crops); at other ratios OpenCV's coordinates round apart from these, by
  about 1e-3 of a level at 255.
* :func:`warp_affine_zero_f32` is ``cv2.warpAffine(img, M, (w, h))``
  (INTER_LINEAR, constant 0 border) on float32.
* :func:`dilate2_f32` and :func:`erode2_f32` are ``cv2.dilate`` and
  ``cv2.erode`` with ``np.ones((2, 2))``: the anchor at (1, 1), so each
  output takes the max (min) of itself and its upper and left neighbours,
  and taps outside the image are ignored; exact.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's first source tap of each output pixel of one axis and the
    float32 fraction towards the next tap."""
    scale = 1.0 / (dst / src)  # OpenCV: scale = 1 / inv_scale, inv_scale = dst / src
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _round_weights(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    # saturate_cast<short>(x * 2048) rounds half to even, as np.rint does
    w0 = np.rint((np.float32(1.0) - f).astype(np.float32) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return w0, w1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` for a uint8 ``[H, W]`` or
    ``[H, W, C]`` image, bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    # horizontal: a source column left of 0 or at/after the last one takes
    # one tap at full weight (OpenCV zeroes the fraction there)
    sx, fx = _linear_taps(w, width)
    low, high = sx < 0, sx >= w - 1
    sx = np.where(low, 0, np.where(high, w - 1, sx))
    fx = np.where(low | high, np.float32(0.0), fx).astype(np.float32)
    ax0, ax1 = _round_weights(fx)
    x = img.astype(np.int64)
    rows = x[:, sx] * ax0.reshape((-1,) + (1,) * (x.ndim - 2)) \
        + x[:, np.minimum(sx + 1, w - 1)] * ax1.reshape((-1,) + (1,) * (x.ndim - 2))
    # vertical: rows are clamped to the image, the fraction is kept
    sy, fy = _linear_taps(h, height)
    by0, by1 = _round_weights(fy)
    r0 = rows[np.clip(sy, 0, h - 1)]
    r1 = rows[np.clip(sy + 1, 0, h - 1)]
    shape = (-1,) + (1,) * (rows.ndim - 1)
    out = (((by0.reshape(shape) * (r0 >> 4)) >> 16) + ((by1.reshape(shape) * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


#: ``cv2.COLOR_RGB2GRAY``'s weights of R, G and B, scaled by 2**15
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for a uint8 ``[H, W, 3]``
    image, bit for bit."""
    x = np.asarray(img).astype(np.int32)
    y = x[..., 0] * _GRAY_R + x[..., 1] * _GRAY_G + x[..., 2] * _GRAY_B
    return ((y + (1 << 14)) >> 15).astype(np.uint8)


def component_boxes(mask: np.ndarray) -> List[Tuple[int, int, int, int, int]]:
    """``(x, y, w, h, area)`` of each 8-connected component of ``mask != 0``,
    in ``cv2.connectedComponentsWithStats``' label order.

    OpenCV labels 2x2 pixel blocks in raster order of the blocks, so its
    labels follow each component's first block in that order (a block lies
    in one component at most: its pixels are 8-connected); ``scipy`` numbers
    components by their first pixel in raster order, and the two differ
    where a component starts on the odd row of a block row."""
    from scipy import ndimage

    labels, n = ndimage.label(np.asarray(mask) != 0, structure=np.ones((3, 3), bool))
    if n == 0:
        return []
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    h, w = labels.shape
    block = (ys // 2) * ((w + 1) // 2) + xs // 2
    first_block = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first_block, lab, block)
    area = np.bincount(lab, minlength=n + 1)
    boxes = []
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        y, x = sl[0].start, sl[1].start
        boxes.append((first_block[i], (x, y, sl[1].stop - x, sl[0].stop - y, int(area[i]))))
    return [b for _, b in sorted(boxes)]


def laplacian_f32(gray_u8: np.ndarray) -> np.ndarray:
    """float32 [H, W] Laplacian of a uint8 [H, W] image, as OpenCV gives it."""
    img = np.asarray(gray_u8).astype(np.float32)
    # numpy's "reflect" leaves the edge out, as BORDER_REFLECT_101 does; an
    # axis of length 1 reflects onto itself in both
    p = img
    for axis in (0, 1):
        width = [(0, 0), (0, 0)]
        width[axis] = (1, 1)
        p = np.pad(p, width, mode="reflect" if img.shape[axis] > 1 else "edge")
    return np.ascontiguousarray(p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * img, np.float32)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: float64 [2, 3]."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
            + np.asarray(c, np.float32)).astype(np.float32)


def _remap_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, replicate: bool) -> np.ndarray:
    """Bilinear sampling of ``img`` at float32 source coordinates ``sx``,
    ``sy`` [h, w], in float32 before any rounding: taps outside the image
    read 0, or the nearest edge pixel when ``replicate``."""
    h, w = img.shape[:2]
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    ax = (sx - ix.astype(np.float32))[..., None]
    ay = (sy - iy.astype(np.float32))[..., None]
    src = img.reshape(h, w, -1).astype(np.float32)

    def tap(yy, xx):
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        if replicate:
            return v
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(inside[..., None], v, np.float32(0.0))

    p00, p01, p10, p11 = tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma32(ax, p01 - p00, p00)
    bottom = _fma32(ax, p11 - p10, p10)
    return _fma32(ay, bottom - top, top).reshape(sx.shape + img.shape[2:])


def _remap_linear_u8(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, replicate: bool) -> np.ndarray:
    """:func:`_remap_linear` of a uint8 image, rounded half to even."""
    return np.clip(np.rint(_remap_linear(img, sx, sy, replicate)), 0, 255).astype(np.uint8)


def _map_row(m0: np.float32, m1: np.float32, m2: np.float32, width: int, height: int) -> np.ndarray:
    """float32 ``m0 * x + (m1 * y + m2)`` over the output grid, the x term
    fused."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    return _fma32(np.full_like(xx, m0), xx, m1 * yy + m2)


#: pixels per step of OpenCV's vectorised warpAffine loop
_WARP_LANES = 16


def _affine_maps(M: np.ndarray, width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    """The float32 source coordinates of ``cv2.warpAffine``'s output grid:
    ``M`` inverted in double, then each row in float32."""
    m = np.asarray(M, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    m = m.astype(np.float32)
    maps = []
    for a, b, c in (m[0:3], m[3:6]):
        out = _map_row(a, b, c, width, height)
        # the columns past OpenCV's 16-pixel vector loop: fma(x, a, y * b) + c
        tail = width - width % _WARP_LANES
        if tail < width:
            yy, xx = np.mgrid[0:height, tail:width].astype(np.float32)
            out[:, tail:] = _fma32(xx, a, yy * b) + c
        maps.append(out)
    return maps[0], maps[1]


def warp_affine_u8(img: np.ndarray, M: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpAffine(img, M, (width, height), flags=cv2.INTER_LINEAR)``
    for a uint8 image, with a constant 0 border."""
    return _remap_linear_u8(img, *_affine_maps(M, width, height), replicate=False)


def warp_affine_f32(img: np.ndarray, M: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpAffine(img, M, (width, height),
    borderMode=cv2.BORDER_REPLICATE)`` (INTER_LINEAR) for a float32 image."""
    return _remap_linear(np.asarray(img, np.float32), *_affine_maps(M, width, height), replicate=True)


def _reflect101(img: np.ndarray, r: int) -> np.ndarray:
    """``img`` padded by ``r`` on both spatial axes with
    ``BORDER_REFLECT_101`` (numpy's ``reflect``)."""
    return np.pad(img, ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2), mode="reflect")


def blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))`` for a uint8 image and odd ``k``, bit for
    bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or k % 2 != 1:
        raise ValueError(f"blur_u8 takes uint8 and an odd window, got {img.dtype} and {k}")
    h, w = img.shape[:2]
    p = _reflect101(img.astype(np.int32), k // 2)
    # window sums from running sums along each axis (exact in int32)
    c = np.cumsum(p, axis=1, dtype=np.int32)
    rows = c[:, k - 1:].copy()
    rows[:, 1:] -= c[:, :w - 1]
    c = np.cumsum(rows, axis=0, dtype=np.int32)
    acc = c[k - 1:].copy()
    acc[1:] -= c[:h - 1]
    return ((2 * acc + k * k) // (2 * k * k)).astype(np.uint8)


#: ``getGaussianKernel``'s fixed kernels for ``k`` <= 9 and ``sigma`` <= 0
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
                   9: [0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875, 0.1171875,
                       0.05078125, 0.015625]}


def gaussian_kernel_f32(k: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.getGaussianKernel(k, sigma, cv2.CV_32F)``: float32 [k]; a
    ``sigma`` <= 0 takes OpenCV's fixed kernel up to ``k = 9``, and beyond is
    ``0.3 * ((k - 1) / 2 - 1) + 0.8``."""
    if sigma <= 0 and k in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[k], np.float32)
    sigma = sigma if sigma > 0 else ((k - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


#: float32 lanes of OpenCV's AVX2 filter loops: of a row of ``n`` values
#: (pixels times channels) the last ``n % 8`` are computed by its scalar C++,
#: without fused multiply-adds
_FILTER_LANES = 8


def _mac(a, b, acc, fused: bool) -> np.ndarray:
    """float32 ``a * b + acc``: fused (one rounding), or the product rounded
    and then the sum."""
    if fused:
        return _fma32(a, b, acc)
    return (np.asarray(a, np.float32) * np.float32(b)).astype(np.float32) + acc


def _lanes_then_tail(n: int, compute, unrolled: int = 0) -> np.ndarray:
    """``compute(lo, hi, fused)`` gives the flat columns ``lo:hi`` of a
    filter's output rows: fused in OpenCV's vector loop and in the
    ``unrolled``-wide steps of its scalar tail, plain in the rest."""
    cut = n - n % _FILTER_LANES
    if unrolled:
        cut += (n - cut) // unrolled * unrolled
    parts = ([compute(0, cut, True)] if cut else []) + ([compute(cut, n, False)] if cut < n else [])
    return np.concatenate(parts, axis=1)


def _sep_rows(p: np.ndarray, g: np.ndarray, n: int, cn: int) -> np.ndarray:
    """OpenCV's float32 row filter of the symmetric kernel ``g`` over the
    flat padded rows ``p`` [rows, n + (k - 1) * cn] -> [rows, n]."""
    k, r = len(g), len(g) // 2

    def compute(lo, hi, fused):
        tap = lambda j: p[:, (r + j) * cn + lo:(r + j) * cn + hi]  # noqa: E731
        if k == 3:
            return _mac(tap(0), g[1], (tap(-1) + tap(1)) * g[0], fused)
        if k == 5:
            return _mac(tap(-2) + tap(2), g[0], _mac(tap(0), g[2], (tap(-1) + tap(1)) * g[1], fused), fused)
        acc = tap(-r) * g[0]
        for j in range(1, k):
            acc = _mac(tap(j - r), g[j], acc, fused)
        return acc

    # the scalar tail: steps of two values (k <= 5) or four, fused as the
    # vector loop; a last odd value is not matched for k >= 7
    return _lanes_then_tail(n, compute, 2 if k <= 5 else 4)


def gaussian_blur_f32(img: np.ndarray, k: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigma)`` for a float32 ``[H, W]`` or
    ``[H, W, C]`` image and odd ``k``; bit for bit where a row holds a
    multiple of 4 values (the module docstring says where not)."""
    img = np.asarray(img, np.float32)
    if k % 2 != 1:
        raise ValueError(f"gaussian_blur_f32 takes an odd kernel size, got {k}")
    if k == 1:
        return img.copy()
    g, r = gaussian_kernel_f32(k, sigma), k // 2
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    n = w * cn
    rows = _sep_rows(_reflect101(img, r).reshape(h + 2 * r, -1), g, n, cn)

    def compute(lo, hi, fused):
        acc = rows[r:r + h, lo:hi] * g[r]
        for j in range(1, r + 1):
            acc = _mac(rows[r - j:r - j + h, lo:hi] + rows[r + j:r + j + h, lo:hi], g[r + j], acc, fused)
        return acc

    return _lanes_then_tail(n, compute).reshape(img.shape)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` for a float32 or float64 ``[H, W]``
    or ``[H, W, C]`` image and a kernel of fewer than 130 taps (the anchor at
    its centre), in the image's dtype."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"filter2d takes float32 or float64, got {img.dtype}")
    kern = np.asarray(kernel, img.dtype)
    kh, kw = kern.shape
    if kh * kw >= 130:
        raise ValueError(f"filter2d: OpenCV filters a {kh}x{kw} kernel through the DFT, not ported")
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    ay, ax = kh // 2, kw // 2
    pads = ((ay, kh - 1 - ay), (ax, kw - 1 - ax)) + ((0, 0),) * (img.ndim - 2)
    p = np.pad(img, pads, mode="reflect").reshape(h + kh - 1, -1)
    taps = list(zip(*np.nonzero(kern)))

    def compute(lo, hi, fused):
        acc = np.zeros((h, hi - lo), img.dtype)
        for i, j in taps:
            src = p[i:i + h, j * cn + lo:j * cn + hi]
            acc = _mac(src, kern[i, j], acc, fused) if img.dtype == np.float32 else acc + src * kern[i, j]
        return acc

    if img.dtype == np.float64:  # OpenCV's double filter has no vector loop
        return compute(0, w * cn, False).reshape(img.shape)
    return _lanes_then_tail(w * cn, compute).reshape(img.shape)


def resize_linear_f32(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) for a float32
    ``[H, W]`` or ``[H, W, C]`` image."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]

    def coords(n, src):
        s = src / n
        return _fma32(np.float32(s), np.arange(n, dtype=np.float32), np.float32(0.5 * s - 0.5))

    sx = np.broadcast_to(coords(width, w)[None], (height, width))
    sy = np.broadcast_to(coords(height, h)[:, None], (height, width))
    return _remap_linear(img, np.ascontiguousarray(sx), np.ascontiguousarray(sy), replicate=True)


def warp_affine_zero_f32(img: np.ndarray, M: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpAffine(img, M, (width, height))`` (INTER_LINEAR, a constant
    0 border) for a float32 image."""
    return _remap_linear(np.asarray(img, np.float32), *_affine_maps(M, width, height), replicate=False)


def _morph2(img: np.ndarray, op, fill: float) -> np.ndarray:
    x = np.asarray(img, np.float32)
    p = np.pad(x, ((1, 0), (1, 0)) + ((0, 0),) * (x.ndim - 2), constant_values=fill)
    h, w = x.shape[:2]
    return op(op(p[:h, :w], p[:h, 1:]), op(p[1:, :w], p[1:, 1:]))


def dilate2_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, np.ones((2, 2), np.uint8))`` for float32."""
    return _morph2(img, np.maximum, -np.inf)


def erode2_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.erode(img, np.ones((2, 2), np.uint8))`` for float32."""
    return _morph2(img, np.minimum, np.inf)


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)`` of four point pairs: float64
    [3, 3] with ``M[2, 2] = 1``."""
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = float(src[i][0]), float(src[i][1])
        u, v = float(dst[i][0]), float(dst[i][1])
        A[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def warp_perspective_u8(img: np.ndarray, M: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.warpPerspective(img, M, (width, height),
    borderMode=cv2.BORDER_REPLICATE)`` (INTER_LINEAR) for a uint8 image."""
    m = np.linalg.inv(np.asarray(M, np.float64)).astype(np.float32).ravel()
    X, Y, W = (_map_row(m[i], m[i + 1], m[i + 2], width, height) for i in (0, 3, 6))
    return _remap_linear_u8(img, X / W, Y / W, replicate=True)
