"""OpenCV 5's text for the ``FONT_HERSHEY_*`` constants, without OpenCV:
:func:`get_text_size` is ``cv2.getTextSize`` and :func:`put_text` is
``cv2.putText`` as OpenCV 5.0.0 computes them, for the 37 characters the
OCR and CLIP data generators draw (:data:`ALPHABET`).

OpenCV 5 no longer strokes Hershey glyphs: each constant names one of its
built-in TrueType faces at a weight (one for thickness 1, one for 2 and
up; ``FONT_ITALIC`` changes nothing), and ``fontScale`` becomes an integer
pixel size, ``round(fontScale * 1000 / d)`` with ``d`` per face
(:data:`_SIZE_DIVISOR`; OpenCV's own double arithmetic puts a boundary up
to 2 ulp from the exact half).  The glyphs of a size are anti-aliased alpha
masks drawn at integer pen positions that advance by a whole number of
pixels, so

* a string's width is the sum of its characters' advances plus one, its
  height the size, its baseline the deepest descent of its characters;
* the text is each glyph's mask blended over the image in turn,
  ``(dst * (255 - a) + color * a + 127) // 255`` per channel, clipped at the
  image's edges (no wrapping).

Both read the committed atlas ``fvd_tpu_torch/assets/opencv5_text.npz``,
which ``python -m fvd_tpu_torch.tools.make_text_atlas`` measures off
OpenCV 5.0.0: advances and extents at pixel sizes ``1..METRIC_SIZES - 1``,
glyph masks at sizes ``GLYPH_SIZES`` (fontScale 0.15-1.8 for the SIMPLEX
family, 0.26-3.2 for PLAIN), one group per distinct (face, weight).  On the tested
draws both are equal to OpenCV's, bit for bit.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence, Tuple

import numpy as np

FONT_HERSHEY_SIMPLEX = 0
FONT_HERSHEY_PLAIN = 1
FONT_HERSHEY_DUPLEX = 2
FONT_HERSHEY_COMPLEX = 3
FONT_HERSHEY_TRIPLEX = 4
FONT_HERSHEY_COMPLEX_SMALL = 5
FONT_HERSHEY_SCRIPT_SIMPLEX = 6
FONT_HERSHEY_SCRIPT_COMPLEX = 7
FONT_ITALIC = 16

#: the characters of the atlas: the OCR alphabet
ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "
#: thickness 1, 2 and 3 are measured; 3 and up draw as 2 on OpenCV 5.0.0
THICKNESS_CLASSES = 3
#: pixel sizes with metrics: 0 .. METRIC_SIZES - 1
METRIC_SIZES = 65
#: pixel sizes with glyph masks, inclusive
GLYPH_SIZES = (4, 48)
#: fontScale -> pixel size: round(fontScale * 1000 / divisor), per face
_SIZE_DIVISOR = (37, 66, 37, 37, 37, 46, 40, 40)

ATLAS_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "assets", "opencv5_text.npz")


@functools.lru_cache(maxsize=1)
def _atlas() -> dict:
    with np.load(ATLAS_PATH) as z:
        atlas = {k: z[k] for k in z.files}
    if bytes(atlas["alphabet"]).decode("ascii") != ALPHABET:
        raise ValueError(f"{ATLAS_PATH}: alphabet differs from utils.text.ALPHABET")
    return atlas


_CHAR_INDEX = {c: i for i, c in enumerate(ALPHABET)}


def _pixel_size(font_face: int, font_scale: float) -> int:
    return int(np.rint(float(font_scale) * 1000.0 / _SIZE_DIVISOR[font_face & 15]))


def _resolve(text: str, font_face: int, font_scale: float, thickness: int):
    """-> (group, pixel size, character indices)."""
    face = int(font_face) & ~FONT_ITALIC
    if not 0 <= face < 8:
        raise ValueError(f"font face {font_face}: only the eight FONT_HERSHEY_* faces are measured")
    if thickness < 1:
        raise ValueError(f"thickness {thickness}: filled text is not measured")
    if not text:
        raise ValueError("empty text")
    try:
        idx = np.array([_CHAR_INDEX[c] for c in text], np.int64)
    except KeyError as e:
        raise ValueError(f"character {e.args[0]!r} is not in the atlas' alphabet {ALPHABET!r}") from None
    size = _pixel_size(face, font_scale)
    if not 1 <= size < METRIC_SIZES:
        raise ValueError(f"fontScale {font_scale} gives pixel size {size}, outside 1..{METRIC_SIZES - 1}")
    group = int(_atlas()["groups"][face, min(int(thickness), THICKNESS_CLASSES) - 1])
    return group, size, idx


def get_text_size(text: str, font_face: int, font_scale: float,
                  thickness: int) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(text, font_face, font_scale, thickness)`` of OpenCV
    5.0.0: ``((width, height), baseline)``."""
    group, size, idx = _resolve(text, font_face, font_scale, thickness)
    adv, top, bottom = _atlas()["metrics"][group, size][:, idx].astype(np.int64)
    return (int(adv.sum()) + 1, int(top.max())), int(bottom.max())


def _scalar(color, channels: int) -> np.ndarray:
    """OpenCV's ``Scalar`` of ``color`` for ``channels`` channels: a number
    fills the first channel only, missing channels are 0."""
    c = [color] if np.isscalar(color) else list(color)
    c = (c + [0] * 4)[:4]
    return np.array([int(round(float(v))) for v in c[:channels]], np.int64)


def put_text(img: np.ndarray, text: str, org: Sequence[int], font_face: int,
             font_scale: float, color, thickness: int = 1) -> np.ndarray:
    """``cv2.putText(img, text, org, font_face, font_scale, color,
    thickness)`` of OpenCV 5.0.0 on a uint8 ``[H, W]`` or ``[H, W, C]``
    image, in place; ``org`` is the left end of the baseline.  Returns
    ``img``."""
    if img.dtype != np.uint8:
        raise TypeError(f"put_text draws on uint8, got {img.dtype}")
    group, size, idx = _resolve(text, font_face, font_scale, thickness)
    lo, hi = GLYPH_SIZES
    if not lo <= size <= hi:
        raise ValueError(f"fontScale {font_scale} gives pixel size {size}; glyphs are measured at {lo}..{hi}")
    atlas = _atlas()
    view = img if img.ndim == 3 else img[..., None]
    H, W, C = view.shape
    col = _scalar(color, C)
    adv = atlas["metrics"][group, size, 0]
    table = atlas["glyph_index"][group, size - lo]
    pixels = atlas["glyph_pixels"]
    x, y = int(org[0]), int(org[1])
    for j in idx:
        off, gh, gw, dx, dy = (int(v) for v in table[j])
        x0, y0 = x + dx, y + dy
        # the part of the mask inside the image
        ax0, ay0 = max(0, -x0), max(0, -y0)
        ax1, ay1 = min(gw, W - x0), min(gh, H - y0)
        if gh and ax1 > ax0 and ay1 > ay0:
            a = pixels[off:off + gh * gw].reshape(gh, gw)[ay0:ay1, ax0:ax1].astype(np.int64)[..., None]
            region = view[y0 + ay0:y0 + ay1, x0 + ax0:x0 + ax1]
            region[...] = (region.astype(np.int64) * (255 - a) + col * a + 127) // 255
        x += int(adv[j])
    return img
