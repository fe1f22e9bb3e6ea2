"""Measure OpenCV 5's text rendering for the ``FONT_HERSHEY_*`` constants
into the glyph atlas that :mod:`fvd_tpu_torch.utils.text` draws from:

    python -m fvd_tpu_torch.tools.make_text_atlas [--out PATH]

OpenCV 5 draws the Hershey constants with its built-in TrueType faces: each
constant picks a face and a weight (one for thickness 1, one for thickness 2
and up), and ``fontScale`` picks an integer pixel size.  Glyphs sit at
integer pen positions that advance by a whole number of pixels, so one alpha
mask per (face, weight, size, character) and an advance per character are
the whole contract.  This tool reads them off ``cv2`` (OpenCV 5.0.0): for
every constant and thickness class the advance, the top and the bottom of
each character of :data:`~fvd_tpu_torch.utils.text.ALPHABET` at pixel sizes
``1..METRIC_SIZES - 1``, and the tight alpha mask of each glyph at sizes
``GLYPH_SIZES``.  Constants that draw the same (metrics and masks at every
size) share one group; ``FONT_ITALIC`` is checked to change nothing.

The output is a zip of ``.npy`` members with fixed timestamps, so two runs
give the same bytes.  It needs ``cv2`` 5 and runs on a workstation, never
on the card's machine; the port reads the committed file.
"""

from __future__ import annotations

import argparse
import io
import os
import zipfile

import numpy as np

from fvd_tpu_torch.utils import text as T

_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


def _scale_for(face: int, size: int) -> float:
    """A ``fontScale`` that OpenCV turns into pixel size ``size``: the middle
    of the size's interval."""
    return size * T._SIZE_DIVISOR[face & 15] / 1000.0


def _metrics(cv2, face: int, thickness: int, size: int) -> np.ndarray:
    """[3, len(ALPHABET)] advance, top, bottom of each character."""
    out = np.zeros((3, len(T.ALPHABET)), np.int16)
    s = _scale_for(face, size)
    for j, ch in enumerate(T.ALPHABET):
        (w, h), base = cv2.getTextSize(ch, face, s, thickness)
        out[:, j] = (w - 1, h, base)
    return out


def _glyph(cv2, face: int, thickness: int, size: int, ch: str):
    """(alpha mask uint8 [h, w], dx, dy) of one character, offsets from the
    pen position on the baseline to the mask's top-left pixel."""
    pad = 2 * size + 8
    canvas = np.zeros((4 * size + 16, 4 * size + 16), np.uint8)
    cv2.putText(canvas, ch, (pad, pad + size), face, _scale_for(face, size), 255, thickness)
    rows, cols = canvas.any(axis=1), canvas.any(axis=0)
    if not rows.any():
        return np.zeros((0, 0), np.uint8), 0, 0
    y0, y1 = int(rows.argmax()), len(rows) - int(rows[::-1].argmax())
    x0, x1 = int(cols.argmax()), len(cols) - int(cols[::-1].argmax())
    return canvas[y0:y1, x0:x1].copy(), int(x0 - pad), int(y0 - pad - size)


def _check_size_rule(cv2) -> None:
    """The scale -> pixel size rule of ``text._pixel_size`` on both sides of
    a few boundaries per face."""
    for face in range(8):
        d = T._SIZE_DIVISOR[face]
        for size in (2, 9, 17, 30, 47):
            for s, want in (((size - 0.5) * d / 1000 * (1 - 1e-9), size - 1),
                            ((size - 0.5) * d / 1000 * (1 + 1e-9), size)):
                got = cv2.getTextSize("H", face, s, 1)[0][1]
                if got != want or T._pixel_size(face, s) != want:
                    raise AssertionError(f"face {face} scale {s}: cv2 {got}, rule {T._pixel_size(face, s)}")


def measure(cv2):
    """-> dict of the atlas' arrays."""
    _check_size_rule(cv2)
    n_chars = len(T.ALPHABET)
    sizes_g = list(range(T.GLYPH_SIZES[0], T.GLYPH_SIZES[1] + 1))
    signatures, groups = [], np.zeros((8, T.THICKNESS_CLASSES), np.int16)
    metrics, glyph_sets = [], []
    for face in range(8):
        for t in range(1, T.THICKNESS_CLASSES + 1):
            met = np.stack([_metrics(cv2, face, t, s) for s in range(T.METRIC_SIZES)])
            glyphs = [[_glyph(cv2, face, t, s, ch) for ch in T.ALPHABET] for s in sizes_g]
            sig = met.tobytes() + b"".join(m.tobytes() + bytes([m.shape[1] % 256]) + np.int16([dx, dy]).tobytes()
                                           for row in glyphs for m, dx, dy in row)
            if sig not in signatures:
                signatures.append(sig)
                metrics.append(met)
                glyph_sets.append(glyphs)
            groups[face, t - 1] = signatures.index(sig)
            # italic changes nothing, and strokes past the last class draw as that class
            for other_face, other_t in ((face | T.FONT_ITALIC, t), (face, t + 2 * T.THICKNESS_CLASSES)):
                if other_t > T.THICKNESS_CLASSES and t != T.THICKNESS_CLASSES:
                    continue
                for s in (sizes_g[0], 20, sizes_g[-1]):
                    a = cv2.getTextSize(T.ALPHABET, other_face, _scale_for(face, s), other_t)
                    b = cv2.getTextSize(T.ALPHABET, face, _scale_for(face, s), t)
                    same = a == b and all(
                        np.array_equal(x[0], y[0]) and x[1:] == y[1:]
                        for x, y in ((_glyph(cv2, other_face, other_t, s, ch), _glyph(cv2, face, t, s, ch))
                                     for ch in "AG8W"))
                    if not same:
                        raise AssertionError(f"face {other_face} thickness {other_t} size {s} "
                                             f"draws unlike face {face} thickness {t}")
    index = np.zeros((len(metrics), len(sizes_g), n_chars, 5), np.int32)
    chunks, offset = [], 0
    for g, glyphs in enumerate(glyph_sets):
        for si, row in enumerate(glyphs):
            for j, (m, dx, dy) in enumerate(row):
                index[g, si, j] = (offset, m.shape[0], m.shape[1], dx, dy)
                chunks.append(m.ravel())
                offset += m.size
    return {
        "alphabet": np.frombuffer(T.ALPHABET.encode("ascii"), np.uint8).copy(),
        "groups": groups,
        "metrics": np.stack(metrics),  # [G, METRIC_SIZES, 3, n_chars]
        "glyph_sizes": np.asarray(T.GLYPH_SIZES, np.int16),
        "glyph_index": index,
        "glyph_pixels": np.concatenate(chunks),
        "opencv_version": np.frombuffer(cv2.__version__.encode("ascii"), np.uint8).copy(),
    }


def write_atlas(arrays: dict, path: str) -> None:
    """A deflated zip of ``.npy`` members with fixed timestamps, which
    ``np.load`` reads like any ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=9) as z:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(arrays[name]), allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=_ZIP_TIME)
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            z.writestr(info, buf.getvalue(), compresslevel=9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=T.ATLAS_PATH)
    args = ap.parse_args(argv)
    import cv2

    if not cv2.__version__.startswith("5."):
        raise SystemExit(f"the atlas is OpenCV 5's text; this cv2 is {cv2.__version__}")
    arrays = measure(cv2)
    write_atlas(arrays, args.out)
    print(f"wrote {args.out}: {len(arrays['metrics'])} groups, "
          f"{arrays['glyph_pixels'].size} glyph pixels, {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
