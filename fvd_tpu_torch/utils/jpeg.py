"""Baseline JPEG encode and grayscale and colour decode with numpy, byte for
byte what OpenCV's libjpeg-turbo gives.

* :func:`encode_jpeg` is ``cv2.imencode(".jpg", cv2.cvtColor(rgb,
  cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, quality])`` with OpenCV's
  defaults otherwise: baseline JFIF 1.01 at ``quality`` (95 by default; the
  Annex K tables scaled by ``jpeg_quality_scaling``), Y at 2x2 over Cb
  and Cr at 1x1 (4:2:0), the Annex K Huffman tables, no restart markers.  The
  stages follow libjpeg's C, which its SIMD paths equal bit for bit:
  ``jccolor.c``'s 16-bit fixed-point RGB -> YCbCr, ``jcsample.c``'s h2v2
  downsample with its alternating bias and right-edge replication,
  ``jcprepct.c``'s bottom-edge replication, ``jccoefct.c``'s dummy blocks at
  the right and bottom of a partial MCU, ``jfdctint.c``'s islow FDCT,
  ``jcdctmgr.c``'s quantiser and ``jchuff.c``'s entropy coder (0xFF00
  stuffing, 1-bit padding).
* :func:`decode_jpeg_gray` is ``cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)`` on a
  baseline (or extended Huffman sequential, 8-bit) file: Huffman decode of
  every component, then dequantisation and ``jidctint.c``'s islow IDCT with
  libjpeg's range limit on the first component only, which is libjpeg's
  grayscale output of a YCbCr or grayscale file.
* :func:`decode_jpeg_color` is ``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` with
  the channels reversed to RGB: the islow IDCT on every component,
  ``jdsample.c``'s h2v2 fancy upsampling of 4:2:0 chroma and ``jdcolor.c``'s
  fixed-point YCbCr -> RGB.  The photometric realism lever round-trips its
  images through it.

The vision LLM of V5 and C2 reads these bytes, as it reads OpenCV's in the
JAX package.
"""

from __future__ import annotations

import struct
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

QUALITY = 95

#: jpeg_natural_order: zigzag index -> row-major index in the 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda k: (k // 8 + k % 8, k // 8 if (k // 8 + k % 8) % 2 else -(k // 8))),
                  np.int64)

# Annex K.1 quantisation tables, row-major
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_Q = np.full(64, 99, np.int64)
_STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), tuple(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), tuple(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")))


def _scaled_qtable(basic: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((basic * scale + 50) // 100, 1, 255)


def _huff_codes(table) -> Dict[int, Tuple[int, int]]:
    """Canonical codes (Annex C): symbol -> (code, length)."""
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _code_arrays(table) -> Tuple[np.ndarray, np.ndarray]:
    codes = _huff_codes(table)
    value, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for sym, (c, n) in codes.items():
        value[sym], length[sym] = c, n
    return value, length


# --------------------------------------------------------------------- encode
def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _rgb_to_ycc(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c rgb_ycc_convert: SCALEBITS 16, Cb and Cr round with ONE_HALF - 1."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, cbcr = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + cbcr + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + cbcr + half - 1) >> 16
    return y, cb, cr


def _downsample_h2v2(plane: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """jcsample.c h2v2_downsample after expand_right_edge to ``2 * out_cols``
    and jcprepct.c's bottom padding to an even row count, then the
    downsampled rows replicated down to ``out_rows`` (the iMCU height)."""
    h, w = plane.shape
    p = np.pad(plane, ((0, h % 2), (0, 2 * out_cols - w)), mode="edge")
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    d = (s + bias) >> 2
    return np.pad(d, ((0, out_rows - d.shape[0]), (0, 0)), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[8*by, 8*bx] -> [by, bx, 8, 8]"""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c jpeg_fdct_islow on level-shifted samples [..., 8, 8]
    (int64); the output is scaled up by 8, as libjpeg's is."""
    c_bits, p1 = 13, 2

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, shift_even, descale_even, n_odd):
        d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
        tmp0, tmp7 = d0 + d7, d0 - d7
        tmp1, tmp6 = d1 + d6, d1 - d6
        tmp2, tmp5 = d2 + d5, d2 - d5
        tmp3, tmp4 = d3 + d4, d3 - d4
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        if shift_even:
            out[0], out[4] = (tmp10 + tmp11) << p1, (tmp10 - tmp11) << p1
        else:
            out[0], out[4] = descale(tmp10 + tmp11, descale_even), descale(tmp10 - tmp11, descale_even)
        z1 = (tmp12 + tmp13) * 4433
        out[2] = descale(z1 + tmp13 * 6270, n_odd)
        out[6] = descale(z1 + tmp12 * -15137, n_odd)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * 9633
        tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        out[7] = descale(tmp4 + z1 + z3, n_odd)
        out[5] = descale(tmp5 + z2 + z4, n_odd)
        out[3] = descale(tmp6 + z2 + z3, n_odd)
        out[1] = descale(tmp7 + z1 + z4, n_odd)
        return np.stack(out, axis=-1)

    rows = one_pass(blocks, True, 0, c_bits - p1)
    cols = one_pass(np.swapaxes(rows, -1, -2), False, p1, c_bits + p1)
    return np.swapaxes(cols, -1, -2)


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: divide by ``qtable * 8``, rounding half away from zero."""
    d = qtable.reshape(8, 8) * 8
    mag = (np.abs(coef) + (d >> 1)) // d
    return np.where(coef < 0, -mag, mag)


def _component_coefs(plane: np.ndarray, qtable: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Quantised coefficients [bh, bw, 64] in zigzag order of the padded
    plane's first ``bh`` x ``bw`` blocks."""
    blocks = _blocks(plane[: bh * 8, : bw * 8]) - 128
    return _quantize(_fdct_islow(blocks), qtable).reshape(bh, bw, 64)[..., ZIGZAG]


def _nbits(v: np.ndarray) -> np.ndarray:
    """Category (bit count) of |v|, 0 for 0."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The low ``n`` bits jchuff.c emits after a symbol: v, or v - 1 when
    v < 0 (ones' complement)."""
    return np.where(v < 0, v - 1, v) & ((1 << n) - 1)


@lru_cache(maxsize=None)
def _tables():
    return {"dc": (_code_arrays(_DC_LUMA), _code_arrays(_DC_CHROMA)),
            "ac": (_code_arrays(_AC_LUMA), _code_arrays(_AC_CHROMA))}


def _entropy_code(coefs: np.ndarray, comp: np.ndarray) -> bytes:
    """jchuff.c encode_one_block over the blocks in scan order: coefficients
    [N, 64] (zigzag) and each block's component (0 Y, 1 Cb, 2 Cr)."""
    tabs = _tables()
    tsel = (comp > 0).astype(np.int64)
    n = len(coefs)
    # DC: difference from the previous block of the same component
    dc = coefs[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    dn = _nbits(diff)
    dc_val = np.choose(tsel, [tabs["dc"][0][0][dn], tabs["dc"][1][0][dn]])
    dc_len = np.choose(tsel, [tabs["dc"][0][1][dn], tabs["dc"][1][1][dn]])
    ev_key = [np.arange(n) * 65]
    ev_val = [(dc_val << dn) | _extra(diff, dn)]
    ev_len = [dc_len + dn]
    # AC: each nonzero coefficient with the zero run before it (ZRLs for 16 zeros)
    blk, pos = np.nonzero(coefs[:, 1:])
    pos = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(pos, 1))
    run = pos - prev - 1
    v = coefs[blk, pos]
    an = _nbits(v)
    sym = ((run & 15) << 4) | an
    ts = tsel[blk]
    ac_val = np.choose(ts, [tabs["ac"][0][0][sym], tabs["ac"][1][0][sym]])
    ac_len = np.choose(ts, [tabs["ac"][0][1][sym], tabs["ac"][1][1][sym]])
    zrl_val = np.choose(ts, [tabs["ac"][0][0][0xF0], tabs["ac"][1][0][0xF0]])
    zrl_len = np.choose(ts, [tabs["ac"][0][1][0xF0], tabs["ac"][1][1][0xF0]])
    val, length = np.zeros(len(blk), np.int64), np.zeros(len(blk), np.int64)
    for k in range(3):  # at most 3 ZRLs: a run is at most 62
        z = (run >> 4) > k
        val = np.where(z, (val << zrl_len) | zrl_val, val)
        length = np.where(z, length + zrl_len, length)
    ev_key.append(blk * 65 + pos)
    ev_val.append((((val << ac_len) | ac_val) << an) | _extra(v, an))
    ev_len.append(length + ac_len + an)
    # EOB where the block's last coefficient is zero
    eob = np.nonzero(coefs[:, 63] == 0)[0]
    ev_key.append(eob * 65 + 64)
    ev_val.append(np.choose(tsel[eob], [tabs["ac"][0][0][0], tabs["ac"][1][0][0]]))
    ev_len.append(np.choose(tsel[eob], [tabs["ac"][0][1][0], tabs["ac"][1][1][0]]))
    order = np.argsort(np.concatenate(ev_key), kind="stable")
    vals, lens = np.concatenate(ev_val)[order], np.concatenate(ev_len)[order]
    # bits, most significant first; pad the last byte with ones (flush_bits)
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    owner = np.repeat(np.arange(len(lens)), lens)
    shift = ends[owner] - 1 - np.arange(total)
    bits = ((vals[owner] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(rgb_u8: np.ndarray, quality: int = QUALITY) -> bytes:
    """uint8 RGB [H, W, 3] -> the bytes of ``cv2.imencode(".jpg", bgr,
    [cv2.IMWRITE_JPEG_QUALITY, quality])`` (OpenCV's defaults otherwise;
    ``quality`` 1..100, default 95)."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"encode_jpeg: expected uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    mcu_y, mcu_x = -(-h // 16), -(-w // 16)
    bh, bw = -(-h // 8), -(-w // 8)  # Y's blocks in the image
    quality = min(max(int(quality), 1), 100)
    q = (_scaled_qtable(_STD_LUMA_Q, quality), _scaled_qtable(_STD_CHROMA_Q, quality))
    y, cb, cr = _rgb_to_ycc(img)

    # Y: edge-replicated to the MCU grid; the blocks past (bh, bw) are
    # jccoefct.c's dummies: AC zero, DC copied from the block before
    yc = np.zeros((2 * mcu_y, 2 * mcu_x, 64), np.int64)
    yc[:bh, :bw] = _component_coefs(np.pad(y, ((0, 16 * mcu_y - h), (0, 16 * mcu_x - w)), mode="edge"),
                                    q[0], bh, bw)
    if bw % 2:
        yc[:bh, bw, 0] = yc[:bh, bw - 1, 0]
    if bh % 2:
        yc[bh, :, 0] = yc[bh - 1, 1::2, 0].repeat(2)
    chroma = [_component_coefs(_downsample_h2v2(p, 8 * mcu_y, 8 * mcu_x), q[1], mcu_y, mcu_x) for p in (cb, cr)]

    # scan order: per MCU, Y's 2x2 blocks row by row, then Cb, then Cr
    ymcu = yc.reshape(mcu_y, 2, mcu_x, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mcu_y, mcu_x, 4, 64)
    scan = np.concatenate([ymcu, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcu_y * mcu_x)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(q):
        out.append(_segment(0xDB, bytes([i]) + bytes(t[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, table in ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)):
        out.append(_segment(0xC4, bytes([cls_id]) + bytes(table[0]) + bytes(table[1])))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(_entropy_code(scan, comp))
    out.append(b"\xff\xd9")
    return b"".join(out)


# --------------------------------------------------------------------- decode
class _Huff:
    """16-bit lookahead tables of one Huffman table: code -> symbol, length
    (length 0 marks a bit pattern that starts no code)."""

    def __init__(self, counts, symbols):
        sym, length = np.zeros(1 << 16, np.int64), np.zeros(1 << 16, np.int64)
        for s, (c, n) in _huff_codes((counts, symbols)).items():
            lo = c << (16 - n)
            sym[lo: lo + (1 << (16 - n))] = s
            length[lo: lo + (1 << (16 - n))] = n
        self.sym, self.len = sym.tolist(), length.tolist()


@lru_cache(maxsize=64)
def _huff(counts: bytes, symbols: bytes) -> _Huff:
    return _Huff(tuple(counts), tuple(symbols))


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """jidctint.c jpeg_idct_islow on dequantised blocks [..., 8, 8] (int64)
    with IDCT_range_limit: -> uint8 samples."""
    c_bits, p1 = 13, 2

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, shift, n):
        z2, z3 = d[..., 2], d[..., 6]
        z1 = (z2 + z3) * 4433
        tmp2 = z1 + z3 * -15137
        tmp3 = z1 + z2 * 6270
        tmp0 = (d[..., 0] + d[..., 4]) << c_bits
        tmp1 = (d[..., 0] - d[..., 4]) << c_bits
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
        z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
        z5 = (z3 + z4) * 9633
        tmp0, tmp1, tmp2, tmp3 = tmp0 * 2446, tmp1 * 16819, tmp2 * 25172, tmp3 * 12299
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
        tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
        out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
               tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
        return np.stack([descale(o, n) for o in out], axis=-1)

    cols = one_pass(np.swapaxes(coef, -1, -2), True, c_bits - p1)  # pass 1 over columns
    rows = one_pass(np.swapaxes(cols, -1, -2), True, c_bits + p1 + 3)
    return _RANGE_LIMIT[rows & 1023]


def _range_limit() -> np.ndarray:
    """jdmaster.c prepare_range_limit_table as IDCT_range_limit sees it:
    index (x & 1023) -> clamp(x + 128) for x in [-512, 511]."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit()


def _scan_segments(data: bytes, start: int) -> Tuple[List[bytes], int]:
    """The entropy-coded bytes from ``start`` up to the next marker that is
    not a restart, unstuffed and split at restart markers."""
    segs, cur = [], bytearray()
    i, n = start, len(data)
    while i < n:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            cur += data[i:]
            i = n
            break
        cur += data[i:j]
        m = data[j + 1]
        if m == 0x00:
            cur.append(0xFF)
            i = j + 2
        elif m == 0xFF:
            i = j + 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            i = j + 2
        else:
            i = j
            break
    segs.append(bytes(cur))
    return segs, i




def _read_bits(w24, p: int, s: int) -> int:
    """``s`` (1..16) bits at bit offset ``p``, sign-extended as JPEG's
    extra bits are (HUFF_EXTEND)."""
    v = ((w24[p >> 3] << (p & 7)) & 0xFFFFFF) >> (24 - s)
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_scan(segments: List[bytes], comps, restart: int, mcus: Tuple[int, int]) -> None:
    """Huffman-decode one scan.  ``comps``: per scan component (dc table, ac
    table, blocks per MCU as (dy, dx) pairs, keep, out) where ``keep`` maps
    (MCU row, MCU col, dy, dx) to a block of ``out`` ([by, bx, 64], zigzag
    order) for a component whose coefficients are kept, else None."""
    mcu_rows, mcu_cols = mcus
    total = mcu_rows * mcu_cols
    per_seg = restart or total
    mcu = 0
    for seg in segments:
        if mcu >= total:
            break
        b = np.frombuffer(seg + b"\x00\x00\x00", np.uint8).astype(np.int64)
        w24 = ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()
        limit = 8 * len(seg) + 16
        p = 0
        pred = [0] * len(comps)
        for _ in range(min(per_seg, total - mcu)):
            my, mx = divmod(mcu, mcu_cols)
            for ci, (dc, ac, offsets, keep, out) in enumerate(comps):
                for dy, dx in offsets:
                    if p > limit:
                        raise ValueError("decode_jpeg: entropy-coded data ends early")
                    look = ((w24[p >> 3] << (p & 7)) >> 8) & 0xFFFF
                    n = dc.len[look]
                    if n == 0:
                        raise ValueError("decode_jpeg: bad Huffman code")
                    s = dc.sym[look]
                    p += n
                    if s:
                        pred[ci] += _read_bits(w24, p, s)
                        p += s
                    blk = [pred[ci]] + [0] * 63 if keep is not None else None
                    k = 1
                    while k < 64:
                        look = ((w24[p >> 3] << (p & 7)) >> 8) & 0xFFFF
                        n = ac.len[look]
                        if n == 0:
                            raise ValueError("decode_jpeg: bad Huffman code")
                        rs = ac.sym[look]
                        p += n
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if blk is not None and k < 64:
                                blk[k] = _read_bits(w24, p, s)
                            p += s
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
                    if blk is not None:
                        by, bx = keep(my, mx, dy, dx)
                        if by < out.shape[0] and bx < out.shape[1]:
                            out[by, bx] = blk
            mcu += 1


def _read_jpeg(data: bytes, keep_all: bool):
    """Parse a sequential Huffman 8-bit JPEG file -> (height, width, [(h, v,
    dequantised blocks [by, bx, 8, 8] or None)] per frame component, hmax,
    vmax), or None for bytes that do not start as a JPEG file.  The blocks
    of every component are kept with ``keep_all``, else the first one's."""
    data = bytes(data)
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        return None
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], _Huff] = {}
    frame = None
    restart = 0
    blocks = {}
    i, n = 2, len(data)
    while i + 2 <= n:
        if data[i] != 0xFF:
            raise ValueError(f"decode_jpeg: marker expected at byte {i}")
        m = data[i + 1]
        if m == 0xFF:  # fill byte
            i += 1
            continue
        if m == 0xD9:
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if i + 4 > n:
            raise ValueError("decode_jpeg: truncated segment")
        (length,) = struct.unpack(">H", data[i + 2: i + 4])
        payload = data[i + 4: i + 2 + length]
        i += 2 + length
        if m == 0xDB:
            o = 0
            while o < len(payload):
                pq, tq = payload[o] >> 4, payload[o] & 15
                size = 128 if pq else 64
                t = np.zeros(64, np.int64)
                t[ZIGZAG] = np.frombuffer(payload[o + 1: o + 1 + size], ">u2" if pq else np.uint8)
                qt[tq] = t
                o += 1 + size
        elif m == 0xC4:
            o = 0
            while o < len(payload):
                counts = payload[o + 1: o + 17]
                nsym = sum(counts)
                huff[(payload[o] >> 4, payload[o] & 15)] = _huff(counts, payload[o + 17: o + 17 + nsym])
                o += 17 + nsym
        elif m in (0xC0, 0xC1):
            prec, fh, fw, nc = struct.unpack(">BHHB", payload[:6])
            comps = [(payload[6 + 3 * k], payload[7 + 3 * k] >> 4, payload[7 + 3 * k] & 15, payload[8 + 3 * k])
                     for k in range(nc)]
            if prec != 8 or nc not in (1, 3) or fh == 0 or fw == 0:
                raise ValueError(f"decode_jpeg: unsupported frame: {prec}-bit, {nc} components")
            if nc == 3 and [c[0] for c in comps] == [82, 71, 66]:
                raise ValueError("decode_jpeg: RGB JPEG not supported")
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if comps[0][1:3] != (hmax, vmax):
                raise ValueError("decode_jpeg: subsampled first component not supported")
            frame = (fh, fw, comps, hmax, vmax)
            for k, (cid, h, v, _) in enumerate(comps):
                if keep_all or k == 0:
                    blocks[cid] = np.zeros((-(-(-(-fh * v // vmax)) // 8), -(-(-(-fw * h // hmax)) // 8), 64),
                                           np.int64)
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"decode_jpeg: unsupported frame type 0x{m:02x}")
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", payload[:2])
        elif m == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12 and payload[11] == 0 \
                and frame is not None and len(frame[2]) == 3:
            raise ValueError("decode_jpeg: Adobe RGB JPEG not supported")
        elif m == 0xDA:
            if frame is None:
                raise ValueError("decode_jpeg: scan before frame header")
            fh, fw, fcomps, hmax, vmax = frame
            by_id = {c[0]: c for c in fcomps}
            ns = payload[0]
            scan = []
            for k in range(ns):
                cid, sel = payload[1 + 2 * k], payload[2 + 2 * k]
                _, h, v, _ = by_id[cid]
                out = blocks.get(cid)
                if ns == 1:  # non-interleaved: one block per MCU
                    offsets, keep = [(0, 0)], (lambda my, mx, dy, dx: (my, mx)) if out is not None else None
                    mcus = (-(-(-(-fh * v // vmax)) // 8), -(-(-(-fw * h // hmax)) // 8))
                else:
                    offsets = [(dy, dx) for dy in range(v) for dx in range(h)]
                    keep = (lambda my, mx, dy, dx, h=h, v=v: (my * v + dy, mx * h + dx)) if out is not None else None
                    mcus = (-(-fh // (8 * vmax)), -(-fw // (8 * hmax)))
                scan.append((huff[(0, sel >> 4)], huff[(1, sel & 15)], offsets, keep, out))
            segments, i = _scan_segments(data, i)
            _decode_scan(segments, scan, restart, mcus)
    if frame is None:
        return None
    fh, fw, fcomps, hmax, vmax = frame
    planes = []
    for cid, h, v, tq in fcomps:
        b = blocks.get(cid)
        if b is not None:
            coef = np.zeros(b.shape, np.int64)
            coef[..., ZIGZAG] = b
            b = (coef * qt[tq]).reshape(*coef.shape[:2], 8, 8)
        planes.append((h, v, b))
    return fh, fw, planes, hmax, vmax


def _samples(blocks: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """The islow IDCT of dequantised blocks [by, bx, 8, 8] -> uint8 samples
    [rows, cols] (the component's own size)."""
    pix = _idct_islow(blocks)
    by, bx = pix.shape[:2]
    return np.ascontiguousarray(pix.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:rows, :cols])


def decode_jpeg_gray(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W], as ``cv2.imdecode(buf, IMREAD_GRAYSCALE)``
    gives on a sequential Huffman 8-bit file (the first component: YCbCr's
    Y, or the one component of a grayscale file).  None for bytes that do
    not start as a JPEG file; a JPEG of a kind this decoder does not read
    (progressive, arithmetic, 12-bit, RGB, CMYK, a subsampled first
    component) or a corrupt one raises ValueError."""
    parsed = _read_jpeg(data, keep_all=False)
    if parsed is None:
        return None
    fh, fw, planes = parsed[:3]
    return _samples(planes[0][2], fh, fw)


def _fancy_h2v2(plane: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """jdsample.c ``h2v2_fancy_upsample`` of a chroma plane [r, c]: each
    output sample 9/16, 3/16, 3/16 and 1/16 of its four nearest input
    samples (the edge rows and columns replicated), rounded with the biases
    8 and 7 of even and odd output columns -> [out_rows, out_cols]."""
    x = plane.astype(np.int64)
    up = np.concatenate([x[:1], x[:-1]])
    down = np.concatenate([x[1:], x[-1:]])
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    for parity, near in ((0, up), (1, down)):
        colsum = 3 * x + near
        left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        out[parity::2, 0::2] = (3 * colsum + left + 8) >> 4
        out[parity::2, 1::2] = (3 * colsum + right + 7) >> 4
    return out[:out_rows, :out_cols]


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ``ycc_rgb_convert``: the fixed-point tables at SCALEBITS 16,
    clamped to 0..255 -> uint8 [H, W, 3] RGB."""
    cb, cr = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg_color(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 RGB [H, W, 3]: ``cv2.imdecode(buf,
    cv2.IMREAD_COLOR)`` (which gives BGR) with its channels reversed, on a
    YCbCr file at 4:4:4 or 4:2:0, or a grayscale one (its samples in all
    three channels).  libjpeg's islow IDCT on every component, ``jdsample.c``'s
    h2v2 fancy (triangle) upsampling of the chroma and ``jdcolor.c``'s
    fixed-point YCbCr -> RGB.  None for bytes that do not start as a JPEG
    file; a JPEG of another kind raises ValueError."""
    parsed = _read_jpeg(data, keep_all=True)
    if parsed is None:
        return None
    fh, fw, planes, hmax, vmax = parsed
    if len(planes) == 1:
        y = _samples(planes[0][2], fh, fw)
        return np.repeat(y[..., None], 3, axis=-1)
    y = _samples(planes[0][2], fh, fw).astype(np.int64)
    chroma = []
    for h, v, b in planes[1:]:
        rows, cols = -(-fh * v // vmax), -(-fw * h // hmax)
        c = _samples(b, rows, cols)
        if (hmax // h, vmax // v) == (2, 2):
            c = _fancy_h2v2(c, fh, fw)
        elif (h, v) != (hmax, vmax):
            raise ValueError(f"decode_jpeg_color: chroma sampling {h}x{v} of {hmax}x{vmax} not supported")
        chroma.append(c)
    return _ycc_to_rgb(y, *chroma)
