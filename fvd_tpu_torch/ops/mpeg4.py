"""MPEG-4 Part 2 reconstruction and colour conversion, batched over a VOP's
blocks: the parallel half of the ``mpeg4`` codec that the JAX package reaches
through libavcodec and libswscale (``native/decode_shim.cc`` or OpenCV), and
the colour conversion of the H.264 pictures that the card's NVDEC decodes.

A frame is one flat uint8 tensor of its three planes, Y then Cb then Cr, at
the macroblock-aligned size (:class:`Geometry`).  Five functions, each with a
plain version and a CUDA kernel:

* :func:`parse_vops` (``csrc/mpeg4_parse.cu`` ``mpeg4_parse``): the entropy
  decoding of a range of VOPs, a thread a VOP, into the packed int16 rows the
  reconstruction splits; its plain version is the host parser
  (``fvd_tpu_torch/utils/mpeg4v.py``), one VOP at a time;
* :func:`reconstruct_vop` (``csrc/mpeg4_decode.cu`` ``mpeg4_recon``): H.263
  inverse quantisation, libavcodec's ``simple_idct`` bit for bit, half-pel
  motion compensation with ``rounding_type`` and edge clamping, add and clip;
* :func:`yuv420_to_rgb` (``mpeg4_decode.cu`` ``yuv420_rgb``): libswscale's
  unscaled yuv420p -> rgb24 conversion (BT.601, limited range, in its x86
  fixed-point form), each chroma sample covering 2x2 pixels; and
  :func:`nv12_to_rgb` (``csrc/nvdec.cu`` ``nv12_rgb``), the same arithmetic
  on an NV12 surface (Cb and Cr interleaved) at its pitch, as the card's
  NVDEC gives H.264 pictures;
* :func:`forward_vop` (``csrc/mpeg4_encode.cu`` ``mpeg4_forward``): RGB to
  YUV 4:2:0, the residual against the reference frame (vector (0, 0)), an
  integer 8x8 FDCT and H.263 quantisation.

A wrapper takes the plain version only for CPU tensors (``parse_vops``: for
a CPU ``device``); on CUDA tensors it launches its kernel (each launch
counted in ``fvd_tpu_torch._kernels``) and raises if the build or the launch
fails.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fvd_tpu_torch import _kernels
from fvd_tpu_torch.utils import mpeg4v
from fvd_tpu_torch.utils.avi import UnsupportedVideo

# simple_idct's constants: W_i = round(cos(i pi / 16) sqrt(2) 2^14), W4 one less
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20

# libswscale's rgb2rgb coefficients (RGB2YUV_SHIFT 15), BT.601 limited range
RGB2YUV_SHIFT = 15
RY, GY, BY = (int(c * 219 / 255 * (1 << RGB2YUV_SHIFT) + 0.5) for c in (0.299, 0.587, 0.114))
RU, GU, BU = (-int(0.169 * 224 / 255 * (1 << RGB2YUV_SHIFT) + 0.5),
              -int(0.331 * 224 / 255 * (1 << RGB2YUV_SHIFT) + 0.5),
              int(0.500 * 224 / 255 * (1 << RGB2YUV_SHIFT) + 0.5))
RV, GV, BV = (int(0.500 * 224 / 255 * (1 << RGB2YUV_SHIFT) + 0.5),
              -int(0.419 * 224 / 255 * (1 << RGB2YUV_SHIFT) + 0.5),
              -int(0.081 * 224 / 255 * (1 << RGB2YUV_SHIFT) + 0.5))

#: the FDCT's basis, round(2^13 alpha(u) cos((2x + 1) u pi / 16))
FDCT_BITS = 13
FDCT_SHIFT1, FDCT_SHIFT2 = 10, 16
FDCT_BASIS = tuple(tuple(int(round((1 << FDCT_BITS) * (math.sqrt(0.125) if u == 0 else 0.5)
                                   * math.cos((2 * x + 1) * u * math.pi / 16)))
                         for x in range(8)) for u in range(8))

DC_SCALE_LUMA = tuple(0 if q == 0 else 8 if q <= 4 else 2 * q if q <= 8 else q + 8 if q <= 24
                      else 2 * q - 16 for q in range(32))
DC_SCALE_CHROMA = tuple(0 if q == 0 else 8 if q <= 4 else (q + 13) // 2 if q <= 24 else q - 6
                        for q in range(32))


def _round16(f: int) -> int:
    """libswscale's ``roundToInt16`` of a 16.16 fixed-point value."""
    return max(-32768, min(32767, (f + (1 << 15)) >> 16))


#: libswscale's yuv2rgb coefficients for BT.601 limited range at the default
#: contrast and saturation, in its SIMD form (``ff_yuv2rgb_c_init_tables``'s
#: ``yCoeff``, ``vrCoeff``, ``ubCoeff``, ``ugCoeff``, ``vgCoeff``, ``yOffset``)
Y_COEFF = _round16(((1 << 16) * 255 // 219) * 8192)
VR_COEFF, UB_COEFF, UG_COEFF, VG_COEFF = (_round16(c * 8192) for c in (104597, 132201, -25675, -53279))
Y_OFFSET = _round16((16 << 16) * 8)


@dataclass(frozen=True)
class Geometry:
    """The planes of one frame at the macroblock-aligned size."""
    width: int
    height: int

    @property
    def mb_w(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_h(self) -> int:
        return (self.height + 15) // 16

    @property
    def n_mb(self) -> int:
        return self.mb_w * self.mb_h

    @property
    def n_blocks(self) -> int:
        return 6 * self.n_mb

    @property
    def luma(self) -> Tuple[int, int]:
        return 16 * self.mb_h, 16 * self.mb_w

    @property
    def frame_bytes(self) -> int:
        h, w = self.luma
        return h * w * 3 // 2


@lru_cache(maxsize=16)
def _block_index(geo: Geometry, device: str):
    """For each block: (plane offset, plane stride, plane height, x0, y0) as
    int64 tensors ``[n_blocks]``, and the flat frame index of each of its
    pixels ``[n_blocks, 8, 8]``."""
    h, w = geo.luma
    hc, wc = h // 2, w // 2
    base, stride, height, x0, y0 = [], [], [], [], []
    for my in range(geo.mb_h):
        for mx in range(geo.mb_w):
            for n in range(4):
                base.append(0); stride.append(w); height.append(h)
                x0.append(16 * mx + 8 * (n & 1)); y0.append(16 * my + 8 * (n >> 1))
            for off in (h * w, h * w + hc * wc):
                base.append(off); stride.append(wc); height.append(hc)
                x0.append(8 * mx); y0.append(8 * my)
    t = [torch.tensor(v, dtype=torch.int64, device=device) for v in (base, stride, height, x0, y0)]
    r = torch.arange(8, device=device)
    pix = t[0][:, None, None] + (t[4][:, None, None] + r[None, :, None]) * t[1][:, None, None] \
        + t[3][:, None, None] + r[None, None, :]
    return (*t, pix)


# --- reconstruction -------------------------------------------------------------

def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def dequantize_plain(levels: torch.Tensor, qscale_blk: torch.Tensor, intra_blk: torch.Tensor,
                     luma_blk: torch.Tensor) -> torch.Tensor:
    """H.263 inverse quantisation of int16 levels ``[N, 64]`` -> int64: an
    intra DC is level x dc_scaler; every other level l is
    ``sign(l) (2 q |l| + ((q - 1) | 1))``; all clipped to [-2048, 2047]."""
    lv = levels.to(torch.int64)
    q = qscale_blk.to(torch.int64)[:, None]
    mag = 2 * q * lv.abs() + ((q - 1) | 1)
    out = torch.where(lv > 0, mag, torch.where(lv < 0, -mag, torch.zeros_like(mag)))
    dc_scale = torch.where(luma_blk, _table(DC_SCALE_LUMA, levels.device)[q[:, 0]],
                           _table(DC_SCALE_CHROMA, levels.device)[q[:, 0]])
    out[:, 0] = torch.where(intra_blk, lv[:, 0] * dc_scale, out[:, 0])
    return out.clamp_(-2048, 2047)


@lru_cache(maxsize=16)
def _table_cached(values: tuple, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def _table(values: tuple, device) -> torch.Tensor:
    return _table_cached(values, str(device))


def idct_plain(coef: torch.Tensor) -> torch.Tensor:
    """libavcodec's ``simple_idct`` (8-bit, int16 blocks) of int64 ``[N, 64]``
    -> int64 ``[N, 8, 8]`` before the final clip: the row pass with its DC-only
    shortcut and int16 stores, then the column pass."""
    b = _wrap(coef, 16).reshape(-1, 8, 8)
    r = [b[:, :, k] for k in range(8)]
    dc_only = (b[:, :, 1:] == 0).all(dim=-1)
    a0 = W4 * r[0] + (1 << (ROW_SHIFT - 1))
    a1, a2, a3 = a0 + W6 * r[2], a0 - W6 * r[2], a0 - W2 * r[2]
    a0 = a0 + W2 * r[2]
    b0 = W1 * r[1] + W3 * r[3]
    b1 = W3 * r[1] - W7 * r[3]
    b2 = W5 * r[1] - W1 * r[3]
    b3 = W7 * r[1] - W5 * r[3]
    a0 = a0 + W4 * r[4] + W6 * r[6]
    a1 = a1 - W4 * r[4] - W2 * r[6]
    a2 = a2 - W4 * r[4] + W2 * r[6]
    a3 = a3 + W4 * r[4] - W6 * r[6]
    b0 = b0 + W5 * r[5] + W7 * r[7]
    b1 = b1 - W1 * r[5] - W5 * r[7]
    b2 = b2 + W7 * r[5] + W3 * r[7]
    b3 = b3 + W3 * r[5] - W1 * r[7]
    rows = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0], dim=-1)
    rows = _wrap(_wrap(rows, 32) >> ROW_SHIFT, 16)
    rows = torch.where(dc_only[..., None], _wrap(r[0] * 8, 16)[..., None], rows)
    c = [rows[:, k, :] for k in range(8)]
    a0 = W4 * (c[0] + ((1 << (COL_SHIFT - 1)) // W4))
    a1, a2, a3 = a0 + W6 * c[2], a0 - W6 * c[2], a0 - W2 * c[2]
    a0 = a0 + W2 * c[2]
    b0 = W1 * c[1] + W3 * c[3]
    b1 = W3 * c[1] - W7 * c[3]
    b2 = W5 * c[1] - W1 * c[3]
    b3 = W7 * c[1] - W5 * c[3]
    a0, a1, a2, a3 = a0 + W4 * c[4], a1 - W4 * c[4], a2 - W4 * c[4], a3 + W4 * c[4]
    b0, b1, b2, b3 = b0 + W5 * c[5], b1 - W1 * c[5], b2 + W7 * c[5], b3 + W3 * c[5]
    a0, a1, a2, a3 = a0 + W6 * c[6], a1 - W2 * c[6], a2 + W2 * c[6], a3 - W6 * c[6]
    b0, b1, b2, b3 = b0 + W7 * c[7], b1 - W5 * c[7], b2 + W3 * c[7], b3 - W1 * c[7]
    cols = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0], dim=1)
    return _wrap(cols, 32) >> COL_SHIFT


def predict_plain(ref: torch.Tensor, geo: Geometry, mv: torch.Tensor, rounding: int) -> torch.Tensor:
    """Half-pel prediction of every block from the flat reference frame, int64
    ``[N, 8, 8]``: samples beyond a plane's edge repeat its edge, and each
    prediction is ``(a + b + c + d + 2 - rounding_type) >> 2`` of the (up to)
    four integer samples around it."""
    base, stride, height, x0, y0, _ = _block_index(geo, str(ref.device))
    mvx = mv[:, 0].to(torch.int64)
    mvy = mv[:, 1].to(torch.int64)
    r = torch.arange(8, device=ref.device)
    xs = (x0 + (mvx >> 1))[:, None] + r[None, :]               # [N, 8]
    ys = (y0 + (mvy >> 1))[:, None] + r[None, :]
    fx, fy = (mvx & 1)[:, None], (mvy & 1)[:, None]
    wmax, hmax = (stride - 1)[:, None], (height - 1)[:, None]
    x_a, x_b = xs.clamp(min=0).minimum(wmax), (xs + fx).clamp(min=0).minimum(wmax)
    y_a, y_b = ys.clamp(min=0).minimum(hmax), (ys + fy).clamp(min=0).minimum(hmax)
    refl = ref.to(torch.int64)
    st = stride[:, None, None]
    bs = base[:, None, None]

    def at(yy, xx):
        return refl[bs + yy[:, :, None] * st + xx[:, None, :]]

    total = at(y_a, x_a) + at(y_a, x_b) + at(y_b, x_a) + at(y_b, x_b)
    return (total + 2 - rounding) >> 2


def reconstruct_vop_plain(levels: torch.Tensor, qscale: torch.Tensor, intra: torch.Tensor,
                          mv: torch.Tensor, coded: torch.Tensor, ref: Optional[torch.Tensor],
                          rounding: int, geo: Geometry) -> torch.Tensor:
    """Plain PyTorch version of ``mpeg4_recon``: one VOP's blocks -> the flat
    uint8 frame."""
    dev = levels.device
    intra_blk = intra.to(torch.bool).repeat_interleave(6)
    q_blk = qscale.to(torch.int64).repeat_interleave(6)
    luma_blk = (torch.arange(geo.n_blocks, device=dev) % 6) < 4
    # the residual of the coded blocks only (most of a P-VOP's are not)
    sel = coded.to(torch.bool).nonzero().squeeze(1)
    res = torch.zeros((geo.n_blocks, 8, 8), dtype=torch.int64, device=dev)
    if sel.numel():
        res[sel] = idct_plain(dequantize_plain(levels[sel], q_blk[sel], intra_blk[sel], luma_blk[sel]))
    if ref is None:
        if not bool(intra.all()):
            raise ValueError("reconstruct_vop: inter macroblocks need a reference frame")
        pred = torch.zeros_like(res)
    else:
        pred = predict_plain(ref, geo, mv, rounding)
        pred = torch.where(intra_blk[:, None, None], torch.zeros_like(pred), pred)
    out = torch.empty(geo.frame_bytes, dtype=torch.uint8, device=dev)
    pix = _block_index(geo, str(dev))[5]
    out[pix.reshape(-1)] = (pred + res).clamp_(0, 255).to(torch.uint8).reshape(-1)
    return out


# --- colour -----------------------------------------------------------------------

def _planes_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Y ``[T, >=height, >=width]`` and Cb, Cr at half the size, any integer
    type -> RGB uint8 ``[T, height, width, 3]``: libswscale's unscaled
    yuv -> rgb24 conversion in the 16-bit fixed-point form its x86 build
    runs, which is what both of the JAX package's readers give: with
    ``mulhi(a, b) = (a b) >> 16``, ``y = mulhi(8 Y - Y_OFFSET, Y_COEFF)`` (not
    clamped: below Y = 16 it goes negative), ``u = 8 Cb - 1024``,
    ``v = 8 Cr - 1024``, and R = y + mulhi(v, VR), G = y + mulhi(u, UG) +
    mulhi(v, VG), B = y + mulhi(u, UB), each saturated to [0, 255]; each
    chroma sample covers 2x2 pixels."""
    y = y[:, :height, :width].to(torch.int64)
    u = u.to(torch.int64).repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :height, :width] * 8 - 1024
    v = v.to(torch.int64).repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :height, :width] * 8 - 1024
    y = ((y * 8 - Y_OFFSET) * Y_COEFF) >> 16
    out = torch.stack([y + ((v * VR_COEFF) >> 16),
                       y + ((u * UG_COEFF) >> 16) + ((v * VG_COEFF) >> 16),
                       y + ((u * UB_COEFF) >> 16)], dim=-1)
    return out.clamp_(0, 255).to(torch.uint8)


def yuv420_to_rgb_plain(frames: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Plain PyTorch version of ``yuv420_rgb``: flat frames uint8 ``[T, F]``
    -> RGB uint8 ``[T, height, width, 3]`` (the arithmetic of
    :func:`_planes_to_rgb`)."""
    h, w = geo.luma
    hc, wc = h // 2, w // 2
    t = frames.shape[0]
    y = frames[:, :h * w].reshape(t, h, w)
    u = frames[:, h * w:h * w + hc * wc].reshape(t, hc, wc)
    v = frames[:, h * w + hc * wc:].reshape(t, hc, wc)
    return _planes_to_rgb(y, u, v, geo.height, geo.width)


def nv12_to_rgb_plain(luma: torch.Tensor, uv: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Plain PyTorch version of ``nv12_rgb``: an NV12 picture -> RGB uint8
    ``[height, width, 3]``.  ``luma`` is uint8 ``[>=height, >=width]`` and
    ``uv`` uint8 ``[>=height/2, >=width]``, Cb and Cr interleaved, both at any
    row stride (a decoder surface's pitch): de-interleaved, then the
    arithmetic of :func:`yuv420_to_rgb_plain`."""
    cw, ch = (width + 1) // 2, (height + 1) // 2
    return _planes_to_rgb(luma[None], uv[None, :ch, 0:2 * cw:2], uv[None, :ch, 1:2 * cw:2], height, width)[0]


def rgb_to_yuv420_plain(rgb: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """RGB uint8 ``[height, width, 3]`` -> the flat YUV 4:2:0 frame, the frame
    padded to macroblocks by repeating its last row and column.  Y is
    ``((RY r + GY g + BY b + 2^14) >> 15) + 16`` with libswscale's rgb2rgb
    coefficients; Cb and Cr take the same form on the rounded means of each
    2x2 quad."""
    h, w = geo.luma
    x = rgb.to(torch.int64)
    x = torch.nn.functional.pad(x.permute(2, 0, 1)[None].to(torch.float32),
                                (0, w - geo.width, 0, h - geo.height), mode="replicate")[0]
    x = x.to(torch.int64)
    r, g, b = x[0], x[1], x[2]
    half = 1 << (RGB2YUV_SHIFT - 1)
    y = ((RY * r + GY * g + BY * b + half) >> RGB2YUV_SHIFT) + 16

    def quad(p):
        return (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + 2) >> 2

    rq, gq, bq = quad(r), quad(g), quad(b)
    u = (((RU * rq + GU * gq + BU * bq + half) >> RGB2YUV_SHIFT) + 128).clamp(0, 255)
    v = (((RV * rq + GV * gq + BV * bq + half) >> RGB2YUV_SHIFT) + 128).clamp(0, 255)
    return torch.cat([y.reshape(-1), u.reshape(-1), v.reshape(-1)]).to(torch.uint8)


# --- forward (the encoder) ----------------------------------------------------------

def fdct_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Integer 8x8 FDCT of int64 ``[N, 8, 8]`` (rows y, columns x) -> int64
    ``[N, 64]`` in raster order (v, u): orthonormal, the basis at 13 bits,
    rounded after each pass."""
    c = _table(tuple(v for row in FDCT_BASIS for v in row), blocks.device).reshape(8, 8)
    tmp = (blocks[:, :, None, :] * c[None, None, :, :]).sum(-1)           # [N, y, u]
    tmp = (tmp + (1 << (FDCT_SHIFT1 - 1))) >> FDCT_SHIFT1
    out = (tmp[:, None, :, :] * c[None, :, :, None]).sum(2)               # [N, v, u]
    return ((out + (1 << (FDCT_SHIFT2 - 1))) >> FDCT_SHIFT2).reshape(-1, 64)


def quantize_plain(coef: torch.Tensor, q: int, intra: bool, luma_blk: torch.Tensor) -> torch.Tensor:
    """H.263 quantisation at qscale q: an intra DC is ``(F + s/2) // s`` for
    the dc_scaler s, an intra AC level ``|F| // 2q``, an inter level
    ``(2|F| - q) // 4q`` (a dead zone of a quarter step), each with F's sign
    and at most 2047."""
    a = coef.abs()
    lv = (a // (2 * q)) if intra else ((2 * a - q).clamp(min=0) // (4 * q))
    lv = torch.where(coef < 0, -lv, lv).clamp_(-2047, 2047)
    if intra:
        s = torch.where(luma_blk, torch.full_like(coef[:, 0], DC_SCALE_LUMA[q]),
                        torch.full_like(coef[:, 0], DC_SCALE_CHROMA[q]))
        lv[:, 0] = (coef[:, 0] + (s >> 1)) // s
    return lv.to(torch.int16)


def forward_vop_plain(rgb: torch.Tensor, ref: Optional[torch.Tensor], q: int, geo: Geometry) -> torch.Tensor:
    """Plain PyTorch version of ``mpeg4_forward``: one RGB frame -> the
    quantised levels int16 ``[n_blocks, 64]`` of an I-VOP (``ref`` None) or of
    a P-VOP predicted with the vector (0, 0) from the flat frame ``ref``."""
    cur = rgb_to_yuv420_plain(rgb, geo).to(torch.int64)
    pix = _block_index(geo, str(rgb.device))[5]
    blocks = cur[pix]
    if ref is not None:
        blocks = blocks - ref.to(torch.int64)[pix]
    luma_blk = (torch.arange(geo.n_blocks, device=rgb.device) % 6) < 4
    return quantize_plain(fdct_plain(blocks), q, ref is None, luma_blk)


# --- parsing --------------------------------------------------------------------------

def row_parts(geo: Geometry) -> Tuple[int, int, int, int, int]:
    """The int16 lengths of a parsed VOP's packed row: levels ``[n_blocks,
    64]``, qscale and intra ``[n_mb]``, mv ``[n_blocks, 2]``, coded
    ``[n_blocks]``."""
    return geo.n_blocks * 64, geo.n_mb, geo.n_mb, 2 * geo.n_blocks, geo.n_blocks


@dataclass
class VopRange:
    """Parsed VOPs: ``packed`` int16 ``[n, sum(row_parts)]`` (one row a VOP,
    on the device the range was parsed on), ``kinds`` one of "I", "P", "N"
    a VOP, ``rounding`` each VOP's ``rounding_type``."""
    packed: torch.Tensor
    kinds: str
    rounding: List[int]

    def __len__(self) -> int:
        return len(self.kinds)

    def split(self, i: int, geo: Geometry):
        """VOP ``i``'s (levels ``[n_blocks, 64]``, qscale, intra, mv
        ``[n_blocks, 2]``, coded), views of its row."""
        lv, q, intra, mv, coded = torch.split(self.packed[i], row_parts(geo))
        return lv.view(geo.n_blocks, 64), q, intra, mv.view(geo.n_blocks, 2), coded

    def vop(self, i: int, geo: Geometry) -> mpeg4v.VopData:
        """VOP ``i`` as the host parser's :class:`VopData` (copied to the host)."""
        lv, q, intra, mv, coded = (t.cpu().numpy() for t in self.split(i, geo))
        return mpeg4v.VopData(self.kinds[i], self.rounding[i], lv, q, intra, mv, coded)


#: the kernel's status codes -> the plain parser's message for the same fault
PARSE_ERRORS = {
    1: "MPEG-4 video with B-VOPs",
    2: "MPEG-4 video with S-VOPs (sprites)",
    3: "truncated VOP header",
    4: "missing marker bit after {what}",
    5: "MPEG-4 VOP with vop_quant 0",
    6: "MPEG-4 VOP with vop_fcode_forward 0",
    7: "MPEG-4 video with resync markers (video packets)",
    8: "invalid variable-length code at bit {pos}",
    9: "invalid TCOEF code at bit {pos}",
    10: "TCOEF run past the block end at bit {pos}",
    11: "invalid TCOEF escape at bit {pos}",
    12: "TCOEF escape with level 0 at bit {pos}",
}
#: which marker bit (status code 4, ``what`` in bits 8 and up)
PARSE_MARKERS = ("modulo_time_base", "vop_time_increment", "dct_dc_differential", "escape run", "escape level")


def parse_vops_plain(data: bytes, offsets: Sequence[Tuple[int, int, int]], vol_ids: Sequence[int],
                     vols: Sequence[mpeg4v.VOL], device="cpu") -> VopRange:
    """Plain version of ``mpeg4_parse``: each VOP through the host parser
    (:class:`fvd_tpu_torch.utils.mpeg4v.Decoder`) with the VOL in force for
    it.  ``offsets`` holds each VOP's (sample start, VOP payload start,
    sample end) in ``data``; an unsupported VOP raises
    :class:`UnsupportedVideo` as the host parser does."""
    geo = Geometry(vols[0].width, vols[0].height)
    packed = np.zeros((len(offsets), sum(row_parts(geo))), np.int16)
    kinds, rounding = [], []
    for i, ((start, vop, end), vid) in enumerate(zip(offsets, vol_ids)):
        v = mpeg4v.Decoder(vols[vid])._vop(data[start:end], vop - start)
        packed[i] = np.concatenate([v.levels.reshape(-1), v.qscale, v.intra, v.mv.reshape(-1), v.coded])
        kinds.append(v.kind)
        rounding.append(v.rounding)
    return VopRange(torch.from_numpy(packed).to(device), "".join(kinds), rounding)


def _parse_tables() -> np.ndarray:
    """``kTab`` of ``csrc/mpeg4_parse.cu``, int16, in its layout: each VLC's
    lookup table (``(symbol << 4) | length``, -1 where no code starts),
    the TCOEF tables' (last, run, level) and their LMAX and RMAX, the three
    scans, the DC scalers, ``intra_dc_vlc_thr``'s thresholds and the 4MV
    chroma rounding."""
    parts = []
    for codes, bits in ((mpeg4v.MCBPC_I, 9), (mpeg4v.MCBPC_P, 9), (mpeg4v.CBPY, 6), (mpeg4v.MVD, 12),
                        (mpeg4v.DC_LUMA, 11), (mpeg4v.DC_CHROMA, 12), (mpeg4v.TCOEF_INTRA_CODES, 12),
                        (mpeg4v.TCOEF_INTER_CODES, 12)):
        got, table = mpeg4v._lut(codes)
        assert got == bits, (got, bits)
        parts.append([-1 if e is None else (e[0] << 4) | e[1] for e in table])
    for rll in (mpeg4v.TCOEF_INTRA_RLL, mpeg4v.TCOEF_INTER_RLL):
        parts.append([(last << 12) | (run << 5) | level for last, run, level in rll] + [0])
    for tables in (mpeg4v._INTRA, mpeg4v._INTER):
        for which in (1, 2):  # LMAX by (last, run), RMAX by (last, level)
            parts.append([tables[which].get((last, k), 0) for last in (0, 1) for k in range(64)])
    parts += [mpeg4v.ZIGZAG, mpeg4v.ALT_HORIZONTAL, mpeg4v.ALT_VERTICAL, mpeg4v.DC_SCALE_LUMA,
              mpeg4v.DC_SCALE_CHROMA, mpeg4v.DC_THRESHOLD, mpeg4v._CHROMA_ROUND]
    return np.concatenate([np.asarray(p, np.int16) for p in parts])


@lru_cache(maxsize=1)
def _parse_tables_c():
    tab = _parse_tables()
    return (ctypes.c_int16 * len(tab))(*tab.tolist()), len(tab)


def parse_scratch_len(geo: Geometry) -> int:
    """int16 scratch a VOP needs on the card: the DC predictors of the three
    block grids (with a border), the first row and column of each intra
    block, and the luma vectors' grid (x and y)."""
    grids = (2 * geo.mb_h + 1) * (2 * geo.mb_w + 1) + 2 * (geo.mb_h + 1) * (geo.mb_w + 1)
    return 17 * grids + 2 * (2 * geo.mb_h + 1) * (2 * geo.mb_w + 2)


def _parse_error(status: int, pos: int) -> UnsupportedVideo:
    """The host parser's error for the kernel's ``status`` at bit ``pos``."""
    msg = PARSE_ERRORS.get(status & 0xFF, "MPEG-4 parse failed with status {status}")
    what = PARSE_MARKERS[status >> 8] if (status & 0xFF) == 4 and (status >> 8) < len(PARSE_MARKERS) else ""
    return UnsupportedVideo(msg.format(what=what, pos=pos, status=status))


def _parse_blob(data: bytes, offsets, vol_ids, vols) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """``mpeg4_parse``'s one input buffer: the VOPs' int64 (sample start,
    VOP payload start, sample end), the VOLs' int32 (time_bits,
    resync_marker_disable, quant_precision, 0), the VOPs' int32 VOL index and
    the samples, each 8-byte aligned, 8 zero bytes after them; and where the
    last three start."""
    table = np.asarray(offsets, np.int64).reshape(len(offsets), 3)
    vol_tab = np.asarray([(v.time_bits, v.resync_marker_disable, v.quant_precision, 0) for v in vols], np.int32)
    sections = [table.view(np.uint8).reshape(-1), vol_tab.view(np.uint8).reshape(-1),
                np.asarray(vol_ids, np.int32).view(np.uint8).reshape(-1), np.frombuffer(data, np.uint8)]
    starts, pos = [], 0
    for s in sections:
        starts.append(pos)
        pos += (len(s) + 7) // 8 * 8
    blob = np.zeros(pos + 8, np.uint8)
    for s, at in zip(sections, starts):
        blob[at:at + len(s)] = s
    return blob, (starts[1], starts[2], starts[3])


def parse_vops(data: bytes, offsets: Sequence[Tuple[int, int, int]], vol_ids: Sequence[int],
               vols: Sequence[mpeg4v.VOL], device=None) -> VopRange:
    """Entropy-decode the VOPs of one range of an ``mp4v`` stream -> their
    packed rows on ``device``.  ``data`` holds the range's compressed
    samples, ``offsets`` each VOP's (sample start, VOP payload start, sample
    end) in it, ``vol_ids`` the VOL of ``vols`` in force for each VOP (all of
    one frame size).  On the card, one launch of ``mpeg4_parse`` (a thread a
    VOP) after one copy of the bytes, then one fetch of the VOPs' kinds and
    statuses; a VOP the kernel refuses raises :class:`UnsupportedVideo` with
    the host parser's message.  :func:`parse_vops_plain` on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if not offsets:
        raise ValueError("parse_vops: no VOPs")
    geo = Geometry(vols[0].width, vols[0].height)
    if any((v.mb_w, v.mb_h) != (geo.mb_w, geo.mb_h) for v in vols):
        raise UnsupportedVideo("MPEG-4 video whose frame size changes mid-stream")
    if dev.type != "cuda":
        return parse_vops_plain(data, offsets, vol_ids, vols, dev)
    n = len(offsets)
    blob, starts = _parse_blob(data, offsets, vol_ids, vols)
    row = sum(row_parts(geo))
    scratch_len = parse_scratch_len(geo)
    on_card = torch.from_numpy(blob).to(dev)   # the one copy of the range
    dev = on_card.device                       # with its index
    packed = torch.zeros((n, row), dtype=torch.int16, device=dev)
    scratch = torch.zeros((n, scratch_len), dtype=torch.int16, device=dev)
    info = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    tab, tab_len = _parse_tables_c()
    args = _ParseArgs(n, len(vols), geo.mb_w, geo.mb_h, row, scratch_len, tab_len, *starts)
    _launch("mpeg4_parse", dev, on_card.data_ptr(), packed.data_ptr(), scratch.data_ptr(), info.data_ptr(),
            ctypes.addressof(tab), ctypes.addressof(args))
    got = info.cpu().numpy()                   # the one fetch
    bad = np.flatnonzero(got[:, 2])
    if len(bad):
        i = int(bad[0])
        raise _parse_error(int(got[i, 2]), int(got[i, 3]))
    return VopRange(packed, "".join("IPN"[k] for k in got[:, 0]), got[:, 1].tolist())


# --- the wrappers -----------------------------------------------------------------

class _ParseArgs(ctypes.Structure):
    """``ParseArgs`` in ``csrc/mpeg4_parse.cu``."""
    _fields_ = [(f, ctypes.c_int) for f in ("n_vops", "n_vols", "mb_w", "mb_h", "row_len", "scratch_len",
                                            "tab_len", "vols_at", "ids_at", "data_at")]


class _ReconArgs(ctypes.Structure):
    """``ReconArgs`` in ``csrc/mpeg4_decode.cu``."""
    _fields_ = [(f, ctypes.c_int) for f in ("mb_w", "mb_h", "rounding", "has_ref")]


class _RgbArgs(ctypes.Structure):
    """``RgbArgs`` in ``csrc/mpeg4_decode.cu``."""
    _fields_ = [(f, ctypes.c_int) for f in ("width", "height", "luma_w", "luma_h")]


class _Nv12Args(ctypes.Structure):
    """``Nv12Args`` in ``csrc/nvdec.cu``."""
    _fields_ = [(f, ctypes.c_int) for f in ("width", "height", "luma_pitch", "uv_pitch", "out_pitch")]


class _ForwardArgs(ctypes.Structure):
    """``ForwardArgs`` in ``csrc/mpeg4_encode.cu``."""
    _fields_ = [(f, ctypes.c_int) for f in ("width", "height", "mb_w", "mb_h", "q", "has_ref")]


#: ``kConsts`` of ``csrc/mpeg4_encode.cu``: the FDCT basis, then RY..BV
_FORWARD_CONSTS = (ctypes.c_int * 73)(*[v for row in FDCT_BASIS for v in row],
                                      RY, GY, BY, RU, GU, BU, RV, GV, BV)


def _launch(name: str, dev: torch.device, *args) -> None:
    fn = _kernels.load(name)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _kernels.count_launch(name)


def _on_cuda(name: str, *tensors: Optional[torch.Tensor]) -> Optional[torch.device]:
    """None where every tensor is on the CPU (the plain version runs); the
    CUDA device where all are on one; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return None
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}; need one CUDA device or the CPU")
    return next(iter(devs))


def _int16(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int16 and t.is_contiguous() else t.to(torch.int16).contiguous()


def reconstruct_vop(levels: torch.Tensor, qscale: torch.Tensor, intra: torch.Tensor,
                    mv: torch.Tensor, coded: torch.Tensor, ref: Optional[torch.Tensor],
                    rounding: int, geo: Geometry, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One VOP's levels ``[n_blocks, 64]``, per-macroblock qscale and intra
    flag ``[n_mb]``, per-block vectors ``[n_blocks, 2]`` and coded flags
    ``[n_blocks]`` and the previous flat frame (None for an all-intra VOP) ->
    the flat uint8 frame.  One launch of ``mpeg4_recon`` on CUDA tensors
    (into ``out`` where given); :func:`reconstruct_vop_plain` on the CPU."""
    dev = _on_cuda("reconstruct_vop", levels, qscale, intra, mv, coded, ref, out)
    if dev is None:
        frame = reconstruct_vop_plain(levels, qscale, intra, mv, coded, ref, rounding, geo)
        return frame if out is None else out.copy_(frame)
    if levels.shape != (geo.n_blocks, 64) or mv.shape != (geo.n_blocks, 2) \
            or qscale.numel() != geo.n_mb or intra.numel() != geo.n_mb or coded.numel() != geo.n_blocks:
        raise ValueError(f"reconstruct_vop: shapes {tuple(levels.shape)}, {tuple(mv.shape)} do not "
                         f"fit {geo}")
    if ref is not None and (ref.dtype != torch.uint8 or ref.numel() != geo.frame_bytes):
        raise ValueError(f"reconstruct_vop: the reference is {ref.dtype} x {ref.numel()}, not "
                         f"uint8 x {geo.frame_bytes}")
    if out is None:
        out = torch.empty(geo.frame_bytes, dtype=torch.uint8, device=dev)
    tensors = [_int16(t) for t in (levels, qscale, intra, mv, coded)]
    args = _ReconArgs(geo.mb_w, geo.mb_h, int(rounding), int(ref is not None))
    _launch("mpeg4_recon", dev, *(t.data_ptr() for t in tensors),
            None if ref is None else ref.contiguous().data_ptr(), out.data_ptr(),
            ctypes.addressof(args))
    return out


def yuv420_to_rgb(frame: torch.Tensor, geo: Geometry, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One flat uint8 frame -> RGB uint8 ``[height, width, 3]``: one launch of
    ``yuv420_rgb`` on a CUDA tensor (into ``out`` where given);
    :func:`yuv420_to_rgb_plain` on the CPU."""
    dev = _on_cuda("yuv420_to_rgb", frame, out)
    if dev is None:
        rgb = yuv420_to_rgb_plain(frame.reshape(1, -1), geo)[0]
        return rgb if out is None else out.copy_(rgb)
    if frame.dtype != torch.uint8 or frame.numel() != geo.frame_bytes:
        raise ValueError(f"yuv420_to_rgb: frame {frame.dtype} x {frame.numel()} does not fit {geo}")
    if out is None:
        out = torch.empty((geo.height, geo.width, 3), dtype=torch.uint8, device=dev)
    h, w = geo.luma
    args = _RgbArgs(geo.width, geo.height, w, h)
    _launch("yuv420_rgb", dev, frame.contiguous().data_ptr(), out.data_ptr(), ctypes.addressof(args))
    return out


def nv12_to_rgb(luma: torch.Tensor, uv: torch.Tensor, width: int, height: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An NV12 picture (``luma`` uint8 ``[>=height, >=width]``, ``uv`` uint8
    ``[>=height/2, >=width]`` interleaved Cb Cr, each at its own row stride:
    a decoder surface's pitch) -> RGB uint8 ``[height, width, 3]``: one launch
    of ``nv12_rgb`` on CUDA tensors (into ``out`` where given, whose rows may
    be strided); :func:`nv12_to_rgb_plain` on the CPU."""
    dev = _on_cuda("nv12_to_rgb", luma, uv, out)
    if dev is None:
        rgb = nv12_to_rgb_plain(luma, uv, width, height)
        return rgb if out is None else out.copy_(rgb)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    for name, t, rows, cols in (("luma", luma, height, width), ("uv", uv, ch, 2 * cw)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1 or t.shape[0] < rows or t.shape[1] < cols:
            raise ValueError(f"nv12_to_rgb: {name} {t.dtype} {tuple(t.shape)} (strides {t.stride()}) does "
                             f"not hold {rows} rows of {cols} bytes")
    if out is None:
        out = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    if out.dtype != torch.uint8 or tuple(out.shape) != (height, width, 3) or out.stride()[1:] != (3, 1):
        raise ValueError(f"nv12_to_rgb: out {out.dtype} {tuple(out.shape)} {out.stride()} is not "
                         f"[{height}, {width}, 3] uint8 with packed rows")
    args = _Nv12Args(width, height, luma.stride(0), uv.stride(0), out.stride(0))
    _launch("nv12_rgb", dev, luma.data_ptr(), uv.data_ptr(), out.data_ptr(), ctypes.addressof(args))
    return out


def forward_vop(rgb: torch.Tensor, ref: Optional[torch.Tensor], q: int, geo: Geometry) -> torch.Tensor:
    """One RGB frame uint8 ``[height, width, 3]`` -> the quantised levels
    int16 ``[n_blocks, 64]`` of an I-VOP (``ref`` None) or of a P-VOP with the
    vector (0, 0) against the flat frame ``ref``: one launch of
    ``mpeg4_forward`` on CUDA tensors; :func:`forward_vop_plain` on the CPU."""
    dev = _on_cuda("forward_vop", rgb, ref)
    if dev is None:
        return forward_vop_plain(rgb, ref, q, geo)
    if rgb.dtype != torch.uint8 or tuple(rgb.shape) != (geo.height, geo.width, 3):
        raise ValueError(f"forward_vop: frame {rgb.dtype} {tuple(rgb.shape)} does not fit {geo}")
    levels = torch.empty((geo.n_blocks, 64), dtype=torch.int16, device=dev)
    args = _ForwardArgs(geo.width, geo.height, geo.mb_w, geo.mb_h, int(q), int(ref is not None))
    _launch("mpeg4_forward", dev, rgb.contiguous().data_ptr(),
            None if ref is None else ref.contiguous().data_ptr(), levels.data_ptr(),
            ctypes.addressof(_FORWARD_CONSTS), ctypes.addressof(args))
    return levels
