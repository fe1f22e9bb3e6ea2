"""Known-answer MPEG-4 Part 2 streams for the parser's tests and the card's
smoke run: every syntax path of :class:`fvd_tpu_torch.utils.mpeg4v.Decoder`
that the port's own encoder (:func:`fvd_tpu_torch.utils.mpeg4v.encode_vop`,
intra DC by its VLC, every vector (0, 0), no AC prediction) leaves out.

A stream is a list of :class:`VopSpec`: each VOP's kind ("I", "P", or "N"
for ``vop_coded`` 0), ``vop_quant``, ``intra_dc_vlc_thr``, ``f_code`` and
rounding, and one :class:`MbSpec` a macroblock: not coded, inter with one
vector or four, or intra (with or without AC prediction), a dquant, and the
levels the parser must give, raster order: an inter block's quantised levels,
an intra block's levels after DC and AC prediction.  :func:`encode_vop`
writes the VOP, coding each vector as its difference from the median
predictor (wrapped into the ``f_code`` range) and each intra block as its
residual from the predictions, which it runs as the decoder does;
:func:`expected` gives the :class:`VopData` the parser must return.
:func:`covering_stream` draws a stream that reaches: vectors at ``f_code`` 1,
2 and 3 with differences that wrap, four-vector macroblocks, intra
macroblocks in P-VOPs, dquant, TCOEF escapes of all three types,
``intra_dc_vlc_thr`` above 0 (intra DC coded as a TCOEF), ``ac_pred_flag``
1 from the left and from above, MCBPC stuffing and not-coded VOPs.
:func:`write_mp4` writes one as an ``mp4v`` MP4, the VOL repeated in later
I-VOPs' samples.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.utils import mp4
from fvd_tpu_torch.utils import mpeg4v as m
from fvd_tpu_torch.utils.avi import fps_rational


@dataclass
class MbSpec:
    """One macroblock: ``kind`` "skip" (not_coded), "inter", "inter4v" or
    "intra"; ``mv`` one (x, y) half-pel vector ("inter") or four
    ("inter4v"); ``levels`` int ``[6, 64]``; ``dquant`` one of -2, -1, 0, 1,
    2 (not with "inter4v" or "skip"); ``ac_pred`` for intra; ``stuffing``
    MCBPC stuffing codes before the macroblock's own."""
    kind: str
    levels: Optional[np.ndarray] = None
    mv: Sequence[Tuple[int, int]] = ()
    dquant: int = 0
    ac_pred: int = 0
    stuffing: int = 0


@dataclass
class VopSpec:
    kind: str                      # "I", "P" or "N"
    q: int = 3
    dc_thr: int = 0                # intra_dc_vlc_thr, 0..7
    f_code: int = 1
    rounding: int = 0
    mbs: List[MbSpec] = field(default_factory=list)


def _wrap_mvd(d: int, f_code: int) -> int:
    size = 1 << (5 + f_code)
    return (d + size // 2) % size - size // 2


def _put_mvd(w: m.BitWriter, d: int, f_code: int) -> None:
    """A vector component's difference ``d`` (already in the f_code range)."""
    if d == 0:
        w.code(m.MVD[0])
        return
    shift = f_code - 1
    a = abs(d)
    w.code(m.MVD[((a - 1) >> shift) + 1])
    w.put(1, int(d < 0))
    if shift:
        w.put(shift, (a - 1) & ((1 << shift) - 1))


def _runs(block: Sequence[int], scan: Sequence[int], first: int) -> List[Tuple[int, int]]:
    out, prev = [], first - 1
    for i in range(first, 64):
        v = int(block[scan[i]])
        if v:
            out.append((i - prev - 1, v))
            prev = i
    return out


class _Intra:
    """The decoder's DC and AC prediction (``Decoder._intra_block``), run
    forward over final levels to give each intra block's residual."""

    def __init__(self, mb_w: int, mb_h: int):
        self.st = m._IntraState(mb_w, mb_h)
        self.mb_w = mb_w

    def residual(self, blk: Sequence[int], n, mb_x, mb_y, q, qlist, ac_pred, use_dc_vlc):
        """(DC difference, AC residuals raster ``[64]`` with the DC's residual
        at 0 when DC is coded as a TCOEF, the scan) of one block whose final
        levels are ``blk``; updates the predictors as the decoder does."""
        st = self.st
        scale = (m.DC_SCALE_LUMA if n < 4 else m.DC_SCALE_CHROMA)[q]
        g, i = st.where(n, mb_x, mb_y)
        up = i - st.stride[g]
        pred_dc, direction = st.dc_pred(g, i, scale)
        blk = [int(v) for v in blk]
        res = list(blk)
        if ac_pred:
            mb = len(qlist) - 1
            if direction == 0:
                nb = st.ac_left.get((g, i - 1), m._IntraState._ZEROS)
                nq = qlist[mb - 1] if mb_x > 0 else q
                rescale = not (mb_x == 0 or nq == q or n in (1, 3))
                for k in range(1, 8):
                    res[k * 8] -= m._rounded_div(nb[k] * nq, q) if rescale else nb[k]
            else:
                nb = st.ac_top.get((g, up), m._IntraState._ZEROS)
                nq = qlist[mb - self.mb_w] if mb_y > 0 else q
                rescale = not (mb_y == 0 or nq == q or n in (2, 3))
                for k in range(1, 8):
                    res[k] -= m._rounded_div(nb[k] * nq, q) if rescale else nb[k]
        st.store_dc(g, i, blk[0], scale)
        if ac_pred or any(blk[8:64:8]) or any(blk[1:8]):
            st.ac_left[g, i] = blk[0:64:8]
            st.ac_top[g, i] = blk[0:8]
        diff = blk[0] - pred_dc
        res[0] = 0 if use_dc_vlc else diff
        scan = (m.ALT_VERTICAL if direction == 0 else m.ALT_HORIZONTAL) if ac_pred else m.ZIGZAG
        return diff, res, scan


def encode_vop(vol: m.VOL, spec: VopSpec, modulo_time_base: int, time_increment: int) -> bytes:
    """One VOP of ``spec`` (see the module docstring)."""
    mb_w, mb_h = vol.mb_w, vol.mb_h
    w = m.BitWriter()
    w.start_code(m.VOP_START)
    w.put(2, 1 if spec.kind == "P" else 0)
    for _ in range(modulo_time_base):
        w.put(1, 1)
    w.put(1, 0); w.put(1, 1)
    w.put(vol.time_bits, time_increment); w.put(1, 1)
    if spec.kind == "N":
        w.put(1, 0)
        w.stuffing()
        return w.getvalue()
    w.put(1, 1)
    p_vop = spec.kind == "P"
    if p_vop:
        w.put(1, spec.rounding)
    w.put(3, spec.dc_thr)
    w.put(5, spec.q)
    if p_vop:
        w.put(3, spec.f_code)
    intra_st = _Intra(mb_w, mb_h)
    stride = 2 * mb_w + 2
    mvx = [0] * ((2 * mb_h + 1) * stride)
    mvy = [0] * len(mvx)
    q = spec.q
    qlist: List[int] = []
    for mb, s in enumerate(spec.mbs):
        mb_x, mb_y = mb % mb_w, mb // mb_w
        if s.kind == "skip":
            if not p_vop:
                raise ValueError("an I-VOP has no not-coded macroblocks")
            w.put(1, 1)
            qlist.append(q)
            continue
        intra = s.kind == "intra"
        if s.dquant and s.kind == "inter4v":
            raise ValueError("inter4v macroblocks carry no dquant")
        mb_type = {"inter": 0, "inter4v": 2, "intra": 3}[s.kind] + (1 if s.dquant else 0)
        use_dc_vlc = q < m.DC_THRESHOLD[spec.dc_thr]
        if s.dquant:
            q = min(31, max(1, q + s.dquant))
        qlist.append(q)
        levels = np.asarray(s.levels, np.int64).reshape(6, 64)
        if intra:
            coded = []
            for n in range(6):
                diff, res, scan = intra_st.residual(levels[n], n, mb_x, mb_y, q, qlist, s.ac_pred, use_dc_vlc)
                runs = _runs(res, scan, 1 if use_dc_vlc else 0)
                coded.append((diff, runs))
            cbp = sum(int(bool(runs)) << (5 - n) for n, (_, runs) in enumerate(coded))
        else:
            runs_all = [_runs(levels[n], m.ZIGZAG, 0) for n in range(6)]
            cbp = sum(int(bool(r)) << (5 - n) for n, r in enumerate(runs_all))
        for _ in range(s.stuffing):  # in a P-VOP each stuffing code follows a not_coded 0
            if p_vop:
                w.put(1, 0)
            w.code(m.MCBPC_P[20] if p_vop else m.MCBPC_I[8])
        if p_vop:
            w.put(1, 0)
        w.code((m.MCBPC_P[4 * mb_type + (cbp & 3)]) if p_vop else m.MCBPC_I[4 * (mb_type - 3) + (cbp & 3)])
        if intra:
            w.put(1, s.ac_pred)
            w.code(m.CBPY[cbp >> 2])
        else:
            w.code(m.CBPY[(cbp >> 2) ^ 15])
        if s.dquant:
            w.put(2, m.DQUANT.index(s.dquant))
        if intra:
            for n, (diff, runs) in enumerate(coded):
                if use_dc_vlc:
                    size = abs(diff).bit_length()
                    w.code((m.DC_LUMA if n < 4 else m.DC_CHROMA)[size])
                    if size:
                        w.put(size, diff if diff > 0 else diff + (1 << size) - 1)
                        if size > 8:
                            w.put(1, 1)
                if runs:
                    m._put_tcoef(w, runs, m._INTRA)
            continue
        base = (2 * mb_y + 1) * stride + 2 * mb_x + 1
        vecs = list(s.mv) if s.kind == "inter4v" else [tuple(s.mv[0])] * 4
        for n in range(4 if s.kind == "inter4v" else 1):
            px, py = m.Decoder._pred_mv(mvx, mvy, stride, base, mb_x, mb_y, n)
            x, y = vecs[n]
            _put_mvd(w, _wrap_mvd(x - px, spec.f_code), spec.f_code)
            _put_mvd(w, _wrap_mvd(y - py, spec.f_code), spec.f_code)
            cells = [base + (n >> 1) * stride + (n & 1)] if s.kind == "inter4v" else \
                [base, base + 1, base + stride, base + stride + 1]
            for i in cells:
                mvx[i], mvy[i] = x, y
        for n in range(6):
            if runs_all[n]:
                m._put_tcoef(w, runs_all[n], m._INTER)
    w.stuffing()
    return w.getvalue()


def expected(vol: m.VOL, spec: VopSpec) -> m.VopData:
    """The :class:`VopData` the parser must give for ``spec``."""
    n_mb = vol.mb_w * vol.mb_h
    levels = np.zeros((6 * n_mb, 64), np.int16)
    mv = np.zeros((6 * n_mb, 2), np.int16)
    coded = np.zeros(6 * n_mb, np.int16)
    qscale = np.zeros(n_mb, np.int16)
    intra = np.zeros(n_mb, np.int16)
    if spec.kind == "N":
        return m.VopData("N", 0, levels, qscale, intra, mv, coded)
    q = spec.q
    for mb, s in enumerate(spec.mbs):
        b0 = 6 * mb
        if s.kind != "skip" and s.dquant:
            q = min(31, max(1, q + s.dquant))
        qscale[mb] = q
        if s.kind == "skip":
            continue
        blk = np.asarray(s.levels, np.int64).reshape(6, 64)
        if s.kind == "intra":
            intra[mb] = 1
            levels[b0:b0 + 6] = blk
            coded[b0:b0 + 6] = 1
            continue
        vecs = list(s.mv) if s.kind == "inter4v" else [tuple(s.mv[0])] * 4
        if s.kind == "inter4v":
            c = (m.chroma_mv_4(sum(v[0] for v in vecs)), m.chroma_mv_4(sum(v[1] for v in vecs)))
        else:
            c = (m.chroma_mv_1(vecs[0][0]), m.chroma_mv_1(vecs[0][1]))
        mv[b0:b0 + 4] = vecs
        mv[b0 + 4:b0 + 6] = c
        levels[b0:b0 + 6] = blk
        coded[b0:b0 + 6] = blk.any(axis=1)
    return m.VopData(spec.kind, spec.rounding if spec.kind == "P" else 0, levels, qscale, intra, mv, coded)


def _ac_levels(rng, q, n, dense, big):
    """Quantised AC levels of ``n`` blocks, raster ``[n, 64]`` with DC 0:
    sparse small ones, some dense runs, and (``big``) escapes of type 3;
    dequantised they stay inside [-2048, 2047] at qscale ``q``."""
    out = np.zeros((n, 64), np.int64)
    top = max(1, (2047 - q) // (2 * q))
    for b in range(n):
        k = rng.randint(0, 12) if dense else rng.randint(0, 4)
        pos = rng.choice(np.arange(1, 64), size=k, replace=False)
        vals = rng.randint(1, 4, size=k) * rng.choice([-1, 1], size=k)
        if big and k and rng.rand() < 0.5:
            vals[0] = rng.randint(min(30, top), top + 1) * rng.choice([-1, 1])
        out[b, pos] = np.clip(vals, -top, top)
    return out


def covering_stream(width: int = 64, height: int = 48, n: int = 12, seed: int = 0) -> List[VopSpec]:
    """A stream of ``n`` VOPs (at least 8) whose syntax reaches every path
    named in the module docstring: VOP 0 an I-VOP with AC prediction, DC by
    VLC; then P-VOPs cycling f_code 1, 2, 3 with large vectors whose
    differences wrap, four-vector, intra (AC prediction from either side)
    and not-coded macroblocks, dquant and stuffing; a not-coded VOP; an
    I-VOP whose ``intra_dc_vlc_thr`` puts some macroblocks' DC into the
    TCOEFs."""
    if n < 8:
        raise ValueError("a covering stream needs at least 8 VOPs")
    rng = np.random.RandomState(seed)
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    n_mb = mb_w * mb_h
    specs: List[VopSpec] = []
    for t in range(n):
        if t == 0 or t == 6:
            # I-VOPs: the second at intra_dc_vlc_thr 3 (DC as a TCOEF from
            # qscale 17), its dquant crossing the threshold
            q = 5 if t == 0 else 16
            spec = VopSpec("I", q=q, dc_thr=0 if t == 0 else 3)
            for mb in range(n_mb):
                dq = [0, 2, 1, -1, 0, -2][mb % 6] if t == 6 else ((mb % 4 == 3) and 1)
                q = min(31, max(1, q + dq))
                spec.mbs.append(_intra_mb(rng, q, ac_pred=int(mb % 3 != 0), dquant=dq, stuffing=int(mb == 1)))
            specs.append(spec)
            continue
        if t == 4:
            specs.append(VopSpec("N"))
            continue
        f_code = 1 + (t % 3)
        reach = 16 << (f_code - 1)
        q = [4, 8, 12][t % 3]
        spec = VopSpec("P", q=q, f_code=f_code, rounding=t % 2)
        for mb in range(n_mb):
            r = (mb + t) % 7
            dq = 0
            if r == 0:
                spec.mbs.append(MbSpec("skip"))
                continue
            if r == 1:
                dq = [-1, 2][mb % 2]
                q = min(31, max(1, q + dq))
                spec.mbs.append(_intra_mb(rng, q, ac_pred=1, dquant=dq))
                continue
            if r in (2, 5):
                # far vectors: a difference past the range wraps around
                while True:
                    vecs = [_vector(rng, reach, spec.rounding) for _ in range(4)]
                    c = (m.chroma_mv_4(sum(v[0] for v in vecs)), m.chroma_mv_4(sum(v[1] for v in vecs)))
                    if not spec.rounding or (c[0] % 2 == c[1] % 2 and _inside_4v(vecs, c, mb % mb_w, mb // mb_w,
                                                                                  width, height)):
                        break
                spec.mbs.append(MbSpec("inter4v", _ac_levels(rng, q, 6, dense=True, big=True), vecs))
                continue
            if r == 3:
                dq = [1, -2][mb % 2]
                q = min(31, max(1, q + dq))
            vec = _vector(rng, reach, spec.rounding, chroma=True)
            spec.mbs.append(MbSpec("inter", _ac_levels(rng, q, 6, dense=r == 6, big=r == 4), [vec], dquant=dq,
                                   stuffing=int(r == 6 and mb < 2)))
        specs.append(spec)
    return specs


def _vector(rng, reach: int, rounding: int, chroma: bool = False) -> Tuple[int, int]:
    """A half-pel vector in ``[-2 reach, 2 reach)``.  Under rounding_type 1
    its luma (and, with ``chroma``, its chroma) prediction is whole-pel or
    half-pel in both directions, never in one alone: libavcodec's default
    x86 build averages a one-direction half-pel sample without rounding only
    approximately (off by one next to a 0 sample; ``AV_CODEC_FLAG_BITEXACT``
    turns that off), and OpenCV's FFmpeg approximates it otherwise, so the
    JAX package's two readers agree with each other, and with the standard,
    only outside that case."""
    while True:
        x, y = (int(v) for v in rng.randint(-2 * reach, 2 * reach, 2))
        if not rounding:
            return x, y
        luma_ok = x % 2 == y % 2
        chroma_ok = (x % 4 != 0) == (y % 4 != 0)
        if luma_ok and (chroma_ok or not chroma):
            return x, y


def _inside_4v(vecs, c, mb_x: int, mb_y: int, width: int, height: int) -> bool:
    """Whether no block of a four-vector macroblock is predicted from at or
    past the frame's right or bottom edge: libavcodec clips such a block's
    position to the edge and drops its half-pel flag in that direction, which
    under rounding_type 1 leaves a one-direction average (see
    :func:`_vector`)."""
    for n, (x, y) in enumerate(vecs):
        if 16 * mb_x + 8 * (n & 1) + (x >> 1) >= width or 16 * mb_y + 8 * (n >> 1) + (y >> 1) >= height:
            return False
    return 8 * mb_x + (c[0] >> 1) < width // 2 and 8 * mb_y + (c[1] >> 1) < height // 2


def _intra_mb(rng, q: int, ac_pred: int, dquant: int = 0, stuffing: int = 0) -> MbSpec:
    levels = _ac_levels(rng, q, 6, dense=True, big=True)
    for n in range(6):
        scale = (m.DC_SCALE_LUMA if n < 4 else m.DC_SCALE_CHROMA)[q]
        levels[n, 0] = rng.randint(max(1, 200 // scale), 1800 // scale)
    return MbSpec("intra", levels, dquant=dquant, ac_pred=ac_pred, stuffing=stuffing)


def encode_stream(width: int, height: int, fps: float, specs: Sequence[VopSpec]):
    """(the VOS/VO/VOL headers, each VOP's bytes, the :class:`VopData` the
    parser must give for each)."""
    rate, scale = fps_rational(fps)
    config = m.write_headers(width, height, rate)
    vol = m.parse_vol(config, config.index(b"\x00\x00\x01\x20") + 4)
    samples, answers, seconds = [], [], 0
    for i, spec in enumerate(specs):
        ticks = i * scale
        now = ticks // rate
        samples.append(encode_vop(vol, spec, now - seconds, ticks % rate))
        seconds = now
        answers.append(expected(vol, spec))
    return config, samples, answers


def write_mp4(path: str, width: int, height: int, fps: float, specs: Sequence[VopSpec]) -> List[m.VopData]:
    """``specs`` as an ``mp4v`` MP4 at ``path`` (a GOV before the first VOP,
    the VOS/VO/VOL headers again in the sample of every later I-VOP, as some
    encoders repeat them; the I-VOPs sync samples) -> the :class:`VopData`
    the parser must give."""
    config, samples, answers = encode_stream(width, height, fps, specs)
    with mp4.Mp4Writer(path, width, height, fps, config) as out:
        for i, (spec, sample) in enumerate(zip(specs, samples)):
            head = m.write_gov() if i == 0 else config if spec.kind == "I" else b""
            out.write(head + sample, sync=spec.kind == "I")
    return answers
