"""A known-answer H.264 writer: frames in an MP4 whose decoded pictures are
known exactly, to hold H.264 decoders to (libavcodec's, through the JAX
package's readers, and the card's NVDEC, through the port).

Every coded macroblock is I_PCM, which carries its samples raw; a P picture
codes a macroblock whose samples equal its reference's as a P_Skip (a copy:
its vector is (0, 0) at every position of an all-skip run), so a still frame
is one ``mb_skip_run``.  B pictures are non-reference pictures of I_PCM
macroblocks, coded after the reference that follows them in display order.
The stream is CAVLC in Main profile (or High with scaling lists in the SPS,
which I_PCM ignores), POC type 0, one slice a picture, the deblocking filter
off, every sync picture an IDR.  The VUI sets ``bitstream_restriction_flag``
with ``max_num_reorder_frames``, without which libavcodec guesses the reorder
depth and can emit a B picture late or drop it.

Colour goes through the port's ``rgb_to_yuv420_plain`` (libswscale's rgb2rgb
arithmetic), or YUV 4:2:0 planes are taken as they are; either way the
expected RGB of each frame is ``yuv420_to_rgb_plain`` of the samples coded,
the arithmetic of the JAX package's readers.  The tests and ``chip_smoke.py``
use this writer; ``write_video`` does not (the JAX package writes no H.264).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fvd_tpu_torch.ops import mpeg4 as ops
from fvd_tpu_torch.utils import h264, mp4

#: mb_type of I_PCM in an I, P and B slice (Tables 7-11, 7-13, 7-14)
PCM_MB_TYPE = {"I": 25, "P": 30, "B": 48}
SLICE_TYPE = {"P": 0, "B": 1, "I": 2}
LOG2_MAX_FRAME_NUM = LOG2_MAX_POC_LSB = 16
#: a 4x4 and an 8x8 scaling list the High-profile SPS carries explicitly
_SCALING_4X4 = tuple(6 + 3 * (i % 5) for i in range(16))
_SCALING_8X8 = tuple(16 + (i * 7) % 23 for i in range(64))


def gop_pattern(n: int, gop: int = 12) -> str:
    """Display-order picture types for ``n`` frames: an IDR every ``gop``
    frames, then ``BP`` pairs, a GOP ending on a P."""
    out = []
    for start in range(0, n, gop):
        k = min(gop, n - start)
        body = ("BP" * k)[:k - 1]
        if body.endswith("B"):
            body = body[:-1] + "P"
        out.append("I" + body)
    return "".join(out)


def _scaling_list(w: h264.BitWriter, values: Sequence[int]) -> None:
    """``scaling_list()`` of ``values``; a list that stops repeating its last
    value ends early (delta_scale to a next scale of 0)."""
    last = 8
    end = len(values)
    while end > 1 and values[end - 1] == values[end - 2]:
        end -= 1
    for j in range(len(values)):
        if j == end:
            w.se(((0 - last + 128) % 256) - 128)
            return
        w.se(((values[j] - last + 128) % 256) - 128)
        last = values[j]


def write_sps(mb_w: int, mb_h: int, crop: Tuple[int, int, int, int] = (0, 0, 0, 0), *,
              max_num_ref_frames: int = 1, max_num_reorder_frames: int = 0, high: bool = False,
              chroma_format_idc: int = 1, bit_depth: int = 8, frame_mbs_only: bool = True,
              full_range: bool = False) -> bytes:
    """A sequence parameter set NAL unit: Main profile, or High with a
    scaling matrix of explicit, default and fall-back lists; POC type 0; a
    VUI with the bitstream restriction.  The last four arguments make SPSs
    the port refuses (a test's)."""
    w = h264.BitWriter()
    high = high or chroma_format_idc != 1 or bit_depth != 8
    w.u(8, (244 if chroma_format_idc == 3 else 122 if chroma_format_idc == 2 else 110 if bit_depth > 8
            else 100) if high else 77)
    w.u(8, 0 if high else 0x40)      # constraint_set1_flag: Main
    w.u(8, 40)                       # level 4.0
    w.ue(0)                          # seq_parameter_set_id
    if high:
        w.ue(chroma_format_idc)
        if chroma_format_idc == 3:
            w.u(1, 0)
        w.ue(bit_depth - 8)
        w.ue(bit_depth - 8)
        w.u(1, 0)                    # qpprime_y_zero_transform_bypass_flag
        w.u(1, 1)                    # seq_scaling_matrix_present_flag
        for i in range(8 if chroma_format_idc != 3 else 12):
            if i == 0:
                w.u(1, 1)
                _scaling_list(w, _SCALING_4X4)
            elif i == 2:                 # useDefaultScalingMatrixFlag
                w.u(1, 1)
                w.se(-8)
            elif i == 6:
                w.u(1, 1)
                _scaling_list(w, _SCALING_8X8)
            elif i == 3:                 # a list that repeats its last value early
                w.u(1, 1)
                _scaling_list(w, (12, 20) + (24,) * 14)
            else:
                w.u(1, 0)
    w.ue(LOG2_MAX_FRAME_NUM - 4)
    w.ue(0)                          # pic_order_cnt_type
    w.ue(LOG2_MAX_POC_LSB - 4)
    w.ue(max_num_ref_frames)
    w.u(1, 0)                        # gaps_in_frame_num_value_allowed_flag
    w.ue(mb_w - 1)
    w.ue(mb_h // (2 - frame_mbs_only) - 1)
    w.flag(frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, 0)                    # mb_adaptive_frame_field_flag
    w.u(1, 1)                        # direct_8x8_inference_flag
    w.flag(any(crop))
    if any(crop):
        for c in crop:
            w.ue(c)
    w.u(1, 1)                        # vui_parameters_present_flag
    w.u(1, 0)                        # aspect_ratio_info_present_flag
    w.u(1, 0)                        # overscan_info_present_flag
    w.flag(full_range)               # video_signal_type_present_flag
    if full_range:
        w.u(3, 5)
        w.u(1, 1)
        w.u(1, 0)
    w.u(1, 0)                        # chroma_loc_info_present_flag
    w.u(1, 0)                        # timing_info_present_flag
    w.u(1, 0)                        # nal_hrd_parameters_present_flag
    w.u(1, 0)                        # vcl_hrd_parameters_present_flag
    w.u(1, 0)                        # pic_struct_present_flag
    w.u(1, 1)                        # bitstream_restriction_flag
    w.u(1, 1)                        # motion_vectors_over_pic_boundaries_flag
    w.ue(0)
    w.ue(0)
    w.ue(16)
    w.ue(16)
    w.ue(max_num_reorder_frames)
    w.ue(max_num_ref_frames)         # max_dec_frame_buffering
    return h264.nal_unit(3, h264.NAL_SPS, w.trailing())


def write_pps() -> bytes:
    """The picture parameter set: CAVLC, one slice group, one reference in
    each list by default, QP 26, deblocking control present."""
    w = h264.BitWriter()
    w.ue(0)          # pic_parameter_set_id
    w.ue(0)          # seq_parameter_set_id
    w.u(1, 0)        # entropy_coding_mode_flag: CAVLC
    w.u(1, 0)        # bottom_field_pic_order_in_frame_present_flag
    w.ue(0)          # num_slice_groups_minus1
    w.ue(0)          # num_ref_idx_l0_default_active_minus1
    w.ue(0)          # num_ref_idx_l1_default_active_minus1
    w.u(1, 0)        # weighted_pred_flag
    w.u(2, 0)        # weighted_bipred_idc
    w.se(0)          # pic_init_qp_minus26
    w.se(0)          # pic_init_qs_minus26
    w.se(0)          # chroma_qp_index_offset
    w.u(1, 1)        # deblocking_filter_control_present_flag
    w.u(1, 0)        # constrained_intra_pred_flag
    w.u(1, 0)        # redundant_pic_cnt_present_flag
    return h264.nal_unit(3, h264.NAL_PPS, w.trailing())


def _slice(kind: str, idr: bool, idr_id: int, frame_num: int, poc_lsb: int, mbs: np.ndarray,
           skip: Optional[np.ndarray]) -> bytes:
    """One slice NAL unit covering the picture: ``mbs`` uint8 [n_mb, 384]
    (each macroblock's 256 luma samples, then 64 Cb and 64 Cr, in raster
    order), ``skip`` the P_Skip macroblocks of a P picture."""
    w = h264.BitWriter()
    w.ue(0)                                   # first_mb_in_slice
    w.ue(SLICE_TYPE[kind])
    w.ue(0)                                   # pic_parameter_set_id
    w.u(LOG2_MAX_FRAME_NUM, frame_num)
    if idr:
        w.ue(idr_id)
    w.u(LOG2_MAX_POC_LSB, poc_lsb)
    if kind == "B":
        w.u(1, 1)                             # direct_spatial_mv_pred_flag
    if kind != "I":
        w.u(1, 0)                             # num_ref_idx_active_override_flag
        w.u(1, 0)                             # ref_pic_list_modification_flag_l0
    if kind == "B":
        w.u(1, 0)                             # ref_pic_list_modification_flag_l1
    if kind != "B":                           # dec_ref_pic_marking(): references only
        w.u(1, 0)                             # no_output_of_prior_pics / adaptive marking
        if idr:
            w.u(1, 0)                         # long_term_reference_flag
    w.se(0)                                   # slice_qp_delta
    w.ue(1)                                   # disable_deblocking_filter_idc: off
    mb_type = PCM_MB_TYPE[kind]
    run = 0
    for i in range(len(mbs)):
        if skip is not None and skip[i]:
            run += 1
            continue
        if kind != "I":
            w.ue(run)                         # mb_skip_run
            run = 0
        w.ue(mb_type)
        w.align_zero()                        # pcm_alignment_zero_bit
        w.raw(mbs[i].tobytes())
    if run:
        w.ue(run)
    ref_idc = 0 if kind == "B" else (3 if idr else 2)
    return h264.nal_unit(ref_idc, h264.NAL_IDR if idr else h264.NAL_SLICE, w.trailing())


def yuv_frames(frames: Union[np.ndarray, Tuple[np.ndarray, np.ndarray, np.ndarray]], geo: ops.Geometry):
    """The flat macroblock-aligned YUV frames uint8 [T, frame_bytes]: RGB
    through ``rgb_to_yuv420_plain``, or Y, Cb, Cr planes padded by repeating
    their last row and column."""
    h, w = geo.luma
    if isinstance(frames, tuple):
        y, u, v = (np.asarray(p, np.uint8) for p in frames)
        if u.shape[1:] != ((geo.height + 1) // 2, (geo.width + 1) // 2) or u.shape != v.shape:
            raise ValueError(f"chroma planes {u.shape}, {v.shape} do not fit {y.shape}")

        def pad(p, ph, pw):
            return np.pad(p, ((0, 0), (0, ph - p.shape[1]), (0, pw - p.shape[2])), mode="edge")

        return np.concatenate([pad(y, h, w).reshape(len(y), -1), pad(u, h // 2, w // 2).reshape(len(y), -1),
                               pad(v, h // 2, w // 2).reshape(len(y), -1)], axis=1)
    return np.stack([ops.rgb_to_yuv420_plain(torch.from_numpy(np.ascontiguousarray(f)), geo).numpy()
                     for f in frames])


def _macroblocks(flat: np.ndarray, geo: ops.Geometry) -> np.ndarray:
    """One flat frame -> its macroblocks' PCM samples uint8 [n_mb, 384]."""
    h, w = geo.luma
    y = flat[:h * w].reshape(geo.mb_h, 16, geo.mb_w, 16).transpose(0, 2, 1, 3).reshape(geo.n_mb, 256)
    c = flat[h * w:].reshape(2, geo.mb_h, 8, geo.mb_w, 8).transpose(1, 3, 0, 2, 4).reshape(geo.n_mb, 128)
    return np.concatenate([y, c], axis=1)


def decode_order(pattern: str) -> List[int]:
    """Display ids in coding order: each reference picture, then the B
    pictures shown before it."""
    order, waiting = [], []
    for i, kind in enumerate(pattern):
        if kind == "B":
            waiting.append(i)
        else:
            order.append(i)
            order += waiting
            waiting = []
    return order


def _check_pattern(pattern: str, n: int) -> None:
    if len(pattern) != n or set(pattern) - set("IPB") or not pattern.startswith("I"):
        raise ValueError(f"pattern {pattern!r}: one of I, P, B per frame ({n}), starting with I")
    if pattern.endswith("B") or "BI" in pattern:
        raise ValueError(f"pattern {pattern!r}: a B picture needs a P after it in its GOP")


def rotation_matrix(degrees: int) -> Tuple[int, ...]:
    """The ``tkhd`` matrix that libavformat reads as a rotation of ``degrees``
    (0, 90, 180 or 270)."""
    a, b = {0: (1, 0), 90: (0, 1), 180: (-1, 0), 270: (0, -1)}[degrees % 360]
    return (a << 16, b << 16, 0, -b << 16, a << 16, 0, 0, 0, 0x40000000)


def write_pcm_h264(path: str, frames, fps: float, pattern: Optional[str] = None, *, high: bool = False,
                   rotation: int = 0) -> np.ndarray:
    """Write ``frames`` (RGB uint8 [T, H, W, 3], or a tuple of Y, Cb, Cr
    uint8 planes [T, H, W], [T, H/2, W/2], [T, H/2, W/2]) as H.264 in an
    ``avc1`` MP4 at ``path``: ``pattern`` gives each frame's picture type in
    display order (``I``, ``P``, ``B``; default all ``I``; see
    :func:`gop_pattern`), a height or width off the macroblock grid is
    cropped from the bottom and right.  Returns the RGB uint8 [T, H, W, 3]
    a decoder must give, in display order."""
    if isinstance(frames, tuple):
        t, height, width = np.asarray(frames[0]).shape
    else:
        frames = np.asarray(frames)
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError(f"frames are uint8 [T, H, W, 3] RGB, got {frames.dtype} {frames.shape}")
        t, height, width, _ = frames.shape
    if width % 2 or height % 2 or not t:
        raise ValueError(f"H.264 4:2:0 frames have an even size, got {width}x{height} x {t}")
    pattern = pattern or "I" * t
    _check_pattern(pattern, t)
    geo = ops.Geometry(width, height)
    flat = yuv_frames(frames, geo)
    expect = ops.yuv420_to_rgb_plain(torch.from_numpy(flat), geo).numpy()
    h, w = geo.luma
    crop = (0, (w - width) // 2, 0, (h - height) // 2)
    has_b = "B" in pattern
    sps = write_sps(geo.mb_w, geo.mb_h, crop, max_num_ref_frames=2 if has_b else 1,
                    max_num_reorder_frames=1 if has_b else 0, high=high)
    pps = write_pps()
    order = decode_order(pattern)
    shift = max(j - i for j, i in enumerate(order))   # how far a picture decodes after its display slot
    with mp4.Mp4Writer(path, width, height, fps, h264.write_avcc(sps, pps), codec="avc1",
                       matrix=rotation_matrix(rotation)) as out:
        ref = None
        idr_at = idr_count = frame_num = 0
        for j, i in enumerate(order):
            kind = pattern[i]
            mbs = _macroblocks(flat[i], geo)
            idr = kind == "I"
            if idr:
                idr_at, frame_num = i, 0
                idr_count += 1
            skip = (mbs == ref).all(axis=1) if kind == "P" else None
            poc = (2 * (i - idr_at)) % (1 << LOG2_MAX_POC_LSB)
            nal = _slice(kind, idr, (idr_count - 1) % 2, frame_num % (1 << LOG2_MAX_FRAME_NUM), poc, mbs, skip)
            out.write(len(nal).to_bytes(4, "big") + nal, sync=idr, composition_offset=i - j + shift)
            if kind != "B":
                ref = mbs
                frame_num += 1
    return expect
