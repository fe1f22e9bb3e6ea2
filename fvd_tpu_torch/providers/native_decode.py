"""MPEG-4 Part 2 video in MP4, decoded and encoded by the port: the
counterpart of ``fvd_tpu/providers/native_decode.py`` (the libav shim,
``native/decode_shim.cc``) and of OpenCV's ``mp4v`` writer.  :func:`open_video`
opens an MP4 by its codec: ``mp4v`` here, H.264 (``avc1``, ``avc3``) on the
card's NVDEC (``fvd_tpu_torch/providers/nvdec.py``).

The host reads the container (``fvd_tpu_torch/utils/mp4.py``) and each
sample's headers; entropy decoding, reconstruction and colour conversion run
in the kernels of ``fvd_tpu_torch/ops/mpeg4.py``, on the card unless the
caller passes ``device="cpu"``, where their plain versions run (the host
parser of ``fvd_tpu_torch/utils/mpeg4v.py`` among them).  Encoding's bit
writer runs on the host.

:class:`NativeVideo` is one decode session, as the shim's handle is: it reads
the stream in a single forward pass across :meth:`NativeVideo.read_frames`
calls (ids before the session's position are dropped), a range of samples at
a time (:data:`PARSE_CHUNK_BYTES`): the range's compressed bytes cross to the
card in one copy, one launch parses its VOPs, one fetch brings back their
kinds and statuses, and the card reconstructs each VOP and converts the
wanted ones to RGB.  A not-coded VOP gives no frame, as in libavcodec.  The
file's audio track reads through ``fvd_tpu_torch/providers/audio.py``.
:func:`write_mp4v` writes frames as an ``mp4v`` MP4, as the JAX package's
``write_video`` does through OpenCV: an I-VOP every :data:`GOP` frames, P-VOPs
between them, ``vop_quant`` :data:`QUANT`.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fvd_tpu_torch.ops import mpeg4 as ops
from fvd_tpu_torch.providers import audio
from fvd_tpu_torch.utils import mp4, mpeg4v
from fvd_tpu_torch.utils.avi import UnsupportedVideo, fps_rational

#: the JAX package's files: an I-VOP every 12 frames, vop_quant 3
GOP = 12
QUANT = 3
#: the most device memory one parsed range takes (its packed rows and the
#: parse kernel's scratch): 64 MiB: 213 VOPs at 320x240, 7 at 1920x1080
PARSE_CHUNK_BYTES = 64 << 20


def available() -> bool:
    """The port's decoder needs no library: always True."""
    return True


def _resolve(device):
    from fvd_tpu_torch import resolve_device

    return resolve_device(device)


def open_video(path: str, device=None):
    """A decode session of the MP4 file at ``path`` for its codec, the file
    parsed once: :class:`NativeVideo` for ``mp4v``,
    :class:`fvd_tpu_torch.providers.nvdec.NvdecVideo` for ``avc1`` and
    ``avc3``; another codec raises :class:`UnsupportedVideo` naming it."""
    from fvd_tpu_torch.providers.nvdec import NvdecVideo

    opened = mp4.open_track(path)
    return (NvdecVideo if opened[2].codec == "h264" else NativeVideo)(path, device, opened)


class NativeVideo:
    """One decode session of an ``mp4v`` MP4 file on ``device`` (default the
    card; resolved at the first decode, so probing needs no card).  ``stats``
    sums host seconds spent parsing, reconstructing and converting, and the
    VOPs parsed.  ``opened`` is :func:`fvd_tpu_torch.utils.mp4.open_track`'s
    result for ``path`` where the caller has it."""

    def __init__(self, path: str, device=None, opened=None):
        self.path = path
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._f, self._data, self.track = opened or mp4.open_track(path)
        try:
            if self.track.fourcc != "mp4v":
                raise UnsupportedVideo(f"{path}: MP4 video of codec {self.track.fourcc!r}, not MPEG-4 Part 2")
            if not self.track.sizes:
                raise UnsupportedVideo(f"{path}: MP4 video track without samples")
            vol = mpeg4v.find_vol(self.track.config) or mpeg4v.find_vol(self._sample(0))
            if vol is None:
                raise UnsupportedVideo(f"{path}: mp4v track without a VOL header")
        except BaseException:
            self.close()
            raise
        self.geo = ops.Geometry(vol.width, vol.height)
        self._vol = vol                             # the VOL in force after the last sample scanned
        self._pos = 0                               # next sample to reconstruct
        self._out = 0                               # frames given so far (a not-coded VOP gives none)
        self._ref: Optional[torch.Tensor] = None    # the frame of sample _pos - 1
        per_vop = 2 * (sum(ops.row_parts(self.geo)) + ops.parse_scratch_len(self.geo))
        self._chunk = max(1, PARSE_CHUNK_BYTES // per_vop)
        self.stats = {"parse_s": 0.0, "recon_s": 0.0, "rgb_s": 0.0, "vops": 0, "ranges": 0}

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = _resolve(self._device_arg)
        return self._device

    def close(self) -> None:
        if self._f is not None:
            self._data.close()
            self._f.close()
            self._f = None

    def __enter__(self) -> "NativeVideo":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _sample(self, i: int) -> bytes:
        off, size = self.track.offsets[i], self.track.sizes[i]
        return bytes(self._data[off:off + size])

    def probe(self) -> Tuple[float, int, int, int, float, bool]:
        """(fps, frame count, width, height, duration s, has audio)."""
        t = self.track
        fps = t.fps
        return fps, t.frame_count, self.geo.width, self.geo.height, \
            (t.frame_count / fps if fps else 0.0), audio.has_audio(self._data, self.path)

    def probe_extra(self) -> Tuple[int, str]:
        """(rotation degrees [0, 360) from the ``tkhd`` matrix, codec name)."""
        return self.track.rotation, "mpeg4"

    def extract_audio(self, target_sr: int, max_seconds: float = 7200.0) -> Optional[np.ndarray]:
        """The file's first audio track as mono float32 at ``target_sr``, at
        most ``max_seconds`` (:func:`fvd_tpu_torch.providers.audio.extract`
        on the session's device); None without an audio track."""
        return audio.extract(self.path, self._data, target_sr, max_seconds, self.device)

    def _parse(self, first: int, last: int) -> ops.VopRange:
        """Samples ``first`` to ``last`` (exclusive) entropy-decoded in one
        :func:`fvd_tpu_torch.ops.mpeg4.parse_vops` call: the host finds each
        sample's VOP and any VOL in force, the range's bytes cross in one
        copy."""
        t0 = time.perf_counter()
        data, offsets, vol_ids, vols = mpeg4v.scan_samples([self._sample(i) for i in range(first, last)], self._vol)
        rng = ops.parse_vops(data, offsets, vol_ids, vols, self.device)
        self._vol = vols[-1]
        self.stats["parse_s"] += time.perf_counter() - t0
        self.stats["vops"] += last - first
        self.stats["ranges"] += 1
        return rng

    def read_frames(self, frame_ids: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
        """The frames ``frame_ids`` (sorted, without repeats; ids past the end
        or before the session's position dropped) -> (uint8 [T, H, W, 3] RGB,
        kept ids).  Asking for an id past the end leaves the session at the
        end, as the shim's pass reads the stream to its end looking for it.
        As libavcodec, a not-coded VOP gives no frame: frame ids count the
        coded VOPs."""
        n = self.track.frame_count
        ids = {int(i) for i in frame_ids}
        frames, kept = self._read(sorted(i for i in ids if self._out <= i < n))
        if any(i >= n for i in ids):
            self._pos, self._ref = n, None
        return frames.cpu().numpy(), kept

    def _read(self, wanted: List[int]) -> Tuple[torch.Tensor, List[int]]:
        """The frames ``wanted`` (sorted, from the session's position on) on
        the session's device, and the ids read: ranges of VOPs parsed on the
        device, each VOP reconstructed, the wanted frames converted to RGB."""
        geo, dev = self.geo, self.device
        out = torch.empty((len(wanted), geo.height, geo.width, 3), dtype=torch.uint8, device=dev)
        k = 0

        def convert(frame, out_id):
            nonlocal k
            if k < len(wanted) and wanted[k] == out_id:
                ops.yuv420_to_rgb(frame, geo, out=out[k])
                k += 1

        while k < len(wanted):
            # each sample gives at most one frame
            end = min(self._pos + wanted[-1] + 1 - self._out, self.track.frame_count)
            if self._pos >= end:
                break
            rng = self._parse(self._pos, min(end, self._pos + self._chunk))
            self._reconstruct(rng, convert)
        return out[:k], wanted[:k]

    def _reconstruct(self, rng: ops.VopRange, on_frame) -> None:
        """Reconstruct the VOPs of ``rng`` (the samples from
        the session's position on) in order, calling ``on_frame(frame,
        out_id)`` with each VOP's flat frame and its frame id (None for a
        not-coded VOP, which repeats the previous frame and gives no frame of
        its own), and advance the session past them."""
        geo = self.geo
        t0 = time.perf_counter()
        rgb = 0.0
        for j, kind in enumerate(rng.kinds):
            if kind == "N":
                if self._ref is None:
                    raise UnsupportedVideo(f"{self.path}: a not-coded VOP before any frame")
            else:
                if kind == "P" and self._ref is None:
                    raise UnsupportedVideo(f"{self.path}: a P-VOP before any I-VOP")
                lv, q, intra, mv, coded = rng.split(j, geo)
                self._ref = ops.reconstruct_vop(lv, q, intra, mv, coded, self._ref if kind == "P" else None,
                                                rng.rounding[j], geo)
            out_id = None
            if kind != "N":
                out_id = self._out
                self._out += 1
            t1 = time.perf_counter()
            on_frame(self._ref, out_id)
            rgb += time.perf_counter() - t1
        self._pos += len(rng)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats["recon_s"] += time.perf_counter() - t0 - rgb
        self.stats["rgb_s"] += rgb


def write_mp4v(path: str, frames: np.ndarray, fps: float, device=None, audio: Optional[tuple] = None) -> dict:
    """RGB uint8 ``[T, H, W, 3]`` -> an ``mp4v`` MP4 at ``path``, encoded on
    ``device`` (default the card): :func:`fvd_tpu_torch.ops.mpeg4.forward_vop`
    then the host's bitstream writer, the reference rebuilt with
    :func:`fvd_tpu_torch.ops.mpeg4.reconstruct_vop`; ``audio``, where given,
    is :meth:`fvd_tpu_torch.utils.mp4.Mp4Writer.add_audio`'s arguments (an
    AAC track).  Returns host seconds spent (``forward_s``, ``recon_s``,
    ``bits_s``) and the frame count."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3 or not len(frames):
        raise ValueError(f"frames are uint8 [T, H, W, 3] RGB, got {frames.dtype} {frames.shape}")
    dev = _resolve(device)
    _, h, w, _ = frames.shape
    rate, scale = fps_rational(fps)
    if rate >= 1 << 16:
        raise ValueError(f"fps {fps} needs a time resolution of {rate}, past MPEG-4's 16 bits")
    geo = ops.Geometry(w, h)
    config = mpeg4v.write_headers(w, h, rate)
    vol = mpeg4v.parse_vol(config, config.index(b"\x00\x00\x01\x20") + 4)
    stats = {"forward_s": 0.0, "recon_s": 0.0, "bits_s": 0.0, "frames": len(frames)}
    zeros_mv = torch.zeros((geo.n_blocks, 2), dtype=torch.int16, device=dev)
    qscale = torch.full((geo.n_mb,), QUANT, dtype=torch.int16, device=dev)
    ones_mb = torch.ones(geo.n_mb, dtype=torch.int16, device=dev)
    zeros_mb = torch.zeros(geo.n_mb, dtype=torch.int16, device=dev)
    ref: Optional[torch.Tensor] = None
    rounding, seconds = 0, 0
    with mp4.Mp4Writer(path, w, h, fps, config) as out:
        if audio is not None:
            out.add_audio(*audio)
        for i, frame in enumerate(frames):
            t0 = time.perf_counter()
            intra = i % GOP == 0
            rgb = torch.from_numpy(np.ascontiguousarray(frame)).to(dev)
            levels = ops.forward_vop(rgb, None if intra else ref, QUANT, geo)
            host = levels.cpu().numpy()
            t1 = time.perf_counter()
            if intra:
                rounding = 0
                coded = torch.ones(geo.n_blocks, dtype=torch.int16, device=dev)
            else:
                rounding ^= 1  # 1, 0, 1, ... over the P-VOPs of a GOP, as libavcodec writes
                coded = (levels != 0).any(dim=1).to(torch.int16)
            ref = ops.reconstruct_vop(levels, qscale, ones_mb if intra else zeros_mb, zeros_mv,
                                      coded, None if intra else ref, rounding, geo)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            t2 = time.perf_counter()
            ticks = i * scale
            now = ticks // rate
            sample = mpeg4v.encode_vop(vol, "I" if intra else "P", host, QUANT, now - seconds,
                                       ticks % rate, rounding)
            seconds = now
            out.write((mpeg4v.write_gov() if i == 0 else b"") + sample, sync=intra)
            stats["forward_s"] += t1 - t0
            stats["recon_s"] += t2 - t1
            stats["bits_s"] += time.perf_counter() - t2
    return stats
