"""MPEG-4 Part 2 video in MP4, decoded and encoded by the port: the
counterpart of ``fvd_tpu/providers/native_decode.py`` (the libav shim,
``native/decode_shim.cc``) and of OpenCV's ``mp4v`` writer.  :func:`open_video`
opens an MP4 by its codec: ``mp4v`` here, H.264 (``avc1``, ``avc3``) on the
card's NVDEC (``fvd_tpu_torch/providers/nvdec.py``).

Entropy decoding and encoding run on the host (``fvd_tpu_torch/utils/mpeg4v.py``,
the container in ``fvd_tpu_torch/utils/mp4.py``); reconstruction and colour
conversion run in the kernels of ``fvd_tpu_torch/ops/mpeg4.py``, on the card
unless the caller passes ``device="cpu"``, where their plain versions run.

:class:`NativeVideo` is one decode session, as the shim's handle is: it reads
the stream in a single forward pass across :meth:`NativeVideo.read_frames`
calls (ids before the session's position are dropped), a GOP at a time: the
host parses the GOP's VOPs, their levels and vectors cross to the card in one
copy, and the card reconstructs each VOP and converts the wanted ones to RGB.
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
from fvd_tpu_torch.utils import mp4, mpeg4v
from fvd_tpu_torch.utils.avi import UnsupportedVideo, fps_rational

#: the JAX package's files: an I-VOP every 12 frames, vop_quant 3
GOP = 12
QUANT = 3


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
        self._decoder = mpeg4v.Decoder(vol)
        self._pos = 0                              # next sample to decode
        self._ref: Optional[torch.Tensor] = None   # the frame of sample _pos - 1
        self._ahead: Optional[mpeg4v.VopData] = None
        self.stats = {"parse_s": 0.0, "recon_s": 0.0, "rgb_s": 0.0, "vops": 0}

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
            (t.frame_count / fps if fps else 0.0), False

    def probe_extra(self) -> Tuple[int, str]:
        """(rotation degrees [0, 360) from the ``tkhd`` matrix, codec name)."""
        return self.track.rotation, "mpeg4"

    def extract_audio(self, target_sr: int, max_seconds: float = 7200.0) -> Optional[np.ndarray]:
        """No audio codec is ported yet: always None (callers take the
        sibling ``.wav``)."""
        return None

    def next_gop(self, stop: int) -> List[mpeg4v.VopData]:
        """Parse the VOPs from the session's position up to (not including)
        the next I-VOP after it, or sample ``stop``, whichever comes first.
        An I-VOP parsed ahead is kept for the next call."""
        vops: List[mpeg4v.VopData] = []
        end = min(stop, self.track.frame_count)
        t0 = time.perf_counter()
        while self._pos + len(vops) < end:
            if self._ahead is not None:  # the VOP of sample self._pos
                vop, self._ahead = self._ahead, None
            else:
                vop = self._decoder.decode(self._sample(self._pos + len(vops)))
                self.stats["vops"] += 1
            if vops and vop.kind == "I":
                self._ahead = vop
                break
            vops.append(vop)
        self.stats["parse_s"] += time.perf_counter() - t0
        return vops

    def read_frames(self, frame_ids: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
        """The frames ``frame_ids`` (sorted, without repeats; ids past the end
        or before the session's position dropped) -> (uint8 [T, H, W, 3] RGB,
        kept ids).  Asking for an id past the end leaves the session at the
        end, as the shim's pass reads the stream to its end looking for it."""
        n = self.track.frame_count
        ids = {int(i) for i in frame_ids}
        frames, kept = self._read(sorted(i for i in ids if self._pos <= i < n))
        if any(i >= n for i in ids):
            self._pos, self._ahead, self._ref = n, None, None
        return frames.cpu().numpy(), kept

    def _read(self, wanted: List[int]) -> Tuple[torch.Tensor, List[int]]:
        """The frames ``wanted`` (sorted, from the session's position on) on
        the session's device, and the ids read."""
        geo, dev = self.geo, self.device
        out = torch.empty((len(wanted), geo.height, geo.width, 3), dtype=torch.uint8, device=dev)
        if not wanted:
            return out, []
        k = 0
        while k < len(wanted):
            vops = self.next_gop(wanted[-1] + 1)
            if not vops:
                break
            first = self._pos
            frames = self.reconstruct(vops)
            t0 = time.perf_counter()
            for j, frame in enumerate(frames):
                if k < len(wanted) and wanted[k] == first + j:
                    ops.yuv420_to_rgb(frame, geo, out=out[k])
                    k += 1
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            self.stats["rgb_s"] += time.perf_counter() - t0
        return out[:k], wanted[:k]

    def reconstruct(self, vops: List[mpeg4v.VopData]) -> List[torch.Tensor]:
        """Reconstruct ``vops`` (the samples from the session's position on)
        and advance it; returns the flat frames on the session's device."""
        geo, dev = self.geo, self.device
        t0 = time.perf_counter()
        n_blk, n_mb = geo.n_blocks, geo.n_mb
        parts = (n_blk * 64, n_mb, n_mb, 2 * n_blk, n_blk)
        packed = np.empty((len(vops), sum(parts)), np.int16)
        for i, v in enumerate(vops):
            packed[i] = np.concatenate([v.levels.reshape(-1), v.qscale, v.intra, v.mv.reshape(-1),
                                        v.coded])
        # one copy of the GOP to the device
        side = torch.from_numpy(packed).to(dev, non_blocking=False)
        frames = []
        for i, v in enumerate(vops):
            if v.kind == "N":
                if self._ref is None:
                    raise UnsupportedVideo(f"{self.path}: a not-coded VOP before any frame")
                frames.append(self._ref)
                continue
            if v.kind == "P" and self._ref is None:
                raise UnsupportedVideo(f"{self.path}: a P-VOP before any I-VOP")
            row = side[i]
            lv, q, intra, mv, coded = torch.split(row, parts)
            ref = self._ref if v.kind == "P" else None
            self._ref = ops.reconstruct_vop(lv.view(n_blk, 64), q, intra, mv.view(n_blk, 2), coded,
                                            ref, v.rounding, geo)
            frames.append(self._ref)
        self._pos += len(vops)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self.stats["recon_s"] += time.perf_counter() - t0
        return frames


def write_mp4v(path: str, frames: np.ndarray, fps: float, device=None) -> dict:
    """RGB uint8 ``[T, H, W, 3]`` -> an ``mp4v`` MP4 at ``path``, encoded on
    ``device`` (default the card): :func:`fvd_tpu_torch.ops.mpeg4.forward_vop`
    then the host's bitstream writer, the reference rebuilt with
    :func:`fvd_tpu_torch.ops.mpeg4.reconstruct_vop`.  Returns host seconds
    spent (``forward_s``, ``recon_s``, ``bits_s``) and the frame count."""
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
