"""H.264 (AVC) in MP4, decoded by the card's NVDEC: the port's counterpart of
what the JAX package reads through libavcodec's ``h264`` decoder and
libswscale (``native/decode_shim.cc`` ``fvd_read_frames``, or OpenCV).

The host reads the container (``fvd_tpu_torch/utils/mp4.py``) and the
parameter sets (``fvd_tpu_torch/utils/h264.py``), and hands each sample to
the card's hardware decoder as an Annex B access unit (``csrc/nvdec.cu``: the
parser, the decoder, their callbacks); each picture comes back in display
order as an NV12 surface on the card, which ``nv12_rgb``
(:func:`fvd_tpu_torch.ops.mpeg4.nv12_to_rgb`) converts to RGB with the
arithmetic of the JAX package's readers.  Decoded H.264 is exact by the
standard, so the frames should equal the JAX readers' bit for bit.

Unverified: no NVDEC decode has run on a card yet.  The only H100 this was
tried on runs in a container without NVIDIA's ``video`` capability, where
every cuvid call fails (:func:`out_of_reach`), so the session, its
hand-declared Video Codec SDK structures and the surface layout have not been
held against the known-answer streams (``fvd_tpu_torch/utils/h264_pcm.py``)
on a card that decodes.  H.264 is not yet a supported input.

There is no CPU H.264 decoder in the port: :class:`NvdecVideo` raises
:class:`UnsupportedVideo` naming NVDEC when its caller asks for the CPU, and
a missing ``libnvcuvid`` or a failed call of the decoder raises
:class:`NvdecError`.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fvd_tpu_torch import _kernels
from fvd_tpu_torch.ops import mpeg4 as ops
from fvd_tpu_torch.providers import audio
from fvd_tpu_torch.utils import h264, mp4
from fvd_tpu_torch.utils.avi import UnsupportedVideo

#: the session's own codes (``csrc/nvdec.cu``); a positive code is a CUresult
_CODES = {-1: "libcuda.so.1 could not be loaded", -2: "libnvcuvid.so.1 (NVDEC) could not be loaded",
          -3: "a symbol of libcuda or libnvcuvid is missing", -4: "a stream this card's NVDEC does not decode",
          -5: "a picture was decoded over before it was read", -6: "no picture is waiting",
          -7: "a call out of turn"}


def _fn(name: str):
    return _kernels.load(name)


def _message(handle) -> str:
    buf = ctypes.create_string_buffer(512)
    _fn("nvdec_message")(handle, ctypes.addressof(buf), len(buf))
    return buf.value.decode(errors="replace")


class NvdecError(RuntimeError):
    """A failed call of the NVDEC session: ``code`` is a CUresult, or one of
    the session's own negative codes (``_CODES``)."""

    def __init__(self, text: str, code: int):
        super().__init__(text)
        self.code = code


def _video_capability_withheld() -> bool:
    """Whether the process runs in a container that names its driver
    capabilities without ``video`` (nor ``all``)."""
    caps = os.environ.get("NVIDIA_DRIVER_CAPABILITIES")
    return caps is not None and not {"video", "all"} & {c.strip() for c in caps.split(",")}


def out_of_reach(err: BaseException) -> bool:
    """Whether ``err`` is the one failure that the machine, not the port,
    causes: CUresult 2 (what every cuvid call returns there) in a container
    without NVIDIA's ``video`` capability.  Any other failure (a missing
    library or symbol, another CUresult, the same CUresult where the
    capability is given) is a fault to report."""
    return isinstance(err, NvdecError) and err.code == 2 and _video_capability_withheld()


def _check(rc: int, handle, what: str) -> None:
    if rc == 0:
        return
    text = f"NVDEC {what}: {_CODES.get(rc, f'CUresult {rc}')} ({_message(handle)})"
    if rc == -4:
        raise UnsupportedVideo(text)
    if rc == 2 and _video_capability_withheld():
        text += ("; a container reaches NVDEC only with NVIDIA's video capability "
                 f"(NVIDIA_DRIVER_CAPABILITIES={os.environ.get('NVIDIA_DRIVER_CAPABILITIES')!r})")
    raise NvdecError(text, rc)


def decoder_caps(device=None) -> Dict[str, int]:
    """The card's NVDEC capabilities for H.264 4:2:0 8-bit
    (``cuvidGetDecoderCaps``)."""
    dev = torch.device("cuda" if device is None else device)
    out = (ctypes.c_int * 8)()
    _check(_fn("nvdec_caps")(dev.index or 0, ctypes.addressof(out)), None, "cuvidGetDecoderCaps")
    keys = ("supported", "nvdecs", "output_format_mask", "max_width", "max_height", "max_mb_count",
            "min_width", "min_height")
    return dict(zip(keys, list(out)))


class _CudaBytes:
    """A device buffer of ``rows`` x ``pitch`` bytes, seen by
    ``torch.as_tensor`` through ``__cuda_array_interface__`` (no copy)."""

    def __init__(self, ptr: int, rows: int, pitch: int):
        self.__cuda_array_interface__ = {"shape": (rows, pitch), "typestr": "|u1", "data": (ptr, False),
                                         "version": 2}


class Surface:
    """A mapped NVDEC picture: ``luma`` and ``uv`` (uint8 views of the NV12
    surface at its ``pitch``, from the display rectangle's corner), the
    display ``width`` and ``height``.  Valid until the session's
    :meth:`NvdecSession.unmap`."""

    def __init__(self, info, device: torch.device):
        ptr, pitch, rows, self.width, self.height, left, top, _ = (int(v) for v in info)
        whole = torch.as_tensor(_CudaBytes(ptr, rows + rows // 2, pitch), device=device)
        self.pitch = pitch
        self.luma = whole[top:rows, left:]
        self.uv = whole[rows + top // 2:, left:]


class NvdecSession:
    """One NVDEC parser and decoder on a card (``csrc/nvdec.cu``): feed
    Annex B access units, then read or skip each picture they let out, in
    display order."""

    def __init__(self, device: torch.device):
        self.device = device
        handle = ctypes.c_void_p()
        _check(_fn("nvdec_open")(device.index or 0, ctypes.addressof(handle)), None, "nvdec_open")
        self._h = handle.value

    def close(self) -> None:
        if self._h:
            _fn("nvdec_close")(self._h)
            self._h = None

    def feed(self, access_unit: Optional[bytes]) -> None:
        """Parse one access unit; None flushes (end of stream)."""
        if access_unit is None:
            rc = _fn("nvdec_feed")(self._h, None, 0, 1)
        else:
            rc = _fn("nvdec_feed")(self._h, access_unit, len(access_unit), 0)
        _check(rc, self._h, "cuvidParseVideoData")

    def pending(self) -> int:
        return _fn("nvdec_pending")(self._h)

    def map(self, stream: torch.cuda.Stream) -> Surface:
        """Map the next picture, ready on ``stream``."""
        info = (ctypes.c_longlong * 8)()
        _check(_fn("nvdec_map")(self._h, stream.cuda_stream, ctypes.addressof(info)), self._h,
               "cuvidMapVideoFrame64")
        return Surface(info, self.device)

    def unmap(self) -> None:
        """Unmap the mapped picture (its readers done: the caller has
        synchronised their stream) and drop it."""
        _check(_fn("nvdec_unmap")(self._h), self._h, "cuvidUnmapVideoFrame64")

    def skip(self) -> None:
        _check(_fn("nvdec_skip")(self._h), self._h, "nvdec_skip")


class NvdecVideo:
    """One decode session of an H.264 (``avc1``/``avc3``) MP4 file on the card
    ``device`` (default the card; resolved at the first decode, so probing
    needs none), with the interface of
    :class:`fvd_tpu_torch.providers.native_decode.NativeVideo`.  ``stats``
    sums host seconds spent feeding access units (``feed_s``: the parse and
    the decode's submission), waiting for mapped pictures (``wait_s``) and
    converting them (``rgb_s``), and the pictures shown (``frames``).
    ``opened`` is :func:`fvd_tpu_torch.utils.mp4.open_track`'s result for
    ``path`` where the caller has it."""

    def __init__(self, path: str, device=None, opened=None):
        self.path = path
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._session: Optional[NvdecSession] = None
        self._f, self._data, self.track = opened or mp4.open_track(path)
        try:
            if self.track.codec != "h264":
                raise UnsupportedVideo(f"{path}: MP4 video of codec {self.track.fourcc!r}, not H.264")
            if not self.track.sizes:
                raise UnsupportedVideo(f"{path}: MP4 video track without samples")
            self.config = h264.parse_avcc(self.track.config)
            sps = self.config.sps or [n for n in h264.split_length_prefixed(self._sample(0), self.config.length_size)
                                      if h264.nal_type(n) == h264.NAL_SPS]
            if not sps:
                raise UnsupportedVideo(f"{path}: H.264 track without a sequence parameter set")
            self.sps = h264.parse_sps(sps[0])
            h264.check_supported(self.sps, path)
        except BaseException:
            self.close()
            raise
        self.width, self.height = self.sps.width, self.sps.height
        self._sync = None if self.track.sync is None else set(self.track.sync)
        self._fed = 0          # samples fed to the decoder
        self._shown = 0        # display id of the next picture out
        self._ended = False    # the end-of-stream packet fed
        self.stats = {"feed_s": 0.0, "wait_s": 0.0, "rgb_s": 0.0, "frames": 0}

    @property
    def device(self) -> torch.device:
        if self._device is None:
            from fvd_tpu_torch import resolve_device

            dev = resolve_device(self._device_arg)
            if dev.type != "cuda":
                raise UnsupportedVideo(f"{self.path}: H.264 decodes on the card's NVDEC only; the port has no "
                                       f"H.264 decoder for {dev}")
            self._device = dev
        return self._device

    def close(self) -> None:
        if self._session is not None:
            self._session.close()
            self._session = None
        if self._f is not None:
            self._data.close()
            self._f.close()
            self._f = None

    def __enter__(self) -> "NvdecVideo":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _sample(self, i: int) -> bytes:
        off, size = self.track.offsets[i], self.track.sizes[i]
        return bytes(self._data[off:off + size])

    def probe(self) -> Tuple[float, int, int, int, float, bool]:
        """(fps, frame count, width, height, duration s, has audio): the
        duration is the movie header's, as the shim reads it."""
        t = self.track
        duration = t.movie_duration or (t.frame_count / t.fps if t.fps else 0.0)
        return t.fps, t.frame_count, self.width, self.height, duration, audio.has_audio(self._data, self.path)

    def probe_extra(self) -> Tuple[int, str]:
        """(rotation degrees [0, 360) from the ``tkhd`` matrix, codec name)."""
        return self.track.rotation, "h264"

    def extract_audio(self, target_sr: int, max_seconds: float = 7200.0) -> Optional[np.ndarray]:
        """The file's first audio track as mono float32 at ``target_sr``, at
        most ``max_seconds`` (:func:`fvd_tpu_torch.providers.audio.extract`,
        on the session's device argument: the audio needs no NVDEC); None
        without an audio track."""
        return audio.extract(self.path, self._data, target_sr, max_seconds, self._device_arg)

    def _feed(self) -> None:
        """Feed the next sample, or the end of the stream after the last."""
        if self._session is None:
            self._session = NvdecSession(self.device)
        t0 = time.perf_counter()
        i = self._fed
        if i < self.track.frame_count:
            sync = i == 0 or self._sync is None or i in self._sync
            self._session.feed(h264.annexb_access_unit(self._sample(i), self.config, sync))
            self._fed += 1
        else:
            self._session.feed(None)
            self._ended = True
        self.stats["feed_s"] += time.perf_counter() - t0

    def _convert(self, out: torch.Tensor) -> None:
        """The next picture into ``out`` (uint8 [H, W, 3] on the card)."""
        stream = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        surface = self._session.map(stream)
        t1 = time.perf_counter()
        try:
            ops.nv12_to_rgb(surface.luma, surface.uv, self.width, self.height, out=out)
            stream.synchronize()
        finally:
            self._session.unmap()
        self.stats["wait_s"] += t1 - t0
        self.stats["rgb_s"] += time.perf_counter() - t1

    def read_frames(self, frame_ids: Sequence[int]) -> Tuple[np.ndarray, List[int]]:
        """The frames ``frame_ids`` (sorted, without repeats; ids past the end
        or before the session's position dropped) -> (uint8 [T, H, W, 3] RGB,
        kept ids), in one forward pass over the stream across calls, the
        decoded pictures numbered in display order as the shim numbers them.
        Asking for an id past the end leaves the session at the end."""
        n = self.track.frame_count
        ids = {int(i) for i in frame_ids}
        wanted = sorted(i for i in ids if self._shown <= i < n)
        kept: List[int] = []
        if wanted:
            out = torch.empty((len(wanted), self.height, self.width, 3), dtype=torch.uint8, device=self.device)
            while len(kept) < len(wanted):
                if not (self._session and self._session.pending()):
                    if self._ended:
                        break
                    self._feed()
                    continue
                if self._shown == wanted[len(kept)]:
                    self._convert(out[len(kept)])
                    kept.append(self._shown)
                else:
                    self._session.skip()
                self._shown += 1
                self.stats["frames"] += 1
            frames = out[:len(kept)].cpu().numpy()
        else:
            frames = np.zeros((0, self.height, self.width, 3), np.uint8)
        if any(i >= n for i in ids):
            self._shown, self._ended = n, True
        return frames, kept
