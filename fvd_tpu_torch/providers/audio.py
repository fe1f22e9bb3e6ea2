"""The audio track of an MP4, decoded by the port: the counterpart of the JAX
package's ``fvd_extract_audio`` (``native/decode_shim.cc``: libavcodec's
decoder, then libswresample to mono float at ``target_sr``).  The audio
track does not depend on the video codec, so :class:`NativeVideo` (``mp4v``)
and :class:`NvdecVideo` (H.264) both read it here.

AAC-LC only: the host parses the access units
(``fvd_tpu_torch/utils/aac.py``), then ``aac_synth`` turns the spectra into
PCM and ``audio_resample`` mixes it to mono at ``target_sr``
(``fvd_tpu_torch/ops/aac.py``), on the card unless the caller passes
``device="cpu"``.  Another codec or AAC profile raises
:class:`UnsupportedVideo` naming it; a kernel's failure raises
``RuntimeError`` and nothing falls back.
"""

from __future__ import annotations

import mmap
from typing import Optional

import numpy as np
import torch

from fvd_tpu_torch.ops import aac as ops
from fvd_tpu_torch.utils import aac, mp4
from fvd_tpu_torch.utils.avi import UnsupportedVideo


def _config(path: str, track: mp4.AudioTrack) -> aac.AudioConfig:
    if track.fourcc != "mp4a" or track.object_type != 0x40:
        raise UnsupportedVideo(f"{path}: MP4 audio of codec {track.fourcc!r} (object type "
                               f"0x{track.object_type:02x}); the port decodes AAC-LC only")
    return aac.parse_asc(track.config)


def has_audio(data, path: str = "") -> bool:
    """Whether the file's first audio track is one the port decodes (the
    shim's rule: an audio track whose codec opens)."""
    try:
        track = mp4.audio_track(path, data)
        if track is None:
            return False
        _config(path, track)
        return True
    except UnsupportedVideo:
        return False


def units_needed(frames: int, first: int, in_rate: int, target_sr: int, max_seconds: float) -> int:
    """How many access units, of ``frames``, give the first ``max_seconds``
    at ``target_sr`` exactly as the whole track does: a frame's 1024 output
    samples depend on no later frame, and swr's output ``k`` reads input up
    to its filter's end, so the rest are never parsed."""
    n_out = int(target_sr * max_seconds)
    if n_out <= 0:
        return min(frames, 1)
    if in_rate == target_sr:
        need = n_out
    else:
        rs = ops.resampler(in_rate, target_sr)
        need = ((n_out - 1) * rs.step) // rs.phases - rs.center + rs.length
    return min(frames, -(-(first + need) // 1024))


def extract(path: str, data, target_sr: int, max_seconds: float = 7200.0, device=None) -> Optional[np.ndarray]:
    """The first audio track of the MP4 whose bytes are ``data`` as mono
    float32 at ``target_sr``, at most ``max_seconds`` (only the access
    units those need are parsed); None without an audio track."""
    from fvd_tpu_torch import resolve_device

    track = mp4.audio_track(path, data)
    if track is None:
        return None
    cfg = _config(path, track)
    dev = resolve_device(device)
    frames = len(track.sizes)
    first, _ = ops.output_range(frames, track.sample_deltas, track.media_time, track.edit_duration)
    frames = units_needed(frames, first, cfg.sample_rate, target_sr, max_seconds)
    spectra = aac.decode(cfg, [bytes(data[o:o + s]) for o, s in zip(track.offsets[:frames], track.sizes[:frames])])
    meta = np.stack([spectra.sequence, spectra.shape, spectra.prev_sequence, spectra.prev_shape])
    coef = torch.from_numpy(spectra.coef).to(dev)
    pcm = ops.imdct_synth(coef, torch.from_numpy(meta).to(dev))
    first, end = ops.output_range(frames, track.sample_deltas, track.media_time, track.edit_duration)
    mono = ops.resample(pcm[:, first:end], cfg.sample_rate, target_sr)
    return mono[:int(target_sr * max_seconds)].cpu().numpy()


def extract_file(path: str, target_sr: int, max_seconds: float = 7200.0, device=None) -> Optional[np.ndarray]:
    """:func:`extract` on the file at ``path``, read through ``mmap``, its
    video track never opened; None for a file that is no MP4 or has no
    audio track."""
    with open(path, "rb") as f:
        if not mp4.is_mp4(f.read(12)):
            return None
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
            return extract(path, data, target_sr, max_seconds, device)
