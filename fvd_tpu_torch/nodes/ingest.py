"""IN: ingest — copy the video, extract audio, probe metadata: the port of
``fvd_tpu/nodes/ingest.py``.

Reference behavior (``main.py:56-290``): create ``processed/video_<ts>/``,
copy the local video to ``video.mp4`` (whatever its container), extract
``audio.wav``, record metadata ``{duration, fps, size, rotation}``.

The port reads raw-RGBA AVI, ``mp4v`` MP4 and H.264 MP4 (``avc1``, ``avc3``:
8-bit 4:2:0 progressive limited-range, on the card's NVDEC)
(``fvd_tpu_torch/providers/media.py``): a video in another container or codec
fails here with an error that names it, where the JAX package would transcode
it to H.264 with ffmpeg.  Audio comes from an MP4's AAC-LC track (decoded by
the port, its kernels on ``device``, default the card), else from ffmpeg
where a binary exists, else from the sibling ``.wav``.  The URL branch
(yt-dlp download with retries) is not ported yet: a URL raises.
"""

from __future__ import annotations

import datetime
import os
import shutil

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import native_decode
from fvd_tpu_torch.providers.media import VideoReader, extract_audio, is_mp4
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def probe_codec_rotation(video_path: str) -> tuple:
    """(codec_name, rotation_degrees) of an MP4, as the JAX package's shim
    reports them (``avcodec_get_name``, and the ``tkhd`` display matrix's
    rotation): ``("mpeg4", r)`` for an ``mp4v`` file, ``("h264", r)`` for an
    ``avc1`` or ``avc3`` one; ``("", 0)`` for anything else."""
    try:
        if not is_mp4(video_path):
            return "", 0
        with native_decode.open_video(video_path) as nv:
            rotation, codec = nv.probe_extra()
        return codec, rotation
    except (OSError, ValueError):
        return "", 0


def _make_run_dir(processed_dir: str) -> str:
    """``processed_dir/video_<timestamp>``; two videos ingested within the same
    microsecond (concurrent ``invoke`` calls) get ``_1``, ``_2``... suffixes
    instead of sharing one directory."""
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S_%f")
    base = os.path.join(processed_dir, f"video_{timestamp}")
    os.makedirs(processed_dir, exist_ok=True)
    path, n = base, 0
    while True:
        try:
            os.mkdir(path)
            return path
        except FileExistsError:
            n += 1
            path = f"{base}_{n}"


def run(state: State, config: Config = default_config(), device=None) -> StateDelta:
    cfg = config.ingest
    input_path = state.get("input_path", "")
    debug = state.get("debug", False)

    if input_path.startswith(("http://", "https://")):
        raise NotImplementedError(
            "IN: URL ingest is not ported to fvd_tpu_torch yet (ROADMAP.md §1); "
            "download the video and pass a local raw-RGBA AVI file")
    if not os.path.exists(input_path):
        raise FileNotFoundError(f"Input file not found: {input_path}")

    output_dir = _make_run_dir(cfg.processed_dir)
    video_path = os.path.join(output_dir, "video.mp4")
    shutil.copy2(input_path, video_path)
    # keep a sibling wav reachable for the no-ffmpeg audio path
    src_wav = os.path.splitext(input_path)[0] + ".wav"
    if os.path.exists(src_wav):
        shutil.copy2(src_wav, os.path.splitext(video_path)[0] + ".wav")
    metadata: dict = {"original_path": input_path}

    # Audio extraction (reference main.py:262-283).
    audio_path = os.path.join(output_dir, "audio.wav")
    extracted = extract_audio(video_path, audio_path, device=device)
    if extracted is None:
        print("IN: warning - no audio track available for this video.")

    # Metadata probe; raises UnsupportedVideo, naming the container, for a
    # file the port cannot read.
    meta = VideoReader().probe(video_path)
    codec, rotation = probe_codec_rotation(video_path)
    if meta is not None:
        metadata.update(
            {
                "duration": meta.duration,
                "fps": meta.fps,
                "size": [meta.width, meta.height],
                "rotation": rotation,
            }
        )
        if codec:
            metadata["codec"] = codec

    dump_node_debug(output_dir, "IN", {"video": video_path, "audio": extracted or "none"})
    return {"data_dir": output_dir, "metadata": metadata, "debug": debug}
