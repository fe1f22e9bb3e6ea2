"""Progressive (streaming) analysis: a running fake-probability on a growing
prefix of a video.  The port of ``fvd_tpu/streaming.py``.

Frames stream through the same chunked decode and landmark-track machinery
the V3 and V4 nodes use (the shared frame caches, the shared ``track_chunk``
selector: V3's aspect-gated track for the mouth series, V4's gate-free
padded track and EAR smoothing for the blink series, and chunk-resumable
OneEuro carries).  After every chunk the accumulated tracks re-score through
the real C1 and LR feature functions on a prefix state, so each update's
``lip_sync`` / ``blink_rate`` / ``fake_probability`` is what the batch
pipeline's vision and audio features would report for the video cut at that
point (ASR, head-pose and web-evidence features join only in a full run).
C1 runs on the analyzer's device: on the card, one launch of
``csrc/lipsync_score.cu`` per update.

Use cases: early-exit moderation (stop paying for a video once the
probability settles), live dashboards, analyzing while a download is still
in flight.

    for update in ProgressiveAnalyzer(path, device="cuda").updates():
        print(update.t_end, update.fake_probability)

Smoothing goes through the program coalescer's wrappers of
``nodes/_smooth.py`` (``one_euro_scan_chunk_co``, ``v4_smooth_chunk_co``), as
V3 and V4 do: several analyses at once share one host loop per chunk, each
bit-equal to its own scan.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.nodes import c1_lipsync
from fvd_tpu_torch.nodes._tracking import FaceTracker, TrackerConfig, track_chunk
from fvd_tpu_torch.nodes.lr_fusion import build_features, load_weights
from fvd_tpu_torch.ops import fusion
from fvd_tpu_torch.nodes._smooth import one_euro_scan_chunk_co, v4_smooth_chunk_co
from fvd_tpu_torch.ops.filters import one_euro_init_carry
from fvd_tpu_torch.ops.spectral import interp_to_length, rms_envelope
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.media import (
    StreamingSampler,
    VideoReader,
    device_frames_for,
    extract_audio,
    shared_landmarks,
)
from fvd_tpu_torch.state import State
from fvd_tpu_torch.utils.wav import read_wav, to_mono


def _load_envelope(video_path: str, fps: float, duration: float, device=None) -> Optional[np.ndarray]:
    """Full-length RMS envelope of the video's audio at its own rate
    (``hop = int(sr/fps)``, ``frame = 2*hop``, interpolated to
    ``int(duration*fps)`` samples), computed once in float32 on ``device``
    and returned as float64 on the host; prefixes slice it.  The audio is a
    sibling ``.wav`` or what ``extract_audio`` finds; None when there is
    none or it does not read."""
    tmpdir = None
    wav = os.path.splitext(video_path)[0] + ".wav"
    try:
        if not os.path.exists(wav):
            tmpdir = tempfile.mkdtemp(prefix="fvd_stream_")
            wav = extract_audio(video_path, os.path.join(tmpdir, "audio.wav"))
            if wav is None:
                return None
        try:
            samples, sr = read_wav(wav)
        except Exception:
            return None
    finally:
        if tmpdir is not None:  # the extracted wav is dead once read
            shutil.rmtree(tmpdir, ignore_errors=True)
    y = torch.from_numpy(np.ascontiguousarray(to_mono(samples), np.float32)).to(resolve_device(device))
    hop = max(1, int(sr / fps))
    env = rms_envelope(y, frame_length=2 * hop, hop=hop)
    target = int(duration * fps)
    if target > 0:
        env = interp_to_length(env, target)
    return env.cpu().numpy().astype(np.float64)


@dataclass
class ProgressiveUpdate:
    """One re-scoring of the growing prefix."""

    chunk_index: int
    t_end: float               # seconds of video analyzed so far
    fraction: float            # t_end / duration
    mouth_samples: int         # landmark samples accumulated
    features: Dict[str, float]
    fake_probability: float


@dataclass
class ProgressiveAnalyzer:
    """Progressive analysis of ``video_path`` with C1 and the envelope on
    ``device`` (default the card; ``"cpu"`` runs C1's plain version)."""

    video_path: str
    config: Config = field(default_factory=default_config)
    providers: Optional[Providers] = None
    chunk_seconds: float = 5.0
    device: Any = None

    def updates(self) -> Iterator[ProgressiveUpdate]:
        dev = resolve_device(self.device)
        providers = self.providers or get_providers()
        cfg = self.config.landmarks
        if providers.landmarks is None:
            return
        meta = VideoReader().probe(self.video_path)
        if meta is None or not meta.fps:
            return
        fps = meta.fps
        duration = meta.duration
        stride = max(1, int(round(fps / cfg.sample_fps)))
        sample_ids = list(range(0, meta.frame_count, stride))
        if not sample_ids:
            return
        chunk_frames = max(1, int(round(self.chunk_seconds * cfg.sample_fps)))

        # Two trackers, as the batch pipeline runs them: V3's aspect-gated
        # track feeds the mouth landmarks and C1, V4's gate-free padded track
        # the blink (EAR) series.
        tracker_v3 = FaceTracker(
            TrackerConfig(
                frame_width=meta.width,
                frame_height=meta.height,
                min_face_frac=cfg.min_face_frac,
                iou_min=cfg.track_iou_min,
                aspect_gate=True,
                aspect_range=cfg.aspect_ratio_range,
            )
        )
        tracker_v4 = FaceTracker(
            TrackerConfig(
                frame_width=meta.width,
                frame_height=meta.height,
                min_face_frac=cfg.min_face_frac,
                iou_min=cfg.track_iou_min,
                aspect_gate=False,
                pad_frac=cfg.pose_crop_pad_frac,
            )
        )
        carry = one_euro_init_carry((68, 2))
        lm4_carry = one_euro_init_carry((68, 3))
        pose_carry = one_euro_init_carry((3,))
        envelope = _load_envelope(self.video_path, fps, duration, dev)
        weights = load_weights(self.config.fusion.weights_path)
        lm_device = getattr(providers.landmarks, "device", None) or dev

        mouth_landmarks: List[Dict[str, Any]] = []
        blink_data: List[Dict[str, Any]] = []
        any_face = False
        chunk_index = 0
        processed = 0

        for frames, kept_ids in StreamingSampler(self.video_path, sample_ids, chunk_size=chunk_frames):
            T = len(kept_ids)
            frames_dev = (device_frames_for(self.video_path, kept_ids, frames, device=lm_device)
                          if getattr(providers.landmarks, "accepts_device_frames", False)
                          else None)
            # no pose_pad: --stream has no V4 pose consumer, so the fused
            # landmark+pose program would compute poses nobody reads
            all_landmarks = shared_landmarks(self.video_path, kept_ids, providers.landmarks, frames,
                                             frames_dev)

            # V3's mouth track (feeds C1)
            times, raw, valid, _ = track_chunk(
                all_landmarks, kept_ids, fps, tracker_v3, n_pts=68, dim=2, processed=processed,
            )
            smoothed, carry = one_euro_scan_chunk_co(
                carry, times, raw, valid, min_cutoff=cfg.landmark_min_cutoff, beta=cfg.landmark_beta,
            )

            # V4's blink track: EAR through V4's smoothing stage, pose
            # inputs zero (pose joins in full runs)
            _, raw4, valid4, _ = track_chunk(
                all_landmarks, kept_ids, fps, tracker_v4, n_pts=68, dim=3, processed=processed,
            )
            _, smoothed_ears, _, lm4_carry, pose_carry = v4_smooth_chunk_co(
                lm4_carry, pose_carry, times, raw4, valid4, np.zeros((T, 3)), np.zeros(T, bool),
                lm_min_cutoff=cfg.landmark_min_cutoff, lm_beta=cfg.landmark_beta,
                pose_min_cutoff=cfg.pose_min_cutoff, pose_beta=cfg.pose_beta,
            )

            for i, fid in enumerate(kept_ids):
                pts: List[List[float]] = []
                if valid[i]:
                    any_face = True
                    pts = smoothed[i][48:68].tolist()
                if valid4[i]:
                    blink_data.append({"frame_id": int(fid), "timestamp": float(times[i]),
                                       "ear": float(smoothed_ears[i])})
                mouth_landmarks.append({"frame_id": int(fid), "timestamp": float(times[i]),
                                        "landmarks": pts})
            processed += T

            t_end = float(times[-1]) + 1.0 / cfg.sample_fps if T else 0.0
            t_end = min(t_end, duration)
            yield self._score_prefix(chunk_index, t_end, duration, fps, mouth_landmarks, blink_data,
                                     envelope, any_face, weights, dev)
            chunk_index += 1

    def _score_prefix(self, chunk_index, t_end, duration, fps, mouth_landmarks, blink_data, envelope,
                      any_face, weights, dev) -> ProgressiveUpdate:
        """Re-score the prefix through the real C1 node and LR features."""
        prefix_env = None  # no key -> C1's no-audio path (score 0.0)
        if envelope is not None:
            prefix_env = envelope[: int(t_end * fps)]  # an ndarray; C1 takes one
        state = State(
            face_detections=[{"frame_id": 0, "faces": [{"confidence": 1.0}]}] if any_face else [],
            mouth_landmarks=list(mouth_landmarks),
            blink_data=list(blink_data),
            head_pose_data=[],  # pose joins in full-pipeline runs
            audio_envelope=prefix_env,
            metadata={"fps": fps, "duration": t_end},
        )
        state = state.apply(c1_lipsync.run(state, self.config, device=dev))
        features = build_features(state, self.config)
        return ProgressiveUpdate(
            chunk_index=chunk_index,
            t_end=t_end,
            fraction=t_end / duration if duration else 1.0,
            mouth_samples=len(mouth_landmarks),
            features=features,
            fake_probability=fusion.predict_host(features, weights),
        )


def analyze_progressive(video_path: str, config: Optional[Config] = None,
                        providers: Optional[Providers] = None, chunk_seconds: float = 5.0,
                        device=None) -> Iterator[ProgressiveUpdate]:
    """Yield a :class:`ProgressiveUpdate` per chunk, C1 on ``device``
    (default the card)."""
    return ProgressiveAnalyzer(video_path, config=config or default_config(), providers=providers,
                               chunk_seconds=chunk_seconds, device=device).updates()
