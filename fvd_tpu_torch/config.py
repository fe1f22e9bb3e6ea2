"""Centralized typed configuration: the port's copy of ``fvd_tpu/config.py``,
with the same tree, defaults and ``E2_MAX_WORKERS`` read.

The reference scatters its magic numbers across node bodies (thresholds
0.5/0.25/0.15, 5 fps sampling at ``v3_mouth_landmarks_timeseries.py:105``,
5 s windows at ``c1_lip_sync_score.py:120``, model names, env vars read via
dotenv).  Here every tunable lives in one frozen dataclass tree so runs are
reproducible and the values are discoverable/documentable.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class IngestConfig:
    """IN node (reference ``main.py:56-290``)."""

    processed_dir: str = "processed"
    videos_dir: str = "videos"
    download_retries: int = 3          # main.py:175
    retry_backoff_s: float = 5.0       # main.py:236 (retry_count * 5)
    transcode_codecs: Tuple[str, ...] = ("libx264",)  # NVENC has no TPU analog


@dataclass(frozen=True)
class AudioConfig:
    """A1/A3 front-end (reference ``a1:24-31``, ``a3:25-49``)."""

    target_sr: int = 16_000            # a1:26
    # Onset detection (librosa.onset.onset_detect equivalents, a3:25)
    n_fft: int = 2048
    hop_length: int = 512
    n_mels: int = 128
    fmax: Optional[float] = None
    # librosa peak-picking defaults expressed in seconds (converted at
    # runtime using sr/hop): pre_max=post_max=0.03, pre_avg=post_avg=0.1,
    # wait=0.03, delta=0.07
    peak_pre_max_s: float = 0.03
    peak_post_max_s: float = 0.00
    peak_pre_avg_s: float = 0.10
    peak_post_avg_s: float = 0.10
    peak_wait_s: float = 0.03
    peak_delta: float = 0.07


@dataclass(frozen=True)
class FaceDetectConfig:
    """V1 (reference ``v1_keyframes_facetrack.py``)."""

    input_size: int = 300              # v1:105 (300x300 SSD input)
    mean_bgr: Tuple[float, float, float] = (104.0, 177.0, 123.0)  # v1:106
    confidence_threshold: float = 0.5  # v1:121
    min_area_frac: float = 0.005       # v1:149 (0.5% of frame area)
    crop_pad_frac: float = 0.2         # v1:154-155
    sample_fps: float = 1.0            # v1:183 (1 keyframe per second)
    nms_iou_threshold: float = 0.45
    max_detections: int = 200


@dataclass(frozen=True)
class LandmarkConfig:
    """V3/V4 (reference ``v3:94-209``, ``v4:131-287``)."""

    sample_fps: float = 5.0            # v3:105, v4:146
    detector_threshold: float = 0.5    # v3:94
    track_iou_min: float = 0.15        # v3:179, v4:219
    min_face_frac: float = 0.05        # v3:152 (5% of frame dims)
    aspect_ratio_range: Tuple[float, float] = (0.3, 3.0)  # v3:157
    # OneEuroFilter parameters (v3:206, v4:255/281)
    landmark_min_cutoff: float = 0.5
    landmark_beta: float = 0.1
    pose_min_cutoff: float = 0.1
    pose_beta: float = 0.1
    pose_crop_pad_frac: float = 0.1    # v4:244-245
    crop_size: int = 256               # model input for landmark regression
    stream_chunk_frames: int = 512     # bounded-memory chunking for long videos


@dataclass(frozen=True)
class LipSyncConfig:
    """C1 (reference ``c1_lip_sync_score.py:107-185``)."""

    window_duration_s: float = 5.0     # c1:120
    max_lag_s: float = 0.5             # c1:131
    silence_std_threshold: float = 0.01  # c1:139
    sharpness_threshold: float = 1.5   # c1:172
    sharpness_penalty: float = 0.5     # c1:173
    top_fraction: float = 0.5          # c1:183
    epsilon: float = 1e-9              # c1:108


@dataclass(frozen=True)
class GestureConfig:
    """C2 (reference ``c2_gesture_narration_check.py:126-133``)."""

    consistent_threshold: float = 0.25
    inconsistent_threshold: float = 0.15
    segment_tolerance_s: float = 2.0   # c2:17-34


@dataclass(frozen=True)
class ForensicsConfig:
    """V5 (reference ``v5_texture_ela.py``)."""

    jpeg_quality: int = 90             # v5:67
    top_k_faces: int = 3               # v5:42


@dataclass(frozen=True)
class EvidenceConfig:
    """E1/E2/E3 (reference ``e1``, ``e2``, ``e3``)."""

    results_per_claim: int = 5         # e1:143
    rate_limit_s: float = 0.2          # e1:137
    max_workers: int = field(
        default_factory=lambda: max(1, int(os.getenv("E2_MAX_WORKERS", "4")))
    )                                   # e2:24
    base_score: float = 0.5            # e2:221
    gov_bonus: float = 0.4             # e2:226
    edu_bonus: float = 0.3             # e2:229
    high_trust_bonus: float = 0.3      # e2:234
    medium_trust_bonus: float = 0.1    # e2:237
    https_bonus: float = 0.1           # e2:242
    about_page_bonus: float = 0.1      # e2:249
    consensus_bonus: float = 0.1       # e2:258
    consensus_min_domains: int = 2     # e2:257 (strictly greater)
    about_page_timeout_s: float = 2.0  # e2:101
    enable_about_page_probe: bool = False  # network probe; off by default
    # E3 verdict bands (e3:9-18)
    verdict_highly_likely: float = 0.7
    verdict_likely: float = 0.4
    verdict_possible: float = 0.2


@dataclass(frozen=True)
class FusionConfig:
    """LR node (reference ``lr_node.py:120-192``)."""

    weights_path: str = "lr_weights.json"
    features_dir: str = "features"
    learning_rate: float = 0.005       # lr:183
    blink_rate_max: float = 60.0       # lr:122
    headpose_jerk_max: float = 100.0   # lr:125
    speech_rate_max: float = 5.0       # lr:128


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for scale-out (no reference analog; see SURVEY §2.3)."""

    data_axis: str = "data"            # videos / frame batches
    time_axis: str = "time"            # sequence axis (C1 halo exchange)
    data_parallel: int = 0             # 0 = use all devices on data axis
    time_parallel: int = 1


@dataclass(frozen=True)
class Config:
    ingest: IngestConfig = field(default_factory=IngestConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    face_detect: FaceDetectConfig = field(default_factory=FaceDetectConfig)
    landmarks: LandmarkConfig = field(default_factory=LandmarkConfig)
    lip_sync: LipSyncConfig = field(default_factory=LipSyncConfig)
    gesture: GestureConfig = field(default_factory=GestureConfig)
    forensics: ForensicsConfig = field(default_factory=ForensicsConfig)
    evidence: EvidenceConfig = field(default_factory=EvidenceConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    assets_dir: str = "assets"
    debug: bool = False

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def default_config() -> Config:
    return Config()
