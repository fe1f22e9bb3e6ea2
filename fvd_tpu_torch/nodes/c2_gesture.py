"""C2: gesture-narration consistency check: the port of
``fvd_tpu/nodes/c2_gesture.py``.

Reference behavior (``nodes/C_nodes/c2_gesture_narration_check.py:36-201``):
per keyframe, parse the frame id from the filename, convert to a timestamp
via video_fps, fuzzy-match the nearest transcript segment within ±2 s, score
CLIP image-text cosine; thresholds: > 0.25 Consistent, < 0.15 Inconsistent,
otherwise an LLM vision fallback with JSON ``{consistent, reason}`` (kept
'Ambiguous' when that fails / is unavailable).  The keyframe goes to the
vision LLM as the JPEG bytes OpenCV gives the JAX package (``utils/jpeg.py``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.media import cached_keyframe_images
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta
from fvd_tpu_torch.utils.jpeg import encode_jpeg


def find_closest_segment(timestamp: float, segments: List[dict], tolerance: float = 2.0) -> Optional[dict]:
    """Nearest segment within tolerance; strict overlap wins (c2:17-34)."""
    best, min_dist = None, float("inf")
    for seg in segments:
        start, end = seg["start"], seg["end"]
        if start <= timestamp <= end:
            return seg
        dist = min(abs(timestamp - start), abs(timestamp - end))
        if dist < min_dist and dist <= tolerance:
            min_dist = dist
            best = seg
    return best


def parse_frame_id(path: str) -> int:
    """First numeric token in the basename, -1 if none (c2:80-99)."""
    basename = os.path.basename(path)
    for part in basename.replace(".", "_").split("_"):
        if part.isdigit():
            return int(part)
    return -1


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    cfg = config.gesture
    keyframes = state.get("keyframes", []) or []
    segments = state.get("segments", []) or []
    if not keyframes:
        print("C2: no keyframes found; skipping gesture check.")
        return {}
    if providers.clip is None:
        # reference behavior when the CLIP model fails to load (c2:56-58):
        # the node bails and leaves state unchanged
        print("C2: no CLIP model available; skipping gesture check.")
        return {}

    fps = (state.get("metadata", {}) or {}).get("video_fps", 30.0)
    gesture_checks: List[Dict[str, Any]] = []

    # Gather every (keyframe, matched segment) pair first, then score the
    # whole set in ONE device program; only the genuinely ambiguous band
    # escalates to the per-frame LLM fallback (c2:126-171 semantics).
    candidates: List[tuple] = []  # (frame_id, timestamp, text, image)
    images = cached_keyframe_images(keyframes)
    for kf_path, image in zip(keyframes, images):
        frame_id = parse_frame_id(kf_path)
        if frame_id == -1:
            continue
        timestamp = frame_id / fps
        matched = find_closest_segment(timestamp, segments, cfg.segment_tolerance_s)
        if not matched:
            continue
        if image is None:
            continue
        candidates.append((frame_id, timestamp, matched["text"], image))

    scores: List[Optional[float]] = []
    batch_fn = getattr(providers.clip, "image_text_similarity_batch", None)
    if batch_fn is not None and candidates:
        try:
            scores = [float(s) for s in batch_fn(
                [c[3] for c in candidates], [c[2] for c in candidates])]
        except Exception:
            scores = []
    if len(scores) != len(candidates):
        scores = []
        for (_, _, text, image) in candidates:
            try:
                scores.append(float(providers.clip.image_text_similarity(image, text)))
            except Exception:
                scores.append(None)

    for (frame_id, timestamp, text, image), score in zip(candidates, scores):
        if score is None:
            continue

        status = "Uncertain"
        reason = f"CLIP Score: {score:.2f}"
        source = "clip_local"

        if score > cfg.consistent_threshold:
            status = "Consistent"
        elif score < cfg.inconsistent_threshold:
            status = "Inconsistent"
        elif providers.llm.available:
            result = providers.llm.vision_json(
                "",
                f"Does the image support this narration: '{text}'? Return "
                "JSON with 'consistent' (bool) and 'reason'.",
                [encode_jpeg(np.asarray(image, np.uint8))],
            )
            if result is not None:
                status = "Consistent" if result.get("consistent") else "Inconsistent"
                reason = f"LLM Fallback: {result.get('reason')}"
                source = "llm_fallback"
            else:
                status = "Ambiguous"
        else:
            status = "Ambiguous (No API Key)"

        gesture_checks.append(
            {
                "timestamp": timestamp,
                "frame_id": frame_id,
                "text": text,
                "status": status,
                "score": score,
                "reason": reason,
                "source": source,
            }
        )

    dump_node_debug(
        state.get("data_dir"),
        "C2",
        {
            "checked": len(gesture_checks),
            "matched": sum(1 for g in gesture_checks if g["status"] == "Consistent"),
            "inconsistent": sum(1 for g in gesture_checks if g["status"] == "Inconsistent"),
        },
    )
    return {"gesture_check": gesture_checks}
