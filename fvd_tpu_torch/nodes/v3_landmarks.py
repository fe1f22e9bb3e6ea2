"""V3: mouth-landmark time series with robust tracking: the port of
``fvd_tpu/nodes/v3_landmarks.py``.

Reference behavior (``nodes/V_nodes/v3_mouth_landmarks_timeseries.py``):
sample at 5 fps, 2D landmarks per frame, IoU-based single-face tracking with
largest-face (re)acquisition, OneEuroFilter smoothing (min_cutoff 0.5,
beta 0.1), mouth points 48..68 recorded per sampled frame, annotated
``landmarks_viz``, ``metadata.landmark_model``.

Frames stream in bounded chunks, gathered on the device from the tensor V1
uploaded; the landmark model runs one batched forward per chunk, and
smoothing is the chunk-resumable OneEuro loop of ``ops/filters.py`` with its
carried filter state, equal to one whole-track scan with memory bounded by
the chunk size; under the program coalescer concurrent videos' chunks run as
one loop (``nodes/_smooth.py``), bit-equal to each video's own.  The viz
(``landmarks_viz.avi``, PNG-in-AVI, where the JAX package writes an mp4) is
drawn with numpy masks and encoded on the artifact pool.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.nodes._tracking import (
    FaceTracker,
    TrackerConfig,
    landmark_box,
    track_chunk,
)
from fvd_tpu_torch.nodes._smooth import one_euro_scan_chunk_co
from fvd_tpu_torch.ops.filters import one_euro_init_carry
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.media import (
    IncrementalVideoWriter,
    StreamingSampler,
    VideoReader,
    content_key,
    device_frames_for,
    shared_landmarks,
)
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.runtime.io_pool import defer_artifact
from fvd_tpu_torch.runtime.tracer import get_tracer
from fvd_tpu_torch.state import State, StateDelta
from fvd_tpu_torch.utils import draw


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    cfg = config.landmarks
    output_dir = state.get("data_dir")
    if not output_dir or not os.path.exists(output_dir):
        print(f"V3: data directory not found at {output_dir}")
        return {}
    video_path = os.path.join(output_dir, "video.mp4")
    if not os.path.exists(video_path):
        print(f"V3: video file not found at {video_path}")
        return {}
    if providers.landmarks is None:
        print("V3: no landmark model configured; skipping.")
        return {}

    meta = VideoReader().probe(video_path)
    if meta is None:
        print("V3: cannot probe video.")
        return {}
    fps = meta.fps
    stride = max(1, int(round(fps / cfg.sample_fps))) if fps else 1
    sample_ids = list(range(0, meta.frame_count, stride))
    if not sample_ids:
        print("V3: no frames to sample.")
        return {}

    tracker = FaceTracker(
        TrackerConfig(
            frame_width=meta.width,
            frame_height=meta.height,
            min_face_frac=cfg.min_face_frac,
            iou_min=cfg.track_iou_min,
            aspect_gate=True,
            aspect_range=cfg.aspect_ratio_range,
        )
    )

    viz_fps = max(1.0, fps / stride) if fps else 1.0
    viz_path = os.path.join(output_dir, "landmarks_viz.avi")
    # content-scoped: a re-run over identical video bytes + identical drawn
    # landmarks serves the encoded viz from the artifact cache
    viz = IncrementalVideoWriter(viz_path, viz_fps,
                                 cache_scope=(content_key(video_path), "V3"))

    mouth_landmarks_data: List[Dict[str, Any]] = []
    carry = one_euro_init_carry((68, 2))
    n_pts = 68
    processed = 0

    tracer = get_tracer()
    try:
        chunks = iter(StreamingSampler(video_path, sample_ids,
                                       chunk_size=cfg.stream_chunk_frames))
        while True:
            with tracer.span("v3/decode"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            frames, kept_ids = chunk
            # ONE batched landmark forward per chunk, shared with V4; the
            # detector inside consumes the device-resident tensor V1 uploaded.
            with tracer.span("v3/landmark_fwd"):
                dev = (device_frames_for(video_path, kept_ids, frames,
                                         getattr(providers.landmarks, "device", None))
                       if getattr(providers.landmarks, "accepts_device_frames", False)
                       else None)
                # pose_pad makes the shared entry compute V4's poses in the
                # same program, so V4 reuses it; V3 drops the poses
                all_landmarks = shared_landmarks(video_path, kept_ids,
                                                 providers.landmarks, frames, dev,
                                                 pose_pad=cfg.pose_crop_pad_frac)

            T = len(kept_ids)
            with tracer.span("v3/track"):
                times, raw_track, valid, _ = track_chunk(
                    all_landmarks, kept_ids, fps, tracker,
                    n_pts=n_pts, dim=2, processed=processed,
                )

            # Chunk-resumable OneEuro smoothing (v3:204-209 semantics).
            with tracer.span("v3/smooth"):
                smoothed, carry = one_euro_scan_chunk_co(
                    carry, times, raw_track, valid,
                    min_cutoff=cfg.landmark_min_cutoff, beta=cfg.landmark_beta,
                )

            with tracer.span("v3/emit"):
                for i, fid in enumerate(kept_ids):
                    frame_landmarks: List[List[float]] = []
                    if valid[i]:
                        mouth_points = smoothed[i][48:68]
                        if len(mouth_points) >= 20:
                            frame_landmarks = mouth_points.tolist()
                    mouth_landmarks_data.append(
                        {"frame_id": int(fid), "timestamp": float(times[i]),
                         "landmarks": frame_landmarks}
                    )

            # Annotation + encode run on the artifact pool (io_pool):
            # the node thread goes straight to the next chunk's decode +
            # forward.  Inputs are chunk-local arrays never mutated again.
            def draw_chunk(frames=frames, valid=valid, smoothed=smoothed,
                           width=meta.width):
                batch = frames.copy()
                for i in range(len(batch)):
                    if not valid[i]:
                        continue
                    try:  # drawing failures never lose the frame (v3:129-134)
                        pts = smoothed[i]
                        x1, y1, x2, y2 = landmark_box(pts)
                        draw.rectangle(batch[i], (x1, y1), (x2, y2),
                                       max(2, width // 300), (0, 0, 255))
                        for (x, y) in pts[48:68]:
                            draw.fill_disc(batch[i], (int(x), int(y)),
                                           max(3, width // 200), (0, 255, 0))
                    except Exception:
                        pass
                return batch

            viz.append(
                draw_chunk,
                fingerprint=np.asarray(kept_ids, np.int64).tobytes()
                + np.asarray(valid, np.uint8).tobytes()
                + np.ascontiguousarray(smoothed).tobytes(),
            )
            processed += T
        # Success: the encode runs on the artifact pool, overlapped with
        # downstream nodes; the scheduler flushes it at end of run.
        defer_artifact(output_dir, viz.close_async())
    except BaseException:
        try:
            viz.close()
        except BaseException:
            pass
        raise
    if not viz.appended:
        viz_path = None
    # viz_path is advertised before the deferred encode lands; if that
    # encode fails, the scheduler's flush warns and the path may not
    # materialize — consumers must tolerate a missing viz file (the
    # reference has the same race with its video writer finalization)

    metadata = dict(state.get("metadata", {}) or {})
    metadata["landmark_model"] = f"{providers.landmarks.model_name}_smoothed"

    dump_node_debug(
        output_dir,
        "V3",
        {"frames": len(mouth_landmarks_data), "viz_path": viz_path},
    )
    return {
        "mouth_landmarks": mouth_landmarks_data,
        "mouth_landmarks_viz_path": viz_path,
        "metadata": metadata,
    }
