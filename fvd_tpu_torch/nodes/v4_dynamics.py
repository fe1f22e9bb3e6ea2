"""V4: blink (EAR) + head-pose dynamics: the port of
``fvd_tpu/nodes/v4_dynamics.py``.

Reference behavior (``nodes/V_nodes/v4_blink_headpose_dynamics.py``): 5 fps
sampling, landmarks, IoU tracking with a 10%-padded active box, EAR from eye
landmarks 36..48 on OneEuro-smoothed landmarks (min_cutoff 0.5, beta 0.1),
SixDRepNet pose on the padded crop smoothed with a *stronger* OneEuro
(min_cutoff 0.1, beta 0.1), ``headpose_viz``, metadata blink/pose model
names.

Frames stream in bounded chunks gathered on the device from the tensor V1
uploaded.  The landmark forward is V3's: one shared program per chunk that
also gives every detection's pose on its padded crop box, so V4 runs no
forward of its own.  The smoothing stage (two OneEuro scans + EAR) is the
chunk-resumable host float32 loop of ``ops/filters.py``; under the program
coalescer concurrent videos' chunks share one loop (``nodes/_smooth.py``).
The viz
(``headpose_viz.avi``, PNG-in-AVI, where the JAX package writes an mp4) is
drawn with numpy and encoded on the artifact pool.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.nodes._tracking import FaceTracker, TrackerConfig, track_chunk
from fvd_tpu_torch.nodes._smooth import v4_smooth_chunk_co
from fvd_tpu_torch.ops.filters import one_euro_init_carry
from fvd_tpu_torch.ops.image import resize
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.media import (
    IncrementalVideoWriter,
    StreamingSampler,
    VideoReader,
    content_key,
    device_frames_for,
    shared_landmarks_pose,
)
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.runtime.io_pool import defer_artifact
from fvd_tpu_torch.runtime.tracer import get_tracer
from fvd_tpu_torch.state import State, StateDelta
from fvd_tpu_torch.utils import draw


def _resize_crop(crop: np.ndarray, size: int) -> np.ndarray:
    """uint8 crop -> uint8 [size, size, 3], linear (``cv2.resize`` in the JAX
    package), for a provider that takes host crops."""
    x = torch.from_numpy(np.ascontiguousarray(crop))[None].to(torch.float32)
    out = resize(x, (size, size), antialias=False)[0]
    return np.clip(np.rint(out.numpy()), 0, 255).astype(np.uint8)


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    cfg = config.landmarks
    output_dir = state.get("data_dir")
    if not output_dir or not os.path.exists(output_dir):
        print(f"V4: data directory not found at {output_dir}")
        return {}
    video_path = os.path.join(output_dir, "video.mp4")
    if not os.path.exists(video_path):
        print(f"V4: video file not found at {video_path}")
        return {}
    if providers.landmarks is None:
        print("V4: no landmark model configured; skipping.")
        return {}

    meta = VideoReader().probe(video_path)
    if meta is None:
        print("V4: cannot probe video.")
        return {}
    fps = meta.fps
    stride = max(1, int(round(fps / cfg.sample_fps))) if fps else 1
    sample_ids = list(range(0, meta.frame_count, stride))
    if not sample_ids:
        print("V4: no frames to sample.")
        return {}

    # Tracking: V4 keeps a 10%-padded active box and has no aspect gate
    # (v4:182-251).
    tracker = FaceTracker(
        TrackerConfig(
            frame_width=meta.width,
            frame_height=meta.height,
            min_face_frac=cfg.min_face_frac,
            iou_min=cfg.track_iou_min,
            aspect_gate=False,
            pad_frac=cfg.pose_crop_pad_frac,
        )
    )

    viz_fps = max(1.0, fps / stride) if fps else 1.0
    viz_path = os.path.join(output_dir, "headpose_viz.avi")
    # content-scoped encode cache: see the matching note in v3_landmarks.py
    viz = IncrementalVideoWriter(viz_path, viz_fps,
                                 cache_scope=(content_key(video_path), "V4"))

    n_pts, dim = 68, 3
    lm_carry = one_euro_init_carry((n_pts, dim))
    pose_carry = one_euro_init_carry((3,))
    blink_data: List[Dict[str, Any]] = []
    head_pose_data: List[Dict[str, Any]] = []
    processed = 0

    tracer = get_tracer()
    try:
        chunks = iter(StreamingSampler(video_path, sample_ids,
                                       chunk_size=cfg.stream_chunk_frames))
        while True:
            with tracer.span("v4/decode"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            frames, kept_ids = chunk
            # Shared with V3's identical forward over the same sampled
            # frames; the fused program also gives per-detection poses on
            # crop boxes derived on the device.
            with tracer.span("v4/landmark_fwd"):
                dev = (device_frames_for(video_path, kept_ids, frames,
                                         getattr(providers.landmarks, "device", None))
                       if getattr(providers.landmarks, "accepts_device_frames", False)
                       else None)
                all_landmarks, fused_poses = shared_landmarks_pose(
                    video_path, kept_ids, providers.landmarks, frames, dev,
                    pose_pad=cfg.pose_crop_pad_frac)

            T = len(kept_ids)
            with tracer.span("v4/track"):
                times, raw_track, valid, crop_boxes, sel = track_chunk(
                    all_landmarks, kept_ids, fps, tracker,
                    n_pts=n_pts, dim=dim, collect_boxes=True,  # boxes pre-padded
                    collect_sel=True, processed=processed,
                )

            # Pose: the fused rows where present, else ONE batched forward per
            # chunk (v4:267-287), cropped on the device where the provider
            # takes the frame tensor.
            raw_pose = np.zeros((T, 3), np.float64)
            pose_valid = np.zeros(T, bool)
            pose_boxes_fn = (getattr(providers.landmarks, "pose_boxes_batch", None)
                             if dev is not None else None)
            with tracer.span("v4/pose_fwd"):
                boxes, crops, usable = [], [], []
                poses: Any = []
                for i in range(T):
                    if valid[i] and crop_boxes[i] is not None:
                        x1, y1, x2, y2 = crop_boxes[i]
                        if x2 <= x1 or y2 <= y1:
                            continue
                        if fused_poses is not None and sel[i] >= 0:
                            raw_pose[i] = fused_poses[i][sel[i]]
                            pose_valid[i] = True
                        elif pose_boxes_fn is not None:
                            boxes.append((x1, y1, x2, y2))
                            usable.append(i)
                        else:
                            crop = frames[i][y1:y2, x1:x2]
                            if crop.size > 0:
                                crops.append(_resize_crop(crop, cfg.crop_size))
                                usable.append(i)
                if pose_boxes_fn is not None and boxes:
                    poses = np.asarray(pose_boxes_fn(dev, boxes, usable))
                elif crops:
                    poses = np.asarray(providers.landmarks.pose_batch(np.stack(crops)))
            for i, p in zip(usable, poses):
                raw_pose[i] = p  # (pitch, yaw, roll)
                pose_valid[i] = True

            # Both smoothing scans + EAR, chunk-resumable.
            with tracer.span("v4/smooth"):
                _, smoothed_ears, smoothed_pose, lm_carry, pose_carry = v4_smooth_chunk_co(
                    lm_carry, pose_carry, times, raw_track, valid, raw_pose, pose_valid,
                    lm_min_cutoff=cfg.landmark_min_cutoff, lm_beta=cfg.landmark_beta,
                    pose_min_cutoff=cfg.pose_min_cutoff, pose_beta=cfg.pose_beta,
                )

            with tracer.span("v4/emit"):
                for i, fid in enumerate(kept_ids):
                    if valid[i]:
                        blink_data.append(
                            {"frame_id": int(fid), "timestamp": float(times[i]),
                             "ear": float(smoothed_ears[i])}
                        )
                    if pose_valid[i]:
                        pitch, yaw, roll = smoothed_pose[i]
                        head_pose_data.append(
                            {
                                "frame_id": int(fid),
                                "timestamp": float(times[i]),
                                "pose": {"pitch": float(pitch), "yaw": float(yaw),
                                         "roll": float(roll)},
                            }
                        )

            # Annotation + encode on the artifact pool (see V3).
            def draw_chunk(frames=frames, valid=valid, ears=smoothed_ears,
                           boxes=list(crop_boxes)):
                batch = frames.copy()
                for i in range(len(batch)):
                    if not valid[i]:
                        continue
                    try:  # drawing failures never lose the frame
                        if boxes[i]:
                            x1, y1, x2, y2 = boxes[i]
                            draw.rectangle(batch[i], (x1, y1), (x2, y2), 1, (255, 255, 0))
                        draw.put_text(batch[i], f"EAR: {float(ears[i]):.2f}", (10, 30), 2,
                                      (255, 0, 0))
                    except Exception:
                        pass
                return batch

            boxes_fp = np.asarray(
                [b if b else (-1, -1, -1, -1) for b in crop_boxes], np.int64
            )
            viz.append(
                draw_chunk,
                fingerprint=np.asarray(kept_ids, np.int64).tobytes()
                + np.asarray(valid, np.uint8).tobytes()
                + boxes_fp.tobytes()
                + np.ascontiguousarray(smoothed_ears).tobytes(),
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
    # as in V3, the viz path is advertised before the deferred encode lands

    metadata = dict(state.get("metadata", {}) or {})
    metadata["blink_model"] = "EAR_smoothed"
    metadata["pose_model"] = f"{providers.landmarks.model_name}_pose_smoothed"

    dump_node_debug(
        output_dir,
        "V4",
        {
            "blink_samples": len(blink_data),
            "pose_samples": len(head_pose_data),
            "viz_path": viz_path,
        },
    )
    return {
        "blink_data": blink_data,
        "head_pose_data": head_pose_data,
        "headpose_viz_path": viz_path,
        "metadata": metadata,
    }
