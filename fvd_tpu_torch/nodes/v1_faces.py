"""V1: keyframe extraction + face detection: the port of
``fvd_tpu/nodes/v1_faces.py``.

Reference behavior (``nodes/V_nodes/v1_keyframes_facetrack.py:6-217``): one
frame per second (frame_id = int(t*fps)); OpenCV-DNN SSD forward per frame;
keep detections with confidence >= 0.5, clip to frame, drop non-positive
boxes, sort by area desc, drop faces under 0.5% of frame area; largest is
``is_main``; save keyframes and 20%-padded face crops; emit ``keyframes``,
``face_detections`` and metadata (video_fps, total_frames,
face_detection_model).

Frames for ALL keyframes are read once into a single ``uint8[T, H, W, 3]``
batch and the detector runs as ONE batched forward on the device
(``providers/vision.py`` FaceDetectorProvider).  V1 uploads the union of its
1 fps grid and V3's 5 fps grid once; V3 gathers its frames from that tensor
on the device.  Keyframes and crops are written as PNG (``frame_<id>.png``,
``face_<id>_<i>.png``) where the JAX package writes JPEG.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.media import (StreamingSampler, VideoReader, content_key,
                                           device_frames_for)
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.runtime.io_pool import ArtifactWriter
from fvd_tpu_torch.state import State, StateDelta


def _process_chunk(frames, kept_ids, detections_per_frame, meta, cfg,
                   frame_area, keyframes_dir, faces_dir,
                   keyframes_paths, face_detections, writer,
                   ck=None) -> None:
    """Per-frame filtering/cropping/artifacts (v1:110-180 semantics).

    PNG encodes go through the background ArtifactWriter so they overlap
    the next chunk's decode + detector dispatch; the caller drains it before
    returning the node delta.
    """
    for frame, fid, dets in zip(frames, kept_ids, detections_per_frame):
        timestamp = fid / meta.fps
        keyframe_path = os.path.join(keyframes_dir, f"frame_{fid:06d}.png")
        # content-addressed encode identity: a re-run over identical video
        # bytes writes the cached PNG instead of re-encoding
        writer.save_png(keyframe_path, frame, key=(ck, "kf", fid) if ck else None)
        keyframes_paths.append(keyframe_path)

        # Filter + clip (v1:118-141).
        face_list = []
        for d in dets:
            if d.confidence < cfg.confidence_threshold:
                continue
            x1 = max(0, int(d.x1))
            y1 = max(0, int(d.y1))
            x2 = min(meta.width, int(d.x2))
            y2 = min(meta.height, int(d.y2))
            w, h = x2 - x1, y2 - y1
            if w <= 0 or h <= 0:
                continue
            face_list.append(
                {"x": x1, "y": y1, "w": w, "h": h, "area": w * h,
                 "confidence": float(d.confidence)}
            )
        face_list.sort(key=lambda f: f["area"], reverse=True)

        detections_in_frame = []
        for i, face in enumerate(face_list):
            if face["area"] < frame_area * cfg.min_area_frac:
                continue
            x, y, w, h = face["x"], face["y"], face["w"], face["h"]
            pad_w = int(w * cfg.crop_pad_frac)
            pad_h = int(h * cfg.crop_pad_frac)
            cx1 = max(0, x - pad_w)
            cy1 = max(0, y - pad_h)
            cx2 = min(meta.width, x + w + pad_w)
            cy2 = min(meta.height, y + h + pad_h)
            crop = frame[cy1:cy2, cx1:cx2]
            face_path = os.path.join(faces_dir, f"face_{fid:06d}_{i}.png")
            writer.save_png(
                face_path, crop,
                key=(ck, "crop", fid, i, cx1, cy1, cx2, cy2) if ck else None)
            detections_in_frame.append(
                {
                    "bbox": {"x": x, "y": y, "w": w, "h": h},
                    "confidence": face["confidence"],
                    "is_main": i == 0,
                    "crop_path": face_path,
                    "crop": crop,  # in-memory fast path for V5 (no re-read)
                }
            )

        face_detections.append(
            {
                "frame_id": fid,
                "timestamp": timestamp,
                "faces": detections_in_frame,
                "keyframe_path": keyframe_path,
            }
        )


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
    device=None,
) -> StateDelta:
    """``device``: where an ``mp4v`` video decodes (default the card)."""
    providers = providers or get_providers()
    cfg = config.face_detect
    output_dir = state.get("data_dir")
    if not output_dir or not os.path.exists(output_dir):
        print(f"V1: data directory not found at {output_dir}")
        return {}

    video_path = os.path.join(output_dir, "video.mp4")
    reader = VideoReader()
    meta = reader.probe(video_path)
    if meta is None:
        print(f"V1: cannot open video at {video_path}")
        return {}

    keyframes_dir = os.path.join(output_dir, "keyframes")
    faces_dir = os.path.join(output_dir, "faces")
    os.makedirs(keyframes_dir, exist_ok=True)
    os.makedirs(faces_dir, exist_ok=True)

    # 1 frame/sec grid: frame_id = int(t * fps), t = 0, 1, 2, ... (v1:90-183)
    frame_ids: List[int] = []
    t = 0.0
    while True:
        fid = int(t * meta.fps)
        if fid >= meta.frame_count:
            break
        frame_ids.append(fid)
        t += 1.0

    detector = providers.face_detector
    if detector is not None:
        model_name = detector.model_name
    else:
        print("V1: no face detector configured; extracting keyframes only.")
        model_name = "none"

    frame_area = meta.width * meta.height
    keyframes_paths: List[str] = []
    face_detections: List[Dict[str, Any]] = []

    # Stream keyframes in bounded chunks; one batched detector forward per
    # chunk (the keyframe grid is coarse, but an hour of HD footage is still
    # thousands of full-res frames — memory must not scale with duration).
    chunk_size = config.landmarks.stream_chunk_frames
    # Device-resident frame tensor: V1 runs first in the V-branch, so it
    # uploads the UNION of its 1 fps grid and the V3 sampling grid once;
    # downstream nodes consume device-side gathers instead of re-uploading.
    # Only for videos that fit one chunk — longer ones keep the bounded
    # streaming path.
    use_device = detector is not None and getattr(
        detector, "accepts_device_frames", False)
    det_device = getattr(detector, "device", None)
    if use_device and meta.fps:
        lmk_stride = max(1, int(round(meta.fps / config.landmarks.sample_fps)))
        union_ids = sorted(set(frame_ids) | set(range(0, meta.frame_count, lmk_stride)))
        if len(union_ids) <= chunk_size:
            union_frames, union_kept = reader.sample(video_path, union_ids, device)
            if len(union_kept) > 0:
                device_frames_for(video_path, union_kept, union_frames, det_device)

    ck = content_key(video_path)
    writer = ArtifactWriter()
    try:
        for frames, kept_ids in StreamingSampler(video_path, frame_ids,
                                                 chunk_size=chunk_size, device=device):
            if detector is not None:
                dev = device_frames_for(video_path, kept_ids, device=det_device) if use_device else None
                detections_per_frame = detector.detect_batch(
                    dev if dev is not None else frames)
            else:
                detections_per_frame = [[] for _ in kept_ids]
            _process_chunk(frames, kept_ids, detections_per_frame, meta, cfg,
                           frame_area, keyframes_dir, faces_dir,
                           keyframes_paths, face_detections, writer, ck=ck)
    except BaseException:
        # join queued encodes so they can't fail silently in the shared
        # pool after the node unwinds; the original error stays primary
        try:
            writer.drain()
        except Exception as e:
            print(f"V1: artifact drain after failure: {e}")
        raise
    else:
        writer.drain()  # artifact contract: files exist before the delta merges

    if not keyframes_paths:
        print("V1: no frames decoded.")
        return {}

    metadata = dict(state.get("metadata", {}) or {})
    metadata["video_fps"] = meta.fps
    metadata["total_frames"] = meta.frame_count
    metadata["face_detection_model"] = model_name

    dump_node_debug(
        output_dir,
        "V1",
        {
            "keyframes": len(keyframes_paths),
            "faces": sum(len(d["faces"]) for d in face_detections),
            "fps": meta.fps,
        },
    )
    return {
        "keyframes": keyframes_paths,
        "face_detections": face_detections,
        "metadata": metadata,
    }
