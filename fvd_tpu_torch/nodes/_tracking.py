"""Face track selection shared by V3/V4: the port's copy of
``fvd_tpu/nodes/_tracking.py``.

Reference logic (``v3_mouth_landmarks_timeseries.py:139-209`` and
``v4_blink_headpose_dynamics.py:182-251``): maintain an active face box;

* no active box: acquire the largest face whose box passes a min-size gate
  (5% of frame dims) — V3 additionally gates aspect ratio to [0.3, 3.0];
* active box: pick the max-IoU face; if max IoU < 0.15, tracking is lost —
  reset and fall back to the largest face with NO gates;
* the winning face's landmark bounding box becomes the next active box
  (V4 pads it 10% before storing — it feeds the pose crop).

This is an inherently sequential, ragged-input state machine over a handful
of boxes per frame — it stays on host (SURVEY §7 "implement as scan (cheap)
rather than forcing parallelism" applies to the *smoothing*, which is the
dense part; see ``ops/filters.py`` ``one_euro_scan``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fvd_tpu_torch.ops.filters import iou


def landmark_box(landmarks: np.ndarray) -> Tuple[int, int, int, int]:
    """Integer bounding box of a landmark set (reference int() truncation)."""
    x_min = int(np.min(landmarks[:, 0]))
    y_min = int(np.min(landmarks[:, 1]))
    x_max = int(np.max(landmarks[:, 0]))
    y_max = int(np.max(landmarks[:, 1]))
    return x_min, y_min, x_max, y_max


@dataclass
class TrackerConfig:
    frame_width: int
    frame_height: int
    min_face_frac: float = 0.05
    iou_min: float = 0.15
    aspect_gate: bool = True
    aspect_range: Tuple[float, float] = (0.3, 3.0)
    pad_frac: float = 0.0  # V4 pads the stored box by 10%


def track_chunk(
    all_landmarks: Sequence[Sequence[np.ndarray]],
    kept_ids: Sequence[int],
    fps: float,
    tracker: "FaceTracker",
    *,
    n_pts: int = 68,
    dim: int = 2,
    collect_boxes: bool = False,
    collect_sel: bool = False,
    processed: int = 0,
):
    """Per-frame track selection for one decoded chunk (shared by V3, V4
    and the progressive streaming analyzer — one implementation of the
    select/record step so the three paths can never drift).

    ``all_landmarks``: per-frame candidate landmark sets (the provider
    forward's output).  Returns ``(times [T] f64, raw [T, n_pts, dim],
    valid [T] bool, boxes)`` where ``boxes`` is the tracker's (possibly
    padded) active box per selected frame when ``collect_boxes`` else None.
    With ``collect_sel`` a fifth element is appended: the selected
    candidate index per frame (-1 where invalid) — the row key into the
    fused landmark+pose forward's per-detection pose output.
    2D landmark sets are zero-extended to ``dim`` (V4's 3D track with a 2D
    provider).
    """
    T = len(kept_ids)
    times = np.array(
        [fid / fps if fps else processed + i for i, fid in enumerate(kept_ids)],
        np.float64,
    )
    raw = np.zeros((T, n_pts, dim), np.float64)
    valid = np.zeros(T, bool)
    boxes: Optional[List[Optional[List[int]]]] = [None] * T if collect_boxes else None
    sel: Optional[List[int]] = [-1] * T if collect_sel else None
    for i, lm_list in enumerate(all_landmarks):
        idx = tracker.select([np.asarray(lm)[:, :2] for lm in lm_list])
        if idx == -1:
            continue
        lm = np.asarray(lm_list[idx], np.float64)
        if lm.shape[1] < dim:
            lm = np.concatenate(
                [lm, np.zeros((lm.shape[0], dim - lm.shape[1]))], axis=1
            )
        raw[i] = lm[:n_pts, :dim]
        valid[i] = True
        if boxes is not None:
            boxes[i] = list(tracker.active_box)
        if sel is not None:
            sel[i] = idx
    if sel is not None:
        return times, raw, valid, boxes, sel
    return times, raw, valid, boxes


class FaceTracker:
    """Per-video sequential track selector."""

    def __init__(self, cfg: TrackerConfig):
        self.cfg = cfg
        self.active_box: Optional[List[int]] = None

    def _acquire_largest(self, landmarks_list: Sequence[np.ndarray], gated: bool) -> int:
        cfg = self.cfg
        best_idx, max_area = -1, -1
        for i, lm in enumerate(landmarks_list):
            x_min, y_min, x_max, y_max = landmark_box(lm)
            w, h = x_max - x_min, y_max - y_min
            if gated:
                if w < cfg.frame_width * cfg.min_face_frac or h < cfg.frame_height * cfg.min_face_frac:
                    continue
                if cfg.aspect_gate and h > 0:
                    ar = w / h
                    if ar < cfg.aspect_range[0] or ar > cfg.aspect_range[1]:
                        continue
            area = w * h
            if area > max_area:
                max_area = area
                best_idx = i
        return best_idx

    def select(self, landmarks_list: Sequence[np.ndarray]) -> int:
        """Index of the tracked face for this frame, -1 if none; updates the
        active box."""
        if not landmarks_list:
            return -1
        cfg = self.cfg
        if self.active_box is None:
            best_idx = self._acquire_largest(landmarks_list, gated=True)
        else:
            best_idx, max_iou = -1, -1.0
            for i, lm in enumerate(landmarks_list):
                box = list(landmark_box(lm))
                v = iou(self.active_box, box)
                if v > max_iou:
                    max_iou = v
                    best_idx = i
            if max_iou < cfg.iou_min:
                # tracking lost: reset + largest face, no gates (v3:179-193)
                self.active_box = None
                best_idx = self._acquire_largest(landmarks_list, gated=False)

        if best_idx != -1:
            x_min, y_min, x_max, y_max = landmark_box(landmarks_list[best_idx])
            if cfg.pad_frac > 0:
                pad_w = int((x_max - x_min) * cfg.pad_frac)
                pad_h = int((y_max - y_min) * cfg.pad_frac)
                x_min = max(0, x_min - pad_w)
                y_min = max(0, y_min - pad_h)
                x_max = min(cfg.frame_width, x_max + pad_w)
                y_max = min(cfg.frame_height, y_max + pad_h)
            self.active_box = [x_min, y_min, x_max, y_max]
        return best_idx
