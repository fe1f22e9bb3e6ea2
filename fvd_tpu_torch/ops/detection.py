"""Detection ops: the counterparts of ``make_anchors``, ``decode_boxes``,
``iou_matrix``, ``nms`` and the host-side training helpers ``encode_boxes``
and ``match_anchors`` in ``fvd_tpu/ops/detection.py``.

NMS keeps the reference's static shape: a fixed budget of ``max_out``
iterations, each taking the highest-scoring survivor and masking its
neighbourhood, batched over a leading image axis.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def make_anchors(
    feature_shapes: Sequence[Tuple[int, int]],
    scales: Sequence[Sequence[float]],
    aspect_ratios: Sequence[Sequence[float]] = None,
) -> np.ndarray:
    """SSD prior boxes in normalized cxcywh, one set per feature map:
    [num_anchors, 4] (cx, cy, w, h), ordered head, scale, ratio, row, col."""
    if aspect_ratios is None:
        aspect_ratios = [[1.0]] * len(feature_shapes)
    out = []
    for (fh, fw), head_scales, head_ars in zip(feature_shapes, scales, aspect_ratios):
        ys = (np.arange(fh) + 0.5) / fh
        xs = (np.arange(fw) + 0.5) / fw
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        for s in head_scales:
            for ar in head_ars:
                w = s * np.sqrt(ar)
                h = s / np.sqrt(ar)
                out.append(np.stack(
                    [cx.ravel(), cy.ravel(), np.full(fh * fw, w), np.full(fh * fw, h)], axis=1))
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 variances: Tuple[float, float] = (0.1, 0.2)) -> torch.Tensor:
    """SSD offset decode: deltas [..., A, 4] (dcx, dcy, dw, dh) + anchors
    [A, 4] cxcywh -> corner boxes [..., A, 4] (x1, y1, x2, y2), normalized."""
    acx, acy, aw, ah = anchors[..., 0], anchors[..., 1], anchors[..., 2], anchors[..., 3]
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[0] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2] * variances[1], -10.0, 10.0)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3] * variances[1], -10.0, 10.0)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of corner boxes: a [..., N, 4] x b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_out: int = 200,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape greedy NMS over a leading batch axis.

    boxes [B, A, 4], scores [B, A] -> (boxes [B, max_out, 4], scores
    [B, max_out]).  Each of ``max_out`` iterations takes the argmax survivor
    (the first on ties) and suppresses boxes with IoU >= ``iou_threshold``;
    an empty slot has index -1, score 0 and a zero box.
    """
    B, A = scores.shape
    alive = scores > score_threshold
    ious = iou_matrix(boxes, boxes)
    rows = torch.arange(B, device=scores.device)
    neg_inf = torch.full_like(scores, float("-inf"))
    out_idx = torch.full((B, max_out), -1, dtype=torch.int64, device=scores.device)
    out_score = torch.zeros((B, max_out), dtype=scores.dtype, device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked, dim=1)
        best_score = masked[rows, best]
        ok = best_score > float("-inf")
        out_idx[:, i] = torch.where(ok, best, -1)
        out_score[:, i] = torch.where(ok, best_score, 0.0)
        suppress = ious[rows, best] >= iou_threshold
        alive = torch.where(ok[:, None], alive & ~suppress, alive)
        alive[rows, best] = False
    picked = torch.gather(boxes, 1, out_idx.clamp(min=0)[..., None].expand(B, max_out, 4))
    out_boxes = torch.where((out_idx >= 0)[..., None], picked, torch.zeros_like(picked))
    return out_boxes, out_score


def encode_boxes(boxes: np.ndarray, anchors: np.ndarray,
                 variances: Tuple[float, float] = (0.1, 0.2)) -> np.ndarray:
    """Inverse of :func:`decode_boxes` on the host (training targets): corner
    boxes [..., A, 4] + anchors [A, 4] cxcywh -> offsets [..., A, 4]."""
    bw = np.maximum(boxes[..., 2] - boxes[..., 0], 1e-6)
    bh = np.maximum(boxes[..., 3] - boxes[..., 1], 1e-6)
    bcx = (boxes[..., 0] + boxes[..., 2]) / 2
    bcy = (boxes[..., 1] + boxes[..., 3]) / 2
    acx, acy, aw, ah = anchors[..., 0], anchors[..., 1], anchors[..., 2], anchors[..., 3]
    return np.stack([(bcx - acx) / (variances[0] * aw), (bcy - acy) / (variances[0] * ah),
                     np.log(bw / aw) / variances[1], np.log(bh / ah) / variances[1]], axis=-1)


def match_anchors(gt_boxes: np.ndarray, anchors: np.ndarray,
                  pos_iou: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Training-time anchor matching on the host: each anchor gets the best gt
    if their IoU >= ``pos_iou``, and every gt claims its best anchor.  ->
    (labels [A] in {0, 1}, matched gt [A, 4] corner boxes)."""
    A = anchors.shape[0]
    labels = np.zeros(A, np.float32)
    matched = np.zeros((A, 4), np.float32)
    if len(gt_boxes) == 0:
        return labels, matched
    corners = np.stack([anchors[:, 0] - anchors[:, 2] / 2, anchors[:, 1] - anchors[:, 3] / 2,
                        anchors[:, 0] + anchors[:, 2] / 2, anchors[:, 1] + anchors[:, 3] / 2], axis=1)
    lt = np.maximum(corners[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(corners[:, None, 2:], gt_boxes[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (corners[:, 2] - corners[:, 0]) * (corners[:, 3] - corners[:, 1])
    area_b = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    ious = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    best_gt = ious.argmax(axis=1)
    pos = ious.max(axis=1) >= pos_iou
    for g in range(len(gt_boxes)):  # force-match each gt's best anchor
        a = ious[:, g].argmax()
        pos[a] = True
        best_gt[a] = g
    labels[pos] = 1.0
    matched[pos] = gt_boxes[best_gt[pos]]
    return labels, matched
