"""Hourglass landmark regressor (V3) and 6D head-pose head (V4): the
counterpart of ``ResBlock``, ``Hourglass``, ``LandmarkHourglass``,
``decode_heatmaps``, ``PoseHead``, ``rotation_6d_to_matrix``,
``euler_from_matrix_deg``, ``_device_crops``, ``landmarks_from_frames``,
``pose_from_frames``, ``landmarks_pose_from_frames``, ``_pad_bucket``,
``_marshal_boxes``, the ``FANLandmarks`` provider and the reference-scale
``Bottleneck``, ``HourglassB``, ``FANLandmarkNet`` and ``PoseResNet50`` in
``fvd_tpu/models/landmarks_fan.py``.  The hourglass and the pose head run
their crop batches through :func:`~fvd_tpu_torch.parallel.inference.shard_for_inference`,
so an installed inference mesh splits them over its devices.

Training (``:664-707`` there): :func:`landmark_loss`, :func:`pose_loss`,
:func:`pose_consistency_loss`, :func:`make_landmark_train_step`, the npz
:func:`save_params` / :func:`load_params` and the eval forwards
:func:`landmarks_forward` and :func:`pose_forward` on uint8 crops.

Submodules carry the flax auto-names (``Conv_0``, ``GroupNorm_0``,
``ResBlock_3``, ``Hourglass_0``) so a flax params tree loads through
:mod:`fvd_tpu_torch.weights`.  Public functions keep the reference's NHWC
layout; the convolutions run NCHW inside.
"""

from __future__ import annotations

import functools
from typing import List, Mapping, Optional

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models.layers import (SameConv2d, adam, adam_step, conv_in_dtype, group_norm,
                                         group_norm_in_dtype, in_dtype, same_pads)
from fvd_tpu_torch.ops.image import resize, scale_and_translate
from fvd_tpu_torch.parallel.inference import shard_for_inference

CROP_SIZE = 128
HEATMAP_SIZE = 32
N_LANDMARKS = 68


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = SameConv2d(in_ch, features, 3)
        self.GroupNorm_1 = group_norm(features)
        self.Conv_1 = SameConv2d(features, features, 3)
        if in_ch != features:
            self.Conv_2 = nn.Conv2d(in_ch, features, 1)

    def forward(self, x):
        r = x
        x = self.Conv_0(F.relu(self.GroupNorm_0(x)))
        x = self.Conv_1(F.relu(self.GroupNorm_1(x)))
        if hasattr(self, "Conv_2"):
            r = self.Conv_2(r)
        return x + r


class Hourglass(nn.Module):
    """Blocks in flax call order: per level a skip block and a block after
    the pool (0..2*depth-1), the middle block, then one per level going up."""

    def __init__(self, features: int, depth: int = 3):
        super().__init__()
        self.depth = depth
        for i in range(3 * depth + 1):
            setattr(self, f"ResBlock_{i}", ResBlock(features, features))

    def forward(self, x):
        skips = []
        for d in range(self.depth):
            skips.append(getattr(self, f"ResBlock_{2 * d}")(x))
            x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f"ResBlock_{2 * d + 1}")(x)
        x = getattr(self, f"ResBlock_{2 * self.depth}")(x)
        for u, skip in enumerate(reversed(skips)):
            # jax.image.resize "nearest" samples floor((o + 0.5) * in / out),
            # which is torch's "nearest-exact"
            x = F.interpolate(x, size=skip.shape[-2:], mode="nearest-exact")
            x = getattr(self, f"ResBlock_{2 * self.depth + 1 + u}")(x + skip)
        return x


class LandmarkHourglass(nn.Module):
    """NHWC [B, 128, 128, 3] float (0..1) -> heatmaps NHWC [B, 32, 32, 68]."""

    def __init__(self, width: int = 64):
        super().__init__()
        self.Conv_0 = SameConv2d(3, width, 7, stride=2)
        self.GroupNorm_0 = group_norm(width)
        self.ResBlock_0 = ResBlock(width, width)
        self.Hourglass_0 = Hourglass(width)
        self.GroupNorm_1 = group_norm(width)
        self.Conv_1 = nn.Conv2d(width, N_LANDMARKS, 1)
        self.width = width

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))   # 64
        x = F.max_pool2d(self.ResBlock_0(x), 2, 2)      # 32
        x = self.Hourglass_0(x)
        x = F.relu(self.GroupNorm_1(x))
        return self.Conv_1(x).permute(0, 2, 3, 1)


def from_params(params: Mapping, device=None) -> LandmarkHourglass:
    """A :class:`LandmarkHourglass` holding a flax params tree; the width is
    read from the stem kernel."""
    model = LandmarkHourglass(weights_mod.kernel_width(params, "Conv_0"))
    model.load_state_dict(weights_mod.to_state_dict(params), strict=True)
    return model.eval().to(device)


def decode_heatmaps(heatmaps: torch.Tensor, temperature: float = 10.0) -> torch.Tensor:
    """Soft-argmax: [..., H, W, K] -> [..., K, 2] (x, y) in [0, 1]."""
    *lead, h, w, k = heatmaps.shape
    attn = torch.softmax(heatmaps.reshape(*lead, h * w, k) * temperature, dim=-2)
    ys = (torch.arange(h, dtype=attn.dtype, device=attn.device) + 0.5) / h
    xs = (torch.arange(w, dtype=attn.dtype, device=attn.device) + 0.5) / w
    grid_y = ys.repeat_interleave(w)
    grid_x = xs.repeat(h)
    x = torch.einsum("...ak,a->...k", attn, grid_x)
    y = torch.einsum("...ak,a->...k", attn, grid_y)
    return torch.stack([x, y], dim=-1)


class PoseHead(nn.Module):
    """NHWC [B, 128, 128, 3] float (0..1) -> 6D rotation representation [B, 6]:
    four stride-2 3x3 convs, each with GroupNorm(8) and ReLU, a spatial mean,
    then Dense(128), ReLU, Dense(6)."""

    def __init__(self, width: int = 32):
        super().__init__()
        in_ch = 3
        for i in range(4):
            out_ch = width * 2 ** min(i, 2)
            setattr(self, f"Conv_{i}", SameConv2d(in_ch, out_ch, 3, stride=2))
            setattr(self, f"GroupNorm_{i}", group_norm(out_ch))
            in_ch = out_ch
        self.Dense_0 = nn.Linear(in_ch, 128)
        self.Dense_1 = nn.Linear(128, 6)
        self.width = width

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        x = x.mean(dim=(2, 3))
        return self.Dense_1(F.relu(self.Dense_0(x)))


def pose_from_params(params: Mapping, device=None) -> PoseHead:
    """A :class:`PoseHead` holding a flax params tree; the width is read from
    the first conv kernel (``pose.npz``: 32, the width its ``pose.json``
    names)."""
    model = PoseHead(weights_mod.kernel_width(params, "Conv_0"))
    model.load_state_dict(weights_mod.to_state_dict(params), strict=True)
    return model.eval().to(device)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt 6D -> SO(3) (Zhou et al., the SixDRepNet representation);
    the rows of the result are b1, b2 and b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-8)
    a2_proj = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2_proj / (torch.linalg.vector_norm(a2_proj, dim=-1, keepdim=True) + 1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def euler_from_matrix_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (pitch, yaw, roll) degrees, SixDRepNet convention;
    where ``sy < 1e-6`` (gimbal lock) pitch comes from the second row and roll
    is 0."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    pitch = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                        torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    yaw = torch.atan2(-R[..., 2, 0], sy)
    roll = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([pitch, yaw, roll], dim=-1) * (180.0 / np.pi)


def _pose_forward(pose_model: PoseHead, crops: torch.Tensor) -> torch.Tensor:
    d6 = in_dtype(pose_model, torch.float32)(crops.to(torch.float32))
    return euler_from_matrix_deg(rotation_6d_to_matrix(d6))


def _pose_of_crops(pose_model: PoseHead, crops: torch.Tensor) -> torch.Tensor:
    """float32 crops [N, 128, 128, 3] in 0..1 -> (pitch, yaw, roll) [N, 3].
    The pose head always runs in float32, whatever the landmarks' dtype; the
    crops split over the inference mesh where one is installed."""
    return shard_for_inference(_pose_forward, pose_model, crops)


def _device_crops(frames: torch.Tensor, boxes: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
    """Gather and resize face crops from the frame tensor: uint8 [T, H, W, 3]
    + px boxes [N, 4] + owner frame ids [N] -> float crops [N, 128, 128, 3]
    in 0..1.  cv2's half-pixel mapping (scale = crop / extent, translation =
    -origin * scale), linear, no antialias; taps outside the frame are
    dropped and the rest renormalised, as jax.image.scale_and_translate
    does."""
    imgs = frames.index_select(0, owners).to(torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)
    sy = CROP_SIZE / torch.clamp(y2 - y1, min=1.0)
    sx = CROP_SIZE / torch.clamp(x2 - x1, min=1.0)
    scale = torch.stack([sy, sx], dim=-1)
    translation = torch.stack([-y1 * sy, -x1 * sx], dim=-1)
    crops = scale_and_translate(imgs, (CROP_SIZE, CROP_SIZE), scale, translation, antialias=False)
    return crops / 255.0


@torch.no_grad()
def landmarks_from_frames(
    model: LandmarkHourglass,
    frames: torch.Tensor,
    boxes: torch.Tensor,
    owners: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Crop from the frame tensor + hourglass forward in ``compute_dtype`` +
    float32 soft-argmax -> landmark coords [N, 68, 2] in crop [0, 1].  The
    crops split over the inference mesh where one is installed."""
    return shard_for_inference(functools.partial(_landmarks_of_crops, compute_dtype=compute_dtype), model,
                               _device_crops(frames, boxes, owners))


def _landmarks_of_crops(model: LandmarkHourglass, crops: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    hm = in_dtype(model, compute_dtype)(crops.to(compute_dtype))
    return decode_heatmaps(hm.to(torch.float32))


@torch.no_grad()
def pose_from_frames(pose_model: PoseHead, frames: torch.Tensor, boxes: torch.Tensor,
                     owners: torch.Tensor) -> torch.Tensor:
    """Crop from the frame tensor + 6D pose head -> (pitch, yaw, roll) [N, 3]."""
    return _pose_of_crops(pose_model, _device_crops(frames, boxes, owners))


def pose_crop_boxes(coords: torch.Tensor, boxes: torch.Tensor, frame_w: float, frame_h: float,
                    pad_frac: float) -> torch.Tensor:
    """V4's pose crop box per detection, from its landmark coords [N, 68, 2]
    (crop [0, 1]) and its px box [N, 4]: the landmarks' frame-space bounding
    box, truncated, padded by ``trunc(extent * pad_frac)`` and clipped to the
    frame, as float32 [N, 4].  The host tracker's rule (``landmark_box`` plus
    V4's pad), in float32 with the JAX program's order of operations, so that
    min, max and trunc give the same integers."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    px = x1[:, None] + coords[:, :, 0] * (x2 - x1)[:, None]
    py = y1[:, None] + coords[:, :, 1] * (y2 - y1)[:, None]
    bx1, bx2 = torch.trunc(px.amin(dim=1)), torch.trunc(px.amax(dim=1))
    by1, by2 = torch.trunc(py.amin(dim=1)), torch.trunc(py.amax(dim=1))
    # Python scalars enter a float32 op as float32 (no host-to-device copy)
    pad_w = torch.trunc((bx2 - bx1) * pad_frac)
    pad_h = torch.trunc((by2 - by1) * pad_frac)
    return torch.stack([torch.clamp(bx1 - pad_w, min=0.0), torch.clamp(by1 - pad_h, min=0.0),
                        torch.clamp(bx2 + pad_w, max=frame_w), torch.clamp(by2 + pad_h, max=frame_h)], dim=1)


@torch.no_grad()
def landmarks_pose_from_frames(
    model: LandmarkHourglass,
    pose_model: PoseHead,
    frames: torch.Tensor,
    boxes: torch.Tensor,
    owners: torch.Tensor,
    frame_w: float,
    frame_h: float,
    pad_frac: float,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Crop gather + hourglass landmarks + per-detection 6D pose, the pose
    crop box derived on the device from the landmark coords
    (:func:`pose_crop_boxes`): -> (coords [N, 68, 2], poses [N, 3]).  The
    landmarks run in ``compute_dtype``, the pose head in float32."""
    coords = landmarks_from_frames(model, frames, boxes, owners, compute_dtype)
    pose_boxes = pose_crop_boxes(coords, boxes, frame_w, frame_h, pad_frac)
    return coords, pose_from_frames(pose_model, frames, pose_boxes, owners)


def _pad_bucket(n: int) -> int:
    """Static shape bucket (next power of two, >= 8) so varying face counts
    reuse the same shapes."""
    b = 8
    while b < n:
        b *= 2
    return b


def _marshal_boxes(boxes, owners, device):
    """(boxes, owners) lists -> bucket-padded float32 / int64 tensors on
    ``device`` + real count.  Pad rows are the [0, 0, CROP_SIZE, CROP_SIZE]
    sentinel of owner 0 — valid inputs whose outputs are sliced off."""
    n = len(boxes)
    pad = _pad_bucket(n)
    boxes_arr = np.zeros((pad, 4), np.float32)
    boxes_arr[:n] = np.asarray(boxes, np.float32)
    boxes_arr[n:] = [0, 0, CROP_SIZE, CROP_SIZE]
    owners_arr = np.zeros(pad, np.int64)
    owners_arr[:n] = owners
    return torch.from_numpy(boxes_arr).to(device), torch.from_numpy(owners_arr).to(device), n


class FANLandmarks:
    """LandmarkProvider: a face detector composed with the hourglass and the
    pose head; crops for ALL frames are gathered on the device from the frame
    tensor and run as one forward.

    The JAX package also crops on the host with OpenCV when it has no device
    frames; the port always takes the device program, uploading host frames
    first where none are given.  ``pose_checkpoint`` (``pose.npz``) holds the
    pose head; without one the head is randomly initialised from a fixed seed,
    as the JAX package initialises it from ``PRNGKey(2)``.  The pose head
    runs in float32 under any ``compute_dtype``.  The JAX package's chained
    detector+landmarks program (``FVD_TPU_FUSED_DETLM``, opt-in) is not
    ported.
    """

    model_name = "fvd_tpu_hourglass"
    #: the inner detector forward can consume a device-resident frame tensor
    accepts_device_frames = True

    def __init__(self, face_detector, checkpoint: str, pose_checkpoint: Optional[str] = None,
                 detector_threshold: float = 0.5, compute_dtype: torch.dtype = torch.bfloat16,
                 device=None):
        self.device = resolve_device(device)
        self.face_detector = face_detector
        self.landmark_model = from_params(weights_mod.read_npz(checkpoint), self.device)
        if pose_checkpoint is not None:
            self.pose_model = pose_from_params(weights_mod.read_npz(pose_checkpoint), self.device)
        else:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(2)
                self.pose_model = PoseHead().eval().to(self.device)
        self.detector_threshold = detector_threshold
        self.compute_dtype = compute_dtype

    def _collect_detections(self, detections, frame_w: int, frame_h: int):
        """Apply the confidence / clip / min-size gate (integer truncation of
        the float boxes, as the reference)."""
        owners, boxes = [], []
        for i, dets in enumerate(detections):
            for d in dets:
                if d.confidence < self.detector_threshold:
                    continue
                x1, y1 = max(0, int(d.x1)), max(0, int(d.y1))
                x2, y2 = min(frame_w, int(d.x2)), min(frame_h, int(d.y2))
                if x2 - x1 < 4 or y2 - y1 < 4:
                    continue
                owners.append(i)
                boxes.append((x1, y1, x2, y2))
        return owners, boxes

    def landmarks_batch(self, frames: np.ndarray, device_frames=None) -> List[List[np.ndarray]]:
        """uint8 [T, H, W, 3] RGB -> per-frame lists of [68, 2] pixel
        landmarks.  ``device_frames``: the same frames already on the device;
        the detector and the crop gather both read it."""
        if device_frames is None:
            device_frames = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        detections = self.face_detector.detect_batch(device_frames)
        h, w = frames.shape[1:3]
        owners, boxes = self._collect_detections(detections, w, h)
        out: List[List[np.ndarray]] = [[] for _ in range(len(frames))]
        if not boxes:
            return out
        boxes_t, owners_t, n = _marshal_boxes(boxes, owners, self.device)
        coords = landmarks_from_frames(self.landmark_model, device_frames, boxes_t, owners_t,
                                       compute_dtype=self.compute_dtype)[:n].cpu().numpy()
        for (x1, y1, x2, y2), owner, c in zip(boxes, owners, coords):
            pts = np.stack([x1 + c[:, 0] * (x2 - x1), y1 + c[:, 1] * (y2 - y1)], axis=1)
            out[owner].append(pts)
        return out

    def landmarks_pose_batch(self, frames: np.ndarray, device_frames=None, pose_pad: float = 0.0):
        """Landmarks and a per-detection pose in one device program
        (:func:`landmarks_pose_from_frames`): ``(lm_lists, pose_lists)``, where
        ``pose_lists[i][j]`` is the (pitch, yaw, roll) of detection ``j`` of
        frame ``i`` on V4's crop box (the landmark box padded by
        ``pose_pad``)."""
        if device_frames is None:
            device_frames = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        detections = self.face_detector.detect_batch(device_frames)
        h, w = frames.shape[1:3]
        owners, boxes = self._collect_detections(detections, w, h)
        out_lm: List[List[np.ndarray]] = [[] for _ in range(len(frames))]
        out_pose: List[List[np.ndarray]] = [[] for _ in range(len(frames))]
        if not boxes:
            return out_lm, out_pose
        boxes_t, owners_t, n = _marshal_boxes(boxes, owners, self.device)
        coords, poses = landmarks_pose_from_frames(
            self.landmark_model, self.pose_model, device_frames, boxes_t, owners_t,
            float(w), float(h), float(pose_pad), compute_dtype=self.compute_dtype)
        coords, poses = coords[:n].cpu().numpy(), poses[:n].cpu().numpy()
        for (x1, y1, x2, y2), owner, c, p in zip(boxes, owners, coords, poses):
            out_lm[owner].append(np.stack([x1 + c[:, 0] * (x2 - x1), y1 + c[:, 1] * (y2 - y1)], axis=1))
            out_pose[owner].append(p)
        return out_lm, out_pose

    @torch.no_grad()
    def pose_batch(self, crops: np.ndarray) -> np.ndarray:
        """uint8 face crops [N, S, S, 3] -> (pitch, yaw, roll) [N, 3]: resized
        to 128 as ``jax.image.resize`` does, then the pose head."""
        if len(crops) == 0:
            return np.zeros((0, 3))
        x = torch.from_numpy(np.ascontiguousarray(crops)).to(self.device, torch.float32) / 255.0
        x = resize(x, (CROP_SIZE, CROP_SIZE), antialias=True)
        return _pose_of_crops(self.pose_model, x).cpu().numpy()

    def pose_boxes_batch(self, device_frames, boxes, owners) -> np.ndarray:
        """Pose for px ``boxes`` of the ``owners`` rows of the device frame
        tensor, cropped on the device."""
        if len(boxes) == 0:
            return np.zeros((0, 3))
        boxes_t, owners_t, n = _marshal_boxes(boxes, owners, self.device)
        return pose_from_frames(self.pose_model, device_frames, boxes_t, owners_t)[:n].cpu().numpy()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
#: write a model as the JAX package's flat npz (``landmarks.npz``, ``pose.npz``),
#: and load one
save_params, load_params = weights_mod.save_npz, weights_mod.load_npz


def landmark_loss(model: LandmarkHourglass, crops: torch.Tensor, target_coords: torch.Tensor) -> torch.Tensor:
    """Squared distance of the soft-argmax coordinates to the targets, mean
    over crops and landmarks (crops float [B, 128, 128, 3] in 0..1, targets
    [B, 68, 2] in [0, 1])."""
    coords = decode_heatmaps(model(crops))
    return torch.mean(torch.sum((coords - target_coords) ** 2, dim=-1))


def _frobenius2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum((a - b) ** 2, dim=(-1, -2)))


def pose_loss(model: PoseHead, crops: torch.Tensor, target_R: torch.Tensor) -> torch.Tensor:
    """Squared Frobenius distance between the predicted and the target
    rotation matrices."""
    return _frobenius2(rotation_6d_to_matrix(model(crops)), target_R)


def pose_consistency_loss(model: PoseHead, crops_a: torch.Tensor, crops_b: torch.Tensor,
                          target_R: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """The supervised loss of both branches of a same-face, same-rotation
    pair (A clean, B with accessory strokes), plus ``lam`` times the squared
    Frobenius distance between the two predictions."""
    Ra = rotation_6d_to_matrix(model(crops_a))
    Rb = rotation_6d_to_matrix(model(crops_b))
    sup = (_frobenius2(Ra, target_R) + _frobenius2(Rb, target_R)) * 0.5
    return sup + lam * _frobenius2(Ra, Rb)


def make_landmark_train_step(lr: float = 1e-3):
    """-> ``(step, init_opt)`` for the hourglass: ``init_opt(model)`` is
    ``optax.adam(lr)`` as ``torch.optim.Adam`` and ``step(model, opt, crops,
    targets)`` updates ``model`` in place and returns the loss before the
    update."""
    return functools.partial(adam_step, landmark_loss), functools.partial(adam, lr=lr)


def _uint8_crops(crops: torch.Tensor) -> torch.Tensor:
    """uint8 crops [B, S, S, 3] -> float [B, 128, 128, 3] in 0..1, resized as
    ``jax.image.resize`` "linear" resizes."""
    return resize(crops.to(torch.float32) / 255.0, (CROP_SIZE, CROP_SIZE), antialias=True)


@torch.no_grad()
def landmarks_forward(model: LandmarkHourglass, crops: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 crops [B, S, S, 3] -> landmark coords [B, 68, 2] in crop [0, 1]:
    the hourglass in ``compute_dtype`` (bf16 by default), the soft-argmax in
    float32."""
    return _landmarks_of_crops(model, _uint8_crops(crops), compute_dtype)


@torch.no_grad()
def pose_forward(pose_model: PoseHead, crops: torch.Tensor) -> torch.Tensor:
    """uint8 crops [B, S, S, 3] -> (pitch, yaw, roll) degrees [B, 3], in
    float32."""
    return _pose_forward(pose_model, _uint8_crops(crops))


# ---------------------------------------------------------------------------
# Reference-scale vision models (FAN and ResNet-50 geometry)
# ---------------------------------------------------------------------------
FAN_CROP_SIZE = 256
FAN_HEATMAP_SIZE = 64


def _gn_relu(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return F.relu(group_norm_in_dtype(gn, x))


class Bottleneck(nn.Module):
    """Pre-activation 1x1-3x3-1x1 bottleneck residual; ``mid`` defaults to
    ``features // 4`` (the FAN hourglass passes ``features // 2``).  A 1x1
    projection ``Conv_3`` carries the residual where the width or the stride
    changes.  It computes in its input's dtype (flax's ``dtype=``)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, mid: Optional[int] = None):
        super().__init__()
        mid = mid or features // 4
        self.GroupNorm_0 = group_norm(in_ch)
        self.Conv_0 = nn.Conv2d(in_ch, mid, 1)
        self.GroupNorm_1 = group_norm(mid)
        self.Conv_1 = SameConv2d(mid, mid, 3, stride=stride)
        self.GroupNorm_2 = group_norm(mid)
        self.Conv_2 = nn.Conv2d(mid, features, 1)
        if in_ch != features or stride != 1:
            self.Conv_3 = nn.Conv2d(in_ch, features, 1, stride=stride)

    def forward(self, x):
        y = conv_in_dtype(self.Conv_0, _gn_relu(self.GroupNorm_0, x))
        y = conv_in_dtype(self.Conv_1, _gn_relu(self.GroupNorm_1, y))
        y = conv_in_dtype(self.Conv_2, _gn_relu(self.GroupNorm_2, y))
        return y + (conv_in_dtype(self.Conv_3, x) if hasattr(self, "Conv_3") else x)


class HourglassB(nn.Module):
    """Bottleneck-block hourglass (the FAN unit, half-width 3x3s), blocks in
    flax call order as :class:`Hourglass`."""

    def __init__(self, features: int, depth: int = 4):
        super().__init__()
        self.depth = depth
        for i in range(3 * depth + 1):
            setattr(self, f"Bottleneck_{i}", Bottleneck(features, features, mid=features // 2))

    def forward(self, x):
        skips = []
        for d in range(self.depth):
            skips.append(getattr(self, f"Bottleneck_{2 * d}")(x))
            x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f"Bottleneck_{2 * d + 1}")(x)
        x = getattr(self, f"Bottleneck_{2 * self.depth}")(x)
        for u, skip in enumerate(reversed(skips)):
            x = F.interpolate(x, size=skip.shape[-2:], mode="nearest-exact")
            x = getattr(self, f"Bottleneck_{2 * self.depth + 1 + u}")(x + skip)
        return x


class FANLandmarkNet(nn.Module):
    """Reference-scale FAN: ``n_stacks`` stacked ``width``-feature
    hourglasses, NHWC crops [B, 256, 256, 3] -> the LAST stack's heatmaps
    NHWC [B, 64, 64, 68] (:func:`decode_heatmaps` applies unchanged).
    Submodules carry flax's auto-names in its call order, so a flax tree
    loads through :func:`fvd_tpu_torch.weights.to_state_dict`.

    ``compute_dtype`` is flax's ``dtype=``: the crops and every weight are
    cast to it inside the forward (bfloat16 on float32 parameters, as the
    JAX trainer runs it), the GroupNorm statistics stay float32, and the
    heatmaps come back in float32 (float64 where it computes in float64).
    ``None`` computes in the parameters' dtype."""

    def __init__(self, width: int = 256, n_stacks: int = 4, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_stacks = n_stacks
        self.compute_dtype = compute_dtype
        self.Conv_0 = SameConv2d(3, 64, 7, stride=2)
        self.GroupNorm_0 = group_norm(64)
        self.Bottleneck_0 = Bottleneck(64, 128)
        self.Bottleneck_1 = Bottleneck(128, width)
        conv = 1
        self.heads = []
        for s in range(n_stacks):
            setattr(self, f"HourglassB_{s}", HourglassB(width))
            setattr(self, f"Bottleneck_{2 + s}", Bottleneck(width, width))
            setattr(self, f"GroupNorm_{1 + s}", group_norm(width))
            names = [f"Conv_{conv}", f"Conv_{conv + 1}"]
            setattr(self, names[0], nn.Conv2d(width, width, 1))
            setattr(self, names[1], nn.Conv2d(width, N_LANDMARKS, 1))
            conv += 2
            if s < n_stacks - 1:  # the intermediate-supervision remix
                names += [f"Conv_{conv}", f"Conv_{conv + 1}"]
                setattr(self, names[2], nn.Conv2d(width, width, 1))
                setattr(self, names[3], nn.Conv2d(N_LANDMARKS, width, 1))
                conv += 2
            self.heads.append(names)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype or self.Conv_0.weight.dtype)
        x = _gn_relu(self.GroupNorm_0, conv_in_dtype(self.Conv_0, x))        # 128
        x = F.max_pool2d(self.Bottleneck_0(x), 2, 2)                         # 64
        x = self.Bottleneck_1(x)
        hm = None
        for s, names in enumerate(self.heads):
            y = getattr(self, f"Bottleneck_{2 + s}")(getattr(self, f"HourglassB_{s}")(x))
            y = _gn_relu(getattr(self, f"GroupNorm_{1 + s}"), conv_in_dtype(getattr(self, names[0]), y))
            hm = conv_in_dtype(getattr(self, names[1]), y)
            if len(names) == 4:
                x = x + conv_in_dtype(getattr(self, names[2]), y) + conv_in_dtype(getattr(self, names[3]), hm)
        return hm.permute(0, 2, 3, 1).to(torch.promote_types(hm.dtype, torch.float32))


#: (features, blocks, stride) of the four ResNet-50 stages
POSE50_STAGES = ((256, 3, 1), (512, 4, 2), (1024, 6, 2), (2048, 3, 2))


class PoseResNet50(nn.Module):
    """ResNet-50-scale 6D pose backbone (SixDRepNet's backbone class): NHWC
    crops [B, 224, 224, 3] -> 6D rotation [B, 6].  A 7x7/2 conv with
    GroupNorm and ReLU, a 3x3/2 max-pool padded as flax's ``SAME`` (with
    -inf), ``[3, 4, 6, 3]`` :class:`Bottleneck` stages at 256/512/1024/2048
    with strides 1, 2, 2, 2, a float32 spatial mean and ``Dense(6)``.
    ``compute_dtype`` as :class:`FANLandmarkNet`'s; the head is float32."""

    def __init__(self, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = SameConv2d(3, 64, 7, stride=2)
        self.GroupNorm_0 = group_norm(64)
        in_ch, i = 64, 0
        for ch, blocks, stride in POSE50_STAGES:
            for b in range(blocks):
                setattr(self, f"Bottleneck_{i}", Bottleneck(in_ch, ch, stride=stride if b == 0 else 1))
                in_ch, i = ch, i + 1
        self.n_blocks = i
        self.Dense_0 = nn.Linear(in_ch, 6)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype or self.Conv_0.weight.dtype)
        x = _gn_relu(self.GroupNorm_0, conv_in_dtype(self.Conv_0, x))
        top, bottom = same_pads(x.shape[-2], 3, 2)
        left, right = same_pads(x.shape[-1], 3, 2)
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3))
        return F.linear(x, self.Dense_0.weight.to(x.dtype), self.Dense_0.bias.to(x.dtype))
