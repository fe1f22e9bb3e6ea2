"""The fused per-video analyzer: the counterpart of ``__graft_entry__.entry()``.

``fn(ssd, lmk, frames u8[T,240,320,3], audio f32[M], other_feats [8], w [9],
b []) -> (fake_probability, lip_sync_score)`` over 10 s of 30 fps video: the
SSD detector on the 1 fps subsample (V1), the hourglass on the 5 fps crops
gathered with each frame's nearest keyframe box (V3), the mouth-aspect-ratio
series, the audio RMS envelope (A3), windowed lip-sync (C1, one launch of the CUDA
stage kernel on the card) and the LR head.  Both backbones run in bf16, as
the reference does.

Run it on the card with ``python -m fvd_tpu_torch.entry``.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models import face_ssd, landmarks_fan
from fvd_tpu_torch.ops.lipsync import lip_sync_score, mar_from_points
from fvd_tpu_torch.ops.spectral import interp_to_length, rms_envelope

CHECKPOINT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "checkpoints")
FPS = 30.0
SR = 16000
H, W = 240, 320


def load_models(device=None, checkpoint_dir: str = CHECKPOINT_DIR):
    """(FaceSSD, LandmarkHourglass) from ``face_ssd.npz`` and
    ``landmarks.npz``, at the widths their kernels carry."""
    dev = resolve_device(device)
    ssd = face_ssd.from_params(weights_mod.read_npz(os.path.join(checkpoint_dir, "face_ssd.npz")), dev)
    lmk = landmarks_fan.from_params(
        weights_mod.read_npz(os.path.join(checkpoint_dir, "landmarks.npz")), dev)
    return ssd, lmk


def make_analyzer(duration: float = 10.0, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """The analyzer ``fn`` for a clip of ``duration`` seconds."""
    T = int(duration * FPS)
    det_stride = int(FPS)          # 1 fps detect
    lmk_stride = int(FPS / 5)      # 5 fps landmarks
    det_ids = np.arange(0, T, det_stride)
    lmk_ids = np.arange(0, T, lmk_stride)
    lmk_det = lmk_ids // det_stride  # nearest-keyframe box
    n_lmk = len(lmk_ids)
    lmk_fps = FPS / lmk_stride
    hop = int(SR / lmk_fps)

    @torch.no_grad()
    def fn(ssd, lmk, frames, audio_wave, other_feats, w, b):
        dev = frames.device
        boxes, _ = face_ssd.detect_batch(ssd, frames[torch.as_tensor(det_ids, device=dev)],
                                         compute_dtype=compute_dtype)
        best = boxes[:, 0, :]  # NMS output is score-sorted; normalized corners
        px = best * torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
        coords = landmarks_fan.landmarks_from_frames(
            lmk, frames, px[torch.as_tensor(lmk_det, device=dev)],
            torch.as_tensor(lmk_ids, device=dev), compute_dtype=compute_dtype)
        mar = mar_from_points(coords[:, 48:68, :])

        env = rms_envelope(audio_wave, frame_length=2 * hop, hop=hop)
        env = interp_to_length(env, n_lmk)
        lip = lip_sync_score(mar, env, lmk_fps).score

        # LR fusion, lip_sync at index 2 of fvd_tpu_torch.ops.fusion.FEATURE_ORDER
        feats = torch.cat([other_feats[:2], lip[None], other_feats[2:]])
        prob = torch.sigmoid(feats @ w + b)
        return prob, lip

    return fn


def example_inputs(duration: float = 10.0):
    """The example inputs of ``__graft_entry__.entry()`` as numpy arrays, made
    from ``RandomState(0)``: frames, audio, other_feats, w, b."""
    T, M = int(duration * FPS), int(duration * SR)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, size=(T, H, W, 3), dtype=np.uint8)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(M) / SR)).astype(np.float32)
    other = rng.rand(8).astype(np.float32)
    w = rng.randn(9).astype(np.float32) * 0.1
    b = np.float32(0.1)
    return frames, audio, other, w, b


def entry(device=None, compute_dtype: torch.dtype = torch.bfloat16,
          duration: float = 10.0, checkpoint_dir: str = CHECKPOINT_DIR) -> Tuple[Callable, tuple]:
    """Returns ``(fn, example_args)``: ``fn(*example_args)`` ->
    ``(fake_probability, lip_sync_score)``, with the models and inputs on
    ``device`` (default the card)."""
    dev = resolve_device(device)
    ssd, lmk = load_models(dev, checkpoint_dir)
    frames, audio, other, w, b = example_inputs(duration)
    args = (ssd, lmk) + tuple(torch.as_tensor(a).to(dev) for a in (frames, audio, other, w, b))
    return make_analyzer(duration, compute_dtype), args


if __name__ == "__main__":
    fn, args = entry()
    prob, lip = fn(*args)
    print({"fake_probability": float(prob), "lip_sync_score": float(lip)})
