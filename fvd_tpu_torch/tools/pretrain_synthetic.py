"""Pretrain the face detector, the landmark hourglass and the pose head on
procedural faces, and write the npz checkpoints the providers load:

    python -m fvd_tpu_torch.tools.pretrain_synthetic --steps 400 --batch 16
    python -m fvd_tpu_torch.tools.pretrain_synthetic --steps 2 --cpu --out-dir /tmp/ckpt

The counterpart of the JAX package's ``tools/pretrain_synthetic.py``, with
its flags and defaults: ``face_ssd.npz``, ``landmarks.npz`` and ``pose.npz``
(+ ``pose.json``) under ``--out-dir``, the detector's train state under
``<out-dir>/train_state_det`` (saved every 500 steps and at the end,
continued by ``--resume``).  It runs on the card unless ``--cpu`` is given,
and raises where there is none.  The realism levers ``--photometric``,
``--shading`` and ``--portrait`` and the detector's ``--dense`` mixture go
to the generators as the JAX tool passes them.

After each trainer one line ``[det] summary {...}`` (``lmk``, ``pose``)
gives, as JSON: the steps, the median host data ms and device ms of a step
(the device step fenced with CUDA events on the card: upload, forward,
backward and the Adam update), images per second over the loop's wall time,
the loss of the first and last step, and the eval metric.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import face_ssd, landmarks_fan
from fvd_tpu_torch.models.checkpointing import load_train_state, save_train_state
from fvd_tpu_torch.models.layers import adam, adam_step
from fvd_tpu_torch.models.synthetic_faces import detector_batch, landmark_batch
from fvd_tpu_torch.models.synthetic_pose import pose_batch, pose_batch_paired
from fvd_tpu_torch.ops import detection

class StepTimer:
    """Host data ms and device step ms of each step; on the card the step is
    fenced with CUDA events and read once at the end, so timing adds no
    sync to the loop."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.data_ms, self._steps = [], []

    def data(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.data_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def step(self, fn, *args):
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self._steps.append((start, end))
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            self._steps.append((time.perf_counter() - t0) * 1e3)
        return out

    def step_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self._steps]
        return list(self._steps)


def step_summary(timer: StepTimer, items: int, seconds: float, losses, unit: str = "images", **fields) -> dict:
    """The ``summary`` line's fields: steps, median data and step ms,
    ``<unit>_per_s`` over the loop's wall time, the first and last loss."""
    losses = [float(x) for x in losses]
    return {"steps": len(timer.data_ms), "data_ms": statistics.median(timer.data_ms),
            "step_ms": statistics.median(timer.step_ms()), f"{unit}_per_s": items / seconds,
            "loop_s": seconds, "loss_first": losses[0], "loss_last": losses[-1], **fields}


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


def train_detector(steps: int, batch: int, width: int, out: str, device, seed: int = 0,
                   resume: bool = False, lr: float = 1e-3, augment: bool = False,
                   photometric: bool = False, dense: bool = False, shading: bool = False,
                   portrait: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    model = weights.seeded(face_ssd.FaceSSD(width), seed).to(device)
    step_fn, init_opt = face_ssd.make_train_step(lr=lr)
    opt = init_opt(model)
    start_step = 0
    train_dir = os.path.join(os.path.dirname(out) or ".", "train_state_det")
    if resume:
        restored = load_train_state(train_dir, model, opt)
        if restored is not None:
            start_step = restored
            print(f"[det] resumed train state at step {start_step} from {train_dir}")
        elif os.path.exists(out):
            face_ssd.load_params(out, model)
            print(f"[det] resumed params-only from {out}")

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(start_step, start_step + steps):
        frames, labels, locs, _ = timer.data(detector_batch, rng, batch, augment=augment, photometric=photometric,
                                             dense=dense, shaded=shading, portrait=portrait)
        loss = timer.step(lambda: step_fn(model, opt, *_to(device, frames, labels, locs)))
        losses.append(loss)
        if i % 50 == 0 or i == start_step + steps - 1:
            print(f"[det] step {i:4d} loss {float(loss):.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)
        if i > start_step and i % 500 == 0:
            save_train_state(train_dir, i, model, opt)
    seconds = time.perf_counter() - t0

    # eval: the top detection's IoU with the gt box on fresh samples
    frames, _, _, gt_boxes = detector_batch(rng, 16)
    raw = (frames + np.asarray(face_ssd.MEAN_RGB)).clip(0, 255).astype(np.uint8)
    boxes, scores = face_ssd.detect_batch(model, torch.from_numpy(raw).to(device))
    ious = torch.where(scores[:, 0] > 0, detection.iou_matrix(boxes[:, :1], torch.from_numpy(gt_boxes)
                                                              .to(device)[:, None])[:, 0, 0], 0.0)
    mean_iou = float(ious.mean())
    print(f"[det] eval mean IoU (top detection vs gt): {mean_iou:.3f}")

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    face_ssd.save_params(out, model)
    save_train_state(train_dir, start_step + steps, model, opt)
    print(f"[det] saved {out} (+ train state at step {start_step + steps})")
    return step_summary(timer, steps * batch, seconds, losses, start_step=start_step, eval_mean_iou=mean_iou)


def train_landmarks(steps: int, batch: int, width: int, out: str, device, seed: int = 1,
                    resume: bool = False, lr: float = 1e-3, augment: bool = False,
                    photometric: bool = False, shading: bool = False, hard_half: bool = False,
                    portrait: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    model = weights.seeded(landmarks_fan.LandmarkHourglass(width), seed).to(device)
    if resume and os.path.exists(out):
        landmarks_fan.load_params(out, model)
        print(f"[lmk] resumed params from {out}")
    step_fn, init_opt = landmarks_fan.make_landmark_train_step(lr=lr)
    opt = init_opt(model)

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(steps):
        crops, targets = timer.data(landmark_batch, rng, batch, augment=augment, photometric=photometric,
                                    shaded=shading, hard_half=hard_half, portrait=portrait)
        loss = timer.step(lambda: step_fn(model, opt, *_to(device, crops, targets)))
        losses.append(loss)
        if i % 50 == 0 or i == steps - 1:
            print(f"[lmk] step {i:4d} loss {float(loss):.5f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    crops, targets = landmark_batch(rng, 16)
    coords = landmarks_fan.landmarks_forward(model, torch.from_numpy((crops * 255).astype(np.uint8)).to(device))
    err = float(np.mean(np.linalg.norm(coords.cpu().numpy() - targets, axis=-1)))
    print(f"[lmk] eval mean normalized error: {err:.4f}")

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    landmarks_fan.save_params(out, model)
    print(f"[lmk] saved {out}")
    return step_summary(timer, steps * batch, seconds, losses, eval_mean_error=err)


def train_pose(steps: int, batch: int, width: int, out: str, device, seed: int = 2,
               resume: bool = False, lr: float = 1e-3, augment: bool = False,
               photometric: bool = False, shading: bool = False, hard_half: bool = False,
               portrait: bool = False, consistency: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    model = weights.seeded(landmarks_fan.PoseHead(width), seed).to(device)
    if resume and os.path.exists(out):
        landmarks_fan.load_params(out, model)
        print(f"[pose] resumed params from {out}")
    opt = adam(model, lr)

    # odd steps with --consistency: same-face, same-rotation pairs, their
    # divergence penalised; losses of the two kinds are kept apart
    timer, losses, closses, images = StepTimer(device), [], [], 0
    t0 = time.perf_counter()
    for i in range(steps):
        if consistency and i % 2 == 1:
            ca, cb, Rs = timer.data(pose_batch_paired, rng, max(batch // 2, 4), photometric=photometric,
                                    shaded=shading)
            closses.append(timer.step(lambda: adam_step(landmarks_fan.pose_consistency_loss, model, opt,
                                                        *_to(device, ca, cb, Rs))))
            images += 2 * len(ca)
            continue
        crops, Rs, _ = timer.data(pose_batch, rng, batch, augment=augment, photometric=photometric,
                                  shaded=shading, hard_half=hard_half, portrait=portrait)
        loss = timer.step(lambda: adam_step(landmarks_fan.pose_loss, model, opt, *_to(device, crops, Rs)))
        losses.append(loss)
        images += len(crops)
        if i % 100 == 0 or i == steps - 1:
            print(f"[pose] step {i:4d} loss {float(loss):.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    crops, _, eulers = pose_batch(rng, 32)
    pred = landmarks_fan.pose_forward(model, torch.from_numpy((crops * 255).astype(np.uint8)).to(device))
    err = np.abs(pred.cpu().numpy() - eulers).mean(axis=0)
    print(f"[pose] eval mean abs err (pitch/yaw/roll deg): {err.round(2)}")

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    landmarks_fan.save_params(out, model)
    with open(out.replace(".npz", ".json"), "w") as f:
        json.dump({"width": width}, f)
    print(f"[pose] saved {out} (width={width})")
    extra = {"consistency_loss_first": float(closses[0]), "consistency_loss_last": float(closses[-1])} \
        if closses else {}
    return step_summary(timer, images, seconds, losses, eval_mean_abs_err_deg=err.tolist(), **extra)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--det-width", type=int, default=32)
    ap.add_argument("--lmk-width", type=int, default=32)
    ap.add_argument("--pose-width", type=int, default=32)
    ap.add_argument("--out-dir", default="checkpoints")
    ap.add_argument("--only", choices=["det", "lmk", "pose"], default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hard-half", action="store_true",
                    help="lmk/pose: the whole augmented half renders hard")
    ap.add_argument("--consistency", action="store_true",
                    help="pose: odd steps train on clean/accessory pairs with the divergence penalty")
    ap.add_argument("--augment", action="store_true",
                    help="robustness augmentations on half of each batch (a quarter hard)")
    ap.add_argument("--dense", action="store_true",
                    help="det: 3/4 of each batch augmented, half of it hard, every augmented sample photometric")
    ap.add_argument("--photometric", action="store_true",
                    help="lighting ramp, white balance, motion blur, noise, desaturation and JPEG on the "
                         "augmented samples")
    ap.add_argument("--portrait", action="store_true",
                    help="hair, jaw, hat band, eye and mouth detail and background clutter")
    ap.add_argument("--shading", action="store_true",
                    help="rim and directional shading, skin mottling, sheen and a feathered face edge on 3/4 "
                         "of each batch")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    common = dict(resume=args.resume, lr=args.lr, augment=args.augment, photometric=args.photometric,
                  shading=args.shading, portrait=args.portrait)
    out = {}
    if args.only in (None, "det"):
        out["det"] = train_detector(args.steps, args.batch, args.det_width,
                                    os.path.join(args.out_dir, "face_ssd.npz"), device, dense=args.dense, **common)
        print("[det] summary " + json.dumps(out["det"]), flush=True)
    if args.only in (None, "lmk"):
        out["lmk"] = train_landmarks(args.steps, args.batch, args.lmk_width,
                                     os.path.join(args.out_dir, "landmarks.npz"), device,
                                     hard_half=args.hard_half, **common)
        print("[lmk] summary " + json.dumps(out["lmk"]), flush=True)
    if args.only in (None, "pose"):
        out["pose"] = train_pose(args.steps, args.batch, args.pose_width,
                                 os.path.join(args.out_dir, "pose.npz"), device,
                                 hard_half=args.hard_half, consistency=args.consistency, **common)
        print("[pose] summary " + json.dumps(out["pose"]), flush=True)
    return out


if __name__ == "__main__":
    main()
