"""Train the reference-scale FAN landmark net (4 stacked 256-feature
bottleneck hourglasses over 256-px crops, 64x64 heatmaps) on procedural
faces and compare it with the shipped 128-px hourglass on identical samples:

    python -m fvd_tpu_torch.tools.pretrain_fan --steps 3000 --batch 16
    python -m fvd_tpu_torch.tools.pretrain_fan --cpu --steps 2 --width 32 --stacks 2 --batch 2 --out /tmp/fan.npz

The counterpart of the JAX package's ``tools/pretrain_fan.py``, with its
flags and defaults.  The net computes in bfloat16 on float32 parameters,
seeded from ``--seed`` (or loaded from ``--out`` with ``--resume``); the data
is ``landmark_batch(..., crop=256, augment=True, photometric=True,
shaded=True, hard_half=True)``; the loss is the soft-argmax coordinate MSE;
the optimiser is ``models/optim.py``'s clipped AdamW on a warmup-cosine
schedule.  After training, the paired evaluation draws 64 clean and 64 hard
samples and reports the FAN's mean landmark error and the shipped
``landmarks.npz``'s beside ``--out`` (its crops shrunk to 128 px as
``cv2.resize`` shrinks them), as % of the crop.  It writes ``--out`` in the
JAX package's npz layout and a json sidecar with ``paired_eval_pct_crop``.
It runs on the card unless ``--cpu`` is given, and raises where there is
none.

Its last line, ``[fan] summary {...}``, gives as JSON the steps, the median
host data ms and device ms of a step (CUDA events on the card), crops per
second over the loop's wall time, the first and last loss and both paired
errors.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import landmarks_fan as lf
from fvd_tpu_torch.models.optim import adamw_warmup_cosine, clipped_adamw_step
from fvd_tpu_torch.models.synthetic_faces import landmark_batch
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, _to, step_summary
from fvd_tpu_torch.utils import cv

#: the training data's recipe (the JAX tool's ``landmark_batch`` call)
TRAIN_DATA = dict(crop=lf.FAN_CROP_SIZE, augment=True, photometric=True, shaded=True, hard_half=True)
#: the paired evaluation's hard samples
HARD_EVAL = dict(augment=True, photometric=True, hard_half=True)


def fan_loss(model: lf.FANLandmarkNet, crops: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of the soft-argmax coordinates to the targets."""
    coords = lf.decode_heatmaps(model(crops))
    return torch.mean(torch.sum((coords - targets) ** 2, dim=-1))


@torch.no_grad()
def paired_eval(model: lf.FANLandmarkNet, ship, seed: int, device, n: int = 64, **kw):
    """-> (FAN error, shipped hourglass error or None): mean landmark error
    as a fraction of the crop on ``n`` samples of ``landmark_batch(
    RandomState(seed), n, crop=256, **kw)``; the hourglass reads them
    shrunk to 128 px and quantised to uint8."""
    crops, targets = landmark_batch(np.random.RandomState(seed), n, crop=lf.FAN_CROP_SIZE, **kw)
    coords = lf.decode_heatmaps(model(torch.from_numpy(crops).to(device))).cpu().numpy()
    fan_err = float(np.mean(np.linalg.norm(coords - targets, axis=-1)))
    if ship is None:
        return fan_err, None
    small = np.stack([cv.resize_linear_f32(c, lf.CROP_SIZE, lf.CROP_SIZE) for c in crops])
    ship_coords = lf.landmarks_forward(ship, torch.from_numpy((small * 255).astype(np.uint8)).to(device))
    return fan_err, float(np.mean(np.linalg.norm(ship_coords.cpu().numpy() - targets, axis=-1)))


def _pct(x):
    return 100 * x if x else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--out", default="checkpoints/fan_landmarks.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--stacks", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    rng = np.random.RandomState(args.seed)
    model = weights.seeded(lf.FANLandmarkNet(args.width, args.stacks, compute_dtype=torch.bfloat16), args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"FAN-geometry params: {n_params / 1e6:.1f}M", flush=True)
    if args.resume and os.path.exists(args.out):
        weights.load_npz(args.out, model)
        print(f"[fan] resumed params from {args.out}", flush=True)
    model.to(device)
    opt, sched = adamw_warmup_cosine(model, args.lr, args.warmup, args.steps)

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(args.steps):
        crops, targets = timer.data(landmark_batch, rng, args.batch, **TRAIN_DATA)
        loss = timer.step(lambda: clipped_adamw_step(fan_loss, model, opt, sched, *_to(device, crops, targets)))
        losses.append(loss)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"[fan] step {i:5d} loss {float(loss):.5f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    # the paired evaluation against the shipped 128-px hourglass
    ship_path = os.path.join(os.path.dirname(args.out) or "checkpoints", "landmarks.npz")
    ship = lf.from_params(weights.read_npz(ship_path), device) if os.path.exists(ship_path) else None
    model.eval()
    fan_in, ship_in = paired_eval(model, ship, args.seed + 10_000, device)
    fan_hard, ship_hard = paired_eval(model, ship, args.seed + 10_001, device, **HARD_EVAL)
    nan = float("nan")
    print("[fan] paired eval (identical samples, % of crop x100):", flush=True)
    print(f"  clean in-domain : FAN {100 * fan_in:.3f}  shipped-128px {_pct(ship_in) or nan:.3f}", flush=True)
    print(f"  hard (aug+photo+hard-half): FAN {100 * fan_hard:.3f}  shipped-128px {_pct(ship_hard) or nan:.3f}",
          flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    weights.save_npz(args.out, model)
    paired = {"clean": {"fan": 100 * fan_in, "shipped_128px": _pct(ship_in)},
              "hard": {"fan": 100 * fan_hard, "shipped_128px": _pct(ship_hard)}}
    with open(args.out.replace(".npz", ".json"), "w") as f:
        json.dump({"arch": "fan", "width": args.width, "n_stacks": args.stacks, "params_m": n_params / 1e6,
                   "train": "pretrain_fan.py", "steps": args.steps, "paired_eval_pct_crop": paired}, f, indent=1)
    print(f"[fan] saved {args.out}", flush=True)
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="crops",
                           paired_eval_pct_crop=paired)
    print("[fan] summary " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
