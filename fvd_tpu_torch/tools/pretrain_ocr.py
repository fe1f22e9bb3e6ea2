"""Pretrain the OCR stack (the text-region detector and the CTC recognizer)
on rendered text, and write the npz checkpoints the providers load:

    python -m fvd_tpu_torch.tools.pretrain_ocr --steps 1500 --batch 32
    python -m fvd_tpu_torch.tools.pretrain_ocr --steps 2 --det-steps 2 --det-arch v2 --det-width 16 \
        --cpu --out-dir /tmp/ocr

The counterpart of the JAX package's ``tools/pretrain_ocr.py``, with its
flags and defaults: ``ocr_rec.npz``, and ``ocr_det.npz`` with its
``{"arch", "width"}`` sidecar, under ``--out-dir``; the JAX package's
``ocr.load_detector`` and ``encoders.load_params`` read both.  The
recognizer trains ``--steps`` steps of ``ctc_loss`` on
``synthetic_text.recognizer_batch``, the detector ``--det-steps`` (default
the JAX tool's ``max(200, steps // 3)``) of ``ocr.detector_loss`` on
``detector_batch``, both with Adam from ``weights.seeded`` (seed 0 and 1),
or from the npz with ``--resume``.  It runs on the card unless ``--cpu`` is
given, and raises where there is none.

The batches equal the JAX package's for the same seeds (texts, labels,
masks, lines and RNG state).  After each part one line ``[rec] summary
{...}`` (``[det]``) gives, as JSON: the steps, the median host data ms and
device ms of a step (CUDA events on the card), lines or images per second,
the first and last loss, and the eval: exact-match and character accuracy
on 32 fresh lines, mask IoU on 16 fresh scenes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import ocr
from fvd_tpu_torch.models.layers import adam, adam_step
from fvd_tpu_torch.models.synthetic_text import detector_batch, recognizer_batch
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary


def _to(device, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def rec_eval(model: ocr.CTCRecognizer, rng: np.random.RandomState, device) -> dict:
    """Exact-match rate and character accuracy on 32 fresh lines of ``rng``."""
    lines, _, texts = recognizer_batch(rng, 32)
    decoded = ocr.ctc_greedy_decode(ocr.recognize_forward(model, *_to(device, lines)).cpu().numpy())
    exact = sum(d == t for d, t in zip(decoded, texts)) / len(texts)
    char_ok = sum(sum(a == b for a, b in zip(d, t)) for d, t in zip(decoded, texts))
    char_total = sum(len(t) for t in texts)
    return {"exact": exact, "char_acc": char_ok / max(char_total, 1), "sample": [texts[0], decoded[0]]}


def det_eval(model: torch.nn.Module, rng: np.random.RandomState, device) -> float:
    """Pixel-mask IoU at 0.5 over 16 fresh scenes of ``rng``."""
    imgs, masks = detector_batch(rng, 16)
    pred = ocr.detect_forward(model, *_to(device, imgs)).cpu().numpy() > 0.5
    gt = masks > 0.5
    return float((pred & gt).sum() / max((pred | gt).sum(), 1))


def train_recognizer(steps: int, batch: int, width: int, out: str, device, seed: int = 0,
                     resume: bool = False, lr: float = 1e-3, augment: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    model = weights.seeded(ocr.CTCRecognizer(width=width), seed)
    if resume and os.path.exists(out):
        weights.load_npz(out, model)
        print(f"[rec] resumed params from {out}")
    model.to(device)
    opt = adam(model, lr)

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(steps):
        lines, labels, _ = timer.data(recognizer_batch, rng, batch, augment=augment)
        losses.append(timer.step(lambda: adam_step(ocr.ctc_loss, model, opt, *_to(device, lines, labels))))
        if i % 100 == 0 or i == steps - 1:
            print(f"[rec] step {i:4d} loss {float(losses[-1]):.3f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    ev = rec_eval(model, rng, device)
    print(f"[rec] eval: exact={ev['exact']:.2f} char_acc={ev['char_acc']:.2f} "
          f"sample: {ev['sample'][0]!r} -> {ev['sample'][1]!r}")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    weights.save_npz(out, model)
    print(f"[rec] saved {out}")
    return step_summary(timer, steps * batch, seconds, losses, unit="lines", eval_exact=ev["exact"],
                        eval_char_acc=ev["char_acc"])


def train_detector(steps: int, batch: int, width: int, out: str, device, seed: int = 1,
                   resume: bool = False, lr: float = 1e-3, augment: bool = False, arch: str = "v1") -> dict:
    rng = np.random.RandomState(seed)
    model = weights.seeded(ocr.DET_ARCHS[arch](width=width), seed)
    if resume and os.path.exists(out):
        weights.load_npz(out, model)
        print(f"[det] resumed params from {out}")
    model.to(device)
    opt = adam(model, lr)

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(steps):
        imgs, masks = timer.data(detector_batch, rng, batch, augment=augment)
        losses.append(timer.step(lambda: adam_step(ocr.detector_loss, model, opt, *_to(device, imgs, masks))))
        if i % 100 == 0 or i == steps - 1:
            print(f"[det] step {i:4d} loss {float(losses[-1]):.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    iou = det_eval(model, rng, device)
    print(f"[det] eval mask IoU: {iou:.3f}")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    weights.save_npz(out, model)
    with open(out.replace(".npz", ".json"), "w") as f:
        json.dump({"arch": arch, "width": width}, f)
    print(f"[det] saved {out} (arch={arch}, width={width})")
    return step_summary(timer, steps * batch, seconds, losses, arch=arch, width=width, eval_mask_iou=iou)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--rec-width", type=int, default=32)
    ap.add_argument("--det-width", type=int, default=None,
                    help="default: the arch's native width (v1: 16, v2: 128)")
    ap.add_argument("--det-arch", choices=["v1", "v2"], default="v1")
    ap.add_argument("--det-steps", type=int, default=None,
                    help="detector steps (default: max(200, steps // 3), as the JAX tool)")
    ap.add_argument("--out-dir", default="checkpoints")
    ap.add_argument("--only", choices=["rec", "det"], default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--augment", action="store_true",
                    help="font-diversity + shape jitter on half of each batch (non-held-out faces only; "
                         "see synthetic_text._train_font)")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    common = dict(resume=args.resume, lr=args.lr, augment=args.augment)
    out = {}
    if args.only in (None, "rec"):
        out["rec"] = train_recognizer(args.steps, args.batch, args.rec_width,
                                      os.path.join(args.out_dir, "ocr_rec.npz"), device, **common)
        print("[rec] summary " + json.dumps(out["rec"]), flush=True)
    if args.only in (None, "det"):
        det_width = args.det_width or ocr.DET_DEFAULT_WIDTH[args.det_arch]
        det_steps = args.det_steps if args.det_steps is not None else max(200, args.steps // 3)
        out["det"] = train_detector(det_steps, args.batch, det_width, os.path.join(args.out_dir, "ocr_det.npz"),
                                    device, arch=args.det_arch, **common)
        print("[det] summary " + json.dumps(out["det"]), flush=True)
    return out


if __name__ == "__main__":
    main()
