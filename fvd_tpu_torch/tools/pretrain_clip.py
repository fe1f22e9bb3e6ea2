"""Contrastively pretrain the CLIP dual towers on procedural scenes, and
write the npz checkpoint and sidecar the providers load:

    python -m fvd_tpu_torch.tools.pretrain_clip --steps 1200 --batch 32
    python -m fvd_tpu_torch.tools.pretrain_clip --steps 2 --dim 32 --depth 1 --batch 8 --cpu --out /tmp/clip/clip.npz

The counterpart of the JAX package's ``tools/pretrain_clip.py``, with its
flags and defaults.  Pairs are rendered text scenes with "text saying
<STRING>" captions, procedural faces with "a person's face ..." and plain
textures with "an empty background"; the loss is the symmetric InfoNCE of
``encoders.clip_loss`` over in-batch negatives (unique captions), with Adam
from ``weights.seeded`` (seed 0), or from ``--out`` with ``--resume``.  It
runs on the card unless ``--cpu`` is given, and raises where there is none.

The batches equal the JAX package's for the same ``--seed`` (captions, token
ids, images and RNG state).  After training, retrieval@1 and the
matched-vs-mismatched margin on a fresh batch are printed, and the sidecar
``clip.json`` gets ``dim``, ``depth``, ``out_dim`` and the calibration onto
the reference CLIP's cosine scale, ``cal_offset`` (mean mismatched cosine)
and ``cal_scale`` (0.35 over matched minus mismatched), from that batch.
One last line ``[clip] summary {...}`` gives, as JSON: the steps, the median
host data ms and device ms of a step (CUDA events on the card), pairs per
second, the first and last loss, and the eval.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models.encoders import IMAGE_SIZE, MAX_TEXT_LEN, ClipModel, clip_loss
from fvd_tpu_torch.models.layers import adam, adam_step
from fvd_tpu_torch.models.synthetic_faces import render_face
from fvd_tpu_torch.models.synthetic_text import random_text
from fvd_tpu_torch.models.transformer import ByteTokenizer
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary
from fvd_tpu_torch.utils import cv
from fvd_tpu_torch.utils import text as T


def make_pair(rng: np.random.RandomState):
    """-> (image uint8 [112, 112, 3], caption str)."""
    kind = rng.randint(3)
    if kind == 0:  # text scene
        text = random_text(rng, 3, 10)
        img = cv.blur_u8((rng.rand(IMAGE_SIZE, IMAGE_SIZE, 3) * 70).astype(np.uint8), 3)
        scale = rng.uniform(0.45, 0.7)
        y = rng.randint(30, IMAGE_SIZE - 10)
        T.put_text(img, text, (4, y), T.FONT_HERSHEY_SIMPLEX, scale, (235, 235, 235), 2)
        return img, f"text saying {text}"
    if kind == 1:  # face scene
        face, _, _ = render_face(rng, IMAGE_SIZE)
        return face, "a person's face looking at the camera"
    img = (rng.rand(IMAGE_SIZE, IMAGE_SIZE, 3) * rng.randint(40, 200)).astype(np.uint8)
    return cv.blur_u8(img, 7), "an empty textured background"


def clip_batch(rng: np.random.RandomState, batch: int, tok: ByteTokenizer, max_len: int):
    """(images float [B, 112, 112, 3] in 0..1, ids [B, max_len] int32,
    captions), the captions unique within the batch."""
    images = np.zeros((batch, IMAGE_SIZE, IMAGE_SIZE, 3), np.float32)
    ids = np.zeros((batch, max_len), np.int32)
    captions = []
    seen = set()
    for i in range(batch):
        img, caption = make_pair(rng)
        while caption in seen:  # in-batch negatives need unique captions
            img, caption = make_pair(rng)
        seen.add(caption)
        images[i] = img.astype(np.float32) / 255.0
        ids[i] = tok.encode(caption, max_len)
        captions.append(caption)
    return images, ids, captions


@torch.no_grad()
def clip_eval(model: ClipModel, images: torch.Tensor, ids: torch.Tensor) -> dict:
    """Retrieval@1 and the matched-vs-mismatched logit margin of one batch,
    and the calibration of its cosines: ``cal_offset`` the mean mismatched
    cosine, ``cal_scale`` 0.35 over (mean matched - mean mismatched), in the
    model's dtype as the JAX tool computes them."""
    logits = model(images, ids).cpu().numpy()
    n = logits.shape[0]
    diag = np.diag(logits)
    off = (logits.sum(axis=1) - diag) / (n - 1)
    cos = (model.encode_image(images) @ model.encode_text(ids).T).cpu().numpy()
    d = np.diag(cos)
    o = (cos.sum(1) - d) / (n - 1)
    return {"retrieval_at_1": float((logits.argmax(axis=1) == np.arange(n)).mean()),
            "margin": float((diag - off).mean()), "cal_offset": float(o.mean()),
            "cal_scale": float(0.35 / max(d.mean() - o.mean(), 1e-6))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--out", default="checkpoints/clip.npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    rng = np.random.RandomState(args.seed)
    tok = ByteTokenizer()
    model = weights.seeded(ClipModel(dim=args.dim, depth=args.depth, out_dim=args.dim), 0)
    if args.resume and os.path.exists(args.out):
        weights.load_npz(args.out, model)
        print(f"[clip] resumed params from {args.out}")
    model.to(device)
    opt = adam(model, args.lr)

    def to_dev(images, ids):
        return torch.from_numpy(images).to(device), torch.from_numpy(ids).to(device)

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(args.steps):
        images, ids, _ = timer.data(clip_batch, rng, args.batch, tok, MAX_TEXT_LEN)
        losses.append(timer.step(lambda: adam_step(clip_loss, model, opt, *to_dev(images, ids))))
        if i % 100 == 0 or i == args.steps - 1:
            print(f"[clip] step {i:4d} loss {float(losses[-1]):.3f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    images, ids, _ = clip_batch(rng, 32, tok, MAX_TEXT_LEN)
    ev = clip_eval(model, *to_dev(images, ids))
    print(f"[clip] eval: retrieval@1={ev['retrieval_at_1']:.2f} "
          f"matched-vs-mismatched margin={ev['margin']:.3f}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    weights.save_npz(args.out, model)
    with open(args.out.replace(".npz", ".json"), "w") as f:
        json.dump({"dim": args.dim, "depth": args.depth, "out_dim": args.dim,
                   "cal_offset": ev["cal_offset"], "cal_scale": ev["cal_scale"]}, f)
    print(f"[clip] saved {args.out} (dim={args.dim}, depth={args.depth})")
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="pairs",
                           **{f"eval_{k}": v for k, v in ev.items()})
    print("[clip] summary " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
