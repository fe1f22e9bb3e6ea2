"""Train the CLIP ViT-B/32-geometry model (vision 768 x 12, patch 32, image
224; text 512 x 12; projection 512) on the procedural scene domain:

    python -m fvd_tpu_torch.tools.pretrain_hf_clip --steps 3000 --batch 128
    python -m fvd_tpu_torch.tools.pretrain_hf_clip --cpu --tiny --steps 2 --batch 4 --pool 16 --out /tmp/clip

The counterpart of the JAX package's ``tools/pretrain_hf_clip.py``, with its
flags and defaults.  Without ``--resume`` (or without ``--out``) it
fabricates the model and tokenizer into ``--out`` (``--tiny``: 2-layer
64-wide towers); the model computes in bfloat16 on float32 parameters.

The pool is ``--pool`` text scenes ("text saying <X>", OpenCV 5's text from
``utils/text.py``), ``pool // 8`` procedural faces ("a person's face
looking at the camera", half of them photometrically randomised) and
``pool // 16`` textured backgrounds, drawn on the host at 224 px and
uploaded once with their caption ids and masks; each step the host draws
only the indices of ``--batch - 2`` distinct text scenes, one face and one
background, and the device gathers, normalises (CLIP's mean and std, then
bfloat16), runs both towers and takes the symmetric InfoNCE on the cosines
times ``exp(clip(logit_scale, 0, log 100))`` plus ``--band-weight`` times
the band term (matched cosines above ``--band-target``, mismatched below
0.05), and the clipped AdamW of ``hf_train.hf_optimizer`` steps.  The
held-out evaluation (64 text scenes, 8 faces, 4 backgrounds of
``RandomState(seed + 1)``) reports retrieval@1 over the text scenes and the
mean matched and mismatched cosines, from which the calibration
``cal_offset`` / ``cal_scale`` that ``providers/hf_models.HFClip`` reads is
written into ``fvd_train_meta.json``.  ``--promote`` copies ``--out`` in
float16 with the ``.json`` and ``.txt`` files.  A SIGTERM saves before
exiting.  It runs on the card unless ``--cpu`` is given, and raises where
there is none.

Its last line, ``[clip] summary {...}``, gives as JSON the steps, the median
host data ms and device ms of a step (CUDA events on the card), pairs per
second over the loop's wall time, the first and last loss, the evaluation,
the calibration and the parameter count.
"""

from __future__ import annotations

import argparse
import json
import os
import math
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.models.hf_clip import CLIPModel
from fvd_tpu_torch.models.optim import clipped_adamw_step
from fvd_tpu_torch.tools import hf_train
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer

SIZE = 224          # ViT-B/32 native input
MAX_LEN = 77        # CLIP text positions
FACE_CAPTION = "a person's face looking at the camera"
BG_CAPTION = "an empty textured background"
#: CLIP's pixel mean and std, the literals of the JAX tool (``tools/pretrain_hf_clip.py:217-218``)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
META = {"domain": "procedural-scenes", "train": "pretrain_hf_clip.py",
        "geometry": "clip-vit-b32 vision768x12p32 text512x12"}


def make_text_scene(rng: np.random.RandomState, text: str) -> np.ndarray:
    from fvd_tpu_torch.utils import cv, text as T

    img = (rng.rand(SIZE, SIZE, 3) * 70).astype(np.uint8)
    img = cv.blur_u8(img, 5)
    scale = rng.uniform(0.9, 1.4)
    y = rng.randint(60, SIZE - 20)
    T.put_text(img, text, (8, y), T.FONT_HERSHEY_SIMPLEX, scale, (235, 235, 235), 2)
    return img


def make_face_scene(rng: np.random.RandomState) -> np.ndarray:
    """A ``make_face_video``-style keyframe: a blurred background, one
    elliptical face at a random position, size and aperture, photometrically
    randomised half the time."""
    from fvd_tpu_torch.models.synthetic_faces import draw_face, photometric_randomize
    from fvd_tpu_torch.utils import cv

    img = (rng.rand(SIZE, SIZE, 3) * 60 + rng.rand(3) * 120).astype(np.uint8)
    img = cv.blur_u8(img, 5)
    skin = np.array([rng.randint(160, 230), rng.randint(120, 190), rng.randint(100, 170)])
    fh = SIZE * rng.uniform(0.35, 0.75)
    fw = fh / rng.uniform(1.1, 1.4)
    cx = rng.uniform(fw * 0.4, SIZE - fw * 0.4)
    cy = rng.uniform(fh * 0.4, SIZE - fh * 0.4)
    draw_face(img, cx, cy, fw, fh, skin, aperture=rng.rand())
    if rng.rand() < 0.5:
        img = photometric_randomize(img, rng)
    return img


def make_background(rng: np.random.RandomState) -> np.ndarray:
    from fvd_tpu_torch.utils import cv

    img = (rng.rand(SIZE, SIZE, 3) * rng.randint(40, 200)).astype(np.uint8)
    return cv.blur_u8(img, 13)


def build_pool(rng: np.random.RandomState, n_text: int, n_face: int, n_bg: int):
    """-> (images uint8 [M, 224, 224, 3], captions): text scenes with
    distinct texts first, then faces, then backgrounds."""
    from fvd_tpu_torch.models.synthetic_text import random_text

    images = np.zeros((n_text + n_face + n_bg, SIZE, SIZE, 3), np.uint8)
    captions, seen = [], set()
    for i in range(n_text):
        text = random_text(rng, 3, 12)
        while text in seen:
            text = random_text(rng, 3, 12)
        seen.add(text)
        images[i] = make_text_scene(rng, text)
        captions.append(f"text saying {text}")
    for i in range(n_face):
        images[n_text + i] = make_face_scene(rng)
        captions.append(FACE_CAPTION)
    for i in range(n_bg):
        images[n_text + n_face + i] = make_background(rng)
        captions.append(BG_CAPTION)
    return images, captions


def sample_batch(rng: np.random.RandomState, batch: int, n_text: int, n_face: int, n_bg: int) -> np.ndarray:
    """Pool indices with captions unique in the batch: ``batch - 2``
    distinct text scenes, one face, one background, shuffled."""
    idx = rng.choice(n_text, batch - 2, replace=False).astype(np.int32)
    face = n_text + rng.randint(n_face)
    bg = n_text + n_face + rng.randint(n_bg)
    out = np.concatenate([idx, [face], [bg]]).astype(np.int32)
    rng.shuffle(out)
    return out


def preprocess(pool: torch.Tensor, idx: torch.Tensor, dtype) -> torch.Tensor:
    """Gathered uint8 pixels -> CLIP-normalised [B, 224, 224, 3] in
    ``dtype``, normalised in float32 (in ``dtype`` where it is wider)."""
    wide = torch.promote_types(dtype, torch.float32)
    mean = torch.tensor(CLIP_MEAN, dtype=wide, device=pool.device)
    std = torch.tensor(CLIP_STD, dtype=wide, device=pool.device)
    return ((pool[idx].to(wide) / 255.0 - mean) / std).to(dtype)


def towers(model: CLIPModel, pixels, ids, mask):
    """Both embeddings in float32, each divided by its norm + 1e-8."""
    ie, te = model(pixels, ids, mask)
    return hf_train.unit(hf_train.wide(ie)), hf_train.unit(hf_train.wide(te))


def clip_loss(model: CLIPModel, pixels, ids, mask, band_weight: float, band_target: float):
    """-> (loss, mean matched cosine): the symmetric InfoNCE at the clipped
    learned scale plus ``band_weight`` times the C2 band term on the raw
    cosines."""
    ie, te = towers(model, pixels, ids, mask)
    cos = ie @ te.T
    scale = torch.exp(torch.clamp(model.logit_scale, 0.0, math.log(100.0)))
    diag = torch.diagonal(cos)
    off = cos - torch.eye(cos.shape[0], dtype=cos.dtype, device=cos.device) * cos
    band = torch.mean(torch.relu(band_target - diag) ** 2) + torch.mean(torch.relu(off - 0.05) ** 2)
    return hf_train.symmetric_ce(cos * scale) + band_weight * band, diag.mean()


def clip_step_loss(model, pool, ids, mask, idx, band_weight, band_target, aux):
    """The train step's loss from pool indices on the device; the mean
    matched cosine goes into ``aux``."""
    dt = input_dtype(model)
    loss, dmean = clip_loss(model, preprocess(pool, idx, dt), ids[idx], mask[idx], band_weight, band_target)
    aux.append(dmean.detach())
    return loss


def input_dtype(model: CLIPModel) -> torch.dtype:
    """The pixels' dtype: the compute dtype, else the parameters'."""
    return model.compute_dtype or next(model.parameters()).dtype


@torch.no_grad()
def evaluate(model: CLIPModel, ev_pool, ev_ids, ev_mask, n_text: int):
    """-> (retrieval@1 over the text scenes, mean matched, mean mismatched cosine)."""
    idx = torch.arange(ev_pool.shape[0], device=ev_pool.device)
    ie, te = towers(model, preprocess(ev_pool, idx, input_dtype(model)), ev_ids, ev_mask)
    cos = (ie @ te.T).cpu().numpy()
    sub = cos[:n_text, :n_text]
    r_at_1 = float((sub.argmax(axis=1) == np.arange(n_text)).mean())
    diag = float(np.diag(cos).mean())
    off = float((cos.sum() - np.trace(cos)) / (cos.size - cos.shape[0]))
    return r_at_1, diag, off


def run(argv=None):
    """The tool on ``argv`` -> (the trained model, the summary, ``replay``:
    a model's mean loss over the run's batches drawn again)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--pool", type=int, default=2304,
                    help="text-scene pool size (faces/backgrounds added on top: pool//8 faces, pool//16 backgrounds)")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--band-weight", type=float, default=2.0, help="weight of the C2 cosine-band shaping term")
    ap.add_argument("--band-target", type=float, default=0.35,
                    help="matched-cosine floor the band term enforces (the C2 Consistent threshold is 0.25)")
    ap.add_argument("--out", default="checkpoints/hf_staging/clip")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer 64d towers: a smoke test of the trainer, not a capability run")
    ap.add_argument("--promote", default=None,
                    help="after training+eval, copy --out to this dir as float16 (e.g. checkpoints/hf/clip)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(hf_train.device_line(device), flush=True)
    if not (args.resume and os.path.isdir(args.out)):
        from fvd_tpu_torch.tools.make_hf_geometry_checkpoints import make_clip

        print("fabricating CLIP ViT-B/32-geometry model + tokenizer...", flush=True)
        make_clip(args.out, tiny=args.tiny)
    tok = Tokenizer.from_dir(args.out)
    model = hf_train.load_for_training(CLIPModel, "clip", args.out, device)
    n_params = hf_train.count_params(model)
    print(f"[clip] params: {n_params}", flush=True)
    img_size = hf_train.read_config(args.out)["vision_config"]["image_size"]
    if img_size != SIZE:
        raise ValueError(f"{args.out}: image size {img_size}, the scenes are {SIZE}")

    rng = np.random.RandomState(args.seed)
    n_face, n_bg = max(args.pool // 8, 16), max(args.pool // 16, 8)
    t0 = time.perf_counter()
    print(f"rendering pool: {args.pool} text + {n_face} face + {n_bg} bg...", flush=True)
    pool_imgs, pool_caps = build_pool(rng, args.pool, n_face, n_bg)
    enc = tok(pool_caps, MAX_LEN)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool_dev = torch.from_numpy(pool_imgs).to(device)
    ids_dev = torch.from_numpy(enc["input_ids"]).to(device)
    mask_dev = torch.from_numpy(enc["attention_mask"]).to(device)
    print(f"pool rendered in {render_s:.1f}s, {pool_imgs.nbytes / 1e6:.0f} MB on {pool_dev.device} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    ev_imgs, ev_caps = build_pool(np.random.RandomState(args.seed + 1), 64, 8, 4)
    ev_enc = tok(ev_caps, MAX_LEN)
    ev = (torch.from_numpy(ev_imgs).to(device), torch.from_numpy(ev_enc["input_ids"]).to(device),
          torch.from_numpy(ev_enc["attention_mask"]).to(device))

    opt, sched = hf_train.hf_optimizer(model, args.lr, args.warmup, args.steps)
    #: held-out calibration onto the reference CLIP's band, written at the final save
    cal: dict = {}

    def save(tag=""):
        hf_train.save_tree(model, "clip", args.out)
        hf_train.write_meta(args.out, {"domain": META["domain"], "train": META["train"], "steps": args.steps,
                                       "pool": args.pool, "seed": args.seed, "geometry": META["geometry"], **cal})
        print(f"[save{tag}] -> {args.out} ({cal or 'no cal yet'})", flush=True)

    data_rng = np.random.RandomState(args.seed + 7)
    timer, losses, aux = StepTimer(device), [], []
    with hf_train.save_on_sigterm(save):
        t0 = time.perf_counter()
        for i in range(args.steps):
            idx = torch.from_numpy(timer.data(sample_batch, data_rng, args.batch, args.pool, n_face,
                                              n_bg)).to(device, torch.int64)
            loss = timer.step(lambda: clipped_adamw_step(clip_step_loss, model, opt, sched, pool_dev, ids_dev,
                                                         mask_dev, idx, args.band_weight, args.band_target, aux))
            losses.append(loss)
            if i % 50 == 0 or i == args.steps - 1:
                print(f"[clip] step {i:5d} loss {float(loss):.4f} diag-cos {float(aux[-1]):.3f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
            if args.eval_every and i > 0 and i % args.eval_every == 0:
                r1, dg, off = evaluate(model, *ev, 64)
                print(f"[clip] step {i}: held-out retrieval@1={r1:.3f} diag={dg:.3f} off={off:.3f}", flush=True)
            if args.save_every and i > 0 and i % args.save_every == 0:
                save(f"@{i}")
        seconds = time.perf_counter() - t0

        r1, dg, off = evaluate(model, *ev, 64)
        print(f"[clip] FINAL held-out: retrieval@1={r1:.3f} diag-cos={dg:.3f} off-cos={off:.3f}", flush=True)
        cal.update(cal_offset=round(off, 6), cal_scale=round(0.35 / max(dg - off, 1e-6), 6))
        save()
    if args.promote:
        hf_train.promote_f16(model, "clip", args.out, args.promote)
        print(f"promoted (f16) -> {args.promote}", flush=True)
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="pairs", retrieval_at_1=r1,
                           diag_cos=dg, off_cos=off, params=n_params, pool_s=render_s, **cal,
                           loss_curve=hf_train.loss_curve(losses))
    print("[clip] summary " + json.dumps(summary), flush=True)

    @torch.no_grad()
    def replay(m) -> float:
        rng, out = np.random.RandomState(args.seed + 7), []
        for _ in range(args.steps):
            idx = torch.from_numpy(sample_batch(rng, args.batch, args.pool, n_face, n_bg)).to(device, torch.int64)
            out.append(float(clip_step_loss(m, pool_dev, ids_dev, mask_dev, idx, args.band_weight,
                                            args.band_target, [])))
        return float(np.mean(out))

    return model, summary, replay


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
