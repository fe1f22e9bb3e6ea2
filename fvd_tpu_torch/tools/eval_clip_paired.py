"""Paired evaluation of a trained CLIP ViT-B/32-geometry checkpoint against
the dim-192 CLIP:

    python -m fvd_tpu_torch.tools.eval_clip_paired --new checkpoints/hf_staging/clip \
        [--old checkpoints/clip.npz] [--n 24] [--json out.json] [--cpu]

The counterpart of the JAX package's ``tools/eval_clip_paired.py``, with its
flags, printed lines and JSON: the adoption gate of a real-geometry C2
model.  Both providers score the SAME fresh scenes (a held-out seed; the
trainer's three pair families at 224 pixels, ``pretrain_hf_clip.build_pool``),
each through its own inference convention: the dim-192 ``JaxClip`` through
its calibrated 112-pixel towers (its sidecar's accepted settings), the HF
checkpoint through ``HFClip`` (raw cosines, or its own calibration).

Per provider:

* retrieval@1 over the unique-caption text scenes (the image x caption
  cosine matrix, argmax per image);
* the matched-minus-mismatched cosine margin;
* C2's band correctness: the share of matched pairs above the Consistent
  threshold (``CONSISTENT_T`` 0.25) and of mismatched pairs below
  Inconsistent (``INCONSISTENT_T`` 0.15).  The gate takes the balanced
  rate ((+) + (-)) / 2: a checkpoint can buy band(+) 1.0 by compressing
  the matched variance through its calibration while leaving mismatched
  pairs above Inconsistent, and C2's decisions need both sides;
* a keyframe probe: ``make_face_scene`` frames against transcript-like
  phrases (C2's benchmark-time pairing), reported for visibility.

Gate: new >= old on retrieval@1, margin and the balanced band rate; null
without ``--old``.  The models run on the card unless ``--cpu`` is given;
without a card that raises.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os

import numpy as np

CONSISTENT_T = 0.25
INCONSISTENT_T = 0.15


def cross_scores(provider, images, texts, chunk: int = 512) -> np.ndarray:
    """[n_images, n_texts] similarity matrix through the provider's own
    paired batch API (images repeated, texts tiled)."""
    n_i, n_t = len(images), len(texts)
    pairs_i, pairs_t = [], []
    for i in range(n_i):
        for t in range(n_t):
            pairs_i.append(images[i])
            pairs_t.append(texts[t])
    out = np.zeros(n_i * n_t, np.float32)
    for s in range(0, len(pairs_i), chunk):
        out[s:s + chunk] = provider.image_text_similarity_batch(pairs_i[s:s + chunk], pairs_t[s:s + chunk])
    return out.reshape(n_i, n_t)


def provider_metrics(provider, images, captions, kf_images, kf_texts) -> dict:
    cos = cross_scores(provider, images, captions)
    n = len(images)
    diag = np.diag(cos)
    off = (cos.sum() - np.trace(cos)) / (cos.size - n)
    r1 = float((cos.argmax(axis=1) == np.arange(n)).mean())
    matched_ok = float((diag > CONSISTENT_T).mean())
    off_mask = ~np.eye(n, dtype=bool)
    mismatched_ok = float((cos[off_mask] < INCONSISTENT_T).mean())
    kf = provider.image_text_similarity_batch(kf_images, kf_texts)
    return {
        "retrieval_at_1": r1,
        "margin": float(diag.mean() - off),
        "diag_mean": float(diag.mean()),
        "off_mean": float(off),
        "band_matched_gt_025": matched_ok,
        "band_mismatched_lt_015": mismatched_ok,
        "keyframe_vs_transcript_mean": float(np.mean(kf)),
        "keyframe_vs_transcript_max": float(np.max(kf)),
    }


def balanced_band(m: dict) -> float:
    return (m["band_matched_gt_025"] + m["band_mismatched_lt_015"]) / 2


def meets_gate(new: dict, old) -> bool | None:
    """new >= old on retrieval@1, margin and the balanced band rate; None
    without an old provider's metrics."""
    if old is None:
        return None
    return bool(new["retrieval_at_1"] >= old["retrieval_at_1"] and new["margin"] >= old["margin"]
                and balanced_band(new) >= balanced_band(old))


def scenes(seed: int, n: int):
    """(images, captions, keyframe images, keyframe texts) of the held-out
    seed: ``n`` text scenes, 2 face scenes and 1 background of the trainer's
    pool, then 8 face frames and 8 three-phrase transcripts."""
    from fvd_tpu_torch.models.synthetic_text import random_text
    from fvd_tpu_torch.tools.pretrain_hf_clip import build_pool, make_face_scene

    rng = np.random.RandomState(seed)
    imgs, caps = build_pool(rng, n, 2, 1)
    images = [imgs[i] for i in range(len(imgs))]
    # face frames against transcript-phrase captions (C2's benchmark-time
    # pairing): no learnable correspondence, so the scores should sit in or
    # below the ambiguous band, far under the matched one
    kf_images = [make_face_scene(rng) for _ in range(8)]
    kf_texts = [" ".join(random_text(rng, 3, 8) for _ in range(3)) for _ in range(8)]
    return images, caps, kf_images, kf_texts


def old_clip(path: str, device):
    """The npz ``JaxClip`` of ``path`` with the sidecar's settings its
    constructor accepts."""
    from fvd_tpu_torch.models import encoders

    kwargs = {}
    meta_path = path.replace(".npz", ".json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        accepted = set(inspect.signature(encoders.JaxClip.__init__).parameters) - {"device"}
        kwargs = {k: v for k, v in meta.items() if k in accepted}
    return encoders.JaxClip(checkpoint=path, device=device, **kwargs)


def main(argv=None) -> int:
    from fvd_tpu_torch import resolve_device
    from fvd_tpu_torch.providers.hf_models import HFClip

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--new", default="checkpoints/hf_staging/clip")
    ap.add_argument("--old", default="checkpoints/clip.npz")
    ap.add_argument("--n", type=int, default=24, help="text scenes for the retrieval matrix (n^2 pairs)")
    ap.add_argument("--seed", type=int, default=20260821)
    ap.add_argument("--cpu", action="store_true", help="score on the CPU instead of the card")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    images, caps, kf_images, kf_texts = scenes(args.seed, args.n)
    new = HFClip.from_local(args.new, device=device)
    results = {"new": provider_metrics(new, images, caps, kf_images, kf_texts)}
    old_metrics = None
    if os.path.exists(args.old):
        old_metrics = provider_metrics(old_clip(args.old, device), images, caps, kf_images, kf_texts)
        results["old"] = old_metrics

    for name in results:
        m = results[name]
        print(f"[{name}] retrieval@1={m['retrieval_at_1']:.3f} "
              f"margin={m['margin']:.3f} "
              f"diag={m['diag_mean']:.3f} off={m['off_mean']:.3f} "
              f"band(+)={m['band_matched_gt_025']:.3f} "
              f"band(-)={m['band_mismatched_lt_015']:.3f} "
              f"kf-vs-transcript={m['keyframe_vs_transcript_mean']:.3f}")
    results["meets_verdict_gate"] = meets_gate(results["new"], old_metrics)
    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
