"""Calibrate the LR fusion weights on the framework's own labeled corpus:

    python -m fvd_tpu_torch.tools.calibrate_lr [--cpu] [--n-real 6 --n-fake 8 ...]
    python -m fvd_tpu_torch.tools.calibrate_lr --refit-from-meta --out lr_weights_calibrated.json

The counterpart of the JAX package's ``tools/calibrate_lr.py``, with its
flags, fit and files.  The shipped ``assets/lr_weights_pretrained.json`` is
the reference's trained vector: its decision boundary was fit to the
reference's 11-video corpus, and on this framework's feature distribution it
ranks fakes above reals without putting the fake above the 0.5 verdict
threshold.  This tool runs the 16-node DAG on a generated labeled corpus
(``make_labeled_corpus``'s plain fakes, ambiguous fakes and hard reals),
fits a vector by full-batch logistic regression under sign constraints,
validates it on a corpus of fresh seeds, and writes the vector and a
``*_meta.json`` holding the accuracies and the feature matrices.
``--refit-from-meta`` refits from those matrices in seconds.

It runs on the card unless ``--cpu`` is given.  ``--out`` defaults to
``lr_weights_calibrated.json`` in the working directory, never into
``assets/``, whose vector the JAX package's bench probe and tests read.
The corpora (raw-RGBA clips, ~90 MB per 10 s clip) are deleted when the
features are taken.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np

FEATURES = ("speech_rate", "pause_ratio", "lip_sync", "gesture_score",
            "blink_rate", "headpose_jerk", "texture", "claim_reliability",
            "evidence_reliability")

#: sign constraints matching the reference's trained semantics (supported
#: claims and reliable evidence argue real; texture argues fake): an
#: 18-sample fit can invert these through collinearity with the hard-real
#: recipes (claimless noisy reals), and a semantically backwards vector
#: must not ship even if it classifies
SIGN = {"claim_reliability": -1, "evidence_reliability": -1, "texture": +1,
        "lip_sync": -1}

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pipeline_features(videos, labels, config, providers, device=None):
    """Run the full 16-node DAG per video on ``device`` (default the card);
    -> (X, y), the feature matrix and the labels."""
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State

    dag = build_graph(config, providers, device=device)
    X, y = [], []
    for path, label in zip(videos, labels):
        t0 = time.perf_counter()
        final = Scheduler(dag).invoke(State(input_path=path))
        feats = final.features or {}
        X.append([float(feats.get(k, 0.0)) for k in FEATURES])
        y.append(label)
        print(f"  {os.path.basename(path):34s} label={label} "
              f"p_ref={final.fake_probability:.3f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return np.asarray(X, np.float64), np.asarray(y, np.float64)


def fit_lr(X, y, l2=1e-3, lr=0.5, epochs=4000):
    """Full-batch projected-GD logistic regression (bias unregularized;
    SIGN-constrained coordinates projected each step)."""
    n, d = X.shape
    w = np.zeros(d)
    b = 0.0
    signs = np.array([SIGN.get(k, 0) for k in FEATURES], np.float64)
    for _ in range(epochs):
        z = X @ w + b
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
        g = p - y
        w -= lr * (X.T @ g / n + l2 * w)
        b -= lr * g.mean()
        w = np.where(signs > 0, np.maximum(w, 0.0),
                     np.where(signs < 0, np.minimum(w, 0.0), w))
    return w, b


def predict(X, w, b):
    return 1.0 / (1.0 + np.exp(-np.clip(X @ w + b, -30, 30)))


def build(args, seed_shift, out):
    """The corpus of ``args`` in ``out``, its seeds shifted by ``seed_shift``
    (the train corpus takes 0 and validation 50: the same families, fresh
    instances) -> (paths, labels)."""
    from fvd_tpu_torch.tools.make_labeled_corpus import build_corpus

    paths = build_corpus(out, args.n_real, args.n_fake, args.duration,
                         fps=args.fps, n_ambiguous=args.ambiguous,
                         n_hard_real=args.hard_reals, seed_offset=seed_shift)
    labels = [0 if "_real_" in os.path.basename(p) else 1 for p in paths]
    return paths, labels


def _payload(w, b):
    payload = {"bias": float(b)}
    payload.update({k: float(v) for k, v in zip(FEATURES, w)})
    return payload


def refit_from_meta(out: str) -> int:
    """Refit from ``<out>_meta.json``'s train matrix (hard reals left out of
    the fit), score its validation matrix, and write both files again."""
    meta_path = out.replace(".json", "_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    Xtr = np.asarray(meta["train"]["X"])
    ytr = np.asarray(meta["train"]["y"])
    fit_rows = [i for i, v in enumerate(meta["train"]["videos"])
                if "_real_vlog" not in v]
    w, b = fit_lr(Xtr[fit_rows], ytr[fit_rows])
    Xv, yv = np.asarray(meta["val"]["X"]), np.asarray(meta["val"]["y"])
    pv = predict(Xv, w, b)
    acc_v = float(np.mean((pv > 0.5) == yv))
    with open(out, "w") as f:
        json.dump(_payload(w, b), f, indent=2)
    meta["val_acc"] = acc_v
    meta["fit"] = "refit-from-meta, hard reals excluded"
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"refit saved {out} (val acc {acc_v:.3f}; "
          f"p(val)={np.round(pv, 3).tolist()})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the pipeline on the CPU instead of the card")
    ap.add_argument("--n-real", type=int, default=6)
    ap.add_argument("--n-fake", type=int, default=8)
    ap.add_argument("--ambiguous", type=int, default=2)
    ap.add_argument("--hard-reals", type=int, default=2)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--out", default="lr_weights_calibrated.json")
    ap.add_argument("--refit-from-meta", action="store_true",
                    help="refit from the persisted feature matrices in "
                         "*_meta.json (seconds) instead of re-running the "
                         "pipeline (tens of minutes)")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    if args.refit_from_meta:
        return refit_from_meta(out)

    from fvd_tpu_torch import resolve_device
    from fvd_tpu_torch.config import EvidenceConfig, default_config
    from fvd_tpu_torch.providers.factory import production_providers

    device = resolve_device("cpu" if args.cpu else "cuda")
    config = dataclasses.replace(
        default_config(), evidence=EvidenceConfig(rate_limit_s=0.0, max_workers=4))
    providers = production_providers(checkpoint_dir=os.path.join(REPO, "checkpoints"),
                                     recorded_services=True, device=device)
    scratch = tempfile.mkdtemp(prefix="fvd_calib_run_")
    cwd = os.getcwd()
    os.chdir(scratch)  # nodes write cwd-relative artifacts
    try:
        print("— train corpus —", flush=True)
        train_videos, train_labels = build(args, 0, os.path.join(scratch, "train"))
        Xtr, ytr = pipeline_features(train_videos, train_labels, config, providers, device)
        shutil.rmtree(os.path.join(scratch, "train"))
        # hard reals (_real_vlog: sensor noise + claimless speech) are
        # designed false positives; in the fit they pull the texture weight
        # toward zero through label conflict, so they are left out of the
        # fit and kept in the corpus for reporting
        fit_rows = [i for i, v in enumerate(train_videos)
                    if "_real_vlog" not in os.path.basename(v)]
        w, b = fit_lr(Xtr[fit_rows], ytr[fit_rows])
        ptr = predict(Xtr, w, b)
        acc_tr = float(np.mean((ptr > 0.5) == ytr))
        print(f"train acc {acc_tr:.3f}  p(real) {ptr[np.asarray(ytr) == 0].round(3)}"
              f"  p(fake) {ptr[np.asarray(ytr) == 1].round(3)}", flush=True)

        print("— fresh-seed validation corpus —", flush=True)
        val_videos, val_labels = build(args, 50, os.path.join(scratch, "val"))
        Xv, yv = pipeline_features(val_videos, val_labels, config, providers, device)
        pv = predict(Xv, w, b)
        acc_v = float(np.mean((pv > 0.5) == yv))
        print(f"val acc {acc_v:.3f}  p(real) {pv[np.asarray(yv) == 0].round(3)}"
              f"  p(fake) {pv[np.asarray(yv) == 1].round(3)}", flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(scratch, ignore_errors=True)

    with open(out, "w") as f:
        json.dump(_payload(w, b), f, indent=2)
    meta = {"train_acc": acc_tr, "val_acc": acc_v,
            "corpus": {"n_real": args.n_real, "n_fake": args.n_fake,
                       "ambiguous": args.ambiguous, "hard_reals": args.hard_reals,
                       "duration": args.duration, "fps": args.fps},
            "sign_constraints": SIGN,
            # the raw fit data, so a refit needs no pipeline runs
            "train": {"X": Xtr.tolist(), "y": ytr.tolist(),
                      "videos": [os.path.basename(v) for v in train_videos]},
            "val": {"X": Xv.tolist(), "y": yv.tolist(),
                    "videos": [os.path.basename(v) for v in val_videos]},
            "date": time.strftime("%Y-%m-%d")}
    with open(out.replace(".json", "_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(f"saved {out}  (train {acc_tr:.3f} / val {acc_v:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
