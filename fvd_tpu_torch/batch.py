"""Batch evaluation / training harness: the port of ``fvd_tpu/batch.py``.

Reference behavior (``batch_test.py:13-198``): scan ``videos/*.mp4`` sorted
by probed duration; label from filename keywords (deepfake/fake/ai/
synthesia); fast path recomputes LR locally from the feature cache
(skipping the pipeline); slow path runs the full pipeline; ``--train``
retries each video up to 100x with online SGD until the prediction matches
the label; writes a ``batch_results.txt`` table + accuracy summary.

    python -m fvd_tpu_torch.batch [--videos-dir D] [--concurrency N] [--train]
                                  [--train-device] [--clear-cache] [--cpu]

runs on the card unless ``--cpu`` is given.  ``--concurrency N`` scores the
videos the feature cache does not hold N at a time
(:func:`run_pipeline_many`, with cross-video coalescing of the model
forwards and device programs).  ``--train-device`` replays the whole cached
feature corpus on the device (``ops/fusion.train_until_correct``): the same
sequential replay the reference does in Python, minus the per-video process
spawns.  On a machine with more than one visible card, ``main`` installs a
data-parallel inference mesh over them for the run
(:mod:`fvd_tpu_torch.parallel.inference`): the coalesced detector, landmark,
pose and OCR forwards split over every card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.graph import build_graph
from fvd_tpu_torch.nodes.lr_fusion import load_weights, save_weights
from fvd_tpu_torch.ops import fusion
from fvd_tpu_torch.parallel.inference import set_inference_mesh
from fvd_tpu_torch.parallel.mesh import make_mesh, visible_devices
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.coalesce import coalesce_providers
from fvd_tpu_torch.providers.media import VideoReader
from fvd_tpu_torch.runtime.scheduler import Scheduler
from fvd_tpu_torch.state import State

LABEL_KEYWORDS = ("deepfake", "fake", "ai", "synthesia")  # batch_test.py:33-37


def get_label(filename: str) -> int:
    name = os.path.basename(filename).lower()
    return 1 if any(k in name for k in LABEL_KEYWORDS) else 0


def get_videos(videos_dir: str = "videos") -> List[str]:
    """All mp4s sorted by probed duration ascending (batch_test.py:27-31)."""
    reader = VideoReader()
    paths = glob.glob(os.path.join(videos_dir, "*.mp4"))

    def duration(p: str) -> float:
        meta = reader.probe(p)
        return meta.duration if meta else 0.0

    return sorted(paths, key=duration)


def run_local_lr(video_path: str, label: Optional[int], train: bool, config: Config) -> Optional[float]:
    """Feature-cache fast path (batch_test.py:41-89): recompute the LR score
    from cached features + current weights; optional SGD update."""
    name = os.path.basename(video_path)
    feature_file = os.path.join(config.fusion.features_dir, f"{name}.json")
    if not os.path.exists(feature_file):
        return None
    try:
        with open(feature_file) as f:
            features = json.load(f)
    except (OSError, ValueError):
        return None

    weights = load_weights(config.fusion.weights_path)
    if train and label in (0, 1):
        weights, prob = fusion.sgd_update_host(features, weights, label, lr=config.fusion.learning_rate)
        save_weights(config.fusion.weights_path, weights)
        return prob
    return fusion.predict_host(features, weights)


def run_pipeline(video_path: str, label: Optional[int], config: Config, providers: Optional[Providers] = None,
                 device=None) -> Optional[float]:
    """Slow path: full in-process pipeline run on ``device`` (default the
    card; no subprocess spawn, so the models stay loaded across videos)."""
    dag = build_graph(config, providers or get_providers(), device=device)
    state = State(input_path=video_path, debug=config.debug)
    if label is not None:
        state.label = label
    try:
        final = Scheduler(dag).invoke(state)
        return final.fake_probability
    except Exception as e:
        print(f"ERROR running pipeline for {video_path}: {e}")
        return None


def run_pipeline_many(video_paths: List[str], config: Config, providers: Optional[Providers] = None,
                      concurrency: int = 2, device=None) -> List[Optional[float]]:
    """Evaluate several videos with overlapped pipelines: while one video's
    host work (decode, file I/O, tracking) runs, another's device programs
    execute.  Above one at a time the bundle is wrapped for cross-video
    coalescing (:func:`coalesce_providers`), so concurrent pipelines'
    detector, landmark, OCR and CLIP forwards and their per-video programs
    merge into single forwards.  Unlabeled scoring only (online training
    stays sequential for weight determinism)."""
    providers = providers or get_providers()
    close = lambda: None  # noqa: E731
    if concurrency > 1:
        providers, close = coalesce_providers(providers)
    try:
        with ThreadPoolExecutor(max_workers=max(1, concurrency)) as pool:
            futures = [pool.submit(run_pipeline, path, None, config, providers, device) for path in video_paths]
            return [f.result() for f in futures]
    finally:
        close()


def evaluate_video(video_path: str, train: bool, max_retries: int, config: Config,
                   providers: Optional[Providers] = None, device=None) -> Tuple[Optional[float], int]:
    """(final probability, attempts). With --train, retry until the
    thresholded prediction matches the label (batch_test.py:158-189)."""
    label = get_label(video_path)
    attempts = 0
    prob: Optional[float] = None
    retries = max_retries if train else 1
    for _ in range(retries):
        attempts += 1
        prob = run_local_lr(video_path, label, train, config)
        if prob is None:
            prob = run_pipeline(video_path, label if train else None, config, providers, device)
        if prob is None:
            return None, attempts
        predicted = 1 if prob > 0.5 else 0
        if not train or predicted == label:
            break
    return prob, attempts


def train_device(config: Config, device=None) -> Optional[str]:
    """Corpus replay on ``device`` (default the card): load every cached
    feature vector, run the per-video SGD loops, persist the weights."""
    dev = resolve_device(device)
    files = sorted(glob.glob(os.path.join(config.fusion.features_dir, "*.json")))
    if not files:
        return None
    names, feats, labels = [], [], []
    for f in files:
        with open(f) as fh:
            features = json.load(fh)
        names.append(os.path.basename(f)[: -len(".json")])
        feats.append(fusion.features_to_vector(features))
        labels.append(float(get_label(names[-1])))
    w, b = fusion.weights_to_vectors(load_weights(config.fusion.weights_path))
    w2, b2, iters = fusion.train_until_correct(
        torch.from_numpy(np.stack(feats)).to(dev),
        torch.tensor(labels, dtype=torch.float32, device=dev),
        torch.from_numpy(w).to(dev),
        torch.from_numpy(b).to(dev),
        lr=config.fusion.learning_rate,
    )
    save_weights(config.fusion.weights_path, fusion.vectors_to_weights(w2.cpu().numpy(), b2.cpu().numpy()))
    return f"device-trained on {len(names)} cached videos, iters={iters.cpu().numpy().tolist()}"


def format_results(rows: List[Tuple[str, int, Optional[float]]]) -> str:
    """The reference's results table (batch_test.py:191-195 format)."""
    lines = [
        f"{'Video Name':60s} | Label | Prob       | Pred  | Status",
        "-" * 100,
    ]
    correct = 0
    evaluated = 0
    for name, label, prob in rows:
        if prob is None:
            lines.append(f"{name:60s} | {label:<5d} | ERROR      | -     | ERROR")
            continue
        pred = 1 if prob > 0.5 else 0
        status = "CORRECT" if pred == label else "WRONG"
        evaluated += 1
        correct += pred == label
        pred_name = "FAKE" if pred else "REAL"
        lines.append(f"{name:60s} | {label:<5d} | {prob:.20f} | {pred_name:5s} | {status}")
    if evaluated:
        acc = correct / evaluated * 100.0
        lines.append("")
        lines.append(f"Total Accuracy: {acc:.2f}% ({correct}/{evaluated})")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Batch evaluation / training harness")
    parser.add_argument("--train", action="store_true", help="online-train until correct")
    parser.add_argument("--train-device", action="store_true",
                        help="corpus replay over the feature cache on the device")
    parser.add_argument("--clear-cache", action="store_true", help="drop the feature cache")
    parser.add_argument("--videos-dir", default="videos")
    parser.add_argument("--results", default="results/batch_results.txt")
    parser.add_argument("--max-retries", type=int, default=100)
    parser.add_argument("--concurrency", type=int, default=1,
                        help="overlapped pipelines for unlabeled evaluation "
                             "(ignored with --train: online SGD is sequential)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from fvd_tpu_torch.providers.factory import bootstrap_production

    bootstrap_production(device=device)
    devices = _mesh_devices(device)
    prev = None
    if len(devices) > 1:
        # multi-card batch evaluation: DP-shard the coalesced model forwards
        # over every visible card; restored on exit so embedders (tests,
        # tools) don't inherit the mesh
        prev = set_inference_mesh(make_mesh(n_data=len(devices), n_time=1, devices=devices))
        print(f"inference mesh: {len(devices)}-way DP")
    try:
        return _main_body(args, default_config(), device)
    finally:
        if len(devices) > 1:
            set_inference_mesh(prev)


def _mesh_devices(device) -> List[torch.device]:
    """The devices ``main``'s inference mesh spans: every visible card for a
    run on the card, none for a CPU run."""
    return visible_devices() if torch.device(device).type == "cuda" else []


def _main_body(args, config, device) -> int:
    if args.clear_cache:
        for f in glob.glob(os.path.join(config.fusion.features_dir, "*.json")):
            os.remove(f)
        print("Feature cache cleared.")

    if args.train_device:
        msg = train_device(config, device)
        print(msg or "No cached features to train on.")

    videos = get_videos(args.videos_dir)
    if not videos:
        print(f"No videos found in {args.videos_dir}/")
        return 0 if args.train_device else 1

    rows = []
    if args.concurrency > 1 and not args.train:
        # fast-path cache hits first, overlapped pipelines for the rest
        cached, uncached = [], []
        for path in videos:
            prob = run_local_lr(path, get_label(path), False, config)
            (cached if prob is not None else uncached).append((path, prob))
        probs = dict(cached)
        if uncached:
            results = run_pipeline_many([p for p, _ in uncached], config, concurrency=args.concurrency,
                                        device=device)
            probs.update({p: r for (p, _), r in zip(uncached, results)})
        for path in videos:
            rows.append((os.path.basename(path), get_label(path), probs.get(path)))
            print(f"{os.path.basename(path)}: p={probs.get(path)}")
    else:
        for path in videos:
            label = get_label(path)
            prob, attempts = evaluate_video(path, args.train, args.max_retries, config, device=device)
            rows.append((os.path.basename(path), label, prob))
            print(f"{os.path.basename(path)}: p={prob} (attempts={attempts})")

    table = format_results(rows)
    os.makedirs(os.path.dirname(args.results) or ".", exist_ok=True)
    with open(args.results, "w") as f:
        f.write(table + "\n")
    print(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
