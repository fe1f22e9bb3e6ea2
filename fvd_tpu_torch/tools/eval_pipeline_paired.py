"""Paired end-to-end pipeline contract for checkpoint adoption:

    python -m fvd_tpu_torch.tools.eval_pipeline_paired \
        --override face_ssd.npz=/tmp/det_r3/face_ssd.npz [--duration 8] [--heldout] [--json out.json] [--cpu]

The counterpart of the JAX package's ``tools/eval_pipeline_paired.py``,
with its flags, printed lines, JSON and exit code.  A candidate checkpoint
ships only if the full 16-node pipeline keeps its discrimination on the
SAME fresh clips: one in-sync clip and one desync + texture fake are
rendered once (OpenCV's shapes, the JAX package's pixels, as raw-RGBA AVI
with the speech the shipped ASR reads), then analyzed with the SHIPPED
checkpoints and with the candidate overrides.  The contract: the new lip
separation (sync minus fake ``lip_sync``) at least half the old one and
above 0.2, and the fake's probability above the sync clip's; the tool exits
1 when it fails.

:func:`compose_ckpt_dir` links only the top-level ``.npz``/``.json`` of
``checkpoints/``, so the candidate side has no ``hf/``: where the HF
lineup loads, the shipped side runs it and the candidate side the npz zoo,
as in the JAX tool.  Each side loads ``production_providers(...,
recorded_services=True)`` (the face and landmark backbones in bfloat16)
on the card unless ``--cpu`` is given; without a card that raises.  The
candidate's directory, the clips and the runs' files go to a temporary
working directory, removed at the end, and the tool returns to the
directory it started in.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the speech both clips say
SPEECH_TEXT = "the river level rose two feet"


def compose_ckpt_dir(base: str, overrides: dict, out: str | None = None) -> str:
    """A fresh directory (``out``, or a new temporary one) linking ``base``'s
    top-level ``.npz``/``.json`` files, with each override (``{name: path}``)
    and its sidecar copied in."""
    if out is None:
        out = tempfile.mkdtemp(prefix="fvd_ckpt_")
    else:
        os.makedirs(out)
    for f in os.listdir(base):
        if f.endswith((".npz", ".json")):
            os.symlink(os.path.join(base, f), os.path.join(out, f))
    for name, path in overrides.items():
        dst = os.path.join(out, name)
        if os.path.lexists(dst):
            os.unlink(dst)
        shutil.copy2(path, dst)
        sidecar = path.replace(".npz", ".json")
        if path.endswith(".npz") and os.path.exists(sidecar):
            dst_side = dst.replace(".npz", ".json")
            if os.path.lexists(dst_side):
                os.unlink(dst_side)
            shutil.copy2(sidecar, dst_side)
    return out


def analyze(video: str, ckpt_dir: str, device=None, compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The 16 nodes on ``video`` with the production bundle of ``ckpt_dir``
    and the recorded services -> {p, lip, words, claims}."""
    from fvd_tpu_torch.config import EvidenceConfig, default_config
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.providers.factory import production_providers
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State

    cfg = dataclasses.replace(default_config(), evidence=EvidenceConfig(rate_limit_s=0.0, max_workers=2))
    providers = production_providers(checkpoint_dir=ckpt_dir, recorded_services=True, device=device,
                                     compute_dtype=compute_dtype)
    final = Scheduler(build_graph(cfg, providers, device=device)).invoke(State(input_path=video))
    return {"p": round(float(final.fake_probability), 4),
            "lip": round(float(final.features.get("lip_sync", 0.0)), 4),
            "words": int(final.word_count or 0),
            "claims": len(final.claims or [])}


def render_clips(base: str, duration: float, fps: float, heldout: bool):
    """(sync, fake) clip paths under ``media/``: seed 21 in sync, seed 22
    with its mouth at 1.37 Hz and texture noise 14 in the face, both saying
    :data:`SPEECH_TEXT` in the speech domain of ``base``'s ASR."""
    from fvd_tpu_torch.providers.factory import asr_speech_domain
    from fvd_tpu_torch.synthetic import make_face_video
    from fvd_tpu_torch.tools.make_labeled_corpus import corpus_speech

    speech = corpus_speech(asr_speech_domain(base))
    common = dict(duration=duration, fps=fps, width=320, height=240, speech=speech, heldout=heldout,
                  speech_text=SPEECH_TEXT, opencv=True)
    sync = make_face_video("media", name="sync", seed=21, **common)
    fake = make_face_video("media", name="fake", seed=22, mouth_gate_hz=1.37, texture_noise=14.0, **common)
    return sync, fake


def contract(results: dict) -> dict:
    """The separations and the verdict of ``results`` ({old, new} x {sync,
    fake} analyses), added to it."""
    sep_old = results["old"]["sync"]["lip"] - results["old"]["fake"]["lip"]
    sep_new = results["new"]["sync"]["lip"] - results["new"]["fake"]["lip"]
    p_gap_old = results["old"]["fake"]["p"] - results["old"]["sync"]["p"]
    p_gap_new = results["new"]["fake"]["p"] - results["new"]["sync"]["p"]
    ok = sep_new >= 0.5 * sep_old and sep_new > 0.2 and p_gap_new > 0.0
    results["lip_separation"] = {"old": round(sep_old, 4), "new": round(sep_new, 4)}
    results["prob_gap"] = {"old": round(p_gap_old, 4), "new": round(p_gap_new, 4)}
    results["contract_ok"] = bool(ok)
    print(f"paired pipeline contract: {'OK' if ok else 'FAIL'} "
          f"(lip separation {sep_old:.3f}->{sep_new:.3f}, "
          f"prob gap {p_gap_old:.3f}->{p_gap_new:.3f})")
    return results


def main(argv=None) -> int:
    from fvd_tpu_torch import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--override", action="append", default=[], metavar="NAME=PATH",
                    help="checkpoint file(s) the candidate replaces, e.g. face_ssd.npz=/tmp/det_r3/face_ssd.npz")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--heldout", action="store_true", help="render the clips in the held-out face distribution")
    ap.add_argument("--cpu", action="store_true", help="analyze on the CPU instead of the card")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    overrides = dict(o.split("=", 1) for o in args.override)
    base = os.path.join(REPO, "checkpoints")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="fvd_paired_") as work:
        new_dir = compose_ckpt_dir(base, overrides, os.path.join(work, "ckpt"))
        os.chdir(work)
        try:
            sync, fake = render_clips(base, args.duration, args.fps, args.heldout)
            results = {}
            for tag, ckpt in (("old", base), ("new", new_dir)):
                results[tag] = {"sync": analyze(sync, ckpt, device), "fake": analyze(fake, ckpt, device)}
                print(f"[{tag}] sync={results[tag]['sync']} fake={results[tag]['fake']}", flush=True)
        finally:
            os.chdir(cwd)

    contract(results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if results["contract_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
