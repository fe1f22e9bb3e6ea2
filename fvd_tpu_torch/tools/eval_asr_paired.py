"""Paired evaluation of two ASR checkpoints on fresh utterance families:

    python -m fvd_tpu_torch.tools.eval_asr_paired --old checkpoints/asr_formant.npz \
        --new /tmp/asr_r3/asr_formant.npz [--n 64] [--json out.json] [--cpu]

The counterpart of the JAX package's ``tools/eval_asr_paired.py``, with its
flags, printed lines and ``--json`` keys.  The adoption rule: a
continuation finetune ships only on a paired win, both checkpoints decoding
the SAME fresh samples, so the comparison is noise-matched.  Families:

* ``base``: ``formant_speech``, the shipped checkpoint's domain (the audio
  ``make_face_video`` and the benchmark render); a regression here vetoes
  adoption;
* ``hard``: ``formant_speech_hard`` (rate variation, coarticulation
  undershoot, F0 drift, reverb; ``models/synthetic_speech.py``), the
  held-out family.

Verdict ADOPT when the new checkpoint's exact rate beats the old one's on
``hard`` and stays within 0.03 of it on ``base``, else REJECT.  The models
decode on the card unless ``--cpu`` is given; without a card that raises.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import asr
from fvd_tpu_torch.models.transformer import ByteTokenizer


def load_ckpt(path: str, device=None) -> Tuple[asr.AsrModel, dict]:
    """(model on ``device``, sidecar) of an ASR npz and its json."""
    with open(path.replace(".npz", ".json")) as f:
        meta = json.load(f)
    model = asr.AsrModel(dim=int(meta["dim"]), depth=int(meta["depth"]))
    model.load_state_dict(weights.to_state_dict(weights.read_npz(path)), strict=True)
    return model.eval().to(resolve_device(device)), meta


def decode_all(model: asr.AsrModel, mels: torch.Tensor, max_tokens: int) -> List[str]:
    """Greedy decode of ``mels`` [B, frames, 80] -> the stripped texts."""
    tok = ByteTokenizer()
    ids = asr.greedy_decode(model, mels.to(next(model.parameters()).device), max_tokens)
    return [tok.decode(row).strip() for row in ids.cpu().numpy()]


def score(decoded, texts) -> Tuple[float, float]:
    """(exact-match share, character accuracy over all reference characters)."""
    exact = sum(d == t for d, t in zip(decoded, texts)) / max(len(texts), 1)
    ok = tot = 0
    for d, t in zip(decoded, texts):
        tot += len(t)
        ok += sum(a == b for a, b in zip(d, t))
    return exact, ok / max(tot, 1)


def adopt(results: dict) -> bool:
    """The paired verdict: a win on ``hard``, no regression past 0.03 on
    ``base`` (exact rates)."""
    return bool(results["hard_new"]["exact"] > results["hard_old"]["exact"]
                and results["base_new"]["exact"] >= results["base_old"]["exact"] - 0.03)


def hard_domain(dither: float):
    """``Domain("formant")`` rendering every utterance in the hard family,
    with the checkpoint's dither added."""
    from fvd_tpu_torch.models.synthetic_speech import formant_speech_hard
    from fvd_tpu_torch.tools.pretrain_asr import Domain

    dom = Domain("formant", noise=dither)

    def render(text, rng=None):
        rng = rng or np.random.RandomState(0)
        a = formant_speech_hard(text, rng, variability=1.0)
        if dither > 0:
            a = a + dither * rng.randn(len(a)).astype(np.float32)
        return a

    dom.render = render
    return dom


def main(argv=None) -> int:
    from fvd_tpu_torch.tools.pretrain_asr import Domain, asr_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default="checkpoints/asr_formant.npz")
    ap.add_argument("--new", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--cpu", action="store_true", help="decode on the CPU instead of the card")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    old_m, old_meta = load_ckpt(args.old, device)
    new_m, new_meta = load_ckpt(args.new, device)
    mel_frames = int(old_meta["chunk_frames"])
    max_tokens = int(old_meta["max_tokens"])
    assert mel_frames == int(new_meta["chunk_frames"])
    dither = float(old_meta.get("dither", 0.0))
    tok = ByteTokenizer()

    results = {}
    for fam in ("base", "hard"):
        dom = hard_domain(dither) if fam == "hard" else Domain("formant", noise=dither)
        rng = np.random.RandomState(args.seed + (1 if fam == "hard" else 0))
        mels, _, _, texts = asr_batch(rng, args.n, tok, mel_frames, max_tokens, domain=dom, device=device)
        for name, model in (("old", old_m), ("new", new_m)):
            exact, char = score(decode_all(model, mels, max_tokens), texts)
            results[f"{fam}_{name}"] = {"exact": round(exact, 4), "char": round(char, 4)}
            print(f"[{fam}] {name}: exact={exact:.3f} char={char:.3f}", flush=True)

    win = adopt(results)
    results["adopt"] = win
    print(f"paired verdict: {'ADOPT' if win else 'REJECT'} "
          f"(hard {results['hard_old']['exact']}->{results['hard_new']['exact']}, "
          f"base {results['base_old']['exact']}->{results['base_new']['exact']})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
