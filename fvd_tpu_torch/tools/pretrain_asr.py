"""Train the ASR encoder-decoder on synthetic speech and write the npz
checkpoint and sidecar the providers load:

    python -m fvd_tpu_torch.tools.pretrain_asr --steps 1500 --batch 16
    python -m fvd_tpu_torch.tools.pretrain_asr --domain formant_hard --dim 192 --depth 4 --resume
    python -m fvd_tpu_torch.tools.pretrain_asr --steps 2 --dim 32 --depth 1 --cpu --out /tmp/asr.npz

The counterpart of the JAX package's ``tools/pretrain_asr.py``, with its flags
and defaults.  Utterances are tone-coded letters (``--domain tone``) or
formant-synthesised speech (``formant``; ``formant_hard`` renders half of them
in the harder family of ``models/synthetic_speech.py``); the model learns the
whole transduction, log-mel -> encoder -> cross-attention decoder -> byte
tokens, and a greedy decode of fresh utterances reads them back.  It runs on
the card unless ``--cpu`` is given, and raises where there is none.  The
weights start from ``weights.seeded`` (seed 0), or from ``--out`` with
``--resume``.

The npz has the JAX package's keys; the sidecar gives ``dim``, ``depth``,
``chunk_frames``, ``max_tokens``, ``domain`` (the base family consumers
dispatch on), ``train_domain`` and ``dither``.  One last line ``[asr]
summary {...}`` gives, as JSON: the steps, the median host data ms and
device ms of a step (CUDA events on the card), utterances per second, the
first and last loss, and the eval's exact and character accuracy.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models import asr
from fvd_tpu_torch.models.layers import adam, adam_step
from fvd_tpu_torch.models.transformer import ByteTokenizer
from fvd_tpu_torch.synthetic import TONE_ALPHABET as ALPHABET
from fvd_tpu_torch.synthetic import TONE_CHAR_S
from fvd_tpu_torch.synthetic import TONE_SR as SR
from fvd_tpu_torch.synthetic import tone_speech
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary

_VOWELS = "aeiou"
_CONSONANTS = "bcdfghjklmnpqrstvwxyz"

#: the mel window (~1.3 s of audio) and the token budget of one utterance
MEL_FRAMES = 128
MAX_TOKENS = 16


def random_letters(rng: np.random.RandomState, min_len=3, max_len=10) -> str:
    n = rng.randint(min_len, max_len + 1)
    return "".join(ALPHABET[rng.randint(len(ALPHABET))] for _ in range(n))


def random_pronounceable(rng: np.random.RandomState, min_len=3, max_len=10) -> str:
    """CV(C) syllables: pronounceable strings whose formant renderings carry
    well-defined consonant-vowel transitions."""
    out = []
    n = rng.randint(min_len, max_len + 1)
    while len(out) < n:
        out.append(_CONSONANTS[rng.randint(len(_CONSONANTS))])
        out.append(_VOWELS[rng.randint(len(_VOWELS))])
        if rng.rand() < 0.3:
            out.append(_CONSONANTS[rng.randint(len(_CONSONANTS))])
        if rng.rand() < 0.25 and len(out) < n:
            out.append(" ")
    return "".join(out[:n]).strip() or "ba"


_COMMON_WORDS = (
    "the a of to and in that it is was for on said will year city state "
    "next cut tax taxes mayor court team game final point museum bridge "
    "open month school board vote river level rose feet after storm new "
    "two six nine thousand jobs july added ruled ban effect won art wing "
    "port dock repair fair crowd summer library late friday airline route "
    "coast record modern traffic last this has had they but not can"
).split()


def random_common_words(rng: np.random.RandomState, min_len=3, max_len=10) -> str:
    """Phrases of common English words (clipped to the utterance budget):
    the vocabulary register of narrated news video."""
    out = ""
    while True:
        w = _COMMON_WORDS[rng.randint(len(_COMMON_WORDS))]
        cand = w if not out else f"{out} {w}"
        if len(cand) > max_len:
            break
        out = cand
    return out or "the"


class Domain:
    """Audio-rendering domain: the tone-coded alphabet or formant-synthesised
    speech (``models/synthetic_speech.py``)."""

    def __init__(self, name: str, noise: float = 0.0):
        self.name = name
        self.noise = noise
        if name == "tone":
            self.char_s = TONE_CHAR_S
            self.render = tone_speech
            self.utterance = random_letters
            self.dither = 0.01
            return
        from fvd_tpu_torch.models.synthetic_speech import PHONE_S, formant_speech, formant_speech_hard

        self.char_s = PHONE_S
        hard = name == "formant_hard"

        def render(text, rng=None):
            rng = rng or np.random.RandomState(0)
            # joint family: half base renders, half hard renders, so the hard
            # axes (rate, undershoot, F0 drift, reverb) are learnt without
            # losing the base family the synthetic videos speak
            if hard and rng.rand() < 0.5:
                a = formant_speech_hard(text, rng, variability=1.0)
            else:
                a = formant_speech(text, rng)
            if noise > 0:
                a = a + noise * rng.randn(len(a)).astype(np.float32)
            return a

        def utterance(rng, min_len=3, max_len=10):
            # 60% pronounceable syllables, 40% common-word phrases
            if rng.rand() < 0.6:
                return random_pronounceable(rng, min_len, max_len)
            return random_common_words(rng, min_len, max_len)

        self.render, self.utterance, self.dither = render, utterance, noise


def asr_batch(rng: np.random.RandomState, batch: int, tok: ByteTokenizer, mel_frames: int, max_tokens: int,
              domain: Domain = None, device="cpu"):
    """-> (mels [B, mel_frames, 80] on ``device``, tokens_in, tokens_out,
    texts).  Utterances and tokens are drawn on the host (numpy); the
    log-mel is one batched device call, each utterance floored at its own
    maximum less 8 (``models/asr.log_mel``), and its rows past the
    utterance's ``1 + samples // HOP`` frames are zero."""
    domain = domain or Domain("tone")
    max_chars = 10
    pad_len = int(SR * domain.char_s) * max_chars
    audio = np.zeros((batch, pad_len), np.float32)
    lens = np.zeros(batch, np.int64)
    tokens_in = np.zeros((batch, max_tokens), np.int32)
    tokens_out = np.zeros((batch, max_tokens), np.int32)
    texts = []
    for i in range(batch):
        text = domain.utterance(rng)
        a = domain.render(text, rng)
        n = min(len(a), pad_len)
        audio[i, :n] = a[:n]
        lens[i] = n
        target = tok.encode(text, max_tokens, add_special=True)
        tokens_in[i] = np.concatenate([[tok.BOS], target[:-1]])
        tokens_out[i] = target
        texts.append(text)

    mel = asr.log_mel(torch.from_numpy(audio).to(device))   # [B, F, 80]
    frames = torch.from_numpy(np.minimum(1 + lens // asr.HOP, min(mel_frames, mel.shape[1]))).to(device)
    mel = torch.where(torch.arange(mel.shape[1], device=mel.device)[None, :, None] < frames[:, None, None],
                      mel, torch.zeros((), device=mel.device))
    mels = F.pad(mel[:, :mel_frames], (0, 0, 0, mel_frames - min(mel_frames, mel.shape[1])))
    return mels, tokens_in, tokens_out, texts


def evaluate(model: asr.AsrModel, rng: np.random.RandomState, tok: ByteTokenizer, domain: Domain, device):
    """Greedy decode of 16 fresh utterances -> (exact share, character
    accuracy, (first text, its decode))."""
    mel, _, _, texts = asr_batch(rng, 16, tok, MEL_FRAMES, MAX_TOKENS, domain=domain, device=device)
    ids = asr.greedy_decode(model, mel, MAX_TOKENS)
    decoded = [tok.decode(row).strip() for row in ids.cpu().numpy()]
    exact = sum(d == t for d, t in zip(decoded, texts)) / len(texts)
    char_ok = char_total = 0
    for d, t in zip(decoded, texts):
        char_total += len(t)
        char_ok += sum(a == b for a, b in zip(d, t))
    return exact, char_ok / max(char_total, 1), (texts[0], decoded[0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--domain", choices=["tone", "formant", "formant_hard"], default="tone")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    ap.add_argument("--noise", type=float, default=0.002,
                    help="formant-domain training noise floor (also the checkpoint's inference dither)")
    ap.add_argument("--resume", action="store_true", help="continuation-finetune: load params from --out")
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = "checkpoints/asr.npz" if args.domain == "tone" else "checkpoints/asr_formant.npz"
    domain = Domain(args.domain, noise=args.noise)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    rng = np.random.RandomState(0)
    tok = ByteTokenizer()
    model = weights.seeded(asr.AsrModel(dim=args.dim, depth=args.depth), 0)
    if args.resume and os.path.exists(args.out):
        weights.load_npz(args.out, model)
        print(f"[asr] resumed params from {args.out}")
    model.to(device)
    opt = adam(model, args.lr)

    def step(mel, tin, tout):
        tin, tout = (torch.from_numpy(t).to(device) for t in (tin, tout))
        return adam_step(asr.asr_loss, model, opt, mel, tin, tout)

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(args.steps):
        mel, tin, tout, _ = timer.data(asr_batch, rng, args.batch, tok, MEL_FRAMES, MAX_TOKENS, domain, device)
        losses.append(timer.step(step, mel, tin, tout))
        if i % 100 == 0 or i == args.steps - 1:
            print(f"[asr] step {i:4d} loss {float(losses[-1]):.3f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    exact, char_acc, (text, decoded) = evaluate(model, rng, tok, domain, device)
    print(f"[asr] eval: exact={exact:.2f} char_acc={char_acc:.2f} sample: {text!r} -> {decoded!r}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    weights.save_npz(args.out, model)
    with open(args.out.replace(".npz", ".json"), "w") as f:
        json.dump({"dim": args.dim, "depth": args.depth, "chunk_frames": MEL_FRAMES, "max_tokens": MAX_TOKENS,
                   "domain": "formant" if args.domain.startswith("formant") else args.domain,
                   "train_domain": args.domain, "dither": domain.dither}, f)
    print(f"[asr] saved {args.out}")
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="utterances",
                           eval_exact=exact, eval_char_acc=char_acc)
    print("[asr] summary " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
