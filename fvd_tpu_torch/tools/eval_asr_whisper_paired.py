"""Paired evaluation of a trained Whisper-base-geometry checkpoint against
the dim-192 ASR:

    python -m fvd_tpu_torch.tools.eval_asr_whisper_paired --whisper checkpoints/hf_staging/whisper \
        [--old checkpoints/asr_formant.npz] [--n 64] [--n-sentences 12] [--json out.json] [--cpu]

The counterpart of the JAX package's ``tools/eval_asr_whisper_paired.py``,
with its flags, printed lines and JSON: the adoption gate of a
real-geometry ASR.  Both models decode the SAME fresh utterances
(noise-matched), each through its own inference convention: the dim-192
encoder-decoder through its 128-frame greedy decode (``eval_asr_paired``'s
conventions), the Whisper-geometry model through its 30 s window and a
greedy generate of at most 24 tokens, the start token included (Flax's
``generate(max_length=24)``; :func:`fvd_tpu_torch.models.hf_whisper.greedy_generate`).
Two levels:

* utterance: ``--n`` fresh single phrases (at most 10 characters, the
  dim-192 training budget): exact and character accuracy;
* transcript: ``--n-sentences`` 30 s ``gated_speech`` sentences written as
  WAV files and read by BOTH providers' ``transcribe()``: word accuracy on
  the spoken words (the A2-level comparison the pipeline exercises).

Gate: the Whisper model's exact and character accuracy at the utterance
level both at least the dim-192's.  The models run on the card unless
``--cpu`` is given; without a card that raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List

import numpy as np
import torch

#: Flax ``generate``'s ``max_length`` of the utterance level (start token included)
MAX_LENGTH = 24
#: utterances a Whisper generate takes at once
WHISPER_BATCH = 16
WORDS_POOL = ("the mayor said the city will cut taxes next year "
              "the river level rose two feet after the storm "
              "the court ruled the ban can not take effect").split()


def word_acc(hyp: str, ref_words: list) -> float:
    hyp_words = hyp.split()
    ok = sum(a == b for a, b in zip(hyp_words, ref_words))
    return ok / max(len(ref_words), 1)


def utterances(seed: int, n: int, dither: float):
    """(texts, audios) of ``n`` fresh formant utterances with the
    checkpoint's dither."""
    from fvd_tpu_torch.tools.pretrain_asr import Domain

    dom = Domain("formant", noise=dither)
    rng = np.random.RandomState(seed)
    texts, audios = [], []
    for _ in range(n):
        t = dom.utterance(rng)
        texts.append(t)
        audios.append(dom.render(t, rng))
    return texts, audios


def old_decode(model, meta: dict, audios, device) -> List[str]:
    """The dim-192 path: one batched log-mel of the utterances padded to
    the checkpoint's frames, each row's frames past its audio zeroed, then
    the greedy decode."""
    from fvd_tpu_torch.models import asr
    from fvd_tpu_torch.tools.eval_asr_paired import decode_all

    mel_frames = int(meta["chunk_frames"])
    pad_len = mel_frames * asr.HOP
    buf = np.zeros((len(audios), pad_len), np.float32)
    for i, a in enumerate(audios):
        k = min(len(a), pad_len)
        buf[i, :k] = a[:k]
    m = asr.log_mel(torch.from_numpy(buf).to(device)).cpu().numpy()
    mels = np.zeros((len(audios), mel_frames, asr.N_MELS), np.float32)
    for i, a in enumerate(audios):
        frames_i = min(1 + len(a) // asr.HOP, mel_frames, m.shape[1])
        mels[i, :frames_i] = m[i, :frames_i]
    return decode_all(model, torch.from_numpy(mels), int(meta["max_tokens"]))


def whisper_generate(hf, audios) -> np.ndarray:
    """Token ids [n, MAX_LENGTH] of each utterance at the start of its 30 s
    window, generated ``WHISPER_BATCH`` at a time."""
    from fvd_tpu_torch.models.hf_whisper import greedy_generate

    out = []
    for i in range(0, len(audios), WHISPER_BATCH):
        feats = torch.cat([hf._features(torch.as_tensor(a, dtype=torch.float32).to(hf.device), 16000)
                           for a in audios[i:i + WHISPER_BATCH]])
        out.append(greedy_generate(hf.model, feats, MAX_LENGTH, hf.start_id, hf.eos_id, hf.pad_id).cpu().numpy())
    return np.concatenate(out)


def sentences(seed: int, n: int) -> List[str]:
    srng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = srng.randint(6, 11)
        out.append(" ".join(WORDS_POOL[srng.randint(len(WORDS_POOL))] for _ in range(k)))
    return out


def main(argv=None) -> int:
    from fvd_tpu_torch import resolve_device
    from fvd_tpu_torch.models.asr import JaxASR
    from fvd_tpu_torch.providers.hf_models import HFWhisperASR
    from fvd_tpu_torch.synthetic import gated_speech
    from fvd_tpu_torch.tools.eval_asr_paired import load_ckpt, score
    from fvd_tpu_torch.utils.hf_tokenizers import whisper_decode
    from fvd_tpu_torch.utils.wav import write_wav

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--whisper", default="checkpoints/hf_staging/whisper")
    ap.add_argument("--old", default="checkpoints/asr_formant.npz")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--n-sentences", type=int, default=12)
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--cpu", action="store_true", help="decode on the CPU instead of the card")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    old_model, old_meta = load_ckpt(args.old, device)
    dither = float(old_meta.get("dither", 0.0))
    hf = HFWhisperASR.from_local(args.whisper, device=device)

    # --- utterance level: the same fresh audio to both models ---
    texts, audios = utterances(args.seed, args.n, dither)
    old_decoded = old_decode(old_model, old_meta, audios, device)
    old_exact, old_char = score(old_decoded, texts)
    new_decoded = [whisper_decode(hf.tokenizer, row).strip() for row in whisper_generate(hf, audios)]
    new_exact, new_char = score(new_decoded, texts)
    print(f"[utterance n={args.n}] dim-192: exact={old_exact:.3f} "
          f"char={old_char:.3f} | whisper-base-geom: exact={new_exact:.3f} "
          f"char={new_char:.3f}")
    for t, d in list(zip(texts, new_decoded))[:4]:
        print(f"    {t!r} -> {d!r}")

    # --- transcript level: full 30 s sentences through both providers ---
    old_asr = JaxASR.from_checkpoint(args.old, device=device)
    accs = {"old": [], "new": []}
    with tempfile.TemporaryDirectory(prefix="fvd_asr_pair_") as tdir:
        for i, s in enumerate(sentences(args.seed + 1, args.n_sentences)):
            path = os.path.join(tdir, f"s{i}.wav")
            write_wav(path, gated_speech(s, 30.0, renderer="formant"), 16000)
            # the words actually rendered (gated_speech drops words past the clip)
            spoken = s.split()
            accs["old"].append(word_acc((old_asr.transcribe(path) or {"text": ""})["text"], spoken))
            accs["new"].append(word_acc((hf.transcribe(path) or {"text": ""})["text"], spoken))
    t_old = float(np.mean(accs["old"]))
    t_new = float(np.mean(accs["new"]))
    print(f"[transcript n={args.n_sentences}] dim-192 word acc={t_old:.3f} | "
          f"whisper-base-geom word acc={t_new:.3f}")

    results = {
        "utterance": {"n": args.n,
                      "old": {"exact": round(old_exact, 4), "char": round(old_char, 4)},
                      "new": {"exact": round(new_exact, 4), "char": round(new_char, 4)}},
        "transcript": {"n": args.n_sentences,
                       "old_word_acc": round(t_old, 4),
                       "new_word_acc": round(t_new, 4)},
        "meets_verdict_gate": bool(new_exact >= old_exact and new_char >= old_char),
    }
    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
