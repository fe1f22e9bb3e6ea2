"""Train the whisper-base-geometry model (d_model 512, 6 + 6 layers, 8 heads,
80 mel bins, vocab 51865) on the formant speech domain:

    python -m fvd_tpu_torch.tools.pretrain_hf_whisper --steps 8000 --batch 8
    python -m fvd_tpu_torch.tools.pretrain_hf_whisper --cpu --tiny --steps 2 --batch 2 --pool 16 --out /tmp/whisper

The counterpart of the JAX package's ``tools/pretrain_hf_whisper.py``, with
its flags and defaults.  Without ``--resume`` (or without ``--out``) it
fabricates the model and tokenizer into ``--out`` (``--tiny``: d64, 2 + 2
layers, vocab 600); the model computes in bfloat16 on float32 parameters.

The data path keeps the JAX tool's: ``--pool`` distinct phrases of at most
10 characters (common words or pronounceable syllables) rendered once as
formant speech (a share of the hard family, a sub-hop shift, an optional
dither up to ``--noise-max``), their power-mel tiles computed on the device
in chunks of 256 and kept there; each step the host draws only integers (up
to 22 phrase slots and their frame offsets per 30 s canvas, the
transcript's byte-level BPE ids), the device composes the canvases
(``ops/whisper_frontend.compose_canvas_batch``), casts them to bfloat16 and
takes the teacher-forced masked NLL over 256 decoder positions, and the
clipped AdamW of ``hf_train.hf_optimizer`` steps.  The held-out evaluation
decodes 64 unseen phrases (base family) placed at slot 0, greedily from
start id 1 to eos 0 within 16 tokens, and reports exact and character
accuracy.  It writes ``--out`` as ``save_pretrained`` lays it out, with
``fvd_train_meta.json``; ``--promote`` copies the directory.  A SIGTERM
saves before exiting.  It runs on the card unless ``--cpu`` is given, and
raises where there is none.

Its last line, ``[whisper] summary {...}``, gives as JSON the steps, the
median host data ms and device ms of a step (CUDA events on the card),
canvases per second over the loop's wall time, the first and last loss,
both held-out accuracies and the parameter count.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration, greedy_generate
from fvd_tpu_torch.models.optim import clipped_adamw_step
from fvd_tpu_torch.ops.whisper_frontend import compose_canvas_batch, mel_filter_bank, phrase_power_mel
from fvd_tpu_torch.tools import hf_train
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer, whisper_decode

MAX_CHARS = 10          # gated_speech's trained-utterance phrase budget
TILE_FRAMES = 104       # phrase power-mel tile (<= 0.95 s content + boundary)
SEQ = 256               # decoder length (~1 token a character on the byte vocabulary)
KMAX = 22               # most phrases on one 30 s canvas
POOL_CHUNK = 256        # phrases per power-mel launch
START_ID, EOS_ID = 1, 0
META = {"domain": "formant", "train": "pretrain_hf_whisper.py", "geometry": "whisper-base d512 6+6 h8 vocab51865"}


def gen_phrases(rng: np.random.RandomState, n: int, taken=()) -> list:
    """``n`` distinct phrases of at most ``MAX_CHARS`` characters: common
    words (60%) or pronounceable syllables, none of ``taken``."""
    from fvd_tpu_torch.tools.pretrain_asr import random_common_words, random_pronounceable

    out, seen = [], set(taken)
    while len(out) < n:
        if rng.rand() < 0.6:
            p = random_common_words(rng, max_len=MAX_CHARS)
        else:
            p = random_pronounceable(rng, min_len=3, max_len=MAX_CHARS)
        p = p[:MAX_CHARS].strip()
        if p and p not in seen:
            seen.add(p)
            out.append(p)
    return out


def render_pool(phrases: list, rng: np.random.RandomState, hard_frac: float = 0.3,
                noise_max: float = 0.0) -> np.ndarray:
    """[M, TILE_FRAMES * 160] float32 audio: each phrase's formant speech
    (the hard family with probability ``hard_frac``) shifted by up to one
    hop, plus a dither of amplitude ~U(0, ``noise_max``)."""
    from fvd_tpu_torch.models.synthetic_speech import formant_speech, formant_speech_hard

    buf = np.zeros((len(phrases), TILE_FRAMES * 160), np.float32)
    for i, p in enumerate(phrases):
        if rng.rand() < hard_frac:
            a = formant_speech_hard(p, rng, variability=1.0)
        else:
            a = formant_speech(p, rng)
        pad = rng.randint(0, 160)
        n = min(len(a), buf.shape[1] - pad)
        buf[i, pad:pad + n] = a[:n]
        if noise_max > 0:
            buf[i] += rng.uniform(0, noise_max) * rng.randn(buf.shape[1]).astype(np.float32)
    return buf


def pool_power_mels(audio_pool: np.ndarray, mel_filters: torch.Tensor) -> torch.Tensor:
    """[M, TILE_FRAMES, n_mels] power-mel tiles on ``mel_filters``' device,
    ``POOL_CHUNK`` phrases a launch."""
    dev = mel_filters.device
    return torch.cat([phrase_power_mel(torch.from_numpy(audio_pool[i:i + POOL_CHUNK]).to(dev), mel_filters,
                                       TILE_FRAMES) for i in range(0, len(audio_pool), POOL_CHUNK)])


def sample_batch(rng: np.random.RandomState, batch: int, n_pool: int, texts: list, tok_encode):
    """Host integers of one batch: phrase slots ``idx`` (-1 unused) and
    frame offsets ``off`` [batch, KMAX], decoder inputs, labels and the loss
    mask [batch, SEQ], and each canvas's transcript."""
    idx = np.full((batch, KMAX), -1, np.int32)
    off = np.zeros((batch, KMAX), np.int32)
    dec_in = np.zeros((batch, SEQ), np.int32)
    labels = np.zeros((batch, SEQ), np.int32)
    mask = np.zeros((batch, SEQ), np.float32)
    sample_texts = []
    for b in range(batch):
        r = rng.rand()
        if r < 0.03:
            k = 0
        elif r < 0.30:
            k = rng.randint(1, 4)
        elif r < 0.70:
            k = rng.randint(4, 11)
        else:
            k = rng.randint(11, KMAX + 1)
        spacing = 100 if rng.rand() < 0.7 else rng.randint(80, 161)
        start = 0 if rng.rand() < 0.5 else rng.randint(0, 600)
        k = min(k, max((2896 - start) // spacing, 0))
        rows = rng.randint(0, n_pool, k).astype(np.int32)
        idx[b, :k] = rows
        off[b, :k] = start + spacing * np.arange(k)
        text = " ".join(texts[j] for j in rows)
        sample_texts.append(text)
        ids = tok_encode(text)[: SEQ - 2]
        n = len(ids)
        dec_in[b, 0] = START_ID
        dec_in[b, 1:n + 1] = ids
        labels[b, :n] = ids
        labels[b, n] = EOS_ID
        mask[b, :n + 1] = 1.0
    return idx, off, dec_in, labels, mask, sample_texts


def whisper_loss(model: WhisperForConditionalGeneration, feats: torch.Tensor, dec_in: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Teacher-forced NLL of ``labels`` over the positions of ``mask``, the
    logits taken in float32."""
    logits = hf_train.wide(model(feats, dec_in))
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def whisper_step_loss(model, pool, idx, off, dec_in, labels, mask):
    """The train step's loss: the canvases composed on the device from
    ``pool`` and cast to the model's compute dtype (else its parameters'),
    then :func:`whisper_loss`."""
    feats = compose_canvas_batch(pool, idx, off)
    return whisper_loss(model, feats.to(model.compute_dtype or next(model.parameters()).dtype), dec_in, labels,
                        mask)


@torch.no_grad()
def evaluate(model, tok: Tokenizer, eval_pool: torch.Tensor, eval_texts: list, n: int = 64, log_samples: int = 2):
    """-> (exact, char accuracy) of greedy decodes of the first ``n``
    held-out phrases, each alone at slot 0 of its canvas, 16 at a time."""
    dev = eval_pool.device
    idx = torch.arange(n, device=dev)[:, None]
    feats = compose_canvas_batch(eval_pool, idx, torch.zeros_like(idx))
    decoded = []
    for i in range(0, n, 16):
        ids = greedy_generate(model, feats[i:i + 16], MAX_CHARS + 6, START_ID, EOS_ID, EOS_ID).cpu().numpy()
        decoded += [whisper_decode(tok, row) for row in ids]
    exact = char_ok = char_tot = 0
    for d, t in zip(decoded, eval_texts[:n]):
        d = d.strip()
        exact += d == t
        char_tot += len(t)
        char_ok += sum(a == b for a, b in zip(d, t))
    for d, t in zip(decoded[:log_samples], eval_texts[:log_samples]):
        print(f"    {t!r} -> {d.strip()!r}", flush=True)
    return exact / n, char_ok / max(char_tot, 1)


def run(argv=None):
    """The tool on ``argv`` -> (the trained model, the summary, ``replay``:
    a model's mean loss over the run's batches drawn again)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pool", type=int, default=1600)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--out", default="checkpoints/hf_staging/whisper")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-max", type=float, default=0.0,
                    help="bake per-tile dither ~U(0,noise_max) into the pool (see render_pool)")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    ap.add_argument("--tiny", action="store_true",
                    help="d64 2+2 geometry, vocab 600: a smoke test of the trainer, not a capability run")
    ap.add_argument("--promote", default=None,
                    help="after training+eval, copy --out to this dir (e.g. checkpoints/hf/whisper)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(hf_train.device_line(device), flush=True)
    if not (args.resume and os.path.isdir(args.out)):
        from fvd_tpu_torch.tools.make_hf_geometry_checkpoints import make_whisper

        print("fabricating whisper-base-geometry model + tokenizer...", flush=True)
        if args.tiny:
            make_whisper(args.out, d_model=64, layers=2, heads=2, ffn=128, vocab_size=600)
        else:
            make_whisper(args.out)
    tok = Tokenizer.from_dir(args.out)
    model = hf_train.load_for_training(WhisperForConditionalGeneration, "whisper", args.out, device)
    n_params = hf_train.count_params(model)
    print(f"[whisper] params: {n_params}", flush=True)

    def tok_encode(text):
        return [i for i in tok.encode_ids(text) if i > 1]

    rng = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    train_texts = gen_phrases(rng, args.pool)
    eval_texts = gen_phrases(rng, 64, taken=train_texts)
    print(f"rendering {args.pool}+64 phrases...", flush=True)
    pool_audio = render_pool(train_texts, rng, noise_max=args.noise_max)
    eval_audio = render_pool(eval_texts, np.random.RandomState(args.seed + 1), hard_frac=0.0,
                             noise_max=args.noise_max)
    with open(os.path.join(args.out, "preprocessor_config.json")) as f:
        fe = json.load(f)
    mel = torch.from_numpy(mel_filter_bank(fe["n_fft"] // 2 + 1, fe["feature_size"], 0.0, 8000.0,
                                           fe["sampling_rate"]).astype(np.float32)).to(device)
    pool_dev = pool_power_mels(pool_audio, mel)
    eval_pool_dev = pool_power_mels(eval_audio, mel)
    render_s = time.perf_counter() - t0
    print(f"pool ready in {render_s:.1f}s ({tuple(pool_dev.shape)} on {pool_dev.device})", flush=True)

    opt, sched = hf_train.hf_optimizer(model, args.lr, args.warmup, args.steps)

    def save(tag=""):
        hf_train.save_tree(model, "whisper", args.out)
        hf_train.write_meta(args.out, {"domain": META["domain"], "train": META["train"], "steps": args.steps,
                                       "pool": args.pool, "geometry": META["geometry"]})
        print(f"[save{tag}] -> {args.out}", flush=True)

    data_rng = np.random.RandomState(args.seed + 7)
    timer, losses = StepTimer(device), []
    with hf_train.save_on_sigterm(save):
        t0 = time.perf_counter()
        for i in range(args.steps):
            idx, off, dec_in, labels, mask, _ = timer.data(sample_batch, data_rng, args.batch, args.pool,
                                                           train_texts, tok_encode)
            batch = [torch.from_numpy(x).to(device, torch.int64) for x in (idx, off, dec_in, labels)] + \
                [torch.from_numpy(mask).to(device)]
            loss = timer.step(lambda: clipped_adamw_step(whisper_step_loss, model, opt, sched, pool_dev, *batch))
            losses.append(loss)
            if i % 50 == 0 or i == args.steps - 1:
                print(f"[whisper] step {i:5d} loss {float(loss):.4f} ({time.perf_counter() - t0:.1f}s)",
                      flush=True)
            if args.eval_every and i > 0 and i % args.eval_every == 0:
                ex, ca = evaluate(model, tok, eval_pool_dev, eval_texts, n=32)
                print(f"[whisper] step {i}: held-out exact={ex:.3f} char={ca:.3f}", flush=True)
            if args.save_every and i > 0 and i % args.save_every == 0:
                save(f"@{i}")
        seconds = time.perf_counter() - t0

        ex, ca = evaluate(model, tok, eval_pool_dev, eval_texts, n=64, log_samples=4)
        print(f"[whisper] FINAL held-out (64 phrases): exact={ex:.3f} char={ca:.3f}", flush=True)
        save()
    if args.promote:
        os.makedirs(os.path.dirname(args.promote) or ".", exist_ok=True)
        if os.path.isdir(args.promote):
            shutil.rmtree(args.promote)
        shutil.copytree(args.out, args.promote)
        print(f"promoted -> {args.promote}", flush=True)
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="canvases",
                           exact=ex, char=ca, params=n_params, pool_s=render_s,
                           loss_curve=hf_train.loss_curve(losses))
    print("[whisper] summary " + json.dumps(summary), flush=True)

    @torch.no_grad()
    def replay(m) -> float:
        rng, out = np.random.RandomState(args.seed + 7), []
        for _ in range(args.steps):
            idx, off, dec_in, labels, mask, _ = sample_batch(rng, args.batch, args.pool, train_texts, tok_encode)
            b = [torch.from_numpy(x).to(device, torch.int64) for x in (idx, off, dec_in, labels)]
            out.append(float(whisper_step_loss(m, pool_dev, *b, torch.from_numpy(mask).to(device))))
        return float(np.mean(out))

    return model, summary, replay


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
