"""Train the MiniLM-L6-geometry BERT encoder (6 layers, hidden 384, 12
heads, intermediate 1536, vocab 30522) for E1's evidence ranking:

    python -m fvd_tpu_torch.tools.pretrain_hf_minilm --steps 4000 --batch 96
    python -m fvd_tpu_torch.tools.pretrain_hf_minilm --cpu --steps 2 --batch 4 --out /tmp/minilm

The counterpart of the JAX package's ``tools/pretrain_hf_minilm.py``, with
its flags and defaults.  Without ``--resume`` (or without ``--out``) it
fabricates the model and tokenizer into ``--out``
(``make_hf_geometry_checkpoints.make_minilm``); the model computes in
bfloat16 on float32 parameters.  A batch is ``--batch`` unique claim/evidence
facts of ``pretrain_text_encoder``'s generator, the query a claim rendering
and the document a search-result rendering of the same fact, WordPiece ids
padded to 64; the loss is the symmetric InfoNCE at temperature 0.07 over the
masked mean of the last hidden state (the arithmetic of
``providers/hf_models.HFTextEncoder``); the optimiser is the clipped AdamW of
``hf_train.hf_optimizer``.  The held-out retrieval@1 is 64-way over two
batches of ``RandomState(seed + 10000)``.  It writes ``--out`` as
``FlaxBertModel.save_pretrained`` lays it out, with ``fvd_train_meta.json``;
``--promote`` copies it in float16 with the ``.json`` and ``.txt`` files.  A
SIGTERM saves before exiting.  It runs on the card unless ``--cpu`` is
given, and raises where there is none.

Its last line, ``[minilm] summary {...}``, gives as JSON the steps, the
median host data ms and device ms of a step (CUDA events on the card), pairs
per second over the loop's wall time, the first and last loss, the final
retrieval@1 and the parameter count.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.models.hf_bert import BertModel, mean_pool
from fvd_tpu_torch.models.optim import clipped_adamw_step
from fvd_tpu_torch.tools import hf_train
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary
from fvd_tpu_torch.tools.pretrain_text_encoder import make_fact, render_doc, render_fact
from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer

MAX_LEN = 64
TEMPERATURE = 0.07
META = {"domain": "claims-evidence", "train": "pretrain_hf_minilm.py",
        "geometry": "minilm-l6 bert 6L h384 i1536 vocab30522"}


def make_batch(rng: np.random.RandomState, batch: int, tok: Tokenizer):
    """-> (q_ids, q_mask, d_ids, d_mask) [batch, MAX_LEN] int64: ``batch``
    unique facts, each rendered as a claim and as a search result."""
    seen, qs, ds = set(), [], []
    while len(qs) < batch:
        f = make_fact(rng)
        key = json.dumps(f, sort_keys=True)
        if key in seen:
            continue
        seen.add(key)
        qs.append(render_fact(rng, f))
        ds.append(render_doc(rng, f))
    q, d = tok(qs, MAX_LEN), tok(ds, MAX_LEN)
    return q["input_ids"], q["attention_mask"], d["input_ids"], d["attention_mask"]


def embed(model: BertModel, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean of the last hidden state, in the compute dtype, as float32."""
    return hf_train.wide(mean_pool(model(ids, mask), mask))


def minilm_loss(model: BertModel, q_ids, q_mask, d_ids, d_mask) -> torch.Tensor:
    q = hf_train.unit(embed(model, q_ids, q_mask))
    d = hf_train.unit(embed(model, d_ids, d_mask))
    return hf_train.symmetric_ce((q @ d.T) / TEMPERATURE)


@torch.no_grad()
def evaluate(model: BertModel, tok: Tokenizer, seed: int, device, n: int = 64) -> float:
    """Held-out retrieval@1: fresh facts, ``n``-way claim -> document, two rounds."""
    rng = np.random.RandomState(seed + 10_000)
    accs = []
    for _ in range(2):
        q_ids, q_mask, d_ids, d_mask = (torch.from_numpy(x).to(device) for x in make_batch(rng, n, tok))
        q = hf_train.unit(embed(model, q_ids, q_mask)).cpu().numpy()
        d = hf_train.unit(embed(model, d_ids, d_mask)).cpu().numpy()
        accs.append(((q @ d.T).argmax(axis=1) == np.arange(n)).mean())
    return float(np.mean(accs))


def run(argv=None):
    """The tool on ``argv`` -> (the trained model, the summary, ``replay``:
    a model's mean loss over the run's batches drawn again)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--out", default="checkpoints/hf_staging/minilm")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    ap.add_argument("--promote", default=None,
                    help="after training+eval, copy --out to this dir as float16 (e.g. checkpoints/hf/minilm)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(hf_train.device_line(device), flush=True)
    if not (args.resume and os.path.isdir(args.out)):
        from fvd_tpu_torch.tools.make_hf_geometry_checkpoints import make_minilm

        print("fabricating MiniLM-L6-geometry model + tokenizer...", flush=True)
        make_minilm(args.out)
    tok = Tokenizer.from_dir(args.out)
    model = hf_train.load_for_training(BertModel, "bert", args.out, device)
    n_params = hf_train.count_params(model)
    print(f"[minilm] params: {n_params}", flush=True)
    opt, sched = hf_train.hf_optimizer(model, args.lr, args.warmup, args.steps)

    def save(tag=""):
        hf_train.save_tree(model, "bert", args.out)
        hf_train.write_meta(args.out, {**META, "steps": args.steps, "seed": args.seed})
        print(f"[save{tag}] -> {args.out}", flush=True)

    data_rng = np.random.RandomState(args.seed + 7)
    timer, losses = StepTimer(device), []
    with hf_train.save_on_sigterm(save):
        t0 = time.perf_counter()
        for i in range(args.steps):
            batch = timer.data(make_batch, data_rng, args.batch, tok)
            batch = [torch.from_numpy(x).to(device) for x in batch]
            loss = timer.step(lambda: clipped_adamw_step(minilm_loss, model, opt, sched, *batch))
            losses.append(loss)
            if i % 50 == 0 or i == args.steps - 1:
                print(f"[minilm] step {i:5d} loss {float(loss):.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)
            if args.eval_every and i > 0 and i % args.eval_every == 0:
                print(f"[minilm] step {i}: held-out retrieval@1={evaluate(model, tok, args.seed, device):.3f}",
                      flush=True)
            if args.save_every and i > 0 and i % args.save_every == 0:
                save(f"@{i}")
        seconds = time.perf_counter() - t0

        acc = evaluate(model, tok, args.seed, device)
        print(f"[minilm] FINAL held-out retrieval@1 (64-way): {acc:.3f}", flush=True)
        save()
    if args.promote:
        hf_train.promote_f16(model, "bert", args.out, args.promote)
        print(f"promoted (f16) -> {args.promote}", flush=True)
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="pairs",
                           retrieval_at_1=acc, params=n_params,
                           loss_curve=hf_train.loss_curve(losses))
    print("[minilm] summary " + json.dumps(summary), flush=True)

    @torch.no_grad()
    def replay(m) -> float:
        rng = np.random.RandomState(args.seed + 7)
        return float(np.mean([float(minilm_loss(m, *(torch.from_numpy(x).to(device)
                                                     for x in make_batch(rng, args.batch, tok))))
                              for _ in range(args.steps)]))

    return model, summary, replay


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
