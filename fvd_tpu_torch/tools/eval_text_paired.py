"""Paired evaluation of a trained MiniLM-L6-geometry encoder against the
dim-192 text tower:

    python -m fvd_tpu_torch.tools.eval_text_paired --new checkpoints/hf_staging/minilm \
        [--old checkpoints/text_encoder.npz] [--n 64] [--rounds 4] [--json out.json] [--cpu]

The counterpart of the JAX package's ``tools/eval_text_paired.py``, with its
flags, printed lines and JSON.  It is the adoption gate of a real-geometry
E1 rerank model: both providers embed the SAME fresh claims and evidence
documents (a held-out seed of ``pretrain_text_encoder``'s fact generator)
and are scored on the ranking task E1 performs (the cosine of a claim's
embedding with each document's).

Per provider, over ``--rounds`` rounds of ``--n`` ranking tasks that share
an ``--n``-document pool (every other fact's document is a same-template
distractor, so the slot values are the only separator; a fact drawn twice
in a round is skipped):

* retrieval@1: the top-ranked document is the claim's own;
* MRR: the mean reciprocal rank of the true document;
* top5: the true document lands in E1's kept top 5.

Gate: new >= old on all three.  ``--new`` is an HF directory
(``HFTextEncoder.from_local``), ``--old`` an npz text tower at its
sidecar's dims; without ``--old`` the gate is null.  The encoders run on
the card unless ``--cpu`` is given; without a card that raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

METRICS = ("retrieval_at_1", "mrr", "top5")


def ranking_metrics(encoder, claims, docs) -> dict:
    """The three ranking metrics of claim ``i`` against document ``i`` in
    the pool ``docs``."""
    q = np.asarray(encoder.encode_batch(claims), np.float32)
    d = np.asarray(encoder.encode_batch(docs), np.float32)
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-8)
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
    cos = q @ d.T
    n = len(claims)
    order = np.argsort(-cos, axis=1)
    ranks = np.empty(n, np.int64)
    for i in range(n):
        ranks[i] = int(np.where(order[i] == i)[0][0]) + 1
    return {
        "retrieval_at_1": float((ranks == 1).mean()),
        "mrr": float((1.0 / ranks).mean()),
        "top5": float((ranks <= 5).mean()),
    }


def meets_gate(results: dict):
    """new >= old on every metric; None without an old provider."""
    if "old" not in results:
        return None
    return bool(all(results["new"][k] >= results["old"][k] for k in METRICS))


def rounds_of_facts(rng: np.random.RandomState, n: int, rounds: int):
    """Each round's (claims, docs): ``n`` distinct facts, each rendered as
    a claim and as a document."""
    from fvd_tpu_torch.tools.pretrain_text_encoder import make_fact, render_doc, render_fact

    for _ in range(rounds):
        seen, claims, docs = set(), [], []
        while len(claims) < n:
            f = make_fact(rng)
            key = json.dumps(f, sort_keys=True)
            if key in seen:
                continue
            seen.add(key)
            claims.append(render_fact(rng, f))
            docs.append(render_doc(rng, f))
        yield claims, docs


def main(argv=None) -> int:
    from fvd_tpu_torch import resolve_device
    from fvd_tpu_torch.providers.hf_models import HFTextEncoder

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--new", default="checkpoints/hf_staging/minilm")
    ap.add_argument("--old", default="checkpoints/text_encoder.npz")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=20260821)
    ap.add_argument("--cpu", action="store_true", help="embed on the CPU instead of the card")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    new = HFTextEncoder.from_local(args.new, device=device)
    old = None
    if os.path.exists(args.old):
        from fvd_tpu_torch.models import encoders

        meta = {}
        sidecar = args.old.replace(".npz", ".json")
        if os.path.exists(sidecar):
            with open(sidecar) as fh:
                meta = json.load(fh)
        old = encoders.JaxTextEncoder(checkpoint=args.old, dim=int(meta.get("dim", 192)),
                                      depth=int(meta.get("depth", 6)), out_dim=int(meta.get("out_dim", 256)),
                                      device=device)

    agg = {"new": [], "old": []}
    for claims, docs in rounds_of_facts(np.random.RandomState(args.seed), args.n, args.rounds):
        agg["new"].append(ranking_metrics(new, claims, docs))
        if old is not None:
            agg["old"].append(ranking_metrics(old, claims, docs))

    results = {}
    for name, rounds in agg.items():
        if not rounds:
            continue
        results[name] = {k: float(np.mean([r[k] for r in rounds])) for k in rounds[0]}
        m = results[name]
        print(f"[{name}] retrieval@1={m['retrieval_at_1']:.3f} mrr={m['mrr']:.3f} top5={m['top5']:.3f}")
    results["meets_verdict_gate"] = meets_gate(results)
    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
