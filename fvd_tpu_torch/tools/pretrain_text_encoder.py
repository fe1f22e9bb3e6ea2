"""Contrastively pretrain the sentence TextTower for E1 evidence re-ranking
and write the npz checkpoint and sidecar the providers load:

    python -m fvd_tpu_torch.tools.pretrain_text_encoder --steps 3000 --batch 64
    python -m fvd_tpu_torch.tools.pretrain_text_encoder --steps 2 --dim 32 --depth 1 --cpu --out /tmp/te.npz

The counterpart of the JAX package's ``tools/pretrain_text_encoder.py``, with
its flags and defaults.  It fills the MiniLM-L6-v2 role (reference
``e1_web_evidence.py:330-354``): E1 embeds the claim and each search result's
"title snippet" string and ranks by cosine.  Training pairs are claim-style
sentences against re-styled paraphrases of the same fact (synonyms,
attribution order, digit/word numbers, headline and snippet framing); the
facts of a batch share templates and topics, so the slot values separate the
positives from the negatives.  The loss is the symmetric InfoNCE of
``models/encoders.text_info_nce_loss`` at temperature 0.07.  It runs on the
card unless ``--cpu`` is given, and raises where there is none; the weights
start from ``weights.seeded`` (seed 0), or from ``--out`` with ``--resume``.

The batches equal the JAX package's for the same ``--seed`` (ids and RNG
state).  After training, retrieval@1 over four 64-way batches of a held-out
seed (``--seed`` + 10 000) goes into the sidecar beside ``dim``, ``depth`` and
``out_dim``.  One last line ``[text] summary {...}`` gives, as JSON: the
steps, the median host data ms and device ms of a step (CUDA events on the
card), pairs per second, the first and last loss, and the retrieval@1.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from fvd_tpu_torch import resolve_device, weights
from fvd_tpu_torch.models.encoders import MAX_TEXT_LEN, TextTower, text_info_nce_loss
from fvd_tpu_torch.models.layers import adam, adam_step
from fvd_tpu_torch.models.transformer import ByteTokenizer
from fvd_tpu_torch.tools.pretrain_synthetic import StepTimer, step_summary

# ---------------------------------------------------------------------------
# Claim generator: one underlying fact -> (claim rendering, coverage rendering)
# ---------------------------------------------------------------------------
SYN = {
    "said": ["said", "stated", "announced", "declared", "told reporters"],
    "will": ["will", "plans to", "intends to", "is going to"],
    "cut": ["cut", "reduce", "lower", "slash"],
    "raise": ["raise", "increase", "boost", "hike"],
    "rose": ["rose", "climbed", "increased", "went up"],
    "fell": ["fell", "dropped", "declined", "went down"],
    "reported": ["reported", "confirmed", "recorded", "registered"],
    "found": ["found", "discovered", "detected", "identified"],
    "percent": ["percent", "per cent", "%"],
    "about": ["about", "around", "approximately", "roughly", "nearly"],
}

WORDS_0_20 = (
    "zero one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen twenty"
).split()

OFFICIALS = ["mayor", "governor", "senator", "council chair", "police chief",
             "health director", "school superintendent", "fire marshal"]
CITIES = ["riverton", "lakeside", "fairview", "oakdale", "mill valley",
          "cedar falls", "port hughes", "granite bay", "summit", "brookfield"]
THINGS = ["property taxes", "transit fares", "water rates", "parking fines",
          "school funding", "park budgets", "housing permits", "road tolls"]
RIVERS = ["bear", "salt", "copper", "willow", "stone", "fox", "elk", "pine"]
DISEASES = ["measles", "influenza", "whooping cough", "salmonella", "mumps"]
ORGS = ["the county health office", "state regulators", "the water authority",
        "federal inspectors", "the transit agency", "university researchers"]
COMPANIES = ["northline motors", "vexa labs", "harbor steel", "bluepeak air",
             "orchard foods", "quanta textiles"]
AGENCIES = ["the space agency", "the weather service", "the geological survey",
            "the fisheries board"]
PHENOMENA = ["a new fault line", "record ocean temperatures", "a meteor shower",
             "an unusual algae bloom", "a magnetic anomaly"]


def _num(rng) -> int:
    return int(rng.choice([2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 15, 18, 20, 25,
                           30, 40, 50, 75, 100, 200, 500]))


def make_fact(rng: np.random.RandomState) -> dict:
    """A structured fact; renderings below restyle it without changing it."""
    kind = int(rng.randint(5))
    f = {"kind": kind, "num": _num(rng)}
    if kind == 0:   # policy: official says city will cut/raise thing by N%
        f.update(who=rng.choice(OFFICIALS), where=rng.choice(CITIES),
                 verb=rng.choice(["cut", "raise"]), what=rng.choice(THINGS))
    elif kind == 1:  # flood: river rose/fell N feet
        f.update(river=rng.choice(RIVERS), verb=rng.choice(["rose", "fell"]))
    elif kind == 2:  # health: org reported N cases of disease in city
        f.update(org=rng.choice(ORGS), disease=rng.choice(DISEASES),
                 where=rng.choice(CITIES))
    elif kind == 3:  # economy: company to add/cut N jobs in city
        f.update(company=rng.choice(COMPANIES), where=rng.choice(CITIES),
                 verb=rng.choice(["add", "eliminate"]))
    else:            # science: agency found phenomenon
        f.update(agency=rng.choice(AGENCIES), what=rng.choice(PHENOMENA))
    return f


def _syn(rng, key: str) -> str:
    return str(rng.choice(SYN[key]))


def _fmt_num(rng, n: int) -> str:
    if n <= 20 and rng.rand() < 0.5:
        return WORDS_0_20[n]
    return str(n)


def render_fact(rng: np.random.RandomState, f: dict) -> str:
    """One spoken/written rendering of the fact.  Repeated calls with the
    same fact give paraphrases: synonyms, attribution order and number
    format vary; the slot values never do."""
    n = _fmt_num(rng, f["num"])
    k = f["kind"]
    if k == 0:
        core = f"{_syn(rng, f['verb'])} {f['what']} by {n} {_syn(rng, 'percent')}"
        attrib = f"the {f['who']} of {f['where']}"
        style = rng.randint(3)
        if style == 0:
            return f"{attrib} {_syn(rng, 'said')} the city {_syn(rng, 'will')} {core}"
        if style == 1:
            return f"according to {attrib}, the city {_syn(rng, 'will')} {core}"
        return f"the city {_syn(rng, 'will')} {core}, the {f['who']} {_syn(rng, 'said')}"
    if k == 1:
        lead = f"the {f['river']} river"
        if rng.rand() < 0.5:
            return f"{lead} {_syn(rng, f['verb'])} {n} feet overnight"
        return f"water levels on {lead} {_syn(rng, f['verb'])} by {n} feet"
    if k == 2:
        if rng.rand() < 0.5:
            return (f"{f['org']} {_syn(rng, 'reported')} {n} new cases of "
                    f"{f['disease']} in {f['where']}")
        return (f"{n} {f['disease']} cases were {_syn(rng, 'reported')} "
                f"in {f['where']} by {f['org']}")
    if k == 3:
        verb = "add" if f["verb"] == "add" else str(rng.choice(["eliminate", "cut"]))
        if rng.rand() < 0.5:
            return f"{f['company']} {_syn(rng, 'will')} {verb} {n} jobs in {f['where']}"
        past = {"add": "added", "eliminate": "eliminated", "cut": "cut"}[verb]
        return (f"{_syn(rng, 'about')} {n} jobs in {f['where']} "
                f"will be {past} by {f['company']}")
    if rng.rand() < 0.5:
        return f"{f['agency']} {_syn(rng, 'found')} {f['what']}"
    return f"{f['what']} was {_syn(rng, 'found')} by {f['agency']}"


TITLE_STYLES = ["Fact check: {s}", "AP verification: {s}", "Reality Check: {s}",
                "Rating: {s}", "What we know: {s}", "{s}"]
SNIPPET_STYLES = [
    "Coverage of the claim '{s}' with sourcing and context.",
    "Officials respond after reports that {s}.",
    "Our reporters examined whether {s}.",
    "New details emerge: {s}.",
]


def render_doc(rng: np.random.RandomState, f: dict) -> str:
    """A search-result-style rendering: '{title} {snippet}' — the exact
    string shape E1 embeds (nodes/e1_evidence.py rank_results)."""
    title = str(rng.choice(TITLE_STYLES)).format(s=render_fact(rng, f))
    if rng.rand() < 0.7:
        snippet = str(rng.choice(SNIPPET_STYLES)).format(s=render_fact(rng, f))
        return f"{title} {snippet}"
    return title


def make_batch(rng: np.random.RandomState, batch: int, tok, max_len: int):
    """(query ids, doc ids).  Facts in a batch reuse topics/templates, so
    negatives are same-shaped sentences with different slot values."""
    q_ids = np.zeros((batch, max_len), np.int32)
    d_ids = np.zeros((batch, max_len), np.int32)
    seen = set()
    for i in range(batch):
        while True:
            f = make_fact(rng)
            key = json.dumps(f, sort_keys=True)
            if key not in seen:
                seen.add(key)
                break
        q_ids[i] = tok.encode(render_fact(rng, f), max_len)
        d_ids[i] = tok.encode(render_doc(rng, f), max_len)
    return q_ids, d_ids


@torch.no_grad()
def retrieval_at_1(model: TextTower, seed: int, tok: ByteTokenizer, device) -> float:
    """Mean retrieval@1 over four 64-way batches drawn from ``seed``: each
    query's nearest document by cosine is its own."""
    rng = np.random.RandomState(seed)
    accs = []
    for _ in range(4):
        q_ids, d_ids = make_batch(rng, 64, tok, MAX_TEXT_LEN)
        q = model(torch.from_numpy(q_ids).to(device)).cpu().numpy()
        d = model(torch.from_numpy(d_ids).to(device)).cpu().numpy()
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        accs.append(((q @ d.T).argmax(axis=1) == np.arange(len(q))).mean())
    return float(np.mean(accs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dim", type=int, default=192)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--out-dim", type=int, default=256)
    ap.add_argument("--out", default="checkpoints/text_encoder.npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    rng = np.random.RandomState(args.seed)
    tok = ByteTokenizer()
    model = weights.seeded(TextTower(dim=args.dim, depth=args.depth, out_dim=args.out_dim), 0)
    if args.resume and os.path.exists(args.out):
        weights.load_npz(args.out, model)
        print(f"[text] resumed params from {args.out}")
    model.to(device)
    opt = adam(model, args.lr)

    def step(q_ids, d_ids):
        return adam_step(text_info_nce_loss, model, opt, torch.from_numpy(q_ids).to(device),
                         torch.from_numpy(d_ids).to(device))

    timer, losses = StepTimer(device), []
    t0 = time.perf_counter()
    for i in range(args.steps):
        q_ids, d_ids = timer.data(make_batch, rng, args.batch, tok, MAX_TEXT_LEN)
        losses.append(timer.step(step, q_ids, d_ids))
        if i % 100 == 0 or i == args.steps - 1:
            print(f"[text] step {i:4d} loss {float(losses[-1]):.3f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    seconds = time.perf_counter() - t0

    acc = retrieval_at_1(model, args.seed + 10_000, tok, device)
    print(f"[text] eval retrieval@1 (64-way, held-out seed): {acc:.3f}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    weights.save_npz(args.out, model)
    with open(args.out.replace(".npz", ".json"), "w") as fh:
        json.dump({"dim": args.dim, "depth": args.depth, "out_dim": args.out_dim, "eval_retrieval_at_1": acc}, fh)
    print(f"[text] saved {args.out} (dim={args.dim}, depth={args.depth})")
    summary = step_summary(timer, args.steps * args.batch, seconds, losses, unit="pairs",
                           eval_retrieval_at_1=acc)
    print("[text] summary " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
