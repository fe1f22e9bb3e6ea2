"""E3: claim-evidence aggregation: the port of ``fvd_tpu/nodes/e3_scorer.py``.

Reference behavior (``nodes/E_nodes/e3_claim_evidence_scorer.py:20-123``):
group evidence by claim_id, then exact claim_text, then substring loose
match; claim score = mean reliability of matched evidence; unmatched claims
fall back to ``global_avg * 0.5``; verdict bands >0.7 Highly Likely,
>0.4 Likely, >0.2 Possible, else Unverified; claims rewritten with
``{evidence_score (2dp), verdict, evidence_count}``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def get_verdict(score: float, config: Config = default_config()) -> str:
    ev = config.evidence
    if score > ev.verdict_highly_likely:
        return "Highly Likely"
    if score > ev.verdict_likely:
        return "Likely"
    if score > ev.verdict_possible:
        return "Possible"
    return "Unverified"


def run(state: State, config: Config = default_config()) -> StateDelta:
    evidence_list = state.get("evidence", []) or []
    claims_input = state.get("claims", []) or []

    if claims_input and isinstance(claims_input[0], str):
        claims_data: List[Any] = [{"text": c} for c in claims_input]
    else:
        claims_data = list(claims_input)
    if not claims_data:
        print("E3: no claims found to score.")
        return {}

    by_id: Dict[str, List[dict]] = {}
    by_text: Dict[str, List[dict]] = {}
    for ev in evidence_list:
        if ev.get("claim_id"):
            by_id.setdefault(ev["claim_id"], []).append(ev)
        if ev.get("claim_text"):
            by_text.setdefault(ev["claim_text"], []).append(ev)

    global_avg = 0.0
    if evidence_list:
        global_avg = sum(e.get("reliability_score", 0.0) for e in evidence_list) / max(
            len(evidence_list), 1
        )

    scored_claims: List[dict] = []
    for claim_obj in claims_data:
        if isinstance(claim_obj, dict):
            claim_text = claim_obj.get("claim_text") or claim_obj.get("text")
            claim_id = claim_obj.get("id")
        else:
            claim_text = str(claim_obj)
            claim_id = None
        if not claim_text:
            continue

        related: List[dict] = []
        if claim_id and claim_id in by_id:
            related = by_id[claim_id]
        elif claim_text in by_text:
            related = by_text[claim_text]
        else:
            lowered = claim_text.lower()
            for key, items in by_text.items():
                lk = key.lower()
                if lowered in lk or lk in lowered:
                    related.extend(items)
        evidence_count = len(related)

        final_score = 0.0
        verdict = "Unverified"
        if evidence_count > 0:
            final_score = sum(e.get("reliability_score", 0.0) for e in related) / evidence_count
            verdict = get_verdict(final_score, config)
        elif global_avg > 0:
            # fallback: half the global average (e3:94-98)
            final_score = max(final_score, global_avg * 0.5)
            verdict = get_verdict(final_score, config)
            evidence_count = len(evidence_list)

        new_claim = dict(claim_obj) if isinstance(claim_obj, dict) else {"text": claim_text}
        new_claim.setdefault("text", claim_text)
        new_claim.setdefault("claim_text", claim_text)
        new_claim.update(
            {
                "evidence_score": round(final_score, 2),
                "verdict": verdict,
                "evidence_count": evidence_count,
            }
        )
        scored_claims.append(new_claim)

    dump_node_debug(
        state.get("data_dir"),
        "E3",
        {
            "claims_scored": len(scored_claims),
            "avg_score": sum(c.get("evidence_score", 0) for c in scored_claims)
            / max(len(scored_claims), 1),
        },
    )
    return {"claims": scored_claims}
