"""E1: web evidence retrieval: the port of ``fvd_tpu/nodes/e1_evidence.py``.

Reference behavior (``nodes/E_nodes/e1_web_evidence.py:52-363``): normalize
claims (UUID ids), build 7 query variants per claim (fact-check / is-it-true
/ proof / evidence-for / debunked / fake / hoax + who-what controversy),
search with the fallback chain, URL-dedup, re-rank by embedding cosine, keep
top-5 per claim, flatten with claim context, polite rate limiting, in-memory
query cache, and rewrite ``claims`` with ids.

The searcher is a provider (``providers/search.py``) and ranking embeds with
the pluggable text encoder; an encoder with ``encode_batch`` embeds the
(claim + results) texts in one call instead of the reference's per-result
``model.encode`` loop (e1:342-347).
"""

from __future__ import annotations

import time
import uuid
from datetime import datetime
from typing import Any, Dict, List, Optional

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.encoders import cosine
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def normalize_claims(claims_raw: List[Any]) -> List[Dict[str, Any]]:
    """str|dict claims -> typed claims with stable ids (e1:89-115)."""
    claims: List[Dict[str, Any]] = []
    for c in claims_raw:
        claim_id = str(uuid.uuid4())
        if isinstance(c, dict):
            if "id" in c:
                claim_id = str(c["id"])
            claims.append(
                {
                    "id": claim_id,
                    "claim_text": c.get("claim_text", str(c)),
                    "who": c.get("who"),
                    "what": c.get("what"),
                    "when": c.get("when"),
                    "where": c.get("where"),
                }
            )
        else:
            claims.append(
                {"id": claim_id, "claim_text": str(c), "who": None, "what": None, "when": None, "where": None}
            )
    return claims


def construct_queries(claim: Dict[str, Any]) -> List[str]:
    """Supporting + contradicting query variants (e1:196-218)."""
    text = claim["claim_text"]
    queries = {
        f"{text} fact check",
        f"is it true that {text}",
        f"proof that {text}",
        f"evidence for {text}",
        f"{text} debunked",
        f"{text} fake",
        f"{text} hoax",
    }
    if claim.get("who") and claim.get("what"):
        queries.add(f"{claim['who']} {claim['what']} controversy")
    return list(queries)


def deduplicate(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    seen = set()
    unique = []
    for r in results:
        if r["url"] not in seen:
            seen.add(r["url"])
            unique.append(r)
    return unique


def rank_results(
    results: List[Dict[str, Any]], claim_text: str, providers: Providers
) -> List[Dict[str, Any]]:
    """Embedding-cosine re-rank (e1:330-354); one batched encode."""
    if not results:
        return []
    try:
        texts = [claim_text] + [f"{r['title']} {r['snippet']}" for r in results]
        encode_batch = getattr(providers.text_encoder, "encode_batch", None)
        if encode_batch is not None:
            embs = encode_batch(texts)  # ONE batched device forward
        else:
            embs = [providers.text_encoder.encode(t) for t in texts]
        query_emb = embs[0]
        for r, emb in zip(results, embs[1:]):
            r["relevance_score"] = cosine(query_emb, emb)
        results.sort(key=lambda x: x["relevance_score"], reverse=True)
    except Exception:
        pass
    return results


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    cfg = config.evidence
    claims_raw = state.get("claims", []) or []
    use_cache = state.get("use_cache", True)
    if not claims_raw:
        print("E1: no claims found in state; skipping web evidence.")
        return {}

    claims = normalize_claims(claims_raw)
    cache: Dict[str, List[Dict[str, Any]]] = {}
    evidence_results: List[Dict[str, Any]] = []

    for claim in claims:
        query_variants = construct_queries(claim)
        all_results: List[Dict[str, Any]] = []
        for query in query_variants:
            if use_cache and query in cache:
                results = cache[query]
            else:
                try:
                    results = providers.search.search(query, cfg.results_per_claim)
                except Exception:
                    results = []
                if use_cache and results:
                    cache[query] = results
                if cfg.rate_limit_s > 0:
                    time.sleep(cfg.rate_limit_s)
            all_results.extend(dict(r) for r in results)

        ranked = rank_results(deduplicate(all_results), claim["claim_text"], providers)
        for res in ranked[: cfg.results_per_claim]:
            flat = dict(res)
            flat["claim_id"] = claim["id"]
            flat["claim_text"] = claim["claim_text"]
            flat["query_variants"] = query_variants
            flat["retrieval_timestamp"] = datetime.now().isoformat()
            evidence_results.append(flat)

    dump_node_debug(
        state.get("data_dir"),
        "E1",
        {"claims": len(claims), "evidence_items": len(evidence_results)},
    )
    # claims rewritten with ids so E3 can align (e1:115)
    return {"claims": claims, "evidence": evidence_results}
