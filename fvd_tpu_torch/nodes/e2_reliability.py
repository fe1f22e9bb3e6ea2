"""E2: source reliability scoring: the port of
``fvd_tpu/nodes/e2_reliability.py``, its prompt and heuristic unchanged.  The
trust tiers are read from the repo's ``assets/trusted_sources.json``.

Reference behavior (``nodes/E_nodes/e2_source_reliability.py:282-354``):
per-claim consensus map of unique domains, per-item scoring fanned out over a
thread pool, LLM-primary scoring with a heuristic fallback whose exact
arithmetic is a golden contract (``tests/test_e2_reliability.py``):

base 0.5, +0.4 .gov/.mil, +0.3 .edu, +0.3 high-trust / +0.1 medium-trust,
+0.1 https, +0.1 about-page, +0.1 consensus(>2 domains), capped at 1.0.
"""

from __future__ import annotations

import json
import os
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, List, Optional

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def load_trusted_sources(assets_dir: str = "assets") -> Dict[str, List[str]]:
    """Load trust tiers; tolerant of both this framework's tiered format and
    a flat {high_trust, medium_trust} layout."""
    candidates = [
        os.path.join(assets_dir, "trusted_sources.json"),
        os.path.join(os.getcwd(), assets_dir, "trusted_sources.json"),
        os.path.join(os.path.dirname(__file__), "..", "..", "assets", "trusted_sources.json"),
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                if "tiers" in data:
                    return {
                        "high_trust": data["tiers"].get("high", []),
                        "medium_trust": data["tiers"].get("medium", []),
                    }
                return {
                    "high_trust": data.get("high_trust", []),
                    "medium_trust": data.get("medium_trust", []),
                }
            except Exception:
                break
    return {"high_trust": [], "medium_trust": []}


def get_domain(url: str) -> str:
    """Hostname without www. (reference e2:71-81)."""
    try:
        domain = urllib.parse.urlparse(url).netloc
        if domain.startswith("www."):
            domain = domain[4:]
        return domain.lower()
    except Exception:
        return ""


def check_about_page(url: str, timeout_s: float = 2.0) -> bool:
    """Probe <scheme>://<host>/about (reference e2:83-116). Network access —
    only invoked when config.evidence.enable_about_page_probe is set."""
    import urllib.request

    try:
        parsed = urllib.parse.urlparse(url)
        req = urllib.request.Request(
            f"{parsed.scheme}://{parsed.netloc}/about",
            headers={"User-Agent": "Mozilla/5.0"},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status == 200
    except Exception:
        return False


def llm_reliability(
    providers: Providers, domain: str, url: str, snippet: str, claim_text: str
) -> Optional[Dict[str, Any]]:
    """LLM-primary scoring (reference e2:118-192). Returns {score, reason}
    or None -> heuristic fallback."""
    if not providers.llm.available:
        return None
    prompt = (
        "You are an expert fact-checker evaluating source reliability.\n"
        f"SOURCE DETAILS:\n- Domain: {domain}\n- URL: {url}\n"
        f"- Claim being verified: {claim_text}\n- Content snippet: {snippet[:500]}\n"
        "Score reliability 0.0 (completely unreliable) to 1.0 (highly "
        "reliable) considering domain authority, content quality, citations, "
        "objectivity and professionalism. Return ONLY a JSON object "
        '{"score": <float>, "reason": "<brief explanation>"}'
    )
    result = providers.llm.chat_json(
        "You are a helpful assistant that outputs JSON.", prompt
    )
    if not result or not isinstance(result.get("score"), (int, float)):
        return None
    return {
        "score": max(0.0, min(1.0, float(result["score"]))),
        "reason": result.get("reason", "No reason provided"),
    }


def heuristic_reliability(
    url: str,
    trusted: Dict[str, List[str]],
    consensus_count: int,
    config: Config = default_config(),
    probe_about: bool = False,
) -> Dict[str, Any]:
    """The golden heuristic arithmetic (reference e2:219-267)."""
    ev = config.evidence
    domain = get_domain(url)
    score = ev.base_score
    details: List[str] = []

    if domain.endswith(".gov") or domain.endswith(".mil"):
        score += ev.gov_bonus
        details.append(f"Government/Military domain (+{ev.gov_bonus})")
    elif domain.endswith(".edu"):
        score += ev.edu_bonus
        details.append(f"Educational domain (+{ev.edu_bonus})")

    def in_tier(tier: List[str]) -> bool:
        return any(domain == t or domain.endswith("." + t) for t in tier)

    if in_tier(trusted.get("high_trust", [])):
        score += ev.high_trust_bonus
        details.append(f"High trust source (+{ev.high_trust_bonus})")
    elif in_tier(trusted.get("medium_trust", [])):
        score += ev.medium_trust_bonus
        details.append(f"Medium trust source (+{ev.medium_trust_bonus})")

    if url.startswith("https://"):
        score += ev.https_bonus
        details.append(f"Secure protocol (HTTPS) (+{ev.https_bonus})")

    if probe_about and check_about_page(url, ev.about_page_timeout_s):
        score += ev.about_page_bonus
        details.append(f"About page found (+{ev.about_page_bonus})")

    if consensus_count > ev.consensus_min_domains:
        score += ev.consensus_bonus
        details.append(f"Consensus boost ({consensus_count} sources) (+{ev.consensus_bonus})")

    return {"score": min(1.0, score), "details": details}


def score_item(
    item: Dict[str, Any],
    trusted: Dict[str, List[str]],
    consensus_map: Dict[str, int],
    providers: Providers,
    config: Config,
) -> Dict[str, Any]:
    new_item = dict(item)
    url = item.get("url", "")
    claim_text = item.get("claim_text", "")
    start = time.time()
    if not url:
        new_item["reliability_score"] = 0.0
        new_item["reliability_details"] = ["No URL provided"]
        return new_item

    llm_result = llm_reliability(providers, get_domain(url), url, item.get("snippet", ""), claim_text)
    if llm_result is not None:
        new_item["reliability_score"] = llm_result["score"]
        new_item["reliability_details"] = [f"LLM: {llm_result['reason']}"]
    else:
        h = heuristic_reliability(
            url,
            trusted,
            consensus_map.get(claim_text, 0),
            config,
            probe_about=config.evidence.enable_about_page_probe,
        )
        new_item["reliability_score"] = h["score"]
        new_item["reliability_details"] = h["details"]
    new_item["_e2_elapsed"] = time.time() - start
    return new_item


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    evidence_list = state.get("evidence", []) or []
    if not evidence_list:
        print("E2: no evidence found to score.")
        return {}

    trusted = load_trusted_sources(config.assets_dir)

    # Consensus: unique domains per claim (e2:310-322).
    claim_domains: Dict[str, set] = {}
    for item in evidence_list:
        claim = item.get("claim_text", "unknown")
        domain = get_domain(item.get("url", ""))
        if claim and domain:
            claim_domains.setdefault(claim, set()).add(domain)
    consensus_map = {k: len(v) for k, v in claim_domains.items()}

    scored: List[Dict[str, Any]] = []
    with ThreadPoolExecutor(max_workers=config.evidence.max_workers) as pool:
        futures = {
            pool.submit(score_item, item, trusted, consensus_map, providers, config): item
            for item in evidence_list
        }
        for fut in as_completed(futures):
            original = futures[fut]
            try:
                new_item = fut.result()
                new_item.pop("_e2_elapsed", None)
                scored.append(new_item)
            except Exception as e:
                err_item = dict(original)
                err_item["reliability_score"] = 0.0
                err_item["reliability_details"] = [f"Scoring failed: {e}"]
                scored.append(err_item)

    dump_node_debug(state.get("data_dir"), "E2", {"evidence_scored": len(scored)})
    return {"evidence": scored}
