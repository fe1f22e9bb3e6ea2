"""C3: claim extraction from transcript + OCR text: the port of
``fvd_tpu/nodes/c3_claims.py``, its prompt unchanged.

Reference behavior (``nodes/C_nodes/c3_claim_extraction.py:19-115``): an
LLM-only JSON-mode extraction over ``transcript[:4000]`` and OCR text
``[:2000]``; each claim becomes ``{claim_text, text, source: <provider>,
confidence: 0.95}``; failures and absent credentials yield an empty list.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def collect_ocr_text(ocr_results: List[Any]) -> str:
    parts: List[str] = []
    for item in ocr_results or []:
        if isinstance(item, str):
            parts.append(item)
        elif isinstance(item, dict):
            if "detections" in item:
                parts.extend(d.get("text", "") for d in item["detections"])
            else:
                parts.append(item.get("text", ""))
    return "\n".join(p for p in parts if p)


def extract_claims(
    transcript: str, ocr_results: List[Any], providers: Providers
) -> List[Dict[str, Any]]:
    if not providers.llm.available:
        return []
    ocr_text = collect_ocr_text(ocr_results)
    prompt = (
        "You are a fact-checking assistant. Extract verifiable factual "
        "claims from the following text sources.\n\n"
        f"TRANSCRIPT:\n{transcript[:4000]}\n\n"
        f"ON-SCREEN TEXT (OCR):\n{ocr_text[:2000]}\n\n"
        "Instructions:\n"
        "1. Identify specific, factual claims that can be verified "
        "(statistics, events, quotes, scientific facts).\n"
        "2. Ignore opinions, questions, or vague statements.\n"
        '3. Return a JSON object with a key "claims" containing a list of '
        "strings.\n"
        '4. If no claims are found, return {"claims": []}.'
    )
    result = providers.llm.chat_json(
        "You are a helpful assistant that outputs JSON.", prompt
    )
    if not result:
        return []
    claims = result.get("claims", [])
    if not isinstance(claims, list):
        return []  # JSON mode can legally return a string here
    return [
        {"claim_text": txt, "text": txt, "source": "llm", "confidence": 0.95}
        for txt in claims
        if isinstance(txt, str)
    ]


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    transcript = state.get("transcript", "") or ""
    ocr_results = state.get("ocr_results", []) or []

    final_claims = extract_claims(transcript, ocr_results, providers)
    if final_claims:
        print(f"C3: extracted {len(final_claims)} claims.")
    else:
        print("C3: extraction unavailable or returned no claims.")

    dump_node_debug(state.get("data_dir"), "C3", {"claims": len(final_claims)})
    return {"claims": final_claims}
