"""LR fusion node: 9-feature logistic regression + online learning.  The
port's copy of ``fvd_tpu/nodes/lr_fusion.py``; a host node that touches no
device.

Numerically identical to the reference ``nodes/lr_node.py:82-194`` — this is
the parity contract (BASELINE.md: fake_probability within 1e-3 on the bundled
feature corpus; this implementation matches to float64 round-off):

* feature definitions and normalizations  (lr_node.py:84-140)
* stable sigmoid                          (lr_node.py:152-155)
* feature-cache persistence               (lr_node.py:168-179)
* online SGD when a label is provided     (lr_node.py:181-192)
* debug-JSON fallback recovery when upstream state keys were lost
  (lr_node.py:34-47, 65-79)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.ops import fusion
from fvd_tpu_torch.runtime.debug import dump_node_debug, read_node_debug
from fvd_tpu_torch.state import State, StateDelta


def _safe_float(val, default=0.0):
    try:
        return float(val)
    except (TypeError, ValueError):
        return default


def _pretrained_weights_path() -> str:
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo_root, "assets", "lr_weights_pretrained.json")


def load_weights(path: str) -> Dict[str, float]:
    """Tolerant weight loading (reference lr_node.py:17-25): missing file or
    malformed JSON -> empty dict (all-zero weights).

    When no local weights file exists yet, falls back to the shipped
    pretrained weights (the reference repo ships its trained
    ``lr_weights.json``; a fresh checkout scores with them rather than the
    all-zero p=0.5). Online SGD still writes updates to ``path``, which then
    takes precedence.
    """
    if not os.path.exists(path):
        pre = _pretrained_weights_path()
        if os.path.basename(path) == "lr_weights.json" and os.path.exists(pre):
            path = pre
        else:
            return {}
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            return {}
        return {k: _safe_float(v, 0.0) for k, v in data.items()}
    except Exception:
        return {}


def save_weights(path: str, weights: Dict[str, float]) -> None:
    with open(path, "w") as f:
        json.dump(weights, f, indent=2)


# ---------------------------------------------------------------------------
# Feature builders (reference lr_node.py:27-79, 84-128)
# ---------------------------------------------------------------------------
def gesture_score_from_state(state: State) -> float:
    checks = state.get("gesture_check", []) or []
    matched = sum(1 for g in checks if g.get("status") == "Consistent")
    missed = sum(1 for g in checks if g.get("status") == "Inconsistent")
    if (matched + missed) > 0:
        return matched / (matched + 0.5 * missed)
    # Recovery path: read the C2 debug artifact (lr_node.py:34-47).
    dbg = read_node_debug(state.get("data_dir"), "C2")
    if dbg:
        matched = _safe_float(dbg.get("matched"), 0.0)
        missed = _safe_float(dbg.get("inconsistent"), 0.0)
        if (matched + missed) > 0:
            return matched / (matched + 0.5 * missed)
    return 0.0


def headpose_jerk(pose_list: List[dict]) -> float:
    """Mean |Δangle|/Δt over yaw/pitch/roll (lr_node.py:49-63)."""
    if len(pose_list) < 2:
        return 0.0
    diffs: List[float] = []
    for prev, curr in zip(pose_list, pose_list[1:]):
        dt = _safe_float(curr.get("timestamp"), 0.0) - _safe_float(prev.get("timestamp"), 0.0)
        if dt <= 0:
            continue
        prev_pose = prev.get("pose", prev)
        curr_pose = curr.get("pose", curr)
        for key in ("yaw", "pitch", "roll"):
            diffs.append(
                abs(_safe_float(curr_pose.get(key), 0.0) - _safe_float(prev_pose.get(key), 0.0)) / dt
            )
    if not diffs:
        return 0.0
    return sum(diffs) / len(diffs)


def texture_score_from_state(state: State) -> float:
    raw = state.get("texture_ela_score")
    score = _safe_float(raw, None) if raw is not None else None
    if score is not None:
        return score
    # Recovery path: V5 debug artifact (lr_node.py:65-79).
    dbg = read_node_debug(state.get("data_dir"), "V5")
    if dbg:
        return _safe_float(dbg.get("avg_score"), 0.0)
    return 0.0


def build_features(state: State, config: Config = default_config()) -> Dict[str, float]:
    """The 9-feature vector with reference normalizations (lr_node.py:84-140)."""
    fus = config.fusion
    metadata = state.get("metadata", {}) or {}
    duration = _safe_float(metadata.get("duration"), 0.0)
    segments = state.get("segments", []) or []

    word_count = _safe_float(state.get("word_count"), 0.0)
    speech_rate = word_count / duration if duration > 0 else 0.0

    pause_total = 0.0
    if segments:
        sorted_segs = sorted(segments, key=lambda s: s.get("start", 0.0))
        for prev, curr in zip(sorted_segs, sorted_segs[1:]):
            gap = _safe_float(curr.get("start"), 0.0) - _safe_float(prev.get("end"), 0.0)
            if gap > 0:
                pause_total += gap
    pause_ratio = (pause_total / duration) if duration > 0 else 0.0

    lip_sync_score = _safe_float(state.get("lip_sync_score"), 0.0)
    gesture_score = gesture_score_from_state(state)

    blink_data = state.get("blink_data", []) or []
    # Note: counts EAR *samples* per minute, not detected blinks — matches
    # the reference exactly (lr_node.py:102-103).
    blink_rate = (len(blink_data) / duration) * 60.0 if duration > 0 else 0.0
    pose = state.get("head_pose_data", []) or []
    jerk = headpose_jerk(pose)

    texture_score = texture_score_from_state(state)

    claims = state.get("claims", []) or []
    evidence = state.get("evidence", []) or []
    supported = [c for c in claims if isinstance(c, dict) and _safe_float(c.get("evidence_score"), 0.0) > 0]
    avg_claim_reliability = (
        sum(_safe_float(c.get("evidence_score"), 0.0) for c in supported) / len(supported)
        if supported
        else 0.0
    )
    evidence_avg = (
        sum(_safe_float(e.get("reliability_score"), 0.0) for e in evidence) / max(len(evidence), 1)
        if evidence
        else 0.0
    )

    return {
        "speech_rate": min(speech_rate / fus.speech_rate_max, 1.0),
        "pause_ratio": pause_ratio,
        "lip_sync": lip_sync_score,
        "gesture_score": gesture_score,
        "blink_rate": min(blink_rate / fus.blink_rate_max, 1.0),
        "headpose_jerk": min(jerk / fus.headpose_jerk_max, 1.0),
        "texture": texture_score,
        "claim_reliability": avg_claim_reliability,
        "evidence_reliability": evidence_avg,
    }


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------
def run(state: State, config: Config = default_config()) -> StateDelta:
    fus = config.fusion
    features = build_features(state, config)

    weights = load_weights(fus.weights_path)
    fake_prob = fusion.predict_host(features, weights)

    dump_node_debug(
        state.get("data_dir"),
        "LR",
        {"fake_probability": fake_prob, "features": features},
    )

    # Feature-cache persistence (lr_node.py:168-179).
    input_path = state.get("input_path", "")
    if input_path:
        try:
            os.makedirs(fus.features_dir, exist_ok=True)
            video_name = os.path.basename(input_path)
            with open(os.path.join(fus.features_dir, f"{video_name}.json"), "w") as f:
                json.dump(features, f, indent=2)
        except Exception as e:
            print(f"LR: Warning - failed to save feature cache: {e}")

    # Online SGD (lr_node.py:181-192).
    label = state.get("label")
    if label in (0, 1):
        new_weights, _ = fusion.sgd_update_host(
            features, weights, label, lr=fus.learning_rate
        )
        try:
            save_weights(fus.weights_path, new_weights)
        except Exception as e:
            print(f"LR: Warning - failed to save updated weights: {e}")

    return {"features": features, "fake_probability": fake_prob}
