"""Pipeline state: a typed, last-writer-wins merged record.  The port's copy
of ``fvd_tpu/state.py``.

The reference models shared state as a TypedDict of ~24 keys, every one
``Annotated[..., overwrite]`` where ``overwrite(left, right) = right``
(reference ``main.py:19-54``), so parallel DAG branches can be joined by a
superstep scheduler with deterministic last-writer-wins semantics.  Nodes
communicate *only* through this record plus files under ``data_dir``.

Here the same contract is a ``dataclass`` with a declared schema:

* host-side metadata (paths, transcripts, claims, evidence) stays as plain
  Python objects;
* array-valued fields (``audio_envelope``, ``frames`` …) may hold
  ``torch.Tensor``/``numpy`` values — the dataclass is not traced itself; the
  device work happens inside nodes, which receive the state read-only and
  return a :class:`StateDelta` (a plain dict of updated keys).

``merge_states`` applies deltas in arrival order — the analog of the
reference's ``overwrite`` reducer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

#: A node's output: a mapping of state-field updates (last writer wins).
StateDelta = Dict[str, Any]


@dataclass
class State:
    """Schema mirrors the reference ``State`` TypedDict (``main.py:22-54``)."""

    # --- inputs / run control ---
    input_path: str = ""
    label: Optional[int] = None
    debug: bool = False
    use_cache: bool = True

    # --- ingest outputs ---
    data_dir: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    # --- audio branch ---
    transcript: Optional[str] = None
    segments: Optional[List[dict]] = None
    word_count: Optional[int] = None
    audio_onsets: Optional[List[float]] = None
    onset_count: Optional[int] = None
    audio_envelope: Optional[Any] = None  # array-like [duration*fps]
    audio_16k: Optional[Any] = None       # device-resident mono 16k samples
                                          # (A1 output; file artifact is the
                                          # durable copy, this skips re-reads)

    # --- vision branch ---
    keyframes: Optional[List[str]] = None
    face_detections: Optional[List[dict]] = None
    ocr_results: Optional[List[dict]] = None
    mouth_landmarks: Optional[List[dict]] = None
    mouth_landmarks_viz_path: Optional[str] = None
    blink_data: Optional[List[dict]] = None
    head_pose_data: Optional[List[dict]] = None
    headpose_viz_path: Optional[str] = None

    # --- cross-modal / evidence ---
    lip_sync_score: Optional[float] = None
    gesture_check: Optional[List[dict]] = None
    texture_ela_score: Optional[float] = None
    texture_ela_details: Optional[Any] = None
    claims: Optional[List[Any]] = None
    evidence: Optional[List[dict]] = None

    # --- fusion outputs ---
    features: Optional[Dict[str, float]] = None
    fake_probability: Optional[float] = None

    # --- test hooks (reference c1:45-46) ---
    test_audio_signal: Optional[Any] = None

    # ------------------------------------------------------------------
    # dict-like access so node code reads naturally and stays close to the
    # reference's state-dict contract.
    # ------------------------------------------------------------------
    _FIELDS = None  # populated below

    def get(self, key: str, default: Any = None) -> Any:
        if key in self.field_names():
            val = getattr(self, key)
            return default if val is None else val
        return default

    def __getitem__(self, key: str) -> Any:
        if key not in self.field_names():
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self.field_names() and getattr(self, key) is not None

    @classmethod
    def field_names(cls):
        if cls._FIELDS is None:
            cls._FIELDS = tuple(
                f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")
            )
        return cls._FIELDS

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "State":
        names = set(cls.field_names())
        unknown = set(d) - names
        if unknown:
            raise KeyError(f"Unknown state keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items()})

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.field_names()}

    #: Fields merged by dict-union instead of replacement.  ``metadata`` is
    #: written by many nodes concurrently (A1/A2/A3/V1..V4 each add keys);
    #: the reference mutates one shared dict in place under LangGraph, so its
    #: effective semantics are union — pure last-writer-wins would drop the
    #: other branch's keys (e.g. V1's video_fps lost when A3 finishes later).
    _UNION_FIELDS = ("metadata",)

    def apply(self, delta: Optional[StateDelta]) -> "State":
        """Return a new State with ``delta`` applied: last writer wins per
        field, except union-merged dict fields (see _UNION_FIELDS)."""
        if not delta:
            return self
        names = set(self.field_names())
        unknown = set(delta) - names
        if unknown:
            raise KeyError(
                f"Node wrote unknown state keys: {sorted(unknown)} — "
                f"declare them in fvd_tpu_torch.state.State"
            )
        updates = dict(delta)
        for key in self._UNION_FIELDS:
            if key in updates:
                current = getattr(self, key)
                incoming = updates[key]
                if isinstance(current, dict) and isinstance(incoming, dict):
                    updates[key] = {**current, **incoming}
        return dataclasses.replace(self, **updates)


def merge_states(base: State, *deltas: Optional[StateDelta]) -> State:
    """Fold deltas into ``base`` in order (the ``overwrite`` reducer,
    reference ``main.py:19-20``)."""
    out = base
    for d in deltas:
        out = out.apply(d)
    return out
