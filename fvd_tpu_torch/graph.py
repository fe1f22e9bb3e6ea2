"""The 16-node analysis DAG: the port of ``fvd_tpu/graph.py``.

Wiring matches the reference exactly (``main.py:316-341``):

    IN -> A1 -> {A2, A3};  IN -> V1 -> {V2, V3, V4, V5, C2}
    A3, V3 -> C1;  A2 -> C2;  A2, V2 -> C3
    C3 -> E1 -> E2 -> E3
    A2, C1, C2, V4, V5, E3 -> LR

(The reference Streamlit display adds C3->E3 / E1->E3 and drops A2->LR —
a display-only divergence SURVEY §3.2 flags; we wire the real graph.)

``device`` (default the card) goes to the nodes with device work of their
own: A1, A3, C1 and V5.  V1, V3 and V4 run on their providers' device, and
A2's EnergyVAD on its own.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.nodes import (
    a1_standardize,
    a2_asr,
    a3_onsets,
    c1_lipsync,
    c2_gesture,
    c3_claims,
    e1_evidence,
    e2_reliability,
    e3_scorer,
    ingest,
    lr_fusion,
    v1_faces,
    v2_ocr,
    v3_landmarks,
    v4_dynamics,
    v5_forensics,
)
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.runtime.dag import DAG

#: Display order for status boards (reference app.py node list).
NODE_ORDER = [
    "IN", "A1", "V1", "A2", "A3", "V2", "V3", "V4", "V5",
    "C1", "C2", "C3", "E1", "E2", "E3", "LR",
]


def build_graph(
    config: Optional[Config] = None, providers: Optional[Providers] = None, device=None
) -> DAG:
    cfg = config or default_config()
    prov = providers or get_providers()
    dev = resolve_device(device)

    def with_prov(fn, **kw):
        return partial(fn, config=cfg, providers=prov, **kw)

    def with_cfg(fn, **kw):
        return partial(fn, config=cfg, **kw)

    dag = DAG()
    dag.add_node("IN", with_cfg(ingest.run, device=dev), host_only=True)
    dag.add_node("A1", with_cfg(a1_standardize.run, device=dev), deps=["IN"])
    dag.add_node("V1", with_prov(v1_faces.run, device=dev), deps=["IN"])
    dag.add_node("A2", with_prov(a2_asr.run), deps=["A1"])
    dag.add_node("A3", with_cfg(a3_onsets.run, device=dev), deps=["A1"])
    dag.add_node("V2", with_prov(v2_ocr.run), deps=["V1"])
    dag.add_node("V3", with_prov(v3_landmarks.run, device=dev), deps=["V1"])
    dag.add_node("V4", with_prov(v4_dynamics.run, device=dev), deps=["V1"])
    dag.add_node("V5", with_prov(v5_forensics.run, device=dev), deps=["V1"])
    dag.add_node("C1", with_cfg(c1_lipsync.run, device=dev), deps=["A3", "V3"])
    dag.add_node("C2", with_prov(c2_gesture.run), deps=["A2", "V1"])
    dag.add_node("C3", with_prov(c3_claims.run), deps=["A2", "V2"], host_only=True)
    dag.add_node("E1", with_prov(e1_evidence.run), deps=["C3"], host_only=True)
    dag.add_node("E2", with_prov(e2_reliability.run), deps=["E1"], host_only=True)
    dag.add_node("E3", with_cfg(e3_scorer.run), deps=["E2"])
    dag.add_node("LR", with_cfg(lr_fusion.run), deps=["A2", "C1", "C2", "V4", "V5", "E3"])
    return dag.validate()
