"""V5: texture / ELA forensics: the port of ``fvd_tpu/nodes/v5_forensics.py``.

Reference behavior (``nodes/V_nodes/v5_texture_ela.py:13-179``): pick the
top-3 frames by (first face confidence x area), produce an ELA image and an
FFT log-magnitude spectrum per crop, send (original, ELA, FFT) to a vision
LLM with a strict JSON ``{fake_probability, reasoning}`` contract, and score
the mean; missing faces/crops/credentials all yield 0.0 with a reason.

ELA is the DCT-domain JPEG approximation of ``ops/forensics.py``, one
shape-bucketed batch on ``device`` (default the card) per video, or per
coalesced group of videos; the spectrum is the host FFT.  The artifacts are
``ela_analysis/ela_<i>.png`` and ``fft_<i>.png`` (the JAX package writes
JPEG files); the images sent to the vision LLM are the JPEG bytes OpenCV
gives the JAX package (``utils/jpeg.py``), which a recorded LLM scores.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.ops import forensics
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.coalesce import run_program
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.runtime.io_pool import ArtifactWriter
from fvd_tpu_torch.state import State, StateDelta
from fvd_tpu_torch.utils.jpeg import encode_jpeg
from fvd_tpu_torch.utils.png import decode_png


def _safe_float(val, default=None):
    try:
        return float(val)
    except (TypeError, ValueError):
        return default


def _load_crop(face_info: Dict[str, Any]) -> Optional[np.ndarray]:
    """Crop pixels: V1's in-memory crop, else the PNG at ``crop_path``."""
    if "crop" in face_info and face_info["crop"] is not None:
        return np.asarray(face_info["crop"], np.uint8)
    path = face_info.get("crop_path")
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return decode_png(f.read())[..., :3]
    return None


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
    device=None,
) -> StateDelta:
    providers = providers or get_providers()
    dev = resolve_device(device)
    cfg = config.forensics
    face_detections = state.get("face_detections", []) or []
    output_dir = state.get("data_dir")

    if not face_detections:
        print("V5: no faces detected to analyze.")
        return {"texture_ela_score": 0.0, "texture_ela_details": {"reason": "No faces found"}}

    valid = [f for f in face_detections if f.get("faces")]
    if not valid:
        print("V5: detections present but no crops were generated.")
        return {
            "texture_ela_score": 0.0,
            "texture_ela_details": {"reason": "No face crops available"},
        }

    # top-K by confidence x area of the main face (v5:33-42)
    ranked = sorted(
        valid,
        key=lambda x: (
            x["faces"][0]["confidence"] * x["faces"][0]["bbox"]["w"] * x["faces"][0]["bbox"]["h"]
        ),
        reverse=True,
    )
    selected = ranked[: cfg.top_k_faces]

    ela_dir = None
    if output_dir:
        ela_dir = os.path.join(output_dir, "ela_analysis")
        os.makedirs(ela_dir, exist_ok=True)

    crops: List[Optional[np.ndarray]] = []
    for face_data in selected:
        try:  # per-face isolation: one bad entry never loses the others
            crop = _load_crop(face_data["faces"][0])
        except Exception as e:
            print(f"V5: error loading face crop: {e}")
            crop = None
        crops.append(crop if crop is not None and crop.size else None)
    present = [c for c in crops if c is not None]

    # ELA for every selected crop in ONE shape-bucketed batch; concurrent
    # videos' crop sets of one bucket merge into one batch under the program
    # coalescer.  The spectrum (global over each crop's exact shape) runs on
    # the host.
    step = forensics._ELA_BUCKET
    hb = max(step, -(-max((c.shape[0] for c in present), default=8) // step) * step)
    wb = max(step, -(-max((c.shape[1] for c in present), default=8) // step) * step)

    def _run_batch(crop_lists):
        flat = [c for lst in crop_lists for c in lst]
        res = forensics.ela_batch(flat, cfg.jpeg_quality, device=dev)
        out, o = [], 0
        for lst in crop_lists:
            out.append(res[o: o + len(lst)])
            o += len(lst)
        return out

    elas = iter(run_program("v5_ela", (hb, wb, cfg.jpeg_quality, str(dev)), present, _run_batch))
    ela_by_idx = [None if c is None else next(elas) for c in crops]

    writer = ArtifactWriter()
    analysis_results: List[Dict[str, Any]] = []
    for i, (face_data, crop) in enumerate(zip(selected, crops)):
        try:
            if crop is None:
                continue
            ela = np.asarray(ela_by_idx[i]).astype(np.uint8)
            spectrum = forensics.fft_spectrum_host(
                forensics.rgb_to_gray_host(crop)
            ).astype(np.uint8)
            spectrum_rgb = np.stack([spectrum] * 3, axis=-1)

            if ela_dir:
                writer.save_png(os.path.join(ela_dir, f"ela_{i}.png"), ela)
                writer.save_png(os.path.join(ela_dir, f"fft_{i}.png"), spectrum_rgb)

            if providers.llm.available:
                result = providers.llm.vision_json(
                    "You are a forensic image analyst specializing in deepfake "
                    "detection. You MUST return a JSON object (nothing else) "
                    "with keys 'fake_probability' and 'reasoning'.",
                    "Analyze this face for manipulation. Return JSON.",
                    [encode_jpeg(crop), encode_jpeg(ela), encode_jpeg(spectrum_rgb)],
                )
                if isinstance(result, dict):
                    analysis_results.append(result)
        except Exception as e:
            print(f"V5: error analyzing face {i}: {e}")
    writer.drain()

    scores = []
    for r in analysis_results:
        val = _safe_float(r.get("fake_probability") if isinstance(r, dict) else r)
        if val is not None:
            scores.append(val)

    if scores:
        avg = sum(scores) / len(scores)
        dump_node_debug(
            output_dir, "V5", {"faces_analyzed": len(analysis_results), "avg_score": avg}
        )
        return {"texture_ela_score": avg, "texture_ela_details": analysis_results}

    print("V5: no analysis results generated.")
    return {
        "texture_ela_score": 0.0,
        "texture_ela_details": {"reason": "Analysis failed or no keys"},
    }
