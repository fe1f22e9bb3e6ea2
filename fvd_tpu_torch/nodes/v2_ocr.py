"""V2: OCR over keyframes: the port of ``fvd_tpu/nodes/v2_ocr.py``.

Reference behavior (``nodes/V_nodes/v2_ocr_overlays.py:5-80``): EasyOCR over
each keyframe; keeps ``{text, confidence, bbox}`` per detection; frames with
no text are omitted; no keyframes -> no-op; writes
``metadata.ocr_model``.

The OCR engine is a provider; production wires the detection + recognition
models of ``models/ocr.py``, hermetic runs use Null/Scripted (exactly how
the reference's tests run, ``tests/test_v2_ocr_overlays.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.providers.media import cached_keyframe_images, keyframe_device_frames
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    keyframes = state.get("keyframes", []) or []
    if not keyframes:
        print("V2: no keyframes found; skipping OCR.")
        return {}

    loaded = [(kf, im) for kf, im in zip(keyframes, cached_keyframe_images(keyframes))
              if im is not None]

    # Preferred: detection straight off the frame tensor V1 put on the
    # device (a gather there, no second upload of the frames).  Falls back
    # to one batched host forward, then to per-frame reads.
    batch_fn = getattr(providers.ocr, "read_text_batch", None)
    dev_fn = getattr(providers.ocr, "read_text_batch_device", None)
    if os.environ.get("FVD_TPU_NO_DEVICE_OCR"):  # A/B switch, read at call time
        dev_fn = None
    dev = keyframe_device_frames([kf for kf, _ in loaded], device=providers.ocr.device) \
        if (dev_fn is not None and loaded) else None
    if dev is not None:
        all_detections = dev_fn(dev, [im for _, im in loaded])
    elif batch_fn is not None and loaded:
        all_detections = batch_fn([im for _, im in loaded])
    else:
        all_detections = [providers.ocr.read_text(im) for _, im in loaded]

    ocr_results: List[dict] = []
    for (kf_path, _), detections in zip(loaded, all_detections):
        frame_text = [
            {
                "text": d.get("text", ""),
                "confidence": float(d.get("confidence", 0.0)),
                "bbox": [[int(p[0]), int(p[1])] for p in d.get("bbox", [])],
            }
            for d in detections
        ]
        if frame_text:
            ocr_results.append({"keyframe_path": kf_path, "detections": frame_text})

    metadata = dict(state.get("metadata", {}) or {})
    metadata["ocr_model"] = providers.ocr.model_name

    dump_node_debug(
        state.get("data_dir"),
        "V2",
        {
            "frames_with_text": len(ocr_results),
            "detections": sum(len(fr["detections"]) for fr in ocr_results),
        },
    )
    return {"ocr_results": ocr_results, "metadata": metadata}
