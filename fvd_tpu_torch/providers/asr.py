"""ASR provider seam: the protocol and the Null, Scripted and EnergyVAD
providers of ``fvd_tpu/providers/asr.py``.

The reference's A2 runs Whisper base (``a2_vad_asr.py:27-30``) and its tests
mock the model entirely (``tests/test_a2_vad_asr.py:24-56``).  The protocol
returns the Whisper result shape: ``{"text": str, "segments":
[{start, end, text}]}``.  NullASR makes A2 a no-op; ScriptedASR is the
test/hermetic implementation; EnergyVAD produces real speech segments (no
words) from the RMS envelope on the device, so downstream pause-ratio
features stay meaningful without a model.  The model that transcribes is
``fvd_tpu_torch.models.asr.JaxASR``; the HF Whisper drop-in is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol

import torch

from fvd_tpu_torch import resolve_device


class ASRProvider(Protocol):
    def transcribe(self, audio_path: str, audio=None) -> Optional[Dict[str, Any]]:
        """Whisper-shaped result (``audio``: optional in-memory 16 kHz
        samples that skip the file read) or None when unavailable."""
        ...

    @property
    def model_name(self) -> str: ...


class NullASR:
    model_name = "null"

    def transcribe(self, audio_path: str, audio=None) -> Optional[Dict[str, Any]]:
        return None


class ScriptedASR:
    model_name = "scripted"

    def __init__(self, text: str = "", segments: Optional[List[dict]] = None):
        self.text = text
        self.segments = segments if segments is not None else []

    def transcribe(self, audio_path: str, audio=None) -> Optional[Dict[str, Any]]:
        return {"text": self.text, "segments": self.segments}


class EnergyVAD:
    """Voice-activity segmentation from the RMS envelope, computed on
    ``device`` (default the card) with one fetch.

    Produces empty text but real ``segments`` so LR's pause_ratio feature
    (lr_node.py:89-96 analog) is computable hermetically.
    """

    model_name = "energy_vad"

    def __init__(self, frame_s: float = 0.05, threshold_ratio: float = 0.2, min_gap_s: float = 0.3,
                 device=None):
        self.frame_s = frame_s
        self.threshold_ratio = threshold_ratio
        self.min_gap_s = min_gap_s
        self.device = resolve_device(device)

    def transcribe(self, audio_path: str, audio=None) -> Optional[Dict[str, Any]]:
        from fvd_tpu_torch.ops.spectral import rms_envelope
        from fvd_tpu_torch.utils.wav import read_wav, to_mono

        sr = 16000
        if audio is None:
            try:
                samples, sr = read_wav(audio_path)
            except Exception:
                return None
            audio = to_mono(samples)
        y = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        hop = max(int(sr * self.frame_s), 1)
        env = rms_envelope(y, frame_length=2 * hop, hop=hop).cpu().numpy()
        if env.size == 0:
            return {"text": "", "segments": []}
        thr = float(env.max()) * self.threshold_ratio
        active = env > thr

        segments: List[dict] = []
        start = None
        for i, a in enumerate(active):
            t = i * self.frame_s
            if a and start is None:
                start = t
            elif not a and start is not None:
                segments.append({"start": start, "end": t, "text": ""})
                start = None
        if start is not None:
            segments.append({"start": start, "end": len(active) * self.frame_s, "text": ""})

        # merge segments separated by < min_gap_s
        merged: List[dict] = []
        for seg in segments:
            if merged and seg["start"] - merged[-1]["end"] < self.min_gap_s:
                merged[-1]["end"] = seg["end"]
            else:
                merged.append(seg)
        return {"text": "", "segments": merged}
