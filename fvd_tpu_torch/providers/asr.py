"""ASR provider seam: the protocol and the Null provider of
``fvd_tpu/providers/asr.py``.

The reference's A2 runs Whisper base (``a2_vad_asr.py:27-30``) and its tests
mock the model entirely (``tests/test_a2_vad_asr.py:24-56``).  The protocol
returns the Whisper result shape: ``{"text": str, "segments":
[{start, end, text}]}``.  NullASR makes A2 a no-op.  The scripted and model
providers come with the A2 node.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Protocol


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
