"""A2: voice-activity detection + speech recognition: the port of
``fvd_tpu/nodes/a2_asr.py``.

Reference behavior (``nodes/A_nodes/a2_vad_asr.py:10-65``): Whisper base
over ``audio_16k.wav`` -> ``transcript``, ``segments``, ``word_count``,
``metadata.transcription_model``; missing audio is a no-op.

The model is a provider (``providers/asr.py``): NullASR makes the node a
no-op; ScriptedASR gives a fixed transcript; EnergyVAD gives real speech
segments from the device-resident 16 kHz signal; ``models/asr.py``'s
JaxASR transcribes it.
"""

from __future__ import annotations

import os
from typing import Optional

from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.providers import Providers, get_providers
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def run(
    state: State,
    config: Config = default_config(),
    providers: Optional[Providers] = None,
) -> StateDelta:
    providers = providers or get_providers()
    data_dir = state.get("data_dir")
    audio_path = os.path.join(data_dir or "", "audio_16k.wav")
    if not data_dir or not os.path.exists(audio_path):
        print(f"A2: audio file not found at {audio_path}")
        return {}

    # A1 leaves its resampled output device-resident; providers that take
    # the in-memory audio skip the file re-read and the upload.
    try:
        result = providers.asr.transcribe(audio_path, audio=state.get("audio_16k"))
    except TypeError:
        result = providers.asr.transcribe(audio_path)
    if result is None:
        print("A2: no ASR backend available; skipping transcription.")
        return {}

    transcript = result.get("text", "") or ""
    segments = result.get("segments", []) or []

    metadata = dict(state.get("metadata", {}) or {})
    metadata["transcription_model"] = providers.asr.model_name

    dump_node_debug(
        data_dir,
        "A2",
        {"words": len(transcript.split()), "segments": len(segments)},
    )
    return {
        "transcript": transcript,
        "segments": segments,
        "word_count": len(transcript.split()),
        "metadata": metadata,
    }
