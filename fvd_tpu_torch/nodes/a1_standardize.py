"""A1: audio standardization — resample to 16 kHz mono PCM: the port of
``fvd_tpu/nodes/a1_standardize.py``.

Reference behavior (``nodes/A_nodes/a1_demux_audio_extract.py:5-52``):
``audio.wav`` in ``data_dir`` -> ``audio_16k.wav`` (16 kHz, mono, s16),
metadata gains ``audio_sample_rate``/``audio_channels``; missing input is a
warn-and-skip no-op.

The resampler is the polyphase sum of ``fvd_tpu_torch/ops/resample.py`` on
``device`` (default the card); the 16 kHz signal stays there as
``audio_16k`` for A3.  Under multi-video overlap, videos with the same
(length, rates) resample as one batched call with one fetch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.ops.resample import resample_batch
from fvd_tpu_torch.providers.coalesce import run_program
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta
from fvd_tpu_torch.utils.wav import read_wav, to_mono, write_wav


def run(state: State, config: Config = default_config(), device=None) -> StateDelta:
    dev = resolve_device(device)
    output_dir = state.get("data_dir")
    if not output_dir or not os.path.exists(output_dir):
        print(f"A1: data directory not found at {output_dir}")
        return {}

    input_path = os.path.join(output_dir, "audio.wav")
    if not os.path.exists(input_path):
        print(f"A1: audio file not found at {input_path}; skipping standardization.")
        return {}

    target_sr = config.audio.target_sr
    samples, sr = read_wav(input_path)
    mono = np.asarray(to_mono(samples), np.float32)
    if sr == target_sr:
        resampled = mono
        resampled_dev = torch.from_numpy(mono).to(dev)
    else:
        def _run_batch(monos):
            out = resample_batch(torch.from_numpy(np.stack(monos)).to(dev), sr, target_sr)
            host = out.cpu().numpy()  # one fetch for the group
            return [(host[i], out[i]) for i in range(len(monos))]

        resampled, resampled_dev = run_program(
            "a1_resample", (len(mono), sr, target_sr, str(dev)), mono, _run_batch)

    output_path = os.path.join(output_dir, "audio_16k.wav")
    write_wav(output_path, resampled, target_sr)

    metadata = dict(state.get("metadata", {}) or {})
    metadata["audio_sample_rate"] = target_sr
    metadata["audio_channels"] = 1

    dump_node_debug(output_dir, "A1", {"audio_path": output_path})
    return {"metadata": metadata, "audio_16k": resampled_dev}
