"""C1: lip-sync scoring node, the port of ``fvd_tpu/nodes/c1_lipsync.py``.

Host shell around the C1 stage (``fvd_tpu_torch/ops/lipsync.py``: one launch
of ``csrc/lipsync_score.cu`` on the card, its plain version on the CPU).
Early-out semantics match the reference exactly
(``c1_lip_sync_score.py:29-97``):

* no ``face_detections``      -> 0.0   (c1:35-39)
* no ``mouth_landmarks``      -> 0.0   (c1:50-53)
* no fps or duration          -> 0.0   (c1:55-58)
* no audio signal             -> 0.0   (c1:94-97)
* ``test_audio_signal`` state hook takes priority over ``audio_envelope``
  (c1:45-46, 89-92).

Signal preparation (MAR per landmark sample, float64 interpolation of both
signals onto the ``duration*fps`` grid, length reconciliation) mirrors
c1:60-105; the signals are then cast to float32 on the host, where the JAX
package casts them in ``jnp.asarray``.

Under multi-video overlap (the program coalescer active) concurrent videos
of one signal length go to the card together: one host-to-device copy each
for the stacked mouth and audio rows, one kernel launch for the group and one
fetch each of the scores and valid-window counts.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.config import Config, default_config
from fvd_tpu_torch.ops import lipsync
from fvd_tpu_torch.providers.coalesce import program_coalescing_active, run_program
from fvd_tpu_torch.runtime.debug import dump_node_debug
from fvd_tpu_torch.state import State, StateDelta


def calculate_mar(mouth_points) -> float:
    """Scalar MAR for one 20-point mouth (c1:9-27)."""
    if mouth_points is None or len(mouth_points) < 20:
        return 0.0
    m = np.asarray(mouth_points, dtype=np.float64)
    A = np.linalg.norm(m[2] - m[10])
    B = np.linalg.norm(m[3] - m[9])
    C = np.linalg.norm(m[4] - m[8])
    D = np.linalg.norm(m[0] - m[6])
    if D == 0:
        return 0.0
    return float((A + B + C) / (3.0 * D))


def run(state: State, config: Config = default_config(), device=None) -> StateDelta:
    """The C1 node on ``device`` (default the card; ``"cpu"`` runs the
    stage's plain version)."""
    dev = resolve_device(device)
    cfg = config.lip_sync
    face_detections = state.get("face_detections") or []
    if len(face_detections) == 0:
        print(" C1: no faces detected upstream; lip-sync score 0.0")
        return {"lip_sync_score": 0.0}

    mouth_landmarks = state.get("mouth_landmarks")
    if not mouth_landmarks:
        print(" C1: missing mouth landmarks; lip-sync score 0.0")
        return {"lip_sync_score": 0.0}

    metadata = state.get("metadata", {}) or {}
    fps = metadata.get("fps")
    duration = metadata.get("duration")
    if not fps or not duration:
        print(" C1: missing fps/duration; lip-sync score 0.0")
        return {"lip_sync_score": 0.0}

    # Visual signal: MAR per sample, interpolated to the constant-fps grid
    # (c1:60-85).
    num_frames = int(duration * fps)
    time_axis = np.linspace(0, duration, num_frames)
    timestamps, mars = [], []
    for lm in mouth_landmarks:
        timestamps.append(lm.get("timestamp", 0.0))
        if "mar" in lm:
            mars.append(float(lm["mar"]))
        elif "landmarks" in lm:
            pts = lm["landmarks"]
            mars.append(calculate_mar(pts) if pts else 0.0)
        else:
            mars.append(0.0)
    if not timestamps:
        return {"lip_sync_score": 0.0}
    mouth_signal = np.interp(time_axis, timestamps, mars)

    # Audio signal: test hook first, then A3 envelope (c1:87-97).
    test_signal = state.get("test_audio_signal")
    envelope = state.get("audio_envelope")
    if test_signal is not None:
        audio_signal = np.asarray(test_signal, dtype=np.float64)
    elif envelope is not None:
        audio_signal = np.asarray(envelope, dtype=np.float64)
    else:
        print(" C1: no audio signal available; lip-sync score 0.0")
        return {"lip_sync_score": 0.0}

    # Length reconciliation (c1:99-105).
    if len(audio_signal) != len(mouth_signal):
        audio_signal = np.interp(
            np.linspace(0, 1, len(mouth_signal)),
            np.linspace(0, 1, len(audio_signal)),
            audio_signal,
        )
    mouth32 = mouth_signal.astype(np.float32)
    audio32 = audio_signal.astype(np.float32)

    kwargs = dict(
        window_duration_s=cfg.window_duration_s,
        max_lag_s=cfg.max_lag_s,
        silence_std=cfg.silence_std_threshold,
        sharpness_threshold=cfg.sharpness_threshold,
        sharpness_penalty=cfg.sharpness_penalty,
    )
    if program_coalescing_active():
        def _run_batch(pairs: List[Tuple[np.ndarray, np.ndarray]]):
            mouths = torch.from_numpy(np.stack([m for m, _ in pairs])).to(dev)
            audios = torch.from_numpy(np.stack([a for _, a in pairs])).to(dev)
            r = lipsync.lip_sync_score_batch(mouths, audios, fps, **kwargs)
            return [(s, v, r.n_windows) for s, v in zip(r.score.tolist(), r.n_valid.tolist())]

        score, n_valid, n_windows = run_program(
            "c1_lipsync",
            (len(mouth32), float(fps)) + tuple(sorted(kwargs.items())) + (str(dev),),
            (mouth32, audio32), _run_batch)
    else:
        r = lipsync.lip_sync_score(torch.from_numpy(mouth32).to(dev),
                                   torch.from_numpy(audio32).to(dev), fps, **kwargs)
        score, n_valid, n_windows = float(r.score), int(r.n_valid), r.n_windows

    dump_node_debug(
        state.get("data_dir"),
        "C1",
        {
            "lip_sync_score": score,
            "mouth_samples": len(mouth_landmarks),
            "audio_len": int(len(audio_signal)),
            "windows": int(n_windows),
            "valid_windows": int(n_valid),
        },
    )
    print(f" C1: lip-sync score {score:.4f}")
    return {"lip_sync_score": score}
