"""Cross-video coalesced OneEuro smoothing (V3, V4 and streaming): the port
of ``fvd_tpu/nodes/_smooth.py``.

Each video's per-chunk smoothing (``ops/filters.py`` ``one_euro_scan_chunk``
and ``v4_smooth_chunk``) is a float32 loop over the chunk's T samples on the
host.  With several videos at once these wrappers send their chunks through
the cross-video program coalescer (``providers/coalesce.py`` ``run_program``):
a group stacks its videos on the scans' leading batch axis and runs ONE loop
over T for all of them, where each video would otherwise run its own.

Chunks pad to a power-of-two time bucket with ``valid=False`` rows: an
invalid row leaves the carry untouched and outputs NaN, so the padded rows
are sliced off and the carry handed to the next chunk is the unpadded
scan's.  The step is elementwise float32 with no transcendental and no
reduction across videos, so each video's outputs and carry are bit-equal to
its own plain scan.  When the program coalescer is inactive (single-video
CLI runs, tests) the wrappers call the plain scans.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from fvd_tpu_torch.models.landmarks_fan import _pad_bucket as _bucket
from fvd_tpu_torch.ops.filters import _ears, one_euro_scan_chunk, v4_smooth_chunk


def _pad_tail(arr, pad: int) -> np.ndarray:
    arr = np.asarray(arr)
    if pad == 0:
        return arr
    return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1))


def _carry_np(carry) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(c) for c in carry)


def _stack(payloads: List[Tuple], col: int) -> Any:
    """Column ``col`` of every payload stacked on a new leading axis; a carry
    column is stacked field by field."""
    items = [p[col] for p in payloads]
    if isinstance(items[0], tuple):
        return tuple(np.stack(fields) for fields in zip(*items))
    return np.stack(items)


def _row(carry, i: int) -> Tuple[np.ndarray, ...]:
    return tuple(c[i] for c in carry)


def one_euro_scan_chunk_co(carry, times, values, valid, *, min_cutoff: float = 1.0, beta: float = 0.0,
                           d_cutoff: float = 1.0):
    """Coalesced drop-in for :func:`~fvd_tpu_torch.ops.filters.one_euro_scan_chunk`
    (V3's per-chunk landmark smoothing)."""
    from fvd_tpu_torch.providers.coalesce import program_coalescing_active, run_program

    kw = dict(min_cutoff=min_cutoff, beta=beta, d_cutoff=d_cutoff)
    if not program_coalescing_active():
        return one_euro_scan_chunk(carry, times, values, valid, **kw)
    T = int(len(times))
    Tb = _bucket(T)
    pad = Tb - T
    statics = (float(min_cutoff), float(beta), float(d_cutoff))
    payload = (_carry_np(carry), _pad_tail(times, pad), _pad_tail(values, pad),
               _pad_tail(np.asarray(valid, bool), pad))

    def _run_batch(payloads):
        sm, c = one_euro_scan_chunk(*(_stack(payloads, k) for k in range(4)), **kw)
        return [(sm[i], _row(c, i)) for i in range(len(payloads))]

    sm, new_carry = run_program("oe_smooth", (Tb, tuple(np.shape(values)[1:])) + statics, payload, _run_batch)
    return sm[:T], new_carry


def v4_smooth_chunk_co(lm_carry, pose_carry, times, lm_track, lm_valid, pose_track, pose_valid, *,
                       lm_min_cutoff: float = 0.5, lm_beta: float = 0.1, pose_min_cutoff: float = 0.1,
                       pose_beta: float = 0.1):
    """Coalesced drop-in for :func:`~fvd_tpu_torch.ops.filters.v4_smooth_chunk`
    (V4's landmark OneEuro + EAR + pose OneEuro chunk)."""
    from fvd_tpu_torch.providers.coalesce import program_coalescing_active, run_program

    kw = dict(lm_min_cutoff=lm_min_cutoff, lm_beta=lm_beta, pose_min_cutoff=pose_min_cutoff, pose_beta=pose_beta)
    if not program_coalescing_active():
        return v4_smooth_chunk(lm_carry, pose_carry, times, lm_track, lm_valid, pose_track, pose_valid, **kw)
    T = int(len(times))
    Tb = _bucket(T)
    pad = Tb - T
    statics = (float(lm_min_cutoff), float(lm_beta), float(pose_min_cutoff), float(pose_beta))
    payload = (_carry_np(lm_carry), _carry_np(pose_carry), _pad_tail(times, pad), _pad_tail(lm_track, pad),
               _pad_tail(np.asarray(lm_valid, bool), pad), _pad_tail(pose_track, pad),
               _pad_tail(np.asarray(pose_valid, bool), pad))

    def _run_batch(payloads):
        lm_c, pose_c, times_b, lm_b, lv_b, pose_b, pv_b = (_stack(payloads, k) for k in range(7))
        sm_lm, lm_c = one_euro_scan_chunk(lm_c, times_b, lm_b, lv_b, min_cutoff=lm_min_cutoff, beta=lm_beta)
        sm_pose, pose_c = one_euro_scan_chunk(pose_c, times_b, pose_b, pv_b, min_cutoff=pose_min_cutoff,
                                              beta=pose_beta)
        return [(sm_lm[i], sm_pose[i], _row(lm_c, i), _row(pose_c, i)) for i in range(len(payloads))]

    sm_lm, sm_pose, new_lm_carry, new_pose_carry = run_program(
        "v4_smooth", (Tb, tuple(np.shape(lm_track)[1:])) + statics, payload, _run_batch)
    # EAR per video on its own rows, as v4_smooth_chunk computes it
    sm_lm = sm_lm[:T]
    return sm_lm, _ears(sm_lm), sm_pose[:T], new_lm_carry, new_pose_carry
