"""OneEuro smoothing, V4's smoothing stage and box IoU: the counterpart of
``iou``, ``one_euro_scan``, ``one_euro_init_carry``, ``one_euro_scan_chunk``,
``v4_smooth_chunk``, ``v4_smooth_program``, ``OneEuroFilter`` and
``eye_aspect_ratio`` in ``fvd_tpu/ops/filters.py``.

The JAX package runs the filter as one ``lax.scan`` over a track's T samples,
vectorised over its coordinates.  On the card a scan step would be some twenty
tiny launches, T times over, so here it is a float32 loop over T on the host,
vectorised over the coordinates (and over a leading batch of videos).  The
step is the same float32 arithmetic in the same order; no transcendental
appears.  Invalid samples leave the filter state untouched and output NaN, and
the chunked scan hands its carry on, so chunk by chunk equals one whole scan.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_F = np.float32
_TWO_PI = _F(2.0 * math.pi)

#: (initialized bool, t_prev f32, x_prev f32[...], dx_prev f32[...]), each
#: with the leading batch dimensions of the scan that made it
Carry = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def iou(box_a, box_b) -> float:
    """IoU with inclusive-pixel (+1) areas — reference calculate_iou
    (v3:48-61 / v4:90-103)."""
    xA = max(box_a[0], box_b[0])
    yA = max(box_a[1], box_b[1])
    xB = min(box_a[2], box_b[2])
    yB = min(box_a[3], box_b[3])
    inter = max(0, xB - xA + 1) * max(0, yB - yA + 1)
    area_a = (box_a[2] - box_a[0] + 1) * (box_a[3] - box_a[1] + 1)
    area_b = (box_b[2] - box_b[0] + 1) * (box_b[3] - box_b[1] + 1)
    return inter / float(area_a + area_b - inter)


def one_euro_init_carry(value_shape) -> Carry:
    """Fresh (uninitialized) filter carry for the chunked scan."""
    zero = np.zeros(value_shape, _F)
    return (np.array(False), _F(0.0), zero, zero.copy())


def _smoothing(t_e: np.ndarray, cutoff) -> np.ndarray:
    # the JAX step's 2.0 * jnp.pi * cutoff * t_e, left to right in float32
    r = (_TWO_PI * cutoff) * t_e
    return r / (r + _F(1.0))


def one_euro_scan_chunk(carry: Carry, times, values, valid, min_cutoff: float = 1.0,
                        beta: float = 0.0, d_cutoff: float = 1.0):
    """Chunk-resumable OneEuroFilter: ``times [..., T]``, ``values
    [..., T, *V]``, ``valid [..., T]`` with the same leading dimensions as the
    carry's ``initialized`` -> (float32 ``[..., T, *V]``, new carry).

    * the first valid sample initializes the filter and passes through raw;
    * later valid samples are filtered with t_e measured from the previous
      valid one;
    * invalid samples leave the state untouched and output NaN."""
    initialized, t_prev, x_prev, dx_prev = (np.asarray(c) for c in carry)
    times = np.asarray(times).astype(_F)
    values = np.asarray(values).astype(_F)
    valid = np.asarray(valid, bool)
    lead = initialized.ndim
    T = times.shape[lead]
    vdims = values.ndim - lead - 1
    mc, b, dc = _F(min_cutoff), _F(beta), _F(2.0 * math.pi * d_cutoff)
    initialized, t_prev = initialized.copy(), t_prev.astype(_F).copy()
    x_prev, dx_prev = x_prev.astype(_F).copy(), dx_prev.astype(_F).copy()
    out = np.empty_like(values)
    expand = (slice(None),) * lead + (None,) * vdims  # [...] -> [..., 1 x vdims]
    for i in range(T):
        t = times[(slice(None),) * lead + (i,)]
        x = values[(slice(None),) * lead + (i,)]
        ok = valid[(slice(None),) * lead + (i,)]
        t_e = t - t_prev
        safe_te = np.where(t_e != 0, t_e, _F(1.0)).astype(_F)
        r_d = dc * safe_te
        a_d = (r_d / (r_d + _F(1.0)))[expand]
        te = safe_te[expand]
        dx = (x - x_prev) / te
        dx_hat = a_d * dx + (_F(1.0) - a_d) * dx_prev
        cutoff = mc + b * np.abs(dx_hat)
        a = _smoothing(te, cutoff)
        x_hat = a * x + (_F(1.0) - a) * x_prev
        use_init = np.logical_and(ok, np.logical_not(initialized))
        use_filt = np.logical_and(ok, initialized)
        ui, uf = use_init[expand], use_filt[expand]
        out[(slice(None),) * lead + (i,)] = np.where(ui, x, np.where(uf, x_hat, _F(np.nan)))
        x_prev = np.where(ui, x, np.where(uf, x_hat, x_prev))
        dx_prev = np.where(ui, _F(0.0), np.where(uf, dx_hat, dx_prev))
        t_prev = np.where(ok, t, t_prev).astype(_F)
        initialized = np.logical_or(initialized, ok)
    return out, (initialized, t_prev, x_prev, dx_prev)


def one_euro_scan(times, values, valid, min_cutoff: float = 1.0, beta: float = 0.0,
                  d_cutoff: float = 1.0) -> np.ndarray:
    """OneEuroFilter over a whole track (times [T], values [T, ...], valid [T])."""
    values = np.asarray(values)
    out, _ = one_euro_scan_chunk(one_euro_init_carry(values.shape[1:]), times, values, valid,
                                 min_cutoff=min_cutoff, beta=beta, d_cutoff=d_cutoff)
    return out


def _ears(sm_lm: np.ndarray) -> np.ndarray:
    """Mean eye aspect ratio of eyes 36:42 and 42:48 per sample of a
    smoothed [T, 68, D] float32 track (reference v4:260-264)."""
    def ear_of(eye):  # [T, 6, D]
        a = np.linalg.norm(eye[:, 1] - eye[:, 5], axis=-1)
        b = np.linalg.norm(eye[:, 2] - eye[:, 4], axis=-1)
        c = np.linalg.norm(eye[:, 0] - eye[:, 3], axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(c > 0, (a + b) / (_F(2.0) * c), _F(0.0)).astype(_F)

    return ((ear_of(sm_lm[:, 36:42]) + ear_of(sm_lm[:, 42:48])) / _F(2.0)).astype(_F)


def v4_smooth_chunk(lm_carry: Carry, pose_carry: Carry, times, lm_track, lm_valid, pose_track,
                    pose_valid, lm_min_cutoff: float = 0.5, lm_beta: float = 0.1,
                    pose_min_cutoff: float = 0.1, pose_beta: float = 0.1):
    """Chunk-resumable V4 smoothing stage: the landmark OneEuro scan, EAR per
    sample and the (stronger) pose OneEuro scan, with carried filter states
    -> (smoothed landmarks [T, 68, D], ears [T], smoothed poses [T, 3], new
    landmark carry, new pose carry)."""
    sm_lm, lm_carry = one_euro_scan_chunk(lm_carry, times, lm_track, lm_valid,
                                          min_cutoff=lm_min_cutoff, beta=lm_beta)
    sm_pose, pose_carry = one_euro_scan_chunk(pose_carry, times, pose_track, pose_valid,
                                              min_cutoff=pose_min_cutoff, beta=pose_beta)
    return sm_lm, _ears(sm_lm), sm_pose, lm_carry, pose_carry


def v4_smooth_program(times, lm_track, lm_valid, pose_track, pose_valid, lm_min_cutoff: float = 0.5,
                      lm_beta: float = 0.1, pose_min_cutoff: float = 0.1, pose_beta: float = 0.1):
    """V4's whole smoothing stage over whole tracks: (smoothed landmarks,
    ears, smoothed poses)."""
    lm_track = np.asarray(lm_track)
    sm_lm, ears, sm_pose, _, _ = v4_smooth_chunk(
        one_euro_init_carry(lm_track.shape[1:]), one_euro_init_carry(np.shape(pose_track)[1:]),
        times, lm_track, lm_valid, pose_track, pose_valid, lm_min_cutoff=lm_min_cutoff,
        lm_beta=lm_beta, pose_min_cutoff=pose_min_cutoff, pose_beta=pose_beta)
    return sm_lm, ears, sm_pose


class OneEuroFilter:
    """Stateful host-side float64 filter (identical math) for call-at-a-time
    use and for testing the scan against."""

    def __init__(self, t0, x0, dx0=0.0, min_cutoff=1.0, beta=0.0, d_cutoff=1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.x_prev = np.asarray(x0, dtype=float)
        self.dx_prev = np.asarray(dx0, dtype=float) * np.ones_like(self.x_prev)
        self.t_prev = float(t0)

    @staticmethod
    def _sf(t_e, cutoff):
        r = 2 * np.pi * cutoff * t_e
        return r / (r + 1)

    def __call__(self, t, x):
        x = np.asarray(x, dtype=float)
        t_e = t - self.t_prev
        a_d = self._sf(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = a_d * dx + (1 - a_d) * self.dx_prev
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = self._sf(t_e, cutoff)
        x_hat = a * x + (1 - a) * self.x_prev
        self.x_prev = x_hat
        self.dx_prev = dx_hat
        self.t_prev = t
        return x_hat


def eye_aspect_ratio(eye: np.ndarray) -> float:
    """EAR over 6 eye landmarks (reference v4:50-55); works for 2D or 3D."""
    eye = np.asarray(eye, dtype=float)
    a = np.linalg.norm(eye[1] - eye[5])
    b = np.linalg.norm(eye[2] - eye[4])
    c = np.linalg.norm(eye[0] - eye[3])
    return float((a + b) / (2.0 * c)) if c > 0 else 0.0
