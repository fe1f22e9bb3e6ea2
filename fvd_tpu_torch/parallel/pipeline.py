"""Sharded device programs: DP video batches, SP time axis with halo
exchange, and the fused multi-device training step — the counterpart of
``fvd_tpu/parallel/pipeline.py``.

Each ``make_*`` function returns a program that every rank of a
:func:`~fvd_tpu_torch.parallel.mesh.make_mesh` mesh calls with the same
global inputs; a rank reads only its own block of them (as ``shard_map``'s
``in_specs`` hand each device its block), and the rest moves through
explicit collectives on the mesh's axis groups:

* ``all_reduce`` (``lax.psum``) for the global z-normalisation statistics
  and the LR gradients, loss and example count (DP);
* neighbour ``ppermute`` for the lip-sync halo along ``time`` (SP): the left
  halo is ``max_lag`` samples, the right ``window + max_lag``, zeros at both
  ends of the ring, the only cross-shard dependency of the pipeline;
* ``all_gather`` of the per-window scores and valid flags for the global
  top-half selection (``ops.lipsync._top_half_mean``).

The per-shard window scoring is plain torch, as it is XLA in JAX; it keeps
the reference's quirks: the Bessel std in the silence gate, ``norm_div =
window`` and zero lag padding per window.  JAX scans over a rank's videos
(collectives cannot cross ``vmap``); here a rank's videos share each
collective, one row per video.  A rank outside the mesh returns ``None``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fvd_tpu_torch.ops.lipsync import EPS, _top_half_mean
from fvd_tpu_torch.parallel.mesh import Mesh


# ---------------------------------------------------------------------------
# SP: time-sharded lip-sync scoring with halo exchange
# ---------------------------------------------------------------------------
def _local_window_scores(
    ext: torch.Tensor,          # [B, halo_l + chunk + halo_r] extended mouth signal
    ext_a: torch.Tensor,        # same extent, audio
    chunk: int,
    window: int,
    step: int,
    max_lag: int,
    norm_div: int,
    n_total: int,
    shard: int,
    silence_std: float,
    sharpness_threshold: float,
    sharpness_penalty: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores/valid ``[B, chunk // step]`` for the windows whose start lies in
    shard ``shard``'s chunk."""
    dev = ext.device
    starts_local = torch.arange(chunk // step, device=dev) * step
    in_range = shard * chunk + starts_local <= n_total - window
    # mouth windows: ext starts at (chunk_start - max_lag)
    m_idx = (max_lag + starts_local)[:, None] + torch.arange(window, device=dev)[None, :]
    wm, wa = ext[:, m_idx], ext_a[:, m_idx]                      # [B, w_per, window]
    # the reference zero-pads each window's lag context: do NOT use the real
    # neighbouring samples here
    wa_ext = F.pad(wa, (max_lag, max_lag))

    def bessel_std(x):
        mean = x.mean(dim=-1, keepdim=True)
        return torch.sqrt(((x - mean) ** 2).sum(dim=-1) / (window - 1))

    valid = (bessel_std(wa) >= silence_std) & (bessel_std(wm) >= silence_std) & in_range
    a_lag = wa_ext.unfold(-1, window, 1)                         # [B, w_per, L, window]
    cc = torch.einsum("bnlw,bnw->bnl", a_lag, wm) / norm_div
    max_corr = cc.amax(dim=-1)
    sharpness = max_corr / (cc.abs().mean(dim=-1) + EPS)
    scores = torch.where(sharpness < sharpness_threshold, max_corr * sharpness_penalty, max_corr)
    return scores, valid


def _znorm_global(x: torch.Tensor, n_total: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """z-normalise each row of a time-sharded ``[B, chunk]`` with
    all-reduced statistics (the population std, as ``jnp.std``)."""
    mean = mesh.all_reduce(x.sum(dim=-1, keepdim=True), axis) / n_total
    var = mesh.all_reduce(((x - mean) ** 2).sum(dim=-1, keepdim=True), axis) / n_total
    return (x - mean) / (torch.sqrt(var) + EPS)


def _halo_extend(x: torch.Tensor, halo_l: int, halo_r: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[B, chunk]`` -> ``[B, halo_l + chunk + halo_r]`` from the neighbours'
    edges, zeros at the ends of the ring (the zero lag padding of the
    single-device kernel)."""
    n_dev = mesh.shape[axis]
    left = mesh.ppermute(x[:, -halo_l:], axis, [(i, i + 1) for i in range(n_dev - 1)])
    right = mesh.ppermute(x[:, :halo_r], axis, [(i + 1, i) for i in range(n_dev - 1)])
    return torch.cat([left, x, right], dim=1)


def _sp_geometry(n: int, n_time: int, fps: float, window_duration_s: float, max_lag_s: float):
    window = int(window_duration_s * fps)
    step = max(int(window / 2), 1)
    max_lag = int(fps * max_lag_s)
    return window, step, max_lag, n // n_time


def _sp_scores(mouth, audio, mesh, axis, n, chunk, window, step, max_lag, silence_std, sharpness_threshold,
               sharpness_penalty):
    """Per-row lip-sync score ``[B]`` of this rank's ``[B, chunk]`` blocks."""
    mouth = _znorm_global(mouth.to(torch.float32), n, mesh, axis)
    audio = _znorm_global(audio.to(torch.float32), n, mesh, axis)
    halo_l, halo_r = max_lag, window + max_lag
    ext_m = _halo_extend(mouth, halo_l, halo_r, mesh, axis)
    ext_a = _halo_extend(audio, halo_l, halo_r, mesh, axis)
    scores, valid = _local_window_scores(ext_m, ext_a, chunk, window, step, max_lag, window, n, mesh.index(axis),
                                         silence_std, sharpness_threshold, sharpness_penalty)
    # global selection over all windows (tiny): gather + shared math
    all_scores = mesh.all_gather(scores.T.contiguous(), axis).T      # [B, n_time * w_per]
    all_valid = mesh.all_gather(valid.T.to(torch.uint8).contiguous(), axis).T.bool()
    return _top_half_mean(all_scores, all_valid)


def make_time_sharded_lipsync(
    mesh: Mesh,
    n: int,
    fps: float,
    window_duration_s: float = 5.0,
    max_lag_s: float = 0.5,
    silence_std: float = 0.01,
    sharpness_threshold: float = 1.5,
    sharpness_penalty: float = 0.5,
    time_axis: str = "time",
):
    """An SP lip-sync scorer ``fn(mouth [n], audio [n]) -> score []``, the
    signals sharded over ``time``.

    Requires chunk = n / n_time to be a multiple of the hop and at least
    window + max_lag (so each window's data lives on at most 2 shards).
    """
    n_time = mesh.shape[time_axis]
    window, step, max_lag, chunk = _sp_geometry(n, n_time, fps, window_duration_s, max_lag_s)
    if chunk * n_time != n:
        raise ValueError(f"signal length {n} not divisible by time={n_time}")
    if chunk % step != 0:
        raise ValueError(f"chunk {chunk} must be a multiple of hop {step}")
    if chunk < window + max_lag:
        raise ValueError(f"chunk {chunk} shorter than window+lag {window + max_lag}")

    def fn(mouth: torch.Tensor, audio: torch.Tensor) -> Optional[torch.Tensor]:
        if not mesh.active:
            return None
        lo = mesh.index(time_axis) * chunk
        return _sp_scores(mouth[None, lo:lo + chunk], audio[None, lo:lo + chunk], mesh, time_axis, n, chunk,
                          window, step, max_lag, silence_std, sharpness_threshold, sharpness_penalty)[0]

    return fn


# ---------------------------------------------------------------------------
# DP: sharded LR training step
# ---------------------------------------------------------------------------
class TrainStepResult(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor
    probs: torch.Tensor
    loss: torch.Tensor


def _lr_step(feats, labels, w, b, lr, mesh: Mesh, data_axis: str) -> TrainStepResult:
    """The LR gradient step on this rank's rows, gradients, loss and count
    all-reduced over ``data``; ``probs`` gathered in row order."""
    n_global = mesh.all_reduce(torch.tensor([float(feats.shape[0])], device=feats.device), data_axis)[0]
    z = feats @ w + b
    p = torch.sigmoid(z)
    err = p - labels
    gw = mesh.all_reduce(feats.T @ err, data_axis) / n_global
    gb = mesh.all_reduce(err.sum()[None], data_axis)[0] / n_global
    # stable BCE loss, all-reduce-averaged
    loss_local = torch.sum(torch.clamp(z, min=0) - z * labels + torch.log1p(torch.exp(-torch.abs(z))))
    loss = mesh.all_reduce(loss_local[None], data_axis)[0] / n_global
    return TrainStepResult(w - lr * gw, b - lr * gb, mesh.all_gather(p, data_axis), loss)


def _rows(mesh: Mesh, axis: str, total: int):
    n = mesh.shape[axis]
    if total % n:
        raise ValueError(f"batch {total} not divisible by {axis}={n}")
    per = total // n
    lo = mesh.index(axis) * per
    return slice(lo, lo + per)


def make_dp_lr_train_step(mesh: Mesh, lr: float = 0.005, data_axis: str = "data"):
    """Minibatch logistic-regression step ``fn(feats [B, D], labels [B], w
    [D], b []) -> TrainStepResult``: rows sharded over ``data``, gradients
    all-reduce-averaged across shards."""

    def fn(feats, labels, w, b) -> Optional[TrainStepResult]:
        if not mesh.active:
            return None
        rows = _rows(mesh, data_axis, feats.shape[0])
        return _lr_step(feats[rows], labels[rows], w, b, lr, mesh, data_axis)

    return fn


# ---------------------------------------------------------------------------
# Fused multi-device training step (DP x SP)
# ---------------------------------------------------------------------------
def make_multichip_train_step(
    mesh: Mesh,
    batch: int,
    n: int,
    fps: float,
    lr: float = 0.005,
    data_axis: str = "data",
    time_axis: str = "time",
    window_duration_s: float = 5.0,
    max_lag_s: float = 0.5,
):
    """One training step over a 2-D mesh:

    * videos sharded over ``data`` (DP);
    * each video's signal tracks sharded over ``time`` (SP, halo exchange);
    * lip-sync feature computed on the device, fused into the 9-feature vector;
    * LR gradient step with a cross-``data`` all-reduce.

    ``fn(mouth [B, N], audio [B, N], other_feats [B, 8], labels [B], w [9],
    b []) -> TrainStepResult``.
    """
    n_time = mesh.shape[time_axis]
    n_data = mesh.shape[data_axis]
    window, step, max_lag, chunk = _sp_geometry(n, n_time, fps, window_duration_s, max_lag_s)
    if chunk * n_time != n or chunk % step != 0 or chunk < window + max_lag:
        raise ValueError("invalid time sharding for these signal dimensions")
    if batch % n_data != 0:
        raise ValueError(f"batch {batch} not divisible by data={n_data}")

    def fn(mouth, audio, other_feats, labels, w, b) -> Optional[TrainStepResult]:
        if not mesh.active:
            return None
        rows = _rows(mesh, data_axis, batch)
        lo = mesh.index(time_axis) * chunk
        lip = _sp_scores(mouth[rows, lo:lo + chunk], audio[rows, lo:lo + chunk], mesh, time_axis, n, chunk,
                         window, step, max_lag, 0.01, 1.5, 0.5)
        other = other_feats[rows]
        # lip_sync is feature index 2 (ops.fusion.FEATURE_ORDER)
        feats = torch.cat([other[:, :2], lip[:, None], other[:, 2:]], dim=1)
        return _lr_step(feats, labels[rows], w, b, lr, mesh, data_axis)

    return fn
