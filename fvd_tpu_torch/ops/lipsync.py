"""C1 lip-sync scoring: the counterpart of ``fvd_tpu/ops/lipsync.py``.

Per video: z-normalise the mouth-aspect-ratio and audio-envelope signals,
cut both into 5 s windows at 50% hop, score each window by its
cross-correlation peak over +-0.5 s of lag (halved when the peak is not
sharp), and take the mean of the top half of the valid window scores.

The whole stage is the port of the Pallas TPU kernel
``_lipsync_window_kernel`` and the jitted program around it
(``lip_sync_score_pallas``): :func:`lip_sync_score_batch` launches the CUDA
kernel ``csrc/lipsync_score.cu`` once on a CUDA tensor and runs
:func:`lip_sync_score_batch_plain` on a CPU tensor.  The reference's quirks
are kept: the window gate uses a Bessel-corrected std while ``_znorm`` uses
the population std, each window gets its own zero lag padding, and the
cross-correlation divides by ``int(window_duration_s * fps)`` even when a
short signal is a single shorter window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from fvd_tpu_torch import _kernels

EPS = 1e-9


def mar_from_points(mouth_points: torch.Tensor) -> torch.Tensor:
    """MAR for a batch of mouth landmarks ``[..., 20, 2]``: verticals
    (m2,m10), (m3,m9), (m4,m8), horizontal (m0,m6); (A+B+C)/(3D), 0 where
    D == 0."""
    p = mouth_points

    def d(i, j):
        return torch.linalg.vector_norm(p[..., i, :] - p[..., j, :], dim=-1)

    A, B, C, D = d(2, 10), d(3, 9), d(4, 8), d(0, 6)
    return torch.where(D > 0, (A + B + C) / (3.0 * D), torch.zeros_like(D))


def _znorm(x: torch.Tensor) -> torch.Tensor:
    """Row-wise ``(x - mean) / (std + EPS)`` over the last axis, with the
    population std (``jnp.std``'s default)."""
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) / (x.std(dim=-1, correction=0, keepdim=True) + EPS)


def window_params(n: int, fps: float, window_duration_s: float = 5.0) -> Tuple[int, int, int]:
    """(window_size, step, n_windows) with torch-unfold semantics; a signal
    shorter than one window becomes a single full-length window."""
    window = int(window_duration_s * fps)
    step = max(int(window / 2), 1)
    if n < window:
        return n, n, 1
    return window, step, (n - window) // step + 1


def _top_half_mean(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per row of ``[B, n_win]``: the mean of the top ``max(1, n_valid // 2)``
    valid scores, clamped >= 0; 0 where no window is valid."""
    n_valid = valid.sum(dim=-1)
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=-1, descending=True).values
    k = torch.clamp((n_valid.to(torch.float32) * 0.5).to(torch.int64), min=1)
    csum = torch.cumsum(torch.where(torch.isfinite(order), order, torch.zeros_like(order)), dim=-1)
    mean_topk = csum.gather(-1, (k - 1)[..., None])[..., 0] / k.to(scores.dtype)
    return torch.where(n_valid > 0, torch.clamp(mean_topk, min=0.0), torch.zeros_like(mean_topk))


class LipSyncResult(NamedTuple):
    score: torch.Tensor          # f32, [] for one video, [B] for a batch
    n_windows: int
    n_valid: torch.Tensor        # int32, same shape as score
    window_scores: torch.Tensor  # f32, [n_windows] or [B, n_windows]
    window_valid: torch.Tensor   # bool, same shape as window_scores


def lip_sync_window_scores_plain(
    mouth: torch.Tensor,
    audio: torch.Tensor,
    window: int,
    step: int,
    n_win: int,
    max_lag: int,
    norm_div: float,
    silence_std: float = 0.01,
    sharpness_threshold: float = 1.5,
    sharpness_penalty: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window scores of the z-normalised signals ``[B, N]`` (or ``[N]``) ->
    (score f32 ``[B, n_win]``, valid bool ``[B, n_win]``), the function of the TPU
    window kernel.  One einsum over all (window, lag) pairs, as
    ``lip_sync_score_xla`` does."""
    wm = mouth.unfold(-1, window, step)[..., :n_win, :]  # [B, n_win, W]
    wa = audio.unfold(-1, window, step)[..., :n_win, :]
    valid = (wa.std(dim=-1) >= silence_std) & (wm.std(dim=-1) >= silence_std)  # Bessel
    a_lag = torch.nn.functional.pad(wa, (max_lag, max_lag)).unfold(-1, window, 1)
    cc = torch.einsum("...lw,...w->...l", a_lag, wm) / norm_div  # [B, n_win, 2L+1]
    max_corr = cc.amax(dim=-1)
    sharpness = max_corr / (cc.abs().mean(dim=-1) + EPS)
    score = torch.where(sharpness < sharpness_threshold, max_corr * sharpness_penalty, max_corr)
    return score, valid


def lip_sync_score_batch_plain(
    mouths: torch.Tensor,
    audios: torch.Tensor,
    fps: float,
    window_duration_s: float = 5.0,
    max_lag_s: float = 0.5,
    silence_std: float = 0.01,
    sharpness_threshold: float = 1.5,
    sharpness_penalty: float = 0.5,
) -> LipSyncResult:
    """Plain PyTorch version of the stage kernel, the same function as
    :func:`lip_sync_score_batch`: ``_znorm``, the window scores and the
    top-half mean as separate torch ops."""
    n = mouths.shape[-1]
    window, step, n_win = window_params(n, fps, window_duration_s)
    scores, valid = lip_sync_window_scores_plain(
        _znorm(mouths.to(torch.float32)), _znorm(audios.to(torch.float32)),
        window, step, n_win,
        max_lag=int(fps * max_lag_s),
        norm_div=float(int(window_duration_s * fps)),
        silence_std=silence_std,
        sharpness_threshold=sharpness_threshold,
        sharpness_penalty=sharpness_penalty,
    )
    return LipSyncResult(score=_top_half_mean(scores, valid), n_windows=n_win,
                         n_valid=valid.sum(dim=-1, dtype=torch.int32),
                         window_scores=scores, window_valid=valid)


#: the stage kernel's block: 16 warps, each of which can take windows
KERNEL_WARPS = 16
#: dynamic shared memory the kernel may use: 227 KB a block can opt into on
#: sm_90, less 1 KB for its static arrays (``kMaxDynamicSmem`` in the source)
KERNEL_SMEM_BYTES = 227 * 1024 - 1024


def kernel_slices(window: int, max_lag: int, n_win: int) -> int:
    """Warps of the stage kernel that take windows: as many as fit the shared
    memory, at most one per window and :data:`KERNEL_WARPS`.  Each holds a
    slice of ``4 * round4(2 * round4(window) + 2 * max_lag)`` bytes, and the
    block holds ``5 * n_win`` bytes of window results.  Raises
    ``ValueError`` where not even one slice fits."""
    wp = -(-window // 4) * 4
    slice_bytes = 4 * (-(-(2 * wp + 2 * max_lag) // 4) * 4)
    slices = min(KERNEL_WARPS, n_win, (KERNEL_SMEM_BYTES - 5 * n_win) // slice_bytes)
    if slices < 1:
        raise ValueError(
            f"lip_sync_score_batch: the kernel's shared memory ({KERNEL_SMEM_BYTES} B) holds "
            f"no {slice_bytes} B window slice (window {window}, max_lag {max_lag}) beside "
            f"{n_win} window results")
    return slices


class _KernelArgs(ctypes.Structure):
    """The scalar arguments of ``lipsync_score_launch`` (``StageArgs`` in
    ``csrc/lipsync_score.cu``), passed by address."""
    _fields_ = ([(f, ctypes.c_int) for f in ("batch", "n", "window", "step", "n_win", "max_lag", "slices")]
                + [(f, ctypes.c_float) for f in ("norm_div", "silence_std", "sharpness_threshold",
                                                 "sharpness_penalty")])


@functools.lru_cache(maxsize=256)
def _kernel_args(batch: int, n: int, fps: float, window_duration_s: float, max_lag_s: float,
                 silence_std: float, sharpness_threshold: float, sharpness_penalty: float):
    """(n_win, the kernel's scalar arguments, their address) for ``batch`` rows
    of ``n`` samples; raises ``ValueError`` past the kernel's limits.  The
    struct is part of the cached value, which keeps its address valid."""
    window, step, n_win = window_params(n, fps, window_duration_s)
    max_lag = int(fps * max_lag_s)
    if window < 1 or max_lag < 0:
        raise ValueError(f"lip_sync_score_batch: fps {fps} gives window {window}, "
                         f"max_lag {max_lag}")
    args = _KernelArgs(batch, n, window, step, n_win, max_lag, kernel_slices(window, max_lag, n_win),
                       float(int(window_duration_s * fps)), silence_std, sharpness_threshold,
                       sharpness_penalty)
    return n_win, args, ctypes.addressof(args)


_launch_stage = None  # the kernel's ctypes launcher, bound at the first CUDA call


def lip_sync_score_batch(
    mouths: torch.Tensor,
    audios: torch.Tensor,
    fps: float,
    window_duration_s: float = 5.0,
    max_lag_s: float = 0.5,
    silence_std: float = 0.01,
    sharpness_threshold: float = 1.5,
    sharpness_penalty: float = 0.5,
) -> LipSyncResult:
    """Scores of ``B`` same-length raw signal pairs ``[B, N]``: ``score`` and
    ``n_valid`` of shape ``[B]``, the per-window results ``[B, n_windows]``.
    One video's ``[N]`` pair gives ``[]`` and ``[n_windows]``.

    On a CUDA tensor this is one launch of ``csrc/lipsync_score.cu`` for the
    whole stage and every video, and no other device op but the outputs'
    allocation (or it raises); on a CPU tensor it is
    :func:`lip_sync_score_batch_plain`.  At the main path's sizes a caller
    waits for the host work of a call, not for the card, so it is kept to a
    few torch calls and one ctypes call."""
    global _launch_stage
    dev = mouths.device
    if dev.type == "cpu" and audios.device.type == "cpu":
        return lip_sync_score_batch_plain(mouths, audios, fps, window_duration_s, max_lag_s,
                                          silence_std, sharpness_threshold, sharpness_penalty)
    if (dev.type != "cuda" or audios.device != dev or mouths.dim() not in (1, 2)
            or mouths.shape != audios.shape or mouths.numel() == 0):
        raise ValueError(f"lip_sync_score_batch: need two non-empty [B, N] or [N] signals of one "
                         f"shape on one CUDA device (or the CPU), got {tuple(mouths.shape)} on "
                         f"{dev} and {tuple(audios.shape)} on {audios.device}")
    lead, n = mouths.shape[:-1], mouths.shape[-1]
    batch = lead[0] if lead else 1
    n_win, _args, args_ptr = _kernel_args(batch, n, fps, window_duration_s, max_lag_s, silence_std,
                                          sharpness_threshold, sharpness_penalty)
    if mouths.dtype != torch.float32 or not mouths.is_contiguous():
        mouths = mouths.to(torch.float32).contiguous()
    if audios.dtype != torch.float32 or not audios.is_contiguous():
        audios = audios.to(torch.float32).contiguous()
    # the four outputs as they are returned: four torch calls and no views
    score = torch.empty(lead, dtype=torch.float32, device=dev)
    n_valid = torch.empty(lead, dtype=torch.int32, device=dev)
    window_scores = torch.empty(lead + (n_win,), dtype=torch.float32, device=dev)
    window_valid = torch.empty(lead + (n_win,), dtype=torch.bool, device=dev)
    if _launch_stage is None:
        _launch_stage = _kernels.load("lipsync_score")
    # the stream's handle as an int, without building a torch.cuda.Stream object
    args = (mouths.data_ptr(), audios.data_ptr(), score.data_ptr(), n_valid.data_ptr(),
            window_scores.data_ptr(), window_valid.data_ptr(), args_ptr,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = _launch_stage(*args)
    else:
        with torch.cuda.device(dev):
            err = _launch_stage(*args)
    if err != 0:
        raise RuntimeError(f"lipsync_score kernel launch failed: cudaError {err}")
    _kernels.count_launch("lipsync_score")
    return LipSyncResult(score=score, n_windows=n_win, n_valid=n_valid,
                         window_scores=window_scores, window_valid=window_valid)


def lip_sync_score(mouth: torch.Tensor, audio: torch.Tensor, fps: float, **kwargs) -> LipSyncResult:
    """One video's score from its ``[N]`` mouth and audio signals."""
    return lip_sync_score_batch(mouth, audio, fps, **kwargs)
