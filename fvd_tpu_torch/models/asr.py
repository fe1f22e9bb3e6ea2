"""Whisper-style ASR encoder-decoder: the counterpart of
``fvd_tpu/models/asr.py``, with its training loss :func:`asr_loss`.

Role (SURVEY §2.4): openai-whisper base in A2 (``a2_vad_asr.py:27-30``).
A log-mel frontend on the port's spectral ops, a conv-subsampled transformer
encoder, and a causal transformer decoder with cross-attention over a
byte-level vocabulary, with the flax submodule names, so the npz checkpoints
load through :mod:`fvd_tpu_torch.weights`.  Everything runs in float32.

:func:`greedy_decode` is the JAX package's ``lax.while_loop`` as a host loop:
each step runs the whole decoder over all ``max_tokens`` positions (causal, so
step ``i`` reads positions up to ``i`` only) and takes the argmax at ``i``;
finished rows are padded with PAD; the loop stops when every row has emitted
EOS, which costs one 1-byte fetch per step.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models.layers import SameConv1d
from fvd_tpu_torch.models.transformer import ByteTokenizer, MHABlock, gelu, layer_norm, sincos_positions

N_MELS = 80
MAX_AUDIO_FRAMES = 1024   # mel frames after hop (~10.2 s at 16 kHz/160 hop)
MAX_TOKENS = 128
HOP = 160                  # 10 ms at 16 kHz
N_FFT = 400


def _heads(dim: int) -> int:
    return max(1, dim // 32)


def _positions(length: int, dim: int, device) -> torch.Tensor:
    return torch.from_numpy(sincos_positions(length, dim)).to(device)


class AsrEncoder(nn.Module):
    """``heads`` 0 takes ``dim // 32``, as the flax module does."""

    def __init__(self, dim: int = 192, depth: int = 4, heads: int = 0):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.Conv_0 = SameConv1d(N_MELS, dim, 3)
        self.Conv_1 = SameConv1d(dim, dim, 3, stride=2)   # T/2
        for i in range(depth):
            setattr(self, f"MHABlock_{i}", MHABlock(dim, heads or _heads(dim)))
        self.LayerNorm_0 = layer_norm(dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:   # [B, T, 80]
        x = gelu(self.Conv_0(mel.transpose(1, 2)))
        x = gelu(self.Conv_1(x)).transpose(1, 2)
        x = x + _positions(x.shape[1], self.dim, x.device)
        for i in range(self.depth):
            x = getattr(self, f"MHABlock_{i}")(x)
        return self.LayerNorm_0(x)


class AsrDecoder(nn.Module):
    def __init__(self, dim: int = 192, depth: int = 4):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.Embed_0 = nn.Embedding(ByteTokenizer.vocab_size, dim)
        for i in range(depth):
            setattr(self, f"MHABlock_{i}", MHABlock(dim, _heads(dim), causal=True, cross=True))
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, ByteTokenizer.vocab_size)

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:  # [B, S], [B, T', D]
        x = self.Embed_0(tokens.long())
        x = x + _positions(tokens.shape[-1], self.dim, x.device)
        for i in range(self.depth):
            x = getattr(self, f"MHABlock_{i}")(x, context=memory)
        return self.Dense_0(self.LayerNorm_0(x))


class AsrModel(nn.Module):
    def __init__(self, dim: int = 192, depth: int = 4):
        super().__init__()
        self.encoder = AsrEncoder(dim=dim, depth=depth)
        self.decoder = AsrDecoder(dim=dim, depth=depth)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))


def asr_loss(model: AsrModel, mel: torch.Tensor, tokens_in: torch.Tensor, tokens_out: torch.Tensor,
             pad_id: int = ByteTokenizer.PAD) -> torch.Tensor:
    """Teacher-forced cross entropy, masked on ``tokens_out != pad_id`` and
    divided by the count of unmasked tokens (at least 1)."""
    logp = torch.log_softmax(model(mel, tokens_in), dim=-1)
    nll = -logp.gather(-1, tokens_out.long()[..., None])[..., 0]
    mask = (tokens_out != pad_id).to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def log_mel(audio: torch.Tensor, sr: int = 16000) -> torch.Tensor:
    """Whisper-style log-mel of ``audio`` [..., n] -> [..., frames, 80], each
    row floored at its own maximum less 8."""
    from fvd_tpu_torch.ops.spectral import mel_filterbank, stft_power

    power = stft_power(audio, n_fft=N_FFT, hop=HOP)
    fb = torch.from_numpy(mel_filterbank(sr, N_FFT, N_MELS)).to(audio.device)
    mel = power @ fb.T
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    logmel = torch.maximum(logmel, logmel.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logmel + 4.0) / 4.0


def _mel_masked(audio_b: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """Batched log-mel with rows past each item's content zeroed: the
    training-time silence representation."""
    mel = log_mel(audio_b)  # [B, F, 80]
    idx = torch.arange(mel.shape[1], device=mel.device)[None, :, None]
    return torch.where(idx < n_frames[:, None, None], mel, torch.zeros((), device=mel.device))


@torch.no_grad()
def greedy_decode(model: AsrModel, mel: torch.Tensor, max_tokens: int = MAX_TOKENS) -> torch.Tensor:
    """Greedy autoregressive decode -> tokens [B, max_tokens] (BOS first)."""
    memory = model.encoder(mel)
    b = mel.shape[0]
    tokens = torch.full((b, max_tokens), ByteTokenizer.PAD, dtype=torch.int64, device=mel.device)
    tokens[:, 0] = ByteTokenizer.BOS
    done = torch.zeros(b, dtype=torch.bool, device=mel.device)
    for i in range(max_tokens - 1):
        logits = model.decoder(tokens, memory)
        nxt = logits[:, i].argmax(dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, ByteTokenizer.PAD), nxt)
        tokens[:, i + 1] = nxt
        done = done | (nxt == ByteTokenizer.EOS)
        if bool(done.all()):
            break
    return tokens


def active_spans(
    y: np.ndarray,
    sr: int = 16000,
    rel_thresh: float = 0.05,
    abs_floor: float = 1e-4,
    merge_gap_s: float = 0.2,
    min_span_s: float = 0.05,
    pad_s: float = 0.02,
) -> list:
    """Host-side energy VAD: contiguous speech spans as sample ranges.

    The reference's Whisper handles long-form audio by internally windowing
    around detected speech (a2_vad_asr.py:27-30 relies on that); the
    equivalent here keeps each decoded window inside the trained
    distribution (speech followed by silence) instead of slicing fixed
    windows that cut through speech/pause boundaries.
    """
    hop = HOP
    n = len(y) // hop
    if n == 0:
        return [(0, len(y))] if len(y) else []
    frames = y[: n * hop].reshape(n, hop).astype(np.float64)
    rms = np.sqrt(np.mean(frames * frames, axis=1))
    thr = max(abs_floor, rel_thresh * float(rms.max()))
    active = rms > thr
    if not active.any():
        return []
    edges = np.flatnonzero(np.diff(np.concatenate([[0], active.view(np.int8), [0]])))
    spans = list(zip(edges[0::2], edges[1::2]))  # frame-index [start, end)
    gap = max(1, int(merge_gap_s * sr / hop))
    merged = [spans[0]]
    for s, e in spans[1:]:
        if s - merged[-1][1] <= gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    min_fr = max(1, int(min_span_s * sr / hop))
    pad = int(pad_s * sr / hop)
    return [
        (max(0, s - pad) * hop, min(len(y), (e + pad) * hop))
        for s, e in merged
        if e - s >= min_fr
    ]


class JaxASR:
    """ASRProvider over the encoder-decoder (Whisper role), on ``device``
    (default the card).

    Chunks audio into ``chunk_frames`` windows, decodes each greedily, and
    emits Whisper-shaped ``{text, segments}``.
    """

    model_name = "fvd_tpu_asr"

    def __init__(self, params, dim: int = 192, depth: int = 4,
                 chunk_frames: int = MAX_AUDIO_FRAMES, max_tokens: int = MAX_TOKENS,
                 dither: float = 0.01, device=None):
        self.dim, self.depth = dim, depth
        self.chunk_frames = chunk_frames
        self.max_tokens = max_tokens
        self.dither = dither
        self.device = resolve_device(device)
        model = AsrModel(dim=dim, depth=depth)
        model.load_state_dict(weights_mod.to_state_dict(params), strict=True)
        self.model = model.eval().to(self.device)
        self.tok = ByteTokenizer()

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "JaxASR":
        """Load an ASR checkpoint (npz + sibling json meta)."""
        meta = {}
        meta_path = path.replace(".npz", ".json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return cls(
            weights_mod.read_npz(path),
            dim=int(meta.get("dim", 192)), depth=int(meta.get("depth", 4)),
            chunk_frames=int(meta.get("chunk_frames", MAX_AUDIO_FRAMES)),
            max_tokens=int(meta.get("max_tokens", MAX_TOKENS)),
            # domain-matched inference dither: the tone checkpoint trains on
            # a 0.01 noise floor (clean audio decodes empty without it); the
            # formant domain trains near-clean
            dither=float(meta.get("dither", 0.01)),
            device=device,
        )

    def windows(self, y: np.ndarray, sr: int = 16000):
        """The windows one transcription decodes: ``(pieces, rows,
        n_frames)``, ``pieces`` the ``(start sample, samples)`` of each
        energy-VAD span cut to the chunk length, ``rows`` them padded to
        the chunk with the dither added, ``n_frames`` their mel frames."""
        spans = active_spans(y, sr)
        chunk_samples = (self.chunk_frames - 1) * HOP
        pieces: list = []  # (start_sample, samples)
        for s0, s1 in spans:
            for off in range(s0, s1, chunk_samples):
                pieces.append((off, y[off: min(off + chunk_samples, s1)]))
        rows = np.zeros((len(pieces), chunk_samples), np.float32)
        n_frames = np.zeros(len(pieces), np.int32)
        # deterministic dither matching the training noise floor, drawn anew
        # for every call
        dither = np.random.RandomState(0)
        for i, (_, seg) in enumerate(pieces):
            n = len(seg)
            rows[i, :n] = seg + self.dither * dither.randn(n).astype(np.float32)
            n_frames[i] = min(1 + n // HOP, self.chunk_frames)
        return pieces, rows, n_frames

    def decode_windows(self, rows: np.ndarray, n_frames: np.ndarray) -> np.ndarray:
        """Tokens [P, max_tokens] of ``rows``: one batched mel and one greedy
        decode, the batch padded to the JAX package's power-of-two bucket
        (at least 4); one fetch."""
        total = len(rows)
        bucket = 1 << max(2, (total - 1).bit_length())
        if bucket > total:
            rows = np.concatenate([rows, np.zeros((bucket - total, rows.shape[1]), np.float32)])
            n_frames = np.concatenate([n_frames, np.zeros(bucket - total, np.int32)])
        mels = _mel_masked(torch.from_numpy(rows).to(self.device), torch.from_numpy(n_frames).to(self.device))
        return greedy_decode(self.model, mels, self.max_tokens).cpu().numpy()[:total]

    def transcribe(self, audio_path: str, audio=None) -> Optional[Dict[str, Any]]:
        """``audio`` (host array or tensor at 16 kHz) skips the file read.

        Long-form strategy: energy-VAD spans -> each span windowed to the
        model's chunk length -> one batched mel + one batched greedy decode
        over all windows.  Mirrors Whisper's windowed long-form decode
        (reference a2_vad_asr.py:27-30) while keeping every window inside
        the trained speech-then-silence distribution.
        """
        sr = 16000
        if audio is None:
            from fvd_tpu_torch.utils.wav import read_wav, to_mono

            try:
                samples, sr = read_wav(audio_path)
            except Exception:
                return None
            audio = to_mono(samples)
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().cpu().numpy()
        pieces, rows, n_frames = self.windows(np.asarray(audio, np.float32), sr)
        if not pieces:
            return {"text": "", "segments": []}

        # under multi-video overlap the window batches of concurrent videos
        # coalesce into the same decode
        from fvd_tpu_torch.providers.coalesce import run_program

        def _run_batch(payloads):
            toks = self.decode_windows(np.concatenate([r for r, _ in payloads]),
                                       np.concatenate([f for _, f in payloads]))
            out, o = [], 0
            for r, _ in payloads:
                out.append(toks[o: o + len(r)])
                o += len(r)
            return out

        tokens = run_program(
            "a2_decode", (id(self), rows.shape[1], self.chunk_frames, self.max_tokens),
            (rows, n_frames), _run_batch)
        segments = []
        texts = []
        for (off, seg), row in zip(pieces, np.asarray(tokens)):
            text = self.tok.decode(row).strip()
            if text:
                segments.append({"start": off / sr,
                                 "end": (off + len(seg)) / sr, "text": text})
                texts.append(text)
        return {"text": " ".join(texts), "segments": segments}
