"""Provider bundle factories: the port's subset of
``fvd_tpu/providers/factory.py``.

``production_providers`` assembles the implementation of each seam that the
port has:

* the SSD detector, the hourglass landmarks and the pose head from
  ``checkpoints/{face_ssd,landmarks,pose}.npz``, on ``device``;
* EnergyVAD for speech segments, on ``device``;
* the hashing text encoder for evidence ranking, no OCR, no CLIP (C2 then
  skips, as the JAX package does without a CLIP), no LLM and no search.

On a machine with no network and no API keys the JAX package's bundle gives
the same empty LLM and search results.  Each seam whose model or backend is
ported later prints one line naming its ROADMAP item.
"""

from __future__ import annotations

import os

import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.providers import Providers
from fvd_tpu_torch.providers.asr import EnergyVAD
from fvd_tpu_torch.providers.encoders import HashingTextEncoder
from fvd_tpu_torch.providers.llm import NullLLM
from fvd_tpu_torch.providers.search import NullSearch
from fvd_tpu_torch.providers.vision import NullOCR

KNOWN_CHECKPOINTS = (
    "face_ssd.npz", "landmarks.npz", "pose.npz", "clip.npz", "asr.npz",
    "ocr_rec.npz", "ocr_det.npz", "text_encoder.npz", "hf",
)

#: the seams whose models or backends wait for a later slice of the port
_NOT_PORTED = (
    "text encoder: the hashing encoder stands in for MiniLM (ROADMAP §1 item 12)",
    "CLIP: none, C2 skips (ROADMAP §1 item 12)",
    "ASR model: EnergyVAD segments, no words (ROADMAP §1 item 10)",
    "OCR: none (ROADMAP §1 item 11)",
    "LLM and search: none, no networked backend (ROADMAP §1 item 13)",
)


def _has_checkpoints(path: str) -> bool:
    return any(os.path.exists(os.path.join(path, f)) for f in KNOWN_CHECKPOINTS)


def default_checkpoint_dir() -> str:
    """Checkpoint search order: $FVD_CHECKPOINT_DIR, ./checkpoints (only when
    it actually holds fvd checkpoints — an unrelated same-named directory
    must not shadow the trained weights), then the repo-root checkpoints/
    next to the package (the CLI can run from any cwd).
    """
    env = os.environ.get("FVD_CHECKPOINT_DIR")
    if env:
        return env
    if os.path.isdir("checkpoints") and _has_checkpoints("checkpoints"):
        return "checkpoints"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo_root, "checkpoints")


def bootstrap_production(device=None) -> Providers:
    """Install the production bundle on ``device`` as the process default
    unless a caller already installed one via set_providers() (entry points
    call this; tests and embedders that inject their own bundle keep it)."""
    from fvd_tpu_torch.providers import get_providers, providers_installed, set_providers

    if providers_installed():
        return get_providers()
    ckpt_dir = default_checkpoint_dir()
    print(f"providers: checkpoints from {os.path.abspath(ckpt_dir)}")
    return set_providers(production_providers(ckpt_dir, device=device))


def production_providers(checkpoint_dir: str = "checkpoints", device=None,
                         compute_dtype: torch.dtype = torch.bfloat16) -> Providers:
    """The port's production bundle on ``device`` (default the card), the
    vision backbones in ``compute_dtype``.  The three vision checkpoints are
    required: the port has no random-init detector or landmark model."""
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks

    dev = resolve_device(device)
    detector = SSDFaceDetector(checkpoint=os.path.join(checkpoint_dir, "face_ssd.npz"),
                               compute_dtype=compute_dtype, device=dev)
    landmarks = FANLandmarks(detector, checkpoint=os.path.join(checkpoint_dir, "landmarks.npz"),
                             pose_checkpoint=os.path.join(checkpoint_dir, "pose.npz"),
                             compute_dtype=compute_dtype, device=dev)
    for line in _NOT_PORTED:
        print(f"providers: {line}")
    return Providers(
        llm=NullLLM(),
        search=NullSearch(),
        text_encoder=HashingTextEncoder(),
        clip=None,
        asr=EnergyVAD(device=dev),
        ocr=NullOCR(),
        face_detector=detector,
        landmarks=landmarks,
    )
