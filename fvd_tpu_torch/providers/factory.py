"""Provider bundle factories: the port of ``fvd_tpu/providers/factory.py``.

``production_providers`` assembles the implementation of each seam, on
``device``:

* the SSD detector, the hourglass landmarks and the pose head from
  ``checkpoints/{face_ssd,landmarks,pose}.npz``, and the OCR detector and
  recognizer from ``checkpoints/{ocr_det,ocr_rec}.npz`` (all required: the
  port has no random-init model);
* the HF drop-ins of ``checkpoints/hf/{minilm,clip,whisper}`` first
  (``providers/hf_models.py``), as the JAX package's ``_try`` loads them: a
  missing directory gives the npz model, and one that fails to load prints
  ``providers: failed to load HF <kind>: <error>`` and gives the npz model;
* else the text encoder from ``text_encoder.npz`` (dims from its sidecar),
  else the hashing encoder; the CLIP from ``clip.npz`` (calibration from its
  sidecar), else none, and C2 skips; the ASR from ``asr_formant.npz``, else
  ``asr.npz``, else EnergyVAD segments with no words;
* the LLM and search with the JAX package's precedence: with
  ``recorded_services`` the deterministic ``RecordedLLM`` and
  ``RecordedSearch`` of ``providers/recorded.py``; else ``OpenAILLM`` where
  ``use_llm`` and a key (``OPENAI_API_KEY``) are given, else ``NullLLM``;
  and ``search.default_chain()`` (Serper, Google CSE, keyless DuckDuckGo,
  the disk cache under ``FVD_SEARCH_CACHE_DIR``) where ``use_search``, else
  ``NullSearch``.

Without a key the LLM is ``NullLLM``, so C3 extracts no claims and E1 never
searches.  One ``providers:`` line names the classes picked for the text
encoder, the CLIP and the ASR, and a second the LLM and the search.
"""

from __future__ import annotations

import functools
import inspect
import json
import os

import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch.providers import Providers
from fvd_tpu_torch.providers.asr import EnergyVAD
from fvd_tpu_torch.providers.encoders import HashingTextEncoder
from fvd_tpu_torch.providers.llm import NullLLM, OpenAILLM
from fvd_tpu_torch.providers.search import default_chain, describe

KNOWN_CHECKPOINTS = (
    "face_ssd.npz", "landmarks.npz", "pose.npz", "clip.npz", "asr.npz",
    "ocr_rec.npz", "ocr_det.npz", "text_encoder.npz", "hf",
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


def asr_speech_domain(checkpoint_dir: str) -> str:
    """The speech domain ("formant" | "tone") of the ASR checkpoint
    production_providers will load: synthetic-media generators use this to
    render audio the shipped ASR can actually transcribe."""
    for name in ("asr_formant", "asr"):
        npz = os.path.join(checkpoint_dir, name + ".npz")
        meta = os.path.join(checkpoint_dir, name + ".json")
        if os.path.exists(npz):
            try:
                with open(meta) as f:
                    return json.load(f).get("domain", "tone")
            except (OSError, ValueError):
                return "tone"
    return "tone"


def _sidecar(npz: str) -> dict:
    path = npz.replace(".npz", ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def network_services(use_llm: bool = True, use_search: bool = True, recorded_services: bool = False):
    """The bundle's (LLM, search), in the JAX package's precedence: the
    recorded pair with ``recorded_services``; else ``OpenAILLM`` where
    ``use_llm`` and it has a key, else ``NullLLM``; ``default_chain()``
    where ``use_search``, else the default ``Providers().search``."""
    if recorded_services:
        from fvd_tpu_torch.providers.recorded import RecordedLLM, RecordedSearch

        return RecordedLLM(), RecordedSearch()
    llm = OpenAILLM() if use_llm else NullLLM()
    if not llm.available:
        llm = NullLLM()
    return llm, default_chain() if use_search else Providers().search


def bootstrap_production(use_llm: bool = True, use_search: bool = True, device=None) -> Providers:
    """Install the production bundle on ``device`` as the process default
    unless a caller already installed one via set_providers() (entry points
    call this; tests and embedders that inject their own bundle keep it)."""
    from fvd_tpu_torch.providers import get_providers, providers_installed, set_providers

    if providers_installed():
        return get_providers()
    ckpt_dir = default_checkpoint_dir()
    print(f"providers: checkpoints from {os.path.abspath(ckpt_dir)}")
    return set_providers(production_providers(ckpt_dir, use_llm=use_llm, use_search=use_search, device=device))


def production_providers(checkpoint_dir: str = "checkpoints", use_llm: bool = True, use_search: bool = True,
                         recorded_services: bool = False, device=None,
                         compute_dtype: torch.dtype = torch.bfloat16) -> Providers:
    """The port's production bundle on ``device`` (default the card), the
    face and landmark backbones in ``compute_dtype``; the OCR, CLIP, text
    encoder and ASR compute as their JAX counterparts do (the v2 OCR
    detector in bf16, the rest in float32).  An npz checkpoint that exists
    but does not load raises; an HF directory that does not load is named
    and passed over, as in the JAX package.  ``recorded_services`` puts the
    recorded LLM and search in place of the null ones, so the C3 -> E1 -> E2
    -> E3 and V5 half of the DAG runs hermetically."""
    from fvd_tpu_torch.models.asr import JaxASR
    from fvd_tpu_torch.models.encoders import JaxClip, JaxTextEncoder
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.models.ocr import JaxOCR

    dev = resolve_device(device)
    ckpt = functools.partial(os.path.join, checkpoint_dir)
    detector = SSDFaceDetector(checkpoint=ckpt("face_ssd.npz"), compute_dtype=compute_dtype, device=dev)
    landmarks = FANLandmarks(detector, checkpoint=ckpt("landmarks.npz"), pose_checkpoint=ckpt("pose.npz"),
                             compute_dtype=compute_dtype, device=dev)
    ocr = JaxOCR.from_checkpoints(ckpt("ocr_det.npz"), ckpt("ocr_rec.npz"), device=dev)

    # The weight-compatible HF models take precedence where their
    # checkpoint directories exist.
    from fvd_tpu_torch.providers import hf_models

    def _try(kind, loader):
        path = ckpt("hf", kind)
        if os.path.isdir(path):
            try:
                return loader(path, device=dev)
            except Exception as e:
                print(f"providers: failed to load HF {kind}: {e}")
        return None

    text_encoder = _try("minilm", hf_models.HFTextEncoder.from_local)
    clip = _try("clip", hf_models.HFClip.from_local)
    asr = _try("whisper", hf_models.HFWhisperASR.from_local)

    # Without trained weights, the lexical hashing encoder ranks evidence
    # better than random weights would, and C2 skips (the reference's
    # model-load-failure behavior) rather than score with a random CLIP.
    if text_encoder is None and os.path.exists(ckpt("text_encoder.npz")):
        meta = _sidecar(ckpt("text_encoder.npz"))
        text_encoder = JaxTextEncoder(checkpoint=ckpt("text_encoder.npz"), dim=int(meta.get("dim", 192)),
                                      depth=int(meta.get("depth", 6)), out_dim=int(meta.get("out_dim", 256)),
                                      device=dev)
    if text_encoder is None:
        text_encoder = HashingTextEncoder()
    if clip is None and os.path.exists(ckpt("clip.npz")):
        # sidecars may carry extra bookkeeping fields; take only what the
        # constructor knows
        accepted = set(inspect.signature(JaxClip.__init__).parameters) - {"self", "params", "checkpoint",
                                                                          "device"}
        kwargs = {k: v for k, v in _sidecar(ckpt("clip.npz")).items() if k in accepted}
        clip = JaxClip(checkpoint=ckpt("clip.npz"), device=dev, **kwargs)
    # the formant-domain checkpoint first: speech-structured audio over the
    # tone-coded alphabet; both decode through the same VAD-windowed stack
    for name in ("asr_formant.npz", "asr.npz"):
        if asr is None and os.path.exists(ckpt(name)):
            asr = JaxASR.from_checkpoint(ckpt(name), device=dev)
    if asr is None:
        asr = EnergyVAD(device=dev)
    print(f"providers: text encoder {type(text_encoder).__name__}, CLIP {type(clip).__name__}, "
          f"ASR {type(asr).__name__}")
    llm, search = network_services(use_llm, use_search, recorded_services)
    print(f"providers: LLM {type(llm).__name__}, search {describe(search)}")
    return Providers(
        llm=llm,
        search=search,
        text_encoder=text_encoder,
        clip=clip,
        asr=asr,
        ocr=ocr,
        face_detector=detector,
        landmarks=landmarks,
    )
