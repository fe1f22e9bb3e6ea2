"""Pluggable host-side providers: the port's copy of
``fvd_tpu/providers/__init__.py``.

Every external capability is a small protocol with a deterministic
Null/Scripted implementation used by default, so nodes behave exactly like
the reference does with no API key and no model available.  The port's
production vision providers are ``fvd_tpu_torch.models.face_ssd.SSDFaceDetector``
and ``fvd_tpu_torch.models.landmarks_fan.FANLandmarks``; ``media.py`` holds the
video I/O and the frame caches, ``coalesce.py`` the program coalescer and
``factory.py`` the production bundle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from fvd_tpu_torch.providers.llm import LLMProvider, NullLLM, ScriptedLLM  # noqa: F401
from fvd_tpu_torch.providers.search import NullSearch, SearchProvider, StaticSearch  # noqa: F401
from fvd_tpu_torch.providers.encoders import (  # noqa: F401
    ClipProvider,
    HashingTextEncoder,
    StubClip,
    TextEncoder,
)
from fvd_tpu_torch.providers.asr import ASRProvider, NullASR, ScriptedASR  # noqa: F401
from fvd_tpu_torch.providers.vision import (  # noqa: F401
    FaceDetectorProvider,
    LandmarkProvider,
    NullOCR,
    OCRProvider,
    ScriptedLandmarks,
    ScriptedOCR,
)


@dataclass
class Providers:
    """The full provider bundle a pipeline run uses."""

    llm: LLMProvider = field(default_factory=NullLLM)
    search: SearchProvider = field(default_factory=NullSearch)
    text_encoder: TextEncoder = field(default_factory=HashingTextEncoder)
    clip: ClipProvider = field(default_factory=StubClip)
    asr: ASRProvider = field(default_factory=NullASR)
    ocr: OCRProvider = field(default_factory=NullOCR)
    face_detector: Optional[FaceDetectorProvider] = None
    landmarks: Optional[LandmarkProvider] = None


_default: Providers = Providers()
_default_is_custom: bool = False


def get_providers() -> Providers:
    return _default


def providers_installed() -> bool:
    """True once set_providers() has replaced the inert default bundle."""
    return _default_is_custom


def set_providers(providers: Providers) -> Providers:
    global _default, _default_is_custom
    _default = providers
    _default_is_custom = True
    return _default
