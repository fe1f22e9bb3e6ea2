"""Build and bind the port's CUDA kernels.

Each kernel lives in a ``csrc/<source>.cu`` file (its own name unless
``SOURCES`` names another; a file may hold several kernels) with a plain
``extern "C"`` launcher and no PyTorch header.  At first use the file is
compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``build/fvd_tpu_torch_kernels/`` at the
root of the checkout, named by a hash of its source and ``NVCC_FLAGS``, and
loaded with ``ctypes``.  Nothing here runs at import; a missing ``nvcc`` or a
failed build raises, and nothing falls back.

Each wrapper calls :func:`count_launch` where it launches its kernel, so a run
can show that it went through the kernel.  A source may also export host
entry points that launch nothing (``ENTRY_POINTS``: the NVDEC session of
``csrc/nvdec.cu``); :func:`load` binds those the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "fvd_tpu_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
#: kernel name -> (launcher symbol, argtypes): device pointers, a pointer to the
#: scalar arguments' struct and the stream, all as ``c_void_p``
SIGNATURES = {
    "lipsync_score": ("lipsync_score_launch", [_P] * 8),
    "mpeg4_recon": ("mpeg4_recon_launch", [_P] * 9),
    "yuv420_rgb": ("yuv420_rgb_launch", [_P] * 4),
    "mpeg4_forward": ("mpeg4_forward_launch", [_P] * 6),
    "nv12_rgb": ("nv12_rgb_launch", [_P] * 5),
    "mpeg4_parse": ("mpeg4_parse_launch", [_P] * 7),
    "aac_synth": ("aac_synth_launch", [_P] * 6),
    "audio_resample": ("audio_resample_launch", [_P] * 5),
}
#: kernel name -> the ``csrc/`` file that holds it, where that is not its name
SOURCES = {"mpeg4_recon": "mpeg4_decode", "yuv420_rgb": "mpeg4_decode",
           "mpeg4_forward": "mpeg4_encode", "nv12_rgb": "nvdec"}
_I, _L = ctypes.c_int, ctypes.c_longlong
#: host entry point (its own symbol) -> (its ``csrc/`` file, argtypes); each
#: returns an int, 0 on success
ENTRY_POINTS = {
    "nvdec_open": ("nvdec", [_I, _P]),
    "nvdec_close": ("nvdec", [_P]),
    "nvdec_feed": ("nvdec", [_P, _P, _L, _I]),
    "nvdec_pending": ("nvdec", [_P]),
    "nvdec_map": ("nvdec", [_P, _P, _P]),
    "nvdec_unmap": ("nvdec", [_P]),
    "nvdec_skip": ("nvdec", [_P]),
    "nvdec_caps": ("nvdec", [_I, _P]),
    "nvdec_message": ("nvdec", [_P, _P, _I]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
#: seconds each kernel's build (or load of a cached build) took in this process
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]``; safe from several threads at once (the
    coalescer's groups launch from its own threads)."""
    with _count_lock:
        LAUNCHES[name] += 1


def _source(name: str) -> str:
    return ENTRY_POINTS[name][0] if name in ENTRY_POINTS else SOURCES.get(name, name)


def source_path(name: str) -> Path:
    """The ``.cu`` file of kernel, entry point (or source) ``name``."""
    return _PKG / "csrc" / f"{_source(name)}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
                       "kernels are built at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives: named by a hash of the
    source and of ``NVCC_FLAGS``, so a change of either builds anew."""
    digest = hashlib.sha256(source_path(name).read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{_source(name)}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    these flags exists."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str):
    """The launcher function of kernel ``name`` (or the entry point ``name``),
    built and bound on first use (one build and one load per source file)."""
    source = _source(name)
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build(name)))
            BUILD_SECONDS[source] = time.perf_counter() - t0
            _loaded[source] = lib
        symbol, argtypes = SIGNATURES[name] if name in SIGNATURES else (name, ENTRY_POINTS[name][1])
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
