"""The port's kernel build bookkeeping (``fvd_tpu_torch/_kernels.py``) on the
CPU: where a build is kept, and the launch counts.  Neither needs nvcc."""

import sys
import threading

import pytest

from fvd_tpu_torch import _kernels


@pytest.mark.parametrize("name", sorted(_kernels.SIGNATURES))
def test_library_path_is_stable_for_the_same_source_and_flags(name):
    path = _kernels.library_path(name)
    assert path == _kernels.library_path(name)
    source = _kernels.SOURCES.get(name, name)  # kernels of one source share its build
    assert path.parent == _kernels.BUILD_DIR and path.name.startswith(f"{source}-")
    assert path.suffix == ".so"


FLAG_CHANGES = {
    "flag-added": lambda flags: flags + ["-lineinfo"],
    "optimisation-level": lambda flags: [f.replace("-O3", "-O2") for f in flags],
    "target": lambda flags: [f.replace("compute_90a,code=sm_90a", "compute_90,code=sm_90")
                             for f in flags],
}


@pytest.mark.parametrize("change", sorted(FLAG_CHANGES))
def test_library_path_changes_with_nvcc_flags(monkeypatch, change):
    before = _kernels.library_path("lipsync_score")
    flags = FLAG_CHANGES[change](list(_kernels.NVCC_FLAGS))
    assert flags != _kernels.NVCC_FLAGS
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", flags)
    changed = _kernels.library_path("lipsync_score")
    assert changed != before and changed.parent == before.parent
    monkeypatch.undo()
    assert _kernels.library_path("lipsync_score") == before


def test_library_path_changes_with_the_source(monkeypatch, tmp_path):
    before = _kernels.library_path("lipsync_score")
    src = tmp_path / "lipsync_score.cu"
    src.write_bytes(_kernels.source_path("lipsync_score").read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(_kernels, "source_path", lambda name: src)
    assert _kernels.library_path("lipsync_score") != before


def test_count_launch_loses_no_update_across_threads():
    """Coalesced groups launch from the coalescer's threads: each launch must
    count, however the threads interleave."""
    threads, per_thread = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _kernels.reset_launches()

        def work():
            for _ in range(per_thread):
                _kernels.count_launch("lipsync_score")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
        assert _kernels.LAUNCHES["lipsync_score"] == threads * per_thread
    finally:
        sys.setswitchinterval(interval)
        _kernels.reset_launches()
