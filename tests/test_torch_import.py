"""The port stands alone: ``fvd_tpu_torch`` and ``chip_smoke.py`` import with
JAX, flax, OpenCV, transformers, tokenizers, msgpack, regex, requests and
openai blocked, and no source of theirs names ``fvd_tpu`` or imports one of
those."""

import os
import pkgutil
import re
import subprocess
import sys

import fvd_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "fvd_tpu_torch")


def _modules():
    return sorted(["fvd_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="fvd_tpu_torch.")])


BLOCKED = ("jax", "flax", "cv2", "transformers", "tokenizers", "msgpack", "regex", "requests", "openai")


def test_every_module_imports_with_jax_flax_cv2_blocked():
    mods = _modules()
    assert {"fvd_tpu_torch.entry", "fvd_tpu_torch.serving", "fvd_tpu_torch.ops.lipsync",
            "fvd_tpu_torch.models.face_ssd", "fvd_tpu_torch.models.landmarks_fan",
            "fvd_tpu_torch.config", "fvd_tpu_torch.state", "fvd_tpu_torch.runtime.scheduler",
            "fvd_tpu_torch.providers.coalesce", "fvd_tpu_torch.nodes.c1_lipsync",
            "fvd_tpu_torch.nodes.lr_fusion", "fvd_tpu_torch.utils.wav", "fvd_tpu_torch.utils.avi",
            "fvd_tpu_torch.utils.png", "fvd_tpu_torch.utils.draw", "fvd_tpu_torch.ops.resample",
            "fvd_tpu_torch.ops.spectral", "fvd_tpu_torch.ops.filters", "fvd_tpu_torch.providers.media",
            "fvd_tpu_torch.providers.vision", "fvd_tpu_torch.providers.llm",
            "fvd_tpu_torch.providers.search", "fvd_tpu_torch.providers.encoders",
            "fvd_tpu_torch.providers.asr", "fvd_tpu_torch.runtime.io_pool", "fvd_tpu_torch.nodes.ingest",
            "fvd_tpu_torch.nodes.a1_standardize", "fvd_tpu_torch.nodes.a3_onsets",
            "fvd_tpu_torch.nodes.v1_faces", "fvd_tpu_torch.nodes._tracking",
            "fvd_tpu_torch.nodes.v3_landmarks", "fvd_tpu_torch.synthetic", "fvd_tpu_torch.graph",
            "fvd_tpu_torch.cli", "fvd_tpu_torch.ops.forensics", "fvd_tpu_torch.providers.factory",
            "fvd_tpu_torch.nodes.a2_asr", "fvd_tpu_torch.nodes.v2_ocr", "fvd_tpu_torch.nodes.v4_dynamics",
            "fvd_tpu_torch.nodes.v5_forensics", "fvd_tpu_torch.nodes.c2_gesture", "fvd_tpu_torch.nodes.c3_claims",
            "fvd_tpu_torch.nodes.e1_evidence", "fvd_tpu_torch.nodes.e2_reliability",
            "fvd_tpu_torch.nodes.e3_scorer", "fvd_tpu_torch.models.transformer", "fvd_tpu_torch.models.encoders",
            "fvd_tpu_torch.models.ocr", "fvd_tpu_torch.models.asr", "fvd_tpu_torch.utils.cv",
            "fvd_tpu_torch.utils.msgpack", "fvd_tpu_torch.utils.hf_tokenizers",
            "fvd_tpu_torch.utils._tokenizer_unicode",
            "fvd_tpu_torch.ops.whisper_frontend", "fvd_tpu_torch.models.hf_bert", "fvd_tpu_torch.models.hf_clip",
            "fvd_tpu_torch.models.hf_whisper", "fvd_tpu_torch.providers.hf_models", "fvd_tpu_torch.utils.jpeg",
            "fvd_tpu_torch.providers.recorded", "fvd_tpu_torch.batch",
            "fvd_tpu_torch.streaming", "fvd_tpu_torch.ui.web", "fvd_tpu_torch.ui.app",
            "fvd_tpu_torch.parallel", "fvd_tpu_torch.parallel.mesh", "fvd_tpu_torch.parallel.launch",
            "fvd_tpu_torch.parallel.inference", "fvd_tpu_torch.parallel.pipeline",
            "fvd_tpu_torch.parallel.tensor", "fvd_tpu_torch.parallel.stages",
            "fvd_tpu_torch.parallel.experts", "fvd_tpu_torch.parallel.programs",
            "fvd_tpu_torch.models.synthetic_faces", "fvd_tpu_torch.models.synthetic_pose",
            "fvd_tpu_torch.models.checkpointing", "fvd_tpu_torch.tools",
            "fvd_tpu_torch.tools.pretrain_synthetic", "fvd_tpu_torch.tools.pretrain_asr",
            "fvd_tpu_torch.tools.pretrain_text_encoder", "fvd_tpu_torch.models.synthetic_speech",
            "fvd_tpu_torch.providers.loopback", "fvd_tpu_torch.tools.make_labeled_corpus",
            "fvd_tpu_torch.tools.accuracy_trajectory", "fvd_tpu_torch.tools.calibrate_lr",
            "fvd_tpu_torch.utils.text", "fvd_tpu_torch.models.synthetic_text", "fvd_tpu_torch.tools.pretrain_ocr",
            "fvd_tpu_torch.tools.pretrain_clip", "fvd_tpu_torch.tools.eval_heldout",
            "fvd_tpu_torch.tools.make_text_atlas", "fvd_tpu_torch.models.optim",
            "fvd_tpu_torch.tools.pretrain_fan", "fvd_tpu_torch.models.hf_layers", "fvd_tpu_torch.tools.hf_train",
            "fvd_tpu_torch.tools.make_hf_geometry_checkpoints", "fvd_tpu_torch.tools.pretrain_hf_minilm",
            "fvd_tpu_torch.tools.pretrain_hf_whisper", "fvd_tpu_torch.tools.pretrain_hf_clip",
            "fvd_tpu_torch.tools.eval_asr_paired", "fvd_tpu_torch.tools.eval_text_paired",
            "fvd_tpu_torch.tools.eval_clip_paired", "fvd_tpu_torch.tools.eval_asr_whisper_paired",
            "fvd_tpu_torch.tools.eval_pipeline_paired", "fvd_tpu_torch.tools.diagnose_det_heldout",
            "fvd_tpu_torch.tools.diagnose_lmkpose_heldout", "fvd_tpu_torch.tools.profile_pipeline",
            "fvd_tpu_torch.tools.repro_node", "fvd_tpu_torch.tools.render_dag_svg",
            "fvd_tpu_torch.nodes._smooth", "fvd_tpu_torch.tools.ab_bench"} <= set(mods)
    # a fresh interpreter: this test process has imported jax for other files
    code = (
        "import importlib, sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'fvd_tpu' or m.startswith('fvd_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_source_names_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith((".py", ".cu"))]
    names_pkg = re.compile(r"\bfvd_tpu\.|import fvd_tpu\b")
    imports_jax = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(BLOCKED), re.M)
    offenders = []
    for path in files:
        with open(path) as f:
            text = f.read()
        for pat in (names_pkg, imports_jax):
            offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0)!r}" for m in pat.finditer(text)]
    # the glyph atlas' generator measures OpenCV itself, inside its main()
    # (the module imports without cv2, as the first test shows)
    allowed = [f"{os.path.join('fvd_tpu_torch', 'tools', 'make_text_atlas.py')}: '    import cv2'"]
    assert sorted(offenders) == allowed, offenders


def test_default_device_is_the_card():
    assert fvd_tpu_torch.default_device() == "cuda"
