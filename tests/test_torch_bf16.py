"""bf16, stage by stage: the port's bf16 V1 detector and V3 landmark net
against the JAX package's bf16 path on the same inputs, at the shipped
checkpoints' width 32.

The inputs are the first keyframes and crops of ``__graft_entry__.entry()``'s
clip (``fvd_tpu_torch.entry.example_inputs``).  bf16 keeps 8 mantissa bits and
the two frameworks round at different places in the conv sums, so the bars
are set from what the two packages gave at ``entry()``'s ten keyframes and
fifty crops on the CPU (top boxes 1.0e-3 of the image, top scores 3.7e-3,
landmarks 0.0124 of the crop), with headroom.  End to end, the lip score of a
nearly flat MAR series magnifies these; that is not held here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.models import face_ssd as jssd
from fvd_tpu.models import landmarks_fan as jlmk
from fvd_tpu_torch import weights
from fvd_tpu_torch.entry import H, W, example_inputs
from fvd_tpu_torch.models import face_ssd as tssd
from fvd_tpu_torch.models import landmarks_fan as tlmk

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints")
#: bf16 vs bf16 across the two packages (see the module docstring)
TOP_BOX_TOL = 2e-3      # normalised box corners of each keyframe's first NMS slot
TOP_SCORE_TOL = 5e-3    # that slot's score
LANDMARK_TOL = 2e-2     # landmarks in crop coordinates [0, 1], on identical boxes
KEYFRAMES, CROPS = 4, 8


@pytest.fixture(scope="module")
def clip():
    frames = example_inputs()[0]
    return frames[: 30 * KEYFRAMES]


@pytest.fixture(scope="module")
def detections(clip):
    """Each package's bf16 detections of the clip's 1 fps keyframes."""
    keyframes = clip[::30]
    jparams = jssd.load_params(os.path.join(CKPT, "face_ssd.npz"), width=32)
    jb, js = jssd.detect_batch_jit(jparams, jnp.asarray(keyframes), width=32, compute_dtype=jnp.bfloat16)
    model = tssd.from_params(weights.read_npz(os.path.join(CKPT, "face_ssd.npz")), "cpu")
    tb, ts = tssd.detect_batch(model, torch.from_numpy(keyframes), compute_dtype=torch.bfloat16)
    return (np.asarray(jb), np.asarray(js)), (tb.numpy(), ts.numpy())


def test_v1_top_boxes_and_scores_bf16_match_jax(detections):
    (jb, js), (tb, ts) = detections
    assert tb.shape == jb.shape == (KEYFRAMES, 32, 4)
    assert (js[:, 0] > 0).all()  # every keyframe has a first slot to compare
    np.testing.assert_allclose(tb[:, 0], jb[:, 0], atol=TOP_BOX_TOL, rtol=0)
    np.testing.assert_allclose(ts[:, 0], js[:, 0], atol=TOP_SCORE_TOL, rtol=0)


def test_v3_landmarks_bf16_on_identical_boxes_match_jax(clip, detections):
    (jb, _), _ = detections
    lmk_ids = np.arange(0, len(clip), 6)[:CROPS]
    boxes = (jb[lmk_ids // 30, 0] * np.array([W, H, W, H], np.float32)).astype(np.float32)
    init = jax.jit(jlmk.LandmarkHourglass(width=32).init)(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)))
    jparams = jlmk.load_params(os.path.join(CKPT, "landmarks.npz"), init)
    ref = np.asarray(jlmk.landmarks_from_frames(jparams, jnp.asarray(clip), jnp.asarray(boxes),
                                                jnp.asarray(lmk_ids), width=32, compute_dtype=jnp.bfloat16))
    model = tlmk.from_params(weights.read_npz(os.path.join(CKPT, "landmarks.npz")), "cpu")
    got = tlmk.landmarks_from_frames(model, torch.from_numpy(clip), torch.from_numpy(boxes),
                                     torch.from_numpy(lmk_ids).long(), compute_dtype=torch.bfloat16).numpy()
    assert got.shape == ref.shape == (CROPS, 68, 2)
    np.testing.assert_allclose(got, ref, atol=LANDMARK_TOL, rtol=0)
