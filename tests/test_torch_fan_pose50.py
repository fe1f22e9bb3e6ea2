"""The reference-scale vision modules of ``fvd_tpu_torch/models/landmarks_fan.py``
against the JAX package's on the CPU, at small sizes.

* ``FANLandmarkNet`` at width 32 and 2 stacks on flax's parameters (carried
  through ``weights.to_state_dict``), 64-px crops: heatmaps and soft-argmax
  coordinates within ``F32_TOL`` in float32; in bfloat16 on float32
  parameters (``dtype=jnp.bfloat16`` against ``compute_dtype=torch.bfloat16``)
  within the bar ``BF16_FACTOR`` explains.  Its full-geometry parameter
  count equals ``init_fan_params``'.
* ``PoseResNet50``: JAX's ``test_pose_resnet_shapes_reduced_depth`` mirrored
  on the port's ``Bottleneck``, the full module's parameters (count, names
  and shapes) equal to ``init_pose50_params``', and a 64-px forward on
  flax's parameters within ``POSE50_TOL``.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn as nn

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fvd_tpu.models import landmarks_fan as jlf  # noqa: E402
from fvd_tpu.models import synthetic_faces as jsf  # noqa: E402
from fvd_tpu_torch import weights  # noqa: E402
from fvd_tpu_torch.models import landmarks_fan as lf  # noqa: E402
from fvd_tpu_torch.models.layers import SameConv2d  # noqa: E402
from test_torch_train_losses import one_torch_thread  # noqa: E402,F401

WIDTH, STACKS, CROP = 32, 2, 64
#: float32 against float32: only the conv sums' order differs (measured
#: 3.8e-5 on heatmaps of |hm| ~ 3.4 and 2.6e-5 of the crop on the coordinates)
F32_TOL = {"heatmaps": 2e-4, "coords": 1e-4}
#: bfloat16 against bfloat16 (8 mantissa bits; XLA's and oneDNN's convs round
#: their sums apart).  On seeded weights the heatmaps are flat and the
#: soft-argmax at temperature 10 magnifies each rounding: JAX's own bfloat16
#: forward lies 0.29 (heatmaps) and 0.16 of the crop (coordinates) from its
#: float32 one, and the port's bfloat16 0.28 and 0.16 from JAX's.  The bar:
#: no further from JAX's bfloat16 than this factor times JAX's own bfloat16
#: distance, and a mean coordinate distance under ``BF16_MEAN_COORDS``
BF16_FACTOR = 1.5
BF16_MEAN_COORDS = 0.03
#: 16 float32 bottlenecks up to 2048 wide, each GroupNorm'd, to a 6D output of
#: |d6| ~ 1
POSE50_TOL = 1e-4


def _crops(seed=0, n=2):
    return jsf.landmark_batch(np.random.RandomState(seed), n, crop=CROP, augment=True, hard_half=True)


@functools.lru_cache(maxsize=None)
def _flax_fan():
    crops, _ = _crops()
    net = jlf.FANLandmarkNet(width=WIDTH, n_stacks=STACKS)
    return jax.jit(net.init)(jax.random.PRNGKey(3), jnp.asarray(crops))


def _forwards(dtype):
    """-> (port heatmaps, JAX heatmaps) of ``_crops()`` on ``_flax_fan()``'s
    parameters, computing in ``dtype``."""
    crops, _ = _crops()
    params = _flax_fan()
    jdt, tdt = {"f32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    net = jlf.FANLandmarkNet(width=WIDTH, n_stacks=STACKS, dtype=jdt)
    ref = np.asarray(jax.jit(net.apply)(params, jnp.asarray(crops)))
    model = lf.FANLandmarkNet(WIDTH, STACKS, compute_dtype=tdt)
    model.load_state_dict(weights.to_state_dict(params), strict=True)
    with torch.no_grad():
        hm = model(torch.from_numpy(crops))
    assert hm.dtype == torch.float32 and hm.shape == ref.shape == (2, CROP // 4, CROP // 4, lf.N_LANDMARKS)
    return hm.numpy(), ref


def _coords(hm):
    return np.asarray(jlf.decode_heatmaps(jnp.asarray(hm)))


def test_fan_forward_matches_flax_f32():
    hm, ref = _forwards("f32")
    np.testing.assert_allclose(hm, ref, atol=F32_TOL["heatmaps"], rtol=0)
    np.testing.assert_allclose(lf.decode_heatmaps(torch.from_numpy(hm)).numpy(), _coords(ref),
                               atol=F32_TOL["coords"], rtol=0)


def test_fan_forward_matches_flax_bf16():
    hm, ref = _forwards("bf16")
    _, ref32 = _forwards("f32")
    assert np.abs(hm - ref).max() <= BF16_FACTOR * np.abs(ref - ref32).max()
    d = np.abs(lf.decode_heatmaps(torch.from_numpy(hm)).numpy() - _coords(ref))
    assert d.max() <= BF16_FACTOR * np.abs(_coords(ref) - _coords(ref32)).max()
    assert d.mean() <= BF16_MEAN_COORDS


# -------------------------------------------------------------- PoseResNet50
class _FlaxSmallPose(fnn.Module):
    """``tests/test_ocr_v2_and_fan_scale.py``'s ``SmallPose``."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(16, (7, 7), strides=(4, 4), padding="SAME")(x)
        x = jlf.Bottleneck(32, stride=2)(x)
        x = jlf.Bottleneck(64, stride=2)(x)
        x = jnp.mean(x, axis=(1, 2))
        return fnn.Dense(6)(x)


class _SmallPose(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = SameConv2d(3, 16, 7, stride=4)
        self.Bottleneck_0 = lf.Bottleneck(16, 32, stride=2)
        self.Bottleneck_1 = lf.Bottleneck(32, 64, stride=2)
        self.Dense_0 = nn.Linear(64, 6)

    def forward(self, x):
        x = self.Bottleneck_1(self.Bottleneck_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        return self.Dense_0(x.mean(dim=(2, 3)))


def test_pose_resnet_shapes_reduced_depth():
    crops = np.random.RandomState(6).rand(2, 224, 224, 3).astype(np.float32)
    net = _FlaxSmallPose()
    params = jax.jit(net.init)(jax.random.PRNGKey(6), jnp.asarray(crops))
    ref = np.asarray(jax.jit(net.apply)(params, jnp.asarray(crops)))
    model = _SmallPose()
    model.load_state_dict(weights.to_state_dict(params), strict=True)
    with torch.no_grad():
        d6 = model(torch.from_numpy(crops))
    np.testing.assert_allclose(d6.numpy(), ref, atol=F32_TOL["coords"], rtol=0)
    R = lf.rotation_6d_to_matrix(d6)
    np.testing.assert_allclose(torch.einsum("bij,bkj->bik", R, R).numpy(), np.eye(3)[None].repeat(2, 0), atol=1e-5)
    assert lf.euler_from_matrix_deg(R).shape == (2, 3)


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


def test_pose50_parameter_count_and_names_match_flax():
    template = jax.eval_shape(lambda: jlf.init_pose50_params(jax.random.PRNGKey(0)))
    model = lf.PoseResNet50()
    assert sum(p.numel() for p in model.parameters()) == _count(template)
    shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(template)[0]}
    assert {k: v.shape for k, v in weights.from_state_dict(model).items()} == shapes


def test_pose50_forward_matches_flax():
    crops = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    net = jlf.PoseResNet50()
    params = jax.jit(net.init)(jax.random.PRNGKey(4), jnp.asarray(crops))
    ref = np.asarray(jax.jit(net.apply)(params, jnp.asarray(crops)))
    model = lf.PoseResNet50()
    model.load_state_dict(weights.to_state_dict(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, ref, atol=POSE50_TOL, rtol=0)


def test_fan_full_geometry_param_count():
    template = jax.eval_shape(lambda: jlf.init_fan_params(jax.random.PRNGKey(7)))
    n = sum(p.numel() for p in lf.FANLandmarkNet().parameters())
    assert n == _count(template) and 10e6 < n < 40e6
