"""``fvd_tpu_torch/parallel/stages.py`` against ``fvd_tpu/parallel/stages.py``
on the CPU, case for case with ``tests/test_pipeline_stages.py``: the GPipe
ring on a module's group of four gloo ranks (``parallel/launch.py``) against
the JAX package's ring and the sequential stack, its gradients against the
sequential stack's, and ``asr_encoder_pp`` against the JAX package's.  The
JAX test's 8-stage case is 4 stages here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fvd_tpu.parallel.stages import pipeline_forward, stack_layer_params
from fvd_tpu_torch.parallel import programs
from fvd_tpu_torch.parallel.launch import RankGroup

#: float32 on both sides; only the summation order differs
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankGroup(4, "gloo", "cpu", str(tmp_path_factory.mktemp("store")), timeout=120.0) as group:
        yield group


def _mlp_layer(params, x):
    w, b = params
    return x + jnp.tanh(x @ w + b)  # residual keeps activation shape


def _init_layers(rng, s, d):
    return [((rng.randn(d, d) * 0.3).astype(np.float32), (rng.randn(d) * 0.1).astype(np.float32))
            for _ in range(s)]


def _sequential(layers, xs):
    y = jnp.asarray(xs)
    for p in layers:
        y = jax.vmap(lambda x, p=p: _mlp_layer(p, x))(y)
    return y


@pytest.mark.parametrize("s,m", [(4, 6), (4, 3), (2, 1)])
def test_pipeline_forward_matches_sequential(ranks, s, m):
    rng = np.random.RandomState(0)
    d, b = 16, 4
    layers = _init_layers(rng, s, d)
    xs = rng.randn(m, b, d).astype(np.float32)
    ref = np.asarray(_sequential(layers, xs))
    jax_ring = pipeline_forward(Mesh(np.array(jax.devices()[:s]), ("stage",)), _mlp_layer,
                                stack_layer_params([tuple(map(jnp.asarray, p)) for p in layers]), jnp.asarray(xs))

    got = ranks.run(programs.pp_residual_stack, layers, xs)
    assert got[s:] == [None] * (4 - s)
    for r in got[:s]:   # the output is replicated over the ring
        np.testing.assert_allclose(r["out"], ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["out"], np.asarray(jax_ring), rtol=TOL, atol=TOL)


def test_pipeline_grad_matches_sequential(ranks):
    """The gradient goes back round the ring (the reverse hand-off), so the
    PP stack trains: each stage's gradient equals the sequential stack's."""
    s, m, d, b = 4, 6, 4, 8
    rng = np.random.RandomState(2)
    layers = _init_layers(rng, s, d)
    xs = rng.randn(m, b, d).astype(np.float32)
    tgt = rng.randn(m, b, d).astype(np.float32)

    def loss_seq(ls):
        return jnp.mean((_sequential(ls, xs) - jnp.asarray(tgt)) ** 2)

    g_seq = jax.grad(loss_seq)([tuple(map(jnp.asarray, p)) for p in layers])
    got = ranks.run(programs.pp_residual_stack, layers, xs, tgt)
    for stage, (r, (gw, gb)) in enumerate(zip(got, g_seq)):
        np.testing.assert_allclose(r["grads"][0], np.asarray(gw), rtol=TOL, atol=TOL, err_msg=f"w{stage}")
        np.testing.assert_allclose(r["grads"][1], np.asarray(gb), rtol=TOL, atol=TOL, err_msg=f"b{stage}")
    assert float(got[0]["loss1"]) < float(got[0]["loss0"])   # one SGD step lowers the loss


def test_asr_encoder_pp_matches_replicated(ranks):
    """The real-model PP path: the ASR encoder's MHABlock stack one block per
    stage equals the JAX package's replicated encoder and its PP encoder."""
    from fvd_tpu.models.asr import N_MELS, AsrModel
    from fvd_tpu.parallel.stages import asr_encoder_pp
    from fvd_tpu_torch import weights

    dim, depth, b, t = 64, 4, 4, 32
    model = AsrModel(dim=dim, depth=depth)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, t, N_MELS), jnp.float32),
                                 jnp.zeros((1, 8), jnp.int32))
    mel = np.random.RandomState(0).randn(b, t, N_MELS).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: model.apply(p, x, method=AsrModel.encode))(params, jnp.asarray(mel)))
    jax_pp = np.asarray(asr_encoder_pp(params, jnp.asarray(mel), Mesh(np.array(jax.devices()[:depth]), ("stage",)),
                                       dim=dim, depth=depth))
    state = {k[len("encoder."):]: v.numpy() for k, v in weights.to_state_dict(params).items()
             if k.startswith("encoder.")}
    got = ranks.run(programs.pp_asr_encoder, state, dim, depth, mel)
    for r in got:
        np.testing.assert_allclose(r, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r, jax_pp, rtol=2e-5, atol=2e-5)


def test_pipeline_forward_without_grad_equals_with_grad(ranks):
    """The ring under ``torch.no_grad`` (inference) and with autograd on (the
    JAX test's jit-versus-eager check) give the same output."""
    s, m, d, b = 4, 5, 8, 2
    rng = np.random.RandomState(1)
    layers = _init_layers(rng, s, d)
    xs = rng.randn(m, b, d).astype(np.float32)
    with_grad = ranks.run(programs.pp_residual_stack, layers, xs, np.zeros_like(xs))
    no_grad = ranks.run(programs.pp_residual_stack, layers, xs)
    for a, c in zip(with_grad, no_grad):
        np.testing.assert_allclose(a["out"], c["out"], rtol=1e-6, atol=1e-6)
