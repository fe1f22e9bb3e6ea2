"""``fvd_tpu_torch/parallel/experts.py`` against ``fvd_tpu/parallel/experts.py``
on the CPU, case for case with ``tests/test_experts.py``: the EP MoE on a
module's group of four gloo ranks (``parallel/launch.py``) against the JAX
package's dense oracle on the same params (drawn by JAX, passed as numpy),
the same dropped tokens, and gradients that equal the dense oracle's.  The
JAX test's 8-way case is 2-way here with 4 experts a rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvd_tpu.parallel.experts import init_moe_params, moe_forward_dense
from fvd_tpu_torch.parallel import experts as texperts
from fvd_tpu_torch.parallel import programs
from fvd_tpu_torch.parallel.launch import RankGroup

#: float32 on both sides; only the summation order differs
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with RankGroup(4, "gloo", "cpu", str(tmp_path_factory.mktemp("store")), timeout=120.0) as group:
        yield group


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


@pytest.mark.parametrize("ep,e,b,d", [(4, 4, 32, 16), (2, 8, 16, 8), (2, 4, 24, 8)])
def test_moe_sharded_matches_dense(ranks, ep, e, b, d):
    params = init_moe_params(jax.random.PRNGKey(0), e, d, 4 * d)
    x = np.random.RandomState(0).randn(b, d).astype(np.float32)
    ref = np.asarray(moe_forward_dense(params, jnp.asarray(x)))
    got = ranks.run(programs.moe, ep, _np(params), x)
    assert got[ep:] == [None] * (4 - ep)
    for r in got[:ep]:   # replicated on every rank of the axis
        np.testing.assert_allclose(r["out"], ref, rtol=0, atol=TOL)
    dense = texperts.moe_forward_dense({k: torch.from_numpy(v) for k, v in _np(params).items()}, torch.from_numpy(x))
    np.testing.assert_allclose(dense.numpy(), ref, rtol=0, atol=TOL)


def test_moe_capacity_drops_overflow(ranks):
    """With capacity_factor tiny, later tokens routed to a full expert
    contribute zero (the caller's residual carries them): the same rows as
    the JAX package drops."""
    e, b, d = 2, 16, 8
    params = init_moe_params(jax.random.PRNGKey(1), e, d, 16)
    # identical tokens all route to one expert; capacity 1 keeps only the first
    x = np.ones((b, d), np.float32)
    rows = ranks.run(programs.moe, 2, _np(params), x, 1.0 / 8)[0]["out"]
    ref = np.asarray(moe_forward_dense(params, jnp.asarray(x), capacity_factor=1.0 / 8))
    nonzero = np.abs(rows).sum(axis=-1) > 1e-9
    assert nonzero.sum() <= max(1, int(np.ceil(b / e / 8)))
    np.testing.assert_array_equal(nonzero, np.abs(ref).sum(axis=-1) > 1e-9)
    np.testing.assert_allclose(rows, ref, rtol=0, atol=TOL)


def test_moe_routing_takes_the_first_expert_on_ties():
    """Top-1 routing: argmax takes the first index on ties, and the queue
    slot is the token's place among its expert's tokens."""
    x = torch.ones(3, 2)
    gate = torch.zeros(2, 4)   # all logits equal
    dispatch, combine = texperts._routing(x, gate, 4, capacity=2)
    assert dispatch[:, 0].sum() == 2 and dispatch[:, 1:].sum() == 0   # expert 0; the third token dropped
    assert dispatch[0, 0, 0] == 1 and dispatch[1, 0, 1] == 1 and dispatch[2].sum() == 0
    torch.testing.assert_close(combine, dispatch * 0.25)


def test_moe_grads_flow_sharded(ranks):
    e, b, d = 4, 32, 8
    params = init_moe_params(jax.random.PRNGKey(2), e, d, 16)
    x = np.random.RandomState(1).randn(b, d).astype(np.float32)
    tgt = np.random.RandomState(2).randn(b, d).astype(np.float32)

    def loss_dn(p):
        return jnp.mean((moe_forward_dense(p, jnp.asarray(x)) - jnp.asarray(tgt)) ** 2)

    g_dn = _np(jax.grad(loss_dn)(params))
    got = ranks.run(programs.moe, 4, _np(params), x, 1.25, tgt)
    per = e // 4
    for k, want in g_dn.items():
        if k == "gate":   # replicated: the full gradient on every rank
            for r in got:
                np.testing.assert_allclose(r["grads"][k], want, rtol=1e-4, atol=TOL, err_msg=k)
        else:             # each rank holds its experts' rows
            ours = np.concatenate([r["grads"][k] for r in got])
            np.testing.assert_allclose(ours, want, rtol=1e-4, atol=TOL, err_msg=k)
            assert ours.shape[0] == per * 4
    assert any(np.abs(r["grads"]["w1"]).max() > 0 for r in got)
