"""The full 16-node DAG under the inference mesh, the counterpart of
``tests/test_mesh_full_dag.py``: the production bundle (the npz view of
``checkpoints/`` of ``tests/test_torch_zoo_dag.py``, float32) with the
recorded services and the cross-video coalescer, on one clip, run by the
port alone and under a 4-entry CPU inference mesh, and by the JAX package
under its 8-device mesh.  The fused probability must survive sharding
(|dp| <= 1e-3, the JAX test's bar, features within 2e-3) and agree with the
JAX package's meshed run at the same bars."""

import functools
import os

import jax.numpy as jnp
import pytest
import torch

#: the JAX test's bars: the fused probability and each LR feature
PROB_TOL, FEATURE_TOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import fvd_tpu.config as jconfig
    import fvd_tpu_torch.config as tconfig
    from fvd_tpu import graph as jgraph
    from fvd_tpu.models import face_ssd as jssd
    from fvd_tpu.models import landmarks_fan as jlmk
    from fvd_tpu.parallel.inference import set_inference_mesh as jset_mesh
    from fvd_tpu.parallel.mesh import make_mesh as jmake_mesh
    from fvd_tpu.providers import factory as jfactory
    from fvd_tpu.providers.coalesce import coalesce_providers as jcoalesce
    from fvd_tpu.runtime.scheduler import Scheduler as JScheduler
    from fvd_tpu.state import State as JState
    from fvd_tpu_torch import graph as tgraph
    from fvd_tpu_torch.parallel import inference
    from fvd_tpu_torch.parallel.mesh import make_mesh
    from fvd_tpu_torch.providers import factory as tfactory
    from fvd_tpu_torch.providers import media as tmedia
    from fvd_tpu_torch.providers.coalesce import coalesce_providers
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import make_face_video
    from test_torch_full_dag import CKPT, _config
    from test_torch_zoo_dag import LINKED, SPEECH

    ckpt = tmp_path_factory.mktemp("ckpt")
    for n in LINKED:
        os.symlink(os.path.join(CKPT, n), ckpt / n)
    clip = make_face_video(str(tmp_path_factory.mktemp("clip")), "meshdag", duration=4.0, fps=10.0, seed=11,
                           speech_text=SPEECH)

    shards = []
    replica = inference.replica

    def counting_replica(model, device):
        shards.append(device)
        return replica(model, device)

    def run_torch(mesh, name):
        tmedia.clear_frame_cache()
        prev = inference.set_inference_mesh(mesh)
        provs, close = coalesce_providers(tfactory.production_providers(
            str(ckpt), device="cpu", compute_dtype=torch.float32, recorded_services=True))
        try:
            dag = tgraph.build_graph(_config(tconfig, tmp_path_factory.mktemp(name)), provs, device="cpu")
            final = Scheduler(dag).invoke(State(input_path=clip))
            return float(final.fake_probability), dict(final.features)
        finally:
            close()
            inference.set_inference_mesh(prev)

    out = {"single": run_torch(None, "single")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(inference, "replica", counting_replica)
        out["mesh"] = run_torch(make_mesh(n_data=4, n_time=1, devices=["cpu"] * 4), "mesh")
    out["shards"] = len(shards)

    tmedia.clear_frame_cache()
    prev = jset_mesh(jmake_mesh(n_data=8, n_time=1))
    provs, close = jcoalesce(jfactory.production_providers(str(ckpt), use_llm=False, use_search=False,
                                                           recorded_services=True))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jssd, "detect_batch_jit", functools.partial(jssd.detect_batch_jit, compute_dtype=jnp.float32))
            mp.setattr(jlmk, "landmarks_pose_from_frames",
                       functools.partial(jlmk.landmarks_pose_from_frames, compute_dtype=jnp.float32))
            dag = jgraph.build_graph(_config(jconfig, tmp_path_factory.mktemp("jax")), provs)
            final = JScheduler(dag).invoke(JState(input_path=clip))
        out["jax_mesh"] = (float(final.fake_probability), dict(final.features))
    finally:
        close()
        jset_mesh(prev)
    return out


def test_full_dag_mesh_equals_single_device(mesh_runs):
    p_single, f_single = mesh_runs["single"]
    p_mesh, f_mesh = mesh_runs["mesh"]
    assert mesh_runs["shards"] > 0   # the mesh run split forwards over its entries
    assert 0.0 < p_single < 1.0
    assert abs(p_single - p_mesh) <= PROB_TOL, (p_single, p_mesh)
    for k, v in f_single.items():
        assert f_mesh[k] == pytest.approx(v, abs=FEATURE_TOL), (k, v, f_mesh[k])


def test_full_dag_mesh_matches_the_jax_meshed_run(mesh_runs):
    p_mesh, f_mesh = mesh_runs["mesh"]
    p_jax, f_jax = mesh_runs["jax_mesh"]
    assert abs(p_mesh - p_jax) <= PROB_TOL, (p_mesh, p_jax)
    assert set(f_mesh) == set(f_jax)
    for k, v in f_jax.items():
        assert f_mesh[k] == pytest.approx(v, abs=FEATURE_TOL), (k, v, f_mesh[k])
