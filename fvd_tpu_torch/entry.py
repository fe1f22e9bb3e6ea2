"""The fused per-video analyzer: the counterpart of ``__graft_entry__.entry()``.

``fn(ssd, lmk, frames u8[T,240,320,3], audio f32[M], other_feats [8], w [9],
b []) -> (fake_probability, lip_sync_score)`` over 10 s of 30 fps video: the
SSD detector on the 1 fps subsample (V1), the hourglass on the 5 fps crops
gathered with each frame's nearest keyframe box (V3), the mouth-aspect-ratio
series, the audio RMS envelope (A3), windowed lip-sync (C1, one launch of the CUDA
stage kernel on the card) and the LR head.  Both backbones run in bf16, as
the reference does.

Run it on the card with ``python -m fvd_tpu_torch.entry``.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: the parallel layer's six checks on
``n`` ranks and an in-process inference mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from fvd_tpu_torch import resolve_device
from fvd_tpu_torch import weights as weights_mod
from fvd_tpu_torch.models import face_ssd, landmarks_fan
from fvd_tpu_torch.ops.lipsync import lip_sync_score, mar_from_points
from fvd_tpu_torch.ops.spectral import interp_to_length, rms_envelope

CHECKPOINT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "checkpoints")
FPS = 30.0
SR = 16000
H, W = 240, 320


def load_models(device=None, checkpoint_dir: str = CHECKPOINT_DIR):
    """(FaceSSD, LandmarkHourglass) from ``face_ssd.npz`` and
    ``landmarks.npz``, at the widths their kernels carry."""
    dev = resolve_device(device)
    ssd = face_ssd.from_params(weights_mod.read_npz(os.path.join(checkpoint_dir, "face_ssd.npz")), dev)
    lmk = landmarks_fan.from_params(
        weights_mod.read_npz(os.path.join(checkpoint_dir, "landmarks.npz")), dev)
    return ssd, lmk


def make_analyzer(duration: float = 10.0, compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """The analyzer ``fn`` for a clip of ``duration`` seconds."""
    T = int(duration * FPS)
    det_stride = int(FPS)          # 1 fps detect
    lmk_stride = int(FPS / 5)      # 5 fps landmarks
    det_ids = np.arange(0, T, det_stride)
    lmk_ids = np.arange(0, T, lmk_stride)
    lmk_det = lmk_ids // det_stride  # nearest-keyframe box
    n_lmk = len(lmk_ids)
    lmk_fps = FPS / lmk_stride
    hop = int(SR / lmk_fps)

    @torch.no_grad()
    def fn(ssd, lmk, frames, audio_wave, other_feats, w, b):
        dev = frames.device
        boxes, _ = face_ssd.detect_batch(ssd, frames[torch.as_tensor(det_ids, device=dev)],
                                         compute_dtype=compute_dtype)
        best = boxes[:, 0, :]  # NMS output is score-sorted; normalized corners
        px = best * torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
        coords = landmarks_fan.landmarks_from_frames(
            lmk, frames, px[torch.as_tensor(lmk_det, device=dev)],
            torch.as_tensor(lmk_ids, device=dev), compute_dtype=compute_dtype)
        mar = mar_from_points(coords[:, 48:68, :])

        env = rms_envelope(audio_wave, frame_length=2 * hop, hop=hop)
        env = interp_to_length(env, n_lmk)
        lip = lip_sync_score(mar, env, lmk_fps).score

        # LR fusion, lip_sync at index 2 of fvd_tpu_torch.ops.fusion.FEATURE_ORDER
        feats = torch.cat([other_feats[:2], lip[None], other_feats[2:]])
        prob = torch.sigmoid(feats @ w + b)
        return prob, lip

    return fn


def example_inputs(duration: float = 10.0):
    """The example inputs of ``__graft_entry__.entry()`` as numpy arrays, made
    from ``RandomState(0)``: frames, audio, other_feats, w, b."""
    T, M = int(duration * FPS), int(duration * SR)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 255, size=(T, H, W, 3), dtype=np.uint8)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(M) / SR)).astype(np.float32)
    other = rng.rand(8).astype(np.float32)
    w = rng.randn(9).astype(np.float32) * 0.1
    b = np.float32(0.1)
    return frames, audio, other, w, b


def entry(device=None, compute_dtype: torch.dtype = torch.bfloat16,
          duration: float = 10.0, checkpoint_dir: str = CHECKPOINT_DIR) -> Tuple[Callable, tuple]:
    """Returns ``(fn, example_args)``: ``fn(*example_args)`` ->
    ``(fake_probability, lip_sync_score)``, with the models and inputs on
    ``device`` (default the card)."""
    dev = resolve_device(device)
    ssd, lmk = load_models(dev, checkpoint_dir)
    frames, audio, other, w, b = example_inputs(duration)
    args = (ssd, lmk) + tuple(torch.as_tensor(a).to(dev) for a in (frames, audio, other, w, b))
    return make_analyzer(duration, compute_dtype), args


# ---------------------------------------------------------------------------
# dryrun_multichip: the parallel layer's checks
# ---------------------------------------------------------------------------
#: the bars of ``__graft_entry__.dryrun_multichip``
SHARDED_TOL = 2e-3          # sharded inference (SSD + hourglass, FAN) vs one device
TP_TOL = 1e-4               # TP vs replicated, times max(1, |output|)
PP_EP_TOL = 1e-4            # PP vs sequential, EP vs the dense oracle
DAG_TOL = 1e-3              # the full DAG's fake_probability, mesh vs one device
#: the multichip train step's loss at w = 0, b = 0: the BCE of p = 1/2
LOG2 = float(np.log(2.0))


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn, *args):
    """``(fn(*args), ms)`` on the host clock, the device synchronised."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _max_delta(a, b) -> float:
    from fvd_tpu_torch.parallel.launch import to_host

    return float(np.max(np.abs(np.asarray(to_host(a), np.float64) - np.asarray(to_host(b), np.float64))))


def _train_inputs(batch: int, n: int, fps: float):
    """Check 1's inputs (``__graft_entry__``'s): rolled sines, features and
    labels from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    t = np.linspace(0, n / fps, n)
    base = (0.5 * (1 + np.sin(2 * np.pi * 1.0 * t))).astype(np.float32)
    mouth = np.stack([np.roll(base, 3 * i) for i in range(batch)])
    audio = np.stack([np.roll(base, 3 * i + 1) for i in range(batch)])
    other = rng.rand(batch, 8).astype(np.float32)
    labels = (rng.rand(batch) > 0.5).astype(np.float32)
    return mouth, audio, other, labels


def _train_step_reference(mouth, audio, other, labels, w, b, fps, lr=0.005):
    """Check 1's step on one device with the plain lip-sync stage."""
    from fvd_tpu_torch.ops.lipsync import lip_sync_score_batch_plain

    lip = lip_sync_score_batch_plain(torch.from_numpy(mouth), torch.from_numpy(audio), fps).score.numpy()
    feats = np.concatenate([other[:, :2], lip[:, None], other[:, 2:]], axis=1).astype(np.float64)
    z = feats @ w + b
    p = 1 / (1 + np.exp(-z))
    err = p - labels
    loss = np.mean(np.maximum(z, 0) - z * labels + np.log1p(np.exp(-np.abs(z))))
    return {"w": w - lr * feats.T @ err / len(labels), "b": b - lr * err.mean(), "probs": p, "loss": loss}


def _dryrun_ranks(n: int, checkpoint_dir: str):
    """Checks 1, 3, 3b, 4 and 5 on every rank; rank 0 also runs each
    reference on its own device and returns ``{check: {...}}`` (the others
    return ``None``)."""
    from fvd_tpu_torch.models.asr import AsrEncoder
    from fvd_tpu_torch.models.encoders import MAX_TEXT_LEN, TextTower
    from fvd_tpu_torch.models.transformer import ByteTokenizer
    from fvd_tpu_torch.parallel import experts, programs
    from fvd_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    lead = torch.distributed.get_rank() == 0
    out: Dict[str, dict] = {}

    # ---- check 1: the fused train step (DP all-reduce + SP halo exchange)
    n_time = 2 if n % 2 == 0 and n > 1 else 1
    n_data = n // n_time
    fps, chunk = 10.0, 75
    steps_n, batch = chunk * n_time, 2 * n_data
    mouth, audio, other, labels = _train_inputs(batch, steps_n, fps)
    w0, b0 = np.zeros(9, np.float32), np.float32(0.0)
    (step,), ms = _timed(dev, programs.multichip_train, n_data, n_time, batch, fps, mouth, audio, other, labels,
                         w0, b0, 1)
    if lead:
        ref = _train_step_reference(mouth, audio, other, labels, w0.astype(np.float64), 0.0, fps)
        out["train"] = {"mesh": f"{n_data}x{n_time}", "batch": batch, "n": steps_n, "loss": float(step["loss"]),
                        "delta": max(_max_delta(step[k], ref[k]) for k in ref), "ms": ms}

    # ---- check 3: TP at the shipped text encoder's geometry
    if n >= 2:
        with open(os.path.join(checkpoint_dir, "text_encoder.json")) as f:
            cfg = json.load(f)
        tower = TextTower(dim=cfg["dim"], depth=cfg["depth"], out_dim=cfg["out_dim"])
        state = weights_mod.to_state_dict(weights_mod.read_npz(os.path.join(checkpoint_dir, "text_encoder.npz")))
        tok = ByteTokenizer()
        ids = np.stack([tok.encode(t, MAX_TEXT_LEN) for t in ["the river rose two feet", "taxes will be cut"]])
        got, ms = _timed(dev, programs.tp_text_tower, 2, {k: v.numpy() for k, v in state.items()}, cfg["dim"],
                         cfg["depth"], cfg["out_dim"], ids)
        if lead:
            tower.load_state_dict(state)
            with torch.no_grad():
                ref = tower.to(dev)(torch.from_numpy(ids).to(dev)).cpu().numpy()
            out["tp"] = {"geometry": f"shipped text_encoder.npz dim={cfg['dim']}", "delta": _max_delta(got, ref),
                         "scale": float(np.abs(ref).max()), "ms": ms}

    # ---- check 3b: TP 2 and 4 at the Whisper-base geometry
    mel = np.random.RandomState(6).randn(2, 128, 80).astype(np.float32)
    for tp in (2, 4):
        if n < tp:
            continue
        got, ms = _timed(dev, programs.tp_asr_encoder, tp, 8, 512, 6, 8, mel)
        if lead:
            enc = AsrEncoder(dim=512, depth=6, heads=8)
            enc.load_state_dict(weights_mod.seeded_state_dict(enc, 8))
            with torch.no_grad():
                ref = enc.to(dev)(torch.from_numpy(mel).to(dev)).cpu().numpy()
            out[f"tp_whisper{tp}"] = {"delta": _max_delta(got, ref), "scale": float(np.abs(ref).max()), "ms": ms}

    # ---- check 4: the 4-stage GPipe ring, and one training step
    if n >= 4:
        S, M, B, D = 4, 6, 4, 16
        prng = np.random.RandomState(3)
        layers = [((prng.randn(D, D) * 0.3).astype(np.float32), (prng.randn(D) * 0.1).astype(np.float32))
                  for _ in range(S)]
        xs = prng.randn(M, B, D).astype(np.float32)
        tgt = prng.randn(M, B, D).astype(np.float32)
        got, ms = _timed(dev, programs.pp_residual_stack, layers, xs, tgt)
        if lead:
            ref = torch.from_numpy(xs).to(dev)
            for w, b in layers:
                ref = ref + torch.tanh(ref @ torch.from_numpy(w).to(dev) + torch.from_numpy(b).to(dev))
            out["pp"] = {"delta": _max_delta(got["out"], ref.cpu().numpy()), "loss0": float(got["loss0"]),
                         "loss1": float(got["loss1"]), "ms": ms}

    # ---- check 5: the 4-way EP MoE against the dense oracle
    if n >= 4:
        params = experts.init_moe_params(np.random.RandomState(5), 4, 16, 64)
        tokens = np.random.RandomState(4).randn(32, 16).astype(np.float32)
        got, ms = _timed(dev, programs.moe, 4, {k: v.numpy() for k, v in params.items()}, tokens)
        if lead:
            ref = experts.moe_forward_dense({k: v.to(dev) for k, v in params.items()},
                                            torch.from_numpy(tokens).to(dev)).cpu().numpy()
            out["ep"] = {"delta": _max_delta(got["out"], ref), "ms": ms}
    return out if lead else None


def _sharded_inference_check(mesh, dev, n: int, checkpoint_dir: str) -> dict:
    """Check 2: the shipped SSD and hourglass in float32 on ``2 n`` frames and
    crops, split over ``mesh`` against one device."""
    from fvd_tpu_torch.parallel.inference import set_inference_mesh, shard_for_inference

    ssd, lmk = load_models(dev, checkpoint_dir)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 255, size=(2 * n, 96, 96, 3), dtype=np.uint8)).to(dev)
    crops = torch.from_numpy(rng.rand(2 * n, landmarks_fan.CROP_SIZE, landmarks_fan.CROP_SIZE, 3)
                             .astype(np.float32)).to(dev)
    detect = functools.partial(face_ssd.detect_batch, compute_dtype=torch.float32, max_out=8)
    marks = functools.partial(landmarks_fan._landmarks_of_crops, compute_dtype=torch.float32)

    @torch.no_grad()
    def run():
        boxes, scores = shard_for_inference(detect, ssd, frames)
        return boxes, scores, shard_for_inference(marks, lmk, crops)

    ref = [t.cpu().numpy() for t in run()]
    prev = set_inference_mesh(mesh)
    try:
        sharded, ms = _timed(dev, run)
    finally:
        set_inference_mesh(prev)
    deltas = {k: _max_delta(a, b.cpu().numpy()) for k, a, b in zip(("boxes", "scores", "coords"), ref, sharded)}
    if max(deltas.values()) >= SHARDED_TOL:
        raise AssertionError(f"sharded != single-device: {deltas}")
    return {"ways": mesh.shape["data"], **deltas, "ms": ms}


def _fan_check(devices, dev) -> dict:
    """Check 3c: the FAN geometry (4 stacks, 256 features, 256 px crops) with
    seeded weights, 2 crops over a 2-way mesh against one device."""
    from fvd_tpu_torch.parallel.inference import set_inference_mesh, shard_for_inference
    from fvd_tpu_torch.parallel.mesh import make_mesh

    fan = landmarks_fan.FANLandmarkNet()
    fan.load_state_dict(weights_mod.seeded_state_dict(fan, 9))
    fan = fan.eval().to(dev)
    size = landmarks_fan.FAN_CROP_SIZE
    crops = torch.from_numpy(np.random.RandomState(9).rand(2, size, size, 3).astype(np.float32)).to(dev)

    @torch.no_grad()
    def fwd(model, c):
        return landmarks_fan.decode_heatmaps(model(c))

    ref = shard_for_inference(fwd, fan, crops).cpu().numpy()
    prev = set_inference_mesh(make_mesh(n_data=2, n_time=1, devices=devices[:2]))
    try:
        got, ms = _timed(dev, shard_for_inference, fwd, fan, crops)
    finally:
        set_inference_mesh(prev)
    delta = _max_delta(got.cpu().numpy(), ref)
    if delta >= SHARDED_TOL:
        raise AssertionError(f"FAN-geometry DP != replicated: {delta}")
    return {"delta": delta, "ms": ms}


def _full_dag_check(mesh, dev, checkpoint_dir: str) -> dict:
    """Check 6: the 16 nodes with the coalescer and the recorded services on
    one clip, without and with ``mesh`` as the inference mesh."""
    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.parallel.inference import set_inference_mesh
    from fvd_tpu_torch.providers.coalesce import coalesce_providers
    from fvd_tpu_torch.providers.factory import asr_speech_domain, production_providers
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import make_face_video

    speech = "formant_gated" if asr_speech_domain(checkpoint_dir) == "formant" else "tone"
    with tempfile.TemporaryDirectory(prefix="fvd_dryrun_dag_") as root:
        video = make_face_video(os.path.join(root, "media"), name="dagcheck", duration=6.0, fps=10.0, width=320,
                                height=240, seed=7, speech_text="the river level rose two feet", speech=speech)
        cfg = default_config()
        cfg = cfg.replace(
            ingest=dataclasses.replace(cfg.ingest, processed_dir=os.path.join(root, "processed")),
            fusion=dataclasses.replace(cfg.fusion, weights_path=os.path.join(root, "lr_weights.json"),
                                       features_dir=os.path.join(root, "features")),
            evidence=dataclasses.replace(cfg.evidence, rate_limit_s=0.0, max_workers=2))

        def run_dag(m):
            prev = set_inference_mesh(m)
            provs, close = coalesce_providers(production_providers(checkpoint_dir, device=dev,
                                                                   recorded_services=True))
            try:
                final = Scheduler(build_graph(cfg, provs, device=dev)).invoke(State(input_path=video))
                return float(final.fake_probability)
            finally:
                close()
                set_inference_mesh(prev)

        p_single, ms_single = _timed(dev, run_dag, None)
        p_mesh, ms = _timed(dev, run_dag, mesh)
    delta = abs(p_single - p_mesh)
    if delta > DAG_TOL:
        raise AssertionError(f"full-DAG mesh run != single-device: {p_single} vs {p_mesh}")
    return {"ways": mesh.shape["data"], "p_single": p_single, "p_mesh": p_mesh, "delta": delta, "ms": ms,
            "ms_single": ms_single}


def dryrun_multichip(n_devices: int, device=None, checkpoint_dir: str = CHECKPOINT_DIR) -> dict:
    """The parallel layer's six checks (``__graft_entry__.dryrun_multichip``)
    on ``device`` (default the card), at the same conditions and bars:

    1. the fused DP x SP train step on a ``data x time`` mesh (loss log 2 at
       w = 0), against one device;
    2. the shipped SSD and hourglass, ``n``-way sharded inference;
    3. TP 2 at the shipped text encoder's geometry (n >= 2);
    3b. TP 2 and 4 at the Whisper-base geometry (d512, 6 layers, 8 heads);
    3c. 2-way DP at the FAN geometry (n >= 2);
    4. a 4-stage PP ring that also trains (n >= 4);
    5. a 4-way EP MoE against the dense oracle (n >= 4);
    6. the full 16-node DAG with the coalescer and the recorded services
       under the ``n``-way inference mesh, against one device.

    Checks 1, 3, 3b, 4 and 5 run on ``n`` ranks of one process group, rank
    ``r`` on ``cuda:(r % cards)`` (or the CPU); 2, 3c and 6 in this process
    over an inference mesh of the same ``n`` devices.  The backend is NCCL
    where each rank has a card of its own and gloo otherwise (the CPU, or
    ranks that share a card, which NCCL refuses).  Prints one
    ``dryrun_multichip OK: ...`` line and returns each check's numbers; a
    failed check raises."""
    from fvd_tpu_torch.parallel.launch import RankGroup
    from fvd_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [f"cuda:{r % cards}" for r in range(n_devices)]
        backend = "nccl" if n_devices <= cards else "gloo"
    else:
        devices = ["cpu"] * n_devices
        backend = "gloo"
    dev = torch.device(devices[0])
    with tempfile.TemporaryDirectory(prefix="fvd_dryrun_store_") as store:
        with RankGroup(n_devices, backend, devices, store, timeout=600.0) as group:
            checks = group.run(_dryrun_ranks, n_devices, checkpoint_dir)[0]
    if abs(checks["train"]["loss"] - LOG2) > 1e-5 or checks["train"]["delta"] > 1e-5:
        raise AssertionError(f"train step: {checks['train']} (loss must be log 2 = {LOG2})")
    for k in [k for k in checks if k.startswith("tp")]:
        if checks[k]["delta"] >= TP_TOL * max(1.0, checks[k]["scale"]):
            raise AssertionError(f"TP forward != replicated: {k} {checks[k]}")
    if "pp" in checks and (checks["pp"]["delta"] >= PP_EP_TOL or checks["pp"]["loss1"] >= checks["pp"]["loss0"]):
        raise AssertionError(f"PP: {checks['pp']}")
    if "ep" in checks and checks["ep"]["delta"] >= PP_EP_TOL:
        raise AssertionError(f"EP forward != dense: {checks['ep']}")

    mesh = make_mesh(n_data=n_devices, n_time=1, devices=devices)
    checks["sharded"] = _sharded_inference_check(mesh, dev, n_devices, checkpoint_dir)
    if n_devices >= 2:
        checks["fan"] = _fan_check(devices, dev)
    checks["dag"] = _full_dag_check(mesh, dev, checkpoint_dir)

    tr, sh, dag = checks["train"], checks["sharded"], checks["dag"]
    msg = (f"dryrun_multichip OK: mesh=({tr['mesh']}) platform={dev.type} backend={backend} "
           f"devices={','.join(devices)} | train step: batch={tr['batch']} n={tr['n']} loss={tr['loss']:.4f} "
           f"(DP all_reduce + SP ppermute halo) max|delta|={tr['delta']:.2e} | sharded inference "
           f"(SSD+hourglass, {sh['ways']}-way DP): max|delta| boxes={sh['boxes']:.2e} scores={sh['scores']:.2e} "
           f"coords={sh['coords']:.2e}")
    if "tp" in checks:
        msg += f" | TP transformer (2-way heads+MLP, {checks['tp']['geometry']}): max|delta|={checks['tp']['delta']:.2e}"
    wb = [f"tp{tp} max|delta|={checks[f'tp_whisper{tp}']['delta']:.2e}" for tp in (2, 4)
          if f"tp_whisper{tp}" in checks]
    if wb:
        msg += " | TP whisper-base-geometry encoder (d512 6L 8heads ffn2048): " + ", ".join(wb)
    if "fan" in checks:
        msg += (" | DP FAN-geometry landmark net (4-stack 256-feat hourglass @256px) 2-way: "
                f"max|delta|={checks['fan']['delta']:.2e}")
    if "pp" in checks:
        msg += (f" | PP layer stack (4-stage GPipe ring): max|delta|={checks['pp']['delta']:.2e}, "
                f"train loss {checks['pp']['loss0']:.4f} -> {checks['pp']['loss1']:.4f}")
    if "ep" in checks:
        msg += f" | EP MoE FFN (4-way experts): max|delta|={checks['ep']['delta']:.2e}"
    msg += (f" | FULL 16-node DAG under {dag['ways']}-way DP mesh + coalescer: p={dag['p_mesh']:.6f} vs "
            f"single-device p={dag['p_single']:.6f}, |delta|={dag['delta']:.2e}")
    print(msg, flush=True)
    return {"backend": backend, "devices": devices, "checks": checks}


if __name__ == "__main__":
    fn, args = entry()
    prob, lip = fn(*args)
    print({"fake_probability": float(prob), "lip_sync_score": float(lip)})
