#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fvd_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds before the next starts:

1. env       card name and power limit, torch and CUDA versions, the MiB of
             the copy the run started from and which HF msgpacks it holds;
2. build     nvcc builds every CUDA kernel of the main path, all at once;
3. kernel    the C1 stage kernel against its plain PyTorch version, both on
             the card from the same raw signals, at the shapes of
             ``fvd_tpu_torch.c1_timing.SHAPES``; per shape the time a caller
             pays (``ms``, CUDA events, median of 50 rounds after warm-up,
             interleaved with the plain version's ``plain_ms`` and one PyTorch
             library call's ``library_ms``), the kernel alone (``device_ms``,
             CUDA graph replay), the device ops one call dispatches
             (``stage_ops``), and the stage's bound;
4. models    the production bundle's four npz models at their shipped
             checkpoints (``providers/factory.py`` on the checkpoints less
             ``hf/``: the formant ASR and the tone ASR, the v2 OCR on its
             device and host paths, the CLIP, the text encoder), card f32
             against CPU f32 on the same inputs: tokens, OCR texts and masks,
             similarities and unit embeddings; per model the ms per call (CUDA
             events, median of 20), the profiler's kernels per call and the
             largest |d|;
5. hf        the HF lineup of ``checkpoints/hf`` (``providers/hf_models.py``),
             card f32 against CPU f32: MiniLM-L6 on its real weights (64
             sentences, the embeddings' largest |d|), Whisper base on its
             real weights (one 30 s window of 1 clip, with formant speech,
             a cut of the 4 that keeps the script's time; 2 until the
             hf_train phase, random audio the other: tokens equal up to the CPU's first
             step whose top-2 logit margin is under ``HF_MARGIN``, that
             step reported, the
             teacher-forced logits' largest |d| on the CPU's tokens, encoder
             ms, decode steps, ms and kernels per step), CLIP ViT-B/32 at its
             ``config.json``'s geometry with seeded weights (the copy leaves
             its msgpack out; one clip's 10 keyframe/caption pairs, the calibrated
             similarities' largest |d|); ms and kernels per call of each;
6. analyzer  the fused per-video analyzer (``fvd_tpu_torch.entry``) at full
             width on the shipped checkpoints, bf16, against the port's own
             f32 path and against the JAX package's f32 result; one C1 launch
             per call; the time of each stage of a call, and the profiler's
             top kernels by device time;
7. serving   ``ScoringService`` answers 64 concurrent requests, each checked
             against per-request scoring on the CPU; one C1 launch per
             micro-batch;
8. dag       the {C1 -> LR} tail of the DAG on the port's ``Scheduler``, one
             ``invoke`` per video, for 16 videos of 60 s and one of 10 min at
             30 fps: all at once under the program coalescer (one C1 launch
             per coalesced group, at least one group of several videos), then
             one at a time (one launch per video); every video's
             ``lip_sync_score`` and ``fake_probability`` against the same
             states run on the CPU; group sizes, wall time per video and the
             tracer's node and group spans;
9. video     the DAG's lip-sync path from a video file, IN -> A1 -> A3,
             IN -> V1 -> V3, {A3, V3} -> C1 -> LR, on the port's ``Scheduler``
             with the shipped checkpoints, for 4 clips of 10 s at 30 fps and
             240x320 made by ``fvd_tpu_torch.synthetic.make_face_video`` with
             44.1 kHz audio (two in sync, one with a dubbed mouth, one with
             random audio), written as raw-RGBA AVI: on the card in bf16 and in
             f32, each clip alone and then all 4 at once under the program
             coalescer, and on the CPU in f32 each clip alone (its coalesced
             run went in the levers phase's cut).  Checks the card's f32 runs
             against the CPU's, the faces and mouth landmarks found, the in-sync clips
             scoring above the broken ones, one C1 launch per video alone and
             one per coalesced C1 group, one frame upload per video, and the
             AVI round trip; prints wall times, node and ``v3/*`` span
             medians, PNG seconds, the OneEuro scan's time and a
             ``torch.profiler`` view of one video;
10. full_dag all 16 nodes of ``fvd_tpu_torch.graph.build_graph`` on the
             first 2 of those clips (the two in sync; all 4 until the h264
             phase), with ``pose.npz`` and a hermetic bundle (ScriptedASR,
             ScriptedLLM, StaticSearch with fixed content, NullOCR, StubClip):
             card bf16 and card f32 one video at a time, card bf16 with both
             at once under the program coalescer, and CPU f32 on one of the
             clips (the one in sync: a cut that keeps the script's time with
             the batch phase; the dubbed one too until the hf_train phase).  Checks all 16
             nodes done, card f32 against CPU f32 on the 9 LR features and the
             probability, one C1 launch per video (per C1 group when
             coalesced), one frame upload per video, one shared landmark
             forward per chunk for V3 and V4, and V4's pose samples; prints
             every node's span median, the ``v4/*`` spans, wall time per video,
             the card's busy share over one profiled video, and the landmark
             forward's time without and with V4's fused pose program.  Then
             the same runs with the ``zoo`` bundle, the production bundle's
             models with the scripted LLM and search, on the clips with
             tone-coded speech: card f32 against CPU f32 within 1e-5 on the
             features and 1e-6 on the probability, the same transcript
             segments, OCR texts, gesture statuses and evidence ranking.
             Last the ``hf`` bundle, the production bundle on the checkpoint
             tree as shipped (the HF text encoder and Whisper; the npz CLIP
             where the copy left the HF CLIP's msgpack out, as the JAX
             package's factory would pick: checked), on clips with formant
             speech: card f32 one at a time (the batch phase runs this
             bundle 8 at once), CPU f32, the zoo bundle's bars;
11. batch    ``bench.py``'s real-models mode on the port: 8 clips of 10 s
             (bench's are 30 s: the one cut) at 30 fps and 320x240 from
             ``make_face_video`` (seeds 0-7, bench's eight sentences as the
             speech the ASR checkpoint names, the odd seeds' mouths dubbed
             and named ``fake_*``), raw-RGBA AVI named ``*.mp4``, through
             ``batch.run_pipeline_many`` with
             ``production_providers(recorded_services=True)`` (the bundle
             as the checkout ships it).  (a) card f32 8 at once, (b) card
             f32 one at a time, (c) CPU f32 on 1 clip, (d) card bf16 on 2
             clips 8 at a time with and without ``FVD_TPU_NO_COALESCE``,
             each under ``torch.profiler`` (the timed 8-clip passes of both
             went in the levers phase's cut), (e) ``python -m
             fvd_tpu_torch.batch --concurrency 8`` and then
             ``--train-device`` as subprocesses on 2 of the clips.  Checks all 16 nodes on
             every video, (a) against (b) and (b) against (c) (features
             1e-4, probability 1e-5, the same transcripts, OCR texts,
             gesture statuses, V5 recorded scores and evidence rankings),
             one C1 launch per video in (b) and per C1 group in (a), a
             detector or landmark group holding two videos, synced clips'
             lip-sync above the dubbed, an 8-row results table and the
             device-trained weights against the host replay (1e-6); prints
             videos/min, wall ms a video, kernels a video and the
             wrappers' groups and padded sizes; since the codec phase the
             clips are ``mp4v`` (their VOPs parsed on the card), since
             the aac phase each carries its speech as its own AAC-LC track
             and no sibling wav (one ``aac_synth`` and one
             ``audio_resample`` launch a video in (a) and (b)), and (a)
             prints each video's decode and AAC seconds, the detector
             groups' starts and spread and ``mpeg4_parse``'s launches;
12. stream   progressive analysis (``fvd_tpu_torch.streaming``) of two
             clips of the batch corpus at 20 s (bench.py's 30 s until the
             hf_train phase; seed 0 in sync,
             seed 1 dubbed) with the production bundle's detector and
             hourglass: card bf16 and card f32 at 5 s and 2 s chunks, CPU f32
             at 5 s on the synced clip, and ``python -m fvd_tpu_torch.cli
             <clip> --stream --chunk-seconds 5`` as a subprocess.  Checks the
             updates (4 and 10, fraction rising to 1, 100 mouth samples at the
             end), one C1 launch per update and one landmark forward per
             chunk, card f32 against CPU f32 update by update and 2 s against
             5 s chunks at the end (lip_sync, blink_rate, fake_probability
             within ``STREAM_TOL``), synced above dubbed, and the CLI's last
             line against the in-process card bf16 run; prints per run the
             time to the first update, ms per update, wall ms, seconds of
             video per wall second, C1 launches and forwards per chunk, and
             a ``torch.profiler`` view of the synced clip at 5 s (bf16);
13. ui       ``ui.web.serve_web`` on the card in a thread, with the production
             bundle in f32 and the recorded LLM and search, on one 10 s clip
             of the batch corpus: ``POST /analyze`` (all 16 nodes done, one C1
             launch, ``fake_probability`` against a direct ``Scheduler`` run
             within ``UI_PROB_TOL``), ``/artifact`` on a keyframe (a PNG) and
             on ``/etc/passwd`` (403), ``POST /analyze?stream=true&chunk=5`` (2
             updates, two launches, the final p against
             ``analyze_progressive``'s), and ``python -m fvd_tpu_torch.cli
             --frontend-term`` with the path on stdin; prints the DAG's wall ms
             through the server and directly;
14. cli      ``python -m fvd_tpu_torch.cli <clip.avi>`` as a subprocess on the
             card, then again with label 1: rc 0, a last line
             ``Fake probability: p`` with 0 <= p <= 1, C2 scoring with the
             bundle's CLIP, a ``providers:`` line naming the HF text encoder
             and Whisper, one naming ``NullLLM`` and the search chain (no key
             reaches the subprocess, so E1 has no claims to search), and the
             weights file written by the labelled run; prints the cold-start
             seconds;
15. parallel the parallel layer (``fvd_tpu_torch.parallel``) through
             ``entry.dryrun_multichip``: ``dryrun_multichip(1)``, one rank on
             the card under NCCL, then ``dryrun_multichip(4)``, four ranks
             that share the card under gloo (NCCL refuses two ranks on one
             device) and an in-process inference mesh of four entries of the
             card.  Each holds its checks to the JAX package's bars (train
             step, sharded SSD + hourglass, TP at the text encoder's and
             Whisper base's geometry, FAN-geometry DP, the PP ring, the EP
             MoE, the full DAG under the mesh against one device) and
             launches C1 once per DAG run (2); prints each check's delta,
             ms, backend and devices.  A run across several cards needs a
             machine with several and is not made here;
16. train    the vision trainers of ``python -m
             fvd_tpu_torch.tools.pretrain_synthetic`` at full width (the SSD,
             the hourglass and the pose head at width 32, batch 16): (a) three
             Adam steps of each, and one ``pose_consistency_loss`` step, on
             the card and on the CPU from the same seeded weights and the
             port's batches (seeds 0-2), in float32 (TF32 off; the first
             step's loss) and float64 (every step's loss, the first step's
             gradients and the last parameters per tensor); (b) the tool in
             a subprocess on the card (the one trainer still run so, its
             ``python -m`` entry as a user runs it), ``--steps 8
             --consistency`` (15 until the h264 phase), then in this process ``--only det --resume
             --steps 5`` (10 until the h264 phase), which must
             continue from step 8: per trainer the median host data ms and device ms of a
             step (CUDA events), images/s, the first and last loss (the last
             must be lower) and the eval metric; (c) the npz files it wrote
             served by ``SSDFaceDetector`` and ``FANLandmarks`` (with the
             pose head) on the card; (d) the tool in this process with the
             realism levers, ``--dense --photometric --shading --portrait
             --augment --steps 1`` (3 until the h264 phase), writing its
             checkpoints.  Training
             launches no kernel of the repo's;
17. net      the production bundle with ``use_llm=True, use_search=True``:
             ``OpenAILLM`` and the cached Serper -> Google CSE -> DuckDuckGo
             chain, their endpoints, ``OPENAI_BASE_URL`` and dummy keys
             pointed at a loopback server of fixed payloads
             (``providers/loopback.py``; the search cache in a temporary
             directory), through the 16 nodes on the card on a 10 s clip,
             twice (the second run's searches all hit the disk cache), against
             the same bundle with the scripted LLM and search that answer as
             the payloads do (run once before, as a warm-up, and once after):
             the same claims, evidence, reliability scores and texture score,
             |dp| within ``NET_PROB_TOL``, one C1 launch a run; prints the requests the server received and the ms the
             keyless chain takes to come back empty when DuckDuckGo's
             connection is refused on loopback.  No process of this script
             contacts a host outside the machine: its subprocesses run
             without the services' keys;
18. zoo_train the ASR and text-encoder trainers (``python -m
             fvd_tpu_torch.tools.pretrain_asr``, ``pretrain_text_encoder``)
             and the zoo's losses at the shipped geometries: (a) three Adam
             steps each of ``asr_loss`` (dim 192, depth 4, batch 16,
             ``formant_hard``), the text InfoNCE (192 / 4 / 256, batch 64),
             ``clip_loss`` (``clip.npz``, batch 32) and ``ctc_loss``
             (``ocr_rec.npz``, batch 32), card against CPU in float32 and
             float64 as in ``train``; (b) each tool's ``main`` for 25 steps
             on the card in this process under torch's TF32 defaults (in
             subprocesses until the eval phase), then ``pretrain_asr
             --resume --steps 10``: the summaries' data and device ms a step, items/s, losses
             and evals; (c) the npz files served by ``JaxASR`` and
             ``JaxTextEncoder`` on the card;
19. corpus   the labeled-corpus experiment (``python -m
             fvd_tpu_torch.tools.{make_labeled_corpus,accuracy_trajectory,
             calibrate_lr}``): (a) ``build_corpus`` draws 2 real, 2 fake, 1
             ambiguous and 1 hard-real clip of 3 s (10 s until the h264
             phase) at 30 fps and 320x240 with OpenCV's shapes (the labels
             the names encode are checked); (b) ``accuracy_trajectory.main`` in process on them
             with the shipped bundle in bf16 and the recorded services, a
             baseline run and 3 ``--train`` runs: the order the harness
             takes the clips in (online SGD depends on it: ``get_videos``
             sorts by duration, so equal clips keep the directory's glob
             order), per run the accuracy, the SGD attempts, the seconds and
             every clip's probability (each results table scores every clip
             in that order), run 0's features, at least one C1 launch per
             clip; (c) a
             ``texture_noise`` fake and a hard real of 2 s (5 until the h264
             phase) through the 16 nodes, card f32 against CPU f32 at the
             batch phase's bars; (d) ``calibrate_lr.main`` on 1 real, 2
             fakes and 1 hard real of 2 s (5 until the h264 phase)
             for training and again for validation: the accuracies, the
             vector (its sign constraints hold), one C1 launch per clip, and
             ``--refit-from-meta`` giving the same vector exactly;
20. text     the OCR and CLIP trainers and the held-out evaluation: (a) a
             batch of 32 recognizer lines and detector scenes drawn on the
             host; (b) three Adam steps of the recognizer, the v2 detector
             and CLIP, card against CPU in float64; (c) ``pretrain_ocr`` and
             ``pretrain_clip``, then ``pretrain_ocr --only rec --resume``;
             (d) ``eval_heldout`` over the five shipped models, its OCR
             columns against the CPU; (c) and (d) through the tools'
             ``main`` in this process under torch's TF32 defaults
             (subprocesses until the eval phase);
21. fan      the reference-scale FAN trainer and ``PoseResNet50``: (a) the
             host ms to draw one batch of 16 of ``detector_batch`` with
             ``dense`` and every realism lever at 300 px and of
             ``pretrain_fan``'s ``landmark_batch`` at 256 px; (b) three steps
             of ``pretrain_fan``'s loss and clipped AdamW (width 32, 2
             stacks, the tool's 256-px crops), card against CPU in float64;
             (c) ``pretrain_fan.main`` at the full geometry (width 256, 4
             stacks, batch 16, bfloat16 on float32 parameters) from seeded
             weights for ``FAN_CLI_STEPS`` steps and its paired evaluation
             against ``checkpoints/landmarks.npz``: the summary's data and
             device ms a step, crops/s, losses and both errors, and a
             ``torch.profiler`` view of one step (top kernels); (d)
             ``PoseResNet50`` at 224 px: ms a call at batch 16 in bfloat16
             and float32, card f32 against CPU f32 on 4 crops, card bf16
             against card f32.  The FAN trainer launches no kernel of the
             repo's;
22. hf_train the HF trainers: (a) three steps of each tool's loss and
             clipped AdamW at small geometries (BERT 2 x 64, CLIP
             ``--tiny``, Whisper d64 2 + 2 with vocab 600), card against
             CPU in float64, and the decay of BERT's pooler and Whisper's
             frozen encoder positions against optax's product; (b)
             ``pretrain_hf_minilm`` (batch 96) and ``pretrain_hf_whisper``
             (batch 8, ``--pool`` 128) resumed from copies of
             ``checkpoints/hf``, ``pretrain_hf_clip`` (batch 128, ``--pool``
             256) from the port's maker at ViT-B/32, each for
             ``HF_TRAIN_STEPS`` steps in this process with its final
             evaluation: the summary's data and device ms a step, items/s,
             losses and evaluation, the written msgpack read back equal to
             the trained parameters, ``--promote``'s copy, the loss over the
             run's batches lower after than before, and the provider
             loading the files; (c) the shipped MiniLM's and Whisper's
             held-out evaluation before any step, card f32 against CPU f32.
             The HF trainers launch no kernel of the repo's;
23. eval     the paired adoption gates and the diagnostic tools of
             ``fvd_tpu_torch.tools``, each through its ``main`` in this
             process on the card: (a) ``eval_asr_paired --n 16`` on
             ``asr_formant.npz`` against a copy of itself (both sides decode
             alike, REJECT); (b) ``eval_text_paired`` on the shipped MiniLM
             against ``text_encoder.npz`` (32 tasks, 1 round), card against
             CPU; (c) ``eval_clip_paired --n 8`` against a ViT-B/32 from
             ``make_hf_geometry_checkpoints`` (random weights, written to a
             temporary directory; the trained ``clip.npz`` must keep the
             gate); (d) ``eval_asr_whisper_paired`` on the shipped Whisper
             (16 utterances, 2 sentences); (e) ``eval_pipeline_paired
             --override face_ssd.npz=<copy> --duration 4``: the contract
             holds, one C1 launch per DAG run (4), the same lip separation on
             both sides; (f)-(g) ``diagnose_det_heldout`` and
             ``diagnose_lmkpose_heldout`` at ``--n 16``, then every row card
             f32 (TF32 off) against CPU f32 within ``DIAGNOSE_TOL``; (h)
             ``profile_pipeline`` hermetic on a 10 s clip at 30 fps with
             ``--trace``: a row per node (16), a Chrome trace with the 16
             node spans and the card's kernels, 2 C1 launches; (i) a debug
             run of the 16 nodes, then ``repro_node C1`` and ``LR`` on its
             directory, equal to its values (2 C1 launches); (j)
             ``render_dag_svg`` equal to ``docs/dag.svg``.  Paid for by cuts
             in ``zoo_train``, ``text`` and ``hf`` (PERF.md §4);
24. levers   the chained detector -> landmarks -> pose program, the A/B
             switches and ``tools/ab_bench``: (a) on clip 0 of the batch
             corpus at 10 s, its 50 frames at 5 fps, the shipped detector,
             hourglass and pose head in f32 and bf16: the unchained and the
             chained (``FVD_TPU_FUSED_DETLM``) ``landmarks_pose_batch`` find
             the same faces, f32 landmarks within ``LEVERS_LM_TOL`` (crop
             units) and poses within ``LEVERS_POSE_TOL``, the chained
             program card f32 against CPU f32 on the first frames, ms a call
             of each path (CUDA events, interleaved) and its device-to-host
             copies a call (one ``torch.profiler`` pass; the chained path
             must make one); (b) clips 0 and 1 through the 16 nodes 2 at
             once on ``production_providers(recorded_services=True)`` in
             f32, each switch off and then on alone:
             ``fake_probability`` equal under ``FVD_TPU_NO_ARTIFACT_CACHE``
             and ``FVD_TPU_NO_STACK_MEMO``, within ``LEVERS_PROB_TOL`` under
             ``FVD_TPU_NO_FUSED_POSE``, ``FVD_TPU_NO_DEVICE_OCR`` and
             ``FVD_TPU_FUSED_DETLM``, one C1 launch per C1 group, and every
             coalesced smoothing group's videos bit-equal to their plain
             scans (group sizes printed); (c) ``python -m
             fvd_tpu_torch.tools.ab_bench FVD_TPU_FUSED_DETLM=1 --passes 4
             --n-videos 2 --duration 10 --concurrency 2`` in a fresh
             interpreter, its JSON line.  Paid for by cuts in ``batch``
             (PERF.md §4).

25. codec    (runs right after ``kernel``) MPEG-4 Part 2 in MP4: corpus
             clips 0 and 1 encoded with ``write_mp4v`` and decoded with
             ``NativeVideo`` on the card, the three codec kernels against
             their plain versions over two GOPs, ``mpeg4_parse`` against the
             host parser on every VOP of the clips and of three
             known-answer streams (``utils/mpeg4v_ka.py``), their times and
             bounds;
26. h264     (after ``codec``) H.264 in MP4: NVDEC's capabilities; the
             four known-answer streams of ``utils/h264_pcm.py`` (320x240
             I-only, IPBPB over two GOPs with still frames, 320x180 coded
             320x192, planes of 0x00-0x03 samples), every frame's NV12 picture
             through ``nv12_rgb`` against its plain version and the expected
             frame; the counted main path: each stream through
             ``NvdecVideo`` bit for bit, in chunks, from two threads,
             ``nv12_rgb`` on the mapped surfaces, and corpus clip 0 (5 s) as
             H.264 through the lip-sync path against a raw AVI of its frames;
             any NVDEC failure fails, but in a container without NVIDIA's
             video capability, where every cuvid call returns CUresult 2 and
             the first read must raise just that, the main path cannot run;
             IN on an H.264 clip; ``nv12_rgb``'s times and bound;
27. aac      (after ``h264``) AAC-LC audio in MP4: two known-answer tracks
             (``utils/aac_writer.py``; mono 44.1 kHz, stereo 48 kHz)
             through ``media.extract_audio`` on the card (the counted main
             path: ``aac_synth`` and ``audio_resample`` once a track) and
             on the CPU, the WAVs within an int16 step; both kernels against
             their float64 plain versions (1e-6) on those tracks and on a
             5 s clip's own stereo 48 kHz track, their times and bounds, the
             host parse's ms a frame; the CLI on that clip, whose only sound
             is its AAC track: IN's WAV within an int16 step of the CPU's
             decode, and the probability against the same pixels with the
             CPU's decode as a sibling wav (``STREAM_CLI_TOL``).

``--only PHASE[,PHASE]`` runs env, build, kernel and the named phases of
4-27 alone.  Then one JSON line with every kernel's numbers, the card's
name and power limit as nvidia-smi prints them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero; it also exits non-zero, printing no result, where no card is
present.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import glob
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: ``__graft_entry__.entry()``'s analyzer with both backbones in f32
#: (``compute_dtype=jnp.float32``) on its example inputs, run by the JAX package
#: on the CPU; ``tests/test_torch_entry.py`` recomputes and checks these values.
JAX_F32_REFERENCE = {"fake_probability": 0.5049499273300171, "lip_sync_score": 0.04014141112565994}
#: f32 vs f32: rounding in the conv sums moves the chosen box by ~5e-4 px,
#: the landmarks by ~2e-4 and the MAR by ~5e-5; z-normalising a MAR series whose
#: std is ~0.03 magnifies that (measured |d lip| 2.3e-4 between the port on the
#: CPU and JAX on a 4 s clip).
F32_TOL = {"fake_probability": 2e-4, "lip_sync_score": 2e-3}
#: bf16 vs f32, stage by stage on the same inputs.  bf16 keeps 8 mantissa bits:
#: the keyframes' top detection scores moved by 0.0068 on the CPU and 0.0157 on an
#: H100 (cuDNN's bf16 sums), and the landmarks, cropped from the same boxes, by
#: 0.0104 and 0.0099 of the crop.
BF16_STAGE_TOL = {"top_scores": 5e-2, "landmarks_same_boxes": 5e-2}
#: bf16 vs f32 end to end.  On these random frames the SSD's candidates score
#: close together, so bf16 can flip which box NMS keeps first for a keyframe
#: (one of ten moved by 117 px on the CPU) and the lip score of this noise signal,
#: one valid window, moves with it (0.094 on the CPU, 0.014 in the JAX package).
#: fake_probability sees the lip score through w[2] = 0.129 only.
BF16_TOL = {"fake_probability": 1e-2, "lip_sync_score": 3e-1}
#: kernel vs plain version, both float32 on the card from the same raw signals:
#: only the summation order differs (scores and window scores; flags and counts exact)
KERNEL_TOL = 1e-5
#: the dag phase, card against CPU on the same states: ``lip_sync_score`` is the
#: stage kernel against its plain version (``KERNEL_TOL``); ``fake_probability``
#: sees it through |w[lip_sync]| = 0.46 and the sigmoid's slope of at most 1/4
DAG_PROB_TOL = 1e-6
#: the analyzer's stages run one by one against ``fn`` on the same inputs: the
#: same ops in the same order, so only a non-deterministic cuDNN algorithm could
#: move a value
BREAKDOWN_TOL = 1e-5

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores, H100 SXM data sheet

_t_phase = time.perf_counter()
#: the card's name and power limit as nvidia-smi prints them (the env phase)
SMI_LINE = None


def phase(name: str, **fields) -> None:
    global _t_phase
    now = time.perf_counter()
    print(json.dumps({"phase": name, "seconds": round(now - _t_phase, 3), **fields}), flush=True)
    _t_phase = now


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


#: the variables that give the production bundle a networked LLM or search
#: backend: no process of this script may reach a host outside the machine
SERVICE_KEYS = ("OPENAI_API_KEY", "OPENAI_BASE_URL", "SERPER_API_KEY", "GOOGLE_API_KEY", "GOOGLE_CX")


def _subprocess_env():
    """The environment of the port's processes this script starts: the
    checkout on ``PYTHONPATH`` and no key for a networked service."""
    env = {k: v for k, v in os.environ.items() if k not in SERVICE_KEYS}
    env["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    return env


@contextlib.contextmanager
def _env(name, value):
    """``name`` set to ``value`` (removed where None) for the block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


#: cuDNN's and cuBLAS's TF32 flags as torch started, before ``env_phase``
#: turned both off; the tools run in this process get them back
TF32_DEFAULTS = {}


# -------------------------------------------------------------------- phases
def env_phase():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    # the f32 references compare f32 with f32: keep cuDNN and cuBLAS out of TF32
    TF32_DEFAULTS.update(cudnn=torch.backends.cudnn.allow_tf32, matmul=torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import ctypes.util

    hf = os.path.join(REPO, "checkpoints", "hf")
    phase("env", nvidia_smi=smi_line, torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          python=sys.version.split()[0], libavcodec=ctypes.util.find_library("avcodec"),
          nvcuvid=ctypes.util.find_library("nvcuvid"),
          ffmpeg=shutil.which("ffmpeg"), copy_mib=_tree_mib(REPO),
          hf_msgpacks={k: os.path.exists(os.path.join(hf, k, "flax_model.msgpack"))
                       for k in ("minilm", "clip", "whisper")})
    return smi_line


#: what runs add to the tree they start from
_RUN_OUTPUTS = {"build", "__pycache__", ".git", "_archive", ".pytest_cache", ".hypothesis"}


def _tree_mib(root):
    """MiB of the files under ``root``, less what runs write there: the size
    of the checkout this run was given."""
    total = 0
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in _RUN_OUTPUTS]
        total += sum(os.path.getsize(os.path.join(dirpath, f)) for f in files
                     if not os.path.islink(os.path.join(dirpath, f)))
    return total / 2 ** 20


@functools.lru_cache(maxsize=None)
def _npz_checkpoints():
    """A directory of links to every shipped checkpoint but ``hf/``: where
    the production bundle loads the npz model zoo (made once, removed at
    exit)."""
    import atexit

    view = tempfile.mkdtemp(prefix="npz_checkpoints_")
    atexit.register(shutil.rmtree, view, True)
    ckpt = os.path.join(REPO, "checkpoints")
    for name in os.listdir(ckpt):
        if name != "hf":
            os.symlink(os.path.join(ckpt, name), os.path.join(view, name))
    return view


def build_phase():
    """Builds every kernel, one nvcc per source, all started together, and
    binds it; returns each kernel's build seconds."""
    from fvd_tpu_torch import _kernels

    def build(name):
        t0 = time.perf_counter()
        _kernels.build(name)
        return name, time.perf_counter() - t0

    # one kernel of each source file: a file with several kernels builds once
    firsts = {_kernels.SOURCES.get(name, name): name for name in reversed(list(_kernels.SIGNATURES))}
    with ThreadPoolExecutor(len(firsts)) as pool:
        by_source = dict(pool.map(build, firsts.values()))
    build_s = {name: by_source[firsts[_kernels.SOURCES.get(name, name)]] for name in _kernels.SIGNATURES}
    for name in _kernels.SIGNATURES:
        _kernels.load(name)
    phase("build", build_s=build_s, load_s=dict(_kernels.BUILD_SECONDS),
          build_dir=os.path.relpath(_kernels.BUILD_DIR, REPO))
    return build_s


def _stage_bound_ms(batch, n, n_win, window, max_lag):
    """Least time for one C1 stage call: each input read once and each output
    written once at HBM rate, or its float32 operations at the non-tensor-core
    rate, whichever is longer."""
    # in: two [B, N] f32 rows; out: f32 score + i32 n_valid per video, f32 score + u8 flag per window
    bytes_moved = 2 * batch * n * 4 + batch * n_win * (4 + 1) + batch * 8
    # 2 ops per multiply-add over (window, lag) pairs, the two window stds
    # (4 ops/sample/signal), and the two rows' z-normalisation (~5 ops/sample/signal)
    ops = batch * (n_win * (2 * (2 * max_lag + 1) * window + 8 * window) + 10 * n)
    t_bytes, t_ops = bytes_moved / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), bytes_moved, ops


def kernel_phase():
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.c1_timing import (SHAPES, count_device_ops, graph_ms, interleaved_ms,
                                         make_signals)
    from fvd_tpu_torch.ops.lipsync import (_znorm, lip_sync_score_batch,
                                           lip_sync_score_batch_plain, window_params)

    rng = np.random.RandomState(0)
    cases = []
    for case, batch, n, fps, kind in SHAPES:
        mouth, audio = (torch.from_numpy(x).cuda() for x in make_signals(batch, n, fps, kind, rng))
        cases.append((case, fps, kind, mouth, audio))
    # bring the card's clocks up before the first timed case
    _, fps0, _, m0, a0 = cases[0]
    for _ in range(300):
        lip_sync_score_batch_plain(m0, a0, fps0)
    torch.cuda.synchronize()
    rows = []
    for case, fps, kind, m, a in cases:
        k = lip_sync_score_batch(m, a, fps)
        p = lip_sync_score_batch_plain(m, a, fps)
        torch.cuda.synchronize()
        err = max(float((k.score - p.score).abs().max()),
                  float((k.window_scores - p.window_scores).abs().max()))
        check(err <= KERNEL_TOL, f"kernel vs plain at {case}: max |d score| {err} > {KERNEL_TOL}")
        check(bool(torch.equal(k.window_valid, p.window_valid)), f"kernel vs plain at {case}: window_valid differs")
        check(bool(torch.equal(k.n_valid, p.n_valid)), f"kernel vs plain at {case}: n_valid differs")
        check(bool(torch.isfinite(k.score).all()) and bool((k.score >= 0).all()),
              f"kernel at {case}: scores {k.score.tolist()}")
        if kind == "silent":
            check(k.n_valid[:2].tolist() == [0, 0] and k.score[:2].tolist() == [0.0, 0.0]
                  and not bool(k.window_valid[2, 0]),
                  f"silent/static windows must be invalid, got {k.window_valid.tolist()}")
        if kind == "ties":
            check(int(torch.unique(k.window_scores[0]).numel()) == 1 and int(k.n_valid[0]) == k.n_windows,
                  f"the tie row's windows must all score the same, got {k.window_scores[0].tolist()}")

        def stage():
            return lip_sync_score_batch(m, a, fps)

        before = _kernels.LAUNCHES["lipsync_score"]
        ops = count_device_ops(stage)
        launched = _kernels.LAUNCHES["lipsync_score"] - before
        check(not ops and launched == 1,
              f"one stage call at {case} dispatched {dict(ops)} and {launched} launches")

        batch, n = m.shape
        W, step, n_win = window_params(n, fps)
        L = int(fps * 0.5)
        a_lag = torch.nn.functional.pad(_znorm(a).unfold(-1, W, step)[:, :n_win], (L, L)).unfold(-1, W, 1)
        a_lag = a_lag.reshape(-1, 2 * L + 1, W).contiguous()
        wm = _znorm(m).unfold(-1, W, step)[:, :n_win].reshape(-1, W).contiguous()
        t = interleaved_ms({"ms": stage,
                            "plain_ms": lambda: lip_sync_score_batch_plain(m, a, fps),
                            "library_ms": lambda: torch.einsum("nlw,nw->nl", a_lag, wm)})
        t["device_ms"] = graph_ms(stage)
        bound_ms, bound_by, nbytes, nops = _stage_bound_ms(batch, n, n_win, W, L)
        rows.append({"case": case, "batch": batch, "n": n, "window": W, "max_lag": L, "n_win": n_win,
                     "max_abs_err": err, "stage_ops": sum(ops.values()), "launches_per_call": launched,
                     **t, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": nops})
    phase("kernel", kernel="lipsync_score", tolerance=KERNEL_TOL,
          device_ms_method="100 calls captured in one CUDA graph, replay time / 100",
          library_call="torch.einsum('nlw,nw->nl') over the lag-shifted z-windows: the lag products only",
          cases=rows)
    return rows[0]


#: the models phase, card f32 (TF32 off) against CPU f32 on the same inputs:
#: CLIP similarities and unit text embeddings (on the CPU the port matched the
#: JAX package within 3e-8 and 2.4e-6, ``tests/test_torch_encoders.py``)
MODEL_TOL = 1e-5
#: the v2 OCR detector computes in bf16 on both sides: the share of mask
#: pixels that must agree (``tests/test_torch_ocr.py`` holds the port to the
#: JAX package with the same bar)
OCR_MASK_AGREE = 0.999
#: ``tests/test_asr_model.py``'s long-form case
ASR_TEXT = "the mayor said the city will cut taxes next year"
#: sentences and segment texts for CLIP and the text encoder
ZOO_SENTENCES = ["the moon landing happened in 1969", "water boils at 100 degrees", "thanks for watching",
                 "the mayor said the city will cut taxes next year", "apollo 11 was the first moon landing",
                 "it was staged", "boiling water at sea level", "phase changes of water"]


def _sentences(n):
    """``n`` sentences: the fixed ones, then words drawn from them by seed."""
    rng = np.random.RandomState(0)
    words = " ".join(ZOO_SENTENCES).split()
    out = list(ZOO_SENTENCES)
    while len(out) < n:
        out.append(" ".join(rng.choice(words, rng.randint(1, 20))))
    return out[:n]


def _text_frames():
    """Three 240x320 frames with large bitmap text (``utils/draw.put_text``)."""
    from fvd_tpu_torch.utils.draw import put_text

    frames = (np.random.RandomState(5).rand(3, 240, 320, 3) * 80).astype(np.uint8)
    for f, (text, scale) in zip(frames, (("EAR: 1969", 4), ("2024-10.5", 5), ("AREA 51", 6))):
        put_text(f, text, (20, 140), scale, (230, 230, 230))
    return frames


def _clip_audio_16k(clip):
    """A clip's wav as A1 leaves it: mono, resampled to 16 kHz on the CPU."""
    from fvd_tpu_torch.ops.resample import resample_batch
    from fvd_tpu_torch.utils.wav import read_wav, to_mono

    samples, sr = read_wav(os.path.splitext(clip)[0] + ".wav")
    return resample_batch(to_mono(samples)[None], sr, 16000)[0].numpy()


def _model_row(fn, calls=20):
    """ms per call (CUDA-event fenced, median of ``calls`` after warm-up),
    the profiler's kernels and device time per call, and the aten ops one
    call dispatches."""
    from fvd_tpu_torch.c1_timing import count_device_ops, interleaved_ms

    ms = interleaved_ms({"ms": fn}, warmup=3, rounds=calls)["ms"]
    prof = _profile_top_kernels(fn, (), calls=3)
    return {"ms": ms, "calls_timed": calls, "device_ops_per_call": prof.get("kernels_per_call"),
            "aten_ops_per_call": sum(count_device_ops(fn).values()),
            "device_us_per_call": prof.get("device_us_per_call"), "device_busy_share": prof.get("device_busy_share")}


def _ocr_texts(out):
    return [[(d["text"], d["bbox"]) for d in frame] for frame in out]


def models_phase():
    """The four npz models of the production bundle at their shipped
    checkpoints (the bundle without ``hf/``), card f32 against CPU f32 on the
    same inputs."""
    import torch

    from fvd_tpu_torch.models.asr import JaxASR
    from fvd_tpu_torch.models.ocr import detect_packed_mask
    from fvd_tpu_torch.ops.image import resize
    from fvd_tpu_torch.providers.factory import production_providers
    from fvd_tpu_torch.providers.media import VideoReader
    from fvd_tpu_torch.synthetic import gated_speech

    ckpt = os.path.join(REPO, "checkpoints")
    card = production_providers(_npz_checkpoints(), use_llm=False, use_search=False, device="cuda",
                                compute_dtype=torch.float32)
    cpu = production_providers(_npz_checkpoints(), use_llm=False, use_search=False, device="cpu",
                               compute_dtype=torch.float32)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clips, _ = _video_clips(os.path.join(tmp, "clips"))
        keyframes = [VideoReader(use_cache=False).sample(c, range(0, 300, 30))[0] for c in clips]
        audio = [_clip_audio_16k(c) for c in clips]

    # ASR: asr.npz on gated speech (tests/test_asr_model.py's bars), then the
    # bundle's asr_formant.npz on the clips' 16 kHz audio; tokens card == CPU
    tone = {d: JaxASR.from_checkpoint(os.path.join(ckpt, "asr.npz"), device=d) for d in ("cuda", "cpu")}
    speech = gated_speech(ASR_TEXT, duration=15.0, gate_hz=1.0)
    got = {d: tone[d].transcribe("", audio=speech) for d in tone}
    check(got["cuda"] == got["cpu"], f"asr.npz: card {got['cuda']} vs CPU {got['cpu']}")
    acc = sum(a == b for a, b in zip(got["cuda"]["text"], ASR_TEXT)) / len(ASR_TEXT)
    covered = sum(sg["end"] - sg["start"] for sg in got["cuda"]["segments"])
    check(acc >= 0.8 and covered < 10.0, f"asr.npz: char accuracy {acc}, covered {covered} s: {got['cuda']}")
    _, rows, nf = tone["cuda"].windows(speech)
    check(np.array_equal(tone["cuda"].decode_windows(rows, nf), tone["cpu"].decode_windows(rows, nf)),
          "asr.npz: tokens differ between card and CPU")
    formant = []
    for a in audio:
        _, rows, nf = card.asr.windows(a)
        toks = {d: p.asr.decode_windows(rows, nf) for d, p in (("cuda", card), ("cpu", cpu))}
        check(np.array_equal(toks["cuda"], toks["cpu"]), "asr_formant.npz: tokens differ between card and CPU")
        formant.append({"windows": len(rows), "text": card.asr.transcribe("", audio=a)["text"]})

    def logits_gap(models, rows, nf):
        """Largest |card - CPU| of the decoder logits on the decoded tokens."""
        from fvd_tpu_torch.models.asr import _mel_masked

        res = {}
        with torch.no_grad():
            for d, m in models.items():
                mel = _mel_masked(torch.from_numpy(rows).to(d), torch.from_numpy(nf).to(d))
                toks = torch.from_numpy(m.decode_windows(rows, nf)).to(d)
                res[d] = m.model.decoder(toks, m.model.encoder(mel)).cpu()
        return float((res["cuda"] - res["cpu"]).abs().max())

    _, rows, nf = tone["cuda"].windows(speech)
    tone_gap = logits_gap(tone, rows, nf)
    _, rows, nf = card.asr.windows(audio[0])
    formant_gap = logits_gap({"cuda": card.asr, "cpu": cpu.asr}, rows, nf)
    steps = []
    hook = card.asr.model.decoder.register_forward_pre_hook(lambda *_: steps.append(1))
    card.asr.decode_windows(rows, nf)
    hook.remove()
    out["asr"] = {"checkpoint": "asr_formant.npz", "call": "transcribe() of one clip's 10 s of 16 kHz audio",
                  **_model_row(lambda: card.asr.transcribe("", audio=audio[0])),
                  "max_abs_err": formant_gap, "max_abs_err_of": "decoder logits on the decoded tokens",
                  "windows": len(rows), "decoder_steps": len(steps),
                  "clips": formant,
                  "tone": {"checkpoint": "asr.npz", "call": "transcribe() of 15 s of gated speech",
                           **_model_row(lambda: tone["cuda"].transcribe("", audio=speech)),
                           "max_abs_err": tone_gap, "char_accuracy": acc, "covered_s": covered,
                           "text": got["cuda"]["text"]}}

    # OCR: the clips' keyframes and frames of large text, device path and host path
    frames = np.concatenate(keyframes + [_text_frames()])
    dev = {"cuda": torch.from_numpy(frames).cuda(), "cpu": torch.from_numpy(frames)}
    masks = {d: detect_packed_mask(p.ocr.detector, dev[d]).cpu().numpy() for d, p in (("cuda", card),
                                                                                     ("cpu", cpu))}
    agree = float((masks["cuda"] == masks["cpu"]).mean())
    check(agree >= OCR_MASK_AGREE, f"OCR masks agree on {agree} of pixels, card vs CPU bf16")
    with torch.no_grad():
        logits = {d: p.ocr.detector(resize(dev[d].float() / 255.0, (256, 256), antialias=False)).cpu()
                  for d, p in (("cuda", card), ("cpu", cpu))}
    ocr_gap = float((logits["cuda"] - logits["cpu"]).abs().max())
    texts = {}
    for d, p in (("cuda", card), ("cpu", cpu)):
        texts[(d, "device")] = _ocr_texts(p.ocr.read_text_batch_device(dev[d], list(frames)))
        texts[(d, "host")] = _ocr_texts(p.ocr.read_text_batch(list(frames)))
    for path in ("device", "host"):
        check(texts[("cuda", path)] == texts[("cpu", path)], f"OCR {path} path: card and CPU texts differ")
    one_clip = list(keyframes[0])
    out["ocr"] = {"checkpoints": "ocr_det.npz (v2, width 128) + ocr_rec.npz",
                  "call": "read_text_batch_device() of one clip's 10 keyframes already on the card",
                  **_model_row(lambda: card.ocr.read_text_batch_device(dev["cuda"][:10], one_clip)),
                  "host_path": {"call": "read_text_batch() of the same 10 keyframes",
                                **_model_row(lambda: card.ocr.read_text_batch(one_clip))},
                  "max_abs_err": ocr_gap, "max_abs_err_of": "detector logits, bf16 on both",
                  "mask_agreement": agree, "frames": len(frames),
                  "texts_of_text_frames": [[t for t, _ in f] for f in texts[("cuda", "device")][-3:]],
                  "regions_read": sum(len(f) for f in texts[("cuda", "device")])}

    # CLIP: keyframe and segment-text pairs
    images = [im for kf in keyframes for im in kf]
    captions = _sentences(len(images))
    sims = {d: p.clip.image_text_similarity_batch(images, captions) for d, p in (("cuda", card), ("cpu", cpu))}
    gap = float(np.abs(sims["cuda"] - sims["cpu"]).max())
    check(gap <= MODEL_TOL, f"CLIP similarity card vs CPU: {gap}")
    out["clip"] = {"checkpoint": "clip.npz", "call": "image_text_similarity_batch() of one clip's 10 keyframes",
                   **_model_row(lambda: card.clip.image_text_similarity_batch(images[:10], captions[:10])),
                   "max_abs_err": gap, "pairs": len(images)}

    # text encoder: 64 sentences, unit embeddings and the ranking
    sentences = _sentences(64)
    emb = {}
    for d, p in (("cuda", card), ("cpu", cpu)):
        e = p.text_encoder.encode_batch(sentences)
        emb[d] = e / np.linalg.norm(e, axis=-1, keepdims=True)
    gap = float(np.abs(emb["cuda"] - emb["cpu"]).max())
    check(gap <= MODEL_TOL, f"text encoder, unit embeddings card vs CPU: {gap}")
    rank = {d: np.argmax(e @ e.T - 2 * np.eye(len(e)), axis=1) for d, e in emb.items()}
    check(np.array_equal(rank["cuda"], rank["cpu"]), "text encoder: nearest sentences differ")
    out["text_encoder"] = {"checkpoint": "text_encoder.npz (192/4/256)",
                           "call": "encode_batch() of E1's call: a claim and 5 results",
                           **_model_row(lambda: card.text_encoder.encode_batch(sentences[:6])),
                           "batch_64": _model_row(lambda: card.text_encoder.encode_batch(sentences)),
                           "max_abs_err": gap, "sentences": len(sentences)}
    phase("models", tolerance=MODEL_TOL, ocr_mask_agree=OCR_MASK_AGREE, tf32=False, models=out)


#: the hf phase, card f32 (TF32 off) against CPU f32 on the same inputs:
#: MiniLM embeddings and CLIP's calibrated similarities (on the CPU the port
#: is within 7.2e-7 and 2.6e-6 of the JAX package, tests/test_torch_hf_models.py)
HF_TOL = 1e-5
#: Whisper's teacher-forced logits, card against CPU on the CPU's sequence
#: of up to 320 tokens (the CPU holds the port to the JAX package within
#: 1e-4 on a 24-token sequence, tests/test_torch_hf_whisper.py; here the
#: sequences run ten times as long and the logits reach ~25)
HF_LOGIT_TOL = 1e-3
#: greedy decoding may take another token where the CPU's two best logits
#: are closer than this: card and CPU tokens must agree up to that step
HF_MARGIN = 1e-3


def _seeded_clip(cfg, seed=0):
    """``CLIPModel`` at ``cfg``'s geometry with weights drawn from a seeded
    ``torch.Generator`` (normal, std 0.02; LayerNorms at 1 and 0)."""
    import torch

    from fvd_tpu_torch.models.hf_clip import CLIPModel

    model = CLIPModel(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if "norm" in name or "layrnorm" in name:
                prm.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.02)
    return model


def _whisper_window(card, cpu, audio):
    """One 30 s window of ``audio`` decoded greedily on the card and on the
    CPU: features, tokens up to the CPU's first near-tie, teacher-forced
    logits on the CPU's sequence, and the card's encoder and decode times."""
    import torch

    from fvd_tpu_torch.c1_timing import interleaved_ms
    from fvd_tpu_torch.models.hf_whisper import greedy_generate
    from fvd_tpu_torch.utils.hf_tokenizers import whisper_decode

    max_len = min(cpu.max_new_tokens, cpu.model.config["max_target_positions"])
    feats, ids, steps = {}, {}, {}
    with torch.no_grad():
        for d, asr in (("cuda", card), ("cpu", cpu)):
            feats[d] = asr._features(torch.from_numpy(audio).to(d), 16000)
            steps[d] = []
            ids[d] = greedy_generate(asr.model, feats[d], max_len, asr.start_id, asr.eos_id, asr.pad_id,
                                     steps[d]).cpu().numpy()[0]
        top2 = torch.stack(steps["cpu"])[:, 0].topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).numpy()
        ties = np.flatnonzero(margin < HF_MARGIN)
        # step t writes token t + 1: tokens agree up to the first near-tie's step
        agree = int(ties[0]) + 1 if len(ties) else len(ids["cpu"])
        check(np.array_equal(ids["cuda"][:agree], ids["cpu"][:agree]),
              f"whisper: card tokens {ids['cuda'][:agree].tolist()} vs CPU {ids['cpu'][:agree].tolist()}")
        n = len(steps["cpu"]) + 1
        seq = torch.from_numpy(ids["cpu"][:n][None].copy())
        logits = {d: asr.model(feats[d], seq.to(d)).cpu() for d, asr in (("cuda", card), ("cpu", cpu))}
    gap = float((logits["cuda"] - logits["cpu"]).abs().max())
    check(gap <= HF_LOGIT_TOL, f"whisper teacher-forced logits card vs CPU: {gap}")
    f = feats["cuda"]
    with torch.no_grad():
        encoder_ms = interleaved_ms({"ms": lambda: card.model.encode(f)}, warmup=2, rounds=10)["ms"]
        t0 = time.perf_counter()
        card_steps = []
        greedy_generate(card.model, f, max_len, card.start_id, card.eos_id, card.pad_id, card_steps)
        decode_ms = (time.perf_counter() - t0) * 1e3
        prof = _profile_top_kernels(lambda: greedy_generate(card.model, f, max_len, card.start_id, card.eos_id,
                                                            card.pad_id), (), calls=1)
    return {"tokens": int((ids["cpu"] != cpu.pad_id).sum()), "decode_steps": len(card_steps),
            "first_near_tie_step": int(ties[0]) if len(ties) else None, "smallest_margin": float(margin.min()),
            "tokens_equal": bool(np.array_equal(ids["cuda"], ids["cpu"])),
            "feature_max_abs_err": float((feats["cuda"].cpu() - feats["cpu"]).abs().max()),
            "logits_max_abs_err": gap, "encoder_ms": encoder_ms, "decode_ms": decode_ms,
            "ms_per_step": decode_ms / max(len(card_steps), 1),
            "kernels_per_step": (prof["kernels_per_call"] / max(len(card_steps), 1)
                                 if "kernels_per_call" in prof else prof),
            "text": whisper_decode(card.tokenizer, ids["cuda"]).strip()}


def hf_phase():
    """The HF model lineup of ``checkpoints/hf``, card f32 (TF32 off) against
    CPU f32 on the same inputs: MiniLM and Whisper on their shipped weights,
    CLIP ViT-B/32 at its ``config.json``'s geometry with seeded weights (the
    copy leaves out its 303 MB msgpack)."""
    import torch

    from fvd_tpu_torch.providers.hf_models import HFClip, HFTextEncoder, HFWhisperASR
    from fvd_tpu_torch.providers.media import VideoReader
    from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer

    hf = os.path.join(REPO, "checkpoints", "hf")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the one clip the phase reads (all 4 were drawn until the eval phase)
        clips, _ = _video_clips(os.path.join(tmp, "clips"), ZOO_SPEECH, speech="formant", n=1)
        keyframes = [VideoReader(use_cache=False).sample(c, range(0, 300, 30))[0] for c in clips]
        audio = [_clip_audio_16k(c) for c in clips]

    # MiniLM: 64 sentences
    enc = {d: HFTextEncoder.from_local(os.path.join(hf, "minilm"), device=d) for d in ("cuda", "cpu")}
    sentences = _sentences(64)
    emb = {d: e.encode_batch(sentences) for d, e in enc.items()}
    gap = float(np.abs(emb["cuda"] - emb["cpu"]).max())
    check(gap <= HF_TOL, f"MiniLM embeddings card vs CPU: {gap}")
    out["minilm"] = {"checkpoint": "hf/minilm (6 x 384, real weights)",
                     "call": "encode_batch() of E1's call: a claim and 5 results",
                     **_model_row(lambda: enc["cuda"].encode_batch(sentences[:6])),
                     "batch_64": _model_row(lambda: enc["cuda"].encode_batch(sentences)),
                     "max_abs_err": gap, "sentences": len(sentences)}
    del enc

    # Whisper: one 30 s window of each clip's 16 kHz audio
    asr = {d: HFWhisperASR.from_local(os.path.join(hf, "whisper"), device=d) for d in ("cuda", "cpu")}
    # one of the four clips, sync_a's speech (two until the hf_train phase,
    # random_audio's near-ties the other: a cut that pays for it)
    windows = [_whisper_window(asr["cuda"], asr["cpu"], a) for a in audio[:1]]
    out["whisper"] = {"checkpoint": "hf/whisper (base, 6 + 6 x 512, real weights)",
                      "call": "transcribe() of one clip's 10 s of 16 kHz audio (one 30 s window)",
                      **_model_row(lambda: asr["cuda"].transcribe("", audio=audio[0]), calls=3),
                      "max_abs_err": max(w["logits_max_abs_err"] for w in windows),
                      "max_abs_err_of": "teacher-forced logits on the CPU's tokens", "windows": windows}
    del asr

    # CLIP ViT-B/32 at its config's geometry, seeded weights, the shipped tokenizer and calibration
    with open(os.path.join(hf, "clip", "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(hf, "clip", "fvd_train_meta.json")) as f:
        meta = json.load(f)
    tok = Tokenizer.from_dir(os.path.join(hf, "clip"))
    n_text = cfg["text_config"]["max_position_embeddings"]
    clip = {d: HFClip(_seeded_clip(cfg), lambda t: tok(t, n_text), cfg["vision_config"]["image_size"],
                      meta["cal_offset"], meta["cal_scale"], device=d) for d in ("cuda", "cpu")}
    images = list(keyframes[0])   # one clip's 10 (the four clips' 40 until the hf_train phase)
    captions = _sentences(len(images))
    sims = {d: c.image_text_similarity_batch(images, captions) for d, c in clip.items()}
    gap = float(np.abs(sims["cuda"] - sims["cpu"]).max())
    check(gap <= HF_TOL and np.isfinite(sims["cuda"]).all(), f"CLIP similarity card vs CPU: {gap}")
    out["clip"] = {"checkpoint": "hf/clip config.json geometry (ViT-B/32 768 x 12, text 512 x 12), "
                                 "weights from torch.Generator seed 0",
                   "call": "image_text_similarity_batch() of one clip's 10 keyframes",
                   **_model_row(lambda: clip["cuda"].image_text_similarity_batch(images[:10], captions[:10])),
                   "max_abs_err": gap, "pairs": len(images)}
    phase("hf", tolerance=HF_TOL, logit_tolerance=HF_LOGIT_TOL, margin=HF_MARGIN, tf32=False, models=out)


def _bf16_stages(ssd, lmk, frames):
    """Max |bf16 - f32| of the keyframes' top detection scores, and of the
    landmarks cropped from the same (f32) boxes, on the analyzer's sampling."""
    import torch

    from fvd_tpu_torch.entry import FPS, H, W
    from fvd_tpu_torch.models import face_ssd, landmarks_fan

    dev = frames.device
    det_ids = torch.arange(0, frames.shape[0], int(FPS), device=dev)
    lmk_ids = torch.arange(0, frames.shape[0], int(FPS / 5), device=dev)
    s = {dt: face_ssd.detect_batch(ssd, frames[det_ids], compute_dtype=dt)
         for dt in (torch.bfloat16, torch.float32)}
    px = s[torch.float32][0][:, 0] * torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
    boxes = px[lmk_ids // int(FPS)]
    lm = {dt: landmarks_fan.landmarks_from_frames(lmk, frames, boxes, lmk_ids, compute_dtype=dt)
          for dt in (torch.bfloat16, torch.float32)}
    return {
        "top_scores": float((s[torch.bfloat16][1][:, 0] - s[torch.float32][1][:, 0]).abs().max()),
        "landmarks_same_boxes": float((lm[torch.bfloat16] - lm[torch.float32]).abs().max()),
    }


def _analyzer_breakdown(args, calls=20):
    """Per-stage milliseconds of one bf16 analyzer call: the stages of
    ``make_analyzer``'s ``fn`` run in its order from the port's public
    functions, with a CUDA event recorded after each.  ``card_ms`` is the
    time on the card's clock from one event to the next (the card's work on
    the stage, or its wait for the host where the host is behind);
    ``host_ms`` is the host's time to issue the stage, without synchronising.
    Medians of ``calls`` calls.  Also the device ops each stage dispatches,
    counted in one more call, and the last call's outputs."""
    import torch

    from fvd_tpu_torch.c1_timing import DeviceOpCounter
    from fvd_tpu_torch.entry import FPS, SR, H, W
    from fvd_tpu_torch.models import face_ssd, landmarks_fan
    from fvd_tpu_torch.ops.lipsync import lip_sync_score, mar_from_points
    from fvd_tpu_torch.ops.spectral import interp_to_length, rms_envelope

    ssd, lmk, frames, audio_wave, other, w, b = args
    dev, dt = frames.device, torch.bfloat16
    T = frames.shape[0]
    det_ids, lmk_ids = np.arange(0, T, int(FPS)), np.arange(0, T, int(FPS / 5))
    lmk_fps = FPS / int(FPS / 5)
    hop = int(SR / lmk_fps)

    def run(mark):
        boxes, _ = face_ssd.detect_batch(ssd, frames[torch.as_tensor(det_ids, device=dev)], compute_dtype=dt)
        px = boxes[:, 0, :] * torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
        mark("V1 detect")
        coords = landmarks_fan.landmarks_from_frames(
            lmk, frames, px[torch.as_tensor(lmk_ids // int(FPS), device=dev)],
            torch.as_tensor(lmk_ids, device=dev), compute_dtype=dt)
        mark("V3 crops+hourglass")
        mar = mar_from_points(coords[:, 48:68, :])
        mark("MAR")
        env = interp_to_length(rms_envelope(audio_wave, frame_length=2 * hop, hop=hop), len(lmk_ids))
        mark("A3 envelope+interp")
        lip = lip_sync_score(mar, env, lmk_fps).score
        mark("C1")
        prob = torch.sigmoid(torch.cat([other[:2], lip[None], other[2:]]) @ w + b)
        mark("LR")
        return prob, lip

    card, host = {}, {}
    with torch.no_grad():
        for _ in range(calls):
            marks = [("start", torch.cuda.Event(enable_timing=True), time.perf_counter())]
            marks[0][1].record()

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev, time.perf_counter()))

            out = run(mark)
            torch.cuda.synchronize()
            for (_, e0, t0), (name, e1, t1) in zip(marks, marks[1:]):
                card.setdefault(name, []).append(e0.elapsed_time(e1))
                host.setdefault(name, []).append((t1 - t0) * 1e3)
        with DeviceOpCounter() as counter:
            seen = [0]
            ops = {}

            def count(name):
                total = sum(counter.ops.values())
                ops[name] = total - seen[0]
                seen[0] = total

            run(count)
    ms = {"card_ms": {k: statistics.median(v) for k, v in card.items()},
          "host_ms": {k: statistics.median(v) for k, v in host.items()}}
    return ms, ops, out


def _profile_top_kernels(fn, args, calls=5):
    """``torch.profiler`` over ``calls`` analyzer calls: the ten kernels with
    the most device time, and the device's busy share of the window.  Returns
    the error instead where the profiler fails on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

        def dev_us(e):
            return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

        kernels.sort(key=dev_us, reverse=True)
        total_us = sum(dev_us(e) for e in kernels)
        if total_us <= 0:
            return {"calls": calls, "device_time": "the profiler showed no device time"}
        return {"calls": calls, "device_us_per_call": total_us / calls, "wall_us_per_call": wall_us / calls,
                "device_busy_share": total_us / wall_us, "kernels_per_call": sum(e.count for e in kernels) / calls,
                "top10": [{"kernel": e.key[:90], "device_us_per_call": dev_us(e) / calls,
                           "launches_per_call": e.count / calls} for e in kernels[:10]]}
    except Exception as e:  # a measurement only: report it and go on with the checks
        return {"calls": calls, "error": repr(e)}


def analyzer_phase():
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.entry import entry, make_analyzer

    fn, args = entry(device="cuda")
    fn(*args)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    _kernels.reset_launches()
    prob, lip = fn(*args)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(launches["lipsync_score"] == 1, f"analyzer call must launch the C1 kernel once: {launches}")

    out = {"fake_probability": float(prob), "lip_sync_score": float(lip)}
    check(all(np.isfinite(v) for v in out.values()), f"non-finite output {out}")
    check(0.0 <= out["fake_probability"] <= 1.0, f"probability out of range {out}")
    check(out["lip_sync_score"] >= 0.0, f"lip-sync score below 0 {out}")

    prob32, lip32 = make_analyzer(compute_dtype=torch.float32)(*args)
    out32 = {"fake_probability": float(prob32), "lip_sync_score": float(lip32)}
    for k in out:
        check(abs(out[k] - out32[k]) <= BF16_TOL[k], f"bf16 vs f32 {k}: {out[k]} vs {out32[k]}")
        check(abs(out32[k] - JAX_F32_REFERENCE[k]) <= F32_TOL[k],
              f"f32 vs JAX f32 {k}: {out32[k]} vs {JAX_F32_REFERENCE[k]}")
    stages = _bf16_stages(*args[:3])
    for k, v in stages.items():
        check(v <= BF16_STAGE_TOL[k], f"bf16 vs f32 {k}: max |d| {v} > {BF16_STAGE_TOL[k]}")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    breakdown_ms, breakdown_ops, (bprob, blip) = _analyzer_breakdown(args)
    check(abs(float(bprob) - out["fake_probability"]) <= BREAKDOWN_TOL
          and abs(float(blip) - out["lip_sync_score"]) <= BREAKDOWN_TOL,
          f"stage-by-stage run gave {float(bprob)}, {float(blip)}; fn gave {out}")
    check(breakdown_ops["C1"] == 0, f"the C1 stage dispatched {breakdown_ops['C1']} device ops")
    phase("analyzer", bf16=out, f32=out32, jax_f32=JAX_F32_REFERENCE, bf16_tol=BF16_TOL,
          f32_tol=F32_TOL, bf16_stages=stages, bf16_stage_tol=BF16_STAGE_TOL, launches=launches,
          median_call_ms=statistics.median(times), stage_ms=breakdown_ms,
          stage_card_ms_sum=sum(breakdown_ms["card_ms"].values()), stage_device_ops=breakdown_ops,
          profile=_profile_top_kernels(fn, args),
          frames=list(args[2].shape), audio_samples=int(args[3].shape[0]))
    return launches["lipsync_score"]


def serving_phase():
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.ops.fusion import FEATURE_ORDER, weights_to_vectors
    from fvd_tpu_torch.ops.lipsync import lip_sync_score
    from fvd_tpu_torch.serving import ScoreRequest, ScoringService

    n, fps, n_req, clients = 50, 5.0, 64, 8   # 10 s at the 5 fps landmark rate
    rng = np.random.RandomState(1)
    weights = {k: float(v) for k, v in zip(FEATURE_ORDER, rng.randn(9) * 0.5)}
    weights["bias"] = 0.1
    t = np.linspace(0, n / fps, n)
    reqs = []
    for i in range(n_req):
        env = np.clip(0.5 * (1 + np.sin(2 * np.pi * 0.7 * t + i)) + 0.1 * rng.rand(n), 0, 1)
        mouth = env if i % 2 == 0 else rng.rand(n)
        reqs.append(ScoreRequest(mouth=mouth.astype(np.float32), audio=env.astype(np.float32),
                                 other_feats=rng.rand(8).astype(np.float32)))

    svc = ScoringService(weights, n=n, fps=fps, max_batch=64, max_wait_ms=50.0, devices=["cuda"])
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            results = list(pool.map(lambda r: svc.score(r, timeout=120), reqs))
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_kernels.LAUNCHES)
        batches = svc.batcher.batches_run
    finally:
        svc.close()
    check(batches >= 1, "no micro-batch ran")
    check(launches["lipsync_score"] == batches,
          f"serving must launch the C1 kernel once per micro-batch: {launches}, {batches} batches")

    w, b = weights_to_vectors(weights)
    worst = 0.0
    for r, res in zip(reqs, results):
        lip = float(lip_sync_score(torch.from_numpy(r.mouth), torch.from_numpy(r.audio), fps).score)
        feats = np.concatenate([r.other_feats[:2], [lip], r.other_feats[2:]]).astype(np.float64)
        expected = 1.0 / (1.0 + np.exp(-(feats @ w + float(b))))
        worst = max(worst, abs(res["lip_sync_score"] - lip), abs(res["fake_probability"] - expected))
    check(worst <= 1e-5, f"served results differ from per-request scoring by {worst}")
    phase("serving", requests=n_req, clients=clients, batches_run=batches, launches=launches,
          max_abs_err=worst, wall_ms=wall_ms)
    return launches["lipsync_score"]


def _generate_signals(duration, fps, sync_type, seed):
    """The reference's synthetic lip-sync generator (a copy of
    ``generate_signals`` in ``tests/test_c1_lipsync.py``): an A3-like envelope
    and a mouth signal that follows it, lags it, ignores it or faces silence."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, duration, int(duration * fps))
    envelope = np.clip(0.5 * (1 + np.sin(2 * np.pi * 2 * t)) + 0.1 * rng.rand(len(t)), 0, 1)
    audio, mouth = envelope, envelope
    if sync_type == "delayed":
        mouth = np.roll(envelope, int(0.1 * fps))
    elif sync_type == "random":
        mouth = rng.rand(len(t))
    elif sync_type == "silence":
        audio = np.zeros_like(t)
    landmarks = [{"timestamp": t[i], "mar": v * 0.5 + 0.1} for i, v in enumerate(mouth)]
    return audio, landmarks


def _dag_states(fps=30.0):
    """What A3 and V3 would have written for 16 videos of 60 s and one of
    10 min: landmarks at V3's 5 fps, an envelope of ``duration * fps``
    samples (of 0.8 of that for every other video, which C1 reconciles)."""
    kinds = ("perfect", "delayed", "random", "silence")
    out = []
    for i, seconds in enumerate([60.0] * 16 + [600.0]):
        audio, landmarks = _generate_signals(seconds, fps, kinds[i % 4], seed=i)
        if i % 2:
            n = int(0.8 * len(audio))
            audio = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(audio)), audio)
        out.append(dict(input_path=f"dag_video_{i:02d}.mp4", metadata={"fps": fps, "duration": seconds},
                        face_detections=[{"timestamp": 0.0, "box": [40, 30, 200, 210], "confidence": 0.9}],
                        mouth_landmarks=landmarks[::int(fps / 5)], audio_envelope=audio))
    return out


def _span_ms(tracer, name):
    spans = [sp.elapsed_s * 1e3 for sp in tracer.spans if sp.name == name]
    return statistics.median(spans) if spans else None


def dag_phase():
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.nodes import c1_lipsync, lr_fusion
    from fvd_tpu_torch.providers import coalesce
    from fvd_tpu_torch.runtime import DAG, Scheduler, Tracer, set_tracer
    from fvd_tpu_torch.state import State

    states = _dag_states()
    n = len(states)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = default_config()
        cfg = cfg.replace(fusion=type(cfg.fusion)(weights_path=os.path.join(tmp, "lr_weights.json"),
                                                  features_dir=os.path.join(tmp, "features")))

        def scheduler(device):
            dag = DAG()
            dag.add_node("C1", functools.partial(c1_lipsync.run, config=cfg, device=device))
            dag.add_node("LR", functools.partial(lr_fusion.run, config=cfg), deps=["C1"])
            return Scheduler(dag)

        def invoke(sched, i):
            t0 = time.perf_counter()
            final = sched.invoke(State(**states[i]))
            return final, (time.perf_counter() - t0) * 1e3

        cpu_sched, card_sched = scheduler("cpu"), scheduler("cuda")
        ref = [invoke(cpu_sched, i)[0] for i in range(n)]
        invoke(card_sched, 0)  # warm-up: the event loop, the thread pools, the first copies

        def run(coalesced):
            tracer = set_tracer(Tracer())
            deactivate = coalesce._activate_program_coalescer(max_wait_ms=30.0) if coalesced else (lambda: None)
            co = coalesce._program_co
            try:
                _kernels.reset_launches()
                t0 = time.perf_counter()
                if coalesced:
                    with ThreadPoolExecutor(n) as pool:
                        out = list(pool.map(lambda i: invoke(card_sched, i), range(n)))
                else:
                    out = [invoke(card_sched, i) for i in range(n)]
                total_ms = (time.perf_counter() - t0) * 1e3
                launches = _kernels.LAUNCHES["lipsync_score"]
                groups = co.groups_run if coalesced else None
            finally:
                deactivate()
                set_tracer(None)
            finals, wall = zip(*out)
            errs = {"lip_sync_score": max(abs(f.lip_sync_score - r.lip_sync_score) for f, r in zip(finals, ref)),
                    "fake_probability": max(abs(f.fake_probability - r.fake_probability)
                                            for f, r in zip(finals, ref))}
            check(errs["lip_sync_score"] <= KERNEL_TOL and errs["fake_probability"] <= DAG_PROB_TOL,
                  f"dag on the card vs the CPU ({'coalesced' if coalesced else 'one at a time'}): {errs}")
            check(all(np.isfinite(f.fake_probability) and 0.0 < f.fake_probability < 1.0 for f in finals),
                  f"dag probabilities {[f.fake_probability for f in finals]}")
            sizes = sorted((sp.meta["n"] for sp in tracer.spans if sp.name == "coalesce/c1_lipsync"),
                           reverse=True)
            return {"launches": launches, "groups": groups, "group_sizes": sizes, "max_abs_err": errs,
                    "median_wall_ms_per_video": statistics.median(wall), "wall_ms_all_videos": total_ms,
                    "span_median_ms": {k: _span_ms(tracer, k)
                                       for k in ("node/C1", "node/LR", "coalesce/c1_lipsync")}}, finals

        a, finals = run(coalesced=True)
        check(a["launches"] == a["groups"] == len(a["group_sizes"]) and sum(a["group_sizes"]) == n,
              f"coalesced run: {a['launches']} launches for {a['groups']} groups of {a['group_sizes']}")
        check(a["group_sizes"][0] > 1, f"no coalesced group held more than one video: {a['group_sizes']}")
        b, _ = run(coalesced=False)
        check(b["launches"] == n and not b["group_sizes"],
              f"one video at a time: {b['launches']} launches for {n} videos")
    scores = [f.lip_sync_score for f in finals]
    check(all(s == 0.0 for s in scores[3::4]) and len(set(np.round(scores, 3))) >= 4,
          f"dag lip-sync scores {scores}")
    phase("dag", videos=n, video_seconds=[s["metadata"]["duration"] for s in states], tolerance=KERNEL_TOL,
          prob_tolerance=DAG_PROB_TOL, coalesced=a, one_at_a_time=b,
          lip_sync_scores=scores, fake_probabilities=[f.fake_probability for f in finals])
    return a["launches"] + b["launches"]


#: the video phase, card f32 against CPU f32 on the same clips: the same
#: programs summing in other orders (cuDNN against the CPU's convolutions); on
#: the CPU the port matched the JAX package within 4.2e-7 (lip) and 4.7e-8
#: (probability) on a 6 s clip (``tests/test_torch_video_dag.py``)
VIDEO_LIP_TOL, VIDEO_PROB_TOL = 1e-4, 1e-5
#: the share of keyframes with a face (V1) and of 5 fps samples with mouth
#: landmarks (V3) every clip must reach
VIDEO_FOUND_MIN = 0.8
VIDEO_SPANS = ("node/IN", "node/A1", "node/A3", "node/V1", "node/V3", "node/C1", "node/LR",
               "v3/decode", "v3/landmark_fwd", "v3/track", "v3/smooth", "v3/emit")


def _video_clips(root, speech_text=None, speech="tone", n=4):
    """The first ``n`` of 4 clips of 10 s at 30 fps and 240x320 with 44.1 kHz
    audio: two in sync (gates of 1.0 and 1.3 Hz), one whose mouth moves at
    0.37 Hz against a 1 Hz audio gate (a dubbed mouth), one with random
    audio.  The gated audio is a tone, or ``speech_text`` as tone-coded
    speech in the gate's on-windows; with ``speech="formant"``,
    ``speech_text`` as one formant utterance at 16 kHz (Whisper's domain)."""
    from fvd_tpu_torch.synthetic import make_face_video
    from fvd_tpu_torch.utils.wav import write_wav

    sr = 16000 if speech == "formant" else 44100
    common = dict(duration=10.0, fps=30.0, width=320, height=240, sr=sr, speech_text=speech_text, speech=speech)
    recipes = [("sync_a", dict(gate_hz=1.0, seed=0)), ("sync_b", dict(gate_hz=1.3, seed=1)),
               ("dubbed", dict(gate_hz=1.0, mouth_gate_hz=0.37, seed=2)), ("random_audio", dict(gate_hz=1.0, seed=3))]
    clips = [make_face_video(root, name, **kw, **common) for name, kw in recipes[:n]]
    if n == 4:
        noise = np.random.RandomState(3).uniform(-0.5, 0.5, int(10.0 * sr))
        write_wav(os.path.join(root, "random_audio.wav"), noise, sr)
    return clips, ["sync", "sync", "broken", "broken"][:n]


def _video_scheduler(root, device, dtype):
    """The seven nodes of the lip-sync path on ``device``, wired with the
    dependencies of the JAX package's ``graph.py`` restricted to them; runs
    write under ``root/processed``."""
    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.nodes import (a1_standardize, a3_onsets, c1_lipsync, ingest, lr_fusion, v1_faces,
                                     v3_landmarks)
    from fvd_tpu_torch.providers import Providers
    from fvd_tpu_torch.runtime import DAG, Scheduler

    ckpt = os.path.join(REPO, "checkpoints")
    det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), compute_dtype=dtype, device=device)
    prov = Providers(face_detector=det, landmarks=FANLandmarks(
        det, checkpoint=os.path.join(ckpt, "landmarks.npz"), compute_dtype=dtype, device=device))
    cfg = default_config()
    cfg = cfg.replace(ingest=dataclasses.replace(cfg.ingest, processed_dir=os.path.join(root, "processed")),
                      fusion=dataclasses.replace(cfg.fusion, weights_path=os.path.join(root, "lr_weights.json"),
                                                 features_dir=os.path.join(root, "features")))
    part = functools.partial
    dag = DAG()
    dag.add_node("IN", part(ingest.run, config=cfg), host_only=True)
    dag.add_node("A1", part(a1_standardize.run, config=cfg, device=device), deps=["IN"])
    dag.add_node("V1", part(v1_faces.run, config=cfg, providers=prov, device=device), deps=["IN"])
    dag.add_node("A3", part(a3_onsets.run, config=cfg, device=device), deps=["A1"])
    dag.add_node("V3", part(v3_landmarks.run, config=cfg, providers=prov, device=device), deps=["V1"])
    dag.add_node("C1", part(c1_lipsync.run, config=cfg, device=device), deps=["A3", "V3"])
    dag.add_node("LR", part(lr_fusion.run, config=cfg), deps=["C1"])
    return Scheduler(dag)


def _video_run(sched, root, clips, coalesced, window_ms=30.0):
    """Every clip through ``sched``, one after another or all at once under
    the program coalescer (its adaptive window from ``window_ms``, or fixed at
    ``window_ms`` where it is over 30), from cold caches: final states, wall
    ms per video, C1 launches, coalesced C1 groups, frame uploads and the
    tracer's spans.  The run directories under ``root`` are removed after."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.providers import coalesce, media
    from fvd_tpu_torch.runtime import Tracer, io_pool, set_tracer
    from fvd_tpu_torch.state import State

    def invoke(path):
        t0 = time.perf_counter()
        final = sched.invoke(State(input_path=path))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return final, (time.perf_counter() - t0) * 1e3

    media.clear_frame_cache()
    io_pool.clear_artifact_caches()
    tracer = set_tracer(Tracer())
    deactivate = coalesce._activate_program_coalescer(max_wait_ms=window_ms) if coalesced else (lambda: None)
    fixed = coalesced and window_ms > 30.0
    if fixed:
        os.environ["FVD_TPU_NO_ADAPTIVE_WINDOW"] = "1"
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        if coalesced:
            with ThreadPoolExecutor(len(clips)) as pool:
                out = list(pool.map(invoke, clips))
        else:
            out = [invoke(p) for p in clips]
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = _kernels.LAUNCHES["lipsync_score"]
    finally:
        deactivate()
        set_tracer(None)
        if fixed:
            os.environ.pop("FVD_TPU_NO_ADAPTIVE_WINDOW", None)
        shutil.rmtree(os.path.join(root, "processed"), ignore_errors=True)
    finals, wall = zip(*out)
    spans = {k: _span_ms(tracer, k) for k in VIDEO_SPANS}
    totals = tracer.summary()
    return {"finals": finals, "wall": list(wall), "total_ms": total_ms, "launches": launches,
            "c1_groups": sorted((sp.meta["n"] for sp in tracer.spans if sp.name == "coalesce/c1_lipsync"),
                                reverse=True),
            "uploads": media._device_frames.uploads, "upload_bytes": media._device_frames.upload_bytes,
            "spans": spans, "png_s": totals.get("artifact/png", 0.0), "viz_s": totals.get("artifact/viz", 0.0),
            "png_writes": tracer.counts().get("artifact/png", 0)}


def _video_summary(r, n):
    finals = r["finals"]
    return {"median_wall_ms_per_video": statistics.median(r["wall"]), "wall_ms_all_videos": r["total_ms"],
            "lipsync_score_launches": r["launches"], "c1_group_sizes": r["c1_groups"],
            "frame_uploads_per_video": r["uploads"] / n, "frame_upload_mb_per_video": r["upload_bytes"] / n / 1e6,
            "png_writes_per_video": r["png_writes"] / n, "png_write_s_per_video": r["png_s"] / n,
            "viz_encode_s_per_video": r["viz_s"] / n, "span_median_ms": r["spans"],
            "lip_sync_scores": [f.lip_sync_score for f in finals],
            "fake_probabilities": [f.fake_probability for f in finals]}


def _check_video_run(r, kinds, what):
    n = len(kinds)
    for f, kind in zip(r["finals"], kinds):
        faces = [bool(d["faces"]) for d in f.face_detections]
        mouths = [bool(m["landmarks"]) for m in f.mouth_landmarks]
        check(len(faces) == 10 and sum(faces) >= VIDEO_FOUND_MIN * len(faces),
              f"{what}: V1 found faces in {sum(faces)} of {len(faces)} keyframes")
        check(len(mouths) == 50 and sum(mouths) >= VIDEO_FOUND_MIN * len(mouths),
              f"{what}: V3 gave mouth landmarks for {sum(mouths)} of {len(mouths)} samples")
        check(np.isfinite(f.fake_probability) and 0.0 < f.fake_probability < 1.0 and f.lip_sync_score >= 0.0,
              f"{what}: {kind} clip gave {f.lip_sync_score}, {f.fake_probability}")
    sync = [f.lip_sync_score for f, k in zip(r["finals"], kinds) if k == "sync"]
    broken = [f.lip_sync_score for f, k in zip(r["finals"], kinds) if k == "broken"]
    check(min(sync) > max(broken), f"{what}: in-sync clips {sync} do not score above the broken ones {broken}")
    check(r["uploads"] == n, f"{what}: {r['uploads']} frame uploads for {n} videos")


def _profile_video(sched, clip):
    """``torch.profiler`` over one video's DAG on the card: the ten kernels
    with the most device time and the device's busy share of the wall time."""
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.runtime import io_pool
    from fvd_tpu_torch.state import State

    media.clear_frame_cache()
    io_pool.clear_artifact_caches()
    return _profile_top_kernels(lambda: sched.invoke(State(input_path=clip)), (), calls=1)


def _one_euro_ms(samples):
    """Median ms of the port's host OneEuro scan over a track of ``samples``
    5 fps samples of 68 points (V3's smoothing of a whole clip)."""
    from fvd_tpu_torch.ops.filters import one_euro_scan

    rng = np.random.RandomState(0)
    times = np.arange(samples) / 5.0
    values = 100 + 50 * rng.rand(samples, 68, 2)
    valid = rng.rand(samples) > 0.1
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_euro_scan(times, values, valid, min_cutoff=0.5, beta=0.1)
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def video_phase():
    import torch

    from fvd_tpu_torch.providers.media import VideoReader, write_video

    with tempfile.TemporaryDirectory() as tmp:
        frames = np.random.RandomState(4).randint(0, 256, (30, 240, 320, 3), dtype=np.uint8)
        write_video(os.path.join(tmp, "roundtrip.avi"), frames, 30.0)
        back, kept = VideoReader(use_cache=False).sample(os.path.join(tmp, "roundtrip.avi"), range(30))
        check(kept == list(range(30)) and np.array_equal(back, frames), "write_video -> VideoReader is not bit-exact")

        t0 = time.perf_counter()
        clips, kinds = _video_clips(os.path.join(tmp, "clips"))
        make_s = time.perf_counter() - t0
        n = len(clips)
        runs, summary = {}, {}
        for name, device, dtype in (("card_bf16", "cuda", torch.bfloat16), ("card_f32", "cuda", torch.float32),
                                    ("cpu_f32", "cpu", torch.float32)):
            root = os.path.join(tmp, name)
            sched = _video_scheduler(root, device, dtype)
            _video_run(sched, root, clips[:1], coalesced=False)  # warm-up: cuDNN picks its algorithms
            modes = [("one_at_a_time", False, None)]
            if device == "cuda":
                # the CPU runs its clips one at a time only (its coalesced
                # run went in the levers phase's cut): the card's coalesced
                # runs are held against that
                modes.append(("coalesced", True, 30.0))
            if name == "card_f32":
                # the 30 ms window rarely lets the clips' C1 calls meet (groups
                # of one on the card); a fixed 500 ms window makes C1 groups
                # of several videos, which must hold to the CPU as well
                modes.append(("grouped_500ms", True, 500.0))
            for mode, coalesced, window_ms in modes:
                r = _video_run(sched, root, clips, coalesced, window_ms or 30.0)
                _check_video_run(r, kinds, f"{name} {mode}")
                if device == "cuda":
                    if coalesced:
                        check(r["launches"] == len(r["c1_groups"]) and sum(r["c1_groups"]) == n,
                              f"{name} {mode}: {r['launches']} launches for C1 groups {r['c1_groups']}")
                    else:
                        check(r["launches"] == n, f"{name}: {r['launches']} launches for {n} videos")
                    if mode == "grouped_500ms":
                        check(r["c1_groups"][0] > 1, f"{name} {mode}: no C1 group of more than one video: "
                                                     f"{r['c1_groups']}")
                runs[(name, mode)] = r
                summary.setdefault(name, {})[mode] = _video_summary(r, n)
            if name == "card_bf16":
                summary[name]["profile_one_video"] = _profile_video(sched, clips[0])
        errs = {}
        for mode, cpu_mode in (("one_at_a_time", "one_at_a_time"), ("coalesced", "one_at_a_time"),
                               ("grouped_500ms", "one_at_a_time")):
            card, cpu = runs[("card_f32", mode)]["finals"], runs[("cpu_f32", cpu_mode)]["finals"]
            errs[mode] = {"lip_sync_score": max(abs(a.lip_sync_score - b.lip_sync_score) for a, b in zip(card, cpu)),
                          "fake_probability": max(abs(a.fake_probability - b.fake_probability)
                                                  for a, b in zip(card, cpu))}
            check(errs[mode]["lip_sync_score"] <= VIDEO_LIP_TOL and errs[mode]["fake_probability"] <= VIDEO_PROB_TOL,
                  f"video, card f32 vs CPU f32 ({mode}): {errs[mode]}")
        bf16_gap = max(abs(a.lip_sync_score - b.lip_sync_score)
                       for a, b in zip(runs[("card_bf16", "one_at_a_time")]["finals"],
                                       runs[("card_f32", "one_at_a_time")]["finals"]))
    launches = sum(r["launches"] for (name, _), r in runs.items() if name.startswith("card"))
    phase("video", clips=[os.path.basename(c) for c in clips], kinds=kinds, clip_seconds=10.0, fps=30.0,
          frame_size=[240, 320], audio_sr=44100, make_clips_s=make_s, tolerance=VIDEO_LIP_TOL,
          prob_tolerance=VIDEO_PROB_TOL, card_f32_vs_cpu_f32=errs, card_bf16_vs_f32_max_lip=bf16_gap,
          one_euro_scan_ms={"50 samples (10 s)": _one_euro_ms(50), "3000 samples (10 min)": _one_euro_ms(3000)},
          runs=summary)
    return launches


#: the full_dag phase, card f32 against CPU f32 on the same clips and bundle:
#: the video phase's bars for lip and the probability, held by every LR feature (on the
#: CPU the port matched the JAX package within 7.7e-7 on every feature,
#: ``tests/test_torch_full_dag.py``)
DAG_FEATURE_TOL, DAG_FULL_PROB_TOL = 1e-4, 1e-5
FULL_DAG_NODES = ("IN", "A1", "V1", "A2", "A3", "V2", "V3", "V4", "V5",
                  "C1", "C2", "C3", "E1", "E2", "E3", "LR")
FULL_DAG_SPANS = tuple(f"node/{n}" for n in FULL_DAG_NODES) + (
    "v4/decode", "v4/landmark_fwd", "v4/track", "v4/pose_fwd", "v4/smooth", "v4/emit", "v3/landmark_fwd",
    "coalesce/v5_ela", "coalesce/c1_lipsync")


def _hermetic_providers(det, lmk):
    """Fixed ASR, LLM, search and CLIP content for a 10 s clip: two claims,
    five search results over three trust tiers, one gesture check of each
    status, a texture score of 0.3."""
    from fvd_tpu_torch.providers import Providers, ScriptedASR, ScriptedLLM, StaticSearch, StubClip
    from fvd_tpu_torch.providers.search import make_result
    from fvd_tpu_torch.providers.vision import NullOCR

    claims = ["the moon landing happened in 1969", "water boils at 100 degrees"]
    segments = [{"start": 0.0, "end": 2.5, "text": claims[0]}, {"start": 3.2, "end": 5.6, "text": claims[1]},
                {"start": 6.4, "end": 9.5, "text": "thanks for watching"}]
    search = {"moon landing": [make_result("https://www.nasa.gov/apollo11", "Apollo 11", "moon landing 1969"),
                               make_result("https://en.wikipedia.org/wiki/Apollo_11", "Apollo 11", "first landing"),
                               make_result("http://moon-hoax.example.com/fake", "it was staged", "hoax")],
              "water boils": [make_result("https://www.bbc.com/science/boiling", "Boiling", "100 degrees"),
                              make_result("https://chem.mit.edu/water", "Phase changes", "boiling water")]}
    llm = {"Extract verifiable factual claims": {"claims": claims},
           "forensic image analyst": {"fake_probability": 0.3, "reasoning": "scripted"}}
    return Providers(llm=ScriptedLLM(responses=llm), search=StaticSearch(search),
                     clip=StubClip(scripted={"moon": 0.3, "water": 0.1}),
                     asr=ScriptedASR(" ".join(s["text"] for s in segments), segments), ocr=NullOCR(),
                     face_detector=det, landmarks=lmk)


def _zoo_providers(device, dtype, hf=False):
    """The production bundle of ``providers/factory.py`` with the hermetic
    bundle's scripted LLM and search so that C3-E3 have claims: on the npz
    checkpoints (the formant ASR, the v2 OCR, the CLIP, the text encoder and
    the three vision models), or, where ``hf``, on the checkpoint tree as
    shipped here, whose ``hf/`` gives the HF text encoder and Whisper (and
    CLIP where its msgpack is there)."""
    from fvd_tpu_torch.providers.factory import production_providers

    ckpt = os.path.join(REPO, "checkpoints") if hf else _npz_checkpoints()
    prov = production_providers(ckpt, use_llm=False, use_search=False, device=device, compute_dtype=dtype)
    scripted = _hermetic_providers(prov.face_detector, prov.landmarks)
    return dataclasses.replace(prov, llm=scripted.llm, search=scripted.search)


def _hf_kinds():
    """The providers the JAX package's factory picks on this checkpoint tree:
    the HF models whose directory loads (a CLIP whose msgpack the copy left
    out does not), the npz ones otherwise."""
    hf = os.path.join(REPO, "checkpoints", "hf")
    has = {k: os.path.exists(os.path.join(hf, k, "flax_model.msgpack")) for k in ("minilm", "clip", "whisper")}
    return ("HFTextEncoder" if has["minilm"] else "JaxTextEncoder", "HFClip" if has["clip"] else "JaxClip",
            "HFWhisperASR" if has["whisper"] else "JaxASR")


def _full_dag_scheduler(root, device, dtype, bundle="hermetic"):
    """``graph.build_graph`` on ``device`` with the shipped face_ssd,
    landmarks and pose checkpoints and the hermetic bundle, or with
    :func:`_zoo_providers` for the ``zoo`` and ``hf`` bundles; runs write
    under ``root``."""
    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.runtime import Scheduler

    if bundle != "hermetic":
        prov = _zoo_providers(device, dtype, hf=bundle == "hf")
        kinds = tuple(type(getattr(prov, k)).__name__ for k in ("text_encoder", "clip", "asr"))
        check(bundle != "hf" or kinds == _hf_kinds(),
              f"full_dag hf: the factory picked {kinds}, the JAX package's picks {_hf_kinds()} on this tree")
    else:
        ckpt = os.path.join(REPO, "checkpoints")
        det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), compute_dtype=dtype, device=device)
        lmk = FANLandmarks(det, checkpoint=os.path.join(ckpt, "landmarks.npz"),
                           pose_checkpoint=os.path.join(ckpt, "pose.npz"), compute_dtype=dtype, device=device)
        prov = _hermetic_providers(det, lmk)
    cfg = default_config()
    cfg = cfg.replace(ingest=dataclasses.replace(cfg.ingest, processed_dir=os.path.join(root, "processed")),
                      fusion=dataclasses.replace(cfg.fusion, weights_path=os.path.join(root, "lr_weights.json"),
                                                 features_dir=os.path.join(root, "features")),
                      evidence=dataclasses.replace(cfg.evidence, rate_limit_s=0.0))
    return Scheduler(build_graph(cfg, prov, device=device))


def _full_dag_run(sched, root, clips, coalesced):
    """Every clip through the 16 nodes, one after another or all at once
    under the program coalescer (30 ms adaptive window), from cold caches:
    final states, the nodes done per video, wall ms per video, C1 launches and
    groups, frame uploads, landmark forwards and the tracer's spans."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.providers import coalesce, media
    from fvd_tpu_torch.runtime import Tracer, io_pool, set_tracer
    from fvd_tpu_torch.state import State

    def run(path):
        t0 = time.perf_counter()
        done, final = [], None
        for ev in sched.stream(State(input_path=path)):
            if ev.node == "__end__":
                check(ev.status == "done", f"full DAG failed on {path}: {ev.error}")
                final = ev.delta["__final_state__"]
            elif ev.status == "done":
                done.append(ev.node)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return final, done, (time.perf_counter() - t0) * 1e3

    media.clear_frame_cache()
    io_pool.clear_artifact_caches()
    tracer = set_tracer(Tracer())
    deactivate = coalesce._activate_program_coalescer(max_wait_ms=30.0) if coalesced else (lambda: None)
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        if coalesced:
            with ThreadPoolExecutor(len(clips)) as pool:
                out = list(pool.map(run, clips))
        else:
            out = [run(p) for p in clips]
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = _kernels.LAUNCHES["lipsync_score"]
    finally:
        deactivate()
        set_tracer(None)
        shutil.rmtree(os.path.join(root, "processed"), ignore_errors=True)
    finals, done, wall = zip(*out)
    counts = tracer.counts()
    return {"finals": finals, "done": done, "wall": list(wall), "total_ms": total_ms, "launches": launches,
            "c1_groups": sorted((sp.meta["n"] for sp in tracer.spans if sp.name == "coalesce/c1_lipsync"),
                                reverse=True),
            "uploads": media._device_frames.uploads, "forwards": media._landmark_share.forwards,
            "fwd_spans": (counts.get("v3/landmark_fwd", 0), counts.get("v4/landmark_fwd", 0)),
            "pose_fwd_calls": sum(1 for sp in tracer.spans if sp.name == "v4/pose_fwd"),
            "spans": {k: _span_ms(tracer, k) for k in FULL_DAG_SPANS}}


def _check_full_dag_run(r, what):
    n = len(r["finals"])
    for f, done in zip(r["finals"], r["done"]):
        check(sorted(done) == sorted(FULL_DAG_NODES), f"{what}: nodes done {sorted(done)}")
        check(len(f.blink_data) >= VIDEO_FOUND_MIN * 50 and len(f.head_pose_data) >= VIDEO_FOUND_MIN * 50,
              f"{what}: V4 gave {len(f.blink_data)} EARs and {len(f.head_pose_data)} poses of 50 samples")
        check(np.isfinite(f.fake_probability) and 0.0 < f.fake_probability < 1.0,
              f"{what}: probability {f.fake_probability}")
        check(all(np.isfinite(v) for v in f.features.values()), f"{what}: features {f.features}")
        check(len(f.claims) == 2 and len(f.evidence) == 5 and f.texture_ela_score == 0.3,
              f"{what}: {len(f.claims)} claims, {len(f.evidence)} evidence items, texture {f.texture_ela_score}")
    check(r["uploads"] == n, f"{what}: {r['uploads']} frame uploads for {n} videos")
    # one chunk per 10 s video (50 samples <= stream_chunk_frames): V3 and V4
    # each ask once, the share runs one forward, V4 runs no pose forward
    check(r["forwards"] == n and r["fwd_spans"] == (n, n),
          f"{what}: {r['forwards']} landmark forwards, spans {r['fwd_spans']}, for {n} one-chunk videos")


def _full_dag_summary(r):
    n = len(r["finals"])
    return {"median_wall_ms_per_video": statistics.median(r["wall"]), "wall_ms_all_videos": r["total_ms"],
            "lipsync_score_launches": r["launches"], "c1_group_sizes": r["c1_groups"],
            "frame_uploads_per_video": r["uploads"] / n, "landmark_forwards_per_video": r["forwards"] / n,
            "span_median_ms": r["spans"], "features": [f.features for f in r["finals"]],
            "fake_probabilities": [f.fake_probability for f in r["finals"]]}


def _pose_program_ms(clip, rounds=10):
    """Median host ms (each call ends in its fetch) of V3's landmark forward
    without and with V4's fused pose program, bf16, on one clip's 50 samples
    at 5 fps already on the card, in interleaved rounds after a warm-up: what
    sharing one program for V3 and V4 costs the landmark forward."""
    import torch

    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.providers.media import VideoReader

    ckpt = os.path.join(REPO, "checkpoints")
    det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), device="cuda")
    lmk = FANLandmarks(det, checkpoint=os.path.join(ckpt, "landmarks.npz"),
                       pose_checkpoint=os.path.join(ckpt, "pose.npz"), device="cuda")
    frames, _ = VideoReader(use_cache=False).sample(clip, range(0, 300, 6))
    dev = torch.from_numpy(frames).cuda()
    calls = {"landmarks_only": lambda: lmk.landmarks_batch(frames, device_frames=dev),
             "landmarks_and_pose": lambda: lmk.landmarks_pose_batch(frames, device_frames=dev, pose_pad=0.1)}
    times = {k: [] for k in calls}
    for r in range(rounds + 1):
        for k, fn in calls.items():
            t0 = time.perf_counter()
            fn()
            if r:
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


#: the zoo bundle's bars, card f32 against CPU f32: the scripted bundle's
#: measured gaps (5.4e-7 on lip, 5.4e-8 on the probability) with room
ZOO_FEATURE_TOL, ZOO_PROB_TOL = 1e-5, 1e-6
#: what the zoo clips say, in the tone alphabet
ZOO_SPEECH = "the moon landing happened and water boils at sea level"


def _zoo_outputs(f):
    """What the zoo's models decide, compared exactly between card and CPU:
    the transcript's segments, the OCR texts, the gesture statuses, and E1's
    ranking of each claim's evidence (E2 hands the items on in completion
    order, so the ranking is read off the relevance scores)."""
    return {"segments": [(sg["start"], sg["end"], sg["text"]) for sg in f.segments],
            "ocr": [[d["text"] for d in r["detections"]] for r in f.ocr_results],
            "gestures": [(g["frame_id"], g["status"]) for g in f.gesture_check],
            "evidence": [(c, u) for c, _, u in sorted((e["claim_text"], -e["relevance_score"], e["url"])
                                                      for e in f.evidence)]}


#: the full_dag phase's CPU runs: sync_a of the four (sync_a and dubbed until
#: the hf_train phase: a cut that pays for it)
CPU_CLIPS = slice(0, 1)
#: the clips each bundle of the full_dag phase draws and runs: the two in sync
#: (all 4 of the video phase's until the h264 phase, a cut that pays for it)
FULL_DAG_CLIPS = 2


def full_dag_phase():
    import torch

    from fvd_tpu_torch.ops.fusion import FEATURE_ORDER

    bf16, f32 = torch.bfloat16, torch.float32
    standard = [("card_bf16", "cuda", bf16, (False, True)), ("card_f32", "cuda", f32, (False,)),
                ("cpu_f32", "cpu", f32, (False,))]
    # the hf bundle runs 8 at once in the batch phase, so here it runs one at
    # a time only; the CPU runs take the clip in sync (CPU_CLIPS)
    configs = {"hermetic": standard, "zoo": standard,
               "hf": [("card_f32", "cuda", f32, (False,)), ("cpu_f32", "cpu", f32, (False,))]}
    # the hf bundle's clips say the zoo's sentence as one formant utterance (Whisper's domain)
    speech = {"hermetic": (None, "tone"), "zoo": (ZOO_SPEECH, "tone"), "hf": (ZOO_SPEECH, "formant")}
    result = {}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for bundle in ("hermetic", "zoo", "hf"):
            models = bundle != "hermetic"
            clips, _ = _video_clips(os.path.join(tmp, bundle, "clips"), *speech[bundle], n=FULL_DAG_CLIPS)
            n = len(clips)
            runs, summary = {}, {}
            for name, device, dtype, modes in configs[bundle]:
                root = os.path.join(tmp, bundle, name)
                sched = _full_dag_scheduler(root, device, dtype, bundle)
                if device == "cuda":
                    _full_dag_run(sched, root, clips[:1], coalesced=False)  # warm-up: cuDNN picks its algorithms
                for coalesced in modes:
                    mode = "coalesced" if coalesced else "one_at_a_time"
                    r = _full_dag_run(sched, root, clips[CPU_CLIPS] if device == "cpu" else clips, coalesced)
                    _check_full_dag_run(r, f"full_dag {bundle} {name} {mode}")
                    if device == "cuda":
                        if coalesced:
                            check(r["launches"] == len(r["c1_groups"]) and sum(r["c1_groups"]) == n,
                                  f"full_dag {bundle} {name} {mode}: {r['launches']} launches for C1 groups "
                                  f"{r['c1_groups']}")
                        else:
                            check(r["launches"] == n, f"full_dag {bundle} {name}: {r['launches']} launches for "
                                                      f"{n} videos")
                    runs[(name, mode)] = r
                    summary.setdefault(name, {})[mode] = _full_dag_summary(r)
                if name == "card_bf16" or (bundle == "hf" and name == "card_f32"):
                    summary[name]["profile_one_video"] = _profile_video(sched, clips[0])
                    if bundle == "hermetic":
                        summary[name]["shared_forward_ms"] = _pose_program_ms(clips[0])
            card = runs[("card_f32", "one_at_a_time")]["finals"][CPU_CLIPS]
            cpu = runs[("cpu_f32", "one_at_a_time")]["finals"]
            errs = {k: max(abs(a.features[k] - b.features[k]) for a, b in zip(card, cpu)) for k in FEATURE_ORDER}
            errs["fake_probability"] = max(abs(a.fake_probability - b.fake_probability) for a, b in zip(card, cpu))
            feature_tol, prob_tol = (ZOO_FEATURE_TOL, ZOO_PROB_TOL) if models else (DAG_FEATURE_TOL,
                                                                                     DAG_FULL_PROB_TOL)
            check(all(v <= feature_tol for k, v in errs.items() if k != "fake_probability")
                  and errs["fake_probability"] <= prob_tol, f"full_dag {bundle}, card f32 vs CPU f32: {errs}")
            out = {"clips": [os.path.basename(c) for c in clips],
                   "cpu_clips": [os.path.basename(c) for c in clips[CPU_CLIPS]], "feature_tolerance": feature_tol,
                   "prob_tolerance": prob_tol, "card_f32_vs_cpu_f32": errs, "runs": summary}
            if models:
                for a, b in zip(card, cpu):
                    check(_zoo_outputs(a) == _zoo_outputs(b),
                          f"full_dag {bundle}: card f32 and CPU f32 decide differently: {_zoo_outputs(a)} vs "
                          f"{_zoo_outputs(b)}")
                asr = "hf_whisper_flax" if bundle == "hf" and _hf_kinds()[2] == "HFWhisperASR" else "fvd_tpu_asr"
                ran = {(f.metadata.get("transcription_model"), f.metadata.get("ocr_model")) for f in card + cpu}
                check(ran == {(asr, "fvd_tpu_ocr")}, f"full_dag {bundle}: A2 and V2 ran {ran}")
                out["outputs_card_f32"] = [_zoo_outputs(f) for f in card]
                out["transcripts_card_f32"] = [f.transcript for f in card]
            if bundle == "hf":
                out["providers"] = dict(zip(("text_encoder", "clip", "asr"), _hf_kinds()))
            result[bundle] = out
            launches += sum(r["launches"] for (name, _), r in runs.items() if name.startswith("card"))
    phase("full_dag", nodes=len(FULL_DAG_NODES), **result)
    return launches


#: bench.py's real-models corpus (bench.py:338-347): one sentence per clip
BATCH_SENTENCES = (
    "the mayor said the city will cut taxes next year",
    "the river level rose two feet after the storm",
    "the new bridge opened to traffic last month",
    "the school board voted to extend the year",
    "the state added nine thousand jobs in july",
    "the court ruled the ban can not take effect",
    "the team won the final game by six points",
    "the museum opened a wing for modern art",
)
#: the batch phase's cuts: bench.py's clips are 30 s; (e)'s CLI takes 4 of
#: the 8 clips (it paid for the text phase), then 2 (it pays for the levers
#: phase); (d)'s profiled passes 2 (they paid for the fan phase), then 1
#: (they pay for decoding the mp4v corpus in every run, while (b) keeps all
#: 8 clips), and (d) runs only them (its timed 8-clip passes paid for the
#: levers phase, whose ab_bench is the per-pass A/B instrument)
BATCH_CLIP_SECONDS, BENCH_CLIP_SECONDS = 10.0, 30.0
BATCH_PROFILE_CLIPS, BATCH_CLI_CLIPS = 1, 2
#: every LR feature and the probability, coalesced against alone and card
#: against CPU, all f32: the bars of tests/test_torch_full_dag.py
BATCH_FEATURE_TOL, BATCH_PROB_TOL = 1e-4, 1e-5
#: ``--train-device``'s float32 weights against the float64 host replay
BATCH_TRAIN_TOL = 1e-6
#: the vision wrappers' group spans and their buckets (providers/coalesce.py)
BATCH_BUCKETS = {"det": 256, "lm": 512, "lmpose": 512, "pose": 512, "ocr": 256, "ocrdev": 256, "clip": 256}


def _corpus_clip(videos, i, seconds, container="mp4"):
    """Clip ``i`` of bench.py's real-models corpus: ``make_face_video`` seed
    ``i``, 320x240 at 30 fps, sentence ``i`` in the speech the shipped ASR
    checkpoint names (``asr_speech_domain``; formant phrases in the gate's
    on-windows); an odd seed's mouth moves at 0.37 Hz against the 1 Hz audio
    gate (dubbed) and its name carries "fake".  As bench.py's corpus holds it,
    ``<name>.mp4`` in ``mp4v`` encoded by the port on the card (MPEG-4 Part 2
    at vop_quant 3, an I-VOP every 12 frames, as the JAX package's
    ``write_video`` writes through OpenCV); with ``container="avi"`` the
    drawn frames in a lossless raw-RGBA AVI under that name, which reads
    without decoding (the phases that do not measure decoding keep it: see
    PERF.md §4).  In ``videos``, with its wav -> (path, speech)."""
    from fvd_tpu_torch.providers.factory import asr_speech_domain
    from fvd_tpu_torch.synthetic import FORMANT_SR, make_face_video

    domain = asr_speech_domain(os.path.join(REPO, "checkpoints"))
    speech, sr = ("formant_gated", FORMANT_SR) if domain == "formant" else ("tone", 44100)
    name = f"fake_clip{i}" if i % 2 else f"clip{i}"
    path = make_face_video(videos, name, duration=seconds, fps=30.0, width=320, height=240, sr=sr, seed=i,
                           speech_text=BATCH_SENTENCES[i], speech=speech, mouth_gate_hz=0.37 if i % 2 else None,
                           container=container, device="cuda")
    mp4 = path[:-len(f".{container}")] + ".mp4"
    os.replace(path, mp4)
    return mp4, speech


def _own_aac(src, out, signal, rate):
    """``src``'s ``mp4v`` samples written to ``out`` (``src`` itself
    allowed) with ``signal`` (float ``[n]`` or ``[n, 2]`` at ``rate``) as the
    file's own AAC-LC track (:func:`aac_writer.encode_signal`, the plain
    encoder) -> out."""
    from fvd_tpu_torch.utils import aac_writer, mp4

    data = open(src, "rb").read()
    track = mp4.parse(src, data)
    asc, units = aac_writer.encode_signal(signal, rate)
    sync = set(track.sync or range(track.frame_count))
    with mp4.Mp4Writer(out, track.width, track.height, track.fps, track.config) as w:
        for i, (o, n) in enumerate(zip(track.offsets, track.sizes)):
            w.write(data[o:o + n], sync=i in sync)
        w.add_audio(asc, rate, 1 if np.ndim(signal) == 1 else 2, units, 1024)
    return out


def _batch_corpus(root):
    """bench.py's real-models corpus at 10 s (:func:`_corpus_clip` 0-7) in
    ``root/videos``, each clip's speech its own AAC-LC track, as an upload
    carries it, and no sibling wav."""
    from fvd_tpu_torch.utils.wav import read_wav

    videos = os.path.join(root, "videos")
    clips = [_corpus_clip(videos, i, BATCH_CLIP_SECONDS) for i in range(len(BATCH_SENTENCES))]
    for path, _ in clips:
        wav = path[:-len(".mp4")] + ".wav"
        _own_aac(path, path, *read_wav(wav))
        os.remove(wav)
    return videos, [p for p, _ in clips], clips[0][1]


def _batch_config(root):
    """bench.py's config (no E1 rate limit, 4 E2 workers), writing under ``root``."""
    from fvd_tpu_torch.config import default_config

    cfg = default_config()
    return cfg.replace(ingest=dataclasses.replace(cfg.ingest, processed_dir=os.path.join(root, "processed")),
                       fusion=dataclasses.replace(cfg.fusion, weights_path=os.path.join(root, "lr_weights.json"),
                                                  features_dir=os.path.join(root, "features")),
                       evidence=dataclasses.replace(cfg.evidence, rate_limit_s=0.0, max_workers=4))


def _batch_run(providers, paths, root, device, concurrency, profile=False):
    """The clips through ``batch.run_pipeline_many`` (``concurrency`` > 1)
    or one at a time through ``batch.run_pipeline``, from cold caches: every
    video's final state (``batch``'s scheduler wrapped to keep them), the
    wall seconds, C1 launches and the tracer's spans; with ``profile``, a
    ``torch.profiler`` view of the same run instead of its timing."""
    import torch

    from fvd_tpu_torch import _kernels, batch
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.runtime import Scheduler, Tracer, io_pool, set_tracer

    finals = {}

    class Keep(Scheduler):
        def invoke(self, state):
            final = super().invoke(state)
            finals[state.input_path] = final
            return final

    cfg = _batch_config(root)

    def run():
        if concurrency > 1:
            return batch.run_pipeline_many(paths, cfg, providers, concurrency=concurrency, device=device)
        return [batch.run_pipeline(p, None, cfg, providers, device=device) for p in paths]

    from fvd_tpu_torch.providers import native_decode

    # each decode session's stats, summed by file, when it closes
    decode = {}
    decode_lock = threading.Lock()
    close = native_decode.NativeVideo.close

    def counted_close(self):
        if self._f is not None:
            with decode_lock:
                total = decode.setdefault(self.path, {"parse_s": 0.0, "recon_s": 0.0, "rgb_s": 0.0, "vops": 0,
                                                      "ranges": 0, "sessions": 0})
                for k in ("parse_s", "recon_s", "rgb_s", "vops", "ranges"):
                    total[k] += self.stats[k]
                total["sessions"] += 1
        close(self)

    # each AAC track's host seconds in IN: the whole extraction, its host parse
    from fvd_tpu_torch.providers import audio
    from fvd_tpu_torch.utils import aac

    extract, parse = audio.extract, aac.decode
    sound = {"extract_s": [], "parse": []}

    def timed_extract(*a, **k):
        t = time.perf_counter()
        try:
            return extract(*a, **k)
        finally:
            with decode_lock:
                sound["extract_s"].append(round(time.perf_counter() - t, 4))

    def timed_parse(cfg, units):
        t = time.perf_counter()
        try:
            return parse(cfg, units)
        finally:
            with decode_lock:
                sound["parse"].append((len(units), round(time.perf_counter() - t, 4)))

    audio.extract, aac.decode = timed_extract, timed_parse
    media.clear_frame_cache()
    io_pool.clear_artifact_caches()
    tracer = set_tracer(Tracer())
    batch.Scheduler = Keep
    native_decode.NativeVideo.close = counted_close
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        if profile:
            prof = _profile_top_kernels(run, (), calls=1)
            probs = [finals[p].fake_probability if p in finals else None for p in paths]
        else:
            probs = run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _kernels.LAUNCHES["lipsync_score"]
        codec_launches = {k: _kernels.LAUNCHES[k] for k in CODEC_KERNELS + AAC_KERNELS}
    finally:
        batch.Scheduler = Scheduler
        native_decode.NativeVideo.close = close
        audio.extract, aac.decode = extract, parse
        set_tracer(None)
        shutil.rmtree(os.path.join(root, "processed"), ignore_errors=True)
    check(all(p is not None for p in probs) and len(finals) == len(paths),
          f"batch: a pipeline failed ({probs}, {len(finals)} final states)")
    counts = tracer.counts()
    groups = {}
    for kind, bucket in list(BATCH_BUCKETS.items()) + [(k, None) for k in ("c1_lipsync", "v5_ela", "oe_smooth",
                                                                           "v4_smooth")]:
        spans = [sp for sp in tracer.spans if sp.name == f"coalesce/{kind}"]
        if spans:
            groups[kind] = {"groups": len(spans), "videos_per_group": sorted((sp.meta["n"] for sp in spans),
                                                                             reverse=True),
                            "items": [sp.meta["size"] for sp in spans],
                            "median_ms": statistics.median(sp.elapsed_s * 1e3 for sp in spans),
                            # when each group started running, seconds into the run
                            "starts_s": sorted(round(sp.start_s - t0, 3) for sp in spans)}
            if bucket:
                from fvd_tpu_torch.providers.coalesce import _pad_target

                groups[kind]["padded_to"] = [_pad_target(sp.meta["size"], bucket) for sp in spans]
    out = {"finals": [finals[p] for p in paths], "probs": probs, "seconds": seconds, "launches": launches,
           "codec_launches": codec_launches, "decode": sorted(decode.values(), key=lambda d: -d["parse_s"]),
           "aac": sound,
           "nodes_done": {n: counts.get(f"node/{n}", 0) for n in FULL_DAG_NODES}, "groups": groups,
           "spans": {n: _span_ms(tracer, f"node/{n}") for n in FULL_DAG_NODES}}
    if profile:
        out["profile"] = prof
    return out


def _batch_outputs(f):
    """What the recorded bundle decides, compared exactly between runs: the
    transcript and its segments, the OCR texts, the gesture statuses, V5's
    recorded scores and E1's evidence ranking (a node with nothing to do
    leaves its field empty)."""
    texture = f.texture_ela_details
    return {"transcript": f.transcript, "segments": [(sg["start"], sg["end"], sg["text"]) for sg in f.segments or []],
            "ocr": [[d["text"] for d in r["detections"]] for r in f.ocr_results or []],
            "gestures": [(g["frame_id"], g["status"]) for g in f.gesture_check or []],
            "texture": [d.get("fake_probability") for d in texture] if isinstance(texture, list) else texture,
            "evidence": [(c, u) for c, _, u in sorted((e["claim_text"], -e["relevance_score"], e["url"])
                                                      for e in f.evidence or [])]}


def _batch_compare(a, b, what):
    """Every LR feature and the probability of runs ``a`` and ``b`` (the same
    clips), and their decisions: the largest gaps; raises past the bars."""
    from fvd_tpu_torch.ops.fusion import FEATURE_ORDER

    errs = {k: max(abs(x.features[k] - y.features[k]) for x, y in zip(a, b)) for k in FEATURE_ORDER}
    errs["fake_probability"] = max(abs(x.fake_probability - y.fake_probability) for x, y in zip(a, b))
    check(all(v <= BATCH_FEATURE_TOL for k, v in errs.items() if k != "fake_probability")
          and errs["fake_probability"] <= BATCH_PROB_TOL, f"batch, {what}: {errs}")
    for x, y in zip(a, b):
        check(_batch_outputs(x) == _batch_outputs(y),
              f"batch, {what}: the runs decide differently: {_batch_outputs(x)} vs {_batch_outputs(y)}")
    return errs


def _batch_summary(r, n):
    return {"seconds": r["seconds"], "videos_per_min": n / r["seconds"] * 60.0,
            "wall_ms_per_video": r["seconds"] * 1e3 / n, "lipsync_score_launches": r["launches"],
            "codec_launches": r["codec_launches"],
            "groups": r["groups"], "node_span_median_ms": r["spans"],
            "fake_probabilities": [f.fake_probability for f in r["finals"]]}


def _zero_lr_weights(root):
    """An empty ``lr_weights.json`` in ``root``: all-zero weights, so p = 0.5
    calls every clip real and the first fake clip takes at least one update,
    whichever CLIP the checkout loads (the shipped weights may already call
    every clip right, and then nothing trains)."""
    with open(os.path.join(root, "lr_weights.json"), "w") as f:
        f.write("{}")


def _batch_cli(root, names):
    """``python -m fvd_tpu_torch.batch`` as a user runs it from ``root``:
    8 at a time, then ``--train-device`` over the feature cache it left, from
    all-zero weights; the weights against the host replay of
    ``run_local_lr(train=True)`` from the same start in the same order."""
    import glob

    from fvd_tpu_torch import batch
    from fvd_tpu_torch.ops import fusion

    env = _subprocess_env()
    out = {}
    for name, extra in (("concurrency_8", ["--concurrency", "8"]), ("train_device", ["--train-device"])):
        if name == "train_device":
            _zero_lr_weights(root)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.batch", "--videos-dir", "videos"] + extra,
                              cwd=root, env=env, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"batch cli {name}: rc {proc.returncode}: {proc.stderr[-3000:]}")
        with open(os.path.join(root, "results", "batch_results.txt")) as f:
            table = f.read()
        rows = [ln for ln in table.splitlines() if ln.split(" |")[0].strip() in names]
        check(len(rows) == len(names) and "ERROR" not in table and "Total Accuracy: " in table,
              f"batch cli {name}: results table {table!r}")
        out[name] = {"seconds": seconds, "accuracy": table.strip().splitlines()[-1],
                     "providers": [ln for ln in proc.stdout.splitlines() if ln.startswith("providers:")]}
        if name == "train_device":
            trained = [ln for ln in proc.stdout.splitlines() if ln.startswith("device-trained on")]
            check(trained and trained[0].startswith(f"device-trained on {len(names)} cached videos"),
                  f"batch cli train_device: {proc.stdout[-2000:]}")
            out[name]["trained"] = trained[0]
    # the host replay: run_local_lr's online update per video, in the feature
    # files' sorted order, until the prediction matches the label
    replay = os.path.join(root, "replay")
    shutil.copytree(os.path.join(root, "features"), os.path.join(replay, "features"))
    _zero_lr_weights(replay)
    cfg = _batch_config(replay)
    iters = []
    for path in sorted(glob.glob(os.path.join(replay, "features", "*.json"))):
        video = os.path.basename(path)[:-len(".json")]
        label = batch.get_label(video)
        n = 0
        while n < 100 and (batch.run_local_lr(video, label, False, cfg) > 0.5) != bool(label):
            batch.run_local_lr(video, label, True, cfg)
            n += 1
        iters.append(n)
    with open(os.path.join(root, "lr_weights.json")) as f, open(cfg.fusion.weights_path) as g:
        dev, host = json.load(f), json.load(g)
    gap = max(abs(dev[k] - host.get(k, 0.0)) for k in ("bias",) + fusion.FEATURE_ORDER)
    check(sum(iters) > 0 and out["train_device"]["trained"].endswith(f"iters={iters}") and gap <= BATCH_TRAIN_TOL,
          f"batch cli: --train-device {out['train_device']['trained']} vs host replay iters {iters}, |d w| {gap}")
    out["train_device"].update(host_replay_iters=iters, weights_max_abs_err=gap)
    return out


def batch_phase():
    """bench.py's real-models mode on the port: the production bundle with
    the recorded LLM and search, 8 face clips scored at once through
    ``batch.run_pipeline_many`` under cross-video coalescing."""
    import torch

    from fvd_tpu_torch import batch
    from fvd_tpu_torch.providers.factory import production_providers

    ckpt = os.path.join(REPO, "checkpoints")
    result = {"cut": {"clip_seconds": BATCH_CLIP_SECONDS, "bench_clip_seconds": BENCH_CLIP_SECONDS,
                      "profiled_clips": BATCH_PROFILE_CLIPS, "cli_clips": BATCH_CLI_CLIPS},
              "feature_tolerance": BATCH_FEATURE_TOL, "prob_tolerance": BATCH_PROB_TOL,
              "train_tolerance": BATCH_TRAIN_TOL, "tf32": False}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        videos, paths, speech = _batch_corpus(tmp)
        result["make_clips_s"] = time.perf_counter() - t0
        names = [os.path.basename(p) for p in paths]
        labels = [batch.get_label(p) for p in paths]
        check(sorted(batch.get_videos(videos)) == sorted(paths) and labels.count(1) == labels.count(0) == 4,
              f"batch: get_videos/get_label gave {batch.get_videos(videos)}, {labels}")
        result.update(clips=names, labels=labels, speech=speech, clip_fps=30.0, frame_size=[240, 320])
        n = len(paths)

        f32 = production_providers(ckpt, device="cuda", compute_dtype=torch.float32, recorded_services=True)
        result["providers"] = {k: type(getattr(f32, k)).__name__ for k in ("text_encoder", "clip", "asr", "llm",
                                                                          "search", "ocr")}
        _batch_run(f32, paths[:1], os.path.join(tmp, "warm"), "cuda", 1)  # cuDNN picks its algorithms
        a = _batch_run(f32, paths, os.path.join(tmp, "a"), "cuda", 8)
        b = _batch_run(f32, paths, os.path.join(tmp, "b"), "cuda", 1)
        del f32
        cpu = production_providers(ckpt, device="cpu", compute_dtype=torch.float32, recorded_services=True)
        c = _batch_run(cpu, paths[:1], os.path.join(tmp, "c"), "cpu", 1)   # 2 clips until hf_train
        del cpu
        for r, what in ((a, "(a) card f32, 8 at once"), (b, "(b) card f32, one at a time"),
                        (c, "(c) CPU f32, 1 clip")):
            check(all(v == len(r["finals"]) for v in r["nodes_done"].values()),
                  f"batch {what}: nodes done {r['nodes_done']}")
            check(all(np.isfinite(f.fake_probability) and 0.0 < f.fake_probability < 1.0
                      and all(np.isfinite(v) for v in f.features.values()) for f in r["finals"]),
                  f"batch {what}: {[f.features for f in r['finals']]}")
        check(b["launches"] == n, f"batch (b): {b['launches']} C1 launches for {n} videos")
        # the clips are mp4v: the card runs decode through the codec kernels,
        # each clip's VOPs up to V3's last 5 fps frame at least once (the
        # 1 fps and 5 fps grids' union, 50 frames to RGB); the CPU run
        # through the plain versions
        vops = (int(round(BATCH_CLIP_SECONDS * 30.0)) - 1) // 6 * 6 + 1
        for r, what, clips in ((a, "(a)", n), (b, "(b)", n), (c, "(c)", 0)):
            got = r["codec_launches"]
            check(got["mpeg4_recon"] >= vops * clips and got["yuv420_rgb"] >= clips and got["mpeg4_forward"] == 0
                  and got["mpeg4_parse"] >= clips and got["aac_synth"] == got["audio_resample"] == clips
                  and (clips or not any(got.values())),
                  f"batch {what}: codec launches {got} for {clips} clips (one AAC track each)")
        for k in CODEC_KERNELS + AAC_KERNELS:
            CODEC_LAUNCHES[k] += a["codec_launches"][k] + b["codec_launches"][k]
        c1 = a["groups"].get("c1_lipsync", {"groups": 0, "videos_per_group": []})
        check(a["launches"] == c1["groups"] and sum(c1["videos_per_group"]) == n,
              f"batch (a): {a['launches']} C1 launches for C1 groups {c1}")
        # the decode on the card (each video's sessions' seconds), the
        # detector groups' start times, mpeg4_parse's launches
        starts = a["groups"].get("det", {}).get("starts_s", [])
        gaps = [round(y - x, 3) for x, y in zip(starts, starts[1:])]
        spread = round(starts[-1] - starts[0], 3) if starts else None
        decode_s = [round(d["parse_s"] + d["recon_s"] + d["rgb_s"], 3) for d in a["decode"]]
        result["a_decode"] = {"per_video": [{k: round(v, 4) if isinstance(v, float) else v for k, v in d.items()}
                                            for d in a["decode"]],
                              "det_group_starts_s": starts, "det_group_spread_s": spread, "det_group_gaps_s": gaps,
                              "mpeg4_parse_launches": a["codec_launches"]["mpeg4_parse"],
                              "aac_extract_s": a["aac"]["extract_s"], "aac_parse_frames_s": a["aac"]["parse"],
                              "in_ms": a["spans"].get("IN")}
        print(f"batch (a): decode seconds a video {decode_s} (parse {[round(d['parse_s'], 3) for d in a['decode']]}),"
              f" AAC extraction seconds {a['aac']['extract_s']} (host parse {a['aac']['parse']}), detector groups "
              f"start {starts} s (spread {spread}), mpeg4_parse launches {a['codec_launches']['mpeg4_parse']}",
              flush=True)
        vision = [m for k in ("det", "lm", "lmpose") for m in a["groups"].get(k, {}).get("videos_per_group", [])]
        check(vision and max(vision) >= 2, f"batch (a): no detector or landmark group holds two videos: "
                                           f"{ {k: a['groups'].get(k) for k in ('det', 'lm', 'lmpose')} }")
        lips = [f.features["lip_sync"] for f in b["finals"]]
        sync = [v for v, lab in zip(lips, labels) if lab == 0]
        dubbed = [v for v, lab in zip(lips, labels) if lab == 1]
        check(min(sync) > max(dubbed), f"batch (b): synced clips' lip_sync {sync} not above the dubbed {dubbed}")
        result["a_vs_b"] = _batch_compare(a["finals"], b["finals"], "(a) coalesced vs (b) alone, card f32")
        result["b_vs_c"] = _batch_compare(b["finals"][:1], c["finals"], "(b) card f32 vs (c) CPU f32")
        result["outputs_b"] = [{k: o[k] for k in ("transcript", "texture", "gestures")}
                               for o in map(_batch_outputs, b["finals"])]
        result["decode"] = {"container": "mp4v (MPEG-4 Part 2) and its own AAC-LC track in MP4, written by the "
                                         "port on the card (the video) and the plain encoder (the sound)",
                            "file_bytes": [os.path.getsize(p) for p in paths],
                            "raw_bytes": 320 * 240 * 3 * int(round(BATCH_CLIP_SECONDS * 30.0))}
        result["runs"] = {"a_card_f32_concurrency_8": _batch_summary(a, n),
                          "b_card_f32_one_at_a_time": _batch_summary(b, n),
                          "c_cpu_f32_one_clip": _batch_summary(c, len(c["finals"]))}
        launches += a["launches"] + b["launches"]

        bf16 = production_providers(ckpt, device="cuda", compute_dtype=torch.bfloat16, recorded_services=True)
        _batch_run(bf16, paths[:1], os.path.join(tmp, "warm16"), "cuda", 1)
        k = BATCH_PROFILE_CLIPS
        for half, env in (("coalesced", None), ("no_coalesce", "1")):
            with _env("FVD_TPU_NO_COALESCE", env):
                d = _batch_run(bf16, paths[:k], os.path.join(tmp, f"d_{half}"), "cuda", 8, profile=True)
            check(all(v == k for v in d["nodes_done"].values()), f"batch (d) {half}: nodes done {d['nodes_done']}")
            c1 = d["groups"].get("c1_lipsync", {"groups": k})
            check(d["launches"] == (c1["groups"] if half == "coalesced" else k),
                  f"batch (d) {half}: {d['launches']} C1 launches, C1 groups {c1}")
            summary = {"clips": k, "seconds_under_profiler": d["seconds"], "lipsync_score_launches": d["launches"],
                       "codec_launches": d["codec_launches"],
                       "groups": d["groups"], "fake_probabilities": d["probs"]}
            p = d["profile"]
            summary["profile"] = {key: v for key, v in p.items() if key != "top10"}
            summary["profile"]["top10"] = p.get("top10", [])[:5]
            if "kernels_per_call" in p:
                summary["kernels_per_video"] = p["kernels_per_call"] / k
            result.setdefault("runs", {})[f"d_card_bf16_concurrency_8_{half}"] = summary
            launches += d["launches"]
        del bf16
        result["d_coalesced_vs_no_coalesce_max_prob"] = max(
            abs(x - y) for x, y in zip(result["runs"]["d_card_bf16_concurrency_8_coalesced"]["fake_probabilities"],
                                       result["runs"]["d_card_bf16_concurrency_8_no_coalesce"]["fake_probabilities"]))
        # the CLI on 2 of the clips (4 paid for the text phase, 2 for levers)
        cli_root = os.path.join(tmp, "cli")
        os.makedirs(os.path.join(cli_root, "videos"))
        for p in paths[:BATCH_CLI_CLIPS]:
            os.link(p, os.path.join(cli_root, "videos", os.path.basename(p)))
        result["e_cli"] = _batch_cli(cli_root, names[:BATCH_CLI_CLIPS])
    phase("batch", **result)
    return launches


#: the stream phase: 20 s clips (bench.py's 30 s until the hf_train phase: a
#: cut that pays for it) and the two chunk sizes
STREAM_CLIP_SECONDS = 20.0
STREAM_CHUNKS = (5.0, 2.0)
#: per progressive update, card f32 against CPU f32 and 2 s chunks against
#: 5 s: lip_sync, blink_rate and fake_probability (the kernel's bar)
STREAM_TOL = KERNEL_TOL
#: the CLI's ``--stream`` in a fresh process against the same card bf16 run
#: in this one
STREAM_CLI_TOL = 1e-4
#: the ui phase: the web server's results against the same runs made directly
UI_PROB_TOL = 1e-6
#: the ui phase's clip: one of the batch corpus at the batch phase's length
UI_CLIP_SECONDS = BATCH_CLIP_SECONDS


def _vision_providers(device, dtype):
    """The production bundle's face detector and FANLandmarks (face_ssd,
    landmarks and pose checkpoints), as ``providers/factory.py`` builds them."""
    from fvd_tpu_torch.models.face_ssd import SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.providers import Providers

    ckpt = os.path.join(REPO, "checkpoints")
    det = SSDFaceDetector(checkpoint=os.path.join(ckpt, "face_ssd.npz"), compute_dtype=dtype, device=device)
    lmk = FANLandmarks(det, checkpoint=os.path.join(ckpt, "landmarks.npz"),
                       pose_checkpoint=os.path.join(ckpt, "pose.npz"), compute_dtype=dtype, device=device)
    return Providers(face_detector=det, landmarks=lmk)


def _stream_run(providers, clip, device, chunk_seconds, cfg):
    """One clip through ``streaming.analyze_progressive`` from cold frame
    caches: the updates, the host clock at each, C1 launches and landmark
    forwards."""
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.streaming import analyze_progressive

    media.clear_frame_cache()
    _kernels.reset_launches()
    updates, stamps = [], []
    t0 = time.perf_counter()
    for u in analyze_progressive(clip, cfg, providers, chunk_seconds, device=device):
        stamps.append(time.perf_counter())  # C1's score is on the host: the card is done
        updates.append(u)
    check(updates, f"stream: no update for {clip} on {device}")
    steps = np.diff([t0] + stamps) * 1e3
    return {"updates": updates, "first_update_s": stamps[0] - t0, "median_update_ms": float(np.median(steps[1:]))
            if len(steps) > 1 else float(steps[0]), "wall_ms": (stamps[-1] - t0) * 1e3,
            "launches": _kernels.LAUNCHES["lipsync_score"], "forwards": media._landmark_share.forwards}


def _stream_summary(r, seconds):
    final = r["updates"][-1]
    return {"updates": len(r["updates"]), "first_update_s": r["first_update_s"],
            "median_update_ms": r["median_update_ms"], "wall_ms": r["wall_ms"],
            "video_s_per_wall_s": seconds / (r["wall_ms"] / 1e3), "c1_launches": r["launches"],
            "landmark_forwards_per_chunk": r["forwards"] / len(r["updates"]),
            "final": {"lip_sync": final.features["lip_sync"], "blink_rate": final.features["blink_rate"],
                      "fake_probability": final.fake_probability}}


def _check_stream_run(r, device, chunk_seconds, what):
    """The contract of every run: ceil(samples / chunk) updates whose
    fraction rises to 1, every sample scored by the last, one landmark
    forward per chunk and, on the card, one C1 launch per update."""
    ups = r["updates"]
    samples = int(STREAM_CLIP_SECONDS * 5)
    chunk = int(round(chunk_seconds * 5))
    fractions = [u.fraction for u in ups]
    check(len(ups) == -(-samples // chunk) and fractions == sorted(fractions) and abs(fractions[-1] - 1.0) <= 0.05
          and ups[-1].mouth_samples == samples and [u.chunk_index for u in ups] == list(range(len(ups))),
          f"stream {what}: {[(u.t_end, u.fraction, u.mouth_samples) for u in ups]}")
    check(r["forwards"] == len(ups), f"stream {what}: {r['forwards']} landmark forwards for {len(ups)} chunks")
    check(all(np.isfinite(u.fake_probability) and 0.0 < u.fake_probability < 1.0
              and all(np.isfinite(v) for v in u.features.values()) for u in ups), f"stream {what}: {ups[-1]}")
    if device == "cuda":
        check(r["launches"] == len(ups), f"stream {what}: {r['launches']} C1 launches for {len(ups)} updates")


def _stream_gaps(a, b):
    """Largest |d| of lip_sync, blink_rate and fake_probability, update by update."""
    return {k: max(abs((x.fake_probability if k == "fake_probability" else x.features[k])
                       - (y.fake_probability if k == "fake_probability" else y.features[k]))
                   for x, y in zip(a, b)) for k in ("lip_sync", "blink_rate", "fake_probability")}


def stream_phase():
    """Progressive analysis (``fvd_tpu_torch.streaming``) on 20 s clips of
    bench.py's corpus: the production bundle's detector and hourglass on the
    card, C1 on the card once per update."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.streaming import analyze_progressive

    seconds = STREAM_CLIP_SECONDS
    result = {"nvidia_smi": SMI_LINE, "clip_seconds": seconds, "clip_fps": 30.0, "frame_size": [240, 320],
              "tolerance": STREAM_TOL, "cli_tolerance": STREAM_CLI_TOL, "tf32": False}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        clips = {"sync": _corpus_clip(os.path.join(tmp, "videos"), 0, seconds, "avi")[0],
                 "dubbed": _corpus_clip(os.path.join(tmp, "videos"), 1, seconds, "avi")[0]}
        result["make_clips_s"] = time.perf_counter() - t0
        cfg = _batch_config(tmp)  # LR reads the shipped weights: no lr_weights.json under tmp
        runs, summary = {}, {}
        for name, device, dtype in (("card_bf16", "cuda", torch.bfloat16), ("card_f32", "cuda", torch.float32),
                                    ("cpu_f32", "cpu", torch.float32)):
            prov = _vision_providers(device, dtype)
            for chunk in STREAM_CHUNKS if device == "cuda" else STREAM_CHUNKS[:1]:
                for kind, clip in clips.items():
                    if device == "cpu" and kind != "sync":
                        continue
                    if device == "cuda":  # cuDNN picks its algorithms for this chunk's shapes
                        warm = analyze_progressive(clip, cfg, prov, chunk, device=device)
                        next(warm)
                        warm.close()
                    what = f"{name} {kind} {chunk:g} s"
                    r = _stream_run(prov, clip, device, chunk, cfg)
                    _check_stream_run(r, device, chunk, what)
                    runs[(name, kind, chunk)] = r
                    summary.setdefault(name, {})[f"{kind}_{chunk:g}s"] = _stream_summary(r, seconds)
                    if device == "cuda":
                        launches += r["launches"]
            if name == "card_bf16":  # the device's busy share over one clip, the bundle's dtype
                prof = _profile_top_kernels(_stream_run, (prov, clips["sync"], device, 5.0, cfg), calls=1)
                launches += _kernels.LAUNCHES["lipsync_score"]
                summary[name]["profile_sync_5s"] = {**prof, "top10": prof.get("top10", [])[:5]}
            del prov
        for name in ("card_bf16", "card_f32"):
            sync, dubbed = (runs[(name, k, 5.0)]["updates"][-1].features["lip_sync"] for k in ("sync", "dubbed"))
            check(sync > dubbed, f"stream {name}: the synced clip's lip_sync {sync} is not above the dubbed {dubbed}")
        vs_cpu = _stream_gaps(runs[("card_f32", "sync", 5.0)]["updates"], runs[("cpu_f32", "sync", 5.0)]["updates"])
        check(all(v <= STREAM_TOL for v in vs_cpu.values()), f"stream: card f32 vs CPU f32 per update: {vs_cpu}")
        chunks = {}
        for kind in clips:
            a, b = runs[("card_f32", kind, 2.0)]["updates"][-1], runs[("card_f32", kind, 5.0)]["updates"][-1]
            gap = _stream_gaps([a], [b])
            check(a.mouth_samples == b.mouth_samples and gap["lip_sync"] <= STREAM_TOL
                  and gap["fake_probability"] <= STREAM_TOL, f"stream {kind}: 2 s vs 5 s chunks, final: {gap}")
            chunks[kind] = gap
        result.update(runs=summary, card_f32_vs_cpu_f32=vs_cpu, card_f32_2s_vs_5s_final=chunks)

        # the CLI as a user runs it, in a fresh interpreter on the card
        env = _subprocess_env()
        cwd = os.path.join(tmp, "cli")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.cli", clips["sync"], "--stream",
                               "--chunk-seconds", "5"], cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=300)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"stream cli: rc {proc.returncode}: {proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        check(lines[-1].startswith("Fake probability: "), f"stream cli: last line {lines[-1]!r}")
        p = float(lines[-1].split(": ", 1)[1])
        ref = runs[("card_bf16", "sync", 5.0)]["updates"][-1].fake_probability
        updates = [ln for ln in lines if ln.startswith("[")]
        check(len(updates) == len(runs[("card_bf16", "sync", 5.0)]["updates"]) and abs(p - ref) <= STREAM_CLI_TOL,
              f"stream cli: {len(updates)} update lines, p {p} vs the in-process card bf16 run's {ref}")
        result["cli"] = {"seconds_with_cold_start": cli_s, "fake_probability": p, "in_process": ref,
                         "abs_diff": abs(p - ref), "update_lines": updates}
    phase("stream", **result)
    return launches


def _ui_wait(base, until, timeout=300):
    """Poll ``/status`` until ``until(snapshot)``; the snapshot."""
    import urllib.request

    deadline = time.time() + timeout
    while time.time() < deadline:
        with urllib.request.urlopen(base + "/status", timeout=30) as r:
            snap = json.loads(r.read())
        if until(snap):
            return snap
        time.sleep(0.05)
    raise AssertionError(f"ui: no end within {timeout} s: {snap}")


def _ui_request(base, path, method="GET"):
    """(status, content type, body) of one request, error statuses included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, method=method), timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def ui_phase():
    """The web UI (``fvd_tpu_torch.ui.web``) on the card: a DAG run and a
    progressive run through the server, each against the same run made
    directly; the artifact route; the terminal UI in a fresh interpreter."""
    import threading
    from urllib.parse import quote

    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.graph import NODE_ORDER, build_graph
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.providers.factory import production_providers
    from fvd_tpu_torch.runtime import Scheduler, io_pool
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.streaming import analyze_progressive
    from fvd_tpu_torch.ui.web import serve_web

    def cold():
        media.clear_frame_cache()
        io_pool.clear_artifact_caches()
        _kernels.reset_launches()

    result = {"nvidia_smi": SMI_LINE, "clip_seconds": UI_CLIP_SECONDS, "tolerance": UI_PROB_TOL, "tf32": False}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        clip, _ = _corpus_clip(os.path.join(tmp, "videos"), 0, UI_CLIP_SECONDS, "avi")
        cfg = _batch_config(tmp)
        prov = production_providers(os.path.join(REPO, "checkpoints"), use_llm=False, use_search=False,
                                    recorded_services=True, device="cuda", compute_dtype=torch.float32)
        sched = Scheduler(build_graph(cfg, prov, device="cuda"))
        cold()
        sched.invoke(State(input_path=clip))  # warm-up: cuDNN picks its algorithms
        srv, manager = serve_web(port=0, config=cfg, providers=prov, block=False, device="cuda")
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            check(manager.device == "cuda", f"ui: the manager runs on {manager.device}")
            cold()
            t0 = time.perf_counter()
            status, _, body = _ui_request(base, f"/analyze?path={quote(clip)}", "POST")
            check(status == 200 and json.loads(body) == {"started": True}, f"ui: POST /analyze gave {status} {body}")
            snap = _ui_wait(base, lambda s: not s["running"])
            server_ms = (time.perf_counter() - t0) * 1e3
            dag_launches = _kernels.LAUNCHES["lipsync_score"]
            check(snap["error"] is None and snap["result"] is not None, f"ui: the run failed: {snap['error']}")
            check(all(snap["statuses"][n] == "done" for n in NODE_ORDER), f"ui: statuses {snap['statuses']}")
            check(dag_launches == 1, f"ui: {dag_launches} C1 launches for one video through the server")
            served = snap["result"]

            # the artifact route, while this run's data_dir is the result's
            kf = served["frames"][0]["keyframe"] if served["frames"] else None
            check(kf is not None and kf.endswith(".png"), f"ui: keyframes {served['frames'][:1]}")
            status, ctype, body = _ui_request(base, "/artifact?path=" + quote(kf))
            check(status == 200 and ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n",
                  f"ui: /artifact on {kf} gave {status} {ctype} {body[:8]!r}")
            forbidden = _ui_request(base, "/artifact?path=/etc/passwd")[0]
            check(forbidden == 403, f"ui: /artifact?path=/etc/passwd gave {forbidden}")

            cold()
            t0 = time.perf_counter()
            direct = sched.invoke(State(input_path=clip))
            direct_ms = (time.perf_counter() - t0) * 1e3
            launches += dag_launches + _kernels.LAUNCHES["lipsync_score"]
            dag_gap = abs(served["fake_probability"] - direct.fake_probability)
            check(dag_gap <= UI_PROB_TOL, f"ui: the server's p {served['fake_probability']} vs the direct run's "
                                          f"{direct.fake_probability}")

            cold()
            status, _, body = _ui_request(base, f"/analyze?path={quote(clip)}&stream=true&chunk=5", "POST")
            check(status == 200 and json.loads(body) == {"started": True}, f"ui: POST stream gave {status} {body}")
            snap = _ui_wait(base, lambda s: not s["running"])
            stream_launches = _kernels.LAUNCHES["lipsync_score"]
            check(snap["error"] is None and len(snap["progressive"]) == 2 and snap["progressive"][-1]["fraction"] == 1.0,
                  f"ui: progressive run {snap['error']} {snap['progressive']}")
            check(stream_launches == 2, f"ui: {stream_launches} C1 launches for 2 progressive updates")
            cold()
            ups = list(analyze_progressive(clip, cfg, prov, 5.0, device="cuda"))
            launches += stream_launches + _kernels.LAUNCHES["lipsync_score"]
            stream_gap = abs(snap["progressive"][-1]["p"] - ups[-1].fake_probability)
            check(len(ups) == 2 and stream_gap <= UI_PROB_TOL,
                  f"ui: the server's progressive p {snap['progressive'][-1]['p']} vs analyze_progressive's "
                  f"{ups[-1].fake_probability} ({len(ups)} updates)")
        finally:
            srv.shutdown()
            srv.server_close()
            server.join(timeout=30)
        del prov, sched

        # the terminal UI as a user runs it: the path on stdin
        env = _subprocess_env()
        cwd = os.path.join(tmp, "term")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.cli", "--frontend-term"], input=clip + "\n",
                              cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        term_s = time.perf_counter() - t0
        verdict = [ln for ln in proc.stdout.splitlines() if ln.startswith("Verdict: ")]
        check(proc.returncode == 0 and len(verdict) == 1,
              f"ui: --frontend-term rc {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    result.update(dag_wall_ms={"through_server": server_ms, "direct": direct_ms},
                  fake_probability={"server": served["fake_probability"], "direct": direct.fake_probability,
                                    "abs_diff": dag_gap},
                  progressive={"server": snap["progressive"], "direct_p": ups[-1].fake_probability,
                               "abs_diff": stream_gap},
                  c1_launches={"dag_through_server": dag_launches, "progressive_through_server": stream_launches},
                  frontend_term={"seconds_with_cold_start": term_s, "verdict": verdict[0]})
    phase("ui", **result)
    return launches


def cli_phase():
    """The CLI as a user runs it, in a fresh interpreter on the card."""
    from fvd_tpu_torch.synthetic import make_face_video

    with tempfile.TemporaryDirectory() as tmp:
        clip = make_face_video(os.path.join(tmp, "clips"), "clip", duration=10.0, fps=30.0, sr=44100,
                               speech_text=ZOO_SPEECH)
        cwd = os.path.join(tmp, "run")
        os.makedirs(cwd)
        env = _subprocess_env()
        weights = os.path.join(cwd, "lr_weights.json")
        out = {}
        for name, extra in (("unlabelled", []), ("label_1", ["1"])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.cli", clip] + extra, cwd=cwd, env=env,
                                  capture_output=True, text=True, timeout=300)
            seconds = time.perf_counter() - t0
            check(proc.returncode == 0, f"cli {name}: rc {proc.returncode}: {proc.stderr[-2000:]}")
            last = proc.stdout.strip().splitlines()[-1]
            check(last.startswith("Fake probability: "), f"cli {name}: last line {last!r}")
            p = float(last.split(": ", 1)[1])
            check(0.0 <= p <= 1.0, f"cli {name}: probability {p}")
            # C2 scores with a CLIP, and the bundle names the HF models this tree loads
            check("C2: no CLIP model available" not in proc.stdout, f"cli {name}: C2 found no CLIP")
            picked = "providers: text encoder {}, CLIP {}, ASR {}".format(*_hf_kinds())
            check(picked in proc.stdout and "HFTextEncoder" in picked and "HFWhisperASR" in picked,
                  f"cli {name}: no line {picked!r} naming the HF text encoder and Whisper: {proc.stdout[-3000:]}")
            # without a key: no LLM, so C3 extracts no claims and E1 never searches
            check("providers: LLM NullLLM, search " in proc.stdout and "E1: no claims found" in proc.stdout,
                  f"cli {name}: an LLM without a key, or E1 searched: {proc.stdout[-3000:]}")
            out[name] = {"seconds": seconds, "fake_probability": p, "weights_file": os.path.exists(weights),
                         "providers": [ln for ln in proc.stdout.splitlines() if ln.startswith("providers:")]}
        check(not out["unlabelled"]["weights_file"] and out["label_1"]["weights_file"],
              f"cli: the labelled run did not write {weights}: {out}")
        with open(weights) as f, open(os.path.join(REPO, "assets", "lr_weights_pretrained.json")) as g:
            check(json.load(f) != json.load(g), "cli: the labelled run left the weights as they were")
    phase("cli", cold_start_s=out["unlabelled"]["seconds"], runs=out)


#: the train phase's parity, card against CPU from the same seeded weights on
#: the same batches.  float32 (TF32 off): the first step's loss.  Later steps'
#: float32 losses, per-tensor gradients and parameters are printed but held in
#: float64: a tensor whose gradient is a small difference of large terms (a
#: GroupNorm bias, the consistency term) differs in the third decimal between
#: two float32 summation orders, and Adam's first updates are about +-lr wherever
#: |g| >> eps, so a gradient within rounding of 0 moves a parameter either way
#: (``tests/test_torch_train_losses.py`` measured both against JAX)
TRAIN_F32_LOSS_TOL = 1e-4
TRAIN_F64_TOL = 1e-8
#: gradients that are exactly zero in exact arithmetic (the heatmap conv's bias
#: under the spatial soft-argmax), held to this share of the whole gradient
TRAIN_ZERO_GRAD = {"lmk": ("Conv_1.bias",)}
TRAIN_ZERO_GRAD_TOL = 1e-12
TRAIN_BATCH = 16
TRAIN_STEPS = 3
#: the tool's steps: 8 since the h264 phase (15 since the hf_train phase, 30
#: until then, 50 before the fan phase); over 15 steps the losses fell to
#: 41%, 14% and 11% of the first (det, lmk, pose; the h264 phase's runs)
TRAIN_CLI_STEPS = 8
TRAIN_RESUME_STEPS = 5   # 10 until the h264 phase
#: the realism levers' run of the tool (the JAX tool's flags)
TRAIN_LEVERS = ["--dense", "--photometric", "--shading", "--portrait", "--augment"]
TRAIN_LEVER_STEPS = 1    # 3 until the h264 phase


def _train_batches():
    """Three batches of each trainer from the port's generators (seeds 0-2)
    and one consistency pair batch, at the tool's sizes."""
    from fvd_tpu_torch.models.synthetic_faces import detector_batch, landmark_batch
    from fvd_tpu_torch.models.synthetic_pose import pose_batch, pose_batch_paired

    rngs = [np.random.RandomState(s) for s in range(TRAIN_STEPS)]
    return {"det": [detector_batch(r, TRAIN_BATCH)[:3] for r in rngs],
            "lmk": [landmark_batch(r, TRAIN_BATCH) for r in rngs],
            "pose": [pose_batch(r, TRAIN_BATCH)[:2] for r in rngs],
            "consistency": [pose_batch_paired(np.random.RandomState(0), max(TRAIN_BATCH // 2, 4))]}


def _train_run(name, batches, device, dtype):
    """The tool's model and Adam step for ``name`` over ``batches`` on
    ``device`` in ``dtype`` -> (losses, step-0 gradients, final parameters),
    the last two on the CPU."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import face_ssd, landmarks_fan
    from fvd_tpu_torch.models.layers import adam, adam_step

    net, loss_fn = {"det": (face_ssd.FaceSSD, face_ssd.ssd_loss),
                    "lmk": (landmarks_fan.LandmarkHourglass, landmarks_fan.landmark_loss),
                    "pose": (landmarks_fan.PoseHead, landmarks_fan.pose_loss),
                    "consistency": (landmarks_fan.PoseHead, landmarks_fan.pose_consistency_loss)}[name]
    seed = {"det": 0, "lmk": 1}.get(name, 2)
    model = weights.seeded(net(32), seed).to(device, dtype)
    opt, losses, grads = adam(model), [], None
    for b in batches:
        losses.append(adam_step(loss_fn, model, opt, *(torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
                                                       for x in b)))
        if grads is None:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return [float(x) for x in losses], grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _worst_rel(a, b, skip=()):
    """(largest relative L2 of a tensor of ``a`` to its twin in ``b``, its name);
    a tensor that is zero on both sides counts 0."""
    import torch

    worst = (0.0, "")
    for k in b:
        if k in skip:
            continue
        diff, ref = float(torch.linalg.vector_norm((a[k] - b[k]).double())), float(torch.linalg.vector_norm(b[k].double()))
        rel = 0.0 if diff == ref == 0 else diff / ref
        worst = max(worst, (rel, k))
    return worst


def _train_parity(batches, run=_train_run, zero_grad=lambda name, grads: TRAIN_ZERO_GRAD.get(name, ()),
                  tags=("f32", "f64")):
    """Card against CPU for each trainer of ``batches``, in float32 and
    float64 (``tags``); ``run`` is :func:`_train_run`, :func:`_zoo_train_run`
    or :func:`_text_train_run`, ``zero_grad(name, grads)`` the tensors whose
    gradient is zero in exact arithmetic."""
    import torch

    out = {}
    for name, b in batches.items():
        row = {}
        for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            if tag not in tags:
                continue
            t0 = time.perf_counter()
            card = run(name, b, "cuda", dt)
            t1 = time.perf_counter()
            cpu = run(name, b, "cpu", dt)
            loss_rel = [abs(x - y) / abs(y) for x, y in zip(card[0], cpu[0])]
            zero = zero_grad(name, cpu[1])
            row[tag] = {"losses_card": card[0], "losses_cpu": cpu[0], "loss_rel": loss_rel,
                        "worst_grad_rel": _worst_rel(card[1], cpu[1], zero),
                        "worst_param_rel": _worst_rel(card[2], cpu[2], zero),
                        "card_s": t1 - t0, "cpu_s": time.perf_counter() - t1}
            if tag == "f32":
                check(loss_rel[0] <= TRAIN_F32_LOSS_TOL,
                      f"train {name}: card f32 loss {card[0][0]} vs CPU {cpu[0][0]} (rel {loss_rel[0]})")
                continue
            check(max(loss_rel) <= TRAIN_F64_TOL, f"train {name}: f64 losses {card[0]} vs CPU {cpu[0]}")
            for what in ("worst_grad_rel", "worst_param_rel"):
                check(row[tag][what][0] <= TRAIN_F64_TOL, f"train {name}: f64 {what} {row[tag][what]}")
            total = sum(float(g.double().pow(2).sum()) for g in cpu[1].values()) ** 0.5
            for k in zero:
                for side in (card, cpu):
                    check(float(torch.linalg.vector_norm(side[1][k].double())) <= TRAIN_ZERO_GRAD_TOL * total,
                          f"train {name}: {k}'s gradient is not zero")
        out[name] = row
    return out


@contextlib.contextmanager
def _torch_defaults():
    """cuDNN's and cuBLAS's TF32 flags as torch starts (the port sets
    neither, so a user's ``python -m`` run of a tool has these) for the
    block, and off again after it, as ``env_phase`` set them."""
    import torch

    torch.backends.cudnn.allow_tf32 = TF32_DEFAULTS["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = TF32_DEFAULTS["matmul"]
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _tool_run(tool, args, fresh=False):
    """``python -m fvd_tpu_torch.tools.<tool> args`` on the card, its stdout
    captured: in a fresh interpreter with ``fresh`` (10-20 s more), else its
    ``main(args)`` in this process under torch's TF32 defaults -> (seconds,
    {part: its summary line's JSON}, stdout)."""
    import importlib

    if fresh:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"fvd_tpu_torch.tools.{tool}"] + args, cwd=REPO,
                              env=_subprocess_env(), capture_output=True, text=True, timeout=600)
        seconds, stdout = time.perf_counter() - t0, proc.stdout
        check(proc.returncode == 0, f"{tool} {args}: rc {proc.returncode}: {proc.stderr[-3000:]}")
    else:
        with _torch_defaults():
            _, stdout, seconds = _quiet(importlib.import_module(f"fvd_tpu_torch.tools.{tool}").main, args)
    check(stdout.startswith("device: cuda"), f"{tool} did not run on the card: {stdout[:300]}")
    summaries = {ln.split(" ", 1)[0].strip("[]"): json.loads(ln.split(" summary ", 1)[1])
                 for ln in stdout.splitlines() if " summary {" in ln}
    check(bool(summaries), f"{tool}: no summary line: {stdout[-2000:]}")
    return seconds, summaries, stdout


def train_phase():
    """The vision trainers: (a) card against CPU from the same weights and
    batches, (b) the tool on the card in a subprocess, then ``--resume`` in
    this process, (c)
    the npz files it wrote served by the providers on the card."""
    import torch

    from fvd_tpu_torch.models.face_ssd import MEAN_RGB, SSDFaceDetector
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarks
    from fvd_tpu_torch.models.synthetic_faces import detector_batch
    from fvd_tpu_torch.tools import pretrain_synthetic

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "train: TF32 must stay off for the card-vs-CPU bars")
    t0 = time.perf_counter()
    batches = _train_batches()
    data_s = time.perf_counter() - t0
    parity = _train_parity(batches)

    with tempfile.TemporaryDirectory() as tmp:
        # the one trainer still in a fresh interpreter: the ``python -m`` entry as a user runs it
        cli_s, runs, stdout = _tool_run("pretrain_synthetic", ["--batch", str(TRAIN_BATCH), "--out-dir", tmp, "--steps",
                                                              str(TRAIN_CLI_STEPS), "--consistency"], fresh=True)
        check(set(runs) == {"det", "lmk", "pose"}, f"train: summaries {sorted(runs)}: {stdout[-2000:]}")
        for name, r in runs.items():
            check(r["steps"] == TRAIN_CLI_STEPS and r["loss_last"] < r["loss_first"],
                  f"train {name}: loss {r['loss_first']} -> {r['loss_last']} over {r['steps']} steps")
        # the resume in this process: a fresh interpreter costs ~20 s here
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resumed = pretrain_synthetic.main(["--only", "det", "--resume", "--steps", str(TRAIN_RESUME_STEPS),
                                               "--batch", str(TRAIN_BATCH), "--out-dir", tmp])
        resume_s, stdout = time.perf_counter() - t0, out.getvalue()
        check(resumed["det"]["start_step"] == TRAIN_CLI_STEPS
              and f"resumed train state at step {TRAIN_CLI_STEPS}" in stdout,
              f"train: --resume did not continue from step {TRAIN_CLI_STEPS}: {stdout[:1000]}")
        check(sorted(os.listdir(os.path.join(tmp, "train_state_det"))) ==
              sorted([str(TRAIN_CLI_STEPS), str(TRAIN_CLI_STEPS + TRAIN_RESUME_STEPS)]),
              f"train: train states {os.listdir(os.path.join(tmp, 'train_state_det'))}")

        # (c) the written checkpoints serve on the card
        frames, _, _, gt = detector_batch(np.random.RandomState(7), 4)
        raw = (frames + np.asarray(MEAN_RGB)).clip(0, 255).astype(np.uint8)
        det = SSDFaceDetector(os.path.join(tmp, "face_ssd.npz"), device="cuda")
        # a 50-step detector scores below the providers' 0.5 gate: take every
        # box so that the hourglass and the pose head run
        lmk = FANLandmarks(det, os.path.join(tmp, "landmarks.npz"), pose_checkpoint=os.path.join(tmp, "pose.npz"),
                           detector_threshold=0.0, device="cuda")
        faces = det.detect_batch(raw)
        lm, poses = lmk.landmarks_pose_batch(raw)
        check(len(faces) == len(lm) == len(poses) == 4 and all(len(f) for f in lm) and all(len(f) for f in poses),
              f"train: the trained providers gave {[len(f) for f in lm]} landmark sets a frame")
        check(all(np.isfinite(p).all() for f in poses for p in f) and all(np.isfinite(x).all() for f in lm for x in f),
              "train: non-finite landmarks or poses from the trained providers")
        served = {"faces": [len(f) for f in faces], "top_scores": [f[0].confidence if f else 0.0 for f in faces],
                  "landmark_sets": [len(f) for f in lm], "poses": [len(f) for f in poses]}

        # (d) the realism levers, in this process
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            levers = pretrain_synthetic.main(TRAIN_LEVERS + ["--steps", str(TRAIN_LEVER_STEPS), "--batch",
                                                             str(TRAIN_BATCH), "--out-dir", os.path.join(tmp, "lev")])
        levers_s = time.perf_counter() - t0
        check(set(levers) == {"det", "lmk", "pose"} and all(r["steps"] == TRAIN_LEVER_STEPS for r in levers.values())
              and all(os.path.exists(os.path.join(tmp, "lev", f)) for f in ("face_ssd.npz", "landmarks.npz", "pose.npz")),
              f"train: the lever run gave {levers}")

    timing = {name: {k: r[k] for k in ("data_ms", "step_ms", "images_per_s", "loop_s", "loss_first", "loss_last")}
              for name, r in runs.items()}
    evals = {name: {k: v for k, v in r.items() if k.startswith(("eval", "consistency"))} for name, r in runs.items()}
    phase("train", nvidia_smi=SMI_LINE, batch=TRAIN_BATCH, widths=32, data_s=data_s, parity=parity,
          f32_loss_tol=TRAIN_F32_LOSS_TOL, f64_tol=TRAIN_F64_TOL, cli_steps=TRAIN_CLI_STEPS, cli_s=cli_s,
          timing=timing, eval=evals, resume_s=resume_s, resumed_from=resumed["det"]["start_step"],
          resumed_loss=[resumed["det"]["loss_first"], resumed["det"]["loss_last"]], served=served,
          levers={"argv": TRAIN_LEVERS, "steps": TRAIN_LEVER_STEPS, "s": levers_s,
                  "timing": {name: _summary_timing(r) for name, r in levers.items()}})


#: the net phase: a 10 s clip of the zoo bundle's speech through the 16 nodes,
#: the networked LLM and search (on a loopback server) against the scripted
#: ones; the probability sees the same claims, evidence and scores through the
#: same float32 card programs, so only a non-deterministic cuDNN algorithm could
#: move it
NET_CLIP_SECONDS = 10.0
NET_PROB_TOL = 1e-6
NET_CACHED = "CachedSearch(ChainSearch(SerperSearch, GoogleCSESearch, DuckDuckGoSearch))"
#: the DAG runs of the phase, one C1 launch each: the scripted bundle (a
#: warm-up), the networked one, the networked one again from the disk cache,
#: the scripted one
NET_RUNS = 4


def _net_run(prov, root, clip):
    """The clip through ``graph.build_graph`` with ``prov`` on the card, from
    cold caches -> (final state, wall ms)."""
    import torch

    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.runtime import Scheduler, io_pool
    from fvd_tpu_torch.state import State

    sched = Scheduler(build_graph(_batch_config(root), prov, device="cuda"))
    media.clear_frame_cache()
    io_pool.clear_artifact_caches()
    t0 = time.perf_counter()
    final = sched.invoke(State(input_path=clip))
    torch.cuda.synchronize()
    return final, (time.perf_counter() - t0) * 1e3


def _net_decisions(f):
    """What the LLM and search decide in a run, compared exactly (the
    evidence as a set: E2's workers finish in any order)."""
    return {"claims": [c["claim_text"] for c in f.claims],
            "evidence": sorted((e["url"], e.get("source"), round(e.get("reliability_score", -1.0), 9))
                               for e in f.evidence),
            "texture": f.texture_ela_score}


def _net_request_text(path, payload):
    """The query of a search request, the first 60 characters of a chat
    request's prompt."""
    from fvd_tpu_torch.providers.loopback import user_text

    if path == "/v1/chat/completions":
        return user_text(payload.get("messages", []))[1][:60]
    if path == "/customsearch/v1":
        return payload.get("q", [""])[0]
    return payload.get("q") if isinstance(payload, dict) else payload


def _refused_chain_ms():
    """ms for ``default_chain().search`` without keys to come back empty when
    DuckDuckGo's connection is refused (its endpoint on a closed loopback
    port); the real endpoints are never contacted."""
    import socket

    from fvd_tpu_torch.providers.search import DuckDuckGoSearch, default_chain

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    saved = DuckDuckGoSearch.ENDPOINT, {k: os.environ.pop(k, None) for k in SERVICE_KEYS + ("NO_PROXY",)}
    DuckDuckGoSearch.ENDPOINT = f"http://127.0.0.1:{port}/html/"
    os.environ["NO_PROXY"] = "127.0.0.1"
    try:
        chain = default_chain()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            check(chain.search("the moon landing happened in 1969 fact check") == [],
                  "net: the keyless chain found results on a refused port")
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        DuckDuckGoSearch.ENDPOINT = saved[0]
        os.environ.pop("NO_PROXY", None)
        os.environ.update({k: v for k, v in saved[1].items() if v is not None})
    return ms


def net_phase():
    """The production bundle with ``use_llm=True, use_search=True``: the
    OpenAI LLM and the cached Serper -> CSE -> DuckDuckGo chain pointed at a
    loopback server of fixed payloads (``providers/loopback.py``), through
    the 16 nodes on the card, against the same bundle with the scripted LLM
    and search that answer as the payloads do."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.providers import loopback
    from fvd_tpu_torch.providers.factory import production_providers
    from fvd_tpu_torch.providers.llm import OpenAILLM
    from fvd_tpu_torch.providers.search import describe
    from fvd_tpu_torch.synthetic import make_face_video

    with tempfile.TemporaryDirectory() as tmp:
        clip = make_face_video(os.path.join(tmp, "clips"), "clip", duration=NET_CLIP_SECONDS, fps=30.0, sr=44100,
                               speech_text=ZOO_SPEECH)
        cache_env = os.environ.get("FVD_SEARCH_CACHE_DIR")
        os.environ["FVD_SEARCH_CACHE_DIR"] = os.path.join(tmp, "search_cache")
        try:
            with loopback.LoopbackServices() as svc, svc.pointed():
                prov = production_providers(_npz_checkpoints(), use_llm=True, use_search=True, device="cuda",
                                            compute_dtype=torch.float32)
                check(isinstance(prov.llm, OpenAILLM) and describe(prov.search) == NET_CACHED,
                      f"net: the bundle has {type(prov.llm).__name__} and {describe(prov.search)}")
                llm, search = loopback.scripted_services()
                scripted = dataclasses.replace(prov, llm=llm, search=search)
                _kernels.reset_launches()
                _, warm_ms = _net_run(scripted, tmp, clip)  # warm-up: cuDNN picks its algorithms
                first, first_ms = _net_run(prov, tmp, clip)
                after_first = svc.counts()
                second, second_ms = _net_run(prov, tmp, clip)
                counts = svc.counts()
                requests = [(m, path, _net_request_text(path, p)) for m, path, _, p in svc.requests]
                ref, ref_ms = _net_run(scripted, tmp, clip)
                check(svc.counts() == counts, "net: the scripted run sent a request")
        finally:
            if cache_env is None:
                os.environ.pop("FVD_SEARCH_CACHE_DIR", None)
            else:
                os.environ["FVD_SEARCH_CACHE_DIR"] = cache_env
    launches = _kernels.LAUNCHES["lipsync_score"]
    check(launches == NET_RUNS, f"net: C1 launched {launches} times for {NET_RUNS} DAG runs")
    cached = {k: counts.get(k, 0) - after_first.get(k, 0) for k in counts}
    for path in ("/serper/search", "/customsearch/v1", "/html/", "/v1/chat/completions"):
        check(after_first.get(path, 0) > 0, f"net: the first run sent nothing to {path}: {after_first}")
    check(all(cached.get(p, 0) == 0 for p in ("/serper/search", "/customsearch/v1", "/html/")),
          f"net: the second run searched again past the disk cache: {cached}")
    want = _net_decisions(ref)
    check(want["claims"] == loopback.CLAIMS and want["evidence"],
          f"net: the scripted run gave {want}")
    deltas = []
    for name, f in (("first", first), ("cached", second)):
        check(_net_decisions(f) == want, f"net: the {name} run decided {_net_decisions(f)}, the scripted {want}")
        deltas.append(abs(f.fake_probability - ref.fake_probability))
        check(deltas[-1] <= NET_PROB_TOL, f"net: the {name} run's probability {f.fake_probability} vs the "
                                          f"scripted {ref.fake_probability}")
    refused = _refused_chain_ms()
    phase("net", nvidia_smi=SMI_LINE, clip_seconds=NET_CLIP_SECONDS, llm="OpenAILLM", search=NET_CACHED,
          prob_tol=NET_PROB_TOL, abs_dp=deltas, fake_probability=ref.fake_probability,
          wall_ms={"scripted_warm_up": warm_ms, "networked": first_ms, "networked_cached": second_ms,
                   "scripted": ref_ms},
          requests_first_run=after_first, requests_cached_run=cached, requests=requests,
          evidence=len(want["evidence"]), refused_chain_ms=refused,
          offline_chain="not measured: nothing here may contact a host outside the machine; the chain's "
                        "DuckDuckGo was refused on a closed loopback port instead", c1_launches=launches)
    return launches


#: the zoo_train phase: the geometries of the shipped checkpoints
#: (``asr_formant.json``, ``text_encoder.json``, ``clip.json``, ``ocr_rec``)
#: and the JAX tools' batches and learning rates
ZOO_TRAIN_BATCH = {"asr": 16, "text": 64, "clip": 32, "ctc": 32}
ZOO_TRAIN_LR = {"asr": 1e-3, "text": 3e-4, "clip": 3e-4, "ctc": 1e-3}
#: each tool's steps: 25 since the hf_train phase (50 before)
ZOO_CLI_STEPS = 25
ZOO_RESUME_STEPS = 10


def _zoo_train_batches():
    """Three batches of each zoo trainer at the tool's sizes, from seeds 0-2:
    the ASR tool's ``formant_hard`` batches, the text tool's, seeded images
    with the text tool's sentences for the CLIP, seeded lines with random
    labels for the recognizer."""
    from fvd_tpu_torch.models.encoders import MAX_TEXT_LEN
    from fvd_tpu_torch.models.ocr import CTC_VOCAB, encode_ctc_labels
    from fvd_tpu_torch.models.transformer import ByteTokenizer
    from fvd_tpu_torch.tools.pretrain_asr import MAX_TOKENS, MEL_FRAMES, Domain, asr_batch
    from fvd_tpu_torch.tools.pretrain_text_encoder import make_batch

    tok, out = ByteTokenizer(), {"asr": [], "text": [], "clip": [], "ctc": []}
    for s in range(TRAIN_STEPS):
        mel, tin, tout, _ = asr_batch(np.random.RandomState(s), ZOO_TRAIN_BATCH["asr"], tok, MEL_FRAMES, MAX_TOKENS,
                                      Domain("formant_hard", 0.002))
        out["asr"].append((mel.numpy(), tin, tout))
        out["text"].append(make_batch(np.random.RandomState(s), ZOO_TRAIN_BATCH["text"], tok, MAX_TEXT_LEN))
        rng = np.random.RandomState(100 + s)
        out["clip"].append((rng.rand(ZOO_TRAIN_BATCH["clip"], 112, 112, 3).astype(np.float32),
                            make_batch(rng, ZOO_TRAIN_BATCH["clip"], tok, MAX_TEXT_LEN)[0]))
        texts = ["".join(rng.choice(CTC_VOCAB, rng.randint(4, 21))) for _ in range(ZOO_TRAIN_BATCH["ctc"])]
        out["ctc"].append((rng.rand(ZOO_TRAIN_BATCH["ctc"], 32, 256, 1).astype(np.float32),
                           np.stack([encode_ctc_labels(t, 32) for t in texts])))
    return out


def _zoo_train_run(name, batches, device, dtype):
    """The zoo trainer ``name`` (seeded ASR and text encoder at the shipped
    geometries, the shipped CLIP and recognizer) for one Adam step per batch
    on ``device`` in ``dtype`` -> (losses, step-0 gradients, final
    parameters), the last two on the CPU."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import asr, encoders, ocr
    from fvd_tpu_torch.models.layers import adam, adam_step

    ckpt = os.path.join(REPO, "checkpoints")
    if name == "asr":
        meta = json.load(open(os.path.join(ckpt, "asr_formant.json")))
        model, loss_fn = weights.seeded(asr.AsrModel(meta["dim"], meta["depth"]), 0), asr.asr_loss
    elif name == "text":
        meta = json.load(open(os.path.join(ckpt, "text_encoder.json")))
        model = weights.seeded(encoders.TextTower(meta["dim"], meta["depth"], out_dim=meta["out_dim"]), 0)
        loss_fn = encoders.text_info_nce_loss
    elif name == "clip":
        meta = json.load(open(os.path.join(ckpt, "clip.json")))
        model = weights.load_npz(os.path.join(ckpt, "clip.npz"),
                                 encoders.ClipModel(meta["dim"], meta["depth"], meta["out_dim"]))
        loss_fn = encoders.clip_loss
    else:
        model, loss_fn = weights.load_npz(os.path.join(ckpt, "ocr_rec.npz"), ocr.CTCRecognizer(32)), ocr.ctc_loss
    model.to(device, dtype)
    opt, losses, grads = adam(model, ZOO_TRAIN_LR[name]), [], None
    for b in batches:
        args = [torch.as_tensor(x, device=device, dtype=dtype if np.asarray(x).dtype.kind == "f" else torch.long)
                for x in b]
        losses.append(adam_step(loss_fn, model, opt, *args))
        if grads is None:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return [float(x) for x in losses], grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _summary_timing(r):
    """A tool summary's steps, times, rates, losses and eval."""
    return {k: r[k] for k in r if k.endswith(("_ms", "_per_s", "_s")) or k.startswith(("loss", "eval", "steps"))}


def zoo_train_phase():
    """The ASR and text-encoder trainers and the zoo's losses: (a) card
    against CPU from the same weights and batches, (b) the two tools'
    ``main`` on the card under torch's TF32 defaults, then ``pretrain_asr
    --resume``, (c) the npz
    files they wrote served by ``JaxASR`` and ``JaxTextEncoder`` on the
    card."""
    import torch

    from fvd_tpu_torch.models.asr import JaxASR
    from fvd_tpu_torch.models.encoders import JaxTextEncoder
    from fvd_tpu_torch.models.synthetic_speech import formant_speech
    from fvd_tpu_torch.tools import pretrain_asr

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "zoo_train: TF32 must stay off for the card-vs-CPU bars")
    t0 = time.perf_counter()
    batches = _zoo_train_batches()
    data_s = time.perf_counter() - t0
    # the key projections' biases: the softmax ignores a score added to every key
    parity = _train_parity(batches, run=_zoo_train_run,
                           zero_grad=lambda name, grads: tuple(k for k in grads if k.endswith("key.bias")))

    with tempfile.TemporaryDirectory() as tmp:
        asr_npz, text_npz = os.path.join(tmp, "asr_formant.npz"), os.path.join(tmp, "text_encoder.npz")
        asr_args = ["--batch", str(ZOO_TRAIN_BATCH["asr"]), "--dim", "192", "--depth", "4", "--domain",
                    "formant_hard", "--out", asr_npz]
        runs = {"asr": _tool_run("pretrain_asr", ["--steps", str(ZOO_CLI_STEPS)] + asr_args),
                "text": _tool_run("pretrain_text_encoder", ["--steps", str(ZOO_CLI_STEPS), "--out", text_npz])}
        runs = {name: (r[0], r[1][name], r[2]) for name, r in runs.items()}
        for name, (_, r, _) in runs.items():
            check(r["steps"] == ZOO_CLI_STEPS and r["loss_last"] < r["loss_first"],
                  f"zoo_train {name}: loss {r['loss_first']} -> {r['loss_last']} over {r['steps']} steps")
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resumed = pretrain_asr.main(["--steps", str(ZOO_RESUME_STEPS), "--resume"] + asr_args)
        resume_s, stdout = time.perf_counter() - t0, out.getvalue()
        check(f"resumed params from {asr_npz}" in stdout and resumed["steps"] == ZOO_RESUME_STEPS
              and resumed["loss_first"] < runs["asr"][1]["loss_first"],
              f"zoo_train: --resume did not continue from the trained weights: {stdout[:1000]}")
        with open(asr_npz.replace(".npz", ".json")) as f:
            sidecar = json.load(f)
        check(sidecar["domain"] == "formant" and sidecar["train_domain"] == "formant_hard",
              f"zoo_train: sidecar {sidecar}")

        # (c) the written checkpoints serve on the card
        audio = formant_speech("the city", np.random.RandomState(0))
        audio = np.concatenate([np.zeros(8000, np.float32), audio, np.zeros(8000, np.float32)])
        transcripts = {d: JaxASR.from_checkpoint(asr_npz, device=d).transcribe(None, audio=audio)
                       for d in ("cuda", "cpu")}
        check(all(isinstance(t, dict) and isinstance(t["text"], str) for t in transcripts.values()),
              f"zoo_train: transcripts {transcripts}")
        enc = {d: JaxTextEncoder(checkpoint=text_npz, dim=192, depth=4, out_dim=256, device=d)
               for d in ("cuda", "cpu")}
        emb = {d: e.encode_batch(ZOO_SENTENCES) for d, e in enc.items()}
        emb_d = float(np.abs(emb["cuda"] - emb["cpu"]).max())
        check(np.isfinite(emb["cuda"]).all() and emb_d <= MODEL_TOL,
              f"zoo_train: text encoder card vs CPU |d| {emb_d}")
        ranks = (emb["cuda"] @ emb["cuda"].T).argsort(axis=1)[:, ::-1][:, 1].tolist()

    timing = {name: _summary_timing(r) for name, (_, r, _) in runs.items()}
    phase("zoo_train", nvidia_smi=SMI_LINE, batch=ZOO_TRAIN_BATCH, data_s=data_s, parity=parity,
          f32_loss_tol=TRAIN_F32_LOSS_TOL, f64_tol=TRAIN_F64_TOL, cli_steps=ZOO_CLI_STEPS,
          cli_s={name: r[0] for name, r in runs.items()}, timing=timing, resume_s=resume_s,
          resumed_loss=[resumed["loss_first"], resumed["loss_last"]],
          served={"transcripts": {d: t["text"] for d, t in transcripts.items()},
                  "text_encoder_card_vs_cpu": emb_d, "nearest_sentence": ranks})


#: the dryrun_multichip runs of the parallel phase: (ranks, the backend they
#: must pick on a one-card machine)
PARALLEL_RUNS = ((1, "nccl"), (4, "gloo"))
#: C1 launches of one dryrun_multichip: check 6 runs the DAG once alone and
#: once under the mesh, one launch each; the ranks' SP scoring is plain torch
PARALLEL_C1_LAUNCHES = 2


def parallel_phase():
    """``entry.dryrun_multichip`` on the card: one NCCL rank, then four gloo
    ranks sharing the card with a four-entry inference mesh."""
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.entry import dryrun_multichip

    runs, launches = {}, 0
    for n, backend in PARALLEL_RUNS:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        r = dryrun_multichip(n, device="cuda")
        seconds = time.perf_counter() - t0
        check(r["backend"] == backend, f"parallel: dryrun_multichip({n}) ran under {r['backend']}, not {backend}")
        c1 = _kernels.LAUNCHES["lipsync_score"]
        check(c1 == PARALLEL_C1_LAUNCHES, f"parallel: dryrun_multichip({n}) launched C1 {c1} times, "
                                          f"not {PARALLEL_C1_LAUNCHES}")
        launches += c1
        ranks = f"{n} {backend} rank(s) on {','.join(r['devices'])}"
        in_process = f"in-process mesh of {','.join(r['devices'])}"
        runs[f"n{n}"] = {
            "backend": r["backend"], "seconds": seconds, "c1_launches": c1,
            "checks": {name: {**{k: v for k, v in c.items() if k in ("delta", "ms", "boxes", "scores", "coords",
                                                                       "loss", "loss0", "loss1", "p_single",
                                                                       "p_mesh", "scale", "mesh", "ways")},
                              "on": in_process if name in ("sharded", "fan", "dag") else ranks}
                       for name, c in r["checks"].items()}}
    phase("parallel", nvidia_smi=SMI_LINE, runs=runs,
          multi_card="not run: this machine has one card; the ranks share it")
    return launches


#: the corpus phase's labeled corpus: 2 real, 2 fake, 1 ambiguous and 1 hard
#: real clip of 3 s at 30 fps and 320x240 (10 s until the h264 phase, a cut
#: that pays for it; the JAX experiment's corpus holds 12-23 of them), and the
#: trajectory's trained runs after the baseline
CORPUS_FAMILIES = {"n_real": 2, "n_fake": 2, "n_ambiguous": 1, "n_hard_real": 1}
CORPUS_CLIP_SECONDS = 3.0
CORPUS_RUNS = 3
#: (c)'s two lever clips, each cut to 2 s (5 until the h264 phase) under its
#: own seed: the texture fake (FAKE_RECIPES[1]) and the first hard real
CORPUS_LEVER_SECONDS = 2.0
#: (d)'s calibration corpus: 1 real, 2 fakes, 1 hard real of 2 s (5 until the
#: h264 phase) for train and again for validation (the JAX tool's default is
#: 18 of 10 s each)
CORPUS_CALIBRATE = ["--n-real", "1", "--n-fake", "2", "--ambiguous", "0", "--hard-reals", "1", "--duration", "2"]


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output caught -> (result, output, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue(), time.perf_counter() - t0


def _corpus_trajectory(root):
    """``accuracy_trajectory.main`` in process on the corpus in
    ``root/videos``: a baseline run and ``CORPUS_RUNS`` trained runs with
    the shipped bundle (bf16) and the recorded services -> the order the
    harness takes the clips in (online SGD depends on it), per run its
    accuracy line, seconds and every clip's probability, run 0's features,
    the C1 launches."""
    from fvd_tpu_torch import _kernels, batch
    from fvd_tpu_torch import providers as tprov
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.runtime import io_pool
    from fvd_tpu_torch.tools import accuracy_trajectory

    seconds = []
    batch_main = batch.main

    def timed(argv):
        t0 = time.perf_counter()
        try:
            return batch_main(argv)
        finally:
            seconds.append(time.perf_counter() - t0)

    cwd, bundle = os.getcwd(), (tprov._default, tprov._default_is_custom)
    batch.main = timed
    media.clear_frame_cache()
    io_pool.clear_artifact_caches()
    try:
        _kernels.reset_launches()
        rc, out, _ = _quiet(accuracy_trajectory.main, ["--workdir", root, "--runs", str(CORPUS_RUNS),
                                                       "--baseline-eval"])
        launches = _kernels.LAUNCHES["lipsync_score"]
    finally:
        batch.main = batch_main
        os.chdir(cwd)
        tprov._default, tprov._default_is_custom = bundle
        media.clear_frame_cache()
        io_pool.clear_artifact_caches()
    check(rc == 0, f"corpus (b): accuracy_trajectory returned {rc}: {out[-3000:]}")
    order = [os.path.basename(p) for p in batch.get_videos(os.path.join(root, "videos"))]
    probs, wrong = [], []
    for run in range(CORPUS_RUNS + 1):
        with open(os.path.join(root, "results", f"batch_results{run}.txt")) as f:
            table = f.read()
        rows = [[c.strip() for c in ln.split("|")] for ln in table.splitlines() if ln.startswith("clip")]
        check([r[0] for r in rows] == order and all(0.0 <= float(r[2]) <= 1.0 for r in rows),
              f"corpus (b): run {run}'s table does not score every clip in the order {order}: {table}")
        probs.append({r[0]: float(r[2]) for r in rows})
        wrong.append([r[0] for r in rows if r[4] == "WRONG"])
    features = {}
    for name in order:
        with open(os.path.join(root, "features", f"{name}.json")) as f:
            features[name] = json.load(f)
    runs = [ln for ln in out.splitlines() if ln.startswith("run ")]
    check(len(runs) == CORPUS_RUNS + 1 and len(seconds) == CORPUS_RUNS + 1, f"corpus (b): {runs}, {seconds}")
    check(launches >= len(order), f"corpus (b): {launches} C1 launches for {len(order)} clips' first runs")
    lines = out.strip().splitlines()
    return {"order": order, "runs": [{"line": r, "seconds": s, "wrong": w, "probabilities": p}
                                     for r, s, w, p in zip(runs, seconds, wrong, probs)],
            "run0_features": features, "trajectory": lines[-2], "attempts": lines[-1],
            "lipsync_score_launches": launches}


def _corpus_levers(root):
    """(c): a texture fake and a hard real of ``CORPUS_LEVER_SECONDS``
    through the 16 nodes, card f32 against CPU f32 at the batch phase's
    bars -> the gaps and the card run's C1 launches."""
    import torch

    from fvd_tpu_torch.providers.factory import production_providers
    from fvd_tpu_torch.tools.make_labeled_corpus import (FAKE_RECIPES, HARD_REAL_RECIPES, SENTENCES, corpus_speech,
                                                         write_clip)

    ckpt = os.path.join(REPO, "checkpoints")
    speech = corpus_speech()
    hard_real, exclamation = HARD_REAL_RECIPES[0]
    paths = [write_clip(os.path.join(root, "videos"), name, speech, duration=CORPUS_LEVER_SECONDS, fps=30.0,
                        seed=seed, speech_text=text, **levers)
             for name, seed, text, levers in (("lever_texture_deepfake", 600, SENTENCES[1], FAKE_RECIPES[1]),
                                              ("lever_sensor_real_vlog", 601, exclamation, hard_real))]
    card = production_providers(ckpt, device="cuda", compute_dtype=torch.float32, recorded_services=True)
    a = _batch_run(card, paths, os.path.join(root, "card"), "cuda", 1)
    del card
    cpu = production_providers(ckpt, device="cpu", compute_dtype=torch.float32, recorded_services=True)
    b = _batch_run(cpu, paths, os.path.join(root, "cpu"), "cpu", 1)
    del cpu
    for r, what in ((a, "card f32"), (b, "CPU f32")):
        check(all(v == len(paths) for v in r["nodes_done"].values()), f"corpus (c) {what}: {r['nodes_done']}")
    check(a["launches"] == len(paths), f"corpus (c): {a['launches']} C1 launches for {len(paths)} clips")
    errs = _batch_compare(a["finals"], b["finals"], "corpus (c) lever clips, card f32 vs CPU f32")
    return {"clips": [os.path.basename(p) for p in paths], "card_vs_cpu": errs,
            "fake_probabilities": {"card": a["probs"], "cpu": b["probs"]},
            "texture": [f.features["texture"] for f in a["finals"]], "seconds": {"card": a["seconds"],
                                                                                "cpu": b["seconds"]},
            "lipsync_score_launches": a["launches"]}


def _corpus_calibrate(root):
    """(d): ``calibrate_lr.main`` on the card on a small corpus, then
    ``--refit-from-meta`` on what it wrote, which must give the same vector."""
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.tools import calibrate_lr

    out = os.path.join(root, "cal.json")
    _kernels.reset_launches()
    rc, log, seconds = _quiet(calibrate_lr.main, CORPUS_CALIBRATE + ["--out", out])
    launches = _kernels.LAUNCHES["lipsync_score"]
    check(rc == 0, f"corpus (d): calibrate_lr returned {rc}: {log[-3000:]}")
    with open(out) as f:
        vector = json.load(f)
    with open(out.replace(".json", "_meta.json")) as f:
        meta = json.load(f)
    n = len(meta["train"]["videos"]) + len(meta["val"]["videos"])
    check(n == 8 and launches == n, f"corpus (d): {launches} C1 launches for {n} clips")
    bad = {k: vector[k] for k, sign in calibrate_lr.SIGN.items() if vector[k] * sign < 0}
    check(not bad, f"corpus (d): the vector breaks the sign constraints: {bad}")
    rc, refit_log, _ = _quiet(calibrate_lr.main, ["--refit-from-meta", "--out", out])
    with open(out) as f:
        refit = json.load(f)
    check(rc == 0 and refit == vector, f"corpus (d): the refit gave {refit} against {vector}: {refit_log}")
    return {"seconds": seconds, "train_acc": meta["train_acc"], "val_acc": meta["val_acc"], "vector": vector,
            "train_videos": meta["train"]["videos"], "val_videos": meta["val"]["videos"],
            "lines": [ln for ln in log.splitlines() if ln.startswith(("train acc", "val acc", "  clip"))],
            "lipsync_score_launches": launches}


def corpus_phase():
    """The labeled-corpus experiment on the card: (a) a corpus of every
    family from ``make_labeled_corpus.build_corpus``, (b)
    ``accuracy_trajectory`` on it, (c) two lever clips card against CPU,
    (d) ``calibrate_lr`` and its refit."""
    from fvd_tpu_torch import batch
    from fvd_tpu_torch.tools.make_labeled_corpus import build_corpus

    result = {"cut": {"families": CORPUS_FAMILIES, "clip_seconds": CORPUS_CLIP_SECONDS, "trained_runs": CORPUS_RUNS,
                      "lever_clip_seconds": CORPUS_LEVER_SECONDS, "calibrate": " ".join(CORPUS_CALIBRATE)},
              "feature_tolerance": BATCH_FEATURE_TOL, "prob_tolerance": BATCH_PROB_TOL}
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "traj")
        t0 = time.perf_counter()
        paths = build_corpus(os.path.join(traj, "videos"), CORPUS_FAMILIES["n_real"], CORPUS_FAMILIES["n_fake"],
                             CORPUS_CLIP_SECONDS, n_ambiguous=CORPUS_FAMILIES["n_ambiguous"],
                             n_hard_real=CORPUS_FAMILIES["n_hard_real"])
        result["make_clips_s"] = time.perf_counter() - t0
        names = [os.path.basename(p) for p in paths]
        labels = [batch.get_label(p) for p in paths]
        want = [0 if "_real_" in n else 1 for n in names]
        check(labels == want == [0, 0, 1, 1, 1, 0], f"corpus (a): labels {dict(zip(names, labels))}")
        result.update(clips=names, labels=labels)
        result["b_trajectory"] = _corpus_trajectory(traj)
        shutil.rmtree(traj)
        result["c_levers"] = _corpus_levers(os.path.join(tmp, "levers"))
        result["d_calibrate"] = _corpus_calibrate(tmp)
    phase("corpus", **result)
    return (result["b_trajectory"]["lipsync_score_launches"] + result["c_levers"]["lipsync_score_launches"]
            + result["d_calibrate"]["lipsync_score_launches"])


#: the text phase: the OCR and CLIP trainers and the held-out evaluation.
#: Data draws are timed at the tools' batch; card against CPU at the shipped
#: recognizer and CLIP geometries and the v2 detector at width 32 (batch 8:
#: float64 convolutions at 256x256 on the CPU); the tools 20 steps
TEXT_BATCH = 32
TEXT_PARITY_BATCH = {"rec": 32, "det_v2": 8, "clip": 32}
TEXT_LR = {"rec": 1e-3, "det_v2": 1e-3, "clip": 3e-4}
TEXT_CLI_STEPS = 20
TEXT_RESUME_STEPS = 5
TEXT_EVAL_N = 16
#: the held-out evaluation on the card against the CPU: the recognizer's
#: exact-match rate and character accuracy within one line of 16, the v2
#: detector's mask IoU (bfloat16: pixels near the threshold may flip)
TEXT_EVAL_OCR_TOL, TEXT_EVAL_IOU_TOL = 1.0 / TEXT_EVAL_N, 0.01
#: the floor of ``tests/test_models.py::test_ocr_detector_heldout_font_floor``
#: (n 16, seed 19: ``eval_ocr_det``'s held-out column)
TEXT_HELDOUT_IOU_FLOOR = 0.85


def _text_train_batches(names=("rec", "det_v2", "clip")):
    """Three batches of each text trainer from the port's generators (seeds
    0-2; the second augmented where the generator can)."""
    from fvd_tpu_torch.models.encoders import MAX_TEXT_LEN
    from fvd_tpu_torch.models.synthetic_text import detector_batch, recognizer_batch
    from fvd_tpu_torch.models.transformer import ByteTokenizer
    from fvd_tpu_torch.tools.pretrain_clip import clip_batch

    tok, out = ByteTokenizer(), {}
    for name in names:
        b = TEXT_PARITY_BATCH[name]
        draw = {"rec": lambda r, aug: recognizer_batch(r, b, augment=aug)[:2],
                "det_v2": lambda r, aug: detector_batch(r, b, augment=aug),
                "clip": lambda r, aug: clip_batch(r, b, tok, MAX_TEXT_LEN)[:2]}[name]
        out[name] = [draw(np.random.RandomState(s), s == 1) for s in range(TRAIN_STEPS)]
    return out


def _text_train_run(name, batches, device, dtype):
    """The text trainer ``name`` (the tools' seeded recognizer at width 32,
    v2 detector at width 32 computing in ``dtype``, CLIP at 128 / 4) for one
    Adam step per batch on ``device`` in ``dtype`` -> (losses, step-0
    gradients, final parameters), the last two on the CPU."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import encoders, ocr
    from fvd_tpu_torch.models.layers import adam, adam_step

    model, loss_fn = {"rec": lambda: (weights.seeded(ocr.CTCRecognizer(32), 0), ocr.ctc_loss),
                      "det_v2": lambda: (weights.seeded(ocr.TextRegionNetV2(32, compute_dtype=dtype), 1),
                                         ocr.detector_loss),
                      "clip": lambda: (weights.seeded(encoders.ClipModel(128, 4, 128), 0), encoders.clip_loss)}[name]()
    model.to(device, dtype)
    opt, losses, grads = adam(model, TEXT_LR[name]), [], None
    for b in batches:
        args = [torch.as_tensor(x, device=device, dtype=dtype if np.asarray(x).dtype.kind == "f" else torch.long)
                for x in b]
        losses.append(adam_step(loss_fn, model, opt, *args))
        if grads is None:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return [float(x) for x in losses], grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def text_phase():
    """The OCR and CLIP trainers and the held-out evaluation on the card:
    (a) the host data draws timed at the tools' batch, (b) card against CPU
    over three Adam steps in float64 for the recognizer, the v2 detector and
    CLIP, (c) ``pretrain_ocr`` (both parts, v2 at the shipped width 128) and
    ``pretrain_clip`` at the shipped geometries, then ``pretrain_ocr --only
    rec --resume``, (d) ``eval_heldout`` over all five models on the shipped
    checkpoints, the OCR columns against the CPU; each tool through its
    ``main`` in this process under torch's TF32 defaults."""
    import torch

    from fvd_tpu_torch.models.synthetic_text import detector_batch, recognizer_batch
    from fvd_tpu_torch.tools import eval_heldout, pretrain_ocr

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "text: TF32 must stay off for the card-vs-CPU bars")
    result = {"nvidia_smi": SMI_LINE, "cut": {"cli_steps": TEXT_CLI_STEPS, "resume_steps": TEXT_RESUME_STEPS,
                                              "eval_n": TEXT_EVAL_N}}
    draw_ms = {}
    for what, fn in (("rec", lambda r: recognizer_batch(r, TEXT_BATCH)),
                     ("rec_augment", lambda r: recognizer_batch(r, TEXT_BATCH, augment=True)),
                     ("det", lambda r: detector_batch(r, TEXT_BATCH))):
        t0 = time.perf_counter()
        fn(np.random.RandomState(0))
        draw_ms[what] = (time.perf_counter() - t0) * 1e3
    result["a_draw_ms_per_batch"] = draw_ms

    t0 = time.perf_counter()
    batches = _text_train_batches()
    result["b_data_s"] = time.perf_counter() - t0
    result["b_parity"] = _train_parity(batches, run=_text_train_run, tags=("f64",),
                                       zero_grad=lambda name, grads: tuple(k for k in grads if k.endswith("key.bias")))

    with tempfile.TemporaryDirectory() as tmp:
        ocr_dir, clip_npz = os.path.join(tmp, "ocr"), os.path.join(tmp, "clip", "clip.npz")
        common = ["--batch", str(TEXT_BATCH), "--out-dir", ocr_dir]
        runs = {"ocr": _tool_run("pretrain_ocr", ["--steps", str(TEXT_CLI_STEPS), "--det-steps", str(TEXT_CLI_STEPS),
                                                  "--det-arch", "v2"] + common),
                "clip": _tool_run("pretrain_clip", ["--steps", str(TEXT_CLI_STEPS), "--batch", str(TEXT_BATCH),
                                                    "--dim", "128", "--depth", "4", "--out", clip_npz])}
        parts = {**runs["ocr"][1], **runs["clip"][1]}
        check(set(parts) == {"rec", "det", "clip"}, f"text: summaries {sorted(parts)}")
        for name, r in parts.items():
            check(r["steps"] == TEXT_CLI_STEPS and r["loss_last"] < r["loss_first"], f"text {name}: summary {r}")
        with open(os.path.join(ocr_dir, "ocr_det.json")) as f:
            sidecar = json.load(f)
        check(sidecar == {"arch": "v2", "width": 128}, f"text: ocr_det.json {sidecar}")
        with open(clip_npz.replace(".npz", ".json")) as f:
            clip_meta = json.load(f)
        check(np.isfinite([clip_meta["cal_offset"], clip_meta["cal_scale"]]).all(), f"text: clip.json {clip_meta}")
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resumed = pretrain_ocr.main(["--only", "rec", "--resume", "--steps", str(TEXT_RESUME_STEPS)] + common)
        resume_s, stdout = time.perf_counter() - t0, out.getvalue()
        rec_npz = os.path.join(ocr_dir, "ocr_rec.npz")
        check(f"resumed params from {rec_npz}" in stdout and resumed["rec"]["steps"] == TEXT_RESUME_STEPS
              and resumed["rec"]["loss_first"] < parts["rec"]["loss_first"],
              f"text: --resume did not continue from the trained weights: {stdout[:1000]}")
        result["c_cli_s"] = {name: r[0] for name, r in runs.items()}
        result["c_timing"] = {name: _summary_timing(r) for name, r in parts.items()}
        result["c_eval_lines"] = [ln for name in ("ocr", "clip") for ln in runs[name][2].splitlines()
                                  if " eval" in ln]
        result["c_resume"] = {"s": resume_s, "loss": [resumed["rec"]["loss_first"], resumed["rec"]["loss_last"]]}

    with _torch_defaults():
        card, stdout, result["d_eval_s"] = _quiet(eval_heldout.main, ["--n", str(TEXT_EVAL_N)])
    check(stdout.startswith("device: cuda"), f"eval_heldout did not run on the card: {stdout[:300]}")
    check(set(card) == set(eval_heldout.EVALS), f"eval_heldout printed {sorted(card)}")
    check(all(np.isfinite([r["in_domain"], r["held_out"]]).all() for r in card.values()), f"eval_heldout: {card}")
    t0 = time.perf_counter()
    cpu = {name: eval_heldout.EVALS[name](TEXT_EVAL_N, device="cpu") for name in ("ocr", "ocr_det")}
    result["d_cpu_ocr_s"] = time.perf_counter() - t0
    for name, keys, tol in (("ocr", ("in_domain", "held_out", "char_in_domain", "char_held_out"), TEXT_EVAL_OCR_TOL),
                            ("ocr_det", ("in_domain", "held_out"), TEXT_EVAL_IOU_TOL)):
        for k in keys:
            check(abs(card[name][k] - cpu[name][k]) <= tol, f"eval_heldout {name} {k}: card {card[name][k]}, "
                                                           f"CPU {cpu[name][k]}")
    check(card["ocr_det"]["held_out"] >= TEXT_HELDOUT_IOU_FLOOR,
          f"eval_heldout: held-out-font detection IoU {card['ocr_det']['held_out']}")
    result["d_eval"] = {"card": card, "cpu": cpu}
    phase("text", **result)


#: the fan phase: (b)'s chain, the CPU test's (``tests/test_torch_pretrain_fan.py``)
#: at the tool's 256-px crops, so that the first steps clip and move the weights
FAN_PARITY = {"width": 32, "stacks": 2, "batch": 2, "lr": 1e-2, "warmup": 2}
#: the host-bound tool loop at the full geometry: a handful of steps
FAN_CLI_STEPS = 6
FAN_DATA_BATCH = POSE50_BATCH = 16
POSE50_CPU_BATCH = 4
#: PoseResNet50 card f32 against CPU f32 (TF32 off): 16 GroupNorm'd
#: bottlenecks to a 6D output of |d6| ~ 1 (the CPU test's bar against flax)
POSE50_TOL = 1e-4


def _fan_batches():
    """Three batches of ``pretrain_fan``'s data (seeds 0-2) at (b)'s size."""
    from fvd_tpu_torch.models.synthetic_faces import landmark_batch
    from fvd_tpu_torch.tools.pretrain_fan import TRAIN_DATA

    return {"fan": [landmark_batch(np.random.RandomState(s), FAN_PARITY["batch"], **TRAIN_DATA)
                    for s in range(TRAIN_STEPS)]}


def _fan_train_run(name, batches, device, dtype):
    """``pretrain_fan``'s loss and clipped AdamW on its warmup-cosine
    schedule at ``FAN_PARITY`` from seeded weights, one step per batch on
    ``device`` in ``dtype`` -> (losses, the first step's clipped
    gradients, final parameters), the last two on the CPU."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarkNet
    from fvd_tpu_torch.models.optim import adamw_warmup_cosine, clipped_adamw_step
    from fvd_tpu_torch.tools.pretrain_fan import fan_loss

    model = weights.seeded(FANLandmarkNet(FAN_PARITY["width"], FAN_PARITY["stacks"]), 0).to(device, dtype)
    opt, sched = adamw_warmup_cosine(model, FAN_PARITY["lr"], FAN_PARITY["warmup"], len(batches))
    losses, grads = [], None
    for b in batches:
        losses.append(clipped_adamw_step(fan_loss, model, opt, sched,
                                         *(torch.as_tensor(np.asarray(x), dtype=dtype, device=device) for x in b)))
        if grads is None:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return [float(x) for x in losses], grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _tiny_grads(name, grads):
    """The tensors whose gradient is zero in exact arithmetic, by their
    size against the whole (the last heatmap bias; conv biases ahead of a
    GroupNorm of one channel per group)."""
    total = sum(float(g.double().pow(2).sum()) for g in grads.values()) ** 0.5
    return tuple(k for k, g in grads.items() if float(g.double().norm()) <= TRAIN_ZERO_GRAD_TOL * total)


def _pose50_outputs(device, dtype, crops):
    """``PoseResNet50`` from seeded weights computing in ``dtype`` on
    ``device`` -> (the model, its 6D output of ``crops`` on the CPU)."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models.landmarks_fan import PoseResNet50

    model = weights.seeded(PoseResNet50(compute_dtype=dtype), 0).to(device).eval()
    with torch.no_grad():
        return model, model(torch.from_numpy(crops).to(device)).float().cpu().numpy()


def fan_phase():
    """The face-data realism levers' host cost, ``pretrain_fan`` and
    ``PoseResNet50`` on the card."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models.landmarks_fan import FANLandmarkNet
    from fvd_tpu_torch.models.optim import adamw_warmup_cosine, clipped_adamw_step
    from fvd_tpu_torch.models.synthetic_faces import detector_batch, landmark_batch
    from fvd_tpu_torch.tools import pretrain_fan

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "fan: TF32 must stay off for the card-vs-CPU bars")
    result = {"nvidia_smi": SMI_LINE, "cut": {"cli_steps": FAN_CLI_STEPS, "parity": FAN_PARITY}}
    draw_ms = {}
    for what, fn in (("detector_dense_all_levers_300", lambda r: detector_batch(
                         r, FAN_DATA_BATCH, augment=True, photometric=True, dense=True, shaded=True, portrait=True)),
                     ("landmark_fan_256", lambda r: landmark_batch(r, FAN_DATA_BATCH, **pretrain_fan.TRAIN_DATA))):
        t0 = time.perf_counter()
        fn(np.random.RandomState(0))
        draw_ms[what] = (time.perf_counter() - t0) * 1e3
    result["a_draw_ms_per_batch"] = draw_ms

    t0 = time.perf_counter()
    batches = _fan_batches()
    result["b_data_s"] = time.perf_counter() - t0
    result["b_parity"] = _train_parity(batches, run=_fan_train_run, tags=("f64",), zero_grad=_tiny_grads)

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(REPO, "checkpoints", "landmarks.npz"), os.path.join(tmp, "landmarks.npz"))
        out = os.path.join(tmp, "fan_landmarks.npz")
        t0 = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            summary = pretrain_fan.main(["--steps", str(FAN_CLI_STEPS), "--batch", str(FAN_DATA_BATCH), "--out", out])
        result["c_s"] = time.perf_counter() - t0
        lines = stdout.getvalue().splitlines()
        check(lines[0].startswith("device: cuda") and "FAN-geometry params: 12.2M" in lines[1],
              f"pretrain_fan: {lines[:2]}")
        check(summary["steps"] == FAN_CLI_STEPS and np.isfinite([summary["loss_first"], summary["loss_last"]]).all(),
              f"pretrain_fan: summary {summary}")
        paired = summary["paired_eval_pct_crop"]
        check(all(np.isfinite(v) for split in paired.values() for v in split.values())
              and paired["clean"]["shipped_128px"] < 3.0,
              f"pretrain_fan: paired evaluation {paired}")
        with open(out.replace(".npz", ".json")) as f:
            check(json.load(f)["paired_eval_pct_crop"] == paired, "pretrain_fan: the sidecar's paired evaluation")
        result["c_summary"] = summary
        result["c_lines"] = [ln for ln in lines if ln.startswith(("[fan] step", "  "))]

    # (c) where a step's device time goes: one step of the tool's model,
    # chain and batch size under the profiler, after two to warm up
    model = weights.seeded(FANLandmarkNet(compute_dtype=torch.bfloat16), 0).cuda()
    opt, sched = adamw_warmup_cosine(model, 3e-4, 200, 3000)
    batch = [torch.from_numpy(x).cuda() for x in landmark_batch(np.random.RandomState(0), FAN_DATA_BATCH,
                                                                  **pretrain_fan.TRAIN_DATA)]

    def step():
        return clipped_adamw_step(pretrain_fan.fan_loss, model, opt, sched, *batch)

    step(), step()
    result["c_step_profile"] = _profile_top_kernels(step, (), calls=1)
    del model, opt, sched, batch

    rng = np.random.RandomState(0)
    crops = rng.rand(POSE50_BATCH, 224, 224, 3).astype(np.float32)
    pose = {}
    for tag, dt in (("bf16", torch.bfloat16), ("f32", None)):
        model, pose[tag] = _pose50_outputs("cuda", dt, crops)
        x = torch.from_numpy(crops).cuda()

        def call(model=model, x=x):
            with torch.no_grad():
                return model(x)

        pose[f"{tag}_row"] = _model_row(call)
        del model
    _, cpu = _pose50_outputs("cpu", None, crops[:POSE50_CPU_BATCH])
    gap = float(np.abs(pose["f32"][:POSE50_CPU_BATCH] - cpu).max())
    check(gap <= POSE50_TOL and np.isfinite(pose["bf16"]).all(), f"PoseResNet50 card f32 vs CPU f32: {gap}")
    result["d_pose50"] = {"batch": POSE50_BATCH, "bf16": pose["bf16_row"], "f32": pose["f32_row"],
                          "card_f32_vs_cpu_f32_max_abs": gap, "cpu_batch": POSE50_CPU_BATCH,
                          "card_bf16_vs_card_f32_max_abs": float(np.abs(pose["bf16"] - pose["f32"]).max()),
                          "tolerance": POSE50_TOL}
    phase("fan", **result)


#: the hf_train phase: (a)'s small geometries (BERT 2 x 64, CLIP --tiny,
#: Whisper d64 2 + 2 with vocab 600), three steps of each tool's loss and
#: chain at a learning rate that moves the weights after a one-step warmup
HF_PARITY = {"batch": {"minilm": 8, "clip": 6, "whisper": 2}, "lr": 1e-3, "warmup": 1}
#: (b): the tools at the full geometry, a handful of steps each, inside
#: their default warmups (a fresh AdamW at full rate on a trained model
#: takes ~lr steps on every weight and undoes it); the pools cut from the
#: tools' 1 600 phrases and 2 304 text scenes
HF_TRAIN_STEPS = 10
HF_TRAIN_BATCH = {"minilm": 96, "whisper": 8, "clip": 128}
HF_TRAIN_POOL = {"whisper": 128, "clip": 256}
#: (c): the shipped Whisper's held-out phrases decoded on the CPU too (a cut
#: of the tool's 64: the CPU's float32 encoder takes ~0.4 s a canvas)
HF_EVAL_CPU_PHRASES = 8
#: (c): MiniLM's held-out embeddings, card f32 (TF32 off) against CPU f32
HF_EMBED_TOL = 1e-4
#: the decay of the parameters no loss reaches (BERT's pooler, Whisper's
#: frozen encoder positions) against optax's product of (1 - lr * 0.01)
HF_DECAY_TOL = 1e-12
_HF_PARITY_CASES = {}
_HF_DECAY = {}


def _hf_parity_cases(root):
    """(a)'s three models (float32, CPU) and their three batches, built once:
    -> {name: (model factory, loss, batches, the frozen parameter or None)}."""
    import torch

    from fvd_tpu_torch.models.hf_bert import BertModel
    from fvd_tpu_torch.models.hf_clip import CLIPModel
    from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration
    from fvd_tpu_torch.ops.whisper_frontend import mel_filter_bank
    from fvd_tpu_torch.tools import hf_train, make_hf_geometry_checkpoints as makers
    from fvd_tpu_torch.tools import pretrain_hf_clip as hc, pretrain_hf_minilm as hm, pretrain_hf_whisper as hw
    from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer

    if _HF_PARITY_CASES:
        return _HF_PARITY_CASES
    hf = os.path.join(REPO, "checkpoints", "hf")
    b = HF_PARITY["batch"]
    cfg = hf_train.read_config(os.path.join(hf, "minilm"))
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128)
    bert_sd = makers.init_state_dict(BertModel(cfg, unused=True), "bert", cfg, 0)
    tok = Tokenizer.from_dir(os.path.join(hf, "minilm"))
    rng = np.random.RandomState(7)

    def bert():
        m = BertModel(cfg, unused=True)
        m.load_state_dict(bert_sd)
        return m

    _HF_PARITY_CASES["minilm"] = (bert, hm.minilm_loss, [hm.make_batch(rng, b["minilm"], tok) for _ in range(3)],
                                  "pooler.dense.weight")

    makers.make_clip(os.path.join(root, "clip"), tiny=True)
    ctok = Tokenizer.from_dir(os.path.join(root, "clip"))
    imgs, caps = hc.build_pool(np.random.RandomState(0), 8, 2, 2)
    enc = ctok(caps, hc.MAX_LEN)
    rng = np.random.RandomState(7)
    bw, bt = 2.0, 0.35
    _HF_PARITY_CASES["clip"] = (
        lambda: hf_train.load_for_training(CLIPModel, "clip", os.path.join(root, "clip"), "cpu", None),
        lambda m, idx, pool, ids, mask: hc.clip_step_loss(m, pool, ids, mask, idx, bw, bt, []),
        [(hc.sample_batch(rng, b["clip"], 8, 2, 2), imgs, enc["input_ids"], enc["attention_mask"])
         for _ in range(3)], None)

    makers.make_whisper(os.path.join(root, "whisper"), d_model=64, layers=2, heads=2, ffn=128, vocab_size=600)
    wtok = Tokenizer.from_dir(os.path.join(root, "whisper"))
    texts = hw.gen_phrases(np.random.RandomState(0), 8)
    mel = torch.from_numpy(mel_filter_bank().astype(np.float32))
    pool = hw.pool_power_mels(hw.render_pool(texts, np.random.RandomState(0)), mel).numpy()
    rng = np.random.RandomState(7)
    batches = []
    for _ in range(3):
        idx, off, dec_in, labels, mask, _ = hw.sample_batch(
            rng, b["whisper"], len(texts), texts, lambda t: [i for i in wtok.encode_ids(t) if i > 1])
        batches.append((pool, idx, off, dec_in, labels, mask))
    _HF_PARITY_CASES["whisper"] = (
        lambda: hf_train.load_for_training(WhisperForConditionalGeneration, "whisper", os.path.join(root, "whisper"),
                                           "cpu", None),
        hw.whisper_step_loss, batches, "model.encoder.embed_positions.weight")
    return _HF_PARITY_CASES


def _hf_train_run(name, batches, device, dtype):
    """One of (a)'s models for one step of its tool's loss and the HF
    tools' clipped AdamW per batch on ``device`` in ``dtype`` -> (losses,
    step-0 gradients, final parameters); the frozen parameter's decay
    against optax's goes into ``_HF_DECAY``."""
    import torch

    from fvd_tpu_torch.models.optim import clipped_adamw_step
    from fvd_tpu_torch.tools import hf_train

    make, loss_fn, _, frozen = _HF_PARITY_CASES[name]
    model = make().to(device, dtype)
    opt, sched = hf_train.hf_optimizer(model, HF_PARITY["lr"], HF_PARITY["warmup"], len(batches))
    p0 = model.get_parameter(frozen).detach().clone() if frozen else None
    factor, losses, grads = 1.0, [], None
    for b in batches:
        args = [torch.as_tensor(np.asarray(x), device=device,
                                dtype=dtype if np.asarray(x).dtype.kind == "f" else
                                torch.uint8 if np.asarray(x).dtype == np.uint8 else torch.long) for x in b]
        factor *= 1.0 - sched.get_last_lr()[0] * 0.01
        losses.append(clipped_adamw_step(loss_fn, model, opt, sched, *args))
        if grads is None:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    if frozen:
        p = model.get_parameter(frozen).detach()
        _HF_DECAY[(name, device)] = float(torch.linalg.vector_norm(p - p0 * factor) / torch.linalg.vector_norm(p0))
    return [float(x) for x in losses], grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _hf_tool(module, argv):
    """``module.run(argv)`` in this process, its stdout captured ->
    (seconds, model, summary, replay, lines)."""
    t0 = time.perf_counter()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        model, summary, replay = module.run(argv)
    lines = stdout.getvalue().splitlines()
    check(lines[0].startswith("device: cuda"), f"{module.__name__}: {lines[:2]}")
    return time.perf_counter() - t0, model, summary, replay, lines


def _hf_written(model, family, out, promoted):
    """The msgpack the tool wrote, read back through the port, against the
    trained parameters (exactly), and ``--promote``'s copy: float16 for
    MiniLM and CLIP, the directory as it is for Whisper."""
    import torch

    from fvd_tpu_torch.utils.msgpack import leaves, read_msgpack
    from fvd_tpu_torch.weights import hf_state_dict

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    back = hf_state_dict(read_msgpack(os.path.join(out, "flax_model.msgpack")), family, unused=True)
    check(back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd),
          f"{family}: the written msgpack differs from the trained parameters")
    tree = read_msgpack(os.path.join(promoted, "flax_model.msgpack"))
    if family == "whisper":   # the JAX tool's --promote copies the directory as it is
        check({str(v.dtype) for _, v in leaves(tree)} == {"float32"}, "whisper: --promote's copy")
    else:
        check({str(v.dtype) for _, v in leaves(tree)} == {"float16"}, f"{family}: --promote wrote other than float16")
        half = hf_state_dict(tree, family, unused=True)
        check(all(torch.equal(half[k], sd[k].half().float()) for k in sd), f"{family}: --promote's values")
    return {"leaves": len(sd), "promoted_mib": os.path.getsize(os.path.join(promoted, "flax_model.msgpack")) / 2 ** 20}


def _hf_shipped_eval(root):
    """(c): the shipped MiniLM's and Whisper's held-out evaluation before any
    step, the models in float32 (TF32 off), card against CPU."""
    import torch

    from fvd_tpu_torch.models.hf_bert import BertModel
    from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration
    from fvd_tpu_torch.ops.whisper_frontend import mel_filter_bank
    from fvd_tpu_torch.tools import hf_train, pretrain_hf_minilm as hm, pretrain_hf_whisper as hw
    from fvd_tpu_torch.utils.hf_tokenizers import Tokenizer

    hf = os.path.join(REPO, "checkpoints", "hf")
    out = {}
    tok = Tokenizer.from_dir(os.path.join(hf, "minilm"))
    q_ids, q_mask, _, _ = hm.make_batch(np.random.RandomState(10_000), 64, tok)
    emb, acc = {}, {}
    for d in ("cuda", "cpu"):
        model = hf_train.load_for_training(BertModel, "bert", os.path.join(hf, "minilm"), d, None)
        with torch.no_grad():
            emb[d] = hm.embed(model, torch.from_numpy(q_ids).to(d), torch.from_numpy(q_mask).to(d)).cpu()
        acc[d] = hm.evaluate(model, tok, 0, d)
    gap = float((emb["cuda"] - emb["cpu"]).abs().max())
    check(gap <= HF_EMBED_TOL and acc["cuda"] == acc["cpu"], f"minilm held-out card vs CPU: {gap}, {acc}")
    out["minilm"] = {"retrieval_at_1": acc, "embedding_max_abs_err": gap, "tolerance": HF_EMBED_TOL}

    wtok = Tokenizer.from_dir(os.path.join(hf, "whisper"))
    rng = np.random.RandomState(0)
    eval_texts = hw.gen_phrases(rng, 64, taken=hw.gen_phrases(rng, HF_TRAIN_POOL["whisper"]))
    audio = hw.render_pool(eval_texts, np.random.RandomState(1), hard_frac=0.0)
    res = {}
    for d in ("cuda", "cpu"):
        model = hf_train.load_for_training(WhisperForConditionalGeneration, "whisper", os.path.join(hf, "whisper"),
                                           d, None)
        pool = hw.pool_power_mels(audio, torch.from_numpy(mel_filter_bank().astype(np.float32)).to(d))
        with contextlib.redirect_stdout(io.StringIO()):
            res[d] = hw.evaluate(model, wtok, pool, eval_texts, n=HF_EVAL_CPU_PHRASES)
    n = HF_EVAL_CPU_PHRASES
    check(abs(res["cuda"][0] - res["cpu"][0]) <= 1.0 / n and abs(res["cuda"][1] - res["cpu"][1]) <= 1.0 / n,
          f"whisper held-out card vs CPU: {res}")
    out["whisper"] = {"phrases": n, "exact_char": res}
    return out


def hf_train_phase():
    """The HF trainers: (a) three steps of each tool's loss and chain, card
    against CPU in float64 at small geometries, the pooler's and the frozen
    positions' decay against optax's; (b) each tool at the full geometry in
    this process (MiniLM and Whisper resumed from copies of the shipped
    checkpoints, CLIP fabricated by the port's maker), its files read back
    and promoted; (c) the shipped MiniLM's and Whisper's held-out evaluation
    before any step, card f32 against CPU f32."""
    import torch

    from fvd_tpu_torch.models.hf_bert import BertModel
    from fvd_tpu_torch.models.hf_clip import CLIPModel
    from fvd_tpu_torch.models.hf_whisper import WhisperForConditionalGeneration
    from fvd_tpu_torch.providers.hf_models import HFClip, HFTextEncoder, HFWhisperASR
    from fvd_tpu_torch.tools import hf_train, make_hf_geometry_checkpoints as makers
    from fvd_tpu_torch.tools import pretrain_hf_clip as hc, pretrain_hf_minilm as hm, pretrain_hf_whisper as hw

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "hf_train: TF32 must stay off for the card-vs-CPU bars")
    result = {"nvidia_smi": SMI_LINE, "cut": {"steps": HF_TRAIN_STEPS, "batch": HF_TRAIN_BATCH, "pool": HF_TRAIN_POOL,
                                              "cpu_eval_phrases": HF_EVAL_CPU_PHRASES, "parity": HF_PARITY}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cases = _hf_parity_cases(os.path.join(tmp, "parity"))
        result["a_setup_s"] = time.perf_counter() - t0
        result["a_parity"] = _train_parity({k: v[2] for k, v in cases.items()}, run=_hf_train_run, tags=("f64",),
                                           zero_grad=_tiny_grads)
        for key, rel in _HF_DECAY.items():
            check(rel <= HF_DECAY_TOL, f"hf_train {key}: the frozen parameter's decay is {rel} off optax's")
        result["a_decay_rel"] = {f"{k[0]}_{k[1]}": v for k, v in _HF_DECAY.items()}

        hf = os.path.join(REPO, "checkpoints", "hf")
        common = ["--steps", str(HF_TRAIN_STEPS), "--eval-every", "0", "--save-every", "0"]
        runs = {}
        for name, module, family, cls, extra, provider in (
                ("minilm", hm, "bert", BertModel, ["--resume"], HFTextEncoder),
                ("whisper", hw, "whisper", WhisperForConditionalGeneration,
                 ["--resume", "--pool", str(HF_TRAIN_POOL["whisper"])], HFWhisperASR),
                ("clip", hc, "clip", CLIPModel, ["--pool", str(HF_TRAIN_POOL["clip"])], HFClip)):
            out, promoted = os.path.join(tmp, name), os.path.join(tmp, f"{name}_f16")
            if "--resume" in extra:
                shutil.copytree(os.path.join(hf, name), out)
            seconds, model, summary, replay, lines = _hf_tool(
                module, common + extra + ["--batch", str(HF_TRAIN_BATCH[name]), "--out", out, "--promote", promoted])
            check(summary["steps"] == HF_TRAIN_STEPS and np.isfinite(summary["loss_curve"]).all(),
                  f"pretrain_hf_{name}: losses {summary['loss_curve']}")
            written = _hf_written(model, family, out, promoted)
            # the losses fall: the mean loss over the run's batches, before
            # (the shipped weights, or the maker's again) and after training
            t1 = time.perf_counter()
            trained = replay(model)
            del model
            if "--resume" in extra:
                start = hf_train.load_for_training(cls, family, os.path.join(hf, name), "cuda")
            else:   # the maker's weights again, without writing them
                cfg = makers.clip_config()
                start = hf_train.training_model(cls, family, cfg, torch.bfloat16)
                start.load_state_dict(makers.init_state_dict(start, family, cfg, 0))
                start = start.cuda()
            before = replay(start)
            del start
            check(trained < before, f"pretrain_hf_{name}: the run's batches' loss {before} -> {trained}")
            written["replayed_loss"] = {"before": before, "after": trained, "s": time.perf_counter() - t1}
            t1 = time.perf_counter()
            served = provider.from_local(out, device="cuda")
            written["provider_load_s"] = time.perf_counter() - t1
            with open(os.path.join(out, "fvd_train_meta.json")) as f:
                written["meta_keys"] = sorted(json.load(f))
            del served
            torch.cuda.empty_cache()
            runs[name] = {"s": seconds, "summary": summary, "written": written,
                          "lines": [ln for ln in lines if ln.startswith(("[", "    ", "pool", "render"))][-8:]}
        result["b_tools"] = runs
        t0 = time.perf_counter()
        result["c_shipped_eval"] = _hf_shipped_eval(tmp)
        result["c_s"] = time.perf_counter() - t0
    phase("hf_train", **result)


#: the eval phase: the paired gates and the diagnostic tools at reduced
#: counts (the JAX tools' defaults: 64 utterances, 64 x 4 ranking tasks, 24
#: scenes, 64 + 12 utterances and sentences, 8 s clips, 64 faces, 30 s)
EVAL_ASR_N = 16
EVAL_TEXT = ["--n", "32", "--rounds", "1"]
EVAL_CLIP_N = 8
EVAL_WHISPER = ["--n", "16", "--n-sentences", "2"]
EVAL_PIPELINE_SECONDS = 4.0
EVAL_DIAGNOSE_N = 16
EVAL_PROFILE = ["--duration", "10", "--fps", "30"]
#: the debug run repro_node reads: a synthetic clip of this many seconds at 30 fps
EVAL_REPRO_SECONDS = 10.0
#: ``eval_heldout``'s face bars (``tests/test_torch_eval_heldout.py`` FACE_TOL),
#: held here by the diagnose tools' rows card f32 against CPU f32: IoU, % of
#: the crop, degrees
DIAGNOSE_TOL = {"det": 0.005, "lmk": 0.03, "pose": 0.01}
#: the shipped checkpoints on their own domains at these counts (CPU runs of
#: the tools: formant ASR base exact 0.8125, Whisper base char 0.96, clip.npz
#: retrieval@1 0.857 at n 4): floors well under them, so a checkpoint or
#: a decode that broke shows
EVAL_ASR_EXACT_FLOOR = 0.5
EVAL_CHAR_FLOOR = 0.5
EVAL_CLIP_R1_FLOOR = 0.5
#: eval_pipeline_paired rounds each lip score to 4 decimals: the two sides'
#: separations on the same detector and hourglass agree to within two such
#: roundings
EVAL_SEPARATION_TOL = 2e-4
#: the fields C1 reads, and those LR reads less C2's and V5's outputs (LR
#: recovers those from the run's debug files)
REPRO_C1_KEYS = ("face_detections", "mouth_landmarks", "metadata", "audio_envelope")
REPRO_LR_KEYS = ("input_path", "metadata", "segments", "word_count", "lip_sync_score", "blink_data",
                 "head_pose_data", "claims", "evidence")


def _eval_tool(main, argv, json_path):
    """A paired tool's ``main(argv + --json)`` in this process -> (rc, its
    JSON, stdout, seconds)."""
    rc, out, seconds = _quiet(main, argv + ["--json", json_path])
    with open(json_path) as f:
        return rc, json.load(f), out, seconds


def _eval_gates(tmp, ckpt):
    """(a)-(e): the paired gates on the card -> {tool: result}, the C1
    launches of eval_pipeline_paired."""
    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.tools import eval_asr_paired, eval_asr_whisper_paired, eval_clip_paired
    from fvd_tpu_torch.tools import eval_pipeline_paired, eval_text_paired
    from fvd_tpu_torch.tools import make_hf_geometry_checkpoints as makers

    out = {}
    asr = os.path.join(ckpt, "asr_formant.npz")
    copy = os.path.join(tmp, "asr_copy.npz")
    shutil.copy(asr, copy)
    shutil.copy(asr.replace(".npz", ".json"), copy.replace(".npz", ".json"))
    rc, res, log, s = _eval_tool(eval_asr_paired.main, ["--old", asr, "--new", copy, "--n", str(EVAL_ASR_N)],
                                 os.path.join(tmp, "asr.json"))
    check(rc == 0 and res["adopt"] is False and "paired verdict: REJECT" in log, f"eval_asr_paired: {res}")
    for fam in ("base", "hard"):
        check(res[f"{fam}_old"] == res[f"{fam}_new"], f"eval_asr_paired: one checkpoint decoded apart: {res}")
    check(res["base_old"]["exact"] >= EVAL_ASR_EXACT_FLOOR, f"eval_asr_paired: base family {res['base_old']}")
    out["asr"] = {"s": s, "result": res}

    argv = ["--new", os.path.join(ckpt, "hf", "minilm"), "--old", os.path.join(ckpt, "text_encoder.npz")] + EVAL_TEXT
    rc, card, _, s = _eval_tool(eval_text_paired.main, argv, os.path.join(tmp, "text.json"))
    rc_cpu, cpu, _, s_cpu = _eval_tool(eval_text_paired.main, argv + ["--cpu"], os.path.join(tmp, "text_cpu.json"))
    check(rc == rc_cpu == 0 and card == cpu and isinstance(card["meets_verdict_gate"], bool),
          f"eval_text_paired: card {card}, CPU {cpu}")
    out["text"] = {"s": s, "cpu_s": s_cpu, "result": card}

    t0 = time.perf_counter()
    clip_dir = os.path.join(tmp, "hf_clip")
    makers.make_clip(clip_dir)   # ViT-B/32, random weights: the copy leaves the shipped msgpack out
    make_s = time.perf_counter() - t0
    rc, res, log, s = _eval_tool(eval_clip_paired.main, ["--new", clip_dir, "--old", os.path.join(ckpt, "clip.npz"),
                                                         "--n", str(EVAL_CLIP_N)], os.path.join(tmp, "clip.json"))
    shutil.rmtree(clip_dir)
    check(rc == 0 and set(res) == {"new", "old", "meets_verdict_gate"}
          and all(np.isfinite(list(m.values())).all() for m in (res["new"], res["old"])), f"eval_clip_paired: {res}")
    check(res["old"]["retrieval_at_1"] >= EVAL_CLIP_R1_FLOOR and res["meets_verdict_gate"] is False,
          f"eval_clip_paired: the trained CLIP against random ViT-B/32 weights: {res}")
    out["clip"] = {"make_s": make_s, "s": s, "result": res}

    argv = ["--whisper", os.path.join(ckpt, "hf", "whisper"), "--old", asr] + EVAL_WHISPER
    rc, res, log, s = _eval_tool(eval_asr_whisper_paired.main, argv, os.path.join(tmp, "whisper.json"))
    utt = res["utterance"]
    check(rc == 0 and min(utt["old"]["char"], utt["new"]["char"]) >= EVAL_CHAR_FLOOR
          and 0.0 <= min(res["transcript"]["old_word_acc"], res["transcript"]["new_word_acc"])
          and isinstance(res["meets_verdict_gate"], bool), f"eval_asr_whisper_paired: {res}")
    out["whisper"] = {"s": s, "result": res, "lines": [ln for ln in log.splitlines() if ln.startswith(("[", "    "))]}

    ssd = os.path.join(tmp, "face_ssd_copy.npz")
    shutil.copy(os.path.join(ckpt, "face_ssd.npz"), ssd)
    _kernels.reset_launches()
    argv = ["--override", f"face_ssd.npz={ssd}", "--duration", str(EVAL_PIPELINE_SECONDS)]
    rc, res, log, s = _eval_tool(eval_pipeline_paired.main, argv, os.path.join(tmp, "pipe.json"))
    launches = _kernels.LAUNCHES["lipsync_score"]
    sep = res["lip_separation"]
    check(rc == 0 and res["contract_ok"] and launches == 4, f"eval_pipeline_paired: rc {rc}, {launches} C1 launches "
                                                           f"for 4 DAG runs: {res}")
    check(abs(sep["old"] - sep["new"]) <= EVAL_SEPARATION_TOL,
          f"eval_pipeline_paired: one detector and hourglass, separations {sep}")
    out["pipeline"] = {"s": s, "result": res, "lipsync_score_launches": launches,
                       "providers": sorted({ln for ln in log.splitlines() if ln.startswith("providers: text")})}
    return out, launches


def _eval_diagnose():
    """(f)-(g): the diagnose tools' tables on the card, and each row card
    f32 against CPU f32 -> their results."""
    import torch

    from fvd_tpu_torch import weights
    from fvd_tpu_torch.models import face_ssd
    from fvd_tpu_torch.tools import diagnose_det_heldout as dd, diagnose_lmkpose_heldout as dl
    from fvd_tpu_torch.tools.eval_heldout import CKPT

    n = ["--n", str(EVAL_DIAGNOSE_N)]
    det, det_log, det_s = _quiet(dd.main, n)
    lmkpose, lmk_log, lmk_s = _quiet(dl.main, n)
    check(list(det) == list(lmkpose) == [name for name, _ in dd.CASES] and len(det_log.splitlines()) == 6
          and len(lmk_log.splitlines()) == 7, f"diagnose: tables\n{det_log}\n{lmk_log}")
    t0 = time.perf_counter()
    params = weights.read_npz(os.path.join(CKPT, "face_ssd.npz"))
    ssd = {d: face_ssd.from_params(params, d) for d in ("cuda", "cpu")}
    models = {d: dl.load_models(None, None, d) for d in ("cuda", "cpu")}
    gaps = {}
    for name, factors in dd.CASES:
        frames, gts = dd.case_frames(EVAL_DIAGNOSE_N, factors)
        crops, targets = dl.lmk_crops(EVAL_DIAGNOSE_N, factors)
        pcrops, eulers = dl.pose_crops(EVAL_DIAGNOSE_N, factors)
        row = {d: (dd.mean_iou(ssd[d], frames, gts, torch.float32),
                   dl.lmk_error(models[d][0], crops, targets, torch.float32),
                   dl.pose_error(models[d][1], pcrops, eulers)) for d in ("cuda", "cpu")}
        gaps[name] = [abs(a - b) for a, b in zip(row["cuda"], row["cpu"])]
        for (key, tol), gap in zip(DIAGNOSE_TOL.items(), gaps[name]):
            check(gap <= tol, f"diagnose {name} {key}: card f32 {row['cuda']} against CPU f32 {row['cpu']}")
    return {"det_s": det_s, "lmkpose_s": lmk_s, "det": det, "lmkpose": lmkpose,
            "card_f32_vs_cpu_f32": gaps, "compare_s": time.perf_counter() - t0}


def _eval_dev_tools(tmp):
    """(h)-(j): profile_pipeline, repro_node and render_dag_svg on the card
    -> (their results, C1 launches)."""
    import dataclasses

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.config import default_config
    from fvd_tpu_torch.graph import NODE_ORDER, build_graph
    from fvd_tpu_torch.providers.recorded import RecordedLLM, RecordedSearch
    from fvd_tpu_torch.runtime.debug import _jsonable
    from fvd_tpu_torch.runtime.scheduler import Scheduler
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.synthetic import hermetic_providers, make_synthetic_video
    from fvd_tpu_torch.tools import profile_pipeline, render_dag_svg, repro_node

    out, cwd = {}, os.getcwd()
    _kernels.reset_launches()
    prof, log, s = _quiet(profile_pipeline.main, EVAL_PROFILE + ["--trace", os.path.join(tmp, "trace")])
    launches = {"profile": _kernels.LAUNCHES["lipsync_score"]}
    rows = [ln.split()[0] for ln in log.splitlines() if ln.startswith("node/")]
    with open(prof["trace"]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"] for e in events if str(e.get("name", "")).startswith("node/")}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(sorted(rows) == sorted(spans) == sorted(f"node/{n}" for n in NODE_ORDER) and kernels > 0
          and launches["profile"] == 2, f"profile_pipeline: rows {rows}, spans {sorted(spans)}, {kernels} kernels in "
                                        f"the trace, {launches['profile']} C1 launches for 2 runs")
    out["profile"] = {"s": s, "total_s": prof["total_s"], "trace_mib": os.path.getsize(prof["trace"]) / 2 ** 20,
                      "trace_kernels": kernels, "node_s": {k: v for k, v in prof["summary"].items()
                                                           if k.startswith("node/")}}

    run_dir = os.path.join(tmp, "run")
    os.makedirs(run_dir)
    os.chdir(run_dir)
    try:
        _kernels.reset_launches()
        clip = make_synthetic_video("media", duration=EVAL_REPRO_SECONDS, fps=30.0)
        providers = dataclasses.replace(hermetic_providers(fps=30.0, device="cuda"), llm=RecordedLLM(),
                                        search=RecordedSearch())
        dag = build_graph(default_config().replace(debug=True), providers, device="cuda")
        final = Scheduler(dag).invoke(State(input_path=clip, debug=True))
        deltas, t0 = {}, time.perf_counter()
        for node, keys, extra in (("C1", REPRO_C1_KEYS, []), ("LR", REPRO_LR_KEYS, ["--debug"])):
            path = os.path.join(tmp, f"{node}.json")
            with open(path, "w") as f:
                json.dump({k: _jsonable(getattr(final, k)) for k in keys}, f)
            deltas[node], _, _ = _quiet(repro_node.main, [node, "--data-dir", final.data_dir, "--state-json", path]
                                        + extra)
        launches["repro"] = _kernels.LAUNCHES["lipsync_score"]
    finally:
        os.chdir(cwd)
    check(deltas["C1"]["lip_sync_score"] == final.lip_sync_score != 0.0
          and deltas["LR"]["features"] == final.features and deltas["LR"]["fake_probability"] ==
          final.fake_probability and final.texture_ela_score > 0.0 and launches["repro"] == 2,
          f"repro_node: C1 {deltas['C1']}, LR {deltas['LR']} against the run's {final.lip_sync_score}, "
          f"{final.features}, {final.fake_probability}; {launches['repro']} C1 launches")
    out["repro"] = {"s": time.perf_counter() - t0, "lip_sync_score": final.lip_sync_score,
                    "fake_probability": final.fake_probability}

    svg = os.path.join(tmp, "dag.svg")
    rc, _, _ = _quiet(render_dag_svg.main, ["--out", svg])
    with open(svg) as f, open(os.path.join(REPO, "docs", "dag.svg")) as g:
        check(rc == 0 and f.read() == g.read(), "render_dag_svg: the SVG differs from docs/dag.svg")
    out["render_dag_svg"] = "equal to docs/dag.svg"
    return out, launches


def eval_phase():
    """The paired adoption gates and the diagnostic tools on the card, each
    through its ``main`` in this process: (a) ``eval_asr_paired`` on the
    shipped formant ASR against a copy of itself, (b) ``eval_text_paired`` on
    the shipped MiniLM, card against CPU, (c) ``eval_clip_paired`` against a
    ViT-B/32 from the port's maker, (d) ``eval_asr_whisper_paired`` on the
    shipped Whisper, (e) ``eval_pipeline_paired`` with a copy of the shipped
    detector, (f)-(g) both ``diagnose_*`` tools, their rows card f32 against
    CPU f32, (h) ``profile_pipeline`` hermetic with a trace, (i)
    ``repro_node C1`` and ``LR`` against a debug run, (j)
    ``render_dag_svg`` against ``docs/dag.svg`` -> the C1 launches."""
    import torch

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "eval: TF32 must stay off for the card-vs-CPU bars")
    result = {"nvidia_smi": SMI_LINE, "cut": {"asr_n": EVAL_ASR_N, "text": EVAL_TEXT, "clip_n": EVAL_CLIP_N,
                                              "whisper": EVAL_WHISPER, "pipeline_s": EVAL_PIPELINE_SECONDS,
                                              "diagnose_n": EVAL_DIAGNOSE_N, "profile": EVAL_PROFILE}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        result["gates"], pipeline = _eval_gates(tmp, os.path.join(REPO, "checkpoints"))
        result["gates_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["diagnose"] = _eval_diagnose()
        result["diagnose_total_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["dev_tools"], launches = _eval_dev_tools(tmp)
        result["dev_tools_s"] = time.perf_counter() - t0
    launches["pipeline"] = pipeline
    result["lipsync_score_launches"] = launches
    phase("eval", **result)
    return sum(launches.values())


#: the levers phase: the 16 nodes on 2 clips of the batch corpus at 5 s
#: (bench.py's 8 at 30 s; 10 s until the corpus became mp4v) 2 at once,
#: and ``ab_bench`` for 4 passes (its 8) on 2 clips of 5 s
LEVERS_CLIP_SECONDS, LEVERS_CLIPS = 5.0, 2
#: chained against unchained landmarks, f32 on the card: the f32 landmark bar
#: of tests/test_torch_pose.py in crop [0, 1] units; poses in degrees (the
#: JAX test's bar)
LEVERS_LM_TOL, LEVERS_POSE_TOL = 1e-5, 1e-3
#: the chained program card f32 against CPU f32 on the first frames: crop
#: units and degrees (card and CPU convolutions sum in other orders)
LEVERS_CPU_FRAMES, LEVERS_CPU_LM_TOL, LEVERS_CPU_POSE_TOL = 10, 1e-4, 5e-3
LEVERS_ROUNDS = 10
#: the switches of (b): fake_probability equal to the baseline's under the
#: first two (they change no arithmetic), within LEVERS_PROB_TOL (f32) under
#: the others
LEVERS_EXACT = ("FVD_TPU_NO_ARTIFACT_CACHE", "FVD_TPU_NO_STACK_MEMO")
LEVERS_CLOSE = ("FVD_TPU_NO_FUSED_POSE", "FVD_TPU_NO_DEVICE_OCR", "FVD_TPU_FUSED_DETLM")
LEVERS_PROB_TOL = 1e-5
AB_BENCH_ARGV = ["FVD_TPU_FUSED_DETLM=1", "--passes", "4", "--n-videos", "2", "--duration", "5",
                 "--concurrency", "2"]
AB_BENCH_KEYS = ["lever", "a_best", "b_best", "a_med", "b_med", "speedup_best", "speedup_med", "passes"]


def _lmpose_call(prov, frames, dev, chained):
    with _env("FVD_TPU_FUSED_DETLM", "1" if chained else None):
        return prov.landmarks_pose_batch(frames, device_frames=dev, pose_pad=0.1)


def _lmpose_gaps(a, b, boxes=None):
    """Largest landmark gap (pixels; crop units where ``boxes`` gives each
    detection's box) and pose gap (degrees) of two ``landmarks_pose_batch``
    results with the same detections."""
    (lm_a, pose_a), (lm_b, pose_b) = a, b
    check([len(x) for x in lm_a] == [len(x) for x in lm_b],
          f"levers: detections differ: {[len(x) for x in lm_a]} vs {[len(x) for x in lm_b]}")
    px = crop = pose = 0.0
    for i, (xs, ys, ps, qs) in enumerate(zip(lm_a, lm_b, pose_a, pose_b)):
        for j, (x, y, p, q) in enumerate(zip(xs, ys, ps, qs)):
            d = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
            px = max(px, float(d.max()))
            if boxes is not None:
                x1, y1, x2, y2 = boxes[i][j]
                crop = max(crop, float((d / [x2 - x1, y2 - y1]).max()))
            pose = max(pose, float(np.abs(np.asarray(p, np.float64) - np.asarray(q, np.float64)).max()))
    return {"landmarks_px": px, "landmarks_crop": crop if boxes is not None else None, "pose_deg": pose,
            "detections": sum(len(x) for x in lm_a)}


def _host_boxes(prov, dev, w, h):
    """Each frame's gated detector boxes, in the order the providers list
    their detections."""
    owners, boxes = prov._collect_detections(prov.face_detector.detect_batch(dev), w, h)
    out = [[] for _ in range(int(dev.shape[0]))]
    for o, b in zip(owners, boxes):
        out[o].append(b)
    return out


def _d2h_copies(fn, calls=2):
    """Device-to-host and host-to-device copies per call of ``fn`` from one
    ``torch.profiler`` pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    count = {kind: sum(e.count for e in events if f"Memcpy {kind}" in e.key) / calls for kind in ("DtoH", "HtoD")}
    check(events, "levers: the profiler showed no device event")
    return {"d2h_per_call": count["DtoH"], "h2d_per_call": count["HtoD"], "calls": calls}


def _levers_chained(clip):
    """(a) The chained program against the unchained path on the card, at
    the shipped geometry, on the clip's 5 fps frames."""
    import torch

    from fvd_tpu_torch.c1_timing import interleaved_ms
    from fvd_tpu_torch.providers.media import VideoReader

    frames, _, meta = VideoReader(use_cache=False).sample_at_fps(clip, 5.0)
    h, w = frames.shape[1:3]
    out = {"frames": int(len(frames)), "frame_hw": [int(h), int(w)]}
    dev = torch.from_numpy(frames).cuda()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prov = _vision_providers("cuda", dtype).landmarks
        unchained, chained = _lmpose_call(prov, frames, dev, False), _lmpose_call(prov, frames, dev, True)
        row = _lmpose_gaps(unchained, chained, _host_boxes(prov, dev, w, h))
        check(row["detections"] >= VIDEO_FOUND_MIN * len(frames),
              f"levers (a) {name}: {row['detections']} faces in {len(frames)} frames")
        if name == "f32":
            check(row["landmarks_crop"] <= LEVERS_LM_TOL and row["pose_deg"] <= LEVERS_POSE_TOL,
                  f"levers (a) f32 chained vs unchained: {row}")
            n = LEVERS_CPU_FRAMES
            cpu = _vision_providers("cpu", dtype).landmarks
            on_cpu = _lmpose_call(cpu, frames[:n], torch.from_numpy(frames[:n]), True)
            row["card_vs_cpu_chained"] = _lmpose_gaps(_lmpose_call(prov, frames[:n], dev[:n], True), on_cpu,
                                                      _host_boxes(cpu, torch.from_numpy(frames[:n]), w, h))
            gaps = row["card_vs_cpu_chained"]
            check(gaps["landmarks_crop"] <= LEVERS_CPU_LM_TOL and gaps["pose_deg"] <= LEVERS_CPU_POSE_TOL,
                  f"levers (a) chained card f32 vs CPU f32 on {n} frames: {gaps}")
        row["ms_per_call"] = interleaved_ms({"unchained": lambda: _lmpose_call(prov, frames, dev, False),
                                             "chained": lambda: _lmpose_call(prov, frames, dev, True)},
                                            warmup=3, rounds=LEVERS_ROUNDS)
        row["copies"] = {k: _d2h_copies(lambda: _lmpose_call(prov, frames, dev, k == "chained"))
                         for k in ("unchained", "chained")}
        check(row["copies"]["chained"]["d2h_per_call"] == 1,
              f"levers (a) {name}: the chained path made {row['copies']['chained']} copies a call")
        out[name] = row
    return out


class _SmoothBitCheck:
    """Wraps ``providers.coalesce.run_program`` so that every coalesced
    smoothing group also runs each of its videos through the plain scan of
    ``ops/filters.py`` on the same (padded) inputs, which must give the same
    bits: the outputs, NaN rows included, and every carry field."""

    def __init__(self):
        from fvd_tpu_torch.providers import coalesce

        self.coalesce, self.real = coalesce, coalesce.run_program
        self.groups = {"oe_smooth": [], "v4_smooth": []}
        self.checked = 0
        self.mismatches = []
        self._lock = threading.Lock()

    @staticmethod
    def _plain(kind, key, p):
        from fvd_tpu_torch.ops.filters import one_euro_scan_chunk

        if kind == "oe_smooth":
            mc, beta, dc = key[2:]
            sm, c = one_euro_scan_chunk(*p, min_cutoff=mc, beta=beta, d_cutoff=dc)
            return [sm, *c]
        lm_mc, lm_b, p_mc, p_b = key[2:]
        lm_c, pose_c, t, lm, lv, pose, pv = p
        sm_lm, lc = one_euro_scan_chunk(lm_c, t, lm, lv, min_cutoff=lm_mc, beta=lm_b)
        sm_pose, pc = one_euro_scan_chunk(pose_c, t, pose, pv, min_cutoff=p_mc, beta=p_b)
        return [sm_lm, sm_pose, *lc, *pc]

    def run_program(self, kind, key, payload, run_batch):
        if kind not in self.groups:
            return self.real(kind, key, payload, run_batch)

        def checked(payloads):
            out = run_batch(payloads)
            for p, o in zip(payloads, out):
                got = [o[0], *o[1]] if kind == "oe_smooth" else [o[0], o[1], *o[2], *o[3]]
                want = self._plain(kind, key, p)
                same = len(got) == len(want) and all(
                    np.asarray(a).dtype == np.asarray(b).dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()
                    for a, b in zip(got, want))
                with self._lock:
                    self.checked += 1
                    if not same:
                        self.mismatches.append((kind, key))
            with self._lock:
                self.groups[kind].append(len(payloads))
            return out

        return self.real(kind, key, payload, checked)

    def __enter__(self):
        self.coalesce.run_program = self.run_program
        return self

    def __exit__(self, *exc):
        self.coalesce.run_program = self.real


def _levers_switches(tmp, paths):
    """(b) The clips through the 16 nodes 2 at once on the card in f32,
    each switch off (the baseline) and on alone."""
    import torch

    from fvd_tpu_torch.providers.factory import production_providers

    prov = production_providers(os.path.join(REPO, "checkpoints"), device="cuda", compute_dtype=torch.float32,
                                recorded_services=True)
    runs, launches = {}, 0
    with _SmoothBitCheck() as bits:
        for name in (None,) + LEVERS_EXACT + LEVERS_CLOSE:
            with _env(name, "1") if name else contextlib.nullcontext():
                r = _batch_run(prov, paths, os.path.join(tmp, name or "baseline"), "cuda", 2)
            check(all(v == len(paths) for v in r["nodes_done"].values()), f"levers (b) {name}: {r['nodes_done']}")
            c1 = r["groups"].get("c1_lipsync", {"groups": 0})
            check(r["launches"] == c1["groups"] and r["launches"] >= 1,
                  f"levers (b) {name}: {r['launches']} C1 launches for C1 groups {c1}")
            launches += r["launches"]
            runs[name or "baseline"] = {
                "seconds": r["seconds"], "fake_probabilities": r["probs"], "lipsync_score_launches": r["launches"],
                "smooth_groups": {k: r["groups"].get(k, {}).get("videos_per_group", [])
                                  for k in ("oe_smooth", "v4_smooth")},
                "lmpose_groups": r["groups"].get("lmpose", {}).get("videos_per_group", [])}
    base = runs["baseline"]["fake_probabilities"]
    for name in LEVERS_EXACT + LEVERS_CLOSE:
        gap = max(abs(a - b) for a, b in zip(runs[name]["fake_probabilities"], base))
        runs[name]["max_abs_dp"] = gap
        check(gap == 0.0 if name in LEVERS_EXACT else gap <= LEVERS_PROB_TOL,
              f"levers (b) {name}: fake_probability {runs[name]['fake_probabilities']} vs {base}")
    check(bits.checked > 0 and not bits.mismatches,
          f"levers (b): coalesced smoothing not bit-equal to the plain scans: {bits.mismatches[:4]}")
    return {"runs": runs, "smooth_bit_equal": {"videos_checked": bits.checked, "group_sizes": bits.groups}}, launches


def _levers_ab_bench(tmp):
    """(c) ``python -m fvd_tpu_torch.tools.ab_bench`` in a fresh interpreter."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.tools.ab_bench"] + AB_BENCH_ARGV, cwd=tmp,
                          env=_subprocess_env(), capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"levers (c) ab_bench: rc {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"levers (c) ab_bench: stdout {proc.stdout[-2000:]!r}")
    out = json.loads(lines[0])
    check(list(out) == AB_BENCH_KEYS and [a for a, _ in out["passes"]] == ["A", "B", "A", "B"]
          and out["lever"] == AB_BENCH_ARGV[0], f"levers (c) ab_bench: {out}")
    log = proc.stderr.strip().splitlines()
    check(any(ln.startswith("card: NVIDIA") for ln in log), f"levers (c) ab_bench: no card line in {log[:5]}")
    return {"argv": AB_BENCH_ARGV, "seconds": seconds, "json": out, "stderr": log}


def levers_phase():
    """The chained detector -> landmarks -> pose program, the A/B switches
    and ``tools/ab_bench`` on the card: (a) chained against unchained in f32
    and bf16 on one clip's 5 fps frames (the same detections, f32 landmarks
    within ``LEVERS_LM_TOL``, the chained program card f32 against CPU f32,
    ms a call, device-to-host copies a call); (b) the 16 nodes on 2 clips 2
    at once, each switch off and on, the coalesced smoothing checked bit for
    bit against the plain scans; (c) ``ab_bench`` in a fresh interpreter ->
    the C1 launches of (b)."""
    import torch

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "levers: TF32 must stay off for the card-vs-CPU bars")
    result = {"nvidia_smi": SMI_LINE, "cut": {"clip_seconds": LEVERS_CLIP_SECONDS, "clips": LEVERS_CLIPS,
                                              "bench_clips": 8, "bench_clip_seconds": BENCH_CLIP_SECONDS,
                                              "ab_bench_passes": 4, "ab_bench_default_passes": 8},
              "tolerance": {"lm_crop": LEVERS_LM_TOL, "pose_deg": LEVERS_POSE_TOL, "cpu_lm_crop": LEVERS_CPU_LM_TOL,
                            "cpu_pose_deg": LEVERS_CPU_POSE_TOL, "prob": LEVERS_PROB_TOL}}
    with tempfile.TemporaryDirectory() as tmp:
        videos = os.path.join(tmp, "videos")
        paths = [_corpus_clip(videos, i, LEVERS_CLIP_SECONDS, "avi")[0] for i in range(LEVERS_CLIPS)]
        t0 = time.perf_counter()
        result["chained"] = _levers_chained(paths[0])
        result["chained_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["switches"], launches = _levers_switches(tmp, paths)
        result["switches_s"] = time.perf_counter() - t0
        result["ab_bench"] = _levers_ab_bench(tmp)
    result["lipsync_score_launches"] = launches
    phase("levers", **result)
    return launches


#: the codec phase: corpus clips 0 and 1 at 10 s, 320x240, 30 fps
CODEC_CLIPS, CODEC_SECONDS = 2, 10.0
#: the VOPs of clip 0 held bit for bit against the plain versions: two GOPs
CODEC_PLAIN_VOPS = 24
CODEC_KERNELS = ("mpeg4_recon", "yuv420_rgb", "mpeg4_forward", "mpeg4_parse")
#: the aac phase's kernels
AAC_KERNELS = ("aac_synth", "audio_resample")
#: the kernels line's rows after lipsync_score: the codec kernels and the
#: h264 phase's nv12_rgb
ROW_KERNELS = CODEC_KERNELS + ("nv12_rgb",) + AAC_KERNELS
#: each row kernel's launches on the main path: the codec phase's encode and
#: decode and the batch phase's card runs (a) and (b); the h264 phase's NVDEC
#: decodes
CODEC_LAUNCHES = {k: 0 for k in ROW_KERNELS}
#: each row kernel's row of the kernels line (the codec and h264 phases), and
#: the phase whose main path must launch it
CODEC_ROWS = {}
MAIN_PATH_PHASE = {"mpeg4_recon": "codec", "yuv420_rgb": "codec", "mpeg4_forward": "codec", "nv12_rgb": "h264",
                   "mpeg4_parse": "codec", "aac_synth": "aac", "audio_resample": "aac"}
CODEC_SOURCES = {"mpeg4_recon": "mpeg4_decode", "yuv420_rgb": "mpeg4_decode", "mpeg4_forward": "mpeg4_encode",
                 "mpeg4_parse": "mpeg4_parse", "aac_synth": "aac_synth", "audio_resample": "audio_resample",
                 "nv12_rgb": "nvdec"}
CODEC_REPLACES = {
    "mpeg4_parse": "native/decode_shim.cc:155 (fvd_read_frames: libavcodec's mpeg4 entropy decoding; "
                   "cv2 at fvd_tpu/providers/media.py:521)",
    "aac_synth": "native/decode_shim.cc:206-264 (fvd_extract_audio: libavcodec's aac IMDCT, windowing and "
                 "overlap-add)",
    "audio_resample": "native/decode_shim.cc:213-245 (fvd_extract_audio: libswresample's rematrix and "
                      "resampler)",
    "mpeg4_recon": "native/decode_shim.cc:155 (fvd_read_frames: libavcodec's mpeg4 decoder; "
                   "cv2 at fvd_tpu/providers/media.py:521)",
    "yuv420_rgb": "native/decode_shim.cc:155 (fvd_read_frames: sws_scale yuv420p -> rgb24; "
                  "cv2 at fvd_tpu/providers/media.py:521)",
    "mpeg4_forward": "fvd_tpu/providers/media.py:774 (write_video: cv2 VideoWriter 'mp4v', "
                     "libavcodec's mpeg4 encoder and libswscale)",
    "nv12_rgb": "native/decode_shim.cc:147-204 (fvd_read_frames: libavcodec's h264 decoder, then sws_scale "
                "yuv420p -> rgb24 at :154-156; cv2 at fvd_tpu/providers/media.py:541)",
}


def _codec_bounds(geo, p_vop, coded_blocks):
    """Least device time a VOP of each codec kernel could take: each input
    it needs read once and each output written once at HBM rate, or its
    integer operations at the data sheet's non-tensor-core float32 rate (the
    guide's table has no int32 entry; the card's integer rate is no higher),
    whichever is longer -> {kernel: (ms, bound_by, bytes, ops)}.  The
    reconstruction needs the levels, the dequantisation and the IDCT of the
    VOP's ``coded_blocks`` only: an uncoded block adds nothing."""
    n_blk, n_mb, frame = geo.n_blocks, geo.n_mb, geo.frame_bytes
    px = geo.width * geo.height
    rows = {
        # the coded blocks' int16 levels, every block's qscale, intra flag,
        # vector and coded flag in; the reference (P-VOP) read, the frame
        # written; dequantisation 5 ops a coefficient and the two IDCT passes
        # 48 ops a row or column of a coded block, the prediction and the
        # add 15 ops a pixel
        "mpeg4_recon": (coded_blocks * 64 * 2 + (2 * n_mb + 3 * n_blk) * 2 + frame * (2 if p_vop else 1),
                        coded_blocks * (64 * 5 + 16 * 48) + n_blk * 64 * 15),
        # the frame in, RGB out; 10 ops a pixel and 12 a 2x2 quad
        "yuv420_rgb": (frame + 3 * px, 10 * px + 12 * (px // 4)),
        # RGB and the reference (P-VOP) in, int16 levels out; colour 8 ops a
        # pixel, the FDCT's two passes 16 ops a coefficient each, quantisation 5
        "mpeg4_forward": (3 * px + (frame if p_vop else 0) + n_blk * 64 * 2,
                          8 * px + n_blk * 64 * (2 * 16 + 5)),
    }
    out = {}
    for k, (nbytes, ops) in rows.items():
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
        out[k] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)
    return out


#: the parse kernel's stream set beside the corpus clips: known-answer
#: streams (every syntax path; width, height, VOPs, seed)
CODEC_KA_STREAMS = ((64, 48, 24, 0), (96, 64, 24, 1), (320, 240, 36, 2))


def _parse_inputs(path):
    """Every sample of ``path`` as ``parse_vops``' inputs."""
    from fvd_tpu_torch.utils import mp4, mpeg4v

    data = open(path, "rb").read()
    track = mp4.parse(path, data)
    return mpeg4v.scan_samples([data[o:o + n] for o, n in zip(track.offsets, track.sizes)],
                               mpeg4v.find_vol(track.config))


def _codec_parse(tmp, corpus):
    """``mpeg4_parse`` against the host parser, bit for bit, on every VOP of
    the corpus clips and of the known-answer streams; its times (wall ms a
    range of :data:`fvd_tpu_torch.providers.native_decode.PARSE_CHUNK_BYTES`,
    device microseconds a launch, the host parser's ms a VOP) and bound."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.c1_timing import graph_ms
    from fvd_tpu_torch.ops import mpeg4 as ops
    from fvd_tpu_torch.providers import native_decode as nd
    from fvd_tpu_torch.utils import mpeg4v_ka

    streams = list(corpus)
    for w, h, n, seed in CODEC_KA_STREAMS:
        path = os.path.join(tmp, f"ka_{w}x{h}.mp4")
        mpeg4v_ka.write_mp4(path, w, h, 30.0, mpeg4v_ka.covering_stream(w, h, n, seed=seed))
        streams.append(path)
    worst, vops, plain_s = 0, 0, 0.0
    for path in streams:
        args = _parse_inputs(path)
        got = ops.parse_vops(*args, device="cuda")
        t0 = time.perf_counter()
        want = ops.parse_vops_plain(*args)
        plain_s += time.perf_counter() - t0
        check(got.kinds == want.kinds and got.rounding == want.rounding,
              f"codec: mpeg4_parse kinds/rounding differ on {os.path.basename(path)}")
        worst = max(worst, int((got.packed.cpu().int() - want.packed.int()).abs().max()))
        vops += len(got)
    check(worst == 0, f"codec: mpeg4_parse against the host parser: max |d| {worst}")
    # timings on clip 0's first range, the size a session parses
    data, offsets, ids, vols = _parse_inputs(corpus[0])
    geo = ops.Geometry(vols[0].width, vols[0].height)
    per_vop = 2 * (sum(ops.row_parts(geo)) + ops.parse_scratch_len(geo))
    k = min(len(offsets), nd.PARSE_CHUNK_BYTES // per_vop)
    end = offsets[k - 1][2]
    rng_args = (data[:end], offsets[:k], ids[:k], vols)
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        ops.parse_vops(*rng_args, device="cuda")
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ops.parse_vops_plain(*rng_args)
    plain_range_s = time.perf_counter() - t0
    # the kernel alone: its inputs staged once, the two memsets and the launch in a graph
    blob_np, starts = ops._parse_blob(*rng_args)
    blob = torch.from_numpy(blob_np).cuda()
    packed = torch.zeros((k, sum(ops.row_parts(geo))), dtype=torch.int16, device="cuda")
    scratch = torch.zeros((k, ops.parse_scratch_len(geo)), dtype=torch.int16, device="cuda")
    info = torch.zeros((k, 4), dtype=torch.int32, device="cuda")
    tab, tab_len = ops._parse_tables_c()
    pargs = ops._ParseArgs(k, len(vols), geo.mb_w, geo.mb_h, packed.shape[1], scratch.shape[1], tab_len, *starts)

    def launch():
        packed.zero_()
        scratch.zero_()
        ops._launch("mpeg4_parse", packed.device, blob.data_ptr(), packed.data_ptr(), scratch.data_ptr(),
                    info.data_ptr(), ctypes.addressof(tab), ctypes.addressof(pargs))

    before = _kernels.LAUNCHES["mpeg4_parse"]
    device_ms = graph_ms(launch)
    _kernels.LAUNCHES["mpeg4_parse"] = before  # the timing's launches are not the main path's
    nbytes = len(blob_np) + packed.numel() * 2 + info.numel() * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    CODEC_ROWS["mpeg4_parse"] = {"max_abs_err": worst, "ms": statistics.median(walls) * 1e3, "device_ms": device_ms,
                                 "plain_ms": plain_range_s * 1e3, "bound_ms": bound_ms, "bound_by": "bytes"}
    return {"streams": [os.path.basename(p) for p in streams], "vops_bit_equal": vops,
            "plain_ms_per_vop": plain_s * 1e3 / vops, "range_vops": k, "range_wall_ms": statistics.median(walls) * 1e3,
            "range_device_us": device_ms * 1e3, "device_us_per_vop": device_ms * 1e3 / k,
            "wall_ms_per_vop": statistics.median(walls) * 1e3 / k, "plain_range_ms": plain_range_s * 1e3,
            "bound_us": bound_ms * 1e3, "bound_bytes": nbytes}


def codec_phase():
    """MPEG-4 Part 2 in MP4 on the card, the slice's main path: corpus clips 0
    and 1 (10 s, 320x240, 30 fps) encoded with ``write_mp4v`` and decoded with
    ``NativeVideo`` on the card (counted), then clip 0's first VOPs through
    ``mpeg4_recon``, ``yuv420_rgb`` and ``mpeg4_forward`` against their plain
    versions on the card, bit for bit over two GOPs; ms a VOP for the host parse, the
    reconstruction and the colour conversion, encode ms a frame, file bytes
    against raw, luma PSNR against the drawn frames, each kernel's device time
    and bound."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.c1_timing import graph_ms, interleaved_ms
    from fvd_tpu_torch.ops import mpeg4 as ops
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.providers import native_decode as nd
    from fvd_tpu_torch.utils import mp4, mpeg4v

    n = int(round(CODEC_SECONDS * 30.0))
    result = {"nvidia_smi": SMI_LINE, "clips": CODEC_CLIPS, "clip_seconds": CODEC_SECONDS, "fps": 30.0,
              "frame_size": [240, 320], "vop_quant": nd.QUANT, "gop": nd.GOP}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        drawn = []
        for i in range(CODEC_CLIPS):
            raw, _ = _corpus_clip(tmp, i, CODEC_SECONDS, "avi")
            drawn.append(media.VideoReader(use_cache=False).sample(raw, range(n))[0])
        result["draw_s"] = time.perf_counter() - t0
        paths = [os.path.join(tmp, f"codec{i}.mp4") for i in range(CODEC_CLIPS)]
        # the main path, counted: encode, then decode every frame, on the card
        _kernels.reset_launches()
        enc, dec = [], []
        for frames, path in zip(drawn, paths):
            t0 = time.perf_counter()
            stats = nd.write_mp4v(path, frames, 30.0, device="cuda")
            enc.append(dict(stats, wall_s=time.perf_counter() - t0))
        decoded = []
        for path in paths:
            t0 = time.perf_counter()
            with nd.NativeVideo(path, device="cuda") as v:
                frames, kept = v.read_frames(range(n))
                dec.append(dict(v.stats, wall_s=time.perf_counter() - t0))
            check(kept == list(range(n)) and frames.shape == (n, 240, 320, 3), f"codec: decoded {len(kept)} frames")
            decoded.append(frames)
        torch.cuda.synchronize()
        launches = {k: _kernels.LAUNCHES[k] for k in CODEC_KERNELS}
        ranges = sum(d["ranges"] for d in dec)
        check(launches == {"mpeg4_recon": 2 * n * CODEC_CLIPS, "yuv420_rgb": n * CODEC_CLIPS,
                           "mpeg4_forward": n * CODEC_CLIPS, "mpeg4_parse": ranges} and ranges >= CODEC_CLIPS,
              f"codec: launches {launches}: one recon a VOP in the encoder and one in the decoder, "
              f"one colour conversion a frame, one forward a frame, one parse a range ({ranges} ranges)")
        result["parse"] = _codec_parse(tmp, paths)
        for k in CODEC_KERNELS:
            CODEC_LAUNCHES[k] += launches[k]
        result["main_path_launches"] = launches
        result["encode_ms_per_frame"] = [e["wall_s"] * 1e3 / n for e in enc]
        result["encode_host_ms_per_frame"] = {k: [e[k] * 1e3 / n for e in enc] for k in ("forward_s", "recon_s", "bits_s")}
        result["decode_ms_per_frame"] = [d["wall_s"] * 1e3 / n for d in dec]
        result["parse_ms_per_vop"] = [d["parse_s"] * 1e3 / d["vops"] for d in dec]
        result["parse_ranges"] = [d["ranges"] for d in dec]
        result["recon_host_ms_per_vop"] = [d["recon_s"] * 1e3 / d["vops"] for d in dec]
        result["rgb_host_ms_per_frame"] = [d["rgb_s"] * 1e3 / n for d in dec]
        result["file_bytes"] = [os.path.getsize(p) for p in paths]
        result["raw_bytes"] = int(drawn[0].nbytes)
        result["raw_over_file"] = [drawn[0].nbytes / b for b in result["file_bytes"]]

        # bit for bit against the plain versions on the card: the first two
        # GOPs of clip 0 (every VOP goes through the kernels, for the PSNR)
        data = open(paths[0], "rb").read()
        track = mp4.parse(paths[0], data)
        decoder = mpeg4v.Decoder(mpeg4v.find_vol(track.config))  # the plain comparisons' VOPs
        geo = ops.Geometry(320, 240)
        ref_k = ref_p = None
        worst = {k: 0 for k in CODEC_KERNELS}
        ys, keep = [], {}
        for i, (off, size) in enumerate(zip(track.offsets, track.sizes)):
            vop = decoder.decode(data[off:off + size])
            args = [torch.from_numpy(a).cuda() for a in (vop.levels, vop.qscale, vop.intra, vop.mv, vop.coded)]
            p_vop = vop.kind == "P"
            rgb = torch.from_numpy(drawn[0][i]).cuda()
            k = ops.reconstruct_vop(*args, ref_k if p_vop else None, vop.rounding, geo)
            rk = ops.yuv420_to_rgb(k, geo)
            check(torch.equal(rk.cpu(), torch.from_numpy(decoded[0][i])), f"codec: frame {i} differs from the decode")
            if i < CODEC_PLAIN_VOPS:
                fk = ops.forward_vop(rgb, ref_k if p_vop else None, nd.QUANT, geo)
                fp = ops.forward_vop_plain(rgb, ref_p if p_vop else None, nd.QUANT, geo)
                worst["mpeg4_forward"] = max(worst["mpeg4_forward"], int((fk.int() - fp.int()).abs().max()))
                p = ops.reconstruct_vop_plain(*args, ref_p if p_vop else None, vop.rounding, geo)
                worst["mpeg4_recon"] = max(worst["mpeg4_recon"], int((k.int() - p.int()).abs().max()))
                rp = ops.yuv420_to_rgb_plain(p[None], geo)[0]
                worst["yuv420_rgb"] = max(worst["yuv420_rgb"], int((rk.int() - rp.int()).abs().max()))
                ref_p = p
            ys.append(k[:320 * 240])
            if i in (0, 1):  # an I-VOP and a P-VOP for the timings
                keep[vop.kind] = (args, ref_k, vop.rounding, rgb)
            ref_k = k
        check(not any(worst.values()), f"codec: kernels against their plain versions: max |d| {worst}")
        result["bit_equal_vops"] = min(CODEC_PLAIN_VOPS, len(track.sizes))
        ref_y = torch.stack([ops.rgb_to_yuv420_plain(torch.from_numpy(f).cuda(), geo)[:320 * 240] for f in drawn[0]])
        mse = ((torch.stack(ys).double() - ref_y.double()) ** 2).mean().item()
        result["luma_psnr_db"] = 10 * np.log10(255 ** 2 / mse)
        check(result["luma_psnr_db"] > 35.0, f"codec: luma PSNR {result['luma_psnr_db']} dB")

        # timings: the wrapper per call (CUDA events), the plain version, the device time
        (ia, _, _, irgb), (pa, pref, prnd, prgb) = keep["I"], keep["P"]
        frame = ref_k
        rows = {
            "mpeg4_recon": (lambda: ops.reconstruct_vop(*pa, pref, prnd, geo),
                            lambda: ops.reconstruct_vop_plain(*pa, pref, prnd, geo)),
            "yuv420_rgb": (lambda: ops.yuv420_to_rgb(frame, geo),
                           lambda: ops.yuv420_to_rgb_plain(frame[None], geo)),
            "mpeg4_forward": (lambda: ops.forward_vop(prgb, pref, nd.QUANT, geo),
                              lambda: ops.forward_vop_plain(prgb, pref, nd.QUANT, geo)),
        }
        coded_blocks = int(pa[4].sum())
        bounds = _codec_bounds(geo, p_vop=True, coded_blocks=coded_blocks)
        timing = {}
        for name, (fn, plain) in rows.items():
            t = interleaved_ms({"ms": fn, "plain_ms": plain})
            t["device_ms"] = graph_ms(fn)
            bound_ms, bound_by, nbytes, nops = bounds[name]
            timing[name] = {**t, "device_us": t["device_ms"] * 1e3, "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
                            "bound_by": bound_by, "bytes": nbytes, "ops": nops, "coded_blocks": coded_blocks,
                            "shape": "P-VOP, 300 MBs, 1800 blocks"}
            CODEC_ROWS[name] = {"max_abs_err": worst[name], "ms": t["ms"], "device_ms": t["device_ms"],
                                "plain_ms": t["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by}
        timing["mpeg4_recon"]["i_vop_device_us"] = graph_ms(lambda: ops.reconstruct_vop(*ia, None, 0, geo)) * 1e3
        result["kernels"] = timing
    phase("codec", **result)


#: the h264 phase: the known-answer streams (name -> frames, height, width,
#: fps, display-order pattern), corpus clip 0 for the DAG, the surface pitch
#: nv12_rgb is held at where no NVDEC surface exists
H264_STREAMS = {"i_only": (10, 240, 320, 30.0, None), "ipbpb": (24, 240, 320, 30.0, "gop"),
                "cropped": (8, 180, 320, 25.0, "IPBPIBPP"), "low_samples": (6, 48, 64, 10.0, "IPPBPP")}
H264_CLIP_SECONDS = 5.0
H264_PITCH = 512


def _h264_sources():
    """Each known-answer stream's frames: a smoothed random texture moving a
    pixel a frame with still frames (all-skip P pictures) in it, or Y, Cb, Cr
    planes of 0x00-0x03 runs (emulation prevention in the samples)."""
    out = {}
    for name, (n, h, w, fps, pattern) in H264_STREAMS.items():
        rng = np.random.RandomState(len(out))
        if name == "low_samples":
            y = rng.randint(0, 4, (n, h, w)).astype(np.uint8)
            u = rng.randint(0, 4, (n, h // 2, w // 2)).astype(np.uint8)
            v = np.where(np.arange(w // 2) % 3 == 0, 255, 0).astype(np.uint8) * np.ones_like(u)
            y[2], u[2], v[2] = y[1], u[1], v[1]
            src = (y, u, v)
        else:
            base = rng.randint(0, 256, (h + n, w + n, 3)).astype(np.float32)
            base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
            frames = [base[i:i + h, i:i + w] for i in range(n)]
            for i in (4, 5, 15):
                if i < n:
                    frames[i] = frames[i - 1]
            src = np.stack(frames).astype(np.uint8)
        out[name] = src
    return out


def _nv12_surface(flat, geo, pitch):
    """A flat YUV 4:2:0 frame (macroblock-aligned planes) as an NV12 surface
    on the card, ``pitch`` bytes a row, as a decoder lays its pictures out."""
    import torch

    h, w = geo.luma
    f = torch.from_numpy(flat).cuda()
    surface = torch.zeros((h * 3 // 2, pitch), dtype=torch.uint8, device="cuda")
    surface[:h, :w] = f[:h * w].view(h, w)
    surface[h:, 0:w:2] = f[h * w:h * w * 5 // 4].view(h // 2, w // 2)
    surface[h:, 1:w:2] = f[h * w * 5 // 4:].view(h // 2, w // 2)
    return surface[:h], surface[h:]


def _h264_dag(tmp):
    """Corpus clip 0 (5 s) as all-PCM H.264 and as a raw AVI of the same
    decoded frames, each with the sibling wav, through the lip-sync path on
    the card in f32 -> the two final states, the H.264 run's C1 and
    nv12_rgb launches."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.utils import h264_pcm

    raw, _ = _corpus_clip(tmp, 0, H264_CLIP_SECONDS, "avi")
    n = int(round(H264_CLIP_SECONDS * 30.0))
    frames = media.VideoReader(use_cache=False).sample(raw, range(n))[0]
    h264_path, avi_path = os.path.join(tmp, "clip0_h264.mp4"), os.path.join(tmp, "clip0_avi.avi")
    expect = h264_pcm.write_pcm_h264(h264_path, frames, 30.0, h264_pcm.gop_pattern(n))
    media.write_video(avi_path, expect, 30.0)
    for path in (h264_path, avi_path):
        shutil.copy(raw[:-len(".mp4")] + ".wav", os.path.splitext(path)[0] + ".wav")
    sched = _video_scheduler(os.path.join(tmp, "dag"), "cuda", torch.float32)
    _video_run(sched, os.path.join(tmp, "dag"), [avi_path], coalesced=False)  # warm-up: cuDNN picks its algorithms
    a = _video_run(sched, os.path.join(tmp, "dag"), [h264_path], coalesced=False)
    nv12 = _kernels.LAUNCHES["nv12_rgb"]
    b = _video_run(sched, os.path.join(tmp, "dag"), [avi_path], coalesced=False)
    return a, b, nv12


def h264_phase():
    """H.264 in MP4 on the card: (a) NVDEC's capabilities for H.264 4:2:0
    8-bit; (b) the four known-answer streams of ``utils/h264_pcm.py``
    (320x240 I-only, IPBPB over two GOPs with still frames, 320x180 coded
    320x192, YUV planes of 0x00-0x03 runs), every frame's NV12 picture
    through nv12_rgb against its plain version and the expected RGB, bit for
    bit; (c) the main path, counted: each stream through ``NvdecVideo``
    (every frame equal to the expected, in display order, as many as
    ``probe()`` counts; a pass in chunks; two sessions from two threads;
    nv12_rgb on the mapped surfaces against its plain version), then corpus
    clip 0 (5 s) as all-PCM H.264 through the lip-sync path against a raw
    AVI of the same frames; (d) IN on the H.264 clip; (e) nv12_rgb's time,
    its plain version's, its device time and its bound at 320x240.  Any
    failure of NVDEC fails the phase, but for one state that the machine
    causes (``nvdec.out_of_reach``: CUresult 2 in a container without
    NVIDIA's video capability): there the first read must raise that same
    failure (no fallback), and (c)'s NVDEC steps and nv12_rgb's main-path
    launch check cannot run."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.c1_timing import graph_ms, interleaved_ms
    from fvd_tpu_torch.nodes import ingest
    from fvd_tpu_torch.ops import mpeg4 as ops
    from fvd_tpu_torch.providers import nvdec
    from fvd_tpu_torch.state import State
    from fvd_tpu_torch.utils import h264, h264_pcm, mp4

    result = {"nvidia_smi": SMI_LINE, "driver_capabilities": os.environ.get("NVIDIA_DRIVER_CAPABILITIES"),
              "kernel_release": os.uname().release}
    try:
        result["nvdec_caps"] = nvdec.decoder_caps("cuda")
        available = True
    except RuntimeError as e:
        check(nvdec.out_of_reach(e), f"h264 (a): NVDEC failed: {type(e).__name__}: {e}")
        result["nvdec_caps"] = f"{type(e).__name__}: {e}"
        available = False
    check(not available or result["nvdec_caps"]["supported"] == 1,
          f"h264 (a): this card's NVDEC does not decode H.264 4:2:0 8-bit: {result['nvdec_caps']}")
    result["nvdec_available"] = available
    c1_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # (b) the known-answer streams and their NV12 pictures through the kernel
        t0 = time.perf_counter()
        streams = {}
        for name, src in _h264_sources().items():
            n, h, w, fps, pattern = H264_STREAMS[name]
            path = os.path.join(tmp, f"{name}.mp4")
            pattern = h264_pcm.gop_pattern(n) if pattern == "gop" else pattern
            geo = ops.Geometry(w, h)
            streams[name] = (path, h264_pcm.write_pcm_h264(path, src, fps, pattern), h264_pcm.yuv_frames(src, geo),
                             geo)
        result["write_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / sum(v[0] for v in H264_STREAMS.values())
        worst, frames_held = 0, 0
        for name, (path, expect, flat, geo) in streams.items():
            for i in range(len(expect)):
                luma, uv = _nv12_surface(flat[i], geo, H264_PITCH)
                k = ops.nv12_to_rgb(luma, uv, geo.width, geo.height)
                p = ops.nv12_to_rgb_plain(luma, uv, geo.width, geo.height)
                worst = max(worst, int((k.int() - p.int()).abs().max()),
                            int(np.abs(k.cpu().numpy().astype(np.int64) - expect[i]).max()))
                frames_held += 1
        check(worst == 0, f"h264 (b): nv12_rgb against its plain version and the expected frames: max |d| {worst}")
        result["b_kernel_vs_plain"] = {"frames": frames_held, "max_abs_err": worst, "pitch": H264_PITCH}

        # (c) the main path, counted
        _kernels.reset_launches()
        path0 = streams["ipbpb"][0]
        if not available:
            try:
                with nvdec.NvdecVideo(path0, device="cuda") as v:
                    v.read_frames([0])
                raised = None
            except (RuntimeError, ValueError) as e:
                raised = e
            check(raised is not None and nvdec.out_of_reach(raised) and "NVDEC" in str(raised),
                  f"h264 (c): NVDEC refused the capability query but a read raised {raised!r}")
            check(_kernels.LAUNCHES["nv12_rgb"] == 0, "h264 (c): nv12_rgb launched without a decoded picture")
            result["c_main_path"] = {"run": False, "read_raised": str(raised)}
        else:
            decoded, shown = {}, 0
            for name, (path, expect, _, _) in streams.items():
                t0 = time.perf_counter()
                with nvdec.NvdecVideo(path, device="cuda") as v:
                    got, kept = v.read_frames(range(len(expect)))
                    stats, count = dict(v.stats), v.probe()[1]
                wall = time.perf_counter() - t0
                check(kept == list(range(len(expect))) and count == len(expect) and np.array_equal(got, expect),
                      f"h264 (c) {name}: NVDEC gave {len(kept)} of {count} frames, "
                      f"max |d| {int(np.abs(got.astype(int) - expect[:len(got)]).max()) if len(got) else None}")
                decoded[name] = {"frames": len(kept), "ms_per_frame": wall * 1e3 / len(kept), **stats}
                shown += len(kept)
            path, expect = streams["ipbpb"][:2]
            with nvdec.NvdecVideo(path, device="cuda") as v:
                parts = [v.read_frames(ids) for ids in ([0, 1, 2, 5], [1, 7, 8, 20], [21, 99], [22])]
            check([k for _, k in parts] == [[0, 1, 2, 5], [7, 8, 20], [21], []]
                  and all(np.array_equal(f, expect[k]) for f, k in parts[:3]), f"h264 (c): chunked pass {parts}")
            shown += 8
            both = [None, None]

            def one(j):
                with nvdec.NvdecVideo(path, device="cuda") as v:
                    both[j] = v.read_frames(range(len(expect)))[0]

            threads = [threading.Thread(target=one, args=(j,)) for j in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            check(all(b is not None and np.array_equal(b, expect) for b in both), "h264 (c): two sessions at once")
            shown += 2 * len(expect)
            check(_kernels.LAUNCHES["nv12_rgb"] == shown,
                  f"h264 (c): {_kernels.LAUNCHES['nv12_rgb']} nv12_rgb launches for {shown} frames")
            CODEC_LAUNCHES["nv12_rgb"] += shown
            a, b, nv12 = _h264_dag(tmp)
            fa, fb = a["finals"][0], b["finals"][0]
            gaps = {k: abs(fa.features[k] - fb.features[k]) for k in fa.features}
            gaps["fake_probability"] = abs(fa.fake_probability - fb.fake_probability)
            check(not any(gaps.values()) and fa.lip_sync_score == fb.lip_sync_score
                  and np.isfinite(fa.fake_probability) and 0.0 < fa.fake_probability < 1.0,
                  f"h264 (c): the DAG on H.264 against the raw AVI of its frames: {gaps}")
            check(a["launches"] == 1 and nv12 > 0, f"h264 (c): the DAG launched C1 {a['launches']} and nv12_rgb "
                                                    f"{nv12} times")
            CODEC_LAUNCHES["nv12_rgb"] += nv12
            c1_launches += a["launches"] + b["launches"]
            result["c_main_path"] = {"run": True, "decoded": decoded, "dag": {
                "gaps": gaps, "lip_sync_score": fa.lip_sync_score, "fake_probability": fa.fake_probability,
                "nv12_rgb_launches": nv12, "wall_ms": {"h264": a["wall"][0], "avi": b["wall"][0]}}}
            # nv12_rgb on the decoder's own mapped surfaces against its plain version (not counted)
            path, expect = streams["cropped"][:2]
            data = open(path, "rb").read()
            track = mp4.parse(path, data)
            cfg = h264.parse_avcc(track.config)
            session, worst_mapped, shown = nvdec.NvdecSession(torch.device("cuda")), 0, 0
            try:
                for i in range(track.frame_count + 1):
                    session.feed(None if i == track.frame_count else h264.annexb_access_unit(
                        data[track.offsets[i]:track.offsets[i] + track.sizes[i]], cfg, i in track.sync))
                    while session.pending():
                        surf = session.map(torch.cuda.current_stream())
                        k = ops.nv12_to_rgb(surf.luma, surf.uv, surf.width, surf.height)
                        p = ops.nv12_to_rgb_plain(surf.luma, surf.uv, surf.width, surf.height)
                        torch.cuda.synchronize()
                        worst_mapped = max(worst_mapped, int((k.int() - p.int()).abs().max()),
                                           int(np.abs(k.cpu().numpy().astype(np.int64) - expect[shown]).max()))
                        result["c_surface"] = {"pitch": surf.pitch, "luma_rows": surf.luma.shape[0]}
                        session.unmap()
                        shown += 1
            finally:
                session.close()
            check(worst_mapped == 0 and shown == len(expect),
                  f"h264 (c): nv12_rgb on {shown} mapped surfaces against its plain version: max |d| {worst_mapped}")
        result["c_main_path"]["nv12_rgb_launches"] = CODEC_LAUNCHES["nv12_rgb"]

        # (d) IN on an H.264 clip turned 90 degrees: the host's probe, on any machine
        clip = os.path.join(tmp, "in_h264.mp4")
        n = H264_STREAMS["i_only"][0]
        h264_pcm.write_pcm_h264(clip, _h264_sources()["i_only"], 30.0, rotation=90)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            meta = ingest.run(State(input_path=clip))["metadata"]
        finally:
            os.chdir(cwd)
        check((meta["codec"], meta["rotation"], meta["fps"], meta["size"]) == ("h264", 90, 30.0, [320, 240])
              and abs(meta["duration"] - n / 30.0) < 1e-9, f"h264 (d): IN recorded {meta}")
        result["d_ingest"] = {k: meta[k] for k in ("codec", "rotation", "fps", "size", "duration")}

    # (e) timings at 320x240 on a surface at the pitch
    path, _, flat, geo = streams["i_only"]
    luma, uv = _nv12_surface(flat[0], geo, H264_PITCH)
    out = torch.empty((240, 320, 3), dtype=torch.uint8, device="cuda")
    t = interleaved_ms({"ms": lambda: ops.nv12_to_rgb(luma, uv, 320, 240, out=out),
                        "plain_ms": lambda: ops.nv12_to_rgb_plain(luma, uv, 320, 240)})
    t["device_ms"] = graph_ms(lambda: ops.nv12_to_rgb(luma, uv, 320, 240, out=out))
    px = 320 * 240
    nbytes, nops = px * 3 // 2 + 3 * px, 10 * px + 12 * (px // 4)   # the picture in, RGB out; as yuv420_rgb
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, nops / H100_F32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    result["e_nv12_rgb"] = {**t, "device_us": t["device_ms"] * 1e3, "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
                            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes, "ops": nops,
                            "shape": f"320x240 at pitch {H264_PITCH}"}
    # nv12_rgb's main path runs only where the process reaches NVDEC
    CODEC_ROWS["nv12_rgb"] = {"max_abs_err": worst, "ms": t["ms"], "device_ms": t["device_ms"],
                              "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                              "bound_by": result["e_nv12_rgb"]["bound_by"], "on_main_path": available}
    phase("h264", **result)
    return c1_launches


#: the aac phase: the known-answer streams (channels, rate, frames, seed;
#: every syntax path of the parser, 48 kHz resampled to 44.1), the CLI clip's
#: length and its own track's rate (stereo at 48 kHz, as a phone records it,
#: so the resampler runs at a clip's length too)
AAC_STREAMS = ((1, 44100, 48, 1), (2, 48000, 48, 2))
AAC_CLI_SECONDS = 5.0
AAC_CLI_RATE = 48000
#: the kernels against their float64 plain versions: a few float32 steps at
#: the signals' scale (the kernels sum in float64 too, in another order)
AAC_TOL = 1e-6
#: H100 SXM data sheet: float64 on the tensor cores, the card's float64 peak
#: (the measurement guide's table has no float64 entry); aac_synth and
#: audio_resample compute in float64
H100_F64_FLOPS = 67e12


def _aac_synth_flops(meta):
    """The floating-point operations the function ``aac_synth`` computes
    needs at least, for the bound: per frame and channel an FFT-based IMDCT
    (an N-point IMDCT as an N/4-point complex FFT, 5 (N/4) log2(N/4), with
    its pre- and post-twiddles, 6 a complex product, N/4 each), one of
    2048 points for a long window or eight of 256 for short ones, then the
    window and the overlap-add, 3 an output sample."""
    seq = np.asarray(meta[0])
    short = int((seq == 2).sum())

    def imdct(n):
        q = n // 4
        return 5 * q * math.log2(q) + 12 * q

    return (seq.size - short) * imdct(2048) + short * 8 * imdct(256) + seq.size * 3 * 1024


def _aac_direct_flops(meta):
    """The floating-point operations (two a multiply-add) this design of
    ``aac_synth`` does, a direct O(N^2) IMDCT: 1024 multiply-adds an output
    sample of a long frame's half, none for the 448 samples a short-window
    meeting zeroes, 128 a short window's sample."""
    seq, _, pseq, _ = meta
    frames, chans = seq.shape
    macs = 0
    for f in range(frames):
        for c in range(chans):
            long_overlap = pseq[f, c] in (0, 3) and seq[f, c] in (0, 1)
            if seq[f, c] == 2:
                macs += 1024 * 128   # windows 0-4 cover the left half's samples 1024 times in all
            else:
                macs += (1024 if long_overlap else 576) * 1024
            if f:
                if seq[f - 1, c] == 2:
                    macs += 1024 * 128   # windows 3-7 over the right half
                else:
                    macs += (1024 if long_overlap else 576) * 1024
    return 2 * macs


def _aac_clip(tmp):
    """A face clip (``make_face_video``, 320x240 at 30 fps, 44.1 kHz speech)
    as ``mp4v`` with its sound as the track's own AAC (the plain encoder),
    stereo at :data:`AAC_CLI_RATE` (the speech interpolated to that rate,
    0.7 and 0.5 of it in the two channels), no sibling wav -> (that clip,
    the same video without a track, its sibling wav beside it)."""
    from fvd_tpu_torch.synthetic import make_face_video
    from fvd_tpu_torch.utils.wav import read_wav

    src = make_face_video(os.path.join(tmp, "src"), "clip", duration=AAC_CLI_SECONDS, fps=30.0, sr=44100,
                          speech_text=ZOO_SPEECH, container="mp4", device="cuda")
    speech, sr = read_wav(src[:-4] + ".wav")
    t = np.arange(int(len(speech) * AAC_CLI_RATE / sr)) / AAC_CLI_RATE
    up = np.interp(t, np.arange(len(speech)) / sr, speech)
    out = os.path.join(tmp, "clips", "aac_clip.mp4")
    os.makedirs(os.path.dirname(out))
    return _own_aac(src, out, np.stack([0.7 * up, 0.5 * up], axis=1), AAC_CLI_RATE), src


def _aac_kernel_rows(path, ch, rate):
    """``aac_synth`` and ``audio_resample`` against their float64 plain
    versions on the AAC track of ``path``, timed (CUDA events a call, a
    CUDA graph's device time, the plain versions on the host), with their
    bounds; the host parse's ms a frame."""
    import torch

    from fvd_tpu_torch.c1_timing import graph_ms, interleaved_ms
    from fvd_tpu_torch.ops import aac as oaac
    from fvd_tpu_torch.utils import aac, mp4

    data = open(path, "rb").read()
    track = mp4.audio_track(path, data)
    cfg = aac.parse_asc(track.config)
    units = [data[o:o + k] for o, k in zip(track.offsets, track.sizes)]
    t0 = time.perf_counter()
    spectra = aac.decode(cfg, units)
    parse_ms = (time.perf_counter() - t0) * 1e3 / len(units)
    meta = np.stack([spectra.sequence, spectra.shape, spectra.prev_sequence, spectra.prev_shape])
    coef_d, meta_d = torch.from_numpy(spectra.coef).cuda(), torch.from_numpy(meta).cuda()
    pcm_d = oaac.imdct_synth(coef_d, meta_d)
    t0 = time.perf_counter()
    pcm_p = oaac.imdct_synth_plain(spectra.coef, *meta)
    plain_synth = (time.perf_counter() - t0) * 1e3
    synth_err = float(np.abs(pcm_d.cpu().numpy() - pcm_p).max())
    first, end = oaac.output_range(len(units), track.sample_deltas, track.media_time, track.edit_duration)
    src, pcm_np = pcm_d[:, first:end], pcm_p[:, first:end]
    mono_d = oaac.resample(src, rate, 44100)
    t0 = time.perf_counter()
    mono_p = oaac.resample_plain(pcm_np, rate, 44100)
    plain_res = (time.perf_counter() - t0) * 1e3
    check(mono_d.shape[0] == mono_p.shape[0], f"aac: resample lengths {mono_d.shape} {mono_p.shape}")
    res_err = float(np.abs(mono_d.cpu().numpy() - mono_p).max())
    check(synth_err <= AAC_TOL and res_err <= AAC_TOL,
          f"aac: {path}: aac_synth |d| {synth_err}, audio_resample |d| {res_err} > {AAC_TOL}")
    t = interleaved_ms({"synth": lambda: oaac.imdct_synth(coef_d, meta_d),
                        "resample": lambda: oaac.resample(src, rate, 44100)}, warmup=3, rounds=20)
    dev = {"synth": graph_ms(lambda: oaac.imdct_synth(coef_d, meta_d), reps=10, replays=5),
           "resample": graph_ms(lambda: oaac.resample(src, rate, 44100), reps=20, replays=5)}
    n_out = mono_p.shape[0]
    length = oaac.resampler(rate, 44100).length if rate != 44100 else 0
    synth_bytes = spectra.coef.nbytes + meta.nbytes + pcm_p.nbytes
    res_bytes = pcm_np.nbytes + n_out * 4
    res_flops = 2 * n_out * max(length, 1) + (n_out if ch == 2 else 0)
    rows = {}
    for name, err, ms, dms, pms, nbytes, ops, extra in (
            ("aac_synth", synth_err, t["synth"], dev["synth"], plain_synth, synth_bytes, _aac_synth_flops(meta),
             {"design_flops": _aac_direct_flops(meta)}),
            ("audio_resample", res_err, t["resample"], dev["resample"], plain_res, res_bytes, res_flops, {})):
        tb, to = nbytes / H100_BYTES_PER_S, ops / H100_F64_FLOPS
        bound_ms = max(tb, to) * 1e3
        rows[name] = {"max_abs_err": err, "ms": ms, "device_ms": dms, "device_us": dms * 1e3, "plain_host_ms": pms,
                      "bound_ms": bound_ms, "bound_by": "bytes" if tb >= to else "operations",
                      "device_over_bound": dms / bound_ms, "bytes": nbytes, "flops": ops, **extra,
                      "frames": len(units), "channels": ch, "rate": rate}
    return rows, parse_ms


def aac_phase():
    """AAC-LC audio in MP4 on the card: the known-answer streams through
    ``media.extract_audio`` (the counted main path: the host parse, then
    ``aac_synth`` and ``audio_resample``), the card's WAV against the CPU's,
    each kernel against its float64 plain version on those tracks and on a
    5 s clip's own stereo 48 kHz track, and the CLI on that clip (no sibling
    wav): its IN's WAV against the CPU's decode of the track, and its
    probability against the CLI on the same pixels with the CPU's decode as
    a sibling wav; the host parse's ms a frame, the kernels' device time and
    bounds."""
    import torch

    from fvd_tpu_torch import _kernels
    from fvd_tpu_torch.providers import media
    from fvd_tpu_torch.providers import native_decode as nd
    from fvd_tpu_torch.utils import aac_tables, aac_writer
    from fvd_tpu_torch.utils.wav import read_wav

    result = {"nvidia_smi": SMI_LINE, "streams": [dict(zip(("channels", "rate", "frames", "seed"), s))
                                                 for s in AAC_STREAMS], "tolerance": AAC_TOL, "target_sr": 44100}

    def lsb(x, y):
        a, b = read_wav(x)[0], read_wav(y)[0]
        check(a.shape == b.shape, f"aac: WAV lengths {a.shape} {b.shape} ({x}, {y})")
        return int(np.round(np.abs(a - b).max() * 32768))

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for ch, rate, n, seed in AAC_STREAMS:
            index = aac_tables.SAMPLE_RATES.index(rate)
            units = [aac_writer.write_frame(f, index) for f in aac_writer.covering_frames(ch, rate, n=n, seed=seed)]
            path = os.path.join(tmp, f"aac_{ch}_{rate}.mp4")
            nd.write_mp4v(path, np.zeros((3, 16, 16, 3), np.uint8), 10.0, device="cuda",
                          audio=(aac_writer.audio_specific_config(rate, ch), rate, ch, units, 1024))
            paths.append(path)
        # the main path, counted: IN's extract_audio on the card
        _kernels.reset_launches()
        card_wavs = []
        for i, path in enumerate(paths):
            out = os.path.join(tmp, f"card{i}.wav")
            check(media.extract_audio(path, out, 44100, device="cuda") == out, f"aac: no audio from {path}")
            card_wavs.append(out)
        torch.cuda.synchronize()
        launches = {k: _kernels.LAUNCHES[k] for k in AAC_KERNELS}
        check(launches == {k: len(paths) for k in AAC_KERNELS}, f"aac: launches {launches}, one each a track")
        for k in AAC_KERNELS:
            CODEC_LAUNCHES[k] += launches[k]
        result["main_path_launches"] = launches
        # the card's WAVs against the CPU's (the plain versions)
        steps = []
        for i, path in enumerate(paths):
            cpu = os.path.join(tmp, f"cpu{i}.wav")
            media.extract_audio(path, cpu, 44100, device="cpu")
            steps.append(lsb(card_wavs[i], cpu))
        check(max(steps) <= 1, f"aac: card WAVs against the CPU's: {steps} int16 steps")
        result["card_vs_cpu_wav_lsb"] = steps
        # the CLI clip: its own stereo 48 kHz track
        t0 = time.perf_counter()
        clip, src = _aac_clip(tmp)
        result["clip_s"] = time.perf_counter() - t0
        # each kernel against its plain version, on every track; timings
        rows, parse = {}, {}
        tracks = [(f"ka_{ch}ch_{rate}", path, ch, rate) for (ch, rate, _, _), path in zip(AAC_STREAMS, paths)]
        for key, path, ch, rate in tracks + [("clip_2ch_48000", clip, 2, AAC_CLI_RATE)]:
            got, parse[key] = _aac_kernel_rows(path, ch, rate)
            for name, row in got.items():
                rows.setdefault(name, {})[key] = row
        result["kernels"] = rows
        result["host_parse_ms_per_frame"] = parse
        for name in AAC_KERNELS:  # the kernels line takes the clip's row
            r = rows[name]["clip_2ch_48000"]
            CODEC_ROWS[name] = {"max_abs_err": max(v["max_abs_err"] for v in rows[name].values()), "ms": r["ms"],
                                "device_ms": r["device_ms"], "plain_ms": r["plain_host_ms"],
                                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        # the CLI: the AAC clip (no sibling wav), then the same pixels with
        # the CPU's decode of that track (the plain versions) as a sibling wav
        cpu_wav = os.path.join(tmp, "clip_cpu.wav")
        check(media.extract_audio(clip, cpu_wav, 44100, device="cpu") == cpu_wav, "aac: no CPU audio from the clip")
        cwd = os.path.join(tmp, "run")
        os.makedirs(cwd)
        cli = {}
        for name, path in (("aac_track", clip), ("sibling_wav", None)):
            if path is None:
                path = os.path.join(tmp, "clips", "wav_clip.mp4")
                shutil.copy(src, path)
                shutil.copy(cpu_wav, path[:-4] + ".wav")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "fvd_tpu_torch.cli", path], cwd=cwd, env=_subprocess_env(),
                                  capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0, f"aac cli {name}: rc {proc.returncode}: {proc.stderr[-2000:]}")
            last = proc.stdout.strip().splitlines()[-1]
            check(last.startswith("Fake probability: "), f"aac cli {name}: last line {last!r}")
            check("no audio track available" not in proc.stdout, f"aac cli {name}: IN found no audio")
            cli[name] = {"seconds": time.perf_counter() - t0, "fake_probability": float(last.split(": ", 1)[1])}
            if name == "aac_track":
                runs = sorted(glob.glob(os.path.join(cwd, "processed", "video_*", "audio.wav")))
                check(len(runs) == 1, f"aac: the AAC run's audio.wav: {runs}")
                cli[name]["wav_vs_cpu_lsb"] = lsb(runs[0], cpu_wav)
                check(cli[name]["wav_vs_cpu_lsb"] <= 1,
                      f"aac cli: IN's WAV {cli[name]['wav_vs_cpu_lsb']} int16 steps from the CPU's decode")
        dp = abs(cli["aac_track"]["fake_probability"] - cli["sibling_wav"]["fake_probability"])
        check(dp <= STREAM_CLI_TOL, f"aac cli: |dp| {dp} between the AAC track and the CPU's decode as a sibling wav")
        result["cli"] = dict(cli, abs_diff=dp, tolerance=STREAM_CLI_TOL)
    phase("aac", **result)


#: the phases after ``kernel``, in order; ``--only`` runs some of them
PHASES = ("codec", "h264", "aac", "models", "hf", "analyzer", "serving", "dag", "video", "full_dag", "batch", "stream", "ui", "cli",
          "parallel", "train", "net", "zoo_train", "corpus", "text", "fan", "hf_train", "eval", "levers")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run after env, build and kernel (default: all)")
    only = parser.parse_args(argv).only.split(",")
    if not set(only) <= set(PHASES):
        parser.error(f"--only takes phases of {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    global SMI_LINE
    smi_line = SMI_LINE = env_phase()
    build_s = build_phase()
    entry_row = kernel_phase()
    # each phase that drives a main path returns its C1 launches (net's DAG
    # runs among them); the model zoo, the HF models, the trainers and the
    # held-out evaluation launch no kernel of the repo's, and the CLI's
    # launches happen in its own processes and are not counted here
    counted = {"analyzer": analyzer_phase, "serving": serving_phase, "dag": dag_phase, "video": video_phase,
               "full_dag": full_dag_phase, "batch": batch_phase, "stream": stream_phase, "ui": ui_phase,
               "parallel": parallel_phase, "net": net_phase, "corpus": corpus_phase, "eval": eval_phase,
               "levers": levers_phase, "h264": h264_phase}
    uncounted = {"codec": codec_phase, "aac": aac_phase, "models": models_phase, "hf": hf_phase, "cli": cli_phase, "train": train_phase,
                 "zoo_train": zoo_train_phase, "text": text_phase, "fan": fan_phase, "hf_train": hf_train_phase}
    launches = 0
    for name in PHASES:
        if name in counted and name in only:
            launches += counted[name]()
        elif name in only:
            uncounted[name]()

    kernels = [{
        "name": "lipsync_score",
        "route": "cuda",
        "source": "fvd_tpu_torch/csrc/lipsync_score.cu",
        "replaces": "fvd_tpu/ops/lipsync.py:161 (+ jitted stage :284-328)",
        "launches": launches,
        "max_abs_err": entry_row["max_abs_err"],
        "ms": entry_row["ms"],
        "device_ms": entry_row["device_ms"],
        "stage_ops": entry_row["stage_ops"],
        "plain_ms": entry_row["plain_ms"],
        "bound_ms": entry_row["bound_ms"],
        "bound_by": entry_row["bound_by"],
        "library_ms": entry_row["library_ms"],
        "build_s": build_s["lipsync_score"],
    }]
    for name in ROW_KERNELS:
        row = CODEC_ROWS.get(name, {})
        if MAIN_PATH_PHASE[name] in only and row.get("on_main_path", True):
            check(CODEC_LAUNCHES[name] > 0, f"{name}: no launch on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": f"fvd_tpu_torch/csrc/{CODEC_SOURCES[name]}.cu",
            "replaces": CODEC_REPLACES[name], "launches": CODEC_LAUNCHES[name],
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"), "device_ms": row.get("device_ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": None, "build_s": build_s[name]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
