"""Generate a labeled fake/real video corpus for the batch harness:

    python -m fvd_tpu_torch.tools.make_labeled_corpus --out videos --n-real 6 --n-fake 6
    python -m fvd_tpu_torch.tools.make_labeled_corpus --ambiguous 4 --hard-reals 4

The counterpart of the JAX package's ``tools/make_labeled_corpus.py``, with
its flags, defaults, recipes, seeds and names.  The reference's defining
artifact is a labeled 11-video corpus whose accuracy climbs 63.64% -> 100%
under online LR training (``batch_test.py:158-189``); this builds the
equivalent: procedural-face clips, labels encoded in the file name the way
the reference's loader reads them (``batch_test.py:33-37`` keywords), fakes
carrying the manipulations the LR features detect:

* lip-sync break   — a mouth driven at another rate than the audio gate (C1 down)
* texture tamper   — additive face-region noise (V5 up)
* pose jitter      — per-frame head displacement (headpose_jerk up)

Each clip also speaks a distinct sentence, in the speech domain of the
shipped ASR checkpoint, so the transcript -> claims -> evidence chain
contributes features.  The clips are drawn with OpenCV's rasterisation
(``make_face_video(..., opencv=True)``), so their pixels are the JAX
corpus's before its mp4 encoding; each is a raw-RGBA AVI named
``<name>.mp4`` (the batch harness globs ``*.mp4`` and reads by content),
with ``<name>.wav`` beside it.  No card is needed.
"""

from __future__ import annotations

import argparse
import os

from fvd_tpu_torch.providers.factory import asr_speech_domain, default_checkpoint_dir
from fvd_tpu_torch.synthetic import make_face_video

SENTENCES = [
    "the mayor said the city will cut taxes next year",
    "the river level rose two feet after the storm",
    "the new bridge opened to traffic last month",
    "the school board voted to extend the year",
    "the state added nine thousand jobs in july",
    "the court ruled the ban can not take effect",
    "the team won the final game by six points",
    "the museum opened a wing for modern art",
    "the port will close two docks for repairs",
    "the county fair drew a record crowd this summer",
    "the library will stay open late on fridays",
    "the airline added three routes to the coast",
]

#: per-fake manipulation recipes (cycled): desync-only, texture-only,
#: all-three, desync+texture — the corpus shouldn't be separable on one
#: feature alone.  Desync = incommensurate mouth frequency (a lag shift
#: alone stays inside C1's ±0.5 s search window and never breaks sync).
FAKE_RECIPES = [
    {"mouth_gate_hz": 1.37},
    {"texture_noise": 14.0},
    {"mouth_gate_hz": 1.37, "texture_noise": 14.0, "pose_jitter": 2.5},
    {"mouth_gate_hz": 0.71, "texture_noise": 10.0},
]

#: feature-ambiguous recipes: manipulations at the edge of each feature's
#: sensitivity — near-band desync whose mouth track still partly correlates
#: inside C1's ±0.5 s lag search, texture noise below V5's comfortable band,
#: and a pose wobble alone.  With these in the corpus, run-1 accuracy starts
#: below 100% (like the reference's 63.64%) and the online-learning climb
#: shows in the accuracy itself, not only in the attempts.
AMBIGUOUS_RECIPES = [
    {"mouth_gate_hz": 1.13},                        # near-band desync only
    {"texture_noise": 6.0},                         # sub-threshold texture
    {"pose_jitter": 1.4},                           # pose wobble only
    {"mouth_gate_hz": 0.89, "texture_noise": 4.0},  # both, faint
]

#: hard-real recipes: genuine videos under real-world capture degradation —
#: whole-frame sensor noise (low light, recompression) that raises V5's
#: forensic texture score and degrades landmark and lip tracking on an
#: unmanipulated clip, with short exclamatory speech that holds no verifiable
#: claim (C3 extracts nothing, so claim and evidence reliability stay 0, like
#: the reference corpus's Biden clip).  Under the pretrained LR weights these
#: start on the fake side of the threshold with a deficit near the 100-retry
#: SGD budget: the false-positive hard case.
HARD_REAL_RECIPES = [
    ({"sensor_noise": 20.0}, "so very cool"),
    ({"sensor_noise": 26.0}, "wow just wow"),
    ({"sensor_noise": 22.0, "pose_jitter": 1.0}, "that was close"),
    ({"sensor_noise": 24.0}, "oh my word"),
]


def corpus_speech(renderer: str | None = None) -> str:
    """``make_face_video``'s ``speech`` for a speech domain, ``"formant"`` or
    ``"tone"`` (default: the shipped ASR checkpoint's): the JAX package's
    formant renderer is the port's ``"formant_gated"``."""
    if renderer is None:
        renderer = asr_speech_domain(default_checkpoint_dir())
    return "formant_gated" if renderer.startswith("formant") else "tone"


def write_clip(out_dir, name, speech, **kw) -> str:
    """One corpus clip drawn with OpenCV's rasterisation, written as
    ``<name>.avi`` and renamed ``<name>.mp4`` -> its path."""
    avi = make_face_video(out_dir, name=name, speech=speech, opencv=True, **kw)
    mp4 = avi[:-len(".avi")] + ".mp4"
    os.replace(avi, mp4)
    return mp4


def build_corpus(out_dir: str, n_real: int, n_fake: int, duration: float,
                 fps: float = 30.0, width: int = 320, height: int = 240,
                 renderer: str | None = None, n_ambiguous: int = 0,
                 n_hard_real: int = 0, seed_offset: int = 0):
    """The corpus in ``out_dir`` -> its clips' paths: ``n_real`` plain reals
    (seeds 100 + i), ``n_fake`` fakes (200 + j, :data:`FAKE_RECIPES`),
    ``n_ambiguous`` subtle fakes (300 + k) and ``n_hard_real`` noisy reals
    (400 + m), every seed shifted by ``seed_offset`` (fresh instances of the
    same families).  ``renderer`` is the speech domain, ``"formant"`` or
    ``"tone"`` (default: the shipped ASR checkpoint's)."""
    speech = corpus_speech(renderer)
    common = dict(duration=duration, fps=fps, width=width, height=height)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n_real):
        paths.append(write_clip(out_dir, f"clip{i:02d}_real_news", speech, seed=seed_offset + 100 + i,
                                speech_text=SENTENCES[i % len(SENTENCES)], **common))
    for j in range(n_fake):
        paths.append(write_clip(out_dir, f"clip{n_real + j:02d}_deepfake", speech, seed=seed_offset + 200 + j,
                                speech_text=SENTENCES[(n_real + j) % len(SENTENCES)],
                                **FAKE_RECIPES[j % len(FAKE_RECIPES)], **common))
    for k in range(n_ambiguous):
        idx = n_real + n_fake + k
        paths.append(write_clip(out_dir, f"clip{idx:02d}_subtle_deepfake", speech, seed=seed_offset + 300 + k,
                                speech_text=SENTENCES[idx % len(SENTENCES)],
                                **AMBIGUOUS_RECIPES[k % len(AMBIGUOUS_RECIPES)], **common))
    for m in range(n_hard_real):
        recipe, text = HARD_REAL_RECIPES[m % len(HARD_REAL_RECIPES)]
        idx = n_real + n_fake + n_ambiguous + m
        paths.append(write_clip(out_dir, f"clip{idx:02d}_real_vlog", speech, seed=seed_offset + 400 + m,
                                speech_text=text, **recipe, **common))
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="videos")
    ap.add_argument("--n-real", type=int, default=6)
    ap.add_argument("--n-fake", type=int, default=6)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--ambiguous", type=int, default=0,
                    help="additional feature-ambiguous fakes (AMBIGUOUS_RECIPES, cycled)")
    ap.add_argument("--hard-reals", type=int, default=0,
                    help="additional noisy genuine clips with no verifiable claims "
                         "(HARD_REAL_RECIPES, cycled): the false-positive hard cases")
    args = ap.parse_args(argv)
    paths = build_corpus(args.out, args.n_real, args.n_fake, args.duration,
                         fps=args.fps, n_ambiguous=args.ambiguous,
                         n_hard_real=args.hard_reals)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
