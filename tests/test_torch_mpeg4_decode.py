"""The port's MPEG-4 Part 2 decoder (``fvd_tpu_torch/utils/mpeg4v.py`` on the
host, ``fvd_tpu_torch/ops/mpeg4.py``'s plain versions on the CPU) against the
JAX package's ``VideoReader`` (its libav shim and OpenCV) on the files the JAX
package writes: a face clip, and a shifting texture whose P-VOPs carry real
half-pel motion.  The port mirrors ``tests/test_native_decode.py``,
``tests/test_frame_cache.py`` and ``tests/test_chunked_streaming.py``."""

import functools

import numpy as np
import pytest
import torch

from fvd_tpu.providers import native_decode as jnd
from fvd_tpu.providers.media import StreamingSampler as JSampler
from fvd_tpu.providers.media import VideoReader as JReader
from fvd_tpu.providers.media import write_video as jax_write_video
from fvd_tpu.synthetic import make_face_video as jax_make_face_video
from fvd_tpu_torch.ops import mpeg4 as tops
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers import native_decode as tnd
from fvd_tpu_torch.utils import mp4, mpeg4v
from fvd_tpu_torch.utils import mpeg4v_ka as ka
from fvd_tpu_torch.utils.avi import UnsupportedVideo

#: the bars against the JAX package's readers, per RGB channel
MAX_BAR, MEAN_BAR = 2, 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers); the
    port's video decodes on ``device="cpu"`` (the plain versions)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tmedia.clear_frame_cache()
    torch.set_num_threads(threads)


def texture_frames(n=30, h=48, w=64, seed=0):
    """A smooth random texture moving by (1.5, 0.5) px a frame (drawn at twice
    the size and averaged down): the encoder's motion search finds whole- and
    half-pel vectors."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (2 * h + n, 2 * w + 3 * n, 3)).astype(np.float32)
    for _ in range(4):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1) + np.roll(base, 1, (0, 1))) / 4
    frames = [base[t:t + 2 * h, 3 * t:3 * t + 2 * w].reshape(h, 2, w, 2, 3).mean(axis=(1, 3))
              for t in range(n)]
    return np.clip(np.stack(frames) * 1.5 - 64, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp4v")
    texture = str(d / "texture.mp4")
    jax_write_video(texture, texture_frames(), 10.0)
    face = jax_make_face_video(str(d), "face", duration=4.0, fps=10.0)
    return {"texture": texture, "face": face}


@functools.lru_cache(maxsize=None)
def _decode_all(path):
    """Every frame of ``path`` through the port (plain versions) and through
    the JAX package's reader, decoded once per file for the module."""
    meta = JReader(use_cache=False).probe(path)
    ours, kept = tmedia.VideoReader(use_cache=False).sample(path, range(meta.frame_count), device="cpu")
    theirs, kept_j = JReader(use_cache=False).sample(path, range(meta.frame_count))
    assert kept == kept_j == list(range(meta.frame_count))
    return ours.astype(np.int64), theirs.astype(np.int64)


@pytest.mark.parametrize("name", ["texture", "face"])
def test_decode_matches_jax_reader(clips, name):
    ours, theirs = _decode_all(clips[name])
    d = np.abs(ours - theirs)
    assert d.max() <= MAX_BAR and d.mean() <= MEAN_BAR
    if jnd.available():  # the shim and OpenCV take the same libswscale path here
        cv, _ = JReader(use_cache=False)._sample_cv2(clips[name], range(len(ours)))
        assert np.abs(ours - cv).max() <= MAX_BAR


@pytest.mark.parametrize("name", ["texture", "face"])
def test_no_drift_over_a_gop(clips, name):
    """The last P-VOP of each GOP is within the I-VOP's bar: an IDCT or a
    motion compensation that is off by one would build up over 11 P-VOPs."""
    ours, theirs = _decode_all(clips[name])
    err = np.abs(ours - theirs).reshape(len(ours), -1)
    for start in range(0, len(ours), tnd.GOP):
        last = min(start + tnd.GOP, len(ours)) - 1
        for i in (start, last):
            assert err[i].max() <= MAX_BAR and err[i].mean() <= MEAN_BAR, i


def parsed_vops(path, n=None):
    """The first ``n`` samples of ``path`` (all by default) through
    ``parse_vops`` on the CPU, as host ``VopData``, and the geometry."""
    data = open(path, "rb").read()
    track = mp4.parse(path, data)
    samples = [data[o:o + s] for o, s in zip(track.offsets, track.sizes)][:n]
    vol = mpeg4v.find_vol(track.config) or mpeg4v.find_vol(samples[0])
    geo = tops.Geometry(vol.width, vol.height)
    rng = tops.parse_vops(*mpeg4v.scan_samples(samples, vol), "cpu")
    return [rng.vop(i, geo) for i in range(len(rng))], geo


def test_texture_p_vops_carry_half_pel_motion(clips):
    vops, _ = parsed_vops(clips["texture"], tnd.GOP)
    kinds = "".join(x.kind for x in vops)
    assert kinds == "I" + "P" * (tnd.GOP - 1)
    mv = np.concatenate([x.mv.reshape(-1, 6, 2)[:, :4] for x in vops[1:]]).reshape(-1, 2)
    assert np.abs(mv).max() >= 2                 # whole-pel motion
    assert (mv % 2 != 0).any()                   # and half-pel
    assert {x.rounding for x in vops[1:]} == {0, 1}


def test_read_frames_out_of_range_and_forward_only(clips):
    """As the shim: ids past the end are dropped (and the pass reads to the
    end looking for them), and a session reads forward, so ids before its
    position are dropped too."""
    path = clips["texture"]
    calls = [[7, 3, 7], [5, 29, 500], [29]]
    with tnd.NativeVideo(path, device="cpu") as v:
        ours = [v.read_frames(ids) for ids in calls]
    assert [k for _, k in ours] == [[3, 7], [29], []]
    assert ours[0][0].shape == (2, 48, 64, 3)
    if jnd.available():
        with jnd.NativeVideo(path) as j:
            theirs = [j.read_frames(ids) for ids in calls]
        assert [k for _, k in theirs] == [k for _, k in ours]
        for (a, _), (b, _) in zip(ours[:2], theirs[:2]):
            assert np.abs(a.astype(int) - b.astype(int)).max() <= MAX_BAR


def test_reader_caches_and_serves_subsets(clips):
    path = clips["face"]
    tmedia.clear_frame_cache()
    reader = tmedia.VideoReader()
    frames, kept = reader.sample(path, range(0, 40, 5), device="cpu")
    again, kept2 = reader.sample(path, [10, 20, 0], device="cpu")
    assert kept2 == [0, 10, 20]
    np.testing.assert_array_equal(again, frames[[0, 2, 4]])
    tmedia.clear_frame_cache()


def test_streaming_sampler_chunks_match_jax(clips):
    path, ids = clips["face"], list(range(0, 40, 3))
    ours = list(tmedia.StreamingSampler(path, ids, chunk_size=4, device="cpu"))
    theirs = list(JSampler(path, ids, chunk_size=4))
    assert [k for _, k in ours] == [k for _, k in theirs]
    assert [len(k) for _, k in ours] == [4, 4, 4, 2]
    for (a, _), (b, _) in zip(ours, theirs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= MAX_BAR


def _vol(**change):
    """VOL header bits in field order, with ``change`` overriding fields."""
    f = dict(random=0, type=1, is_id=1, verid=1, prio=1, aspect=1, ctrl=1, chroma=1, low_delay=1,
             vbv=0, shape=0, res=10, fixed=0, width=64, height=48, interlaced=0, obmc=1, sprite=0,
             not8=0, quant=0, qpel=0, complexity=1, resync=1, partitioned=0, scal=0)
    f.update(change)
    w = mpeg4v.BitWriter()
    w.start_code(0x120)
    w.put(1, f["random"]); w.put(8, f["type"]); w.put(1, f["is_id"]); w.put(4, f["verid"]); w.put(3, f["prio"])
    w.put(4, f["aspect"]); w.put(1, f["ctrl"]); w.put(2, f["chroma"]); w.put(1, f["low_delay"]); w.put(1, f["vbv"])
    w.put(2, f["shape"]); w.put(1, 1); w.put(16, f["res"]); w.put(1, 1); w.put(1, f["fixed"]); w.put(1, 1)
    w.put(13, f["width"]); w.put(1, 1); w.put(13, f["height"]); w.put(1, 1)
    w.put(1, f["interlaced"]); w.put(1, f["obmc"]); w.put(1 if f["verid"] == 1 else 2, f["sprite"])
    w.put(1, f["not8"]); w.put(1, f["quant"])
    if f["verid"] != 1:
        w.put(1, f["qpel"])
    w.put(1, f["complexity"]); w.put(1, f["resync"]); w.put(1, f["partitioned"])
    if f["verid"] != 1:
        w.put(2, 0)
    w.put(1, f["scal"])
    w.stuffing()
    return w.getvalue()


@pytest.mark.parametrize("change,expect", [
    ({"interlaced": 1}, "interlaced"),
    ({"quant": 1}, "quant_type 1"),
    ({"partitioned": 1}, "data partitioning"),
    ({"shape": 1}, "non-rectangular"),
    ({"sprite": 1}, "sprites"),
    ({"verid": 2, "qpel": 1}, "quarter-pel"),
    ({"chroma": 2}, "4:2:0"),
])
def test_profile_features_outside_simple_raise_naming_them(change, expect):
    assert mpeg4v.find_vol(_vol()).width == 64
    with pytest.raises(UnsupportedVideo, match=expect):
        mpeg4v.find_vol(_vol(**change))


@pytest.mark.parametrize("coding_type,expect", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_b_and_s_vops_raise(coding_type, expect):
    vol = mpeg4v.find_vol(_vol())
    w = mpeg4v.BitWriter()
    w.start_code(mpeg4v.VOP_START)
    w.put(2, coding_type)
    w.put(32, 0)
    w.align_zero()
    with pytest.raises(UnsupportedVideo, match=expect):
        mpeg4v.Decoder(vol).decode(w.getvalue())


def test_resync_markers_raise(clips):
    """A VOL that allows video packets, and a VOP that starts one."""
    vol = mpeg4v.find_vol(_vol(resync=0))
    w = mpeg4v.BitWriter()
    w.start_code(mpeg4v.VOP_START)
    w.put(2, 0); w.put(1, 0); w.put(1, 1); w.put(vol.time_bits, 0); w.put(1, 1); w.put(1, 1)
    w.put(3, 0); w.put(5, 3)
    w.put(17, 1)  # a resync marker where the first macroblock should be
    w.stuffing()
    with pytest.raises(UnsupportedVideo, match="resync"):
        mpeg4v.Decoder(vol).decode(w.getvalue())


def _simple_idct_row_col(block):
    """libavcodec's 8-bit ``simple_idct`` put, one scalar row and column at a
    time, with C's 16- and 32-bit wrapping: the reference for the
    vectorised plain version."""
    w1, w2, w3, w4, w5, w6, w7 = tops.W1, tops.W2, tops.W3, tops.W4, tops.W5, tops.W6, tops.W7

    def s32(x):
        return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31

    def s16(x):
        return ((x + 2 ** 15) % 2 ** 16) - 2 ** 15

    b = [[s16(int(v)) for v in block[r * 8:r * 8 + 8]] for r in range(8)]
    for row in b:
        if not any(row[1:]):
            row[:] = [s16(row[0] * 8)] * 8
            continue
        a0 = w4 * row[0] + 1024
        a = [a0 + w2 * row[2] + w4 * row[4] + w6 * row[6], a0 + w6 * row[2] - w4 * row[4] - w2 * row[6],
             a0 - w6 * row[2] - w4 * row[4] + w2 * row[6], a0 - w2 * row[2] + w4 * row[4] - w6 * row[6]]
        bb = [w1 * row[1] + w3 * row[3] + w5 * row[5] + w7 * row[7],
              w3 * row[1] - w7 * row[3] - w1 * row[5] - w5 * row[7],
              w5 * row[1] - w1 * row[3] + w7 * row[5] + w3 * row[7],
              w7 * row[1] - w5 * row[3] + w3 * row[5] - w1 * row[7]]
        row[:] = [s16(s32(a[i] + bb[i]) >> 11) for i in range(4)] + \
            [s16(s32(a[3 - i] - bb[3 - i]) >> 11) for i in range(4)]
    out = np.zeros((8, 8), np.int64)
    for c in range(8):
        col = [b[r][c] for r in range(8)]
        a0 = w4 * (col[0] + 32)
        a = [a0 + w2 * col[2] + w4 * col[4] + w6 * col[6], a0 + w6 * col[2] - w4 * col[4] - w2 * col[6],
             a0 - w6 * col[2] - w4 * col[4] + w2 * col[6], a0 - w2 * col[2] + w4 * col[4] - w6 * col[6]]
        bb = [w1 * col[1] + w3 * col[3] + w5 * col[5] + w7 * col[7],
              w3 * col[1] - w7 * col[3] - w1 * col[5] - w5 * col[7],
              w5 * col[1] - w1 * col[3] + w7 * col[5] + w3 * col[7],
              w7 * col[1] - w5 * col[3] + w3 * col[5] - w1 * col[7]]
        vals = [s32(a[i] + bb[i]) >> 20 for i in range(4)] + [s32(a[3 - i] - bb[3 - i]) >> 20 for i in range(4)]
        out[:, c] = vals
    return out


def test_plain_idct_is_simple_idct():
    rng = np.random.RandomState(0)
    blocks = np.zeros((64, 64), np.int64)
    blocks[:16] = rng.randint(-2048, 2048, (16, 64))             # dense, full range
    blocks[16:32, 0] = rng.randint(-2048, 2048, 16)              # DC only, past 1024
    blocks[32:48, rng.randint(0, 64, 16)] = rng.randint(-300, 300, 16)  # sparse
    blocks[48:, :8] = rng.randint(-50, 50, (16, 8))              # first row only
    got = tops.idct_plain(torch.from_numpy(blocks)).numpy()
    for i in range(64):
        np.testing.assert_array_equal(got[i], _simple_idct_row_col(blocks[i]))


def test_not_coded_vop_repeats_the_previous_frame(tmp_path):
    """A not-coded VOP gives no frame and leaves the reference as it was: a
    known-answer stream with one reads to the frames of the same stream
    without it."""
    specs = ka.covering_stream(64, 48, 8, seed=0)
    assert specs[4].kind == "N"
    paths = str(tmp_path / "with.mp4"), str(tmp_path / "without.mp4")
    ka.write_mp4(paths[0], 64, 48, 10.0, specs)
    ka.write_mp4(paths[1], 64, 48, 10.0, specs[:4] + specs[5:])
    read = []
    for path in paths:
        with tnd.NativeVideo(path, device="cpu") as v:
            read.append(v.read_frames(range(8)))
    assert read[0][1] == read[1][1] == list(range(7))
    np.testing.assert_array_equal(read[0][0], read[1][0])
