"""The port's H.264 reading (``fvd_tpu_torch/utils/h264.py``, the ``avc1``
entry of ``utils/mp4.py``, ``providers/nvdec.py``) and its known-answer writer
(``utils/h264_pcm.py``) against the JAX package's readers, its libav shim and
OpenCV, which decode H.264 with libavcodec.  The writer's files must read to
its expected frames bit for bit, in display order (I-only, IPBPB over two
GOPs with still frames, a height off the macroblock grid, YUV planes of
0x00-0x03 runs); the port's probe must equal the shim's.  Mirrors
``tests/test_native_decode.py`` and ``tests/test_ingest.py``.  NVDEC itself
runs on the card only (``tests/test_torch_cuda.py``); here a stand-in session
drives ``NvdecVideo.read_frames``'s pass over the stream."""

import ctypes

import cv2
import numpy as np
import pytest
import torch

from fvd_tpu.nodes import ingest as jingest
from fvd_tpu.providers import native_decode as jnd
from fvd_tpu.providers.media import VideoReader as JReader
from fvd_tpu_torch.nodes import ingest as tingest
from fvd_tpu_torch.ops import mpeg4 as tops
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers import native_decode as tnd
from fvd_tpu_torch.providers import nvdec as tnv
from fvd_tpu_torch.utils import h264, h264_pcm, mp4
from fvd_tpu_torch.utils.avi import UnsupportedVideo


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (the suite runs six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tmedia.clear_frame_cache()
    torch.set_num_threads(threads)


def moving(n, h, w, seed=0, still=()):
    """A smoothed random texture moving by a pixel a frame; the frames in
    ``still`` repeat the one before (all-skip P pictures)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + n, w + n, 3)).astype(np.float32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    out = [base[i:i + h, i:i + w] for i in range(n)]
    for i in still:
        out[i] = out[i - 1]
    return np.stack(out).astype(np.uint8)


def low_planes(n=6, h=48, w=64, seed=1):
    """Y, Cb, Cr planes of 0x00-0x03 runs (and full-scale Cr columns): every
    PCM sample run needs emulation prevention."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, (n, h, w)).astype(np.uint8)
    y[:, :8] = 0
    u = rng.randint(0, 4, (n, h // 2, w // 2)).astype(np.uint8)
    v = np.zeros_like(u)
    v[:, ::3] = 255
    y[2], u[2], v[2] = y[1], u[1], v[1]
    return y, u, v


def colour_sweep(n=4, h=128, w=512):
    """Y planes of every value 0-255 (two columns each) against Cb over the
    rows and Cr over the columns in steps that cover the range: the
    readers' colour arithmetic at every luma value."""
    y = np.broadcast_to((np.arange(w) // 2).astype(np.uint8), (n, h, w)).copy()
    rows = (np.arange(h // 2)[None, :] * 4 + 64 * np.arange(n)[:, None]) % 256
    cols = (np.arange(w // 2)[None, :] * 37 + 11 * np.arange(n)[:, None]) % 256
    u = np.broadcast_to(rows[:, :, None], (n, h // 2, w // 2)).astype(np.uint8)
    v = np.broadcast_to(cols[:, None, :], (n, h // 2, w // 2)).astype(np.uint8)
    return y, u.copy(), v.copy()


#: name -> (source, fps, pattern, writer options)
STREAMS = {
    "i_only": (lambda: moving(5, 240, 320), 30.0, None, {}),
    "ipbpb": (lambda: moving(24, 240, 320, still=(4, 5, 6, 15)), 30.0, h264_pcm.gop_pattern(24), {}),
    "cropped": (lambda: moving(8, 180, 320, seed=2), 25.0, h264_pcm.gop_pattern(8, 4), {}),
    "low_samples": (low_planes, 10.0, "IPPBPP", {}),
    "colour_sweep": (colour_sweep, 10.0, None, {}),
    "high_rot90": (lambda: moving(4, 64, 96, seed=3), 10.0, "IPBP", {"high": True, "rotation": 90}),
    "tiny": (lambda: moving(6, 40, 72, seed=4), 30.0, h264_pcm.gop_pattern(6), {}),
}
#: the shim crashes on files as small as 72x40 (its x86 colour path): cv2 only
SHIM_STREAMS = [k for k in STREAMS if k != "tiny"]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("h264")
    out = {}
    for name, (make, fps, pattern, kw) in STREAMS.items():
        path = str(d / f"{name}.mp4")
        out[name] = (path, h264_pcm.write_pcm_h264(path, make(), fps, pattern, **kw))
    return out


def _cv2_frames(path):
    """Every frame as OpenCV decodes it, unrotated (OpenCV 5 turns a frame by
    the ``tkhd`` rotation unless told not to)."""
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 0)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(bgr[..., ::-1])
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("name", SHIM_STREAMS)
def test_known_answer_read_by_jax_shim(streams, name):
    if not jnd.available():
        pytest.skip("the JAX package's libav shim is not built here")
    path, expect = streams[name]
    with jnd.NativeVideo(path) as v:
        got, kept = v.read_frames(range(len(expect)))
    assert kept == list(range(len(expect)))
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("name", list(STREAMS))
def test_known_answer_read_by_cv2(streams, name):
    path, expect = streams[name]
    np.testing.assert_array_equal(_cv2_frames(path), expect)


@pytest.mark.parametrize("name", SHIM_STREAMS)
def test_probe_matches_jax_shim(streams, name):
    if not jnd.available():
        pytest.skip("the JAX package's libav shim is not built here")
    path, expect = streams[name]
    with tnd.open_video(path) as ours, jnd.NativeVideo(path) as theirs:
        assert isinstance(ours, tnv.NvdecVideo)
        p, q = ours.probe(), theirs.probe()
        assert p[:4] == q[:4] and p[5] == q[5] is False
        assert p[4] == pytest.approx(q[4], abs=1e-9)  # the movie header's duration, elst or not
        assert ours.probe_extra() == theirs.probe_extra() == (90 if "rot90" in name else 0, "h264")
    a, b = tmedia.VideoReader(use_cache=False).probe(path), JReader(use_cache=False).probe(path)
    assert (a.fps, a.frame_count, a.width, a.height) == (b.fps, b.frame_count, b.width, b.height)
    assert (a.frame_count, a.height, a.width) == expect.shape[:3]


def test_b_pictures_get_ctts_and_elst(streams):
    """Coding order I P B P B ...: each B is shown before the P it follows,
    so the samples carry composition offsets and the edit starts at the first
    one, as FFmpeg's muxer writes it."""
    path, _ = streams["ipbpb"]
    data = open(path, "rb").read()
    t = mp4.parse(path, data)
    d = t.sample_deltas[0]
    order = h264_pcm.decode_order(h264_pcm.gop_pattern(24))
    assert order[:6] == [0, 2, 1, 4, 3, 6]
    assert t.composition_offsets == [(i - j + 1) * d for j, i in enumerate(order)]
    assert t.media_time == t.composition_offsets[0] == d
    assert t.sync == [0, 12] and t.codec == "h264" and t.fourcc == "avc1"
    cfg = h264.parse_avcc(t.config)
    nals = h264.split_length_prefixed(data[t.offsets[1]:t.offsets[1] + t.sizes[1]], cfg.length_size)
    assert [h264.nal_type(n) for n in nals] == [h264.NAL_SLICE]
    assert h264.parse_sps(cfg.sps[0]).max_num_reorder_frames == 1


def test_annexb_access_unit_puts_parameter_sets_ahead_of_sync_samples(streams):
    path, _ = streams["ipbpb"]
    data = open(path, "rb").read()
    t = mp4.parse(path, data)
    cfg = h264.parse_avcc(t.config)
    first = h264.annexb_access_unit(data[t.offsets[0]:t.offsets[0] + t.sizes[0]], cfg, True)
    second = h264.annexb_access_unit(data[t.offsets[1]:t.offsets[1] + t.sizes[1]], cfg, False)
    assert [h264.nal_type(n) for n in h264.split_annexb(first)] == [h264.NAL_SPS, h264.NAL_PPS, h264.NAL_IDR]
    assert [h264.nal_type(n) for n in h264.split_annexb(second)] == [h264.NAL_SLICE]
    assert h264.split_annexb(first)[0] == cfg.sps[0]


def test_high_profile_sps_with_scaling_lists(streams):
    """The scaling lists (explicit, default and repeating) are skipped
    exactly: what follows them reads right, and libavcodec, which read the
    same SPS, decoded the file to the expected frames (the shim test)."""
    path, _ = streams["high_rot90"]
    t = mp4.parse(path, open(path, "rb").read())
    sps = h264.parse_sps(h264.parse_avcc(t.config).sps[0])
    assert (sps.profile_idc, sps.chroma_format_idc, sps.bit_depth_luma) == (100, 1, 8)
    assert sps.scaling_matrix_present
    assert (sps.width, sps.height, sps.mb_width, sps.mb_height) == (96, 64, 6, 4)
    assert (sps.max_num_ref_frames, sps.max_num_reorder_frames, sps.max_dec_frame_buffering) == (2, 1, 2)
    assert (sps.log2_max_frame_num, sps.log2_max_poc_lsb, sps.pic_order_cnt_type) == (16, 16, 0)
    assert t.rotation == 90


def test_cropped_display_size(streams):
    path, _ = streams["cropped"]
    sps = h264.parse_sps(h264.parse_avcc(mp4.parse(path, open(path, "rb").read()).config).sps[0])
    assert (sps.mb_width, sps.mb_height, sps.crop, sps.width, sps.height) == (20, 12, (0, 0, 0, 6), 320, 180)


def test_emulation_prevention_in_samples(streams):
    """Runs of 0x00-0x03 samples: the writer escapes them and unescaping
    gives the RBSP back; no NAL unit holds a start code's prefix."""
    path, _ = streams["low_samples"]
    data = open(path, "rb").read()
    t = mp4.parse(path, data)
    escapes = 0
    for off, size in zip(t.offsets, t.sizes):
        for nal in h264.split_length_prefixed(data[off:off + size], 4):
            for bad in (b"\x00\x00\x00", b"\x00\x00\x01", b"\x00\x00\x02"):
                assert bad not in nal
            escapes += nal.count(b"\x00\x00\x03")
            assert h264.escape(h264.unescape(nal[1:])) == nal[1:]
    assert escapes > 1000


@pytest.mark.parametrize("seed", range(4))
def test_escape_unescape_roundtrip(seed):
    rng = np.random.RandomState(seed)
    raw = bytes(rng.choice([0, 0, 0, 1, 2, 3, 4, 255], 4000).astype(np.uint8).tolist()) + b"\x80"
    esc = h264.escape(raw)
    assert h264.unescape(esc) == raw
    for bad in (b"\x00\x00\x00", b"\x00\x00\x01", b"\x00\x00\x02"):
        assert bad not in esc
    assert esc.count(b"\x00\x00\x03") > raw.count(b"\x00\x00\x03")


def test_exp_golomb_roundtrip():
    w = h264.BitWriter()
    values = [0, 1, 2, 3, 7, 8, 254, 255, 65535, 1 << 20]
    for v in values:
        w.ue(v)
        w.se(v)
        w.se(-v)
        w.u(5, v & 31)
    r = h264.BitReader(w.trailing())
    for v in values:
        assert (r.ue(), r.se(), r.se(), r.u(5)) == (v, v, -v, v & 31)


def _avc_file(path, sps):
    """An ``avc1`` MP4 of one sample whose ``avcC`` holds ``sps``."""
    pps = h264_pcm.write_pps()
    with mp4.Mp4Writer(path, 32, 32, 10.0, h264.write_avcc(sps, pps), codec="avc1") as out:
        out.write(b"\x00\x00\x00\x02\x65\x88", sync=True)


@pytest.mark.parametrize("feature,kw,match", [
    ("10 bit", {"bit_depth": 10}, "bit depth 10"),
    ("4:4:4", {"chroma_format_idc": 3}, "4:4:4"),
    ("4:2:2", {"chroma_format_idc": 2}, "4:2:2"),
    ("monochrome", {"chroma_format_idc": 0}, "monochrome"),
    ("interlace", {"frame_mbs_only": False}, "interlaced"),
    ("full range", {"full_range": True}, "full-range"),
])
def test_unsupported_streams_raise_naming_the_feature(tmp_path, feature, kw, match):
    path = str(tmp_path / "v.mp4")
    _avc_file(path, h264_pcm.write_sps(2, 2, **kw))
    with pytest.raises(UnsupportedVideo, match=match):
        tmedia.VideoReader(use_cache=False).probe(path)
    with pytest.raises(UnsupportedVideo, match=match):
        tnv.NvdecVideo(path, device="cuda")


def test_avc1_without_avcc_raises_naming_avc1(tmp_path):
    path = str(tmp_path / "v.mp4")
    _avc_file(path, h264_pcm.write_sps(2, 2))
    data = open(path, "rb").read()
    open(path, "wb").write(data.replace(b"avcC", b"xxxx"))
    with pytest.raises(UnsupportedVideo, match="avc1"):
        tmedia.VideoReader(use_cache=False).probe(path)


def test_nv12_plain_at_a_pitch_equals_yuv420_plain():
    geo = tops.Geometry(70, 38)
    frame = torch.from_numpy(np.random.RandomState(0).randint(0, 256, geo.frame_bytes).astype(np.uint8))
    h, w = geo.luma
    y = frame[:h * w].reshape(h, w)
    u = frame[h * w:h * w * 5 // 4].reshape(h // 2, w // 2)
    v = frame[h * w * 5 // 4:].reshape(h // 2, w // 2)
    surface = torch.full((h * 3 // 2, 128), 77, dtype=torch.uint8)
    surface[:h, :w] = y
    surface[h:, 0:w:2] = u
    surface[h:, 1:w:2] = v
    want = tops.yuv420_to_rgb_plain(frame[None], geo)[0]
    assert torch.equal(tops.nv12_to_rgb_plain(surface[:h], surface[h:], 70, 38), want)
    out = torch.zeros((38, 70, 3), dtype=torch.uint8)
    assert tops.nv12_to_rgb(surface[:h], surface[h:], 70, 38, out=out) is out and torch.equal(out, want)


def test_colour_below_luma_16_is_not_clamped():
    """libswscale's x86 path takes 8Y - 128 without clamping it at 0: a luma
    sample under 16 darkens its pixel (the low-samples file holds the JAX
    readers to it bit for bit)."""
    geo = tops.Geometry(16, 16)
    frame = torch.full((geo.frame_bytes,), 128, dtype=torch.uint8)
    frame[:256] = 0
    frame[256 + 64:] = 255  # Cr
    assert tops.yuv420_to_rgb_plain(frame[None], geo)[0, 0, 0].tolist() == [183, 0, 0]


def test_sample_on_the_cpu_raises_naming_nvdec(streams):
    path, _ = streams["i_only"]
    with pytest.raises(UnsupportedVideo, match="NVDEC"):
        tmedia.VideoReader(use_cache=False).sample(path, [0, 1], device="cpu")
    with pytest.raises(UnsupportedVideo, match="NVDEC"):
        next(iter(tmedia.StreamingSampler(path, range(5), chunk_size=2, device="cpu")))


def test_missing_libnvcuvid_raises(monkeypatch):
    """No fallback: a machine without NVIDIA's NVDEC library makes the
    session raise, naming it."""
    def fake_load(name):
        if name == "nvdec_open":
            return lambda device, out: -2
        if name == "nvdec_message":
            def message(handle, buf, n):
                text = b"libnvcuvid.so.1: cannot open shared object file"
                ctypes.memmove(buf, text, len(text) + 1)
                return 0
            return message
        raise AssertionError(name)

    monkeypatch.setattr(tnv._kernels, "load", fake_load)
    monkeypatch.setenv("NVIDIA_DRIVER_CAPABILITIES", "compute,utility")
    with pytest.raises(RuntimeError, match="libnvcuvid") as raised:
        tnv.NvdecSession(torch.device("cuda", 0))
    assert raised.value.code == -2 and not tnv.out_of_reach(raised.value)


@pytest.mark.parametrize("code,caps,out", [
    (2, "compute,utility", True),
    (2, " compute , utility ", True),
    (2, "compute,video,utility", False),
    (2, "all", False),
    (2, None, False),
    (1, "compute,utility", False),
    (999, "compute,utility", False),
    (-1, "compute,utility", False),
    (-3, "compute,utility", False),
])
def test_only_cuda_result_2_without_the_video_capability_is_out_of_reach(monkeypatch, code, caps, out):
    """The one failure that callers may treat as the machine's (CUresult 2
    in a container that withholds NVIDIA's video capability); every other
    code, and the same code where the capability is given or no container
    names its capabilities, is a fault."""
    monkeypatch.setattr(tnv._kernels, "load", lambda name: lambda handle, buf, n: 0)
    if caps is None:
        monkeypatch.delenv("NVIDIA_DRIVER_CAPABILITIES", raising=False)
    else:
        monkeypatch.setenv("NVIDIA_DRIVER_CAPABILITIES", caps)
    with pytest.raises(tnv.NvdecError) as raised:
        tnv._check(code, None, "cuvidGetDecoderCaps")
    assert raised.value.code == code and tnv.out_of_reach(raised.value) is out
    assert ("video capability" in str(raised.value)) is out
    assert not tnv.out_of_reach(RuntimeError("NVDEC: CUresult 2"))


class _StandInSession:
    """NVDEC's behaviour on the writer's streams, on the CPU: pictures come
    out in display order once more than ``reorder`` wait, all at the end of
    the stream, as NV12 surfaces at a pitch wider than the picture."""

    def __init__(self, display_ids, planes, geo, reorder):
        self.order, self.planes, self.geo, self.reorder = list(display_ids), planes, geo, reorder
        self.fed, self.waiting, self.queue = 0, [], []

    def feed(self, au):
        if au is None:
            self.queue += sorted(self.waiting)
            self.waiting = []
            return
        assert h264.split_annexb(au)
        self.waiting.append(self.order[self.fed])
        self.fed += 1
        while len(self.waiting) > self.reorder:
            self.waiting.sort()
            self.queue.append(self.waiting.pop(0))

    def pending(self):
        return len(self.queue)

    def map(self, stream):
        i = self.queue[0]
        h, w = self.geo.luma
        f = torch.from_numpy(self.planes[i])
        surface = torch.zeros((h * 3 // 2, w + 64), dtype=torch.uint8)
        surface[:h, :w] = f[:h * w].reshape(h, w)
        surface[h:, 0:w:2] = f[h * w:h * w * 5 // 4].reshape(h // 2, w // 2)
        surface[h:, 1:w:2] = f[h * w * 5 // 4:].reshape(h // 2, w // 2)
        s = type("S", (), {})()
        s.luma, s.uv, s.width, s.height = surface[:h], surface[h:], self.geo.width, self.geo.height
        return s

    def unmap(self):
        self.queue.pop(0)

    def skip(self):
        self.queue.pop(0)

    def close(self):
        pass


@pytest.fixture
def stand_in(streams, monkeypatch):
    """``NvdecVideo`` on the CPU with a stand-in for the card's session."""
    path, expect = streams["ipbpb"]
    make, _, pattern, _ = STREAMS["ipbpb"]
    geo = tops.Geometry(320, 240)
    planes = h264_pcm.yuv_frames(make(), geo)
    order = h264_pcm.decode_order(pattern)
    monkeypatch.setattr(tnv.NvdecVideo, "device", property(lambda self: torch.device("cpu")))
    monkeypatch.setattr(tnv, "NvdecSession", lambda dev: _StandInSession(order, planes, geo, 1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("T", (), {"synchronize": lambda self: None})())
    return path, expect


def test_read_frames_in_one_pass_across_calls(stand_in):
    path, expect = stand_in
    with tnv.NvdecVideo(path) as v:
        a, ka = v.read_frames([5, 0, 1, 2, 2])
        b, kb = v.read_frames([1, 7, 8, 20])          # 1 is behind the session: dropped
        assert v.stats["frames"] == 21
        c, kc = v.read_frames([21, 99])               # past the end: the session ends
        d, kd = v.read_frames([22, 23])
    assert (ka, kb, kc, kd) == ([0, 1, 2, 5], [7, 8, 20], [21], [])
    for got, ids in ((a, ka), (b, kb), (c, kc)):
        np.testing.assert_array_equal(got, expect[ids])
    assert d.shape == (0, 240, 320, 3)


def test_read_frames_every_frame_in_display_order(stand_in):
    path, expect = stand_in
    with tnv.NvdecVideo(path) as v:
        got, kept = v.read_frames(range(len(expect)))
        assert v._ended and v._fed == len(expect)
    assert kept == list(range(len(expect)))
    np.testing.assert_array_equal(got, expect)


def test_codec_rotation_metadata_matches_jax_ingest(streams, tmp_path, monkeypatch):
    """IN on an H.264 file records what the JAX package's IN records: codec
    ``h264`` and the ``tkhd`` rotation, fps, size and duration."""
    path, _ = streams["high_rot90"]
    monkeypatch.chdir(tmp_path)
    assert tingest.probe_codec_rotation(path) == ("h264", 90)
    if jnd.available():
        assert jingest.probe_codec_rotation(path) == ("h264", 90)
    from fvd_tpu.state import State as JState
    from fvd_tpu_torch.state import State as TState

    ours = tingest.run(TState(input_path=path))["metadata"]
    theirs = jingest.run(JState(input_path=path))["metadata"]
    keys = ("duration", "fps", "size", "rotation", "codec") if jnd.available() else ("duration", "fps", "size")
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert ours["codec"] == "h264" and ours["rotation"] == 90
