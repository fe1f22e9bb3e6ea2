"""The port's MPEG-4 VOP parse interface (``fvd_tpu_torch/ops/mpeg4.py``
``parse_vops``, whose card kernel is ``csrc/mpeg4_parse.cu``) and the
known-answer writer (``fvd_tpu_torch/utils/mpeg4v_ka.py``): the plain version
equals the per-VOP host parser on the JAX package's clips and on the
known-answer streams, those streams parse to their answers, and both of the
JAX package's readers (its libav shim and OpenCV) read the writer's files to
the port's frames bit for bit."""

import numpy as np
import pytest
import torch

from fvd_tpu.providers import native_decode as jnd
from fvd_tpu.providers.media import VideoReader as JReader
from fvd_tpu.providers.media import write_video as jax_write_video
from fvd_tpu.synthetic import make_face_video as jax_make_face_video
from fvd_tpu_torch.ops import mpeg4 as tops
from fvd_tpu_torch.providers import native_decode as tnd
from fvd_tpu_torch.utils import mp4, mpeg4v
from fvd_tpu_torch.utils import mpeg4v_ka as ka
from fvd_tpu_torch.utils.avi import UnsupportedVideo

from test_torch_mpeg4_decode import texture_frames

#: the known-answer streams: (width, height, VOPs, seed)
KA_STREAMS = [(64, 48, 12, 0), (96, 64, 14, 1), (48, 32, 9, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp4v_parse")
    texture = str(d / "texture.mp4")
    jax_write_video(texture, texture_frames(n=14), 10.0)
    face = jax_make_face_video(str(d), "face", duration=2.0, fps=10.0)
    return {"texture": texture, "face": face}


@pytest.fixture(scope="module")
def ka_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp4v_ka")
    out = {}
    for w, h, n, seed in KA_STREAMS:
        path = str(d / f"ka_{w}x{h}.mp4")
        specs = ka.covering_stream(w, h, n, seed=seed)
        out[(w, h)] = (path, specs, ka.write_mp4(path, w, h, 10.0, specs))
    return out


def _range(path):
    """Every sample of ``path`` as ``parse_vops``' inputs, scanned as the
    session scans them, and the samples."""
    data = open(path, "rb").read()
    track = mp4.parse(path, data)
    samples = [data[o:o + s] for o, s in zip(track.offsets, track.sizes)]
    return (*mpeg4v.scan_samples(samples, mpeg4v.find_vol(track.config)), samples)


def _assert_range_equals(rng, vops, geo):
    assert rng.kinds == "".join(v.kind for v in vops)
    assert rng.rounding == [v.rounding for v in vops]
    for i, v in enumerate(vops):
        got = rng.vop(i, geo)
        for f in ("levels", "qscale", "intra", "mv", "coded"):
            np.testing.assert_array_equal(getattr(got, f), getattr(v, f), err_msg=f"VOP {i} {f}")


@pytest.mark.parametrize("name", ["texture", "face"])
def test_plain_parse_equals_the_per_vop_loop_on_jax_clips(jax_clips, name):
    data, offsets, ids, vols, samples = _range(jax_clips[name])
    dec = mpeg4v.Decoder(vols[0])
    loop = [dec.decode(s) for s in samples]
    rng = tops.parse_vops(data, offsets, ids, vols, "cpu")
    assert rng.packed.dtype == torch.int16 and rng.packed.shape[0] == len(samples)
    _assert_range_equals(rng, loop, tops.Geometry(vols[0].width, vols[0].height))


@pytest.mark.parametrize("size", [(w, h) for w, h, _, _ in KA_STREAMS])
def test_known_answer_streams_parse_to_their_answers(ka_files, size):
    path, specs, answers = ka_files[size]
    data, offsets, ids, vols, samples = _range(path)
    assert len(vols) == 2 and ids[-1] == 1  # the second I-VOP's sample repeats the VOL
    dec = mpeg4v.Decoder(vols[0])
    loop = [dec.decode(s) for s in samples]
    geo = tops.Geometry(*size)
    _assert_range_equals(tops.parse_vops(data, offsets, ids, vols, "cpu"), loop, geo)
    _assert_range_equals(tops.parse_vops(data, offsets, ids, vols, "cpu"), answers, geo)


def test_known_answer_streams_reach_every_path(ka_files):
    """The syntax the writer promises, counted from the specs and the
    parsed rows: f_code 1-3, wrapped differences, four vectors, intra in
    P-VOPs, dquant, AC prediction from both sides, intra DC as a TCOEF,
    stuffing, not-coded VOPs and all three escape types."""
    seen = set()
    escapes = set()
    orig = mpeg4v.Decoder._escape

    def counting(r, bits, table, lmax, rmax):
        p = r.pos
        first, second = (r.buf[p >> 3] >> (7 - (p & 7))) & 1, (r.buf[(p + 1) >> 3] >> (7 - ((p + 1) & 7))) & 1
        escapes.add(1 if not first else 2 if not second else 3)
        return orig(r, bits, table, lmax, rmax)

    mpeg4v.Decoder._escape = staticmethod(counting)
    try:
        for path, specs, _ in ka_files.values():
            data, offsets, ids, vols, samples = _range(path)
            dec = mpeg4v.Decoder(vols[0])
            for s in samples:
                dec.decode(s)
            for spec in specs:
                seen.add(("kind", spec.kind))
                if spec.kind == "P":
                    seen.add(("f_code", spec.f_code))
                    seen.add(("rounding", spec.rounding))
                for mb in spec.mbs:
                    seen.add(("mb", spec.kind, mb.kind))
                    if mb.dquant:
                        seen.add(("dquant", mb.kind))
                    if mb.stuffing:
                        seen.add(("stuffing", spec.kind))
                    if mb.kind == "intra" and mb.ac_pred:
                        seen.add(("ac_pred", spec.kind))
                if spec.kind == "I" and spec.dc_thr:
                    seen.add(("dc_as_tcoef",))
    finally:
        mpeg4v.Decoder._escape = staticmethod(orig)
    want = {("kind", "I"), ("kind", "P"), ("kind", "N"), ("f_code", 1), ("f_code", 2), ("f_code", 3),
            ("rounding", 0), ("rounding", 1), ("mb", "P", "skip"), ("mb", "P", "inter"), ("mb", "P", "inter4v"),
            ("mb", "P", "intra"), ("mb", "I", "intra"), ("dquant", "inter"), ("dquant", "intra"),
            ("stuffing", "I"), ("stuffing", "P"), ("ac_pred", "I"), ("ac_pred", "P"), ("dc_as_tcoef",)}
    assert want <= seen, want - seen
    assert escapes == {1, 2, 3}
    # a difference past the f_code range wraps, and AC prediction comes
    # from the left and from above
    wrapped, directions = 0, set()
    for (w, h), (_, specs, _) in ka_files.items():
        for spec in specs:
            if spec.kind == "N":
                continue
            reach = 32 << (spec.f_code - 1)
            st = ka._Intra((w + 15) // 16, (h + 15) // 16)
            q, qlist = spec.q, []
            for i, mb in enumerate(spec.mbs):
                wrapped += sum(int(abs(x) >= reach // 2 or abs(y) >= reach // 2) for x, y in mb.mv)
                if mb.kind != "skip" and mb.dquant:
                    q = min(31, max(1, q + mb.dquant))
                qlist.append(q)
                if mb.kind == "intra":
                    for n in range(6):
                        _, _, scan = st.residual(mb.levels[n], n, i % st.mb_w, i // st.mb_w, q, qlist,
                                                 mb.ac_pred, True)
                        if mb.ac_pred:
                            directions.add(scan is mpeg4v.ALT_VERTICAL)
    assert wrapped > 10
    assert directions == {True, False}


@pytest.mark.parametrize("size", [(w, h) for w, h, _, _ in KA_STREAMS])
def test_known_answer_files_read_bit_equal_through_both_jax_readers(ka_files, size):
    """The shim and OpenCV give the port's frames bit for bit; a not-coded
    VOP gives no frame in either, nor in the port."""
    path, specs, _ = ka_files[size]
    n_coded = sum(s.kind != "N" for s in specs)
    with tnd.NativeVideo(path, device="cpu") as v:
        ours, kept = v.read_frames(range(len(specs)))
        assert v.stats["ranges"] >= 1 and v.stats["vops"] == len(specs)
    assert kept == list(range(n_coded))
    with jnd.NativeVideo(path) as j:
        theirs, kept_j = j.read_frames(list(range(len(specs))))
    assert kept_j == kept
    np.testing.assert_array_equal(ours, theirs)
    cv, kept_c = JReader(use_cache=False)._sample_cv2(path, range(len(specs)))
    assert kept_c == kept
    np.testing.assert_array_equal(ours, cv)


def test_session_reads_in_ranges_across_calls(ka_files):
    """Two calls and a chunk of 5 VOPs: the frames equal one whole read, and
    the session parses each sample once."""
    path, specs, _ = ka_files[(96, 64)]
    with tnd.NativeVideo(path, device="cpu") as v:
        whole, _ = v.read_frames(range(len(specs)))
    with tnd.NativeVideo(path, device="cpu") as v:
        v._chunk = 5
        a, ka_ = v.read_frames([0, 2, 3])
        b, kb = v.read_frames([1, 4, 9, 10])   # 1 is behind the session: dropped
        assert v.stats["vops"] <= len(specs) and v.stats["ranges"] >= 3
    assert ka_ == [0, 2, 3] and kb == [4, 9, 10]
    np.testing.assert_array_equal(a, whole[[0, 2, 3]])
    np.testing.assert_array_equal(b, whole[[4, 9, 10]])


def _broken(vol, body):
    w = mpeg4v.BitWriter()
    w.start_code(mpeg4v.VOP_START)
    body(w)
    w.stuffing()
    return w.getvalue()


def _vop_header(w, vol, ctype=1, q=3, f_code=1):
    w.put(2, ctype); w.put(1, 0); w.put(1, 1); w.put(vol.time_bits, 0); w.put(1, 1); w.put(1, 1)
    if ctype == 1:
        w.put(1, 0)
    w.put(3, 0); w.put(5, q)
    if ctype == 1:
        w.put(3, f_code)


#: (status code, what to write after the start code, the message)
BROKEN = [
    (1, lambda w, vol: (w.put(2, 2), w.put(32, 0)), "B-VOPs"),
    (2, lambda w, vol: (w.put(2, 3), w.put(32, 0)), "S-VOPs"),
    (4, lambda w, vol: (w.put(2, 0), w.put(1, 0), w.put(1, 0), w.put(16, 0)), "marker bit after modulo_time_base"),
    (5, lambda w, vol: _vop_header(w, vol, ctype=0, q=0), "vop_quant 0"),
    (6, lambda w, vol: _vop_header(w, vol, f_code=0), "vop_fcode_forward 0"),
    (8, lambda w, vol: (_vop_header(w, vol, ctype=0), w.put(9, 0), w.put(8, 0)), "invalid variable-length code"),
    (10, lambda w, vol: (_vop_header(w, vol), w.put(1, 0), w.code(mpeg4v.MCBPC_P[3]),
                         w.code(mpeg4v.CBPY[15 ^ 8]), w.code(mpeg4v.MVD[0]), w.code(mpeg4v.MVD[0]),
                         [w.put(8, 0b11111110) for _ in range(40)]), "run past the block end"),
]


@pytest.mark.parametrize("code,body,message", BROKEN, ids=[m for _, _, m in BROKEN])
def test_status_codes_carry_the_host_parsers_messages(code, body, message):
    """Each fault the kernel reports by status code formats to the message
    the host parser raises for the same VOP (the card tests hold the kernel
    to the codes on these VOPs)."""
    vol = mpeg4v.find_vol(mpeg4v.write_headers(32, 32, 10))
    sample = _broken(vol, lambda w: body(w, vol))
    with pytest.raises(UnsupportedVideo, match=message) as plain:
        tops.parse_vops(sample, [(0, 4, len(sample))], [0], [vol], "cpu")
    pos = int(str(plain.value).rsplit(" ", 1)[-1]) if "at bit" in str(plain.value) else 0
    assert str(tops._parse_error(code, pos)) == str(plain.value)
