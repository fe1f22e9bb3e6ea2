"""AAC-LC audio in MP4 through the port (``fvd_tpu_torch/utils/aac.py`` on
the host, ``fvd_tpu_torch/ops/aac.py``'s plain versions on the CPU) against
the JAX package's libav shim (libavcodec's ``aac`` and libswresample), on
files of the known-answer writer (``fvd_tpu_torch/utils/aac_writer.py``):
``media.extract_audio``'s WAVs within 1 int16 step at 44.1 kHz and 4 where
resampled, the floats within 3e-5 (measured at most 1.3e-5, in the TNS
frames, which libavcodec filters in float32), ``has_audio`` as the shim
reports it, each unsupported feature refused by name, and swr's resampler
on float WAVs."""

import os
import struct
import wave

import numpy as np
import pytest
import torch

from fvd_tpu.providers import media as jmedia
from fvd_tpu.providers import native_decode as jnd
from fvd_tpu_torch.ops import aac as taac
from fvd_tpu_torch.providers import audio as taudio
from fvd_tpu_torch.providers import media as tmedia
from fvd_tpu_torch.providers import native_decode as tnd
from fvd_tpu_torch.utils import aac, aac_tables, mp4
from fvd_tpu_torch.utils import aac_writer as W
from fvd_tpu_torch.utils.avi import UnsupportedVideo

#: (channels, rate, frames, seed) of the known-answer files
CONFIGS = [(1, 44100, 24, 1), (2, 44100, 24, 2), (1, 48000, 20, 3), (2, 48000, 30, 4)]
WAV_LSB = {44100: 1, 48000: 4}
FLOAT_TOL = 3e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(path, channels, rate, frames, priming=1024, asc=None, video=3):
    index = aac_tables.SAMPLE_RATES.index(rate)
    units = [W.write_frame(f, index) for f in frames]
    tnd.write_mp4v(path, np.full((video, 16, 16, 3), 90, np.uint8), 10.0, device="cpu",
                   audio=(asc or W.audio_specific_config(rate, channels), rate, channels, units, priming))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("aac")
    return {cfg: _write(str(d / f"aac_{cfg[0]}_{cfg[1]}.mp4"), cfg[0], cfg[1],
                        W.covering_frames(cfg[0], cfg[1], n=cfg[2], seed=cfg[3])) for cfg in CONFIGS}


def _wav(path):
    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int64), w.getframerate()


@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"{c}ch_{r}" for c, r, _, _ in CONFIGS])
def test_extract_audio_matches_jax(files, cfg, tmp_path):
    path = files[cfg]
    ours = tmedia.extract_audio(path, str(tmp_path / "t.wav"), 44100, device="cpu")
    theirs = jmedia.extract_audio(path, str(tmp_path / "j.wav"), 44100)
    assert ours == str(tmp_path / "t.wav") and theirs == str(tmp_path / "j.wav")
    a, ra = _wav(ours)
    b, rb = _wav(theirs)
    assert ra == rb == 44100 and len(a) == len(b) > 0
    assert np.abs(a - b).max() <= WAV_LSB[cfg[1]]
    with tnd.NativeVideo(path, device="cpu") as v:
        fo, has = v.extract_audio(44100), v.probe()[5]
    with jnd.NativeVideo(path) as j:
        fj, has_j = j.extract_audio(44100), j.probe()[5]
    assert has == has_j is True
    assert fo.dtype == np.float32 and fo.shape == fj.shape
    assert np.abs(fo - fj).max() <= FLOAT_TOL
    assert np.abs(fj).max() > 0.1  # a real signal, not silence


def test_max_seconds_and_no_audio_track(files, tmp_path):
    path = files[(1, 44100, 24, 1)]
    with tnd.NativeVideo(path, device="cpu") as v:
        short = v.extract_audio(44100, max_seconds=0.1)
    with jnd.NativeVideo(path) as j:
        short_j = j.extract_audio(44100, max_seconds=0.1)
    assert len(short) == len(short_j) == 4410
    silent = str(tmp_path / "silent.mp4")
    tnd.write_mp4v(silent, np.zeros((3, 16, 16, 3), np.uint8), 10.0, device="cpu")
    with tnd.NativeVideo(silent, device="cpu") as v:
        assert v.probe()[5] is False and v.extract_audio(44100) is None
    with jnd.NativeVideo(silent) as j:
        assert j.probe()[5] is False


@pytest.mark.parametrize("cfg", [CONFIGS[1], CONFIGS[3]], ids=["2ch_44100", "2ch_48000"])
def test_max_seconds_parses_only_the_units_it_needs(files, cfg, monkeypatch):
    """A cap parses a prefix of the access units, and gives the whole
    track's first samples exactly, resampled or not; the shim's capped
    decode agrees."""
    path = files[cfg]
    data = open(path, "rb").read()
    full = taudio.extract(path, data, 44100, device="cpu")
    parsed = []
    decode = aac.decode
    monkeypatch.setattr(aac, "decode", lambda c, units: parsed.append(len(units)) or decode(c, units))
    short = taudio.extract(path, data, 44100, max_seconds=0.25, device="cpu")
    assert len(short) == 11025 and parsed[0] < cfg[2]
    np.testing.assert_array_equal(short, full[:len(short)])
    with jnd.NativeVideo(path) as j:
        theirs = j.extract_audio(44100, max_seconds=0.25)
    assert theirs.shape == short.shape and np.abs(short - theirs).max() <= FLOAT_TOL


def test_audio_reads_whatever_the_video_codec(files, tmp_path):
    """The audio track alone is read: an MP4 whose video codec the port
    refuses still gives its AAC sound, and a file that is no MP4 gives
    none (then the sibling wav)."""
    path = files[CONFIGS[0]]
    other = str(tmp_path / "h263.mp4")
    with open(other, "wb") as f:
        f.write(open(path, "rb").read().replace(b"mp4v", b"s263"))
    with pytest.raises(UnsupportedVideo, match="s263"):
        tnd.open_video(other, device="cpu")
    a = tmedia.extract_audio(path, str(tmp_path / "a.wav"), 44100, device="cpu")
    b = tmedia.extract_audio(other, str(tmp_path / "b.wav"), 44100, device="cpu")
    np.testing.assert_array_equal(_wav(a)[0], _wav(b)[0])
    raw = str(tmp_path / "raw.avi")
    tmedia.write_video(raw, np.zeros((2, 16, 16, 3), np.uint8), 10.0)
    assert taudio.extract_file(raw, 44100, device="cpu") is None
    assert tmedia.extract_audio(raw, str(tmp_path / "c.wav"), 44100, device="cpu") is None


def test_covering_frames_reach_every_path():
    """Both shapes, the four sequences, grouped short windows, all eleven
    codebooks and escapes, noise, pulses, TNS, DSE and FIL, M/S by mask and
    for all, intensity of both signs, a pair without a common window."""
    seen = set()
    for channels, rate, n, seed in CONFIGS:
        index = aac_tables.SAMPLE_RATES.index(rate)
        for f in W.covering_frames(channels, rate, n=n, seed=seed):
            seen |= {("seq", f.sequence), ("shape", f.shape)}
            if f.fill:
                seen.add("fill")
            if f.data:
                seen.add("dse")
            if channels == 2:
                seen.add(("common", f.common_window))
                if f.common_window:
                    seen.add(("ms", f.ms))
            if f.sequence == aac.EIGHT_SHORT and len(f.groups) < 8:
                seen.add("grouped")
            short, swb, groups = W._band_layout(f, index)
            for ch in f.channels:
                books = W._choose_books(ch, f, swb, groups)
                seen |= {("book", b) for b in books}
                if (np.abs(ch.q) >= 16).any():
                    seen.add("escape")
                if ch.pulses:
                    seen.add("pulse")
                if ch.tns:
                    seen.add(("tns", short))
    want = {("seq", s) for s in range(4)} | {("shape", 0), ("shape", 1), "fill", "dse", ("common", True),
                                            ("common", False), ("ms", 0), ("ms", 1), ("ms", 2), "grouped", "escape",
                                            "pulse", ("tns", True), ("tns", False)}
    want |= {("book", b) for b in range(1, 12)} | {("book", 13), ("book", 14), ("book", 15)}
    assert want <= seen, want - seen


def test_plain_encoder_round_trip_and_jax_parity(tmp_path):
    """The plain encoder's speech-like tone decodes to itself (at over 55
    dB) in both packages, 1024 samples of priming in its edit list."""
    sr = 44100
    t = np.arange(int(sr * 1.5)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    asc, units = W.encode_signal(x, sr)
    path = str(tmp_path / "tone.mp4")
    tnd.write_mp4v(path, np.zeros((3, 16, 16, 3), np.uint8), 10.0, device="cpu", audio=(asc, sr, 1, units, 1024))
    with tnd.NativeVideo(path, device="cpu") as v:
        ours = v.extract_audio(sr)
    with jnd.NativeVideo(path) as j:
        theirs = j.extract_audio(sr)
    assert ours.shape == theirs.shape and len(ours) >= len(x)
    assert np.abs(ours - theirs).max() <= FLOAT_TOL
    err = ours[:len(x)] - x
    assert 10 * np.log10((x ** 2).mean() / (err ** 2).mean()) > 55


def _asc(aot, rate_index=4, channels=1, frame960=0, tail=b""):
    from fvd_tpu_torch.utils.mpeg4v import BitWriter

    w = BitWriter()
    if aot >= 31:
        w.put(5, 31); w.put(6, aot - 32)
    else:
        w.put(5, aot)
    w.put(4, rate_index); w.put(4, channels)
    w.put(1, frame960); w.put(1, 0); w.put(1, 0)
    w.align_zero()
    return w.getvalue() + tail


def _lc_frames(channels=1, n=4):
    return W.covering_frames(channels, 44100, n=n, seed=5)


def _with_element(frames, kind):
    """Access units whose first element is a bare element of ``kind``
    (LFE, CCE, PCE) or a fill element carrying SBR data."""
    index = aac_tables.SAMPLE_RATES.index(44100)
    if kind == "sbr_fill":  # FIL with a count of 2: EXT_SBR_DATA, a nibble, a byte
        prefix = [(3, 6), (4, 2), (4, 13), (4, 0), (8, 0)]
    else:
        prefix = [(3, {"lfe": 3, "cce": 2, "pce": 5}[kind]), (4, 0)]
    nbits, bits = 0, 0
    for n, v in prefix:
        nbits, bits = nbits + n, (bits << n) | v
    out = []
    for f in frames:
        body = W.write_frame(f, index)
        total = nbits + 8 * len(body)
        value = (bits << (8 * len(body))) | int.from_bytes(body, "big")
        size = (total + 7) // 8
        out.append((value << (8 * size - total)).to_bytes(size, "big"))
    return out


REFUSALS = [
    ("he-aac", dict(asc=_asc(5)), "SBR"),
    ("he-aac-v2", dict(asc=_asc(29)), "PS"),
    ("main", dict(asc=_asc(1)), "AAC Main"),
    ("ltp", dict(asc=_asc(4)), "AAC LTP"),
    ("960", dict(asc=_asc(2, frame960=1)), "960-sample"),
    ("6ch", dict(asc=_asc(2, channels=6)), "channel configuration 6"),
    ("pce", dict(asc=_asc(2, channels=0)), "program config"),
    ("implicit-sbr", dict(units="sbr_fill"), "SBR"),
    ("lfe", dict(units="lfe"), "LFE"),
    ("cce", dict(units="cce"), "coupling"),
    ("pce-element", dict(units="pce"), "program config"),
]


@pytest.mark.parametrize("name,how,message", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_unsupported_features_raise_naming_them_and_fall_back_to_the_wav(tmp_path, name, how, message):
    frames = _lc_frames()
    path = str(tmp_path / "clip.mp4")
    units = _with_element(frames, how["units"]) if "units" in how else \
        [W.write_frame(f, aac_tables.SAMPLE_RATES.index(44100)) for f in frames]
    asc = how.get("asc", W.audio_specific_config(44100, 1))
    tnd.write_mp4v(path, np.zeros((3, 16, 16, 3), np.uint8), 10.0, device="cpu", audio=(asc, 44100, 1, units, 1024))
    data = open(path, "rb").read()
    with pytest.raises(UnsupportedVideo, match=message):
        taudio.extract(path, data, 44100, device="cpu")
    # the sibling wav is what extract_audio then takes
    sib = np.round(np.sin(np.arange(4410) / 9.0) * 9000).astype("<i2")
    with wave.open(str(tmp_path / "clip.wav"), "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(44100); w.writeframes(sib.tobytes())
    got = tmedia.extract_audio(path, str(tmp_path / "out.wav"), 44100, device="cpu")
    assert got == str(tmp_path / "out.wav")
    np.testing.assert_array_equal(_wav(got)[0], sib)


def test_a_kernel_error_propagates(files, tmp_path, monkeypatch):
    """A RuntimeError from a kernel wrapper is no unsupported feature: it
    propagates, and the sibling wav is not taken."""
    path = files[(1, 44100, 24, 1)]
    with wave.open(os.path.splitext(path)[0] + ".wav", "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(44100); w.writeframes(bytes(200))

    def broken(*a, **k):
        raise RuntimeError("aac_synth kernel launch failed: cudaError 700")

    monkeypatch.setattr(taac, "imdct_synth", broken)
    try:
        with pytest.raises(RuntimeError, match="aac_synth"):
            tmedia.extract_audio(path, str(tmp_path / "out.wav"), 44100, device="cpu")
    finally:
        os.remove(os.path.splitext(path)[0] + ".wav")


def test_explicit_rate_and_edit_list_priming(tmp_path):
    """An AudioSpecificConfig with the rate coded in 24 bits reads as the
    indexed one, and an edit list's 2112 samples of priming are dropped as
    libavformat drops them."""
    frames = W.covering_frames(1, 44100, n=8, seed=6)
    a = _write(str(tmp_path / "a.mp4"), 1, 44100, frames, priming=2112,
               asc=W.audio_specific_config(44100, 1, explicit_rate=True))
    cfg = aac.parse_asc(mp4.audio_track(a, open(a, "rb").read()).config)
    assert (cfg.sample_rate, cfg.sampling_index) == (44100, 4)
    with tnd.NativeVideo(a, device="cpu") as v:
        ours = v.extract_audio(44100)
    assert len(ours) == 8 * 1024 - 2112
    with jnd.NativeVideo(a) as j:
        if j.probe()[5]:
            theirs = j.extract_audio(44100)
            assert theirs.shape == ours.shape and np.abs(ours - theirs).max() <= FLOAT_TOL


def _f32_wav(path, x, sr):
    data = np.asarray(x, np.float32).T.reshape(-1).tobytes()
    ch = x.shape[0]
    fmt = struct.pack("<HHIIHH", 3, ch, sr, sr * 4 * ch, 4 * ch, 32)
    riff = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


@pytest.mark.parametrize("channels,rate,n", [(1, 48000, 7168), (2, 48000, 10240), (1, 22050, 5000),
                                             (2, 44100, 3000), (1, 32000, 9000), (2, 24000, 4096),
                                             (1, 8000, 3072)])
def test_resampler_matches_swr(tmp_path, channels, rate, n):
    """``resample_plain`` against libswresample through the shim on float
    WAVs (swr filters in float32 there too): the same length, within 2
    float32 steps."""
    rng = np.random.RandomState(rate + channels)
    t = np.arange(n) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t + c) + 0.05 * rng.randn(n) for c in range(channels)])
    x = x.astype(np.float32)
    path = str(tmp_path / "x.wav")
    _f32_wav(path, x, rate)
    with jnd.NativeVideo(path) as j:
        ref = j.extract_audio(44100)
    ours = taac.resample(torch.from_numpy(x), rate, 44100).numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 2.4e-7
