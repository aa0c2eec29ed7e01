"""The port's DV25 codec, on the CPU, at tolerance 0 against the JAX
package's in-tree DV codec (``tcforge_tpu/io/dv.py``, ``io/dvdec.py``,
``io/dvenc.py``):

- the DIF walk and frame info, the probe of DV and PVN files;
- the host parse (``csrc/dv_host.cpp``) against the pinned Python parse
  and the plain ``dv_idct`` against ``DVDecoder.decode`` on every fixture
  frame (PAL 4:2:0 and NTSC 4:1:1), the per-block IDCTs against
  ``idct88``/``idct248`` (dc-only rows, int16 wrap), the placement;
- AAUX extraction and injection;
- per block: the mode against ``_pick_modes``, the float64 transform
  against numpy's ``F @ x``, the levels and classes against
  ``_quantize`` at every qno, the AC bits against ``_ac_cost``;
- the rate fit and the packer (C++ and plain) against the pinned
  Python, a segment that reaches the qno floor and drops coefficients,
  and the encoder's bytes: the fixtures (the JAX encoder's output) from
  their seeded frames, and one live PAL frame with a noise patch.

The fixtures are files (``tests/data/dv/make_streams.py``), pinned by
SHA-256 here.
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from tcforge_tpu.io import dv as jdv
from tcforge_tpu.io import dvdec as jdec
from tcforge_tpu.io import dvenc as jenc
from tcforge_tpu.io import pvn as jpvn
from tcforge_tpu.io.probe import probe_file as jax_probe
from tcforge_tpu.modules.encoders.bridge_video import DvVideoEncoder as JDv
from tcforge_tpu_torch.io import dv as tdv
from tcforge_tpu_torch.io import dvcodec
from tcforge_tpu_torch.io.probe import probe_file
from tcforge_tpu_torch.modules.encoders import capture_enc
from tcforge_tpu_torch.ops import kernels

DATA = Path(__file__).resolve().parent / "data" / "dv"
FIXTURES = {
    "pal.dv": "9f1a89a9645a2bcd6ee9bece1a123531c2e7ac75c5ec50927d40ce05ab21e984",
    "ntsc.dv": "5eb925dfca7dd38e74377397b0813611e3a529a5a6017c60fd1ea49a90879985"}
FRAME_BYTES = {"pal.dv": 144000, "ntsc.dv": 120000}
FRAMES = [(name, k) for name in sorted(FIXTURES) for k in range(2)]


def frame(name: str, k: int) -> bytes:
    data = (DATA / name).read_bytes()
    size = FRAME_BYTES[name]
    return data[k * size:(k + 1) * size]


def make_streams():
    spec = importlib.util.spec_from_file_location(
        "dv_make_streams", DATA / "make_streams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixtures_are_pinned(name):
    digest = hashlib.sha256((DATA / name).read_bytes()).hexdigest()
    assert digest == FIXTURES[name]


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()
               if p.is_file()) < 600_000


def test_basis_is_the_jax_encoders():
    b = dvcodec.basis()
    assert b.dtype == np.float64
    assert b[0].tobytes() == jenc._F88.tobytes()
    assert b[1].tobytes() == jenc._F248.tobytes()


# --------------------------------------------------------------------- #
# the DIF walk, frame info and the probe

SYNTH = [dict(is_pal=p, audio_rate=r, audio_12bit=b, wide=w)
         for p in (True, False) for r in (48000, 44100, 32000)
         for b in (False, True) for w in (False, True)]


@pytest.mark.parametrize("kw", SYNTH, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_frame_info_of_synthetic_frames(kw):
    data = jdv.synth_frame(**kw)
    assert tdv.synth_frame(**kw) == data
    assert tdv.parse_frame_info(data) == \
        tdv.DvFrameInfo(**vars(jdv.parse_frame_info(data)))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_frame_walk_and_info(name):
    with open(DATA / name, "rb") as f:
        ours = list(tdv.iter_frames(f))
    with open(DATA / name, "rb") as f:
        theirs = list(jdv.iter_frames(f))
    assert ours == theirs and len(ours) == 2
    assert vars(tdv.parse_frame_info(ours[0])) == \
        vars(jdv.parse_frame_info(ours[0]))
    for sct in range(5):
        assert tdv.extract_payload(ours[0], sct) == \
            jdv.extract_payload(ours[0], sct)


def _same_probe(path):
    ours, theirs = probe_file(str(path)), jax_probe(str(path))
    assert repr(ours).replace("tcforge_tpu_torch", "tcforge_tpu") == \
        repr(theirs)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_probe_of_a_dv_file_matches_the_jax_probe(name):
    _same_probe(DATA / name)


@pytest.mark.parametrize("kw", SYNTH[::3], ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_probe_of_synthetic_dv_matches_the_jax_probe(kw, tmp_path):
    path = tmp_path / "synth.dv"
    path.write_bytes(jdv.synth_frame(**kw) * 2)
    _same_probe(path)


@pytest.mark.parametrize("imagetype,fps,nframes", [(6, 15.0, 3), (5, 29.97, 3),
                                                  (6, 25.0, 0)])
def test_probe_of_a_pvn_file_matches_the_jax_probe(imagetype, fps, nframes,
                                                   tmp_path):
    rng = np.random.default_rng(imagetype)
    hdr = jpvn.PvnHeader(imagetype=imagetype, dtype="a", bits=8, width=16,
                         height=12, nframes=nframes, framerate=fps)
    shape = (12, 16, 3) if imagetype == 6 else (12, 16)
    buf = io.BytesIO()
    jpvn.write_header(buf, hdr)
    for _ in range(3):
        jpvn.write_frame(buf, hdr, rng.integers(0, 256, shape)
                         .astype(np.uint8))
    path = tmp_path / "clip.pvn"
    path.write_bytes(buf.getvalue())
    _same_probe(path)


# --------------------------------------------------------------------- #
# decode


@pytest.fixture(scope="module")
def jax_planes():
    dec = jdec.DVDecoder()
    return {key: dec.decode(frame(*key)) for key in FRAMES}


@pytest.fixture(scope="module")
def records():
    return {key: dvcodec.parse_frame_ref(frame(*key)) for key in FRAMES}


@pytest.mark.parametrize("key", FRAMES, ids=lambda k: f"{k[0]}-{k[1]}")
def test_host_parse_matches_the_pinned_parse(key, records):
    pal, coef, mode = records[key]
    assert pal == (key[0] == "pal.dv")
    nb = dvcodec.frame_blocks(pal)
    c2 = np.full((nb, 64), 0, np.int16)
    m2 = np.zeros(nb, np.uint8)
    dvcodec.parse_frames([frame(*key)], pal, c2, m2)
    assert np.array_equal(c2, coef) and np.array_equal(m2, mode)
    # both transforms occur in the fixtures
    assert 0 < int(mode.sum()) < nb


@pytest.mark.parametrize("key", FRAMES, ids=lambda k: f"{k[0]}-{k[1]}")
def test_plain_decode_matches_the_jax_decoder(key, records, jax_planes):
    pal, coef, mode = records[key]
    got = kernels.dv_idct(torch.from_numpy(coef), torch.from_numpy(mode),
                          pal)
    for g, w in zip(got, jax_planes[key]):
        assert np.array_equal(g[0].numpy(), w)


def test_a_batch_parses_frame_after_frame():
    frames = [frame(*k) for k in FRAMES if k[0] == "pal.dv"] * 3
    nb = dvcodec.PAL_BLOCKS
    coef = np.zeros((len(frames) * nb, 64), np.int16)
    mode = np.zeros(len(frames) * nb, np.uint8)
    dvcodec.parse_frames(frames, True, coef, mode)
    one = np.zeros((nb, 64), np.int16)
    dvcodec.parse_frames(frames[1:2], True, one, np.zeros(nb, np.uint8))
    assert np.array_equal(coef[nb:2 * nb], one)
    assert np.array_equal(coef[3 * nb:4 * nb], one)


@pytest.mark.parametrize("cut,message", [
    (119999, "dv: short frame"),
    (130000, "dv: incomplete video sequence")])
def test_the_parse_refuses_as_the_jax_decoder(cut, message):
    data = frame("pal.dv", 0)[:cut]
    with pytest.raises(ValueError, match=message):
        jdec.DVDecoder().decode(data)
    with pytest.raises(ValueError, match=message):
        dvcodec.parse_frames([data], True,
                             np.zeros((dvcodec.PAL_BLOCKS, 64), np.int16),
                             np.zeros(dvcodec.PAL_BLOCKS, np.uint8))


def test_the_parse_refuses_a_frame_of_the_other_system():
    with pytest.raises(ValueError, match="other system"):
        dvcodec.parse_frames([frame("ntsc.dv", 0)], True,
                             np.zeros((dvcodec.PAL_BLOCKS, 64), np.int16),
                             np.zeros(dvcodec.PAL_BLOCKS, np.uint8))


def _blocks(seed: int, n: int = 64) -> np.ndarray:
    """int (n, 8, 8) coefficient blocks: small and large values, rows
    with only a DC, blocks whose 2-4-8 butterfly wraps int16."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-300, 300, (n, 8, 8)) * (rng.random((n, 8, 8)) < 0.3)
    b[:, :, 0] = rng.integers(0, 2048, (n, 8))
    b[: n // 4, 2:5, 1:] = 0                       # dc-only rows
    b[n // 4: n // 2, 0::2] = rng.integers(20000, 32767, (n // 4, 4, 8))
    b[n // 4: n // 2, 1::2] = rng.integers(-32767, -20000, (n // 4, 4, 8))
    return b


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("mode", (0, 1))
def test_block_idct_matches_the_jax_idct(seed, mode):
    b = _blocks(seed)
    want = (jdec.idct248 if mode else jdec.idct88)(b.astype(np.int64))
    got = dvcodec.idct_blocks_ref(torch.from_numpy(b.astype(np.int16)
                                                   .reshape(-1, 64)),
                                  torch.full((len(b),), mode,
                                             dtype=torch.uint8))
    assert np.array_equal(got.numpy().reshape(-1, 8, 8), want)


@pytest.mark.parametrize("pal", (True, False))
def test_placement_covers_every_sample_once(pal):
    idx = dvcodec.pixel_index(pal).ravel()
    assert np.array_equal(np.sort(idx), np.arange(dvcodec.frame_samples(pal)))


# --------------------------------------------------------------------- #
# AAUX audio


def _pcm(seed: int, n: int = 1920, channels: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n, channels) if channels > 1 else (n,)
    return rng.integers(-32768, 32768, shape).astype(np.int16)


@pytest.mark.parametrize("k", range(2))
def test_extract_audio_matches_the_jax_function(k):
    data = frame("pal.dv", k)
    a, ra = jdec.extract_audio(data)
    b, rb = dvcodec.extract_audio(data)
    assert ra == rb and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed,n,channels", [
    (0, 1920, 2), (1, 1920, 1), (2, 100, 2), (3, 0, 2), (4, 2500, 2),
    (5, 1919, 1)])
def test_inject_audio_matches_the_jax_function(seed, n, channels):
    base = frame("pal.dv", seed % 2)
    pcm = _pcm(seed, n, channels)
    want = jenc.inject_audio(base, pcm)
    assert dvcodec.inject_audio(base, pcm) == want
    back, _ = dvcodec.extract_audio(want)
    assert np.array_equal(back, jdec.extract_audio(want)[0])


def _no_source_pack() -> bytes:
    """A PAL frame whose AS packs say there is no audio."""
    data = bytearray(jdv.synth_frame(is_pal=True))
    for off in range(0, 144000, 80):
        if data[off] >> 5 == 3 and data[off + 3] == 0x50:
            data[off + 4] = 0xFF
    return bytes(data)


@pytest.mark.parametrize("make,err", [
    (lambda: frame("ntsc.dv", 0) + bytes(24000), ValueError),
    (_no_source_pack, ValueError),
    (lambda: jenc.inject_audio(jdv.synth_frame(is_pal=True),
                               _pcm(0))[:100000], ValueError)])
def test_extract_audio_refuses_as_the_jax_function(make, err):
    data = make()
    with pytest.raises(err) as theirs:
        jdec.extract_audio(data)
    with pytest.raises(err) as ours:
        dvcodec.extract_audio(data)
    assert str(ours.value) == str(theirs.value)


def test_a_44k_source_pack_is_not_48k_audio():
    data = bytearray(jenc.inject_audio(jdv.synth_frame(is_pal=True),
                                       _pcm(0)))
    for off in range(0, 144000, 80):           # AS packs: 44.1 kHz
        if data[off] >> 5 == 3 and data[off + 3] == 0x50:
            data[off + 7] = (1 << 3)
    with pytest.raises(NotImplementedError) as theirs:
        jdec.extract_audio(bytes(data))
    with pytest.raises(NotImplementedError) as ours:
        dvcodec.extract_audio(bytes(data))
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------------- #
# encode: per-block analysis


def _pixel_blocks(seed: int, n: int = 60) -> np.ndarray:
    """uint8 (n, 8, 8): flat, smooth, interlaced, noisy and saturated
    blocks."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, 8, 8), np.int64)
    yy, xx = np.mgrid[0:8, 0:8]
    for i in range(n):
        kind = i % 5
        if kind == 0:
            out[i] = rng.integers(0, 256)
        elif kind == 1:
            out[i] = rng.integers(0, 128) + rng.integers(0, 16) * xx \
                + rng.integers(0, 16) * yy
        elif kind == 2:
            out[i] = np.where(yy % 2, rng.integers(0, 100),
                              rng.integers(150, 256)) + rng.integers(0, 9, (8, 8))
        elif kind == 3:
            out[i] = rng.integers(0, 256, (8, 8))
        else:
            out[i] = np.where((xx + yy) % 2, 0, 255)
    return np.clip(out, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def analysed():
    """Per seed: the blocks, the JAX modes, the port's modes and
    forward transform (DC zeroed as the encoder does)."""
    out = {}
    for seed in range(6):
        blocks = _pixel_blocks(seed)
        t = torch.from_numpy(blocks.reshape(-1, 64).astype(np.int64))
        mode = dvcodec.pick_modes_ref(t)
        X = dvcodec.forward_ref(t, mode)
        out[seed] = (blocks, jenc.DVEncoder._pick_modes(blocks), mode, X)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_modes_match_pick_modes(seed, analysed):
    blocks, want, mode, _ = analysed[seed]
    assert mode.tolist() == want
    assert 0 < sum(want) < len(want)


@pytest.mark.parametrize("seed", range(6))
def test_forward_transform_is_numpys_gemv(seed, analysed):
    blocks, modes, _, X = analysed[seed]
    for i, b in enumerate(blocks):
        F = jenc._F248 if modes[i] else jenc._F88
        want = F @ b.astype(np.float64).ravel()
        assert X[i].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("qno", range(16))
def test_levels_and_bits_match_quantize_and_ac_cost(qno, analysed):
    enc = jenc.DVEncoder()
    for seed in (0, 3):
        _, modes, mode, X = analysed[seed]
        X = X.clone()
        X[:, 0] = 0.0
        cls, lv = dvcodec.quantize_ref(X, mode, torch.full_like(mode, qno))
        bits = dvcodec.ac_cost_ref(lv)
        for i in range(len(modes)):
            c, want = enc._quantize(X[i].numpy(), modes[i], qno)
            assert (int(cls[i]), lv[i].tolist()) == (c, want)
            assert int(bits[i]) == jenc._ac_cost(want)


@pytest.mark.parametrize("seed", range(8))
def test_ac_cost_of_random_levels(seed):
    rng = np.random.default_rng(seed)
    lv = rng.integers(-255, 256, (50, 64)) * (rng.random((50, 64))
                                              < 0.05 + 0.1 * seed)
    got = dvcodec.ac_cost_ref(torch.from_numpy(lv))
    assert got.tolist() == [jenc._ac_cost(row.tolist()) for row in lv]


def test_the_cost_table_is_the_coders():
    t = dvcodec.cost_table()
    for run in (0, 1, 5, 14, 15, 40, 62):
        for a in (1, 2, 7, 22, 23, 100, 255):
            lv = [0] * 64
            lv[run + 1] = a
            assert int(t[run, a]) + 4 == jenc._ac_cost(lv)


# --------------------------------------------------------------------- #
# encode: the segment's rate fit, the drop at the qno floor, packing


def _jax_segment(blocks6x5, enc):
    mbs = []
    for m in range(5):
        b = blocks6x5[6 * m:6 * m + 6]
        mbs.append((b, enc._pick_modes(b)))
    return enc._segment_strings(mbs)


def _port_segment(blocks6x5):
    t = torch.from_numpy(blocks6x5.reshape(-1, 64).astype(np.int64))
    mode = dvcodec.pick_modes_ref(t)
    X = dvcodec.forward_ref(t, mode)
    dc = torch.round((X[:, 0] - 1024.0) / 4.0).clamp_(-256, 255)
    X[:, 0] = 0.0
    table = torch.empty((30, 16, 2), dtype=torch.int16)
    for q in range(16):
        cls, lv = dvcodec.quantize_ref(X, mode, torch.full_like(mode, q))
        table[:, q, 0] = cls.to(torch.int16)
        table[:, q, 1] = dvcodec.ac_cost_ref(lv).to(torch.int16)
    qno = dvcodec.rate_fit_ref(table.numpy())
    assert np.array_equal(qno, dvcodec.rate_fit(table.numpy()))
    cls, lv = dvcodec.quantize_ref(
        X, mode, torch.from_numpy(qno.astype(np.int64)).repeat_interleave(6))
    return (dvcodec._segment_strings_ref(lv.numpy(), cls.numpy(),
                                         dc.numpy(), mode.numpy(), qno),
            qno, lv)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("noise", (0, 1))
def test_segment_strings_match_the_jax_encoder(seed, noise):
    rng = np.random.default_rng(seed)
    if noise:
        blocks = rng.integers(0, 256, (30, 8, 8)).astype(np.uint8)
    else:
        blocks = _pixel_blocks(seed, 30)
    want = _jax_segment(blocks, jenc.DVEncoder())
    got, qno, lv = _port_segment(blocks)
    assert got == want
    assert jenc.DVEncoder._pack_segment(got) == \
        jenc.DVEncoder._pack_segment(want)
    if noise:
        # noise reaches the qno floor, and the drop happened: the kept
        # levels cost less than the table's at qno 0
        assert qno.max() == 0
        kept = sum(jenc._ac_cost([0] + [int(v) for v in row[1:]])
                   for row in lv.numpy())
        assert sum(bs[1] for _, strs in got for bs in strs) - 12 * 30 \
            < kept


@pytest.mark.parametrize("seed", range(4))
def test_the_rate_fit_of_random_tables(seed):
    rng = np.random.default_rng(seed)
    cost = np.sort(rng.integers(4, 400, (60, 30, 16)), axis=2)
    table = np.zeros((1800, 16, 2), np.int16)
    table[:, :, 1] = cost.reshape(-1, 16)
    table[:, :, 0] = rng.integers(0, 4, (1800, 16))
    assert np.array_equal(dvcodec.rate_fit(table),
                          dvcodec.rate_fit_ref(table))


@pytest.fixture(scope="module")
def fixture_sources():
    """The seeded frames and audio of the fixtures (make_streams.py)."""
    ms = make_streams()
    out = {}
    for k in range(2):
        out[("pal.dv", k)] = (ms.frame(576, 720, 288, 360, k, 100 + k),
                              ms.audio(k, 200 + k))
        out[("ntsc.dv", k)] = (ms.frame(480, 720, 480, 180, k, 300 + k),
                               None)
    return out


def _encode_plain(planes, pal):
    y, u, v = (torch.from_numpy(np.ascontiguousarray(p))[None]
               for p in planes)
    table, dc, mode = kernels.dv_fdct_cost(y, u, v)
    qno = dvcodec.rate_fit_ref(table.numpy())
    lv, cls = kernels.dv_fdct_cost(y, u, v, torch.from_numpy(qno))
    args = (lv.numpy(), cls.numpy(), dc.numpy(), mode.numpy(), qno, pal)
    return dvcodec.pack_frame_ref(*args), dvcodec.pack_frames(*args)[0]


@pytest.mark.parametrize("key", FRAMES, ids=lambda k: f"{k[0]}-{k[1]}")
def test_encoder_bytes_match_the_fixtures(key, fixture_sources):
    planes, pcm = fixture_sources[key]
    plain, host = _encode_plain(planes, key[0] == "pal.dv")
    assert host == plain
    if pcm is not None:
        host = dvcodec.inject_audio(host, pcm)
    assert host == frame(*key)


@pytest.fixture(scope="module")
def live_pal():
    """One live JAX encode: the first fixture frame with a 64x64 noise
    patch, whose segments reach the qno floor and drop coefficients."""
    ms = make_streams()
    y, u, v = ms.frame(576, 720, 288, 360, 0, 100)
    y = y.copy()
    y[:64, :64] = np.random.default_rng(9).integers(0, 256, (64, 64))
    return (y, u, v), jenc.DVEncoder().encode(y, u, v)


def test_a_frame_at_the_qno_floor_matches_the_jax_encoder(live_pal):
    planes, want = live_pal
    plain, host = _encode_plain(planes, True)
    assert plain == want and host == want


# --------------------------------------------------------------------- #
# the encoder module's chroma resite and refusal


@pytest.mark.parametrize("seed", range(4))
def test_chroma_420_to_411_matches_the_jax_module(seed):
    c = np.random.default_rng(seed).integers(0, 256, (3, 240, 360)) \
        .astype(np.uint8)
    got = capture_enc.chroma_420_to_411(torch.from_numpy(c))
    for i in range(3):
        assert np.array_equal(got[i].numpy(), JDv._chroma_420_to_411(c[i]))


@pytest.mark.parametrize("h,w", [(480, 640), (576, 704), (64, 48)])
def test_a_size_dv_cannot_carry_raises_the_jax_message(h, w):
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.core.job import Job
    y = torch.zeros((1, h, w), dtype=torch.uint8)
    c = torch.zeros((1, h // 2, w // 2), dtype=torch.uint8)
    fb = FrameBatch(format=ImageFormat.YUV420P, y=y, u=c, v=c.clone(),
                    attrs=torch.zeros(1, dtype=torch.int32),
                    frame_ids=torch.zeros(1, dtype=torch.int64))
    enc = capture_enc.DvVideoEncoder(Job(), "bitrate=9000")
    with pytest.raises(ValueError) as ours:
        enc.encode_video(fb)
    with pytest.raises(ValueError) as theirs:
        jenc.DVEncoder().encode(
            y[0].numpy(), *(2 * [JDv._chroma_420_to_411(c[0].numpy())]
                            if h == 480 else 2 * [c[0].numpy()]))
    assert str(ours.value) == str(theirs.value)
