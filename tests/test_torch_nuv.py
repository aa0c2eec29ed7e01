"""The port's RTjpeg codec and NuppelVideo modules, on the CPU, at
tolerance 0 against the JAX package (``tcforge_tpu/io/rtjpeg.py``,
``io/nuv.py``, ``modules/importers/nuv_import.py``):

- the tables of every quality, the forward transform and quantizer
  (``rtjpeg_fdct_quant``'s plain version) and the inverse transform
  (``rtjpeg_idct``'s) at qualities 16, 128 and 255 and on coefficients
  that wrap int16, against ``fdct_blocks``/``quant_blocks`` and
  ``idct_blocks``;
- the host byte coder (``csrc/rtjpeg_host.cpp``) against the pinned
  ``b2s``/``s2b`` and the JAX compressor's bytes, a payload cut short;
- the NUV container, and the importer against the JAX importer over
  every frame type (raw ``'0'``, RTjpeg ``'1'``, black ``'N'``, repeat
  ``'L'``, a new ``'D'`` table mid-stream, ``'A'`` audio, seek, sync and
  text frames, an unknown type) at several batch sizes, the ``'2'``/
  ``'3'`` refusal and an RTjpeg frame before its tables;
- the ``nuvrtj`` encoder and the ``nuv`` multiplexor against the JAX
  modules.

The NUV files are written here, at 176x144 and smaller.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import pytest
import torch

from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io import nuv as jnuv
from tcforge_tpu.io import rtjpeg as jrtj
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import nuv as tnuv
from tcforge_tpu_torch.io import rtjcodec
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels

CPU = torch.device("cpu")
QUALITIES = (16, 128, 255)
SIZES = ((16, 16), (48, 32), (176, 144))


def planes(w: int, h: int, seed: int, n: int = 1):
    """Seeded 4:2:0 frames: gradients, an edge and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for k in range(n):
        y = 40 + 0.5 * xx + 0.3 * yy + 60 * (xx > w // 2 + k) \
            + rng.normal(0, 8 + 10 * (seed % 3), (h, w))
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        us.append(rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8))
        vs.append(rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
    return np.stack(ys), np.stack(us), np.stack(vs)


# --------------------------------------------------------------------- #
# tables and transforms


@pytest.mark.parametrize("q", list(range(16, 256, 8)) + [255])
def test_tables_of_every_quality(q):
    c = jrtj.RTjpegCompressor(16, 16, q)
    lqcq, lb8, cb8, tables = rtjcodec.compress_tables(q)
    assert tables == c.tables()
    assert np.array_equal(lqcq, np.stack([c.lqt, c.cqt]))
    assert (lb8, cb8) == (c.lb8, c.cb8)
    d = jrtj.RTjpegDecompressor(tables, 16, 16)
    qt, dl, dc = rtjcodec.decompress_tables(tables)
    assert np.array_equal(qt, np.stack([d.liqt, d.ciqt]))
    assert (dl, dc) == (d.lb8, d.cb8)


def test_a_short_table_packet_raises_as_the_jax_decompressor():
    with pytest.raises(ValueError, match="short RTjpeg table packet"):
        jrtj.RTjpegDecompressor(b"\0" * 100, 16, 16)
    with pytest.raises(ValueError, match="short RTjpeg table packet"):
        rtjcodec.decompress_tables(b"\0" * 100)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("w,h", SIZES)
def test_forward_transform_and_quantizer_match_the_jax_codec(q, w, h):
    y, u, v = planes(w, h, q + w, 2)
    c = jrtj.RTjpegCompressor(w, h, q)
    qt = torch.from_numpy(rtjcodec.compress_tables(q)[0])
    got = kernels.rtjpeg_fdct_quant(torch.from_numpy(y), torch.from_numpy(u),
                                    torch.from_numpy(v), qt)
    nb = rtjcodec.frame_blocks(w, h)
    for k in range(2):
        blocks = np.stack(list(jrtj._mb_blocks(y[k], u[k], v[k])))
        coefs = jrtj.fdct_blocks(blocks)
        luma = np.tile([True] * 4 + [False] * 2, nb // 6)
        want = np.empty((nb, 64), np.int16)
        want[luma] = jrtj.quant_blocks(coefs[luma], c.lqt)
        want[~luma] = jrtj.quant_blocks(coefs[~luma], c.cqt)
        assert np.array_equal(got[k * nb:(k + 1) * nb].numpy(), want)


@pytest.mark.parametrize("seed", range(10))
def test_inverse_transform_matches_idct_blocks(seed):
    rng = np.random.default_rng(seed)
    scale = (10, 1000, 50000, 4_000_000)[seed % 4]
    data = rng.integers(-scale, scale, (36, 64)) \
        * (rng.random((36, 64)) < 0.4)
    data[:, 0] = rng.integers(0, min(scale, 255 * 16000), 36)
    want = jrtj.idct_blocks(data)
    got = rtjcodec.idct_blocks_ref(torch.from_numpy(data.astype(np.int32)))
    assert np.array_equal(got.numpy().reshape(-1, 8, 8), want)


# --------------------------------------------------------------------- #
# the byte coder


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("w,h", SIZES)
def test_compressor_bytes_match_the_jax_compressor(q, w, h):
    y, u, v = planes(w, h, 7 * q + h, 2)
    c = jrtj.RTjpegCompressor(w, h, q)
    lqcq, lb8, cb8, _ = rtjcodec.compress_tables(q)
    blocks = kernels.rtjpeg_fdct_quant(
        torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
        torch.from_numpy(lqcq)).numpy()
    nb = rtjcodec.frame_blocks(w, h)
    host = rtjcodec.compress_frames(blocks, nb, lb8, cb8)
    for k in range(2):
        want = c.compress(y[k], u[k], v[k])
        assert rtjcodec.b2s_frame_ref(blocks[k * nb:(k + 1) * nb], lb8,
                                      cb8) == want
        assert host[k] == want


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("w,h", SIZES)
def test_decompressor_matches_the_jax_decompressor(q, w, h):
    y, u, v = planes(w, h, 3 * q + w, 2)
    c = jrtj.RTjpegCompressor(w, h, q)
    streams = [c.compress(y[k], u[k], v[k]) for k in range(2)]
    d = jrtj.RTjpegDecompressor(c.tables(), w, h)
    qt, lb8, cb8 = rtjcodec.decompress_tables(c.tables())
    nb = rtjcodec.frame_blocks(w, h)
    coef = np.empty((2 * nb, 64), np.int32)
    rtjcodec.decompress_frames(streams, nb, qt, lb8, cb8, coef)
    got = kernels.rtjpeg_idct(torch.from_numpy(coef), w, h)
    for k in range(2):
        assert np.array_equal(coef[k * nb:(k + 1) * nb],
                              rtjcodec.s2b_frame_ref(streams[k], nb, qt,
                                                     lb8, cb8))
        for g, want in zip(got, d.decompress(streams[k])):
            assert np.array_equal(g[k].numpy(), want)


@pytest.mark.parametrize("cut", (1, 7, 100))
def test_a_stream_cut_short_raises(cut):
    w, h = 48, 32
    y, u, v = planes(w, h, 5)
    c = jrtj.RTjpegCompressor(w, h, 255)
    data = c.compress(y[0], u[0], v[0])[:-cut]
    with pytest.raises(IndexError):
        jrtj.RTjpegDecompressor(c.tables(), w, h).decompress(data)
    qt, lb8, cb8 = rtjcodec.decompress_tables(c.tables())
    nb = rtjcodec.frame_blocks(w, h)
    with pytest.raises(IndexError):
        rtjcodec.decompress_frames([data], nb, qt, lb8, cb8,
                                   np.empty((nb, 64), np.int32))


def test_geometry_must_be_a_multiple_of_16():
    with pytest.raises(ValueError, match="multiple-of-16"):
        jrtj.RTjpegCompressor(40, 32, 255)
    with pytest.raises(ValueError, match="multiple-of-16"):
        rtjcodec.check_geometry(40, 32)


# --------------------------------------------------------------------- #
# the container and the importer


def test_file_header_round_trip():
    hdr = jnuv.NuvHeader(width=176, height=144, fps=29.97, keyframedist=30,
                         videoblocks=12, audioblocks=-1)
    a, b = io.BytesIO(), io.BytesIO()
    jnuv.write_file_header(a, hdr)
    tnuv.write_file_header(b, tnuv.NuvHeader(**vars(hdr)))
    assert a.getvalue() == b.getvalue()
    b.seek(0)
    assert vars(tnuv.read_file_header(b)) == vars(hdr)


def write_nuv(path, w: int, h: int, kinds: str, seed: int = 0,
              quality: int = 255) -> None:
    """A NUV file of frames by kind: ``1`` RTjpeg, ``0`` raw, ``N``
    black, ``L`` repeat, ``D`` new tables (a second quality), ``A`` PCM,
    ``R`` a seek point, ``S``/``T`` sync and text frames, ``?`` an
    unknown video type, ``2`` an LZO frame."""
    c = jrtj.RTjpegCompressor(w, h, quality)
    c2 = jrtj.RTjpegCompressor(w, h, 64)
    y, u, v = planes(w, h, seed, len(kinds))
    rng = np.random.default_rng(seed + 1)
    with open(path, "wb") as f:
        jnuv.write_file_header(f, jnuv.NuvHeader(width=w, height=h,
                                                 fps=29.97))
        jnuv.write_frame(f, "D", "R", c.tables())
        enc = c
        for k, kind in enumerate(kinds):
            if kind == "1":
                jnuv.write_frame(f, "V", "1", enc.compress(y[k], u[k], v[k]))
            elif kind == "0":
                jnuv.write_frame(f, "V", "0", y[k].tobytes() + u[k].tobytes()
                                 + v[k].tobytes())
            elif kind in "NL2?":
                jnuv.write_frame(f, "V", kind.replace("?", "X"), b"")
            elif kind == "D":
                enc = c2
                jnuv.write_frame(f, "D", "R", c2.tables())
            elif kind == "A":
                jnuv.write_frame(f, "A", "0", rng.integers(
                    -30000, 30000, 2 * 735).astype("<i2").tobytes())
            elif kind == "R":
                f.write(b"RTjjjjjjjjjj")
            else:
                jnuv.write_frame(f, kind, "0", b"xyz")


STREAMS = {
    "rtjpeg": "1A1A1A1A1A1",
    "mixed": "L1N0LA11D1A1L0",
    "tables": "11D11D1",
    "marks": "1RS1T1?1A",
    "raw_only": "0A0A0",
}


def read_all(imp, n: int):
    video, audio = [], []
    while True:
        got = imp.read_video_batch(n)
        if got is None:
            break
        video.append({k: np.asarray(got[k]) for k in "yuv"})
        pcm = imp.read_audio_batch(735 * n)
        if pcm is not None:
            audio.append(np.asarray(pcm))
    return video, audio


@pytest.mark.parametrize("n", (1, 3, 4))
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_importer_matches_the_jax_importer(name, n, tmp_path):
    path = tmp_path / f"{name}.nuv"
    write_nuv(path, 48, 32, STREAMS[name], seed=len(name))
    j = jax_new_module(JKind.DEMULTIPLEXOR, "nuv", JJob())
    j.open(str(path))
    t = new_module(ModuleKind.DEMULTIPLEXOR, "nuv", Job())
    t.open(str(path))
    t.start(CPU)
    for attr in ("width", "height", "fps", "audio_rate", "audio_channels",
                 "total_frames"):
        assert getattr(t, attr) == getattr(j, attr)
    jv, ja = read_all(j, n)
    tv, ta = read_all(t, n)
    j.close()
    t.close()
    assert len(tv) == len(jv) > 0
    for a, b in zip(tv, jv):
        for k in "yuv":
            assert np.array_equal(a[k], b[k])
    assert len(ta) == len(ja)
    for a, b in zip(ta, ja):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ("2", "3"))
def test_lzo_frames_are_refused_as_the_jax_importer_refuses(kind, tmp_path):
    path = tmp_path / "lzo.nuv"
    write_nuv(path, 32, 32, "1" + "2")
    data = bytearray(path.read_bytes())
    at = data.rindex(b"V2")
    data[at + 1] = ord(kind)
    path.write_bytes(bytes(data))
    errs = []
    for imp in (jax_new_module(JKind.DEMULTIPLEXOR, "nuv", JJob()),
                new_module(ModuleKind.DEMULTIPLEXOR, "nuv", Job())):
        imp.open(str(path))
        if hasattr(imp, "start"):
            imp.start(CPU)
        with pytest.raises(NotImplementedError) as e:
            read_all(imp, 4)
        errs.append(str(e.value))
        imp.close()
    assert errs[0] == errs[1]


def test_rtjpeg_before_its_tables_is_refused(tmp_path):
    path = tmp_path / "notables.nuv"
    c = jrtj.RTjpegCompressor(32, 32, 255)
    y, u, v = planes(32, 32, 1)
    with open(path, "wb") as f:
        jnuv.write_file_header(f, jnuv.NuvHeader(width=32, height=32))
        jnuv.write_frame(f, "V", "1", c.compress(y[0], u[0], v[0]))
    errs = []
    for imp in (jax_new_module(JKind.DEMULTIPLEXOR, "nuv", JJob()),
                new_module(ModuleKind.DEMULTIPLEXOR, "nuv", Job())):
        imp.open(str(path))
        if hasattr(imp, "start"):
            imp.start(CPU)
        with pytest.raises(ValueError) as e:
            imp.read_video_batch(2)
        errs.append(str(e.value))
        imp.close()
    assert errs[0] == errs[1]


def test_one_idct_launch_a_batch_of_rtjpeg_frames(tmp_path, monkeypatch):
    path = tmp_path / "r.nuv"
    write_nuv(path, 48, 32, "1111111")
    calls = []
    real = kernels.rtjpeg_idct
    monkeypatch.setattr(kernels, "rtjpeg_idct",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    t = new_module(ModuleKind.DEMULTIPLEXOR, "nuv", Job())
    t.open(str(path))
    t.start(CPU)
    read_all(t, 4)
    t.close()
    assert calls == [4 * 36, 3 * 36]


# --------------------------------------------------------------------- #
# the nuvrtj encoder and the nuv multiplexor


def _batch(y, u, v) -> FrameBatch:
    n = y.shape[0]
    return FrameBatch(format=ImageFormat.YUV420P, y=torch.from_numpy(y),
                      u=torch.from_numpy(u), v=torch.from_numpy(v),
                      attrs=torch.zeros(n, dtype=torch.int32),
                      frame_ids=torch.arange(n))


@pytest.mark.parametrize("q", QUALITIES)
def test_encoder_matches_the_jax_module(q):
    from tcforge_tpu.core.frame import FrameBatch as JBatch
    from tcforge_tpu.core.formats import ImageFormat as JFormat
    y, u, v = planes(48, 32, q, 3)
    jj, tj = JJob(), Job()
    jenc = jax_new_module(JKind.ENCODER, "nuvrtj", jj, f"quality={q}")
    tenc = new_module(ModuleKind.ENCODER, "nuvrtj", tj, f"quality={q}")
    want = jenc.encode_video(JBatch(format=JFormat.YUV420P, y=y, u=u, v=v))
    got = tenc.encode_video(_batch(y, u, v))
    assert got == want
    assert tj.extradata["rtjpeg_tables"] == jj.extradata["rtjpeg_tables"]
    assert tenc.tables() == jenc.tables()


def test_the_encoder_refuses_what_the_jax_module_refuses():
    y, u, v = planes(48, 32, 1)
    fb = dataclasses.replace(_batch(y, u, v), format=ImageFormat.YUV444P)
    with pytest.raises(ValueError, match="nuvrtj needs YUV420P input"):
        new_module(ModuleKind.ENCODER, "nuvrtj", Job()).encode_video(fb)
    y, u, v = planes(40, 32, 1)
    with pytest.raises(ValueError, match="multiple-of-16"):
        new_module(ModuleKind.ENCODER, "nuvrtj", Job()).encode_video(
            _batch(y, u, v))


@pytest.mark.parametrize("tables", (True, False))
def test_multiplexor_matches_the_jax_module(tables, tmp_path):
    outs = []
    for side, job, mod in (("jax", JJob(), jax_new_module),
                           ("port", Job(), new_module)):
        kind = JKind.MULTIPLEXOR if side == "jax" else ModuleKind.MULTIPLEXOR
        job.im_v_width, job.im_v_height, job.fps = 48, 32, 29.97
        if tables:
            job.extradata["rtjpeg_tables"] = \
                jrtj.RTjpegCompressor(48, 32, 200).tables()
        m = mod(kind, "nuv", job)
        path = tmp_path / f"{side}.nuv"
        m.open(str(path))
        for k in range(3):
            m.write_video(bytes([k]) * (10 + k))
            m.write_audio(bytes(range(8)))
        m.close()
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
