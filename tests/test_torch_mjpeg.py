"""The port's baseline JPEG decode and the Motion-JPEG AVI path, on the CPU.

The golden is what the JAX package gives through PIL
(``Image.open(...).convert("RGB")``, libjpeg-turbo): its avi importer's
and mov reader's route.  Held at tolerance 0 against it:

- the host parse (``io/jpeg.py``, ``csrc/jpeg_entropy.cpp``) and the two
  kernels' plain versions (``jpeg_idct_ref``, ``jpeg_color_ref``) on every
  chunk of every fixture and on JPEGs made here: every sampling
  (h1v1, h2v1, h1v2, h2v2, h4v1, gray) at odd sizes and chroma 1 and 2
  samples wide, Adobe RGB, restart intervals by rows and by blocks, a
  stripped DHT, 16-bit tables, non-interleaved scans, two images in a
  chunk with trailing bytes;
- ``jpeg_idct_ref`` against a line-by-line int64 transcription of
  ``jidctint.c`` on in-range blocks, its range limit against
  ``jdmaster.c``'s table;
- the Motion-JPEG AVI through the port's importer and CLI against the
  JAX importer and CLI (``chip_smoke.MJPEG_GOLDEN``'s video cases, each
  output's SHA-256 pinned for ``chip_smoke.py`` to check on the card),
  one launch of each kernel a batch, the refusals by name.

The fixtures are files (``tests/data/mjpeg/make_streams.py``), pinned by
SHA-256 here; the compressed audio tracks are
``tests/test_torch_avi_audio.py``'s, the MOV files
``tests/test_torch_mov.py``'s.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io.avi import AviVideoStream, AviWriter
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import jpeg
from tcforge_tpu_torch.io.avi import AviReader
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels
from tcforge_tpu_torch.pipeline import engine
from test_torch_engine import run_cli

DATA = chip_smoke.MJPEG_DATA
CPU = torch.device("cpu")
FIXTURES = {
    "ac3.avi":
        "2c9aa63869bb42aaad8e78a4054ac1b949d4e7d0e3f67ffa32bcfede96f70841",
    "dot.avi":
        "10ea2997c5a0579e709646a13d662bb6ff8a668e63a86f2b6e3de5628918db65",
    "fields.avi":
        "e6c13342ab078c85222c111216db688322c8c28b9f77794a6f79f64e847cc0ea",
    "jpeg.mov":
        "ea767e8ea9f09bdfb7f97e7f6ed2d00ba282a7ba93e49791ab66d886d5be6a1f",
    "legacy.avi":
        "a2a458028c426bf5fc0788e15b99e78cddb184c227995fe0722aee37ef12af82",
    "mixed.avi":
        "799f8a4fde67b863fda7aa21b21d7a384040f611a55ae82fff0b99d49a33713e",
    "mjpa.mov":
        "0b5312c60e473d074e4277149e315a98106a611d55fd0b0547ce7f6b0bc42637",
    "mp2.avi":
        "d2766244ff6e048e66715bd90c9b261eb23742d4712ec0e1251c54befba04f3f",
    "narrow.avi":
        "7d60b2856686f397b3663bdabd401a4c3f8b90b5f4b08f5e02f9994bd849f2fa",
    "nodht.avi":
        "05f2809db1ef797bbc25f4213da7aafa19b31cfd515fc86bfb503b4fa476cb33",
    "odd.avi":
        "02abc1e02ecdd1a98d090dec795e5ac09f73b1845f88cb9768aec518164b2d46",
    "small.avi":
        "e26169f7cfd4d994f5df710a0b202b14c9b15175e9ba4036585d5d1ac36df7a8",
}
AVI_FIXTURES = sorted(n for n in FIXTURES if n.endswith(".avi"))
# the golden cases of this file; the audio and MOV ones are
# test_torch_avi_audio.py's and test_torch_mov.py's
VIDEO_GOLDEN = ("mjpeg", "small_avi", "mixed", "odd", "narrow", "dot",
                "fields", "nodht")


def _load_make_streams():
    spec = importlib.util.spec_from_file_location(
        "mjpeg_make_streams", DATA / "make_streams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


make_streams = _load_make_streams()


def chunks(name: str):
    with AviReader(str(DATA / name)) as r:
        return [bytes(r.read_video_frame(i)[0])
                for i in range(r.video_frames)]


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def port_rgb(data: bytes) -> np.ndarray:
    """One JPEG through the host decode and the plain versions."""
    geom, coef, qt = jpeg.decode_coefficients(data)
    samples = kernels.jpeg_idct(torch.from_numpy(coef),
                                torch.from_numpy(qt)[None], geom)
    return kernels.jpeg_color(samples, geom)[0].numpy()


def assert_decodes_as_pil(data: bytes) -> None:
    want = pil_rgb(data)
    got = port_rgb(data)
    assert got.shape == want.shape
    assert np.array_equal(got, want), \
        f"{int((got != want).sum())} bytes differ"


# ------------------------------------------------------------------ #
# the JAX and port CLIs on the golden cases

class InTreeDecoder:
    """The JAX bridge's ``AvAudioDecoder`` shape over the JAX package's
    in-tree decoder of the same kind: the golden audio route."""

    def __init__(self, name: str):
        from tcforge_tpu.io import a52dec, mp2dec
        self._dec = (a52dec if name == "ac3" else mp2dec).StreamDecoder()

    def feed(self, data: bytes) -> None:
        self._dec.feed(data)

    def read(self):
        return self._dec.read()

    def flush(self) -> None:
        self._dec.flush()


@contextlib.contextmanager
def in_tree_audio():
    """The JAX avi importer's compressed audio through its in-tree
    decoders (its route without the FFmpeg bridge)."""
    import tcforge_tpu.native.av as av
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(av, "AvAudioDecoder", InTreeDecoder)
        yield


def jax_cli(argv):
    return jax_cli_main([*argv, "--mesh", "off", "-q", "--progress_off"])


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


# hqdn3d on frames of another size than the header's (a chunk's first
# field image): the JAX chain's native host stage seeds from the frames,
# and it runs only where JAX has one device (chain.py _host_idx), as the
# JAX CLI does on a CPU; the tests' eight-device mesh jits it instead,
# which fails to broadcast the header-sized state
ONE_DEVICE = ("fields", "mov_mjpa")


def jax_cli_one_device(argv):
    """The JAX CLI in a process of its own with one CPU device."""
    code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu');"
            "from tcforge_tpu.cli import main; sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-c", code, *argv, "--mesh", "off", "-q",
         "--progress_off"], cwd=str(chip_smoke.ROOT), env=env,
        timeout=300).returncode


def run_goldens(cases, tmp):
    """Each ``chip_smoke.MJPEG_GOLDEN`` case through both CLIs (the JAX
    one's audio through its in-tree decoders; ``ONE_DEVICE``'s on one
    device): {case: {"jax": outputs, "port": outputs}}, each a list of
    bytes."""
    out = {}
    for case in cases:
        got = {}
        jax_run = jax_cli_one_device if case in ONE_DEVICE else jax_cli
        for key, run in (("jax", jax_run), ("port", port_cli)):
            d = tmp / f"{key}_{case}"
            d.mkdir()
            with in_tree_audio():
                rc = run(chip_smoke.mjpeg_golden_argv(case, d))
            assert rc == 0, (case, key)
            got[key] = [f.read_bytes() for f in
                        chip_smoke.mjpeg_golden_outputs(case, d)]
        out[case] = got
    return out


def assert_golden(outs, case):
    assert outs[case]["port"] == outs[case]["jax"]
    digests = [hashlib.sha256(b).hexdigest() for b in outs[case]["port"]]
    assert digests == list(chip_smoke.MJPEG_GOLDEN_SHA256[case])


@pytest.fixture(scope="module")
def video_goldens(tmp_path_factory):
    return run_goldens(VIDEO_GOLDEN, tmp_path_factory.mktemp("mjpeg"))


@pytest.mark.parametrize("case", VIDEO_GOLDEN)
def test_mjpeg_golden_cli_matches_jax_cli_byte_for_byte(case, video_goldens):
    assert_golden(video_goldens, case)


def test_the_readme_command_fails_in_both_clis_as_hqdn3d_refuses_rgb(
        tmp_path, capsys):
    """-y raw,raw,avi keeps an RGB24 source RGB into the AVI (the JAX
    engine's _setup_modules), where hqdn3d takes YUV420P only: both CLIs
    stop, so the mjpeg path writes a Y4M and a WAV."""
    argv = ["-i", str(DATA / "legacy.avi"), "-x", "avi", "-J",
            "hqdn3d=luma=4.0", "-y", "raw,raw,avi"]
    assert jax_cli([*argv, "-o", str(tmp_path / "j.avi")]) == 1
    assert port_cli([*argv, "-o", str(tmp_path / "p.avi")]) == 1
    assert "hqdn3d only supports YUV420P" in capsys.readouterr().err


# ------------------------------------------------------------------ #
# the fixtures

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_pinned(name):
    digest = hashlib.sha256((DATA / name).read_bytes()).hexdigest()
    assert digest == FIXTURES[name]


def test_fixture_directory_stays_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()
               if p.is_file()) < 800_000


def test_standard_tables_are_pils():
    """The Annex K tables the port takes where a DHT is missing are the
    ones PIL's encoder writes."""
    head = jpeg.read_headers(make_streams.pil_jpeg(
        make_streams.test_rgb(16, 16, 1)))
    assert head.huff == {k: (bytes(b), v)
                         for k, (b, v) in jpeg.STD_TABLES.items()}


# ------------------------------------------------------------------ #
# the decode against PIL

FIXTURE_CHUNKS = [(name, i) for name in AVI_FIXTURES
                  for i in range(len(chunks(name)))]


@pytest.mark.parametrize("name,index", FIXTURE_CHUNKS)
def test_fixture_chunk_decodes_as_pil(name, index):
    assert_decodes_as_pil(chunks(name)[index])


SAMPLINGS = {"h1v1": [(1, 1)] * 3, "h2v1": [(2, 1), (1, 1), (1, 1)],
             "h1v2": [(1, 2), (1, 1), (1, 1)],
             "h2v2": [(2, 2), (1, 1), (1, 1)],
             "h4v1": [(4, 1), (1, 1), (1, 1)], "gray": [(1, 1)]}
# odd sizes; chroma 1 and 2 samples wide and high
SIZES = [(16, 16), (13, 7), (1, 1), (2, 9), (4, 3), (9, 2), (33, 17)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_every_sampling_decodes_as_pil(sampling, size):
    w, h = size
    rgb = make_streams.test_rgb(w, h, seed=w * 31 + h)
    planes = make_streams.ycc_planes(rgb, SAMPLINGS[sampling] if
                                     sampling != "gray" else [(1, 1)] * 3)
    factors = SAMPLINGS[sampling]
    assert_decodes_as_pil(make_streams.encode_baseline(
        planes[:len(factors)], factors, w, h, quality=75))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("opts", [
    dict(quality=95), dict(quality=30), dict(restart_marker_rows=1),
    dict(restart_marker_blocks=1), dict(restart_marker_blocks=5)])
def test_pil_jpegs_decode_as_pil(subsampling, opts):
    rgb = make_streams.test_rgb(37, 21, seed=subsampling + 7)
    assert_decodes_as_pil(make_streams.pil_jpeg(
        rgb, subsampling=subsampling, **opts))


@pytest.mark.parametrize("case", ["adobe_rgb", "gray_pil", "stripped_dht",
                                  "stripped_dht_restart", "qt16",
                                  "separate_scans", "rgb_ids", "no_app0",
                                  "two_images", "trailing_bytes",
                                  "restart_mcus", "fill_bytes"])
def test_special_jpegs_decode_as_pil(case):
    rgb = make_streams.test_rgb(29, 19, seed=5)
    ms = make_streams
    planes = ms.ycc_planes(rgb, [(2, 2), (1, 1), (1, 1)])
    if case == "adobe_rgb":
        data = ms.pil_jpeg(rgb, keep_rgb=True)
    elif case == "gray_pil":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("L").save(buf, "JPEG", quality=70)
        data = buf.getvalue()
    elif case == "stripped_dht":
        data = ms.strip_dht(ms.pil_jpeg(rgb, subsampling=2))
    elif case == "stripped_dht_restart":
        data = ms.strip_dht(ms.pil_jpeg(rgb, subsampling=1,
                                        restart_marker_blocks=2))
    elif case == "qt16":
        data = ms.encode_baseline(planes, [(2, 2), (1, 1), (1, 1)], 29, 19,
                                  qt16=True, quality=20)
    elif case == "separate_scans":
        data = ms.encode_baseline(planes, [(2, 2), (1, 1), (1, 1)], 29, 19,
                                  separate=True)
    elif case == "rgb_ids":
        data = ms.encode_baseline([rgb[..., i] for i in range(3)],
                                  [(1, 1)] * 3, 29, 19, app0=b"",
                                  ids=[82, 71, 66])
    elif case == "no_app0":
        data = ms.encode_baseline(planes, [(2, 2), (1, 1), (1, 1)], 29, 19,
                                  app0=b"", dht=False)
    elif case == "two_images":
        data = (ms.pil_jpeg(rgb, subsampling=2)
                + ms.pil_jpeg(rgb[::-1].copy(), subsampling=0))
    elif case == "trailing_bytes":
        data = ms.pil_jpeg(rgb, subsampling=2) + b"\xff\x00junk\xff"
    elif case == "restart_mcus":
        data = ms.encode_baseline(planes, [(2, 2), (1, 1), (1, 1)], 29, 19,
                                  restart=1)
    else:                    # fill bytes before the markers after SOI
        data = ms.pil_jpeg(rgb, subsampling=2)
        data = data[:2] + b"\xff\xff" + data[2:]
    assert_decodes_as_pil(data)


# ------------------------------------------------------------------ #
# the refusals

def _sof_patched(code: int = None, precision: int = None,
                 height: int = None) -> bytes:
    data = bytearray(make_streams.pil_jpeg(make_streams.test_rgb(16, 16, 3)))
    at = data.index(b"\xff\xc0")
    if code is not None:
        data[at + 1] = code
    if precision is not None:
        data[at + 4] = precision
    if height is not None:
        struct.pack_into(">H", data, at + 5, height)
    return bytes(data)


def _refused(what: str) -> bytes:
    if what == "progressive":
        return make_streams.pil_jpeg(make_streams.test_rgb(16, 16, 3),
                                     progressive=True)
    if what == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(make_streams.test_rgb(16, 16, 3)).convert(
            "CMYK").save(buf, "JPEG")
        return buf.getvalue()
    return {"lossless": lambda: _sof_patched(0xC3),
            "hierarchical": lambda: _sof_patched(0xC5),
            "arithmetic": lambda: _sof_patched(0xC9),
            "12-bit": lambda: _sof_patched(precision=12),
            "dnl": lambda: _sof_patched(height=0)}[what]()


@pytest.mark.parametrize("what,match", [
    ("progressive", "progressive JPEG \\(SOF2\\)"),
    ("lossless", "lossless JPEG \\(SOF3\\)"),
    ("hierarchical", "hierarchical JPEG \\(SOF5\\)"),
    ("arithmetic", "arithmetic-coded JPEG \\(SOF9\\)"),
    ("12-bit", "12-bit samples"),
    ("cmyk", "four-component \\(CMYK/YCCK\\) JPEG"),
    ("dnl", "a height given by a DNL marker")])
def test_what_the_port_does_not_decode_is_refused_by_name(what, match):
    with pytest.raises(NotImplementedError, match=match) as e:
        jpeg.decode_coefficients(_refused(what))
    assert "not ported to the torch port" in str(e.value)


def test_a_progressive_mjpeg_avi_is_refused_through_the_cli(tmp_path):
    src = tmp_path / "p.avi"
    w = AviWriter(str(src), AviVideoStream(fourcc="MJPG", width=16,
                                           height=16, fps=25.0), [])
    w.write_video_frame(_refused("progressive"))
    w.close()
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "o.y4m")]) == 1


@pytest.mark.parametrize("cut", [3, 40, 200])
def test_a_cut_jpeg_raises(cut):
    data = make_streams.pil_jpeg(make_streams.test_rgb(16, 16, 3))
    with pytest.raises(ValueError):
        jpeg.decode_coefficients(data[:cut])


# ------------------------------------------------------------------ #
# the plain versions

# jidctint.c's FIX() constants at CONST_BITS 13
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _islow_int64(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` transcribed line by line in int64, with its
    zero-AC shortcuts and its range-limit table (``jdmaster.c``)."""
    table = np.zeros(1024, np.int64)
    simple = np.concatenate([np.zeros(256), np.arange(256),
                             np.full(384, 255), np.zeros(384)])
    # the post-IDCT table: sample_range_limit + CENTERJSAMPLE, its
    # second half zeros then the simple table's start
    table[:512] = simple[256 + 128:256 + 128 + 512]
    table[512:896] = 0
    table[896:] = np.arange(128)
    out = np.zeros((8, 8), np.int64)
    ws = np.zeros((8, 8), np.int64)

    def odd(t0, t1, t2, t3):
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * _F["f1175"]
        t0, t1 = t0 * _F["f0298"], t1 * _F["f2053"]
        t2, t3 = t2 * _F["f3072"], t3 * _F["f1501"]
        z1, z2 = z1 * -_F["f0899"], z2 * -_F["f2562"]
        z3, z4 = z3 * -_F["f1961"] + z5, z4 * -_F["f0390"] + z5
        return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4

    def even(d0, d2, d4, d6):
        z1 = (d2 + d6) * _F["f0541"]
        tmp2, tmp3 = z1 - d6 * _F["f1847"], z1 + d2 * _F["f0765"]
        tmp0, tmp1 = (d0 + d4) << 13, (d0 - d4) << 13
        return tmp0 + tmp3, tmp1 + tmp2, tmp1 - tmp2, tmp0 - tmp3

    x = coef.astype(np.int64).reshape(8, 8) * q.astype(np.int64).reshape(8, 8)
    for c in range(8):
        col = x[:, c]
        if not col[1:].any():
            ws[:, c] = col[0] << 2
            continue
        t10, t11, t12, t13 = even(col[0], col[2], col[4], col[6])
        t0, t1, t2, t3 = odd(col[7], col[5], col[3], col[1])
        for r, v in enumerate((t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                               t13 - t0, t12 - t1, t11 - t2, t10 - t3)):
            ws[r, c] = (v + (1 << 10)) >> 11
    for r in range(8):
        row = ws[r]
        if not row[1:].any():
            out[r] = table[((row[0] + 16) >> 5) & 1023]
            continue
        t10, t11, t12, t13 = even(row[0], row[2], row[4], row[6])
        t0, t1, t2, t3 = odd(row[7], row[5], row[3], row[1])
        for c, v in enumerate((t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                               t13 - t0, t12 - t1, t11 - t2, t10 - t3)):
            out[r, c] = table[((v + (1 << 17)) >> 18) & 1023]
    return out.reshape(64)


@pytest.mark.parametrize("seed", range(4))
def test_idct_ref_matches_libjpegs_int64_form(seed):
    """In range (products well inside int32) the plain version's int32
    arithmetic is jidctint.c's; sparse blocks take its shortcuts."""
    rng = np.random.default_rng(seed)
    n = 300
    coef = rng.integers(-200, 201, (n, 64)).astype(np.int16)
    coef[::3] *= (rng.random((len(coef[::3]), 64)) < 0.1)
    coef[::5, 1:] = 0
    q = rng.integers(1, 40, 64)
    geom = jpeg.geometry(8, 8 * n, jpeg.GRAY, [(1, 1)])
    qt = np.zeros((1, 4, 64), np.int16)
    qt[0, 0] = q
    got = jpeg.idct_ref(torch.from_numpy(coef), torch.from_numpy(qt),
                        geom).numpy()
    want = np.stack([_islow_int64(c, q) for c in coef])
    assert np.array_equal(got, want)


def test_range_limit_is_libjpegs_table():
    x = torch.arange(-4096, 4096, dtype=torch.int32)
    got = jpeg.range_limit(x).to(torch.int64).numpy()
    m = x.numpy() & 1023
    want = np.where(m < 128, m + 128, np.where(m < 512, 255, np.where(
        m < 896, 0, m - 896)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "blocks", "qt_shape", "geom",
                                 "samples"])
def test_the_wrappers_check_their_input(bad):
    geom = jpeg.geometry(16, 16, jpeg.YCC, [(2, 2), (1, 1), (1, 1)])
    coef = torch.zeros((geom.blocks, 64), dtype=torch.int16)
    qt = torch.zeros((1, 4, 64), dtype=torch.int16)
    samples = torch.zeros((geom.blocks, 64), dtype=torch.uint8)
    if bad == "dtype":
        coef = coef.to(torch.int32)
    elif bad == "blocks":
        coef = coef[:-1]
    elif bad == "qt_shape":
        qt = qt[:, :3]
    elif bad == "samples":
        samples = samples[:-1]
    err = TypeError if bad == "geom" else ValueError
    with pytest.raises(err):
        if bad == "samples":
            kernels.jpeg_color(samples, geom)
        else:
            kernels.jpeg_idct(coef, qt, None if bad == "geom" else geom)


# ------------------------------------------------------------------ #
# the importer and the engine

def port_importer(name: str):
    import tcforge_tpu_torch.modules  # noqa: F401
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(DATA / name))
    imp.start(CPU)
    return imp


def jax_frames(path):
    import tcforge_tpu.modules  # noqa: F401
    imp = jax_new_module(JKind.DEMULTIPLEXOR, "avi", JJob())
    imp.open(str(path))
    out = []
    while (b := imp.read_video_batch(4)) is not None:
        out += list(b["rgb"])
    imp.close()
    return out


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("name", ["mixed.avi", "fields.avi", "nodht.avi",
                                  "small.avi"])
def test_importer_matches_the_jax_importer(name, batch):
    """RGB24 frames in batches, the runs of one geometry of mixed.avi's
    chunks, the zero-size chunk skipped (small.avi has none: mixed is
    rewritten with one here)."""
    imp = port_importer(name)
    assert imp.planned and imp.format.value == "rgb24"
    got = []
    while (b := imp.read_video_batch(batch)) is not None:
        assert b["rgb"].dtype == torch.uint8
        got += list(b["rgb"].numpy())
    imp.close()
    want = jax_frames(DATA / name)
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_a_zero_size_chunk_gives_no_frame(tmp_path):
    src = tmp_path / "z.avi"
    cs = chunks("small.avi")
    w = AviWriter(str(src), AviVideoStream(fourcc="MJPG", width=64,
                                           height=48, fps=25.0), [])
    for c in (cs[0], b"", cs[1], b"", b"", cs[2]):
        w.write_video_frame(c)
    w.close()
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(src))
    imp.start(CPU)
    got = imp.read_video_batch(16)["rgb"].numpy()
    assert imp.read_video_batch(16) is None
    want = jax_frames(src)
    assert len(got) == len(want) == 3
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_frames_of_two_sizes_in_a_batch_fail_as_in_the_jax_importer(
        tmp_path):
    src = tmp_path / "two.avi"
    w = AviWriter(str(src), AviVideoStream(fourcc="MJPG", width=64,
                                           height=48, fps=25.0), [])
    w.write_video_frame(chunks("small.avi")[0])
    w.write_video_frame(chunks("odd.avi")[0])
    w.close()
    with pytest.raises(ValueError, match="same shape"):
        jax_frames(src)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(src))
    imp.start(CPU)
    with pytest.raises(ValueError, match="same shape"):
        imp.read_video_batch(4)


def test_one_launch_of_each_kernel_a_batch(monkeypatch, tmp_path):
    """The CLI path calls each JPEG wrapper once a batch of one geometry
    (mixed.avi: once a run of one geometry)."""
    calls = {"jpeg_idct": 0, "jpeg_color": 0}
    for name in calls:
        orig = getattr(kernels, name)

        def spy(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(kernels, name, spy)
    for src, batch, want in (("small.avi", 16, 1), ("small.avi", 4, 2),
                             ("mixed.avi", 16, 12)):
        for k in calls:
            calls[k] = 0
        assert port_cli(["-i", str(DATA / src), "-o",
                         str(tmp_path / "o.y4m"), "--batch",
                         str(batch)]) == 0
        assert calls == {"jpeg_idct": want, "jpeg_color": want}


def test_x_auto_takes_an_mjpeg_avi_to_the_avi_module():
    job = Job(video_in_file=str(DATA / "small.avi"))
    assert engine.video_module(job) == "avi"


def test_an_importer_given_no_device_decodes_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(DATA / "small.avi"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imp.read_video_batch(3)


@pytest.mark.cuda
def test_jpeg_kernels_match_their_plain_versions_on_cuda():
    """Both kernels against their plain versions on the card, on every
    chunk of the AVI fixtures (``chip_smoke.py`` phase 3 does it on every
    fixture and on random records)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for name in AVI_FIXTURES:
        for c in chunks(name):
            geom, coef, qt = jpeg.decode_coefficients(c)
            coef = torch.from_numpy(coef).to(dev)
            qt = torch.from_numpy(qt)[None].to(dev)
            samples = kernels.jpeg_idct(coef, qt, geom)
            assert torch.equal(samples, kernels.jpeg_idct_ref(coef, qt,
                                                              geom))
            assert torch.equal(kernels.jpeg_color(samples, geom),
                               kernels.jpeg_color_ref(samples, geom))
