"""The port's baseline JPEG encode and the ``movjpeg`` encoder, on the CPU.

The golden is what the JAX package writes through PIL
(``Image.fromarray(rgb).save(buf, "JPEG", quality=q)``, libjpeg-turbo):
its ``movjpeg`` encoder's route.  Held at tolerance 0 against it:

- the two kernels' plain versions (``jpeg_ycc_down_ref``,
  ``jpeg_fdct_quant_ref``) with the host Huffman coder
  (``csrc/jpeg_huffenc.cpp``) and the headers, against PIL's bytes:
  noise, a gradient and a flat frame at sizes from 1x1 to 640x480, odd
  ones among them (dummy blocks at the right and the bottom), at
  qualities 10, 50, 90 and 100, and every quality from 10 to 100 at
  33x31;
- the quantizer's reciprocal form (libjpeg-turbo's ``compute_reciprocal``
  with 16-bit DCTELEMs) against rounded division over every magnitude an
  int16 coefficient has, for every table entry from 1 to 255;
- the ``movjpeg`` module against the JAX module's ``encode_video`` on
  YUV420P and RGB24 batches;
- ``chip_smoke.MJPEGENC_GOLDEN``'s ``mjpegenc`` case (README's legacy
  AVI, ``-y movjpeg,lame,avi -F MJPG``) through both CLIs, its digest
  pinned for ``chip_smoke.py``, and read back through the port's own
  Motion-JPEG importer as the JAX CLI reads the JAX file.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import jpegenc
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels
from test_torch_audio_encode import run_goldens
from test_torch_mjpeg import in_tree_audio
from test_torch_mpeg_import import jax_cli, jax_native, port_cli  # noqa: F401

CPU = torch.device("cpu")
SIZES = ((1, 1), (7, 5), (15, 17), (16, 16), (17, 33), (33, 31),
         (176, 144), (640, 480))


def frames(width: int, height: int, seed: int) -> np.ndarray:
    """uint8 (3, height, width, 3): noise, a gradient with a seeded
    tint, and a flat colour (DC-only blocks)."""
    rng = np.random.default_rng(seed)
    out = np.empty((3, height, width, 3), np.uint8)
    out[0] = rng.integers(0, 256, (height, width, 3))
    yy, xx = np.mgrid[0:height, 0:width]
    tint = rng.integers(0, 256, 3)
    out[1] = np.stack([(3 * xx + yy + tint[0]) % 256,
                       (5 * yy + tint[1]) % 256,
                       (xx * yy + tint[2]) % 256], -1)
    out[2] = rng.integers(0, 256, 3)
    return out


def pil_jpeg(rgb: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def port_jpegs(rgb: np.ndarray, quality: int):
    """Each frame through the plain versions and the host coder."""
    return jpegenc.encode_rgb(torch.from_numpy(rgb), quality)


@pytest.mark.parametrize("quality", [10, 50, 90, 100])
@pytest.mark.parametrize("width,height", SIZES)
def test_the_plain_path_gives_pils_bytes(width, height, quality):
    rgb = frames(width, height, width * 1000 + height + quality)
    got = port_jpegs(rgb, quality)
    for i in range(len(rgb)):
        assert got[i] == pil_jpeg(rgb[i], quality), i


@pytest.mark.parametrize("quality", range(10, 101))
def test_every_quality_gives_pils_bytes(quality):
    rgb = frames(33, 31, quality)[:2]
    assert port_jpegs(rgb, quality) == [pil_jpeg(f, quality) for f in rgb]


@pytest.mark.parametrize("entry", range(1, 256))
def test_the_reciprocal_quantizer_is_rounded_division(entry):
    """sign(x) * (((|x| + corr) * recip) >> shift) equals
    sign(x) * ((|x| + d/2) // d) for d = entry << 3 and every |x| an
    int16 coefficient has."""
    recip, corr, shift = (int(v) for v in jpegenc.divisors(
        np.full((2, 64), entry, np.uint8))[0, :, 0])
    x = np.arange(0, 32769, dtype=np.int64)
    d = entry << 3
    assert np.array_equal(((x + corr) * recip) >> shift, (x + d // 2) // d)


def test_the_header_is_pils_up_to_the_scan():
    rgb = frames(40, 24, 3)[1]
    want = pil_jpeg(rgb, 75)
    head = jpegenc.header(40, 24, 75)
    assert want.startswith(head) and want.endswith(b"\xff\xd9")
    # PIL gives its tables in natural order
    assert Image.open(io.BytesIO(want)).quantization == {
        t: jpegenc.quant_tables(75)[t].tolist() for t in range(2)}


def test_the_coder_orders_blocks_by_mcu_with_dummies():
    """17x7: three Y block columns and one row the image has, in two
    MCUs of four Y blocks: the fourth column is a dummy (the DC at its
    left, no AC) and so is the second row of each MCU, which takes the
    DC at the right of its MCU's first row."""
    rgb = frames(17, 7, 5)[:1]
    geom = jpegenc.enc_geometry(17, 7)
    div = torch.from_numpy(jpegenc.divisors(jpegenc.quant_tables(90)))
    coef = kernels.jpeg_fdct_quant(kernels.jpeg_ycc_down(
        torch.from_numpy(rgb), geom), div, geom)[0].view(2, 6, 64)
    y = coef[:, :4]
    assert (y[1, 1, 1:] == 0).all() and y[1, 1, 0] == y[1, 0, 0]
    for mcu in range(2):
        for k in (2, 3):
            assert (y[mcu, k, 1:] == 0).all()
            assert y[mcu, k, 0] == y[mcu, 1, 0]
    assert (y[0, :2, 1:] != 0).any()


@pytest.mark.parametrize("what", ["dtype", "shape", "geom", "div"])
def test_the_wrappers_check_their_inputs(what):
    geom = jpegenc.enc_geometry(16, 8)
    rgb = torch.zeros((1, 8, 16, 3), dtype=torch.uint8)
    div = torch.from_numpy(jpegenc.divisors(jpegenc.quant_tables(90)))
    with pytest.raises((ValueError, TypeError)):
        if what == "dtype":
            kernels.jpeg_ycc_down(rgb.to(torch.int16), geom)
        elif what == "shape":
            kernels.jpeg_ycc_down(rgb[:, :4].contiguous(), geom)
        elif what == "geom":
            kernels.jpeg_ycc_down(rgb, (16, 8))
        else:
            planes = kernels.jpeg_ycc_down(rgb, geom)
            kernels.jpeg_fdct_quant(planes, div[:1].contiguous(), geom)


@pytest.mark.cuda
def test_the_kernels_equal_their_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")
    dev = torch.device("cuda")
    for width, height in SIZES:
        rgb = torch.from_numpy(frames(width, height, 1))
        geom = jpegenc.enc_geometry(width, height)
        div = torch.from_numpy(jpegenc.divisors(jpegenc.quant_tables(90)))
        planes = kernels.jpeg_ycc_down(rgb.to(dev), geom)
        assert torch.equal(planes.cpu(), kernels.jpeg_ycc_down_ref(rgb, geom))
        coef = kernels.jpeg_fdct_quant(planes, div.to(dev), geom)
        assert torch.equal(coef.cpu(), kernels.jpeg_fdct_quant_ref(
            planes.cpu(), div, geom))


# ------------------------------------------------------------------ #
# the movjpeg module

def yuv_batch(width: int, height: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (3, height, width), dtype=np.uint8),
            rng.integers(0, 256, (3, height // 2, width // 2),
                         dtype=np.uint8),
            rng.integers(0, 256, (3, height // 2, width // 2),
                         dtype=np.uint8))


@pytest.mark.parametrize("quality", [10, 75, 90])
@pytest.mark.parametrize("fmt", ["yuv420p", "rgb24"])
def test_movjpeg_matches_the_jax_module(fmt, quality):
    options = f"quality={quality}"
    ours = new_module(ModuleKind.ENCODER, "movjpeg", Job(), options)
    ref = jax_new_module(JKind.ENCODER, "movjpeg", JJob(), options)
    if fmt == "rgb24":
        rgb = frames(48, 30, quality)
        got = ours.encode_video(FrameBatch.from_numpy(
            rgb=rgb, device=CPU, fmt=ImageFormat.RGB24))
        want = ref.encode_video(JFrameBatch.from_numpy(
            rgb=rgb, fmt=JFormat.RGB24))
    else:
        y, u, v = yuv_batch(48, 30, quality)
        got = ours.encode_video(FrameBatch.from_numpy(
            y, u, v, device=CPU, fmt=ImageFormat.YUV420P))
        want = ref.encode_video(JFrameBatch.from_numpy(
            y, u, v, fmt=JFormat.YUV420P))
    assert got == want and len(got) == 3


# ------------------------------------------------------------------ #
# the legacy AVI through both CLIs

@pytest.fixture(scope="module")
def goldens(tmp_path_factory, jax_native):
    return run_goldens(("mjpegenc",), tmp_path_factory.mktemp("mjpegenc"))


def test_the_legacy_avi_matches_the_jax_cli(goldens):
    jax_bytes, port_bytes, argv = goldens["mjpegenc"]
    assert jax_bytes and port_bytes == jax_bytes
    assert chip_smoke.sha256_file(argv[argv.index("-o") + 1]) == \
        chip_smoke.MJPEGENC_GOLDEN_SHA256["mjpegenc"]


def test_the_legacy_avi_reads_back_as_the_jax_cli_reads_it(goldens,
                                                            tmp_path):
    """The port's Motion-JPEG importer on the port's AVI (its JPEG frames
    through the decode kernels' plain versions, its MP3 track through
    the in-tree decoder) gives what the JAX CLI gives on the JAX file."""
    argv = goldens["mjpegenc"][2]
    src = argv[argv.index("-o") + 1]
    files = {}
    for side, run, path in (("jax", jax_cli, src.replace("port_", "jax_")),
                            ("port", port_cli, src)):
        back, wav = tmp_path / f"{side}.y4m", tmp_path / f"{side}.wav"
        with in_tree_audio():
            assert run(["-i", path, "-x", "avi", "-o", str(back), "-m",
                        str(wav)]) == 0
        files[side] = (back.read_bytes(), wav.read_bytes())
    assert files["port"] == files["jax"]
    assert b" W128 H96 " in files["port"][0]
    assert files["port"][0].count(b"FRAME\n") == \
        chip_smoke.MJPEGENC_GOLDEN_FRAMES
