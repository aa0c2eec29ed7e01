"""The torch port's package rules and core records, against the JAX package.

- no module of ``tcforge_tpu_torch`` (nor ``chip_smoke.py``) imports jax
  or tcforge_tpu;
- the jax-free modules copied into the port equal their sources;
- FrameBatch, the registry and the kernel wrappers' input checks.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tcforge_tpu.core import formats as jformats
from tcforge_tpu.core import job as jjob
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu_torch.core import formats as tformats
from tcforge_tpu_torch.core import job as tjob
from tcforge_tpu.core import frame as jframe
from tcforge_tpu_torch.core import frame as tframe
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.modules import registry as tregistry
from tcforge_tpu_torch.modules.filters import cadence
from tcforge_tpu_torch.modules.filters.denoise3d import Denoise3dFilter
from tcforge_tpu_torch.modules.filters.hqdn3d import Hqdn3dFilter
from tcforge_tpu_torch.modules.filters.tomsmocomp import TomsMoCompFilter
from tcforge_tpu_torch.modules.filters.unsharp import UnsharpFilter
from tcforge_tpu_torch.ops import kernels, zoom

# One intra-op thread per test process.  Every xdist worker collects
# every test file before it runs any, so this line, in a port test
# module that all workers import, sets each worker's torch to one
# thread for the whole run.  Six workers with torch's default eight
# threads each on eight cores oversubscribe the CPU: three copies of
# test_torch_stabilize.py's warp_plane/transform_filter cases run at
# once with eight threads each did not finish in 230 s, with one thread
# each they took 47 s (one copy alone: 63 s with eight threads, 76 s
# with one).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tcforge_tpu_torch"

COPIES = ["core/formats.py", "core/optstr.py", "core/codecs.py",
          "core/framecode.py", "core/job.py", "core/ratiocodes.py",
          "io/y4m.py", "io/image.py", "io/wav.py", "io/mpeg.py",
          "io/probe.py", "io/ts.py", "io/ac3.py", "io/a52dec.py",
          "io/mp2dec.py", "io/mp3dec.py", "io/vag.py", "io/ifo.py",
          "io/spu.py", "io/vobsub.py", "io/mp3.py", "io/psmux.py",
          "modules/importers/framegen.py", "io/avi.py", "io/rawio.py",
          "io/tclzo.py", "io/_mp4tables.py", "io/mpeg4.py", "io/mpaenc.py",
          "io/mp3enc.py", "io/a52enc.py", "io/cdxa.py", "io/aacdec.py",
          "io/flac.py", "io/ogg.py", "io/vorbis.py", "io/vorbisenc.py",
          "io/au.py", "io/aacenc.py", "io/dv.py", "io/nuv.py", "io/pvn.py",
          "io/rtjpeg.py"]
# lines a whole-file copy changes: the audio encoders and FLAC take their
# BitWriter from io/mpeg2host.py, the jax-free copy of io/mpeg2codec.py's head
# (which pins the class to its source), and the MP3 encoder's _emit skips
# a region coded with table 0, all zeros in no bits, where the source
# looks up the table's codes and raises
COPY_CHANGES = {
    rel: {"from .mpeg2codec import BitWriter\n":
          "from .mpeg2host import BitWriter\n"}
    for rel in ("io/mpaenc.py", "io/mp3enc.py", "io/a52enc.py",
                "io/flac.py", "io/aacenc.py")}
COPY_CHANGES["io/mp3enc.py"][
    "            vidx, linbits, _mx = _TSEL[tsel]\n"
    "            codes, lens = _VTABS[vidx]\n"] = (
    "            vidx, linbits, _mx = _TSEL[tsel]\n"
    "            if vidx == 0:\n"
    "                # table 0 codes an all-zero region in no bits (the JAX\n"
    "                # source looks its codes up and raises)\n"
    "                continue\n"
    "            codes, lens = _VTABS[vidx]\n")
# C++ sources copied whole from native/ (the MPEG-2 host parse)
NATIVE_COPIES = {"csrc/mpeg2intra.cpp": "native/mpeg2intra.cpp",
                 "csrc/mpeg2tables.h": "native/mpeg2tables.h",
                 "csrc/mpeg2encode.cpp": "native/mpeg2encode.cpp"}
# copies of line ranges of a source: the framework-free head of
# io/mpeg2codec.py (up to its ``import jax``) without the two functions
# that reach the JAX package (the 4:2:2 intra reconstruction and the
# native decode loop), and its numpy field helpers; the jax-free parts of
# io/mpeg2enc.py (numpy, the macroblock modes, the alternate scan, the
# D-picture math, TM5 rate control); io/mpeg4dec.py without its unused
# import of io/dvdec.py (line 56); the MPEG-4 encoder's syntax writer
# (the bit writer, VLC tables and block, vector and DC coding, the FDCT
# basis and quantizers, the stream and VOP headers, the intra
# macroblock's writer, the B mb_type codes and the vector wrap);
# split_extra_options of the encoder cfg tier; the MOV reader without its
# photo-JPEG branch (the port's own, io/jpeg.py) and the writer without
# write_video_frame (PIL's photo-JPEG: the port's is io/jpegenc.py); the
# DV decoder without its docstring and decode and the DV encoder without
# its docstring, forward transforms, encode and _segment_strings
# (io/dvcodec.py splits those between the card and the host)
RANGE_COPIES = {"io/mpeg4dec.py": ("io/mpeg4dec.py",
                                   ((1, 55), (57, 2791))),
                "io/mpeg2host.py": ("io/mpeg2codec.py",
                                    ((1, 946), (983, 1069), (1880, 2031))),
                "io/mpeg2rc.py": ("io/mpeg2enc.py",
                                  ((31, 31), (37, 40), (43, 49),
                                   (1192, 1316))),
                "io/mpeg4syntax.py": ("io/mpeg4enc.py",
                                      ((1, 205), (211, 216), (278, 347),
                                       (390, 406), (783, 786), (838, 844))),
                "modules/encoders/encoder_cfg.py": (
                    "modules/encoders/encoder_cfg.py",
                    ((18, 21), (24, 24), (40, 57))),
                "io/mov.py": ("io/mov.py", ((1, 339), (344, 404), (423, 546))),
                "io/dvdec.py": ("io/dvdec.py", ((41, 479), (575, 634))),
                "io/dvenc.py": ("io/dvenc.py", ((27, 130), (240, 383),
                                                (469, 480), (548, 597))),
                "io/theora.py": ("io/theora.py", ((27, 578), (584, 586),
                                                  (642, 649), (680, 856))),
                "io/theoraenc.py": ("io/theoraenc.py",
                                    ((29, 281), (287, 289), (315, 410),
                                     (950, 1034)))}


def _rewrite(src: str) -> str:
    """A source as the port copies it: every import of the JAX package,
    indented lazy ones too, names the port's package instead."""
    return re.sub(r"^(\s*)from tcforge_tpu([. ])", r"\1from tcforge_tpu_torch\2",
                  src, flags=re.M)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if re.match(r"(jax|jaxlib|tcforge_tpu)(\.|$)", m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("rel", COPIES)
def test_copies_match_their_sources(rel):
    ours = (PORT / rel).read_text().splitlines(keepends=True)
    assert ours[0].startswith(f"# Copied from tcforge_tpu/{rel};")
    src = (REPO / "tcforge_tpu" / rel).read_text()
    for old, new in COPY_CHANGES.get(rel, {}).items():
        assert src.count(old) == 1, (rel, old)
        src = src.replace(old, new)
    assert "".join(ours[1:]) == _rewrite(src)


@pytest.mark.parametrize("rel", sorted(NATIVE_COPIES))
def test_native_copies_match_their_sources(rel):
    ours = (PORT / rel).read_text().splitlines(keepends=True)
    assert ours[0].startswith(f"// Copied from {NATIVE_COPIES[rel]};")
    assert "".join(ours[1:]) == (REPO / NATIVE_COPIES[rel]).read_text()


@pytest.mark.parametrize("rel,part", [(rel, i) for rel, (_, ranges)
                                      in RANGE_COPIES.items()
                                      for i in range(len(ranges))])
def test_range_copies_match_their_sources(rel, part):
    """Each pinned line range of the source, in the copy in order after
    the one-line header, which names the ranges."""
    src_rel, ranges = RANGE_COPIES[rel]
    ours = (PORT / rel).read_text().splitlines(keepends=True)
    spans = " and ".join(f"{a}-{b}" for a, b in ranges)
    assert ours[0].startswith(f"# Copied from tcforge_tpu/{src_rel} lines "
                              f"{spans};")
    src = (REPO / "tcforge_tpu" / src_rel).read_text().splitlines(
        keepends=True)
    assert len(ours) == 1 + sum(b - a + 1 for a, b in ranges)
    at = 1 + sum(b - a + 1 for a, b in ranges[:part])
    a, b = ranges[part]
    assert "".join(ours[at:at + b - a + 1]) == _rewrite("".join(src[a - 1:b]))


def test_image_format_members():
    assert ([(m.name, m.value) for m in tformats.ImageFormat]
            == [(m.name, m.value) for m in jformats.ImageFormat])


def test_job_fields_and_defaults():
    def fields(mod):
        out = []
        for f in dataclasses.fields(mod.Job):
            default = (f.default_factory() if f.default_factory
                       is not dataclasses.MISSING else f.default)
            if hasattr(default, "name"):          # enum members
                default = (type(default).__name__, default.name)
            out.append((f.name, default))
        return out
    assert fields(tjob) == fields(jjob)


@pytest.mark.parametrize("text", ["hqdn3d=luma=4.0", "hqdn3d",
                                  "hqdn3d = luma=2:chroma=3 "])
def test_filter_spec_parse(text):
    t, j = tjob.FilterSpec.parse(text), jjob.FilterSpec.parse(text)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_filter_slots_and_kinds_match():
    assert ({s.name: s.value for s in tregistry.FilterSlot}
            == {s.name: s.value for s in jregistry.FilterSlot})
    assert ({k.name: k.value for k in tregistry.ModuleKind}
            == {k.name: k.value for k in jregistry.ModuleKind})


@pytest.mark.parametrize("name,cls,options", [
    ("hqdn3d", Hqdn3dFilter, "luma=4.0"),
    ("unsharp", UnsharpFilter, "luma=0.8:luma_matrix=7x5"),
    ("tomsmocomp", TomsMoCompFilter, "searcheffort=5"),
    ("denoise3d", Denoise3dFilter, ""),
    ("ivtc", cadence.IvtcFilter, "field=1"),
    ("32detect", cadence.Detect32Filter, "threshold=12"),
    ("decimate", cadence.DecimateFilter, ""),
    ("32drop", cadence.Drop32Filter, "")])
def test_registry_lookup(name, cls, options):
    job = tjob.Job()
    mod = tregistry.new_module(tregistry.ModuleKind.FILTER, name, job,
                               options)
    assert isinstance(mod, cls)
    jcls = jregistry.lookup(jregistry.ModuleKind.FILTER, name)
    assert mod.slots == jcls.slots
    assert ([(p.name, p.default) for p in cls.desc.params]
            == [(p.name, p.default) for p in jcls.desc.params])
    with pytest.raises(KeyError, match="nosuch"):
        tregistry.lookup(tregistry.ModuleKind.FILTER, "nosuch")


@pytest.mark.parametrize("name", [n for n in dir(jframe)
                                  if n.startswith("ATTR_")])
def test_frame_attr_flags(name):
    assert getattr(tframe, name) == getattr(jframe, name)


def test_with_attrs():
    fb = FrameBatch.from_numpy(np.zeros((2, 4, 4), np.uint8),
                               device=torch.device("cpu"))
    attrs = torch.tensor([8, 0], dtype=torch.int32)
    out = fb.with_attrs(attrs)
    assert out.attrs is attrs and out.y is fb.y and fb.attrs.tolist() == [0, 0]


def test_frame_batch_roundtrip():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (3, 6, 8), dtype=np.uint8)
    u = rng.integers(0, 256, (3, 3, 4), dtype=np.uint8)
    v = rng.integers(0, 256, (3, 3, 4), dtype=np.uint8)
    fb = FrameBatch.from_numpy(y, u, v, device=torch.device("cpu"),
                               fps=25.0, first_id=5)
    assert (fb.batch, fb.height, fb.width) == (3, 6, 8)
    assert fb.frame_ids.tolist() == [5, 6, 7]
    assert fb.attrs.dtype == torch.int32 and fb.attrs.tolist() == [0] * 3
    for got, want in zip(fb.to_numpy(), (y, u, v)):
        np.testing.assert_array_equal(got, want)
    fb2 = fb.with_planes(y=torch.zeros((3, 6, 8), dtype=torch.uint8))
    assert int(fb2.y.sum()) == 0 and fb2.u is fb.u and fb2.fps == 25.0
    single = FrameBatch.from_numpy(y[0], device=torch.device("cpu"))
    assert single.y.shape == (1, 6, 8) and single.u is None


def test_frame_batch_rgb_form():
    """``rgb`` replaces the planes, the planes replace ``rgb``, as in the
    JAX record."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (2, 4, 6, 3), dtype=np.uint8)
    cpu = torch.device("cpu")
    fb = FrameBatch.from_numpy(rgb=rgb, device=cpu, fmt=ImageFormat.RGB24)
    jfb = jframe.FrameBatch.from_numpy(rgb=rgb, fmt=jformats.ImageFormat.RGB24)
    assert (fb.batch, fb.height, fb.width) == (jfb.batch, jfb.height,
                                              jfb.width) == (2, 4, 6)
    assert fb.y is None and len(fb.planes) == len(jfb.planes) == 1
    np.testing.assert_array_equal(fb.to_numpy()[0], rgb)
    y = torch.zeros((2, 4, 6), dtype=torch.uint8)
    back = fb.with_planes(y=y, u=y[:, :2, :3], v=y[:, :2, :3],
                          format=ImageFormat.YUV420P)
    assert back.rgb is None and back.y is y and len(back.planes) == 3
    again = back.with_planes(rgb=fb.rgb, format=ImageFormat.RGB24)
    assert again.y is None and again.u is None and again.rgb is fb.rgb
    single = FrameBatch.from_numpy(rgb=rgb[0], device=cpu,
                                   fmt=ImageFormat.RGB24)
    assert single.rgb.shape == (1, 4, 6, 3)


class TestWrapperChecks:
    """Each wrapper raises on what its kernel does not take."""

    lut = torch.zeros(kernels.LUT_SIZE, dtype=torch.int32)

    def test_spatial_scan(self):
        x = torch.zeros((2, 4, 5), dtype=torch.uint8)
        with pytest.raises(ValueError, match="dtype"):
            kernels.spatial_scan(x.float(), self.lut, -1)
        with pytest.raises(ValueError, match="3-D"):
            kernels.spatial_scan(x[0], self.lut, -1)
        with pytest.raises(ValueError, match="contiguous"):
            kernels.spatial_scan(x.transpose(1, 2), self.lut, -1)
        with pytest.raises(ValueError, match="entries"):
            kernels.spatial_scan(x, self.lut[:100], -1)
        with pytest.raises(ValueError, match="axis"):
            kernels.spatial_scan(x, self.lut, 0)
        with pytest.raises(ValueError, match="device"):
            kernels.spatial_scan(x.to("meta"), self.lut.to("meta"), -1)

    def test_temporal_scan(self):
        v = torch.zeros((2, 4, 5), dtype=torch.int32)
        with pytest.raises(ValueError, match="ant shape"):
            kernels.temporal_scan(v, torch.zeros((4, 4), dtype=torch.int32),
                                  self.lut)
        with pytest.raises(ValueError, match="dtype"):
            kernels.temporal_scan(v.to(torch.uint8),
                                  torch.zeros((4, 5), dtype=torch.int32),
                                  self.lut)

    def test_zoom_pass(self):
        img = torch.zeros((2, 4, 9), dtype=torch.uint8)
        band = zoom._device_band(9, 5, "lanczos3", "cpu")
        assert kernels.zoom_pass(img, band, -1).shape == (2, 4, 5)
        with pytest.raises(ValueError, match="band made for 9"):
            kernels.zoom_pass(img, band, -2)
        with pytest.raises(ValueError, match="dtype"):
            kernels.zoom_pass(img.int(), band, -1)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda():
    """Runs where a card is present (``chip_smoke.py`` does the same at
    the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tcforge_tpu_torch.modules.filters.hqdn3d import precalc_coefs
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    lut = torch.from_numpy(precalc_coefs(4.0)).to(dev)
    x = torch.from_numpy(rng.integers(0, 256, (3, 17, 23),
                                      dtype=np.uint8)).to(dev)
    for axis in (-1, -2):
        torch.testing.assert_close(kernels.spatial_scan(x, lut, axis),
                                   kernels.spatial_scan_ref(x, lut, axis),
                                   rtol=0, atol=0)
    v = kernels.spatial_scan(x, lut, -1)
    ant = x[0].to(torch.int32) << 8
    for got, want in zip(kernels.temporal_scan(v, ant, lut),
                         kernels.temporal_scan_ref(v, ant, lut)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for axis, old, new in ((-1, 23, 11), (-2, 17, 30)):
        band = zoom._device_band(old, new, "lanczos3", str(dev))
        torch.testing.assert_close(kernels.zoom_pass(x, band, axis),
                                   kernels.zoom_pass_ref(x, band, axis),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_slice_kernels_match_plain_versions_on_cuda():
    """unsharp, TomsMoComp and the denoise3d scans at small odd shapes,
    where a card is present (``chip_smoke.py`` runs them at the paths'
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tcforge_tpu_torch.modules.filters.denoise3d import precalc_coefs
    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(0, 256, (4, 37, 150),
                                      dtype=np.uint8)).to(dev)

    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    for sx, sy, am in ((3, 2, 0.8), (8, 7, -1.5), (0, 7, 2.0), (8, 8, 0.5)):
        same(kernels.unsharp_plane(x, sx, sy, am),
             kernels.unsharp_plane_ref(x, sx, sy, am))
    for effort in (0, 5, 15):
        for parity in (0, 1):
            args = (x[1:-1], x[:-2], x[2:], parity, effort)
            same(kernels.tomsmocomp_plane(*args),
                 kernels.tomsmocomp_plane_ref(*args))
    lut = torch.from_numpy(precalc_coefs(4.0)).to(dev)
    for axis in (-1, -2):
        same(kernels.d3_spatial_scan(x, lut, axis),
             kernels.d3_spatial_scan_ref(x, lut, axis))
    v = kernels.d3_spatial_scan(x, lut, -1)
    prev = torch.zeros(x.shape[1:], dtype=torch.int32, device=dev)
    for got, want in zip(kernels.d3_temporal_scan(v, prev, lut),
                         kernels.d3_temporal_scan_ref(v, prev, lut)):
        same(got, want)
