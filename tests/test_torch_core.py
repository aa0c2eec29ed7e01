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
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.modules import registry as tregistry
from tcforge_tpu_torch.modules.filters.hqdn3d import Hqdn3dFilter
from tcforge_tpu_torch.ops import kernels, zoom

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tcforge_tpu_torch"

COPIES = ["core/formats.py", "core/optstr.py", "core/codecs.py",
          "core/framecode.py", "core/job.py", "core/ratiocodes.py",
          "io/y4m.py"]


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
    want = re.sub(r"^from tcforge_tpu\.", "from tcforge_tpu_torch.", src,
                  flags=re.M)
    assert "".join(ours[1:]) == want


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


def test_registry_lookup():
    job = tjob.Job()
    mod = tregistry.new_module(tregistry.ModuleKind.FILTER, "hqdn3d", job,
                               "luma=4.0")
    assert isinstance(mod, Hqdn3dFilter)
    with pytest.raises(KeyError, match="nosuch"):
        tregistry.lookup(tregistry.ModuleKind.FILTER, "nosuch")


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
