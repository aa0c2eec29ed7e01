"""The port's short-header (H.263) MPEG-4 decode, on the CPU.

The golden is the JAX CLI's own route on the CPU: under an MPEG-4
fourcc its avi importer with ``TCFORGE_NATIVE_MPEG4=1`` decodes a short
video header picture through the numpy ``Mpeg4Decoder.decode_short``
(``decode_frames``).  Held at tolerance 0 against it, on the fixtures of
``tests/data/h263`` (libavcodec's h263 at CIF, QCIF with drop-frame
chunks and sub-QCIF with GOB headers; ``make_streams.py``):

- every picture reconstructed by the plain versions from the plan parse
  (``io/mpeg4plan.py``'s copy of ``decode_short``: an I picture an intra
  plan of the H.263-dequantized blocks, a P picture 1MV records) from
  the numpy decoder's reference, against the numpy decoder's planes;
- each plan's blocks, vectors and masks against what the numpy decoder
  dequantizes and predicts, macroblock by macroblock;
- whole streams through the port's importer against the JAX importer at
  batches 1, 5 and 16: the same frames in the same order, each picture
  shown at once, no last frame held back or repeated;
- the H.263 cases of ``chip_smoke.GMC_GOLDEN`` through both CLIs, their
  SHA-256 pinned for the card;
- an extended PTYPE and a P picture first refused as the numpy decoder
  refuses them, a new source format starting a new VOL.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.io import mpeg4dec as jdec
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import mpeg4dec as tdec
from tcforge_tpu_torch.io import mpeg4plan, mpeg4recon
from tcforge_tpu_torch.io.avi import AviReader
from tcforge_tpu_torch.io.mpeg4plan import FORM_HALF, Mpeg4PlanDecoder
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels
from test_torch_mpeg4 import (_avi, assert_same_frames, jax_cli, port_cli,
                              port_frames)

DATA = chip_smoke.H263_DATA
FIXTURES = {
    "gob.avi":
        "7f80338eb81a53b9c0c174bf7f258b0c1f53714a67c89d28c3f187bbbb04fe31",
    "h263.avi":
        "80b5f038cef501d131237a600bbaeda9b012002e04c3e9b307ac9dd41775faa3",
    "qcif.avi":
        "506a36159e634b01a665bc4333a8cc8ec5248f86690d2c11ca87ed471ef8afaa",
}
# the pictures of each fixture (its chunks but the drop-frame ones)
COUNTS = {"h263.avi": 48, "qcif.avi": 12, "gob.avi": 8}
PICTURES = [(name, k) for name, n in COUNTS.items() for k in range(n)]
GOLDEN = [c for c, (src, *_r) in chip_smoke.GMC_GOLDEN.items()
          if isinstance(src, str)]


@pytest.fixture
def numpy_route(monkeypatch):
    """The JAX avi importer's numpy MPEG-4 route (the JAX CLI's here)."""
    monkeypatch.setenv("TCFORGE_NATIVE_MPEG4", "1")
    monkeypatch.delenv("TCFORGE_MPEG4_JAX", raising=False)


def chunks(name: str) -> list:
    with AviReader(str(DATA / name)) as r:
        return [bytes(r.read_video_frame(i)[0])
                for i in range(r.video_frames)]


_DECODED = {}


def decoded(name: str):
    """Per picture: the numpy decoder's coded planes before and after it,
    the frame ``decode_frames`` returned, and the port's plan."""
    if name not in _DECODED:
        ref, mine = jdec.Mpeg4Decoder(), Mpeg4PlanDecoder()
        out = []
        for c in chunks(name):
            if not c:
                continue
            before = ref.last
            (shown,) = ref.decode_frames(c)
            (plan,) = mine.parse_plans(c)
            out.append((before, ref.last, shown, plan))
        _DECODED[name] = out
    return _DECODED[name]


def _t(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)


# ------------------------------------------------------------------ #
# the fixtures

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_pinned(name):
    digest = hashlib.sha256((DATA / name).read_bytes()).hexdigest()
    assert digest == FIXTURES[name]


def test_fixture_directory_stays_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 150_000


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_fixtures_exercise_the_short_header(name):
    """Intra and P pictures, COD skips, intra macroblocks in P pictures,
    vectors; GOB headers in gob.avi; drop-frame chunks in qcif.avi."""
    plans = [d[3] for d in decoded(name)]
    assert len(plans) == COUNTS[name]
    assert all(p["short"] == 1 and p["rounding"] == 0 for p in plans)
    P = [p for p in plans if p["kind"] == "P"]
    assert [p["kind"] for p in plans].count("I") >= 2 and P
    skip = sum(int(((p["use_f"] != 0) & ~p["mvs4"].any((1, 2))
                    & ~p["blocks"].any((1, 2, 3))).sum()) for p in P)
    assert skip and sum(int(p["intra"].sum()) for p in P)
    assert sum(int(p["mvs4"].any((1, 2)).sum()) for p in P)
    if name == "qcif.avi":
        assert chunks(name).count(b"") == 2
    if name == "gob.avi":
        dec, gobs = Mpeg4PlanDecoder(), [0]
        orig = dec._sh_gob_header

        def spy(b, q):
            pos = b.pos
            got = orig(b, q)
            gobs[0] += b.pos != pos
            return got
        dec._sh_gob_header = spy
        for c in chunks(name):
            dec.parse_plans(c)
        assert gobs[0] > 0


# ------------------------------------------------------------------ #
# each picture

@pytest.mark.parametrize("name,k", PICTURES)
def test_each_picture_matches_decode_short(name, k):
    """Picture ``k`` reconstructed by the plain version from its plan and
    the numpy decoder's reference against the numpy decoder's planes and
    the frame it returned."""
    before, after, shown, plan = decoded(name)[k]
    vop = torch.from_numpy(mpeg4recon.stage_plan(plan))
    fwd = _t(before) if plan["kind"] == "P" else None
    got = mpeg4recon.reconstruct(vop, plan["kind"], plan["rounding"],
                                 plan["mbw"], fwd, None,
                                 mpeg4recon.route(plan))
    assert_same_frames([got], [after])
    assert_same_frames([got], [shown])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_plans_hold_the_numpy_decoders_blocks_and_vectors(name,
                                                          monkeypatch):
    """Macroblock by macroblock, the plan's blocks equal what the numpy
    decoder inverse-transforms (``idct_put`` of an intra macroblock,
    ``idct_add_sel`` of an inter one), its vectors the luma vector the
    numpy decoder predicts with and the chroma vector ``(m >> 1) |
    (m & 1)``; a COD skip is a zero vector without residual."""
    seen = {}
    last = {}

    def keep(fn, key):
        def call(blocks, *a):
            last["blocks"], last["intra"] = np.array(blocks), key
            return fn(blocks, *a)
        return call
    monkeypatch.setattr(jdec, "idct_put", keep(jdec.idct_put, 1))
    monkeypatch.setattr(jdec, "idct_add_sel", keep(jdec.idct_add_sel, 0))
    orig_mc, orig_store = jdec.Mpeg4Decoder._mc_block, \
        jdec.Mpeg4Decoder._luma_store

    def mc(refp, pad, x0, y0, size, mx, my, rnd):
        if size == 16:
            last["mv"] = (mx, my)
        return orig_mc(refp, pad, x0, y0, size, mx, my, rnd)

    def store(y, x0, y0, out, dct):
        seen[(y0 // 16, x0 // 16)] = (last["blocks"], last["intra"],
                                      last.pop("mv", None))
        return orig_store(y, x0, y0, out, dct)
    monkeypatch.setattr(jdec.Mpeg4Decoder, "_mc_block", staticmethod(mc))
    monkeypatch.setattr(jdec.Mpeg4Decoder, "_luma_store",
                        staticmethod(store))
    ref, mine = jdec.Mpeg4Decoder(), Mpeg4PlanDecoder()
    for c in chunks(name):
        if not c:
            continue
        seen.clear()
        ref.decode_frames(c)
        (plan,) = mine.parse_plans(c)
        for idx in range(plan["mbw"] * plan["mbh"]):
            key = (idx // plan["mbw"], idx % plan["mbw"])
            if key not in seen:              # a COD skip
                assert plan["kind"] == "P" and plan["use_f"][idx] == 1
                assert not plan["mvs4"][idx].any()
                assert not plan["blocks"][idx].any()
                continue
            blocks, intra, mv = seen[key]
            assert np.array_equal(plan["blocks"][idx], blocks)
            assert plan["intra"][idx] == intra
            assert plan["use_f"][idx] == (1 - intra)
            if not intra:
                assert plan["mvs4"][idx].tolist() == [list(mv)] * 4
                assert plan["cmv"][idx].tolist() == [
                    (m >> 1) | (m & 1) for m in mv]
        assert not plan["form"].any() and not plan["dct_type"].any()


def test_stage_plan_packs_short_header_records():
    for _b, _a, _s, plan in decoded("qcif.avi"):
        rec = mpeg4recon.stage_plan(plan)
        nmb = plan["mbw"] * plan["mbh"]
        assert rec.shape == (nmb, mpeg4recon.REC)
        assert np.array_equal(rec[:, :384].reshape(nmb, 6, 8, 8),
                              plan["blocks"])
        assert np.array_equal(rec[:, mpeg4recon.FMV:mpeg4recon.BMV]
                              .reshape(nmb, 4, 2), plan["mvs4"])
        assert (rec[:, mpeg4recon.FORM] == FORM_HALF).all()
        assert mpeg4recon.route(plan) == "mpeg4_recon"


def test_no_host_pixels_in_the_short_header_plans(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a numpy pixel route ran")
    monkeypatch.setattr(mpeg4plan, "idct_put", refuse)
    monkeypatch.setattr(mpeg4plan, "idct_add_sel", refuse)
    monkeypatch.setattr(tdec.Mpeg4Decoder, "_mc_block", refuse)
    monkeypatch.setattr(tdec.Mpeg4Decoder, "_luma_store", refuse)
    for name in ("qcif.avi", "gob.avi"):
        dec = Mpeg4PlanDecoder()
        plans = [p for c in chunks(name) if c for p in dec.parse_plans(c)]
        assert len(plans) == COUNTS[name]


# ------------------------------------------------------------------ #
# display order and whole streams

def test_anchors_show_a_short_header_picture_at_once():
    """A short-header picture displays itself, and ``flush`` adds nothing
    after it; an MPEG-4 anchor pending before it stays pending, as
    ``decode_short`` leaves the numpy decoder's ``_pending``."""
    a = mpeg4recon.Anchors()
    assert a.add("I", 1, True) == (None, None, 1)
    assert a.add("P", 2, True) == (1, None, 2)
    assert a.flush() is None
    b = mpeg4recon.Anchors()
    assert b.add("I", 1) == (None, None, None)
    assert b.add("I", 2, True) == (None, None, 2)
    assert b.add("P", 3, True) == (2, None, 3)
    assert b.flush() == 1 and b.flush() is None


_JAX_FRAMES = {}


@pytest.mark.parametrize("batch", [1, 5, 16])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_stream_matches_the_jax_importer(name, batch, numpy_route,
                                         monkeypatch):
    """Every frame, in order: a picture at once, a drop-frame chunk the
    last picture again, nothing held back for the end."""
    import test_torch_mpeg4
    monkeypatch.setattr(test_torch_mpeg4, "DATA", DATA)
    if name not in _JAX_FRAMES:
        _JAX_FRAMES[name] = test_torch_mpeg4.jax_frames(name)
    got = port_frames(name, batch)
    assert len(got) == len(chunks(name))
    assert_same_frames(got, _JAX_FRAMES[name])


def test_a_batch_is_decided_without_reading_ahead():
    """A short-header batch of n frames parses n chunks: no reorder lag
    makes it read the next one."""
    import tcforge_tpu_torch.modules  # noqa: F401
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(DATA / "gob.avi"))
    imp.start(torch.device("cpu"))
    plan = imp.plan_batch(3)
    assert len(plan.frames) == 3 and imp._pos == 3
    imp.release(plan)
    imp.close()


# ------------------------------------------------------------------ #
# the CLI against the JAX CLI

@pytest.mark.parametrize("case", GOLDEN)
def test_h263_golden_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
                                                       numpy_route):
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / key
        d.mkdir()
        assert run(chip_smoke.gmc_golden_argv(case, d)) == 0, key
        outs[key] = [f.read_bytes() for f in
                     chip_smoke.gmc_golden_outputs(case, d)]
    assert outs["port"] == outs["jax"]
    digests = [hashlib.sha256(b).hexdigest() for b in outs["port"]]
    assert digests == list(chip_smoke.GMC_GOLDEN_SHA256[case])


# ------------------------------------------------------------------ #
# refusals and format changes

def _with_format(pic: bytes, fmt: int) -> bytes:
    """``pic`` with its PTYPE source format (bits 35-37) set to ``fmt``."""
    bits = int.from_bytes(pic[:8], "big")
    bits = (bits & ~(7 << (64 - 38))) | (fmt << (64 - 38))
    return bits.to_bytes(8, "big") + pic[8:]


def test_an_extended_ptype_is_refused_as_in_jax(tmp_path, numpy_route):
    """Source format 7 (an extended PTYPE): the numpy decoder's refusal,
    in its words, from the port's importer and both CLIs."""
    pic = _with_format(chunks("qcif.avi")[0], 7)
    src = _avi(tmp_path / "x.avi", "XVID", [pic])
    match = r"h263: source format 7 \(extended PTYPE\) is not supported"
    with pytest.raises(NotImplementedError, match=match):
        jdec.Mpeg4Decoder().decode_frames(pic)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(src))
    imp.start(torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=match):
        imp.read_video_batch(4)
    with pytest.raises(NotImplementedError, match=match):
        jax_cli(["-i", str(src), "-o", str(tmp_path / "j.y4m")])
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "p.y4m")]) == 1


def test_a_p_picture_first_fails_as_in_jax(tmp_path):
    c = [x for x in chunks("qcif.avi") if x]
    for dec in (jdec.Mpeg4Decoder().decode_frames,
                Mpeg4PlanDecoder().parse_plans):
        with pytest.raises(ValueError, match="h263: P picture before I"):
            dec(c[1])
    src = _avi(tmp_path / "p.avi", "XVID", c[1:3])
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "p.y4m")]) == 1


def test_a_new_source_format_starts_a_new_vol():
    """QCIF pictures then sub-QCIF ones through one decoder: the second
    format's I picture starts its own VOL, plans and planes of its size."""
    seq = [x for x in chunks("qcif.avi") if x][:3] \
        + [x for x in chunks("gob.avi") if x][:3]
    ref, mine = jdec.Mpeg4Decoder(), Mpeg4PlanDecoder()
    plans, want = [], []
    for c in seq:
        want += ref.decode_frames(c)
        plans += mine.parse_plans(c)
    assert [(p["mbw"], p["mbh"]) for p in plans] == [(11, 9)] * 3 \
        + [(8, 6)] * 3
    fwd = None
    for p, w in zip(plans, want):
        vop = torch.from_numpy(mpeg4recon.stage_plan(p))
        fwd = mpeg4recon.reconstruct(vop, p["kind"], 0, p["mbw"], fwd, None,
                                     mpeg4recon.route(p))
        assert_same_frames([fwd], [w])


# ------------------------------------------------------------------ #
# on the card

@pytest.mark.cuda
def test_h263_pictures_match_their_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for before, _a, _s, plan in decoded("gob.avi"):
        vop = torch.from_numpy(mpeg4recon.stage_plan(plan)).to(dev)
        if plan["kind"] == "I":
            got = kernels.mpeg4_idct_intra(vop, plan["mbw"])
            want = kernels.mpeg4_idct_intra_ref(vop, plan["mbw"])
        else:
            args = (vop, plan["mbw"], 0,
                    tuple(p.to(dev) for p in _t(before)), None)
            got, want = kernels.mpeg4_recon(*args), \
                kernels.mpeg4_recon_ref(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
