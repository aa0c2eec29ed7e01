"""The port's GMC (S-VOP) MPEG-4 part 2 decode (DivX 5 / Xvid global
motion compensation), on the CPU.

The golden is the JAX CLI's own route on the CPU, as in
``tests/test_torch_mpeg4.py``: its avi importer with
``TCFORGE_NATIVE_MPEG4=1`` decodes through the numpy ``Mpeg4Decoder``.
The streams are written at test time by ``chip_smoke.GmcWriter`` (an
I-VOP from the port's encoder, S-VOPs from the pinned syntax writer with
GMC skips, GMC macroblocks with a residual, 1MV and intra macroblocks;
quarter-sample and interlaced VOLs among them).  Held at tolerance 0
against the numpy decoder:

- the plain warp (``mpeg4_gmc_warp_ref``, and the wrapper on the CPU)
  against ``_gmc_warp_planes`` over 0 to 3 warping points, accuracy 0 to
  3 and rounding 0 and 1, at a display size that is a power of two and
  one that is neither that nor a multiple of 16, trajectories from a few
  samples to far outside the plane;
- every VOP of eight streams (points 0 to 3, accuracy 0 to 3, four
  sizes; a quarter-sample, an interlaced and a quarter-sample interlaced
  one, whose S-VOPs ``route`` sends to ``mpeg4_recon_qpel`` and
  ``mpeg4_recon_field``) reconstructed by the plain versions from the
  numpy decoder's reference, against its planes, and the average GMC
  vectors the parse keeps for the vector predictor against the numpy
  decoder's;
- the GMC form in each of the three reconstruction wrappers, records
  with the form but no warp refused, and ``stage_plan`` of the new
  records;
- whole streams through the port's importer against the JAX importer at
  batches 1, 4 and 16, and one warp and one reconstruction call an
  S-VOP with the numpy decoder's pixel routes patched to raise;
- the ``GMC_GOLDEN`` cases through both CLIs, each output's SHA-256
  pinned in ``chip_smoke.GMC_GOLDEN_SHA256`` for the card;
- more than three warping points refused as the numpy decoder refuses
  them (the sprite refusals are in ``tests/test_torch_mpeg4.py``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.io import mpeg4dec as jdec
from tcforge_tpu_torch.io import mpeg4dec as tdec
from tcforge_tpu_torch.io import mpeg4plan, mpeg4recon
from tcforge_tpu_torch.io.mpeg4plan import (FORM_GMC, FORM_HALF,
                                            FORM_QPEL16, WARP,
                                            Mpeg4PlanDecoder, warp_record)
from tcforge_tpu_torch.ops import kernels
from test_torch_mpeg4 import (assert_same_frames, jax_cli, port_cli,
                              port_frames)

# the streams: (width, height, groups, gop, seed, points a group,
# accuracy[, quarter-sample, interlaced]); qpel and il are the GMC_GOLDEN
# cases gmc_qpel and gmc_il
STREAMS = {
    "acc3": (176, 144, 2, 5, 7, (1, 2), 3),
    "acc2": (176, 144, 2, 5, 8, (3, 0), 2),
    "acc1": (200, 136, 1, 8, 9, (3,), 1),
    "acc0": (160, 112, 1, 8, 10, (2,), 0),
    "odd": (100, 70, 1, 8, 11, (1,), 3),
    "qpel": (176, 144, 2, 5, 21, (2, 3), 3, True, False),
    "il": (176, 144, 2, 5, 22, (1, 3), 2, False, True),
    "qpel_il": (160, 112, 1, 6, 23, (3,), 1, True, True),
}
FILES = ("acc3", "acc2", "odd", "qpel", "il")


def flags(name: str):
    """A stream's (quarter-sample, interlaced)."""
    return tuple(bool(f) for f in (STREAMS[name][7:] or (False, False)))
VOPS = [(name, k) for name, (_w, _h, g, gop, *_r) in STREAMS.items()
        for k in range(g * gop)]


@pytest.fixture
def numpy_route(monkeypatch):
    """The JAX avi importer's numpy MPEG-4 route (the JAX CLI's here)."""
    monkeypatch.setenv("TCFORGE_NATIVE_MPEG4", "1")
    monkeypatch.delenv("TCFORGE_MPEG4_JAX", raising=False)


_CHUNKS = {}


def stream_chunks(name: str) -> list:
    if name not in _CHUNKS:
        _CHUNKS[name] = chip_smoke.gmc_chunks(*STREAMS[name])
    return _CHUNKS[name]


_DECODED = {}


def decoded(name: str):
    """Per chunk of a stream: the numpy decoder's coded planes before and
    after it and its vector grid after it, and the port's plan."""
    if name not in _DECODED:
        ref, mine = jdec.Mpeg4Decoder(), Mpeg4PlanDecoder()
        out = []
        for c in stream_chunks(name):
            before = ref.last
            ref.decode_frames(c)
            (plan,) = mine.parse_plans(c)
            out.append((before, ref.last, ref._co_mvs, mine._co_mvs, plan))
        _DECODED[name] = out
    return _DECODED[name]


def _t(planes):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)


def _gmc_vol(w: int, h: int, points: int, acc: int):
    dec = jdec.Mpeg4Decoder()
    vol = jdec._VOL()
    vol.width, vol.height = w, h
    vol.sprite_enable, vol.sprite_points, vol.sprite_accuracy = 2, points, acc
    dec.vol = vol
    return dec


# ------------------------------------------------------------------ #
# the warp

@pytest.mark.parametrize("size", [(128, 96), (100, 70)])
@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("acc", range(4))
@pytest.mark.parametrize("points", range(4))
def test_gmc_warp_ref_matches_gmc_warp_planes(points, acc, rnd, size):
    """``_gmc_setup``'s warps of a random reference (alpha and beta from
    the display size, the samples from the coded planes), from small
    trajectories to ones far outside the plane, against the numpy warp;
    the wrapper's plain route too."""
    w, h = size
    cw, ch = -(-w // 16) * 16, -(-h // 16) * 16
    rng = np.random.default_rng(1000 * points + 100 * acc + 10 * rnd + w)
    planes = [rng.integers(0, 256, (ch // k, cw // k), dtype=np.uint8)
              for k in (1, 2, 2)]
    dec = _gmc_vol(w, h, points, acc)
    for reach in (3, 40, 2500):
        traj = [tuple(int(v) for v in rng.integers(-reach, reach + 1, 2))
                for _ in range(points)]
        P = dec._gmc_setup(traj)
        want = dec._gmc_warp_planes(planes, P, rnd)
        rec = warp_record(P, rnd)
        assert rec.shape == (WARP,) and rec.dtype == np.int64
        got = mpeg4recon.mpeg4_gmc_warp_ref(_t(planes), rec)
        via = kernels.mpeg4_gmc_warp(_t(planes), rec.tolist())
        for p in range(3):
            assert np.array_equal(got[p].numpy(), want[p]), (reach, p)
            assert torch.equal(via[p], got[p])


def test_warp_record_holds_the_setup():
    dec = _gmc_vol(176, 144, 1, 3)
    P = dec._gmc_setup([(5, -3)])
    rec = warp_record(P, 1)
    assert (rec[mpeg4plan.W_S], rec[mpeg4plan.W_N], rec[mpeg4plan.W_RND],
            rec[mpeg4plan.W_TX], rec[mpeg4plan.W_TY]) == (16, 1, 1, 5, -3)
    dec = _gmc_vol(176, 144, 3, 2)
    P = dec._gmc_setup([(2, 1), (6, -2), (-3, 5)])
    rec = warp_record(P, 0)
    assert rec[mpeg4plan.W_DXX:mpeg4plan.W_DYY + 1].tolist() == [
        v for row in P["D"] for v in row]
    assert rec[mpeg4plan.W_SH:mpeg4plan.W_OCY + 1].tolist() == [
        P["sh"], P["ox"], P["oy"], P["ocx"], P["ocy"]]


@pytest.mark.parametrize("bad", ["S", "points", "rounding", "length",
                                 "shift", "planes", "chroma", "dtype"])
def test_the_warp_wrapper_checks_its_input(bad):
    planes = [torch.zeros((32, 48), dtype=torch.uint8),
              torch.zeros((16, 24), dtype=torch.uint8),
              torch.zeros((16, 24), dtype=torch.uint8)]
    rec = warp_record(_gmc_vol(48, 32, 2, 3)._gmc_setup([(1, 1), (2, 2)]), 0)
    if bad == "S":
        rec[mpeg4plan.W_S] = 3
    elif bad == "points":
        rec[mpeg4plan.W_N] = 4
    elif bad == "rounding":
        rec[mpeg4plan.W_RND] = 2
    elif bad == "length":
        rec = rec[:-1]
    elif bad == "shift":
        rec[mpeg4plan.W_SH] = 0
    elif bad == "planes":
        planes = [p[:, :40].contiguous() for p in planes]
    elif bad == "chroma":
        planes[2] = torch.zeros((16, 20), dtype=torch.uint8)
    else:
        planes[0] = planes[0].to(torch.int16)
    with pytest.raises(ValueError):
        kernels.mpeg4_gmc_warp(planes, rec)


def test_the_plan_parse_warps_with_numpy_outside_plan_mode():
    """``_gmc_warp_planes`` records the warp only in plan mode; the
    parse's pixel route stays the numpy warp."""
    dec = Mpeg4PlanDecoder()
    dec.vol = _gmc_vol(64, 48, 2, 3).vol
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, (48 // k, 64 // k), dtype=np.uint8)
              for k in (1, 2, 2)]
    P = dec._gmc_setup([(3, -4), (2, 5)])
    want = jdec.Mpeg4Decoder._gmc_warp_planes(dec, planes, P, 1)
    got = dec._gmc_warp_planes(planes, P, 1)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------------ #
# each VOP

@pytest.mark.parametrize("name,k", VOPS)
def test_each_vop_matches_the_numpy_decoder(name, k):
    """VOP ``k`` of a stream in decode order, reconstructed by the plain
    version ``route`` picks (an S-VOP: the warp, then the GMC form) from
    the numpy decoder's reference, against the numpy decoder's coded
    planes; after an S-VOP, the parse's vector grid (GMC macroblocks'
    average vectors, 1MV vectors) equals the numpy decoder's, and
    ``route`` picks the VOL's instance."""
    before, after, ref_mvs, my_mvs, plan = decoded(name)[k]
    quarter, interlaced = flags(name)
    assert mpeg4recon.route(plan) == (
        "mpeg4_recon_field" if interlaced else
        "mpeg4_recon_qpel" if quarter else "mpeg4_recon")
    vop = torch.from_numpy(mpeg4recon.stage_plan(plan))
    if plan["kind"] == "I":
        got = mpeg4recon.mpeg4_idct_intra_ref(vop, plan["mbw"])
    else:
        assert plan["kind"] == "P" and plan["warp"] is not None
        got = mpeg4recon.reconstruct(vop, "P", plan["rounding"],
                                     plan["mbw"], _t(before), None,
                                     mpeg4recon.route(plan), plan["warp"])
        assert my_mvs == ref_mvs
        assert (plan["form"] == FORM_GMC).any()
        assert set(np.unique(plan["form"]).tolist()) <= {
            FORM_QPEL16 if quarter else FORM_HALF, FORM_HALF, FORM_GMC}
    assert_same_frames([got], [after])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_each_stream_has_every_macroblock_kind(name):
    """Each stream's S-VOPs hold GMC skips, coded GMC macroblocks, 1MV
    (quarter-sample in a quarter-sample VOL) and intra macroblocks, an
    interlaced stream's coded ones both dct_types; the S-VOPs' rounding
    moves."""
    quarter, interlaced = flags(name)
    plans = [d[4] for d in decoded(name)]
    s = [p for p in plans if p["warp"] is not None]
    form = np.concatenate([p["form"] for p in s])
    coded = np.concatenate([p["blocks"].reshape(len(p["form"]), -1).any(1)
                            for p in s])
    intra = np.concatenate([p["intra"] for p in s]) != 0
    dct = np.concatenate([p["dct_type"] for p in s])
    assert ((form == FORM_GMC) & ~coded).any()
    assert ((form == FORM_GMC) & coded).any()
    one_mv = FORM_QPEL16 if quarter else FORM_HALF
    assert ((form == one_mv) & ~intra).any() and intra.any()
    assert set(dct[coded].tolist()) == ({0, 1} if interlaced else {0})
    assert {int(p["rounding"]) for p in s} == {0, 1}
    assert {int(p["warp"][mpeg4plan.W_N]) for p in s} \
        == set(STREAMS[name][5])
    assert {int(p["warp"][mpeg4plan.W_S]) for p in s} \
        == {2 << STREAMS[name][6]}


@pytest.mark.parametrize("wrapper", ["mpeg4_recon", "mpeg4_recon_qpel",
                                     "mpeg4_recon_field"])
@pytest.mark.parametrize("name", ["acc3", "odd"])
def test_each_template_instance_takes_the_gmc_form(name, wrapper):
    """Every S-VOP through each reconstruction wrapper (their plain
    routes) equals the numpy decoder's planes: the quarter-sample and
    interlaced instances take the GMC form too."""
    for before, after, _r, _m, plan in decoded(name):
        if plan["warp"] is None:
            continue
        vop = torch.from_numpy(mpeg4recon.stage_plan(plan))
        got = getattr(kernels, wrapper)(vop, plan["mbw"], plan["rounding"],
                                        _t(before), None, warp=plan["warp"])
        assert_same_frames([got], [after])


def test_stage_plan_packs_the_gmc_form():
    for _b, _a, _r, _m, plan in decoded("acc3"):
        rec = mpeg4recon.stage_plan(plan)
        assert np.array_equal(rec[:, mpeg4recon.FORM], plan["form"])
        assert np.array_equal(rec[:, mpeg4recon.USE_F] != 0,
                              (plan["use_f"] != 0))
        if plan["warp"] is not None:
            gmc = plan["form"] == FORM_GMC
            assert gmc.any() and (rec[gmc, mpeg4recon.USE_F] == 1).all()
        assert mpeg4recon.route(plan) == "mpeg4_recon"


@pytest.mark.parametrize("wrapper", ["mpeg4_recon", "mpeg4_recon_qpel",
                                     "mpeg4_recon_field"])
def test_gmc_records_without_their_warp_are_refused(wrapper):
    """An S-VOP's records given without its warp record raise (the
    kernel traps), and a warp without a forward anchor too: no
    ``FORM_GMC`` macroblock is predicted from anything but its warp."""
    before, _a, _r, _m, plan = decoded("acc3")[1]
    vop = torch.from_numpy(mpeg4recon.stage_plan(plan))
    with pytest.raises(ValueError, match="FORM_GMC"):
        getattr(kernels, wrapper)(vop, plan["mbw"], plan["rounding"],
                                  _t(before), None)
    with pytest.raises(ValueError, match="forward anchor"):
        getattr(kernels, wrapper)(vop, plan["mbw"], plan["rounding"], None,
                                  _t(before), warp=plan["warp"])


# ------------------------------------------------------------------ #
# whole streams

@pytest.fixture(scope="module")
def gmc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmc")
    out = {}
    for name in FILES:
        out[name] = chip_smoke.write_gmc_avi(d / f"{name}.avi",
                                             *STREAMS[name])
    return out


_JAX_FRAMES = {}


@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("name", FILES)
def test_stream_matches_the_jax_importer(name, batch, gmc_files,
                                         numpy_route, monkeypatch):
    import test_torch_mpeg4
    monkeypatch.setattr(test_torch_mpeg4, "DATA", gmc_files[name].parent)
    if name not in _JAX_FRAMES:
        _JAX_FRAMES[name] = test_torch_mpeg4.jax_frames(gmc_files[name].name)
    got = port_frames(gmc_files[name].name, batch)
    _w, _h, groups, gop, *_r = STREAMS[name]
    assert len(got) == groups * gop
    assert_same_frames(got, _JAX_FRAMES[name])


def test_one_warp_and_one_reconstruction_an_s_vop(gmc_files, monkeypatch,
                                                  tmp_path):
    """The CLI path calls ``mpeg4_gmc_warp`` and ``mpeg4_recon`` once an
    S-VOP, ``mpeg4_idct_intra`` once an I-VOP, and never a pixel route of
    the numpy decoder (its warp among them)."""
    from test_torch_engine import run_cli
    calls = dict.fromkeys(("mpeg4_gmc_warp", "mpeg4_recon",
                           "mpeg4_idct_intra"), 0)
    for name in calls:
        orig = getattr(kernels, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kernels, name, spy)

    def refuse(*a, **k):
        raise AssertionError("a numpy pixel route ran")
    for route in ("_mc_block", "_mc_rect", "_gmc_warp_planes", "_gmc_bilin",
                  "decode_frames", "flush"):
        monkeypatch.setattr(tdec.Mpeg4Decoder, route, refuse)
    monkeypatch.setattr(tdec, "idct_add_sel", refuse)
    monkeypatch.setattr(tdec, "idct_put", refuse)
    assert run_cli(["-i", str(gmc_files["acc3"]), "-o",
                    str(tmp_path / "o.y4m"), "--device", "cpu", "-q",
                    "--progress_off", "--batch", "3"]) == 0
    _w, _h, groups, gop, *_r = STREAMS["acc3"]
    assert calls == {"mpeg4_gmc_warp": groups * (gop - 1),
                     "mpeg4_recon": groups * (gop - 1),
                     "mpeg4_idct_intra": groups}


# ------------------------------------------------------------------ #
# the CLI against the JAX CLI

@pytest.mark.parametrize("case", [c for c in chip_smoke.GMC_GOLDEN
                                  if isinstance(chip_smoke.GMC_GOLDEN[c][0],
                                                tuple)])
def test_gmc_golden_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
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
# refusals

def test_more_than_three_points_are_refused_as_in_jax():
    gw = chip_smoke.GmcWriter(64, 48, seed=2)
    data = gw.headers(4)
    for dec in (jdec.Mpeg4Decoder(), Mpeg4PlanDecoder()):
        with pytest.raises(ValueError, match="GMC warping points > 3"):
            (dec.decode_frames if isinstance(dec, jdec.Mpeg4Decoder)
             else dec.parse_plans)(data)


# ------------------------------------------------------------------ #
# on the card

@pytest.mark.cuda
def test_gmc_kernels_match_their_plain_versions_on_cuda():
    """The warp and the GMC form of each reconstruction kernel against
    their plain versions on the card, on every S-VOP of a stream
    (``chip_smoke.py`` phase 3 does it on divx_gmc, the small streams and
    random warps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for before, _a, _r, _m, plan in decoded("acc3"):
        if plan["warp"] is None:
            continue
        ref = tuple(p.to(dev) for p in _t(before))
        gmc = kernels.mpeg4_gmc_warp(ref, plan["warp"])
        want = kernels.mpeg4_gmc_warp_ref(ref, plan["warp"])
        assert all(torch.equal(g, w) for g, w in zip(gmc, want))
        vop = torch.from_numpy(mpeg4recon.stage_plan(plan)).to(dev)
        for wrapper in ("mpeg4_recon", "mpeg4_recon_qpel",
                        "mpeg4_recon_field"):
            args = (vop, plan["mbw"], plan["rounding"], ref, None)
            got = getattr(kernels, wrapper)(*args, warp=plan["warp"])
            want = getattr(kernels, wrapper + "_ref")(*args,
                                                      warp=plan["warp"])
            assert all(torch.equal(g, w) for g, w in zip(got, want))
