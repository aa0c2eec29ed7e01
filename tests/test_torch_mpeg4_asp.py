"""The port's quarter-sample and interlaced MPEG-4 part 2 decode (Xvid /
DivX Advanced Simple Profile, interlaced captures), on the CPU.

The golden is the JAX CLI's own route on the CPU, as in
``tests/test_torch_mpeg4.py``: its avi importer with
``TCFORGE_NATIVE_MPEG4=1`` decodes through the numpy ``Mpeg4Decoder``.
Held at tolerance 0 against it:

- the plain quarter-sample MC (``mpeg4recon.qpel_blocks``) against the
  numpy ``_mc_block_qpel``: all 16 phases, filter blocks of 8 and 16,
  rounding 0 and 1, windows at every edge of the plane;
- the plain field MC (``mpeg4_recon_field_ref``) against
  ``_field_pred_mb`` over ``_field_pad``: every pair of reference
  fields, odd and even vertical and horizontal vectors, every
  macroblock row, records made by the plan parse's ``_rec_field``;
- the residual's field DCT store against ``_luma_store``;
- the port's plan parse (``io/mpeg4plan.py``): its copies of the
  pinned decoder's methods against their source lines (records added,
  the refusals narrowed, nothing else), and its plans against the
  pinned decoder's on every fixture that decoder's plan form takes;
- every VOP's plain reconstruction of ``il_small.avi``,
  ``qpel_small.avi``, ``qpel.avi`` and ``ildct.avi`` against the numpy
  decoder's planes, each counting the features its fixture exercises;
- whole streams through the port's importer against the JAX importer
  at batches 1, 4 and 16;
- the CLI against the JAX CLI on ``chip_smoke.ASP_GOLDEN`` (the two
  full-width paths, the small files with ``-y raw,raw,avi`` and with
  ``-I 5``, batches that end inside a B run), each output's SHA-256
  pinned in ``chip_smoke.AVI_GOLDEN_SHA256`` for the card;
- a field-predicted P macroblock in a quarter-sample VOL, which the
  numpy decoder refuses: the port refuses it too, both CLIs exit 1.

The fixtures are files (``tests/data/mpeg4/make_streams.py``), pinned in
``tests/test_torch_mpeg4.py``.
"""

from __future__ import annotations

import difflib
import hashlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.io import mpeg4dec as jdec
from tcforge_tpu_torch.io import mpeg4dec as tdec
from tcforge_tpu_torch.io import mpeg4recon
from tcforge_tpu_torch.io.mpeg4plan import (FORM_FIELD, FORM_QPEL8,
                                            FORM_QPEL16, Mpeg4PlanDecoder)
from tcforge_tpu_torch.ops import kernels
from test_torch_mpeg4 import (DATA, assert_same_frames, chunks, jax_cli,
                              jax_frames, port_cli, port_frames,
                              port_importer)

REPO = Path(__file__).resolve().parent.parent
# the new fixtures small enough for the numpy decoder here
SMALL = ["il_small.avi", "qpel_small.avi", "qpel.avi", "ildct.avi"]
# the fixtures the pinned decoder's plan form takes
PINNED = ["small.avi", "odd.avi", "native.avi", "drop.avi", "packed.avi",
          "divx.avi"]


@pytest.fixture
def numpy_route(monkeypatch):
    """The JAX avi importer's numpy MPEG-4 route (the JAX CLI's here)."""
    monkeypatch.setenv("TCFORGE_NATIVE_MPEG4", "1")
    monkeypatch.delenv("TCFORGE_MPEG4_JAX", raising=False)


def parse(name: str, decoder=Mpeg4PlanDecoder):
    """Every plan of a fixture's chunks, and the count of field
    direct-mode macroblocks the parse met."""
    dec = decoder()
    direct = [0]
    if decoder is Mpeg4PlanDecoder:
        orig = dec._b_direct_field

        def spy(*a, **k):
            direct[0] += 1
            return orig(*a, **k)
        dec._b_direct_field = spy
    plans = [p for c in chunks(name) if c for p in dec.parse_plans(bytes(c))]
    return dec, plans, direct[0]


def features(plans, field_direct: int) -> dict:
    """Counts of the macroblocks of each feature in ``plans``."""
    def count(kind, cond):
        return int(sum(cond(p).sum() for p in plans if p["kind"] == kind))
    return {
        "field_dct_I": count("I", lambda p: p["dct_type"] != 0),
        "field_dct_P": count("P", lambda p: p["dct_type"] != 0),
        "field_dct_B": count("B", lambda p: p["dct_type"] != 0),
        "field_P": count("P", lambda p: p["form"] == FORM_FIELD),
        "field_B": count("B", lambda p: p["form"] == FORM_FIELD)
        - field_direct,
        "field_direct": field_direct,
        "qpel_1mv": count("P", lambda p: p["form"] == FORM_QPEL16),
        "qpel_4mv": count("P", lambda p: p["form"] == FORM_QPEL8),
        "qpel_direct": count("B", lambda p: p["form"] == FORM_QPEL8)}


# what each fixture must exercise
EXERCISES = {
    "il_small.avi": ("field_dct_I", "field_dct_P", "field_dct_B", "field_P",
                     "field_B", "field_direct"),
    "divx_il.avi": ("field_dct_I", "field_dct_P", "field_dct_B", "field_P",
                    "field_B", "field_direct"),
    "qpel_small.avi": ("qpel_1mv", "qpel_4mv", "qpel_direct"),
    "divx_qpel.avi": ("qpel_1mv", "qpel_4mv", "qpel_direct"),
    "qpel.avi": ("qpel_1mv",),
    "ildct.avi": (),
}


# ------------------------------------------------------------------ #
# quarter-sample MC

@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("phase", range(16))
def test_qpel_blocks_match_mc_block_qpel(phase, s, rnd):
    """Blocks at the plane's corners, edges and middle, their whole
    vectors from far outside the plane to far past it, against the numpy
    filter over the edge-padded plane."""
    rng = np.random.default_rng(100 * phase + 10 * s + rnd)
    h, w, pad = 48, 64, 48
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref_pad = np.pad(ref, pad, mode="edge")
    cases = [(oy, ox, iy, ix)
             for oy in (0, (h - s) // 2, h - s)
             for ox in (0, (w - s) // 2, w - s)
             for iy, ix in ((0, 0), (-1, 1), (3, -7), (-28, 30),
                            (29, -29), tuple(rng.integers(-20, 21, 2)))]
    oy, ox, iy, ix = (np.array(c) for c in zip(*cases))
    mvx, mvy = 4 * ix + (phase & 3), 4 * iy + (phase >> 2)
    got = mpeg4recon.qpel_blocks(torch.from_numpy(ref), torch.from_numpy(oy),
                                 torch.from_numpy(ox), torch.from_numpy(mvx),
                                 torch.from_numpy(mvy), s, rnd).numpy()
    for i, (y0, x0, _, _) in enumerate(cases):
        want = jdec.Mpeg4Decoder._mc_block_qpel(ref_pad, pad, int(x0),
                                                int(y0), s, int(mvx[i]),
                                                int(mvy[i]), rnd)
        assert np.array_equal(got[i], want), (y0, x0, mvx[i], mvy[i])


# ------------------------------------------------------------------ #
# field MC and the field DCT store

def _field_records(rng, mbw, mbh, sels, vy_odd, vx_odd):
    """A P-VOP's records, every macroblock field-predicted from the
    forward anchor with ``sels`` and random vectors of the given
    parities (the plan parse's ``_rec_field``), and the vectors."""
    dec = Mpeg4PlanDecoder()
    dec._mbw, dec._mbh = mbw, mbh
    plan = dec._plan_new("P")
    vecs = []
    for idx in range(mbw * mbh):
        fmvs = [(2 * int(rng.integers(-12, 13)) + vx_odd,
                 2 * int(rng.integers(-10, 11)) + vy_odd) for _ in range(2)]
        dec._rec_field(idx, 0, fmvs, sels)
        vecs.append(fmvs)
    plan["use_f"][:] = 1
    return torch.from_numpy(mpeg4recon.stage_plan(plan)), vecs


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("vx_odd", [0, 1])
@pytest.mark.parametrize("vy_odd", [0, 1])
@pytest.mark.parametrize("sels", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_field_mc_matches_field_pred_mb(sels, vy_odd, vx_odd, rnd):
    """Every macroblock of a 4x3 grid (the top, middle and bottom rows:
    field reads past the frame's edges take its first or last row)
    against ``_field_pred_mb`` over ``_field_pad``."""
    rng = np.random.default_rng(8 * sels[0] + 4 * sels[1] + 2 * vy_odd
                                + vx_odd + 16 * rnd)
    mbw, mbh, pad = 4, 3, 32
    planes = [rng.integers(0, 256, (16 * mbh // k, 16 * mbw // k),
                           dtype=np.uint8) for k in (1, 2, 2)]
    vop, vecs = _field_records(rng, mbw, mbh, sels, vy_odd, vx_odd)
    got = mpeg4recon.mpeg4_recon_field_ref(
        vop, mbw, rnd, tuple(torch.from_numpy(p) for p in planes), None)
    dec = jdec.Mpeg4Decoder()
    refs_f = dec._field_pad(planes, pad)
    for idx, fmvs in enumerate(vecs):
        y0, x0 = 16 * (idx // mbw), 16 * (idx % mbw)
        want = dec._field_pred_mb(refs_f, pad, x0, y0, fmvs, sels, rnd)
        assert np.array_equal(got[0][y0:y0 + 16, x0:x0 + 16].numpy(),
                              want[0]), idx
        for p in (1, 2):
            assert np.array_equal(got[p][y0 // 2:y0 // 2 + 8,
                                         x0 // 2:x0 // 2 + 8].numpy(),
                                  want[p]), (idx, p)


@pytest.mark.parametrize("seed", range(4))
def test_field_dct_store_matches_luma_store(seed):
    """An I-VOP's plain reconstruction with dct_type at random against
    the numpy IDCT placed by ``_luma_store``."""
    rng = np.random.default_rng(seed)
    mbw, mbh = 3, 2
    nmb = mbw * mbh
    rec = np.zeros((nmb, mpeg4recon.REC), np.int16)
    rec[:, :384] = rng.integers(-300, 300, (nmb, 384))
    rec[:, mpeg4recon.DCT] = rng.permutation(np.arange(nmb) % 2)
    got = mpeg4recon.mpeg4_idct_intra_ref(torch.from_numpy(rec), mbw)
    y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
    for idx in range(nmb):
        out = jdec.idct_put(rec[idx, :384].reshape(6, 8, 8)
                            .astype(np.int64))
        jdec.Mpeg4Decoder._luma_store(y, 16 * (idx % mbw),
                                      16 * (idx // mbw), out[:4],
                                      int(rec[idx, mpeg4recon.DCT]))
    assert np.array_equal(got[0].numpy(), y)


# ------------------------------------------------------------------ #
# the plan parse

_COPIES = [name for name, fn in vars(Mpeg4PlanDecoder).items()
           if callable(fn) and "Copy of" in (inspect.getcomments(fn) or "")]
# the pixel routes a copy must not add to
_PIXEL_ROUTES = ("_mc_", "idct", "np.pad", "_field_pad", "_field_pred_mb",
                 "_luma_store", "_luma_split")


def test_the_plan_parse_copies_six_methods():
    """The six methods of the quarter-sample and interlaced plan form,
    and ``decode_short``, copied for the short-header plans."""
    assert sorted(_COPIES) == ["_b_direct", "_b_direct_field",
                               "_decode_bvop", "_decode_pvop", "_decode_vop",
                               "decode_short", "parse_plans"]


@pytest.mark.parametrize("name", sorted(_COPIES))
def test_plan_copies_keep_their_source_lines(name):
    """Each copied method is the source lines its header names with lines
    added for the records; the only source lines it drops are the plan
    form's refusals it lifts (interlaced, quarter-sample, GMC, short
    header: their conditions, ``raise`` lines and messages, and their
    docstring) and the plan kind's two lines, which an S-VOP's ``P`` plan
    with its rounding replaces, and what it adds calls no pixel route."""
    fn = vars(Mpeg4PlanDecoder)[name]
    m = re.search(r"tcforge_tpu/io/mpeg4dec\.py:(\d+)-(\d+)",
                  inspect.getcomments(fn))
    a, b = int(m.group(1)), int(m.group(2))
    src = (REPO / "tcforge_tpu" / "io" / "mpeg4dec.py").read_text() \
        .splitlines()[a - 1:b]
    ours = inspect.getsource(fn).splitlines()
    assert ours[0] == src[0] and ours[-1] == src[-1]
    ops = difflib.SequenceMatcher(None, src, ours, autojunk=False) \
        .get_opcodes()
    dropped = [ln for tag, i1, i2, _, _ in ops if tag in ("replace", "delete")
               for ln in src[i1:i2]]
    added = [ln for tag, _, _, j1, j2 in ops if tag in ("replace", "insert")
             for ln in ours[j1:j2]]
    assert added
    for ln in dropped:
        assert re.search(r"interlace|quarter|sprite_enable|GMC|numpy|"
                         r"short-header|^\s*raise NotImplementedError\($|"
                         r"_plan_new\(\('I', 'P', 'B'\)\[vop_type\],$|"
                         r"rounding if vop_type == 1 else 0\)$", ln), ln
    for ln in added:
        assert not any(r in ln for r in _PIXEL_ROUTES), ln


@pytest.mark.parametrize("name", PINNED)
def test_plans_equal_the_pinned_decoders(name):
    """A VOL the pinned plan form takes gives the same plans, the new
    records 0."""
    _, want, _ = parse(name, tdec.Mpeg4Decoder)
    _, got, direct = parse(name)
    assert len(got) == len(want) and direct == 0
    for g, w in zip(got, want):
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                assert np.array_equal(g[key], value), key
            else:
                assert g[key] == value, key
        for key in ("dct_type", "form", "fsel", "fmv", "fcmv", "qpel",
                    "interlaced"):
            assert not np.any(g[key]), key
        assert mpeg4recon.route(g) == "mpeg4_recon"


@pytest.mark.parametrize("name,wrapper", [
    ("il_small.avi", "mpeg4_recon_field"), ("ildct.avi", "mpeg4_recon_field"),
    ("qpel_small.avi", "mpeg4_recon_qpel"), ("qpel.avi", "mpeg4_recon_qpel")])
def test_stage_plan_packs_the_new_records(name, wrapper):
    dec, plans, _ = parse(name)
    for p in plans:
        rec = mpeg4recon.stage_plan(p)
        nmb = p["mbw"] * p["mbh"]
        assert rec.shape == (nmb, mpeg4recon.REC)
        assert np.array_equal(rec[:, mpeg4recon.DCT], p["dct_type"])
        assert np.array_equal(rec[:, mpeg4recon.FORM], p["form"])
        assert np.array_equal(rec[:, mpeg4recon.FSEL:mpeg4recon.FLDMV],
                              p["fsel"].reshape(nmb, 4))
        assert np.array_equal(rec[:, mpeg4recon.FLDMV:mpeg4recon.FLDCMV],
                              p["fmv"].reshape(nmb, 8))
        assert np.array_equal(rec[:, mpeg4recon.FLDCMV:mpeg4recon.FLDCMV + 8],
                              p["fcmv"].reshape(nmb, 8))
        assert not rec[:, mpeg4recon.FLDCMV + 8:].any()
        assert mpeg4recon.route(p) == wrapper


@pytest.mark.parametrize("name", ["divx_qpel.avi", "divx_il.avi"])
def test_the_full_width_fixtures_exercise_their_features(name):
    _, plans, direct = parse(name)
    got = features(plans, direct)
    assert all(got[k] > 0 for k in EXERCISES[name]), got
    assert plans[0]["interlaced" if "il" in name else "qpel"] == 1


# ------------------------------------------------------------------ #
# each VOP and whole streams

@pytest.mark.parametrize("name", SMALL)
def test_each_vop_matches_the_numpy_decoder(name):
    """VOP by VOP in decode order through the wrapper ``route`` picks:
    an anchor's whole coded grid against the numpy decoder's reference
    planes, a B-VOP's frame against the frame it displays; the features
    the fixture exercises each occur."""
    ref, mine = jdec.Mpeg4Decoder(), Mpeg4PlanDecoder()
    ra = rb = None
    plans = []
    for c in chunks(name):
        if not c:
            continue
        shown = ref.decode_frames(bytes(c))
        (plan,) = mine.parse_plans(bytes(c))
        plans.append(plan)
        vop = torch.from_numpy(mpeg4recon.stage_plan(plan))
        mbw, kind = plan["mbw"], plan["kind"]
        fn = getattr(mpeg4recon, mpeg4recon.route(plan) + "_ref")
        if kind == "I":
            rec = mpeg4recon.mpeg4_idct_intra_ref(vop, mbw)
        elif kind == "P":
            rec = fn(vop, mbw, plan["rounding"], rb, None)
        else:
            rec = fn(vop, mbw, 0, ra, rb)
        if kind == "B":
            vol = mine.vol
            got = mpeg4recon.crop(rec, vol.width, vol.height)
            assert_same_frames([got], shown[-1:])
        else:
            assert_same_frames([rec], [ref.last])
            ra, rb = rb, rec
    _, _, direct = parse(name)
    got = features(plans, direct)
    assert all(got[k] > 0 for k in EXERCISES[name]), got
    assert mine.vol.interlaced or mine.vol.quarter_sample


_JAX_FRAMES = {}


@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("name", SMALL)
def test_stream_matches_the_jax_importer(name, batch, numpy_route):
    if name not in _JAX_FRAMES:
        _JAX_FRAMES[name] = jax_frames(name)
    assert_same_frames(port_frames(name, batch), _JAX_FRAMES[name])


# ------------------------------------------------------------------ #
# the CLI against the JAX CLI

@pytest.mark.parametrize("case", chip_smoke.ASP_GOLDEN)
def test_asp_golden_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
                                                      numpy_route):
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / key
        d.mkdir()
        assert run(chip_smoke.avi_golden_argv(case, d)) == 0, key
        outs[key] = [f.read_bytes() for f in
                     chip_smoke.avi_golden_outputs(case, d)]
    assert outs["port"] == outs["jax"]
    digests = [hashlib.sha256(b).hexdigest() for b in outs["port"]]
    assert digests == list(chip_smoke.AVI_GOLDEN_SHA256[case])


def test_quarter_sample_field_prediction_is_refused_as_in_jax(tmp_path,
                                                              numpy_route):
    """qpel_il.avi holds a field-predicted P macroblock in a
    quarter-sample VOL: the numpy decoder refuses it by name, so the
    port's importer does.  The JAX CLI lets the error out of ``main``
    (its process exits with status 1), the port's CLI returns 1."""
    imp = port_importer("qpel_il.avi")
    with pytest.raises(NotImplementedError,
                       match="quarter-sample field prediction"):
        imp.read_video_batch(4)
    argv = ["-i", str(DATA / "qpel_il.avi")]
    with pytest.raises(NotImplementedError,
                       match="quarter-sample field prediction"):
        jax_cli([*argv, "-o", str(tmp_path / "j.y4m")])
    assert port_cli([*argv, "-o", str(tmp_path / "p.y4m")]) == 1


# ------------------------------------------------------------------ #
# the wrappers

@pytest.mark.parametrize("wrapper", ["mpeg4_recon_qpel", "mpeg4_recon_field"])
@pytest.mark.parametrize("bad", ["dtype", "rec", "rows", "anchor",
                                 "rounding"])
def test_the_new_wrappers_check_their_input(wrapper, bad):
    vop = torch.zeros((6, mpeg4recon.REC), dtype=torch.int16)
    mbw, fwd, rounding = 3, None, 0
    if bad == "dtype":
        vop = vop.to(torch.int32)
    elif bad == "rec":
        vop = torch.zeros((6, mpeg4recon.REC - 1), dtype=torch.int16)
    elif bad == "rows":
        mbw = 4
    elif bad == "anchor":
        fwd = (torch.zeros((32, 48), dtype=torch.uint8),
               torch.zeros((16, 24), dtype=torch.uint8),
               torch.zeros((8, 24), dtype=torch.uint8))
    else:
        rounding = 2
    with pytest.raises(ValueError):
        getattr(kernels, wrapper)(vop, mbw, rounding, fwd, None)


@pytest.mark.parametrize("wrapper", ["mpeg4_recon", "mpeg4_recon_qpel",
                                     "mpeg4_recon_field"])
def test_each_wrapper_predicts_only_its_forms(wrapper):
    """On records of every form: ``mpeg4_recon`` predicts all half-pel,
    ``mpeg4_recon_qpel`` the quarter-sample forms too and the field form
    half-pel, ``mpeg4_recon_field`` every form as recorded."""
    rng = np.random.default_rng(3)
    mbw, mbh = 4, 3
    nmb = mbw * mbh
    rec = np.zeros((nmb, mpeg4recon.REC), np.int16)
    rec[:, mpeg4recon.USE_F] = 1
    rec[:, mpeg4recon.FMV:mpeg4recon.BMV] = rng.integers(-9, 10, (nmb, 8))
    rec[:, mpeg4recon.FLDMV:mpeg4recon.FLDCMV + 8] = rng.integers(-9, 10,
                                                                  (nmb, 16))
    rec[:, mpeg4recon.FSEL:mpeg4recon.FLDMV] = rng.integers(0, 2, (nmb, 4))
    ref = tuple(torch.from_numpy(rng.integers(0, 256, (mbh * k, mbw * k),
                                              dtype=np.uint8))
                for k in (16, 8, 8))
    forms = {"mpeg4_recon": (0,), "mpeg4_recon_qpel": (0, 1, 2),
             "mpeg4_recon_field": (0, 1, 2, 3)}[wrapper]
    for form in range(4):
        rec[:, mpeg4recon.FORM] = form
        vop = torch.from_numpy(rec.copy())
        got = getattr(kernels, wrapper)(vop, mbw, 1, ref, None)
        rec[:, mpeg4recon.FORM] = form if form in forms else 0
        want = mpeg4recon.mpeg4_recon_field_ref(torch.from_numpy(rec), mbw,
                                                1, ref, None)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), form
