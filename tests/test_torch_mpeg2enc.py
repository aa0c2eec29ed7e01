"""The port's MPEG-2 encoder (``io/mpeg2enc.py``, the three encoder
kernels' plain versions, ``io/m2e.py``) against the JAX package's, on the
CPU.

Under ``JAX_PLATFORMS=cpu`` the JAX encoder sends its block math through
its native library (``native/tcforge_host.cpp``), so that C++ is the
golden: every plain version is held to its native counterpart at
tolerance 0, on the same seeded numpy inputs: the motion search
(``me16_refine``) at ranges 1, 4, 5, 8 and 16 on smooth, noisy, shifted
and flat content, the half-pel prediction (``mc_pred_half``), the fused B
prediction (``b_mc_sel_pred``), ``b_select_pred``, ``bisad``, ``mb_act``,
and the block coder in its three modes (``enc_intra_plane``,
``enc_inter_plane`` with ``enc_intra_sel`` recoding a P picture's intra
macroblocks, ``enc_inter_levels``) at qs 1, 8 and 31 with and without the
alternate scan and MPEG-1, and on blocks whose coefficients land within
1e-6 of a rounding boundary at qs 1, 2, 8 and 31.  Then the whole
encoder: ``Mpeg2FullEncoder``'s bytes against the JAX class's (GOP 15/3
with rate control, 12/1 at constant q, field pictures in both orders,
MPEG-1, D-pictures, alternate scan, pulldown, the quantiser's bounds,
flushes with B pictures waiting, one and two frames), the syntax writer
against the native one, the pinned framegen importer against the JAX
module, and the wrappers' input checks.  The intra-only encoder
(``Mpeg2IntraEncoder``: the block coder under the pinned writer) is held
to the JAX package's numpy ``Mpeg2Encoder`` byte for byte, the block
coder's 4:2:2 intra levels to that encoder's quantiser, and the D-picture
math to the JAX function.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tcforge_tpu.io import mpeg2enc as jenc
from tcforge_tpu.io.mpeg2codec import Mpeg2Encoder as JIntraEncoder
from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder as JEncoder
from tcforge_tpu.io.mpeg2enc import RateController as JRateController
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import m2e, mpeg2enc
from tcforge_tpu_torch.io.mpeg2codec import dct_basis
from tcforge_tpu_torch.io.mpeg2enc import Mpeg2FullEncoder
from tcforge_tpu_torch.io.mpeg2rc import RateController
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels
from test_torch_mpeg_import import jax_native  # noqa: F401

H, W = 64, 96


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def smooth(h, w, seed, shift=(0, 0), grain=6.0):
    """A seeded smooth plane (two crossed waves) with Gaussian grain,
    moved by ``shift`` (rows, columns)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin((xx + shift[1]) / 7.0 + seed)
            + 50 * np.cos((yy + shift[0]) / 5.0))
    return np.clip(base + rng.normal(0, grain, (h, w)), 0,
                   255).astype(np.uint8)


def content(kind, h, w, seed):
    """(reference, current) planes: smooth and moved, uniform noise, a
    moved block near the frame's edges, or flat (ties everywhere)."""
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return smooth(h, w, seed), smooth(h, w, seed, (3, -5))
    if kind == "noise":
        return (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h, w), dtype=np.uint8))
    if kind == "shifted":
        ref = smooth(h, w, seed, grain=2.0)
        cur = np.roll(ref, (-7, 9), (0, 1))
        cur[:16, :16] = rng.integers(0, 256, (16, 16))
        return ref, cur
    return (np.full((h, w), 90, np.uint8),
            np.full((h, w), 91, np.uint8))


# ------------------------------------------------------------------ #
# motion search and prediction

@pytest.mark.parametrize("shape", [(48, 64), (H, W)])
@pytest.mark.parametrize("kind", ["smooth", "noise", "shifted", "flat"])
@pytest.mark.parametrize("r", [1, 4, 5, 8, 16])
def test_me16_refine_matches_native(r, kind, shape, jax_native):
    ref, cur = content(kind, *shape, seed=r)
    mv, sad = jax_native.me16_refine(ref, cur, r)
    got_mv, got_sad = kernels.mpeg2_me_ref([t(ref)], t(cur), r)
    assert np.array_equal(got_mv[0].numpy(), mv)
    assert np.array_equal(got_sad[0].numpy(), sad)


def test_mpeg2_me_stacks_two_references(jax_native):
    ref, cur = content("smooth", H, W, 3)
    ref2 = smooth(H, W, 4)
    mv, sad = kernels.mpeg2_me([t(ref), t(ref2)], t(cur), 8)
    assert mv.shape == (2, H // 16, W // 16, 2) and mv.dtype == torch.int32
    for k, r in enumerate((ref, ref2)):
        want_mv, want_sad = jax_native.me16_refine(r, cur, 8)
        assert np.array_equal(mv[k].numpy(), want_mv)
        assert np.array_equal(sad[k].numpy(), want_sad)


def test_mpeg2_me_reads_a_field_in_place(jax_native):
    """A field picture's planes are every other row of the frame: the
    search reads them as views."""
    frame = smooth(2 * H, W, 5)
    top, bottom = t(frame)[0::2], t(frame)[1::2]
    mv, sad = kernels.mpeg2_me([top], bottom, 4)
    want_mv, want_sad = jax_native.me16_refine(frame[0::2].copy(),
                                               frame[1::2].copy(), 4)
    assert np.array_equal(mv[0].numpy(), want_mv)
    assert np.array_equal(sad[0].numpy(), want_sad)


def vectors(h, w, mb, spread, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-spread, spread + 1,
                        (h // mb, w // mb, 2)).astype(np.int32)


@pytest.mark.parametrize("spread", [3, 40])
@pytest.mark.parametrize("mb", [16, 8])
def test_mc_pred_half_matches_native(mb, spread, jax_native):
    h, w = (H, W) if mb == 16 else (H // 2, W // 2)
    ref = smooth(h, w, 7)
    mv = vectors(h, w, mb, spread, seed=mb + spread)
    want = jax_native.mc_pred_half(ref, mv, mb)
    assert np.array_equal(mpeg2enc.mc_pred(t(ref), t(mv), mb).numpy(), want)


@pytest.mark.parametrize("spread", [3, 40])
@pytest.mark.parametrize("mb", [16, 8])
def test_b_mc_sel_pred_matches_native(mb, spread, jax_native):
    h, w = (H, W) if mb == 16 else (H // 2, W // 2)
    fref, bref = smooth(h, w, 8), smooth(h, w, 9)
    fmv, bmv = (vectors(h, w, mb, spread, seed=s) for s in (1, 2))
    mode = np.random.default_rng(3).integers(0, 3, (h // mb, w // mb)) \
        .astype(np.int32)
    want = jax_native.b_mc_sel_pred(fref, bref, fmv, bmv, mode, mb)
    fp = mpeg2enc.mc_pred(t(fref), t(fmv), mb)
    bp = mpeg2enc.mc_pred(t(bref), t(bmv), mb)
    got = mpeg2enc.b_select(fp, bp, t(mode), mb)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mb", [16, 8])
def test_b_select_pred_matches_native(mb, jax_native):
    fp, bp = smooth(H, W, 10), smooth(H, W, 11)
    mode = np.random.default_rng(4).integers(0, 3, (H // mb, W // mb)) \
        .astype(np.int32)
    want = jax_native.b_select_pred(fp, bp, mode, mb)
    got = mpeg2enc.b_select(t(fp), t(bp), t(mode), mb)
    assert np.array_equal(got.numpy(), want)


def test_bisad_matches_native(jax_native):
    fp, bp, cur = smooth(H, W, 12), smooth(H, W, 13), smooth(H, W, 14)
    want = jax_native.bisad(fp, bp, cur)
    assert np.array_equal(mpeg2enc.bisad(t(fp), t(bp), t(cur)).numpy(), want)


@pytest.mark.parametrize("kind", ["smooth", "noise", "shifted", "flat"])
def test_mb_act_matches_native(kind, jax_native):
    _, cur = content(kind, H, W, 15)
    assert np.array_equal(mpeg2enc.mb_act(t(cur)).numpy(),
                          jax_native.mb_act(cur))


def picture(seed, h=H, w=W):
    """A 4:2:0 picture's planes (y, u, v) as numpy."""
    return (smooth(h, w, seed), smooth(h // 2, w // 2, seed + 1),
            smooth(h // 2, w // 2, seed + 2))


@pytest.mark.parametrize("bi", [False, True])
def test_enc_pred_matches_the_native_planes(bi, jax_native):
    """``mpeg2_enc_pred``'s plain version over a picture's three planes:
    P from one reference, B with each macroblock's mode (chroma at the
    vectors halved toward 0), as ``_p_native`` and ``_b_native`` build
    them."""
    fwd, bwd = picture(20), picture(30)
    fmv, bmv = vectors(H, W, 16, 40, 5), vectors(H, W, 16, 40, 6)
    mode = np.random.default_rng(7).integers(0, 3, (H // 16, W // 16)) \
        .astype(np.int32)
    cfmv = jenc._np_trunc_div(fmv, 2).astype(np.int32)
    cbmv = jenc._np_trunc_div(bmv, 2).astype(np.int32)
    if bi:
        fpy = jax_native.mc_pred_half(fwd[0], fmv, 16)
        bpy = jax_native.mc_pred_half(bwd[0], bmv, 16)
        want = [jax_native.b_select_pred(fpy, bpy, mode, 16)] + [
            jax_native.b_mc_sel_pred(f, b, cfmv, cbmv, mode, 8)
            for f, b in zip(fwd[1:], bwd[1:])]
        got = kernels.mpeg2_enc_pred(tuple(map(t, fwd)), t(fmv),
                                     tuple(map(t, bwd)), t(bmv), t(mode))
    else:
        want = [jax_native.mc_pred_half(fwd[0], fmv, 16)] + [
            jax_native.mc_pred_half(p, cfmv, 8) for p in fwd[1:]]
        got = kernels.mpeg2_enc_pred(tuple(map(t, fwd)), t(fmv))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_enc_bmode_matches_the_native_decision(jax_native):
    """``mpeg2_enc_bmode``'s plain version: the first minimum of (fsad,
    bsad, bisad - 256) with ``_b_native``'s predictions and SADs."""
    fy, by = smooth(H, W, 40), smooth(H, W, 41, (2, 3))
    cur = smooth(H, W, 40, (1, 1))
    fmv, fsad = jax_native.me16_refine(fy, cur, 8)
    bmv, bsad = jax_native.me16_refine(by, cur, 8)
    bi = jax_native.bisad(jax_native.mc_pred_half(fy, fmv, 16),
                          jax_native.mc_pred_half(by, bmv, 16), cur)
    want = np.argmin(np.stack([fsad, bsad, bi - 256]), axis=0)
    got = kernels.mpeg2_enc_bmode(t(fy), t(by), t(fmv), t(fsad), t(bmv),
                                  t(bsad), t(cur))
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ #
# the block coder

def native_blocks(nat, mode, cur, pred, qs, alt, m1, intra_mb=None):
    """The JAX package's native route of a picture's block coding:
    ``_intra_native``; ``_p_native``'s ``enc_inter_plane`` with
    ``enc_intra_sel`` recoding the intra macroblocks in place; or
    ``_b_native``'s ``enc_inter_levels``."""
    y, u, v = cur
    if mode == mpeg2enc.ENC_INTRA:
        return jenc._intra_native(nat, y, u, v, qs, alt, m1)
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    scan = mpeg2enc.scan_order(alt)
    levels = np.empty((mbh * mbw, 6, 64), np.int16)
    if mode == mpeg2enc.ENC_LEVELS:
        for p, pp, slot in zip(cur, pred, (-1, 4, 5)):
            nat.enc_inter_levels(p, pp, qs, scan, m1, slot=slot, out=levels)
        return (levels,)
    recs = [nat.enc_inter_plane(p, pp, qs, scan, m1, slot=slot,
                                out=levels)[1]
            for p, pp, slot in zip(cur, pred, (-1, 4, 5))]
    if intra_mb is not None and intra_mb.any():
        ys, xs = np.nonzero(intra_mb)
        dyx = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], np.int32)
        lby = (ys[:, None] * 2 + dyx[:, 0][None, :]).ravel()
        lbx = (xs[:, None] * 2 + dyx[:, 1][None, :]).ravel()
        w = mpeg2enc.intra_weights()
        fi = intra_mb.reshape(-1)
        levels[fi, :4] = nat.enc_intra_sel(y, qs, w, scan, lby, lbx,
                                           recs[0], m1).reshape(-1, 4, 64)
        levels[fi, 4] = nat.enc_intra_sel(u, qs, w, scan, ys, xs, recs[1],
                                          m1)
        levels[fi, 5] = nat.enc_intra_sel(v, qs, w, scan, ys, xs, recs[2],
                                          m1)
    return (levels, *recs)


def port_blocks(mode, cur, pred, qs, alt, m1, intra_mb=None):
    levels, rec = kernels.mpeg2_enc_blocks(
        mode, tuple(map(t, cur)), None if pred is None
        else tuple(map(t, pred)), qs, alt, m1,
        None if intra_mb is None else t(intra_mb))
    return (levels.numpy(), *(r.numpy() for r in (rec or ())))


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


QS = [1, 8, 31]


@pytest.mark.parametrize("m1", [False, True])
@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("qs", QS)
def test_enc_intra_plane_matches_native(qs, alt, m1, jax_native):
    cur = picture(50 + qs)
    assert_same(port_blocks(mpeg2enc.ENC_INTRA, cur, None, qs, alt, m1),
                native_blocks(jax_native, mpeg2enc.ENC_INTRA, cur, None, qs,
                              alt, m1))


def inter_picture(seed):
    """A current picture and its prediction: the prediction moved and
    regrained, one macroblock of noise (an intra candidate), one block
    equal to the prediction (all-zero levels)."""
    cur = list(picture(seed))
    pred = [smooth(p.shape[0], p.shape[1], seed + k, (1, 2), grain=3.0)
            for k, p in enumerate(cur)]
    rng = np.random.default_rng(seed)
    cur[0][16:32, 32:48] = rng.integers(0, 256, (16, 16))
    cur[0][40:48, 8:16] = pred[0][40:48, 8:16]
    intra_mb = rng.random((H // 16, W // 16)) < 0.25
    intra_mb[1, 2] = True
    return tuple(cur), tuple(pred), intra_mb


@pytest.mark.parametrize("m1", [False, True])
@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("qs", QS)
def test_enc_inter_plane_with_intra_sel_matches_native(qs, alt, m1,
                                                       jax_native):
    cur, pred, intra_mb = inter_picture(60 + qs)
    assert_same(port_blocks(mpeg2enc.ENC_INTER, cur, pred, qs, alt, m1,
                            intra_mb),
                native_blocks(jax_native, mpeg2enc.ENC_INTER, cur, pred, qs,
                              alt, m1, intra_mb))


@pytest.mark.parametrize("m1", [False, True])
@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("qs", QS)
def test_enc_inter_levels_matches_native(qs, alt, m1, jax_native):
    cur, pred, _ = inter_picture(70 + qs)
    assert_same(port_blocks(mpeg2enc.ENC_LEVELS, cur, pred, qs, alt, m1),
                native_blocks(jax_native, mpeg2enc.ENC_LEVELS, cur, pred,
                              qs, alt, m1))


def near_half_blocks(kind: str, qs: int, count: int, seed: int):
    """``count`` 8x8 blocks (intra: pixels; inter: a prediction and a
    residual within it) whose DCT coefficient (intra: its quantiser's
    quotient ``C * 32 / (2 W 2qs)``) lies nearest a rounding boundary
    (an odd multiple of 1/2), picked from 200,000 random blocks by a
    float64 DCT: the cases where the order of the fused multiply-adds
    decides the level."""
    rng = np.random.default_rng(seed)
    b = dct_basis()
    n = 200_000
    if kind == "intra":
        x = rng.integers(0, 256, (n, 8, 8)).astype(np.float64)
    else:
        x = rng.integers(-60, 61, (n, 8, 8)).astype(np.float64)
    coef = np.einsum("ik,nkl,jl->nij", b, x, b).reshape(n, 64)
    q = coef
    if kind == "intra":
        w = mpeg2enc.intra_weights().astype(np.float64)
        q = coef * 32.0 / (2.0 * w * (2.0 * qs))
        q[:, 0] = coef[:, 0] / 8.0
    gap = np.abs(np.abs(q - np.floor(q)) - 0.5).min(axis=1)
    pick = np.argsort(gap)[:count]
    assert gap[pick].max() < 1e-6
    return x[pick]


def blocks_to_plane(blocks: np.ndarray, bh: int, bw: int) -> np.ndarray:
    return (blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
            .reshape(bh * 8, bw * 8))


@pytest.mark.parametrize("kind", ["intra", "inter"])
@pytest.mark.parametrize("qs", [1, 2, 8, 31])
def test_blocks_on_rounding_boundaries_match_native(kind, qs, jax_native):
    """The luma of a 32x32 picture and its chroma are blocks whose
    coefficients land within 1e-6 of x.5."""
    blocks = near_half_blocks(kind, qs, 24, seed=qs)
    y = blocks_to_plane(blocks[:16], 4, 4)
    u, v = blocks_to_plane(blocks[16:20], 2, 2), blocks_to_plane(
        blocks[20:24], 2, 2)
    if kind == "intra":
        cur = tuple(p.astype(np.uint8) for p in (y, u, v))
        args = (mpeg2enc.ENC_INTRA, cur, None)
    else:
        pred = tuple(np.full(p.shape, 128, np.uint8) for p in (y, u, v))
        cur = tuple((p + 128).astype(np.uint8) for p in (y, u, v))
        args = (mpeg2enc.ENC_INTER, cur, pred)
    for alt in (False, True):
        assert_same(port_blocks(*args, qs, alt, False),
                    native_blocks(jax_native, *args, qs, alt, False))


@pytest.mark.parametrize("qs", QS)
def test_enc_blocks_codes_4_2_2_intra_planes_as_the_numpy_quantiser(qs):
    """4:2:2 intra planes (chroma of the luma's height): eight blocks a
    macroblock, Cb Cr Cb Cr, each block's levels those of the JAX
    package's numpy intra quantiser (its DC in slot 0)."""
    rng = np.random.default_rng(qs)
    y = smooth(H, W, qs)
    u = smooth(H, W // 2, qs + 1)
    v = rng.integers(0, 256, (H, W // 2), dtype=np.uint8)
    levels = port_blocks(mpeg2enc.ENC_INTRA, (y, u, v), None, qs, False,
                         False)[0]
    mbh, mbw = H // 16, W // 16
    assert levels.shape == (mbh * mbw, 8, 64)
    lv = levels.reshape(mbh, mbw, 8, 64).astype(np.int32)
    quant = JIntraEncoder(W, H, qscale=qs, chroma=422)._quantize_plane
    for plane, slot in ((u, 4), (v, 5)):
        dc, ac = quant(plane)
        for row in (0, 1):
            got = lv[:, :, slot + 2 * row]
            assert np.array_equal(got[..., 0], dc[row::2])
            assert np.array_equal(got[..., 1:], ac[row::2, :, 1:])
    dc, ac = quant(y)
    luma = lv[:, :, :4].reshape(mbh, mbw, 2, 2, 64).transpose(
        0, 2, 1, 3, 4).reshape(2 * mbh, 2 * mbw, 64)
    assert np.array_equal(luma[..., 0], dc)
    assert np.array_equal(luma[..., 1:], ac[..., 1:])


INTRA_CASES = {
    "frame": dict(w=96, h=64, qscale=8),
    "ragged_q1": dict(w=90, h=60, qscale=1),
    "fields_q31": dict(w=64, h=64, qscale=31, interlaced=True),
    "ragged_fields": dict(w=80, h=50, qscale=3, interlaced=True),
    "422_pulldown": dict(w=96, h=64, qscale=5, chroma=422, pulldown=True),
    "422_q1": dict(w=48, h=32, qscale=1, chroma=422),
}


@pytest.mark.parametrize("case", sorted(INTRA_CASES))
def test_intra_encoder_matches_the_numpy_encoder(case):
    """``Mpeg2IntraEncoder`` (the block coder's levels under the pinned
    writer) against the JAX package's numpy ``Mpeg2Encoder``: three
    noisy pictures, byte for byte."""
    kw = dict(INTRA_CASES[case])
    w, h = kw.pop("w"), kw.pop("h")
    want_enc, got_enc = JIntraEncoder(w, h, **kw), \
        mpeg2enc.Mpeg2IntraEncoder(w, h, **kw)
    code = ("encode_frame_fields" if kw.get("interlaced")
            else "encode_frame")
    ch = h if kw.get("chroma") == 422 else h // 2
    rng = np.random.default_rng(len(case))
    for i in range(3):
        planes = (smooth(h, w, i), rng.integers(0, 256, (ch, w // 2),
                                                dtype=np.uint8),
                  smooth(ch, w // 2, i + 5))
        want = getattr(want_enc, code)(*planes, with_seq=i == 0)
        got = getattr(got_enc, code)(*map(t, planes), with_seq=i == 0)
        assert got == want
    assert got_enc.sequence_end() == want_enc.sequence_end()


@pytest.mark.parametrize("shape", [(16, 16), (48, 64), (H, W)])
def test_d_math_matches_the_jax_one(shape):
    """The D picture's levels, the blocks' means rounded half to even on
    the planes' device, against the JAX package's numpy function; planes
    of means that end in .5 included."""
    h, w = shape
    rng = np.random.default_rng(h + w)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    y[:8, :8] = 0
    y[:8, :8:2] = 1                   # a mean of 0.5
    u, v = smooth(h // 2, w // 2, 3), smooth(h // 2, w // 2, 4)
    want = jenc.encode_d_math(y, u, v)[0]
    got = mpeg2enc.encode_d_math(*map(t, (y, u, v)))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)


def test_fdct_is_the_row_then_column_chain():
    """``fdct_f64`` and ``idct_f64`` round trip a block to within the
    float64 error of the orthonormal basis."""
    x = np.random.default_rng(1).integers(-255, 256, (5, 8, 8)) \
        .astype(np.float64)
    basis = torch.from_numpy(dct_basis())
    coef = mpeg2enc.fdct_f64(t(x), basis)
    back = mpeg2enc.idct_f64(coef, basis)
    assert np.abs(back.numpy() - x).max() < 1e-9


# ------------------------------------------------------------------ #
# the encoder

def frames(n, h, w, seed=0):
    """Display-order frames of moving smooth content with grain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = 128 + 60 * np.sin((xx + 2 * i) / 7.0) \
            + 50 * np.cos((yy + i) / 5.0)
        y = np.clip(base + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 30 * np.sin((xx[::2, ::2] + i) / 9.0), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 30 * np.cos((yy[::2, ::2] + i) / 6.0), 0,
                    255).astype(np.uint8)
        out.append((y, u, v))
    return out


ENCODER_CASES = {
    "gop15_3_rc": (11, dict(w=96, h=64, fps=29.97, gop_n=15, gop_m=3,
                            rate_control=True, bitrate_kbps=600, qmin=2)),
    "gop12_1_cq": (9, dict(w=96, h=64, fps=25.0, gop_n=12, gop_m=1,
                           qscale=5)),
    "fields_tff": (7, dict(w=64, h=64, fps=29.97, gop_n=6, gop_m=3,
                           fields=True, qscale=6)),
    "fields_bff_rc": (7, dict(w=64, h=64, fps=29.97, gop_n=6, gop_m=3,
                              fields=True, top_field_first=False,
                              rate_control=True, bitrate_kbps=800)),
    "mpeg1": (8, dict(w=64, h=48, fps=25.0, gop_n=6, gop_m=3, mpeg1=True,
                      qscale=6)),
    "mpeg1_rc": (8, dict(w=64, h=48, fps=25.0, gop_n=4, gop_m=2,
                         mpeg1=True, rate_control=True, bitrate_kbps=500)),
    "dpict": (5, dict(w=64, h=48, fps=25.0, gop_n=4, gop_m=1, mpeg1=True,
                      dpict=True)),
    "alt_scan": (7, dict(w=64, h=48, fps=29.97, gop_n=6, gop_m=3,
                         alt_scan=True, qscale=3)),
    "pulldown": (9, dict(w=64, h=48, fps=23.976, gop_n=6, gop_m=3,
                         pulldown=True, qscale=4)),
    "range1": (6, dict(w=64, h=48, gop_n=6, gop_m=3, search_range=1,
                       qscale=2)),
    "range16": (6, dict(w=96, h=64, gop_n=6, gop_m=3, search_range=16,
                        qscale=9)),
    "q_bounds": (8, dict(w=64, h=48, gop_n=8, gop_m=2, rate_control=True,
                         bitrate_kbps=100, qmin=4, qmax=12)),
    "max_bitrate": (4, dict(w=64, h=48, gop_n=4, gop_m=2, qscale=7,
                            max_bitrate_kbps=900)),
    "flush_bs_waiting": (5, dict(w=64, h=48, gop_n=15, gop_m=3, qscale=5)),
    "one_frame": (1, dict(w=64, h=48, gop_n=15, gop_m=3, qscale=5)),
    "two_frames": (2, dict(w=64, h=48, gop_n=15, gop_m=3, qscale=5)),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_full_encoder_matches_the_jax_class(case, jax_native):
    n, kw = ENCODER_CASES[case]
    kw = dict(kw)
    w, h = kw.pop("w"), kw.pop("h")
    fr = frames(n, h, w, seed=len(case))
    jax_enc = JEncoder(w, h, **kw)
    port_enc = Mpeg2FullEncoder(w, h, **kw)
    want = [jax_enc.push_frame(*f) for f in fr]
    got = [port_enc.push_frame(*map(t, f)) for f in fr]
    assert got == want
    assert port_enc.flush() == jax_enc.flush()


def test_4_2_2_is_refused_by_name():
    """4:2:2 is MPEG-2 syntax: with MPEG-1 or D-pictures both classes
    refuse it, naming it (the 4:2:2 encode itself is
    tests/test_torch_mpeg422_cli.py's)."""
    for kw in (dict(mpeg1=True), dict(mpeg1=True, dpict=True)):
        for cls in (JEncoder, Mpeg2FullEncoder):
            with pytest.raises(ValueError, match="4:2:2"):
                cls(64, 48, chroma=422, **kw)


@pytest.mark.parametrize("kw,message", [
    (dict(width=60), "multiple of 16"), (dict(fields=True, height=48),
                                         "height"),
    (dict(gop_n=5, gop_m=3), "multiple"), (dict(mpeg1=True, fields=True),
                                           "mpeg1"),
    (dict(dpict=True), "D-pictures"), (dict(search_range=2000), "f_code")])
def test_encoder_refuses_what_the_jax_class_refuses(kw, message):
    args = dict(width=64, height=64)
    args.update(kw)
    for cls in (JEncoder, Mpeg2FullEncoder):
        with pytest.raises(ValueError, match=message):
            cls(**args)


@pytest.mark.parametrize("pic", ["I", "P", "B", "field_P", "mpeg1_B",
                                 "D"])
def test_syntax_writer_matches_native(pic, jax_native):
    """``io/m2e.py`` (the port's build of the pinned writer) against the
    JAX package's ``native.m2e_picture`` on one picture's records."""
    y, u, v = picture(80)
    ref = picture(81)
    ps = 1 if pic.startswith("field") else 0
    m1 = pic.startswith("mpeg1") or pic == "D"
    flags = (ps << 4) | (64 if m1 else 0)
    if pic in ("I", "D"):
        levels = port_blocks(mpeg2enc.ENC_INTRA, (y, u, v), None, 6, False,
                             m1)[0]
        mbinfo = np.zeros((levels.shape[0], 8), np.int32)
        mbinfo[:, 0] = mpeg2enc.MB_INTRA
        ptype = 4 if pic == "D" else 1
        if pic == "D":
            levels = mpeg2enc.encode_d_math(*map(t, (y, u, v))).numpy()
    elif pic == "B" or pic == "mpeg1_B":
        mbinfo, levels = mpeg2enc.encode_b_math(
            *map(t, (y, u, v)), tuple(map(t, ref)), tuple(map(t, picture(82))),
            6, 8, False, m1)
        mbinfo, levels, ptype = mbinfo.numpy(), levels.numpy(), 3
    else:
        out = mpeg2enc.encode_p_math(*map(t, (y, u, v)), tuple(map(t, ref)),
                                     6, 8, False, m1)
        mbinfo, levels, ptype = out[0].numpy(), out[1].numpy(), 2
        if ps:
            mbinfo[:, 7] = 0
    height = H // 2 if ps else H
    if ps:
        levels = levels[:levels.shape[0] // 2]
        mbinfo = mbinfo[:mbinfo.shape[0] // 2]
    args = (W, height, ptype, 3, 6, 1 if ptype == 1 else 2, 2 if ptype == 3
            else 15, mbinfo, levels)
    assert m2e.m2e_picture(*args, flags=flags) == \
        jax_native.m2e_picture(*args, flags=flags)


def test_rate_controller_follows_the_jax_one():
    """The pinned TM5 controller and the JAX one pick the same quantisers
    over a GOP's pictures and bit counts."""
    jrc = JRateController(6000, 29.97, 15, 3, 8, qmin=2)
    prc = RateController(6000, 29.97, 15, 3, 8, qmin=2)
    bits = np.random.default_rng(2).integers(20_000, 900_000, 40)
    for i, b in enumerate(bits):
        ptype = 1 if i % 15 == 0 else (2 if i % 3 == 0 else 3)
        assert prc.pick_qscale(ptype) == jrc.pick_qscale(ptype)
        prc.update(ptype, int(b))
        jrc.update(ptype, int(b))


@pytest.mark.parametrize("options", ["frames=5", "frames=3:seed=7"])
def test_framegen_matches_the_jax_module(options):
    """The pinned synthetic source: the same colour-wave planes and the
    same pink noise as the JAX importer."""
    from tcforge_tpu.core.job import Job as JJob
    ours = new_module(ModuleKind.DEMULTIPLEXOR, "framegen",
                      Job(im_v_width=64, im_v_height=48, a_rate=48000,
                          a_chan=2), options)
    ref = jax_new_module(JKind.DEMULTIPLEXOR, "framegen",
                         JJob(im_v_width=64, im_v_height=48, a_rate=48000,
                              a_chan=2), options)
    for mod in (ours, ref):
        mod.open(None)
    while True:
        a, b = ours.read_video_batch(2), ref.read_video_batch(2)
        assert (a is None) == (b is None)
        if a is None:
            break
        for k in "yuv":
            assert np.array_equal(a[k], b[k])
        assert np.array_equal(ours.read_audio_batch(1920),
                              ref.read_audio_batch(1920))


# ------------------------------------------------------------------ #
# the wrappers' checks

def planes_u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


@pytest.mark.parametrize("call,message", [
    (lambda: kernels.mpeg2_me([], planes_u8(32, 32), 8), "one or two"),
    (lambda: kernels.mpeg2_me([planes_u8(32, 32)], planes_u8(32, 40), 8),
     "macroblocks"),
    (lambda: kernels.mpeg2_me([planes_u8(32, 48)], planes_u8(32, 32), 8),
     "shape"),
    (lambda: kernels.mpeg2_me([planes_u8(32, 32)], planes_u8(32, 32), 65),
     "search range"),
    (lambda: kernels.mpeg2_enc_pred((planes_u8(32, 32),),
                                    torch.zeros((2, 2, 2),
                                                dtype=torch.int64)),
     "dtype"),
    (lambda: kernels.mpeg2_enc_blocks(3, (planes_u8(32, 32),) * 3, None, 5,
                                      False, False), "mode"),
    (lambda: kernels.mpeg2_enc_blocks(0, (planes_u8(32, 32),
                                          planes_u8(16, 16),
                                          planes_u8(16, 16)), None, 32,
                                      False, False), "qs"),
    (lambda: kernels.mpeg2_enc_blocks(2, (planes_u8(32, 32),
                                          planes_u8(16, 16),
                                          planes_u8(16, 16)),
                                      (planes_u8(32, 32),
                                       planes_u8(16, 16),
                                       planes_u8(16, 16)), 5, False, False,
                                      torch.zeros((2, 2), dtype=torch.bool)),
     "intra_mb"),
    (lambda: kernels.mpeg2_enc_blocks(0, (planes_u8(32, 32),
                                          planes_u8(16, 8),
                                          planes_u8(16, 16)), None, 5,
                                      False, False), "shape"),
    (lambda: kernels.mpeg2_enc_blocks(2, (planes_u8(32, 32),
                                          planes_u8(32, 16),
                                          planes_u8(32, 16)),
                                      (planes_u8(32, 32),
                                       planes_u8(16, 16),
                                       planes_u8(16, 16)), 5, False, False),
     "shape")])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, message):
    with pytest.raises(ValueError, match=message):
        call()
