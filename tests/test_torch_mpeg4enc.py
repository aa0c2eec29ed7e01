"""The port's MPEG-4 part 2 encoder (``-y xvid``) against the JAX
package's ``Mpeg4NativeEncoder``, on the CPU, at tolerance 0.

- ``Mpeg4Encoder``'s chunks and ``recon_log`` against the JAX encoder's
  over a grid of geometry (a multiple of 16 and not), quantizer 1, 5 and
  31, 0 to 3 B-VOPs, 4MV on and off, rate control off and at 200 and 800
  kbit/s, tail groups and GOP boundaries;
- the plain versions of the three kernels against the JAX loops they
  replace: the searches (``_search_mv``, ``_search_mv4``), the direct
  prediction (``_direct_pred``), the decisions of a P-VOP (the JAX
  encoder's median grid and skips), the block coder (``_code_intra_mb``
  and the inter block coding);
- the seed order of ``_search_mv``'s two-element set, over all 1,023
  nonzero predictor seeds;
- the plain forward DCT against numpy's ``_fdct`` on random blocks and
  on blocks whose coefficients land within an ulp of a quantizer step;
- the JAX encoder's 4MV skip (``mpeg4enc.py:732``): its decoder drifts
  from its reconstruction, and the port's in the same frames;
- the wrappers' checks of their input.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.io import mpeg4enc as jenc
from tcforge_tpu.io.mpeg4dec import Mpeg4Decoder as JDecoder
from tcforge_tpu_torch.io import mpeg4encdev as D
from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
from tcforge_tpu_torch.ops import kernels


def _t(frame):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in frame)


def encode_both(width, height, frames, **cfg):
    """Every chunk of both encoders on the same frames, and the
    encoders."""
    j = jenc.Mpeg4NativeEncoder(width, height, keep_recon_log=True, **cfg)
    p = Mpeg4Encoder(width, height, keep_recon_log=True, **cfg)
    jo, po = [], []
    for f in frames:
        jo += j.push(*f)
        po += p.push(*_t(f))
    jo += j.flush()
    po += p.flush()
    return jo, po, j, p


def assert_same(jo, po, j, p):
    assert [c for c, _ in po] == [c for c, _ in jo]
    assert [k for _, k in po] == [k for _, k in jo]
    assert sorted(p.recon_log) == sorted(j.recon_log)
    for disp, planes in j.recon_log.items():
        for a, b in zip(planes, p.recon_log[disp]):
            assert np.array_equal(np.asarray(a), b.numpy()), disp


# ------------------------------------------------------------------ #
# whole streams

@pytest.mark.parametrize("size", [(96, 64), (88, 56)],
                         ids=["96x64", "88x56"])
@pytest.mark.parametrize("q", [1, 5, 31])
@pytest.mark.parametrize("bframes", [0, 1, 2, 3])
@pytest.mark.parametrize("four_mv", [False, True], ids=["1mv", "4mv"])
def test_encoder_matches_jax_at_constant_q(size, q, bframes, four_mv):
    w, h = size
    frames = chip_smoke.encoder_clip(w, h, 6, seed=q + 7 * bframes)
    assert_same(*encode_both(w, h, frames, qscale=q, bframes=bframes,
                             four_mv=four_mv, gop=12))


@pytest.mark.parametrize("kbps", [200, 800])
@pytest.mark.parametrize("bframes", [0, 2])
@pytest.mark.parametrize("four_mv", [False, True], ids=["1mv", "4mv"])
def test_encoder_matches_jax_under_rate_control(kbps, bframes, four_mv):
    """Nine frames at GOP 4: I-VOPs inside the stream, a tail group
    shorter than the others, the controller's picks and updates."""
    frames = chip_smoke.encoder_clip(96, 64, 9, seed=kbps + bframes)
    assert_same(*encode_both(96, 64, frames, bitrate_kbps=kbps, gop=4,
                             bframes=bframes, four_mv=four_mv))


@pytest.mark.parametrize("cfg", [
    dict(qscale=5, bframes=2, four_mv=True),
    dict(bitrate_kbps=800, bframes=1, gop=5),
    dict(qscale=31, bframes=0, four_mv=True, gop=3)],
    ids=["q5_b2_4mv", "rc800_b1", "q31_gop3"])
def test_encoder_matches_jax_at_200x136(cfg):
    frames = chip_smoke.encoder_clip(200, 136, 5, seed=11)
    assert_same(*encode_both(200, 136, frames, **cfg))


@pytest.mark.parametrize("kind", ["wave", "still"])
@pytest.mark.parametrize("search", [1, 4, 14])
def test_encoder_matches_jax_at_other_search_ranges(kind, search):
    frames = chip_smoke.encoder_clip(96, 64, 5, seed=search, kind=kind)
    assert_same(*encode_both(96, 64, frames, qscale=8, bframes=1,
                             four_mv=True, search_range=search))


def test_encode_without_b_vops_matches_jax():
    frames = chip_smoke.encoder_clip(96, 64, 4, seed=3)
    j = jenc.Mpeg4NativeEncoder(96, 64, gop=2)
    p = Mpeg4Encoder(96, 64, gop=2)
    for f in frames:
        assert p.encode(*_t(f)) == j.encode(*f)


# ------------------------------------------------------------------ #
# the JAX encoder's 4MV skip

def _decode(chunks):
    dec = JDecoder()
    out = []
    for c in chunks:
        out += dec.decode_frames(c)
    tail = dec.flush()
    return out + ([tail] if tail is not None else [])


def _drift(chunks, log, w, h):
    return [i for i, f in enumerate(_decode(chunks))
            if not np.array_equal(np.asarray(f[0]),
                                  np.asarray(log[i][0])[:h, :w])]


@pytest.mark.parametrize("q", [8, 31])
def test_the_4mv_skip_drifts_in_jax_and_in_the_port_alike(q):
    """``mpeg4enc.py:732`` writes a not_coded skip for a 4MV macroblock
    whose 1MV vector is (0, 0) and whose levels are 0, and keeps the 4MV
    prediction as its reconstruction: any decoder copies the co-located
    macroblock instead.  The port carries the quirk: the same bytes, the
    same reconstruction, so the same frames drift."""
    frames = chip_smoke.encoder_clip(96, 64, 8, seed=1, kind="still")
    jo, po, j, p = encode_both(96, 64, frames, qscale=q, four_mv=True)
    assert_same(jo, po, j, p)
    drift = _drift([c for c, _ in jo], j.recon_log, 96, 64)
    assert drift, "the clip no longer reaches the 4MV skip"
    port_drift = _drift([c for c, _ in po],
                        {k: [x.numpy() for x in v]
                         for k, v in p.recon_log.items()}, 96, 64)
    assert port_drift == drift
    # without 4MV the decode is the reconstruction
    jo, po, j, p = encode_both(96, 64, frames, qscale=q)
    assert _drift([c for c, _ in po], {k: [x.numpy() for x in v] for k, v
                                       in p.recon_log.items()}, 96, 64) == []


# ------------------------------------------------------------------ #
# the plain versions against the JAX loops

_SEEDS = [(a, b) for a in range(-16, 16) for b in range(-16, 16)
          if (a, b) != (0, 0)]


@pytest.mark.parametrize("a", range(-16, 16))
def test_the_seed_set_iterates_the_predictor_first(a):
    """``_search_mv`` loops over ``{(0, 0), (pred >> 1)}``: for every
    nonzero seed with components in [-16, 15] CPython iterates the
    predictor's seed first, which the port's search and kernel take as
    their order (a tie keeps the earlier seed)."""
    for s in [s for s in _SEEDS if s[0] == a]:
        assert list({(0, 0), s}) == [s, (0, 0)]


def _refs(seed, w=96, h=64):
    rng = np.random.default_rng(seed)
    f = chip_smoke.encoder_clip(w, h, 2, seed=seed)
    ref = f[0][0]
    cur = np.roll(f[1][0], (int(rng.integers(-3, 4)),
                            int(rng.integers(-3, 4))), (0, 1))
    return ref, cur, rng


@pytest.mark.parametrize("seed", range(12))
def test_search_mv_matches_jax(seed):
    ref, cur, rng = _refs(seed)
    pad = 32
    ref_pad = np.pad(ref, pad, mode="edge")
    j = jenc.Mpeg4NativeEncoder(96, 64)
    t8 = D.int_sad_table(torch.from_numpy(cur), torch.from_numpy(ref))
    hp = D.HalfPel(torch.from_numpy(ref))
    r = D.TABLE_R
    for mby in range(4):
        for mbx in range(6):
            x0, y0 = 16 * mbx, 16 * mby
            pred = (int(rng.integers(-32, 32)), int(rng.integers(-32, 32)))
            want = j._search_mv(ref_pad, pad, cur[y0:y0 + 16, x0:x0 + 16],
                                x0, y0, pred)

            def sad16(ix, iy):
                return int(t8[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2,
                              iy + r, ix + r].sum())
            got = D.search_mv(sad16, hp, torch.from_numpy(
                cur[y0:y0 + 16, x0:x0 + 16].astype(np.int32)), x0, y0,
                pred, j.search)
            assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_search_mv4_matches_jax(seed):
    ref, cur, rng = _refs(100 + seed)
    pad = 32
    ref_pad = np.pad(ref, pad, mode="edge")
    j = jenc.Mpeg4NativeEncoder(96, 64)
    t8 = D.int_sad_table(torch.from_numpy(cur), torch.from_numpy(ref))
    hp = D.HalfPel(torch.from_numpy(ref))
    r = D.TABLE_R
    for mby in range(4):
        for mbx in range(6):
            x0, y0 = 16 * mbx, 16 * mby
            mx, my = int(rng.integers(-32, 32)), int(rng.integers(-32, 32))
            want = j._search_mv4(ref_pad, pad, cur, x0, y0, mx, my)

            def t8k(k, nx, ny):
                return int(t8[2 * mby + (k >> 1), 2 * mbx + (k & 1),
                              ny + r, nx + r])
            got = D.search_mv4(t8k, hp, torch.from_numpy(
                cur.astype(np.int32)), x0, y0, mx, my)
            assert got == want


@pytest.mark.parametrize("trb,trd", [(1, 2), (1, 3), (2, 3), (3, 4)])
def test_direct_prediction_matches_jax(trb, trd):
    """``_direct_pred`` from co-located vectors of every size (skipped
    ones count as 0) against the records' direct vectors through the
    block coder's prediction."""
    rng = np.random.default_rng(trb * 10 + trd)
    mbw, mbh = 6, 4
    planes = [tuple(rng.integers(0, 256, (mbh * s, mbw * s), dtype=np.uint8)
                    for s in (16, 8, 8)) for _ in range(2)]
    co = torch.zeros((mbw * mbh, D.REC), dtype=torch.int16)
    co[:, D.FMV4:D.FMV4 + 8] = torch.from_numpy(
        rng.integers(-32, 32, (mbw * mbh, 8)).astype(np.int16))
    co[:, D.SKIP] = torch.from_numpy(
        (rng.random(mbw * mbh) < 0.2).astype(np.int16))
    j = jenc.Mpeg4NativeEncoder(16 * mbw, 16 * mbh)
    j._co_mvs = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
    for i in range(mbw * mbh):
        mbx, mby = i % mbw, i // mbw
        for k in range(4):
            m = (0, 0) if co[i, D.SKIP] else (int(co[i, D.FMV4 + 2 * k]),
                                               int(co[i, D.FMV4 + 2 * k + 1]))
            j._co_mvs[2 * mby + (k >> 1)][2 * mbx + (k & 1)] = m
    pad = 32
    frefs = [np.pad(p, pad, mode="edge") for p in planes[0]]
    brefs = [np.pad(p, pad, mode="edge") for p in planes[1]]
    f, b = D.direct_vectors(co, trb, trd)
    rec = torch.zeros_like(co)
    rec[:, D.MODE] = D.MODE_DIRECT
    rows = rec.tolist()
    for i in range(mbw * mbh):
        D._set_vectors(rows[i], f[i].tolist(), b[i].tolist(), False)
    rec = torch.tensor(rows, dtype=torch.int16)
    pred = D._mb_blocks(D._prediction(
        rec, mbw, tuple(map(torch.from_numpy, planes[0])),
        tuple(map(torch.from_numpy, planes[1]))), mbw)
    for i in range(mbw * mbh):
        mbx, mby = i % mbw, i // mbw
        want = j._direct_pred(frefs, brefs, pad, 16 * mbx, 16 * mby, mbx,
                              mby, trb, trd)
        assert np.array_equal(pred[i].numpy(), want)


@pytest.mark.parametrize("four_mv", [False, True], ids=["1mv", "4mv"])
@pytest.mark.parametrize("kind", ["wave", "still"])
@pytest.mark.parametrize("q", [2, 16])
def test_p_vop_decisions_match_jax(four_mv, kind, q):
    """One P-VOP: the plain decisions and block coder against the JAX
    ``_encode_pvop``'s state after it: the median grid it leaves for the
    B-VOPs (``_co_mvs``), its skips, and its reconstruction."""
    frames = chip_smoke.encoder_clip(96, 64, 2, seed=q, kind=kind)
    j = jenc.Mpeg4NativeEncoder(96, 64, qscale=q, four_mv=four_mv)
    j.encode(*frames[0])
    j.encode(*frames[1])
    p = Mpeg4Encoder(96, 64, qscale=q, four_mv=four_mv)
    p.encode(*_t(frames[0]))
    cur = p._pad(*_t(frames[1]))
    rec = kernels.mpeg4_enc_me(cur, p._recon, q, four_mv, p.search)
    rec, recon = kernels.mpeg4_enc_blocks(rec, cur, p._recon, None, q,
                                          D.VOP_P, True)
    skip = rec[:, D.SKIP].bool()
    mvs = torch.where(skip[:, None], torch.zeros(1, dtype=torch.int16),
                      rec[:, D.FMV4:D.FMV4 + 8]).reshape(4, 6, 2, 2, 2)
    grid = mvs.permute(0, 2, 1, 3, 4).reshape(8, 12, 2).tolist()
    assert [[tuple(m) for m in row] for row in grid] == \
        [[tuple(m) for m in row] for row in j._co_mvs]
    assert skip.reshape(4, 6).tolist() == j._co_skip
    for a, b in zip(j._recon, recon):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("q", [1, 3, 8, 17, 31])
def test_intra_block_coding_matches_code_intra_mb(q):
    """An I-VOP's levels (the DC in slot 0), cbp and reconstruction
    against ``_code_intra_mb`` macroblock by macroblock."""
    frames = chip_smoke.encoder_clip(96, 64, 1, seed=q)
    cur = D.pad_planes(*_t(frames[0]), 6, 4)
    rec, recon = kernels.mpeg4_enc_blocks(None, cur, None, None, q,
                                          D.VOP_I, True)
    j = jenc.Mpeg4NativeEncoder(96, 64, qscale=q)
    yp, up, vp = j._pad_planes(*frames[0])
    dcs = [np.full((9, 14), 1024, np.int64) for _ in range(3)]
    levels = rec[:, :384].reshape(24, 6, 8, 8).numpy()
    for i in range(24):
        mbx, mby = i % 6, i // 6
        src6 = j._mb_blocks(yp, up, vp, mbx, mby)
        cbp, entries, want = j._code_intra_mb(src6, mbx, mby, dcs)
        assert int(rec[i, D.CBP]) == cbp
        for n, (_, lv) in enumerate(entries):
            assert np.array_equal(levels[i, n].reshape(64)[1:],
                                  lv.reshape(64)[1:])
        got = D._mb_blocks(recon, 6)[i].numpy()
        assert np.array_equal(got, want)
    assert (rec[:, D.MODE] == D.MODE_INTRA).all()


# ------------------------------------------------------------------ #
# the forward DCT and the quantizers

@pytest.mark.parametrize("seed", range(10))
def test_fdct_matches_numpy_fdct(seed):
    """1,000 random residual blocks a case: the plain DCT's two FMA
    chains give numpy's ``_DCTM @ b @ _DCTM.T`` bit for bit (a multiply
    and an add in the same order do not)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-255, 256, (1000, 8, 8))
    got = D.fdct_ref(torch.from_numpy(blocks)).numpy()
    want = np.stack([jenc._fdct(b) for b in blocks])
    assert np.array_equal(got, want)


def _step_blocks(q):
    """Blocks whose coefficients land on or next to a quantizer step at
    ``q``: flat blocks (F00 = 8c) and single cosines of the basis, scaled
    so that a coefficient is a multiple of q."""
    out = []
    for c in range(-255, 256):
        out.append(np.full((8, 8), c))
    d = jenc._DCTM
    for u in range(8):
        for v in range(8):
            basis = np.outer(d[u], d[v])
            for m in range(1, 12):
                out.append(np.round(basis * m * q * 2).astype(np.int64))
                out.append(np.round(basis * (m * q * 2 + q)).astype(
                    np.int64))
    return np.clip(np.stack(out), -255, 255)


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 7, 8, 12, 16, 23, 31])
def test_quantizers_match_numpy_on_step_boundaries(q):
    blocks = _step_blocks(q)
    f = D.fdct_ref(torch.from_numpy(blocks))
    inter = D.quant_inter_ref(f, q).numpy()
    scale = torch.full((len(blocks),), 8, dtype=torch.int64)
    intra = D.quant_intra_ref(f, q, scale).numpy()
    for k, b in enumerate(blocks):
        fj = jenc._fdct(b)
        assert np.array_equal(inter[k], jenc._quant_inter(fj, q))
        ac = jenc._quant_intra_ac(fj, q)
        assert np.array_equal(intra[k].reshape(64)[1:], ac.reshape(64)[1:])
        assert intra[k, 0, 0] == int(np.floor(fj[0, 0] / 8 + 0.5))


# ------------------------------------------------------------------ #
# padding and the wrappers

@pytest.mark.parametrize("size", [(96, 64), (88, 56), (200, 136), (17, 9),
                                  (16, 16), (33, 47)])
def test_pad_planes_matches_jax(size):
    w, h = size
    f = chip_smoke.encoder_clip(w, h, 1, seed=w)[0]
    j = jenc.Mpeg4NativeEncoder(w, h)
    got = D.pad_planes(*_t(f), j.mbw, j.mbh)
    for a, b in zip(j._pad_planes(*f), got):
        assert np.array_equal(a, b.numpy())


def _planes(mbw=2, mbh=2):
    return tuple(torch.zeros((mbh * s, mbw * s), dtype=torch.uint8)
                 for s in (16, 8, 8))


@pytest.mark.parametrize("bad", ["odd", "chroma", "dtype", "q", "search",
                                 "rec", "vop", "tr", "grid", "two"])
def test_the_wrappers_check_their_input(bad):
    cur, ref = _planes(), _planes()
    rec = torch.zeros((4, D.REC), dtype=torch.int16)
    with pytest.raises(ValueError):
        if bad == "odd":
            kernels.mpeg4_enc_me((torch.zeros((24, 32), dtype=torch.uint8),
                                  *cur[1:]), ref, 5, False, 12)
        elif bad == "chroma":
            kernels.mpeg4_enc_me((cur[0], cur[1][:8], cur[2]), ref, 5,
                                 False, 12)
        elif bad == "dtype":
            kernels.mpeg4_enc_me(cur, (ref[0].int(), *ref[1:]), 5, False,
                                 12)
        elif bad == "q":
            kernels.mpeg4_enc_me(cur, ref, 32, False, 12)
        elif bad == "search":
            kernels.mpeg4_enc_me(cur, ref, 5, False, 15)
        elif bad == "rec":
            kernels.mpeg4_enc_blocks(rec[:3], cur, ref, None, 5, D.VOP_P,
                                     False)
        elif bad == "vop":
            kernels.mpeg4_enc_blocks(rec, cur, None, None, 5, 3, False)
        elif bad == "tr":
            kernels.mpeg4_enc_bme(cur, ref, ref, rec, 2, 2, 12)
        elif bad == "grid":
            kernels.mpeg4_enc_bme(cur, ref, _planes(1, 2), rec, 1, 2, 12)
        else:
            kernels.mpeg4_enc_blocks(rec, cur, ref, None, 5, D.VOP_B, False)


def test_a_vop_on_the_cpu_runs_the_plain_versions(monkeypatch):
    calls = []
    for name in ("mpeg4_enc_me_ref", "mpeg4_enc_bme_ref",
                 "mpeg4_enc_blocks_ref"):
        orig = getattr(D, name)

        def spy(*a, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(*a)
        monkeypatch.setattr(D, name, spy)
    enc = Mpeg4Encoder(32, 32, bframes=1)
    for f in chip_smoke.encoder_clip(32, 32, 3, seed=2):
        enc.push(*_t(f))
    enc.flush()
    assert calls == ["mpeg4_enc_blocks_ref",
                     "mpeg4_enc_me_ref", "mpeg4_enc_blocks_ref",
                     "mpeg4_enc_bme_ref", "mpeg4_enc_blocks_ref"]
    assert not any(kernels.launches[k] for k in
                   ("mpeg4_enc_me", "mpeg4_enc_bme", "mpeg4_enc_blocks"))


@pytest.mark.cuda
def test_mpeg4_encode_kernels_match_their_plain_versions_on_cuda():
    """The three kernels against their plain versions on the card, every
    call of a 96x64 encode with B-VOPs and 4MV (``chip_smoke.py`` phase 3
    does it on the divxenc path and off it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames = chip_smoke.encoder_clip(96, 64, 7, seed=5)
    out = {}
    for dev in ("cuda", "cpu"):
        enc = Mpeg4Encoder(96, 64, qscale=8, bframes=2, four_mv=True)
        chunks = []
        for f in frames:
            chunks += enc.push(*(p.to(dev) for p in _t(f)))
        out[dev] = chunks + enc.flush()
    assert out["cuda"] == out["cpu"]
