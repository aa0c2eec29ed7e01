"""The port's MPEG-1/2 reconstruction against the JAX package's, function
by function, on the CPU.

The streams are the files of ``tests/data/mpeg2`` (``make_streams.py``
writes them; their SHA-256 values are pinned here and ``chip_smoke.py``
reads them on the card).  Each picture's parse output comes from the
port's own parse (``io/mpeg2parse.py``) and goes into both packages'
functions with the same references (the JAX package's planes):
``reconstruct_picture_jax`` for every frame picture (I, P, B, MPEG-1 P
and B, dual prime with both field orders, field MC with both field
selects, field DCT, skipped macroblocks, vectors out of the frame, a
size that is not a multiple of 16), ``reconstruct_field_picture_jax``
and ``decode_field_step`` for every predicted field picture (16x16 and
16x8 field MC, dual prime), ``_dual_prime_vectors_jax`` and the MC
pieces, all at tolerance 0.  The float32 IDCT is held to the JAX one on
blocks whose terms land on exact halves; the float64 IDCT of intra
pictures (the JAX package's native one, which only the whole-path
goldens of ``tests/test_torch_mpeg_import.py`` reach) is held to an
exact rational reference of the same chain of fused multiply-adds.
"""

from __future__ import annotations

import hashlib
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tcforge_tpu.io import mpeg2codec as jcodec
from tcforge_tpu_torch.io import mpeg, mpeg2codec, mpeg2parse
from tcforge_tpu_torch.io.mpeg2host import MBF_DUAL, MBF_INTRA
from tcforge_tpu_torch.ops import kernels

DATA = Path(__file__).resolve().parent / "data" / "mpeg2"

# every stream of tests/data/mpeg2, pinned (make_streams.py)
STREAMS = {
    "dpict.m1v":
        "1551e03c6f661e32d33dcd81850642e42d24be806cea7663dccc67a8bb3e30ef",
    "dvd.vob":
        "306f0b31515c6424fb78cad27b0aedc5a8e274c58c462015c9359c4d6d6ce940",
    "dvd_fields.vob":
        "0aa0e4f35c5f5071f2d22582943adc5660d2d939c3137dcea3e96994d24bd2ee",
    "fields.m2v":
        "cb0a8c4469b7e30a4c9d41dbfc9b7272a130b0ee76f6868b47502b20f1c72542",
    "intra.m2v":
        "69c4cf26519f8a87a4b4bfc70b9296d72a54da2d623a6d07e541eb7b2aec211b",
    "mpeg1.m1v":
        "3f55650c1a46b8aaf2640f101c6de3db8da659646aedd650ff5b5e180527208b",
    "odd.m2v":
        "4d3ad0e722b682ce982c715d2fb8810771f8b3e48521d2b0ca34398e2562f47e",
    "small.m2v":
        "8bb85ca0e52ca4736b3481efdb51ae1d3a8228592cd152abc944454cff36315b",
    "small.mpg":
        "77da436698bdfde080525968962c9549d1f41a28342fe7b6e34c2b1e0af42f27",
    "synth_fields.m2v":
        "84fb2fece392aea3dfaf6692034267dc3e3af8099677d8f4ce0183a0cc0a8876",
    "synth_odd.m2v":
        "184686a191a088c4c76136752d81b2ac48d7edba41332c4be07eb465acb75b93",
    "synth_tff0.m2v":
        "7e8c54740ebd0e08c7fb0b3a041318141ecb10c1f335d4bd36c02764607989bd",
    "synth_tff1.m2v":
        "4439b0126057f2a49abe2aed2241b115baee671c84cd8d87191e55f67f5fcc27",
}

# the float64 IDCT basis the kernels are handed (tc_idct_fill_basis)
BASIS_SHA256 = \
    "948391a6afe50a44ba3d40e335e88080f18799f916ec9781145808ebfd56765b"


def elementary(name: str) -> bytes:
    """The video elementary stream of a fixture (a program stream's
    video PES payloads)."""
    path = DATA / name
    if path.suffix in (".vob", ".mpg"):
        return b"".join(p for sid, p in mpeg.iter_pes_packets(str(path))
                        if 0xE0 <= sid <= 0xEF)
    return path.read_bytes()


def parse_all(name: str):
    """Every picture of a fixture: (ptype, picture_structure, tff,
    (ycoef, ucoef, vcoef, mbinfo)), and the stream's geometry."""
    bs = mpeg2parse.Mpeg2Bitstream(elementary(name))
    shapes = mpeg2parse.coef_shapes(bs.width, bs.height, bs.chroma)
    pics = []
    while True:
        out = [np.empty(s, np.int32) for s in shapes]
        got = bs.next_picture_full(out)
        if got is None:
            break
        pics.append((got[0], bs.last_picture_structure, bs.last_tff,
                     tuple(out)))
    geo = (bs.width, bs.height)
    bs.close()
    return pics, geo


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a)))


def planes_t(planes):
    return None if planes is None else tuple(t(p) for p in planes)


def assert_planes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_digest(name):
    assert hashlib.sha256((DATA / name).read_bytes()).hexdigest() \
        == STREAMS[name]


def test_streams_stay_small():
    assert sum((DATA / n).stat().st_size for n in STREAMS) <= 1_500_000


def test_basis_table_is_the_jax_packages_and_pinned():
    b = mpeg2codec.dct_basis()
    assert b.dtype == np.float64 and b.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(b, jcodec._dct_basis())
    # the native IDCT's own formula, c/2 * cos((2n+1) k pi / 16)
    want = [[(1 / math.sqrt(2.0) if k == 0 else 1.0) / 2.0
             * math.cos((2 * n + 1) * k * 3.14159265358979323846 / 16.0)
             for n in range(8)] for k in range(8)]
    np.testing.assert_array_equal(b, np.array(want))
    assert hashlib.sha256(b.tobytes()).hexdigest() == BASIS_SHA256


def test_idct_kron_is_the_jax_table():
    np.testing.assert_array_equal(mpeg2codec.idct_kron(),
                                  np.asarray(jcodec._idct_kron()))


def _fma_exact(a: float, b: float, c: float) -> float:
    # CPython's int/int true division is correctly rounded
    return float(Fraction(a) * Fraction(b) + Fraction(c))


@pytest.mark.parametrize("seed", range(4))
def test_fma64_is_one_rounding(seed):
    """Against exact rational arithmetic: random doubles, integer
    coefficients times the basis (the IDCT's own operands) and sums
    built to land on rounding midpoints."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.normal(0, 1e3, 300),
                        rng.integers(-2048, 2048, 300).astype(np.float64),
                        np.ldexp(rng.integers(1, 1 << 20, 100), -10)])
    b = np.concatenate([rng.normal(0, 1, 300),
                        rng.choice(mpeg2codec.dct_basis().ravel(), 300),
                        np.ldexp(rng.integers(1, 1 << 33, 100), -33)])
    c = np.concatenate([rng.normal(0, 1e3, 300), rng.normal(0, 50, 300),
                        np.ldexp(rng.integers(-(1 << 52), 1 << 52, 100),
                                 -30)])
    got = mpeg2codec.fma64(*(torch.from_numpy(x) for x in (a, b, c)))
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.numpy(), want)


def _exact_idct_f64(block: np.ndarray) -> np.ndarray:
    """tc_idct_block_avx512's chain of fused multiply-adds, in exact
    rationals rounded once per step: (8, 8) int -> (8, 8) uint8."""
    bas = mpeg2codec.dct_basis()
    tt = np.zeros((8, 8))
    for i in range(8):
        for j in range(8):
            acc = 0.0
            for k in range(8):
                acc = _fma_exact(float(block[i, k]), bas[k, j], acc)
            tt[i, j] = acc
    out = np.zeros((8, 8))
    for i in range(8):
        for j in range(8):
            acc = 0.0
            for k in range(8):
                acc = _fma_exact(bas[k, i], tt[k, j], acc)
            out[i, j] = acc
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _half_blocks(rng, n: int) -> np.ndarray:
    """Intra blocks whose DC and (0,4)/(4,0)/(4,4) terms put many pixels
    on exact halves (a DC of 8*(v + 1/2) alone gives v + 0.5 everywhere),
    with sparse other terms."""
    blocks = np.zeros((n, 64), np.int32)
    blocks[:, 0] = 8 * rng.integers(0, 255, n) + 4
    for pos in (4, 32, 36):
        blocks[:, pos] = 8 * rng.integers(-4, 5, n)
    k = rng.integers(1, 64, (n, 3))
    blocks[np.arange(n)[:, None], k] += rng.integers(-9, 10, (n, 3))
    return blocks


def test_idct_intra_f64_is_the_fma_chain():
    rng = np.random.default_rng(5)
    blocks = _half_blocks(rng, 24)
    blocks[:4] = 0
    blocks[:4, 0] = [4, 2044, 1020, 12]
    coef = torch.from_numpy(blocks.reshape(1, 4, 6, 64))
    got = kernels.mpeg2_idct_intra(coef).numpy()[0]
    for idx in range(24):
        by, bx = divmod(idx, 6)
        want = _exact_idct_f64(blocks[idx].reshape(8, 8))
        np.testing.assert_array_equal(
            got[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8], want)


@pytest.fixture(scope="module")
def jax_idct():
    return jax.jit(jcodec._idct_spatial_jax)


@pytest.mark.parametrize("seed", range(3))
def test_idct_spatial_exact_halves_match_jax(seed, jax_idct):
    rng = np.random.default_rng(100 + seed)
    blocks = _half_blocks(rng, 6 * 8).reshape(6, 8, 64)
    got = mpeg2codec.idct_spatial(torch.from_numpy(blocks))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_idct(jnp.asarray(blocks))))


# ------------------------------------------------------------------ #
# every picture of the frame-picture fixtures


FRAME_STREAMS = {"synth_tff1.m2v": 7, "synth_tff0.m2v": 7,
                 "synth_odd.m2v": 7, "small.m2v": 16, "mpeg1.m1v": 12}
FIELD_STREAMS = {"synth_fields.m2v": 12, "fields.m2v": 20}
_DECODED = {}


def decoded(name: str):
    """Each picture of a fixture through both packages: the JAX
    package's planes in decode order, and the port's from the same
    parse output and the same (JAX) references.  Intra frame pictures
    without field DCT take the float64 route in both importers; here
    both take the float32 reconstruction (``reconstruct_picture``)."""
    if name in _DECODED:
        return _DECODED[name]
    pics, (w, h) = parse_all(name)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    ref_fwd = ref_bwd = None
    pend = None
    out = []
    for ptype, ps, tff, (yc, uc, vc, mbinfo) in pics:
        if ps in (1, 2):
            mb_rows = (h // 2 + 15) // 16
            if ptype == 1:
                # an intra field: the JAX function's CPU branch takes the
                # native IDCT there; the importer goldens hold it
                planes = jcodec.reconstruct_field_picture_jax(
                    yc, uc, vc, mbinfo, mb_w, mb_rows,
                    cur_parity=0 if ps == 1 else 1)
                jp = (tuple(np.asarray(p) for p in planes),
                      0 if ps == 1 else 1)
                port = None
            else:
                jp = jcodec.decode_field_step(ptype, ps, yc, uc, vc, mbinfo,
                                              mb_w, mb_rows, pend, ref_fwd,
                                              ref_bwd)
                tpend = (None if pend is None
                         else (pend[0], planes_t(pend[1]), pend[2]))
                port = mpeg2codec.decode_field_step(
                    ptype, ps, *(t(a) for a in (yc, uc, vc, mbinfo)),
                    mb_rows, tpend, planes_t(ref_fwd), planes_t(ref_bwd))
            out.append((ptype, ps, jp, port))
            if pend is None:
                pend = (jp[1], jp[0], ptype)
                continue
            frame = jcodec.weave_to_frame(pend, jp[0], jp[1], mb_w, mb_h)
            if pend[2] in (1, 2) or ptype in (1, 2):
                ref_fwd, ref_bwd = ref_bwd, frame
            pend = None
            continue
        if ptype in (1, 2, 4):
            fwd, bwd = (ref_bwd if ptype == 2 else None), None
        else:
            fwd, bwd = (ref_fwd if ref_fwd is not None else ref_bwd), ref_bwd
        jp = tuple(np.asarray(p) for p in jcodec.reconstruct_picture_jax(
            yc, uc, vc, mbinfo, mb_w, mb_h, fwd=fwd, bwd=bwd,
            top_field_first=bool(tff)))
        port = mpeg2codec.reconstruct_picture(
            *(t(a) for a in (yc, uc, vc, mbinfo)), planes_t(fwd),
            planes_t(bwd), bool(tff))
        out.append((ptype, tff, jp, port, mbinfo))
        if ptype in (1, 2, 4):
            ref_fwd, ref_bwd = ref_bwd, jp
    _DECODED[name] = out
    return out


@pytest.mark.parametrize("name,index", [(n, i) for n, c in
                                        FRAME_STREAMS.items()
                                        for i in range(c)])
def test_frame_picture_matches_reconstruct_picture_jax(name, index):
    pics = decoded(name)
    assert len(pics) == FRAME_STREAMS[name]
    _ptype, _tff, jp, port, _mbinfo = pics[index]
    assert_planes_equal(port, jp)


@pytest.mark.parametrize("name,index", [(n, i) for n, c in
                                        FIELD_STREAMS.items()
                                        for i in range(c)])
def test_field_picture_matches_decode_field_step(name, index):
    pics = decoded(name)
    assert len(pics) == FIELD_STREAMS[name]
    ptype, _ps, jp, port = pics[index]
    if ptype == 1:
        # intra fields: the float64 IDCT (test_intra_field_is_the_f64_idct)
        assert port is None
        return
    planes, parity = port
    assert parity == jp[1]
    assert_planes_equal(planes, jp[0])


def test_the_synthetic_streams_cover_every_macroblock_mode():
    """What the per-picture cases above exercise: every flag of the
    parse's macroblock records, both field orders, vectors that reach
    out of the frame."""
    seen = 0
    far = 0
    for name in ("synth_tff1.m2v", "synth_tff0.m2v", "synth_odd.m2v"):
        pics, (w, h) = parse_all(name)
        for _ptype, _ps, _tff, (_yc, _uc, _vc, mbinfo) in pics:
            seen |= int(np.bitwise_or.reduce(mbinfo[:, 0]))
            mv = np.abs(mbinfo[:, 1:9]) >> 1
            far = max(far, int(mv.max()))
    assert seen == 0x7F                  # intra .. dual prime
    assert far > 16                       # further than a macroblock
    tffs = {p[2] for p in parse_all("synth_tff0.m2v")[0][1:]} | {
        p[2] for p in parse_all("synth_tff1.m2v")[0][1:]}
    assert tffs == {0, 1}
    fields, _ = parse_all("synth_fields.m2v")
    f = 0
    for _ptype, _ps, _tff, (_yc, _uc, _vc, mbinfo) in fields:
        f |= int(np.bitwise_or.reduce(mbinfo[:, 0]))
    assert f & 128 and f & MBF_DUAL         # 16x8 and dual prime


@pytest.mark.parametrize("name", ["synth_fields.m2v", "fields.m2v"])
def test_intra_field_is_the_f64_idct(name):
    """An intra field goes through the float64 IDCT of its coded grid,
    as the JAX package's CPU path takes it."""
    pics, (w, h) = parse_all(name)
    mb_rows = (h // 2 + 15) // 16
    ptype, ps, _tff, (yc, uc, vc, mbinfo) = pics[0]
    assert ptype == 1
    (y, u, v), parity = mpeg2codec.decode_field_step(
        ptype, ps, *(t(a) for a in (yc, uc, vc, mbinfo)), mb_rows, None,
        None, None)
    assert parity == (0 if ps == 1 else 1)
    want = kernels.mpeg2_idct_intra_ref(t(yc[None, :mb_rows * 2]))[0]
    assert torch.equal(y, want)
    assert y.shape == (mb_rows * 16, (w + 15) // 16 * 16)
    for by in range(0, mb_rows * 2, 3):
        blk = yc[by, 0].reshape(8, 8)
        np.testing.assert_array_equal(y[by * 8:by * 8 + 8, :8].numpy(),
                                      _exact_idct_f64(blk))


@pytest.mark.parametrize("tff", [0, 1])
def test_dual_prime_vectors_match_jax(tff):
    rng = np.random.default_rng(tff)
    mv = rng.integers(-64, 64, (6, 5, 2)).astype(np.int32)
    dmv = rng.integers(-1, 2, (6, 5, 2)).astype(np.int32)
    jt, jb = jcodec._dual_prime_vectors_jax(jnp.asarray(mv),
                                            jnp.asarray(dmv), bool(tff))
    pt, pb = mpeg2codec.dual_prime_vectors(t(mv), t(dmv), bool(tff))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("seed", range(3))
def test_mc_pieces_match_jax_out_of_the_frame(seed):
    """The frame, field and dual-prime MC of one plane with vectors that
    reach well outside it, and the field-DCT deinterleave."""
    rng = np.random.default_rng(seed)
    h, w, mb = 32, 48, 16
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mv1 = rng.integers(-80, 80, (h // mb, w // mb, 2)).astype(np.int32)
    mv2 = rng.integers(-80, 80, (h // mb, w // mb, 2)).astype(np.int32)
    fmv = rng.integers(0, 2, (h // mb, w // mb)).astype(bool)
    fsel = rng.integers(0, 4, (h // mb, w // mb)).astype(np.int32)
    want = jcodec._mc_plane_jax(jnp.asarray(ref), jnp.asarray(mv1),
                                jnp.asarray(mv2), jnp.asarray(fmv),
                                jnp.asarray(fsel), mb)
    got = mpeg2codec.mc_plane(t(ref), t(mv1), t(mv2), t(fmv), t(fsel), mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vt, vb = jcodec._dual_prime_vectors_jax(jnp.asarray(mv1),
                                            jnp.asarray(mv2 % 3 - 1), True)
    want = jcodec._dual_prime_plane_jax(jnp.asarray(ref), jnp.asarray(mv1),
                                        vt, vb, mb)
    got = mpeg2codec.dual_prime_plane(t(ref), t(mv1), t(np.asarray(vt)),
                                      t(np.asarray(vb)), mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sp = rng.integers(-300, 300, (h, w)).astype(np.int32)
    fd = rng.integers(0, 2, (h // 16, w // 16)).astype(bool)
    want = jcodec._deinterleave_field_dct_jax(jnp.asarray(sp),
                                              jnp.asarray(fd))
    got = mpeg2codec.deinterleave_field_dct(t(sp), t(fd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chroma_vectors_round_toward_zero():
    mv = t(np.arange(-7, 8, dtype=np.int32))
    np.testing.assert_array_equal(
        mpeg2codec.chroma_mv(mv).numpy(),
        np.asarray(jcodec._chroma_mv_jax(jnp.arange(-7, 8))))


def test_skipped_and_intra_macroblocks_in_predicted_pictures():
    """Skipped macroblocks copy their prediction and intra ones in P and
    B pictures ignore it (the records the cases above decode)."""
    pics = decoded("synth_tff1.m2v")
    kinds = set()
    for ptype, _tff, _jp, _port, mbinfo in pics:
        flags = mbinfo[:, 0]
        if ptype in (2, 3):
            kinds |= {int(f) for f in flags & (MBF_INTRA | 8)}
    assert {MBF_INTRA, 8} <= kinds


@pytest.mark.parametrize("bad", ["dtype", "shape", "refs"])
def test_mpeg2_recon_checks_its_inputs(bad):
    pics, _ = parse_all("synth_tff1.m2v")
    yc, uc, vc, mbinfo = (t(a) for a in pics[1][3])
    fwd = tuple(torch.zeros(s, dtype=torch.uint8)
                for s in ((48, 64), (24, 32), (24, 32)))
    args = [yc, uc, vc, mbinfo, fwd, None, True]
    if bad == "dtype":
        args[0] = yc.to(torch.int16)
    elif bad == "shape":
        args[1] = uc[:-1]
    else:
        args[4] = fwd[:2] + (torch.zeros((24, 30), dtype=torch.uint8),)
    with pytest.raises(ValueError):
        kernels.mpeg2_recon(*args)


def test_mpeg2_idct_intra_checks_its_input():
    with pytest.raises(ValueError):
        kernels.mpeg2_idct_intra(torch.zeros((1, 2, 2, 63),
                                             dtype=torch.int32))


@pytest.mark.cuda
def test_mpeg2_kernels_match_their_plain_versions_on_cuda():
    """The two kernels against their plain versions on the card, on
    every picture of the synthetic streams (``chip_smoke.py`` phase 3
    does it for every fixture)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for name in ("synth_tff1.m2v", "synth_odd.m2v"):
        pics, _ = parse_all(name)
        ref = None
        for ptype, _ps, tff, arrays in pics:
            args = [t(a).to(dev) for a in arrays]
            fwd = ref if ptype != 1 else None
            got = kernels.mpeg2_recon(*args, fwd, fwd, bool(tff))
            want = kernels.mpeg2_recon_ref(*args, fwd, fwd, bool(tff))
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            ref = got
        coef = t(pics[0][3][0])[None].to(dev)
        assert torch.equal(kernels.mpeg2_idct_intra(coef),
                           kernels.mpeg2_idct_intra_ref(coef))
