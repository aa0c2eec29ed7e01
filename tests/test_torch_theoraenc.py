"""The port's Theora encoder on the CPU, byte for byte against the JAX
package's in-tree encoder (``tcforge_tpu/io/theoraenc.py``
``TheoraNativeEncoder``):

- the headers, and the packets of ``TheoraDeviceEncoder`` over a qi
  ladder, the GOP cadence and forced key frames, noise key frames whose
  levels reach the alphabet's ceiling, a pan and a negative diagonal,
  sparse inter frames, static scenes that decay to empty frames, cropped
  geometry;
- the plain ``theora_fdct_quant`` against ``_quantize_blocks`` bit for
  bit on a few hundred blocks, near-ties among them (blocks whose
  quotient lies within a rounding of .5 or of the dead zone's edge);
- the plain ``theora_me`` against ``_choose_modes``;
- the host coder's DC residuals and token writer against
  ``_dc_residuals`` and ``_token_events``/``_write_tokens`` on random
  levels, EOB runs longer than 4095 blocks among them;
- the reconstruction the encoder makes from its own records against the
  decode of the packet it wrote (the JAX encoder's loop) by the port's
  decoder and by the JAX decoder.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tcforge_tpu.io import theora as jth
from tcforge_tpu.io.theoraenc import TheoraNativeEncoder
from tcforge_tpu_torch.io import theoracodec as tc
from tcforge_tpu_torch.io import theoraenc as tenc
from tcforge_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def python_tokens():
    """The JAX decoder's Python token path, for this module's tests only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TCFORGE_NATIVE_THEORA_TOKENS", "0")
        yield


def smooth(rng, h, w, passes=2):
    base = rng.integers(0, 256, (h, w)).astype(float)
    for _ in range(passes):
        for ax in range(2):
            base = (base + np.roll(base, 1, ax) + np.roll(base, -1, ax)) / 3
    return base


def clip8(a):
    return np.clip(a, 0, 255).astype(np.uint8)


def pan(w, h, n, seed, dx=3, dy=2):
    """A smooth field moving by (dx, dy) a frame (negative for up and
    left), its chroma with it."""
    rng = np.random.default_rng(seed)
    m = 8 + 4 * n
    big = smooth(rng, h + 2 * m, w + 2 * m)
    cbig = smooth(rng, (h + 1) // 2 + m, (w + 1) // 2 + m)
    out = []
    for i in range(n):
        y0, x0 = m + dy * i, m + dx * i
        cy, cx = m // 2 + (dy * i) // 2, m // 2 + (dx * i) // 2
        out.append((clip8(big[y0:y0 + h, x0:x0 + w]),
                    clip8(cbig[cy:cy + (h + 1) // 2, cx:cx + (w + 1) // 2]),
                    clip8(255 - cbig[cy:cy + (h + 1) // 2,
                                     cx:cx + (w + 1) // 2])))
    return out


def noise(w, h, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2),
                          dtype=np.uint8),
             rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2),
                          dtype=np.uint8)) for _ in range(n)]


def sparse(w, h, n, seed):
    """A still frame with one changed 8x8 patch a frame."""
    rng = np.random.default_rng(seed)
    y, u, v = pan(w, h, 1, seed)[0]
    out = []
    for i in range(n):
        y = y.copy()
        by, bx = rng.integers(0, h // 8), rng.integers(0, w // 8)
        y[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = rng.integers(0, 256,
                                                               (8, 8))
        out.append((y, u, v))
    return out


def both(frames, w, h, force=(), **kw):
    """Each frame through both encoders: [(JAX packet, key), ...],
    [(port packet, key), ...] and the two encoders."""
    jenc = TheoraNativeEncoder(w, h, **kw)
    penc = tc.TheoraDeviceEncoder(w, h, device="cpu", **kw)
    want, got = [], []
    for i, (y, u, v) in enumerate(frames):
        want.append(jenc.encode(y, u, v, force_key=i in force))
        got.append(penc.encode(torch.from_numpy(y), torch.from_numpy(u),
                               torch.from_numpy(v), force_key=i in force))
    return want, got, jenc, penc


# ------------------------------------------------------------------ #
# packets


@pytest.mark.parametrize("qi", (0, 10, 20, 30, 45, 55, 63))
def test_the_packets_over_a_qi_ladder_are_the_jax_packets(qi):
    want, got, jenc, penc = both(pan(64, 48, 4, qi), 64, 48, qi=qi, gop=8)
    assert penc.headers == jenc.headers
    assert got == want


@pytest.mark.parametrize("gop,force", [(1, ()), (2, ()), (3, (4,)),
                                       (64, (2, 3))])
def test_the_gop_cadence_and_forced_keys_are_the_jax_encoders(gop, force):
    want, got, _, _ = both(pan(48, 32, 6, 7), 48, 32, force=force, qi=40,
                           gop=gop)
    assert got == want
    assert [k for _, k in got] == [k for _, k in want]


@pytest.mark.parametrize("qi", (63, 20))
def test_noise_key_frames_are_the_jax_packets(qi):
    want, got, _, _ = both(noise(48, 48, 3, qi), 48, 48, qi=qi, gop=2)
    assert got == want


@pytest.mark.parametrize("dx,dy", [(3, 2), (-3, -2), (-5, 3), (4, -1)])
def test_motion_in_every_direction_gives_the_jax_packets(dx, dy):
    want, got, jenc, _ = both(pan(80, 64, 4, 11, dx, dy), 80, 64, qi=45,
                              gop=16)
    assert got == want


def test_sparse_inter_frames_are_the_jax_packets():
    want, got, _, _ = both(sparse(64, 64, 5, 3), 64, 64, qi=50, gop=16)
    assert got == want


def test_a_static_scene_decays_to_empty_frames_as_in_jax():
    frames = pan(48, 32, 1, 5) * 4
    want, got, _, _ = both(frames, 48, 32, qi=30, gop=16)
    assert got == want and len(got[-1][0]) < len(got[0][0]) // 4


@pytest.mark.parametrize("w,h", [(50, 34), (17, 9), (33, 47)])
def test_cropped_geometry_is_the_jax_packets(w, h):
    want, got, _, _ = both(pan(w, h, 3, w), w, h, qi=45, gop=8)
    assert got == want


def test_the_device_planes_are_the_coded_planes():
    frames = pan(50, 34, 1, 2)
    jenc = TheoraNativeEncoder(50, 34)
    penc = tc.TheoraDeviceEncoder(50, 34, device="cpu")
    got = penc.device_planes(*(torch.from_numpy(p) for p in frames[0]))
    for g, w in zip(got, jenc._coded_planes(*frames[0])):
        np.testing.assert_array_equal(g.numpy(), w)


def test_bad_settings_raise_as_in_jax():
    for kw in ({"width": 0, "height": 8}, {"width": 8, "height": 8,
                                           "qi": 64}):
        with pytest.raises(ValueError):
            TheoraNativeEncoder(**kw)
        with pytest.raises(ValueError):
            tc.TheoraDeviceEncoder(device="cpu", **kw)


# ------------------------------------------------------------------ #
# the reconstruction from the encoder's records


@pytest.mark.parametrize("qi", (10, 45, 63))
def test_the_reconstruction_from_records_is_the_decoded_packet(qi):
    frames = pan(64, 48, 5, 20 + qi, -3, 2)
    penc = tc.TheoraDeviceEncoder(64, 48, qi=qi, gop=3, device="cpu")
    pdec = tc.TheoraDeviceDecoder(penc.headers, "cpu")
    jdec = jth.TheoraDecoder(penc.headers)
    for y, u, v in frames:
        pkt, _ = penc.encode(torch.from_numpy(y), torch.from_numpy(u),
                             torch.from_numpy(v))
        pdec.decode(pkt)
        jdec.decode(pkt)
        for mine, port, ref in zip(penc.dec.last, pdec.last, jdec.last):
            assert torch.equal(mine, port)
            np.testing.assert_array_equal(mine.numpy(), ref)


# ------------------------------------------------------------------ #
# the quantizer


def near_ties(rng, qmat: np.ndarray, qti: int, count: int) -> np.ndarray:
    """Residual blocks whose quotient lies near a rounding edge: flat
    blocks (a DC of 32 c, so c / 2 with qmat 64 is a tie) and random ones
    kept where some |t| lies within 1e-9 of .5 (intra) or .7 (inter)."""
    flat = np.repeat(np.arange(-40, 41)[:, None], 64, axis=1)
    picked = [flat]
    edge = 0.7 if qti else 0.5
    while sum(len(p) for p in picked) < count:
        r = rng.integers(-255, 256, (4000, 64))
        r[:, rng.integers(0, 64, 40)] //= 8
        x = tenc._fdct_blocks(r.reshape(-1, 8, 8).astype(np.float64))
        t = x.reshape(-1, 64) / qmat[None, :]
        frac = np.abs(t) - np.floor(np.abs(t))
        near = (np.abs(frac - edge) < 1e-2).any(axis=1)
        picked.append(r[near][:count])
    return np.concatenate(picked)[:count]


@pytest.mark.parametrize("qi", (0, 30, 63))
@pytest.mark.parametrize("qti,pli", [(0, 0), (0, 1), (1, 0), (1, 2)])
def test_the_plain_quantizer_is_numpys_einsum_bit_for_bit(qti, pli, qi):
    rng = np.random.default_rng(qti * 100 + pli * 10 + qi)
    jenc = TheoraNativeEncoder(16, 16, qi=qi)
    qmat = jenc.dec._qmat(qti, pli, qi).astype(np.float64)
    blocks = near_ties(rng, qmat, qti, 300)
    want = jenc._quantize_blocks(blocks.reshape(-1, 8, 8), qti, pli)
    qm = np.stack([np.stack([jenc.dec._qmat(q, p, qi) for p in range(3)])
                   for q in range(2)]).astype(np.int32)
    group = np.full(len(blocks), qti * 3 + pli, np.uint8)
    got = kernels.theora_fdct_quant(torch.from_numpy(blocks.astype(np.int16)),
                                    torch.from_numpy(group),
                                    torch.from_numpy(qm))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ #
# the mode decision


@pytest.mark.parametrize("content,qi", [("pan", 45), ("pan", 10),
                                        ("left", 63), ("noise", 30),
                                        ("sparse", 45)])
def test_the_plain_mode_decision_is_choose_modes(content, qi):
    w, h = 96, 64
    make = {"pan": lambda: pan(w, h, 2, 4),
            "left": lambda: pan(w, h, 2, 5, -4, -3),
            "noise": lambda: noise(w, h, 2, 6),
            "sparse": lambda: sparse(w, h, 2, 7)}[content]
    (y0, u0, v0), (y1, u1, v1) = make()
    jenc = TheoraNativeEncoder(w, h, qi=qi)
    jenc.encode(y0, u0, v0)
    planes = jenc._coded_planes(y1, u1, v1)
    modes, mvs, coded = jenc._choose_modes(planes)
    penc = tc.TheoraDeviceEncoder(w, h, qi=qi, device="cpu")
    got = kernels.theora_me(
        torch.from_numpy(planes[0].astype(np.uint8)),
        torch.from_numpy(jenc.dec.last[0]), penc._order, penc._lam,
        penc._sse_floor).numpy()
    ga = penc.arrays
    for mb, r in zip(jenc.geo.mb_order, ga.order):
        assert got[r, 0] == modes[mb]
        assert tuple(got[r, 1:3]) == tuple(mvs[mb])
        np.testing.assert_array_equal(got[r, 3:7],
                                      coded[ga.luma[r]].astype(np.int32))


@pytest.mark.parametrize("content", ["pan", "noise"])
def test_the_sad_table_is_the_lazy_sads(content):
    """The plain ``theora_me``'s two forms of the SADs (the card's table
    and the host's lazy one) agree at every vector."""
    make = pan(48, 32, 2, 8, -3, 2) if content == "pan" \
        else noise(48, 32, 2, 8)
    src = torch.from_numpy(make[1][0])
    ref = torch.from_numpy(make[0][0])
    table, lazy = tc.TableSad(src, ref), tc.LazySad(src, ref)
    for mb in range(6):
        for my in range(-31, 32):
            for mx in range(-31, 32):
                assert table(mb, mx, my) == lazy(mb, mx, my)


# ------------------------------------------------------------------ #
# the host coder


@pytest.mark.parametrize("seed", range(3))
def test_the_dc_residuals_are_the_jax_encoders(seed):
    rng = np.random.default_rng(seed)
    jenc = TheoraNativeEncoder(96, 64)
    geo, ga = jenc.geo, tc.GeoArrays(jenc.geo)
    dcq = rng.integers(-900, 900, geo.total_blocks).astype(np.int64)
    coded = rng.random(geo.total_blocks) < 0.7
    bclass = rng.integers(0, 3, geo.total_blocks).astype(np.uint8)
    want = jenc._dc_residuals(dcq, coded, bclass.astype(np.int32))
    resid = np.zeros(geo.total_blocks, np.int64)
    final = dcq.copy()
    coded8 = coded.astype(np.uint8)
    tc.library().tc_th_dc_residuals(
        dcq.ctypes.data, coded8.ctypes.data, bclass.ctypes.data,
        ga.plane_off.ctypes.data, ga.bw.ctypes.data, ga.bh.ctypes.data,
        resid.ctypes.data, final.ctypes.data)
    np.testing.assert_array_equal(np.where(coded, resid, 0),
                                  np.where(coded, want, 0))


@pytest.mark.parametrize("nb,density", [(30, 0.5), (600, 0.05),
                                        (5000, 0.001), (9000, 0.0)])
def test_the_token_writer_is_the_jax_token_stream(nb, density):
    rng = np.random.default_rng(nb)
    cz = np.where(rng.random((nb, 64)) < density,
                  rng.integers(-580, 581, (nb, 64)), 0).astype(np.int32)
    small = rng.random((nb, 64)) < density * 2
    cz = np.where(small & (cz == 0), rng.integers(-3, 4, (nb, 64)), cz)
    cz[rng.random(nb) < 0.3, 0] = 0
    islv = (rng.random(nb) < 0.3).astype(np.uint8)
    jenc = TheoraNativeEncoder(16, 16)
    jenc.geo.block_pos = np.zeros((nb, 3), np.int32)
    jenc.geo.block_pos[:, 0] = islv
    bw = tenc.BitWriter()
    bw.write(0x5A, 7)
    stream = jenc._token_events(cz, np.arange(nb))
    jenc._write_tokens(bw, stream)
    prefix = tenc.BitWriter()
    prefix.write(0x5A, 7)
    assert tc.write_tokens(cz, islv, prefix) == bw.getvalue()


def test_a_level_beyond_the_alphabet_raises():
    cz = np.zeros((2, 64), np.int32)
    cz[1, 3] = 581
    with pytest.raises(ValueError, match="alphabet"):
        tc.write_tokens(cz, np.zeros(2, np.uint8), tenc.BitWriter())


@pytest.mark.cuda
def test_the_encoder_on_cuda_gives_the_cpu_packets():
    """Runs where a card is present (``chip_smoke.py`` checks every
    kernel call of the ogv path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames = pan(96, 64, 4, 9, -2, 1)
    cpu = tc.TheoraDeviceEncoder(96, 64, device="cpu")
    card = tc.TheoraDeviceEncoder(96, 64, device="cuda")
    for y, u, v in frames:
        planes = [torch.from_numpy(p) for p in (y, u, v)]
        assert card.encode(*(p.cuda() for p in planes)) \
            == cpu.encode(*planes)


def test_the_copies_name_their_sources():
    root = Path(__file__).resolve().parents[1]
    for rel in ("io/theora.py", "io/theoraenc.py"):
        head = (root / "tcforge_tpu_torch" / rel).read_text().splitlines()[0]
        assert head.startswith(f"# Copied from tcforge_tpu/{rel} lines ")
