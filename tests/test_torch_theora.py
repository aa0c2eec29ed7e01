"""The port's Theora decode on the CPU, at tolerance 0 against the JAX
package's in-tree decoder (``tcforge_tpu/io/theora.py``) on its Python
token path (``TCFORGE_NATIVE_THEORA_TOKENS=0``):

- the fixtures: their pinned bytes, their budget, the modes and formats
  they hold (GOLDEN and 4MV macroblocks, 4:2:0, 4:2:2, 4:4:4, a cropped
  picture, repeat markers);
- the header parse and the tables both packages build from the same
  packets (every quantizer matrix, the loop-filter limits, the Huffman
  trees), the block geometry;
- per frame of every fixture: the host parse (flags, modes, vectors,
  block qi) against the JAX decoder's, the host coder's tokens and DC
  prediction (``csrc/theora_host.cpp``) against ``_decode_tokens`` and
  ``_predict_dc``, the plain ``theora_recon`` against ``_reconstruct``'s
  planes before the loop filter and the plain ``theora_loop_filter``
  against ``_loop_filter``, then whole streams frame by frame;
- the two plain versions on random records off the fixtures' path (every
  mode, 4MV in each format, coefficients that wrap numpy's int32 IDCT,
  random coded patterns and limits);
- a crafted setup header whose Huffman table has more leaves than the
  token alphabet, which the port refuses with ``ValueError``;
- the ``ogg`` importer against the JAX importer, the repeat marker that
  lands first in a batch among it.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tcforge_tpu.io import theora as jth
from tcforge_tpu.io import theoraenc as jenc
from tcforge_tpu_torch.io import theora as tth
from tcforge_tpu_torch.io import theoracodec as tc
from tcforge_tpu_torch.io.ogg import iter_pages, pages_to_packets
from tcforge_tpu_torch.ops import kernels

DATA = Path(__file__).resolve().parent / "data" / "theora"
FIXTURES = {
    "cif.ogv": "94c5463ed515f5929abc1f1d6a8fd2b803e2e6d8bd631e94de7ace2ff9da8af8",
    "cropped.ogv": "b4cbae077def27458ff11dc4209da12f4931ba3ba3de148574a887a760d1c700",
    "dup.ogv": "f851c7a4dc62c27799793c3061de72f0769c9c22857341648507d9aa5f85f4cc",
    "lowq.ogv": "ad03cebb54e81d993122423f442669137665e305f03ce1a4b876d85a8c49892a",
    "yuv420.ogv": "5da057f26b4399c203a3768452b0ccd50ed42506b67443d73ba9d62b05dd7fbc",
    "yuv422.ogv": "4df02014196e80a7cee1a0635a7c50fb37e7a8817ffc25e31ebd2a4e1daf1549",
    "yuv444.ogv": "cc3b47852d453942d6e6c6b283d709ed02117a2987449247b50e9160dd2a15f3"}
NAMES = sorted(FIXTURES)
BUDGET = 200_000


@contextlib.contextmanager
def python_tokens():
    """The JAX decoder's Python token path."""
    saved = os.environ.get("TCFORGE_NATIVE_THEORA_TOKENS")
    os.environ["TCFORGE_NATIVE_THEORA_TOKENS"] = "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["TCFORGE_NATIVE_THEORA_TOKENS"]
        else:
            os.environ["TCFORGE_NATIVE_THEORA_TOKENS"] = saved


@lru_cache(maxsize=None)
def packets(name: str):
    with open(DATA / name, "rb") as f:
        return [p for _, p in pages_to_packets(iter_pages(f))]


@lru_cache(maxsize=None)
def jax_trace(name: str):
    """The JAX decoder over a fixture, each data packet's stages kept:
    its parse, tokens, DCs, the planes before and after the loop filter
    and the picture."""
    pk = packets(name)
    dec = jth.TheoraDecoder(pk[:3])
    frames = []
    cur: dict = {}

    def keep(method, key, after=None):
        fn = getattr(dec, method)

        def call(*a):
            got = fn(*a)
            cur[key] = got.copy() if isinstance(got, np.ndarray) else got
            if after:
                after(*a)
            return got
        setattr(dec, method, call)
    keep("_read_block_flags", "coded")
    keep("_read_modes", "modes")
    keep("_read_motion", "mvs")
    keep("_read_block_qis", "qi_idx")
    keep("_decode_tokens", "tokens")
    predict = dec._predict_dc

    def predict_dc(coefs, coded, bclass):
        predict(coefs, coded, bclass)
        cur["coefs"] = coefs.copy()
        cur["bclass"] = np.asarray(bclass).copy()
    dec._predict_dc = predict_dc
    lf = dec._loop_filter

    def loop_filter(planes, coded, qi0):
        cur["before"] = [p.copy() for p in planes]
        cur["qi0"] = qi0
        cur["golden_in"] = dec.golden
        lf(planes, coded, qi0)
        cur["after"] = [p.copy() for p in planes]
    dec._loop_filter = loop_filter
    with python_tokens():
        for pkt in pk[3:]:
            cur = {"pkt": pkt, "last_in": dec.last}
            out = dec.decode(pkt)
            cur["out"] = out
            frames.append(cur)
    return dec, frames


def port_decoder(name: str) -> tc.TheoraDeviceDecoder:
    return tc.TheoraDeviceDecoder(packets(name)[:3], "cpu")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ #
# the fixtures


def test_the_fixtures_fit_their_budget():
    total = sum(f.stat().st_size for f in DATA.iterdir() if f.is_file())
    assert total <= BUDGET


@pytest.mark.parametrize("name", NAMES)
def test_the_fixtures_are_the_pinned_bytes(name):
    assert hashlib.sha256((DATA / name).read_bytes()).hexdigest() \
        == FIXTURES[name]


def test_the_fixtures_hold_golden_4mv_every_format_a_crop_and_repeats():
    modes, fmts, cropped, repeats = set(), set(), False, 0
    for name in NAMES:
        dec, frames = jax_trace(name)
        fmts.add(dec.info.pixel_format)
        cropped |= (dec.info.pic_w, dec.info.pic_h) != (dec.info.frame_w,
                                                        dec.info.frame_h)
        repeats += sum(1 for f in frames if not f["pkt"])
        for f in frames:
            modes |= {m for m in f.get("modes", {}).values() if m >= 0}
    assert {jth.MODE_GOLDEN, jth.MODE_GOLDEN_MV, jth.MODE_FOURMV,
            jth.MODE_INTRA, jth.MODE_MV, jth.MODE_LAST,
            jth.MODE_LAST2} <= modes
    assert fmts == {0, 2, 3} and cropped and repeats == 2


# ------------------------------------------------------------------ #
# headers, tables, geometry


@pytest.mark.parametrize("name", NAMES)
def test_the_identification_header_parses_as_in_jax(name):
    pk = packets(name)
    assert vars(tth.parse_ident(pk[0])) == vars(jth.parse_ident(pk[0]))


@pytest.mark.parametrize("name", NAMES)
def test_the_setup_tables_are_the_jax_tables(name):
    pk = packets(name)
    ours, ref = tth.parse_setup(pk[2]), jth.parse_setup(pk[2])
    for key in ("lflims", "acscale", "dcscale", "base_mats"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key))
    for key in ("qr_counts", "qr_sizes", "qr_bmis", "huff_leaves"):
        assert getattr(ours, key) == getattr(ref, key)


@pytest.mark.parametrize("qti,pli", [(q, p) for q in (0, 1)
                                     for p in (0, 1, 2)])
@pytest.mark.parametrize("name", NAMES)
def test_every_quantizer_matrix_is_the_jax_matrix(name, qti, pli):
    pk = packets(name)
    ours, ref = tth.parse_setup(pk[2]), jth.parse_setup(pk[2])
    for qi in range(64):
        np.testing.assert_array_equal(tth._build_qmat(ours, qti, pli, qi),
                                      jth._build_qmat(ref, qti, pli, qi))


@pytest.mark.parametrize("name", NAMES)
def test_the_block_geometry_is_the_jax_geometry(name):
    info = jth.parse_ident(packets(name)[0])
    ours = tth._Geometry(tth.parse_ident(packets(name)[0]))
    ref = jth._Geometry(info)
    np.testing.assert_array_equal(ours.coded_order, ref.coded_order)
    np.testing.assert_array_equal(ours.block_pos, ref.block_pos)
    assert ours.mb_order == ref.mb_order
    assert ours.mb_luma == ref.mb_luma and ours.mb_chroma == ref.mb_chroma
    assert ours.sb_blocks == ref.sb_blocks


# ------------------------------------------------------------------ #
# each frame's stages


@lru_cache(maxsize=None)
def port_records(name: str):
    """The port's host parse of each data packet (None for a repeat)."""
    dec = port_decoder(name)
    return [dec.parse(f["pkt"]) if f["pkt"] else None
            for f in jax_trace(name)[1]]


@pytest.mark.parametrize("name", NAMES)
def test_the_host_parse_gives_the_jax_flags_modes_vectors_and_qi(name):
    dec, frames = jax_trace(name)
    ga = tc.GeoArrays(dec.geo)
    for f, rec in zip(frames, port_records(name)):
        if rec is None:
            continue
        intra = "coded" not in f
        assert rec.intra == intra
        want_coded = np.ones(ga.total, bool) if intra else f["coded"]
        np.testing.assert_array_equal(rec.coded, want_coded)
        np.testing.assert_array_equal(rec.qiidx, f["qi_idx"])
        want = np.zeros_like(rec.mbrec)
        for (mbx, mby), mode in f.get("modes", {}).items():
            r = want[mby * ga.mbw + mbx]
            r[0] = mode
            if mode >= 0:
                mv = f["mvs"].get((mbx, mby), (0, 0))
                if mode == jth.MODE_FOURMV:
                    r[1:9] = np.asarray(mv).reshape(-1)
                else:
                    r[1:3] = mv
        np.testing.assert_array_equal(rec.mbrec, want)


@pytest.mark.parametrize("name", NAMES)
def test_the_host_coder_gives_the_jax_tokens_and_dcs(name):
    for f, rec in zip(jax_trace(name)[1], port_records(name)):
        if rec is not None:
            np.testing.assert_array_equal(rec.coefs, f["coefs"])


@pytest.mark.parametrize("name", NAMES)
def test_the_plain_recon_gives_the_planes_before_the_loop_filter(name):
    dec, frames = jax_trace(name)
    port = port_decoder(name)
    info = dec.info
    for f, rec in zip(frames, port_records(name)):
        if rec is None:
            continue
        last = golden = None
        if not rec.intra:
            last = tuple(t(p) for p in f["last_in"])
            golden = tuple(t(p) for p in (f["golden_in"] or f["last_in"]))
        got = kernels.theora_recon(
            t(rec.coefs), t(rec.coded), t(rec.qiidx), t(rec.mbrec),
            t(port.qmat_table(rec.qis)), last, golden, dec.geo.fmt,
            info.frame_w, info.frame_h)
        for g, w in zip(got, f["before"]):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", NAMES)
def test_the_plain_loop_filter_is_the_jax_loop_filter(name):
    dec, frames = jax_trace(name)
    info = dec.info
    for f in frames:
        if "before" not in f:
            continue
        lim = int(dec.setup.lflims[f["qi0"]])
        if lim <= 0:             # no filter at this qi
            for b, a in zip(f["before"], f["after"]):
                np.testing.assert_array_equal(a, b)
            continue
        coded = f.get("coded", np.ones(dec.geo.total_blocks, bool))
        got = kernels.theora_loop_filter(
            tuple(t(p) for p in f["before"]), t(coded.astype(np.uint8)), lim,
            dec.geo.fmt, info.frame_w, info.frame_h)
        for g, w in zip(got, f["after"]):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", NAMES)
def test_whole_streams_decode_as_in_jax_frame_by_frame(name):
    port = port_decoder(name)
    for f in jax_trace(name)[1]:
        got = port.decode(f["pkt"])
        want = f["out"]
        assert (got is None) == (want is None)
        if want is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------------ #
# the plain versions off the path


FORMATS = {0: "yuv420.ogv", 2: "yuv422.ogv", 3: "yuv444.ogv"}


def random_frame(rng, dec, big: bool):
    """Random records for an inter frame of ``dec``'s geometry: every
    mode, random vectors, coefficients (large ones wrap numpy's int32
    IDCT), random coded blocks and qi indexes of three qis."""
    geo = dec.geo
    coded = rng.random(geo.total_blocks) < 0.7
    mb_modes, mb_mvs = {}, {}
    for mb in geo.mb_order:
        mode = int(rng.integers(-1, 8))
        mb_modes[mb] = mode
        if mode == jth.MODE_FOURMV:
            mb_mvs[mb] = [tuple(int(v) for v in rng.integers(-31, 32, 2))
                          for _ in range(4)]
        elif mode in (jth.MODE_MV, jth.MODE_GOLDEN_MV, jth.MODE_LAST,
                      jth.MODE_LAST2):
            mb_mvs[mb] = tuple(int(v) for v in rng.integers(-31, 32, 2))
        else:
            mb_mvs[mb] = (0, 0)
    lim = 1 << 22 if big else 40
    coefs = rng.integers(-lim, lim, (geo.total_blocks, 64)).astype(np.int32)
    coefs[:, 8:] = np.where(rng.random((geo.total_blocks, 56)) < 0.8, 0,
                            coefs[:, 8:])
    qis = [int(v) for v in rng.integers(0, 64, 3)]
    qi_idx = rng.integers(0, 3, geo.total_blocks).astype(np.int32)
    return coded, mb_modes, mb_mvs, coefs, qis, qi_idx


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_the_plain_recon_on_random_records_is_reconstruct(fmt, seed):
    rng = np.random.default_rng(100 * fmt + seed)
    name = FORMATS[fmt]
    jdec = jth.TheoraDecoder(packets(name)[:3])
    port = port_decoder(name)
    geo, info = jdec.geo, jdec.info
    planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)
              for h, w in zip(geo.plane_h, geo.plane_w)]
    gold = [rng.integers(0, 256, (h, w), dtype=np.uint8)
            for h, w in zip(geo.plane_h, geo.plane_w)]
    jdec.last, jdec.golden = [p.copy() for p in planes], gold
    coded, mb_modes, mb_mvs, coefs, qis, qi_idx = random_frame(
        rng, jdec, big=seed % 2 == 1)
    before = []
    jdec._loop_filter = lambda pl, c, q: before.extend(p.copy() for p in pl)
    jdec._reconstruct(coefs.copy(), coded, None, qis, qi_idx, mb_modes,
                      mb_mvs, intra=False)
    mbrec = np.zeros((geo.mbw * geo.mbh, tc.MB_COLS), np.int32)
    port._fill_records(mbrec, mb_modes, mb_mvs)
    got = kernels.theora_recon(
        t(coefs), t(coded.astype(np.uint8)), t(qi_idx.astype(np.uint8)),
        t(mbrec), t(port.qmat_table(qis)), tuple(t(p) for p in planes),
        tuple(t(p) for p in gold), fmt, info.frame_w, info.frame_h)
    for g, w in zip(got, before):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_the_plain_loop_filter_on_random_planes_is_loop_filter(fmt, seed):
    rng = np.random.default_rng(200 + 10 * fmt + seed)
    jdec = jth.TheoraDecoder(packets(FORMATS[fmt])[:3])
    geo, info = jdec.geo, jdec.info
    planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)
              for h, w in zip(geo.plane_h, geo.plane_w)]
    coded = rng.random(geo.total_blocks) < (0.3, 0.6, 0.9, 1.0)[seed]
    qi0 = int(rng.integers(0, 64))
    jdec.setup.lflims = rng.integers(1, 64, 64).astype(np.int32)
    lim = int(jdec.setup.lflims[qi0])
    got = kernels.theora_loop_filter(tuple(t(p) for p in planes),
                                     t(coded.astype(np.uint8)), lim, fmt,
                                     info.frame_w, info.frame_h)
    with python_tokens():
        jdec._loop_filter(planes, coded, qi0)
    for g, w in zip(got, planes):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", range(5))
def test_the_plain_idct_wraps_as_numpys_int32(seed):
    rng = np.random.default_rng(seed)
    lim = (1 << 12, 1 << 16, 1 << 20, 1 << 24, 1 << 31)[seed]
    x = rng.integers(-lim, lim, (64, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        tc.idct_ref(torch.from_numpy(x).to(torch.int64)).numpy(),
        jth.idct8x8(x))


# ------------------------------------------------------------------ #
# a crafted setup header


def crafted_setup(tree) -> bytes:
    """The in-tree encoder's setup header with its first Huffman table
    replaced by ``tree`` (the setup grammar's bits, 0 a split and 1 a
    5-bit token)."""
    bw = jenc.BitWriter()
    bw.write(5, 3)
    for v in jenc._LFLIMS:
        bw.write(int(v), 5)
    for scale in (jenc._AC_SCALE, jenc._DC_SCALE):
        bw.write(9, 4)
        for v in scale:
            bw.write(int(v), 10)
    bw.write(2, 9)
    for bm in (jenc._BM_INTRA_Y, jenc._BM_INTRA_C, jenc._BM_INTER):
        for v in bm:
            bw.write(int(v), 8)

    def one_range(bmi):
        bw.write(bmi, 2)
        bw.write(62, 6)
        bw.write(bmi, 2)
    one_range(0)
    bw.write(1, 1)
    one_range(1)
    bw.write(0, 1)
    bw.write(1, 1)
    one_range(2)
    for _ in range(4):
        bw.write(0, 1)
    tree(bw)
    for g in range(5):
        for k in range(16):
            if g or k:
                jenc._emit_tree(bw, jenc._GROUP_CODES[g])
    return b"\x82theora" + bw.getvalue()


def balanced(bw, depth=6, level=0):
    if level == depth:
        bw.write(1, 1)
        bw.write(level % 32, 5)
        return
    bw.write(0, 1)
    balanced(bw, depth, level + 1)
    balanced(bw, depth, level + 1)


def skewed(bw, leaves=32, level=0):
    if level == leaves - 1:
        bw.write(1, 1)
        bw.write(level, 5)
        return
    bw.write(0, 1)
    bw.write(1, 1)
    bw.write(level, 5)
    skewed(bw, leaves, level + 1)


def test_a_huffman_table_beyond_the_alphabet_is_refused():
    """A balanced tree of 64 leaves: the JAX Python path takes it, the
    port's coder refuses it (a table holds at most the 32 tokens)."""
    pkt = crafted_setup(balanced)
    setup = jth.parse_setup(pkt)
    assert len(setup.huff_leaves[0]) == 64
    with pytest.raises(ValueError, match="32"):
        tc.HuffTables(tth.parse_setup(pkt).huff_leaves)
    enc = jenc.TheoraNativeEncoder(32, 32)
    with pytest.raises(ValueError, match="32"):
        tc.TheoraDeviceDecoder([enc.headers[0], enc.headers[1], pkt], "cpu")


def test_a_deep_table_within_the_alphabet_is_taken():
    """A skewed tree of 32 leaves, 31 bits deep (the JAX decoder's walked
    table): the coder takes it; one leaf more is refused."""
    pkt = crafted_setup(skewed)
    leaves = tth.parse_setup(pkt).huff_leaves
    assert max(n for _, n, _ in leaves[0]) == 31
    assert tc.HuffTables(leaves).handle
    bad = [list(x) for x in leaves]
    bad[0] = bad[0] + [(0, 3, 1)]
    with pytest.raises(ValueError):
        tc.HuffTables(bad)


# ------------------------------------------------------------------ #
# the ogg importer


def read_all(imp, n: int):
    out = []
    while True:
        got = imp.read_video_batch(n)
        if got is None:
            return out
        out.append({k: np.asarray(v) for k, v in got.items()})


def importers(name: str, monkeypatch):
    import tcforge_tpu.modules  # noqa: F401
    import tcforge_tpu_torch.modules  # noqa: F401
    from tcforge_tpu.core.job import Job as JJob
    from tcforge_tpu.modules.registry import ModuleKind as JK
    from tcforge_tpu.modules.registry import new_module as jnew
    from tcforge_tpu_torch.core.job import Job
    from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
    monkeypatch.setenv("TCFORGE_NATIVE_THEORA", "1")
    monkeypatch.setenv("TCFORGE_NATIVE_THEORA_TOKENS", "0")
    jimp = jnew(JK.DEMULTIPLEXOR, "ogg", JJob())
    jimp.open(str(DATA / name))
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "ogg", Job())
    imp.open(str(DATA / name))
    imp.start(torch.device("cpu"))
    return jimp, imp


@pytest.mark.parametrize("name,n", [
    (name, 3) for name in ("cropped.ogv", "yuv422.ogv", "yuv444.ogv",
                           "dup.ogv")] + [("dup.ogv", n) for n in (1, 2, 4, 5)])
def test_the_importer_gives_the_jax_importers_batches(name, n, monkeypatch):
    jimp, imp = importers(name, monkeypatch)
    want, got = read_all(jimp, n), read_all(imp, n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in "yuv":
            np.testing.assert_array_equal(g[k], w[k])


def test_a_repeat_first_in_a_batch_repeats_the_last_batchs_frame(
        monkeypatch):
    _, imp = importers("dup.ogv", monkeypatch)
    first, second = imp.read_video_batch(4), imp.read_video_batch(4)
    assert first["y"].shape[0] == 4 and second["y"].shape[0] == 4
    assert torch.equal(second["y"][0], first["y"][-1])


def test_the_importer_needs_start_or_a_card(monkeypatch):
    from tcforge_tpu_torch.core.job import Job
    from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "ogg", Job())
    imp.open(str(DATA / "yuv420.ogv"))
    assert imp.planned and (imp.width, imp.height) == (96, 80)
    with pytest.raises(RuntimeError, match="start"):
        imp.plan_batch(4)


@pytest.mark.cuda
def test_the_theora_kernels_match_their_plain_versions_on_cuda():
    """Runs where a card is present (``chip_smoke.py`` checks every
    kernel call of the card's paths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for name in NAMES:
        ours = tc.TheoraDeviceDecoder(packets(name)[:3], dev)
        ref = port_decoder(name)
        for pkt in packets(name)[3:]:
            got, want = ours.decode(pkt), ref.decode(pkt)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
