"""The port's MPEG-2 4:2:2 profile (422P) against the JAX package's, on the
CPU, function by function and through the MPEG importer.

At 4:2:2 a chroma macroblock is 8 wide and 16 tall, chroma vectors halve
the horizontal component alone (13818-2 7.6.3.7) and a frame picture's
field DCT covers chroma too.  Held at tolerance 0 against the JAX
package's CPU route:

- the chroma vector maps of the decoder (horizontal at index 0) and the
  encoder (horizontal at index 1), and the row-pair decimation into the
  4:2:0 chain (``chroma_422_to_420``, odd heights too);
- ``mpeg2_recon``'s plain version with ``chroma=2`` against the jitted
  ``_recon_picture_math`` (frame pictures: frame, field and dual-prime
  prediction, field DCT, intra macroblocks among predicted ones, vectors
  far past every edge, either field first) and ``_recon_field_core``
  (field pictures: 16x16, 16x8 and dual prime, either parity, reference
  fields of other heights), on random records from
  ``chip_smoke._records_422`` at several macroblock grids;
- ``mpeg2_idct_intra``'s plain version with field-DCT flags against
  ``reconstruct_intra_422``, whose CPU branch is the native float64 IDCT;
- the encoder's P, B and I pictures at 4:2:2 (``encode_p_math``,
  ``encode_b_math``, ``encode_intra_math``: the search, the prediction
  over 16x8 chroma tiles, the 8-block coder with its intra macroblocks)
  against ``_p_native``, ``_b_native`` and ``_intra_native``;
- the MPEG importer on 4:2:2 streams written at test time by the JAX
  package's ``Mpeg2FullEncoder(chroma=422)`` (frame and field pictures,
  gop_m 1, 2 and 3, alternate scan, rate control, a flush with B pictures
  waiting), kept at 4:2:2 under ``-V yuv422p`` and decimated otherwise,
  at batches of 1, 3 and 16 (a batch boundary inside a B run, a batch of
  one, a short last batch, an odd picture count), frame for frame
  against the JAX importer's ``_read_batch_422``.

The CLI cases (the 4:2:2 encode, ``-R``, ``-N``, the goldens) are in
``tests/test_torch_mpeg422_cli.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io import mpeg2codec as jcodec
from tcforge_tpu.io import mpeg2enc as jenc
from tcforge_tpu.io.mpeg2enc import Mpeg2FullEncoder as JEncoder
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import mpeg2codec, mpeg2enc
from tcforge_tpu_torch.io.mpeg2host import MBF_DUAL, MBF_FIELD_DCT
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels
from test_torch_mpeg_import import jax_native  # noqa: F401

# (mb_w, mb_h): one macroblock, a row of them, a small picture
GRIDS = [(1, 1), (3, 1), (4, 3)]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(np.ascontiguousarray(a))


def assert_planes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ #
# the chroma vectors and the decimation


@pytest.mark.parametrize("seed", range(3))
def test_decoder_chroma_vectors_match_jax(seed):
    rng = np.random.default_rng(seed)
    mv = rng.integers(-300, 301, (5, 7, 2)).astype(np.int32)
    mv[0, :, :] = np.arange(-3, 4)[:, None]
    got = mpeg2codec.chroma_mv_422(t(mv)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jcodec._chroma_mv_422_jax(j(mv))))
    np.testing.assert_array_equal(got, jcodec._chroma_mv_422(mv))


@pytest.mark.parametrize("seed", range(3))
def test_encoder_chroma_vectors_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    mv = rng.integers(-300, 301, (4, 6, 2)).astype(np.int32)
    mv[0, :, :] = np.arange(-3, 3)[:, None]
    got = mpeg2enc.chroma_mv_half_422(t(mv)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jenc._chroma_mv_half_422(j(mv))))
    y = np.zeros((16, 32), np.uint8)
    u = np.zeros((16, 16), np.uint8)
    cmv = jenc._enc_layout(y, u)[5]
    np.testing.assert_array_equal(got, cmv(mv))


def test_each_side_halves_its_horizontal_component():
    """The decoder's records hold (x, y), the encoder's vectors (y, x):
    each map halves x toward 0 and keeps y."""
    np.testing.assert_array_equal(
        mpeg2codec.chroma_mv_422(t(np.array([5, -5], np.int32))).numpy(),
        [2, -5])
    np.testing.assert_array_equal(
        mpeg2enc.chroma_mv_half_422(t(np.array([-5, 5], np.int32))).numpy(),
        [-5, 2])
    y, u = (torch.zeros((32, 32), dtype=torch.uint8),
            torch.zeros((32, 16), dtype=torch.uint8))
    assert mpeg2enc.chroma_params(y, u)[1] == (16, 8)
    assert mpeg2enc.chroma_params(y, u[:16])[1] == (8, 8)


@pytest.mark.parametrize("h", [1, 2, 3, 8, 17, 64])
def test_chroma_422_to_420_matches_jax(h):
    rng = np.random.default_rng(h)
    plane = rng.integers(0, 256, (h, 11), dtype=np.uint8)
    want = jcodec.chroma_422_to_420(plane)
    np.testing.assert_array_equal(
        mpeg2codec.chroma_422_to_420(t(plane)).numpy(), want)
    batch = np.stack([plane, plane[::-1]])
    got = mpeg2codec.chroma_422_to_420(t(batch)).numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1],
                                  jcodec.chroma_422_to_420(plane[::-1]))


# ------------------------------------------------------------------ #
# frame and field pictures on random records

FRAME_FORMS = {
    # the flags a form keeps, and whether its vectors reach far out
    "mix": (1 | 2 | 4 | 16 | 32 | 64, True),
    "dual": (2 | 64, False),
    "field_mv": (2 | 4 | 16, False),
    "field_dct": (2 | 4 | 32, True),
    "far": (1 | 2 | 4, True)}
FIELD_FORMS = {"mix": (1 | 2 | 4 | 64 | 128, True),
               "dual": (2 | 64, False),
               "16x8": (2 | 4 | 128, True),
               "far": (1 | 2 | 4, True)}


def picture_inputs(seed: int, mb_w: int, mb_h: int, field: bool, keep: int,
                   far: bool):
    """Coefficient grids of one 4:2:2 picture and its records, the flags
    cut to ``keep`` (dual prime always with a forward vector), far
    vectors cut to near ones unless ``far``."""
    rng = np.random.default_rng(seed)

    def coefs(rows, cols):
        c = rng.integers(-60, 61, (rows, cols, 64)).astype(np.int32)
        c[rng.random(c.shape) < 0.7] = 0
        return c

    yc, uc, vc = (coefs(2 * mb_h, 2 * mb_w), coefs(2 * mb_h, mb_w),
                  coefs(2 * mb_h, mb_w))
    info = chip_smoke._records_422(rng, mb_h * mb_w, field)
    info[:, 0] &= keep
    info[:, 0] |= np.where((info[:, 0] & 64) != 0, 2, 0).astype(np.int32)
    if not far:
        info[:, 1:9] = np.clip(info[:, 1:9], -40, 40)
        dual = (info[:, 0] & 64) != 0
        info[dual, 3:5] = np.clip(info[dual, 3:5], -1, 1)
    return yc, uc, vc, info


def frame_planes(rng, rows: int, mb_w: int):
    return (rng.integers(0, 256, (rows * 16, mb_w * 16), dtype=np.uint8),
            rng.integers(0, 256, (rows * 16, mb_w * 8), dtype=np.uint8),
            rng.integers(0, 256, (rows * 16, mb_w * 8), dtype=np.uint8))


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("form", sorted(FRAME_FORMS))
def test_frame_picture_matches_recon_picture_math(form, grid, tff):
    mb_w, mb_h = grid
    keep, far = FRAME_FORMS[form]
    yc, uc, vc, info = picture_inputs(len(form) + mb_w, mb_w, mb_h, False,
                                      keep, far)
    rng = np.random.default_rng(mb_h)
    fwd, bwd = frame_planes(rng, mb_h, mb_w), frame_planes(rng, mb_h, mb_w)
    any_dual = bool((info[:, 0] & MBF_DUAL).any())
    want = jcodec._recon_jax_core(
        j(yc), j(uc), j(vc), j(info), mb_w, mb_h, True, True, tff, any_dual,
        2, tuple(map(j, fwd)), tuple(map(j, bwd)))
    got = kernels.mpeg2_recon(t(yc), t(uc), t(vc), t(info),
                              tuple(map(t, fwd)), tuple(map(t, bwd)), tff,
                              chroma=2)
    assert got[1].shape == (mb_h * 16, mb_w * 8)
    assert_planes_equal(got, want)


@pytest.mark.parametrize("grid", GRIDS)
def test_frame_picture_without_references_matches_jax(grid):
    """An intra picture through the float32 reconstruction (the field-DCT
    deinterleave of its chroma rows included) and a P picture with no
    anchor (no prediction at all)."""
    mb_w, mb_h = grid
    yc, uc, vc, info = picture_inputs(7, mb_w, mb_h, False, 1 | 2 | 32,
                                      False)
    zero = (jnp.zeros((mb_h * 16, mb_w * 16), jnp.uint8),
            jnp.zeros((mb_h * 16, mb_w * 8), jnp.uint8),
            jnp.zeros((mb_h * 16, mb_w * 8), jnp.uint8))
    want = jcodec._recon_jax_core(j(yc), j(uc), j(vc), j(info), mb_w, mb_h,
                                  False, False, True, False, 2, zero, zero)
    got = kernels.mpeg2_recon(t(yc), t(uc), t(vc), t(info), None, None,
                              True, chroma=2)
    assert_planes_equal(got, want)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("form", sorted(FIELD_FORMS))
def test_field_picture_matches_recon_field_core(form, grid, parity):
    """Reference fields of other heights than the picture's (coordinates
    clip to each field's own size), read in place as a frame's lines of
    one parity."""
    mb_w, mb_rows = grid
    keep, far = FIELD_FORMS[form]
    yc, uc, vc, info = picture_inputs(len(form) * 3 + mb_w, mb_w, mb_rows,
                                      True, keep, far)
    rng = np.random.default_rng(parity + mb_w)
    pairs = []
    for rows in (2 * mb_rows + 1, 2 * mb_rows - 1 or 1):
        fr = frame_planes(rng, rows, mb_w)
        pairs.append((tuple(p[0::2] for p in fr), tuple(p[1::2] for p in fr)))
    any_dual = bool((info[:, 0] & MBF_DUAL).any())
    want = jcodec._recon_field_core(
        j(yc), j(uc), j(vc), j(info), mb_w, mb_rows, True, True, any_dual,
        parity, 2, *(tuple(tuple(map(j, f)) for f in pair) for pair in pairs))
    got = kernels.mpeg2_recon(
        t(yc), t(uc), t(vc), t(info),
        *(tuple(tuple(torch.from_numpy(p) for p in f) for f in pair)
          for pair in pairs), True, field_parity=parity, chroma=2)
    assert got[1].shape == (mb_rows * 16, mb_w * 8)
    assert_planes_equal(got, want)


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("grid", GRIDS)
def test_intra_picture_matches_reconstruct_intra_422(grid, share,
                                                     jax_native):
    """The float64 IDCT with the field-DCT deinterleave folded into its
    store, against the JAX function's native IDCT and deinterleave."""
    mb_w, mb_h = grid
    rng = np.random.default_rng(int(share * 10) + mb_w)
    yc, uc, vc, info = picture_inputs(int(share * 10), mb_w, mb_h, False, 0,
                                      False)
    yc, uc, vc = (rng.integers(-400, 401, c.shape).astype(np.int32)
                  for c in (yc, uc, vc))
    info[:, 0] = 1 | np.where(rng.random(mb_h * mb_w) < share,
                              MBF_FIELD_DCT, 0)
    want = jcodec.reconstruct_intra_422(yc, uc, vc, info, mb_w, mb_h)
    got = mpeg2codec.reconstruct_intra_422(t(yc), t(uc), t(vc), t(info))
    assert_planes_equal(got, want)


@pytest.mark.parametrize("bad", ["chroma", "grid", "ref"])
def test_mpeg2_recon_checks_its_4_2_2_inputs(bad):
    yc, uc, vc, info = (t(a) for a in picture_inputs(1, 2, 2, False, 3,
                                                     False))
    fwd = tuple(torch.zeros(s, dtype=torch.uint8)
                for s in ((32, 32), (32, 16), (32, 16)))
    args, kw = [yc, uc, vc, info, fwd, None, True], dict(chroma=2)
    if bad == "chroma":
        kw["chroma"] = 3
    elif bad == "grid":
        args[1], args[2] = uc[:2], vc[:2]           # a 4:2:0 chroma grid
    else:
        args[4] = fwd[:1] + (fwd[1][:16],) * 2     # 4:2:0 chroma planes
    with pytest.raises(ValueError):
        kernels.mpeg2_recon(*args, **kw)


@pytest.mark.parametrize("bad", ["dtype", "tiling"])
def test_mpeg2_idct_intra_checks_its_field_dct(bad):
    coef = torch.zeros((1, 4, 4, 64), dtype=torch.int32)
    fd = torch.zeros((1, 2, 2), dtype=torch.bool)
    if bad == "dtype":
        fd = fd.to(torch.uint8)
    else:
        fd = torch.zeros((1, 2, 3), dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.mpeg2_idct_intra(coef, field_dct=fd)


# ------------------------------------------------------------------ #
# the encoder's pictures at 4:2:2

W, H = 96, 64


def enc_planes(kind: str, seed: int, shift=(0, 0)):
    """(y, u, v) 4:2:2 planes: smooth waves with grain moved by ``shift``,
    or uniform noise (where the search finds nothing, so P pictures code
    intra macroblocks)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return tuple(rng.integers(0, 256, (H, w), dtype=np.uint8)
                     for w in (W, W // 2, W // 2))
    yy, xx = np.mgrid[0:H, 0:W]
    yy, xx = yy + shift[0], xx + shift[1]
    base = 128 + 60 * np.sin(xx / 7.0 + seed) + 50 * np.cos(yy / 5.0)

    def plane(a):
        return np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8)

    return (plane(base), plane(base[:, ::2] * 0.5 + 64),
            plane(128 + 40 * np.cos(xx[:, ::2] / 4.0 + yy[:, ::2] / 9.0)))


CONTENTS = ["smooth", "noise", "moved"]


def pair(kind: str, seed: int):
    """(reference, current) 4:2:2 frames of ``kind``."""
    if kind == "moved":
        return enc_planes("smooth", seed), enc_planes("smooth", seed, (3, -5))
    if kind == "noise":
        return enc_planes("smooth", seed), enc_planes("noise", seed + 1)
    return enc_planes("smooth", seed), enc_planes("smooth", seed + 1)


@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("qs", [1, 8, 31])
@pytest.mark.parametrize("kind", CONTENTS)
def test_p_picture_matches_p_native(kind, qs, alt, jax_native):
    ref, cur = pair(kind, qs)
    nat = jenc._native_blocks()
    want = jenc._p_native(nat, *cur, ref, qs, 8, alt, False)
    got = mpeg2enc.encode_p_math(*map(t, cur), tuple(map(t, ref)), qs, 8,
                                 alt)
    assert got[1].shape == (W * H // 256, 8, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_p_pictures_code_intra_macroblocks():
    """The noise case above takes the intra macroblocks' path: both
    chroma blocks of each plane recoded intra in the same launch."""
    ref, cur = pair("noise", 8)
    mbinfo = mpeg2enc.encode_p_math(*map(t, cur), tuple(map(t, ref)), 8,
                                    8)[0]
    assert int((mbinfo[:, 0] == 1).sum()) > 0


@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("qs", [1, 8, 31])
@pytest.mark.parametrize("kind", CONTENTS)
def test_b_picture_matches_b_native(kind, qs, alt, jax_native):
    fwd, cur = pair(kind, qs + 40)
    bwd = enc_planes("smooth", qs + 60, (-2, 4))
    nat = jenc._native_blocks()
    want = jenc._b_native(nat, *cur, fwd, bwd, qs, 8, alt, False)
    got = mpeg2enc.encode_b_math(*map(t, cur), tuple(map(t, fwd)),
                                 tuple(map(t, bwd)), qs, 8, alt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("qs", [1, 8, 31])
def test_intra_picture_matches_intra_native(qs, jax_native):
    cur = enc_planes("smooth", qs)
    nat = jenc._native_blocks()
    want = jenc._intra_native(nat, *cur, qs, qs == 8, False)
    got = mpeg2enc.encode_intra_math(*map(t, cur), qs, qs == 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ #
# the importer on 4:2:2 streams


def stream_frames(n: int, w: int, h: int, seed: int):
    """Display-order 4:2:2 frames: a moving block over grain, a cut half
    way, noise patches that P pictures code intra."""
    rng = np.random.default_rng(seed)
    out = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        scene = i >= n // 2
        base = (128 + 60 * np.sin((xx + 3 * i) / (7.0 + 5 * scene))
                + 50 * np.cos((yy + 2 * i) / 5.0))
        y = np.clip(base + rng.normal(0, 5, (h, w)), 0, 255)
        bx, by = (4 * i) % (w - 32), (2 * i) % (h - 32)
        y[by:by + 32, bx:bx + 32] = rng.integers(0, 256, (32, 32))
        u = np.clip(128 + 30 * np.sin((xx[:, ::2] + i) / 9.0)
                    + rng.normal(0, 3, (h, w // 2)), 0, 255)
        v = np.clip(128 + 30 * np.cos((yy[:, ::2] + 2 * i) / 6.0)
                    + rng.normal(0, 3, (h, w // 2)), 0, 255)
        out.append(tuple(p.astype(np.uint8) for p in (y, u, v)))
    return out


# name -> (frames, width, height, the JAX encoder's settings)
STREAMS = {
    "gop_m1": (9, 176, 144, dict(gop_n=4, gop_m=1, qscale=5)),
    "gop_m2_rc": (10, 176, 144, dict(gop_n=6, gop_m=2, rate_control=True,
                                     bitrate_kbps=2000)),
    "gop_m3": (9, 176, 144, dict(gop_n=6, gop_m=3, qscale=4)),
    "fields_m1": (7, 176, 160, dict(gop_n=4, gop_m=1, fields=True,
                                    qscale=6)),
    "fields_m3_bff": (9, 176, 160, dict(gop_n=6, gop_m=3, fields=True,
                                        top_field_first=False, qscale=5)),
    "alt_scan": (9, 176, 144, dict(gop_n=6, gop_m=3, alt_scan=True,
                                   qscale=3)),
    "flush_bs": (8, 176, 144, dict(gop_n=12, gop_m=3, qscale=6)),
}


@pytest.fixture(scope="module")
def streams(tmp_path_factory, jax_native):
    """Each stream written by the JAX package's encoder: name -> path."""
    tmp = tmp_path_factory.mktemp("m422")
    out = {}
    for k, (name, (n, w, h, kw)) in enumerate(STREAMS.items()):
        enc = JEncoder(w, h, fps=25.0, chroma=422, **kw)
        path = tmp / f"{name}.m2v"
        with open(path, "wb") as f:
            for fr in stream_frames(n, w, h, seed=k):
                f.write(enc.push_frame(*fr))
            f.write(enc.flush())
        out[name] = path
    return out


def decode_both(path, keep: bool, batch: int):
    """Every batch of the JAX importer and of the port's (on the CPU)."""
    jjob = JJob()
    if keep:
        jjob.im_colorspace = JImageFormat.YUV422P
    jimp = jax_new_module(JKind.DEMULTIPLEXOR, "mpeg", jjob)
    jimp.open(str(path))
    pimp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg",
                      Job(im_colorspace=(ImageFormat.YUV422P if keep
                                         else ImageFormat.YUV420P)), "")
    pimp.open(str(path))
    pimp.start(torch.device("cpu"))
    assert pimp.format.value == jimp.format.value
    got, want = [], []
    while True:
        a, b = jimp.read_video_batch(batch), pimp.read_video_batch(batch)
        if a is None or b is None:
            assert a is None and b is None
            break
        want.append(a)
        got.append(b)
    jimp.close()
    pimp.close()
    return got, want


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_importer_matches_the_jax_importer(name, keep, batch, streams):
    got, want = decode_both(streams[name], keep, batch)
    n, w, h, _ = STREAMS[name]
    assert sum(b["y"].shape[0] for b in got) == n
    for g, wb in zip(got, want):
        assert g["u"].shape[1:] == ((h if keep else h // 2), w // 2)
        for key in "yuv":
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(wb[key]))


def test_every_intra_frame_picture_takes_the_f64_idct(streams, monkeypatch):
    """A 4:2:2 intra frame picture goes to ``reconstruct_intra_422`` one
    by one (no batched intra run), the others to the float32
    reconstruction with ``chroma=2``."""
    seen = []
    real_intra = mpeg2codec.reconstruct_intra_422
    real_recon = mpeg2codec.reconstruct_picture

    def intra(*a):
        seen.append("intra")
        return real_intra(*a)

    def recon(*a, **kw):
        seen.append(kw["chroma"])
        return real_recon(*a, **kw)

    monkeypatch.setattr(mpeg2codec, "reconstruct_intra_422", intra)
    monkeypatch.setattr(mpeg2codec, "reconstruct_picture", recon)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", Job(), "")
    imp.open(str(streams["gop_m1"]))
    imp.start(torch.device("cpu"))
    while imp.read_video_batch(16) is not None:
        pass
    assert seen.count("intra") == 3 and set(seen) == {"intra", 2}
