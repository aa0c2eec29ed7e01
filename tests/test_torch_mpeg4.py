"""The port's MPEG-4 part 2 (DivX/Xvid) decode from AVI, on the CPU.

The golden is the JAX CLI's own route on the CPU: its avi importer with
``TCFORGE_NATIVE_MPEG4=1`` decodes through the numpy ``Mpeg4Decoder``
(``decode_frames`` and ``flush``); without it the JAX package would
take its FFmpeg bridge where one is built, which the card's machine has
not.  Held at tolerance 0 against it:

- the plain XVID IDCT (``xvid_idct_ref``) against the numpy
  ``_xvid_idct`` on full-range blocks (where the JAX device form's int32
  wraps and the port, like numpy, does not);
- every VOP's reconstruction (``mpeg4_recon_ref``,
  ``mpeg4_idct_intra_ref``) against the numpy decoder's planes, the
  whole coded grid;
- whole streams through the port's importer against the JAX importer at
  several batch sizes, and against the JAX device form
  (``mpeg4jax.decode_stream_jax``);
- the CLI against the JAX CLI on ``chip_smoke.AVI_GOLDEN``, each
  output's SHA-256 pinned for ``chip_smoke.py`` to check on the card;
- the refusals by name, one reconstruction launch per VOP and no pixel
  route of the numpy decoder on the path, ``divxkey``.

The fixtures are files (``tests/data/mpeg4/make_streams.py``), pinned by
SHA-256 here.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.io import mpeg4dec as jdec
from tcforge_tpu.io.avi import AviAudioStream, AviVideoStream, AviWriter
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import new_module as jax_new_module
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io import mpeg4dec as tdec
from tcforge_tpu_torch.io import mpeg4recon
from tcforge_tpu_torch.io.avi import AviReader
from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
from tcforge_tpu_torch.ops import kernels
from test_torch_engine import run_cli

DATA = chip_smoke.MPEG4_DATA
FIXTURES = {
    "divx.avi":
        "980b0748a3f4cb5c1570cdb42041caa8bab7101560735f57d626acf43d33cde1",
    "divx_il.avi":
        "81226f8f9fa8e32dc3f88c6fd536318cb08ce0fc7378619a3d53330ae03c2f0a",
    "divx_qpel.avi":
        "8be92df517bf658714196e0d4c14256153b3d255b1b698551340d233cb8de11c",
    "drop.avi":
        "27cf4f5540ec4e5d0e03d6aa9ba6c8bdf18a9209f628506e7d7fdbbd052006b4",
    "il_small.avi":
        "3ec614aa0a4365a458ba78a70eb5e09d2725447f8d8dc231becccc35ad289779",
    "ildct.avi":
        "654027885f403e296d8c65f24a68c05efcf3957d907e249797f8608d0953ba28",
    "lzo.avi":
        "917759237b1a2e31a31556d6c0006f395de227c41187ed4886db804ffa009fc6",
    "native.avi":
        "6ef6465a290cce8062445a4672ec4846ceda5b25d3ee1d60ac2419d280a79eec",
    "odd.avi":
        "c5b3ecb1dfaeee958eaede3a1d0999b1bc95d7a10ef5f7304f10dc6b81153cdd",
    "packed.avi":
        "d4da3a97646d7c503ffe2a0c6b48da08c8f46bc84323210486c0a3c7bf3e2f52",
    "qpel.avi":
        "a5d018517c30f8a07a352a934279dc57093a2ca3bc2c87984f95cc8d8bfc7a3a",
    "qpel_il.avi":
        "e1a1b48beca3909e9af88922cca9560d1109886201f5e37a069b89687a1c7f29",
    "qpel_small.avi":
        "4cf9627e8b97ccee0b0ad491ba247a117c581348fcfef6ac8bcbbbfc410c8807",
    "small.avi":
        "2fa118af66be9b097af15ed5390b0c2f224398c29833353f04481903b165a155",
    "yuy2.avi":
        "a2fec86e3803f55e6cfeeaba0f591a872ac906f66feb82bc18c8c5c9cad502eb",
}
# the MPEG-4 streams small enough for the numpy decoder here
STREAMS = ["small.avi", "odd.avi", "native.avi", "drop.avi", "packed.avi"]


@pytest.fixture
def numpy_route(monkeypatch):
    """The JAX avi importer's numpy MPEG-4 route (the JAX CLI's here)."""
    monkeypatch.setenv("TCFORGE_NATIVE_MPEG4", "1")
    monkeypatch.delenv("TCFORGE_MPEG4_JAX", raising=False)


def chunks(name: str):
    with AviReader(str(DATA / name)) as r:
        return [r.read_video_frame(i)[0] for i in range(r.video_frames)]


def jax_frames(name: str, batch: int = 16):
    """Every frame the JAX importer gives on its numpy route."""
    import tcforge_tpu.modules  # noqa: F401
    imp = jax_new_module(JKind.DEMULTIPLEXOR, "avi", JJob())
    imp.open(str(DATA / name))
    out = []
    while True:
        b = imp.read_video_batch(batch)
        if b is None:
            break
        out += [tuple(b[k][i] for k in "yuv") for i in range(len(b["y"]))]
    imp.close()
    return out


_JAX_FRAMES = {}


@pytest.fixture
def jax_decoded(numpy_route):
    def get(name):
        if name not in _JAX_FRAMES:
            _JAX_FRAMES[name] = jax_frames(name)
        return _JAX_FRAMES[name]
    return get


def port_importer(name: str, **job):
    import tcforge_tpu_torch.modules  # noqa: F401
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job(**job))
    imp.open(str(DATA / name))
    imp.start(torch.device("cpu"))
    return imp


def port_frames(name: str, batch: int):
    imp = port_importer(name)
    out = []
    while True:
        b = imp.read_video_batch(batch)
        if b is None:
            break
        out += [tuple(b[k][i].numpy() for k in "yuv")
                for i in range(b["y"].shape[0])]
    imp.close()
    return out


def assert_same_frames(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for p in range(3):
            assert np.array_equal(np.asarray(g[p]), np.asarray(w[p])), \
                f"frame {i} plane {p}"


# ------------------------------------------------------------------ #
# the fixtures

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_pinned(name):
    digest = hashlib.sha256((DATA / name).read_bytes()).hexdigest()
    assert digest == FIXTURES[name]


def test_fixture_directory_stays_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 850_000


# ------------------------------------------------------------------ #
# the IDCT

@pytest.mark.parametrize("lo,hi", [(-2048, 2047), (-300, 299), (-64, 63)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xvid_idct_ref_matches_numpy(lo, hi, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(lo, hi + 1, (4000, 8, 8))
    # sparse blocks too, as the streams' are
    blocks[::2] *= rng.random((2000, 8, 8)) < 0.1
    got = mpeg4recon.xvid_idct_ref(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, jdec._xvid_idct(blocks))


def test_the_jax_device_idct_wraps_where_numpy_does_not():
    """The JAX device form's int32 column pass wraps once |d +- c| >
    92,681; the JAX CLI decodes through numpy, and the port follows it."""
    from tcforge_tpu.io.mpeg4jax import xvid_idct_jax
    rng = np.random.default_rng(5)
    blocks = rng.integers(-2048, 2048, (2000, 8, 8))
    want = jdec._xvid_idct(blocks)
    jax_out = np.asarray(xvid_idct_jax(blocks.astype(np.int32)))
    assert (jax_out != want).any(axis=(1, 2)).sum() > 0
    got = mpeg4recon.xvid_idct_ref(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ #
# each VOP

def test_stage_plan_packs_a_macroblock_record():
    dec = tdec.Mpeg4Decoder()
    plans = [p for c in chunks("small.avi")[:3] if c
             for p in dec.parse_plans(bytes(c))]
    p = plans[1]
    rec = mpeg4recon.stage_plan(p)
    nmb = p["mbw"] * p["mbh"]
    assert rec.shape == (nmb, mpeg4recon.REC) and rec.dtype == np.int16
    assert np.array_equal(rec[:, :384].reshape(nmb, 6, 8, 8), p["blocks"])
    assert np.array_equal(rec[:, 384:392].reshape(nmb, 4, 2), p["mvs4"])
    assert np.array_equal(rec[:, 392:400].reshape(nmb, 4, 2), p["bmvs4"])
    assert np.array_equal(rec[:, 400:402], p["cmv"])
    assert np.array_equal(rec[:, 402:404], p["bcmv"])
    assert np.array_equal(rec[:, 404], p["use_f"])
    assert np.array_equal(rec[:, 405], p["use_b"])
    assert not rec[:, 406:].any()


@pytest.mark.parametrize("name", ["small.avi", "odd.avi", "native.avi",
                                  "drop.avi"])
def test_each_vop_matches_the_numpy_decoder(name):
    """VOP by VOP in decode order: an anchor's whole coded grid against
    the numpy decoder's reference planes, a B-VOP's frame against the
    frame it displays."""
    ref, mine = jdec.Mpeg4Decoder(), tdec.Mpeg4Decoder()
    ra = rb = None
    kinds = set()
    for c in chunks(name):
        if not c:
            continue
        shown = ref.decode_frames(bytes(c))
        (plan,) = mine.parse_plans(bytes(c))
        vop = torch.from_numpy(mpeg4recon.stage_plan(plan))
        mbw, kind = plan["mbw"], plan["kind"]
        kinds.add(kind)
        if kind == "I":
            rec = mpeg4recon.mpeg4_idct_intra_ref(vop, mbw)
        elif kind == "P":
            rec = mpeg4recon.mpeg4_recon_ref(vop, mbw, plan["rounding"], rb,
                                             None)
        else:
            rec = mpeg4recon.mpeg4_recon_ref(vop, mbw, 0, ra, rb)
        if kind == "B":
            vol = mine.vol
            got = mpeg4recon.crop(rec, vol.width, vol.height)
            assert_same_frames([got], shown[-1:])
        else:
            assert_same_frames([rec], [ref.last])
            ra, rb = rb, rec
    assert kinds >= ({"I", "P"} if name == "drop.avi" else {"I", "P", "B"})


# ------------------------------------------------------------------ #
# whole streams

@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("name", STREAMS)
def test_stream_matches_the_jax_importer(name, batch, jax_decoded):
    """Drop-frame chunks (an all-skip P plan), packed P+B chunks and
    their placeholders, batch boundaries inside B runs, the last anchor
    flushed at the end."""
    assert_same_frames(port_frames(name, batch), jax_decoded(name))


@pytest.mark.parametrize("name", ["small.avi", "odd.avi"])
def test_stream_matches_decode_stream_jax(name):
    from tcforge_tpu.io import mpeg4jax
    data = b"".join(bytes(c) for c in chunks(name))
    dec = tdec.Mpeg4Decoder()
    got = mpeg4recon.decode_plans(dec.parse_plans(data), "cpu",
                                  dec.vol.width, dec.vol.height)
    assert_same_frames(got, mpeg4jax.decode_stream_jax(data))


def test_anchors_give_display_order():
    """One frame per VOP but the first anchor, the last anchor at flush;
    a P-VOP predicts from the newer anchor, a B-VOP from both."""
    dec = tdec.Mpeg4Decoder()
    kinds = [p["kind"] for c in chunks("small.avi") if c
             for p in dec.parse_plans(bytes(c))]
    anchors = mpeg4recon.Anchors()
    got = [anchors.add(k, h) for h, k in enumerate(kinds)]
    assert kinds[:4] == ["I", "P", "B", "B"]
    assert got[:4] == [(None, None, None), (0, None, 0), (0, 1, 2),
                       (0, 1, 3)]
    assert [g[2] for g in got[1:]] == [
        h if k == "B" else max(j for j in range(h) if kinds[j] != "B")
        for h, k in enumerate(kinds) if h]
    last = max(h for h, k in enumerate(kinds) if k != "B")
    assert anchors.flush() == last and anchors.flush() is None


def test_one_reconstruction_launch_per_vop_and_no_host_pixels(monkeypatch,
                                                              tmp_path):
    """The whole CLI path calls a reconstruction wrapper once per plan
    and never a pixel route of the numpy decoder."""
    calls = {"mpeg4_recon": 0, "mpeg4_idct_intra": 0}
    for name in calls:
        orig = getattr(kernels, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kernels, name, spy)

    def refuse(*a, **k):
        raise AssertionError("a numpy pixel route ran")
    for route in ("_mc_block", "_mc_rect", "decode_frames", "flush"):
        monkeypatch.setattr(tdec.Mpeg4Decoder, route, refuse)
    monkeypatch.setattr(tdec, "idct_add_sel", refuse)
    monkeypatch.setattr(tdec, "idct_put", refuse)
    for name in ("small.avi", "drop.avi", "packed.avi"):
        dec = tdec.Mpeg4Decoder()
        plans = [p for c in chunks(name) if c
                 for p in dec.parse_plans(bytes(c))]
        drops = sum(1 for c in chunks(name) if not c) \
            - (len(plans) - len([c for c in chunks(name) if c]))
        for k in calls:
            calls[k] = 0
        assert run_cli(["-i", str(DATA / name), "-o",
                        str(tmp_path / "o.y4m"), "--device", "cpu", "-q",
                        "--progress_off", "--batch", "3"]) == 0
        intra = sum(p["kind"] == "I" for p in plans)
        assert calls["mpeg4_idct_intra"] == intra
        assert calls["mpeg4_recon"] == len(plans) - intra + drops


# ------------------------------------------------------------------ #
# the CLI against the JAX CLI

def jax_cli(argv):
    return jax_cli_main([*argv, "--mesh", "off", "-q", "--progress_off"])


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


@pytest.mark.parametrize("case", sorted(set(chip_smoke.AVI_GOLDEN)
                                       - set(chip_smoke.ASP_GOLDEN)))
def test_avi_golden_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
                                                      numpy_route):
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / key
        d.mkdir()
        argv = chip_smoke.avi_golden_argv(case, d)
        assert run(argv) == 0, key
        outs[key] = [f.read_bytes() for f in
                     chip_smoke.avi_golden_outputs(case, d)]
    assert outs["port"] == outs["jax"]
    digests = [hashlib.sha256(b).hexdigest() for b in outs["port"]]
    assert digests == list(chip_smoke.AVI_GOLDEN_SHA256[case])


# ------------------------------------------------------------------ #
# refusals

def _avi(path, fourcc, chunks_, audio=None):
    w = AviWriter(str(path), AviVideoStream(fourcc=fourcc, width=176,
                                            height=144, fps=25.0),
                  [audio] if audio is not None else [])
    for c in chunks_:
        w.write_video_frame(c)
    if audio is not None:
        w.write_audio(b"\x00" * 418)
    w.close()
    return path


@pytest.mark.parametrize("what,match", [
    ("h263", "fourcc 'H263'"), ("mjpg", "progressive JPEG \\(SOF2\\)"),
    ("h264", "fourcc 'H264'"), ("mjpg_cmyk", "four-component"),
    ("mjpg_arith", "arithmetic-coded JPEG \\(SOF9\\)")])
def test_what_the_port_lacks_is_refused_by_name(what, match, tmp_path):
    """Each raises naming itself (and the CLI exits 1); none decodes on
    the host.  A short-header (H.263) picture under the fourcc H263, which
    the JAX package hands to FFmpeg, is refused (under an MPEG-4 fourcc the
    port decodes it, tests/test_torch_h263.py); so are the JPEG forms the
    port's Motion-JPEG decode does not take (tests/test_torch_mjpeg.py
    covers the baseline ones, and every refusal of io/jpeg.py)."""
    from test_torch_mjpeg import _refused
    if what == "h263":
        with AviReader(str(chip_smoke.H263_DATA / "qcif.avi")) as r:
            pic = r.read_video_frame(0)[0]
        src = _avi(tmp_path / "s.avi", "H263", [bytes(pic)])
    elif what == "h264":
        src = _avi(tmp_path / "h.avi", "H264", [bytes(64)])
    else:
        kind = {"mjpg": "progressive", "mjpg_cmyk": "cmyk",
                "mjpg_arith": "arithmetic"}[what]
        src = _avi(tmp_path / "m.avi", "MJPG", [_refused(kind)])
    out = tmp_path / "o.y4m"
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    with pytest.raises(NotImplementedError, match=match) as e:
        imp.open(str(src))
        imp.start(torch.device("cpu"))
        imp.read_video_batch(4)
    assert "not ported to the torch port yet" in str(e.value)
    assert port_cli(["-i", str(src), "-o", str(out)]) == 1


@pytest.mark.parametrize("sprite,match", [
    (1, "mpeg4: static sprite VOLs"), (2, "mpeg4: sprite brightness change"),
    (0, "mpeg4: static sprite VOPs")])
def test_sprite_vols_are_refused_by_name(sprite, match, tmp_path,
                                         numpy_route):
    """What the numpy decoder refuses of sprites, the port refuses in its
    words (GMC itself decodes, tests/test_torch_mpeg4_gmc.py): a static
    sprite VOL (sprite_enable 1), a GMC VOL with a sprite brightness
    change, and an S-VOP in a VOL without sprites (a static sprite VOP);
    both CLIs stop (the JAX CLI lets the error out, the port's returns
    1)."""
    gw = chip_smoke.GmcWriter(176, 144, seed=1)
    frame = chip_smoke.encoder_clip(176, 144, 1, seed=1)[0]
    data = [gw.headers(1, sprite=sprite, brightness=int(sprite == 2))
            + gw.ivop(frame)]
    if sprite == 0:
        data.append(gw.svop(frame, 0))
    src = _avi(tmp_path / "s.avi", "XVID", data)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(src))
    imp.start(torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=match) as e:
        imp.read_video_batch(4)
    assert "not ported" not in str(e.value)
    with pytest.raises(NotImplementedError, match=match):
        jax_cli(["-i", str(src), "-o", str(tmp_path / "j.y4m")])
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "p.y4m")]) == 1


def test_a_seek_into_an_mpeg4_stream_fails_as_in_jax(tmp_path, numpy_route,
                                                     capsys):
    """-L jumps the chunk index as the JAX importer's seek does: past the
    chunk with the VOL header both CLIs stop at 'VOP before VOL'."""
    argv = ["-i", str(DATA / "small.avi"), "-L", "3"]
    assert jax_cli([*argv, "-o", str(tmp_path / "j.y4m")]) == 1
    assert port_cli([*argv, "-o", str(tmp_path / "p.y4m")]) == 1
    assert "VOP before VOL" in capsys.readouterr().err


def test_a_compressed_track_the_session_drops_is_not_refused(tmp_path):
    """An MP3 track beside raw video, with a Y4M output and no -m: the
    session takes no audio (as the JAX engine drops it), so the video
    imports."""
    src = _avi(tmp_path / "a.avi", "I420", [bytes(176 * 144 * 3 // 2)],
               AviAudioStream(format_tag=0x55, byte_rate=16000))
    assert port_cli(["-i", str(src), "-o", str(tmp_path / "o.y4m")]) == 0


# ------------------------------------------------------------------ #
# divxkey and the wrappers

@pytest.mark.parametrize("name", ["small.avi", "native.avi", "drop.avi"])
def test_divxkey_matches_the_jax_filter(name):
    """The keyframe attribute of every frame id, those past the scan and
    below 0 too, as the JAX filter sets it."""
    import dataclasses

    import jax.numpy as jnp
    from tcforge_tpu.core.frame import FrameBatch as JBatch
    from tcforge_tpu.modules.filters.analysis import DivxKeyFilter as JKey
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.modules.filters.analysis import DivxKeyFilter
    path = str(DATA / name)
    ours = DivxKeyFilter(Job(video_in_file=path))
    ref = JKey(JJob(video_in_file=path))
    assert ours.n_frames == ref.n_frames
    ids = np.arange(-2, ref.n_frames + 3, dtype=np.int32)
    y = np.zeros((len(ids), 16, 16), np.uint8)
    c = np.zeros((len(ids), 8, 8), np.uint8)
    fb = FrameBatch.from_numpy(y, c, c, device=torch.device("cpu"))
    fb, _ = ours.apply(dataclasses.replace(
        fb, frame_ids=torch.from_numpy(ids)), None)
    jfb = JBatch.from_numpy(y=y, u=c, v=c)
    jfb, _ = ref.apply(dataclasses.replace(
        jfb, frame_ids=jnp.asarray(ids)), None)
    assert np.array_equal(fb.attrs.numpy(), np.asarray(jfb.attrs))
    assert fb.attrs.numpy().any()


def _vop(nmb=6):
    return torch.zeros((nmb, mpeg4recon.REC), dtype=torch.int16)


@pytest.mark.parametrize("bad", ["dtype", "rec", "rows", "anchor",
                                 "rounding"])
def test_the_wrappers_check_their_input(bad):
    vop, mbw, fwd = _vop(), 3, None
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
    with pytest.raises(ValueError):
        kernels.mpeg4_recon(vop, mbw, 2 if bad == "rounding" else 0, fwd,
                            None)
    if bad in ("dtype", "rec", "rows"):
        with pytest.raises(ValueError):
            kernels.mpeg4_idct_intra(vop, mbw)


def test_an_importer_given_no_device_decodes_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(DATA / "small.avi"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imp.read_video_batch(3)


@pytest.mark.cuda
def test_mpeg4_kernels_match_their_plain_versions_on_cuda():
    """The reconstruction kernels against their plain versions on the
    card, on every VOP of the small streams (``mpeg4_recon``,
    ``mpeg4_recon_qpel``, ``mpeg4_recon_field`` as ``route`` picks them,
    and ``mpeg4_idct_intra`` with field DCT; ``chip_smoke.py`` phase 3
    does it on every VOP of divx.avi, divx_qpel.avi and divx_il.avi and
    off the path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tcforge_tpu_torch.io.mpeg4plan import Mpeg4PlanDecoder
    dev = torch.device("cuda")
    for name in ("small.avi", "odd.avi", "qpel_small.avi", "il_small.avi"):
        dec = Mpeg4PlanDecoder()
        ra = rb = None
        for c in chunks(name):
            for p in dec.parse_plans(bytes(c)):
                vop = torch.from_numpy(mpeg4recon.stage_plan(p)).to(dev)
                if p["kind"] == "I":
                    got = kernels.mpeg4_idct_intra(vop, p["mbw"])
                    want = kernels.mpeg4_idct_intra_ref(vop, p["mbw"])
                else:
                    fwd = ra if p["kind"] == "B" else rb
                    bwd = rb if p["kind"] == "B" else None
                    args = (vop, p["mbw"], p["rounding"], fwd, bwd)
                    wrapper = mpeg4recon.route(p)
                    got = getattr(kernels, wrapper)(*args)
                    want = getattr(kernels, wrapper + "_ref")(*args)
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
                if p["kind"] != "B":
                    ra, rb = rb, got

