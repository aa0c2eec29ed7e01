"""The port's ``xvid`` encoder module and MPEG-4 export through the CLI,
on the CPU, against the JAX package.

The golden is the JAX CLI's route on the CPU with
``TCFORGE_NATIVE_MPEG4ENC=1``: its ``xvid`` module's in-tree encoder
(``io/mpeg4enc.Mpeg4NativeEncoder``), not the FFmpeg bridge's libxvid,
which the card's machine has not; an AVI input decodes through its
numpy decoder (``TCFORGE_NATIVE_MPEG4=1``).  Held at tolerance 0:

- the module's description, its option split and the rule that an
  explicit ``quant=`` means constant quality, against the JAX module;
- the small ``chip_smoke.XVID_GOLDEN`` cases through both CLIs, byte for
  byte, each digest pinned for ``chip_smoke.py`` to check on the card;
- the read-back: the port's AVI decoded by the port's own MPEG-4
  importer equals the JAX importer's decode, and without 4MV the
  encoder's reconstruction.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.cli import main as jax_cli_main
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.encoders import encoder_cfg as jcfg
from tcforge_tpu.modules.registry import ModuleKind as JKind
from tcforge_tpu.modules.registry import lookup as jlookup
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.avi import AviVideoStream, AviWriter
from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
from tcforge_tpu_torch.modules.encoders import encoder_cfg as tcfg
from tcforge_tpu_torch.modules.registry import ModuleKind, lookup, new_module
from test_torch_engine import run_cli


@pytest.fixture
def native_routes(monkeypatch):
    """The JAX CLI's in-tree MPEG-4 encoder and decoder."""
    monkeypatch.setenv("TCFORGE_NATIVE_MPEG4ENC", "1")
    monkeypatch.setenv("TCFORGE_NATIVE_MPEG4", "1")


def jax_cli(argv):
    return jax_cli_main([*argv, "--mesh", "off", "-q", "--progress_off"])


def port_cli(argv):
    return run_cli([*argv, "--device", "cpu", "-q", "--progress_off"])


# ------------------------------------------------------------------ #
# the module

def test_the_module_matches_the_jax_module():
    import tcforge_tpu.modules  # noqa: F401
    import tcforge_tpu_torch.modules  # noqa: F401
    ours = lookup(ModuleKind.ENCODER, "xvid")
    ref = jlookup(JKind.ENCODER, "xvid")
    assert ours.info.media == ref.info.media
    assert ([c.name for c in ours.info.codecs_out]
            == [c.name for c in ref.info.codecs_out])
    assert ([(p.name, p.help, p.fmt, p.default, p.lo, p.hi)
             for p in ours.desc.params]
            == [(p.name, p.help, p.fmt, p.default, p.lo, p.hi)
                for p in ref.desc.params])
    assert ours.desc.comment == ref.desc.comment


@pytest.mark.parametrize("opts", [
    "", "quant=4", "bitrate=300:keyint=5", "four_mv=1:bframes=2",
    "quant=3:max_bframes=2", "vhq=4:chroma_opt", "keyint=12:bframes=2:"
    "four_mv=1", "qpel:gmc:quant=7", "bitrate=900:unknown=x:four_mv=0",
    "help"])
def test_options_split_as_in_jax(opts):
    import tcforge_tpu_torch.modules  # noqa: F401
    desc = lookup(ModuleKind.ENCODER, "xvid").desc
    assert tcfg.split_extra_options(desc, opts) == \
        jcfg.split_extra_options(desc, opts)


@pytest.mark.parametrize("opts,w", [
    ("", None), ("quant=4", None), ("bitrate=300", None),
    ("quant=4:bitrate=300", None), ("", 700), ("quant=9", 700),
    ("keyint=5:bframes=3:four_mv=1", 250)],
    ids=["default", "quant", "bitrate", "both", "w", "quant_w", "all"])
def test_the_encoder_is_built_as_in_jax(opts, w, monkeypatch,
                                        native_routes):
    """The encoder's arguments: an explicit ``quant=`` means constant
    quality; ``bitrate=``, or the job's bitrate (``-w``, 1800 by default)
    without ``quant``, rate control; ``keyint`` 0 means 250."""
    import jax.numpy as jnp
    from tcforge_tpu.core.formats import ImageFormat as JFormat
    from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
    from tcforge_tpu.io import mpeg4enc as jenc
    from tcforge_tpu.modules.registry import new_module as jnew
    from tcforge_tpu_torch.io import mpeg4enc as tenc
    import tcforge_tpu.modules  # noqa: F401
    import tcforge_tpu_torch.modules  # noqa: F401
    got = {}

    def recorder(key):
        class Rec:
            def __init__(self, *a, **k):
                got[key] = (a, k)

            def push(self, *a):
                return []
        return Rec
    monkeypatch.setattr(jenc, "Mpeg4NativeEncoder", recorder("jax"))
    monkeypatch.setattr(tenc, "Mpeg4Encoder", recorder("port"))
    kw = {"bitrate": w} if w else {}
    jm = jnew(JKind.ENCODER, "xvid", JJob(fps=29.97, **kw), opts)
    pm = new_module(ModuleKind.ENCODER, "xvid", Job(fps=29.97, **kw), opts)
    y = np.zeros((1, 32, 48), np.uint8)
    c = np.zeros((1, 16, 24), np.uint8)
    jm.encode_video(JFrameBatch(format=JFormat.YUV420P, y=jnp.asarray(y),
                                u=jnp.asarray(c), v=jnp.asarray(c)))
    pm.encode_video(FrameBatch(format=ImageFormat.YUV420P,
                               y=torch.from_numpy(y), u=torch.from_numpy(c),
                               v=torch.from_numpy(c)))
    assert got["port"] == got["jax"]
    assert pm.extra_opts == jm.extra_opts


def test_the_module_flushes_its_tail_as_frames():
    import tcforge_tpu_torch.modules  # noqa: F401
    m = new_module(ModuleKind.ENCODER, "xvid", Job(fps=25.0),
                   "quant=5:bframes=3")
    frames = chip_smoke.encoder_clip(32, 32, 6, seed=1)
    fb = FrameBatch(format=ImageFormat.YUV420P,
                    y=torch.from_numpy(np.stack([f[0] for f in frames])),
                    u=torch.from_numpy(np.stack([f[1] for f in frames])),
                    v=torch.from_numpy(np.stack([f[2] for f in frames])))
    got = m.encode_video(fb)
    tail = m.flush()
    assert len(got) == 5 and len(tail) == 1 and m.last_flush_frames == 1
    assert m.flush() == [] or m.last_flush_frames == 1


# ------------------------------------------------------------------ #
# the CLI against the JAX CLI

SMALL = [c for c in chip_smoke.XVID_GOLDEN if c not in ("divxenc", "divx")]


@pytest.mark.parametrize("case", SMALL)
def test_xvid_golden_cli_matches_jax_cli_byte_for_byte(case, tmp_path,
                                                       native_routes):
    outs = {}
    for key, run in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / key
        d.mkdir()
        assert run(chip_smoke.xvid_golden_argv(case, d)) == 0, key
        outs[key] = [f.read_bytes() for f in
                     chip_smoke.xvid_golden_outputs(case, d)]
    assert outs["port"] == outs["jax"]
    digests = [hashlib.sha256(b).hexdigest() for b in outs["port"]]
    assert digests == list(chip_smoke.XVID_GOLDEN_SHA256[case])


def test_every_xvid_golden_is_pinned():
    assert sorted(chip_smoke.XVID_GOLDEN_SHA256) == \
        sorted(chip_smoke.XVID_GOLDEN)


def test_the_avi_names_the_xvid_fourcc(tmp_path, native_routes):
    d = tmp_path / "p"
    d.mkdir()
    assert port_cli(chip_smoke.xvid_golden_argv("y4m_b1", d)) == 0
    from tcforge_tpu_torch.io.avi import AviReader
    with AviReader(str(d / "out.avi")) as r:
        assert r.video.fourcc == "XVID"
        assert (r.video.width, r.video.height) == (96, 64)
        assert r.video_frames == 12


# ------------------------------------------------------------------ #
# the read-back

def _write_avi(path, chunks, w, h):
    avi = AviWriter(str(path), AviVideoStream(fourcc="XVID", width=w,
                                              height=h, fps=25.0))
    for c in chunks:
        avi.write_video_frame(c)
    avi.close()


def _port_decode(path):
    import tcforge_tpu_torch.modules  # noqa: F401
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "avi", Job())
    imp.open(str(path))
    imp.start(torch.device("cpu"))
    out = []
    while (b := imp.read_video_batch(4)) is not None:
        out += [tuple(b[k][i].numpy() for k in "yuv")
                for i in range(b["y"].shape[0])]
    imp.close()
    return out


def _jax_decode(path):
    import tcforge_tpu.modules  # noqa: F401
    from tcforge_tpu.modules.registry import new_module as jnew
    imp = jnew(JKind.DEMULTIPLEXOR, "avi", JJob())
    imp.open(str(path))
    out = []
    while (b := imp.read_video_batch(4)) is not None:
        out += [tuple(np.asarray(b[k][i]) for k in "yuv")
                for i in range(len(b["y"]))]
    imp.close()
    return out


@pytest.mark.parametrize("four_mv,kind", [(False, "wave"), (False, "still"),
                                          (True, "wave"), (True, "still")])
def test_the_port_reads_back_its_own_avi(four_mv, kind, tmp_path,
                                         native_routes):
    """The encoder's AVI through the port's MPEG-4 importer: the JAX
    importer's frames, and without 4MV the encoder's reconstruction; the
    still clip with 4MV reaches the JAX encoder's 4MV skip, where the
    decode drifts from it."""
    w, h = 88, 56
    frames = chip_smoke.encoder_clip(w, h, 8, seed=9, kind=kind)
    enc = Mpeg4Encoder(w, h, qscale=8, bframes=2, four_mv=four_mv,
                       keep_recon_log=True)
    chunks = []
    for f in frames:
        chunks += enc.push(*(torch.from_numpy(p) for p in f))
    chunks += enc.flush()
    path = tmp_path / "enc.avi"
    _write_avi(path, [c for c, _ in chunks], w, h)
    got = _port_decode(path)
    want = _jax_decode(path)
    assert len(got) == len(want) == 8
    for g, j in zip(got, want):
        for a, b in zip(g, j):
            assert np.array_equal(a, b)
    drift = [i for i, g in enumerate(got)
             if not np.array_equal(g[0], enc.recon_log[i][0][:h, :w].numpy())]
    if not four_mv:
        assert drift == []
    elif kind == "still":
        assert drift
