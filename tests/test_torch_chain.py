"""The port's VideoChain (plain versions on the CPU) against the JAX
chain's ``trace_step`` at the ``entry()`` shapes of ``__graft_entry__``
(512x288 -> 448x256, batch 4): one batch, two batches with the carry
handed over through ``interop``, and batch-size invariance.  Then the
slice's paths (cfg2, cfg4, denoise3d of ``chip_smoke.PATHS``) at
128x72, batch 3, over two batches with every carry compared.  Then
every internal transform of ``apply_video_trans`` alone and three at a
time, on YUV and on RGB jobs (the entry conversion and the pre and
post clips included), and cfg1 and cfg3 as wholes at a small size.
Tolerance 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import tcforge_tpu.modules  # noqa: F401  (registers the JAX filters)
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import FilterSpec as JFilterSpec
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.pipeline.chain import VideoChain as JVideoChain
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.job import FilterSpec, Job
from tcforge_tpu_torch.interop import states_from_numpy, states_to_numpy
from tcforge_tpu_torch.pipeline.chain import VideoChain

W, H, OUT_W, OUT_H, BATCH = 512, 288, 448, 256, 4
CPU = torch.device("cpu")


def _job_kw():
    return dict(im_v_width=W, im_v_height=H, deinterlace=5,
                zoom_width=OUT_W, zoom_height=OUT_H, batch_size=BATCH)


@pytest.fixture(scope="module")
def chains():
    jchain = JVideoChain(JJob(**_job_kw(),
                              filters=[JFilterSpec("hqdn3d", "luma=4.0")]),
                         JImageFormat.YUV420P, W, H)
    tchain = VideoChain(Job(**_job_kw(),
                            filters=[FilterSpec("hqdn3d", "luma=4.0")]),
                        ImageFormat.YUV420P, W, H)
    return jchain, tchain


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [tuple(rng.integers(0, 255, shape, dtype=np.uint8)
                  for shape in ((BATCH, H, W), (BATCH, H // 2, W // 2),
                                (BATCH, H // 2, W // 2)))
            for _ in range(2)]


def _run_jax(jchain, planes, states):
    out, states = jchain.trace_step(JFrameBatch.from_numpy(*planes), states)
    return [np.asarray(p) for p in out.planes], states


def _run_port(tchain, planes, states):
    out, states = tchain(FrameBatch.from_numpy(*planes, device=CPU), states)
    return list(out.to_numpy()), states


def _jax_states_np(states):
    return [None if s is None else {k: np.asarray(v) for k, v in s.items()}
            for s in states]


def test_program_order_runs_hqdn3d_after_the_zoom(chains):
    jchain, tchain = chains
    assert tchain.program() == [("pre", -1), ("trans", -1), ("filter", 0),
                                ("post", -1)]
    # FrameAnt is sized for the zoomed frame, as in the JAX chain
    tstate = tchain.initial_states(CPU)[0]
    jstate = jchain.initial_states()[0]
    for key in ("y", "u", "v"):
        assert tuple(tstate[key].shape) == jstate[key].shape
    assert tuple(tstate["y"].shape) == (OUT_H, OUT_W)


def test_one_batch_matches_trace_step(chains, batches):
    jchain, tchain = chains
    want, _ = _run_jax(jchain, batches[0], jchain.initial_states())
    got, _ = _run_port(tchain, batches[0], tchain.initial_states(CPU))
    assert [g.shape for g in got] == [(BATCH, OUT_H, OUT_W),
                                      (BATCH, OUT_H // 2, OUT_W // 2),
                                      (BATCH, OUT_H // 2, OUT_W // 2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_two_batches_with_jax_carry(chains, batches):
    """Batch 1 in both; the port's carry equals JAX's.  Batch 2 in the
    port starts from JAX's carried state, handed over as numpy."""
    jchain, tchain = chains
    _, jstates = _run_jax(jchain, batches[0], jchain.initial_states())
    _, tstates = _run_port(tchain, batches[0], tchain.initial_states(CPU))
    jnp_states = _jax_states_np(jstates)
    for t, j in zip(states_to_numpy(tstates), jnp_states):
        for key in j:
            np.testing.assert_array_equal(t[key], j[key])
    want, jstates2 = _run_jax(jchain, batches[1], jstates)
    got, tstates2 = _run_port(tchain, batches[1],
                              states_from_numpy(jnp_states, CPU))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for t, j in zip(states_to_numpy(tstates2), _jax_states_np(jstates2)):
        for key in j:
            np.testing.assert_array_equal(t[key], j[key])


def test_batch_size_invariance(chains, batches):
    _, tchain = chains
    planes = batches[0]
    whole, s_whole = _run_port(tchain, planes, tchain.initial_states(CPU))
    states = tchain.initial_states(CPU)
    parts = []
    for sl in (slice(0, 2), slice(2, 4)):
        out, states = _run_port(tchain, [p[sl] for p in planes], states)
        parts.append(out)
    for k in range(3):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][k], parts[1][k]]), whole[k])
    for key in ("y", "u", "v"):
        assert torch.equal(states[0][key], s_whole[0][key])


@pytest.mark.parametrize("field,value,flag", [
    ("im_clip", (2, 2, 2, 2), "-j"), ("ex_clip", (2, 2, 2, 2), "-Y"),
    ("resize_up", (1, 1), "-X/-B"), ("reduce_w", 2, "-r"),
    ("flip_v", True, "-z"), ("flip_h", True, "-l"), ("decolor", True, "-K"),
    ("gamma", 1.5, "-G"), ("antialias", 1, "-C"), ("deinterlace", 2, "-I 2"),
    ("pre_im_clip", (2, 2, 2, 2), "--pre_clip"),
    ("post_ex_clip", (2, 2, 2, 2), "--post_clip")])
def test_unported_transforms_raise(field, value, flag):
    """Every transform of the list builds its chain, ``-I 2`` too: the
    JAX chain does nothing for it (its deinterlacer is the smartdeinter
    filter), so the program runs and hands the batch back unchanged."""
    job = Job(**{field: value})
    chain = VideoChain(job, ImageFormat.YUV420P, 64, 48)
    assert chain.program()[1] == ("trans", -1)
    assert not chain.is_identity()
    if flag != "-I 2":
        return
    rng = np.random.default_rng(4)
    planes = [rng.integers(0, 256, (2, h, w), dtype=np.uint8)
              for h, w in ((48, 64), (24, 32), (24, 32))]
    fb = FrameBatch.from_numpy(*planes, device=CPU)
    out, states = chain(fb, chain.initial_states(CPU))
    assert states == []
    for got, want in zip(out.planes, planes):
        np.testing.assert_array_equal(got.numpy(), want)


SW, SH, SBATCH = 128, 72, 3


def _filters(cls, text):
    return [cls.parse(part) for part in text.split(",")]


@pytest.mark.parametrize("path", sorted(chip_smoke.PATHS))
def test_slice_path_two_batches(path):
    text = chip_smoke.PATHS[path]["args"][1]
    kw = dict(im_v_width=SW, im_v_height=SH, batch_size=SBATCH)
    jchain = JVideoChain(JJob(**kw, filters=_filters(JFilterSpec, text)),
                         JImageFormat.YUV420P, SW, SH)
    tchain = VideoChain(Job(**kw, filters=_filters(FilterSpec, text)),
                        ImageFormat.YUV420P, SW, SH)
    # the filters run in the same order (POST_M: in -J order)
    assert ([i for kind, i in tchain.program() if kind == "filter"]
            == [i for kind, i in jchain._program() if kind == "filter"])
    jstates, tstates = jchain.initial_states(), tchain.initial_states(CPU)
    rng = np.random.default_rng(len(path))
    for k in range(2):
        planes = [rng.integers(0, 256, (SBATCH, h, w), dtype=np.uint8)
                  for h, w in ((SH, SW), (SH // 2, SW // 2),
                               (SH // 2, SW // 2))]
        jout, jstates = jchain.trace_step(
            JFrameBatch.from_numpy(*planes, first_id=k * SBATCH), jstates)
        tout, tstates = tchain(FrameBatch.from_numpy(
            *planes, device=CPU, first_id=k * SBATCH), tstates)
        for g, w in zip(tout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(tout.attrs.numpy(),
                                      np.asarray(jout.attrs))
        for t, j in zip(states_to_numpy(tstates), _jax_states_np(jstates)):
            assert (t is None) == (j is None)
            for key in j or ():
                np.testing.assert_array_equal(t[key], j[key])


# every internal transform alone, then three at a time
TW, TH = 64, 48
TRANSFORMS = {
    "j": dict(im_clip=(2, 4, 6, 8)),
    "j_grow": dict(im_clip=(-2, -4, 0, -8)),
    "I1": dict(deinterlace=1),
    "I3": dict(deinterlace=3),
    "I4": dict(deinterlace=4),
    "I5": dict(deinterlace=5),
    "X": dict(resize_up=(1, 2)),
    "B": dict(resize_down=(2, 1)),
    "XB": dict(resize_up=(1, 0), resize_down=(0, 1)),
    "Z": dict(zoom_width=48, zoom_height=40),
    "Z_interlaced": dict(zoom_width=80, zoom_height=40,
                         zoom_interlaced=True),
    "Z_bell": dict(zoom_width=32, zoom_height=56, zoom_filter="bell"),
    "Y": dict(ex_clip=(4, 2, 0, 6)),
    "r": dict(reduce_w=2, reduce_h=2),
    "r_h": dict(reduce_h=3),
    "z": dict(flip_v=True),
    "l": dict(flip_h=True),
    "k": dict(rgbswap=True),
    "K": dict(decolor=True),
    "G": dict(gamma=0.8),
    "C": dict(antialias=1),
    "C_para": dict(antialias=2, antialias_weight=0.5, antialias_bias=0.2),
    "pre_clip": dict(pre_im_clip=(2, 0, 4, 2)),
    "post_clip": dict(post_ex_clip=(0, 2, 2, -4)),
    "j+z+G": dict(im_clip=(2, 4, 6, 8), flip_v=True, gamma=1.6),
    "I3+r+K": dict(deinterlace=3, reduce_w=2, decolor=True),
    "X+Y+C": dict(resize_up=(1, 1), ex_clip=(2, 2, 2, 2), antialias=1),
    "pre+Z+l+post": dict(pre_im_clip=(0, 2, 0, 2), zoom_width=40,
                         zoom_height=32, flip_h=True,
                         post_ex_clip=(2, 2, 2, 2)),
}


@pytest.mark.parametrize("csp", ["yuv420p", "rgb24", "yuv422p"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_internal_transforms_match_jax(name, csp):
    kw = dict(im_v_width=TW, im_v_height=TH, **TRANSFORMS[name])
    jchain = JVideoChain(JJob(**kw, im_colorspace=JImageFormat(csp)),
                         JImageFormat.YUV420P, TW, TH)
    tchain = VideoChain(Job(**kw, im_colorspace=ImageFormat(csp)),
                        ImageFormat.YUV420P, TW, TH)
    rng = np.random.default_rng(len(name))
    planes = [rng.integers(0, 256, (2, h, w), dtype=np.uint8)
              for h, w in ((TH, TW), (TH // 2, TW // 2), (TH // 2, TW // 2))]
    jout, _ = jchain.trace_step(JFrameBatch.from_numpy(*planes), [])
    tout, _ = tchain(FrameBatch.from_numpy(*planes, device=CPU), [])
    assert tout.format.value == jout.format.value == csp
    assert len(tout.planes) == len(jout.planes)
    for got, want in zip(tout.planes, jout.planes):
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the geometry the job announces is the one that came out
    if "deinterlace" not in kw or kw["deinterlace"] != 4:
        assert (tout.width, tout.height) == tchain.job.export_size()


def test_cfg1_whole_matches_jax(monkeypatch):
    """cfg1 (benches/run_configs.py:118-128) at 64x48 -> 48x32: 420P to
    RGB24 and back, then the zoom of each plane."""
    from tcforge_tpu.ops import colorspace as jcs
    from tcforge_tpu.ops import zoom as jzoom
    from tcforge_tpu_torch.ops import colorspace, zoom
    monkeypatch.setattr(chip_smoke, "CFG1_ZOOM", (48, 32))
    rng = np.random.default_rng(21)
    planes = [rng.integers(0, 256, (3, h, w), dtype=np.uint8)
              for h, w in ((48, 64), (24, 32), (24, 32))]
    back = jcs.convert(jcs.convert(JFrameBatch.from_numpy(*planes),
                                   JImageFormat.RGB24), JImageFormat.YUV420P)
    want = (jzoom.zoom_plane(back.y, 48, 32), jzoom.zoom_plane(back.u, 24, 16),
            jzoom.zoom_plane(back.v, 24, 16))
    got = chip_smoke.cfg1_step(colorspace, zoom,
                               FrameBatch.from_numpy(*planes, device=CPU))
    for g, w in zip(got.planes, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("batch", [5, 16])
def test_cfg3_chain_matches_jax(batch, tmp_path):
    """``-J 32detect,ivtc,decimate`` in its slots' order (ivtc PRE_S,
    32detect PRE_M, decimate POST_S) over a telecined stream, the JAX
    chain jitted as its engine runs it."""
    from tcforge_tpu_torch.io.y4m import Y4MReader
    chip_smoke.write_telecine_y4m(tmp_path / "t.y4m", TW, TH, 2 * batch,
                                  seed=6)
    with Y4MReader(str(tmp_path / "t.y4m")) as r:
        planes = r.read_batch(2 * batch)
    text = "32detect=force_mode=3,ivtc,decimate"
    kw = dict(im_v_width=TW, im_v_height=TH, batch_size=batch)
    jchain = JVideoChain(JJob(**kw, filters=_filters(JFilterSpec, text)),
                         JImageFormat.YUV420P, TW, TH)
    tchain = VideoChain(Job(**kw, filters=_filters(FilterSpec, text)),
                        ImageFormat.YUV420P, TW, TH)
    assert [(k, i) for k, i in tchain.program()] == \
        [(k, -1 if i is None else i) for k, i in jchain._program()]
    assert [tchain.filters[i].info.name for k, i in tchain.program()
            if k == "filter"] == ["ivtc", "32detect", "decimate"]
    jstates, tstates = jchain.initial_states(), tchain.initial_states(CPU)
    for k in range(2):
        part = [p[k * batch:(k + 1) * batch] for p in planes]
        jout, jstates = jchain(JFrameBatch.from_numpy(
            *part, first_id=k * batch), jstates)
        tout, tstates = tchain(FrameBatch.from_numpy(
            *part, device=CPU, first_id=k * batch), tstates)
        for g, w in zip(tout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(tout.attrs.numpy(),
                                      np.asarray(jout.attrs))
