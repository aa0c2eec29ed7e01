"""The cadence filters of the torch port (ivtc, 32detect, decimate,
32drop) against the JAX filters on the CPU: batches of 1, 5, 7 and 16
frames, three in a row with the carried state, on 3:2 telecined content
and on noise; the state handed from JAX to the port mid-stream through
``interop``; the float32 comb scores on their thresholds.  Tolerance 0:
the frames are bytes and the scores are compared as the int32 they
become.  The JAX filters run under ``jax.jit``, as the JAX engine runs
them: XLA compiles the comb scores' division by the constant frame area
into a multiplication, which is what the port computes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import cadence as jcad
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import cadence as tcad
from tcforge_tpu_torch.modules.registry import FilterSlot

CPU = torch.device("cpu")
W, H, FRAMES = 64, 48, 48

# (class name, options)
FILTERS = {
    "ivtc": ("IvtcFilter", ""),
    "ivtc_bottom_magic": ("IvtcFilter", "field=1:magic=1"),
    "32detect": ("Detect32Filter", "force_mode=3:verbose=1"),
    "32detect_low": ("Detect32Filter",
                     "threshold=1:chromathres=1:force_mode=1:verbose=1"),
    "decimate": ("DecimateFilter", ""),
    "32drop": ("Drop32Filter", ""),
}


@pytest.fixture(scope="module")
def content(tmp_path_factory):
    """{"telecine": planes, "noise": planes}, each (y, u, v) of FRAMES
    frames."""
    tmp = tmp_path_factory.mktemp("cadence")
    chip_smoke.write_telecine_y4m(tmp / "t.y4m", W, H, FRAMES, seed=2)
    chip_smoke.write_test_y4m(tmp / "n.y4m", W, H, FRAMES, seed=4)
    out = {}
    for key, name in (("telecine", "t.y4m"), ("noise", "n.y4m")):
        with Y4MReader(str(tmp / name)) as r:
            out[key] = r.read_batch(FRAMES)
    return out


def _pair(name):
    cls, options = FILTERS[name]
    return (getattr(tcad, cls)(Job(), options),
            getattr(jcad, cls)(JJob(), options))


def _np_state(state):
    """A JAX filter state as numpy, nested dicts kept."""
    if state is None:
        return None
    return {k: _np_state(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in state.items()}


def _assert_states_equal(port_state, jax_state):
    got, want = interop.states_to_numpy(port_state), _np_state(jax_state)
    assert (got is None) == (want is None)

    def walk(g, w, path):
        assert sorted(g) == sorted(w), path
        for key in w:
            if isinstance(w[key], dict):
                walk(g[key], w[key], path + key + ".")
            else:
                np.testing.assert_array_equal(
                    np.asarray(g[key]).astype(np.int64),
                    np.asarray(w[key]).astype(np.int64), path + key)

    if want is not None:
        walk(got, want, "")


def _run_both(name, planes, sizes, start=0):
    """Both filters over consecutive batches of ``sizes`` frames; every
    output batch and the final states compared."""
    port, ref = _pair(name)
    pstate = port.init_state(W, H, ImageFormat.YUV420P, CPU)
    jstate = ref.init_state(W, H, JImageFormat.YUV420P)
    k = start
    skipped = 0
    ref_apply = jax.jit(ref.apply)
    for n in sizes:
        batch = [p[k:k + n] for p in planes]
        pout, pstate = port.apply(FrameBatch.from_numpy(
            *batch, device=CPU, first_id=k), pstate)
        jout, jstate = ref_apply(JFrameBatch.from_numpy(
            *batch, first_id=k), jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(pout.attrs.numpy(),
                                      np.asarray(jout.attrs))
        skipped += int(((pout.attrs & ATTR_SKIPPED) != 0).sum())
        k += n
    _assert_states_equal(pstate, jstate)
    return skipped


@pytest.mark.parametrize("n", [1, 5, 7, 16])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_three_batches_on_telecined_content(content, name, n):
    _run_both(name, content["telecine"], [n, n, n])


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_uneven_batches_on_noise(content, name):
    _run_both(name, content["noise"], [7, 16, 5, 1, 2])


def test_decimate_drops_a_fifth_of_a_telecined_stream(content):
    """40 frames through ivtc then decimate in batches of 16, 16, 8: of
    the 36 that leave the delay of 4, a fifth is dropped."""
    ivtc, _ = _pair("ivtc")
    dec, _ = _pair("decimate")
    s1 = ivtc.init_state(W, H, ImageFormat.YUV420P, CPU)
    s2 = dec.init_state(W, H, ImageFormat.YUV420P, CPU)
    flags = []
    for k in (0, 16, 32):
        fb = FrameBatch.from_numpy(*(p[k:k + 16][:40 - k]
                                     for p in content["telecine"]),
                                   device=CPU, first_id=k)
        fb, s1 = ivtc.apply(fb, s1)
        fb, s2 = dec.apply(fb, s2)
        flags += ((fb.attrs & ATTR_SKIPPED) != 0).tolist()
    assert flags[:4] == [True] * 4
    kept = [i for i, f in enumerate(flags) if not f]
    assert len(kept) in (28, 29)
    # one pick per five arrivals, each read within the next five
    for group in range(4, 39, 5):
        assert sum(flags[group:group + 5]) <= 2


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_state_handed_from_jax_mid_stream(content, name):
    """Batch 1 in JAX; its state converted by interop; batch 2 in the
    port gives JAX's batch 2."""
    port, ref = _pair(name)
    planes = content["telecine"]
    first = [p[:7] for p in planes]
    second = [p[7:20] for p in planes]
    ref_apply = jax.jit(ref.apply)
    _, jstate = ref_apply(JFrameBatch.from_numpy(*first),
                          ref.init_state(W, H, JImageFormat.YUV420P))
    want, jstate2 = ref_apply(JFrameBatch.from_numpy(*second, first_id=7),
                              jstate)
    convert = (interop.carry_from_numpy
               if name in ("decimate", "32drop")
               else interop.states_from_numpy)
    pstate = convert(_np_state(jstate), CPU)
    got, pstate2 = port.apply(FrameBatch.from_numpy(
        *second, device=CPU, first_id=7), pstate)
    for g, w in zip(got.to_numpy(), want.planes):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got.attrs.numpy(), np.asarray(want.attrs))
    _assert_states_equal(pstate2, jstate2)


def test_decimate_state_keeps_its_counters_on_the_host():
    dec, _ = _pair("decimate")
    state = dec.init_state(W, H, ImageFormat.YUV420P, CPU)
    assert state["ok"] == [1] * 6
    assert (state["frame_in"], state["frame_out"], state["count"]) == (0, 0, 0)
    assert state["metric"].shape == (6, (W * H + 15) // 16)
    assert state["y"].shape == (4, H, W) and state["u"].shape == (4, H // 2,
                                                                   W // 2)


@pytest.mark.parametrize("name,slot", [("ivtc", FilterSlot.PRE_S),
                                       ("32detect", FilterSlot.PRE_M),
                                       ("decimate", FilterSlot.POST_S),
                                       ("32drop", FilterSlot.PRE_M)])
def test_slots_and_params_match(name, slot):
    port, ref = _pair(name)
    assert port.slots == slot and int(ref.slots) == int(slot)
    assert port.options == ref.options
    assert port.info.name == ref.info.name


@pytest.mark.parametrize("cls", ["IvtcFilter", "DecimateFilter",
                                 "Drop32Filter"])
def test_filters_require_420(cls):
    with pytest.raises(ValueError, match="YUV420P"):
        getattr(tcad, cls)(Job()).init_state(8, 8, ImageFormat.YUV422P, CPU)


@pytest.mark.parametrize("w,h", [(720, 480), (64, 48), (600, 100),
                                 (1920, 1080)])
def test_comb_ratio_is_the_compiled_formula(w, h):
    """Every comb count up to 200,000 at the frame sizes of cfg3 and of
    the tests: the score and the critical-ratio test as XLA compiles
    them (at 720x480 a true float32 division differs for 19 counts)."""
    cc = np.arange(0, min(w * h, 200000), dtype=np.int32)
    score = jax.jit(lambda c: (c * 1000.0 / (w * h)).astype(jnp.int32))
    ratio = jax.jit(lambda c: c / (w * h) > 0.00005)
    t = torch.from_numpy(cc)
    np.testing.assert_array_equal(
        tcad._comb_ratio(t, 1000.0, w, h).to(torch.int32).numpy(),
        np.asarray(score(jnp.asarray(cc))))
    np.testing.assert_array_equal(
        (tcad._comb_ratio(t, 1.0, w, h) > 0.00005).numpy(),
        np.asarray(ratio(jnp.asarray(cc))))


def _combed(n, h, w, seed):
    """Frames of a flat field with a seeded share of comb pixels (a line
    unlike the two around it), the share rising with the frame."""
    rng = np.random.default_rng(seed)
    out = np.full((n, h, w), 90, np.uint8)
    for i in range(n):
        hits = rng.random((h // 2, w)) < i / (2.0 * n)
        out[i, 1::2][hits[:out[i, 1::2].shape[0]]] = 200
    return out


@pytest.mark.parametrize("h,w", [(48, 64), (30, 50), (21, 37), (12, 125)])
@pytest.mark.parametrize("eq,diff", [(10, 30), (5, 15)])
def test_interlace_score_float32_truncation(h, w, eq, diff):
    """Scores all along 0..1000: the float32 ratio, truncated, equals
    the jitted JAX function's for every frame."""
    planes = _combed(64, h, w, h + w)
    want = jax.jit(lambda p: jcad.interlace_score(p, eq, diff, counts=True))(
        jnp.asarray(planes))
    got = tcad.interlace_score(torch.from_numpy(planes), eq, diff,
                               counts=True)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert len(set(got[2].tolist())) > 20


@pytest.mark.parametrize("area,counts", [
    ((100, 200), (0, 1, 2, 3)),       # 1 / 20000 sits on the 5e-5 ratio
    ((200, 200), (1, 2, 3, 4)),       # 2 / 40000 again
    ((100, 600), (2, 3, 4, 5))])      # 3 / 60000
def test_32drop_critical_ratio_on_the_threshold(area, counts):
    """Frames with exactly k comb pixels around k / (w * h) == 0.00005:
    the port's float32 test decides as JAX's."""
    h, w = area
    y = np.full((len(counts), h, w), 60, np.uint8)
    for i, k in enumerate(counts):
        y[i, 1, :k] = 250                 # k pixels unlike rows 0 and 2
    u = np.full((len(counts), h // 2, w // 2), 128, np.uint8)
    port, ref = _pair("32drop")
    pout, pstate = port.apply(
        FrameBatch.from_numpy(y, u, u, device=CPU),
        port.init_state(w, h, ImageFormat.YUV420P, CPU))
    jout, jstate = jax.jit(ref.apply)(
        JFrameBatch.from_numpy(y, u, u),
        ref.init_state(w, h, JImageFormat.YUV420P))
    np.testing.assert_array_equal(pout.attrs.numpy(), np.asarray(jout.attrs))
    np.testing.assert_array_equal(pout.y.numpy(), np.asarray(jout.y))
    _assert_states_equal(pstate, jstate)


def test_32detect_on_rgb_matches_jax():
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (5, 24, 16, 3), dtype=np.uint8)
    rgb[2, 1::2] = 255 - rgb[2, 0::2]
    port, ref = _pair("32detect_low")
    pout, pstate = port.apply(FrameBatch.from_numpy(
        rgb=rgb, device=CPU, fmt=ImageFormat.RGB24), None)
    jout, jstate = jax.jit(ref.apply)(JFrameBatch.from_numpy(
        rgb=rgb, fmt=JImageFormat.RGB24), None)
    np.testing.assert_array_equal(pout.attrs.numpy(), np.asarray(jout.attrs))
    _assert_states_equal(pstate, jstate)


def test_32detect_verbose_lines(caplog):
    """``collect`` writes the reference's line per frame."""
    port, _ = _pair("32detect")
    y = _combed(3, 24, 32, 1)
    u = np.full((3, 12, 16), 128, np.uint8)
    _, state = port.apply(FrameBatch.from_numpy(y, u, u, device=CPU,
                                                first_id=4), None)
    with caplog.at_level("INFO", logger="tcforge_tpu_torch"):
        port.collect(state)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 3
    assert lines[0].startswith("[32detect] (0) frame [000004]: (1) = ")
    assert lines[2].endswith("interlaced = yes") or \
        lines[2].endswith("interlaced = no")


def test_32detect_at_its_defaults_computes_nothing():
    """Neither force_mode nor verbose: no attribute and no state can
    change, as in the JAX filter."""
    port, ref = _pair("32detect")
    port = tcad.Detect32Filter(Job(), "")
    y = _combed(2, 24, 32, 2)
    u = np.full((2, 12, 16), 128, np.uint8)
    out, state = port.apply(FrameBatch.from_numpy(y, u, u, device=CPU), None)
    jout, jstate = jcad.Detect32Filter(JJob(), "").apply(
        JFrameBatch.from_numpy(y, u, u), None)
    assert state is None and jstate is None
    np.testing.assert_array_equal(out.attrs.numpy(), np.asarray(jout.attrs))
