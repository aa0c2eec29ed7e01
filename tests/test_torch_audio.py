"""The port's audio track against the JAX package, on the CPU, at
tolerance 0.

- every op of ``ops/audio.py`` at odd sample counts, mono and stereo;
- every audio filter in both forms the JAX engine runs: jitted (the
  whole audio step of a session without ``-E``) and op by op (``-E``'s
  2048-sample chunks); the port's filter with ``jitted`` set to match,
  over batches in a row so every carry crosses a batch boundary;
- ``StreamingResampler`` fed in chunks of 1, 7 and 4096 samples;
- ``AudioChain`` against the JAX ``AudioChain`` with and without ``-E``,
  over a short last batch and the flush;
- the synchronizer (``-D``, ``--av_fine_ms``, adjust's clones and drops)
  against the JAX one on the same numpy batches;
- the WAV importer and multiplexor, the registry and the states'
  interop.

JAX filters are built once per option set and jitted once per shape
(``_jax_filter``), so the cases share their traces.
"""

from __future__ import annotations

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.frame import AudioBatch as JAudioBatch
from tcforge_tpu.core.job import FilterSpec as JFilterSpec
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules import registry as jregistry
from tcforge_tpu.ops import audio as jaudio
from tcforge_tpu.pipeline import synchronizer as jsync
from tcforge_tpu.pipeline.chain import AudioChain as JAudioChain
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, AudioBatch
from tcforge_tpu_torch.core.job import FilterSpec, Job
from tcforge_tpu_torch.io.wav import WavInfo, WavReader, WavWriter
from tcforge_tpu_torch.modules import registry
from tcforge_tpu_torch.ops import audio
from tcforge_tpu_torch.ops.graphs import GraphScan
from tcforge_tpu_torch.ops.fp32 import tree_sum
from tcforge_tpu_torch.pipeline import synchronizer
from tcforge_tpu_torch.pipeline.chain import AudioChain

CPU = torch.device("cpu")
LEVELS = (0.0, 2.0, 200.0, 3000.0, 12000.0)


def pcm_batch(rng, n: int, s: int, c: int) -> np.ndarray:
    """(n, s, c) int16 noise, each frame at one of LEVELS: silent,
    quiet and loud frames side by side."""
    amp = rng.choice(np.array(LEVELS, np.float32), size=(n, 1, 1))
    x = rng.standard_normal((n, s, c), dtype=np.float32) * amp
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16)


def same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- ops/audio.py ------------------------------------------------------

SHAPES = [(1, 37, 1), (3, 1601, 2), (2, 2047, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_u8_and_s16_conversions(shape):
    rng = np.random.default_rng(1)
    s16 = rng.integers(-32768, 32768, shape, dtype=np.int16)
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    same(audio.s16_to_u8(torch.from_numpy(s16)),
         jaudio.s16_to_u8(jnp.asarray(s16)))
    same(audio.u8_to_s16(torch.from_numpy(u8)),
         jaudio.u8_to_s16(jnp.asarray(u8)))


@functools.lru_cache(maxsize=None)
def _jit_amplify(scale: float):
    return jax.jit(lambda x: jaudio.amplify(x, scale))


@pytest.mark.parametrize("scale", [0.37, 1.5, 2.9, 0.1234567])
@pytest.mark.parametrize("channels", [1, 2])
def test_amplify_matches_jitted_and_op_by_op(scale, channels):
    """Every int16 value at the scale: the fused form of the jitted
    step, which op-by-op JAX equals here too; the clip count."""
    ramp = np.arange(-32768, 32768, dtype=np.int16)
    x = np.stack([ramp, ramp[::-1]], -1)[None, :, :channels]
    out, nclip = audio.amplify(torch.from_numpy(x), scale)
    for jout, jclip in (_jit_amplify(scale)(jnp.asarray(x)),
                        jaudio.amplify(jnp.asarray(x), scale)):
        same(out, jout)
        assert int(nclip) == int(jclip)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_channel_conversions(shape):
    rng = np.random.default_rng(2)
    x = rng.integers(-32768, 32768, shape[:2] + (1,), dtype=np.int16)
    same(audio.mono_to_stereo(torch.from_numpy(x)),
         jaudio.mono_to_stereo(jnp.asarray(x)))
    x2 = rng.integers(-32768, 32768, shape[:2] + (2,), dtype=np.int16)
    same(audio.stereo_to_mono(torch.from_numpy(x2)),
         jaudio.stereo_to_mono(jnp.asarray(x2)))
    with pytest.raises(ValueError):
        audio.stereo_to_mono(torch.from_numpy(x))


RATES = [(48000, 44100), (44100, 48000), (48000, 32000)]


@pytest.mark.parametrize("rates", RATES, ids=str)
@pytest.mark.parametrize("channels", [1, 2])
def test_resample_linear(rates, channels):
    rng = np.random.default_rng(3)
    x = rng.integers(-32768, 32768, (2, 1601, channels), dtype=np.int16)
    same(audio.resample_linear(torch.from_numpy(x), *rates),
         jaudio.resample_linear(jnp.asarray(x), *rates))


@functools.lru_cache(maxsize=None)
def _jit_poly(src: int, dst: int):
    return jax.jit(lambda x: jaudio.resample_poly(x, src, dst))


@pytest.mark.parametrize("rates", RATES, ids=str)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_resample_poly_in_both_forms(rates, channels, dtype):
    """The jitted form (eight lanes of fused multiply-adds) against the
    jitted function, the op-by-op form against op-by-op JAX; float32
    input shows every bit of the sum."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 1601, channels)) * 9000).astype(dtype)
    if dtype == np.int16:
        x = rng.integers(-32768, 32768, x.shape, dtype=np.int16)
    t = torch.from_numpy(x)
    same(audio.resample_poly(t, *rates, jitted=True),
         _jit_poly(*rates)(jnp.asarray(x)))
    same(audio.resample_poly(t, *rates, jitted=False),
         jaudio.resample_poly(jnp.asarray(x), *rates))


@pytest.mark.parametrize("rates", RATES, ids=str)
def test_resample_coeffs(rates):
    for got, want in zip(audio.resample_coeffs(1601, *rates),
                         jaudio.resample_coeffs(1601, *rates)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [1, 7, 4096])
@pytest.mark.parametrize("rates", [(48000, 44100), (44100, 48000)], ids=str)
def test_streaming_resampler_in_chunks(chunk, rates):
    """Fed in chunks of 1, 7 and 4096 samples, then flushed: the JAX
    resampler's bytes fed the whole stream at once."""
    rng = np.random.default_rng(5)
    x = rng.integers(-32768, 32768, (3001, 2), dtype=np.int16)
    ref = jaudio.StreamingResampler(*rates, 2)
    want = np.concatenate([ref.process(x), ref.flush()])
    port = audio.StreamingResampler(*rates, 2)
    got = [port.process(x[i:i + chunk]) for i in range(0, len(x), chunk)]
    got = np.concatenate(got + [port.flush()])
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert len(got) == len(x) * rates[1] // rates[0]


@pytest.mark.parametrize("shape", [(5, 37, 1), (3, 1602, 2), (2, 2048, 2),
                                   (2, 4096, 1), (4, 128, 1)], ids=str)
def test_tree_sum_is_xlas_order(shape):
    """The float32 sum of squares per frame in the order the jitted JAX
    filters add them (padded windows in order, unpadded windows of
    several rows in eight lanes)."""
    rng = np.random.default_rng(6)
    x = pcm_batch(rng, *shape).astype(np.float32)
    want = jax.jit(lambda a: jnp.sum(a * a, axis=(1, 2)))(jnp.asarray(x))
    t = torch.from_numpy(x)
    same(tree_sum(t * t, 2), want)


# -- the audio filters -------------------------------------------------

FILTER_CASES = [
    ("normalize", ""), ("normalize", "algo=2"),
    ("normalize", "smooth=0.3:smoothlast=0.5"),
    ("normalize", "algo=2:smooth=0.2"),
    ("astat", ""), ("astat", "silence_limit=5"),
    ("lowpass", ""), ("lowpass", "taps=3"),
    ("detectsilence", "silence_frames=2"),
    ("detectsilence", "scan_only=1:silence_frames=1"),
    ("resample", "rate=44100"), ("resample", "rate=32000"),
    ("aclip", ""), ("aclip", "level=3:range=2"), ("aclip", "range=0"),
    ("cpaudio", ""), ("cpaudio", "source=1")]


@functools.lru_cache(maxsize=None)
def _jax_filter(name: str, options: str):
    """A JAX filter and its jitted apply, shared by the cases of one
    option set (one trace per batch shape)."""
    f = jregistry.new_module(jregistry.ModuleKind.FILTER, name, JJob(),
                             options)
    return f, jax.jit(f.apply)


def _run_filter(name, options, form, shape, batches=4, seed=7):
    """The JAX filter (``form``) and the port's over ``batches`` batches
    in a row, states carried; each batch's outputs compared."""
    jf, japply = _jax_filter(name, options)
    apply = japply if form == "jitted" else jf.apply
    tf = registry.new_module(registry.ModuleKind.FILTER, name, Job(),
                             options)
    tf.jitted = form == "jitted"
    n, s, c = shape
    jst, tst = jf.init_state(48000, c), tf.init_state(48000, c, CPU)
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(batches):
        x = pcm_batch(rng, n, s, c)
        jout, jst = apply(JAudioBatch(pcm=jnp.asarray(x), rate=48000,
                                      channels=c), jst)
        tout, tst = tf.apply(AudioBatch(pcm=torch.from_numpy(x), rate=48000,
                                        channels=c), tst)
        tf.collect(tst)
        if name == "detectsilence":
            events += [tuple(e) for e in np.asarray(jst["events"])
                       if e[0] >= 0]
        same(tout.pcm, jout.pcm)
        assert tout.rate == jout.rate
        if jout.attrs is None:
            assert tout.attrs is None
        else:
            same(tout.attrs, jout.attrs)
    return jst, tst, tf, events


# op-by-op lowpass is some hundred small JAX ops, each compiled once per
# shape: it runs at the shape of -E's chunks, which the chain's cases
# share
_SHAPES = {("lowpass", "jitted"): (3, 1602, 2),
           ("lowpass", "op_by_op"): (2, 2048, 2)}


@pytest.mark.parametrize("form", ["jitted", "op_by_op"])
@pytest.mark.parametrize("name,options", FILTER_CASES)
def test_filter_matches_jax(name, options, form):
    shape = _SHAPES.get((name, form), (6, 1602, 2))
    jst, tst, tf, events = _run_filter(name, options, form, shape)
    want = jax.tree_util.tree_map(np.asarray, jst)
    if name == "detectsilence":
        assert tf.intervals == events
        assert (tst["zeros"], tst["fid"]) == (int(want["zeros"]),
                                              int(want["fid"]))
    elif want is not None:
        got = interop.states_to_numpy(tst)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,form", [
    ("normalize", "jitted"), ("normalize", "op_by_op"),
    ("aclip", "jitted"), ("aclip", "op_by_op"), ("lowpass", "jitted")])
def test_filter_on_mono_chunks(name, form):
    """Mono 2048-sample chunks (unpadded reduction windows of one
    row)."""
    _run_filter(name, "", form, (5, 2048, 1), batches=3, seed=8)


@pytest.mark.parametrize("level", [0.0, 12000.0])
def test_normalize_on_silence_and_loud_input(level):
    """All-silent frames keep the gain (the gate); loud ones drive it to
    its floor, frame after frame."""
    jf, japply = _jax_filter("normalize", "")
    tf = registry.new_module(registry.ModuleKind.FILTER, "normalize",
                             Job(), "")
    x = np.clip(np.random.default_rng(9).standard_normal((8, 1602, 2))
                * level, -32768, 32767).astype(np.int16)
    jout, jst = japply(JAudioBatch(pcm=jnp.asarray(x)),
                       jf.init_state(48000, 2))
    tout, tst = tf.apply(AudioBatch(pcm=torch.from_numpy(x)),
                         tf.init_state(48000, 2, CPU))
    same(tout.pcm, jout.pcm)
    np.testing.assert_array_equal(np.asarray(tst[0]), np.asarray(jst[0]))
    assert (float(tst[0]) == 1.0) == (level == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("options", ["", "algo=2", "smoothlast=0.5"])
def test_normalize_graph_replay_matches_the_cpu_on_cuda(options):
    """On a card normalize replays its frame step as a CUDA graph,
    captured when its state is made: batches of two shapes in turn, each
    output and the carry equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    filt = {d: registry.new_module(registry.ModuleKind.FILTER, "normalize",
                                   Job(), options) for d in ("cpu", "cuda")}
    st = {"cpu": filt["cpu"].init_state(48000, 2, CPU),
          "cuda": filt["cuda"].init_state(48000, 2, dev)}
    rng = np.random.default_rng(13)
    for n in (3, 5, 3, 5, 3, 5, 3):
        x = pcm_batch(rng, n, 2048, 2)
        outs = {}
        for d, device in (("cpu", CPU), ("cuda", dev)):
            out, st[d] = filt[d].apply(
                AudioBatch(pcm=torch.from_numpy(x).to(device)), st[d])
            outs[d] = out.pcm.cpu()
        same(outs["cuda"], outs["cpu"])
    for g, w in zip(interop.states_to_numpy(st["cuda"]),
                    interop.states_to_numpy(st["cpu"])):
        np.testing.assert_array_equal(g, w)


def _scan_step(x, a):
    return (a * 0.5 + x.sum(),)


def _eager_scan(xs, a):
    out = []
    for row in xs:
        a = _scan_step(row, a)[0]
        out.append(a)
    return torch.stack(out)


def test_graph_scan_prepare_on_the_cpu_captures_nothing():
    """``GraphScan.prepare`` is a no-op for CPU tensors: the scan keeps no
    graph and runs its steps eagerly."""
    scan = GraphScan(_scan_step)
    a = torch.ones((), dtype=torch.float32)
    scan.prepare(torch.zeros((2,), dtype=torch.float32), (a,))
    assert scan._graph is None
    xs = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ys, carry = scan(xs, (a,))
    assert torch.equal(ys, _eager_scan(xs, a))
    assert torch.equal(carry[0], ys[-1])


@pytest.mark.cuda
def test_graph_capture_survives_pending_garbage_on_cuda():
    """A CUDA graph freed while another is captured ends that capture;
    the garbage collector frees a finished session's graph wherever it
    runs.  A step lets go of the last hold on a captured scan in the
    middle of its own capture, with a collection due at almost every
    allocation: the capture must hold and the replay equal the eager
    steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.zeros((2,), dtype=torch.float32, device=dev)
    a = torch.ones((), dtype=torch.float32, device=dev)
    old = GraphScan(_scan_step)
    old.prepare(x, (a,))
    hold = [old]
    del old

    def capturing(x, a):
        if hold and torch.cuda.is_current_stream_capturing():
            garbage = [hold.pop()]
            garbage.append(garbage)
            del garbage
            [[] for _ in range(64)]
        return _scan_step(x, a)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        scan = GraphScan(capturing)
        scan.prepare(x, (a,))
    finally:
        gc.set_threshold(*thresholds)
    assert not hold
    xs = torch.arange(12, dtype=torch.float32, device=dev).reshape(6, 2)
    ys, _ = scan(xs, (a,))
    assert torch.equal(ys, _eager_scan(xs, a))


def test_detectsilence_reports_across_a_batch_boundary(caplog):
    """Silent frames 2-6 span the boundary of two batches of 4: one
    interval, reported once the loud frame arrives, and the tcmp3cut
    line at the end."""
    tf = registry.new_module(registry.ModuleKind.FILTER, "detectsilence",
                             Job(), "silence_frames=3")
    jf = jregistry.new_module(jregistry.ModuleKind.FILTER, "detectsilence",
                              JJob(), "silence_frames=3")
    loud = np.full((1, 40, 2), 3000, np.int16)
    quiet = np.zeros((1, 40, 2), np.int16)
    frames = [loud, loud, quiet, quiet, quiet, quiet, quiet, loud]
    tst, jst = tf.init_state(48000, 2, CPU), jf.init_state(48000, 2)
    for k in (0, 4):
        x = np.concatenate(frames[k:k + 4])
        _, jst = jf.apply(JAudioBatch(pcm=jnp.asarray(x)), jst)
        jf.collect(jst)
        _, tst = tf.apply(AudioBatch(pcm=torch.from_numpy(x)), tst)
        tf.collect(tst)
    assert tf.intervals == jf.intervals == [(2, 6)]
    with caplog.at_level("INFO", logger="tcforge_tpu_torch"):
        tf.finalize(tst)
    assert "Execute: tcmp3cut -i in.mp3 -o base -t ,2" in caplog.text


@pytest.mark.parametrize("peak,silence_limit,expect", [
    (0, 0, "seems only silence"), (16384, 0, 'with "-s 2.000"'),
    (20000, 0, "normalize volume")])
def test_astat_finalize(peak, silence_limit, expect, caplog, tmp_path):
    tf = registry.new_module(registry.ModuleKind.FILTER, "astat", Job(),
                             f"silence_limit={silence_limit}")
    x = np.zeros((2, 10, 2), np.int16)
    x[0, 0, 0], x[1, 3, 1] = peak, -peak
    _, st = tf.apply(AudioBatch(pcm=torch.from_numpy(x)),
                     tf.init_state(48000, 2, CPU))
    with caplog.at_level("INFO", logger="tcforge_tpu_torch"):
        tf.finalize(st)
    assert expect in caplog.text
    jst = {"min": jnp.int32(-peak), "max": jnp.int32(peak)}
    jf = _jax_filter("astat", "")[0]
    assert tf.suggested_rescale(st) == jf.suggested_rescale(jst)


def test_aclip_marks_attrs_and_keeps_them():
    """aclip ORs SKIPPED and KEYFRAME into attrs the batch carries."""
    tf = registry.new_module(registry.ModuleKind.FILTER, "aclip", Job(),
                             "range=1")
    x = np.zeros((4, 16, 2), np.int16)
    x[2] = 5000
    attrs = torch.tensor([0, 2, 0, 0], dtype=torch.int32)
    out, _ = tf.apply(AudioBatch(pcm=torch.from_numpy(x), attrs=attrs),
                      tf.init_state(48000, 2, CPU))
    assert out.attrs.tolist() == [ATTR_SKIPPED, 2 | ATTR_SKIPPED, 1,
                                  0]


# -- the chain -------------------------------------------------------

CHAIN_CASES = {
    "resampled": (["normalize", "lowpass", "astat"],
                  dict(mp3frequency=44100, dm_chan=2)),
    "jitted": (["normalize=algo=2", "aclip", "detectsilence", "cpaudio"],
               dict(dm_chan=2)),
    "volume_mono": (["normalize"], dict(volume=1.5, dm_chan=1)),
    "volume_resampled": (["normalize", "resample=rate=22050"],
                         dict(volume=1.5, dm_chan=1, mp3frequency=32000)),
    "resampler_alone": ([], dict(mp3frequency=44100, dm_chan=2)),
    "identity": ([], dict(dm_chan=2)),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_audio_chain_matches_jax(case):
    """Batches of 3, 3 and 1 frames of 1602 stereo samples, then the
    flush: the concatenated output, the clip counts and the states."""
    filters, fields = CHAIN_CASES[case]
    jchain = JAudioChain(JJob(filters=[JFilterSpec.parse(f)
                                       for f in filters], **fields))
    chain = AudioChain(Job(filters=[FilterSpec.parse(f) for f in filters],
                           **fields), CPU)
    jst, tst = jchain.initial_states(), chain.initial_states()
    rng = np.random.default_rng(10)
    jout, tout = [], []
    for n in (3, 3, 1):
        x = pcm_batch(rng, n, 1602, 2)
        ja, jst, jclip = jchain(JAudioBatch(pcm=x, rate=48000, channels=2),
                                jst)
        for f, s in zip(jchain.filters, jst):
            f.collect(s)
        ta, tst, tclip = chain(AudioBatch(pcm=torch.from_numpy(x),
                                          rate=48000, channels=2), tst)
        for f, s in zip(chain.filters, tst):
            f.collect(s)
        assert int(tclip) == int(jclip)
        assert ta.rate == ja.rate and ta.channels == ja.channels
        jout.append(np.asarray(ja.pcm).reshape(-1, ja.channels))
        tout.append(ta.pcm.numpy().reshape(-1, ta.channels))
    ja, jst = jchain.flush(jst)
    ta, tst = chain.flush(tst)
    assert (ja is None) == (ta is None)
    if ja is not None:
        jout.append(np.asarray(ja.pcm).reshape(-1, ja.channels))
        tout.append(ta.pcm.numpy().reshape(-1, ta.channels))
    np.testing.assert_array_equal(np.concatenate(tout),
                                  np.concatenate(jout))
    for g, w in zip(jax.tree_util.tree_leaves(
            interop.audio_states_to_numpy(chain.filters, tst)),
            jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, jst))):
        if np.ndim(w) == 2 and w.shape == (1, 2):
            continue                # detectsilence's last events rows
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filters", [["normalize"], ["lowpass", "astat"]])
def test_audio_chain_step_with_whole_batch_resample(filters):
    """``step`` (the JAX chain's jitted ``_trace_step``): -E as one
    whole-batch resample_poly."""
    fields = dict(mp3frequency=44100, dm_chan=2)
    jchain = JAudioChain(JJob(filters=[JFilterSpec.parse(f)
                                       for f in filters], **fields))
    chain = AudioChain(Job(filters=[FilterSpec.parse(f) for f in filters],
                           **fields), CPU)
    x = pcm_batch(np.random.default_rng(11), 3, 1602, 2)
    ja, jst, _ = jax.jit(jchain._trace_step)(
        JAudioBatch(pcm=jnp.asarray(x), rate=48000, channels=2),
        jchain.initial_states())
    ta, tst, _ = chain.step(AudioBatch(pcm=torch.from_numpy(x), rate=48000,
                                       channels=2), chain.initial_states())
    same(ta.pcm, ja.pcm)


def test_audio_chain_identity_keeps_host_samples():
    chain = AudioChain(Job(dm_chan=2), CPU)
    ab = AudioBatch(pcm=torch.zeros((2, 5, 2), dtype=torch.int16))
    assert chain(ab, [])[0] is ab


def test_audio_states_round_trip_through_the_jax_chain():
    """The port's states after two batches, handed to the JAX chain for
    a third: the same output as the port's own third batch."""
    filters = ["normalize=algo=2", "lowpass", "aclip", "detectsilence",
               "astat"]
    jchain = JAudioChain(JJob(filters=[JFilterSpec.parse(f)
                                       for f in filters], dm_chan=2))
    chain = AudioChain(Job(filters=[FilterSpec.parse(f) for f in filters],
                           dm_chan=2), CPU)
    rng = np.random.default_rng(12)
    tst = chain.initial_states()
    for _ in range(2):
        _, tst, _ = chain(AudioBatch(pcm=torch.from_numpy(
            pcm_batch(rng, 4, 1602, 2))), tst)
    jst = [jax.tree_util.tree_map(jnp.asarray, s) for s in
           interop.audio_states_to_numpy(chain.filters, tst)]
    back = interop.audio_states_from_numpy(
        chain.filters, [jax.tree_util.tree_map(np.asarray, s)
                        for s in jst], CPU)
    x = pcm_batch(rng, 4, 1602, 2)
    ja, _, _ = jchain(JAudioBatch(pcm=x), jst)
    ta, _, _ = chain(AudioBatch(pcm=torch.from_numpy(x)), back)
    same(ta.pcm, ja.pcm)
    same(ta.attrs, ja.attrs)


# -- the synchronizer ------------------------------------------------

def _planes(rng, n):
    return {k: rng.integers(0, 256, (n, h, 6), dtype=np.uint8)
            for k, h in (("y", 4), ("u", 2), ("v", 2))}


@pytest.mark.parametrize("shift", [-3, 3])
@pytest.mark.parametrize("fine", [0, -20, 20])
def test_sync_audio_shifts(shift, fine):
    """-D (whole audio frames inserted or dropped) and --av_fine_ms
    (samples at the input's rate), batch after batch."""
    jjob = JJob(av_offset=shift, av_fine_ms=fine, sync_method="none")
    tjob = Job(av_offset=shift, av_fine_ms=fine, sync_method="none")
    js, ts = jsync.new_synchronizer(jjob), synchronizer.new_synchronizer(tjob)
    rng = np.random.default_rng(13)
    for _ in range(4):
        pcm = rng.integers(-9, 9, (2 * 1920, 2), dtype=np.int16)
        want = js.process_audio(pcm, 1920)
        got = ts.process_audio(pcm, 1920)
        np.testing.assert_array_equal(got, want)
    assert ts.fine_samples == js.fine_samples == 0


@pytest.mark.parametrize("audio_per_batch", [[4, 4, 1, 0, 0],
                                             [4, 7, 9, 5, 4],
                                             [2, 6, 4, 3, 8]])
@pytest.mark.parametrize("margin,interval", [(1, 4), (1, 0), (2, 3)])
def test_adjust_sync_clones_and_drops(audio_per_batch, margin, interval):
    """The adjust method on batches of 4 frames with audio short, long
    and uneven: the same frames out, clones and drops counted alike."""
    jjob = JJob(resync_margin=margin, resync_interval=interval)
    tjob = Job(resync_margin=margin, resync_interval=interval)
    js, ts = jsync.new_synchronizer(jjob), synchronizer.new_synchronizer(tjob)
    rng = np.random.default_rng(14)
    for frames in audio_per_batch:
        planes = _planes(rng, 4)
        want = js.process_video(dict(planes), frames)
        got = ts.process_video(dict(planes), frames)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert (ts.video_cloned, ts.video_dropped) == (js.video_cloned,
                                                   js.video_dropped)
    assert ts.summary() == js.summary()


# -- modules ---------------------------------------------------------

JAX_AUDIO_FILTERS = sorted(
    name for name, cls in jregistry._REGISTRIES[
        jregistry.ModuleKind.FILTER].items()
    if issubclass(cls, jregistry.AudioFilter))


@pytest.mark.parametrize("name", JAX_AUDIO_FILTERS)
def test_every_jax_audio_filter_is_registered(name):
    cls = registry.lookup(registry.ModuleKind.FILTER, name)
    jcls = jregistry.lookup(jregistry.ModuleKind.FILTER, name)
    assert issubclass(cls, registry.AudioFilter)
    assert cls.slots == jcls.slots
    assert ([(p.name, p.default) for p in cls.desc.params]
            == [(p.name, p.default) for p in jcls.desc.params])


def test_wav_importer_muxer_and_encoder_round_trip(tmp_path):
    rng = np.random.default_rng(15)
    pcm = rng.integers(-32768, 32768, (3000, 2), dtype=np.int16)
    with WavWriter(str(tmp_path / "a.wav"), WavInfo(44100, 2, 16)) as w:
        w.write_samples(pcm)
    job = Job(dm_chan=2, a_rate=44100)
    imp = registry.new_module(registry.ModuleKind.DEMULTIPLEXOR, "wav", job)
    imp.open(str(tmp_path / "a.wav"))
    assert (imp.audio_rate, imp.audio_channels) == (44100, 2)
    parts = [imp.read_audio_batch(1024) for _ in range(3)]
    assert imp.read_audio_batch(1) is None
    imp.close()
    enc = registry.new_module(registry.ModuleKind.ENCODER, "raw", job)
    payloads = enc.encode_audio(AudioBatch(pcm=torch.from_numpy(
        np.concatenate(parts).reshape(3, 1000, 2))))
    mux = registry.new_module(registry.ModuleKind.MULTIPLEXOR, "wav", job)
    mux.open(str(tmp_path / "b.wav"))
    for p in payloads:
        mux.write_audio(p)
    mux.close()
    assert ((tmp_path / "b.wav").read_bytes()
            == (tmp_path / "a.wav").read_bytes())
    with WavReader(str(tmp_path / "b.wav")) as r:
        assert r.total_samples == 3000
    assert registry.find_mux_module_for_path("x/OUT.WAV") == "wav"
    assert registry.find_mux_module_for_path("out.ogg") == "ogg"
    assert registry.find_mux_module_for_path("out.mkv") is None


def test_audio_batch_numpy_round_trip():
    x = np.arange(24, dtype=np.int16).reshape(3, 4, 2)
    ab = AudioBatch.from_numpy(x, device=CPU, rate=44100, first_id=5)
    assert (ab.batch, ab.samples_per_frame, ab.channels, ab.rate) == \
        (3, 4, 2, 44100)
    assert ab.frame_ids.tolist() == [5, 6, 7]
    np.testing.assert_array_equal(ab.to_numpy(), x)
    assert AudioBatch.from_numpy(x[0], device=CPU).pcm.shape == (1, 4, 2)


@pytest.mark.parametrize("volume, rate, batch", [
    ("0.5", 48000, 16), ("1.7", 48000, 16), ("0.5", 48000, 1),
    ("1.7", 48000, 3), ("0.5", 48000, 7), ("1.7", 44100, 1),
    ("0.5", 44100, 5), ("1.7", 44100, 16), ("0.5", 8000, 1),
    ("1.7", 32000, 3)])
def test_lowpass_after_volume_matches_the_jax_cli(volume, rate, batch,
                                                  tmp_path):
    """-s with -J lowpass and no -E: the JAX engine jits the amplify and
    lowpass's scan into one program, where XLA contracts some of the
    scan's products and not others (``_scan_pairs_amplified``).  A
    WAV-to-WAV session on noise, five batches of ``batch`` nominal
    frames at 25 frames/s (the carry crosses each boundary), byte for
    byte against the JAX CLI's WAV.  The JAX side runs with ``--mesh
    off``: the tests' eight-device mesh would round its batch up to a
    multiple of eight, and a scan over other batches rounds otherwise."""
    from tcforge_tpu.cli import main as jax_cli_main
    from tcforge_tpu_torch import cli
    src = tmp_path / "noise.wav"
    rng = np.random.default_rng(23)
    pcm = rng.integers(-32768, 32768,
                       (5 * batch * (rate // 25), 2)).astype(np.int16)
    with WavWriter(str(src), WavInfo(rate=rate, channels=2, bits=16)) as w:
        w.write_samples(pcm)
    outs = []
    for main, extra in ((jax_cli_main, ["--mesh", "off"]),
                        (cli.main, ["--device", "cpu"])):
        out = tmp_path / f"out{len(outs)}.wav"
        assert main(["-i", str(src), "-o", str(out), "-s", volume, "-J",
                     "lowpass", "--batch", str(batch), "--progress_off",
                     "-q", *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[1] == outs[0]


@pytest.mark.parametrize("frames, samples", [
    (1, 16), (1, 20), (1, 24), (1, 31), (1, 40), (1, 48), (1, 256),
    (1, 320), (1, 341), (1, 654), (2, 2048), (1, 4122), (3, 2048)])
def test_lowpass_after_volume_step_matches_the_jitted_jax_step(frames,
                                                               samples):
    """The same fused program at scan lengths where the recursion's
    bottom and its last two-element level change copies: lengths from 16
    to 6144, each a power of two or just past one, where the new carry
    is the bottom's value.  Two batches in a row, so the second starts
    from a carry; output and carry exactly the jitted JAX step's."""
    fields = dict(volume=0.5 if samples % 2 else 1.7, dm_chan=2)
    jchain = JAudioChain(JJob(filters=[JFilterSpec.parse("lowpass")],
                              **fields))
    chain = AudioChain(Job(filters=[FilterSpec.parse("lowpass")], **fields),
                       CPU)
    jstep = jax.jit(jchain._trace_step)
    jst, tst = jchain.initial_states(), chain.initial_states()
    rng = np.random.default_rng(samples)
    for _ in range(2):
        x = rng.integers(-32768, 32768, (frames, samples, 2)
                         ).astype(np.int16)
        ja, jst, jclip = jstep(JAudioBatch(pcm=jnp.asarray(x), rate=48000,
                                           channels=2), jst)
        ta, tst, tclip = chain.step(AudioBatch(pcm=torch.from_numpy(x),
                                               rate=48000, channels=2), tst)
        same(ta.pcm, ja.pcm)
        same(tst[0], jst[0])
        assert int(tclip) == int(jclip)
