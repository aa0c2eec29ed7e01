"""The port's VideoChain (plain versions on the CPU) against the JAX
chain's ``trace_step`` at the ``entry()`` shapes of ``__graft_entry__``
(512x288 -> 448x256, batch 4): one batch, two batches with the carry
handed over through ``interop``, and batch-size invariance.  Tolerance
0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

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
from tcforge_tpu_torch.pipeline.chain import VideoChain, unsupported_flags

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
    assert tchain.program() == [("trans", -1), ("filter", 0)]
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
    job = Job(**{field: value})
    assert unsupported_flags(job) == [flag]
    with pytest.raises(NotImplementedError, match=flag):
        VideoChain(job, ImageFormat.YUV420P, 64, 48)
