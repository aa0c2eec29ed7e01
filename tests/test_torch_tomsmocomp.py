"""TomsMoComp in the torch port (plain version on the CPU) against the
JAX filter: the jnp tournament at every effort level and both parities,
StrangeBob on luma and chroma, the Pallas kernel in interpret mode, the
window form (carried frames and batch, never concatenated) at ragged
shapes, and the filter over two batches with its window carried, at
batches of 1, 2 and 5 frames too.  Tolerance 0."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.frame import ATTR_SKIPPED as J_ATTR_SKIPPED
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import tomsmocomp as jtmc
from tcforge_tpu.ops import kernels as jkernels
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.interop import states_from_numpy, states_to_numpy
from tcforge_tpu_torch.modules.filters import tomsmocomp as ttmc
from tcforge_tpu_torch.ops import kernels

CPU = torch.device("cpu")
EFFORTS = (0, 1, 3, 5, 9, 11, 13, 15)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]


def _jax_plane(c, p, x, parity, effort, strange=False, luma=True):
    out = jax.vmap(lambda c, p, x: jtmc.tomsmocomp_plane(
        c.astype(jnp.int32), p.astype(jnp.int32), x.astype(jnp.int32),
        parity, effort, strange, luma))(jnp.asarray(c), jnp.asarray(p),
                                        jnp.asarray(x))
    return np.clip(np.asarray(out), 0, 255).astype(np.uint8)


def _port_plane(c, p, x, parity, effort, strange=False, luma=True):
    c, p, x = (torch.from_numpy(a) for a in (c, p, x))
    if strange:
        return kernels.tomsmocomp_plane_ref(c, p, x, parity, effort, True,
                                            luma).numpy()
    return kernels.tomsmocomp_plane(c, p, x, parity, effort).numpy()


@pytest.mark.parametrize("effort", range(16))
def test_offsets_match_both_jax_tables(effort):
    want = jtmc._offsets_for_effort(effort)
    assert ttmc._offsets_for_effort(effort) == want
    assert jkernels._tmc_offsets(effort) == want


@pytest.mark.parametrize("effort", EFFORTS)
@pytest.mark.parametrize("parity", (0, 1))
@pytest.mark.parametrize("shape", [(2, 37, 150), (1, 24, 40)])
def test_plain_matches_jnp_tournament(shape, parity, effort):
    c, p, x = _planes(shape, effort * 2 + parity)
    np.testing.assert_array_equal(_port_plane(c, p, x, parity, effort),
                                  _jax_plane(c, p, x, parity, effort))


@pytest.mark.parametrize("luma", (True, False))
@pytest.mark.parametrize("parity", (0, 1))
@pytest.mark.parametrize("effort", (0, 5, 15))
def test_strange_bob_matches_jnp(effort, parity, luma):
    # a smooth gradient with noise makes the diagonal candidates win
    rng = np.random.default_rng(effort + 10 * parity)
    ramp = (np.arange(40)[None, :] * 3 + np.arange(30)[:, None] * 5)
    c, p, x = (np.clip(ramp[None] + rng.integers(-12, 12, (2, 30, 40)),
                       0, 255).astype(np.uint8) for _ in range(3))
    np.testing.assert_array_equal(
        _port_plane(c, p, x, parity, effort, True, luma),
        _jax_plane(c, p, x, parity, effort, True, luma))


@pytest.mark.parametrize("effort,parity,shape", [
    (5, 0, (2, 64, 128)), (15, 1, (2, 100, 200)), (3, 0, (2, 37, 150)),
    (0, 1, (1, 40, 136)), (9, 0, (1, 40, 136)), (13, 1, (1, 66, 130))])
def test_plain_matches_pallas2_interpret(effort, parity, shape):
    c, p, x = _planes(shape, effort + 31)
    want = np.asarray(jkernels.tomsmocomp_plane_pallas2(
        jnp.asarray(c), jnp.asarray(p), jnp.asarray(x), parity, effort,
        interpret=True))
    np.testing.assert_array_equal(_port_plane(c, p, x, parity, effort),
                                  want)


def _filter_pair(options, w, h):
    port = ttmc.TomsMoCompFilter(Job(), options)
    ref = jtmc.TomsMoCompFilter(JJob(), options)
    return (port, port.init_state(w, h, ImageFormat.YUV420P, CPU),
            ref, ref.init_state(w, h, JImageFormat.YUV420P))


@pytest.mark.parametrize("options", [
    "", "searcheffort=5", "searcheffort=15:topfirst=0", "usevertfilter=1",
    "searcheffort=9:usevertfilter=1:topfirst=0", "usestrangebob=1",
    "usestrangebob=1:usevertfilter=1:searcheffort=3"])
def test_filter_two_batches_with_window(options):
    w, h = 24, 18
    port, pstate, ref, jstate = _filter_pair(options, w, h)
    rng = np.random.default_rng(len(options))
    first = 0
    for n in (3, 2):
        y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
        u = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
        pout, pstate = port.apply(
            FrameBatch.from_numpy(y, u, v, device=CPU, first_id=first),
            pstate)
        jout, jstate = ref.apply(
            JFrameBatch.from_numpy(y, u, v, first_id=first), jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(pout.attrs.numpy(),
                                      np.asarray(jout.attrs))
        for key in ("y", "u", "v"):
            np.testing.assert_array_equal(pstate[key].numpy(),
                                          np.asarray(jstate[key]))
        first += n


def test_warmup_marks_the_first_two_frames_skipped():
    port, state, _, _ = _filter_pair("", 8, 6)
    assert ATTR_SKIPPED == J_ATTR_SKIPPED
    planes = [np.zeros((3, 6, 8), np.uint8), np.zeros((3, 3, 4), np.uint8),
              np.zeros((3, 3, 4), np.uint8)]
    out, state = port.apply(FrameBatch.from_numpy(*planes, device=CPU),
                            state)
    assert out.attrs.tolist() == [ATTR_SKIPPED, ATTR_SKIPPED, 0]
    out, _ = port.apply(FrameBatch.from_numpy(*planes, device=CPU,
                                              first_id=3), state)
    assert out.attrs.tolist() == [0, 0, 0]


def test_window_handed_over_from_jax():
    """The JAX filter's window, as numpy, starts the port's second batch."""
    w, h = 20, 12
    port, _, ref, jstate = _filter_pair("searcheffort=11", w, h)
    rng = np.random.default_rng(5)
    batches = [[rng.integers(0, 256, (n, hh, ww), dtype=np.uint8)
                for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
               for n in (4, 3)]
    _, jstate = ref.apply(JFrameBatch.from_numpy(*batches[0]), jstate)
    jout, jstate2 = ref.apply(
        JFrameBatch.from_numpy(*batches[1], first_id=4), jstate)
    pstate = states_from_numpy({k: np.asarray(v) for k, v in jstate.items()},
                               CPU)
    assert pstate["y"].dtype == torch.uint8
    pout, pstate2 = port.apply(
        FrameBatch.from_numpy(*batches[1], device=CPU, first_id=4), pstate)
    for got, want in zip(pout.to_numpy(), jout.planes):
        np.testing.assert_array_equal(got, np.asarray(want))
    for key, val in states_to_numpy(pstate2).items():
        np.testing.assert_array_equal(val, np.asarray(jstate2[key]))


def test_strange_bob_launches_no_kernel():
    port, state, _, _ = _filter_pair("usestrangebob=1", 8, 6)
    planes = [np.zeros((2, 6, 8), np.uint8), np.zeros((2, 3, 4), np.uint8),
              np.zeros((2, 3, 4), np.uint8)]
    kernels.reset_launches()
    port.apply(FrameBatch.from_numpy(*planes, device=CPU), state)
    assert kernels.launches["tomsmocomp"] == 0


def test_rejects_non_420():
    with pytest.raises(ValueError, match="YUV420P"):
        ttmc.TomsMoCompFilter(Job()).init_state(8, 8, ImageFormat.YUV422P,
                                                CPU)


def test_wrapper_checks():
    x = torch.zeros((2, 6, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shapes differ"):
        kernels.tomsmocomp_plane(x, x, x[:1].contiguous(), 0, 5)
    with pytest.raises(ValueError, match="dtype"):
        kernels.tomsmocomp_plane(x.int(), x, x, 0, 5)
    with pytest.raises(ValueError, match="out of range"):
        kernels.tomsmocomp_plane(x, x, x, 2, 5)
    with pytest.raises(ValueError, match="out of range"):
        kernels.tomsmocomp_plane(x, x, x, 0, 16)


@pytest.mark.parametrize("options", ["", "searcheffort=15:topfirst=0",
                                     "usestrangebob=1"])
@pytest.mark.parametrize("n", (1, 2, 5))
def test_window_form_and_filter_over_small_batches(options, n):
    """Two batches of n frames: the window form's plain version on the
    carried frames and the batch, and the filter's apply (its outputs,
    flags and carried frames, n < 2 included), against the JAX filter."""
    w, h = 22, 14
    port, pstate, ref, jstate = _filter_pair(options, w, h)
    effort = port.options["searcheffort"]
    parity = 0 if port.options["topfirst"] else 1
    rng = np.random.default_rng(n + len(options))
    for first in (0, n):
        planes = [rng.integers(0, 256, (n, hh, ww), dtype=np.uint8)
                  for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        if not port.options["usestrangebob"]:
            got = kernels.tomsmocomp_window_ref(
                pstate["y"], torch.from_numpy(planes[0]), parity, effort)
            want = _jax_plane(*_window_views(
                np.concatenate([pstate["y"].numpy(), planes[0]])),
                parity, effort)
            np.testing.assert_array_equal(got.numpy(), want)
        pout, pstate = port.apply(
            FrameBatch.from_numpy(*planes, device=CPU, first_id=first),
            pstate)
        jout, jstate = ref.apply(
            JFrameBatch.from_numpy(*planes, first_id=first), jstate)
        for got, want in zip(pout.to_numpy(), jout.planes):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(pout.attrs.numpy(),
                                      np.asarray(jout.attrs))
        for key in ("y", "u", "v"):
            np.testing.assert_array_equal(pstate[key].numpy(),
                                          np.asarray(jstate[key]))


def _window_views(window):
    """(curr, prev, next) of a (n + 2, H, W) window."""
    return window[1:-1], window[:-2], window[2:]


@pytest.mark.parametrize("effort", (0, 15))
@pytest.mark.parametrize("h", (1, 3, 4, 5))
@pytest.mark.parametrize("w", (1, 5, 9, 13, 127))
def test_window_form_at_ragged_shapes(w, h, effort):
    """Widths that are no multiple of 4 or 16 and planes of 1-5 rows
    (rows 0 and H-1 kept whatever the parity; |dx| = 4 at effort 15
    reaches both edges), against the jnp tournament."""
    parity = (w + h) % 2
    rng = np.random.default_rng(w * 10 + h + effort)
    state = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    batch = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    got = kernels.tomsmocomp_window(torch.from_numpy(state),
                                    torch.from_numpy(batch), parity, effort)
    want = _jax_plane(*_window_views(np.concatenate([state, batch])),
                      parity, effort)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", (1, 2, 3))
def test_window_carry_is_a_copy_of_the_last_two_frames(n):
    state = torch.arange(2 * 6, dtype=torch.uint8).reshape(2, 2, 3)
    batch = torch.arange(n * 6, dtype=torch.uint8).reshape(n, 2, 3) + 100
    carry = ttmc.window_carry(state, batch)
    np.testing.assert_array_equal(carry.numpy(),
                                  torch.cat([state, batch])[-2:].numpy())
    assert carry.is_contiguous()
    assert carry.data_ptr() not in (state.data_ptr(), batch.data_ptr())
    batch.fill_(0)
    assert int(carry[-1].max()) > 0


def test_window_wrapper_checks():
    state = torch.zeros((2, 6, 5), dtype=torch.uint8)
    batch = torch.zeros((3, 6, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="two frames"):
        kernels.tomsmocomp_window(state[:1], batch, 0, 5)
    with pytest.raises(ValueError, match="two frames"):
        kernels.tomsmocomp_window(state[:, :5].contiguous(), batch, 0, 5)
    with pytest.raises(ValueError, match="dtype"):
        kernels.tomsmocomp_window(state, batch.int(), 0, 5)
    with pytest.raises(ValueError, match="out of range"):
        kernels.tomsmocomp_window(state, batch, 0, 16)
