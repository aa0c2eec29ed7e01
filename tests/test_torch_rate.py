"""The port's rate changers against the JAX filters on the CPU: fps up
and down (``pre`` left to the filter and forced both ways), skip,
slowmo and modfps (mode 0 and 1, clonetype 0 to 5, up and down,
``buffer`` against ``examine``), over batches of uneven sizes in a row
with the carry threaded, on ``chip_smoke.write_motion_y4m``'s clip with
every fifth frame repeated.  Every output batch (planes, attrs, ids,
fps) and the final carry are compared, tolerance 0.  The JAX filters
run under ``jax.jit``, as the JAX engine runs them: XLA turns the
float32 divisions by constant rates into multiplications by their
reciprocals, which is what the port computes.  Then fps's float32
schedule over 200,000 frame ids, and modfps's carry handed from a JAX
run to the port mid-stream through ``interop``."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

import chip_smoke
from tcforge_tpu.core.frame import FrameBatch as JFrameBatch
from tcforge_tpu.core.formats import ImageFormat as JImageFormat
from tcforge_tpu.core.job import Job as JJob
from tcforge_tpu.modules.filters import modfps as jmodfps
from tcforge_tpu.modules.filters import rate as jrate
from tcforge_tpu_torch import interop
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, FrameBatch
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.io.y4m import Y4MReader
from tcforge_tpu_torch.modules.filters import modfps, rate
from tcforge_tpu_torch.modules.registry import FilterSlot
from test_torch_deint import CPU, assert_states_equal, run_pair

W, H, FRAMES = 64, 48, 30
# uneven batches in a row; three batch sizes in all, so that the JAX
# filter's traces serve every split
SIZES = ((7, 1, 7, 8, 7), (8, 7, 1, 7, 7), (1, 7, 7, 7, 8))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("rate") / "m.y4m"
    chip_smoke.write_motion_y4m(path, W, H, FRAMES, seed=21, repeat_every=5)
    with Y4MReader(str(path)) as r:
        return r.read_batch(FRAMES)


@functools.lru_cache(maxsize=None)
def _jax_filter(ref_cls, options, fps, ex_fps):
    """The JAX filter and its jitted apply, shared by the cases that
    differ only in how the frames are split (one trace per batch
    shape)."""
    ref = ref_cls(JJob(fps=fps, ex_fps=ex_fps), options)
    return ref, jax.jit(ref.apply)


def pair(port_cls, ref_cls, options, fps, ex_fps=0.0):
    """The port's filter and the JAX one with its jitted apply, each on
    a job at ``fps`` with ``--export_fps ex_fps``."""
    job = Job(fps=fps, ex_fps=ex_fps)
    port = port_cls(job, options)
    ref = _jax_filter(ref_cls, options, fps, ex_fps)
    assert port.slots == ref[0].slots
    assert job.ex_fps == ref[0].job.ex_fps
    return port, ref


FPS = [("infps=25:outfps=29.97", 25.0), ("infps=29.97:outfps=25", 29.97),
       ("infps=30:outfps=24", 30.0), ("infps=24:outfps=60", 24.0),
       ("25:50", 25.0), ("infps=25:outfps=23.976:pre=0", 25.0),
       ("infps=23.976:outfps=25:pre=1", 23.976),
       ("outfps=50", 29.97), ("infps=25", 25.0)]


@pytest.mark.parametrize("sizes", SIZES[:2])
@pytest.mark.parametrize("options,fps", FPS)
def test_fps_matches_jax(clip, options, fps, sizes):
    port, ref = pair(rate.FpsFilter, jrate.FpsFilter, options, fps)
    run_pair(port, ref, clip, sizes, W, H)


@pytest.mark.parametrize("pre", [-1, 0, 1])
def test_fps_slot_follows_the_direction_unless_forced(pre):
    up = rate.FpsFilter(Job(fps=25.0), f"infps=25:outfps=30:pre={pre}")
    down = rate.FpsFilter(Job(fps=25.0), f"infps=30:outfps=25:pre={pre}")
    want = {-1: (FilterSlot.POST_S, FilterSlot.PRE_S),
            0: (FilterSlot.POST_S, FilterSlot.POST_S),
            1: (FilterSlot.PRE_S, FilterSlot.PRE_S)}[pre]
    assert (up.slots, down.slots) == want


@pytest.mark.parametrize("infps,outfps", [
    (30000 / 1001, 25.0), (25.0, 30000 / 1001), (23.976, 29.97),
    (29.97, 23.976)])
def test_fps_float32_schedule_over_long_streams(infps, outfps):
    """The schedule at frame ids up to 200,000, where float32 rounds:
    equal to the jitted JAX filter's for every id."""
    options = f"infps={infps}:outfps={outfps}"
    port, (ref, apply) = pair(rate.FpsFilter, jrate.FpsFilter, options,
                              infps)
    n = 200_000
    tiny = np.zeros((n, 2, 2), np.uint8)
    pout, _ = port.apply(FrameBatch.from_numpy(tiny, tiny[:, :1, :1],
                                               tiny[:, :1, :1], device=CPU),
                         None)
    jout, _ = apply(JFrameBatch.from_numpy(tiny, tiny[:, :1, :1],
                                           tiny[:, :1, :1]), None)
    np.testing.assert_array_equal(pout.attrs.numpy(), np.asarray(jout.attrs))
    np.testing.assert_array_equal(pout.frame_ids.numpy(),
                                  np.asarray(jout.frame_ids))


@pytest.mark.parametrize("sizes", SIZES[1:])
@pytest.mark.parametrize("options", ["0.3-0.7", "0.2-0.9/3,0.20-0.25",
                                     "ranges=0.0-0.2,0.10-0.12/2",
                                     "ranges=1-2", "ranges="])
def test_skip_matches_jax(clip, options, sizes):
    """Times as -c takes them: 0.3-0.7 is frames [3, 7)."""
    port, ref = pair(rate.SkipFilter, jrate.SkipFilter, options, 25.0)
    run_pair(port, ref, clip, sizes, W, H)


@pytest.mark.parametrize("sizes", SIZES[:2])
@pytest.mark.parametrize("options", ["", "factor=1", "factor=3"])
def test_slowmo_matches_jax(clip, options, sizes):
    port, ref = pair(rate.SlowMoFilter, jrate.SlowMoFilter, options, 25.0)
    run_pair(port, ref, clip, sizes, W, H)


MODFPS = [(f"clonetype={c}", 25.0, 29.97) for c in range(6)]
MODFPS += [("clonetype=7", 25.0, 29.97), ("", 29.97, 25.0),
           ("buffer=7", 29.97, 25.0), ("examine=3", 30.0, 24.0),
           ("buffer=2:examine=9", 24.0, 30.0),
           ("examine=4:subsample=7:clonetype=4", 24.0, 30.0),
           ("clonetype=5:subsample=1", 25.0, 50.0),
           ("infrc=3:clonetype=3", 25.0, 30.0),
           ("mode=0", 29.97, 25.0), ("mode=0", 25.0, 29.97)]


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("options,fps,ex_fps", MODFPS)
def test_modfps_matches_jax(clip, options, fps, ex_fps, sizes):
    port, ref = pair(modfps.ModFpsFilter, jmodfps.ModFpsFilter, options,
                     fps, ex_fps)
    pstate, jstate = run_pair(port, ref, clip, sizes, W, H)
    assert_states_equal(pstate, jstate)


def test_modfps_skips_the_near_duplicates(clip):
    """29.97 -> 25 at buffer=7 on the clip whose frames 4, 9, 14, ...
    repeat the frame before: once the ring holds real scores, each skip
    lands on a frame whose successor repeats it (a slot's score is its
    SAD against the next arrival)."""
    port = modfps.ModFpsFilter(Job(fps=29.97, ex_fps=25.0), "buffer=7")
    state = port.init_state(W, H, ImageFormat.YUV420P, CPU)
    out, state = port.apply(FrameBatch.from_numpy(*clip, device=CPU), state)
    flags = ((out.attrs & ATTR_SKIPPED) != 0).tolist()
    # output j carries arrival j's id and input j - 7's content
    skipped = [j - 7 for j, s in enumerate(flags) if s and j >= 14]
    assert len(skipped) >= 2 and all(k % 5 == 3 for k in skipped), skipped


def test_modfps_refuses_more_than_twice_the_rate():
    with pytest.raises(ValueError, match="twice"):
        modfps.ModFpsFilter(Job(fps=25.0, ex_fps=60.0), "")


@pytest.mark.parametrize("options,fps,ex_fps", [
    ("buffer=7", 29.97, 25.0), ("clonetype=4", 25.0, 29.97)])
def test_modfps_jax_carry_resumes_in_the_port(clip, options, fps, ex_fps):
    """Eleven frames through the JAX filter, its ring and counters handed
    over with ``interop.carry_from_numpy``, then the rest through both."""
    port, (ref, apply) = pair(modfps.ModFpsFilter, jmodfps.ModFpsFilter,
                              options, fps, ex_fps)
    jstate = ref.init_state(W, H, JImageFormat.YUV420P)
    _, jstate = apply(JFrameBatch.from_numpy(*[p[:11] for p in clip]),
                      jstate)
    pstate = interop.carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), CPU)
    pstate, jstate = run_pair(port, (ref, apply), clip, (8, 11), W, H,
                              first_id=11, states=(pstate, jstate))
    assert_states_equal(pstate, jstate)
