"""Audio filters: normalize, astat, lowpass, detectsilence, resample.

The port of ``tcforge_tpu/modules/filters/audio_filters.py``, rebuilds
of ``filter_normalize.c`` (the AGC volume normalizer), ``filter_astat.c``
(peak statistics and the suggested rescale), ``filter_lowpass.c`` (a
one-pole IIR low-pass), ``filter_detectsilence.c`` (the silent-frame
reporter) and ``filter_resample.c``, on the chain's device.

The JAX engine runs the filters in one of two forms (``AudioFilter.
jitted``, set by the audio chain): jitted, in the whole audio step of a
session without ``-E``, or op by op on the resampler's 2048-sample
chunks with ``-E``.  The port computes the float32 of the form it is
in: XLA's CPU reductions in their tree order (``ops/fp32.py``
``tree_sum``), its fused multiply-adds where the jitted code has them,
and a correctly rounded ``sqrt`` (``sqrt32``).  normalize's frame loop
is a ``lax.scan``, which JAX compiles whole in both forms; the port runs
it frame by frame on the device.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.frame import AudioBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (AudioFilter, FilterSlot,
                                                ModuleInfo, ModuleKind,
                                                register)
from tcforge_tpu_torch.ops import audio as audio_ops
from tcforge_tpu_torch.ops.fp32 import fma32, recip32, sqrt32, tree_sum
from tcforge_tpu_torch.ops.graphs import GraphScan

_log = logging.getLogger("tcforge_tpu_torch")

MUL_MIN, MUL_MAX = 0.1, 5.0
MAX_S16 = 32767.0
MID_S16 = MAX_S16 * 0.25     # target RMS (filter_normalize.c:64)
SIL_S16 = MAX_S16 * 0.01     # silence gate (filter_normalize.c:68)
NSAMPLES = 128               # algo 2 history (filter_normalize.c:73)
MIN_SAMPLE_SIZE = 32000

_F32 = np.float32


@register
class NormalizeFilter(AudioFilter):
    """filter_normalize.c: the per-frame RMS drives the gain toward
    MID/rms, clamped to [0.1, 5.0]; samples are scaled and clamped.
    ``algo`` 1 = one-value memory smoothing (new = a*old + b*needed),
    2 = weighted mean over the last 128 frame averages
    (filter_normalize.c:260-305).

    The frames' RMS values do not depend on the carry: they are computed
    for the whole batch at once, in the order of XLA's reduction.  The
    gain and its history are the carry, frame after frame: a few float32
    scalars a frame on the batch's device, each operation rounded as
    XLA's CPU code rounds it (``fma32`` where it fuses).  Nothing is
    read back; the ring index is a host int (the frame count mod 128).
    On a card those are some forty launches a frame, each a few
    microseconds of the host's time, so the frame's step is replayed as
    one CUDA graph (``GraphScan``)."""

    info = ModuleInfo(name="normalize", kind=ModuleKind.FILTER,
                      media="audio")
    desc = ModuleDesc(
        name="normalize", comment="volume normalizer (AGC)",
        version="0.1.1", capabilities="AE",
        params=[ParamSpec("smooth", "gain smoothing factor", "f", 0.06,
                          0.0, 1.0),
                ParamSpec("smoothlast", "smoothing for last sample "
                          "average", "f", 0.06, 0.0, 1.0),
                ParamSpec("algo", "1=memory smoothing 2=weighted mean",
                          "d", 1, 1, 2)])
    slots = FilterSlot.PRE_M
    media = "audio"

    def init_state(self, rate: int, channels: int,
                   device: torch.device) -> Any:
        """(mul, lastavg, the (avg, len) ring, the ring index): float32
        tensors on ``device`` and a host int."""
        state = (torch.ones((), dtype=torch.float32, device=device),
                 torch.zeros((), dtype=torch.float32, device=device),
                 torch.zeros((NSAMPLES, 2), dtype=torch.float32,
                             device=device), 0)
        # on a card the frame's step is captured here, before the
        # engine's threads start (``GraphScan.prepare``)
        self._scan.prepare(
            torch.zeros((2,), dtype=torch.float32, device=device),
            (*state[:3], torch.zeros((), dtype=torch.int64, device=device)))
        return state

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self._scan = GraphScan(self._frame)

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        mul, lastavg, mem, idx = state
        n, s, c = ab.pcm.shape
        if n == 0:
            return ab, state
        dev = ab.pcm.device
        length = s * c
        x = ab.pcm.to(torch.float32)
        # the mean is the sum times the float32 1/length (XLA's form);
        # a frame of no samples has the JAX filter's 0/0
        inv = recip32(length) if length else math.nan
        curavgs = sqrt32(tree_sum(x * x, 2) * inv)
        # each frame's step takes its RMS and its sample count
        xs = torch.stack([curavgs, torch.full_like(curavgs, length)], 1)
        gains, (mul, lastavg, mem, _) = self._scan(xs, (
            mul, lastavg, mem,
            torch.full((), idx, dtype=torch.int64, device=dev)))
        if int(self.options["algo"]) == 2:
            idx = (idx + n) % NSAMPLES
        pcm = (gains[:, None, None] * x).clamp(-32768, 32767)
        return ab.with_pcm(pcm.to(torch.int16)), (mul, lastavg, mem, idx)

    def _frame(self, x: torch.Tensor, mul: torch.Tensor,
               lastavg: torch.Tensor, mem: torch.Tensor, idx: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
        """One frame's step of the carry (the JAX filter's ``_norm_step``
        but for the samples): ``x`` is the frame's (RMS, sample count),
        the ring index a device scalar.  Only tensor operations, so that
        ``GraphScan`` can replay it."""
        smooth = float(self.options["smooth"])
        smoothlast = float(self.options["smoothlast"])
        keep, take = 1.0 - smooth, smooth
        keep_last, take_last = 1.0 - smoothlast, smoothlast
        dev = x.device

        def const(v: float) -> torch.Tensor:
            # a float32 constant filled on the device (no host copy)
            return torch.full((), v, dtype=torch.float32, device=dev)

        curavg, length = x[0], x[1]
        mid, tiny, sil = const(MID_S16), const(1e-9), const(SIL_S16)
        lo, hi = const(MUL_MIN), const(MUL_MAX)
        if int(self.options["algo"]) == 1:
            needed = mid / torch.maximum(curavg * mul, tiny)
            new_mul = torch.minimum(torch.maximum(
                fma32(mul, keep, needed * take), lo), hi)
            mul = torch.where(curavg > sil, new_mul, mul)
            if keep_last == take_last:
                # XLA factors a*c + b*c into (a + b)*c, and the product
                # mul*curavg then fuses into the add
                lastavg = fma32(mul, curavg, lastavg) * take_last
            else:
                lastavg = fma32(lastavg, keep_last,
                                curavg * mul * take_last)
            return mul, lastavg, mem, idx
        # the ring's total and weighted sum in one reduction
        sums = tree_sum(torch.stack([mem[:, 1], mem[:, 0] * mem[:, 1]]), 1)
        total = sums[0]
        avg = sums[1] / torch.maximum(const(1.0), total)
        new_mul = torch.minimum(torch.maximum(
            mid / torch.maximum(avg, tiny), lo), hi)
        mul = torch.where((total > const(MIN_SAMPLE_SIZE)) & (avg >= sil),
                          new_mul, mul)
        mem = mem.index_copy(0, idx.view(1),
                             torch.stack([curavg * mul, length])[None])
        return mul, lastavg, mem, torch.remainder(idx + 1, NSAMPLES)


@register
class AstatFilter(AudioFilter):
    """filter_astat.c: the global sample min and max in the carry; the
    suggested volume rescale (32767/peak) is logged at the end."""

    info = ModuleInfo(name="astat", kind=ModuleKind.FILTER, media="audio")
    desc = ModuleDesc(name="astat", comment="audio peak statistics",
                      capabilities="AE",
                      params=[ParamSpec("file", "write result to file",
                                        "s", ""),
                              ParamSpec("silence_limit", "maximum "
                                        "silence amplitude", "d", 0,
                                        0, 32767)])
    slots = FilterSlot.PRE_S
    media = "audio"

    def init_state(self, rate: int, channels: int,
                   device: torch.device) -> Any:
        return {"min": torch.zeros((), dtype=torch.int32, device=device),
                "max": torch.zeros((), dtype=torch.int32, device=device)}

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        if ab.pcm.numel() == 0:
            return ab, state
        lo = torch.minimum(state["min"], ab.pcm.min().to(torch.int32))
        hi = torch.maximum(state["max"], ab.pcm.max().to(torch.int32))
        return ab, {"min": lo, "max": hi}

    def finalize(self, state: Any) -> None:
        """astat_stop (filter_astat.c:160-205): the silence check, the
        "-s" suggestion, the optional scale-value file."""
        mn = int(state["min"])
        mx = int(state["max"])
        lim = self.options["silence_limit"]
        if mn >= lim and mx <= lim:
            _log.info("[astat] audio track seems only silence")
            return
        if mn == 0 or mx == 0:
            _log.warning("[astat] bad minimum/maximum value, unable to "
                         "find scale value")
            return
        fmin = -mn / 32767.0
        fmax = mx / 32767.0
        vol = 1.0 / fmax if fmin < fmax else 1.0 / fmin
        path = self.options["file"]
        if path:
            with open(path, "w") as fh:
                fh.write(f"{vol:.3f}\n")
            _log.info("[astat] wrote audio scale value to '%s'", path)
        else:
            _log.info("[astat] (min=%.3f/max=%.3f), normalize volume "
                      "with \"-s %.3f\"", -fmin, fmax, vol)

    @staticmethod
    def suggested_rescale(state) -> float:
        peak = max(int(state["max"]), -int(state["min"]))
        return 32767.0 / peak if peak else 1.0


def _scan_pairs(elems, combine):
    """``jax.lax.associative_scan`` over axis 0 of a list of tensors: the
    same odd/even recursion, so every combine sees the same operands."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _scan_pairs(reduced, combine)
    if n % 2 == 0:
        even = combine([e[0:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([e[0:1], ev])
        full = torch.empty((n,) + e.shape[1:], dtype=e.dtype,
                           device=e.device)
        full[0::2] = ev
        full[1::2] = od
        out.append(full)
    return out


def _scan_pairs_amplified(g, b, combine, plain):
    """``_scan_pairs`` of the affine maps ``(g, b)`` as XLA computes it in
    a jitted step where ``-s``'s amplify feeds the scan.  XLA recomputes
    ``b = alpha * x`` from the amplified samples inside the fusions that
    need it; there the clamp of the amplify leaves a select between each
    product and its sum, so LLVM contracts no product of a level-0 pair
    into a fused multiply-add (``plain``).  One fusion instead reads ``b``
    back from memory and contracts its level-0 pairs (``combine``); each
    value of a deeper level comes from one of the two.  Found in the
    optimized program's fusions: the up-sweep's levels 1-3 are written
    from the samples, level 4 from ``b``, and level m > 4 from level m-4,
    so a value recomputed from level s descends from the contracted copy
    when s >= 0 and s % 4 == 0 (``contracted``; s = 0 is ``b`` itself,
    s < 0 the samples).  The down-sweep at depth j recomputes its
    elements from level j-3; the bottom of the recursion (depth D) comes
    from level D-4, and where depth D-1 holds two elements, its first
    from level D-5.  Checked against the jitted JAX step on every length
    from 2 to 700 and on lengths up to 2^18 near each power of two."""
    def contracted(level):
        return level >= 0 and level % 4 == 0

    def scan(copies, depth):
        n = copies["plain"][0].shape[0]
        if n < 2:
            return copies["fused" if contracted(depth - 4) else "plain"]
        reduced = {}
        for key, (gg, bb) in copies.items():
            pair = ([gg[0:-1:2], bb[0:-1:2]], [gg[1::2], bb[1::2]])
            reduced[key] = (plain(*pair) if depth == 0 and key == "plain"
                            else combine(*pair))
        odd = scan(reduced, depth + 1)
        source = depth - (4 if n == 2 else 3)
        gg, bb = copies["fused" if contracted(source) else "plain"]
        if n % 2 == 0:
            even = combine([e[0:-1] for e in odd], [gg[2::2], bb[2::2]])
        else:
            even = combine(list(odd), [gg[2::2], bb[2::2]])
        out = []
        for e, ev, od in zip((gg, bb), even, odd):
            full = torch.empty((n,) + e.shape[1:], dtype=e.dtype,
                               device=e.device)
            full[0::2] = torch.cat([e[0:1], ev])
            full[1::2] = od
            out.append(full)
        return out

    return scan({"plain": (g, b), "fused": (g, b)}, 0)


@register
class LowpassFilter(AudioFilter):
    """filter_lowpass.c: single-pole IIR smoothing across samples,
    out[t] = (1-a)*out[t-1] + a*x[t], solved as the JAX filter solves it:
    an associative scan of the affine maps (g, b), composed as
    (g2*g1, g2*b1 + b2), in ``lax.associative_scan``'s recursion.  The
    jitted step fuses ``g2*b1 + b2`` and the carry's ``g*c + b`` into
    fused multiply-adds; op by op each is rounded twice.  Where ``-s``
    scales the samples in the same jitted step (``after_amplify``, set by
    the audio chain), its level-0 pairs are contracted in some copies
    and not in others (``_scan_pairs_amplified``)."""

    info = ModuleInfo(name="lowpass", kind=ModuleKind.FILTER,
                      media="audio")
    desc = ModuleDesc(name="lowpass", comment="audio low-pass filter",
                      params=[ParamSpec("taps", "filter strength", "d",
                                        30, 1, 1000)])
    slots = FilterSlot.PRE_M
    media = "audio"

    def init_state(self, rate: int, channels: int,
                   device: torch.device) -> Any:
        return torch.zeros((channels,), dtype=torch.float32, device=device)

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        n, s, c = ab.pcm.shape
        if n * s == 0:
            return ab, state
        alpha = 1.0 / float(self.options["taps"])
        flat = ab.pcm.reshape(n * s, c).to(torch.float32)
        g = torch.full_like(flat, _F32(1.0 - alpha))
        b = _F32(alpha) * flat
        fused = self.jitted

        def compose(left, right):
            gl, bl = left
            gr, br = right
            return [gl * gr, fma32(gr, bl, br) if fused else gr * bl + br]

        if fused and self.after_amplify:
            gains, outs = _scan_pairs_amplified(
                g, b, compose,
                lambda left, right: [left[0] * right[0],
                                     right[0] * left[1] + right[1]])
        else:
            gains, outs = _scan_pairs([g, b], compose)
        carry = state[None, :]
        out = fma32(gains, carry, outs) if fused else gains * carry + outs
        pcm = out.clamp(-32768, 32767).to(torch.int16).reshape(n, s, c)
        return ab.with_pcm(pcm), out[-1]


@register
class DetectSilenceFilter(AudioFilter):
    """filter_detectsilence.c: detect silence intervals in the audio
    track and print them (scan_only) or a tcmp3cut command line of the
    song-start positions at the end.

    A frame is silence when int(sum |s| / 32767) == 0; consecutive
    silent frames accumulate (short gaps do not reset the counter, as in
    the reference), and an interval [id-zeros, id-1] is reported at the
    first non-silent frame once zeros >= silence_frames.  The float32 sum
    of the JAX filter is only compared with 32767: below 2^24 every
    partial sum of integers is exact, and past it the sum stays past
    32767 in any order, so the exact integer sum decides alike.  The
    counter runs on the host over the batch's flags, read back once a
    batch in ``collect``."""

    info = ModuleInfo(name="detectsilence", kind=ModuleKind.FILTER,
                      media="audio")
    desc = ModuleDesc(name="detectsilence",
                      comment="detect silence intervals",
                      params=[ParamSpec("scan_only", "only print "
                                        "intervals, no tcmp3cut line",
                                        "d", 0, 0, 1),
                              ParamSpec("silence_frames", "min silent "
                                        "frames for a song transition",
                                        "d", 4, 1, 1 << 30)])
    slots = FilterSlot.PRE_S
    media = "audio"

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.intervals: list = []

    def init_state(self, rate: int, channels: int,
                   device: torch.device) -> Any:
        """``zeros`` and ``fid`` are host ints once ``collect`` has run;
        ``silent`` holds the last batch's per-frame flags (a device
        tensor until then)."""
        return {"zeros": 0, "fid": 0,
                "silent": torch.zeros((0,), dtype=torch.bool,
                                      device=device)}

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        state = self._settle(state)
        tot = ab.pcm.to(torch.int32).abs().to(torch.int64).sum(dim=(1, 2))
        return ab, {"zeros": state["zeros"], "fid": state["fid"],
                    "silent": tot < 32767}

    def _settle(self, state: Any) -> Any:
        """Run the counter over the flags not yet counted: the intervals
        that end in them are recorded."""
        silent = state["silent"]
        if not len(silent):
            return state
        zeros, fid = state["zeros"], state["fid"]
        sf = self.options["silence_frames"]
        for sil in silent.tolist():
            if not sil and zeros >= sf:
                self.intervals.append((fid - zeros, fid - 1))
                zeros = 0
            elif sil:
                zeros += 1
            fid += 1
        return {"zeros": zeros, "fid": fid,
                "silent": silent[:0]}

    def collect(self, state: Any) -> None:
        new = self._settle(state)
        state.update(new)

    def finalize(self, state: Any) -> None:
        if self.options["scan_only"]:
            for s, e in self.intervals:
                _log.info("[detectsilence] silence interval in frames "
                          "[%d-%d]", s, e)
        elif self.intervals:
            songs = ",".join(str(s) for s, _ in self.intervals)
            _log.info("[detectsilence] ********** Songs ***********")
            _log.info("[detectsilence] ,%s", songs)
            _log.info("[detectsilence] Execute: tcmp3cut -i in.mp3 -o "
                      "base -t ,%s", songs)


@register
class ResampleFilter(AudioFilter):
    """filter_resample.c analogue: rate conversion inside the filter
    chain through the polyphase resampler (``ops/audio.py``
    ``resample_poly``), each audio frame resampled on its own, so the
    batch keeps its per-frame layout."""

    info = ModuleInfo(name="resample", kind=ModuleKind.FILTER,
                      media="audio")
    desc = ModuleDesc(
        name="resample", comment="audio resampler",
        params=[ParamSpec("rate", "output sample rate", "d", 48000,
                          4000, 192000)])
    slots = FilterSlot.PRE_S
    media = "audio"

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        rate = self.options["rate"]
        if rate == ab.rate:
            return ab, state
        pcm = audio_ops.resample_poly(ab.pcm, ab.rate, rate,
                                      jitted=self.jitted)
        return AudioBatch(pcm=pcm, rate=rate, channels=ab.channels,
                          attrs=ab.attrs, frame_ids=ab.frame_ids), state
