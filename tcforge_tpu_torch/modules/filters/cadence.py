"""Cadence filters: ivtc, 32detect, decimate, 32drop — inverse telecine.

The port of ``tcforge_tpu/modules/filters/cadence.py`` (rebuilds of
``filter_ivtc.c``, ``filter_32detect.c``, ``filter_decimate.c`` and
``filter_32drop.c``).  The classic NTSC workflow is ``-J ivtc,decimate``
(29.97i telecined -> 23.976p): ivtc reassembles progressive frames by
choosing the best-matching field pairing from a 3-frame window,
decimate drops the duplicate frame in each group of 5.  Variable output
counts are expressed through the SKIPPED frame attribute, which the
engine drops at write.

All in plain torch: the JAX package runs no hand kernel here.  Where
the JAX filter walks the batch with a ``lax.scan`` whose step depends
on the data (decimate's duplicate pick, 32drop's interlace test), the
port computes that datum for the whole batch on the device, pulls the
few integers in one copy, runs the integer state machine on the host
and assembles the frames with one gather: one wait per batch in place
of one per frame.  Those state machines' counters are Python ints in
the carried state (``interop.carry_from_numpy`` converts the
JAX filters' states).  The float tests run in float32 as XLA compiles
them in the JAX engine's jitted chain (``_comb_ratio``).
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import (ATTR_INTERLACED, ATTR_SKIPPED,
                                          FrameBatch)
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)

_log = logging.getLogger("tcforge_tpu_torch")


def _attrs(fb: FrameBatch) -> torch.Tensor:
    if fb.attrs is not None:
        return fb.attrs
    return torch.zeros((fb.batch,), dtype=torch.int32, device=fb.device)


def _mark(fb: FrameBatch, mask: torch.Tensor, flag: int) -> torch.Tensor:
    """The batch's attrs with ``flag`` set where ``mask`` holds."""
    attrs = _attrs(fb)
    return torch.where(mask, attrs | flag, attrs)


def _host_mask(mask: List[bool], device: torch.device) -> torch.Tensor:
    return torch.tensor(mask, dtype=torch.bool, device=device)


def _require_420(name: str, fmt: ImageFormat) -> None:
    if fmt != ImageFormat.YUV420P:
        raise ValueError(f"{name} requires YUV420P")


def _zero_frames(n: int, width: int, height: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    def z(h, w):
        return torch.zeros((n, h, w), dtype=torch.uint8, device=device)
    return {"y": z(height, width), "u": z(height // 2, width // 2),
            "v": z(height // 2, width // 2)}


# --------------------------------------------------------------------- #
# ivtc


@lru_cache(maxsize=16)
def _ivtc_rows(height: int, field: int,
               device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The rows of ivtc's metric grid and the rows above and below them,
    on ``device``: the combing test walks the opposite-parity field
    around line base = (field ? 2 : 1), rows stepping 4
    (filter_ivtc.c:207-240); a last row whose lower neighbour lies past
    the plane is left out, as in the JAX filter."""
    base = 2 if field else 1
    rows = np.arange(base, height - 2 + base, 4)
    rows = torch.as_tensor(rows[(rows + 1) < height], dtype=torch.int64,
                           device=device)
    return rows - 1, rows, rows + 1


@register
class IvtcFilter(VideoFilter):
    """filter_ivtc.c: inverse telecine via best field match.

    State carries the previous two raw input frames; output frame j is
    assembled from the window (j-2, j-1, j) exactly like the reference's
    3-slot ring, with the first two stream frames marked SKIPPED.
    """

    info = ModuleInfo(name="ivtc", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="ivtc", comment="inverse telecine filter", version="0.4.1",
        capabilities="VYE",
        params=[ParamSpec("field", "which field to replace "
                          "(0=top 1=bottom)", "d", 0, 0, 1),
                ParamSpec("magic", "perform magic", "d", 0, 0, 1),
                ParamSpec("verbose", "print verbose information", "d", 0,
                          0, 1)])
    slots = FilterSlot.PRE_S

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        _require_420("ivtc", fmt)
        return _zero_frames(2, width, height, device)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        field = self.options["field"]
        n, h, dev = fb.batch, fb.height, fb.device

        # window arrays: W[j] = input j-2, W[j+1] = j-1, W[j+2] = j
        wy = torch.cat([state["y"], fb.y])
        wu = torch.cat([state["u"], fb.u])
        wv = torch.cat([state["v"], fb.v])

        # the metric grid's rows of every window frame, and those above
        # and below them; 4 samples on / 12 off along x
        above, rows, below = _ivtc_rows(h, field, dev)
        a = wy.index_select(1, above).to(torch.int16)
        b = wy.index_select(1, below).to(torch.int16)
        centre = wy[1:-1].index_select(1, rows).to(torch.int16)
        xs_mask = (torch.arange(fb.width, device=dev) % 16) < 4

        def metric(lo: int) -> torch.Tensor:
            """Comb hits of the current frames' grid rows between the
            neighbour rows of window frames lo .. lo + n."""
            comb = ((a[lo:lo + n] - centre).to(torch.int32)
                    * (b[lo:lo + n] - centre))
            return ((comb > 100) & xs_mask).sum(dim=(-2, -1),
                                                dtype=torch.int32)

        p, c, nxt = metric(0), metric(1), metric(2)

        # chosen: argmin with the reference's tie order (c, p, n)
        lowest = c
        chosen = torch.ones((n,), dtype=torch.int32, device=dev)
        chosen = torch.where(p < lowest, 0, chosen)
        lowest = torch.minimum(lowest, p)
        chosen = torch.where(nxt < lowest, 2, chosen)
        lowest = torch.minimum(lowest, nxt)
        if self.options["magic"]:
            cond = (c < 50) & ((lowest - c).abs() < 10) & (p + c + nxt > 1000)
            chosen = torch.where(cond, 1, chosen)
        # window index of the frame that gives the replaced field
        pick = torch.arange(n, device=dev) + chosen

        def assemble(wp: torch.Tensor) -> torch.Tensor:
            """The current frame with its field-``field`` lines taken
            from the chosen frame (ivtc_copy_field pair semantics)."""
            out = wp[1:-1].clone()
            out[:, field::2] = wp[:, field::2].index_select(0, pick)
            return out

        # first two stream frames are buffer-warmup -> SKIPPED
        attrs = _mark(fb, fb.frame_ids < 2, ATTR_SKIPPED)
        new_state = {"y": wy[-2:].clone(), "u": wu[-2:].clone(),
                     "v": wv[-2:].clone()}
        out = fb.with_planes(y=assemble(wy), u=assemble(wu),
                             v=assemble(wv)).with_attrs(attrs)
        return out, new_state


# --------------------------------------------------------------------- #
# 32detect

COLOR_EQUAL = 10
COLOR_DIFF = 30
THRESHOLD = 9


def comb_counts(plane: torch.Tensor, eq: int,
                diff: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two comb counts cc_1/cc_2 of interlace_test
    (filter_32detect.c:88-135) per frame of (N, H, W), int32: line pairs
    of one field that agree (< eq) while the line between differs
    (> diff), walking from line 0 and from line 1."""
    s = plane.to(torch.int16)
    h = plane.shape[-2]
    s1 = s[..., 0:h - 4:2, :]
    s2 = s[..., 1:h - 3:2, :]
    s3 = s[..., 2:h - 2:2, :]
    s4 = s[..., 3:h - 1:2, :]
    cc1 = (((s1 - s3).abs() < eq) & ((s1 - s2).abs() > diff)) \
        .sum(dim=(-2, -1), dtype=torch.int32)
    cc2 = (((s2 - s4).abs() < eq) & ((s2 - s3).abs() > diff)) \
        .sum(dim=(-2, -1), dtype=torch.int32)
    return cc1, cc2


def _comb_ratio(cc: torch.Tensor, scale: float, w: int,
                h: int) -> torch.Tensor:
    """``cc * scale / (w * h)`` in float32, as the JAX engine's jitted
    chain computes it: XLA turns the division by the constant area into
    a multiplication by its float32 reciprocal and folds ``scale`` into
    it, so the result is ``cc * (scale * (1 / area))``.  (At 720x480 a
    true division gives another score for 19 of the counts below
    200,000; JAX run op by op, outside a jit, divides.)"""
    factor = np.float32(scale) * (np.float32(1) / np.float32(w * h))
    return cc.to(torch.float32) * float(factor)


def interlace_score(plane: torch.Tensor, eq: int, diff: int,
                    counts: bool = False) -> Any:
    """interlace_test port: per-frame combing score in 0.1% units over a
    (N, H, W) plane, int32 (the float32 ratio truncated toward zero).
    With ``counts`` also the raw cc_1/cc_2 comb counts."""
    cc1, cc2 = comb_counts(plane, eq, diff)
    cc = _comb_ratio(cc1 + cc2, 1000.0, plane.shape[-1],
                     plane.shape[-2]).to(torch.int32)
    return (cc1, cc2, cc) if counts else cc


@register
class Detect32Filter(VideoFilter):
    """filter_32detect.c: flag interlaced frames (and optionally force a
    deinterlace mode on them via frame attributes)."""

    info = ModuleInfo(name="32detect", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="32detect", comment="3:2 pulldown / interlace detector",
        capabilities="VYR",
        params=[
            ParamSpec("threshold", "interlace detection threshold", "d",
                      THRESHOLD, 1, 1000),
            ParamSpec("chromathres", "chroma detection threshold", "d",
                      THRESHOLD // 2, 1, 1000),
            ParamSpec("equal", "threshold for equal colors", "d",
                      COLOR_EQUAL, 1, 255),
            ParamSpec("diff", "threshold for different colors", "d",
                      COLOR_DIFF, 1, 255),
            ParamSpec("chromaeq", "threshold for equal chroma", "d",
                      COLOR_EQUAL // 2, 1, 255),
            ParamSpec("chromadi", "threshold for different chroma",
                      "d", COLOR_DIFF // 2, 1, 255),
            ParamSpec("force_mode", "force deinterlace mode on detection",
                      "d", 0, 0, 5),
            ParamSpec("pre", "run as pre filter", "d", 1, 0, 1),
            ParamSpec("verbose", "show results", "d", 0, 0, 1)])
    slots = FilterSlot.PRE_M

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        opt = self.options
        if not (opt["force_mode"] or opt["verbose"]):
            return fb.with_attrs(_attrs(fb)), state     # nothing reads it
        eq, diff = opt["equal"], opt["diff"]
        if fb.rgb is not None:
            cc1, cc2, score = interlace_score(
                fb.rgb.reshape(fb.batch, fb.height, -1), eq, diff,
                counts=True)
            interlaced = score > opt["threshold"]
        else:
            ceq, cdiff = max(1, opt["chromaeq"]), max(1, opt["chromadi"])
            cc1, cc2, score = interlace_score(fb.y, eq, diff, counts=True)
            interlaced = ((score > opt["threshold"])
                          | (interlace_score(fb.u, ceq, cdiff)
                             > opt["chromathres"])
                          | (interlace_score(fb.v, ceq, cdiff)
                             > opt["chromathres"]))
        attrs = _attrs(fb)
        if opt["force_mode"]:
            attrs = torch.where(interlaced, attrs | ATTR_INTERLACED, attrs)
        if opt["verbose"]:
            ids = (fb.frame_ids if fb.frame_ids is not None
                   else torch.arange(fb.batch, dtype=torch.int32,
                                     device=fb.device))
            state = {"ids": ids, "cc1": cc1, "cc2": cc2, "cc": score,
                     "flag": interlaced}
        return fb.with_attrs(attrs), state

    def collect(self, state: Any) -> None:
        if not (self.options["verbose"] and isinstance(state, dict)):
            return
        ids, cc1, cc2, cc, flag = (
            state[k].cpu().tolist()
            for k in ("ids", "cc1", "cc2", "cc", "flag"))
        for n, fid in enumerate(ids):
            if fid < 0:
                continue
            _log.info("[32detect] (0) frame [%06d]: (1) = %5d | (2) = %5d "
                      "| (3) = %3d | interlaced = %s", fid, cc1[n], cc2[n],
                      cc[n], "yes" if flag[n] else "no")


# --------------------------------------------------------------------- #
# decimate

FRBUFSIZ = 6


@lru_cache(maxsize=256)
def _decimate_plan(frame_in: int, frame_out: int, phase: int, n: int,
                   device: torch.device):
    """Where a batch of ``n`` arrivals lands in decimate's ring and what
    each of its picks compares, which follow from the counters alone
    (``phase`` is the arrival count, from 5 on folded to 5 + count % 5).
    Rows index the pool of the carried ring (0..5) followed by the
    batch's samples (6..): ``picks`` is (picks, 6) int64 on ``device``,
    the six ring rows from ``frame_out`` on at each pick (None without
    one), ``rows`` the pool row of each slot after the batch."""
    rows = list(range(FRBUFSIZ))
    picks = []
    count = phase
    for k in range(n):
        rows[frame_in] = FRBUFSIZ + k
        frame_in = (frame_in + 1) % FRBUFSIZ
        count += 1
        if count > 4:
            if count % 5 == 0:
                picks.append([rows[(frame_out + j) % FRBUFSIZ]
                              for j in range(FRBUFSIZ)])
            frame_out = (frame_out + 1) % FRBUFSIZ
    return (torch.tensor(picks, device=device) if picks else None,
            torch.tensor(rows, device=device))


@register
class DecimateFilter(VideoFilter):
    """filter_decimate.c: drop the near-duplicate frame in each group of
    5 (the 3:2 pulldown residue after ivtc).

    The 6-slot ring logic, exactly: frames are delayed by 4, every 5th
    arrival picks the minimum |diff| neighbour pair of the ring (Y plane
    sampled every 16th byte) and invalidates that slot; invalid slots
    emit SKIPPED frames.

    Which slots a batch writes, and which six rows each pick compares,
    follow from the arrival count alone (``_decimate_plan``); the
    device gathers those rows from the carried ring and the batch's
    samples and finds every pick's minimum in one pass; the picks (at
    most one per five frames) come to the host in one copy, and the
    ``ok`` ring runs there.  State: ``y``/``u``/``v`` (the four delayed
    frames) and ``metric`` (the ring's samples) on the device; ``ok`` a
    list of six ints, ``frame_in``, ``frame_out`` and ``count`` ints.
    """

    info = ModuleInfo(name="decimate", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="decimate", comment="NTSC decimation (4 of 5 frames)",
        capabilities="VYE",
        params=[ParamSpec("verbose", "print verbose information", "d", 0,
                          0, 1)])
    slots = FilterSlot.POST_S

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        _require_420("decimate", fmt)
        ns = (height * width + 15) // 16     # subsampled metric length
        state = _zero_frames(4, width, height, device)
        state.update(
            metric=torch.zeros((FRBUFSIZ, ns), dtype=torch.uint8,
                               device=device),
            ok=[1] * FRBUFSIZ, frame_in=0, frame_out=0, count=0)
        return state

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        n, dev = fb.batch, fb.device

        count = state["count"]
        picks, rows = _decimate_plan(
            state["frame_in"], state["frame_out"],
            count if count < 5 else 5 + count % 5, n, dev)

        # the same bytes filter_decimate.c compares: every 16th of the
        # flattened luma plane
        pool = torch.cat([state["metric"], fb.y.reshape(n, -1)[:, ::16]])
        jmin = None
        if picks is not None:
            seq = pool[picks].to(torch.int16)
            diffs = (seq[:, 1:] - seq[:, :-1]).abs().sum(-1,
                                                         dtype=torch.int32)
            jmin = diffs.argmin(dim=1)       # the first minimum

        # delayed frame path: window = [carry(4), batch][0:n]
        win = {k: torch.cat([state[k], p])
               for k, p in (("y", fb.y), ("u", fb.u), ("v", fb.v))}
        new_state = {k: w[n:n + 4].clone() for k, w in win.items()}
        new_state["metric"] = pool[rows]

        # the ok ring (after the device work above is queued: reading
        # the picks waits for it)
        jmin = jmin.tolist() if jmin is not None else []
        ok = list(state["ok"])
        frame_in, frame_out, count = (state["frame_in"], state["frame_out"],
                                      state["count"])
        skipped = []
        for k in range(n):
            ok[frame_in] = 1
            frame_in = (frame_in + 1) % FRBUFSIZ
            count += 1
            if count > 4 and count % 5 == 0:
                ok[(frame_out + jmin.pop(0)) % FRBUFSIZ] = 0
            buffering = count <= 4
            skipped.append(buffering or ok[frame_out] != 1)
            if not buffering:
                frame_out = (frame_out + 1) % FRBUFSIZ
        new_state.update(ok=ok, frame_in=frame_in, frame_out=frame_out,
                         count=count)

        attrs = _mark(fb, _host_mask(skipped, dev), ATTR_SKIPPED)
        out = fb.with_planes(y=win["y"][:n], u=win["u"][:n],
                             v=win["v"][:n]).with_attrs(attrs)
        return out, new_state


# --------------------------------------------------------------------- #
# 32drop


@register
class Drop32Filter(VideoFilter):
    """filter_32drop.c: 3:2 inverse telecine by dropping interlaced
    duplicates with a 5-frame sync counter.

    Per frame (filter_32drop.c:168-218): run the combing test
    (thresholds 50/100, critical ratio 5e-5); an interlaced frame is
    skipped while the drop budget allows (dcnt < 8, +5 per drop), a
    SECOND consecutive interlaced frame gets the previous interlaced
    frame's even rows + chroma merged in (merge_frames, :90-106), and
    when dropping would lose sync the last progressive frame is copied
    over.  dcnt <= -5 forces a skip to hold the 5-frame cadence on
    progressive material.

    The combing test of every frame of the batch runs on the device
    and comes to the host in one copy; the counters (``fnum``,
    ``lfnum``, ``dcnt``, Python ints in the state) run there and name
    each output's source frames, which one gather assembles.  ``last``
    and ``lasti`` are {"y", "u", "v"} of one frame each.
    """

    info = ModuleInfo(name="32drop", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="32drop", comment="3:2 telecine drop (filter_32drop)",
        version="0.4", capabilities="VRYE", params=[])
    slots = FilterSlot.PRE_M

    _EQ = 50
    _DIFF = 100
    _CRIT = 0.00005

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        _require_420("32drop", fmt)

        def frame():
            return {k: p[0] for k, p in
                    _zero_frames(1, width, height, device).items()}
        return {"last": frame(), "lasti": frame(),
                "fnum": 0, "lfnum": -1, "dcnt": 0}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        n, dev = fb.batch, fb.device
        cc1, cc2 = comb_counts(fb.y, self._EQ, self._DIFF)
        isint = _comb_ratio(cc1 + cc2, 1.0, fb.width, fb.height) > self._CRIT

        # sources: 0 = last progressive, 1 = last interlaced, 2 + k =
        # frame k of the batch
        pool = {k: torch.cat([state["last"][k][None], state["lasti"][k][None],
                              p])
                for k, p in (("y", fb.y), ("u", fb.u), ("v", fb.v))}
        last, lasti = 0, 1
        fnum, lfnum, dcnt = state["fnum"], state["lfnum"], state["dcnt"]
        odd_src, even_src, skips = [], [], []
        for k, interlaced in enumerate(isint.tolist()):
            cur = 2 + k
            second = interlaced and fnum - lfnum == 2
            first_i = interlaced and not second
            # second interlaced in a row: even rows + chroma from the
            # previous interlaced frame
            odd, even = cur, (lasti if second else cur)
            can_drop = dcnt < 8
            skip = first_i and can_drop
            # can't drop: copy the last progressive frame over instead
            # (only when the previous frame was progressive, fnum > 0)
            if first_i and not can_drop and fnum - lfnum < 3 and fnum > 0:
                odd = even = last
            if skip:
                dcnt += 5
            if dcnt <= -5:                   # progressive-source sync drop
                skip = True
                dcnt += 5
            odd_src.append(odd)
            even_src.append(even)
            skips.append(skip)
            if not interlaced:
                last, lfnum = cur, fnum
            if first_i:
                lasti = cur
            fnum += 1
            dcnt -= 1

        even_t = torch.tensor(even_src, device=dev)
        out_y = pool["y"][even_t]
        out_y[:, 1::2] = pool["y"][torch.tensor(odd_src, device=dev), 1::2]
        new_state = {
            "last": {k: p[last].clone() for k, p in pool.items()},
            "lasti": {k: p[lasti].clone() for k, p in pool.items()},
            "fnum": fnum, "lfnum": lfnum, "dcnt": dcnt}
        attrs = _mark(fb, _host_mask(skips, dev), ATTR_SKIPPED)
        out = fb.with_planes(y=out_y, u=pool["u"][even_t],
                             v=pool["v"][even_t]).with_attrs(attrs)
        return out, new_state
