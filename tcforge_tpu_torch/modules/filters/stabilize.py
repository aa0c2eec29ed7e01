"""stabilize (pass 1) and transform (pass 2): video stabilization.

The port of ``tcforge_tpu/modules/filters/stabilize.py`` (the
``filter/stabilize/`` subproject, Georg Martius' vid.stab precursor):

- ``stabilize`` measures each frame against the one before it with a
  grid of square fields: per field a coarse block search (stride
  ``stepsize`` over +-maxshift, dx outer and dy inner) and a fine one
  (+-(stepsize-1) around the coarse best), a later candidate winning
  only with a strictly smaller SAD; fields at or beyond the window's
  edge are discarded.  On the card the whole batch is one launch of
  ``ops/kernels.py`` ``stabilize_field_search`` (frame n against frame
  n-1, the carried frame for n = 0); its plain version is the JAX loop,
  a gather and a sum per candidate.  The fields' Michelson contrast is
  plain torch.  ``collect`` reads the batch back once and runs the
  robust translation and rotation estimate on the host in float64
  numpy, as the JAX filter does; ``finalize`` writes the ``.trf`` file.
- ``transform`` reads the ``.trf`` file, smooths the camera path on the
  host and warps every frame by the inverse transform: one launch of
  ``stabilize_warp``'s kernel ``transform_warp`` per plane, whose plain
  version is ``warp_plane`` batched over the frames.  Its ``sharpen``
  runs the port's ``UnsharpFilter`` (the ``unsharp`` kernel) on all
  three planes.

Gathers follow jnp indexing: a negative index wraps once, then every
index clamps to the edge (``_jidx``).  The warp is float32 as the
jitted JAX filter computes it: its per-frame parameters come from a
table made once on the host (``warp_params``), with ``cos`` and ``sin``
from the C library's ``cosf``/``sinf``, which XLA's CPU code calls, and
the sums that XLA contracts into fused multiply-adds computed as such
(``ops/fp32.py`` ``fma32``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
from functools import lru_cache
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)
from tcforge_tpu_torch.ops import kernels
from tcforge_tpu_torch.ops.fp32 import fma32

_log = logging.getLogger("tcforge_tpu_torch")

DEFAULT_TRANS_FILE = "transforms.dat"


# ---------------------------------------------------------------------------
# Transform record math (transform.c): host-side numpy on (N, 4) arrays
# with columns [x, y, alpha, zoom].


def cleanmean(vals: np.ndarray) -> Tuple[float, float, float]:
    """Pentile-trimmed mean (transform.c:291-305): drop len/5 smallest
    and largest, return (mean, min, max) of the remainder."""
    v = np.sort(vals)
    cut = len(v) // 5
    kept = v[cut:len(v) - cut]
    return float(kept.mean()), float(kept[0]), float(kept[-1])


def cleanmean_xy(ts: np.ndarray) -> Tuple[float, float]:
    """cleanmean_xy_transform (transform.c:184-200): per-axis trimmed
    mean of field translations."""
    mx, _, _ = cleanmean(ts[:, 0])
    my, _, _ = cleanmean(ts[:, 1])
    return mx, my


def cleanmaxmin_xy(ts: np.ndarray, percentil: int) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    """cleanmaxmin_xy_transform (transform.c:221-234)."""
    cut = len(ts) * percentil // 100
    xs = np.sort(ts[:, 0])
    ys = np.sort(ts[:, 1])
    mn = np.array([xs[cut], ys[cut]])
    mx = np.array([xs[len(ts) - cut - 1], ys[len(ts) - cut - 1]])
    return mn, mx


def init_fields(width: int, height: int, size: int, maxshift: int,
                stepsize: int) -> np.ndarray:
    """Measurement-field grid (initFields, filter_stabilize.c:198-230).
    Returns (F, 2) int centers (x, y)."""
    rows = max(3, (height - maxshift * 2) // size - 1)
    cols = max(3, (width - maxshift * 2) // size - 1)
    border = size // 2 + maxshift + stepsize
    step_x = (width - 2 * border) // max(cols - 1, 1)
    step_y = (height - 2 * border) // max(rows - 1, 1)
    centers = [(border + i * step_x, border + j * step_y)
               for j in range(rows) for i in range(cols)]
    return np.asarray(centers, np.int32)


def smooth_transforms(ts: np.ndarray, smoothing: int) -> np.ndarray:
    """Sliding-average lowpass with drift-killing EMA
    (preprocess_transforms, filter_transform.c:625-686)."""
    n = len(ts)
    s = smoothing * 2 + 1
    tau = 1.0 / (3 * s)
    orig = ts.copy()
    out = ts.copy()
    s_sum = orig[:min(smoothing, n)].sum(axis=0)
    avg2 = np.zeros(4)
    for i in range(n):
        old = orig[i - smoothing - 1] if i - smoothing - 1 >= 0 \
            else np.zeros(4)
        new = orig[i + smoothing] if i + smoothing < n else np.zeros(4)
        s_sum = s_sum - old + new
        avg = s_sum / s
        out[i] = orig[i] - avg
        avg2 = avg2 * (1 - tau) + out[i] * tau
        out[i] = out[i] - avg2
    return out


def preprocess_transforms(ts: np.ndarray, width: int, height: int, *,
                          smoothing: int, invert: int, relative: int,
                          maxshift: int, maxangle: float, zoom: float,
                          optzoom: int) -> np.ndarray:
    """Full path preprocessing (filter_transform.c:615-740)."""
    ts = np.asarray(ts, np.float64).copy()
    if len(ts) == 0:
        return ts
    if smoothing > 0:
        ts = smooth_transforms(ts, smoothing)
    if invert:
        ts = -ts
    if relative:
        ts = np.cumsum(ts, axis=0)
    if maxshift != -1:
        ts[:, 0] = np.clip(ts[:, 0], -maxshift, maxshift)
        ts[:, 1] = np.clip(ts[:, 1], -maxshift, maxshift)
    if maxangle != -1.0:
        ts[:, 2] = np.clip(ts[:, 2], -maxangle, maxangle)
    if optzoom != 0 and len(ts) > 1:
        mn, mx = cleanmaxmin_xy(ts, 10)
        zx = 2 * max(mx[0], abs(mn[0])) / width
        zy = 2 * max(mx[1], abs(mn[1])) / height
        zoom += 100 * max(zx, zy)
        _log.info("[stabilize] transform: final zoom: %f", zoom)
    if zoom != 0:
        ts[:, 3] += zoom
    return ts


def write_trf(path: str, ts: List[np.ndarray], params: dict) -> None:
    """.trf writer (stabilize_stop, filter_stabilize.c:1084-1102)."""
    with open(path, "w") as f:
        for k, v in params.items():
            f.write(f"# {k:>13s} = {v}\n")
        f.write("# Transforms\n#C FrameNr x y alpha zoom extra\n")
        for i, t in enumerate(ts):
            f.write(f"{i} {t[0]:6.4f} {t[1]:6.4f} {t[2]:8.5f} "
                    f"{t[3]:6.4f} 0\n")


def read_trf(path: str) -> np.ndarray:
    """.trf reader (read_input_file, filter_transform.c:554-597);
    accepts the 5-column (no zoom) legacy format too."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) == 6:
                rows.append([float(parts[1]), float(parts[2]),
                             float(parts[3]), float(parts[4])])
            elif len(parts) == 5:
                rows.append([float(parts[1]), float(parts[2]),
                             float(parts[3]), 0.0])
            else:
                raise ValueError(f"cannot parse transforms line: {line!r}")
    return np.asarray(rows, np.float64).reshape(-1, 4)


# ---------------------------------------------------------------------------
# Pass 1: stabilize


def _jidx(i: torch.Tensor, n: int) -> torch.Tensor:
    """A jnp gather's index along an axis of ``n``: a negative index
    wraps once, then it clamps to the edge."""
    return torch.where(i < 0, i + n, i).clamp_(0, n - 1)


def _field_patch_indices(centers: np.ndarray, size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(F, S, S) row/col gather indices for all field patches."""
    s2 = size // 2
    offs = np.arange(size) - s2
    fy = centers[:, 1, None, None] + offs[None, :, None]
    fx = centers[:, 0, None, None] + offs[None, None, :]
    return fy.astype(np.int32), fx.astype(np.int32)


def _gather(plane: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor) -> torch.Tensor:
    """``plane[..., rows, cols]`` as jnp indexes it, for (..., H, W)
    planes and index tensors that broadcast against the leading
    dimensions and the fields' (F, S, S)."""
    h, w = plane.shape[-2:]
    flat = (_jidx(rows, h) * w + _jidx(cols, w)).to(torch.int64)
    lead = plane.shape[:-2]
    flat = flat.expand(torch.broadcast_shapes(
        flat.shape, (*lead, *flat.shape[-3:])))
    src = plane.reshape(*lead, h * w)
    return torch.gather(src, -1, flat.reshape(*lead, -1)).view(flat.shape)


def field_search(curr: torch.Tensor, prev: torch.Tensor, fy: torch.Tensor,
                 fx: torch.Tensor, maxshift: int, stepsize: int
                 ) -> torch.Tensor:
    """Two-stage block search for every field at once (stabilize.py
    :209-272), over (..., H, W) frames ``curr`` and ``prev`` with (F, S,
    S) int32 field indices.  Stage 1 walks the coarse +-maxshift grid at
    ``stepsize`` (dx outer, dy inner), stage 2 refines +-(stepsize-1) at
    1 px around each field's coarse best; a strict ``<`` keeps the first
    candidate among equal SADs.  Returns (..., F, 2) int32 (dx, dy)."""
    ci = curr.to(torch.int32)
    pi = prev.to(torch.int32)
    lead = curr.shape[:-2]
    patches = _gather(ci, fy, fx)                       # (..., F, S, S)

    def sad(dx, dy):
        cand = _gather(pi, fy + dy, fx + dx)
        return (cand - patches).abs_().sum((-2, -1), dtype=torch.int32)

    rng = list(range(-maxshift, maxshift + 1, stepsize))
    nf = fy.shape[0]
    best = torch.full((*lead, nf), torch.iinfo(torch.int32).max,
                      dtype=torch.int32, device=curr.device)
    bx = torch.zeros_like(best)
    by = torch.zeros_like(best)
    for dx in rng:
        for dy in rng:
            s = sad(dx, dy)
            better = s < best
            best = torch.where(better, s, best)
            bx = torch.where(better, dx, bx)
            by = torch.where(better, dy, by)
    if stepsize > 1:
        r = stepsize - 1
        cx, cy = bx[..., None, None], by[..., None, None]
        for ox in range(-r, r + 1):
            for oy in range(-r, r + 1):
                if ox == 0 and oy == 0:
                    continue
                s = sad(cx + ox, cy + oy)
                better = s < best
                best = torch.where(better, s, best)
                bx = torch.where(better, cx[..., 0, 0] + ox, bx)
                by = torch.where(better, cy[..., 0, 0] + oy, by)
    # at or beyond the window's edge: the search ran off it, discard
    bx = torch.where(bx.abs() >= maxshift, 0, bx)
    by = torch.where(by.abs() >= maxshift, 0, by)
    return torch.stack([bx, by], dim=-1)


def field_contrast(curr: torch.Tensor, fy: torch.Tensor,
                   fx: torch.Tensor) -> torch.Tensor:
    """Michelson contrast per field (contrastSubImg,
    filter_stabilize.c:349-369) over (..., H, W) frames: (..., F)."""
    patches = _gather(curr, fy, fx).to(torch.float32)
    mx = patches.amax((-2, -1))
    mn = patches.amin((-2, -1))
    return (mx - mn) / (mx + mn + 0.1)


def global_shift_search(curr: torch.Tensor, prev: torch.Tensor,
                        maxshift: int) -> torch.Tensor:
    """algo=0 brute force (stabilize.py:285-326): the full-frame
    mean absolute difference over every shift, (H, W) frames, float32
    error ``sum / area``, a strict ``<`` in dx-outer order.  Returns (2,)
    int32 (dx, dy), negated to the algo=1 convention.  Plain torch: no
    kernel yet."""
    h, w = curr.shape
    ci = curr.to(torch.int32)
    pi = prev.to(torch.int32)
    dev = curr.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    best = torch.tensor(1e20, dtype=torch.float32, device=dev)
    bdx = torch.zeros((), dtype=torch.int32, device=dev)
    bdy = torch.zeros((), dtype=torch.int32, device=dev)
    for dx in range(-maxshift, maxshift + 1):
        for dy in range(-maxshift, maxshift + 1):
            sy, sx = yy - dy, xx - dx
            valid = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
            diff = (ci - pi[sy.clamp(0, h - 1), sx.clamp(0, w - 1)]).abs()
            total = torch.where(valid, diff, 0).sum(dtype=torch.int32)
            err = total.to(torch.float32) / float(
                (w - abs(dx)) * (h - abs(dy)))
            better = err < best
            best = torch.where(better, err, best)
            bdx = torch.where(better, dx, bdx)
            bdy = torch.where(better, dy, bdy)
    return torch.stack([-bdx, -bdy])


@register
class StabilizeFilter(VideoFilter):
    """filter_stabilize.c: pass-1 motion analysis -> .trf file."""

    info = ModuleInfo(name="stabilize", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="stabilize", comment="extract inter-frame transforms "
        "(pass 1 of stabilization)", version="0.75", capabilities="VRY4",
        params=[ParamSpec("result", "transforms output file", "s", ""),
                ParamSpec("shakiness", "shake amount 1-10", "d", 4, 1, 10),
                ParamSpec("accuracy", "detection accuracy 1-15", "d", 4,
                          1, 15),
                ParamSpec("stepsize", "search stride", "d", 6, 1, 32),
                ParamSpec("algo", "0=brute force 1=fields", "d", 1, 0, 1),
                ParamSpec("mincontrast", "field contrast floor", "f",
                          0.3, 0.0, 1.0),
                ParamSpec("show", "draw fields (unsupported)", "d", 0,
                          0, 2)])
    slots = FilterSlot.POST_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.shakiness = min(10, max(1, self.options["shakiness"]))
        self.accuracy = max(self.shakiness,
                            min(15, max(1, self.options["accuracy"])))
        self.stepsize = self.options["stepsize"]
        self.algo = self.options["algo"]
        self.mincontrast = self.options["mincontrast"]
        self.maxanglevariation = 1.0
        if self.options["show"]:
            _log.warning("[stabilize] show=%d: field drawing is not "
                         "supported in this build", self.options["show"])
        self.result = self.options["result"] or (
            os.path.basename(job.video_in_file or "") + ".trf"
            if job.video_in_file else DEFAULT_TRANS_FILE)
        self.transforms: List[np.ndarray] = []
        self._seen = 0
        self._centers: Optional[np.ndarray] = None

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt == ImageFormat.RGB24:
            raise ValueError("stabilize: use YUV420P input (-V); the RGB "
                             "path is not built yet")
        self.width, self.height = width, height
        # shakiness scales both window and field size
        # (filter_stabilize.c:986-987)
        self.maxshift = min(width, height) * self.shakiness // 40
        self.field_size = self.maxshift
        if self.algo == 1:
            self._centers = init_fields(width, height, self.field_size,
                                        self.maxshift, self.stepsize)
            self.field_rows = max(3, (height - self.maxshift * 2)
                                  // self.field_size - 1)
            self.maxfields = self.accuracy * len(self._centers) // 15
            fy, fx = _field_patch_indices(self._centers, self.field_size)
            self._fy = torch.from_numpy(fy).to(device)
            self._fx = torch.from_numpy(fx).to(device)
            self._centers_t = torch.from_numpy(self._centers).to(device)
        nf = len(self._centers) if self.algo == 1 else 1
        return {"init": False,
                "prev": torch.zeros((height, width), dtype=torch.uint8,
                                    device=device),
                "shifts": torch.zeros((1, nf, 2), dtype=torch.int32,
                                      device=device),
                "contrast": torch.zeros((1, nf), dtype=torch.float32,
                                        device=device),
                "valid": torch.zeros((1,), dtype=torch.bool, device=device),
                "ids": torch.full((1,), -1, dtype=torch.int32,
                                  device=device)}

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        y, n, dev = fb.y, fb.batch, fb.device
        if self.algo == 1:
            shifts = kernels.stabilize_field_search(
                state["prev"], y, self._centers_t, self.field_size,
                self.maxshift, self.stepsize)
            contrast = field_contrast(y, self._fy, self._fx)
        else:
            prevs = torch.cat([state["prev"][None], y[:-1]])
            shifts = torch.stack([global_shift_search(y[i], prevs[i],
                                                      self.maxshift)
                                  for i in range(n)])[:, None, :]
            contrast = torch.ones((n, 1), dtype=torch.float32, device=dev)
        # had a previous frame: all but the stream's first (no copy
        # from the host, which would wait for the card)
        valid = torch.arange(n, device=dev) >= (0 if state["init"] else 1)
        ids = (fb.frame_ids if fb.frame_ids is not None
               else torch.zeros((n,), dtype=torch.int32, device=dev))
        return fb, {"init": True, "prev": y[-1].clone(), "shifts": shifts,
                    "contrast": contrast, "valid": valid, "ids": ids}

    # ---- host side -------------------------------------------------

    def collect(self, state: Any) -> None:
        """One read-back a batch: shifts, contrast (as its bits), the
        had-a-previous-frame flags and the ids in one int32 tensor."""
        shifts, contrast = state["shifts"], state["contrast"]
        n, nf = contrast.shape
        packed = torch.cat([shifts.reshape(n, 2 * nf),
                            contrast.view(torch.int32),
                            state["valid"].to(torch.int32)[:, None],
                            state["ids"].to(torch.int32)[:, None]], dim=1)
        host = packed.cpu().numpy()
        shifts = host[:, :2 * nf].reshape(n, nf, 2)
        contrast = np.ascontiguousarray(host[:, 2 * nf:3 * nf]).view(
            np.float32)
        valid, ids = host[:, 3 * nf], host[:, 3 * nf + 1]
        for i in range(n):
            if ids[i] < 0:
                continue                   # a pad frame
            if not valid[i]:
                self.transforms.append(np.zeros(4))
            elif self.algo == 0:
                self.transforms.append(
                    np.array([shifts[i, 0, 0], shifts[i, 0, 1], 0.0, 0.0]))
            else:
                self.transforms.append(
                    self._robust_transform(shifts[i], contrast[i]))
            self._seen += 1

    def _select_fields(self, contrast: np.ndarray) -> np.ndarray:
        """Segment-balanced top-contrast selection (selectfields,
        filter_stabilize.c:604-666)."""
        c = contrast.copy()
        c[c < self.mincontrast] = 0.0
        nseg = self.field_rows + 1
        seglen = len(c) // nseg + 1
        chosen: List[int] = []
        leftover = c.copy()
        for s in range(nseg):
            lo, hi = seglen * s, min(seglen * (s + 1), len(c))
            if lo >= hi:
                continue
            order = np.argsort(-c[lo:hi], kind="stable") + lo
            for idx in order[:self.maxfields // nseg]:
                if c[idx] > 0:
                    chosen.append(idx)
                    leftover[idx] = 0.0
        remaining = self.maxfields - len(chosen)
        if remaining > 0:
            order = np.argsort(-leftover, kind="stable")
            for idx in order[:remaining]:
                if leftover[idx] > 0:
                    chosen.append(idx)
        return np.asarray(sorted(set(chosen)), np.int64)

    def _robust_transform(self, shifts: np.ndarray,
                          contrast: np.ndarray) -> np.ndarray:
        """calcTransFields (filter_stabilize.c:682-781): trimmed-mean
        translation, per-field rotation angles, off-center fixup."""
        sel = self._select_fields(contrast)
        if len(sel) < 1:
            _log.warning("[stabilize] too low contrast, no field "
                         "remains in frame %d", self._seen)
            return np.zeros(4)
        ts = shifts[sel].astype(np.float64)       # (K, 2)
        fs = self._centers[sel].astype(np.float64)
        tx, ty = cleanmean_xy(ts)
        # integer center like the C (filter_stabilize.c:725-733)
        center = self._centers[sel].sum(axis=0) // len(sel)

        alpha = 0.0
        if len(self._centers) >= 6:
            rel = ts - np.array([tx, ty])
            angles = np.zeros(len(sel))
            for i in range(len(sel)):
                dx = fs[i, 0] - center[0]
                dy = fs[i, 1] - center[1]
                # fields near the rotation center carry no signal
                # (calcAngle, filter_stabilize.c:450-465)
                if abs(dx) + abs(dy) < self.maxshift:
                    angles[i] = 0.0
                else:
                    a1 = np.arctan2(dy, dx)
                    a2 = np.arctan2(dy + rel[i, 1], dx + rel[i, 0])
                    d = a2 - a1
                    angles[i] = d - 2 * np.pi if d > np.pi else (
                        d + 2 * np.pi if d < -np.pi else d)
            m, mn, mx = cleanmean(angles)
            alpha = -m
            if mx - mn > self.maxanglevariation:
                alpha = 0.0
                _log.info("[stabilize] too large angle variation (%f)",
                          mx - mn)
        # compensate off-center rotation (filter_stabilize.c:771-775)
        px = center[0] - self.width / 2
        py = center[1] - self.height / 2
        tx += (np.cos(alpha) - 1) * px - np.sin(alpha) * py
        ty += np.sin(alpha) * px + (np.cos(alpha) - 1) * py
        return np.array([tx, ty, alpha, 0.0])

    def finalize(self, state: Any) -> None:
        write_trf(self.result, self.transforms, {
            "accuracy": self.accuracy, "shakiness": self.shakiness,
            "stepsize": self.stepsize, "algo": self.algo,
            "mincontrast": self.mincontrast, "result": self.result})
        _log.info("[stabilize] wrote %d transforms to %s",
                  len(self.transforms), self.result)


# ---------------------------------------------------------------------------
# Pass 2: transform


@lru_cache(maxsize=None)
def _libm() -> ctypes.CDLL:
    """The C library's maths: XLA's CPU code calls its ``cosf`` and
    ``sinf`` (``sincosf``), which torch's and numpy's own differ from by
    an ulp in about one input in a hundred."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn in (lib.cosf, lib.sinf):
        fn.argtypes = (ctypes.c_float,)
        fn.restype = ctypes.c_float
    return lib


def _myfloor(x: torch.Tensor) -> torch.Tensor:
    """myfloor (transform.h:106-111), including the -1.0 -> -2 quirk."""
    return torch.where(x < 0, torch.trunc(x - 1), torch.trunc(x)).to(
        torch.int32)


def _myround(x: torch.Tensor) -> torch.Tensor:
    """myround (transform.h:94-99): round half away from zero."""
    return torch.where(x > 0, torch.trunc(x + 0.5),
                       torch.trunc(x - 0.5)).to(torch.int32)


def _pixel(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           default: torch.Tensor) -> torch.Tensor:
    """PIXEL macro (filter_transform.c:52): bounds-checked int gather
    from (N, H, W) ``img`` at (N, H, W) coordinates, float32."""
    h, w = img.shape[-2:]
    valid = (x >= 0) & (y >= 0) & (x < w) & (y < h)
    v = _take(img, y.clamp(0, h - 1), x.clamp(0, w - 1))
    return torch.where(valid, v.to(torch.float32), default)


def _take(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor
          ) -> torch.Tensor:
    """``img[n, y, x]`` per frame n of (N, H, W) ``img`` for in-range
    (N, H, W) coordinates."""
    n, h, w = img.shape
    flat = (y.to(torch.int64) * w + x).reshape(n, -1)
    return torch.gather(img.reshape(n, h * w), 1, flat).view(y.shape)


def _interp_bilin_border(img, x, y, default):
    """interpolateBiLinBorder (filter_transform.c:170-185)."""
    x_f = _myfloor(x)
    x_c = x_f + 1
    y_f = _myfloor(y)
    y_c = y_f + 1
    v1 = _pixel(img, x_c, y_c, default)
    v2 = _pixel(img, x_c, y_f, default)
    v3 = _pixel(img, x_f, y_c, default)
    v4 = _pixel(img, x_f, y_f, default)
    wx1, wx0 = x - x_f, x_c - x
    wy1, wy0 = y - y_f, y_c - y
    a = fma32(v1, wx1, v3 * wx0)
    b = fma32(v2, wx1, v4 * wx0)
    return fma32(a, wy1, b * wy0)


def _interp_zero(img, x, y, default):
    return _pixel(img, _myround(x), _myround(y), default)


def _interp_lin(img, x, y, default):
    x_f = _myfloor(x)
    x_c = x_f + 1
    y_n = _myround(y)
    v1 = _pixel(img, x_c, y_n, default)
    v2 = _pixel(img, x_f, y_n, default)
    return fma32(v1, x - x_f, v2 * (x_c - x))


def _interp_bilin(img, x, y, default):
    return _interp_bilin_border(img, x, y, default)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (torch's CPU kernel is
    not): through float64, whose rounding cannot move it."""
    return torch.sqrt(x.double()).float()


def _interp_sqr(img, x, y, default):
    """interpolateSqr (filter_transform.c:236-257)."""
    h, w = img.shape[-2:]
    x_f = _myfloor(x)
    x_c = x_f + 1
    y_f = _myfloor(y)
    y_c = y_f + 1
    v1 = _pixel(img, x_c, y_c, default)
    v2 = _pixel(img, x_c, y_f, default)
    v3 = _pixel(img, x_f, y_c, default)
    v4 = _pixel(img, x_f, y_f, default)
    f1 = 1 - _sqrt(((x_c - x) * (y_c - y)).abs())
    f2 = 1 - _sqrt(((x_c - x) * (y - y_f)).abs())
    f3 = 1 - _sqrt(((x - x_f) * (y_c - y)).abs())
    f4 = 1 - _sqrt(((x - x_f) * (y - y_f)).abs())
    num = fma32(v4, f4, fma32(v3, f3, fma32(v1, f1, v2 * f2)))
    s = num / (f1 + f2 + f3 + f4)
    inner = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return torch.where(inner, s, _interp_bilin_border(img, x, y, default))


def _bicub_kernel(t, a0, a1, a2, a3):
    """Catmull-Rom tap (filter_transform.c:196-198); the C truncates to
    short at each evaluation."""
    u3 = -a0 + 3 * a1 - 3 * a2 + a3
    u2 = 2 * a0 - 5 * a1 + 4 * a2 - a3
    u1 = -a0 + a2
    v = (2 * a1 + t * fma32(t, fma32(t, u3, u2), u1)) * 0.5
    return torch.trunc(v)


def _interp_bicub(img, x, y, default):
    """interpolateBiCub (filter_transform.c:201-233)."""
    h, w = img.shape[-2:]
    x_f = _myfloor(x)
    y_f = _myfloor(y)
    tx = x - x_f
    rows = []
    for dy in (-1, 0, 1, 2):
        taps = [_take(img, (y_f + dy).clamp(0, h - 1),
                      (x_f + dx).clamp(0, w - 1)).to(torch.float32)
                for dx in (-1, 0, 1, 2)]
        rows.append(_bicub_kernel(tx, *taps))
    s = _bicub_kernel(y - y_f, *rows)
    # the C maps the final short through (unsigned char): mod-256 wrap
    s = torch.remainder(s, 256.0)
    inner = (x >= 1) & (x <= w - 2) & (y >= 1) & (y <= h - 2)
    return torch.where(inner, s, _interp_bilin_border(img, x, y, default))


_INTERP = {0: _interp_zero, 1: _interp_lin, 2: _interp_bilin,
           3: _interp_sqr, 4: _interp_bicub}


def warp_params(trans: np.ndarray, width: int, height: int,
                center_scale: float, rotation_threshold: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame parameters of the warp of a (width, height) plane for
    each float32 row (tx, ty, alpha, tzoom) of ``trans``: float32 (T, 4)
    ``zcos``, ``zsin`` and the source offsets ``c_x - tx*center_scale``,
    ``c_y - ty*center_scale``; int32 (T, 3) the rounded translation
    (``_myround(tx*center_scale)``, the same of ty) and the
    pure-translation flag."""
    t = np.asarray(trans, np.float32)
    tx, ty, alpha, tzoom = (t[:, i] for i in range(4))
    # 1 - tzoom/100: XLA's product with the reciprocal, fused
    z = fma32(torch.from_numpy(-tzoom), np.float32(0.01),
              np.float32(1.0)).numpy()
    libm = _libm()
    cos = np.array([libm.cosf(float(-a)) for a in alpha], np.float32)
    sin = np.array([libm.sinf(float(-a)) for a in alpha], np.float32)
    cs = np.float32(center_scale)
    fparams = np.stack([z * cos, z * sin,
                        np.float32(width / 2.0) - tx * cs,
                        np.float32(height / 2.0) - ty * cs], axis=1)
    stx, sty = torch.from_numpy(tx * cs), torch.from_numpy(ty * cs)
    pure = (np.abs(alpha) <= np.float32(rotation_threshold)) & (tzoom == 0)
    iparams = np.stack([_myround(stx).numpy(), _myround(sty).numpy(),
                        pure.astype(np.int32)], axis=1)
    return fparams.astype(np.float32), iparams.astype(np.int32)


def source_coords(fparams: torch.Tensor, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 source coordinates (N, H, W) of every output pixel of
    an (h, w) plane for (N, 4) ``fparams`` (``warp_params``)."""
    dev = fparams.device
    zcos, zsin, offx, offy = (fparams[:, i, None, None] for i in range(4))
    xd = (torch.arange(w, device=dev, dtype=torch.float32)
          - np.float32(w / 2.0))[None, None, :]
    yd = (torch.arange(h, device=dev, dtype=torch.float32)
          - np.float32(h / 2.0))[None, :, None]
    # the jitted filter fuses the first product of each sum
    x_s = fma32(zcos, xd, zsin * yd) + offx
    y_s = fma32(-zsin, xd, zcos * yd) + offy
    return x_s.expand(-1, h, w), y_s.expand(-1, h, w)


def warp_plane(plane: torch.Tensor, fparams: torch.Tensor,
               iparams: torch.Tensor, *, interp: int, crop: int,
               default_val: int) -> torch.Tensor:
    """Inverse-map affine warp (transformYUV, filter_transform.c:426-536)
    of (N, H, W) uint8 planes, frame n with row n of ``fparams`` and
    ``iparams`` (``warp_params``): the interpolated warp, or where the
    frame's flag is set the rounded integer copy.  Outside the source
    the pixel keeps its own value, or with ``crop`` = 1 becomes
    ``default_val``."""
    n, h, w = plane.shape
    dev = plane.device
    x_s, y_s = source_coords(fparams, h, w)
    default = (torch.full((n, h, w), float(default_val), device=dev)
               if crop == 1 else plane.to(torch.float32))
    interp_out = torch.trunc(_INTERP[interp](plane, x_s, y_s, default)).to(
        torch.uint8)
    rtx, rty, pure = (iparams[:, i, None, None] for i in range(3))
    sx = torch.arange(w, device=dev)[None, None, :] - rtx
    sy = torch.arange(h, device=dev)[None, :, None] - rty
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    shifted = _take(plane, sy.clamp(0, h - 1).expand(n, h, w),
                    sx.clamp(0, w - 1).expand(n, h, w))
    fallback = (torch.full_like(plane, default_val) if crop == 1 else plane)
    trans_out = torch.where(valid, shifted, fallback)
    return torch.where(pure != 0, trans_out, interp_out)


@register
class TransformFilter(VideoFilter):
    """filter_transform.c: pass-2 frame warper driven by a .trf file."""

    info = ModuleInfo(name="transform", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="transform", comment="apply stabilizing transforms "
        "(pass 2)", version="0.77", capabilities="VRY4",
        params=[ParamSpec("input", "transforms file", "s", ""),
                ParamSpec("smoothing", "lowpass window half-size", "d",
                          10, 0, 1000),
                ParamSpec("maxshift", "clamp translation px", "d", -1,
                          -1, 10000),
                ParamSpec("maxangle", "clamp rotation rad", "f", -1.0,
                          -1.0, 3.15),
                ParamSpec("crop", "0=keep border 1=black", "d", 0, 0, 1),
                ParamSpec("invert", "invert transforms", "d", 0, 0, 1),
                ParamSpec("relative", "transforms are relative", "d", 1,
                          0, 1),
                ParamSpec("zoom", "extra zoom percent", "f", 0.0,
                          -100.0, 100.0),
                ParamSpec("optzoom", "auto zoom to hide border", "d", 1,
                          0, 1),
                ParamSpec("interpol", "0=off 1=lin 2=bilin 3=quad "
                          "4=bicubic", "d", 2, 0, 4),
                ParamSpec("sharpen", "post-sharpen amount", "f", 0.8,
                          0.0, 2.0)])
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        self.input = self.options["input"] or (
            os.path.basename(job.video_in_file or "") + ".trf"
            if job.video_in_file else DEFAULT_TRANS_FILE)
        self.interpol = min(4, self.options["interpol"])
        self.crop = self.options["crop"]
        self.rotation_threshold = 0.25 / (180 / np.pi)
        try:
            self._raw = read_trf(self.input)
        except OSError as e:
            raise ValueError(f"transform: cannot open transforms file "
                             f"{self.input}: {e}") from e
        self._sharpen = None
        if self.options["sharpen"] > 0:
            from tcforge_tpu_torch.modules.filters.unsharp import (
                UnsharpFilter)
            amt = self.options["sharpen"]
            self._sharpen = UnsharpFilter(
                job, f"luma={amt}:luma_matrix=5x5:chroma={amt / 2}:"
                f"chroma_matrix=5x5")

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        if fmt != ImageFormat.YUV420P:
            raise ValueError("transform needs YUV420P (the reference's "
                             "RGB path is not built yet)")
        maxshift = self.options["maxshift"]
        if maxshift > width // 2:
            maxshift = width // 2
        if maxshift > height // 2:
            maxshift = height // 2
        ts = preprocess_transforms(
            self._raw, width, height,
            smoothing=self.options["smoothing"],
            invert=self.options["invert"],
            relative=self.options["relative"], maxshift=maxshift,
            maxangle=self.options["maxangle"],
            zoom=self.options["zoom"], optzoom=self.options["optzoom"])
        if len(ts) == 0:
            ts = np.zeros((1, 4))
        self._trans = np.asarray(ts, np.float32)
        # per plane (luma; chroma at half the centre and translation)
        self._params = []
        for w, h, scale in ((width, height, 1.0),
                            (width // 2, height // 2, 0.5)):
            fp, ip = warp_params(self._trans, w, h, scale,
                                 self.rotation_threshold)
            self._params.append((torch.from_numpy(fp).to(device),
                                 torch.from_numpy(ip).to(device)))
        return None

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        n = fb.batch
        ids = (fb.frame_ids if fb.frame_ids is not None
               else torch.arange(n, dtype=torch.int32, device=fb.device))
        # past the file end the last transform repeats
        # (filter_transform.c:940-945)
        rows = ids.clamp(0, len(self._trans) - 1).to(torch.int64)
        planes = []
        for plane, default_val, (fp, ip) in (
                (fb.y, 16, self._params[0]), (fb.u, 128, self._params[1]),
                (fb.v, 128, self._params[1])):
            planes.append(kernels.transform_warp(
                plane, fp[rows], ip[rows], self.interpol, self.crop,
                default_val))
        out = fb.with_planes(y=planes[0], u=planes[1], v=planes[2])
        if self._sharpen is not None:
            out, _ = self._sharpen.apply(out, None)
        return out, state
