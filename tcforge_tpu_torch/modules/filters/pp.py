"""pp — the postprocessing filter family (filter_pp.c's libpostproc).

The port of ``tcforge_tpu/modules/filters/pp.py``, which implements the
libpostproc subfilters itself: the same option grammar
(``<name>[:opt[:opt...]][/<name>...]``, ``,`` and ``|`` as separators
too, ``-name`` removing a preset member, transcode-style ``hb=64:vb``
strings translated as filter_pp.c's ``do_optstr`` does, ``-J pp`` alone
meaning ``de``) and the same subfilters on uint8 planes: hb/vb and
h1/v1 deblocking, dr deringing, the five deinterlacers lb li ci md fd,
al autolevels and tn tmpnoise.  A constant quantizer drives the
thresholds: 1, or ``fq``.

Two float32 expressions follow the jitted JAX filter: the deblock's
flatness fraction, a mean that XLA compiles to ``sum * (1/56)``, and
autolevels' ``x * scale + lo`` (plain and fused multiply-add give the
same bytes over its whole domain).  tn carries the previous output
frame; whether it is seeded yet is a Python bool, decided on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (FilterSlot, ModuleInfo,
                                                ModuleKind, VideoFilter,
                                                register)

_LONG = {
    "hdeblock": "hb", "vdeblock": "vb", "x1hdeblock": "h1",
    "x1vdeblock": "v1", "dering": "dr", "autopp": "al", "autolevels": "al",
    "linblenddeint": "lb", "linipoldeint": "li", "cubicipoldeint": "ci",
    "mediandeint": "md", "ffmpegdeint": "fd", "tmpnoise": "tn",
    "forcequant": "fq", "default": "de", "fast": "fa", "pre": "pre",
}
_KNOWN = set(_LONG.values()) | set(_LONG) | {
    "hb", "vb", "h1", "v1", "dr", "al", "lb", "li", "ci", "md", "fd",
    "tn", "fq", "de", "fa", "pre"}
_FLAGS = {"a": "a", "autoq": "a", "c": "c", "chrom": "c",
          "y": "y", "nochrom": "y", "f": "f", "fullyrange": "f"}

_PRESETS = {"de": ["hb:a", "vb:a", "dr:a", "al"],
            "fa": ["h1:a", "v1:a", "dr:a", "al"]}

# the deblock's flatness fraction: a mean over 7 x 8 booleans, which XLA
# compiles to a product with the float32 reciprocal
_INV_56 = float(np.float32(1) / np.float32(56))


def _translate_optstr(s: str) -> str:
    """do_optstr (filter_pp.c:126-151): turn a transcode optstr
    (``hb=64:vb:dr``) into pp syntax (``hb:64/vb/dr``) when the
    '='/'/' census says it is one (no_optstr, :109-124)."""
    score = s.count("/") + s.count("|") + s.count(",") - s.count("=")
    if score > 0:
        return s
    out = []
    toks = s.split(":")
    for i, tok in enumerate(toks):
        head = tok.split("=", 1)[0]
        flag = head in _FLAGS and head not in ("al",)
        if i == 0 or flag or not (head[:1].isalpha()):
            out.append(tok.replace("=", ":"))
        else:
            out.append("/" + tok.replace("=", ":"))
    return ":".join(out[:1]) + "".join(
        t if t.startswith("/") else ":" + t for t in out[1:])


def parse_pp_options(s: str) -> Dict[str, Dict]:
    """pp_get_mode_by_name_and_quality analogue: returns
    {short_name: {"chroma": bool, "args": [ints]}} plus special keys
    ``fq`` (int) and ``pre`` (bool).  Raises ValueError on unknown
    filter names (the reference errors out the same way)."""
    s = _translate_optstr(s.strip())
    active: Dict[str, Dict] = {}
    fq = 0
    pre = False
    norm = s.replace("|", "/").replace(",", "/")
    items: List[str] = [p for p in norm.split("/") if p]
    i = 0
    while i < len(items):
        item = items[i]
        i += 1
        remove = item.startswith("-")
        if remove:
            item = item[1:]
        fields = item.split(":")
        name = fields[0].strip().lower()
        name = _LONG.get(name, name)
        if name == "pre":
            pre = True
            continue
        if name in _PRESETS:
            if remove:
                for sub in _PRESETS[name]:
                    active.pop(sub.split(":")[0], None)
            else:
                items[i:i] = _PRESETS[name]
            continue
        if name not in _KNOWN:
            raise ValueError(f"pp: unknown postprocess filter {name!r}")
        if remove:
            active.pop(name, None)
            continue
        chroma: Optional[bool] = None
        args: List[int] = []
        for f in fields[1:]:
            f = f.strip()
            if f in _FLAGS:
                fl = _FLAGS[f]
                if fl == "c":
                    chroma = True
                elif fl == "y":
                    chroma = False
                # 'a' (autoq): quality == PP_QUALITY_MAX -> always on
                # 'f' (fullyrange) only meaningful for al
                elif fl == "f" and name == "al":
                    args.append(1)
            elif f.lstrip("-").isdigit():
                args.append(int(f))
            elif f:
                raise ValueError(f"pp: bad option {f!r} for {name!r}")
        if name == "fq":
            fq = args[0] if args else 1
            continue
        active[name] = {"chroma": chroma, "args": args}
    active["__fq__"] = {"chroma": None, "args": [fq]}
    active["__pre__"] = {"chroma": None, "args": [int(pre)]}
    return active


# ------------------------------------------------------------------ #
# subfilters on (N, H, W) uint8 planes (int32 inside, uint8 out)

def _trunc_half(x: torch.Tensor) -> torch.Tensor:
    """C integer division by 2 (truncates toward zero)."""
    return torch.div(x, 2, rounding_mode="trunc")


def deblock_v(plane: torch.Tensor, qp: int, diff: int,
              flat: int) -> torch.Tensor:
    """Vertical deblock across every 8-row boundary: the default filter
    step on the boundary pair l4|l5 (context l1..l8), or on flat
    segments the (1,2,1)/4 lowpass over l2..l7."""
    n, h, w = plane.shape
    nb = h // 8 - 1
    if nb <= 0:
        return plane
    p = plane.to(torch.int32)
    rows = (torch.arange(nb, device=p.device)[:, None] * 8 + 8
            + torch.arange(-4, 4, device=p.device)[None, :])
    seg = p[:, rows, :]                          # (n, nb, 8, w)
    l = [seg[:, :, k, :] for k in range(8)]      # l1..l8 = l[0]..l[7]
    me = 5 * (l[4] - l[3]) + 2 * (l[2] - l[5])
    le = 5 * (l[2] - l[1]) + 2 * (l[0] - l[3])
    re = 5 * (l[6] - l[5]) + 2 * (l[4] - l[7])
    d = (me.abs() - torch.minimum(le.abs(), re.abs())).clamp_(min=0)
    d = (5 * d + 32) >> 6
    d = torch.where(me > 0, -d, d)
    q = _trunc_half(l[3] - l[4])
    zero = torch.zeros_like(q)
    d = torch.where(q > 0, torch.minimum(torch.maximum(d, zero), q),
                    torch.minimum(torch.maximum(d, q), zero))
    d = torch.where(me.abs() < (diff * qp) >> 3, d, 0)

    # flatness per 8-column segment
    dc_off = ((qp * flat) >> 8) + 1
    diffs = torch.stack([(l[k + 1] - l[k]).abs() <= dc_off
                         for k in range(7)], dim=2)       # (n,nb,7,w)
    wc = w // 8
    dseg = diffs[:, :, :, :wc * 8].reshape(n, nb, 7, wc, 8)
    frac = dseg.sum(dim=(2, 4), dtype=torch.int32).to(torch.float32) \
        * _INV_56
    seg8 = seg[:, :, :, :wc * 8].reshape(n, nb, 8, wc, 8)
    rng = seg8.amax(dim=(2, 4)) - seg8.amin(dim=(2, 4))
    is_flat = (frac > flat / 64.0) & (rng < 2 * qp + dc_off)
    is_flat = F.pad(is_flat.repeat_interleave(8, dim=2),
                    (0, w - wc * 8))                      # (n,nb,w)

    ctx = [l[0]] + l + [l[7]]
    lp = [(ctx[k] + 2 * ctx[k + 1] + ctx[k + 2] + 2) >> 2
          for k in range(1, 7)]                           # l2..l7
    new4 = (l[3] - d).clamp_(0, 255)
    new5 = (l[4] + d).clamp_(0, 255)
    upd = {3: torch.where(is_flat, lp[2], new4),
           4: torch.where(is_flat, lp[3], new5)}
    for k in (1, 2, 5, 6):
        upd[k] = torch.where(is_flat, lp[k - 1], seg[:, :, k, :])
    res = p.clone()
    for k, v in upd.items():
        res[:, rows[:, k], :] = v
    return res.to(torch.uint8)


def deblock_h(plane: torch.Tensor, qp: int, diff: int,
              flat: int) -> torch.Tensor:
    """Horizontal deblock = vertical deblock on the transpose."""
    return deblock_v(plane.transpose(1, 2), qp, diff,
                     flat).transpose(1, 2).contiguous()


def x1_deblock_v(plane: torch.Tensor, qp: int) -> torch.Tensor:
    """x1vdeblock: the two rows at each boundary take the (1,3,3,1)/8
    vertical kernel where the boundary step exceeds qp."""
    n, h, w = plane.shape
    nb = h // 8 - 1
    if nb <= 0:
        return plane
    p = plane.to(torch.int32)
    rows = torch.arange(nb, device=p.device) * 8 + 8
    a, b, c, d = (p[:, rows + k, :] for k in (-2, -1, 0, 1))
    soft = (a + 3 * b + 3 * c + d + 4) >> 3
    on = (b - c).abs() > qp
    res = p.clone()
    res[:, rows - 1, :] = torch.where(on, soft, b)
    res[:, rows, :] = torch.where(on, soft, c)
    return res.to(torch.uint8)


def x1_deblock_h(plane: torch.Tensor, qp: int) -> torch.Tensor:
    return x1_deblock_v(plane.transpose(1, 2), qp).transpose(1, 2) \
        .contiguous()


def _edge_pad1(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) padded by one edge-replicated sample on each side."""
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def dering(plane: torch.Tensor, qp: int) -> torch.Tensor:
    """Deringing: in each 8x8 block with real contrast (max - min >
    2*qp + 16), pixels whose whole 3x3 neighbourhood sits on one side of
    the block's midpoint take the (1,2,1)^2/16 blur."""
    n, h, w = plane.shape
    hb, wb = h // 8, w // 8
    if hb == 0 or wb == 0:
        return plane
    p = plane.to(torch.int32)
    crop = p[:, :hb * 8, :wb * 8]
    blocks = crop.reshape(n, hb, 8, wb, 8)
    bmin = blocks.amin(dim=(2, 4))
    bmax = blocks.amax(dim=(2, 4))
    mid = (bmin + bmax + 1) >> 1
    active = (bmax - bmin) > (2 * qp + 16)

    def full(t):
        return t.repeat_interleave(8, 1).repeat_interleave(8, 2)
    side = crop > full(mid)
    pad = _edge_pad1(crop)
    spad = _edge_pad1(side)
    acc = torch.zeros_like(crop)
    same = torch.ones_like(side)
    k = (1, 2, 1)
    ch, cw = crop.shape[1], crop.shape[2]
    for dy in range(3):
        for dx in range(3):
            acc += k[dy] * k[dx] * pad[:, dy:dy + ch, dx:dx + cw]
            same &= spad[:, dy:dy + ch, dx:dx + cw] == side
    blur = (acc + 8) >> 4
    res = p.clone()
    res[:, :hb * 8, :wb * 8] = torch.where(full(active) & same, blur, crop)
    return res.to(torch.uint8)


def _rows_shift(p: torch.Tensor, k: int) -> torch.Tensor:
    """Rows moved by k (row i takes row i + k), edge rows repeated."""
    if k < 0:
        return torch.cat([p[:, :1].expand(-1, -k, -1), p[:, :k]], dim=1)
    if k > 0:
        return torch.cat([p[:, k:], p[:, -1:].expand(-1, k, -1)], dim=1)
    return p


def _odd_rows(p: torch.Tensor, odd_value: torch.Tensor) -> torch.Tensor:
    odd = (torch.arange(p.shape[1], device=p.device) % 2 == 1)[None, :, None]
    return torch.where(odd, odd_value, p).to(torch.uint8)


def linblend_deint(plane: torch.Tensor) -> torch.Tensor:
    """lb: every line -> (above + 2*line + below + 2) >> 2."""
    p = plane.to(torch.int32)
    return ((_rows_shift(p, -1) + 2 * p + _rows_shift(p, 1) + 2)
            >> 2).to(torch.uint8)


def linipol_deint(plane: torch.Tensor) -> torch.Tensor:
    """li: odd lines = average of the even neighbours."""
    p = plane.to(torch.int32)
    return _odd_rows(p, (_rows_shift(p, -1) + _rows_shift(p, 1) + 1) >> 1)


def cubicipol_deint(plane: torch.Tensor) -> torch.Tensor:
    """ci: odd lines = cubic (-1,9,9,-1)/16 of same-parity neighbours."""
    p = plane.to(torch.int32)
    sh = lambda k: _rows_shift(p, k)
    return _odd_rows(p, ((-sh(-3) + 9 * sh(-1) + 9 * sh(1) - sh(3) + 8)
                         >> 4).clamp_(0, 255))


def median_deint(plane: torch.Tensor) -> torch.Tensor:
    """md: odd lines = median(above, line, below)."""
    p = plane.to(torch.int32)
    up, dn = _rows_shift(p, -1), _rows_shift(p, 1)
    return _odd_rows(p, torch.maximum(torch.minimum(up, p), torch.minimum(
        torch.maximum(up, p), dn)))


def ffmpeg_deint(plane: torch.Tensor) -> torch.Tensor:
    """fd: odd lines = (-1,4,2,4,-1)/8 vertical lowpass."""
    p = plane.to(torch.int32)
    sh = lambda k: _rows_shift(p, k)
    return _odd_rows(p, ((-sh(-2) + 4 * sh(-1) + 2 * p + 4 * sh(1)
                          - sh(2) + 4) >> 3).clamp_(0, 255))


def autolevels(y: torch.Tensor, fullyrange: bool) -> torch.Tensor:
    """al: per-frame histogram stretch, the robust (1/256-tail) min and
    max mapped onto 0..255 (fullyrange) or 16..235."""
    n, h, w = y.shape
    yi = y.to(torch.int64).reshape(n, -1)
    total = yi.shape[1]
    base = torch.arange(n, device=y.device)[:, None] * 256
    hist = torch.bincount((yi + base).reshape(-1),
                          minlength=256 * n).reshape(n, 256)
    cdf = hist.cumsum(dim=1)
    tail = total // 256
    lo = (cdf > tail).to(torch.uint8).argmax(dim=1)
    hi = 255 - (cdf < total - tail).flip(1).to(torch.uint8).argmax(dim=1)
    hi = torch.maximum(hi, lo + 1)
    out_lo, out_hi = (0, 255) if fullyrange else (16, 235)
    # a true division (a Python number over a tensor would be computed
    # as the number times the tensor's reciprocal)
    scale = torch.full((n,), float(out_hi - out_lo), device=y.device) / \
        (hi - lo).to(torch.float32)
    out = (yi - lo[:, None]).to(torch.float32) * scale[:, None] + out_lo
    return (out + 0.5).clamp_(0, 255).to(torch.uint8).reshape(n, h, w)


def tmpnoise(frame: torch.Tensor, prev: torch.Tensor, t1: int, t2: int,
             t3: int) -> torch.Tensor:
    """tn: per-pixel blend with the previous output frame, weighted by
    |diff| against the three thresholds (t1 <= t2 <= t3)."""
    c = frame.to(torch.int32)
    p = prev.to(torch.int32)
    d = (c - p).abs()
    out = torch.where(d < t1, (7 * p + c + 4) >> 3,
                      torch.where(d < t2, (p + c + 1) >> 1,
                                  torch.where(d < t3, (p + 3 * c + 2) >> 2,
                                              c)))
    return out.to(torch.uint8)


def _tmpnoise_scan(prev: torch.Tensor, frames: torch.Tensor, t1: int,
                   t2: int, t3: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """tmpnoise over the N frames with the previous output carried:
    (last output, (N, H, W) outputs)."""
    outs = []
    for frame in frames:
        prev = tmpnoise(frame, prev, t1, t2, t3)
        outs.append(prev)
    return prev, torch.stack(outs)


@register
class PPFilter(VideoFilter):
    """libpostproc-family postprocessor (filter_pp.c)."""

    info = ModuleInfo(name="pp", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="pp", comment="postprocess filters (native libpostproc-"
        "family implementation)",
        params=[ParamSpec("hb", "horizontal deblocking", "s", ""),
                ParamSpec("vb", "vertical deblocking", "s", ""),
                ParamSpec("h1", "experimental h deblock 1", "s", ""),
                ParamSpec("v1", "experimental v deblock 1", "s", ""),
                ParamSpec("dr", "deringing", "s", ""),
                ParamSpec("al", "auto brightness/contrast", "s", ""),
                ParamSpec("f", "stretch luminance to 0..255", "s", ""),
                ParamSpec("lb", "linear blend deinterlacer", "s", ""),
                ParamSpec("li", "linear interpolating deint", "s", ""),
                ParamSpec("ci", "cubic interpolating deint", "s", ""),
                ParamSpec("md", "median deinterlacer", "s", ""),
                ParamSpec("fd", "ffmpeg deinterlacer", "s", ""),
                ParamSpec("de", "preset: hb:a/vb:a/dr:a/al", "s", ""),
                ParamSpec("fa", "preset: h1:a/v1:a/dr:a/al", "s", ""),
                ParamSpec("tn", "temporal noise reducer", "s", ""),
                ParamSpec("fq", "force quantizer", "d", 0, 0, 31),
                ParamSpec("pre", "run as pre filter", "d", 0, 0, 1)])
    slots = FilterSlot.POST_M

    def __init__(self, job, options: str = ""):
        # pp has its own grammar, not the optstr key=value parser
        self.job = job
        self.options_str = options
        self.options = {}
        # the reference errors out without options (filter_pp.c:224);
        # the default preset keeps -J pp usable
        self.active = parse_pp_options(options or "de")
        self.qp = max(1, self.active.pop("__fq__")["args"][0])
        if self.active.pop("__pre__")["args"][0]:
            self.slots = FilterSlot.PRE_M
        self._order = [n for n in
                       ("hb", "vb", "h1", "v1", "dr", "tn", "lb", "li",
                        "ci", "md", "fd", "al")
                       if n in self.active]

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        """tn's carry: the previous output planes and whether they are
        seeded yet (a host bool)."""
        if "tn" not in self.active:
            return None

        def z(h, w):
            return torch.zeros((h, w), dtype=torch.uint8, device=device)
        return (z(height, width), z(height // 2, width // 2),
                z(height // 2, width // 2), False)

    def _chroma_on(self, name: str) -> bool:
        c = self.active[name]["chroma"]
        # quality == MAX: chroma filtering on unless 'y'/nochrom
        return True if c is None else c

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if fb.format != ImageFormat.YUV420P:
            # "This filter is only capable of YUV 4:2:0 mode"
            # (filter_pp.c:221): other formats pass through
            return fb, state
        y, u, v = fb.y, fb.u, fb.v
        qp = self.qp
        for name in self._order:
            args = self.active[name]["args"]
            con = self._chroma_on(name)
            if name in ("hb", "vb"):
                diff = args[0] if len(args) > 0 else 64
                flat = args[1] if len(args) > 1 else 40
                fn = deblock_h if name == "hb" else deblock_v
                y = fn(y, qp, diff, flat)
                if con:
                    u, v = fn(u, qp, diff, flat), fn(v, qp, diff, flat)
            elif name in ("h1", "v1"):
                fn = x1_deblock_h if name == "h1" else x1_deblock_v
                y = fn(y, qp)
                if con:
                    u, v = fn(u, qp), fn(v, qp)
            elif name == "dr":
                y = dering(y, qp)
                if con:
                    u, v = dering(u, qp), dering(v, qp)
            elif name == "tn":
                t1 = args[0] if len(args) > 0 else 8
                t2 = args[1] if len(args) > 1 else 16
                t3 = args[2] if len(args) > 2 else 32
                t1, t2, t3 = sorted((t1, t2, t3))
                py, pu, pv, seeded = state
                if not seeded:
                    py, pu, pv = y[0], u[0], v[0]
                py, y = _tmpnoise_scan(py, y, t1, t2, t3)
                if con:
                    pu, u = _tmpnoise_scan(pu, u, t1, t2, t3)
                    pv, v = _tmpnoise_scan(pv, v, t1, t2, t3)
                state = (py, pu, pv, True)
            elif name == "lb":
                y = linblend_deint(y)
                if con:
                    u, v = linblend_deint(u), linblend_deint(v)
            elif name == "li":
                y = linipol_deint(y)
            elif name == "ci":
                y = cubicipol_deint(y)
            elif name == "md":
                y = median_deint(y)
            elif name == "fd":
                y = ffmpeg_deint(y)
            elif name == "al":
                y = autolevels(y, bool(args and args[0]))
        return fb.with_planes(y=y, u=u, v=v), state
