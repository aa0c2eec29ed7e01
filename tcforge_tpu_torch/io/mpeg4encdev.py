"""The MPEG-4 part 2 encoder's device side: records and plain versions.

The JAX package's encoder (``tcforge_tpu/io/mpeg4enc.py``
``Mpeg4NativeEncoder``) is numpy loops over macroblocks that decide
and code each one as they write it.  The port splits each VOP in two:
its decisions and its block coding run on the frames' device (three
kernels, ``ops/kernels.py`` ``mpeg4_enc_me``, ``mpeg4_enc_bme`` and
``mpeg4_enc_blocks``, ``csrc/mpeg4_encode.cu``), and the host writes
the bits from their records (``io/mpeg4enc.py``).

One int16 record a macroblock (``REC`` values), one tensor a VOP:

- ``LV`` 384 levels, the six blocks (Y0 Y1 Y2 Y3 Cb Cr) in raster
  order; an intra block's slot 0 holds its quantized DC ``dc_q``
  (``floor(F00 / dc_scale + 0.5)``), its AC levels the rest;
- ``MODE``: ``MODE_INTER`` (1MV), ``MODE_INTER4``, ``MODE_INTRA`` of an
  I or P VOP; ``MODE_DIRECT``, ``MODE_INTERP``, ``MODE_BACKWARD``,
  ``MODE_FORWARD`` (the B ``mb_type`` plus 3) and ``MODE_COSKIP`` (its
  co-located macroblock was skipped: no bits) of a B-VOP;
- ``CBP`` the coded block pattern (bit ``5 - n`` for block n) and
  ``SKIP`` a P-VOP's not_coded or a B-VOP's ``modb`` uncoded direct,
  both written by the block coder;
- ``MX``, ``MY``: a P macroblock's 1MV vector (half-pel), a B
  macroblock's forward search result; ``BMX``, ``BMY`` its backward one;
- ``FMV4``, ``BMV4``: each luma block's forward and backward vector of
  the prediction, ``FCMV``, ``BCMV`` the chroma vectors (the
  reconstruction records of ``io/mpeg4recon.py``).

The decisions depend on SADs alone, except where the JAX encoder's
not_coded test (``mpeg4enc.py:732``) overrides a 4MV macroblock whose
1MV vector is (0, 0) and whose levels are all zero: it writes a skip,
sets the median-prediction grid to (0, 0) there, and keeps the 4MV
prediction as its reconstruction where any decoder copies the
co-located macroblock.  The decision stage computes those levels
itself so that the grid, and every later vector, follows the JAX
encoder; the drift is the JAX encoder's and is kept.

The plain versions (what the wrappers run on the CPU) follow the JAX
loops' order and ties exactly: the integer SADs come from a table of
every 8x8 block at every integer offset within +-15 (their sums give the
16x16 SADs), the half-pel ones from the reference's four phase planes;
the forward DCT is numpy's ``_DCTM @ b @ _DCTM.T`` as its OpenBLAS
computes it, two chains of fused multiply-adds over k from 0
(``io/mpeg2codec.fma64``), never ``torch.matmul``; the quantizers divide
tensor by tensor (IEEE division).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tcforge_tpu_torch.io import _mp4tables as T
from tcforge_tpu_torch.io.mpeg2codec import fma64
from tcforge_tpu_torch.io.mpeg4dec import Mpeg4Decoder
from tcforge_tpu_torch.io.mpeg4recon import _blocks_to_planes, _mc_plane, \
    xvid_idct_ref
from tcforge_tpu_torch.io.mpeg4syntax import _DCTM

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

REC = 416
LV = 0
MODE, CBP, SKIP, MX, MY, BMX, BMY = 384, 385, 386, 387, 388, 389, 390
FMV4, BMV4, FCMV, BCMV = 391, 399, 407, 409

MODE_INTER, MODE_INTER4, MODE_INTRA = 0, 1, 2
MODE_DIRECT, MODE_INTERP, MODE_BACKWARD, MODE_FORWARD = 3, 4, 5, 6
MODE_COSKIP = 7
VOP_I, VOP_P, VOP_B = 0, 1, 2

# the integer table's reach: the 1MV search stays within +-14
# (Mpeg4NativeEncoder.search), the 4MV one within +-15
TABLE_R = 15
MAX_SEARCH = 14


def pad_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               mbw: int, mbh: int) -> Planes:
    """A frame's planes on the coded grid, the last column and row
    repeated (``Mpeg4NativeEncoder._pad_planes``), on their device."""
    out = []
    for p, s in ((y, 16), (u, 8), (v, 8)):
        h, w = p.shape
        if (h, w) == (s * mbh, s * mbw):
            out.append(p.contiguous())
            continue
        iy = torch.arange(s * mbh, device=p.device).clamp_(max=h - 1)
        ix = torch.arange(s * mbw, device=p.device).clamp_(max=w - 1)
        out.append(p[iy][:, ix].contiguous())
    return tuple(out)


def round_chroma(x: int) -> int:
    return T.CHROMA_ROUNDTAB[x & 0xF] + ((x >> 3) & ~1)


# ------------------------------------------------------------------ #
# Block coding (plain version of mpeg4_enc_blocks)

_BASIS = {}


def _basis(device) -> torch.Tensor:
    key = str(device)
    if key not in _BASIS:
        _BASIS[key] = torch.from_numpy(_DCTM.copy()).to(device)
    return _BASIS[key]


def fdct_ref(blocks: torch.Tensor) -> torch.Tensor:
    """(n, 8, 8) integer samples -> float64 coefficients: numpy's
    ``_DCTM @ b @ _DCTM.T`` as OpenBLAS computes it, ``t[u][x]`` and then
    ``f[u][v]`` each a chain of fused multiply-adds over k = 0..7 from
    0."""
    d = _basis(blocks.device)
    b = blocks.to(torch.float64)
    t = torch.zeros_like(b)
    for k in range(8):
        t = fma64(d[:, k][None, :, None], b[:, k:k + 1, :], t)
    f = torch.zeros_like(t)
    for k in range(8):
        f = fma64(t[:, :, k:k + 1], d[:, k][None, None, :], f)
    return f


def quant_inter_ref(f: torch.Tensor, q: int) -> torch.Tensor:
    """``_quant_inter``: ``sign(f) * max(trunc((|f| - q/2) / 2q), 0)``,
    clipped to +-2047."""
    mag = torch.trunc((f.abs() - q * 0.5) / torch.full_like(f, 2.0 * q))
    lv = torch.sign(f) * mag.clamp(min=0)
    return lv.to(torch.int64).clamp(-2047, 2047)


def quant_intra_ref(f: torch.Tensor, q: int, scale: torch.Tensor
                    ) -> torch.Tensor:
    """``_quant_intra_ac`` of the AC coefficients, and ``dc_q =
    floor(F00 / scale + 0.5)`` in slot 0 (``scale`` per block)."""
    lv = torch.trunc(f / torch.full_like(f, 2.0 * q)).to(torch.int64)
    lv = lv.clamp(-2047, 2047)
    dc = torch.floor(f[:, 0, 0] / scale.to(torch.float64) + 0.5)
    lv[:, 0, 0] = dc.to(torch.int64)
    return lv


def dequant_ref(lv: torch.Tensor, q: int, intra: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``Mpeg4Decoder._dequant`` (H.263): ``sign * (2|lv| q + add)`` where
    a level is not 0; an intra block's DC ``dc_q * scale``; clipped to
    [-2048, 2047]."""
    add = q - 1 if (q & 1) == 0 else q
    out = torch.where(lv != 0, torch.sign(lv) * (2 * lv.abs() * q + add),
                      torch.zeros_like(lv))
    out[:, 0, 0] = torch.where(intra, lv[:, 0, 0] * scale, out[:, 0, 0])
    return out.clamp(-2048, 2047)


def _mb_blocks(planes: Sequence[torch.Tensor], mbw: int) -> torch.Tensor:
    """Coded-grid planes -> (nmb, 6, 8, 8) int64 blocks."""
    y, u, v = (p.to(torch.int64) for p in planes)
    mbh = y.shape[0] // 16
    yb = y.reshape(mbh, 2, 8, mbw, 2, 8).permute(0, 3, 1, 4, 2, 5)
    yb = yb.reshape(mbh * mbw, 4, 8, 8)
    cb = [c.reshape(mbh, 8, mbw, 8).permute(0, 2, 1, 3)
          .reshape(mbh * mbw, 1, 8, 8) for c in (u, v)]
    return torch.cat([yb, *cb], dim=1)


def _use(mode: torch.Tensor):
    use_f = ((mode == MODE_INTER) | (mode == MODE_INTER4)
             | (mode == MODE_FORWARD) | (mode == MODE_DIRECT)
             | (mode == MODE_INTERP) | (mode == MODE_COSKIP))
    use_b = ((mode == MODE_BACKWARD) | (mode == MODE_DIRECT)
             | (mode == MODE_INTERP) | (mode == MODE_COSKIP))
    return use_f, use_b


def _prediction(rec: torch.Tensor, mbw: int, fwd, bwd,
                nplanes: int = 3) -> List[torch.Tensor]:
    """The first ``nplanes`` planes' predictions from the records'
    vectors (rounding 0): forward, backward, their average, or 0
    (intra)."""
    from tcforge_tpu_torch.io import mpeg4recon as R
    mbh = rec.shape[0] // mbw
    mode = rec[:, MODE].to(torch.int64)
    use_f, use_b = _use(mode)
    out = []
    for p in range(nplanes):
        px = 16 if p == 0 else 8
        uf = R._mb_mask(use_f, mbh, mbw, px)
        ub = R._mb_mask(use_b, mbh, mbw, px)
        preds = []
        for ref, lo, hi in ((fwd, FMV4, FCMV), (bwd, BMV4, BCMV)):
            if ref is None:
                preds.append(None)
                continue
            if p == 0:
                mvx, mvy = R._luma_vectors(rec[:, lo:lo + 8], mbh, mbw)
            else:
                mvx, mvy = R._chroma_vectors(rec[:, hi:hi + 2], mbh, mbw)
            preds.append(_mc_plane(ref[p], mvx, mvy, 0))
        zero = torch.zeros((mbh * px, mbw * px), dtype=torch.int64,
                           device=rec.device)
        f = preds[0] if preds[0] is not None else zero
        b = preds[1] if preds[1] is not None else zero
        out.append(torch.where(uf & ub, (f + b + 1) >> 1,
                               torch.where(uf, f, torch.where(ub, b, zero))))
    return out


def _dc_scales(q: int, n: int, device) -> torch.Tensor:
    """(n, 6) int64 DC scales of the six blocks of each macroblock."""
    row = [T.Y_DC_SCALE[q]] * 4 + [T.C_DC_SCALE[q]] * 2
    return torch.tensor(row, dtype=torch.int64, device=device).repeat(n, 1)


def code_blocks(src: torch.Tensor, pred: torch.Tensor, intra: torch.Tensor,
                q: int):
    """(nmb, 6, 8, 8) source and prediction blocks of macroblocks, intra
    ones flagged: the levels (an intra block's DC in slot 0), each
    block's coded flag (an intra block's AC alone) and its
    reconstruction (``_code_intra_mb``'s and ``_encode_pvop``'s math)."""
    n = src.shape[0]
    intra6 = intra[:, None].expand(n, 6).reshape(-1)
    s = src.reshape(-1, 8, 8)
    pr = pred.reshape(-1, 8, 8)
    f = fdct_ref(torch.where(intra6[:, None, None], s, s - pr))
    scale = _dc_scales(q, n, src.device).reshape(-1)
    lv = torch.where(intra6[:, None, None], quant_intra_ref(f, q, scale),
                     quant_inter_ref(f, q))
    ac = lv.reshape(-1, 64)[:, 1:].ne(0).any(1)
    coded = torch.where(intra6, ac, ac | (lv[:, 0, 0] != 0))
    deq = dequant_ref(lv, q, intra6, scale)
    res = xvid_idct_ref(deq)
    rec = torch.where(intra6[:, None, None], res,
                      torch.where(coded[:, None, None], res + pr, pr))
    return (lv.reshape(n, 6, 64), coded.reshape(n, 6),
            rec.clamp(0, 255).reshape(n, 6, 8, 8))


def mpeg4_enc_blocks_ref(rec: Optional[torch.Tensor], cur: Planes, fwd, bwd,
                         q: int, vop_type: int, recon: bool):
    """Plain version of ``mpeg4_enc_blocks``: new records, the decisions
    of ``rec`` (None for an I-VOP) with the levels, cbp and skips."""
    mbw = cur[0].shape[1] // 16
    n = (cur[0].shape[0] // 16) * mbw
    if vop_type == VOP_I:
        rec = torch.zeros((n, REC), dtype=torch.int16, device=cur[0].device)
        rec[:, MODE] = MODE_INTRA
        fwd = bwd = None
    else:
        rec = rec.clone()
    mode = rec[:, MODE].to(torch.int64)
    pred = _mb_blocks(_prediction(rec, mbw, fwd, bwd), mbw)
    src = _mb_blocks(cur, mbw)
    lv, coded, blocks = code_blocks(src, pred, mode == MODE_INTRA, q)
    coskip = mode == MODE_COSKIP
    lv[coskip] = 0
    coded[coskip] = False
    blocks[coskip] = pred[coskip].clamp(0, 255)
    weights = torch.tensor([32, 16, 8, 4, 2, 1], device=rec.device)
    cbp = (coded.to(torch.int64) * weights).sum(1)
    if vop_type == VOP_B:
        skip = (mode == MODE_DIRECT) & (cbp == 0)
    else:
        skip = ((mode == MODE_INTER) | (mode == MODE_INTER4)) & (cbp == 0) \
            & (rec[:, MX] == 0) & (rec[:, MY] == 0)
    rec[:, LV:LV + 384] = lv.reshape(n, 384).to(torch.int16)
    rec[:, CBP] = cbp.to(torch.int16)
    rec[:, SKIP] = skip.to(torch.int16)
    planes = None
    if recon:
        planes = tuple(p.to(torch.uint8) for p in _blocks_to_planes(
            blocks.reshape(n, 6, 8, 8), mbw))
    return rec, planes


# ------------------------------------------------------------------ #
# Decisions (plain versions of mpeg4_enc_me and mpeg4_enc_bme)

def int_sad_table(cur_y: torch.Tensor, ref_y: torch.Tensor,
                  r: int = TABLE_R, block: int = 8) -> torch.Tensor:
    """(h/block, w/block, 2r+1, 2r+1) int32: the SAD of each block x
    block luma block against the reference at every integer offset (dy,
    dx) in [-r, r], each sample coordinate clamped to the plane (the JAX
    encoder's 32-sample edge padding)."""
    h, w = cur_y.shape
    dev = cur_y.device
    iy = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    ix = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    rp = ref_y.to(torch.int16)[iy][:, ix]
    c = cur_y.to(torch.int16)
    n = 2 * r + 1
    out = torch.empty((n, n, h // block, w // block), dtype=torch.int32,
                      device=dev)
    for dy in range(n):
        band = rp[dy:dy + h]
        for dx in range(n):
            d = (band[:, dx:dx + w] - c).abs_()
            out[dy, dx] = d.view(h // block, block, w // block, block).sum(
                (1, 3), dtype=torch.int32)
    return out.permute(2, 3, 0, 1).contiguous()


class HalfPel:
    """A reference plane's four half-pel phase planes (rounding 0) on the
    host, every coordinate clamped: ``block(y, x, size, mx, my)`` is
    ``Mpeg4Decoder._mc_block``'s prediction of the block at (y, x)."""

    PAD = 40

    def __init__(self, ref: torch.Tensor):
        h, w = ref.shape
        p = self.PAD
        iy = torch.arange(-p, h + p + 1).clamp(0, h - 1)
        ix = torch.arange(-p, w + p + 1).clamp(0, w - 1)
        r = ref.cpu().to(torch.int32)[iy][:, ix]
        a, b = r[:-1, :-1], r[:-1, 1:]
        c, d = r[1:, :-1], r[1:, 1:]
        # phase index hx + 2 hy
        self.phases = torch.stack([a, (a + b + 1) >> 1, (a + c + 1) >> 1,
                                   (a + b + c + d + 2) >> 2])
        self._windows = {}

    def block(self, y: int, x: int, size: int, mx: int, my: int):
        gy, gx = y + (my >> 1) + self.PAD, x + (mx >> 1) + self.PAD
        return self.phases[(mx & 1) + 2 * (my & 1), gy:gy + size,
                           gx:gx + size]

    def sads(self, cur: torch.Tensor, y: int, x: int, cands) -> List[int]:
        """The SADs of ``cur`` (size x size at (y, x)) against each
        candidate vector's prediction, in one gather."""
        size = cur.shape[0]
        win = self._windows.get(size)
        if win is None:
            win = self._windows[size] = self.phases.unfold(
                1, size, 1).unfold(2, size, 1)
        ph = [(mx & 1) + 2 * (my & 1) for mx, my in cands]
        ys = [y + (my >> 1) + self.PAD for _, my in cands]
        xs = [x + (mx >> 1) + self.PAD for mx, _ in cands]
        preds = win[ph, ys, xs]
        return (preds - cur).abs().sum((1, 2)).tolist()


def search_mv(sad16, hp: HalfPel, cur: torch.Tensor, x0: int, y0: int,
              pred, lim: int):
    """``Mpeg4NativeEncoder._search_mv`` over an integer SAD function:
    the predictor's seed (halved) before (0, 0) (the order of the JAX
    loop's two-element set; a tie keeps the earlier), from each the
    three-step search (steps 4, 2, 1, each repeated while one of (-s, 0),
    (s, 0), (0, -s), (0, s) improves, strictly), then the 3x3 half-pel
    refine around the winner (dx outer, dy inner, within [-32, 31]).
    Returns (mx, my, sad)."""
    seeds = [(pred[0] >> 1, pred[1] >> 1)]
    if seeds[0] != (0, 0):
        seeds.append((0, 0))
    best = None
    for seed in seeds:
        bx = max(-lim, min(lim, seed[0]))
        by = max(-lim, min(lim, seed[1]))
        bs = sad16(bx, by)
        step = 4
        while step:
            improved = True
            while improved:
                improved = False
                for dx, dy in ((-step, 0), (step, 0), (0, -step),
                               (0, step)):
                    nx, ny = bx + dx, by + dy
                    if abs(nx) > lim or abs(ny) > lim:
                        continue
                    s = sad16(nx, ny)
                    if s < bs:
                        bs, bx, by = s, nx, ny
                        improved = True
            step >>= 1
        if best is None or bs < best[0]:
            best = (bs, bx, by)
    _, bx, by = best
    cands = [(2 * bx + dx, 2 * by + dy) for dx in (-1, 0, 1)
             for dy in (-1, 0, 1)
             if -32 <= 2 * bx + dx <= 31 and -32 <= 2 * by + dy <= 31]
    sads = hp.sads(cur, y0, x0, cands)
    k = min(range(len(cands)), key=lambda i: (sads[i], i))
    return cands[k][0], cands[k][1], sads[k]


def search_mv4(t8, hp: HalfPel, cur_y: torch.Tensor, x0: int, y0: int,
               mx: int, my: int):
    """``Mpeg4NativeEncoder._search_mv4``: per 8x8 block the +-2 integer
    search around the 1MV winner (dy outer, dx inner, within +-15), then
    its 3x3 half-pel refine (dy outer, dx inner, within [-32, 31]), each
    the first strict minimum.  ``t8(k, nx, ny)`` is block k's integer
    SAD.  Returns ([(mx, my)] * 4, total SAD)."""
    out, total = [], 0
    ix0, iy0 = mx >> 1, my >> 1
    for k in range(4):
        sx, sy = x0 + 8 * (k & 1), y0 + 8 * (k >> 1)
        bs, best = None, None
        for ddy in range(-2, 3):
            for ddx in range(-2, 3):
                nx, ny = ix0 + ddx, iy0 + ddy
                if abs(nx) > 15 or abs(ny) > 15:
                    continue
                s = t8(k, nx, ny)
                if bs is None or s < bs:
                    bs, best = s, (nx, ny)
        ix, iy = best
        cands = [(2 * ix + ddx, 2 * iy + ddy) for ddy in (-1, 0, 1)
                 for ddx in (-1, 0, 1)
                 if -32 <= 2 * ix + ddx <= 31 and -32 <= 2 * iy + ddy <= 31]
        sads = hp.sads(cur_y[sy:sy + 8, sx:sx + 8], sy, sx, cands)
        j = min(range(len(cands)), key=lambda i: (sads[i], i))
        out.append(cands[j])
        total += sads[j]
    return out, total


def _mean_dev(y: torch.Tensor) -> torch.Tensor:
    """(mbh, mbw) int64: each macroblock's SAD against its mean
    (``int(cury.mean())``, the sum >> 8)."""
    h, w = y.shape
    b = y.to(torch.int64).reshape(h // 16, 16, w // 16, 16)
    mean = b.sum((1, 3)) >> 8
    return (b - mean[:, None, :, None]).abs().sum((1, 3))


def _set_vectors(row: List[int], fmv4, bmv4, single: bool) -> None:
    """A record's prediction vectors: each luma block's, and the chroma
    vector: ``(m >> 1) | (m & 1)`` of a ``single`` vector, else
    ``_round_chroma`` of the four's sums."""
    for lo, clo, mvs in ((FMV4, FCMV, fmv4), (BMV4, BCMV, bmv4)):
        if mvs is None:
            continue
        for k, (mx, my) in enumerate(mvs):
            row[lo + 2 * k] = mx
            row[lo + 2 * k + 1] = my
        if single:
            m0 = mvs[0]
            row[clo] = (m0[0] >> 1) | (m0[0] & 1)
            row[clo + 1] = (m0[1] >> 1) | (m0[1] & 1)
        else:
            row[clo] = round_chroma(sum(m[0] for m in mvs))
            row[clo + 1] = round_chroma(sum(m[1] for m in mvs))


def _host(planes) -> Planes:
    return tuple(p.cpu() for p in planes)


def mpeg4_enc_me_ref(cur: Planes, ref: Planes, q: int, four_mv: bool,
                     search: int) -> torch.Tensor:
    """Plain version of ``mpeg4_enc_me``: ``_encode_pvop``'s decisions in
    raster order (records with ``LV``, ``CBP`` and ``SKIP`` 0)."""
    dev = cur[0].device
    h, w = cur[0].shape
    mbh, mbw = h // 16, w // 16
    lim = min(int(search), MAX_SEARCH)
    t8 = int_sad_table(cur[0], ref[0]).cpu().numpy()
    devs = _mean_dev(cur[0]).cpu().tolist()
    hcur = _host(cur)
    cy = hcur[0].to(torch.int32)
    hp = HalfPel(ref[0])
    hpc = None
    rows = []
    grid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
    dec = Mpeg4Decoder()
    dec._mbw = mbw
    r = TABLE_R
    for mby in range(mbh):
        for mbx in range(mbw):
            x0, y0 = 16 * mbx, 16 * mby
            bx2, by2 = 2 * mbx, 2 * mby
            row = [0] * REC

            def sad16(ix, iy):
                return int(t8[by2, bx2, iy + r, ix + r]
                           + t8[by2, bx2 + 1, iy + r, ix + r]
                           + t8[by2 + 1, bx2, iy + r, ix + r]
                           + t8[by2 + 1, bx2 + 1, iy + r, ix + r])

            pred = dec._pred_mv(grid, bx2, by2, 0)
            cb = cy[y0:y0 + 16, x0:x0 + 16]
            mx, my, sad = search_mv(sad16, hp, cb, x0, y0, pred, lim)
            if devs[mby][mbx] < sad - 500:
                row[MODE] = MODE_INTRA
                for k in range(4):
                    grid[by2 + (k >> 1)][bx2 + (k & 1)] = (0, 0)
                rows.append(row)
                continue
            use4, mvs4 = False, None
            if four_mv:
                def t8k(k, nx, ny):
                    return int(t8[by2 + (k >> 1), bx2 + (k & 1),
                                  ny + r, nx + r])
                mvs4, sad4 = search_mv4(t8k, hp, cy, x0, y0, mx, my)
                use4 = sad4 + 300 < sad \
                    and any(m != (mx, my) for m in mvs4)
            row[MX], row[MY] = mx, my
            if use4:
                row[MODE] = MODE_INTER4
                _set_vectors(row, mvs4, None, False)
                if mx == 0 and my == 0:
                    # the JAX encoder's not_coded test reads the 4MV
                    # levels here: a skip sets the grid to (0, 0)
                    if hpc is None:
                        hpc = (HalfPel(ref[1]), HalfPel(ref[2]))
                    if not _any_level_4mv(hcur, hp, hpc, row, x0, y0, q):
                        mvs4 = [(0, 0)] * 4
                for k in range(4):
                    grid[by2 + (k >> 1)][bx2 + (k & 1)] = mvs4[k]
            else:
                row[MODE] = MODE_INTER
                _set_vectors(row, [(mx, my)] * 4, None, True)
                for k in range(4):
                    grid[by2 + (k >> 1)][bx2 + (k & 1)] = (mx, my)
            rows.append(row)
    return torch.tensor(rows, dtype=torch.int16).to(dev)


def _any_level_4mv(hcur: Planes, hp: HalfPel, hpc, row, x0, y0,
                   q: int) -> bool:
    """Whether the inter levels of a 4MV macroblock (its vectors in
    ``row``) are not all 0."""
    pred = [hp.block(y0 + 8 * (k >> 1), x0 + 8 * (k & 1), 8,
                     row[FMV4 + 2 * k], row[FMV4 + 2 * k + 1])
            for k in range(4)]
    pred += [h.block(y0 >> 1, x0 >> 1, 8, row[FCMV], row[FCMV + 1])
             for h in hpc]
    src = [hcur[0][y0 + 8 * (k >> 1):y0 + 8 * (k >> 1) + 8,
                   x0 + 8 * (k & 1):x0 + 8 * (k & 1) + 8] for k in range(4)]
    src += [p[y0 >> 1:(y0 >> 1) + 8, x0 >> 1:(x0 >> 1) + 8]
            for p in hcur[1:]]
    res = torch.stack(src).to(torch.int64) - torch.stack(pred).to(torch.int64)
    return bool(quant_inter_ref(fdct_ref(res), q).ne(0).any())


def direct_vectors(co: torch.Tensor, trb: int, trd: int):
    """Each macroblock's direct-mode vectors from the co-located anchor's
    records (``_direct_pred``: a skipped macroblock's vectors are 0):
    int64 (nmb, 4, 2) forward ``trb * mv / trd`` and backward
    ``(trb - trd) * mv / trd``, each divided toward 0."""
    n = co.shape[0]
    mv = co[:, FMV4:FMV4 + 8].to(torch.int64).reshape(n, 4, 2)
    mv = torch.where((co[:, SKIP] != 0)[:, None, None],
                     torch.zeros_like(mv), mv)
    f = torch.div(trb * mv, trd, rounding_mode="trunc")
    b = torch.div((trb - trd) * mv, trd, rounding_mode="trunc")
    return f, b


def mpeg4_enc_bme_ref(cur: Planes, fwd: Planes, bwd: Planes,
                      co: torch.Tensor, trb: int, trd: int,
                      search: int) -> torch.Tensor:
    """Plain version of ``mpeg4_enc_bme``: ``_encode_bvop``'s decisions,
    the predictors reset at each row (records with ``LV``, ``CBP`` and
    ``SKIP`` 0)."""
    dev = cur[0].device
    h, w = cur[0].shape
    mbh, mbw = h // 16, w // 16
    lim = min(int(search), MAX_SEARCH)
    n = mbh * mbw
    # the direct prediction's luma SAD of every macroblock
    dfv, dbv = direct_vectors(co, trb, trd)
    drec = torch.zeros((n, REC), dtype=torch.int16, device=dev)
    drec[:, MODE] = MODE_DIRECT
    drec[:, FMV4:FMV4 + 8] = dfv.reshape(n, 8).to(torch.int16)
    drec[:, BMV4:BMV4 + 8] = dbv.reshape(n, 8).to(torch.int16)
    dpy = _prediction(drec, mbw, fwd, bwd, nplanes=1)[0]
    dsad = (cur[0].to(torch.int64) - dpy).abs().reshape(
        mbh, 16, mbw, 16).sum((1, 3)).cpu().tolist()
    co_skip = (co[:, SKIP] != 0).cpu().tolist()
    dfv, dbv = dfv.cpu().tolist(), dbv.cpu().tolist()
    r = MAX_SEARCH
    tabs = [int_sad_table(cur[0], ref, r, 16).cpu().numpy()
            for ref in (fwd[0], bwd[0])]
    hps = (HalfPel(fwd[0]), HalfPel(bwd[0]))
    cy = cur[0].cpu().to(torch.int32)
    rows = []
    for mby in range(mbh):
        pf = pb = (0, 0)
        for mbx in range(mbw):
            i = mby * mbw + mbx
            x0, y0 = 16 * mbx, 16 * mby
            row = [0] * REC
            if co_skip[i]:
                row[MODE] = MODE_COSKIP
                _set_vectors(row, dfv[i], dbv[i], False)
                rows.append(row)
                continue
            cb = cy[y0:y0 + 16, x0:x0 + 16]
            found = []
            for t16, hp, p in zip(tabs, hps, (pf, pb)):
                def sad16(ix, iy, t16=t16):
                    return int(t16[mby, mbx, iy + r, ix + r])
                found.append(search_mv(sad16, hp, cb, x0, y0, p, lim))
            (fmx, fmy, fsad), (bmx, bmy, bsad) = found
            ipy = (hps[0].block(y0, x0, 16, fmx, fmy)
                   + hps[1].block(y0, x0, 16, bmx, bmy) + 1) >> 1
            isad = int((cb - ipy).abs().sum())
            cands = [(dsad[mby][mbx] - 16, 0), (fsad + 32, 3),
                     (bsad + 32, 2), (isad + 64, 1)]
            mb_type = min(cands)[1]
            row[MODE] = MODE_DIRECT + mb_type
            row[MX], row[MY], row[BMX], row[BMY] = fmx, fmy, bmx, bmy
            if mb_type == 0:
                _set_vectors(row, dfv[i], dbv[i], False)
            else:
                if mb_type in (1, 3):
                    _set_vectors(row, [(fmx, fmy)] * 4, None, True)
                    pf = (fmx, fmy)
                if mb_type in (1, 2):
                    _set_vectors(row, None, [(bmx, bmy)] * 4, True)
                    pb = (bmx, bmy)
            rows.append(row)
    return torch.tensor(rows, dtype=torch.int16).to(dev)
