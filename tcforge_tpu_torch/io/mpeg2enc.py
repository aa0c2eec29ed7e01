"""MPEG-2 video encoder: I/P/B pictures with motion estimation, on a
device.

The port of the JAX package's ``io/mpeg2enc.py`` as its CPU path takes
it: under ``JAX_PLATFORMS=cpu`` the JAX encoder sends its block math
through the native library (``_native_blocks``, ``:631-636``:
``_intra_native`` ``:668``, ``_p_native`` ``:725``, ``_b_native``
``:806``), so that C++ (``native/tcforge_host.cpp``) is what this module
computes, bit for bit.  The XLA forms the JAX package runs off the CPU
(``motion_search``, ``halfpel_refine``, ``_p_inter_math``,
``_b_code_math``) and its TPU workarounds (the shift-select MC, the
coefficient-major "slab" pipeline) are not ported.

A picture's device math runs through three kernels (``ops/kernels.py``):

- ``mpeg2_me``: the integer search (exhaustive for ``r <= 4``; else an
  exhaustive search of 8x8 blocks on 2x2-decimated planes within
  ``(r+1)//2``, then a +-2 refine at full resolution, the vector clamped
  to +-r) and the 3x3 half-pel refine; the first strict minimum wins, in
  dy-major then dx order, and a candidate outside the picture scores
  ``1 << 30``;
- ``mpeg2_enc_pred``: the half-pel prediction of each macroblock, each
  sample coordinate clamped on its own, chroma vectors halved toward 0
  (at 4:2:2 the horizontal component alone, over 8-wide, 16-tall chroma
  tiles: ``_chroma_mv_half_422``, ``_chroma_params``);
  in a B picture from the reference(s) its mode uses, and the mode
  itself (``mpeg2_enc_bmode``: the bi-average SAD, then the first minimum
  of ``(fsad, bsad, bisad - 256)``);
- ``mpeg2_enc_blocks``: per 8x8 block the float64 forward DCT (sums of
  fused multiply-adds in the native library's order), the quantiser, the
  dequantiser with MPEG-1 oddification or the 13818-2 mismatch control,
  the float64 IDCT and the clipped reconstruction; intra, inter with
  reconstruction (a P picture's intra macroblocks, chosen where ``sad >
  mb_act + 512``, coded intra in the same launch), or inter levels
  alone (B).  At 4:2:2 a macroblock has eight blocks, the chroma ones in
  the order Cb4 Cr5 Cb6 Cr7 (``_enc_layout``).

The plain torch functions below are the kernels' plain versions; the
wrappers run them for tensors on the CPU.  ``mb_act``, the mode and cbp
arithmetic and the macroblock records are plain torch on the device.

The host half is ``Mpeg2FullEncoder``: coded-order reordering, frame
and field pictures, MPEG-1 and D-pictures, TM5 rate control
(``io/mpeg2rc.py``, a pinned copy), the syntax writer
(``io/m2e.py``).  Each picture is one sync: its levels and records come
down, the writer codes them, and the rate controller reads the bits
before the next picture's quantiser is chosen.  The reconstructions
stay on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.io.m2e import m2e_picture
from tcforge_tpu_torch.io.mpeg2codec import dct_basis, fma64, mb_tile
from tcforge_tpu_torch.io.mpeg2host import (DEFAULT_INTRA_MATRIX, ZIGZAG,
                                            Mpeg2Encoder)
from tcforge_tpu_torch.io.mpeg2rc import (MB_BACKWARD, MB_FORWARD, MB_INTRA,
                                          MB_PATTERN, SCAN_ALT,
                                          RateController)

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

INVALID_SAD = 1 << 30          # a candidate that leaves the picture
INTRA_BIAS = 512               # use_intra = sad > mb_act + INTRA_BIAS
BI_BIAS = 256                  # B: the bi-average SAD's head start

# block coder modes (the kernel's template parameter)
ENC_INTRA, ENC_INTER, ENC_LEVELS = 0, 1, 2


def scan_order(alt: bool) -> np.ndarray:
    """The coefficient scan: alternate (13818-2 figure 7-3) or zigzag."""
    return np.asarray(SCAN_ALT if alt else ZIGZAG, np.int32)


def intra_weights() -> np.ndarray:
    """The default intra quantiser matrix, natural order (64,)."""
    return np.asarray(DEFAULT_INTRA_MATRIX, np.int32).reshape(64)


def trunc_div2(mv: torch.Tensor) -> torch.Tensor:
    """Chroma vectors of 4:2:0: each component halved toward 0."""
    return torch.div(mv, 2, rounding_mode="trunc")


def chroma_mv_half_422(mv: torch.Tensor) -> torch.Tensor:
    """Chroma vectors of 4:2:2 (``_chroma_mv_half_422``): the horizontal
    component (index 1 of the encoder's (y, x) vectors) halved toward 0,
    the vertical kept."""
    return torch.stack([mv[..., 0], trunc_div2(mv[..., 1])], -1)


def chroma_params(y: torch.Tensor, u: torch.Tensor):
    """(chroma vector map, chroma macroblock tile) from the planes'
    shapes (``_chroma_params``): full-height chroma is 4:2:2."""
    if u.shape[0] == y.shape[0]:
        return chroma_mv_half_422, (16, 8)
    return trunc_div2, (8, 8)


# ------------------------------------------------------------------ #
# The block coder (plain version of mpeg2_enc_blocks)

def fdct_f64(blk: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) float64 -> (N, 8, 8) float64, as ``fdct8x8`` of the
    native library computes it (its AVX-512 form): row pass ``t[i][j] =
    fma(x[i][k], B[j][k], t[i][j])``, column pass ``o[i][j] = fma(B[i][k],
    t[k][j], o[i][j])``, k = 0..7 from 0."""
    t = torch.zeros_like(blk)
    for k in range(8):
        t = fma64(blk[:, :, k:k + 1], basis[:, k][None, None, :], t)
    o = torch.zeros_like(blk)
    for k in range(8):
        o = fma64(basis[:, k][None, :, None], t[:, k:k + 1, :], o)
    return o


def idct_f64(coef: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) integer-valued float64 -> (N, 8, 8) float64, as
    ``idct8x8_d``: ``t[i][j] = fma(c[i][k], B[k][j], t)``, then ``o[i][j]
    = fma(B[k][i], t[k][j], o)``, k = 0..7 from 0."""
    t = torch.zeros_like(coef)
    for k in range(8):
        t = fma64(coef[:, :, k:k + 1], basis[k][None, None, :], t)
    o = torch.zeros_like(coef)
    for k in range(8):
        o = fma64(basis[k][None, :, None], t[:, k:k + 1, :], o)
    return o


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(h, w) -> (h/8 * w/8, 8, 8), raster order of the blocks."""
    h, w = plane.shape
    return (plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)
            .reshape(-1, 8, 8))


def _unblocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return (blocks.reshape(h // 8, w // 8, 8, 8).permute(0, 2, 1, 3)
            .reshape(h, w))


def _oddify(d: torch.Tensor) -> torch.Tensor:
    """11172-2 mismatch control: a nonzero even value steps toward 0."""
    even = (d != 0) & (d % 2 == 0)
    return torch.where(even, d - torch.sign(d), d)


def _mismatch(deq: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """13818-2 7.4.4: where ``on`` and the block's sum is even, flip the
    last coefficient's low bit."""
    flip = on & (deq.sum(dim=1) % 2 == 0)
    deq[:, 63] = torch.bitwise_xor(deq[:, 63], flip.to(deq.dtype))
    return deq


def _quant_intra(coef: torch.Tensor, qs: int, m1: bool,
                 weights: torch.Tensor) -> torch.Tensor:
    """(N, 64) DCT -> (N, 64) int64 levels, natural order: DC
    ``clip(rint(C00 / 8), 0, 255)``, AC ``clip(rint(C * 32 / (2 W 2qs)),
    +-lim)``."""
    lim = 255 if m1 else 2047
    den = 2.0 * weights.to(torch.float64) * (2.0 * qs)
    lv = torch.round(coef * 32.0 / den).clamp(-lim, lim).to(torch.int64)
    lv[:, 0] = torch.round(coef[:, 0] / 8.0).clamp(0, 255).to(torch.int64)
    return lv


def _dequant_intra(lv: torch.Tensor, qs: int, m1: bool,
                   weights: torch.Tensor) -> torch.Tensor:
    prod = lv * 2 * weights.to(torch.int64) * (2 * qs)
    deq = torch.div(prod, 32, rounding_mode="trunc")
    if m1:
        deq = _oddify(deq)
    deq[:, 0] = lv[:, 0] * 8
    deq = deq.clamp(-2048, 2047)
    if not m1:
        deq = _mismatch(deq, torch.ones_like(deq[:, 0], dtype=torch.bool))
    return deq


def _quant_inter(coef: torch.Tensor, qs: int, m1: bool) -> torch.Tensor:
    """``trunc(|rint(C)| / 2qs)`` with the sign of ``rint(C)``, the
    magnitude clamped to ``lim``."""
    lim = 255 if m1 else 2047
    c = torch.round(coef).to(torch.int64)
    q = torch.div(c.abs(), 2 * qs, rounding_mode="floor").clamp(max=lim)
    return torch.where(c < 0, -q, q)


def _dequant_inter(lv: torch.Tensor, qs: int, m1: bool) -> torch.Tensor:
    mag = (2 * lv.abs() + 1) * 16 * (2 * qs)
    deq = torch.where(lv == 0, torch.zeros_like(lv),
                      torch.sign(lv) * torch.div(mag, 32,
                                                 rounding_mode="floor"))
    if m1:
        deq = _oddify(deq)
    deq = deq.clamp(-2048, 2047)
    if not m1:
        deq = _mismatch(deq, torch.ones_like(deq[:, 0], dtype=torch.bool))
    return deq


def _scanned(lv: torch.Tensor, scan: torch.Tensor) -> torch.Tensor:
    """(N, 64) natural order -> (N, 64) int16 in scan order."""
    return lv[:, scan.long()].to(torch.int16)


def _recon(deq: torch.Tensor, basis: torch.Tensor,
           pred: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, 64) dequantised -> (N, 8, 8) uint8: the IDCT rounded half to
    even, plus the prediction, clipped."""
    pix = torch.round(idct_f64(deq.to(torch.float64).reshape(-1, 8, 8),
                               basis))
    if pred is not None:
        pix = pix + pred.to(torch.float64)
    return pix.clamp(0, 255).to(torch.uint8)


def intra_blocks(blk: torch.Tensor, qs: int, m1: bool, scan: torch.Tensor,
                 weights: torch.Tensor, basis: torch.Tensor):
    """``enc_intra_block`` over (N, 8, 8) uint8 blocks: (levels (N, 64)
    int16 in scan order, reconstruction (N, 8, 8) uint8)."""
    coef = fdct_f64(blk.to(torch.float64), basis).reshape(-1, 64)
    lv = _quant_intra(coef, qs, m1, weights)
    return (_scanned(lv, scan),
            _recon(_dequant_intra(lv, qs, m1, weights), basis, None))


def inter_blocks(blk: torch.Tensor, pred: torch.Tensor, qs: int, m1: bool,
                 scan: torch.Tensor, basis: torch.Tensor,
                 recon: bool = True):
    """``tc_enc_inter_plane``'s block (``recon``) or
    ``tc_enc_inter_levels``' over (N, 8, 8) uint8 blocks and their
    predictions; a block whose levels are all zero reconstructs to its
    prediction."""
    resid = blk.to(torch.float64) - pred.to(torch.float64)
    lv = _quant_inter(fdct_f64(resid, basis).reshape(-1, 64), qs, m1)
    levels = _scanned(lv, scan)
    if not recon:
        return levels, None
    coded = (lv != 0).any(dim=1)
    rec = pred.clone()
    if bool(coded.any()):
        rec[coded] = _recon(_dequant_inter(lv[coded], qs, m1), basis,
                            pred[coded])
    return levels, rec


def lv_slots(bh: int, bw: int, luma: bool, device,
             nb: int = 6) -> torch.Tensor:
    """Each block's row of a (nmb * nb, 64) levels array, raster order of
    the blocks (``lv_index`` slot -1 for luma, 4 or 5 for chroma, whose
    +1 the caller adds for Cr; with ``nb`` 8, 4:2:2, a macroblock's
    second chroma row at 6 or 7)."""
    by = torch.arange(bh, device=device)[:, None]
    bx = torch.arange(bw, device=device)[None, :]
    if luma:
        idx = ((by >> 1) * (bw >> 1) + (bx >> 1)) * nb + (by & 1) * 2 \
            + (bx & 1)
    elif nb == 8:
        idx = ((by >> 1) * bw + bx) * 8 + 4 + (by & 1) * 2
    else:
        idx = (by * bw + bx) * 6 + 4
    return idx.reshape(-1)


def enc_blocks_math(mode: int, cur: Sequence[torch.Tensor],
                    pred: Optional[Sequence[torch.Tensor]], qs: int,
                    alt: bool, m1: bool,
                    intra_mb: Optional[torch.Tensor] = None):
    """Plain version of ``mpeg2_enc_blocks``: the three planes of a
    picture (4:2:0, or 4:2:2 with chroma of the luma's height) coded
    block by block.  ``mode`` ENC_INTRA (no prediction),
    ENC_INTER (with reconstruction; the blocks of the macroblocks where
    ``intra_mb`` (mbh, mbw) is set are coded intra, as ``tc_enc_intra_sel``
    recodes them) or ENC_LEVELS (inter, no reconstruction).  Returns
    (levels (nmb, 6, 64) int16 in scan order, macroblock-interleaved, or
    (nmb, 8, 64) for 4:2:2 planes; the reconstructed planes, or None for
    ENC_LEVELS)."""
    y = cur[0]
    dev = y.device
    h, w = y.shape
    mbh, mbw = h // 16, w // 16
    nb = 8 if cur[1].shape[0] == h else 6
    scan = torch.from_numpy(scan_order(alt)).to(dev)
    weights = torch.from_numpy(intra_weights()).to(dev)
    basis = torch.from_numpy(dct_basis()).to(dev)
    levels = torch.empty((mbh * mbw * nb, 64), dtype=torch.int16,
                         device=dev)
    recs = []
    for k, plane in enumerate(cur):
        ph, pw = plane.shape
        blk = _blocks(plane)
        slots = lv_slots(ph // 8, pw // 8, k == 0, dev, nb) + (k == 2)
        if mode == ENC_INTRA:
            lv, rec = intra_blocks(blk, qs, m1, scan, weights, basis)
        else:
            pblk = _blocks(pred[k])
            lv, rec = inter_blocks(blk, pblk, qs, m1, scan, basis,
                                   recon=mode == ENC_INTER)
            if intra_mb is not None and bool(intra_mb.any()):
                fy = 2 if k == 0 or nb == 8 else 1
                fx = 2 if k == 0 else 1
                sel = intra_mb.repeat_interleave(fy, 0).repeat_interleave(
                    fx, 1).reshape(-1)
                ilv, irec = intra_blocks(blk[sel], qs, m1, scan, weights,
                                         basis)
                lv[sel] = ilv
                rec[sel] = irec
        levels[slots] = lv
        if rec is not None:
            recs.append(_unblocks(rec, ph, pw))
    return (levels.reshape(mbh * mbw, nb, 64),
            tuple(recs) if mode != ENC_LEVELS else None)


# ------------------------------------------------------------------ #
# Motion estimation (plain version of mpeg2_me)

def mb_sums(x: torch.Tensor, mb: int) -> torch.Tensor:
    """(h, w) -> (h/mb, w/mb): the sum of each mb x mb block, int64."""
    h, w = x.shape
    return x.reshape(h // mb, mb, w // mb, mb).sum(dim=(1, 3),
                                                  dtype=torch.int64)


def dec2(p: torch.Tensor) -> torch.Tensor:
    """``me_dec2``: the 2x2 box average ``(a+b+c+d+2) >> 2``."""
    q = p.to(torch.int32)
    h2, w2 = q.shape[0] // 2, q.shape[1] // 2
    q = q[:2 * h2, :2 * w2]
    s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def _first_min(keys: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 0 of int64 (cand, ...) SADs:
    the packed key ``sad * n + index`` has one smallest value."""
    n = keys.shape[0]
    idx = torch.arange(n, device=keys.device).reshape(
        (n,) + (1,) * (keys.dim() - 1))
    return torch.argmin(keys * n + idx, dim=0)


def exhaustive_search(ref: torch.Tensor, cur: torch.Tensor, r: int,
                      mb: int):
    """``me_exhaustive``: per mb x mb block the first best (dy, dx) in
    [-r, r]^2 (dy-major) and its SAD; displacements that leave the plane
    score ``INVALID_SAD``."""
    h, w = ref.shape
    mbh, mbw = h // mb, w // mb
    dev = ref.device
    rr = ref.to(torch.int32)
    c = cur.to(torch.int32)[:mbh * mb, :mbw * mb]
    y0 = torch.arange(mbh, device=dev)[:, None] * mb
    x0 = torch.arange(mbw, device=dev)[None, :] * mb
    rows = torch.arange(mbh * mb, device=dev)
    cols = torch.arange(mbw * mb, device=dev)
    sads = []
    for dy in range(-r, r + 1):
        oky = (y0 + dy >= 0) & (y0 + mb + dy <= h)
        for dx in range(-r, r + 1):
            ok = oky & (x0 + dx >= 0) & (x0 + mb + dx <= w)
            shifted = rr[(rows + dy).clamp(0, h - 1)[:, None],
                         (cols + dx).clamp(0, w - 1)[None, :]]
            s = mb_sums((shifted - c).abs(), mb)
            sads.append(torch.where(ok, s, INVALID_SAD))
    sads = torch.stack(sads)
    best = _first_min(sads)
    n = 2 * r + 1
    mv = torch.stack([best // n - r, best % n - r], dim=-1)
    return mv.to(torch.int32), sads.gather(0, best[None])[0].to(torch.int32)


def _mb_windows(plane: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                size: int) -> torch.Tensor:
    """(..., size, size) int32 windows of ``plane`` at top-left corners
    (ys, xs); rows and columns clamped into the plane (the callers mark
    the windows that leave it)."""
    h, w = plane.shape
    off = torch.arange(size, device=plane.device)
    rows = (ys[..., None] + off).clamp(0, h - 1)
    cols = (xs[..., None] + off).clamp(0, w - 1)
    return plane.to(torch.int32)[rows[..., :, None], cols[..., None, :]]


def me16_refine_math(ref: torch.Tensor, cur: torch.Tensor, r: int):
    """Plain version of ``mpeg2_me`` for one reference: ``tc_me16_refine``
    -> (mvh (mbh, mbw, 2) int32 half-pel (y, x), sad (mbh, mbw) int32)."""
    h, w = ref.shape
    mbh, mbw = h // 16, w // 16
    dev = ref.device
    y0 = (torch.arange(mbh, device=dev) * 16)[:, None].expand(mbh, mbw)
    x0 = (torch.arange(mbw, device=dev) * 16)[None, :].expand(mbh, mbw)
    curw = _mb_windows(cur, y0, x0, 16)                 # (mbh, mbw, 16, 16)
    if r <= 4:
        mv, _ = exhaustive_search(ref, cur, r, 16)
    else:
        cmv, _ = exhaustive_search(dec2(ref), dec2(cur), (r + 1) // 2, 8)
        base = cmv * 2
        cand, sads = [], []
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                vy = (base[..., 0] + dy).clamp(-r, r)
                vx = (base[..., 1] + dx).clamp(-r, r)
                ok = ((y0 + vy >= 0) & (y0 + 16 + vy <= h)
                      & (x0 + vx >= 0) & (x0 + 16 + vx <= w))
                win = _mb_windows(ref, y0 + vy, x0 + vx, 16)
                s = (win - curw).abs().sum(dim=(-2, -1), dtype=torch.int64)
                sads.append(torch.where(ok, s, INVALID_SAD))
                cand.append(torch.stack([vy, vx], dim=-1))
        best = _first_min(torch.stack(sads))
        mv = torch.stack(cand).gather(
            0, best[None, ..., None].expand(1, mbh, mbw, 2))[0]
    base = mv.to(torch.int32) * 2
    cand, sads = [], []
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            vy, vx = base[..., 0] + dy, base[..., 1] + dx
            iy, ix = vy >> 1, vx >> 1
            hy, hx = vy & 1, vx & 1
            ok = ((y0 + iy >= 0) & (y0 + 16 + iy + hy <= h)
                  & (x0 + ix >= 0) & (x0 + 16 + ix + hx <= w))
            win = _mb_windows(ref, y0 + iy, x0 + ix, 17)
            a, b = win[..., :16, :16], win[..., :16, 1:]
            c, d = win[..., 1:, :16], win[..., 1:, 1:]
            hy4, hx4 = hy[..., None, None], hx[..., None, None]
            p = torch.where((hy4 == 1) & (hx4 == 1), (a + b + c + d + 2) >> 2,
                            torch.where(hx4 == 1, (a + b + 1) >> 1,
                                        torch.where(hy4 == 1,
                                                    (a + c + 1) >> 1, a)))
            s = (p - curw).abs().sum(dim=(-2, -1), dtype=torch.int64)
            sads.append(torch.where(ok, s, INVALID_SAD))
            cand.append(torch.stack([vy, vx], dim=-1))
    sads = torch.stack(sads)
    best = _first_min(sads)
    mvh = torch.stack(cand).gather(
        0, best[None, ..., None].expand(1, mbh, mbw, 2))[0]
    return mvh.to(torch.int32), sads.gather(0, best[None])[0].to(torch.int32)


def mb_act(plane: torch.Tensor) -> torch.Tensor:
    """``tc_mb_act``: per 16x16 macroblock ``floor(sum |256 x - S| /
    256)``, S the macroblock's sum (the exact integer form of the mean
    absolute deviation), int32 (mbh, mbw)."""
    h, w = plane.shape
    mbh, mbw = h // 16, w // 16
    x = plane[:mbh * 16, :mbw * 16].to(torch.int64)
    s = mb_sums(x, 16)
    dev = 256 * x - s.repeat_interleave(16, 0).repeat_interleave(16, 1)
    return torch.div(mb_sums(dev.abs(), 16), 256,
                     rounding_mode="floor").to(torch.int32)


# ------------------------------------------------------------------ #
# Prediction (plain versions of mpeg2_enc_pred and mpeg2_enc_bmode)

def mc_pred(ref: torch.Tensor, mvh: torch.Tensor, mb) -> torch.Tensor:
    """``tc_mc_pred_half``: each mb x mb tile of a plane (or (rows,
    columns) tile) predicted at its half-pel vector (y, x), every sample
    coordinate clamped into the plane on its own; (a+b+1)>>1 and
    (a+b+c+d+2)>>2 at the half positions."""
    h, w = ref.shape
    dev = ref.device
    mby, mbx = mb_tile(mb)
    vy = mvh[..., 0].repeat_interleave(mby, 0).repeat_interleave(mbx, 1)
    vx = mvh[..., 1].repeat_interleave(mby, 0).repeat_interleave(mbx, 1)
    yy = torch.arange(h, device=dev)[:, None] + (vy >> 1)
    xx = torch.arange(w, device=dev)[None, :] + (vx >> 1)
    hy, hx = (vy & 1) == 1, (vx & 1) == 1
    r = ref.to(torch.int32)
    y0, y1 = yy.clamp(0, h - 1), (yy + 1).clamp(0, h - 1)
    x0, x1 = xx.clamp(0, w - 1), (xx + 1).clamp(0, w - 1)
    a, b, c, d = r[y0, x0], r[y0, x1], r[y1, x0], r[y1, x1]
    p = torch.where(hx & hy, (a + b + c + d + 2) >> 2,
                    torch.where(hx, (a + b + 1) >> 1,
                                torch.where(hy, (a + c + 1) >> 1, a)))
    return p.to(torch.uint8)


def b_select(fp: torch.Tensor, bp: torch.Tensor, mode: torch.Tensor,
             mb) -> torch.Tensor:
    """``tc_b_select_pred``: per macroblock the forward (0), backward (1)
    or the average ``(f + b + 1) >> 1`` (2) prediction."""
    mby, mbx = mb_tile(mb)
    m = mode.repeat_interleave(mby, 0).repeat_interleave(mbx, 1)
    bi = ((fp.to(torch.int32) + bp.to(torch.int32) + 1) >> 1).to(torch.uint8)
    return torch.where(m == 0, fp, torch.where(m == 1, bp, bi))


def bisad(fp: torch.Tensor, bp: torch.Tensor,
          cur: torch.Tensor) -> torch.Tensor:
    """``tc_bisad``: per 16x16 macroblock the SAD of the bi-average
    prediction, int32."""
    bi = (fp.to(torch.int32) + bp.to(torch.int32) + 1) >> 1
    return mb_sums((bi - cur.to(torch.int32)).abs(), 16).to(torch.int32)


def b_mode(fsad: torch.Tensor, bsad: torch.Tensor,
           bi: torch.Tensor) -> torch.Tensor:
    """The first minimum of ``(fsad, bsad, bisad - 256)``: 0 forward, 1
    backward, 2 both."""
    mode = torch.zeros_like(fsad)
    best = fsad
    mode = torch.where(bsad < best, 1, mode)
    best = torch.minimum(bsad, best)
    return torch.where(bi - BI_BIAS < best, 2, mode).to(torch.int32)


def enc_pred_math(fwd: Sequence[torch.Tensor], fmv: torch.Tensor,
                  bwd: Optional[Sequence[torch.Tensor]] = None,
                  bmv: Optional[torch.Tensor] = None,
                  mode: Optional[torch.Tensor] = None) -> Tuple:
    """Plain version of ``mpeg2_enc_pred``: the prediction of each of the
    planes of ``fwd`` (luma first, then chroma at the chroma vectors of
    ``chroma_params``).  With ``mode`` (mbh, mbw) each macroblock is
    predicted from the reference(s) its mode uses, as
    ``tc_b_mc_sel_pred2`` (the same values as ``tc_b_select_pred`` on two
    whole predictions)."""
    c_mv, c_mb = (chroma_params(fwd[0], fwd[1]) if len(fwd) > 1
                  else (None, None))
    out = []
    for k, f in enumerate(fwd):
        mb = 16 if k == 0 else c_mb
        fm = fmv if k == 0 else c_mv(fmv)
        fp = mc_pred(f, fm, mb)
        if mode is None:
            out.append(fp)
            continue
        bm = bmv if k == 0 else c_mv(bmv)
        out.append(b_select(fp, mc_pred(bwd[k], bm, mb), mode, mb))
    return tuple(out)


def enc_bmode_math(fy: torch.Tensor, by: torch.Tensor, fmv: torch.Tensor,
                   fsad: torch.Tensor, bmv: torch.Tensor,
                   bsad: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mpeg2_enc_bmode``: each B macroblock's mode
    from its two luma predictions' bi-average SAD and the two searches'
    SADs (``_b_native``)."""
    bi = bisad(mc_pred(fy, fmv, 16), mc_pred(by, bmv, 16), cur)
    return b_mode(fsad, bsad, bi)


# ------------------------------------------------------------------ #
# A picture's device math, through the kernels

def _kernels():
    from tcforge_tpu_torch.ops import kernels
    return kernels


def _cbp(levels: torch.Tensor) -> torch.Tensor:
    """The coded block pattern of (nmb, 6 or 8, 64) levels, the first
    block in the highest bit."""
    nb = levels.shape[1]
    nz = (levels != 0).any(dim=2).to(torch.int32)
    weights = (1 << torch.arange(nb - 1, -1, -1, device=levels.device)).to(
        torch.int32)
    return (nz * weights).sum(dim=1, dtype=torch.int32)


def encode_intra_math(y, u, v, qs: int, alt: bool = False, m1: bool = False):
    """I picture: (levels (nmb, 6 or 8, 64) int16, recon y, u, v)."""
    levels, rec = _kernels().mpeg2_enc_blocks(ENC_INTRA, (y, u, v), None,
                                              qs, alt, m1)
    return (levels, *rec)


def encode_p_math(y, u, v, refs: Planes, qs: int, r: int, alt: bool = False,
                  m1: bool = False):
    """P picture (``_p_native``): (mbinfo (nmb, 8) int32, levels, recon y,
    u, v)."""
    k = _kernels()
    mv, sad = k.mpeg2_me((refs[0],), y, r)
    mvh, sad = mv[0], sad[0]
    use_intra = sad > mb_act(y) + INTRA_BIAS
    pred = k.mpeg2_enc_pred(refs, mvh)
    levels, rec = k.mpeg2_enc_blocks(ENC_INTER, (y, u, v), pred, qs, alt,
                                     m1, use_intra)
    cbp = _cbp(levels)
    fi = use_intra.reshape(-1)
    mvf = mvh.reshape(-1, 2)
    zero_mv = (mvf[:, 0] == 0) & (mvf[:, 1] == 0)
    modes = torch.where(fi, MB_INTRA,
                        torch.where(cbp > 0, MB_FORWARD | MB_PATTERN,
                                    MB_FORWARD))
    modes = torch.where(~fi & zero_mv & (cbp == 0), 0, modes)
    mbinfo = torch.zeros((fi.shape[0], 8), dtype=torch.int32,
                         device=y.device)
    mbinfo[:, 0] = modes
    mbinfo[:, 1] = mvf[:, 1]
    mbinfo[:, 2] = mvf[:, 0]
    mbinfo[:, 5] = cbp
    return (mbinfo, levels, *rec)


def encode_b_math(y, u, v, fwd: Planes, bwd: Planes, qs: int, r: int,
                  alt: bool = False, m1: bool = False):
    """B picture (``_b_native``): (mbinfo (nmb, 8) int32, levels)."""
    k = _kernels()
    mv, sad = k.mpeg2_me((fwd[0], bwd[0]), y, r)
    fmv, bmv = mv[0], mv[1]
    mode = k.mpeg2_enc_bmode(fwd[0], bwd[0], fmv, sad[0], bmv, sad[1], y)
    pred = k.mpeg2_enc_pred(fwd, fmv, bwd, bmv, mode)
    levels, _ = k.mpeg2_enc_blocks(ENC_LEVELS, (y, u, v), pred, qs, alt, m1)
    cbp = _cbp(levels)
    modef = mode.reshape(-1)
    base = torch.where(modef == 0, MB_FORWARD,
                       torch.where(modef == 1, MB_BACKWARD,
                                   MB_FORWARD | MB_BACKWARD))
    modes = torch.where(cbp > 0, base | MB_PATTERN, base)
    fmvf, bmvf = fmv.reshape(-1, 2), bmv.reshape(-1, 2)
    mbinfo = torch.zeros((modef.shape[0], 8), dtype=torch.int32,
                         device=y.device)
    mbinfo[:, 0] = modes
    mbinfo[:, 1] = fmvf[:, 1]
    mbinfo[:, 2] = fmvf[:, 0]
    mbinfo[:, 3] = bmvf[:, 1]
    mbinfo[:, 4] = bmvf[:, 0]
    mbinfo[:, 5] = cbp
    return mbinfo, levels


def encode_d_math(y, u, v) -> torch.Tensor:
    """MPEG-1 D picture (11172-2 2.4.3.6; ``encode_d_math`` of the JAX
    package): one level a block, its mean rounded half to even, in slot
    0 of (nmb, 6, 64) int16 levels."""
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16

    def means(p):
        m = torch.round(mb_sums(p, 8).to(torch.float64) / 64.0)
        return m.clamp(0, 255).to(torch.int16)

    levels = torch.zeros((mbh * mbw, 6, 64), dtype=torch.int16,
                         device=y.device)
    # figure 6-10 luma block order inside a macroblock: TL TR BL BR
    levels[:, 0:4, 0] = (means(y).reshape(mbh, 2, mbw, 2)
                         .permute(0, 2, 1, 3).reshape(-1, 4))
    levels[:, 4, 0] = means(u).reshape(-1)
    levels[:, 5, 0] = means(v).reshape(-1)
    return levels


class Mpeg2IntraEncoder(Mpeg2Encoder):
    """The intra-only encoder (``gop_n=1``) on the planes' device: the
    pinned writer of ``io/mpeg2host.py``, whose DCT and quantiser run in
    the block coder instead (intra mode at the picture's qscale, 4:2:0 or
    4:2:2).  The numpy quantiser's float64 DCT is a BLAS product that
    sums k = 0..7 in order with fused multiply-adds, as the kernel does,
    so the levels are the same (held at tolerance 0 in the tests).  A
    picture is one launch and one download of its levels; the padding
    to the macroblock grid runs on the device too."""

    @staticmethod
    def _pad_to(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
        ph, pw = plane.shape
        if (ph, pw) == (h, w):
            return plane
        dev = plane.device
        rows = torch.arange(h, device=dev).clamp(max=ph - 1)
        cols = torch.arange(w, device=dev).clamp(max=pw - 1)
        return plane[rows][:, cols]

    def _write_slices(self, w, planes, mb_w: int, mb_h: int) -> None:
        levels, _ = _kernels().mpeg2_enc_blocks(ENC_INTRA, planes, None,
                                                self.qscale, False, False)
        lv = levels.cpu().numpy().astype(np.int32).reshape(mb_h, mb_w, -1,
                                                           64)
        cs = self.csub
        y = (lv[:, :, :4].reshape(mb_h, mb_w, 2, 2, 64)
             .transpose(0, 2, 1, 3, 4).reshape(2 * mb_h, 2 * mb_w, 64))
        chroma = [lv[:, :, 4 + c::2].transpose(0, 2, 1, 3)
                  .reshape(mb_h * cs, mb_w, 64) for c in (0, 1)]
        coded = []
        for ac in (y, *chroma):
            ac = np.ascontiguousarray(ac)
            coded.append((ac[..., 0].copy(), ac))
            ac[..., 0] = 0
        self._coded = iter(coded)
        super()._write_slices(w, planes, mb_w, mb_h)

    def _quantize_plane(self, plane):
        # the levels _write_slices computed, for its planes y, u, v in turn
        return next(self._coded)


# ------------------------------------------------------------------ #
# The host's GOP loop

def _fcode(search_range: int) -> int:
    """The f_code whose vectors cover +-2 * range half-pels."""
    fc = 1
    while (16 << (fc - 1)) < 2 * search_range + 1:
        fc += 1
    if fc > 7:
        raise ValueError(
            f"search_range {search_range} needs f_code {fc} > 7; "
            "maximum supported range is 1008")
    return fc


class Mpeg2FullEncoder:
    """IPB GOP encoder producing a complete MPEG-2 (or MPEG-1) elementary
    stream, as the JAX package's ``Mpeg2FullEncoder`` (``io/mpeg2enc.py:
    1319-1647``) writes it: ``gop_n`` the I distance, ``gop_m`` the anchor
    distance (3: two B pictures between anchors), ``rate_control`` TM5
    toward ``bitrate_kbps`` (else constant ``qscale``), ``fields`` two
    field pictures a frame (16x16 same-parity field prediction),
    ``pulldown`` the 3:2 flags by display index, ``alt_scan``, ``mpeg1``
    (11172-2 syntax, a GOP header per I picture), ``dpict`` (MPEG-1
    D-pictures alone) and ``chroma`` 420 or 422 (the 422P profile: chroma
    planes of the luma's height, eight blocks a macroblock; MPEG-2 only).
    ``push_frame`` takes a display-order frame's uint8 planes, on the
    device that does the block math, and returns the bytes coded so far;
    ``flush`` codes the frames still waiting as P pictures and ends the
    sequence.  The pass log of ``-R`` is written (pass 1) and read (pass
    2) as in the JAX encoder."""

    def __init__(self, width: int, height: int, fps: float = 25.0,
                 qscale: int = 8, gop_n: int = 12, gop_m: int = 1,
                 search_range: int = 8, bitrate_kbps: int = 8000,
                 rate_control: bool = False, pass_mode: int = 0,
                 pass_log: Optional[str] = None, qmin: int = 1,
                 qmax: int = 31, max_bitrate_kbps: int = 0,
                 pulldown: bool = False, fields: bool = False,
                 top_field_first: bool = True, alt_scan: bool = False,
                 mpeg1: bool = False, dpict: bool = False,
                 chroma: int = 420):
        if width % 16 or height % 16:
            raise ValueError("mpeg2enc: geometry must be multiple of 16")
        if chroma not in (420, 422):
            raise ValueError("mpeg2enc: chroma must be 420 or 422")
        if chroma == 422 and (mpeg1 or dpict):
            raise ValueError("mpeg2enc: 4:2:2 is MPEG-2-only "
                             "(no mpeg1/dpict)")
        self.chroma = chroma
        if mpeg1 and (fields or alt_scan or pulldown):
            raise ValueError("mpeg1: field pictures / alternate scan "
                             "/ pulldown flags are MPEG-2 syntax")
        if dpict and not mpeg1:
            raise ValueError("dpict: D-pictures are MPEG-1 syntax "
                             "(11172-2 2.4.3.4) — set mpeg1=1")
        if fields and height % 32:
            raise ValueError("mpeg2enc: field pictures need height "
                             "multiple of 32 (mb-aligned fields)")
        if gop_m < 1 or gop_n < 1 or gop_n % gop_m:
            raise ValueError("mpeg2enc: gop_n must be a multiple "
                             "of gop_m")
        self.width, self.height = width, height
        self.dpict = dpict
        self.pass_mode = pass_mode
        self.pass_log = pass_log
        self._pass_stats: List[Tuple[int, int]] = []
        complexities = None
        if pass_mode == 2 and pass_log:
            with open(pass_log) as f:
                complexities = [int(line.split()[1]) for line in f
                                if line.strip()]
        self.rc = RateController(
            bitrate_kbps, fps * (2 if fields else 1), gop_n, gop_m,
            qscale, complexities=complexities, qmin=qmin, qmax=qmax) \
            if (rate_control or pass_mode == 2) else None
        self.qscale = max(qmin, min(qmax, qscale))
        self.pulldown = pulldown
        self.fields = fields
        self.top_field_first = top_field_first
        self.alt_scan = alt_scan
        self.mpeg1 = mpeg1
        self.gop_n, self.gop_m = gop_n, gop_m
        self.range = search_range
        self.fcode = _fcode(search_range)
        self._seq = Mpeg2Encoder(width, height, fps=fps, qscale=qscale,
                                 bitrate_kbps=bitrate_kbps,
                                 max_bitrate_kbps=max_bitrate_kbps,
                                 pulldown=pulldown, interlaced=fields,
                                 mpeg1=mpeg1, chroma=chroma)
        self._frame_no = 0          # display index of the next input
        self._gop_base = 0          # mpeg1: first displayed frame of the GOP
        self._pending: List[Tuple[int, torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = []      # waiting Bs
        self._recon: Optional[Planes] = None            # the last anchor
        self._recon_f: Dict[int, Planes] = {}           # its fields
        self._out: List[bytes] = []

    # -- internals ---------------------------------------------------- #

    def _pick_q(self, pic_type: int = 2) -> int:
        return self.rc.pick_qscale(pic_type) if self.rc else self.qscale

    def _emit(self, pic_type: int, temporal_ref: int, qscale: int,
              mbinfo, levels, with_seq: bool = False, ps: int = 0,
              gop_first_disp: int = 0, gop_closed: bool = False) -> None:
        """Code one picture: its records and levels come to the host (the
        picture's one wait for the device), the syntax writer codes them
        and the rate controller reads the bits.  ps: 0 frame picture, 1
        and 2 the top and bottom field."""
        if isinstance(levels, torch.Tensor):
            levels = levels.cpu().numpy()
        if isinstance(mbinfo, torch.Tensor):
            mbinfo = mbinfo.cpu().numpy()
        data = b""
        if with_seq:
            data += self._seq.sequence_header()
            if self.mpeg1:
                data += self._seq.gop_header(gop_first_disp,
                                             closed=gop_closed)
        flags = (8 if self.alt_scan else 0) | (ps << 4) \
            | (64 if self.mpeg1 else 0) \
            | (128 if self.chroma == 422 else 0)
        if self.pulldown and not ps:
            tff, rff = ((1, 1), (0, 0), (0, 1), (1, 0))[temporal_ref % 4]
            flags |= tff | (rff << 1)
        data += m2e_picture(
            self.width, self.height // 2 if ps else self.height,
            pic_type, temporal_ref, qscale,
            self.fcode if pic_type >= 2 else 15,
            self.fcode if pic_type == 3 else 15, mbinfo, levels,
            flags=flags)
        if self.rc:
            self.rc.update(pic_type, len(data) * 8)
        self._pass_stats.append((pic_type, len(data) * 8))
        self._out.append(data)

    def _tref(self, disp_idx: int) -> int:
        """temporal_reference: free-running mod 1024 in MPEG-2 (no GOP
        headers); MPEG-1 restarts it at each GOP header."""
        if self.mpeg1:
            return (disp_idx - self._gop_base) % 1024
        return disp_idx % 1024

    def _encode_anchor(self, disp_idx: int, y, u, v) -> None:
        """Code the new anchor as I or P, then the B pictures waiting on
        it."""
        gop_pos = disp_idx % self.gop_n
        q = self._pick_q(1 if gop_pos == 0 else 2)
        if gop_pos == 0:
            if self.mpeg1:
                self._gop_base = (min([disp_idx]
                                      + [b[0] for b in self._pending])
                                  if disp_idx else 0)
            levels, ry, ru, rv = encode_intra_math(y, u, v, q, self.alt_scan,
                                                   self.mpeg1)
            self._emit(1, self._tref(disp_idx), q, self._intra_info(1),
                       levels, with_seq=True, gop_first_disp=self._gop_base,
                       gop_closed=disp_idx == 0)
        else:
            mbinfo, levels, ry, ru, rv = encode_p_math(
                y, u, v, self._recon, q, self.range, self.alt_scan,
                self.mpeg1)
            self._emit(2, self._tref(disp_idx), q, mbinfo, levels)
        prev_anchor = self._recon
        self._recon = (ry, ru, rv)
        for bidx, by, bu, bv in self._pending:
            if prev_anchor is None:
                prev_anchor = self._recon
            q = self._pick_q(3)
            mbinfo, levels = encode_b_math(
                by, bu, bv, prev_anchor, self._recon, q, self.range,
                self.alt_scan, self.mpeg1)
            self._emit(3, self._tref(bidx), q, mbinfo, levels)
        self._pending = []

    def _intra_info(self, rows_div: int) -> np.ndarray:
        nmb = (self.height // (16 * rows_div)) * (self.width // 16)
        mbinfo = np.zeros((nmb, 8), np.int32)
        mbinfo[:, 0] = MB_INTRA
        return mbinfo

    # -- field pictures ------------------------------------------------ #

    def _field_order(self):
        return (0, 1) if self.top_field_first else (1, 0)

    @staticmethod
    def _set_fieldsel(mbinfo, parity: int):
        """Same-parity prediction: the vertical field select of both
        directions is the parity (bit 0 forward, bit 2 backward)."""
        mbinfo = mbinfo.clone()
        mbinfo[:, 7] = parity * 5
        return mbinfo

    def _encode_intra_field(self, parity: int, tref: int, fy, fu, fv,
                            with_seq: bool):
        q = self._pick_q(1)
        levels, ry, ru, rv = encode_intra_math(fy, fu, fv, q, self.alt_scan)
        self._emit(1, tref, q, self._intra_info(2), levels,
                   with_seq=with_seq, ps=parity + 1)
        return ry, ru, rv

    def _encode_anchor_fields(self, disp_idx: int, y, u, v) -> None:
        gop_pos = disp_idx % self.gop_n
        tref = disp_idx % 1024
        prev = dict(self._recon_f) if self._recon_f else None
        for k, parity in enumerate(self._field_order()):
            fy, fu, fv = y[parity::2], u[parity::2], v[parity::2]
            if gop_pos == 0 or prev is None:
                rec = self._encode_intra_field(parity, tref, fy, fu, fv,
                                               with_seq=(k == 0))
            else:
                q = self._pick_q(2)
                mbinfo, levels, ry, ru, rv = encode_p_math(
                    fy, fu, fv, prev[parity], q, self.range, self.alt_scan)
                self._emit(2, tref, q, self._set_fieldsel(mbinfo, parity),
                           levels, ps=parity + 1)
                rec = (ry, ru, rv)
            self._recon_f[parity] = rec
        if prev is None:
            prev = dict(self._recon_f)
        for bidx, by, bu, bv in self._pending:
            for parity in self._field_order():
                q = self._pick_q(3)
                mbinfo, levels = encode_b_math(
                    by[parity::2], bu[parity::2], bv[parity::2],
                    prev[parity], self._recon_f[parity], q, self.range,
                    self.alt_scan)
                self._emit(3, bidx % 1024, q,
                           self._set_fieldsel(mbinfo, parity), levels,
                           ps=parity + 1)
        self._pending = []

    # -- public API ---------------------------------------------------- #

    def push_frame(self, y: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> bytes:
        """Feed one display-order frame; the coded bytes ready so far
        (empty while B frames wait for their anchor)."""
        ch = self.height if self.chroma == 422 else self.height // 2
        if (tuple(y.shape) != (self.height, self.width)
                or tuple(u.shape) != (ch, self.width // 2)
                or tuple(v.shape) != (ch, self.width // 2)):
            raise ValueError(
                f"push_frame: plane shapes {tuple(y.shape)}/"
                f"{tuple(u.shape)} do not match {self.width}x"
                f"{self.height} chroma {self.chroma}")
        idx = self._frame_no
        self._frame_no += 1
        if self.dpict:
            gop_pos = idx % self.gop_n
            if gop_pos == 0:
                self._gop_base = idx
            levels = encode_d_math(y, u, v)
            self._emit(4, self._tref(idx), self.qscale, self._intra_info(1),
                       levels, with_seq=gop_pos == 0,
                       gop_first_disp=self._gop_base, gop_closed=True)
            return self._take()
        gop_pos = idx % self.gop_n
        have_anchor = (bool(self._recon_f) if self.fields
                       else self._recon is not None)
        is_anchor = (gop_pos % self.gop_m) == 0 or not have_anchor
        if is_anchor and self.fields:
            self._encode_anchor_fields(idx, y, u, v)
        elif is_anchor:
            self._encode_anchor(idx, y, u, v)
        else:
            self._pending.append((idx, y, u, v))
        return self._take()

    def _take(self) -> bytes:
        out = b"".join(self._out)
        self._out = []
        return out

    def flush(self) -> bytes:
        """Code the frames past the last anchor as chained P pictures (a
        trailing B would display before its last reference) and end the
        sequence."""
        for idx, py, pu, pv in self._pending:
            if self.fields:
                for parity in self._field_order():
                    q = self._pick_q(2)
                    mbinfo, levels, ry, ru, rv = encode_p_math(
                        py[parity::2], pu[parity::2], pv[parity::2],
                        self._recon_f[parity], q, self.range, self.alt_scan)
                    self._emit(2, self._tref(idx), q,
                               self._set_fieldsel(mbinfo, parity), levels,
                               ps=parity + 1)
                    self._recon_f[parity] = (ry, ru, rv)
                continue
            q = self._pick_q(2)
            mbinfo, levels, ry, ru, rv = encode_p_math(
                py, pu, pv, self._recon, q, self.range, self.alt_scan,
                self.mpeg1)
            self._emit(2, self._tref(idx), q, mbinfo, levels)
            self._recon = (ry, ru, rv)
        self._pending = []
        if self.pass_mode == 1 and self.pass_log:
            with open(self.pass_log, "w") as f:
                for ptype, bits in self._pass_stats:
                    f.write(f"{ptype} {bits}\n")
        out = self._take() + b"\x00\x00\x01\xb7"
        return out
