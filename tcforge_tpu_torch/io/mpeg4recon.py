"""MPEG-4 part 2 (DivX/Xvid) VOP reconstruction in torch.

The port's counterpart of the JAX package's ``io/mpeg4jax.py``: the
host parse (``io/mpeg4plan.py`` ``Mpeg4PlanDecoder.parse_plans``, the
pinned ``io/mpeg4dec.py`` with the port's own plan stores) records each
VOP's plan (its dequantized coefficient blocks, each 8x8 block's
forward and backward vectors, the chroma vectors it derived, the
macroblock masks, and for interlaced, quarter-sample and GMC VOLs each
macroblock's dct_type, prediction form and field vectors, and an
S-VOP's warp record), and this module rebuilds the planes from it on
the device.

- ``stage_plan`` packs a plan into one int16 record a macroblock
  (``REC`` values: the six blocks' coefficients, the vectors, the
  masks, dct_type, the form and the field records), so that a batch of
  VOPs goes up to the card in one copy.
- ``Anchors`` keeps the decode order's two anchors (by any handle) and
  gives display order with the one-anchor lag of the JAX ``_make_step``
  (``mpeg4jax.py:193-211``): a B-VOP displays at once and predicts from
  both anchors, a P-VOP from the newer, an anchor displays the anchor
  before it, the first anchor displays nothing, and ``flush`` gives the
  last anchor at the end of the stream (``run_plans``,
  ``decode_stream_jax``); a short-header picture displays at once
  (``decode_frames``' ``decode_short``), and ``flush`` adds nothing
  after it.
- ``reconstruct`` runs one VOP in one launch (``mpeg4_idct_intra`` for
  an I-VOP; for a P or B VOP ``mpeg4_recon_field`` in an interlaced
  VOL, ``mpeg4_recon_qpel`` in a quarter-sample one, else
  ``mpeg4_recon``; ``ops/kernels.py``) from the anchors' planes,
  carried on the device; an S-VOP in two, which the wrapper makes from
  the VOP's warp record: ``mpeg4_gmc_warp`` of the forward anchor, then
  the VOP's reconstruction, whose ``FORM_GMC`` macroblocks take the
  warped planes.
- ``crop`` cuts a coded (macroblock-aligned) frame to the VOL's size.

The plain versions the wrappers run on the CPU: ``xvid_idct_ref`` (the
XVID integer IDCT in int64, as the numpy ``_xvid_idct`` computes it:
the JAX device form's int32 column pass wraps where
``_SQRT2 * (d +- c)`` passes 2**31, and the JAX CLI decodes through
numpy), ``mpeg4_recon_ref`` (per 8x8 block half-pel MC in gather form
with each sample coordinate clamped on its own to the coded plane, as
the numpy decoder's edge-padded planes give at any vector length, the
bidirectional average ``(f + b + 1) >> 1`` and the clip, as
``_recon_vop_math``), ``mpeg4_recon_qpel_ref`` (``_mc_block_qpel``: the
8-tap filter over each filter block's (s+1)x(s+1) window, mirrored at
the block's edges, horizontal stage first) and ``mpeg4_recon_field_ref``
(``_field_pred_mb``: half-pel field MC whose rows clamp in frame space,
``_field_pad``'s row ``2j + k`` of field k).  Each stores the residual
by dct_type (``_luma_store``).  ``mpeg4_gmc_warp_ref`` is
``_gmc_warp_planes``: each sample's coordinate from the warp record in
64 bits (floor shifts; chroma's own offsets and its ``(d >> 1) | (d &
1)`` translation at S = 2), the bilinear blend of the four samples
around it, each coordinate clamped on its own to the coded plane (what
``_gmc_bilin``'s edge padding and clips give), rounded with ``S*S/2 -
rounding`` and clipped.  Not ported: the GOP scan
(``_recon_gop_core``) and the shift-select MC, which exist for the
TPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.io import mpeg4dec as M
from tcforge_tpu_torch.io.mpeg4plan import (FORM_FIELD, FORM_GMC,
                                            FORM_HALF, FORM_QPEL8,
                                            FORM_QPEL16, W_DXX, W_DXY,
                                            W_DYX, W_DYY, W_N, W_OCX, W_OCY,
                                            W_OX, W_OY, W_RND, W_S, W_SH,
                                            W_TX, W_TY)

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# one macroblock's record, int16: the six 8x8 blocks' coefficients
# (Y0 Y1 Y2 Y3 Cb Cr, raster within a block), the four luma blocks'
# forward and backward vectors (x, y; half-pel or quarter-sample as
# the VOL codes them), the forward and backward chroma vectors, use_f,
# use_b, dct_type, the prediction form (io/mpeg4plan.py FORM_*), a
# field macroblock's reference fields (forward field 0 and 1, backward
# field 0 and 1), its half-pel field vectors and their chroma vectors
# (x, y in the same order), and four values of padding
REC = 432
COEF, FMV, BMV, FCMV, BCMV, USE_F, USE_B = 0, 384, 392, 400, 402, 404, 405
DCT, FORM, FSEL, FLDMV, FLDCMV = 406, 407, 408, 412, 420


def stage_plan(plan: dict, out: Optional[np.ndarray] = None) -> np.ndarray:
    """A plan's (nmb, ``REC``) int16 records, written into ``out`` when
    given (a slot of a pinned host buffer).  A plan of the pinned
    decoder, which has no dct_type, form or field records, stages them
    as 0.  An S-VOP's warp record (``plan["warp"]``, int64) is not
    staged: it stays on the host and goes to ``mpeg4_gmc_warp`` as its
    launch's arguments (``reconstruct``)."""
    nmb = plan["mbw"] * plan["mbh"]
    if out is None:
        out = np.empty((nmb, REC), np.int16)
    out[:, COEF:FMV] = plan["blocks"].reshape(nmb, 384)
    out[:, FMV:BMV] = plan["mvs4"].reshape(nmb, 8)
    out[:, BMV:FCMV] = plan["bmvs4"].reshape(nmb, 8)
    out[:, FCMV:BCMV] = plan["cmv"]
    out[:, BCMV:USE_F] = plan["bcmv"]
    out[:, USE_F] = plan["use_f"]
    out[:, USE_B] = plan["use_b"]
    if "form" in plan:
        out[:, DCT] = plan["dct_type"]
        out[:, FORM] = plan["form"]
        out[:, FSEL:FLDMV] = plan["fsel"].reshape(nmb, 4)
        out[:, FLDMV:FLDCMV] = plan["fmv"].reshape(nmb, 8)
        out[:, FLDCMV:FLDCMV + 8] = plan["fcmv"].reshape(nmb, 8)
        out[:, FLDCMV + 8:] = 0
    else:
        out[:, USE_B + 1:] = 0
    return out


def _i16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def xvid_idct_ref(blocks: torch.Tensor) -> torch.Tensor:
    """(n, 8, 8) integer coefficients -> (n, 8, 8) int64 samples in the
    int16 range: ``mpeg4dec._xvid_idct`` in torch, every product and sum
    in 64 bits."""
    b = blocks.to(torch.int64)
    rows = torch.empty_like(b)
    for r in range(8):
        c1, c2, c3, c4, c5, c6, c7 = M._ROW_TABS[r]
        rnd = M._ROW_RND[r]
        x = [b[:, r, i] for i in range(8)]
        a0 = c4 * x[0] + c2 * x[2] + c4 * x[4] + c6 * x[6] + rnd
        a1 = c4 * x[0] + c6 * x[2] - c4 * x[4] - c2 * x[6] + rnd
        a2 = c4 * x[0] - c6 * x[2] - c4 * x[4] + c2 * x[6] + rnd
        a3 = c4 * x[0] - c2 * x[2] + c4 * x[4] - c6 * x[6] + rnd
        b0 = c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7]
        b1 = c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7]
        b2 = c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7]
        b3 = c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7]
        for i, v in enumerate((a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                               a3 - b3, a2 - b2, a1 - b1, a0 - b0)):
            rows[:, r, i] = _i16(v >> 11)
    x = [rows[:, i, :] for i in range(8)]
    t17a = ((M._TAN1 * x[7]) >> 16) + x[1]
    t17b = ((M._TAN1 * x[1]) >> 16) - x[7]
    t35a = ((M._TAN3 * x[5]) >> 16) + x[3]
    t35b = ((M._TAN3 * x[3]) >> 16) - x[5]
    b0 = t17a + t35a
    d = t17a - t35a
    c = t17b + t35b
    e0 = 2 * ((M._SQRT2 * (d + c)) >> 16)
    e1 = 2 * ((M._SQRT2 * (d - c)) >> 16)
    t26a = ((M._TAN2 * x[6]) >> 16) + x[2]
    t26b = ((M._TAN2 * x[2]) >> 16) - x[6]
    s04 = x[0] + x[4]
    d04 = x[0] - x[4]
    a0 = s04 + t26a
    a1 = s04 - t26a
    a2 = d04 + t26b
    a3 = d04 - t26b
    return torch.stack([_i16(v >> 6) for v in (
        a0 + b0, a2 + e0, a3 + e1, a1 - t35b + t17b, a1 + t35b - t17b,
        a3 - e1, a2 - e0, a0 - b0)], dim=1)


def _from_mbs(mbs: torch.Tensor, mbw: int) -> torch.Tensor:
    """(nmb, px, px) macroblocks -> the (px*mbh, px*mbw) plane."""
    nmb, px = mbs.shape[0], mbs.shape[1]
    mbh = nmb // mbw
    return mbs.reshape(mbh, mbw, px, px).permute(0, 2, 1, 3).reshape(
        px * mbh, px * mbw)


def _to_mbs(plane: torch.Tensor, px: int) -> torch.Tensor:
    h, w = plane.shape
    return plane.reshape(h // px, px, w // px, px).permute(0, 2, 1, 3) \
        .reshape(-1, px, px)


def _blocks_to_planes(res: torch.Tensor, mbw: int,
                      dct: Optional[torch.Tensor] = None) -> Planes:
    """(nmb, 6, 8, 8) -> the (16*mbh, 16*mbw) luma and two (8*mbh,
    8*mbw) chroma planes: luma blocks in quadrant order, or where
    ``dct`` (nmb,) is nonzero as field lines (``_luma_store``: blocks 0
    and 1 the even rows, 2 and 3 the odd)."""
    nmb = res.shape[0]
    q = res[:, :4].reshape(nmb, 2, 2, 8, 8)          # (mb, kr, kc, r, c)
    y = q.permute(0, 1, 3, 2, 4).reshape(nmb, 16, 16)
    if dct is not None:
        fld = q.permute(0, 3, 1, 2, 4).reshape(nmb, 16, 16)
        y = torch.where((dct != 0).view(nmb, 1, 1), fld, y)
    return (_from_mbs(y, mbw), _from_mbs(res[:, 4], mbw),
            _from_mbs(res[:, 5], mbw))


def _residuals(vop: torch.Tensor, mbw: int) -> Planes:
    nmb = vop.shape[0]
    res = xvid_idct_ref(vop[:, COEF:FMV].reshape(nmb * 6, 8, 8))
    return _blocks_to_planes(res.reshape(nmb, 6, 8, 8), mbw, vop[:, DCT])


def _check_vop(vop: torch.Tensor, mbw: int) -> int:
    if vop.dtype != torch.int16 or vop.dim() != 2 or vop.shape[1] != REC:
        raise ValueError(f"vop: expected int16 (nmb, {REC}) records, got "
                         f"{vop.dtype} {tuple(vop.shape)}")
    if mbw <= 0 or vop.shape[0] % mbw:
        raise ValueError(f"vop: {vop.shape[0]} macroblocks are not rows "
                         f"of {mbw}")
    return vop.shape[0] // mbw


def mpeg4_idct_intra_ref(vop: torch.Tensor, mbw: int) -> Planes:
    """Plain version of ``mpeg4_idct_intra``: an I-VOP's planes, the
    IDCT of every block clipped to uint8 and stored by dct_type."""
    _check_vop(vop, mbw)
    return tuple(p.clamp(0, 255).to(torch.uint8)
                 for p in _residuals(vop, mbw))


def _halfpel(ref: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
             mvx: torch.Tensor, mvy: torch.Tensor, rnd: int,
             sel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half-pel samples at rows ``gy`` and columns ``gx`` (broadcast)
    moved by ``(mvx, mvy)``: two taps ``(a + b + 1 - rnd) >> 1``, four
    taps ``(a + b + c + d + 2 - rnd) >> 2``, each sample's row and column
    clamped on its own to the plane.  With ``sel`` the rows are rows of
    field ``sel``: field row j is frame row ``2j + sel``, clamped in frame
    space (``_field_pad``)."""
    h, w = ref.shape
    mvx, mvy = mvx.to(torch.int64), mvy.to(torch.int64)
    x0, y0 = gx + (mvx >> 1), gy + (mvy >> 1)
    hx, hy = (mvx & 1) != 0, (mvy & 1) != 0
    ya, yb = (y0, y0 + 1) if sel is None else (2 * y0 + sel,
                                               2 * (y0 + 1) + sel)
    r = ref.to(torch.int64)
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = ya.clamp(0, h - 1), yb.clamp(0, h - 1)
    p00, p01 = r[ya, xa], r[ya, xb]
    p10, p11 = r[yb, xa], r[yb, xb]
    return torch.where(
        hx & hy, (p00 + p01 + p10 + p11 + 2 - rnd) >> 2,
        torch.where(hx, (p00 + p01 + 1 - rnd) >> 1,
                    torch.where(hy, (p00 + p10 + 1 - rnd) >> 1, p00)))


def _grid(h: int, w: int, dev):
    return (torch.arange(h, device=dev).view(h, 1),
            torch.arange(w, device=dev).view(1, w))


def _mc_plane(ref: torch.Tensor, mvx: torch.Tensor, mvy: torch.Tensor,
              rnd: int) -> torch.Tensor:
    """Half-pel prediction of a whole plane from per-pixel vectors
    (``Mpeg4Decoder._mc_block``)."""
    gy, gx = _grid(*ref.shape, ref.device)
    return _halfpel(ref, gy, gx, mvx, mvy, rnd)


_QPEL_TAPS = [int(t) for t in M._QPEL_TAPS]


def _qpel_lowpass(win: torch.Tensor, s: int, rnd: int, dim: int
                  ) -> torch.Tensor:
    """The 8-tap half-sample filter along ``dim`` of windows s+1 long
    there, mirrored at the window's edges (``_qpel_idx``), clipped:
    ``clip((v + 16 - rnd) >> 5, 0, 255)``, s long there."""
    idx = torch.from_numpy(M._qpel_idx(s).astype(np.int64)).to(win.device)
    v = 0
    for t, tap in enumerate(_QPEL_TAPS):
        v = v + tap * win.index_select(dim, idx[:, t])
    return ((v + 16 - rnd) >> 5).clamp(0, 255)


def qpel_blocks(ref: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                mvx: torch.Tensor, mvy: torch.Tensor, s: int, rnd: int
                ) -> torch.Tensor:
    """Quarter-sample predictions of s x s blocks at ``(oy, ox)`` (n,)
    with vectors ``(mvx, mvy)`` (n,): ``_mc_block_qpel`` over the numpy
    decoder's edge-padded reference, each window coordinate clamped on
    its own to the plane.  Returns (n, s, s) int64."""
    h, w = ref.shape
    n = oy.shape[0]
    mvx, mvy = mvx.to(torch.int64), mvy.to(torch.int64)
    k = torch.arange(s + 1, device=ref.device)
    ys = (oy.view(n, 1) + (mvy >> 2).view(n, 1) + k).clamp(0, h - 1)
    xs = (ox.view(n, 1) + (mvx >> 2).view(n, 1) + k).clamp(0, w - 1)
    blk = ref.to(torch.int64)[ys[:, :, None], xs[:, None, :]]
    hx, hy = (mvx & 3).view(n, 1, 1), (mvy & 3).view(n, 1, 1)
    hh = _qpel_lowpass(blk, s, rnd, 2)                   # (n, s+1, s)
    a, b = blk[:, :, :s], blk[:, :, 1:]
    col = torch.where(hx == 0, a, torch.where(
        hx == 2, hh, torch.where(hx == 1, (a + hh + 1 - rnd) >> 1,
                                 (b + hh + 1 - rnd) >> 1)))
    hv = _qpel_lowpass(col, s, rnd, 1)                   # (n, s, s)
    a, b = col[:, :s], col[:, 1:]
    return torch.where(hy == 0, a, torch.where(
        hy == 2, hv, torch.where(hy == 1, (a + hv + 1 - rnd) >> 1,
                                 (b + hv + 1 - rnd) >> 1)))


def _luma_vectors(mvs: torch.Tensor, mbh: int, mbw: int):
    """(nmb, 8) vectors of the four luma blocks -> (x, y) per pixel."""
    v = mvs.reshape(mbh, mbw, 2, 2, 2).permute(0, 2, 1, 3, 4)
    v = v.reshape(2 * mbh, 2 * mbw, 2)
    v = v.repeat_interleave(8, 0).repeat_interleave(8, 1)
    return v[..., 0], v[..., 1]


def _chroma_vectors(cmv: torch.Tensor, mbh: int, mbw: int):
    v = cmv.reshape(mbh, mbw, 2).repeat_interleave(8, 0) \
        .repeat_interleave(8, 1)
    return v[..., 0], v[..., 1]


def _mb_mask(mask: torch.Tensor, mbh: int, mbw: int, px: int):
    return (mask.reshape(mbh, mbw) != 0).repeat_interleave(px, 0) \
        .repeat_interleave(px, 1)


def _qpel_luma(ref: torch.Tensor, vec: torch.Tensor, form: torch.Tensor,
               pred: torch.Tensor, mbw: int, rnd: int) -> torch.Tensor:
    """``pred`` (nmb, 16, 16) with its quarter-sample macroblocks
    replaced: ``FORM_QPEL16`` ones filtered as one 16x16 block with
    block 0's vector, ``FORM_QPEL8`` ones as four 8x8 blocks."""
    pred = pred.clone()
    dev = ref.device
    for f, s in ((FORM_QPEL16, 16), (FORM_QPEL8, 8)):
        mb = (form == f).nonzero().flatten()
        if mb.numel() == 0:
            continue
        nb = 16 // s
        k = torch.arange(nb * nb, device=dev)
        oy = ((mb // mbw) * 16).view(-1, 1) + s * (k // nb)
        ox = ((mb % mbw) * 16).view(-1, 1) + s * (k % nb)
        v = vec[mb].view(-1, 4, 2)[:, :nb * nb].to(torch.int64)
        blocks = qpel_blocks(ref, oy.flatten(), ox.flatten(),
                             v[..., 0].flatten(), v[..., 1].flatten(), s,
                             rnd)
        pred[mb] = blocks.view(-1, nb, nb, s, s).permute(
            0, 1, 3, 2, 4).reshape(-1, 16, 16)
    return pred


def _field_plane(ref: torch.Tensor, vop: torch.Tensor, d: int, lo: int,
                 mbw: int, px: int, rnd: int) -> torch.Tensor:
    """``_field_pred_mb``'s plane for direction ``d``: row r of a
    macroblock from field ``r & 1``'s vector (the record at ``lo``: the
    luma or the chroma field vectors) in the selected reference field,
    at field row ``y >> 1`` of its plane row y."""
    h, w = ref.shape
    gy, gx = _grid(h, w, ref.device)
    mb = (gy // px) * mbw + gx // px
    i = (gy & 1).expand(h, w)
    vec = vop[:, lo + 4 * d:lo + 4 * d + 4].to(torch.int64).view(-1, 2, 2)
    sel = vop[:, FSEL + 2 * d:FSEL + 2 * d + 2].to(torch.int64)
    return _halfpel(ref, gy >> 1, gx, vec[mb, i, 0], vec[mb, i, 1], rnd,
                    sel[mb, i])


def _gmc_coords(warp, h: int, w: int, chroma: bool, dev):
    """``_gmc_warp_planes``' sample coordinates (x, y) at S precision,
    int64 (h, w), of a plane of the warp record ``warp``."""
    S, n = int(warp[W_S]), int(warp[W_N])
    i = torch.arange(w, dtype=torch.int64, device=dev).view(1, w)
    j = torch.arange(h, dtype=torch.int64, device=dev).view(h, 1)
    if n == 1:
        dx, dy = int(warp[W_TX]), int(warp[W_TY])
        if not chroma:
            ox, oy = dx * (S // 2), dy * (S // 2)
        elif S == 2:
            ox, oy = (dx >> 1) | (dx & 1), (dy >> 1) | (dy & 1)
        else:
            ox, oy = dx * (S // 4), dy * (S // 4)
        return (i * S + ox).expand(h, w), (j * S + oy).expand(h, w)
    dxx, dxy, dyx, dyy = (int(warp[k]) for k in (W_DXX, W_DXY, W_DYX,
                                                 W_DYY))
    sh = int(warp[W_SH])
    if not chroma:
        return ((int(warp[W_OX]) + dxx * i + dxy * j) >> sh,
                (int(warp[W_OY]) + dyx * i + dyy * j) >> sh)
    return ((int(warp[W_OCX]) + 4 * (dxx * i + dxy * j)) >> (sh + 2),
            (int(warp[W_OCY]) + 4 * (dyx * i + dyy * j)) >> (sh + 2))


def mpeg4_gmc_warp_ref(ref: Planes, warp) -> Planes:
    """Plain version of ``mpeg4_gmc_warp``: the three coded-grid planes
    of ``ref`` warped by the record ``warp`` (io/mpeg4plan.py
    ``warp_record``), as ``_gmc_warp_planes`` and ``_gmc_bilin``:
    ``(S-fx)(S-fy)a + fx(S-fy)b + (S-fx)fy c + fx fy d + S*S/2 -
    rounding``, shifted by ``2*bit_length(S) - 2`` and clipped, the
    integer part of each coordinate a floor and each of the four
    samples' coordinates clamped on its own to the plane."""
    S, rnd = int(warp[W_S]), int(warp[W_RND])
    lg = S.bit_length() - 1
    R, sh2 = S * S // 2 - rnd, 2 * S.bit_length() - 2
    out = []
    for p, plane in enumerate(ref):
        h, w = plane.shape
        vx, vy = _gmc_coords(warp, h, w, p > 0, plane.device)
        x0, y0 = vx >> lg, vy >> lg
        fx, fy = vx & (S - 1), vy & (S - 1)
        xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
        ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
        r = plane.to(torch.int64)
        v = ((S - fx) * (S - fy) * r[ya, xa] + fx * (S - fy) * r[ya, xb]
             + (S - fx) * fy * r[yb, xa] + fx * fy * r[yb, xb] + R) >> sh2
        out.append(v.clamp(0, 255).to(torch.uint8))
    return tuple(out)


def _recon_ref(vop: torch.Tensor, mbw: int, rounding: int,
               fwd: Optional[Planes], bwd: Optional[Planes],
               forms: Tuple[int, ...], gmc: Optional[Planes] = None
               ) -> Planes:
    """A P or B VOP's planes from its records with the prediction forms
    ``forms`` (any other form but ``FORM_GMC`` is predicted as
    ``FORM_HALF``); a ``FORM_GMC`` macroblock's forward prediction is the
    warped planes ``gmc`` at its own place, and records that hold one
    without them raise."""
    mbh = _check_vop(vop, mbw)
    form = vop[:, FORM].to(torch.int64)
    if gmc is None and bool((form == FORM_GMC).any()):
        raise ValueError("FORM_GMC macroblocks without the S-VOP's warped "
                         "planes")
    res = _residuals(vop, mbw)
    use_f, use_b = vop[:, USE_F], vop[:, USE_B]
    out = []
    for p in range(3):
        px = 16 if p == 0 else 8
        uf = _mb_mask(use_f, mbh, mbw, px)
        ub = _mb_mask(use_b, mbh, mbw, px)
        preds = []
        for d, (ref, lo, hi, rnd) in enumerate(((fwd, FMV, FCMV, rounding),
                                                (bwd, BMV, BCMV, 0))):
            if ref is None:
                preds.append(torch.zeros_like(res[p]))
                continue
            if p == 0:
                mvx, mvy = _luma_vectors(vop[:, lo:lo + 8], mbh, mbw)
            else:
                mvx, mvy = _chroma_vectors(vop[:, hi:hi + 2], mbh, mbw)
            pred = _mc_plane(ref[p], mvx, mvy, rnd)
            if p == 0 and FORM_QPEL16 in forms:
                pred = _from_mbs(_qpel_luma(ref[0], vop[:, lo:lo + 8], form,
                                            _to_mbs(pred, 16), mbw, rnd), mbw)
            if FORM_FIELD in forms:
                fld = _field_plane(ref[p], vop, d,
                                   FLDMV if p == 0 else FLDCMV, mbw, px, rnd)
                pred = torch.where(_mb_mask(form == FORM_FIELD, mbh, mbw, px),
                                   fld, pred)
            if d == 0 and gmc is not None:
                pred = torch.where(_mb_mask(form == FORM_GMC, mbh, mbw, px),
                                   gmc[p].to(torch.int64), pred)
            preds.append(pred)
        f, b = preds
        pred = torch.where(uf & ub, (f + b + 1) >> 1,
                           torch.where(uf, f, torch.where(
                               ub, b, torch.zeros_like(f))))
        out.append((pred + res[p]).clamp(0, 255).to(torch.uint8))
    return tuple(out)


def mpeg4_recon_ref(vop: torch.Tensor, mbw: int, rounding: int,
                    fwd: Optional[Planes], bwd: Optional[Planes],
                    gmc: Optional[Planes] = None) -> Planes:
    """Plain version of ``mpeg4_recon``: a P or B VOP's planes from its
    records and the two anchors on the coded grid (``_recon_vop_math``
    with gather MC): the forward prediction with ``rounding`` (a
    P-VOP's rounding type; a B-VOP's is 0), the backward with 0, their
    average where a macroblock uses both, 0 where it uses neither (an
    intra macroblock), plus the IDCT stored by dct_type, clipped to
    uint8.  Every macroblock is predicted half-pel from its blocks'
    vectors, whatever its form, but a ``FORM_GMC`` one, whose forward
    prediction is the warped planes ``gmc`` (an S-VOP's,
    ``mpeg4_gmc_warp_ref``) at its place."""
    return _recon_ref(vop, mbw, rounding, fwd, bwd, (FORM_HALF,), gmc)


def mpeg4_recon_qpel_ref(vop: torch.Tensor, mbw: int, rounding: int,
                         fwd: Optional[Planes], bwd: Optional[Planes],
                         gmc: Optional[Planes] = None) -> Planes:
    """Plain version of ``mpeg4_recon_qpel``: ``mpeg4_recon_ref`` with the
    luma of ``FORM_QPEL16`` and ``FORM_QPEL8`` macroblocks predicted by
    ``qpel_blocks`` from their quarter-sample vectors (the chroma stays
    half-pel, from the recorded chroma vectors)."""
    return _recon_ref(vop, mbw, rounding, fwd, bwd,
                      (FORM_HALF, FORM_QPEL16, FORM_QPEL8), gmc)


def mpeg4_recon_field_ref(vop: torch.Tensor, mbw: int, rounding: int,
                          fwd: Optional[Planes], bwd: Optional[Planes],
                          gmc: Optional[Planes] = None) -> Planes:
    """Plain version of ``mpeg4_recon_field``: ``mpeg4_recon_qpel_ref``
    with ``FORM_FIELD`` macroblocks predicted field by field
    (``_field_pred_mb``: each field's half-pel vector in its reference
    field, its rows clamped in frame space; the chroma from the
    recorded per-field chroma vectors)."""
    return _recon_ref(vop, mbw, rounding, fwd, bwd,
                      (FORM_HALF, FORM_QPEL16, FORM_QPEL8, FORM_FIELD), gmc)


class Anchors:
    """The two anchors of the decode order, by handle: ``fwd`` the
    older, ``bwd`` the newer; ``pending`` the anchor not yet displayed."""

    def __init__(self):
        self.fwd = self.bwd = self.pending = None

    def add(self, kind: str, handle, at_once: bool = False):
        """A VOP of ``kind`` decoded as ``handle``: the handles it
        predicts from (forward, backward; None for none) and the handle
        it displays (None for the stream's first anchor).  An anchor
        ``at_once`` (a short-header picture) displays itself and leaves
        the pending anchor pending, as ``decode_short`` leaves the numpy
        decoder's."""
        if kind == "B":
            return self.fwd, self.bwd, handle
        refs = (self.bwd if kind == "P" else None), None
        self.fwd, self.bwd = self.bwd, handle
        if at_once:
            return refs + (handle,)
        shown, self.pending = self.pending, handle
        return refs + (shown,)

    def flush(self):
        """The pending anchor's handle at the end of the stream, once."""
        shown, self.pending = self.pending, None
        return shown


def route(plan: dict) -> str:
    """The reconstruction wrapper of a plan's P or B VOP, by its VOL:
    ``mpeg4_recon_field`` for an interlaced one, ``mpeg4_recon_qpel`` for
    a quarter-sample one, else ``mpeg4_recon``."""
    if plan.get("interlaced"):
        return "mpeg4_recon_field"
    return "mpeg4_recon_qpel" if plan.get("qpel") else "mpeg4_recon"


def reconstruct(vop: torch.Tensor, kind: str, rounding: int, mbw: int,
                fwd: Optional[Planes], bwd: Optional[Planes],
                wrapper: str = "mpeg4_recon", warp=None) -> Planes:
    """One VOP's coded-grid planes, one launch: the IDCT alone for an
    I-VOP, else ``wrapper`` (``route``'s choice) predicting from ``fwd``
    and ``bwd`` (a B-VOP's rounding is 0) with the IDCT.  An S-VOP (a P
    plan with a ``warp`` record) takes two, both made by ``wrapper``:
    ``mpeg4_gmc_warp`` of ``fwd``, then the reconstruction."""
    from tcforge_tpu_torch.ops import kernels
    if kind == "I":
        return kernels.mpeg4_idct_intra(vop, mbw)
    args = (vop, mbw, rounding if kind == "P" else 0, fwd, bwd)
    if warp is None:
        return getattr(kernels, wrapper)(*args)
    return getattr(kernels, wrapper)(*args, warp=warp)


def crop(frame: Planes, width: int, height: int) -> Planes:
    """A coded frame cut to the VOL's size (``_crop_planes``)."""
    y, u, v = frame
    ch, cw = (height + 1) // 2, (width + 1) // 2
    return y[:height, :width], u[:ch, :cw], v[:ch, :cw]


def decode_plans(plans: List[dict], device, width: int, height: int
                 ) -> List[Planes]:
    """Every display frame of decode-order ``plans`` (a whole stream),
    cropped to ``width`` x ``height``: each VOP one launch, the last
    anchor flushed (``decode_stream_jax``)."""
    anchors, frames, shown = Anchors(), {}, []
    for h, plan in enumerate(plans):
        vop = torch.from_numpy(stage_plan(plan)).to(device)
        fh, bh, show = anchors.add(plan["kind"], h, bool(plan.get("short")))
        frames[h] = reconstruct(vop, plan["kind"], int(plan["rounding"]),
                                plan["mbw"], frames.get(fh), frames.get(bh),
                                route(plan), plan.get("warp"))
        shown.append(show)
    shown.append(anchors.flush())
    return [crop(frames[h], width, height) for h in shown if h is not None]
