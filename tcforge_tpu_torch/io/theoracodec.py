"""Theora both ways: the token coder on the host, the pixels on the device.

The JAX package's decoder (``tcforge_tpu/io/theora.py``) and encoder
(``tcforge_tpu/io/theoraenc.py``) are numpy and Python.  The port keeps
their parse, tables and syntax writers (the pinned ``io/theora.py`` and
``io/theoraenc.py``) and splits the rest:

- decode: the host parses a packet up to its tokens (flags, modes,
  motion vectors, block qi: the pinned methods), decodes the tokens and
  predicts the DCs in C++ (``csrc/theora_host.cpp``: ``_decode_tokens``
  with ``TCFORGE_NATIVE_THEORA_TOKENS=0`` and ``_predict_dc``); the device
  runs ``theora_recon`` (``_reconstruct``: dequantization, the integer
  IDCT, intra or half-pel motion compensation from ``last`` or
  ``golden``, the copy of uncoded blocks) and ``theora_loop_filter``
  (``_loop_filter``) on the planes it keeps between frames;
- encode: the device prepares the coded planes, decides the modes
  (``theora_me``: ``_choose_modes`` with ``_search_mv``), forms the
  residuals and quantizes them (``theora_fdct_quant``: ``_fdct_blocks``
  in numpy's einsum order with ``_quantize_blocks``); the host writes the
  flags, modes and vectors (the pinned writers) and, in C++, the DC
  residuals and the tokens (``_dc_residuals``, ``_token_events``,
  ``_write_tokens``); the device reconstructs the frame from the records
  it just wrote with the decoder's two kernels, which equals decoding the
  packet (the JAX encoder decodes it).

A macroblock record (``MB_COLS`` int32, the macroblocks in raster order of
the coded frame) is its mode (-1 where none is coded) and four (x, y)
vectors in half-pels: a FOURMV macroblock's one a luma block (raster
order in the macroblock), any other's in the first.  The plain versions
of the four kernels are here (``recon_ref``, ``loop_filter_ref``,
``fdct_quant_ref``, ``me_ref``); ``ops/kernels.py`` holds the wrappers.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.io import theora as th
from tcforge_tpu_torch.io import theoraenc as the
from tcforge_tpu_torch.ops import _build

MB_COLS = 9
ME_COLS = 7              # theora_me's record: mode, mvx, mvy, 4 coded flags
MV_RANGE = 31            # half-pel vectors lie in -31..31
MV_SPAN = 2 * MV_RANGE + 1
ZIGZAG = np.array(th.ZIGZAG, np.int64)
# the token alphabet's largest level (token 22: 69 + 9 extra bits)
LEVEL_MAX = 580


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The host coder ``csrc/theora_host.cpp``, built at first use."""
    lib = _build.load_host("theora_host")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tc_th_huff_new.argtypes = (p, p, p, p)
    lib.tc_th_huff_new.restype = p
    lib.tc_th_huff_free.argtypes = (p,)
    lib.tc_th_huff_free.restype = None
    lib.tc_th_tokens.argtypes = (p, p, ll, ll, p, p, i, p)
    lib.tc_th_tokens.restype = ll
    lib.tc_th_predict_dc.argtypes = (p, p, p, p, p, p)
    lib.tc_th_predict_dc.restype = None
    lib.tc_th_dc_residuals.argtypes = (p, p, p, p, p, p, p, p)
    lib.tc_th_dc_residuals.restype = None
    lib.tc_th_write_tokens.argtypes = (p, p, i, p, p, p, ll, ctypes.c_uint64,
                                       i, p, ll)
    lib.tc_th_write_tokens.restype = ll
    return lib


class HuffTables:
    """The setup header's 80 Huffman tables in the host coder, each
    checked: at most 32 leaves (the token alphabet), a complete prefix
    code no deeper than 32 bits; any other raises ``ValueError``."""

    def __init__(self, leaves: List[list]):
        self._lib = library()
        self._h = None
        if len(leaves) != 80:
            raise ValueError("theora: the setup header needs 80 Huffman "
                             "tables")
        counts = np.array([len(t) for t in leaves], np.int32)
        if counts.min() < 1 or counts.max() > 32:
            raise ValueError("theora: a Huffman table with more than 32 "
                             "leaves (the token alphabet)")
        flat = [leaf for t in leaves for leaf in t]
        codes = np.array([c for c, _, _ in flat], np.uint32)
        lens = np.array([n for _, n, _ in flat], np.uint8)
        toks = np.array([t for _, _, t in flat], np.uint8)
        h = self._lib.tc_th_huff_new(_ptr(codes), _ptr(lens), _ptr(toks),
                                     _ptr(counts))
        if not h:
            raise ValueError("theora: a Huffman table that is not a "
                             "complete prefix code of at most 32 tokens")
        self._h = h

    @property
    def handle(self) -> int:
        return self._h

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tc_th_huff_free(self._h)
            self._h = None


# --------------------------------------------------------------------- #
# geometry


def plane_dims(fmt: int, fw: int, fh: int) -> List[Tuple[int, int]]:
    """(height, width) of the three planes of a coded frame."""
    if fmt == 0:
        return [(fh, fw), (fh // 2, fw // 2), (fh // 2, fw // 2)]
    if fmt == 2:
        return [(fh, fw), (fh, fw // 2), (fh, fw // 2)]
    if fmt == 3:
        return [(fh, fw)] * 3
    raise ValueError(f"theora: pixel format {fmt}")


class GeoArrays:
    """A ``_Geometry``'s maps as arrays: per plane its blocks' offset and
    grid, each macroblock's (raster order) luma and chroma block ids,
    the raster index of each macroblock of ``mb_order``."""

    def __init__(self, geo: th._Geometry):
        self.fmt = geo.fmt
        self.plane_off = np.array(geo.plane_off, np.int32)
        self.bw = np.array(geo.bw, np.int32)
        self.bh = np.array(geo.bh, np.int32)
        self.total = geo.total_blocks
        self.mbw, self.mbh = geo.mbw, geo.mbh
        nmb = geo.mbw * geo.mbh
        self.order = np.array([mby * geo.mbw + mbx
                               for mbx, mby in geo.mb_order], np.int64)
        nch = len(geo.mb_chroma[geo.mb_order[0]])
        self.luma = np.zeros((nmb, 4), np.int64)
        self.chroma = np.zeros((nmb, nch), np.int64)
        for mb, r in zip(geo.mb_order, self.order):
            self.luma[r] = geo.mb_luma[mb]
            self.chroma[r] = geo.mb_chroma[mb]
        self.coded_order = geo.coded_order.astype(np.int32)
        self.chroma_block = (geo.block_pos[:, 0] != 0).astype(np.uint8)


# --------------------------------------------------------------------- #
# int32 arithmetic as numpy computes it (wrapping)


def _w32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_1d(x: torch.Tensor) -> torch.Tensor:
    """``_idct_1d`` over the last axis of an int64 tensor holding int32
    values, every step wrapped to int32."""
    def m(c, v):
        return _w32(c * v) >> 16
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    x4, x5, x6, x7 = x[..., 4], x[..., 5], x[..., 6], x[..., 7]
    a = _w32(m(th.xC1S7, x1) + m(th.xC7S1, x7))
    b = _w32(m(th.xC7S1, x1) - m(th.xC1S7, x7))
    c = _w32(m(th.xC3S5, x3) + m(th.xC5S3, x5))
    d = _w32(m(th.xC3S5, x5) - m(th.xC5S3, x3))
    ad = m(th.xC4S4, _w32(a - c))
    bd = m(th.xC4S4, _w32(b - d))
    cd = _w32(a + c)
    dd = _w32(b + d)
    e = m(th.xC4S4, _w32(x0 + x4))
    f = m(th.xC4S4, _w32(x0 - x4))
    g = _w32(m(th.xC2S6, x2) + m(th.xC6S2, x6))
    h = _w32(m(th.xC6S2, x2) - m(th.xC2S6, x6))
    ed, gd = _w32(e - g), _w32(e + g)
    add, bdd = _w32(f + ad), _w32(bd - h)
    fd, hd = _w32(f - ad), _w32(bd + h)
    return torch.stack([_w32(gd + cd), _w32(add + hd), _w32(add - hd),
                        _w32(ed + dd), _w32(ed - dd), _w32(fd + bdd),
                        _w32(fd - bdd), _w32(gd - cd)], dim=-1)


def idct_ref(deq: torch.Tensor) -> torch.Tensor:
    """``idct8x8`` on int64 (n, 8, 8) dequantized coefficients."""
    t = _idct_1d(deq)
    t = _idct_1d(t.transpose(1, 2)).transpose(1, 2)
    return _w32(t + 8) >> 4


def _rshift_round(a: torch.Tensor, b: int) -> torch.Tensor:
    half = 1 << (b - 1)
    return torch.where(a > 0, (a + half) >> b, -((-a + half) >> b))


def _halve(v: torch.Tensor) -> torch.Tensor:
    return (v >> 1) | (v & 1)


def block_motion(mbrec: torch.Tensor, fmt: int, p: int, bh: int, bw: int):
    """Each block's mode (NO_MV where its macroblock codes none) and (x,
    y) vector of plane ``p`` (a bh x bw grid), int64 (bh, bw) each: a
    FOURMV luma block's own, the chroma of FOURMV by the format's rule
    (``_rshift_round`` of the sum), chroma vectors halved on subsampled
    axes as ``(v >> 1) | (v & 1)``."""
    mbw = (bw // 2) if p == 0 or fmt == 3 else bw
    dev = mbrec.device
    by = torch.arange(bh, device=dev)[:, None]
    bx = torch.arange(bw, device=dev)[None, :]
    rec = mbrec.to(torch.int64)
    if p == 0 or fmt == 3:
        mb = (by // 2) * mbw + bx // 2
    elif fmt == 2:
        mb = (by // 2) * mbw + bx
    else:
        mb = by * mbw + bx
    r = rec[mb]                                    # (bh, bw, MB_COLS)
    mode = r[..., 0]
    mode = torch.where(mode < 0, torch.full_like(mode, th.MODE_NO_MV),
                       mode)
    four = mode == th.MODE_FOURMV
    mx, my = r[..., 1], r[..., 2]
    if p == 0 or fmt == 3:
        k = (by & 1) * 2 + (bx & 1)
        kx = torch.gather(r, 2, (1 + 2 * k).expand(bh, bw)[..., None])[..., 0]
        ky = torch.gather(r, 2, (2 + 2 * k).expand(bh, bw)[..., None])[..., 0]
        fx, fy = kx, ky
    elif fmt == 0:
        fx = _rshift_round(r[..., 1] + r[..., 3] + r[..., 5] + r[..., 7], 2)
        fy = _rshift_round(r[..., 2] + r[..., 4] + r[..., 6] + r[..., 8], 2)
    else:
        j = (by & 1).expand(bh, bw)
        sx = torch.where(j == 0, r[..., 1] + r[..., 3], r[..., 5] + r[..., 7])
        sy = torch.where(j == 0, r[..., 2] + r[..., 4], r[..., 6] + r[..., 8])
        fx, fy = _rshift_round(sx, 1), _rshift_round(sy, 1)
    mx = torch.where(four, fx, mx)
    my = torch.where(four, fy, my)
    if p > 0:
        if fmt in (0, 2):
            mx = _halve(mx)
        if fmt == 0:
            my = _halve(my)
    return mode, mx, my


def _blocks_of(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) to (bh * bw, 8, 8) in raster order of blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3) \
        .reshape(-1, 8, 8)


def _plane_of(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return blocks.reshape(h // 8, w // 8, 8, 8).permute(0, 2, 1, 3) \
        .reshape(h, w)


def mc_pred(ref: torch.Tensor, bh: int, bw: int, mx: torch.Tensor,
            my: torch.Tensor) -> torch.Tensor:
    """int64 (bh * bw, 8, 8): each block's half-pel prediction from the
    uint8 plane ``ref`` (the whole-pel part toward zero, the signed
    half-step remainder; the plane's edges repeated past it)."""
    h, w = ref.shape
    dev = ref.device
    wx = (mx + (mx < 0).to(mx.dtype)) >> 1
    wy = (my + (my < 0).to(my.dtype)) >> 1
    rx, ry = mx - 2 * wx, my - 2 * wy
    o = torch.arange(8, device=dev)
    by = torch.arange(bh, device=dev)[:, None, None, None]
    bx = torch.arange(bw, device=dev)[None, :, None, None]
    gy = 8 * by + wy[:, :, None, None] + o[None, None, :, None]
    gx = 8 * bx + wx[:, :, None, None] + o[None, None, None, :]
    refl = ref.to(torch.int64)

    def at(yy, xx):
        return refl[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
    pred = at(gy.expand(bh, bw, 8, 8), gx.expand(bh, bw, 8, 8))
    half = ((rx != 0) | (ry != 0))[:, :, None, None]
    pred2 = at((gy + ry[:, :, None, None]).expand(bh, bw, 8, 8),
               (gx + rx[:, :, None, None]).expand(bh, bw, 8, 8))
    pred = torch.where(half, (pred + pred2) >> 1, pred)
    return pred.reshape(-1, 8, 8)


# --------------------------------------------------------------------- #
# the plain versions of the four kernels


def recon_ref(coefs: torch.Tensor, coded: torch.Tensor, qiidx: torch.Tensor,
              mbrec: torch.Tensor, qmats: torch.Tensor, last, golden,
              fmt: int, fw: int, fh: int) -> Tuple[torch.Tensor, ...]:
    """``_reconstruct`` without the loop filter: the three uint8 planes
    of a frame from int32 (n, 64) zigzag coefficients (DCs predicted),
    uint8 (n,) coded flags and qi indexes, the int32 (mbs, MB_COLS)
    macroblock records and the int32 (2, 3, 3, 64) raster quantizer
    matrices [qti][plane][qi index]; ``last`` and ``golden`` the
    reference planes (None for an intra frame)."""
    intra = last is None
    dev = coefs.device
    zz = torch.from_numpy(ZIGZAG).to(dev)
    out = []
    off = 0
    for p, (h, w) in enumerate(plane_dims(fmt, fw, fh)):
        bh, bw = h // 8, w // 8
        n = bh * bw
        cz = coefs[off:off + n].to(torch.int64)
        cd = coded[off:off + n].bool()
        qi = qiidx[off:off + n].to(torch.int64).clamp(max=2)
        if intra:
            mode = torch.full((bh, bw), th.MODE_INTRA, dtype=torch.int64,
                              device=dev)
            mx = my = torch.zeros_like(mode)
        else:
            mode, mx, my = block_motion(mbrec, fmt, p, bh, bw)
        mode, mx, my = mode.reshape(-1), mx.reshape(bh, bw), my.reshape(bh, bw)
        qti = (mode != th.MODE_INTRA).to(torch.int64)
        qm = qmats.to(torch.int64)[qti, p, qi]            # (n, 64) raster
        deq = torch.zeros((n, 64), dtype=torch.int64, device=dev)
        deq[:, zz] = _w32(cz * qm[:, zz])
        deq[:, 0] = _w32(cz[:, 0] * qmats.to(torch.int64)[qti, p, 0, 0])
        resid = idct_ref(deq.reshape(n, 8, 8))
        block = _w32(resid + 128)
        if not intra:
            fc = torch.tensor(th.FRAME_CLASS, device=dev)[mode]
            pl = mc_pred(last[p], bh, bw, mx, my)
            pg = mc_pred(golden[p], bh, bw, mx, my)
            pred = torch.where((fc == 2)[:, None, None], pg, pl)
            block = torch.where((fc == 0)[:, None, None], block,
                                _w32(pred + resid))
        block = block.clamp(0, 255).to(torch.uint8)
        if not intra:
            block = torch.where(cd[:, None, None], block,
                                _blocks_of(last[p]))
        out.append(_plane_of(block, h, w).contiguous())
        off += n
    return tuple(out)


def _bound(f: torch.Tensor, lim: int) -> torch.Tensor:
    a = f.abs()
    return torch.sign(f) * torch.where(
        a < lim, a, torch.where(a < 2 * lim, 2 * lim - a,
                                torch.zeros_like(a)))


def loop_filter_ref(planes, coded: torch.Tensor, lim: int, fmt: int,
                    fw: int, fh: int) -> Tuple[torch.Tensor, ...]:
    """``_loop_filter`` on copies of the three uint8 planes: for each
    coded block in raster order its left and top edges, then its right
    and bottom edges where that neighbour is uncoded.  Done here by
    anti-diagonals (the blocks with ``bx + 2 * by == t``), which touch no
    common pixel and keep every pair of overlapping blocks in raster
    order, so the result is the raster walk's."""
    out = [p.clone() for p in planes]
    if lim <= 0:
        return tuple(out)
    dev = coded.device
    o = torch.arange(8, device=dev)
    off = 0
    for p, (h, w) in enumerate(plane_dims(fmt, fw, fh)):
        bh, bw = h // 8, w // 8
        cd = coded[off:off + bh * bw].bool().reshape(bh, bw)
        off += bh * bw
        pl = out[p].to(torch.int32)
        right_open = torch.zeros_like(cd)
        right_open[:, :-1] = ~cd[:, 1:]
        below_open = torch.zeros_like(cd)
        below_open[:-1, :] = ~cd[1:, :]
        rows = torch.arange(bh, device=dev)

        def filt_h(y0, x):          # vertical edges at columns x
            r = (y0[:, None] + o[None, :]).reshape(-1)
            xx = x[:, None].expand(-1, 8).reshape(-1)
            a, b = pl[r, xx - 2], pl[r, xx - 1]
            c, d = pl[r, xx], pl[r, xx + 1]
            big_r = _bound(((a - d) + 3 * (c - b) + 4) >> 3, lim)
            pl[r, xx - 1] = (b + big_r).clamp(0, 255)
            pl[r, xx] = (c - big_r).clamp(0, 255)

        def filt_v(y, x0):          # horizontal edges at rows y
            cc = (x0[:, None] + o[None, :]).reshape(-1)
            yy = y[:, None].expand(-1, 8).reshape(-1)
            a, b = pl[yy - 2, cc], pl[yy - 1, cc]
            c, d = pl[yy, cc], pl[yy + 1, cc]
            big_r = _bound(((a - d) + 3 * (c - b) + 4) >> 3, lim)
            pl[yy - 1, cc] = (b + big_r).clamp(0, 255)
            pl[yy, cc] = (c - big_r).clamp(0, 255)
        for t in range(bw + 2 * (bh - 1)):
            bx = t - 2 * rows
            ok = (bx >= 0) & (bx < bw)
            by_t, bx_t = rows[ok], bx[ok]
            live = cd[by_t, bx_t]
            by_t, bx_t = by_t[live], bx_t[live]
            if not len(by_t):
                continue
            m = bx_t > 0
            if m.any():
                filt_h(8 * by_t[m], 8 * bx_t[m])
            m = by_t > 0
            if m.any():
                filt_v(8 * by_t[m], 8 * bx_t[m])
            m = right_open[by_t, bx_t]
            if m.any():
                filt_h(8 * by_t[m], 8 * bx_t[m] + 8)
            m = below_open[by_t, bx_t]
            if m.any():
                filt_v(8 * by_t[m] + 8, 8 * bx_t[m])
        out[p] = pl.to(torch.uint8)
    return tuple(out)


@lru_cache(maxsize=None)
def basis() -> np.ndarray:
    """The encoder's forward DCT basis ``_B`` (float64 8 x 8)."""
    return np.ascontiguousarray(the._B)


def fdct_quant_ref(resid: torch.Tensor, group: torch.Tensor,
                   qmat: torch.Tensor) -> torch.Tensor:
    """``_quantize_blocks`` on int16 (n, 64) raster residual blocks: the
    float64 ``16 * einsum("kn,bnm,lm->bkl", B, R, B)`` summed as numpy's
    einsum sums it (for each output, n outer, m inner, each term
    ``(B[k, n] * R[n, m]) * B[l, m]`` added in turn from 0), divided by
    the group's quantizer (``group`` uint8 (n,) = qti * 3 + plane into
    the int32 (2, 3, 64) raster matrices), rounded half to even (qti 0)
    or with the inter dead zone ``sign * floor(|t| + 0.3)`` (qti 1),
    clipped to +-580.  Returns int32 (n, 64) in zigzag order."""
    dev = resid.device
    n = resid.shape[0]
    r = resid.to(torch.float64).reshape(n, 8, 8)
    b = torch.from_numpy(basis()).to(dev)
    # every term (B[k, n] * R[n, m]) * B[l, m], (n, m) flattened last
    terms = (b[None, :, None, :, None] * r[:, None, None, :, :]) \
        * b[None, None, :, None, :]
    terms = terms.reshape(n, 8, 8, 64)
    if dev.type == "cpu":
        # the CPU's cumulative sum adds the terms one after the other
        s = torch.cumsum(terms, dim=3)[..., 63]
    else:
        s = torch.zeros((n, 8, 8), dtype=torch.float64, device=dev)
        for j in range(64):
            s = s + terms[..., j]
    x = (16.0 * s).reshape(n, 64)
    g = group.to(torch.int64)
    q = qmat.reshape(6, 64).to(torch.float64)[g]
    t = x / q
    dead = torch.sign(t) * torch.floor(t.abs() + 0.3)
    lv = torch.where((g >= 3)[:, None], dead, torch.round(t))
    lv = lv.clamp(-LEVEL_MAX, LEVEL_MAX).to(torch.int64)
    return lv[:, torch.from_numpy(ZIGZAG).to(dev)].to(torch.int32)


def _mv_bits() -> np.ndarray:
    return np.array([the._MV_CODES[v][1] for v in range(-31, 32)],
                    np.int64)


class LazySad:
    """A macroblock's SAD against its half-pel prediction from the
    reference (the encoder's ``_mc_pred`` over the plane padded by 32
    repeated samples), computed on the host when the walk asks for it."""

    def __init__(self, src: torch.Tensor, ref: torch.Tensor):
        self.src = src.cpu().numpy().astype(np.int32)
        self.ref = np.pad(ref.cpu().numpy().astype(np.int32), 32,
                          mode="edge")
        self.mbw = self.src.shape[1] // 16
        self.memo: dict = {}

    def __call__(self, mb: int, mx: int, my: int) -> int:
        key = (mb, mx, my)
        got = self.memo.get(key)
        if got is None:
            mby, mbx = divmod(int(mb), self.mbw)
            y0, x0 = 16 * mby, 16 * mbx
            wx = (mx + (1 if mx < 0 else 0)) >> 1
            wy = (my + (1 if my < 0 else 0)) >> 1
            rx, ry = mx - 2 * wx, my - 2 * wy
            gy, gx = y0 + wy + 32, x0 + wx + 32
            pred = self.ref[gy:gy + 16, gx:gx + 16]
            if rx or ry:
                pred = (pred + self.ref[gy + ry:gy + ry + 16,
                                        gx + rx:gx + rx + 16]) >> 1
            got = int(np.abs(self.src[y0:y0 + 16, x0:x0 + 16] - pred).sum())
            self.memo[key] = got
        return got


class TableSad:
    """Every macroblock's SAD at every half-pel vector, computed at once
    on the tensors' device (one row of 63 vectors a step; the plain
    version's form on the card, where the lazy host form waits on the
    host), then looked up."""

    def __init__(self, src: torch.Tensor, ref: torch.Tensor):
        h, w = src.shape
        dev = src.device
        s = src.to(torch.int32)
        r = ref.to(torch.int32)
        ys = torch.arange(h, device=dev)
        xs = torch.arange(w, device=dev)
        mv = torch.arange(-MV_RANGE, MV_RANGE + 1, device=dev)
        whole = (mv + (mv < 0).to(mv.dtype)) >> 1
        half = mv - 2 * whole
        cols = (xs[None, :] + whole[:, None]).clamp(0, w - 1)
        cols2 = (xs[None, :] + whole[:, None] + half[:, None]).clamp(0, w - 1)
        rows = []
        for iy in range(MV_SPAN):
            wy, ry = int(whole[iy]), int(half[iy])
            top = r[(ys + wy).clamp(0, h - 1)]
            bot = r[(ys + wy + ry).clamp(0, h - 1)]
            a = top[:, cols]                            # (h, 63, w)
            b = bot[:, cols2]
            use = ((half != 0) | (ry != 0))[None, :, None]
            pred = torch.where(use, (a + b) >> 1, a)
            d = (s[:, None, :] - pred).abs()
            rows.append(d.reshape(h // 16, 16, MV_SPAN, w // 16, 16)
                     .sum(dim=(1, 4)).permute(0, 2, 1)
                     .reshape(-1, MV_SPAN))
        self.table = torch.stack(rows, dim=1).reshape(
            -1, MV_SPAN * MV_SPAN).cpu().numpy()

    def __call__(self, mb: int, mx: int, my: int) -> int:
        return int(self.table[mb, (my + MV_RANGE) * MV_SPAN + mx
                              + MV_RANGE])


def mb_stats_ref(src: torch.Tensor, ref: torch.Tensor):
    """Per macroblock: int64 (mbs, 4) SSE of ``src - ref`` of each 8x8
    luma block (raster in the macroblock) and int64 (mbs,) the SAD from
    the macroblock's mean (``int(src.mean())``)."""
    h, w = src.shape
    mbh, mbw = h // 16, w // 16
    s = src.to(torch.int64)
    d = s - ref.to(torch.int64)
    sse = (d * d).reshape(mbh, 2, 8, mbw, 2, 8).sum(dim=(2, 5)) \
        .permute(0, 2, 1, 3).reshape(-1, 4)
    blk = s.reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3).reshape(-1, 256)
    mean = blk.sum(dim=1) // 256
    sad_i = (blk - mean[:, None]).abs().sum(dim=1)
    return sse, sad_i


def choose_modes(sad, sse: np.ndarray, sad_i: np.ndarray,
                 order: np.ndarray, lam: float, sse_floor: float
                 ) -> np.ndarray:
    """``_choose_modes``' walk over the macroblocks in ``order``, with
    ``sad(mb, mx, my)`` a macroblock's SAD at a half-pel vector: int32
    (mbs, ME_COLS) records (mode, -1 where no luma block is coded; mvx,
    mvy; the four luma coded flags)."""
    bits = _mv_bits()
    out = np.zeros((len(sse), ME_COLS), np.int32)
    out[:, 0] = -1
    last = (0, 0)
    last2 = (0, 0)
    for mb in order:
        coded = [bool(sse[mb, k] > sse_floor) for k in range(4)]
        out[mb, 3:7] = coded
        if not any(coded):
            continue
        cand = [(sad(mb, 0, 0) + lam * 2, 0, th.MODE_NO_MV, (0, 0))]
        if last != (0, 0):
            cand.append((sad(mb, *last) + lam * 2, 1, th.MODE_LAST, last))
        if last2 != (0, 0) and last2 != last:
            cand.append((sad(mb, *last2) + lam * 3, 2, th.MODE_LAST2, last2))
        # _search_mv from the best of (0, 0) and the chain's vector
        best, best_sad = (0, 0), sad(mb, 0, 0)
        sx, sy = last[0] >> 1, last[1] >> 1
        if (sx, sy) != (0, 0) and abs(sx) <= 15 and abs(sy) <= 15:
            s = sad(mb, 2 * sx, 2 * sy)
            if s < best_sad:
                best, best_sad = (sx, sy), s
        for step in (8, 4, 2, 1):
            improved = True
            while improved:
                improved = False
                for dy in (-step, 0, step):
                    for dx in (-step, 0, step):
                        if dx == 0 and dy == 0:
                            continue
                        nx, ny = best[0] + dx, best[1] + dy
                        if abs(nx) > 15 or abs(ny) > 15:
                            continue
                        s = sad(mb, 2 * nx, 2 * ny)
                        if s < best_sad:
                            best, best_sad = (nx, ny), s
                            improved = True
        mv = (2 * best[0], 2 * best[1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                nx, ny = mv[0] + dx, mv[1] + dy
                if abs(nx) > 31 or abs(ny) > 31:
                    continue
                s = sad(mb, nx, ny)
                if s < best_sad:
                    mv, best_sad = (nx, ny), s
        if mv != (0, 0):
            mvbits = int(bits[mv[0] + 31] + bits[mv[1] + 31])
            cand.append((best_sad + lam * (4 + mvbits), 3, th.MODE_MV, mv))
        cand.append((int(sad_i[mb]) + lam * 6, 4, th.MODE_INTRA, (0, 0)))
        cand.sort()
        _, _, mode, mv = cand[0]
        out[mb, 0:3] = (mode, mv[0], mv[1])
        if mode == th.MODE_MV:
            last2 = last
            last = mv
        elif mode == th.MODE_LAST2:
            last, last2 = last2, last
    return out


def me_ref(src: torch.Tensor, ref: torch.Tensor, order: torch.Tensor,
           lam: float, sse_floor: float) -> torch.Tensor:
    """The plain version of ``theora_me``: the statistics on the device,
    the walk on the host, each SAD computed on the host when the walk
    asks for it (``LazySad``) or, on the card, every SAD at once
    (``TableSad``); int32 (mbs, ME_COLS) on ``src``'s device."""
    sse, sad_i = mb_stats_ref(src, ref)
    sad = LazySad(src, ref) if src.device.type == "cpu" \
        else TableSad(src, ref)
    rec = choose_modes(sad, sse.cpu().numpy(),
                       sad_i.cpu().numpy(), order.cpu().numpy(), lam,
                       sse_floor)
    return torch.from_numpy(rec).to(src.device)


# --------------------------------------------------------------------- #
# the decoder


@dataclass
class FrameRecords:
    """A frame's records for the device: ``intra``, the qis, uint8 (n,)
    coded flags and qi indexes, int32 (n, 64) zigzag coefficients with
    their DCs predicted, int32 (mbs, MB_COLS) macroblock records."""

    intra: bool
    qis: List[int]
    coded: np.ndarray
    qiidx: np.ndarray
    coefs: np.ndarray
    mbrec: np.ndarray


class TheoraDeviceDecoder(th.TheoraDecoder):
    """The decoder: ``parse`` (host, any thread) turns a data packet into
    ``FrameRecords``; ``reconstruct`` (the device, in stream order) makes
    the frame and keeps ``last`` and ``golden`` on the device; ``crop``
    gives the picture as ``decode`` :650 returns it."""

    def __init__(self, header_packets: List[bytes], device):
        if len(header_packets) < 3:
            raise ValueError("theora: need 3 header packets")
        self.info = th.parse_ident(header_packets[0])
        self.setup = th.parse_setup(header_packets[2])
        self.geo = th._Geometry(self.info)
        self._qmat_cache: dict = {}
        self.huff = HuffTables(self.setup.huff_leaves)
        self.arrays = GeoArrays(self.geo)
        self.device = torch.device(device)
        self.last: Optional[Tuple[torch.Tensor, ...]] = None
        self.golden: Optional[Tuple[torch.Tensor, ...]] = None
        self.frame_no = 0
        self._keyed = False

    # -- host half ---------------------------------------------------- #

    def parse(self, pkt: bytes) -> Optional[FrameRecords]:
        """The host half of ``decode`` for a nonempty packet: None for a
        stray header packet."""
        if pkt[0] & 0x80:
            return None
        b = th.Bits(pkt)
        if b.read1() != 0:
            raise ValueError("theora: bad packet type bit")
        ftype = b.read1()
        qis = [b.read(6)]
        if b.read1():
            qis.append(b.read(6))
            if b.read1():
                qis.append(b.read(6))
        ga = self.arrays
        mbrec = np.zeros((ga.mbw * ga.mbh, MB_COLS), np.int32)
        if ftype == 0:
            if b.read(3) != 0:
                raise ValueError("theora: nonzero keyframe reserved bits")
            coded = np.ones(ga.total, bool)
            qi_idx = self._read_block_qis(b, coded, len(qis))
            bclass = np.zeros(ga.total, np.uint8)
            self._keyed = True
        else:
            if not self._keyed:
                raise ValueError("theora: inter frame before keyframe")
            coded = self._read_block_flags(b)
            mb_modes = self._read_modes(b, coded)
            mb_mvs = self._read_motion(b, coded, mb_modes)
            qi_idx = self._read_block_qis(b, coded, len(qis))
            self._fill_records(mbrec, mb_modes, mb_mvs)
            bclass = self._block_classes(mbrec)
        coefs = self._tokens(b, coded)
        coded8 = np.ascontiguousarray(coded, np.uint8)
        library().tc_th_predict_dc(
            _ptr(coefs), _ptr(coded8), _ptr(bclass), _ptr(ga.plane_off),
            _ptr(ga.bw), _ptr(ga.bh))
        return FrameRecords(ftype == 0, qis, coded8,
                            np.ascontiguousarray(qi_idx, np.uint8), coefs,
                            mbrec)

    def _fill_records(self, mbrec, mb_modes, mb_mvs) -> None:
        mbw = self.arrays.mbw
        for (mbx, mby), mode in mb_modes.items():
            r = mbrec[mby * mbw + mbx]
            r[0] = mode
            if mode < 0:
                continue
            mv = mb_mvs.get((mbx, mby), (0, 0))
            if mode == th.MODE_FOURMV:
                r[1:9] = np.asarray(mv, np.int32).reshape(-1)
            else:
                r[1:3] = mv

    def _block_classes(self, mbrec) -> np.ndarray:
        """uint8 (n,) frame class of each block (``_decode_inter``)."""
        ga = self.arrays
        mode = np.full(ga.total, th.MODE_NO_MV, np.int64)
        mbmode = mbrec[:, 0].astype(np.int64)
        live = mbmode >= 0
        for ids in (ga.luma, ga.chroma):
            mode[ids[live]] = mbmode[live][:, None]
        return np.array(th.FRAME_CLASS, np.uint8)[mode]

    def _tokens(self, b: th.Bits, coded: np.ndarray) -> np.ndarray:
        ga = self.arrays
        blocks = np.ascontiguousarray(
            ga.coded_order[coded[ga.coded_order]], np.int32)
        islv = np.ascontiguousarray(ga.chroma_block[blocks])
        out = np.zeros((ga.total, 64), np.int32)
        data = np.frombuffer(bytes(b.raw8), np.uint8)
        end = library().tc_th_tokens(
            self.huff.handle, _ptr(data), len(data), b.pos, _ptr(blocks),
            _ptr(islv), len(blocks), _ptr(out))
        b.pos = int(end)
        return out

    def qmat_table(self, qis: List[int]) -> np.ndarray:
        """int32 (2, 3, 3, 64) raster matrices [qti][plane][qi index]."""
        out = np.zeros((2, 3, 3, 64), np.int32)
        for qti in range(2):
            for p in range(3):
                for i in range(3):
                    out[qti, p, i] = self._qmat(qti, p,
                                                qis[min(i, len(qis) - 1)])
        return out

    # -- device half -------------------------------------------------- #

    def reconstruct(self, rec: FrameRecords) -> None:
        """The frame of ``rec`` on the device: ``theora_recon`` and
        ``theora_loop_filter``; it becomes ``last`` (and ``golden`` for
        an intra frame)."""
        from tcforge_tpu_torch.ops import kernels
        dev = self.device
        up = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
        coded = up(rec.coded)
        self.reconstruct_on(up(rec.coefs), coded, up(rec.qiidx),
                            up(rec.mbrec), up(self.qmat_table(rec.qis)),
                            rec.intra, rec.qis[0], kernels)

    def reconstruct_on(self, coefs, coded, qiidx, mbrec, qmats, intra: bool,
                       qi0: int, kernels) -> None:
        info = self.info
        fmt, fw, fh = self.geo.fmt, info.frame_w, info.frame_h
        if intra or self.last is None:
            last = golden = None
        else:
            last = self.last
            golden = self.golden if self.golden is not None else self.last
        planes = kernels.theora_recon(coefs, coded, qiidx, mbrec, qmats,
                                      last, golden, fmt, fw, fh)
        lim = int(self.setup.lflims[qi0])
        if lim > 0:
            planes = kernels.theora_loop_filter(planes, coded, lim, fmt, fw,
                                                fh)
        self.last = planes
        if intra:
            self.golden = planes
        self.frame_no += 1

    def crop(self) -> Tuple[torch.Tensor, ...]:
        """``_crop`` of ``last`` on the device: flipped to display order,
        the picture cut out."""
        info = self.info
        top = info.frame_h - info.pic_y - info.pic_h
        out = []
        for p, plane in enumerate(self.last):
            if p == 0:
                px, pw, ph, ty = info.pic_x, info.pic_w, info.pic_h, top
            elif self.geo.fmt == 0:
                px, pw = info.pic_x // 2, (info.pic_w + 1) // 2
                ph, ty = (info.pic_h + 1) // 2, top >> 1
            elif self.geo.fmt == 2:
                px, pw = info.pic_x // 2, (info.pic_w + 1) // 2
                ph, ty = info.pic_h, top
            else:
                px, pw, ph, ty = info.pic_x, info.pic_w, info.pic_h, top
            disp = torch.flip(plane, [0])
            out.append(disp[ty:ty + ph, px:px + pw].contiguous())
        return tuple(out)

    def decode(self, pkt: bytes):
        """``decode`` :650 on the device: the cropped planes, None for a
        stray header packet or a repeat before any frame."""
        if not pkt:
            return None if self.last is None else self.crop()
        rec = self.parse(pkt)
        if rec is None:
            return None
        self.reconstruct(rec)
        return self.crop()


# --------------------------------------------------------------------- #
# the encoder


@lru_cache(maxsize=None)
def group_codes() -> Tuple[np.ndarray, np.ndarray]:
    """The encoder's Huffman codes and lengths, uint32 and uint8 (5, 32)
    by group and token (``_GROUP_CODES``)."""
    codes = np.zeros((5, 32), np.uint32)
    lens = np.zeros((5, 32), np.uint8)
    for g, table in the._GROUP_CODES.items():
        for tok, (c, n) in table.items():
            codes[g, tok], lens[g, tok] = c, n
    return codes, lens


def write_tokens(cz: np.ndarray, islv: np.ndarray,
                 prefix: the.BitWriter) -> bytes:
    """The packet: ``prefix``'s bits, then the token stream of the coded
    blocks' int32 (nb, 64) zigzag rows ``cz`` (coded order, DC residuals
    in place) with ``islv`` 1 for chroma (``_token_events`` and
    ``_write_tokens`` in C++)."""
    codes, lens = group_codes()
    cz = np.ascontiguousarray(cz, np.int32)
    islv = np.ascontiguousarray(islv, np.uint8)
    head = np.frombuffer(bytes(prefix.buf) + b"\0", np.uint8)
    cap = len(prefix.buf) + 16 + 5 * 64 * len(cz)
    out = np.empty(cap, np.uint8)
    n = library().tc_th_write_tokens(
        _ptr(cz), _ptr(islv), len(cz), _ptr(codes), _ptr(lens), _ptr(head),
        len(prefix.buf), prefix.acc, prefix.n, _ptr(out), cap)
    if n < 0:
        raise ValueError("theoraenc: a level beyond the token alphabet")
    return out[:n].tobytes()


class TheoraDeviceEncoder(the.TheoraNativeEncoder):
    """``TheoraNativeEncoder`` with its frames on the device: ``encode``
    takes the display planes as uint8 tensors and returns (packet,
    is_key), the same bytes; the reconstruction (``dec.last``) stays on
    the device."""

    def __init__(self, width: int, height: int,
                 fps: Tuple[int, int] = (25, 1), qi: int = 45,
                 gop: int = 64, par: Tuple[int, int] = (0, 0),
                 device="cuda"):
        if width <= 0 or height <= 0:
            raise ValueError("theoraenc: bad geometry")
        if not 0 <= qi <= 63:
            raise ValueError("theoraenc: qi must be 0..63")
        self.qi = int(qi)
        self.gop = max(1, int(gop))
        self.kfgshift = max(1, (self.gop - 1).bit_length())
        self.w, self.h = width, height
        self.fmbw = (width + 15) // 16
        self.fmbh = (height + 15) // 16
        self.fps = fps
        self.par = par
        self.headers = [self._ident_header(), self._comment_header(),
                        self._setup_header()]
        self.dec = TheoraDeviceDecoder(self.headers, device)
        self.geo = self.dec.geo
        self.arrays = self.dec.arrays
        self._since_key = 0
        self._nframes = 0
        self._zz = np.array(th.ZIGZAG, np.int64)
        dev = self.dec.device
        qm = np.stack([np.stack([self.dec._qmat(qti, p, self.qi)
                                 for p in range(3)]) for qti in range(2)])
        self._qmat = torch.from_numpy(qm.astype(np.int32)).to(dev)
        self._qmats = torch.from_numpy(self.dec.qmat_table([self.qi])).to(dev)
        qstep = float(self.dec._qmat(1, 0, self.qi)[1])
        self._lam = max(2.0, qstep / 3.0)
        self._sse_floor = 1.5 * qstep * qstep
        self._chroma_floor = [1.5 * float(self.dec._qmat(1, p, self.qi)[1])
                              * float(self.dec._qmat(1, p, self.qi)[1])
                              for p in range(3)]
        self._order = torch.from_numpy(
            self.arrays.order.astype(np.int32)).to(dev)
        fw, fh = self.fmbw * 16, self.fmbh * 16
        self._dims = plane_dims(0, fw, fh)

    def device_planes(self, y: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> List[torch.Tensor]:
        """``_coded_planes`` on the device: uint8 planes of the coded
        frame (edges repeated, flipped: frames are coded bottom-up)."""
        out = []
        for pl, (ph, pw) in zip((y, u, v), self._dims):
            dev = pl.device
            rows = torch.arange(ph, device=dev).clamp(max=pl.shape[0] - 1)
            cols = torch.arange(pw, device=dev).clamp(max=pl.shape[1] - 1)
            out.append(torch.flip(pl[rows][:, cols], [0]).contiguous())
        return out

    def encode(self, y, u, v, force_key: bool = False
               ) -> Tuple[bytes, bool]:
        from tcforge_tpu_torch.ops import kernels
        planes = self.device_planes(y, u, v)
        key = (force_key or self.dec.last is None
               or self._since_key >= self.gop)
        pkt = self._encode_intra_dev(planes, kernels) if key \
            else self._encode_inter_dev(planes, kernels)
        self._since_key = 1 if key else self._since_key + 1
        self._nframes += 1
        return pkt, key

    def _quantize(self, resid: List[torch.Tensor], qti: List[torch.Tensor],
                  kernels) -> torch.Tensor:
        blocks = torch.cat([_blocks_of(r).reshape(-1, 64) for r in resid])
        group = torch.cat([q * 3 + p for p, q in enumerate(qti)])
        return kernels.theora_fdct_quant(blocks.to(torch.int16).contiguous(),
                                         group.to(torch.uint8), self._qmat)

    def _finish(self, bw: the.BitWriter, cz: torch.Tensor, coded: np.ndarray,
                bclass: np.ndarray, mbrec: torch.Tensor, intra: bool,
                kernels) -> bytes:
        """The DC residuals and tokens on the host, then the frame's
        reconstruction on the device from these records."""
        ga = self.arrays
        czh = cz.cpu().numpy()
        coded8 = np.ascontiguousarray(coded, np.uint8)
        dcq = np.ascontiguousarray(czh[:, 0], np.int64)
        resid = np.zeros(ga.total, np.int64)
        final = dcq.copy()
        library().tc_th_dc_residuals(
            _ptr(dcq), _ptr(coded8), _ptr(np.ascontiguousarray(bclass,
                                                               np.uint8)),
            _ptr(ga.plane_off), _ptr(ga.bw), _ptr(ga.bh), _ptr(resid),
            _ptr(final))
        czh[:, 0] = np.where(coded, resid, 0)
        blocks = ga.coded_order[coded[ga.coded_order]]
        pkt = write_tokens(czh[blocks], ga.chroma_block[blocks], bw)
        dev = cz.device
        cz[:, 0] = torch.from_numpy(
            np.where(coded, final, 0).astype(np.int32)).to(dev)
        zeros = torch.zeros(ga.total, dtype=torch.uint8, device=dev)
        self.dec.reconstruct_on(cz, torch.from_numpy(coded8).to(dev), zeros,
                                mbrec, self._qmats, intra, self.qi, kernels)
        return pkt

    def _encode_intra_dev(self, planes, kernels) -> bytes:
        bw = the.BitWriter()
        bw.write(0, 1)                         # data packet
        bw.write(0, 1)                         # intra
        bw.write(self.qi, 6)
        bw.write(0, 1)                         # single qi
        bw.write(0, 3)                         # reserved
        resid = [p.to(torch.int16) - 128 for p in planes]
        qti = [torch.zeros(r.numel() // 64, dtype=torch.int64,
                           device=r.device) for r in resid]
        cz = self._quantize(resid, qti, kernels)
        ga = self.arrays
        mbrec = torch.zeros((ga.mbw * ga.mbh, MB_COLS), dtype=torch.int32,
                            device=cz.device)
        return self._finish(bw, cz, np.ones(ga.total, bool),
                            np.zeros(ga.total, np.uint8), mbrec, True,
                            kernels)

    def _encode_inter_dev(self, planes, kernels) -> bytes:
        ga = self.arrays
        bw = the.BitWriter()
        bw.write(0, 1)
        bw.write(1, 1)                         # inter
        bw.write(self.qi, 6)
        bw.write(0, 1)
        last = self.dec.last
        me = kernels.theora_me(planes[0], last[0], self._order, self._lam,
                               self._sse_floor)
        dev = me.device
        mbrec = torch.zeros((ga.mbw * ga.mbh, MB_COLS), dtype=torch.int32,
                            device=dev)
        mbrec[:, 0:3] = me[:, 0:3]
        resid, qti, coded = [], [], []
        for p, (h, w) in enumerate(self._dims):
            bh, bw_ = h // 8, w // 8
            mode, mx, my = block_motion(mbrec, 0, p, bh, bw_)
            mode = mode.reshape(-1)
            src = _blocks_of(planes[p]).to(torch.int64)
            prev = _blocks_of(last[p]).to(torch.int64)
            pred = mc_pred(last[p], bh, bw_, mx, my)
            intra = (mode == th.MODE_INTRA)[:, None, None]
            r = torch.where(intra, src - 128, src - pred)
            if p == 0:
                flags = me[:, 3:7].reshape(ga.mbh, ga.mbw, 2, 2) \
                    .permute(0, 2, 1, 3).reshape(-1)
                cd = flags != 0
            else:
                d0 = src - prev
                cd = (d0 * d0).sum(dim=(1, 2)).to(torch.float64) \
                    > self._chroma_floor[p]
            resid.append(_plane_of(r, h, w))
            qti.append((mode != th.MODE_INTRA).to(torch.int64))
            coded.append(cd)
        cz = self._quantize(resid, qti, kernels)
        coded_t = torch.cat(coded)
        nomv = torch.cat([block_motion(mbrec, 0, p, h // 8, w // 8)[0]
                          .reshape(-1) for p, (h, w) in
                          enumerate(self._dims)]) == th.MODE_NO_MV
        coded_t = coded_t & ~(nomv & ~(cz != 0).any(dim=1))
        coded = coded_t.cpu().numpy()
        meh = me.cpu().numpy()
        mb_modes, mb_mvs = {}, {}
        for mb, r in zip(self.geo.mb_order, ga.order):
            mb_modes[mb] = int(meh[r, 0])
            mb_mvs[mb] = (int(meh[r, 1]), int(meh[r, 2]))
        self._write_block_flags(bw, coded)
        self._write_modes(bw, mb_modes, coded)
        self._write_motion(bw, mb_modes, mb_mvs, coded)
        block_mode = np.full(ga.total, th.MODE_NO_MV, np.int64)
        mbmode = meh[:, 0].astype(np.int64)
        live = mbmode >= 0
        for ids in (ga.luma, ga.chroma):
            block_mode[ids[live]] = mbmode[live][:, None]
        bclass = np.array(th.FRAME_CLASS, np.uint8)[block_mode]
        return self._finish(bw, cz, coded, bclass, mbrec, False, kernels)
