"""DV25 both ways: the pixels on the device, the bits on the host.

The JAX package's in-tree DV codec (``tcforge_tpu/io/dvdec.py``,
``io/dvenc.py``) is numpy and Python loops over blocks.  The port splits
each direction in two:

Decode.  The host walks a frame's DIF blocks and runs the run-level VLC
with its three-pass bit spill (a block's own area, the macroblock's pool,
the segment's pool) for the 9,720 (PAL) or 8,100 (NTSC) blocks of a
frame: ``csrc/dv_host.cpp`` ``tc_dv_parse``, frames side by side on host
threads, held byte for byte to ``parse_frame_ref`` (the pinned
``DVDecoder._parse_mb`` and ``_drain`` of ``io/dvdec.py`` with
``decode``'s segment pass).  Its record is a block's 64 dequantized
coefficients (int16, raster order) and its DCT mode, the blocks in
bitstream order (sequence, segment, macroblock, block).  On the device
one launch of ``dv_idct`` a batch (``ops/kernels.py``) runs the exact
integer 8-8 IDCT (with the dc-only row shortcut) or the 2-4-8 field IDCT
and stores each block straight into its plane: ``placement`` gives each
block's plane, row, column and whether it is a split right-edge 4:1:1
chroma block.  ``dv_idct_ref`` is the plain version.

Encode.  On the device, one launch of ``dv_fdct_cost`` gathers each
block from the planes, picks its 8-8 or 2-4-8 mode
(``DVEncoder._pick_modes``), computes its float64 forward transform with
the pinned inverse matrices (``dvbasis.npy``: the JAX module's ``_F88``
and ``_F248``, which it computes with LAPACK at import) in the order
numpy's OpenBLAS gemv sums ``F @ x`` on the machine that pinned the
goldens (four lanes of fused multiply-adds over ``i % 4``, then ``(l0 +
l2) + (l1 + l3)``), its DC, and for every qno 0..15 the class
``DVEncoder._quantize`` picks and the AC bits ``_ac_cost`` counts.  The
host fits each segment's rate from that table alone
(``tc_dv_rate_fit``, ``_segment_strings``' qno descent), a second launch
gives the levels at the chosen qnos, and the host drops coefficients at
the qno floor, writes the codewords, packs each segment with the
decoder-exact pass 1/2/3 spill and assembles the DIF frame
(``tc_dv_pack``, held to ``pack_frame_ref``, which runs the pinned
``_ac_cost``, ``_ac_bits`` and ``_pack_segment``).

Audio (AAUX, PAL 48 kHz 16-bit) stays on the host: ``extract_audio`` and
``inject_audio`` give the pinned functions' results with numpy gathers
instead of a loop over samples.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.io import dvdec as dd
from tcforge_tpu_torch.io import dvenc as de
from tcforge_tpu_torch.ops import _build

PAL_BLOCKS = 12 * 27 * 30       # blocks a PAL frame
NTSC_BLOCKS = 10 * 27 * 30      # blocks an NTSC frame
PAL_BYTES = 144000
NTSC_BYTES = 120000
QNOS = 16                       # the quantizer numbers 0..15
SEGMENT_BUDGET = 5 * 536        # AC bits of a segment (_segment_strings)
# a block's cost table entry: the class and the AC bits at each qno
TABLE_CLASS, TABLE_COST = 0, 1

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def frame_blocks(pal: bool) -> int:
    return PAL_BLOCKS if pal else NTSC_BLOCKS


def plane_shapes(pal: bool) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(rows, columns) of the Y plane and of each chroma plane."""
    return ((576, 720), (288, 360)) if pal else ((480, 720), (480, 180))


@lru_cache(maxsize=None)
def placement(pal: bool) -> np.ndarray:
    """int32 (blocks, 4): each block's plane (0 Y, 1 Cb, 2 Cr), top row,
    left column and split flag, the blocks in bitstream order: the PAL
    superblock shuffle of ``DVDecoder.decode`` and the NTSC one of
    ``_ntsc_mb_blocks`` (a split block carries a 4x16 region: its left
    four columns the top half)."""
    nseq = 12 if pal else 10
    out = np.zeros((frame_blocks(pal), 4), np.int32)
    i = 0
    for seq in range(nseq):
        for v_i in range(27):
            for b in range(5):
                if pal:
                    sb_col = dd._SB_COL[b]
                    sb_row = (seq + dd._SB_ROW_OFF[b]) % 12
                    cx = v_i // 3
                    cy = v_i % 3 if cx % 2 == 0 else 2 - (v_i % 3)
                    mbx = 9 * sb_col + cx
                    mby = 3 * sb_row + cy
                    entries = [(0, mby * 16 + (k // 2) * 8,
                                mbx * 16 + (k % 2) * 8, False)
                               for k in range(4)]
                    entries += [(2, mby * 8, mbx * 8, False),
                                (1, mby * 8, mbx * 8, False)]
                else:
                    entries = dd._ntsc_mb_blocks(seq, v_i, b)
                for p, py, px, split in entries:
                    out[i] = (p, py, px, int(split))
                    i += 1
    return out


@lru_cache(maxsize=None)
def pixel_index(pal: bool) -> np.ndarray:
    """int64 (blocks, 64): where each sample of each block lies in a
    frame's planes laid one after the other (Y, Cb, Cr)."""
    (yh, yw), (ch, cw) = plane_shapes(pal)
    base = (0, yh * yw, yh * yw + ch * cw)
    width = (yw, cw, cw)
    place = placement(pal)
    r = np.arange(8)[:, None]
    c = np.arange(8)[None, :]
    out = np.empty((len(place), 64), np.int64)
    for i, (p, py, px, split) in enumerate(place):
        if split:
            rows = py + r + 8 * (c >= 4)
            cols = px + (c % 4)
        else:
            rows = py + r + 0 * c
            cols = px + c + 0 * r
        out[i] = (base[p] + rows * width[p] + cols).ravel()
    return out


def frame_samples(pal: bool) -> int:
    (yh, yw), (ch, cw) = plane_shapes(pal)
    return yh * yw + 2 * ch * cw


# --------------------------------------------------------------------- #
# decode: the host parse (plain: the pinned Python) and the plain IDCT


@lru_cache(maxsize=None)
def _decoder() -> dd.DVDecoder:
    return dd.DVDecoder()


def _video_payloads(data: bytes) -> Tuple[bool, int, List[List[bytes]]]:
    """``DVDecoder.decode``'s checks and its walk of the video DIF
    blocks: (pal, sequences, the payloads of each sequence in order)."""
    if len(data) < 120000:
        raise ValueError("dv: short frame")
    pal = bool(data[3] & 0x80)
    if pal:
        data = data[:PAL_BYTES]
        nseq = 12
    else:
        data = data[:NTSC_BYTES]
        nseq = 10
    vid: List[List[bytes]] = [[] for _ in range(nseq)]
    for off in range(0, len(data), 80):
        if data[off] >> 5 == 4:
            seq = data[off + 1] >> 4
            if seq < nseq:
                vid[seq].append(data[off + 3:off + 80])
    for seq in range(nseq):
        if len(vid[seq]) != 135:
            raise ValueError("dv: incomplete video sequence")
    return pal, nseq, vid


def parse_frame_ref(data: bytes) -> Tuple[bool, np.ndarray, np.ndarray]:
    """The plain host parse of one DV frame: (pal, int16 (blocks, 64)
    dequantized coefficients in raster order, uint8 (blocks,) DCT mode),
    the blocks in bitstream order: ``DVDecoder._parse_mb`` for each
    macroblock, then ``decode``'s segment pass."""
    dec = _decoder()
    pal, nseq, vid = _video_payloads(data)
    coef = np.zeros((frame_blocks(pal), 64), np.int16)
    mode = np.zeros(frame_blocks(pal), np.uint8)
    i = 0
    for seq in range(nseq):
        for v_i in range(27):
            parsed = [dec._parse_mb(vid[seq][5 * v_i + b])
                      for b in range(5)]
            mbs = [p[0] for p in parsed]
            pool = dd._concat([p[1] for p in parsed])
            for m in mbs:
                for blk in m:
                    if not blk.done:
                        dec._drain(blk, pool)
            for m in mbs:
                for blk in m:
                    coef[i] = blk.coefs
                    mode[i] = blk.mode
                    i += 1
    return pal, coef, mode


def _idct_rows(b: torch.Tensor) -> torch.Tensor:
    """``_idct_rows`` on int64 (n, 8, 8): the row pass, rows whose AC is
    zero the dc<<3 shortcut."""
    r = [b[:, :, i] for i in range(8)]
    base = dd._W4 * r[0] + (1 << (dd._ROW_SHIFT - 1))
    a0 = base + dd._W2 * r[2] + dd._W4 * r[4] + dd._W6 * r[6]
    a1 = base + dd._W6 * r[2] - dd._W4 * r[4] - dd._W2 * r[6]
    a2 = base - dd._W6 * r[2] - dd._W4 * r[4] + dd._W2 * r[6]
    a3 = base - dd._W2 * r[2] + dd._W4 * r[4] - dd._W6 * r[6]
    b0 = dd._W1 * r[1] + dd._W3 * r[3] + dd._W5 * r[5] + dd._W7 * r[7]
    b1 = dd._W3 * r[1] - dd._W7 * r[3] - dd._W1 * r[5] - dd._W5 * r[7]
    b2 = dd._W5 * r[1] - dd._W1 * r[3] + dd._W7 * r[5] + dd._W3 * r[7]
    b3 = dd._W7 * r[1] - dd._W5 * r[3] + dd._W3 * r[5] - dd._W1 * r[7]
    out = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                       a3 - b3, a2 - b2, a1 - b1, a0 - b0], dim=2)
    out = out >> dd._ROW_SHIFT
    dconly = (b[:, :, 1:] == 0).all(dim=2, keepdim=True)
    return torch.where(dconly, (b[:, :, :1] << 3).expand_as(out), out)


def _idct88(coef: torch.Tensor) -> torch.Tensor:
    t = _idct_rows(coef)
    c = [t[:, i, :] for i in range(8)]
    base = dd._W4 * (c[0] + ((1 << (dd._COL_SHIFT - 1)) // dd._W4))
    a0 = base + dd._W2 * c[2] + dd._W4 * c[4] + dd._W6 * c[6]
    a1 = base + dd._W6 * c[2] - dd._W4 * c[4] - dd._W2 * c[6]
    a2 = base - dd._W6 * c[2] - dd._W4 * c[4] + dd._W2 * c[6]
    a3 = base - dd._W2 * c[2] + dd._W4 * c[4] - dd._W6 * c[6]
    b0 = dd._W1 * c[1] + dd._W3 * c[3] + dd._W5 * c[5] + dd._W7 * c[7]
    b1 = dd._W3 * c[1] - dd._W7 * c[3] - dd._W1 * c[5] - dd._W5 * c[7]
    b2 = dd._W5 * c[1] - dd._W1 * c[3] + dd._W7 * c[5] + dd._W3 * c[7]
    b3 = dd._W7 * c[1] - dd._W5 * c[3] + dd._W3 * c[5] - dd._W1 * c[7]
    out = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                       a3 - b3, a2 - b2, a1 - b1, a0 - b0], dim=1)
    return out >> dd._COL_SHIFT


def _idct4col(a: torch.Tensor) -> torch.Tensor:
    a0, a1, a2, a3 = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    half = 1 << (dd._C_SHIFT - 1)
    c0 = ((a0 + a2) << (dd._CN_SHIFT - 1)) + half
    c2 = ((a0 - a2) << (dd._CN_SHIFT - 1)) + half
    c1 = a1 * dd._C1 + a3 * dd._C2
    c3 = a1 * dd._C2 - a3 * dd._C1
    return torch.stack([c0 + c1, c2 + c3, c2 - c3, c0 - c1],
                       dim=1) >> dd._C_SHIFT


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _idct248(coef: torch.Tensor) -> torch.Tensor:
    bf = torch.empty_like(coef)
    bf[:, 0::2] = _wrap16(coef[:, 0::2] + coef[:, 1::2])
    bf[:, 1::2] = _wrap16(coef[:, 0::2] - coef[:, 1::2])
    t = _idct_rows(bf)
    out = torch.empty_like(t)
    out[:, 0::2] = _idct4col(t[:, 0::2])
    out[:, 1::2] = _idct4col(t[:, 1::2])
    return out


def idct_blocks_ref(coef: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """uint8 (n, 64) samples of int16 (n, 64) coefficients: ``idct88``
    where ``mode`` is 0, ``idct248`` where it is 1."""
    c = coef.to(torch.int64).view(-1, 8, 8)
    pix = torch.where(mode.view(-1, 1, 1).bool(), _idct248(c), _idct88(c))
    return pix.clamp_(0, 255).to(torch.uint8).view(-1, 64)


def dv_idct_ref(coef: torch.Tensor, mode: torch.Tensor, pal: bool) -> Planes:
    """Plain version of ``kernels.dv_idct``: the planes of a batch of
    frames from their parse records."""
    nb = frame_blocks(pal)
    frames = coef.shape[0] // nb
    (yh, yw), (ch, cw) = plane_shapes(pal)
    pix = idct_blocks_ref(coef, mode).view(frames, nb * 64)
    flat = torch.empty((frames, frame_samples(pal)), dtype=torch.uint8,
                       device=coef.device)
    idx = torch.from_numpy(pixel_index(pal).ravel()).to(coef.device)
    flat[:, idx] = pix
    y = flat[:, :yh * yw].reshape(frames, yh, yw)
    u = flat[:, yh * yw:yh * yw + ch * cw].reshape(frames, ch, cw)
    v = flat[:, yh * yw + ch * cw:].reshape(frames, ch, cw)
    return y.contiguous(), u.contiguous(), v.contiguous()


# --------------------------------------------------------------------- #
# encode: the plain versions of dv_fdct_cost's two entries

_BASIS_FILE = Path(__file__).resolve().parent / "dvbasis.npy"


@lru_cache(maxsize=None)
def basis() -> np.ndarray:
    """float64 (2, 64, 64): the JAX encoder's ``_F88`` and ``_F248``, bit
    for bit (``tests/test_torch_dv.py`` holds them to the JAX module)."""
    return np.load(_BASIS_FILE)


@lru_cache(maxsize=None)
def factors() -> np.ndarray:
    """int64 (2, 2, 22, 64): ``DVDecoder._factors`` [class 3][mode][q]
    [scan position]."""
    return np.array(_decoder()._factors, np.int64)


@lru_cache(maxsize=None)
def zigzag() -> np.ndarray:
    """int64 (2, 64): the 8-8 and 2-4-8 scans."""
    return np.array([dd._ZIGZAG_88, dd._ZIGZAG_248], np.int64)


@lru_cache(maxsize=None)
def cost_table() -> np.ndarray:
    """uint8 (64, 256): the AC bits ``_ac_cost`` adds for a nonzero level
    of magnitude ``a`` after ``run`` zeros: the run-level code where there
    is one, else the run-only code (when ``run``) and the level-only
    code."""
    t = np.zeros((64, 256), np.uint8)
    for run in range(64):
        for a in range(1, 256):
            hit = de._DIRECT.get((run, a))
            if hit is not None:
                t[run, a] = hit[1]
            else:
                t[run, a] = (de._RUNONLY[run - 1][1] if run else 0) \
                    + de._LEVELONLY[a][1]
    return t


def gather_blocks(planes: Planes, pal: bool) -> torch.Tensor:
    """int64 (frames * blocks, 64): each block's samples from the planes,
    as ``DVEncoder.encode`` cuts them."""
    frames = planes[0].shape[0]
    flat = torch.cat([p.reshape(frames, -1) for p in planes], dim=1)
    idx = torch.from_numpy(pixel_index(pal).ravel()).to(flat.device)
    return flat[:, idx].reshape(-1, 64).to(torch.int64)


def pick_modes_ref(blocks: torch.Tensor) -> torch.Tensor:
    """``DVEncoder._pick_modes``: 1 where the line-to-line differences
    outweigh twice the field-internal ones."""
    x = blocks.view(-1, 8, 8)
    inter = (x[:, 1:] - x[:, :-1]).abs().sum(dim=(1, 2))
    fields = ((x[:, 2:] - x[:, :-2]).abs().sum(dim=(1, 2)) + 1) // 2
    return (inter > 2 * fields).to(torch.uint8)


def forward_ref(blocks: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """float64 (n, 64): ``F @ x`` for each block by its mode's matrix, in
    the order of OpenBLAS's double gemv kernel on the machine that pinned
    the goldens: lane ``i % 4`` a chain of fused multiply-adds over
    ``i``, then ``(l0 + l2) + (l1 + l3)``."""
    from tcforge_tpu_torch.io.mpeg2codec import fma64
    x = blocks.to(torch.float64)
    F = torch.from_numpy(basis()).to(x.device)
    out = torch.empty_like(x)
    for m in (0, 1):
        sel = mode == m
        if not bool(sel.any()):
            continue
        xs = x[sel]
        acc = [torch.zeros_like(xs) for _ in range(4)]
        for i in range(64):
            acc[i % 4] = fma64(F[m][:, i][None, :], xs[:, i:i + 1],
                               acc[i % 4])
        out[sel] = (acc[0] + acc[2]) + (acc[1] + acc[3])
    return out


def quantize_ref(X: torch.Tensor, mode: torch.Tensor, qno: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DVEncoder._quantize`` for each block at its ``qno``: (uint8
    class, int64 (n, 64) zigzag levels), the finest class whose AC levels
    fit 255, else class 3 clipped."""
    dev = X.device
    zz = torch.from_numpy(zigzag()).to(dev)[mode.long()]
    xz = torch.gather(X, 1, zz)
    fac = torch.from_numpy(factors()).to(dev).to(torch.float64)
    cls = torch.full((X.shape[0],), 3, dtype=torch.uint8, device=dev)
    lv = None
    done = torch.zeros(X.shape[0], dtype=torch.bool, device=dev)
    for c in (0, 1, 2, 3):
        q = qno.long() + dd._QUANT_OFFSET[c]
        f = fac[1 if c == 3 else 0][mode.long(), q]
        cand = torch.round(xz * 16384.0 / f).to(torch.int64)
        fits = cand[:, 1:].abs().amax(dim=1) <= 255
        take = fits & ~done
        lv = cand if lv is None else torch.where(take[:, None], cand, lv)
        cls = torch.where(take, torch.full_like(cls, c), cls)
        done |= fits
    lv = torch.where(done[:, None], lv, lv.clamp(-255, 255))
    return cls, lv


def ac_cost_ref(lv: torch.Tensor) -> torch.Tensor:
    """``_ac_cost`` of int64 (n, 64) zigzag levels (position 0 ignored)."""
    dev = lv.device
    pos = torch.arange(64, device=dev)
    nz = (lv != 0) & (pos > 0)
    last = torch.where(nz, pos, torch.zeros_like(pos)).cummax(dim=1).values
    prev = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
    run = (pos - prev - 1).clamp(min=0)
    t = torch.from_numpy(cost_table().astype(np.int64)).to(dev)
    bits = t[run, lv.abs().clamp(max=255)]
    return de._EOB_CODE[1] + torch.where(nz, bits, 0).sum(dim=1)


def fdct_cost_ref(planes: Planes, pal: bool, qno=None):
    """Plain version of ``kernels.dv_fdct_cost``.  Without ``qno``: (int16
    (n, 16, 2) each block's class and AC bits at qno 0..15, int16 (n,) DC,
    uint8 (n,) mode); with uint8 ``qno`` (n / 6,), each macroblock's:
    (int16 (n, 64) zigzag levels, uint8 (n,) class)."""
    blocks = gather_blocks(planes, pal)
    mode = pick_modes_ref(blocks)
    X = forward_ref(blocks, mode)
    dc = torch.round((X[:, 0] - 1024.0) / 4.0).clamp_(-256, 255)
    X[:, 0] = 0.0
    if qno is not None:
        q = qno.long().repeat_interleave(6)
        cls, lv = quantize_ref(X, mode, q)
        return lv.to(torch.int16), cls
    table = torch.empty((X.shape[0], QNOS, 2), dtype=torch.int16,
                        device=X.device)
    for q in range(QNOS):
        cls, lv = quantize_ref(X, mode, torch.full_like(mode, q))
        table[:, q, TABLE_CLASS] = cls.to(torch.int16)
        table[:, q, TABLE_COST] = ac_cost_ref(lv).to(torch.int16)
    return table, dc.to(torch.int16), mode


# --------------------------------------------------------------------- #
# encode: the host's rate fit and packing (plain: the pinned Python)


def rate_fit_ref(table: np.ndarray) -> np.ndarray:
    """uint8 (n / 6,) each macroblock's qno: ``_segment_strings``' descent
    from 15, the segment's most expensive macroblock first, read from the
    int16 (n, 16, 2) table of a whole number of segments."""
    cost = table[:, :, TABLE_COST].astype(np.int64).reshape(-1, 5, 6, QNOS)
    out = np.empty((cost.shape[0], 5), np.uint8)
    for s in range(cost.shape[0]):
        mb = cost[s].sum(axis=1)            # (5, 16)
        qnos = [15] * 5
        totals = [int(mb[m, 15]) for m in range(5)]
        while sum(totals) > SEGMENT_BUDGET and max(qnos) > 0:
            m = max(range(5),
                    key=lambda k: totals[k] if qnos[k] > 0 else -1)
            if qnos[m] == 0:
                break
            qnos[m] -= 1
            totals[m] = int(mb[m, qnos[m]])
        out[s] = qnos
    return out.reshape(-1)


def _segment_strings_ref(levels, cls, dc, mode, qno):
    """One segment's 5 x (qno, [(bits, nbits) x 6]) as ``_segment_strings``
    ends: the coefficient drop at the qno floor, then each block's DC,
    mode, class and ``_ac_bits``."""
    infos = []
    totals = []
    for m in range(5):
        info = []
        for i in range(6):
            lv = [int(x) for x in levels[6 * m + i]]
            info.append((int(cls[6 * m + i]), lv, de._ac_cost(lv)))
        infos.append(info)
        totals.append(sum(c for _, _, c in info))
    while sum(totals) > SEGMENT_BUDGET:
        m = max(range(5), key=lambda k: totals[k])
        info = infos[m]
        worst = max(range(6), key=lambda i: info[i][2])
        c, lv, cost = info[worst]
        for j in range(63, 0, -1):
            if lv[j]:
                lv[j] = 0
                break
        ncost = de._ac_cost(lv)
        info[worst] = (c, lv, ncost)
        totals[m] += ncost - cost
    out = []
    for m in range(5):
        strs = []
        for i in range(6):
            c, lv, _ = infos[m][i]
            bs = de._BitStr()
            bs.put(int(dc[6 * m + i]) & 0x1FF, 9)
            bs.put(int(mode[6 * m + i]), 1)
            bs.put(c, 2)
            av, an = de._ac_bits(lv)
            bs.put(av, an)
            strs.append((bs.val, bs.n))
        out.append((int(qno[m]), strs))
    return out


def _dif_templates(pal: bool):
    if pal:
        return de._HDR_PAYLOAD, de._VAUX_PAYLOAD
    return de._HDR_PAYLOAD_N, de._VAUX_PAYLOAD_N


def pack_frame_ref(levels: np.ndarray, cls: np.ndarray, dc: np.ndarray,
                   mode: np.ndarray, qno: np.ndarray, pal: bool) -> bytes:
    """The plain host half of ``DVEncoder.encode`` for one frame from its
    blocks' levels (zigzag), classes, DCs and modes and its macroblocks'
    qnos: each segment's strings and ``_pack_segment``, then the DIF
    frame with the header, subcode, VAUX and empty audio sections."""
    nseq = 12 if pal else 10
    hdr, vaux = _dif_templates(pal)
    out = bytearray()
    for seq in range(nseq):
        out += bytes([0x1F, (seq << 4) | 0x07, 0x00]) + hdr
        for k in range(2):
            out += bytes([0x3F, (seq << 4) | 0x07, k]) + de._SUB_PAYLOAD
        for k in range(3):
            out += bytes([0x56, (seq << 4) | 0x07, k]) + vaux
        seg_payloads: List[bytes] = []
        for v_i in range(27):
            s = seq * 27 + v_i
            sl = slice(30 * s, 30 * s + 30)
            seg_payloads.extend(de.DVEncoder._pack_segment(
                _segment_strings_ref(levels[sl], cls[sl], dc[sl], mode[sl],
                                     qno[5 * s:5 * s + 5])))
        audio_n = video_n = vi = 0
        for n in range(144):
            if n % 16 == 0:
                out += bytes([0x76, (seq << 4) | 0x07, audio_n]) \
                    + de._AUDIO_PAYLOAD
                audio_n += 1
            else:
                out += bytes([0x96, (seq << 4) | 0x07, video_n]) \
                    + seg_payloads[vi]
                video_n += 1
                vi += 1
    return bytes(out)


# --------------------------------------------------------------------- #
# the host library: csrc/dv_host.cpp


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """``csrc/dv_host.cpp``, built with g++ at first use."""
    lib = _build.load_host("dv_host")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tc_dv_parse.argtypes = (p, p, ll, i, p, p, p, p, p, p)
    lib.tc_dv_rate_fit.argtypes = (p, ll, p)
    lib.tc_dv_pack.argtypes = (p, p, p, p, p, ll, i, p, p, p, p)
    for fn in (lib.tc_dv_parse, lib.tc_dv_rate_fit, lib.tc_dv_pack):
        fn.restype = i
    return lib


@lru_cache(maxsize=None)
def _parse_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pinned decoder's tables for ``tc_dv_parse``: int32 (65536, 3)
    the 16-bit VLC window's (length, step, level), the (2, 2, 22, 64)
    dequantizer factors, and the two scans, the block areas' bits and the
    class offsets of the quantizer number (138 values)."""
    lut = np.ascontiguousarray(np.array(dd._LUT, np.int32))
    fac = np.ascontiguousarray(factors(), np.int32)
    misc = np.concatenate([zigzag().ravel(), dd._BLOCK_BITS,
                           dd._QUANT_OFFSET]).astype(np.int32)
    return lut, fac, misc


# tc_dv_parse's per-frame status codes
_PARSE_ERRORS = {1: "dv: short frame",
                 2: "dv: incomplete video sequence",
                 3: "dv: a frame of the other system (525/60 and 625/50 "
                    "frames mixed in one stream)"}


def parse_frames(frames: Sequence[bytes], pal: bool, coef: np.ndarray,
                 mode: np.ndarray) -> None:
    """``parse_frame_ref`` of each frame of one system into ``coef`` (int16
    (frames * blocks, 64), zeroed) and ``mode`` (uint8 (frames *
    blocks,)), frames side by side on host threads.  A frame the pinned
    parse refuses raises its ValueError (the first such frame's)."""
    n = len(frames)
    nb = frame_blocks(pal)
    if coef.shape != (n * nb, 64) or coef.dtype != np.int16 \
            or mode.shape != (n * nb,) or mode.dtype != np.uint8 \
            or not coef.flags.c_contiguous:
        raise ValueError(f"dv parse: coef {coef.shape} {coef.dtype}, mode "
                         f"{mode.shape} for {n} frames of {nb} blocks")
    if n == 0:
        return
    keep = [np.frombuffer(f, np.uint8) for f in frames]
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in keep])
    lens = np.array([len(f) for f in frames], np.int64)
    status = np.zeros(n, np.int32)
    lut, fac, misc = _parse_tables()
    rc = library().tc_dv_parse(
        ctypes.cast(ptrs, ctypes.c_void_p), lens.ctypes.data, n, int(pal),
        coef.ctypes.data, mode.ctypes.data, status.ctypes.data,
        lut.ctypes.data, fac.ctypes.data, misc.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"dv: the host parse failed ({rc})")
    for k in range(n):
        if status[k]:
            raise ValueError(_PARSE_ERRORS[int(status[k])])


def rate_fit(table: np.ndarray) -> np.ndarray:
    """``rate_fit_ref`` by ``tc_dv_rate_fit``."""
    table = np.ascontiguousarray(table, np.int16)
    if table.ndim != 3 or table.shape[1:] != (QNOS, 2) \
            or table.shape[0] % 30:
        raise ValueError(f"dv rate fit: table {table.shape}")
    segments = table.shape[0] // 30
    qno = np.empty(segments * 5, np.uint8)
    library().tc_dv_rate_fit(table.ctypes.data, segments, qno.ctypes.data)
    return qno


@lru_cache(maxsize=None)
def _vlc_blob() -> np.ndarray:
    """uint32: the pinned encoder's codes for ``tc_dv_pack``: the
    run-level codes and lengths (64 x 256 each, length 0 where there is
    none), the run-only and the level-only ones, EOB, the block areas'
    bits."""
    dcode = np.zeros((64, 256), np.uint32)
    dlen = np.zeros((64, 256), np.uint32)
    for (run, a), (code, ln) in de._DIRECT.items():
        dcode[run, a], dlen[run, a] = code, ln
    rcode = np.array([de._RUNONLY[r][0] for r in range(64)], np.uint32)
    rlen = np.array([de._RUNONLY[r][1] for r in range(64)], np.uint32)
    lcode = np.zeros(256, np.uint32)
    llen = np.zeros(256, np.uint32)
    for a in range(1, 256):
        lcode[a], llen[a] = de._LEVELONLY[a]
    tail = np.array([*de._EOB_CODE, *dd._BLOCK_BITS], np.uint32)
    return np.concatenate([dcode.ravel(), dlen.ravel(), rcode, rlen, lcode,
                           llen, tail])


@lru_cache(maxsize=None)
def _templates(pal: bool) -> np.ndarray:
    hdr, vaux = _dif_templates(pal)
    return np.frombuffer(hdr + de._SUB_PAYLOAD + vaux + de._AUDIO_PAYLOAD,
                         np.uint8).copy()


def pack_frames(levels: np.ndarray, cls: np.ndarray, dc: np.ndarray,
                mode: np.ndarray, qno: np.ndarray, pal: bool) -> List[bytes]:
    """``pack_frame_ref`` of each frame of a batch by ``tc_dv_pack``,
    frames side by side on host threads."""
    nb = frame_blocks(pal)
    levels = np.ascontiguousarray(levels, np.int16)
    cls = np.ascontiguousarray(cls, np.uint8)
    dc = np.ascontiguousarray(dc, np.int16)
    mode = np.ascontiguousarray(mode, np.uint8)
    qno = np.ascontiguousarray(qno, np.uint8)
    frames = levels.shape[0] // nb
    if levels.shape != (frames * nb, 64) or cls.shape != (frames * nb,) \
            or dc.shape != cls.shape or mode.shape != cls.shape \
            or qno.shape != (frames * nb // 6,):
        raise ValueError(f"dv pack: levels {levels.shape}, qno {qno.shape} "
                         f"for frames of {nb} blocks")
    size = PAL_BYTES if pal else NTSC_BYTES
    out = np.empty(frames * size, np.uint8)
    status = np.zeros(frames, np.int32)
    if frames:
        library().tc_dv_pack(
            levels.ctypes.data, cls.ctypes.data, dc.ctypes.data,
            mode.ctypes.data, qno.ctypes.data, frames, int(pal),
            _templates(pal).ctypes.data, _vlc_blob().ctypes.data,
            out.ctypes.data, status.ctypes.data)
    if status.any():
        raise AssertionError("dvenc: segment overflow exceeded capacity")
    return [out[f * size:(f + 1) * size].tobytes() for f in range(frames)]


# --------------------------------------------------------------------- #
# AAUX audio (PAL 48 kHz 16-bit), the pinned functions with gathers


@lru_cache(maxsize=None)
def _audio_slots() -> Tuple[np.ndarray, np.ndarray]:
    """(seq, dbn, byte) of each of the 2 x 1920 samples of a frame,
    channel 1 six sequences on (``_audio_positions``)."""
    seq = np.concatenate([dd._AUD_SEQ, dd._AUD_SEQ + 6])
    dbn = np.concatenate([dd._AUD_DBN, dd._AUD_DBN])
    off = np.concatenate([dd._AUD_OFF, dd._AUD_OFF])
    return seq * 256 + dbn, off


def _audio_blocks(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The audio DIF blocks of a frame of 1800 blocks: their rows in file
    order, and for each (seq, dbn) key the row of its last block (-1
    where there is none), as the pinned functions' dicts keep it."""
    rows = np.nonzero(arr[:, 0] >> 5 == 3)[0]
    keys = (arr[rows, 1] >> 4).astype(np.int64) * 256 + arr[rows, 2]
    where = np.full(16 * 256, -1, np.int64)
    where[keys] = rows                     # later blocks win
    return rows, where


def _sample_rows(where: np.ndarray) -> np.ndarray:
    keys, _ = _audio_slots()
    got = where[keys]
    if (got < 0).any():
        k = int(keys[np.argmax(got < 0)])
        raise KeyError((k >> 8, k & 0xFF))
    return got


def extract_audio(data: bytes) -> Tuple[np.ndarray, int]:
    """``dvdec.extract_audio``: ((1920, 2) int16 samples, 48000) of a PAL
    frame, with its checks and errors."""
    if len(data) < PAL_BYTES or not (data[3] & 0x80):
        raise ValueError("dv audio: need a PAL DIF frame")
    arr = np.frombuffer(data, np.uint8, PAL_BYTES).reshape(1800, 80)
    rows, where = _audio_blocks(arr)
    if int((where >= 0).sum()) != 108:
        raise ValueError("dv audio: incomplete audio sections")
    packs = rows[arr[rows, 3] == 0x50]
    if not len(packs) or arr[packs[0], 4] == 0xFF:
        raise ValueError("dv audio: no AAUX source pack (no audio)")
    as_pack = arr[packs[0], 3:8]
    smp = (int(as_pack[4]) >> 3) & 0x7
    qu = int(as_pack[4]) & 0x7
    if smp != 0 or qu != 0:
        raise NotImplementedError(
            "dv audio: only 48 kHz 16-bit is implemented natively "
            f"(stream has smp={smp} qu={qu}); use the FFmpeg bridge")
    _, off = _audio_slots()
    base = _sample_rows(where) * 80 + 3 + off
    flat = arr.reshape(-1)
    pcm = ((flat[base].astype(np.int32) << 8) | flat[base + 1]).astype(
        np.uint16).view(np.int16)
    return pcm.reshape(2, 1920).T.copy(), 48000


def inject_audio(frame: bytes, pcm: np.ndarray) -> bytes:
    """``dvenc.inject_audio``: (1920, 2) int16 samples (short input
    zero-padded, mono doubled) into a PAL frame's AAUX packs and audio
    blocks."""
    if len(frame) != PAL_BYTES:
        raise ValueError("dv audio: need a PAL DIF frame")
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = np.stack([pcm, pcm], axis=1)
    if pcm.shape[0] < 1920:
        pcm = np.pad(pcm, ((0, 1920 - pcm.shape[0]), (0, 0)))
    arr = np.frombuffer(frame, np.uint8).reshape(1800, 80).copy()
    rows, where = _audio_blocks(arr)
    for r in rows:
        seq = int(arr[r, 1]) >> 4
        dbn = int(arr[r, 2])
        start = 3 if seq % 2 == 0 else 0
        if start <= dbn < start + 4:
            pk = bytearray(de._AAUX_PACKS[dbn - start])
            if pk[0] == 0x50 and seq >= 6:
                pk[2] = 0x01
            arr[r, 3:8] = np.frombuffer(bytes(pk), np.uint8)
        else:
            arr[r, 3:8] = 0xFF
    _, off = _audio_slots()
    base = _sample_rows(where) * 80 + 3 + off
    vals = pcm[:1920, :2].T.reshape(-1).astype(np.int32) & 0xFFFF
    flat = arr.reshape(-1)
    flat[base] = vals >> 8
    flat[base + 1] = vals & 0xFF
    return flat.tobytes()


# --------------------------------------------------------------------- #
# the two directions over a batch


def decode_records(coef: torch.Tensor, mode: torch.Tensor, pal: bool
                   ) -> Planes:
    """A batch's 4:2:0 planes from its parse records on their device: one
    launch of ``dv_idct``; NTSC's 4:1:1 chroma to 4:2:0 as the JAX
    importer's ``to420`` does it (vertical pairs averaged, columns
    repeated)."""
    from tcforge_tpu_torch.ops import kernels
    y, u, v = kernels.dv_idct(coef, mode, pal)
    if not pal:
        def to420(c: torch.Tensor) -> torch.Tensor:
            m = ((c[:, 0::2].to(torch.int32) + c[:, 1::2] + 1) >> 1)
            return m.to(torch.uint8).repeat_interleave(2, dim=2)
        u, v = to420(u), to420(v)
    return y, u, v


def encode_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> List[bytes]:
    """DIF frames of a batch of PAL 4:2:0 or NTSC 4:1:1 planes on their
    device: the cost table (one launch of ``dv_fdct_cost``), the host's
    rate fit, the levels at the chosen qnos (a second launch), the
    host's packing."""
    from tcforge_tpu_torch.ops import kernels
    y, u, v = y.contiguous(), u.contiguous(), v.contiguous()
    pal = kernels._dv_system(y, u, v)
    table, dc, mode = kernels.dv_fdct_cost(y, u, v)
    qno = rate_fit(table.cpu().numpy())
    levels, cls = kernels.dv_fdct_cost(
        y, u, v, torch.from_numpy(qno).to(y.device))
    return pack_frames(levels.cpu().numpy(), cls.cpu().numpy(),
                       dc.cpu().numpy(), mode.cpu().numpy(), qno, pal)
