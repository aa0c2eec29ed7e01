"""RTjpeg (the NuppelVideo intra codec) both ways: the block transforms on
the device, the byte coder on the host.

The JAX package's RTjpeg (``tcforge_tpu/io/rtjpeg.py``, pinned in the
port as ``io/rtjpeg.py``) runs its transforms in numpy over a frame's
blocks and its byte coder ``b2s``/``s2b`` in per-block Python.  The port
keeps the tables (``init_q``, ``_b8``, ``dct_tables``, ``idct_tables``)
and splits the rest:

- compress: one launch of ``rtjpeg_fdct_quant`` a batch
  (``ops/kernels.py``) cuts the 4:2:0 planes into blocks in stream order
  (``_mb_blocks``: per 16x16 macroblock Y00 Y01 Y10 Y11, U, V), runs the
  AAN integer forward DCT with DESCALE10/20 (``fdct_blocks``) and
  quantizes with the luma or chroma table (``quant_blocks``); the host
  codes each frame's blocks with ``b2s`` (``csrc/rtjpeg_host.cpp``
  ``tc_rtjpeg_b2s``, frames on host threads);
- decompress: the host decodes each frame's bytes with ``s2b`` into
  dequantized coefficients (``tc_rtjpeg_s2b``), one launch of
  ``rtjpeg_idct`` a batch runs the AAN inverse DCT with the reference's
  MULTIPLY/DESCALE and its 16..235 range limit (``idct_blocks``) and
  stores each block into its plane.

``fdct_quant_ref`` and ``idct_ref`` are the plain versions; the C++ coder
is held to the pinned ``b2s`` and ``s2b``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.io import rtjpeg as rj
from tcforge_tpu_torch.ops import _build

# the most bytes b2s writes for a block: its DC and 63 values
BLOCK_BYTES_MAX = 64


def check_geometry(width: int, height: int) -> None:
    if width % 16 or height % 16:
        raise ValueError("RTjpeg needs multiple-of-16 geometry")


def frame_blocks(width: int, height: int) -> int:
    return (width // 16) * (height // 16) * 6


@lru_cache(maxsize=None)
def block_index(width: int, height: int) -> np.ndarray:
    """int64 (blocks, 64): where each sample of each block lies in a
    frame's planes laid one after the other (Y, U, V), the blocks in
    ``_mb_blocks``' order."""
    check_geometry(width, height)
    cw = width // 2
    ysize = width * height
    csize = ysize // 4
    r = np.arange(8)[:, None]
    c = np.arange(8)[None, :]
    out = []
    for by in range(0, height, 16):
        for bx in range(0, width, 16):
            for oy, ox in ((0, 0), (0, 8), (8, 0), (8, 8)):
                out.append((by + oy + r) * width + bx + ox + c)
            cy, cx = by // 2, bx // 2
            out.append(ysize + (cy + r) * cw + cx + c)
            out.append(ysize + csize + (cy + r) * cw + cx + c)
    return np.stack(out).reshape(-1, 64)


@lru_cache(maxsize=None)
def compress_tables(quality: int) -> Tuple[np.ndarray, int, int, bytes]:
    """``RTjpegCompressor(w, h, quality)``'s state: int64 (2, 64) forward
    quantizers (luma, chroma) with the AAN scales folded in, the two
    zigzag thresholds and the 'D' frame's 128 uint32 tables."""
    lqt, cqt, liqt, ciqt, lb8, cb8 = rj.init_q(quality)
    lq, cq = rj.dct_tables(lqt, cqt)
    tables = liqt.astype("<u4").tobytes() + ciqt.astype("<u4").tobytes()
    return np.stack([lq, cq]).astype(np.int64), lb8, cb8, tables


def decompress_tables(tables: bytes) -> Tuple[np.ndarray, int, int]:
    """``RTjpegDecompressor``'s state from a 'D' frame's payload: int64
    (2, 64) AAN-scaled dequantizers (luma, chroma) and the two zigzag
    thresholds."""
    if len(tables) < 128 * 4:
        raise ValueError("short RTjpeg table packet")
    buf = np.frombuffer(tables, "<u4", count=128)
    liqt, ciqt = buf[:64].copy(), buf[64:].copy()
    li, ci = rj.idct_tables(liqt, ciqt)
    return np.stack([li, ci]).astype(np.int64), rj._b8(liqt), rj._b8(ciqt)


def _luma(nblocks: int, device) -> torch.Tensor:
    """True for the Y blocks of a run of frames' blocks."""
    return (torch.arange(nblocks, device=device) % 6) < 4


# --------------------------------------------------------------------- #
# the plain versions of the two kernels


def gather_blocks(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """int64 (frames * blocks, 64): the frames' blocks in stream order."""
    frames, height, width = y.shape
    flat = torch.cat([y.reshape(frames, -1), u.reshape(frames, -1),
                      v.reshape(frames, -1)], dim=1)
    idx = torch.from_numpy(block_index(width, height).ravel()).to(y.device)
    return flat[:, idx].reshape(-1, 64).to(torch.int64)


def _as16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int16).to(torch.int64)


def fdct_ref(b: torch.Tensor) -> torch.Tensor:
    """``fdct_blocks`` on int64 (n, 8, 8) samples."""
    ws = torch.empty_like(b)
    t0, t7 = b[:, :, 0] + b[:, :, 7], b[:, :, 0] - b[:, :, 7]
    t1, t6 = b[:, :, 1] + b[:, :, 6], b[:, :, 1] - b[:, :, 6]
    t2, t5 = b[:, :, 2] + b[:, :, 5], b[:, :, 2] - b[:, :, 5]
    t3, t4 = b[:, :, 3] + b[:, :, 4], b[:, :, 3] - b[:, :, 4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    ws[:, :, 0] = (t10 + t11) << 8
    ws[:, :, 4] = (t10 - t11) << 8
    z1 = (t12 + t13) * rj.FIX_0_707106781
    ws[:, :, 2] = (t13 << 8) + z1
    ws[:, :, 6] = (t13 << 8) - z1
    t10, t11, t12 = t4 + t5, t5 + t6, t6 + t7
    z5 = (t10 - t12) * rj.FIX_0_382683433
    z2 = t10 * rj.FIX_0_541196100 + z5
    z4 = t12 * rj.FIX_1_306562965 + z5
    z3 = t11 * rj.FIX_0_707106781
    z11, z13 = (t7 << 8) + z3, (t7 << 8) - z3
    ws[:, :, 5] = z13 + z2
    ws[:, :, 3] = z13 - z2
    ws[:, :, 1] = z11 + z4
    ws[:, :, 7] = z11 - z4

    def d10(x):
        return _as16((x + 128) >> 8)

    def d20(x):
        return _as16((x + 32768) >> 16)
    out = torch.empty_like(b)
    t0, t7 = ws[:, 0, :] + ws[:, 7, :], ws[:, 0, :] - ws[:, 7, :]
    t1, t6 = ws[:, 1, :] + ws[:, 6, :], ws[:, 1, :] - ws[:, 6, :]
    t2, t5 = ws[:, 2, :] + ws[:, 5, :], ws[:, 2, :] - ws[:, 5, :]
    t3, t4 = ws[:, 3, :] + ws[:, 4, :], ws[:, 3, :] - ws[:, 4, :]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out[:, 0, :] = d10(t10 + t11)
    out[:, 4, :] = d10(t10 - t11)
    z1 = (t12 + t13) * rj.FIX_0_707106781
    out[:, 2, :] = d20((t13 << 8) + z1)
    out[:, 6, :] = d20((t13 << 8) - z1)
    t10, t11, t12 = t4 + t5, t5 + t6, t6 + t7
    z5 = (t10 - t12) * rj.FIX_0_382683433
    z2 = t10 * rj.FIX_0_541196100 + z5
    z4 = t12 * rj.FIX_1_306562965 + z5
    z3 = t11 * rj.FIX_0_707106781
    z11, z13 = (t7 << 8) + z3, (t7 << 8) - z3
    out[:, 5, :] = d20(z13 + z2)
    out[:, 3, :] = d20(z13 - z2)
    out[:, 1, :] = d20(z11 + z4)
    out[:, 7, :] = d20(z11 - z4)
    return out


def fdct_quant_ref(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qt: torch.Tensor) -> torch.Tensor:
    """Plain version of ``kernels.rtjpeg_fdct_quant``: int16 (frames *
    blocks, 64) quantized coefficients in natural order."""
    coef = fdct_ref(gather_blocks(y, u, v).view(-1, 8, 8)).view(-1, 64)
    q = torch.where(_luma(coef.shape[0], coef.device)[:, None],
                    qt[0][None, :], qt[1][None, :])
    return ((coef * q + 32767) >> 16).to(torch.int16)


def idct_blocks_ref(data: torch.Tensor) -> torch.Tensor:
    """``idct_blocks``: (n, 64) dequantized coefficients to uint8 (n, 64)
    samples, range-limited to 16..235."""
    d = data.to(torch.int64).view(-1, 8, 8)

    def mul(v, c):
        return (v * c + 128) >> 8

    def butterfly(x0, x1, x2, x3, x4, x5, x6, x7):
        t10, t11 = x0 + x4, x0 - x4
        t13 = x2 + x6
        t12 = mul(x2 - x6, rj.FIX_1_414213562) - t13
        e0, e3 = t10 + t13, t10 - t13
        e1, e2 = t11 + t12, t11 - t12
        z13, z10 = x5 + x3, x5 - x3
        z11, z12 = x1 + x7, x1 - x7
        o7 = z11 + z13
        t11 = mul(z11 - z13, rj.FIX_1_414213562)
        z5 = mul(z10 + z12, rj.FIX_1_847759065)
        t10 = mul(z12, rj.FIX_1_082392200) - z5
        t12 = mul(z10, -rj.FIX_2_613125930) + z5
        o6 = t12 - o7
        o5 = t11 - o6
        o4 = t10 + o5
        return (e0 + o7, e1 + o6, e2 + o5, e3 - o4,
                e3 + o4, e2 - o5, e1 - o6, e0 - o7)
    ws = torch.stack(butterfly(*[d[:, i, :] for i in range(8)]), dim=1)
    out = torch.stack(butterfly(*[ws[:, :, i] for i in range(8)]), dim=2)
    out = _as16((out + 4) >> 3).clamp_(16, 235)
    return out.to(torch.uint8).view(-1, 64)


def idct_ref(coef: torch.Tensor, width: int, height: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``kernels.rtjpeg_idct``: the 4:2:0 planes of a
    batch of frames from their dequantized coefficients."""
    nb = frame_blocks(width, height)
    frames = coef.shape[0] // nb
    pix = idct_blocks_ref(coef).view(frames, nb * 64)
    ysize = width * height
    flat = torch.empty((frames, ysize * 3 // 2), dtype=torch.uint8,
                       device=coef.device)
    idx = torch.from_numpy(block_index(width, height).ravel()).to(
        coef.device)
    flat[:, idx] = pix
    y = flat[:, :ysize].reshape(frames, height, width)
    u = flat[:, ysize:ysize * 5 // 4].reshape(frames, height // 2,
                                              width // 2)
    v = flat[:, ysize * 5 // 4:].reshape(frames, height // 2, width // 2)
    return y.contiguous(), u.contiguous(), v.contiguous()


# --------------------------------------------------------------------- #
# the byte coder: plain (the pinned b2s and s2b) and csrc/rtjpeg_host.cpp


def b2s_frame_ref(q: np.ndarray, lb8: int, cb8: int) -> bytes:
    """One frame's stream from its int16 (blocks, 64) quantized blocks,
    as ``RTjpegCompressor.compress`` codes them."""
    return b"".join(rj.b2s(q[k], lb8 if k % 6 < 4 else cb8)
                    for k in range(q.shape[0]))


def s2b_frame_ref(data: bytes, nblocks: int, tables: np.ndarray, lb8: int,
                  cb8: int) -> np.ndarray:
    """One frame's int64 (blocks, 64) dequantized coefficients, as
    ``RTjpegDecompressor.decompress`` reads them."""
    mv = memoryview(data)
    pos = 0
    out = np.empty((nblocks, 64), np.int64)
    for k in range(nblocks):
        luma = k % 6 < 4
        out[k], pos = rj.s2b(mv, pos, lb8 if luma else cb8,
                             tables[0] if luma else tables[1])
    return out


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """``csrc/rtjpeg_host.cpp``, built with g++ at first use."""
    lib = _build.load_host("rtjpeg_host")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tc_rtjpeg_b2s.argtypes = (p, ll, ll, i, i, p, p, ll, p)
    lib.tc_rtjpeg_s2b.argtypes = (p, p, ll, ll, i, i, p, p, p, p)
    lib.tc_rtjpeg_b2s.restype = i
    lib.tc_rtjpeg_s2b.restype = i
    return lib


@lru_cache(maxsize=None)
def _zigzag32() -> np.ndarray:
    return rj.ZZ.astype(np.int32)


def compress_frames(q: np.ndarray, nblocks: int, lb8: int, cb8: int
                    ) -> List[bytes]:
    """``b2s_frame_ref`` of each frame of int16 (frames * blocks, 64)
    quantized blocks, frames side by side on host threads."""
    q = np.ascontiguousarray(q, np.int16)
    frames = q.shape[0] // nblocks
    if q.shape != (frames * nblocks, 64):
        raise ValueError(f"rtjpeg: blocks {q.shape}, frames of {nblocks}")
    cap = nblocks * BLOCK_BYTES_MAX
    out = np.empty(frames * cap, np.uint8)
    lengths = np.zeros(frames, np.int64)
    if frames:
        library().tc_rtjpeg_b2s(q.ctypes.data, frames, nblocks, lb8, cb8,
                                _zigzag32().ctypes.data, out.ctypes.data,
                                cap, lengths.ctypes.data)
    return [out[f * cap:f * cap + int(lengths[f])].tobytes()
            for f in range(frames)]


def decompress_frames(payloads: Sequence[bytes], nblocks: int,
                      tables: np.ndarray, lb8: int, cb8: int,
                      coef: np.ndarray) -> None:
    """``s2b_frame_ref`` of each payload into ``coef`` (int32 (frames *
    blocks, 64)), frames side by side on host threads.  A payload that
    ends before its last block raises IndexError, as the pinned
    decoder's read past its end does."""
    n = len(payloads)
    if coef.shape != (n * nblocks, 64) or coef.dtype != np.int32 \
            or not coef.flags.c_contiguous:
        raise ValueError(f"rtjpeg: coef {coef.shape} {coef.dtype} for {n} "
                         f"frames of {nblocks} blocks")
    if n == 0:
        return
    keep = [np.frombuffer(p, np.uint8) for p in payloads]
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in keep])
    lens = np.array([len(p) for p in payloads], np.int64)
    status = np.zeros(n, np.int32)
    qt = np.ascontiguousarray(tables, np.int64)
    library().tc_rtjpeg_s2b(ctypes.cast(ptrs, ctypes.c_void_p),
                            lens.ctypes.data, n, nblocks, lb8, cb8,
                            qt.ctypes.data, _zigzag32().ctypes.data,
                            coef.ctypes.data, status.ctypes.data)
    if status.any():
        raise IndexError("rtjpeg: frame data ends inside a block")
