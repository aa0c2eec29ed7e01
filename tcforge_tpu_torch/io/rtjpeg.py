# Copied from tcforge_tpu/io/rtjpeg.py; only the package name in its imports differs.
"""RTjpeg codec — bit-exact port of the NuppelVideo intra codec.

Rebuild of ``import/nuv/RTjpegN.c`` (the portable, non-MMX paths):

- AAN integer forward DCT (RTjpeg_dctY, 8-bit fixed point with the
  DESCALE10/DESCALE20 rounding) and the matching jidctfst-style inverse
  (RTjpeg_idct, MULTIPLY/DESCALE/RL semantics incl. the 16..235 range
  limit);
- quality-scaled quantizer construction (RTjpeg_init_Q) with the AAN
  scale factors folded into the tables (dct_init/idct_init);
- the run-length entropy coder (RTjpeg_b2s/s2b): DC byte, raw int8
  coefficients up to the ``b8`` zigzag threshold, then values clipped
  to +-63 with zero runs coded as ``63 + runlength``;
- the 4:2:0 macroblock stream layout (Y00 Y01 Y10 Y11 U V per 16x16).

The DCT/IDCT and quantization are vectorized over every block of a
frame; only the entropy byte stream is per-block Python (same split as
the MPEG-2 path).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

ZZ = np.array([
    0, 8, 1, 2, 9, 16, 24, 17, 10, 3, 4, 11, 18, 25, 32, 40,
    33, 26, 19, 12, 5, 6, 13, 20, 27, 34, 41, 48, 56, 49, 42, 35,
    28, 21, 14, 7, 15, 22, 29, 36, 43, 50, 57, 58, 51, 44, 37, 30,
    23, 31, 38, 45, 52, 59, 60, 53, 46, 39, 47, 54, 61, 62, 55, 63],
    dtype=np.int64)

AAN = np.array([
    4294967296, 5957222912, 5611718144, 5050464768, 4294967296,
    3374581504, 2324432128, 1184891264,
    5957222912, 8263040512, 7783580160, 7005009920, 5957222912,
    4680582144, 3224107520, 1643641088,
    5611718144, 7783580160, 7331904512, 6598688768, 5611718144,
    4408998912, 3036936960, 1548224000,
    5050464768, 7005009920, 6598688768, 5938608128, 5050464768,
    3968072960, 2733115392, 1393296000,
    4294967296, 5957222912, 5611718144, 5050464768, 4294967296,
    3374581504, 2324432128, 1184891264,
    3374581504, 4680582144, 4408998912, 3968072960, 3374581504,
    2651326208, 1826357504, 931136000,
    2324432128, 3224107520, 3036936960, 2733115392, 2324432128,
    1826357504, 1258030336, 641204288,
    1184891264, 1643641088, 1548224000, 1393296000, 1184891264,
    931136000, 641204288, 326894240], dtype=np.uint64)

LUM_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
    103, 99], dtype=np.uint64)

CHROM_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    dtype=np.uint64)

FIX_0_382683433 = 98
FIX_0_541196100 = 139
FIX_0_707106781 = 181
FIX_1_306562965 = 334
FIX_1_082392200 = 277
FIX_1_414213562 = 362
FIX_1_847759065 = 473
FIX_2_613125930 = 669


def init_q(q: int):
    """RTjpeg_init_Q: quality 0..255 -> (lqt, cqt, liqt, ciqt, lb8, cb8).
    liqt/ciqt are the 128 uint32s shipped in the stream."""
    qual = np.uint64(q) << np.uint64(32 - 7)
    lqt = (qual // (LUM_QUANT << np.uint64(16))) >> np.uint64(3)
    cqt = (qual // (CHROM_QUANT << np.uint64(16))) >> np.uint64(3)
    lqt = np.maximum(lqt, 1).astype(np.int64)
    cqt = np.maximum(cqt, 1).astype(np.int64)
    liqt = (1 << 16) // (lqt << 3)
    ciqt = (1 << 16) // (cqt << 3)
    lqt = ((1 << 16) // liqt) >> 3
    cqt = ((1 << 16) // ciqt) >> 3
    return (lqt.astype(np.int64), cqt.astype(np.int64),
            liqt.astype(np.uint32), ciqt.astype(np.uint32),
            _b8(liqt), _b8(ciqt))


def _b8(iqt) -> int:
    """Zigzag threshold: last index whose dequant step is <= 8."""
    b8 = 0
    while iqt[ZZ[b8 + 1]] <= 8:
        b8 += 1
        if b8 == 63:
            break
    return b8


def dct_tables(lqt, cqt):
    """RTjpeg_dct_init: fold the AAN scales into the forward quantizers."""
    lq = ((lqt.astype(np.uint64) << np.uint64(32)) // AAN).astype(
        np.int64)
    cq = ((cqt.astype(np.uint64) << np.uint64(32)) // AAN).astype(
        np.int64)
    return lq, cq


def idct_tables(liqt, ciqt):
    """RTjpeg_idct_init: AAN-scale the stream dequant tables."""
    li = ((liqt.astype(np.uint64) * AAN) >> np.uint64(32)).astype(
        np.int64)
    ci = ((ciqt.astype(np.uint64) * AAN) >> np.uint64(32)).astype(
        np.int64)
    return li, ci


# --------------------------------------------------------------------- #
# Forward DCT (RTjpeg_dctY, portable branch) over (N, 8, 8) uint8 blocks


def fdct_blocks(blocks: np.ndarray) -> np.ndarray:
    b = blocks.astype(np.int64)
    mul = lambda v, c: v * c                       # D_MULTIPLY

    # pass 1: rows -> workspace at 2^8 scale
    t0 = b[:, :, 0] + b[:, :, 7]
    t7 = b[:, :, 0] - b[:, :, 7]
    t1 = b[:, :, 1] + b[:, :, 6]
    t6 = b[:, :, 1] - b[:, :, 6]
    t2 = b[:, :, 2] + b[:, :, 5]
    t5 = b[:, :, 2] - b[:, :, 5]
    t3 = b[:, :, 3] + b[:, :, 4]
    t4 = b[:, :, 3] - b[:, :, 4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    ws = np.empty(b.shape, np.int64)
    ws[:, :, 0] = (t10 + t11) << 8
    ws[:, :, 4] = (t10 - t11) << 8
    z1 = mul(t12 + t13, FIX_0_707106781)
    ws[:, :, 2] = (t13 << 8) + z1
    ws[:, :, 6] = (t13 << 8) - z1
    t10 = t4 + t5
    t11 = t5 + t6
    t12 = t6 + t7
    z5 = mul(t10 - t12, FIX_0_382683433)
    z2 = mul(t10, FIX_0_541196100) + z5
    z4 = mul(t12, FIX_1_306562965) + z5
    z3 = mul(t11, FIX_0_707106781)
    z11 = (t7 << 8) + z3
    z13 = (t7 << 8) - z3
    ws[:, :, 5] = z13 + z2
    ws[:, :, 3] = z13 - z2
    ws[:, :, 1] = z11 + z4
    ws[:, :, 7] = z11 - z4

    # pass 2: columns -> coefficients
    d10 = lambda x: ((x + 128) >> 8).astype(np.int16).astype(np.int64)
    d20 = lambda x: ((x + 32768) >> 16).astype(np.int16) \
        .astype(np.int64)
    t0 = ws[:, 0, :] + ws[:, 7, :]
    t7 = ws[:, 0, :] - ws[:, 7, :]
    t1 = ws[:, 1, :] + ws[:, 6, :]
    t6 = ws[:, 1, :] - ws[:, 6, :]
    t2 = ws[:, 2, :] + ws[:, 5, :]
    t5 = ws[:, 2, :] - ws[:, 5, :]
    t3 = ws[:, 3, :] + ws[:, 4, :]
    t4 = ws[:, 3, :] - ws[:, 4, :]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = np.empty(b.shape, np.int64)
    out[:, 0, :] = d10(t10 + t11)
    out[:, 4, :] = d10(t10 - t11)
    z1 = mul(t12 + t13, FIX_0_707106781)
    out[:, 2, :] = d20((t13 << 8) + z1)
    out[:, 6, :] = d20((t13 << 8) - z1)
    t10 = t4 + t5
    t11 = t5 + t6
    t12 = t6 + t7
    z5 = mul(t10 - t12, FIX_0_382683433)
    z2 = mul(t10, FIX_0_541196100) + z5
    z4 = mul(t12, FIX_1_306562965) + z5
    z3 = mul(t11, FIX_0_707106781)
    z11 = (t7 << 8) + z3
    z13 = (t7 << 8) - z3
    out[:, 5, :] = d20(z13 + z2)
    out[:, 3, :] = d20(z13 - z2)
    out[:, 1, :] = d20(z11 + z4)
    out[:, 7, :] = d20(z11 - z4)
    return out


def quant_blocks(coefs: np.ndarray, qtbl: np.ndarray) -> np.ndarray:
    """RTjpeg_quant: (block*qtbl + 32767) >> 16."""
    flat = coefs.reshape(-1, 64)
    return ((flat * qtbl[None, :] + 32767) >> 16).astype(np.int16)


# --------------------------------------------------------------------- #
# Inverse DCT (RTjpeg_idct, portable branch)


def idct_blocks(data: np.ndarray) -> np.ndarray:
    """(N, 64) int dequantized coefficients -> (N, 8, 8) uint8 pixels
    (range-limited to 16..235 like the reference's RL macro)."""
    d = data.reshape(-1, 8, 8).astype(np.int64)
    mul = lambda v, c: (v * c + 128) >> 8          # MULTIPLY

    # pass 1: columns -> workspace (note the reference's all-zero
    # shortcut is a pure speedup: identical results)
    t0 = d[:, 0, :]
    t1 = d[:, 2, :]
    t2 = d[:, 4, :]
    t3 = d[:, 6, :]
    t10, t11 = t0 + t2, t0 - t2
    t13 = t1 + t3
    t12 = mul(t1 - t3, FIX_1_414213562) - t13
    e0, e3 = t10 + t13, t10 - t13
    e1, e2 = t11 + t12, t11 - t12
    t4 = d[:, 1, :]
    t5 = d[:, 3, :]
    t6 = d[:, 5, :]
    t7 = d[:, 7, :]
    z13 = t6 + t5
    z10 = t6 - t5
    z11 = t4 + t7
    z12 = t4 - t7
    o7 = z11 + z13
    t11 = mul(z11 - z13, FIX_1_414213562)
    z5 = mul(z10 + z12, FIX_1_847759065)
    t10 = mul(z12, FIX_1_082392200) - z5
    t12 = mul(z10, -FIX_2_613125930) + z5
    o6 = t12 - o7
    o5 = t11 - o6
    o4 = t10 + o5
    ws = np.empty(d.shape, np.int64)
    ws[:, 0, :] = e0 + o7
    ws[:, 7, :] = e0 - o7
    ws[:, 1, :] = e1 + o6
    ws[:, 6, :] = e1 - o6
    ws[:, 2, :] = e2 + o5
    ws[:, 5, :] = e2 - o5
    ws[:, 4, :] = e3 + o4
    ws[:, 3, :] = e3 - o4

    # pass 2: rows -> pixels
    t10 = ws[:, :, 0] + ws[:, :, 4]
    t11 = ws[:, :, 0] - ws[:, :, 4]
    t13 = ws[:, :, 2] + ws[:, :, 6]
    t12 = mul(ws[:, :, 2] - ws[:, :, 6], FIX_1_414213562) - t13
    e0, e3 = t10 + t13, t10 - t13
    e1, e2 = t11 + t12, t11 - t12
    z13 = ws[:, :, 5] + ws[:, :, 3]
    z10 = ws[:, :, 5] - ws[:, :, 3]
    z11 = ws[:, :, 1] + ws[:, :, 7]
    z12 = ws[:, :, 1] - ws[:, :, 7]
    o7 = z11 + z13
    t11 = mul(z11 - z13, FIX_1_414213562)
    z5 = mul(z10 + z12, FIX_1_847759065)
    t10 = mul(z12, FIX_1_082392200) - z5
    t12 = mul(z10, -FIX_2_613125930) + z5
    o6 = t12 - o7
    o5 = t11 - o6
    o4 = t10 + o5
    desc = lambda x: ((x + 4) >> 3).astype(np.int16).astype(np.int64)
    rl = lambda x: np.clip(x, 16, 235)
    out = np.empty(d.shape, np.int64)
    out[:, :, 0] = rl(desc(e0 + o7))
    out[:, :, 7] = rl(desc(e0 - o7))
    out[:, :, 1] = rl(desc(e1 + o6))
    out[:, :, 6] = rl(desc(e1 - o6))
    out[:, :, 2] = rl(desc(e2 + o5))
    out[:, :, 5] = rl(desc(e2 - o5))
    out[:, :, 4] = rl(desc(e3 + o4))
    out[:, :, 3] = rl(desc(e3 - o4))
    return out.astype(np.uint8)


# --------------------------------------------------------------------- #
# Entropy coding (RTjpeg_b2s / RTjpeg_s2b, portable branch)


def b2s(block: np.ndarray, b8: int) -> bytes:
    """One quantized block (64 int16, natural order) -> byte stream."""
    zz = block[ZZ]
    out = bytearray()
    dc = int(zz[0])
    out.append(254 if dc > 254 else (0 if dc < 0 else dc))
    for ci in range(1, b8 + 1):
        v = int(zz[ci])
        v = 127 if v > 127 else (-128 if v < -128 else v)
        out.append(v & 0xFF)
    ci = b8 + 1
    while ci < 64:
        v = int(zz[ci])
        if v > 0:
            out.append(min(v, 63))
            ci += 1
        elif v < 0:
            out.append(max(v, -64) & 0xFF)
            ci += 1
        else:
            run = 0
            while ci < 64 and zz[ci] == 0:
                ci += 1
                run += 1
            out.append(63 + run)
    return bytes(out)


def s2b(strm: memoryview, pos: int, b8: int,
        qtbl: np.ndarray) -> Tuple[np.ndarray, int]:
    """Byte stream -> one dequantized block (64 int, natural order)."""
    data = np.zeros(64, np.int64)
    data[ZZ[0]] = strm[pos] * int(qtbl[ZZ[0]])
    ci = pos + 1
    co = 1
    while co <= b8:
        v = strm[ci]
        if v >= 128:
            v -= 256
        i = ZZ[co]
        data[i] = v * int(qtbl[i])
        ci += 1
        co += 1
    while co < 64:
        v = strm[ci]
        if v >= 128:
            v -= 256
        if v > 63:
            co += v - 63
        else:
            i = ZZ[co]
            data[i] = v * int(qtbl[i])
            co += 1
        ci += 1
    return data, ci


# --------------------------------------------------------------------- #
# Frame codec: 4:2:0 macroblock layout


def _mb_blocks(y, u, v):
    """Yield per-MB blocks in stream order (Y00 Y01 Y10 Y11 U V)."""
    h, w = y.shape
    for by in range(0, h, 16):
        for bx in range(0, w, 16):
            yield y[by:by + 8, bx:bx + 8]
            yield y[by:by + 8, bx + 8:bx + 16]
            yield y[by + 8:by + 16, bx:bx + 8]
            yield y[by + 8:by + 16, bx + 8:bx + 16]
            cy, cx = by // 2, bx // 2
            yield u[cy:cy + 8, cx:cx + 8]
            yield v[cy:cy + 8, cx:cx + 8]


class RTjpegCompressor:
    def __init__(self, width: int, height: int, quality: int = 255):
        if width % 16 or height % 16:
            raise ValueError("RTjpeg needs multiple-of-16 geometry")
        self.width, self.height = width, height
        (lqt, cqt, self.liqt, self.ciqt,
         self.lb8, self.cb8) = init_q(quality)
        self.lqt, self.cqt = dct_tables(lqt, cqt)

    def tables(self) -> bytes:
        """The 128 uint32 quant tables shipped in the 'D' frame."""
        return (self.liqt.astype("<u4").tobytes()
                + self.ciqt.astype("<u4").tobytes())

    def compress(self, y, u, v) -> bytes:
        blocks = np.stack(list(_mb_blocks(y, u, v)))
        coefs = fdct_blocks(blocks)
        n_mb = len(blocks) // 6
        luma_sel = np.tile([True] * 4 + [False] * 2, n_mb)
        q = np.empty((len(blocks), 64), np.int16)
        q[luma_sel] = quant_blocks(coefs[luma_sel], self.lqt)
        q[~luma_sel] = quant_blocks(coefs[~luma_sel], self.cqt)
        out = bytearray()
        for k in range(len(blocks)):
            b8 = self.lb8 if luma_sel[k] else self.cb8
            out += b2s(q[k], b8)
        return bytes(out)


class RTjpegDecompressor:
    def __init__(self, tables: bytes, width: int, height: int):
        if len(tables) < 128 * 4:
            raise ValueError("short RTjpeg table packet")
        buf = np.frombuffer(tables, "<u4", count=128)
        self.width, self.height = width, height
        liqt = buf[:64].copy()
        ciqt = buf[64:].copy()
        self.lb8 = _b8(liqt)
        self.cb8 = _b8(ciqt)
        self.liqt, self.ciqt = idct_tables(liqt, ciqt)

    def decompress(self, data: bytes):
        w, h = self.width, self.height
        mv = memoryview(data)
        pos = 0
        blocks = []
        n_mb = (h // 16) * (w // 16)
        for _ in range(n_mb):
            for b in range(6):
                qt = self.liqt if b < 4 else self.ciqt
                b8 = self.lb8 if b < 4 else self.cb8
                blk, pos = s2b(mv, pos, b8, qt)
                blocks.append(blk)
        pix = idct_blocks(np.stack(blocks))
        y = np.empty((h, w), np.uint8)
        u = np.empty((h // 2, w // 2), np.uint8)
        v = np.empty((h // 2, w // 2), np.uint8)
        k = 0
        for by in range(0, h, 16):
            for bx in range(0, w, 16):
                y[by:by + 8, bx:bx + 8] = pix[k]
                y[by:by + 8, bx + 8:bx + 16] = pix[k + 1]
                y[by + 8:by + 16, bx:bx + 8] = pix[k + 2]
                y[by + 8:by + 16, bx + 8:bx + 16] = pix[k + 3]
                cy, cx = by // 2, bx // 2
                u[cy:cy + 8, cx:cx + 8] = pix[k + 4]
                v[cy:cy + 8, cx:cx + 8] = pix[k + 5]
                k += 6
        return y, u, v
