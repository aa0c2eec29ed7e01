"""Baseline JPEG encode: the pixels on the card, the bits on the host.

The JAX package's ``movjpeg`` encoder (``modules/importers/
mov_import.py``) writes each frame through PIL
(``Image.fromarray(rgb).save(buf, "JPEG", quality=q)``, libjpeg-turbo
underneath); the machine with the card has no PIL, so the port encodes
JPEG itself and gives PIL's bytes, in three steps:

- On the card, one launch of each kernel covers a batch of RGB24 frames
  of one size (``ops/kernels.py``): ``jpeg_ycc_down`` converts to YCbCr
  as libjpeg-turbo's ``jccolor.c`` ``rgb_ycc_convert`` does (SCALEBITS
  16, ``ONE_HALF - 1`` rounding on Cb and Cr), downsamples the chroma as
  ``jcsample.c`` ``h2v2_downsample`` does (bias 1, 2 alternating along a
  row) and writes each component's plane padded to whole MCUs: the last
  column repeated (``expand_right_edge``) and the last row
  (``jcprepct.c`` ``expand_bottom_edge``, the chroma's after
  downsampling).  ``jpeg_fdct_quant`` runs ``jfdctint.c``
  ``jpeg_fdct_islow`` on every block and quantizes it as ``jcdctmgr.c``
  ``quantize`` does, through ``compute_reciprocal``'s reciprocal,
  correction and shift (``divisors`` here), and writes the blocks in the
  order the Huffman coder reads them: MCU after MCU (four Y blocks, Cb,
  Cr), 64 coefficients in zigzag order.  A block past the image's right
  or bottom edge in an MCU is ``jccoefct.c`` ``compress_data``'s dummy:
  zero AC and the DC of the block before it (left of it, or at the
  right of the MCU's row above).  ``ycc_down_ref`` and
  ``fdct_quant_ref`` are the plain versions, in integer arithmetic.
- On the host, ``csrc/jpeg_huffenc.cpp`` (g++ at first use, as the
  decoder's ``jpeg_entropy.cpp``) codes each frame's blocks as
  ``jchuff.c`` ``encode_one_block`` does with the standard tables of
  ITU T.81 Annex K: DC differences per component from 0 at each frame,
  AC run lengths with ZRL and EOB, 0xFF stuffed with 0x00, the last byte
  padded with 1-bits.  A frame's scan is one serial bit stream (no
  restart markers), so frames are coded side by side on host threads.
- ``header`` writes what ``jcmarker.c`` writes before the scan, as PIL
  leaves the settings: SOI, APP0 JFIF 1.01 (density 1:1, no unit), DQT
  0 and 1 (``jcparam.c`` ``jpeg_set_quality`` with ``force_baseline``),
  SOF0 (Y 2x2, Cb and Cr 1x1), DHT DC 0, AC 0, DC 1, AC 1 and SOS.

The tables of the decoder (``io/jpeg.py`` ``STD_TABLES``, ``NATURAL``)
serve both directions.
"""

from __future__ import annotations

import ctypes
import struct
from functools import lru_cache
from typing import List, NamedTuple

import numpy as np
import torch

from tcforge_tpu_torch.io.jpeg import NATURAL, STD_TABLES
from tcforge_tpu_torch.ops import _build

# jcparam.c std_luminance_quant_tbl and std_chrominance_quant_tbl, in
# natural order
_STD_QUANT = (
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     *([99] * 32)))
# the blocks of an MCU (4:2:0): four Y blocks in rows, Cb, Cr
MCU_BLOCKS = 6
# the most bytes a block can take in the scan: a 16-bit DC code and 11
# bits, 63 AC codes of 16 bits and 10, every byte stuffed
BLOCK_BYTES_MAX = 2 * ((16 + 11 + 63 * 26 + 7) // 8)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class EncGeometry(NamedTuple):
    """A frame of ``width`` x ``height`` as the encoder lays it out: the
    MCU grid (16 x 16 pixels each), the Y blocks the image really has
    (``yw`` x ``yh``, the rest of the grid dummies) and the padded planes
    (Y ``16 mcuy`` x ``16 mcux``, then Cb and Cr ``8 mcuy`` x ``8
    mcux``, ``plane_bytes`` in all); ``blocks`` a frame."""

    width: int
    height: int
    mcux: int
    mcuy: int
    yw: int
    yh: int

    @property
    def blocks(self) -> int:
        return self.mcux * self.mcuy * MCU_BLOCKS

    @property
    def y_size(self) -> int:
        return 256 * self.mcux * self.mcuy

    @property
    def plane_bytes(self) -> int:
        return self.y_size + 2 * 64 * self.mcux * self.mcuy


def enc_geometry(width: int, height: int) -> EncGeometry:
    if width < 1 or height < 1 or width > 65535 or height > 65535:
        raise ValueError(f"jpeg: {width}x{height} is not a JPEG size")
    return EncGeometry(width, height, _ceil(width, 16), _ceil(height, 16),
                       _ceil(width, 8), _ceil(height, 8))


def quant_tables(quality: int) -> np.ndarray:
    """uint8 (2, 64) natural-order tables of ``jpeg_set_quality(quality,
    force_baseline=TRUE)``: ``jpeg_quality_scaling``, then ``(basic *
    scale + 50) / 100`` clamped to 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    basic = np.array(_STD_QUANT, np.int64)
    return np.clip((basic * scale + 50) // 100, 1, 255).astype(np.uint8)


def divisors(tables: np.ndarray) -> np.ndarray:
    """int32 (2, 3, 64): ``jcdctmgr.c`` ``compute_reciprocal`` of each
    entry's divisor ``q << 3`` (the islow DCT's outputs are 8 times the
    true DCT's) with 16-bit DCTELEMs, as libjpeg-turbo's SIMD build has
    them: the reciprocal, the correction (the rounding) and the shift
    ``r``; a coefficient ``x`` quantizes to ``sign(x) * (((|x| + corr) *
    recip) >> r)``."""
    out = np.zeros((2, 3, 64), np.int32)
    for t in range(2):
        for i in range(64):
            d = int(tables[t, i]) << 3
            b = d.bit_length() - 1
            r = 16 + b
            fq, fr = divmod(1 << r, d)
            c = d // 2
            if fr == 0:
                fq >>= 1
                r -= 1
            elif fr <= d // 2:
                c += 1
            else:
                fq += 1
            out[t, :, i] = (fq, c, r)
    return out


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


@lru_cache(maxsize=None)
def header(width: int, height: int, quality: int) -> bytes:
    """The bytes of a frame before its scan, as libjpeg-turbo writes them
    with PIL's settings."""
    tables = quant_tables(quality)
    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(2):
        out.append(_marker(0xDB, bytes([t]) + tables[t][NATURAL].tobytes()))
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for t in range(2):
        for kind, cls in (("dc", 0), ("ac", 1)):
            bits, vals = STD_TABLES[(kind, t)]
            out.append(_marker(0xC4, bytes([cls << 4 | t, *bits]) + vals))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                    0])))
    return b"".join(out)


@lru_cache(maxsize=None)
def huffman_codes() -> tuple:
    """uint32 codes and uint8 lengths (4, 256) of the standard tables
    (DC 0, AC 0, DC 1, AC 1), as ``jchuff.c``
    ``jpeg_make_c_derived_tbl`` builds them from their bits and
    symbols."""
    codes = np.zeros((4, 256), np.uint32)
    sizes = np.zeros((4, 256), np.uint8)
    for k, key in enumerate((("dc", 0), ("ac", 0), ("dc", 1), ("ac", 1))):
        bits, vals = STD_TABLES[key]
        code, sym = 0, 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                codes[k, vals[sym]] = code
                sizes[k, vals[sym]] = length
                code += 1
                sym += 1
            code <<= 1
    return codes, sizes


# --------------------------------------------------------------------- #
# the plain versions of the two kernels

def _index(n: int, limit: int, device) -> torch.Tensor:
    return torch.arange(n, device=device).clamp(max=limit - 1)


def ycc_down_ref(rgb: torch.Tensor, geom: EncGeometry) -> torch.Tensor:
    """Plain version of ``jpeg_ycc_down``: uint8 (frames, height, width,
    3) RGB24 to uint8 (frames, plane_bytes), the padded Y plane, then
    Cb's and Cr's, in int32 arithmetic."""
    dev = rgb.device
    h, w = geom.height, geom.width
    frames = rgb.shape[0]
    # Y: the pixel at each padded position, the last row and column
    # repeated
    rows = _index(16 * geom.mcuy, h, dev)
    cols = _index(16 * geom.mcux, w, dev)
    p = rgb[:, rows][:, :, cols].to(torch.int32)
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    # Cb and Cr at full resolution over the input rows of each chroma
    # row (the last chroma row repeated below the image), then the 2x2
    # sums with the bias 1, 2, 1, 2, ...
    crow = _index(8 * geom.mcuy, _ceil(h, 2), dev)
    ccol = torch.arange(8 * geom.mcux, device=dev)
    r2 = torch.stack((2 * crow, (2 * crow + 1).clamp(max=h - 1)), 1)
    c2 = torch.stack((2 * ccol, 2 * ccol + 1), 1).clamp(max=w - 1)
    q = rgb[:, r2.reshape(-1)][:, :, c2.reshape(-1)].to(torch.int32)
    r, g, b = q[..., 0], q[..., 1], q[..., 2]
    half = (128 << 16) + 32767
    cb = (-11059 * r - 21709 * g + 32768 * b + half) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + half) >> 16
    bias = 1 + (ccol & 1)

    def down(c: torch.Tensor) -> torch.Tensor:
        c = c.view(frames, 8 * geom.mcuy, 2, 8 * geom.mcux, 2)
        return (c.sum((2, 4)) + bias) >> 2

    return torch.cat([t.reshape(frames, -1) for t in
                      (y, down(cb), down(cr))], 1).to(torch.uint8)


@lru_cache(maxsize=None)
def block_sources(geom: EncGeometry) -> tuple:
    """For each block of a frame in the coder's order: the offset of its
    source block's first sample in the frame's planes, the row stride of
    that plane, its table set and whether it is a dummy (zero AC, the
    DC of its source)."""
    offs, strides, tabs, dummies = [], [], [], []
    cw = 8 * geom.mcux
    for my in range(geom.mcuy):
        for mx in range(geom.mcux):
            for k in range(4):
                by, bx = 2 * my + (k >> 1), 2 * mx + (k & 1)
                dummy = by >= geom.yh or bx >= geom.yw
                if by >= geom.yh:        # a row under the image
                    by, bx = geom.yh - 1, min(2 * mx + 1, geom.yw - 1)
                bx = min(bx, geom.yw - 1)
                offs.append(by * 8 * 16 * geom.mcux + bx * 8)
                strides.append(16 * geom.mcux)
                tabs.append(0)
                dummies.append(dummy)
            for c in range(2):
                offs.append(geom.y_size + c * 64 * geom.mcux * geom.mcuy
                            + my * 8 * cw + mx * 8)
                strides.append(cw)
                tabs.append(1)
                dummies.append(False)
    return (np.array(offs, np.int64), np.array(strides, np.int64),
            np.array(tabs, np.int64), np.array(dummies, bool))


def _fdct_1d(d: List[torch.Tensor], pass1: bool) -> List[torch.Tensor]:
    """One pass of ``jpeg_fdct_islow`` over eight int32 tensors."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = 11 if pass1 else 15

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    o = [None] * 8
    if pass1:
        o[0], o[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
    else:
        o[0], o[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
    z1 = (tmp12 + tmp13) * 4433
    o[2] = descale(z1 + tmp13 * 6270, shift)
    o[6] = descale(z1 - tmp12 * 15137, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819
    tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o[7] = descale(tmp4 + z1 + z3, shift)
    o[5] = descale(tmp5 + z2 + z4, shift)
    o[3] = descale(tmp6 + z2 + z3, shift)
    o[1] = descale(tmp7 + z1 + z4, shift)
    return o


def fdct_quant_ref(planes: torch.Tensor, div: torch.Tensor,
                   geom: EncGeometry) -> torch.Tensor:
    """Plain version of ``jpeg_fdct_quant``: uint8 (frames, plane_bytes)
    planes and int32 (2, 3, 64) divisors to int16 (frames, blocks, 64)
    quantized coefficients in the coder's order, zigzag within a
    block."""
    dev = planes.device
    offs, strides, tabs, dummies = block_sources(geom)
    r8 = torch.arange(8, device=dev)
    idx = (torch.from_numpy(offs).to(dev)[:, None, None]
           + r8[None, :, None] * torch.from_numpy(strides).to(dev)[:, None,
                                                                   None]
           + r8[None, None, :])                       # (blocks, 8, 8)
    s = planes[:, idx].to(torch.int32) - 128          # (frames, blocks, 8, 8)
    rows = _fdct_1d([s[..., k] for k in range(8)], True)
    s = torch.stack(rows, -1)                          # pass 1 over rows
    cols = _fdct_1d([s[..., k, :] for k in range(8)], False)
    x = torch.stack(cols, -2).reshape(*s.shape[:2], 64).to(torch.int64)
    d = div.to(dev, torch.int64)[torch.from_numpy(tabs).to(dev)]
    recip, corr, shift = d[:, 0], d[:, 1], d[:, 2]     # (blocks, 64)
    q = ((x.abs() + corr) * recip) >> shift
    q = torch.where(x < 0, -q, q)
    ac = torch.from_numpy(~dummies).to(dev)
    q[:, :, 1:] *= ac[:, None]
    return q[:, :, torch.from_numpy(NATURAL).to(dev)].to(torch.int16)


# --------------------------------------------------------------------- #
# the host Huffman coder

@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """``csrc/jpeg_huffenc.cpp``, built with g++ at first use."""
    lib = _build.load_host("jpeg_huffenc")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.tc_jpeg_huff_encode.argtypes = (p, ll, ctypes.c_int, p, p, p, ll,
                                         p)
    lib.tc_jpeg_huff_encode.restype = ctypes.c_int
    return lib


def entropy_code(coef: np.ndarray, geom: EncGeometry) -> List[bytes]:
    """The scans of a batch: int16 (frames, blocks, 64) coefficients in
    the coder's order, one bytes a frame (up to, without, its EOI)."""
    coef = np.ascontiguousarray(coef, np.int16)
    frames = coef.shape[0]
    if coef.shape[1:] != (geom.blocks, 64):
        raise ValueError(f"coef: {coef.shape}, expected (frames, "
                         f"{geom.blocks}, 64)")
    codes, sizes = huffman_codes()
    cap = geom.blocks * BLOCK_BYTES_MAX + 16
    out = np.empty(frames * cap, np.uint8)
    lengths = np.zeros(frames, np.int64)
    if frames:
        rc = library().tc_jpeg_huff_encode(
            coef.ctypes.data, frames, geom.blocks, codes.ctypes.data,
            sizes.ctypes.data, out.ctypes.data, cap, lengths.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"jpeg: the Huffman coder failed ({rc})")
    return [out[f * cap:f * cap + int(lengths[f])].tobytes()
            for f in range(frames)]


@lru_cache(maxsize=None)
def _divisors_on(quality: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(divisors(quant_tables(quality))).to(device)


def coefficients(rgb: torch.Tensor, quality: int) -> torch.Tensor:
    """The quantized coefficients of a batch of uint8 (frames, height,
    width, 3) RGB24 frames at ``quality``, on the batch's device: one
    launch of each kernel (their plain versions on the CPU)."""
    from tcforge_tpu_torch.ops import kernels
    geom = enc_geometry(rgb.shape[2], rgb.shape[1])
    planes = kernels.jpeg_ycc_down(rgb.contiguous(), geom)
    return kernels.jpeg_fdct_quant(planes, _divisors_on(quality, rgb.device),
                                   geom)


def download(coef: torch.Tensor) -> np.ndarray:
    """The coefficients in host memory, for the Huffman coder."""
    return coef.cpu().numpy()


def encode_rgb(rgb: torch.Tensor, quality: int) -> List[bytes]:
    """JPEG files of a batch of uint8 (frames, height, width, 3) RGB24
    frames at ``quality``: the two kernels on the batch's device, one
    download of the coefficients, the host coder; header and EOI around
    each frame's scan."""
    height, width = rgb.shape[1:3]
    geom = enc_geometry(width, height)
    coef = download(coefficients(rgb, quality))
    head = header(width, height, quality)
    return [head + scan + b"\xff\xd9" for scan in entropy_code(coef, geom)]
