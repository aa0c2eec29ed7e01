"""Baseline JPEG decode: the headers on the host, the pixels on the card.

The JAX package decodes Motion-JPEG AVI chunks and QuickTime photo-JPEG
samples through PIL (``Image.open(...).convert("RGB")``, libjpeg-turbo
underneath); the machine with the card has no PIL, so the port decodes
them itself, in three steps, and gives PIL's bytes:

- ``read_headers`` reads the markers that libjpeg reads up to the first
  scan: SOI, APPn (JFIF, ``AVI1``, Adobe APP14 and its ``transform``),
  DQT (8- and 16-bit tables), DHT, SOF0 and SOF1 (8-bit Huffman
  sequential), DRI, COM; ``Geometry`` works out the components'
  sampling, the MCU layout, each component's padded block grid and its
  real size ``ceil(dim * samp / max_samp)``, the colour space
  (``jdapimin.c`` ``default_decompress_parms``: JFIF, Adobe's
  transform, else the component ids) and each component's upsampling
  (``jdsample.c`` ``jinit_upsampler``).  What the port does not decode
  raises ``NotImplementedError`` naming it: progressive (SOF2), lossless
  (SOF3), hierarchical (SOF5-7) and arithmetic-coded (SOF9 and up)
  JPEG, 12-bit samples, four components (CMYK/YCCK), a height given by
  a DNL marker.
- ``decode_scans`` runs each scan's Huffman decode through the host
  library ``csrc/jpeg_entropy.cpp`` (g++ at first use, as the MPEG-2
  parse), which writes the quantized coefficients in natural order,
  64 int16 to a block, into each component's padded plane; a scan
  without a DHT for its table takes the standard table of ITU T.81
  Annex K, as libjpeg does.  The decode stops at the first EOI: a chunk
  that holds two field images (``AVI1`` interlaced MJPEG, QuickTime
  ``mjpa``) gives its first, as ``Image.open`` does, and trailing bytes
  are ignored.
- On the card, one launch of each kernel covers a batch of frames of
  one geometry (``ops/kernels.py`` ``jpeg_idct``: dequantization and
  libjpeg's ``jpeg_idct_islow`` through its range-limit table;
  ``jpeg_color``: libjpeg-turbo's upsampling and ``ycc_rgb_convert``,
  cropped to the image, RGB24).  ``idct_ref`` and ``color_ref`` here are
  their plain versions, in int32 arithmetic.

``JpegStream`` is the plan/execute protocol of an importer's JPEG video
track (``modules/importers/avi_import.py``, ``mov_import.py``): ``plan``
(the engine's reader thread) decodes a batch's chunks into a ring of
host buffers (pinned on a card), ``execute`` (the main thread) uploads
a buffer in one copy and runs the two kernels.
"""

from __future__ import annotations

import ctypes
import queue
import struct
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.ops import _build

# jutils.c jpeg_natural_order: the natural index of each zigzag position
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K.3 (jstdhuff.c): (bits[1..16], symbols) of the
# standard tables, DC and AC, 0 luminance and 1 chrominance
_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_TABLES = {
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                _AC_LUMA),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                _AC_CHROMA),
}

# colour spaces of a frame (the kernel's codes)
YCC, RGB, GRAY = 0, 1, 2
# upsampling of a component (jdsample.c): the full size, h2v1, h1v2 and
# h2v2 fancy upsampling, and replication (h2v1_upsample, h2v2_upsample,
# int_upsample)
UP_FULL, UP_H2V1, UP_H1V2, UP_H2V2, UP_REPLICATE = range(5)
# int16 quantizer values a frame in a staging buffer: four tables of 64
QT_PER_FRAME = 4 * 64

_SOF_REFUSED = {
    0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)",
    0xCF: "arithmetic-coded JPEG (SOF15)",
    0xCC: "arithmetic-coded JPEG (DAC)"}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"jpeg: {what} is not ported to the torch "
                               "port yet")


class CompGeom(NamedTuple):
    """One component of a frame: its sampling factors ``h`` and ``v``,
    its padded plane of ``bw`` x ``bh`` blocks, the blocks it really has
    (``wib`` x ``hib``), its real size ``dw`` x ``dh`` in samples, the
    first block of its plane within the frame (``off``), and its
    upsampling (``up``, with the factors ``hf`` and ``vf``)."""

    h: int
    v: int
    bw: int
    bh: int
    wib: int
    hib: int
    dw: int
    dh: int
    off: int
    up: int
    hf: int
    vf: int


class Geometry(NamedTuple):
    """What a launch of the two kernels needs to know of its frames
    (every frame of a launch has the same): the image's size, its colour
    space, the MCU grid and its components; ``blocks`` a frame."""

    width: int
    height: int
    color: int
    mcux: int
    mcuy: int
    comps: Tuple[CompGeom, ...]
    blocks: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def geometry(width: int, height: int, color: int,
             sampling: List[Tuple[int, int]]) -> Geometry:
    """The frame geometry of an image of ``width`` x ``height`` whose
    components have the ``(h, v)`` sampling factors ``sampling``
    (``jdinput.c`` ``initial_setup``, ``jdsample.c`` ``jinit_upsampler``
    with fancy upsampling on, as PIL leaves it)."""
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcux, mcuy = _ceil(width, 8 * max_h), _ceil(height, 8 * max_v)
    comps, off = [], 0
    for h, v in sampling:
        if max_h % h or max_v % v:
            raise not_ported(f"fractional sampling ({h}x{v} of "
                             f"{max_h}x{max_v})")
        wib = _ceil(width * h, 8 * max_h)
        hib = _ceil(height * v, 8 * max_v)
        dw, dh = _ceil(width * h, max_h), _ceil(height * v, max_v)
        bw, bh = (wib, hib) if len(sampling) == 1 else (mcux * h, mcuy * v)
        hf, vf = max_h // h, max_v // v
        if hf == 1 and vf == 1:
            up = UP_FULL
        elif hf == 2 and vf == 1:
            up = UP_H2V1 if dw > 2 else UP_REPLICATE
        elif hf == 1 and vf == 2:
            up = UP_H1V2
        elif hf == 2 and vf == 2:
            up = UP_H2V2 if dw > 2 else UP_REPLICATE
        else:
            up = UP_REPLICATE
        comps.append(CompGeom(h, v, bw, bh, wib, hib, dw, dh, off, up,
                              hf, vf))
        off += bw * bh
    return Geometry(width, height, color, mcux, mcuy, tuple(comps), off)


@dataclass
class Header:
    """A JPEG's headers up to its first scan: the frame (size, components
    ``(id, h, v, quant table)``), the tables and restart interval in
    force, the markers that decide the colour space, and ``pos``, the
    offset of the first SOS marker."""

    width: int = 0
    height: int = 0
    comps: List[Tuple[int, int, int, int]] = field(default_factory=list)
    qt: Dict[int, np.ndarray] = field(default_factory=dict)
    huff: Dict[Tuple[str, int], Tuple[bytes, bytes]] = field(
        default_factory=dict)
    restart: int = 0
    jfif: bool = False
    adobe: Optional[int] = None
    pos: int = 0

    @property
    def color(self) -> int:
        """``jdapimin.c`` ``default_decompress_parms``."""
        if len(self.comps) == 1:
            return GRAY
        if self.jfif:
            return YCC
        if self.adobe is not None:
            return RGB if self.adobe == 0 else YCC
        ids = tuple(c[0] for c in self.comps)
        return RGB if ids == (82, 71, 66) else YCC

    @property
    def geometry(self) -> Geometry:
        return geometry(self.width, self.height, self.color,
                        [(h, v) for _, h, v, _ in self.comps])


def _segment(data: bytes, pos: int) -> Tuple[int, int, int]:
    """The marker at or after ``pos`` (fill bytes skipped): its code, the
    offset of its 0xFF and the offset past its segment."""
    n = len(data)
    while pos < n and data[pos] != 0xFF:
        pos += 1
    while pos + 1 < n and data[pos + 1] == 0xFF:
        pos += 1
    if pos + 1 >= n:
        raise ValueError("jpeg: the data ends before EOI")
    code = data[pos + 1]
    if code == 0xD8 or code == 0x01 or 0xD0 <= code <= 0xD9:
        return code, pos, pos + 2
    if pos + 4 > n:
        raise ValueError("jpeg: a marker segment is cut")
    length = struct.unpack_from(">H", data, pos + 2)[0]
    if length < 2 or pos + 2 + length > n:
        raise ValueError(f"jpeg: marker 0x{code:02X} has a bad length")
    return code, pos, pos + 2 + length


def _tables(head: Header, code: int, seg: memoryview) -> None:
    """A DQT, DHT or DRI segment's tables into ``head``."""
    if code == 0xDB:                       # DQT
        i = 0
        while i < len(seg):
            pq, tq = seg[i] >> 4, seg[i] & 15
            size = 128 if pq else 64
            if tq > 3 or i + 1 + size > len(seg):
                raise ValueError("jpeg: a bad DQT segment")
            vals = np.frombuffer(seg[i + 1:i + 1 + size],
                                 ">u2" if pq else np.uint8)
            table = np.zeros(64, np.int32)
            table[NATURAL] = vals
            head.qt[tq] = table
            i += 1 + size
    elif code == 0xC4:                     # DHT
        i = 0
        while i < len(seg):
            if i + 17 > len(seg):
                raise ValueError("jpeg: a bad DHT segment")
            tc, th = seg[i] >> 4, seg[i] & 15
            bits = bytes(seg[i + 1:i + 17])
            count = sum(bits)
            if tc > 1 or th > 3 or count > 256 \
                    or i + 17 + count > len(seg):
                raise ValueError("jpeg: a bad DHT segment")
            head.huff[("dc" if tc == 0 else "ac", th)] = (
                bits, bytes(seg[i + 17:i + 17 + count]))
            i += 17 + count
    elif code == 0xDD:                     # DRI
        if len(seg) != 2:
            raise ValueError("jpeg: a bad DRI segment")
        head.restart = struct.unpack_from(">H", seg)[0]


def read_headers(data: bytes) -> Header:
    """The headers of the JPEG in ``data`` up to its first scan."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("jpeg: no SOI marker")
    head = Header()
    mv = memoryview(data)
    pos, sof = 2, False
    while True:
        code, at, nxt = _segment(data, pos)
        seg = mv[at + 4:nxt]
        if code in _SOF_REFUSED:
            raise not_ported(_SOF_REFUSED[code])
        if code in (0xC0, 0xC1):
            if sof:
                raise ValueError("jpeg: two SOF markers")
            sof = True
            precision, height, width, n = struct.unpack_from(">BHHB", seg)
            if precision != 8:
                raise not_ported(f"{precision}-bit samples")
            if n == 4:
                raise not_ported("four-component (CMYK/YCCK) JPEG")
            if n not in (1, 3):
                raise not_ported(f"{n}-component JPEG")
            if height == 0:
                raise not_ported("a height given by a DNL marker")
            if width == 0 or len(seg) < 6 + 3 * n:
                raise ValueError("jpeg: a bad SOF segment")
            for k in range(n):
                cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise ValueError("jpeg: a bad SOF component")
                head.comps.append((cid, h, v, tq))
            head.width, head.height = width, height
            if n > 1 and sum(h * v for _, h, v, _ in head.comps) > 10:
                raise ValueError("jpeg: sampling factors too large for "
                                 "an interleaved scan")
        elif code == 0xDA:                 # SOS
            if not sof:
                raise ValueError("jpeg: SOS before SOF")
            head.pos = at
            return head
        elif code == 0xD9:
            raise ValueError("jpeg: EOI before the first scan")
        elif code == 0xE0:
            head.jfif |= len(seg) >= 14 and bytes(seg[:5]) == b"JFIF\0"
        elif code == 0xEE:
            if len(seg) >= 12 and bytes(seg[:5]) == b"Adobe":
                head.adobe = seg[11]
        else:
            _tables(head, code, seg)
        pos = nxt


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The entropy decoder (``csrc/jpeg_entropy.cpp``), built and loaded
    at first use; raises if the build fails."""
    lib = _build.load_host("jpeg_entropy")
    f = lib.tc_jpeg_scan
    f.restype = ctypes.c_longlong
    f.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                  np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                  np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                  ctypes.c_void_p]
    return lib


_SCAN_ERRORS = {-1: "a Huffman table is missing or bad",
                -2: "a Huffman code no table holds",
                -3: "a restart marker is missing",
                -4: "a bad scan"}


def _scan_tables(head: Header) -> np.ndarray:
    """The eight tables a scan may name (DC 0-3, AC 0-3) as the entropy
    decoder takes them: 273 bytes each, the code counts at [1..16] and
    the symbols after; an absent table 0 or 1 is the standard one."""
    out = np.zeros((8, 273), np.uint8)
    for k, kind in enumerate(("dc", "ac")):
        for t in range(4):
            got = head.huff.get((kind, t)) or STD_TABLES.get((kind, t))
            if got is not None:
                bits, vals = got
                out[4 * k + t, 1:17] = tuple(bits)
                out[4 * k + t, 17:17 + len(vals)] = np.frombuffer(
                    bytes(vals), np.uint8)
    return out


def decode_scans(head: Header, data: bytes, geom: Geometry,
                 coef: np.ndarray, qt: np.ndarray) -> None:
    """Each scan of the image from ``head.pos`` to its EOI: coefficients
    into ``coef`` (int16 (geom.blocks, 64), C-contiguous, zeroed by the
    caller) and each component's quantizer, as libjpeg latches it at the
    component's first scan, into ``qt`` (int16 (4, 64): a 16-bit table
    keeps its values' bits)."""
    lib = library()
    mv = memoryview(data)
    latched = [False] * len(head.comps)
    pos = head.pos
    ptr = coef.ctypes.data
    while True:
        code, at, nxt = _segment(data, pos)
        seg = mv[at + 4:nxt]
        if code == 0xD9:
            return
        if code == 0xDA:
            n = seg[0] if len(seg) else 0
            if not 1 <= n <= 4 or len(seg) < 1 + 2 * n + 3:
                raise ValueError("jpeg: a bad SOS segment")
            spec = np.zeros(4 + 8 * n, np.int32)
            for k in range(n):
                cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
                ci = next((i for i, c in enumerate(head.comps)
                           if c[0] == cid), None)
                if ci is None:
                    raise ValueError(f"jpeg: SOS names component {cid}")
                c = geom.comps[ci]
                if not latched[ci]:
                    table = head.qt.get(head.comps[ci][3])
                    if table is None:
                        raise ValueError("jpeg: a quantization table is "
                                         "missing")
                    qt[ci] = table.astype(np.uint16).view(np.int16)
                    latched[ci] = True
                hv = (1, 1) if n == 1 else (c.h, c.v)
                spec[4 + 8 * k:12 + 8 * k] = (
                    *hv, c.bw, c.off, tables >> 4, tables & 15, c.wib,
                    c.hib)
                if n == 1:
                    spec[1:3] = c.wib, c.hib
            if n > 1:
                spec[1:3] = geom.mcux, geom.mcuy
            spec[0], spec[3] = n, head.restart
            end = lib.tc_jpeg_scan(data, len(data), nxt, spec,
                                   _scan_tables(head), ptr)
            if end < 0:
                raise ValueError(f"jpeg: {_SCAN_ERRORS.get(end, end)}")
            pos = end
            continue
        if code == 0xDC:
            raise not_ported("a DNL marker")
        if code in _SOF_REFUSED or code in (0xC0, 0xC1):
            raise ValueError("jpeg: a second frame header")
        _tables(head, code, seg)
        pos = nxt


def decode_coefficients(data: bytes):
    """One JPEG's geometry, coefficients (int16 (blocks, 64)) and
    quantizers (int16 (4, 64)): the host half of the decode alone."""
    head = read_headers(data)
    geom = head.geometry
    coef = np.zeros((geom.blocks, 64), np.int16)
    qt = np.zeros((4, 64), np.int16)
    decode_scans(head, data, geom, coef, qt)
    return geom, coef, qt


# --------------------------------------------------------------------- #
# the plain versions of the two kernels (int32)

# jidctint.c FIX() constants at CONST_BITS 13
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(d, shift: int):
    """One pass of ``jpeg_idct_islow`` over the eight int32 tensors
    ``d`` (the inputs 0..7 of each line), each output descaled by
    ``shift`` (arithmetic in int32, wrapping as the card's does)."""
    c = _C
    z1 = (d[2] + d[6]) * c["f0541"]
    tmp2 = z1 + d[6] * -c["f1847"]
    tmp3 = z1 + d[2] * c["f0765"]
    tmp0 = (d[0] + d[4]) * 8192
    tmp1 = (d[0] - d[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["f1175"]
    t0 = t0 * c["f0298"]
    t1 = t1 * c["f2053"]
    t2 = t2 * c["f3072"]
    t3 = t3 * c["f1501"]
    z1 = z1 * -c["f0899"]
    z2 = z2 * -c["f2562"]
    z3 = z3 * -c["f1961"] + z5
    z4 = z4 * -c["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(x + half) >> shift for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0,
        tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """``jdmaster.c`` ``prepare_range_limit_table``'s post-IDCT table at
    ``x & 1023``: x + 128 clamped for x in [-512, 512), wrapping beyond
    (uint8)."""
    m = x & 1023
    return torch.where(m < 512, (m + 128).clamp(max=255),
                       (m - 896).clamp(min=0)).to(torch.uint8)


def _block_comps(geom: Geometry, nblocks: int, device) -> torch.Tensor:
    """Each block's index into the frames' quantizer tables: frame * 4 +
    its component."""
    r = torch.arange(nblocks, device=device)
    comp = torch.zeros(nblocks, dtype=torch.long, device=device)
    for k, c in enumerate(geom.comps[1:], 1):
        comp += ((r % geom.blocks) >= c.off).long()
    return (r // geom.blocks) * 4 + comp


def idct_ref(coef: torch.Tensor, qt: torch.Tensor,
             geom: Geometry) -> torch.Tensor:
    """Plain version of ``jpeg_idct``: uint8 (blocks, 64) samples of the
    int16 (blocks, 64) natural-order coefficients, dequantized by
    ``qt`` (int16 (frames, 4, 64), the values' low 16 bits), through
    ``jpeg_idct_islow`` (CONST_BITS 13, PASS1_BITS 2) and the range-limit
    table."""
    q = (qt.reshape(-1, 64).to(torch.int32) & 0xFFFF)[
        _block_comps(geom, coef.shape[0], coef.device)]
    x = (coef.to(torch.int32) * q).view(-1, 8, 8)
    cols = _idct_1d([x[:, r, :] for r in range(8)], 11)    # pass 1
    ws = torch.stack(cols, 1)                               # (B, row, col)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 18)   # pass 2
    return range_limit(torch.stack(rows, 2)).reshape(-1, 64)


def _planes(samples: torch.Tensor, geom: Geometry) -> List[torch.Tensor]:
    """Each component's padded plane (frames, 8 bh, 8 bw), int32."""
    per = samples.view(-1, geom.blocks, 8, 8)
    out = []
    for c in geom.comps:
        p = per[:, c.off:c.off + c.bw * c.bh].reshape(-1, c.bh, c.bw, 8, 8)
        out.append(p.permute(0, 1, 3, 2, 4).reshape(
            -1, 8 * c.bh, 8 * c.bw).to(torch.int32))
    return out


def _upsample(p: torch.Tensor, c: CompGeom, width: int, height: int
              ) -> torch.Tensor:
    """A component's samples at every pixel of the image (``jdsample.c``):
    the neighbours of the fancy forms are those of its real size
    (``dw`` x ``dh``), the rows above and below the image repeating its
    first and last (``jdmainct.c``'s context rows)."""
    dev = p.device
    y = torch.arange(height, device=dev)
    x = torch.arange(width, device=dev)
    if c.up == UP_FULL:
        return p[:, :height, :width]
    if c.up == UP_REPLICATE:
        return p[:, y // c.vf][:, :, x // c.hf]
    if c.up == UP_H2V1:
        col, odd = x // 2, x % 2
        near = (col + 2 * odd - 1).clamp(0, c.dw - 1)
        rows = p[:, :height]
        return (3 * rows[:, :, col] + rows[:, :, near] + 1 + odd) >> 2
    row, odd = y // 2, (y % 2)
    near = (row + 2 * odd - 1).clamp(0, c.dh - 1)
    colsum = 3 * p[:, row] + p[:, near]
    if c.up == UP_H1V2:
        return (colsum[:, :, :width] + 1 + odd[:, None]) >> 2
    col, xodd = x // 2, x % 2
    far = (col + 2 * xodd - 1).clamp(0, c.dw - 1)
    return (3 * colsum[:, :, col] + colsum[:, :, far] + 8 - xodd) >> 4


def color_ref(samples: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """Plain version of ``jpeg_color``: the frames' RGB24 pixels, uint8
    (frames, height, width, 3), from ``jpeg_idct``'s samples: each
    component upsampled (``_upsample``), then ``jdcolor.c``
    ``ycc_rgb_convert`` (SCALEBITS 16, ``FIX()`` rounding, clamped), RGB
    as it is, gray to all three."""
    planes = [_upsample(p, c, geom.width, geom.height)
              for p, c in zip(_planes(samples, geom), geom.comps)]
    if geom.color == GRAY:
        rgb = [planes[0]] * 3
    elif geom.color == RGB:
        rgb = planes
    else:
        y, cb, cr = planes[0], planes[1] - 128, planes[2] - 128
        rgb = [y + ((91881 * cr + 32768) >> 16),
               y + ((-22554 * cb - 46802 * cr + 32768) >> 16),
               y + ((116130 * cb + 32768) >> 16)]
    return torch.stack(rgb, -1).clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------------- #
# the plan/execute protocol of a JPEG video track

class _Staging:
    """A host buffer of a batch's frames: ``tcap`` frames' quantizers
    (``QT_PER_FRAME`` int16 each) then the coefficient blocks, 64 int16
    each; pinned on a card, where ``event`` marks the end of its last
    upload, which a refill waits for."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.event = None
        self.tcap = 0
        self.flat = torch.empty(0, dtype=torch.int16)

    def _alloc(self, n: int) -> torch.Tensor:
        return (torch.empty(n, dtype=torch.int16, pin_memory=True)
                if self.pinned else torch.empty(n, dtype=torch.int16))

    def reset(self, frames: int) -> None:
        """Room for the quantizers of ``frames`` frames."""
        if frames > self.tcap:
            self.tcap = frames
            self.flat = self._alloc(frames * QT_PER_FRAME + 64 * 8192)

    def room(self, blocks: int) -> None:
        """Room for ``blocks`` coefficient blocks, what is there kept."""
        need = self.tcap * QT_PER_FRAME + 64 * blocks
        if need > self.flat.numel():
            old = self.flat
            self.flat = self._alloc(max(need, 2 * old.numel()))
            self.flat[:old.numel()].copy_(old)

    def coef(self, first: int, count: int) -> np.ndarray:
        at = self.tcap * QT_PER_FRAME + 64 * first
        return self.flat.numpy()[at:at + 64 * count].reshape(count, 64)

    def qt(self, frame: int) -> np.ndarray:
        at = frame * QT_PER_FRAME
        return self.flat.numpy()[at:at + QT_PER_FRAME].reshape(4, 64)


class Run(NamedTuple):
    """Frames ``f0`` to ``f1`` of a plan, of one geometry, whose blocks
    are ``b0`` to ``b1``."""

    geom: Geometry
    f0: int
    f1: int
    b0: int
    b1: int


@dataclass
class JpegPlan:
    """One batch of the JPEG decode, decoded on the host (``plan``) and
    run on the device (``execute``): its staging buffer, its frames and
    their runs of one geometry."""

    buffer: Optional[_Staging]
    frames: List[int] = field(default_factory=list)
    runs: List[Run] = field(default_factory=list)
    blocks: int = 0

    @property
    def upload_elements(self) -> int:
        """The int16 values ``execute`` uploads: the quantizers' room and
        the blocks (none once the buffer is given back)."""
        if self.buffer is None:
            return 0
        return self.buffer.tcap * QT_PER_FRAME + 64 * self.blocks


class JpegStream:
    """The JPEG video track of an import module: ``plan`` decodes up to
    ``n`` chunks on the host into a staging buffer, ``execute`` turns a
    plan into frames on the device, one launch of each kernel for each
    run of frames of one geometry (one run a batch in practice)."""

    def __init__(self):
        self.device: Optional[torch.device] = None
        self.decoded = 0               # frames planned so far

    def start(self, device: torch.device, buffers: int = 1) -> None:
        """Decode onto ``device`` with a ring of ``buffers`` staging
        buffers (pinned on a card)."""
        self.device = torch.device(device)
        pinned = self.device.type == "cuda"
        self.pool: "queue.Queue[_Staging]" = queue.Queue()
        for _ in range(buffers):
            self.pool.put(_Staging(pinned))

    def _take(self, alive) -> Optional[_Staging]:
        while True:
            try:
                buf = self.pool.get(timeout=0.1)
                break
            except queue.Empty:
                if alive is not None and not alive():
                    return None
        if buf.event is not None:
            buf.event.synchronize()
            buf.event = None
        return buf

    def plan(self, next_chunk: Callable[[], Optional[bytes]], n: int,
             alive=None) -> Optional[JpegPlan]:
        """Decode the next ``n`` chunks that ``next_chunk`` gives (None at
        the end of the track) into a staging buffer: the batch's plan,
        or None when the track has ended."""
        if self.device is None:
            raise RuntimeError("JpegStream.start() was not called")
        buf = self._take(alive)
        if buf is None:
            return None
        plan = JpegPlan(buf)
        buf.reset(n)
        try:
            while len(plan.frames) < n:
                data = next_chunk()
                if data is None:
                    break
                self._add(plan, data)
        except BaseException:
            self.release(plan)
            raise
        if not plan.frames:
            self.release(plan)
            return None
        return plan

    def _add(self, plan: JpegPlan, data: bytes) -> None:
        head = read_headers(data)
        geom = head.geometry
        buf, f = plan.buffer, len(plan.frames)
        buf.room(plan.blocks + geom.blocks)
        coef = buf.coef(plan.blocks, geom.blocks)
        coef.fill(0)
        qt = buf.qt(f)
        qt.fill(0)
        decode_scans(head, data, geom, coef, qt)
        last = plan.runs[-1] if plan.runs else None
        if last is not None and last.geom == geom:
            plan.runs[-1] = last._replace(f1=f + 1,
                                          b1=last.b1 + geom.blocks)
        else:
            plan.runs.append(Run(geom, f, f + 1, plan.blocks,
                                 plan.blocks + geom.blocks))
        plan.frames.append(self.decoded)
        plan.blocks += geom.blocks
        self.decoded += 1

    def release(self, plan: JpegPlan) -> None:
        """Give back a plan's buffer without running it."""
        if plan.buffer is not None:
            self.pool.put(plan.buffer)
            plan.buffer = None

    def execute(self, plan: JpegPlan, copy_stream=None
                ) -> Optional[Dict[str, torch.Tensor]]:
        """Run ``plan`` on the device: ``{"rgb": uint8 (N, H, W, 3)}``
        on the device.  The upload is one copy of the buffer's quantizers
        and blocks, on ``copy_stream`` (when given, on a card), which the
        current stream waits for.  Frames of two sizes in one batch
        raise, as the JAX importer's ``np.stack`` does."""
        from tcforge_tpu_torch.ops import kernels
        buf, dev = plan.buffer, self.device
        n = plan.upload_elements
        if dev.type == "cuda":
            compute = torch.cuda.current_stream(dev)
            stream = copy_stream or compute
            if copy_stream is not None:
                copy_stream.wait_stream(compute)
            with torch.cuda.stream(stream):
                flat = torch.empty(n, dtype=torch.int16, device=dev)
                flat.copy_(buf.flat[:n], non_blocking=True)
                buf.event = torch.cuda.Event()
                buf.event.record(stream)
            if copy_stream is not None:
                compute.wait_event(buf.event)
                flat.record_stream(compute)
        else:
            flat = buf.flat[:n].clone()
        head = buf.tcap * QT_PER_FRAME
        self.release(plan)
        shown = []
        for run in plan.runs:
            coef = flat[head + 64 * run.b0:head + 64 * run.b1].view(-1, 64)
            qt = flat[run.f0 * QT_PER_FRAME:run.f1 * QT_PER_FRAME].view(
                -1, 4, 64)
            samples = kernels.jpeg_idct(coef, qt, run.geom)
            shown.append(kernels.jpeg_color(samples, run.geom))
        if len({tuple(r.shape[1:]) for r in shown}) > 1:
            raise ValueError("all input arrays must have the same shape")
        return {"rgb": shown[0] if len(shown) == 1 else torch.cat(shown)}
