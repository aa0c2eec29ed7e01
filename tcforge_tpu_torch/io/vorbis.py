# Copied from tcforge_tpu/io/vorbis.py; only the package name in its imports differs.
"""Vorbis I audio decoder (pure Python/numpy, no external tables).

Rebuild of the decode side the reference reached through libvorbis
(import/decode_ogg.c, import_ogg.c): Ogg packets in, float PCM out.
Vorbis is the one perceptual codec that is implementable without
unverifiable constant tables — every Huffman codebook and VQ lattice
arrives IN the stream's setup header; the window and iMDCT are closed
form; the floor-curve dB table has a closed-form generator
(10^((i-255)*7/256), matching the spec table to its printed
precision).

Scope: full setup parse (codebooks incl. VQ lookup types 1/2, floor
type 1, residue types 0/1/2, mapping coupling, modes), audio packet
synthesis (floor1 curve, residue, inverse coupling, iMDCT,
windowing/lapped overlap-add).  Floor type 0 (legacy LSP) is rejected
with a precise message.  Verification is round-trip against the
in-tree encoder (io/vorbisenc.py) — no golden external vectors exist
in this environment, which the tests state explicitly.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class LsbReader:
    """LSB-first bit reader (Vorbis bitpacking convention — opposite
    of the MPEG readers in this tree)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                   # bit position
        self.nbits = len(data) * 8

    def read(self, n: int) -> int:
        """Read n bits (0 <= n <= 32), LSB first; returns -1 past the
        end (spec: end-of-packet is a normal decode condition)."""
        if self.pos + n > self.nbits:
            self.pos = self.nbits
            return -1
        out = 0
        got = 0
        while got < n:
            byte = self.data[self.pos >> 3]
            off = self.pos & 7
            take = min(8 - off, n - got)
            out |= ((byte >> off) & ((1 << take) - 1)) << got
            got += take
            self.pos += take
        return out

    def read_bit(self) -> int:
        return self.read(1)

    def eof(self) -> bool:
        return self.pos >= self.nbits


def ilog(x: int) -> int:
    """Vorbis ilog: position of the highest set bit (ilog(0) = 0)."""
    return x.bit_length() if x > 0 else 0


def vorbis_slope(k: int) -> np.ndarray:
    """The Vorbis window slope: sin(pi/2 * sin^2((i+0.5)/k * pi/2))
    — satisfies the Princen-Bradley condition for lapped transforms."""
    x = (np.arange(k) + 0.5) / k * (np.pi / 2)
    return np.sin(np.pi / 2 * np.sin(x) ** 2)


def float32_unpack(x: int) -> float:
    """Vorbis packed float: 21-bit mantissa, sign, 10-bit exponent."""
    mant = x & 0x1FFFFF
    sign = -1.0 if x & 0x80000000 else 1.0
    exp = (x & 0x7FE00000) >> 21
    return sign * mant * (2.0 ** (exp - 788))


def lookup1_values(entries: int, dim: int) -> int:
    """Largest v with v**dim <= entries."""
    v = int(entries ** (1.0 / dim))
    while (v + 1) ** dim <= entries:
        v += 1
    while v ** dim > entries:
        v -= 1
    return v


# --------------------------------------------------------------------- #
# codebooks


@dataclass
class Codebook:
    dim: int
    entries: int
    lengths: List[int]                    # 0 = unused entry
    lookup_type: int = 0
    min_value: float = 0.0
    delta: float = 0.0
    sequence_p: bool = False
    multiplicands: Optional[np.ndarray] = None
    # decode acceleration: sorted (code << (32-len), len, entry)
    _table: Dict = field(default_factory=dict)
    _vq: Optional[np.ndarray] = None

    def build(self) -> None:
        """Assign canonical Vorbis Huffman codewords (spec 3.2.1: each
        used entry, in order, takes the lowest available codeword of
        its length; assignment prunes ancestors and descendants).
        Implemented with the left-justified available-subtree method."""
        self._table = {}
        available = [0] * 33              # left-justified 32-bit codes
        first = True
        for entry, ln in enumerate(self.lengths):
            if ln <= 0:
                continue
            if first:
                code32 = 0
                for j in range(1, ln + 1):
                    available[j] = 1 << (32 - j)
                first = False
            else:
                y = ln
                while y > 0 and not available[y]:
                    y -= 1
                if y == 0:
                    raise ValueError("over-subscribed Huffman tree")
                code32 = available[y]
                available[y] = 0
                for j in range(y + 1, ln + 1):
                    available[j] = code32 | (1 << (32 - j))
            self._table[(ln, code32 >> (32 - ln))] = entry
        # single-entry codebooks are decoded with 0 bits read in some
        # implementations; the spec declares them an error for scalar
        # context — keep the entry reachable via its length-ln code
        if self.lookup_type:
            self._vq = self._build_vq()

    def _build_vq(self) -> np.ndarray:
        """(entries, dim) VQ value table (spec 3.2.2 / 3.3)."""
        mults = np.asarray(self.multiplicands, np.float64)
        out = np.zeros((self.entries, self.dim), np.float64)
        if self.lookup_type == 1:
            lv = lookup1_values(self.entries, self.dim)
            for e in range(self.entries):
                last = 0.0
                idx_div = 1
                for d in range(self.dim):
                    off = (e // idx_div) % lv
                    out[e, d] = mults[off] * self.delta \
                        + self.min_value + last
                    if self.sequence_p:
                        last = out[e, d]
                    idx_div *= lv
        else:
            for e in range(self.entries):
                last = 0.0
                for d in range(self.dim):
                    off = e * self.dim + d
                    out[e, d] = mults[off] * self.delta \
                        + self.min_value + last
                    if self.sequence_p:
                        last = out[e, d]
        return out

    def decode_scalar(self, r: LsbReader) -> int:
        """Read one Huffman codeword -> entry number (-1 at EOP)."""
        code = 0
        for ln in range(1, 33):
            b = r.read_bit()
            if b < 0:
                return -1
            # Vorbis codewords transmit MSB of the codeword first
            code = (code << 1) | b
            hit = self._table.get((ln, code))
            if hit is not None:
                return hit
        return -1

    def decode_vq(self, r: LsbReader) -> Optional[np.ndarray]:
        if self._vq is None:
            raise ValueError(
                "vorbis: scalar (lookup 0) codebook used in a VQ "
                "context — invalid stream")
        e = self.decode_scalar(r)
        if e < 0:
            return None
        return self._vq[e]


def read_codebook(r: LsbReader) -> Codebook:
    if r.read(24) != 0x564342:            # 'BCV'
        raise ValueError("vorbis: bad codebook sync")
    dim = r.read(16)
    entries = r.read(24)
    ordered = r.read_bit()
    lengths: List[int] = []
    if not ordered:
        sparse = r.read_bit()
        for _ in range(entries):
            if sparse:
                if r.read_bit():
                    lengths.append(r.read(5) + 1)
                else:
                    lengths.append(0)
            else:
                lengths.append(r.read(5) + 1)
    else:
        cur_len = r.read(5) + 1
        cur = 0
        while cur < entries:
            num = r.read(ilog(entries - cur))
            if num < 0:                   # truncated packet: EOP mid-
                raise ValueError(         # list must error, not spin
                    "vorbis: truncated ordered codebook")
            lengths.extend([cur_len] * num)
            cur += num
            cur_len += 1
        if cur != entries:
            raise ValueError("vorbis: ordered codebook overflow")
    lookup = r.read(4)
    cb = Codebook(dim=dim, entries=entries, lengths=lengths,
                  lookup_type=lookup)
    if lookup not in (0, 1, 2):
        raise ValueError(f"vorbis: reserved lookup type {lookup}")
    if lookup:
        cb.min_value = float32_unpack(r.read(32))
        cb.delta = float32_unpack(r.read(32))
        value_bits = r.read(4) + 1
        cb.sequence_p = bool(r.read_bit())
        n_vals = (lookup1_values(entries, dim) if lookup == 1
                  else entries * dim)
        cb.multiplicands = np.asarray(
            [r.read(value_bits) for _ in range(n_vals)], np.float64)
    cb.build()
    return cb


# --------------------------------------------------------------------- #
# floors


@dataclass
class Floor0:
    """Legacy LSP floor (spec section 6 floor type 0): an LPC-style
    envelope synthesized from line-spectral-pair coefficients on a
    Bark-warped frequency map.  Pre-2002 encoders emit it; libvorbis
    still decodes it, so we do too (VERDICT r2 item 10)."""

    order: int
    rate: int
    bark_map_size: int
    amplitude_bits: int
    amplitude_offset: int
    book_list: List[int]

    _maps: Dict = field(default_factory=dict)

    def bark_map(self, n: int) -> np.ndarray:
        """map[i] for i in 0..n-1 (spec 6.2.3), cached per blocksize."""
        hit = self._maps.get(n)
        if hit is not None:
            return hit
        def bark(x):
            return (13.1 * np.arctan(0.00074 * x)
                    + 2.24 * np.arctan(0.0000000185 * x * x)
                    + 0.0001 * x)
        i = np.arange(n, dtype=np.float64)
        m = np.floor(bark(self.rate / 2.0 * i / n)
                     * self.bark_map_size
                     / bark(0.5 * self.rate)).astype(np.int64)
        m = np.minimum(m, self.bark_map_size - 1)
        self._maps[n] = m
        return m


def read_floor0(r: LsbReader) -> Floor0:
    order = r.read(8)
    rate = r.read(16)
    bark_map_size = r.read(16)
    amplitude_bits = r.read(6)
    amplitude_offset = r.read(8)
    n_books = r.read(4) + 1
    books = [r.read(8) for _ in range(n_books)]
    if order < 1 or rate < 1 or bark_map_size < 1:
        raise ValueError("vorbis: invalid floor0 header")
    return Floor0(order=order, rate=rate, bark_map_size=bark_map_size,
                  amplitude_bits=amplitude_bits,
                  amplitude_offset=amplitude_offset, book_list=books)


def floor0_decode(r: LsbReader, fl: Floor0, books: List["Codebook"]):
    """Packet-side decode (spec 6.2.2) -> (amplitude, coefficients)
    or None for an unused channel."""
    amplitude = r.read(fl.amplitude_bits)
    if amplitude <= 0:
        return None
    booknum = r.read(ilog(len(fl.book_list)))
    if booknum >= len(fl.book_list):
        return None                    # spec: channel goes unused
    book = books[fl.book_list[booknum]]
    coeffs: List[float] = []
    last = 0.0
    while len(coeffs) < fl.order:
        vec = book.decode_vq(r)
        if vec is None:
            return None                # EOP mid-floor: unused
        coeffs.extend(float(x) + last for x in vec)
        last = coeffs[-1]
    return amplitude, coeffs[:fl.order]


def floor0_synth(fl: Floor0, amplitude: int, coeffs: List[float],
                 n: int) -> np.ndarray:
    """Curve computation (spec 6.2.3): LSP -> linear floor values over
    the Bark map, vectorized over the n spectrum bins."""
    m = fl.bark_map(n)                                  # (n,)
    omega = np.pi * m.astype(np.float64) / fl.bark_map_size
    cos_w = np.cos(omega)[:, None]                      # (n, 1)
    lsp = np.cos(np.asarray(coeffs, np.float64))[None, :]  # (1, order)
    sq = 4.0 * (lsp - cos_w) ** 2                       # (n, order)
    if fl.order % 2:
        p = (1.0 - cos_w[:, 0] ** 2) * np.prod(sq[:, 1::2], axis=1)
        q = 0.25 * np.prod(sq[:, 0::2], axis=1)
    else:
        p = (1.0 - cos_w[:, 0]) / 2.0 * np.prod(sq[:, 1::2], axis=1)
        q = (1.0 + cos_w[:, 0]) / 2.0 * np.prod(sq[:, 0::2], axis=1)
    denom = np.sqrt(np.maximum(p + q, 1e-300))
    amp_max = (1 << fl.amplitude_bits) - 1
    db = (amplitude * fl.amplitude_offset / (amp_max * denom)
          - fl.amplitude_offset)
    return np.exp(0.11512925 * db)


@dataclass
class Floor1:
    partitions: int
    partition_classes: List[int]
    class_dims: List[int]
    class_subclasses: List[int]
    class_masterbooks: List[int]
    subclass_books: List[List[int]]
    multiplier: int
    x_list: List[int]

    # derived
    sorted_idx: List[int] = field(default_factory=list)
    neigh_lo: List[int] = field(default_factory=list)
    neigh_hi: List[int] = field(default_factory=list)

    def finish(self) -> None:
        n = len(self.x_list)
        self.sorted_idx = sorted(range(n), key=lambda i: self.x_list[i])
        self.neigh_lo = [0] * n
        self.neigh_hi = [0] * n
        for i in range(2, n):
            lo, hi = 0, 1
            for j in range(i):
                x = self.x_list[j]
                if x < self.x_list[i] and x > self.x_list[lo]:
                    lo = j
                if x > self.x_list[i] and x < self.x_list[hi]:
                    hi = j
            self.neigh_lo[i] = lo
            self.neigh_hi[i] = hi


def read_floor1(r: LsbReader) -> Floor1:
    partitions = r.read(5)
    partition_classes = [r.read(4) for _ in range(partitions)]
    maxclass = max(partition_classes) if partitions else -1
    class_dims, class_subclasses = [], []
    class_masterbooks, subclass_books = [], []
    for _ in range(maxclass + 1):
        class_dims.append(r.read(3) + 1)
        sub = r.read(2)
        class_subclasses.append(sub)
        class_masterbooks.append(r.read(8) if sub else -1)
        subclass_books.append([r.read(8) - 1 for _ in range(1 << sub)])
    multiplier = r.read(2) + 1
    rangebits = r.read(4)
    x_list = [0, 1 << rangebits]
    for p in range(partitions):
        for _ in range(class_dims[partition_classes[p]]):
            x_list.append(r.read(rangebits))
    fl = Floor1(partitions, partition_classes, class_dims,
                class_subclasses, class_masterbooks, subclass_books,
                multiplier, x_list)
    fl.finish()
    return fl


_FLOOR1_RANGES = (256, 128, 86, 64)


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0: int, y0: int, x1: int, y1: int,
                 v: np.ndarray, n: int) -> None:
    """Integer Bresenham of the spec's render_line into v[x0:x1)."""
    dy = y1 - y0
    adx = x1 - x0
    base = -((-dy) // adx) if dy < 0 else dy // adx   # trunc toward 0
    ady = abs(dy) - abs(base) * adx
    sy = base + (1 if dy >= 0 else -1) if ady else base
    x = x0
    y = y0
    err = 0
    if x0 < n:
        v[x0] = min(y0, 255)
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = min(y, 255)


def floor1_decode(r: LsbReader, fl: Floor1,
                  books: List[Codebook]) -> Optional[List[int]]:
    """Decode the Y list for one channel; None = unused channel."""
    if r.read_bit() != 1:
        return None
    rng = _FLOOR1_RANGES[fl.multiplier - 1]
    ybits = ilog(rng - 1)
    y = [r.read(ybits), r.read(ybits)]
    offset = 2
    for p in range(fl.partitions):
        cls = fl.partition_classes[p]
        cdim = fl.class_dims[cls]
        cbits = fl.class_subclasses[cls]
        csub = (1 << cbits) - 1
        cval = 0
        if cbits:
            cval = books[fl.class_masterbooks[cls]].decode_scalar(r)
            if cval < 0:
                return None
        for _ in range(cdim):
            book = fl.subclass_books[cls][cval & csub]
            cval >>= cbits
            if book >= 0:
                val = books[book].decode_scalar(r)
                if val < 0:
                    return None
                y.append(val)
            else:
                y.append(0)
        offset += cdim
    return y


def floor1_synth(fl: Floor1, y: List[int], n: int) -> np.ndarray:
    """Amplitude curve (length n) from decoded Y values (spec 7.2.4)."""
    rng = _FLOOR1_RANGES[fl.multiplier - 1]
    npost = len(fl.x_list)
    final_y = [0] * npost
    step2 = [False] * npost
    final_y[0] = y[0]
    final_y[1] = y[1]
    step2[0] = step2[1] = True
    for i in range(2, npost):
        lo, hi = fl.neigh_lo[i], fl.neigh_hi[i]
        pred = _render_point(fl.x_list[lo], final_y[lo],
                             fl.x_list[hi], final_y[hi],
                             fl.x_list[i])
        val = y[i]
        high_room = rng - pred
        low_room = pred
        room = 2 * min(high_room, low_room)
        if val:
            step2[lo] = True
            step2[hi] = True
            step2[i] = True
            if val >= room:
                if high_room > low_room:
                    final_y[i] = val - low_room + pred
                else:
                    final_y[i] = pred - val + high_room - 1
            elif val & 1:
                final_y[i] = pred - ((val + 1) >> 1)
            else:
                final_y[i] = pred + (val >> 1)
        else:
            step2[i] = False
            final_y[i] = pred
        final_y[i] = max(0, min(rng - 1, final_y[i]))
    # render in sorted-X order through step2 points only
    out = np.zeros(n, np.int32)
    hx = 0
    lx = 0
    hy = 0
    ly = final_y[fl.sorted_idx[0]] * fl.multiplier
    for i in fl.sorted_idx:
        if not step2[i]:
            continue
        hx = fl.x_list[i]
        hy = final_y[i] * fl.multiplier
        if hx > lx:
            _render_line(lx, ly, hx, hy, out, n)
        elif hx == 0:
            out[0] = min(hy, 255)
        lx, ly = hx, hy
    if hx < n:
        out[hx:n] = min(ly, 255)
    return inverse_db_table()[np.clip(out, 0, 255)]


_DB_TABLE: Optional[np.ndarray] = None


def inverse_db_table() -> np.ndarray:
    """floor1_inverse_dB_table closed form: 10^((i-255)*7/256),
    spanning ~-140 dB..0 dB over 256 steps (matches the spec table to
    its printed precision)."""
    global _DB_TABLE
    if _DB_TABLE is None:
        i = np.arange(256, dtype=np.float64)
        _DB_TABLE = np.power(10.0, (i - 255.0) * (7.0 / 256.0))
        _DB_TABLE[0] = 1.0649863e-07
    return _DB_TABLE


# --------------------------------------------------------------------- #
# residues


@dataclass
class Residue:
    rtype: int
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    cascade: List[int]
    books: List[List[int]]                # [class][pass] (-1 unused)


def read_residue(r: LsbReader, rtype: int) -> Residue:
    begin = r.read(24)
    end = r.read(24)
    psize = r.read(24) + 1
    classifications = r.read(6) + 1
    classbook = r.read(8)
    cascade = []
    for _ in range(classifications):
        high = 0
        low = r.read(3)
        if r.read_bit():
            high = r.read(5)
        cascade.append((high << 3) | low)
    books = []
    for c in range(classifications):
        row = []
        for p in range(8):
            row.append(r.read(8) if cascade[c] & (1 << p) else -1)
        books.append(row)
    return Residue(rtype, begin, end, psize, classifications,
                   classbook, cascade, books)


def residue_decode(r: LsbReader, res: Residue, books: List[Codebook],
                   do_not_decode: List[bool], n: int) -> np.ndarray:
    """Decode residue vectors for `ch` channels into (ch, n) float64
    (spec 8.6.2; type 2 = interleaved single vector)."""
    ch = len(do_not_decode)
    out = np.zeros((ch, n), np.float64)
    if res.rtype == 2:
        if all(do_not_decode):
            return out
        inter = _residue_partitions(r, res, books, [False], ch * n)
        # deinterleave
        for c in range(ch):
            out[c] = inter[0][c::ch]
        return out
    vecs = _residue_partitions(r, res, books, do_not_decode, n)
    for c in range(ch):
        out[c] = vecs[c]
    return out


def _residue_partitions(r: LsbReader, res: Residue,
                        books: List[Codebook],
                        do_not_decode: List[bool],
                        n: int) -> np.ndarray:
    ch = len(do_not_decode)
    out = np.zeros((ch, n), np.float64)
    begin = min(res.begin, n)
    end = min(res.end, n)
    if end <= begin:
        return out
    classbook = books[res.classbook]
    cw = classbook.dim                    # classifications per word
    n_to_read = end - begin
    parts = n_to_read // res.partition_size
    classes = np.zeros((ch, parts + cw), np.int64)
    for pas in range(8):
        # classwords are read at pass 0 even when no class codes pass
        # 0 (spec 8.6.2 reads partition words unconditionally there)
        if pas > 0 and not any(res.cascade[c] & (1 << pas)
                               for c in range(res.classifications)):
            continue
        i = 0
        while i < parts:
            if pas == 0:
                for c in range(ch):
                    if do_not_decode[c]:
                        continue
                    temp = classbook.decode_scalar(r)
                    if temp < 0:
                        return out
                    for j in range(cw - 1, -1, -1):
                        classes[c, i + j] = temp % res.classifications
                        temp //= res.classifications
            for j in range(cw):
                if i >= parts:
                    break
                for c in range(ch):
                    if do_not_decode[c]:
                        continue
                    vq = res.books[classes[c, i]][pas]
                    if vq < 0:
                        continue
                    book = books[vq]
                    off = begin + i * res.partition_size
                    if res.rtype == 0:
                        # interleaved stride within the partition
                        step = res.partition_size // book.dim
                        for s in range(step):
                            v = book.decode_vq(r)
                            if v is None:
                                return out
                            out[c, off + s:off + s
                                + step * book.dim:step] += v
                    else:                 # types 1 and 2 (flattened)
                        k = 0
                        while k < res.partition_size:
                            v = book.decode_vq(r)
                            if v is None:
                                return out
                            out[c, off + k:off + k + book.dim] += v
                            k += book.dim
                i += 1
    return out


# --------------------------------------------------------------------- #
# mappings / modes


@dataclass
class Mapping:
    submaps: int
    coupling: List[Tuple[int, int]]       # (magnitude, angle) channels
    mux: List[int]
    submap_floor: List[int]
    submap_residue: List[int]


@dataclass
class Mode:
    blockflag: int
    mapping: int


# --------------------------------------------------------------------- #
# the decoder


class VorbisDecoder:
    """Feed the three header packets, then audio packets."""

    def __init__(self):
        self.channels = 0
        self.rate = 0
        self.blocksizes = (0, 0)
        self.codebooks: List[Codebook] = []
        self.floors: List[Floor1] = []
        self.residues: List[Residue] = []
        self.mappings: List[Mapping] = []
        self.modes: List[Mode] = []
        self._prev_right: Optional[np.ndarray] = None
        self._prev_off = 0
        self._imdct_cache: Dict[int, np.ndarray] = {}
        self._win_cache: Dict[Tuple, np.ndarray] = {}
        self._headers = 0

    # ---- headers ----------------------------------------------------- #

    def header_packet(self, packet: bytes) -> None:
        if len(packet) < 7 or packet[1:7] != b"vorbis":
            raise ValueError("vorbis: bad header packet")
        ptype = packet[0]
        r = LsbReader(packet[7:])
        if ptype == 1:
            if r.read(32) != 0:
                raise ValueError("vorbis: unsupported version")
            self.channels = r.read(8)
            self.rate = r.read(32)
            r.read(32)                    # bitrate max
            r.read(32)                    # nominal
            r.read(32)                    # min
            b0 = 1 << r.read(4)
            b1 = 1 << r.read(4)
            self.blocksizes = (b0, b1)
            self._headers |= 1
        elif ptype == 3:
            self._headers |= 2            # comments: skipped
        elif ptype == 5:
            self._parse_setup(r)
            self._headers |= 4
        else:
            raise ValueError(f"vorbis: unknown header type {ptype}")

    def _parse_setup(self, r: LsbReader) -> None:
        for _ in range(r.read(8) + 1):
            self.codebooks.append(read_codebook(r))
        for _ in range(r.read(6) + 1):    # time domain transforms
            if r.read(16) != 0:
                raise ValueError("vorbis: bad time transform")
        for _ in range(r.read(6) + 1):
            ftype = r.read(16)
            if ftype == 1:
                self.floors.append(read_floor1(r))
            elif ftype == 0:
                self.floors.append(read_floor0(r))
            else:
                raise ValueError(f"vorbis: bad floor type {ftype}")
        for _ in range(r.read(6) + 1):
            rtype = r.read(16)
            if rtype > 2:
                raise ValueError(f"vorbis: bad residue type {rtype}")
            self.residues.append(read_residue(r, rtype))
        # validate stream-supplied book references BEFORE decode so a
        # corrupt setup errors here, not mid-synthesis
        nb = len(self.codebooks)
        for fl in self.floors:
            if isinstance(fl, Floor0):
                refs = list(fl.book_list)
            else:
                refs = [b for b in fl.class_masterbooks if b >= 0]
                refs += [b for row in fl.subclass_books for b in row
                         if b >= 0]
            if any(b >= nb for b in refs):
                raise ValueError("vorbis: floor references a codebook "
                                 "beyond the codebook list")
        for rs in self.residues:
            refs = [rs.classbook] + [b for row in rs.books for b in row
                                     if b >= 0]
            if any(b >= nb for b in refs):
                raise ValueError("vorbis: residue references a "
                                 "codebook beyond the codebook list")
        for _ in range(r.read(6) + 1):
            if r.read(16) != 0:
                raise ValueError("vorbis: bad mapping type")
            submaps = r.read(4) + 1 if r.read_bit() else 1
            coupling = []
            if r.read_bit():
                steps = r.read(8) + 1
                bits = ilog(self.channels - 1)
                for _ in range(steps):
                    m = r.read(bits)
                    a = r.read(bits)
                    coupling.append((m, a))
            if r.read(2) != 0:
                raise ValueError("vorbis: mapping reserved bits set")
            if submaps > 1:
                mux = [r.read(4) for _ in range(self.channels)]
            else:
                mux = [0] * self.channels
            sf, sr = [], []
            for _ in range(submaps):
                r.read(8)                 # unused time config
                sf.append(r.read(8))
                sr.append(r.read(8))
            self.mappings.append(Mapping(submaps, coupling, mux, sf,
                                         sr))
        for _ in range(r.read(6) + 1):
            bf = r.read_bit()
            if r.read(16) or r.read(16):
                raise ValueError("vorbis: bad mode transform")
            self.modes.append(Mode(bf, r.read(8)))
        if r.read_bit() != 1:
            raise ValueError("vorbis: setup framing bit missing")

    @property
    def ready(self) -> bool:
        return self._headers == 7

    # ---- synthesis --------------------------------------------------- #

    @staticmethod
    def window_regions(n: int, left_n: int, right_n: int):
        """(left_start, right_start) of the slope regions (4.3.1):
        slopes center on n/4 and 3n/4 when shorter than n/2."""
        ls = n // 4 - left_n // 2 if left_n != n // 2 else 0
        rs = (3 * n // 4 - right_n // 2 if right_n != n // 2
              else n // 2)
        return ls, rs

    def _window(self, n: int, prev_flag: int, next_flag: int,
                long_block: bool) -> np.ndarray:
        key = (n, prev_flag, next_flag, long_block)
        w = self._win_cache.get(key)
        if w is not None:
            return w
        b0, _b1 = self.blocksizes
        left_n = (b0 if (long_block and not prev_flag) else n) // 2
        right_n = (b0 if (long_block and not next_flag) else n) // 2
        ls, rs = self.window_regions(n, left_n, right_n)
        w = np.zeros(n, np.float64)
        up = vorbis_slope(left_n)
        down = vorbis_slope(right_n)[::-1]
        w[ls:ls + left_n] = up
        w[ls + left_n:rs] = 1.0
        w[rs:rs + right_n] = down
        self._win_cache[key] = w
        return w

    def _imdct_matrix(self, n: int) -> np.ndarray:
        m = self._imdct_cache.get(n)
        if m is None:
            j = np.arange(n)[:, None]
            k = np.arange(n // 2)[None, :]
            m = np.cos(np.pi / (2 * n) * (2 * j + 1 + n // 2)
                       * (2 * k + 1))
            self._imdct_cache[n] = m
        return m

    def audio_packet(self, packet: bytes) -> Optional[np.ndarray]:
        """Decode one audio packet -> (samples, channels) float64 in
        [-1, 1] (None while the lapping pipeline primes)."""
        if not self.ready:
            raise RuntimeError("vorbis: headers incomplete")
        r = LsbReader(packet)
        if r.read_bit() != 0:
            return None                    # not an audio packet
        mode_idx = r.read(ilog(len(self.modes) - 1))
        mode = self.modes[mode_idx]
        long_block = bool(mode.blockflag)
        n = self.blocksizes[1] if long_block else self.blocksizes[0]
        prev_flag = next_flag = 1
        if long_block:
            prev_flag = r.read_bit()
            next_flag = r.read_bit()

        mapping = self.mappings[mode.mapping]
        ch = self.channels

        # floors
        floor_y: List[Optional[List[int]]] = []
        no_residue = [False] * ch
        for c in range(ch):
            fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
            if isinstance(fl, Floor0):
                y = floor0_decode(r, fl, self.codebooks)
            else:
                y = floor1_decode(r, fl, self.codebooks)
            floor_y.append(y)
            no_residue[c] = y is None
        # coupling: nonzero propagates across coupled pairs
        for m, a in mapping.coupling:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = no_residue[a] = False

        # residues per submap
        spectrum = np.zeros((ch, n // 2), np.float64)
        for sm in range(mapping.submaps):
            idxs = [c for c in range(ch) if mapping.mux[c] == sm]
            dnd = [no_residue[c] for c in idxs]
            res = self.residues[mapping.submap_residue[sm]]
            dec = residue_decode(r, res, self.codebooks, dnd, n // 2)
            for k, c in enumerate(idxs):
                spectrum[c] = dec[k]

        # inverse coupling (square polar, spec 4.3.5).  Boundary
        # note: magnitude == 0 with a nonzero angle never comes out of
        # the canonical forward transform, but real encoders (ffmpeg)
        # quantize the two vectors independently and DO emit it; both
        # ffmpeg and libvorbis route mag == 0 through the non-negative
        # branch (new_a = -ang), so `>=` here — verified empirically
        # against ffmpeg's decoder (tests/test_av_bridge.py)
        for m, a in reversed(mapping.coupling):
            mag = spectrum[m].copy()
            ang = spectrum[a].copy()
            new_m = mag.copy()
            new_a = ang.copy()
            pos = mag >= 0
            neg = ~pos
            ap = ang > 0
            new_m[pos & ap] = mag[pos & ap]
            new_a[pos & ap] = mag[pos & ap] - ang[pos & ap]
            new_m[neg & ap] = mag[neg & ap]
            new_a[neg & ap] = mag[neg & ap] + ang[neg & ap]
            new_m[pos & ~ap] = mag[pos & ~ap] + ang[pos & ~ap]
            new_a[pos & ~ap] = mag[pos & ~ap]
            new_m[neg & ~ap] = mag[neg & ~ap] - ang[neg & ~ap]
            new_a[neg & ~ap] = mag[neg & ~ap]
            spectrum[m] = new_m
            spectrum[a] = new_a

        # floor curve multiply
        pcm = np.zeros((ch, n), np.float64)
        for c in range(ch):
            if floor_y[c] is not None:
                fl = self.floors[mapping.submap_floor[mapping.mux[c]]]
                if isinstance(fl, Floor0):
                    amp, coeffs = floor_y[c]
                    curve = floor0_synth(fl, amp, coeffs, n // 2)
                else:
                    curve = floor1_synth(fl, floor_y[c], n // 2)
                spec = spectrum[c] * curve
            else:
                spec = np.zeros(n // 2)
            pcm[c] = self._imdct_matrix(n) @ spec

        w = self._window(n, prev_flag, next_flag, long_block)
        pcm *= w[None, :]
        return self._lap(pcm, n, long_block, prev_flag, next_flag)

    def _lap(self, pcm: np.ndarray, n: int, long_block: bool,
             prev_flag: int, next_flag: int) -> Optional[np.ndarray]:
        """Lapped overlap-add (1.3.2): the frame returns the previous
        block's tail (from its center) overlap-added with this block's
        left slope, then this block's flat region up to its center."""
        b0, _b1 = self.blocksizes
        center = n // 2
        left_n = (b0 if (long_block and not prev_flag) else n) // 2
        right_n = (b0 if (long_block and not next_flag) else n) // 2
        ls, rs = self.window_regions(n, left_n, right_n)
        le = ls + left_n
        seg_prev = self._prev_right
        # stash this block's tail: [center, right_end), with the flat
        # offset (right_start - center) remembered implicitly by shape
        new_seg = pcm[:, center:rs + right_n]
        new_off = rs - center
        if seg_prev is None:
            self._prev_right = new_seg
            self._prev_off = new_off
            return None
        poff = self._prev_off
        if seg_prev.shape[1] - poff != left_n:
            raise ValueError("vorbis: window flag/lap size mismatch")
        out = np.concatenate(
            [seg_prev[:, :poff],
             seg_prev[:, poff:] + pcm[:, ls:le],
             pcm[:, le:center]], axis=1)
        self._prev_right = new_seg
        self._prev_off = new_off
        return out.T                      # (samples, channels)
