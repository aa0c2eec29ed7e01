# Copied from tcforge_tpu/io/vorbisenc.py; only the package name in its imports differs.
"""Minimal spec-conformant Vorbis I encoder.

The encode-side analogue of the reference's encode_vorbis.c (which
wrapped libvorbisenc).  This is not a psychoacoustic coder — it is a
*valid* Vorbis bitstream writer built to (a) give the framework a real
in-tree lossy audio encoder and (b) produce verification vectors for
:mod:`tcforge_tpu.io.vorbis` (the decoder), since no external golden
files exist in this environment.

Design: flat floor1 (the two mandatory posts only — zero floor
codebooks), residue type 2 with a 3-pass successive-refinement lattice
(radix-5 lookup-type-1 VQ books, dim 2), single mapping without
coupling, one short mode plus an optional long mode to exercise the
decoder's window switching.  Every codebook travels in the setup
header, exactly like any other Vorbis stream.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from tcforge_tpu_torch.io.vorbis import (Codebook, Floor1, _render_point,
                                   floor1_synth, ilog,
                                   inverse_db_table, vorbis_slope)


class LsbWriter:
    """LSB-first bitpacker (Vorbis convention)."""

    def __init__(self):
        self.out = bytearray()
        self.bit = 0

    def write(self, value: int, n: int) -> None:
        for i in range(n):
            if self.bit == 0:
                self.out.append(0)
            if (value >> i) & 1:
                self.out[-1] |= 1 << self.bit
            self.bit = (self.bit + 1) & 7

    def write_huff(self, code: int, ln: int) -> None:
        """Huffman codewords go MSB-first (tree-walk order)."""
        for i in range(ln - 1, -1, -1):
            self.write((code >> i) & 1, 1)

    def bytes(self) -> bytes:
        return bytes(self.out)


def float32_pack(x: float) -> int:
    """Inverse of vorbis.float32_unpack (21-bit mantissa form)."""
    if x == 0:
        return 0
    sign = 0x80000000 if x < 0 else 0
    x = abs(x)
    exp = 0
    while x < (1 << 20) and exp > -400:
        x *= 2.0
        exp -= 1
    while x >= (1 << 21):
        x /= 2.0
        exp += 1
    return sign | ((exp + 788) << 21) | (int(round(x)) & 0x1FFFFF)


# --------------------------------------------------------------------- #
# fixed coding setup


class _Book:
    """Encoder-side codebook: lengths + assigned codes (reusing the
    decoder's canonical assignment so both sides agree by
    construction)."""

    def __init__(self, dim: int, lengths: List[int], lookup_type=0,
                 min_value=0.0, delta=0.0, value_bits=0,
                 multiplicands=None):
        self.dim = dim
        self.entries = len(lengths)
        self.lengths = lengths
        self.lookup_type = lookup_type
        self.min_value = min_value
        self.delta = delta
        self.value_bits = value_bits
        self.multiplicands = multiplicands or []
        cb = Codebook(dim=dim, entries=self.entries, lengths=lengths,
                      lookup_type=lookup_type, min_value=min_value,
                      delta=delta,
                      multiplicands=np.asarray(self.multiplicands,
                                               np.float64)
                      if multiplicands else None)
        cb.build()
        self.codes = {e: (ln, code) for (ln, code), e
                      in cb._table.items()}
        self.values = cb._vq              # (entries, dim) or None

    def pack(self, w: LsbWriter) -> None:
        w.write(0x564342, 24)
        w.write(self.dim, 16)
        w.write(self.entries, 24)
        w.write(0, 1)                     # not ordered
        w.write(0, 1)                     # not sparse
        for ln in self.lengths:
            w.write(ln - 1, 5)
        w.write(self.lookup_type, 4)
        if self.lookup_type:
            w.write(float32_pack(self.min_value), 32)
            w.write(float32_pack(self.delta), 32)
            w.write(self.value_bits - 1, 4)
            w.write(0, 1)                 # sequence_p
            for m in self.multiplicands:
                w.write(m, self.value_bits)

    def put(self, w: LsbWriter, entry: int) -> None:
        ln, code = self.codes[entry]
        w.write_huff(code, ln)


def _uniform_lengths(n: int) -> List[int]:
    """Lengths for a full balanced tree over n = 2^k entries."""
    k = ilog(n - 1)
    if (1 << k) != n:
        raise ValueError("uniform codebook needs power-of-two entries")
    return [k] * n


def _complete_lengths(n: int) -> List[int]:
    """Near-balanced COMPLETE Huffman lengths for n entries (Kraft sum
    exactly 1): a entries at L = floor(log2 n) and n - a at L + 1 with
    a = 2^(L+1) - n.  For n = 36 this is 28x5 + 8x6, for n = 25 it is
    7x4 + 18x5 — identical to the hand-built tables they replace."""
    if n < 2:
        raise ValueError("complete tree needs >= 2 entries")
    L = n.bit_length() - 1
    a = (1 << (L + 1)) - n
    return [L] * a + [L + 1] * (n - a)


def _huff_lengths(freqs) -> List[int]:
    """Huffman code lengths for the given frequency priors (complete
    tree by construction — vorbis codebooks transmit lengths only and
    assign codes canonically, so better lengths are a drop-in)."""
    import heapq
    heap = [(float(f), i, ("leaf", i)) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    uid = len(heap)
    while len(heap) > 1:
        f1, _, t1 = heapq.heappop(heap)
        f2, _, t2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, uid, ("node", t1, t2)))
        uid += 1
    lens = [0] * len(freqs)

    def walk(t, d):
        if t[0] == "leaf":
            lens[t[1]] = max(1, d)
        else:
            walk(t[1], d + 1)
            walk(t[2], d + 1)
    walk(heap[0][2], 0)
    return lens


def _vq_prior(skew: float) -> List[float]:
    """Frequency prior for one 25-entry (5x5) lattice book: weight
    decays with taxicab distance from the (0, 0) center and boosts
    same-sign diagonals (adjacent floor-normalized bins correlate —
    measured on tone/noise mixes)."""
    out = []
    for a in range(5):
        for b in range(5):
            d = abs(a - 2) + abs(b - 2)
            f = skew ** d
            if (a - 2) * (b - 2) > 0:
                f *= 1.5
            out.append(f)
    return out


def _class_prior(nclass: int) -> List[float]:
    """Classbook prior: quiet partitions dominate and neighbouring
    partitions share a class (strong diagonal, measured)."""
    g = [2.2 ** (nclass - 1 - c) for c in range(nclass)]
    out = []
    for c0 in range(nclass):
        for c1 in range(nclass):
            f = g[c0] * g[c1]
            if c0 == c1:
                f *= 3.0
            elif abs(c0 - c1) == 1:
                f *= 1.5
            out.append(f)
    return out


# floor-value prior: the predictive scheme lands on 0 for most posts,
# small corrections decay, 255 appears as the saturation escape
_FLOOR_PRIOR = [200.0] + [40.0 / (1 + v) for v in range(1, 255)] \
    + [30.0]

RADIX = 5                                # lattice points per dim/pass
_PASSES = 5
_PART_SIZE = 8                           # residue partition size
_CLASSWORDS = 2                          # classbook dimension

# floor post X positions (interior; [0, 256] are implicit) — denser at
# low frequencies where spectra move fastest
_FLOOR_FRACS = ((1, 32), (1, 16), (3, 32), (1, 8), (3, 16), (1, 4),
                (5, 16), (3, 8), (1, 2), (5, 8), (3, 4), (7, 8))


class VorbisEncoder:
    """Fixed-setup Vorbis I encoder: 16-bit PCM in, Ogg packets out.

    blocksize: short block size (64..8192, power of two).  With
    ``long_blocks=True`` a second 4x mode is emitted for frames the
    caller marks long (exercises window switching)."""

    def __init__(self, rate: int, channels: int, blocksize: int = 256,
                 long_blocks: bool = False, base_delta: float = 0.5,
                 coupling: Optional[bool] = None,
                 passes: int = _PASSES):
        self.rate = rate
        self.channels = channels
        # square-polar channel coupling (spec 4.3.5): lossless
        # magnitude/angle rotation of the residue pair.  Measured:
        # with this coder's coarse power-of-4 class thresholds the
        # smaller angle channel rarely drops a class, so coupling
        # costs ~1 dB for no bit savings — default OFF; the decoder
        # path stays exercised by tests
        self.coupling = bool(coupling) and channels == 2
        self.n0 = blocksize
        self.n1 = blocksize * 4 if long_blocks else blocksize
        self.long_blocks = long_blocks
        # residue VQ: successive-refinement radix-5 lattice, dim 2.
        # Pass deltas form an exact coverage chain (residual after a
        # pass is <= delta/2 = the next pass's +-2*delta reach).  The
        # chain's total reach is (8/3)*4*base_delta; the upper-
        # envelope floor fit bounds |residue| to ~0.95, so base_delta
        # below ~0.09 loses coverage and SNR collapses (each pass is
        # ~+12 dB, each base_delta halving ~+6 dB within coverage).
        if not 2 <= passes <= 7:
            raise ValueError("passes must be in 2..7 (cascade bitmap "
                             "is 8 bits; classbook grows as "
                             "(passes+1)^2)")
        if base_delta < 0.09:
            raise ValueError("base_delta below 0.09: the lattice "
                             "chain's +-(8/3)*4*base_delta reach no "
                             "longer covers floor-bounded residues")
        self.passes = passes
        self.deltas = [base_delta * 4 / (4 ** k) for k in range(passes)]
        self._books: List[_Book] = []
        # residue classes: 0 = silent, k = refine starting at pass
        # passes-k (quiet partitions skip the wide passes entirely)
        self._nclass = passes + 1
        self._cascade = [0] + [(((1 << passes) - 1)
                               >> (passes - k)) << (passes - k)
                              for k in range(1, self._nclass)]
        # nclass^classwords entries, Huffman-coded against a
        # measured prior (quiet-heavy with a diagonal boost) — the
        # old near-balanced tree left ~2 bits/word on the table
        ncw = self._nclass ** _CLASSWORDS
        self._classbook = _Book(
            _CLASSWORDS, _huff_lengths(_class_prior(self._nclass)))
        self._books.append(self._classbook)
        self._vq_books: List[_Book] = []
        for k, d in enumerate(self.deltas):
            # 25-entry lattice book with center-weighted Huffman
            # lengths (early refinement passes skew hard toward the
            # small symbols; the deepest passes approach uniform)
            skew = 0.45 if k < 2 else 0.62
            b = _Book(2, _huff_lengths(_vq_prior(skew)),
                      lookup_type=1, min_value=-2 * d, delta=d,
                      value_bits=3, multiplicands=[0, 1, 2, 3, 4])
            self._vq_books.append(b)
            self._books.append(b)
        # fitted floor1: three partitions of one 4-dim class, post
        # positions scaled to the spectrum size (a fixed 0..256 post
        # range stops tracking the envelope above bin 256 and large
        # blocksizes collapse), values Huffman-coded (0 dominates —
        # the predictive scheme lands exactly for most posts)
        self._floor_book = _Book(1, _huff_lengths(_FLOOR_PRIOR))
        self._floor_book_idx = len(self._books)
        self._books.append(self._floor_book)
        bins1 = self.n1 // 2
        self._rangebits = max(1, ilog(bins1 - 1))
        R = 1 << self._rangebits
        xs = sorted({max(1, (R * fnum) // fden)
                     for fnum, fden in _FLOOR_FRACS})
        while len(xs) < 12:                  # tiny blocks: pad grid
            cand = max(xs) + 1
            while cand in xs or cand >= R:
                cand -= 1
            xs.append(cand)
            xs.sort()
        fl = Floor1(partitions=3, partition_classes=[0, 0, 0],
                    class_dims=[4], class_subclasses=[0],
                    class_masterbooks=[-1],
                    subclass_books=[[self._floor_book_idx]],
                    multiplier=1,
                    x_list=[0, R] + xs[:12])
        fl.finish()
        self._floor = fl
        self._prev_tail: Optional[np.ndarray] = None
        self._mdct_cache = {}

    # ---- headers ------------------------------------------------------ #

    def header_packets(self) -> List[bytes]:
        ident = bytearray(b"\x01vorbis")
        ident += struct.pack("<IBI", 0, self.channels, self.rate)
        ident += struct.pack("<iii", 0, 0, 0)     # bitrate hints
        ident.append(ilog(self.n0 - 1) | (ilog(self.n1 - 1) << 4))
        ident.append(1)                   # framing
        comment = bytearray(b"\x03vorbis")
        vendor = b"tcforge_tpu vorbis"
        comment += struct.pack("<I", len(vendor)) + vendor
        comment += struct.pack("<I", 0)   # no user comments
        comment.append(1)
        return [bytes(ident), bytes(comment), self._setup_packet()]

    def _setup_packet(self) -> bytes:
        w = LsbWriter()
        for b in b"\x05vorbis":
            w.write(b, 8)
        w.write(len(self._books) - 1, 8)
        for b in self._books:
            b.pack(w)
        w.write(0, 6)                     # time transforms - 1
        w.write(0, 16)
        # one floor: type 1, fitted multi-post envelope
        w.write(0, 6)                     # floor count - 1
        w.write(1, 16)                    # floor type 1
        fl = self._floor
        w.write(fl.partitions, 5)
        for c in fl.partition_classes:
            w.write(c, 4)
        for k in range(max(fl.partition_classes) + 1):
            w.write(fl.class_dims[k] - 1, 3)
            w.write(fl.class_subclasses[k], 2)
            if fl.class_subclasses[k]:
                w.write(fl.class_masterbooks[k], 8)
            for b in fl.subclass_books[k]:
                w.write(b + 1, 8)
        w.write(fl.multiplier - 1, 2)     # range 256
        w.write(self._rangebits, 4)       # rangebits
        for x in fl.x_list[2:]:
            w.write(x, self._rangebits)
        # one residue: type 2
        w.write(0, 6)                     # residue count - 1
        w.write(2, 16)
        w.write(0, 24)                    # begin
        # end = the real type-2 vector size (ch * n1/2): strict
        # decoders (ffmpeg) validate it against the blocksize instead
        # of clamping
        w.write(self.channels * self.n1 // 2, 24)
        w.write(_PART_SIZE - 1, 24)
        w.write(self._nclass - 1, 6)      # classifications - 1
        w.write(0, 8)                     # classbook index
        for bitmap in self._cascade:
            w.write(bitmap & 7, 3)
            if bitmap >> 3:
                w.write(1, 1)
                w.write(bitmap >> 3, 5)
            else:
                w.write(0, 1)
        for bitmap in self._cascade:      # per-class books per pass
            for p in range(8):
                if bitmap & (1 << p):
                    w.write(1 + p, 8)
        # one mapping, type 0
        w.write(0, 6)
        w.write(0, 16)
        w.write(0, 1)                     # no submaps flag
        if self.coupling:
            w.write(1, 1)                 # coupling present
            w.write(0, 8)                 # steps - 1
            w.write(0, 1)                 # magnitude = ch 0 (1 bit:
            w.write(1, 1)                 # ilog(ch-1)) angle = ch 1
        else:
            w.write(0, 1)                 # no coupling
        w.write(0, 2)                     # reserved
        w.write(0, 8)                     # time config (discarded)
        w.write(0, 8)                     # floor number
        w.write(0, 8)                     # residue number
        # modes: short (+ long when enabled)
        nmodes = 2 if self.long_blocks else 1
        w.write(nmodes - 1, 6)
        for m in range(nmodes):
            w.write(m, 1)                 # blockflag
            w.write(0, 16)
            w.write(0, 16)
            w.write(0, 8)                 # mapping 0
        w.write(1, 1)                     # framing
        return w.bytes()

    # ---- transform ------------------------------------------------------ #

    def _mdct(self, n: int) -> np.ndarray:
        m = self._mdct_cache.get(n)
        if m is None:
            j = np.arange(n)[:, None]
            k = np.arange(n // 2)[None, :]
            m = np.cos(np.pi / (2 * n) * (2 * j + 1 + n // 2)
                       * (2 * k + 1))
            self._mdct_cache[n] = m
        return m

    def encode_block(self, frame: np.ndarray, long_block: bool = False,
                     prev_long: bool = False,
                     next_long: bool = False) -> bytes:
        """Encode one lapped block: frame is (n, channels) float in
        [-1, 1] where n = the block size (the caller supplies
        half-overlapped frames: consecutive blocks share n/2
        samples)."""
        n = self.n1 if long_block else self.n0
        assert frame.shape[0] == n
        ch = self.channels
        w = LsbWriter()
        w.write(0, 1)                     # audio packet
        if self.long_blocks:
            w.write(1 if long_block else 0, 1)
        if long_block:
            w.write(1 if prev_long else 0, 1)
            w.write(1 if next_long else 0, 1)

        # analysis window must equal the decoder's synthesis window
        win = self._window(n, long_block, prev_long, next_long)
        mdct = self._mdct(n)
        spec = np.zeros((ch, n // 2), np.float64)
        for c in range(ch):
            # forward MDCT scaled so decoder iMDCT + windowed
            # overlap-add is the identity (TDAC; verified in tests)
            spec[c] = (4.0 / n) * (mdct.T @ (win * frame[:, c]))

        # fitted floor1 per channel: quantized-dB envelope at the
        # posts, coded with the decoder's predictive val scheme
        table = inverse_db_table()
        fl = self._floor
        curves = [None] * ch
        silent = [False] * ch
        for c in range(ch):
            mag = np.abs(spec[c])
            if float(mag.max()) < 1e-10:
                silent[c] = True
                w.write(0, 1)             # floor unused
                continue
            q = np.minimum(np.searchsorted(table, mag), 255)
            vals = self._encode_floor_vals(self._fit_floor(q))
            w.write(1, 1)                 # floor nonzero
            w.write(vals[0], 8)
            w.write(vals[1], 8)
            idx = 2
            for part in range(fl.partitions):
                cls = fl.partition_classes[part]
                # class_subclasses is 0: no masterbook word
                for _ in range(fl.class_dims[cls]):
                    self._floor_book.put(w, vals[idx])
                    idx += 1
            curves[c] = floor1_synth(fl, vals, n // 2)
        if all(silent):
            return w.bytes()

        # residue: interleaved type-2 vector over ALL channels,
        # normalized by the synthesized floor curve (exactly what the
        # decoder multiplies back)
        res = [spec[c] / curves[c] if not silent[c]
               else np.zeros(n // 2) for c in range(ch)]
        if self.coupling and not any(silent):
            # forward square-polar (exact inverse of the decoder's
            # 4.3.5 reconstruction): dominant value carries magnitude
            m, a = res[0], res[1]
            dom_m = np.abs(m) >= np.abs(a)
            mag = np.where(dom_m, m, a)
            pos = np.where(dom_m, m > 0, a > 0)
            ang = np.where(pos, m - a, a - m)
            res = [mag, ang]
        total = ch * (n // 2)
        inter = np.zeros(total, np.float64)
        for c in range(ch):
            inter[c::ch] = res[c]
        self._write_residue(w, inter)
        return w.bytes()

    def _fit_floor(self, q: np.ndarray) -> List[int]:
        """Per-post quantized-dB targets forming an UPPER envelope:
        start from the max over each post's band plus headroom, then
        lift segment endpoints until the RENDERED line covers every
        bin — a max fit sampled only at the posts lets the line sag
        between them (a tone mid-segment ends up far above the
        floor, its residue outside the lattice's reach, and SNR
        collapses; measured residue -13 at large blocksizes)."""
        fl = self._floor
        xs = fl.x_list
        order = fl.sorted_idx
        nbins = len(q)
        sx = [xs[i] for i in order]
        targets = [0] * len(xs)
        for k, i in enumerate(order):
            lo = 0 if k == 0 else (sx[k - 1] + sx[k]) // 2
            hi = nbins if k == len(order) - 1 \
                else (sx[k] + sx[k + 1]) // 2 + 1
            lo, hi = min(lo, nbins), min(hi, nbins)
            band = q[lo:hi]
            t = int(band.max()) + 4 if band.size else 0
            targets[i] = min(t, 255)
        # lift pass: piecewise-linear coverage of q + margin at every
        # bin (the decoder renders straight segments through the
        # sorted posts; lifting both endpoints by a segment's worst
        # deficit covers it without lowering any other segment)
        need = np.minimum(q.astype(np.int64) + 2, 255)
        # iterate to convergence: when one endpoint caps at 255 the
        # uniform lift only moves the other end, so the deficit
        # shrinks geometrically by the bin's position fraction — a
        # fixed small iteration count left mid-segment tone peaks
        # uncovered (residue 1.43 > the bd=0.125 chain reach)
        for _ in range(16):
            deficit = [0] * len(xs)
            for k in range(len(order) - 1):
                i0, i1 = order[k], order[k + 1]
                x0, x1 = xs[i0], xs[i1]
                b0, b1 = min(x0, nbins), min(x1, nbins)
                if b1 <= b0:
                    continue
                bb = np.arange(b0, b1)
                line = targets[i0] + (
                    (targets[i1] - targets[i0])
                    * (bb - x0)) // (x1 - x0)
                d = int((need[b0:b1] - line).max()) if len(bb) else 0
                if d > 0:
                    deficit[i0] = max(deficit[i0], d)
                    deficit[i1] = max(deficit[i1], d)
            if not any(deficit):
                break
            targets = [min(t + d, 255)
                       for t, d in zip(targets, deficit)]
        return targets

    def _encode_floor_vals(self, targets: List[int]):
        """Targets -> transmitted val list, mirroring the decoder's
        predictive reconstruction (floor1_synth step 1) exactly: each
        val is chosen so the decoder lands on (or saturates toward)
        the target."""
        fl = self._floor
        rng = 256
        npost = len(fl.x_list)
        final_y = [0] * npost
        vals = [min(targets[0], rng - 1), min(targets[1], rng - 1)]
        final_y[0], final_y[1] = vals[0], vals[1]
        for i in range(2, npost):
            lo, hi = fl.neigh_lo[i], fl.neigh_hi[i]
            pred = _render_point(fl.x_list[lo], final_y[lo],
                                 fl.x_list[hi], final_y[hi],
                                 fl.x_list[i])
            off = min(targets[i], rng - 1) - pred
            low_room = pred
            high_room = rng - pred
            room = 2 * min(low_room, high_room)
            if off == 0:
                val = 0
            elif off > 0:
                if 2 * off < room:
                    val = 2 * off
                elif high_room > low_room:
                    val = off + low_room          # escape upward
                else:
                    val = max(0, 2 * (high_room - 1))  # saturate up
            else:
                if 2 * (-off) + 1 < room:
                    val = 2 * (-off) - 1
                elif low_room >= high_room:
                    val = high_room - 1 - off     # escape downward
                else:
                    val = max(0, 2 * low_room - 1)     # saturate down
            vals.append(val)
            # decoder-identical reconstruction for the running state
            if val:
                if val >= room:
                    if high_room > low_room:
                        fy = val - low_room + pred
                    else:
                        fy = pred - val + high_room - 1
                elif val & 1:
                    fy = pred - ((val + 1) >> 1)
                else:
                    fy = pred + (val >> 1)
            else:
                fy = pred
            final_y[i] = max(0, min(rng - 1, fy))
        return vals

    def _window(self, n, long_block, prev_long, next_long):
        b0 = self.n0
        left_n = (b0 if (long_block and not prev_long) else n) // 2
        right_n = (b0 if (long_block and not next_long) else n) // 2
        ls = n // 4 - left_n // 2 if left_n != n // 2 else 0
        rs = (3 * n // 4 - right_n // 2 if right_n != n // 2
              else n // 2)
        win = np.zeros(n)
        win[ls:ls + left_n] = vorbis_slope(left_n)
        win[ls + left_n:rs] = 1.0
        win[rs:rs + right_n] = vorbis_slope(right_n)[::-1]
        return win

    def _write_residue(self, w: LsbWriter, vec: np.ndarray) -> None:
        """Successive-refinement lattice coding mirroring the decoder's
        partition walk exactly (pass-major, classwords at pass 0).

        Each partition picks the cheapest class whose first coded
        pass still covers its peak (class k codes passes
        passes-k..passes-1), so quiet partitions skip the wide
        passes entirely."""
        n = vec.shape[0]
        parts = n // _PART_SIZE
        classes = np.zeros(parts, np.int64)
        resid = vec.copy()
        for i in range(parts):
            m = np.max(np.abs(resid[i * _PART_SIZE:(i + 1)
                                    * _PART_SIZE]))
            if m < self.deltas[-1] / 2:
                classes[i] = 0            # below the finest step
                continue
            cls = self._nclass - 1
            for k in range(1, self._nclass):
                if m <= 2.0 * self.deltas[self.passes - k]:
                    cls = k
                    break
            classes[i] = cls
        # precompute per-pass lattice choices
        choices = []                      # [pass][part] -> entry list
        for p, d in enumerate(self.deltas):
            vals = self._vq_books[p].values        # (25, 2)
            rows = []
            for i in range(parts):
                if not self._cascade[classes[i]] & (1 << p):
                    rows.append(None)
                    continue
                sl = resid[i * _PART_SIZE:(i + 1) * _PART_SIZE]
                entries = []
                for k in range(0, _PART_SIZE, 2):
                    target = sl[k:k + 2]
                    e = int(np.argmin(
                        np.sum((vals - target[None, :]) ** 2, axis=1)))
                    entries.append(e)
                    sl[k:k + 2] = target - vals[e]
                rows.append(entries)
            choices.append(rows)
        # emit in decode order
        for p in range(self.passes):
            i = 0
            while i < parts:
                if p == 0:
                    word = 0
                    for j in range(_CLASSWORDS):
                        c = classes[i + j] if i + j < parts else 0
                        word = word * self._nclass + int(c)
                    self._classbook.put(w, word)
                for j in range(_CLASSWORDS):
                    if i >= parts:
                        break
                    if choices[p][i] is not None:
                        for e in choices[p][i]:
                            self._vq_books[p].put(w, e)
                    i += 1

    # ---- convenience: whole-signal encode ------------------------------- #

    def encode_signal(self, pcm: np.ndarray,
                      flags: Optional[List[bool]] = None) -> List[bytes]:
        """PCM (S, C) int16 or float -> audio packets.

        Default: short blocks, half-overlap; decoding and concatenating
        reproduces the signal (minus the lapping prime/drain).  With
        ``flags`` (one bool per block, True = long), mixed block sizes
        are emitted with the correct window transition flags: block
        starts follow s_{i+1} = s_i + 3n_i/4 - n_{i+1}/4 so the slope
        centers align (1.3.2 lapping)."""
        if pcm.dtype == np.int16:
            x = pcm.astype(np.float64) / 32768.0
        else:
            x = np.asarray(pcm, np.float64)
        if flags is None:
            n = self.n0
            hop = n // 2
            s = x.shape[0]
            npad = (-(s - n) % hop) if s > n else n - s
            x = np.pad(x, ((hop, hop + npad), (0, 0)))
            return [self.encode_block(x[st:st + n])
                    for st in range(0, x.shape[0] - n + 1, hop)]
        if not self.long_blocks:
            raise ValueError("mixed flags need long_blocks=True")
        sizes = [self.n1 if f else self.n0 for f in flags]
        total = sum(3 * n // 4 for n in sizes) + self.n1
        x = np.pad(x, ((self.n1 // 2,
                        max(0, total - x.shape[0])), (0, 0)))
        packets = []
        pos = 0
        for i, f in enumerate(flags):
            n = sizes[i]
            prev_long = flags[i - 1] if i > 0 else True
            next_long = flags[i + 1] if i + 1 < len(flags) else True
            packets.append(self.encode_block(
                x[pos:pos + n], long_block=f, prev_long=prev_long,
                next_long=next_long))
            if i + 1 < len(flags):
                pos += 3 * n // 4 - sizes[i + 1] // 4
        return packets
