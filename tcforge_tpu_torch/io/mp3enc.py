# Copied from tcforge_tpu/io/mp3enc.py; its BitWriter comes from io/mpeg2host.py (the jax-free copy of io/mpeg2codec.py's head), _emit skips a region coded with table 0 (all zeros, no bits; the source raises there), and only the package name in its imports differs.
"""Native MPEG-1 audio Layer III (MP3) encoder.

The reference encodes MP3 through lame (export/encode_lame.c; the
bridge path here uses libavcodec's lame binding).  This is a
from-scratch spec encoder in the dist10/shine tradition so MP3
encodes with no external library at all:

- the Layer III hybrid filterbank run FORWARD: the shared 32-band
  polyphase analysis (io/mpaenc.py), per-granule frequency inversion,
  36->18 MDCT with the sine window (long blocks, block_type 0; the
  forward transform is ``IM36.T @ (win * t36) / 9`` — probed to the
  filterbank's ~84 dB near-perfect-reconstruction floor against
  io/mp3dec.py's synthesis chain), and the INVERSE aliasing-reduction
  butterflies (the decoder applies the forward ones, 2.4.3.4.10.1);
- global-gain-only quantization (scalefactors 0, scalefac_compress 0
  — spec-valid; the inner loop bisects global_gain until the coded
  granule fits its even share of the frame's main-data bits);
- real Huffman coding: per-region exact-cost table selection over
  all 32 big-value tables (ESC tables with linbits included) and the
  cheaper of count1 tables A/B, built by walking the SAME canonical
  (lens, symbols) arrays io/mp3dec.py decodes with;
- main_data_begin = 0 always (every frame self-contained: no bit
  reservoir, unused bits become stuffing — spec-valid, slightly
  lower efficiency than lame).

Validated by round-trip SNR through the in-tree decoder AND
libavcodec (tests/test_mp3enc.py)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import mp3dec as M
from .mp2dec import (_L23_KBPS_V2, _L3_KBPS, _MPA_RATES,
                     _MPA_RATES_V2, _MPA_RATES_V25)
from .mpaenc import _analyze
from .mpeg2host import BitWriter

__all__ = ["Mp3Encoder", "NativeMp3Encoder"]

_SFI = {44100: 0, 48000: 1, 32000: 2}


# ------------------------------------------------------------------ #
# Huffman ENCODE tables: walk the same canonical (lens, symbols)
# arrays the decoder's LUTs are built from.
# ------------------------------------------------------------------ #

def _build_encode_tables():
    # vidx -> (code[256], len[256]) indexed by sym = x<<4 | y
    vtabs = [None]
    pos = 0
    for n in M._T["sizes"].tolist():
        lens = M._T["lens"][pos:pos + n].tolist()
        syms = M._T["symbols"][pos:pos + n].tolist()
        codes = np.zeros(256, np.int64)
        lns = np.zeros(256, np.int64)
        code = 0
        for ln, sym in zip(lens, syms):
            codes[sym] = code >> (32 - ln)
            lns[sym] = ln
            code += 1 << (32 - ln)
        vtabs.append((codes, lns))
        pos += n
    # table_select -> (vidx, linbits, max_x) with max_x from the syms
    # actually present (vidx 0 = the all-zero table)
    sel = []
    for t in range(32):
        vidx, linbits = int(M._HUFF_DATA[t][0]), int(M._HUFF_DATA[t][1])
        if vidx == 0:
            sel.append((0, 0, 0))
            continue
        lns = vtabs[vidx][1]
        present = np.nonzero(lns)[0]
        max_x = int((present >> 4).max())
        sel.append((vidx, linbits, max_x))
    return vtabs, sel


_VTABS, _TSEL = _build_encode_tables()
_QA_BITS = M._T["quad_bits"][0].astype(int)
_QA_CODES = M._T["quad_codes"][0].astype(int)

_F36 = M._IM36.T / 9.0                     # forward MDCT (18, 36)
_CS, _CA = M._CS, M._CA


def _antialias_inv(x: np.ndarray) -> np.ndarray:
    """Inverse of mp3dec._antialias (the rotation's det is 1)."""
    out = x.copy()
    for sb in range(1, 32):
        a = out[sb - 1, 17:9:-1].copy()
        b = out[sb, 0:8].copy()
        out[sb - 1, 17:9:-1] = a * _CS + b * _CA
        out[sb, 0:8] = b * _CS - a * _CA
    return out


def _region_cost(ix: np.ndarray, tsel: int) -> Optional[int]:
    """Exact Huffman bits for a big-values region under one table,
    or None if the table cannot represent the region."""
    vidx, linbits, max_x = _TSEL[tsel]
    a = np.abs(ix[0::2])
    b = np.abs(ix[1::2])
    mx = max(int(a.max()) if len(a) else 0,
             int(b.max()) if len(b) else 0)
    if vidx == 0:
        return None if mx > 0 else 0
    limit = max_x if linbits == 0 else 15 + (1 << linbits) - 1
    if mx > limit:
        return None
    ca = np.minimum(a, 15)
    cb = np.minimum(b, 15)
    syms = (ca.astype(np.int64) << 4) | cb.astype(np.int64)
    lns = _VTABS[vidx][1][syms]
    if np.any(lns == 0):
        return None                         # sym not in this table
    bits = int(lns.sum())
    bits += int((a != 0).sum()) + int((b != 0).sum())   # sign bits
    if linbits:
        bits += linbits * int((ca == 15).sum() + (cb == 15).sum())
    return bits


def _best_table(ix: np.ndarray) -> Tuple[int, int]:
    """(table_select, bits) cheapest over all 32 table codes."""
    best_t, best_c = 0, None
    for t in range(32):
        c = _region_cost(ix, t)
        if c is not None and (best_c is None or c < best_c):
            best_t, best_c = t, c
    if best_c is None:
        raise AssertionError("mp3enc: no table covers region "
                             f"(max {int(np.abs(ix).max())})")
    return best_t, best_c


def _count1_cost(quads: np.ndarray) -> Tuple[int, int]:
    """(count1table, bits) for the (n, 4) array of |v|<=1 values."""
    nz = (quads != 0)
    signs = int(nz.sum())
    codes = (nz[:, 0] << 3 | nz[:, 1] << 2 | nz[:, 2] << 1
             | nz[:, 3]).astype(int)
    cost_a = int(_QA_BITS[codes].sum()) + signs
    cost_b = 4 * len(quads) + signs
    return (0, cost_a) if cost_a <= cost_b else (1, cost_b)


class _GranPlan:
    __slots__ = ("ix", "gg", "bigv", "c1end", "tables", "r0", "r1",
                 "count1table", "bits")


def _plan_granule(xr: np.ndarray, budget: int, sfreq: int
                  ) -> _GranPlan:
    """Quantize xr with the largest-precision global_gain whose
    Huffman coding fits budget bits."""
    absxr = np.abs(xr)
    mx = float(absxr.max())
    bil = M._BAND_INDEX_LONG[sfreq]

    def quantize(gg: int) -> np.ndarray:
        step = 2.0 ** (-(gg - 210) / 4.0)
        ixf = (absxr * step) ** 0.75
        ix = np.floor(ixf + 0.4054).astype(np.int64)
        return np.where(xr < 0, -ix, ix)

    def plan_for(gg: int) -> _GranPlan:
        p = _GranPlan()
        p.gg = gg
        ix = quantize(gg)
        if np.abs(ix).max() > 8206:
            p.bits = 1 << 30
            p.ix = ix
            return p
        nz = np.nonzero(ix)[0]
        lastnz = int(nz[-1]) + 1 if len(nz) else 0
        big = np.nonzero(np.abs(ix) > 1)[0]
        bigv = (int(big[-1]) + 2) // 2 * 2 if len(big) else 0
        bigv = min(bigv, 576)
        c1len = (lastnz - bigv + 3) // 4 * 4 if lastnz > bigv else 0
        if bigv + c1len > 576:
            # quads would overrun 576: absorb the tail into the
            # big-values pairs (|v| <= 1 is codable there too)
            bigv = min((lastnz + 1) // 2 * 2, 576)
            c1len = 0
        c1end = bigv + c1len
        # fixed region0/1 split clamped to the band table
        r0, r1 = 7, 7
        rb1 = min(int(bil[r0 + 1]), bigv)
        rb2 = min(int(bil[r0 + r1 + 2]), bigv)
        bits = 0
        tables = []
        for lo, hi in ((0, rb1), (rb1, rb2), (rb2, bigv)):
            if hi > lo:
                t, c = _best_table(ix[lo:hi])
            else:
                t, c = 0, 0
            tables.append(t)
            bits += c
        quads = ix[bigv:c1end].reshape(-1, 4)
        c1t, c1c = _count1_cost(np.abs(quads))
        bits += c1c
        p.ix, p.bigv, p.c1end = ix, bigv, c1end
        p.tables, p.r0, p.r1 = tables, r0, r1
        p.count1table, p.bits = c1t, bits
        return p

    if mx <= 0.0:
        return plan_for(210)
    # smallest gg keeping max|ix| <= 8206
    gg_lo = 0
    step_needed = (8206.5 / (mx ** 0.75)) if mx > 0 else 1.0
    # step = 2^(-(gg-210)/4) <= 8206.5/mx^{3/4}
    import math
    gg_lo = max(0, int(math.ceil(210 - 4 * math.log2(step_needed))))
    gg_lo = min(gg_lo, 255)
    lo, hi = gg_lo, 255
    best = None
    while lo < hi:                          # bits ~ monotone in gg
        mid = (lo + hi) // 2
        p = plan_for(mid)
        if p.bits <= budget:
            hi = mid
            best = p
        else:
            lo = mid + 1
    if best is None or best.gg != lo:
        best = plan_for(lo)
    while best.bits > budget and best.gg < 255:  # monotonicity slack
        best = plan_for(best.gg + 1)
    if best.bits > budget:
        raise AssertionError("mp3enc: granule cannot fit budget")
    return best


class Mp3Encoder:
    """Stateful Layer III encoder: polyphase history and MDCT
    overlap carry across frames; feed exactly 1152 samples."""

    def __init__(self, rate: int, channels: int, bitrate_kbps: int):
        # version from the rate family: MPEG-1, MPEG-2 LSF (half
        # rates, ONE 576-sample granule per frame) or MPEG-2.5
        # (quarter rates, same LSF frame layout)
        if rate in _MPA_RATES:
            self.version, vbits = 1, 3
            sfi = _MPA_RATES.index(rate)
            self.sfreq = sfi
            kbps_tab = _L3_KBPS
            self.samples = 1152
            self._slots = 144000
        elif rate in _MPA_RATES_V2:
            self.version, vbits = 2, 2
            sfi = _MPA_RATES_V2.index(rate)
            self.sfreq = 3 + sfi
            kbps_tab = _L23_KBPS_V2
            self.samples = 576
            self._slots = 72000
        elif rate in _MPA_RATES_V25:
            self.version, vbits = 25, 0
            sfi = _MPA_RATES_V25.index(rate)
            self.sfreq = 6 + sfi
            kbps_tab = _L23_KBPS_V2
            self.samples = 576
            self._slots = 72000
        else:
            raise ValueError(f"mp3enc: unsupported rate {rate}")
        if channels not in (1, 2):
            raise ValueError("mp3enc: 1 or 2 channels only")
        self.rate = rate
        self.channels = channels
        kbps = min(kbps_tab[1:], key=lambda b:
                   (abs(b - int(bitrate_kbps)), b))
        self.bitrate_kbps = kbps
        self.frame_bytes = self._slots * kbps // rate
        self._hist = np.zeros((channels, 480))
        self._prev = np.zeros((channels, 32, 18))
        bri = kbps_tab.index(kbps)
        mode = 3 if channels == 1 else 0
        self._header = ((0x7FF << 21) | (vbits << 19) | (1 << 17)
                        | (1 << 16) | (bri << 12) | (sfi << 10)
                        | (mode << 6))

    def _granule_xr(self, ch: int, gran: np.ndarray) -> np.ndarray:
        """(32,18) freq-inverted subband samples -> (576,) xr."""
        prev = self._prev[ch]
        t36 = np.concatenate((prev, gran), axis=1)  # (32, 36)
        X = (t36 * M._WIN_NORMAL[None, :]) @ _F36.T  # (32, 18)
        self._prev[ch] = gran
        return _antialias_inv(X).reshape(-1)

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        if pcm.shape != (self.samples, self.channels):
            raise ValueError(
                f"mp3enc: need ({self.samples}, {self.channels}) "
                f"samples, got {pcm.shape}")
        if pcm.dtype.kind in "iu":
            x = pcm.astype(np.float64) / 32768.0
        else:
            x = pcm.astype(np.float64)
        nch = self.channels
        ngr = 2 if self.version == 1 else 1

        plans: List[List[_GranPlan]] = []
        if self.version == 1:
            side_bits = 136 if nch == 1 else 256
        else:                   # LSF: 8+1/2 + 63 per channel
            side_bits = 72 if nch == 1 else 136
        total_main = self.frame_bytes * 8 - 32 - side_bits
        budget = total_main // (ngr * nch)
        for ch in range(nch):
            s = _analyze(x[:, ch], self._hist[ch])  # (18*ngr, 32)
            self._hist[ch] = np.concatenate(
                (self._hist[ch], x[:, ch]))[-480:]
            row = []
            for gr in range(ngr):
                gran = s[18 * gr:18 * gr + 18].T * M._FREQINV
                xr = self._granule_xr(ch, gran)
                row.append(_plan_granule(xr, budget, self.sfreq))
            plans.append(row)

        # main data first (to know part2_3_length exactly = plan.bits)
        md = BitWriter()
        bil = M._BAND_INDEX_LONG[self.sfreq]
        for gr in range(ngr):
            for ch in range(nch):
                p = plans[ch][gr]
                self._emit(md, p, bil)
        main = md.bytes()

        w = BitWriter()
        w.put(self._header, 32)
        if self.version == 1:
            w.put(0, 9)                     # main_data_begin
            w.put(0, 5 if nch == 1 else 3)  # private bits
            for _ch in range(nch):
                w.put(0, 4)                 # scfsi
        else:
            w.put(0, 8)                     # main_data_begin (LSF)
            w.put(0, 1 if nch == 1 else 2)
        for gr in range(ngr):
            for ch in range(nch):
                p = plans[ch][gr]
                w.put(p.bits, 12)           # part2_3 (scalefac bits 0)
                w.put(p.bigv // 2, 9)
                w.put(p.gg, 8)
                # scalefac_compress: 9 bits in LSF, 4 in MPEG-1
                w.put(0, 9 if self.version != 1 else 4)
                w.put(0, 1)                 # window_switching off
                w.put(p.tables[0], 5)
                w.put(p.tables[1], 5)
                w.put(p.tables[2], 5)
                w.put(p.r0, 4)
                w.put(p.r1, 3)
                if self.version == 1:
                    w.put(0, 1)             # preflag (absent in LSF)
                w.put(0, 1)                 # scalefac_scale
                w.put(p.count1table, 1)
        out = w.bytes() + main
        if len(out) > self.frame_bytes:
            raise AssertionError("mp3enc: frame overflow "
                                 f"{len(out)} > {self.frame_bytes}")
        return out + b"\x00" * (self.frame_bytes - len(out))

    def _emit(self, w: BitWriter, p: _GranPlan, bil) -> None:
        ix = p.ix
        start_bits = None
        rb1 = min(int(bil[p.r0 + 1]), p.bigv)
        rb2 = min(int(bil[p.r0 + p.r1 + 2]), p.bigv)
        for (lo, hi), tsel in zip(((0, rb1), (rb1, rb2),
                                   (rb2, p.bigv)), p.tables):
            if hi <= lo:
                continue
            vidx, linbits, _mx = _TSEL[tsel]
            if vidx == 0:
                # table 0 codes an all-zero region in no bits (the JAX
                # source looks its codes up and raises)
                continue
            codes, lens = _VTABS[vidx]
            lmask = (1 << linbits) - 1
            for i in range(lo, hi, 2):
                vx, vy = int(ix[i]), int(ix[i + 1])
                ax, ay = abs(vx), abs(vy)
                cx, cy = min(ax, 15), min(ay, 15)
                sym = (cx << 4) | cy
                w.put(int(codes[sym]), int(lens[sym]))
                if cx == 15 and linbits:
                    w.put((ax - 15) & lmask, linbits)
                if ax:
                    w.put(1 if vx < 0 else 0, 1)
                if cy == 15 and linbits:
                    w.put((ay - 15) & lmask, linbits)
                if ay:
                    w.put(1 if vy < 0 else 0, 1)
        for i in range(p.bigv, p.c1end, 4):
            q = ix[i:i + 4]
            code = (int(q[0] != 0) << 3 | int(q[1] != 0) << 2
                    | int(q[2] != 0) << 1 | int(q[3] != 0))
            if p.count1table:
                w.put(15 - code, 4)
            else:
                w.put(int(_QA_CODES[code]), int(_QA_BITS[code]))
            for v in q:
                if v:
                    w.put(1 if v < 0 else 0, 1)


class NativeMp3Encoder:
    """AvAudioEncoder-shaped streaming wrapper so the lame module can
    fall back to the native encoder when the bridge is absent."""

    frame_size = 1152
    extradata = b""

    def __init__(self, rate: int, channels: int, bitrate_bps: int):
        self._enc = Mp3Encoder(rate, channels,
                               max(8, bitrate_bps // 1000))
        self.frame_size = self._enc.samples
        self._pend = np.zeros((0, channels), np.int16)
        self._out: List[bytes] = []

    def set_framed(self, framed: bool = True) -> None:
        pass

    def feed(self, pcm: np.ndarray) -> None:
        pcm = np.asarray(pcm, np.int16).reshape(-1,
                                                self._enc.channels)
        self._pend = np.concatenate((self._pend, pcm))
        n = self._enc.samples
        while self._pend.shape[0] >= n:
            self._out.append(self._enc.encode_frame(self._pend[:n]))
            self._pend = self._pend[n:]

    def flush(self) -> None:
        if self._pend.shape[0]:
            pad = np.zeros((self._enc.samples - self._pend.shape[0],
                            self._enc.channels), np.int16)
            self._out.append(self._enc.encode_frame(
                np.concatenate((self._pend, pad))))
            self._pend = self._pend[:0]

    def read_packets(self) -> List[bytes]:
        out = self._out
        self._out = []
        return out

    def close(self) -> None:
        self._out = []
