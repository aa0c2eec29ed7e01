# Copied from tcforge_tpu/io/mpaenc.py; its BitWriter comes from io/mpeg2host.py (the jax-free copy of io/mpeg2codec.py's head), and only the package name in its imports differs.
"""Native MPEG-1 audio Layer II encoder (ISO 11172-3).

The reference encodes MP2 through external tools (the mp2enc/toolame
role of export/encode_mp2enc.c; the bridge path here uses
libavcodec's twolame-family encoder).  This is a from-scratch spec
implementation so VCD/SVCD/DVD audio encodes with no external
library at all: the 32-band polyphase analysis filterbank, lossless
scfsi selection, greedy MNR bit allocation over the B.2a-d tables,
midtread quantization with grouped triplets, and frame packing in
the exact field order of io/mp2dec.py's oracle-validated reader.

Quantization/table constants are shared with io/mp2dec.py (the
published spec's numeric tables).  The analysis window is the
synthesis window D of Table B.3 scaled by 1/32 (the spec's Table C.1
relationship); correctness is validated by round-trip SNR through
the in-tree decoder AND the bundled libavcodec decoder
(tests/test_mpaenc.py) — Layer II conformance is tolerance-based by
definition, so the oracle match is an SNR bound, not bit-exactness.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .mp2dec import (QUANT_BITS, QUANT_STEPS, SCALEFACTORS, _alloc_table,
                     _D, _L2_KBPS, _L23_KBPS_V2, _MPA_RATES,
                     _MPA_RATES_V2)
from .mpeg2host import BitWriter

__all__ = ["Mp2Encoder", "NativeAudioEncoder"]


# ------------------------------------------------------------------ #
# Analysis filterbank.  Flattened to one (32, 512) matrix H so a whole
# frame's 36 granule-samples are three matmuls per channel:
#   S[k] = sum_n cos((2k+1)((n&63)-16)pi/64) * C[n] * x[t-n]
# with C = D/32 (Table C.1).  Windows are newest-first slices of the
# input, so H is applied to time-reversed strides.
# ------------------------------------------------------------------ #

_C = _D / 32.0
_MCOS = np.cos((2 * np.arange(32) + 1)[:, None]
               * ((np.arange(512) & 63) - 16)[None, :] * np.pi / 64)
_H = (_MCOS * _C[None, :]).T.copy()        # (512, 32), x_rev @ _H


def _analyze(x: np.ndarray, history: np.ndarray) -> np.ndarray:
    """x: (32*n,) float in [-1,1); history: previous 480 samples.
    Returns (n, 32) subband samples (n = 36 for a 1152-sample
    MPEG-1 frame, 18 for an LSF 576-sample frame) and updates
    nothing (caller keeps the tail)."""
    full = np.concatenate((history, x))
    n = len(x) // 32
    # step s consumes samples up to index 480 + 32(s+1); window is the
    # last 512 samples, newest first
    idx = (480 + 32 * (np.arange(n)[:, None] + 1) - 1
           - np.arange(512)[None, :])
    return full[idx] @ _H


# SNR proxy per quantization class: 20*log10(steps) (the spec's Table
# C.5 values track this within ~1 dB; only the greedy ORDER depends
# on it, reconstruction never does).
_SNR_DB = tuple(20.0 * np.log10(s) for s in QUANT_STEPS)
# sample bits per subband for 12 granules of 3 samples
_SAMPLE_BITS = tuple(12 * -b if b < 0 else 36 * b for b in QUANT_BITS)

# Layer II bitrate/mode legality (spec Table B.2 note): these kbps are
# mono-only below, stereo-only above.
_L2_MONO_ONLY = {32, 48, 56, 80}
_L2_STEREO_ONLY = {224, 256, 320, 384}


def _legal_bitrate(kbps: int, nch: int, version: int = 1) -> int:
    if version != 1:                       # LSF: no mode restrictions
        return min(_L23_KBPS_V2[1:], key=lambda b: (abs(b - kbps), b))
    cand = [b for b in _L2_KBPS[1:]
            if not (nch == 1 and b in _L2_STEREO_ONLY)
            and not (nch == 2 and b in _L2_MONO_ONLY)]
    return min(cand, key=lambda b: (abs(b - kbps), b))


class Mp2Encoder:
    """Stateful Layer II encoder: 480-sample analysis history carries
    across frames; feed exactly 1152 samples per call."""

    def __init__(self, rate: int, channels: int, bitrate_kbps: int):
        if rate in _MPA_RATES:
            version = 1
        elif rate in _MPA_RATES_V2:
            version = 2                    # MPEG-2 LSF
        else:
            raise ValueError(f"mpaenc: unsupported sample rate {rate} "
                             f"(Layer II: {_MPA_RATES + _MPA_RATES_V2})")
        if channels not in (1, 2):
            raise ValueError("mpaenc: 1 or 2 channels only")
        self.rate = rate
        self.channels = channels
        self.version = version
        self.bitrate_kbps = _legal_bitrate(int(bitrate_kbps), channels,
                                           version)
        self.frame_bytes = 144000 * self.bitrate_kbps // rate
        self.table, self.sblimit = _alloc_table(
            rate, self.bitrate_kbps, channels, version)
        self._hist = np.zeros((channels, 480), np.float64)
        # header: sync(11) ver layer=10 prot=1(no CRC) | bri sfi
        # pad=0 priv=0 | mode modeext=0 copy=0 orig=0 emph=00
        if version == 1:
            bri = _L2_KBPS.index(self.bitrate_kbps)
            sfi = _MPA_RATES.index(rate)
            vbits = 3
        else:
            bri = _L23_KBPS_V2.index(self.bitrate_kbps)
            sfi = _MPA_RATES_V2.index(rate)
            vbits = 2
        mode = 3 if channels == 1 else 0
        self._header = ((0x7FF << 21) | (vbits << 19) | (2 << 17)
                        | (1 << 16) | (bri << 12) | (sfi << 10)
                        | (mode << 6))

    # -------------------------------------------------------------- #

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        """pcm: (1152, channels) int16 or float in [-1,1)."""
        if pcm.shape != (1152, self.channels):
            raise ValueError(
                f"mpaenc: need (1152, {self.channels}) samples, got "
                f"{pcm.shape}")
        if pcm.dtype.kind in "iu":
            x = pcm.astype(np.float64) / 32768.0
        else:
            x = pcm.astype(np.float64)
        nch, sbl, table = self.channels, self.sblimit, self.table

        # subband analysis: (nch, 36, 32)
        sbs = np.stack([_analyze(x[:, ch], self._hist[ch])
                        for ch in range(nch)])
        self._hist = np.ascontiguousarray(x[-480:].T)

        # scalefactor indices per (ch, part, sb): smallest sf >= max|s|
        parts = np.abs(sbs).reshape(nch, 3, 12, 32).max(axis=2)
        fi = np.floor(
            3.0 * (1.0 - np.log2(np.where(parts > 0, parts, 1.0)))
        ).astype(np.int64)
        fi = np.clip(np.where(parts > 0, fi, 62), 0, 62)
        sfv = np.array(SCALEFACTORS[:63])
        # float-edge fixups both directions
        for _ in range(2):
            fi = np.where(sfv[fi] < parts, np.maximum(fi - 1, 0), fi)
            fi = np.where((fi < 62) & (sfv[np.minimum(fi + 1, 62)]
                                       >= parts),
                          fi + 1, fi)
        scf = fi                                   # (nch, 3, sb<=32)

        # lossless scfsi per (ch, sb)
        scfsi = np.zeros((nch, 32), np.int64)
        eq12 = scf[:, 0, :] == scf[:, 1, :]
        eq23 = scf[:, 1, :] == scf[:, 2, :]
        scfsi[eq12 & eq23] = 2
        scfsi[eq12 & ~eq23] = 1
        scfsi[~eq12 & eq23] = 3
        nscf = np.choose(scfsi, [3, 2, 1, 2])
        scf_cost = 2 + 6 * nscf                    # bits once alloc>0

        # greedy MNR bit allocation
        level = parts.max(axis=1)                  # (nch, 32) max |s|
        with np.errstate(divide="ignore"):
            level_db = np.where(level > 0,
                                20.0 * np.log10(level * 32768.0 + 1.0),
                                -np.inf)
        budget = self.frame_bytes * 8 - 32
        budget -= nch * sum(table[sb][0] for sb in range(sbl))
        alloc = np.zeros((nch, 32), np.int64)

        def inc_cost(ch: int, sb: int) -> Optional[int]:
            a = alloc[ch][sb]
            classes = table[sb][1]
            if a >= len(classes):
                return None
            cost = _SAMPLE_BITS[classes[a]]
            if a == 0:
                cost += int(scf_cost[ch][sb])
            else:
                cost -= _SAMPLE_BITS[classes[a - 1]]
            return cost

        def snr_now(ch: int, sb: int) -> float:
            a = alloc[ch][sb]
            return _SNR_DB[table[sb][1][a - 1]] if a else 0.0

        live = [(ch, sb) for ch in range(nch) for sb in range(sbl)
                if level[ch][sb] > 0]
        while live:
            best, best_d = None, None
            for ch, sb in live:
                d = level_db[ch][sb] - snr_now(ch, sb)
                if best_d is None or d > best_d:
                    best, best_d = (ch, sb), d
            if best_d is not None and best_d < -20.0:
                break                              # all transparent
            ch, sb = best
            c = inc_cost(ch, sb)
            if c is None or c > budget:
                live.remove((ch, sb))
                continue
            alloc[ch][sb] += 1
            budget -= c

        # quantize: raw = round((frac*steps + steps - 1)/2)
        w = BitWriter()
        w.put(self._header, 32)
        for sb in range(sbl):
            for ch in range(nch):
                w.put(int(alloc[ch][sb]), table[sb][0])
        for sb in range(sbl):
            for ch in range(nch):
                if alloc[ch][sb]:
                    w.put(int(scfsi[ch][sb]), 2)
        for sb in range(sbl):
            for ch in range(nch):
                if not alloc[ch][sb]:
                    continue
                si = scfsi[ch][sb]
                f = scf[ch, :, sb]
                if si == 0:
                    tx = (f[0], f[1], f[2])
                elif si == 1:
                    tx = (f[0], f[2])
                elif si == 2:
                    tx = (f[0],)
                else:
                    tx = (f[0], f[1])
                for v in tx:
                    w.put(int(v), 6)

        # per-(ch,sb) raw sample codes for the whole frame up front
        raws = np.zeros((nch, 36, 32), np.int64)
        stepv = np.zeros((nch, 32), np.int64)
        for ch in range(nch):
            for sb in range(sbl):
                a = alloc[ch][sb]
                if not a:
                    continue
                steps = QUANT_STEPS[table[sb][1][a - 1]]
                stepv[ch][sb] = steps
                sfc = sfv[scf[ch, :, sb]]          # (3,)
                frac = sbs[ch, :, sb] / np.repeat(sfc, 12)
                r = np.rint((frac * steps + steps - 1) / 2.0)
                raws[ch, :, sb] = np.clip(r, 0, steps - 1)

        for gr in range(12):
            for sb in range(sbl):
                for ch in range(nch):
                    a = alloc[ch][sb]
                    if not a:
                        continue
                    cls = table[sb][1][a - 1]
                    bits = QUANT_BITS[cls]
                    t0, t1, t2 = raws[ch, 3 * gr:3 * gr + 3, sb]
                    if bits < 0:
                        steps = stepv[ch][sb]
                        w.put(int(t0 + steps * (t1 + steps * t2)),
                              -bits)
                    else:
                        w.put(int(t0), bits)
                        w.put(int(t1), bits)
                        w.put(int(t2), bits)
        out = w.bytes()
        if len(out) > self.frame_bytes:
            raise AssertionError("mpaenc: frame overflow "
                                 f"{len(out)} > {self.frame_bytes}")
        return out + b"\x00" * (self.frame_bytes - len(out))


class NativeAudioEncoder:
    """AvAudioEncoder-shaped streaming wrapper (feed/read_packets/
    flush/frame_size/extradata) so encoder modules can fall back to
    the native Layer II encoder when the FFmpeg bridge is absent."""

    frame_size = 1152
    extradata = b""

    def __init__(self, rate: int, channels: int, bitrate_bps: int):
        self._enc = Mp2Encoder(rate, channels,
                               max(8, bitrate_bps // 1000))
        self._pend = np.zeros((0, channels), np.int16)
        self._out: List[bytes] = []

    def set_framed(self, framed: bool = True) -> None:
        pass                                       # always framed

    def feed(self, pcm: np.ndarray) -> None:
        pcm = np.asarray(pcm, np.int16).reshape(-1,
                                                self._enc.channels)
        self._pend = np.concatenate((self._pend, pcm))
        while self._pend.shape[0] >= 1152:
            self._out.append(self._enc.encode_frame(self._pend[:1152]))
            self._pend = self._pend[1152:]

    def flush(self) -> None:
        if self._pend.shape[0]:
            pad = np.zeros((1152 - self._pend.shape[0],
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
