# Copied from tcforge_tpu/io/aacenc.py; its BitWriter comes from io/mpeg2host.py (the jax-free copy of io/mpeg2codec.py's head), and only the package name in its imports differs.
"""Native AAC-LC encoder.

Completes the in-tree audio matrix: every audio codec this framework
carries now encodes AND decodes without external libraries (the
reference needed faac for this role, encode/encode_faac.c).  A
deliberately simple spec-valid encoder in the mp3enc tradition:

- sine-shaped windows with FULL block switching on the push/
  flush_frames path (r5): a high-passed attack detector plus a
  one-frame lookahead place LONG_START / EIGHT_SHORT (8 groups of
  1, grouping bits 0) / LONG_STOP around transients — measured
  pre-echo improvement around attacks, lavc-decodable; the legacy
  encode_frame API stays ONLY_LONG;
- the 2048-point MDCT shared with io/aacdec.py (forward =
  ``2048 * IM.T @ (win * x)`` — probed to ~250 dB perfect
  reconstruction against the decoder's filterbank);
- one global_gain per frame chosen by bisection so the coded frame
  meets its average bit budget (AAC frames are variable-length, so
  no reservoir/stuffing games are needed), scalefactors flat (the
  1-bit zero-delta code per band);
- real Huffman coding: exact-cost codebook selection per scalefactor
  band over all 11 spectral codebooks (ESC escapes included), then
  run-merged section_data;
- stereo as one CPE with common_window=1 and ms_mask_present=0.

Output: raw access units (feed them to the ADTS wrapper below or a
container).  Validated by round-trip through the in-tree
oracle-exact decoder AND libavcodec (tests/test_aacenc.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import aacdec as D
from .mpeg2host import BitWriter

__all__ = ["AacEncoder", "NativeAacEncoder", "adts_header"]


def _encode_luts():
    """Per-codebook (codes, lens) arrays indexed by symbol, plus the
    scalefactor codebook — built from the same decode tables."""
    D._init_tables()
    D._init_tuples()
    cbs = []
    pos = 0
    for n in D._T["cb_sizes"].tolist():
        cbs.append((D._T["cb_codes"][pos:pos + n].astype(np.int64),
                    D._T["cb_bits"][pos:pos + n].astype(np.int64)))
        pos += n
    sf = (D._T["sf_codes"].astype(np.int64),
          D._T["sf_bits"].astype(np.int64))
    return cbs, sf


_CBS, _SF = _encode_luts()


def adts_header(frame_len: int, sfi: int, channels: int) -> bytes:
    ln = frame_len + 7
    h = bytearray(7)
    h[0] = 0xFF
    h[1] = 0xF1                            # MPEG-4, layer 0, no CRC
    h[2] = (1 << 6) | (sfi << 2) | (channels >> 2)
    h[3] = ((channels & 3) << 6) | (ln >> 11)
    h[4] = (ln >> 3) & 0xFF
    h[5] = ((ln & 7) << 5) | 0x1F
    h[6] = 0xFC
    return bytes(h)


def _cb_cost(q: np.ndarray, cb: int) -> int:
    """Exact Huffman bits to code band q with codebook cb, or a huge
    number when the codebook cannot represent it."""
    BIG = 1 << 30
    dim, lav, signed = D._CB_META[cb - 1]
    a = np.abs(q)
    mx = int(a.max()) if len(a) else 0
    if cb == 11:
        if mx > 8191:
            return BIG
    elif mx > lav:
        return BIG
    codes, lens = _CBS[cb - 1]
    span = 2 * lav + 1 if signed else lav + 1
    vals = np.minimum(a, lav) if cb == 11 else a
    if signed:
        vals = q + lav
    grp = vals.reshape(-1, dim)
    syms = np.zeros(len(grp), np.int64)
    for d in range(dim):
        syms = syms * span + grp[:, d]
    bits = int(lens[syms].sum())
    if not signed:
        bits += int((a != 0).sum())
    if cb == 11:
        esc = a >= 16
        if esc.any():
            for v in a[esc].tolist():
                nn = int(v).bit_length() - 1
                bits += (nn - 4) + 1 + nn
    return bits


class AacEncoder:
    """Stateful AAC-LC encoder: the MDCT history carries across
    frames; feed exactly 1024 samples per call; emits raw access
    units (no ADTS)."""

    def __init__(self, rate: int, channels: int, bitrate_kbps: int):
        if rate not in D.SAMPLE_RATES:
            raise ValueError(f"aacenc: unsupported rate {rate}")
        if channels not in (1, 2):
            raise ValueError("aacenc: 1 or 2 channels only")
        D._init_tables()
        self.rate = rate
        self.channels = channels
        self.sfi = D.SAMPLE_RATES.index(rate)
        self.bitrate_kbps = max(8 * channels, int(bitrate_kbps))
        self.frame_bits = int(self.bitrate_kbps * 1000 * 1024 / rate)
        self.swb = D._SWB_LONG[self.sfi]
        self.nswb = len(self.swb) - 1
        # bandwidth cap: spend bits below ~(bitrate-derived) cutoff
        per_ch = self.bitrate_kbps / channels
        cutoff = min(rate / 2.0, 5000.0 + per_ch * 90.0)
        bins = int(cutoff / (rate / 2.0) * 1024)
        self.max_sfb = 1
        for s in range(self.nswb):
            if int(self.swb[s + 1]) <= bins:
                self.max_sfb = s + 1
        self._hist = np.zeros((channels, 1024))
        W = D._windows()
        self._win = np.concatenate([W[(0, 1024)], W[(0, 1024)][::-1]])
        self._F = D._imdct_mat(1024).T * 2048.0
        # EIGHT_SHORT support (push/flush path): forward short MDCT,
        # transition windows, short swb table, one-frame lookahead
        wl, ws = W[(0, 1024)], W[(0, 128)]
        self._win_start = np.concatenate(
            [wl, np.ones(448), ws[::-1], np.zeros(448)])
        self._win_stop = np.concatenate(
            [np.zeros(448), ws, np.ones(448), wl[::-1]])
        self._win_short = np.concatenate([ws, ws[::-1]])
        self._Fs = D._imdct_mat(128).T * 256.0
        self.swb_s = D._SWB_SHORT[self.sfi]
        per_ch = self.bitrate_kbps / channels
        cutoff = min(rate / 2.0, 5000.0 + per_ch * 90.0)
        bins_s = int(cutoff / (rate / 2.0) * 128)
        self.max_sfb_s = 1
        for s in range(len(self.swb_s) - 1):
            if int(self.swb_s[s + 1]) <= bins_s:
                self.max_sfb_s = s + 1
        self._pend_pcm = None            # one-frame lookahead
        self._pend_transient = False
        self._last_seq = 0

    def asc(self) -> bytes:
        """AudioSpecificConfig (LC) for container extradata."""
        return bytes([(2 << 3) | (self.sfi >> 1),
                      ((self.sfi & 1) << 7) | (self.channels << 3)])

    # -------------------------------------------------------------- #

    def _quantize(self, x: np.ndarray, gg: int) -> np.ndarray:
        step = 2.0 ** (-0.25 * (gg - 100))
        mag = np.floor(np.abs(x * step) ** 0.75 + 0.4054)
        return np.where(x < 0, -mag, mag).astype(np.int64)

    def _plan(self, q: np.ndarray) -> Tuple[list, int]:
        """Per-sfb best codebook + total spectral/section/sf bits."""
        cbs = []
        bits = 0
        for s in range(self.max_sfb):
            lo, hi = int(self.swb[s]), int(self.swb[s + 1])
            band = q[lo:hi]
            if not band.any():
                cbs.append(0)
                continue
            best_cb, best_c = 11, None
            for cb in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11):
                c = _cb_cost(band, cb)
                if best_c is None or c < best_c:
                    best_cb, best_c = cb, c
            cbs.append(best_cb)
            bits += best_c + 1             # +1: zero-delta sf code
        # section_data: runs of equal codebooks, 5-bit len, esc 31
        run = 1
        for s in range(1, self.max_sfb + 1):
            if s < self.max_sfb and cbs[s] == cbs[s - 1]:
                run += 1
                continue
            bits += 4 + 5 * (1 + (run // 31))
            run = 1
        return cbs, bits

    def _fit_gain(self, x: np.ndarray, budget: int
                  ) -> Tuple[int, np.ndarray, list]:
        mx = float(np.abs(x).max())
        if mx <= 0:
            q = np.zeros(1024, np.int64)
            cbs, _ = self._plan(q)
            return 100, q, cbs
        import math
        # smallest gg keeping max|q| <= 8191
        gg_lo = max(0, int(math.ceil(
            100 + 4 * math.log2(mx / (8191.5 ** (4.0 / 3.0))))))
        gg_lo = min(gg_lo, 255)
        lo, hi = gg_lo, 255
        best = None
        while lo < hi:
            mid = (lo + hi) // 2
            q = self._quantize(x, mid)
            cbs, bits = self._plan(q)
            if bits <= budget:
                hi = mid
                best = (mid, q, cbs)
            else:
                lo = mid + 1
        if best is None or best[0] != lo:
            q = self._quantize(x, lo)
            cbs, bits = self._plan(q)
            while bits > budget and lo < 255:
                lo += 1
                q = self._quantize(x, lo)
                cbs, bits = self._plan(q)
            best = (lo, q, cbs)
        return best

    def _emit_ics_info(self, w: BitWriter, seq: int = 0) -> None:
        w.put(0, 1)                        # ics_reserved
        w.put(seq, 2)
        w.put(0, 1)                        # sine shape
        if seq == 2:                       # EIGHT_SHORT
            w.put(self.max_sfb_s, 4)
            w.put(0, 7)                    # grouping: 8 groups of 1
        else:
            w.put(self.max_sfb, 6)
            w.put(0, 1)                    # predictor_data_present

    # ------------------------------------------------------------- #
    # EIGHT_SHORT path (push/flush API with one-frame lookahead)
    # ------------------------------------------------------------- #

    @staticmethod
    def _transient(pcm: np.ndarray) -> bool:
        """Attack detector on the HIGH-PASSED signal (x[n]-x[n-1]):
        steady tones cancel, attacks spike — a 128-sample subblock
        whose HP energy jumps an order of magnitude over the running
        level marks the frame for EIGHT_SHORT."""
        x = pcm.astype(np.float64)
        if pcm.dtype.kind in "iu":
            x = x / 32768.0
        # signed per-channel HP (rectifying first hides attacks that
        # oppose the local waveform sign), worst channel per subblock
        hp = np.diff(x, axis=0, prepend=x[:1])
        e = (hp.reshape(8, 128, -1) ** 2).sum(axis=1).max(axis=1)
        run = max(float(e[0]), 1e-5)
        for j in range(1, 8):
            if e[j] > 10.0 * run and e[j] > 1e-3:
                return True
            run = max(0.7 * run + 0.3 * float(e[j]), 1e-5)
        return False

    def _plan_short(self, q8: np.ndarray) -> Tuple[list, int]:
        """q8 (8, 128): per-group (window) codebooks + bit total
        under the 8-groups-of-1 layout (grouping bits 0)."""
        cbs8 = []
        bits = 0
        for g in range(8):
            cbs = []
            for s in range(self.max_sfb_s):
                lo, hi = int(self.swb_s[s]), int(self.swb_s[s + 1])
                band = q8[g, lo:hi]
                if not band.any():
                    cbs.append(0)
                    continue
                best_cb, best_c = 11, None
                for cb in range(1, 12):
                    c = _cb_cost(band, cb)
                    if best_c is None or c < best_c:
                        best_cb, best_c = cb, c
                cbs.append(best_cb)
                bits += best_c + 1         # zero-delta sf code
            run = 1
            for s in range(1, self.max_sfb_s + 1):
                if s < self.max_sfb_s and cbs[s] == cbs[s - 1]:
                    run += 1
                    continue
                bits += 4 + 3 * (1 + (run // 7))
                run = 1
            cbs8.append(cbs)
        return cbs8, bits

    def _fit_gain_short(self, x8: np.ndarray, budget: int):
        mx = float(np.abs(x8).max())
        if mx <= 0:
            q = np.zeros((8, 128), np.int64)
            cbs8, _ = self._plan_short(q)
            return 100, q, cbs8
        import math
        gg_lo = max(0, int(math.ceil(
            100 + 4 * math.log2(mx / (8191.5 ** (4.0 / 3.0))))))
        lo, hi = min(gg_lo, 255), 255
        best = None
        while lo < hi:
            mid = (lo + hi) // 2
            q = self._quantize(x8, mid)
            cbs8, bits = self._plan_short(q)
            if bits <= budget:
                hi = mid
                best = (mid, q, cbs8)
            else:
                lo = mid + 1
        if best is None or best[0] != lo:
            q = self._quantize(x8, lo)
            cbs8, bits = self._plan_short(q)
            while bits > budget and lo < 255:
                lo += 1
                q = self._quantize(x8, lo)
                cbs8, bits = self._plan_short(q)
            best = (lo, q, cbs8)
        return best

    def _emit_body_short(self, w: BitWriter, q8, cbs8) -> None:
        # section_data: per group, 3-bit run lengths (esc 7)
        for g in range(8):
            cbs = cbs8[g]
            s = 0
            while s < self.max_sfb_s:
                cb = cbs[s]
                run = 1
                while s + run < self.max_sfb_s \
                        and cbs[s + run] == cb:
                    run += 1
                w.put(cb, 4)
                r = run
                while r >= 7:
                    w.put(7, 3)
                    r -= 7
                w.put(r, 3)
                s += run
        code0, len0 = int(_SF[0][60]), int(_SF[1][60])
        for g in range(8):
            for s in range(self.max_sfb_s):
                if cbs8[g][s] != 0:
                    w.put(code0, len0)
        w.put(0, 1)                        # pulse absent
        w.put(0, 1)                        # tns absent
        w.put(0, 1)                        # gain control absent
        for g in range(8):
            self._emit_spectra(w, q8[g], cbs8[g], self.swb_s,
                               self.max_sfb_s)

    def _code_frame(self, pcm: np.ndarray, seq: int) -> bytes:
        """One access unit at the given window_sequence."""
        x = pcm.astype(np.float64)
        nch = self.channels
        full = np.concatenate((self._hist, x.T), axis=1)
        self._hist = np.ascontiguousarray(x.T)
        short = seq == 2
        if short:
            coefs = []
            for ch in range(nch):
                rows = np.empty((8, 128))
                for j in range(8):
                    seg = full[ch][448 + 128 * j:704 + 128 * j]
                    rows[j] = self._Fs @ (seg * self._win_short)
                coefs.append(rows)
        else:
            win = (self._win, self._win_start,
                   None, self._win_stop)[seq]
            coefs = [self._F @ (full[ch] * win)
                     for ch in range(nch)]
        budget_all = self.frame_bits - 16 - 56
        per_ch = max(200, budget_all // nch - 120)
        w = BitWriter()
        if nch == 1:
            w.put(0, 3)                    # SCE
            w.put(0, 4)
            if short:
                gg, q8, cbs8 = self._fit_gain_short(coefs[0],
                                                    per_ch)
                w.put(gg, 8)
                self._emit_ics_info(w, 2)
                self._emit_body_short(w, q8, cbs8)
            else:
                gg, q, cbs = self._fit_gain(coefs[0], per_ch)
                w.put(gg, 8)
                self._emit_ics_info(w, seq)
                self._emit_body(w, q, cbs)
        else:
            w.put(1, 3)                    # CPE
            w.put(0, 4)
            w.put(1, 1)                    # common_window
            self._emit_ics_info(w, 2 if short else seq)
            w.put(0, 2)                    # ms_mask_present = 0
            for ch in range(nch):
                if short:
                    gg, q8, cbs8 = self._fit_gain_short(coefs[ch],
                                                        per_ch)
                    w.put(gg, 8)
                    self._emit_body_short(w, q8, cbs8)
                else:
                    gg, q, cbs = self._fit_gain(coefs[ch], per_ch)
                    w.put(gg, 8)
                    self._emit_body(w, q, cbs)
        w.put(7, 3)                        # END
        return w.bytes()

    def push(self, pcm: np.ndarray) -> List[bytes]:
        """Window-switching path: feed 1024 samples; returns the
        access units ready so far (output lags input by ONE frame —
        the lookahead places LONG_START before a transient).  Call
        flush_frames() at EOS for the final unit."""
        if pcm.shape != (1024, self.channels):
            raise ValueError(f"aacenc: need (1024, {self.channels})"
                             f" samples, got {pcm.shape}")
        t_cur = self._transient(pcm)
        out: List[bytes] = []
        if self._pend_pcm is not None:
            if self._pend_transient:
                seq = 2
            elif t_cur:
                seq = 1                    # LONG_START
            elif self._last_seq == 2:
                seq = 3                    # LONG_STOP
            else:
                seq = 0
            out.append(self._code_frame(self._pend_pcm, seq))
            self._last_seq = seq
        self._pend_pcm = np.array(pcm)
        self._pend_transient = t_cur
        return out

    def flush_frames(self) -> List[bytes]:
        if self._pend_pcm is None:
            return []
        seq = 2 if self._pend_transient else \
            (3 if self._last_seq == 2 else 0)
        out = [self._code_frame(self._pend_pcm, seq)]
        self._pend_pcm = None
        self._last_seq = seq
        return out

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        if pcm.shape != (1024, self.channels):
            raise ValueError(f"aacenc: need (1024, {self.channels}) "
                             f"samples, got {pcm.shape}")
        x = pcm.astype(np.float64)
        nch = self.channels
        full = np.concatenate((self._hist, x.T), axis=1)  # (nch, 2048)
        self._hist = np.ascontiguousarray(x.T)
        coefs = [self._F @ (full[ch] * self._win) for ch in range(nch)]

        side_fixed = 3 + 4 + (1 + 5 + 8 if nch == 1 else 0)
        budget_all = self.frame_bits - 16 - 56  # END + ADTS header
        per_ch = max(200, budget_all // nch - 80)
        plans = [self._fit_gain(coefs[ch], per_ch)
                 for ch in range(nch)]

        w = BitWriter()
        if nch == 1:
            w.put(0, 3)                    # SCE
            w.put(0, 4)                    # tag
            gg, q, cbs = plans[0]
            w.put(gg, 8)
            self._emit_ics_info(w)
            self._emit_body(w, q, cbs)
        else:
            w.put(1, 3)                    # CPE
            w.put(0, 4)                    # tag
            w.put(1, 1)                    # common_window
            self._emit_ics_info(w)
            w.put(0, 2)                    # ms_mask_present = 0
            for ch in range(nch):
                gg, q, cbs = plans[ch]
                w.put(gg, 8)
                self._emit_body(w, q, cbs)
        w.put(7, 3)                        # END
        return w.bytes()

    def _emit_body(self, w: BitWriter, q: np.ndarray,
                   cbs: list) -> None:
        """Everything in individual_channel_stream after global_gain
        and (optional) ics_info."""
        s = 0
        while s < self.max_sfb:
            cb = cbs[s]
            run = 1
            while s + run < self.max_sfb and cbs[s + run] == cb:
                run += 1
            w.put(cb, 4)
            r = run
            while r >= 31:
                w.put(31, 5)
                r -= 31
            w.put(r, 5)
            s += run
        code0, len0 = int(_SF[0][60]), int(_SF[1][60])
        for s in range(self.max_sfb):
            if cbs[s] != 0:
                w.put(code0, len0)
        w.put(0, 1)
        w.put(0, 1)
        w.put(0, 1)
        self._emit_spectra(w, q, cbs, self.swb, self.max_sfb)

    @staticmethod
    def _emit_spectra(w: BitWriter, q: np.ndarray, cbs: list,
                      swb, max_sfb: int) -> None:
        for s in range(max_sfb):
            cb = cbs[s]
            if cb == 0:
                continue
            dim, lav, signed = D._CB_META[cb - 1]
            codes, lens = _CBS[cb - 1]
            span = 2 * lav + 1 if signed else lav + 1
            lo, hi = int(swb[s]), int(swb[s + 1])
            for i in range(lo, hi, dim):
                vals = q[i:i + dim]
                if signed:
                    sym = 0
                    for v in vals.tolist():
                        sym = sym * span + (v + lav)
                    w.put(int(codes[sym]), int(lens[sym]))
                else:
                    sym = 0
                    clipped = []
                    for v in vals.tolist():
                        av = min(abs(v), lav if cb != 11 else 16)
                        clipped.append(av)
                        sym = sym * span + av
                    w.put(int(codes[sym]), int(lens[sym]))
                    for v, av in zip(vals.tolist(), clipped):
                        if av:
                            w.put(1 if v < 0 else 0, 1)
                    if cb == 11:
                        for v, av in zip(vals.tolist(), clipped):
                            if av == 16:
                                mag = abs(v)
                                nn = mag.bit_length() - 1
                                w.put((1 << (nn - 4 + 1)) - 2,
                                      nn - 4 + 1)
                                w.put(mag & ((1 << nn) - 1), nn)


class NativeAacEncoder:
    """AvAudioEncoder-shaped streaming wrapper so the faac module can
    fall back to the native encoder when the bridge is absent."""

    frame_size = 1024

    def __init__(self, rate: int, channels: int, bitrate_bps: int):
        self._enc = AacEncoder(rate, channels,
                               max(16, bitrate_bps // 1000))
        self.extradata = self._enc.asc()
        self._pend = np.zeros((0, channels), np.int16)
        self._out: List[bytes] = []

    def set_framed(self, framed: bool = True) -> None:
        pass

    def feed(self, pcm: np.ndarray) -> None:
        pcm = np.asarray(pcm, np.int16).reshape(-1,
                                                self._enc.channels)
        self._pend = np.concatenate((self._pend, pcm))
        while self._pend.shape[0] >= 1024:
            # push path: window switching with one-frame lookahead
            self._out.extend(self._enc.push(self._pend[:1024]))
            self._pend = self._pend[1024:]

    def flush(self) -> None:
        if self._pend.shape[0]:
            pad = np.zeros((1024 - self._pend.shape[0],
                            self._enc.channels), np.int16)
            self._out.extend(self._enc.push(
                np.concatenate((self._pend, pad))))
            self._pend = self._pend[:0]
        self._out.extend(self._enc.flush_frames())

    def read_packets(self) -> List[bytes]:
        out = self._out
        self._out = []
        return out

    def close(self) -> None:
        self._out = []
