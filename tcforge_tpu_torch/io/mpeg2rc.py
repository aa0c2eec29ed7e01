# Copied from tcforge_tpu/io/mpeg2enc.py lines 31-31 and 37-40 and 43-49 and 1192-1316; the jax-free parts of the MPEG-2 encoder: the macroblock modes, the alternate scan and TM5 rate control.
import numpy as np
MB_INTRA = 1
MB_PATTERN = 2
MB_BACKWARD = 4
MB_FORWARD = 8
# alternate scan (13818-2 figure 7-3, kScanAlt) — better run structure
# for interlaced content; selected per picture by the alternate_scan bit
SCAN_ALT = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63])
class RateController:
    """TM5 single-pass rate control (Test Model 5 step 1-2): the
    global complexity model (X = S*Q per picture type) allocates
    each picture a target from the REMAINING GOP budget, and the
    quantiser is chosen to HIT that target (q = X/T — the spend a
    picture of complexity X makes at quantiser q is ~X/q).

    This replaced a fixed-per-type-target single-virtual-buffer
    scheme that overspent ~8x on the first I picture at low rates
    (q0 was honored blindly), then wedged q at the rail for the rest
    of the GOP and coded the NEXT GOP's I at q31 — measured 1.6 dB
    behind libavcodec at equal bytes; the target-driven form closes
    that to parity.  The remaining-bits counter R carries deficits
    across GOPs (the only cross-GOP feedback needed).  2-pass
    (-R 2) overrides targets proportional to pass-1 complexity."""

    KP, KB = 1.0, 1.4                   # TM5 Kp/Kb
    # I pictures get a quality bias: their spend propagates through
    # every predicted picture of the GOP, so the RD-optimal I share
    # exceeds TM5's uniform-quality model.  0.35 measured best on a
    # smooth/noisy content grid (+2.0 dB smooth, +0.2 noisy, rate
    # adherence within 7%); applied on the ALLOCATION side so the
    # budget stays consistent.
    IBIAS = 0.35

    def __init__(self, bitrate_kbps: int, fps: float, gop_n: int,
                 gop_m: int, q0: int, complexities=None,
                 qmin: int = 1, qmax: int = 31):
        self.qmin, self.qmax = qmin, qmax
        br = bitrate_kbps * 1000.0
        self._bpf = br / max(1e-6, fps)
        self._gop_n = max(1, gop_n)
        self._gop_m = max(1, gop_m)
        # TM5 initial complexities (step 1)
        self._X = {1: 160.0 * br / 115.0, 2: 60.0 * br / 115.0,
                   3: 42.0 * br / 115.0}
        self._R = 0.0                   # remaining GOP bits
        self._np = self._nb = 0         # P/B pictures left in GOP
        self.reaction = 2.0 * self._bpf         # TM5 r
        d0 = 10.0 * self.reaction / 31.0
        self._d = {1: d0, 2: self.KP * d0, 3: self.KB * d0}
        self.qscale = max(qmin, min(qmax, q0))
        self._unseen = {1, 2, 3}
        self._target = self._bpf
        self._cx = list(complexities) if complexities else None
        self._cx_mean = (sum(self._cx) / len(self._cx)
                         if self._cx else 0.0)
        self._pic = 0

    def pick_qscale(self, pic_type: int = 2) -> int:
        # D-pictures (type 4) account like I (intra, self-contained)
        t = 1 if pic_type == 4 else pic_type
        if t == 1:
            # new GOP: add its budget (R carries +/- from the last)
            self._R += self._gop_n * self._bpf
            n_anchor = self._gop_n // self._gop_m
            self._np = max(0, n_anchor - 1)
            self._nb = self._gop_n - n_anchor
        Xi, Xp, Xb = self._X[1], self._X[2], self._X[3]
        R = max(self._R, self._bpf)     # deep deficit: keep moving
        if t == 1:
            # IBIAS < 1 inflates the I's claimed complexity in the
            # ALLOCATION so the GOP budget stays consistent with the
            # biased quantiser below (an I coded at q = X*b/T spends
            # T/b — biasing q without enlarging T overshot rate by
            # up to 1.28x in the sweep)
            Xe = Xi / self.IBIAS
            T = R / (1.0 + self._np * Xp / (Xe * self.KP)
                     + self._nb * Xb / (Xe * self.KB))
        elif t == 2:
            T = R / max(1e-6, self._np
                        + self._nb * self.KP * Xb / (self.KB * Xp))
        else:
            T = R / max(1e-6, self._nb
                        + self._np * self.KB * Xp / (self.KP * Xb))
        T = max(self._bpf / 8.0, min(T, self._gop_n * self._bpf))
        if self._cx and self._cx_mean > 0:
            i = min(self._pic, len(self._cx) - 1)
            T = self._bpf * self._cx[i] / self._cx_mean
        self._target = T
        # step 2, hybrid: I pictures are too rare for the buffer
        # integrator to converge (2 samples per 16 frames), so they
        # use the proportional form q = X/T directly — X_I is
        # updated once per GOP and T_I is the model's allocation;
        # P/B are frequent and one-picture noisy, so they keep the
        # damped virtual-buffer form (a proportional P loop
        # period-2 oscillated: q 28,22,31,21,31... measured)
        if t == 1:
            q = self._X[1] / T          # true X vs enlarged T
        else:
            q = 31.0 * self._d[t] / self.reaction
        self.qscale = max(self.qmin, min(self.qmax, int(round(q))))
        return self.qscale

    def update(self, pic_type: int, bits: int) -> None:
        t = 1 if pic_type == 4 else pic_type
        if self._pic == 0 and t == 1:
            # the very first picture measures how far the content is
            # from TM5's blind initial complexities; rescale the
            # still-initial P/B buffers by that surprise so the
            # FIRST P doesn't code at the optimistic d0 quantiser
            # (measured: noisy content's first P at q10 spent 42x
            # its target before any feedback existed)
            surprise = float(bits) * self.qscale / self._X[1]
            surprise = max(0.5, min(4.0, surprise))
            self._d[2] *= surprise
            self._d[3] *= surprise
        # step-1 complexity feedback: first sample of a type
        # replaces the blind initial guess outright, later samples
        # are EMA-damped (X = S * Q)
        if t in self._unseen:
            self._unseen.discard(t)
            self._X[t] = max(1.0, float(bits) * self.qscale)
        else:
            self._X[t] = max(1.0, 0.5 * self._X[t]
                             + 0.5 * float(bits) * self.qscale)
        self._d[t] += bits - self._target
        self._d[t] = max(self.reaction / 62.0,
                         min(2.0 * self.reaction, self._d[t]))
        self._R -= bits
        if t == 2 and self._np > 0:
            self._np -= 1
        elif t == 3 and self._nb > 0:
            self._nb -= 1
        self._pic += 1
