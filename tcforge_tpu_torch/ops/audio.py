"""PCM audio ops: the libtcaudio layer, in plain torch.

The port of ``tcforge_tpu/ops/audio.py``: ``tca_convert_from/to``,
``tca_amplify``, ``tca_mono_to_stereo`` and ``tca_stereo_to_mono`` over
(..., S, C) sample tensors, the linear and the polyphase windowed-sinc
resamplers, and ``StreamingResampler``, the exact streaming resampler
behind ``-E``.  The canonical sample format is int16.

The JAX engine runs these ops in two forms, and the port computes the
one of the branch it is on:

- jitted (the whole audio step without ``-E``, and ``-E``'s volume and
  channel step): XLA's CPU code contracts ``x * scale + 0.5`` and the
  taps' multiply-adds into fused multiply-adds (``ops/fp32.py``
  ``fma32``);
- op by op (the filters of the ``-E`` branch): every product and sum
  rounded on its own.

``StreamingResampler`` is the JAX package's host stage by design
(float32 numpy, ``einsum`` over carried history, batch-size-invariant):
it stays numpy on the host here too, the same code.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from tcforge_tpu_torch.ops.fp32 import fma32


def u8_to_s16(pcm: torch.Tensor) -> torch.Tensor:
    """TCA_U8 -> S16: center at 0 and scale by 256 (8-bit unsigned
    samples biased by 0x80)."""
    return ((pcm.to(torch.int32) - 0x80) << 8).to(torch.int16)


def s16_to_u8(pcm: torch.Tensor) -> torch.Tensor:
    """S16 -> TCA_U8: high byte + 0x80 bias."""
    return ((pcm.to(torch.int32) >> 8) + 0x80).to(torch.uint8)


def amplify(pcm: torch.Tensor, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Volume scaling with clip counting (tca_amplify,
    libtcaudio/tcaudio.c:154-207): v = floor(sample*scale + 0.5), as the
    fused multiply-add of the jitted step, clamped to the int16 range;
    every clipped sample counts.  Returns (scaled_pcm, nclip), nclip a
    0-d int32 tensor on the pcm's device."""
    v = torch.floor(fma32(pcm.to(torch.float32), np.float32(scale), 0.5))
    v = v.to(torch.int32)
    clipped = (v > 0x7FFF) | (v < -0x8000)
    nclip = clipped.sum(dtype=torch.int32)
    out = v.clamp(-0x8000, 0x7FFF).to(torch.int16)
    return out, nclip


def mono_to_stereo(pcm: torch.Tensor) -> torch.Tensor:
    """Duplicate mono samples into both channels (tca_mono_to_stereo).
    (..., S, 1) -> (..., S, 2)."""
    if pcm.shape[-1] != 1:
        raise ValueError("mono_to_stereo expects 1 channel")
    return torch.cat([pcm, pcm], dim=-1)


def stereo_to_mono(pcm: torch.Tensor) -> torch.Tensor:
    """Rounded per-sample average (tca_stereo_to_mono): (l + r + 1) / 2
    in int32, the C division truncating toward zero."""
    if pcm.shape[-1] != 2:
        raise ValueError("stereo_to_mono expects 2 channels")
    s = pcm[..., 0].to(torch.int32) + pcm[..., 1].to(torch.int32) + 1
    mono = torch.where(s < 0, -((-s) >> 1), s >> 1)
    return mono.to(torch.int16)[..., None]


def resample_linear(pcm: torch.Tensor, src_rate: int,
                    dst_rate: int) -> torch.Tensor:
    """Linear-interpolation resampler, op by op (no JAX path jits it).
    (..., S, C) -> (..., S', C) with S' = floor(S * dst/src)."""
    if src_rate == dst_rate:
        return pcm
    s = pcm.shape[-2]
    new_s = int(s * dst_rate // src_rate)
    pos = (torch.arange(new_s, dtype=torch.float32, device=pcm.device)
           * np.float32(src_rate / dst_rate))
    idx0 = torch.floor(pos).to(torch.int32).clamp(0, s - 1)
    idx1 = (idx0 + 1).clamp(0, s - 1)
    frac = (pos - idx0.to(torch.float32))[..., None]
    a = pcm[..., idx0.long(), :].to(torch.float32)
    b = pcm[..., idx1.long(), :].to(torch.float32)
    out = a + (b - a) * frac
    return torch.round(out).to(pcm.dtype)


# --------------------------------------------------------------------- #
# Polyphase windowed-sinc resampler: per output sample a row of 32
# contributor indices and coefficients (libtcvideo/zoom.c's contributor
# design applied to audio), gathered and reduced.

_RESAMPLE_CACHE = {}
_LANES = 8            # float32 lanes of XLA's vectorized tap loop


def _kaiser(n, beta: float):
    return np.i0(beta * np.sqrt(np.clip(
        1.0 - (2.0 * n / (len(n) - 1) - 1.0) ** 2, 0.0, 1.0))) \
        / np.i0(beta)


def resample_coeffs(s_in: int, src_rate: int, dst_rate: int,
                    taps: int = 32, beta: float = 9.0):
    """Contributor lists for windowed-sinc resampling: per output
    sample a (taps,) index row into the input and a (taps,) coefficient
    row.  Windowed-sinc interpolation at output times n*src/dst, cutoff
    min(1, dst/src), Kaiser window, edge-replicated boundaries, rows
    normalized to unit DC gain."""
    key = (s_in, src_rate, dst_rate, taps, beta)
    hit = _RESAMPLE_CACHE.get(key)
    if hit is not None:
        return hit
    s_out = int(s_in * dst_rate // src_rate)
    ratio = src_rate / dst_rate
    fc = min(1.0, 1.0 / ratio)
    t = np.arange(s_out, dtype=np.float64) * ratio       # (s_out,)
    base = np.floor(t).astype(np.int64)
    half = taps // 2
    k = np.arange(-half + 1, half + 1)                   # (taps,)
    j = base[:, None] + k[None, :]                       # sample indices
    x = j - t[:, None]                                   # distance
    h = fc * np.sinc(fc * x)
    win = _kaiser(np.arange(taps), beta)
    h = h * win[None, :]
    h /= h.sum(axis=1, keepdims=True)
    jc = np.clip(j, 0, s_in - 1)                         # edge replicate
    out = (jc.astype(np.int32), h.astype(np.float32))
    _RESAMPLE_CACHE[key] = out
    return out


_DEVICE_COEFFS = {}


def _device_coeffs(s_in: int, src_rate: int, dst_rate: int, taps: int,
                   beta: float, device: torch.device):
    """``resample_coeffs`` on ``device`` (int64 indices, (s_out, taps, 1)
    coefficients), copied there once per shape."""
    key = (s_in, src_rate, dst_rate, taps, beta, str(device))
    hit = _DEVICE_COEFFS.get(key)
    if hit is None:
        idx, coef = resample_coeffs(s_in, src_rate, dst_rate, taps, beta)
        hit = (torch.from_numpy(idx).long().to(device),
               torch.from_numpy(coef)[..., None].to(device))
        _DEVICE_COEFFS[key] = hit
    return hit


def resample_poly(pcm: torch.Tensor, src_rate: int, dst_rate: int,
                  taps: int = 32, beta: float = 9.0,
                  jitted: bool = True) -> torch.Tensor:
    """Polyphase windowed-sinc resampling of (..., S, C) PCM: the
    (s_out, taps) contributor windows gathered and each output the sum
    of its taps' products.  ``jitted``: in the order of the jitted step
    (eight lanes of fused multiply-adds, then halved); else in tap
    order, each product and sum rounded on its own, as op-by-op JAX
    computes it."""
    if src_rate == dst_rate:
        return pcm
    idx, coef = _device_coeffs(pcm.shape[-2], src_rate, dst_rate, taps,
                               beta, pcm.device)
    gathered = pcm.to(torch.float32)[..., idx, :]     # (..., s_out, taps, C)
    out = torch.zeros(gathered.shape[:-2] + gathered.shape[-1:],
                      dtype=torch.float32, device=pcm.device)
    if jitted:
        # XLA's CPU code vectorizes the tap loop: eight lanes, tap t's
        # product fused into lane t % 8, the lanes then halved in turn
        lanes = [out] * _LANES
        for t in range(taps):
            lanes[t % _LANES] = fma32(gathered[..., t, :], coef[:, t],
                                      lanes[t % _LANES])
        while len(lanes) > 1:
            half = len(lanes) // 2
            lanes = [lanes[i] + lanes[i + half] for i in range(half)]
        out = lanes[0]
    else:
        prod = gathered * coef
        for t in range(taps):
            out = out + prod[..., t, :]
    if pcm.dtype == torch.int16:
        out = torch.round(out).clamp(-32768, 32767)
    return out.to(pcm.dtype)


class StreamingResampler:
    """Exact streaming polyphase windowed-sinc resampler (host/numpy).

    Same contributor math as :func:`resample_poly`, but the output
    time grid is GLOBAL (t_m = m * src / dst from stream start) and
    the filter history carries across calls, so the output is
    batch-size-invariant: feeding the same stream in chunks of 4 or
    4096 samples yields identical bytes.  Outputs whose sinc window
    extends past the received input are held back until more input
    (or :meth:`flush`, which edge-replicates the final samples like
    the block resampler's right boundary).  The JAX package's own host
    stage, the same numpy code.
    """

    def __init__(self, src_rate: int, dst_rate: int, channels: int,
                 taps: int = 32, beta: float = 9.0):
        g = math.gcd(int(src_rate), int(dst_rate))
        self.src = int(src_rate) // g
        self.dst = int(dst_rate) // g
        self.channels = channels
        self.taps = taps
        self.half = taps // 2
        self.fc = min(1.0, self.dst / self.src)
        self._win = _kaiser(np.arange(taps), beta)
        self._k = np.arange(-self.half + 1, self.half + 1)
        self._buf = np.zeros((0, channels), np.float32)
        self._start = 0          # global input index of _buf[0]
        self._m = 0              # next global output index
        self._total = 0          # input samples received
        self._dtype = None
        # the coefficient row depends only on frac(m*src/dst), which
        # cycles with period dst: every phase computed once
        self._phases = None
        if self.dst <= 8192:
            fracs = np.arange(self.dst) / self.dst
            x = self._k[None, :] - fracs[:, None]
            h = self.fc * np.sinc(self.fc * x) * self._win[None, :]
            h /= h.sum(axis=1, keepdims=True)
            self._phases = h.astype(np.float32)

    def _emit(self, m_hi: int, pad_tail: int = 0):
        if m_hi <= self._m:
            return np.zeros((0, self.channels),
                            self._dtype or np.int16)
        ms = np.arange(self._m, m_hi, dtype=np.int64)
        base = (ms * self.src) // self.dst
        if self._phases is not None:
            h = self._phases[(ms * self.src) % self.dst]
        else:
            t = ms * (self.src / self.dst)
            x = base[:, None] + self._k[None, :] - t[:, None]
            h = (self.fc * np.sinc(self.fc * x)
                 * self._win[None, :])
            h /= h.sum(axis=1, keepdims=True)
            h = h.astype(np.float32)
        buf = self._buf
        if pad_tail:
            buf = np.concatenate([buf, np.repeat(buf[-1:], pad_tail,
                                                 axis=0)])
        # contributor windows are consecutive taps: a strided window
        # view and einsum for the body; rows whose window would start
        # before the buffer (the stream head) take the clipped gather
        idx0 = (base - self._start - self.half + 1)
        nb = len(buf)
        ok = (idx0 >= 0) & (idx0 + self.taps <= nb)
        if ok.all():
            win = np.lib.stride_tricks.sliding_window_view(
                buf, self.taps, axis=0)          # (nb-taps+1, C, taps)
            out = np.einsum("sct,st->sc", win[idx0], h,
                            optimize=True)
        else:
            out = np.empty((len(ms), self.channels), np.float32)
            sel = np.nonzero(ok)[0]
            if len(sel):
                win = np.lib.stride_tricks.sliding_window_view(
                    buf, self.taps, axis=0)
                out[sel] = np.einsum("sct,st->sc", win[idx0[sel]],
                                     h[sel], optimize=True)
            rest = np.nonzero(~ok)[0]
            # the sample indices of these rows' windows (only they need
            # them: the body's come from the window view)
            j_r = base[rest, None] + self._k[None, :] - self._start
            jc = np.clip(j_r, 0, nb - 1)
            out[rest] = (buf[jc] * h[rest][:, :, None]).sum(axis=1)
        if self._dtype == np.int16:
            out = np.clip(np.rint(out), -32768, 32767)
        self._m = int(m_hi)
        return out.astype(self._dtype or np.float32)

    def process(self, pcm):
        """Feed (S, C) samples; return every output sample whose
        window is fully covered by the input so far."""
        if self._dtype is None:
            self._dtype = pcm.dtype.type if hasattr(pcm, "dtype") \
                else np.int16
        pcm = np.asarray(pcm, np.float32).reshape(-1, self.channels)
        self._buf = np.concatenate([self._buf, pcm])
        self._total += len(pcm)
        t_last = self._total - 1 - self.half
        if t_last < 0:
            return np.zeros((0, self.channels), self._dtype)
        m_hi = ((t_last + 1) * self.dst - 1) // self.src + 1
        out = self._emit(m_hi)
        # drop the consumed head (keep what future windows reach)
        keep_from = max(self._start,
                        (self._m * self.src) // self.dst
                        - self.half + 1)
        self._buf = self._buf[keep_from - self._start:]
        self._start = keep_from
        return out

    def flush(self):
        """Emit the held-back tail (right-edge replication); the total
        output count is floor(total_in * dst / src), like the block
        resampler's."""
        if self._dtype is None or self._total == 0:
            return np.zeros((0, self.channels), np.int16)
        m_hi = (self._total * self.dst) // self.src
        return self._emit(m_hi, pad_tail=self.taps)
