"""MPEG-4 part 2 Simple Profile encoder (``-y xvid``) of the port.

The JAX package's ``tcforge_tpu/io/mpeg4enc.py`` ``Mpeg4NativeEncoder``
with the same public surface (its constructor's arguments, ``encode``,
``push``, ``flush``, ``keep_recon_log``, ``recon_log``) and the same
bytes.  Each VOP:

- the frame arrives on its device and is padded to the coded grid there
  (``mpeg4encdev.pad_planes``); it is never copied to the host whole;
- rate control picks the quantizer (``io/mpeg2rc.py``'s
  ``RateController``, the JAX encoder's TM5 controller);
- the kernels decide and code every macroblock (``ops/kernels.py``:
  ``mpeg4_enc_me`` for a P-VOP, ``mpeg4_enc_bme`` for a B-VOP, then
  ``mpeg4_enc_blocks``), which also writes an anchor's reconstruction,
  kept on the device with the anchor's records (a B-VOP's direct mode
  reads the co-located vectors and skips from them);
- the records come to the host in one copy, and the host writes the
  bits in raster order as ``_encode_ivop``, ``_encode_pvop`` and
  ``_encode_bvop`` do: the gradient DC prediction, the median-predicted
  vector deltas (per block, progressively, for 4MV) wrapped into the
  fcode 1 range, a B row's forward and backward predictors, the
  co-located skips that cost no bits, ``modb``/``modb2`` and DBQUANT;
  then the rate controller takes the VOP's bits.

The syntax writer (bit writer, VLC tables, block, vector and DC coding,
the stream and VOP headers) is ``io/mpeg4syntax.py``, a pinned copy of
the JAX encoder's.  The GOP rule (an I-VOP when the next group reaches
``gop`` frames since the last one), the B-VOPs' coded order after their
anchor and ``trb``/``trd``, and the modulo time base are the JAX
encoder's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.io import _mp4tables as T
from tcforge_tpu_torch.io import mpeg4encdev as D
from tcforge_tpu_torch.io.mpeg4dec import Mpeg4Decoder, _log2up
from tcforge_tpu_torch.io.mpeg4syntax import (_CBPY_CODES, _MCBPC_P,
                                              BitWriter, Mpeg4NativeEncoder,
                                              _write_block, _write_mv)

__all__ = ["Mpeg4Encoder"]


class Mpeg4Encoder(Mpeg4NativeEncoder):
    """One coded chunk a frame, the stream headers before the first;
    ``gop`` the I-VOP interval, ``qscale`` the quantizer without rate
    control.  Frames are (y, u, v) tensors on the device that codes
    them."""

    def __init__(self, width: int, height: int, fps: float = 25.0,
                 qscale: int = 5, gop: int = 12,
                 search_range: int = 12, bframes: int = 0,
                 keep_recon_log: bool = False,
                 four_mv: bool = False, bitrate_kbps: int = 0,
                 qmin: int = 2, qmax: int = 31):
        if not (1 <= qscale <= 31):
            raise ValueError("mpeg4enc: qscale out of range")
        if not (0 <= bframes <= 7):
            raise ValueError("mpeg4enc: bframes out of range")
        self.four_mv = bool(four_mv)
        self._rc = None
        if bitrate_kbps:
            from tcforge_tpu_torch.io.mpeg2rc import RateController
            self._rc = RateController(
                bitrate_kbps, fps, max(1, gop),
                bframes + 1, qscale, qmin=max(1, qmin),
                qmax=min(31, qmax))
        self.width, self.height = width, height
        self.mbw = (width + 15) // 16
        self.mbh = (height + 15) // 16
        self.qscale = qscale
        self.gop = max(1, gop)
        self.search = min(search_range, 14)
        self.bframes = bframes
        self.time_inc_res = max(1, int(round(fps)))
        self.time_inc_bits = _log2up(self.time_inc_res)
        self._frame = 0
        # the modulo time base (the decoder's _time_base and
        # _last_time_base: a B-VOP counts from the base before the last
        # anchor moved it)
        self._tb = 0
        self._prev_tb = 0
        # the anchors' coded-grid planes on the device, and the last
        # anchor's records (the B-VOPs' co-located vectors and skips)
        self._recon: Optional[tuple] = None
        self._recon_prev: Optional[tuple] = None
        self._co: Optional[torch.Tensor] = None
        self._queue: list = []           # pending (disp, y, u, v)
        self._disp = 0
        self._anchor_disp = -1
        self._since_i = 0
        self._wrote_headers = False
        # display index -> the coded-grid planes, with keep_recon_log
        self.keep_recon_log = keep_recon_log
        self.recon_log: dict = {}
        self._dec = Mpeg4Decoder()
        self._dec._mbw = self.mbw
        self._host: Optional[torch.Tensor] = None

    # ---------------------------------------------------------- #
    # Frames

    def _pad(self, y, u, v):
        return D.pad_planes(y, u, v, self.mbw, self.mbh)

    def encode(self, y, u, v) -> Tuple[bytes, bool]:
        """-> (chunk bytes, is_keyframe), without B-VOPs; with them use
        ``push``/``flush``."""
        assert self.bframes == 0, "use push()/flush() with bframes"
        cur = self._pad(y, u, v)
        intra = (self._frame % self.gop == 0) or self._recon is None
        chunk = self._code_anchor(cur, self._frame, intra)
        self._frame += 1
        return chunk, intra

    def push(self, y, u, v) -> List[Tuple[bytes, bool]]:
        """One display-order frame; zero or more coded chunks in coded
        order (an anchor before the B-VOPs shown before it)."""
        if self.bframes == 0:
            return [self.encode(y, u, v)]
        self._queue.append((self._disp, y, u, v))
        self._disp += 1
        if self._recon is None or len(self._queue) == self.bframes + 1:
            return self._emit_group()
        return []

    def flush(self) -> List[Tuple[bytes, bool]]:
        """The pending frames (the last one anchors)."""
        if not self._queue:
            return []
        return self._emit_group()

    def _emit_group(self) -> List[Tuple[bytes, bool]]:
        group, self._queue = self._queue, []
        bs, anchor = group[:-1], group[-1]
        disp_a = anchor[0]
        intra = (self._recon is None
                 or self._since_i + len(group) >= self.gop)
        prev_anchor_disp = self._anchor_disp
        out = [(self._code_anchor(self._pad(*anchor[1:]), disp_a, intra),
                intra)]
        self._anchor_disp = disp_a
        trd = max(1, disp_a - prev_anchor_disp)
        for disp_b, by, bu, bv in bs:
            trb = disp_b - prev_anchor_disp
            if self._rc is not None:
                self.qscale = self._rc.pick_qscale(3)
            w = BitWriter()
            self._vop_header(w, 2, disp_b)
            self._code_bvop(w, self._pad(by, bu, bv), disp_b, trb, trd)
            w.stuff()
            if self._rc is not None:
                self._rc.update(3, 8 * len(w.buf))
            out.append((w.getvalue(), False))
        self._since_i = 0 if intra else self._since_i + len(group)
        return out

    def _code_anchor(self, cur, disp: int, intra: bool) -> bytes:
        w = BitWriter()
        if not self._wrote_headers:
            w.buf.extend(self._headers())
            self._wrote_headers = True
        self._recon_prev = self._recon
        if self._rc is not None:
            self.qscale = self._rc.pick_qscale(1 if intra else 2)
        self._vop_header(w, 0 if intra else 1, disp)
        self._code_anchor_vop(w, cur, intra)
        w.stuff()
        if self._rc is not None:
            self._rc.update(1 if intra else 2, 8 * len(w.buf))
        if self.keep_recon_log:
            self.recon_log[disp] = self._recon
        return w.getvalue()

    # ---------------------------------------------------------- #
    # The device stage and its records

    def _records(self, rec: torch.Tensor) -> np.ndarray:
        """The VOP's records on the host: one copy (through a pinned
        buffer from a card), after the kernels that wrote them."""
        if rec.device.type != "cuda":
            return rec.numpy()
        if self._host is None or self._host.shape != rec.shape:
            self._host = torch.empty(rec.shape, dtype=rec.dtype,
                                     pin_memory=True)
        self._host.copy_(rec, non_blocking=True)
        torch.cuda.current_stream(rec.device).synchronize()
        return self._host.numpy()

    def _code_anchor_vop(self, w: BitWriter, cur, intra: bool) -> None:
        from tcforge_tpu_torch.ops import kernels
        q = self.qscale
        if intra:
            rec, recon = kernels.mpeg4_enc_blocks(None, cur, None, None, q,
                                                  D.VOP_I, True)
        else:
            rec = kernels.mpeg4_enc_me(cur, self._recon, q, self.four_mv,
                                       self.search)
            rec, recon = kernels.mpeg4_enc_blocks(rec, cur, self._recon,
                                                  None, q, D.VOP_P, True)
        host = self._records(rec)
        if intra:
            self._write_ivop(w, host)
        else:
            self._write_pvop(w, host)
        self._recon = recon
        self._co = rec

    def _code_bvop(self, w: BitWriter, cur, disp: int, trb: int,
                   trd: int) -> None:
        from tcforge_tpu_torch.ops import kernels
        rec = kernels.mpeg4_enc_bme(cur, self._recon_prev, self._recon,
                                    self._co, trb, trd, self.search)
        rec, recon = kernels.mpeg4_enc_blocks(
            rec, cur, self._recon_prev, self._recon, self.qscale, D.VOP_B,
            self.keep_recon_log)
        self._write_bvop(w, self._records(rec))
        if self.keep_recon_log:
            self.recon_log[disp] = recon

    # ---------------------------------------------------------- #
    # The host writer

    def _intra_entries(self, levels: np.ndarray, mbx: int, mby: int,
                       dcs) -> list:
        """``_code_intra_mb``'s DC prediction over the ``dcs`` grids:
        each block's (dc difference, levels)."""
        q = self.qscale
        entries = []
        for n in range(6):
            if n < 4:
                gx = 1 + 2 * mbx + (n & 1)
                gy = 1 + 2 * mby + (n >> 1)
                plane = 0
            else:
                gx, gy = 1 + mbx, 1 + mby
                plane = n - 3
            lv = levels[n]
            dc_q = int(lv[0, 0])
            scale = (T.Y_DC_SCALE if plane == 0 else T.C_DC_SCALE)[q]
            g = dcs[plane]
            a = g[gy][gx - 1]
            c = g[gy - 1][gx]
            dgt = g[gy - 1][gx - 1]
            pred = c if abs(a - dgt) < abs(dgt - c) else a
            pred_q = (pred + (scale >> 1)) // scale
            g[gy][gx] = dc_q * scale
            entries.append((dc_q - pred_q, lv))
        return entries

    def _dc_grids(self):
        return [[[1024] * (2 * self.mbw + 2) for _ in range(2 * self.mbh + 1)]
                for _ in range(3)]

    @staticmethod
    def _levels(host: np.ndarray) -> np.ndarray:
        return host[:, D.LV:D.LV + 384].reshape(-1, 6, 8, 8)

    def _write_ivop(self, w: BitWriter, host: np.ndarray) -> None:
        levels = self._levels(host)
        cbps = host[:, D.CBP].tolist()
        dcs = self._dc_grids()
        mbw = self.mbw
        for i, cbp in enumerate(cbps):
            entries = self._intra_entries(levels[i], i % mbw, i // mbw, dcs)
            self._write_intra_mb(w, cbp, entries, False)

    def _write_pvop(self, w: BitWriter, host: np.ndarray) -> None:
        levels = self._levels(host)
        info = host[:, D.MODE:D.FMV4 + 8].tolist()
        dcs = self._dc_grids()
        mbw, mbh = self.mbw, self.mbh
        grid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        pred_mv, wrap = self._dec._pred_mv, self._wrap_mv
        o = D.FMV4 - D.MODE
        for i, r in enumerate(info):
            mbx, mby = i % mbw, i // mbw
            bx, by = 2 * mbx, 2 * mby
            mode, cbp, skip = r[0], r[D.CBP - D.MODE], r[D.SKIP - D.MODE]
            if mode == D.MODE_INTRA:
                entries = self._intra_entries(levels[i], mbx, mby, dcs)
                self._write_intra_mb(w, cbp, entries, True)
                continue
            if skip:
                w.put(1, 1)              # not_coded: copy co-located
                continue
            mx, my = r[D.MX - D.MODE], r[D.MY - D.MODE]
            use4 = mode == D.MODE_INTER4
            w.put(0, 1)                  # not_coded = 0
            code, bits = _MCBPC_P[(2 if use4 else 0, cbp & 3)]
            w.put(code, bits)
            code, bits = _CBPY_CODES[((cbp >> 2) & 0xF) ^ 0xF]
            w.put(code, bits)
            if use4:
                # per block against the progressive median predictor
                for k in range(4):
                    m = (r[o + 2 * k], r[o + 2 * k + 1])
                    pk = pred_mv(grid, bx + (k & 1), by + (k >> 1), k)
                    _write_mv(w, wrap(m[0] - pk[0]))
                    _write_mv(w, wrap(m[1] - pk[1]))
                    grid[by + (k >> 1)][bx + (k & 1)] = m
            else:
                pred = pred_mv(grid, bx, by, 0)
                _write_mv(w, wrap(mx - pred[0]))
                _write_mv(w, wrap(my - pred[1]))
                for k in range(4):
                    grid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
            lv = levels[i]
            for n in range(6):
                if (cbp >> (5 - n)) & 1:
                    _write_block(w, lv[n], False, 0)

    def _write_bvop(self, w: BitWriter, host: np.ndarray) -> None:
        levels = self._levels(host)
        info = host[:, D.MODE:D.BMY + 1].tolist()
        mbw = self.mbw
        wrap = self._wrap_mv
        pf = pb = (0, 0)
        for i, (mode, cbp, skip, fmx, fmy, bmx, bmy) in enumerate(info):
            if i % mbw == 0:
                pf = pb = (0, 0)         # per-row predictors
            if mode == D.MODE_COSKIP:
                continue                 # the decoder makes it, no bits
            if skip:
                w.put(1, 1)              # modb=1: uncoded direct
                continue
            mb_type = mode - D.MODE_DIRECT
            w.put(0, 1)                  # modb
            w.put(1 if cbp == 0 else 0, 1)     # modb2
            code, bits = self._MBTYPE_B[mb_type]
            w.put(code, bits)
            if cbp:
                w.put(cbp, 6)
            if mb_type != 0 and cbp:
                w.put(0, 1)              # DBQUANT: +0
            if mb_type == 0:
                _write_mv(w, 0)          # delta MV (0,0)
                _write_mv(w, 0)
            if mb_type in (1, 3):
                _write_mv(w, wrap(fmx - pf[0]))
                _write_mv(w, wrap(fmy - pf[1]))
                pf = (fmx, fmy)
            if mb_type in (1, 2):
                _write_mv(w, wrap(bmx - pb[0]))
                _write_mv(w, wrap(bmy - pb[1]))
                pb = (bmx, bmy)
            lv = levels[i]
            for n in range(6):
                if (cbp >> (5 - n)) & 1:
                    _write_block(w, lv[n], False, 0)
