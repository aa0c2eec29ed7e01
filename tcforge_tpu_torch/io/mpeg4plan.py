"""The port's MPEG-4 plan parse: the pinned ``io/mpeg4dec.py`` decoder
with a plan form that takes interlaced, quarter-sample and GMC VOLs and
short-header (H.263) pictures.

``Mpeg4PlanDecoder.parse_plans`` records, per VOP, what the card's
reconstruction needs (``io/mpeg4recon.py`` ``stage_plan``), on top of
the pinned plan (the dequantized blocks, the half-pel or quarter-sample
luma vectors of each 8x8 block as decoded, the chroma vectors, use_f
and use_b), per macroblock:

- ``dct_type``: 1 where the luma blocks are field lines (``_luma_store``);
- ``form``, the prediction's shape: ``FORM_HALF`` (half-pel frame MC, as
  every VOP the pinned plan takes), ``FORM_QPEL16`` (a quarter-sample
  1MV macroblock, filtered as one 16x16 block), ``FORM_QPEL8`` (a
  quarter-sample 4MV or direct-mode macroblock, four 8x8 filter blocks:
  the 8-tap filter mirrors at the filter block's own edges, so that a
  1MV macroblock and a 4MV one with four equal vectors differ),
  ``FORM_FIELD`` (field prediction: two 16x8 luma and two 8x4 chroma
  blocks per direction from the selected reference fields) or
  ``FORM_GMC`` (an S-VOP's macroblock that takes the warped reference at
  its own place: the not_coded "GMC skip" and a coded mcsel macroblock,
  whose residual is added);
- for a field macroblock, per direction and field, its half-pel field
  vector (``fmv``), its reference field (``fsel``) and the chroma vector
  ``_field_pred_mb`` derives from it, ``(m >> 1) | (m & 1)`` (``fcmv``);
- a quarter-sample macroblock's chroma vector as the pixel path derives
  it: ``_qpel_chroma_1mv`` for 1MV, the ``_trunc2`` sums for 4MV and
  direct mode (the pinned direct-mode store records the half-pel rule).

and per VOP:

- ``warp``: an S-VOP's warp record (``warp_record``: ``_gmc_setup``'s
  values and the VOP's rounding; None for any other VOP), from which
  the card rebuilds ``_gmc_warp_planes``.  An S-VOP is a P plan with its
  rounding; each macroblock's average vector (``_gmc_amv``) stays on the
  host, where it feeds the vector predictor and the co-located vectors
  as in the numpy decoder;
- ``short``: 1 for a short-header picture (``decode_short``), which
  displays at once (no B pictures, no reorder lag).  An I picture is an
  intra plan of the H.263-dequantized blocks; a P picture's macroblocks
  are 1MV records (a COD skip a zero vector without residual, an intra
  macroblock an intra record), rounding 0, the chroma vector
  ``(m >> 1) | (m & 1)``.  Its references are the numpy decoder's
  padded by 32, which the per-coordinate clamp equals for H.263's
  vectors of at most 16 samples.

Every vector is worked out here, on the host.  The methods whose plan
stores lacked these are copies of their source lines, each under a
header comment naming them, with lines added for the records and the
plan form's refusals lifted (pinned by ``tests/test_torch_mpeg4_asp.py``);
``_intra_mb`` and ``_b_residual`` take ``dct_type`` as an argument and are
wrapped, and ``_gmc_warp_planes`` records the warp instead of warping in
plan mode.  What the numpy decoder refuses, this parse refuses the same
way, in its words: a field-predicted P macroblock in a quarter-sample
VOL ("mpeg4: quarter-sample field prediction"), static sprites, sprite
brightness change, more than three warping points (a ``ValueError``)
and an extended PTYPE.  A VOL the pinned plan form takes gives the same
plans as before, the new fields 0.
"""

from __future__ import annotations

import numpy as np

from tcforge_tpu_torch.io.mpeg4dec import (_ALT_V, _CBPY_LUT, _MBTYPE_B_LUT,
                                           _MCBPC_I_LUT, _MCBPC_P_LUT, _VOL,
                                           _ZIG, Bits, Mpeg4Decoder, _dquant,
                                           _iter_startcodes, _log2up,
                                           _read_lut, idct_add_sel, idct_put)

__all__ = ["Mpeg4PlanDecoder", "FORM_HALF", "FORM_QPEL16", "FORM_QPEL8",
           "FORM_FIELD", "FORM_GMC", "WARP", "warp_record"]

FORM_HALF, FORM_QPEL16, FORM_QPEL8, FORM_FIELD, FORM_GMC = 0, 1, 2, 3, 4

# an S-VOP's warp record, int64: the sprite's S (2 << accuracy), its
# warping points, the VOP's rounding, one point's translation (x, y) or
# the affine form's matrix (dxx, dxy, dyx, dyy), shift and the luma and
# chroma offsets (``_gmc_setup``)
WARP = 14
(W_S, W_N, W_RND, W_TX, W_TY, W_DXX, W_DXY, W_DYX, W_DYY, W_SH, W_OX, W_OY,
 W_OCX, W_OCY) = range(WARP)


def warp_record(P: dict, rounding: int) -> np.ndarray:
    """``_gmc_setup``'s dict and the VOP's rounding as a ``WARP`` record
    (the affine fields 0 for one point, the translation 0 for the
    others)."""
    rec = np.zeros(WARP, np.int64)
    rec[W_S], rec[W_N], rec[W_RND] = P["S"], P["n"], rounding
    if P["n"] == 1:
        rec[W_TX], rec[W_TY] = P["trans"]
    else:
        (rec[W_DXX], rec[W_DXY]), (rec[W_DYX], rec[W_DYY]) = P["D"]
        rec[W_SH:W_OCY + 1] = (P["sh"], P["ox"], P["oy"], P["ocx"],
                               P["ocy"])
    return rec


class Mpeg4PlanDecoder(Mpeg4Decoder):
    """``Mpeg4Decoder`` whose plans carry the interlaced, quarter-sample,
    GMC and short-header records (see the module's docstring)."""

    def _plan_new(self, kind: str, rounding: int = 0) -> dict:
        plan = super()._plan_new(kind, rounding)
        nmb = self._mbw * self._mbh
        vol = self.vol
        plan.update(
            qpel=int(bool(vol is not None and vol.quarter_sample)),
            interlaced=int(bool(vol is not None and vol.interlaced)),
            dct_type=np.zeros(nmb, np.uint8),
            form=np.zeros(nmb, np.uint8),
            fsel=np.zeros((nmb, 2, 2), np.uint8),       # [dir][field]
            fmv=np.zeros((nmb, 2, 2, 2), np.int16),     # [dir][field](x, y)
            fcmv=np.zeros((nmb, 2, 2, 2), np.int16),
            warp=None,
            short=int(bool(getattr(vol, "short_header", False))))
        return plan

    def _rec_gmc(self, idx: int) -> None:
        """Macroblock ``idx`` of an S-VOP predicts from the warped
        reference at its own place."""
        self._plan['use_f'][idx] = 1
        self._plan['form'][idx] = FORM_GMC

    def _rec_1mv(self, idx: int, blocks, mx: int, my: int) -> None:
        """A short-header P picture's inter macroblock ``idx``: its
        blocks, its half-pel vector and the chroma vector
        ``(m >> 1) | (m & 1)`` (``decode_short``)."""
        pl = self._plan
        pl['blocks'][idx] = blocks
        pl['use_f'][idx] = 1
        pl['mvs4'][idx] = [(mx, my)] * 4
        pl['cmv'][idx] = ((mx >> 1) | (mx & 1), (my >> 1) | (my & 1))

    def _gmc_warp_planes(self, planes, P, rnd):
        """In plan mode the S-VOP's warp record (``warp_record``), kept
        in its plan for the card, in place of the warped planes, which
        plan mode has no pixels for; else the numpy warp."""
        if self._plan is None:
            return super()._gmc_warp_planes(planes, P, rnd)
        self._plan['warp'] = warp_record(P, rnd)
        return self._plan['warp']

    def _rec_field(self, idx: int, d: int, fmvs, fsels) -> None:
        """Direction ``d`` (0 forward, 1 backward) of field macroblock
        ``idx``: each field's vector, reference field and chroma vector
        (``_field_pred_mb``'s ``(m >> 1) | (m & 1)``)."""
        pl = self._plan
        pl['form'][idx] = FORM_FIELD
        for i in range(2):
            mx, my = fmvs[i]
            pl['fmv'][idx, d, i] = (mx, my)
            pl['fcmv'][idx, d, i] = ((mx >> 1) | (mx & 1),
                                     (my >> 1) | (my & 1))
            pl['fsel'][idx, d, i] = fsels[i]

    def _intra_mb(self, b, y, u, v, mbx, mby, qscale, cbp, ac_pred,
                  dc_thr, dcs, acs_row, acs_col, qgrid,
                  intra_vop, dct_type=0) -> None:
        super()._intra_mb(b, y, u, v, mbx, mby, qscale, cbp, ac_pred,
                          dc_thr, dcs, acs_row, acs_col, qgrid, intra_vop,
                          dct_type)
        if self._plan is not None:
            self._plan['dct_type'][mby * self._mbw + mbx] = dct_type

    def _b_residual(self, b, cbp, qscale, pred_y, pred_u, pred_v,
                    x0, y0, y, u, v, dct_type=0):
        super()._b_residual(b, cbp, qscale, pred_y, pred_u, pred_v, x0, y0,
                            y, u, v, dct_type)
        if self._plan is not None:
            self._plan['dct_type'][(y0 // 16) * self._mbw + (x0 // 16)] = \
                dct_type

    # Copy of tcforge_tpu/io/mpeg4dec.py:445-470; interlaced,
    # quarter-sample and GMC VOLs and short-header pictures are planned.
    def parse_plans(self, data: bytes) -> list:
        """Parse one container chunk in plan mode, returning the
        decode-order recon plans it yields (no pixel work; see
        io/mpeg4jax.py for the batched device reconstruction).
        Raises NotImplementedError for VOL features the device path
        does not cover, as the numpy decoder refuses them (static
        sprites, sprite brightness change, extended PTYPE)."""
        self.plan_mode = True
        start = len(self.plans)
        if len(data) >= 3 and data[0] == 0 and data[1] == 0 \
                and (data[2] & 0xFC) == 0x80:
            self.decode_short(data)          # a short-header picture
            out, self.plans = self.plans[start:], self.plans[:start]
            return out
        for code, payload in _iter_startcodes(data):
            if 0x20 <= code <= 0x2F:
                self._parse_vol(Bits(payload))
            elif code == 0xB6:
                self._decode_vop(Bits(payload))
        out, self.plans = self.plans[start:], self.plans[:start]
        return out

    # Copy of tcforge_tpu/io/mpeg4dec.py:606-720; an S-VOP is planned
    # as a P-VOP with its rounding.
    def _decode_vop(self, b: Bits):
        if self.vol is None:
            raise ValueError("mpeg4: VOP before VOL")
        vol = self.vol
        vop_type = b.read(2)
        time_incr = 0
        while b.read1():                 # modulo time base
            time_incr += 1
        b.read1()
        time_inc = b.read(vol.time_inc_bits)
        b.read1()
        # temporal bookkeeping (direct-mode TRB/TRD ratios)
        res = max(1, vol.time_inc_res)
        if vop_type != 2:
            self._last_time_base = self._time_base
            self._time_base += time_incr
            self._time = self._time_base * res + time_inc
            if self._time < self._last_non_b_time:
                self._time += res
                self._time_base += 1
            self._pp_time = self._time - self._last_non_b_time
            self._last_non_b_time = self._time
        else:
            self._time = (self._last_time_base + time_incr) * res \
                + time_inc
            self._pb_time = self._pp_time \
                - (self._last_non_b_time - self._time)
        if not b.read1():                # vop_coded == 0
            if vop_type != 2:
                if self.plan_mode:
                    # repeat-anchor == an all-skip P plan (inter,
                    # zero MVs, no residual -> the device MC copies
                    # the reference verbatim)
                    plan = self._plan_new('P')
                    plan['use_f'][:] = 1
                    self.plans.append(plan)
                    self._plan = None
                return self._shift_refs(None)
            return None
        rounding = 0
        if vop_type == 1 or (vop_type == 3 and
                             getattr(vol, "sprite_enable", 0) == 2):
            rounding = b.read1()
        if vop_type == 3 and getattr(vol, "sprite_enable", 0) != 2:
            raise NotImplementedError("mpeg4: static sprite VOPs")
        intra_dc_thr = b.read(3)
        if vol.interlaced:
            self._top_field_first = b.read1()
            self._alt_scan = b.read1()
        else:
            self._alt_scan = 0
        svop_traj = None
        if vop_type == 3:
            svop_traj = [(self._read_traj_dmv(b),
                          self._read_traj_dmv(b))
                         for _ in range(vol.sprite_points)]
        qscale = b.read(vol.quant_precision)
        if qscale == 0:
            raise ValueError("mpeg4: qscale 0")
        fcode = fcode_b = 1
        if vop_type in (1, 2, 3):
            fcode = b.read(3)
            if fcode == 0:
                raise ValueError("mpeg4: fcode 0")
        if vop_type == 2:
            fcode_b = b.read(3)
            if fcode_b == 0:
                raise ValueError("mpeg4: fcode_b 0")
        if self.plan_mode:
            self._plan_new(('I', 'P', 'B', 'P')[vop_type],
                           rounding if vop_type in (1, 3) else 0)
        if vol.data_partitioned and vop_type in (0, 1):
            if vop_type == 1 and self.last is None:
                raise ValueError("mpeg4: P-VOP before I-VOP")
            prev_ref = self.last
            self._decode_dp_vop(b, vop_type, qscale, intra_dc_thr,
                                fcode, rounding)
            self._older = prev_ref
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
            return self._shift_refs(self.last)
        if vop_type == 0:
            prev_ref = self.last
            self._decode_ivop(b, qscale, intra_dc_thr)
            self._older = prev_ref
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
            return self._shift_refs(self.last)
        elif vop_type in (1, 3):
            if self.last is None:
                raise ValueError("mpeg4: P-VOP before I-VOP")
            prev_ref = self.last
            self._decode_pvop(b, qscale, intra_dc_thr, fcode,
                              rounding, svop_traj=svop_traj)
            self._older = prev_ref
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
            return self._shift_refs(self.last)
        else:
            if self._older is None or self.last is None:
                raise ValueError("mpeg4: B-VOP without two references")
            out = self._decode_bvop(b, qscale, fcode, fcode_b)
            if self._plan is not None:
                self.plans.append(self._plan)
                self._plan = None
                return None
            return out

    # Copy of tcforge_tpu/io/mpeg4dec.py:2113-2367; the plan store
    # records dct_type, the prediction form, a field macroblock's vectors
    # and an S-VOP's GMC macroblocks.
    def _decode_pvop(self, b, qscale, dc_thr, fcode, rounding,
                     svop_traj=None):
        vol = self.vol
        mbw, mbh = self._mbw, self._mbh
        W, H = mbw * 16, mbh * 16
        prev = self.last
        pad = 16 + (32 << (fcode - 1)) // 2
        refs = None if self._plan is not None else \
            [np.pad(pl, pad, mode="edge") for pl in prev]
        gmc_P = gw = None
        if svop_traj is not None:
            gmc_P = self._gmc_setup(svop_traj)
            gw = self._gmc_warp_planes(prev, gmc_P, rounding)
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        dcs = [np.full((2 * mbh + 1, 2 * mbw + 2), 1024, np.int64)
               for _ in range(3)]
        acs_row = [np.zeros((2 * mbh + 1, 2 * mbw + 2, 8), np.int64)
                   for _ in range(3)]
        acs_col = [np.zeros((2 * mbh + 1, 2 * mbw + 2, 8), np.int64)
                   for _ in range(3)]
        qgrid = [np.zeros((2 * mbh + 1, 2 * mbw + 2), np.int64)
                 for _ in range(3)]
        # per-block MV grid for prediction (None = not yet decoded)
        mvgrid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        skipmap = [[False] * mbw for _ in range(mbh)]
        fieldmap = [[False] * mbw for _ in range(mbh)]
        fmvtab = [[None] * mbw for _ in range(mbh)]
        fseltab = [[None] * mbw for _ in range(mbh)]
        refs_f = None                    # lazy padded field planes
        pkt_start = 0                    # first MB of current packet

        for mby in range(mbh):
            for mbx in range(mbw):
                x0, y0 = 16 * mbx, 16 * mby
                bx, by = 2 * mbx, 2 * mby
                nq = self._resync(b, fcode + 15, mby * mbw + mbx)
                if nq is not None:
                    qscale = nq
                    pkt_start = mby * mbw + mbx
                    dcs, acs_row, acs_col, qgrid = \
                        self._fresh_pred_grids()
                if b.read1():                   # not_coded: skip MB
                    if gw is not None:
                        # S-VOP skip = GMC prediction, no residual
                        if self._plan is not None:
                            self._rec_gmc(mby * mbw + mbx)
                            amv = self._gmc_amv(gmc_P, mbx, mby, fcode)
                            for k in range(4):
                                mvgrid[by + (k >> 1)][bx + (k & 1)] = amv
                            continue
                        for p, (pl, sh) in enumerate(((y, 0),
                                                      (u, 1),
                                                      (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                gw[p][py:py + s, px:px + s]
                        amv = self._gmc_amv(gmc_P, mbx, mby, fcode)
                        for k in range(4):
                            mvgrid[by + (k >> 1)][bx + (k & 1)] = \
                                amv
                        continue
                    if self._plan is not None:
                        # inter copy: zero MVs, no residual
                        self._plan['use_f'][mby * mbw + mbx] = 1
                    else:
                        for p, (pl, sh) in enumerate(((y, 0),
                                                      (u, 1),
                                                      (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                prev[p][py:py + s, px:px + s]
                    skipmap[mby][mbx] = True
                    continue
                mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                while mb_type == -2:            # stuffing
                    mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                intra = mb_type in (3, 4)
                mcsel = False
                if gw is not None and not intra \
                        and mb_type in (0, 1):
                    mcsel = b.read1() == 1
                ac_pred = 0
                if intra:
                    ac_pred = b.read1()
                cbpy = _read_lut(b, _CBPY_LUT, 6)
                if not intra:
                    cbpy ^= 0xF
                if mb_type in (1, 4, 5):
                    qscale = _dquant(b, qscale)
                if mb_type == 5:
                    mb_type = 2                # 4MV with dquant
                cbp = (cbpy << 2) | cbpc
                # interlaced_information() (6.2.7.3): dct_type for
                # intra-or-coded MBs, then the field prediction
                # flag + field selects for 16x16 inter MBs
                dct_type = 0
                field_mc = False
                fsels = None
                if vol.interlaced:
                    if intra or cbp:
                        dct_type = b.read1()
                    if not intra and mb_type != 2 and not mcsel \
                            and b.read1():
                        field_mc = True
                        fsels = (b.read1(), b.read1())
                if intra:
                    self._intra_mb(b, y, u, v, mbx, mby, qscale, cbp,
                                   ac_pred, dc_thr, dcs, acs_row,
                                   acs_col, qgrid, intra_vop=False,
                                   dct_type=dct_type)
                    continue
                # motion vectors
                if mcsel:
                    amv = self._gmc_amv(gmc_P, mbx, mby, fcode)
                    mvs = [amv] * 4
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = amv
                elif field_mc:
                    if vol.quarter_sample:
                        raise NotImplementedError(
                            "mpeg4: quarter-sample field prediction")
                    px_, py_ = self._pred_mv(mvgrid, bx, by, 0,
                                             pkt_start)
                    hpy = self._cdiv2(py_)
                    fmvs = []
                    for i in range(2):
                        fmx = self._decode_mv_component(b, fcode,
                                                        px_)
                        fmy = self._decode_mv_component(b, fcode,
                                                        hpy)
                        fmvs.append((fmx, fmy))
                    # neighbour-prediction value: |1-rounded average
                    # of the field mx, SUM of the field-unit my
                    # (== frame-unit average; ff_h263_update_motion_val)
                    sx_ = fmvs[0][0] + fmvs[1][0]
                    avg = ((sx_ >> 1) | (sx_ & 1),
                           fmvs[0][1] + fmvs[1][1])
                    mvs = [avg] * 4
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = avg
                    fieldmap[mby][mbx] = True
                    fmvtab[mby][mbx] = list(fmvs)
                    fseltab[mby][mbx] = fsels
                elif mb_type == 2:              # 4MV
                    mvs = []
                    for k in range(4):
                        px_, py_ = self._pred_mv(
                            mvgrid, bx + (k & 1), by + (k >> 1), k,
                            pkt_start)
                        mx = self._decode_mv_component(b, fcode, px_)
                        my = self._decode_mv_component(b, fcode, py_)
                        mvs.append((mx, my))
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
                else:                           # 1MV
                    px_, py_ = self._pred_mv(mvgrid, bx, by, 0,
                                             pkt_start)
                    mx = self._decode_mv_component(b, fcode, px_)
                    my = self._decode_mv_component(b, fcode, py_)
                    mvs = [(mx, my)] * 4
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
                # luma MC
                qpel = vol.quarter_sample
                mc_l = self._mc_block_qpel if qpel else self._mc_block
                pred_y = np.empty((16, 16), np.int32)
                if self._plan is not None:
                    pass                        # device MC
                elif mcsel:
                    pred_y[:] = gw[0][y0:y0 + 16, x0:x0 + 16]
                elif field_mc:
                    if refs_f is None:
                        refs_f = self._field_pad(prev, pad)
                    pred_y, pred_u, pred_v = self._field_pred_mb(
                        refs_f, pad, x0, y0, fmvs, fsels, rounding)
                elif mb_type == 2:
                    for k in range(4):
                        mx, my = mvs[k]
                        sx, sy = x0 + 8 * (k & 1), y0 + 8 * (k >> 1)
                        pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                               8 * (k & 1):8 * (k & 1) + 8] = \
                            mc_l(refs[0], pad, sx, sy, 8,
                                 mx, my, rounding)
                else:
                    pred_y[:] = mc_l(refs[0], pad, x0, y0,
                                     16, mvs[0][0],
                                     mvs[0][1], rounding)
                # chroma MV derivation (field MC derives its own)
                if field_mc:
                    cmx = cmy = 0
                elif mb_type == 2:
                    if qpel:
                        # per-block C-truncated /2 BEFORE summing
                        # (probed exact; trunc-of-sum diverges when
                        # the blocks' parities differ)
                        sx = sum(self._trunc2(m[0]) for m in mvs)
                        sy = sum(self._trunc2(m[1]) for m in mvs)
                    else:
                        sx = sum(m[0] for m in mvs)
                        sy = sum(m[1] for m in mvs)
                    cmx = self._round_chroma(sx)
                    cmy = self._round_chroma(sy)
                elif qpel:
                    cmx = self._qpel_chroma_1mv(mvs[0][0])
                    cmy = self._qpel_chroma_1mv(mvs[0][1])
                else:
                    cmx = (mvs[0][0] >> 1) | (mvs[0][0] & 1)
                    cmy = (mvs[0][1] >> 1) | (mvs[0][1] & 1)
                if mcsel and self._plan is None:
                    pred_u = gw[1][(y0 >> 1):(y0 >> 1) + 8,
                                   (x0 >> 1):(x0 >> 1) + 8] \
                        .astype(np.int32)
                    pred_v = gw[2][(y0 >> 1):(y0 >> 1) + 8,
                                   (x0 >> 1):(x0 >> 1) + 8] \
                        .astype(np.int32)
                elif not field_mc and self._plan is None:
                    pred_u = self._mc_block(refs[1], pad, x0 >> 1,
                                            y0 >> 1, 8, cmx, cmy,
                                            rounding)
                    pred_v = self._mc_block(refs[2], pad, x0 >> 1,
                                            y0 >> 1, 8, cmx, cmy,
                                            rounding)
                # residual blocks
                iscan = _ALT_V if self._alt_scan else _ZIG
                blocks = np.zeros((6, 8, 8), np.int64)
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        lv = self._read_block(b, False, iscan, 0)
                        blocks[n] = self._dequant(lv, qscale, False,
                                                  0)
                if self._plan is not None:
                    idx = mby * mbw + mbx
                    pl = self._plan
                    pl['blocks'][idx] = blocks
                    pl['use_f'][idx] = 1
                    pl['mvs4'][idx] = mvs
                    pl['cmv'][idx] = (cmx, cmy)
                    pl['dct_type'][idx] = dct_type
                    if field_mc:
                        self._rec_field(idx, 0, fmvs, fsels)
                    elif mcsel:
                        self._rec_gmc(idx)
                    elif qpel:
                        pl['form'][idx] = FORM_QPEL8 if mb_type == 2 \
                            else FORM_QPEL16
                    continue
                pred6 = np.empty((6, 8, 8), np.int32)
                for k, blk in enumerate(self._luma_split(pred_y,
                                                         dct_type)):
                    pred6[k] = blk
                pred6[4] = pred_u
                pred6[5] = pred_v
                out = idct_add_sel(blocks, pred6,
                                   [(cbp >> (5 - n)) & 1
                                    for n in range(6)])
                self._luma_store(y, x0, y0, out[:4], dct_type)
                u[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[4]
                v[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[5]
        self.last = [y, u, v]
        self._co_mvs = mvgrid
        self._co_skip = skipmap
        self._co_field = fieldmap
        self._co_fmvs = fmvtab
        self._co_fsels = fseltab

    # Copy of tcforge_tpu/io/mpeg4dec.py:2373-2564; the plan store
    # records the prediction form and a field macroblock's vectors.
    def _decode_bvop(self, b, qscale, fcode_f, fcode_b):
        vol = self.vol
        mbw, mbh = self._mbw, self._mbh
        W, H = mbw * 16, mbh * 16
        fwd_ref, bwd_ref = self._older, self.last
        pad = 16 + (32 << (max(fcode_f, fcode_b) - 1)) // 2
        if self._plan is not None:
            frefs = brefs = None
        else:
            frefs = [np.pad(pl, pad, mode="edge") for pl in fwd_ref]
            brefs = [np.pad(pl, pad, mode="edge") for pl in bwd_ref]
        y = np.zeros((H, W), np.uint8)
        u = np.zeros((H // 2, W // 2), np.uint8)
        v = np.zeros((H // 2, W // 2), np.uint8)
        trb, trd = self._pb_time, self._pp_time
        if trd <= 0:
            trd = 1
        co_mvs = self._co_mvs or \
            [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        co_skip = self._co_skip or [[False] * mbw
                                    for _ in range(mbh)]
        self._bf_refs = [None, None]     # lazy padded field planes
        self._bf_srcs = (fwd_ref, bwd_ref, pad)

        qpel = vol.quarter_sample
        mc_l = self._mc_block_qpel if qpel else self._mc_block
        if qpel:
            chroma_mv = self._qpel_chroma_1mv
        else:
            def chroma_mv(m):
                return (m >> 1) | (m & 1)

        def avg_bidir(a, bb):
            return (a + bb + 1) >> 1

        for mby in range(mbh):
            # B-VOP MV predictors reset per MB row: last_mv[dir][fld]
            lm = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
            for mbx in range(mbw):
                x0, y0 = 16 * mbx, 16 * mby
                nq = self._resync(b, max(fcode_f, fcode_b, 2) + 15,
                                  mby * mbw + mbx)
                if nq is not None:
                    qscale = nq
                    lm = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
                if co_skip[mby][mbx]:
                    # co-located P MB skipped: this MB has NO bits
                    # (direct, zero motion, not coded)
                    self._b_direct(b, frefs, brefs, pad, x0, y0,
                                   (0, 0), co_mvs, mbx, mby, trb,
                                   trd, 0, qscale, y, u, v,
                                   read_blocks=False)
                    continue
                if b.read1():              # modb == '1': direct,
                    self._b_direct(b, frefs, brefs, pad, x0, y0,
                                   None, co_mvs, mbx, mby, trb, trd,
                                   0, qscale, y, u, v,
                                   read_blocks=False)
                    continue
                modb2 = b.read1()
                mb_type = _read_lut(b, _MBTYPE_B_LUT, 4)
                cbp = 0 if modb2 else b.read(6)
                if mb_type != 0 and cbp:
                    # DBQUANT: "0"=0, "10"=-2, "11"=+2
                    if b.read1():
                        qscale = max(1, min(31, qscale
                                            + (2 if b.read1()
                                               else -2)))
                # interlaced_information(): dct_type for coded MBs
                # (direct included), field flag + per-direction
                # selects for non-direct MBs
                dct_type = 0
                field_pr = False
                fsf = fsb = None
                if vol.interlaced:
                    if cbp:
                        dct_type = b.read1()
                    if mb_type != 0 and b.read1():
                        field_pr = True
                        if mb_type in (1, 3):
                            fsf = (b.read1(), b.read1())
                        if mb_type in (1, 2):
                            fsb = (b.read1(), b.read1())
                if mb_type == 0:           # direct (with delta MV)
                    dmx = self._decode_mv_component(b, 1, 0)
                    dmy = self._decode_mv_component(b, 1, 0)
                    self._b_direct(b, frefs, brefs, pad, x0, y0,
                                   (dmx, dmy), co_mvs, mbx, mby,
                                   trb, trd, cbp, qscale, y, u, v,
                                   read_blocks=True,
                                   dct_type=dct_type)
                    continue
                fmvs_f = fmvs_b = None
                if mb_type in (1, 3):      # interpolate / forward
                    if field_pr:
                        fmvs_f = []
                        for i in range(2):
                            mx = self._decode_mv_component(
                                b, fcode_f, lm[0][i][0])
                            my = self._decode_mv_component(
                                b, fcode_f, self._cdiv2(lm[0][i][1]))
                            lm[0][i] = [mx, 2 * my]
                            fmvs_f.append((mx, my))
                    else:
                        fx = self._decode_mv_component(b, fcode_f,
                                                       lm[0][0][0])
                        fy = self._decode_mv_component(b, fcode_f,
                                                       lm[0][0][1])
                        lm[0][0] = [fx, fy]
                        lm[0][1] = [fx, fy]
                if mb_type in (1, 2):      # interpolate / backward
                    if field_pr:
                        fmvs_b = []
                        for i in range(2):
                            mx = self._decode_mv_component(
                                b, fcode_b, lm[1][i][0])
                            my = self._decode_mv_component(
                                b, fcode_b, self._cdiv2(lm[1][i][1]))
                            lm[1][i] = [mx, 2 * my]
                            fmvs_b.append((mx, my))
                    else:
                        bx_ = self._decode_mv_component(b, fcode_b,
                                                        lm[1][0][0])
                        by_ = self._decode_mv_component(b, fcode_b,
                                                        lm[1][0][1])
                        lm[1][0] = [bx_, by_]
                        lm[1][1] = [bx_, by_]
                if self._mb_trace is not None:
                    self._mb_trace.append(
                        (mbx, mby, mb_type,
                         fmvs_f or tuple(lm[0][0]),
                         fmvs_b or tuple(lm[1][0]), cbp))
                if self._plan is not None:
                    idx = mby * mbw + mbx
                    pl = self._plan
                    if mb_type in (1, 3):
                        pf = lm[0][0]
                        pl['use_f'][idx] = 1
                        pl['mvs4'][idx] = [pf] * 4
                        pl['cmv'][idx] = (chroma_mv(pf[0]),
                                          chroma_mv(pf[1]))
                    if mb_type in (1, 2):
                        pb_ = lm[1][0]
                        pl['use_b'][idx] = 1
                        pl['bmvs4'][idx] = [pb_] * 4
                        pl['bcmv'][idx] = (chroma_mv(pb_[0]),
                                           chroma_mv(pb_[1]))
                    if field_pr:
                        if fmvs_f is not None:
                            self._rec_field(idx, 0, fmvs_f, fsf)
                        if fmvs_b is not None:
                            self._rec_field(idx, 1, fmvs_b, fsb)
                    elif qpel:
                        pl['form'][idx] = FORM_QPEL16
                    self._b_residual(b, cbp, qscale, None, None,
                                     None, x0, y0, y, u, v,
                                     dct_type=dct_type)
                    continue
                pred_y = None
                pred_u = pred_v = None
                if mb_type in (1, 3):
                    if field_pr:
                        fpy, fpu, fpv = self._field_pred_mb(
                            self._bf_pad(0), pad, x0, y0,
                            fmvs_f, fsf, 0)
                    else:
                        pf = lm[0][0]
                        fpy = mc_l(frefs[0], pad, x0, y0, 16,
                                   pf[0], pf[1], 0)
                        cmx, cmy = chroma_mv(pf[0]), chroma_mv(pf[1])
                        fpu = self._mc_block(frefs[1], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                        fpv = self._mc_block(frefs[2], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                    pred_y, pred_u, pred_v = fpy, fpu, fpv
                if mb_type in (1, 2):
                    if field_pr:
                        bpy, bpu, bpv = self._field_pred_mb(
                            self._bf_pad(1), pad, x0, y0,
                            fmvs_b, fsb, 0)
                    else:
                        pb_ = lm[1][0]
                        bpy = mc_l(brefs[0], pad, x0, y0, 16,
                                   pb_[0], pb_[1], 0)
                        cmx, cmy = chroma_mv(pb_[0]), chroma_mv(pb_[1])
                        bpu = self._mc_block(brefs[1], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                        bpv = self._mc_block(brefs[2], pad, x0 >> 1,
                                             y0 >> 1, 8, cmx, cmy, 0)
                    if pred_y is None:
                        pred_y, pred_u, pred_v = bpy, bpu, bpv
                    else:
                        pred_y = avg_bidir(pred_y, bpy)
                        pred_u = avg_bidir(pred_u, bpu)
                        pred_v = avg_bidir(pred_v, bpv)
                self._b_residual(b, cbp, qscale, pred_y, pred_u,
                                 pred_v, x0, y0, y, u, v,
                                 dct_type=dct_type)
        return self._crop_planes([y, u, v])

    # Copy of tcforge_tpu/io/mpeg4dec.py:2575-2665; the plan store
    # records the quarter-sample chroma rule and the 8x8 filter blocks.
    def _b_direct(self, b, frefs, brefs, pad, x0, y0, delta, co_mvs,
                  mbx, mby, trb, trd, cbp, qscale, y, u, v,
                  read_blocks, dct_type=0):
        """Direct-mode MB: per-block MVs scaled from the co-located
        backward-reference MBs by the TRB/TRD time ratio (C
        truncating division)."""
        if delta is None:
            delta = (0, 0)
        if self.vol.interlaced and self._co_field \
                and self._co_field[mby][mbx]:
            return self._b_direct_field(b, pad, x0, y0, delta, mbx,
                                        mby, trb, trd, cbp, qscale,
                                        y, u, v, read_blocks,
                                        dct_type)
        def tdiv(a, d):
            q = abs(a) // d
            return -q if a < 0 else q
        fmv = []
        bmv = []
        for k in range(4):
            cm = co_mvs[2 * mby + (k >> 1)][2 * mbx + (k & 1)]
            fx = tdiv(trb * cm[0], trd) + delta[0]
            fy = tdiv(trb * cm[1], trd) + delta[1]
            # backward vector gates on each delta COMPONENT, not
            # the pair (a (d,0) delta scales y but differences x)
            bx = (fx - cm[0]) if delta[0] \
                else tdiv((trb - trd) * cm[0], trd)
            by = (fy - cm[1]) if delta[1] \
                else tdiv((trb - trd) * cm[1], trd)
            fmv.append((fx, fy))
            bmv.append((bx, by))
        qpel = self.vol.quarter_sample
        mc_l = self._mc_block_qpel if qpel else self._mc_block
        if self._mb_trace is not None:
            self._mb_trace.append(
                (x0 // 16, y0 // 16, "direct", fmv, bmv,
                 cbp if read_blocks else 0))
        if self._plan is not None:
            idx = mby * self._mbw + mbx
            pl = self._plan
            pl['use_f'][idx] = 1
            pl['use_b'][idx] = 1
            pl['mvs4'][idx] = fmv
            pl['bmvs4'][idx] = bmv
            sfx = sum(m[0] for m in fmv)
            sfy = sum(m[1] for m in fmv)
            sbx = sum(m[0] for m in bmv)
            sby = sum(m[1] for m in bmv)
            if qpel:
                # the pixel path's chroma below: per-block C-truncated
                # /2 before summing
                sfx = sum(self._trunc2(m[0]) for m in fmv)
                sfy = sum(self._trunc2(m[1]) for m in fmv)
                sbx = sum(self._trunc2(m[0]) for m in bmv)
                sby = sum(self._trunc2(m[1]) for m in bmv)
                pl['form'][idx] = FORM_QPEL8
            pl['cmv'][idx] = (self._round_chroma(sfx),
                              self._round_chroma(sfy))
            pl['bcmv'][idx] = (self._round_chroma(sbx),
                               self._round_chroma(sby))
            self._b_residual(b, cbp if read_blocks else 0, qscale,
                             None, None, None, x0, y0, y, u, v,
                             dct_type)
            return
        pred_y = np.empty((16, 16), np.int32)
        for k in range(4):
            sx, sy = x0 + 8 * (k & 1), y0 + 8 * (k >> 1)
            fp = mc_l(frefs[0], pad, sx, sy, 8,
                      fmv[k][0], fmv[k][1], 0)
            bp = mc_l(brefs[0], pad, sx, sy, 8,
                      bmv[k][0], bmv[k][1], 0)
            pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                   8 * (k & 1):8 * (k & 1) + 8] = (fp + bp + 1) >> 1
        if qpel:
            # per-block C-truncated /2 before summing (probed exact)
            sfx = sum(self._trunc2(m[0]) for m in fmv)
            sfy = sum(self._trunc2(m[1]) for m in fmv)
            sbx = sum(self._trunc2(m[0]) for m in bmv)
            sby = sum(self._trunc2(m[1]) for m in bmv)
        else:
            sfx = sum(m[0] for m in fmv)
            sfy = sum(m[1] for m in fmv)
            sbx = sum(m[0] for m in bmv)
            sby = sum(m[1] for m in bmv)
        fcx, fcy = self._round_chroma(sfx), self._round_chroma(sfy)
        bcx, bcy = self._round_chroma(sbx), self._round_chroma(sby)
        fpu = self._mc_block(frefs[1], pad, x0 >> 1, y0 >> 1, 8,
                             fcx, fcy, 0)
        bpu = self._mc_block(brefs[1], pad, x0 >> 1, y0 >> 1, 8,
                             bcx, bcy, 0)
        fpv = self._mc_block(frefs[2], pad, x0 >> 1, y0 >> 1, 8,
                             fcx, fcy, 0)
        bpv = self._mc_block(brefs[2], pad, x0 >> 1, y0 >> 1, 8,
                             bcx, bcy, 0)
        pred_u = (fpu + bpu + 1) >> 1
        pred_v = (fpv + bpv + 1) >> 1
        self._b_residual(b, cbp if read_blocks else 0, qscale,
                         pred_y, pred_u, pred_v, x0, y0, y, u, v,
                         dct_type)

    # Copy of tcforge_tpu/io/mpeg4dec.py:2667-2718; with a plan store,
    # which the source lacks.
    def _b_direct_field(self, b, pad, x0, y0, delta, mbx, mby, trb,
                        trd, cbp, qscale, y, u, v, read_blocks,
                        dct_type):
        """Direct mode over a FIELD-predicted co-located MB: per
        destination field i, scale that field's co-located vector by
        the per-field temporal distances IN FIELD UNITS — the frame
        distances doubled, then corrected by one field period for
        the field pairing: tff ? 2t - sel + i : 2t + sel - i (the
        co-located field select vs the destination parity); forward
        field select = the co-located select, backward select = own
        parity (ff_mpeg4_set_direct_mv's interlaced branch,
        oracle-verified by TestFieldDirectProbe — the plain TRB/TRD
        ratio only matches the field whose correction is zero)."""
        def tdiv(a, d):
            q = abs(a) // d
            return -q if a < 0 else q
        co = self._co_fmvs[mby][mbx]
        cosel = self._co_fsels[mby][mbx]
        tff = self._top_field_first
        fmvs, bmvs, fsf, fsb = [], [], [], []
        for i in range(2):
            cmx, cmy = co[i]
            if tff:
                tpp = 2 * trd - cosel[i] + i
                tpb = 2 * trb - cosel[i] + i
            else:
                tpp = 2 * trd + cosel[i] - i
                tpb = 2 * trb + cosel[i] - i
            fx = tdiv(tpb * cmx, tpp) + delta[0]
            fy = tdiv(tpb * cmy, tpp) + delta[1]
            bx = (fx - cmx) if delta[0] \
                else tdiv((tpb - tpp) * cmx, tpp)
            by = (fy - cmy) if delta[1] \
                else tdiv((tpb - tpp) * cmy, tpp)
            fmvs.append((fx, fy))
            bmvs.append((bx, by))
            fsf.append(cosel[i])
            fsb.append(i)
        if self._mb_trace is not None:
            self._mb_trace.append(
                (mbx, mby, "direct-field", fmvs, bmvs,
                 cbp if read_blocks else 0))
        if self._plan is not None:
            idx = mby * self._mbw + mbx
            self._plan['use_f'][idx] = 1
            self._plan['use_b'][idx] = 1
            self._rec_field(idx, 0, fmvs, fsf)
            self._rec_field(idx, 1, bmvs, fsb)
            self._b_residual(b, cbp if read_blocks else 0, qscale,
                             None, None, None, x0, y0, y, u, v,
                             dct_type)
            return
        fp = self._field_pred_mb(self._bf_pad(0), pad, x0, y0,
                                 fmvs, fsf, 0)
        bp = self._field_pred_mb(self._bf_pad(1), pad, x0, y0,
                                 bmvs, fsb, 0)
        pred_y = (fp[0] + bp[0] + 1) >> 1
        pred_u = (fp[1] + bp[1] + 1) >> 1
        pred_v = (fp[2] + bp[2] + 1) >> 1
        self._b_residual(b, cbp if read_blocks else 0, qscale,
                         pred_y, pred_u, pred_v, x0, y0, y, u, v,
                         dct_type)

    # Copy of tcforge_tpu/io/mpeg4dec.py:1575-1708; the plan store
    # records an intra plan of the H.263 blocks or a P plan of 1MV
    # records (``_rec_1mv``), no pixel work.
    def decode_short(self, data: bytes):
        """Decode one short-video-header picture; returns (y, u, v)
        display planes (no reorder delay — H.263 baseline has no B
        pictures)."""
        b = Bits(data)
        if b.read(22) != 0x20:
            raise ValueError("h263: bad short_video_start_marker")
        b.read(8)                    # temporal_reference
        if b.read1() != 1:
            raise ValueError("h263: marker bit")
        if b.read1() != 0:
            raise ValueError("h263: zero bit")
        b.read(3)                    # split_screen/doc_camera/freeze
        fmt = b.read(3)
        if fmt not in self._SH_FORMATS:
            raise NotImplementedError(
                f"h263: source format {fmt} (extended PTYPE) is not "
                "supported")
        w, h = self._SH_FORMATS[fmt]
        ptype = b.read1()            # 0 = I, 1 = P
        b.read(4)                    # four_reserved_zero_bits
        q = b.read(5)
        if q == 0:
            raise ValueError("h263: quant 0")
        b.read1()                    # zero bit
        while b.read1():             # PEI
            b.read(8)
        if self.vol is None or self.vol.width != w \
                or not getattr(self.vol, "short_header", False):
            vol = _VOL()
            vol.width, vol.height = w, h
            vol.time_inc_res = 30000
            vol.time_inc_bits = _log2up(30000)
            vol.short_header = True
            self.vol = vol
            self._mbw, self._mbh = w // 16, h // 16
        mbw, mbh = self._mbw, self._mbh
        y = np.zeros((h, w), np.uint8)
        u = np.zeros((h // 2, w // 2), np.uint8)
        v = np.zeros((h // 2, w // 2), np.uint8)
        prev = self.last
        if ptype and prev is None:
            raise ValueError("h263: P picture before I picture")
        if self.plan_mode:
            self._plan_new('P' if ptype else 'I')
        pad = 16 + 16
        refs = None if not ptype else \
            [np.pad(pl, pad, mode="edge") for pl in prev]
        mvgrid = [[(0, 0)] * (2 * mbw) for _ in range(2 * mbh)]
        for mby in range(mbh):
            if mby:
                q = self._sh_gob_header(b, q)
            for mbx in range(mbw):
                x0, y0 = 16 * mbx, 16 * mby
                bx, by = 2 * mbx, 2 * mby
                if ptype:
                    if b.read1():            # COD: skip MB
                        if self._plan is not None:
                            # inter copy: zero MVs, no residual
                            self._plan['use_f'][mby * mbw + mbx] = 1
                            continue
                        for p_i, (pl, sh) in enumerate(
                                ((y, 0), (u, 1), (v, 1))):
                            s = 16 >> sh
                            px, py = x0 >> sh, y0 >> sh
                            pl[py:py + s, px:px + s] = \
                                prev[p_i][py:py + s, px:px + s]
                        continue
                    mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT, 13)
                    while mb_type == -2:     # stuffing
                        mb_type, cbpc = _read_lut(b, _MCBPC_P_LUT,
                                                  13)
                else:
                    mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT, 9)
                    while mb_type == -1:
                        mb_type, cbpc = _read_lut(b, _MCBPC_I_LUT,
                                                  9)
                intra = mb_type in (3, 4)
                cbpy = _read_lut(b, _CBPY_LUT, 6)
                if not intra:
                    cbpy ^= 0xF
                if mb_type in (1, 4):
                    q = _dquant(b, q)
                cbp = (cbpy << 2) | cbpc
                if intra:
                    blocks = np.zeros((6, 8, 8), np.int64)
                    for n in range(6):
                        dcd = b.read(8)
                        if dcd in (0, 128):
                            raise ValueError("h263: bad INTRADC")
                        if dcd == 255:
                            dcd = 128
                        lv = np.zeros((8, 8), np.int64)
                        if (cbp >> (5 - n)) & 1:
                            lv = self._read_block_sh(b, 1)
                        blocks[n] = self._dequant_h263(lv, q, dcd)
                    if self._plan is not None:
                        idx = mby * mbw + mbx
                        self._plan['blocks'][idx] = blocks
                        self._plan['intra'][idx] = 1
                        for k in range(4):
                            mvgrid[by + (k >> 1)][bx + (k & 1)] = (0, 0)
                        continue
                    out = idct_put(blocks)
                    self._luma_store(y, x0, y0, out[:4], 0)
                    u[mby * 8:mby * 8 + 8,
                      mbx * 8:mbx * 8 + 8] = out[4]
                    v[mby * 8:mby * 8 + 8,
                      mbx * 8:mbx * 8 + 8] = out[5]
                    for k in range(4):
                        mvgrid[by + (k >> 1)][bx + (k & 1)] = (0, 0)
                    continue
                # inter MB: one MV, H.263 predictors == MPEG-4 1MV
                px_, py_ = self._pred_mv(mvgrid, bx, by, 0)
                mx = self._decode_mv_component(b, 1, px_)
                my = self._decode_mv_component(b, 1, py_)
                for k in range(4):
                    mvgrid[by + (k >> 1)][bx + (k & 1)] = (mx, my)
                if self._plan is not None:
                    blocks = np.zeros((6, 8, 8), np.int64)
                    for n in range(6):
                        if (cbp >> (5 - n)) & 1:
                            lv = self._read_block_sh(b, 0)
                            blocks[n] = self._dequant_h263(lv, q, 0)
                    self._rec_1mv(mby * mbw + mbx, blocks, mx, my)
                    continue
                pred_y = self._mc_block(refs[0], pad, x0, y0, 16,
                                        mx, my, 0)
                cmx = (mx >> 1) | (mx & 1)
                cmy = (my >> 1) | (my & 1)
                pred_u = self._mc_block(refs[1], pad, x0 >> 1,
                                        y0 >> 1, 8, cmx, cmy, 0)
                pred_v = self._mc_block(refs[2], pad, x0 >> 1,
                                        y0 >> 1, 8, cmx, cmy, 0)
                blocks = np.zeros((6, 8, 8), np.int64)
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        lv = self._read_block_sh(b, 0)
                        blocks[n] = self._dequant_h263(lv, q, 0)
                pred6 = np.empty((6, 8, 8), np.int32)
                for k in range(4):
                    pred6[k] = pred_y[8 * (k >> 1):8 * (k >> 1) + 8,
                                      8 * (k & 1):8 * (k & 1) + 8]
                pred6[4] = pred_u
                pred6[5] = pred_v
                out = idct_add_sel(
                    blocks, pred6,
                    [(cbp >> (5 - n)) & 1 for n in range(6)])
                self._luma_store(y, x0, y0, out[:4], 0)
                u[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[4]
                v[(y0 >> 1):(y0 >> 1) + 8,
                  (x0 >> 1):(x0 >> 1) + 8] = out[5]
        if self._plan is not None:
            self.plans.append(self._plan)
            self._plan = None
        self.last = [y, u, v]
        return self._crop_planes([y, u, v])
