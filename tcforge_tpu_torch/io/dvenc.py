# Copied from tcforge_tpu/io/dvenc.py lines 27-130 and 240-383 and 469-480 and 548-597; the DV encoder's VLC tables and bit counts, its DIF templates, quantizer, segment packer and mode choice, and the AAUX injection, without the module docstring, the forward transforms, encode and _segment_strings, which the port splits between the device and the host (io/dvcodec.py).
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tcforge_tpu_torch.io import dvdec as dd

__all__ = ["DVEncoder"]


# ------------------------------------------------------------------ #
# Encode-side VLC: (run, level>0) -> (code, len) incl. the sign slot
# ------------------------------------------------------------------ #

def _build_enc_tables():
    direct = {}
    runonly = {}
    for code, ln, run, level in dd._VLC_HEAD:
        if level:
            key = (run, level)
            if key not in direct or ln + 1 < direct[key][1]:
                direct[key] = (code << 1, ln + 1)   # + sign bit slot
        else:
            runonly[run] = (code, ln)
    for run in range(64):
        if run not in runonly:
            runonly[run] = (8064 + run, 13)
    levelonly = {}
    for lvl in range(1, 256):
        levelonly[lvl] = ((32512 + lvl) << 1, 16)
    for (run, level), v in list(direct.items()):
        if run == 0:
            if level not in levelonly or v[1] < levelonly[level][1]:
                levelonly[level] = v
    return direct, runonly, levelonly


_DIRECT, _RUNONLY, _LEVELONLY = _build_enc_tables()
_EOB_CODE = (dd._EOB[0], dd._EOB[1])


class _BitStr:
    """Growing MSB-first bitstring as (bigint, nbits)."""

    __slots__ = ("val", "n")

    def __init__(self):
        self.val = 0
        self.n = 0

    def put(self, v: int, k: int) -> None:
        self.val = (self.val << k) | (v & ((1 << k) - 1))
        self.n += k


def _ac_bits(levels: List[int]) -> Tuple[int, int]:
    """Zigzag AC levels (index 1..63, level[0] ignored) -> the
    block's AC codeword bitstring (incl. EOB)."""
    bs = _BitStr()
    run = 0
    for pos in range(1, 64):
        v = levels[pos]
        if v == 0:
            run += 1
            continue
        a = abs(v)
        sign = 1 if v < 0 else 0
        hit = _DIRECT.get((run, a))
        if hit is not None:
            code, ln = hit
            bs.put(code | sign, ln)
        else:
            if run:
                code, ln = _RUNONLY[run - 1]
                bs.put(code, ln)
            code, ln = _LEVELONLY[a]
            bs.put(code | sign, ln)
        run = 0
    code, ln = _EOB_CODE
    bs.put(code, ln)
    return bs.val, bs.n


def _ac_cost(levels: List[int]) -> int:
    """Bit cost of _ac_bits without building the string."""
    cost = _EOB_CODE[1]
    run = 0
    for pos in range(1, 64):
        v = levels[pos]
        if v == 0:
            run += 1
            continue
        a = abs(v)
        hit = _DIRECT.get((run, a))
        if hit is not None:
            cost += hit[1]
        else:
            if run:
                cost += _RUNONLY[run - 1][1]
            cost += _LEVELONLY[a][1]
        run = 0
    return cost


# DIF section templates (625/50 field values; see module docstring)
_HDR_PAYLOAD = bytes.fromhex("bff87878" + "78" + "ff" * 72)
# NTSC: DSF=0 in the header byte; VAUX source byte 3 clears the
# 50/60 system bit
_HDR_PAYLOAD_N = bytes.fromhex("3ff87878" + "78" + "ff" * 72)
_VAUX_PACKS_N = bytes.fromhex("60ffffc0ff613fc8fcff")
_VAUX_PAYLOAD_N = (_VAUX_PACKS_N + b"\xff" * 35 + _VAUX_PACKS_N
                   + b"\xff" * 22)[:77]
_SUB_PAYLOAD = bytes(
    b"".join(bytes([0x8F, 0xF0 + n]) + b"\xff" * 6 for n in range(9))
)[:77].ljust(77, b"\xff")
_VAUX_PACKS = bytes.fromhex("60ffffe0ff613fc8fcff")
_VAUX_PAYLOAD = (_VAUX_PACKS + b"\xff" * 35 + _VAUX_PACKS
                 + b"\xff" * 22)[:77]
_AUDIO_PAYLOAD = b"\xff" * 77


class DVEncoder:
    """DV25 frame encoder: encode(y, u, v) -> DIF frame
    (PAL 720x576 4:2:0 -> 144000 bytes; NTSC 720x480 4:1:1 with
    (480, 180) chroma -> 120000 bytes)."""

    def __init__(self):
        self._factors = dd.DVDecoder()._factors
        # quant index per (class, qno): q = qno + offset[class]
        self._zz = np.array(dd._ZIGZAG_88, np.int64)
        self._zz248 = np.array(dd._ZIGZAG_248, np.int64)

    # ------------------------------------------------------------ #

    def _quantize(self, X: np.ndarray, mode: int, qno: int
                  ) -> Tuple[int, List[int]]:
        """Coefficients (64,) raster -> (class, zigzag levels) at
        qno: finest class whose AC levels fit |level| <= 255."""
        zz = self._zz248 if mode else self._zz
        xz = X[zz]
        for cls in (0, 1, 2, 3):
            q = qno + dd._QUANT_OFFSET[cls]
            factor = np.array(
                self._factors[1 if cls == 3 else 0][mode][q],
                np.float64)
            lv = np.rint(xz * 16384.0 / factor).astype(np.int64)
            if np.abs(lv[1:]).max(initial=0) <= 255:
                out = lv.tolist()
                return cls, out
        np.clip(lv, -255, 255, out=lv)
        return 3, lv.tolist()

    # ------------------------------------------------------------ #

    @staticmethod
    def _pack_segment(mbs: List[Tuple[int, List[Tuple[int, int]]]]
                      ) -> List[bytes]:
        """5 parsed MBs [(qno, [(bits, nbits) x 6])] -> 5 x 77-byte
        payloads with decoder-exact pass-1/2/3 spilling."""
        payloads = []
        free_slots: List[List[int]] = []   # [mb] -> free bit counts
        mb_over: List[Tuple[int, int]] = []  # per-MB overflow string
        area_bits: List[List[List[int]]] = []
        for qno, strs in mbs:
            areas = []          # per block: [val, nbits] placed bits
            frees = []
            over = _BitStr()
            for bi, (v, n) in enumerate(strs):
                cap = dd._BLOCK_BITS[bi]
                if n <= cap:
                    areas.append([v, n])
                    frees.append(cap - n)
                else:
                    areas.append([v >> (n - cap), cap])
                    over.put(v & ((1 << (n - cap)) - 1), n - cap)
                    frees.append(0)
            free_slots.append(frees)
            mb_over.append((over.val, over.n))
            area_bits.append(areas)
        # pass 2: each MB's overflow goes into its own free tails
        seg_over = _BitStr()
        for m in range(5):
            ov, on = mb_over[m]
            pos = 0
            for bi in range(6):
                f = free_slots[m][bi]
                if f <= 0 or pos >= on:
                    continue
                take = min(f, on - pos)
                chunk = (ov >> (on - pos - take)) & ((1 << take) - 1)
                areas = area_bits[m][bi]
                areas[0] = (areas[0] << take) | chunk
                areas[1] += take
                free_slots[m][bi] -= take
                pos += take
            if pos < on:
                seg_over.put(ov & ((1 << (on - pos)) - 1), on - pos)
        # pass 3: the segment overflow fills the remaining free
        # tails across MBs in order (the reader's segment pool)
        ov, on = seg_over.val, seg_over.n
        pos = 0
        for m in range(5):
            for bi in range(6):
                f = free_slots[m][bi]
                if f <= 0 or pos >= on:
                    continue
                take = min(f, on - pos)
                chunk = (ov >> (on - pos - take)) & ((1 << take) - 1)
                areas = area_bits[m][bi]
                areas[0] = (areas[0] << take) | chunk
                areas[1] += take
                free_slots[m][bi] -= take
                pos += take
        # the segment-fit guarantee (see _segment_strings) means
        # everything placed; a leftover here is a bug
        assert pos == on, "dvenc: segment overflow exceeded capacity"
        # emit payloads: STA/QNO byte + areas padded with 1-bits
        for m in range(5):
            qno, _ = mbs[m]
            bs = _BitStr()
            bs.put(0x0, 4)                  # STA
            bs.put(qno, 4)
            for bi in range(6):
                v, n = area_bits[m][bi]
                pad = dd._BLOCK_BITS[bi] - n
                bs.put(v, n)
                if pad:                 # provably unread (see above)
                    bs.put((1 << pad) - 1, pad)
            assert bs.n == 616
            payloads.append(bs.val.to_bytes(77, "big"))
        return payloads

    # ------------------------------------------------------------ #

    @staticmethod
    def _pick_modes(blocks: np.ndarray) -> List[int]:
        """Per-block 8-8 vs 2-4-8 decision: interlaced content has
        more energy in line-to-line differences than in field-
        internal differences."""
        modes = []
        for b in blocks:
            x = b.astype(np.int64)
            inter = np.abs(x[1:] - x[:-1]).sum()
            fields = (np.abs(x[2:] - x[:-2]).sum() + 1) // 2
            modes.append(1 if inter > 2 * fields else 0)
        return modes

    def _mb_at_qno(self, X, modes, qno):
        """AC info for one MB at a quantizer: [(cls, lv, cost)] and
        the MB's total AC bits."""
        info = []
        total = 0
        for i in range(6):
            cls, lv = self._quantize(X[i], modes[i], qno)
            cost = _ac_cost(lv)
            info.append((cls, lv, cost))
            total += cost
        return info, total

# ------------------------------------------------------------------ #
# DV audio injection (AAUX, PAL 48 kHz 16-bit stereo)
# ------------------------------------------------------------------ #

# AAUX pack templates (field values of the 625/50 48k/16-bit locked
# mode; byte 2 of the AS pack carries the channel-group index)
_AAUX_PACKS = (bytes.fromhex("50d800e080"),
               bytes.fromhex("511ccfa0ff"),
               bytes.fromhex("52ffc10170"),
               bytes.fromhex("53ff8080c0"))


def inject_audio(frame: bytes, pcm: np.ndarray) -> bytes:
    """Write (1920, 2) int16 samples into a DV25 PAL frame's audio
    DIF blocks (the shuffle derived empirically — see io/dvdec.py).
    Short input is zero-padded; returns the new frame."""
    if len(frame) != 144000:
        raise ValueError("dv audio: need a PAL DIF frame")
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = np.stack([pcm, pcm], axis=1)
    if pcm.shape[0] < 1920:
        pcm = np.pad(pcm, ((0, 1920 - pcm.shape[0]), (0, 0)))
    out = bytearray(frame)
    offs = {}
    for off in range(0, 144000, 80):
        if out[off] >> 5 == 3:
            seq = out[off + 1] >> 4
            dbn = out[off + 2]
            offs[(seq, dbn)] = off + 3
            # AAUX packs: dbn 3..6 in even sequences, 0..3 in odd
            start = 3 if seq % 2 == 0 else 0
            if start <= dbn < start + 4:
                pk = bytearray(_AAUX_PACKS[dbn - start])
                if pk[0] == 0x50 and seq >= 6:
                    pk[2] = 0x01          # second channel group
                out[off + 3:off + 8] = pk
            else:
                out[off + 3:off + 8] = b"\xff" * 5
    from tcforge_tpu_torch.io.dvdec import _AUD_SEQ, _AUD_DBN, _AUD_OFF
    for ch in range(2):
        col = pcm[:1920, ch]
        for n in range(1920):
            base = offs[(int(_AUD_SEQ[n]) + 6 * ch,
                         int(_AUD_DBN[n]))]
            o = base + int(_AUD_OFF[n])
            v = int(col[n]) & 0xFFFF
            out[o] = v >> 8
            out[o + 1] = v & 0xFF
    return bytes(out)
