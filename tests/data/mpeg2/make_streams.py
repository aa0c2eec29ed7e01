#!/usr/bin/env python3
"""Write the MPEG-1/2 streams that the port's tests and ``chip_smoke.py``
read.  The card's machine has no JAX, so they are files; each is pinned
by SHA-256 in ``tests/test_torch_mpeg2.py`` (``STREAMS``).

    JAX_PLATFORMS=cpu python tests/data/mpeg2/make_streams.py

The JAX package's encoder and program-stream multiplexor make the
encoded ones (``-y mpeg2,raw,mpg`` or ``mpeg2,raw,raw`` with ``-F``
options), from seeded Y4M clips of smooth gradients with moving
textured blocks:

- ``dvd.vob``: NTSC DVD video, 720x480 at 29.97 fps, 48 frames, MPEG-2
  MP@ML frame pictures, GOP N=15 M=3, rate control toward 6000 kbit/s
  (the JAX bench's cfg8 encoder settings at DVD width), a video-only
  program stream;
- ``dvd_fields.vob``: 720x480 field pictures (``fields=1``), 6 frames,
  rate control toward 2000 kbit/s (which the field encoder overshoots
  twice over: the files together stay under 1.5 MB);
- ``small.mpg`` (PS, 64x48, 20 frames, N=6 M=3), ``small.m2v`` (ES,
  80x64, 16 frames, N=9 M=3), ``odd.m2v`` (72x40: a size that is not a
  multiple of 16), ``fields.m2v`` (64x64 field pictures), ``intra.m2v``
  (all intra), ``mpeg1.m1v`` (MPEG-1 I/P/B) and ``dpict.m1v`` (MPEG-1
  D-pictures).

The synthetic ones are written bit by bit here, with random macroblock
modes that the encoder never picks: ``synth_tff1.m2v`` and
``synth_tff0.m2v`` (64x48 frame pictures, I P B B P B B: frame, field
and dual-prime prediction with both field selects, field DCT, coded and
skipped macroblocks, intra macroblocks in P and B pictures, vectors
that point outside the frame), ``synth_odd.m2v`` (the same at 72x40)
and ``synth_fields.m2v`` (64x48 field pictures: 16x16 and 16x8 field
prediction, dual prime, both field selects).
"""

from __future__ import annotations

import hashlib
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent.parent
sys.path.insert(0, str(REPO))

# Table B-9 (coded_block_pattern), code and length by pattern 0..63
CBP_VLC = [
    (0x01, 9), (0x0b, 5), (0x09, 5), (0x0d, 6), (0x0d, 4), (0x17, 7),
    (0x13, 7), (0x1f, 8), (0x0c, 4), (0x16, 7), (0x12, 7), (0x1e, 8),
    (0x13, 5), (0x1b, 8), (0x17, 8), (0x13, 8), (0x0b, 4), (0x15, 7),
    (0x11, 7), (0x1d, 8), (0x11, 5), (0x19, 8), (0x15, 8), (0x11, 8),
    (0x0f, 6), (0x0f, 8), (0x0d, 8), (0x03, 9), (0x0f, 5), (0x0b, 8),
    (0x07, 8), (0x07, 9), (0x0a, 4), (0x14, 7), (0x10, 7), (0x1c, 8),
    (0x0e, 6), (0x0e, 8), (0x0c, 8), (0x02, 9), (0x10, 5), (0x18, 8),
    (0x14, 8), (0x10, 8), (0x0e, 5), (0x0a, 8), (0x06, 8), (0x06, 9),
    (0x12, 5), (0x1a, 8), (0x16, 8), (0x12, 8), (0x0d, 5), (0x09, 8),
    (0x05, 8), (0x05, 9), (0x0c, 5), (0x08, 8), (0x04, 8), (0x04, 9),
    (0x07, 3), (0x0a, 5), (0x08, 5), (0x0c, 6)]
# Table B-1 (macroblock_address_increment) 1..3
MBA_VLC = {1: (0b1, 1), 2: (0b011, 3), 3: (0b010, 3)}
# Table B-10 (motion_code) magnitudes 1..3, before the sign bit
MV_VLC = {1: (0b01, 2), 2: (0b001, 3), 3: (0b0001, 4)}
F_CODE = 3                              # r_size 2: deltas up to +-12


def clip_y4m(path, width, height, frames, seed, fps=(30000, 1001)):
    """Smooth gradients with two textured blocks that move, and mild
    grain: video that compresses like a programme, not like noise."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    tex = rng.integers(40, 220, (max(2, height // 3), max(2, width // 4)))
    hdr = Y4MHeader(width=width, height=height, fps_num=fps[0],
                    fps_den=fps[1], interlacing="t")
    with Y4MWriter(str(path), hdr) as wr:
        for k in range(frames):
            y = 60 + 80 * (xx / width) + 50 * np.sin((yy + 3 * k) / 23.0)
            for (bx, by, vx, vy) in ((0.1, 0.2, 5, 2), (0.6, 0.5, -3, 3)):
                th, tw = tex.shape
                x0 = int(bx * width + vx * k) % max(1, width - tw)
                y0 = int(by * height + vy * k) % max(1, height - th)
                y[y0:y0 + th, x0:x0 + tw] = tex
            y = y + rng.normal(0, 0.5, y.shape)
            cy, cx = yy[::2, ::2] / 2, xx[::2, ::2] / 2
            u = 128 + 30 * np.cos((cx + 2 * k) / 17.0)
            v = 128 + 30 * np.sin((cy - k) / 13.0)
            wr.write_frame(*(np.clip(np.round(p), 0, 255).astype(np.uint8)
                             for p in (y, u, v)))


def encode(src, out, opts, mux):
    from tcforge_tpu.cli import main
    rc = main(["-i", str(src), "-o", str(out), "-y", f"mpeg2,raw,{mux}",
               "-F", opts, "-q", "--progress_off"])
    if rc != 0:
        raise SystemExit(f"encoding {out.name} failed: {rc}")


# ------------------------------------------------------------------ #
# The synthetic streams

class Synth:
    """Random P and B pictures, frame- or field-coded, after an intra
    frame from the JAX package's intra encoder."""

    def __init__(self, width, height, seed, tff=1):
        from tcforge_tpu.io.mpeg2codec import Mpeg2Encoder
        self.w, self.h, self.tff = width, height, tff
        self.mb_w = (width + 15) // 16
        self.rng = np.random.default_rng(seed)
        self.enc = Mpeg2Encoder(width, height, 29.97, qscale=3)

    def intra_frame(self, fields=False):
        rng = self.rng
        yy, xx = np.mgrid[0:self.h, 0:self.w]
        y = (40 + 3 * xx + 2 * yy + rng.integers(0, 60, (self.h, self.w))
             ).clip(0, 255).astype(np.uint8)
        ch, cw = self.h // 2, self.w // 2
        u = rng.integers(60, 200, (ch, cw)).astype(np.uint8)
        v = rng.integers(60, 200, (ch, cw)).astype(np.uint8)
        if fields:
            return self.enc.encode_frame_fields(y, u, v,
                                                top_field_first=True)
        return self.enc.encode_frame(y, u, v, with_seq=True)

    # -- syntax pieces --

    def _header(self, w, ptype, temporal, ps):
        w.start_code(0x00)
        w.put(temporal & 0x3FF, 10)
        w.put(ptype, 3)
        w.put(0xFFFF, 16)
        if ptype in (2, 3):
            w.put(0b0111, 4)           # full_pel 0, f_code 7 (MPEG-2)
        if ptype == 3:
            w.put(0b0111, 4)
        w.put(0, 1)
        w.start_code(0xB5)
        w.put(0b1000, 4)
        for _ in range(4):
            w.put(F_CODE, 4)
        w.put(0, 2)                    # intra_dc_precision 8 bit
        w.put(ps, 2)
        w.put(self.tff, 1)
        w.put(0, 1)                    # frame_pred_frame_dct 0
        w.put(0, 1)                    # no concealment vectors
        w.put(0, 1)                    # linear quantiser scale
        w.put(0, 1)                    # Table B-14
        w.put(0, 1)                    # zigzag scan
        w.put(0, 1)                    # repeat_first_field
        w.put(0, 1)                    # chroma_420_type
        w.put(0, 1)                    # progressive_frame
        w.put(0, 1)                    # composite_display

    def _mv(self, w, dual=False):
        """One motion vector's two components as random deltas (the
        parse adds them to its predictors, so vectors wander across the
        whole range and out of the frame); dual prime's dmvectors."""
        r = F_CODE - 1
        for _ in range(2):
            delta = int(self.rng.integers(-12, 13))
            if delta == 0:
                w.put(1, 1)
            else:
                mag = abs(delta)
                bits, ln = MV_VLC[((mag - 1) >> r) + 1]
                w.put(bits, ln)
                w.put(1 if delta < 0 else 0, 1)
                w.put((mag - 1) & ((1 << r) - 1), r)
            if dual:
                dm = int(self.rng.integers(-1, 2))
                w.put(*{0: (0, 1), 1: (0b10, 2), -1: (0b11, 2)}[dm])

    def _coded_blocks(self, w):
        """A coded block pattern and that many non-intra blocks of a few
        random coefficients each (escape codes, then end of block)."""
        cbp = int(self.rng.integers(1, 64))
        w.put(*CBP_VLC[cbp])
        for _ in range(bin(cbp).count("1")):
            pos = np.sort(self.rng.choice(64, int(self.rng.integers(1, 5)),
                                          replace=False))
            prev = -1
            for p in pos:
                level = int(self.rng.integers(1, 40)) * int(
                    self.rng.choice((-1, 1)))
                w.put(0b000001, 6)     # escape
                w.put(int(p) - prev - 1, 6)
                w.put(level & 0xFFF, 12)
                prev = int(p)
            w.put(0b10, 2)             # end of block

    def _intra_mb(self, w, field_dct_bit):
        """An intra macroblock of DC terms; the DC predictors carry from
        an intra macroblock to the next, and reset at a slice's start
        and after any other macroblock (``self.dc``)."""
        from tcforge_tpu.io.mpeg2codec import (DC_CHROMA, DC_LUMA,
                                               Mpeg2Encoder)
        if field_dct_bit:
            w.put(int(self.rng.integers(0, 2)), 1)     # dct_type
        for i in range(6):
            k = 0 if i < 4 else i - 3          # y y y y, then u, v
            lo, hi, table = ((20, 236, DC_LUMA) if i < 4
                             else (60, 200, DC_CHROMA))
            dc = int(self.rng.integers(lo, hi))
            Mpeg2Encoder._write_dc(w, dc - self.dc[k], table)
            self.dc[k] = dc
            w.put(0b10, 2)

    def picture(self, ptype, temporal, ps=3):
        """A P (2) or B (3) picture, frame (ps 3) or field (ps 1, 2)
        coded, every macroblock's mode drawn at random."""
        from tcforge_tpu.io.mpeg2codec import BitWriter
        rng = self.rng
        w = BitWriter()
        self._header(w, ptype, temporal, ps)
        field = ps != 3
        rows = ((self.h // 2 if field else self.h) + 15) // 16
        for row in range(rows):
            w.start_code(row + 1)
            w.put(int(rng.integers(1, 12)), 5)         # quantiser scale
            w.put(0, 1)
            col, last_plain = 0, False
            self.dc = [128] * 3
            while col < self.mb_w:
                skip = 0
                # skipped macroblocks: never first or last in a slice; in
                # a B picture only after a plain frame-predicted one
                if col > 0 and (ptype == 2 or last_plain):
                    skip = int(rng.choice((0, 0, 0, 1, 2)))
                    skip = min(skip, self.mb_w - 1 - col)
                col += skip
                if skip:
                    self.dc = [128] * 3
                w.put(*MBA_VLC[skip + 1])
                last_plain = self._macroblock(w, ptype, field)
                col += 1
        return w.bytes()

    def _macroblock(self, w, ptype, field):
        """One macroblock; True when a skipped B macroblock may follow
        it (frame prediction, not intra)."""
        rng = self.rng
        intra = rng.random() < 0.1
        if intra:
            w.put(0b00011, 5)
            self._intra_mb(w, not field)
            return False
        self.dc = [128] * 3
        if ptype == 2:
            kind = rng.choice(("mc_coded", "mc", "nomc_coded"))
            fwd, bwd = kind != "nomc_coded", False
            coded = kind != "mc"
            w.put(*{"mc_coded": (1, 1), "mc": (0b001, 3),
                    "nomc_coded": (0b01, 2)}[kind])
        else:
            fwd, bwd = [(True, False), (False, True), (True, True)][
                int(rng.integers(0, 3))]
            coded = bool(rng.integers(0, 2))
            # Table B-3: forward '001c', backward '01c', both '1c'
            code, ln = {(True, False): (0b001, 3), (False, True): (0b01, 2),
                        (True, True): (0b1, 1)}[(fwd, bwd)]
            w.put((code << 1) | int(coded), ln + 1)
        plain = True
        if fwd or bwd:
            choices = ["frame", "field"] + (["dual"] if ptype == 2 else [])
            mt = rng.choice(choices)
            if field:     # field pictures: 16x16 field, 16x8, dual prime
                w.put({"frame": 0b01, "field": 0b10, "dual": 0b11}[mt], 2)
            else:
                w.put({"field": 0b01, "frame": 0b10, "dual": 0b11}[mt], 2)
            plain = mt == "frame" and not field
        if coded and not field:
            w.put(int(rng.integers(0, 2)), 1)          # dct_type
        for present in (fwd, bwd):
            if not present:
                continue
            if mt == "dual":
                self._mv(w, dual=True)
            elif mt == "field":
                # two vectors with field selects: field MC in a frame
                # picture, 16x8 MC in a field picture
                for _ in range(2):
                    w.put(int(rng.integers(0, 2)), 1)
                    self._mv(w)
            else:
                if field:
                    w.put(int(rng.integers(0, 2)), 1)
                self._mv(w)
        if coded:
            self._coded_blocks(w)
        return plain


def synth_frames(width, height, seed, tff):
    """I, then P B B P B B in decode order (temporal references of the
    display order I B B P B B P)."""
    s = Synth(width, height, seed, tff)
    out = bytearray(s.intra_frame())
    for ptype, tref in ((2, 3), (3, 1), (3, 2), (2, 6), (3, 4), (3, 5)):
        out += s.picture(ptype, tref)
    return bytes(out) + b"\x00\x00\x01\xb7"


def synth_fields(width, height, seed):
    """An intra frame of two field pictures, then P and B frames of
    two field pictures each (top first)."""
    s = Synth(width, height, seed, tff=1)
    out = bytearray(s.intra_frame(fields=True))
    for ptype, tref in ((2, 3), (3, 1), (3, 2), (2, 6), (3, 4)):
        for ps in (1, 2):
            out += s.picture(ptype, tref, ps)
    return bytes(out) + b"\x00\x00\x01\xb7"


def main() -> None:
    import tempfile
    import jax
    jax.config.update("jax_platforms", "cpu")
    encoded = {
        # name: (w, h, frames, seed, -F options, multiplexor)
        "dvd.vob": (720, 480, 48, 1,
                    "gop_n=15:gop_m=3:rc=1:bitrate=6000", "mpg"),
        "dvd_fields.vob": (720, 480, 6, 2,
                           "gop_n=15:gop_m=3:rc=1:bitrate=2000:fields=1",
                           "mpg"),
        "small.mpg": (64, 48, 20, 3, "gop_n=6:gop_m=3", "mpg"),
        "small.m2v": (80, 64, 16, 4, "gop_n=9:gop_m=3", "raw"),
        "odd.m2v": (72, 40, 6, 5, "gop_n=1", "raw"),
        "fields.m2v": (64, 64, 10, 6, "gop_n=6:gop_m=3:fields=1", "raw"),
        "intra.m2v": (64, 48, 8, 7, "gop_n=1", "raw"),
        "mpeg1.m1v": (64, 48, 12, 8, "gop_n=6:gop_m=3:mpeg1=1", "raw"),
        "dpict.m1v": (64, 48, 8, 9, "dpict=1", "raw"),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, (w, h, frames, seed, opts, mux) in encoded.items():
            src = Path(tmp) / f"{name}.y4m"
            clip_y4m(src, w, h, frames, seed)
            encode(src, HERE / name, opts, mux)
    (HERE / "synth_tff1.m2v").write_bytes(synth_frames(64, 48, 11, 1))
    (HERE / "synth_tff0.m2v").write_bytes(synth_frames(64, 48, 12, 0))
    (HERE / "synth_odd.m2v").write_bytes(synth_frames(72, 40, 13, 1))
    (HERE / "synth_fields.m2v").write_bytes(synth_fields(64, 48, 14))
    total = 0
    for p in sorted(HERE.glob("*.m?v")) + sorted(HERE.glob("*.vob")) \
            + sorted(HERE.glob("*.mpg")):
        size = os.path.getsize(p)
        total += size
        print(f"{p.name:18s} {size:8d} "
              f"{hashlib.sha256(p.read_bytes()).hexdigest()}")
    print(f"total {total} bytes")


if __name__ == "__main__":
    main()
