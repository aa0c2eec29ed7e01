"""Write the Theora fixtures of the port's tests with libtheora through
the JAX package's FFmpeg bridge (``tcforge_tpu.native.av``), from seeded
frames.

    JAX_PLATFORMS=cpu python tests/data/theora/make_streams.py

Each file is an Ogg holding one Theora stream (its three header packets
on pages of their own, then one data packet a page):

- ``yuv420.ogv``, ``yuv422.ogv``, ``yuv444.ogv``: 96x80, eight frames, a
  key frame every four, a smoothed noise field that pans away and comes
  back (the encoder picks GOLDEN_MV and 4MV macroblocks) with a patch
  moving down and to the left (negative horizontal vectors);
- ``cif.ogv``: 176x144 4:2:0, ten frames, one key frame;
- ``lowq.ogv``: 96x80 at a fixed coarse quantizer, where the loop filter
  works on partly coded frames;
- ``cropped.ogv``: a 50x34 picture in a 64x48 frame;
- ``dup.ogv``: ``yuv420.ogv``'s packets with zero-length repeat markers
  after the fourth frame and at the end.

Deterministic: the same bytes each run (a few seconds).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))


def frames(w: int, h: int, n: int, seed: int, cw: int, ch: int):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h + 96, w + 96)).astype(float)
    for ax in range(2):
        base = (base + np.roll(base, 1, ax) + np.roll(base, -1, ax)) / 3
    as8 = lambda a: np.clip(a, 0, 255).astype(np.uint8)
    patch = as8(base[:24, :24] * 1.2)
    out = []
    for i in range(n):
        k = i if i < n // 2 else n - 1 - i         # away and back
        dx, dy = 3 * k, 2 * k - (i % 3)
        y = as8(base[20 + dy:20 + dy + h, 20 + dx:20 + dx + w]).copy()
        px, py = max(0, w - 40 - 5 * i), min(h - 24, 8 + 3 * i)
        y[py:py + 24, px:px + 24] = patch[:min(24, h - py), :min(24, w - px)]
        u = as8(base[i:i + ch, 2 * i:2 * i + cw])
        v = as8(base[40:40 + ch, 10 + i:10 + i + cw])
        out.append((np.ascontiguousarray(y), u, v))
    return out


def encode(fr, w: int, h: int, gop: int, **kw):
    from tcforge_tpu.native import av
    enc = av.AvVideoEncoder("libtheora", w, h, fps=25.0, gop=gop,
                            global_header=True, **kw)
    pkts = []
    for f in fr:
        pkts += [p for p, _ in enc.encode(*f)]
    pkts += [p for p, _ in enc.flush()]
    return av.split_xiph_extradata(enc.extradata), pkts


def write_ogg(path: Path, hdrs, pkts) -> None:
    from tcforge_tpu.io.ogg import OggPageWriter
    with open(path, "wb") as f:
        wr = OggPageWriter(f, serial=0x7E0A)
        for hp in hdrs:
            wr.write_packet(hp, granule=0, flush=True)
        for i, pkt in enumerate(pkts):
            wr.write_packet(pkt, granule=i + 1, flush=True)
        wr.close(eos=True)


def main() -> None:
    w, h = 96, 80
    for fmt, cw, ch in (("yuv420p", w // 2, h // 2),
                        ("yuv422p", w // 2, h), ("yuv444p", w, h)):
        hdrs, pkts = encode(frames(w, h, 8, 3, cw, ch), w, h, 4,
                            bitrate=300_000, opts={"pixel_format": fmt})
        write_ogg(HERE / f"{fmt[:6]}.ogv", hdrs, pkts)
        if fmt == "yuv420p":
            write_ogg(HERE / "dup.ogv", hdrs,
                      pkts[:4] + [b""] + pkts[4:] + [b""])
    hdrs, pkts = encode(frames(176, 144, 10, 5, 88, 72), 176, 144, 12,
                        bitrate=250_000)
    write_ogg(HERE / "cif.ogv", hdrs, pkts)
    hdrs, pkts = encode(frames(w, h, 6, 7, w // 2, h // 2), w, h, 4,
                        opts={"flags": "+qscale", "global_quality": "354"})
    write_ogg(HERE / "lowq.ogv", hdrs, pkts)
    hdrs, pkts = encode(frames(50, 34, 6, 9, 25, 17), 50, 34, 5,
                        opts={"flags": "+qscale", "global_quality": "826"})
    write_ogg(HERE / "cropped.ogv", hdrs, pkts)


if __name__ == "__main__":
    main()
