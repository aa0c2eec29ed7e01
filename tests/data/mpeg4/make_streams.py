#!/usr/bin/env python3
"""Write the AVI files that the port's MPEG-4 and AVI tests and
``chip_smoke.py`` read.  The card's machine has no JAX, so they are
files; each is pinned by SHA-256 in ``tests/test_torch_mpeg4.py``
(``FIXTURES``).

    JAX_PLATFORMS=cpu python tests/data/mpeg4/make_streams.py

The JAX package's own encoders make them: libavcodec's ``mpeg4``
through its FFmpeg bridge (``tcforge_tpu/native/av.py``), its in-tree
``io/mpeg4enc.Mpeg4NativeEncoder`` and LZO1X compressor, and its
``io/avi.AviWriter``, from seeded clips of smooth gradients that pan,
with textured blocks moving against them (so that the vectors reach
past the frame's edges and the 8x8 blocks of a macroblock differ):

- ``divx.avi``: 640x480 at 25 fps, XVID fourcc, 24 frames (two GOPs of
  12), ``bf=2``, ``flags=+mv4``, toward 1.5 Mbit/s (the JAX bench's
  cfg10 encoder settings, ``benches/run_configs.py:564-660``, with the
  4MV flag spelled as libavcodec takes it), with a 48 kHz stereo s16
  PCM track interleaved a frame at a time;
- ``small.avi`` (176x144) and ``odd.avi`` (200x136, not a multiple of
  16), 12 frames each, the same settings toward 250 kbit/s, with an
  8 kHz stereo PCM track;
- ``drop.avi``: 176x144, 8 frames of I/P with two zero-size drop-frame
  chunks;
- ``packed.avi``: 176x144, 8 frames of I/P/B with each P and the B after it packed
  into one chunk and an empty placeholder chunk behind it (Xvid's
  packed bitstream);
- ``native.avi``: 176x144, 8 frames from ``Mpeg4NativeEncoder`` (4MV, two B
  frames, GOP 6);
- ``qpel.avi`` and ``ildct.avi``: 176x144, 2 frames with quarter-sample
  and interlaced VOLs;
- ``qpel_small.avi`` and ``il_small.avi``: 176x144, 12 frames, ``bf=2``,
  toward 250 kbit/s, with ``flags=+qpel+mv4`` (Xvid's Advanced Simple
  Profile) and with ``flags=+ildct+ilme`` on field-sampled content
  (``fields``: each frame's two fields from two instants);
- ``divx_qpel.avi``: 640x480 at 25 fps, 12 frames, cfg10's settings with
  ``+qpel``, toward 1 Mbit/s;
- ``divx_il.avi``: 720x480 at 29.97 fps, 12 field-sampled frames,
  ``+ildct+ilme``, toward 1 Mbit/s (an NTSC capture kept interlaced);
- ``qpel_il.avi``: 176x144, 2 field-sampled frames with
  ``+qpel+ildct+ilme``, whose field-predicted P macroblocks in a
  quarter-sample VOL the numpy decoder refuses;
- ``yuy2.avi`` (YUY2) and ``lzo.avi`` (LZO2), 64x48, 4 frames, with
  8 kHz PCM.

The output is the same bytes on every run.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent.parent
sys.path.insert(0, str(REPO))

FPS = 25.0
RATE = 48000                     # divx.avi's track
SMALL_RATE = 8000                # the small clips' tracks


def clip(width: int, height: int, frames: int, seed: int):
    """Seeded YUV420P frames: a smooth gradient panning by a non-integer
    step, two textured blocks moving against it, mild noise."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (64, 64)).astype(np.float64)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, 1, (0, 1))) / 4
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    out = []
    for t in range(frames):
        px, py = 2.5 * t, -1.5 * t
        y = (96 + 60 * np.sin((xx + px) / 37.0) * np.cos((yy + py) / 29.0)
             + 0.15 * (xx + yy))
        for k, (bx, by, vx, vy) in enumerate(((0.2, 0.3, -3.5, 2.0),
                                              (0.6, 0.5, 4.0, -2.5))):
            x0 = int(bx * width + vx * t) % max(1, width - 24)
            y0 = int(by * height + vy * t) % max(1, height - 24)
            s = min(48, width - x0, height - y0)
            y[y0:y0 + s, x0:x0 + s] = tex[:s, :s] * (0.6 + 0.3 * k) + 20
        y += rng.normal(0, 1.0, y.shape)
        y = np.clip(y, 0, 255).astype(np.uint8)
        ch, cw = height // 2, width // 2
        u = np.clip(128 + 40 * np.sin((xx[::2, ::2][:ch, :cw] + 2 * t) / 23),
                    0, 255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos((yy[::2, ::2][:ch, :cw] - t) / 19),
                    0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


def pcm(frames: int, seed: int, rate: int = RATE) -> np.ndarray:
    """(frames * rate / FPS, 2) int16: two tones and noise."""
    rng = np.random.default_rng(seed)
    n = frames * rate // int(FPS)
    t = np.arange(n) / rate
    left = 6000 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 300, n)
    right = 4000 * np.sin(2 * np.pi * 660 * t) + rng.normal(0, 300, n)
    return np.stack([left, right], 1).round().astype(np.int16)


def fields(width: int, height: int, frames: int, seed: int):
    """Field-sampled frames, as an interlaced capture holds them:
    ``clip`` at twice the frame rate, each frame's top-field rows (even)
    from one instant and its bottom-field rows (odd) from the next."""
    out = []
    src = clip(width, height, 2 * frames, seed)
    for t in range(frames):
        first, second = src[2 * t], src[2 * t + 1]
        frame = []
        for a, b in zip(first, second):
            p = a.copy()
            p[1::2] = b[1::2]
            frame.append(p)
        out.append(tuple(frame))
    return out


def lavc(frames, width: int, height: int, opts: dict, gop: int = 12,
         bitrate: int = 1_500_000, fps: float = FPS):
    """libavcodec mpeg4 packets in decode order."""
    from tcforge_tpu.native import av
    enc = av.AvVideoEncoder("mpeg4", width, height, fps=fps,
                            bitrate=bitrate, gop=gop, opts=opts)
    pkts = []
    for f in frames:
        pkts += [p for p, _ in enc.encode(*f)]
    pkts += [p for p, _ in enc.flush()]
    enc.close()
    return pkts


def write_avi(path: Path, fourcc: str, width: int, height: int, chunks,
              audio=None, rate: int = RATE, fps: float = FPS) -> None:
    """``chunks``: video payloads (b"" a drop-frame chunk); ``audio``:
    int16 (n, 2) PCM at ``rate``, a frame's samples after each video
    chunk."""
    from tcforge_tpu.io.avi import AviAudioStream, AviVideoStream, AviWriter
    tracks = [AviAudioStream(rate=rate, channels=2, bits=16)] \
        if audio is not None else []
    spf = rate // int(FPS)
    w = AviWriter(str(path), AviVideoStream(fourcc=fourcc, width=width,
                                            height=height, fps=fps), tracks)
    for i, c in enumerate(chunks):
        w.write_video_frame(c, keyframe=(i == 0))
        if audio is not None:
            part = audio[i * spf:(i + 1) * spf]
            if len(part):
                w.write_audio(part.tobytes())
    w.close()


DIVX = {"bf": "2", "flags": "+mv4"}
# Xvid's Advanced Simple Profile "quality" encode: quarter-sample with 4MV
QPEL = {"bf": "2", "flags": "+qpel+mv4"}
# a capture kept interlaced: field DCT and field motion
ILACE = {"bf": "2", "flags": "+ildct+ilme"}
# divx_il.avi's rate tolerance, in bits: libavcodec's default lets a
# 12-frame clip of field-sampled noise overshoot 1 Mbit/s threefold
ILACE_BT = {**ILACE, "bt": "200000"}
NTSC = 30000 / 1001


def main() -> None:
    from tcforge_tpu.core.formats import ImageFormat
    from tcforge_tpu.io import tclzo
    from tcforge_tpu.io.mpeg4enc import Mpeg4NativeEncoder
    from tcforge_tpu.io.rawio import pack_frame

    frames = clip(640, 480, 24, seed=1)
    write_avi(HERE / "divx.avi", "XVID", 640, 480,
              lavc(frames, 640, 480, DIVX), pcm(24, 2))
    for name, (w, h) in (("small.avi", (176, 144)), ("odd.avi", (200, 136))):
        write_avi(HERE / name, "XVID", w, h,
                  lavc(clip(w, h, 12, seed=3), w, h, DIVX, bitrate=250_000),
                  pcm(12, 4, SMALL_RATE), SMALL_RATE)

    small = clip(176, 144, 8, seed=5)
    pkts = lavc(small, 176, 144, {}, gop=6, bitrate=200_000)
    chunks = []
    for i, p in enumerate(pkts):
        chunks.append(p)
        if i in (2, 5):
            chunks.append(b"")
    write_avi(HERE / "drop.avi", "XVID", 176, 144, chunks)

    # decode order I P B P B ...: each P with the B behind it in one
    # chunk, then the placeholder
    pkts = lavc(small, 176, 144, {"bf": "1"}, gop=6, bitrate=200_000)
    chunks, i = [], 0
    while i < len(pkts):
        kind = (pkts[i][pkts[i].find(b"\x00\x00\x01\xb6") + 4] >> 6)
        if kind == 1 and i + 1 < len(pkts):
            chunks += [pkts[i] + pkts[i + 1], b""]
            i += 2
        else:
            chunks.append(pkts[i])
            i += 1
    write_avi(HERE / "packed.avi", "XVID", 176, 144, chunks)

    enc = Mpeg4NativeEncoder(176, 144, fps=FPS, qscale=6, gop=6,
                             bframes=2, four_mv=True)
    chunks = []
    for f in small:
        chunks += [c for c, _ in enc.push(*f)]
    chunks += [c for c, _ in enc.flush()]
    write_avi(HERE / "native.avi", "DIVX", 176, 144, chunks)

    for name, opts in (("qpel.avi", {"flags": "+qpel"}),
                       ("ildct.avi", {"flags": "+ildct"})):
        write_avi(HERE / name, "XVID", 176, 144,
                  lavc(small[:2], 176, 144, opts, bitrate=200_000))

    write_avi(HERE / "qpel_small.avi", "XVID", 176, 144,
              lavc(clip(176, 144, 12, seed=11), 176, 144, QPEL,
                   bitrate=250_000))
    write_avi(HERE / "il_small.avi", "XVID", 176, 144,
              lavc(fields(176, 144, 12, seed=12), 176, 144, ILACE,
                   bitrate=250_000))
    write_avi(HERE / "divx_qpel.avi", "XVID", 640, 480,
              lavc(clip(640, 480, 12, seed=13), 640, 480, QPEL,
                   bitrate=1_000_000))
    write_avi(HERE / "divx_il.avi", "XVID", 720, 480,
              lavc(fields(720, 480, 12, seed=14), 720, 480, ILACE_BT,
                   bitrate=1_000_000, fps=NTSC), fps=NTSC)
    write_avi(HERE / "qpel_il.avi", "XVID", 176, 144,
              lavc(fields(176, 144, 2, seed=15), 176, 144,
                   {"flags": "+qpel+ildct+ilme"}, bitrate=200_000))

    tiny = clip(64, 48, 4, seed=7)
    write_avi(HERE / "yuy2.avi", "YUY2", 64, 48,
              [pack_frame((y, np.repeat(u, 2, 0), np.repeat(v, 2, 0)),
                          ImageFormat.YUY2) for y, u, v in tiny],
              pcm(4, 8, SMALL_RATE), SMALL_RATE)
    write_avi(HERE / "lzo.avi", "LZO2", 64, 48,
              [tclzo.compress_frame(pack_frame(f, ImageFormat.YUV420P))
               for f in tiny], pcm(4, 9, SMALL_RATE), SMALL_RATE)

    for p in sorted(HERE.glob("*.avi")):
        print(f"{p.name}: {p.stat().st_size} bytes, "
              f"{hashlib.sha256(p.read_bytes()).hexdigest()}")


if __name__ == "__main__":
    main()
