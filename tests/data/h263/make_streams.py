#!/usr/bin/env python3
"""Write the short-header (H.263) AVI files that the port's H.263 tests
and ``chip_smoke.py`` read.  The card's machine has no JAX and no
FFmpeg, so they are files; each is pinned by SHA-256 in
``tests/test_torch_h263.py`` (``FIXTURES``).

    JAX_PLATFORMS=cpu python tests/data/h263/make_streams.py

libavcodec's ``h263`` encoder through the JAX package's FFmpeg bridge
(``tcforge_tpu/native/av.py`` ``AvVideoEncoder``) codes seeded clips of
``tests/data/mpeg4/make_streams.py`` (smooth gradients that pan, with
textured blocks moving against them); the JAX package's
``io/avi.AviWriter`` writes them under MPEG-4 fourccs, the route on
which the JAX avi importer's numpy decoder takes short-header pictures:

- ``h263.avi``: CIF (352x288, the largest size 3GP and videoconference
  H.263 commonly carries) at 25 fps, 48 frames (four GOPs of 12),
  toward 400 kbit/s (a rate tolerance of 50,000 bits holds it there),
  fourcc ``FMP4``;
- ``qcif.avi``: QCIF (176x144), 12 frames, GOP 6, toward 100 kbit/s,
  fourcc ``XVID``, with two zero-size drop-frame chunks;
- ``gob.avi``: sub-QCIF (128x96), 8 frames, GOP 4, toward 100 kbit/s,
  fourcc ``DIVX``, with GOB headers (libavcodec's ``ps``, its RTP
  payload size, starts a GOB where a packet fills).

The output is the same bytes on every run.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent.parent
sys.path.insert(0, str(REPO))

FPS = 25.0


def h263(frames, width: int, height: int, bitrate: int, gop: int,
         opts=None):
    """libavcodec h263 packets (one picture each)."""
    from tcforge_tpu.native import av
    enc = av.AvVideoEncoder("h263", width, height, fps=FPS, bitrate=bitrate,
                            gop=gop, opts=opts)
    pkts = []
    for f in frames:
        pkts += [p for p, _ in enc.encode(*f)]
    pkts += [p for p, _ in enc.flush()]
    enc.close()
    return pkts


def _mpeg4_streams():
    """``tests/data/mpeg4/make_streams.py`` (its clips and AVI writer)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mpeg4_make_streams", HERE.parent / "mpeg4" / "make_streams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    m4 = _mpeg4_streams()
    clip, write_avi = m4.clip, m4.write_avi
    write_avi(HERE / "h263.avi", "FMP4", 352, 288,
              h263(clip(352, 288, 48, seed=31), 352, 288, 400_000, 12,
                   {"bt": "50000"}))
    pkts = h263(clip(176, 144, 12, seed=32), 176, 144, 100_000, 6,
                {"bt": "20000"})
    write_avi(HERE / "qcif.avi", "XVID", 176, 144,
              pkts[:4] + [b""] + pkts[4:9] + [b""] + pkts[9:])
    write_avi(HERE / "gob.avi", "DIVX", 128, 96,
              h263(clip(128, 96, 8, seed=33), 128, 96, 100_000, 4,
                   {"ps": "64", "bt": "20000"}))
    for p in sorted(HERE.glob("*.avi")):
        print(f"{p.name}: {p.stat().st_size} bytes, "
              f"{hashlib.sha256(p.read_bytes()).hexdigest()}")


if __name__ == "__main__":
    main()
