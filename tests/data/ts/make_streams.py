#!/usr/bin/env python3
"""Write the elementary streams from which the port's tests and
``chip_smoke.py`` build their transport streams, VideoCD tracks and
``-p`` audio files.  The card's machine has no JAX, so they are files;
each is pinned by SHA-256 in ``tests/test_torch_ts.py`` (``FIXTURES``).
The transport streams and CDXA tracks themselves are muxed from them at
run time (``chip_smoke.ts_input``, ``chip_smoke.vcd_input``).

    JAX_PLATFORMS=cpu python tests/data/ts/make_streams.py

The JAX package's own encoders write them, with the FFmpeg bridge
unused (the same bytes on any machine):

- ``video.m2v``: 176x144 at 25 fps, 15 frames of
  ``tests/data/mpeg2/make_streams.clip_y4m``, MPEG-2 I/P/B frame
  pictures, GOP N=5 M=3 at qscale 24 (the JAX CLI, ``-y
  mpeg2,raw,raw``); its encoder repeats the sequence header, so the
  stream holds five program stream units;
- ``a.mp2``: MPEG-1 Layer II, 48 kHz stereo, 64 kbit/s
  (``io/mpaenc.py``); ``a.mp3``: MPEG-1 Layer III, the same at 64
  kbit/s (``io/mp3enc.py``); ``a.ac3``: AC-3, 48 kHz stereo, 96 kbit/s
  (``io/a52enc.py``); ``a.aac``: AAC-LC in ADTS frames, 48 kHz stereo,
  64 kbit/s (``io/aacenc.py``); ``a.flac``: FLAC, 8 kHz mono, 16 bits
  (``io/flac.py``).  Each holds 0.6 s (the video's length) of a tone
  a channel under seeded noise.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests" / "data" / "mpeg2"))

SECONDS = 0.6


def tones(rate: int, channels: int, seed: int) -> np.ndarray:
    """(S, C) int16: a tone a channel under seeded noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * SECONDS)) / rate
    out = []
    for ch in range(channels):
        x = 6000 * np.sin(2 * np.pi * (440 + 220 * ch) * t)
        out.append(x + rng.normal(0, 300, t.shape))
    return np.clip(np.rint(np.stack(out, 1)), -32768, 32767).astype(np.int16)


def frames(pcm: np.ndarray, size: int):
    """The samples in frames of ``size``, the last padded with zeros."""
    n = -(-pcm.shape[0] // size)
    pad = np.zeros((n * size - pcm.shape[0], pcm.shape[1]), np.int16)
    whole = np.concatenate([pcm, pad])
    return [whole[k * size:(k + 1) * size] for k in range(n)]


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import make_streams as mpeg2_streams
    from tcforge_tpu.io import aacenc, a52enc, flac, mp3enc, mpaenc
    tmp = HERE / "_clip.y4m"
    mpeg2_streams.clip_y4m(tmp, 176, 144, 15, seed=31, fps=(25, 1))
    mpeg2_streams.encode(tmp, HERE / "video.m2v",
                         "gop_n=5:gop_m=3:qscale=24", "raw")
    os.unlink(tmp)
    pcm = tones(48000, 2, seed=7)
    enc = mpaenc.Mp2Encoder(48000, 2, 64)
    (HERE / "a.mp2").write_bytes(b"".join(
        enc.encode_frame(f) for f in frames(pcm, 1152)))
    # table 0 codes an all-zero region in no bits; the JAX encoder looks
    # its codes up and raises, so it gets an empty table (as the port's
    # copy skips the region)
    mp3enc._VTABS[0] = (np.zeros(256, np.int64), np.zeros(256, np.int64))
    enc = mp3enc.Mp3Encoder(48000, 2, 64)
    (HERE / "a.mp3").write_bytes(b"".join(
        enc.encode_frame(f) for f in frames(pcm, 1152)))
    enc = a52enc.A52Encoder(48000, 2, 96)
    (HERE / "a.ac3").write_bytes(b"".join(
        enc.encode_frame(f) for f in frames(pcm, 1536)))
    enc = aacenc.AacEncoder(48000, 2, 64)
    out = bytearray()
    for f in frames(pcm, 1024):
        au = enc.encode_frame(f)
        out += aacenc.adts_header(len(au), enc.sfi, 2) + au
    (HERE / "a.aac").write_bytes(bytes(out))
    mono = tones(8000, 1, seed=8)
    enc = flac.FlacEncoder(8000, 1)
    (HERE / "a.flac").write_bytes(enc.header() + b"".join(
        enc.encode_frame(f) for f in frames(mono, enc.block)[:-1])
        + enc.encode_frame(mono[(len(frames(mono, enc.block)) - 1)
                                * enc.block:]))
    for name in sorted(p.name for p in HERE.iterdir()
                       if p.suffix != ".py"):
        print(name, (HERE / name).stat().st_size)


if __name__ == "__main__":
    main()
