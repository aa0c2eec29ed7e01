"""Write the DV fixtures of the port's tests with the JAX package's in-tree
DV25 encoder (``tcforge_tpu/io/dvenc.py``), from seeded frames.

    JAX_PLATFORMS=cpu python tests/data/dv/make_streams.py

- ``pal.dv``: two 720x576 4:2:0 frames with 48 kHz 16-bit stereo AAUX
  audio (``inject_audio``);
- ``ntsc.dv``: two 720x480 4:1:1 frames, no audio.

The content mixes gradients, a moving edge, field-interlaced stripes (the
encoder picks 2-4-8 blocks there) and seeded noise.  Deterministic: the
same bytes each run (about 40 s: the encoder takes seconds a frame).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))


def frame(h: int, w: int, ch: int, cw: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 60 + 0.15 * xx + 0.1 * yy + 30 * np.sin(xx / (9.0 + k) + yy / 23.0)
    # a moving bright edge
    y += 70 * (xx > 200 + 40 * k)
    # interlaced stripes in a band: the fields disagree
    band = (yy > h // 3) & (yy < h // 2)
    y += np.where(band, 40 * ((yy + k) % 2), 0)
    y += rng.normal(0, 6, (h, w))
    cy, cx = np.mgrid[0:ch, 0:cw]
    u = 128 + 40 * np.sin(cx / 17.0 + k) + rng.normal(0, 3, (ch, cw))
    v = 128 + 40 * np.cos(cy / 13.0 - k) + rng.normal(0, 3, (ch, cw))
    as8 = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)
    return as8(y), as8(u), as8(v)


def audio(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = np.arange(1920) + 1920 * k
    left = 8000 * np.sin(2 * np.pi * 440 * n / 48000)
    right = 6000 * np.sin(2 * np.pi * 660 * n / 48000)
    pcm = np.stack([left, right], axis=1) + rng.normal(0, 200, (1920, 2))
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)


def main() -> None:
    from tcforge_tpu.io.dvenc import DVEncoder, inject_audio
    enc = DVEncoder()
    with open(HERE / "pal.dv", "wb") as f:
        for k in range(2):
            y, u, v = frame(576, 720, 288, 360, k, 100 + k)
            f.write(inject_audio(enc.encode(y, u, v), audio(k, 200 + k)))
    with open(HERE / "ntsc.dv", "wb") as f:
        for k in range(2):
            y, u, v = frame(480, 720, 480, 180, k, 300 + k)
            f.write(enc.encode(y, u, v))


if __name__ == "__main__":
    main()
