#!/usr/bin/env python3
"""Write the Motion-JPEG and QuickTime files that the port's JPEG tests
and ``chip_smoke.py`` read.  The card's machine has no JAX and no PIL,
so they are files; each is pinned by SHA-256 in
``tests/test_torch_mjpeg.py`` (``FIXTURES``).

    JAX_PLATFORMS=cpu python tests/data/mjpeg/make_streams.py

- ``legacy.avi``: the README's legacy AVI, written by the JAX CLI with
  the README's own command (``-y movjpeg,lame,avi -F MJPG``, movjpeg at
  its default quality of 90, 4:2:0): 8 frames of
  ``tests/data/mpeg2/dvd.vob`` (NTSC DVD video) zoomed to 640x480, the
  4:3 square-pixel size of a camcorder's VGA movie mode, at 29.97 fps,
  with a 48 kHz stereo WAV from ``chip_smoke.write_test_wav`` as MP3
  (libmp3lame through the JAX package's FFmpeg bridge, 128 kbit/s);
- ``small.avi``: the same command on a seeded 64x48 clip, 6 frames;
- ``mixed.avi``: 48x32, one chunk of each kind: PIL's 4:4:4, 4:2:2 and
  4:2:0, ``encode_baseline``'s 4:4:0 (h1v2), 4:1:1 (h4v1), gray, three
  non-interleaved scans and a 16-bit quantization table, PIL's Adobe
  RGB (``keep_rgb``), restart intervals by blocks and by rows;
- ``odd.avi`` (13x7, 4:2:0), ``narrow.avi`` (4x9: chroma 2 wide, 4:2:0
  and 4:2:2 chunks) and ``dot.avi`` (1x1, 4:2:0 and 4:4:0);
- ``fields.avi``: 64x48 in the header, each chunk two 64x24 field
  images with an ``AVI1`` APP0 marker and no DHT (a capture card's
  interlaced MJPEG), trailing bytes after the second;
- ``nodht.avi``: 64x48 4:2:2 chunks with their DHT stripped (a
  camera's MJPEG), with restart intervals;
- ``mp2.avi`` and ``ac3.avi``: ``small.avi``'s video with an MPEG-1
  Layer II track (tag 0x50, 192 kbit/s) and an AC-3 track (tag 0x2000,
  192 kbit/s) of 48 kHz stereo, from the JAX package's in-tree encoders
  (``io/mpaenc.py``, ``io/a52enc.py``);
- ``jpeg.mov``: a seeded 64x48 clip with a 48 kHz stereo WAV through the
  JAX CLI's ``-y movjpeg,raw,mov`` (photo-JPEG and a ``sowt`` track);
- ``mjpa.mov``: ``fields.avi``'s chunks as ``mjpa`` samples, written by
  the JAX ``io/mov.MovWriter``.

``encode_baseline`` (numpy: a float DCT, the Annex K tables) writes the
samplings and scan layouts that PIL's encoder does not; the tests use it
too.  The output is the same bytes on every run.
"""

from __future__ import annotations

import io
import os
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent.parent
sys.path.insert(0, str(REPO))

FPS = 30000 / 1001
LEGACY_FRAMES = 8
SMALL = dict(w=64, h=48, frames=6, seed=81)

# ITU T.81 Annex K.1: the luminance and chrominance quantization tables
# in natural order
_QL = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QC = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
                99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99,
                99, 99] + [99] * 32)


def _quality(table: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of a base table."""
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * s + 50) // 100, 1, 255)


def _codes(bits, vals):
    """The canonical Huffman code of each symbol: {symbol: (code, len)}."""
    out, code = {}, 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def align(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _dct_matrix() -> np.ndarray:
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def encode_baseline(planes, sampling, width: int, height: int,
                    quality: int = 80, restart: int = 0,
                    separate: bool = False, dht: bool = True,
                    qt16: bool = False, app0: bytes = b"JFIF\x00\x01\x01"
                    b"\x00\x00\x01\x00\x01\x00\x00", ids=None) -> bytes:
    """A baseline JPEG of the component ``planes`` (uint8, each
    ``ceil(dim * samp / max_samp)`` of the image's ``width`` x
    ``height``) with sampling factors ``sampling`` ((h, v) each): the
    standard tables of Annex K, component 0 on the luminance tables;
    ``restart`` MCUs a restart interval, ``separate`` one scan a
    component, ``dht`` False leaves the Huffman tables out (a decoder
    takes the standard ones), ``qt16`` writes 16-bit quantization
    tables, ``app0`` the APP0 payload (empty: none)."""
    from tcforge_tpu_torch.io.jpeg import NATURAL, STD_TABLES, geometry
    ids = ids or list(range(1, len(planes) + 1))
    geom = geometry(width, height, 0, list(sampling))
    qts = [_quality(_QL, quality), _quality(_QC, quality)]
    dct = _dct_matrix()
    coefs = []
    for plane, c in zip(planes, geom.comps):
        p = np.asarray(plane, np.float64)
        assert p.shape == (c.dh, c.dw), (p.shape, c)
        p = np.pad(p, ((0, 8 * c.bh - c.dh), (0, 8 * c.bw - c.dw)),
                   mode="edge") - 128
        blocks = p.reshape(c.bh, 8, c.bw, 8).transpose(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        q = qts[min(len(coefs), 1)].reshape(8, 8)
        coefs.append(np.rint(f / q).astype(np.int64).reshape(
            c.bh, c.bw, 64)[:, :, NATURAL])            # zigzag order
    codes = {(k, t): _codes(*STD_TABLES[(k, t)]) for k in ("dc", "ac")
             for t in (0, 1)}

    def segment(code: int, payload: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload

    out = bytearray(b"\xff\xd8")
    if app0:
        out += segment(0xE0, app0)
    for t, q in enumerate(qts[:min(2, len(planes))]):
        zz = q[NATURAL]
        out += segment(0xDB, bytes([(16 if qt16 else 0) | t])
                       + (zz.astype(">u2").tobytes() if qt16
                          else zz.astype(np.uint8).tobytes()))
    out += segment(0xC0, struct.pack(">BHHB", 8, height, width,
                                     len(planes)) + b"".join(
        bytes([ids[i], (h << 4) | v, min(i, 1)])
        for i, (h, v) in enumerate(sampling)))
    if dht:
        for (kind, t), (bits, vals) in STD_TABLES.items():
            if t < min(2, len(planes)):
                out += segment(0xC4, bytes([(kind == "ac") << 4 | t])
                               + bytes(bits) + bytes(vals))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    scans = ([[i] for i in range(len(planes))] if separate or
             len(planes) == 1 else [list(range(len(planes)))])
    for scan in scans:
        out += segment(0xDA, bytes([len(scan)]) + b"".join(
            bytes([ids[i], (min(i, 1) << 4) | min(i, 1)]) for i in scan)
            + b"\x00\x3f\x00")
        if len(scan) == 1:
            c = geom.comps[scan[0]]
            mcus = [[(scan[0], by, bx)] for by in range(c.hib)
                    for bx in range(c.wib)]
        else:
            mcus = [[(i, my * geom.comps[i].v + yy, mx * geom.comps[i].h
                      + xx) for i in scan for yy in range(geom.comps[i].v)
                     for xx in range(geom.comps[i].h)]
                    for my in range(geom.mcuy) for mx in range(geom.mcux)]
        w = _Bits()
        pred = [0] * len(planes)
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                w.align()
                w.out += bytes([0xFF, 0xD0 + ((m // restart - 1) & 7)])
                pred = [0] * len(planes)
            for i, by, bx in mcu:
                t = min(i, 1)
                zz = coefs[i][by, bx]
                size, bits = _magnitude(int(zz[0]) - pred[i])
                pred[i] = int(zz[0])
                w.put(*codes[("dc", t)][size])
                w.put(bits, size)
                run = 0
                for k in range(1, 64):
                    v = int(zz[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        w.put(*codes[("ac", t)][0xF0])
                        run -= 16
                    size, bits = _magnitude(v)
                    w.put(*codes[("ac", t)][(run << 4) | size])
                    w.put(bits, size)
                    run = 0
                if run:
                    w.put(*codes[("ac", t)][0x00])
        w.align()
        out += w.out
    return bytes(out + b"\xff\xd9")


def test_rgb(width: int, height: int, seed: int) -> np.ndarray:
    """Seeded RGB content: gradients and a moving square, with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    base = np.stack([(xx * 7 + yy * 3) % 256, (xx * 2 + yy * 9) % 256,
                     128 + 100 * np.sin(xx / 5 + yy / 7)], -1)
    base[height // 4:height // 2, width // 3:width // 2] = (240, 20, 60)
    return np.clip(base + rng.normal(0, 18, base.shape), 0,
                   255).astype(np.uint8)


def ycc_planes(rgb: np.ndarray, sampling):
    """JFIF YCbCr planes of ``rgb`` at ``sampling`` (box-averaged)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    full = [0.299 * r + 0.587 * g + 0.114 * b,
            128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
    height, width = rgb.shape[:2]
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    out = []
    for plane, (h, v) in zip(full, sampling):
        fh, fv = max_h // h, max_v // v
        dw, dh = -(-width * h // max_h), -(-height * v // max_v)
        p = np.pad(plane, ((0, dh * fv - height), (0, dw * fh - width)),
                   mode="edge")
        p = p.reshape(dh, fv, dw, fh).mean(axis=(1, 3))
        out.append(np.clip(np.rint(p), 0, 255).astype(np.uint8))
    return out


def pil_jpeg(rgb: np.ndarray, **opts) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **opts)
    return buf.getvalue()


def strip_dht(data: bytes) -> bytes:
    """``data`` without its DHT segments."""
    out, pos = bytearray(data[:2]), 2
    while True:
        code = data[pos + 1]
        if code == 0xDA:
            return bytes(out + data[pos:])
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if code != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length


def avi1_app0(data: bytes, field: int) -> bytes:
    """``data`` with its APP0 made an ``AVI1`` marker of field
    ``field`` (1 or 2), as capture cards write interlaced MJPEG."""
    assert data[2:4] == b"\xff\xe0"
    length = struct.unpack_from(">H", data, 4)[0]
    app = b"AVI1" + bytes([field, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    return (data[:2] + b"\xff\xe0" + struct.pack(">H", len(app) + 2) + app
            + data[4 + length:])


def mixed_chunks(width: int = 48, height: int = 32, seed: int = 91):
    """``mixed.avi``'s chunks: (name, JPEG bytes)."""
    rgb = [test_rgb(width, height, seed + k) for k in range(12)]
    gray = [np.rint(ycc_planes(rgb[5], [(1, 1)] * 3)[0]).astype(np.uint8)]
    return [
        ("444", pil_jpeg(rgb[0], quality=85, subsampling=0)),
        ("422", pil_jpeg(rgb[1], quality=75, subsampling=1)),
        ("420", pil_jpeg(rgb[2], quality=95, subsampling=2)),
        ("440", encode_baseline(ycc_planes(rgb[3], [(1, 2), (1, 1), (1, 1)]),
                                [(1, 2), (1, 1), (1, 1)], width, height)),
        ("411", encode_baseline(ycc_planes(rgb[4], [(4, 1), (1, 1), (1, 1)]),
                                [(4, 1), (1, 1), (1, 1)], width, height,
                                quality=70)),
        ("gray", encode_baseline(gray, [(1, 1)], width, height)),
        ("separate_qt16", encode_baseline(
            ycc_planes(rgb[6], [(2, 2), (1, 1), (1, 1)]),
            [(2, 2), (1, 1), (1, 1)], width, height, separate=True,
            qt16=True, quality=60)),
        ("adobe_rgb", pil_jpeg(rgb[7], quality=80, keep_rgb=True)),
        ("restart_blocks", pil_jpeg(rgb[8], quality=80, subsampling=2,
                                    restart_marker_blocks=3)),
        ("restart_rows", pil_jpeg(rgb[9], quality=80, subsampling=1,
                                  restart_marker_rows=1)),
        ("rgb_ids", encode_baseline(
            [rgb[10][..., i] for i in range(3)], [(1, 1)] * 3, width,
            height, app0=b"", ids=[82, 71, 66])),
        ("444_2x1_mcu", encode_baseline(
            ycc_planes(rgb[11], [(2, 1), (2, 1), (2, 1)]),
            [(2, 1), (2, 1), (2, 1)], width, height, restart=2)),
    ]


def odd_chunks():
    """``odd.avi``, ``narrow.avi`` and ``dot.avi``'s chunks."""
    out = {}
    out["odd.avi"] = (13, 7, [pil_jpeg(test_rgb(13, 7, 101 + k), quality=q,
                                       subsampling=2)
                              for k, q in enumerate((90, 50))])
    rgb = test_rgb(4, 9, 103)
    out["narrow.avi"] = (4, 9, [
        pil_jpeg(rgb, quality=90, subsampling=2),
        pil_jpeg(rgb, quality=90, subsampling=1),
        encode_baseline(ycc_planes(rgb, [(1, 2), (1, 1), (1, 1)]),
                        [(1, 2), (1, 1), (1, 1)], 4, 9)])
    dot = test_rgb(1, 1, 104)
    out["dot.avi"] = (1, 1, [
        pil_jpeg(dot, quality=90, subsampling=2),
        encode_baseline(ycc_planes(dot, [(1, 2), (1, 1), (1, 1)]),
                        [(1, 2), (1, 1), (1, 1)], 1, 1)])
    return out


def fields_chunks(frames: int = 3, seed: int = 105):
    out = []
    for k in range(frames):
        rgb = test_rgb(64, 48, seed + k)
        top, bottom = (strip_dht(avi1_app0(pil_jpeg(
            np.ascontiguousarray(rgb[f::2]), quality=85, subsampling=1),
            f + 1)) for f in (0, 1))
        out.append(top + bottom + b"\x00" * 7)
    return out


def nodht_chunks(frames: int = 3, seed: int = 109):
    return [strip_dht(pil_jpeg(test_rgb(64, 48, seed + k), quality=80,
                               subsampling=1, restart_marker_rows=2))
            for k in range(frames)]


def _write_avi(path: Path, width: int, height: int, chunks, audio=None,
               fps: float = 25.0) -> None:
    """An MJPG AVI of ``chunks``; ``audio``: (AviAudioStream, payloads),
    one payload after each frame, the rest at the end."""
    from tcforge_tpu.io.avi import AviVideoStream, AviWriter
    stream, payloads = audio if audio is not None else (None, [])
    w = AviWriter(str(path), AviVideoStream(fourcc="MJPG", width=width,
                                            height=height, fps=fps),
                  [stream] if stream is not None else [])
    per = -(-len(payloads) // max(1, len(chunks)))
    for i, c in enumerate(chunks):
        w.write_video_frame(c)
        for p in payloads[i * per:(i + 1) * per]:
            w.write_audio(p)
    w.close()


def _jax_cli(argv) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tcforge_tpu.cli import main
    rc = main([*argv, "--mesh", "off", "-q", "--progress_off"])
    assert rc == 0, (argv, rc)


def _small_clip(directory: Path) -> Path:
    import chip_smoke
    src = directory / "small.y4m"
    chip_smoke.write_motion_y4m(src, SMALL["w"], SMALL["h"],
                                SMALL["frames"], seed=SMALL["seed"])
    return src


def _audio(kind: str, seconds: float, seed: int):
    """A compressed track of the seeded WAV: (AviAudioStream, frames)."""
    from tcforge_tpu.io.a52enc import NativeAc3Encoder
    from tcforge_tpu.io.avi import AviAudioStream
    from tcforge_tpu.io.mpaenc import NativeAudioEncoder
    import chip_smoke
    from tcforge_tpu.io.wav import WavReader
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "a.wav"
        chip_smoke.write_test_wav(wav, int(48000 * seconds), seed=seed)
        with WavReader(str(wav)) as r:
            pcm = r.read_samples(1 << 30)
    enc = (NativeAc3Encoder if kind == "ac3" else NativeAudioEncoder)(
        48000, 2, 192000)
    enc.set_framed(True)
    enc.feed(pcm)
    enc.flush()
    frames = enc.read_packets()
    tag = 0x2000 if kind == "ac3" else 0x50
    return AviAudioStream(format_tag=tag, channels=2, rate=48000, bits=0,
                          byte_rate=192000 // 8), frames


def main() -> None:
    from tcforge_tpu.io.avi import AviReader
    from tcforge_tpu.io.mov import MovWriter
    import chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = tmp / "in.wav"
        chip_smoke.write_test_wav(wav, 48000, seed=83)
        _jax_cli(["-i", str(REPO / "tests" / "data" / "mpeg2" / "dvd.vob"),
                  "-x", "mpeg", "-Z", "640x480", "-p", str(wav), "-y",
                  "movjpeg,lame,avi", "-F", "MJPG", "--max_frames",
                  str(LEGACY_FRAMES), "-o", str(HERE / "legacy.avi")])
        small = _small_clip(tmp)
        _jax_cli(["-i", str(small), "-p", str(wav), "-y",
                  "movjpeg,lame,avi", "-F", "MJPG", "-o",
                  str(HERE / "small.avi")])
        _jax_cli(["-i", str(small), "-p", str(wav), "-y",
                  "movjpeg,raw,mov", "-o", str(HERE / "jpeg.mov")])
    with AviReader(str(HERE / "small.avi")) as r:
        chunks = [bytes(r.read_video_frame(i)[0])
                  for i in range(r.video_frames)]
    for kind in ("mp2", "ac3"):
        _write_avi(HERE / f"{kind}.avi", SMALL["w"], SMALL["h"], chunks,
                   _audio(kind, len(chunks) / FPS + 0.1, seed=84),
                   fps=FPS)
    _write_avi(HERE / "mixed.avi", 48, 32, [c for _, c in mixed_chunks()])
    for name, (w, h, cs) in odd_chunks().items():
        _write_avi(HERE / name, w, h, cs)
    fields = fields_chunks()
    _write_avi(HERE / "fields.avi", 64, 48, fields)
    _write_avi(HERE / "nodht.avi", 64, 48, nodht_chunks())
    mov = MovWriter(str(HERE / "mjpa.mov"), 64, 48, 25.0, fourcc="mjpa")
    for c in fields:
        mov.write_video_sample(c)
    mov.close()


if __name__ == "__main__":
    main()
    import hashlib
    for p in sorted(HERE.iterdir()):
        if p.suffix in (".avi", ".mov"):
            print(f'    "{p.name}":\n        '
                  f'"{hashlib.sha256(p.read_bytes()).hexdigest()}",')
