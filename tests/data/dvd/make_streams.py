#!/usr/bin/env python3
"""Write the DVD rip fixtures that the port's tests and ``chip_smoke.py``
read: a decrypted ``VIDEO_TS`` title with an AC-3 track, small program
streams with each audio kind a DVD carries, and subtitles.  The card's
machine has no JAX, so they are files; each is pinned by SHA-256 in
``tests/test_torch_dvd_audio.py`` (``FIXTURES``).

    JAX_PLATFORMS=cpu python tests/data/dvd/make_streams.py

The JAX package's CLI encodes them (``-y mpeg2,<audio>,mpg``) with its
in-tree audio encoders (``io/a52enc.py``, ``io/mp2enc.py``) and the
FFmpeg bridge off, so that a machine without FFmpeg writes the same
bytes.  The program streams are then cut into 2048-byte DVD sectors:
each pack is padded with a padding packet (stream 0xBE) and the end code
dropped, as on a disc.

- ``VIDEO_TS/``: title 1 of a one-title disc.  NTSC DVD video, 720x480
  at 29.97 fps, 28 frames, MPEG-2 MP@ML frame pictures, GOP N=15 M=3,
  rate control toward 1600 kbit/s (the JAX bench's cfg8 encoder
  settings at a DVD's lower rate; the file holds 1742 kbit/s of video), with a 48 kHz stereo AC-3 track at
  192 kbit/s.  Its sectors are split over ``VTS_01_1.VOB`` and
  ``VTS_01_2.VOB`` at the sector where its second GOP starts (a split
  inside a picture gives the JAX package output that differs from run
  to run); ``VIDEO_TS.IFO`` and ``VTS_01_0.IFO`` (the byte
  layout of ``make_vmg`` and ``make_vts_ifo`` in
  ``tests/test_dvd_ifo.py``) give it two chapters, the second from the
  sector that holds its second GOP's sequence header;
- ``lpcm.vob``, ``mp2.vob``, ``ac3.vob``: 64x48, 12 frames (LPCM 4), N=6 M=3,
  with a 48 kHz stereo track of DVD LPCM, MPEG-1 Layer II at 192 kbit/s
  or AC-3 at 192 kbit/s; ``ac3x2.vob``: ``ac3.vob`` with a second AC-3
  track (sub-stream 0x81, another signal) after each packet of the
  first;
- ``small.spu``: three raw subpicture units for a 64x48 frame;
  ``small.idx`` / ``small.sub``: a VobSub pair of three units for 64x48
  (two languages, the second unit forced); ``title.idx`` /
  ``title.sub``: a VobSub pair of three units for the 720x480 title.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import struct
import sys
import wave
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent.parent
sys.path.insert(0, str(REPO))

SECTOR = 2048
MUX_CHUNK = 1990        # video and audio payload a PES: packs fit a sector
TITLE = dict(w=720, h=480, frames=28, seed=71)
SMALL = dict(w=64, h=48, frames=12, seed=72)
LPCM_FRAMES = 4         # 48 kHz stereo LPCM is 192 KB a second
TITLE_OPTS = "gop_n=15:gop_m=3:rc=1:bitrate=1600"
SMALL_OPTS = "gop_n=6:gop_m=3"


def _mpeg2_streams():
    spec = importlib.util.spec_from_file_location(
        "mpeg2_streams", HERE.parent / "mpeg2" / "make_streams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def title_y4m(path, width, height, frames, seed):
    """The title's picture: ``clip_y4m``'s moving gradients and blocks,
    the blocks textured in 8x8 cells (a programme's detail at DVD
    width, where per-pixel noise would take several times the rate)."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cells = rng.integers(40, 220, (height // 24, width // 32))
    tex = np.kron(cells, np.ones((8, 8)))
    hdr = Y4MHeader(width=width, height=height, fps_num=30000,
                    fps_den=1001, interlacing="t")
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


def write_wav(path, seconds: float, seed: int, rate: int = 48000):
    """Stereo 16-bit: two tones that glide, with a little noise."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    left = 9000 * np.sin(2 * np.pi * (440 + 60 * t) * t)
    right = 7000 * np.sin(2 * np.pi * (660 - 90 * t) * t + 0.5)
    pcm = np.stack([left, right], 1) + rng.normal(0, 300, (n, 2))
    pcm = np.clip(np.round(pcm), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def encode(y4m, wav, out, opts, audio):
    """The JAX CLI: ``y4m`` and ``wav`` into a program stream, audio by
    the in-tree encoder ``audio`` (``raw`` writes LPCM), a frame at a
    time, so that each frame's audio follows it in the stream."""
    from tcforge_tpu.cli import main
    aenc = "raw" if audio == "raw" else f"{audio}=bitrate=192"
    rc = main(["-i", str(y4m), "-p", str(wav), "-o", str(out),
               "-y", f"mpeg2,{aenc},mpg=chunk={MUX_CHUNK}", "-F", opts,
               "--batch", "1", "--mesh", "off", "-q", "--progress_off"])
    if rc != 0:
        raise SystemExit(f"encoding {out} failed: {rc}")


def packs(ps: bytes):
    """The program stream's packs, each with its packets, in order (the
    end code dropped)."""
    out = []
    pos = 0
    while pos + 4 <= len(ps):
        assert ps[pos:pos + 3] == b"\x00\x00\x01", pos
        code = ps[pos + 3]
        if code == 0xB9:
            break
        if code == 0xBA:
            stuff = ps[pos + 13] & 7
            out.append(bytearray(ps[pos:pos + 14 + stuff]))
            pos += 14 + stuff
            continue
        size = 6 + struct.unpack(">H", ps[pos + 4:pos + 6])[0]
        out[-1] += ps[pos:pos + size]
        pos += size
    return out


def packets(ps: bytes):
    """The program stream's packets after the pack headers, in order:
    (stream id, the bytes after the PES header); the system header as
    (0xBB, the whole header)."""
    for pack in packs(ps):
        pos = 14 + (pack[13] & 7)
        while pos < len(pack):
            sid = pack[pos + 3]
            size = 6 + struct.unpack(">H", pack[pos + 4:pos + 6])[0]
            if sid == 0xBB:
                yield sid, bytes(pack[pos:pos + size])
            else:
                yield sid, bytes(pack[pos + 9 + pack[pos + 8]:pos + size])
            pos += size


def _pes(sid: int, payload: bytes, stuffing: int = 0) -> bytes:
    return (b"\x00\x00\x01" + bytes([sid])
            + struct.pack(">H", len(payload) + 3 + stuffing)
            + bytes([0x80, 0x00, stuffing]) + b"\xff" * stuffing + payload)


def sectors(ps: bytes) -> bytes:
    """The streams of ``ps`` in 2048-byte DVD sectors: each pack one
    packet of one stream, filled before it is written, in the order the
    data came (a last short packet of a stream padded with a padding
    packet, stream 0xBE); a GOP's video starts a sector.  An LPCM packet keeps its 7-byte header (the
    frame number counting on) and whole sample pairs; an AC-3 packet its
    4-byte one."""
    pack_header = packs(ps)[0][:14]
    out = bytearray()
    sys_hdr = b""
    queues = {}
    heads = {}
    lpcm_frame = [0]

    def room(key) -> int:
        sid, sub = key
        cap = SECTOR - 14 - len(sys_hdr) - 9
        if sub is None:
            return cap
        if sub >= 0xA0:
            return (cap - 7) // 4 * 4
        return cap - 4

    def emit(key, data: bytes) -> None:
        nonlocal sys_hdr
        sid, sub = key
        if sub is None:
            body = data
        elif sub >= 0xA0:
            lpcm_frame[0] += 1
            h = heads[key]
            body = bytes([sub, 1, 0, 4, lpcm_frame[0] & 0x1F, h[5],
                          h[6]]) + data
        else:
            body = bytes([sub, 1, 0, 1]) + data
        pad = SECTOR - 14 - len(sys_hdr) - 9 - len(body)
        # a gap too short for a padding packet is PES header stuffing
        stuffing = pad if pad < 6 else 0
        pack = bytearray(pack_header) + sys_hdr + _pes(sid, body, stuffing)
        sys_hdr = b""
        pad -= stuffing
        if pad:
            pack += b"\x00\x00\x01\xbe" + struct.pack(">H", pad - 6) \
                + b"\xff" * (pad - 6)
        out.extend(pack)

    def drain(key, final: bool) -> None:
        q = queues[key]
        while len(q) >= room(key) or (final and q):
            n = min(len(q), room(key))
            emit(key, bytes(q[:n]))
            del q[:n]

    for sid, data in packets(ps):
        if sid == 0xBB:
            sys_hdr = data
            continue
        if sid == 0xBE:
            continue
        if sid == 0xBD:
            key = (sid, data[0])
            heads.setdefault(key, data[:7])
            data = data[7:] if data[0] >= 0xA0 else data[4:]
        else:
            key = (sid, None)
        q = queues.setdefault(key, bytearray())
        gop = data.find(b"\x00\x00\x01\xb3") if sid == 0xE0 else -1
        if gop >= 0 and (q or gop):
            # a sequence header starts a new sector, as a VOBU's video
            # does on a disc
            q.extend(data[:gop])
            drain(key, True)
            data = data[gop:]
        q.extend(data)
        drain(key, False)
    for key in queues:
        drain(key, True)
    return bytes(out)


def second_track(ps: bytes, wav, seed: int) -> bytes:
    """``ps`` with a second AC-3 track (sub-stream 0x81): after each
    pack of the first, a pack of as many bytes of another signal."""
    from tcforge_tpu.io.a52enc import NativeAc3Encoder
    write_wav(wav, 1.2, seed)
    with wave.open(str(wav)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    enc = NativeAc3Encoder(48000, 2, 192000)
    enc.feed(pcm.reshape(-1, 2)[:, ::-1])
    enc.flush()
    stream = b"".join(enc.read_packets())
    out = bytearray()
    at = 0
    for pack in packs(ps):
        out += pack
        head = pack.find(b"\x00\x00\x01\xbd")
        if head < 0 or pack[head + 9 + pack[head + 8]] != 0x80:
            continue
        n = len(pack) - head - 9 - pack[head + 8] - 4
        part = stream[at:at + n]
        at += n
        if part:
            pes = bytes([0x80, 0x00, 0, 0x81, 1, 0, 0]) + part
            out += pack[:14] + b"\x00\x00\x01\xbd" \
                + struct.pack(">H", len(pes)) + pes
    return bytes(out)


# ------------------------------------------------------------------ #
# IFOs: the byte layout of tests/test_dvd_ifo.py's make_vmg and
# make_vts_ifo

def make_vmg(titles) -> bytes:
    blob = bytearray(4 * SECTOR)
    blob[0:12] = b"DVDVIDEO-VMG"
    struct.pack_into(">I", blob, 0xC4, 1)
    base = SECTOR
    struct.pack_into(">H", blob, base, len(titles))
    struct.pack_into(">I", blob, base + 4, 8 + 12 * len(titles) - 1)
    pos = base + 8
    for vts, ttn, chapters, angles in titles:
        blob[pos] = 0x38
        blob[pos + 1] = angles
        struct.pack_into(">H", blob, pos + 2, chapters)
        blob[pos + 6] = vts
        blob[pos + 7] = ttn
        struct.pack_into(">I", blob, pos + 8, 100)
        pos += 12
    return bytes(blob)


def make_vts_ifo(pgc_cells, ptts) -> bytes:
    blob = bytearray(16 * SECTOR)
    blob[0:12] = b"DVDVIDEO-VTS"
    struct.pack_into(">I", blob, 0xC8, 1)
    struct.pack_into(">I", blob, 0xCC, 2)
    base = SECTOR
    ttns = sorted(ptts)
    struct.pack_into(">H", blob, base, len(ttns))
    off = 8 + 4 * len(ttns)
    offsets = []
    body = bytearray()
    for ttn in ttns:
        offsets.append(off + len(body))
        for pgcn, pgn in ptts[ttn]:
            body += struct.pack(">HH", pgcn, pgn)
    struct.pack_into(">I", blob, base + 4, off + len(body) - 1)
    for i, o in enumerate(offsets):
        struct.pack_into(">I", blob, base + 8 + 4 * i, o)
    blob[base + off:base + off + len(body)] = body
    g = 2 * SECTOR
    pgcns = sorted(pgc_cells)
    struct.pack_into(">H", blob, g, len(pgcns))
    pgc_off = 8 + 8 * len(pgcns)
    for i, pgcn in enumerate(pgcns):
        program_map, cells = pgc_cells[pgcn]
        struct.pack_into(">I", blob, g + 8 + 8 * i + 4, pgc_off)
        p = g + pgc_off
        blob[p + 2] = len(program_map)
        blob[p + 3] = len(cells)
        pm_off = 0xEC
        cp_off = pm_off + len(program_map)
        struct.pack_into(">H", blob, p + 0xE6, pm_off)
        struct.pack_into(">H", blob, p + 0xE8, cp_off)
        for j, cell in enumerate(program_map):
            blob[p + pm_off + j] = cell
        for c, (first, last) in enumerate(cells):
            e = p + cp_off + 24 * c
            struct.pack_into(">I", blob, e + 8, first)
            struct.pack_into(">I", blob, e + 20, last)
        pgc_off += cp_off + 24 * len(cells)
    return bytes(blob)


def second_gop_sector(vob: bytes) -> int:
    """The sector whose pack carries the second sequence header."""
    seen = 0
    for k in range(len(vob) // SECTOR):
        if b"\x00\x00\x01\xb3" in vob[k * SECTOR:(k + 1) * SECTOR]:
            seen += 1
            if seen == 2:
                return k
    raise SystemExit("the title has one GOP")


# ------------------------------------------------------------------ #
# subtitles

def _bitmap(rng, h, w):
    """A 2-bit subtitle bitmap: an outlined bar of text-like runs."""
    bm = np.zeros((h, w), np.uint8)
    bm[1:h - 1, 1:w - 1] = 1
    cells = rng.random(((h - 4) // 4, (w - 4) // 4))
    glyphs = np.where(cells < 0.35, 2, np.where(cells < 0.5, 3, 1))
    ink = np.repeat(np.repeat(glyphs, 4, 0), 4, 1)
    bm[2:2 + ink.shape[0], 2:2 + ink.shape[1]] = ink
    return bm


def spu_units(rng, frame_w, frame_h, sizes):
    from tcforge_tpu.io import spu
    units = []
    for k, (w, h) in enumerate(sizes):
        x = (frame_w - w) // 2 + 3 * k
        y = frame_h - h - 2 - 2 * k
        units.append(spu.encode_spu(
            _bitmap(rng, h, w), x, y, palette=(0, 1 + k, 2 + 2 * k, 9),
            alpha=(0, 15, 11 - k, 15 - 4 * k), duration_ticks=12 + 9 * k))
    return units


def forced(unit: bytes) -> bytes:
    """The unit with a forced-display command in its first control
    sequence (the FORCE command before START)."""
    total, ctrl = struct.unpack(">HH", unit[:4])
    start = ctrl + 4 + 18      # after PALETTE, ALPHA, COORDS, RLE_OFFSETS
    assert unit[start] == 0x01
    body = unit[:start] + b"\x00" + unit[start:]
    # the second sequence's offset moves by one byte
    seq1 = struct.unpack(">H", unit[ctrl + 2:ctrl + 4])[0] + 1
    body = bytearray(body)
    struct.pack_into(">HH", body, 0, total + 1, ctrl)
    struct.pack_into(">H", body, ctrl + 2, seq1)
    struct.pack_into(">H", body, seq1 + 2, seq1)
    return bytes(body)


def write_vobsub(base: Path, frame_w, frame_h, tracks, times_ms):
    """``base``.idx and ``base``.sub: each track's units as bare
    private-stream-1 packets (sub-stream 0x20 + track), the .idx keyed
    by their byte offsets."""
    sub = bytearray()
    lines = ["# VobSub index file, v7 (do not modify this line!)",
             f"size: {frame_w}x{frame_h}",
             "palette: " + ", ".join(
                 f"{(17 * i) & 255:02x}{(40 + 13 * i) & 255:02x}"
                 f"{(200 - 11 * i) & 255:02x}" for i in range(16))]
    for track, units in enumerate(tracks):
        lines.append(f"id: {'en' if track == 0 else 'fr'}, index: {track}")
        for unit, ms in zip(units, times_ms):
            off = len(sub)
            payload = bytes([0x20 + track]) + unit
            sub += b"\x00\x00\x01\xbd" + struct.pack(
                ">H", len(payload) + 8) + bytes([0x81, 0x80, 5]) \
                + bytes([0x21, 0, 1, 0, 1]) + payload
            hh, rest = divmod(ms, 3600000)
            mm, rest = divmod(rest, 60000)
            ss, msec = divmod(rest, 1000)
            lines.append(f"timestamp: {hh:02d}:{mm:02d}:{ss:02d}:{msec:03d}"
                         f", filepos: {off:09x}")
    base.with_suffix(".idx").write_text("\n".join(lines) + "\n")
    base.with_suffix(".sub").write_bytes(bytes(sub))


def main() -> None:
    import tcforge_tpu.native.av as av
    av.available = lambda: False        # the in-tree encoders
    os.environ["TCFORGE_NATIVE_AC3ENC"] = "1"
    os.environ["TCFORGE_NATIVE_MP2ENC"] = "1"
    import tempfile
    clip_y4m = _mpeg2_streams().clip_y4m
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the title
        src, wav, ps = tmp / "title.y4m", tmp / "title.wav", tmp / "t.vob"
        title_y4m(src, TITLE["w"], TITLE["h"], TITLE["frames"],
                  TITLE["seed"])
        write_wav(wav, TITLE["frames"] / 29.97 + 0.05, TITLE["seed"])
        encode(src, wav, ps, TITLE_OPTS, "ac3enc")
        vob = sectors(ps.read_bytes())
        nsec = len(vob) // SECTOR
        ch2 = second_gop_sector(vob)
        split = ch2
        ts = HERE / "VIDEO_TS"
        ts.mkdir(exist_ok=True)
        (ts / "VTS_01_1.VOB").write_bytes(vob[:split * SECTOR])
        (ts / "VTS_01_2.VOB").write_bytes(vob[split * SECTOR:])
        # the tables end inside the second and third sectors: the
        # blank sectors after them are not written
        (ts / "VIDEO_TS.IFO").write_bytes(
            make_vmg([(1, 1, 2, 1)])[:2 * SECTOR])
        (ts / "VTS_01_0.IFO").write_bytes(make_vts_ifo(
            {1: ([1, 2], [(0, ch2 - 1), (ch2, nsec - 1)])},
            {1: [(1, 1), (1, 2)]})[:3 * SECTOR])
        # the small program streams
        src, wav = tmp / "small.y4m", tmp / "small.wav"
        clip_y4m(src, SMALL["w"], SMALL["h"], SMALL["frames"],
                 SMALL["seed"])
        write_wav(wav, SMALL["frames"] / 29.97 + 0.05, SMALL["seed"])
        short = tmp / "short.y4m"
        clip_y4m(short, SMALL["w"], SMALL["h"], LPCM_FRAMES, SMALL["seed"])
        for name, audio in (("lpcm", "raw"), ("mp2", "mp2enc"),
                            ("ac3", "ac3enc")):
            out = tmp / f"{name}.vob"
            encode(short if audio == "raw" else src, wav, out, SMALL_OPTS,
                   audio)
            (HERE / f"{name}.vob").write_bytes(sectors(out.read_bytes()))
        two = second_track((tmp / "ac3.vob").read_bytes(), tmp / "b.wav",
                           SMALL["seed"] + 1)
        (HERE / "ac3x2.vob").write_bytes(sectors(two))
    # subtitles
    rng = np.random.default_rng(73)
    from tcforge_tpu.io import spu
    small = spu_units(rng, 64, 48, [(40, 12), (28, 9), (50, 14)])
    (HERE / "small.spu").write_bytes(b"".join(small))
    other = spu_units(rng, 64, 48, [(36, 10), (30, 8), (44, 12)])
    write_vobsub(HERE / "small", 64, 48,
                 [[small[0], forced(small[1]), small[2]], other],
                 [0, 250, 480])
    title = spu_units(rng, 720, 480, [(360, 44), (300, 40), (420, 48)])
    write_vobsub(HERE / "title", 720, 480, [title], [33, 300, 634])
    for unit in small + [forced(small[1])] + title:
        spu.decode_spu(unit)            # every unit parses
    for path in sorted(p for p in HERE.rglob("*")
                       if p.is_file() and p.suffix != ".py"):
        print(f"{path.relative_to(HERE)} {path.stat().st_size} "
              f"{hashlib.sha256(path.read_bytes()).hexdigest()}")


if __name__ == "__main__":
    main()
