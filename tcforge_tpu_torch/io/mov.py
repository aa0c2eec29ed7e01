# Copied from tcforge_tpu/io/mov.py lines 1-339 and 344-404 and 423-546; the reader without its photo-JPEG branch (modules/importers/mov_import.py) and the writer without write_video_frame (the mov multiplexor writes encoded samples)
"""QuickTime/MOV container reader and writer (import_mov.c /
probe_mov.c analogues, self-contained where the reference delegated to
libquicktime).

Reader: walks the atom tree, builds per-track sample tables from
``stsd/stts/stsc/stsz/stco|co64`` and resolves every sample to a file
(offset, size).  Video sample decode covers the uncompressed
quicktime fourccs — ``raw `` (RGB24), ``yv12``/``y420`` (planar
4:2:0), ``2vuy``/``yuv2`` (packed 4:2:2) — plus ``jpeg``/``mjpa``
photo-JPEG via PIL.  Audio covers the classic PCM fourccs ``twos``
(signed BE), ``sowt`` (signed LE) and ``raw `` (unsigned 8-bit).

Writer: emits a single ``mdat`` followed by a ``moov`` with one video
track (and optionally one PCM audio track), the same layout
libquicktime produced for the reference's export path.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

import numpy as np

_be32 = struct.Struct(">I")
_be64 = struct.Struct(">Q")

VIDEO_FOURCCS = ("raw ", "yv12", "y420", "2vuy", "yuv2", "jpeg", "mjpa")
AUDIO_FOURCCS = ("twos", "sowt", "raw ", "lpcm")


# --------------------------------------------------------------------- #
# atom walking


def iter_atoms(f: BinaryIO, start: int, end: int
               ) -> Iterator[Tuple[str, int, int]]:
    """Yield (type, payload_offset, payload_size) for each atom in
    [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        size = _be32.unpack(hdr[:4])[0]
        typ = hdr[4:8].decode("latin-1")
        if size == 1:
            ext = f.read(8)
            if len(ext) < 8:
                return
            size = _be64.unpack(ext)[0]
            payload = pos + 16
        elif size == 0:
            size = end - pos
            payload = pos + 8
        else:
            payload = pos + 8
        if size < 8 and not (size == 0):
            return
        yield typ, payload, pos + size - payload
        pos += size


def _find(f: BinaryIO, start: int, end: int,
          typ: str) -> Optional[Tuple[int, int]]:
    for t, off, sz in iter_atoms(f, start, end):
        if t == typ:
            return off, sz
    return None


# --------------------------------------------------------------------- #
# sample tables


@dataclass
class MovTrack:
    kind: str                        # 'vide' | 'soun'
    fourcc: str
    timescale: int
    duration: int
    # video
    width: int = 0
    height: int = 0
    depth: int = 24
    # audio
    channels: int = 0
    bits: int = 0
    samplerate: int = 0
    # tables
    sample_sizes: Optional[np.ndarray] = None   # per sample, or None
    uniform_size: int = 0
    chunk_offsets: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    stsc: List[Tuple[int, int]] = field(default_factory=list)
    stts: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def n_samples(self) -> int:
        if self.sample_sizes is not None:
            return len(self.sample_sizes)
        total = 0
        for first, spc in self._chunk_runs():
            total += spc
        return total

    def _chunk_runs(self) -> Iterator[Tuple[int, int]]:
        """(chunk_index, samples_per_chunk) for every chunk."""
        nchunks = len(self.chunk_offsets)
        for i, (first, spc) in enumerate(self.stsc):
            last = (self.stsc[i + 1][0] if i + 1 < len(self.stsc)
                    else nchunks + 1)
            for c in range(first, last):
                if c > nchunks:
                    return
                yield c - 1, spc

    def sample_locations(self) -> List[Tuple[int, int]]:
        """Resolve every sample to (file_offset, size)."""
        out: List[Tuple[int, int]] = []
        sizes = self.sample_sizes
        idx = 0
        for chunk, spc in self._chunk_runs():
            off = int(self.chunk_offsets[chunk])
            for _ in range(spc):
                sz = (self.uniform_size if sizes is None
                      else int(sizes[idx]))
                out.append((off, sz))
                off += sz
                idx += 1
                if sizes is not None and idx >= len(sizes):
                    return out
        return out

    @property
    def fps(self) -> float:
        # dominant stts delta
        if not self.stts or self.timescale <= 0:
            return 0.0
        count, delta = max(self.stts, key=lambda cd: cd[0])
        if delta <= 0:
            return 0.0
        return self.timescale / delta


def _parse_stsd(f: BinaryIO, off: int, sz: int, kind: str,
                tr: MovTrack) -> None:
    f.seek(off)
    data = f.read(sz)
    # version/flags (4) + entry count (4)
    nent = _be32.unpack(data[4:8])[0]
    pos = 8
    if nent < 1:
        return
    entsz = _be32.unpack(data[pos:pos + 4])[0]
    tr.fourcc = data[pos + 4:pos + 8].decode("latin-1")
    body = data[pos + 8:pos + entsz]
    if kind == "vide" and len(body) >= 78 - 8:
        # 6 reserved + 2 dataref + 2 version + 2 revision + 4 vendor
        # + 4 temporal q + 4 spatial q
        tr.width = struct.unpack(">H", body[24:26])[0]
        tr.height = struct.unpack(">H", body[26:28])[0]
        if len(body) >= 76:
            tr.depth = struct.unpack(">H", body[74:76])[0]
    elif kind == "soun" and len(body) >= 28:
        version = struct.unpack(">H", body[8:10])[0]
        tr.channels = struct.unpack(">H", body[16:18])[0]
        tr.bits = struct.unpack(">H", body[18:20])[0]
        tr.samplerate = struct.unpack(">H", body[24:26])[0]
        if version >= 1 and len(body) >= 44:
            pass                      # v1 extras not needed for PCM


def _parse_stbl(f: BinaryIO, off: int, sz: int, kind: str,
                tr: MovTrack) -> None:
    for t, o, s in iter_atoms(f, off, off + sz):
        f.seek(o)
        if t == "stsd":
            _parse_stsd(f, o, s, kind, tr)
        elif t == "stts":
            data = f.read(s)
            n = _be32.unpack(data[4:8])[0]
            tr.stts = [struct.unpack(">II", data[8 + 8 * i:16 + 8 * i])
                       for i in range(n)]
        elif t == "stsc":
            data = f.read(s)
            n = _be32.unpack(data[4:8])[0]
            tr.stsc = [struct.unpack(
                ">II", data[8 + 12 * i:16 + 12 * i])
                for i in range(n)]
        elif t == "stsz":
            data = f.read(s)
            uniform = _be32.unpack(data[4:8])[0]
            n = _be32.unpack(data[8:12])[0]
            if uniform:
                tr.uniform_size = uniform
                tr.sample_sizes = None
                tr._stsz_count = n
            else:
                tr.sample_sizes = np.frombuffer(
                    data[12:12 + 4 * n], ">u4").astype(np.int64)
        elif t == "stco":
            data = f.read(s)
            n = _be32.unpack(data[4:8])[0]
            tr.chunk_offsets = np.frombuffer(
                data[8:8 + 4 * n], ">u4").astype(np.int64)
        elif t == "co64":
            data = f.read(s)
            n = _be32.unpack(data[4:8])[0]
            tr.chunk_offsets = np.frombuffer(
                data[8:8 + 8 * n], ">u8").astype(np.int64)


def _parse_trak(f: BinaryIO, off: int, sz: int) -> Optional[MovTrack]:
    mdia = _find(f, off, off + sz, "mdia")
    if not mdia:
        return None
    hdlr = _find(f, mdia[0], mdia[0] + mdia[1], "hdlr")
    mdhd = _find(f, mdia[0], mdia[0] + mdia[1], "mdhd")
    minf = _find(f, mdia[0], mdia[0] + mdia[1], "minf")
    if not (hdlr and mdhd and minf):
        return None
    f.seek(hdlr[0])
    h = f.read(hdlr[1])
    kind = h[8:12].decode("latin-1")
    if kind not in ("vide", "soun"):
        return None
    f.seek(mdhd[0])
    m = f.read(mdhd[1])
    version = m[0]
    if version == 1:
        timescale = _be32.unpack(m[20:24])[0]
        duration = _be64.unpack(m[24:32])[0]
    else:
        timescale = _be32.unpack(m[12:16])[0]
        duration = _be32.unpack(m[16:20])[0]
    stbl = _find(f, minf[0], minf[0] + minf[1], "stbl")
    if not stbl:
        return None
    tr = MovTrack(kind=kind, fourcc="", timescale=timescale,
                  duration=duration)
    _parse_stbl(f, stbl[0], stbl[1], kind, tr)
    return tr


class MovReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._f.seek(0, 2)
        fsize = self._f.tell()
        self.tracks: List[MovTrack] = []
        moov = None
        for t, off, sz in iter_atoms(self._f, 0, fsize):
            if t == "moov":
                moov = (off, sz)
        if moov is None:
            raise ValueError("mov: no moov atom")
        for t, off, sz in iter_atoms(self._f, moov[0],
                                     moov[0] + moov[1]):
            if t == "trak":
                tr = _parse_trak(self._f, off, sz)
                if tr is not None:
                    self.tracks.append(tr)
        if not self.tracks:
            raise ValueError("mov: no playable tracks")

    @property
    def video(self) -> Optional[MovTrack]:
        for t in self.tracks:
            if t.kind == "vide":
                return t
        return None

    @property
    def audio(self) -> Optional[MovTrack]:
        for t in self.tracks:
            if t.kind == "soun":
                return t
        return None

    def read_sample(self, loc: Tuple[int, int]) -> bytes:
        self._f.seek(loc[0])
        return self._f.read(loc[1])

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MovReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------- #
# video sample decode


def decode_video_sample(fourcc: str, data: bytes, width: int,
                        height: int) -> Dict[str, np.ndarray]:
    """One video sample → dict of planes ('rgb' or 'y'/'u'/'v')."""
    fcc = fourcc.lower()
    if fcc == "raw ":
        rgb = np.frombuffer(data, np.uint8, width * height * 3) \
            .reshape(height, width, 3)
        return {"rgb": rgb}
    if fcc in ("yv12", "y420"):
        ysz = width * height
        csz = ysz // 4
        y = np.frombuffer(data, np.uint8, ysz).reshape(height, width)
        a = np.frombuffer(data, np.uint8, csz, ysz) \
            .reshape(height // 2, width // 2)
        b = np.frombuffer(data, np.uint8, csz, ysz + csz) \
            .reshape(height // 2, width // 2)
        if fcc == "yv12":              # V plane first
            return {"y": y, "u": b, "v": a}
        return {"y": y, "u": a, "v": b}
    if fcc in ("2vuy", "yuv2"):
        pk = np.frombuffer(data, np.uint8, width * height * 2) \
            .reshape(height, width * 2)
        if fcc == "2vuy":              # u y0 v y1
            y = pk.reshape(height, width // 2, 4)[:, :, (1, 3)] \
                .reshape(height, width)
            u2 = pk.reshape(height, width // 2, 4)[:, :, 0]
            v2 = pk.reshape(height, width // 2, 4)[:, :, 2]
        else:                          # yuv2: y0 u y1 v (s8 chroma)
            q = pk.reshape(height, width // 2, 4)
            y = q[:, :, (0, 2)].reshape(height, width)
            u2 = (q[:, :, 1].astype(np.int16) + 128).astype(np.uint8)
            v2 = (q[:, :, 3].astype(np.int16) + 128).astype(np.uint8)
        # 4:2:2 -> 4:2:0 by vertical pair average
        u = ((u2[0::2].astype(np.uint16) + u2[1::2]) // 2) \
            .astype(np.uint8)
        v = ((v2[0::2].astype(np.uint16) + v2[1::2]) // 2) \
            .astype(np.uint8)
        return {"y": np.ascontiguousarray(y), "u": u, "v": v}
    raise NotImplementedError(f"mov: video fourcc {fourcc!r} "
                              "not supported")


def decode_audio_bytes(fourcc: str, data: bytes, channels: int,
                       bits: int) -> np.ndarray:
    fcc = fourcc.lower()
    if fcc == "twos":
        pcm = np.frombuffer(data, ">i2" if bits == 16 else np.int8)
    elif fcc in ("sowt", "lpcm"):
        pcm = np.frombuffer(data, "<i2" if bits == 16 else np.int8)
    elif fcc == "raw ":
        pcm = (np.frombuffer(data, np.uint8).astype(np.int16)
               - 128) << 8
    else:
        raise NotImplementedError(f"mov: audio fourcc {fourcc!r} "
                                  "not supported")
    if bits == 8 and fcc in ("twos", "sowt", "lpcm"):
        pcm = pcm.astype(np.int16) << 8
    pcm = pcm.astype(np.int16)
    n = len(pcm) // max(1, channels) * max(1, channels)
    return pcm[:n].reshape(-1, max(1, channels))


# --------------------------------------------------------------------- #
# writer


def _atom(typ: str, payload: bytes) -> bytes:
    return _be32.pack(8 + len(payload)) + typ.encode("latin-1") + payload


def _full(typ: str, payload: bytes, version: int = 0) -> bytes:
    return _atom(typ, bytes([version, 0, 0, 0]) + payload)


class MovWriter:
    """Streaming writer: mdat grows as samples arrive, moov written on
    close (single video track + optional PCM audio track)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 fourcc: str = "jpeg", audio_rate: int = 0,
                 audio_channels: int = 2, jpeg_quality: int = 90):
        self._f = open(path, "wb")
        self.width, self.height, self.fps = width, height, fps
        self.fourcc = fourcc
        self.audio_rate = audio_rate
        self.audio_channels = audio_channels
        self.jpeg_quality = jpeg_quality
        self._vsamples: List[Tuple[int, int]] = []   # (offset, size)
        self._achunks: List[Tuple[int, int]] = []    # (offset, frames)
        self._f.write(_atom("ftyp", b"qt  \x00\x00\x02\x00qt  "))
        self._mdat_pos = self._f.tell()
        self._f.write(_be32.pack(0) + b"mdat")

    # -- samples -------------------------------------------------------
    def write_video_sample(self, data: bytes) -> None:
        off = self._f.tell()
        self._f.write(data)
        self._vsamples.append((off, len(data)))

    def write_audio(self, pcm: np.ndarray) -> None:
        """Interleaved int16 (n, channels) PCM frames (sowt)."""
        off = self._f.tell()
        data = np.ascontiguousarray(pcm, "<i2").tobytes()
        self._f.write(data)
        self._achunks.append((off, len(pcm)))

    # -- moov ----------------------------------------------------------
    def _video_trak(self, track_id: int) -> bytes:
        w, h = self.width, self.height
        timescale = 90000
        delta = int(round(timescale / max(self.fps, 1e-6)))
        n = len(self._vsamples)
        duration = n * delta
        stsd_body = (_be32.pack(1)
                     + _atom(self.fourcc,
                             b"\x00" * 6 + struct.pack(">H", 1)
                             + b"\x00" * 16
                             + struct.pack(">HH", w, h)
                             + struct.pack(">II", 0x00480000,
                                           0x00480000)
                             + _be32.pack(0) + struct.pack(">H", 1)
                             + b"\x00" * 32
                             + struct.pack(">Hh", 24, -1)))
        stts = _full("stts", _be32.pack(1)
                     + struct.pack(">II", n, delta))
        stsc = _full("stsc", _be32.pack(1)
                     + struct.pack(">III", 1, 1, 1))
        stsz = _full("stsz", _be32.pack(0) + _be32.pack(n)
                     + b"".join(_be32.pack(sz)
                                for _, sz in self._vsamples))
        stco = _full("stco", _be32.pack(n)
                     + b"".join(_be32.pack(off)
                                for off, _ in self._vsamples))
        stbl = _atom("stbl", _full("stsd", stsd_body) + stts + stsc
                     + stsz + stco)
        vmhd = _full("vmhd", struct.pack(">HHHH", 0, 0, 0, 0),
                     version=0)
        vmhd = vmhd[:11] + b"\x01" + vmhd[12:]      # flags = 1
        # dref: one self-referencing url entry
        dinf = _atom("dinf", _full(
            "dref", _be32.pack(1)
            + _be32.pack(12) + b"url " + b"\x00\x00\x00\x01"))
        minf = _atom("minf", vmhd + dinf + stbl)
        hdlr = _full("hdlr", b"mhlr" + b"vide" + b"\x00" * 12 + b"\x00")
        mdhd = _full("mdhd", struct.pack(">IIIIHH", 0, 0, timescale,
                                         duration, 0, 0))
        mdia = _atom("mdia", mdhd + hdlr + minf)
        tkhd = _full("tkhd", struct.pack(">IIIII", 0, 0, track_id, 0,
                                         duration)
                     + b"\x00" * 8 + struct.pack(">HHHH", 0, 0, 0, 0)
                     + _matrix()
                     + struct.pack(">II", w << 16, h << 16))
        tkhd = tkhd[:11] + b"\x0f" + tkhd[12:]      # flags: enabled
        return _atom("trak", tkhd + mdia)

    def _audio_trak(self, track_id: int) -> bytes:
        rate, ch = self.audio_rate, self.audio_channels
        frames = sum(nf for _, nf in self._achunks)
        fsize = 2 * ch
        stsd_body = (_be32.pack(1)
                     + _atom("sowt",
                             b"\x00" * 6 + struct.pack(">H", 1)
                             + struct.pack(">HH", 0, 0) + _be32.pack(0)
                             + struct.pack(">HHHH", ch, 16, 0, 0)
                             + struct.pack(">I", rate << 16)))
        stts = _full("stts", _be32.pack(1)
                     + struct.pack(">II", frames, 1))
        stsc_entries = []
        prev_nf = None
        for i, (_, nf) in enumerate(self._achunks):
            if nf != prev_nf:
                stsc_entries.append((i + 1, nf))
                prev_nf = nf
        stsc = _full("stsc", _be32.pack(len(stsc_entries))
                     + b"".join(struct.pack(">III", first, nf, 1)
                                for first, nf in stsc_entries))
        stsz = _full("stsz", _be32.pack(fsize) + _be32.pack(frames))
        stco = _full("stco", _be32.pack(len(self._achunks))
                     + b"".join(_be32.pack(off)
                                for off, _ in self._achunks))
        stbl = _atom("stbl", _full("stsd", stsd_body) + stts + stsc
                     + stsz + stco)
        smhd = _full("smhd", struct.pack(">HH", 0, 0))
        dinf = _atom("dinf", _full(
            "dref", _be32.pack(1)
            + _be32.pack(12) + b"url " + b"\x00\x00\x00\x01"))
        minf = _atom("minf", smhd + dinf + stbl)
        hdlr = _full("hdlr", b"mhlr" + b"soun" + b"\x00" * 12 + b"\x00")
        mdhd = _full("mdhd", struct.pack(">IIIIHH", 0, 0, rate, frames,
                                         0, 0))
        mdia = _atom("mdia", mdhd + hdlr + minf)
        tkhd = _full("tkhd", struct.pack(">IIIII", 0, 0, track_id, 0,
                                         frames)
                     + b"\x00" * 8 + struct.pack(">HHHH", 0, 0, 0x100,
                                                 0)
                     + _matrix() + struct.pack(">II", 0, 0))
        tkhd = tkhd[:11] + b"\x0f" + tkhd[12:]
        return _atom("trak", tkhd + mdia)

    def close(self) -> None:
        end = self._f.tell()
        self._f.seek(self._mdat_pos)
        self._f.write(_be32.pack(end - self._mdat_pos))
        self._f.seek(end)
        timescale = 90000
        n = len(self._vsamples)
        delta = int(round(timescale / max(self.fps, 1e-6)))
        traks = self._video_trak(1)
        next_id = 2
        if self._achunks:
            traks += self._audio_trak(next_id)
            next_id += 1
        mvhd = _full("mvhd", struct.pack(
            ">IIIII", 0, 0, timescale, n * delta, 0x00010000)
            + struct.pack(">HH", 0x0100, 0) + b"\x00" * 8 + _matrix()
            + b"\x00" * 24 + _be32.pack(next_id))
        self._f.write(_atom("moov", mvhd + traks))
        self._f.close()


def _matrix() -> bytes:
    return struct.pack(">9I", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                       0x40000000)
