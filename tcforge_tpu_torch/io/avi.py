# Copied from tcforge_tpu/io/avi.py; only the package name in its imports differs.
"""AVI container reader/writer.

Rebuild of ``avilib/avilib.[ch]``: byte-level AVI 1.0 container handling —
the codec payloads are opaque (exactly like avilib; decoding is the
import/export modules' job).  Features mirrored from avilib.h:324-389:

- video stream + multiple audio tracks,
- keyframe flags in the idx1 index,
- index rebuild by scanning the movi list when idx1 is missing,
- header fixup on close.

OpenDML (AVI 2.0) support mirrors avilib's >2GB handling: the writer
rolls into ``RIFF AVIX`` extension segments past the segment limit,
emits per-stream per-segment ``ix##`` standard indexes inside each movi
list plus an ``indx`` super index in the stream headers and an
``odml/dmlh`` total-frames header; the reader prefers the super index
(which spans segments) and falls back to idx1 / movi scanning,
including scanning across AVIX segments.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Tuple, Union

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIF_ISINTERLEAVED = 0x00000100
AVIIF_KEYFRAME = 0x00000010

AVI10_LIMIT = (1 << 31) - (1 << 20)   # stay under 2GB like avilib


class AviError(ValueError):
    pass


@dataclass
class AviVideoStream:
    fourcc: str = "I420"
    width: int = 0
    height: int = 0
    fps: float = 25.0
    frames: int = 0


@dataclass
class AviAudioStream:
    format_tag: int = 1          # PCM
    channels: int = 2
    rate: int = 48000
    bits: int = 16
    bytes_total: int = 0
    # compressed tracks (MP3/MP2/AC3): average byte rate; the stream
    # header then uses the byte-stream form (dwScale=nBlockAlign=1,
    # dwRate=nAvgBytesPerSec=byte_rate) instead of PCM sample math
    byte_rate: int = 0

    @property
    def block_align(self) -> int:
        if self.byte_rate:
            return 1
        return max(1, self.channels * self.bits // 8)

    @property
    def avg_bytes_per_sec(self) -> int:
        return self.byte_rate or self.rate * self.block_align


@dataclass
class _IndexEntry:
    ckid: bytes
    flags: int
    offset: int       # absolute file offset of chunk header
    size: int


def _fourcc(s: str) -> bytes:
    return s.encode("ascii").ljust(4, b" ")[:4]


class AviWriter:
    """AVI 1.0 writer (AVI_open_output_file + AVI_write_frame analogue)."""

    MAX_SEGMENTS = 64                # indx super-index capacity

    def __init__(self, path: Union[str, os.PathLike],
                 video: AviVideoStream,
                 audio_tracks: Optional[List[AviAudioStream]] = None,
                 segment_limit: int = AVI10_LIMIT,
                 comments: Optional[dict] = None):
        self._f: BinaryIO = open(path, "w+b")
        self.video = video
        self.audio = list(audio_tracks or [])
        # --avi_comments: LIST INFO tags (INAM, ICMT, ISFT, ...)
        self.comments = dict(comments or {})
        self._index: List[_IndexEntry] = []
        self._frames = 0
        self._seg0_frames = 0
        self._audio_bytes = [0] * len(self.audio)
        self._audio_chunks = [0] * len(self.audio)
        self._segment_limit = max(1 << 12, segment_limit)
        self._segment = 0
        self._seg_start = 0          # file offset of current RIFF header
        # per-stream entries of the CURRENT segment: (ckid, off, size, kf)
        self._seg_entries: List[List[_IndexEntry]] =             [[] for _ in range(1 + len(self.audio))]
        # per-stream list of written ix chunks: (offset, size, n_entries)
        self._ix_chunks: List[List[Tuple[int, int, int]]] =             [[] for _ in range(1 + len(self.audio))]
        # reserve header space; rewritten on close
        self._headers_size = self._compute_headers_size()
        self._f.write(b"\0" * self._headers_size)
        self._movi_start = self._f.tell()
        self._f.write(b"LIST\0\0\0\0movi")
        self._seg_movi_start = self._movi_start

    def _compute_headers_size(self) -> int:
        # RIFF(12) + hdrl LIST hdr(12) + avih(8+56)
        n = 12 + 12 + 64
        indx = 8 + 24 + 16 * self.MAX_SEGMENTS  # per-stream super index
        n += 12 + 8 + 56 + 8 + 40 + indx  # video strl + strh + strf + indx
        for _ in self.audio:
            n += 12 + 8 + 56 + 8 + 16 + indx
        n += 12 + 8 + 248              # odml LIST + dmlh
        if self.comments:
            n += len(self._build_info())
        n += 8 + 260                   # JUNK padding for alignment/growth
        return n

    def _build_info(self) -> bytes:
        """LIST INFO chunk from the comments dict (AVI_info tags)."""
        body = b""
        for tag, text in self.comments.items():
            data = text.encode("utf-8", "replace") + b"\0"
            if len(data) & 1:
                data += b"\0"
            body += (tag.encode("latin-1")[:4].ljust(4, b" ")
                     + struct.pack("<I", len(data)) + data)
        return (b"LIST" + struct.pack("<I", 4 + len(body)) + b"INFO"
                + body)

    def _stream_no(self, ckid: bytes) -> int:
        return int(ckid[:2])

    def _write_ix_chunks(self) -> None:
        """One OpenDML standard index (ix##) per stream for the current
        segment's chunks, placed inside the movi list."""
        base = self._seg_movi_start
        for sn, entries in enumerate(self._seg_entries):
            if not entries:
                continue
            ckid = entries[0].ckid
            # AVI_STDINDEX: wLongsPerEntry, subtype, type, nEntries,
            # chunk id, qwBaseOffset, reserved
            body = struct.pack("<HBBI4sQI", 2, 0, 0x01, len(entries),
                               ckid, base, 0)
            for e in entries:
                size = e.size
                if not (e.flags & AVIIF_KEYFRAME):
                    size |= 0x80000000
                body += struct.pack("<II", e.offset + 8 - base, size)
            pos = self._f.tell()
            ixid = b"ix" + ckid[:2]
            self._f.write(ixid + struct.pack("<I", len(body)) + body)
            self._ix_chunks[sn].append((pos, len(body) + 8,
                                        len(entries)))
            self._seg_entries[sn] = []

    def _close_segment(self, last: bool) -> None:
        """Finish the current movi list (+idx1 for segment 0) and patch
        the segment's RIFF size."""
        self._write_ix_chunks()
        movi_end = self._f.tell()
        if self._segment == 0:
            self._seg0_frames = self._frames
            idx = bytearray()
            for e in self._index:
                idx += e.ckid
                idx += struct.pack("<III", e.flags,
                                   e.offset - (self._movi_start + 8),
                                   e.size)
            self._f.write(b"idx1" + struct.pack("<I", len(idx))
                          + bytes(idx))
        seg_end = self._f.tell()
        self._f.seek(self._seg_movi_start)
        self._f.write(b"LIST" + struct.pack(
            "<I", movi_end - self._seg_movi_start - 8) + b"movi")
        if self._segment > 0:
            self._f.seek(self._seg_start)
            self._f.write(b"RIFF" + struct.pack(
                "<I", seg_end - self._seg_start - 8) + b"AVIX")
        self._f.seek(seg_end)

    def _roll_segment(self) -> None:
        if self._segment + 1 >= self.MAX_SEGMENTS:
            raise AviError("too many OpenDML segments")
        self._close_segment(last=False)
        self._segment += 1
        self._seg_start = self._f.tell()
        self._f.write(b"RIFF\0\0\0\0AVIX")
        self._seg_movi_start = self._f.tell()
        self._f.write(b"LIST\0\0\0\0movi")

    # ------------------------------------------------------------------ #

    def _write_chunk(self, ckid: bytes, data: bytes, flags: int) -> None:
        pos = self._f.tell()
        if pos - self._seg_start + len(data) + 4096 > self._segment_limit:
            self._roll_segment()
            pos = self._f.tell()
        self._f.write(ckid + struct.pack("<I", len(data)))
        self._f.write(data)
        if len(data) & 1:
            self._f.write(b"\0")
        entry = _IndexEntry(ckid, flags, pos, len(data))
        if self._segment == 0:
            self._index.append(entry)
        self._seg_entries[self._stream_no(ckid)].append(entry)

    @property
    def _video_ckid(self) -> bytes:
        return (b"00dc" if self.video.fourcc not in
                ("I420", "YV12", "YUY2", "UYVY", "RGB ", "DIB ")
                else b"00db")

    def write_video_frame(self, data: bytes, keyframe: bool = True) -> None:
        self._write_chunk(self._video_ckid, data,
                          AVIIF_KEYFRAME if keyframe else 0)
        self._frames += 1

    def write_audio(self, data: bytes, track: int = 0) -> None:
        if track >= len(self.audio):
            raise AviError(f"no audio track {track}")
        ckid = b"%02dwb" % (track + 1)
        self._write_chunk(ckid, data, AVIIF_KEYFRAME)
        self._audio_bytes[track] += len(data)
        self._audio_chunks[track] += 1

    # ------------------------------------------------------------------ #

    def _build_headers(self) -> bytes:
        v = self.video
        fps = v.fps if v.fps > 0 else 25.0
        usec_per_frame = int(round(1_000_000 / fps))
        max_bytes_per_sec = int(v.width * v.height * 3 * fps)
        num_streams = 1 + len(self.audio)

        avih = struct.pack(
            "<14I", usec_per_frame, max_bytes_per_sec, 0,
            AVIF_HASINDEX | AVIF_ISINTERLEAVED, self._seg0_frames, 0,
            num_streams, 0, v.width, v.height, 0, 0, 0, 0)

        def super_index(sn: int, ckid: bytes) -> bytes:
            """OpenDML 'indx' super index pointing at the ix## chunks."""
            chunks = self._ix_chunks[sn]
            # AVI_SUPERINDEX: wLongsPerEntry, subtype, type, nEntries,
            # chunk id, reserved x3
            body = struct.pack("<HBBI4s3I", 4, 0, 0x00, len(chunks),
                               ckid, 0, 0, 0)
            for off, size, dur in chunks:
                body += struct.pack("<QII", off, size, dur)
            body += b"\0" * (16 * (self.MAX_SEGMENTS - len(chunks)))
            return b"indx" + struct.pack("<I", len(body)) + body

        # video strl (fps = dwRate/dwScale = 1e6/usec_per_frame)
        strh_v = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            b"vids", _fourcc(v.fourcc), 0, 0, 0, 0,
            usec_per_frame, 1_000_000,
            0, self._frames, 0, 0xFFFFFFFF, 0,
            0, 0, v.width & 0x7FFF, v.height & 0x7FFF)
        bits = {"I420": 12, "YV12": 12, "YUY2": 16, "UYVY": 16}.get(
            v.fourcc, 24)
        bmih = struct.pack(
            "<IiiHH4sIiiII", 40, v.width, v.height, 1, bits,
            _fourcc(v.fourcc), v.width * v.height * bits // 8, 0, 0, 0, 0)
        indx_v = super_index(0, self._video_ckid)
        strl_v = (b"LIST" + struct.pack("<I", 4 + 8 + len(strh_v) + 8
                                        + len(bmih) + len(indx_v))
                  + b"strl"
                  + b"strh" + struct.pack("<I", len(strh_v)) + strh_v
                  + b"strf" + struct.pack("<I", len(bmih)) + bmih
                  + indx_v)

        strl_a = b""
        for t, a in enumerate(self.audio):
            ba = a.block_align
            bps = a.avg_bytes_per_sec
            length = self._audio_bytes[t] // ba
            strh = struct.pack(
                "<4s4sIHHIIIIIIIIhhhh",
                b"auds", b"\0\0\0\0", 0, 0, 0, 0,
                ba, bps if a.byte_rate else a.rate * ba, 0, length,
                0, 0, ba, 0, 0, 0, 0)
            strf = struct.pack("<HHIIHH", a.format_tag, a.channels,
                               a.rate, bps, ba,
                               0 if a.byte_rate else a.bits)
            indx_a = super_index(t + 1, b"%02dwb" % (t + 1))
            strl_a += (b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8
                                             + len(strf) + len(indx_a))
                       + b"strl"
                       + b"strh" + struct.pack("<I", len(strh)) + strh
                       + b"strf" + struct.pack("<I", len(strf)) + strf
                       + indx_a)

        dmlh = struct.pack("<I", self._frames).ljust(248, b"\0")
        odml = (b"LIST" + struct.pack("<I", 4 + 8 + len(dmlh)) + b"odml"
                + b"dmlh" + struct.pack("<I", len(dmlh)) + dmlh)
        hdrl_body = (b"avih" + struct.pack("<I", len(avih)) + avih
                     + strl_v + strl_a + odml)
        hdrl = (b"LIST" + struct.pack("<I", 4 + len(hdrl_body)) + b"hdrl"
                + hdrl_body)
        return hdrl

    def close(self) -> None:
        self._close_segment(last=True)
        file_end = self._f.tell()
        seg0_end = file_end if self._segment == 0 else self._seg_start

        # headers
        hdrl = self._build_headers()
        self._f.seek(0)
        self._f.write(b"RIFF" + struct.pack("<I", seg0_end - 8) + b"AVI ")
        self._f.write(hdrl)
        if self.comments:
            self._f.write(self._build_info())
        pad = self._headers_size - (self._f.tell())
        if pad < 8:
            raise AviError("header area overflow (internal)")
        self._f.write(b"JUNK" + struct.pack("<I", pad - 8) + b"\0" * (pad - 8))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AviReader:
    """AVI reader (AVI_open_input_file analogue) with index rebuild."""

    def __init__(self, path: Union[str, os.PathLike]):
        self._f: BinaryIO = open(path, "rb")
        self.video = AviVideoStream()
        self.audio: List[AviAudioStream] = []
        self._video_index: List[Tuple[int, int, int]] = []  # (off, size, flags)
        self._audio_index: List[List[Tuple[int, int]]] = []
        self._movi_start = 0
        self.info: dict = {}           # LIST INFO tags
        self._parse()

    # ------------------------------------------------------------------ #

    def _parse(self) -> None:
        f = self._f
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"AVI ":
            raise AviError("not an AVI file")
        idx1_data = None
        stream_types: List[bytes] = []
        self._super: List[List[int]] = []   # per stream: ix chunk offsets
        self._movi_starts: List[int] = []
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"RIFF":
                f.read(4)             # AVIX extension segment: descend
                continue
            if cid == b"LIST":
                ltype = f.read(4)
                if ltype == b"movi":
                    if not self._movi_starts:
                        self._movi_start = f.tell() - 4
                    self._movi_starts.append(f.tell() - 4)
                    f.seek(size - 4, 1)
                elif ltype in (b"hdrl", b"strl"):
                    continue  # descend
                elif ltype == b"INFO":
                    body = f.read(size - 4 + (size & 1))
                    pos = 0
                    while pos + 8 <= len(body):
                        tag = body[pos:pos + 4].decode("latin-1").strip()
                        ln = struct.unpack("<I",
                                           body[pos + 4:pos + 8])[0]
                        self.info[tag] = body[pos + 8:pos + 8 + ln] \
                            .rstrip(b"\0").decode("utf-8", "replace")
                        pos += 8 + ln + (ln & 1)
                else:
                    f.seek(size - 4, 1)
            elif cid == b"avih":
                data = f.read(size + (size & 1))
                vals = struct.unpack("<14I", data[:56])
                self.video.width, self.video.height = vals[8], vals[9]
                if vals[0]:
                    self.video.fps = 1_000_000 / vals[0]
                self.video.frames = vals[4]
            elif cid == b"strh":
                data = f.read(size + (size & 1))
                fcc_type = data[:4]
                stream_types.append(fcc_type)
                if fcc_type == b"vids":
                    self.video.fourcc = data[4:8].decode("ascii",
                                                         "replace").strip()
                    scale, rate = struct.unpack("<II", data[20:28])
                    if scale:
                        self.video.fps = rate / scale
                elif fcc_type == b"auds":
                    self.audio.append(AviAudioStream())
                    self._audio_index.append([])
            elif cid == b"strf":
                data = f.read(size + (size & 1))
                if stream_types and stream_types[-1] == b"auds" and self.audio:
                    (tag, ch, rate, br, ba,
                     bits) = struct.unpack("<HHIIHH", data[:16])
                    a = self.audio[-1]
                    a.format_tag, a.channels, a.rate, a.bits = (tag, ch,
                                                                rate, bits)
                    if tag != 1:
                        # byte-stream track: keep the coded byte rate
                        # so rewrites (avimerge/avisplit) stay valid
                        a.byte_rate = br
                elif stream_types and stream_types[-1] == b"vids" and size >= 40:
                    # BITMAPINFOHEADER compression fourcc wins over strh
                    comp = data[16:20]
                    if comp.strip(b"\0"):
                        self.video.fourcc = comp.decode("ascii",
                                                        "replace").strip()
            elif cid == b"indx":
                data = f.read(size + (size & 1))
                self._super.append(self._parse_super_index(data))
            elif cid == b"idx1":
                idx1_data = f.read(size + (size & 1))
            else:
                f.seek(size + (size & 1), 1)

        if any(self._super):
            self._load_opendml()
        if not self._video_index and idx1_data:
            self._load_idx1(idx1_data)
        if not self._video_index:
            self._scan_movi()
        self.video.frames = len(self._video_index)

    def _parse_super_index(self, data: bytes) -> List[int]:
        """OpenDML super index -> list of ix chunk file offsets."""
        if len(data) < 24:
            return []
        _lpb, _sub, idx_type, n_in_use = struct.unpack_from("<HBBI",
                                                            data, 0)
        offs = []
        if idx_type != 0x00:          # not an index-of-indexes
            return []
        for k in range(n_in_use):
            base = 24 + 16 * k
            if base + 16 > len(data):
                break
            qw_off = struct.unpack_from("<Q", data, base)[0]
            offs.append(qw_off)
        return offs

    def _load_opendml(self) -> None:
        """Build the frame index from ix## standard index chunks."""
        f = self._f
        here = f.tell()
        for sn, ix_offsets in enumerate(self._super):
            for off in ix_offsets:
                f.seek(off)
                hdr = f.read(8)
                if len(hdr) < 8 or hdr[:2] != b"ix":
                    continue
                size = struct.unpack("<I", hdr[4:])[0]
                data = f.read(size)
                if len(data) < 24:
                    continue
                (_lpb, _sub, idx_type, n, ckid,
                 base, _r2) = struct.unpack_from("<HBBI4sQI", data, 0)
                if idx_type != 0x01:
                    continue
                for k in range(n):
                    o = 24 + 8 * k
                    if o + 8 > len(data):
                        break
                    doff, dsize = struct.unpack_from("<II", data, o)
                    keyframe = not (dsize & 0x80000000)
                    dsize &= 0x7FFFFFFF
                    pos = base + doff
                    if ckid[:2] == b"00":
                        self._video_index.append(
                            (pos, dsize,
                             AVIIF_KEYFRAME if keyframe else 0))
                    elif ckid[2:4] == b"wb":
                        t = int(ckid[:2]) - 1
                        if 0 <= t < len(self._audio_index):
                            self._audio_index[t].append((pos, dsize))
        f.seek(here)

    def _load_idx1(self, data: bytes) -> None:
        # idx1 offsets are relative to the 'movi' fourcc position
        # (self._movi_start records exactly that position)
        base = self._movi_start
        n = len(data) // 16
        # Detect absolute-offset indexes (some writers store them)
        absolute = False
        if n:
            first_off = struct.unpack("<I", data[8:12])[0]
            probe = base + first_off
            here = self._f.tell()
            for cand, is_abs in ((probe, False), (first_off, True)):
                self._f.seek(cand)
                if self._f.read(4) == data[0:4]:
                    absolute = is_abs
                    break
            self._f.seek(here)
        for i in range(n):
            ckid, flags, off, size = struct.unpack_from("<4sIII", data,
                                                        i * 16)
            pos = off if absolute else base + off
            stream = ckid[:2]
            if stream == b"00":
                self._video_index.append((pos + 8, size, flags))
            elif ckid[2:] == b"wb":
                t = int(ckid[:2]) - 1
                if 0 <= t < len(self._audio_index):
                    self._audio_index[t].append((pos + 8, size))

    def _scan_movi(self) -> None:
        """Index rebuild by walking movi chunks (avilib idx_fix path),
        across every movi list (AVI + AVIX segments)."""
        f = self._f
        end = os.fstat(f.fileno()).st_size
        starts = self._movi_starts or [self._movi_start]
        for ms in starts:
            f.seek(ms - 8)
            lsize = struct.unpack("<I", f.read(4))[0]
            movi_end = min(end, ms + 4 + lsize - 4)
            f.seek(ms + 4)
            while f.tell() + 8 <= movi_end:
                pos = f.tell()
                hdr = f.read(8)
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid in (b"idx1",) or cid[:2] == b"ix":
                    f.seek(size + (size & 1), 1)
                    continue
                if cid[:2] == b"00":
                    self._video_index.append((pos + 8, size,
                                              AVIIF_KEYFRAME))
                elif cid[2:] == b"wb":
                    t = int(cid[:2]) - 1
                    if 0 <= t < len(self._audio_index):
                        self._audio_index[t].append((pos + 8, size))
                f.seek(size + (size & 1), 1)

    # ------------------------------------------------------------------ #

    @property
    def video_frames(self) -> int:
        return len(self._video_index)

    def audio_bytes(self, track: int = 0) -> int:
        return sum(s for _, s in self._audio_index[track])

    def read_video_frame(self, idx: int) -> Tuple[bytes, bool]:
        """(payload, keyframe) for frame idx (AVI_read_frame)."""
        off, size, flags = self._video_index[idx]
        self._f.seek(off)
        return self._f.read(size), bool(flags & AVIIF_KEYFRAME)

    def read_audio_chunks(self, track: int = 0):
        for off, size in self._audio_index[track]:
            self._f.seek(off)
            yield self._f.read(size)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
