# Copied from tcforge_tpu/io/ogg.py; only the package name in its imports differs.
"""OGG container demux layer (import/probe_ogg.c, import/ogmstreams.h
analogues at the container level).

Parses pages, reassembles logical-stream packets, and identifies
streams from their BOS packets: Vorbis / Theora / Speex / FLAC ID
headers and the OggDS ("OGM") stream headers the reference's
probe_ogg.c:88-260 reads.  Codec *decode* (vorbis audio, theora/divx
video) is not provided — no codec libraries in this build — so the
import path reports exactly which streams exist and why they are
gated; stream extraction (page copy by serial) supports the
tcdemux/tcextract workflow.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------- #
# page-level CRC (poly 0x04c11db7, no reflection, init/xorout 0)

_CRC_TABLE = []
for _i in range(256):
    _r = _i << 24
    for _ in range(8):
        _r = ((_r << 1) ^ 0x04C11DB7) if (_r & 0x80000000) else (_r << 1)
    _CRC_TABLE.append(_r & 0xFFFFFFFF)


def ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) ^ b)
                                                     & 0xFF]
    return crc


@dataclass
class OggPage:
    version: int
    header_type: int          # 1=continued, 2=BOS, 4=EOS
    granule: int
    serial: int
    seq: int
    crc: int
    segments: List[bytes]
    raw: bytes                # the full page, verbatim

    @property
    def bos(self) -> bool:
        return bool(self.header_type & 2)

    @property
    def eos(self) -> bool:
        return bool(self.header_type & 4)

    @property
    def continued(self) -> bool:
        return bool(self.header_type & 1)


def iter_pages(f: BinaryIO, check_crc: bool = False
               ) -> Iterator[OggPage]:
    """Walk pages, resyncing on garbage like the reference's sync
    layer."""
    buf = b""
    while True:
        # ensure we can see a header
        while len(buf) < 27:
            more = f.read(65536)
            if not more:
                return
            buf += more
        idx = buf.find(b"OggS")
        if idx < 0:
            buf = buf[-3:]
            continue
        if idx:
            buf = buf[idx:]
            continue
        while len(buf) < 27:
            more = f.read(65536)
            if not more:
                return
            buf += more
        (version, htype, granule, serial, seq, crc,
         nsegs) = struct.unpack("<BBqIIIB", buf[4:27])
        need = 27 + nsegs
        while len(buf) < need:
            more = f.read(65536)
            if not more:
                return
            buf += more
        lacing = buf[27:27 + nsegs]
        body_len = sum(lacing)
        need = 27 + nsegs + body_len
        while len(buf) < need:
            more = f.read(65536)
            if not more:
                return
            buf += more
        raw = buf[:need]
        if check_crc:
            zeroed = raw[:22] + b"\x00\x00\x00\x00" + raw[26:]
            if ogg_crc(zeroed) != crc:
                buf = buf[4:]            # bad page: resync past capture
                continue
        body = raw[27 + nsegs:]
        segments = []
        pos = 0
        for lv in lacing:
            segments.append(body[pos:pos + lv])
            pos += lv
        yield OggPage(version=version, header_type=htype,
                      granule=granule, serial=serial, seq=seq, crc=crc,
                      segments=segments, raw=raw)
        buf = buf[need:]


def pages_to_packets(pages: Iterator[OggPage], serial: Optional[int]
                     = None) -> Iterator[Tuple[int, bytes]]:
    """Reassemble packets; yields (serial, packet).  Lacing value 255
    means the packet continues into the next segment/page."""
    partial: Dict[int, bytes] = {}
    for pg in pages:
        if serial is not None and pg.serial != serial:
            continue
        had = pg.serial in partial
        acc = partial.pop(pg.serial, b"")
        drop_first = pg.continued and not had   # mid-packet join
        for seg in pg.segments:
            acc += seg
            if len(seg) < 255:                  # packet boundary
                if drop_first:
                    drop_first = False
                else:
                    yield pg.serial, acc
                acc = b""
        if acc and not drop_first:
            partial[pg.serial] = acc


# ---------------------------------------------------------------------- #
# stream identification (BOS packets)


@dataclass
class OggStreamInfo:
    serial: int
    kind: str                 # 'audio' | 'video' | 'text' | 'unknown'
    codec: str                # 'vorbis', 'theora', 'speex', 'flac',
    #                           OGM fourcc, ...
    channels: int = 0
    samplerate: int = 0
    bits: int = 0
    width: int = 0
    height: int = 0
    fps: float = 0.0


def _parse_vorbis_id(pkt: bytes) -> OggStreamInfo:
    # 1 + "vorbis" + ver(4) + channels(1) + rate(4) LE
    channels = pkt[11]
    rate = struct.unpack("<I", pkt[12:16])[0]
    return OggStreamInfo(serial=0, kind="audio", codec="vorbis",
                         channels=channels, samplerate=rate, bits=16)


def _parse_theora_id(pkt: bytes) -> OggStreamInfo:
    # 0x80 + "theora" + VMAJ VMIN VREV + FMBW(2) FMBH(2) BE
    # + picw(3) pich(3) + picx picy + FRN(4) FRD(4)
    fmbw, fmbh = struct.unpack(">HH", pkt[10:14])
    picw = int.from_bytes(pkt[14:17], "big")
    pich = int.from_bytes(pkt[17:20], "big")
    frn, frd = struct.unpack(">II", pkt[22:30])
    fps = frn / frd if frd else 0.0
    return OggStreamInfo(serial=0, kind="video", codec="theora",
                         width=picw or fmbw * 16,
                         height=pich or fmbh * 16, fps=fps)


def _parse_ogm_header(pkt: bytes) -> Optional[OggStreamInfo]:
    # 0x01 + ogm_stream_header (ogmstreams.h:71-94)
    if len(pkt) < 1 + 40:
        return None
    streamtype = pkt[1:9].rstrip(b"\x00").decode("latin-1",
                                                 "replace")
    subtype = pkt[9:13].decode("latin-1", "replace")
    time_unit, samples_per_unit = struct.unpack("<qq", pkt[17:33])
    bits = struct.unpack("<H", pkt[41:43])[0] if len(pkt) >= 43 else 0
    if streamtype.startswith("video"):
        if len(pkt) < 53:
            return None
        w, h = struct.unpack("<ii", pkt[45:53])
        fps = 10_000_000 / time_unit if time_unit else 0.0
        return OggStreamInfo(serial=0, kind="video", codec=subtype,
                             width=w, height=h, fps=fps)
    if streamtype.startswith("audio"):
        if len(pkt) < 49:
            return None
        channels, _blockalign = struct.unpack("<hh", pkt[45:49])
        return OggStreamInfo(serial=0, kind="audio", codec=subtype,
                             channels=channels,
                             samplerate=int(samples_per_unit),
                             bits=bits)
    if streamtype.startswith("text"):
        return OggStreamInfo(serial=0, kind="text", codec="text")
    return None


def identify_bos(pkt: bytes) -> OggStreamInfo:
    if len(pkt) >= 7 and pkt[0] == 1 and pkt[1:7] == b"vorbis":
        return _parse_vorbis_id(pkt)
    if len(pkt) >= 7 and pkt[0] == 0x80 and pkt[1:7] == b"theora":
        return _parse_theora_id(pkt)
    if len(pkt) >= 8 and pkt[:8] == b"Speex   ":
        rate = struct.unpack("<I", pkt[36:40])[0] if len(pkt) >= 40 else 0
        ch = struct.unpack("<I", pkt[48:52])[0] if len(pkt) >= 52 else 0
        return OggStreamInfo(serial=0, kind="audio", codec="speex",
                             channels=ch, samplerate=rate)
    if len(pkt) >= 5 and pkt[:5] == b"\x7fFLAC":
        return OggStreamInfo(serial=0, kind="audio", codec="flac")
    if len(pkt) >= 1 and pkt[0] == 0x01:
        ogm = _parse_ogm_header(pkt)
        if ogm is not None:
            return ogm
    return OggStreamInfo(serial=0, kind="unknown", codec="unknown")


def identify_streams(f: BinaryIO) -> List[OggStreamInfo]:
    """Read BOS pages (they come first in a physical stream) and
    identify every logical stream (probe_ogg.c:108-260)."""
    out: List[OggStreamInfo] = []
    for pg in iter_pages(f):
        if not pg.bos:
            break
        pkt = b"".join(pg.segments)
        info = identify_bos(pkt)
        info.serial = pg.serial
        out.append(info)
    return out


def extract_stream(f: BinaryIO, out: BinaryIO, serial: int) -> int:
    """Copy one logical stream's pages verbatim to `out` (tcdemux-style
    stream extraction).  Returns pages copied."""
    n = 0
    for pg in iter_pages(f):
        if pg.serial == serial:
            out.write(pg.raw)
            n += 1
    return n


# ---------------------------------------------------------------------- #
# Page writer (multiplex/multiplex_ogg.c byte-layout half: pages + CRC;
# no codec libs involved — payloads are OGM/raw packets)

FLAG_CONTINUED = 0x01
FLAG_BOS = 0x02
FLAG_EOS = 0x04


def build_page(serial: int, seq: int, granule: int,
               segments: List[bytes], flags: int = 0) -> bytes:
    """Serialize one page; `segments` are the lacing chunks (each
    <= 255 bytes, a 255-byte chunk continues the packet)."""
    lacing = bytes(len(s) for s in segments)
    body = b"".join(segments)
    hdr = (b"OggS" + bytes([0, flags])
           + struct.pack("<qIIi", granule, serial & 0xFFFFFFFF,
                         seq, 0)
           + bytes([len(segments)]) + lacing)
    crc = ogg_crc(hdr + body)
    hdr = hdr[:22] + struct.pack("<I", crc) + hdr[26:]
    return hdr + body


def _lace(packet: bytes) -> List[bytes]:
    """Split a packet into 255-byte lacing segments (a final short or
    empty segment terminates it)."""
    segs = [packet[i:i + 255] for i in range(0, len(packet), 255)]
    if not segs or len(segs[-1]) == 255:
        segs.append(b"")
    return segs


class OggPageWriter:
    """One logical stream's packet->page serializer."""

    MAX_SEGS = 200          # flush threshold (255 is the format limit)

    def __init__(self, f: BinaryIO, serial: int):
        self.f = f
        self.serial = serial
        self.seq = 0
        self._segs: List[bytes] = []
        self._granule = 0
        self._flags = FLAG_BOS          # first page out is BOS

    def _emit(self, flags_extra: int = 0) -> None:
        if not self._segs and not (self._flags | flags_extra):
            return
        page = build_page(self.serial, self.seq, self._granule,
                          self._segs, self._flags | flags_extra)
        self.f.write(page)
        self.seq += 1
        self._segs = []
        self._flags = 0

    def write_packet(self, packet: bytes, granule: int,
                     flush: bool = False) -> None:
        """Queue one packet; `granule` is the stream position after it."""
        for seg in _lace(packet):
            self._segs.append(seg)
            if len(self._segs) >= self.MAX_SEGS:
                self._granule = -1 if len(seg) == 255 else granule
                self._emit()
                if len(seg) == 255:
                    self._flags |= FLAG_CONTINUED
        self._granule = granule
        if flush:
            self._emit()

    def close(self, eos: bool = True) -> None:
        self._emit(FLAG_EOS if eos else 0)


# OGM (OggDS) stream headers, the layout probe_ogg.c reads back
# (ogmstreams.h:71-94): 1 type byte + 56-byte ogm_stream_header.

def ogm_video_header(fourcc: str, width: int, height: int,
                     fps: float) -> bytes:
    buf = bytearray(57)
    buf[0] = 0x01
    buf[1:1 + 5] = b"video"
    buf[9:13] = fourcc.encode("latin-1")[:4].ljust(4, b"\x20")
    time_unit = int(round(10_000_000 / fps)) if fps else 400000
    struct.pack_into("<qq", buf, 17, time_unit, 1)
    struct.pack_into("<l", buf, 13, 56)          # header size
    struct.pack_into("<ii", buf, 45, width, height)
    return bytes(buf)


def ogm_audio_header(rate: int, channels: int, bits: int,
                     block_align: int) -> bytes:
    buf = bytearray(57)
    buf[0] = 0x01
    buf[1:1 + 5] = b"audio"
    buf[9:13] = b"\x30\x30\x30\x31"              # 0001 = PCM tag
    struct.pack_into("<l", buf, 13, 56)
    # OGM audio convention (ogmstreams.h / ogmtools): time_unit is
    # one second in 100 ns units and samples_per_unit carries the
    # rate — readers derive rate = spu * 1e7 / time_unit, so packing
    # time_unit = 1e7/rate would square the rate (and overflow
    # int32 in libavformat)
    struct.pack_into("<qq", buf, 17, 10_000_000, rate)
    struct.pack_into("<l", buf, 33, 1)           # default_len
    struct.pack_into("<H", buf, 41, bits)
    struct.pack_into("<hh", buf, 45, channels, block_align)
    struct.pack_into("<I", buf, 49, rate * channels * (bits // 8))
    return bytes(buf)


def ogm_comment_header(vendor: bytes = b"tcforge_tpu") -> bytes:
    """OGM secondary (comment) header: 0x03 + 'vorbis' + a
    vorbis-comment block + framing byte.  OGM logical streams carry
    TWO header packets; demuxers (libavformat oggparseogm.c) wait
    for both before opening the stream."""
    return (b"\x03vorbis"
            + len(vendor).to_bytes(4, "little") + vendor
            + (0).to_bytes(4, "little") + b"\x01")


def ogm_data_packet(payload: bytes, samples: int = 1,
                    keyframe: bool = True) -> bytes:
    """OGM data packet: flags byte encodes the sample-count field width
    (bits 7-6 -> low bits, bit 1 -> bit 2) and the keyframe bit 0x08."""
    if samples < 0x100:
        nlen, field = 1, struct.pack("<B", samples)
    elif samples < 0x10000:
        nlen, field = 2, struct.pack("<H", samples)
    else:
        nlen, field = 4, struct.pack("<I", samples)
    flags = ((nlen & 3) << 6) | ((nlen & 4) >> 1)
    if keyframe:
        flags |= 0x08
    return bytes([flags]) + field + payload


def ogm_parse_data_packet(pkt: bytes) -> Tuple[bytes, int, bool]:
    """Inverse of ogm_data_packet -> (payload, samples, keyframe)."""
    flags = pkt[0]
    nlen = ((flags & 0xC0) >> 6) | ((flags & 0x02) << 1)
    samples = int.from_bytes(pkt[1:1 + nlen], "little") if nlen else 1
    return pkt[1 + nlen:], samples, bool(flags & 0x08)
