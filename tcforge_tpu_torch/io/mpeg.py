# Copied from tcforge_tpu/io/mpeg.py; only the package name in its imports differs.
"""MPEG PS/ES scanning: probe + program-stream demux (host side).

Rebuild of the probing/navigation halves of ``mpeglib/`` and
``import/scan_pes.c`` / ``seqinfo.c``: sequence-header parsing for probe
(width/height/fps/aspect from the 00 00 01 B3 header), PS pack walking,
and PES payload extraction for the compressed-import path.

Actual video *decoding* is delegated to a host decoder module
(modules/importers); this file is pure bitstream navigation.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional, Tuple

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat

# MPEG frame-rate code table (ISO 11172-2 / 13818-2), matches the
# reference's frc codes 1..8 (libtc/ratiocodes.c:36-53).
_MPEG_FPS = {
    1: 24000 / 1001, 2: 24.0, 3: 25.0, 4: 30000 / 1001,
    5: 30.0, 6: 50.0, 7: 60000 / 1001, 8: 60.0,
}

SEQ_START = b"\x00\x00\x01\xb3"
PACK_START = b"\x00\x00\x01\xba"
PES_VIDEO_BASE = 0xE0
PES_AUDIO_BASE = 0xC0
PES_PRIVATE1 = 0xBD


def parse_sequence_header(buf: bytes) -> Optional[Tuple[int, int, int, float]]:
    """Parse an MPEG video sequence header at the start of `buf`
    (after the 00 00 01 B3 code): returns (width, height, aspect_code,
    fps) or None (seqinfo.c / scan_pes.c:269 semantics)."""
    if len(buf) < 8:
        return None
    w = (buf[0] << 4) | (buf[1] >> 4)
    h = ((buf[1] & 0x0F) << 8) | buf[2]
    aspect = buf[3] >> 4
    frate = buf[3] & 0x0F
    fps = _MPEG_FPS.get(frate, 0.0)
    return w, h, aspect, fps


def find_sequence_header(path: str,
                         limit: int = 2 << 20) -> Optional[Tuple[int, int,
                                                                 int, float]]:
    """Scan the first `limit` bytes for a sequence header (inside PES
    payloads or raw ES)."""
    with open(path, "rb") as f:
        data = f.read(limit)
    pos = data.find(SEQ_START)
    if pos < 0:
        return None
    return parse_sequence_header(data[pos + 4:pos + 16])


def probe_mpeg(path: str, info, limit: int = 2 << 20) -> None:
    """Fill ProbeInfo for a PS/ES stream (probe_mpeg/probe_stream
    analogue); `limit` = -H probe depth in bytes."""
    seq = find_sequence_header(path, limit=limit)
    if seq:
        w, h, aspect, fps = seq
        info.is_video = True
        info.width, info.height = w, h
        info.fps = fps
        info.asr = aspect
        # MPEG-1 streams carry no sequence_extension (id 0b0001 in
        # the nibble after an 0xB5 start code) — scan the SAME probe
        # window the sequence-header search used, starting from the
        # header itself
        with open(path, "rb") as f:
            head = f.read(limit)
        start = max(0, head.find(SEQ_START))
        is_m2 = False
        i = start
        while True:
            i = head.find(b"\x00\x00\x01\xb5", i)
            if i < 0 or i + 5 > len(head):
                break
            if (head[i + 4] >> 4) == 1:
                is_m2 = True
                break
            i += 4
        info.codec = Codec.MPEG2 if is_m2 else Codec.MPEG1
    # detect AC3 audio in PS private-stream packets (not raw ES bytes,
    # which would false-positive on coded video data)
    with open(path, "rb") as f:
        head = f.read(4)
    if head == PACK_START:
        from tcforge_tpu_torch.io.probe import ProbeTrack
        seen = set()                     # one listing per track kind
        scanned = 0
        for sid, payload in iter_pes_packets(path):
            scanned += 1
            if scanned > 4000 or len(seen) >= 3:
                break
            if 0xC0 <= sid <= 0xDF and ("mp2", sid) not in seen:
                # MPEG audio stream (MP2/MP3 PES)
                from tcforge_tpu_torch.io.mp3 import iter_frames
                rate = 48000
                ch = 2
                for _, fr in iter_frames(payload[:4096]):
                    rate = fr.rate
                    ch = fr.channels
                    break
                info.tracks.append(ProbeTrack(
                    codec=Codec.MP2, samplerate=rate,
                    channels=ch, bits=16))
                seen.add(("mp2", sid))
                continue
            if sid != PES_PRIVATE1:
                continue
            if b"\x0b\x77" in payload[:16] and "ac3" not in seen:
                info.tracks.append(ProbeTrack(codec=Codec.AC3,
                                              samplerate=48000,
                                              channels=2))
                seen.add("ac3")
                continue
            if payload[:1] == b"\xff" and "vag" not in seen:
                # PlayStation VAG audio (scan_pes.c:1184-1222 role)
                from tcforge_tpu_torch.io.vag import parse_header as _vag_hdr
                got = _vag_hdr(payload[4:])
                info.tracks.append(ProbeTrack(
                    codec=Codec.VAG,
                    samplerate=got.rate if got else 44100,
                    channels=got.channels if got else 1, bits=16))
                seen.add("vag")
                continue
            if payload[:1] and 0xA0 <= payload[0] <= 0xA7 \
                    and ("lpcm", payload[0]) not in seen:
                try:
                    got = parse_lpcm_payload(payload,
                                             payload[0] - 0xA0)
                except NotImplementedError:
                    got = None
                if got is not None:
                    info.tracks.append(ProbeTrack(
                        codec=Codec.PCM, samplerate=got[1],
                        channels=got[0].shape[1], bits=16))
                    seen.add(("lpcm", payload[0]))


def iter_pes_packets(path: str, chunk: int = 1 << 20,
                     with_pts: bool = False):
    """Walk a program stream yielding (stream_id, payload) PES packets.

    Port of the packet-level walk in mpeglib/tcdemux: handles pack
    headers (MPEG-1 and MPEG-2 forms), system headers, and PES packets
    with MPEG-2 extension headers.  STREAMING: the file is read in
    ``chunk``-sized windows and only the unconsumed tail is buffered
    (the windowed-reader role of mpeglib's packet loop) — memory stays
    bounded regardless of file size.
    """
    with open(path, "rb") as f:
        data = f.read(chunk)
        eof = len(data) < chunk
        pos = 0

        def need(k):
            """Ensure k bytes from pos are buffered; False at EOF."""
            nonlocal data, pos, eof
            while pos + k > len(data) and not eof:
                more = f.read(chunk)
                eof = len(more) < chunk
                data = data[pos:] + more     # drop the consumed head
                pos = 0
            return pos + k <= len(data)

        while need(4):
            if data[pos:pos + 3] != b"\x00\x00\x01":
                pos += 1
                continue
            sid = data[pos + 3]
            if sid == 0xBA:                  # pack header
                if not need(14):
                    break
                if (data[pos + 4] >> 6) == 0x01:   # MPEG-2: '01' marker
                    stuffing = data[pos + 13] & 0x07
                    pos += 14 + stuffing
                else:                              # MPEG-1: 12 bytes
                    pos += 12
                continue
            if sid == 0xB9:                  # program end
                break
            if sid < 0xBB:                   # other start codes: skip
                pos += 4
                continue
            if not need(6):
                break
            plen = struct.unpack(">H", data[pos + 4:pos + 6])[0]
            if not need(6 + plen):
                # truncated final packet: keep what arrived
                plen = len(data) - pos - 6
            start = pos + 6
            end = start + plen
            payload = data[start:end]
            if sid != 0xBB and sid != 0xBE and sid != 0xBF:
                # strip PES header from payload
                pts = pes_pts(payload)
                payload = _strip_pes_header(payload)
            else:
                pts = None
            if with_pts:
                yield sid, payload, pts
            else:
                yield sid, payload
            pos = end

    return


def pes_pts(p: bytes) -> "Optional[int]":
    """Extract the PTS (90 kHz ticks) from a PES packet payload (the
    bytes after the 6-byte start code + length), or None."""
    if len(p) < 3:
        return None
    if (p[0] >> 6) == 0x02:                  # MPEG-2 PES
        flags = p[1]
        if not (flags & 0x80) or len(p) < 8:
            return None
        b = p[3:8]
        return (((b[0] >> 1) & 0x7) << 30) | (b[1] << 22) \
            | ((b[2] >> 1) << 15) | (b[3] << 7) | (b[4] >> 1)
    i = 0
    while i < len(p) and p[i] == 0xFF:       # MPEG-1 stuffing
        i += 1
    if i + 1 < len(p) and (p[i] >> 6) == 0x01:
        i += 2
    if i + 4 < len(p) and (p[i] >> 4) in (0x2, 0x3):
        b = p[i:i + 5]
        return (((b[0] >> 1) & 0x7) << 30) | (b[1] << 22) \
            | ((b[2] >> 1) << 15) | (b[3] << 7) | (b[4] >> 1)
    return None


def _strip_pes_header(p: bytes) -> bytes:
    """Remove the MPEG-1/2 PES header, returning the raw payload."""
    if len(p) < 3:
        return b""
    if (p[0] >> 6) == 0x02:                  # MPEG-2 PES
        hdrlen = p[2]
        return p[3 + hdrlen:]
    # MPEG-1: skip stuffing then optional STD + PTS/DTS
    i = 0
    while i < len(p) and p[i] == 0xFF:
        i += 1
    if i + 1 < len(p) and (p[i] >> 6) == 0x01:   # STD buffer size
        i += 2
    if i < len(p):
        flags = p[i] >> 4
        if flags == 0x02:
            i += 5
        elif flags == 0x03:
            i += 10
        else:
            i += 1
    return p[i:]


def extract_video_es(path: str, out_path: str) -> int:
    """tcextract analogue for PS video: concatenate video PES payloads.
    Returns bytes written."""
    total = 0
    with open(out_path, "wb") as out:
        for sid, payload in iter_pes_packets(path):
            if PES_VIDEO_BASE <= sid <= 0xEF:
                out.write(payload)
                total += len(payload)
    return total


def read_video_es(path: str) -> bytes:
    """Whole-file video elementary stream (PS demuxed, ES verbatim)."""
    from tcforge_tpu_torch.io.probe import sniff_magic
    from tcforge_tpu_torch.core.codecs import ContainerFormat
    if sniff_magic(path) == ContainerFormat.MPEG_PS:
        es = bytearray()
        for sid, payload in iter_pes_packets(path):
            if PES_VIDEO_BASE <= sid <= 0xEF:
                es += payload
        return bytes(es)
    with open(path, "rb") as f:
        return f.read()


def es_unit_ranges(es: bytes):
    """Program-stream-unit boundaries: byte ranges of the video ES
    delimited by sequence headers (the seqinfo/PSU notion the
    reference's PSU mode splits on, src/transcode.c:662,
    import/seqinfo.c)."""
    starts = []
    pos = 0
    while True:
        i = es.find(b"\x00\x00\x01\xb3", pos)
        if i < 0:
            break
        starts.append(i)
        pos = i + 4
    if not starts:
        return [(0, len(es))] if es else []
    return [(s, starts[k + 1] if k + 1 < len(starts) else len(es))
            for k, s in enumerate(starts)]


def count_psus(path: str) -> int:
    return len(es_unit_ranges(read_video_es(path)))


# ---------------------------------------------------------------------- #
# DVD LPCM (private stream 1, sub-stream 0xA0-0xA7): uncompressed PCM
# with a 7-byte private header — the one VOB audio codec that needs no
# external library (import_vob's -a LPCM track path).

LPCM_RATES = (48000, 96000, 44100, 32000)


def parse_lpcm_payload(payload: bytes, track: int = 0):
    """Private-stream-1 LPCM packet -> (samples int16 (S, C), rate)
    or None when the sub-stream is not LPCM track ``track``
    (sub-stream id 0xA0 + track — the -a selector).

    Layout: [sub_stream_id][frame_count][first_access_ptr:2]
    [emphasis/mute/frame#][quant(2b) rate(2b) rsvd(1b) channels(3b)]
    [dynamic range] then big-endian samples.  16-bit only (20/24-bit
    words are truncated to 16).
    """
    if len(payload) < 7 or payload[0] != 0xA0 + (track & 7):
        return None
    info = payload[5]
    quant = (info >> 6) & 3
    rate = LPCM_RATES[(info >> 4) & 3]
    channels = (info & 7) + 1
    data = payload[7:]
    if quant == 0:                     # 16-bit big-endian
        import numpy as np
        usable = len(data) // (2 * channels) * (2 * channels)
        pcm = np.frombuffer(data[:usable], ">i2").astype("<i2")
        return pcm.reshape(-1, channels), rate
    raise NotImplementedError(
        f"LPCM: {20 if quant == 1 else 24}-bit sample groups are not "
        "supported (16-bit LPCM decodes; 20/24-bit group packing is "
        "unimplemented)")


def parse_ac3_payload(payload: bytes, track: int = 0):
    """Private-stream-1 AC-3 packet -> raw AC-3 bytes or None.
    Sub-stream id 0x80 + track, then a 3-byte private header
    (frame count + first access unit pointer)."""
    if len(payload) < 4 or payload[0] != 0x80 + (track & 7):
        return None
    return payload[4:]


def parse_vag_payload(payload: bytes):
    """Private-stream-1 PlayStation VAG packet -> raw VAG bytes or
    None.  Sub-stream id 0xFF, then a 3-byte private header the
    reference skips (import_vag.c xread), then ADPCM data (the first
    packet usually starts with an SShd header block)."""
    if len(payload) < 5 or payload[0] != 0xFF:
        return None
    return payload[4:]


def extract_lpcm(path: str):
    """Collect the LPCM track of a VOB/PS -> (pcm (S, C) int16, rate)
    or (None, 0) when absent."""
    import numpy as np
    chunks = []
    rate = 0
    for sid, payload in iter_pes_packets(path):
        if sid == 0xBD:
            got = parse_lpcm_payload(payload)
            if got is not None:
                pcm, rate = got[0], got[1]
                chunks.append(pcm)
    if not chunks:
        return None, 0
    return np.concatenate(chunks), rate
