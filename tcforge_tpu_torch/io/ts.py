# Copied from tcforge_tpu/io/ts.py; only the package name in its imports differs.
"""MPEG transport stream (ISO 13818-1) demultiplexing.

The windowed-TS equivalent of the reference's ``import/ts_reader.c``
(``ts_read``: PID filter + PES strip into an ES pipe, used by tccat
for TC_MAGIC_TS inputs), extended with PAT/PMT program parsing so the
video PID is found automatically when ``--ts_pid`` isn't given.

Streaming like :func:`tcforge_tpu.io.mpeg.iter_pes_packets`: the file
reads in bounded windows, memory stays O(window).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

TS_PACKET = 188
SYNC = 0x47


def iter_ts_packets(path: str, chunk: int = 1 << 20
                    ) -> Iterator[Tuple[int, bool, bytes]]:
    """Yield (pid, payload_unit_start, payload) per TS packet, skipping
    adaptation fields; resyncs on corrupt input by scanning for 0x47
    at 188-byte periodicity."""
    with open(path, "rb") as f:
        buf = f.read(chunk)
        pos = 0
        eof = len(buf) < chunk
        while True:
            if pos + TS_PACKET > len(buf):
                if eof:
                    return
                more = f.read(chunk)
                eof = len(more) < chunk
                buf = buf[pos:] + more
                pos = 0
                continue
            if buf[pos] != SYNC:
                pos += 1                        # resync scan
                continue
            pkt = buf[pos:pos + TS_PACKET]
            pos += TS_PACKET
            pusi = bool(pkt[1] & 0x40)
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            afc = (pkt[3] >> 4) & 3
            off = 4
            if afc in (2, 3):                   # adaptation field
                off += 1 + pkt[4]
            if afc in (1, 3) and off < TS_PACKET:
                yield pid, pusi, pkt[off:]


def _parse_pat(payload: bytes) -> Dict[int, int]:
    """PAT section -> {program_number: pmt_pid}."""
    if len(payload) < 9:
        return {}
    ptr = payload[0]
    s = payload[1 + ptr:]
    if not s or s[0] != 0x00:                   # table_id PAT
        return {}
    slen = ((s[1] & 0x0F) << 8) | s[2]
    body = s[8:3 + slen - 4]                    # skip hdr, drop CRC
    out = {}
    for i in range(0, len(body) - 3, 4):
        prog = (body[i] << 8) | body[i + 1]
        pid = ((body[i + 2] & 0x1F) << 8) | body[i + 3]
        if prog != 0:
            out[prog] = pid
    return out


def _parse_pmt(payload: bytes) -> Dict[int, int]:
    """PMT section -> {elementary_pid: stream_type}."""
    if len(payload) < 13:
        return {}
    ptr = payload[0]
    s = payload[1 + ptr:]
    if not s or s[0] != 0x02:                   # table_id PMT
        return {}
    slen = ((s[1] & 0x0F) << 8) | s[2]
    pinfo = ((s[10] & 0x0F) << 8) | s[11]
    body = s[12 + pinfo:3 + slen - 4]
    out = {}
    i = 0
    while i + 5 <= len(body):
        stype = body[i]
        epid = ((body[i + 1] & 0x1F) << 8) | body[i + 2]
        eslen = ((body[i + 3] & 0x0F) << 8) | body[i + 4]
        out[epid] = stype
        i += 5 + eslen
    return out


_VIDEO_STREAM_TYPES = (0x01, 0x02)      # MPEG-1 / MPEG-2 video


def find_video_pid(path: str, max_packets: int = 20000) -> Optional[int]:
    """Pick the video PID: PAT->PMT stream_type when present, else the
    first PID whose PES starts with a video stream id (0xE0-0xEF)."""
    pmt_pids: Dict[int, int] = {}
    fallback: Optional[int] = None
    for k, (pid, pusi, payload) in enumerate(iter_ts_packets(path)):
        if k >= max_packets:
            break
        if pid == 0 and pusi:
            pmt_pids.update(_parse_pat(payload))
        elif pid in pmt_pids.values() and pusi:
            for epid, stype in _parse_pmt(payload).items():
                if stype in _VIDEO_STREAM_TYPES:
                    return epid
        elif pusi and len(payload) >= 4 \
                and payload[:3] == b"\x00\x00\x01" \
                and 0xE0 <= payload[3] <= 0xEF and fallback is None:
            fallback = pid
    return fallback


def _strip_pes(payload: bytes) -> bytes:
    """Drop the PES header from a payload that starts one (MPEG-2
    form: stream id + length + flags + header-length)."""
    if len(payload) < 9 or payload[:3] != b"\x00\x00\x01":
        return payload
    hlen = payload[8]
    return payload[9 + hlen:]


def iter_video_es(path: str, pid: Optional[int] = None,
                  chunk: int = 1 << 18) -> Iterator[bytes]:
    """Yield the video elementary stream of one PID in bounded chunks
    (ts_read role: PID filter + PES strip)."""
    if pid is None or pid <= 0:
        pid = find_video_pid(path)
        if pid is None:
            return
    buf = bytearray()
    started = False
    for p, pusi, payload in iter_ts_packets(path):
        if p != pid:
            continue
        if pusi:
            started = True
            payload = _strip_pes(payload)
        elif not started:
            continue                            # mid-PES join point
        buf += payload
        if len(buf) >= chunk:
            yield bytes(buf)
            buf.clear()
    if buf:
        yield bytes(buf)


def sniff_ts(head: bytes) -> bool:
    """True when the head looks like a transport stream: 0x47 sync at
    188-byte periodicity (fileinfo.c TC_MAGIC_TS role)."""
    if len(head) < 2 * TS_PACKET + 1:
        return False
    return (head[0] == SYNC and head[TS_PACKET] == SYNC
            and head[2 * TS_PACKET] == SYNC)


# --------------------------------------------------------------------- #
# writer (test fixture quality: enough to round-trip our own demux and
# feed other TS tools; one program, video only)


def wrap_ts(es: bytes, pid: int = 0x100, with_psi: bool = True) -> bytes:
    """Pack an elementary stream into single-program TS packets."""
    import struct
    import zlib

    def section(table_id: int, body: bytes, ext: int) -> bytes:
        s = bytes([table_id]) + struct.pack(
            ">H", 0xB000 | (len(body) + 9)) + struct.pack(">H", ext) \
            + bytes([0xC1, 0, 0]) + body
        crc = _mpeg_crc32(s)
        return s + struct.pack(">I", crc)

    def packet(p: int, pusi: bool, payload: bytes, counter: int,
               psi: bool = False) -> bytes:
        body = (b"\x00" if psi and pusi else b"") + payload
        pad = TS_PACKET - 4 - len(body)
        hdr = bytes([SYNC, (0x40 if pusi else 0) | (p >> 8), p & 0xFF,
                     0x10 | (counter & 0x0F)])
        if psi:
            return hdr + body + b"\xff" * pad
        if pad > 0:
            # stuffing via adaptation field
            hdr = bytes([hdr[0], hdr[1], hdr[2], hdr[3] | 0x20])
            af = bytes([pad - 1]) + (b"\x00" + b"\xff" * (pad - 2)
                                     if pad > 1 else b"")
            return hdr + af + body
        return hdr + body

    out = bytearray()
    if with_psi:
        pat = section(0x00, struct.pack(">HH", 1, 0xE000 | 0x20), 1)
        pmt_es = bytes([0x02, 0xE0 | (pid >> 8), pid & 0xFF, 0xF0, 0])
        pmt = section(0x02, struct.pack(">H", 0xE000 | pid)
                      + b"\xF0\x00" + pmt_es, 1)
        out += packet(0, True, pat, 0, psi=True)
        out += packet(0x20, True, pmt, 0, psi=True)
    # one PES covering the whole ES (length 0 = unbounded, video-legal)
    pes = b"\x00\x00\x01\xe0\x00\x00" + b"\x80\x00\x00" + es
    counter = 0
    pos = 0
    first = True
    while pos < len(pes):
        take = min(TS_PACKET - 4, len(pes) - pos)
        out += packet(pid, first, pes[pos:pos + take], counter)
        counter = (counter + 1) & 0x0F
        first = False
        pos += take
    return bytes(out)


def _mpeg_crc32(data: bytes) -> int:
    """CRC-32/MPEG-2 (poly 0x04C11DB7, init all-ones, no reflection)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


# stream_type -> codec name for the probe census (ISO 13818-1 table
# 2-29 + common registrations)
TS_STREAM_TYPES = {
    0x01: "mpeg1video", 0x02: "mpeg2video", 0x03: "mp2", 0x04: "mp2",
    0x0F: "aac", 0x11: "aac_latm", 0x1B: "h264", 0x24: "hevc",
    0x81: "ac3", 0x06: "private_pes", 0x0A: "iso13818_6",
}


def scan_programs(path: str, max_packets: int = 20000):
    """PAT/PMT walk -> {elementary_pid: stream_type} for the probe
    (probe_ts role: list every program's elementary streams)."""
    pmt_pids = {}
    streams = {}
    for k, (pid, pusi, payload) in enumerate(iter_ts_packets(path)):
        if k >= max_packets:
            break
        if pid == 0 and pusi:
            pmt_pids.update(_parse_pat(payload))
        elif pid in pmt_pids.values() and pusi:
            streams.update(_parse_pmt(payload))
            if streams and len(pmt_pids) <= 1:
                break
    return streams
