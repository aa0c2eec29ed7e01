# Copied from tcforge_tpu/io/vobsub.py; only the package name in its imports differs.
"""VobSub (.idx/.sub) subtitle file pairs.

The reference's extsub consumed subpictures demuxed from the VOB
itself; ripped subtitles usually live in VobSub pairs instead — a
text .idx (palette, geometry, per-language timestamp/filepos table)
plus a .sub that is a plain MPEG program stream of private-stream-1
subpicture packets.  This reader feeds the same SPU decode path
(io/spu.py), so the extsub filter renders either source.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class VobsubLang:
    lang: str
    index: int
    # (timestamp ms, filepos byte offset into the .sub)
    entries: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class VobsubInfo:
    size: Optional[Tuple[int, int]] = None
    palette: List[Tuple[int, int, int]] = field(default_factory=list)
    langs: List[VobsubLang] = field(default_factory=list)


_TS = re.compile(r"(\d+):(\d+):(\d+):(\d+)")


def parse_idx(path: str) -> VobsubInfo:
    info = VobsubInfo()
    cur: Optional[VobsubLang] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(":")
            key = key.strip().lower()
            val = val.strip()
            if key == "size":
                w, _, h = val.partition("x")
                try:
                    info.size = (int(w), int(h))
                except ValueError:
                    pass
            elif key == "palette":
                info.palette = []
                for item in val.split(","):
                    item = item.strip()
                    if len(item) == 6:
                        info.palette.append(
                            (int(item[0:2], 16), int(item[2:4], 16),
                             int(item[4:6], 16)))
            elif key == "id":
                # "id: en, index: 0"
                lang, _, rest = val.partition(",")
                m = re.search(r"index:\s*(\d+)", rest)
                cur = VobsubLang(lang=lang.strip(),
                                 index=int(m.group(1)) if m else
                                 len(info.langs))
                info.langs.append(cur)
            elif key == "timestamp":
                # "timestamp: 00:00:01:000, filepos: 000000000"
                m = _TS.match(val)
                fp = re.search(r"filepos:\s*([0-9a-fA-F]+)", val)
                if m and fp and cur is not None:
                    hh, mm, ss, ms = (int(g) for g in m.groups())
                    t = ((hh * 60 + mm) * 60 + ss) * 1000 + ms
                    cur.entries.append((t, int(fp.group(1), 16)))
    return info


def palette_luma(palette: List[Tuple[int, int, int]]) -> List[int]:
    """16 RGB entries -> BT.601 luma CLUT (what extsub renders
    with)."""
    out = []
    for r, g, b in palette:
        out.append(int(round(0.299 * r + 0.587 * g + 0.114 * b)))
    while len(out) < 16:
        out.append(0)
    return out[:16]


def _find_sub(idx_path: str) -> str:
    """Companion .sub path, tolerating case variants (.SUB etc.)."""
    base = os.path.splitext(idx_path)[0]
    for ext in (".sub", ".SUB", ".Sub"):
        cand = base + ext
        if os.path.exists(cand):
            return cand
    # last resort: scan the directory case-insensitively
    d = os.path.dirname(os.path.abspath(idx_path)) or "."
    want = (os.path.basename(base) + ".sub").lower()
    for name in os.listdir(d):
        if name.lower() == want:
            return os.path.join(d, name)
    return base + ".sub"               # let open() raise cleanly


def _collect_spus_with_offsets(sub_path: str, track: int):
    """[(first_packet_offset, Spu)] from a .sub (bare private-stream-1
    PES concatenation or pack-wrapped PS): a local scan so each
    assembled unit keeps the byte offset the .idx filepos column keys
    on."""
    import struct

    from tcforge_tpu_torch.io import spu as spuio
    # iter_pes_packets has no offset channel: scan packet starts
    # manually (0x000001BD) and parse each PES header locally
    data = open(sub_path, "rb").read()
    out = []
    pending = b""
    pend_off = None
    want = 0x20 + track
    pos = 0
    while True:
        i = data.find(b"\x00\x00\x01\xbd", pos)
        if i < 0 or i + 6 > len(data):
            break
        plen = struct.unpack(">H", data[i + 4:i + 6])[0]
        pkt = data[i:i + 6 + plen]
        pos = i + 6 + plen
        got = list(iter_pes_packets_bytes(pkt))
        for sid, payload in got:
            if sid != 0xBD or not payload or payload[0] != want:
                continue
            chunk = payload[1:]
            if not pending:
                pending = chunk
                pend_off = i
            else:
                pending += chunk
            if len(pending) >= 2:
                total = struct.unpack(">H", pending[:2])[0]
                if total and len(pending) >= total:
                    try:
                        out.append((pend_off,
                                    spuio.decode_spu(pending[:total])))
                    except ValueError:
                        pass
                    pending = b""
    return out


def iter_pes_packets_bytes(pkt: bytes):
    """Parse ONE raw PES packet (header skip identical to the
    program-stream importer's contract): yields (sid, payload)."""
    if len(pkt) < 9 or pkt[:3] != b"\x00\x00\x01":
        return
    sid = pkt[3]
    hdr_len = pkt[8]
    payload = pkt[9 + hdr_len:]
    if payload:
        yield sid, payload


def read_vobsub(idx_path: str, track: int = 0):
    """(spus, info): decode every subpicture unit of language-index
    ``track`` from the .sub program stream; PTS comes from the .idx
    timestamp table (authoritative for ripped subs), keyed by the
    filepos column so a count mismatch cannot shift later cues."""
    info = parse_idx(idx_path)
    sub_path = _find_sub(idx_path)
    lang = next((lg for lg in info.langs if lg.index == track),
                info.langs[0] if info.langs else None)
    stream_track = lang.index if lang is not None else track
    with_off = _collect_spus_with_offsets(sub_path, stream_track)
    if lang is not None:
        by_pos = {fp: ms for ms, fp in lang.entries}
        for off, s in with_off:
            ms = by_pos.get(off)
            if ms is None:
                # pack-wrapped PS: filepos points at the 0x000001BA
                # pack header, the PES follows within the pack
                # header+stuffing (14..~30 bytes)
                for back in range(1, 33):
                    ms = by_pos.get(off - back)
                    if ms is not None:
                        break
            if ms is not None:         # idx ms -> 90 kHz ticks
                s.pts = ms * 90
    return [s for _off, s in with_off], info
