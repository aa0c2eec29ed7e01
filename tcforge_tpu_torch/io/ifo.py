# Copied from tcforge_tpu/io/ifo.py; only the package name in its imports differs.
"""DVD-Video IFO parsing (decrypted rips) — the navigation slice of
the reference's import_dvd.c/dvd_reader.c (which used libdvdread;
libdvdread's role here splits in two: CSS descrambling, which stays
gated, and IFO table parsing, which is a plain binary format).

Scope: VMG title table (TT_SRPT), VTS part-of-title table
(VTS_PTT_SRPT) and VTS program chains (VTS_PGCIT program maps + cell
playback tables) — ``-T title`` maps onto the VTS VOB concatenation
and ``-T title,chapter`` onto the chapter's cell sector spans (the
tccat -T extraction role).

Layout per the public DVD-Video spec (as mirrored in libdvdread's
ifo_types.h): VMGI_MAT carries a sector pointer to TT_SRPT at offset
0xC4; TT_SRPT entries are 12 bytes (playback type, angles, nr_ptts,
parental id, VTS number, VTS_TTN, title set sector).
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from typing import List, Optional

SECTOR = 2048


@dataclass
class DvdTitle:
    title: int                 # 1-based global title number
    vts: int                   # title set number (VTS_nn)
    vts_ttn: int               # title number inside the VTS
    chapters: int              # nr of PTTs
    angles: int


def _read(path: str, limit: int = 1 << 20) -> bytes:
    with open(path, "rb") as f:
        return f.read(limit)


def parse_tt_srpt(vmg: bytes) -> List[DvdTitle]:
    """Titles from a VIDEO_TS.IFO blob."""
    if vmg[:12] != b"DVDVIDEO-VMG":
        raise ValueError("not a VMG IFO (missing DVDVIDEO-VMG)")
    (tt_sector,) = struct.unpack(">I", vmg[0xC4:0xC8])
    base = tt_sector * SECTOR
    (n_titles,) = struct.unpack(">H", vmg[base:base + 2])
    out: List[DvdTitle] = []
    pos = base + 8
    for i in range(n_titles):
        ent = vmg[pos:pos + 12]
        if len(ent) < 12:
            break
        angles = ent[1]
        (nr_ptts,) = struct.unpack(">H", ent[2:4])
        vts_nr = ent[6]
        vts_ttn = ent[7]
        out.append(DvdTitle(title=i + 1, vts=vts_nr, vts_ttn=vts_ttn,
                            chapters=nr_ptts, angles=angles))
        pos += 12
    return out


def find_video_ts(path: str) -> Optional[str]:
    """Resolve a disc root or VIDEO_TS directory to the VIDEO_TS dir."""
    if os.path.isdir(path):
        base = os.path.basename(os.path.normpath(path)).upper()
        if base == "VIDEO_TS":
            return path
        sub = os.path.join(path, "VIDEO_TS")
        if os.path.isdir(sub):
            return sub
        # case-insensitive fallback
        for name in os.listdir(path):
            if name.upper() == "VIDEO_TS" and \
                    os.path.isdir(os.path.join(path, name)):
                return os.path.join(path, name)
        # a bare directory of VTS files counts too
        if any(re.match(r"(?i)vts_\d\d_\d\.vob$", n)
               for n in os.listdir(path)):
            return path
    return None


def _find_file(ts_dir: str, want: str) -> Optional[str]:
    for name in os.listdir(ts_dir):
        if name.upper() == want.upper():
            return os.path.join(ts_dir, name)
    return None


def list_titles(ts_dir: str) -> List[DvdTitle]:
    vmg = _find_file(ts_dir, "VIDEO_TS.IFO")
    if vmg is None:
        # no VMG: synthesize one title per VTS present
        vts_nrs = sorted({int(m.group(1)) for n in os.listdir(ts_dir)
                          for m in [re.match(r"(?i)vts_(\d\d)_\d\.vob$",
                                             n)] if m})
        return [DvdTitle(title=i + 1, vts=v, vts_ttn=1, chapters=1,
                         angles=1) for i, v in enumerate(vts_nrs)]
    return parse_tt_srpt(_read(vmg))


def title_vobs(ts_dir: str, title: int) -> List[str]:
    """Ordered VOB paths for 1-based title number `title`."""
    titles = list_titles(ts_dir)
    match = next((t for t in titles if t.title == title), None)
    if match is None:
        raise ValueError(
            f"dvd: no title {title} (disc has {len(titles)})")
    vobs = []
    for k in range(1, 10):        # VTS_nn_1.VOB .. VTS_nn_9.VOB
        p = _find_file(ts_dir, f"VTS_{match.vts:02d}_{k}.VOB")
        if p is None:
            break
        vobs.append(p)
    if not vobs:
        raise FileNotFoundError(
            f"dvd: no VOB files for title {title} (VTS_{match.vts:02d})"
            f" in {ts_dir} — encrypted discs need external ripping")
    return vobs


# ------------------------------------------------------------------ #
# VTS-level tables: chapter (PTT) -> PGC/program -> cell sectors
# (layouts per the DVD-Video spec as mirrored in libdvdread's
# ifo_types.h: VTSI_MAT sector pointers at 0xC8 / 0xCC)


@dataclass
class CellSpan:
    first_sector: int
    last_sector: int


@dataclass
class VtsChapters:
    """Per-VTS navigation: chapters[ttn][k] = list of CellSpan."""
    chapters: dict                # (vts_ttn, 1-based ptt) -> [CellSpan]

    def spans(self, vts_ttn: int, ptt: int) -> List[CellSpan]:
        key = (vts_ttn, ptt)
        if key not in self.chapters:
            raise ValueError(f"dvd: no chapter {ptt} in VTS title "
                             f"{vts_ttn}")
        return self.chapters[key]

    def count(self, vts_ttn: int) -> int:
        return sum(1 for (t, _) in self.chapters if t == vts_ttn)


def parse_vts(vts_ifo: bytes) -> VtsChapters:
    if vts_ifo[:12] != b"DVDVIDEO-VTS":
        raise ValueError("not a VTS IFO (missing DVDVIDEO-VTS)")
    (ptt_sector,) = struct.unpack(">I", vts_ifo[0xC8:0xCC])
    (pgcit_sector,) = struct.unpack(">I", vts_ifo[0xCC:0xD0])
    ptt_base = ptt_sector * SECTOR
    pgcit_base = pgcit_sector * SECTOR

    # VTS_PTT_SRPT: per-title arrays of (pgcn, pgn)
    (n_titles,) = struct.unpack(">H", vts_ifo[ptt_base:ptt_base + 2])
    (last_byte,) = struct.unpack(">I",
                                 vts_ifo[ptt_base + 4:ptt_base + 8])
    offs = [struct.unpack(">I", vts_ifo[ptt_base + 8 + 4 * i:
                                        ptt_base + 12 + 4 * i])[0]
            for i in range(n_titles)]
    ends = offs[1:] + [last_byte + 1]
    ptts = {}                     # ttn -> [(pgcn, pgn)]
    for ttn, (off, end) in enumerate(zip(offs, ends), start=1):
        arr = []
        pos = ptt_base + off
        stop = ptt_base + end
        while pos + 4 <= stop:
            pgcn, pgn = struct.unpack(">HH", vts_ifo[pos:pos + 4])
            arr.append((pgcn, pgn))
            pos += 4
        ptts[ttn] = arr

    # VTS_PGCIT: PGCs with program maps + cell playback tables
    (n_pgc,) = struct.unpack(">H", vts_ifo[pgcit_base:pgcit_base + 2])
    pgcs = {}
    for i in range(n_pgc):
        srp = pgcit_base + 8 + 8 * i
        (pgc_off,) = struct.unpack(">I", vts_ifo[srp + 4:srp + 8])
        p = pgcit_base + pgc_off
        nprog = vts_ifo[p + 2]
        ncell = vts_ifo[p + 3]
        (pm_off,) = struct.unpack(">H", vts_ifo[p + 0xE6:p + 0xE8])
        (cp_off,) = struct.unpack(">H", vts_ifo[p + 0xE8:p + 0xEA])
        program_map = [vts_ifo[p + pm_off + j] for j in range(nprog)]
        cells = []
        for c in range(ncell):
            e = p + cp_off + 24 * c
            (first,) = struct.unpack(">I", vts_ifo[e + 8:e + 12])
            (last,) = struct.unpack(">I", vts_ifo[e + 20:e + 24])
            cells.append(CellSpan(first, last))
        pgcs[i + 1] = (program_map, cells)

    chapters = {}
    for ttn, arr in ptts.items():
        for k, (pgcn, pgn) in enumerate(arr, start=1):
            if pgcn not in pgcs:
                continue
            program_map, cells = pgcs[pgcn]
            if not (1 <= pgn <= len(program_map)):
                continue
            first_cell = program_map[pgn - 1]          # 1-based cell
            last_cell = (program_map[pgn]
                         if pgn < len(program_map)
                         else len(cells) + 1)
            spans = [cells[c - 1]
                     for c in range(first_cell, last_cell)
                     if 1 <= c <= len(cells)]
            chapters[(ttn, k)] = spans
    return VtsChapters(chapters)


def chapter_sectors(ts_dir: str, title: int,
                    chapter: int) -> List[CellSpan]:
    """Cell sector spans for 1-based (title, chapter)."""
    titles = list_titles(ts_dir)
    t = next((tt for tt in titles if tt.title == title), None)
    if t is None:
        raise ValueError(f"dvd: no title {title}")
    vts_ifo = _find_file(ts_dir, f"VTS_{t.vts:02d}_0.IFO")
    if vts_ifo is None:
        raise FileNotFoundError(
            f"dvd: VTS_{t.vts:02d}_0.IFO missing — chapter "
            "navigation needs the VTS IFO (whole-title import works)")
    return parse_vts(_read(vts_ifo)).spans(t.vts_ttn, chapter)


def extract_sectors(ts_dir: str, title: int, spans: List[CellSpan],
                    out) -> int:
    """Copy the spans' 2048-byte sectors from the title's VOB set to
    `out` (the tccat -T role); returns bytes written."""
    vobs = title_vobs(ts_dir, title)
    sizes = [os.path.getsize(v) for v in vobs]
    total = 0
    for span in spans:
        start = span.first_sector * SECTOR
        end = (span.last_sector + 1) * SECTOR
        pos = 0
        for v, size in zip(vobs, sizes):
            lo = max(start, pos)
            hi = min(end, pos + size)
            if lo < hi:
                with open(v, "rb") as f:
                    f.seek(lo - pos)
                    remaining = hi - lo
                    while remaining > 0:
                        chunk = f.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        out.write(chunk)
                        total += len(chunk)
                        remaining -= len(chunk)
            pos += size
    return total
