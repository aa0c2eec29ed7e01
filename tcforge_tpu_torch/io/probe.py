# Copied from tcforge_tpu/io/probe.py; only the package name in its imports differs.
"""Stream probing: magic sniffing + per-format probers filling the Job.

Rebuild of the reference probe stack: magic signature table
(``import/fileinfo.c:146-220``, 64 TC_MAGIC_* signatures), per-format
probers (``import/probe_*.c``) and the engine-side autoprobe
(``src/probe.c:53-120`` probe_stream_data -> probe_to_vob).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.job import Job
from tcforge_tpu_torch.core import ratiocodes


@dataclass
class ProbeTrack:
    codec: Codec = Codec.UNKNOWN
    bitrate: int = 0
    samplerate: int = 0
    channels: int = 0
    bits: int = 16
    lavf_codec: str = ""          # codec name when only FFmpeg knows it


@dataclass
class ProbeInfo:
    """ProbeInfo analogue (import/tcprobe binary dump payload)."""

    magic: ContainerFormat = ContainerFormat.UNKNOWN
    width: int = 0
    height: int = 0
    fps: float = 0.0
    frc: int = 0
    asr: int = 0
    codec: Codec = Codec.UNKNOWN
    num_frames: int = 0
    is_video: bool = False
    tracks: List[ProbeTrack] = field(default_factory=list)
    format: ImageFormat = ImageFormat.UNKNOWN
    lavf_container: str = ""      # libavformat fallback details
    lavf_vcodec: str = ""
    tc_magic: str = "unknown"     # exact fileinfo.c signature name

    def describe(self) -> str:
        name = self.magic.value
        if self.magic == ContainerFormat.UNKNOWN and self.lavf_container:
            name = f"{self.lavf_container} (lavf)"
        descr = TC_MAGIC_DESCR.get(self.tc_magic)
        if descr and self.tc_magic != "unknown":
            name = f"{name} [{descr}]"
        lines = [f"container: {name}"]
        if self.is_video:
            vcodec = self.lavf_vcodec or self.codec.name.lower()
            lines.append(
                f"video: {vcodec} {self.width}x{self.height}"
                f" @ {self.fps:.3f} fps"
                + (f", {self.num_frames} frames" if self.num_frames else ""))
        for i, t in enumerate(self.tracks):
            acodec = t.lavf_codec or t.codec.name.lower()
            lines.append(f"audio[{i}]: {acodec}"
                         f" {t.samplerate} Hz, {t.channels} ch, {t.bits} bit")
        return "\n".join(lines)


_ASF_GUID = bytes((0x30, 0x26, 0xB2, 0x75, 0x8E, 0x66, 0xCF, 0x11,
                   0xA6, 0xD9, 0x00, 0xAA, 0x00, 0x62, 0xCE, 0x6C))
_MXF_MAGIC = bytes((0x06, 0x0E, 0x2B, 0x34, 0x02, 0x05, 0x01, 0x01))


# filetype() display strings (fileinfo.c:830-895), keyed by the
# lowercase TC_MAGIC_* name sniff_tc_magic returns
TC_MAGIC_DESCR = {
    "ts": "MPEG transport stream (TS)",
    "vob": "MPEG program stream (PS)",
    "mpeg_ps": "MPEG program stream (PS)",
    "m2v": "MPEG elementary stream (ES)",
    "mpeg_es": "MPEG elementary stream (ES)",
    "picext": "MPEG elementary stream (ES)",
    "mpeg": "MPEG packetized elementary stream (PES)",
    "mpeg_pes": "MPEG packetized elementary stream (PES)",
    "avi": "RIFF data, AVI video",
    "wav": "RIFF data, WAVE audio",
    "cdxa": "RIFF data, CDXA",
    "mov": "Apple QuickTime movie file",
    "asf": "advanced streaming format ASF",
    "tiff1": "TIFF image", "tiff2": "TIFF image",
    "jpeg": "JPEG image", "bmp": "BMP image", "png": "PNG image",
    "gif": "GIF image", "ppm": "PPM image", "pgm": "PGM image",
    "sgi": "SGI image", "rmf": "Real Media",
    "xml": "XML file, need to analyze the content",
    "mxf": "The Material eXchange Format",
    "ogg": "OGG Multimedia Container",
    "raw": "RAW stream", "ac3": "AC3 stream", "dts": "DTS stream",
    "mp3": "MPEG-1 layer-3 stream",
    "mp3_2": "MPEG-2 layer-3 stream",
    "mp3_2_5": "MPEG-2.5 layer-3 stream",
    "mp2": "MP2 stream", "id3": "MPEG audio ID3 tag",
    "dv_ntsc": "Digital Video (NTSC)",
    "dv_pal": "Digital Video (PAL)",
    "yuv4mpeg": "YUV4MPEG stream", "nuv": "NuppelVideo stream",
    "vnc": "VNCrec logfile", "pv3": "PV3 video", "pvn": "PVN video",
    "flv": "FLV stream", "bsdav": "bsdav stream",
    "vag": "PlayStation VAG audio",          # this build's extra
    "sunau": "Sun/NeXT audio",               # this build's extra
    "pipe": "pipe/fifo (not seekable)",
    "dir": "directory",
    "unknown": "unknown file type",
}


def _mp_audio_magic(b0: int, b1: int) -> Optional[str]:
    """The 2-byte MPEG-audio syncword family (fileinfo.c:196-231):
    FFFB/FFE3/FFF3 are the explicit MP3 generations, FFFD/FFFC MP2,
    then the masked 0xFFF8==0xFFF0 split on the layer bits."""
    w = (b0 << 8) | b1
    if w == 0xFFFB:
        return "mp3"
    if w == 0xFFE3:
        return "mp3_2_5"
    if w == 0xFFF3:
        return "mp3_2"
    if w in (0xFFFD, 0xFFFC):
        return "mp2"
    if (w & 0xFFF8) == 0xFFF0:
        if b1 & 0x02:
            return "mp3"
        if b1 & 0x01:
            return "mp2"
    return None


def _mp_audio_frame_valid(head: bytes):
    """Validated 4-byte MPEG-audio frame header -> ContainerFormat
    (None when not one).  Catches the syncwords fileinfo.c's explicit
    list misses — CRC-protected MPEG-1 Layer III (0xFFFA), Layer II
    CRC (0xFFF4), and Layer I — while rejecting junk 0xFF runs via
    the version/layer/bitrate/samplerate validity fields."""
    if len(head) < 4 or head[0] != 0xFF or (head[1] & 0xE0) != 0xE0:
        return None
    version = (head[1] >> 3) & 0x03      # 01 = reserved
    layer = (head[1] >> 1) & 0x03        # 00 = reserved
    bitrate = (head[2] >> 4) & 0x0F      # 1111 = invalid
    srate = (head[2] >> 2) & 0x03        # 11 = reserved
    if version == 1 or layer == 0 or bitrate in (0, 0xF) or srate == 3:
        return None
    if layer == 1:                       # Layer III
        return ContainerFormat.MP3_FILE
    return ContainerFormat.MP2_FILE      # Layers I/II


def sniff_tc_magic(head: bytes) -> str:
    """Exact port of the ``fileinfo()`` decision tree
    (``import/fileinfo.c:137-604``) over an in-memory header window
    (caller performs the leading zero-pad skip); returns the
    TC_MAGIC_* key in lowercase ('dv_pal', 'm2v', ...) or 'unknown'.

    Deliberate divergence: the reference tags ANY file whose first
    byte is 0x47 ('G') as a transport stream — which swallows GIF
    images; here the TS branch requires real 188-byte sync structure
    (`io/ts.py sniff_ts`), so GIF survives to its own check.
    """
    if len(head) < 4:
        return "unknown"
    b = head

    # ---- 2-byte section (reads 4) --------------------------------
    if b[0] == 0x0B and b[1] == 0x77:
        return "ac3"
    mp = _mp_audio_magic(b[0], b[1])
    if mp:
        return mp
    if b[:2] == b"MM":
        return "tiff1"
    if b[:2] == b"II":
        return "tiff2"
    if b[:2] == b"BM":
        return "bmp"
    if b[0] == 0x01 and b[1] == 0xDA:
        return "sgi"
    if b[:2] == b"P6":
        return "ppm"
    if b[:2] == b"P5":
        return "pgm"
    from tcforge_tpu_torch.io.ts import sniff_ts
    if b[0] == 0x47 and sniff_ts(head):
        return "ts"

    # ---- 4-byte section ------------------------------------------
    if b[:4] == b"\x7f\xfe\x80\x01":
        return "dts"
    if b[:4] == b"\x00\x00\x01\xba":
        return "vob"
    if b[:3] == b"\x00\x00\x01" and (b[3] & 0xF0) == 0xE0:
        return "mpeg"                    # cmp_28_bits 0x000001Ex
    if b[:4] == b"\x1f\x07\x00\x3f":
        return "dv_ntsc"
    if b[:4] == b"\x1f\x07\x00\xbf":
        return "dv_pal"
    if b[:4] == b"OggS":
        return "ogg"
    if b[:4] == b"\x00\x00\x01\xb3":
        return "m2v"                     # reported as MPEG ES
    if b[:4] == b"Nupp":
        return "nuv"
    if b[:4].lower() == b".rmf":
        return "rmf"
    if b[:4] in (b"PV3\x01", b"PV3\x02"):
        return "pv3"
    if (b[:2] == b"PV" and b[2:3] in b"456" and b[3:4] in b"abdf"):
        return "pvn"
    # MPEG audio sync behind 1-2 bytes of zero padding
    for off in (1, 2):
        if len(b) > off + 1 and b[:off] == b"\x00" * off:
            mp = _mp_audio_magic(b[off], b[off + 1])
            if mp in ("mp3", "mp3_2", "mp3_2_5"):
                return mp
    if b[:4] == b"ID3\x03":
        return "id3"
    if b[:4] == b"ID3\x02":
        return "mp3"                     # iTunes-style ID3v2.2 tag

    # ---- 8-byte section ------------------------------------------
    if b[:8] == b"YUV4MPEG":
        return "yuv4mpeg"
    if b[:5] == b"BSDAV":
        return "bsdav"
    if len(b) >= 8 and b[4:8].lower() in (b"moov", b"cmov", b"mdat",
                                          b"ftyp", b"pnot"):
        return "mov"
    if b[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if b[:6].lower() in (b"gif87a", b"gif89a"):
        return "gif"
    if b[:5].lower() == b"<?xml":
        return "xml"
    if b[:6].lower() == b"vnclog":
        return "vnc"
    if len(b) >= 6 and b[:3] == b"FLV" and b[5] == 0:
        return "flv"

    # ---- 12-byte section -----------------------------------------
    if b[:9] == b"YUV4MPEG2":
        return "yuv4mpeg"
    if len(b) >= 12 and b[:4].lower() == b"riff":
        tag = b[8:12].lower()
        if tag == b"avi ":
            return "avi"
        if tag == b"wave":
            return "wav"
        if tag == b"cdxa":
            return "cdxa"
    if b[:2] == b"\xff\xd8":
        return "jpeg"                    # JFIF check subsumed

    # ---- 16-byte section -----------------------------------------
    if b[:16] == _ASF_GUID:
        return "asf"
    if b[:8] == _MXF_MAGIC:
        return "mxf"
    if len(b) >= 16 and b[12:16].lower() in (b"moov", b"cmov",
                                             b"mdat", b"pnot"):
        return "mov"

    # ---- deep scan: raw DV DIF stream (scan_header_dv role) ------
    k = head.find(b"\x1f\x07\x00")
    if 0 <= k < 4096 and k % 80 == 0 and len(head) > k + 3:
        return "dv_pal" if head[k + 3] & 0x80 else "dv_ntsc"
    return "unknown"


# lowercase TC_MAGIC key -> the coarse routing enum
_MAGIC_TO_FORMAT = {
    "ac3": ContainerFormat.AC3_FILE,
    "mp3": ContainerFormat.MP3_FILE,
    "mp3_2": ContainerFormat.MP3_FILE,
    "mp3_2_5": ContainerFormat.MP3_FILE,
    "id3": ContainerFormat.MP3_FILE,
    "mp2": ContainerFormat.MP2_FILE,
    "tiff1": ContainerFormat.IMAGES,
    "tiff2": ContainerFormat.IMAGES,
    "bmp": ContainerFormat.IMAGES,
    "png": ContainerFormat.IMAGES,
    "gif": ContainerFormat.IMAGES,
    "jpeg": ContainerFormat.IMAGES,
    "sgi": ContainerFormat.SGI_IMAGE,
    "ppm": ContainerFormat.PPM_STREAM,
    "pgm": ContainerFormat.PPM_STREAM,
    "ts": ContainerFormat.MPEG_TS,
    "dts": ContainerFormat.DTS_FILE,
    "vob": ContainerFormat.MPEG_PS,
    "mpeg": ContainerFormat.MPEG_PES,
    "dv_ntsc": ContainerFormat.DV_FILE,
    "dv_pal": ContainerFormat.DV_FILE,
    "ogg": ContainerFormat.OGG,
    "m2v": ContainerFormat.MPEG_ES,
    "nuv": ContainerFormat.NUV,
    "rmf": ContainerFormat.RMF,
    "pv3": ContainerFormat.PV3,
    "pvn": ContainerFormat.PVN,
    "yuv4mpeg": ContainerFormat.YUV4MPEG,
    "bsdav": ContainerFormat.BSDAV,
    "mov": ContainerFormat.MOV,
    "xml": ContainerFormat.XML,
    "vnc": ContainerFormat.VNC_LOG,
    "flv": ContainerFormat.FLV,
    "avi": ContainerFormat.AVI,
    "wav": ContainerFormat.WAV,
    "cdxa": ContainerFormat.CDXA,
    "asf": ContainerFormat.ASF,
    "mxf": ContainerFormat.MXF,
}


def read_magic_head(path: str, want: int = 4096) -> bytes:
    """Read the probe window with the leading zero-padding skip VOB
    rips often need (fileinfo.c:166-177: 4-byte zero groups up to
    TC_MAX_SEEK_BYTES)."""
    with open(path, "rb") as f:
        head = f.read(want)
        if head[:4] == b"\x00\x00\x00\x00":
            skipped = 0
            while (head[:4] == b"\x00\x00\x00\x00"
                   and skipped < (1 << 20)):
                nz = 0
                while (nz + 4 <= len(head)
                       and head[nz:nz + 4] == b"\x00\x00\x00\x00"):
                    nz += 4
                skipped += nz
                head = head[nz:] + f.read(nz)
            if len(head) < want:
                head += f.read(want - len(head))
    return head


def sniff_magic(path: str) -> ContainerFormat:
    """Header magic detection: the exact fileinfo.c decision tree
    (``sniff_tc_magic``) first, then this build's extra signatures
    (VAG, SunAU, NuppelVideo string header, PES subtypes, ...)."""
    return sniff_magic_head(read_magic_head(path))


def sniff_magic_head(head: bytes) -> ContainerFormat:
    """``sniff_magic`` over an already-read header window (probe_file
    reads the window once and feeds both sniffers)."""
    if len(head) < 4:
        return ContainerFormat.UNKNOWN
    tc = sniff_tc_magic(head)
    # ADTS AAC carries 0xFFFx sync with LAYER BITS 00 — invalid for
    # MPEG audio, so fileinfo.c's word list mislabels it MP2; a
    # validated ADTS header wins (deliberate divergence, like TS/GIF)
    if tc in ("mp2", "mp3", "mp3_2", "mp3_2_5") and len(head) >= 9 \
            and (head[1] & 0x06) == 0:
        from tcforge_tpu_torch.io.aacdec import parse_adts_header
        if parse_adts_header(head[:9]) is not None:
            return ContainerFormat.AAC_FILE
    fmt = _MAGIC_TO_FORMAT.get(tc)
    if fmt is not None:
        return fmt
    # ---- this build's extra signatures (beyond fileinfo.c) -------
    if head[:4] in (b"\x00\x00\x01\xb0", b"\x00\x00\x01\xb5"):
        # b5 = extension start (TC_MAGIC_PICEXT): an ES cut mid-GOP
        return ContainerFormat.MPEG_ES
    if head[:3] == b"\x00\x00\x01" and head[3:4] == b"\xc0":
        return ContainerFormat.MPEG_PES   # audio-first PES
    if head[:3] == b"\x1f\x07\x00":
        return ContainerFormat.DV_FILE
    if head[:4] == b".snd":
        return ContainerFormat.SUNAU
    if head[:3] == b"ID3":
        return ContainerFormat.MP3_FILE   # ID3v2.4/other versions
    # Full MPEG-audio frame-header check: the fileinfo.c word list
    # misses the CRC-protected MPEG-1 generations (0xFFFA Layer III,
    # 0xFFF4/0xFFF5 Layer II) and all Layer I words; validate the
    # whole 4-byte header (version/layer/bitrate/samplerate fields)
    # so stray 0xFF bytes don't false-positive
    mp = _mp_audio_frame_valid(head)
    if mp is not None:
        return mp
    # MP2 sync behind 1-2 zero-pad bytes (the reference's padded
    # checks cover only the MP3 generations)
    for off in (1, 2):
        if (len(head) > off + 1 and head[:off] == b"\x00" * off
                and _mp_audio_magic(head[off], head[off + 1]) == "mp2"):
            return ContainerFormat.MP2_FILE
    if len(head) >= 12 and head[4:8] in (b"wide", b"free"):
        return ContainerFormat.MOV
    if head[:2] == b"P4":
        return ContainerFormat.PPM_STREAM
    if head.lstrip()[:5] in (b"<?xml", b"<smil"):
        return ContainerFormat.XML
    if head[:11] == b"NuppelVideo":
        return ContainerFormat.NUV
    if head[:4] in (b"VAGp", b"SShd"):
        return ContainerFormat.VAG
    if head[:4] == b"fLaC":
        return ContainerFormat.FLAC_FILE
    # ADTS AAC: sync 0xFFF with layer bits 00 (MPEG audio layers use
    # 01/10/11 there, so this cannot shadow the mp1/2/3 checks above)
    if len(head) >= 9 and head[0] == 0xFF and (head[1] & 0xF6) == 0xF0:
        from tcforge_tpu_torch.io.aacdec import parse_adts_header
        h = parse_adts_header(head[:9])
        if h is not None and h["channels"]:
            return ContainerFormat.AAC_FILE
    return ContainerFormat.UNKNOWN


_FOURCC_FORMAT = {
    "I420": ImageFormat.YUV420P,
    "IYUV": ImageFormat.YUV420P,
    "YV12": ImageFormat.YV12,
    "YUY2": ImageFormat.YUY2,
    "UYVY": ImageFormat.UYVY,
    "YVYU": ImageFormat.YVYU,
    "RGB": ImageFormat.RGB24,
    "DIB": ImageFormat.RGB24,
    "": ImageFormat.RGB24,
}

_FOURCC_CODEC = {
    "I420": Codec.YUV420P, "IYUV": Codec.YUV420P, "YV12": Codec.YV12,
    "YUY2": Codec.YUY2, "UYVY": Codec.UYVY,
}


def _probe_avi(path: str, info: ProbeInfo) -> None:
    from tcforge_tpu_torch.io.avi import AviReader
    with AviReader(path) as r:
        info.is_video = True
        info.width, info.height = r.video.width, r.video.height
        info.fps = r.video.fps
        info.num_frames = r.video_frames
        fcc = r.video.fourcc.strip().upper()
        info.format = _FOURCC_FORMAT.get(fcc, ImageFormat.UNKNOWN)
        from tcforge_tpu_torch.core.codecs import codec_from_fourcc
        info.codec = _FOURCC_CODEC.get(
            fcc, codec_from_fourcc(fcc) if fcc else Codec.RGB24)
        if info.codec == Codec.UNKNOWN and info.format != ImageFormat.UNKNOWN:
            info.codec = Codec.RAW
        for a in r.audio:
            info.tracks.append(ProbeTrack(
                codec={1: Codec.PCM, 0x50: Codec.MP2, 0x55: Codec.MP3,
                       0xFF: Codec.AAC, 0x2000: Codec.AC3}.get(
                    a.format_tag, Codec.UNKNOWN),
                samplerate=a.rate, channels=a.channels, bits=a.bits))


def _probe_y4m(path: str, info: ProbeInfo) -> None:
    from tcforge_tpu_torch.io.y4m import Y4MReader
    with Y4MReader(path) as r:
        h = r.header
        info.is_video = True
        info.width, info.height = h.width, h.height
        info.fps = h.fps
        info.codec = Codec.YUV4MPEG
        info.format = h.format
        # frame count from file size (fixed frame stride)
        size = os.path.getsize(path)
        stride = h.frame_bytes + 6  # "FRAME\n"
        hdr_len = len(h.to_line())
        if size > hdr_len:
            info.num_frames = (size - hdr_len) // stride


def _probe_wav(path: str, info: ProbeInfo) -> None:
    from tcforge_tpu_torch.io.wav import WavReader
    with WavReader(path) as r:
        info.tracks.append(ProbeTrack(
            codec=Codec.PCM, samplerate=r.info.rate,
            channels=r.info.channels, bits=r.info.bits))


def probe_file(path: str, probe_mb: int = 0) -> ProbeInfo:
    """probe_stream_data analogue: sniff + deep probe.

    probe_mb: -H hint — how deep (MB) byte-scanning probers may look.
    """
    info = ProbeInfo()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    head = read_magic_head(path)      # ONE read feeds both sniffers
    info.magic = sniff_magic_head(head)
    info.tc_magic = sniff_tc_magic(head)
    if info.tc_magic == "unknown" and \
            info.magic is not ContainerFormat.UNKNOWN:
        info.tc_magic = info.magic.value    # build-extra signature
    if info.magic == ContainerFormat.AVI:
        _probe_avi(path, info)
    elif info.magic == ContainerFormat.YUV4MPEG:
        _probe_y4m(path, info)
    elif info.magic == ContainerFormat.WAV:
        _probe_wav(path, info)
    elif info.magic in (ContainerFormat.MPEG_PS,
                        ContainerFormat.MPEG_ES):
        from tcforge_tpu_torch.io.mpeg import probe_mpeg
        probe_mpeg(path, info,
                   limit=(probe_mb << 20) if probe_mb else 2 << 20)
    elif info.magic == ContainerFormat.MPEG_TS:
        # transport stream: extract a little video ES first (the
        # sequence header may straddle TS packet payloads)
        from tcforge_tpu_torch.io import ts as tsio
        from tcforge_tpu_torch.io.mpeg import SEQ_START, parse_sequence_header
        es = b""
        for chunk in tsio.iter_video_es(path):
            es += chunk
            if len(es) >= (1 << 16):
                break
        pos = es.find(SEQ_START)
        if pos >= 0:
            seq = parse_sequence_header(es[pos + 4:pos + 16])
            if seq:
                info.is_video = True
                (info.width, info.height, info.asr, info.fps) = seq
                info.codec = Codec.MPEG2
        # PMT census: report the audio elementary streams too
        try:
            for epid, stype in sorted(
                    tsio.scan_programs(path).items()):
                name = tsio.TS_STREAM_TYPES.get(stype, "")
                if name in ("mp2", "aac", "aac_latm", "ac3"):
                    info.tracks.append(ProbeTrack(
                        codec={"mp2": Codec.MP2, "ac3": Codec.AC3,
                               }.get(name, Codec.AAC),
                        lavf_codec=name))
        except Exception:
            pass
    elif info.magic == ContainerFormat.FLAC_FILE:
        from tcforge_tpu_torch.io.flac import parse_streaminfo
        with open(path, "rb") as f:
            blob = f.read(1 << 16)
        pos = 4
        while pos + 4 <= len(blob):
            hdr = blob[pos]
            ln = int.from_bytes(blob[pos + 1:pos + 4], "big")
            if hdr & 0x7F == 0 and pos + 4 + ln <= len(blob):
                si = parse_streaminfo(blob[pos + 4:pos + 4 + ln])
                info.tracks.append(ProbeTrack(
                    codec=Codec.FLAC, samplerate=si["rate"],
                    channels=si["channels"], bits=si["bps"]))
                break
            if hdr >> 7:
                break
            pos += 4 + ln
    elif info.magic == ContainerFormat.AAC_FILE:
        from tcforge_tpu_torch.io.aacdec import (SAMPLE_RATES as _AAC_RATES,
                                           parse_adts_header)
        with open(path, "rb") as f:
            head9 = f.read(9)
        h = parse_adts_header(head9)
        if h is not None:
            info.tracks.append(ProbeTrack(
                codec=Codec.AAC, samplerate=_AAC_RATES[h["sfi"]],
                channels=h["channels"], bits=16))
    elif info.magic == ContainerFormat.SUNAU:
        from tcforge_tpu_torch.io.au import AuReader
        try:
            with AuReader(path) as r:
                info.tracks.append(ProbeTrack(
                    codec=Codec.PCM, samplerate=r.rate,
                    channels=r.channels,
                    bits=16 if r.encoding == 3 else 8))
        except (ValueError, NotImplementedError):
            pass
    elif info.magic == ContainerFormat.VAG:
        from tcforge_tpu_torch.io.vag import parse_header as _vag_hdr
        with open(path, "rb") as f:
            got = _vag_hdr(f.read(64))
        if got is not None:
            info.tracks.append(ProbeTrack(
                codec=(Codec.PCM if got.is_pcm else Codec.VAG),
                samplerate=got.rate, channels=got.channels, bits=16))
    elif info.magic == ContainerFormat.DV_FILE:
        from tcforge_tpu_torch.io import dv as dvio
        with open(path, "rb") as f:
            frame = f.read(dvio.PAL_FRAME)
        d = dvio.parse_frame_info(frame)
        info.is_video = True
        info.width, info.height = d.width, d.height
        info.fps = d.fps
        info.codec = Codec.DV
        info.asr = 3 if d.is_wide else 2
        try:
            sz = os.path.getsize(path)
            info.num_frames = sz // d.frame_size
        except OSError:
            pass
        info.tracks.append(ProbeTrack(
            codec=Codec.PCM, samplerate=d.audio_rate,
            channels=2, bits=16))
    elif info.magic == ContainerFormat.OGG:
        from tcforge_tpu_torch.io.ogg import identify_streams
        with open(path, "rb") as f:
            streams = identify_streams(f)
        for s in streams:
            if s.kind == "video" and not info.is_video:
                info.is_video = True
                info.width, info.height = s.width, s.height
                info.fps = s.fps
                info.codec = (Codec.THEORA if s.codec == "theora"
                              else Codec.UNKNOWN)
            elif s.kind == "audio":
                info.tracks.append(ProbeTrack(
                    codec=(Codec.VORBIS if s.codec == "vorbis"
                           else Codec.SPEEX if s.codec == "speex"
                           else Codec.FLAC if s.codec == "flac"
                           else Codec.UNKNOWN),
                    samplerate=s.samplerate, channels=s.channels,
                    bits=s.bits or 16))
    elif info.magic == ContainerFormat.MOV:
        from tcforge_tpu_torch.io.mov import MovReader
        with MovReader(path) as r:
            v, a = r.video, r.audio
            if v is not None:
                info.is_video = True
                info.width, info.height = v.width, v.height
                info.fps = v.fps
                info.num_frames = v.n_samples
                fcc = v.fourcc.lower()
                if fcc in ("yv12", "y420"):
                    info.format = ImageFormat.YUV420P
                    info.codec = Codec.YUV420P
                elif fcc in ("2vuy", "yuv2"):
                    info.format = ImageFormat.UYVY
                    info.codec = Codec.UYVY
                elif fcc in ("jpeg", "mjpa"):
                    info.format = ImageFormat.RGB24
                    info.codec = Codec.MJPEG
                else:
                    info.format = ImageFormat.RGB24
                    info.codec = Codec.RGB24
            if a is not None:
                info.tracks.append(ProbeTrack(
                    codec=Codec.PCM, samplerate=a.samplerate,
                    channels=a.channels, bits=a.bits))
    elif info.magic == ContainerFormat.PVN:
        from tcforge_tpu_torch.io import pvn
        with open(path, "rb") as f:
            hdr = pvn.read_header(f)
        info.is_video = True
        info.width, info.height = hdr.width, hdr.height
        info.fps = hdr.framerate
        info.num_frames = hdr.nframes
        info.codec = Codec.RGB24
        info.format = (ImageFormat.RGB24 if hdr.channels == 3
                       else ImageFormat.GRAY8)
    if info.magic == ContainerFormat.UNKNOWN:
        # libavformat fallback (mkv/webm/flv/whatever the bundled
        # FFmpeg demuxes) — the probe result still drives module
        # selection (ffmpeg importer)
        try:
            from tcforge_tpu_torch.native import av as _av
            got = _av.fmtprobe(path)
        except Exception:
            got = None
        if got:
            info.lavf_container = got.get("container", "")
            for v in got["video"][:1]:
                info.is_video = True
                info.width, info.height = v["width"], v["height"]
                info.fps = v["fps"]
                info.lavf_vcodec = v["codec"]
            for a in got["audio"]:
                info.tracks.append(ProbeTrack(
                    codec=Codec.UNKNOWN, samplerate=a["rate"],
                    channels=a["channels"], bits=16,
                    lavf_codec=a["codec"]))
    if info.fps > 0:
        code = ratiocodes.frc_code_from_value(info.fps)
        info.frc = code if code is not None else 0
    return info


def probe_to_job(info: ProbeInfo, job: Job) -> Job:
    """probe_to_vob analogue (src/probe.c:395): fill the job record."""
    if info.is_video:
        job.im_v_width = info.width
        job.im_v_height = info.height
        if info.fps > 0:
            job.fps = info.fps
        job.im_frc = info.frc
        job.im_v_codec = info.codec
        job.im_v_format = info.magic
        if not (info.format.is_planar or info.format
                == ImageFormat.UNKNOWN) and not info.format.is_rgb:
            # packed YUV source: keep the packed layout internal
            job.im_colorspace = info.format
        # RGB sources stay at the -V internal colorspace; the engine
        # flips to RGB passthrough only when the muxer can take RGB
        if info.num_frames and job.max_frames is None:
            job.max_frames = info.num_frames
    if info.tracks:
        t = info.tracks[0]
        job.a_rate = t.samplerate or job.a_rate
        job.a_chan = t.channels or job.a_chan
        job.a_bits = t.bits or job.a_bits
        job.im_a_codec = t.codec
    return job
