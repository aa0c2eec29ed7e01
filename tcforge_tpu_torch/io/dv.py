# Copied from tcforge_tpu/io/dv.py; only the package name in its imports differs.
"""DV (DIF) container layer (import/extract_dv.c, decode_dv.c
probe_dv analogues).

Implements the DIF structure level of SMPTE 314M / IEC 61834: 80-byte
DIF blocks, 150-block DIF sequences, 10 (525/60) or 12 (625/50)
sequences per frame; frame splitting, header/VAUX/AAUX pack parsing
for probing (geometry, rate, audio parameters), and per-type payload
extraction.  Compressed macroblock *decode* (the VLC/dequant/IDCT in
libdv that the reference links against) is gated — the SMPTE 314M
code tables are not reproducible here — with the DIF demux kept fully
functional so streams can be split, probed, and passed through.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple

DIF_BLOCK = 80
SEQ_BLOCKS = 150
NTSC_SEQS = 10
PAL_SEQS = 12
NTSC_FRAME = NTSC_SEQS * SEQ_BLOCKS * DIF_BLOCK      # 120000
PAL_FRAME = PAL_SEQS * SEQ_BLOCKS * DIF_BLOCK        # 144000

SCT_HEADER = 0
SCT_SUBCODE = 1
SCT_VAUX = 2
SCT_AUDIO = 3
SCT_VIDEO = 4

_FREQ = {0: 48000, 1: 44100, 2: 32000}


def looks_like_dv(head: bytes) -> Optional[bool]:
    """None if not DV; else True for PAL, False for NTSC
    (fileinfo.c's TC_MAGIC_DV_* check: header DIF block ID)."""
    if len(head) < 4:
        return None
    if head[0] != 0x1F or (head[1] & 0x0F) != 0x07 or head[2] != 0x00:
        return None
    return bool(head[3] & 0x80)          # DSF bit


@dataclass
class DvFrameInfo:
    is_pal: bool
    width: int
    height: int
    fps: float
    frame_size: int
    sampling: str                        # '4:1:1' | '4:2:0'
    is_wide: bool = False
    audio_rate: int = 48000
    audio_channels: int = 2
    audio_12bit: bool = False


def block_type(block: bytes) -> int:
    return block[0] >> 5


def iter_dif_blocks(frame: bytes) -> Iterator[Tuple[int, int, int, bytes]]:
    """Yield (sct, seq, blocknum, block) over a frame buffer."""
    for off in range(0, len(frame) - DIF_BLOCK + 1, DIF_BLOCK):
        b = frame[off:off + DIF_BLOCK]
        yield b[0] >> 5, b[1] >> 4, b[2], b


def _find_pack(frame: bytes, sct: int, pack_id: int) -> Optional[bytes]:
    """First 5-byte pack with the given id inside blocks of type sct
    (packs sit in the block payload after the 3-byte DIF id)."""
    for bsct, _seq, _num, b in iter_dif_blocks(frame):
        if bsct != sct:
            continue
        payload = b[3:]
        if sct == SCT_AUDIO:
            # AAUX: one pack in the first 5 payload bytes
            if payload[0] == pack_id:
                return payload[:5]
        else:
            # VAUX: 15 packs of 5 bytes
            for i in range(0, 75, 5):
                if payload[i] == pack_id:
                    return payload[i:i + 5]
    return None


def parse_frame_info(frame: bytes) -> DvFrameInfo:
    is_pal = looks_like_dv(frame[:4])
    if is_pal is None:
        raise ValueError("dv: not a DIF header block")
    info = DvFrameInfo(
        is_pal=is_pal,
        width=720, height=576 if is_pal else 480,
        fps=25.0 if is_pal else 30000 / 1001,
        frame_size=PAL_FRAME if is_pal else NTSC_FRAME,
        sampling="4:2:0" if is_pal else "4:1:1")
    # VAUX VSC pack (0x61): display aspect in the DISP bits
    vsc = _find_pack(frame[:info.frame_size], SCT_VAUX, 0x61)
    if vsc is not None:
        info.is_wide = (vsc[2] & 0x07) == 0x02
    # AAUX AS pack (0x50): sample rate / quantization
    asp = _find_pack(frame[:info.frame_size], SCT_AUDIO, 0x50)
    if asp is not None:
        smp = (asp[4] >> 3) & 0x07
        qu = asp[4] & 0x07
        info.audio_rate = _FREQ.get(smp, 48000)
        info.audio_12bit = qu == 1
        # 12-bit nonlinear carries two channel pairs
        info.audio_channels = 4 if info.audio_12bit else 2
    return info


def iter_frames(f: BinaryIO) -> Iterator[bytes]:
    """Split a raw DV stream into frames (extract_dv.c raw mode: read
    the header, size the frame from DSF, then step frame by frame)."""
    head = f.read(4)
    if not head:
        return
    is_pal = looks_like_dv(head)
    if is_pal is None:
        raise ValueError("dv: stream does not start with a DIF header")
    size = PAL_FRAME if is_pal else NTSC_FRAME
    buf = head + f.read(size - 4)
    while len(buf) == size:
        yield buf
        buf = f.read(size)


def extract_payload(frame: bytes, sct: int) -> bytes:
    """Concatenated payloads of all blocks of one type (tcextract-style
    stream splitting; video payload = the 77 data bytes per block)."""
    out = []
    for bsct, _seq, _num, b in iter_dif_blocks(frame):
        if bsct == sct:
            out.append(b[3:])
    return b"".join(out)


def synth_frame(is_pal: bool = False, audio_rate: int = 48000,
                audio_12bit: bool = False, wide: bool = False) -> bytes:
    """Generate a structurally valid (content-less) DV frame — the
    same trick decode_dv.c:49-150 uses to probe libdv's output
    format.  Block data is 0xFF filler; header/subcode/VAUX/AAUX ids
    and packs are real."""
    nseq = PAL_SEQS if is_pal else NTSC_SEQS
    smp = {48000: 0, 44100: 1, 32000: 2}[audio_rate]
    frame = bytearray()
    for seq in range(nseq):
        blocks: List[bytes] = []
        # header block
        b = bytearray(80)
        b[0:3] = bytes([0x1F, (seq << 4) | 0x07, 0x00])
        b[3] = (0x80 if is_pal else 0x00) | 0x3F
        b[4] = 0x68
        b[5:8] = b"\x78\x78\x78"
        for i in range(8, 80):
            b[i] = 0xFF
        blocks.append(bytes(b))
        # subcode blocks
        for j in range(2):
            b = bytearray(80)
            b[0:3] = bytes([0x3F, (seq << 4) | 0x07, j])
            for i in range(3, 80):
                b[i] = 0xFF
            blocks.append(bytes(b))
        # vaux blocks, VS (0x60) + VSC (0x61) packs in the first one
        for j in range(3):
            b = bytearray(80)
            b[0:3] = bytes([0x5F, (seq << 4) | 0x07, j])
            for i in range(3, 80):
                b[i] = 0xFF
            if j == 0:
                b[3:8] = bytes([0x60, 0xFF, 0xFF,
                                0x20 if is_pal else 0x00, 0xFF])
                b[8:13] = bytes([0x61, 0x3F,
                                 0xC8 | (0x02 if wide else 0x00),
                                 0xFC, 0xFF])
            blocks.append(bytes(b))
        # audio + video blocks interleaved: 9 audio, 135 video
        vnum = 0
        for j in range(9):
            b = bytearray(80)
            b[0:3] = bytes([0x7F, (seq << 4) | 0x07, j])
            b[3:8] = bytes([0x50, 0xD8,
                            0x30,
                            0xD0 if is_pal else 0xC0,
                            (smp << 3) | (1 if audio_12bit else 0)])
            for i in range(8, 80):
                b[i] = 0xFF
            blocks.append(bytes(b))
            for k in range(15):
                b = bytearray(80)
                b[0:3] = bytes([0x9F, (seq << 4) | 0x07, vnum])
                for i in range(3, 80):
                    b[i] = 0xFF
                blocks.append(bytes(b))
                vnum += 1
        frame += b"".join(blocks)
    return bytes(frame)
