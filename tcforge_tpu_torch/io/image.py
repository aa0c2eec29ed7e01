# Copied from tcforge_tpu/io/image.py; only the package name in its imports differs.
"""Still-image I/O: PPM/PGM/PNM (binary variants) + PNG.

Covers the image halves of the reference's import_im/import_imlist and
encode_im paths for the formats that need no external codec
(GraphicsMagick in the reference; PPM/PGM/PNG here — PNG rides the
stdlib zlib, the full spec filter set implemented both ways).
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Tuple

import numpy as np

_HEADER_RE = re.compile(rb"^(P[456])\s+(?:#[^\n]*\n\s*)*"
                        rb"(\d+)\s+(\d+)\s+(\d+)\s")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


# --------------------------------------------------------------------- #
# PNG


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """Paeth predictor, vectorized (PNG spec 9.4)."""
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) RGB, (H, W, 4) RGBA or (H, W) grayscale uint8 as
    PNG with per-row adaptive filtering (min-sum-of-absolutes)."""
    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    h, w = img.shape[:2]
    bpp = 1 if gray else img.shape[2]
    rows = img.reshape(h, w * bpp)
    prev = np.zeros(w * bpp, np.uint8)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.uint8), cur[:-bpp]])
        b = prev
        c = np.concatenate([np.zeros(bpp, np.uint8), prev[:-bpp]])
        cands = (cur,                                     # 0 none
                 cur - a,                                 # 1 sub
                 cur - b,                                 # 2 up
                 cur - ((a.astype(np.int32)
                         + b.astype(np.int32)) // 2).astype(np.uint8),
                 cur - _paeth(a, b, c))                   # 4 paeth
        # signed-magnitude heuristic from the spec
        best = min(range(5), key=lambda k: int(
            np.abs(cands[k].astype(np.int8).astype(np.int32)).sum()))
        raw.append(best)
        raw += cands[best].tobytes()
        prev = cur
    color = 0 if gray else (6 if bpp == 4 else 2)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(bytes(raw), 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str, keep_alpha: bool = False) -> np.ndarray:
    """Read an 8-bit PNG (gray / gray+alpha / RGB / RGBA / palette;
    no interlace).  Alpha is dropped unless ``keep_alpha`` (then the
    result is always (H, W, 4) RGBA); otherwise (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"not a PNG file: {path}")
    pos = 8
    idat = bytearray()
    w = h = 0
    depth = color = interlace = 0
    palette = None
    while pos + 8 <= len(data):
        (clen,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + clen]
        pos += 12 + clen
        if tag == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} unsupported (8 only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG unsupported")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if nch is None:
        raise ValueError(f"PNG color type {color} unsupported")
    raw = zlib.decompress(bytes(idat))
    stride = w * nch
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    off = 0
    for y in range(h):
        ftype = raw[off]
        cur = np.frombuffer(raw, np.uint8, stride, off + 1).copy()
        off += stride + 1
        if ftype == 1:                 # sub (sequential in x)
            cur32 = cur.astype(np.int32)
            for x in range(nch, stride):
                cur32[x] = (cur32[x] + cur32[x - nch]) & 0xFF
            cur = cur32.astype(np.uint8)
        elif ftype == 2:               # up
            cur = cur + prev
        elif ftype == 3:               # average
            cur32 = cur.astype(np.int32)
            p32 = prev.astype(np.int32)
            for x in range(stride):
                a = cur32[x - nch] if x >= nch else 0
                cur32[x] = (cur32[x] + (a + p32[x]) // 2) & 0xFF
            cur = cur32.astype(np.uint8)
        elif ftype == 4:               # paeth
            cur32 = cur.astype(np.int32)
            p32 = prev.astype(np.int32)
            for x in range(stride):
                a = cur32[x - nch] if x >= nch else 0
                c = p32[x - nch] if x >= nch else 0
                b = p32[x]
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else \
                    (b if pb <= pc else c)
                cur32[x] = (cur32[x] + pred) & 0xFF
            cur = cur32.astype(np.uint8)
        elif ftype != 0:
            raise ValueError(f"PNG filter type {ftype} invalid")
        out[y] = cur
        prev = out[y]
    px = out.reshape(h, w, nch)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        rgb = palette[px[:, :, 0]]
        return _with_alpha(rgb) if keep_alpha else rgb
    if color == 0:
        return _with_alpha(px[:, :, 0]) if keep_alpha else px[:, :, 0]
    if color == 4:                    # gray + alpha
        if keep_alpha:
            g = px[:, :, 0]
            return np.stack([g, g, g, px[:, :, 1]], axis=-1)
        return px[:, :, 0]
    if color == 6 and keep_alpha:
        return px.copy()              # RGBA
    rgb = px[:, :, :3].copy()         # RGB / RGBA (alpha dropped)
    return _with_alpha(rgb) if keep_alpha else rgb


def _with_alpha(img: np.ndarray) -> np.ndarray:
    """Promote (H,W) or (H,W,3) to (H,W,4) RGBA with opaque alpha."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    a = np.full(img.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([img, a], axis=-1)


def read_image(path: str, keep_alpha: bool = False) -> np.ndarray:
    """Read a binary PPM (P6) / PGM (P5) / PBM (P4) / PNG image.

    Returns (H, W, 3) uint8 for color, (H, W) uint8 for grayscale;
    with ``keep_alpha`` always (H, W, 4) RGBA.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        return read_png(path, keep_alpha)
    if (data[:3] == b"\xff\xd8\xff" or data[:2] == b"BM"
            or data[:4] in (b"II*\x00", b"MM\x00*")
            or data[:4] == b"GIF8"):
        # JPEG/BMP/TIFF/GIF via Pillow (the GraphicsMagick role the
        # reference's import_im leaned on)
        import io as _io

        from PIL import Image
        img = Image.open(_io.BytesIO(data))
        if keep_alpha:
            return np.asarray(img.convert("RGBA"))
        if img.mode == "L":
            return np.asarray(img)
        return np.asarray(img.convert("RGB"))
    m = _HEADER_RE.match(data)
    if not m:
        raise ValueError(f"not a binary PNM file: {path}")
    kind = m.group(1).decode()
    w, h = int(m.group(2)), int(m.group(3))
    maxval = int(m.group(4))
    off = m.end()
    if kind == "P6":
        arr = np.frombuffer(data, np.uint8, w * h * 3, off)
        out = arr.reshape(h, w, 3)
    elif kind == "P5":
        arr = np.frombuffer(data, np.uint8, w * h, off)
        out = arr.reshape(h, w)
    else:  # P4 bitmap
        rowbytes = (w + 7) // 8
        arr = np.frombuffer(data, np.uint8, rowbytes * h, off)
        bits = np.unpackbits(arr.reshape(h, rowbytes), axis=1)[:, :w]
        out = ((1 - bits) * 255).astype(np.uint8)
    if maxval != 255 and kind != "P4":
        out = (out.astype(np.uint32) * 255 // maxval).astype(np.uint8)
    return _with_alpha(out) if keep_alpha else out


def write_image(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) as PPM/PNG or (H, W) as PGM/PNG (by
    extension)."""
    img = np.asarray(img, np.uint8)
    if path.lower().endswith(".png"):
        write_png(path, img)
        return
    if path.lower().endswith((".jpg", ".jpeg")):
        from PIL import Image
        Image.fromarray(img).save(path, "JPEG", quality=90)
        return
    if path.lower().endswith((".bmp", ".tif", ".tiff", ".gif")):
        from PIL import Image
        Image.fromarray(img).save(path)
        return
    with open(path, "wb") as f:
        if img.ndim == 3:
            f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        else:
            f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def list_sequence(pattern_or_dir: str) -> List[str]:
    """Expand an image-sequence argument: a directory, a glob, or a
    printf-style pattern (imlist semantics)."""
    import glob
    if os.path.isdir(pattern_or_dir):
        exts = (".ppm", ".pgm", ".pnm", ".pbm", ".png")
        return sorted(os.path.join(pattern_or_dir, f)
                      for f in os.listdir(pattern_or_dir)
                      if f.lower().endswith(exts))
    if "%" in pattern_or_dir:
        out = []
        i = 0
        while True:
            p = pattern_or_dir % i
            if not os.path.exists(p):
                if i > 0:
                    break
                i += 1
                continue
            out.append(p)
            i += 1
        return out
    return sorted(glob.glob(pattern_or_dir))
