"""The LZO1X decoder that the pinned ``io/tclzo.py`` reaches as
``native.av.lzo1x_decode``.

The JAX package decompresses transcode's LZO2 frames through libavutil's
``av_lzo1x_decode`` (its FFmpeg bridge); the port loads no FFmpeg, so
this is the same decoder in Python, op for op (libavutil/lzo.c): the
first literal run, M1 to M4 matches with their trailing literal counts
and the end marker.  A stream that reads or copies out of bounds raises
``ValueError``, as the bridge does.
"""

from __future__ import annotations


def lzo1x_decode(data: bytes, max_out: int) -> bytes:
    """LZO1X-decompress ``data`` into at most ``max_out`` bytes."""
    src = memoryview(bytes(data))
    n = len(src)
    out = bytearray()
    pos = 0

    def byte() -> int:
        nonlocal pos
        if pos >= n:
            raise ValueError("lzo: corrupt LZO1X stream (input depleted)")
        pos += 1
        return src[pos - 1]

    def length(x: int, mask: int) -> int:
        cnt = x & mask
        if not cnt:
            x = byte()
            while not x:
                cnt += 255
                x = byte()
            cnt += mask + x
        return cnt

    def literals(cnt: int) -> None:
        nonlocal pos
        if pos + cnt > n or len(out) + cnt > max_out:
            raise ValueError("lzo: corrupt LZO1X stream (literal run)")
        out.extend(src[pos:pos + cnt])
        pos += cnt

    def match(back: int, cnt: int) -> None:
        start = len(out) - back
        if start < 0 or len(out) + cnt > max_out:
            raise ValueError("lzo: corrupt LZO1X stream (back reference)")
        if back >= cnt:
            out.extend(out[start:start + cnt])
        else:                            # overlapping: repeat the period
            period = out[start:]
            reps, rest = divmod(cnt, back)
            out.extend(period * reps + period[:rest])

    state = 0
    x = byte()
    if x > 17:
        literals(x - 17)
        x = byte()
        if x < 16:
            raise ValueError("lzo: corrupt LZO1X stream")
    while True:
        if x > 15:
            if x > 63:
                cnt = (x >> 5) - 1
                back = (byte() << 3) + ((x >> 2) & 7) + 1
            elif x > 31:
                cnt = length(x, 31)
                x = byte()
                back = (byte() << 6) + (x >> 2) + 1
            else:
                cnt = length(x, 7)
                back = (1 << 14) + ((x & 8) << 11)
                x = byte()
                back += (byte() << 6) + (x >> 2)
                if back == 1 << 14:
                    if cnt != 1:
                        raise ValueError("lzo: corrupt LZO1X stream "
                                         "(end marker)")
                    break
        elif not state:
            literals(length(x, 15) + 3)
            x = byte()
            if x > 15:
                continue
            cnt = 1
            back = (1 << 11) + (byte() << 2) + (x >> 2) + 1
        else:
            cnt = 0
            back = (byte() << 2) + (x >> 2) + 1
        match(back, cnt + 2)
        state = cnt = x & 3
        literals(cnt)
        x = byte()
    return bytes(out)
