"""The MPEG-2 syntax writer: one coded picture from its macroblock records
and levels.

The port's binding of ``tc_m2e_picture`` in ``csrc/mpeg2encode.cpp`` (a
pinned copy of the JAX package's ``native/mpeg2encode.cpp``), built with
``g++`` at first use by ``ops/_build.build_host`` into ``_build/``, on
the CPU as on a card's host.  The same call as the JAX package's
``native.m2e_picture``: the serial variable-length coding of one
picture, run on the host after the card's block math.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from tcforge_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("mpeg2encode")
    lib.tc_m2e_picture.argtypes = (_I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                   ctypes.POINTER(_P), ctypes.POINTER(_I))
    lib.tc_m2e_picture.restype = _I
    lib.tc_m2e_buf_free.argtypes = (_P,)
    lib.tc_m2e_buf_free.restype = None
    return lib


def m2e_picture(width: int, height: int, pic_type: int, temporal_ref: int,
                qscale_code: int, fcode_f: int, fcode_b: int,
                mbinfo: np.ndarray, levels: np.ndarray,
                flags: int = 0) -> bytes:
    """One MPEG-2 (or, with flag 64, MPEG-1) picture: its picture header
    and extensions, then its slices.  ``mbinfo`` (nmb, 8) int32 macroblock
    records (modes, forward and backward half-pel vectors, cbp), ``levels``
    (nmb, 6, 64) int16 in scan order; ``flags`` the picture-extension bits
    (1 top_field_first, 2 repeat_first_field, 8 alternate scan, 16 and 32
    the field picture's parity, 64 MPEG-1)."""
    lib = _lib()
    mbinfo = np.ascontiguousarray(mbinfo, np.int32).reshape(-1)
    levels = np.ascontiguousarray(levels, np.int16).reshape(-1)
    outp = _P()
    outlen = _I()
    rc = lib.tc_m2e_picture(width, height, pic_type, temporal_ref,
                            qscale_code, fcode_f, fcode_b, flags,
                            mbinfo.ctypes.data, levels.ctypes.data,
                            ctypes.byref(outp), ctypes.byref(outlen))
    if rc != 0:
        raise ValueError(f"mpeg2 picture encode failed (rc={rc})")
    try:
        return ctypes.string_at(outp, outlen.value)
    finally:
        lib.tc_m2e_buf_free(outp)
