"""Wrappers of the port's CUDA kernels, each beside its plain version.

=========================  ==========================  =====================
wrapper                    CUDA source                 replaces (tcforge_tpu)
=========================  ==========================  =====================
``spatial_scan``           ``csrc/hqdn3d_scan.cu``     ops/kernels.py
                                                       ``spatial_scan`` "hq"
``temporal_scan``          ``csrc/hqdn3d_scan.cu``     ops/kernels.py
                                                       ``temporal_scan``
``zoom_pass``              ``csrc/zoom_pass.cu``       ops/kernels.py
                                                       ``zoom_pass_pallas``
=========================  ==========================  =====================

Each wrapper checks device, dtype, shape and contiguity and raises on
what its kernel does not take.  A tensor on the CPU goes to the plain
torch version (``*_ref``), which the CPU tests hold against JAX; a CUDA
tensor launches the kernel on the current stream, or raises.  Nothing
falls back.  ``launches`` counts the kernel launches of each wrapper,
so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import torch

from tcforge_tpu_torch.ops import _build

LUT_SIZE = 8192

# kernel launches per wrapper since the last reset_launches()
launches: Dict[str, int] = {"hqdn3d_spatial_scan": 0,
                            "hqdn3d_temporal_scan": 0,
                            "zoom_pass": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class Band(NamedTuple):
    """A resample pass's contributor bands (ops/zoom.py band_table,
    which checks that every band lies inside the ``oldsize`` source
    samples): int32 (new,) first source index, int32 (new,) tap count
    and int32 (new, maxtaps) zero-padded 16.16 weights."""

    first: torch.Tensor
    taps: torch.Tensor
    weights: torch.Tensor
    oldsize: int


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hqdn3d_scan": {
        "tc_hqdn3d_spatial_scan": (_P, _I, _P, _P, _LL, _LL, _LL, _LL, _LL,
                                   _I, _P),
        "tc_hqdn3d_temporal_scan": (_P, _P, _P, _P, _P, _I, _LL, _P),
    },
    "zoom_pass": {
        "tc_zoom_pass": (_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P),
    },
}


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.tc_error_string.argtypes = (ctypes.c_int,)
    lib.tc_error_string.restype = ctypes.c_char_p
    return lib


def _call(lib_name: str, fn: str, *args) -> None:
    lib = _lib(lib_name)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}: "
                           f"{lib.tc_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises for a mix or
    any other device."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, kinds))}")
    dev = kinds.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check(t: torch.Tensor, what: str, dtypes, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, "
                        f"got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-D, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check_lut(lut: torch.Tensor) -> None:
    _check(lut, "lut", (torch.int32,), 1)
    if lut.shape[0] != LUT_SIZE:
        raise ValueError(f"lut: expected {LUT_SIZE} entries, "
                         f"got {lut.shape[0]}")


def _lut_index(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """LowPassMul's table index (filter_hqdn3d.c:49-54), clamped to the
    table as the kernel clamps it (a no-op for uint8-derived input)."""
    return ((prev - curr + 0x10007FF) >> 12).clamp_(0, LUT_SIZE - 1).long()


def _scan_dim(axis: int) -> int:
    if axis not in (-1, -2, 1, 2):
        raise ValueError("axis must be -1 (along W) or -2 (along H), "
                         f"got {axis}")
    return axis % 3


# --------------------------------------------------------------------- #
# Kernel 1: hqdn3d spatial IIR scan (H and V passes)

def spatial_scan_ref(x: torch.Tensor, lut: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Plain version of ``spatial_scan`` (hqdn3d.py:94-116)."""
    dim = _scan_dim(axis)
    f = x.to(torch.int32) << 16 if x.dtype == torch.uint8 else x
    out = torch.empty_like(f)
    prev = f.select(dim, 0)
    out.select(dim, 0).copy_(prev)
    for s in range(1, f.shape[dim]):
        curr = f.select(dim, s)
        prev = curr + lut[_lut_index(prev, curr)]
        out.select(dim, s).copy_(prev)
    return out


def spatial_scan(x: torch.Tensor, lut: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """hqdn3d spatial pass over (N, H, W): ``out[0] = x[0]``,
    ``out[s] = x[s] + lut[(out[s-1] - x[s] + 0x10007FF) >> 12]`` along
    ``axis`` (-1: H pass along W, -2: V pass along H).  ``x`` is uint8
    frames (shifted to the 16.16 domain on load) or int32; the result
    is int32 (N, H, W)."""
    _check(x, "x", (torch.uint8, torch.int32), 3)
    _check_lut(lut)
    dim = _scan_dim(axis)
    if not _on_cuda(x, lut):
        return spatial_scan_ref(x, lut, axis)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    n, h, w = x.shape
    if dim == 2:     # lines (n, y), contiguous along the line
        geom = (n * h, n * h, 0, w, 1, w)
    else:            # lines (n, x), stride W along the line
        geom = (n * w, w, h * w, 1, w, h)
    _call("hqdn3d_scan", "tc_hqdn3d_spatial_scan", x.data_ptr(),
          int(x.dtype == torch.uint8), out.data_ptr(), lut.data_ptr(),
          *geom, _stream(x))
    launches["hqdn3d_spatial_scan"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel 2: hqdn3d temporal scan with the FrameAnt carry

def temporal_scan_ref(v: torch.Tensor, ant: torch.Tensor, lut: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``temporal_scan`` (hqdn3d.py:118-126)."""
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    for i in range(v.shape[0]):
        dst = v[i] + lut[_lut_index(ant << 8, v[i])]
        ant = ((dst + 0x1000007F) >> 8) & 0xFFFF
        out[i] = ((dst + 0x10007FFF) >> 16) & 0xFF
    return out, ant


def temporal_scan(v: torch.Tensor, ant: torch.Tensor, lut: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hqdn3d temporal pass: per pixel, over the N frames of the int32
    (N, H, W) V-pass output, ``dst = lpm(ant << 8, v)``, carry
    ``ant = ((dst + 0x1000007F) >> 8) & 0xFFFF`` and emit
    ``((dst + 0x10007FFF) >> 16) & 0xFF``.  ``ant`` is the int32 (H, W)
    FrameAnt; returns (uint8 (N, H, W), new int32 FrameAnt)."""
    _check(v, "v", (torch.int32,), 3)
    _check(ant, "ant", (torch.int32,), 2)
    _check_lut(lut)
    if tuple(ant.shape) != tuple(v.shape[1:]):
        raise ValueError(f"ant shape {tuple(ant.shape)} != plane "
                         f"{tuple(v.shape[1:])}")
    if not _on_cuda(v, ant, lut):
        return temporal_scan_ref(v, ant, lut)
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    ant_out = torch.empty_like(ant)
    if v.numel() == 0:
        return out, ant_out.copy_(ant)
    n, h, w = v.shape
    _call("hqdn3d_scan", "tc_hqdn3d_temporal_scan", v.data_ptr(),
          ant.data_ptr(), out.data_ptr(), ant_out.data_ptr(),
          lut.data_ptr(), n, h * w, _stream(v))
    launches["hqdn3d_temporal_scan"] += 1
    return out, ant_out


# --------------------------------------------------------------------- #
# Kernel 3: one exact resample pass of the zoom

def _check_band(band: Band, old: int) -> Tuple[int, int]:
    _check(band.first, "band.first", (torch.int32,), 1)
    _check(band.taps, "band.taps", (torch.int32,), 1)
    _check(band.weights, "band.weights", (torch.int32,), 2)
    new = band.weights.shape[0]
    if band.first.shape[0] != new or band.taps.shape[0] != new:
        raise ValueError("band tables disagree on the output size")
    if band.oldsize != old:
        raise ValueError(f"band made for {band.oldsize} source samples, "
                         f"plane has {old}")
    return new, band.weights.shape[1]


def zoom_pass_ref(img: torch.Tensor, band: Band, axis: int) -> torch.Tensor:
    """Plain version of ``zoom_pass``: the same band sums, one tap at a
    time over the whole plane (zoom.py ``_apply_pass_exact``)."""
    dim = _scan_dim(axis)
    first, weights = band.first, band.weights
    src = img.to(torch.int32)
    shape = list(img.shape)
    shape[dim] = weights.shape[0]
    acc = torch.zeros(shape, dtype=torch.int32, device=img.device)
    last = img.shape[dim] - 1
    for k in range(weights.shape[1]):
        # padded taps weigh 0; the clamp only keeps their index valid
        cols = src.index_select(dim, (first + k).clamp(max=last))
        wk = weights[:, k]
        acc += cols * (wk if dim == 2 else wk[:, None])
    return ((acc + 0x8000) >> 16).clamp_(0, 255).to(torch.uint8)


def zoom_pass(img: torch.Tensor, band: Band, axis: int) -> torch.Tensor:
    """One exact resample pass of (B, H, W) uint8 along ``axis`` (-1:
    along W, -2: along H): ``u8(clamp((sum_k px[first + k] * w[k] +
    0x8000) >> 16, 0, 255))`` per output sample."""
    _check(img, "img", (torch.uint8,), 3)
    dim = _scan_dim(axis)
    new, maxtaps = _check_band(band, img.shape[dim])
    if not _on_cuda(img, band.first, band.taps, band.weights):
        return zoom_pass_ref(img, band, axis)
    b, h, w = img.shape
    out_shape = (b, h, new) if dim == 2 else (b, new, w)
    out = torch.empty(out_shape, dtype=torch.uint8, device=img.device)
    if out.numel() == 0:
        return out
    _call("zoom_pass", "tc_zoom_pass", img.data_ptr(), out.data_ptr(),
          band.first.data_ptr(), band.taps.data_ptr(),
          band.weights.data_ptr(), maxtaps, b, h, w, new, int(dim == 2),
          _stream(img))
    launches["zoom_pass"] += 1
    return out
