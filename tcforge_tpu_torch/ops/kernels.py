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
``unsharp_plane``          ``csrc/unsharp.cu``         ops/kernels.py
                                                       ``unsharp_plane_pallas``
``tomsmocomp_plane``,      ``csrc/tomsmocomp.cu``      ops/kernels.py
``tomsmocomp_window``                                  ``tomsmocomp_plane_
                                                       pallas2`` and
                                                       ``tomsmocomp_plane_
                                                       pallas``
``d3_spatial_scan``        ``csrc/hqdn3d_scan.cu``     ops/kernels.py
                                                       ``spatial_scan`` "d3"
``d3_temporal_scan``       ``csrc/hqdn3d_scan.cu``     ops/kernels.py
                                                       ``temporal3d_scan``
``yuvdenoise_chroma``      ``csrc/yuvdenoise.cu``      modules/filters/
                                                       yuvdenoise.py
                                                       ``correct_chroma``
                                                       (a ``lax.scan``, not
                                                       a Pallas kernel)
``stabilize_field_search`` ``csrc/stabilize.cu``       modules/filters/
                                                       stabilize.py
                                                       ``field_search``
                                                       (a ``lax.scan``)
``transform_warp``         ``csrc/stabilize.cu``       modules/filters/
                                                       stabilize.py
                                                       ``warp_plane`` (XLA
                                                       ops)
``mpeg2_recon``            ``csrc/mpeg2_recon.cu``     io/mpeg2codec.py
                                                       ``_recon_picture_
                                                       math`` and
                                                       ``_recon_field_
                                                       core`` (XLA ops)
``mpeg2_idct_intra``       ``csrc/mpeg2_recon.cu``     io/mpeg2codec.py
                                                       ``reconstruct_intra_
                                                       batch_jax``'s CPU
                                                       branch (the native
                                                       float64 IDCT)
``mpeg2_me``               ``csrc/mpeg2_encode.cu``    io/mpeg2enc.py
                                                       ``motion_search`` and
                                                       ``halfpel_refine``
                                                       (XLA ops; the CPU
                                                       route's native
                                                       ``tc_me16_refine``)
``mpeg2_enc_pred``,        ``csrc/mpeg2_encode.cu``    io/mpeg2enc.py
``mpeg2_enc_bmode``                                    ``_mc_pred_half`` and
                                                       ``_b_code_math``'s
                                                       mode choice (XLA ops)
``mpeg2_enc_blocks``       ``csrc/mpeg2_encode.cu``    io/mpeg2enc.py
                                                       ``_intra_math_jax``,
                                                       ``_code_plane_inter``
                                                       (XLA ops; the native
                                                       float64 block coder)
``mpeg4_recon``            ``csrc/mpeg4_recon.cu``     io/mpeg4jax.py
                                                       ``_recon_vop_math``
                                                       (XLA ops; the JAX
                                                       CLI's route is the
                                                       numpy decoder's)
``mpeg4_recon_qpel``       ``csrc/mpeg4_recon.cu``     io/mpeg4dec.py
                                                       ``_mc_block_qpel``
                                                       (numpy; the JAX
                                                       device form refuses
                                                       quarter-sample VOLs)
``mpeg4_recon_field``      ``csrc/mpeg4_recon.cu``     io/mpeg4dec.py
                                                       ``_field_pred_mb``
                                                       and ``_luma_store``
                                                       (numpy; the JAX
                                                       device form refuses
                                                       interlaced VOLs)
``mpeg4_idct_intra``       ``csrc/mpeg4_recon.cu``     io/mpeg4jax.py
                                                       ``xvid_idct_jax`` of
                                                       an I-VOP (XLA ops)
``mpeg4_gmc_warp``         ``csrc/mpeg4_recon.cu``     io/mpeg4dec.py
                                                       ``_gmc_warp_planes``
                                                       and ``_gmc_bilin``
                                                       (numpy; the JAX
                                                       device form refuses
                                                       GMC VOLs)
``mpeg4_enc_me``           ``csrc/mpeg4_encode.cu``    io/mpeg4enc.py
                                                       ``_encode_pvop``'s
                                                       decisions (numpy
                                                       loops, no device
                                                       form)
``mpeg4_enc_bme``          ``csrc/mpeg4_encode.cu``    io/mpeg4enc.py
                                                       ``_encode_bvop``'s
                                                       decisions (numpy)
``mpeg4_enc_blocks``       ``csrc/mpeg4_encode.cu``    io/mpeg4enc.py
                                                       ``_code_intra_mb``
                                                       and the inter block
                                                       coding (numpy)
``jpeg_idct``              ``csrc/jpeg_decode.cu``     modules/importers/
                                                       avi_import.py and
                                                       io/mov.py: PIL's
                                                       ``Image.open`` (no
                                                       JAX form)
``jpeg_color``             ``csrc/jpeg_decode.cu``     the same
``jpeg_ycc_down``          ``csrc/jpeg_encode.cu``     modules/importers/
                                                       mov_import.py
                                                       ``MovJpegEncoder``:
                                                       PIL's ``Image.save``
                                                       (no JAX form)
``jpeg_fdct_quant``        ``csrc/jpeg_encode.cu``     the same
``dv_idct``                ``csrc/dv.cu``              io/dvdec.py
                                                       ``idct88``,
                                                       ``idct248`` and the
                                                       placement of
                                                       ``DVDecoder.decode``
                                                       (numpy, no device
                                                       form)
``dv_fdct_cost``           ``csrc/dv.cu``              io/dvenc.py
                                                       ``_segment_strings``'
                                                       transform,
                                                       ``_pick_modes``,
                                                       ``_quantize`` and
                                                       ``_ac_cost`` (numpy)
``rtjpeg_idct``            ``csrc/rtjpeg.cu``          io/rtjpeg.py
                                                       ``idct_blocks`` and
                                                       the placement of
                                                       ``RTjpegDecompressor.
                                                       decompress`` (numpy)
``rtjpeg_fdct_quant``      ``csrc/rtjpeg.cu``          io/rtjpeg.py
                                                       ``_mb_blocks``,
                                                       ``fdct_blocks`` and
                                                       ``quant_blocks``
                                                       (numpy)
``theora_recon``           ``csrc/theora.cu``          io/theora.py
                                                       ``_reconstruct``
                                                       (numpy, no device
                                                       form)
``theora_loop_filter``     ``csrc/theora.cu``          io/theora.py
                                                       ``_loop_filter``
                                                       (numpy)
``theora_fdct_quant``      ``csrc/theora.cu``          io/theoraenc.py
                                                       ``_fdct_blocks`` and
                                                       ``_quantize_blocks``
                                                       (numpy)
``theora_me``              ``csrc/theora.cu``          io/theoraenc.py
                                                       ``_choose_modes``
                                                       with ``_search_mv``
                                                       (numpy loops)
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
from typing import Dict, List, NamedTuple, Tuple

import torch

from tcforge_tpu_torch.ops import _build

LUT_SIZE = 8192
D3_LUT_SIZE = 512
TMC_MAX_MOV = 4          # Max_Mov envelope (SearchLoopTop.inc)

# kernel launches per wrapper since the last reset_launches()
launches: Dict[str, int] = {"hqdn3d_spatial_scan": 0,
                            "hqdn3d_temporal_scan": 0,
                            "zoom_pass": 0,
                            "unsharp": 0,
                            "tomsmocomp": 0,
                            "d3_spatial_scan": 0,
                            "d3_temporal_scan": 0,
                            "yuvdenoise_chroma": 0,
                            "stabilize_field_search": 0,
                            "transform_warp": 0,
                            "mpeg2_recon": 0,
                            "mpeg2_idct_intra": 0,
                            "mpeg2_me": 0,
                            "mpeg2_enc_pred": 0,
                            "mpeg2_enc_bmode": 0,
                            "mpeg2_enc_blocks": 0,
                            "mpeg4_recon": 0,
                            "mpeg4_recon_qpel": 0,
                            "mpeg4_recon_field": 0,
                            "mpeg4_idct_intra": 0,
                            "mpeg4_gmc_warp": 0,
                            "mpeg4_enc_me": 0,
                            "mpeg4_enc_bme": 0,
                            "mpeg4_enc_blocks": 0,
                            "jpeg_idct": 0,
                            "jpeg_color": 0,
                            "jpeg_ycc_down": 0,
                            "jpeg_fdct_quant": 0,
                            "dv_idct": 0,
                            "dv_fdct_cost": 0,
                            "rtjpeg_idct": 0,
                            "rtjpeg_fdct_quant": 0,
                            "theora_recon": 0,
                            "theora_loop_filter": 0,
                            "theora_fdct_quant": 0,
                            "theora_me": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# outputs per block of the zoom kernel's rows pass (csrc/zoom_pass.cu
# kStrip); a Band's ``lo`` holds one entry per strip of this many
ZOOM_STRIP = 128


class Band(NamedTuple):
    """A resample pass's contributor bands (ops/zoom.py band_table,
    which checks that every band lies inside the ``oldsize`` source
    samples): int32 (new,) first source index, int32 (new,) tap count
    and int32 (new, maxtaps) zero-padded 16.16 weights; and, per strip
    of ``ZOOM_STRIP`` outputs, int32 ``lo`` the strip's lowest first
    index, with ``span`` the widest ``max(first + taps) - lo`` of any
    strip (ops/zoom.py strip_spans)."""

    first: torch.Tensor
    taps: torch.Tensor
    weights: torch.Tensor
    oldsize: int
    lo: torch.Tensor
    span: int


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hqdn3d_scan": {
        "tc_hqdn3d_spatial_scan": (_P, _I, _P, _P, _LL, _LL, _LL, _I, _P),
        "tc_hqdn3d_temporal_scan": (_P, _P, _P, _P, _P, _I, _LL, _P),
        "tc_d3_spatial_scan": (_P, _I, _P, _P, _LL, _LL, _LL, _I, _P),
        "tc_d3_temporal_scan": (_P, _P, _P, _P, _P, _I, _LL, _P),
    },
    "unsharp": {
        "tc_unsharp": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "tomsmocomp": {
        "tc_tomsmocomp": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        "tc_tomsmocomp_window": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "yuvdenoise": {
        "tc_yuvdenoise_chroma": (_P, _P, _P, _I, _I, _I, _I, _P),
    },
    "stabilize": {
        "tc_stabilize_field_search": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _P),
        "tc_transform_warp": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "mpeg2_recon": {
        "tc_mpeg2_recon": (_P, _P, _P),
        "tc_mpeg2_idct_intra": (_P, _P, _LL, _I, _I, _P, _I, _P, _P),
    },
    "mpeg2_encode": {
        "tc_mpeg2_me": (_P, _P),
        "tc_mpeg2_enc_pred": (_P, _P),
        "tc_mpeg2_enc_bmode": (_P, _P),
        "tc_mpeg2_enc_blocks": (_P, _P, _P, _P),
    },
    "mpeg4_recon": {
        "tc_mpeg4_recon": (_P, _P),
        "tc_mpeg4_recon_qpel": (_P, _P),
        "tc_mpeg4_recon_field": (_P, _P),
        "tc_mpeg4_idct_intra": (_P, _P),
        "tc_mpeg4_gmc_warp": (_P, _P),
    },
    "jpeg_decode": {
        "tc_jpeg_idct": (_P, _P),
        "tc_jpeg_color": (_P, _P),
    },
    "jpeg_encode": {
        "tc_jpeg_ycc_down": (_P, _P),
        "tc_jpeg_fdct_quant": (_P, _P),
    },
    "dv": {
        "tc_dv_idct": (_P, _P),
        "tc_dv_fdct_cost": (_P, _P),
    },
    "rtjpeg": {
        "tc_rtjpeg_idct": (_P, _P),
        "tc_rtjpeg_fdct_quant": (_P, _P),
    },
    "theora": {
        "tc_theora_recon": (_P, _P),
        "tc_theora_loop_filter": (_P, _P),
        "tc_theora_fdct_quant": (_P, _P),
        "tc_theora_me": (_P, _P),
    },
    "mpeg4_encode": {
        "tc_mpeg4_enc_me": (_P, _P, _P),
        "tc_mpeg4_enc_bme": (_P, _P),
        "tc_mpeg4_enc_blocks": (_P, _P, _P),
    },
    "zoom_pass": {
        "tc_zoom_pass": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _LL, _LL, _LL,
                         _LL, _I, _P),
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


def _check_lut(lut: torch.Tensor, size: int = LUT_SIZE) -> None:
    _check(lut, "lut", (torch.int32,), 1)
    if lut.shape[0] != size:
        raise ValueError(f"lut: expected {size} entries, "
                         f"got {lut.shape[0]}")


def _lut_index(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """LowPassMul's table index (filter_hqdn3d.c:49-54), clamped to the
    table as the kernel clamps it (a no-op for uint8-derived input)."""
    return ((prev - curr + 0x10007FF) >> 12).clamp_(0, LUT_SIZE - 1).long()


def _d3_index(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """denoise3d LowPass's table index (filter_denoise3d.c:101), clamped
    to the table as the kernel clamps it (a no-op for uint8 input)."""
    return (prev - curr + 256).clamp_(0, D3_LUT_SIZE - 1).long()


def _scan_dim(axis: int) -> int:
    if axis not in (-1, -2, 1, 2):
        raise ValueError("axis must be -1 (along W) or -2 (along H), "
                         f"got {axis}")
    return axis % 3


def _scan_ref(f: torch.Tensor, dim: int, step) -> torch.Tensor:
    """``out[0] = f[0]``, ``out[s] = step(out[s-1], f[s])`` along ``dim``,
    one whole slice per loop turn."""
    out = torch.empty_like(f)
    prev = f.select(dim, 0)
    out.select(dim, 0).copy_(prev)
    for s in range(1, f.shape[dim]):
        prev = step(prev, f.select(dim, s))
        out.select(dim, s).copy_(prev)
    return out


# --------------------------------------------------------------------- #
# Kernel 1: hqdn3d spatial IIR scan (H and V passes)

def spatial_scan_ref(x: torch.Tensor, lut: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Plain version of ``spatial_scan`` (hqdn3d.py:94-116)."""
    f = x.to(torch.int32) << 16 if x.dtype == torch.uint8 else x
    return _scan_ref(f, _scan_dim(axis),
                     lambda prev, curr: curr + lut[_lut_index(prev, curr)])


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
    _call("hqdn3d_scan", "tc_hqdn3d_spatial_scan", x.data_ptr(),
          int(x.dtype == torch.uint8), out.data_ptr(), lut.data_ptr(),
          *x.shape, int(dim == 2), _stream(x))
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
    _check(band.lo, "band.lo", (torch.int32,), 1)
    new = band.weights.shape[0]
    if band.first.shape[0] != new or band.taps.shape[0] != new:
        raise ValueError("band tables disagree on the output size")
    if band.lo.shape[0] != -(-new // ZOOM_STRIP):
        raise ValueError(f"band.lo: expected one entry per {ZOOM_STRIP} "
                         f"outputs, got {band.lo.shape[0]} for {new}")
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
    if not _on_cuda(img, band.first, band.taps, band.weights, band.lo):
        return zoom_pass_ref(img, band, axis)
    b, h, w = img.shape
    out_shape = (b, h, new) if dim == 2 else (b, new, w)
    out = torch.empty(out_shape, dtype=torch.uint8, device=img.device)
    if out.numel() == 0:
        return out
    _call("zoom_pass", "tc_zoom_pass", img.data_ptr(), out.data_ptr(),
          band.first.data_ptr(), band.taps.data_ptr(),
          band.weights.data_ptr(), maxtaps, band.lo.data_ptr(), band.span,
          ZOOM_STRIP, b, h, w, new, int(dim == 2), _stream(img))
    launches["zoom_pass"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel U: unsharp mask (edge-clamped binomial blur mod 2^32, sharpen)

def _unsharp_fixed(sx: int, sy: int, amount: float) -> Tuple[int, int, int]:
    """(scalebits, halfscale, 16.16 amount) of unsharp.py:70-72.  Raises
    where the JAX function raises: ValueError for sx = sy = 0 (a negative
    shift), OverflowError once halfscale leaves uint32 (sx + sy >= 17)."""
    if sx < 0 or sy < 0:
        raise ValueError(f"steps must be >= 0, got {sx}, {sy}")
    scalebits = (sx + sy) * 2
    halfscale = 1 << (scalebits - 1)
    if halfscale >= 1 << 32:
        raise OverflowError(f"Python integer {halfscale} out of bounds "
                            "for uint32")
    amount_fx = int(amount * 65536.0)
    if not -(1 << 31) <= amount_fx < 1 << 31:
        raise OverflowError(f"Python integer {amount_fx} out of bounds "
                            "for int32")
    return scalebits, halfscale, amount_fx


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 that two's complement arithmetic gives."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def unsharp_plane_ref(img: torch.Tensor, sx: int, sy: int,
                      amount: float) -> torch.Tensor:
    """Plain version of ``unsharp_plane``: the JAX function's own
    cascade (unsharp.py:35-77), 2*steps [1,1] shift-add passes per axis
    over the edge-padded plane, in int64 reduced mod 2^32."""
    scalebits, halfscale, amount_fx = _unsharp_fixed(sx, sy, amount)
    mask = 0xFFFFFFFF
    a = img.to(torch.int64)
    for dim, steps in ((-1, sx), (-2, sy)):
        if steps:
            size = a.shape[dim]
            idx = torch.arange(-steps, size + steps,
                               device=a.device).clamp_(0, size - 1)
            a = a.index_select(dim, idx)
            for _ in range(2 * steps):
                a = (a.narrow(dim, 1, a.shape[dim] - 1)
                     + a.narrow(dim, 0, a.shape[dim] - 1)) & mask
    # a logical shift by >= 32 gives 0, as XLA's does
    blur = (((a + halfscale) & mask) >> scalebits if scalebits < 32
            else torch.zeros_like(a))
    # blur < 2^30 (scalebits >= 2), so only the product can leave int32
    src = img.to(torch.int64)
    prod = _wrap_i32((src - blur) * amount_fx)
    res = src + (prod.to(torch.int64) >> 16)
    return res.clamp_(0, 255).to(torch.uint8)


def unsharp_plane(img: torch.Tensor, sx: int, sy: int, amount: float,
                  tiled: bool = False) -> torch.Tensor:
    """unsharp over (N, H, W) uint8 with ``sx``/``sy`` steps (half the
    matrix sizes): the edge-clamped binomial blur ``acc`` of 2*sx + 1 by
    2*sy + 1 taps mod 2^32, ``blur = (acc + halfscale) >> scalebits``,
    ``clip(src + (((src - blur) * amount16.16) >> 16), 0, 255)``.

    On the card, matrices up to 7x7 run the register kernel and every
    other size the tiled one; ``tiled`` sends a small matrix to the
    tiled kernel too, so that a check can hold both against the plain
    version."""
    _check(img, "img", (torch.uint8,), 3)
    scalebits, halfscale, amount_fx = _unsharp_fixed(sx, sy, amount)
    if not _on_cuda(img):
        return unsharp_plane_ref(img, sx, sy, amount)
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    n, h, w = img.shape
    _call("unsharp", "tc_unsharp", img.data_ptr(), out.data_ptr(), n, h, w,
          sx, sy, scalebits, amount_fx, int(tiled), _stream(img))
    launches["unsharp"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel T: the TomsMoComp candidate tournament

def tmc_offsets(effort: int) -> List[Tuple[int, int]]:
    """(dy, dx) motion-candidate offsets per SearchEffort (field lines),
    no-motion first (tomsmocomp.py:43-61, kernels.py ``_tmc_offsets``)."""
    offs = [(0, 0)]
    if effort >= 1:
        offs += [(0, 1), (0, -1)]
    if effort >= 3:
        offs += [(1, 0), (-1, 0)]
    if effort >= 5:
        offs += [(0, 2), (0, -2)]
    if effort >= 9:
        offs += [(1, 1), (-1, -1), (1, -1), (-1, 1)]
    if effort >= 11:
        offs += [(0, 3), (0, -3)]
    if effort >= 13:
        offs += [(1, 2), (-1, -2), (1, -2), (-1, 2)]
    if effort >= 15:
        offs += [(0, 4), (0, -4)]
    return offs


def _pair(a: torch.Tensor, b: torch.Tensor):
    """(pavgb value, abs-diff weight) of a pixel pair."""
    return (a + b + 1) >> 1, (a - b).abs()


def _strange_bob(above: torch.Tensor, below: torch.Tensor, luma: bool):
    """StrangeBob.inc's diagonal-aware bob candidate, as tomsmocomp.py
    ``_strange_bob`` (:73-121) computes it, over (..., H, W) int32."""
    thres = 15

    def sh(p, dx):
        return torch.roll(p, -dx, dims=-1)

    j, a, b, c, k = (sh(above, -2), sh(above, -1), above, sh(above, 1),
                     sh(above, 2))
    m, d, e, f, n = (sh(below, -2), sh(below, -1), below, sh(below, 1),
                     sh(below, 2))
    sel = torch.zeros(above.shape, dtype=torch.bool, device=above.device)
    v = torch.zeros_like(above)
    w = torch.zeros_like(above)
    cols = torch.arange(above.shape[-1], device=above.device)
    interior = (cols >= 2) & (cols < above.shape[-1] - 2)
    if luma:
        for (p1, q1), (p2, q2) in (((a, m), (j, n)), ((c, n), (k, m)),
                                   ((b, f), (c, d)), ((b, d), (a, f))):
            val, wgt = _pair(p2, q2)
            cond = ((p1 - q1).abs() > thres) & (wgt <= thres) & interior
            v = torch.where(cond, val, v)
            w = torch.where(cond, wgt, w)
            sel = sel | cond
    val, wgt = _pair(b, e)
    cond = wgt <= thres
    v = torch.where(cond, val, v)
    w = torch.where(cond, wgt, w)
    sel = sel | cond
    use_be = ~sel | (wgt <= w)
    return torch.where(use_be, val, v), torch.where(use_be, wgt, w)


def tomsmocomp_plane_ref(curr: torch.Tensor, prev: torch.Tensor,
                         nxt: torch.Tensor, parity: int, effort: int,
                         strange_bob: bool = False,
                         luma: bool = True) -> torch.Tensor:
    """Plain version of ``tomsmocomp_plane`` (tomsmocomp.py:124-179,
    batched over N), also with StrangeBob's bob candidate, which the
    kernel does not compute."""
    c, p, x = (t.to(torch.int32) for t in (curr, prev, nxt))
    h, w = c.shape[-2:]
    above = torch.roll(c, 1, dims=-2)
    below = torch.roll(c, -1, dims=-2)
    if strange_bob:
        best_v, best_w = _strange_bob(above, below, luma)
    else:
        best_v, best_w = _pair(above, below)
    v0, w0 = _pair(p, x)
    take = w0 <= best_w
    best_v = torch.where(take, v0, best_v)
    best_w = torch.where(take, w0, best_w).add_(1).clamp_(max=255)
    rows = torch.arange(h, device=c.device)[:, None]
    cols = torch.arange(w, device=c.device)[None, :]
    for dy, dx in tmc_offsets(effort)[1:]:
        a = torch.roll(p, (-2 * dy, -dx), dims=(-2, -1))
        b = torch.roll(x, (2 * dy, dx), dims=(-2, -1))
        v, wgt = _pair(a, b)
        ady, adx = 2 * abs(dy), abs(dx)
        valid = ((rows >= ady) & (rows < h - ady)
                 & (cols >= adx) & (cols < w - adx))
        take = (wgt <= best_w) & valid
        best_v = torch.where(take, v, best_v)
        best_w = torch.where(take, wgt, best_w)
    lo = (torch.minimum(above, below) - TMC_MAX_MOV).clamp_(min=0)
    hi = (torch.maximum(above, below) + TMC_MAX_MOV).clamp_(max=255)
    synth = torch.minimum(torch.maximum(best_v, lo), hi)
    r = torch.arange(h, device=c.device)
    keep = ((r % 2 == parity) | (r == 0) | (r == h - 1))[:, None]
    return torch.where(keep, c, synth).clamp_(0, 255).to(torch.uint8)


def _check_tmc(parity: int, effort: int) -> None:
    if parity not in (0, 1) or not 0 <= effort <= 15:
        raise ValueError(f"parity {parity} / effort {effort} out of range")


def tomsmocomp_plane(curr: torch.Tensor, prev: torch.Tensor,
                     nxt: torch.Tensor, parity: int,
                     effort: int) -> torch.Tensor:
    """TomsMoComp over (N, H, W) uint8 frames with their previous and
    next frames: lines of ``parity`` and rows 0 and H-1 pass through;
    each missing pixel takes the winner of the bob, no-motion (+1 bias)
    and motion candidates of ``effort``, clamped to the bob pair's
    [min - 4, max + 4]."""
    for name, t in (("curr", curr), ("prev", prev), ("nxt", nxt)):
        _check(t, name, (torch.uint8,), 3)
    if not curr.shape == prev.shape == nxt.shape:
        raise ValueError("curr/prev/nxt shapes differ: "
                         f"{[tuple(t.shape) for t in (curr, prev, nxt)]}")
    _check_tmc(parity, effort)
    if not _on_cuda(curr, prev, nxt):
        return tomsmocomp_plane_ref(curr, prev, nxt, parity, effort)
    out = torch.empty_like(curr)
    if curr.numel() == 0:
        return out
    _call("tomsmocomp", "tc_tomsmocomp", curr.data_ptr(), prev.data_ptr(),
          nxt.data_ptr(), out.data_ptr(), *curr.shape, parity, effort,
          _stream(curr))
    launches["tomsmocomp"] += 1
    return out


def tomsmocomp_window_ref(state: torch.Tensor, batch: torch.Tensor,
                          parity: int, effort: int) -> torch.Tensor:
    """Plain version of ``tomsmocomp_window``: the window built with
    ``cat``, then ``tomsmocomp_plane_ref``."""
    window = torch.cat([state, batch])
    return tomsmocomp_plane_ref(window[1:-1], window[:-2], window[2:],
                                parity, effort)


def tomsmocomp_window(state: torch.Tensor, batch: torch.Tensor, parity: int,
                      effort: int) -> torch.Tensor:
    """``tomsmocomp_plane`` over the window ``state ++ batch`` without
    building it: ``state`` is the carried uint8 (2, H, W), ``batch`` the
    uint8 (N, H, W); output j has prev ``state[j]`` (j < 2) else
    ``batch[j-2]``, curr ``state[1]`` (j = 0) else ``batch[j-1]``, and
    next ``batch[j]``."""
    _check(state, "state", (torch.uint8,), 3)
    _check(batch, "batch", (torch.uint8,), 3)
    if state.shape[0] != 2 or state.shape[1:] != batch.shape[1:]:
        raise ValueError(f"state {tuple(state.shape)} is not two frames of "
                         f"the batch's {tuple(batch.shape[1:])}")
    _check_tmc(parity, effort)
    if not _on_cuda(state, batch):
        return tomsmocomp_window_ref(state, batch, parity, effort)
    out = torch.empty_like(batch)
    if batch.numel() == 0:
        return out
    _call("tomsmocomp", "tc_tomsmocomp_window", state.data_ptr(),
          batch.data_ptr(), out.data_ptr(), *batch.shape, parity, effort,
          _stream(batch))
    launches["tomsmocomp"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernels D-S and D-T: the denoise3d scans (templates of kernels 1, 2)

def d3_spatial_scan_ref(x: torch.Tensor, lut: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """Plain version of ``d3_spatial_scan`` (denoise3d.py:58-75)."""
    return _scan_ref(x.to(torch.int32), _scan_dim(axis),
                     lambda prev, curr: curr + lut[_d3_index(prev, curr)])


def d3_spatial_scan(x: torch.Tensor, lut: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """denoise3d spatial pass over (N, H, W): ``out[0] = x[0]``,
    ``out[s] = x[s] + lut[out[s-1] - x[s] + 256]`` along ``axis`` (-1:
    along W, -2: along H), in the uint8 domain.  ``x`` is uint8 or
    int32; the result is int32 (N, H, W)."""
    _check(x, "x", (torch.uint8, torch.int32), 3)
    _check_lut(lut, D3_LUT_SIZE)
    dim = _scan_dim(axis)
    if not _on_cuda(x, lut):
        return d3_spatial_scan_ref(x, lut, axis)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    _call("hqdn3d_scan", "tc_d3_spatial_scan", x.data_ptr(),
          int(x.dtype == torch.uint8), out.data_ptr(), lut.data_ptr(),
          *x.shape, int(dim == 2), _stream(x))
    launches["d3_spatial_scan"] += 1
    return out


def d3_temporal_scan_ref(v: torch.Tensor, prev: torch.Tensor,
                         lut: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``d3_temporal_scan`` (denoise3d.py:77-82)."""
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    for i in range(v.shape[0]):
        prev = v[i] + lut[_d3_index(prev, v[i])]
        out[i] = prev.to(torch.uint8)
    return out, prev.clone()


def d3_temporal_scan(v: torch.Tensor, prev: torch.Tensor,
                     lut: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """denoise3d temporal IIR: per pixel, over the N frames of the int32
    (N, H, W) V-pass output, ``prev = v + lut[prev - v + 256]``, emitted
    as uint8.  ``prev`` is the int32 (H, W) previous output frame;
    returns (uint8 (N, H, W), the new previous output)."""
    _check(v, "v", (torch.int32,), 3)
    _check(prev, "prev", (torch.int32,), 2)
    _check_lut(lut, D3_LUT_SIZE)
    if tuple(prev.shape) != tuple(v.shape[1:]):
        raise ValueError(f"prev shape {tuple(prev.shape)} != plane "
                         f"{tuple(v.shape[1:])}")
    if not _on_cuda(v, prev, lut):
        return d3_temporal_scan_ref(v, prev, lut)
    out = torch.empty(v.shape, dtype=torch.uint8, device=v.device)
    prev_out = torch.empty_like(prev)
    if v.numel() == 0:
        return out, prev_out.copy_(prev)
    n, h, w = v.shape
    _call("hqdn3d_scan", "tc_d3_temporal_scan", v.data_ptr(),
          prev.data_ptr(), out.data_ptr(), prev_out.data_ptr(),
          lut.data_ptr(), n, h * w, _stream(v))
    launches["d3_temporal_scan"] += 1
    return out, prev_out


# --------------------------------------------------------------------- #
# Kernel Y: yuvdenoise's chroma correction (a row recurrence)

def yuvdenoise_chroma_ref(ref: torch.Tensor, tmp: torch.Tensor,
                          threshold: int) -> torch.Tensor:
    """Plain version of ``yuvdenoise_chroma``: the JAX ``lax.scan`` over
    rows (yuvdenoise.py:183-218) as a Python loop, one row of every
    plane per turn."""
    p, h2, w2 = ref.shape
    q = (ref - tmp).abs()
    f1 = (255 * (q - threshold) // max(1, threshold)).clamp_(0, 255)
    f2 = 255 - f1
    app = q > threshold
    simple = (tmp * f2 + ref * f1) // 255
    flat = (torch.arange(h2, device=ref.device)[:, None] * w2
            + torch.arange(w2, device=ref.device)[None, :])
    three = (flat > w2) & (flat < w2 * h2 - w2)
    out = torch.empty_like(tmp)
    prev = torch.zeros_like(tmp[:, 0])
    for r in range(h2):
        above, below = (r - 1) % h2, (r + 1) % h2
        tt = ((ref[:, r] + ref[:, below] + ref[:, above]) * f1[:, r] // 3
              + (tmp[:, r] + tmp[:, below] + prev) * f2[:, r] // 3) // 255
        prev = torch.where(app[:, r], torch.where(three[r], tt,
                                                  simple[:, r]), tmp[:, r])
        out[:, r] = prev
    return out


def yuvdenoise_chroma(ref: torch.Tensor, tmp: torch.Tensor,
                      threshold: int) -> torch.Tensor:
    """yuvdenoise's correct_frame2 on chroma (denoise.c:414-478) for P
    int32 (P, H2, W2) planes at once.  Per pixel ``q = |ref - tmp|``,
    ``f1 = clamp(255*(q - T) // max(1, T), 0, 255)``, ``f2 = 255 - f1``;
    where ``q > T`` the pixel becomes ``(tmp*f2 + ref*f1) // 255`` or,
    at the interior flat indices ``W2 < c < W2*H2 - W2``, the vertical
    3-tap ``((ref + ref_below + ref_above)*f1 // 3 + (tmp + tmp_below +
    out_above)*f2 // 3) // 255``, which reads the row above after it was
    corrected; elsewhere it stays ``tmp``.  Returns int32 (P, H2, W2)."""
    _check(ref, "ref", (torch.int32,), 3)
    _check(tmp, "tmp", (torch.int32,), 3)
    if ref.shape != tmp.shape:
        raise ValueError(f"ref {tuple(ref.shape)} and tmp "
                         f"{tuple(tmp.shape)} differ")
    if not _on_cuda(ref, tmp):
        return yuvdenoise_chroma_ref(ref, tmp, threshold)
    out = torch.empty_like(tmp)
    if out.numel() == 0:
        return out
    _call("yuvdenoise", "tc_yuvdenoise_chroma", ref.data_ptr(),
          tmp.data_ptr(), out.data_ptr(), int(threshold), *ref.shape,
          _stream(ref))
    launches["yuvdenoise_chroma"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel S: stabilize's field search and transform's warp

def stabilize_field_search_ref(prev: torch.Tensor, frames: torch.Tensor,
                               centers: torch.Tensor, size: int,
                               maxshift: int, stepsize: int
                               ) -> torch.Tensor:
    """Plain version of ``stabilize_field_search``: the JAX loop of
    ``field_search`` (stabilize.py:209-272), a gather and a sum per
    candidate, over the batch at once."""
    from tcforge_tpu_torch.modules.filters import stabilize
    offs = torch.arange(size, dtype=torch.int32, device=frames.device) \
        - size // 2
    fy = centers[:, 1, None, None] + offs[None, :, None]
    fx = centers[:, 0, None, None] + offs[None, None, :]
    prevs = torch.cat([prev[None], frames[:-1]])
    return stabilize.field_search(frames, prevs, fy, fx, maxshift, stepsize)


def stabilize_field_search(prev: torch.Tensor, frames: torch.Tensor,
                           centers: torch.Tensor, size: int, maxshift: int,
                           stepsize: int) -> torch.Tensor:
    """stabilize's block search (calcFieldTransYUV) for every field of
    every frame of a uint8 (N, H, W) batch, frame n against frame n-1
    and frame 0 against the (H, W) ``prev``.  Field f is the ``size``
    square whose top left is ``centers[f] - size // 2`` (int32 (F, 2),
    x then y), indexed as jnp indexes (a negative index wraps once,
    then clamps).  The coarse grid (stride ``stepsize`` over
    +-``maxshift``, dx outer, dy inner), then +-(stepsize-1) around each
    field's coarse best; a later candidate wins only with a strictly
    smaller SAD; a result at or beyond ``maxshift`` becomes 0.  Returns
    int32 (N, F, 2) (dx, dy)."""
    _check(prev, "prev", (torch.uint8,), 2)
    _check(frames, "frames", (torch.uint8,), 3)
    _check(centers, "centers", (torch.int32,), 2)
    if tuple(prev.shape) != tuple(frames.shape[1:]):
        raise ValueError(f"prev shape {tuple(prev.shape)} != frame "
                         f"{tuple(frames.shape[1:])}")
    if centers.shape[1] != 2 or size < 1 or stepsize < 1 or maxshift < 0:
        raise ValueError(f"bad fields: centers {tuple(centers.shape)}, "
                         f"size {size}, maxshift {maxshift}, "
                         f"stepsize {stepsize}")
    if not _on_cuda(prev, frames, centers):
        return stabilize_field_search_ref(prev, frames, centers, size,
                                          maxshift, stepsize)
    n, h, w = frames.shape
    nf = centers.shape[0]
    out = torch.empty((n, nf, 2), dtype=torch.int32, device=frames.device)
    if n == 0 or nf == 0:
        return out
    _call("stabilize", "tc_stabilize_field_search", prev.data_ptr(),
          frames.data_ptr(), centers.data_ptr(), out.data_ptr(), n, nf, h,
          w, size, maxshift, stepsize, _stream(frames))
    launches["stabilize_field_search"] += 1
    return out


WARP_INTERPOLATIONS = (0, 1, 2, 3, 4)


def transform_warp_ref(plane: torch.Tensor, fparams: torch.Tensor,
                       iparams: torch.Tensor, interp: int, crop: int,
                       default_val: int) -> torch.Tensor:
    """Plain version of ``transform_warp``: ``stabilize.warp_plane``
    over the batch."""
    from tcforge_tpu_torch.modules.filters import stabilize
    return stabilize.warp_plane(plane, fparams, iparams, interp=interp,
                                crop=crop, default_val=default_val)


def transform_warp(plane: torch.Tensor, fparams: torch.Tensor,
                   iparams: torch.Tensor, interp: int, crop: int,
                   default_val: int) -> torch.Tensor:
    """transform's inverse-map warp (transformYUV,
    filter_transform.c:426-536) of a uint8 (N, H, W) plane batch, frame
    n with float32 ``fparams[n]`` = (zcos, zsin, c_x - tx*s, c_y - ty*s)
    and int32 ``iparams[n]`` = (round(tx*s), round(ty*s),
    pure-translation flag) (``stabilize.warp_params``): the ``interp``
    interpolation (0 zero, 1 linear, 2 bilinear, 3 quadratic, 4
    bicubic) at the source coordinates, or the rounded integer shift
    where the flag is set; outside the source the pixel keeps its own
    value, or with ``crop`` = 1 becomes ``default_val``.  Returns uint8
    (N, H, W)."""
    _check(plane, "plane", (torch.uint8,), 3)
    _check(fparams, "fparams", (torch.float32,), 2)
    _check(iparams, "iparams", (torch.int32,), 2)
    n = plane.shape[0]
    if tuple(fparams.shape) != (n, 4) or tuple(iparams.shape) != (n, 3):
        raise ValueError(f"params {tuple(fparams.shape)} "
                         f"{tuple(iparams.shape)} for {n} frames")
    if interp not in WARP_INTERPOLATIONS or crop not in (0, 1):
        raise ValueError(f"interp {interp}, crop {crop}")
    if not _on_cuda(plane, fparams, iparams):
        return transform_warp_ref(plane, fparams, iparams, interp, crop,
                                  default_val)
    out = torch.empty_like(plane)
    if out.numel() == 0:
        return out
    _call("stabilize", "tc_transform_warp", plane.data_ptr(),
          fparams.data_ptr(), iparams.data_ptr(), out.data_ptr(),
          *plane.shape, int(interp), int(crop), int(default_val),
          _stream(plane))
    launches["transform_warp"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel M: MPEG-2 picture reconstruction

@lru_cache(maxsize=None)
def _basis_host():
    """The float64 IDCT basis as a ctypes array of 64 doubles (the JAX
    package's ``_dct_basis``), handed to each launch."""
    from tcforge_tpu_torch.io.mpeg2codec import dct_basis
    return (ctypes.c_double * 64)(*dct_basis().reshape(-1).tolist())


def _basis(device: torch.device) -> torch.Tensor:
    from tcforge_tpu_torch.io.mpeg2codec import dct_basis
    return torch.from_numpy(dct_basis()).to(device)


def _check_plane(p: torch.Tensor, what: str) -> None:
    if not isinstance(p, torch.Tensor) or p.dtype != torch.uint8 \
            or p.dim() != 2:
        raise ValueError(f"{what}: expected a uint8 2-D plane")
    if p.shape[0] and p.stride(1) != 1:
        raise ValueError(f"{what}: rows must be contiguous")


def _refs_list(refs, field: bool, what: str) -> List[torch.Tensor]:
    """The reference planes in the kernel's order: (y, u, v), or for a
    field picture the top field's then the bottom field's."""
    if refs is None:
        return []
    groups = list(refs) if field else [refs]
    if len(groups) != (2 if field else 1):
        raise ValueError(f"{what}: expected (top, bottom) field planes")
    planes = [p for g in groups for p in g]
    if len(planes) != 3 * len(groups):
        raise ValueError(f"{what}: expected (y, u, v) planes")
    for i, p in enumerate(planes):
        _check_plane(p, f"{what}[{i}]")
        if p.shape[0] == 0 or p.shape[1] == 0:
            raise ValueError(f"{what}[{i}]: an empty plane")
    return planes


def mpeg2_recon_ref(ycoef, ucoef, vcoef, mbinfo, fwd, bwd, tff: bool,
                    field_parity=None, chroma: int = 1):
    """Plain version of ``mpeg2_recon``: ``recon_picture_math`` or, for a
    field picture, ``recon_field_math`` (io/mpeg2codec.py)."""
    from tcforge_tpu_torch.io import mpeg2codec
    if field_parity is None:
        return mpeg2codec.recon_picture_math(ycoef, ucoef, vcoef, mbinfo,
                                             fwd, bwd, tff, chroma)
    return mpeg2codec.recon_field_math(ycoef, ucoef, vcoef, mbinfo, fwd, bwd,
                                       field_parity, chroma)


def mpeg2_recon(ycoef: torch.Tensor, ucoef: torch.Tensor,
                vcoef: torch.Tensor, mbinfo: torch.Tensor, fwd, bwd,
                tff: bool, field_parity=None, chroma: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One picture's planes from its parse output: int32 natural-order
    coefficient grids (rows*2, mb_w*2, 64) and (rows*chroma, mb_w, 64)
    twice, int32 macroblock records (rows*mb_w, 12) (flags, forward and
    backward vectors, field selects).  ``chroma`` 1 is 4:2:0; 2 is 4:2:2,
    whose chroma macroblocks are 8 wide and 16 tall, whose chroma vectors
    halve the horizontal component alone, and whose frame pictures'
    field-DCT macroblocks deinterleave chroma rows too.  A frame picture
    (``field_parity`` None) predicts from ``fwd`` / ``bwd`` = (y, u, v)
    uint8 frames or None, a field picture from (top, bottom) pairs of
    (y, u, v) field planes of any height (rows need not be adjacent in
    memory: a frame's lines of one parity will do).  Per pixel the
    float32 IDCT (sequential fused multiply-adds over the 64
    coefficients), a frame picture's field-DCT deinterleave, the frame,
    field or dual-prime half-pel prediction (``tff``: top field first)
    and the clipped sum.  Returns uint8 (rows*16, mb_w*16) and
    (rows*8*chroma, mb_w*8) twice."""
    for t, what in ((ycoef, "ycoef"), (ucoef, "ucoef"), (vcoef, "vcoef")):
        _check(t, what, (torch.int32,), 3)
    _check(mbinfo, "mbinfo", (torch.int32,), 2)
    if chroma not in (1, 2):
        raise ValueError(f"chroma {chroma}: 1 (4:2:0) or 2 (4:2:2)")
    rows, mb_w = ycoef.shape[0] // 2, ycoef.shape[1] // 2
    if (tuple(ycoef.shape) != (2 * rows, 2 * mb_w, 64)
            or tuple(ucoef.shape) != (rows * chroma, mb_w, 64)
            or tuple(vcoef.shape) != (rows * chroma, mb_w, 64)
            or tuple(mbinfo.shape) != (rows * mb_w, 12)):
        raise ValueError(f"grids {tuple(ycoef.shape)} {tuple(ucoef.shape)} "
                         f"{tuple(vcoef.shape)} {tuple(mbinfo.shape)} do not "
                         f"make one {('4:2:0', '4:2:2')[chroma - 1]} "
                         "macroblock grid")
    field = field_parity is not None
    if field and field_parity not in (0, 1):
        raise ValueError(f"field_parity {field_parity}")
    fplanes = _refs_list(fwd, field, "fwd")
    bplanes = _refs_list(bwd, field, "bwd")
    sizes = ((rows * 16, mb_w * 16), (rows * 8 * chroma, mb_w * 8),
             (rows * 8 * chroma, mb_w * 8))
    if not field:
        for planes, what in ((fplanes, "fwd"), (bplanes, "bwd")):
            for p, size in zip(planes, sizes):
                if tuple(p.shape) != size:
                    raise ValueError(f"{what}: plane {tuple(p.shape)} is "
                                     "not the coded grid")
    if not _on_cuda(ycoef, ucoef, vcoef, mbinfo, *fplanes, *bplanes):
        return mpeg2_recon_ref(ycoef, ucoef, vcoef, mbinfo, fwd, bwd, tff,
                               field_parity, chroma)
    dev = ycoef.device
    out = tuple(torch.empty(size, dtype=torch.uint8, device=dev)
                for size in sizes)
    if rows == 0 or mb_w == 0:
        return out
    meta = [ycoef.data_ptr(), ucoef.data_ptr(), vcoef.data_ptr(),
            *(o.data_ptr() for o in out), mbinfo.data_ptr(), mb_w, rows,
            int(bool(fplanes)), int(bool(bplanes)), int(bool(tff)),
            int(field), int(field_parity or 0)]
    for planes in (fplanes, bplanes):
        for i in range(6):
            if i < len(planes):
                p = planes[i]
                meta += [p.data_ptr(), p.shape[0], p.shape[1], p.stride(0)]
            else:
                meta += [0, 0, 0, 0]
    meta.append(chroma)
    arr = (ctypes.c_longlong * len(meta))(*meta)
    _call("mpeg2_recon", "tc_mpeg2_recon", ctypes.cast(arr, _P),
          ctypes.cast(_basis_host(), _P), _stream(ycoef))
    launches["mpeg2_recon"] += 1
    return out


def _field_dct_mb(coef: torch.Tensor, field_dct) -> int:
    """Checks ``field_dct`` (bool (N, mb_h, mb_w)) against the grids
    (N, bh, bw, 64): 16-row macroblocks, each 16 (luma) or 8 (4:2:2
    chroma) pixels wide.  Returns that width, or 0 without it."""
    if field_dct is None:
        return 0
    _check(field_dct, "field_dct", (torch.bool,), 3)
    n, bh, bw = coef.shape[:3]
    mbh, mbw = field_dct.shape[1:]
    if (field_dct.shape[0] != n or bh != 2 * mbh or mbw == 0
            or (bw * 8) % mbw or (bw * 8) // mbw not in (8, 16)):
        raise ValueError(f"field_dct {tuple(field_dct.shape)} does not "
                         f"tile the grids {tuple(coef.shape)}")
    return (bw * 8) // mbw


def mpeg2_idct_intra_ref(coef: torch.Tensor,
                         field_dct=None) -> torch.Tensor:
    """Plain version of ``mpeg2_idct_intra``: ``idct_intra_f64``
    (io/mpeg2codec.py) with an exact float64 fused multiply-add, then
    ``deinterleave_field_dct`` of each picture."""
    from tcforge_tpu_torch.io import mpeg2codec
    out = mpeg2codec.idct_intra_f64(coef, _basis(coef.device))
    if field_dct is None:
        return out
    mb_px = _field_dct_mb(coef, field_dct)
    return torch.stack([mpeg2codec.deinterleave_field_dct(p, fd, mb_px)
                        for p, fd in zip(out, field_dct)])


def mpeg2_idct_intra(coef: torch.Tensor, field_dct=None) -> torch.Tensor:
    """The float64 IDCT of intra pictures: int32 (N, bh, bw, 64)
    natural-order coefficient grids -> uint8 (N, bh*8, bw*8), per block
    ``t = C B`` then ``o = B^T t`` with every sum a sequential fused
    multiply-add over k = 0..7 from 0, rounded half to even and
    clipped.  With ``field_dct`` (bool (N, mb_h, mb_w), a 4:2:2 frame
    picture's field-DCT macroblocks: 16 rows, 16 pixels wide for luma
    and 8 for chroma) the rows of those macroblocks are stored
    deinterleaved: coded row r of 16 goes to 2r (r < 8) or 2(r-8)+1."""
    _check(coef, "coef", (torch.int32,), 4)
    if coef.shape[3] != 64:
        raise ValueError(f"coef: expected 64 coefficients a block, got "
                         f"{tuple(coef.shape)}")
    mb_px = _field_dct_mb(coef, field_dct)
    tensors = (coef,) if field_dct is None else (coef, field_dct)
    if not _on_cuda(*tensors):
        return mpeg2_idct_intra_ref(coef, field_dct)
    n, bh, bw = coef.shape[:3]
    out = torch.empty((n, bh * 8, bw * 8), dtype=torch.uint8,
                      device=coef.device)
    if out.numel() == 0:
        return out
    _call("mpeg2_recon", "tc_mpeg2_idct_intra", coef.data_ptr(),
          out.data_ptr(), n, bh, bw,
          field_dct.data_ptr() if mb_px else 0,
          (bw * 8) // mb_px if mb_px else 0, ctypes.cast(_basis_host(), _P),
          _stream(coef))
    launches["mpeg2_idct_intra"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernels E1-E3: the MPEG-2 encoder's motion search, prediction and block
# coder (not TPU kernels: the JAX package's CPU route runs them in
# native/tcforge_host.cpp, its device route as XLA ops)

ME_MAX_RANGE = 64        # csrc/mpeg2_encode.cu kMaxRange


def _meta(values) -> ctypes.c_void_p:
    """A launch's arguments as one array of 64-bit integers (pointers,
    strides, sizes), read on the host side of the C entry point."""
    arr = (ctypes.c_longlong * len(values))(*values)
    return ctypes.cast(arr, _P), arr


def _check_mb_planes(planes, what: str, shape=None) -> Tuple[int, int]:
    """uint8 2-D planes of one shape whose rows are contiguous (field
    views of a frame are fine), both sides multiples of 16 for luma."""
    for i, p in enumerate(planes):
        _check_plane(p, f"{what}[{i}]")
        if shape is not None and tuple(p.shape) != tuple(shape):
            raise ValueError(f"{what}[{i}]: shape {tuple(p.shape)}, "
                             f"expected {tuple(shape)}")
        shape = p.shape
    return tuple(shape)


def _check_yuv(planes, what: str) -> Tuple[int, int]:
    """(y,) or (y, u, v) planes of a whole number of macroblocks, chroma
    of 4:2:0 (h/2, w/2) or of 4:2:2 (h, w/2): (h, w)."""
    if len(planes) not in (1, 3):
        raise ValueError(f"{what}: expected (y,) or (y, u, v) planes")
    h, w = _check_mb_planes(planes[:1], what)
    if h % 16 or w % 16 or h == 0 or w == 0:
        raise ValueError(f"{what}: {w}x{h} is not a whole number of "
                         "macroblocks")
    _check_mb_planes(planes[1:], what, (_chroma_rows(planes, h), w // 2))
    return h, w


def _chroma_rows(planes, h: int) -> int:
    """The chroma planes' rows: h at 4:2:2 (full-height chroma, as the
    JAX encoder's ``_chroma_params`` tells the two apart), else h/2."""
    if len(planes) > 1 and planes[1].dim() == 2 and planes[1].shape[0] == h:
        return h
    return h // 2


def _check_mvs(mv: torch.Tensor, what: str, mbh: int, mbw: int) -> None:
    _check(mv, what, (torch.int32,), 3)
    if tuple(mv.shape) != (mbh, mbw, 2):
        raise ValueError(f"{what}: shape {tuple(mv.shape)}, expected "
                         f"{(mbh, mbw, 2)}")


def _check_range(r: int) -> None:
    if not 1 <= int(r) <= ME_MAX_RANGE:
        raise ValueError(f"search range {r}: 1..{ME_MAX_RANGE}")


def mpeg2_me_ref(refs, cur: torch.Tensor, r: int):
    """Plain version of ``mpeg2_me``: ``me16_refine_math`` (io/mpeg2enc.py)
    for each reference."""
    from tcforge_tpu_torch.io.mpeg2enc import me16_refine_math
    outs = [me16_refine_math(ref, cur, r) for ref in refs]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def mpeg2_me(refs, cur: torch.Tensor, r: int):
    """The encoder's motion search of ``cur`` (a uint8 luma plane whose
    sides are multiples of 16) in each of one or two reference planes of
    its shape: per 16x16 macroblock the integer search (exhaustive for
    ``r <= 4``; else exhaustive on 2x2-decimated planes within
    ``(r+1)//2``, then +-2 at full resolution, clamped to +-r) and the
    3x3 half-pel refine, each the first strict minimum in dy-major order,
    candidates that leave the plane at ``1 << 30``.  Returns int32
    (n, mbh, mbw, 2) half-pel vectors (y, x) and int32 (n, mbh, mbw)
    SADs (``tc_me16_refine``)."""
    refs = list(refs)
    if not 1 <= len(refs) <= 2:
        raise ValueError("mpeg2_me: one or two reference planes")
    h, w = _check_yuv([cur], "cur")
    _check_mb_planes(refs, "refs", (h, w))
    _check_range(r)
    if not _on_cuda(cur, *refs):
        return mpeg2_me_ref(refs, cur, r)
    dev = cur.device
    mbh, mbw = h // 16, w // 16
    mv = torch.empty((len(refs), mbh, mbw, 2), dtype=torch.int32,
                     device=dev)
    sad = torch.empty((len(refs), mbh, mbw), dtype=torch.int32, device=dev)
    meta = [cur.data_ptr(), cur.stride(0), h, w, int(r), len(refs),
            mv.data_ptr(), sad.data_ptr()]
    for i in range(2):
        p = refs[min(i, len(refs) - 1)]
        meta += [p.data_ptr(), p.stride(0)]
    ptr, _keep = _meta(meta)
    _call("mpeg2_encode", "tc_mpeg2_me", ptr, _stream(cur))
    launches["mpeg2_me"] += 1
    return mv, sad


def mpeg2_enc_pred_ref(fwd, fmv, bwd=None, bmv=None, mode=None):
    """Plain version of ``mpeg2_enc_pred``: ``enc_pred_math``
    (io/mpeg2enc.py)."""
    from tcforge_tpu_torch.io.mpeg2enc import enc_pred_math
    return enc_pred_math(fwd, fmv, bwd, bmv, mode)


def mpeg2_enc_pred(fwd, fmv: torch.Tensor, bwd=None, bmv=None, mode=None):
    """The half-pel prediction of a picture's planes, (y,) or (y, u, v) of
    4:2:0 or 4:2:2: per macroblock from ``fwd`` at int32 (mbh, mbw, 2)
    half-pel (y, x) vectors ``fmv`` (4:2:0 chroma at the vectors halved
    toward 0 over 8x8 tiles; 4:2:2 chroma, planes of the luma's height,
    at the horizontal component alone halved, over 8-wide, 16-tall
    tiles), each sample coordinate clamped into its plane on its own
    (``tc_mc_pred_half``).
    With ``mode`` (int32 (mbh, mbw): 0 forward, 1 backward, 2 the
    average ``(f + b + 1) >> 1``) each macroblock is predicted from the
    reference(s) its mode uses, ``bwd`` at ``bmv`` for the backward one
    (``tc_b_mc_sel_pred2``).  Returns contiguous uint8 planes."""
    fwd = list(fwd)
    h, w = _check_yuv(fwd, "fwd")
    mbh, mbw = h // 16, w // 16
    _check_mvs(fmv, "fmv", mbh, mbw)
    bplanes = []
    if mode is not None:
        bplanes = list(bwd)
        if len(bplanes) != len(fwd):
            raise ValueError("bwd: one plane for each of fwd's")
        _check_yuv(bplanes, "bwd")
        for b, f in zip(bplanes, fwd):
            _check_mb_planes([b], "bwd", f.shape)
        _check_mvs(bmv, "bmv", mbh, mbw)
        _check(mode, "mode", (torch.int32,), 2)
        if tuple(mode.shape) != (mbh, mbw):
            raise ValueError(f"mode: shape {tuple(mode.shape)}")
    extra = [bmv, mode] if mode is not None else []
    if not _on_cuda(fmv, *fwd, *bplanes, *extra):
        return mpeg2_enc_pred_ref(fwd, fmv, bwd, bmv, mode)
    dev = fmv.device
    outs = tuple(torch.empty(p.shape, dtype=torch.uint8, device=dev)
                 for p in fwd)
    meta = [len(fwd), mbw, fmv.data_ptr(),
            bmv.data_ptr() if mode is not None else 0,
            mode.data_ptr() if mode is not None else 0]
    for i in range(3):
        if i < len(fwd):
            f, o = fwd[i], outs[i]
            b = bplanes[i] if bplanes else f
            meta += [f.data_ptr(), f.stride(0), b.data_ptr(), b.stride(0),
                     o.data_ptr(), o.shape[0], o.shape[1]]
        else:
            meta += [0] * 7
    ptr, _keep = _meta(meta)
    _call("mpeg2_encode", "tc_mpeg2_enc_pred", ptr, _stream(fmv))
    launches["mpeg2_enc_pred"] += 1
    return outs


def mpeg2_enc_bmode_ref(fy, by, fmv, fsad, bmv, bsad, cur):
    """Plain version of ``mpeg2_enc_bmode``: ``enc_bmode_math``
    (io/mpeg2enc.py)."""
    from tcforge_tpu_torch.io.mpeg2enc import enc_bmode_math
    return enc_bmode_math(fy, by, fmv, fsad, bmv, bsad, cur)


def mpeg2_enc_bmode(fy: torch.Tensor, by: torch.Tensor, fmv: torch.Tensor,
                    fsad: torch.Tensor, bmv: torch.Tensor,
                    bsad: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """A B picture's macroblock modes, the second entry point of the
    prediction kernel: per 16x16 macroblock the SAD of the average of
    its forward and backward luma predictions (``tc_bisad`` of two
    ``tc_mc_pred_half``), then the first minimum of ``(fsad, bsad, bisad -
    256)``: int32 (mbh, mbw), 0 forward, 1 backward, 2 both."""
    h, w = _check_yuv([cur], "cur")
    _check_mb_planes([fy, by], "refs", (h, w))
    mbh, mbw = h // 16, w // 16
    for mv, what in ((fmv, "fmv"), (bmv, "bmv")):
        _check_mvs(mv, what, mbh, mbw)
    for s, what in ((fsad, "fsad"), (bsad, "bsad")):
        _check(s, what, (torch.int32,), 2)
        if tuple(s.shape) != (mbh, mbw):
            raise ValueError(f"{what}: shape {tuple(s.shape)}")
    if not _on_cuda(fy, by, fmv, fsad, bmv, bsad, cur):
        return mpeg2_enc_bmode_ref(fy, by, fmv, fsad, bmv, bsad, cur)
    mode = torch.empty((mbh, mbw), dtype=torch.int32, device=cur.device)
    meta = [cur.data_ptr(), cur.stride(0), fy.data_ptr(), fy.stride(0),
            by.data_ptr(), by.stride(0), h, w, fmv.data_ptr(),
            fsad.data_ptr(), bmv.data_ptr(), bsad.data_ptr(),
            mode.data_ptr()]
    ptr, _keep = _meta(meta)
    _call("mpeg2_encode", "tc_mpeg2_enc_bmode", ptr, _stream(cur))
    launches["mpeg2_enc_bmode"] += 1
    return mode


@lru_cache(maxsize=None)
def _enc_tables(alt: bool):
    """The block coder's constant tables for a launch: the float64 DCT
    basis (64 doubles), and the scan order then the intra matrix (128
    ints)."""
    from tcforge_tpu_torch.io.mpeg2codec import dct_basis
    from tcforge_tpu_torch.io.mpeg2enc import intra_weights, scan_order
    basis = (ctypes.c_double * 64)(*dct_basis().reshape(-1).tolist())
    ints = (ctypes.c_int * 128)(*scan_order(alt).tolist(),
                                *intra_weights().tolist())
    return basis, ints


def mpeg2_enc_blocks_ref(mode, cur, pred, qs, alt, m1, intra_mb=None):
    """Plain version of ``mpeg2_enc_blocks``: ``enc_blocks_math``
    (io/mpeg2enc.py)."""
    from tcforge_tpu_torch.io.mpeg2enc import enc_blocks_math
    return enc_blocks_math(mode, cur, pred, qs, alt, m1, intra_mb)


def mpeg2_enc_blocks(mode: int, cur, pred, qs: int, alt: bool, m1: bool,
                     intra_mb=None):
    """The block coder of a picture's three planes: per 8x8 block
    the float64 forward DCT, the quantiser at ``qs`` (1..31; MPEG-1
    levels with ``m1``), the dequantiser (oddification with ``m1``, else
    the 13818-2 mismatch control), the float64 IDCT and the clipped
    reconstruction, the levels in scan order (alternate with ``alt``)
    written to a macroblock-interleaved int16 (nmb, 6, 64) array, or
    (nmb, 8, 64) for 4:2:2 planes (chroma of the luma's height, the
    chroma blocks of a macroblock Cb Cr Cb Cr).  ``mode`` 0: intra
    (``pred`` None); 1: inter from the uint8 prediction planes ``pred``,
    with reconstruction (an all-zero block reconstructs to its
    prediction), the blocks of the macroblocks set in ``intra_mb`` (bool
    (mbh, mbw)) coded intra instead; 2: inter levels alone.  Returns
    (levels, (rec y, u, v) or None for mode 2) (``tc_enc_intra_plane``,
    ``tc_enc_inter_plane`` with ``tc_enc_intra_sel``,
    ``tc_enc_inter_levels``)."""
    if mode not in (0, 1, 2):
        raise ValueError(f"mpeg2_enc_blocks: mode {mode}")
    if not 1 <= int(qs) <= 31:
        raise ValueError(f"qs {qs}: 1..31")
    cur = list(cur)
    if len(cur) != 3:
        raise ValueError("cur: expected (y, u, v)")
    h, w = _check_yuv(cur, "cur")
    ch = _chroma_rows(cur, h)
    mbh, mbw = h // 16, w // 16
    tensors = list(cur)
    if mode == 0:
        if pred is not None or intra_mb is not None:
            raise ValueError("intra: no prediction and no intra_mb")
    else:
        pred = list(pred)
        if len(pred) != 3:
            raise ValueError("pred: expected (y, u, v)")
        _check_mb_planes(pred[:1], "pred", (h, w))
        _check_mb_planes(pred[1:], "pred", (ch, w // 2))
        tensors += pred
    if intra_mb is not None:
        if mode != 1:
            raise ValueError("intra_mb: inter mode with reconstruction only")
        _check(intra_mb, "intra_mb", (torch.bool,), 2)
        if tuple(intra_mb.shape) != (mbh, mbw):
            raise ValueError(f"intra_mb: shape {tuple(intra_mb.shape)}")
        tensors.append(intra_mb)
    if not _on_cuda(*tensors):
        return mpeg2_enc_blocks_ref(mode, cur, pred, qs, alt, m1, intra_mb)
    dev = cur[0].device
    levels = torch.empty((mbh * mbw, 8 if ch == h else 6, 64),
                         dtype=torch.int16, device=dev)
    rec = (tuple(torch.empty(p.shape, dtype=torch.uint8, device=dev)
                 for p in cur) if mode != 2 else None)
    meta = [mode, int(qs), int(bool(m1)), mbw, levels.data_ptr(),
            intra_mb.data_ptr() if intra_mb is not None else 0]
    for i in range(3):
        p = pred[i] if pred is not None else cur[i]
        meta += [cur[i].data_ptr(), cur[i].stride(0), p.data_ptr(),
                 p.stride(0), rec[i].data_ptr() if rec else 0,
                 cur[i].shape[0], cur[i].shape[1]]
    ptr, _keep = _meta(meta)
    basis, ints = _enc_tables(bool(alt))
    _call("mpeg2_encode", "tc_mpeg2_enc_blocks", ptr,
          ctypes.cast(basis, _P), ctypes.cast(ints, _P), _stream(cur[0]))
    launches["mpeg2_enc_blocks"] += 1
    return levels, rec


# --------------------------------------------------------------------- #
# Kernel V: MPEG-4 part 2 VOP reconstruction (not a TPU kernel: the JAX
# package's device form is XLA ops, io/mpeg4jax.py)

def _vop_args(vop: torch.Tensor, mbw: int, refs, what: str
              ) -> Tuple[int, List[torch.Tensor]]:
    """Checks a VOP's records and its anchors: the macroblock rows, and
    the anchor planes ((y, u, v) uint8 on the coded grid, contiguous)."""
    _check(vop, "vop", (torch.int16,), 2)
    from tcforge_tpu_torch.io.mpeg4recon import REC
    if vop.shape[1] != REC or mbw <= 0 or vop.shape[0] % mbw:
        raise ValueError(f"vop: {tuple(vop.shape)} is not rows of {mbw} "
                         f"macroblock records of {REC}")
    mbh = vop.shape[0] // mbw
    planes: List[torch.Tensor] = []
    for ref, name in zip(refs, what):
        if ref is None:
            continue
        ref = list(ref)
        if len(ref) != 3:
            raise ValueError(f"{name}: expected (y, u, v) planes")
        for p, mb in zip(ref, (16, 8, 8)):
            _check(p, name, (torch.uint8,), 2)
            if tuple(p.shape) != (mbh * mb, mbw * mb):
                raise ValueError(f"{name}: plane {tuple(p.shape)} is not "
                                 "the coded grid")
        planes += ref
    return mbh, planes


def _vop_out(vop: torch.Tensor, mbh: int, mbw: int):
    return tuple(torch.empty((mbh * mb, mbw * mb), dtype=torch.uint8,
                             device=vop.device) for mb in (16, 8, 8))


def _recon_launch(name: str, vop: torch.Tensor, mbw: int, rounding: int,
                  fwd, bwd, warp=None):
    """Checks a P or B VOP's arguments and runs kernel ``name`` (on the
    CPU its plain version, ``io/mpeg4recon.py`` ``<name>_ref``); with an
    S-VOP's warp record ``warp``, ``mpeg4_gmc_warp`` of ``fwd`` first,
    whose planes the kernel's ``FORM_GMC`` macroblocks take."""
    if int(rounding) not in (0, 1):
        raise ValueError(f"rounding {rounding}: 0 or 1")
    _mbh, planes = _vop_args(vop, mbw, (fwd, bwd), ("fwd", "bwd"))
    if warp is not None and fwd is None:
        raise ValueError("warp: an S-VOP needs its forward anchor")
    cuda = _on_cuda(vop, *planes)
    gmc = None if warp is None else mpeg4_gmc_warp(fwd, warp)
    if not cuda:
        from tcforge_tpu_torch.io import mpeg4recon
        return getattr(mpeg4recon, f"{name}_ref")(vop, mbw, rounding, fwd,
                                                  bwd, gmc)
    return _recon_kernel(name, vop, mbw, rounding, fwd, bwd, gmc)


def _recon_kernel(name: str, vop: torch.Tensor, mbw: int, rounding: int,
                  fwd, bwd, gmc):
    """Launches kernel ``name`` on checked arguments, the warped planes
    ``gmc`` (``mpeg4_gmc_warp``'s) given exactly for an S-VOP: a launch
    whose records hold a ``FORM_GMC`` macroblock but no planes traps."""
    mbh = vop.shape[0] // mbw
    out = _vop_out(vop, mbh, mbw)
    if vop.shape[0] == 0:
        return out
    meta = [vop.data_ptr(), *(o.data_ptr() for o in out), mbw, mbh,
            int(rounding)]
    for ref in (fwd, bwd, gmc):
        meta += [0, 0, 0] if ref is None else [p.data_ptr() for p in ref]
    ptr, _keep = _meta(meta)
    _call("mpeg4_recon", f"tc_{name}", ptr, _stream(vop))
    launches[name] += 1
    return out


def _recon_plain(name: str, vop, mbw: int, rounding: int, fwd, bwd, warp):
    """Kernel ``name``'s plain version (io/mpeg4recon.py ``<name>_ref``),
    an S-VOP's planes warped by ``mpeg4_gmc_warp_ref`` first."""
    from tcforge_tpu_torch.io import mpeg4recon
    gmc = None if warp is None else mpeg4_gmc_warp_ref(fwd, warp)
    return getattr(mpeg4recon, f"{name}_ref")(vop, mbw, rounding, fwd, bwd,
                                              gmc)


def mpeg4_recon_ref(vop, mbw: int, rounding: int, fwd, bwd, warp=None):
    """Plain version of ``mpeg4_recon`` (io/mpeg4recon.py)."""
    return _recon_plain("mpeg4_recon", vop, mbw, rounding, fwd, bwd, warp)


def mpeg4_recon(vop: torch.Tensor, mbw: int, rounding: int, fwd, bwd,
                warp=None):
    """A P or B VOP's planes: int16 (nmb, ``REC``) macroblock records
    (io/mpeg4recon.py ``stage_plan``: the dequantized blocks, each luma
    block's forward and backward half-pel vectors, the chroma vectors,
    use_f, use_b and dct_type), macroblock rows of ``mbw``, the forward
    anchor ``fwd`` and backward anchor ``bwd`` ((y, u, v) uint8
    coded-grid planes, or None: a prediction from None is 0).  Per block
    the XVID integer IDCT (64-bit, as the numpy decoder), per pixel the
    half-pel prediction (``rounding`` forward, 0 backward; each sample
    coordinate clamped to the plane), the average of both where a
    macroblock uses both, and the clipped sum, the luma residual placed
    by dct_type.  ``warp``: an S-VOP's warp record (io/mpeg4plan.py
    ``warp_record``, on the host), which ``fwd`` is warped by first
    (``mpeg4_gmc_warp``, a second launch); its ``FORM_GMC`` macroblocks
    predict from those planes at their own place, and records that hold
    one need it.  Returns uint8 (16*mbh, 16*mbw) and (8*mbh, 8*mbw)
    twice."""
    return _recon_launch("mpeg4_recon", vop, mbw, rounding, fwd, bwd, warp)


def mpeg4_recon_qpel_ref(vop, mbw: int, rounding: int, fwd, bwd, warp=None):
    """Plain version of ``mpeg4_recon_qpel`` (io/mpeg4recon.py)."""
    return _recon_plain("mpeg4_recon_qpel", vop, mbw, rounding, fwd, bwd,
                        warp)


def mpeg4_recon_qpel(vop: torch.Tensor, mbw: int, rounding: int, fwd,
                     bwd, warp=None):
    """``mpeg4_recon`` for a quarter-sample VOL: the luma of a macroblock
    of form ``FORM_QPEL16`` (one 16x16 filter block) or ``FORM_QPEL8``
    (four 8x8) predicted from its quarter-sample vectors by the 8-tap
    filter, mirrored at the filter block's edges (io/mpeg4plan.py); the
    chroma half-pel from the recorded chroma vectors; ``warp`` and
    ``FORM_GMC`` as ``mpeg4_recon``."""
    return _recon_launch("mpeg4_recon_qpel", vop, mbw, rounding, fwd, bwd,
                         warp)


def mpeg4_recon_field_ref(vop, mbw: int, rounding: int, fwd, bwd, warp=None):
    """Plain version of ``mpeg4_recon_field`` (io/mpeg4recon.py)."""
    return _recon_plain("mpeg4_recon_field", vop, mbw, rounding, fwd, bwd,
                        warp)


def mpeg4_recon_field(vop: torch.Tensor, mbw: int, rounding: int, fwd,
                      bwd, warp=None):
    """``mpeg4_recon_qpel`` for an interlaced VOL: a macroblock of form
    ``FORM_FIELD`` predicted field by field (row r from field r & 1's
    half-pel vector in its reference field, rows clamped in frame
    space), from the recorded field vectors, selects and chroma
    vectors; ``warp`` and ``FORM_GMC`` as ``mpeg4_recon``."""
    return _recon_launch("mpeg4_recon_field", vop, mbw, rounding, fwd, bwd,
                         warp)


def mpeg4_idct_intra_ref(vop, mbw: int):
    """Plain version of ``mpeg4_idct_intra`` (io/mpeg4recon.py)."""
    from tcforge_tpu_torch.io import mpeg4recon
    return mpeg4recon.mpeg4_idct_intra_ref(vop, mbw)


def mpeg4_idct_intra(vop: torch.Tensor, mbw: int):
    """An I-VOP's planes from its records (the coefficients and
    dct_type): the XVID integer IDCT of every block, clipped to uint8,
    the luma placed by dct_type."""
    mbh, _ = _vop_args(vop, mbw, (), ())
    if not _on_cuda(vop):
        return mpeg4_idct_intra_ref(vop, mbw)
    out = _vop_out(vop, mbh, mbw)
    if vop.shape[0] == 0:
        return out
    ptr, _keep = _meta([vop.data_ptr(), *(o.data_ptr() for o in out), mbw,
                        mbh, 0, 0, 0, 0, 0, 0, 0])
    _call("mpeg4_recon", "tc_mpeg4_idct_intra", ptr, _stream(vop))
    launches["mpeg4_idct_intra"] += 1
    return out


def _warp_values(warp) -> List[int]:
    """An S-VOP's warp record (io/mpeg4plan.py ``warp_record``: a
    sequence of ``WARP`` integers, on the host) checked: S a power of two
    from 2 to 16, 0 to 3 points, rounding 0 or 1, a shift that leaves
    room for the chroma's two more bits."""
    from tcforge_tpu_torch.io.mpeg4plan import (W_N, W_RND, W_S, W_SH,
                                                WARP)
    values = [int(v) for v in warp]
    if len(values) != WARP:
        raise ValueError(f"warp: {len(values)} values, expected {WARP}")
    if values[W_S] not in (2, 4, 8, 16):
        raise ValueError(f"warp: S {values[W_S]} is not 2, 4, 8 or 16")
    if not 0 <= values[W_N] <= 3:
        raise ValueError(f"warp: {values[W_N]} points, 0 to 3")
    if values[W_RND] not in (0, 1):
        raise ValueError(f"warp: rounding {values[W_RND]}: 0 or 1")
    if values[W_N] != 1 and not 1 <= values[W_SH] <= 60:
        raise ValueError(f"warp: shift {values[W_SH]} out of range")
    return values


def mpeg4_gmc_warp_ref(ref, warp):
    """Plain version of ``mpeg4_gmc_warp`` (io/mpeg4recon.py)."""
    from tcforge_tpu_torch.io import mpeg4recon
    return mpeg4recon.mpeg4_gmc_warp_ref(ref, _warp_values(warp))


def mpeg4_gmc_warp(ref, warp):
    """An S-VOP's warped reference (``_gmc_warp_planes``): the three
    coded-grid planes of ``ref`` ((y, u, v) uint8, contiguous, the luma
    sides multiples of 16, the chroma half of each) sampled through the
    warp record ``warp`` (io/mpeg4plan.py ``warp_record``, on the host:
    the sprite's S, its points, the rounding and the translation or the
    affine form): per output sample its coordinate in 64 bits, the
    bilinear blend of the four samples around it, each clamped on its
    own to the plane, rounded with ``S*S/2 - rounding`` and clipped.
    Returns three new planes of ``ref``'s shapes."""
    values = _warp_values(warp)
    ref, mbh, mbw = _enc_planes(ref, "ref")
    if not _on_cuda(*ref):
        return mpeg4_gmc_warp_ref(ref, values)
    out = [torch.empty_like(p) for p in ref]
    ptr, _keep = _meta([*(p.data_ptr() for p in ref),
                        *(o.data_ptr() for o in out), 16 * mbh, 16 * mbw,
                        *values])
    _call("mpeg4_recon", "tc_mpeg4_gmc_warp", ptr, _stream(ref[0]))
    launches["mpeg4_gmc_warp"] += 1
    return tuple(out)


# --------------------------------------------------------------------- #
# Kernel VI: the MPEG-4 part 2 encoder's decisions and block coding (not
# TPU kernels: the JAX package's encoder is numpy loops,
# io/mpeg4enc.py; csrc/mpeg4_encode.cu)

def _enc_planes(planes, what: str, mbh: int = 0, mbw: int = 0):
    """(y, u, v) uint8 contiguous planes of the coded grid: the luma
    sides multiples of 16, the chroma half of each."""
    planes = list(planes) if planes is not None else []
    if len(planes) != 3:
        raise ValueError(f"{what}: expected (y, u, v) planes")
    for p in planes:
        _check(p, what, (torch.uint8,), 2)
    h, w = planes[0].shape
    if h % 16 or w % 16 or h == 0 or w == 0:
        raise ValueError(f"{what}: {w}x{h} is not a whole number of "
                         "macroblocks")
    if mbh and (h, w) != (16 * mbh, 16 * mbw):
        raise ValueError(f"{what}: {w}x{h}, expected the coded grid "
                         f"{16 * mbw}x{16 * mbh}")
    for p in planes[1:]:
        if tuple(p.shape) != (h // 2, w // 2):
            raise ValueError(f"{what}: chroma {tuple(p.shape)}, expected "
                             f"{(h // 2, w // 2)}")
    return planes, h // 16, w // 16


def _enc_records(rec: torch.Tensor, nmb: int, what: str = "rec") -> None:
    from tcforge_tpu_torch.io.mpeg4encdev import REC
    _check(rec, what, (torch.int16,), 2)
    if tuple(rec.shape) != (nmb, REC):
        raise ValueError(f"{what}: shape {tuple(rec.shape)}, expected "
                         f"{(nmb, REC)}")


def _check_search(q: int, search: int) -> None:
    from tcforge_tpu_torch.io.mpeg4encdev import MAX_SEARCH
    if not 1 <= int(q) <= 31:
        raise ValueError(f"q {q}: 1..31")
    if not 1 <= int(search) <= MAX_SEARCH:
        raise ValueError(f"search {search}: 1..{MAX_SEARCH}")


def _plane_ptrs(planes) -> list:
    return [p.data_ptr() for p in planes]


def mpeg4_enc_me_ref(cur, ref, q: int, four_mv: bool, search: int):
    """Plain version of ``mpeg4_enc_me`` (io/mpeg4encdev.py)."""
    from tcforge_tpu_torch.io import mpeg4encdev
    return mpeg4encdev.mpeg4_enc_me_ref(cur, ref, q, four_mv, search)


def mpeg4_enc_me(cur, ref, q: int, four_mv: bool, search: int):
    """A P-VOP's decisions (``_encode_pvop``'s) from the coded-grid
    planes of the frame ``cur`` and of the previous anchor's
    reconstruction ``ref``: per macroblock in raster order the median
    predictor, the three-step search from its seed and (0, 0) within
    +-``search``, the half-pel refine, intra where the mean-removed SAD
    is below the SAD less 500, with ``four_mv`` the per-block search and
    4MV where it saves more than 300, and the 4MV skip's grid at quantizer
    ``q``.  Returns int16 (nmb, ``REC``) records (io/mpeg4encdev.py)
    with the mode and vectors set; the block coder fills the rest."""
    cur, mbh, mbw = _enc_planes(cur, "cur")
    ref, _, _ = _enc_planes(ref, "ref", mbh, mbw)
    _check_search(q, search)
    if not _on_cuda(*cur, *ref):
        return mpeg4_enc_me_ref(cur, ref, q, four_mv, search)
    from tcforge_tpu_torch.io.mpeg4encdev import REC
    dev = cur[0].device
    rec = torch.empty((mbh * mbw, REC), dtype=torch.int16, device=dev)
    # the median predictor's grid and each row's progress (the wavefront)
    grid = torch.empty((2 * mbh, 2 * mbw, 2), dtype=torch.int32, device=dev)
    sync = torch.zeros((mbh + 1,), dtype=torch.int32, device=dev)
    meta = [rec.data_ptr(), *_plane_ptrs(cur), *_plane_ptrs(ref), mbw, mbh,
            int(q), int(bool(four_mv)), int(search), grid.data_ptr(),
            sync.data_ptr()]
    ptr, _keep = _meta(meta)
    _call("mpeg4_encode", "tc_mpeg4_enc_me", ptr,
          ctypes.cast(_mpeg4_basis(), _P), _stream(rec))
    launches["mpeg4_enc_me"] += 1
    return rec


def mpeg4_enc_bme_ref(cur, fwd, bwd, co, trb: int, trd: int, search: int):
    """Plain version of ``mpeg4_enc_bme`` (io/mpeg4encdev.py)."""
    from tcforge_tpu_torch.io import mpeg4encdev
    return mpeg4encdev.mpeg4_enc_bme_ref(cur, fwd, bwd, co, trb, trd, search)


def mpeg4_enc_bme(cur, fwd, bwd, co: torch.Tensor, trb: int, trd: int,
                  search: int):
    """A B-VOP's decisions (``_encode_bvop``'s) from the frame ``cur``,
    the older anchor ``fwd`` and the newer ``bwd`` (coded-grid planes)
    and the newer anchor's records ``co``: per macroblock the direct
    prediction (the co-located vectors scaled by ``trb`` / ``trd``, 0
    where it was skipped), no bits where the co-located macroblock was
    skipped, else the forward and backward searches from the row's
    predictors and the cheapest of direct, forward, backward and
    interpolated, ties to the first of (direct, interpolated, backward,
    forward).  Returns int16 (nmb, ``REC``) records with the mode and
    vectors set."""
    cur, mbh, mbw = _enc_planes(cur, "cur")
    fwd, _, _ = _enc_planes(fwd, "fwd", mbh, mbw)
    bwd, _, _ = _enc_planes(bwd, "bwd", mbh, mbw)
    _enc_records(co, mbh * mbw, "co")
    _check_search(1, search)
    if not 0 < int(trb) < int(trd):
        raise ValueError(f"trb {trb}, trd {trd}: 0 < trb < trd")
    if not _on_cuda(*cur, *fwd, *bwd, co):
        return mpeg4_enc_bme_ref(cur, fwd, bwd, co, trb, trd, search)
    from tcforge_tpu_torch.io.mpeg4encdev import REC
    rec = torch.empty((mbh * mbw, REC), dtype=torch.int16,
                      device=cur[0].device)
    meta = [rec.data_ptr(), *_plane_ptrs(cur), *_plane_ptrs(fwd),
            *_plane_ptrs(bwd), co.data_ptr(), mbw, mbh, int(trb), int(trd),
            int(search)]
    ptr, _keep = _meta(meta)
    _call("mpeg4_encode", "tc_mpeg4_enc_bme", ptr, _stream(rec))
    launches["mpeg4_enc_bme"] += 1
    return rec


@lru_cache(maxsize=None)
def _mpeg4_basis():
    """The forward DCT's float64 basis (the JAX encoder's ``_DCTM``)."""
    from tcforge_tpu_torch.io.mpeg4syntax import _DCTM
    return (ctypes.c_double * 64)(*_DCTM.reshape(-1).tolist())


def mpeg4_enc_blocks_ref(rec, cur, fwd, bwd, q: int, vop_type: int,
                         recon: bool):
    """Plain version of ``mpeg4_enc_blocks`` (io/mpeg4encdev.py)."""
    from tcforge_tpu_torch.io import mpeg4encdev
    return mpeg4encdev.mpeg4_enc_blocks_ref(rec, cur, fwd, bwd, q, vop_type,
                                            recon)


def mpeg4_enc_blocks(rec, cur, fwd, bwd, q: int, vop_type: int,
                     recon: bool):
    """The block coder of a VOP, every macroblock at once: an I-VOP
    (``vop_type`` 0, ``rec`` None) codes every macroblock intra; a P (1)
    or B (2) VOP takes the modes and vectors of its decisions' records
    ``rec``.  Per macroblock the prediction from ``fwd`` and ``bwd``
    (half-pel, rounding 0, the records' per-block and chroma vectors),
    per block the float64 forward DCT of the source or the residual (two
    fused multiply-add chains, as numpy's), the H.263 quantizer at ``q``
    (intra: the DC ``floor(F00 / scale + 0.5)``, the AC truncated), the
    dequantizer, the XVID integer IDCT and the clipped reconstruction.
    Returns (new records: the decisions with the levels, the coded block
    pattern and the skip flag; the reconstructed (y, u, v) planes, or
    None without ``recon``)."""
    from tcforge_tpu_torch.io.mpeg4encdev import REC, VOP_B, VOP_I, VOP_P
    cur, mbh, mbw = _enc_planes(cur, "cur")
    if vop_type not in (VOP_I, VOP_P, VOP_B):
        raise ValueError(f"vop_type {vop_type}")
    _check_search(q, 1)
    tensors = list(cur)
    if vop_type != VOP_I:
        _enc_records(rec, mbh * mbw)
        fwd, _, _ = _enc_planes(fwd, "fwd", mbh, mbw)
        tensors += [rec, *fwd]
    elif rec is not None:
        raise ValueError("an I-VOP takes no records")
    if vop_type == VOP_B:
        bwd, _, _ = _enc_planes(bwd, "bwd", mbh, mbw)
        tensors += bwd
    if not _on_cuda(*tensors):
        return mpeg4_enc_blocks_ref(rec, cur, fwd, bwd, q, vop_type, recon)
    dev = cur[0].device
    out = torch.empty((mbh * mbw, REC), dtype=torch.int16, device=dev)
    planes = (tuple(torch.empty(p.shape, dtype=torch.uint8, device=dev)
                    for p in cur) if recon else None)
    meta = [rec.data_ptr() if rec is not None else 0, out.data_ptr(),
            *_plane_ptrs(cur),
            *(_plane_ptrs(fwd) if vop_type != VOP_I else [0, 0, 0]),
            *(_plane_ptrs(bwd) if vop_type == VOP_B else [0, 0, 0]),
            *(_plane_ptrs(planes) if recon else [0, 0, 0]), mbw, mbh,
            int(q), int(vop_type)]
    ptr, _keep = _meta(meta)
    _call("mpeg4_encode", "tc_mpeg4_enc_blocks", ptr,
          ctypes.cast(_mpeg4_basis(), _P), _stream(out))
    launches["mpeg4_enc_blocks"] += 1
    return out, planes


# --------------------------------------------------------------------- #
# Kernel VII: baseline JPEG (Motion-JPEG and photo-JPEG video) on the
# card (not TPU kernels: the JAX package decodes JPEG through PIL);
# csrc/jpeg_decode.cu, the plain versions in io/jpeg.py

JPEG_MAX_COMPS = 3       # csrc/jpeg_decode.cu kMaxComps


def _jpeg_geometry(geom) -> None:
    from tcforge_tpu_torch.io.jpeg import Geometry
    if not isinstance(geom, Geometry):
        raise TypeError("geom: expected an io/jpeg.py Geometry")
    if not 1 <= len(geom.comps) <= JPEG_MAX_COMPS or geom.blocks <= 0:
        raise ValueError(f"geom: {len(geom.comps)} components, "
                         f"{geom.blocks} blocks a frame")


def jpeg_idct_ref(coef: torch.Tensor, qt: torch.Tensor, geom):
    """Plain version of ``jpeg_idct`` (io/jpeg.py ``idct_ref``)."""
    from tcforge_tpu_torch.io import jpeg
    return jpeg.idct_ref(coef, qt, geom)


def jpeg_idct(coef: torch.Tensor, qt: torch.Tensor, geom) -> torch.Tensor:
    """The samples of a batch of JPEG frames of one geometry ``geom``
    (io/jpeg.py ``Geometry``): int16 (blocks, 64) natural-order
    coefficients, the frames' blocks one after the other, dequantized by
    their frame's table of their component (``qt``: int16 (frames, 4,
    64), each value's low 16 bits), then libjpeg's ``jpeg_idct_islow``
    (CONST_BITS 13, PASS1_BITS 2, int32 arithmetic that wraps) and its
    range-limit table at ``x & 1023`` (out-of-range values wrap, as
    there).  Returns uint8 (blocks, 64), each block's samples in rows."""
    _jpeg_geometry(geom)
    _check(coef, "coef", (torch.int16,), 2)
    _check(qt, "qt", (torch.int16,), 3)
    if coef.shape[1] != 64 or coef.shape[0] % geom.blocks:
        raise ValueError(f"coef: {tuple(coef.shape)} is not frames of "
                         f"{geom.blocks} blocks of 64")
    frames = coef.shape[0] // geom.blocks
    if tuple(qt.shape) != (frames, 4, 64):
        raise ValueError(f"qt: {tuple(qt.shape)}, expected "
                         f"({frames}, 4, 64)")
    if not _on_cuda(coef, qt):
        return jpeg_idct_ref(coef, qt, geom)
    out = torch.empty((coef.shape[0], 64), dtype=torch.uint8,
                      device=coef.device)
    if frames == 0:
        return out
    offs = [c.off for c in geom.comps]
    offs += [geom.blocks] * (JPEG_MAX_COMPS - len(offs))
    ptr, _keep = _meta([coef.data_ptr(), qt.data_ptr(), out.data_ptr(),
                        coef.shape[0], geom.blocks, *offs[1:]])
    _call("jpeg_decode", "tc_jpeg_idct", ptr, _stream(coef))
    launches["jpeg_idct"] += 1
    return out


def jpeg_color_ref(samples: torch.Tensor, geom):
    """Plain version of ``jpeg_color`` (io/jpeg.py ``color_ref``)."""
    from tcforge_tpu_torch.io import jpeg
    return jpeg.color_ref(samples, geom)


def jpeg_color(samples: torch.Tensor, geom) -> torch.Tensor:
    """The RGB24 pixels of a batch of JPEG frames of one geometry: from
    ``jpeg_idct``'s uint8 (blocks, 64) samples, each output pixel's
    component samples upsampled as libjpeg-turbo's ``jdsample.c`` does
    (fancy h2v1 and h2v2 where the component is wider than 2 samples,
    fancy h1v2, else replication; the neighbours those of the
    component's real size, the rows above and below the image its first
    and last), then ``jdcolor.c`` ``ycc_rgb_convert`` (SCALEBITS 16,
    clamped), RGB as it is, gray to all three.  Returns uint8 (frames,
    height, width, 3)."""
    _jpeg_geometry(geom)
    _check(samples, "samples", (torch.uint8,), 2)
    if samples.shape[1] != 64 or samples.shape[0] % geom.blocks:
        raise ValueError(f"samples: {tuple(samples.shape)} is not frames "
                         f"of {geom.blocks} blocks of 64")
    if not _on_cuda(samples):
        return jpeg_color_ref(samples, geom)
    frames = samples.shape[0] // geom.blocks
    out = torch.empty((frames, geom.height, geom.width, 3),
                      dtype=torch.uint8, device=samples.device)
    if frames == 0:
        return out
    comps = []
    for c in geom.comps:
        comps += [c.off, c.bw, c.dw, c.dh, c.hf, c.vf, c.up]
    comps += [0] * (7 * (JPEG_MAX_COMPS - len(geom.comps)))
    ptr, _keep = _meta([samples.data_ptr(), out.data_ptr(), frames,
                        geom.width, geom.height, geom.blocks, geom.color,
                        len(geom.comps), *comps])
    _call("jpeg_decode", "tc_jpeg_color", ptr, _stream(samples))
    launches["jpeg_color"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel VIII: baseline JPEG encode (the movjpeg encoder) on the card (not
# TPU kernels: the JAX package encodes JPEG through PIL);
# csrc/jpeg_encode.cu, the plain versions in io/jpegenc.py


def _jpeg_enc_geometry(geom) -> None:
    from tcforge_tpu_torch.io.jpegenc import EncGeometry
    if not isinstance(geom, EncGeometry):
        raise TypeError("geom: expected an io/jpegenc.py EncGeometry")


def jpeg_ycc_down_ref(rgb: torch.Tensor, geom):
    """Plain version of ``jpeg_ycc_down`` (io/jpegenc.py
    ``ycc_down_ref``)."""
    from tcforge_tpu_torch.io import jpegenc
    return jpegenc.ycc_down_ref(rgb, geom)


def jpeg_ycc_down(rgb: torch.Tensor, geom) -> torch.Tensor:
    """The padded YCbCr planes of a batch of RGB24 frames of one size
    ``geom`` (io/jpegenc.py ``EncGeometry``): uint8 (frames, height,
    width, 3) to uint8 (frames, plane_bytes), the Y plane (16 mcuy x 16
    mcux), then Cb and Cr (8 mcuy x 8 mcux each): libjpeg-turbo's
    ``rgb_ycc_convert`` and ``h2v2_downsample``, the last column and row
    repeated past the image."""
    _jpeg_enc_geometry(geom)
    _check(rgb, "rgb", (torch.uint8,), 4)
    if tuple(rgb.shape[1:]) != (geom.height, geom.width, 3):
        raise ValueError(f"rgb: {tuple(rgb.shape)}, expected (frames, "
                         f"{geom.height}, {geom.width}, 3)")
    if not _on_cuda(rgb):
        return jpeg_ycc_down_ref(rgb, geom)
    frames = rgb.shape[0]
    out = torch.empty((frames, geom.plane_bytes), dtype=torch.uint8,
                      device=rgb.device)
    if frames == 0:
        return out
    ptr, _keep = _meta([rgb.data_ptr(), out.data_ptr(), frames, geom.width,
                        geom.height, 8 * geom.mcux, 8 * geom.mcuy])
    _call("jpeg_encode", "tc_jpeg_ycc_down", ptr, _stream(rgb))
    launches["jpeg_ycc_down"] += 1
    return out


def jpeg_fdct_quant_ref(planes: torch.Tensor, div: torch.Tensor, geom):
    """Plain version of ``jpeg_fdct_quant`` (io/jpegenc.py
    ``fdct_quant_ref``)."""
    from tcforge_tpu_torch.io import jpegenc
    return jpegenc.fdct_quant_ref(planes, div, geom)


def jpeg_fdct_quant(planes: torch.Tensor, div: torch.Tensor,
                    geom) -> torch.Tensor:
    """The quantized coefficients of a batch of frames from
    ``jpeg_ycc_down``'s planes: libjpeg's ``jpeg_fdct_islow`` on each
    block, quantized through the int32 (2, 3, 64) divisors (io/jpegenc.py
    ``divisors``: reciprocal, correction and shift of each natural-order
    entry, luminance then chrominance).  Returns int16 (frames, blocks,
    64): MCU after MCU (four Y blocks, Cb, Cr), zigzag order in a block,
    the blocks past the image's edges ``compress_data``'s dummies (the DC
    of the block before them, zero AC)."""
    _jpeg_enc_geometry(geom)
    _check(planes, "planes", (torch.uint8,), 2)
    _check(div, "div", (torch.int32,), 3)
    if planes.shape[1] != geom.plane_bytes:
        raise ValueError(f"planes: {tuple(planes.shape)}, expected "
                         f"(frames, {geom.plane_bytes})")
    if tuple(div.shape) != (2, 3, 64):
        raise ValueError(f"div: {tuple(div.shape)}, expected (2, 3, 64)")
    if not _on_cuda(planes, div):
        return jpeg_fdct_quant_ref(planes, div, geom)
    frames = planes.shape[0]
    out = torch.empty((frames, geom.blocks, 64), dtype=torch.int16,
                      device=planes.device)
    if frames == 0:
        return out
    ptr, _keep = _meta([planes.data_ptr(), div.data_ptr(), out.data_ptr(),
                        frames, geom.mcux, geom.mcuy, geom.yw, geom.yh])
    _call("jpeg_encode", "tc_jpeg_fdct_quant", ptr, _stream(planes))
    launches["jpeg_fdct_quant"] += 1
    return out


# --------------------------------------------------------------------- #
# Kernel IX: DV25 both ways (the dv import module, encoder and
# multiplexor) on the card (not TPU kernels: the JAX package's DV codec
# is numpy); csrc/dv.cu, the plain versions in io/dvcodec.py


def _dv_system(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> bool:
    """True for PAL planes (576x720, 4:2:0 chroma 288x360), False for NTSC
    (480x720, 4:1:1 chroma 480x180); raises for anything else."""
    from tcforge_tpu_torch.io import dvcodec
    for what, t in (("y", y), ("u", u), ("v", v)):
        _check(t, what, (torch.uint8,), 3)
    for pal in (True, False):
        (yh, yw), (ch, cw) = dvcodec.plane_shapes(pal)
        frames = y.shape[0]
        if (tuple(y.shape) == (frames, yh, yw)
                and tuple(u.shape) == (frames, ch, cw)
                and tuple(v.shape) == (frames, ch, cw)):
            return pal
    raise ValueError(f"dv planes: y {tuple(y.shape)}, u {tuple(u.shape)}, "
                     f"v {tuple(v.shape)} are neither PAL 4:2:0 nor NTSC "
                     "4:1:1")


def _dv_geometry(pal: bool) -> List[int]:
    from tcforge_tpu_torch.io import dvcodec
    (yh, yw), (ch, cw) = dvcodec.plane_shapes(pal)
    return [dvcodec.frame_blocks(pal), yw, yh, cw, ch]


@lru_cache(maxsize=None)
def _dv_tables(device: torch.device, pal: bool):
    """The kernels' tables on ``device``: placement, the transposed
    basis, the factors as float64, the scans, the cost table."""
    from tcforge_tpu_torch.io import dvcodec
    import numpy as np
    place = torch.from_numpy(dvcodec.placement(pal)).to(device)
    basis_t = torch.from_numpy(np.ascontiguousarray(
        dvcodec.basis().transpose(0, 2, 1))).to(device)
    fac = torch.from_numpy(dvcodec.factors().astype(np.float64)).to(device)
    zz = torch.from_numpy(dvcodec.zigzag().astype(np.int32)).to(device)
    cost = torch.from_numpy(dvcodec.cost_table()).to(device)
    return place, basis_t, fac, zz, cost


def dv_idct_ref(coef: torch.Tensor, mode: torch.Tensor, pal: bool):
    """Plain version of ``dv_idct`` (io/dvcodec.py ``dv_idct_ref``)."""
    from tcforge_tpu_torch.io import dvcodec
    return dvcodec.dv_idct_ref(coef, mode, pal)


def dv_idct(coef: torch.Tensor, mode: torch.Tensor, pal: bool):
    """The planes of a batch of DV frames from their host parse's records
    (io/dvcodec.py): int16 (frames * blocks, 64) dequantized coefficients
    in raster order and uint8 (frames * blocks,) DCT modes, the blocks in
    bitstream order.  Each block's exact integer IDCT (``idct88``, its
    dc-only rows ``dc << 3``; or ``idct248`` where its mode is 1), clipped
    to 0..255, into its place in the planes.  Returns uint8 y (frames,
    576, 720), u and v (frames, 288, 360) for PAL; (frames, 480, 720) and
    (frames, 480, 180) for NTSC."""
    from tcforge_tpu_torch.io import dvcodec
    _check(coef, "coef", (torch.int16,), 2)
    _check(mode, "mode", (torch.uint8,), 1)
    nb = dvcodec.frame_blocks(pal)
    if coef.shape[1] != 64 or coef.shape[0] % nb \
            or mode.shape[0] != coef.shape[0]:
        raise ValueError(f"coef {tuple(coef.shape)}, mode "
                         f"{tuple(mode.shape)}: not frames of {nb} blocks")
    if not _on_cuda(coef, mode):
        return dv_idct_ref(coef, mode, pal)
    frames = coef.shape[0] // nb
    (yh, yw), (ch, cw) = dvcodec.plane_shapes(pal)
    dev = coef.device
    y = torch.empty((frames, yh, yw), dtype=torch.uint8, device=dev)
    u = torch.empty((frames, ch, cw), dtype=torch.uint8, device=dev)
    v = torch.empty_like(u)
    if frames == 0:
        return y, u, v
    place = _dv_tables(dev, pal)[0]
    ptr, _keep = _meta([coef.data_ptr(), mode.data_ptr(), place.data_ptr(),
                        y.data_ptr(), u.data_ptr(), v.data_ptr(), frames,
                        *_dv_geometry(pal)])
    _call("dv", "tc_dv_idct", ptr, _stream(coef))
    launches["dv_idct"] += 1
    return y, u, v


def dv_fdct_cost_ref(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     qno=None):
    """Plain version of ``dv_fdct_cost`` (io/dvcodec.py
    ``fdct_cost_ref``)."""
    from tcforge_tpu_torch.io import dvcodec
    return dvcodec.fdct_cost_ref((y, u, v), _dv_system(y, u, v), qno)


def dv_fdct_cost(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 qno=None):
    """The device half of the DV25 encoder on a batch of PAL 4:2:0 or NTSC
    4:1:1 planes: each block (bitstream order) cut from the planes, its
    mode (``_pick_modes``), its float64 forward transform (the pinned
    ``_F88``/``_F248`` in OpenBLAS's gemv order) and DC, then without
    ``qno``: (int16 (n, 16, 2) the class and AC bits at qno 0..15, int16
    (n,) DC, uint8 (n,) mode), the table the host's rate fit reads; with
    uint8 ``qno`` (n / 6,), each macroblock's chosen qno: (int16 (n, 64)
    zigzag levels, uint8 (n,) class)."""
    from tcforge_tpu_torch.io import dvcodec
    pal = _dv_system(y, u, v)
    nblocks = y.shape[0] * dvcodec.frame_blocks(pal)
    if qno is not None:
        _check(qno, "qno", (torch.uint8,), 1)
        if qno.shape[0] * 6 != nblocks:
            raise ValueError(f"qno: {tuple(qno.shape)}, expected "
                             f"({nblocks // 6},)")
        tensors = (y, u, v, qno)
    else:
        tensors = (y, u, v)
    if not _on_cuda(*tensors):
        return dv_fdct_cost_ref(y, u, v, qno)
    dev = y.device
    if qno is None:
        out = torch.empty((nblocks, dvcodec.QNOS, 2), dtype=torch.int16,
                          device=dev)
        dc = torch.empty((nblocks,), dtype=torch.int16, device=dev)
    else:
        out = torch.empty((nblocks, 64), dtype=torch.int16, device=dev)
        dc = None
    small = torch.empty((nblocks,), dtype=torch.uint8, device=dev)
    if nblocks == 0:
        return (out, dc, small) if qno is None else (out, small)
    place, basis_t, fac, zz, cost = _dv_tables(dev, pal)
    ptr, _keep = _meta([
        y.data_ptr(), u.data_ptr(), v.data_ptr(), place.data_ptr(),
        basis_t.data_ptr(), fac.data_ptr(), zz.data_ptr(), cost.data_ptr(),
        0 if qno is None else qno.data_ptr(), out.data_ptr(),
        0 if dc is None else dc.data_ptr(), small.data_ptr(), y.shape[0],
        *_dv_geometry(pal)])
    _call("dv", "tc_dv_fdct_cost", ptr, _stream(y))
    launches["dv_fdct_cost"] += 1
    return (out, dc, small) if qno is None else (out, small)


# --------------------------------------------------------------------- #
# Kernel X: RTjpeg both ways (the nuv import module and the nuvrtj
# encoder) on the card (not TPU kernels: the JAX package's RTjpeg is
# numpy); csrc/rtjpeg.cu, the plain versions in io/rtjcodec.py


def _rtjpeg_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[int, int]:
    from tcforge_tpu_torch.io import rtjcodec
    for what, t in (("y", y), ("u", u), ("v", v)):
        _check(t, what, (torch.uint8,), 3)
    frames, height, width = y.shape
    rtjcodec.check_geometry(width, height)
    half = (frames, height // 2, width // 2)
    if tuple(u.shape) != half or tuple(v.shape) != half:
        raise ValueError(f"u {tuple(u.shape)}, v {tuple(v.shape)}: "
                         f"expected {half}")
    return width, height


def rtjpeg_fdct_quant_ref(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          qt: torch.Tensor) -> torch.Tensor:
    """Plain version of ``rtjpeg_fdct_quant`` (io/rtjcodec.py
    ``fdct_quant_ref``)."""
    from tcforge_tpu_torch.io import rtjcodec
    return rtjcodec.fdct_quant_ref(y, u, v, qt)


def rtjpeg_fdct_quant(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      qt: torch.Tensor) -> torch.Tensor:
    """The quantized blocks of a batch of 4:2:0 frames (a multiple of 16
    each way) as RTjpeg codes them: each block in stream order
    (``_mb_blocks``), the AAN integer forward DCT (``fdct_blocks``) and
    ``quant_blocks`` with the int64 (2, 64) forward quantizers (luma,
    chroma; io/rtjcodec.py ``compress_tables``).  Returns int16 (frames *
    blocks, 64) in natural order."""
    from tcforge_tpu_torch.io import rtjcodec
    width, height = _rtjpeg_planes(y, u, v)
    _check(qt, "qt", (torch.int64,), 2)
    if tuple(qt.shape) != (2, 64):
        raise ValueError(f"qt: {tuple(qt.shape)}, expected (2, 64)")
    if not _on_cuda(y, u, v, qt):
        return rtjpeg_fdct_quant_ref(y, u, v, qt)
    frames = y.shape[0]
    out = torch.empty((frames * rtjcodec.frame_blocks(width, height), 64),
                      dtype=torch.int16, device=y.device)
    if frames == 0:
        return out
    ptr, _keep = _meta([y.data_ptr(), u.data_ptr(), v.data_ptr(),
                        qt.data_ptr(), out.data_ptr(), frames, width,
                        height])
    _call("rtjpeg", "tc_rtjpeg_fdct_quant", ptr, _stream(y))
    launches["rtjpeg_fdct_quant"] += 1
    return out


def rtjpeg_idct_ref(coef: torch.Tensor, width: int, height: int):
    """Plain version of ``rtjpeg_idct`` (io/rtjcodec.py ``idct_ref``)."""
    from tcforge_tpu_torch.io import rtjcodec
    return rtjcodec.idct_ref(coef, width, height)


def rtjpeg_idct(coef: torch.Tensor, width: int, height: int):
    """The 4:2:0 planes of a batch of RTjpeg frames of ``width`` x
    ``height`` from the host decoder's int32 (frames * blocks, 64)
    dequantized coefficients (natural order, stream order of blocks):
    ``idct_blocks`` (the AAN inverse DCT, 64-bit, range-limited to
    16..235) into each block's place.  Returns uint8 y (frames, height,
    width), u and v (frames, height / 2, width / 2)."""
    from tcforge_tpu_torch.io import rtjcodec
    rtjcodec.check_geometry(width, height)
    _check(coef, "coef", (torch.int32,), 2)
    nb = rtjcodec.frame_blocks(width, height)
    if coef.shape[1] != 64 or coef.shape[0] % nb:
        raise ValueError(f"coef {tuple(coef.shape)}: not frames of {nb} "
                         "blocks of 64")
    if not _on_cuda(coef):
        return rtjpeg_idct_ref(coef, width, height)
    frames = coef.shape[0] // nb
    dev = coef.device
    y = torch.empty((frames, height, width), dtype=torch.uint8, device=dev)
    u = torch.empty((frames, height // 2, width // 2), dtype=torch.uint8,
                    device=dev)
    v = torch.empty_like(u)
    if frames == 0:
        return y, u, v
    ptr, _keep = _meta([coef.data_ptr(), y.data_ptr(), u.data_ptr(),
                        v.data_ptr(), frames, width, height])
    _call("rtjpeg", "tc_rtjpeg_idct", ptr, _stream(coef))
    launches["rtjpeg_idct"] += 1
    return y, u, v


# --------------------------------------------------------------------- #
# Kernel XI: Theora both ways (the ogg importer's Theora decode and the
# theora encoder) on the card (not TPU kernels: the JAX package's Theora
# is numpy); csrc/theora.cu, the plain versions in io/theoracodec.py


def _theora_planes(planes, fmt: int, fw: int, fh: int, what: str) -> None:
    from tcforge_tpu_torch.io import theoracodec
    dims = theoracodec.plane_dims(fmt, fw, fh)
    if len(planes) != 3:
        raise ValueError(f"{what}: expected three planes")
    for t, hw in zip(planes, dims):
        _check(t, what, (torch.uint8,), 2)
        if tuple(t.shape) != hw:
            raise ValueError(f"{what}: plane {tuple(t.shape)}, expected {hw}")


def _theora_blocks(fmt: int, fw: int, fh: int) -> int:
    from tcforge_tpu_torch.io import theoracodec
    if fw <= 0 or fh <= 0 or fw % 16 or fh % 16:
        raise ValueError(f"theora: frame {fw}x{fh} is not whole macroblocks")
    return sum((h // 8) * (w // 8)
               for h, w in theoracodec.plane_dims(fmt, fw, fh))


def theora_recon_ref(coefs, coded, qiidx, mbrec, qmats, last, golden,
                     fmt: int, fw: int, fh: int):
    """Plain version of ``theora_recon`` (io/theoracodec.py
    ``recon_ref``)."""
    from tcforge_tpu_torch.io import theoracodec
    return theoracodec.recon_ref(coefs, coded, qiidx, mbrec, qmats, last,
                                 golden, fmt, fw, fh)


def theora_recon(coefs: torch.Tensor, coded: torch.Tensor,
                 qiidx: torch.Tensor, mbrec: torch.Tensor,
                 qmats: torch.Tensor, last, golden, fmt: int, fw: int,
                 fh: int):
    """A Theora frame's planes before the loop filter (``_reconstruct``):
    int32 (n, 64) zigzag coefficients with predicted DCs, uint8 (n,)
    coded flags and qi indexes (blocks by id: planes in turn, raster
    order), int32 (mbs, 9) macroblock records (io/theoracodec.py), int32
    (2, 3, 3, 64) raster quantizer matrices [qti][plane][qi index];
    ``last`` and ``golden`` the three uint8 reference planes of an inter
    frame, None for an intra frame.  Each coded block dequantized (its DC
    at the first qi), the spec's integer IDCT with numpy's int32
    wrapping, plus 128 (intra) or the half-pel prediction from ``last``
    or ``golden``, clipped; an uncoded block copies ``last``.  Returns
    three uint8 planes of format ``fmt`` (0 4:2:0, 2 4:2:2, 3 4:4:4) of a
    ``fw`` x ``fh`` frame."""
    nb = _theora_blocks(fmt, fw, fh)
    _check(coefs, "coefs", (torch.int32,), 2)
    _check(coded, "coded", (torch.uint8,), 1)
    _check(qiidx, "qiidx", (torch.uint8,), 1)
    _check(mbrec, "mbrec", (torch.int32,), 2)
    _check(qmats, "qmats", (torch.int32,), 4)
    if tuple(coefs.shape) != (nb, 64) or coded.shape[0] != nb \
            or qiidx.shape[0] != nb:
        raise ValueError(f"coefs {tuple(coefs.shape)}, coded "
                         f"{tuple(coded.shape)}, qiidx {tuple(qiidx.shape)}:"
                         f" expected {nb} blocks")
    if tuple(mbrec.shape) != ((fw // 16) * (fh // 16), 9):
        raise ValueError(f"mbrec: {tuple(mbrec.shape)}")
    if tuple(qmats.shape) != (2, 3, 3, 64):
        raise ValueError(f"qmats: {tuple(qmats.shape)}")
    if (last is None) != (golden is None):
        raise ValueError("last and golden: both or neither")
    refs = ()
    if last is not None:
        _theora_planes(last, fmt, fw, fh, "last")
        _theora_planes(golden, fmt, fw, fh, "golden")
        refs = (*last, *golden)
    if not _on_cuda(coefs, coded, qiidx, mbrec, qmats, *refs):
        return theora_recon_ref(coefs, coded, qiidx, mbrec, qmats, last,
                                golden, fmt, fw, fh)
    from tcforge_tpu_torch.io import theoracodec
    out = tuple(torch.empty(hw, dtype=torch.uint8, device=coefs.device)
                for hw in theoracodec.plane_dims(fmt, fw, fh))
    ref_ptrs = [t.data_ptr() for t in refs] if refs else [0] * 6
    ptr, _keep = _meta([coefs.data_ptr(), coded.data_ptr(), qiidx.data_ptr(),
                        mbrec.data_ptr(), qmats.data_ptr(), *ref_ptrs,
                        *(t.data_ptr() for t in out), fmt, fw, fh])
    _call("theora", "tc_theora_recon", ptr, _stream(coefs))
    launches["theora_recon"] += 1
    return out


def theora_loop_filter_ref(planes, coded, lim: int, fmt: int, fw: int,
                           fh: int):
    """Plain version of ``theora_loop_filter`` (io/theoracodec.py
    ``loop_filter_ref``)."""
    from tcforge_tpu_torch.io import theoracodec
    return theoracodec.loop_filter_ref(planes, coded, lim, fmt, fw, fh)


def theora_loop_filter(planes, coded: torch.Tensor, lim: int, fmt: int,
                       fw: int, fh: int):
    """The spec's loop filter (``_loop_filter``) on the three uint8
    planes of a ``fw`` x ``fh`` frame of format ``fmt`` with the uint8
    (n,) coded flags and the limit ``lim`` (``lflims[qi0]``, > 0): in
    raster block order, in place on a copy, each coded block's left and
    top edges, then its right and bottom ones where that neighbour is
    uncoded.  Returns the three filtered planes."""
    nb = _theora_blocks(fmt, fw, fh)
    _theora_planes(planes, fmt, fw, fh, "planes")
    _check(coded, "coded", (torch.uint8,), 1)
    if coded.shape[0] != nb:
        raise ValueError(f"coded: {tuple(coded.shape)}, expected ({nb},)")
    if not 0 < lim < 128:
        raise ValueError(f"lim: {lim}, expected 1..127")
    if not _on_cuda(*planes, coded):
        return theora_loop_filter_ref(planes, coded, lim, fmt, fw, fh)
    out = tuple(p.clone() for p in planes)
    ptr, _keep = _meta([*(t.data_ptr() for t in out), coded.data_ptr(), lim,
                        fmt, fw, fh])
    _call("theora", "tc_theora_loop_filter", ptr, _stream(coded))
    launches["theora_loop_filter"] += 1
    return out


def theora_fdct_quant_ref(resid, group, qmat):
    """Plain version of ``theora_fdct_quant`` (io/theoracodec.py
    ``fdct_quant_ref``)."""
    from tcforge_tpu_torch.io import theoracodec
    return theoracodec.fdct_quant_ref(resid, group, qmat)


@lru_cache(maxsize=None)
def _theora_basis(device: torch.device) -> torch.Tensor:
    from tcforge_tpu_torch.io import theoracodec
    return torch.from_numpy(theoracodec.basis()).to(device)


def theora_fdct_quant(resid: torch.Tensor, group: torch.Tensor,
                      qmat: torch.Tensor) -> torch.Tensor:
    """The Theora encoder's quantized blocks (``_quantize_blocks``): int16
    (n, 64) raster residual blocks, uint8 (n,) group ``qti * 3 + plane``,
    int32 (2, 3, 64) raster quantizer matrices; the float64 forward DCT
    in numpy's einsum order without fused multiply-adds, divided by the
    group's matrix, rounded half to even (intra) or with the inter dead
    zone, clipped to +-580.  Returns int32 (n, 64) in zigzag order."""
    _check(resid, "resid", (torch.int16,), 2)
    _check(group, "group", (torch.uint8,), 1)
    _check(qmat, "qmat", (torch.int32,), 3)
    if resid.shape[1] != 64 or group.shape[0] != resid.shape[0]:
        raise ValueError(f"resid {tuple(resid.shape)}, group "
                         f"{tuple(group.shape)}")
    if tuple(qmat.shape) != (2, 3, 64):
        raise ValueError(f"qmat: {tuple(qmat.shape)}, expected (2, 3, 64)")
    if not _on_cuda(resid, group, qmat):
        return theora_fdct_quant_ref(resid, group, qmat)
    n = resid.shape[0]
    out = torch.empty((n, 64), dtype=torch.int32, device=resid.device)
    if n == 0:
        return out
    basis = _theora_basis(resid.device)
    ptr, _keep = _meta([resid.data_ptr(), group.data_ptr(), qmat.data_ptr(),
                        basis.data_ptr(), out.data_ptr(), n])
    _call("theora", "tc_theora_fdct_quant", ptr, _stream(resid))
    launches["theora_fdct_quant"] += 1
    return out


def theora_me_ref(src, ref, order, lam: float, sse_floor: float):
    """Plain version of ``theora_me`` (io/theoracodec.py ``me_ref``)."""
    from tcforge_tpu_torch.io import theoracodec
    return theoracodec.me_ref(src, ref, order, lam, sse_floor)


def _f64_bits(x: float) -> int:
    import struct
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def theora_me(src: torch.Tensor, ref: torch.Tensor, order: torch.Tensor,
              lam: float, sse_floor: float) -> torch.Tensor:
    """The Theora encoder's macroblock decisions (``_choose_modes`` with
    ``_search_mv``) on a coded luma plane ``src`` against the
    reconstructed ``ref`` (uint8 (H, W), multiples of 16), the
    macroblocks walked in int32 ``order`` (raster indexes in coded order):
    every macroblock's SAD at every half-pel vector and its statistics in
    parallel, then the walk with its LAST/LAST2 chain, the three-step
    search and the half-pel refine, the float64 costs with ``lam`` and
    the skip floor ``sse_floor``.  Returns int32 (mbs, 7): mode (-1 where
    no luma block is coded), mvx, mvy, the four luma coded flags."""
    _check(src, "src", (torch.uint8,), 2)
    _check(ref, "ref", (torch.uint8,), 2)
    _check(order, "order", (torch.int32,), 1)
    h, w = src.shape
    if h % 16 or w % 16 or tuple(ref.shape) != (h, w):
        raise ValueError(f"src {tuple(src.shape)}, ref {tuple(ref.shape)}")
    nmb = (h // 16) * (w // 16)
    if order.shape[0] != nmb:
        raise ValueError(f"order: {tuple(order.shape)}, expected ({nmb},)")
    if not _on_cuda(src, ref, order):
        return theora_me_ref(src, ref, order, lam, sse_floor)
    from tcforge_tpu_torch.io import theoracodec
    dev = src.device
    table = torch.empty((nmb, theoracodec.MV_SPAN ** 2), dtype=torch.int32,
                        device=dev)
    stats = torch.empty((nmb, 5), dtype=torch.int32, device=dev)
    out = torch.empty((nmb, theoracodec.ME_COLS), dtype=torch.int32,
                      device=dev)
    ptr, _keep = _meta([src.data_ptr(), ref.data_ptr(), order.data_ptr(),
                        table.data_ptr(), stats.data_ptr(), out.data_ptr(),
                        h, w, _f64_bits(lam), _f64_bits(sse_floor)])
    _call("theora", "tc_theora_me", ptr, _stream(src))
    launches["theora_me"] += 1
    return out
