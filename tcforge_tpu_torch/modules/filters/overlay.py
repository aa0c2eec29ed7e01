"""Overlay and region filters: logo, logoaway, fieldanalysis, 29to23,
cpaudio.

The port of ``tcforge_tpu/modules/filters/overlay.py``:

- logo (``filter_logo.c``): an image (or an animated sequence) over the
  frame at a position, blended by its alpha in the reference's Q16
  integers.  The YUV planes of the logo are made once, on the chain's
  device (``init_state``); with ``hqconv`` its chroma goes through the
  Lanczos3 zoom (``ops/zoom.py``, the ``zoom_pass`` kernel on the card).
  A PNG or PNM logo loads through ``io/image.py``; only another format
  (an animated GIF) goes through Pillow.
- logoaway (``filter_logoaway.c``): paints a region out by solid fill,
  XY interpolation from its borders (corner, top row, left column, then
  the interior, as the reference's walk reads its own writes back) or
  the shape of an alpha image.
- fieldanalysis (``filter_fieldanalysis.c``): the five field metrics of
  every frame on the device, then one read-back a batch of the
  per-frame decisions, and the telecine state machine and the frame
  counters on the host; ``finalize`` logs the RESULTS and CONCLUSION
  lines.
- 29to23 (``filter_29to23.c``): the fps filter at 29.97 -> 23.976.
- cpaudio (``filter_cpaudio.c``): one audio channel copied over the
  other (an ``AudioFilter``; the video chain builds it and skips it,
  the audio chain runs it).

Float32 divisions by a constant are the jitted JAX filters' products
with the float32 reciprocal (``ops/fp32.py``), logo's faded opacity the
fused multiply-add of the compiled code, and fieldanalysis sums its row
sums in XLA's order (``ops/fp32.py`` ``tree_sum``).
"""

from __future__ import annotations

import logging
from typing import Any, List, Tuple

import numpy as np
import torch

from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.frame import ATTR_SKIPPED, AudioBatch, FrameBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (AudioFilter, FilterSlot,
                                                ModuleInfo, ModuleKind,
                                                VideoFilter, register)
from tcforge_tpu_torch.ops.fp32 import fma32, recip32, tree_sum

_log = logging.getLogger("tcforge_tpu_torch")


def _ids(fb: FrameBatch) -> torch.Tensor:
    return (fb.frame_ids if fb.frame_ids is not None
            else torch.arange(fb.batch, dtype=torch.int32, device=fb.device))


@register
class LogoFilter(VideoFilter):
    """filter_logo.c: render an image (or animated sequence) over the
    video with per-pixel alpha blending.

    - alpha: GraphicsMagick "opacity" (0 = visible).  opacity==0 copies
      the logo pixel, opacity==MaxRGB keeps the video, anything between
      blends with per-term uint8 truncation (``render_logo_yuv:652-664``)
      in Q16 integers (opacity_q = 257*byte, ScaleQuantumToChar =
      round(q/257)).
    - fade=in-out (``set_fade:378-393``): opacity_q +=
      trunc((MaxRGB-opacity_q)*coeff), coeff ramping over the first
      `fadein` / last `fadeout` frames of `range`.
    - YUV logos: RGB->YUV420P, or with `hqconv` RGB->YUV444P and a
      Lanczos3 chroma zoom (``setup_logo_yuv:480-545``).  U/V are
      blended only at even rows/cols using that pixel's opacity;
      `grayout` skips chroma.
    - animation (``set_delay:395-409``): image i shows for
      delay_i*fps/100 frames (+1 after the first cycle); `ignoredelay`
      advances every frame; a closed form per frame id.
    - RGB frames are top-down like every other filter, so `pos` means
      the same visual spot and `flip` is a plain mirror.
    """

    info = ModuleInfo(name="logo", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="logo", comment="render image in videostream",
        capabilities="VRY",
        params=[ParamSpec("file", "image to overlay", "s", ""),
                ParamSpec("posdef", "0=None 1=TopL 2=TopR 3=BotL "
                          "4=BotR 5=Center", "d", 0, 0, 5),
                ParamSpec("pos", "position XxY", "dxd", (0, 0)),
                ParamSpec("range", "restrict to framerange",
                          "d-d", (0, 0x7FFFFFFF)),
                ParamSpec("fade", "fade in/out (# of frames)",
                          "d-d", (0, 0)),
                ParamSpec("flip", "mirror image", "b", False),
                ParamSpec("rgbswap", "swap red/blue", "b", False),
                ParamSpec("grayout", "YUV only: don't write Cb/Cr",
                          "b", False),
                ParamSpec("hqconv", "YUV only: high quality rgb->yuv",
                          "b", False),
                ParamSpec("ignoredelay", "ignore animation delays",
                          "b", False)])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        path = self.options["file"]
        if not path:
            raise ValueError("logo: 'file' option is required")
        frames, delays_cs = _load_logo_frames(path)
        if self.options["flip"]:
            frames = [np.flip(f, axis=0) for f in frames]
        if self.options["rgbswap"]:
            frames = [f[..., [2, 1, 0, 3]] for f in frames]
        self._rgba = np.ascontiguousarray(np.stack(frames))  # (S, h, w, 4)
        fps = job.fps if job.fps > 0 else 25.0
        # filter_logo.c:407/748: frames per image = delay*fps/100
        self._delays = [int(d * fps / 100.0) for d in delays_cs]
        self._yuv = None
        self._dev = None

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        """The logo's tensors on ``device``: setup_logo_yuv runs at
        configure time in the reference too."""
        h, w = self._rgba.shape[1:3]
        self._rgba_t = torch.from_numpy(self._rgba).to(device)
        self._dev = self._rgba_t.device
        ob = 255 - self._rgba_t[..., 3].to(torch.int32)    # opacity byte
        self._opacity_q = ob * 257
        self._yuv = None if (h | w) & 1 else self._make_yuv_planes(device)
        return None

    # ---- configure-time helpers ---- #

    def _position(self, fw: int, fh: int) -> Tuple[int, int]:
        """flogo_compute_position (filter_logo.c:318-357), top-down."""
        lh, lw = self._rgba.shape[1:3]
        if lw > fw or lh > fh:
            raise ValueError("logo: image is larger than the frame")
        preset = self.options["posdef"]
        x, y = self.options["pos"]
        if preset == 1:
            x, y = 0, 0
        elif preset == 2:
            x = fw - lw
        elif preset == 3:
            y = fh - lh
        elif preset == 4:
            x, y = fw - lw, fh - lh
        elif preset == 5:
            x, y = (fw - lw) // 2, (fh - lh) // 2
            x += x & 1                # align to even, logo.c:344-347
            y += y & 1
        if x < 0 or y < 0 or x + lw > fw or y + lh > fh:
            raise ValueError("logo: invalid position")
        return x, y

    def _make_yuv_planes(self, device: torch.device):
        """setup_logo_yuv: per-sequence-frame YUV420P logo planes, int32
        on ``device``."""
        from tcforge_tpu_torch.ops.colorspace import rgb_to_yuv_pixels
        from tcforge_tpu_torch.ops.zoom import zoom_plane
        h, w = self._rgba.shape[1:3]
        y, u, v = rgb_to_yuv_pixels(self._rgba_t[..., :3])
        if self.options["hqconv"]:
            u = zoom_plane(u.to(torch.uint8), w // 2, h // 2,
                           "lanczos3").to(torch.int32)
            v = zoom_plane(v.to(torch.uint8), w // 2, h // 2,
                           "lanczos3").to(torch.int32)
        else:
            # 4:2:0 siting: U from (even, even), V from (odd, odd)
            u, v = u[..., 0::2, 0::2], v[..., 1::2, 1::2]
        return y.contiguous(), u.contiguous(), v.contiguous()

    # ---- per-frame schedule (vectorized over frame ids) ---- #

    def _seq_index(self, k: torch.Tensor) -> torch.Tensor:
        """set_delay closed form: sequence index for the k-th in-range
        frame.  Image 0 shows d0 frames, then the cycle
        [1]*(d1+1) ... [n-1]*(dn-1+1) [0]*(d0+1) repeats."""
        n = len(self._delays)
        if n == 1:
            return torch.zeros_like(k)
        if self.options["ignoredelay"]:
            return (k + 1) % n
        d = self._delays
        lengths = np.array([d[i % n] + 1 for i in range(1, n + 1)])
        cum = torch.from_numpy(np.cumsum(lengths)).to(k.device)
        j = torch.clamp(k - d[0], min=0) % int(cum[-1])
        idx = torch.searchsorted(cum, j.to(cum.dtype), right=True)
        return torch.where(k < d[0], 0, (1 + idx) % n).to(k.dtype)

    def _fade_coeff(self, ids: torch.Tensor) -> torch.Tensor:
        """set_fade (filter_logo.c:378-393), float32."""
        start, end = self.options["range"]
        fin, fout = self.options["fade"]
        fc = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        if fout > 0:
            fc = torch.where(end - ids < fout,
                             (ids - end + fout).to(torch.float32)
                             * recip32(fout), fc)
        if fin > 0:
            fc = torch.where(ids - start < fin,
                             (start - ids + fin).to(torch.float32)
                             * recip32(fin), fc)
        return fc

    def _opacity(self, seq: torch.Tensor, fc: torch.Tensor):
        """Per-pixel effective opacity for (N,) sequence indices and
        fade coefficients: (copy, skip, img_coeff, vid_coeff), each
        (N, h, w)."""
        oq = self._opacity_q[seq.to(torch.int64)]          # (N, h, w)
        fcb = fc[:, None, None]
        oq = oq + ((65535 - oq).to(torch.float32) * fcb).to(torch.int32)
        copy = oq == 0
        skip = oq >= 65535
        byte = (oq + 128) // 257                      # ScaleQuantumToChar
        # flogo_calc_coeff:360-376: img = 1 - ScaleCharToQuantum(b)/MaxRGB
        # in float32, vid = 1 - img.  Without a fade XLA folds these
        # constants when it compiles (a product, then a difference); a
        # fade makes them depend on the frame, and the compiled code
        # fuses the product into the difference
        q = (byte * 257).to(torch.float32)
        fin, fout = self.options["fade"]
        img_c = (fma32(-q, recip32(65535), 1.0) if fin > 0 or fout > 0
                 else 1.0 - q * recip32(65535))
        vid_c = 1.0 - img_c
        return copy, skip, img_c, vid_c

    @staticmethod
    def _blend(vid, img, copy, skip, img_c, vid_c):
        """render_logo_yuv:652-664: per-term uint8 truncation."""
        mixed = (torch.floor(vid.to(torch.float32) * vid_c)
                 + torch.floor(img.to(torch.float32) * img_c))
        out = torch.where(copy, img, mixed.to(torch.int32))
        return torch.where(skip, vid, out)

    # ---- main ---- #

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if self._dev != fb.device:
            self.init_state(fb.width, fb.height, fb.format, fb.device)
        x, y = self._position(fb.width, fb.height)
        lh, lw = self._rgba.shape[1:3]
        start, end = self.options["range"]
        ids = _ids(fb)
        active = (ids >= start) & (ids <= end)
        k = torch.clamp(ids - start, min=0)
        seq = self._seq_index(k).to(torch.int64)
        fc = self._fade_coeff(ids)

        if fb.rgb is not None:
            copy, skip, ic, vc = self._opacity(seq, fc)
            logo = self._rgba_t[..., :3].to(torch.int32)[seq]
            reg = fb.rgb[:, y:y + lh, x:x + lw, :].to(torch.int32)
            out = self._blend(reg, logo, copy[..., None], skip[..., None],
                              ic[..., None], vc[..., None])
            out = torch.where(active[:, None, None, None], out, reg)
            rgb = fb.rgb.clone()
            rgb[:, y:y + lh, x:x + lw, :] = out.to(fb.rgb.dtype)
            return fb.with_planes(rgb=rgb), state

        if self._yuv is None:
            raise ValueError("logo: image has odd sizes (YUV420)")
        ly, lu, lv = self._yuv
        copy, skip, ic, vc = self._opacity(seq, fc)
        reg = fb.y[:, y:y + lh, x:x + lw].to(torch.int32)
        oy = self._blend(reg, ly[seq], copy, skip, ic, vc)
        oy = torch.where(active[:, None, None], oy, reg)
        py = fb.y.clone()
        py[:, y:y + lh, x:x + lw] = oy.to(fb.y.dtype)
        out = fb.with_planes(y=py)
        if not self.options["grayout"]:
            # chroma at even rows/cols, that pixel's opacity
            # (render_logo_yuv:640-668); video chroma row = y//2 + r2.
            ch, cw = lh // 2, lw // 2
            cy, cx = y // 2, x // 2
            c_masks = [m[:, 0::2, 0::2] for m in (copy, skip, ic, vc)]
            act = active[:, None, None]
            planes = []
            for plane, logo in ((fb.u, lu), (fb.v, lv)):
                region = plane[:, cy:cy + ch, cx:cx + cw].to(torch.int32)
                blended = torch.where(act, self._blend(
                    region, logo[seq], *c_masks), region)
                p = plane.clone()
                p[:, cy:cy + ch, cx:cx + cw] = blended.to(plane.dtype)
                planes.append(p)
            out = out.with_planes(u=planes[0], v=planes[1])
        return out, state


def _single_frame_file(path: str) -> bool:
    """A PNM, or a PNG without an animation chunk: one frame, which
    ``io/image.py`` reads without Pillow."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    if head[:2] in (b"P4", b"P5", b"P6"):
        return True
    return head[:8] == b"\x89PNG\r\n\x1a\n" and b"acTL" not in head


def _load_logo_frames(path: str):
    """Load an image file as a list of RGBA frames + delays (1/100 s).

    Animated GIF/PNG sequences come through Pillow (all frames, per-frame
    delay like GraphicsMagick's image->delay); everything else is a
    single frame via tcforge_tpu_torch.io.image, and a PNG or PNM never
    touches Pillow."""
    frames, delays = [], []
    if not _single_frame_file(path):
        try:
            from PIL import Image, ImageSequence
            img = Image.open(path)
            if getattr(img, "n_frames", 1) > 1:
                for fr in ImageSequence.Iterator(img):
                    frames.append(np.asarray(fr.convert("RGBA")))
                    # Pillow duration is ms; GM delay is 1/100 s
                    delays.append(int(fr.info.get("duration", 0)) // 10)
                return frames, delays
        except Exception:
            pass
    from tcforge_tpu_torch.io.image import read_image
    return [read_image(path, keep_alpha=True)], [0]


def _blend8(src, dest, alpha):
    """filter_logoaway.c:125 alpha_blending: ((a*(src-dest))>>8)+dest,
    truncated to uint8 like the C unsigned-char assignment."""
    return (((alpha * (src - dest)) >> 8) + dest) & 0xFF


def _arange(a: int, b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(a, b, dtype=torch.int32, device=like.device)


@register
class LogoAwayFilter(VideoFilter):
    """filter_logoaway.c: remove a logo region.

    Modes (``filter_logoaway.c:54-59``): 0=none, 1=solid fill, 2=xy
    interpolation from the region borders, 3=shape (alpha image guides
    which border pixel anchors the interpolation).

    The XY luma path follows the reference's sequential walk
    (``process_frame_yuv_xy:458-505``): it writes the top row / left
    column first and then reads them back as interpolation anchors for
    the interior, so the batched version computes corner -> top row ->
    left column -> interior in four stages.  The chroma anchors (rows
    ``ypos/2`` / ``height/2``) lie outside the processed range and stay
    original, so chroma is a single gather.  Mode 3 takes the
    nearest-opaque anchor in each direction.
    """

    info = ModuleInfo(name="logoaway", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="logoaway", comment="remove an image from the video",
        capabilities="VRY",
        params=[ParamSpec("range", "frame range", "d-d", (0, 1 << 30)),
                ParamSpec("pos", "position of logo XxY", "dxd", (0, 0)),
                ParamSpec("size", "size of logo WxH", "dxd", (10, 10)),
                ParamSpec("mode", "0=none 1=solid 2=xy 3=shape",
                          "d", 0, 0, 3),
                ParamSpec("border", "draw visible border", "b", False),
                ParamSpec("dump", "dump filter area to file", "b", False),
                ParamSpec("xweight", "x-y weight (0%-100%)",
                          "d", 50, 0, 100),
                ParamSpec("fill", "solid fill color RRGGBB", "s",
                          "000000"),
                ParamSpec("file", "image with alpha/shape info", "s", "")])
    slots = FilterSlot.PRE_M

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        fill = self.options["fill"]
        self._rgb_fill = tuple(int(fill[i:i + 2], 16) for i in (0, 2, 4))
        r, g, b = self._rgb_fill
        # configure-time BT.601 conversion, filter_logoaway.c:866-868
        self._yuv_fill = (int(0.257 * r + 0.504 * g + 0.098 * b + 16),
                          int(0.439 * r - 0.368 * g - 0.071 * b + 128),
                          int(-0.148 * r - 0.291 * g + 0.439 * b + 128))
        self._alpha = None
        if self.options["file"]:
            from tcforge_tpu_torch.io.image import read_image
            img = read_image(self.options["file"])
            if img.ndim == 3:
                img = img[..., 0]           # red channel, like the ref
            self._alpha = np.asarray(img, np.int32)

    # ---- per-plane primitives, int32 (N, H, W) tensors ---- #

    @staticmethod
    def _xy_luma(plane, x0, y0, x1, y1, xw):
        """The four-stage XY walk on one full-res plane (batch, H, W)
        int32; x1/y1 are absolute end coords."""
        yw = 100 - xw
        w, h = x1 - x0, y1 - y0
        xd, yd = 256 // w, 256 // h
        ah = (xd * (x1 - _arange(x0, x1, plane)))[None, :]     # (1, w)
        av = (yd * (y1 - _arange(y0, y1, plane)))[:, None]     # (h, 1)
        right = plane[:, y0:y1, x1][:, :, None]                # (N,h,1)
        bottom = plane[:, y1, x0:x1][:, None, :]               # (N,1,w)
        orig = plane[:, y0:y1, x0:x1]                          # (N,h,w)
        # stage A: corner (y0,x0)
        ch = _blend8(orig[:, :1, :1], right[:, :1], ah[None, :, :1])
        cv = _blend8(orig[:, :1, :1], bottom[:, :, :1], av[None, :1])
        corner = (ch * xw + cv * yw) // 100
        # stage B: top row (y0, col>x0): left anchor = new corner,
        # vertical anchor = self (original)
        th = _blend8(corner, right[:, :1], ah[None, :, :])
        tv = _blend8(orig[:, :1, :], bottom, av[None, :1])
        top = (th * xw + tv * yw) // 100                       # (N,1,w)
        top[:, :, :1] = corner
        # stage C: left column (row>y0, x0): h anchor = self original,
        # v anchor = new corner
        lh = _blend8(orig[:, :, :1], right, ah[None, :, :1])
        lv = _blend8(corner, bottom[:, :, :1], av[None, :, :])
        left = (lh * xw + lv * yw) // 100                      # (N,h,1)
        # stage D: interior
        ih = _blend8(left, right, ah[None, :, :])
        iv = _blend8(top, bottom, av[None, :, :])
        fill = (ih * xw + iv * yw) // 100
        fill = torch.cat(
            [top, torch.cat([left[:, 1:, :], fill[:, 1:, 1:]], dim=2)],
            dim=1)
        out = plane.clone()
        out[:, y0:y1, x0:x1] = fill
        return out

    @staticmethod
    def _xy_chroma(plane, x0, y0, x1, y1, xw):
        """Reference chroma XY walk (process_frame_yuv_xy:507-545):
        rows [y0/2+1, y1/2), cols [x0/2+1, x1/2); anchors at row y0/2 /
        col x0/2 (unprocessed => original) and row y1/2 / col x1/2."""
        yw = 100 - xw
        xd, yd = 512 // (x1 - x0), 512 // (y1 - y0)
        cx0, cx1, cy0, cy1 = x0 // 2 + 1, x1 // 2, y0 // 2 + 1, y1 // 2
        if cx1 <= cx0 or cy1 <= cy0:
            return plane
        ah = (xd * (x1 // 2 - _arange(cx0, cx1, plane)))[None, :]
        av = (yd * (y1 // 2 - _arange(cy0, cy1, plane)))[:, None]
        lft = plane[:, cy0:cy1, x0 // 2][:, :, None]
        rgt = plane[:, cy0:cy1, x1 // 2][:, :, None]
        top = plane[:, y0 // 2, cx0:cx1][:, None, :]
        bot = plane[:, y1 // 2, cx0:cx1][:, None, :]
        hcalc = _blend8(lft, rgt, ah[None])
        vcalc = _blend8(top, bot, av[None])
        out = plane.clone()
        out[:, cy0:cy1, cx0:cx1] = (hcalc * xw + vcalc * yw) // 100
        return out

    @staticmethod
    def _border(plane, x0, y0, x1, y1):
        """draw_border_yuv (filter_logoaway.c:193-208): dashed 255."""
        odd_cols = (_arange(x0, x1, plane) & 1).bool()
        odd_rows = (_arange(y0, y1, plane) & 1).bool()
        plane = plane.clone()
        for row in (y0, y1 - 1):
            plane[:, row, x0:x1] = torch.where(odd_cols, 255,
                                               plane[:, row, x0:x1])
        for col in (x0, x1):
            plane[:, y0:y1, col] = torch.where(odd_rows, 255,
                                               plane[:, y0:y1, col])
        return plane

    def _shape_anchors(self, w, h):
        """Nearest-opaque (alpha==255) anchor index per pixel in each
        of the four directions, from the static alpha mask."""
        mask = self._alpha[:h, :w] == 255
        idx = np.arange(w)[None, :].repeat(h, 0)
        left = np.where(mask, idx, 0)
        np.maximum.accumulate(left, axis=1, out=left)
        right = np.where(mask, idx, w - 1)
        right = np.flip(np.minimum.accumulate(np.flip(right, 1), 1), 1)
        idy = np.arange(h)[:, None].repeat(w, 1)
        up = np.where(mask, idy, 0)
        np.maximum.accumulate(up, axis=0, out=up)
        down = np.where(mask, idy, h - 1)
        down = np.flip(np.minimum.accumulate(np.flip(down, 0), 0), 0)
        return left, right, up, down

    def _region(self, fw: int, fh: int):
        x0, y0 = self.options["pos"]
        w, h = self.options["size"]
        return x0, y0, min(x0 + w, fw - 1), min(y0 + h, fh - 1)

    def _on_device(self, key, make, device: torch.device):
        """``make()``'s numpy arrays as tensors on ``device``, made once:
        a copy from the host in every step would wait for the card."""
        cache = self.__dict__.setdefault("_tensors", {})
        if (key, device) not in cache:
            cache[key, device] = [torch.from_numpy(np.ascontiguousarray(a))
                                  .to(device) for a in make()]
        return cache[key, device]

    def _alpha_t(self, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
        return self._on_device(("alpha", h, w),
                               lambda: [self._alpha[:h, :w]],
                               like.device)[0][None]

    def _full_res(self, plane, fill_val, x0, y0, x1, y1):
        """Solid/xy/shape + border on one full-res plane (N,H,W)."""
        mode = self.options["mode"]
        xw = self.options["xweight"]
        plane = plane.to(torch.int32)
        if mode == 1:
            plane = plane.clone()
            if self._alpha is not None:
                a = self._alpha_t(y1 - y0, x1 - x0, plane)
                plane[:, y0:y1, x0:x1] = _blend8(plane[:, y0:y1, x0:x1],
                                                 fill_val, a)
            else:
                plane[:, y0:y1, x0:x1] = fill_val
        elif mode == 2:
            plane = self._xy_luma(plane, x0, y0, x1, y1, xw)
        elif mode == 3 and self._alpha is not None:
            w_, h_ = x1 - x0, y1 - y0
            anchors = [a[None].expand(plane.shape[0], -1, -1)
                       for a in self._on_device(
                           ("anchors", h_, w_),
                           lambda: self._shape_anchors(w_, h_),
                           plane.device)]
            xd, yd = 256 // w_, 256 // h_
            ah = (xd * (x1 - _arange(x0, x1, plane)))[None, None, :]
            av = (yd * (y1 - _arange(y0, y1, plane)))[None, :, None]
            reg = plane[:, y0:y1, x0:x1]
            lval = torch.gather(reg, 2, anchors[0])
            rval = torch.gather(reg, 2, anchors[1])
            uval = torch.gather(reg, 1, anchors[2])
            dval = torch.gather(reg, 1, anchors[3])
            hcalc = _blend8(lval, rval, ah)
            vcalc = _blend8(uval, dval, av)
            npx = (hcalc * xw + vcalc * (100 - xw)) // 100
            a = self._alpha_t(h_, w_, plane)
            plane = plane.clone()
            plane[:, y0:y1, x0:x1] = _blend8(reg, npx, a)
        if self.options["border"]:
            plane = self._border(plane, x0, y0, x1, y1)
        return plane

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        if self.options["mode"] == 0:
            return fb, state
        x0, y0, x1, y1 = self._region(fb.width, fb.height)
        if x1 - x0 < 2 or y1 - y0 < 2:
            return fb, state
        start, end = self.options["range"]
        ids = _ids(fb)
        active = ((ids >= start) & (ids <= end))[:, None, None]
        if self.options["dump"]:
            self._dump(fb)
        mode = self.options["mode"]
        xw = self.options["xweight"]
        if fb.rgb is not None:
            # the reference's RGB frames are stored bottom-up
            # (buf_off=(height-row)*width, filter_logoaway.c:240); the
            # same math is applied here on top-down planes.
            planes = [self._full_res(fb.rgb[..., c], self._rgb_fill[c],
                                     x0, y0, x1, y1)
                      for c in range(3)]
            rgb = torch.stack(planes, dim=-1).to(fb.rgb.dtype)
            rgb = torch.where(active[..., None], rgb, fb.rgb)
            return fb.with_planes(rgb=rgb), state
        yc, uc, vc = self._yuv_fill
        y = self._full_res(fb.y, yc, x0, y0, x1, y1)
        u = fb.u.to(torch.int32)
        v = fb.v.to(torch.int32)
        cy0, cy1 = y0 // 2 + 1, y1 // 2
        cx0, cx1 = x0 // 2 + 1, x1 // 2
        if mode == 1 and cy1 > cy0 and cx1 > cx0:
            u[:, cy0:cy1, cx0:cx1] = uc
            v[:, cy0:cy1, cx0:cx1] = vc
        elif mode in (2, 3):
            u = self._xy_chroma(u, x0, y0, x1, y1, xw)
            v = self._xy_chroma(v, x0, y0, x1, y1, xw)
        out = fb.with_planes(
            y=torch.where(active, y.to(fb.y.dtype), fb.y),
            u=torch.where(active, u.to(fb.u.dtype), fb.u),
            v=torch.where(active, v.to(fb.v.dtype), fb.v))
        return out, state

    def _dump(self, fb: FrameBatch) -> None:
        from tcforge_tpu_torch.io.image import write_image
        x0, y0 = self.options["pos"]
        w, h = self.options["size"]
        if fb.rgb is not None:
            reg = fb.rgb[0, y0:y0 + h, x0:x0 + w]
        else:
            reg = fb.y[0, y0:y0 + h, x0:x0 + w]
        write_image("dump[0].ppm", reg.cpu().numpy().astype(np.uint8))


def _fa_bob_fields(lum: torch.Tensor):
    """filter_fieldanalysis.c:97-107 bob_field, both fields, (N,H,W).

    T rows [0, H-3]: even = avg(adjacent top-field lines), odd = next
    top line.  B row 0 = source row 1, then the same walk one row down.
    Rows >= H-2 stay zero (the reference leaves them calloc'd)."""
    h = lum.shape[1]
    lum = lum.to(torch.int32)
    t = torch.zeros_like(lum)
    t[:, 0:h - 2:2] = (lum[:, 0:h - 2:2] + lum[:, 2:h:2]) >> 1
    t[:, 1:h - 1:2] = lum[:, 2:h:2]
    b = torch.zeros_like(lum)
    b[:, 0] = lum[:, 1]
    b[:, 1:h - 2:2] = (lum[:, 1:h - 2:2] + lum[:, 3:h:2]) >> 1
    b[:, 2:h - 1:2] = lum[:, 3:h:2]
    return t, b


def _fa_compare(p1, p2, rows, denom_h):
    """pic_compare (filter_fieldanalysis.c:111-125): mean squared
    difference over `rows` leading rows, divided by width*denom_h.
    Row sums in int32 (exact), then float32 accumulation.  The leading
    dimensions of ``p1`` and ``p2`` are batch dimensions: several
    compares of the same shape go as one."""
    d = (p1[..., :rows, :].to(torch.int32)
         - p2[..., :rows, :].to(torch.int32))
    row = (d * d).sum(dim=-1, dtype=torch.int32)        # (..., rows)
    lead = row.shape[:-1]
    tot = tree_sum(row.reshape(-1, rows).to(torch.float32), 1)
    return tot.view(lead) * recip32(p1.shape[-1] * denom_h)


@register
class FieldAnalysisFilter(VideoFilter):
    """filter_fieldanalysis.c: detect progressive / interlaced /
    field-shifted / telecined video from the luminance field.

    check_interlace (``filter_fieldanalysis.c:140-378``): bobbed
    top/bottom fields, the five pic_compare metrics and the prog/top/
    shift decision rules (including the reference's reuse of
    pixShiftChangedT in the bottom-field shift test) per frame on the
    device; then one read-back a batch of the per-frame decisions, and
    on the host the telecine counter state machine (NTSC-gated unless
    `forcetelecinedetect`), the inconsistency fixes and the frame-type
    counters.  Metrics are float32 (the reference uses double); per-frame
    `verbose` logging is summarized at close.  `outdiff` debug modes
    1-11 overwrite the luma plane (pic_diff scale 4)."""

    info = ModuleInfo(name="fieldanalysis", kind=ModuleKind.FILTER)
    desc = ModuleDesc(
        name="fieldanalysis",
        comment="Field analysis for detecting interlace and telecine",
        capabilities="VRY4E",
        params=[
            ParamSpec("interlacediff", "min temporal inter-field diff "
                      "for interlaced", "f", 1.1),
            ParamSpec("unknowndiff", "max change vs detail for "
                      "neglecting interlaced", "f", 1.5),
            ParamSpec("progressivediff", "min change vs detail for "
                      "progressive", "f", 8.0),
            ParamSpec("progressivechange", "min temporal change for "
                      "progressive", "f", 0.2),
            ParamSpec("changedifmore", "min temporal change for truly "
                      "changed frames", "f", 10.0),
            ParamSpec("forcetelecinedetect", "detect telecine on "
                      "non-NTSC too", "b", False),
            ParamSpec("verbose", "output analysis for every frame",
                      "d", 0, 0, 2),
            ParamSpec("outdiff", "output internal debug frames",
                      "d", 0, 0, 11)])
    slots = FilterSlot.PRE_S

    _UNKNOWN, _FALSE, _TRUE = -1, 0, 1

    def init_state(self, width: int, height: int, fmt: ImageFormat,
                   device: torch.device) -> Any:
        z = torch.zeros((height, width), dtype=torch.int32, device=device)
        # num, unknown, top, bottom, interlaced, progressive, fieldshift,
        # telecine: host counters, as the telecine state
        return {"prev": z, "prev_t": z, "prev_b": z, "started": 0,
                "telecine": 0, "counts": [0] * 8}

    def _luma(self, fb: FrameBatch) -> torch.Tensor:
        if fb.y is not None:
            return fb.y.to(torch.int32)
        from tcforge_tpu_torch.ops.colorspace import rgb_to_gray_pixels
        return rgb_to_gray_pixels(fb.rgb).to(torch.int32)

    def _decisions(self, lum, lum_t, lum_b, prev, prev_t, prev_b):
        """The per-frame metrics and decisions on the device: int32
        (N, 5) of changed_t, changed_b, is_prog, is_top, is_shift."""
        o = self.options
        h = lum.shape[1]
        # the five compares in two stacks of one shape each
        pix_diff, shift_t, shift_b = _fa_compare(
            torch.stack([lum_t, lum_t, lum_b]),
            torch.stack([lum_b, prev_b, prev_t]), h - 2, h - 2)
        last_t, last_b = _fa_compare(
            torch.stack([lum[:, 0::2], lum[:, 1::2]]),
            torch.stack([prev[:, 0::2], prev[:, 1::2]]), h // 2, h // 2)
        pix_last = (last_t + last_b) * 0.5

        def f32(v):
            return float(np.float32(v))
        changed_t = last_t > f32(o["changedifmore"])
        changed_b = last_b > f32(o["changedifmore"])
        ild, und = f32(o["interlacediff"]), f32(o["unknowndiff"])
        prd, prc = f32(o["progressivediff"]), f32(o["progressivechange"])
        U, F, T = self._UNKNOWN, self._FALSE, self._TRUE
        full = torch.full(pix_diff.shape, U, dtype=torch.int32,
                          device=lum.device)
        is_top = torch.where(shift_t * ild < shift_b, T, full)
        is_top = torch.where(shift_b * ild < shift_t, F, is_top)
        is_prog = torch.where((pix_diff * und > shift_t)
                              | (pix_diff * und > shift_b), F, full)
        is_prog = torch.where((pix_diff * prd < shift_t)
                              & (pix_diff * prd < shift_b)
                              & (pix_diff < pix_last * prc), T, is_prog)
        # NB: the reference tests pixShiftChangedT (not B) against
        # pixLast in the bottom branch too (lines 193-196) — kept.
        is_shift = torch.where(
            ((shift_t * prd < pix_diff) & (shift_t * prd < shift_b)
             & (shift_t < prc * pix_last))
            | ((shift_b * prd < pix_diff) & (shift_b * prd < shift_t)
               & (shift_t < prc * pix_last)), T, full)
        return torch.stack([changed_t.to(torch.int32),
                            changed_b.to(torch.int32), is_prog, is_top,
                            is_shift], dim=1)

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        o = self.options
        h = fb.height
        lum = self._luma(fb)
        lum_t, lum_b = _fa_bob_fields(lum)
        prev = torch.cat([state["prev"][None], lum[:-1]], 0)
        prev_t = torch.cat([state["prev_t"][None], lum_t[:-1]], 0)
        prev_b = torch.cat([state["prev_b"][None], lum_b[:-1]], 0)
        codes = self._decisions(lum, lum_t, lum_b, prev, prev_t, prev_b)
        attrs = (fb.attrs if fb.attrs is not None else torch.zeros(
            (fb.batch,), dtype=torch.int32, device=fb.device))
        skipped = ((attrs & ATTR_SKIPPED) != 0).to(torch.int32)
        host = torch.cat([codes, skipped[:, None]], dim=1).cpu().tolist()

        fps = fb.fps if fb.fps > 0 else self.job.fps
        do_telecine = ((29.9 < fps < 30.1)
                       or bool(o["forcetelecinedetect"]))
        tstate, counts = state["telecine"], list(state["counts"])
        for i, (ct, cb, prog, top, shift, skip) in enumerate(host):
            # first frame of the stream: buffers rotate, no check
            first = state["started"] == 0 and i == 0
            check = not skip and not first
            tstate, inc = self._step(tstate, check, ct == 1, cb == 1, prog,
                                     top, shift, do_telecine)
            if first:
                counts[0] += 1               # numFrames++ only
            elif check:
                counts = [c + d for c, d in zip(counts, inc)]

        out = fb
        od = o["outdiff"]
        if od and fb.y is not None:
            def diff4(a, b):
                return torch.clamp((4 * (a - b)).abs(), max=255)
            if od == 2:
                dbg = lum.clone()
                dbg[:, 1:h - 2:2] = prev[:, 1:h - 2:2]
            else:
                dbg = {1: lambda: lum, 3: lambda: lum_t, 4: lambda: lum_b,
                       5: lambda: prev_t, 6: lambda: prev_b,
                       7: lambda: diff4(lum_t, lum_b),
                       8: lambda: diff4(lum_t, prev_b),
                       9: lambda: diff4(lum_b, prev_t),
                       10: lambda: diff4(lum_t, prev_t),
                       11: lambda: diff4(lum_b, prev_b)}[od]()
            out = fb.with_planes(y=dbg.to(fb.y.dtype))
        new_state = {"prev": lum[-1].clone(), "prev_t": lum_t[-1].clone(),
                     "prev_b": lum_b[-1].clone(), "started": 1,
                     "telecine": tstate, "counts": counts}
        return out, new_state

    def _step(self, tstate: int, chk: bool, ct: bool, cb: bool, prog: int,
              top: int, shift: int, do_telecine: bool
              ) -> Tuple[int, List[int]]:
        """One frame of the telecine state machine and the counters
        (filter_fieldanalysis.c:220-375): the new state and the frame's
        increments of the eight counters."""
        U, F, T = self._UNKNOWN, self._FALSE, self._TRUE
        if do_telecine and chk:
            gate = (ct or cb) and (prog != U or top != U or tstate > 10)
            if gate:
                phase = tstate % 5
                dec = 0
                if phase == 0 and ((top == T and cb) or (top == F and ct)):
                    dec += 20
                if phase in (1, 2) and prog == F:
                    dec += 20
                if phase == 3 and prog == T:
                    dec += 20
                if phase == 3 and ((top == T and ct) or (top == F and cb)):
                    dec += 20
                if phase == 4 and prog == T:
                    dec += 20
                ts = max(tstate - dec, 0)
                # second chance to be phase 0 (lines 260-272)
                if ts == 0 and ((top == T and cb) or (top == F and ct)):
                    ts = -1
                ts += 1
            else:
                ts = tstate + 1 if tstate > 10 else 0
            tstate = ts - 10 if ts > 100 else ts
        # inconsistency fixes (lines 289-300)
        if prog == F and top == U:
            prog = U
        if prog != F and top != U:
            prog = top = U
        if not ct or not cb:
            prog = top = shift = U
        # counters (lines 355-375)
        sel = 4 if prog == F else (5 if prog == T else 1)
        if not ct and not cb:
            sel = 1
        if shift == T:
            sel = 6
        if tstate > 10:
            sel = 7
        inc = [0] * 8
        inc[sel] += 1
        inc[2] += top == T
        inc[3] += top == F
        inc[0] += 1
        return tstate, inc

    def finalize(self, state: Any) -> None:
        """RESULTS + CONCLUSION block (filter_fieldanalysis.c:500-560)."""
        (num, unknown, top, bottom, inter, prog, shift,
         tele) = [int(x) for x in state["counts"]]
        if num == 0:
            return
        total = num - unknown
        fields = max(top + bottom, 1)
        for line in (
                f"RESULTS: Frames: {num} (100%)  Unknown: {unknown} "
                f"({100.0 * unknown / num:.3g}%)",
                f"RESULTS: Progressive: {prog} "
                f"({100.0 * prog / num:.3g}%)  Interlaced: {inter} "
                f"({100.0 * inter / num:.3g}%)",
                f"RESULTS: FieldShift: {shift} "
                f"({100.0 * shift / num:.3g}%)  Telecined: {tele} "
                f"({100.0 * tele / num:.3g}%)",
                f"RESULTS: MajorField: TopFirst {top} "
                f"({100.0 * top / fields:.3g}%)  BottomFirst {bottom} "
                f"({100.0 * bottom / fields:.3g}%)"):
            _log.info("[fieldanalysis] %s", line)
        major = "top" if top > bottom else "bottom"
        if total < 50:
            verdict = "less than 50 frames analyzed correctly, no conclusion."
        elif unknown * 10 > num * 9:
            verdict = ("less than 10% frames analyzed correctly, "
                       "no conclusion.")
        elif prog * 8 > total * 7:
            verdict = "CONCLUSION: progressive video."
        elif top * 8 > bottom and bottom * 8 > top:
            verdict = ("major field unsure, no conclusion. "
                       "Use deinterlacer for processing.")
        elif tele * 4 > total * 3:
            verdict = f"CONCLUSION: telecined video, {major} field first."
        elif shift * 4 > total * 3:
            verdict = ("CONCLUSION: field shifted progressive video, "
                       f"{major} field first.")
        elif inter > shift and (inter + shift) * 8 > total * 7:
            verdict = f"CONCLUSION: interlaced video, {major} field first."
        else:
            verdict = ("mixed video, no conclusion. "
                       "Use deinterlacer for processing.")
        _log.info("[fieldanalysis] %s", verdict)
        self.verdict = verdict


@register
class F29to23Filter(VideoFilter):
    """filter_29to23.c: 29.97 -> 23.976 drop preset (fps filter alias)."""

    info = ModuleInfo(name="29to23", kind=ModuleKind.FILTER)
    desc = ModuleDesc(name="29to23", comment="29.97->23.976 fps preset")
    slots = FilterSlot.PRE_S

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        from tcforge_tpu_torch.modules.filters.rate import FpsFilter
        self._fps = FpsFilter(job, "infps=29.97:outfps=23.976")

    def apply(self, fb: FrameBatch, state: Any) -> Tuple[FrameBatch, Any]:
        return self._fps.apply(fb, state)


@register
class CpAudioFilter(AudioFilter):
    """filter_cpaudio.c: copy one stereo channel over the other."""

    info = ModuleInfo(name="cpaudio", kind=ModuleKind.FILTER,
                      media="audio")
    desc = ModuleDesc(name="cpaudio", comment="copy audio channel",
                      params=[ParamSpec("source", "source channel "
                                        "(0=left 1=right)", "d", 0, 0, 1)])
    slots = FilterSlot.PRE_M
    media = "audio"

    def apply(self, ab: AudioBatch, state: Any) -> Tuple[AudioBatch, Any]:
        if ab.channels != 2:
            return ab, state
        src = self.options["source"]
        mono = ab.pcm[..., src:src + 1]
        return ab.with_pcm(torch.cat([mono, mono], dim=-1)), state
