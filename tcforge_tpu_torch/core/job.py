# Copied from tcforge_tpu/core/job.py; only the package name in its imports differs.
"""The job/session record — single source of configuration truth.

Re-implementation of the reference's ``vob_t``/``TCJob``
(``tccore/job.h:64-250``) and ``TCSession`` (``src/transcode.h:74-120``):
one record filled by the CLI + probe, then read by every module.  Field
names follow vob_t (im_v_width, ex_v_width, im_clip_*, zoom_*, ...) so the
option surface maps 1:1.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

from tcforge_tpu_torch.core.codecs import Codec, ContainerFormat
from tcforge_tpu_torch.core.formats import ImageFormat
from tcforge_tpu_torch.core.framecode import FrameRangeList


@dataclass
class FilterSpec:
    """One entry of the -J filter chain: name + option string."""

    name: str
    options: str = ""
    enabled: bool = True
    instance_id: int = -1

    @staticmethod
    def parse(text: str) -> "FilterSpec":
        """Parse 'name=opts' or 'name' (cmdline -J syntax)."""
        if "=" in text:
            name, opts = text.split("=", 1)
            return FilterSpec(name=name.strip(), options=opts.strip())
        return FilterSpec(name=text.strip())


@dataclass
class Job:
    """vob_t analogue.  im_* = import-side, ex_* = export-side."""

    # --- files -----------------------------------------------------------
    video_in_file: Optional[str] = None      # -i
    audio_in_file: Optional[str] = None      # -p
    video_out_file: Optional[str] = None     # -o
    audio_out_file: Optional[str] = None     # -m

    # --- input stream geometry / rate (filled by probe) -------------------
    im_v_width: int = 0
    im_v_height: int = 0
    fps: float = 25.0
    im_frc: int = 3                          # frame rate code
    im_asr: int = 1                          # input aspect code
    im_par: int = 0                          # pixel aspect code
    im_par_width: int = 1
    im_par_height: int = 1
    encode_fields: int = 0                   # interlacing hint from probe
    im_v_codec: Codec = Codec.YUV420P
    im_v_format: ContainerFormat = ContainerFormat.UNKNOWN

    # --- input audio -------------------------------------------------------
    a_rate: int = 48000
    a_bits: int = 16
    a_chan: int = 2
    im_a_codec: Codec = Codec.PCM
    im_a_format: ContainerFormat = ContainerFormat.UNKNOWN
    a_track: int = 0                          # -a
    v_track: int = 0                          # -x track selection

    # --- internal colorspace (-V) ------------------------------------------
    im_colorspace: ImageFormat = ImageFormat.YUV420P

    # --- transforms (the video_trans.c "jIXBZYrzlkKGC" chain) --------------
    # --pre_clip: initial region select, before everything (preprocess_
    # vid_frame, video_trans.c:483)
    pre_im_clip: Optional[Tuple[int, int, int, int]] = None
    # -j clip (top, left, bottom, right; negative = grow with black border)
    im_clip: Optional[Tuple[int, int, int, int]] = None
    # -I deinterlace mode (0=off 1=interpolate 2=blend 3=drop 4=linear-zoom 5=prebuilt)
    deinterlace: int = 0
    # -X fast scale up (units of 8 px) / -B fast scale down
    resize_up: Tuple[int, int] = (0, 0)       # (w_units, h_units)
    resize_down: Tuple[int, int] = (0, 0)
    # -Z WxH slow zoom (high-quality filtered resize)
    zoom_width: int = 0
    zoom_height: int = 0
    zoom_filter: str = "lanczos3"
    zoom_interlaced: bool = False
    # -Y second clip
    ex_clip: Optional[Tuple[int, int, int, int]] = None
    # -r reduce (integer shrink factors)
    reduce_w: int = 1
    reduce_h: int = 1
    # --post_clip: final region select, after everything (postprocess_
    # vid_frame, video_trans.c:548)
    post_ex_clip: Optional[Tuple[int, int, int, int]] = None
    # -z / -l / -k / -K / -G / -C
    flip_v: bool = False
    flip_h: bool = False
    rgbswap: bool = False
    decolor: bool = False
    gamma: float = 0.0
    antialias: int = 0                        # 0=off 1=resize 2=full 3=all
    antialias_weight: float = 1.0 / 3.0       # TC_DEFAULT_AAWEIGHT
    antialias_bias: float = 0.5               # TC_DEFAULT_AABIAS

    # --- export side --------------------------------------------------------
    ex_v_width: int = 0
    ex_v_height: int = 0
    ex_v_codec: Codec = Codec.YUV420P
    ex_a_codec: Codec = Codec.PCM
    ex_v_fcc: str = ""                        # -F fourcc / module options
    ex_a_fcc: str = ""
    ex_frc: int = 0                           # output rate code (--export_frc)
    ex_fps: float = 0.0
    video_max_bitrate: int = 0
    bitrate: int = 1800
    mp3bitrate: int = 128
    mp3quality: float = -1.0
    divxmultipass: int = 0                    # -R pass number
    divxlogfile: Optional[str] = None
    quality: int = 5
    rc_requested: bool = False                # -w given: rate control on
    keyframes: int = 250                      # -w second field
    avi_limit: int = 0                        # --avi_limit (MB)
    min_quantizer: int = 2                    # --quantizers min
    max_quantizer: int = 31                   # --quantizers max
    pulldown: bool = False                    # --pulldown 3:2 flags
    encoder_flush: bool = True                # -O disables
    ex_codec_names: str = ""                  # -N format string

    # --- audio processing ---------------------------------------------------
    volume: float = 1.0                       # -s scale
    mp3frequency: int = 0                     # resample target (-E)
    dm_bits: int = 16
    dm_chan: int = 0      # 0 = inherit a_chan (reference -d default)
    sync_method: str = "adjust"               # synchronizer (none|adjust)
    av_offset: int = 0                        # -D frame shift
    a_vbr: int = 0                            # -b vbr flag
    mp3mode: int = 0                          # -b mode (0=joint stereo)
    a_codec_flag: int = 0                     # -n import audio codec id
    resync_margin: int = 1                    # --resync_margin frames
    resync_interval: int = 25                 # --resync_interval frames
    no_audio_adjust: bool = False             # --no_audio_adjust
    a52_mode: int = 0                         # --a52_* flag bits
    dv_yuy2_mode: bool = False                # --dv_yuy2_mode

    # codec side data passed encoder -> muxer (TCModuleExtraData analogue)
    extradata: Dict[str, bytes] = dfield(default_factory=dict)

    # --- ranges / control ---------------------------------------------------
    ranges: Optional[FrameRangeList] = None   # -c
    frame_interval: int = 1                   # --frame_interval
    vob_offset: int = 0                       # -L: skip N frames first
    seek_unit: int = 0                        # -S: unit (frames/PSUs)
    nav_seek_file: Optional[str] = None       # --nav_seek (tcdemux nav)
    vob_chunk: int = 0                        # -W chunk n
    vob_chunk_max: int = 0                    # -W of m (0 = off)
    vob_chunk_num1: int = -1                  # --cluster_chunks a
    vob_chunk_num2: int = -1                  # --cluster_chunks b
    vob_percentage: bool = False              # --cluster_percentage
    dvd_title: int = 1                        # -T (DVD access is gated)
    dvd_chapter1: int = -1
    dvd_chapter2: int = -1
    dvd_angle: int = 1
    ts_pid1: int = 0                          # --ts_pid
    probe_amount: int = 0                     # -H probe bytes hint
    mesh_mode: str = "auto"                   # device mesh: auto|off
    psu_unit: int = -1                        # --psu_mode unit index
    psu_unit_end: int = -1                    # --no_split: end unit (excl)
    av_fine_ms: int = 0                       # sub-frame A/V shift (ms)
    avi_comments_file: Optional[str] = None   # --avi_comments
    ex_asr: int = 0                           # --export_asr code
    ex_par: Optional[tuple] = None            # --export_par (num, den)
    hard_fps: bool = False                    # --hard_fps
    progress_rate: float = 0.5                # --progress_rate seconds

    # --- filter chain (-J) ---------------------------------------------------
    filters: List[FilterSpec] = dfield(default_factory=list)

    # --- modules (-x/-y) -----------------------------------------------------
    im_v_module: str = "auto"
    im_a_module: str = "auto"
    ex_v_module: str = "raw"
    ex_a_module: str = "raw"
    ex_m_module: str = "auto"
    # per-module option strings (-x mod=opts / -y mod=opts,
    # cmdline_def.h:473-492 vob->im_v_string & co.)
    im_v_string: str = ""
    im_a_string: str = ""
    ex_v_string: str = ""
    ex_a_string: str = ""
    ex_m_string: str = ""

    # --- output rotation (multiplexor.c:42-198) ------------------------------
    rotate_frames: int = 0                    # new output every N frames
    rotate_mb: int = 0                        # new output every N MB

    # --- control / profiles --------------------------------------------------
    socket_path: Optional[str] = None         # --socket
    export_profiles: str = ""                 # --export_prof

    # --- pipeline tuning (TPU replacements for ring-buffer knobs) -----------
    batch_size: int = 16                      # frames per device batch (-u analogue)
    prefetch_depth: int = 2                   # host->device double buffering
    max_frames: Optional[int] = None

    # ------------------------------------------------------------------ #

    def export_size(self) -> Tuple[int, int]:
        """Output geometry of the internal transform chain applied to the
        probed input geometry (src/transcode.c:1740-2530 math)."""
        return self.transform_size(self.im_v_width, self.im_v_height)

    def transform_size(self, w: int, h: int,
                       inner: bool = False) -> Tuple[int, int]:
        """Apply the --pre_clip/-j/-X/-B/-Z/-Y/-r/--post_clip geometry
        math to a given size.  ``inner=True`` covers only the
        apply_video_trans stage (-j..-r), excluding the pre/post clips
        that run in the import/export stages around the filter slots."""
        if self.pre_im_clip and not inner:
            t, l, b, r = self.pre_im_clip
            w, h = w - l - r, h - t - b
        if self.im_clip:
            t, l, b, r = self.im_clip
            w, h = w - l - r, h - t - b
        wu, hu = self.resize_up
        w, h = w + wu * 8, h + hu * 8
        wd, hd = self.resize_down
        w, h = w - wd * 8, h - hd * 8
        if self.zoom_width:
            w = self.zoom_width
        if self.zoom_height:
            h = self.zoom_height
        if self.ex_clip:
            t, l, b, r = self.ex_clip
            w, h = w - l - r, h - t - b
        w //= max(1, self.reduce_w)
        h //= max(1, self.reduce_h)
        if self.post_ex_clip and not inner:
            t, l, b, r = self.post_ex_clip
            w, h = w - l - r, h - t - b
        return w, h

    def validate(self) -> None:
        """Basic option sanity checks (src/transcode.c:1740+ analogue)."""
        if self.im_v_width < 0 or self.im_v_height < 0:
            raise ValueError("negative input geometry")
        w, h = self.export_size()
        if (self.im_v_width and w <= 0) or (self.im_v_height and h <= 0):
            raise ValueError(
                f"transform chain yields non-positive output size {w}x{h}")
        if self.fps <= 0:
            raise ValueError("fps must be positive")
        if self.reduce_w < 1 or self.reduce_h < 1:
            raise ValueError("reduce factors must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")

    @property
    def out_fps(self) -> float:
        return self.ex_fps if self.ex_fps > 0 else self.fps
