"""Command line of the port: ``python -m tcforge_tpu_torch.cli``.

It takes the JAX CLI's own flag names, with the same parsing, for what
the port carries so far: the internal transforms ``--pre_clip``, ``-j``,
``-I`` 1 to 5 (2 does nothing, as in the JAX chain), ``-X``, ``-B``,
``-Z``, ``-Y``, ``-r``, ``-z``, ``-l``, ``-k``, ``-K``, ``-G``, ``-C``
and ``--post_clip``, the internal colorspace ``-V`` (planar YUV or RGB;
the Y4M output of an RGB job is YUV420P), the engine's ``-c`` ranges
(parsed at the input's rate), ``--frame_interval``, ``-L``,
``--max_frames``, ``--export_fps``, ``--batch``, ``--prefetch`` and
``--progress_rate``, and the ``-J`` filters hqdn3d, unsharp,
tomsmocomp, denoise3d, ivtc, 32detect, decimate, 32drop, smartdeinter,
smartyuv, doublefps, smartbob, barrel, fps, skip, slowmo, modfps,
invert, levels, deinterlace, mask, testframe, extsub and null
(comma-separated, run in their slots' order), and the audio track:
``-p`` and ``-m`` (below), ``-s``, ``-d``,
``-E rate[,bits[,channels]]``, ``-D``, ``--av_fine_ms``, ``--sync``,
``--resync_margin``, ``--resync_interval`` and ``--no_audio_adjust``,
with the audio filters normalize, astat, lowpass, detectsilence,
resample, aclip and cpaudio in the same ``-J`` list, ``-e
rate[,bits[,channels]]`` (which wins over the probe), ``-n``, ``-A``,
``-M`` and ``--a52_demux``, ``--a52_drc_off`` and ``--a52_dolby_off``
(accepted and gated, as in the JAX CLI); an audio file given to ``-i``
makes an audio-only session through ``-y``'s audio encoder and
multiplexor, and so does ``-x null`` with ``-p``.  MPEG-1/2 video (a DVD's VOB,
a program stream, an elementary stream) is read with ``-x mpeg`` (or
its aliases ``mpeg2``, ``mpg`` and ``vob``), or found by its magic with
the default ``-x auto`` (a 4:2:2 stream stays 4:2:2 under ``-V
yuv422p``, else its chroma is decimated to 4:2:0); its size and rate come from the sequence
header, the host parses it and the card reconstructs it.  A program
stream's LPCM, MPEG audio or AC-3 track (``-a`` picks it) goes to ``-m``;
a transport stream (``--ts_pid`` picks the video PID, else its PAT and
PMT do; its audio is the PMT's first MPEG audio, AC-3 or AAC stream) and
a VideoCD track (RIFF/CDXA ``.DAT``) take the same route, and without
``-p`` the source's own track goes into a multiplexor that takes audio;
``-S
unit[,chunks]`` starts at a program stream unit, ``--psu_mode`` runs one
pipeline a unit into ``-o``'s ``%d`` (``--psu_first``, ``--psu_last``,
``--psu_chunks a-b``; ``--no_split`` writes the units into one file), and
``-W n,m[,navfile]`` (``--cluster_chunks``, ``--cluster_percentage``,
``--nav_seek``) takes chunk n of m as ``-L`` and ``--max_frames``; ``-p``
and an audio-only ``-i`` take WAV, MP3 (Layers I to III), AC-3, FLAC,
ADTS AAC, Sun AU and PlayStation VAG files, and ``-p`` the track of any
MPEG, AVI, MOV or Ogg file the port imports; an Ogg/OGM file (``-x
ogg``, or found by its magic) brings OGM raw I420/YV12 video and PCM or
Vorbis audio;
``-x dvd -T title[,chapter[-chapter]]`` reads a decrypted ``VIDEO_TS``
title and a directory given to ``-i`` plays its files in turn.  An AVI
(``-x avi``, or found by its magic) brings raw, LZO2 or MPEG-4 part 2
(DivX/Xvid) video and a PCM track; MPEG-4 is parsed on the host and
reconstructed on the card.  The export stage takes the JAX CLI's ``-y
venc[,aenc[,mux]]`` (encoders ``raw``, ``null``, ``copy``,
``yuv4mpeg``, ``mpeg2``, ``lzo`` and ``xvid``; multiplexors ``raw``, ``null``,
``y4m``, ``wav``, ``mpg`` and ``avi``, ``auto`` by the output's
extension), ``--avi_comments``, ``-F`` (the video encoder's options,
``k=v:...``, or the AVI's fourcc), ``-w``,
``--video_max_bitrate``, ``--quantizers``, ``--encode_fields``,
``--pulldown``, ``-R n[,logfile]`` (two-pass rate control: pass 1 writes
the log, ``divx4.log`` by default, pass 2 reads it) and ``-N
vformat[,aformat]`` (the encoders by format name where ``-y`` is not
given); the MPEG-2 encoder's motion search, prediction and block
coding run on the card, its syntax writer on the host, and ``mpg`` writes
a program stream with the audio track as DVD LPCM; so do the MPEG-4
(``xvid``) encoder's decisions and block coding, into an AVI or an
OGM.  The audio encoders are ``raw``, ``null``, ``copy``, ``lame``,
``mp2enc``/``toolame``, ``ac3enc``, ``faac``, ``flac`` and ``vorbis``
(the JAX package's in-tree coders), into any multiplexor that takes
audio (``ogg``: OGM PCM, or the native Vorbis stream); ``-m`` writes the
audio into the multiplexor its extension names (``wav`` where it names
none):

    python -m tcforge_tpu_torch.cli -i in.y4m -I 5 -Z 1280x720 \\
        -J hqdn3d=luma=4.0 -o out.y4m [--batch 16] [--device cuda]
    python -m tcforge_tpu_torch.cli -i in720.y4m -o out.y4m \\
        -J hqdn3d=luma=4.0,unsharp=luma=0.8:luma_matrix=7x5
    python -m tcforge_tpu_torch.cli -i in1080.y4m -o out.y4m \\
        -J tomsmocomp=searcheffort=5
    python -m tcforge_tpu_torch.cli -i in720.y4m -o out.y4m -J denoise3d
    python -m tcforge_tpu_torch.cli -i ntsc.y4m -o film.y4m \\
        -J 32detect,ivtc,decimate
    python -m tcforge_tpu_torch.cli -i in.y4m -o out.y4m -V rgb24 \\
        -j 8,16 -z -l -G 0.8
    python -m tcforge_tpu_torch.cli -i in1080i.y4m -o out.y4m \\
        -J smartdeinter,hqdn3d=luma=4.0 -Z 1280x720
    python -m tcforge_tpu_torch.cli -i ntsc.y4m -o 60p.y4m \\
        -J doublefps,smartbob
    python -m tcforge_tpu_torch.cli -i ntsc.y4m -o pal.y4m \\
        -J modfps=buffer=7 --export_fps 25 -Z 720x576
    python -m tcforge_tpu_torch.cli -i in.y4m -p in.wav -I 5 \\
        -Z 1280x720 -J hqdn3d=luma=4.0,normalize -E 44100 \\
        -o out.y4m -m out.wav
    python -m tcforge_tpu_torch.cli -i in.wav -o out.wav -E 44100 \\
        -J normalize,lowpass,astat
    python -m tcforge_tpu_torch.cli -i dvd.vob -x mpeg \\
        -J hqdn3d=luma=4.0 -o out.y4m --batch 16
    python -m tcforge_tpu_torch.cli -i VIDEO_TS -x dvd -T 1 -o out.y4m \\
        -J extsub=subtitle_file=subs.idx,hqdn3d=luma=4.0 -m out.wav
    python -m tcforge_tpu_torch.cli -i in1080i.y4m -p in.wav -I 5 \\
        -Z 720x480 -J hqdn3d=luma=4.0 -y mpeg2,raw,mpg \\
        -F gop_n=15:gop_m=3:rc=1:bitrate=6000 -o out.mpg
    python -m tcforge_tpu_torch.cli -i dvd.vob -y mpeg2,raw,raw \\
        -F gop_n=12:gop_m=1:qscale=5 -o out.m2v
    python -m tcforge_tpu_torch.cli -i in1080i422.y4m -V yuv422p -I 5 \\
        -Z 720x576 -J denoise3d -y mpeg2,raw,raw \\
        -F gop_n=12:gop_m=3:rc=1:bitrate=15000 -R 1,pass.log -o out.m2v
    python -m tcforge_tpu_torch.cli -i out.m2v -x mpeg -V yuv422p \\
        -J denoise3d -o out422.y4m
    python -m tcforge_tpu_torch.cli -i cap.ts -I 5 -Z 1280x720 \\
        -J hqdn3d=luma=4.0 -o out.y4m -m out.wav
    python -m tcforge_tpu_torch.cli -i avseq01.dat -J hqdn3d=luma=4.0 \\
        -o out.y4m -m out.wav
    python -m tcforge_tpu_torch.cli -i dvd.vob --psu_mode -o unit%d.y4m
    python -m tcforge_tpu_torch.cli -i in.y4m -p in.ac3 -o out.y4m \\
        -m out.wav
    python -m tcforge_tpu_torch.cli -i divx.avi -x avi \\
        -J hqdn3d=luma=4.0 -y raw,raw,avi -o out.avi
    python -m tcforge_tpu_torch.cli -i dvd.vob -x mpeg -Z 640x480 \\
        -J hqdn3d=luma=4.0 -y xvid,raw,avi \\
        -F keyint=12:bframes=2:four_mv=1 -w 1500 -o out.avi
    python -m tcforge_tpu_torch.cli -i VIDEO_TS -x dvd -T 1 -Z 640x480 \\
        -J hqdn3d=luma=4.0 -y xvid,vorbis,ogg=fourcc=XVID \\
        -F keyint=12:bframes=2:four_mv=1 -w 1500 -o film.ogm
    python -m tcforge_tpu_torch.cli -i VIDEO_TS -x dvd -T 1 \\
        -y xvid,lame,avi -o film.avi
    python -m tcforge_tpu_torch.cli -i a.flac -y null,vorbis,ogg -o a.ogg

and refuses every other flag of the JAX CLI with an error that names
it, and any other audio file, naming the JAX module that reads it.
``--device cuda`` (the default) with no card raises: the CLI never drops
to the CPU quietly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import torch

from tcforge_tpu_torch.core.formats import format_from_string
from tcforge_tpu_torch.core.framecode import parse_ranges
from tcforge_tpu_torch.core.job import FilterSpec, Job


def _parse_clip(text: str):
    """-j T[,L[,B[,R]]] with omitted values mirroring the reference
    (L defaults to T, B to T, R to L)."""
    parts = [int(x) for x in text.split(",")]
    t = parts[0]
    l = parts[1] if len(parts) > 1 else t
    b = parts[2] if len(parts) > 2 else t
    r = parts[3] if len(parts) > 3 else l
    return (t, l, b, r)


def _resize_units(spec: str):
    """-X/-B n[,m[,M]]: n rows and m columns of M pixels, M one of 8, 16
    and 32 (the default); the job counts 8-pixel units, (w, h)."""
    parts = [int(x) for x in spec.split(",")]
    n = parts[0]
    m = parts[1] if len(parts) > 1 else 0
    mult = parts[2] if len(parts) > 2 else 32
    if mult not in (8, 16, 32):
        raise SystemExit("invalid multiplier for -X/-B (must be 8, 16, or 32)")
    return (m * mult // 8, n * mult // 8)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tcforge_tpu_torch", allow_abbrev=False,
        description="tcforge on PyTorch/CUDA: Y4M, MPEG-1/2, AVI, MOV or "
                    "Ogg video (and audio) in, filter chain, Y4M, MPEG-2, "
                    "AVI, MOV, OGM or raw (and audio) out")
    p.add_argument("-i", dest="video_in", required=True,
                   help="input file (YUV4MPEG2, an MPEG-1/2 program or "
                        "elementary stream, a directory of them, a "
                        "VIDEO_TS directory with -x dvd, an AVI, MOV or "
                        "Ogg file, or an audio file for an audio-only "
                        "session)")
    p.add_argument("-o", dest="video_out", required=True,
                   help="output file (YUV4MPEG2, or the -y "
                        "multiplexor's)")
    p.add_argument("-x", "--import_with", dest="im_modules",
                   default="auto,auto",
                   help="import modules video[,audio] (video: auto, y4m, "
                        "wav, mpeg or its aliases mpeg2, mpg, vob, dvd, "
                        "multi; name=options)")
    p.add_argument("-y", "--export_with", dest="ex_modules",
                   default="raw,raw,auto",
                   help="export modules venc[,aenc[,mux]] (video: raw, "
                        "null, copy, yuv4mpeg, mpeg2, lzo, xvid, movjpeg; "
                        "audio: raw, null, copy, lame, mp2enc, toolame, "
                        "ac3enc, faac, flac, vorbis; mux: auto, raw, null, "
                        "y4m, wav, mpg, avi, mov, ogg; name=options)")
    p.add_argument("-F", "--export_param", dest="ex_v_fcc", default="",
                   help="video encoder option string (module-specific, "
                        "e.g. gop_n=12:gop_m=3)")
    p.add_argument("-N", dest="export_codec", default="",
                   help="export codecs vformat[,aformat] (selects "
                        "encoder modules by format name)")
    p.add_argument("-w", dest="bitrate",
                   help="video bitrate kbps[,keyframes] (enables rate "
                        "control)")
    p.add_argument("--video_max_bitrate", type=int, default=0,
                   help="maximum bitrate for VBR MPEG-2 (VBV cap) "
                        "[same as -w]")
    p.add_argument("--quantizers", default="",
                   help="min,max quantizer for MPEG-like codecs [2,31]")
    p.add_argument("--encode_fields", default="",
                   help="field-based encoding: t (top-first), b "
                        "(bottom-first), p (progressive), u (unknown)")
    p.add_argument("--pulldown", action="store_true",
                   help="set MPEG 3:2 pulldown flags on export")
    p.add_argument("-R", dest="multipass",
                   help="multipass mode n[,logfile] (1=analyze 2=encode)")
    p.add_argument("--avi_comments", dest="avi_comments",
                   help="file of 'TAG text' lines -> AVI LIST INFO")
    p.add_argument("-T", dest="dvd_title", default="",
                   help="DVD title[,chapters[,angle]] of a decrypted "
                        "VIDEO_TS directory (-x dvd)")
    p.add_argument("-a", dest="a_track", type=int, default=0,
                   help="audio track to extract")
    p.add_argument("-p", dest="audio_in",
                   help="audio input file (an audio file, or the track of "
                        "an MPEG, AVI, MOV or Ogg file)")
    p.add_argument("-m", dest="audio_out",
                   help="audio output file (its multiplexor by its "
                        "extension, WAV where it names none)")
    # audio (the JAX CLI's flags and parsing)
    p.add_argument("-s", "--audio_scale", dest="volume", type=float,
                   default=1.0, help="volume scale")
    p.add_argument("-E", dest="resample", default="0",
                   help="audio output rate[,bits[,channels]]")
    p.add_argument("-e", dest="import_afmt", default="",
                   help="import audio rate[,bits[,channels]] "
                   "[48000,16,2]")
    p.add_argument("-n", dest="import_codec", default="",
                   help="import audio codec id (hex, e.g. 0x2000)")
    p.add_argument("-b", dest="abitrate", default="",
                   help="audio encoder bitrate kbps (lame, mp2enc, ac3enc, "
                        "faac)")
    p.add_argument("-A", dest="audio_use_ac3", action="store_true",
                   help="use AC3 as internal audio codec")
    p.add_argument("-M", dest="demuxer_sync", type=int, default=1,
                   help="demuxer sync mode (accepted for parity)")
    p.add_argument("--a52_demux", action="store_true",
                   help="(gated) demux AC3/A52 to separate channels")
    p.add_argument("--a52_drc_off", action="store_true",
                   help="(gated) disable AC3 dynamic range compression")
    p.add_argument("--a52_dolby_off", action="store_true",
                   help="(gated) disable AC3 Dolby surround")
    p.add_argument("--dv_yv12_mode", action="store_true",
                   help="(gated) force YV12 for PAL DV decode")
    p.add_argument("--dv_yuy2_mode", action="store_true",
                   help="(gated) use YUY2 for PAL DV decode")
    p.add_argument("-d", "--audio_swap", dest="channels", type=int,
                   default=0, help="output channels")
    p.add_argument("-D", "--sync_frame", dest="av_offset", type=int,
                   default=0, help="A/V shift in frames (audio delay)")
    p.add_argument("--av_fine_ms", type=int, default=0,
                   help="sub-frame A/V shift in milliseconds")
    p.add_argument("--sync", dest="sync_method", default="adjust",
                   choices=["none", "adjust"],
                   help="A/V synchronizer method")
    p.add_argument("--resync_margin", type=int, default=1,
                   help="max A/V drift in frames before resync [1]")
    p.add_argument("--resync_interval", type=int, default=25,
                   help="check A/V sync every N frames [25]")
    p.add_argument("--no_audio_adjust", action="store_true",
                   help="disable audio frame size adjustment")
    p.add_argument("--pre_clip", dest="pre_clip",
                   help="initial region clip T[,L[,B[,R]]] (before "
                        "all filters)")
    p.add_argument("-j", dest="im_clip", help="clip T[,L[,B[,R]]]")
    p.add_argument("-I", dest="deinterlace", type=int, default=0,
                   help="deinterlace mode 1..5")
    p.add_argument("-X", dest="resize_up",
                   help="expand by n rows, m cols of M px [0,0,32]")
    p.add_argument("-B", dest="resize_down",
                   help="shrink by n rows, m cols of M px [0,0,32]")
    p.add_argument("-Z", dest="zoom", help="zoom WxH (slow, filtered)")
    p.add_argument("--zoom_filter", default="lanczos3",
                   help="zoom filter (lanczos3|bell|box|mitchell|...)")
    p.add_argument("-Y", dest="ex_clip", help="export clip T[,L[,B[,R]]]")
    p.add_argument("-r", dest="reduce", help="reduce n[,m]")
    p.add_argument("-z", dest="flip_v", action="store_true",
                   help="flip vertically")
    p.add_argument("-l", dest="flip_h", action="store_true", help="mirror")
    p.add_argument("-k", dest="rgbswap", action="store_true",
                   help="swap red/blue")
    p.add_argument("-K", dest="decolor", action="store_true",
                   help="grayscale")
    p.add_argument("-G", dest="gamma", type=float, default=0.0,
                   help="gamma correction")
    p.add_argument("-C", dest="antialias", type=int, default=0,
                   help="antialias mode 1..3")
    p.add_argument("--antialias_para", default="",
                   help="antialias center pixel weight, xy-bias "
                        "[0.333,0.500]")
    p.add_argument("--post_clip", dest="post_clip",
                   help="final region clip T[,L[,B[,R]]] (after all "
                        "filters)")
    p.add_argument("-J", dest="filters", action="append", default=[],
                   help="filter chain: name[=opts][,name...]")
    p.add_argument("-V", dest="colorspace", default="yuv420p",
                   help="internal colorspace (yuv420p|rgb24|yuv422p)")
    p.add_argument("-c", dest="ranges",
                   help="encode ranges S-E[/step][,...] (times or frames)")
    p.add_argument("--frame_interval", type=int, default=1,
                   help="encode every Nth frame")
    p.add_argument("--max_frames", type=int, help="stop after N frames")
    p.add_argument("-L", "--vob_seek", dest="vob_offset", type=int,
                   default=0, help="seek: skip the first N source frames")
    # MPEG navigation (the JAX CLI's flags and parsing)
    p.add_argument("-S", dest="seek_unit", default=None,
                   help="seek unit[,chunks] (program-stream units)")
    p.add_argument("--nav_seek", dest="nav_seek",
                   help="tcdemux nav index file for frame-exact "
                        "MPEG seeking")
    p.add_argument("-W", dest="autosplit", default="",
                   help="autosplit: process chunk n of m "
                        "(n,m[,navfile])")
    p.add_argument("--cluster_chunks", default="",
                   help="process chunk range a-b instead of one chunk")
    p.add_argument("--cluster_percentage", action="store_true",
                   help="-W values are percentages")
    p.add_argument("--psu_mode", action="store_true",
                   help="process MPEG program stream units separately "
                        "(-o needs %%d)")
    p.add_argument("--psu_first", type=int, default=0,
                   help="first PSU to process")
    p.add_argument("--psu_last", type=int, default=-1,
                   help="last PSU to process (exclusive; -1 = all)")
    p.add_argument("--psu_chunks", default="",
                   help="process only units a-b in PSU mode")
    p.add_argument("--no_split", action="store_true",
                   help="encode to a single file in chapter/PSU mode")
    p.add_argument("--ts_pid", default="",
                   help="transport stream video pid (hex)")
    p.add_argument("--export_fps", dest="export_fps", type=float,
                   default=0.0, help="output fps (for fps/modfps filters)")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device batch")
    p.add_argument("--prefetch", type=int, default=2,
                   help="host prefetch depth")
    p.add_argument("--progress_rate", type=float, default=0.5,
                   help="progress meter update interval (seconds)")
    p.add_argument("--progress_off", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda or cpu)")
    return p


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(use --device cpu to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return dev


def args_to_job(args: argparse.Namespace) -> Job:
    job = Job(video_in_file=args.video_in, video_out_file=args.video_out,
              audio_in_file=args.audio_in, audio_out_file=args.audio_out,
              deinterlace=args.deinterlace, batch_size=args.batch,
              max_frames=args.max_frames, frame_interval=args.frame_interval,
              vob_offset=args.vob_offset, prefetch_depth=args.prefetch,
              progress_rate=args.progress_rate)
    # "-x module=optstring" (the JAX CLI's _mod_opts)
    im_mods = (args.im_modules + ",auto").split(",")
    job.im_v_module, _, job.im_v_string = im_mods[0].partition("=")
    job.im_a_module, _, job.im_a_string = im_mods[1].partition("=")
    ex_mods = (args.ex_modules + ",raw,auto").split(",")
    job.ex_v_module, _, job.ex_v_string = ex_mods[0].partition("=")
    job.ex_a_module, _, job.ex_a_string = ex_mods[1].partition("=")
    job.ex_m_module, _, job.ex_m_string = ex_mods[2].partition("=")
    # the encoder's flags (tcforge_tpu/cli.py:412-431)
    job.ex_v_fcc = args.ex_v_fcc
    job.avi_comments_file = args.avi_comments
    if args.bitrate:
        parts = args.bitrate.split(",")
        job.bitrate = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.keyframes = int(parts[1])
        job.rc_requested = True
    job.video_max_bitrate = args.video_max_bitrate
    if args.quantizers:
        mn, mx = args.quantizers.split(",")
        job.min_quantizer, job.max_quantizer = int(mn), int(mx)
        if not (1 <= job.min_quantizer <= 31
                and 1 <= job.max_quantizer <= 31):
            raise ValueError("--quantizers values must be in 1..31")
    if args.encode_fields:
        codes = {"p": 0, "t": 1, "b": 2, "u": 3}
        if args.encode_fields not in codes:
            raise ValueError("--encode_fields takes t, b, p or u")
        job.encode_fields = codes[args.encode_fields]
    job.pulldown = args.pulldown
    job.ex_codec_names = args.export_codec
    if args.multipass:
        parts = args.multipass.split(",")
        job.divxmultipass = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.divxlogfile = parts[1]
        elif job.divxmultipass:
            job.divxlogfile = "divx4.log"
    if job.ex_codec_names and args.ex_modules == "raw,raw,auto":
        _select_encoders(job)
    if args.export_fps:
        job.ex_fps = args.export_fps
    if args.pre_clip:
        job.pre_im_clip = _parse_clip(args.pre_clip)
    if args.im_clip:
        job.im_clip = _parse_clip(args.im_clip)
    if args.post_clip:
        job.post_ex_clip = _parse_clip(args.post_clip)
    if args.resize_up:
        job.resize_up = _resize_units(args.resize_up)
    if args.resize_down:
        job.resize_down = _resize_units(args.resize_down)
    if args.zoom:
        w, h = args.zoom.split("x", 1)
        job.zoom_width, job.zoom_height = int(w), int(h)
    job.zoom_filter = args.zoom_filter
    if args.ex_clip:
        job.ex_clip = _parse_clip(args.ex_clip)
    if args.reduce:
        parts = [int(x) for x in args.reduce.split(",")]
        job.reduce_h = parts[0]
        job.reduce_w = parts[1] if len(parts) > 1 else parts[0]
    job.flip_v = args.flip_v
    job.flip_h = args.flip_h
    job.rgbswap = args.rgbswap
    job.decolor = args.decolor
    job.gamma = args.gamma
    job.antialias = args.antialias
    if args.antialias_para:
        w, b = args.antialias_para.split(",")
        job.antialias_weight = float(w)
        job.antialias_bias = float(b)
    job.im_colorspace = format_from_string(args.colorspace)
    for chain in args.filters:
        for part in chain.split(","):
            if part.strip():
                job.filters.append(FilterSpec.parse(part.strip()))
    job.volume = args.volume
    # -E rate[,bits[,channels]] (export_afmt, cmdline_def.h:898)
    eparts = str(args.resample).split(",")
    job.mp3frequency = int(eparts[0] or 0)
    if len(eparts) > 1 and eparts[1]:
        job.dm_bits = int(eparts[1])
    if len(eparts) > 2 and eparts[2]:
        job.dm_chan = int(eparts[2])
    _import_afmt(args, job)
    if args.import_codec:
        job.a_codec_flag = int(args.import_codec, 16)
    if args.abitrate:
        # the in-tree encoders take the bitrate alone, as in the JAX
        # package
        job.mp3bitrate = int(args.abitrate.split(",")[0])
    if args.audio_use_ac3:
        from tcforge_tpu_torch.core.codecs import Codec
        job.im_a_codec = Codec.AC3
    # the --a52_* bits: no decoder reads them, as in the JAX package
    job.a52_mode = ((1 if args.a52_demux else 0)
                    | (2 if args.a52_drc_off else 0)
                    | (4 if args.a52_dolby_off else 0))
    # stored on the job and read by no decoder, as in the JAX package
    job.dv_yuy2_mode = args.dv_yuy2_mode and not args.dv_yv12_mode
    job.av_offset = args.av_offset
    job.sync_method = args.sync_method
    job.resync_margin = args.resync_margin
    job.resync_interval = args.resync_interval
    job.no_audio_adjust = args.no_audio_adjust
    if args.channels:
        job.dm_chan = args.channels
    job.av_fine_ms = args.av_fine_ms
    job.a_track = args.a_track
    if args.seek_unit:
        job.seek_unit = int(args.seek_unit.split(",")[0])
    if args.nav_seek:
        job.nav_seek_file = args.nav_seek
    if args.ts_pid:
        job.ts_pid1 = int(args.ts_pid, 16)
    if args.dvd_title:
        # -T t[,c[-d][,a]] (cmdline_def.h:340)
        parts = args.dvd_title.split(",")
        job.dvd_title = int(parts[0])
        if len(parts) > 1 and parts[1]:
            ch = parts[1].split("-")
            job.dvd_chapter1 = int(ch[0])
            if len(ch) > 1 and ch[1]:
                job.dvd_chapter2 = int(ch[1])
        if len(parts) > 2 and parts[2]:
            job.dvd_angle = int(parts[2])
    return job


def _import_afmt(args: argparse.Namespace, job: Job) -> None:
    """-e rate[,bits[,channels]] (import_afmt, cmdline_def.h:556): the
    job's audio rate, bits and channels, which the null importer's
    session and the multiplexors read."""
    if args.import_afmt:
        parts = args.import_afmt.split(",")
        job.a_rate = int(parts[0])
        if len(parts) > 1 and parts[1]:
            job.a_bits = int(parts[1])
        if len(parts) > 2 and parts[2]:
            job.a_chan = int(parts[2])


def _select_encoders(job: Job) -> None:
    """-N vformat[,aformat] with -y left at its default: the encoders by
    format name (tcforge_tpu/cli.py:625-641)."""
    from tcforge_tpu_torch.modules.registry import encoder_for_format
    names = job.ex_codec_names.split(",")
    vmod = encoder_for_format(names[0])
    if vmod is None:
        raise ValueError(f"-N: no encoder for format {names[0]!r}")
    job.ex_v_module = vmod
    if len(names) > 1 and names[1]:
        amod = encoder_for_format(names[1])
        if amod is None and names[1].lower() != "pcm":
            raise ValueError(f"-N: no encoder for format {names[1]!r}")
        job.ex_a_module = amod or "raw"


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra:
        parser.error("not supported by the torch port yet: "
                     + " ".join(extra))
    return args


def _autosplit(args: argparse.Namespace, job: Job) -> None:
    """-W n,m[,navfile]: chunk n of m of the stream as -L and
    --max_frames (tcforge_tpu/cli.py:644-685); the stream's length is
    the nav file's ``total_pictures`` (JSON, as tcdemux writes it), else
    --max_frames or the probe's frame count.  --cluster_chunks a-b takes
    chunks a to b, --cluster_percentage reads n and m as percentages."""
    parts = args.autosplit.split(",")
    if len(parts) < 2:
        raise ValueError("-W needs n,m[,navfile]")
    job.vob_chunk = int(parts[0])
    job.vob_chunk_max = int(parts[1])
    job.vob_percentage = args.cluster_percentage
    navf = parts[2] if len(parts) > 2 and parts[2] else args.nav_seek
    total = 0
    if navf and os.path.exists(navf):
        with open(navf) as f:
            total = int(json.load(f).get("total_pictures", 0))
    if not total:
        total = job.max_frames or 0
    if not total:
        raise ValueError("-W: unknown stream length; provide a tcdemux nav "
                         "file (-W n,m,navfile)")
    startc, chunks = job.vob_chunk, 1
    if args.cluster_chunks:
        a, b = args.cluster_chunks.split("-")
        job.vob_chunk_num1, job.vob_chunk_num2 = int(a), int(b)
        startc, chunks = int(a), int(b) - int(a)
    if args.cluster_percentage:
        start = total * job.vob_chunk // 100
        end = total * min(100, job.vob_chunk + job.vob_chunk_max) // 100
    else:
        start = total * startc // job.vob_chunk_max
        end = total * (startc + chunks) // job.vob_chunk_max
    job.vob_offset += start
    job.max_frames = end - start


def _probed_job(args: argparse.Namespace) -> Job:
    """The job with the input's size and rate from its header, -W's
    chunk, and the -c ranges parsed at that rate (the JAX CLI maps -W and
    parses the ranges after its probe)."""
    from tcforge_tpu_torch.pipeline.engine import probe
    job = args_to_job(args)
    probe(job)
    # -e wins over the probe, as in the JAX CLI
    _import_afmt(args, job)
    if args.autosplit:
        _autosplit(args, job)
    if args.ranges:
        job.ranges = parse_ranges(args.ranges, job.fps)
    return job


def job_from_argv(argv: List[str]) -> Job:
    """The job that ``main(argv)`` would run, without running it."""
    return _probed_job(_parse(argv))


def _psu_units(args: argparse.Namespace) -> None:
    """--psu_chunks a-b sets the first and last unit, and PSU mode unless
    --no_split is given (then neither changes: the whole stream runs, as
    in the JAX CLI)."""
    if args.psu_chunks:
        ab = args.psu_chunks.split("-")
        args.psu_first = int(ab[0])
        args.psu_last = int(ab[1])
        if not args.psu_mode and not args.no_split:
            args.psu_mode = True


def _run(args: argparse.Namespace, job: Job, device: torch.device) -> int:
    """One pipeline of ``job``: its frame count (the summary printed
    unless -q)."""
    from tcforge_tpu_torch.pipeline.engine import Pipeline
    pipe = Pipeline(job, device)
    counters = pipe.run(progress=not (args.progress_off or args.quiet))
    if not args.quiet:
        print(f"[torch] {counters.summary()} on {pipe.device}",
              file=sys.stderr)
    return counters.frames


def _psu_mode(args: argparse.Namespace, job: Job,
              device: torch.device) -> int:
    """--psu_mode: one pipeline a program stream unit, each writing the
    -o name with the unit's number for its %d (tcforge_tpu/cli.py:705-
    732); 1 where -o has no %d, a unit fails or no frame was read."""
    from tcforge_tpu_torch.io.mpeg import count_psus
    if "%d" not in (job.video_out_file or ""):
        print("[torch] --psu_mode needs %d in -o", file=sys.stderr)
        return 1
    n_units = count_psus(job.video_in_file)
    last = args.psu_last if args.psu_last >= 0 else n_units
    out_tpl = job.video_out_file
    frames = 0
    for unit in range(args.psu_first, min(last, n_units)):
        job.psu_unit = unit
        job.video_out_file = out_tpl % unit
        try:
            frames += _run(args, job, device)
        except (OSError, ValueError, KeyError, NotImplementedError) as e:
            print(f"[torch] PSU {unit} failed: {e}", file=sys.stderr)
            return 1
    return 0 if frames > 0 else 1


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(argv)
    device = _device(args.device)
    try:
        job = _probed_job(args)
        _psu_units(args)
        if args.psu_mode and args.no_split:
            # the units from the first up to the last in one output
            from tcforge_tpu_torch.io.mpeg import count_psus
            job.psu_unit = args.psu_first
            job.psu_unit_end = (args.psu_last if args.psu_last >= 0
                                else count_psus(job.video_in_file))
        elif args.psu_mode:
            return _psu_mode(args, job, device)
        frames = _run(args, job, device)
    except (OSError, ValueError, KeyError, NotImplementedError) as e:
        print(f"[torch] the pipeline failed: {e}", file=sys.stderr)
        return 1
    return 0 if frames > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
