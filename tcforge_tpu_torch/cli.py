"""Command line of the port: ``python -m tcforge_tpu_torch.cli``.

It takes the JAX CLI's own flag names for what this slice carries:

    python -m tcforge_tpu_torch.cli -i in.y4m -I 5 -Z 1280x720 \\
        -J hqdn3d=luma=4.0 -o out.y4m [--batch 16] [--device cuda]

and refuses every other flag of the JAX CLI with an error that names
it.  ``--device cuda`` (the default) with no card raises: the CLI never
drops to the CPU quietly.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from tcforge_tpu_torch.core.job import FilterSpec, Job


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tcforge_tpu_torch", allow_abbrev=False,
        description="tcforge on PyTorch/CUDA: Y4M in, filter chain, "
                    "Y4M out")
    p.add_argument("-i", dest="video_in", required=True,
                   help="input file (YUV4MPEG2)")
    p.add_argument("-o", dest="video_out", required=True,
                   help="output file (YUV4MPEG2)")
    p.add_argument("-I", dest="deinterlace", type=int, default=0,
                   help="deinterlace mode 1, 3, 4 or 5")
    p.add_argument("-Z", dest="zoom", help="zoom WxH (Lanczos3)")
    p.add_argument("-J", dest="filters", action="append", default=[],
                   help="filter[=options] list (only hqdn3d so far)")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device batch")
    p.add_argument("--max_frames", type=int, help="stop after N frames")
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
              deinterlace=args.deinterlace, batch_size=args.batch,
              max_frames=args.max_frames)
    if args.zoom:
        w, h = args.zoom.split("x", 1)
        job.zoom_width, job.zoom_height = int(w), int(h)
    for chain in args.filters:
        for part in chain.split(","):
            if part.strip():
                job.filters.append(FilterSpec.parse(part.strip()))
    return job


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra:
        parser.error("not supported by the torch port yet: "
                     + " ".join(extra))
    from tcforge_tpu_torch.pipeline.engine import Pipeline

    pipe = Pipeline(args_to_job(args), _device(args.device))
    show = not (args.progress_off or args.quiet)
    counters = pipe.run(
        progress=(lambda c: print(f"\r[torch] {c.frames} frames",
                                  end="", file=sys.stderr))
        if show else None)
    if show:
        print(file=sys.stderr)
    if not args.quiet:
        print(f"[torch] {counters.summary()} on {pipe.device}",
              file=sys.stderr)
    return 0 if counters.frames > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
