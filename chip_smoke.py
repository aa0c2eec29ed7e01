#!/usr/bin/env python3
"""Drive the torch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

The main path is the 1080i -> 720p chain of ``bench.py``: YUV420P
1920x1080, batch 16, ``-I 5`` linear-blend deinterlace, ``-Z 1280x720``
Lanczos3 zoom, ``-J hqdn3d=luma=4.0`` (which runs after the zoom, at
1280x720).  Phases, each of which raises on failure:

1. a CUDA card is present; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``tcforge_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain torch version on the card, at the main
   path's shapes, tolerance 0 (all of it is integer arithmetic);
4. the port's CLI on a seeded 48-frame 1080i Y4M: every kernel was
   launched, and the output equals the same chain built from the plain
   versions on the card, byte for byte;
5. the small case whose SHA-256 ``tests/test_torch_cli.py`` pins against
   the JAX CLI, run on the card: same digest;
6. numbers: steady-state chain frames/s on device-resident batches
   (CUDA events), end-to-end CLI frames/s, each kernel's time beside
   its plain version's.

It prints one JSON object per result, then the kernels' summary and, as
its last line, ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.  Without a CUDA device it exits non-zero before printing a result.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the main path (bench.py:29-44, __graft_entry__.py:15-56)
MAIN_W, MAIN_H, MAIN_BATCH, MAIN_FRAMES = 1920, 1080, 16, 48
MAIN_ARGS = ["-I", "5", "-Z", "1280x720", "-J", "hqdn3d=luma=4.0"]

# the small golden case: port CLI == JAX CLI byte for byte on the CPU
# (tests/test_torch_cli.py), and this digest on the card
GOLDEN_W, GOLDEN_H, GOLDEN_FRAMES, GOLDEN_SEED = 128, 72, 7, 1
GOLDEN_ARGS = ["-I", "5", "-Z", "64x48", "-J", "hqdn3d=luma=4.0",
               "--batch", "3"]
GOLDEN_SHA256 = ("d722baeee4117656ce281b2d83799d44"
                 "cbe1f88ce33ef1f63f29ef87afa73784")

KERNELS = {
    "hqdn3d_spatial_scan": ("tcforge_tpu_torch/csrc/hqdn3d_scan.cu",
                            "tcforge_tpu/ops/kernels.py:221"),
    "hqdn3d_temporal_scan": ("tcforge_tpu_torch/csrc/hqdn3d_scan.cu",
                             "tcforge_tpu/ops/kernels.py:277"),
    "zoom_pass": ("tcforge_tpu_torch/csrc/zoom_pass.cu",
                  "tcforge_tpu/ops/kernels.py:859"),
}


def write_test_y4m(path, width: int, height: int, frames: int,
                   seed: int) -> None:
    """A seeded YUV420P Y4M of uniform noise at 25 fps."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    hdr = Y4MHeader(width=width, height=height, fps_num=25, fps_den=1)
    with Y4MWriter(str(path), hdr) as wr:
        for _ in range(frames):
            wr.write_frame(
                rng.integers(0, 256, (height, width), dtype=np.uint8),
                rng.integers(0, 256, (height // 2, width // 2),
                             dtype=np.uint8),
                rng.integers(0, 256, (height // 2, width // 2),
                             dtype=np.uint8))


def sha256_file(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tcforge_tpu_torch import cli
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.io.y4m import Y4MReader
    from tcforge_tpu_torch.modules.filters.hqdn3d import Hqdn3dFilter
    from tcforge_tpu_torch.ops import _build, kernels, video, zoom

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit(phase="card", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build
    for lib in ("hqdn3d_scan", "zoom_pass"):
        t0 = time.perf_counter()
        path, report = _build.build(lib)
        kernels._lib(lib)
        emit(phase="build", lib=lib, seconds=time.perf_counter() - t0,
             path=str(path.relative_to(ROOT)))
        for line in report.splitlines():
            if "ptxas info" in line:
                print("  " + line.strip(), flush=True)

    # 3. kernels vs plain versions at the main path's shapes
    job = Job(deinterlace=5, zoom_width=1280, zoom_height=720,
              filters=[FilterSpec("hqdn3d", "luma=4.0")])
    hq = Hqdn3dFilter(job, "luma=4.0")
    ls, lt, cs, ct = hq.luts(dev)
    rng = np.random.default_rng(7)

    def rand_u8(*shape):
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def max_err(a, b):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
              f"{tuple(b.shape)} {b.dtype}")
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    stats = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0}
             for k in KERNELS}

    def record(kernel, case, err, ms, plain_ms):
        emit(phase="kernel", kernel=kernel, case=case, max_abs_err=err,
             ms=ms, plain_ms=plain_ms)
        check(err == 0, f"{kernel} {case} differs from its plain version "
                        f"(max abs err {err})")
        s = stats[kernel]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms

    # "ms" sums the launches of one 16-frame batch: u and v count twice
    for plane, (n, h, w), sp, tp, per_batch in (
            ("y", (16, 720, 1280), ls, lt, 1),
            ("u/v", (16, 360, 640), cs, ct, 2)):
        frames = [rand_u8(n, h, w), rand_u8(n, h, w)]
        vs = []
        for axis, name in ((-1, "H"), (-2, "V")):
            src = frames[0] if axis == -1 else hp
            got = kernels.spatial_scan(src, sp, axis)
            want = kernels.spatial_scan_ref(src, sp, axis)
            err = max_err(got, want)
            ms = timed(lambda: kernels.spatial_scan(src, sp, axis), 20)
            pms = timed(lambda: kernels.spatial_scan_ref(src, sp, axis), 1)
            record("hqdn3d_spatial_scan", f"{plane} {name} {(n, h, w)}",
                   err, ms * per_batch, pms * per_batch)
            hp = got
        vs.append(hp)
        vs.append(kernels.spatial_scan(kernels.spatial_scan(
            frames[1], sp, -1), sp, -2))
        # two consecutive batches: the FrameAnt carry crosses them
        ant0 = frames[0][0].to(torch.int32) << 8
        o1, a1 = kernels.temporal_scan(vs[0], ant0, tp)
        o2, a2 = kernels.temporal_scan(vs[1], a1, tp)
        r1, b1 = kernels.temporal_scan_ref(vs[0], ant0, tp)
        r2, b2 = kernels.temporal_scan_ref(vs[1], b1, tp)
        err = max(max_err(o1, r1), max_err(a1, b1), max_err(o2, r2),
                  max_err(a2, b2))
        ms = timed(lambda: kernels.temporal_scan(vs[0], ant0, tp), 20)
        pms = timed(lambda: kernels.temporal_scan_ref(vs[0], ant0, tp), 3)
        record("hqdn3d_temporal_scan", f"{plane} 2 batches {(n, h, w)}",
               err, ms * per_batch, pms * per_batch)

    for plane, (h, w), (nh, nw), per_batch in (
            ("y", (1080, 1920), (720, 1280), 1),
            ("u/v", (540, 960), (360, 640), 2)):
        src = rand_u8(16, h, w)
        for axis, old, new, name in ((-1, w, nw, "H"), (-2, h, nh, "V")):
            band = zoom._device_band(old, new, "lanczos3", str(dev))
            got = kernels.zoom_pass(src, band, axis)
            want = kernels.zoom_pass_ref(src, band, axis)
            err = max_err(got, want)
            ms = timed(lambda: kernels.zoom_pass(src, band, axis), 20)
            pms = timed(lambda: kernels.zoom_pass_ref(src, band, axis), 3)
            record("zoom_pass", f"{plane} {name} {tuple(src.shape)}->"
                                f"{tuple(got.shape)}", err, ms * per_batch,
                   pms * per_batch)
            src = got
    del frames, vs, hp
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        # 4. the main path through the port's CLI
        src = tmp / "in1080.y4m"
        out = tmp / "out720.y4m"
        write_test_y4m(src, MAIN_W, MAIN_H, MAIN_FRAMES, seed=3)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(out), *MAIN_ARGS,
                       "--batch", str(MAIN_BATCH), "--device", "cuda",
                       "--progress_off", "-q"])
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        check(rc == 0, f"CLI exit code {rc}")
        emit(phase="main_path", frames=MAIN_FRAMES, seconds=e2e_s,
             e2e_fps=MAIN_FRAMES / e2e_s, launches=launches)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was not launched by the "
                             "main path")
        got = _read_y4m(Y4MReader, out)
        check(got[0].shape == (MAIN_FRAMES, 720, 1280)
              and got[1].shape == (MAIN_FRAMES, 360, 640),
              f"main path output shapes {[p.shape for p in got]}")
        want = _plain_chain(torch, dev, _read_y4m(Y4MReader, src), hq,
                            video, zoom, kernels)
        diff = [int((torch.from_numpy(g).to(dev).int() - w.int()).abs()
                    .max()) for g, w in zip(got, want)]
        emit(phase="main_path_vs_plain", max_abs_err=max(diff),
             planes=["y", "u", "v"])
        check(max(diff) == 0, f"main path differs from the plain chain on "
                              f"the card: {diff}")

        # 5. golden digest pinned against the JAX CLI
        gsrc, gout = tmp / "golden_in.y4m", tmp / "golden_out.y4m"
        write_test_y4m(gsrc, GOLDEN_W, GOLDEN_H, GOLDEN_FRAMES, GOLDEN_SEED)
        rc = cli.main(["-i", str(gsrc), "-o", str(gout), *GOLDEN_ARGS,
                       "--device", "cuda", "--progress_off", "-q"])
        digest = sha256_file(gout)
        emit(phase="golden", sha256=digest, pinned=GOLDEN_SHA256)
        check(rc == 0 and digest == GOLDEN_SHA256,
              "golden output differs from the JAX-pinned digest")

    # 6. steady-state chain frames/s on device-resident batches
    fps = _chain_fps(torch, dev)
    emit(phase="chain", batch=MAIN_BATCH, **fps)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _read_y4m(reader_cls, path):
    with reader_cls(str(path)) as r:
        return r.read_batch(1 << 30)


def _plain_chain(torch, dev, planes, hq, video, zoom, kernels):
    """The main path composed from the plain torch versions only, on the
    card: deinterlace, zoom, then hqdn3d with FrameAnt carried."""
    ls, lt, cs, ct = hq.luts(dev)

    def zoom_ref(p, nw, nh):
        h, w = p.shape[-2:]
        p = kernels.zoom_pass_ref(p, zoom._device_band(
            w, nw, "lanczos3", str(dev)), -1)
        return kernels.zoom_pass_ref(p, zoom._device_band(
            h, nh, "lanczos3", str(dev)), -2)

    outs = [[], [], []]
    ants = [None, None, None]
    n = planes[0].shape[0]
    for b0 in range(0, n, MAIN_BATCH):
        y, u, v = (torch.from_numpy(p[b0:b0 + MAIN_BATCH]).to(dev)
                   for p in planes)
        y = video.deint_linear_blend(y)
        batch = (zoom_ref(y, 1280, 720), zoom_ref(u, 640, 360),
                 zoom_ref(v, 640, 360))
        for k, (p, sp, tp) in enumerate(zip(batch, (ls, cs, cs),
                                            (lt, ct, ct))):
            ant = ants[k] if ants[k] is not None else \
                p[0].to(torch.int32) << 8
            hp = kernels.spatial_scan_ref(p, sp, -1)
            vp = kernels.spatial_scan_ref(hp, sp, -2)
            o, ants[k] = kernels.temporal_scan_ref(vp, ant, tp)
            outs[k].append(o)
    return [torch.cat(o) for o in outs]


def _chain_fps(torch, dev, warmup: int = 2, timed_batches: int = 8):
    """Frames/s of VideoChain on batches already on the card: CUDA
    events around ``timed_batches`` distinct batches after ``warmup``
    ones, with the hqdn3d FrameAnt carried throughout."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.pipeline.chain import VideoChain

    job = Job(im_v_width=MAIN_W, im_v_height=MAIN_H, deinterlace=5,
              zoom_width=1280, zoom_height=720,
              filters=[FilterSpec("hqdn3d", "luma=4.0")],
              batch_size=MAIN_BATCH)
    chain = VideoChain(job, ImageFormat.YUV420P, MAIN_W, MAIN_H)
    states = chain.initial_states(dev)
    gen = torch.Generator(device=dev).manual_seed(11)

    def plane(h, w):
        return torch.randint(0, 256, (MAIN_BATCH, h, w), generator=gen,
                             dtype=torch.uint8, device=dev)

    batches = [FrameBatch(
        format=ImageFormat.YUV420P, y=plane(MAIN_H, MAIN_W),
        u=plane(MAIN_H // 2, MAIN_W // 2), v=plane(MAIN_H // 2, MAIN_W // 2),
        attrs=torch.zeros(MAIN_BATCH, dtype=torch.int32, device=dev),
        frame_ids=torch.arange(MAIN_BATCH, dtype=torch.int32, device=dev),
        fps=25.0) for _ in range(warmup + timed_batches)]
    for fb in batches[:warmup]:
        _, states = chain(fb, states)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for fb in batches[warmup:]:
        out, states = chain(fb, states)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    dev_ms = start.elapsed_time(end)
    frames = MAIN_BATCH * timed_batches
    return {"chain_fps": frames / (dev_ms / 1e3),
            "ms_per_batch": dev_ms / timed_batches,
            "host_s": host_s, "frames": frames,
            "out_shape": list(out.y.shape)}


if __name__ == "__main__":
    sys.exit(main())
