"""Command-line entry point: `python -m raytracing_rust_tpu_torch`.

Counterpart of `raytracing_rust_tpu/cli.py` for what the port covers:
`scenes` lists the presets; `render` renders one, with Russian roulette
from bounce N on under `--rr-depth N` and a resumable `.npz` under
`--checkpoint PATH`, through one of two engines (`--engine`):

* `kernel`: the K1 kernel (`ops/tracer.render_kernel`). A scene it refuses,
  as the JAX kernel refuses it (an image on a rotated sphere, a nested
  checker, an image that is not 8-bit exact, more than 8 media, more than
  96 rects that form no box beside more prims), exits 2 with the reason;
* `xla`: the general wavefront tier (`render.render`), torch ops on the
  same device (the JAX CLI's name for its XLA tier, so both command lines
  take the same flags); it takes every scene;
* `auto` (the default): the kernel, and the general tier only where the
  kernel's record build refuses the scene, with one line on stderr. No
  preset is refused. A kernel that fails to build or launch is an error,
  never a reason to change engines.

`--bvh auto|on|off` (default `auto`) picks how the general tier finds its
closest hits: `on` by a BVH (`accel/bvh.py`), `off` by the dense scan,
`auto` by `render.auto_use_bvh` (the device's measured crossover in prims).
`on` renders on the general tier under `--engine auto` (one line on
stderr) and exits 2 under `--engine kernel`, as the JAX CLI's `--bvh` does
with its Pallas engine; `auto` leaves K1 where it takes the scene. Unlike
JAX's store_true flag, `off` forces the dense scan.

`render_scene` is that choice, for any scene. `--device cuda` (the default)
needs CUDA and raises without it; `--device cpu` runs the kernel's plain
torch version or the general tier on the CPU.

`--sharded` renders on the general tier over the ranks of a
torch.distributed group (`parallel/sharding.render_sharded`: NCCL on the
card, gloo on the CPU), every rank on pixel rows as JAX's default mesh
puts every device on dp; under `torchrun --nproc-per-node N` each rank
takes its card, and without torchrun the command is one rank. Rank 0
writes the image and prints. As in JAX it takes neither `--checkpoint` nor
`--engine kernel`, nor `--bvh on`: its general tier scans densely.

As JAX's, `render` appends its request, a fallback to the general tier,
the profiler trace's path, the timers' summary (under `--timers`) and its
result to `--log PATH` (default `log/log.log`; `utils/logger.py`), draws a
progress bar on stderr (`utils/progress.py`; rank 0's under `--sharded`)
unless `--no-progress`, and under `--profile DIR` records the render with
`torch.profiler` (the CPU's activity, and the card's on CUDA) and exports
a Chrome trace into DIR (rank 0's under `--sharded`).

`bench` prints `benchlib.run`'s JSON line: primary rays/s of a preset
(default `cornell_box_baseline`, 800×800×500) through `render_scene`'s
auto engine, and the training step's throughput and gradient check;
`--device cuda` (the default) raises without CUDA, as `render` does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def render_scene(scene, cam, nx: int, ny: int, spp: int, *, engine="auto",
                 device="cuda", seed: int = 0, max_depth: int = 50,
                 rr_depth: int | None = None, checkpoint: str | None = None,
                 timers=None, use_bvh: bool | None = None, progress=None,
                 log=None):
    """Render a scene through the engine the caller names → (image,
    "kernel" or "xla"). "kernel" raises UnsupportedScene for a scene the
    kernel refuses; "xla" runs the general tier; "auto" runs the kernel
    unless its record build refuses the scene, and then the general tier,
    with one line on stderr (and in log, a `utils.logger.Logger`, where
    given). Only UnsupportedScene from the record build changes engines.
    use_bvh: the general tier's `render(use_bvh=)`; progress: either
    engine's progress hook."""
    from .ops import tracer
    from .render import render
    from .utils.timers import Timers

    if engine not in ("auto", "xla", "kernel"):
        raise ValueError(f"unknown engine {engine!r}")
    if timers is None:
        timers = Timers()
    kw = dict(device=device, seed=seed, max_depth=max_depth,
              rr_depth=rr_depth, checkpoint=checkpoint, timers=timers,
              progress=progress)
    if engine != "xla":
        try:
            with timers.phase("record_build"):
                srec = tracer.build_scene_record(scene)
        except tracer.UnsupportedScene as e:
            if engine == "kernel":
                raise
            print(f"auto engine: the kernel refuses the scene ({e}); "
                  "rendering on the general tier", file=sys.stderr)
            if log is not None:
                log.write(f"kernel unsupported ({e}); falling back to xla")
        else:
            return tracer.render_kernel(scene, cam, nx, ny, spp, srec=srec,
                                        **kw), "kernel"
    return render(scene, cam, nx, ny, spp, use_bvh=use_bvh, **kw), "xla"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="raytracing_rust_tpu_torch",
        description="Monte Carlo path tracer on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene preset")
    r.add_argument("--scene", required=True)
    r.add_argument("--nx", type=int, default=None)
    r.add_argument("--ny", type=int, default=None)
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--max-depth", type=int, default=50,
                   help="bounce cap (reference src/color.rs:9)")
    r.add_argument("--rr-depth", type=int, default=None,
                   help="Russian roulette from this bounce on (opt-in, "
                        "unbiased; not in the reference; turns the "
                        "dense-medium walk off)")
    r.add_argument("--out", default=None,
                   help="output path (.ppm or .png); default "
                        "output/<scene>.ppm")
    r.add_argument("--engine", choices=["auto", "xla", "kernel"],
                   default="auto",
                   help="kernel = the hand-written CUDA kernel (its plain "
                        "torch version on --device cpu); xla = the general "
                        "wavefront tier in torch ops (the JAX CLI's name); "
                        "auto = the kernel, falling back to the general "
                        "tier for a scene the kernel refuses")
    r.add_argument("--checkpoint", default=None, metavar="PATH",
                   help=".npz path for a resumable render (either engine)")
    r.add_argument("--bvh", choices=["auto", "on", "off"], default="auto",
                   help="the general tier's closest hits: on = by a BVH "
                        "(reference src/bvh.rs), off = the dense scan, auto "
                        "= the BVH from the device's measured crossover in "
                        "prims on; on renders on the general tier")
    r.add_argument("--sharded", action="store_true",
                   help="shard the general tier's render over the ranks of "
                        "torchrun (or one rank without it)")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    r.add_argument("--timers", action="store_true",
                   help="print per-phase wall times")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="record the render with torch.profiler and write "
                        "its Chrome trace into DIR")
    r.add_argument("--log", default="log/log.log", metavar="PATH")
    r.add_argument("--no-progress", action="store_true")

    sub.add_parser("scenes", help="list scene presets")

    b = sub.add_parser("bench", help="throughput benchmark: one JSON line "
                                     "(benchlib.run)")
    b.add_argument("--scene", default="cornell_box_baseline")
    b.add_argument("--spp", type=int, default=None)
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    args = ap.parse_args(argv)

    from .models.builders import PRESETS

    if args.cmd == "scenes":
        for name, p in PRESETS.items():
            print(f"{name:24s} {p.nx}x{p.ny} spp={p.spp}")
        return 0

    if args.cmd == "bench":
        # the render's validation, before benchlib.run builds anything
        if args.scene not in PRESETS:
            print(f"unknown scene {args.scene!r}; try: "
                  f"{', '.join(PRESETS)}", file=sys.stderr)
            return 2
        if args.spp is not None and args.spp <= 0:
            print(f"--spp must be positive (got {args.spp})",
                  file=sys.stderr)
            return 2
        from . import benchlib
        print(benchlib.to_json(benchlib.run(scene=args.scene, spp=args.spp,
                                            device=args.device)))
        return 0

    if args.scene not in PRESETS:
        print(f"unknown scene {args.scene!r}; try: {', '.join(PRESETS)}",
              file=sys.stderr)
        return 2
    preset = PRESETS[args.scene]
    nx = preset.nx if args.nx is None else args.nx
    ny = preset.ny if args.ny is None else args.ny
    spp = preset.spp if args.spp is None else args.spp
    if min(nx, ny, spp) <= 0:
        print(f"nx/ny/spp must be positive (got {nx}x{ny} spp={spp})",
              file=sys.stderr)
        return 2
    if args.rr_depth is not None and args.rr_depth < 0:
        print(f"--rr-depth must be ≥ 0 (got {args.rr_depth})",
              file=sys.stderr)
        return 2
    if args.sharded and (args.checkpoint or args.engine == "kernel"
                         or args.bvh == "on"):
        print("--sharded takes neither --checkpoint, --engine kernel nor "
              "--bvh on (it is the general tier's dense path)",
              file=sys.stderr)
        return 2
    if args.bvh == "on" and args.engine == "kernel":
        print("--bvh on needs the general tier (--engine xla or auto)",
              file=sys.stderr)
        return 2
    engine = args.engine
    if args.bvh == "on" and engine == "auto":
        print("--bvh on: rendering on the general tier", file=sys.stderr)
        engine = "xla"
    use_bvh = {"auto": None, "on": True, "off": False}[args.bvh]
    preset = type(preset)(**{**preset.__dict__, "nx": nx, "ny": ny})

    import torch

    from .ops.tracer import UnsupportedScene
    from .utils.logger import Logger, LogLevel
    from .utils.progress import ProgressBar
    from .utils.timers import Timers

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs CUDA, and "
                           "torch.cuda.is_available() is false")
    log = Logger(args.log, LogLevel.DEBUG)
    if args.sharded:
        from .parallel import sharding
        with sharding.process_group(args.device) as dev:
            return _render_sharded(args, preset, nx, ny, spp, dev, log)
    log.write(f"render scene={args.scene}")
    if args.bvh == "on" and args.engine == "auto":
        log.write("--bvh requested; using the xla tier")
    timers = Timers()
    with timers.phase("scene_build"):
        scene = preset.build(device=args.device)
        cam = preset.camera(device=args.device)
    progress = None if args.no_progress else ProgressBar(args.scene)
    try:
        with profiled(args.profile, args.scene, args.device, log):
            t0 = time.perf_counter()
            img, engine = render_scene(
                scene, cam, nx, ny, spp, engine=engine, device=args.device,
                seed=args.seed, max_depth=args.max_depth, timers=timers,
                rr_depth=args.rr_depth, checkpoint=args.checkpoint,
                use_bvh=use_bvh, progress=progress, log=log)
            dt = time.perf_counter() - t0
    except UnsupportedScene as e:
        print(f"kernel engine: {e}", file=sys.stderr)
        return 2
    _write(args, img, nx, ny, spp, dt, f"{args.device} ({engine} engine)",
           timers, log)
    return 0


@contextlib.contextmanager
def profiled(trace_dir: str | None, name: str, device, log=None):
    """Record the body with `torch.profiler` (the CPU's activity, and the
    card's where device is CUDA) and export its Chrome trace to
    trace_dir/<name>.trace.json, logged to log; the profiler stops and
    exports in a `finally`, as JAX's CLI stops its trace. No trace_dir: the
    body runs as it is."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{name}.trace.json")
        prof.export_chrome_trace(path)
        if log is not None:
            log.write(f"profiler trace -> {path}")


def _render_sharded(args, preset, nx: int, ny: int, spp: int, dev,
                    log) -> int:
    """`render --sharded` on this rank's device: `render_sharded` over every
    rank on dp; rank 0 logs, draws the bar, profiles, writes and prints."""
    from .parallel import sharding
    from .utils.progress import ProgressBar
    from .utils.timers import Timers

    timers = Timers()
    mesh = sharding.make_mesh()
    rank0 = mesh.rank == 0
    if rank0:
        log.write(f"render scene={args.scene}")
    with timers.phase("scene_build"):
        scene = preset.build(device=dev)
        cam = preset.camera(device=dev)
    progress = (ProgressBar(args.scene) if rank0 and not args.no_progress
                else None)
    with profiled(args.profile if rank0 else None, args.scene, dev, log):
        t0 = time.perf_counter()
        img = sharding.render_sharded(
            scene, cam, nx, ny, spp, mesh, device=dev, seed=args.seed,
            max_depth=args.max_depth, rr_depth=args.rr_depth, timers=timers,
            progress=progress)
        dt = time.perf_counter() - t0
    if rank0:
        import torch.distributed as dist
        _write(args, img, nx, ny, spp, dt,
               f"{args.device} (xla engine, sharded over dp={mesh.dp} "
               f"sp={mesh.sp} ranks, {dist.get_backend()})", timers, log)
    return 0


def _write(args, img, nx: int, ny: int, spp: int, dt: float, where: str,
           timers, log) -> None:
    """Encode img at --out (default output/<scene>.ppm), print the summary
    line and, under --timers, the timers; log the timers' summary and the
    result as JAX's CLI does."""
    from .utils import image_io

    out = args.out or os.path.join("output", f"{args.scene}.ppm")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with timers.phase("encode"):
        if out.endswith(".png"):
            image_io.write_png(out, img)
        else:
            image_io.write_ppm(out, img)

    rays = nx * ny * spp
    print(f"{args.scene}: {nx}x{ny} spp={spp} on {where} in {dt:.3f}s "
          f"({rays / dt / 1e6:.2f}M primary rays/s) -> {out}")
    if args.timers:
        print(timers.report())
        log.write(f"timers: {timers.summary()}")
    log.write(f"rendered {args.scene} in {dt:.1f}s -> {out}")


if __name__ == "__main__":
    sys.exit(main())
