"""Command-line entry point: `python -m raytracing_rust_tpu_torch`.

Counterpart of `raytracing_rust_tpu/cli.py` for what the port covers:
`scenes` lists the presets; `render` renders one through the K1 kernel
(`--engine kernel`, the only engine so far), with Russian roulette from
bounce N on under `--rr-depth N`. Every scene the JAX kernel takes renders;
the ones it refuses too (an image on a rotated sphere, a nested checker,
an image that is not 8-bit exact, more than 8 media, more than 96 rects
that form no box beside more prims) exit 2 with the reason: there is no
other engine to fall back on. `--device cuda` (the default) needs CUDA and
raises without it; `--device cpu` runs the kernel's plain torch version.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


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
    r.add_argument("--engine", choices=["kernel"], default="kernel",
                   help="kernel = the hand-written CUDA kernel (its plain "
                        "torch version on --device cpu)")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    r.add_argument("--timers", action="store_true",
                   help="print per-phase wall times")

    sub.add_parser("scenes", help="list scene presets")

    args = ap.parse_args(argv)

    from .models.builders import PRESETS

    if args.cmd == "scenes":
        for name, p in PRESETS.items():
            print(f"{name:24s} {p.nx}x{p.ny} spp={p.spp}")
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
    preset = type(preset)(**{**preset.__dict__, "nx": nx, "ny": ny})

    import torch

    from .ops.tracer import UnsupportedScene, render_kernel
    from .utils import image_io
    from .utils.timers import Timers

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs CUDA, and "
                           "torch.cuda.is_available() is false")
    timers = Timers()
    with timers.phase("scene_build"):
        scene = preset.build(device=args.device)
        cam = preset.camera(device=args.device)
    t0 = time.perf_counter()
    try:
        img = render_kernel(scene, cam, nx, ny, spp, device=args.device,
                            seed=args.seed, max_depth=args.max_depth,
                            timers=timers, rr_depth=args.rr_depth)
    except UnsupportedScene as e:
        print(f"kernel engine: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0

    out = args.out or os.path.join("output", f"{args.scene}.ppm")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with timers.phase("encode"):
        if out.endswith(".png"):
            image_io.write_png(out, img)
        else:
            image_io.write_ppm(out, img)

    rays = nx * ny * spp
    print(f"{args.scene}: {nx}x{ny} spp={spp} on {args.device} in {dt:.3f}s "
          f"({rays / dt / 1e6:.2f}M primary rays/s) -> {out}")
    if args.timers:
        print(timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
