"""Large scenes: the general tier's dense scan against its BVH, and K1,
across prim counts.

Counterpart of `tools/bench_large.py`. For each n of --n it renders
`big_spheres(n)` through `big_spheres_camera` at 64×36, 4 spp, depth 8
(the defaults) through the dense general tier, the BVH general tier and,
on the card, K1 (`ops/tracer.render_kernel`), and prints each one's
primary rays/s over the render's wall (nx·ny·spp / seconds, the best of
--reps after a warm-up call, the card synchronized before the clock
starts and after it stops), the BVH's `bvh_build` seconds and each image's
mean, then the crossover: the smallest prim count from which the BVH beats
the dense scan at every larger size too (None when it never does). The
last line is one JSON object with the rows. `render.auto_use_bvh` takes
its per-device threshold from this table.

    python -m raytracing_rust_tpu_torch.bench_large [--n 1000 3000 ...]
        [--device cuda|cpu] [--reps 2]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

DEFAULT_N = (1000, 3000, 10000, 30000, 100000)


def crossover(rows: list[dict]) -> int | None:
    """The prim count of the first row from which the BVH's rays/s beat the
    dense scan's in that row and in every later one (rows in ascending
    prims), or None."""
    at = None
    for row in rows:
        if row["bvh_rays_per_s"] <= row["dense_rays_per_s"]:
            at = None
        elif at is None:
            at = row["prims"]
    return at


def run(ns=DEFAULT_N, *, nx: int = 64, ny: int = 36, spp: int = 4,
        depth: int = 8, reps: int = 2, device="cuda", log=print) -> dict:
    """The table: one row a scene size (prims, each engine's rays/s and
    image mean, the BVH's build seconds) and the crossover."""
    from .models.builders import big_spheres, big_spheres_camera
    from .ops import tracer
    from .render import render
    from .utils.timers import Timers

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but "
                           "torch.cuda.is_available() is false")
    rays = nx * ny * spp

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        fn()  # warm: the first use of each op, K1's build
        best, img, tm = float("inf"), None, None
        for _ in range(reps):
            t_m = Timers()
            sync()
            t = time.perf_counter()
            img = fn(t_m)
            sync()
            dt = time.perf_counter() - t
            if dt < best:
                best, tm = dt, t_m
        return rays / best, float(np.asarray(img).mean()), tm

    rows = []
    for n in ns:
        scene = big_spheres(n, device=dev)
        cam = big_spheres_camera(n, nx, ny, device=dev)
        kw = dict(device=dev, max_depth=depth)
        row = dict(n=n, prims=scene.num_prims, k1_rays_per_s=None,
                   k1_mean=None)
        row["dense_rays_per_s"], row["dense_mean"], _ = timed(
            lambda tm=None: render(scene, cam, nx, ny, spp, use_bvh=False,
                                   timers=tm, **kw))
        row["bvh_rays_per_s"], row["bvh_mean"], tm = timed(
            lambda tm=None: render(scene, cam, nx, ny, spp, use_bvh=True,
                                   timers=tm, **kw))
        row["bvh_build_seconds"] = tm.summary().get("bvh_build")
        if dev.type == "cuda":
            try:
                row["k1_rays_per_s"], row["k1_mean"], _ = timed(
                    lambda tm=None: tracer.render_kernel(
                        scene, cam, nx, ny, spp, timers=tm, **kw))
            except tracer.UnsupportedScene as e:
                row["k1_refused"] = str(e)
        rows.append(row)

        def f(k):
            return "—" if row[k] is None else f"{row[k]:.0f}"
        log(f"{row['prims']:>8} {f('dense_rays_per_s'):>14} "
            f"{f('bvh_rays_per_s'):>14} {f('k1_rays_per_s'):>14} "
            f"{row['bvh_build_seconds']:>10.4f}")
    return dict(device=str(dev), config=dict(nx=nx, ny=ny, spp=spp,
                                             depth=depth, reps=reps),
                rows=rows, crossover=crossover(rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.bench_large",
        description="dense scan vs BVH vs K1 over big_spheres(n)")
    ap.add_argument("--n", type=int, nargs="+", default=list(DEFAULT_N))
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=36)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from .kernel_stats import smi
    card = (smi("name,power.limit") if args.device == "cuda"
            and torch.cuda.is_available() else "cpu")
    print(f"{card}: big_spheres at {args.nx}x{args.ny} spp {args.spp} depth "
          f"{args.depth}, primary rays/s (best of {args.reps})", flush=True)
    print(f"{'prims':>8} {'dense':>14} {'bvh':>14} {'k1':>14} "
          f"{'bvh_build s':>10}", flush=True)
    out = run(sorted(args.n), nx=args.nx, ny=args.ny, spp=args.spp,
              depth=args.depth, reps=args.reps, device=args.device,
              log=lambda s: print(s, flush=True))
    out["card"] = card
    print(f"crossover: {out['crossover']} prims", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
