"""K1's throughput on each reference scene at the reference's own size.

Counterpart of `tools/bench_scenes.py`: the eight (scene, nx, ny, spp)
configs that the reference's tests hard-code (BASELINE.md; reference
tests/test.rs), each rendered through K1 (`ops/tracer.render_kernel`, its
plain torch version on the CPU) at depth 50 (src/color.rs:9): one warm
render at min(spp, 8) samples, so that on a scene with a dynamic table the
cost-balanced path engages and caches its pixel table as the timed renders
use it (the cache is keyed by scene, camera, size and depth), then the
best of 3 timed renders, each from a synchronized device to its finalized
image. One line a scene: seconds and primary rays/s (nx·ny·spp over the
best), then one JSON object with the rows.

    python -m raytracing_rust_tpu_torch.bench_scenes [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .benchlib import sync
from .inverse_render import _check_device

# (scene, nx, ny, spp): the reference's test configs (tests/test.rs)
CONFIGS = [
    ("cornell_box", 800, 800, 100),
    ("cornell_smoke", 800, 800, 100),
    ("final_scene", 800, 800, 100),
    ("random_spheres", 1280, 720, 100),
    ("simple_light", 1280, 720, 100),
    ("earth", 1280, 720, 10),
    ("two_perlin_spheres", 1280, 720, 10),
    ("two_spheres", 1280, 720, 10),
]
MAX_DEPTH = 50
REPS = 3


def bench(name: str, nx: int, ny: int, spp: int, device,
          reps: int = REPS) -> dict:
    """One config's row: {scene, nx, ny, spp, seconds (best of reps),
    seconds_all_reps, primary_rays_per_s}."""
    import dataclasses

    from .models.builders import PRESETS
    from .ops import tracer

    p = dataclasses.replace(PRESETS[name], nx=nx, ny=ny)
    scene, cam = p.build(device=device), p.camera(device=device)
    kw = dict(device=device, max_depth=MAX_DEPTH)
    tracer.render_kernel(scene, cam, nx, ny, min(spp, 8), seed=9, **kw)
    walls = []
    for r in range(reps):
        sync(device)
        t0 = time.perf_counter()
        tracer.render_kernel(scene, cam, nx, ny, spp, seed=r, **kw)
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    return dict(scene=name, nx=nx, ny=ny, spp=spp, seconds=best,
                seconds_all_reps=walls,
                primary_rays_per_s=nx * ny * spp / best)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.bench_scenes",
        description="K1's primary rays/s on the eight reference configs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = _check_device(args.device)
    rows = []
    for name, nx, ny, spp in CONFIGS:
        row = bench(name, nx, ny, spp, device)
        rows.append(row)
        print(f"{name}: {nx}x{ny}x{spp} best {row['seconds']:.4f}s = "
              f"{row['primary_rays_per_s'] / 1e6:.2f}M rays/s", flush=True)
    print(json.dumps({"device": args.device, "depth": MAX_DEPTH,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
