"""Render the gallery: the eight reference scenes through K1, as PNG.

Counterpart of `tools/make_gallery.py`: each scene at gallery size (16:9
scenes at 416×234, square ones at 360×360) and a sample count high enough
for a converged image, through `ops/tracer.render_kernel` (its plain
torch version on the CPU) at depth 50, seed 0, written as
OUTDIR/<scene>.png. JAX's final_scene renders in 500-sample calls to stay
under the TPU runtime's watchdog; `render_kernel` splits every render by
its own lane budget, so no config names a chunk here.

    python -m raytracing_rust_tpu_torch.make_gallery [OUTDIR]
        [--device cuda|cpu]

OUTDIR defaults to output/gallery (the JAX package's images in
docs/gallery are its own).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# (scene, nx, ny, spp), tools/make_gallery.py's
CONFIGS = [
    ("random_spheres", 416, 234, 1000),
    ("two_spheres", 416, 234, 1000),
    ("two_perlin_spheres", 416, 234, 1000),
    ("earth", 416, 234, 1000),
    ("simple_light", 416, 234, 2000),
    ("cornell_box", 360, 360, 4000),
    ("cornell_smoke", 360, 360, 4000),
    ("final_scene", 360, 360, 1500),
]
DEFAULT_OUTDIR = os.path.join("output", "gallery")


def main(argv=None) -> int:
    from .inverse_render import _check_device
    from .models.builders import PRESETS
    from .ops.tracer import render_kernel
    from .utils import image_io

    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.make_gallery",
        description="render the eight reference scenes through K1 as PNG")
    ap.add_argument("outdir", nargs="?", default=DEFAULT_OUTDIR)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = _check_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    rows = []
    for name, nx, ny, spp in CONFIGS:
        p = dataclasses.replace(PRESETS[name], nx=nx, ny=ny)
        scene, cam = p.build(device=device), p.camera(device=device)
        t0 = time.perf_counter()
        img = render_kernel(scene, cam, nx, ny, spp, device=device, seed=0)
        dt = time.perf_counter() - t0
        path = os.path.join(args.outdir, f"{name}.png")
        image_io.write_png(path, img)
        rows.append(dict(scene=name, nx=nx, ny=ny, spp=spp, seconds=dt,
                         mean=float(img.mean()), path=path))
        print(f"{name}: {nx}x{ny}x{spp} in {dt:.3f}s -> {path}", flush=True)
    print(json.dumps({"device": args.device, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
