"""The alive fraction per bounce of the general tier's wavefront.

Counterpart of `tools/alive_profile.py`, the measurement behind the
general tier's compaction (`render._COMPACT_SCHEDULE`): n camera lanes of
a preset at uniformly drawn pixels go through `ops/integrator._bounce` at
full width, and before each bounce the share of lanes still alive is
taken, until none is or the depth cap ends the walk. From it: the bounces
run, the mean path (Σ of the shares: the bounces a lane runs on average),
the waste of full width (bounces run over the mean path) and the shares at
bounces 10 and 20. A path-statistics probe, not a timing one: it runs on
either device, and the draws (Philox keyed by lane, numpy's pixels) differ
from JAX's, so the two agree within Monte Carlo error.

    python -m raytracing_rust_tpu_torch.alive_profile [SCENE ...]
        [--n 16384] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

DEFAULT_SCENES = ("cornell_box", "final_scene", "two_spheres",
                  "cornell_smoke")


def profile(name: str, n: int = 16384, max_depth: int = 50, seed: int = 0,
            device="cuda") -> dict:
    """{scene, bounces_run, mean_path, waste, alive: f64[bounces_run]} of
    n lanes of preset `name` at its own size: lane k's pixel is numpy's
    default_rng(seed) draw k, its camera ray `render.camera_lane_rays`
    under seed, its bounce b's draws `integrator.lane_draws` keyed by
    (lane, 0, b) under seed. device: "cuda" (the default; raises without
    CUDA) or "cpu"."""
    from .inverse_render import _check_device
    from .models.builders import PRESETS
    from .ops.integrator import _bounce, lane_draws
    from .ops.intersect import plan_pack
    from .render import camera_lane_rays

    device = _check_device(device)
    preset = PRESETS[name]
    scene = preset.build(device=device)
    cam = preset.camera(device=device)
    pid = torch.from_numpy(np.random.default_rng(seed).integers(
        0, preset.nx * preset.ny, n)).to(device)
    lane = torch.arange(n, dtype=torch.int64, device=device)
    o, d, time = camera_lane_rays(cam, pid, seed, preset.nx, preset.ny)
    pack = plan_pack(scene)
    thr = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    fracs = []
    for b in range(max_depth + 1):
        fracs.append(float(alive.double().mean()))
        u = lane_draws(scene, seed, lane, torch.zeros_like(lane), b, False)
        o, d, thr, rad, alive = _bounce(scene, pack, u, max_depth, b, o, d,
                                        time, thr, rad, alive)
        if not bool(alive.any()):
            break
    fr = np.asarray(fracs)
    return {"scene": name, "bounces_run": len(fr),
            "mean_path": float(fr.sum()),
            "waste": len(fr) / float(fr.sum()),
            "alive": fr}


def line(r: dict) -> str:
    """JAX's line of one profile."""
    fr = r["alive"]
    a10 = fr[10] if len(fr) > 10 else 0.0
    a20 = fr[20] if len(fr) > 20 else 0.0
    return (f"{r['scene']:20s} bounces_run={r['bounces_run']:3d} "
            f"mean_path={r['mean_path']:5.2f} "
            f"full/mean={r['waste']:4.1f}x "
            f"alive@10={a10:.4f} alive@20={a20:.5f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.alive_profile",
        description="alive fraction per bounce of the general tier")
    ap.add_argument("scenes", nargs="*", default=list(DEFAULT_SCENES))
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    for name in args.scenes:
        print(line(profile(name, args.n, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
