"""How the sharded block render divides its work over ranks.

Counterpart of `bench_scaling.py` (the JAX package's, at the repository
root): `parallel/sharding.render_block_sharded` of cornell_box (4,096
pixels × 8 spp, depth 8, the preset's camera) over 1, 2 and 4 gloo ranks on
the CPU, each rank a process (`parallel/multihost_worker.launch`, one torch
thread a rank), every rank on dp. JAX reads each device's FLOPs from XLA's
cost analysis; here each rank counts the lanes it traced (its pixel rows ×
its samples), so the work share of the busiest rank against 1/N says
whether the split replicates work, and the wall speedup (the best of
--reps calls after a warm one, timed by rank 0 from a barrier to the
block's sums, which the ranks' all-reduce makes whole on every rank) says
what the host's cores give. One JSON line a rank count, with whether the
block's sums equal one rank's bit for bit, then a summary. It gives no card
number: the ranks run on the CPU.

    python -m raytracing_rust_tpu_torch.bench_scaling [--ranks 1 2 4]
        [--pixels 4096] [--spp 8] [--depth 8] [--reps 3]

JAX's `--split2` (two dispatches of its Pallas kernel on one TPU) has no
counterpart: the port's sharded path runs the general tier.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

SCENE = "cornell_box"
SEED = 0


def rank_main(out: str, n_pix: int, spp: int, depth: int, reps: int) -> int:
    """One rank: the warm call and `reps` timed calls of the block render on
    the CPU over every rank on dp; rank 0 writes {ranks, lanes (by rank),
    seconds (best), seconds_all_reps} to out and the block's sums to
    out + ".npy"."""
    import torch.distributed as dist

    from .models.builders import PRESETS
    from .parallel import sharding

    with sharding.process_group("cpu") as dev:
        mesh = sharding.make_mesh()
        p = PRESETS[SCENE]
        scene, cam = p.build(device=dev), p.camera(device=dev)
        pix = torch.arange(n_pix, dtype=torch.int64, device=dev)

        def block():
            return sharding.render_block_sharded(
                scene, cam, pix, SEED, p.nx, p.ny, spp, depth, mesh)

        sums = block()
        walls = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            block()
            walls.append(time.perf_counter() - t0)
        lo, hi = mesh.rows(n_pix)
        s0, s1 = mesh.samples(spp)
        lanes = [None] * mesh.size
        dist.all_gather_object(lanes, (hi - lo) * (s1 - s0))
        if mesh.rank == 0:
            np.save(out + ".npy", sums.numpy())
            with open(out, "w") as fh:
                json.dump(dict(ranks=mesh.size, lanes=lanes,
                               seconds=min(walls), seconds_all_reps=walls),
                          fh)
    return 0


def run_ranks(n: int, *, n_pix: int = 4096, spp: int = 8, depth: int = 8,
              reps: int = 3, timeout: float = 600.0) -> dict:
    """`rank_main` in n gloo ranks → rank 0's record with the block's sums
    under "sums" (f32[n_pix, 3]). Raises if a rank fails."""
    from .parallel.multihost_worker import launch

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scaling.json")
        runs = launch(n, ["-m", "raytracing_rust_tpu_torch.bench_scaling",
                          "--rank-out", out, "--pixels",
                          str(n_pix), "--spp", str(spp), "--depth",
                          str(depth), "--reps", str(reps)], timeout=timeout)
        for r, (rc, text) in enumerate(runs):
            if rc != 0:
                raise RuntimeError(f"rank {r} of {n} exited {rc}:\n"
                                   f"{text[-3000:]}")
        with open(out) as fh:
            res = json.load(fh)
        res["sums"] = np.load(out + ".npy")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.bench_scaling",
        description="the sharded block render over 1, 2 and 4 gloo ranks "
                    "on the CPU: work share per rank and wall speedup")
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--pixels", type=int, default=4096)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_out:
        return rank_main(args.rank_out, args.pixels, args.spp, args.depth,
                         args.reps)
    rays = args.pixels * args.spp
    res, share, speedup = {}, {}, {}
    for n in args.ranks:
        res[n] = run_ranks(n, n_pix=args.pixels, spp=args.spp,
                           depth=args.depth, reps=args.reps)
        lanes = res[n]["lanes"]
        share[n] = max(lanes) / sum(lanes)
        speedup[n] = res[args.ranks[0]]["seconds"] / res[n]["seconds"]
        print(json.dumps({
            "ranks": n, "rays_per_sec": rays / res[n]["seconds"],
            "lanes_per_rank": lanes, "work_share": share[n],
            "ideal_share": 1 / n, "wall_speedup": speedup[n],
            "bit_equal_to_first": bool(np.array_equal(
                res[n]["sums"], res[args.ranks[0]]["sums"]))}), flush=True)
    print(json.dumps({
        "metric": f"sharded block render over gloo ranks on the CPU "
                  f"({SCENE}, {args.pixels} pixels x {args.spp} spp, depth "
                  f"{args.depth}; lanes traced per rank vs ideal 1/N)",
        "partition_efficiency": {str(n): (1 / n) / share[n]
                                 for n in args.ranks},
        "wall_speedup": {str(n): speedup[n] for n in args.ranks},
        "cpu_cores": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    from .parallel.multihost_worker import finish
    finish(main())
