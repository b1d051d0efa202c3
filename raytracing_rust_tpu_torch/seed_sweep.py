"""The default inverse render's spread over seeds, on each differentiable
tier.

`inverse_render.train` at its default size (200×200, block 4,096 × 64 spp,
depth 6, 40 steps) under seeds 0 … n−1, on the fused tier and on the
general tier (`--no-fast`), each seed's pixel blocks, rays and draws the
same on both tiers. Prints and writes, per tier, each seed's recovered
albedo error (max abs, the trainer's criterion) and emission error, and
their means with standard errors (sample standard deviation / √n).

    python -m raytracing_rust_tpu_torch.seed_sweep [--seeds 10]
        [--device cuda|cpu] [--out chiprun_out/seed_sweep.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from . import inverse_render as ir
from .kernel_stats import smi


def mean_sem(xs) -> tuple[float, float]:
    """(mean, standard error of the mean) of xs (n ≥ 2)."""
    xs = np.asarray(xs, np.float64)
    return float(xs.mean()), float(xs.std(ddof=1) / math.sqrt(len(xs)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.seed_sweep",
        description="the default inverse render over seeds on the fused "
                    "and the general tier")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None, help="JSON path")
    args = ap.parse_args(argv)
    if args.seeds < 2:
        ap.error("--seeds must be ≥ 2 for a standard error")
    card = (smi("name,power.limit") if args.device == "cuda"
            and torch.cuda.is_available() else args.device)
    out = dict(card=card, tiers={})
    print(out["card"], flush=True)
    for tier, fast in (("fused", True), ("general", False)):
        rows = []
        for seed in range(args.seeds):
            t = time.perf_counter()
            res = ir.train(seed=seed, fast=fast, device=args.device,
                           log=lambda *a: None)
            rows.append(dict(
                seed=seed, albedo=res["albedo"].tolist(), emit=res["emit"],
                albedo_err=float(np.abs(res["albedo"] - np.asarray(
                    ir.TRUE_ALBEDO)).max()),
                emit_err=abs(res["emit"] - ir.TRUE_EMIT),
                seconds=time.perf_counter() - t,
                median_step_seconds=float(np.median(res["step_walls"][1:]))
                if len(res["step_walls"]) > 1 else None))
            print(json.dumps({"tier": tier, **rows[-1]}), flush=True)
        a_mean, a_sem = mean_sem([r["albedo_err"] for r in rows])
        e_mean, e_sem = mean_sem([r["emit_err"] for r in rows])
        out["tiers"][tier] = dict(
            runs=rows, albedo_err_mean=a_mean, albedo_err_sem=a_sem,
            emit_err_mean=e_mean, emit_err_sem=e_sem,
            passed=sum(r["albedo_err"] < 0.1 and r["emit_err"] < 0.5
                       for r in rows))
        print(f"{tier}: albedo err {a_mean:.4f} ± {a_sem:.4f}, emission err "
              f"{e_mean:.4f} ± {e_sem:.4f} over {args.seeds} seeds "
              f"({out['tiers'][tier]['passed']} within the criterion)",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
