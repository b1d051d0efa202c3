"""K1's path-length counters, its operation rate, and the card's f32 peak.

    python -m raytracing_rust_tpu_torch.kernel_stats [scene ...] [--balance]
        [--mfu] [--peak] [--nx N] [--ny N] [--spp N] [--max-depth N]
        [--device cuda|cpu]

The counterpart of tools/kernel_stats.py. With scene names (default
final_scene and random_spheres) it renders each preset once with K1f's
stats launch (`run`) and prints, from its counters: steps per sample (a
warp's threads each walk their own list of pixels and samples, one segment
or walk bounce an iteration, so a warp runs until its busiest thread is
done: its steps, its iterations, are the largest segment total among its 32
threads, over their banks and samples, walk bounces counted), the
occupancy (segments over 32 × warp steps: the share of a
warp's thread-steps that trace; the rest is the tail), the segments per
sample, and the dynamic sphere and box member tests per segment (the box
layout beside them: a grid's strip pass, or generic leaves). On a scene
with boxes the launch also fills K1f's
DDA row (tools/kernel_stats.py's dda probe): of the box member tests the
leaf cull lets through, those whose AABB the ray crosses inside its live
window, the visit set of a per-ray grid DDA; it prints their rate per
segment and the share of box tests such a gate could skip. --balance
renders from the cost-balanced pixel table, as the default render of such
a scene does. --device cpu runs the kernel's plain version, which fills the
same counters (small sizes only).

--mfu (`mfu`) times a clean render on the card and divides the operations
its paths needed (the plain version's counts at a few samples, scaled, times
ops/tracer.py K1_OPS) by its time, against D3's measured add rate and the
card's theoretical f32 issue rates. --peak (`peak_sweep`) sweeps D3 over
accumulator counts and grid sizes and prints the add and FMA rates beside
the theoretical ones. Both need a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from .models.builders import PRESETS
from .ops import peak, tracer


def smi(query: str) -> str:
    """One field of `nvidia-smi --query-gpu` for card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def _mhz(query: str) -> float:
    return float(smi(query).split()[0])


def _operands(name, nx, ny, max_depth, balance, device):
    """The preset's operands on device, and its pixel table (kpix 1) when
    balance (the render's own probe and table), else None."""
    preset = PRESETS[name]
    ops = tracer.trace_operands(
        tracer.build_scene_record(preset.build()),
        tracer.build_camera_record(preset.camera()), device)
    pix = (tracer.render_table(ops, nx, ny, max_depth, device) if balance
           else None)
    return ops, pix


def summarize(stats: torch.Tensor, n_pix: int, spp: int,
              kpix: int = 1, dda: bool = False) -> dict:
    """The counters of a stats buffer → steps per sample (a warp's steps
    over spp · kpix, the mean over warps that hold a pixel), segments per
    sample, occupancy, tail share,
    member tests per segment, and the totals; with dda (a buffer with the
    DDA row) the box tests whose AABB the ray crosses, per segment, and the
    share of box tests a per-ray gate could skip (1 − crossings / box
    tests)."""
    busy, sph, box, steps = (x.double() for x in
                             tracer.stats_rows(stats, n_pix, dda))
    held = steps[steps > 0]
    seg, warp_steps = float(busy.sum()), float(steps.sum())
    occ = seg / (tracer.WARP * warp_steps) if warp_steps else 0.0
    return dict(segments=int(seg), warp_steps=int(warp_steps),
                warps=int(held.numel()),
                steps_per_sample=float(held.mean()) / (spp * kpix)
                if held.numel() else 0.0,
                segments_per_sample=seg / (n_pix * spp),
                occupancy=occ, tail_share=1.0 - occ,
                sphere_tests=int(sph.sum()), box_tests=int(box.sum()),
                sphere_tests_per_segment=float(sph.sum()) / max(seg, 1.0),
                box_tests_per_segment=float(box.sum()) / max(seg, 1.0),
                **(_dda(stats, n_pix, float(box.sum()), seg) if dda else {}))


def _dda(stats: torch.Tensor, n_pix: int, box_tests: float,
         seg: float) -> dict:
    cross = float(tracer.dda_row(stats, n_pix).double().sum())
    return dict(dda_crossings=int(cross),
                dda_cross_per_segment=cross / max(seg, 1.0),
                dda_skip_share=1.0 - cross / box_tests if box_tests else 0.0)


def run(name: str, nx: int = 400, ny: int = 400, spp: int = 32,
        max_depth: int = 50, balance: bool = False, device="cuda") -> dict:
    """One stats launch of the preset `name` (its camera at nx×ny), on the
    cost-balanced table under balance, with the DDA row when the scene has
    boxes; prints and returns `summarize`'s figures with the scene's
    sizes."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but "
                           "torch.cuda.is_available() is false")
    n_pix = nx * ny
    ops, pix = _operands(name, nx, ny, max_depth, balance, device)
    dda = ops.box.shape[0] > 0
    stats = tracer.new_stats(nx, ny, device, pix, dda=dda)
    tracer.trace(ops, torch.zeros((3, n_pix), dtype=torch.float64,
                                  device=device),
                 nx=nx, ny=ny, seed=7, sample0=0, n_samples=spp,
                 max_depth=max_depth, pix=pix, stats=stats, dda=dda)
    out = dict(name=name, nx=nx, ny=ny, spp=spp, max_depth=max_depth,
               balance=bool(balance), device=str(device),
               n_dyn=int(ops.dyn.shape[0]), n_box=int(ops.box.shape[0]),
               box_grid=list(ops.grid[:2]) if ops.grid else None,
               **summarize(stats, n_pix, spp, dda=dda))
    print(f"{name}{' [balanced]' if balance else ''}: "
          f"{nx}x{ny} spp={spp} depth={max_depth} on {device}; "
          f"n_dyn={out['n_dyn']} n_box={out['n_box']}")
    print(f"  steps/sample {out['steps_per_sample']:.2f} over "
          f"{out['warps']} warps; segments/sample "
          f"{out['segments_per_sample']:.2f}")
    print(f"  occupancy {100 * out['occupancy']:.1f}% (segments / 32 warp "
          f"steps); tail {100 * out['tail_share']:.1f}%")
    if out["n_dyn"]:
        print(f"  sphere member tests/segment "
              f"{out['sphere_tests_per_segment']:.1f} of {out['n_dyn']}")
    if out["n_box"]:
        layout = ("the strip pass over a {}×{} grid".format(*out["box_grid"])
                  if out["box_grid"] else "generic leaves")
        print(f"  box member tests/segment "
              f"{out['box_tests_per_segment']:.2f} of {out['n_box']} "
              f"({layout})")
        print(f"  box tests whose AABB the ray crosses: "
              f"{out['dda_cross_per_segment']:.2f}/segment → a per-ray gate "
              f"could skip {100 * out['dda_skip_share']:.1f}%")
    return out


def theoretical_fp32() -> dict:
    """The card's theoretical f32 issue rates: SMs × 128 f32 lanes × the SM
    clock nvidia-smi reports as the maximum, one add or one FMA (two
    operations) a lane a clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = _mhz("clocks.max.sm")
    adds = sms * 128 * mhz * 1e6
    return dict(sms=sms, max_sm_mhz=mhz, add_ops_per_s=adds,
                fma_ops_per_s=2 * adds)


def peak_sweep() -> dict:
    """D3 over accumulator counts k and grid sizes (blocks of 256 threads, 1
    to 8 a streaming multiprocessor), the add chain; then the FMA chain at
    the best (k, grid); with the SM clock read after each measurement."""
    if not torch.cuda.is_available():
        raise RuntimeError("--peak measures the card: "
                           "torch.cuda.is_available() is false")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep = []
    for k in (4, 8, 16, 32):
        for per_sm in (1, 2, 4, 8):
            r = peak.fp32_peak(k=k, blocks=per_sm * sms)
            r["sm_mhz"] = _mhz("clocks.sm")
            sweep.append(r)
            print(f"  k={k:3d} blocks={r['blocks']:5d}x{r['threads']}: "
                  f"{r['ops_per_s'] / 1e12:.2f} T f32 adds/s at "
                  f"{r['sm_mhz']:.0f} MHz")
    best = max(sweep, key=lambda r: r["ops_per_s"])
    fma = peak.fp32_peak(k=best["k"], fma=True, blocks=best["blocks"])
    fma["sm_mhz"] = _mhz("clocks.sm")
    th = theoretical_fp32()
    print(f"f32 peak: adds {best['ops_per_s'] / 1e12:.2f} T/s (k={best['k']}, "
          f"{best['blocks']} blocks), FMA {fma['ops_per_s'] / 1e12:.2f} T "
          f"operations/s (an FMA as two) at {fma['sm_mhz']:.0f} MHz; "
          f"theoretical {th['add_ops_per_s'] / 1e12:.2f} T adds/s, "
          f"{th['fma_ops_per_s'] / 1e12:.2f} T FMA operations/s "
          f"({th['sms']} SMs × 128 × {th['max_sm_mhz']:.0f} MHz)")
    return dict(sweep=sweep, add=best, fma=fma, theoretical=th)


def mfu(name: str, nx: int = 800, ny: int = 800, spp: int = 32,
        max_depth: int = 50, balance: bool | None = None,
        peak_adds: float | None = None, count_spp: int = 2) -> dict:
    """K1's achieved f32 operation rate on the preset `name`: the operations
    its paths need (`tracer.k1_work` on the plain version's counts at
    count_spp samples, scaled to spp) over the kernel's time for spp
    samples (CUDA events, the best of three), against D3's measured add
    rate (peak_adds, else measured here) and the theoretical rates."""
    if not torch.cuda.is_available():
        raise RuntimeError("--mfu measures the card: "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    if balance is None:
        balance = name in ("final_scene", "random_spheres")
    stats = run(name, nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                balance=balance, device=dev)
    ops, pix = _operands(name, nx, ny, max_depth, balance, dev)
    n_pix = nx * ny
    sums = torch.zeros((3, n_pix), dtype=torch.float64, device=dev)
    kw = dict(nx=nx, ny=ny, seed=7, sample0=0, max_depth=max_depth)
    counts = {}
    tracer.trace_plain(ops, sums, n_samples=count_spp, counts=counts, **kw)
    n_ops, _ = tracer.k1_work(ops, counts, n_pix, count_spp)
    n_ops *= spp / count_spp
    best = float("inf")
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        tracer.trace(ops, sums.zero_(), n_samples=spp, pix=pix, **kw)
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) * 1e-3)
    if peak_adds is None:
        peak_adds = peak.fp32_peak()["ops_per_s"]
    th = theoretical_fp32()
    achieved = n_ops / best
    out = dict(name=name, nx=nx, ny=ny, spp=spp, balance=bool(balance),
               kernel_s=best, rays_per_s=n_pix * spp / best,
               operations=n_ops, achieved_ops_per_s=achieved,
               measured_add_peak=peak_adds, theoretical=th,
               of_measured_add_peak=achieved / peak_adds,
               of_theoretical_adds=achieved / th["add_ops_per_s"],
               of_published_67t=achieved / 67e12,
               occupancy=stats["occupancy"])
    print(f"\n{name} @ {nx}x{ny} spp {spp} depth {max_depth} "
          f"(balance={balance}): kernel {best:.4f} s = "
          f"{out['rays_per_s'] / 1e6:.1f}M rays/s")
    print(f"  {n_ops:.3e} operations (K1_OPS on {count_spp}-spp counts, "
          f"scaled) -> {achieved / 1e12:.2f} T/s: "
          f"{100 * out['of_measured_add_peak']:.1f}% of D3's add rate "
          f"({peak_adds / 1e12:.2f} T/s), "
          f"{100 * out['of_theoretical_adds']:.1f}% of the theoretical "
          f"adds, {100 * out['of_published_67t']:.1f}% of 67 TFLOP/s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracing_rust_tpu_torch.kernel_stats")
    ap.add_argument("scenes", nargs="*")
    ap.add_argument("--balance", action="store_true",
                    help="render from the cost-balanced pixel table")
    ap.add_argument("--mfu", action="store_true",
                    help="K1's operation rate against the f32 peaks")
    ap.add_argument("--peak", action="store_true",
                    help="sweep D3 for the card's f32 add and FMA rates")
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=400)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    for name in args.scenes:
        if name not in PRESETS:
            print(f"unknown scene {name!r}; try: {', '.join(PRESETS)}",
                  file=sys.stderr)
            return 2
    if args.peak:
        peak_sweep()
        return 0
    if args.mfu:
        adds = peak.fp32_peak()["ops_per_s"]   # a device constant: once
        for name in args.scenes or ["cornell_box", "final_scene"]:
            # walls well above launch overhead: cornell_box at 500 spp
            mfu(name, spp=500 if name == "cornell_box" else 64,
                peak_adds=adds)
        return 0
    for name in args.scenes or ["final_scene", "random_spheres"]:
        run(name, nx=args.nx, ny=args.ny, spp=args.spp,
            max_depth=args.max_depth, balance=args.balance,
            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
