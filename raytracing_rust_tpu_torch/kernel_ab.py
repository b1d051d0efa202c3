"""Same-call A/B of the K1 kernel, or with --grad of K2 and K3, between
this checkout and another one.

    python -m raytracing_rust_tpu_torch.kernel_ab --other DIR [--grad]
        [--turns N] [--out FILE]

DIR is another checkout of the repository, e.g. the parent commit unpacked
with `git archive` into a directory `.gitignore` lists. On one CUDA card the
script builds both checkouts' kernels, compares the SASS of the K1a
instantiation (`trace_k1<false, false, false, false>`, cornell_box's
kernel) line by line without addresses, and times the kernel in each
checkout in turns (other, this, this, other) on cornell_box_baseline
800×800 at 100 spp, random_spheres 1280×720 at 100 spp, two_spheres
1280×720 at 10 spp and final_scene 800×800 at 10 spp, then at the
comparison shapes of chip_smoke.py (cornell_box_baseline and
random_spheres at 2 spp, final_scene at 1), as the cost probe of a
balanced render (`cost_permutation`'s stats launch: PROBE_SPP samples at
PROBE_SEED on the scanline layout) on random_spheres and final_scene, and
as the command line's own table launches of those two presets (100 spp on
the kpix-4 pixel table of the probe's order, in the chunks of
`render_kernel`'s lane budget: 72 + 28 samples at 1280×720, one launch of
100 at 800×800; a timing is the sum of the chunks), depth 50, by CUDA
events over repeated launches after a warm-up. Each
timing run is a fresh process in that checkout, so each imports its own
package. The sums' totals show whether both checkouts compute the same
image. With --grad it times K2 and K3 instead, in the same turns, on the
default inverse render's step and on the geometry step (each 200×200,
block 4,096 × 64 spp = 262,144 lanes, depth 6, step 0's rays and draws, a
seeded cotangent), the mean of 20 launches per timing, the median of 5
timings per run; K2's radiance totals show whether both checkouts trace
the same paths. --turns N repeats the four turns N times (2N runs of each
checkout). Prints one JSON object, also written to
FILE when given.

    python -m raytracing_rust_tpu_torch.kernel_ab --cull [--turns N]
        [--out FILE]

times this checkout's K1 alone, on the same operands with their super
rows (the two-level cull: root, supers, leaves) and with them emptied
(the one-level cull: the root gate over the leaves), in turns (two, one,
one, two) in one process: at the command line's table launches of
random_spheres and final_scene (as above), and on crowds of n small
spheres (`crowd`: n = 1,000 to 20,000, 64 to 2,048 leaves) at 1280×720 ×
4 spp on the scanline layout, depth 50, a timing one launch (its chunks
summed) by CUDA events after a warm-up; the sums show whether both forms
compute the same image.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, preset, samples, timings, layout): "scanline", "probe" (the cost
# probe's stats launch) or "table" (the command line's balanced launches)
SCENES = (
    ("cornell_box_baseline", "cornell_box_baseline", 100, 5, "scanline"),
    ("random_spheres", "random_spheres", 100, 5, "scanline"),
    ("two_spheres", "two_spheres", 10, 10, "scanline"),
    ("final_scene", "final_scene", 10, 5, "scanline"),
    ("cornell_box_baseline@2", "cornell_box_baseline", 2, 20, "scanline"),
    ("random_spheres@2", "random_spheres", 2, 20, "scanline"),
    ("final_scene@1", "final_scene", 1, 20, "scanline"),
    ("random_spheres probe", "random_spheres", 4, 20, "probe"),
    ("final_scene probe", "final_scene", 4, 10, "probe"),
    ("random_spheres table", "random_spheres", 100, 3, "table"),
    ("final_scene table", "final_scene", 100, 3, "table"))

# (label, preset or crowd size, samples, layout) of the --cull timings
CULL_SHAPES = (("random_spheres table", "random_spheres", 100, "table"),
               ("final_scene table", "final_scene", 100, "table"),
               *((f"crowd {n}", n, 4, "scanline")
                 for n in (1000, 2000, 4000, 8000, 20000)))


def crowd(n: int, nx: int, ny: int):
    """n small spheres (radius 0.05) of lambertian, metal and glass, every
    other one moving, over 12 × 3 × 12 units above a checker ground under
    the sky, and a camera that looks into them → (scene, camera): a dynamic
    sphere table of n rows, the card tests' many-sphere scene."""
    import numpy as np
    from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
    from raytracing_rust_tpu_torch.ops import camera
    r = np.random.default_rng(5)
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.checker(
        b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))))
    mats = [b.lambertian(b.solid(0.8, 0.3, 0.3)),
            b.metal(b.solid(0.7, 0.7, 0.7), 0.1), b.dielectric(1.5)]
    for i in range(n):
        c = r.uniform((-6.0, 0.05, -6.0), (6.0, 3.0, 6.0))
        if i % 2:
            b.moving_sphere(c, c + (0.0, 0.2, 0.0), 0.0, 1.0, 0.05,
                            mats[i % 3])
        else:
            b.sphere(c, 0.05, mats[i % 3])
    return b.build(), camera.make_camera((0, 2, 8), (0, 1, 0), (0, 1, 0),
                                         35.0, nx / ny, 0.0, 10.0, 0.0, 1.0)


def _time_cull(turns: int) -> dict:
    """The --cull timings (see the module's docstring)."""
    import dataclasses
    import statistics
    import torch
    from raytracing_rust_tpu_torch.models.builders import PRESETS
    from raytracing_rust_tpu_torch.ops import tracer
    dev = torch.device("cuda")
    out = {}
    for label, scene, spp, layout in CULL_SHAPES:
        if isinstance(scene, int):
            nx, ny = 1280, 720
            built, cam = crowd(scene, nx, ny)
        else:
            p = PRESETS[scene]
            nx, ny, built, cam = p.nx, p.ny, p.build(), p.camera()
        n_pix = nx * ny
        two = tracer.trace_operands(tracer.build_scene_record(built),
                                    tracer.build_camera_record(cam), dev)
        one = dataclasses.replace(two, sups=two.sups[:0],
                                  bsups=two.bsups[:0])
        kw = dict(nx=nx, ny=ny, seed=0, max_depth=50)
        chunks = [(0, spp)]
        if layout == "table":
            kpix, chunks = tracer.launch_plan(n_pix, spp, dev)
            order = tracer.cost_permutation(two, nx, ny, 50, dev)
            kw.update(pix=torch.from_numpy(tracer.balanced_pix_table(
                order, n_pix, kpix)[0]).to(dev), kpix=kpix)
        sums = {f: torch.zeros((3, n_pix), dtype=torch.float64, device=dev)
                for f in ("two", "one")}

        def launch(form):
            ops = two if form == "two" else one
            for s0, n in chunks:
                tracer.trace(ops, sums[form], sample0=s0, n_samples=n, **kw)
        ms = {"two": [], "one": []}
        for form in ("two", "one"):
            launch(form)
        for form in ("two", "one", "one", "two") * turns:
            sums[form].zero_()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            launch(form)
            b.record()
            torch.cuda.synchronize()
            ms[form].append(a.elapsed_time(b))
        med = {f: statistics.median(v) for f, v in ms.items()}
        out[label] = dict(
            shape=[ny, nx, spp], layout=layout, chunks=chunks,
            leaves=[int(two.leaves.shape[0]), int(two.bleaves.shape[0])],
            supers=[int(two.sups.shape[0]), int(two.bsups.shape[0])],
            ms=ms, median_ms=med, one_over_two=med["one"] / med["two"],
            sums_equal=bool(torch.equal(sums["two"], sums["one"])))
    return out


_TIMING = r"""
import json, statistics, sys
import torch
sys.path.insert(0, ".")
from raytracing_rust_tpu_torch.models.builders import PRESETS
from raytracing_rust_tpu_torch.ops import _build, tracer
out = {"library": _build.build()[0]}
dev = torch.device("cuda")
for label, scene, spp, reps, layout in SCENES:
    p = PRESETS[scene]
    n_pix = p.nx * p.ny
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(p.camera()), dev)
    sums = torch.zeros((3, n_pix), dtype=torch.float64, device=dev)
    kw = dict(nx=p.nx, ny=p.ny, seed=0, max_depth=50)
    stats = None
    chunks = [(0, spp)]
    if layout == "probe":
        stats = tracer.new_stats(p.nx, p.ny, dev)
        kw.update(seed=tracer.PROBE_SEED, stats=stats)
    elif layout == "table":
        kpix, chunks = tracer.launch_plan(n_pix, spp, dev)
        order = tracer.cost_permutation(ops, p.nx, p.ny, 50, dev)
        kw.update(pix=torch.from_numpy(tracer.balanced_pix_table(
            order, n_pix, kpix)[0]).to(dev), kpix=kpix)

    def launch():
        for s0, n in chunks:
            tracer.trace(ops, sums, sample0=s0, n_samples=n, **kw)
    launch()
    ms = []
    for _ in range(reps):
        if stats is not None:
            stats.zero_()
        sums.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    out[label] = dict(spp=spp, layout=layout, chunks=chunks, ms=ms,
                      median_ms=statistics.median(ms),
                      sum=float(sums.sum()))
print(json.dumps(out))
"""


_GRAD_TIMING = r"""
import json, statistics, sys
import torch
sys.path.insert(0, ".")
from raytracing_rust_tpu_torch import inverse_render as ir
from raytracing_rust_tpu_torch.ops import _build, grad
out = {"library": _build.build()[0]}
dev = torch.device("cuda")
kw = dict(nx=200, ny=200, spp=64, block=4096, max_depth=6)
g = torch.Generator(device=dev)
for names, scene, cam in (
        (("k2_grad_fwd", "k3_grad_bwd"),
         ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT, device=dev),
         ir.camera(dev)),
        (("k2b_sky_fwd", "k3b_geometric_bwd"),
         ir.build_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT,
                            ir.TRUE_TILT_DEG, device=dev),
         ir.geo_camera(dev))):
    cfg = grad.fast_grad_config(scene)
    rec = grad.fast_grad_record(scene).detach()
    o, d, u = ir.step_inputs(cam, 0, device=dev, **kw)
    g.manual_seed(3)
    ct = torch.rand(o.shape[0], 3, generator=g, device=dev)
    for name, fn in (
            (names[0], lambda: grad.grad_fwd(rec, o, d, u, cfg, 6)),
            (names[1], lambda: grad.grad_bwd(rec, o, d, u, ct, cfg, 6)[0])):
        total = float(fn().sum())
        ms = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(20):
                fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b) / 20)
        out[name] = dict(ms=ms, median_ms=statistics.median(ms), sum=total)
print(json.dumps(out))
"""
GRAD_KERNELS = ("k2_grad_fwd", "k3_grad_bwd", "k2b_sky_fwd",
                "k3b_geometric_bwd")


def _time_checkout(path: str, grad: bool = False) -> dict:
    code = _GRAD_TIMING if grad else f"SCENES = {SCENES!r}\n{_TIMING}"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=path,
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"timing in {path} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _k1a_sass(library: str) -> list[str]:
    """The K1a instantiation's SASS instructions, addresses and encodings
    stripped."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, inside = [], False
    for line in text.splitlines():
        if line.strip().startswith("Function :"):
            inside = "trace_k1ILb0ELb0ELb0E" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if inside and m:
            out.append(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracing_rust_tpu_torch.kernel_ab")
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--cull", action="store_true",
                    help="time this checkout's K1 with and without its "
                    "super rows instead")
    ap.add_argument("--grad", action="store_true",
                    help="time K2 and K3 instead of K1")
    ap.add_argument("--turns", type=int, default=1,
                    help="repeat the (other, this, this, other) turns")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if (args.other is None) != args.cull:
        ap.error("give either --other DIR or --cull")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.cull:
        _report(dict(device=smi, turns=args.turns,
                     shapes=_time_cull(args.turns)), args.out)
        return 0
    other = os.path.abspath(args.other)
    runs = [(who, _time_checkout(path, args.grad)) for who, path in
            (("other", other), ("this", _ROOT), ("this", _ROOT),
             ("other", other)) * args.turns]
    if args.grad:
        kernels = {}
        for k in GRAD_KERNELS:
            med = {who: [r[k]["median_ms"] for w, r in runs if w == who]
                   for who in ("other", "this")}
            mean = {who: sum(v) / len(v) for who, v in med.items()}
            kernels[k] = dict(median_ms=med, mean_ms=mean,
                              this_over_other=mean["this"] / mean["other"],
                              sums_equal=len({r[k]["sum"]
                                              for _, r in runs}) == 1)
        _report(dict(device=smi, order=[who for who, _ in runs],
                     kernels=kernels,
                     runs=[dict(who=who, **r) for who, r in runs]), args.out)
        return 0
    sass = {who: _k1a_sass(r["library"]) for who, r in runs[:2]}
    differ = sum(a != b for a, b in zip(sass["other"], sass["this"])) + abs(
        len(sass["other"]) - len(sass["this"]))
    result = dict(
        device=smi, order=[who for who, _ in runs],
        k1a_sass=dict(instructions_other=len(sass["other"]),
                      instructions_this=len(sass["this"]),
                      differing=differ),
        scenes={label: dict(
            spp=spp, layout=layout,
            median_ms={who: [r[label]["median_ms"] for w, r in runs
                             if w == who] for who in ("other", "this")},
            sums_equal=len({r[label]["sum"] for _, r in runs}) == 1)
            for label, _, spp, _, layout in SCENES},
        runs=[dict(who=who, **r) for who, r in runs])
    _report(result, args.out)
    return 0


def _report(result: dict, out: str | None) -> None:
    text = json.dumps(result)
    print(text)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())
