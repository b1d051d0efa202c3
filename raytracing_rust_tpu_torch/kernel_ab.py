"""Same-call A/B of the K1 kernel, or with --grad of K2 and K3, between
this checkout and another one; the time shares of two K1 sections.

    python -m raytracing_rust_tpu_torch.kernel_ab --other DIR [--grad]
        [--turns N] [--out FILE]

DIR is another checkout of the repository, e.g. the parent commit unpacked
with `git archive` into a directory `.gitignore` lists. On one CUDA card the
script builds both checkouts' kernels, compares the SASS of the K1a
instantiation (`trace_k1<false, false, false, false>`, cornell_box's
kernel) line by line without addresses, and times the kernel in each
checkout in turns (other, this, this, other) on the shapes of `SCENES`:
cornell_box_baseline 800×800 at 100 spp (also with roulette from bounce
6, K1g), random_spheres 1280×720 at 100 spp, two_spheres and
two_perlin_spheres 1280×720 at 10 spp, earth 1280×720 at 10 spp,
cornell_smoke 800×800 at 100 spp, final_scene 800×800 at 10 spp, then at
the comparison shapes of chip_smoke.py (cornell_box_baseline and
random_spheres at 2 spp, final_scene at 1), as the cost probe of a
balanced render (`cost_probe`'s stats launch: PROBE_SPP samples at
PROBE_SEED on the scanline layout) on random_spheres and final_scene, as
the command line's own table launches of those two presets (100 spp on
the checkout's own render table, `render_table`, or in a checkout from
before it JAX's kpix-4 table of the probe's order, in the chunks of
`render_kernel`'s lane budget: 72 + 28 samples at 1280×720, one launch of
100 at 800×800; a timing is the sum of the chunks), every final_scene
shape also with the dense-medium walk off (the event path: the same
operands with FEAT_DENSE_WALK cleared), and as the command line's own
scanline launches of simple_light and of `lattice_scene` through
`lattice_camera` (1280×720, 72 + 28 samples), depth 50, by CUDA events
over repeated launches after a warm-up. Each timing run is a fresh process in that checkout, so each imports its own
package. The sums' totals show whether both checkouts compute the same
image. With --grad it times K2 and K3 instead, in the same turns, on the
default inverse render's step and on the geometry step (each 200×200,
block 4,096 × 64 spp = 262,144 lanes, depth 6, step 0's rays and draws, a
seeded cotangent), through the wrappers and as bare launches on
preallocated outputs (`grad.bare_launches`; in a checkout from before the
winner tape, its lane-major launches), K2 without and with its tape, the
mean of 20 launches per timing, the median of 5 timings per run; K2's
radiance totals and K3's d_d totals show whether both checkouts trace the
same paths (K3's d_rec is summed in another order since the tape).
--turns N repeats the four turns N times (2N runs of each
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

    python -m raytracing_rust_tpu_torch.kernel_ab --shares [--turns N]
        [--out FILE]

measures in this checkout what two sections of K1 cost, on the shapes of
`SHARE_SHAPES` (final_scene's table launch of 100 spp, its
scanline launches of 10 and 1 spp and its 4-spp cost probe, simple_light
72 + 28 and two_perlin_spheres 10 spp at 1280×720, as above): the
dense-medium walk, as final_scene's time with the walk against the event
path (the same operands with FEAT_DENSE_WALK cleared; `walk_equals_event`
says whether the two totals agree); the Perlin marble's turbulence, as each shape's time in the production
build against a second build of the kernels under K1_SOLID_MARBLE, a
define that only this mode passes to nvcc, in which the marble shades
with its solid-colour fields (the paths and their draws stay the same).
The two builds run in fresh processes in turns (production, solid,
solid, production); a section's share is 1 − (time without it) / (time
with it), from the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, preset, samples, timings, layout, variant): layout "scanline",
# "probe" (the cost probe's stats launch), "table" (the command line's
# balanced launches) or "cli" (the command line's scanline launches, in
# the chunks of the lane budget); variant None, "event" (the walk's bit
# cleared) or "rr6" (roulette from bounce 6); "lattice" is lattice_scene
# through lattice_camera at 1280×720
SCENES = (
    ("cornell_box_baseline", "cornell_box_baseline", 100, 5, "scanline",
     None),
    ("cornell_box_baseline rr6", "cornell_box_baseline", 100, 5, "cli",
     "rr6"),
    ("random_spheres", "random_spheres", 100, 5, "scanline", None),
    ("two_spheres", "two_spheres", 10, 10, "scanline", None),
    ("two_perlin_spheres", "two_perlin_spheres", 10, 10, "scanline", None),
    ("simple_light", "simple_light", 100, 5, "cli", None),
    ("earth", "earth", 10, 10, "scanline", None),
    ("cornell_smoke", "cornell_smoke", 100, 5, "scanline", None),
    ("lattice", "lattice", 100, 3, "cli", None),
    ("final_scene", "final_scene", 10, 5, "scanline", None),
    ("final_scene event", "final_scene", 10, 5, "scanline", "event"),
    ("cornell_box_baseline@2", "cornell_box_baseline", 2, 20, "scanline",
     None),
    ("random_spheres@2", "random_spheres", 2, 20, "scanline", None),
    ("final_scene@1", "final_scene", 1, 20, "scanline", None),
    ("final_scene@1 event", "final_scene", 1, 20, "scanline", "event"),
    ("random_spheres probe", "random_spheres", 4, 20, "probe", None),
    ("final_scene probe", "final_scene", 4, 10, "probe", None),
    ("final_scene probe event", "final_scene", 4, 10, "probe", "event"),
    ("random_spheres table", "random_spheres", 100, 3, "table", None),
    ("final_scene table", "final_scene", 100, 3, "table", None),
    ("final_scene table event", "final_scene", 100, 3, "table", "event"))

# the --shares shapes: final_scene's, each with the walk and without it,
# simple_light's and two_perlin_spheres'
SHARE_SHAPES = tuple(s for s in SCENES if s[1] in (
    "final_scene", "simple_light", "two_perlin_spheres"))

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
            chunks = tracer.launch_plan(n_pix, spp, dev)[1]
            kw.update(pix=tracer.render_table(two, nx, ny, 50, dev))
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
import dataclasses, json, statistics, sys
import torch
sys.path.insert(0, ".")
from raytracing_rust_tpu_torch.models.builders import (PRESETS,
                                                        lattice_camera,
                                                        lattice_scene)
from raytracing_rust_tpu_torch.ops import _build, tracer
_build.NVCC_FLAGS = _build.NVCC_FLAGS + DEFINES
out = {"library": _build.build()[0]}
dev = torch.device("cuda")
for label, scene, spp, reps, layout, variant in SCENES:
    if scene == "lattice":
        nx, ny, built, cam = 1280, 720, lattice_scene(), lattice_camera(
            1280, 720)
    else:
        p = PRESETS[scene]
        nx, ny, built, cam = p.nx, p.ny, p.build(), p.camera()
    n_pix = nx * ny
    ops = tracer.trace_operands(tracer.build_scene_record(built),
                                tracer.build_camera_record(cam), dev,
                                6 if variant == "rr6" else None)
    if variant == "event":
        ops = dataclasses.replace(
            ops, feats=ops.feats & ~tracer.FEAT_DENSE_WALK)
    sums = torch.zeros((3, n_pix), dtype=torch.float64, device=dev)
    kw = dict(nx=nx, ny=ny, seed=0, max_depth=50)
    stats = None
    chunks = [(0, spp)]
    if layout == "probe":
        stats = tracer.new_stats(nx, ny, dev)
        kw.update(seed=tracer.PROBE_SEED, stats=stats)
    elif layout in ("table", "cli"):
        kpix, chunks = tracer.launch_plan(n_pix, spp, dev)
    if layout == "table" and hasattr(tracer, "render_table"):
        kw.update(pix=tracer.render_table(ops, nx, ny, 50, dev))
    elif layout == "table":
        # a checkout whose render launches JAX's table
        order = tracer.cost_permutation(ops, nx, ny, 50, dev)
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
    out[label] = dict(spp=spp, layout=layout, variant=variant,
                      chunks=chunks, ms=ms, median_ms=statistics.median(ms),
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
# a checkout with K2's winner tape (and K3 reading it) has bare_launches
TAPE = hasattr(grad, "bare_launches")


def bare_before_tape(rec, o, d, u, ct, cfg):
    # the launches of a checkout from before the tape: lane-major operands
    # and per-block d_rec partials, as its wrappers passed them
    lib = _build.load()
    st = torch.cuda.current_stream().cuda_stream
    n, P, nb = o.shape[0], rec.shape[0], u.shape[0]
    blocks = -(-n // 128)
    o_t, d_t, ct_t = (x.t().contiguous() for x in (o, d, ct))
    rad, d_o, d_d = (torch.empty(3, n, device=dev) for _ in range(3))
    part = torch.empty(blocks, P, 35, device=dev)
    fl = grad._feat_flags(cfg)

    def fwd():
        assert lib.rt_grad_fwd(rec.data_ptr(), P, o_t.data_ptr(),
                               d_t.data_ptr(), u.data_ptr(), rad.data_ptr(),
                               n, nb, 6, *fl, st) == 0

    def bwd():
        assert lib.rt_grad_bwd(rec.data_ptr(), P, o_t.data_ptr(),
                               d_t.data_ptr(), u.data_ptr(), ct_t.data_ptr(),
                               d_o.data_ptr(), d_d.data_ptr(),
                               part.data_ptr(), n, blocks, nb, 6, *fl,
                               st) == 0
    return fwd, None, bwd


def timed(fn):
    fn()
    ms = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(20):
            fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / 20)
    return dict(ms=ms, median_ms=statistics.median(ms))


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
    if TAPE:
        _, tape = grad.grad_fwd(rec, o, d, u, cfg, 6, tape=True)
        fwd = lambda: grad.grad_fwd(rec, o, d, u, cfg, 6)
        fwd_tape = lambda: grad.grad_fwd(rec, o, d, u, cfg, 6, tape=True)[0]
        bwd = lambda: grad.grad_bwd(rec, o, d, u, ct, cfg, 6, tape=tape)
        bare = grad.bare_launches(rec, o, d, u, ct, cfg, 6)
    else:
        fwd = fwd_tape = lambda: grad.grad_fwd(rec, o, d, u, cfg, 6)
        bwd = lambda: grad.grad_bwd(rec, o, d, u, ct, cfg, 6)
        bare = bare_before_tape(rec, o, d, u, ct, cfg)
    # the sums of a contiguous [N, 3] copy, so both layouts sum alike
    out[names[0]] = dict(**timed(fwd), bare=timed(bare[0]),
                         sum=float(fwd().contiguous().sum()))
    if TAPE:
        out[names[0] + "_tape"] = dict(
            **timed(fwd_tape), bare=timed(bare[1]),
            sum=float(fwd_tape().contiguous().sum()))
    k3 = bwd()
    out[names[1]] = dict(**timed(bwd), bare=timed(bare[2]),
                         sum=float(k3[2].contiguous().sum()),
                         d_o_sum=float(k3[1].contiguous().sum()),
                         d_rec_sum=float(k3[0].sum()))
print(json.dumps(out))
"""
# K2 without and with its tape (a checkout from before the tape times its K2
# under both names), K3
GRAD_KERNELS = ("k2_grad_fwd", "k2_grad_fwd_tape", "k3_grad_bwd",
                "k2b_sky_fwd", "k2b_sky_fwd_tape", "k3b_geometric_bwd")



def _time_checkout(path: str, grad: bool = False, scenes=SCENES,
                   defines: tuple = ()) -> dict:
    """One timing run in a fresh process in the checkout at path: K1 on
    `scenes` (built with the nvcc `defines`), or with grad K2 and K3."""
    code = (_GRAD_TIMING if grad else
            f"SCENES = {scenes!r}\nDEFINES = {defines!r}\n{_TIMING}")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=path,
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"timing in {path} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _time_shares(turns: int) -> dict:
    """The --shares timings (see the module's docstring)."""
    import statistics
    builds = {"production": (), "solid": ("-DK1_SOLID_MARBLE",)}
    runs = [(b, _time_checkout(_ROOT, scenes=SHARE_SHAPES,
                               defines=builds[b]))
            for b in ("production", "solid", "solid", "production") * turns]
    med = {b: {label: statistics.median(r[label]["median_ms"]
                                        for w, r in runs if w == b)
               for label, *_ in SHARE_SHAPES} for b in builds}
    shapes = {}
    for label, scene, spp, _, layout, variant in SHARE_SHAPES:
        row = dict(spp=spp, layout=layout, variant=variant,
                   median_ms={b: [r[label]["median_ms"] for w, r in runs
                                  if w == b] for b in builds},
                   noise_share=1.0 - med["solid"][label]
                   / med["production"][label],
                   sums_equal={b: len({r[label]["sum"] for w, r in runs
                                       if w == b}) == 1 for b in builds})
        if variant is None and f"{label} event" in med["production"]:
            ev = f"{label} event"
            row.update(walk_share={b: 1.0 - med[b][ev] / med[b][label]
                                   for b in builds},
                       walk_equals_event=all(
                           r[label]["sum"] == r[ev]["sum"] for _, r in runs))
        shapes[label] = row
    return dict(order=[b for b, _ in runs], shapes=shapes,
                runs=[dict(build=b, **r) for b, r in runs])


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
    ap.add_argument("--shares", action="store_true",
                    help="measure the walk's and the marble's time shares "
                    "in this checkout instead")
    ap.add_argument("--turns", type=int, default=1,
                    help="repeat the (other, this, this, other) turns")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if (args.other is not None) + args.cull + args.shares != 1:
        ap.error("give one of --other DIR, --cull or --shares")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.cull:
        _report(dict(device=smi, turns=args.turns,
                     shapes=_time_cull(args.turns)), args.out)
        return 0
    if args.shares:
        _report(dict(device=smi, turns=args.turns,
                     **_time_shares(args.turns)), args.out)
        return 0
    other = os.path.abspath(args.other)
    runs = [(who, _time_checkout(path, args.grad)) for who, path in
            (("other", other), ("this", _ROOT), ("this", _ROOT),
             ("other", other)) * args.turns]
    if args.grad:
        kernels = {}
        for k in GRAD_KERNELS:
            # a checkout from before the tape has one K2: it stands for both
            rows = [(w, r.get(k) or r[k.removesuffix("_tape")])
                    for w, r in runs]
            row = {}
            for form, get in (("wrapper", lambda x: x["median_ms"]),
                              ("bare", lambda x: x["bare"]["median_ms"])):
                med = {who: [get(x) for w, x in rows if w == who]
                       for who in ("other", "this")}
                mean = {who: sum(v) / len(v) for who, v in med.items()}
                row[form] = dict(median_ms=med, mean_ms=mean,
                                 this_over_other=mean["this"]
                                 / mean["other"])
            kernels[k] = dict(**row, sums_equal=len({x["sum"]
                                                     for _, x in rows}) == 1)
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
            for label, _, spp, _, layout, _ in SCENES},
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
