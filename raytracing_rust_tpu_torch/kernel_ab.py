"""Same-call A/B of the K1 kernel, or with --grad of K2 and K3, between
this checkout and another one; the time shares of two K1 sections.

    python -m raytracing_rust_tpu_torch.kernel_ab --other DIR [--grad]
        [--turns N] [--out FILE]

DIR is another checkout of the repository, e.g. the parent commit unpacked
with `git archive` into a directory `.gitignore` lists. On one CUDA card the
script builds both checkouts' kernels, compares the SASS of the K1a
instantiation (`trace_k1<false, 0, false, 0, false>`, cornell_box's
kernel, with and without roulette) and of the other production
instantiations (STATS off; in a checkout from before the MED flag, the
one that ran the same scenes) line by line without addresses, counts
every instantiation's loads
in its row loops (`tracer.k1_sass_loads`), reports both builds' ptxas
registers and spills and blocks an SM, and times the kernel in each
checkout in turns (other, this, this, other) on the shapes of `SCENES`:
cornell_box_baseline 800×800 at 100 spp (also with roulette from bounce
6, K1g), as the command line's five launches of 500 spp with and
without roulette, random_spheres 1280×720 at 100 spp, two_spheres and
two_perlin_spheres 1280×720 at 10 spp, earth 1280×720 at 10 spp,
cornell_smoke 800×800 at 100 spp, final_scene 800×800 at 10 spp, then at
the comparison shapes of chip_smoke.py (cornell_box_baseline and
random_spheres at 2 spp, final_scene at 1), as the cost probe of a
balanced render (`cost_probe`: PROBE_SPP samples at PROBE_SEED through
`trace_probe`, split as `cost_probe` splits it, or in a checkout from
before it the stats launch on the scanline layout; the timing's sum is the
probe's segments) on random_spheres, final_scene and final_scene at
128×128 (the command line's three probes), cornell_smoke 800×800 at 100
spp on the card's table of a zero cost (compact 16×8 tiles in raster
order, a DYN launch), as
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

measures in this checkout what three parts of K1 cost, on the shapes of
`SHARE_SHAPES` (final_scene's table launch of 100 spp, its
scanline launches of 10 and 1 spp and its 4-spp cost probe, simple_light
72 + 28 and two_perlin_spheres 10 spp at 1280×720, cornell_smoke 100 spp
on the scanline layout and on compact tiles, the three probes, as above):
the dense-medium walk, as final_scene's time with the walk against the
event path (the same operands with FEAT_DENSE_WALK cleared;
`walk_equals_event` says whether the two totals agree); and, against the
production build, two timing builds of the kernels under a define that
only this mode passes to nvcc (`SHARE_BUILDS`): K1_SOLID_MARBLE, in which
the marble shades with its solid-colour fields (the paths and their draws
stay the same), so the noise's share is 1 − solid / production; and
K1_MEDIA_TWICE, in which each segment runs its media race twice (the
second into a sink), so the race's share is twice / production − 1. The
builds run in fresh processes in turns (production, solid, media, media,
solid, production), the medians of each build compared, with each fresh
build's K1 registers and spills (`ptxas`); the production runs also count
each shape's segments, warp steps and occupancy by a stats launch of the
same layout (the probes: their split and blocks).
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
# "probe" (the cost probe of a balanced render: `trace_probe` as
# `cost_probe` splits it, or in a checkout from before it the stats launch
# on the scanline layout), "table" (the command line's balanced launches),
# "cli" (the command line's scanline launches, in the chunks of the lane
# budget) or "tiles" (one launch on the card's table of a zero cost:
# compact 16×8 tiles in raster order); variant None, "event" (the walk's
# bit cleared) or "rr6" (roulette from bounce 6); "lattice" is
# lattice_scene through lattice_camera at 1280×720; a label in SIZES runs
# at that size instead of the preset's
SCENES = (
    ("cornell_box_baseline", "cornell_box_baseline", 100, 5, "scanline",
     None),
    ("cornell_box_baseline rr6", "cornell_box_baseline", 100, 5, "cli",
     "rr6"),
    ("cornell_box_baseline cli", "cornell_box_baseline", 500, 3, "cli",
     None),
    ("cornell_box_baseline rr6 cli", "cornell_box_baseline", 500, 3, "cli",
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
    ("final_scene probe 128", "final_scene", 4, 20, "probe", None),
    ("cornell_smoke tiles", "cornell_smoke", 100, 5, "tiles", None),
    ("random_spheres table", "random_spheres", 100, 3, "table", None),
    ("final_scene table", "final_scene", 100, 3, "table", None),
    ("final_scene table event", "final_scene", 100, 3, "table", "event"))

# (nx, ny) of the shapes that do not run at their preset's size: the third
# probe of the command line's main path (final_scene at 128×128)
SIZES = {"final_scene probe 128": (128, 128)}

# the --shares shapes: final_scene's, each with the walk and without it,
# simple_light's, two_perlin_spheres', cornell_smoke's and the probes
SHARE_SHAPES = tuple(s for s in SCENES if s[1] in (
    "final_scene", "simple_light", "two_perlin_spheres", "cornell_smoke")
    or s[4] == "probe")

# the --shares builds: the nvcc defines of each (csrc/tracer.cu)
SHARE_BUILDS = {"production": (), "solid": ("-DK1_SOLID_MARBLE",),
                "media": ("-DK1_MEDIA_TWICE",)}

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
lib_path, log = _build.build()
out = {"library": lib_path, "ptxas": {},
       "blocks_per_sm": tracer.k1_blocks_per_sm()}
fn = None
for ln in log.splitlines():   # registers and spills of a fresh build's K1
    if "entry function" in ln:
        fn = ln.split("'")[1] if "trace_k1" in ln else None
    elif fn and ("registers" in ln or "spill" in ln):
        out["ptxas"].setdefault(fn, []).append(ln.split(" : ")[-1].strip())
dev = torch.device("cuda")
for label, scene, spp, reps, layout, variant in SCENES:
    if scene == "lattice":
        nx, ny, built, cam = 1280, 720, lattice_scene(), lattice_camera(
            1280, 720)
    else:
        p = PRESETS[scene]
        nx, ny, built, cam = p.nx, p.ny, p.build(), p.camera()
    if label in SIZES:
        from raytracing_rust_tpu_torch.ops import camera
        nx, ny = SIZES[label]
        cam = camera.make_camera(p.look_from, p.look_at, p.view_up, p.vfov,
                                 nx / ny, p.aperture, p.focus_dist, p.time0,
                                 p.time1)
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
    row = None   # the probe's per-pixel segments
    extra = {}
    if layout == "probe" and hasattr(tracer, "trace_probe"):
        # a box grid's probe runs its own instantiations (a checkout from
        # before them has no `ops.grid`)
        grid = (True,) if getattr(ops, "grid", ()) else ()
        split = tracer.probe_split(tracer.probe_tiles(nx, ny),
                                   tracer.probe_resident(dev, *grid), spp)
        row = torch.zeros(n_pix, dtype=torch.int64, device=dev)
        extra.update(split=split, blocks=split * tracer.probe_tiles(nx, ny))
    elif layout == "probe":
        stats = tracer.new_stats(nx, ny, dev)
        row = stats[:n_pix]
        kw.update(seed=tracer.PROBE_SEED, stats=stats)
    elif layout in ("table", "cli"):
        kpix, chunks = tracer.launch_plan(n_pix, spp, dev)
    if layout == "tiles":
        kw.update(pix=tracer.block_tile_table(
            torch.zeros(n_pix, dtype=torch.int64, device=dev), nx, ny))
    elif layout == "table" and hasattr(tracer, "render_table"):
        kw.update(pix=tracer.render_table(ops, nx, ny, 50, dev))
    elif layout == "table":
        # a checkout whose render launches JAX's table
        order = tracer.cost_permutation(ops, nx, ny, 50, dev)
        kw.update(pix=torch.from_numpy(tracer.balanced_pix_table(
            order, n_pix, kpix)[0]).to(dev), kpix=kpix)

    def launch():
        if row is not None and stats is None:
            tracer.trace_probe(ops, row, nx=nx, ny=ny,
                               seed=tracer.PROBE_SEED, sample0=0,
                               n_samples=spp, max_depth=50,
                               split=extra["split"])
            return
        for s0, n in chunks:
            tracer.trace(ops, sums, sample0=s0, n_samples=n, **kw)
    launch()
    ms = []
    for _ in range(reps):
        if row is not None:
            row.zero_()
        if stats is not None:
            stats.zero_()
        sums.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    if COUNT and row is None:
        # the counters of one stats launch of the same samples and layout
        # (the last chunk's size: the command line's launches)
        st = tracer.new_stats(nx, ny, dev, kw.get("pix"), kw.get("kpix", 1))
        tracer.trace(ops, torch.zeros_like(sums), sample0=0,
                     n_samples=chunks[-1][1], stats=st, **kw)
        busy, _, _, steps = tracer.stats_rows(st, n_pix)
        extra.update(counted_spp=chunks[-1][1], segments=int(busy.sum()),
                     warp_steps=int(steps.sum()),
                     occupancy=float(busy.sum()) / (32 * float(steps.sum())))
    out[label] = dict(spp=spp, layout=layout, variant=variant, size=[nx, ny],
                      chunks=chunks, ms=ms, median_ms=statistics.median(ms),
                      sum=float(sums.sum() if row is None else row.sum()),
                      **extra)
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
                   defines: tuple = (), count: bool = False) -> dict:
    """One timing run in a fresh process in the checkout at path: K1 on
    `scenes` (built with the nvcc `defines`; with count also each shape's
    counters from a stats launch), or with grad K2 and K3."""
    code = (_GRAD_TIMING if grad else
            f"SCENES = {scenes!r}\nDEFINES = {defines!r}\n"
            f"SIZES = {SIZES!r}\nCOUNT = {bool(count)!r}\n{_TIMING}")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=path,
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"timing in {path} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _time_shares(turns: int) -> dict:
    """The --shares timings (see the module's docstring)."""
    import statistics
    order = tuple(SHARE_BUILDS)
    runs = [(b, _time_checkout(_ROOT, scenes=SHARE_SHAPES,
                               defines=SHARE_BUILDS[b],
                               count=b == "production"))
            for b in (*order, *order[::-1]) * turns]
    med = {b: {label: statistics.median(r[label]["median_ms"]
                                        for w, r in runs if w == b)
               for label, *_ in SHARE_SHAPES} for b in order}
    shapes = {}
    for label, scene, spp, _, layout, variant in SHARE_SHAPES:
        prod = med["production"][label]
        row = dict(spp=spp, layout=layout, variant=variant,
                   median_ms={b: [r[label]["median_ms"] for w, r in runs
                                  if w == b] for b in order},
                   noise_share=1.0 - med["solid"][label] / prod,
                   media_share=med["media"][label] / prod - 1.0,
                   sums_equal={b: len({r[label]["sum"] for w, r in runs
                                       if w == b}) == 1 for b in order},
                   counters={k: v for k, v in next(
                       r for w, r in runs if w == "production")[label].items()
                       if k in ("counted_spp", "segments", "warp_steps",
                                "occupancy", "split", "blocks", "size")})
        if variant is None and f"{label} event" in med["production"]:
            ev = f"{label} event"
            row.update(walk_share={b: 1.0 - med[b][ev] / med[b][label]
                                   for b in order},
                       walk_equals_event=all(
                           r[label]["sum"] == r[ev]["sum"] for _, r in runs))
        shapes[label] = row
    return dict(order=[b for b, _ in runs], shapes=shapes,
                runs=[dict(build=b, **r) for b, r in runs])


def _k1_sass(library: str) -> tuple[dict, dict]:
    """(the SASS instructions of each production instantiation of K1
    (STATS off), addresses and encodings stripped, by its flags "K1B,DYN,
    LEAF_SMEM,MED" (K1a's "0,0,0,0"; DYN 2 a box grid's), or "K1B,DYN,
    LEAF_SMEM" in a checkout from before the MED flag; the loads of every
    instantiation, `tracer.k1_sass_loads`)."""
    from raytracing_rust_tpu_torch.ops import sass, tracer
    text = sass.cuobjdump_sass(library)
    out = {}
    for name, instrs in sass.functions(text).items():
        f = re.search(r"trace_k1ILb([01])EL[bi]([012])ELb([01])EL[bi]0E"
                      r"(?:Lb([01])E)?E", name)
        if f:
            out[",".join(g for g in f.groups() if g is not None)] = [
                s for _, s in instrs]
    return out, tracer.k1_sass_loads(text=text)


def _counterpart(other: dict, name: str) -> list:
    """The other checkout's SASS of the instantiation `name` ("K1B,DYN,
    LEAF_SMEM,MED"): its own, or in a checkout from before the box grid's
    instantiations (DYN 2) the one that ran the grid (DYN 1), or in a
    checkout from before the MED flag the one that ran the same scenes
    ("K1B,DYN,LEAF_SMEM"; media alone ran K1B then)."""
    if name in other:
        return other[name]
    k1b, dyn, leaf, med = name.split(",")
    if dyn == "2":
        return _counterpart(other, ",".join((k1b, "1", leaf, med)))
    if (k1b, dyn, med) == ("0", "0", "1"):
        k1b = "1"
    return other.get(",".join((k1b, dyn, leaf)), [])


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
    sass, loads = {}, {}
    for who, r in runs[:2]:
        sass[who], loads[who] = _k1_sass(r["library"])

    def differ(name):
        a, b = _counterpart(sass["other"], name), sass["this"].get(name, [])
        return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    k1a = "0,0,0,0" if "0,0,0,0" in sass["this"] else "0,0,0"
    result = dict(
        device=smi, order=[who for who, _ in runs],
        k1a_sass=dict(
            instructions_other=len(_counterpart(sass["other"], k1a)),
            instructions_this=len(sass["this"].get(k1a, [])),
            differing=differ(k1a)),
        production_sass_differing={
            name: differ(name) for name in sorted(sass["this"])},
        sass_loads=loads,
        ptxas={who: r["ptxas"] for who, r in runs[:2]},
        blocks_per_sm={who: r["blocks_per_sm"] for who, r in runs[:2]},
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
