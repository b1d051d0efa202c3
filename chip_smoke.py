#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_rust_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
version and renders on the card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from csrc/ with nvcc (timed), with ptxas's
     registers and spills per instantiation and the blocks of each K1
     instantiation an SM holds (the runtime's occupancy query);
  3. the K1a kernel against its plain torch version, on the card, on the
     same records and draws: cornell_box 800×800, 4 spp, depth 50;
  4. sample chunks of 2 and 4 give bit-identical kernel sums;
  5. the render path through the command line, `render --scene
     cornell_box_baseline --device cuda` (800×800, 500 spp, depth 50),
     with K1a's launch count, a check of the image, and the kernel's and
     the plain version's times at 800×800×8 spp;
  6. K2 (csrc/grad.cu) against its plain version `trace_tiles_plain` at
     the training step's full width: the inverse-render scene, 4,096
     pixels × 64 spp = 262,144 lanes, depth 6, the step's own rays and
     draws; its winner tape bit-equal to the plain tape;
  7. K3 on that tape against torch autograd through the plain version,
     same inputs and a seeded cotangent; d_rec, d_o and d_d identical in
     two launches;
  8. the training path, `inverse_render.main(["--device", "cuda",
     "--steps", "40"])` (200×200, block 4,096, 64 spp, depth 6), with K2's
     and K3's launch counts and the recovered albedo and emission;
  9. times by CUDA events at that width: K2 (without and with its tape)
     and K3 through the wrappers and as bare launches on preallocated
     outputs, each kernel's registers, stack frame, blocks an SM and waves,
     the device ops of each wrapper call (torch.profiler: the kernel
     alone), the plain forward, the plain forward + backward, one training
     step; sample-paths/s;
 10. the K1b/K1e instantiations of csrc/tracer.cu against their plain
     version, on each sphere preset the command line renders below, at
     the preset's size, 2 spp, depth 50, under the same gates as phase 3
     and bit for bit (max_abs_err 0):
     random_spheres 1280×720 (checker, sky, metal, glass, 397 dynamic
     spheres of which 311 move, in 32 leaves under 4 super rows) and
     two_spheres 1280×720 (sky and checker, no dynamic table); both
     versions' times; on random_spheres the two-level cull's sums held bit
     for bit to the one-level cull's (super rows emptied) and to no
     cull's (leaves emptied), with each one's time;
 11. the render path through the command line, `render --scene
     random_spheres --device cuda` (1280×720, 100 spp, depth 50), with its
     launch count and a check of the image;
 12. the same for `render --scene two_spheres --device cuda` (1280×720,
     10 spp, depth 50);
 13. the K1c and K1d sections of the K1B instantiations against their
     plain version, on each Next Week preset the command line renders
     below, at the preset's size, 2 spp, depth 50, under phase 3's gates
     and bit for bit:
     two_perlin_spheres and simple_light 1280×720 (Perlin marble),
     earth 1280×720 (sphere UV and the 512×1024 texel atlas) and
     cornell_smoke 800×800 (two rotated constant-density boxes); both
     versions' times, and the work the paths needed (lane bounces, noise
     and image lanes) for the kernels' bounds;
 14-17. the render path through the command line, `render --scene S
     --device cuda` at each of those presets' size and spp, depth 50, with
     the launch counts and a check of the image;
 18. the K1e box and K1d walk sections against their plain version on
     final_scene at its preset's size, 800×800, 1 spp, depth 50, under
     phase 3's gates and bit for bit, with the walk on (each walk bounce
     an iteration of the flat loop) and with it off (the event path
     alone); both kernel times, the plain version's, the paths' work, and
     the two kernel runs' sums held to each other bit for bit; on each, the
     two-level cull held bit for bit to the one-level cull and to no cull,
     with their times;
 19. the render path through the command line, `render --scene
     final_scene --device cuda` (800×800, 100 spp, depth 50), with the
     launch counts and a check of the image, and a render at 128×128, 100
     spp whose mean is held to the JAX XLA tier's;
 20. K2 with the sky against its plain version, bit for bit, on the geometry
     inverse render's scene (a ground sphere, a rect light, a tilted cube)
     at its step's full width: 262,144 lanes, depth 6, step 0's rays and
     draws; its tape bit-equal to the plain tape;
 21. K3 with the geometric adjoint against autograd through the plain
     version: each d_rec column within 1e-4 of its own scale, the same
     columns live, d_o and d_d within 1e-4 of theirs; identical in two
     launches;
 22. the geometry training path, `inverse_render.main(["--geometry",
     "--device", "cuda"])` (200 steps), with K2's and K3's launch counts and
     the recovered albedo, emission and tilt;
 23. phase 9's times and kernel facts at that width, and one geometry
     step;
 24. K2 with metal, glass and the checker against its plain version, bit
     for bit, on the JAX fused tier's probe scene (12 prims: a metal sphere
     of fuzz 0.2, a glass sphere of index 1.5, a light, rects and a rotated
     cube, under the sky) at 262,144 lanes, depth 6, rays from (0, 2, 8) as
     tools/tpu_parity.py's fused-tier check makes them, Philox draws; its
     tape bit-equal to the plain tape;
 25. K3 on the same against autograd, per d_rec column as in phase 21
     (fuzz and ref_idx reach C_PARAM), identical in two launches;
 26. phases 24-25 on probe_scene at the tape's full depth, 16, and on the
     checker scene (a checker floor at y = 0.37 and an emissive checker
     sphere: both children's rows) at depths 6 and 16;
 27. the path: the mean radiance's gradient through `trace_fast` into the
     six scene leaves on both scenes at full width, depth 6, with K2's and
     K3's launch counts, against autograd through the plain version leaf by
     leaf (tools/tpu_parity.py's fast_grad_tier on the card);
 28. phase 9's times and kernel facts on probe_scene at full width, depth
     6;
 29. the lattice corners of K1 (textured lights, image rects, flipped
     image prims, textured media) against their plain version on
     `lattice_scene` (tools/tpu_parity.py's camera) at 1280×720, 2 spp,
     depth 50, under phase 3's gates and bit for bit; both versions'
     times and the paths' work (textured-light hits, rect-UV lanes,
     textured-medium events);
 30. the lattice path: `render_kernel` on `lattice_scene` at 1280×720, 100
     spp, depth 50, with its launch counts and a check of the image, and a
     render at 128×72, 100 spp whose mean is held to the JAX XLA tier's;
 31. Russian roulette (K1g) against its plain version: cornell_box
     800×800, 4 spp, rr_depth 6 (a K1B launch), and final_scene 800×800,
     1 spp, rr_depth 5 (the dense-medium walk off), depth 50, under phase
     3's gates and bit for bit; both versions' times and the roulette
     draws;
 32. the roulette path through the command line, `render --scene
     cornell_box_baseline --rr-depth 6 --device cuda` (800×800, 500 spp,
     depth 50), with K1g's launch count, its mean within ±5% of phase 5's
     reference, and its trace time beside phase 5's;
 33. K1f's stats instantiation against the production kernel (sums bit
     for bit) and the plain version (sums bit for bit; per-pixel
     segments, sphere and box member tests and the warp steps equal):
     cornell_box 800×800×2, random_spheres 1280×720×2 and final_scene
     800×800×1, depth 50; the occupancy (segments over 32 × warp steps, a
     warp's steps being the largest segment total among its threads, walk
     bounces included: its iterations of the flat loop),
     the steps per sample and the tail share (1 − occupancy);
 34. the balanced layouts: JAX's cost order and the card's table
     (`render_table`: one pixel a thread, a block on a 16×8 tile, the
     tiles heaviest first), each timed from its probe, then the production
     kernel on JAX's table at kpix 1 and 4 and on the card's table
     against the scanline layout, bit for bit, on random_spheres
     1280×720×2 and final_scene 800×800×1, the plain version on the
     card's table bit for bit; the kernel's times in turns (scanline,
     kpix 1, kpix 4, the card's, the card's, kpix 4, kpix 1, scanline) at
     the samples of the command line's largest table launch of the
     preset, and the occupancy on each layout there, with its blocks and
     waves (blocks over the blocks an SM holds times the SMs);
 35. the render path of both presets through the command line, `render
     --scene random_spheres` and `render --scene final_scene` (and
     final_scene at 128×128 for its mean), now balanced by default: the
     `balance_probe` and `trace` phases, the K1f launch counts, the means
     inside phases 11's and 19's bands;
 36. D3 through `kernel_stats --peak` (`peak_sweep`): the f32 add and FMA
     rates beside the theoretical ones, with the SM clock; its
     accumulators against the plain chain, bit for bit, for every k, adds
     and FMAs;
 37. D1, the winner-row read (csrc/microbench.cu), through `python -m
     raytracing_rust_tpu_torch.microbench` (its `main`: the µs per call at
     8,192 threads, the TPU tile's lanes), then at each variant's own full
     wave (SMs × the blocks of it an SM holds, by the runtime's occupancy
     query): its f32 accumulator and checksum against the plain version,
     bit for bit, both variants (read-only cache, shared memory) and both
     band counts at 8,192 threads, k = 2 and 22, and at the full wave,
     k = 2; the plain version's time per call; the bound: the bytes a call
     delivers over the SM load path's rate (the table stays on chip);
 38. D2, the member tests and the warp votes: the sphere, box, `any` and
     `or_tree` kinds from the same run and at each kind's full wave (ns
     per call), both outputs against the plain version, bit for bit, at
     8,192 threads, k = 64 and 1064, and at the full wave, k = 64; the
     plain version's time per call;
 39. K1f's DDA row: the stats launch with it on final_scene 800×800×1,
     depth 50 (phase 33's size), its sums bit-equal to the production
     kernel's, its five counters equal to the plain version's, its other
     four equal to phase 33's launch without it, the per-ray skip share (1
     − crossings / box tests); then `kernel_stats final_scene` (its main
     path, 400×400×32), which must print the share;
 40. K1 at the main path's own launches: every K1 launch of the command
     line runs of phases 5, 11-17, 19, 32 and 35, of phase 30's
     1280×720 render and of phase 39's kernel_stats was recorded with its
     operands and arguments (`recording`: the cost probe, each chunk of
     `render_kernel`'s lane budget, each pixel table); each is made again
     (`replay`): timed, counted by a stats launch of the same arguments
     (occupancy, tail share), its sums held bit for bit to the same
     samples launched in chunks of the size its scene's comparison phase
     holds to trace_plain, and bounded; cornell_box_baseline's first
     launch (800×800, 104 samples) is also held bit for bit to
     trace_plain.
Every command-line phase prints its per-phase seconds, the PPM encode
included. Then the kernel table and, as the last line, the device
summary. Each row of the table carries the kernel's bound: the larger of
the bytes it must move over the card's memory rate and the f32 operations
this run's paths needed over the card's f32 rate (`bound`). A K1 row's
launches are those its main path counted, and its ms and bound_ms are
their means per launch from phase 40 (`at_main_path`), with the totals
and shapes under "main_path"; a K1 row also carries bound_ms_one_level,
its bound with the cull counted as a slab test of every leaf a segment
(the one-level cull's work; `k1_bound`); the comparison's time and bound stand
under "comparison", and plain_ms is the plain version's time there, at
plain_spp samples.

Any failure exits non-zero before the last line. Without CUDA, or run
outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# cornell_box_baseline's mean gamma-space image value as the JAX package's
# XLA tier renders it on the CPU at 80×80, 500 spp, depth 50, seed 0
# (raytracing_rust_tpu.render.render with the preset's camera). The band is
# ±5%: tighter than the ±20% of tests/test_scene_stats.py, which renders
# at 8 spp; at 500 spp the Monte Carlo spread of the mean is far smaller.
CORNELL_MEAN = 0.22455
CORNELL_BAND = (0.95 * CORNELL_MEAN, 1.05 * CORNELL_MEAN)
# the same for random_spheres (128×72, 100 spp, depth 50, seed 0) and
# two_spheres (128×72, 10 spp, depth 50, seed 0), each at its preset's spp
RANDOM_SPHERES_MEAN = 0.5859978795051575
TWO_SPHERES_MEAN = 0.5419976115226746
# the Next Week presets, each at its preset's spp, depth 50, seed 0, at
# half its width and height: the mean of a gamma-space image falls as the
# pixels shrink (√ of a mean exceeds the mean of √s), by 4.6% for
# simple_light between a tenth and the full size; printed by
# `PYTHONPATH=. python tests/test_torch_textures.py`
NEXT_WEEK_MEANS = {"two_perlin_spheres": 0.603892982006073,
                   "simple_light": 0.14997467398643494,
                   "earth": 0.7475132346153259,
                   "cornell_smoke": 0.297309011220932}
# final_scene at 128×128, its preset's 100 spp, depth 50, seed 0: the mean
# of this scene's gamma-space image moves with size and spp (0.135 at
# 32×32×4, 0.203 at 64×64×16), so the card renders at this size and spp
# for the check; printed by `PYTHONPATH=. python tests/test_torch_final.py`
FINAL_SCENE_MEAN = 0.26402905583381653
FINAL_SCENE_CHECK = (128, 128)
# lattice_scene through tools/tpu_parity.py's camera at 128×72, 100 spp,
# depth 50, seed 0; printed by `PYTHONPATH=. python
# tests/test_torch_lattice.py`
LATTICE_MEAN = 0.06340471655130386
LATTICE_CHECK = (128, 72, 100)

# NVIDIA H100 SXM published peaks (NVIDIA's data sheet, at 700 W): HBM
# bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# csrc/grad.cu, counted from its source: per alive lane bounce of K2 the
# fixed work, each prim's test and a miss's sky; a checker hit's pick (3
# sinf); a metal's reflect with fuzz (on its scatters and absorptions);
# a glass scatter's refract set-up and Schlick, then its refract or its
# reflect. K3 rebuilds K2's bounces from the winner tape (K2's work without
# the prim tests and the sky), then per lane bounce sweeps back the color
# chain (keep, emission, the warp sums of the light and albedo columns, and
# of the odd albedo with a checker); with the sky also, per lane bounce,
# |d|² and the warp sums of the geometric columns (and of C_PARAM with
# metal or glass), and a miss's sky, a sphere winner's or a rect winner's
# geometric chain, and a metal scatter's, a refraction's or a glass
# reflection's adjoint
K2_OPS = dict(segment=60, prim=16, sky=27, checker=10, metal=35, glass=49,
              refract=16, reflect=7, adjoint=61, adjoint_odd=30,
              adjoint_sky=39, adjoint_param=10, adjoint_miss=52,
              adjoint_sphere=113, adjoint_rect=54, adjoint_metal=73,
              adjoint_refract=112, adjoint_reflect=37)


def k2_k3_bound(counts: dict, n_prims: int, n: int, feats,
                tape: bool = True) -> tuple[dict, dict, dict]:
    """(K2's, K3's, the pair's) bound on the paths `trace_tiles_plain`
    counted: its segments (lane bounces), ghost entries, misses, sphere and
    checker hits, scatters, metal scatters and absorptions, glass scatters,
    refractions and the glass scatters that read draw word 3. Operations
    from K2_OPS. Bytes: the record and each lane's o, d read once, draw
    words 0-2 read on a lambertian or metal scatter and a metal absorption,
    word 3 on a glass scatter that can refract, K2's radiance written, and
    with `tape` its winner tape (8 bytes an entry: the segments and the
    ghosts); K3 reads the tape and the cotangent besides and writes d_o,
    d_d and d_rec once. K3's operations are the rebuild (K2's without the
    prim tests and the sky) and the adjoint; the pair (a training step's
    forward and adjoint: K2's work with the tape, the adjoint's alone,
    and both kernels' bytes) counts the forward once and the adjoint
    once."""
    c = {k: counts.get(k, 0) for k in (
        "segments", "ghosts", "misses", "sphere_hits", "checker_hits",
        "scatters", "metal_scatters", "metal_absorbs", "glass_scatters",
        "refracts", "u3_reads")}
    seg, miss, sph = c["segments"], c["misses"], c["sphere_hits"]
    glass, refr = c["glass_scatters"], c["refracts"]
    metal = c["metal_scatters"]
    rebuild = (seg * K2_OPS["segment"]
               + c["checker_hits"] * K2_OPS["checker"]
               + (metal + c["metal_absorbs"]) * K2_OPS["metal"]
               + glass * K2_OPS["glass"] + refr * K2_OPS["refract"]
               + (glass - refr) * K2_OPS["reflect"])
    k2 = (rebuild + seg * n_prims * K2_OPS["prim"]
          + (miss * K2_OPS["sky"] if "sky" in feats else 0))
    adjoint = seg * K2_OPS["adjoint"]
    if "checker" in feats:
        adjoint += seg * K2_OPS["adjoint_odd"]
    if "sky" in feats:
        adjoint += (seg * K2_OPS["adjoint_sky"]
                    + miss * K2_OPS["adjoint_miss"]
                    + sph * K2_OPS["adjoint_sphere"]
                    + (seg - miss - sph) * K2_OPS["adjoint_rect"]
                    + metal * K2_OPS["adjoint_metal"]
                    + refr * K2_OPS["adjoint_refract"]
                    + (glass - refr) * K2_OPS["adjoint_reflect"])
        if {"metal", "diel"} & set(feats):
            adjoint += seg * K2_OPS["adjoint_param"]
    rec_bytes = 4 * n_prims * 35   # ops/grad.py REC_C f32 columns
    draws = 3 * (c["scatters"] - glass + c["metal_absorbs"]) + c["u3_reads"]
    read = rec_bytes + 4 * 6 * n + 4 * draws
    tape_bytes = 8 * (seg + c["ghosts"])
    k2_bytes = read + 4 * 3 * n + (tape_bytes if tape else 0)
    k3_bytes = read + tape_bytes + 4 * 3 * n + 4 * 6 * n + rec_bytes
    return (bound(k2, k2_bytes), bound(rebuild + adjoint, k3_bytes),
            bound(k2 + adjoint, k2_bytes + k3_bytes))


def bound(ops: float, nbytes: float,
          bytes_per_s: float = HBM_BYTES_PER_S) -> dict:
    """The least time the card could take: the larger of bytes over the
    rate of the memory they come from (device memory unless given) and
    operations over its f32 rate."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / bytes_per_s
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def k1_bound(ops, counts: dict, n_pix: int, n_samples: int) -> dict:
    """K1's bound on this run's paths: the operations and bytes of
    `tracer.k1_work` (trace_plain's counts times tracer.K1_OPS, the
    operations of csrc/tracer.cu per item, counted from its source), the
    cull's slab tests those of an exact two-level cull; beside it, as
    bound_ms_one_level, the same with a slab test of every leaf a segment
    (the one-level cull's work, the yardstick of the rows before it)."""
    from raytracing_rust_tpu_torch.ops.tracer import k1_work
    return dict(**bound(*k1_work(ops, counts, n_pix, n_samples)),
                bound_ms_one_level=bound(*k1_work(
                    ops, counts, n_pix, n_samples,
                    one_level=True))["bound_ms"])


@contextlib.contextmanager
def recording(log: list, counters):
    """Every K1 launch made through `tracer.trace` inside the block, appended
    to `log` as a dict: its operands (`ops`), its keyword arguments (`kw`,
    the stats buffer left out), whether it carried a stats buffer
    (`stats`), and the launch counters it moved (`counted`: the keys of
    `counters()` that grew across the call). The launch is the wrapper's
    own; only its arguments are kept."""
    from raytracing_rust_tpu_torch.ops import tracer
    real = tracer.trace

    def logged(ops, sums, **kw):
        before = counters()
        out = real(ops, sums, **kw)
        after = counters()
        log.append(dict(ops=ops, stats=kw.get("stats") is not None,
                        kw={k: v for k, v in kw.items() if k != "stats"},
                        counted=[k for k in after if after[k] > before[k]]))
        return out
    tracer.trace = logged
    try:
        yield log
    finally:
        tracer.trace = real


def replay(launch: dict, held: dict):
    """One K1 launch of `recording`, made again on the same operands and
    arguments → (its figures, its sums). Its ms: CUDA events, two launches
    after a warm-up, on fresh sums (and, for a stats launch, a fresh stats
    buffer). Its counters: the stats launch it is, or a stats launch of the
    same arguments. Its sums held bit for bit to the same samples launched
    in chunks of held["spp"] (the samples its scene's comparison holds to
    trace_plain; the production instantiation). Its bound: held["work"]
    (trace_plain's counts on that comparison) scaled by this launch's
    segments over the comparison's, on this launch's pixels and samples."""
    import torch
    from raytracing_rust_tpu_torch import kernel_stats
    from raytracing_rust_tpu_torch.ops import tracer
    ops, kw = launch["ops"], launch["kw"]
    nx, ny, n, s0 = kw["nx"], kw["ny"], kw["n_samples"], kw["sample0"]
    n_pix, dev = nx * ny, ops.rec.device
    pix, kpix, dda = kw.get("pix"), kw.get("kpix", 1), kw.get("dda", False)

    def zeros():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=dev)

    whole, st = zeros(), tracer.new_stats(nx, ny, dev, pix, kpix, dda=dda)
    if launch["stats"]:
        ms = cuda_ms(lambda: tracer.trace(ops, whole.zero_(),
                                          stats=st.zero_(), **kw), reps=2)
    else:
        ms = cuda_ms(lambda: tracer.trace(ops, whole.zero_(), **kw), reps=2)
        tracer.trace(ops, zeros(), stats=st, **kw)
    parts, step = zeros(), held["spp"]
    prod = {k: v for k, v in kw.items() if k != "dda"}
    for s in range(s0, s0 + n, step):
        tracer.trace(ops, parts, **{**prod, "sample0": s,
                                    "n_samples": min(step, s0 + n - s)})
    occ = kernel_stats.summarize(st, n_pix, n, kpix, dda)
    work = held["work"]
    scale = occ["segments"] / (work["segments"] + work["walk"])
    return dict(
        shape=[ny, nx, n], sample0=s0, kpix=kpix, table=pix is not None,
        stats=launch["stats"], dda=dda, counted=launch["counted"], ms=ms,
        **k1_bound(ops, {k: v * scale for k, v in work.items()}, n_pix, n),
        segments=occ["segments"], warp_steps=occ["warp_steps"],
        occupancy=occ["occupancy"], tail_share=occ["tail_share"],
        chunk_spp=step, equals_chunks=bool(torch.equal(whole, parts))), whole


def at_main_path(row: dict, replayed: list, counter: str,
                 launches: int) -> dict:
    """A K1 row of the kernel table: `row`, the comparison against
    trace_plain (its spp, max_abs_err, ms, plain_ms and bound), restated at
    the main path's launches that moved `counter` (`replay`'s figures): ms
    and bound_ms per launch, their mean; the totals, the launch shapes and
    the occupancy (segments over 32 × warp steps, summed) under
    "main_path"; the comparison's ms and bound under "comparison", and
    plain_ms at plain_spp, the comparison's samples."""
    mine = [r for r in replayed if counter in r["counted"]]
    check(len(mine) == launches, f"{counter}: {launches} launches counted, "
          f"{len(mine)} recorded")
    ms, b = sum(r["ms"] for r in mine), sum(r["bound_ms"] for r in mine)
    b1 = sum(r["bound_ms_one_level"] for r in mine)
    steps = sum(r["warp_steps"] for r in mine)
    return dict(
        max_abs_err=row["max_abs_err"], ms=ms / len(mine),
        bound_ms=b / len(mine),
        bound_by=max(mine, key=lambda r: r["bound_ms"])["bound_by"],
        bound_ms_one_level=b1 / len(mine),
        plain_ms=row["plain_ms"], plain_spp=row["spp"],
        main_path=dict(
            launches=len(mine), ms=ms, bound_ms=b, bound_ms_one_level=b1,
            shapes=[[*r["shape"], r["kpix"], r["stats"]] for r in mine],
            occupancy=sum(r["segments"] for r in mine) / (32 * steps)),
        comparison=dict(spp=row["spp"], ms=row["ms"],
                        bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                        bound_ms_one_level=row["bound_ms_one_level"]))


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def hold_k3_columns(phase: str, what: str, k3, p3, sky: bool,
                    **extra) -> float:
    """K3's (d_rec, d_o, d_d) against autograd's through the twin: each
    d_rec column within 1e-4 of its own scale, the same columns live, d_o
    and d_d within 1e-4 of their scale (exact zeros without the sky), all
    finite; emitted as one line → d_rec's max abs error."""
    import torch
    cols, live_k, live_p = {}, [], []
    for col in range(k3[0].shape[1]):
        a, b = k3[0][:, col], p3[0][:, col]
        if a.any():
            live_k.append(col)
        scale = float(b.abs().max())
        if scale > 0:
            live_p.append(col)
            cols[col] = dict(scale=scale,
                             err_over_scale=float((a - b).abs().max()) / scale)
    leaf = {}
    for name, a, b in (("d_o", k3[1], p3[1]), ("d_d", k3[2], p3[2])):
        scale = float(b.abs().max())
        leaf[name] = dict(scale=scale, err_over_scale=(
            float((a - b).abs().max()) / scale if scale else None),
            kernel_max_abs=float(a.abs().max()))
    err = float((k3[0] - p3[0]).abs().max())
    finite = all(bool(torch.isfinite(x).all()) for x in (*k3, *p3))
    emit(phase, d_rec_columns=cols, live_columns=live_k,
         autograd_live_columns=live_p, finite=finite, d_rec_max_abs_err=err,
         **leaf, **extra)
    check(finite, f"{what}: a gradient is not finite")
    check(live_k == live_p, f"{what}: live columns {live_k} vs {live_p}")
    check(all(v["err_over_scale"] <= 1e-4 for v in cols.values()),
          f"{what}: a d_rec column off by more than 1e-4 of its scale: {cols}")
    if sky:
        check(all(v["scale"] > 0 and v["err_over_scale"] <= 1e-4
                  for v in leaf.values()), f"{what}: d_o/d_d off: {leaf}")
    else:
        check(all(v["scale"] == 0 and v["kernel_max_abs"] == 0
                  for v in leaf.values()), f"{what}: d_o/d_d not zero: {leaf}")
    return err


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls, after one
    warm-up call unless warm is False, by CUDA events."""
    import torch
    if warm:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tape_matches(tape, want) -> bool:
    """K2's winner tape equals the plain tape on every entry the plain tape
    defines (the rest are TAPE_NONE there and unwritten by K2)."""
    import torch
    from raytracing_rust_tpu_torch.ops import grad
    defined = want[:, 0] != grad.TAPE_NONE
    return all(bool(torch.equal(tape[:, r][defined], want[:, r][defined]))
               for r in (0, 1))


def device_ops(fn, calls: int = 3) -> dict | None:
    """The device ops (kernels, copies, memsets) that `calls` calls of fn
    run, by name → count, from torch.profiler after a warm-up call; None
    where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.key != "Activity Buffer Request":
            ops[e.key] = e.count
    return ops or None


def grad_kernel_times(phase: str, rec, o, d, u, ct, cfg, md: int,
                      **extra) -> dict:
    """Phases 9, 23, 28: K2 without and with its tape and K3 on that tape,
    by CUDA events over 20 calls through the wrappers and as bare launches
    on preallocated outputs (`grad.bare_launches`); each kernel's
    registers, stack frame, blocks an SM, the grid and its waves; the
    device ops of one wrapper call (the kernel alone: checked); the pair
    of a training step (two K2, one with the tape, and one K3). Emitted
    as one line → the dict."""
    from raytracing_rust_tpu_torch.ops import grad
    _, tape = grad.grad_fwd(rec, o, d, u, cfg, md, tape=True)
    wrap = {"k2": lambda: grad.grad_fwd(rec, o, d, u, cfg, md),
            "k2_tape": lambda: grad.grad_fwd(rec, o, d, u, cfg, md,
                                             tape=True),
            "k3": lambda: grad.grad_bwd(rec, o, d, u, ct, cfg, md,
                                        tape=tape)}
    bare = dict(zip(wrap, grad.bare_launches(rec, o, d, u, ct, cfg, md)))
    out = {f"{k}_ms": cuda_ms(f, reps=20) for k, f in wrap.items()}
    out.update({f"{k}_bare_ms": cuda_ms(f, reps=20) for k, f in bare.items()})
    out["pair_ms"] = out["k2_ms"] + out["k2_tape_ms"] + out["k3_ms"]
    out["pair_bare_ms"] = (out["k2_bare_ms"] + out["k2_tape_bare_ms"]
                           + out["k3_bare_ms"])
    occ = grad.kernel_occupancy(rec.shape[0])
    mat = int(bool({"metal", "diel", "checker"} & set(cfg[1])))
    tiles = -(-o.shape[0] // grad.GRAD_THREADS)
    for k, inst in (("k2", f"grad_fwd<{mat}>"), ("k3", f"grad_bwd<{mat}>")):
        q = occ[inst]
        resident = q["blocks_per_sm"] * q["sms"]
        grid = min(tiles, resident)
        out[f"{k}_kernel"] = dict(
            instantiation=inst, **q, resident_blocks=resident,
            tiles_of_128_lanes=tiles, grid=grid, waves=grid / resident,
            tiles_per_block=tiles / grid)
    ops = {k: device_ops(f) for k, f in wrap.items()}
    out["device_ops_per_3_calls"] = ops
    emit(phase, lanes=o.shape[0], depth=md, **out, **extra)
    for k, v in ops.items():
        name = "grad_fwd" if k.startswith("k2") else "grad_bwd"
        check(v is None or (len(v) == 1 and name in next(iter(v))
                            and next(iter(v.values())) == 3),
              f"{phase}: a {k} call runs other device ops: {v}")
    return out


def grad_row_facts(gt: dict, k: str) -> dict:
    """The kernels line's extra keys of a K2 or K3 row from
    `grad_kernel_times`: the bare launch's ms (K2's with its tape), K2's
    ms without the tape, the registers, stack frame, blocks an SM and waves,
    and on K3's row the pair of a training step."""
    q = gt[f"{k}_kernel"]
    out = dict(bare_ms=gt["k2_tape_bare_ms" if k == "k2" else "k3_bare_ms"],
               registers=q["registers"], stack_bytes=q["stack_bytes"],
               blocks_per_sm=q["blocks_per_sm"], waves=q["waves"],
               tiles_per_block=q["tiles_per_block"])
    if k == "k2":
        out.update(no_tape_ms=gt["k2_ms"], no_tape_bare_ms=gt["k2_bare_ms"])
    else:
        out.update(pair_ms=gt["pair_ms"], pair_bare_ms=gt["pair_bare_ms"])
    return out


def grad_probe_scene(dev):
    """The JAX fused tier's probe scene: a floor, a red wall, a flipped
    light, a metal sphere (fuzz 0.2), a glass sphere (1.5), a
    lambertian sphere, a rotated, translated cube; 12 prims."""
    from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
    b = SceneBuilder(background=BG_SKY)
    b.rect("zx", -3, -3, 3, 3, 0.0,
           b.lambertian(b.solid(0.73, 0.73, 0.73)))
    b.rect("yz", 0, -3, 6, 3, -3.0,
           b.lambertian(b.solid(0.65, 0.05, 0.05)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    b.sphere((-1.0, 0.8, 0.6), 0.7, b.dielectric(1.5))
    b.sphere((0.0, 0.6, -1.2), 0.6,
             b.lambertian(b.solid(0.2, 0.5, 0.8)))
    xf = b.transform(offset=(0.4, 0.0, 0.2), rotate_axis="y",
                     angle_deg=20.0)
    b.cube((-2.4, 0.0, -1.4), (-1.4, 1.6, -0.4),
           b.lambertian(b.solid(0.4, 0.6, 0.3)), xform=xf)
    return b.build(dev)


def grad_checker_scene(dev):
    """A checker floor at y = 0.37, an emissive checker sphere and a
    lambertian sphere under the sky."""
    from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
    b = SceneBuilder(background=BG_SKY)
    b.rect("zx", -4, -4, 4, 4, 0.37, b.lambertian(b.checker(
        b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))))
    b.sphere((0.0, 1.37, 0.0), 1.0, b.diffuse_light(b.checker(
        b.solid(3.0, 0.5, 0.5), b.solid(0.5, 3.0, 0.5))))
    b.sphere((2.2, 1.1, 0.3), 0.8, b.lambertian(b.solid(0.3, 0.4, 0.8)))
    return b.build(dev)


def material_phases(dev, reset_launches, n: int = 4096 * 64):
    """Phases 24-28: K2 and K3 on metal, glass and the checker against
    their plain versions, the path into the scene leaves with its launch
    counts, and the times → (per (scene, depth): record, config, draws,
    the paths' work and the errors; the path's launches; the times and
    bounds of K2 and K3 on probe_scene at depth 6)."""
    import dataclasses
    import numpy as np
    import torch
    from raytracing_rust_tpu_torch.models.scene import TEX_CHECKER
    from raytracing_rust_tpu_torch.ops import grad

    # -- 24-26. K2 and K3 with metal, glass and the checker vs plain at the
    # training step's full width, rays as tools/tpu_parity.py's fused-tier
    # check makes them, Philox draws: probe_scene (24 K2, 25 K3) and the
    # checker scene (26), each at depth 6 and at the tape's full 16
    r = np.random.default_rng(3)
    d = torch.from_numpy(np.stack(
        [r.uniform(-0.7, 0.7, n), r.uniform(-0.45, 0.25, n), -np.ones(n)],
        -1).astype(np.float32)).to(dev)
    o = torch.tensor([0.0, 2.0, 8.0], device=dev).expand(n, 3).contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ct = torch.rand(n, 3, generator=g, device=dev)
    mscenes = {"probe_scene": grad_probe_scene(dev),
               "checker": grad_checker_scene(dev)}
    material = {}
    for sname, md in (("probe_scene", 6), ("probe_scene", 16),
                      ("checker", 6), ("checker", 16)):
        mcfg = grad.fast_grad_config(mscenes[sname])
        mrec = grad.fast_grad_record(mscenes[sname]).detach()
        u = grad.fast_draws(7, n, md + 1, dev)
        k2, k2_tape = grad.grad_fwd(mrec, o, d, u, mcfg, md, tape=True)
        work = {}
        p2, p2_tape = grad.trace_tiles_plain(mrec, o, d, u, mcfg, md,
                                             counts=work, tape=True)
        torch.cuda.synchronize()
        tape_ok = tape_matches(k2_tape, p2_tape)
        err = float((k2 - p2).abs().max())
        bit_equal = float((k2 == p2).all(dim=1).double().mean())
        emit("k2b_material_vs_plain", scene=sname, feats=sorted(mcfg[1]),
             kinds="".join(mcfg[0]), lanes=n, depth=md,
             lanes_bit_equal=bit_equal, max_abs_err=err,
             kernel_channel_means=k2.mean(dim=0).tolist(),
             plain_channel_means=p2.mean(dim=0).tolist(), work=work,
             tape_bit_equal=tape_ok)
        check(bool(torch.isfinite(k2).all()) and float(p2.sum()) > 0,
              f"K2 {sname} depth {md}: radiance not finite or zero")
        check(tape_ok, f"K2 {sname} depth {md}: the tape differs from plain")
        check(bool(torch.equal(k2, p2)), f"K2 {sname} depth {md}: "
              f"{bit_equal:.4%} of lanes bit-equal, max abs err {err}")
        del p2, p2_tape
        k3 = grad.grad_bwd(mrec, o, d, u, ct, mcfg, md, tape=k2_tape)
        again = grad.grad_bwd(mrec, o, d, u, ct, mcfg, md, tape=k2_tape)
        p3 = grad.trace_tiles_plain_vjp(mrec, o, d, u, ct, mcfg, md)
        torch.cuda.synchronize()
        repeat_ok = all(bool(torch.equal(a, b)) for a, b in zip(k3, again))
        k3_err = hold_k3_columns(
            "k3b_material_vs_autograd", f"K3 {sname} depth {md}", k3, p3,
            True, scene=sname, lanes=n, depth=md,
            d_rec_param_and_odd=k3[0][:, [grad.C_PARAM, grad.C_TEX_O,
                                          grad.C_TEX_O + 1,
                                          grad.C_TEX_O + 2]].tolist(),
            identical_in_two_launches=repeat_ok)
        check(repeat_ok, f"K3 {sname} depth {md}: two launches differ")
        col = grad.C_PARAM if sname == "probe_scene" else grad.C_TEX_O
        check(bool(k3[0][:, col].any()),
              f"K3 {sname}: column {col} carries nothing")
        material[sname, md] = dict(rec=mrec, cfg=mcfg, u=u, work=work,
                                   k2_err=err, k3_err=k3_err)
        del p3, k3, again, k2_tape

    # -- 27. the path: the mean radiance's gradient through trace_fast (K2,
    # K3) into the six scene leaves, each scene at full width, depth 6,
    # against autograd through the plain version, leaf by leaf (the
    # counterpart of tools/tpu_parity.py's fast_grad_tier)
    leaves = ("prim_data", "mat_param", "tex_color", "xf_offset", "xf_sin",
              "xf_cos")

    def leaf_grads(name: str, fast: bool):
        scene = mscenes[name]
        sc = dataclasses.replace(scene, **{
            k: getattr(scene, k).clone().requires_grad_(True)
            for k in leaves})
        mcfg, u = material[name, 6]["cfg"], material[name, 6]["u"]
        if fast:
            rad = grad.trace_fast(sc, o, d, 0, max_depth=6, cfg=mcfg, u=u)
        else:
            rad = grad.trace_tiles_plain(grad.fast_grad_record(sc), o, d, u,
                                         mcfg, 6)
        got = torch.autograd.grad(rad.mean(), [getattr(sc, k)
                                               for k in leaves],
                                  allow_unused=True)
        return [torch.zeros_like(getattr(sc, k)) if x is None else x
                for k, x in zip(leaves, got)]

    reset_launches()
    fast = {name: leaf_grads(name, True) for name in mscenes}
    torch.cuda.synchronize()
    mat_launches = {"k2b_material_fwd": grad.K2_LAUNCHES,
                    "k3b_material_bwd": grad.K3_LAUNCHES}
    for name, scene in mscenes.items():
        want = leaf_grads(name, False)
        rel = {}
        for k, a, b in zip(leaves, fast[name], want):
            scale = max(float(b.abs().max()), 1e-3)
            rel[k] = dict(scale=scale, finite=bool(torch.isfinite(a).all()),
                          err_over_scale=float((a - b).abs().max()) / scale)
        gl = dict(zip(leaves, fast[name]))
        mats = scene.prim_material.long()
        child = scene.tex_child[scene.tex_type == TEX_CHECKER].flatten()
        child = child.long()
        emit("material_grad_path", scene=name, lanes=n, depth=6,
             launches=mat_launches, leaves=rel,
             mat_param=gl["mat_param"].tolist(),
             checker_children_tex_color=gl["tex_color"][child].tolist())
        check(all(v["finite"] and v["err_over_scale"] <= 1e-4
                  for v in rel.values()),
              f"{name}: a scene leaf's gradient is off: {rel}")
        if name == "probe_scene":   # the metal's fuzz, the glass's index
            check(bool((gl["mat_param"][mats[3:5]] != 0).all()),
                  "probe_scene: fuzz or ref_idx got no gradient")
        else:
            check(bool((gl["tex_color"][child].abs().amax(dim=1) > 0).all()),
                  "checker: a checker child's tex_color got no gradient")
    check(all(v > 0 for v in mat_launches.values()),
          f"a kernel of the material path never launched: {mat_launches}")
    del fast

    # -- 28. times on probe_scene at full width, depth 6
    m = material["probe_scene", 6]
    mrec, mcfg, u = m["rec"], m["cfg"], m["u"]
    mk2_bound, mk3_bound, mpair_bound = k2_k3_bound(m["work"], mrec.shape[0],
                                                    n, mcfg[1])
    mgt = grad_kernel_times(
        "material_grad_kernel_times", mrec, o, d, u, ct, mcfg, 6,
        scene="probe_scene", k2_bound=mk2_bound, k3_bound=mk3_bound,
        k2_no_tape_bound=k2_k3_bound(m["work"], mrec.shape[0], n, mcfg[1],
                                     tape=False)[0])
    mk2_ms, mk3_ms = mgt["k2_tape_ms"], mgt["k3_ms"]
    mp2_ms = cuda_ms(lambda: grad.trace_tiles_plain(mrec, o, d, u, mcfg, 6),
                     reps=3)
    mp3_ms = cuda_ms(lambda: grad.trace_tiles_plain_vjp(mrec, o, d, u, ct,
                                                        mcfg, 6), reps=3)
    emit("material_grad_times", scene="probe_scene", lanes=n, depth=6,
         k2_ms=mk2_ms, k3_ms=mk3_ms, plain_fwd_ms=mp2_ms,
         plain_fwd_bwd_ms=mp3_ms, k2_bound=mk2_bound, k3_bound=mk3_bound,
         pair_ms=mgt["pair_ms"], pair_bound=mpair_bound, work=m["work"],
         kernel_fwd_bwd_sample_paths_per_s=n / ((mk2_ms + mk3_ms) * 1e-3))
    return material, mat_launches, dict(
        k2=dict(ms=mk2_ms, plain_ms=mp2_ms, **mk2_bound,
                **grad_row_facts(mgt, "k2")),
        k3=dict(ms=mk3_ms, plain_ms=mp3_ms, **mk3_bound,
                **grad_row_facts(mgt, "k3"),
                pair_bound_ms=mpair_bound["bound_ms"]))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracing_rust_tpu_torch import cli
    from raytracing_rust_tpu_torch import inverse_render as ir
    from raytracing_rust_tpu_torch.models.builders import PRESETS
    from raytracing_rust_tpu_torch import kernel_stats, microbench
    from raytracing_rust_tpu_torch.ops import _build, grad, peak, tracer
    from raytracing_rust_tpu_torch.ops import microbench as mb
    from raytracing_rust_tpu_torch.utils.image_io import read_ppm
    from raytracing_rust_tpu_torch.utils.timers import Timers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def reset_launches():
        tracer.KERNEL_LAUNCHES = tracer.K1BE_LAUNCHES = 0
        tracer.K1C_LAUNCHES = tracer.K1D_LAUNCHES = 0
        tracer.K1E_BOX_LAUNCHES = tracer.K1D_WALK_LAUNCHES = 0
        tracer.K1_LATTICE_LAUNCHES = tracer.K1G_LAUNCHES = 0
        tracer.K1F_LAUNCHES = tracer.K1F_TABLE_LAUNCHES = 0
        tracer.K1F_STATS_LAUNCHES = tracer.K1F_DDA_LAUNCHES = 0
        grad.K2_LAUNCHES = grad.K3_LAUNCHES = 0
        peak.D3_LAUNCHES = 0
        mb.D1_LAUNCHES = mb.D2_LAUNCHES = 0

    def k1_launches():
        return {"k1a_static_trace": tracer.KERNEL_LAUNCHES,
                "k1be_sphere_trace": tracer.K1BE_LAUNCHES,
                "k1c_texture_trace": tracer.K1C_LAUNCHES,
                "k1d_media_trace": tracer.K1D_LAUNCHES,
                "k1e_box_trace": tracer.K1E_BOX_LAUNCHES,
                "k1d_walk_trace": tracer.K1D_WALK_LAUNCHES,
                "k1_lattice_trace": tracer.K1_LATTICE_LAUNCHES,
                "k1g_roulette_trace": tracer.K1G_LAUNCHES,
                "k1f_stats_trace": tracer.K1F_STATS_LAUNCHES,
                "k1f_balanced_trace": tracer.K1F_TABLE_LAUNCHES,
                "k1f_dda_stats": tracer.K1F_DDA_LAUNCHES}

    # the main path's K1 launches by run (`recording`), each run with the
    # key of `held` (its scene's comparison against trace_plain: the work
    # the paths needed and the samples held) that phase 40 replays it with
    main_runs, held = {}, {}

    def record(label: str, key: str):
        main_runs[label] = dict(held=key, launches=[])
        return recording(main_runs[label]["launches"], k1_launches)

    def run_cli(scene: str, *extra: str, label: str | None = None,
                key: str | None = None):
        """`render --scene <scene> --device cuda` at the preset's size, with
        the `extra` arguments (--nx/--ny, --rr-depth), every launch count
        set to 0 just before and read just after → (what to emit, the
        image). With a label, its K1 launches are recorded under it for
        phase 40, with held[key] (key: the scene unless given)."""
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, f"{scene}.ppm")
            argv = ["render", "--scene", scene, "--device", "cuda", "--out",
                    out, "--timers", *extra]
            buf = io.StringIO()
            reset_launches()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf), (
                    record(label, key or scene) if label
                    else contextlib.nullcontext()):
                rc = cli.main(argv)
            wall = time.perf_counter() - t
            launches = k1_launches()
            check(rc == 0, f"cli.main({argv}) returned {rc}")
            img = read_ppm(out)
        text = buf.getvalue()
        rate = re.search(r"\(([0-9.]+)M primary rays/s\)", text)
        timers = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^\s+(\S+)\s+([0-9.]+)s", text, re.M)}
        return dict(argv=argv, wall_seconds=wall,
                    render_primary_rays_per_s=(float(rate.group(1)) * 1e6
                                               if rate else None),
                    timers=timers, launches=launches,
                    image_shape=list(img.shape),
                    mean_luminance=float(img.mean())), img

    # -- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- 2. build
    t = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    ptxas, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            flags = re.search(r"(trace_k1)I((?:Lb[01]E)+)E", m.group(1))
            plain = re.search(r"(grad_fwd|grad_bwd)ILb([01])E", m.group(1))
            d3 = re.search(r"(fp32_peak)_kILi(\d+)ELb([01])E", m.group(1))
            d1 = re.search(r"(attr_read_k)ILb([01])ELi(\d+)E", m.group(1))
            d2 = re.search(r"(member_k)ILi(\d)E", m.group(1))
            fn = (f"{flags.group(1)}<"
                  f"{','.join(re.findall('[01]', flags.group(2)))}>"
                  if flags else f"{plain.group(1)}<{plain.group(2)}>"
                  if plain else f"{d3.group(1)}<{d3.group(2)},{d3.group(3)}>"
                  if d3 else f"{d1.group(1)}<{d1.group(2)},{d1.group(3)}>"
                  if d1 else f"{d2.group(1)}<{d2.group(2)}>"
                  if d2 else m.group(1))
        elif fn and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(fn, []).append(ln.split(" : ")[-1].strip())
    emit("build", seconds=time.perf_counter() - t, nvcc=_build._nvcc(),
         library=os.path.relpath(lib_path), ptxas=ptxas,
         k1_blocks_per_sm=tracer.k1_blocks_per_sm())

    # -- 3. kernel vs plain, cornell_box 800×800, 4 spp, depth 50
    p = PRESETS["cornell_box_baseline"]
    nx, ny = p.nx, p.ny
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(p.camera()), dev)

    def sums():
        return torch.zeros((3, nx * ny), dtype=torch.float64, device=dev)

    kw = dict(nx=nx, ny=ny, seed=0, max_depth=50)
    k = tracer.trace(ops, sums(), sample0=0, n_samples=4, **kw)
    pl = tracer.trace_plain(ops, sums(), sample0=0, n_samples=4, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k).all()), "kernel sums are not finite")
    agree = float(torch.isclose(k, pl, rtol=1e-4, atol=0.0)
                  .all(dim=0).double().mean())
    km, pm = k.mean(dim=1), pl.mean(dim=1)
    mean_rel = float(((km - pm).abs() / pm.abs()).max())
    max_abs_err = float((k - pl).abs().max())
    emit("kernel_vs_plain", shape=[ny, nx], spp=4, depth=50,
         pixels_within_rel_1e4=agree, kernel_channel_means=km.tolist(),
         plain_channel_means=pm.tolist(), channel_mean_max_rel=mean_rel,
         max_abs_err=max_abs_err)
    check(agree >= 0.99, f"only {agree:.4%} of pixels agree within 1e-4")
    check(mean_rel <= 1e-4, f"channel means differ by {mean_rel:.2e} rel")

    # -- 4. chunking invariance of the kernel
    chunked = {}
    for chunk in (2, 4):
        s = sums()
        for s0 in range(0, 4, chunk):
            tracer.trace(ops, s, sample0=s0, n_samples=chunk, **kw)
        chunked[chunk] = s
    same = bool(torch.equal(chunked[2], chunked[4]))
    emit("chunking", spp=4, chunks=[2, 4], bit_identical=same,
         equals_phase3=bool(torch.equal(chunked[4], k)))
    check(same, "spp_chunk 2 and 4 give different kernel sums")

    # -- 5. the main path, through the command line
    info, img = run_cli("cornell_box_baseline", label="cornell_box_baseline")
    lum = info["mean_luminance"]
    launches = info["launches"]
    cornell_trace_s = info["timers"].get("trace")
    emit("main_path", **info, wall_primary_rays_per_s=nx * ny * p.spp
         / info["wall_seconds"], band=list(CORNELL_BAND))
    check(launches["k1a_static_trace"] > 0,
          f"a kernel of the path never launched: {launches}")
    check(img.shape == (ny, nx, 3) and bool(((img >= 0) & (img <= 1)).all()),
          "image has the wrong shape or range")
    check(CORNELL_BAND[0] < lum < CORNELL_BAND[1],
          f"mean luminance {lum:.4f} outside {CORNELL_BAND}")

    # kernel and plain version at 800×800×8 spp, depth 50
    s8 = sums()
    k_ms_k1a = cuda_ms(lambda: tracer.trace(ops, s8.zero_(), sample0=0,
                                            n_samples=8, **kw), reps=5)
    p_ms = cuda_ms(lambda: tracer.trace_plain(ops, s8.zero_(), sample0=0,
                                              n_samples=8, **kw), reps=2)
    c8 = {}
    tracer.trace_plain(ops, s8.zero_(), sample0=0, n_samples=8, counts=c8,
                       **kw)
    k1a_bound = k1_bound(ops, c8, nx * ny, 8)
    k1a = dict(spp=8, max_abs_err=max_abs_err, ms=k_ms_k1a, plain_ms=p_ms,
               **k1a_bound)
    # the main path's launches are held to 4-sample chunks, phase 3's
    held["cornell_box_baseline"] = dict(work=c8, spp=4)
    rays = nx * ny * 8
    emit("kernel_vs_plain_time", shape=[ny, nx], spp=8, depth=50,
         kernel_ms=k_ms_k1a, plain_ms=p_ms, work=c8, **k1a_bound,
         kernel_primary_rays_per_s=rays / (k_ms_k1a * 1e-3),
         plain_primary_rays_per_s=rays / (p_ms * 1e-3))

    # -- 6. K2 vs plain at the training step's full width
    kw = dict(nx=200, ny=200, spp=64, block=4096, max_depth=6)
    target = ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT, device=dev)
    cfg = grad.fast_grad_config(target)
    rec = grad.fast_grad_record(target).detach()
    o, d, u = ir.step_inputs(ir.camera(dev), 0, device=dev, **kw)
    n = o.shape[0]
    k2, k2_tape = grad.grad_fwd(rec, o, d, u, cfg, 6, tape=True)
    c2 = {}
    p2, p2_tape = grad.trace_tiles_plain(rec, o, d, u, cfg, 6, counts=c2,
                                         tape=True)
    k2_bound, k3_bound, pair_bound = k2_k3_bound(c2, rec.shape[0], n,
                                                 cfg[1])
    k2_notape_bound = k2_k3_bound(c2, rec.shape[0], n, cfg[1],
                                  tape=False)[0]
    torch.cuda.synchronize()
    tape_ok = tape_matches(k2_tape, p2_tape)
    check(bool(torch.isfinite(k2).all()), "K2 radiance is not finite")
    agree = float(torch.isclose(k2, p2, rtol=1e-4, atol=0.0)
                  .all(dim=1).double().mean())
    km, pm = k2.mean(dim=0), p2.mean(dim=0)
    mean_rel = float(((km - pm).abs() / pm.abs()).max())
    k2_err = float((k2 - p2).abs().max())
    emit("k2_vs_plain", lanes=n, depth=6, lanes_within_rel_1e4=agree,
         kernel_channel_means=km.tolist(), plain_channel_means=pm.tolist(),
         channel_mean_max_rel=mean_rel, max_abs_err=k2_err, work=c2,
         bit_equal=bool(torch.equal(k2, p2)), tape_bit_equal=tape_ok)
    check(agree >= 0.99, f"K2: only {agree:.4%} of lanes agree within 1e-4")
    check(tape_ok, "K2's winner tape differs from the plain tape")
    check(mean_rel <= 1e-4, f"K2: channel means differ by {mean_rel:.2e}")

    # -- 7. K3 vs autograd of the plain version, same inputs
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ct = torch.rand(n, 3, generator=g, device=dev)
    k3 = grad.grad_bwd(rec, o, d, u, ct, cfg, 6, tape=k2_tape)
    again = grad.grad_bwd(rec, o, d, u, ct, cfg, 6, tape=k2_tape)
    p3 = grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, 6)
    torch.cuda.synchronize()
    repeat_ok = all(bool(torch.equal(a, b)) for a, b in zip(k3, again))
    scale = float(p3[0].abs().max())
    k3_err = float((k3[0] - p3[0]).abs().max())
    lanes_ok = [float(torch.isclose(a, b, rtol=1e-4, atol=0.0)
                      .all(dim=1).double().mean())
                for a, b in zip(k3[1:], p3[1:])]
    emit("k3_vs_autograd", lanes=n, depth=6, d_rec_max_abs_err=k3_err,
         d_rec_scale=scale, d_rec_err_over_scale=k3_err / scale,
         d_o_lanes_within_rel_1e4=lanes_ok[0],
         d_d_lanes_within_rel_1e4=lanes_ok[1],
         d_rec_light_and_albedo=k3[0][:, [grad.C_LIGHT, grad.C_TEX_E,
                                          grad.C_TEX_E + 1,
                                          grad.C_TEX_E + 2]].tolist(),
         identical_in_two_launches=repeat_ok)
    check(repeat_ok, "K3: two launches on the same operands differ")
    check(scale > 0 and k3_err <= 1e-4 * scale,
          f"K3: d_rec off by {k3_err:.3e} at scale {scale:.3e}")
    check(min(lanes_ok) >= 0.99, f"K3: d_o/d_d lanes within 1e-4: {lanes_ok}")
    del p3, again

    # -- 8. the training path
    buf = io.StringIO()
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ir.main(["--device", "cuda", "--steps", "40"])
    wall = time.perf_counter() - t
    train_launches = {"k2_grad_fwd": grad.K2_LAUNCHES,
                      "k3_grad_bwd": grad.K3_LAUNCHES}
    text = buf.getvalue()
    rec_line = re.search(r"max abs err ([0-9.]+)\), emission ([0-9.]+) "
                         r"\(err ([0-9.]+)\)", text)
    step_line = re.search(r"step time: ([0-9.]+)s", text)
    emit("train_path", argv=["--device", "cuda", "--steps", "40"], rc=rc,
         wall_seconds=wall, launches=train_launches,
         albedo_max_abs_err=float(rec_line.group(1)) if rec_line else None,
         emission=float(rec_line.group(2)) if rec_line else None,
         emission_err=float(rec_line.group(3)) if rec_line else None,
         median_step_seconds=float(step_line.group(1)) if step_line else None,
         log=text.splitlines())
    check(all(v > 0 for v in train_launches.values()),
          f"a kernel of the training path never launched: {train_launches}")
    check(rc == 0 and rec_line is not None,
          f"inverse_render.main returned {rc}")

    # -- 9. times at the training step's full width
    gt = grad_kernel_times("grad_kernel_times", rec, o, d, u, ct, cfg, 6,
                           scene="inverse_render", k2_bound=k2_bound,
                           k2_no_tape_bound=k2_notape_bound,
                           k3_bound=k3_bound)
    k2_ms, k3_ms = gt["k2_tape_ms"], gt["k3_ms"]
    p2_ms = cuda_ms(lambda: grad.trace_tiles_plain(rec, o, d, u, cfg, 6),
                    reps=3)
    p3_ms = cuda_ms(lambda: grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg,
                                                       6), reps=3)
    scene = ir.build_scene(ir.START_ALBEDO, ir.START_EMIT, device=dev)
    light_tex, box_tex = ir.param_tex_rows(scene)
    albedo = torch.tensor(ir.START_ALBEDO, device=dev, requires_grad=True)
    emission = torch.tensor(ir.START_EMIT, device=dev, requires_grad=True)

    cam = ir.camera(dev)

    def step():
        oo, dd, uu = ir.step_inputs(cam, 1, device=dev, **kw)
        ir.path_matched_loss(target, scene, light_tex, box_tex, albedo,
                             emission, oo, dd, uu, block=4096, spp=64,
                             max_depth=6, cfg=cfg).backward()
    step_ms = cuda_ms(step, reps=10)
    emit("grad_times", lanes=n, depth=6, k2_ms=k2_ms, k3_ms=k3_ms,
         plain_fwd_ms=p2_ms, plain_fwd_bwd_ms=p3_ms, step_ms=step_ms,
         pair_ms=gt["pair_ms"], pair_bound=pair_bound,
         kernel_fwd_bwd_sample_paths_per_s=n / ((k2_ms + k3_ms) * 1e-3),
         plain_fwd_bwd_sample_paths_per_s=n / (p3_ms * 1e-3),
         step_candidate_sample_paths_per_s=n / (step_ms * 1e-3))

    # -- 10, 13. K1B's sections vs plain at each preset's size, 2 spp,
    # depth 50
    def within(a, b):
        return float(torch.isclose(a, b, rtol=1e-4, atol=0.0)
                     .all(dim=0).double().mean())

    def hold_culls(scene: str, ops, k, pl, kw) -> dict:
        """The two-level cull's sums k against the one-level cull (the
        super rows emptied) and no cull (the leaves emptied), bit for bit;
        each one's time."""
        out = {}
        for name, o in (
                ("one_level", dataclasses.replace(
                    ops, sups=ops.sups[:0], bsups=ops.bsups[:0])),
                ("without_cull", dataclasses.replace(
                    ops, leaves=ops.leaves[:0], bleaves=ops.bleaves[:0]))):
            ko = tracer.trace(o, torch.zeros_like(k), **kw)
            s_o = torch.zeros_like(k)
            out[f"pixels_within_rel_1e4_{name}"] = within(ko, pl)
            out[f"equal_{name}"] = bool(torch.equal(k, ko))
            out[f"kernel_{name}_ms"] = cuda_ms(
                lambda: tracer.trace(o, s_o.zero_(), **kw), reps=1)
            del ko
            check(out[f"equal_{name}"], f"{scene}: the two-level cull's sums "
                  f"differ from the {name.replace('_', ' ')} kernel's")
        return out

    def hold(phase: str, scene: str, built=None, n_samples: int = 2,
             rr_depth=None, key: str | None = None) -> dict:
        """The K1B kernel against trace_plain on `scene` at its preset's
        size (or on built = (scene tables, camera, nx, ny)), n_samples
        spp, depth 50, roulette from rr_depth: gates, times, the paths'
        work and the bound, emitted as one line; returns what the table
        needs. The work and the samples held go to held[key] (the scene
        unless given)."""
        if built is None:
            p = PRESETS[scene]
            built = (p.build(), p.camera(), p.nx, p.ny)
        tables, camera, nx, ny = built
        srec = tracer.build_scene_record(tables)
        ops = tracer.trace_operands(
            srec, tracer.build_camera_record(camera), dev, rr_depth)
        kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=n_samples,
                  max_depth=50)

        def sums():
            return torch.zeros((3, nx * ny), dtype=torch.float64, device=dev)

        k = tracer.trace(ops, sums(), **kw)
        pl = sums()
        work = {}
        pl_ms = cuda_ms(lambda: tracer.trace_plain(ops, pl.zero_(),
                                                   counts=work, **kw),
                        reps=1, warm=False)
        check(bool(torch.isfinite(k).all()), f"{scene}: K1 sums are not "
              "finite")
        agree = within(k, pl)
        km, pm = k.mean(dim=1), pl.mean(dim=1)
        mean_rel = float(((km - pm).abs() / pm.abs()).max())
        err = float((k - pl).abs().max())
        s_k = sums()
        k_ms = cuda_ms(lambda: tracer.trace(ops, s_k.zero_(), **kw), reps=3)
        extra = {}
        if ops.leaves.shape[0]:
            extra = hold_culls(scene, ops, k, pl, kw)
        row = dict(spp=n_samples, max_abs_err=err, ms=k_ms, plain_ms=pl_ms,
                   **k1_bound(ops, work, nx * ny, n_samples))
        held[key or scene] = dict(work=work, spp=n_samples)
        emit(phase, scene=scene, shape=[ny, nx], depth=50,
             rr_depth=rr_depth, feats=ops.feats, unrolled=len(srec.kinds),
             dynamic=int(ops.dyn.shape[0]), leaves=int(ops.leaves.shape[0]),
             sups=int(ops.sups.shape[0]),
             media=int(ops.med.shape[0]), atlas=list(ops.atlas.shape),
             pixels_within_rel_1e4=agree,
             pixels_bit_equal=float((k == pl).all(dim=0).double().mean()),
             kernel_channel_means=km.tolist(), plain_channel_means=pm.tolist(),
             channel_mean_max_rel=mean_rel, work=work,
             kernel_primary_rays_per_s=nx * ny * n_samples / (k_ms * 1e-3),
             **row, **extra)
        check(agree >= 0.99, f"{scene}: only {agree:.4%} of pixels agree")
        check(mean_rel <= 1e-4,
              f"{scene}: channel means differ by {mean_rel:.2e}")
        check(err == 0.0, f"{scene}: K1 differs from plain by {err:.3e}")
        return row

    k1be = {scene: hold("k1be_vs_plain", scene)
            for scene in ("random_spheres", "two_spheres")}

    # -- 11, 12, 14-17. the render path of the sphere and Next Week scenes,
    # through the command line
    def cli_path(scene: str, mean: float, section: str) -> dict:
        p = PRESETS[scene]
        band = (0.95 * mean, 1.05 * mean)
        info, img = run_cli(scene, label=scene)
        lum = info["mean_luminance"]
        emit(f"{scene}_path", **info, spp=p.spp, wall_primary_rays_per_s=(
            p.nx * p.ny * p.spp / info["wall_seconds"]), band=list(band))
        check(info["launches"][section] > 0,
              f"{scene}: {section} never launched: {info['launches']}")
        check(img.shape == (p.ny, p.nx, 3)
              and bool(((img >= 0) & (img <= 1)).all()),
              f"{scene}: image has the wrong shape or range")
        check(band[0] < lum < band[1],
              f"{scene}: mean luminance {lum:.4f} outside {band}")
        return info["launches"]

    sphere_launches = {
        scene: cli_path(scene, mean, "k1be_sphere_trace")
        for scene, mean in (("random_spheres", RANDOM_SPHERES_MEAN),
                            ("two_spheres", TWO_SPHERES_MEAN))}

    k1cd = {scene: hold("k1cd_vs_plain", scene) for scene in NEXT_WEEK_MEANS}
    next_launches = {
        scene: cli_path(scene, mean, "k1d_media_trace"
                        if scene == "cornell_smoke" else "k1c_texture_trace")
        for scene, mean in NEXT_WEEK_MEANS.items()}
    textured = ("two_perlin_spheres", "simple_light", "earth")

    # -- 18. final_scene's boxes and walk vs plain, 800×800, 1 spp, depth 50,
    # the walk on and off
    p = PRESETS["final_scene"]
    nx, ny = p.nx, p.ny
    fops = tracer.trace_operands(
        tracer.build_scene_record(p.build()),
        tracer.build_camera_record(p.camera()), dev)
    check(bool(fops.feats & tracer.FEAT_DENSE_WALK), "final_scene does not "
          "walk")
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=1, max_depth=50)
    final, final_k = {}, {}
    for name, o in (("walk", fops), ("event", dataclasses.replace(
            fops, feats=fops.feats & ~tracer.FEAT_DENSE_WALK))):
        k = tracer.trace(o, sums(), **kw)
        pl, work = sums(), {}
        pl_ms = cuda_ms(lambda: tracer.trace_plain(o, pl.zero_(),
                                                   counts=work, **kw),
                        reps=1, warm=False)
        check(bool(torch.isfinite(k).all()), f"final_scene ({name}): K1 "
              "sums are not finite")
        agree = within(k, pl)
        km, pm = k.mean(dim=1), pl.mean(dim=1)
        mean_rel = float(((km - pm).abs() / pm.abs()).max())
        s_k = sums()
        k_ms = cuda_ms(lambda: tracer.trace(o, s_k.zero_(), **kw), reps=3)
        final[name] = dict(spp=1, max_abs_err=float((k - pl).abs().max()),
                           ms=k_ms, plain_ms=pl_ms,
                           **k1_bound(o, work, nx * ny, 1))
        culls = hold_culls(f"final_scene ({name})", o, k, pl, kw)
        if name == "walk":   # the command line's path
            held["final_scene"] = dict(work=work, spp=1)
        final_k[name] = k
        emit("k1e_k1d_walk_vs_plain", scene="final_scene", path=name,
             shape=[ny, nx], depth=50, feats=o.feats,
             unrolled=int(o.walk.shape[1]), dynamic=int(o.dyn.shape[0]),
             leaves=int(o.leaves.shape[0]), boxes=int(o.box.shape[0]),
             box_leaves=int(o.bleaves.shape[0]),
             interior=int(o.interior.shape[0]), media=int(o.med.shape[0]),
             pixels_within_rel_1e4=agree,
             pixels_bit_equal=float((k == pl).all(dim=0).double().mean()),
             kernel_channel_means=km.tolist(),
             plain_channel_means=pm.tolist(), channel_mean_max_rel=mean_rel,
             work=work, sups=int(o.sups.shape[0]),
             box_sups=int(o.bsups.shape[0]), **final[name], **culls)
        check(agree >= 0.99, f"final_scene ({name}): only {agree:.4%} of "
              "pixels agree")
        check(mean_rel <= 1e-4, f"final_scene ({name}): channel means "
              f"differ by {mean_rel:.2e}")
        check(final[name]["max_abs_err"] == 0.0, f"final_scene ({name}): K1 "
              f"differs from plain by {final[name]['max_abs_err']:.3e}")
    same = bool(torch.equal(final_k["walk"], final_k["event"]))
    emit("k1d_walk_vs_event", scene="final_scene", spp=1,
         walk_equals_event=same,
         pixels_equal=float((final_k["walk"] == final_k["event"])
                            .all(dim=0).double().mean()),
         walk_ms=final["walk"]["ms"], event_ms=final["event"]["ms"])
    check(same, "final_scene: the walk's sums differ from the event path's")
    # the walk against the event path on samples 1-3, a launch a sample: a
    # finding, not a gate (a ray that scatters just past the sealing sphere
    # walks on with no surface cap: tests/test_torch_warp_schedule.py)
    differ = []
    for s in range(1, 4):
        on, off = (tracer.trace(o, sums(), **dict(kw, sample0=s)) for o in (
            fops, dataclasses.replace(
                fops, feats=fops.feats & ~tracer.FEAT_DENSE_WALK)))
        differ += [[s, i] for i in torch.nonzero(
            (on != off).any(dim=0)).squeeze(1).tolist()]
    emit("k1d_walk_vs_event_samples", scene="final_scene", samples=4,
         seed=0, pixel_samples_differ=len(differ), first=differ[:8])
    del final_k

    # -- 19. the render path of final_scene through the command line, and
    # its mean at the JAX reference's size and spp
    info, img = run_cli("final_scene", label="final_scene")
    emit("final_scene_path", **info, spp=p.spp, wall_primary_rays_per_s=(
        nx * ny * p.spp / info["wall_seconds"]))
    final_launches = info["launches"]
    check(all(final_launches[k] > 0 for k in (
        "k1be_sphere_trace", "k1c_texture_trace", "k1d_media_trace",
        "k1e_box_trace", "k1d_walk_trace")),
        f"final_scene: a kernel section never launched: {final_launches}")
    check(img.shape == (ny, nx, 3) and bool(((img >= 0) & (img <= 1)).all()),
          "final_scene: image has the wrong shape or range")
    band = (0.95 * FINAL_SCENE_MEAN, 1.05 * FINAL_SCENE_MEAN)
    cnx, cny = FINAL_SCENE_CHECK
    info, img = run_cli("final_scene", "--nx", str(cnx), "--ny", str(cny))
    lum = info["mean_luminance"]
    emit("final_scene_mean", **info, spp=p.spp, band=list(band))
    check(img.shape == (cny, cnx, 3) and band[0] < lum < band[1],
          f"final_scene {cnx}x{cny}: mean luminance {lum:.4f} outside "
          f"{band}")

    # -- 20. K2 with the sky vs plain, the geometry scene at full width
    kw = dict(nx=200, ny=200, spp=64, block=4096, max_depth=6)
    gtarget = ir.build_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT,
                                 ir.TRUE_TILT_DEG, device=dev)
    gcfg = grad.fast_grad_config(gtarget)
    grec = grad.fast_grad_record(gtarget).detach()
    gcam = ir.geo_camera(dev)
    o, d, u = ir.step_inputs(gcam, 0, device=dev, **kw)
    n = o.shape[0]
    k2, k2_tape = grad.grad_fwd(grec, o, d, u, gcfg, 6, tape=True)
    c2 = {}
    p2, p2_tape = grad.trace_tiles_plain(grec, o, d, u, gcfg, 6, counts=c2,
                                         tape=True)
    torch.cuda.synchronize()
    tape_ok = tape_matches(k2_tape, p2_tape)
    gk2_bound, gk3_bound, gpair_bound = k2_k3_bound(c2, grec.shape[0], n,
                                                    gcfg[1])
    gk2_notape_bound = k2_k3_bound(c2, grec.shape[0], n, gcfg[1],
                                   tape=False)[0]
    check(bool(torch.isfinite(k2).all()), "K2b radiance is not finite")
    gk2_err = float((k2 - p2).abs().max())
    bit_equal = float((k2 == p2).all(dim=1).double().mean())
    emit("k2b_sky_vs_plain", scene="geometry", feats=sorted(gcfg[1]),
         kinds="".join(gcfg[0]), lanes=n, depth=6,
         lanes_bit_equal=bit_equal, max_abs_err=gk2_err,
         kernel_channel_means=k2.mean(dim=0).tolist(),
         plain_channel_means=p2.mean(dim=0).tolist(), work=c2,
         tape_bit_equal=tape_ok)
    check(bool(torch.equal(k2, p2)),
          f"K2b: {bit_equal:.4%} of lanes bit-equal, max abs err {gk2_err}")
    check(tape_ok, "K2b's winner tape differs from the plain tape")

    # -- 21. K3 with the geometric adjoint vs autograd, column by column
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ct = torch.rand(n, 3, generator=g, device=dev)
    k3 = grad.grad_bwd(grec, o, d, u, ct, gcfg, 6, tape=k2_tape)
    again = grad.grad_bwd(grec, o, d, u, ct, gcfg, 6, tape=k2_tape)
    p3 = grad.trace_tiles_plain_vjp(grec, o, d, u, ct, gcfg, 6)
    torch.cuda.synchronize()
    repeat_ok = all(bool(torch.equal(a, b)) for a, b in zip(k3, again))
    gk3_err = hold_k3_columns(
        "k3b_vs_autograd", "K3b", k3, p3, True, scene="geometry", lanes=n,
        depth=6, d_rec_kn_koff=k3[0][:, [grad.C_KN, grad.C_KN + 1,
                                         grad.C_KN + 2, grad.C_KOFF]].tolist(),
        identical_in_two_launches=repeat_ok)
    check(repeat_ok, "K3b: two launches on the same operands differ")
    del p3, again

    # -- 22. the geometry training path
    argv = ["--geometry", "--device", "cuda"]
    buf = io.StringIO()
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ir.main(argv)
    wall = time.perf_counter() - t
    geo_launches = {"k2b_sky_fwd": grad.K2_LAUNCHES,
                    "k3b_geometric_bwd": grad.K3_LAUNCHES}
    text = buf.getvalue()
    rec_line = re.search(r"max abs err ([0-9.]+)\), emission ([0-9.]+) "
                         r"\(err ([0-9.]+)\), tilt (-?[0-9.]+)° "
                         r"\(err ([0-9.]+)°\)", text)
    step_line = re.search(r"step time: ([0-9.]+)s", text)
    vals = ([float(x) for x in rec_line.groups()] if rec_line
            else [None] * 5)
    emit("geometry_train_path", argv=argv, rc=rc, wall_seconds=wall,
         launches=geo_launches, albedo_max_abs_err=vals[0],
         emission=vals[1], emission_err=vals[2], tilt_deg=vals[3],
         tilt_err_deg=vals[4],
         median_step_seconds=float(step_line.group(1)) if step_line else None,
         log=text.splitlines())
    check(all(v > 0 for v in geo_launches.values()),
          f"a kernel of the geometry path never launched: {geo_launches}")
    check(rc == 0 and rec_line is not None,
          f"inverse_render.main({argv}) returned {rc}")

    # -- 23. times at the geometry step's full width
    ggt = grad_kernel_times("geometry_grad_kernel_times", grec, o, d, u, ct,
                            gcfg, 6, scene="geometry", k2_bound=gk2_bound,
                            k2_no_tape_bound=gk2_notape_bound,
                            k3_bound=gk3_bound)
    gk2_ms, gk3_ms = ggt["k2_tape_ms"], ggt["k3_ms"]
    gp2_ms = cuda_ms(lambda: grad.trace_tiles_plain(grec, o, d, u, gcfg, 6),
                     reps=3)
    gp3_ms = cuda_ms(lambda: grad.trace_tiles_plain_vjp(grec, o, d, u, ct,
                                                        gcfg, 6), reps=3)
    gscene = ir.build_geo_scene(device=dev)
    light_tex, cube_tex = ir.geo_param_rows(gscene)
    albedo = torch.tensor(ir.START_GEO_ALBEDO, device=dev, requires_grad=True)
    emission = torch.tensor(ir.START_GEO_EMIT, device=dev, requires_grad=True)
    theta = torch.tensor(ir.START_THETA, device=dev, requires_grad=True)

    def geo_step():
        oo, dd, uu = ir.step_inputs(gcam, 1, device=dev, **kw)
        ir.path_matched_loss(gtarget, gscene, light_tex, cube_tex, albedo,
                             emission, oo, dd, uu, block=4096, spp=64,
                             max_depth=6, cfg=gcfg, theta=theta).backward()
    gstep_ms = cuda_ms(geo_step, reps=10)
    emit("geometry_grad_times", lanes=n, depth=6, k2_ms=gk2_ms, k3_ms=gk3_ms,
         plain_fwd_ms=gp2_ms, plain_fwd_bwd_ms=gp3_ms, step_ms=gstep_ms,
         k2_bound_ms=gk2_bound["bound_ms"], k3_bound_ms=gk3_bound["bound_ms"],
         pair_ms=ggt["pair_ms"], pair_bound=gpair_bound,
         kernel_fwd_bwd_sample_paths_per_s=n / ((gk2_ms + gk3_ms) * 1e-3),
         step_candidate_sample_paths_per_s=n / (gstep_ms * 1e-3))

    # -- 24-28. metal, glass and the checker in K2 and K3
    material, mat_launches, mtimes = material_phases(dev, reset_launches)
    m = material["probe_scene", 6]

    # -- 29. the lattice corners vs plain on lattice_scene, 1280×720, 2 spp
    from raytracing_rust_tpu_torch.models import builders
    lnx, lny = 1280, 720
    lattice = hold("k1_lattice_vs_plain", "lattice_scene", built=(
        builders.lattice_scene(), builders.lattice_camera(lnx, lny), lnx,
        lny))

    # -- 30. the lattice path: render_kernel at 1280×720, 100 spp, and the
    # mean at the JAX reference's size
    def lattice_render(nx: int, ny: int, spp: int,
                       label: str | None = None) -> tuple[dict, object]:
        timers = Timers()
        reset_launches()
        t = time.perf_counter()
        with (record(label, "lattice_scene") if label
              else contextlib.nullcontext()):
            img = tracer.render_kernel(
                builders.lattice_scene(), builders.lattice_camera(nx, ny),
                nx, ny, spp, device="cuda", seed=0, max_depth=50,
                timers=timers)
        wall = time.perf_counter() - t
        info = dict(shape=[ny, nx], spp=spp, depth=50, wall_seconds=wall,
                    timers=timers.summary(), launches=k1_launches(),
                    mean_luminance=float(img.mean()))
        check(img.shape == (ny, nx, 3) and bool(np.isfinite(img).all())
              and bool(((img >= 0) & (img <= 1)).all()),
              f"lattice {nx}x{ny}: image has the wrong shape or range")
        return info, img
    info, img = lattice_render(lnx, lny, 100, label="lattice_scene")
    lattice_launches = info["launches"]
    emit("lattice_path", **info,
         render_primary_rays_per_s=lnx * lny * 100 / info["timers"]["trace"])
    check(lattice_launches["k1_lattice_trace"] > 0,
          f"lattice: the lattice corners never launched: {lattice_launches}")
    cnx, cny, cspp = LATTICE_CHECK
    band = (0.95 * LATTICE_MEAN, 1.05 * LATTICE_MEAN)
    info, img = lattice_render(cnx, cny, cspp)
    lum = info["mean_luminance"]
    emit("lattice_mean", **info, band=list(band))
    check(band[0] < lum < band[1],
          f"lattice {cnx}x{cny}: mean luminance {lum:.4f} outside {band}")

    # -- 31. roulette vs plain: cornell_box 800×800×4 (rr 6), final_scene
    # 800×800×1 (rr 5, the walk off)
    roulette = {
        "cornell_box": hold("k1g_vs_plain", "cornell_box", n_samples=4,
                            rr_depth=6, key="cornell_box --rr-depth 6"),
        "final_scene": hold("k1g_vs_plain", "final_scene", n_samples=1,
                            rr_depth=5, key="final_scene --rr-depth 5")}

    # -- 32. the roulette path through the command line
    info, img = run_cli("cornell_box_baseline", "--rr-depth", "6",
                        label="cornell_box_baseline --rr-depth 6",
                        key="cornell_box --rr-depth 6")
    rr_launches = info["launches"]
    lum = info["mean_luminance"]
    emit("cornell_rr_path", **info, band=list(CORNELL_BAND),
         trace_seconds_without_roulette=cornell_trace_s)
    check(rr_launches["k1g_roulette_trace"] > 0,
          f"cornell_box --rr-depth 6: K1g never launched: {rr_launches}")
    check(img.shape == (800, 800, 3)
          and bool(((img >= 0) & (img <= 1)).all()),
          "cornell_box --rr-depth 6: image has the wrong shape or range")
    check(CORNELL_BAND[0] < lum < CORNELL_BAND[1],
          f"cornell_box --rr-depth 6: mean luminance {lum:.4f} outside "
          f"{CORNELL_BAND}")

    # -- 33. K1f's stats instantiation vs the production kernel and plain
    def preset_ops(scene: str):
        p = PRESETS[scene]
        return (tracer.trace_operands(
            tracer.build_scene_record(p.build()),
            tracer.build_camera_record(p.camera()), dev), p.nx, p.ny)

    def occupancy(stats, n_pix: int, n_samples: int, kpix: int = 1) -> dict:
        s = kernel_stats.summarize(stats, n_pix, n_samples, kpix)
        return {k: s[k] for k in ("occupancy", "tail_share",
                                  "steps_per_sample", "segments_per_sample",
                                  "sphere_tests_per_segment",
                                  "box_tests_per_segment", "warps")}

    k1f_stats = {}
    for scene, n_samples in (("cornell_box_baseline", 2),
                             ("random_spheres", 2), ("final_scene", 1)):
        sops, snx, sny = preset_ops(scene)
        n_pix = snx * sny
        kw = dict(nx=snx, ny=sny, seed=0, sample0=0, n_samples=n_samples,
                  max_depth=50)

        def zeros():
            return torch.zeros((3, n_pix), dtype=torch.float64, device=dev)

        prod = tracer.trace(sops, zeros(), **kw)
        sk = tracer.new_stats(snx, sny, dev)
        k = tracer.trace(sops, zeros(), stats=sk, **kw)
        sp, work = tracer.new_stats(snx, sny, dev), {}
        pl = zeros()
        pl_ms = cuda_ms(lambda: tracer.trace_plain(
            sops, pl, counts=work, stats=sp, **kw), reps=1, warm=False)
        torch.cuda.synchronize()
        check(bool(torch.equal(k, prod)), f"{scene}: the stats "
              "instantiation's sums differ from the production kernel's")
        agree = within(k, pl)
        km, pm = k.mean(dim=1), pl.mean(dim=1)
        mean_rel = float(((km - pm).abs() / pm.abs()).max())
        rows_equal = {name: bool(torch.equal(a, b)) for name, a, b in zip(
            ("segments", "sphere_tests", "box_tests", "warp_steps"),
            tracer.stats_rows(sk, n_pix), tracer.stats_rows(sp, n_pix))}
        st_ms = cuda_ms(lambda: tracer.trace(
            sops, zeros(), stats=tracer.new_stats(snx, sny, dev), **kw),
            reps=3)
        prod_ms = cuda_ms(lambda: tracer.trace(sops, zeros(), **kw), reps=3)
        k1f_stats[scene] = dict(
            spp=n_samples, max_abs_err=float((k - pl).abs().max()),
            ms=st_ms, plain_ms=pl_ms,
            **k1_bound(sops, work, n_pix, n_samples))
        if scene == "final_scene":
            final33 = dict(prod=prod, stats=sk)   # held by phase 39
        emit("k1f_stats_vs_plain", scene=scene, shape=[sny, snx],
             depth=50, pixels_within_rel_1e4=agree,
             pixels_bit_equal=float((k == pl).all(dim=0).double().mean()),
             channel_mean_max_rel=mean_rel, counters_equal=rows_equal,
             stats_ms=st_ms, production_ms=prod_ms, work=work,
             **occupancy(sk, n_pix, n_samples), **k1f_stats[scene])
        check(agree >= 0.99, f"{scene}: only {agree:.4%} of pixels agree")
        check(mean_rel <= 1e-4, f"{scene}: channel means differ by "
              f"{mean_rel:.2e}")
        check(all(rows_equal.values()),
              f"{scene}: stats counters differ from plain: {rows_equal}")
        check(k1f_stats[scene]["max_abs_err"] == 0.0, f"{scene}: the stats "
              f"launch differs from plain by "
              f"{k1f_stats[scene]['max_abs_err']:.3e}")
        del prod, k, pl, sk, sp

    # -- 34. the balanced layouts against the scanline layout: JAX's table
    # at kpix 1 and 4, and the card's (`render_table`, the main path's)
    k1f_bal = {}
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = tracer.k1_blocks_per_sm()
    # both presets run a K1B+DYN instantiation, with or without the leaves
    # in shared memory (the same registers)
    per_sm = min(per_sm["trace_k1<1,1,0,0>"], per_sm["trace_k1<1,1,1,0>"])
    for scene, n_samples in (("random_spheres", 2), ("final_scene", 1)):
        sops, snx, sny = preset_ops(scene)
        n_pix = snx * sny
        kw = dict(nx=snx, ny=sny, seed=0, sample0=0, max_depth=50)

        def zeros():
            return torch.zeros((3, n_pix), dtype=torch.float64, device=dev)

        torch.cuda.synchronize()
        t = time.perf_counter()
        order = tracer.cost_permutation(sops, snx, sny, 50, dev)
        jax_probe_s = time.perf_counter() - t
        t = time.perf_counter()
        tiles = tracer.render_table(sops, snx, sny, 50, dev)
        torch.cuda.synchronize()
        probe_s = time.perf_counter() - t
        tables = {kp: torch.from_numpy(tracer.balanced_pix_table(
            order, n_pix, kp)[0]).to(dev) for kp in (1, 4)}
        layouts = {"scanline": {}, "kpix1": dict(pix=tables[1], kpix=1),
                   "kpix4": dict(pix=tables[4], kpix=4),
                   "tiles": dict(pix=tiles, kpix=1)}
        blocks = {name: (lay["pix"].numel() // lay["kpix"]
                         if lay else n_pix + tracer.THREADS - 1)
                  // tracer.THREADS for name, lay in layouts.items()}
        outs = {name: tracer.trace(sops, zeros(), n_samples=n_samples,
                                   **kw, **lay)
                for name, lay in layouts.items()}
        pl = zeros()
        work = {}
        pl_ms = cuda_ms(lambda: tracer.trace_plain(
            sops, pl, n_samples=n_samples, counts=work, **layouts["tiles"],
            **kw), reps=1, warm=False)
        tiles_ms = cuda_ms(lambda: tracer.trace(
            sops, zeros(), n_samples=n_samples, **layouts["tiles"], **kw),
            reps=3)
        torch.cuda.synchronize()
        same = {name: bool(torch.equal(o, outs["scanline"]))
                for name, o in outs.items()}
        agree = within(outs["tiles"], pl)
        km, pm = outs["tiles"].mean(dim=1), pl.mean(dim=1)
        mean_rel = float(((km - pm).abs() / pm.abs()).max())
        # times in turns at the samples of the command line's largest
        # table launch of this preset (phases 11 and 19 recorded it), and
        # the occupancy of each layout there
        n_main = max(ln["kw"]["n_samples"]
                     for ln in main_runs[scene]["launches"]
                     if ln["kw"].get("pix") is not None)
        turns = []
        for name in ("scanline", "kpix1", "kpix4", "tiles", "tiles",
                     "kpix4", "kpix1", "scanline"):
            turns.append((name, cuda_ms(lambda: tracer.trace(
                sops, zeros(), n_samples=n_main, **layouts[name], **kw),
                reps=2)))
        occ = {}
        for name, lay in layouts.items():
            st = tracer.new_stats(snx, sny, dev, lay.get("pix"),
                                  lay.get("kpix", 1))
            tracer.trace(sops, zeros(), n_samples=n_main, stats=st, **lay,
                         **kw)
            occ[name] = occupancy(st, n_pix, n_main, lay.get("kpix", 1))
        k1f_bal[scene] = dict(
            spp=n_samples, max_abs_err=float((outs["tiles"] - pl).abs().max()),
            ms=tiles_ms, plain_ms=pl_ms,
            **k1_bound(sops, work, n_pix, n_samples))
        emit("k1f_balanced_vs_scanline", scene=scene, shape=[sny, snx],
             depth=50, probe_seconds=probe_s, jax_probe_seconds=jax_probe_s,
             bit_equal_to_scanline=same, plain_pixels_within_rel_1e4=agree,
             plain_channel_mean_max_rel=mean_rel,
             ms_in_turns=turns, turns_spp=n_main, occupancy_in_turns=occ,
             blocks=blocks, blocks_per_sm=per_sm, sms=sm_count,
             waves={name: b / (per_sm * sm_count)
                    for name, b in blocks.items()},
             work=work, **k1f_bal[scene])
        check(all(same.values()), f"{scene}: a balanced layout's sums "
              f"differ from the scanline layout's: {same}")
        check(tiles.device.type == "cuda",
              f"{scene}: the render's table is not on the card")
        check(agree >= 0.99, f"{scene} (tiles): only {agree:.4%} of pixels "
              "agree with plain")
        check(mean_rel <= 1e-4, f"{scene} (tiles): channel means differ by "
              f"{mean_rel:.2e}")
        check(k1f_bal[scene]["max_abs_err"] == 0.0, f"{scene} (tiles): "
              f"differs from plain by {k1f_bal[scene]['max_abs_err']:.3e}")
        del outs, pl

    # -- 35. the balanced render path through the command line
    bal_launches, bal_labels = {}, []
    for scene, extra, mean in (
            ("random_spheres", (), RANDOM_SPHERES_MEAN),
            ("final_scene", (), None),
            ("final_scene", ("--nx", str(FINAL_SCENE_CHECK[0]), "--ny",
                             str(FINAL_SCENE_CHECK[1])), FINAL_SCENE_MEAN)):
        tracer._PERM_CACHE.clear()   # a cold render: the probe runs
        bal_labels.append(" ".join(("balanced", scene, *extra)))
        info, img = run_cli(scene, *extra, label=bal_labels[-1])
        lum = info["mean_luminance"]
        band = None if mean is None else (0.95 * mean, 1.05 * mean)
        emit("k1f_balanced_path", **info, band=band,
             balance_probe_seconds=info["timers"].get("balance_probe"),
             trace_seconds=info["timers"].get("trace"))
        bl = info["launches"]
        check(bl["k1f_stats_trace"] > 0 and bl["k1f_balanced_trace"] > 0
              and "balance_probe" in info["timers"],
              f"{scene} {extra}: the balanced path did not run: {bl}")
        check(bool(((img >= 0) & (img <= 1)).all()),
              f"{scene} {extra}: image out of range")
        if band is not None:
            check(band[0] < lum < band[1],
                  f"{scene} {extra}: mean luminance {lum:.4f} outside {band}")
        for k, v in bl.items():
            bal_launches[k] = bal_launches.get(k, 0) + v

    # -- 36. D3: the f32 peak through kernel_stats --peak, and its
    # accumulators against the plain chain
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        sweep = kernel_stats.peak_sweep()   # what --peak runs
    d3_launches = peak.D3_LAUNCHES
    check(d3_launches > 0, "kernel_stats --peak launched no D3 kernel")
    d3_equal = {}
    for kk in peak.KS:
        for fma in (False, True):
            got = peak.fp32_chain(kk, 64, fma, 4, 128, dev)
            want = peak.fp32_chain_plain(kk, 64, fma, 4 * 128, dev)
            d3_equal[f"k{kk}{'_fma' if fma else ''}"] = bool(
                torch.equal(got, want))
    best = sweep["add"]
    bk, bblocks = best["k"], best["blocks"]
    n_thr = bblocks * best["threads"]
    d3_ms = cuda_ms(lambda: peak.fp32_chain(bk, 64, False, bblocks,
                                            best["threads"], dev), reps=20)
    d3_plain_ms = cuda_ms(lambda: peak.fp32_chain_plain(bk, 64, False, n_thr,
                                                        dev), reps=3)
    d3_got = peak.fp32_chain(bk, 64, False, bblocks, best["threads"], dev)
    d3_err = float((d3_got - peak.fp32_chain_plain(
        bk, 64, False, n_thr, dev)).abs().max())
    d3_bound = bound(64 * peak.UNROLL * bk * n_thr, 4 * bk * n_thr)
    emit("d3_fp32_peak", log=buf.getvalue().splitlines(),
         add_ops_per_s=best["ops_per_s"], add_config=dict(
             k=bk, blocks=bblocks, threads=best["threads"],
             sm_mhz=best["sm_mhz"]),
         fma_ops_per_s=sweep["fma"]["ops_per_s"],
         fma_sm_mhz=sweep["fma"]["sm_mhz"], theoretical=sweep["theoretical"],
         published_f32_ops_per_s=F32_OPS_PER_S, launches=d3_launches,
         plain_bit_equal=d3_equal, compare_shape=dict(
             k=bk, iters=64, threads=n_thr), ms=d3_ms, plain_ms=d3_plain_ms,
         **d3_bound)
    check(all(d3_equal.values()) and d3_err == 0.0,
          f"D3 differs from its plain chain: {d3_equal}")

    # -- 37-38. D1 and D2 through `microbench` (8,192 threads, the TPU
    # tile's lanes), then at each kernel's full wave
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = microbench.main([])
    d1_launches, d2_launches = mb.D1_LAUNCHES, mb.D2_LAUNCHES
    log = buf.getvalue()
    check(rc == 0, f"microbench.main returned {rc}")
    check(d1_launches > 0 and d2_launches > 0,
          f"microbench launched D1 {d1_launches}, D2 {d2_launches} times")
    tile_us = {f"{m.group(1)}_{v}": float(m.group(i)) for m in re.finditer(
        r"attr_read\[(\d) bands\] global\s+([0-9.e+-]+) µs/call\s+shared"
        r"\s+([0-9.e+-]+) µs/call", log) for v, i in (("global", 2),
                                                     ("shared", 3))}
    tile_ns = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(sphere|box|any|or_tree)\s+([0-9.e+-]+) ns/call", log, re.M)}
    check(len(tile_us) == 4 and len(tile_ns) == 4,
          f"microbench printed {tile_us}, {tile_ns}")
    with contextlib.redirect_stdout(io.StringIO()):
        wave_rates = microbench.run_card(None)   # each kernel's full wave

    def d1_case(n, n_bands, shared, kk):
        """D1 against attr_read_plain at n threads → (bit-equal, max abs
        error of the accumulator)."""
        table, col = mb.attr_table(n_bands).to(dev), mb.attr_cols(n).to(dev)
        got = mb.attr_read(table, col, kk, shared=shared)
        want = mb.attr_read_plain(table, col, kk)
        return (bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1])),
                float((got[0] - want[0]).abs().max()))

    def d2_case(n, kind, kk):
        """D2 against member_plain at n threads → (bit-equal, max abs
        error of t_b + wi)."""
        rec, xm = mb.member_rec().to(dev), mb.member_x(n).to(dev)
        got, want = mb.member(rec, xm, kk, kind), mb.member_plain(rec, xm,
                                                                  kk, kind)
        return (bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1])),
                float((got[0] - want[0]).abs().max()))

    col = mb.attr_cols().to(dev)
    d1_equal, d1_plain_s, d1_err = {}, {}, 0.0
    for n_bands in mb.BANDS:
        table = mb.attr_table(n_bands).to(dev)
        t = []
        for kk in mb.D1_K:
            t.append(cuda_ms(lambda: mb.attr_read_plain(table, col, kk), 1,
                             warm=False))
            for shared in (False, True):
                d1_equal[f"{n_bands}_{'shared' if shared else 'global'}"
                         f"_k{kk}"], err = d1_case(mb.TILE, n_bands, shared,
                                                   kk)
                d1_err = max(d1_err, err)
        d1_plain_s[n_bands] = (t[1] - t[0]) * 1e-3 / (mb.D1_K[1]
                                                      - mb.D1_K[0])
        for shared in (False, True):   # each variant's own full wave
            key = f"{n_bands}_{'shared' if shared else 'global'}"
            d1_equal[f"{key}_k{mb.D1_K[0]}_full_wave"], err = d1_case(
                wave_rates["d1_threads"][key], n_bands, shared, mb.D1_K[0])
            d1_err = max(d1_err, err)
    # D1's floor: the bytes one call delivers (each warp's distinct rows,
    # 4 bands) over the SM load path's rate, SMs × 128 B × the max SM
    # clock: the table stays on chip, so the HBM rate is no floor
    th = kernel_stats.theoretical_fp32()
    load_rate = (th["sms"] * mb.SM_LOAD_BYTES_PER_CLK * th["max_sm_mhz"]
                 * 1e6)
    d1_bytes = mb.attr_bytes(col, mb.BANDS[0])
    d1_bound = bound(0, d1_bytes, load_rate)
    emit("d1_winner_row_read", log=log.splitlines(), threads=mb.TILE,
         us_per_call=tile_us, full_wave_threads=wave_rates["d1_threads"],
         full_wave_us_per_call=wave_rates["d1_us"],
         plain_us_per_call={str(b): v * 1e6 for b, v in d1_plain_s.items()},
         bit_equal=d1_equal, launches=d1_launches, bytes_per_call=d1_bytes,
         sm_load_bytes_per_s=load_rate, **d1_bound)
    check(all(d1_equal.values()), f"D1 differs from its plain version: "
          f"{d1_equal}")

    rec, xm = mb.member_rec().to(dev), mb.member_x().to(dev)
    d2_equal, d2_plain_s, d2_err = {}, {}, 0.0
    for kind in mb.KINDS:
        t = []
        for kk in mb.D2_K:
            d2_equal[f"{kind}_k{kk}"], err = d2_case(mb.TILE, kind, kk)
            d2_err = max(d2_err, err)
            t.append(cuda_ms(lambda: mb.member_plain(rec, xm, kk, kind), 1,
                             warm=False))
        d2_plain_s[kind] = (t[1] - t[0]) * 1e-3 / (mb.D2_K[1] - mb.D2_K[0])
        d2_equal[f"{kind}_k{mb.D2_K[0]}_full_wave"], err = d2_case(
            wave_rates["d2_threads"][kind], kind, mb.D2_K[0])
        d2_err = max(d2_err, err)
    d2_ops = {kind: mb.D2_OPS[kind] * mb.TILE for kind in mb.KINDS}
    d2_bound = bound(sum(d2_ops.values()), 0)
    d2_add_rate_ms = sum(d2_ops.values()) / best["ops_per_s"] * 1e3
    emit("d2_member_vote", threads=mb.TILE, ns_per_call=tile_ns,
         full_wave_threads=wave_rates["d2_threads"],
         full_wave_ns_per_call=wave_rates["d2_ns"],
         plain_ns_per_call={k: v * 1e9 for k, v in d2_plain_s.items()},
         bit_equal=d2_equal, launches=d2_launches, ops_per_call=d2_ops,
         bound_at_d3_add_rate_ms=d2_add_rate_ms, **d2_bound)
    check(all(d2_equal.values()), f"D2 differs from its plain version: "
          f"{d2_equal}")

    # -- 39. K1f's DDA row vs the production kernel, plain and phase 33
    sops, snx, sny = preset_ops("final_scene")
    n_pix = snx * sny
    kw = dict(nx=snx, ny=sny, seed=0, sample0=0, n_samples=1, max_depth=50)

    def zeros():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=dev)

    sk = tracer.new_stats(snx, sny, dev, dda=True)
    k = tracer.trace(sops, zeros(), stats=sk, dda=True, **kw)
    sp, work, pl = tracer.new_stats(snx, sny, dev, dda=True), {}, zeros()
    dda_plain_ms = cuda_ms(lambda: tracer.trace_plain(
        sops, pl, counts=work, stats=sp, dda=True, **kw), reps=1, warm=False)
    dda_ms = cuda_ms(lambda: tracer.trace(
        sops, zeros(), stats=tracer.new_stats(snx, sny, dev, dda=True),
        dda=True, **kw), reps=3)
    torch.cuda.synchronize()
    rows_plain = {name: bool(torch.equal(a, b)) for name, a, b in zip(
        ("segments", "sphere_tests", "box_tests", "warp_steps", "dda"),
        (*tracer.stats_rows(sk, n_pix, dda=True), tracer.dda_row(sk, n_pix)),
        (*tracer.stats_rows(sp, n_pix, dda=True), tracer.dda_row(sp, n_pix)))}
    rows_33 = {name: bool(torch.equal(a, b)) for name, a, b in zip(
        ("segments", "sphere_tests", "box_tests", "warp_steps"),
        tracer.stats_rows(sk, n_pix, dda=True),
        tracer.stats_rows(final33["stats"], n_pix))}
    same_sums = bool(torch.equal(k, final33["prod"]))
    dda_sum = kernel_stats.summarize(sk, n_pix, 1, dda=True)
    k1f_dda = dict(spp=1, max_abs_err=float((k - pl).abs().max()),
                   ms=dda_ms, plain_ms=dda_plain_ms,
                   **k1_bound(sops, work, n_pix, 1))
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf), record("kernel_stats final_scene",
                                                 "final_scene"):
        rc = kernel_stats.main(["final_scene"])
    dda_launches = tracer.K1F_DDA_LAUNCHES
    stats_log = buf.getvalue()
    emit("k1f_dda_row", scene="final_scene", shape=[sny, snx],
         depth=50, sums_equal_production=same_sums,
         counters_equal_plain=rows_plain, rows_equal_phase33=rows_33,
         box_tests=dda_sum["box_tests"], crossings=dda_sum["dda_crossings"],
         box_tests_per_segment=dda_sum["box_tests_per_segment"],
         dda_cross_per_segment=dda_sum["dda_cross_per_segment"],
         dda_skip_share=dda_sum["dda_skip_share"], work=work,
         kernel_stats_log=stats_log.splitlines(), launches=dda_launches,
         **k1f_dda)
    del final33, k, pl, sk, sp
    check(same_sums, "the DDA stats launch's sums differ from the "
          "production kernel's")
    check(all(rows_plain.values()), f"DDA stats counters differ from plain: "
          f"{rows_plain}")
    check(all(rows_33.values()), f"the DDA launch's counters differ from "
          f"phase 33's: {rows_33}")
    check(rc == 0 and dda_launches > 0
          and "a per-ray gate could skip" in stats_log,
          f"kernel_stats final_scene: rc {rc}, {dda_launches} DDA launches")

    # -- 40. K1 at the main path's own launches: every launch that phases
    # 5, 11-17, 19, 30, 32, 35 and 39 recorded, made again on its operands
    # and arguments (`replay`); cornell_box_baseline's first launch also
    # held to trace_plain itself, in 8-sample calls
    replayed = {}
    for label, run in main_runs.items():
        rows = []
        for i, launch in enumerate(run["launches"]):
            r, whole = replay(launch, held[run["held"]])
            if label == "cornell_box_baseline" and i == 0:
                kw = launch["kw"]
                s0, n = kw["sample0"], kw["n_samples"]
                pl = torch.zeros_like(whole)
                for s in range(s0, s0 + n, 8):
                    tracer.trace_plain(launch["ops"], pl, **{
                        **kw, "sample0": s, "n_samples": min(8, s0 + n - s)})
                r["plain_max_abs_err"] = float((whole - pl).abs().max())
                r["equals_plain"] = bool(torch.equal(whole, pl))
                del pl
            rows.append(r)
            del whole
        replayed[label] = rows
        steps = sum(r["warp_steps"] for r in rows)
        occ = sum(r["segments"] for r in rows) / (32 * steps)
        emit("k1_main_path_launches", run=label, launches=rows,
             ms=sum(r["ms"] for r in rows),
             bound_ms=sum(r["bound_ms"] for r in rows), occupancy=occ,
             tail_share=1.0 - occ)
        check(all(r["equals_chunks"] for r in rows), f"{label}: a launch's "
              "sums differ from the same samples launched in chunks")
        check(all(r.get("equals_plain", True) for r in rows),
              f"{label}: the launch's sums differ from trace_plain's")
    k1a["max_abs_err"] = max(
        k1a["max_abs_err"],
        replayed["cornell_box_baseline"][0]["plain_max_abs_err"])

    def main_row(row: dict, labels, counter: str, n: int) -> dict:
        return at_main_path(row, [r for lab in labels
                                  for r in replayed[lab]], counter, n)
    sphere_n = sum(v["k1be_sphere_trace"] for v in sphere_launches.values())
    texture_n = sum(next_launches[sc]["k1c_texture_trace"] for sc in textured)

    print(json.dumps({"kernels": [{
        "name": "k1a_static_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": launches["k1a_static_trace"],
        **main_row(k1a, ["cornell_box_baseline"], "k1a_static_trace",
                   launches["k1a_static_trace"]), "library_ms": None}, {
        "name": "k1be_sphere_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": sphere_n,
        **main_row(k1be["random_spheres"], sphere_launches,
                   "k1be_sphere_trace", sphere_n),
        "max_abs_err": max(v["max_abs_err"] for v in k1be.values()),
        "library_ms": None}, {
        "name": "k1c_texture_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": texture_n,
        **main_row(k1cd["simple_light"], textured, "k1c_texture_trace",
                   texture_n),
        "max_abs_err": max(k1cd[sc]["max_abs_err"] for sc in textured),
        "library_ms": None}, {
        "name": "k1d_media_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": next_launches["cornell_smoke"]["k1d_media_trace"],
        **main_row(k1cd["cornell_smoke"], ["cornell_smoke"],
                   "k1d_media_trace",
                   next_launches["cornell_smoke"]["k1d_media_trace"]),
        "library_ms": None}, {
        "name": "k1e_box_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": final_launches["k1e_box_trace"],
        **main_row(final["event"], ["final_scene"], "k1e_box_trace",
                   final_launches["k1e_box_trace"]), "library_ms": None}, {
        "name": "k1d_walk_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": final_launches["k1d_walk_trace"],
        **main_row(final["walk"], ["final_scene"], "k1d_walk_trace",
                   final_launches["k1d_walk_trace"]), "library_ms": None}, {
        "name": "k2_grad_fwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:557",
        "launches": train_launches["k2_grad_fwd"],
        "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": p2_ms, **k2_bound,
        **grad_row_facts(gt, "k2"), "library_ms": None}, {
        "name": "k3_grad_bwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:567",
        "launches": train_launches["k3_grad_bwd"],
        "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": p3_ms, **k3_bound,
        **grad_row_facts(gt, "k3"), "pair_bound_ms": pair_bound["bound_ms"],
        "library_ms": None}, {
        "name": "k2b_sky_fwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:557",
        "launches": geo_launches["k2b_sky_fwd"],
        "max_abs_err": gk2_err, "ms": gk2_ms, "plain_ms": gp2_ms,
        **gk2_bound, **grad_row_facts(ggt, "k2"), "library_ms": None}, {
        "name": "k3b_geometric_bwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:567",
        "launches": geo_launches["k3b_geometric_bwd"],
        "max_abs_err": gk3_err, "ms": gk3_ms, "plain_ms": gp3_ms,
        **gk3_bound, **grad_row_facts(ggt, "k3"),
        "pair_bound_ms": gpair_bound["bound_ms"], "library_ms": None}, {
        "name": "k2b_material_fwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:557",
        "launches": mat_launches["k2b_material_fwd"],
        "max_abs_err": max(v["k2_err"] for v in material.values()),
        **mtimes["k2"], "library_ms": None}, {
        "name": "k3b_material_bwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:567",
        "launches": mat_launches["k3b_material_bwd"],
        "max_abs_err": m["k3_err"], **mtimes["k3"], "library_ms": None}, {
        "name": "k1_lattice_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": lattice_launches["k1_lattice_trace"],
        **main_row(lattice, ["lattice_scene"], "k1_lattice_trace",
                   lattice_launches["k1_lattice_trace"]),
        "library_ms": None}, {
        "name": "k1g_roulette_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": rr_launches["k1g_roulette_trace"],
        **main_row(roulette["cornell_box"],
                   ["cornell_box_baseline --rr-depth 6"], "k1g_roulette_trace",
                   rr_launches["k1g_roulette_trace"]),
        "max_abs_err": max(v["max_abs_err"] for v in roulette.values()),
        "library_ms": None}, {
        "name": "k1f_stats_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": bal_launches["k1f_stats_trace"],
        **main_row(k1f_stats["random_spheres"], bal_labels, "k1f_stats_trace",
                   bal_launches["k1f_stats_trace"]),
        "max_abs_err": max(v["max_abs_err"] for v in k1f_stats.values()),
        "library_ms": None}, {
        "name": "k1f_balanced_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": bal_launches["k1f_balanced_trace"],
        **main_row(k1f_bal["random_spheres"], bal_labels,
                   "k1f_balanced_trace", bal_launches["k1f_balanced_trace"]),
        "max_abs_err": max(v["max_abs_err"] for v in k1f_bal.values()),
        "library_ms": None}, {
        "name": "d3_fp32_peak", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/peak.cu",
        "replaces": "tools/kernel_stats.py:186",
        "launches": d3_launches, "max_abs_err": d3_err, "ms": d3_ms,
        "plain_ms": d3_plain_ms, **d3_bound, "library_ms": None}, {
        # one call (k iteration) of the 4-band read-only-cache read at
        # 8,192 threads; its bound counts the words the call delivers over
        # the SM load path's rate (the table stays on chip). No single
        # PyTorch call computes a k-iteration loop of either microbench
        # kernel, so their library_ms is null
        "name": "d1_winner_row_read", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/microbench.cu",
        "replaces": "tools/microbench.py:70",
        "launches": d1_launches, "max_abs_err": d1_err,
        "ms": tile_us["4_global"] * 1e-3, "plain_ms": d1_plain_s[4] * 1e3,
        **d1_bound, "library_ms": None}, {
        # one call of each of the four kinds at 8,192 threads, summed
        "name": "d2_member_vote", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/microbench.cu",
        "replaces": "tools/microbench.py:162",
        "launches": d2_launches, "max_abs_err": d2_err,
        "ms": sum(tile_ns.values()) * 1e-6,
        "plain_ms": sum(d2_plain_s.values()) * 1e3, **d2_bound,
        "bound_at_d3_add_rate_ms": d2_add_rate_ms, "library_ms": None}, {
        "name": "k1f_dda_stats", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": dda_launches,
        **main_row(k1f_dda, ["kernel_stats final_scene"], "k1f_dda_stats",
                   dda_launches), "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
