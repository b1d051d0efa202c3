#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_rust_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
version and renders on the card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from csrc/ with nvcc (timed), with ptxas's
     registers and spills per instantiation, the blocks of each K1
     instantiation an SM holds (the runtime's occupancy query) and, from
     cuobjdump's SASS, each K1 instantiation's loads in its loop over the
     unrolled record's rows (shared-memory LDS against constant-bank LDC,
     ULDC and operands);
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
 13. the K1c and K1d sections against their plain version, on each
     Next Week preset the command line renders below, at the preset's
     size, 2 spp, depth 50, under phase 3's gates and bit for bit:
     two_perlin_spheres and simple_light 1280×720 (Perlin marble),
     earth 1280×720 (sphere UV and the 512×1024 texel atlas; these three
     in K1B without MED) and cornell_smoke 800×800 (two rotated
     constant-density boxes, K1d, in K1a's code with MED); both
     versions' times, and the work the paths needed (lane bounces, noise
     and image lanes) for the kernels' bounds;
 14-17. the render path through the command line, `render --scene S
     --device cuda` at each of those presets' size and spp, depth 50, with
     the launch counts, the instantiations they ran (media in a MED one,
     cornell_smoke's in `trace_k1<0,0,0,0,1>`, the other scenes' in none)
     and a check of the image;
 18. the K1e box and K1d walk sections against their plain version on
     final_scene at its preset's size, 800×800, 1 spp, depth 50, under
     phase 3's gates and bit for bit, with the walk on (each walk bounce
     an iteration of the flat loop) and with it off (the event path
     alone); its 20×20 ground boxes in the strip layout, through the strip
     pass (K1E_GRID counted on each launch, in a box grid's
     instantiation, DYN 2); both kernel times, the plain
     version's, the paths' work, and the two kernel runs' sums held to
     each other bit for bit; on each, the two-level cull held bit for bit
     to the one-level cull and to no cull, with their times; then 20 cubes
     (a 5×4 grid: the strip pass) and 17 (no grid: the generic box loop)
     against plain, bit for bit, K1E_GRID counted on the grid alone, each
     in the instantiation `tracer.k1_instantiation` names;
 19. the render path through the command line, `render --scene
     final_scene --device cuda` (800×800, 100 spp, depth 50), with the
     launch counts (every box launch a strip-pass launch; none in any
     command line run of a preset without a box grid) and a check of the
     image, and a render at 128×128, 100 spp whose mean is held to the JAX
     XLA tier's;
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
     800×800, 4 spp, rr_depth 6 (the static instantiation, K1a's), and
     final_scene 800×800, 1 spp, rr_depth 5 (the dense-medium walk off),
     depth 50, under phase 3's gates and bit for bit; both versions' times
     and the roulette draws;
 32. the roulette path through the command line, `render --scene
     cornell_box_baseline --rr-depth 6 --device cuda` (800×800, 500 spp,
     depth 50), with K1g's launch count, the instantiation its launches
     ran (the static one, never K1B), its mean within ±5% of phase
     5's reference, and its trace time beside phase 5's;
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
     Then the render's cost probe (`trace_probe`: compact 16×8 tiles, the
     segments alone, each pixel's samples split over blocks until the
     launch holds tracer.PROBE_WAVES = 12 waves of resident blocks) at
     the command line's three probes (random_spheres, final_scene and
     final_scene at 128×128, 4 spp): its row bit-equal to the scanline stats launch's row 0, at
     every split, and (where the plain version is quick: random_spheres
     and 128×128) to the plain version's with its warp steps; the
     render's table equal to the one made from that row; the probe and
     the scanline stats launch timed in turns, each split in turns, the
     probe's blocks, waves and occupancy (its own steps row);
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
     holds to trace_plain, and bounded; a cost probe (`replay_probe`)
     counted by its own steps row and its row held bit for bit to the
     scanline stats launch's; each launch must run the instantiation
     the host's counterpart of `pick` names for it (`picked`: media in
     the MED ones, cornell_smoke's on K1a's code with the media);
     cornell_box_baseline's first launch (800×800, 104 samples) is also
     held bit for bit to trace_plain, and so is cornell_smoke's launch on
     its first 8 samples;
 41. the general wavefront tier (torch ops) on the card at full width:
     `render --scene cornell_box_baseline --engine xla --device cuda`
     (800×800, 500 spp, depth 50), its mean inside phase 5's band, its
     primary rays/s and phases, no kernel launch, its image against the
     kernel's of phase 5 (the same seed and draws: the share of pixels
     with the same bytes, the channel means); then both engines' f64 sums
     at 800×800×8, the share of pixels within 1e-4 relative (≥ 99%);
 42. R5: final_scene on both engines through the command line at
     128×128×100 and at 800×800×4 (the spp cut so that the general tier,
     which tests all 3,400 prims densely with `--bvh off`, stays under
     ~20 s), each
     engine's render seconds and rays/s and which is faster;
 43. the fallback: a nine-media scene and an image on a rotated sphere
     (scenes the kernel refuses) through `cli.render_scene` on the card:
     "kernel" raises UnsupportedScene, "auto" renders on the general tier
     with no kernel launch and one line on stderr, its mean within 1% of
     the same scene's general-tier render on the CPU (96×64×32);
 44. checkpoint, kill and resume: the kernel on cornell_box_baseline
     (800×800×500, 5 chunks) stopped after 2 chunks and resumed, and the
     same checkpoint resumed in 64-sample chunks; the general tier on
     cornell_box 128×128×16 in 4 blocks stopped after 2 and resumed; each
     PPM byte-equal to an uninterrupted render, with `checkpoint_io`'s
     seconds a chunk or block.
 45. the general tier under autograd against K2/K3: the gradient of the
     mean weighted radiance into the six scene tables through
     `integrator.trace(differentiable=True)` (checkpointed bounces, torch
     ops) and through `trace_fast`, on identical `fast_draws`, at 262,144
     lanes: the default inverse scene at the trainer's start (depth 6), the
     geometry scene at zero tilt (the sky, θ's rows; depth 6) and the
     probe scene of phases 24-28 (depths 6 and 16). A lane whose winners
     differ from K2's tape took another branch on an ulp
     (`decision_flips`): at most FLIP_SHARE of the lanes may; on every
     other lane the radiance within 2e-4 (+ 2e-4 relative); the general
     tier also runs in float64 on the same inputs, and a lane whose f32
     gradient into its own ray (d_o, d_d) is off that run's by more than
     1e-4 of its scale is rounding-limited in f32 (at most ILL_SHARE of
     the lanes; the test reads no answer of K3, and K3's distance from
     float64 on those lanes is printed beside the general tier's); each
     table's gradient of the loss over the remaining lanes within 5e-4 of
     the fused tier's largest |gradient| in it, every gradient finite; the
     worst ratio per table (also over all lanes, and each f32 tier's
     against the float64 run, for the record) and both f32 tiers' forward
     + backward times;
 46. `benchlib.grad_fd_err` (64 rays, depth 8) with its breakdown: the
     worst |autograd − central difference| ≤ 1e-3, all five sweeps;
 47. the trainer's general-tier modes through `inverse_render.main`: the
     fused default (40 steps) and `--no-fast` at the default size (200×200,
     4,096 × 64 spp, depth 6, 40 steps: albedo within 0.1, emission within
     0.5, no K2 launch), their median step times side by side; `--quick`
     (albedo within 0.08); `--geometry --no-fast` cut to GEO_NO_FAST_STEPS
     of its 200 steps (the emission rises, the tilt moves off 0). Each run
     must print its tier.
 48. sharding at one rank on NCCL: `render --scene cornell_box --nx 800
     --ny 800 --spp 32 --sharded` (depth 50) through the command line and
     `render_sums_sharded` in this process on a one-rank NCCL group,
     against the general tier's `render_sums` at the same size and seed:
     the sums and the PPM bit for bit, no kernel launch;
 49. two ranks on the one card under gloo on CUDA tensors (NCCL refuses
     two ranks on one GPU; `chip_smoke.py --sharded-rank DIR`, spawned by
     `parallel.multihost_worker.launch`): the same render on meshes (2, 1),
     bit-equal to one rank, and (1, 2), within 1e-12 relative and 1 f32
     ulp of the image; both ranks' sums equal;
 50. on both meshes, the trainer's sharded step at full width (step 0's
     4,096 pixels × 64 spp, depth 6, its `fast_draws`): the target through
     `render_block_sharded`, the loss and tex_color's gradient through
     `train_step_sharded`, against one rank's `lane_radiance` and
     `train_step`: the loss within 1e-6 relative, the gradient within 1e-5
     of its largest |value|; both ranks equal; each side's step time;
 51. the trainer's multi-rank default, `inverse_render.main(["--device",
     "cuda"])` in both ranks (mesh (1, 2), 40 steps on the general tier):
     both exit 0 (albedo within 0.1, emission within 0.5), no K1, K2 or K3
     launch, the sharded tier printed by rank 0 alone; its median step
     beside phase 47's one-rank `--no-fast` step. Two ranks on one card
     show correctness, not multi-GPU scaling, which is not measured.
 52. the general tier's BVH (`accel/bvh.py`): `bvh_closest_hit` against
     the dense `closest_hit` on one chunk of camera rays of final_scene
     (128×128×100) and of big_spheres(30000) (256×144×16): the same mask
     and prim on all but BVH_FLIP_SHARE of the lanes (the count printed),
     t within 1e-4; then `render --scene final_scene --nx 128 --ny 128
     --engine xla --bvh on` (100 spp, depth 50) against phase 42's dense
     image (`--bvh off`): the means within 2e-3 relative and under 0.5% of
     the pixels apart by more than 1e-3 (JAX's gates at 12k prims), no
     kernel launch; both runs' bvh_build, trace and rays/s, the traversal's
     iterations a call and the share of its lanes live at its end;
 53. the crossover: `bench_large` at its defaults (big_spheres(n) for n of
     1,000 to 100,000 at 64×36, 4 spp, depth 8: the dense scan, the BVH
     and K1), and `render._BVH_AUTO_MIN_PRIMS["cuda"]` equal to its
     crossover (None where the BVH wins at no size);
 54. the parity sweep, `parity --quick --json` in this process: exit 0,
     every one of its 11 configs and 8 extra checks reported and passed
     (one line a check), with K1's, K1f's table's and K2/K3's launches.
 55. `bench` through the command line at its defaults (`benchlib.run`:
     cornell_box_baseline 800×800×500 through the auto engine, a warm
     render and 8 timed ones; `grad_fd_err`; the default training step's
     throughput on the fused tier, in 100-step chunks and on the general
     tier): every key of JAX's line, engine "kernel" with phase 5's K1a
     launches a render, grad_engine "fused" with K2 and K3 launched,
     grad_fd_max_abs_err ≤ 1e-3 with all five sweeps; its figures printed;
 56. `python -m raytracing_rust_tpu_torch render --scene
     cornell_box_baseline --profile DIR --log PATH --timers` with the bar
     on, as a process of its own (torch.profiler has recorded the card's
     activity in a process's first profiler session alone): the
     Chrome trace holds a CUDA kernel event of K1 (`trace_k1`), the log
     JAX's four lines (the request, the trace, the timers, the result)
     with their stamps, stderr the bar at 100.0% once, the PPM's values
     equal to phase 5's;
 57. `bench_scenes` (the eight reference configs through K1, best of 3)
     and `make_gallery` into a temporary directory: eight lines with their
     rays/s, eight PNGs, each mean within ±5% of GALLERY_MEANS, with K1a's,
     K1f's table's and the walk's launches; `alive_profile` at its
     defaults on the card (four scenes, 16,384 lanes): a line a scene, each
     profile starting at 1.0 and falling, and cornell_box's fractions at
     ALIVE_N lanes on the card within 4 binomial standard errors of the
     same profile on the CPU;
 58. `profile_train_step` at the default width on both tiers
     (PROFILE_STEPS steps a loop): the parts that partition a step within
     PROFILE_SUM_TOL of the whole step, K2 + K3 by CUDA events inside the
     fused step; its table printed. Then `profile_train_step --tier fused
     --trace DIR` as a process of its own: the Chrome trace holds CUDA
     kernel events of K2 (`grad_fwd`) and K3 (`grad_bwd`).
Then the script's own seconds. Phases 41-58 print the card's name and
power limit beside their numbers and their own seconds. Every
command-line phase prints its per-phase seconds, the PPM encode
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


def k1_bound(ops, counts: dict, n_pix: int, n_samples: int,
             probe: bool = False) -> dict:
    """K1's bound on this run's paths: the operations and bytes of
    `tracer.k1_work` (trace_plain's counts times tracer.K1_OPS, the
    operations of csrc/tracer.cu per item, counted from its source), the
    cull's slab tests those of an exact two-level cull; beside it, as
    bound_ms_one_level, the same with a slab test of every leaf a segment
    (the one-level cull's work, the yardstick of the rows before it). probe:
    the cost probe's work, the paths without their colours or sums."""
    from raytracing_rust_tpu_torch.ops.tracer import k1_work
    return dict(**bound(*k1_work(ops, counts, n_pix, n_samples,
                                 probe=probe)),
                bound_ms_one_level=bound(*k1_work(
                    ops, counts, n_pix, n_samples, one_level=True,
                    probe=probe))["bound_ms"])


@contextlib.contextmanager
def recording(log: list, counters):
    """Every K1 launch made through `tracer.trace` or `tracer.trace_probe`
    inside the block, appended to `log` as a dict: its operands (`ops`),
    its keyword arguments (`kw`, the stats buffer and the probe's steps row
    left out), whether it carried a stats buffer (`stats`; the probe always
    does), whether it is the cost probe's launch (`probe`), and the launch
    counters it moved (`counted`: the keys of `counters()` that grew across
    the call). The launch is the wrapper's own; only its arguments are
    kept."""
    from raytracing_rust_tpu_torch.ops import tracer
    real = {name: getattr(tracer, name) for name in ("trace", "trace_probe")}

    def logger(name):
        def logged(ops, out, **kw):
            before = counters()
            res = real[name](ops, out, **kw)
            after = counters()
            probe = name == "trace_probe"
            log.append(dict(
                ops=ops, probe=probe,
                stats=probe or kw.get("stats") is not None,
                kw={k: v for k, v in kw.items() if k not in ("stats", "steps")},
                counted=[k for k in after if after[k] > before[k]]))
            return res
        return logged
    for name in real:
        setattr(tracer, name, logger(name))
    try:
        yield log
    finally:
        for name, fn in real.items():
            setattr(tracer, name, fn)


def replay(launch: dict, held: dict):
    """One K1 launch of `recording`, made again on the same operands and
    arguments → (its figures, its sums; None for the probe). Its ms: CUDA
    events, two launches after a warm-up, on fresh sums (and, for a stats
    launch, a fresh stats buffer). Its counters: the stats launch it is, or
    a stats launch of the same arguments. Its sums held bit for bit to the
    same samples launched in chunks of held["spp"] (the samples its scene's
    comparison holds to trace_plain; the production instantiation). Its
    bound: held["work"] (trace_plain's counts on that comparison) scaled by
    this launch's segments over the comparison's, on this launch's pixels
    and samples. Its instantiation: the one its timed launches ran. The
    cost probe (`replay_probe`) instead."""
    import torch
    from raytracing_rust_tpu_torch import kernel_stats
    from raytracing_rust_tpu_torch.ops import tracer
    if launch["probe"]:
        return replay_probe(launch, held), None
    ops, kw = launch["ops"], launch["kw"]
    nx, ny, n, s0 = kw["nx"], kw["ny"], kw["n_samples"], kw["sample0"]
    n_pix, dev = nx * ny, ops.rec.device
    pix, kpix, dda = kw.get("pix"), kw.get("kpix", 1), kw.get("dda", False)

    def zeros():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=dev)

    whole, st = zeros(), tracer.new_stats(nx, ny, dev, pix, kpix, dda=dda)
    ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    if launch["stats"]:
        ms = cuda_ms(lambda: tracer.trace(ops, whole.zero_(),
                                          stats=st.zero_(), **kw), reps=2)
    else:
        ms = cuda_ms(lambda: tracer.trace(ops, whole.zero_(), **kw), reps=2)
    ran = sorted(tracer.K1_INSTANTIATION_LAUNCHES - ran)
    if not launch["stats"]:
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
        stats=launch["stats"], dda=dda, counted=launch["counted"],
        instantiation=ran, ms=ms,
        **k1_bound(ops, {k: v * scale for k, v in work.items()}, n_pix, n),
        segments=occ["segments"], warp_steps=occ["warp_steps"],
        occupancy=occ["occupancy"], tail_share=occ["tail_share"],
        chunk_spp=step, equals_chunks=bool(torch.equal(whole, parts))), whole


def replay_probe(launch: dict, held: dict) -> dict:
    """A cost probe launch of `recording` (`tracer.trace_probe`), made
    again on the same operands and arguments → its figures: ms (CUDA
    events, two launches after a warm-up, on a fresh row; the instantiation
    they ran), its segments,
    and its warp steps from its own steps row (occupancy, tail share); its
    row held bit for bit to row 0 of the stats launch of the same samples
    on the scanline layout (`equals_scanline`: what the render's table is
    made from before this probe), and its bound as `replay`'s on the
    probe's own work (`k1_work`'s probe: the paths, without what only
    colours them and without the sums)."""
    import torch
    from raytracing_rust_tpu_torch.ops import tracer
    ops, kw = launch["ops"], launch["kw"]
    nx, ny, n, split = kw["nx"], kw["ny"], kw["n_samples"], kw["split"]
    n_pix, dev = nx * ny, ops.rec.device
    busy = torch.zeros(n_pix, dtype=torch.int64, device=dev)
    ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    ms = cuda_ms(lambda: tracer.trace_probe(ops, busy.zero_(), **kw), reps=2)
    ran = sorted(tracer.K1_INSTANTIATION_LAUNCHES - ran)
    steps = torch.zeros(tracer.probe_warps(nx, ny, split), dtype=torch.int64,
                        device=dev)
    tracer.trace_probe(ops, busy.zero_(), steps=steps, **kw)
    st = tracer.new_stats(nx, ny, dev)
    tracer.trace(ops, torch.zeros((3, n_pix), dtype=torch.float64,
                                  device=dev), stats=st,
                 **{k: v for k, v in kw.items() if k != "split"})
    seg, warp_steps = int(busy.sum()), int(steps.sum())
    occ = seg / (32 * warp_steps)
    work = held["work"]
    scale = seg / (work["segments"] + work["walk"])
    return dict(
        shape=[ny, nx, n], sample0=kw["sample0"], kpix=1, table=False,
        stats=True, probe=True, split=split, instantiation=ran,
        blocks=split * tracer.probe_tiles(nx, ny), dda=False,
        counted=launch["counted"], ms=ms,
        **k1_bound(ops, {k: v * scale for k, v in work.items()}, n_pix, n,
                   probe=True),
        segments=seg, warp_steps=warp_steps, occupancy=occ,
        tail_share=1.0 - occ,
        equals_scanline=bool(torch.equal(busy,
                                         tracer.stats_rows(st, n_pix)[0])))


def picked(ops, **kw) -> str:
    """The name of the K1 instantiation a launch of ops runs, by the host's
    counterpart of csrc/tracer.cu `pick` (`tracer.k1_instantiation`; kw:
    table, stats)."""
    from raytracing_rust_tpu_torch.ops import tracer
    return f"trace_k1<{','.join(map(str, tracer.k1_instantiation(ops, **kw)))}>"


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


# phase 42: final_scene's sizes and samples on both engines, 128×128 at its
# preset's 100 spp and 800×800 at 4 (the general tier tests every one of
# its 3,400 prims densely)
R5_SIZES = ((128, None), (800, 4))
# phase 44: the general tier's kill-and-resume on cornell_box (size², spp)
CK_GENERAL = (128, 16)
# phase 43: the fallback renders' size (nx, ny, spp) and the band of the
# card's mean around the CPU's (the same draws; only rounding differs)
FB_SIZE = (96, 64, 32)
FB_BAND = 0.01


def general_phases(dev, smi: str, run_cli, cornell_img, reset_launches,
                   k1_launches) -> dict:
    """Phases 41-44: the general tier at full width against the kernel's
    image (cornell_img, phase 5's), R5's engines on final_scene, the
    fallback of `--engine auto`, and checkpoint kill-and-resume on both
    engines. run_cli, reset_launches, k1_launches: main's. → phase 42's
    dense general-tier run of final_scene at 128×128: {"info", "img"}."""
    import shutil

    import numpy as np
    import torch
    from raytracing_rust_tpu_torch import cli
    from raytracing_rust_tpu_torch import render as trender
    from raytracing_rust_tpu_torch.models.builders import PRESETS
    from raytracing_rust_tpu_torch.ops import tracer
    from raytracing_rust_tpu_torch.utils.image_io import to_ppm
    from raytracing_rust_tpu_torch.utils.timers import Timers

    def render_seconds(info):
        # the CLI's render phases: its timers without scene build and encode
        return sum(v for k, v in info["timers"].items()
                   if k not in ("scene_build", "encode"))

    # -- 41. the general tier on the card at full width: the command line
    # with --engine xla on cornell_box_baseline (800×800, 500 spp, depth
    # 50), held to the kernel's image of phase 5 (the same seed and draws)
    p = PRESETS["cornell_box_baseline"]
    nx, ny = p.nx, p.ny
    t_phase = time.perf_counter()
    info, img = run_cli("cornell_box_baseline", "--engine", "xla")
    lum = info["mean_luminance"]
    same_bytes = float((img == cornell_img).all(axis=-1).mean())
    emit("general_path", **info, card=smi, band=list(CORNELL_BAND),
         phase_seconds=time.perf_counter() - t_phase,
         render_seconds=render_seconds(info), primary_rays_per_s=(
             nx * ny * p.spp / render_seconds(info)),
         kernel_mean_luminance=float(cornell_img.mean()),
         channel_means=img.reshape(-1, 3).mean(axis=0).tolist(),
         kernel_channel_means=cornell_img.reshape(-1, 3).mean(axis=0)
         .tolist(), pixels_with_the_kernels_bytes=same_bytes)
    check(info["launches"]["k1a_static_trace"] == 0,
          "--engine xla launched the kernel")
    check(img.shape == (ny, nx, 3) and CORNELL_BAND[0] < lum < CORNELL_BAND[1],
          f"general tier: mean luminance {lum:.4f} outside {CORNELL_BAND}")
    # the sums of both engines at 8 spp, per pixel and channel
    t_phase = time.perf_counter()
    scene, cam = p.build(device=dev), p.camera(device=dev)
    g8 = trender.render_sums(scene, cam, nx, ny, 8, device=dev)
    ops = tracer.trace_operands(tracer.build_scene_record(scene),
                                tracer.build_camera_record(cam), dev)
    k8 = tracer.trace(ops, torch.zeros_like(g8), nx=nx, ny=ny, seed=0,
                      sample0=0, n_samples=8, max_depth=50)
    agree = float(torch.isclose(g8, k8, rtol=1e-4, atol=0.0).all(dim=0)
                  .double().mean())
    gm, km = g8.mean(dim=1), k8.mean(dim=1)
    emit("general_vs_kernel", card=smi, shape=[ny, nx], spp=8,
         phase_seconds=time.perf_counter() - t_phase,
         pixels_within_rel_1e4=agree, general_channel_means=gm.tolist(),
         kernel_channel_means=km.tolist(),
         channel_mean_max_rel=float(((gm - km).abs() / km).max()))
    check(agree >= 0.99, f"general tier vs kernel: only {agree:.4%} of "
          "pixels within 1e-4")
    del g8, k8, ops

    # -- 42. R5: final_scene on both engines at each of R5_SIZES
    t_phase = time.perf_counter()
    r5, dense128 = [], None
    for size, spp in R5_SIZES:
        row = dict(size=[size, size], spp=spp or PRESETS["final_scene"].spp)
        for engine in ("kernel", "xla"):
            # the general tier's dense scan, whatever `--bvh auto` picks
            extra = ["--nx", str(size), "--ny", str(size), "--engine", engine,
                     *(["--bvh", "off"] if engine == "xla" else [])]
            info, img = run_cli("final_scene", *extra,
                                *(["--spp", str(spp)] if spp else []))
            if engine == "xla" and size == 128:
                dense128 = dict(info=info, img=img)
            row[engine] = dict(
                render_seconds=render_seconds(info),
                primary_rays_per_s=(size * size * row["spp"]
                                    / render_seconds(info)),
                wall_seconds=info["wall_seconds"], timers=info["timers"],
                mean_luminance=info["mean_luminance"])
            check(bool(np.isfinite(img).all()) and img.mean() > 0.0,
                  f"final_scene {size}² on {engine}: a bad image")
        row["faster"] = min(("kernel", "xla"),
                            key=lambda e: row[e]["render_seconds"])
        row["general_over_kernel_seconds"] = (row["xla"]["render_seconds"]
                                              / row["kernel"]["render_seconds"])
        r5.append(row)
    emit("r5_engines", card=smi, scene="final_scene", sizes=r5,
         phase_seconds=time.perf_counter() - t_phase)

    # -- 43. the fallback: scenes the kernel refuses through `--engine
    # auto`'s choice (`cli.render_scene`) on the card, held to the same
    # scene's general-tier render on the CPU (the same draws)
    t_phase = time.perf_counter()
    fb = []
    for name, build in (("nine_media", nine_media_scene),
                        ("rotated_image_sphere", rotated_image_scene)):
        cam_d, cam_c = (fallback_camera(FB_SIZE[0], FB_SIZE[1], dv)
                        for dv in (dev, "cpu"))
        kw = dict(seed=0, max_depth=50)
        try:
            cli.render_scene(build(dev), cam_d, *FB_SIZE, engine="kernel",
                             device=dev, **kw)
            refused = False
        except tracer.UnsupportedScene:
            refused = True
        reset_launches()
        err = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stderr(err):
            img, engine = cli.render_scene(build(dev), cam_d, *FB_SIZE,
                                           engine="auto", device=dev, **kw)
        seconds = time.perf_counter() - t
        k1 = sum(k1_launches().values())
        ref, _ = cli.render_scene(build("cpu"), cam_c, *FB_SIZE,
                                  engine="xla", device="cpu", **kw)
        rel = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
        fb.append(dict(scene=name, size=list(FB_SIZE), engine=engine,
                       kernel_refused=refused, kernel_launches=k1,
                       seconds=seconds, stderr=err.getvalue().strip(),
                       mean=float(img.mean()), cpu_mean=float(ref.mean()),
                       mean_rel=rel, band_rel=FB_BAND))
        check(refused and engine == "xla" and k1 == 0,
              f"{name}: the kernel did not refuse it, or auto did not fall "
              f"back ({engine}, {k1} kernel launches)")
        check(rel < FB_BAND, f"{name}: the card's mean {img.mean():.5f} vs "
              f"the CPU's {ref.mean():.5f}")
    emit("fallback", card=smi, scenes=fb,
         phase_seconds=time.perf_counter() - t_phase)

    # -- 44. checkpoint, kill and resume: K1 on cornell_box_baseline
    # (800×800×500, 5 chunks) stopped after 2 chunks, resumed with its
    # chunks and with 64-sample ones; the general tier on 4 blocks of
    # cornell_box 128×128×16 stopped after 2; each byte-equal to an
    # uninterrupted render
    t_phase = time.perf_counter()
    scene, cam = p.build(device=dev), p.camera(device=dev)
    ck_rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        path, kept = (os.path.join(tmp, n) for n in ("k.npz", "k2.npz"))
        full = to_ppm(tracer.render_kernel(scene, cam, nx, ny, p.spp,
                                           device=dev))
        tm = Timers()
        stopped = tracer.render_kernel(scene, cam, nx, ny, p.spp, device=dev,
                                       checkpoint=path, timers=tm,
                                       _stop_after_chunks=2)
        shutil.copy(path, kept)
        with np.load(path) as z:
            done = int(z["done"])
        res = [to_ppm(tracer.render_kernel(scene, cam, nx, ny, p.spp,
                                           device=dev, checkpoint=path,
                                           timers=tm))]
        shutil.copy(kept, path)
        res.append(to_ppm(tracer.render_kernel(
            scene, cam, nx, ny, p.spp, device=dev, spp_chunk=64,
            checkpoint=path, timers=tm)))
        n_saves = 2 + sum(len(tracer.launch_plan(nx * ny, p.spp, dev, c,
                                                 done)[1]) for c in (None, 64))
        ck_rows["kernel"] = dict(
            shape=[ny, nx], spp=p.spp, stopped_after_chunks=2, done=done,
            resumed_equal=res[0] == full, resumed_spp_chunk_64_equal=(
                res[1] == full), checkpoint_io_seconds=tm.summary().get(
                    "checkpoint_io"), saves=n_saves,
            checkpoint_io_seconds_per_chunk=tm.summary().get(
                "checkpoint_io", 0.0) / n_saves)
        check(stopped is None and done < p.spp and res[0] == full
              and res[1] == full, f"K1's resumed render differs: "
              f"{ck_rows['kernel']}")
        g, gspp = CK_GENERAL
        gp = dataclasses.replace(PRESETS["cornell_box"], nx=g, ny=g)
        gs, gc = gp.build(device=dev), gp.camera(device=dev)
        gkw = dict(device=dev, block_pixels=g * g // 4)
        gfull = to_ppm(trender.render(gs, gc, g, g, gspp, **gkw))
        gpath = os.path.join(tmp, "g.npz")
        tm = Timers()
        gstop = trender.render(gs, gc, g, g, gspp, checkpoint=gpath,
                               timers=tm, _stop_after_blocks=2, **gkw)
        gres = to_ppm(trender.render(gs, gc, g, g, gspp, checkpoint=gpath,
                                     timers=tm, **gkw))
        ck_rows["general"] = dict(
            shape=[g, g], spp=gspp, blocks=4, stopped_after_blocks=2,
            resumed_equal=gres == gfull,
            checkpoint_io_seconds=tm.summary().get("checkpoint_io"),
            checkpoint_io_seconds_per_block=tm.summary().get(
                "checkpoint_io", 0.0) / 4)
        check(gstop is None and gres == gfull,
              "the general tier's resumed render differs")
    emit("checkpoint_resume", card=smi, **ck_rows,
         phase_seconds=time.perf_counter() - t_phase)
    return dense128


# phase 45: (scene, depth) of the general tier's autograd against K2/K3
AUTOGRAD_CASES = (("inverse_render", 6), ("geometry", 6),
                  ("probe_scene", 6), ("probe_scene", 16))
# phase 45: pixels × samples, the training step's full width
AUTOGRAD_BLOCK, AUTOGRAD_SPP = 4096, 64
# phase 45: the share of lanes a decision on an ulp may send down another
# path than K2's (`decision_flips`; on the CPU, general tier against the
# plain twin at these widths: 5 of 262,144 lanes on the geometry scene, 2
# on probe_scene, 0 on the inverse scene)
FLIP_SHARE = 1e-4
# phase 45: the share of the other lanes that may be rounding-limited in
# f32: the general tier's gradient into the lane's own ray (d_o, d_d) off
# the same tier's float64 run by more than 1e-4 of the lane's scale (a
# refraction near the critical angle, a tangent hit, a long chain inside
# the glass, a path that float64 sends another way). The test reads no
# answer of K3. On the CPU at 32,768 lanes: 0 on the inverse scene, 69
# and 83 on the geometry scene, 97 on probe_scene at depth 6, 123 and 144
# at depth 16 (0.21-0.44%); on those lanes the plain twin of K3 is off
# float64 by 1.0× the general tier's error at the median
ILL_SHARE = 1e-2
# phase 47: the geometry trainer's steps on the general tier (its default
# is 200; cut so that phases 45-47 stay near 120 s: a step takes about
# 1.3 s on an H100 80GB HBM3 at 700 W, PERF.md §6)
GEO_NO_FAST_STEPS = 20


def decision_flips(scene, o, d, u, md: int, tape):
    """The lanes whose path through the general tier is not K2's →
    bool[N]: at a bounce where the general tier's lane is alive, its
    closest hit's winner (−1 on a miss) is not the one K2's tape holds.
    Such a lane took another branch on an ulp (a hit at t ≈ T_MIN, an
    edge, a comparison with a draw), so its radiance and gradient belong
    to another path, not to a fault of either tier. K2 leaves a dead
    lane's later entries unwritten: on a lane the general tier keeps alive
    longer than K2 they hold no winner and count as a flip, and a lane
    that K2 keeps alive longer is not flagged here, so its radiance is
    held to K2's (the gate fails, it does not pass, on either)."""
    import torch
    from raytracing_rust_tpu_torch.ops import grad, integrator, intersect
    pack = intersect.plan_pack(scene)
    n = o.shape[0]
    time_ = torch.zeros(n, device=o.device)
    st = (o, d, torch.ones_like(o), torch.zeros_like(o),
          torch.ones(n, dtype=torch.bool, device=o.device))
    rows = []
    with torch.no_grad():
        for b in range(md + 1):
            hit = intersect.closest_hit(scene, st[0], st[1], time_,
                                        integrator.T_MIN, pack=pack)
            rows.append(torch.where(st[4], hit.idx, grad.TAPE_NONE))
            st = integrator._bounce(scene, pack, u[b].T, md, b, st[0],
                                    st[1], time_, *st[2:])
    win = torch.stack(rows)
    code = tape[:, 0].long()
    k2_win = torch.where(code >= 0, code >> grad.TAPE_SHIFT, code)
    alive = win != grad.TAPE_NONE
    return (alive & (win != k2_win)).any(dim=0)


def _leaf_grads(scene, names, run, o, d):
    """run(scene with the float tables `names` as fresh leaves, o, d as
    fresh leaves) → (radiance, the loss) → (radiance detached, {table or
    "o", "d": gradient})."""
    import torch
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in names}
    rays = {k: x.detach().clone().requires_grad_(True)
            for k, x in (("o", o), ("d", d))}
    rad, loss = run(dataclasses.replace(scene, **leaves), rays["o"],
                    rays["d"])
    leaves.update(rays)
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return rad.detach(), {k: torch.zeros_like(v) if x is None else x
                          for (k, v), x in zip(leaves.items(), g)}


def as_float64(scene):
    """scene with every float table in float64 (the integer tables kept)."""
    import torch
    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).double()
        for f in dataclasses.fields(scene)
        if isinstance(getattr(scene, f.name), torch.Tensor)
        and getattr(scene, f.name).is_floating_point()})


def autograd_phases(dev, smi: str, reset_launches) -> float:
    """Phases 45-47: the general tier under autograd on the card against
    K2/K3, grad_fd_err, and the trainer's general-tier modes → phase 47's
    median `--no-fast` step in seconds. reset_launches: main's."""
    import numpy as np
    import torch
    from raytracing_rust_tpu_torch import benchlib
    from raytracing_rust_tpu_torch import inverse_render as ir
    from raytracing_rust_tpu_torch.ops import grad, integrator

    # -- 45. the general tier's autograd (`trace(differentiable=True)`)
    # against K2/K3 (`trace_fast`) on identical fast_draws at 262,144
    # lanes: at most FLIP_SHARE of the lanes on another path than K2's
    # (`decision_flips`); on every other lane the radiance within 2e-4
    # (+ 2e-4 relative); at most ILL_SHARE of them rounding-limited in f32
    # (the general tier off its own float64 run); and each scene table's
    # gradient of the loss over the rest within 5e-4 of K3's largest
    # |gradient| in it
    t_phase = time.perf_counter()
    block, spp = AUTOGRAD_BLOCK, AUTOGRAD_SPP
    n = block * spp
    r = np.random.default_rng(3)
    probe_d = torch.from_numpy(np.stack(
        [r.uniform(-0.7, 0.7, n), r.uniform(-0.45, 0.25, n), -np.ones(n)],
        -1).astype(np.float32)).to(dev)
    probe_o = torch.tensor([0.0, 2.0, 8.0], device=dev).expand(n, 3)
    kw = dict(nx=200, ny=200, spp=spp, block=block, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w = torch.rand(n, 3, generator=g, device=dev) + 0.5
    names = ("prim_data", "mat_param", "tex_color", "xf_offset", "xf_sin",
             "xf_cos")
    cases = []
    for name, md in AUTOGRAD_CASES:
        if name == "inverse_render":
            scene = ir.build_scene(ir.START_ALBEDO, ir.START_EMIT, device=dev)
            o, d, u = ir.step_inputs(ir.camera(dev), 0, max_depth=md, **kw)
        elif name == "geometry":
            scene = ir.build_geo_scene(device=dev)
            o, d, u = ir.step_inputs(ir.geo_camera(dev), 0, max_depth=md,
                                     **kw)
        else:
            scene = grad_probe_scene(dev)
            o, d = probe_o.contiguous(), probe_d
            u = grad.fast_draws(7, n, md + 1, dev)
        cfg = grad.fast_grad_config(scene)
        _, tape = grad.grad_fwd(grad.fast_grad_record(scene).detach(), o, d,
                                u, cfg, md, tape=True)
        flips = decision_flips(scene, o, d, u, md, tape)

        def general(s, oo, dd, wt):
            rad = integrator.trace(
                s, oo, dd, torch.zeros(n, dtype=oo.dtype, device=dev), 0,
                None, None, md, differentiable=True, u=u.to(oo.dtype))
            return rad, torch.mean(wt.to(oo.dtype) * rad)

        def fused(s, oo, dd, wt):
            rad = grad.trace_fast(s, oo, dd, 0, max_depth=md, cfg=cfg, u=u)
            return rad, torch.mean(wt * rad)

        def tiers(wt):
            """(radiance, gradients) of the general tier, K2/K3 and the
            general tier in float64, the loss weighted by wt."""
            return [_leaf_grads(sc, names,
                                lambda s, oo, dd: f(s, oo, dd, wt), oo, dd)
                    for f, sc, oo, dd in (
                        (general, scene, o, d), (fused, scene, o, d),
                        (general, as_float64(scene), o.double(),
                         d.double()))]

        def ratios(g_a, g_b):
            return {k: float((g_a[k].double() - g_b[k].double()).abs().max())
                    / max(float(g_b[k].abs().max()), 1e-3) for k in names}

        def ray_grad(gr):
            return torch.cat([gr["o"], gr["d"]], dim=1).double()

        (rad_g, g_g), (rad_f, g_f), (_, g_64) = tiers(w)
        err = (rad_g - rad_f).abs()
        off = (err > 2e-4 + 2e-4 * rad_f.abs()).any(dim=1)
        # each lane's gradient into its own ray against float64's, over the
        # lane's scale (floored at 1e-3 of the median lane's)
        ray_64 = ray_grad(g_64)
        lane_scale = ray_64.abs().amax(dim=1)
        lane_scale = torch.clamp(lane_scale,
                                 min=1e-3 * float(lane_scale.median()))
        off_g = (ray_grad(g_g) - ray_64).abs().amax(dim=1) / lane_scale
        off_f = (ray_grad(g_f) - ray_64).abs().amax(dim=1) / lane_scale
        ill = ~flips & (off_g > 1e-4)
        finite = all(bool(torch.isfinite(x).all())
                     for x in (rad_g, *g_g.values()))
        all_lanes = ratios(g_g, g_f)
        k3_over_general = (off_f[ill] / off_g[ill]).cpu()
        set_aside = dict(
            lanes=int(ill.sum()),
            general_off_float64_max=float(off_g[ill].max()) if ill.any()
            else 0.0,
            k3_off_float64_max=float(off_f[ill].max()) if ill.any() else 0.0,
            k3_over_general_off_float64_median=float(
                k3_over_general.median()) if ill.any() else None,
            k3_over_general_off_float64_max=float(
                k3_over_general.max()) if ill.any() else None,
            k3_nearer_float64=int((off_f[ill] < off_g[ill]).sum()))
        del g_64
        keep = w * (~(flips | ill)).to(w.dtype)[:, None]
        (_, g_g), (_, g_f), (_, g_64) = tiers(keep)
        held = ratios(g_g, g_f)
        # for the record: each f32 tier's table gradients against float64
        # (a leaf whose gradient cancels, as xf_cos at zero tilt, is off
        # float64 alike in both)
        float64_ratios = dict(general=ratios(g_g, g_64), k3=ratios(g_f, g_64))
        # warm: the comparison above ran it twice
        gen_ms = cuda_ms(lambda: _leaf_grads(
            scene, names, lambda s, oo, dd: general(s, oo, dd, w), o, d),
            reps=1, warm=False)
        fused_ms = cuda_ms(lambda: _leaf_grads(
            scene, names, lambda s, oo, dd: fused(s, oo, dd, w), o, d),
            reps=5)
        n_flips, n_ill = int(flips.sum()), int(ill.sum())
        case = dict(
            scene=name, depth=md, lanes=n, decision_flips=n_flips,
            rounding_limited_lanes=set_aside,
            radiance_max_abs_err_same_path=float(err[~flips].max()),
            radiance_max_abs_err_all=float(err.max()),
            lanes_off_2e4=int(off.sum()),
            lanes_off_2e4_on_the_same_path=int((off & ~flips).sum()),
            worst_grad_err_over_scale=held,
            worst_err_over_float64_scale=float64_ratios,
            worst_grad_err_over_scale_all_lanes=all_lanes,
            grad_scale={k: float(g_f[k].abs().max()) for k in names},
            finite=finite, general_fwd_bwd_ms=gen_ms,
            fused_fwd_bwd_ms=fused_ms)
        cases.append(case)
        emit("general_autograd_case", card=smi, **case)
        check(finite, f"{name} depth {md}: a general-tier gradient is not "
              "finite")
        check(n_flips <= FLIP_SHARE * n, f"{name} depth {md}: {n_flips} "
              f"lanes on another path than K2's (> {FLIP_SHARE} of {n})")
        check(not bool((off & ~flips).any()), f"{name} depth {md}: "
              f"{int((off & ~flips).sum())} lanes on K2's path off its "
              "radiance by more than 2e-4")
        check(n_ill <= ILL_SHARE * n, f"{name} depth {md}: {n_ill} lanes' "
              "ray gradients off the general tier's float64 run by more "
              f"than 1e-4 (> {ILL_SHARE} of {n})")
        check(all(v <= 5e-4 for v in held.values()),
              f"{name} depth {md}: a gradient off K3's by more than 5e-4 of "
              f"its scale: {held}")
        del rad_g, rad_f, g_g, g_f, g_64, tape
    emit("general_autograd_vs_k2_k3", card=smi, cases=cases,
         phase_seconds=time.perf_counter() - t_phase)

    # -- 46. grad_fd_err on the card, with its breakdown
    t_phase = time.perf_counter()
    worst, per = benchlib.grad_fd_err(breakdown=True, device=dev)
    emit("grad_fd_err", card=smi, n_rays=64, max_depth=8,
         grad_fd_max_abs_err=worst, breakdown=per, bar=1e-3,
         phase_seconds=time.perf_counter() - t_phase)
    check(worst <= 1e-3 and len(per) == 5,
          f"grad_fd_err {worst} (bar 1e-3), sweeps {per}")

    # -- 47. the trainer's general-tier modes: --no-fast at the default
    # size beside the fused default, --quick, and --geometry --no-fast for
    # GEO_NO_FAST_STEPS steps
    t_phase = time.perf_counter()
    runs = {}
    for label, argv in (
            ("fused", ["--device", "cuda"]),
            ("no_fast", ["--device", "cuda", "--no-fast"]),
            ("quick", ["--device", "cuda", "--quick"]),
            ("geometry_no_fast", ["--device", "cuda", "--geometry",
                                  "--no-fast",
                                  "--steps", str(GEO_NO_FAST_STEPS)])):
        buf = io.StringIO()
        reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ir.main(argv)
        text = buf.getvalue()
        rec = [ln for ln in text.splitlines() if ln.startswith("recovered")]
        step = re.search(r"step time: ([0-9.]+)s", text)
        nums = re.findall(r"-?[0-9]+\.[0-9]+", rec[0]) if rec else []
        runs[label] = dict(
            argv=argv, rc=rc, wall_seconds=time.perf_counter() - t,
            k2_launches=grad.K2_LAUNCHES, k3_launches=grad.K3_LAUNCHES,
            tier=[ln for ln in text.splitlines()
                  if ln.startswith("differentiable tier")],
            recovered=rec[0] if rec else None,
            median_step_seconds=float(step.group(1)) if step else None,
            log=text.splitlines()[-8:])
        if label == "geometry_no_fast" and rec:
            runs[label].update(albedo=[float(x) for x in nums[:3]],
                               emission=float(nums[4]),
                               tilt_deg=float(nums[6]))
        check(rec != [], f"inverse_render.main({argv}): no summary")
        general = label != "fused"
        check((runs[label]["k2_launches"] == 0) == general,
              f"{label}: K2 launched {runs[label]['k2_launches']} times")
        check(bool(runs[label]["tier"]) and (
            "general wavefront tier" in runs[label]["tier"][0]) == general,
            f"{label}: printed tier {runs[label]['tier']}")
    emit("trainer_general_tier", card=smi, runs=runs,
         geometry_steps_cut=f"{GEO_NO_FAST_STEPS} of 200",
         no_fast_over_fused_step=(runs["no_fast"]["median_step_seconds"]
                                  / runs["fused"]["median_step_seconds"]),
         phase_seconds=time.perf_counter() - t_phase)
    for label in ("fused", "no_fast", "quick"):
        check(runs[label]["rc"] == 0,
              f"{label}: the trainer missed its criterion: "
              f"{runs[label]['recovered']}")
    geo = runs["geometry_no_fast"]
    check(all(np.isfinite(geo["albedo"])) and geo["emission"] >
          ir.START_GEO_EMIT and geo["tilt_deg"] != 0.0
          and np.isfinite(geo["tilt_deg"]),
          f"--geometry --no-fast did not move toward the truth: "
          f"{geo['recovered']}")
    return runs["no_fast"]["median_step_seconds"]


# phases 48-49: the sharded render, cornell_box (nx, ny, spp) at depth 50
SHARD_RENDER = (800, 800, 32)
# phases 49-50: the meshes of two ranks on the one card (dp, sp)
SHARD_MESHES = ((2, 1), (1, 2))
# phase 50: the step's pixel block and draws, the trainer's step 0's
SHARD_STEP_KEY = 0


def shard_preset():
    """cornell_box at SHARD_RENDER's size, as the command line sets it."""
    from raytracing_rust_tpu_torch.models.builders import PRESETS
    p = PRESETS["cornell_box"]
    return type(p)(**{**p.__dict__, "nx": SHARD_RENDER[0],
                      "ny": SHARD_RENDER[1]})


def shard_step_case(dev):
    """Phase 50's step at the trainer's full width: the target and start
    scenes, the camera, step 0's pixel block (4,096 of 200×200) and its
    draws (`fast_draws` of 4,096 × 64 lanes, depth 6), as the trainer's
    general tier makes them."""
    from raytracing_rust_tpu_torch import inverse_render as ir
    from raytracing_rust_tpu_torch.ops.grad import fast_draws
    kw = dict(nx=200, ny=200, spp=64, max_depth=6)
    pix = ir.step_pixels(SHARD_STEP_KEY, nx=200, ny=200, block=4096,
                         device=dev)
    u = fast_draws(SHARD_STEP_KEY, 4096 * 64, 7, dev)
    return (ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT, dev),
            ir.build_scene(ir.START_ALBEDO, ir.START_EMIT, dev),
            ir.camera(dev), pix, u, kw)


def sharded_rank(out: str) -> int:
    """One rank of phases 49-51, two ranks on card 0 under gloo (NCCL
    refuses two ranks on one GPU), each saving its results to
    out/rank<r>.pt: (49) `render_sums_sharded` of SHARD_RENDER on each of
    SHARD_MESHES; (50) on each mesh the trainer's sharded step at full
    width (`render_block_sharded` of the target, `train_step_sharded`),
    timed; (51) `inverse_render.main(["--device", "cuda"])`, the trainer's
    multi-rank default, its output and launch counts."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist
    from raytracing_rust_tpu_torch import inverse_render as ir
    from raytracing_rust_tpu_torch.ops import grad, tracer
    from raytracing_rust_tpu_torch.parallel import sharding

    res = {}
    with sharding.process_group("cuda", "gloo") as dev:
        rank = dist.get_rank()
        res["backend"] = dist.get_backend()
        p = shard_preset()
        scene, cam = p.build(device=dev), p.camera(device=dev)
        nx, ny, spp = SHARD_RENDER
        for dp, sp in SHARD_MESHES:
            tag = f"{dp}x{sp}"
            mesh = sharding.make_mesh(dp, sp)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sums = sharding.render_sums_sharded(scene, cam, nx, ny, spp, mesh,
                                                device=dev, max_depth=50)
            torch.cuda.synchronize()
            res[f"render_seconds {tag}"] = time.perf_counter() - t
            res[f"sums {tag}"] = sums.cpu()
        target_scene, start, cam2, pix, u, kw = shard_step_case(dev)
        for dp, sp in SHARD_MESHES:
            tag = f"{dp}x{sp}"
            mesh = sharding.make_mesh(dp, sp)
            for turn in range(2):  # the first pays the first use of its ops
                torch.cuda.synchronize()
                t = time.perf_counter()
                with torch.no_grad():
                    target = sharding.render_block_sharded(
                        target_scene, cam2, pix, SHARD_STEP_KEY, mesh=mesh,
                        u=u, **kw)
                loss, g = sharding.train_step_sharded(
                    start, cam2, pix, SHARD_STEP_KEY, target / kw["spp"],
                    mesh=mesh, u=u, **kw)
                torch.cuda.synchronize()
                res[f"step_seconds {tag} {turn}"] = time.perf_counter() - t
                res[f"tex_color {tag} turn {turn}"] = g["tex_color"].cpu()
            res[f"target {tag}"] = target.cpu()
            res[f"loss {tag}"] = loss.cpu()
            res[f"tex_color {tag}"] = g["tex_color"].cpu()
        tracer.KERNEL_LAUNCHES = grad.K2_LAUNCHES = grad.K3_LAUNCHES = 0
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res["trainer_rc"] = ir.main(["--device", "cuda"])
        res["trainer_seconds"] = time.perf_counter() - t
        res["trainer_text"] = buf.getvalue()
        res["trainer_launches"] = [tracer.KERNEL_LAUNCHES, grad.K2_LAUNCHES,
                                   grad.K3_LAUNCHES]
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    return 0


def sharded_phases(dev, smi: str, run_cli, no_fast_step: float) -> None:
    """Phases 48-51: the sharded port on the card. (48) NCCL at one rank:
    `render --sharded` through the command line and `render_sums_sharded`
    in this process, against the general tier's `render_sums` at the same
    size and seed, bit for bit; (49)-(51) two gloo ranks on the one card
    (`sharded_rank`) against one rank. Multi-GPU scaling is not measured
    here: two ranks on one card show correctness, not scaling.
    run_cli: main's; no_fast_step: phase 47's median --no-fast step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from raytracing_rust_tpu_torch import render as trender
    from raytracing_rust_tpu_torch.parallel import multihost_worker, sharding
    from raytracing_rust_tpu_torch.utils.image_io import read_ppm, to_ppm

    # -- 48. NCCL at one rank
    t_phase = time.perf_counter()
    nx, ny, spp = SHARD_RENDER
    p = shard_preset()
    scene, cam = p.build(device=dev), p.camera(device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = trender.render_sums(scene, cam, nx, ny, spp, device=dev,
                              max_depth=50)
    torch.cuda.synchronize()
    ref_seconds = time.perf_counter() - t
    ref_img = trender.finalize_image(ref.T.cpu().numpy(), spp, nx, ny)
    with sharding.process_group("cuda") as rank_dev:
        backend = dist.get_backend()
        mesh = sharding.make_mesh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        one = sharding.render_sums_sharded(scene, cam, nx, ny, spp, mesh,
                                           device=rank_dev, max_depth=50)
        torch.cuda.synchronize()
        one_seconds = time.perf_counter() - t
    check(not dist.is_initialized(), "phase 48's group outlived its render")
    info, img = run_cli("cornell_box", "--nx", str(nx), "--ny", str(ny),
                        "--spp", str(spp), "--sharded")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.ppm")
        with open(path, "w") as fh:
            fh.write(to_ppm(ref_img))
        ref_ppm = read_ppm(path)
    emit("sharded_nccl_one_rank", card=smi, backend=backend,
         shape=[ny, nx], spp=spp, max_depth=50,
         sums_equal=bool(torch.equal(one, ref)),
         cli_image_equal=bool(np.array_equal(img, ref_ppm)),
         cli=info, general_seconds=ref_seconds, sharded_seconds=one_seconds,
         phase_seconds=time.perf_counter() - t_phase)
    check(backend == "nccl", f"phase 48 ran on {backend}, not nccl")
    check(bool(torch.equal(one, ref)), "NCCL at one rank: the sums differ "
          "from the general tier's")
    check(bool(np.array_equal(img, ref_ppm)), "render --sharded: the image "
          "differs from the general tier's")
    check(not any(info["launches"].values()), "render --sharded launched "
          f"a kernel: {info['launches']}")

    # -- 49-51. two ranks on the one card under gloo
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        runs = multihost_worker.launch(
            2, [os.path.abspath(__file__), "--sharded-rank", tmp],
            one_device=True, timeout=600)
        for r, (rc, text) in enumerate(runs):
            check(rc == 0, f"sharded rank {r} exited {rc}:\n{text[-3000:]}")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    spawn_seconds = time.perf_counter() - t_phase

    # 49: the render on both meshes against one rank
    rows = {}
    for dp, sp in SHARD_MESHES:
        tag = f"{dp}x{sp}"
        got = res[0][f"sums {tag}"]
        ref_c = ref.cpu()
        rel = float(((got - ref_c).abs() / ref_c.abs().clamp_min(1e-300))
                    .max())
        g_img = trender.finalize_image(got.T.numpy(), spp, nx, ny)
        ulps = int(np.abs(g_img.view(np.int32).astype(np.int64)
                          - ref_img.view(np.int32).astype(np.int64)).max())
        rows[tag] = dict(
            ranks_equal=bool(torch.equal(got, res[1][f"sums {tag}"])),
            equal=bool(torch.equal(got, ref_c)), max_rel=rel,
            image_max_ulps=ulps,
            render_seconds=[x[f"render_seconds {tag}"] for x in res])
        check(rows[tag]["ranks_equal"], f"{tag}: the ranks' sums differ")
        if sp == 1:
            check(rows[tag]["equal"], f"{tag}: the sums differ from one "
                  "rank's")
        else:
            check(rel <= 1e-12 and ulps <= 1, f"{tag}: sums {rel:.3g} "
                  f"relative (1e-12), image {ulps} ulps (1) off one rank")
    emit("sharded_gloo_two_ranks_render", card=smi,
         backend=res[0]["backend"], shape=[ny, nx], spp=spp, max_depth=50,
         one_rank_seconds=ref_seconds, meshes=rows,
         # the two ranks' whole run: phases 49-51 and their start
         phase_seconds=spawn_seconds)
    check(res[0]["backend"] == "gloo", "phases 49-51 ran on "
          f"{res[0]['backend']}, not gloo")

    # 50: the trainer's step at full width on both meshes against one rank
    t = time.perf_counter()
    target_scene, start, cam2, pix, u, kw = shard_step_case(dev)
    walls, turns = [], []
    for turn in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            target = trender.lane_radiance(target_scene, cam2, pix,
                                           SHARD_STEP_KEY, u=u, **kw)
        loss, g = trender.train_step(start, cam2, pix, SHARD_STEP_KEY,
                                     target / kw["spp"], u=u, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        turns.append(g["tex_color"].cpu())
    target, loss, g = target.cpu(), loss.cpu(), turns[-1]
    scale = float(g.abs().max())
    steps = {}
    for dp, sp in SHARD_MESHES:
        tag = f"{dp}x{sp}"
        r0 = res[0]
        steps[tag] = dict(
            ranks_equal=all(torch.equal(r0[f"{k} {tag}"], res[1][f"{k} {tag}"])
                            for k in ("target", "loss", "tex_color")),
            target_equal=bool(torch.equal(r0[f"target {tag}"], target)),
            target_max_rel=float(((r0[f"target {tag}"] - target).abs()
                                  / target.abs().clamp_min(1e-30)).max()),
            loss=float(r0[f"loss {tag}"]), loss_one_rank=float(loss),
            loss_rel=abs(float(r0[f"loss {tag}"]) - float(loss))
            / float(loss),
            grad_err_over_scale=float((r0[f"tex_color {tag}"] - g).abs()
                                      .max()) / scale,
            # a reading: the same step twice in each process, bit for bit
            # or not (the f32 order of the gradient's sums)
            turns_equal=[torch.equal(x[f"tex_color {tag} turn 0"],
                                     x[f"tex_color {tag} turn 1"])
                         for x in res],
            step_seconds=[[x[f"step_seconds {tag} {i}"] for i in range(2)]
                          for x in res])
        check(steps[tag]["ranks_equal"], f"{tag}: the ranks' steps differ")
        check(steps[tag]["loss_rel"] <= 1e-6
              and steps[tag]["grad_err_over_scale"] <= 1e-5,
              f"{tag}: the sharded step is off one rank's: {steps[tag]}")
    emit("sharded_gloo_train_step", card=smi, lanes=4096 * kw["spp"],
         one_rank_turns_equal=bool(torch.equal(turns[0], turns[1])),
         max_depth=kw["max_depth"], grad_scale=scale, meshes=steps,
         one_rank_step_seconds=walls, phase_seconds=time.perf_counter() - t)

    # 51: the trainer's multi-rank default, 40 steps
    text = res[0]["trainer_text"]
    step = re.search(r"step time: ([0-9.]+)s", text)
    rec = [ln for ln in text.splitlines() if ln.startswith("recovered")]
    emit("sharded_gloo_trainer", card=smi,
         rcs=[x["trainer_rc"] for x in res],
         wall_seconds=[x["trainer_seconds"] for x in res],
         launches_k1_k2_k3=[x["trainer_launches"] for x in res],
         recovered=rec[0] if rec else None,
         tier=[ln for ln in text.splitlines()
               if ln.startswith("differentiable tier")],
         median_step_seconds=float(step.group(1)) if step else None,
         one_rank_no_fast_median_step_seconds=no_fast_step,
         rank1_printed=res[1]["trainer_text"].strip() != "",
         log=text.splitlines()[-6:])
    check(all(x["trainer_rc"] == 0 for x in res),
          f"the two-rank trainer missed its criterion: {rec}")
    check("sharded over dp=1 sp=2 ranks" in text, "the two-rank trainer "
          "did not print its sharded tier")
    check(all(x["trainer_launches"] == [0, 0, 0] for x in res),
          "the two-rank trainer launched a kernel")


# phase 52: the camera rays held to the dense scan: (scene, nx, ny, spp)
# of one general-tier chunk each, final_scene's at the render's size
BVH_HIT_CASES = (("final_scene", 128, 128, 100), ("big_spheres_30000", 256,
                                                  144, 16))
# phase 52: the share of lanes whose prim may differ from the dense scan's
# (a near-tangent ray whose node box f32 rounding culls, an exact tie)
BVH_FLIP_SHARE = 1e-4


def bvh_traversals(rec: list) -> dict:
    """`accel/bvh.RECORD`'s rows (lanes, iterations, live lanes at the
    last compaction) summed up: calls, iterations a call (the loop's
    iterations a bounce), and the share of a call's lanes still live in its
    last COMPACT_EVERY iterations."""
    import numpy as np
    if not rec:
        return dict(calls=0)
    lanes, iters, live = (np.asarray(x, np.float64) for x in zip(*rec))
    share = live / lanes
    return dict(calls=len(rec), lanes_max=int(lanes.max()),
                iterations_mean=float(iters.mean()),
                iterations_max=int(iters.max()),
                iterations_at_full_width=int(iters[lanes == lanes.max()]
                                             .max()),
                live_share_last_median=float(np.median(share)),
                live_share_last_max=float(share.max()))


def bvh_phases(dev, smi: str, run_cli, dense128: dict, reset_launches,
               k1_launches) -> None:
    """Phases 52-54: the BVH's closest hits against the dense scan on the
    card and its final_scene render against phase 42's dense one; the
    crossover table of `bench_large` against `auto_use_bvh`'s constant;
    the parity sweep `parity --quick`."""
    import numpy as np
    import torch
    from raytracing_rust_tpu_torch import bench_large, parity
    from raytracing_rust_tpu_torch import render as trender
    from raytracing_rust_tpu_torch.accel import bvh
    from raytracing_rust_tpu_torch.models.builders import (
        PRESETS, big_spheres, big_spheres_camera)
    from raytracing_rust_tpu_torch.ops import grad
    from raytracing_rust_tpu_torch.ops.intersect import closest_hit

    # -- 52. bvh_closest_hit against the dense closest_hit on one chunk of
    # camera rays of each case, then final_scene through the command line
    t_phase = time.perf_counter()
    hits = []
    for name, nx, ny, spp in BVH_HIT_CASES:
        if name == "final_scene":
            p = dataclasses.replace(PRESETS[name], nx=nx, ny=ny)
            scene, cam = p.build(device=dev), p.camera(device=dev)
        else:
            n = int(name.rsplit("_", 1)[1])
            scene = big_spheres(n, device=dev)
            cam = big_spheres_camera(n, nx, ny, device=dev)
        pix = torch.arange(nx * ny, device=dev).repeat(spp)
        smp = torch.arange(spp, device=dev).repeat_interleave(nx * ny)
        o, d, tm = trender.camera_sample_rays(cam, pix, smp, 0, nx, ny,
                                              scene.has_moving)
        t = time.perf_counter()
        tree = bvh.build_bvh(scene).to(dev)
        build_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        dense = closest_hit(scene, o, d, tm, 1e-3)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t
        bvh.RECORD = []
        t = time.perf_counter()
        got = bvh.bvh_closest_hit(scene, tree, o, d, tm, 1e-3)
        torch.cuda.synchronize()
        bvh_s = time.perf_counter() - t
        loop = bvh_traversals(bvh.RECORD)
        bvh.RECORD = None
        flips = (got.idx != dense.idx) | (got.mask != dense.mask)
        both = got.mask & dense.mask & ~flips
        t_rel = float(((got.t - dense.t).abs() / dense.t)[both].max())
        hits.append(dict(scene=name, lanes=o.shape[0], prims=scene.num_prims,
                         nodes=tree.num_nodes, hits=int(dense.mask.sum()),
                         near_tangency_flips=int(flips.sum()),
                         t_max_rel=t_rel, build_seconds=build_s,
                         dense_seconds=dense_s, bvh_seconds=bvh_s, loop=loop))
        check(int(flips.sum()) <= BVH_FLIP_SHARE * o.shape[0]
              and t_rel <= 1e-4, f"{name}: the BVH's hits differ from the "
              f"dense scan's on {int(flips.sum())} lanes, t by {t_rel:.3g}")
        del o, d, tm, dense, got, flips, both
    # final_scene 128×128×100, depth 50, through the CLI on the BVH
    bvh.RECORD = []
    info, img = run_cli("final_scene", "--nx", "128", "--ny", "128",
                        "--engine", "xla", "--bvh", "on")
    loop = bvh_traversals(bvh.RECORD)
    bvh.RECORD = None
    ref = dense128["img"]
    ma, mb = float(ref.mean()), float(img.mean())
    apart = float((np.abs(img - ref).max(-1) > 1e-3).mean())

    def render_s(i):
        return sum(v for k, v in i["timers"].items()
                   if k not in ("scene_build", "encode"))
    rays = 128 * 128 * PRESETS["final_scene"].spp
    emit("bvh_general_tier", card=smi, hits=hits, shape=[128, 128],
         spp=PRESETS["final_scene"].spp, max_depth=50,
         bvh=dict(timers=info["timers"], render_seconds=render_s(info),
                  primary_rays_per_s=rays / render_s(info),
                  launches=info["launches"], loop=loop, mean=mb),
         dense=dict(timers=dense128["info"]["timers"],
                    render_seconds=render_s(dense128["info"]),
                    primary_rays_per_s=rays / render_s(dense128["info"]),
                    mean=ma),
         mean_rel=abs(ma - mb) / ma, pixels_apart_1e3=apart,
         same_bytes=bool(np.array_equal(img, ref)),
         phase_seconds=time.perf_counter() - t_phase)
    check(abs(ma - mb) / ma < 2e-3 and apart < 0.005,
          f"final_scene on the BVH: mean {mb:.5f} vs dense {ma:.5f}, "
          f"{apart:.4%} of pixels apart by > 1e-3")
    check(not any(info["launches"].values()), "--engine xla --bvh on "
          f"launched a kernel: {info['launches']}")
    check("bvh_build" in info["timers"], "no bvh_build phase")

    # -- 53. the crossover: bench_large at its defaults on the card, and
    # auto_use_bvh's cuda threshold against it
    t_phase = time.perf_counter()
    reset_launches()
    table = bench_large.run(device=dev, log=lambda s: None)
    at = trender._BVH_AUTO_MIN_PRIMS["cuda"]
    emit("bvh_crossover", card=smi, **table, auto_min_prims_cuda=at,
         k1_launches=k1_launches(),
         phase_seconds=time.perf_counter() - t_phase)
    check(at == table["crossover"], f"render._BVH_AUTO_MIN_PRIMS['cuda'] "
          f"= {at}, the card's crossover {table['crossover']}")
    check(all(r["bvh_mean"] == r["dense_mean"] or abs(
        r["bvh_mean"] - r["dense_mean"]) / r["dense_mean"] < 2e-3
        for r in table["rows"]), "bench_large: a BVH image's mean is off "
        "the dense one's")

    # -- 54. the parity sweep, quick, on the card: K1 (K1f's table in
    # balance_scatter) against the general tier, K2/K3 against autograd
    t_phase = time.perf_counter()
    reset_launches()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "parity.json")
        with contextlib.redirect_stdout(buf):
            rc = parity.main(["--quick", "--json", path])
        with open(path) as fh:
            art = json.load(fh)
    launched = dict(k1_launches(), k2=grad.K2_LAUNCHES, k3=grad.K3_LAUNCHES)
    for row in art["checks"]:
        emit("parity_check", card=smi, **row)
    emit("parity_sweep", card=smi, rc=rc, passed=art["pass"],
         failures=art["failures"], checks=len(art["checks"]),
         launches=launched, tail=buf.getvalue().splitlines()[-1],
         phase_seconds=time.perf_counter() - t_phase)
    want = [*parity.CONFIGS, *parity.EXTRA_CHECKS]
    check(rc == 0 and art["pass"], f"parity --quick failed: "
          f"{[r['check'] for r in art['checks'] if not r['pass']]}")
    check([r["check"] for r in art["checks"]] == want,
          f"parity --quick reported {[r['check'] for r in art['checks']]}")
    check(sum(v for k, v in launched.items() if k.startswith("k1")) > 0
          and launched["k1f_balanced_trace"] > 0 and launched["k2"] > 0
          and launched["k3"] > 0, f"the sweep's launches: {launched}")


# phase 55: the keys of `benchlib.run`'s line (JAX's run's keys, with the
# port's engine names)
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "baseline_rays_per_sec",
    "baseline_source", "median_rays_per_sec", "wall_seconds",
    "wall_seconds_all_reps", "engine", "grad_fd_max_abs_err",
    "grad_fd_per_leaf", "grad_samples_per_sec", "grad_samples_per_sec_median",
    "grad_step_seconds", "grad_step_seconds_all_reps", "grad_engine",
    "grad_config", "grad_samples_per_sec_chunk100",
    "grad_step_seconds_chunk100", "grad_samples_per_sec_xla_scan",
    "grad_step_seconds_xla_scan", "device")
# phase 57: each gallery image's reference mean (its band is ±5%): the
# preset's mean behind phases 5-17's bands where the gallery's size and spp
# stay inside those bands (JAX's own gallery images, docs/gallery/*.png,
# rendered by tools/make_gallery.py at the same size and spp, lie within
# 0.1-3.8% of them), and for simple_light and final_scene, whose
# gamma-space means move with spp and size (JAX's gallery images sit 7.9%
# and 12.5% above the bands of phases 13-19), the mean of JAX's gallery
# image itself at the gallery's size and spp
GALLERY_MEANS = {"random_spheres": RANDOM_SPHERES_MEAN,
                 "two_spheres": TWO_SPHERES_MEAN,
                 "two_perlin_spheres": NEXT_WEEK_MEANS["two_perlin_spheres"],
                 "earth": NEXT_WEEK_MEANS["earth"],
                 "simple_light": 0.1617465773291565,
                 "cornell_box": CORNELL_MEAN,
                 "cornell_smoke": NEXT_WEEK_MEANS["cornell_smoke"],
                 "final_scene": 0.29696666464939875}
# phase 58: the training step's profile: timed steps a loop, and how far
# the parts that partition a step may sum from the whole step
PROFILE_STEPS = 8
PROFILE_SUM_TOL = 0.10
# phase 57: the lanes of cornell_box's alive profile held card against CPU
ALIVE_N = 4096


def surface_phases(dev, smi: str, cornell_img, per_render: int,
                   reset_launches, k1_launches) -> None:
    """Phases 55-58: `bench` through the command line; `render --profile
    --log` with the bar on; `bench_scenes`, `make_gallery` and
    `alive_profile`; `profile_train_step` on both tiers, and its trace."""
    import numpy as np
    from PIL import Image
    from raytracing_rust_tpu_torch import (alive_profile, bench_scenes,
                                           benchlib, cli, make_gallery,
                                           profile_train_step)
    from raytracing_rust_tpu_torch.ops import grad, tracer
    from raytracing_rust_tpu_torch.utils.image_io import read_ppm

    # -- 55. bench through the command line, at its defaults
    t_phase = time.perf_counter()
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    renders = 1 + benchlib.KERNEL_REPS
    launched = dict(k1a_static_trace=tracer.KERNEL_LAUNCHES,
                    k2=grad.K2_LAUNCHES, k3=grad.K3_LAUNCHES)
    emit("bench", card=smi, rc=rc, result=res, launches=launched,
         k1a_launches_per_render=launched["k1a_static_trace"] / renders,
         phase5_launches_per_render=per_render,
         phase_seconds=time.perf_counter() - t_phase)
    print(f"bench on {smi}: value {res['value']} rays/s, median "
          f"{res['median_rays_per_sec']}, vs_baseline {res['vs_baseline']}, "
          f"grad_samples_per_sec {res['grad_samples_per_sec']}, _chunk100 "
          f"{res.get('grad_samples_per_sec_chunk100')}, _xla_scan "
          f"{res.get('grad_samples_per_sec_xla_scan')}, device "
          f"{res['device']}", flush=True)
    missing = [k for k in BENCH_KEYS if k not in res]
    check(rc == 0 and not missing, f"bench: rc {rc}, keys missing {missing}")
    check(res["engine"] == "kernel" and launched["k1a_static_trace"]
          == renders * per_render, f"bench: engine {res['engine']}, "
          f"{launched['k1a_static_trace']} K1a launches for {renders} "
          f"renders of {per_render}")
    check(res["grad_engine"] == "fused" and launched["k2"] > 0
          and launched["k3"] > 0, f"bench: grad_engine "
          f"{res['grad_engine']}, launches {launched}")
    check(res["grad_fd_max_abs_err"] <= 1e-3 and set(res["grad_fd_per_leaf"])
          == {label for label, *_ in benchlib.FD_SWEEPS},
          f"bench: grad_fd {res['grad_fd_max_abs_err']}, sweeps "
          f"{res['grad_fd_per_leaf']}")

    # -- 56. render with the profiler, the log and the bar, as a command of
    # its own: with torch 2.11 on an H100 host, torch.profiler records the
    # card's activity in a process's first profiler session alone (phase
    # 9's session sees the kernels, phases 23 and 28's later ones see no
    # device op)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell_box_baseline.ppm")
        log_path = os.path.join(tmp, "log", "render.log")
        prof = os.path.join(tmp, "profile")
        argv = ["render", "--scene", "cornell_box_baseline", "--device",
                "cuda", "--out", out, "--timers", "--profile", prof, "--log",
                log_path]
        run = subprocess.run(
            [sys.executable, "-m", "raytracing_rust_tpu_torch", *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        rc = run.returncode
        check(rc == 0, f"{argv} exited {rc}: {run.stderr[-3000:]}")
        img = read_ppm(out)
        trace_path = os.path.join(prof, "cornell_box_baseline.trace.json")
        trace_bytes = os.path.getsize(trace_path)
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
        with open(log_path) as fh:
            log_lines = fh.read().splitlines()
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = [e for e in kernels if "trace_k1" in e.get("name", "")]
    stamped = all(re.match(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d \[DEBUG\] - ",
                           ln) for ln in log_lines)
    said = [ln.split(" - ", 1)[1] for ln in log_lines]
    bars = run.stderr.count("100.0%")
    same = bool(np.array_equal(img, cornell_img))
    emit("render_profile_log", card=smi, argv=argv, rc=rc,
         trace_bytes=trace_bytes, trace_events=len(events),
         kernel_events=len(kernels), k1_kernel_events=len(k1_events),
         phase5_launches_per_render=per_render,
         k1_kernel_names=sorted({e["name"] for e in k1_events}),
         k1_device_ms=sum(e.get("dur", 0) for e in k1_events) * 1e-3,
         log=log_lines, bars_at_100=bars, ppm_equals_phase5=same,
         stdout=run.stdout.splitlines(),
         phase_seconds=time.perf_counter() - t_phase)
    check(len(k1_events) >= 1, f"--profile: {len(k1_events)} K1 kernel "
          f"events in the trace ({len(kernels)} kernel events)")
    check(stamped and said[0] == "render scene=cornell_box_baseline"
          and said[1].startswith("profiler trace -> ")
          and said[2].startswith("timers: {")
          and said[3].startswith("rendered cornell_box_baseline in ")
          and len(said) == 4, f"--log wrote {log_lines}")
    check(bars == 1, f"the bar reached 100.0% {bars} times on stderr")
    check(same, "the profiled render's PPM differs from phase 5's")

    # -- 57. bench_scenes and make_gallery through their entry points
    t_phase = time.perf_counter()
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_scenes.main(["--device", "cuda"])
    text = buf.getvalue().strip().splitlines()
    table = json.loads(text[-1])["rows"]
    rates = {m.group(1): float(m.group(2)) for m in (re.match(
        r"(\w+): \d+x\d+x\d+ best [0-9.]+s = ([0-9.]+)M rays/s", ln)
        for ln in text[:-1]) if m}
    bench_launches = k1_launches()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_g = make_gallery.main([tmp, "--device", "cuda"])
        rows = json.loads(buf.getvalue().strip().splitlines()[-1])["rows"]
        pngs = {}
        for name in GALLERY_MEANS:
            path = os.path.join(tmp, f"{name}.png")
            if os.path.exists(path):
                pngs[name] = float((np.asarray(Image.open(path).convert(
                    "RGB"), dtype=np.float64) / 255.0).mean())
    gallery_launches = k1_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_a = alive_profile.main([])
    alive_lines = buf.getvalue().strip().splitlines()
    print("\n".join(alive_lines), flush=True)
    alive = {dev_name: alive_profile.profile("cornell_box", ALIVE_N,
                                             device=dev_name)["alive"]
             for dev_name in ("cuda", "cpu")}
    k = min(len(v) for v in alive.values())
    p, q = alive["cuda"][:k], alive["cpu"][:k]
    alive_se = np.sqrt(p * (1 - p) / ALIVE_N + q * (1 - q) / ALIVE_N)
    alive_off = np.abs(p - q) / np.maximum(alive_se, 1e-12)
    falls = all(v[0] == 1.0 and (np.diff(v) <= 0).all()
                for v in alive.values())
    bands = {k: (0.95 * v, 1.05 * v) for k, v in GALLERY_MEANS.items()}
    emit("bench_scenes", card=smi, rc=rc, lines=text[:-1], rows=table,
         launches=bench_launches)
    emit("make_gallery", card=smi, rc=rc_g, rows=rows, png_means=pngs,
         bands=bands, launches=gallery_launches)
    emit("alive_profile", card=smi, rc=rc_a, lines=alive_lines,
         cornell_box_cuda=alive["cuda"].tolist(),
         cornell_box_cpu=alive["cpu"].tolist(),
         worst_diff_over_se=float(alive_off.max()),
         phase_seconds=time.perf_counter() - t_phase)
    check(rc_a == 0 and len(alive_lines) == len(alive_profile.DEFAULT_SCENES)
          and all(ln.split()[0] == name for ln, name in zip(
              alive_lines, alive_profile.DEFAULT_SCENES)),
          f"alive_profile: rc {rc_a}, lines {alive_lines}")
    check(falls and (p <= q + 4 * alive_se).all()
          and (p >= q - 4 * alive_se).all(),
          f"alive_profile: cornell_box's card profile off the CPU's by up "
          f"to {alive_off.max():.2f} standard errors, or not falling from "
          f"1.0: {alive}")
    check(rc == 0 and len(text) == 9 and sorted(rates)
          == sorted(n for n, *_ in bench_scenes.CONFIGS)
          and all(v > 0 for v in rates.values()),
          f"bench_scenes: rc {rc}, rates {rates}")
    check(rc_g == 0 and sorted(pngs) == sorted(GALLERY_MEANS),
          f"make_gallery: rc {rc_g}, PNGs {sorted(pngs)}")
    off = {k: v for k, v in pngs.items()
           if not bands[k][0] < v < bands[k][1]}
    check(not off, f"gallery means outside their bands: {off} ({bands})")
    for launched in (bench_launches, gallery_launches):
        check(launched["k1a_static_trace"] > 0
              and launched["k1f_balanced_trace"] > 0
              and launched["k1d_walk_trace"] > 0,
              f"the tools' K1 launches: {launched}")

    # -- 58. the training step's profile on both tiers
    t_phase = time.perf_counter()
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_train_step.main(["--steps", str(PROFILE_STEPS)])
    text = buf.getvalue().strip().splitlines()
    prof = json.loads(text[-1])["tiers"]
    print("\n".join(text[:-1]), flush=True)
    emit("profile_train_step", card=smi, rc=rc, table=text[:-1],
         tiers=prof, k2=grad.K2_LAUNCHES, k3=grad.K3_LAUNCHES,
         phase_seconds=time.perf_counter() - t_phase)
    check(rc == 0 and sorted(prof) == ["fused", "general"],
          f"profile_train_step: rc {rc}, tiers {sorted(prof)}")
    for tier, r in prof.items():
        check(abs(r["parts_over_step"] - 1.0) <= PROFILE_SUM_TOL,
              f"{tier}: the parts sum to {r['parts_over_step']:.3f}× the "
              f"step")
    fused = prof["fused"]
    check(0 < fused["parts"]["kernels"] < fused["step"]
          and grad.K2_LAUNCHES > 0 and grad.K3_LAUNCHES > 0,
          f"K2 + K3 {fused['parts']['kernels']} s against the step "
          f"{fused['step']} s; launches {grad.K2_LAUNCHES}, "
          f"{grad.K3_LAUNCHES}")
    # its trace, as a process of its own (see phase 56)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--tier", "fused", "--steps", "1", "--trace", tmp]
        run = subprocess.run(
            [sys.executable, "-m", "raytracing_rust_tpu_torch."
             "profile_train_step", *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        check(run.returncode == 0, f"profile_train_step {argv} exited "
              f"{run.returncode}: {run.stderr[-3000:]}")
        trace_path = os.path.join(tmp, "train_step_fused.trace.json")
        trace_bytes = os.path.getsize(trace_path)
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2_events = [e for e in kernels if "grad_fwd" in e.get("name", "")]
    k3_events = [e for e in kernels if "grad_bwd" in e.get("name", "")]
    emit("profile_train_step_trace", card=smi, argv=argv,
         rc=run.returncode, trace_bytes=trace_bytes,
         trace_events=len(events), kernel_events=len(kernels),
         k2_kernel_events=len(k2_events), k3_kernel_events=len(k3_events),
         k2_device_ms=sum(e.get("dur", 0) for e in k2_events) * 1e-3,
         k3_device_ms=sum(e.get("dur", 0) for e in k3_events) * 1e-3,
         kernel_names=sorted({e["name"] for e in k2_events + k3_events}),
         phase_seconds=time.perf_counter() - t_phase)
    check(len(k2_events) >= 1 and len(k3_events) >= 1,
          f"--trace: {len(k2_events)} K2 and {len(k3_events)} K3 kernel "
          f"events in the trace ({len(kernels)} kernel events)")


def fallback_camera(nx: int, ny: int, device):
    from raytracing_rust_tpu_torch.ops.camera import make_camera
    return make_camera((0, 3, 14), (0, 0.5, 0), (0, 1, 0), 40.0, nx / ny,
                       0.0, 10.0, device=device)


def nine_media_scene(device):
    """One medium more than the kernel holds: nine fog spheres on a floor
    under a rect light."""
    from raytracing_rust_tpu_torch.models.scene import BG_BLACK, SceneBuilder
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -100, 0), 99.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.rect("zx", -20, -20, 20, 20, 12.0, b.diffuse_light(b.solid(3, 3, 3)))
    for i in range(9):
        b.medium_sphere((3.0 * i - 12.0, 0, 0), 1.0, 0.5,
                        b.solid(0.9, 0.5 + 0.05 * i, 0.4))
    return b.build(device)


def rotated_image_scene(device):
    """An image texture on a rotated sphere (the kernel takes images on
    unrotated spheres only), under the sky."""
    import numpy as np
    from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
    b = SceneBuilder(background=BG_SKY)
    xf = b.transform(offset=(0, 1, 0), rotate_axis="y", angle_deg=30.0)
    b.sphere((0, -1000, 0), 999.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(
        np.random.default_rng(3).integers(0, 256, (4, 6, 3), np.uint8))),
        xform=xf)
    return b.build(device)


# the presets whose boxes form a regular grid (the strip pass's)
GRID_PRESETS = ("final_scene",)


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


def device_ops(fn, calls: int = 3, tries: int = 3) -> dict | None:
    """The device ops (kernels, copies, memsets) that `calls` calls of fn
    run, by name → count, from torch.profiler after a warm-up call; None
    where the profiler records no device time. Every call of fn runs at
    least one device op, so a profile that records fewer ops than calls
    has lost events (CUPTI can miss a launch at the start of a session):
    it is taken again, at most `tries` times in all, and the last one
    returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
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
        if not ops or sum(ops.values()) >= calls:
            break
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
    t_script = time.perf_counter()
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
        tracer.K1E_GRID_LAUNCHES = 0
        tracer.K1_LATTICE_LAUNCHES = tracer.K1G_LAUNCHES = 0
        tracer.K1F_LAUNCHES = tracer.K1F_TABLE_LAUNCHES = 0
        tracer.K1F_STATS_LAUNCHES = tracer.K1F_DDA_LAUNCHES = 0
        tracer.K1F_PROBE_LAUNCHES = 0
        tracer.K1_INSTANTIATION_LAUNCHES.clear()
        grad.K2_LAUNCHES = grad.K3_LAUNCHES = 0
        peak.D3_LAUNCHES = 0
        mb.D1_LAUNCHES = mb.D2_LAUNCHES = 0

    def k1_launches():
        return {"k1a_static_trace": tracer.KERNEL_LAUNCHES,
                "k1be_sphere_trace": tracer.K1BE_LAUNCHES,
                "k1c_texture_trace": tracer.K1C_LAUNCHES,
                "k1d_media_trace": tracer.K1D_LAUNCHES,
                "k1e_box_trace": tracer.K1E_BOX_LAUNCHES,
                "k1e_grid_strip": tracer.K1E_GRID_LAUNCHES,
                "k1d_walk_trace": tracer.K1D_WALK_LAUNCHES,
                "k1_lattice_trace": tracer.K1_LATTICE_LAUNCHES,
                "k1g_roulette_trace": tracer.K1G_LAUNCHES,
                "k1f_stats_trace": tracer.K1F_STATS_LAUNCHES,
                "k1f_probe_trace": tracer.K1F_PROBE_LAUNCHES,
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
            instantiations = dict(tracer.K1_INSTANTIATION_LAUNCHES)
            check(rc == 0, f"cli.main({argv}) returned {rc}")
            # the presets' one box grid is final_scene's: every box launch
            # of its K1 renders runs the strip pass, no other preset's any
            check(launches["k1e_grid_strip"] == (
                launches["k1e_box_trace"] if scene in GRID_PRESETS else 0),
                f"{scene}: {launches['k1e_grid_strip']} strip-pass launches "
                f"beside {launches['k1e_box_trace']} box launches")
            img = read_ppm(out)
        text = buf.getvalue()
        rate = re.search(r"\(([0-9.]+)M primary rays/s\)", text)
        timers = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^\s+(\S+)\s+([0-9.]+)s", text, re.M)}
        return dict(argv=argv, wall_seconds=wall,
                    render_primary_rays_per_s=(float(rate.group(1)) * 1e6
                                               if rate else None),
                    timers=timers, launches=launches,
                    k1_instantiations=instantiations,
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
            flags = re.search(r"(trace_k1)I((?:L[bi]\d+E)+)E", m.group(1))
            plain = re.search(r"(grad_fwd|grad_bwd)ILb([01])E", m.group(1))
            d3 = re.search(r"(fp32_peak)_kILi(\d+)ELb([01])E", m.group(1))
            d1 = re.search(r"(attr_read_k)ILb([01])ELi(\d+)E", m.group(1))
            d2 = re.search(r"(member_k)ILi(\d)E", m.group(1))
            fn = (f"{flags.group(1)}<"
                  f"{','.join(re.findall(r'L[bi](\d+)E', flags.group(2)))}>"
                  if flags else f"{plain.group(1)}<{plain.group(2)}>"
                  if plain else f"{d3.group(1)}<{d3.group(2)},{d3.group(3)}>"
                  if d3 else f"{d1.group(1)}<{d1.group(2)},{d1.group(3)}>"
                  if d1 else f"{d2.group(1)}<{d2.group(2)}>"
                  if d2 else m.group(1))
        elif fn and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(fn, []).append(ln.split(" : ")[-1].strip())
    build_s = time.perf_counter() - t
    # per K1 instantiation: its SASS's loads in the loop over the unrolled
    # record's rows (its fields from shared memory: LDS, one load a thread;
    # LDC, ULDC and constant operands read the constant bank) and in the
    # whole kernel
    loads = tracer.k1_sass_loads(lib_path)
    emit("build", seconds=build_s, nvcc=_build._nvcc(),
         library=os.path.relpath(lib_path), ptxas=ptxas,
         k1_blocks_per_sm=tracer.k1_blocks_per_sm(),
         k1_row_loop_loads={k: [{c: r[c] for c in ("lds", "ldc", "uldc",
                                                   "const_operands")}
                                for r in v["row_loops"]]
                            for k, v in loads.items()},
         k1_whole_loads={k: v["whole"] for k, v in loads.items()})

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
    cornell_img = img
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
        """The kernel against trace_plain on `scene` at its preset's
        size (or on built = (scene tables, camera, nx, ny)), n_samples
        spp, depth 50, roulette from rr_depth, in the instantiation
        `picked` names: gates, times, the paths' work and the bound,
        emitted as one line; returns what the table needs. The work and
        the samples held go to held[key] (the scene unless given)."""
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

        ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
        k = tracer.trace(ops, sums(), **kw)
        ran = sorted(tracer.K1_INSTANTIATION_LAUNCHES - ran)
        check(ran == [picked(ops)], f"{scene}: K1 ran {ran}, not "
              f"{picked(ops)}")
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
             rr_depth=rr_depth, feats=ops.feats, instantiation=ran,
             unrolled=len(srec.kinds),
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
        # media run their own instantiations (MED), cornell_smoke's K1a's
        # code with them; the probe's (STATS 2) serves every scene
        prod = {n for n in info["k1_instantiations"]
                if n.split(",")[3] == "0"}
        check(all(n.endswith(",1>") == (scene == "cornell_smoke")
                  for n in prod) and (scene != "cornell_smoke" or prod == {
                      "trace_k1<0,0,0,0,1>"}),
              f"{scene}: launched {info['k1_instantiations']}")
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
    check(fops.grid[:2] == (20, 20) and fops.bleaves.shape[0] == 60,
          f"final_scene's boxes are not in the strip layout: {fops.grid}")
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=1, max_depth=50)
    final, final_k = {}, {}
    for name, o in (("walk", fops), ("event", dataclasses.replace(
            fops, feats=fops.feats & ~tracer.FEAT_DENSE_WALK))):
        n_grid = tracer.K1E_GRID_LAUNCHES
        k = tracer.trace(o, sums(), **kw)
        check(tracer.K1E_GRID_LAUNCHES == n_grid + 1, f"final_scene "
              f"({name}): the launch did not run the strip pass")
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
    # 20 cubes fill a 5×4 grid (the strip pass, in a box grid's
    # instantiation), 17 leave three cells empty (the generic box loop):
    # each against plain, bit for bit
    from raytracing_rust_tpu_torch.models import builders
    layouts = {}
    for n_cubes in (20, 17):
        cops = tracer.trace_operands(
            tracer.build_scene_record(builders.cubes_scene(n_cubes)),
            tracer.build_camera_record(builders.cubes_camera(320, 240)), dev)
        n_grid, n_box = tracer.K1E_GRID_LAUNCHES, tracer.K1E_BOX_LAUNCHES
        insts = tracer.K1_INSTANTIATION_LAUNCHES.copy()
        ckw = dict(nx=320, ny=240, seed=1, sample0=0, n_samples=4,
                   max_depth=50)
        zc = torch.zeros((3, 320 * 240), dtype=torch.float64, device=dev)
        k = tracer.trace(cops, zc.clone(), **ckw)
        ran = (tracer.K1E_GRID_LAUNCHES - n_grid,
               tracer.K1E_BOX_LAUNCHES - n_box)
        inst = sorted(tracer.K1_INSTANTIATION_LAUNCHES - insts)
        pl = tracer.trace_plain(cops, zc.clone(), **ckw)
        layouts[n_cubes] = dict(
            grid=list(cops.grid), box_leaves=int(cops.bleaves.shape[0]),
            grid_launches=ran[0], box_launches=ran[1], instantiation=inst,
            max_abs_err=float((k - pl).abs().max()))
        check(ran == ((1, 1) if n_cubes == 20 else (0, 1))
              and bool(cops.grid) == (n_cubes == 20)
              and inst == [picked(cops)]
              and (",2," in inst[0]) == (n_cubes == 20)
              and bool(torch.equal(k, pl)) and float(k.sum()) > 0,
              f"{n_cubes} cubes: {layouts[n_cubes]}")
    emit("k1e_grid_layouts", cubes=layouts)

    # -- 19. the render path of final_scene through the command line, and
    # its mean at the JAX reference's size and spp
    info, img = run_cli("final_scene", label="final_scene")
    emit("final_scene_path", **info, spp=p.spp, wall_primary_rays_per_s=(
        nx * ny * p.spp / info["wall_seconds"]))
    final_launches = info["launches"]
    check(all(final_launches[k] > 0 for k in (
        "k1be_sphere_trace", "k1c_texture_trace", "k1d_media_trace",
        "k1e_box_trace", "k1e_grid_strip", "k1d_walk_trace")),
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
    # roulette alone runs the static instantiation, never K1B
    check(set(info["k1_instantiations"]) == {"trace_k1<0,0,0,0,0>"},
          f"cornell_box --rr-depth 6 launched {info['k1_instantiations']}, "
          f"not the static instantiation")
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

        n_grid = tracer.K1E_GRID_LAUNCHES
        prod = tracer.trace(sops, zeros(), **kw)
        sk = tracer.new_stats(snx, sny, dev)
        k = tracer.trace(sops, zeros(), stats=sk, **kw)
        check(tracer.K1E_GRID_LAUNCHES - n_grid == (
            2 if scene in GRID_PRESETS else 0), f"{scene}: "
            f"{tracer.K1E_GRID_LAUNCHES - n_grid} strip-pass launches of 2")
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
    # both presets run a K1B+DYN instantiation, with the leaves in shared
    # memory, random_spheres without MED and final_scene, a box grid, with
    # it (DYN 2)
    per_sm = min(per_sm[f"trace_k1<1,{f}>"]
                 for f in ("1,0,0,1", "1,1,0,0", "2,1,0,1"))
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

    # -- 34, the probe: the render's cost probe (`trace_probe`) against
    # the stats launch on the scanline layout (the probe before it), at the
    # command line's three probes: its row bit-equal to that launch's row
    # 0 and to the plain version's (on the card, where that is quick), the
    # render's table equal to the one made from that row, each split held
    # to the others; times in turns (scanline, probe, probe, scanline),
    # each split's time, and the probe's blocks, waves and occupancy (its
    # own steps row); each split in turns (1, 2, 4, 4, 2, 1)
    k1f_probe = {}
    for label, scene, size in (("random_spheres", "random_spheres", None),
                               ("final_scene", "final_scene", None),
                               ("final_scene 128", "final_scene",
                                FINAL_SCENE_CHECK)):
        sops, snx, sny = preset_ops(scene)
        if size is not None:
            snx, sny = size
        n_pix = snx * sny
        kw = dict(nx=snx, ny=sny, seed=tracer.PROBE_SEED, sample0=0,
                  n_samples=tracer.PROBE_SPP, max_depth=50)
        tiles_n = tracer.probe_tiles(snx, sny)
        probe_resident = tracer.probe_resident(dev, bool(sops.grid))
        split = tracer.probe_split(tiles_n, probe_resident)
        st = tracer.new_stats(snx, sny, dev)
        scan_sums = torch.zeros((3, n_pix), dtype=torch.float64, device=dev)
        tracer.trace(sops, scan_sums, stats=st, **kw)
        row0 = tracer.stats_rows(st, n_pix)[0].clone()

        def probe(sp, steps=None):
            return tracer.trace_probe(
                sops, torch.zeros(n_pix, dtype=torch.int64, device=dev),
                split=sp, steps=steps, **kw)
        rows = {sp: probe(sp) for sp in (1, 2, 4)}
        steps = torch.zeros(tracer.probe_warps(snx, sny, split),
                            dtype=torch.int64, device=dev)
        busy = probe(split, steps)
        table = tracer.render_table(sops, snx, sny, 50, dev)
        torch.cuda.synchronize()
        eq = dict(row_equals_scanline=bool(torch.equal(busy, row0)),
                  splits_equal=all(bool(torch.equal(r, busy))
                                   for r in rows.values()),
                  table_equals_scanline_table=bool(torch.equal(
                      table, tracer.block_tile_table(row0, snx, sny))))
        if scene == "random_spheres" or size is not None:
            pb = torch.zeros(n_pix, dtype=torch.int64, device=dev)
            psteps = torch.zeros_like(steps)
            pl_ms = cuda_ms(lambda: tracer.probe_plain(
                sops, pb.zero_(), split=split, steps=psteps.zero_(), **kw),
                reps=1, warm=False)
            eq.update(row_equals_plain=bool(torch.equal(busy, pb)),
                      steps_equal_plain=bool(torch.equal(steps, psteps)))
        else:
            pl_ms = None
        turns = []
        for name in ("scanline", "probe", "probe", "scanline"):
            if name == "probe":
                turns.append((name, cuda_ms(lambda: probe(split), reps=3)))
            else:
                turns.append((name, cuda_ms(lambda: tracer.trace(
                    sops, scan_sums.zero_(),
                    stats=tracer.new_stats(snx, sny, dev), **kw), reps=3)))
        split_ms = {sp: [] for sp in (1, 2, 4)}
        for sp in (1, 2, 4, 4, 2, 1):
            split_ms[sp].append(cuda_ms(lambda: probe(sp), reps=3))
        seg = int(busy.sum())
        occ_probe = seg / (32 * int(steps.sum()))
        scan_occ = occupancy(st, n_pix, tracer.PROBE_SPP)["occupancy"]
        probe_ms = sum(t for n_, t in turns if n_ == "probe") / 2
        k1f_probe[label] = dict(split=split, ms=probe_ms, plain_ms=pl_ms)
        emit("k1f_probe_vs_scanline", run=label, shape=[sny, snx],
             spp=tracer.PROBE_SPP, depth=50, **eq, split=split,
             blocks=split * tiles_n, resident_blocks=probe_resident,
             waves=split * tiles_n / probe_resident,
             scanline_blocks=-(-n_pix // tracer.THREADS),
             ms_in_turns=turns, ms_by_split=split_ms, probe_ms=probe_ms,
             scanline_ms=sum(t for n_, t in turns if n_ == "scanline") / 2,
             plain_ms=pl_ms, segments=seg, occupancy=occ_probe,
             scanline_occupancy=scan_occ)
        check(all(eq.values()), f"{label}: the cost probe does not hold: "
              f"{eq}")
        del rows, busy, row0, st, scan_sums

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
              and bl["k1f_probe_trace"] == bl["k1f_stats_trace"]
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
    check(tracer.K1E_GRID_LAUNCHES == tracer.K1E_BOX_LAUNCHES > 0,
          f"kernel_stats final_scene: {tracer.K1E_GRID_LAUNCHES} strip-pass "
          f"launches beside {tracer.K1E_BOX_LAUNCHES} box launches")
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
    # and arguments (`replay`), in the instantiation `pick` names for it;
    # cornell_box_baseline's first launch also held to trace_plain itself,
    # in 8-sample calls, and cornell_smoke's launch (K1d, K1a's code with
    # the media) on its first 8 samples
    replayed = {}
    for label, run in main_runs.items():
        rows = []
        for i, launch in enumerate(run["launches"]):
            r, whole = replay(launch, held[run["held"]])
            kw = launch["kw"]
            want = picked(launch["ops"], table=kw.get("pix") is not None,
                          stats=2 if launch["probe"] else int(launch["stats"]))
            check(r["instantiation"] == [want], f"{label}: launch {i} ran "
                  f"{r['instantiation']}, not {want}")
            if label == "cornell_box_baseline" and i == 0:
                s0, n = kw["sample0"], kw["n_samples"]
                pl = torch.zeros_like(whole)
                for s in range(s0, s0 + n, 8):
                    tracer.trace_plain(launch["ops"], pl, **{
                        **kw, "sample0": s, "n_samples": min(8, s0 + n - s)})
                r["plain_max_abs_err"] = float((whole - pl).abs().max())
                r["equals_plain"] = bool(torch.equal(whole, pl))
                del pl
            if label == "cornell_smoke":
                head = {**kw, "n_samples": min(8, kw["n_samples"])}
                kh, ph = (torch.zeros_like(whole) for _ in range(2))
                tracer.trace(launch["ops"], kh, **head)
                tracer.trace_plain(launch["ops"], ph, **head)
                r["plain_spp"] = head["n_samples"]
                r["plain_max_abs_err"] = float((kh - ph).abs().max())
                r["equals_plain"] = bool(torch.equal(kh, ph))
                del kh, ph
            rows.append(r)
            del whole
        replayed[label] = rows
        steps = sum(r["warp_steps"] for r in rows)
        occ = sum(r["segments"] for r in rows) / (32 * steps)
        emit("k1_main_path_launches", run=label, launches=rows,
             ms=sum(r["ms"] for r in rows),
             bound_ms=sum(r["bound_ms"] for r in rows), occupancy=occ,
             tail_share=1.0 - occ)
        check(all(r.get("equals_chunks", True) for r in rows),
              f"{label}: a launch's sums differ from the same samples "
              "launched in chunks")
        check(all(r.get("equals_scanline", True) for r in rows),
              f"{label}: the cost probe's row differs from the scanline "
              "stats launch's")
        check(all(r.get("equals_plain", True) for r in rows),
              f"{label}: the launch's sums differ from trace_plain's")
        check(all(("k1e_grid_strip" in r["counted"])
                  == ("k1e_box_trace" in r["counted"]
                      and bool(launch["ops"].grid))
                  for r, launch in zip(rows, run["launches"])),
              f"{label}: a box launch of a grid skipped the strip pass")
    k1a["max_abs_err"] = max(
        k1a["max_abs_err"],
        replayed["cornell_box_baseline"][0]["plain_max_abs_err"])
    k1cd["cornell_smoke"]["max_abs_err"] = max(
        k1cd["cornell_smoke"]["max_abs_err"],
        *(r["plain_max_abs_err"] for r in replayed["cornell_smoke"]))

    # -- 41-44. the general tier, the fallback and checkpoints
    dense128 = general_phases(dev, smi, run_cli, cornell_img,
                              reset_launches, k1_launches)
    # -- 45-47. the general tier under autograd
    no_fast_step = autograd_phases(dev, smi, reset_launches)
    # -- 48-51. sharding: NCCL at one rank, two gloo ranks on the card
    sharded_phases(dev, smi, run_cli, no_fast_step)
    # -- 52-54. the BVH, the crossover and the parity sweep
    bvh_phases(dev, smi, run_cli, dense128, reset_launches, k1_launches)
    # -- 55-58. the tool surface: bench, render --profile --log,
    # bench_scenes, make_gallery and alive_profile, profile_train_step
    surface_phases(dev, smi, cornell_img, launches["k1a_static_trace"],
                   reset_launches, k1_launches)
    emit("script", card=smi, seconds=time.perf_counter() - t_script)

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
        "name": "k1e_grid_strip", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:1947",
        "launches": final_launches["k1e_grid_strip"],
        **main_row(final["walk"], ["final_scene"], "k1e_grid_strip",
                   final_launches["k1e_grid_strip"]),
        "max_abs_err": max(final[v]["max_abs_err"] for v in final),
        "library_ms": None}, {
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
    if sys.argv[1:2] == ["--sharded-rank"]:
        from raytracing_rust_tpu_torch.parallel.multihost_worker import finish
        finish(sharded_rank(sys.argv[2]))
    sys.exit(main())
