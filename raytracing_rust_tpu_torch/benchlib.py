"""Benchmark metrics of the port: `bench`'s JSON line.

Counterpart of `raytracing_rust_tpu/benchlib.py`, with the JAX `run`'s
keys and meanings:

* `run`: primary rays/s of a preset through the command line's render
  (`cli.render_scene`: record build, upload, trace, finalize) = nx·ny·spp
  over the best of 8 timed renders after an untimed warm one, against the
  reference's C++ mirror (`reference_baseline`); each primary ray carries
  its whole path (up to 51 segments, reference src/color.rs:9), so the
  rate counts what a user of `create_image` waits for, not segments;
* `grad_throughput`: sample-paths/s forward and backward of the default
  inverse render's training step (`inverse_render.default_run`);
* `grad_fd_err`: the general tier's autograd against central differences
  of the same fixed-draw estimator (gradient health, not time);
* `reference_baseline`: the C++ mirror's recorded rate, read from the
  port's copy of the JAX package's `native/ref_baseline.json`. JAX's live
  re-time of the mirror (`reference_measure`) builds the JAX package's
  native library and is not ported.

Every time is taken on the host clock around work that ends in
`torch.cuda.synchronize()` on the card. A failed rep raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from .inverse_render import _check_device
from .models.scene import BG_SKY, SceneBuilder, SceneTables
from .ops.integrator import trace

# the probe's Philox key (the JAX metric's jax.random.key(10))
FD_SEED = 10

# (label, table, indices, top_k, eps): indices None → the top_k entries of
# |autograd gradient|
FD_SWEEPS = (
    ("albedo", "tex_color", None, 2, 1e-2),           # top-2 albedo channels
    ("emission", "tex_color", [(2, 0)], None, 1e-2),  # the light's solid, R
    # the metal sphere's radius and centre y, the glass sphere's radius
    ("geometry", "prim_data", [(3, 3), (3, 1), (4, 3)], None, 1e-3),
    ("mat_param", "mat_param", [(3,), (4,)], None, 1e-3),  # fuzz, ior
    ("texels", "images", None, 2, 1e-2),              # top-2 image texels
)


def fd_probe(device="cpu", n_rays: int = 64):
    """The metric's probe scene and rays → (scene, o, d). Under the sky (a
    path that escapes carries its attenuation product, so no probe is
    vacuous): a floor, a red wall, a flipped light, a metal sphere (fuzz
    0.3), a glass sphere (1.5) and an 8×16 image-textured sphere; rays
    from (0, 1.5, 6), a quarter aimed inside each sphere's silhouette
    (jitter ≤ 0.4·r, so no FD step flips the hit set) and the rest spread
    over the walls and the light. Numpy draws under seed 5, as the JAX
    metric makes them."""
    rng = np.random.default_rng(5)
    b = SceneBuilder(background=BG_SKY)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    red = b.lambertian(b.solid(0.65, 0.05, 0.05))
    b.rect("zx", -2, -2, 2, 2, 0.0, white)                 # floor
    b.rect("yz", 0, -2, 4, 2, -2.0, red)                   # left wall
    b.rect("zx", -1, -1, 1, 1, 4.0,
           b.diffuse_light(b.solid(5.0, 5.0, 5.0)), flip=True)
    centers = [(0.5, 1.0, 0.5), (-0.7, 0.7, -0.3), (1.2, 0.6, -1.0)]
    b.sphere(centers[0], 0.6, b.metal(b.solid(0.8, 0.8, 0.8), 0.3))
    b.sphere(centers[1], 0.5, b.dielectric(1.5))
    texels = rng.uniform(0.1, 0.9, (8, 16, 3)).astype(np.float32)
    b.sphere(centers[2], 0.6, b.lambertian(b.image(texels)))
    scene = b.build(device)

    origin = np.array([0.0, 1.5, 6.0], np.float32)
    per = n_rays // 4
    dirs = []
    for c in centers:
        to_c = np.asarray(c, np.float32) - origin
        jit = rng.uniform(-0.4 * 0.5, 0.4 * 0.5, (per, 3)).astype(np.float32)
        dirs.append(to_c / np.abs(to_c[2]) + jit / np.abs(to_c[2]))
    nw = n_rays - 3 * per
    dirs.append(np.stack([rng.uniform(-0.6, 0.6, nw),
                          rng.uniform(-0.4, 0.2, nw),
                          -np.ones(nw)], -1).astype(np.float32))
    o = torch.from_numpy(np.tile(origin, (n_rays, 1))).to(device)
    d = torch.from_numpy(np.concatenate(dirs)).to(device)
    return scene, o, d


def grad_fd_err(n_rays: int = 64, max_depth: int = 8,
                breakdown: bool = False, device="cuda"):
    """The worst |autograd − FD| gradient of the mean radiance of
    `fd_probe`'s rays over a sweep of ten parameters spanning the
    differentiable surface (`FD_SWEEPS`): albedo and emission (tex_color),
    geometry (prim_data: sphere radii and a centre), metal fuzz and the
    dielectric's index (mat_param), image texels (images), at depth-8
    paths on fixed draws (Philox under `FD_SEED`, keyed by lane). The
    gradient is `trace(differentiable=True)`'s; FD takes central
    differences of the same trace at eps and eps/2, and where the two
    disagree (a ±eps window straddling a discrete hit flip: FD's failure,
    not autograd's) at eps/4 and eps/8, skipping the probe only when
    those disagree too. breakdown=True → (worst, {label: worst in sweep}).
    device: "cuda" (the default; raises without CUDA) or "cpu"."""
    device = _check_device(device)
    probe, o, d = fd_probe(device, n_rays)
    time = torch.zeros(n_rays, device=device)
    lane = torch.arange(n_rays, dtype=torch.int64, device=device)

    def loss(s: SceneTables, differentiable: bool = False):
        rad = trace(s, o, d, time, FD_SEED, lane, torch.zeros_like(lane),
                    max_depth, differentiable=differentiable)
        return torch.mean(rad)

    names = sorted({leaf for _, leaf, _, _, _ in FD_SWEEPS})
    leaves = {k: getattr(probe, k).detach().clone().requires_grad_(True)
              for k in names}
    grads = dict(zip(names, torch.autograd.grad(
        loss(dataclasses.replace(probe, **leaves), True),
        list(leaves.values()))))

    worst = 0.0
    per_sweep = {}
    with torch.no_grad():
        for label, leaf, idxs, top_k, eps in FD_SWEEPS:
            base = getattr(probe, leaf)
            g_np = grads[leaf].cpu().numpy()
            if idxs is None:
                flat = np.argsort(np.abs(g_np).ravel())[::-1][:top_k]
                idxs = [np.unravel_index(int(i), g_np.shape) for i in flat]
            for idx in idxs:
                idx = tuple(int(i) for i in idx)

                def fd_at(e):
                    hi, lo = base.clone(), base.clone()
                    hi[idx] += e
                    lo[idx] -= e
                    return (float(loss(dataclasses.replace(probe,
                                                           **{leaf: hi})))
                            - float(loss(dataclasses.replace(
                                probe, **{leaf: lo})))) / (2 * e)

                fd1, fd2 = fd_at(eps), fd_at(eps / 2)
                if abs(fd1 - fd2) > 0.2 * max(abs(fd1), abs(fd2)) + 1e-6:
                    fd1, fd2 = fd_at(eps / 4), fd_at(eps / 8)
                    if abs(fd1 - fd2) > 0.2 * max(abs(fd1), abs(fd2)) + 1e-6:
                        continue
                # fd1, the larger consistent step, has the lower f32
                # cancellation noise; the half step is its witness
                err = abs(float(g_np[idx]) - fd1)
                worst = max(worst, err)
                per_sweep[label] = max(per_sweep.get(label, 0.0), err)
    worst = float(f"{worst:.3g}")
    if breakdown:
        return worst, {k: float(f"{v:.3g}") for k, v in per_sweep.items()}
    return worst


# the reference's C++ mirror, single-thread scalar f64, timed on a CPU
# (the JAX package's tools/bench_reference.py); a byte-equal copy of
# raytracing_rust_tpu/native/ref_baseline.json
REF_BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "ref_baseline.json")
# timed renders of `run` on the kernel, and on the general tier (JAX's 8
# and 1: the general tier's render of the headline takes tens of seconds)
KERNEL_REPS, GENERAL_REPS = 8, 1


def reference_baseline() -> tuple[float, str]:
    """(rays_per_sec, source) of the `vs_baseline` denominator: the C++
    mirror's recorded measurement (cornell_box 800×800 at depth 50 on one
    CPU thread), JAX's second source."""
    with open(REF_BASELINE_PATH) as f:
        rec = json.load(f)
    return (float(rec["rays_per_sec"]),
            f"measured (recorded {rec.get('date')}, {rec.get('cpu')})")


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device) -> str:
    """"cpu", or the card's name with its power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (the
    card's row by its index); the power limit is "not read" where
    nvidia-smi does not answer."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    try:
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return f"{name}, {rows[index].rsplit(', ', 1)[1]}"
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{name}, power limit not read"


def run(scene: str = "cornell_box_baseline", spp: int | None = None,
        nx: int | None = None, ny: int | None = None, seed: int = 0,
        engine: str = "auto", device="cuda", grad: dict | None = None):
    """`bench`'s result: the headline forward rate and the training
    step's → a dict of JAX's keys.

    The scene is built once (the CLI's scene_build is outside its rate);
    one untimed call of `cli.render_scene` at the timed call's size, spp
    and chunking warms every path the timed calls take (kernel build, the
    first use of each torch op); then KERNEL_REPS calls (GENERAL_REPS on
    the general tier) at seeds seed, seed + 1, …, each timed from a
    synchronized device to its finalized image. On a scene with a dynamic
    sphere or box table (random_spheres, final_scene) the warm call runs
    the cost probe and caches the pixel table (`ops/tracer.render_kernel`:
    the cache is keyed by scene, camera, size and depth, not seed), so the
    timed reps reuse it and their time leaves the probe out.

    value: nx·ny·spp over the best rep; median_rays_per_sec over the
    median; engine: the engine `render_scene` took ("kernel" or "xla");
    then `grad_fd_err`'s worst and per-sweep error, `grad_throughput`'s
    keys, with on the fused tier its 100-step chunk (`_chunk100`: 2 reps)
    and the general tier's step (`_xla_scan`: 3 reps), as JAX's run adds
    them; device: `card_name`. grad: `grad_throughput` arguments that
    override run's in each of those calls (a CPU test's small step), or
    None for the production step. device: "cuda" (the default; raises
    without CUDA) or "cpu"."""
    from .cli import render_scene
    from .models.builders import PRESETS

    device = _check_device(device)
    preset = PRESETS[scene]
    nx = nx or preset.nx
    ny = ny or preset.ny
    spp = spp or preset.spp
    preset = dataclasses.replace(preset, nx=nx, ny=ny)
    tables = preset.build(device=device)
    cam = preset.camera(device=device)
    kw = dict(engine=engine, device=device)

    _, used = render_scene(tables, cam, nx, ny, spp, seed=seed, **kw)
    walls = []
    for r in range(KERNEL_REPS if used == "kernel" else GENERAL_REPS):
        sync(device)
        t0 = time.perf_counter()
        render_scene(tables, cam, nx, ny, spp, seed=seed + r, **kw)
        walls.append(time.perf_counter() - t0)
    dt, dt_med = min(walls), statistics.median(walls)
    rays_per_sec = nx * ny * spp / dt
    base_rays, base_source = reference_baseline()
    grad_worst, grad_per_leaf = grad_fd_err(breakdown=True, device=device)
    gkw = dict(device=device, **(grad or {}))
    grad_tp = grad_throughput(**gkw)
    if grad_tp["grad_engine"] == "fused":
        dev_tp = grad_throughput(**{"reps": 2, "chunk": 100, **gkw})
        grad_tp["grad_samples_per_sec_chunk100"] = \
            dev_tp["grad_samples_per_sec"]
        grad_tp["grad_step_seconds_chunk100"] = dev_tp["grad_step_seconds"]
        xla_tp = grad_throughput(**{"reps": 3, **gkw, "engine": "xla"})
        grad_tp["grad_samples_per_sec_xla_scan"] = \
            xla_tp["grad_samples_per_sec"]
        grad_tp["grad_step_seconds_xla_scan"] = xla_tp["grad_step_seconds"]
    return {
        "metric": f"primary rays/sec/chip ({scene} {nx}x{ny} {spp}spp)",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / base_rays, 2),
        "baseline_rays_per_sec": round(base_rays, 1),
        "baseline_source": base_source,
        "median_rays_per_sec": round(nx * ny * spp / dt_med, 1),
        "wall_seconds": dt,
        "wall_seconds_all_reps": walls,
        "engine": used,
        "grad_fd_max_abs_err": grad_worst,
        "grad_fd_per_leaf": grad_per_leaf,
        **grad_tp,
        "device": card_name(device),
    }


def grad_throughput(reps: int = 5, chunk: int = 10, block: int = 4096,
                    spp: int = 64, max_depth: int = 6, engine: str = "auto",
                    device="cuda", nx: int = 200, ny: int = 200) -> dict:
    """Sample-paths/s forward and backward of the default inverse render's
    training step (`inverse_render.default_run`: nx×ny, `block` pixels ×
    `spp` a step, depth max_depth; the path-matched loss, then Adam with
    its cosine decay and clamps, `inverse_render.update`), counting the
    target's and the candidate's paths: 2·block·spp a step.

    One warm chunk of `chunk` steps, then `reps` timed chunks, each from a
    synchronized device to its losses on the host; a step's time is its
    chunk's over chunk. The steps are eager (torch has no on-device scan
    of them), so a longer chunk only spreads the host pull wider.
    engine: "auto" takes the fused tier (K2/K3, their plain twin on the
    CPU) wherever `inverse_render.pick_tier` does, "xla" the general tier.
    → grad_samples_per_sec (best chunk), _median, grad_step_seconds,
    _all_reps, grad_engine ("fused" or "general"), grad_config."""
    from . import inverse_render as ir

    device = _check_device(device)
    if engine not in ("auto", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    trainer = ir.default_run(nx=nx, ny=ny, spp=spp, block=block,
                             max_depth=max_depth, device=device,
                             fast=engine != "xla")
    opt, sched = ir.optimizer(trainer.groups, (reps + 1) * chunk)

    def one_chunk(c: int) -> float:
        sync(device)
        t0 = time.perf_counter()
        losses = [ir.update(opt, sched, trainer.groups, trainer.step,
                            c * chunk + i) for i in range(chunk)]
        torch.stack(losses).tolist()
        return (time.perf_counter() - t0) / chunk

    one_chunk(0)
    walls = [one_chunk(1 + r) for r in range(reps)]
    paths_per_step = 2 * block * spp
    best, med = min(walls), statistics.median(walls)
    return {
        "grad_samples_per_sec": round(paths_per_step / best, 1),
        "grad_samples_per_sec_median": round(paths_per_step / med, 1),
        "grad_step_seconds": best,
        "grad_step_seconds_all_reps": walls,
        "grad_engine": trainer.tier,
        "grad_config": (f"inverse_render {nx}x{ny} block {block} spp {spp} "
                        f"depth {max_depth}, {chunk}-step chunks of eager "
                        f"steps, target+candidate fwd+bwd, Adam"),
    }


def to_json(result: dict) -> str:
    return json.dumps(result)
