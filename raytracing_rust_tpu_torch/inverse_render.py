"""Inverse rendering: recover scene parameters by gradient descent through
the fused differentiable tier (kernels K2 and K3) or the general tier.

Counterpart of `examples/inverse_render.py`, in two modes:

* the default (`main_sharded`): a 200×200 cornell-style box is the target;
  Adam on an L2 photometric loss over random pixel blocks recovers TWO
  parameter groups at once: the tall box's albedo (3 channels) and the
  ceiling light's emission (one scalar shared by the three channels);
* `--geometry` (`main_geometry`): a cube tilted about x under the sky,
  beside a ground sphere and a rect light; THREE groups at once: the
  cube's albedo, the light's emission and the tilt θ, which enters the
  scene as the transform row's sin θ and cos θ. Its gradient is the
  geometric adjoint of K3: the sky's radiance moves with every scattered
  direction, and so with the cube's normals.

Each step traces the target and the candidate on the SAME camera rays and
the SAME draws: the path-matched estimator, so the loss compares two
estimates of the same paths that differ only through the parameters (an L2
between independent Monte Carlo estimates would reward a darker, less
noisy albedo). The differentiable tier, printed at the start:

* the fused tier, `ops.grad.trace_fast` (K2/K3 on the card, their plain
  twin on the CPU), wherever `supports_fast_grad` takes the scene and
  depth;
* the general tier, `parallel.sharding.train_step_sharded` (on one rank
  `render.train_step`: autograd through
  `integrator.trace(differentiable=True)`, the target traced without
  gradient), with `--no-fast`, with `--unfused`, and wherever the fused
  tier refuses the scene (as the JAX script falls back to its XLA scan
  tier). Its draws are the step's `fast_draws`, so on the same step both
  tiers trace the same paths.

`--unfused` is the JAX script's per-step loop: its pixel blocks come from
numpy's `default_rng(seed).choice` (the JAX loop's `default_rng(0)` at
seed 0) in place of the per-step randperm, on the general tier. The JAX
loop also differs in its dispatches; in eager torch every mode issues its
ops one by one, so the pixel choice is the only difference. `--quick` is
`main_quick`: albedo alone, 8,192 rays through the script's camera, Adam
0.05 for 60 steps on the general tier.

The default mode (and `--unfused`) runs, as the JAX script's
`main_sharded` does, on a mesh of the process group's ranks: one without
torchrun, N under `torchrun --nproc-per-node N`, laid out as JAX lays its
devices (sp = 2 when N is even, dp = N / sp; `parallel/sharding.py`, NCCL
on the card, gloo on the CPU). With N > 1 every step is
`train_step_sharded` on the general tier, as JAX turns its fused tier off
on a mesh of more than one device. Each rank draws the same pixel blocks
and applies the same all-reduced gradients, so the parameters stay equal
on every rank; rank 0 logs. `--geometry` and `--quick` run on one rank,
as in JAX.

    python -m raytracing_rust_tpu_torch.inverse_render [--device cuda|cpu]
        [--geometry] [--no-fast] [--unfused] [--quick] [--steps 40|200]
        [--spp 64] [--block 4096] [--seed 0]
    torchrun --nproc-per-node N -m raytracing_rust_tpu_torch.inverse_render
        [--device cuda|cpu] [--unfused] [--steps 40] [...]

Exits 0 iff the JAX script's criterion holds: the default, the recovered
albedo within 0.1 (max abs) and the emission within 0.5 of the truth;
`--geometry`, albedo within 0.05, emission within 0.3 and tilt within 3°;
`--quick`, albedo within 0.08.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from .models.scene import BG_BLACK, BG_SKY, SceneBuilder, SceneTables
from .ops.camera import make_camera
from .ops import rng
from .ops.camera import get_rays
from .ops.grad import (MAX_DEPTH, check_kernel_scope, fast_draws,
                       fast_grad_config, supports_fast_grad, trace_fast)
from .ops.integrator import trace
from .parallel import sharding
from .render import camera_lane_rays

TRUE_ALBEDO = (0.2, 0.5, 0.8)   # ground-truth blue-ish box
TRUE_EMIT = 5.0                  # ground-truth light emission
START_ALBEDO = (0.5, 0.5, 0.5)
START_EMIT = 3.0

# --geometry (examples/inverse_render.py:437-440, 497-499)
TRUE_GEO_ALBEDO = (0.2, 0.5, 0.8)
TRUE_GEO_EMIT = 4.0
TRUE_TILT_DEG = 25.0
GEO_XF = 1  # the cube's transform row (row 0 is the identity slot)
START_GEO_ALBEDO = (0.5, 0.5, 0.5)
START_GEO_EMIT = 2.0
START_THETA = 0.0


def camera(device="cpu"):
    """The script's camera (examples/inverse_render.py:632)."""
    return make_camera((0, 3, 9), (0, 1.5, 0), (0, 1, 0), 45.0, 1.0, 0.0,
                       9.0, device=device)


def geo_camera(device="cpu"):
    """The geometry mode's camera (examples/inverse_render.py:442-443)."""
    return make_camera((0, 2.2, 8), (0, 1.2, 0), (0, 1, 0), 40.0, 1.0, 0.0,
                       8.0, device=device)


def build_scene(box_albedo=(0.73, 0.73, 0.73), emit=TRUE_EMIT,
                device="cpu") -> SceneTables:
    """Floor, red and green walls, a ceiling light and a 6-rect box."""
    b = SceneBuilder(background=BG_BLACK)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    b.rect("zx", -3, -3, 3, 3, 0.0, white)                       # floor
    b.rect("yz", 0, -3, 6, 3, -3.0, b.lambertian(b.solid(0.65, 0.05, 0.05)))
    b.rect("yz", 0, -3, 6, 3, 3.0, b.lambertian(b.solid(0.12, 0.45, 0.15)),
           flip=True)
    b.rect("zx", -2, -2, 2, 2, 5.9, b.diffuse_light(b.solid(emit, emit, emit)),
           flip=True)
    box_mat = b.lambertian(b.solid(*box_albedo))
    b.cube((-1.0, 0.0, -1.0), (1.0, 2.5, 1.0), box_mat)
    return b.build(device)


def build_geo_scene(albedo=START_GEO_ALBEDO, emit=TRUE_GEO_EMIT,
                    tilt_deg=0.0, device="cpu") -> SceneTables:
    """The geometry mode's scene (examples/inverse_render.py:446-461): a
    ground sphere, a flipped rect light and a cube centred on its rotation
    origin, tilted about x by transform row GEO_XF, under the sky."""
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.rect("zx", -1.5, -1.5, 1.5, 1.5, 6.0,
           b.diffuse_light(b.solid(emit, emit, emit)), flip=True)
    xf = b.transform(offset=(0.0, 1.3, 0.0), rotate_axis="x",
                     angle_deg=tilt_deg)
    b.cube((-0.9, -0.9, -0.9), (0.9, 0.9, 0.9),
           b.lambertian(b.solid(*albedo)), xform=xf)
    return b.build(device)


def param_tex_rows(scene: SceneTables):
    """(light_tex, box_tex) texture rows of the two trained groups:
    material 3 is the diffuse light, the box material is pushed last."""
    light_tex = int(scene.mat_texture[3])
    box_tex = int(scene.mat_texture[-1])
    return light_tex, box_tex


def geo_param_rows(scene: SceneTables):
    """(light_tex, cube_tex) of the geometry scene: the light is prim 1,
    the cube's faces are pushed last (examples/inverse_render.py:482-485)."""
    mat_tex = scene.mat_texture.cpu().numpy()
    prim_mat = scene.prim_material.cpu().numpy()
    return int(mat_tex[prim_mat[1]]), int(mat_tex[prim_mat[-1]])


def with_params(scene: SceneTables, light_tex: int, box_tex: int,
                albedo: torch.Tensor, emit: torch.Tensor,
                theta: torch.Tensor | None = None) -> SceneTables:
    """The scene with the box's texture row set to albedo and the light's to
    emit on all three channels, and, where theta is given, transform row
    GEO_XF rotated by theta (its sin and cos); differentiable in all three."""
    tc = scene.tex_color
    row = torch.arange(tc.shape[0], device=tc.device)[:, None]
    tc = torch.where(row == box_tex, albedo[None, :], tc)
    tc = torch.where(row == light_tex, emit.expand(3)[None, :], tc)
    if theta is None:
        return dataclasses.replace(scene, tex_color=tc)
    xrow = torch.arange(scene.xf_sin.shape[0], device=tc.device) == GEO_XF
    return dataclasses.replace(
        scene, tex_color=tc,
        xf_sin=torch.where(xrow, torch.sin(theta), scene.xf_sin),
        xf_cos=torch.where(xrow, torch.cos(theta), scene.xf_cos))


def step_pixels(step: int, *, nx: int, ny: int, block: int, device,
                seed: int = 0) -> torch.Tensor:
    """The step's pixel block: a permutation prefix from a generator
    seeded with the key (seed << 32) | step."""
    g = torch.Generator(device=device)
    g.manual_seed((seed << 32) | step)
    return torch.randperm(nx * ny, generator=g, device=device)[:block]


def step_inputs(cam, step: int, *, nx: int, ny: int, spp: int, block: int,
                max_depth: int, device, seed: int = 0):
    """The step's pixel block (`step_pixels`), camera rays and trace draws,
    shared by the target and the candidate. Rays and draws come from
    Philox under the key (seed << 32) | step (their streams differ,
    ops/rng.py). Seed 0 keys each step by its index alone."""
    key = (seed << 32) | step
    pix = step_pixels(step, nx=nx, ny=ny, block=block, device=device,
                      seed=seed)
    pid = pix.repeat_interleave(spp)
    o, d, _ = camera_lane_rays(cam, pid, key, nx, ny)
    u = fast_draws(key, pid.shape[0], max_depth + 1, device)
    return o, d, u


def path_matched_loss(target_scene, scene, light_tex, box_tex, albedo, emit,
                      o, d, u, *, block: int, spp: int, max_depth: int, cfg,
                      theta=None):
    """mean((candidate block image − target block image)²), the target
    traced without gradient on the same rays and draws."""
    def img(s):
        rad = trace_fast(s, o, d, 0, max_depth=max_depth, cfg=cfg, u=u)
        return rad.reshape(block, spp, 3).sum(dim=1) / spp

    with torch.no_grad():
        target = img(target_scene)
    cand = img(with_params(scene, light_tex, box_tex, albedo, emit, theta))
    return torch.mean((cand - target) ** 2)


def _unmarked(part: str) -> None:
    """A step's `mark` where nothing times the step's parts."""


def general_step(target_scene, scene, cam, light_tex, box_tex, albedo, emit,
                 pix, key: int, *, nx: int, ny: int, spp: int,
                 max_depth: int, theta=None, mesh=None,
                 mark=_unmarked) -> torch.Tensor:
    """One step on the general tier → the loss (detached), with the
    gradients of albedo, emit and theta accumulated into their .grad:
    `train_step_sharded` over mesh (`parallel.sharding.Mesh`; None is one
    rank with no process group, `render.train_step` bit for bit) on the
    scene that `with_params` makes, its table gradients chained back onto
    the parameters. The target is traced without gradient on the same rays
    (`camera_lane_rays` under key) and draws (`fast_draws` under key, as the
    fused tier's step draws), sharded the same way
    (`render_block_sharded`). mark(part) is called where each part ends:
    "target", then "fwd_bwd"."""
    u = fast_draws(key, pix.shape[0] * spp, max_depth + 1, pix.device)
    kw = dict(nx=nx, ny=ny, spp=spp, max_depth=max_depth, mesh=mesh, u=u)
    with torch.no_grad():
        target = sharding.render_block_sharded(target_scene, cam, pix, key,
                                               **kw) / spp
    mark("target")
    s2 = with_params(scene, light_tex, box_tex, albedo, emit, theta)
    wrt = ("tex_color",) if theta is None else ("tex_color", "xf_sin",
                                                "xf_cos")
    loss, g = sharding.train_step_sharded(s2, cam, pix, key, target, wrt=wrt,
                                          **kw)
    torch.autograd.backward([getattr(s2, k) for k in wrt],
                            [g[k] for k in wrt])
    mark("fwd_bwd")
    return loss


def pick_tier(scene: SceneTables, max_depth: int, device,
              fast: bool = True, why_not: str = "--no-fast"):
    """The differentiable tier of a run → ("fused", its log line) where
    fast is on and the fused tier takes the scene at max_depth, else
    ("general", its log line with the reason)."""
    if fast and supports_fast_grad(scene, max_depth):
        return "fused", ("fused CUDA kernels K2/K3" if device.type == "cuda"
                         else "fused tier's plain torch twin")
    if fast:
        why_not = (f"the fused tier does not take this scene at depth "
                   f"{max_depth}: it takes depth ≤ {MAX_DEPTH} and no media, "
                   f"noise or image texture or moving sphere")
    return "general", (f"general wavefront tier, torch autograd through "
                       f"checkpointed bounces on {device.type} ({why_not})")


def cosine_decay(total: int, alpha: float):
    """optax.cosine_decay_schedule(lr, total, alpha) as a LambdaLR factor."""
    def f(t):
        t = min(t, total)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / total)) + alpha
    return f


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but torch.cuda.is_available() "
                           "is false")
    return device


def _describe(device, nx, ny, spp, block, max_depth, seed) -> str:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return (f"device: {device.type} ({name}), image {nx}x{ny}, spp {spp}/step, "
            f"block {block} pixels, depth {max_depth}, seed {seed}")


def optimizer(groups, horizon: int):
    """Adam on `groups` [(leaf, lr, lo, hi)], a param group a leaf, and the
    cosine decay of each lr to 0.1 of it over `horizon` steps → (opt,
    sched)."""
    opt = torch.optim.Adam([{"params": [p], "lr": lr}
                            for p, lr, _, _ in groups])
    return opt, torch.optim.lr_scheduler.LambdaLR(opt,
                                                  cosine_decay(horizon, 0.1))


def update(opt, sched, groups, step, i: int, mark=None) -> torch.Tensor:
    """Training step i: step(i)'s loss and backward, then the Adam update,
    the schedule's step and each leaf clamped to its [lo, hi] → the loss
    (on the device, not pulled). mark: None, or a hook that step(i, mark)
    calls where each of its parts ends, and that is called with "adam"
    after the update (`profile_train_step` times the parts so)."""
    opt.zero_grad(set_to_none=True)
    loss = step(i) if mark is None else step(i, mark)
    opt.step()
    sched.step()
    with torch.no_grad():
        for p, _, lo, hi in groups:
            p.clamp_(lo, hi)
    if mark is not None:
        mark("adam")
    return loss


def _fit(groups, step, *, steps: int, horizon: int, log, show):
    """Adam on `groups` [(leaf, lr, lo, hi)], each lr under the cosine decay
    to 0.1 of it over `horizon` steps, each leaf clamped to [lo, hi] after
    its update; step(i) runs step i's loss and backward and returns the
    loss → (losses, step_walls).

    losses: the loss of every step, pulled to the host every 10 steps;
    step_walls: seconds per step of each chunk of up to 10 steps (the first
    includes the kernel build and warm-up). show() formats the parameters
    for the log line of each chunk."""
    opt, sched = optimizer(groups, horizon)
    losses, pending, walls = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = update(opt, sched, groups, step, i)
        pending.append(loss)
        if (i + 1) % 10 == 0 or i == steps - 1:
            # one host pull per chunk: it also waits for the chunk's work
            losses += torch.stack(pending).tolist()
            wall = time.perf_counter() - t0
            walls.append(wall / len(pending))
            log(f"step {i:3d}  loss {losses[-1]:.5f}  {show()}  "
                f"({wall:.2f}s chunk of {len(pending)})")
            pending = []
            t0 = time.perf_counter()
    return losses, walls


def _albedo_str(a) -> str:
    return f"[{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}]"


@dataclasses.dataclass
class DefaultRun:
    """The default inverse render's trained leaves and one step of it
    (`default_run`)."""
    albedo: torch.Tensor      # f32[3], requires grad
    emit: torch.Tensor        # f32[], requires grad
    groups: list              # [(leaf, lr, lo, hi)] for `optimizer`, `update`
    step: object              # step(i, mark) → loss, the leaves' .grad added
    tier: str                 # "fused" or "general"
    tier_line: str            # `pick_tier`'s log line
    cam: object               # the camera
    target_scene: SceneTables  # at the true values
    scene: SceneTables        # at the start values, with_params' base
    light_tex: int
    box_tex: int
    cfg: object               # `fast_grad_config(scene)`; None: general


def default_run(*, nx: int = 200, ny: int = 200, spp: int = 64,
                block: int = 4096, max_depth: int = 6, device="cuda",
                seed: int = 0, fast: bool = True, unfused: bool = False,
                mesh=None) -> DefaultRun:
    """The default inverse render's leaves, at the start values, and its
    step: step(i) traces step i's target and candidate on the same rays
    and draws (`step_inputs` and `path_matched_loss` on the fused tier,
    `general_step` on the general tier), backpropagates and returns the
    loss, calling mark(part) where each part ends: "step_inputs" and
    "fwd_bwd" on the fused tier, "pixels", "target" and "fwd_bwd" on the
    general. `train` runs it under `optimizer` and `update`, as
    `benchlib.grad_throughput` and `profile_train_step` do; the arguments
    are `train`'s."""
    device = _check_device(device)
    cam = camera(device)
    target_scene = build_scene(TRUE_ALBEDO, TRUE_EMIT, device)
    scene = build_scene(START_ALBEDO, START_EMIT, device)
    light_tex, box_tex = param_tex_rows(scene)
    sharded = mesh is not None and mesh.size > 1
    why_not = "--unfused" if unfused else "--no-fast"
    if sharded:
        why_not = f"sharded over dp={mesh.dp} sp={mesh.sp} ranks"
    tier, tier_line = pick_tier(scene, max_depth, device,
                                fast and not unfused and not sharded, why_not)
    cfg = None
    if tier == "fused":
        cfg = fast_grad_config(scene)
        check_kernel_scope(cfg)

    albedo = torch.tensor(START_ALBEDO, dtype=torch.float32, device=device,
                          requires_grad=True)
    emit = torch.tensor(START_EMIT, dtype=torch.float32, device=device,
                        requires_grad=True)
    kw = dict(nx=nx, ny=ny, spp=spp, block=block, max_depth=max_depth)
    pick = np.random.default_rng(seed) if unfused else None

    def step(i, mark=_unmarked):
        if tier == "fused":
            o, d, u = step_inputs(cam, i, device=device, seed=seed, **kw)
            mark("step_inputs")
            loss = path_matched_loss(target_scene, scene, light_tex, box_tex,
                                     albedo, emit, o, d, u, block=block,
                                     spp=spp, max_depth=max_depth, cfg=cfg)
            loss.backward()
            mark("fwd_bwd")
            return loss.detach()
        if unfused:
            pix = torch.from_numpy(pick.choice(nx * ny, size=block,
                                               replace=False)).to(device)
        else:
            pix = step_pixels(i, nx=nx, ny=ny, block=block, device=device,
                              seed=seed)
        mark("pixels")
        return general_step(target_scene, scene, cam, light_tex, box_tex,
                            albedo, emit, pix, (seed << 32) | i, nx=nx, ny=ny,
                            spp=spp, max_depth=max_depth, mesh=mesh,
                            mark=mark)

    # per-group lr: emission must travel ~2.0 while albedo travels ≤ 0.3;
    # the cosine decay damps the momentum overshoot once each arrives
    return DefaultRun(albedo, emit,
                      [(albedo, 0.05, 0.0, 1.0), (emit, 0.25, 0.0, 20.0)],
                      step, tier, tier_line, cam, target_scene, scene,
                      light_tex, box_tex, cfg)


def train(*, steps: int = 40, nx: int = 200, ny: int = 200, spp: int = 64,
          block: int = 4096, max_depth: int = 6, device="cuda", seed: int = 0,
          fast: bool = True, unfused: bool = False, mesh=None,
          log=print) -> dict:
    """Run the default inverse render → dict(albedo, emit, losses,
    step_walls, tier) (`_fit`).

    seed picks the pixel blocks, rays and draws of every step
    (`step_inputs`); 0 is the default run. fast=False (`--no-fast`) and
    unfused (`--unfused`: numpy's pixel blocks) train on the general tier
    (`general_step`), as does a max_depth the fused tier refuses. mesh: a
    `parallel.sharding.Mesh` over the process group's ranks, each calling
    this with its own device (None: one rank with no process group); on a
    mesh of more than one rank every step is sharded over it on the
    general tier."""
    run = default_run(nx=nx, ny=ny, spp=spp, block=block,
                      max_depth=max_depth, device=device, seed=seed,
                      fast=fast, unfused=unfused, mesh=mesh)
    albedo, emit = run.albedo, run.emit
    log(_describe(albedo.device, nx, ny, spp, block, max_depth, seed))
    log(f"target: albedo [{TRUE_ALBEDO[0]:.2f} {TRUE_ALBEDO[1]:.2f} "
        f"{TRUE_ALBEDO[2]:.2f}], emission {TRUE_EMIT:.2f}; start: albedo "
        f"[0.50 0.50 0.50], emission 3.00")
    log(f"differentiable tier: {run.tier_line}")
    losses, walls = _fit(
        run.groups, run.step, steps=steps, horizon=steps, log=log,
        show=lambda: (f"albedo {_albedo_str(albedo.detach().cpu().numpy())}  "
                      f"emit {emit.item():.3f}"))
    return dict(albedo=albedo.detach().cpu().numpy(), emit=emit.item(),
                losses=losses, step_walls=walls, tier=run.tier)


def train_geometry(*, steps: int = 200, nx: int = 200, ny: int = 200,
                   spp: int = 64, block: int = 4096, max_depth: int = 6,
                   device="cuda", seed: int = 0, fast: bool = True,
                   log=print) -> dict:
    """Run the geometry inverse render (`main_geometry`) → dict(albedo,
    emit, tilt_deg, losses, step_walls, tier) (`_fit`): ceil(steps/10)·10
    steps, as the JAX script rounds `steps` up to whole chunks of 10, of
    Adam on albedo (lr 0.05), emission (0.2) and θ (0.06), each under the
    cosine decay over those steps, clamped to [0, 1], [0, 20] and
    [−1.2, 1.2]. fast=False (`--no-fast`) trains on the general tier, θ
    reaching it through the transform row's sin and cos."""
    device = _check_device(device)
    cam = geo_camera(device)
    target_scene = build_geo_scene(TRUE_GEO_ALBEDO, TRUE_GEO_EMIT,
                                   TRUE_TILT_DEG, device)
    scene = build_geo_scene(START_GEO_ALBEDO, TRUE_GEO_EMIT, 0.0, device)
    light_tex, cube_tex = geo_param_rows(scene)
    tier, tier_line = pick_tier(scene, max_depth, device, fast)
    if tier == "fused":
        cfg = fast_grad_config(scene)
        check_kernel_scope(cfg)

    f32 = dict(dtype=torch.float32, device=device, requires_grad=True)
    albedo = torch.tensor(START_GEO_ALBEDO, **f32)
    emit = torch.tensor(START_GEO_EMIT, **f32)
    theta = torch.tensor(START_THETA, **f32)
    log(_describe(device, nx, ny, spp, block, max_depth, seed))
    log(f"geometry mode: recover cube tilt {TRUE_TILT_DEG}° + albedo "
        f"[{TRUE_GEO_ALBEDO[0]:.2f} {TRUE_GEO_ALBEDO[1]:.2f} "
        f"{TRUE_GEO_ALBEDO[2]:.2f}] + emission {TRUE_GEO_EMIT:.2f}; start: "
        f"tilt 0°, albedo [0.50 0.50 0.50], emission 2.00")
    log(f"differentiable tier: {tier_line}")

    kw = dict(nx=nx, ny=ny, spp=spp, block=block, max_depth=max_depth)

    def step(i):
        if tier == "fused":
            o, d, u = step_inputs(cam, i, device=device, seed=seed, **kw)
            loss = path_matched_loss(target_scene, scene, light_tex, cube_tex,
                                     albedo, emit, o, d, u, block=block,
                                     spp=spp, max_depth=max_depth, cfg=cfg,
                                     theta=theta)
            loss.backward()
            return loss.detach()
        pix = step_pixels(i, nx=nx, ny=ny, block=block, device=device,
                          seed=seed)
        return general_step(target_scene, scene, cam, light_tex, cube_tex,
                            albedo, emit, pix, (seed << 32) | i, nx=nx, ny=ny,
                            spp=spp, max_depth=max_depth, theta=theta)

    total = -(-steps // 10) * 10
    losses, walls = _fit(
        [(albedo, 0.05, 0.0, 1.0), (emit, 0.2, 0.0, 20.0),
         (theta, 0.06, -1.2, 1.2)], step,
        steps=total, horizon=total, log=log,
        show=lambda: (f"albedo {_albedo_str(albedo.detach().cpu().numpy())}  "
                      f"emit {emit.item():.3f}  "
                      f"tilt {math.degrees(theta.item()):.2f}°"))
    return dict(albedo=albedo.detach().cpu().numpy(), emit=emit.item(),
                tilt_deg=math.degrees(theta.item()), losses=losses,
                step_walls=walls, tier=tier)


QUICK_RAYS = 8192
QUICK_STEPS = 60
QUICK_LR = 0.05
QUICK_RAY_SEED = 1     # the rays' key (JAX: fold_in(key(0), 1))
QUICK_STEP_SEED = 100  # step i's draws under key QUICK_STEP_SEED + i


def train_quick(*, n_rays: int = QUICK_RAYS, steps: int = QUICK_STEPS,
                max_depth: int = 6, device="cuda", log=print) -> dict:
    """The JAX script's `main_quick` → dict(albedo, losses, seconds): the
    box albedo alone (the light at its true emission) from n_rays camera
    rays through `camera()` at uniform (s, t) (Philox CAMERA words 0-1
    under key QUICK_RAY_SEED, keyed by lane), Adam at QUICK_LR with no
    decay, clamped to [0, 1]; step i traces the target without gradient
    and the candidate with it on the same draws (key QUICK_STEP_SEED + i)
    through the general tier. Logs steps 0, 10, …, and the last."""
    device = _check_device(device)
    cam = camera(device)
    lane = torch.arange(n_rays, dtype=torch.int64, device=device)
    s, t, _, _ = rng.draws(QUICK_RAY_SEED, lane, 0, 0, rng.STREAM_CAMERA)
    o, d, time_ = get_rays(cam, s, t, torch.zeros(n_rays, 3, device=device))
    target_scene = build_scene(TRUE_ALBEDO, TRUE_EMIT, device)
    scene = build_scene(START_ALBEDO, TRUE_EMIT, device)
    _, box_tex = param_tex_rows(scene)
    albedo = torch.tensor(START_ALBEDO, dtype=torch.float32, device=device,
                          requires_grad=True)
    opt = torch.optim.Adam([albedo], lr=QUICK_LR)
    log(f"differentiable tier: general wavefront tier, torch autograd "
        f"through checkpointed bounces on {device.type} (--quick)")
    log(f"target albedo: [0.20 0.50 0.80], start: {_albedo_str(START_ALBEDO)}")
    zero = torch.zeros_like(lane)
    row = torch.arange(scene.tex_color.shape[0], device=device)[:, None]
    losses = []
    t0 = clock = time.perf_counter()
    for i in range(steps):
        seed = QUICK_STEP_SEED + i
        with torch.no_grad():
            target = trace(target_scene, o, d, time_, seed, lane, zero,
                           max_depth)
        s2 = dataclasses.replace(scene, tex_color=torch.where(
            row == box_tex, albedo[None, :], scene.tex_color))
        rad = trace(s2, o, d, time_, seed, lane, zero, max_depth,
                    differentiable=True)
        loss = torch.mean((rad - target) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
        losses.append(loss.item())
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {losses[-1]:.5f}  albedo "
                f"{_albedo_str(albedo.detach().cpu().numpy())}  "
                f"({time.perf_counter() - clock:.2f}s)")
            clock = time.perf_counter()
    return dict(albedo=albedo.detach().cpu().numpy(), losses=losses,
                seconds=time.perf_counter() - t0)


def _steady(walls) -> tuple[float, str]:
    if len(walls) > 1:
        # median over the chunks after the first (build and warm-up)
        return float(np.median(walls[1:])), "median steady chunk"
    return walls[0], "avg incl. build and warm-up (single chunk)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.inverse_render",
        description="recover scene parameters by gradient descent through "
                    "the fused kernels or the general tier: the box albedo "
                    "and the light emission, or with --geometry a cube's "
                    "tilt as well")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--geometry", action="store_true",
                    help="recover the cube tilt + albedo + emission under "
                         "the sky (200 steps by default)")
    ap.add_argument("--no-fast", action="store_true",
                    help="train on the general tier (torch autograd) even "
                         "where the fused kernels take the scene")
    ap.add_argument("--unfused", action="store_true",
                    help="the JAX script's per-step loop: numpy's pixel "
                         "blocks, on the general tier (default mode only)")
    ap.add_argument("--quick", action="store_true",
                    help="the small demo: albedo alone, 8,192 rays, 60 "
                         "steps on the general tier")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 40, or 200 with --geometry, "
                         "which rounds them up to a multiple of 10)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--nx", type=int, default=200)
    ap.add_argument("--ny", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0,
                    help="offset of every step's pixel blocks, rays and draws")
    args = ap.parse_args(argv)
    ranks = sharding.world_size()
    if ranks > 1 and (args.quick or args.geometry):
        ap.error(f"--quick and --geometry run on one rank, not {ranks} (the "
                 "JAX script shards its default mode alone)")
    if args.quick:
        res = train_quick(device=args.device)
        a = res["albedo"]
        err = float(np.abs(a - np.asarray(TRUE_ALBEDO)).max())
        print(f"recovered albedo {_albedo_str(a)} (max abs err {err:.3f})")
        return 0 if err < 0.08 else 1
    if args.geometry and args.unfused:
        ap.error("--unfused is the default mode's loop (the JAX script's "
                 "geometry mode has none)")
    if not 0 <= args.seed < 1 << 31:
        ap.error(f"--seed {args.seed} must lie in [0, 2^31)")
    if args.block > args.nx * args.ny:
        ap.error(f"--block {args.block} exceeds the {args.nx * args.ny} pixels")
    kw = dict(nx=args.nx, ny=args.ny, spp=args.spp, block=args.block,
              device=args.device, seed=args.seed, fast=not args.no_fast)
    rays = args.block * args.spp
    if args.geometry:
        res = train_geometry(steps=200 if args.steps is None else args.steps,
                             **kw)
        a, e, tdeg = res["albedo"], res["emit"], res["tilt_deg"]
        err_a = float(np.abs(a - np.asarray(TRUE_GEO_ALBEDO)).max())
        err_e = abs(e - TRUE_GEO_EMIT)
        err_t = abs(tdeg - TRUE_TILT_DEG)
        steady, tag = _steady(res["step_walls"])
        print(f"recovered albedo {_albedo_str(a)} (max abs err {err_a:.3f}), "
              f"emission {e:.3f} (err {err_e:.3f}), tilt {tdeg:.2f}° "
              f"(err {err_t:.2f}°)")
        print(f"step time: {steady:.4f}s {tag} (3 groups incl. geometry, "
              f"{rays / 1e6:.2f}M target + {rays / 1e6:.2f}M candidate "
              f"sample-paths/step fwd+bwd, depth 6, {res['tier']} tier)")
        return 0 if (err_a < 0.05 and err_e < 0.3 and err_t < 3.0) else 1
    steps = 40 if args.steps is None else args.steps
    # JAX's main_sharded mesh: sp = 2 on an even count of devices
    sp = 2 if ranks % 2 == 0 else 1
    with sharding.process_group(args.device) as dev:
        mesh = sharding.make_mesh(dp=ranks // sp, sp=sp)
        res = train(steps=steps, unfused=args.unfused, mesh=mesh,
                    log=print if mesh.rank == 0 else (lambda *a: None),
                    **{**kw, "device": dev})
    a, e = res["albedo"], res["emit"]
    err_a = float(np.abs(a - np.asarray(TRUE_ALBEDO)).max())
    err_e = abs(e - TRUE_EMIT)
    steady, tag = _steady(res["step_walls"])
    if mesh.rank == 0:
        print(f"recovered albedo {_albedo_str(a)} (max abs err {err_a:.3f}), "
              f"emission {e:.3f} (err {err_e:.3f})")
        print(f"step time: {steady:.4f}s {tag} ({rays / 1e6:.2f}M target + "
              f"{rays / 1e6:.2f}M candidate sample-paths/step fwd+bwd, depth "
              f"6, {res['tier']} tier)")
    return 0 if (err_a < 0.1 and err_e < 0.5) else 1


if __name__ == "__main__":
    sys.exit(main())
