"""Inverse rendering: recover scene parameters by gradient descent through
the fused differentiable tier (kernels K2 and K3).

Counterpart of `examples/inverse_render.py`, its one-device fast path, in
two modes:

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

Each step traces the target and the candidate through
`ops.grad.trace_fast` on the SAME camera rays and the SAME draws: the
path-matched estimator, so the loss compares two estimates of the same
paths that differ only through the parameters (an L2 between independent
Monte Carlo estimates would reward a darker, less noisy albedo).

    python -m raytracing_rust_tpu_torch.inverse_render [--device cuda|cpu]
        [--geometry] [--steps 40|200] [--spp 64] [--block 4096] [--seed 0]

Exits 0 iff the JAX script's criterion holds: the default, the recovered
albedo within 0.1 (max abs) and the emission within 0.5 of the truth;
`--geometry`, albedo within 0.05, emission within 0.3 and tilt within 3°.
Not ported: the sharded path, `--unfused`, `--no-fast` and `--quick`.
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
from .ops.grad import (check_kernel_scope, fast_draws, fast_grad_config,
                       trace_fast)
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


def step_inputs(cam, step: int, *, nx: int, ny: int, spp: int, block: int,
                max_depth: int, device, seed: int = 0):
    """The step's pixel block, camera rays and trace draws, shared by the
    target and the candidate. The pixel block is a permutation prefix from
    a generator seeded with the key (seed << 32) | step; rays and draws come
    from Philox under the same key (their streams differ, ops/rng.py).
    Seed 0 keys each step by its index alone."""
    key = (seed << 32) | step
    g = torch.Generator(device=device)
    g.manual_seed(key)
    pix = torch.randperm(nx * ny, generator=g, device=device)[:block]
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


def _describe(device, nx, ny, spp, block, max_depth, seed) -> list[str]:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    tier = ("fused CUDA kernels K2/K3" if device.type == "cuda"
            else "plain torch twin")
    return [f"device: {device.type} ({name}), image {nx}x{ny}, spp {spp}/step, "
            f"block {block} pixels, depth {max_depth}, seed {seed}",
            f"differentiable tier: {tier}"]


def _fit(groups, step_loss, *, steps: int, horizon: int, log, show):
    """Adam on `groups` [(leaf, lr, lo, hi)], each lr under the cosine decay
    to 0.1 of it over `horizon` steps, each leaf clamped to [lo, hi] after
    its update; step_loss(i) is step i's loss → (losses, step_walls).

    losses: the loss of every step, pulled to the host every 10 steps;
    step_walls: seconds per step of each chunk of up to 10 steps (the first
    includes the kernel build and warm-up). show() formats the parameters
    for the log line of each chunk."""
    opt = torch.optim.Adam([{"params": [p], "lr": lr}
                            for p, lr, _, _ in groups])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(horizon, 0.1))
    losses, pending, walls = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = step_loss(i)
        loss.backward()
        opt.step()
        sched.step()
        with torch.no_grad():
            for p, _, lo, hi in groups:
                p.clamp_(lo, hi)
        pending.append(loss.detach())
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


def train(*, steps: int = 40, nx: int = 200, ny: int = 200, spp: int = 64,
          block: int = 4096, max_depth: int = 6, device="cuda", seed: int = 0,
          log=print) -> dict:
    """Run the default inverse render → dict(albedo, emit, losses,
    step_walls) (`_fit`).

    seed picks the pixel blocks, rays and draws of every step
    (`step_inputs`); 0 is the default run."""
    device = _check_device(device)
    cam = camera(device)
    target_scene = build_scene(TRUE_ALBEDO, TRUE_EMIT, device)
    scene = build_scene(START_ALBEDO, START_EMIT, device)
    light_tex, box_tex = param_tex_rows(scene)
    cfg = fast_grad_config(scene)
    check_kernel_scope(cfg)

    albedo = torch.tensor(START_ALBEDO, dtype=torch.float32, device=device,
                          requires_grad=True)
    emit = torch.tensor(START_EMIT, dtype=torch.float32, device=device,
                        requires_grad=True)
    head = _describe(device, nx, ny, spp, block, max_depth, seed)
    log(head[0])
    log(f"target: albedo [{TRUE_ALBEDO[0]:.2f} {TRUE_ALBEDO[1]:.2f} "
        f"{TRUE_ALBEDO[2]:.2f}], emission {TRUE_EMIT:.2f}; start: albedo "
        f"[0.50 0.50 0.50], emission 3.00")
    log(head[1])

    kw = dict(nx=nx, ny=ny, spp=spp, block=block, max_depth=max_depth)

    def step_loss(i):
        o, d, u = step_inputs(cam, i, device=device, seed=seed, **kw)
        return path_matched_loss(target_scene, scene, light_tex, box_tex,
                                 albedo, emit, o, d, u, block=block, spp=spp,
                                 max_depth=max_depth, cfg=cfg)

    # per-group lr: emission must travel ~2.0 while albedo travels ≤ 0.3;
    # the cosine decay damps the momentum overshoot once each arrives
    losses, walls = _fit(
        [(albedo, 0.05, 0.0, 1.0), (emit, 0.25, 0.0, 20.0)], step_loss,
        steps=steps, horizon=steps, log=log,
        show=lambda: (f"albedo {_albedo_str(albedo.detach().cpu().numpy())}  "
                      f"emit {emit.item():.3f}"))
    return dict(albedo=albedo.detach().cpu().numpy(), emit=emit.item(),
                losses=losses, step_walls=walls)


def train_geometry(*, steps: int = 200, nx: int = 200, ny: int = 200,
                   spp: int = 64, block: int = 4096, max_depth: int = 6,
                   device="cuda", seed: int = 0, log=print) -> dict:
    """Run the geometry inverse render (`main_geometry`) → dict(albedo,
    emit, tilt_deg, losses, step_walls) (`_fit`): ceil(steps/10)·10 steps,
    as the JAX script rounds `steps` up to whole chunks of 10, of Adam on
    albedo (lr 0.05), emission (0.2) and θ (0.06), each under the cosine
    decay over those steps, clamped to [0, 1], [0, 20] and [−1.2, 1.2]."""
    device = _check_device(device)
    cam = geo_camera(device)
    target_scene = build_geo_scene(TRUE_GEO_ALBEDO, TRUE_GEO_EMIT,
                                   TRUE_TILT_DEG, device)
    scene = build_geo_scene(START_GEO_ALBEDO, TRUE_GEO_EMIT, 0.0, device)
    light_tex, cube_tex = geo_param_rows(scene)
    cfg = fast_grad_config(scene)
    check_kernel_scope(cfg)

    f32 = dict(dtype=torch.float32, device=device, requires_grad=True)
    albedo = torch.tensor(START_GEO_ALBEDO, **f32)
    emit = torch.tensor(START_GEO_EMIT, **f32)
    theta = torch.tensor(START_THETA, **f32)
    head = _describe(device, nx, ny, spp, block, max_depth, seed)
    log(head[0])
    log(f"geometry mode: recover cube tilt {TRUE_TILT_DEG}° + albedo "
        f"[{TRUE_GEO_ALBEDO[0]:.2f} {TRUE_GEO_ALBEDO[1]:.2f} "
        f"{TRUE_GEO_ALBEDO[2]:.2f}] + emission {TRUE_GEO_EMIT:.2f}; start: "
        f"tilt 0°, albedo [0.50 0.50 0.50], emission 2.00")
    log(head[1])

    kw = dict(nx=nx, ny=ny, spp=spp, block=block, max_depth=max_depth)

    def step_loss(i):
        o, d, u = step_inputs(cam, i, device=device, seed=seed, **kw)
        return path_matched_loss(target_scene, scene, light_tex, cube_tex,
                                 albedo, emit, o, d, u, block=block, spp=spp,
                                 max_depth=max_depth, cfg=cfg, theta=theta)

    total = -(-steps // 10) * 10
    losses, walls = _fit(
        [(albedo, 0.05, 0.0, 1.0), (emit, 0.2, 0.0, 20.0),
         (theta, 0.06, -1.2, 1.2)], step_loss,
        steps=total, horizon=total, log=log,
        show=lambda: (f"albedo {_albedo_str(albedo.detach().cpu().numpy())}  "
                      f"emit {emit.item():.3f}  "
                      f"tilt {math.degrees(theta.item()):.2f}°"))
    return dict(albedo=albedo.detach().cpu().numpy(), emit=emit.item(),
                tilt_deg=math.degrees(theta.item()), losses=losses,
                step_walls=walls)


def _steady(walls) -> tuple[float, str]:
    if len(walls) > 1:
        # median over the chunks after the first (build and warm-up)
        return float(np.median(walls[1:])), "median steady chunk"
    return walls[0], "avg incl. build and warm-up (single chunk)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.inverse_render",
        description="recover scene parameters by gradient descent through "
                    "the fused kernels: the box albedo and the light "
                    "emission, or with --geometry a cube's tilt as well")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--geometry", action="store_true",
                    help="recover the cube tilt + albedo + emission under "
                         "the sky (200 steps by default)")
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
    if not 0 <= args.seed < 1 << 31:
        ap.error(f"--seed {args.seed} must lie in [0, 2^31)")
    if args.block > args.nx * args.ny:
        ap.error(f"--block {args.block} exceeds the {args.nx * args.ny} pixels")
    kw = dict(nx=args.nx, ny=args.ny, spp=args.spp, block=args.block,
              device=args.device, seed=args.seed)
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
              f"sample-paths/step fwd+bwd, depth 6)")
        return 0 if (err_a < 0.05 and err_e < 0.3 and err_t < 3.0) else 1
    res = train(steps=40 if args.steps is None else args.steps, **kw)
    a, e = res["albedo"], res["emit"]
    err_a = float(np.abs(a - np.asarray(TRUE_ALBEDO)).max())
    err_e = abs(e - TRUE_EMIT)
    steady, tag = _steady(res["step_walls"])
    print(f"recovered albedo {_albedo_str(a)} (max abs err {err_a:.3f}), "
          f"emission {e:.3f} (err {err_e:.3f})")
    print(f"step time: {steady:.4f}s {tag} ({rays / 1e6:.2f}M target + "
          f"{rays / 1e6:.2f}M candidate sample-paths/step fwd+bwd, depth 6)")
    return 0 if (err_a < 0.1 and err_e < 0.5) else 1


if __name__ == "__main__":
    sys.exit(main())
