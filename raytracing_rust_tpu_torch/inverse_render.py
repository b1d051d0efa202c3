"""Inverse rendering: recover scene parameters by gradient descent through
the fused differentiable tier (kernels K2 and K3).

Counterpart of the default mode of `examples/inverse_render.py` (the
one-device fast path of `main_sharded`). A 200×200 cornell-style box is
the target; Adam on an L2 photometric loss over random pixel blocks
recovers TWO parameter groups at once: the tall box's albedo (3 channels)
and the ceiling light's emission (one scalar shared by the three
channels). Each step traces the target and the candidate through
`ops.grad.trace_fast` on the SAME camera rays and the SAME draws: the
path-matched estimator, so the loss compares two estimates of the same
paths that differ only through the parameters (an L2 between independent
Monte Carlo estimates would reward a darker, less noisy albedo).

    python -m raytracing_rust_tpu_torch.inverse_render [--device cuda|cpu]
        [--steps 40] [--spp 64] [--block 4096] [--seed 0]

Exits 0 iff the recovered albedo is within 0.1 (max abs) and the emission
within 0.5 of the truth, the JAX script's criterion. Not ported: the
sharded path, `--unfused`, `--no-fast`, `--quick` and `--geometry`.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from .models.scene import BG_BLACK, SceneBuilder, SceneTables
from .ops.camera import make_camera
from .ops.grad import (check_kernel_scope, fast_draws, fast_grad_config,
                       trace_fast)
from .render import camera_lane_rays

TRUE_ALBEDO = (0.2, 0.5, 0.8)   # ground-truth blue-ish box
TRUE_EMIT = 5.0                  # ground-truth light emission
START_ALBEDO = (0.5, 0.5, 0.5)
START_EMIT = 3.0


def camera(device="cpu"):
    """The script's camera (examples/inverse_render.py:632)."""
    return make_camera((0, 3, 9), (0, 1.5, 0), (0, 1, 0), 45.0, 1.0, 0.0,
                       9.0, device=device)


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


def param_tex_rows(scene: SceneTables):
    """(light_tex, box_tex) texture rows of the two trained groups:
    material 3 is the diffuse light, the box material is pushed last."""
    light_tex = int(scene.mat_texture[3])
    box_tex = int(scene.mat_texture[-1])
    return light_tex, box_tex


def with_params(scene: SceneTables, light_tex: int, box_tex: int,
                albedo: torch.Tensor, emit: torch.Tensor) -> SceneTables:
    """The scene with the box's texture row set to albedo and the light's to
    emit on all three channels; differentiable in albedo and emit."""
    tc = scene.tex_color
    row = torch.arange(tc.shape[0], device=tc.device)[:, None]
    tc = torch.where(row == box_tex, albedo[None, :], tc)
    tc = torch.where(row == light_tex, emit.expand(3)[None, :], tc)
    return dataclasses.replace(scene, tex_color=tc)


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
                      o, d, u, *, block: int, spp: int, max_depth: int, cfg):
    """mean((candidate block image − target block image)²), the target
    traced without gradient on the same rays and draws."""
    def img(s):
        rad = trace_fast(s, o, d, 0, max_depth=max_depth, cfg=cfg, u=u)
        return rad.reshape(block, spp, 3).sum(dim=1) / spp

    with torch.no_grad():
        target = img(target_scene)
    cand = img(with_params(scene, light_tex, box_tex, albedo, emit))
    return torch.mean((cand - target) ** 2)


def cosine_decay(total: int, alpha: float):
    """optax.cosine_decay_schedule(lr, total, alpha) as a LambdaLR factor."""
    def f(t):
        t = min(t, total)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / total)) + alpha
    return f


def train(*, steps: int = 40, nx: int = 200, ny: int = 200, spp: int = 64,
          block: int = 4096, max_depth: int = 6, device="cuda", seed: int = 0,
          log=print) -> dict:
    """Run the inverse render → dict(albedo, emit, losses, step_walls).

    seed picks the pixel blocks, rays and draws of every step
    (`step_inputs`); 0 is the default run.

    losses: the loss of every step, pulled to the host every 10 steps;
    step_walls: seconds per step of each chunk of up to 10 steps (the
    first includes the kernel build and warm-up)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but torch.cuda.is_available() "
                           "is false")
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
    # per-group lr: emission must travel ~2.0 while albedo travels ≤ 0.3;
    # the cosine decay damps the momentum overshoot once each arrives
    opt = torch.optim.Adam([{"params": [albedo], "lr": 0.05},
                            {"params": [emit], "lr": 0.25}])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps, 0.1))

    log(f"device: {device.type} "
        f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
        f"image {nx}x{ny}, spp {spp}/step, block {block} pixels, "
        f"depth {max_depth}, seed {seed}")
    log(f"target: albedo [{TRUE_ALBEDO[0]:.2f} {TRUE_ALBEDO[1]:.2f} "
        f"{TRUE_ALBEDO[2]:.2f}], emission {TRUE_EMIT:.2f}; start: albedo "
        f"[0.50 0.50 0.50], emission 3.00")
    log("differentiable tier: "
        + ("fused CUDA kernels K2/K3" if device.type == "cuda"
           else "plain torch twin"))

    kw = dict(nx=nx, ny=ny, spp=spp, block=block, max_depth=max_depth)
    losses, pending, walls = [], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        o, d, u = step_inputs(cam, i, device=device, seed=seed, **kw)
        opt.zero_grad(set_to_none=True)
        loss = path_matched_loss(target_scene, scene, light_tex, box_tex,
                                 albedo, emit, o, d, u, block=block, spp=spp,
                                 max_depth=max_depth, cfg=cfg)
        loss.backward()
        opt.step()
        sched.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
            emit.clamp_(0.0, 20.0)
        pending.append(loss.detach())
        if (i + 1) % 10 == 0 or i == steps - 1:
            # one host pull per chunk: it also waits for the chunk's work
            losses += torch.stack(pending).tolist()
            a = albedo.detach().cpu().numpy()
            wall = time.perf_counter() - t0
            walls.append(wall / len(pending))
            log(f"step {i:3d}  loss {losses[-1]:.5f}  "
                f"albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}]  "
                f"emit {emit.item():.3f}  "
                f"({wall:.2f}s chunk of {len(pending)})")
            pending = []
            t0 = time.perf_counter()
    return dict(albedo=albedo.detach().cpu().numpy(), emit=emit.item(),
                losses=losses, step_walls=walls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.inverse_render",
        description="recover the box albedo and the light emission by "
                    "gradient descent through the fused kernels")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--steps", type=int, default=40)
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
    res = train(steps=args.steps, nx=args.nx, ny=args.ny, spp=args.spp,
                block=args.block, device=args.device, seed=args.seed)
    a, e = res["albedo"], res["emit"]
    err_a = float(np.abs(a - np.asarray(TRUE_ALBEDO)).max())
    err_e = abs(e - TRUE_EMIT)
    walls = res["step_walls"]
    if len(walls) > 1:
        # median over the chunks after the first (build and warm-up)
        steady = float(np.median(walls[1:]))
        tag = "median steady chunk"
    else:
        steady = walls[0]
        tag = "avg incl. build and warm-up (single chunk)"
    rays = args.block * args.spp
    print(f"recovered albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}] "
          f"(max abs err {err_a:.3f}), emission {e:.3f} (err {err_e:.3f})")
    print(f"step time: {steady:.4f}s {tag} ({rays / 1e6:.2f}M target + "
          f"{rays / 1e6:.2f}M candidate sample-paths/step fwd+bwd, depth 6)")
    return 0 if (err_a < 0.1 and err_e < 0.5) else 1


if __name__ == "__main__":
    sys.exit(main())
