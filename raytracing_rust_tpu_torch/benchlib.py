"""Benchmark metrics of the port.

Counterpart of `raytracing_rust_tpu/benchlib.py`; so far its gradient
health metric alone, `grad_fd_err`: the general tier's autograd against
central differences of the same fixed-draw estimator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but "
                           "torch.cuda.is_available() is false")
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
