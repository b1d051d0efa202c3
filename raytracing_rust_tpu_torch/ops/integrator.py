"""Wavefront path-tracing integrator, forward (the general tier).

Counterpart of `raytracing_rust_tpu/ops/integrator.py`. The reference
integrator is a scalar recursion up to depth 50 (`color(ray, world, depth)`,
reference src/color.rs:6-23):

    hit  → emitted + attenuation ⊙ color(scattered, depth+1)   [depth < 50]
    miss → background (black; the book-1 sky gradient, src/color.rs:18-20,
           is a per-scene option)

Here a batch of N rays carries (origin, direction, throughput, radiance,
alive) through a bounce loop in torch ops that stops when no lane is alive.
Medium events compete with surface hits as the reference's HittableList
scan makes them (the closest wins; src/hittable.rs:37-47, medium.rs:28-56).

Draws are a tensor at the boundary: `_bounce` takes one bounce's uniforms
as u_all[n, m] in the JAX package's column layout (`_U_*`: the sphere
sample 0:3, the dielectric's branch 3, one column per medium from 4, the
roulette last), so a test can feed it JAX's own `_lane_draws`. A render
fills those columns from Philox (`lane_draws`) keyed by each lane's
(pixel, sample) and the bounce, in the kernel's slots (`ops/rng.py`): a
path keeps its stream wherever compaction moves it.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..models.scene import BG_SKY, SceneTables
from . import rng
from .intersect import (BIG, PlannedPack, _dot, closest_hit,
                        hit_attributes, media_scatter, plan_pack)
from .materials import emitted as mat_emitted
from .materials import scatter as mat_scatter
from .textures import eval_texture

# column layout of a bounce's draws (the JAX package's `_lane_draws`)
_U_SPHERE = slice(0, 3)   # scatter direction (3 uniforms)
_U_BRANCH = 3             # dielectric reflect/refract branch
_U_MEDIUM = 4             # media free-flight draws start here (num_media)
# Russian roulette, when on, is the final column

T_MIN = 1e-3  # ray epsilon, reference src/color.rs:7


def background(scene: SceneTables, d: torch.Tensor) -> torch.Tensor:
    """Miss radiance: the book-1 sky gradient (BG_SKY, the reference's
    commented-out src/color.rs:18-20) or black (its live behaviour)."""
    if scene.background == BG_SKY:
        unit = d / rng.sqrt_rn(_dot(d, d))[:, None]
        t = 0.5 * (unit[:, 1] + 1.0)
        white = torch.tensor([1.0, 1.0, 1.0], dtype=d.dtype, device=d.device)
        blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
        return (1.0 - t)[:, None] * white + t[:, None] * blue
    return torch.zeros_like(d)


def lane_draws(scene: SceneTables, seed: int, pix, smp, b: int,
               rr: bool) -> torch.Tensor:
    """One bounce's uniforms from Philox → f32[n, 4 + media + roulette]:
    SCATTER words
    0-3 (counter (pixel, sample, b, SCATTER)) in the sphere and branch
    columns, medium i's word of its MEDIUM slot (`rng.medium_slot`) in
    column 4 + i, ROULETTE word 0 last under roulette: the kernel's slots,
    every stream in one Philox pass (`rng.draws_many`)."""
    media = [rng.medium_slot(i) for i in range(scene.num_media)
             if scene.has_media]
    streams = [rng.STREAM_SCATTER] + sorted({s for s, _ in media})
    if rr:
        streams.append(rng.STREAM_ROULETTE)
    words = rng.draws_many(seed, pix, smp, b, streams)
    row = {s: k for k, s in enumerate(streams)}
    cols = [words[w][0] for w in range(4)]
    cols += [words[w][row[s]] for s, w in media]
    if rr:
        cols.append(words[0][row[rng.STREAM_ROULETTE]])
    return torch.stack(cols, dim=1)


def _bounce(scene: SceneTables, pack: PlannedPack, u_all: torch.Tensor,
            max_depth: int, b: int, o, d, time, thr, rad, alive,
            rr_depth: int | None = None, bvh=None):
    """One wavefront bounce → updated (o, d, thr, rad, alive): closest hit,
    the media race, emission, the background of a miss, scatter below the
    depth cap, Russian roulette from rr_depth on. u_all: this bounce's
    uniforms [n, 4 + media + roulette] (`lane_draws`' columns); bvh: the
    scene's `FlatBVH` on the rays' device, to find the closest hit by its
    traversal (`accel/bvh.bvh_closest_hit`), or None for the dense scan."""
    if bvh is not None:
        from ..accel.bvh import bvh_closest_hit
        hit = bvh_closest_hit(scene, bvh, o, d, time, T_MIN, pack=pack)
    else:
        hit = closest_hit(scene, o, d, time, T_MIN, pack=pack)

    t_ev = hit.t
    if scene.has_media:
        u_med = u_all[:, _U_MEDIUM:_U_MEDIUM + scene.num_media]
        t_med, med_mat = media_scatter(scene, o, d, T_MIN, hit.t, u_med)
        med_event = t_med < hit.t
        t_ev = torch.where(med_event, t_med, hit.t)

    hit_any = t_ev < BIG

    p, normal, u, v, mat_id = hit_attributes(scene, o, d, time, hit,
                                             pack=pack)
    if scene.has_media:
        p = torch.where(med_event[:, None], o + t_med[:, None] * d, p)
        # a medium hit's arbitrary attributes (reference src/medium.rs:44-50)
        normal = torch.where(
            med_event[:, None],
            torch.tensor([1.0, 0.0, 0.0], dtype=o.dtype, device=o.device),
            normal)
        u = torch.where(med_event, 0.0, u)
        v = torch.where(med_event, 0.0, v)
        mat_id = torch.where(med_event, med_mat, mat_id)

    # the texture of each lane's material, once for emission and albedo
    tex = eval_texture(scene, scene.mat_texture[mat_id], u, v, p,
                       checker=pack.checker)

    # emitted light on every hit (reference src/color.rs:8-15)
    e = mat_emitted(scene, mat_id, u, v, p, albedo=tex)
    rad = rad + torch.where((alive & hit_any)[:, None], thr * e,
                            torch.zeros_like(e))

    # a miss collects the background and dies (src/color.rs:16-22)
    bg = background(scene, d)
    rad = rad + torch.where((alive & ~hit_any)[:, None], thr * bg,
                            torch.zeros_like(bg))

    new_d, att, ok = mat_scatter(scene, d, p, normal, u, v, mat_id,
                                 u_all[:, _U_SPHERE], u_all[:, _U_BRANCH],
                                 albedo=tex, mats=pack.mats)

    # scatter only below the depth cap (src/color.rs:9 `depth < 50`)
    cont = alive & hit_any & ok & (b < max_depth)
    thr = torch.where(cont[:, None], thr * att, thr)

    if rr_depth is not None:
        # Russian roulette (not in the reference; opt-in, unbiased): from
        # bounce rr_depth on a path survives with q = max channel of its
        # throughput, clipped to [0.05, 1], and a survivor's throughput is
        # divided by q
        u_rr = u_all[:, -1]
        # detached, as JAX stops its gradient: the survival decision is a
        # discrete choice like the hit's, and a gradient through q(θ)
        # would leave an uncancelled −f·q′/q term
        q = torch.clamp(torch.amax(thr, dim=-1), 0.05, 1.0).detach()
        roulette = b >= rr_depth
        survive = (u_rr < q) | (not roulette)
        thr = torch.where((cont & roulette & survive)[:, None],
                          thr / q[:, None], thr)
        cont = cont & survive

    o = torch.where(cont[:, None], p, o)
    d = torch.where(cont[:, None], new_d, d)
    return o, d, thr, rad, cont


def _check_draws(scene: SceneTables, u: torch.Tensor, n: int, rr: bool,
                 n_bounce: int) -> None:
    """Raise unless u holds the draws of n_bounce bounces of n lanes in
    `_bounce`'s column layout f32[≥ n_bounce, n, m] (m = 4 + media +
    roulette) or, for a media-free scene without roulette (m = 4), in the
    fused tier's f32[≥ n_bounce, 4, n] (`grad.fast_draws`); a shape that
    is both (n = m = 4) is read as the column layout."""
    m = 4 + (scene.num_media if scene.has_media else 0) + int(rr)
    if u.dim() == 3 and u.shape[0] < n_bounce:
        raise ValueError(f"draws for {u.shape[0]} bounces, the trace runs "
                         f"{n_bounce}")
    if u.dim() == 3 and (u.shape[1:] == (n, m)
                         or (m == 4 and u.shape[1:] == (4, n))):
        return
    raise ValueError(f"draws of shape {tuple(u.shape)}: want [n_bounce, {n}, "
                     f"{m}]" + (f" or [n_bounce, 4, {n}]" if m == 4 else ""))


def _bounce_draws(u: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """Bounce b's columns [n, m] of a `_check_draws`-checked u."""
    ub = u[b]
    return ub if ub.shape[0] == n else ub.T


def run_bounces(scene: SceneTables, pack: PlannedPack, seed: int, pix, smp,
                max_depth: int, b0: int, b_end: int, o, d, time, thr, rad,
                alive, rr_depth: int | None = None, u=None,
                differentiable: bool = False, bvh=None):
    """Bounces b0 ≤ b < b_end, stopping when no lane is alive → (o, d, thr,
    rad, alive). pix, smp: each lane's pixel and global sample, the keys of
    its draws (`lane_draws`), so a compacted batch draws what the full
    one would; u, differentiable, bvh: as in `trace`."""
    n = o.shape[0]
    state = (o, d, thr, rad, alive)
    for b in range(b0, b_end):
        if not bool(state[4].any()):
            break

        def bounce(*st, b=b):
            u_all = (lane_draws(scene, seed, pix, smp, b, rr_depth is not None)
                     if u is None else _bounce_draws(u, b, n))
            return _bounce(scene, pack, u_all, max_depth, b, st[0], st[1],
                           time, *st[2:], rr_depth, bvh)

        if differentiable:
            state = torch.utils.checkpoint.checkpoint(
                bounce, *state, use_reentrant=False,
                preserve_rng_state=False)
        else:
            state = bounce(*state)
    return state


def trace(scene: SceneTables, o, d, time, seed: int, pix, smp,
          max_depth: int = 50, rr_depth: int | None = None,
          pack: PlannedPack | None = None, differentiable: bool = False,
          u: torch.Tensor | None = None, bvh=None) -> torch.Tensor:
    """Trace a batch of rays to completion at full width (no compaction)
    → radiance [N, 3]. o, d, time: the rays (directions unnormalized, the
    reference convention); seed, pix, smp: the draws' key and each lane's
    (pixel, sample); rr_depth: the bounce Russian roulette starts at, or
    None (the reference always runs to the cap); pack: the scene's
    `plan_pack`, when the caller holds it.

    differentiable: run each bounce under `torch.utils.checkpoint` (the
    JAX package's `jax.checkpoint(body)`): autograd keeps a bounce's inputs
    and replays the bounce in the backward pass, O(1) residual memory a
    bounce; the replay draws what the forward drew, since the draws are a
    function of (seed, pixel, sample, bounce) or of u. The radiance is the
    same bit for bit either way. u: the draws as a tensor in place of
    `lane_draws` (then seed, pix and smp are not read), at least
    max_depth + 1 bounces of them in a layout `_check_draws` takes, so a
    test can feed the tier JAX's `_lane_draws` or the fused tier's
    `fast_draws`; no gradient flows into them. bvh: the scene's `FlatBVH`
    on the rays' device: each closest hit by its traversal, which is
    forward only (as in JAX, whose traversal is a `lax.while_loop`), so it
    raises under differentiable."""
    if bvh is not None and differentiable:
        raise ValueError("the BVH traversal is forward only: trace with "
                         "differentiable=True takes no bvh")
    if u is not None:
        _check_draws(scene, u, o.shape[0], rr_depth is not None,
                     max_depth + 1)
        u = u.detach()
    thr = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    _, _, _, rad, _ = run_bounces(scene, pack or plan_pack(scene), seed, pix,
                                  smp, max_depth, 0, max_depth + 1, o, d,
                                  time, thr, rad, alive, rr_depth, u,
                                  differentiable, bvh)
    return rad
