"""The fused differentiable tier: kernels K2 (forward) and K3 (backward).

Counterpart of `raytracing_rust_tpu/ops/pallas_grad.py`, with its whole
scope (`supports_fast_grad`): spheres and rects (rotated and translated
instances included: the math runs on the world-space frames of
`ops/intersect.pack_prims`), lambertian, metal, dielectric and
diffuse-light materials, solid and 3D-checker textures (an emissive checker
included), the black background and the sky; at most MAX_PRIMS prims and
MAX_DEPTH bounces (`check_kernel_scope`).

* `fast_grad_record` flattens the scene into the f32[P, REC_C] record with
  differentiable torch ops, so gradients from d_record chain back into
  `prim_data`, `tex_color`, `xf_offset`, `xf_sin` and `xf_cos`.
* `trace_tiles_plain` is the plain version of both kernels: the whole
  multi-bounce trace of `_trace_tiles` in torch, op for op in the JAX
  order, on flat [N] lanes. Torch autograd through it is the gradient
  K3 is held against.
* `grad_fwd` / `grad_bwd` wrap the CUDA kernels of `csrc/grad.cu`: on CUDA
  tensors they launch K2 / K3, on CPU tensors they run the plain version
  (K3's plain version is autograd through `trace_tiles_plain`).
* `trace_fast` is the differentiable entry point (`TraceFast`, the
  `torch.autograd.Function` in place of the JAX `custom_vjp`).

Draws are an input tensor u f32[n_bounce, 4, N] (`fast_draws`: Philox
stream `rng.STREAM_GRAD`, keyed by (seed, lane, bounce)); no gradient flows
into them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.scene import (BG_SKY, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT,
                            MAT_LAMBERTIAN, MAT_METAL, PRIM_MOVING_SPHERE,
                            PRIM_RECT, TEX_CHECKER, TEX_SOLID, SceneTables)
from . import rng
from .intersect import pack_prims
from .tracer import BIG, T_MIN, UnsupportedScene

# record columns (f32[P, REC_C]), the JAX package's
C_IS_SPHERE = 0
C_CX, C_CY, C_CZ = 1, 2, 3
C_R2 = 4
C_INVR = 5
C_KN = 6    # 6..8  rect plane normal (world frame)
C_AN = 9    # 9..11
C_BN = 12   # 12..14
C_KOFF = 15
C_AOFF = 16
C_BOFF = 17
C_A0, C_A1, C_B0, C_B1 = 18, 19, 20, 21
C_FLIP = 22
C_LAMB, C_METAL, C_DIEL, C_LIGHT = 23, 24, 25, 26
C_PARAM = 27
C_TEX_E = 28  # 28..30 texture EVEN color (the solid color for solids)
C_TEX_O = 31  # 31..33 texture ODD color (checker only)
C_CHK = 34    # 1.0 ⇒ 3D-checker texture
REC_C = 35

MAX_PRIMS = 64    # csrc/grad.cu sizes its shared-memory record for this many
MAX_DEPTH = 16    # csrc/grad.cu sizes K3's per-lane state for MAX_DEPTH + 1

# the families K2/K3 cover beyond lambertian + solid (the free default):
# every family of fast_grad_config
KERNEL_FEATS = frozenset({"light", "sky", "metal", "diel", "checker"})

# lanes per CUDA block (csrc/grad.cu THREADS)
GRAD_THREADS = 128

# the winner tape's code (csrc/grad.cu TAPE_*): winner << TAPE_SHIFT | the
# bits, -1 on a miss; TAPE_NONE on an entry no bounce wrote
TAPE_FAR, TAPE_ODD, TAPE_METAL_OK, TAPE_REFRACT = 1, 2, 4, 8
TAPE_SHIFT = 4
TAPE_NONE = -2

# launches of the CUDA kernels, counted by grad_fwd / grad_bwd where they
# launch
K2_LAUNCHES = 0
K3_LAUNCHES = 0


def supports_fast_grad(scene: SceneTables, max_depth: int,
                       rr_depth=None) -> bool:
    """The JAX package's static gate for the fused tier's feature scope
    (pallas_grad.supports_fast_grad), which K2/K3 cover whole."""
    if rr_depth is not None or max_depth > MAX_DEPTH:
        return False
    if scene.has_media or scene.num_prims > MAX_PRIMS:
        return False
    ptype = scene.prim_type.cpu().numpy()
    if (ptype == PRIM_MOVING_SPHERE).any():
        return False
    prim_mat = scene.prim_material.cpu().numpy()
    mtypes = scene.mat_type.cpu().numpy()[prim_mat]
    if not np.isin(mtypes, [MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC,
                            MAT_DIFFUSE_LIGHT]).all():
        return False
    texs = scene.mat_texture.cpu().numpy()[prim_mat]
    ttypes = scene.tex_type.cpu().numpy()
    child = scene.tex_child.cpu().numpy()
    for t in texs:
        if ttypes[t] == TEX_SOLID:
            continue
        if ttypes[t] == TEX_CHECKER:
            c0, c1 = child[t]
            if ttypes[c0] == TEX_SOLID and ttypes[c1] == TEX_SOLID:
                continue
        return False
    return True


def fast_grad_config(scene: SceneTables):
    """(kinds, feats): per-prim "s"/"r", and the families present among
    the USED materials and textures ("metal", "diel", "light", "sky",
    "checker"). Reads the tables on the host: compute it once and pass it
    to `trace_fast(cfg=...)` where the tables live on the card."""
    ptype = scene.prim_type.cpu().numpy()
    kinds = tuple("r" if t == PRIM_RECT else "s" for t in ptype)
    prim_mat = scene.prim_material.cpu().numpy()
    mtypes = scene.mat_type.cpu().numpy()[prim_mat]
    feats = set()
    if (mtypes == MAT_METAL).any():
        feats.add("metal")
    if (mtypes == MAT_DIELECTRIC).any():
        feats.add("diel")
    if (mtypes == MAT_DIFFUSE_LIGHT).any():
        feats.add("light")
    if scene.background == BG_SKY:
        feats.add("sky")
    texs = scene.mat_texture.cpu().numpy()[prim_mat]
    if (scene.tex_type.cpu().numpy()[texs] == TEX_CHECKER).any():
        feats.add("checker")
    return kinds, frozenset(feats)


def check_kernel_scope(cfg) -> None:
    """Raise UnsupportedScene for a config outside K2/K3: a family that
    fast_grad_config does not name, no prim or more than MAX_PRIMS."""
    kinds, feats = cfg
    extra = set(feats) - KERNEL_FEATS
    if extra:
        raise UnsupportedScene(
            f"{', '.join(sorted(extra))} not in the fused kernels yet")
    if not 0 < len(kinds) <= MAX_PRIMS:
        raise UnsupportedScene(
            f"{len(kinds)} prims, the fused kernels take 1..{MAX_PRIMS}")


def fast_grad_record(scene: SceneTables) -> torch.Tensor:
    """SceneTables → f32[P, REC_C], the columns of the JAX
    `fast_grad_record`, built with differentiable non-in-place torch ops."""
    pack = pack_prims(scene)
    f32 = torch.float32
    dev = scene.prim_data.device
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    radius = pack.radius
    invr = torch.where(pack.is_sphere,
                       one / torch.where(radius == 0.0, one, radius), zero)
    mat = scene.prim_material.long()
    mtype = scene.mat_type[mat]
    tex = scene.mat_texture[mat].long()
    is_chk = scene.tex_type[tex] == TEX_CHECKER
    # checker: tex_child[t] = (odd, even); for solids both slots carry the
    # solid color
    child = scene.tex_child.long()
    even = scene.tex_color[torch.where(is_chk, child[tex, 1], tex)]
    odd = scene.tex_color[torch.where(is_chk, child[tex, 0], tex)]
    cols = [
        pack.is_sphere.to(f32),
        pack.c0[:, 0], pack.c0[:, 1], pack.c0[:, 2],
        pack.r2, invr,
        pack.kn[:, 0], pack.kn[:, 1], pack.kn[:, 2],
        pack.an[:, 0], pack.an[:, 1], pack.an[:, 2],
        pack.bn[:, 0], pack.bn[:, 1], pack.bn[:, 2],
        pack.k_off, pack.a_off, pack.b_off,
        pack.a0, pack.a1, pack.b0, pack.b1,
        scene.prim_flip.to(f32),
        (mtype == MAT_LAMBERTIAN).to(f32), (mtype == MAT_METAL).to(f32),
        (mtype == MAT_DIELECTRIC).to(f32),
        (mtype == MAT_DIFFUSE_LIGHT).to(f32),
        scene.mat_param[mat],
        even[:, 0], even[:, 1], even[:, 2],
        odd[:, 0], odd[:, 1], odd[:, 2],
        is_chk.to(f32),
    ]
    assert len(cols) == REC_C
    return torch.stack(cols, dim=1)


def fast_draws(seed: int, n_lanes: int, n_bounce: int,
               device="cpu") -> torch.Tensor:
    """The trace's U[0,1) draws f32[n_bounce, 4, N]: Philox counter
    (lane, 0, bounce, STREAM_GRAD) under key `seed` (ops/rng.py)."""
    lane = torch.arange(n_lanes, dtype=torch.int64, device=device)
    bounce = torch.arange(n_bounce, dtype=torch.int64, device=device)
    return torch.stack(rng.draws(seed, lane[None, :], 0, bounce[:, None],
                                 rng.STREAM_GRAD), dim=1)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def trace_tiles_plain(rec: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                      u: torch.Tensor, cfg, max_depth: int,
                      counts: dict | None = None, tape: bool = False):
    """The whole multi-bounce trace in plain torch → radiance f32[N, 3],
    or with tape (rad, the winner tape i32[n_bounce, 2, N]: `TAPE_*`).

    rec f32[P, REC_C]; o, d f32[N, 3]; u f32[n_bounce, 4, N]; cfg the
    (kinds, feats) of `fast_grad_config`. A torch twin of the JAX
    `_trace_tiles`, op for op in its order, with its constants; every
    division has a tensor divisor (torch's CUDA division by a Python scalar
    multiplies by a reciprocal), and the integer powers of Schlick are the
    multiplies `lax.integer_pow` makes (torch's CUDA pow calls powf).
    Differentiable in rec, o and d. counts, when given, gathers the lane
    bounces a path was alive at ("segments"): the bounces K2 runs before a
    lane's loop ends, the tape's ghost entries after them ("ghosts"), and
    of those bounces the ones that missed ("misses"), that a
    sphere won ("sphere_hits"), that a checker won ("checker_hits"), that
    scattered ("scatters"), off a metal ("metal_scatters") or off glass
    ("glass_scatters"), of those the ones that could refract ("u3_reads")
    and that refracted ("refracts"), and that a metal absorbed
    ("metal_absorbs"). K2 reads draw words 0-2 on the scatters but glass's
    and on the absorptions, and word 3 on the u3_reads.

    The tape holds, for each bounce K2 runs and for the ghost bounce after
    a path dies (the dying ray traced once more: the same winner and t,
    with no scatter bits), the winner code in row 0 (winner << TAPE_SHIFT
    | the TAPE_* bits K2's bounce set, -1 on a miss) and t_best's bits in
    row 1; the other entries are TAPE_NONE and 0, and K2 leaves them
    unwritten."""
    check_kernel_scope(cfg)
    kinds, feats = cfg
    if rec.shape[0] != len(kinds):
        raise ValueError(f"rec has {rec.shape[0]} rows, cfg {len(kinds)} prims")
    any_s = "s" in kinds
    any_r = "r" in kinds
    has_light = "light" in feats
    has_sky = "sky" in feats
    has_metal = "metal" in feats
    has_diel = "diel" in feats
    has_checker = "checker" in feats
    n_bounce = u.shape[0]
    scal = [row.unbind(0) for row in rec.unbind(0)]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    one = torch.ones((), dtype=torch.float32, device=o.device)
    zero = torch.zeros_like(ox)
    thr_r = thr_g = thr_b = torch.ones_like(ox)
    rad_r = rad_g = rad_b = zero
    alive = torch.ones_like(ox)
    if counts is not None:
        for k in ("scatters", "checker_hits", "metal_scatters",
                  "metal_absorbs", "glass_scatters", "u3_reads", "refracts",
                  "ghosts"):
            counts.setdefault(k, 0)
    rows = []          # the tape's [2, N] rows, one a bounce
    was_alive = None   # alive at the previous bounce's start

    def record(won, w_idx, w_far, odd, bits, t_best, alive0, b):
        valid = torch.full_like(won, b <= max_depth)
        if was_alive is not None:
            valid &= (alive0 != 0.0) | (was_alive != 0.0)
        code = (w_idx << TAPE_SHIFT) | w_far.long() * TAPE_FAR | bits
        if odd is not None:
            code |= odd.long() * TAPE_ODD
        code = torch.where(valid, torch.where(won, code, -1), TAPE_NONE)
        t = torch.where(valid, t_best, 0.0).detach().contiguous()
        rows.append(torch.stack([code.to(torch.int32),
                                 t.view(torch.int32)]))

    for b in range(n_bounce):
        u0, u1, u2, u3 = u[b].unbind(0)
        alive0 = alive
        if counts is not None:
            counts["segments"] = (counts.get("segments", 0)
                                  + int((alive != 0.0).sum()))

        # closest hit: first strict minimum over the prims; each kind
        # updates only the attributes it can win, each family only its own
        t_best = torch.full_like(ox, BIG)
        w_sph = zero if (any_s and any_r) else None
        w_cx = w_cy = w_cz = zero
        w_invr = zero
        w_knx = w_kny = w_knz = zero
        w_flip = torch.ones_like(ox)
        w_light_c = zero
        w_metal = w_diel = zero
        w_par = zero
        w_ter = w_teg = w_teb = zero
        w_tor = w_tog = w_tob = zero
        w_chk = zero

        a_dd = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = one / a_dd
        if tape:
            w_idx = torch.full(ox.shape, -1, dtype=torch.int64,
                               device=ox.device)
            w_far = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)

        for p, kind in enumerate(kinds):
            r = scal[p]
            if kind == "s":
                ocx = ox - r[C_CX]
                ocy = oy - r[C_CY]
                ocz = oz - r[C_CZ]
                bq = _dot3(ocx, ocy, ocz, dx, dy, dz)
                cc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r[C_R2]
                disc = bq * bq - a_dd * cc
                pos = disc > 0.0
                sq = torch.sqrt(torch.where(pos, disc, one))  # double-where
                t_near = (-bq - sq) * inv_a
                t_far = (-bq + sq) * inv_a
                near_ok = pos & (t_near > T_MIN) & (t_near < BIG)
                far_ok = pos & (t_far > T_MIN) & (t_far < BIG)
                t_p = torch.where(near_ok, t_near,
                                  torch.where(far_ok, t_far, BIG))
                far_p = far_ok & ~near_ok
            else:
                kx, ky, kz = r[C_KN], r[C_KN + 1], r[C_KN + 2]
                o_kn = _dot3(ox, oy, oz, kx, ky, kz)
                d_kn = _dot3(dx, dy, dz, kx, ky, kz)
                par_m = d_kn == 0.0
                t_r = (r[C_KOFF] - o_kn) / torch.where(par_m, one, d_kn)
                xx = (_dot3(ox, oy, oz, r[C_AN], r[C_AN + 1], r[C_AN + 2])
                      + t_r * _dot3(dx, dy, dz, r[C_AN], r[C_AN + 1],
                                    r[C_AN + 2]) - r[C_AOFF])
                yy = (_dot3(ox, oy, oz, r[C_BN], r[C_BN + 1], r[C_BN + 2])
                      + t_r * _dot3(dx, dy, dz, r[C_BN], r[C_BN + 1],
                                    r[C_BN + 2]) - r[C_BOFF])
                rect_ok = ((~par_m) & (t_r > T_MIN) & (t_r < BIG)
                           & (xx >= r[C_A0]) & (xx <= r[C_A1])
                           & (yy >= r[C_B0]) & (yy <= r[C_B1]))
                t_p = torch.where(rect_ok, t_r, BIG)
                far_p = False

            better = t_p < t_best
            t_best = torch.where(better, t_p, t_best)
            if tape:
                w_idx = torch.where(better, p, w_idx)
                w_far = torch.where(better, far_p, w_far)
            if w_sph is not None:
                w_sph = torch.where(better, r[C_IS_SPHERE], w_sph)
            if kind == "s":
                w_cx = torch.where(better, r[C_CX], w_cx)
                w_cy = torch.where(better, r[C_CY], w_cy)
                w_cz = torch.where(better, r[C_CZ], w_cz)
                w_invr = torch.where(better, r[C_INVR], w_invr)
            else:
                w_knx = torch.where(better, r[C_KN], w_knx)
                w_kny = torch.where(better, r[C_KN + 1], w_kny)
                w_knz = torch.where(better, r[C_KN + 2], w_knz)
            w_flip = torch.where(better, r[C_FLIP], w_flip)
            if has_light:
                w_light_c = torch.where(better, r[C_LIGHT], w_light_c)
            if has_metal or has_diel:
                w_par = torch.where(better, r[C_PARAM], w_par)
            if has_metal:
                w_metal = torch.where(better, r[C_METAL], w_metal)
            if has_diel:
                w_diel = torch.where(better, r[C_DIEL], w_diel)
            w_ter = torch.where(better, r[C_TEX_E], w_ter)
            w_teg = torch.where(better, r[C_TEX_E + 1], w_teg)
            w_teb = torch.where(better, r[C_TEX_E + 2], w_teb)
            if has_checker:
                w_tor = torch.where(better, r[C_TEX_O], w_tor)
                w_tog = torch.where(better, r[C_TEX_O + 1], w_tog)
                w_tob = torch.where(better, r[C_TEX_O + 2], w_tob)
                w_chk = torch.where(better, r[C_CHK], w_chk)

        hit = (t_best < BIG).to(torch.float32)
        if counts is not None:
            live = alive != 0.0
            won = t_best < BIG
            sph = (w_sph > 0.5) if w_sph is not None else torch.full_like(
                won, any_s)
            for k, m in (("misses", live & ~won),
                         ("sphere_hits", live & won & sph)):
                counts[k] = counts.get(k, 0) + int(m.sum())
        t_safe = torch.where(t_best < BIG, t_best, 0.0)
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz

        # normal (sphere: (p − c)/r; rect: kn) × flip
        if any_s and any_r:
            sphw = w_sph > 0.5
            nx = torch.where(sphw, (px - w_cx) * w_invr, w_knx) * w_flip
            ny = torch.where(sphw, (py - w_cy) * w_invr, w_kny) * w_flip
            nz = torch.where(sphw, (pz - w_cz) * w_invr, w_knz) * w_flip
        elif any_s:
            nx = (px - w_cx) * w_invr * w_flip
            ny = (py - w_cy) * w_invr * w_flip
            nz = (pz - w_cz) * w_invr * w_flip
        else:
            nx, ny, nz = w_knx * w_flip, w_kny * w_flip, w_knz * w_flip

        # the winner's texture: a checker picks its odd color where
        # sin(10x)·sin(10y)·sin(10z) < 0 (reference src/texture.rs:40-47)
        if has_checker:
            sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
                     * torch.sin(10.0 * pz))
            use_odd = (w_chk > 0.5) & (sines < 0.0)
            if counts is not None:
                counts["checker_hits"] += int(
                    ((alive != 0.0) & (t_best < BIG) & (w_chk > 0.5)).sum())
            w_alr = torch.where(use_odd, w_tor, w_ter)
            w_alg = torch.where(use_odd, w_tog, w_teg)
            w_alb = torch.where(use_odd, w_tob, w_teb)
        else:
            use_odd = None
            w_alr, w_alg, w_alb = w_ter, w_teg, w_teb
        won = t_best < BIG

        # emitted on every hit (reference src/color.rs:8-15): the light's
        # texture value
        gain = alive * hit
        if has_light:
            gl = gain * w_light_c
            rad_r = rad_r + gl * thr_r * w_alr
            rad_g = rad_g + gl * thr_g * w_alg
            rad_b = rad_b + gl * thr_b * w_alb

        # a miss adds the background and dies (src/color.rs:16-22); the
        # black background adds nothing. csrc/grad.cu takes rsqrtf, which
        # torch.rsqrt computes on the card
        if has_sky:
            miss = alive * (1.0 - hit)
            inv_len = torch.rsqrt(a_dd)
            tt = 0.5 * (dy * inv_len + 1.0)
            bgr = (1.0 - tt) + tt * 0.5
            bgg = (1.0 - tt) + tt * 0.7
            bgb = (1.0 - tt) + tt * 1.0
            rad_r = rad_r + miss * thr_r * bgr
            rad_g = rad_g + miss * thr_g * bgg
            rad_b = rad_b + miss * thr_b * bgb

        if b == max_depth:
            # the final bounce only collects (src/color.rs:9)
            if tape:
                record(won, w_idx, w_far, use_odd, 0, t_best, alive0, b)
                was_alive = alive0
            alive = torch.zeros_like(ox)
            continue

        # a point in the unit ball
        cos_t = 2.0 * u0 - 1.0
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = rng.TWO_PI * u1
        rr3 = torch.exp(torch.log(1.0 - u2) * rng.ONE_THIRD)
        ssx = rr3 * sin_t * torch.cos(phi)
        ssy = rr3 * sin_t * torch.sin(phi)
        ssz = rr3 * cos_t

        # lambertian: n + ball (src/material.rs:49-53)
        ndx, ndy, ndz = nx + ssx, ny + ssy, nz + ssz
        ok = torch.ones_like(ox)

        if has_metal or has_diel:
            inv_len = torch.rsqrt(a_dd)
            ux, uy, uz = dx * inv_len, dy * inv_len, dz * inv_len

        if has_metal:
            # metal: reflect(unit d) + fuzz · ball (src/material.rs:76-87)
            udn = _dot3(ux, uy, uz, nx, ny, nz)
            rfx = ux - 2.0 * udn * nx + w_par * ssx
            rfy = uy - 2.0 * udn * ny + w_par * ssy
            rfz = uz - 2.0 * udn * nz + w_par * ssz
            metal_ok = (_dot3(rfx, rfy, rfz, nx, ny, nz) > 0.0).to(
                torch.float32)
            is_metal = w_metal > 0.5
            ndx = torch.where(is_metal, rfx, ndx)
            ndy = torch.where(is_metal, rfy, ndy)
            ndz = torch.where(is_metal, rfz, ndz)
            ok = torch.where(is_metal, metal_ok, ok)

        if has_diel:
            # dielectric (src/material.rs:105-126) under the JAX
            # double-wheres (param-0 rows, total internal reflection)
            is_diel = w_diel > 0.5
            ref_idx = torch.where(is_diel, w_par, one)
            ddn = _dot3(dx, dy, dz, nx, ny, nz)
            d_len = torch.sqrt(a_dd)
            exiting = ddn > 0.0
            sgn = torch.where(exiting, -one, one)
            onx, ony, onz = sgn * nx, sgn * ny, sgn * nz
            ni_over_nt = torch.where(exiting, ref_idx, one / ref_idx)
            cosine = torch.where(exiting, ref_idx * ddn / d_len,
                                 -ddn / d_len)
            uvdt = _dot3(ux, uy, uz, onx, ony, onz)
            disc_r = 1.0 - ni_over_nt * ni_over_nt * (1.0 - uvdt * uvdt)
            can_refract = disc_r > 0.0
            sq_r = torch.sqrt(torch.where(can_refract, disc_r, one))
            refx = ni_over_nt * (ux - onx * uvdt) - onx * sq_r
            refy = ni_over_nt * (uy - ony * uvdt) - ony * sq_r
            refz = ni_over_nt * (uz - onz * uvdt) - onz * sq_r
            # Schlick; q**2 and one_mc**5 as lax.integer_pow multiplies
            q = (1.0 - ref_idx) / (1.0 + ref_idx)
            r0 = q * q
            one_mc = 1.0 - cosine
            x2 = one_mc * one_mc
            schlick = r0 + (1.0 - r0) * (one_mc * (x2 * x2))
            reflect_prob = torch.where(can_refract, schlick, one)
            take_refract = can_refract & (u3 >= reflect_prob)
            # the pure reflect of the unnormalised d
            prx = dx - 2.0 * ddn * nx
            pry = dy - 2.0 * ddn * ny
            prz = dz - 2.0 * ddn * nz
            ndx = torch.where(is_diel, torch.where(take_refract, refx, prx),
                              ndx)
            ndy = torch.where(is_diel, torch.where(take_refract, refy, pry),
                              ndy)
            ndz = torch.where(is_diel, torch.where(take_refract, refz, prz),
                              ndz)

        if has_light:
            ok = ok * (1.0 - w_light_c)  # a light never scatters

        if has_diel:  # glass attenuates by 1
            atr = torch.where(is_diel, one, w_alr)
            atg = torch.where(is_diel, one, w_alg)
            atb = torch.where(is_diel, one, w_alb)
        else:
            atr, atg, atb = w_alr, w_alg, w_alb

        cont = gain * ok
        keep = cont > 0.5
        if tape:
            # the bits K2's scatter sets: on a bounce that tried to scatter
            # (alive, a hit, not a light)
            tried = gain * ((1.0 - w_light_c) if has_light else 1.0) > 0.5
            bits = torch.zeros_like(w_idx)
            if has_metal:
                bits |= (tried & is_metal & (metal_ok > 0.5)).long() \
                    * TAPE_METAL_OK
            if has_diel:
                bits |= (tried & is_diel & take_refract).long() * TAPE_REFRACT
            record(won, w_idx, w_far, use_odd, bits, t_best, alive0, b)
            was_alive = alive0
        if counts is not None:
            counts["scatters"] += int(keep.sum())
            if has_metal:
                counts["metal_scatters"] += int((keep & is_metal).sum())
                counts["metal_absorbs"] += int(
                    ((gain > 0.5) & is_metal & ~keep).sum())
            if has_diel:
                glass = keep & is_diel
                counts["glass_scatters"] += int(glass.sum())
                counts["u3_reads"] += int((glass & can_refract).sum())
                counts["refracts"] += int((glass & take_refract).sum())
        thr_r = torch.where(keep, thr_r * atr, thr_r)
        thr_g = torch.where(keep, thr_g * atg, thr_g)
        thr_b = torch.where(keep, thr_b * atb, thr_b)
        ox = torch.where(keep, px, ox)
        oy = torch.where(keep, py, oy)
        oz = torch.where(keep, pz, oz)
        dx = torch.where(keep, ndx, dx)
        dy = torch.where(keep, ndy, dy)
        dz = torch.where(keep, ndz, dz)
        if counts is not None and b + 1 < n_bounce:
            counts["ghosts"] += int(((alive0 != 0.0) & (cont == 0.0)).sum())
        alive = cont

    rad = torch.stack([rad_r, rad_g, rad_b], dim=1)
    return (rad, torch.stack(rows)) if tape else rad


def trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, max_depth):
    """K3's plain version: (d_rec, d_o, d_d) of <ct, trace_tiles_plain> by
    torch autograd (zeros where the graph does not reach a leaf)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (rec, o, d)]
        rad = trace_tiles_plain(*leaves, u, cfg, max_depth)
        if not rad.requires_grad:  # no light, no sky: the radiance is 0
            return tuple(torch.zeros_like(x) for x in leaves)
        grads = torch.autograd.grad(rad, leaves, ct, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads))


def _check_operands(rec, o, d, u, max_depth, ct=None, tape=None):
    dev = rec.device
    n = o.shape[0]
    for name, x, shape, dtype in (
            ("rec", rec, (rec.shape[0], REC_C), torch.float32),
            ("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
            ("u", u, (u.shape[0], 4, n), torch.float32),
            ("ct", ct, (n, 3), torch.float32),
            ("tape", tape, (u.shape[0], 2, n), torch.int32)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rec on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != len(shape) or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
        if dev.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernels")
    if not 0 < rec.shape[0] <= MAX_PRIMS:
        raise ValueError(f"rec must have 1..{MAX_PRIMS} rows")
    if not 0 <= max_depth <= MAX_DEPTH or not 0 < u.shape[0] <= MAX_DEPTH + 1:
        raise ValueError(f"depth {max_depth} / {u.shape[0]} bounces outside "
                         f"the kernels' {MAX_DEPTH} / {MAX_DEPTH + 1}")
    if not 0 < n < 1 << 31:
        raise ValueError(f"{n} lanes")


def _feat_flags(cfg) -> tuple[int, ...]:
    """The kernels' launch-uniform family flags, in their argument order."""
    return tuple(int(k in cfg[1])
                 for k in ("light", "sky", "metal", "diel", "checker"))


# csrc/grad.cu: the reduction slots of a d_rec row (SLOTS) and the
# workspace's counters (WS_*): K2's two, K3's three, then one a set
SLOTS = 14
WS_K3_SET0 = 5
_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, n_ints: int):
    """The kernels' counters on `device` for launches on `stream`: zeroed
    once (grown when a launch needs more) and left at zero by every
    launch, so a call launches nothing but its kernel."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < n_ints:
        ws = torch.zeros(max(n_ints, 64), dtype=torch.int32, device=device)
        _WORKSPACES[key] = ws
    return ws


def k3_sets(n: int) -> tuple[int, int]:
    """(set_size, sets) of K3's d_rec reduction over ceil(n / 128) tiles:
    ceil(√tiles) tiles a set."""
    tiles = -(-n // GRAD_THREADS)
    size = math.isqrt(tiles - 1) + 1
    return size, -(-tiles // size)


def _k2(lib, stream, rec, o, d, u, cfg, max_depth: int, rad, tape):
    """K2 through `lib.rt_grad_fwd` on `stream` into rad and, unless None,
    tape; raises on a launch error."""
    ws = _workspace(rec.device, stream, WS_K3_SET0)
    err = lib.rt_grad_fwd(
        rec.data_ptr(), rec.shape[0], o.data_ptr(), d.data_ptr(),
        u.data_ptr(), rad.data_ptr(), None if tape is None else tape.data_ptr(),
        o.shape[0], u.shape[0], max_depth, *_feat_flags(cfg), ws.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")


def _k3_part(rec, n: int) -> torch.Tensor:
    """K3's scratch: a d_rec row of P · SLOTS floats a tile, then a set."""
    return torch.empty((-(-n // GRAD_THREADS) + k3_sets(n)[1])
                       * rec.shape[0] * SLOTS, dtype=torch.float32,
                       device=rec.device)


def _k3(lib, stream, rec, o, d, u, ct, tape, cfg, max_depth: int, d_rec,
        d_o, d_d, part):
    """K3 through `lib.rt_grad_bwd` on `stream` into d_rec, d_o and d_d
    (part: `_k3_part`); raises on a launch error."""
    n = o.shape[0]
    set_size, sets = k3_sets(n)
    ws = _workspace(rec.device, stream, WS_K3_SET0 + sets)
    err = lib.rt_grad_bwd(
        rec.data_ptr(), rec.shape[0], o.data_ptr(), d.data_ptr(),
        u.data_ptr(), tape.data_ptr(), ct.data_ptr(), d_o.data_ptr(),
        d_d.data_ptr(), d_rec.data_ptr(), part.data_ptr(), n, u.shape[0],
        max_depth, *_feat_flags(cfg), ws.data_ptr(), set_size, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")


def _launch_fwd(lib, stream, rec, o, d, u, cfg, max_depth: int,
                tape: bool):
    """K2 on `stream` → rad f32[N, 3], and with tape the winner tape
    i32[n_bounce, 2, N]; raises on a launch error before K2_LAUNCHES
    moves."""
    global K2_LAUNCHES
    n = o.shape[0]
    rad = torch.empty((n, 3), dtype=torch.float32, device=rec.device)
    tp = (torch.empty((u.shape[0], 2, n), dtype=torch.int32,
                      device=rec.device) if tape else None)
    _k2(lib, stream, rec, o, d, u, cfg, max_depth, rad, tp)
    K2_LAUNCHES += 1
    return (rad, tp) if tape else rad


def _launch_bwd(lib, stream, rec, o, d, u, ct, tape, cfg, max_depth: int):
    """K3 on `stream` → (d_rec, d_o, d_d), d_rec reduced inside the
    launch; raises on a launch error before K3_LAUNCHES moves."""
    global K3_LAUNCHES
    d_o = torch.empty((o.shape[0], 3), dtype=torch.float32, device=rec.device)
    d_d = torch.empty_like(d_o)
    d_rec = torch.empty((rec.shape[0], REC_C), dtype=torch.float32,
                        device=rec.device)
    _k3(lib, stream, rec, o, d, u, ct, tape, cfg, max_depth, d_rec, d_o, d_d,
        _k3_part(rec, o.shape[0]))
    K3_LAUNCHES += 1
    return d_rec, d_o, d_d


def grad_fwd(rec, o, d, u, cfg, max_depth: int, tape: bool = False):
    """Wrapper of K2; same contract as `trace_tiles_plain` (not
    differentiable: `trace_fast` is): rad f32[N, 3], or with tape (rad,
    the winner tape that `grad_bwd` reads). On CUDA tensors (contiguous,
    as given) it launches `csrc/grad.cu` `rt_grad_fwd` on the current
    stream or raises; on CPU tensors it runs `trace_tiles_plain`."""
    check_kernel_scope(cfg)
    _check_operands(rec, o, d, u, max_depth)
    if rec.device.type == "cpu":
        with torch.no_grad():
            return trace_tiles_plain(rec, o, d, u, cfg, max_depth, tape=tape)
    if rec.device.type != "cuda":
        raise ValueError(f"no kernel for device {rec.device}")
    from ._build import load
    with torch.cuda.device(rec.device):
        return _launch_fwd(load(), torch.cuda.current_stream().cuda_stream,
                           rec, o, d, u, cfg, max_depth, tape)


def grad_bwd(rec, o, d, u, ct, cfg, max_depth: int, tape=None):
    """Wrapper of K3 → (d_rec f32[P, REC_C], d_o, d_d f32[N, 3]), the
    vector-Jacobian product of the trace with cotangent ct f32[N, 3]. On
    CUDA tensors it launches `rt_grad_bwd` on K2's winner tape of the same
    operands (`grad_fwd(..., tape=True)`), which it requires, and raises
    otherwise; on CPU tensors it runs `trace_tiles_plain_vjp` (the tape,
    if given, is checked and not needed)."""
    check_kernel_scope(cfg)
    _check_operands(rec, o, d, u, max_depth, ct, tape)
    if rec.device.type == "cpu":
        return trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, max_depth)
    if rec.device.type != "cuda":
        raise ValueError(f"no kernel for device {rec.device}")
    if tape is None:
        raise ValueError("K3 reads K2's winner tape: pass grad_fwd(..., "
                         "tape=True)'s")
    from ._build import load
    with torch.cuda.device(rec.device):
        return _launch_bwd(load(), torch.cuda.current_stream().cuda_stream,
                           rec, o, d, u, ct, tape, cfg, max_depth)


def bare_launches(rec, o, d, u, ct, cfg, max_depth: int):
    """(K2, K2 with its tape, K3): closures that launch the kernels on this
    call's outputs, allocated once here, with no check, no allocation and
    no launch count: what chip_smoke.py and kernel_ab time beside the
    wrappers. CUDA tensors as the wrappers take them; K2 with its tape runs
    once here, so K3 reads the tape of these operands."""
    from ._build import load
    lib = load()
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    n = o.shape[0]
    rad = torch.empty((n, 3), dtype=torch.float32, device=rec.device)
    tape = torch.empty((u.shape[0], 2, n), dtype=torch.int32,
                       device=rec.device)
    out = (torch.empty((rec.shape[0], REC_C), dtype=torch.float32,
                       device=rec.device), torch.empty_like(rad),
           torch.empty_like(rad), _k3_part(rec, n))

    def fwd(tp=None):
        _k2(lib, stream, rec, o, d, u, cfg, max_depth, rad, tp)

    fwd(tape)
    return (fwd, lambda: fwd(tape),
            lambda: _k3(lib, stream, rec, o, d, u, ct, tape, cfg, max_depth,
                        *out))


def kernel_occupancy(n_prims: int) -> dict:
    """Per instantiation of K2 and K3 on the current card (`grad_fwd<0>`
    ... `grad_bwd<1>`): registers, local bytes a thread (the stack frame),
    blocks resident an SM at a record of n_prims rows and the SMs, by
    `rt_grad_occupancy`."""
    import ctypes

    from ._build import load
    out = (ctypes.c_int * 16)()
    err = load().rt_grad_occupancy(n_prims, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    names = ("grad_fwd<0>", "grad_fwd<1>", "grad_bwd<0>", "grad_bwd<1>")
    return {name: dict(registers=out[4 * k], stack_bytes=out[4 * k + 1],
                       blocks_per_sm=out[4 * k + 2], sms=out[4 * k + 3])
            for k, name in enumerate(names)}


class TraceFast(torch.autograd.Function):
    """(rec, o, d, u) → radiance f32[N, 3]: K2 forward, K3 backward (the
    plain versions on the CPU). No gradient flows into u. `tape`: the
    forward keeps K2's winner tape for the backward; `trace_fast` asks for
    it where grad mode is on and rec, o or d requires grad."""

    @staticmethod
    def forward(ctx, rec, o, d, u, cfg, max_depth, tape):
        ctx.cfg, ctx.max_depth = cfg, max_depth
        if not tape:
            ctx.save_for_backward(rec, o, d, u)
            return grad_fwd(rec, o, d, u, cfg, max_depth)
        rad, tp = grad_fwd(rec, o, d, u, cfg, max_depth, tape=True)
        ctx.save_for_backward(rec, o, d, u, tp)
        return rad

    @staticmethod
    def backward(ctx, ct):
        rec, o, d, u, *tp = ctx.saved_tensors
        d_rec, d_o, d_d = grad_bwd(rec, o, d, u, ct.contiguous(), ctx.cfg,
                                   ctx.max_depth, tape=tp[0] if tp else None)
        return d_rec, d_o, d_d, None, None, None, None


def trace_fast(scene: SceneTables, o: torch.Tensor, d: torch.Tensor,
               seed: int, max_depth: int = 6, cfg=None,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable radiance f32[N, 3] of rays o, d f32[N, 3] through the
    fused kernels; gradients reach the scene's tables through
    `fast_grad_record`, and o and d.

    seed keys the draws (`fast_draws`) unless u f32[max_depth + 1, 4, N] is
    given. cfg: `fast_grad_config(scene)`, computed here when absent (that
    reads the tables on the host). Raises UnsupportedScene outside the
    kernels' scope, on every device; there is no fallback."""
    if cfg is None:
        if not supports_fast_grad(scene, max_depth):
            raise UnsupportedScene("scene outside the fused tier's scope")
        cfg = fast_grad_config(scene)
    check_kernel_scope(cfg)
    if max_depth > MAX_DEPTH:
        raise UnsupportedScene(f"depth {max_depth} > the fused kernels' "
                               f"{MAX_DEPTH}")
    n_bounce = max_depth + 1
    if u is None:
        u = fast_draws(seed, o.shape[0], n_bounce, o.device)
    rec = fast_grad_record(scene)
    tape = torch.is_grad_enabled() and (rec.requires_grad or o.requires_grad
                                        or d.requires_grad)
    return TraceFast.apply(rec, o, d, u.detach(), cfg, max_depth, tape)
