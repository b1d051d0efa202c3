"""Batched material shading over the tagged material tables (the general
tier).

Counterpart of `raytracing_rust_tpu/ops/materials.py`. The reference
dispatches `&dyn Material::scatter/emitted` per hit (reference
src/material.rs:30-33); each lane here computes the branch of every
material tag the scene holds and selects by its own tag. The math is the
reference's, quirks included:

* lambertian target = p + n + a ball sample (src/material.rs:49-53);
* metal reflects the normalized incoming direction, fuzz perturbs it, and
  the path ends when the result leaves the hemisphere (src/material.rs:
  76-87);
* the dielectric keeps the book's exit cosine `ref_idx·d·n/|d|`
  (src/material.rs:108-115), Schlick's reflectance (:25-28), and refracts
  the unnormalized d through a normalize inside refract() (:13-23);
* diffuse_light never scatters and emits its texture (src/material.rs:
  133-151);
* isotropic scatters uniformly in the ball (src/material.rs:153-173).
"""

from __future__ import annotations

import torch

from ..models.scene import (MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_LAMBERTIAN,
                            MAT_METAL, SceneTables)
from . import rng
from .intersect import _dot
from .rng import sqrt_rn
from .textures import eval_texture


def _norm(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(_dot(v, v))


def _reflect(v, n):
    """reference src/material.rs:9-11"""
    return v - 2.0 * _dot(v, n)[..., None] * n


def _refract(v, n, ni_over_nt):
    """reference src/material.rs:13-23 → (refracted dir, possible mask).
    The square root takes 1 where refraction is impossible (the
    double-where that keeps a gradient finite there)."""
    uv = v / _norm(v)[..., None]
    dt = _dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    refracted = (ni_over_nt[..., None] * (uv - n * dt[..., None])
                 - n * sqrt_rn(torch.where(ok, disc, 1.0))[..., None])
    return refracted, ok


def _schlick(cosine, ref_idx):
    """reference src/material.rs:25-28; the powers as the JAX package's
    integer powers multiply: r0 = x·x, (1 − cos)⁵ = c·((c·c)·(c·c))."""
    x = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = x * x
    c = 1.0 - cosine
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))


def emitted(scene: SceneTables, mat_id, u, v, p, albedo=None) -> torch.Tensor:
    """Per-lane emission (reference src/material.rs:148-150; zeros
    elsewhere). albedo: the lanes' texture values when the caller already
    evaluated them (`eval_texture` of their material's texture)."""
    mat_id = mat_id.long()
    mtype = scene.mat_type[mat_id]
    e = (eval_texture(scene, scene.mat_texture[mat_id], u, v, p)
         if albedo is None else albedo)
    return torch.where((mtype == MAT_DIFFUSE_LIGHT)[:, None], e,
                       torch.zeros_like(e))


def scatter(scene: SceneTables, d_in, p, normal, u, v, mat_id, u_sphere,
            u_branch, albedo=None, mats=None):
    """Batched Material::scatter.

    d_in[N,3] incoming (unnormalized) directions; u_sphere[N,3], u_branch[N]
    uniforms. Returns (new_dir[N,3], attenuation[N,3], ok[N]). New rays
    keep origin p and the parent ray's time (reference src/material.rs:50).
    albedo: as in `emitted`. mats: the material tags the scene's lanes can
    hold, or None; a branch of a tag outside it is not evaluated (no lane
    would select it).
    """
    def has(tag):
        return mats is None or tag in mats

    mat_id = mat_id.long()
    mtype = scene.mat_type[mat_id]
    param = scene.mat_param[mat_id]
    if albedo is None:
        albedo = eval_texture(scene, scene.mat_texture[mat_id], u, v, p)
    sphere_sample = rng.in_unit_sphere(u_sphere)

    # isotropic: a uniform ball direction (src/material.rs:164-168); each
    # other tag's direction where its lanes are
    new_dir = sphere_sample
    attenuation = albedo
    ok = mtype != MAT_DIFFUSE_LIGHT

    if has(MAT_DIELECTRIC):
        # dielectric (src/material.rs:105-126); other rows take ref_idx 1,
        # so no masked-out branch divides by their param 0
        is_diel = mtype == MAT_DIELECTRIC
        ref_idx = torch.where(is_diel, param, 1.0)
        d_dot_n = _dot(d_in, normal)
        d_len = _norm(d_in)
        exiting = d_dot_n > 0.0
        outward_n = torch.where(exiting[:, None], -normal, normal)
        ni_over_nt = torch.where(exiting, ref_idx, 1.0 / ref_idx)
        cosine = torch.where(exiting, ref_idx * d_dot_n / d_len,
                             -d_dot_n / d_len)
        refracted, can_refract = _refract(d_in, outward_n, ni_over_nt)
        reflect_prob = torch.where(can_refract, _schlick(cosine, ref_idx),
                                   1.0)
        take_refract = can_refract & (u_branch >= reflect_prob)
        d_diel = torch.where(take_refract[:, None], refracted,
                             _reflect(d_in, normal))
        new_dir = torch.where(is_diel[:, None], d_diel, new_dir)
        attenuation = torch.where(is_diel[:, None], torch.ones_like(albedo),
                                  albedo)

    if has(MAT_METAL):
        # metal (src/material.rs:76-87)
        is_metal = mtype == MAT_METAL
        d_unit = d_in / _norm(d_in)[:, None]
        refl = _reflect(d_unit, normal)
        refl = refl + param[:, None] * sphere_sample  # fuzz (0 ⇒ unchanged)
        metal_ok = _dot(refl, normal) > 0.0
        new_dir = torch.where(is_metal[:, None], refl, new_dir)
        ok = torch.where(is_metal, metal_ok, ok)

    if has(MAT_LAMBERTIAN):
        # lambertian: dir = n + unit-ball sample (src/material.rs:49-53)
        new_dir = torch.where((mtype == MAT_LAMBERTIAN)[:, None],
                              normal + sphere_sample, new_dir)
    return new_dir, attenuation, ok
