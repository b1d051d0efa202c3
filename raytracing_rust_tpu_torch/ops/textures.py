"""Batched texture evaluation over the tagged texture tables (the general
tier).

Counterpart of `raytracing_rust_tpu/ops/textures.py`. The reference
dispatches `dyn Texture::value(u, v, p)` per hit (reference
src/texture.rs:4-6); here every lane selects among the four texture kinds.
A checker resolves its child one level, as the JAX package's general tier
does (the reference only nests solids under a checker, tests/test.rs:93-101):
a checker under a checker shades as its child checker's even/odd colour
table says, and no deeper. The marble comes from `ops/perlin`'s
turbulence (`turb3_stacked`, `turb3`'s value in a few wide ops), the image
texels are read at each image's true size.
"""

from __future__ import annotations

import torch

from ..models.scene import TEX_CHECKER, TEX_IMAGE, TEX_NOISE, SceneTables
from . import perlin
from .rng import lanewise


def eval_texture(scene: SceneTables, tex_id, u, v, p,
                 checker: bool = True) -> torch.Tensor:
    """RGB for lanes: tex_id[N], u[N], v[N], p[N,3] → [N,3]. checker:
    False when the scene holds no checker (its sines are then not
    evaluated)."""
    tex_id = tex_id.long()
    ttype = scene.tex_type[tex_id]
    if checker:
        # checker indirection (reference src/texture.rs:40-47):
        # sin(10x)·sin(10y)·sin(10z) < 0 ? odd : even
        sp = lanewise(torch.sin, 10.0 * p)
        sines = sp[:, 0] * sp[:, 1] * sp[:, 2]
        child = torch.where(sines < 0.0, scene.tex_child[tex_id, 0],
                            scene.tex_child[tex_id, 1]).long()
        tex_id = torch.where(ttype == TEX_CHECKER, child, tex_id)
        ttype = scene.tex_type[tex_id]

    out = scene.tex_color[tex_id]  # TEX_SOLID (reference src/texture.rs:21-24)

    if scene.has_noise_tex:
        # marble: 0.5·(1 + sin(scale·p.x + 5·turb(p, 7))) (src/texture.rs:
        # 66-70), on the lanes that shade it (a lane's value does not
        # depend on the others)
        idx = torch.nonzero(ttype == TEX_NOISE).squeeze(1)
        if idx.numel():
            q = p[idx]
            turb = perlin.turb3_stacked(q[:, 0], q[:, 1], q[:, 2],
                                        seed=scene.perlin_seed)
            marble = 0.5 * (1.0 + lanewise(
                torch.sin, scene.tex_scale[tex_id[idx]] * q[:, 0]
                + 5.0 * turb))
            out = out.clone()
            out[idx] = marble[:, None].expand(-1, 3)

    if scene.has_image_tex:
        # nearest texel, v flipped, clamped to the edge (src/texture.rs:
        # 86-108), indexed with each image's true size
        img_id = scene.tex_image[tex_id].long()
        ny = scene.image_hw[img_id, 0]
        nx = scene.image_hw[img_id, 1]
        i = torch.minimum(torch.clamp((u * nx).to(torch.int32), min=0),
                          nx - 1).long()
        j = torch.minimum(torch.clamp(((1.0 - v) * ny).to(torch.int32),
                                      min=0), ny - 1).long()
        texel = scene.images[img_id, j, i]
        out = torch.where((ttype == TEX_IMAGE)[:, None], texel, out)

    return out
