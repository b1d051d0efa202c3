"""Hash-gradient Perlin noise and turbulence (reference src/perlin.rs).

Counterpart of `raytracing_rust_tpu/ops/perlin.py` (`_gradient`, `noise`,
`turb`) and of the TPU kernel's `_noise3` / `_turb3`
(`ops/pallas_tracer.py:1043-1087`), whose component-plane form
`noise3` / `turb3` follow op for op; `csrc/tracer.cu` (`cell`,
`corner_term`, `warp_turb`) computes the same expressions in the same
order, its corner terms spread over a warp.

The reference's permutation tables come from an unseeded thread RNG
(src/perlin.rs:5,13), so there is no fixed field to match. The JAX package
replaces them by an arithmetic lattice hash: each corner (i & 255, j & 255,
k & 255) hashes with the seed to two uniforms that parameterize a uniformly
distributed unit gradient (cos θ = 2u₁ − 1, φ = 2πu₂). Lattice coordinates
use a true signed floor, not the reference's saturating `as usize` cast.

Torch has no uint32 arithmetic, so the hash runs on int64 tensors holding
uint32 values, masked to 32 bits after every multiply, with each multiply
split so no partial product leaves int64 (as `ops/rng.py` does for Philox):
the integer path is bit-identical to the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rng import lanewise

# hash constants (ops/perlin.py of the JAX package)
HA, HB, HC = 0x8DA6B343, 0xD8163841, 0xCB1AB31F
HSEED = 0x27D4EB2F
HM1, HM2, HM3 = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35
INV24 = 1.0 / (1 << 24)
TWO_PI = float(np.float32(2.0 * math.pi))
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x · m) mod 2³² for int64 x holding uint32 values and a 32-bit m: the
    product fits 64 bits, and int64 multiplication wraps modulo 2⁶⁴ on both
    devices, so its low 32 bits are the product's."""
    return (x * m) & _MASK32


def seed_word(seed: int) -> int:
    """The seed's 32-bit hash word, (seed · HSEED) mod 2³²."""
    return (seed * HSEED) & _MASK32


def hash_words(ci, cj, ck, seed: int):
    """The two 32-bit hash words (h, g) of lattice corners ci, cj, ck
    (int64 tensors in [0, 255])."""
    h = _mul32(ci, HA) ^ _mul32(cj, HB) ^ _mul32(ck, HC) ^ seed_word(seed)
    h = h ^ (h >> 13)
    h = _mul32(h, HM1)
    h = h ^ (h >> 16)
    g = _mul32(h ^ HM2, HM3)
    g = g ^ (g >> 16)
    return h, g


def gradient(ci, cj, ck, seed: int):
    """Unit gradient (gx, gy, gz), f32, at lattice corners ci, cj, ck (int64
    tensors already wrapped to [0, 255])."""
    h, g = hash_words(ci, cj, ck, seed)
    u1 = (h >> 8).to(torch.float32) * INV24
    u2 = (g >> 8).to(torch.float32) * INV24
    cz = 2.0 * u1 - 1.0
    sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
    phi = TWO_PI * u2
    return (sz * lanewise(torch.cos, phi), sz * lanewise(torch.sin, phi),
            cz)


def cell(px, py, pz):
    """The lattice cell of the points (px, py, pz) (f32 tensors of one
    shape) → (u, i, s): the offsets in the cell, its signed-floor corner
    (int64) and the Hermite-smoothed weights (reference
    src/perlin.rs:39-41), three tensors each."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    ux, uy, uz = px - fx, py - fy, pz - fz
    i = tuple(f.to(torch.int64) for f in (fx, fy, fz))
    s = tuple(u * u * (3.0 - 2.0 * u) for u in (ux, uy, uz))
    return (ux, uy, uz), i, s


def corner_term(c, corner: int, seed: int = 0):
    """The term of `cell` c's corner = 4·di + 2·dj + dk in `noise3`:
    wu·wv·ww times the dot product of the corner's gradient with the
    offset from the corner. csrc/tracer.cu's `corner_term`, the unit that
    its `warp_turb` hands out over a warp."""
    (ux, uy, uz), (ix, iy, iz), (sx, sy, sz) = c
    di, dj, dk = corner >> 2, (corner >> 1) & 1, corner & 1
    wu = sx if di else 1.0 - sx
    wv = sy if dj else 1.0 - sy
    ww = sz if dk else 1.0 - sz
    gx, gy, gz = gradient((ix + di) & 255, (iy + dj) & 255, (iz + dk) & 255,
                          seed)
    dot = (gx * (ux - float(di)) + gy * (uy - float(dj))
           + gz * (uz - float(dk)))
    return wu * wv * ww * dot


def noise3(px, py, pz, seed: int = 0):
    """Gradient noise at the points (px, py, pz) (f32 tensors of one shape;
    reference src/perlin.rs:58-97): Hermite-smoothed trilinear blend of the
    eight corners' gradient dot products, summed corner by corner."""
    c = cell(px, py, pz)
    accum = torch.zeros_like(px)
    for corner in range(8):
        accum = accum + corner_term(c, corner, seed)
    return accum


def turb3(px, py, pz, seed: int = 0, depth: int = 7):
    """|Σₖ 0.5ᵏ noise(2ᵏ p)| over `depth` octaves (reference
    src/perlin.rs:99-109)."""
    accum = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise3(px, py, pz, seed)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(accum)


def noise(p: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Gradient noise for points p[..., 3] (the JAX package's `noise`)."""
    return noise3(p[..., 0], p[..., 1], p[..., 2], seed)


def turb(p: torch.Tensor, depth: int = 7, seed: int = 0) -> torch.Tensor:
    """Turbulence for points p[..., 3] (the JAX package's `turb`)."""
    return turb3(p[..., 0], p[..., 1], p[..., 2], seed, depth)


def turb3_stacked(px, py, pz, seed: int = 0, depth: int = 7):
    """`turb3`'s value bit for bit, in a few wide ops: the points of all
    `depth` octaves (each the last one's times 2, exactly) and the eight
    corners of each cell are stacked into one [depth·8, n] batch, so the
    hash, the gradients and the corner terms run once; the terms are then
    summed in `noise3`'s corner order and the octaves in `turb3`'s. The
    general tier's marble; `turb3` stays the kernel's plain model."""
    scale = torch.tensor([2.0 ** k for k in range(depth)], dtype=px.dtype,
                         device=px.device)[:, None]
    (ux, uy, uz), (ix, iy, iz), (sx, sy, sz) = cell(
        scale * px[None, :], scale * py[None, :], scale * pz[None, :])
    corner = torch.arange(8, device=px.device)
    di, dj, dk = ((corner >> 2)[:, None, None], ((corner >> 1) & 1)[:, None,
                  None], (corner & 1)[:, None, None])
    fi, fj, fk = (x.to(px.dtype) for x in (di, dj, dk))
    wu = torch.where(di == 1, sx, 1.0 - sx)
    wv = torch.where(dj == 1, sy, 1.0 - sy)
    ww = torch.where(dk == 1, sz, 1.0 - sz)
    gx, gy, gz = gradient((ix + di) & 255, (iy + dj) & 255, (iz + dk) & 255,
                          seed)
    dot = gx * (ux - fi) + gy * (uy - fj) + gz * (uz - fk)
    term = wu * wv * ww * dot                       # [8, depth, n]
    noise = torch.zeros_like(term[0])
    for c in range(8):
        noise = noise + term[c]
    accum = torch.zeros_like(px)
    weight = 1.0
    for k in range(depth):
        accum = accum + weight * noise[k]
        weight *= 0.5
    return torch.abs(accum)
