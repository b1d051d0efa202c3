"""Batched ray/scene intersection over the flat tables (the general tier).

Counterpart of `raytracing_rust_tpu/ops/intersect.py`:

* **Transform hoisting** (`rot_plus`, `rot_minus`, `pack_prims`).
  Traslate/Rotate instances (reference src/traslate.rs:18-24,
  src/rotate.rs:85-112) are rigid, so instead of rotating every (ray, prim)
  pair into object space the transform is pushed into per-primitive
  world-space quantities once: sphere centers become `R·c + offset`; rects
  become a (plane normal, two in-plane axes, offsets) frame. The kernel's
  scene record is built from these frames too.
* **The dense closest hit** (`closest_hit`): every (ray, prim) pair's
  candidate t in [N, C] tensors over chunks of prims, then a min-reduction,
  the order-free equivalent of the reference's shrinking scan
  (src/hittable.rs:37-47); `hit_attributes` recomputes the normal and UV of
  each ray's winner only; `media_scatter` samples the constant-density
  media in closed form.

The arithmetic is the JAX package's, op for op and in its order: the
[N,3]·[3,C] contractions are broadcast multiplies and adds in f32 (`_mm`),
never a matmul, so no tensor core (TF32) rounds a coordinate; square roots
are correctly rounded (`rng.sqrt_rn`) and the transcendental functions go
through `rng.lanewise`, so a lane's result does not depend on where it lies
in its batch. On the CPU, t and the winner then equal JAX's eager ones bit
for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.scene import (MED_SPHERE, PRIM_MOVING_SPHERE, PRIM_RECT,
                            PRIM_SPHERE, TEX_CHECKER, SceneTables)
from .rng import lanewise, sqrt_rn

BIG = 3.0e38  # stand-in for f64::MAX at reference src/color.rs:7


def _onehot3(idx: torch.Tensor, dtype) -> torch.Tensor:
    """[..., 3] one-hot for axis codes in {0, 1, 2}."""
    return (idx[..., None] == torch.arange(3, dtype=idx.dtype,
                                           device=idx.device)).to(dtype)


def _rot(scene: SceneTables, xf_id: torch.Tensor, v: torch.Tensor, sign: float):
    axis = scene.xf_axis[xf_id].long()
    s = sign * scene.xf_sin[xf_id][..., None]
    c = scene.xf_cos[xf_id][..., None]
    er = _onehot3(axis, v.dtype)
    ea = _onehot3((axis + 1) % 3, v.dtype)
    eb = _onehot3((axis + 2) % 3, v.dtype)
    va = torch.sum(v * ea, -1, keepdim=True)
    vb = torch.sum(v * eb, -1, keepdim=True)
    vr = torch.sum(v * er, -1, keepdim=True)
    return vr * er + (c * va - s * vb) * ea + (s * va + c * vb) * eb


def rot_plus(scene: SceneTables, xf_id: torch.Tensor, v: torch.Tensor):
    """Object→world rotation of transform slot(s) `xf_id` applied to v.

    Componentwise form of reference src/rotate.rs:100-112: for rotation
    axis r with (a, b) = ((r+1)%3, (r+2)%3):
      out[a] = c·v[a] − s·v[b];  out[b] = s·v[a] + c·v[b];  out[r] = v[r].
    xf_id: int[...]; v: [..., 3] → [..., 3].
    """
    return _rot(scene, xf_id, v, 1.0)


def rot_minus(scene: SceneTables, xf_id: torch.Tensor, v: torch.Tensor):
    """World→object rotation (reference src/rotate.rs:87-97), the inverse
    of `rot_plus`."""
    return _rot(scene, xf_id, v, -1.0)


@dataclass
class PrimPack:
    """Per-primitive world-space quantities."""
    is_sphere: torch.Tensor   # bool[P] (sphere or moving sphere)
    is_moving: torch.Tensor   # bool[P]
    is_rect: torch.Tensor     # bool[P]
    c0: torch.Tensor          # f32[P,3] world center at time0 (R·c0 + offset)
    dc: torch.Tensor          # f32[P,3] world center span (R·(c1−c0)); 0 if static
    t0: torch.Tensor          # f32[P] motion time0 (reference src/sphere.rs:115)
    inv_dt: torch.Tensor      # f32[P] 1/(time1−time0); 0 if static
    radius: torch.Tensor      # f32[P]
    r2: torch.Tensor          # f32[P] radius²
    kn: torch.Tensor          # f32[P,3] rect plane normal (world)
    an: torch.Tensor          # f32[P,3] rect a-axis (world)
    bn: torch.Tensor          # f32[P,3] rect b-axis (world)
    k_off: torch.Tensor       # f32[P] plane offset: k + offset·kn
    a_off: torch.Tensor       # f32[P] offset·an
    b_off: torch.Tensor       # f32[P] offset·bn
    a0: torch.Tensor          # f32[P] rect bounds
    a1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor


def pack_prims(scene: SceneTables) -> PrimPack:
    """Hoist instance transforms into world-space primitive quantities.

    For the reference's world→object mapping p_obj = R₋(p − offset)
    (src/traslate.rs:18 + src/rotate.rs:87-97), |R₋(o−offset) − c| =
    |o − (R₊c + offset)|, so a transformed sphere is a sphere at
    c' = R₊c + offset. For rects the object-space plane/axis unit vectors
    map to world frame vectors R₊e.
    """
    dtype = scene.prim_data.dtype
    ptype = scene.prim_type
    data = scene.prim_data
    xf = scene.prim_xform.long()
    off = scene.xf_offset[xf]

    is_moving = ptype == PRIM_MOVING_SPHERE
    is_sphere = (ptype == PRIM_SPHERE) | is_moving
    is_rect = ptype == PRIM_RECT

    c0w = rot_plus(scene, xf, data[:, 0:3]) + off
    dc_obj = torch.where(is_moving[:, None], data[:, 4:7] - data[:, 0:3],
                         torch.zeros((), dtype=dtype, device=data.device))
    dcw = rot_plus(scene, xf, dc_obj)
    mt0 = data[:, 7]
    mdt = data[:, 8] - data[:, 7]
    one = torch.ones((), dtype=dtype, device=data.device)
    inv_dt = torch.where(is_moving, 1.0 / torch.where(mdt == 0, one, mdt),
                         torch.zeros_like(mdt))
    radius = data[:, 3]

    axis = scene.prim_axis.long()
    kn = rot_plus(scene, xf, _onehot3(axis, dtype))
    an = rot_plus(scene, xf, _onehot3((axis + 1) % 3, dtype))
    bn = rot_plus(scene, xf, _onehot3((axis + 2) % 3, dtype))

    return PrimPack(
        is_sphere=is_sphere, is_moving=is_moving, is_rect=is_rect,
        c0=c0w, dc=dcw, t0=mt0, inv_dt=inv_dt,
        radius=radius, r2=radius * radius,
        kn=kn, an=an, bn=bn,
        k_off=data[:, 4] + torch.sum(off * kn, -1),
        a_off=torch.sum(off * an, -1),
        b_off=torch.sum(off * bn, -1),
        a0=data[:, 0], a1=data[:, 2], b0=data[:, 1], b1=data[:, 3],
    )


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,3] @ [3,C] as an explicit f32 multiply-and-add, never a matmul:
    a tensor-core matmul (TF32 on the card) rounds cornell-scale
    coordinates onto the wrong side of their own surface, as the TPU's bf16
    does (the JAX package's `_mm`)."""
    return (a[:, 0:1] * b[0][None, :] + a[:, 1:2] * b[1][None, :]
            + a[:, 2:3] * b[2][None, :])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of size 3, in order (XLA's reduce of 3)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# elements of an [N, C] temp of `closest_hit` (f32: 128 MB on the CPU, the
# JAX package's budget; 512 MB on the card, whose eager ops are cheap only
# when they are wide)
_BUDGET_CPU = 1 << 25
_BUDGET_CUDA = 1 << 27


def _chunk_size(n: int, p: int, budget_elems: int = _BUDGET_CPU) -> int:
    """The prim-chunk width: all P prims in one pass when the [N, C] temps
    fit the budget, else even chunks covering P."""
    c = max(8, budget_elems // max(n, 1))
    if c >= p:
        return p
    nchunks = -(-p // c)
    return -(-p // nchunks)


@dataclass
class HitPlan:
    """The pack split by kind, for `closest_hit`: JAX's `_candidate_ts`
    evaluates the sphere and the rect test of every (ray, prim) pair and
    selects by kind; here each kind's test runs on its own prims only, and
    the rect frame dot products (o·kn, d·kn, o·an, …) once per distinct
    frame, the per-pair arithmetic unchanged. Component-major [3, K]
    tables, so each [N, K] operand is contiguous."""
    sph: torch.Tensor      # int64[S] sphere prims (moving ones too), ascending
    moving: bool           # a sphere moves: its center is c0 + frac·dc
    c0: torch.Tensor       # f32[3, S]
    dc: torch.Tensor       # f32[3, S]
    t0: torch.Tensor       # f32[S]
    inv_dt: torch.Tensor   # f32[S]
    r2: torch.Tensor       # f32[S]
    rect: torch.Tensor     # int64[R] rect prims, ascending
    frame: torch.Tensor    # int64[R] each rect's frame
    frames: torch.Tensor   # f32[9, F] the distinct (kn, an, bn)
    rframes: torch.Tensor  # f32[9, R] each rect's (kn, an, bn)
    off: torch.Tensor      # f32[7, R] k_off, a_off, b_off, a0, a1, b0, b1


def plan_hits(pack: PrimPack, src: torch.Tensor | None = None) -> HitPlan:
    """The kind split of `pack` for `closest_hit` (once per trace).

    The distinct frames are found on detached values, and `frames` gathers
    each one from its first rect, so it stays a function of the transform
    tables. Under autograd (the frames require grad) two rects share a
    frame only where they also share its source: src, int64[P], names each
    prim's (transform row, axis), or None to share no frame. Otherwise a
    rect's gradient would reach the row of another rect whose frame has
    the same value (a cube at zero tilt and an unrotated light). Every
    frame's dot products are the same values either way."""
    sph = torch.nonzero(pack.is_sphere).squeeze(1)
    rect = torch.nonzero(pack.is_rect).squeeze(1)
    rf = torch.cat([pack.kn, pack.an, pack.bn], dim=1)[rect]   # [R, 9]
    n_rect = rect.numel()
    if n_rect:
        key = rf.detach()
        if rf.requires_grad:
            owner = (src[rect] if src is not None
                     else torch.arange(n_rect, device=rf.device))
            key = torch.cat([key, owner.to(key.dtype)[:, None]], dim=1)
        _, frame = torch.unique(key, dim=0, return_inverse=True)
        lanes = torch.arange(n_rect, device=rf.device)
        first = torch.full((int(frame.max()) + 1,), n_rect,
                           dtype=lanes.dtype, device=rf.device)
        first = first.scatter_reduce(0, frame, lanes, "amin")
        frames = rf[first]
    else:
        frames, frame = rf, rect
    return HitPlan(
        sph=sph, moving=bool(pack.is_moving.any()),
        c0=pack.c0[sph].T.contiguous(), dc=pack.dc[sph].T.contiguous(),
        t0=pack.t0[sph], inv_dt=pack.inv_dt[sph], r2=pack.r2[sph],
        rect=rect, frame=frame, frames=frames.T.contiguous(),
        rframes=rf.T.contiguous(),
        off=torch.stack([pack.k_off, pack.a_off, pack.b_off, pack.a0,
                         pack.a1, pack.b0, pack.b1])[:, rect].contiguous())


def _sphere_ts(pl: HitPlan, lo: int, hi: int, o, d, a, time, t_min: float,
               t_max: float):
    """Candidate t of every (ray, sphere lo..hi−1) pair → [N, C] (BIG =
    miss): the quadratic with its near-then-far root on the open interval
    (reference src/sphere.rs:37-77) at the center of each lane's time
    (src/sphere.rs:115-118); oc by subtraction first (the expanded
    |o|² − 2o·c' + |c'|² cancels catastrophically in f32). A static
    sphere's c0 + frac·dc is c0 exactly (dc = 0), so it is not formed."""
    c0 = pl.c0[:, lo:hi]
    if pl.moving:
        frac = (time[:, None] - pl.t0[None, lo:hi]) * pl.inv_dt[None, lo:hi]
        c = [c0[k][None, :] + frac * pl.dc[k, lo:hi][None, :]
             for k in range(3)]
    else:
        c = [c0[k][None, :] for k in range(3)]
    ocx, ocy, ocz = (o[:, k:k + 1] - c[k] for k in range(3))
    b = (ocx * d[:, 0:1] + ocy * d[:, 1:2]) + ocz * d[:, 2:3]
    cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - pl.r2[None, lo:hi]
    del ocx, ocy, ocz
    disc = b * b - a * cc
    pos = disc > 0.0
    sq = sqrt_rn(torch.where(pos, disc, 1.0))
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    near_ok = pos & (t_near > t_min) & (t_near < t_max)
    far_ok = pos & (t_far > t_min) & (t_far < t_max)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, BIG))


def _frame_dots(f: torch.Tensor, o, d):
    """o·kn, d·kn, o·an, d·an, o·bn, d·bn for frames f (f32[9, K]) →
    six [N, K] (`_mm`)."""
    return [_mm(v, f[3 * k:3 * k + 3]) for k in range(3) for v in (o, d)]


def _rect_ts(pl: HitPlan, lo: int, hi: int, dots, o, d, t_min: float,
             t_max: float):
    """Candidate t of every (ray, rect lo..hi−1) pair → [N, C] (BIG =
    miss): the plane o·kn + t·(d·kn) = k_off and the bounds test
    (reference src/rect.rs:39-69) in the rect's world frame. dots: the
    frames' `_frame_dots` (gathered to the rects), or None to form them
    from the rects' own frames."""
    if dots is None:
        o_kn, d_kn, o_an, d_an, o_bn, d_bn = _frame_dots(
            pl.rframes[:, lo:hi], o, d)
    else:
        fr = pl.frame[lo:hi]
        o_kn, d_kn, o_an, d_an, o_bn, d_bn = (x[:, fr] for x in dots)
    k_off, a_off, b_off, a0, a1, b0, b1 = (x[None, :] for x in
                                           pl.off[:, lo:hi])
    parallel = d_kn == 0.0
    t_r = (k_off - o_kn) / torch.where(parallel, 1.0, d_kn)
    x = o_an + t_r * d_an - a_off
    y = o_bn + t_r * d_bn - b_off
    ok = ((~parallel) & (t_r > t_min) & (t_r < t_max)
          & (x >= a0) & (x <= a1) & (y >= b0) & (y <= b1))
    return torch.where(ok, t_r, BIG)


@dataclass
class Hit:
    t: torch.Tensor      # f32[N]  (BIG on miss)
    idx: torch.Tensor    # int64[N] winning primitive (-1 on miss)
    mask: torch.Tensor   # bool[N]


def closest_hit(scene: SceneTables, o, d, time, t_min: float,
                t_max: float = BIG, pack: PrimPack | None = None,
                chunk: int | None = None) -> Hit:
    """Closest surface hit over all primitives (a min-reduction, the
    order-free equivalent of the reference's shrinking scan,
    src/hittable.rs:37-47): the first minimum in prim order, as JAX's
    argmin keeps it, over chunks of each kind's prims (`HitPlan`; the
    pack's own when it is a `PlannedPack`)."""
    if pack is None:
        pack = pack_prims(scene)
    pl = getattr(pack, "plan", None) or plan_hits(pack)
    n = o.shape[0]
    budget = _BUDGET_CUDA if o.is_cuda else _BUDGET_CPU
    t_best = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    i_best = torch.zeros((n,), dtype=torch.int64, device=o.device)

    def take(t, ids):
        # rebinds, not in-place copies: t_best carries the winner's
        # gradient under autograd
        nonlocal t_best, i_best
        tc, ic = torch.min(t, dim=1)
        ic = ids[ic]
        better = (tc < t_best) | ((tc == t_best) & (ic < i_best))
        t_best = torch.where(better, tc, t_best)
        i_best = torch.where(better, ic, i_best)

    n_sph, n_rect = pl.sph.numel(), pl.rect.numel()
    if n_sph:
        a = _dot(d, d)[:, None]
        c = chunk or _chunk_size(n, n_sph, budget)
        for lo in range(0, n_sph, c):
            hi = min(lo + c, n_sph)
            take(_sphere_ts(pl, lo, hi, o, d, a, time, t_min, t_max),
                 pl.sph[lo:hi])
    if n_rect:
        c = chunk or _chunk_size(n, n_rect, budget)
        n_frames = pl.frames.shape[1]
        dots = (_frame_dots(pl.frames, o, d)
                if n_frames < n_rect and n * n_frames <= budget else None)
        for lo in range(0, n_rect, c):
            hi = min(lo + c, n_rect)
            take(_rect_ts(pl, lo, hi, dots, o, d, t_min, t_max),
                 pl.rect[lo:hi])
    mask = t_best < BIG
    return Hit(t=t_best, idx=torch.where(mask, i_best, -1), mask=mask)


@dataclass
class PlannedPack(PrimPack):
    """A PrimPack with its `HitPlan`, what the general tier traces with,
    and what the scene's lanes can shade: the material tags of its prims
    and media (`mats`), and whether its texture table holds a checker."""
    plan: HitPlan
    mats: frozenset
    checker: bool


def plan_pack(scene: SceneTables) -> PlannedPack:
    """`pack_prims` with its `HitPlan` and shading kinds (once per trace)."""
    pack = pack_prims(scene)
    src = scene.prim_xform.long() * 3 + scene.prim_axis.long()
    mat = scene.prim_material
    if scene.has_media:
        mat = torch.cat([mat, scene.med_material])
    return PlannedPack(
        **vars(pack), plan=plan_hits(pack, src),
        mats=frozenset(scene.mat_type[mat.long()].tolist()),
        checker=bool((scene.tex_type == TEX_CHECKER).any()))


def hit_attributes(scene: SceneTables, o, d, time, hit: Hit,
                   pack: PrimPack | None = None):
    """Attributes of each ray's winning primitive → (p, normal, u, v,
    mat_id): the normal and UV of reference src/sphere.rs:9-15,46-52 and
    src/rect.rs:53-60, the instance rotation of the normal of
    src/rotate.rs:100-112 (through the world frames of the pack), the UV
    from object-space quantities as the reference computes them. Sphere v
    is the canonical (θ+π/2)/π unless the scene keeps the reference's
    FRAC_2_PI (`compat_uv_bug`, src/sphere.rs:13). A miss lane's t is 0
    (the double-where: BIG·d overflows, and a NaN from a texture at p = inf
    would poison a gradient through it); its values are masked later."""
    if pack is None:
        pack = pack_prims(scene)
    # a kind the scene does not hold is not evaluated: torch.where would
    # never select it
    pl = getattr(pack, "plan", None)
    any_sph = pl is None or pl.sph.numel() > 0
    any_rect = pl is None or pl.rect.numel() > 0
    idx = torch.clamp(hit.idx, min=0)

    def g(x):
        return x[idx]
    t = torch.where(hit.t < BIG, hit.t, 0.0)
    p = o + t[:, None] * d

    if any_sph:
        # sphere: world normal (p − c'(time)) / r, the rotated-back object
        # normal
        frac = (time - g(pack.t0)) * g(pack.inv_dt)
        center = g(pack.c0) + frac[:, None] * g(pack.dc)
        r_safe = g(pack.radius)
        r_safe = torch.where(r_safe == 0.0, 1.0, r_safe)
        n_sph = (p - center) / r_safe[:, None]

        # sphere UV from the object-space normal n_obj = R₋ n_world
        if scene.has_xforms:
            n_obj = rot_minus(scene, scene.prim_xform[idx].long(), n_sph)
        else:
            n_obj = n_sph
        phi = lanewise(torch.atan2, n_obj[:, 2], n_obj[:, 0])
        theta = lanewise(torch.asin, torch.clamp(n_obj[:, 1], -1.0, 1.0))
        u_sph = 1.0 - (phi + math.pi) / (2.0 * math.pi)
        v_off = (2.0 / math.pi) if scene.compat_uv_bug else (math.pi / 2.0)
        v_sph = (theta + v_off) / math.pi

    if any_rect:
        # rect: u, v from world-frame projections (src/rect.rs:53-60)
        an, bn, kn = g(pack.an), g(pack.bn), g(pack.kn)
        x = _dot(p, an) - g(pack.a_off)
        y = _dot(p, bn) - g(pack.b_off)
        u_rect = (x - g(pack.a0)) / (g(pack.a1) - g(pack.a0))
        v_rect = (y - g(pack.b0)) / (g(pack.b1) - g(pack.b0))

    if any_sph and any_rect:
        is_sph = g(pack.is_sphere)
        normal = torch.where(is_sph[:, None], n_sph, kn)
        u = torch.where(is_sph, u_sph, u_rect)
        v = torch.where(is_sph, v_sph, v_rect)
    elif any_sph:
        normal, u, v = n_sph, u_sph, v_sph
    else:
        normal, u, v = kn, u_rect, v_rect
    normal = normal * scene.prim_flip[idx][:, None]
    return p, normal, u, v, scene.prim_material[idx].long()


def media_scatter(scene: SceneTables, o, d, t_min: float,
                  t_surface: torch.Tensor, u_med: torch.Tensor):
    """Closed-form ConstantMedium sampling (reference src/medium.rs:28-56)
    over any number of media → (t_scatter[N] (BIG if none),
    med_material[N]).

    Each medium's boundary is entered and left on the ray's line (sphere
    roots, or the box slabs in object space; equivalent to the reference's
    two boundary.hit calls over (−MAX, MAX)); the entry is clamped to t_min
    and the exit to the closest surface, then the free flight −(1/ρ)·ln U
    (src/medium.rs:40) decides. Medium boundaries are static (SceneBuilder
    takes media on sphere or box boundaries without motion), so there is
    no time. u_med: [N, M] uniforms, one per medium a bounce. The first
    strict minimum over the media wins.
    """
    xf = scene.med_xform.long()
    off = scene.xf_offset[xf]
    d_norm = sqrt_rn(_dot(d, d))

    # world→object: o' = R₋(o − off), d' = R₋ d (broadcast over media)
    o_obj = rot_minus(scene, xf[None, :], o[:, None, :] - off[None, :, :])
    d_obj = rot_minus(scene, xf[None, :], d[:, None, :].expand(
        d.shape[0], xf.shape[0], 3))

    data = scene.med_data  # [M, 6]

    # sphere boundary: both roots on the unbounded line
    oc = o_obj - data[None, :, 0:3]
    a = _dot(d_obj, d_obj)
    b = _dot(oc, d_obj)
    c = _dot(oc, oc) - (data[:, 3] * data[:, 3])[None]
    disc = b * b - a * c
    sph_ok = disc > 0.0
    sq = sqrt_rn(torch.where(sph_ok, disc, 1.0))
    sph_enter = (-b - sq) / a
    sph_exit = (-b + sq) / a

    # box boundary: slabs on the infinite line (a tiny direction component
    # becomes 1e-30, so a parallel slab stays finite)
    pmin = data[None, :, 0:3]
    pmax = data[None, :, 3:6]
    d_safe = torch.where(torch.abs(d_obj) < 1e-30, 1e-30, d_obj)
    inv_d = 1.0 / d_safe
    t0 = (pmin - o_obj) * inv_d
    t1 = (pmax - o_obj) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    box_enter = torch.amax(lo, dim=-1)
    box_exit = torch.amin(hi, dim=-1)
    box_ok = box_enter < box_exit

    is_sph = (scene.med_type == MED_SPHERE)[None]
    enter = torch.where(is_sph, sph_enter, box_enter)
    exit_ = torch.where(is_sph, sph_exit, box_exit)
    ok = torch.where(is_sph, sph_ok, box_ok)

    # clamp to [t_min, t_surface] (reference src/medium.rs:32-37)
    enter = torch.clamp(enter, min=t_min)
    exit_ = torch.minimum(exit_, t_surface[:, None])
    ok = ok & (enter < exit_)

    dist_inside = (exit_ - enter) * d_norm[:, None]
    hit_dist = -(1.0 / scene.med_density)[None] * lanewise(
        torch.log, torch.clamp(u_med, min=1e-37))
    scatters = ok & (hit_dist < dist_inside)
    t_sc = torch.where(scatters, enter + hit_dist / d_norm[:, None], BIG)

    t_best, best = torch.min(t_sc, dim=-1)
    return t_best, scene.med_material[best].long()
