"""The forward megakernel (K1a-K1g, the lattice corners) and its host side.

Counterpart of `raytracing_rust_tpu/ops/pallas_tracer.py`, cut to what the
kernel covers: spheres (moving ones included) and rect frame groups from a
per-primitive scalar record, and, for scenes of more than UNROLL_BUDGET
prims, a dynamic sphere table and a table of axis-aligned boxes (cubes of
six rects merged into one row), each in cluster order behind a leaf AABB
cull; lambertian, metal, dielectric and diffuse-light materials with solid,
3-D checker, Perlin marble and image textures (nearest texel from a packed
8-bit atlas at the sphere UV of the pre-flip normal, or at a rect's UV);
textured lights; constant-density media with sphere or box boundaries
under a rotation and offset (free flight against the closest surface,
isotropic scatter, solid or textured albedo), with the dense-medium walk
for a medium sealed by a coincident sphere; a black or sky background;
camera raygen with jitter, a thin lens and a shutter time; optional
Russian roulette; per-pixel radiance sums over a runtime sample count and
depth cap. That is every scene the JAX kernel takes: what it refuses
(image textures on rotated spheres, nested checkers, images that are not
8-bit exact, more than MAX_MEDIA media, more than UNROLL_BUDGET rects that
form no box) raises `UnsupportedScene` here too.

* `build_scene_record` / `build_camera_record` flatten the scene tables and
  the camera into the JAX kernel's record layouts (`R_*`, `M_*`, `C_*`),
  column for column, with the JAX package's partition of big scenes (box
  merge, dynamic tables, cluster tables), its dense-medium analysis and
  its packed texel atlas.
* `trace_operands` puts a scene's records on a device for `trace`.
* `trace` is the wrapper of the hand-written CUDA kernel
  (`csrc/tracer.cu`): on CUDA tensors it launches the kernel, on CPU
  tensors it runs `trace_plain`, the same computation in plain torch.
* `render_kernel` is the counterpart of `render_pallas`: sample chunks
  through `trace`, f64 sums on the device, the reference's gamma; for a
  scene with a dynamic sphere or box table at spp ≥ 8, first the cost
  probe (`cost_probe`, K1f's probe launch `trace_probe`: compact tiles,
  the samples split over blocks, the segments alone) and the balanced
  pixel table the kernel then renders from, as JAX's default render does,
  laid out
  for the card (`render_table`: one pixel a thread, a block on a compact
  tile, the tiles heaviest first, the order computed on the device). JAX's
  own table (`cost_permutation`, `balanced_pix_table`) is kept as the
  yardstick.

Random numbers are Philox4x32-10 keyed by the seed and addressed by
(pixel, sample, bounce, stream); `ops/rng.py` documents the slots.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import (BG_SKY, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT,
                            MAT_ISOTROPIC, MAT_LAMBERTIAN, MAT_METAL,
                            MED_SPHERE, PRIM_MOVING_SPHERE, PRIM_RECT,
                            TEX_CHECKER, TEX_IMAGE, TEX_NOISE, TEX_SOLID,
                            SceneTables)
from ..render import finalize_image
from ..utils.timers import Timers
from . import perlin, rng
from .camera import Camera, get_rays
from .intersect import pack_prims

BIG = 3.0e38
T_MIN = 1e-3   # reference src/color.rs:7
# f32 constants of the sphere UV (pallas_tracer.py:2318-2324)
PI = float(np.float32(math.pi))
HALF_PI = float(np.float32(math.pi / 2.0))
TWO_OVER_PI = float(np.float32(2.0 / math.pi))   # compat_uv's v offset
INV_PI = float(np.float32(1.0 / math.pi))
INV_2PI = float(np.float32(0.5 / math.pi))

# per-primitive scalar record layout (f32[P, REC]), the JAX kernel's
R_IS_SPHERE = 0
R_C0 = 1          # 1..3  world center at time0
R_DC = 4          # 4..6  center span (moving)
R_T0 = 7
R_INV_DT = 8
R_RADIUS = 9
R_R2 = 10
R_KN = 11         # 11..13 rect plane normal (world)
R_AN = 14         # 14..16 rect a axis
R_BN = 17         # 17..19 rect b axis
R_KOFF = 20
R_AOFF = 21
R_BOFF = 22
R_A0, R_A1, R_B0, R_B1 = 23, 24, 25, 26
R_FLIP = 27
R_MAT = 28        # material type tag as float
R_PARAM = 29      # fuzz / ref_idx
R_EMIT = 30       # 30..32
R_ALB_EVEN = 33   # 33..35
R_ALB_ODD = 36    # 36..38
R_CHECKER = 39
R_NOISE = 40
R_NSCALE = 41
R_IMG = 42
R_IMG_BASE = 43
R_IMG_H = 44
R_IMG_W = 45
REC = 46

# per-medium record layout (f32[M, MEDREC]), the JAX kernel's
M_DATA = 0        # sphere: cx, cy, cz, r² | box: pmin3, pmax3 (object space)
M_INV_RHO = 6     # 1 / density
M_ROT = 7         # 7..15 world→object rotation R₋, row-major
M_OFF = 16        # 16..18 translate offset
M_ALB = 19        # 19..21 isotropic albedo (solid)
M_ALB_ODD = 22    # 22..24 a checker's odd colour (M_ALB its even one)
M_CHK = 25        # the textured-albedo flags and fields, as R_CHECKER..
M_NOISE = 26      # R_IMG_W of a record row
M_NSCALE = 27
M_IMG = 28
M_IMG_BASE = 29
M_IMG_H = 30
M_IMG_W = 31
MEDREC = 32
# a texture's 13 fields, the same in a record row (from R_ALB_EVEN) and a
# medium row (from M_ALB): colour (the even one of a checker), the odd
# colour, then the checker, noise and image flags and fields
T_ALB, T_ODD, T_CHK, T_NOISE, T_NSCALE, T_IMG, T_IMG_BASE, T_IMG_H, \
    T_IMG_W = 0, 3, 6, 7, 8, 9, 10, 11, 12
TEXW = 13
# media a scene may hold; the kernel keeps their records in shared memory
# (csrc/tracer.cu MAX_MEDIA)
MAX_MEDIA = 8

# camera scalar record (f32[CAMREC])
C_ORIGIN, C_LL, C_HORIZ, C_VERT, C_U, C_V = 0, 3, 6, 9, 12, 15
C_LENS_R, C_TIME0, C_DTIME = 18, 19, 20
CAMREC = 21

# prims the static section holds; the kernel's shared-memory record is
# sized for this many (csrc/tracer.cu MAX_PRIMS). Bigger scenes move their
# spheres to the dynamic table (pallas_tracer.UNROLL_BUDGET)
UNROLL_BUDGET = 96
# dynamic spheres per leaf cluster, boxes per leaf cluster, and leaves per
# supercluster (pallas_tracer.SPH_LEAF, BOX_LEAF, SUP_FANOUT)
SPH_LEAF = 16
BOX_LEAF = 8
SUP_FANOUT = 8
# cluster table row: AABB lo (3), hi (3), first member, member count
CLUSW = 8
# rows of the dense-medium walk's interior set; a bigger set is dropped
# whole and the medium takes the event path (pallas_tracer.py:980-982).
# The kernel keeps the rows in shared memory (csrc/tracer.cu MAX_INTERIOR)
MAX_INTERIOR = 24
# interior row kinds (TraceOperands.interior_kind)
INT_SPHERE, INT_RECT, INT_BOX = 0, 1, 2
# the bytes of shared memory a launch takes without opting in; the leaf
# tables go there when they fit beside the records (csrc/tracer.cu
# SMEM_BUDGET)
SMEM_BUDGET = 48 * 1024

# K1f's balanced layout (pallas_tracer.py SUB, LANES, TILE, and the JAX
# defaults of RT_KPIX, RT_PROBE_SPP, RT_SMOOTH, RT_BUCKETS; the port reads
# no environment variable for them): a tile of SUB × LANES threads, KPIX
# pixels a thread, a probe of PROBE_SPP samples at seed PROBE_SEED, a box
# filter of SMOOTH × SMOOTH pixels over its cost image and BUCKETS rank
# buckets
SUB = 8
LANES = 1024
TILE = SUB * LANES
KPIX = 4
PROBE_SPP = 4
PROBE_SEED = 0x5BD1
# the waves of resident blocks the card's probe launch is split to fill
# (`probe_split`; chip_smoke.py phase 34 times each split)
PROBE_WAVES = 12
SMOOTH = 9
BUCKETS = 32
# threads in a block of the kernel (csrc/tracer.cu THREADS) and in a warp
THREADS = 128
WARP = 32
# the card's balanced table (`block_tile_table`): a block renders one tile
# of BLOCK_W × BLOCK_H pixels, one a thread, row by row, so that each warp
# renders a 16 × 2 strip of it
BLOCK_W, BLOCK_H = 16, 8

# static kernel features: csrc/tracer.cu runs its K1B instantiations when
# any is set, and branches on each inside them
FEAT_SKY = 1
FEAT_CHECKER = 2
FEAT_METAL = 4
FEAT_DIEL = 8
FEAT_MOVING = 16
FEAT_NOISE = 32       # Perlin marble albedo (K1c)
FEAT_IMAGE = 64       # image albedo: sphere UV, texel atlas (K1c)
FEAT_MEDIA = 128      # constant-density media, event path (K1d)
FEAT_COMPAT_UV = 256  # the reference's sphere-UV constant (src/sphere.rs:13)
FEAT_DENSE_WALK = 512  # the dense-medium walk (K1d walk); clearing it runs
                       # the same scene on the event path alone
# the lattice corners (the JAX kernel's emis_tex, uv_carry, img_flip and
# med_tex flags): textured lights, the UV of image rects and image media,
# the pre-flip normal of flipped image prims, textured medium albedo
FEAT_EMIS_TEX = 1024
FEAT_UV_CARRY = 2048
FEAT_IMG_FLIP = 4096
FEAT_MED_TEX = 8192
FEAT_LATTICE = FEAT_EMIS_TEX | FEAT_UV_CARRY | FEAT_IMG_FLIP | FEAT_MED_TEX
FEAT_RR = 16384        # Russian roulette (K1g) from TraceOperands.rr_depth on
FEAT_ALL = 32767
K1BE_FEATS = FEAT_SKY | FEAT_CHECKER | FEAT_METAL | FEAT_DIEL | FEAT_MOVING

# launches of the CUDA kernel, counted by `trace` after a launch succeeds,
# once for each section the launch runs: K1a is the instantiation with
# every feature off and no table (cornell_box); a launch counts as K1BE
# when it runs sky, checker, metal, dielectric, moving spheres or the
# dynamic sphere table, as K1E_BOX when it holds boxes (and as K1E_GRID
# when they are a grid, which the strip pass tests), as K1C when it
# shades noise or image textures, as K1D when it holds media, as K1D_WALK
# when it runs the dense-medium walk, as K1_LATTICE when it runs any of
# the lattice corners, and as K1G when it plays Russian roulette; K1F counts
# a launch that renders from a pixel table or fills the stats counters, and
# of those K1F_TABLE the table launches, K1F_STATS the stats launches (a
# stats launch runs its own instantiation, so it never counts as K1a), of
# those K1F_PROBE the cost probe's (`trace_probe`) and K1F_DDA the stats
# launches that fill the DDA row
KERNEL_LAUNCHES = 0
K1BE_LAUNCHES = 0
K1C_LAUNCHES = 0
K1D_LAUNCHES = 0
K1E_BOX_LAUNCHES = 0
K1E_GRID_LAUNCHES = 0
K1D_WALK_LAUNCHES = 0
K1_LATTICE_LAUNCHES = 0
K1G_LAUNCHES = 0
K1F_LAUNCHES = 0
K1F_TABLE_LAUNCHES = 0
K1F_STATS_LAUNCHES = 0
K1F_PROBE_LAUNCHES = 0
K1F_DDA_LAUNCHES = 0
# launches by the instantiation that ran ("trace_k1<K1B,DYN,LEAF_SMEM,
# STATS,MED>", as the kernel reports it): which one a path took
# (cornell_box --rr-depth: the static one, K1a's; cornell_smoke: K1a's code
# with the media)
K1_INSTANTIATION_LAUNCHES: collections.Counter = collections.Counter()

# f32 and integer operations of csrc/tracer.cu per item, counted from its
# source (an add, multiply, compare or transcendental is one): a lane
# bounce's fixed work (scatter Philox, ball sample, emission, new ray), a
# camera sample, a sphere test, a rect test, a rect frame, a leaf slab, a
# dynamic member, a medium, a Perlin marble (7 octaves × 8 corners), a
# texel, a box member, a grid box member in the strip pass (its y_hi and
# z planes, the incremental z exit, the folds and the hit test; its y_lo
# plane and z pitch, 3 a segment past the box root, are left out), a box
# leaf slab, a walk bounce's fixed work
# (its scatter Philox, ball sample, new ray) and each interior row it
# tests; a textured light's hit (its texture test, hit point and a
# checker's three sines; a marble or a texel counted as such), a rect's
# image UV (two frame dot products each way, the reciprocals), a textured
# medium's event (its fields and a checker's sines) and a roulette draw
# (a Philox call, the clipped maximum, the reciprocal and three multiplies)
K1_OPS = dict(segment=160, sample=140, sphere=20, rect=14, frame=32,
              leaf=24, member=20, medium=70, noise=2455, image=30, box=26,
              box_strip=17, box_leaf=24, walk=120, interior=22, emis_tex=20, rect_uv=34,
              med_tex=17, rr=112)

# lanes (pixel × sample) per chunk when the caller names no chunk: the plain
# version holds every lane's state in memory, the kernel holds none
_PLAIN_CHUNK_LANES = 1 << 20
_KERNEL_CHUNK_LANES = 1 << 26


class UnsupportedScene(ValueError):
    """Scene uses features outside the kernel's coverage."""


@dataclass(frozen=True)
class SceneRecord:
    """A scene as the kernel sees it (host side, numpy), the parts of
    `pallas_tracer.build_scene_record` the kernel covers."""
    rec: np.ndarray      # f32[max(P, 1), REC] unrolled prims (a zero row if none)
    kinds: tuple         # "sphere" / "moving" / "rect" per unrolled prim
    rect_groups: tuple   # unrolled rect rows grouped by world plane frame
    dyn_rec: np.ndarray  # f32[n_dyn, REC] dynamic spheres in cluster order
    sclus: np.ndarray    # f32[n_leaf + n_sup, CLUSW] leaves, then superclusters
    n_sclus: tuple       # (n_leaf, n_sup)
    # the JAX kernel's flags: (has_checker, has_metal, has_diel, has_noise,
    # has_image, dyn_moving, compat_uv, emis_tex, uv_carry, img_flip,
    # med_tex)
    flags: tuple
    background: int
    med_rec: np.ndarray  # f32[M, MEDREC] media of nonzero density
    med_kinds: tuple     # "msphere" / "mbox" per medium
    atlas: np.ndarray    # int32[I·H, W] texels r<<16 | g<<8 | b ([0, 0]: none)
    perlin_seed: int
    box_rec: np.ndarray  # f32[n_box, REC] merged boxes in cluster order
    bclus: np.ndarray    # f32[n_leaf + n_sup, CLUSW] their leaves, then supers
    n_bclus: tuple       # (n_leaf, n_sup), and (NI, NJ) of a box grid
    med_dense: tuple     # per medium: the dense-medium walk serves it
    int_rec: np.ndarray  # f32[≤ MAX_INTERIOR, REC] the walk's interior rows
    int_kinds: tuple     # "sphere" / "moving" / "rect" / "box" per row

    @property
    def feats(self) -> int:
        """The kernel features (FEAT_* bits) this scene needs."""
        (has_checker, has_metal, has_diel, has_noise, has_image, dyn_moving,
         compat_uv, emis_tex, uv_carry, img_flip, med_tex) = self.flags
        return ((FEAT_SKY if self.background == BG_SKY else 0)
                | (FEAT_CHECKER if has_checker else 0)
                | (FEAT_METAL if has_metal else 0)
                | (FEAT_DIEL if has_diel else 0)
                | (FEAT_MOVING if dyn_moving or "moving" in self.kinds
                   else 0)
                | (FEAT_NOISE if has_noise else 0)
                | (FEAT_IMAGE if has_image else 0)
                | (FEAT_MEDIA if self.med_kinds else 0)
                | (FEAT_COMPAT_UV if compat_uv and has_image else 0)
                | (FEAT_DENSE_WALK if any(self.med_dense) else 0)
                | (FEAT_EMIS_TEX if emis_tex else 0)
                | (FEAT_UV_CARRY if uv_carry else 0)
                | (FEAT_IMG_FLIP if img_flip else 0)
                | (FEAT_MED_TEX if med_tex else 0))


def _merge_boxes(rec, kinds):
    """Collapse runs of 6 axis-aligned rects that tile a box (the
    reference's Cube, src/cube.rs:20-74) into single box rows
    (`pallas_tracer._merge_boxes`, line for line).

    A run merges when its six shading fields (R_FLIP onwards) are exactly
    equal, no face is image-textured (an image face needs its own UV
    frame), each face is a +axis rect, and the faces cover the three axes
    twice and span the box's extent. A box row keeps the REC layout: lo in
    R_C0..+3, hi in R_DC..+3, the columns before R_FLIP otherwise zero, the
    shading fields verbatim. Returns (box_rows f32[B, REC], member mask
    bool[P]).
    """
    P = len(kinds)
    member = np.zeros(P, bool)
    boxes = []
    tol = 1e-4

    def unit_axis(v):
        a = int(np.argmax(np.abs(v)))
        if abs(abs(v[a]) - 1.0) > 1e-6 or np.sum(np.abs(v)) > 1.0 + 1e-6:
            return None, 0.0
        return a, float(np.sign(v[a]))

    p = 0
    while p + 6 <= P:
        run = list(range(p, p + 6))
        if (any(kinds[q] != "rect" for q in run)
                or not np.array_equal(rec[run, R_FLIP:REC],
                                      np.broadcast_to(rec[p, R_FLIP:REC],
                                                      (6, REC - R_FLIP)))
                or rec[p, R_IMG] != 0.0):
            p += 1
            continue
        faces = {}   # k axis → plane offsets
        ok = True
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        planes = []
        for q in run:
            ka, ks = unit_axis(rec[q, R_KN:R_KN + 3])
            aa, _ = unit_axis(rec[q, R_AN:R_AN + 3])
            ba, _ = unit_axis(rec[q, R_BN:R_BN + 3])
            if ka is None or aa is None or ba is None or ks < 0:
                ok = False
                break
            koff = rec[q, R_KOFF] * ks
            a0 = rec[q, R_A0] + rec[q, R_AOFF]
            a1 = rec[q, R_A1] + rec[q, R_AOFF]
            b0 = rec[q, R_B0] + rec[q, R_BOFF]
            b1 = rec[q, R_B1] + rec[q, R_BOFF]
            faces.setdefault(ka, []).append(koff)
            planes.append((ka, aa, ba, a0, a1, b0, b1))
            lo[ka] = min(lo[ka], koff)
            hi[ka] = max(hi[ka], koff)
            lo[aa], hi[aa] = min(lo[aa], a0), max(hi[aa], a1)
            lo[ba], hi[ba] = min(lo[ba], b0), max(hi[ba], b1)
        ok = ok and sorted(faces) == [0, 1, 2] and all(
            len(v) == 2 for v in faces.values())
        ok = ok and all(
            abs(a0 - lo[aa]) <= tol and abs(a1 - hi[aa]) <= tol
            and abs(b0 - lo[ba]) <= tol and abs(b1 - hi[ba]) <= tol
            for _, aa, ba, a0, a1, b0, b1 in planes)
        if not ok:
            p += 1
            continue
        row = rec[p].copy()
        row[:R_FLIP] = 0.0
        row[R_C0:R_C0 + 3] = lo
        row[R_DC:R_DC + 3] = hi
        boxes.append(row)
        member[run] = True
        p += 6
    box_rows = (np.stack(boxes).astype(np.float32) if boxes
                else np.zeros((0, REC), np.float32))
    return box_rows, member


def _cluster_rows(rows, lo, hi, leaf):
    """Recursive median split on AABB centroids → two-level flat clusters
    (`pallas_tracer._cluster_rows`, line for line).

    Returns (rows reordered cluster-contiguously, table f32[L+S, 8],
    n_leaf, n_sup): rows [0, n_leaf) of the table are leaves (lo3, hi3,
    member_start, member_count), rows [n_leaf, n_leaf+n_sup) superclusters
    (lo3, hi3, leaf_start, leaf_count); n_sup == 0 when there are at most
    SUP_FANOUT leaves.
    """
    clusters = []
    supers = []
    order = []

    def split(idx):
        if len(idx) <= leaf:
            start = len(order)
            order.extend(idx.tolist())
            clo, chi = lo[idx].min(0), hi[idx].max(0)
            clusters.append([*clo, *chi, float(start), float(len(idx))])
            return
        cen = (lo[idx] + hi[idx]) * 0.5
        ax = int(np.argmax(cen.max(0) - cen.min(0)))
        ordax = np.argsort(cen[:, ax], kind="stable")
        half = len(idx) // 2
        split(idx[ordax[:half]])
        split(idx[ordax[half:]])

    def split_top(idx):
        if len(idx) <= leaf * SUP_FANOUT:
            first = len(clusters)
            split(idx)
            clo, chi = lo[idx].min(0), hi[idx].max(0)
            supers.append([*clo, *chi, float(first),
                           float(len(clusters) - first)])
            return
        cen = (lo[idx] + hi[idx]) * 0.5
        ax = int(np.argmax(cen.max(0) - cen.min(0)))
        ordax = np.argsort(cen[:, ax], kind="stable")
        half = len(idx) // 2
        split_top(idx[ordax[:half]])
        split_top(idx[ordax[half:]])

    if len(rows):
        split_top(np.arange(len(rows)))
    if len(clusters) <= SUP_FANOUT:
        supers = []
    table = clusters + supers
    return (rows[np.asarray(order, int)] if order else rows,
            np.asarray(table, np.float32) if table
            else np.zeros((1, CLUSW), np.float32),
            len(clusters), len(supers))


def _grid_cluster_rows(box_rows):
    """A regular NI×NJ box grid laid out for the strip pass
    (`pallas_tracer._grid_cluster_rows`, line for line), or None.

    final_scene's 400 ground boxes (reference tests/test.rs:424-438) are a
    20×20 grid: one y_lo, the x and z bounds on one pitch w, only the
    heights vary. The kernel's strip pass (csrc/tracer.cu, the box
    members of a grid) takes the y_lo plane once a segment and a leaf's x
    slab once a leaf; a member pays for its y_hi plane, its z entry and an
    incremental z exit. Returns (rows strip-major: x-major, z ascending;
    table f32[L + S, CLUSW]; n_leaf, n_sup, NI, NJ), or None when the
    boxes are no such grid: fewer than 16, a y_lo not shared, a pitch not
    one w in x and z to 1e-4·w, a cell taken twice, a z width that is not
    one f32 value w32, or a strip whose x planes are not each member's
    bit for bit. A leaf is a BOX_LEAF-member z segment of one strip (lo
    [x_i, y_lo, z_first], hi [x_i + w, max y_hi, z_last + w]); the supers
    group SUP_FANOUT leaves, even when there are no more leaves than that.
    """
    B = len(box_rows)
    if B < 16:
        return None
    lo = box_rows[:, R_C0:R_C0 + 3]
    hi = box_rows[:, R_DC:R_DC + 3]
    ylo = lo[0, 1]
    if not np.all(lo[:, 1] == ylo):
        return None
    xs = np.unique(lo[:, 0])
    zs = np.unique(lo[:, 2])
    ni, nj = len(xs), len(zs)
    if ni < 2 or nj < 2 or ni * nj != B:
        return None
    w = float(xs[1] - xs[0])
    if w <= 0:
        return None
    tol = 1e-4 * w
    if not (np.allclose(np.diff(xs), w, rtol=0, atol=tol)
            and np.allclose(np.diff(zs), w, rtol=0, atol=tol)
            and np.allclose(hi[:, 0] - lo[:, 0], w, rtol=0, atol=tol)
            and np.allclose(hi[:, 2] - lo[:, 2], w, rtol=0, atol=tol)):
        return None
    i_idx = np.rint((lo[:, 0] - xs[0]) / w).astype(int)
    j_idx = np.rint((lo[:, 2] - zs[0]) / w).astype(int)
    cells = i_idx * nj + j_idx
    if len(np.unique(cells)) != B:
        return None
    order = np.argsort(cells)
    rows = np.ascontiguousarray(box_rows[order])
    # the incremental z exit tz0 + w·inv_dz needs one f32 z width
    w32 = np.float32(rows[0, R_DC + 2] - rows[0, R_C0 + 2])
    if not np.all((rows[:, R_DC + 2] - rows[:, R_C0 + 2]) == w32):
        return None
    leaves = []
    for i in range(ni):
        strip = rows[i * nj:(i + 1) * nj]
        # the leaf's x slab stands for each member's: the same bits
        if (not np.all(strip[:, R_C0] == strip[0, R_C0])
                or not np.all(strip[:, R_DC] == strip[0, R_DC])):
            return None
        for s in range(0, nj, BOX_LEAF):
            seg = strip[s:s + BOX_LEAF]
            leaves.append(np.concatenate([
                [strip[0, R_C0], ylo, seg[0, R_C0 + 2]],
                [strip[0, R_DC], seg[:, R_DC + 1].max(),
                 seg[-1, R_DC + 2]],
                [i * nj + s, len(seg)]]))
    supers = []
    for s in range(0, len(leaves), SUP_FANOUT):
        grp = np.stack(leaves[s:s + SUP_FANOUT])
        supers.append(np.concatenate([
            grp[:, 0:3].min(0), grp[:, 3:6].max(0),
            [s, len(grp)]]))
    table = np.asarray(leaves + supers, np.float32)
    return rows, table, len(leaves), len(supers), ni, nj


def _texture_fields(tx, what, tex_type, tex_color, tex_child, tex_scale,
                    tex_image, image_hw, img_h) -> np.ndarray:
    """Texture tx as the kernel reads it → f32[TEXW] (T_* columns): a
    solid colour; a checker's even and odd colours (reference
    src/texture.rs:27-48, solid children only); a marble's scale
    (src/texture.rs:50-71); an image's atlas row base and true size
    (src/texture.rs:73-108). `what` names the owner in the nested-checker
    error."""
    out = np.zeros(TEXW, np.float32)
    tt = int(tex_type[tx])
    if tt == TEX_SOLID:
        out[T_ALB:T_ALB + 3] = tex_color[tx]
    elif tt == TEX_CHECKER:
        odd, even = tex_child[tx]
        if tex_type[odd] != TEX_SOLID or tex_type[even] != TEX_SOLID:
            raise UnsupportedScene(f"nested checker{what}")
        out[T_ALB:T_ALB + 3] = tex_color[even]
        out[T_ODD:T_ODD + 3] = tex_color[odd]
        out[T_CHK] = 1.0
    elif tt == TEX_NOISE:
        out[T_NOISE] = 1.0
        out[T_NSCALE] = tex_scale[tx]
    elif tt == TEX_IMAGE:
        img_id = int(tex_image[tx])
        out[T_IMG] = 1.0
        out[T_IMG_BASE] = float(img_id * img_h)
        out[T_IMG_H] = float(image_hw[img_id, 0])
        out[T_IMG_W] = float(image_hw[img_id, 1])
    else:
        raise UnsupportedScene(f"texture type {tt}{what} is not in the "
                               "kernel")
    return out


def build_scene_record(scene: SceneTables) -> SceneRecord:
    """Flatten SceneTables into the kernel's records (host side).

    The columns, the partition and the flags are those of
    `pallas_tracer.build_scene_record` at its defaults. A scene of at most
    UNROLL_BUDGET prims unrolls them all. A bigger one merges its cubes
    into box rows (`_merge_boxes`), unrolls the rects left over, its
    moving spheres when they fit beside them, and its "hero" spheres
    (radius ≥ 4× the median of the rest), and moves the other spheres into
    the dynamic table; the dynamic spheres are cluster-sorted with a leaf
    AABB table, and so are the boxes, unless they form a regular grid
    (`_grid_cluster_rows`: strip-major rows, z-segment leaves, n_bclus
    (n_leaf, n_sup, NI, NJ)), which the kernel's strip pass tests. Rect
    frame groups share the six ray·frame dot products of one plane frame.

    A light with a checker, noise or image texture fills the texture
    fields as an albedo would and keeps R_EMIT zero; the kernel emits the
    texture's value (pallas_tracer.py:650-660). Media of nonzero density
    fill the per-medium record (`M_*`, the boundary in object space, 1/ρ,
    the world→object rotation and offset, the solid or textured albedo);
    image textures, the media's included, fill the texel atlas. A medium
    is served by the dense-medium walk (pallas_tracer.py:889-987) when its
    mean free path is short (4/ρ under its extent), a coincident
    unrotated sphere seals it, at most MAX_INTERIOR unrolled, dynamic and
    box rows overlap the AABB of the dense media (the interior set), and
    no medium of the scene is textured (935-940).

    Raises UnsupportedScene for what the JAX kernel does not cover either,
    each with its own reason: isotropic surfaces, nested checkers (of a
    surface or a medium), image textures on rotated spheres, images that
    are not 8-bit exact, more than MAX_MEDIA media, and more than
    UNROLL_BUDGET rects that form no box in a scene of more than
    UNROLL_BUDGET prims.
    """
    scene = scene.to("cpu")
    P = scene.num_prims
    pk = pack_prims(scene)
    pk = {k: v.numpy() for k, v in vars(pk).items()}
    ptype = scene.prim_type.numpy()
    prim_mat = scene.prim_material.numpy()
    prim_flip = scene.prim_flip.numpy()
    prim_xf = scene.prim_xform.numpy()
    xf_axis = scene.xf_axis.numpy()
    xf_sin = scene.xf_sin.numpy()
    xf_cos = scene.xf_cos.numpy()
    xf_off = scene.xf_offset.numpy()
    mat_type = scene.mat_type.numpy()
    mat_param = scene.mat_param.numpy()
    mat_tex = scene.mat_texture.numpy()
    tex_type = scene.tex_type.numpy()
    tex_color = scene.tex_color.numpy()
    tex_child = scene.tex_child.numpy()
    tex_scale = scene.tex_scale.numpy()
    tex_image = scene.tex_image.numpy()
    image_hw = scene.image_hw.numpy()
    img_h = scene.images.shape[1]

    rec = np.zeros((P, REC), np.float32)
    kinds = []
    emis_tex = False   # a light with a checker, noise or image texture
    for p in range(P):
        if ptype[p] == PRIM_RECT:
            kinds.append("rect")
        elif ptype[p] == PRIM_MOVING_SPHERE:
            kinds.append("moving")
        else:
            kinds.append("sphere")
        rec[p, R_IS_SPHERE] = 0.0 if kinds[-1] == "rect" else 1.0
        rec[p, R_C0:R_C0 + 3] = pk["c0"][p]
        rec[p, R_DC:R_DC + 3] = pk["dc"][p]
        rec[p, R_T0] = pk["t0"][p]
        rec[p, R_INV_DT] = pk["inv_dt"][p]
        rec[p, R_RADIUS] = pk["radius"][p]
        rec[p, R_R2] = pk["r2"][p]
        rec[p, R_KN:R_KN + 3] = pk["kn"][p]
        rec[p, R_AN:R_AN + 3] = pk["an"][p]
        rec[p, R_BN:R_BN + 3] = pk["bn"][p]
        rec[p, R_KOFF] = pk["k_off"][p]
        rec[p, R_AOFF] = pk["a_off"][p]
        rec[p, R_BOFF] = pk["b_off"][p]
        rec[p, R_A0] = pk["a0"][p]
        rec[p, R_A1] = pk["a1"][p]
        rec[p, R_B0] = pk["b0"][p]
        rec[p, R_B1] = pk["b1"][p]
        rec[p, R_FLIP] = prim_flip[p]

        m = prim_mat[p]
        mt = int(mat_type[m])
        if mt not in (MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC,
                      MAT_DIFFUSE_LIGHT):
            raise UnsupportedScene(
                f"material type {mt} is not in the kernel yet")
        rec[p, R_MAT] = float(mt)
        rec[p, R_PARAM] = mat_param[m]
        tx = mat_tex[m]
        tt = int(tex_type[tx])
        if tt == TEX_SOLID and mt == MAT_DIFFUSE_LIGHT:
            # a solid light keeps the cheap path: its colour in R_EMIT
            rec[p, R_EMIT:R_EMIT + 3] = tex_color[tx]
        else:
            if tt == TEX_IMAGE and kinds[-1] != "rect":
                # a sphere's image UV comes from its world normal (the
                # pre-flip one of a flipped sphere): unrotated spheres only.
                # A rect's UV comes from its world frame, rotated or not
                xf = prim_xf[p]
                if xf_sin[xf] != 0.0 or xf_cos[xf] != 1.0:
                    raise UnsupportedScene("image texture on a rotated "
                                           "sphere")
            # the albedo, or a textured light's emission (reference
            # src/material.rs:133-151): the texture's fields
            rec[p, R_ALB_EVEN:R_ALB_EVEN + TEXW] = _texture_fields(
                tx, "", tex_type, tex_color, tex_child, tex_scale,
                tex_image, image_hw, img_h)
            emis_tex |= mt == MAT_DIFFUSE_LIGHT

    # media (reference src/medium.rs: ConstantMedium with a convex boundary,
    # possibly under Traslate∘Rotate), pallas_tracer.py:698-760
    med_density = scene.med_density.numpy()
    live = [m for m in range(scene.num_media)
            if float(med_density[m]) != 0.0]
    if len(live) > MAX_MEDIA:
        raise UnsupportedScene(f"{len(live)} media: the kernel holds at most "
                               f"{MAX_MEDIA}")
    med_type = scene.med_type.numpy()
    med_data = scene.med_data.numpy()
    med_material = scene.med_material.numpy()
    med_xform = scene.med_xform.numpy()
    med_rec = np.zeros((len(live), MEDREC), np.float32)
    med_kinds = []
    for i, m in enumerate(live):
        if med_type[m] == MED_SPHERE:
            med_kinds.append("msphere")
            med_rec[i, M_DATA:M_DATA + 3] = med_data[m, 0:3]
            med_rec[i, M_DATA + 3] = med_data[m, 3] ** 2
        else:
            med_kinds.append("mbox")
            med_rec[i, M_DATA:M_DATA + 6] = med_data[m, 0:6]
        med_rec[i, M_INV_RHO] = 1.0 / med_density[m]
        # world→object rotation R₋ (reference src/rotate.rs:87-97): about
        # axis r with (a, b) = ((r+1)%3, (r+2)%3), out[a] = c·v[a] + s·v[b],
        # out[b] = −s·v[a] + c·v[b], out[r] = v[r]
        xf = med_xform[m]
        ax, sn, cs = int(xf_axis[xf]), float(xf_sin[xf]), float(xf_cos[xf])
        a, b = (ax + 1) % 3, (ax + 2) % 3
        rot = np.zeros((3, 3), np.float32)
        rot[ax, ax] = 1.0
        rot[a, a], rot[a, b] = cs, sn
        rot[b, a], rot[b, b] = -sn, cs
        med_rec[i, M_ROT:M_ROT + 9] = rot.reshape(-1)
        med_rec[i, M_OFF:M_OFF + 3] = xf_off[xf]
        # the isotropic albedo, solid or textured (reference
        # src/material.rs:153-173)
        med_rec[i, M_ALB:M_ALB + TEXW] = _texture_fields(
            mat_tex[med_material[m]], " (medium albedo)", tex_type,
            tex_color, tex_child, tex_scale, tex_image, image_hw, img_h)

    # the scene's textures, the media's included (pallas_tracer.py:761-770)
    med_tex = bool(np.any(med_rec[:, [M_CHK, M_NOISE, M_IMG]] > 0))
    flags = (bool(np.any(rec[:, R_CHECKER] > 0)
                  or np.any(med_rec[:, M_CHK] > 0)),
             bool(np.any(rec[:, R_MAT] == MAT_METAL)),
             bool(np.any(rec[:, R_MAT] == MAT_DIELECTRIC)),
             bool(np.any(rec[:, R_NOISE] > 0)
                  or np.any(med_rec[:, M_NOISE] > 0)),
             bool(np.any(rec[:, R_IMG] > 0) or np.any(med_rec[:, M_IMG] > 0)))

    # the texel atlas, one int32 r<<16 | g<<8 | b per texel
    # (pallas_tracer.py:772-791): images are stored as f32(u8 / 255), and
    # the exact u8 round trip keeps the kernel's texels bit-identical to the
    # tables'. It lives in device memory: no size cap.
    atlas = np.zeros((0, 0), np.int32)
    if flags[4]:
        pix = scene.images.numpy()                          # [I, H, W, 3]
        q = np.clip(np.rint(pix * 255.0), 0, 255).astype(np.int32)
        if not np.array_equal(q.astype(np.float32) / np.float32(255.0), pix):
            raise UnsupportedScene("image texture is not 8-bit exact")
        n_img, h, w, _ = q.shape
        atlas = np.ascontiguousarray(
            ((q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2])
            .reshape(n_img * h, w))

    # partition (pallas_tracer.py:793-868): small scenes unroll everything;
    # big ones merge cubes into boxes, unroll the rects left over, movers
    # (when they fit) and heroes, and run the other spheres and the boxes
    # through cluster-culled dynamic loops
    dyn_rec = np.zeros((0, REC), np.float32)
    sclus = np.zeros((1, CLUSW), np.float32)
    n_sclus = (0, 0)
    box_rec = np.zeros((0, REC), np.float32)
    bclus = np.zeros((1, CLUSW), np.float32)
    n_bclus = (0, 0)
    if P > UNROLL_BUDGET:
        is_rect = np.array([k == "rect" for k in kinds])
        box_rows, in_box = _merge_boxes(rec, kinds)
        rect_left = is_rect & ~in_box
        if int(rect_left.sum()) > UNROLL_BUDGET:
            raise UnsupportedScene(
                f"{int(rect_left.sum())} rects that form no box in a scene "
                f"of {P} prims exceed the unroll budget of {UNROLL_BUDGET}")
        # movers prefer the unroll, all or none (pallas_tracer.py:812-820)
        is_moving = np.array([k == "moving" for k in kinds])
        keep = rect_left
        if int(rect_left.sum() + is_moving.sum()) <= UNROLL_BUDGET:
            keep = rect_left | is_moving
        sph_left = ~is_rect & ~keep
        if sph_left.any():
            radii = rec[:, R_RADIUS]
            med_r = float(np.median(radii[sph_left]))
            hero = sph_left & (radii >= 4.0 * max(med_r, 1e-20))
            room = UNROLL_BUDGET - int(keep.sum())
            if int(hero.sum()) > room:   # keep only the largest that fit
                order = np.argsort(-radii * hero)
                hero = np.zeros_like(hero)
                hero[order[:room]] = radii[order[:room]] > 0
                hero &= sph_left
            keep = keep | hero
        # dynamic spheres, cluster-sorted; AABB = swept center ± r
        sph = rec[~is_rect & ~keep]
        if len(sph):
            c0 = sph[:, R_C0:R_C0 + 3]
            c1 = c0 + sph[:, R_DC:R_DC + 3]
            r_ = sph[:, R_RADIUS:R_RADIUS + 1]
            dyn_rec, sclus, *n_sclus = _cluster_rows(
                np.ascontiguousarray(sph), np.minimum(c0, c1) - r_,
                np.maximum(c0, c1) + r_, SPH_LEAF)
            n_sclus = tuple(n_sclus)
        if len(box_rows):
            # a regular grid takes the strip layout, n_bclus (n_leaf,
            # n_sup, NI, NJ) (pallas_tracer.py:853-864)
            g = _grid_cluster_rows(box_rows)
            if g is None:
                g = _cluster_rows(box_rows, box_rows[:, R_C0:R_C0 + 3],
                                  box_rows[:, R_DC:R_DC + 3], BOX_LEAF)
            box_rec, bclus, *n_bclus = g
            n_bclus = tuple(n_bclus)
        rec = np.ascontiguousarray(rec[keep])
        kinds = [k for i, k in enumerate(kinds) if keep[i]]
        if not kinds:   # the kernel's record needs at least one row
            rec = np.zeros((1, REC), np.float32)
    # the lattice corners (pallas_tracer.py:875-887): a UV other than a
    # sphere's (an image rect, always unrolled, or an image medium), an
    # image on a flipped prim of any table
    all_rows = np.concatenate([rec, dyn_rec, box_rec])
    uv_carry = bool(any(k == "rect" and rec[i, R_IMG] > 0
                        for i, k in enumerate(kinds))
                    or np.any(med_rec[:, M_IMG] > 0))
    img_flip = bool(np.any((all_rows[:, R_IMG] > 0)
                           & (all_rows[:, R_FLIP] < 0)))
    flags += (bool(len(dyn_rec) and np.any(dyn_rec[:, R_INV_DT] != 0.0)),
              bool(scene.compat_uv_bug), emis_tex, uv_carry, img_flip,
              med_tex)
    med_dense, int_rec, int_kinds = _dense_media(
        med_rec, med_kinds,
        [(rec[i], k) for i, k in enumerate(kinds)]
        + [(r, "moving" if r[R_INV_DT] != 0.0 else "sphere") for r in dyn_rec]
        + [(r, "box") for r in box_rec], med_tex)

    groups = {}
    for i, k in enumerate(kinds):
        if k == "rect":
            key = tuple(np.round(rec[i, R_KN:R_BN + 3], 5).tolist())
            groups.setdefault(key, []).append(i)
    rect_groups = tuple(tuple(g) for g in groups.values())
    return SceneRecord(rec, tuple(kinds), rect_groups, dyn_rec, sclus,
                       n_sclus, flags, int(scene.background), med_rec,
                       tuple(med_kinds), atlas, int(scene.perlin_seed),
                       box_rec, bclus, n_bclus, med_dense, int_rec, int_kinds)


def _row_aabb(row, kind):
    """World AABB of a record row (pallas_tracer.py:897-913): a sphere's
    swept center ± |r|, a box's lo/hi, a rect's four corners ± 1e-4."""
    if kind in ("sphere", "moving"):
        c0 = row[R_C0:R_C0 + 3]
        c1 = c0 + row[R_DC:R_DC + 3]
        r = abs(row[R_RADIUS])
        return np.minimum(c0, c1) - r, np.maximum(c0, c1) + r
    if kind == "box":
        return row[R_C0:R_C0 + 3].copy(), row[R_DC:R_DC + 3].copy()
    kn, an, bn = row[R_KN:R_KN + 3], row[R_AN:R_AN + 3], row[R_BN:R_BN + 3]
    pts = np.stack([(a + row[R_AOFF]) * an + (b + row[R_BOFF]) * bn
                    + row[R_KOFF] * kn
                    for a in (row[R_A0], row[R_A1])
                    for b in (row[R_B0], row[R_B1])])
    return pts.min(0) - 1e-4, pts.max(0) + 1e-4


def _dense_media(med_rec, med_kinds, cand, med_tex):
    """The dense-medium walk's host analysis (pallas_tracer.py:889-987) →
    (dense flag per medium, interior rows f32[n, REC], their kinds).

    A medium is dense when 4·(1/ρ) is under its extent (a sphere's
    diameter, a box's shortest side). The walk is sound only where a
    coincident, unrotated sphere among the candidate rows `cand` ((row,
    kind) of the unrolled, dynamic and box tables) seals the medium, so
    an unsealed dense medium stays on the event path. The interior set is
    every candidate whose AABB overlaps a dense medium's world AABB (the
    rotated object-space corners); above MAX_INTERIOR rows it is dropped
    and every medium takes the event path. In a scene with a textured
    medium (med_tex) no medium walks (935-940): the walk multiplies by a
    solid albedo.
    """
    dense, aabbs = [], []
    for i, mk in enumerate(med_kinds):
        rot = med_rec[i, M_ROT:M_ROT + 9].reshape(3, 3)
        off = med_rec[i, M_OFF:M_OFF + 3]
        if mk == "msphere":
            c = med_rec[i, M_DATA:M_DATA + 3]
            r = float(np.sqrt(med_rec[i, M_DATA + 3]))
            olo, ohi = c - r, c + r
            extent = 2.0 * r
        else:
            olo, ohi = (med_rec[i, M_DATA:M_DATA + 3],
                        med_rec[i, M_DATA + 3:M_DATA + 6])
            extent = float((ohi - olo).min())
        corners = np.stack([
            rot.T @ np.array([(olo, ohi)[a][0], (olo, ohi)[b][1],
                              (olo, ohi)[c_][2]]) + off
            for a in (0, 1) for b in (0, 1) for c_ in (0, 1)])
        aabbs.append((corners.min(0), corners.max(0)))
        is_dense = bool(4.0 * med_rec[i, M_INV_RHO] < extent) and not med_tex
        sealed = False
        if is_dense and mk == "msphere" and np.allclose(rot, np.eye(3),
                                                        atol=1e-6):
            cw = med_rec[i, M_DATA:M_DATA + 3] + off
            sealed = any(
                k == "sphere"
                and np.allclose(row[R_C0:R_C0 + 3], cw,
                                atol=1e-3 * max(r, 1.0))
                and abs(row[R_RADIUS] - r) < 1e-3 * r
                for row, k in cand)
        dense.append(is_dense and sealed)
    int_rows, int_kinds = [], []
    if any(dense):
        for row, k in cand:
            plo, phi = _row_aabb(row, k)
            if any(d and (plo <= mhi).all() and (mlo <= phi).all()
                   for d, (mlo, mhi) in zip(dense, aabbs)):
                int_rows.append(row)
                int_kinds.append(k)
        if len(int_rows) > MAX_INTERIOR:
            int_rows, int_kinds = [], []
    if not int_rows:
        dense = [False] * len(dense)
    int_rec = (np.stack(int_rows).astype(np.float32) if int_rows
               else np.zeros((0, REC), np.float32))
    return tuple(dense), int_rec, tuple(int_kinds)


def build_camera_record(cam: Camera) -> np.ndarray:
    """Camera → f32[CAMREC] scalar record (the JAX kernel's layout)."""
    cam = cam.to("cpu")
    rec = np.zeros(CAMREC, np.float32)
    rec[C_ORIGIN:C_ORIGIN + 3] = cam.origin.numpy()
    rec[C_LL:C_LL + 3] = cam.lower_left.numpy()
    rec[C_HORIZ:C_HORIZ + 3] = cam.horizontal.numpy()
    rec[C_VERT:C_VERT + 3] = cam.vertical.numpy()
    rec[C_U:C_U + 3] = cam.u.numpy()
    rec[C_V:C_V + 3] = cam.v.numpy()
    rec[C_LENS_R] = float(cam.lens_radius)
    rec[C_TIME0] = float(cam.time0)
    rec[C_DTIME] = float(cam.time1) - float(cam.time0)
    return rec


def walk_table(kinds, rect_groups) -> np.ndarray:
    """The order in which the tracers test the unrolled prims → int32[2, K].

    Row 0 is the record row of each step: the spheres in record order,
    then the rects group by group, which is the JAX kernel's order (its
    closest-hit takes the first strict minimum, so the order decides
    ties). Row 1 is the row whose plane frame a rect is tested in (its
    group's first rect), or -1 for a sphere.
    """
    order = [p for p, k in enumerate(kinds) if k != "rect"]
    lead = [-1] * len(order)
    for g in rect_groups:
        order += list(g)
        lead += [g[0]] * len(g)
    return np.asarray([order, lead], np.int32)


@dataclass(frozen=True)
class TraceOperands:
    """What `trace` reads of a scene and camera, on one device."""
    rec: torch.Tensor     # f32[P, REC] unrolled prims, 1 ≤ P ≤ UNROLL_BUDGET
    walk: torch.Tensor    # int32[2, K] walk_table over rec, K ≤ P
    dyn: torch.Tensor     # f32[n_dyn, REC] dynamic spheres in cluster order
    leaves: torch.Tensor  # f32[n_leaf, CLUSW] their leaves; none: no cull
    sups: torch.Tensor    # f32[n_sup, CLUSW] the leaves' super rows (lo3,
                          # hi3, first leaf, leaf count); none: one level
    cam: torch.Tensor     # f32[CAMREC]
    feats: int            # FEAT_* bits
    med: torch.Tensor     # f32[M, MEDREC] media, M ≤ MAX_MEDIA
    med_box: int          # bit i set: medium i has a box boundary, else a sphere
    atlas: torch.Tensor   # int32[rows, W] packed texels
    perlin_seed: int
    box: torch.Tensor     # f32[n_box, REC] boxes in cluster order
    bleaves: torch.Tensor  # f32[n_bleaf, CLUSW] their leaves; none: no cull
    bsups: torch.Tensor   # f32[n_bsup, CLUSW] the box leaves' super rows
    interior: torch.Tensor  # f32[n_int ≤ MAX_INTERIOR, REC] the walk's rows
    interior_kind: torch.Tensor  # int32[n_int] INT_SPHERE / INT_RECT / INT_BOX
    dense: int            # bit i set: medium i is served by the walk
    rr_depth: int = -1    # the first bounce of Russian roulette; -1: none
                          # (FEAT_RR is set exactly when it is ≥ 0)
    grid: tuple = ()      # (NI, NJ, y_lo, w32): the boxes are a regular grid
                          # in strip layout (`_grid_cluster_rows`), tested
                          # by the strip pass; (): none

    def __post_init__(self):
        self._check_grid()
        # the kernel visits a super's leaves as one ascending range, so the
        # ranges must tile [0, n_leaf) once, in order (unread without
        # leaves). The check reads the rows on the host, so it runs once,
        # when the operands are made, not at every launch; rows of a dtype,
        # width or device `trace` refuses are left to its checks.
        for name, sups, leaves in (("sups", self.sups, self.leaves),
                                   ("bsups", self.bsups, self.bleaves)):
            if not (sups.dim() == 2 and sups.shape[0] and leaves.shape[0]
                    and sups.shape[1] == CLUSW
                    and sups.device.type in ("cpu", "cuda")):
                continue
            first, cnt = sups[:, 6:8].double().cpu().unbind(1)
            if not (torch.equal(first, torch.cumsum(cnt, 0) - cnt)
                    and bool((cnt >= 1).all() & (cnt == cnt.floor()).all())
                    and cnt.sum() == leaves.shape[0]):
                raise ValueError(f"{name}' leaf ranges do not tile [0, "
                                 f"{leaves.shape[0]}) in ascending order")

    def _check_grid(self):
        """A grid spec must describe the box table as the strip pass reads
        it (it has no generic fallback): NI·NJ rows, each with the shared
        y_lo and the z width w32 in f32, and each leaf's x planes the bits
        of its members'. Read on the host, once, like the super rows."""
        if not self.grid:
            return
        if len(self.grid) != 4:
            raise ValueError(f"grid must be (NI, NJ, y_lo, w32), got "
                             f"{self.grid}")
        ni, nj, ylo, w32 = self.grid
        box, leaves = self.box, self.bleaves
        if not (box.dim() == 2 and box.shape[1] == REC
                and box.dtype == torch.float32 and leaves.dim() == 2
                and leaves.shape[1] == CLUSW
                and leaves.dtype == torch.float32):
            return   # `trace` refuses these rows
        if ni * nj != box.shape[0] or not w32 > 0.0:
            raise ValueError(f"grid {ni}×{nj} with pitch {w32} does not "
                             f"describe {box.shape[0]} box rows")
        b = box.cpu()
        if not (bool((b[:, R_C0 + 1] == ylo).all())
                and bool((b[:, R_DC + 2] - b[:, R_C0 + 2] == w32).all())):
            raise ValueError("a box of the grid has another y_lo or z width "
                             "than the grid's")
        for lf in leaves.cpu().tolist():
            m = b[int(lf[6]):int(lf[6]) + int(lf[7])]
            if not (bool((m[:, R_C0] == lf[0]).all())
                    and bool((m[:, R_DC] == lf[3]).all())):
                raise ValueError("a grid leaf's x planes are not its "
                                 "members' own")


def trace_operands(srec: SceneRecord, cam_rec: np.ndarray, device,
                   rr_depth: int | None = None) -> TraceOperands:
    """The records of `build_scene_record` and `build_camera_record` as
    `trace` operands on `device`. rr_depth: the bounce from which paths
    play Russian roulette (pallas_tracer.py:2492-2506), or None; roulette
    turns the dense-medium walk off (2540-2542), whose bounces would skip
    its draws."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kind = {"sphere": INT_SPHERE, "moving": INT_SPHERE, "rect": INT_RECT,
            "box": INT_BOX}
    feats = srec.feats
    if rr_depth is not None:
        if rr_depth < 0:
            raise ValueError(f"rr_depth {rr_depth} is negative")
        feats = (feats | FEAT_RR) & ~FEAT_DENSE_WALK
    (n_leaf, n_sup), (n_bleaf, n_bsup) = srec.n_sclus, srec.n_bclus[:2]
    grid = ()
    if len(srec.n_bclus) == 4:
        b = srec.box_rec
        grid = (*srec.n_bclus[2:], float(b[0, R_C0 + 1]),
                float(np.float32(b[0, R_DC + 2] - b[0, R_C0 + 2])))
    return TraceOperands(
        rec=put(srec.rec), walk=put(walk_table(srec.kinds, srec.rect_groups)),
        dyn=put(srec.dyn_rec), leaves=put(srec.sclus[:n_leaf]),
        sups=put(srec.sclus[n_leaf:n_leaf + n_sup]),
        cam=put(cam_rec), feats=feats, med=put(srec.med_rec),
        med_box=sum(1 << i for i, k in enumerate(srec.med_kinds)
                    if k == "mbox"),
        atlas=put(srec.atlas), perlin_seed=srec.perlin_seed,
        box=put(srec.box_rec), bleaves=put(srec.bclus[:n_bleaf]),
        bsups=put(srec.bclus[n_bleaf:n_bleaf + n_bsup]),
        interior=put(srec.int_rec),
        interior_kind=put(np.asarray([kind[k] for k in srec.int_kinds],
                                     np.int32)),
        dense=sum(1 << i for i, d in enumerate(srec.med_dense) if d),
        rr_depth=-1 if rr_depth is None else int(rr_depth), grid=grid)


def _sphere_center(r, time, moving: bool):
    """A sphere's center at each lane's time (reference src/sphere.rs:
    115-118). For a static sphere (dc = 0, inv_dt = 0) the lerp returns c0
    exactly, so one form serves both."""
    if not moving:
        return r[R_C0], r[R_C0 + 1], r[R_C0 + 2]
    frac = (time - r[R_T0]) * r[R_INV_DT]
    return tuple(r[R_C0 + a] + frac * r[R_DC + a] for a in range(3))


def _media_events(med_box: int, med_table, o, d, a_dd, inv_a, t_cap,
                  draw, counts: dict | None = None):
    """Nearest constant-density medium scatter event on [T_MIN, t_cap]
    (pallas_tracer.py `media_events`, 1431-1525; reference
    src/medium.rs:28-56) → (t (BIG where none), winning medium, -1 where
    none). counts, when given, gathers under "med_open" the (lane, medium)
    pairs whose clamped interval is open.

    Each medium's boundary is entered and left on the ray's infinite line
    (sphere roots, or slabs in object space after the world→object
    rotation and offset), the interval is clamped to [T_MIN, t_cap], and
    the free flight −(1/ρ)·ln u is drawn from medium i's slot of the
    MEDIUM streams (`draw(stream)` → four uniforms). The first strict
    minimum wins.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    d_len = torch.sqrt(a_dd)
    inv_dlen = 1.0 / d_len
    t_med = torch.full_like(dx, BIG)
    m_win = torch.full(dx.shape, -1, dtype=torch.int64, device=dx.device)
    for i, m in enumerate(med_table):
        if i % 4 == 0:
            words = draw(rng.STREAM_MEDIUM + i // 4)
        wx, wy, wz = ox - m[M_OFF], oy - m[M_OFF + 1], oz - m[M_OFF + 2]
        r = m[M_ROT:M_ROT + 9]
        o0 = [r[3 * k] * wx + r[3 * k + 1] * wy + r[3 * k + 2] * wz
              for k in range(3)]
        d0 = [r[3 * k] * dx + r[3 * k + 1] * dy + r[3 * k + 2] * dz
              for k in range(3)]
        if med_box >> i & 1:
            # slabs; a tiny direction component is replaced by +1e-30 so a
            # parallel ray stays finite (pallas_tracer.py:1480-1498)
            sd = [torch.where(torch.abs(c) < 1e-30, 1e-30, c) for c in d0]
            lo = [(m[M_DATA + k] - o0[k]) / sd[k] for k in range(3)]
            hi = [(m[M_DATA + 3 + k] - o0[k]) / sd[k] for k in range(3)]
            enter = torch.maximum(
                torch.maximum(torch.minimum(lo[0], hi[0]),
                              torch.minimum(lo[1], hi[1])),
                torch.minimum(lo[2], hi[2]))
            exit_ = torch.minimum(
                torch.minimum(torch.maximum(lo[0], hi[0]),
                              torch.maximum(lo[1], hi[1])),
                torch.maximum(lo[2], hi[2]))
            ok = enter < exit_
        else:
            oc = [o0[k] - m[M_DATA + k] for k in range(3)]
            bq = oc[0] * d0[0] + oc[1] * d0[1] + oc[2] * d0[2]
            cq = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - m[M_DATA + 3]
            disc = bq * bq - a_dd * cq
            ok = disc > 0.0
            sq = torch.sqrt(torch.where(ok, disc, 1.0))
            enter = (-bq - sq) * inv_a
            exit_ = (-bq + sq) * inv_a
        enter = torch.clamp(enter, min=T_MIN)
        exit_ = torch.minimum(exit_, t_cap)
        ok = ok & (enter < exit_)
        if counts is not None:
            counts["med_open"] += int(ok.sum())
        flight = -m[M_INV_RHO] * rng.lanewise(
            torch.log, torch.clamp(words[i % 4], min=1e-37))
        scat = ok & (flight < (exit_ - enter) * d_len)
        t_i = torch.where(scat, enter + flight * inv_dlen, BIG)
        better = t_i < t_med
        t_med = torch.where(better, t_i, t_med)
        m_win = torch.where(better, i, m_win)
    return t_med, m_win


def sphere_uv(nx, ny, nz, compat_uv: bool = False):
    """Sphere UV of unit normals (reference src/sphere.rs:7-15,
    pallas_tracer.py:2318-2324): u = 1 − (φ + π)/(2π), v = (θ + π/2)/π with
    φ = atan2(z, x), θ = asin(y); under compat_uv the reference's 2/π takes
    π/2's place."""
    phi = rng.lanewise(torch.atan2, nz, nx)
    theta = rng.lanewise(torch.asin, torch.clamp(ny, -1.0, 1.0))
    uu = 1.0 - (phi + PI) * INV_2PI
    vv = (theta + (TWO_OVER_PI if compat_uv else HALF_PI)) * INV_PI
    return uu, vv


def texel_rgb(atlas, base, h, w, uu, vv):
    """Nearest texel (reference src/texture.rs:86-108, pallas_tracer.py:
    2329-2357) of the image whose rows start at atlas row `base`, of true
    size h × w (f32 per lane): column ⌊u·w⌋ and v-flipped row ⌊(1 − v)·h⌋,
    each clamped to the image, then r, g, b = u8 / 255."""
    ii = torch.minimum(torch.clamp((uu * w).to(torch.int64), min=0),
                       w.to(torch.int64) - 1)
    jj = torch.minimum(torch.clamp(((1.0 - vv) * h).to(torch.int64), min=0),
                       h.to(torch.int64) - 1)
    rows, width = atlas.shape
    jrow = torch.clamp(base.to(torch.int64) + jj, 0, rows - 1)
    packed = atlas[jrow, torch.clamp(ii, 0, width - 1)]
    # a device divisor: see the camera's division in trace_plain
    d255 = torch.tensor(255.0, device=packed.device)
    return [((packed >> sh) & 255).to(torch.float32) / d255
            for sh in (16, 8, 0)]


def rect_uv(o, d, t, rows):
    """The image UV of rect hits o + t·d (reference src/rect.rs:53-60, as
    ops/intersect.py hit_attributes takes it in the world frame) of the
    record rows `rows` (f32[n, REC]): ((xa − A0)·(1/(A1 − A0)),
    (yb − B0)·(1/(B1 − B0))), xa = o·an + t·(d·an) − a_off and yb alike,
    each in the closest-hit loop's op order (pallas_tracer.py:1719-1735),
    in the row's own frame. o, d: three f32[n]; t: f32[n]."""
    def coord(ax, off):
        an = [rows[:, ax + a] for a in range(3)]
        return ((o[0] * an[0] + o[1] * an[1] + o[2] * an[2])
                + t * (d[0] * an[0] + d[1] * an[1] + d[2] * an[2])
                - rows[:, off])
    uu = ((coord(R_AN, R_AOFF) - rows[:, R_A0])
          * (1.0 / (rows[:, R_A1] - rows[:, R_A0])))
    vv = ((coord(R_BN, R_BOFF) - rows[:, R_B0])
          * (1.0 / (rows[:, R_B1] - rows[:, R_B0])))
    return uu, vv


def texture_rgb(tex, p, sel, uv_of, atlas, perlin_seed, *, checker: bool,
                noise: bool, image: bool, counts=None):
    """The value of each lane's texture (tex f32[n, TEXW], T_* columns) at
    the point p (three f32[n]) → [r, g, b] f32[n], in the kernel's order:
    the colour; where a checker's sin(10x)·sin(10y)·sin(10z) < 0 its odd
    colour (reference src/texture.rs:40-47); the marble 0.5·(1 + sin(scale·x
    + 5·turb(p))) (66-70); the nearest texel at uv_of(lanes) → (u, v)
    (86-108). The marble and the texel are evaluated on the lanes of sel
    only. checker, noise, image: the scene holds such textures. counts:
    see trace_plain."""
    alb = [tex[:, T_ALB + c] for c in range(3)]
    if checker:
        sines = (rng.lanewise(torch.sin, 10.0 * p[0])
                 * rng.lanewise(torch.sin, 10.0 * p[1])
                 * rng.lanewise(torch.sin, 10.0 * p[2]))
        odd = (sines < 0.0) & (tex[:, T_CHK] > 0.0)
        alb = [torch.where(odd, tex[:, T_ODD + c], alb[c]) for c in range(3)]
    if noise:
        use = sel & (tex[:, T_NOISE] > 0.0)
        idx = torch.nonzero(use).squeeze(1)
        if counts is not None:
            counts["noise"] += idx.numel()
        qx, qy, qz = (p[a][idx] for a in range(3))
        turb = perlin.turb3(qx, qy, qz, perlin_seed)
        marble = torch.zeros_like(p[0])
        marble[idx] = 0.5 * (1.0 + rng.lanewise(
            torch.sin, tex[idx, T_NSCALE] * qx + 5.0 * turb))
        alb = [torch.where(use, marble, alb[c]) for c in range(3)]
    if image:
        use = sel & (tex[:, T_IMG] > 0.0)
        idx = torch.nonzero(use).squeeze(1)
        if counts is not None:
            counts["image"] += idx.numel()
        ti = tex[idx]
        rgb = texel_rgb(atlas, ti[:, T_IMG_BASE], ti[:, T_IMG_H],
                        ti[:, T_IMG_W], *uv_of(idx))
        for c in range(3):
            full = torch.zeros_like(p[0])
            full[idx] = rgb[c]
            alb[c] = torch.where(use, full, alb[c])
    return alb


def _safe_inv(c):
    """Reciprocal direction for slab tests (pallas_tracer.py `_safe_inv`,
    1368-1376; csrc/tracer.cu `safe_inv`): an exact-zero component gets a
    huge signed inverse, so a parallel ray outside a slab misses and one
    inside passes."""
    return torch.where(torch.abs(c) < 1e-30,
                       torch.where(c >= 0.0, 1e30, -1e30), 1.0 / c)


def _slab(lo, hi, o, inv_d):
    """Entry and exit t of rays against axis-aligned boxes, in the kernel's
    order (x, then y, then z); lo, hi: three per-axis box bounds and o,
    inv_d: three per-axis ray values, broadcastable."""
    tmn = tmx = None
    for a in range(3):
        t0 = (lo[a] - o[a]) * inv_d[a]
        t1 = (hi[a] - o[a]) * inv_d[a]
        if tmn is None:
            tmn, tmx = torch.minimum(t0, t1), torch.maximum(t0, t1)
        else:
            tmn = torch.maximum(tmn, torch.minimum(t0, t1))
            tmx = torch.minimum(tmx, torch.maximum(t0, t1))
    return tmn, tmx


def _box_t(lo, hi, o, inv_d, slab=False):
    """A box's hit t (reference src/cube.rs through the slab test): the
    entry face when it lies beyond T_MIN, else the exit face
    (pallas_tracer.py `box_thin`, 1914-1923) → (t, ok), and with slab the
    slab's (entry, exit) t besides."""
    tmn, tmx = _slab(lo, hi, o, inv_d)
    t_p = torch.where(tmn > T_MIN, tmn, tmx)
    ok = (tmx > tmn) & (t_p > T_MIN)
    return (t_p, ok, (tmn, tmx)) if slab else (t_p, ok)


def _strip_t(x_lo, x_hi, y_hi, z_lo, o, inv_d, t_ylo, dwz, slab=False):
    """A grid box's hit t in the strip pass's form (pallas_tracer.py
    1965-1995, csrc/tracer.cu the grid's box members) → (t, ok), and with
    slab the (entry, exit) t besides: the x slab of the box's strip (its
    planes are the box's own bits), the shared y_lo plane's t_ylo, the
    box's y_hi plane, its z entry plane tz0 and the incremental z exit
    tz0 + dwz (dwz = w32·inv_dz), folded y, x, z. The entry t is
    `_box_t`'s where the ray enters through the z_lo plane or another
    axis's; the hi z plane's t may differ from (z_hi − oz)·inv_dz by the
    add's rounding."""
    tx0 = (x_lo - o[0]) * inv_d[0]
    tx1 = (x_hi - o[0]) * inv_d[0]
    th = (y_hi - o[1]) * inv_d[1]
    tz0 = (z_lo - o[2]) * inv_d[2]
    tz1 = tz0 + dwz
    tmn = torch.maximum(torch.maximum(torch.minimum(t_ylo, th),
                                      torch.minimum(tx0, tx1)),
                        torch.minimum(tz0, tz1))
    tmx = torch.minimum(torch.minimum(torch.maximum(t_ylo, th),
                                      torch.maximum(tx0, tx1)),
                        torch.maximum(tz0, tz1))
    t_p = torch.where(tmn > T_MIN, tmn, tmx)
    ok = (tmx > tmn) & (t_p > T_MIN)
    return (t_p, ok, (tmn, tmx)) if slab else (t_p, ok)


def _sphere_t(c, r2, o, d, a_dd, inv_a):
    """A sphere's hit t with the dynamic loop's root select: the near root
    when it clears T_MIN, else the far one (pallas_tracer.py:2049-2061)
    → (t, ok). c, r2, o, d, a_dd, inv_a broadcastable."""
    ocx, ocy, ocz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
    bq = ocx * d[0] + ocy * d[1] + ocz * d[2]
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = bq * bq - a_dd * cq
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    t_near = (-bq - sq) * inv_a
    t_far = (-bq + sq) * inv_a
    t_sel = torch.where(t_near > T_MIN, t_near, t_far)
    return t_sel, pos & (t_sel > T_MIN)


def _block(lanes: int, device: torch.device) -> int:
    """Table rows per broadcast block of the table loops: about 2²³ lane ×
    row cells per temporary on the CPU, 2²⁶ on a card (where the block
    count, not the cells, sets the time)."""
    cells = 1 << (23 if device.type == "cpu" else 26)
    return max(1, min(128, cells // max(lanes, 1)))


def _crossed(leaves, o, inv_d, t_d):
    """bool[lanes, n_leaf]: the leaf guard of the kernel's cull
    (`_clus_guard`): the ray crosses the leaf's AABB beyond T_MIN and
    before t_d."""
    tmn, tmx = _slab([leaves[None, :, a] for a in range(3)],
                     [leaves[None, :, 3 + a] for a in range(3)],
                     [x[:, None] for x in o], [x[:, None] for x in inv_d])
    return (tmx > torch.clamp(tmn, min=T_MIN)) & (tmn < t_d[:, None])


def _closest_rows(hit_fn, table, leaves, o, inv_d, t_d, tests=None,
                  crossings=None):
    """The first strict minimum of a table's hits below t_d → (t, winner
    row or -1), as the kernel's culled scan in table order finds it.

    hit_fn(rows, lanes) gives (t, ok) of the lanes (an index tensor)
    against a block of rows as [lanes, block] tensors. The rows go in
    blocks of whole leaves, each tested only on the lanes that cross one
    of its leaves before their t_d at the start (with no leaf table, on
    every lane): a skipped row cannot hold a hit below t_d, so the cull
    changes the work, not the winner. Within a block the first minimum
    wins (torch.min returns its first index), across blocks a strict <,
    so the winner is the one a sequential scan in table order keeps.

    tests (int64 per lane), when given, gathers the member tests the
    kernel's own cull runs: the blocks are then single leaves, each tested
    on the lanes that cross it before their best hit so far, as the kernel
    tests them in order. crossings (int64 per lane; with tests, and hit_fn
    then gives each row's slab (entry, exit) t third) gathers those of the
    tests whose slab the ray crosses inside (T_MIN, best hit before the
    test): the kernel's DDA row, against the running best in table order.
    """
    t_d = t_d.clone()
    win = torch.full(t_d.shape, -1, dtype=torch.int64, device=t_d.device)
    step = _block(t_d.numel(), t_d.device)
    if leaves.shape[0]:
        cross = None if tests is not None else _crossed(leaves, o, inv_d, t_d)
        bounds = leaves[:, 6:8].to(torch.int64).tolist()
    else:
        cross = torch.ones((t_d.numel(), 1), dtype=torch.bool,
                           device=t_d.device)
        bounds = [[0, table.shape[0]]]
    c0 = 0
    while c0 < len(bounds):
        c1 = c0 + 1   # whole leaves, up to `step` rows
        while (tests is None and c1 < len(bounds)
               and bounds[c1][0] + bounds[c1][1] - bounds[c0][0] <= step):
            c1 += 1
        r0, r1 = bounds[c0][0], bounds[c1 - 1][0] + bounds[c1 - 1][1]
        if tests is None:
            lanes = torch.nonzero(cross[:, c0:c1].any(dim=1)).squeeze(1)
        else:
            lanes = torch.nonzero(
                _crossed(leaves[c0:c1], o, inv_d, t_d)[:, 0]
                if leaves.shape[0] else cross[:, 0]).squeeze(1)
            tests[lanes] += r1 - r0
        for q0 in range(r0, r1 if lanes.numel() else r0, step):
            res = hit_fn(table[q0:min(q0 + step, r1)], lanes)
            vals = torch.where(res[1], res[0], BIG)
            mn, idx = vals.min(dim=1)
            cur = t_d[lanes]
            if crossings is not None:
                # the best hit before each row: the minimum of the start's
                # and the earlier rows' (a strict < update keeps the min)
                tmn, tmx = res[2]
                before = torch.cat([cur[:, None], vals[:, :-1]],
                                   dim=1).cummin(dim=1).values
                crossings[lanes] += ((tmx > torch.clamp(tmn, min=T_MIN))
                                     & (tmn < before)).sum(dim=1)
            better = mn < cur
            t_d[lanes] = torch.where(better, mn, cur)
            win[lanes] = torch.where(better, q0 + idx, win[lanes])
        c0 = c1
    return t_d, win


def _leaf_members(leaves, o, inv_d, t_final):
    """Members of the leaves a ray crosses before its closest hit, summed
    over the lanes: the box member tests an exact leaf cull needs (the
    kernel's cull, against a running best hit, tests at least these)."""
    if leaves.shape[0] == 0:
        return 0
    return int((_crossed(leaves, o, inv_d, t_final)
                * leaves[None, :, 7]).sum())


def _cull_tests(leaves, sups, o, inv_d, t_final):
    """Slab tests of the kernel's two-level cull (`cull_table`) that an
    exact cull needs against the closest hit, summed over the lanes: a
    root test a lane, then on the lanes that cross the root every super
    (every leaf, without supers) and the leaves of the supers they cross
    (the kernel, against a running best hit, tests at least these)."""
    if leaves.shape[0] == 0:
        return 0
    root = torch.cat([leaves[:, :3].amin(0), leaves[:, 3:6].amax(0),
                      leaves.new_zeros(2)])[None]
    inside = _crossed(root, o, inv_d, t_final)[:, 0]
    n_in = int(inside.sum())
    if sups.shape[0] == 0:
        return t_final.numel() + n_in * leaves.shape[0]
    held = _crossed(sups, o, inv_d, t_final) & inside[:, None]
    return (t_final.numel() + n_in * sups.shape[0]
            + int((held * sups[None, :, 7]).sum()))


def _interior_t(rows, kinds, o, d, a_dd, inv_a, time, moving):
    """The nearest hit t over the dense-medium walk's interior rows (t
    only, BIG where none; pallas_tracer.py:2571-2641). Each kind's t is the
    expression the main step computes for that row: a sphere's as the
    dynamic loop's (the unrolled loop's near/far select keeps the same
    minimum), a rect's in its own plane frame as the unrolled loop does in
    its group's, a box's as the box loop's."""
    t_s = torch.full_like(d[0], BIG)
    inv_d = None
    for r, k in zip(rows, kinds):
        if k == INT_BOX:
            if inv_d is None:
                inv_d = [_safe_inv(c) for c in d]
            t_p, ok = _box_t(r[R_C0:R_C0 + 3], r[R_DC:R_DC + 3], o, inv_d)
        elif k == INT_RECT:
            kn, an, bn = r[R_KN:R_KN + 3], r[R_AN:R_AN + 3], r[R_BN:R_BN + 3]
            d_kn = d[0] * kn[0] + d[1] * kn[1] + d[2] * kn[2]
            nonpar = d_kn != 0.0
            inv_kn = 1.0 / torch.where(nonpar, d_kn, 1.0)
            t_p = (r[R_KOFF] - (o[0] * kn[0] + o[1] * kn[1] + o[2] * kn[2])
                   ) * inv_kn
            xa = ((o[0] * an[0] + o[1] * an[1] + o[2] * an[2])
                  + t_p * (d[0] * an[0] + d[1] * an[1] + d[2] * an[2])
                  - r[R_AOFF])
            yb = ((o[0] * bn[0] + o[1] * bn[1] + o[2] * bn[2])
                  + t_p * (d[0] * bn[0] + d[1] * bn[1] + d[2] * bn[2])
                  - r[R_BOFF])
            ok = (nonpar & (t_p > T_MIN) & (xa >= r[R_A0]) & (xa <= r[R_A1])
                  & (yb >= r[R_B0]) & (yb <= r[R_B1]))
        else:
            t_p, ok = _sphere_t(_sphere_center(r, time, moving), r[R_R2], o,
                                d, a_dd, inv_a)
        t_s = torch.minimum(t_s, torch.where(ok, t_p, BIG))
    return t_s


def trace_plain(ops: TraceOperands, sums: torch.Tensor, *, nx: int, ny: int,
                seed: int, sample0: int, n_samples: int, max_depth: int,
                counts: dict | None = None, pix: torch.Tensor | None = None,
                kpix: int = 1, stats: torch.Tensor | None = None,
                dda: bool = False) -> torch.Tensor:
    """The kernel's computation in plain torch, on any device.

    Adds, for every pixel, the radiance of samples sample0 ..
    sample0+n_samples−1 to sums (f64[3, nx·ny], updated in place and
    returned), in sample order, so the sums do not depend on how samples
    are split into calls. The whole chunk is one batch of (pixel × sample)
    lanes; each step traces one segment of every live lane, each lane at
    its own bounce (the dense-medium walk advances its lanes by several
    bounces between two steps), and the loop stops when no lane is left.
    Every f32 operation is the kernel's, in the kernel's order. The box and
    dynamic sphere tables are scanned whole, in broadcast blocks, keeping
    the first strict minimum in table order: the kernel's leaf cull skips
    only leaves that cannot hold a closer hit, so the winners are the same.
    On the CPU the transcendental functions go through `rng.lanewise`, so
    the sums do not depend on the chunking there either.

    counts, when given, gathers the work this run's paths needed: lane
    bounces traced ("segments"), lanes shaded by noise ("noise") and by an
    image ("image"), box member tests an exact leaf cull needs ("box"),
    slab tests of the two-level cull of the sphere and of the box table
    that an exact cull needs ("cull", "box_cull": `_cull_tests`),
    lane bounces of the dense-medium walk ("walk"), hits on a textured
    light ("emis_tex"), image lanes at a rect's UV ("rect_uv"), medium
    events of a textured medium ("med_tex"), roulette draws ("rr") and the
    (segment, medium) pairs of the main step whose interval is open
    ("med_open": the media a per-segment gate could not skip).

    pix, kpix: K1f's pixel table (see `trace`); the pixels it names are
    rendered, in its order, each into its own sums, so the sums equal the
    scanline layout's bit for bit. stats, when given (`new_stats`), gathers
    what the kernel's stats launch counts, added to it: per pixel its
    segments, lane bounces of the walk included (so the row sums to
    counts' "segments" + "walk"), and the dynamic sphere and box member
    tests of the kernel's cull, leaf by leaf against the ray's best hit so
    far (counts' "box" counts an exact cull's, against the final hit); per
    warp of the launch's thread mapping, the largest among its 32 threads
    of a thread's segments summed over its banks and samples, walk bounces
    included (the kernel's flat loop runs a warp until its busiest thread
    is done, a segment or a walk bounce an iteration: its iterations);
    with dda
    (a buffer of `new_stats(..., dda=True)`), per pixel the box member
    tests whose slab the ray crosses inside (T_MIN, its best hit before the
    test), the kernel's DDA row (`dda_row`).
    """
    dev = sums.device
    f32 = torch.float32
    n_pix = nx * ny
    (sky, checker, metal, diel, moving, noise, image, media, compat_uv, walk,
     emis_tex, uv_carry, img_flip, med_tex, rr) = (
        bool(ops.feats & b) for b in (
            FEAT_SKY, FEAT_CHECKER, FEAT_METAL, FEAT_DIEL, FEAT_MOVING,
            FEAT_NOISE, FEAT_IMAGE, FEAT_MEDIA, FEAT_COMPAT_UV,
            FEAT_DENSE_WALK, FEAT_EMIS_TEX, FEAT_UV_CARRY, FEAT_IMG_FLIP,
            FEAT_MED_TEX, FEAT_RR))
    if counts is not None:
        for k in ("segments", "noise", "image", "box", "cull", "box_cull",
                  "walk", "emis_tex", "rect_uv", "med_tex", "rr", "med_open"):
            counts.setdefault(k, 0)
    # record cells as Python floats: a torch op with a Python scalar computes
    # in the tensor's f32, and every cell is an f32 value
    table = ops.rec.cpu().tolist()
    order, lead = ops.walk.cpu().tolist()
    med_table = ops.med.cpu().tolist() if media else []
    interior = ops.interior.cpu().tolist() if walk else []
    int_kind = ops.interior_kind.cpu().tolist() if walk else []

    if pix is None:
        pixels = torch.arange(n_pix, dtype=torch.int64, device=dev)
    else:
        pixels = pix.to(dev, torch.int64)
        pixels = pixels[(pixels >= 0) & (pixels < n_pix)]
    n_sel = pixels.numel()
    pix_table = pix
    pix = pixels.repeat(n_samples)
    smp = torch.arange(sample0, sample0 + n_samples, dtype=torch.int64,
                       device=dev).repeat_interleave(n_sel)
    lanes = pix.numel()
    # STATS: each lane's segments, member tests and DDA crossings
    if stats is not None:
        nb_lane, ts_lane, tb_lane, cb_lane = (
            torch.zeros(lanes, dtype=torch.int64, device=dev)
            for _ in range(4))

    # -- camera rays (reference src/camera.rs:53-67, jitter tests/test.rs:66-68)
    u0, u1, u2, u3 = rng.draws(seed, pix, smp, 0, rng.STREAM_CAMERA)
    icol = (pix % nx).to(f32)
    jflip = (ny - 1 - pix // nx).to(f32)
    # divide by device tensors: torch on CUDA turns a division by a Python
    # scalar into a multiply by its reciprocal, which rounds differently
    # from the kernel's (and the CPU's) true division
    s = (icol + u0) / torch.tensor(float(nx), device=dev)
    t = (jflip + u1) / torch.tensor(float(ny), device=dev)
    cr = ops.cam.to(dev)
    lens = Camera(origin=cr[C_ORIGIN:C_ORIGIN + 3],
                  lower_left=cr[C_LL:C_LL + 3],
                  horizontal=cr[C_HORIZ:C_HORIZ + 3],
                  vertical=cr[C_VERT:C_VERT + 3], u=cr[C_U:C_U + 3],
                  v=cr[C_V:C_V + 3], time0=cr[C_TIME0],
                  time1=cr[C_TIME0] + cr[C_DTIME], lens_radius=cr[C_LENS_R])
    o, d, _ = get_rays(lens, s, t, torch.stack([u2, u3, torch.zeros_like(u2)],
                                               dim=-1))
    o, d = list(o.unbind(-1)), list(d.unbind(-1))
    time = None
    if moving:
        # shutter time t0 + u·dt (pallas_tracer.py:1583-1584)
        ut = rng.draws(seed, pix, smp, 0, rng.STREAM_TIME)[0]
        time = cr[C_TIME0] + ut * cr[C_DTIME]

    rad = torch.zeros((3, lanes), dtype=f32, device=dev)
    thr = [torch.ones(lanes, dtype=f32, device=dev) for _ in range(3)]
    live = torch.arange(lanes, device=dev)
    # each live lane's bounce, and whether the walk already ruled out a
    # medium event on its next segment (pallas_tracer.py `skip_med`)
    bnc = torch.zeros(lanes, dtype=torch.int64, device=dev)
    skip = torch.zeros(lanes, dtype=torch.bool, device=dev)
    rec_dev = ops.rec.to(dev)
    dyn_dev = ops.dyn.to(dev)
    box_dev = ops.box.to(dev)
    leaf_dev = ops.leaves.to(dev)
    bleaf_dev = ops.bleaves.to(dev)
    med_dev = ops.med.to(dev)
    dense_of = torch.tensor([bool(ops.dense >> i & 1)
                             for i in range(len(med_table))],
                            dtype=torch.bool, device=dev)
    while True:
        ox, oy, oz = o
        dx, dy, dz = d
        n_live = dx.numel()
        if counts is not None:
            counts["segments"] += n_live
        if stats is not None:
            nb_lane[live] += 1
        a_dd = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a_dd
        t_best = torch.full_like(dx, BIG)
        win = torch.full(dx.shape, -1, dtype=torch.int64, device=dev)
        nrm = [torch.zeros_like(dx) for _ in range(3)]
        frame = None
        for p, l in zip(order, lead):
            r = table[p]
            if l < 0:
                # sphere (reference src/sphere.rs:37-77)
                cx, cy, cz = _sphere_center(r, time, moving)
                ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
                bq = ocx * dx + ocy * dy + ocz * dz
                cq = ocx * ocx + ocy * ocy + ocz * ocz - r[R_R2]
                disc = bq * bq - a_dd * cq
                pos = disc > 0.0
                sq = torch.sqrt(torch.where(pos, disc, 1.0))
                t_near = (-bq - sq) * inv_a
                t_far = (-bq + sq) * inv_a
                near_ok = pos & (t_near > T_MIN) & (t_near < t_best)
                far_ok = pos & (t_far > T_MIN) & (t_far < t_best)
                t_p = torch.where(near_ok, t_near,
                                  torch.where(far_ok, t_far, BIG))
                better = t_p < t_best
                inv_r = float(np.float32(1.0) / np.float32(r[R_RADIUS]))
                n_p = [(ocx + t_p * dx) * inv_r, (ocy + t_p * dy) * inv_r,
                       (ocz + t_p * dz) * inv_r]
            else:
                # rect in its group's world frame (reference src/rect.rs:39-69;
                # x = (o+td)·an expands to o·an + t·(d·an))
                if frame is None or frame[0] != l:
                    f = table[l]
                    kn = f[R_KN:R_KN + 3]
                    d_kn = dx * kn[0] + dy * kn[1] + dz * kn[2]
                    nonpar = d_kn != 0.0
                    frame = (
                        l, kn, nonpar,
                        ox * kn[0] + oy * kn[1] + oz * kn[2],
                        1.0 / torch.where(nonpar, d_kn, 1.0),
                        ox * f[R_AN] + oy * f[R_AN + 1] + oz * f[R_AN + 2],
                        dx * f[R_AN] + dy * f[R_AN + 1] + dz * f[R_AN + 2],
                        ox * f[R_BN] + oy * f[R_BN + 1] + oz * f[R_BN + 2],
                        dx * f[R_BN] + dy * f[R_BN + 1] + dz * f[R_BN + 2])
                _, kn, nonpar, o_kn, inv_kn, o_an, d_an, o_bn, d_bn = frame
                t_p = (r[R_KOFF] - o_kn) * inv_kn
                xa = o_an + t_p * d_an - r[R_AOFF]
                yb = o_bn + t_p * d_bn - r[R_BOFF]
                better = (nonpar & (t_p > T_MIN) & (t_p < t_best)
                          & (xa >= r[R_A0]) & (xa <= r[R_A1])
                          & (yb >= r[R_B0]) & (yb <= r[R_B1]))
                n_p = kn
            flip = r[R_FLIP]
            t_best = torch.where(better, t_p, t_best)
            win = torch.where(better, p, win)
            nrm = [torch.where(better, n_p[a] * flip, nrm[a]) for a in range(3)]
        w = rec_dev[win.clamp(min=0)]
        hit = win >= 0

        if box_dev.shape[0] or dyn_dev.shape[0]:
            inv_d = [_safe_inv(c) for c in d]
        if box_dev.shape[0]:
            # the box table, then (below) the dynamic sphere table, each
            # carrying only (t, winner) (pallas_tracer.py:1906-1942, boxes
            # first, so the first strict minimum keeps a box on a tie)
            tests = None if stats is None else torch.zeros_like(bnc)
            cross = torch.zeros_like(bnc) if dda else None
            if ops.grid:
                # a box grid: the strip pass's member test, its y_lo plane
                # and z pitch taken once a segment
                t_ylo = (ops.grid[2] - oy) * inv_d[1]
                dwz = ops.grid[3] * inv_d[2]

                def box_rows(rows, ln):
                    return _strip_t(
                        rows[None, :, R_C0], rows[None, :, R_DC],
                        rows[None, :, R_DC + 1], rows[None, :, R_C0 + 2],
                        [x[ln, None] for x in o], [x[ln, None] for x in inv_d],
                        t_ylo[ln, None], dwz[ln, None], slab=dda)
            else:
                def box_rows(rows, ln):
                    return _box_t(
                        [rows[None, :, R_C0 + a] for a in range(3)],
                        [rows[None, :, R_DC + a] for a in range(3)],
                        [x[ln, None] for x in o], [x[ln, None] for x in inv_d],
                        slab=dda)
            t_b, wb = _closest_rows(box_rows, box_dev, bleaf_dev, o, inv_d,
                                    t_best, tests, cross)
            if stats is not None:
                tb_lane[live] += tests
            if dda:
                cb_lane[live] += cross
            # winner resolve: the face whose slab t on the chosen side
            # (entry beyond T_MIN, else exit) equals t, ties x → y → z,
            # normal +axis like the reference's rects, then the flip
            # (pallas_tracer.py:2110-2150)
            bwin = wb >= 0
            wr = box_dev[wb.clamp(min=0)]
            t0 = [(wr[:, R_C0 + a] - o[a]) * inv_d[a] for a in range(3)]
            t1 = [(wr[:, R_DC + a] - o[a]) * inv_d[a] for a in range(3)]
            near = [torch.minimum(t0[a], t1[a]) for a in range(3)]
            far = [torch.maximum(t0[a], t1[a]) for a in range(3)]
            use_en = torch.maximum(torch.maximum(near[0], near[1]),
                                   near[2]) > T_MIN
            tx_c = torch.where(use_en, near[0], far[0])
            ty_c = torch.where(use_en, near[1], far[1])
            is_x = t_b == tx_c
            is_y = (t_b == ty_c) & (t_b != tx_c)
            face = (is_x, is_y, ~is_x & ~is_y)
            for a in range(3):
                n_a = torch.where(face[a], 1.0, 0.0) * wr[:, R_FLIP]
                nrm[a] = torch.where(bwin, n_a, nrm[a])
            t_best = torch.where(bwin, t_b, t_best)
            w = torch.where(bwin[:, None], wr, w)
            hit = hit | bwin

        if dyn_dev.shape[0]:
            # the dynamic sphere table with its own root select
            # (pallas_tracer.py:2034-2071)
            def sphere_rows(rows, ln):
                if moving:
                    frac = ((time[ln, None] - rows[None, :, R_T0])
                            * rows[None, :, R_INV_DT])
                    c = [rows[None, :, R_C0 + a] + frac * rows[None, :, R_DC + a]
                         for a in range(3)]
                else:
                    c = [rows[None, :, R_C0 + a] for a in range(3)]
                return _sphere_t(c, rows[None, :, R_R2],
                                 [x[ln, None] for x in o],
                                 [x[ln, None] for x in d], a_dd[ln, None],
                                 inv_a[ln, None])
            tests = None if stats is None else torch.zeros_like(bnc)
            t_d, wd = _closest_rows(sphere_rows, dyn_dev, leaf_dev, o, inv_d,
                                    t_best, tests)
            if stats is not None:
                ts_lane[live] += tests
            # winner resolve: normal (o + t·d − c(time))·inv_r, then the flip
            # (pallas_tracer.py:2097-2148)
            dwin = wd >= 0
            wr = dyn_dev[wd.clamp(min=0)]
            frac = (time - wr[:, R_T0]) * wr[:, R_INV_DT] if moving else None
            inv_r = 1.0 / wr[:, R_RADIUS]
            for a, (oa, da) in enumerate(zip(o, d)):
                ca = wr[:, R_C0 + a]
                if moving:
                    ca = ca + frac * wr[:, R_DC + a]
                n_a = ((oa + t_d * da - ca) * inv_r) * wr[:, R_FLIP]
                nrm[a] = torch.where(dwin, n_a, nrm[a])
            t_best = torch.where(dwin, t_d, t_best)
            w = torch.where(dwin[:, None], wr, w)
            hit = hit | dwin
        if counts is not None and box_dev.shape[0]:
            counts["box"] += _leaf_members(bleaf_dev, o, inv_d, t_best)
            counts["box_cull"] += _cull_tests(bleaf_dev, ops.bsups.to(dev),
                                              o, inv_d, t_best)
        if counts is not None and dyn_dev.shape[0]:
            counts["cull"] += _cull_tests(leaf_dev, ops.sups.to(dev), o,
                                          inv_d, t_best)

        # a medium event before the closest surface takes the hit over
        # (pallas_tracer.py:2204-2266): isotropic, no emission, and the
        # medium's albedo in place of the surface's texture (a solid
        # medium's texture flags are 0); a lane the walk handed over with
        # skip set has no event on this segment
        med_ev = None
        tex = w[:, R_ALB_EVEN:R_ALB_EVEN + TEXW]   # the texture each lane shades
        if media:
            def draw(stream):
                return rng.draws(seed, pix[live], smp[live], bnc, stream)
            t_med, m_win = _media_events(ops.med_box, med_table, o, d, a_dd,
                                         inv_a, t_best, draw, counts)
            med_ev = (t_med < t_best) & ~skip
            t_best = torch.where(med_ev, t_med, t_best)
            tex = torch.where(med_ev[:, None],
                              med_dev[m_win.clamp(min=0), M_ALB:M_ALB + TEXW],
                              tex)
            if counts is not None and med_tex:
                counts["med_tex"] += int((med_ev & (tex[:, [
                    T_CHK, T_NOISE, T_IMG]] > 0.0).any(dim=1)).sum())
        surf = hit if med_ev is None else hit & ~med_ev
        below = bnc < max_depth
        # the texture's value (the albedo, or a textured light's emission)
        # at the hit point: on a scatter below the depth cap, and on a light
        # at any bounce
        px = [o[a] + t_best * d[a] for a in range(3)]
        shade = (hit if med_ev is None else hit | med_ev) & below
        if emis_tex:
            lit = surf & (w[:, R_MAT] == MAT_DIFFUSE_LIGHT)
            shade = shade | lit
            if counts is not None:
                counts["emis_tex"] += int((lit & (tex[:, [
                    T_CHK, T_NOISE, T_IMG]] > 0.0).any(dim=1)).sum())

        def uv_of(idx):
            # the image UV of the lanes idx (pallas_tracer.py:2303-2328): a
            # sphere's from its pre-flip normal, an image rect's from its
            # frame, a medium's u = v = 0 (reference src/medium.rs:44-50)
            wi = w[idx]
            n = [x[idx] for x in nrm]
            if img_flip:
                n = [x * wi[:, R_FLIP] for x in n]
            uu, vv = sphere_uv(*n, compat_uv)
            if uv_carry:
                rect = wi[:, R_IS_SPHERE] == 0.0
                if med_ev is not None:
                    rect = rect & ~med_ev[idx]
                ru, rv = rect_uv([x[idx] for x in o], [x[idx] for x in d],
                                 t_best[idx], wi)
                uu, vv = torch.where(rect, ru, uu), torch.where(rect, rv, vv)
                if med_ev is not None:
                    uu = torch.where(med_ev[idx], 0.0, uu)
                    vv = torch.where(med_ev[idx], 0.0, vv)
                if counts is not None:
                    counts["rect_uv"] += int(rect.sum())
            return uu, vv
        alb = texture_rgb(tex, px, shade, uv_of, ops.atlas.to(dev),
                          ops.perlin_seed, checker=checker, noise=noise,
                          image=image, counts=counts)

        # emission (reference src/color.rs:8-22); a miss adds the background
        # and ends the path
        miss = [0.0, 0.0, 0.0]
        if sky:
            inv_len = 1.0 / torch.sqrt(a_dd)
            ty = 0.5 * (dy * inv_len + 1.0)
            miss = [thr[0] * (1.0 - 0.5 * ty), thr[1] * (1.0 - 0.3 * ty),
                    thr[2]]
        for c in range(3):
            other = miss[c] if med_ev is None else torch.where(med_ev, 0.0,
                                                                miss[c])
            emit = w[:, R_EMIT + c]
            if emis_tex:
                # a textured light emits its texture's value (reference
                # src/material.rs:133-151): its R_EMIT is 0, and a solid
                # light's texture is 0, so the sum is exact for both
                emit = emit + torch.where(lit, alb[c], 0.0)
            rad[c, live] += torch.where(surf, thr[c] * emit, other)
        # scatter while below the depth cap (src/color.rs:9); a light ends
        # the path
        if not bool(below.any()):
            break
        mat = w[:, R_MAT]
        if med_ev is not None:
            mat = torch.where(med_ev, float(MAT_ISOTROPIC), mat)
            hit = hit | med_ev
        cont = hit & (mat != MAT_DIFFUSE_LIGHT) & below
        # lambertian: n + a uniform point in the unit ball
        # (reference src/material.rs:49-53); isotropic: the bare ball
        # sample (src/material.rs:164-168)
        su = rng.draws(seed, pix[live], smp[live], bnc, rng.STREAM_SCATTER)
        ball = rng.in_unit_sphere(torch.stack(su[:3], dim=-1)).unbind(-1)
        nd = [nrm[a] + ball[a] for a in range(3)]
        if med_ev is not None:
            nd = [torch.where(med_ev, ball[a], nd[a]) for a in range(3)]
        if metal or diel:
            inv_len = 1.0 / torch.sqrt(a_dd)
            ud = [d[a] * inv_len for a in range(3)]
            par = w[:, R_PARAM]
        if metal:
            # reflect(unit(d), n) + fuzz·ball; the path ends when that
            # points into the surface (reference src/material.rs:76-87)
            is_met = mat == MAT_METAL
            ddn_u = ud[0] * nrm[0] + ud[1] * nrm[1] + ud[2] * nrm[2]
            md = [ud[a] - 2.0 * ddn_u * nrm[a] + par * ball[a]
                  for a in range(3)]
            met_ok = (md[0] * nrm[0] + md[1] * nrm[1] + md[2] * nrm[2]) > 0.0
            nd = [torch.where(is_met, md[a], nd[a]) for a in range(3)]
            cont = cont & (~is_met | met_ok)
        if diel:
            # dielectric with Schlick's reflect-or-refract draw, the
            # reference's exit cosine ref_idx·(d·n)/|d| included
            # (reference src/material.rs:105-126)
            is_diel = mat == MAT_DIELECTRIC
            ddn = d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2]
            d_len = torch.sqrt(a_dd)
            exiting = ddn > 0.0
            on = [torch.where(exiting, -1.0, 1.0) * nrm[a] for a in range(3)]
            eta = torch.where(exiting, par, 1.0 / par)
            cosine = torch.where(exiting, par * ddn / d_len, -ddn / d_len)
            dt_u = ud[0] * on[0] + ud[1] * on[1] + ud[2] * on[2]
            disc_r = 1.0 - eta * eta * (1.0 - dt_u * dt_u)
            can = disc_r > 0.0
            sq_r = torch.sqrt(torch.where(can, disc_r, 1.0))
            r0 = (1.0 - par) / (1.0 + par)
            r0 = r0 * r0
            one_c = 1.0 - cosine
            one_c2 = one_c * one_c
            schlick = r0 + (1.0 - r0) * one_c2 * one_c2 * one_c
            refr = can & (su[3] >= schlick)
            gd = [torch.where(refr, eta * (ud[a] - on[a] * dt_u) - on[a] * sq_r,
                              d[a] - 2.0 * ddn * nrm[a]) for a in range(3)]
            nd = [torch.where(is_diel, gd[a], nd[a]) for a in range(3)]
            alb = [torch.where(is_diel, 1.0, alb[c]) for c in range(3)]
        keep = torch.nonzero(cont).squeeze(1)
        thr = [thr[c][keep] * alb[c][keep] for c in range(3)]
        if rr:
            # Russian roulette from bounce rr_depth on (pallas_tracer.py:
            # 2492-2506; not in the reference): a path survives with
            # q = max(thr) clipped to [0.05, 1] and a survivor's throughput
            # is multiplied by 1/q, the kernel's reciprocal
            roll = torch.nonzero(bnc[keep] >= ops.rr_depth).squeeze(1)
            if counts is not None:
                counts["rr"] += roll.numel()
            u = rng.draws(seed, pix[live[keep[roll]]], smp[live[keep[roll]]],
                          bnc[keep[roll]], rng.STREAM_ROULETTE)[0]
            q = torch.clamp(torch.maximum(thr[0][roll], torch.maximum(
                thr[1][roll], thr[2][roll])), 0.05, 1.0)
            inv_q = 1.0 / q
            for c in range(3):
                thr[c][roll] = thr[c][roll] * inv_q
            surv = torch.ones(keep.numel(), dtype=torch.bool, device=dev)
            surv[roll] = u < q
            keep = keep[surv]
            thr = [x[surv] for x in thr]
        if keep.numel() == 0:
            break
        live = live[keep]
        o = [px[a][keep] for a in range(3)]
        d = [nd[a][keep] for a in range(3)]
        if moving:
            time = time[keep]
        bnc = bnc[keep] + 1
        skip = torch.zeros_like(bnc, dtype=torch.bool)
        if walk:
            # a lane that just scattered in a dense medium, below the cap,
            # walks (pallas_tracer.py:2540-2562)
            dense_ev = med_ev & dense_of[m_win.clamp(min=0)]
            wnb = None if stats is None else torch.zeros_like(bnc)
            _walk(ops.med_box, dense_of, med_table, med_dev, interior,
                  int_kind, o, d, thr, bnc, skip, time, moving,
                  torch.nonzero(dense_ev[keep] & (bnc < max_depth)).squeeze(1),
                  lambda idx, b, stream: rng.draws(seed, pix[live[idx]],
                                                   smp[live[idx]], b, stream),
                  max_depth, counts, wnb)
            if stats is not None:
                nb_lane[live] += wnb

    per_sample = rad.view(3, n_samples, n_sel)
    for i in range(n_samples):
        if pix_table is None:
            sums += per_sample[:, i].double()
        else:
            sums[:, pixels] += per_sample[:, i].double()
    if stats is not None:
        _add_stats(stats, n_pix, pixels, pix_table, kpix,
                   nb_lane.view(n_samples, n_sel),
                   ts_lane.view(n_samples, n_sel),
                   tb_lane.view(n_samples, n_sel),
                   cb_lane.view(n_samples, n_sel) if dda else None)
    return sums


def _add_stats(stats, n_pix, pixels, pix_table, kpix, nb, ts, tb, cb=None):
    """Adds the per-(sample, pixel) segments nb and member tests ts, tb
    ([n_samples, n_sel], pixels in `pixels` order) to a stats buffer: the
    per-pixel rows, and each warp's steps under the kernel's thread
    mapping (a thread per pixel, or thread j of tile g on slots
    (g·kpix + b)·TILE + j of the table): per thread the Σ over its banks
    and samples of the segments, then the largest of a warp's 32; and the
    DDA crossings cb, when given, to the DDA row."""
    busy, sph, box, steps = stats_rows(stats, n_pix, dda=cb is not None)
    if cb is not None:
        dda_row(stats, n_pix).index_add_(0, pixels, cb.sum(dim=0))
    per_pix = nb.sum(dim=0)
    busy.index_add_(0, pixels, per_pix)
    sph.index_add_(0, pixels, ts.sum(dim=0))
    box.index_add_(0, pixels, tb.sum(dim=0))
    threads = steps.numel() * WARP
    if pix_table is None:
        slot = torch.zeros(threads, dtype=torch.int64, device=nb.device)
        slot[:pixels.numel()] = per_pix
    else:
        flat = torch.zeros(pix_table.numel(), dtype=torch.int64,
                           device=nb.device)
        slots = pix_table.to(nb.device)
        flat[torch.nonzero((slots >= 0) & (slots < n_pix))
             .squeeze(1)] = per_pix
        grid = pix_table.numel() // (kpix * TILE)
        slot = flat.view(grid, kpix, TILE).sum(dim=1).reshape(threads)
    steps += slot.view(-1, WARP).amax(dim=-1)


def _walk(med_box, dense_of, med_table, med_dev, interior, int_kind, o, d,
          thr, bnc, skip, time, moving, idx, draws, max_depth, counts,
          steps=None):
    """The dense-medium walk (pallas_tracer.py:2543-2687) of the lanes idx,
    updating o, d, thr (lists of per-lane tensors), bnc and skip in place.

    Each walk bounce tests only the interior rows, then races the media on
    [T_MIN, nearest interior hit] with the main step's draws at the lane's
    bounce (`draws(idx, bounce, stream)`: MEDIUM for the flights, SCATTER
    for the direction). A scatter advances the lane to the event, takes
    the isotropic direction, multiplies the throughput by the medium's
    albedo and counts a bounce; the lane walks on while the event's
    medium is dense and it is below the cap. No scatter ends the walk with
    skip set: the next main step traces the same segment against the whole
    scene and takes no medium event on it. steps (int64 per lane), when
    given, counts each lane's walk bounces.
    """
    while idx.numel():
        if counts is not None:
            counts["walk"] += idx.numel()
        if steps is not None:
            steps[idx] += 1
        wo = [x[idx] for x in o]
        wd = [x[idx] for x in d]
        wb = bnc[idx]
        a2 = wd[0] * wd[0] + wd[1] * wd[1] + wd[2] * wd[2]
        ia2 = 1.0 / a2
        t_s = _interior_t(interior, int_kind, wo, wd, a2, ia2,
                          time[idx] if moving else None, moving)
        t_m, m_w = _media_events(med_box, med_table, wo, wd, a2, ia2, t_s,
                                 lambda stream: draws(idx, wb, stream))
        adv = t_m < BIG
        skip[idx[~adv]] = True
        sel = torch.nonzero(adv).squeeze(1)
        ai = idx[sel]
        su = draws(ai, wb[sel], rng.STREAM_SCATTER)
        ball = rng.in_unit_sphere(torch.stack(su[:3], dim=-1)).unbind(-1)
        mw = med_dev[m_w[sel]]
        for a in range(3):
            o[a][ai] = wo[a][sel] + t_m[sel] * wd[a][sel]
            d[a][ai] = ball[a]
            thr[a][ai] = thr[a][ai] * mw[:, M_ALB + a]
        bnc[ai] = wb[sel] + 1
        go = dense_of[m_w[sel]] & (bnc[ai] < max_depth)
        idx = ai[go]


def _check_operands(ops: TraceOperands, sums, nx, ny, dev=None):
    """The operands as the kernel takes them, on the sums' device (on dev
    where a launch has no sums, sums None)."""
    dev = sums.device if sums is not None else dev
    for name, x, dtype in (("rec", ops.rec, torch.float32),
                           ("walk", ops.walk, torch.int32),
                           ("dyn", ops.dyn, torch.float32),
                           ("leaves", ops.leaves, torch.float32),
                           ("sups", ops.sups, torch.float32),
                           ("cam", ops.cam, torch.float32),
                           ("med", ops.med, torch.float32),
                           ("atlas", ops.atlas, torch.int32),
                           ("box", ops.box, torch.float32),
                           ("bleaves", ops.bleaves, torch.float32),
                           ("bsups", ops.bsups, torch.float32),
                           ("interior", ops.interior, torch.float32),
                           ("interior_kind", ops.interior_kind, torch.int32),
                           ("sums", sums, torch.float64)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, sums on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    P = ops.rec.shape[0]
    if ops.rec.dim() != 2 or ops.rec.shape[1] != REC \
            or not 0 < P <= UNROLL_BUDGET:
        raise ValueError(f"rec must be [1..{UNROLL_BUDGET}, {REC}], "
                         f"got {tuple(ops.rec.shape)}")
    if ops.walk.dim() != 2 or ops.walk.shape[0] != 2 \
            or ops.walk.shape[1] > P:
        raise ValueError(f"walk must be [2, ≤{P}], got "
                         f"{tuple(ops.walk.shape)}")
    for name, x, width in (("dyn", ops.dyn, REC), ("box", ops.box, REC),
                           ("leaves", ops.leaves, CLUSW),
                           ("sups", ops.sups, CLUSW),
                           ("bleaves", ops.bleaves, CLUSW),
                           ("bsups", ops.bsups, CLUSW)):
        if x.dim() != 2 or x.shape[1] != width:
            raise ValueError(f"{name} must be [n, {width}], got "
                             f"{tuple(x.shape)}")
    for name, sups, leaves in (("sups", ops.sups, ops.leaves),
                               ("bsups", ops.bsups, ops.bleaves)):
        # their leaf ranges were checked when the operands were made
        if leaves.shape[0] and sups.shape[0] > leaves.shape[0]:
            raise ValueError(f"{name}: {sups.shape[0]} super rows over "
                             f"{leaves.shape[0]} leaves")
    if tuple(ops.cam.shape) != (CAMREC,):
        raise ValueError(f"cam must be [{CAMREC}], got {tuple(ops.cam.shape)}")
    if sums is not None and tuple(sums.shape) != (3, nx * ny):
        raise ValueError(f"sums must be [3, {nx * ny}], got {tuple(sums.shape)}")
    if not 0 <= ops.feats <= FEAT_ALL:
        raise ValueError(f"feats {ops.feats} has unknown bits")
    M = ops.med.shape[0]
    if ops.med.dim() != 2 or ops.med.shape[1] != MEDREC or M > MAX_MEDIA:
        raise ValueError(f"med must be [0..{MAX_MEDIA}, {MEDREC}], got "
                         f"{tuple(ops.med.shape)}")
    if not 0 <= ops.med_box < 1 << M or not 0 <= ops.dense < 1 << M:
        raise ValueError(f"med_box {ops.med_box} or dense {ops.dense} names "
                         f"media beyond {M}")
    if bool(ops.feats & FEAT_MEDIA) != (M > 0):
        raise ValueError(f"FEAT_MEDIA is {bool(ops.feats & FEAT_MEDIA)} "
                         f"with {M} media")
    n_int = ops.interior.shape[0]
    if ops.interior.dim() != 2 or ops.interior.shape[1] != REC \
            or n_int > MAX_INTERIOR \
            or tuple(ops.interior_kind.shape) != (n_int,):
        raise ValueError(f"interior must be [0..{MAX_INTERIOR}, {REC}] with "
                         f"one kind per row, got {tuple(ops.interior.shape)} "
                         f"and {tuple(ops.interior_kind.shape)}")
    if ops.feats & FEAT_DENSE_WALK and not (n_int and ops.dense):
        raise ValueError("FEAT_DENSE_WALK needs interior rows and a dense "
                         "medium")
    if bool(ops.feats & FEAT_RR) != (ops.rr_depth >= 0) or (
            ops.feats & FEAT_RR and ops.feats & FEAT_DENSE_WALK):
        raise ValueError(f"FEAT_RR must be set exactly when rr_depth "
                         f"({ops.rr_depth}) is ≥ 0, and never with the walk")
    if ops.atlas.dim() != 2 or ops.atlas.numel() >= 1 << 31 or (
            ops.feats & FEAT_IMAGE and ops.atlas.numel() == 0):
        raise ValueError(f"atlas must be a 2-D texel table (non-empty for "
                         f"image textures), got {tuple(ops.atlas.shape)}")


def _launch(lib, ops: TraceOperands, sums: torch.Tensor | None, *, nx: int,
            ny: int, seed: int, sample0: int, n_samples: int, max_depth: int,
            stream, pix: torch.Tensor | None = None, kpix: int = 1,
            stats: torch.Tensor | None = None, dda: bool = False,
            probe_split: int = 0,
            probe_steps: torch.Tensor | None = None) -> None:
    """One launch of the K1 kernel through `lib` (the library of
    `_build.load`) on `stream`, or with probe_split ≥ 1 the cost probe's
    launch (`trace_probe`: stats is its busy row, sums None); raises if it
    fails, and only then counts the sections it ran."""
    global KERNEL_LAUNCHES, K1BE_LAUNCHES, K1C_LAUNCHES, K1D_LAUNCHES
    global K1E_BOX_LAUNCHES, K1D_WALK_LAUNCHES, K1_LATTICE_LAUNCHES
    global K1G_LAUNCHES, K1F_LAUNCHES, K1F_TABLE_LAUNCHES, K1F_STATS_LAUNCHES
    global K1F_PROBE_LAUNCHES, K1F_DDA_LAUNCHES, K1E_GRID_LAUNCHES
    inst = ctypes.c_int(-1)
    err = lib.rt_trace_k1(
        ops.rec.data_ptr(), ops.rec.shape[0], ops.walk.data_ptr(),
        ops.walk.shape[1], ops.dyn.data_ptr(), ops.dyn.shape[0],
        ops.leaves.data_ptr(), ops.leaves.shape[0], ops.sups.data_ptr(),
        ops.sups.shape[0], ops.cam.data_ptr(),
        ops.feats, None if sums is None else sums.data_ptr(), nx, ny,
        seed & 0xFFFFFFFF, seed >> 32,
        sample0, n_samples, max_depth, ops.med.data_ptr(),
        ops.med.shape[0], ops.med_box, ops.atlas.data_ptr(),
        ops.atlas.shape[0], ops.atlas.shape[1],
        perlin.seed_word(ops.perlin_seed), ops.box.data_ptr(),
        ops.box.shape[0], ops.bleaves.data_ptr(), ops.bleaves.shape[0],
        ops.bsups.data_ptr(), ops.bsups.shape[0], int(bool(ops.grid)),
        *(ops.grid[2:] if ops.grid else (0.0, 0.0)),
        ops.interior.data_ptr(), ops.interior.shape[0],
        ops.interior_kind.data_ptr(), ops.dense, ops.rr_depth,
        None if pix is None else pix.data_ptr(),
        0 if pix is None else pix.numel(), kpix, probe_split,
        None if probe_steps is None else probe_steps.data_ptr(),
        None if stats is None else stats.data_ptr(), int(dda),
        ctypes.addressof(inst), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    if inst.value >= 0:   # the library reports it (a stand-in may not)
        K1_INSTANTIATION_LAUNCHES[instantiation_name(inst.value)] += 1
    n_dyn, n_box = ops.dyn.shape[0], ops.box.shape[0]
    k1f = pix is not None or stats is not None
    if ops.feats == 0 and n_dyn == 0 and n_box == 0 and not k1f:
        KERNEL_LAUNCHES += 1
    if k1f:
        K1F_LAUNCHES += 1
    if pix is not None:
        K1F_TABLE_LAUNCHES += 1
    if stats is not None:
        K1F_STATS_LAUNCHES += 1
    if probe_split:
        K1F_PROBE_LAUNCHES += 1
    if dda:
        K1F_DDA_LAUNCHES += 1
    if ops.feats & K1BE_FEATS or n_dyn:
        K1BE_LAUNCHES += 1
    if n_box:
        K1E_BOX_LAUNCHES += 1
    if n_box and ops.grid:
        K1E_GRID_LAUNCHES += 1
    if ops.feats & (FEAT_NOISE | FEAT_IMAGE):
        K1C_LAUNCHES += 1
    if ops.feats & FEAT_MEDIA:
        K1D_LAUNCHES += 1
    if ops.feats & FEAT_DENSE_WALK:
        K1D_WALK_LAUNCHES += 1
    if ops.feats & FEAT_LATTICE:
        K1_LATTICE_LAUNCHES += 1
    if ops.feats & FEAT_RR:
        K1G_LAUNCHES += 1


def _check_k1f(sums, nx, ny, pix, kpix, stats, dda=False):
    """The pixel table and the stats buffer as the kernel takes them."""
    if dda and stats is None:
        raise ValueError("the DDA row rides in a stats buffer")
    if pix is None:
        if kpix != 1:
            raise ValueError(f"kpix {kpix} without a pixel table")
    else:
        if pix.device != sums.device or pix.dtype != torch.int32 \
                or pix.dim() != 1 or not pix.is_contiguous():
            raise ValueError("pix must be a contiguous int32 vector on the "
                             "sums' device")
        if kpix < 1 or pix.numel() == 0 or pix.numel() % (kpix * TILE):
            raise ValueError(f"pix must hold whole tiles of kpix·TILE = "
                             f"{kpix}·{TILE} slots, got {pix.numel()}")
    if stats is not None:
        want = stats_size(nx * ny, pix, kpix, dda)
        if stats.device != sums.device or stats.dtype != torch.int64 \
                or tuple(stats.shape) != (want,) \
                or not stats.is_contiguous():
            raise ValueError(f"stats must be a contiguous int64[{want}] on "
                             f"the sums' device")


def _check_range(seed, sample0, n_samples, nx, ny, max_depth):
    if not (0 <= seed < 1 << 64 and 0 <= sample0
            and sample0 + n_samples < 1 << 31 and 0 < nx * ny < 1 << 31
            and n_samples >= 0 and max_depth >= 0):
        raise ValueError("seed, sample range, image size or depth out of range")


def trace(ops: TraceOperands, sums: torch.Tensor, *, nx: int, ny: int,
          seed: int, sample0: int, n_samples: int, max_depth: int,
          pix: torch.Tensor | None = None, kpix: int = 1,
          stats: torch.Tensor | None = None,
          dda: bool = False) -> torch.Tensor:
    """Wrapper of the K1 kernel; same contract as `trace_plain`.

    On CUDA tensors it launches `csrc/tracer.cu` on the current stream
    (building it at first use) or raises; on CPU tensors it runs
    `trace_plain`. pix (a table of `render_table` or
    `balanced_pix_table`, int32, flat) names each pixel once; a slot
    outside [0, nx·ny) pads.
    """
    _check_operands(ops, sums, nx, ny)
    _check_k1f(sums, nx, ny, pix, kpix, stats, dda)
    _check_range(seed, sample0, n_samples, nx, ny, max_depth)
    if sums.device.type == "cpu":
        return trace_plain(ops, sums, nx=nx, ny=ny, seed=seed,
                           sample0=sample0, n_samples=n_samples,
                           max_depth=max_depth, pix=pix, kpix=kpix,
                           stats=stats, dda=dda)
    if sums.device.type != "cuda":
        raise ValueError(f"no kernel for device {sums.device}")
    from ._build import load
    lib = load()
    with torch.cuda.device(sums.device):
        _launch(lib, ops, sums, nx=nx, ny=ny, seed=seed, sample0=sample0,
                n_samples=n_samples, max_depth=max_depth,
                stream=torch.cuda.current_stream().cuda_stream, pix=pix,
                kpix=kpix, stats=stats, dda=dda)
    return sums


# the instantiations of csrc/tracer.cu by their template arguments (K1B,
# DYN: 1 the tables, 2 the tables with a box grid's strip pass; LEAF_SMEM,
# STATS: 0 none, 1 the stats launch's counters, 2 the cost probe's; MED),
# as ptxas names them: eleven production ones (`k1_instantiation` says
# which a launch runs), two of them a box grid's, and six for K1f's
# counters, two of them a box grid's
K1_INSTANTIATIONS = ((0, 0, 0, 0, 0), (0, 0, 0, 0, 1), (0, 1, 0, 0, 0),
                     (0, 1, 1, 0, 0), (1, 0, 0, 0, 0), (1, 0, 0, 0, 1),
                     (1, 1, 0, 0, 1), (1, 1, 1, 0, 0), (1, 1, 1, 0, 1),
                     (1, 1, 0, 1, 1), (1, 1, 1, 1, 1), (1, 1, 0, 2, 1),
                     (1, 1, 1, 2, 1), (1, 2, 0, 0, 1), (1, 2, 1, 0, 1),
                     (1, 2, 0, 1, 1), (1, 2, 1, 1, 1), (1, 2, 0, 2, 1),
                     (1, 2, 1, 2, 1))


def instantiation_name(code: int) -> str:
    """The instantiation of a launch's code (csrc/tracer.cu `Pick::code`:
    K1B | (DYN > 0) << 1 | LEAF_SMEM << 2 | STATS << 3 | MED << 5 |
    (DYN == 2) << 6) → "trace_k1<K1B,DYN,LEAF_SMEM,STATS,MED>"."""
    if not 0 <= code < 128 or code >> 6 and not code >> 1 & 1:
        raise ValueError(f"no K1 instantiation has the code {code}")
    flags = (code & 1, (code >> 1 & 1) + (code >> 6), code >> 2 & 1,
             code >> 3 & 3, code >> 5 & 1)
    return f"trace_k1<{','.join(map(str, flags))}>"


def k1_instantiation(ops: TraceOperands, *, table: bool = False,
                     stats: bool = False) -> tuple:
    """The flags (K1B, DYN, LEAF_SMEM, STATS, MED) of the instantiation a
    launch of ops runs, as csrc/tracer.cu `rt_trace_k1` and `pick` choose
    it: table, a launch on a pixel table; stats, 1 for the counters of a
    stats launch, 2 for the cost probe's (`trace_probe`). A table, a box
    table or counters run a DYN instantiation, DYN 2 where the boxes are a
    grid (`ops.grid`); any feature but roulette and media, or either of
    them beside a table, or a grid, a K1B one; media a MED one, and so do
    the counters, a grid and a K1B launch with a table whose leaves are
    not in shared memory (none, or too many to fit); roulette or media
    alone, without a table, K1a's code."""
    n_dyn, n_box = int(ops.dyn.shape[0]), int(ops.box.shape[0])
    n_leaf = int(ops.leaves.shape[0]) if n_dyn else 0
    n_bleaf = int(ops.bleaves.shape[0]) if n_box else 0
    n_sup = int(ops.sups.shape[0]) if n_leaf else 0
    n_bsup = int(ops.bsups.shape[0]) if n_bleaf else 0
    n_int, n_med = int(ops.interior.shape[0]), int(ops.med.shape[0])
    stats, grid = int(stats), bool(ops.grid)
    dyn = int(bool(stats or n_dyn or n_box or table))
    k1b = int(bool(stats or grid or ops.feats & ~(FEAT_RR | FEAT_MEDIA)
                   or (ops.feats and dyn)))
    base = (4 * (ops.rec.shape[0] * REC + CAMREC + 12 * dyn + n_med * MEDREC
                 + n_int * REC) + 4 * (2 * ops.walk.shape[1] + 3 * n_int))
    leaf_bytes = 4 * ((n_leaf + n_sup + n_bleaf + n_bsup) * CLUSW
                      + (2 * n_box if grid else 0))
    leaf_smem = int(n_leaf + n_bleaf > 0 and base + leaf_bytes <= SMEM_BUDGET)
    med = int(bool(n_med or stats or grid
                   or (k1b and dyn and not leaf_smem)))
    return k1b, 2 if grid else dyn, leaf_smem, stats, med


def k1_blocks_per_sm() -> dict:
    """Blocks of THREADS threads that an SM of the current card holds, per
    instantiation ("trace_k1<K1B,DYN,LEAF_SMEM,STATS,MED>"), without dynamic
    shared memory, by the runtime's occupancy query; raises without
    CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("the occupancy query needs a CUDA card: "
                           "torch.cuda.is_available() is false")
    from ._build import load
    lib, out = load(), {}
    for flags in K1_INSTANTIATIONS:
        blocks = ctypes.c_int(0)
        err = lib.rt_trace_k1_blocks_per_sm(*flags, ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy of trace_k1{flags}: cudaError "
                               f"{err}")
        out[f"trace_k1<{','.join(map(str, flags))}>"] = blocks.value
    return out


def k1_sass_loads(library: str | None = None, text: str | None = None
                  ) -> dict:
    """The loads of each K1 instantiation's SASS ("trace_k1<...>", its
    template arguments), by where they read (`sass.load_counts`): the
    whole kernel (`whole`) and each loop over the unrolled record's rows
    (`row_loops`, `sass.row_loops`); from `cuobjdump -sass` of the library
    (this checkout's build unless named), or from its listing `text`."""
    from . import sass
    if text is None:
        from ._build import build
        text = sass.cuobjdump_sass(library or build()[0])
    out = {}
    for name, instrs in sass.functions(text).items():
        m = re.search(r"trace_k1I((?:L[bi]\d+E)+)E", name)
        if m:
            flags = ",".join(re.findall(r"L[bi](\d+)E", m.group(1)))
            out[f"trace_k1<{flags}>"] = dict(
                whole=sass.load_counts([s for _, s in instrs]),
                row_loops=sass.row_loops(instrs))
    return out


def k1_work(ops: TraceOperands, counts: dict, n_pix: int,
            n_samples: int, one_level: bool = False,
            probe: bool = False) -> tuple[int, int]:
    """(operations, bytes) of K1 on a run's paths: `trace_plain`'s counts
    of lane bounces, of noise and image lanes, of the box members an exact
    leaf cull tests (a grid's in the strip pass's form), of the slab tests an exact two-level cull makes, of
    walk bounces, of textured-light hits, rect-UV lanes, textured-medium
    events and roulette draws, times K1_OPS, with the scene's structure
    per lane bounce (the sphere leaf cull's members counted as one leaf's);
    the sums read and written once, every record and the atlas read once.
    one_level: count the cull as a slab test of every leaf a lane bounce,
    the one-level cull's work, in place of the two-level cull's. probe: the
    cost probe's work (`trace_probe`), the paths alone: without what only
    colours a path (the noise, image, textured-light, rect-UV and
    textured-medium lanes, and the atlas; a scene that plays roulette keeps
    them, since its paths follow their colours), and with the busy row
    written once (8 bytes a pixel) in place of the sums read and written."""
    rows = ops.walk[0].tolist()   # the unrolled prims a ray tests
    n_sph = int((ops.rec[rows, R_IS_SPHERE] > 0).sum()) if rows else 0
    n_rect = len(rows) - n_sph
    n_frame = len(set(ops.walk[1].tolist()) - {-1})
    n_leaf = int(ops.leaves.shape[0])
    per_seg = (K1_OPS["segment"] + n_sph * K1_OPS["sphere"]
               + n_rect * K1_OPS["rect"] + n_frame * K1_OPS["frame"]
               + min(int(ops.dyn.shape[0]), SPH_LEAF) * K1_OPS["member"]
               + int(ops.med.shape[0]) * K1_OPS["medium"])
    if one_level:
        per_seg += (n_leaf * K1_OPS["leaf"]
                    + int(ops.bleaves.shape[0]) * K1_OPS["box_leaf"])
    per_walk = (K1_OPS["walk"] + int(ops.interior.shape[0])
                * K1_OPS["interior"] + int(ops.med.shape[0])
                * K1_OPS["medium"])
    colour = not probe or bool(ops.feats & FEAT_RR)
    n_ops = (counts["segments"] * per_seg
             + n_pix * n_samples * K1_OPS["sample"]
             + counts["box"] * K1_OPS["box_strip" if ops.grid else "box"]
             + (0 if one_level else counts["cull"] * K1_OPS["leaf"]
                + counts["box_cull"] * K1_OPS["box_leaf"])
             + counts["walk"] * per_walk + counts["rr"] * K1_OPS["rr"]
             + (sum(counts[k] * K1_OPS[k] for k in (
                 "noise", "image", "emis_tex", "rect_uv", "med_tex"))
                if colour else 0))
    n_bytes = (8 if probe else 2 * 3 * 8) * n_pix + sum(
        t.numel() * t.element_size()
        for t in (ops.rec, ops.walk, ops.dyn, ops.leaves, ops.sups, ops.cam,
                  ops.med, ops.atlas if colour else ops.atlas[:0], ops.box,
                  ops.bleaves, ops.bsups, ops.interior, ops.interior_kind))
    return n_ops, n_bytes


# -- K1f: the cost probe and the balanced pixel table
# (pallas_tracer.py:2817-2972)

def pick_block(nx: int, ny: int) -> tuple[int, int]:
    """2D pixel-block tile shape (BX, BY = TILE // BX) minimizing the padded
    lane count for an nx×ny image (pallas_tracer.py `pick_block`). The
    port's kernel keeps its scanline layout without a table; the block
    serves only as `cost_order`'s tie-break."""
    bx = min((32, 64, 128, 256), key=lambda w: (
        -(-nx // w) * w * (-(-ny // (TILE // w)) * (TILE // w))))
    return bx, TILE // bx


def balanced_pix_table(order: np.ndarray, n_pix: int, kpix: int):
    """Snake-striped kpix-bank pixel table from a cost permutation →
    (perm, grid, pix_table[grid·kpix·SUB, LANES]), pallas_tracer.py
    `balanced_pix_table`: tile g's bank b is the next TILE pixels of the
    order, odd banks reversed so that a thread's kpix pixels sum to about
    the tile's mean cost; index n_pix pads. Thread j of tile g renders
    pix_table.reshape(-1)[(g·kpix + b)·TILE + j], b < kpix."""
    grid = -(-n_pix // (TILE * kpix))
    ids = np.full(grid * kpix * TILE, n_pix, np.int32)
    ids[:n_pix] = order
    ids = ids.reshape(grid, kpix, TILE)
    ids[:, 1::2] = ids[:, 1::2, ::-1].copy()
    return ids.reshape(-1), grid, ids.reshape(grid * kpix * SUB, LANES)


def cost_order(cost: np.ndarray, nx: int, ny: int,
               block: tuple[int, int]) -> np.ndarray:
    """The pixel order of cost-balanced tiles from a per-pixel cost image
    (busy segments, [ny, nx], row 0 on top) → int32[nx·ny]: the part of
    pallas_tracer.py `_cost_permutation` after its probe (2934-2972), in
    its f32 cost and f64 integral image. A SMOOTH × SMOOTH box filter
    (edges padded) lends each pixel its neighbours' samples, since a
    few-spp estimate of a heavy-tailed path length is mostly noise; then
    equal-population rank buckets, ties broken by 2-D block, then by
    index."""
    bxw, byh = block
    gx = -(-nx // bxw)
    cost = np.asarray(cost, np.float32).reshape(ny, nx)
    n_pix = nx * ny
    k = SMOOTH | 1
    pad = np.pad(cost, k // 2, mode="edge")
    ii = np.zeros((pad.shape[0] + 1, pad.shape[1] + 1), np.float64)
    ii[1:, 1:] = pad.cumsum(0).cumsum(1)
    cost = (ii[k:, k:] - ii[:-k, k:] - ii[k:, :-k]
            + ii[:-k, :-k]).reshape(-1)
    yy, xx = np.divmod(np.arange(n_pix), nx)
    rank = np.empty(n_pix, np.int64)
    rank[np.argsort(cost, kind="stable")] = np.arange(n_pix)
    bucket = rank * BUCKETS // n_pix
    blk = (yy // byh) * gx + (xx // bxw)
    return np.lexsort((np.arange(n_pix), blk, bucket)).astype(np.int32)


def stats_size(n_pix: int, pix: torch.Tensor | None = None,
               kpix: int = 1, dda: bool = False) -> int:
    """Length of a stats buffer (`trace`'s stats): three rows of n_pix (each
    pixel's segments, dynamic sphere member tests and box member tests),
    then one entry per warp of the launch (its steps: the largest segment
    total among its threads, over their banks and samples), then with dda a row of n_pix (each
    pixel's box member tests whose slab the ray crosses). A launch without
    a table runs n_pix threads rounded up to THREADS; with one, a thread
    per slot of a bank."""
    threads = (pix.numel() // kpix if pix is not None
               else -(-n_pix // THREADS) * THREADS)
    return 3 * n_pix + threads // WARP + (n_pix if dda else 0)


def new_stats(nx: int, ny: int, device, pix: torch.Tensor | None = None,
              kpix: int = 1, dda: bool = False) -> torch.Tensor:
    """A zeroed stats buffer for `trace` (see `stats_size`)."""
    return torch.zeros(stats_size(nx * ny, pix, kpix, dda),
                       dtype=torch.int64, device=device)


def stats_rows(stats: torch.Tensor, n_pix: int, dda: bool = False):
    """(busy, sphere member tests, box member tests, warp steps): views of a
    stats buffer (with dda, one that holds the DDA row)."""
    return (stats[:n_pix], stats[n_pix:2 * n_pix],
            stats[2 * n_pix:3 * n_pix],
            stats[3 * n_pix:stats.numel() - (n_pix if dda else 0)])


def dda_row(stats: torch.Tensor, n_pix: int) -> torch.Tensor:
    """The DDA row of a stats buffer of `new_stats(..., dda=True)`: per
    pixel its box member tests whose slab the ray crosses."""
    return stats[stats.numel() - n_pix:]


def cost_permutation(ops: TraceOperands, nx: int, ny: int, max_depth: int,
                     device) -> np.ndarray:
    """The pixel order of cost-balanced tiles (pallas_tracer.py
    `_cost_permutation`): the cost probe (`cost_probe`: PROBE_SPP samples
    at the fixed seed PROBE_SEED), its per-pixel segments as the cost
    image, then `cost_order`. The probe's seed is fixed because its
    order is cached across renders: the first caller's seed must not steer
    every later render's layout."""
    busy = cost_probe(ops, nx, ny, max_depth, device).cpu().numpy()
    return cost_order(busy.reshape(ny, nx), nx, ny, pick_block(nx, ny))


def cost_probe(ops: TraceOperands, nx: int, ny: int, max_depth: int,
               device) -> torch.Tensor:
    """The cost probe of a balanced render: `trace_probe` of PROBE_SPP
    samples at PROBE_SEED → its per-pixel segments (int64[nx·ny], row 0 on
    top, on device), the row 0 that a stats launch of the same samples
    counts in any layout. On a card the samples are split as `probe_split`
    says, so that a small image fills the card too; the row does not depend
    on it."""
    device = torch.device(device)
    busy = torch.zeros(nx * ny, dtype=torch.int64, device=device)
    split = 1
    if device.type == "cuda":
        split = probe_split(probe_tiles(nx, ny),
                            probe_resident(device, bool(ops.grid)))
    return trace_probe(ops, busy, nx=nx, ny=ny, seed=PROBE_SEED, sample0=0,
                       n_samples=PROBE_SPP, max_depth=max_depth,
                       split=split)


def probe_tiles(nx: int, ny: int) -> int:
    """The BLOCK_W × BLOCK_H tiles of an nx×ny image: a probe's blocks for
    each part of its samples, a table's blocks at kpix 1."""
    return -(-nx // BLOCK_W) * -(-ny // BLOCK_H)


def probe_warps(nx: int, ny: int, split: int = 1) -> int:
    """The warps of a `trace_probe` launch: split × tiles blocks of THREADS
    threads; the length of its steps row."""
    return split * probe_tiles(nx, ny) * (THREADS // WARP)


def probe_split(n_tiles: int, resident: int,
                n_samples: int = PROBE_SPP) -> int:
    """Into how many parts `cost_probe` splits each pixel's n_samples
    samples: the least power of two that divides them and gives the launch
    PROBE_WAVES waves of `resident` blocks (the SMs × the blocks of the
    probe's instantiation an SM holds), n_tiles blocks a part; at most a
    sample a thread. A launch ends with its last blocks, so shorter blocks
    fill the card at a small image and shorten the last wave at a large
    one; each split also adds warp steps (a warp waits for the longest of
    fewer samples at a time), so it stops at PROBE_WAVES."""
    split = 1
    while (split < n_samples and n_samples % (2 * split) == 0
           and n_tiles * split < PROBE_WAVES * resident):
        split *= 2
    return split


# resident blocks of the probe's instantiations on each card, by (index,
# box grid)
_RESIDENT: dict = {}


def probe_resident(device, grid: bool = False) -> int:
    """The probe's blocks that the card of `device` holds at once: its SMs
    × the blocks of the probe's instantiations an SM holds (the fewer of
    the two, with and without the leaves in shared memory; a box grid's
    two with grid; the occupancy query, once per card)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if (idx, grid) not in _RESIDENT:
        with torch.cuda.device(idx):
            per_sm = k1_blocks_per_sm()
        dyn = 2 if grid else 1
        _RESIDENT[idx, grid] = (
            torch.cuda.get_device_properties(idx).multi_processor_count
            * min(per_sm[f"trace_k1<1,{dyn},0,2,1>"],
                  per_sm[f"trace_k1<1,{dyn},1,2,1>"]))
    return _RESIDENT[idx, grid]


def _check_probe(busy, nx, ny, n_samples, split, steps):
    """The busy and steps rows and the split as the probe's launch takes
    them."""
    if busy.dtype != torch.int64 or tuple(busy.shape) != (nx * ny,) \
            or not busy.is_contiguous():
        raise ValueError(f"busy must be a contiguous int64[{nx * ny}]")
    if split < 1 or n_samples % split:
        raise ValueError(f"split {split} must be ≥ 1 and divide the "
                         f"{n_samples} samples")
    if steps is not None and (
            steps.device != busy.device or steps.dtype != torch.int64
            or tuple(steps.shape) != (probe_warps(nx, ny, split),)
            or not steps.is_contiguous()):
        raise ValueError(f"steps must be a contiguous int64"
                         f"[{probe_warps(nx, ny, split)}] on busy's device")


def trace_probe(ops: TraceOperands, busy: torch.Tensor, *, nx: int, ny: int,
                seed: int, sample0: int, n_samples: int, max_depth: int,
                split: int = 1,
                steps: torch.Tensor | None = None) -> torch.Tensor:
    """Wrapper of K1f's cost probe launch (csrc/tracer.cu, the STATS == 2
    instantiations): adds to busy (int64[nx·ny], updated in place and
    returned) each pixel's segments over samples sample0 ..
    sample0+n_samples−1, walk bounces included: the stats launch's row 0 of
    the same samples, bit for bit. It keeps no radiance and counts nothing
    else. Its blocks take the tiles of `tile_slots`, a pixel a thread; with
    split > 1 (a divisor of n_samples) each tile's pixels run in split
    blocks, n_samples / split samples each, whose counts add up. steps
    (int64[probe_warps(nx, ny, split)]), when given, gets per warp of the
    launch the largest of its threads' segments (a warp's iterations).

    On CUDA tensors it launches the kernel (building it at first use) or
    raises; on CPU tensors it runs `probe_plain`.
    """
    _check_operands(ops, None, nx, ny, dev=busy.device)
    _check_probe(busy, nx, ny, n_samples, split, steps)
    _check_range(seed, sample0, n_samples, nx, ny, max_depth)
    kw = dict(nx=nx, ny=ny, seed=seed, sample0=sample0, n_samples=n_samples,
              max_depth=max_depth)
    if busy.device.type == "cpu":
        return probe_plain(ops, busy, split=split, steps=steps, **kw)
    if busy.device.type != "cuda":
        raise ValueError(f"no kernel for device {busy.device}")
    from ._build import load
    lib = load()
    with torch.cuda.device(busy.device):
        _launch(lib, ops, None, **kw,
                stream=torch.cuda.current_stream().cuda_stream, stats=busy,
                probe_split=split, probe_steps=steps)
    return busy


def probe_plain(ops: TraceOperands, busy: torch.Tensor, *, nx: int, ny: int,
                seed: int, sample0: int, n_samples: int, max_depth: int,
                split: int = 1,
                steps: torch.Tensor | None = None) -> torch.Tensor:
    """`trace_probe` in plain torch, on any device: for each of the split
    parts of the samples, the row 0 of a stats launch of them
    (`trace_plain`) added to busy; with steps, that row laid out as the
    part's threads (`tile_slots`; part j's blocks follow part j − 1's) and
    the largest of each warp's 32 added to its warp's entry."""
    n_pix, per = nx * ny, n_samples // split
    dev = busy.device
    slots = tile_slots(nx, ny, dev).view(-1).long()
    for j in range(split):
        st = new_stats(nx, ny, dev)
        trace_plain(ops, torch.zeros((3, n_pix), dtype=torch.float64,
                                     device=dev),
                    nx=nx, ny=ny, seed=seed, sample0=sample0 + j * per,
                    n_samples=per, max_depth=max_depth, stats=st)
        row = stats_rows(st, n_pix)[0]
        busy += row
        if steps is not None:
            per_thread = torch.cat([row, row.new_zeros(1)])[slots]
            w = per_thread.numel() // WARP
            steps[j * w:(j + 1) * w] += per_thread.view(-1, WARP).amax(1)
    return busy


def tile_slots(nx: int, ny: int, device) -> torch.Tensor:
    """The pixels of the image's BLOCK_W × BLOCK_H tiles, the tiles in
    raster order, each row by row, nx·ny past the image's edge →
    int32[tiles, THREADS] on device: a block's pixels, thread by thread, in
    the probe and (its rows dealt by cost) in `block_tile_table`."""
    n_pix = nx * ny
    pix = torch.arange(n_pix, dtype=torch.int32, device=device)
    return _tile_grid(pix, nx, ny, n_pix).permute(0, 2, 1, 3) \
        .reshape(-1, THREADS)


def _tile_grid(x: torch.Tensor, nx: int, ny: int, fill) -> torch.Tensor:
    """A per-pixel row x (nx·ny values, row 0 on top) on the grid of whole
    tiles of BLOCK_W × BLOCK_H pixels, `fill` where a tile runs past the
    image → [tile rows, BLOCK_H, tile columns, BLOCK_W], on x's device."""
    gx, gy = -(-nx // BLOCK_W), -(-ny // BLOCK_H)
    grid = x.new_full((gy * BLOCK_H, gx * BLOCK_W), fill)
    grid[:ny, :nx] = x.view(ny, nx)
    return grid.view(gy, BLOCK_H, gx, BLOCK_W)


def block_tile_table(busy: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """The card's balanced pixel table, kpix 1, from a cost probe's
    per-pixel segments (`cost_probe`) → int32[a whole number of TILEs] on
    busy's device, computed there. A tile's cost is the Σ of its pixels'
    segments; block b renders the tile of rank b in descending cost, ties
    in tile order (a stable sort; tiles in raster order), thread t on the
    tile's column t % BLOCK_W and row t // BLOCK_W, so a warp holds two
    rows. The block scheduler dispatches blocks in about index order, so
    the longest start first and the last wave holds the cheapest. nx·ny
    pads the clipped tiles and the table's end. Few distinct torch ops,
    since each costs a process tens of ms at its first use on a card."""
    n_pix = nx * ny
    cost = _tile_grid(busy, nx, ny, 0).sum(dim=(1, 3)).view(-1)
    rank = torch.sort(cost, descending=True, stable=True).indices
    slots = tile_slots(nx, ny, busy.device)
    table = torch.full((-(-slots.numel() // TILE) * TILE,), n_pix,
                       dtype=torch.int32, device=busy.device)
    table[:slots.numel()] = slots.index_select(0, rank).view(-1)
    return table


def render_table(ops: TraceOperands, nx: int, ny: int, max_depth: int,
                 device) -> torch.Tensor:
    """The pixel table, kpix 1, that `render_kernel` renders a balanced
    image from: `block_tile_table` of the cost probe, on device; nothing
    goes to the host. JAX's table (`cost_permutation`,
    `balanced_pix_table`) stays the yardstick it is compared with."""
    return block_tile_table(cost_probe(ops, nx, ny, max_depth, device),
                            nx, ny)


# balanced pixel tables on their device, by `_perm_cache_key`; the oldest
# entry goes beyond _PERM_CACHE_SIZE
_PERM_CACHE: dict = {}
_PERM_CACHE_SIZE = 16


def _record_digest(srec: SceneRecord) -> bytes:
    """A digest of everything in a scene record."""
    h = hashlib.sha256()
    for name in SceneRecord.__dataclass_fields__:
        v = getattr(srec, name)
        if isinstance(v, np.ndarray):
            h.update(f"{name}{v.dtype}{v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(f"{name}={v!r};".encode())
    return h.digest()


def _perm_cache_key(cam_np, srec: SceneRecord, nx, ny, max_depth, rr_depth,
                    device):
    """The key of a balanced pixel table (pallas_tracer.py
    `_perm_cache_key`, whose kpix the card's table fixes at 1): the camera
    record's bytes, a digest of the scene record (the port rebuilds its
    record on every call, so an id() key would never hit), the size, depth
    cap, roulette depth and the device the table lives on."""
    return (bytes(np.asarray(cam_np).tobytes()), _record_digest(srec), nx,
            ny, max_depth, rr_depth, str(torch.device(device)))


def launch_plan(n_pix: int, spp: int, device,
                spp_chunk: int | None = None, done: int = 0):
    """How `render_kernel` splits a render into `trace` calls → (kpix of
    JAX's balanced pixel table, `balanced_pix_table`: each thread renders
    kpix pixels, capped so that padding never exceeds one tile's worth of
    slots, pallas_tracer.py:3071; the render's own table, `render_table`,
    has kpix 1, so only the comparisons with JAX's table read it;
    [(sample0, n_samples)] of the calls from sample `done` on (a resumed
    render's first unfinished sample): spp_chunk samples each, by default
    as many as the device's lane budget holds)."""
    if spp_chunk is None:
        budget = (_KERNEL_CHUNK_LANES if torch.device(device).type == "cuda"
                  else _PLAIN_CHUNK_LANES)
        spp_chunk = max(1, min(spp, budget // n_pix))
    return (max(1, min(KPIX, n_pix // TILE)),
            [(s0, min(spp_chunk, spp - s0))
             for s0 in range(done, spp, spp_chunk)])


def render_kernel(scene: SceneTables, cam: Camera, nx: int, ny: int, spp: int,
                  *, device="cuda", seed: int = 0, max_depth: int = 50,
                  spp_chunk: int | None = None,
                  timers: Timers | None = None,
                  rr_depth: int | None = None,
                  balance: bool | None = None,
                  checkpoint: str | None = None,
                  srec: SceneRecord | None = None,
                  progress=None,
                  _stop_after_chunks: int | None = None) -> np.ndarray | None:
    """Full-image render through the K1 kernel → float32 [ny, nx, 3], row 0
    at the top, with the reference's gamma (sqrt + clamp,
    tests/test.rs:72-75).

    device: where the sums live and the trace runs. "cuda" (the default)
    launches the kernel, and raises when CUDA is absent; "cpu" runs the
    plain version. spp_chunk: samples per `trace` call (default: a lane
    budget). The image does not depend on it. rr_depth: Russian roulette
    from this bounce on (the JAX CLI's --rr-depth; not in the reference),
    or None. balance: render from a cost-balanced pixel table
    (`render_pallas(balance=)`; the card's layout, `render_table`: one
    pixel a thread, a block on one compact tile, the tiles dealt heaviest
    first); None turns it on for a scene with a dynamic sphere or box table
    at spp ≥ 8, as JAX does (pallas_tracer.py:3061-3063). Its probe runs
    once per scene, camera, size and depth (a value-keyed cache), timed as
    the phase `balance_probe`; the image does not depend on it.
    checkpoint: an .npz path; after each chunk the f64 sums and the
    samples done are saved (phase `checkpoint_io`), and a render whose
    meta (size, spp, seed, depth caps, the scene record's digest, the
    camera record) matches resumes at the first unfinished sample, with
    any spp_chunk, balance or device; a mismatch warns on stderr and starts
    over. srec: the scene's record when the caller already built it.
    progress: called as progress(samples done, spp) after each chunk (e.g.
    `utils.progress.ProgressBar`); it reads no device value.
    _stop_after_chunks: a test hook that stops the render after that many
    chunks, as if the process had died, and returns None. Raises
    UnsupportedScene for scenes outside the kernel.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but torch.cuda.is_available() "
                           "is false")
    if min(nx, ny, spp) <= 0 or max_depth < 0:
        raise ValueError(f"bad render size {nx}x{ny} spp={spp} "
                         f"depth={max_depth}")
    if timers is None:
        timers = Timers()
    n_pix = nx * ny

    with timers.phase("record_build"):
        if srec is None:
            srec = build_scene_record(scene)
        cam_np = build_camera_record(cam)
    if device.type == "cuda":
        from ._build import load
        with timers.phase("kernel_build"):
            load()
    with timers.phase("upload"):
        ops = trace_operands(srec, cam_np, device, rr_depth)
        sums = torch.zeros((3, n_pix), dtype=torch.float64, device=device)
    done = 0
    want = None
    if checkpoint:
        from .. import checkpoint as ck
        want = ck.meta(ck.ENGINE_KERNEL, nx, ny, spp, seed, max_depth,
                       rr_depth, _record_digest(srec), cam_np.tobytes())
        got = ck.load(checkpoint, want)
        if got is not None:
            sums = torch.from_numpy(got["sums"]).to(device)
            done = int(got["done"])
    chunks = launch_plan(n_pix, spp, device, spp_chunk, done)[1]
    if balance is None:
        balance = (srec.dyn_rec.shape[0] > 0 or srec.box_rec.shape[0] > 0) \
            and spp >= 8
    pix = None
    if balance:
        key = _perm_cache_key(cam_np, srec, nx, ny, max_depth, rr_depth,
                              sums.device)
        pix = _PERM_CACHE.get(key)
        if pix is None:
            with timers.phase("balance_probe"):
                pix = render_table(ops, nx, ny, max_depth, device)
            while len(_PERM_CACHE) >= _PERM_CACHE_SIZE:
                _PERM_CACHE.pop(next(iter(_PERM_CACHE)))
            _PERM_CACHE[key] = pix
    for i, (s0, n) in enumerate(chunks):
        with timers.phase("trace"):
            trace(ops, sums, nx=nx, ny=ny, seed=seed, sample0=s0,
                  n_samples=n, max_depth=max_depth, pix=pix)
        if checkpoint:
            with timers.phase("checkpoint_io"):
                ck.save(checkpoint, want, sums=sums.cpu().numpy(),
                        done=s0 + n)
        if progress is not None:
            progress(s0 + n, spp)
        if _stop_after_chunks is not None and i + 1 >= _stop_after_chunks:
            return None
    with timers.phase("finalize"):
        img = finalize_image(sums.T.cpu().numpy(), spp, nx, ny)
    return img

