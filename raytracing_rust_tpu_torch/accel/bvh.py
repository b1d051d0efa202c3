"""Flat bounding-volume hierarchy of the general tier: a host build and a
per-lane stack traversal in torch ops.

Counterpart of `raytracing_rust_tpu/accel/bvh.py`, whose layout and
algorithm it keeps:

* **Build** on the host in numpy (`build_bvh`): a median split over the
  primitives' bbox minima along the largest centroid extent (the reference's
  src/bvh.rs:17-66 with a deterministic axis in place of its
  `thread_rng()`), into flat arrays: node AABBs rounded outward to f32,
  interleaved [left, right] child ids, leaf counts and a primitive
  permutation padded with −1 to whole leaves. The arrays equal the JAX
  package's numpy build bit for bit.
* **Per-primitive AABBs** (`prim_aabbs`) in float64, vectorized over the
  primitives: rect boxes follow the rect's plane and rotated instances get
  their corners' box (the JAX package's fixes of reference rect.rs:71-75
  and rotate.rs:36-37).
* **Traversal** (`bvh_closest_hit`): each lane pops one node an iteration
  from its own stack, slab-tests it against its shrinking best t, pushes
  both children of an internal node it crosses (right, then left on top:
  the reference's unordered descent) and tests the prims of a leaf it
  crosses, keeping the first strictly nearer one in traversal order. The
  loop runs on the live lanes only: every `COMPACT_EVERY` iterations the
  lanes whose stacks are empty are written out and dropped, which changes
  no lane's result. A lane gets the prim and t that JAX's traversal gives
  it on the same ray; against the dense scan (`ops/intersect.closest_hit`,
  ties to the lowest id) only exact ties and near-tangent rays can differ.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..models.scene import PRIM_MOVING_SPHERE, PRIM_RECT, SceneTables
from ..ops.intersect import BIG, Hit, PrimPack, _dot, pack_prims
from ..ops.rng import sqrt_rn

LEAF_SIZE = 4
MAX_STACK = 48  # ≥ 2 + the tree's depth; final_scene (3,400 prims) needs ~13
# iterations of the traversal between two compactions of its live lanes
COMPACT_EVERY = 4

# when a list, each `bvh_closest_hit` appends (lanes, iterations, live
# lanes at its last compaction before the end): the loop's shape, for
# measurement only
RECORD: list | None = None


@dataclass
class FlatBVH:
    node_min: torch.Tensor    # f32[Nn, 3]
    node_max: torch.Tensor    # f32[Nn, 3]
    node_left: torch.Tensor   # i32[2·Nn] [left, right] pairs | first slot, 0
    node_count: torch.Tensor  # i32[Nn]  0 = internal, else leaf prim count
    prim_order: torch.Tensor  # i32[ceil(P/L)·L] scene prim ids, −1 padding
    # the leaf width prim_order was padded to: the traversal tests this many
    # slots a leaf (a tree of 8-wide leaves read 4 at a time would skip
    # half of each leaf)
    leaf_size: int = LEAF_SIZE

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def to(self, device) -> "FlatBVH":
        """The same tree with every table on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "leaf_size"})


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def prim_aabbs(scene: SceneTables) -> tuple[np.ndarray, np.ndarray]:
    """World-space AABB of each primitive → (lo, hi) f64[P, 3].

    Sphere: center ± |r|, over both centers of a moving sphere (reference
    sphere.rs:79-84, :165-174). Rect: its bounds in its plane, ±1e-4 along
    the normal. A prim under a transform: the box of its box's eight corners
    rotated by +θ about the transform's axis and translated (the correct
    form of rotate.rs:36-58 + traslate.rs:26-32). The JAX package's loop
    over the prims, as array operations in the same float64 order."""
    ptype = _host(scene.prim_type)
    data = _host(scene.prim_data, np.float64)
    axis = _host(scene.prim_axis).astype(np.int64)
    xf = _host(scene.prim_xform).astype(np.int64)
    xf_axis = _host(scene.xf_axis).astype(np.int64)
    xf_sin = _host(scene.xf_sin, np.float64)
    xf_cos = _host(scene.xf_cos, np.float64)
    xf_off = _host(scene.xf_offset, np.float64)
    c0 = data[:, 0:3]
    r = np.abs(data[:, 3:4])
    lo, hi = c0 - r, c0 + r
    mov = (ptype == PRIM_MOVING_SPHERE)[:, None]
    c1 = data[:, 4:7]
    lo = np.where(mov, np.minimum(lo, c1 - r), lo)
    hi = np.where(mov, np.maximum(hi, c1 + r), hi)

    rect = np.nonzero(ptype == PRIM_RECT)[0]
    ka = axis[rect]
    aa, bb = (ka + 1) % 3, (ka + 2) % 3
    k = data[rect, 4]
    for out, vk, va, vb in ((lo, k - 1e-4, data[rect, 0], data[rect, 1]),
                            (hi, k + 1e-4, data[rect, 2], data[rect, 3])):
        out[rect, ka] = vk
        out[rect, aa] = va
        out[rect, bb] = vb

    moved = np.nonzero(xf != 0)[0]
    if moved.size:
        x = xf[moved]
        ax = xf_axis[x]
        s, c = xf_sin[x][:, None], xf_cos[x][:, None]
        # the 8 corners [m, 8, 3]: corner (i, j, k) takes lo or hi per axis
        bits = (np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1
        cs = np.where(bits[None] == 1, hi[moved][:, None, :],
                      lo[moved][:, None, :])
        ia, ib = (np.broadcast_to(((ax + k) % 3)[:, None, None],
                                  (moved.size, 8, 1)) for k in (1, 2))
        ca = np.take_along_axis(cs, ia, 2)[..., 0]
        cb = np.take_along_axis(cs, ib, 2)[..., 0]
        out = cs.copy()
        np.put_along_axis(out, ia, (c * ca - s * cb)[..., None], 2)
        np.put_along_axis(out, ib, (s * ca + c * cb)[..., None], 2)
        out += xf_off[x][:, None, :]
        lo[moved] = out.min(axis=1)
        hi[moved] = out.max(axis=1)
    return lo, hi


def _outward_f32(nmin: np.ndarray, nmax: np.ndarray):
    """f64 node bounds → f32 rounded outward (min down, max up): a cast to
    the nearest f32 can pull a node's box half an ulp inside its prims, and
    a ray grazing a prim in that sliver misses the whole subtree (the JAX
    package measured two such pixels a 64×36 frame at 100k prims)."""
    lo32 = np.asarray(nmin, np.float32)
    hi32 = np.asarray(nmax, np.float32)
    lo32 = np.where(lo32.astype(np.float64) > np.asarray(nmin, np.float64),
                    np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < np.asarray(nmax, np.float64),
                    np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def _check_stack_depth(left: np.ndarray, right: np.ndarray,
                       count: np.ndarray) -> None:
    """Raise when the tree is too deep for the traversal's fixed stack: a pop
    pushes at most two children, so a lane holds at most depth + 1 entries,
    and the traversal clamps its writes to MAX_STACK − 1."""
    depth = np.zeros(len(count), np.int32)
    todo = [0]
    maxd = 0
    while todo:
        nid = todo.pop()
        maxd = max(maxd, int(depth[nid]))
        if count[nid] == 0:  # internal
            for ch in (left[nid], right[nid]):
                depth[ch] = depth[nid] + 1
                todo.append(int(ch))
    if maxd + 2 > MAX_STACK:
        raise ValueError(
            f"BVH depth {maxd} needs a {maxd + 2}-slot traversal stack "
            f"but MAX_STACK={MAX_STACK}")


def build_bvh(scene: SceneTables, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """The tree of a scene's prims, on the host (CPU tensors): the JAX
    package's numpy build (`build_bvh(prefer_native=False)`), node for node.
    A node's prims are sorted by their bbox minimum along the largest extent
    of their centroids (a stable sort) and split at the median; nodes are
    numbered in preorder, a leaf holds ≤ leaf_size prims in consecutive
    slots of prim_order, padded with −1 to a multiple of leaf_size."""
    lo, hi = prim_aabbs(scene)
    centroids = 0.5 * (lo + hi)

    node_min, node_max, node_left, node_count = [], [], [], []
    order: list[int] = []
    rights: list[tuple[int, int]] = []

    def emit(ids: np.ndarray) -> int:
        nid = len(node_min)
        node_min.append(lo[ids].min(axis=0))
        node_max.append(hi[ids].max(axis=0))
        node_left.append(0)
        node_count.append(0)
        if len(ids) <= leaf_size:
            node_left[nid] = len(order)
            node_count[nid] = len(ids)
            order.extend(int(i) for i in ids)
            order.extend([-1] * (-len(order) % leaf_size))
        else:
            ext = centroids[ids].max(axis=0) - centroids[ids].min(axis=0)
            ax = int(np.argmax(ext))
            ids = ids[np.argsort(lo[ids, ax], kind="stable")]
            mid = len(ids) // 2
            node_left[nid] = emit(ids[:mid])
            rights.append((nid, emit(ids[mid:])))
        return nid

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 10000))
    try:
        emit(np.arange(lo.shape[0]))
    finally:
        sys.setrecursionlimit(limit)

    right = np.zeros(len(node_min), np.int32)
    for nid, r in rights:
        right[nid] = r
    left = np.asarray(node_left, np.int32)
    count = np.asarray(node_count, np.int32)
    _check_stack_depth(left, right, count)
    nmin32, nmax32 = _outward_f32(np.asarray(node_min), np.asarray(node_max))
    return FlatBVH(
        node_min=torch.from_numpy(nmin32), node_max=torch.from_numpy(nmax32),
        node_left=torch.from_numpy(np.stack([left, right], 1).reshape(-1)),
        node_count=torch.from_numpy(count),
        prim_order=torch.from_numpy(np.asarray(order, np.int32)),
        leaf_size=leaf_size)


# the columns of `leaf_rows`: a prim's kind and its PrimPack fields
_SPH, _RECT, _C0, _DC, _T0, _INV_DT, _R2 = 0, 1, 2, 5, 8, 9, 10
_KN, _AN, _BN, _OFF = 11, 14, 17, 20   # _OFF: k_off, a_off, b_off, a0 … b1
ROW_FIELDS = 27


def leaf_rows(pack: PrimPack) -> torch.Tensor:
    """The PrimPack as one row a prim → f[P, ROW_FIELDS], so a leaf's prims
    are one gather (`_leaf_candidates` reads its columns)."""
    f = pack.c0.dtype

    def col(x):
        return x.to(f)[:, None]
    return torch.cat([
        col(pack.is_sphere), col(pack.is_rect), pack.c0, pack.dc,
        col(pack.t0), col(pack.inv_dt), col(pack.r2), pack.kn, pack.an,
        pack.bn, torch.stack([pack.k_off, pack.a_off, pack.b_off, pack.a0,
                              pack.a1, pack.b0, pack.b1], dim=1)], dim=1)


def _leaf_candidates(sub: torch.Tensor, o, d, time, t_min: float, t_max):
    """Candidate t of each lane's gathered prims → [n, L] (BIG = miss).
    sub: `leaf_rows` rows [n, L, ROW_FIELDS]; t_max: f[n]. The JAX
    package's `_leaf_candidates`: `closest_hit`'s sphere and rect tests on
    per-(lane, slot) prims, in its order."""
    oL, dL = o[:, None, :], d[:, None, :]
    tm = t_max[:, None]

    # spheres
    frac = (time[:, None] - sub[..., _T0]) * sub[..., _INV_DT]
    cprime = sub[..., _C0:_C0 + 3] + frac[..., None] * sub[..., _DC:_DC + 3]
    oc = oL - cprime
    a = _dot(d, d)[:, None]
    b = _dot(oc, dL)
    cc = _dot(oc, oc) - sub[..., _R2]
    disc = b * b - a * cc
    pos = disc > 0.0
    sq = sqrt_rn(torch.where(pos, disc, 1.0))
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    near_ok = pos & (t_near > t_min) & (t_near < tm)
    far_ok = pos & (t_far > t_min) & (t_far < tm)
    t_sph = torch.where(near_ok, t_near, torch.where(far_ok, t_far, BIG))

    # rects
    kn, an, bn = (sub[..., k:k + 3] for k in (_KN, _AN, _BN))
    k_off, a_off, b_off, a0, a1, b0, b1 = (sub[..., _OFF + k]
                                           for k in range(7))
    o_kn, d_kn = _dot(oL, kn), _dot(dL, kn)
    parallel = d_kn == 0.0
    t_r = (k_off - o_kn) / torch.where(parallel, 1.0, d_kn)
    x = _dot(oL, an) + t_r * _dot(dL, an) - a_off
    y = _dot(oL, bn) + t_r * _dot(dL, bn) - b_off
    ok = ((~parallel) & (t_r > t_min) & (t_r < tm)
          & (x >= a0) & (x <= a1) & (y >= b0) & (y <= b1))
    t_rect = torch.where(ok, t_r, BIG)

    return torch.where(sub[..., _SPH] != 0, t_sph,
                       torch.where(sub[..., _RECT] != 0, t_rect, BIG))


@dataclass
class _Tables:
    """A tree and a scene's prims as the traversal reads them, on one
    device, with the CUDA graphs captured on them (`_run_graphs`)."""
    pack: PrimPack        # the pack `rows` was made from
    leaf_size: int
    nodes: torch.Tensor   # int64[Nn, 3]: right, left | first slot, count
    boxes: torch.Tensor   # f32[Nn, 2, 3]: min, max
    order: torch.Tensor   # int64[ceil(P/L)·L]
    rows: torch.Tensor    # f32[P, ROW_FIELDS] (`leaf_rows`)
    slot: torch.Tensor    # int64[L]: 0 … L − 1
    two: torch.Tensor     # int64[2]: 0, 1
    graphs: dict          # (width, t_min) → _Graph


def _tables(bvh: FlatBVH, pack: PrimPack, leaf_size: int) -> _Tables:
    """The traversal's tables of (bvh, pack), made on the first call and
    kept on the tree for the calls with the same pack (a render's
    bounces)."""
    tab = getattr(bvh, "_tables", None)
    if tab is None or tab.pack is not pack or tab.leaf_size != leaf_size:
        lr = bvh.node_left.view(-1, 2).long()
        dev = lr.device
        tab = _Tables(
            pack=pack, leaf_size=leaf_size,
            # a push writes columns 0-1 (right, left) at sp, sp + 1
            nodes=torch.cat([lr[:, 1:], lr[:, :1],
                             bvh.node_count.long()[:, None]], dim=1),
            boxes=torch.stack([bvh.node_min, bvh.node_max], dim=1),
            order=bvh.prim_order.long(), rows=leaf_rows(pack),
            slot=torch.arange(leaf_size, device=dev),
            two=torch.arange(2, device=dev), graphs={})
        bvh._tables = tab
    return tab


@dataclass
class _Lanes:
    """The traversal's per-lane state: each lane's id in the call (the
    call's lane count for a padding lane), its stack (node ids; the root, 0,
    at first; the entries at and above sp free), sp, its best t and prim,
    and its ray (origin, direction, time, inverse direction)."""
    lane: torch.Tensor
    stack: torch.Tensor
    sp: torch.Tensor
    t_best: torch.Tensor
    i_best: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    time: torch.Tensor
    iv: torch.Tensor

    def rows(self, keep) -> "_Lanes":
        return _Lanes(*(getattr(self, f.name)[keep]
                        for f in dataclasses.fields(self)))


def _step(tab: _Tables, s: _Lanes, t_min: float, masked: bool) -> None:
    """One iteration of the traversal on every lane of s, in place: pop a
    node, slab-test it against the lane's best t, test a crossed leaf's
    prims, push a crossed internal node's children (right, then left on
    top). masked: test the leaf rows of every lane and keep the crossed
    leaves' (no host sync, for a CUDA graph), else of the crossed leaves'
    lanes alone; the results are the same."""
    active = s.sp > 0
    node = s.stack.gather(1, (s.sp - 1).clamp(min=0)[:, None])[:, 0]
    s.sp.sub_(active.long())
    nd = tab.nodes[node]
    t = (tab.boxes[node] - s.o[:, None]) * s.iv[:, None]        # [n, 2, 3]
    enter = t.amin(dim=1).amax(dim=1).clamp(min=t_min)
    leave = torch.minimum(t.amax(dim=1).amin(dim=1), s.t_best)
    boxhit = active & (enter <= leave)
    is_leaf = nd[:, 2] > 0
    leaf = boxhit & is_leaf

    if masked:
        pids = tab.order[torch.where(leaf, nd[:, 1], 0)[:, None] + tab.slot]
        t = _leaf_candidates(tab.rows[pids.clamp(min=0)], s.o, s.d, s.time,
                             t_min, s.t_best)
        tc, k = torch.where(leaf[:, None] & (pids >= 0), t, BIG).min(dim=1)
        better = tc < s.t_best
        s.t_best.copy_(torch.where(better, tc, s.t_best))
        s.i_best.copy_(torch.where(better, pids.gather(1, k[:, None])[:, 0],
                                   s.i_best))
    else:
        li = torch.nonzero(leaf)[:, 0]
        if li.numel():
            pids = tab.order[nd[li, 1][:, None] + tab.slot]        # [m, L]
            tb = s.t_best[li]
            t = _leaf_candidates(tab.rows[pids.clamp(min=0)], s.o[li],
                                 s.d[li], s.time[li], t_min, tb)
            tc, k = torch.where(pids >= 0, t, BIG).min(dim=1)
            better = tc < tb
            s.t_best[li] = torch.where(better, tc, tb)
            s.i_best[li] = torch.where(better, pids.gather(1, k[:, None])
                                       [:, 0], s.i_best[li])

    push = boxhit & ~is_leaf
    kids = torch.where(push[:, None], nd[:, :2], 0).int()
    s.stack.scatter_(1, (s.sp[:, None] + tab.two).clamp(max=MAX_STACK - 1),
                     kids)
    s.sp.add_(2 * push.long())


# on the card the traversal replays COMPACT_EVERY iterations as one CUDA
# graph on lanes padded to a power of two, at least _MIN_WIDTH: eagerly,
# each of its ~150 kernels an iteration costs a launch from the host
_MIN_WIDTH = 1024


@dataclass
class _Graph:
    lanes: _Lanes
    graph: object = None


def _width(n: int) -> int:
    return max(_MIN_WIDTH, 1 << max(n - 1, 0).bit_length())


def _run_graphs(tab: _Tables, s: _Lanes, t_min: float, t_out, i_out):
    """The traversal of lanes s on the card through CUDA graphs → (its
    iterations, the live lanes before its last compaction). The lanes are
    copied into a width's own buffers, padded with lanes of sp 0 (lane id
    n, the spare last slot of t_out and i_out); a width's graph is captured
    after COMPACT_EVERY eager iterations on its first use and replayed
    after, while a quarter of the width or more is live, then the live
    lanes move to a narrower width."""
    n = t_out.shape[0] - 1  # the spare slot, a padding lane's id
    iters, live = 0, s.lane.shape[0]

    def enter(src: _Lanes) -> _Graph:
        nonlocal iters
        m = src.lane.shape[0]
        w = _width(m)
        g = tab.graphs.get((w, t_min))
        if g is None:
            dev, f = src.o.device, src.o.dtype
            g = _Graph(_Lanes(
                lane=torch.empty(w, dtype=torch.int64, device=dev),
                stack=torch.zeros((w, MAX_STACK), dtype=torch.int32,
                                  device=dev),
                sp=torch.empty(w, dtype=torch.int64, device=dev),
                t_best=torch.empty(w, dtype=f, device=dev),
                i_best=torch.empty(w, dtype=torch.int64, device=dev),
                o=torch.zeros((w, 3), dtype=f, device=dev),
                d=torch.zeros((w, 3), dtype=f, device=dev),
                time=torch.zeros(w, dtype=f, device=dev),
                iv=torch.ones((w, 3), dtype=f, device=dev)))
        for fld in dataclasses.fields(_Lanes):
            getattr(g.lanes, fld.name)[:m].copy_(getattr(src, fld.name))
        g.lanes.lane[m:] = n
        g.lanes.sp[m:] = 0
        g.lanes.stack[m:, 0] = 0
        g.lanes.t_best[m:] = BIG
        g.lanes.i_best[m:] = -1
        if g.graph is None:
            for _ in range(COMPACT_EVERY):
                _step(tab, g.lanes, t_min, True)
            iters += COMPACT_EVERY
            g.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g.graph):
                for _ in range(COMPACT_EVERY):
                    _step(tab, g.lanes, t_min, True)
            tab.graphs[(w, t_min)] = g
        return g

    g = enter(s)
    while True:
        g.graph.replay()
        iters += COMPACT_EVERY
        now = int((g.lanes.sp > 0).sum())
        if now == 0 or 4 * now <= g.lanes.lane.shape[0] > _MIN_WIDTH:
            t_out[g.lanes.lane] = g.lanes.t_best
            i_out[g.lanes.lane] = g.lanes.i_best
            if now == 0:
                return iters, live
            g = enter(g.lanes.rows(torch.nonzero(g.lanes.sp > 0)[:, 0]))
        live = now


def _run_eager(tab: _Tables, s: _Lanes, t_min: float, t_out, i_out,
               masked: bool = False):
    """The traversal of lanes s in eager ops → (its iterations, the live
    lanes before its last compaction): COMPACT_EVERY iterations, then the
    lanes whose stacks are empty are written out and dropped."""
    iters, live = 0, s.lane.shape[0]
    while s.lane.shape[0]:
        for _ in range(COMPACT_EVERY):
            _step(tab, s, t_min, masked)
        iters += COMPACT_EVERY
        t_out[s.lane] = s.t_best
        i_out[s.lane] = s.i_best
        keep = torch.nonzero(s.sp > 0)[:, 0]
        if keep.numel() < s.lane.shape[0]:
            live = s.lane.shape[0]
            s = s.rows(keep)
    return iters, live


def bvh_closest_hit(scene: SceneTables, bvh: FlatBVH, o, d, time,
                    t_min: float, pack: PrimPack | None = None,
                    leaf_size: int | None = None) -> Hit:
    """Closest hit by stacked traversal → the `Hit` of `closest_hit`.
    bvh: on the rays' device; leaf_size: the width the tree was built with
    (its own, by default). On the card the iterations run as CUDA graphs,
    elsewhere eagerly, every COMPACT_EVERY of them dropping the lanes whose
    stacks are empty; the hits are the same."""
    if leaf_size is None:
        leaf_size = bvh.leaf_size
    if pack is None:
        pack = pack_prims(scene)
    tab = _tables(bvh, pack, leaf_size)
    dev = o.device
    n = o.shape[0]
    t_out = torch.full((n + 1,), BIG, dtype=o.dtype, device=dev)
    i_out = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    s = _Lanes(lane=torch.arange(n, device=dev),
               stack=torch.zeros((n, MAX_STACK), dtype=torch.int32,
                                 device=dev),
               sp=torch.ones(n, dtype=torch.int64, device=dev),
               t_best=t_out[:n].clone(), i_best=i_out[:n].clone(), o=o, d=d,
               time=time, iv=1.0 / torch.where(d.abs() < 1e-30, 1e-30, d))
    run = _run_graphs if n and o.is_cuda else _run_eager
    iters, live_before = run(tab, s, t_min, t_out, i_out)
    if RECORD is not None:
        RECORD.append((n, iters, live_before))
    t_out, i_out = t_out[:n], i_out[:n]
    mask = t_out < BIG
    return Hit(t=t_out, idx=torch.where(mask, i_out, -1), mask=mask)
