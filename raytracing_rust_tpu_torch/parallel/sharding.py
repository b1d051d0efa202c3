"""Renders and training steps sharded over the ranks of a torch.distributed
process group.

Counterpart of `raytracing_rust_tpu/parallel/sharding.py`. The JAX package
lays its devices out as a (dp, sp) `jax.sharding.Mesh` and lets GSPMD place
the collectives; here every rank is one process with one device, and the
same two axes split the work:

* `dp`: pixel rows (contiguous ranges of flat pixel ids, or of a block's
  pixels);
* `sp`: samples (contiguous ranges of each pixel's samples); the partial
  radiance sums are added over the sp group.

Rank r sits at (r // sp, r % sp), as device r of JAX's
`devices.reshape(dp, sp)` does. The backend is NCCL for CUDA tensors and
gloo on the CPU (`init`); the code only calls `all_reduce`, which both run
on CUDA tensors too, so two ranks may share one card under gloo (NCCL
refuses two ranks on one GPU).

Every draw is keyed by a global id (the general tier's by (pixel, sample,
bounce), a lane grid's by its lane in the whole block), so a shard traces
what one rank would for its pixels and samples, and a split of pixels alone
(sp = 1) gives one rank's sums bit for bit: each rank's rows are written
into a zero-filled tensor of the whole, and adding zeros is exact. A split
of samples adds each pixel's partial sums in rank order rather than in
sample order, so its f64 sums differ from one rank's in the last bits.

Every rank calls the same collectives in the same order, a rank whose
range is empty too: a rank that returned early would hang the others.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.scene import SceneTables
from ..ops.camera import Camera
from ..render import finalize_image, lane_radiance, render_sums
from ..utils.timers import Timers

# the variables torchrun sets for each rank
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")


def init(device="cuda", backend: str | None = None) -> torch.device:
    """Join the process group that torchrun's variables describe (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or, with none of them set, make
    a group of one rank → this rank's device: cuda:LOCAL_RANK (made the
    current device) for "cuda", else the CPU. backend: "nccl" for CUDA and
    "gloo" for the CPU by default; "gloo" may be named for CUDA tensors (two
    ranks on one card). A group that already exists is kept as it is.
    Raises without CUDA for "cuda"; a failed init is not caught."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested, but "
                               "torch.cuda.is_available() is false")
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if any(k in os.environ for k in _LAUNCH_ENV):
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return device


@contextlib.contextmanager
def process_group(device="cuda", backend: str | None = None):
    """`init` for the body of a `with` → this rank's device; a group that
    this made is destroyed after the body."""
    made = not dist.is_initialized()
    dev = init(device, backend)
    try:
        yield dev
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def world_size() -> int:
    """Ranks of the process group, or of the one torchrun describes when
    none exists yet (1 without torchrun)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def mesh_shape(n: int, dp: int | None = None,
               sp: int | None = None) -> tuple[int, int]:
    """(dp, sp) of a mesh over n ranks, with `make_mesh`'s defaults (JAX's:
    every rank on dp) and its assert."""
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    return dp, sp


def _split(n: int, parts: int, i: int) -> tuple[int, int]:
    """Part i of [0, n) cut into `parts` contiguous ranges of sizes that
    differ by at most one (some empty when n < parts)."""
    return n * i // parts, n * (i + 1) // parts


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) layout of the process group's ranks, seen from one rank:
    its coordinates and the groups it reduces over. dp_group: the ranks
    with this rank's sp coordinate; sp_group: those with its dp
    coordinate."""
    dp: int
    sp: int
    rank: int
    dp_group: object
    sp_group: object

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def coords(self) -> tuple[int, int]:
        return self.rank // self.sp, self.rank % self.sp

    def rows(self, n: int) -> tuple[int, int]:
        """This rank's range [lo, hi) of n pixels."""
        return _split(n, self.dp, self.coords[0])

    def samples(self, spp: int) -> tuple[int, int]:
        """This rank's range [lo, hi) of spp samples."""
        return _split(spp, self.sp, self.coords[1])


# One rank and no process group: the functions below that take a mesh run
# on one rank with no collective when given none.
LOCAL = Mesh(1, 1, 0, dp_group=None, sp_group=None)

# The process group whose subgroups `_layouts` holds, and for each (dp, sp)
# its lists of sp and dp groups. Each subgroup gets a communicator of its
# own on first use, so a layout's groups are made once per process group.
_world = None
_layouts: dict[tuple[int, int], tuple[list, list]] = {}


def make_mesh(dp: int | None = None, sp: int | None = None) -> Mesh:
    """Lay the process group's ranks out as a (dp, sp) mesh (defaults as
    JAX's: every rank on dp) with its groups, made on the first call for
    the layout and reused after; every rank calls this, in the same order
    as its other meshes. Needs `init` first."""
    global _world
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init")
    dp, sp = mesh_shape(dist.get_world_size(), dp, sp)
    rank = dist.get_rank()
    if _world is not dist.group.WORLD:
        _world = dist.group.WORLD
        _layouts.clear()
    if (dp, sp) not in _layouts:
        # new_group is collective: every rank makes every group, in one
        # order
        _layouts[dp, sp] = (
            [dist.new_group([i * sp + j for j in range(sp)])
             for i in range(dp)],
            [dist.new_group([i * sp + j for i in range(dp)])
             for j in range(sp)])
    sp_groups, dp_groups = _layouts[dp, sp]
    return Mesh(dp, sp, rank, dp_group=dp_groups[rank % sp],
                sp_group=sp_groups[rank // sp])


def _sum_shards(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum t in place over the sp group (the samples' partial sums), then
    over the dp group (a gather: each rank's rows are zero on the others,
    so it is exact) → t, equal on every rank; t itself on `LOCAL`."""
    if mesh is not LOCAL:
        dist.all_reduce(t, group=mesh.sp_group)
        dist.all_reduce(t, group=mesh.dp_group)
    return t


def render_sums_sharded(scene: SceneTables, cam: Camera, nx: int, ny: int,
                        spp: int, mesh: Mesh, *, device="cuda",
                        seed: int = 0, max_depth: int = 50,
                        rr_depth: int | None = None,
                        timers: Timers | None = None,
                        progress=None) -> torch.Tensor:
    """The general tier's sums f64[3, nx·ny] of the whole image on every
    rank: each rank runs `render.render_sums` on its rows of flat pixel ids
    and its range of samples, then `_sum_shards`.

    JAX's sharded path compacts each shard to a width the host picks, reuses
    chunk 0's widths and redoes a block whose survivors overflow them
    (`_head_sharded` … `_render_block_sharded_compact`). Here each rank's
    `trace_compact` gathers its live lanes with `torch.nonzero`, an exact
    count, so none of that has a counterpart. The closest hits are the
    dense scan's, as on JAX's sharded path (its CLI refuses --sharded with
    --bvh). progress: `render_sums`' hook on this rank's ranges."""
    if timers is None:
        timers = Timers()
    sums = render_sums(scene, cam, nx, ny, spp, device=device, seed=seed,
                       max_depth=max_depth, rr_depth=rr_depth, timers=timers,
                       pixels=mesh.rows(nx * ny), samples=mesh.samples(spp),
                       use_bvh=False, progress=progress)
    with timers.phase("reduce"):
        return _sum_shards(sums, mesh)


def render_sharded(scene: SceneTables, cam: Camera, nx: int, ny: int,
                   spp: int, mesh: Mesh, *, device="cuda", seed: int = 0,
                   max_depth: int = 50, rr_depth: int | None = None,
                   timers: Timers | None = None,
                   progress=None) -> np.ndarray | None:
    """Full image through the general tier, sharded over mesh → float32
    [ny, nx, 3] on rank 0 (`render.render`'s contract), None on the other
    ranks. With sp = 1 it is `render`'s image bit for bit. progress:
    called on rank 0 alone, as progress(done, total) after each of its
    (pixel block, sample chunk)."""
    if timers is None:
        timers = Timers()
    sums = render_sums_sharded(scene, cam, nx, ny, spp, mesh, device=device,
                               seed=seed, max_depth=max_depth,
                               rr_depth=rr_depth, timers=timers,
                               progress=progress if mesh.rank == 0 else None)
    if mesh.rank != 0:
        return None
    with timers.phase("finalize"):
        return finalize_image(sums.T.cpu().numpy(), spp, nx, ny)


def _shard_lanes(pix: torch.Tensor, spp: int, mesh: Mesh):
    """This rank's part of a block's [npix, spp] lane grid → (rows (lo,
    hi), its pixels, its samples per pixel, its lanes' ids in the grid,
    pixel-major as `lane_radiance` lays them)."""
    lo, hi = mesh.rows(pix.shape[0])
    s0, s1 = mesh.samples(spp)
    lane = (torch.arange(lo, hi, dtype=torch.int64, device=pix.device)[:, None]
            * spp + torch.arange(s0, s1, dtype=torch.int64,
                                 device=pix.device)[None, :]).reshape(-1)
    return (lo, hi), pix[lo:hi], s1 - s0, lane


def _shard_draws(u: torch.Tensor | None, lane: torch.Tensor, n: int):
    """The columns of lanes `lane` of a whole grid's draws u (n lanes, in a
    layout `integrator.trace` takes: [n_bounce, n, m] read first, as
    `_check_draws` reads a shape that is both, else [n_bounce, 4, n])."""
    if u is None:
        return None
    return u[:, lane] if u.shape[1] == n else u[:, :, lane]


def _block_partial(scene, cam, pix, seed, nx, ny, spp, max_depth, mesh,
                   differentiable, u):
    """This rank's partial sums f32[rows, 3] of a block's lane grid (its
    pixels, its samples) through `lane_radiance`, and its rows."""
    rows, pix_r, ns, lane = _shard_lanes(pix, spp, mesh)
    if lane.numel() == 0:
        return torch.zeros((rows[1] - rows[0], 3), dtype=torch.float32,
                           device=pix.device), rows
    return lane_radiance(scene, cam, pix_r, seed, nx, ny, ns, max_depth,
                         differentiable=differentiable,
                         u=_shard_draws(u, lane, pix.shape[0] * spp),
                         lane=lane), rows


def _whole_block(part: torch.Tensor, rows, npix: int, mesh: Mesh):
    """The block's sums f32[npix, 3] on every rank from each rank's
    partial rows."""
    sums = torch.zeros((npix, 3), dtype=part.dtype, device=part.device)
    sums[rows[0]:rows[1]] = part
    return _sum_shards(sums, mesh)


def render_block_sharded(scene: SceneTables, cam: Camera, pix: torch.Tensor,
                         seed: int, nx: int, ny: int, spp: int,
                         max_depth: int, mesh: Mesh | None = None,
                         u: torch.Tensor | None = None) -> torch.Tensor:
    """`render.lane_radiance` of a pixel block's [npix, spp] lane grid,
    sharded: pixels over dp, samples over sp, each lane keyed by its id in
    the whole grid → the block's sums f32[npix, 3] on every rank. pix: the
    whole block, the same on every rank; mesh: None for one rank with no
    process group (`LOCAL`); u: the whole grid's draws, or None
    (`lane_radiance`)."""
    mesh = mesh or LOCAL
    part, rows = _block_partial(scene, cam, pix, seed, nx, ny, spp,
                                max_depth, mesh, False, u)
    return _whole_block(part, rows, pix.shape[0], mesh)


def train_step_sharded(scene: SceneTables, cam: Camera, pix: torch.Tensor,
                       seed: int, target: torch.Tensor, *, nx: int, ny: int,
                       spp: int, max_depth: int, mesh: Mesh | None = None,
                       wrt=("tex_color",), u: torch.Tensor | None = None):
    """`render.train_step` over the mesh → (loss, {table: gradient}), the
    same on every rank: the L2 loss of the whole block's image against
    target f32[npix, 3], and each table's gradient summed over the ranks.
    pix, target and u are the whole block's, the same on every rank; mesh:
    None for one rank with no process group (`LOCAL`).

    No collective is differentiated: each rank traces its lanes with their
    graph, the detached partial sums are summed over the mesh into the
    block's sums S, the loss's gradient dL/dS is taken on S as a leaf, and
    each rank carries its rows of dL/dS back through its own graph. The
    table gradients are then summed over the ranks. With one rank every
    operation is `train_step`'s, so its results are `train_step`'s bit for
    bit."""
    mesh = mesh or LOCAL
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in wrt}
    s = dataclasses.replace(scene, **leaves)
    with torch.enable_grad():
        part, rows = _block_partial(s, cam, pix, seed, nx, ny, spp,
                                    max_depth, mesh, True, u)
        sums = _whole_block(part.detach(), rows, pix.shape[0],
                            mesh).requires_grad_(True)
        loss = torch.mean((sums / spp - target) ** 2)
        (d_sums,) = torch.autograd.grad(loss, [sums])
        grads = [None] * len(leaves)
        if part.requires_grad:
            grads = torch.autograd.grad(part, list(leaves.values()),
                                        d_sums[rows[0]:rows[1]],
                                        allow_unused=True)
    out = {k: torch.zeros_like(v) if g is None else g
           for (k, v), g in zip(leaves.items(), grads)}
    for g in out.values():
        _sum_shards(g, mesh)
    return loss.detach(), out
