"""K1f's pixel table for the card (`render_table`, `block_tile_table`), on
the CPU.

A balanced render runs one pixel a thread, a block of THREADS threads on
one compact tile of BLOCK_W × BLOCK_H pixels, the tiles dealt in
descending probe cost (ties in tile order). Here: the table is a
permutation of the pixels padded with nx·ny to whole TILEs; each block's
slots are one tile, row by row, clipped at the image's edge; the tiles'
costs fall with block rank; the order equals a numpy reference of the same
rule; `trace_plain` on the render's table gives the scanline sums and
per-pixel counters bit for bit (so the image stays the one the
scanline-vs-JAX tests hold); the table is made on the probe's device with
no host copy. The kernel on the same table: tests/test_torch_kernel.py and
chip_smoke.py phase 34, on the card.
"""

import numpy as np
import pytest
import torch

from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import tracer
import torch_threads  # noqa: F401  (one torch thread a process)

SIZES = [(40, 20), (64, 36), (16, 8), (33, 9), (1, 1)]


def _ops(name, nx, ny):
    p = tb.PRESETS[name]
    cam = tcam.make_camera(p.look_from, p.look_at, p.view_up, p.vfov,
                           nx / ny, p.aperture, p.focus_dist, p.time0,
                           p.time1)
    return tracer.trace_operands(tracer.build_scene_record(p.build()),
                                 tracer.build_camera_record(cam), "cpu")


def _busy(nx, ny, seed, high=4):
    """A seeded per-pixel cost row with many ties (values 0 .. high − 1)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, nx * ny).astype(np.int64))


def _tile_cost(busy, nx, ny):
    """Each tile's Σ of busy, tiles in raster order, by loops over pixels."""
    gx, gy = -(-nx // tracer.BLOCK_W), -(-ny // tracer.BLOCK_H)
    cost = np.zeros(gx * gy, np.int64)
    b = busy.numpy().reshape(ny, nx)
    for y in range(ny):
        for x in range(nx):
            cost[(y // tracer.BLOCK_H) * gx + x // tracer.BLOCK_W] += b[y, x]
    return cost, gx


@pytest.mark.parametrize("nx,ny", SIZES)
def test_table_is_a_padded_permutation(nx, ny):
    """Every pixel once, nx·ny in every other slot, whole TILEs of int32."""
    n_pix = nx * ny
    table = tracer.block_tile_table(_busy(nx, ny, 1), nx, ny)
    assert table.dtype == torch.int32 and table.dim() == 1
    assert table.numel() % tracer.TILE == 0 and table.numel() >= n_pix
    held = table[table < n_pix]
    assert torch.equal(held.sort().values, torch.arange(n_pix,
                                                        dtype=torch.int32))
    assert bool((table[table >= n_pix] == n_pix).all())


@pytest.mark.parametrize("nx,ny", SIZES)
def test_each_block_is_one_clipped_tile(nx, ny):
    """Block b's THREADS slots, its pads left out, are one BLOCK_W ×
    BLOCK_H tile clipped at the image's edge: thread t on the tile's column
    t % BLOCK_W and row t // BLOCK_W (a warp on two rows), a pad exactly
    where that pixel lies outside the image; the blocks after the tiles
    are all pads."""
    n_pix = nx * ny
    gx, gy = -(-nx // tracer.BLOCK_W), -(-ny // tracer.BLOCK_H)
    blocks = tracer.block_tile_table(_busy(nx, ny, 2), nx, ny) \
        .view(-1, tracer.THREADS).long()
    t = torch.arange(tracer.THREADS)
    seen = set()
    for b in range(gx * gy):
        row = blocks[b]
        first = int(row[row < n_pix].min())
        y0, x0 = divmod(first, nx)
        assert x0 % tracer.BLOCK_W == 0 and y0 % tracer.BLOCK_H == 0
        seen.add((y0, x0))
        x, y = x0 + t % tracer.BLOCK_W, y0 + t // tracer.BLOCK_W
        inside = (x < nx) & (y < ny)
        assert torch.equal(row, torch.where(inside, y * nx + x, n_pix))
    assert len(seen) == gx * gy
    assert bool((blocks[gx * gy:] == n_pix).all())


@pytest.mark.parametrize("nx,ny", SIZES)
def test_tiles_fall_in_cost_ties_in_tile_order(nx, ny):
    """The tiles' costs (Σ busy) do not increase with block rank, and
    tiles of equal cost come in tile order (raster order of the tile
    grid)."""
    n_pix = nx * ny
    busy = _busy(nx, ny, 3, high=3)
    cost, gx = _tile_cost(busy, nx, ny)
    blocks = tracer.block_tile_table(busy, nx, ny).view(-1, tracer.THREADS)
    tiles = []
    for row in blocks[:cost.size]:
        y, x = divmod(int(row[row < n_pix].min()), nx)
        tiles.append((y // tracer.BLOCK_H) * gx + x // tracer.BLOCK_W)
    ranked = [(-int(cost[i]), i) for i in tiles]
    assert ranked == sorted(ranked)


@pytest.mark.parametrize("nx,ny,seed", [(40, 20, 4), (64, 36, 5),
                                        (200, 90, 6)])
def test_order_equals_numpy_reference(nx, ny, seed):
    """The table equals a numpy build of the same rule: tile costs from a
    loop over pixels, a stable argsort of the negated costs, each tile's
    pixels row by row, nx·ny outside the image and after the tiles."""
    n_pix = nx * ny
    busy = _busy(nx, ny, seed, high=40)
    cost, gx = _tile_cost(busy, nx, ny)
    want = []
    for i in np.argsort(-cost, kind="stable"):
        ty, tx = divmod(int(i), gx)
        for r in range(tracer.BLOCK_H):
            for c in range(tracer.BLOCK_W):
                y, x = ty * tracer.BLOCK_H + r, tx * tracer.BLOCK_W + c
                want.append(y * nx + x if x < nx and y < ny else n_pix)
    want += [n_pix] * (-len(want) % tracer.TILE)
    got = tracer.block_tile_table(busy, nx, ny)
    assert np.array_equal(got.numpy(), np.asarray(want, np.int32))


@pytest.mark.parametrize("name", ["random_spheres", "final_scene"])
def test_plain_on_render_table_equals_scanline(name):
    """`trace_plain` on the render's own table (its probe included) gives
    the scanline sums bit for bit, the same three per-pixel counter rows,
    and each warp's steps the largest of its 32 slots' segments."""
    nx, ny = 64, 36
    n_pix = nx * ny
    ops = _ops(name, nx, ny)
    pix = tracer.render_table(ops, nx, ny, 50, "cpu")
    kw = dict(nx=nx, ny=ny, seed=3, sample0=0, n_samples=2, max_depth=50)
    s0 = tracer.new_stats(nx, ny, "cpu")
    a = tracer.trace_plain(ops, torch.zeros((3, n_pix), dtype=torch.float64),
                           stats=s0, **kw)
    s1 = tracer.new_stats(nx, ny, "cpu", pix)
    b = tracer.trace_plain(ops, torch.zeros((3, n_pix), dtype=torch.float64),
                           pix=pix, stats=s1, **kw)
    assert torch.equal(a, b) and float(a.sum()) > 0
    r0, r1 = tracer.stats_rows(s0, n_pix), tracer.stats_rows(s1, n_pix)
    for x, y in zip(r0[:3], r1[:3]):
        assert torch.equal(x, y)
    slot = torch.cat([r0[0], torch.zeros(1, dtype=torch.int64)])[pix.long()]
    assert torch.equal(r1[3], slot.view(-1, tracer.WARP).amax(1))


def test_render_table_stays_on_the_probe_device(monkeypatch):
    """The order is built from the probe's row where it lies: the table
    comes back on the busy row's device, on a meta tensor too (no data to
    copy out), and after its probe `render_table` runs with JAX's host
    order and every copy off the device refused."""
    nx, ny = 40, 20
    meta = tracer.block_tile_table(torch.empty(nx * ny, dtype=torch.int64,
                                               device="meta"), nx, ny)
    assert meta.device.type == "meta" and meta.dtype == torch.int32
    assert meta.numel() == tracer.TILE
    ops = _ops("random_spheres", nx, ny)
    want = tracer.render_table(ops, nx, ny, 12, "cpu")
    busy = tracer.cost_probe(ops, nx, ny, 12, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the table left the probe's device")
    monkeypatch.setattr(tracer, "cost_probe", lambda *args: busy)
    for name in ("cost_order", "balanced_pix_table", "cost_permutation"):
        monkeypatch.setattr(tracer, name, refuse)
    for name in ("cpu", "numpy", "tolist", "item"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = tracer.render_table(ops, nx, ny, 12, "cpu")
    monkeypatch.undo()
    assert got.device.type == "cpu"
    assert torch.equal(got, want)
