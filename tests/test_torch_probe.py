"""K1f's cost probe launch (`trace_probe`, `cost_probe`), on the CPU.

The render's probe counts each pixel's segments alone, on compact 16×8
tiles in raster order, with each pixel's samples split over blocks until
the launch fills the card (csrc/tracer.cu, the STATS == 2 instantiations). A
pixel's paths are keyed by (pixel, sample, bounce), so its segments are the
same in any layout and on any number of threads. Here, through the plain
version: the probe's row equals row 0 of the stats launch on the scanline
layout (the probe before it), so `render_table` and `cost_permutation` are
the ones made from that row; every split gives the same row; each part's
warp steps equal those of a stats launch of its samples on the same
compact tiles; the split fills PROBE_WAVES waves; the wrapper refuses bad
rows and passes its arguments to the kernel in place. The kernel itself is
held to this plain version on the card (tests/test_torch_kernel.py,
chip_smoke.py phases 34 and 40).
"""

import numpy as np
import pytest
import torch

from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import tracer
import torch_threads  # noqa: F401  (one torch thread a process)


def _ops(name, nx, ny):
    p = tb.PRESETS[name]
    cam = tcam.make_camera(p.look_from, p.look_at, p.view_up, p.vfov,
                           nx / ny, p.aperture, p.focus_dist, p.time0,
                           p.time1)
    return tracer.trace_operands(tracer.build_scene_record(p.build()),
                                 tracer.build_camera_record(cam), "cpu")


def _stats_row(ops, nx, ny, depth, sample0=0, n=tracer.PROBE_SPP, pix=None):
    """The stats launch's buffer and its row 0 at the probe's seed."""
    st = tracer.new_stats(nx, ny, "cpu", pix)
    tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64), nx=nx,
                 ny=ny, seed=tracer.PROBE_SEED, sample0=sample0, n_samples=n,
                 max_depth=depth, pix=pix, stats=st)
    return st, tracer.stats_rows(st, nx * ny)[0]


@pytest.mark.parametrize("name,nx,ny,depth", [
    ("random_spheres", 48, 32, 50), ("final_scene", 16, 8, 12)])
def test_probe_row_and_table_equal_the_scanline_stats(name, nx, ny, depth):
    """The probe's row is the scanline stats launch's row 0 bit for bit, so
    the render's table and JAX's order are the ones made from that row."""
    ops = _ops(name, nx, ny)
    _, row = _stats_row(ops, nx, ny, depth)
    busy = tracer.cost_probe(ops, nx, ny, depth, "cpu")
    assert busy.dtype == torch.int64 and torch.equal(busy, row)
    assert int(row.sum()) > 0
    table = tracer.render_table(ops, nx, ny, depth, "cpu")
    assert torch.equal(table, tracer.block_tile_table(row, nx, ny))
    assert np.array_equal(
        tracer.cost_permutation(ops, nx, ny, depth, "cpu"),
        tracer.cost_order(row.numpy().reshape(ny, nx), nx, ny,
                          tracer.pick_block(nx, ny)))


def test_split_counters_equal_one_pixel_a_thread():
    """Every split gives the same row; part j's warp steps are those of a
    stats launch of its samples on the compact tiles in raster order (the
    card's table of a zero cost: the same threads on the same pixels), so
    the plain version's layout is the kernel's."""
    nx, ny, depth = 40, 20, 50
    n_pix = nx * ny
    ops = _ops("random_spheres", nx, ny)
    _, row = _stats_row(ops, nx, ny, depth)
    raster = tracer.block_tile_table(torch.zeros(n_pix, dtype=torch.int64),
                                     nx, ny)
    kw = dict(nx=nx, ny=ny, seed=tracer.PROBE_SEED, sample0=0,
              n_samples=tracer.PROBE_SPP, max_depth=depth)
    for split in (1, 2, 4):
        busy = torch.zeros(n_pix, dtype=torch.int64)
        steps = torch.zeros(tracer.probe_warps(nx, ny, split),
                            dtype=torch.int64)
        tracer.trace_probe(ops, busy, split=split, steps=steps, **kw)
        assert torch.equal(busy, row), split
        per = tracer.PROBE_SPP // split
        parts = steps.view(split, -1)
        for j in range(split):
            st, _ = _stats_row(ops, nx, ny, depth, j * per, per, raster)
            want = tracer.stats_rows(st, n_pix)[3]
            # the table pads to whole TILEs; the probe has no such warps
            assert torch.equal(parts[j], want[:parts.shape[1]]), (split, j)
            assert int(want[parts.shape[1]:].sum()) == 0


def test_probe_split_fills_its_waves():
    """The least power of two that gives PROBE_WAVES waves of the resident
    blocks, dividing the samples, at most a sample a thread: on 132 SMs
    that hold 7 blocks of the probe's instantiations, final_scene (5,000
    tiles at 800×800, 128 at 128×128) takes 4 parts, random_spheres (7,200
    tiles) 2."""
    res = 132 * 7
    waves = tracer.PROBE_WAVES * res
    assert tracer.probe_tiles(128, 128) == 128
    assert tracer.probe_tiles(800, 800) == 5000
    assert tracer.probe_tiles(1280, 720) == 7200
    assert tracer.probe_tiles(40, 20) == 9
    assert tracer.probe_split(128, res) == 4
    assert tracer.probe_split(5000, res) == 4
    assert tracer.probe_split(7200, res) == 2
    assert tracer.probe_split(waves, res) == 1
    assert tracer.probe_split(waves - 1, res) == 2
    assert tracer.probe_split(10, res, n_samples=6) == 2
    assert tracer.probe_split(10, res, n_samples=1) == 1
    assert tracer.probe_warps(40, 20, 4) == 4 * 9 * 4


def test_trace_probe_rejects_bad_rows():
    nx, ny = 8, 8
    ops = _ops("random_spheres", nx, ny)
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=4, max_depth=2)
    good = torch.zeros(nx * ny, dtype=torch.int64)
    for busy, extra in (
            (good.int(), {}), (good[:-1], {}),
            (torch.zeros((2, nx * ny), dtype=torch.int64)[:, 0], {}),
            (good, dict(split=3)), (good, dict(split=0)),
            (good, dict(split=2, steps=torch.zeros(
                tracer.probe_warps(nx, ny, 1), dtype=torch.int64))),
            (good, dict(steps=torch.zeros(tracer.probe_warps(nx, ny),
                                          dtype=torch.int32)))):
        with pytest.raises(ValueError):
            tracer.trace_probe(ops, busy, **kw, **extra)
    with pytest.raises(ValueError):
        tracer.trace_probe(ops, good.to("meta"), **kw)


def test_probe_launch_passes_its_arguments():
    """`_launch` hands the probe's split, its steps row and its busy row
    (in the stats slot) to the kernel, no sums, and only after the launch
    succeeds counts one K1F, K1F_STATS and K1F_PROBE launch, no table and
    no K1a."""
    class Lib:
        def __init__(self, err):
            self.err, self.args = err, None

        def rt_trace_k1(self, *args):
            self.args = args
            return self.err

    ops = _ops("cornell_box", 2, 2)
    busy = torch.zeros(4, dtype=torch.int64)
    steps = torch.zeros(tracer.probe_warps(2, 2, 2), dtype=torch.int64)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=2, max_depth=1,
              stream=None, stats=busy, probe_split=2, probe_steps=steps)
    names = ("K1F_LAUNCHES", "K1F_STATS_LAUNCHES", "K1F_PROBE_LAUNCHES",
             "K1F_TABLE_LAUNCHES", "KERNEL_LAUNCHES")
    before = [getattr(tracer, n) for n in names]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tracer._launch(Lib(700), ops, None, **kw)
    assert [getattr(tracer, n) for n in names] == before
    lib = Lib(0)
    tracer._launch(lib, ops, None, **kw)
    assert lib.args[12] is None   # no sums
    # probe_split, probe_steps, stats, dda, (the instantiation's slot), stream
    assert lib.args[-6:-2] == (2, steps.data_ptr(), busy.data_ptr(), 0)
    assert lib.args[-1] is None
    assert [getattr(tracer, n) - b for n, b in zip(names, before)] == [
        1, 1, 1, 0, 0]


@pytest.mark.parametrize("rr", [None, 6])
def test_probe_work_counts_the_paths_alone(rr):
    """The probe's bound (`k1_work(probe=True)`) counts what its row needs:
    the paths' segments, samples, culls, media and walk bounces, without
    the noise, image, textured-light, rect-UV and textured-medium lanes or
    the atlas, and the busy row written once in place of the sums read and
    written; under roulette a path follows its colours, so they stay."""
    p = tb.PRESETS["final_scene"]
    cam = tcam.make_camera(p.look_from, p.look_at, p.view_up, p.vfov, 2.0,
                           p.aperture, p.focus_dist, p.time0, p.time1)
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(cam), "cpu", rr)
    assert ops.atlas.numel() > 0
    counts = dict(segments=1000, noise=70, image=50, box=300, cull=400,
                  box_cull=200, walk=90, emis_tex=3, rect_uv=5, med_tex=7,
                  rr=40 if rr else 0)
    n_pix, spp = 32, 4
    ops_all, bytes_all = tracer.k1_work(ops, counts, n_pix, spp)
    ops_probe, bytes_probe = tracer.k1_work(ops, counts, n_pix, spp,
                                            probe=True)
    colour = sum(counts[k] * tracer.K1_OPS[k] for k in (
        "noise", "image", "emis_tex", "rect_uv", "med_tex"))
    atlas = ops.atlas.numel() * ops.atlas.element_size()
    if rr:
        assert ops_probe == ops_all
        assert bytes_probe == bytes_all - 40 * n_pix
    else:
        assert ops_probe == ops_all - colour
        assert bytes_probe == bytes_all - 40 * n_pix - atlas
    one, _ = tracer.k1_work(ops, counts, n_pix, spp, one_level=True,
                            probe=True)
    assert one - ops_probe == tracer.k1_work(
        ops, counts, n_pix, spp, one_level=True)[0] - ops_all
