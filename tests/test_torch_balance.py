"""K1f's host side and D3's plain version (the port) against the JAX
package, on the CPU.

The kernels themselves run only on a CUDA card (tests/test_torch_kernel.py
and chip_smoke.py hold them against their plain versions there). Here:
`pick_block`, `balanced_pix_table` and the cost order equal the JAX
package's `pick_block`, `balanced_pix_table` and `_cost_permutation` on the
same cost image; `trace_plain` on a balanced table gives the scanline
layout's sums bit for bit and fills K1f's counters (segments, member
tests, warp steps) under the kernel's thread mapping; `render_kernel`
picks the balance by JAX's rule and its image does not depend on it; a
failed launch moves no launch count; D3's plain chain equals a numpy f32
chain; `kernel_stats` runs on the plain version.
"""

import types

import numpy as np
import pytest
import torch

import jax
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu_torch import kernel_stats
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import peak, tracer
from raytracing_rust_tpu_torch.utils.timers import Timers
import torch_threads  # noqa: F401  (one torch thread a process)


def _ops(name, nx, ny, rr_depth=None):
    p = tb.PRESETS[name]
    cam = tcam.make_camera(p.look_from, p.look_at, p.view_up, p.vfov,
                           nx / ny, p.aperture, p.focus_dist, p.time0,
                           p.time1)
    return tracer.trace_operands(tracer.build_scene_record(p.build()),
                                 tracer.build_camera_record(cam), "cpu",
                                 rr_depth)


def _sums(nx, ny):
    return torch.zeros((3, nx * ny), dtype=torch.float64)


def _table(n_pix, kpix, seed=0):
    order = np.random.default_rng(seed).permutation(n_pix).astype(np.int32)
    return torch.from_numpy(tracer.balanced_pix_table(order, n_pix, kpix)[0])


def test_layout_constants_are_jax_defaults(monkeypatch):
    """The port's SUB, LANES, TILE and KPIX are the JAX kernel's defaults."""
    assert (tracer.SUB, tracer.LANES, tracer.TILE) == (pt.SUB, pt.LANES,
                                                      pt.TILE)
    assert tracer.KPIX == pt.KPIX == 4 and tracer.BUCKETS == 32
    assert (tracer.PROBE_SPP, tracer.SMOOTH) == (4, 9)


@pytest.mark.parametrize("nx,ny", [(1280, 720), (800, 800), (400, 400),
                                   (64, 36), (100, 90), (1, 1)])
def test_pick_block_matches_jax(nx, ny):
    assert tracer.pick_block(nx, ny) == pt.pick_block(nx, ny)


@pytest.mark.parametrize("n_pix", [3 * 8192, 4 * 8192, 20000, 2304])
@pytest.mark.parametrize("kpix", [1, 2, 4])
def test_balanced_pix_table_matches_jax(n_pix, kpix):
    """n_pix that fill whole tiles and that do not, kpix 1, 2 and 4."""
    order = np.random.default_rng(n_pix + kpix).permutation(n_pix) \
        .astype(np.int32)
    got = tracer.balanced_pix_table(order, n_pix, kpix)
    want = pt.balanced_pix_table(order, n_pix, kpix)
    assert got[1] == want[1]
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    flat = got[0]
    assert np.array_equal(np.sort(flat[flat < n_pix]), np.arange(n_pix))


@pytest.mark.parametrize("nx,ny", [(100, 90), (300, 200), (64, 36)])
def test_cost_order_matches_jax_cost_permutation(monkeypatch, nx, ny):
    """The JAX `_cost_permutation` with its probe launch replaced by a
    seeded busy image in its 2-D block layout, against the port's
    `cost_order` on the same image."""
    for var in ("RT_PROBE_SPP", "RT_SMOOTH", "RT_BUCKETS", "RT_BAL_MODE"):
        monkeypatch.delenv(var, raising=False)
    block = pt.pick_block(nx, ny)
    bxw, byh = block
    gx, gy = -(-nx // bxw), -(-ny // byh)
    full = np.random.default_rng(nx * ny).integers(
        1, 60, (gy * byh, gx * bxw)).astype(np.float32)
    lanes = full.reshape(gy, byh, gx, bxw).transpose(0, 2, 1, 3)

    def probe(*args, **kwargs):
        out = np.zeros((7, gx * gy * pt.SUB, pt.LANES), np.float32)
        out[6] = lanes.reshape(gx * gy * pt.SUB, pt.LANES)
        return out

    monkeypatch.setattr(pt, "_trace_call", probe)
    scene = types.SimpleNamespace(background=0, perlin_seed=0)
    want = pt._cost_permutation(
        [None] * 9, jax.devices("cpu")[0], np.zeros(21, np.float32), 50, (),
        (), 0, 0, (0, 0), (0, 0), (), (False,) * 11, scene, nx, ny, block,
        None, (), ())
    got = tracer.cost_order(full[:ny, :nx], nx, ny, tracer.pick_block(nx, ny))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,spp", [("random_spheres", 2),
                                      ("final_scene", 2)])
def test_balanced_plain_is_bit_equal_and_counts(name, spp):
    """trace_plain on a balanced table (kpix 4 from a seeded order) gives
    the scanline layout's sums bit for bit, and the same per-pixel
    counters; the segments row sums to the run's segments and walk
    bounces, the member tests are at least an exact cull's."""
    nx, ny = 64, 36
    ops = _ops(name, nx, ny)
    kw = dict(nx=nx, ny=ny, seed=3, sample0=0, n_samples=spp, max_depth=50)
    counts = {}
    s0 = tracer.new_stats(nx, ny, "cpu")
    a = tracer.trace_plain(ops, _sums(nx, ny), counts=counts, stats=s0, **kw)
    pix = _table(nx * ny, 4)
    s1 = tracer.new_stats(nx, ny, "cpu", pix, 4)
    b = tracer.trace_plain(ops, _sums(nx, ny), pix=pix, kpix=4, stats=s1,
                           **kw)
    assert torch.equal(a, b) and float(a.sum()) > 0
    r0, r1 = tracer.stats_rows(s0, nx * ny), tracer.stats_rows(s1, nx * ny)
    for x, y in zip(r0[:3], r1[:3]):
        assert torch.equal(x, y)
    assert int(r0[0].sum()) == counts["segments"] + counts["walk"]
    assert int(r0[0].min()) >= spp
    assert int(r0[2].sum()) >= counts["box"]
    if name == "final_scene":
        assert counts["walk"] > 0 and int(r0[2].sum()) > 0
    assert int(r0[1].sum()) > 0
    # a warp's steps: at least its busiest thread's segments, at most 32
    # threads' worth
    for busy, steps in ((r0[0], r0[3]), (r1[0], r1[3])):
        assert int(busy.sum()) <= tracer.WARP * int(steps.sum())
    assert int(r0[3].sum()) >= int(r0[0].view(-1, tracer.WARP).amax(1).sum())


def test_warp_steps_follow_the_thread_mapping():
    """At one sample a warp's steps are the largest segment total among its
    threads: thread i holds pixel i on the scanline layout, and slots
    (g·kpix + b)·TILE + j of the table, its banks' segments summed, on a
    balanced one."""
    nx, ny, kpix = 48, 32, 2
    ops = _ops("random_spheres", nx, ny)
    kw = dict(nx=nx, ny=ny, seed=5, sample0=0, n_samples=1, max_depth=50)
    s0 = tracer.new_stats(nx, ny, "cpu")
    tracer.trace_plain(ops, _sums(nx, ny), stats=s0, **kw)
    busy, _, _, steps = tracer.stats_rows(s0, nx * ny)
    assert steps.numel() == nx * ny // tracer.WARP
    assert torch.equal(steps, busy.view(-1, tracer.WARP).amax(1))
    pix = _table(nx * ny, kpix, seed=2)
    s1 = tracer.new_stats(nx, ny, "cpu", pix, kpix)
    tracer.trace_plain(ops, _sums(nx, ny), pix=pix, kpix=kpix, stats=s1, **kw)
    assert s1.numel() - 3 * nx * ny == tracer.TILE // tracer.WARP
    slot = torch.cat([busy, torch.zeros(1, dtype=torch.int64)])[
        pix.long().clamp(max=nx * ny)].view(kpix, tracer.TILE)
    want = slot.sum(0).view(-1, tracer.WARP).amax(1)
    assert torch.equal(tracer.stats_rows(s1, nx * ny)[3], want)


def _thread_totals(per_sample, n_pix, pix=None, kpix=1):
    """Each thread's segments summed over its banks and samples, from the
    per-(sample, pixel) segment counts, under the kernel's thread mapping:
    thread i on pixel i, or thread j of tile g on slots (g·kpix + b)·TILE
    + j; shape [n_samples, threads] per sample, summed by the caller."""
    n_samples = per_sample.shape[0]
    if pix is None:
        threads = -(-n_pix // tracer.THREADS) * tracer.THREADS
        out = torch.zeros((n_samples, threads), dtype=torch.int64)
        out[:, :n_pix] = per_sample
        return out
    ext = torch.cat([per_sample, torch.zeros((n_samples, 1),
                                             dtype=torch.int64)], dim=1)
    idx = pix.long().clone()
    idx[(idx < 0) | (idx >= n_pix)] = n_pix
    grid = pix.numel() // (kpix * tracer.TILE)
    return ext[:, idx].view(n_samples, grid, kpix, tracer.TILE).sum(2) \
        .reshape(n_samples, -1)


# test_warp_steps_sum_banks_and_samples' render: final_scene, 3 samples
_WARP_CASE = dict(nx=64, ny=36, n_samples=3, seed=4)


@pytest.fixture(scope="module")
def per_sample_segments():
    """Each sample's own per-pixel segments (the stats row 0) of
    _WARP_CASE, one scanline launch a sample: row 0 is a pixel's count
    on every layout (test_balanced_plain_is_bit_equal_and_counts), so both
    layouts' cases read these."""
    nx, ny, n = (_WARP_CASE[k] for k in ("nx", "ny", "n_samples"))
    ops = _ops("final_scene", nx, ny)
    per = []
    for s in range(n):
        one = tracer.new_stats(nx, ny, "cpu")
        tracer.trace_plain(ops, _sums(nx, ny), sample0=s, n_samples=1,
                           stats=one, nx=nx, ny=ny, seed=_WARP_CASE["seed"],
                           max_depth=50)
        per.append(tracer.stats_rows(one, nx * ny)[0].clone())
    return ops, torch.stack(per)


@pytest.mark.parametrize("kpix", [None, 4])
def test_warp_steps_sum_banks_and_samples(kpix, per_sample_segments):
    """At 3 samples a warp's steps are the largest among its threads of a
    thread's segments summed over its banks and samples (the kernel's flat
    loop), recounted here from each sample's own per-pixel segments: on the
    scanline layout and on a kpix-4 table. That is at most the per-sample
    reconvergence's Σ over samples of the warp's largest, and below it
    somewhere."""
    nx, ny, n_samples = (_WARP_CASE[k] for k in ("nx", "ny", "n_samples"))
    n_pix = nx * ny
    ops, per = per_sample_segments
    pix = None if kpix is None else _table(n_pix, kpix, seed=6)
    kp = 1 if kpix is None else kpix
    kw = dict(nx=nx, ny=ny, seed=_WARP_CASE["seed"], max_depth=50, pix=pix,
              kpix=kp)
    st = tracer.new_stats(nx, ny, "cpu", pix, kp)
    tracer.trace_plain(ops, _sums(nx, ny), sample0=0, n_samples=n_samples,
                       stats=st, **kw)
    busy, _, _, steps = tracer.stats_rows(st, n_pix)
    assert torch.equal(busy, per.sum(0))
    totals = _thread_totals(per, n_pix, pix, kp)
    want = totals.sum(0).view(-1, tracer.WARP).amax(1)
    assert torch.equal(steps, want)
    per_sample_max = totals.view(n_samples, -1, tracer.WARP).amax(2).sum(0)
    assert bool((steps <= per_sample_max).all())
    assert int(steps.sum()) < int(per_sample_max.sum())


def test_slots_outside_the_image_pad():
    """A slot outside [0, nx·ny) renders nothing, as the padding slot
    nx·ny does (the kernel skips it the same way)."""
    nx, ny = 16, 8
    ops = _ops("cornell_box", nx, ny)
    kw = dict(nx=nx, ny=ny, seed=2, sample0=0, n_samples=1, max_depth=8)
    pix = _table(nx * ny, 1)
    odd = pix.clone()
    pad = torch.nonzero(odd == nx * ny).squeeze(1)
    odd[pad[0::2]] = -1
    odd[pad[1::2]] = nx * ny + 7
    out = []
    for table in (pix, odd):
        st = tracer.new_stats(nx, ny, "cpu", table)
        out.append((tracer.trace_plain(ops, _sums(nx, ny), pix=table,
                                       stats=st, **kw), st))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_render_kernel_balance_rule_and_image():
    """balance=None turns the probe on for a scene with a dynamic table at
    spp ≥ 8 (JAX's rule), once per scene, camera and size; the image is
    the same byte for byte at balance None, True and False."""
    nx, ny = 24, 16
    p = tb.PRESETS["random_spheres"]
    cam = tcam.make_camera(p.look_from, p.look_at, p.view_up, p.vfov,
                           nx / ny, p.aperture, p.focus_dist, p.time0,
                           p.time1)
    scene = p.build()
    tracer._PERM_CACHE.clear()
    imgs, probed = {}, {}
    for balance in (None, True, False):
        timers = Timers()
        imgs[balance] = tracer.render_kernel(
            scene, cam, nx, ny, 8, device="cpu", max_depth=12,
            timers=timers, balance=balance)
        probed[balance] = "balance_probe" in timers.summary()
    assert probed == {None: True, True: False, False: False}
    assert len(tracer._PERM_CACHE) == 1
    pix = next(iter(tracer._PERM_CACHE.values()))
    assert pix.dtype == torch.int32 and pix.numel() % tracer.TILE == 0
    assert imgs[None].tobytes() == imgs[True].tobytes() \
        == imgs[False].tobytes()
    for name, spp in (("random_spheres", 4), ("cornell_box", 8)):
        q = tb.PRESETS[name]
        timers = Timers()
        tracer.render_kernel(q.build(), q.camera(), 8, 8, spp, device="cpu",
                             max_depth=4, timers=timers)
        assert "balance_probe" not in timers.summary()


def test_cost_permutation_probes_with_stats():
    """The probe's order is a permutation of the pixels that puts busy
    pixels after idle ones in bucket order."""
    nx, ny = 32, 24
    ops = _ops("random_spheres", nx, ny)
    order = tracer.cost_permutation(ops, nx, ny, 12, "cpu")
    assert order.dtype == np.int32
    assert np.array_equal(np.sort(order), np.arange(nx * ny))


def test_k1f_failed_launch_counts_nothing():
    """`_launch` raises on a launch error before K1F_LAUNCHES moves; a
    table or stats launch counts as K1F, never as K1a."""
    class Lib:
        def __init__(self, err):
            self.err = err

        def rt_trace_k1(self, *args):
            return self.err

    nx, ny = 2, 2
    ops = _ops("cornell_box", nx, ny)
    sums = _sums(nx, ny)
    stats = tracer.new_stats(nx, ny, "cpu")
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=1, max_depth=1,
              stream=None)
    names = ("K1F_LAUNCHES", "K1F_TABLE_LAUNCHES", "K1F_STATS_LAUNCHES",
             "KERNEL_LAUNCHES")

    def moved():
        return [getattr(tracer, n) - b for n, b in zip(names, before)]

    before = [getattr(tracer, n) for n in names]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tracer._launch(Lib(700), ops, sums, stats=stats, **kw)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tracer._launch(Lib(700), ops, sums, pix=_table(nx * ny, 1), **kw)
    assert moved() == [0, 0, 0, 0]
    tracer._launch(Lib(0), ops, sums, stats=stats, **kw)
    assert moved() == [1, 0, 1, 0]
    tracer._launch(Lib(0), ops, sums, pix=_table(nx * ny, 1), **kw)
    assert moved() == [2, 1, 1, 0]
    tracer._launch(Lib(0), ops, sums, **kw)
    assert moved() == [2, 1, 1, 1]


def test_trace_rejects_bad_k1f_operands():
    nx, ny = 8, 8
    ops = _ops("cornell_box", nx, ny)
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=1, max_depth=2)
    pix = _table(nx * ny, 2)
    for bad in (dict(kpix=2), dict(pix=pix.long(), kpix=2),
                dict(pix=pix[:-1], kpix=2), dict(pix=pix, kpix=4),
                dict(stats=tracer.new_stats(nx, ny, "cpu")[:-1]),
                dict(pix=pix, kpix=2,
                     stats=tracer.new_stats(nx, ny, "cpu"))):
        with pytest.raises(ValueError):
            tracer.trace(ops, _sums(nx, ny), **kw, **bad)


@pytest.mark.parametrize("fma", [False, True])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_d3_plain_chain_matches_numpy(fma, k):
    """D3's plain chain equals a numpy f32 chain: f32 adds of ±c, or the
    fused a·m ± c rounded once (exact in f64 for these operands)."""
    iters = 50
    got = peak.fp32_chain(k, iters, fma, 2, 64, "cpu")
    assert got.shape == (k, 128) and got.dtype == torch.float32
    a = np.float32(1.0) + np.float32(1e-3) * np.arange(k, dtype=np.float32)
    for _ in range(iters):
        for u in range(peak.UNROLL):
            if fma:
                c = peak.FMA_C if u % 2 == 0 else -peak.FMA_C
                a = (a.astype(np.float64) * peak.FMA_M + c).astype(np.float32)
            else:
                a = a + np.float32(peak.ADD_C if u % 2 == 0 else -peak.ADD_C)
    assert np.array_equal(got.numpy(), np.repeat(a[:, None], 128, axis=1))
    if fma:
        assert not np.array_equal(a, 1 + 1e-3 * np.arange(k, dtype=np.float32))
    with pytest.raises(ValueError):
        peak.fp32_chain(3, iters, fma, 2, 64, "cpu")


def test_kernel_stats_runs_on_the_plain_version(capsys):
    """kernel_stats' summary of a stats run on the CPU: occupancy in (0, 1],
    a tail share beside it, member tests on the dynamic table."""
    out = kernel_stats.run("random_spheres", nx=32, ny=32, spp=2,
                           max_depth=12, device="cpu")
    assert 0.0 < out["occupancy"] <= 1.0
    assert out["tail_share"] == pytest.approx(1.0 - out["occupancy"])
    assert out["steps_per_sample"] >= out["segments_per_sample"] > 1.0
    assert out["sphere_tests_per_segment"] > 0 and out["box_tests"] == 0
    bal = kernel_stats.run("random_spheres", nx=32, ny=32, spp=2,
                           max_depth=12, balance=True, device="cpu")
    assert bal["segments"] == out["segments"]
    assert kernel_stats.main(["cornell_box", "--nx", "16", "--ny", "16",
                              "--spp", "1", "--max-depth", "4", "--device",
                              "cpu"]) == 0
    assert "occupancy" in capsys.readouterr().out


def test_stats_add_up_across_chunks():
    """Counters add up across launches as the sums do: two chunks of one
    sample give the per-pixel rows of one launch of two. A launch adds its
    own warp steps (a warp's largest thread total in that launch), so the
    chunked buffer holds the Σ over launches of each warp's largest, the
    whole launch the largest of its threads' Σ."""
    nx, ny = 32, 16
    ops = _ops("final_scene", nx, ny)
    kw = dict(nx=nx, ny=ny, seed=1, max_depth=20)
    whole = tracer.new_stats(nx, ny, "cpu")
    a = tracer.trace_plain(ops, _sums(nx, ny), sample0=0, n_samples=2,
                           stats=whole, **kw)
    parts, b = tracer.new_stats(nx, ny, "cpu"), _sums(nx, ny)
    per = []
    for s0 in (0, 1):
        one = tracer.new_stats(nx, ny, "cpu")
        tracer.trace_plain(ops, b, sample0=s0, n_samples=1, stats=one, **kw)
        parts += one
        per.append(tracer.stats_rows(one, nx * ny)[0])
    assert torch.equal(a, b)
    rw, rp = (tracer.stats_rows(x, nx * ny) for x in (whole, parts))
    for x, y in zip(rw[:3], rp[:3]):
        assert torch.equal(x, y)
    per = torch.stack(per).view(2, -1, tracer.WARP)
    assert torch.equal(rw[3], per.sum(0).amax(1))
    assert torch.equal(rp[3], per.amax(2).sum(0))
