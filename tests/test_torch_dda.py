"""K1f's DDA row (`dda=True` of the stats launch) in the plain version, on
the CPU, on final_scene's 400 merged boxes at 32×16×1.

The JAX package's row cannot be computed here (the megakernel's PRNG has no
CPU lowering, tests/test_pallas_tripwire.py), and the port's row is per
thread, not per tile (csrc/tracer.cu, the box member loop): for each box
member test a ray runs, it counts whether the ray crosses the member's
AABB inside (T_MIN, its best hit before the test), final_scene's ground
boxes in the strip pass's form. Here: the row equals a
sequential numpy recount of that predicate, member by member against the
running best, on every box pass of every segment; it never exceeds the box
tests; it adds up across chunks; the other counters and the probe do not
change; `kernel_stats` reports the skip share. The kernel's row is held to
this one on the card (tests/test_torch_kernel.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from raytracing_rust_tpu_torch import kernel_stats
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import tracer
import torch_threads  # noqa: F401  (one torch thread a process)

NX, NY = 32, 16
KW = dict(nx=NX, ny=NY, seed=2, max_depth=50)


def _ops(name, nx=NX, ny=NY):
    p = tb.PRESETS[name]
    cam = tcam.make_camera(p.look_from, p.look_at, p.view_up, p.vfov,
                           nx / ny, p.aperture, p.focus_dist, p.time0,
                           p.time1)
    return tracer.trace_operands(tracer.build_scene_record(p.build()),
                                 tracer.build_camera_record(cam), "cpu")


def _sums():
    return torch.zeros((3, NX * NY), dtype=torch.float64)


def _slab(lo, hi, o, inv):
    """csrc/tracer.cu `slab` in numpy f32 → (entry, exit)."""
    tmn = tmx = None
    for a in range(3):
        t0, t1 = (lo[a] - o[a]) * inv[a], (hi[a] - o[a]) * inv[a]
        if tmn is None:
            tmn, tmx = np.minimum(t0, t1), np.maximum(t0, t1)
        else:
            tmn = np.maximum(tmn, np.minimum(t0, t1))
            tmx = np.minimum(tmx, np.maximum(t0, t1))
    return tmn, tmx


def _strip(r, o, inv, grid):
    """csrc/tracer.cu's strip-pass member test in numpy f32 → (entry,
    exit): the box's x slab, the grid's y_lo plane and its y_hi plane, its
    z_lo plane and the incremental z exit, folded y, x, z."""
    f32 = np.float32
    t_ylo = (f32(grid[2]) - o[1]) * inv[1]
    tx0 = (r[tracer.R_C0] - o[0]) * inv[0]
    tx1 = (r[tracer.R_DC] - o[0]) * inv[0]
    th = (r[tracer.R_DC + 1] - o[1]) * inv[1]
    tz0 = (r[tracer.R_C0 + 2] - o[2]) * inv[2]
    tz1 = tz0 + f32(grid[3]) * inv[2]
    tmn = np.maximum(np.maximum(np.minimum(t_ylo, th), np.minimum(tx0, tx1)),
                     np.minimum(tz0, tz1))
    tmx = np.minimum(np.minimum(np.maximum(t_ylo, th), np.maximum(tx0, tx1)),
                     np.maximum(tz0, tz1))
    return tmn, tmx


def _recount(leaves, box, o, inv_d, t_d, grid=()):
    """The DDA count of one box pass, per ray, as the kernel's loop runs it:
    leaf by leaf, a leaf tested against the running best hit, then its
    members one by one, each counted when its slab (a grid's: the strip
    pass's member test) is crossed inside (T_MIN, the best hit before it),
    then the best hit updated."""
    f32 = np.float32
    o = [x.numpy() for x in o]
    inv = [x.numpy() for x in inv_d]
    t_d = t_d.numpy().copy()
    t_min = f32(tracer.T_MIN)
    count = np.zeros(t_d.shape, np.int64)
    lv = leaves.numpy()
    rows = box.numpy()
    for L in lv:
        tmn, tmx = _slab(L[0:3], L[3:6], o, inv)
        live = (tmx > np.maximum(tmn, t_min)) & (tmn < t_d)
        for q in range(int(L[6]), int(L[6]) + int(L[7])):
            r = rows[q]
            tmn, tmx = (_strip(r, o, inv, grid) if grid else
                        _slab(r[tracer.R_C0:tracer.R_C0 + 3],
                              r[tracer.R_DC:tracer.R_DC + 3], o, inv))
            count += live & (tmx > np.maximum(tmn, t_min)) & (tmn < t_d)
            t_p = np.where(tmn > t_min, tmn, tmx)
            better = live & (tmx > tmn) & (t_p > t_min) & (t_p < t_d)
            t_d = np.where(better, t_p, t_d)
    return count


@pytest.fixture(scope="module")
def final_run():
    """final_scene at 32×16×1 with the DDA row, every box pass's per-ray
    count beside a sequential numpy recount of it."""
    ops = _ops("final_scene")
    passes = []
    closest = tracer._closest_rows

    def spy(hit_fn, table, leaves, o, inv_d, t_d, tests=None,
            crossings=None):
        out = closest(hit_fn, table, leaves, o, inv_d, t_d, tests, crossings)
        if crossings is not None:
            passes.append((crossings.clone(),
                           _recount(leaves, table, o, inv_d, t_d,
                                    ops.grid)))
        return out

    stats = tracer.new_stats(NX, NY, "cpu", dda=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracer, "_closest_rows", spy)
        sums = tracer.trace_plain(ops, _sums(), sample0=0, n_samples=1,
                                  stats=stats, dda=True, **KW)
    return ops, sums, stats, passes


def test_dda_row_matches_a_sequential_recount(final_run):
    """On every box pass, each ray's count equals the numpy recount, and the
    row's total is the recounts' total."""
    _, _, stats, passes = final_run
    assert len(passes) > 10
    for got, want in passes:
        assert np.array_equal(got.numpy(), want)
    row = tracer.dda_row(stats, NX * NY)
    assert int(row.sum()) == sum(int(w.sum()) for _, w in passes) > 0


def test_dda_crossings_never_exceed_box_tests(final_run):
    """Pixel by pixel, a crossing is a box test, and the gate would skip
    some: crossings ≤ box tests, strictly fewer overall."""
    _, _, stats, _ = final_run
    n_pix = NX * NY
    box = tracer.stats_rows(stats, n_pix, dda=True)[2]
    row = tracer.dda_row(stats, n_pix)
    assert (row >= 0).all() and (row <= box).all()
    assert int(row.sum()) < int(box.sum())


def test_dda_leaves_the_other_counters_and_sums(final_run):
    """A stats buffer without the row keeps its four views, and they and the
    sums equal the ones of the launch with it."""
    ops, sums, stats, _ = final_run
    plain = tracer.new_stats(NX, NY, "cpu")
    assert plain.numel() + NX * NY == stats.numel()
    s = tracer.trace_plain(ops, _sums(), sample0=0, n_samples=1,
                           stats=plain, **KW)
    assert torch.equal(s, sums)
    for a, b in zip(tracer.stats_rows(plain, NX * NY),
                    tracer.stats_rows(stats, NX * NY, dda=True)):
        assert torch.equal(a, b)


def test_dda_row_adds_up_across_chunks():
    """Two chunks of one sample give the per-pixel rows of one launch of
    two, the DDA row too (each launch adds its own warp steps, a warp's
    largest thread total in that launch: tests/test_torch_balance.py)."""
    ops = _ops("final_scene")
    whole = tracer.new_stats(NX, NY, "cpu", dda=True)
    a = tracer.trace_plain(ops, _sums(), sample0=0, n_samples=2, stats=whole,
                           dda=True, **KW)
    parts, b = tracer.new_stats(NX, NY, "cpu", dda=True), _sums()
    n_pix, busy = NX * NY, []
    for s0 in (0, 1):
        one = tracer.new_stats(NX, NY, "cpu", dda=True)
        tracer.trace_plain(ops, b, sample0=s0, n_samples=1, stats=one,
                           dda=True, **KW)
        parts += one
        busy.append(tracer.stats_rows(one, n_pix, dda=True)[0])
    assert torch.equal(a, b)
    rw, rp = (tracer.stats_rows(x, n_pix, dda=True) for x in (whole, parts))
    for x, y in zip((*rw[:3], tracer.dda_row(whole, n_pix)),
                    (*rp[:3], tracer.dda_row(parts, n_pix))):
        assert torch.equal(x, y)
    busy = torch.stack(busy).view(2, -1, tracer.WARP)
    assert torch.equal(rw[3], busy.sum(0).amax(1))
    assert torch.equal(rp[3], busy.amax(2).sum(0))
    assert tracer.dda_row(whole, n_pix).sum() > 0


def test_cost_probe_never_asks_for_the_row(monkeypatch):
    """`cost_permutation`'s probe is a launch without the DDA row, as in JAX
    (pallas_tracer.py:1289-1293): one `trace_probe` call (a launch that
    counts the segments alone) and no `trace` call with the row; its
    segments are the row 0 of a stats launch without the row, and the
    order is `cost_order` of that row."""
    calls = {"trace": [], "trace_probe": []}
    for name in calls:
        def spy(*args, _real=getattr(tracer, name), _name=name, **kw):
            calls[_name].append(kw)
            return _real(*args, **kw)
        monkeypatch.setattr(tracer, name, spy)
    ops = _ops("final_scene", 16, 8)
    order = tracer.cost_permutation(ops, 16, 8, 6, "cpu")
    monkeypatch.undo()
    assert len(calls["trace_probe"]) == 1
    assert not any(kw.get("dda", False) for kw in calls["trace"])
    stats = tracer.new_stats(16, 8, "cpu")
    tracer.trace(ops, torch.zeros((3, 16 * 8), dtype=torch.float64), nx=16,
                 ny=8, seed=tracer.PROBE_SEED, sample0=0,
                 n_samples=tracer.PROBE_SPP, max_depth=6, stats=stats)
    row = tracer.stats_rows(stats, 16 * 8)[0]
    assert torch.equal(tracer.cost_probe(ops, 16, 8, 6, "cpu"), row)
    assert np.array_equal(order, tracer.cost_order(
        row.numpy().reshape(8, 16), 16, 8, tracer.pick_block(16, 8)))


def test_kernel_stats_reports_the_skip_share(capsys):
    """`kernel_stats` asks for the row on a scene with boxes and reports the
    crossings per segment and the skip share in [0, 1]; a scene without
    boxes has neither."""
    out = kernel_stats.run("final_scene", nx=NX, ny=NY, spp=1, max_depth=50,
                           device="cpu")
    assert 0.0 <= out["dda_skip_share"] <= 1.0
    assert out["dda_crossings"] <= out["box_tests"]
    assert out["dda_cross_per_segment"] == pytest.approx(
        out["dda_crossings"] / out["segments"])
    assert "a per-ray gate could skip" in capsys.readouterr().out
    bal = kernel_stats.run("final_scene", nx=NX, ny=NY, spp=1, max_depth=50,
                           balance=True, device="cpu")
    assert bal["dda_crossings"] == out["dda_crossings"]
    none = kernel_stats.run("random_spheres", nx=16, ny=16, spp=1,
                            max_depth=8, device="cpu")
    assert "dda_skip_share" not in none


def test_trace_rejects_bad_dda_operands():
    ops = _ops("final_scene", 8, 8)
    kw = dict(nx=8, ny=8, seed=0, sample0=0, n_samples=1, max_depth=2)
    sums = torch.zeros((3, 64), dtype=torch.float64)
    for bad in (dict(dda=True),
                dict(dda=True, stats=tracer.new_stats(8, 8, "cpu")),
                dict(stats=tracer.new_stats(8, 8, "cpu", dda=True))):
        with pytest.raises(ValueError):
            tracer.trace(ops, sums, **kw, **bad)


def test_dda_launch_counts_after_success():
    """`_launch` passes the row's flag and counts K1F_DDA only after the
    launch succeeds."""
    class Lib:
        def __init__(self, err):
            self.err, self.args = err, None

        def rt_trace_k1(self, *args):
            self.args = args
            return self.err

    ops = _ops("final_scene", 2, 2)
    sums = torch.zeros((3, 4), dtype=torch.float64)
    stats = tracer.new_stats(2, 2, "cpu", dda=True)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=1, max_depth=1,
              stream=None, stats=stats)
    before = (tracer.K1F_DDA_LAUNCHES, tracer.K1F_STATS_LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tracer._launch(Lib(700), ops, sums, dda=True, **kw)
    assert (tracer.K1F_DDA_LAUNCHES, tracer.K1F_STATS_LAUNCHES) == before
    lib = Lib(0)
    tracer._launch(lib, ops, sums, dda=True, **kw)
    assert lib.args[-3] == 1   # dda, (the instantiation's slot), stream
    tracer._launch(lib, ops, sums, **dict(kw, stats=tracer.new_stats(
        2, 2, "cpu")))
    assert lib.args[-3] == 0
    assert (tracer.K1F_DDA_LAUNCHES, tracer.K1F_STATS_LAUNCHES) == (
        before[0] + 1, before[1] + 2)
