"""The strip pass over a regular box grid on the CPU: the port's host layout
and its plain member test, against the JAX package's.

final_scene's 400 ground boxes are a 20×20 grid, which JAX's
`build_scene_record` lays out by default in strips (`_grid_cluster_rows`)
for its kernel's strip pass (pallas_tracer.py:1947-2024). The kernel runs
only on a CUDA card (tests/test_torch_kernel.py and chip_smoke.py hold it
there bit for bit against `trace_plain`). Here: `_grid_cluster_rows`
equals JAX's on final_scene and refuses every near-grid that JAX's refuses;
the strip form's entry, exit and hit t against the generic slab test on
seeded rays, some starting inside a box; the winner of the culled scan in
strip form against a sequential scan; the member-test and DDA counts
against a per-lane loop; final_scene rendered in strip form against the
generic layout; the operands' grid spec, its checks and its launch count;
a box table that is no grid keeps JAX's generic layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import SceneBuilder
from raytracing_rust_tpu_torch.ops import tracer
import torch_threads  # noqa: F401  (one torch thread a process)

R_C0, R_DC = tracer.R_C0, tracer.R_DC
EPS = 2.0 ** -24


def _box_rows():
    """final_scene's merged box rows in `_merge_boxes`' order."""
    full = tracer.build_scene_record
    scene = tb.final_scene()
    old = tracer.UNROLL_BUDGET
    tracer.UNROLL_BUDGET = 1 << 30   # every prim unrolled: the whole record
    try:
        srec = full(scene)
    finally:
        tracer.UNROLL_BUDGET = old
    return tracer._merge_boxes(srec.rec, srec.kinds)[0]


@pytest.fixture(scope="module")
def box_rows():
    return _box_rows()


@pytest.fixture(scope="module")
def final_ops():
    return tracer.trace_operands(
        tracer.build_scene_record(tb.final_scene()),
        tracer.build_camera_record(tb.PRESETS["final_scene"].camera()), "cpu")


def test_grid_rows_equal_jax(box_rows):
    """final_scene's 400 boxes: the strip-major rows, the z-segment leaves
    and their supers, bit for bit JAX's; (60, 8, 20, 20)."""
    got = tracer._grid_cluster_rows(box_rows)
    want = pt._grid_cluster_rows(box_rows)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == tuple(want[2:]) == (60, 8, 20, 20)


def _nudge(rows, case):
    """A copy of the grid's rows with one defect."""
    r = rows.copy()
    w = float(r[1, R_C0 + 2] - r[0, R_C0 + 2]) or 100.0
    if case == "15 boxes":
        return r[:15]
    if case == "y_lo raised":
        r[37, R_C0 + 1] += np.float32(1.0)
    elif case == "shifted 2e-4 w":
        r[41, [R_C0, R_DC]] += np.float32(2e-4 * w)
    elif case == "duplicate cell":
        r[3, [R_C0, R_C0 + 2, R_DC, R_DC + 2]] = r[4, [R_C0, R_C0 + 2, R_DC,
                                                        R_DC + 2]]
    elif case == "z width one ulp":
        # a far plane, so that its ulp is not lost in the width
        q = int(np.argmax(np.abs(r[:, R_DC + 2])))
        r[q, R_DC + 2] = np.nextafter(r[q, R_DC + 2], np.float32(np.inf))
    elif case == "strip x plane one ulp":
        q = int(np.argmax(np.abs(r[:, R_DC])))
        r[q, R_DC] = np.nextafter(r[q, R_DC], np.float32(np.inf))
    return r


@pytest.mark.parametrize("case", [
    "15 boxes", "y_lo raised", "shifted 2e-4 w", "duplicate cell",
    "z width one ulp", "strip x plane one ulp"])
def test_grid_refuses_where_jax_refuses(box_rows, case):
    """Each near-grid: None from both, where the unbroken rows are a
    grid."""
    bad = _nudge(box_rows, case)
    assert not np.array_equal(bad, box_rows)
    assert pt._grid_cluster_rows(bad) is None
    assert tracer._grid_cluster_rows(bad) is None


def _rays(ops, n=4096, seed=0):
    """n seeded rays over final_scene's ground, a quarter of them starting
    inside a box, a few with a zero x or z component."""
    rng = np.random.default_rng(seed)
    box = ops.box.numpy()
    o = rng.uniform((-1100, -20, -1100), (1100, 120, 1100),
                    (n, 3)).astype(np.float32)
    k = rng.integers(0, len(box), n // 4)
    lo, hi = box[k, R_C0:R_C0 + 3], box[k, R_DC:R_DC + 3]
    o[:n // 4] = lo + rng.uniform(0.0, 1.0, (n // 4, 3)) * (hi - lo)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::17, 0] = 0.0
    d[::19, 2] = 0.0
    o = [torch.from_numpy(o[:, a].copy()) for a in range(3)]
    d = [torch.from_numpy(d[:, a].copy()) for a in range(3)]
    return o, [tracer._safe_inv(c) for c in d], n // 4


def _strip(ops, rows, o, inv, slab=False):
    """`_strip_t` of the lanes o, inv against rows, [lanes, rows]."""
    t_ylo = (ops.grid[2] - o[1]) * inv[1]
    dwz = ops.grid[3] * inv[2]
    return tracer._strip_t(
        rows[None, :, R_C0], rows[None, :, R_DC], rows[None, :, R_DC + 1],
        rows[None, :, R_C0 + 2], [x[:, None] for x in o],
        [x[:, None] for x in inv], t_ylo[:, None], dwz[:, None], slab=slab)


def _generic(rows, o, inv):
    return tracer._box_t([rows[None, :, R_C0 + a] for a in range(3)],
                         [rows[None, :, R_DC + a] for a in range(3)],
                         [x[:, None] for x in o], [x[:, None] for x in inv],
                         slab=True)


def test_strip_form_against_the_slab_test(final_ops):
    """On 4,096 rays × 400 boxes: `ok` is the slab test's, bit for bit; the
    entry t is too wherever the ray enters through another plane than the
    hi z plane (the one the strip pass reaches by tz0 + w32·inv_dz); the
    entry, exit and hit t are within the first-order rounding bound of
    the two forms, 6·2⁻²⁴·(|tz0| + |w32·inv_dz|) (each side rounds the
    plane's product, the strip side also w32·inv_dz and the add, and the
    true planes differ by w32: |tz1| ≤ |tz0| + |dwz|)."""
    ops = final_ops
    o, inv, n_in = _rays(ops)
    rows = ops.box
    ts, oks, (mn_s, mx_s) = _strip(ops, rows, o, inv, slab=True)
    tg, okg, (mn_g, mx_g) = _generic(rows, o, inv)
    assert torch.equal(oks, okg)
    tz0 = (rows[None, :, R_C0 + 2] - o[2][:, None]) * inv[2][:, None]
    tz1 = (rows[None, :, R_DC + 2] - o[2][:, None]) * inv[2][:, None]
    hi_z_entry = (tz1 < tz0) & (mn_g == tz1)
    assert torch.equal(mn_s[~hi_z_entry], mn_g[~hi_z_entry])
    bound = 6 * EPS * (tz0.abs() + (ops.grid[3] * inv[2]).abs()[:, None])
    for s, g in ((mn_s, mn_g), (mx_s, mx_g), (ts, tg)):
        assert bool(((s - g).abs() <= bound).all())
    # the inside starts take the exit face, and some hit rows differ by
    # the incremental plane's rounding
    assert bool((oks[:n_in] & (mn_s[:n_in] <= tracer.T_MIN)).any())
    print(f"hit t differing from the slab test's: "
          f"{int(((ts != tg) & okg).sum())} of {int(okg.sum())} hits")


def test_closest_rows_in_strip_form_is_a_sequential_scan(final_ops):
    """`_closest_rows` with the strip test, behind the grid's leaf cull,
    keeps the winner and t of a scan of the rows in table order that keeps
    the first strict minimum, from each lane's start t."""
    ops = final_ops
    o, inv, _ = _rays(ops, seed=1)
    t0 = torch.where(torch.arange(len(o[0])) % 3 == 0,
                     torch.tensor(400.0), torch.tensor(tracer.BIG))

    def hit(rows, ln):
        return _strip(ops, rows, [x[ln] for x in o], [x[ln] for x in inv])

    t, win = tracer._closest_rows(hit, ops.box, ops.bleaves, o, inv, t0)
    ts, oks = _strip(ops, ops.box, o, inv)
    want_t, want_w = t0.clone(), torch.full_like(win, -1)
    for q in range(ops.box.shape[0]):
        better = oks[:, q] & (ts[:, q] < want_t)
        want_t = torch.where(better, ts[:, q], want_t)
        want_w = torch.where(better, q, want_w)
    assert torch.equal(t, want_t) and torch.equal(win, want_w)
    assert int((win >= 0).sum()) > 100


def test_member_and_dda_counts_in_strip_form(final_ops):
    """The member tests and DDA crossings `_closest_rows` gathers in strip
    form (a leaf's members counted where the ray crosses the leaf before
    its best hit so far; a member crossed where its strip slab holds the
    ray inside (T_MIN, best hit before it)) against a loop of the kernel's
    one-level cull, leaf by leaf and member by member in table order, on
    each lane."""
    ops = final_ops
    o, inv, _ = _rays(ops, n=1024, seed=2)
    lanes = len(o[0])
    tests = torch.zeros(lanes, dtype=torch.int64)
    cross = torch.zeros(lanes, dtype=torch.int64)

    def hit(rows, ln):
        return _strip(ops, rows, [x[ln] for x in o], [x[ln] for x in inv],
                      slab=True)

    t0 = torch.full((lanes,), tracer.BIG)
    t, win = tracer._closest_rows(hit, ops.box, ops.bleaves, o, inv, t0,
                                  tests, cross)
    ts, oks, (mn, mx) = _strip(ops, ops.box, o, inv, slab=True)
    want_tests = torch.zeros_like(tests)
    want_cross = torch.zeros_like(cross)
    t_d = t0.clone()
    for leaf in ops.bleaves:
        guard = tracer._crossed(leaf[None], o, inv, t_d)[:, 0]
        start, cnt = int(leaf[6]), int(leaf[7])
        want_tests += guard * cnt
        for q in range(start, start + cnt):
            want_cross += guard & (mx[:, q] > torch.clamp(mn[:, q],
                                                          min=tracer.T_MIN)) \
                & (mn[:, q] < t_d)
            t_d = torch.where(guard & oks[:, q] & (ts[:, q] < t_d),
                              ts[:, q], t_d)
    assert torch.equal(t, t_d)
    assert torch.equal(tests, want_tests) and torch.equal(cross, want_cross)
    assert 0 < int(cross.sum()) < int(tests.sum())


def test_plain_final_scene_strip_against_generic_layout(monkeypatch):
    """final_scene at 64×64×2, depth 50, through `trace_plain`: the strip
    layout and its member test against the generic layout (the boxes
    clustered like the spheres, the slab test). The forms differ only by
    the hi z plane's rounding and, on a tie, by which of two boxes the
    row order keeps: few pixels differ, and the image sum agrees."""
    nx = ny = 64
    cam = tracer.build_camera_record(tb.PRESETS["final_scene"].camera())
    strip = tracer.trace_operands(
        tracer.build_scene_record(tb.final_scene()), cam, "cpu")
    monkeypatch.setattr(tracer, "_grid_cluster_rows", lambda rows: None)
    generic = tracer.trace_operands(
        tracer.build_scene_record(tb.final_scene()), cam, "cpu")
    assert strip.grid and not generic.grid
    assert tuple(strip.bleaves.shape) == (60, tracer.CLUSW)
    assert tuple(generic.bleaves.shape) == (64, tracer.CLUSW)
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=2, max_depth=50)
    stats = [tracer.new_stats(nx, ny, "cpu") for _ in range(2)]
    a, b = (tracer.trace_plain(ops, torch.zeros((3, nx * ny),
                                                dtype=torch.float64),
                               stats=st, **kw)
            for ops, st in zip((strip, generic), stats))
    differ = int((a != b).any(dim=0).sum())
    # the kernel's member tests a segment (its cull, against the running
    # best hit), sphere and box, in each layout
    mix = [[float(r.sum()) / float(seg.sum()) for r in (sph, box)]
           for seg, sph, box, _ in (tracer.stats_rows(st, nx * ny)
                                    for st in stats)]
    print(f"pixels differing: {differ} of {nx * ny}; sphere and box member "
          f"tests a segment: strip {mix[0][0]:.3f}, {mix[0][1]:.3f}; "
          f"generic {mix[1][0]:.3f}, {mix[1][1]:.3f}")
    assert differ <= nx * ny // 100
    assert abs(float(a.sum()) - float(b.sum())) <= 1e-3 * float(b.sum())


def test_operands_carry_the_grid(final_ops):
    """trace_operands: (NI, NJ, y_lo, w32) of the grid; its strip leaves
    and supers; k1_work charges a grid's box members the strip test's
    operations."""
    ops = final_ops
    assert ops.grid == (20, 20, 0.0, 100.0)
    assert tuple(ops.bleaves.shape) == (60, tracer.CLUSW)
    assert tuple(ops.bsups.shape) == (8, tracer.CLUSW)
    counts = dict(segments=10, box=7, cull=0, box_cull=0, walk=0, rr=0,
                  noise=0, image=0, emis_tex=0, rect_uv=0, med_tex=0)
    grid = tracer.k1_work(ops, counts, 1, 1)[0]
    generic = tracer.k1_work(dataclasses.replace(ops, grid=()), counts, 1,
                             1)[0]
    assert generic - grid == 7 * (tracer.K1_OPS["box"]
                                  - tracer.K1_OPS["box_strip"])


@pytest.mark.parametrize("defect", [
    "NI·NJ", "y_lo", "z width", "leaf x plane", "spec length"])
def test_bad_grid_spec_raises(final_ops, defect):
    """A grid spec that does not describe the box table is refused when
    the operands are made (or by `trace`), never run in another form."""
    ops = final_ops
    box, leaves = ops.box.clone(), ops.bleaves.clone()
    grid = ops.grid
    if defect == "NI·NJ":
        grid = (20, 19) + grid[2:]
    elif defect == "y_lo":
        box[5, R_C0 + 1] = 0.5
    elif defect == "z width":
        box[6, R_DC + 2] = float(np.nextafter(np.float32(box[6, R_DC + 2]),
                                              np.float32(np.inf)))
    elif defect == "leaf x plane":
        leaves[4, 3] = float(np.nextafter(np.float32(leaves[4, 3]),
                                          np.float32(np.inf)))
    else:
        grid = grid[:3]
    with pytest.raises(ValueError):
        bad = dataclasses.replace(ops, box=box, bleaves=leaves, grid=grid)
        tracer.trace(bad, torch.zeros((3, 4), dtype=torch.float64), nx=2,
                     ny=2, seed=0, sample0=0, n_samples=1, max_depth=1)


def test_launch_counts_and_passes_the_grid(final_ops):
    """A launch of a grid scene counts as K1E_GRID (besides K1E_BOX) and
    hands the kernel the grid flag, y_lo and w32; the same boxes without
    the spec count as boxes alone and pass a zero flag."""
    got = []

    class Lib:
        def rt_trace_k1(self, *args):
            got.append(args)
            return 0

    sums = torch.zeros((3, 4), dtype=torch.float64)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=1, max_depth=1,
              stream=None)
    before = tracer.K1E_GRID_LAUNCHES, tracer.K1E_BOX_LAUNCHES
    tracer._launch(Lib(), final_ops, sums, **kw)
    assert (tracer.K1E_GRID_LAUNCHES, tracer.K1E_BOX_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert got[-1][33:36] == (1, 0.0, 100.0)   # after the box super rows
    tracer._launch(Lib(), dataclasses.replace(final_ops, grid=()), sums,
                   **kw)
    assert (tracer.K1E_GRID_LAUNCHES, tracer.K1E_BOX_LAUNCHES) == (
        before[0] + 1, before[1] + 2)
    assert got[-1][33] == 0


@pytest.mark.parametrize("grid", ["on", "off"])
def test_non_grid_boxes_keep_the_generic_layout(grid, monkeypatch):
    """17 cubes on a 5-wide grid leave three cells empty, so they are no
    grid: the port's record equals JAX's with its strip grid on (its
    default) and off, the boxes clustered like the spheres, no spec."""
    if grid == "off":
        monkeypatch.setattr(pt, "GRID", False)
    srec = tracer.build_scene_record(tb.cubes_scene(17))
    (_, _, _, _, _, box, n_box, _, _, bclus,
     n_bclus) = pt.build_scene_record(
         tb.cubes_scene(17, JSceneBuilder))[:11]
    assert srec.n_bclus == tuple(n_bclus) and len(n_bclus) == 2
    np.testing.assert_array_equal(srec.box_rec, box[:n_box])
    np.testing.assert_array_equal(srec.bclus, bclus)
    cam = tracer.build_camera_record(tb.PRESETS["final_scene"].camera())
    assert tracer.trace_operands(srec, cam, "cpu").grid == ()


def test_cubes_are_a_grid_like_jax():
    """The 20 cubes of `builders.cubes_scene` fill a 5×4 grid of pitch 1: JAX
    lays them out in strips (5 leaves, one super), and so does the port."""
    srec = tracer.build_scene_record(tb.cubes_scene())
    want = pt.build_scene_record(tb.cubes_scene(20, JSceneBuilder))
    assert srec.n_bclus == tuple(want[10]) == (5, 1, 5, 4)
    np.testing.assert_array_equal(srec.box_rec, want[5][:want[6]])
    np.testing.assert_array_equal(srec.bclus, want[9])
