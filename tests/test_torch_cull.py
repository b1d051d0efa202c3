"""K1's two-level cull on the CPU: the super rows `trace_operands` hands the
kernel, against the JAX package's.

The kernel itself runs only on a CUDA card (tests/test_torch_kernel.py and
chip_smoke.py hold the two-level cull there bit for bit against the
one-level cull, the unculled scan and `trace_plain`). Here: the super rows
equal `pallas_tracer.build_scene_record`'s, bit for bit, and a table of at
most SUP_FANOUT leaves carries none; each super's AABB is the f32 min/max of
its leaves' and their ranges tile the leaves once, in order; on seeded
rays, through the port's own slab test, a crossed leaf implies a crossed
super and a crossed super a crossed root, which is what lets the kernel
skip a super's leaves without changing a winner; `trace_plain` does not
read the super rows; the cull's test count behind K1's bound; the
render's launch plan; the wrapper refuses bad super rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
from raytracing_rust_tpu_torch.ops import tracer
import torch_threads  # noqa: F401  (one torch thread a process)


def _crowd(n):
    """n static spheres of one radius under the sky, every one dynamic
    (none is four times the median radius, so none unrolls)."""
    def make(cls):
        r = np.random.default_rng(n)
        b = cls(background=BG_SKY)
        mats = [b.lambertian(b.solid(0.8, 0.3, 0.3)),
                b.metal(b.solid(0.7, 0.7, 0.7), 0.1)]
        for i in range(n):
            b.sphere(tuple(r.uniform((-8.0, 0.1, -8.0), (8.0, 4.0, 8.0))),
                     0.1, mats[i % 2])
        return b.build()
    return make


# scene → (port scene, JAX scene) builders
_SCENES = {
    "random_spheres": (tb.PRESETS["random_spheres"].build,
                       jb.PRESETS["random_spheres"].build),
    "final_scene": (tb.final_scene, jb.final_scene),
    "crowd_2000": (lambda: _crowd(2000)(SceneBuilder),
                   lambda: _crowd(2000)(JSceneBuilder)),
    "crowd_120": (lambda: _crowd(120)(SceneBuilder),
                  lambda: _crowd(120)(JSceneBuilder)),
}
# (dynamic sphere leaves, supers), (box leaves, supers) as `_cluster_rows`
# splits them (final_scene's boxes: the strip grid's z segments,
# `_grid_cluster_rows`)
_COUNTS = {"random_spheres": ((32, 4), (0, 0)),
           "final_scene": ((64, 8), (60, 8)),
           "crowd_2000": ((128, 16), (0, 0)),
           "crowd_120": ((8, 0), (0, 0))}


def _ops(name):
    return tracer.trace_operands(
        tracer.build_scene_record(_SCENES[name][0]()),
        tracer.build_camera_record(
            tb.PRESETS.get(name, tb.PRESETS["final_scene"]).camera()), "cpu")


def _tables(ops):
    """(name, super rows, leaf rows) of each table a scene has."""
    return [(name, s, lv) for name, s, lv in (
        ("spheres", ops.sups, ops.leaves),
        ("boxes", ops.bsups, ops.bleaves)) if lv.shape[0]]


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_super_rows_equal_jax(name):
    """sups and bsups are the super rows of `pallas_tracer._cluster_rows`
    (of `_grid_cluster_rows` for final_scene's box grid) as its
    `build_scene_record` lays them out after the leaves at its defaults,
    bit for bit; leaves and bleaves are its leaf rows, as before."""
    ops = _ops(name)
    (_, _, _, _, _, _, _, sclus, (n_leaf, n_sup), bclus,
     (n_bleaf, n_bsup, *_)) = pt.build_scene_record(_SCENES[name][1]())[:11]
    assert ((n_leaf, n_sup), (n_bleaf, n_bsup)) == _COUNTS[name]
    for got, want in ((ops.leaves, sclus[:n_leaf]),
                      (ops.sups, sclus[n_leaf:n_leaf + n_sup]),
                      (ops.bleaves, bclus[:n_bleaf]),
                      (ops.bsups, bclus[n_bleaf:n_bleaf + n_bsup])):
        assert got.dtype == torch.float32 and got.shape[1] == tracer.CLUSW
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)
                                      .reshape(-1, tracer.CLUSW))


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_super_rows_hold_and_tile_their_leaves(name):
    """Each super's AABB is exactly the f32 min (lo) and max (hi) of its
    leaves' AABBs, and so contains each of them; the supers' leaf ranges
    are contiguous, ascending, non-empty and tile [0, n_leaf) once."""
    for table, sups, leaves in _tables(_ops(name)):
        s, lv = sups.numpy(), leaves.numpy()
        if not len(s):
            assert len(lv) <= tracer.SUP_FANOUT, table
            continue
        first, cnt = s[:, 6].astype(int), s[:, 7].astype(int)
        assert (s[:, 6:8] == np.stack([first, cnt], 1)).all()
        assert first[0] == 0 and (cnt >= 1).all()
        np.testing.assert_array_equal(first[1:], np.cumsum(cnt)[:-1])
        assert cnt.sum() == len(lv)
        for row, f, c in zip(s, first, cnt):
            mine = lv[f:f + c]
            np.testing.assert_array_equal(row[:3], mine[:, :3].min(0))
            np.testing.assert_array_equal(row[3:6], mine[:, 3:6].max(0))
            assert (row[:3] <= mine[:, :3]).all()
            assert (row[3:6] >= mine[:, 3:6]).all()


def _rays(leaves, n, seed):
    """n seeded f32 rays around a leaf table: origins scattered over its
    bounds (and beyond), at leaf centres (inside a leaf and its super) and
    on a leaf's corner; directions with exact zero components (one, two,
    and signed zeros) beside generic ones; t_d at inf, just above T_MIN
    and in between."""
    r = np.random.default_rng(seed)
    lv = leaves.numpy()
    lo, hi = lv[:, :3].min(0), lv[:, 3:6].max(0)
    span = hi - lo
    o = r.uniform(lo - 0.5 * span, hi + 0.5 * span, (n, 3))
    k = r.integers(0, len(lv), n)
    inside = r.random(n) < 0.3
    o[inside] = 0.5 * (lv[k[inside], :3] + lv[k[inside], 3:6])
    corner = r.random(n) < 0.05
    o[corner] = lv[k[corner], :3]
    d = r.normal(size=(n, 3))
    zero1 = r.random(n) < 0.25
    d[zero1, r.integers(0, 3, int(zero1.sum()))] = 0.0
    zero2 = r.random(n) < 0.1
    axis = r.integers(0, 3, int(zero2.sum()))
    d[zero2] = 0.0
    d[np.nonzero(zero2)[0], axis] = r.choice([-1.0, 1.0], len(axis))
    neg = r.random(n) < 0.05
    d[neg & zero1] *= -1.0    # −0.0 components
    t_min_up = np.nextafter(np.float32(tracer.T_MIN), np.float32(np.inf))
    t_d = np.where(r.random(n) < 0.3, np.inf,
                   np.where(r.random(n) < 0.2, t_min_up,
                            r.uniform(tracer.T_MIN, 3.0 * span.max(), n)))
    o, d, t_d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d, t_d))
    return list(o.unbind(1)), [tracer._safe_inv(c) for c in d.unbind(1)], t_d


@pytest.mark.parametrize("name", ["random_spheres", "final_scene",
                                  "crowd_2000"])
def test_crossed_leaf_implies_crossed_super_and_root(name):
    """On seeded rays through the port's `_safe_inv`/`_slab`/`_crossed`: a
    leaf crossed before t_d lies in a super crossed before t_d, which lies
    in the table's root (the f32 fold of its supers) crossed before t_d;
    the guards also skip: some rays cross a leaf, some supers are not
    crossed."""
    for table, sups, leaves in _tables(_ops(name)):
        o, inv_d, t_d = _rays(leaves, 4096, len(leaves))
        s = sups.numpy()
        root = torch.from_numpy(np.concatenate(
            [s[:, :3].min(0), s[:, 3:6].max(0), [0, 0]])[None].astype(
                np.float32))
        leaf_x = tracer._crossed(leaves, o, inv_d, t_d)
        sup_x = tracer._crossed(sups, o, inv_d, t_d)
        root_x = tracer._crossed(root, o, inv_d, t_d)[:, 0]
        for j, (f, c) in enumerate(s[:, 6:8].astype(int)):
            hit = leaf_x[:, f:f + c].any(dim=1)
            assert not bool((hit & ~sup_x[:, j]).any()), (table, j)
        assert not bool((sup_x.any(dim=1) & ~root_x).any()), table
        assert bool(leaf_x.any()) and bool((~sup_x).any()), table


@pytest.mark.parametrize("name", ["random_spheres", "final_scene"])
def test_plain_does_not_read_super_rows(name):
    """`trace` on the CPU (the plain version) gives the same sums bit for
    bit with the super rows and with them emptied."""
    ops = _ops(name)
    kw = dict(nx=12, ny=8, seed=3, sample0=0, n_samples=1, max_depth=50)
    out = [tracer.trace(o, torch.zeros((3, 96), dtype=torch.float64), **kw)
           for o in (ops, dataclasses.replace(ops, sups=ops.sups[:0],
                                              bsups=ops.bsups[:0]))]
    assert float(out[0].sum()) > 0
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("name", ["random_spheres", "final_scene"])
def test_cull_tests_count_the_two_level_cull(name):
    """`_cull_tests`, the slab tests k1_work's bound counts for the cull,
    is, ray by ray, one root test, then on a ray that crosses the root
    every super and the leaves of each super it crosses, all against the
    ray's final hit; with the super rows emptied, the root and every
    leaf. `k1_work` counts those tests in place of a test of every leaf a
    segment, which `one_level` keeps."""
    ops = _ops(name)
    for table, sups, leaves in _tables(ops):
        o, inv_d, t_d = _rays(leaves, 96, 7)
        s = sups.numpy()
        root = torch.cat([leaves[:, :3].amin(0), leaves[:, 3:6].amax(0),
                          torch.zeros(2)])[None]
        want = want_one = 0
        for i in range(t_d.numel()):
            ray = ([x[i:i + 1] for x in o], [x[i:i + 1] for x in inv_d],
                   t_d[i:i + 1])
            want += 1
            want_one += 1
            if bool(tracer._crossed(root, *ray)[0, 0]):
                want_one += len(leaves)
                want += len(s)
                for j, (f, c) in enumerate(s[:, 6:8].astype(int)):
                    if bool(tracer._crossed(sups[j:j + 1], *ray)[0, 0]):
                        want += c
        got = tracer._cull_tests(leaves, sups, o, inv_d, t_d)
        assert got == want, table
        assert tracer._cull_tests(leaves, sups[:0], o, inv_d, t_d) \
            == want_one, table
        assert t_d.numel() < want < t_d.numel() * (1 + len(s) + len(leaves))
    counts = dict(segments=10, noise=0, image=0, box=0, walk=0, emis_tex=0,
                  rect_uv=0, med_tex=0, rr=0, cull=70, box_cull=90)
    two = tracer.k1_work(ops, counts, 4, 1)[0]
    one = tracer.k1_work(ops, counts, 4, 1, one_level=True)[0]
    assert one - two == (
        10 * (len(ops.leaves) * tracer.K1_OPS["leaf"]
              + len(ops.bleaves) * tracer.K1_OPS["box_leaf"])
        - 70 * tracer.K1_OPS["leaf"] - 90 * tracer.K1_OPS["box_leaf"])


@pytest.mark.parametrize("nx,ny,spp,device,want", [
    (1280, 720, 100, "cuda", (4, [(0, 72), (72, 28)])),
    (800, 800, 100, "cuda", (4, [(0, 100)])),
    (128, 128, 100, "cuda", (2, [(0, 100)])),
    (64, 64, 300, "cpu", (1, [(0, 256), (256, 44)]))])
def test_launch_plan(nx, ny, spp, device, want):
    """`launch_plan`, the plan `render_kernel`, kernel_ab and kernel_stats
    share: kpix as large as KPIX allows with at least one tile of pixels
    a bank, and calls of as many samples as the device's lane budget
    holds (2^26 lanes on a card, 2^20 on the CPU)."""
    assert tracer.launch_plan(nx * ny, spp, device) == want


def test_wrapper_rejects_bad_super_rows():
    """The operand checks refuse super rows of the wrong dtype, width or
    device (at `trace`, before the device is chosen, so the CPU path takes
    them too), and leaf ranges that run past the leaves, overlap or come
    out of order (when the operands are made, so a launch reads no rows
    on the host); super rows beside an empty leaf table are not read."""
    ops = _ops("final_scene")
    sums = torch.zeros((3, 4), dtype=torch.float64)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=1, max_depth=1)
    with pytest.raises(TypeError):
        tracer.trace(dataclasses.replace(ops, sups=ops.sups.double()), sums,
                     **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(
            ops, bsups=ops.bsups[:, :6].contiguous()), sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(ops, sups=ops.sups.to("meta")),
                     sums, **kw)
    past, overlap, swapped = (ops.bsups.clone() for _ in range(3))
    past[-1, 7] += 1.0
    overlap[1, 6] -= 1.0
    swapped[[0, 1]] = swapped[[1, 0]]
    for bad in (past, overlap, swapped):
        with pytest.raises(ValueError):
            tracer.trace(dataclasses.replace(ops, bsups=bad), sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(ops, sups=ops.sups[:-1]), sums,
                     **kw)
    tracer.trace(dataclasses.replace(ops, leaves=ops.leaves[:0]), sums, **kw)
