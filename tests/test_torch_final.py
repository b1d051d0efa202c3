"""The port's final_scene path (box merge, the big-scene partition, the
dense-medium walk) and its repaired faults, against the JAX package, on the
CPU.

The kernel itself runs only on a CUDA card (tests/test_torch_kernel.py and
chip_smoke.py hold it against `trace_plain` there). Here: `_merge_boxes`
and the box leaves equal the JAX package's; final_scene's whole record
equals `pallas_tracer.build_scene_record`'s at its defaults (its ground
boxes in the strip grid's layout);
`trace_plain` renders final_scene and a sealed dense-medium scene to the
JAX XLA tier's radiometry per image half; the walk gives the event path's
sums bit for bit; final_scene's sums do not depend on the sample chunking;
the PPM encoder's bytes equal the Python join's and the JAX package's; a
failed launch counts nothing; the inverse render's seed offset.

Run as a script (`PYTHONPATH=. python tests/test_torch_final.py`) it
prints the JAX XLA tier's final_scene mean image that chip_smoke.py holds
the port's card render to.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import camera as jcam
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu.render import render as jax_render
from raytracing_rust_tpu.utils import image_io as jio
from raytracing_rust_tpu_torch import inverse_render
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import BG_BLACK, SceneBuilder
from raytracing_rust_tpu_torch.render import finalize_image
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import rng, tracer
from raytracing_rust_tpu_torch.utils import image_io as tio
from test_torch_tracer import _assert_halves_agree
import torch_threads  # noqa: F401  (one torch thread a process)


def _cubes(cls, n=20):
    """`builders.cubes_scene` built by cls: n cubes of three materials on a
    5-wide grid under the sky: 6·n rects, more than the unroll budget for
    n ≥ 17, and nothing else."""
    return tb.cubes_scene(n, cls)


def _sealed(cls):
    """A glass sphere sealing a coincident medium of ρ 1 (mean free path
    1, diameter 6: walk-dense), on a gray ground under a sphere light."""
    b = cls(background=BG_BLACK)
    b.sphere((0, -1000, 0), 999.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 3, 0), 3.0, b.dielectric(1.5))
    b.medium_sphere((0, 3, 0), 3.0, 1.0, b.solid(0.8, 0.9, 0.95))
    b.sphere((0, 9, 1), 1.5, b.diffuse_light(b.solid(6, 6, 6)))
    return b.build()


_SEALED_VIEW = ((0, 4, 14), (0, 3, 0), (0, 1, 0), 35.0)


def _final_camera(nx, ny):
    p = tb.PRESETS["final_scene"]
    return (p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
            p.focus_dist, p.time0, p.time1)


@pytest.mark.parametrize("name", ["final_scene", "cubes"])
def test_merge_boxes_and_box_leaves_equal_jax(name, monkeypatch):
    """Box rows and member mask equal `pallas_tracer._merge_boxes` on the
    same record; the box leaves equal its `_cluster_rows` on the same
    rows."""
    scene = {"final_scene": tb.final_scene,
             "cubes": lambda: _cubes(SceneBuilder)}[name]()
    # the whole record, every prim unrolled, as the partition sees it
    monkeypatch.setattr(tracer, "UNROLL_BUDGET", 1 << 30)
    full = tracer.build_scene_record(scene)
    monkeypatch.undo()
    rows, member = tracer._merge_boxes(full.rec, full.kinds)
    want_rows, want_member = pt._merge_boxes(full.rec, full.kinds)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(member, want_member)
    n_box = {"final_scene": 400, "cubes": 20}[name]
    assert len(rows) == n_box and member.sum() == 6 * n_box
    lo, hi = rows[:, tracer.R_C0:tracer.R_C0 + 3], rows[:, tracer.R_DC:
                                                          tracer.R_DC + 3]
    got = tracer._cluster_rows(rows, lo, hi, tracer.BOX_LEAF)
    want = pt._cluster_rows(rows, lo, hi, pt.BOX_LEAF)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == tuple(want[2:])


@pytest.mark.parametrize("name", ["final_scene", "cubes", "sealed"])
def test_record_equals_jax_with_grid_off(name):
    """The whole record, field by field, against
    `pallas_tracer.build_scene_record` at its defaults (the strip grid on:
    final_scene's 20×20 ground boxes and the 20 cubes' 5×4 grid in strip
    layout, n_bclus (n_leaf, n_sup, NI, NJ); the name is older than the
    port's grid): rec, kinds, groups, the dynamic table and its clusters,
    the box table and its clusters, media, flags, the atlas, the interior
    rows and kinds, the dense bits."""
    build = {"final_scene": lambda cls: (tb if cls is SceneBuilder
                                         else jb).final_scene(),
             "cubes": _cubes, "sealed": _sealed}[name]
    srec = tracer.build_scene_record(build(SceneBuilder))
    (rec, kinds, groups, dyn, n_dyn, box, n_box, sclus, n_sclus, bclus,
     n_bclus, med, med_kinds, flags, img, _, _, int_rec,
     int_kinds) = pt.build_scene_record(build(JSceneBuilder))
    np.testing.assert_array_equal(srec.rec, rec)
    assert srec.kinds == kinds and srec.rect_groups == groups
    np.testing.assert_array_equal(srec.dyn_rec, dyn[:n_dyn])
    np.testing.assert_array_equal(srec.sclus, sclus)
    assert srec.n_sclus == tuple(n_sclus)
    np.testing.assert_array_equal(srec.box_rec, box[:n_box])
    np.testing.assert_array_equal(srec.bclus, bclus)
    assert srec.n_bclus == tuple(n_bclus)
    np.testing.assert_array_equal(srec.med_rec, med[:len(srec.med_kinds)])
    assert tuple(zip(srec.med_kinds, srec.med_dense)) == med_kinds
    assert srec.flags == flags
    if srec.atlas.size:
        np.testing.assert_array_equal(
            srec.atlas, img[:srec.atlas.shape[0], :srec.atlas.shape[1]])
    assert srec.int_kinds == int_kinds
    np.testing.assert_array_equal(srec.int_rec, int_rec[:len(int_kinds)])
    if name == "final_scene":
        # the light rect, the mover and five heroes unrolled; 400 boxes,
        # 1,000 dynamic spheres; the blue sphere walks, the mist does not
        assert sorted(srec.kinds) == ["moving", "rect"] + ["sphere"] * 5
        assert len(srec.box_rec) == 400 and len(srec.dyn_rec) == 1000
        assert srec.med_dense == (True, False)
        assert srec.feats & tracer.FEAT_DENSE_WALK
        assert 2 <= len(srec.int_kinds) <= tracer.MAX_INTERIOR
        assert srec.n_bclus == (60, 8, 20, 20)
    if name == "cubes":
        assert srec.kinds == () and len(srec.box_rec) == 20
        assert srec.rec.shape == (1, tracer.REC)   # the zero row
    if name == "sealed":
        assert srec.med_dense == (True,) and srec.int_kinds == ("sphere",)


def test_unsealed_or_big_interior_takes_the_event_path():
    """A dense medium with no coincident sphere, and one whose interior
    set exceeds MAX_INTERIOR rows, do not walk; a thin one never did."""
    def build(seal, crowd, density):
        b = SceneBuilder(background=BG_BLACK)
        b.sphere((0, -1000, 0), 999.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
        if seal:
            b.sphere((0, 3, 0), 3.0, b.dielectric(1.5))
        for i in range(crowd):
            b.sphere((0.2 * i - 2.5, 3, 0), 0.1, b.lambertian(
                b.solid(0.5, 0.5, 0.5)))
        b.medium_sphere((0, 3, 0), 3.0, density, b.solid(1, 1, 1))
        return tracer.build_scene_record(b.build())
    assert build(True, 0, 1.0).med_dense == (True,)
    assert build(False, 0, 1.0).med_dense == (False,)
    assert build(True, tracer.MAX_INTERIOR, 1.0).med_dense == (False,)
    assert build(True, 0, 0.5).med_dense == (False,)   # 4/ρ = 8 > 6


def _plain(scene, args, nx, ny, spp, seed, walk=True, spp_chunk=None):
    ops = tracer.trace_operands(tracer.build_scene_record(scene),
                                tracer.build_camera_record(
                                    tcam.make_camera(*args)), "cpu")
    if not walk:
        ops = dataclasses.replace(ops, feats=ops.feats
                                  & ~tracer.FEAT_DENSE_WALK)
    sums = torch.zeros((3, nx * ny), dtype=torch.float64)
    chunk = spp_chunk or spp
    for s0 in range(0, spp, chunk):
        tracer.trace(ops, sums, nx=nx, ny=ny, seed=seed, sample0=s0,
                     n_samples=min(chunk, spp - s0), max_depth=50)
    return sums


def test_final_scene_plain_matches_jax_per_half():
    """trace_plain on final_scene at 32×32, 16 spp, depth 50 against the
    JAX XLA tier, per image half within max(6σ, 0.012) in clamped linear
    space (gamma²): boxes, 1,000 dynamic spheres, noise, the earth
    texture, glass, fuzzy metal, a mover, the mist and the walked blue
    sphere."""
    nx = ny = 32
    args = _final_camera(nx, ny)
    ours = tracer.render_kernel(tb.final_scene(), tcam.make_camera(*args),
                                nx, ny, 16, device="cpu", seed=11) ** 2
    assert ours.shape == (ny, nx, 3) and np.isfinite(ours).all()
    ref = np.asarray(jax_render(jb.final_scene(), jcam.make_camera(*args),
                                nx, ny, 16, seed=11, max_depth=50)) ** 2
    _assert_halves_agree(ours, ref, 0.012)


def test_dense_walk_equals_event_path_and_matches_jax():
    """The walk draws a bounce's flights and direction from the main
    step's slots, and the interior set holds every surface a walking ray
    can reach first, so with the walk and without it the sums are equal
    bit for bit; both match the JAX XLA tier per image half within
    max(6σ, 0.012) (32×32, 32 spp, depth 50)."""
    nx = ny = 32
    args = (*_SEALED_VIEW, 1.0, 0.0, 10.0, 0.0, 1.0)
    walk = _plain(_sealed(SceneBuilder), args, nx, ny, 32, seed=4)
    event = _plain(_sealed(SceneBuilder), args, nx, ny, 32, seed=4,
                   walk=False)
    assert torch.equal(walk, event)
    ours = finalize_image(walk.T.numpy(), 32, nx, ny) ** 2
    ref = np.asarray(jax_render(_sealed(JSceneBuilder),
                                jcam.make_camera(*args), nx, ny, 32, seed=4,
                                max_depth=50)) ** 2
    assert ours.mean() > 0.01
    _assert_halves_agree(ours, ref, 0.012)


def test_walk_counts_its_bounces():
    """counts: the walk's lane bounces replace main steps one for one,
    plus one main step that re-traces each segment a walk ended on."""
    args = (*_SEALED_VIEW, 1.0, 0.0, 10.0, 0.0, 1.0)
    ops = tracer.trace_operands(
        tracer.build_scene_record(_sealed(SceneBuilder)),
        tracer.build_camera_record(tcam.make_camera(*args)), "cpu")
    event = dataclasses.replace(ops, feats=ops.feats
                                & ~tracer.FEAT_DENSE_WALK)
    cw, ce = {}, {}
    for o, c in ((ops, cw), (event, ce)):
        tracer.trace_plain(o, torch.zeros((3, 144), dtype=torch.float64),
                           nx=12, ny=12, seed=2, sample0=0, n_samples=2,
                           max_depth=50, counts=c)
    assert cw["walk"] > 0 and ce["walk"] == 0
    assert cw["segments"] < ce["segments"] <= cw["segments"] + cw["walk"]


def test_final_scene_chunking_is_bit_identical():
    """final_scene's sums at 8×8, 4 spp, in chunks of 1, 3 and 4 samples:
    equal bit for bit (noise, image, sphere media, boxes, the walk), which
    needs `rng.lanewise` on the CPU."""
    args = _final_camera(8, 8)
    out = [_plain(tb.final_scene(), args, 8, 8, 4, seed=7, spp_chunk=c)
           for c in (1, 3, 4)]
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    assert float(out[0].sum()) > 0


@pytest.mark.parametrize("op", ["pow", "atan2", "sin", "log"])
def test_lanewise_is_position_independent(op):
    """A value's result does not depend on where it lies in the tensor, or
    on the tensor's length (the CPU vector path's scalar tail)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.uniform(0.01, 1, 70001).astype(np.float32))
    y = torch.from_numpy(r.uniform(-1, 1, 70001).astype(np.float32))
    fn = {"pow": (lambda a: torch.pow(a, rng.ONE_THIRD), 1),
          "atan2": (torch.atan2, 2), "sin": (torch.sin, 1),
          "log": (torch.log, 1)}[op]
    args = (x, y)[:fn[1]]
    whole = rng.lanewise(fn[0], *args)
    for lo, hi in ((0, 37), (5, 1000), (63, 40000), (17, 70001)):
        part = rng.lanewise(fn[0], *(a[lo:hi] for a in args))
        assert torch.equal(part, whole[lo:hi])


def _ppm_python_join(img):
    """The encoder the port had: a Python join of the quantized channels."""
    img = np.clip(np.asarray(img), 0.0, 1.0)
    ny, nx, _ = img.shape
    q = tio.quantize(img).reshape(-1, 3)
    body = "\n".join(f"{r} {g} {b}" for r, g, b in q.tolist())
    return f"P3\n{nx} {ny}\n255\n{body}\n"


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 48)])
def test_ppm_bytes_equal_python_join_and_jax(shape):
    """The vectorised encoder's bytes equal the Python join's and the JAX
    package's `to_ppm` (its native encoder): random values, 0, 1, every
    quantization step and the float just under it, negatives and values
    above 1."""
    r = np.random.default_rng(shape[0])
    img = r.uniform(-0.5, 1.5, (*shape, 3)).astype(np.float32)
    flat = img.reshape(-1)
    steps = (np.arange(256, dtype=np.float32) / np.float32(255.99))
    special = np.concatenate([
        steps, np.nextafter(steps, np.float32(-1)),
        np.asarray([0, 1, -1, 2, 1e-9, -0.0, 0.5, 1 - 1e-7, 1e9],
                   np.float32)])
    k = min(flat.size, special.size)
    flat[:k] = special[:k]
    got = tio.to_ppm(img)
    assert got == _ppm_python_join(img) == jio.to_ppm(img)
    assert got.encode() == jio.to_ppm(img).encode()


def test_failed_launch_counts_nothing():
    """`_launch` raises on a launch error before any launch counter moves,
    and counts the sections of a launch that succeeded."""
    class Lib:
        def __init__(self, err):
            self.err = err

        def rt_trace_k1(self, *args):
            return self.err

    ops = tracer.trace_operands(
        tracer.build_scene_record(tb.final_scene()),
        tracer.build_camera_record(tb.PRESETS["final_scene"].camera()),
        "cpu")
    sums = torch.zeros((3, 4), dtype=torch.float64)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=1, max_depth=1,
              stream=None)
    names = ("KERNEL_LAUNCHES", "K1BE_LAUNCHES", "K1C_LAUNCHES",
             "K1D_LAUNCHES", "K1E_BOX_LAUNCHES", "K1D_WALK_LAUNCHES",
             "K1_LATTICE_LAUNCHES", "K1G_LAUNCHES")
    before = [getattr(tracer, n) for n in names]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tracer._launch(Lib(700), ops, sums, **kw)
    assert [getattr(tracer, n) for n in names] == before
    tracer._launch(Lib(0), ops, sums, **kw)
    assert [getattr(tracer, n) - b for n, b in zip(names, before)] == [
        0, 1, 1, 1, 1, 1, 0, 0]
    rr = dataclasses.replace(ops, feats=(ops.feats | tracer.FEAT_RR)
                             & ~tracer.FEAT_DENSE_WALK, rr_depth=5)
    tracer._launch(Lib(0), rr, sums, **kw)
    assert [getattr(tracer, n) - b for n, b in zip(names, before)] == [
        0, 2, 2, 2, 2, 1, 0, 1]


def test_inverse_render_seed_offsets_the_draws():
    """Seed 0 keys a step by its index as before; another seed gives other
    pixel blocks, rays and draws."""
    cam = inverse_render.camera()
    kw = dict(nx=16, ny=16, spp=2, block=32, max_depth=2, device="cpu")
    a = inverse_render.step_inputs(cam, 3, **kw)
    b = inverse_render.step_inputs(cam, 3, seed=0, **kw)
    c = inverse_render.step_inputs(cam, 3, seed=1, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the rays' directions and the draws (the pinhole's origins are one
    # point)
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[2], c[2])


# The chip smoke test's reference mean: the JAX XLA tier on the CPU, seed
# 0, depth 50, final_scene at 128×128, its preset's 100 spp.
SMOKE_SIZE = (128, 128, 100)


def jax_final_mean(nx, ny, spp):
    """The JAX XLA tier's mean gamma-space image of final_scene."""
    p = jb.PRESETS["final_scene"]
    cam = jcam.make_camera(*_final_camera(nx, ny))
    return float(np.asarray(jax_render(p.build(), cam, nx, ny, spp, seed=0,
                                       max_depth=50)).mean())


if __name__ == "__main__":
    print(f"final_scene {SMOKE_SIZE}: {jax_final_mean(*SMOKE_SIZE)!r}")
