"""The port's K1 path (ops/tracer.py) against the JAX package.

The kernel itself runs only on a CUDA card (tests/test_torch_kernel.py and
chip_smoke.py hold it against `trace_plain` there). Here, on the CPU:
the scene and camera records equal the JAX kernel's cell by cell, the
partition of big scenes (dynamic sphere table, cluster table, flags)
included; the Philox generator reproduces Random123's known answers; the
samplers agree with the JAX ones on shared uniforms; `trace_plain` renders
cornell_box, two_spheres, random_spheres and the metal / glass / moving /
checker oracle scenes to the same radiometry as the JAX XLA tier or the
independent C++ mirror of the reference, within Monte Carlo tolerance;
and the image contract is byte-identical.
"""

import numpy as np
import pytest
import torch

from raytracing_rust_tpu import native
from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import camera as jcam
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu.ops import rng as jrng
from raytracing_rust_tpu.render import finalize_image as jax_finalize
from raytracing_rust_tpu.render import render as jax_render
from raytracing_rust_tpu.utils import image_io as jio
from raytracing_rust_tpu_torch import render as trender
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    SceneBuilder)
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import rng, tracer
from raytracing_rust_tpu_torch.utils import image_io as tio
import torch_threads  # noqa: F401  (one torch thread a process)


def _sphere_scene(builder_cls):
    """Spheres and a rect under a sphere light, black background: the
    static section's sphere path, which cornell_box does not reach."""
    b = builder_cls(background=BG_BLACK)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.7, 0.3, 0.2)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.1, 0.1, 0.1)))  # shadowed
    b.sphere((0, 5, 1), 1.5, b.diffuse_light(b.solid(6, 6, 6)))
    b.rect("xy", -3, 0, 3, 3, -2, b.lambertian(b.solid(0.2, 0.6, 0.3)),
           flip=True)
    return b.build()


_SPHERE_VIEW = ((0.0, 2.0, 8.0), (0.0, 1.0, 0.0), (0, 1, 0), 35.0)


def _oracle_spheres(builder_cls):
    """Lambertian, metal and glass spheres under the sky: the C++ mirror's
    scene 1 (tests/test_e2e_oracle.py:49-75)."""
    b = builder_cls(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.2))
    b.sphere((-2.2, 1, 0), 1.0, b.dielectric(1.5))
    return b.build()


def _moving_checker(builder_cls):
    """Checker ground, a moving sphere rising over the shutter, a sharp metal
    hero, the sky: the C++ mirror's scene 3 (tests/test_e2e_oracle.py:
    259-294)."""
    b = builder_cls(background=BG_SKY)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.moving_sphere((0, 1, 0), (0, 1.5, 0), 0.0, 1.0, 1.0,
                    b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.0))
    return b.build()


_ORACLE_SCENES = {"oracle_spheres": _oracle_spheres,
                  "moving_checker": _moving_checker}


def test_cornell_record_equals_jax():
    srec = tracer.build_scene_record(tb.cornell_box())
    jrec, jkinds, jgroups = pt.build_scene_record(jb.cornell_box())[0:3]
    assert srec.rec.dtype == jrec.dtype == np.float32
    np.testing.assert_array_equal(srec.rec, jrec)
    assert srec.kinds == jkinds == ("rect",) * 17
    assert srec.rect_groups == jgroups and len(jgroups) == 9
    assert srec.feats == 0 and len(srec.dyn_rec) == 0


def test_sphere_scene_record_equals_jax():
    srec = tracer.build_scene_record(_sphere_scene(SceneBuilder))
    jrec, jkinds, jgroups = pt.build_scene_record(
        _sphere_scene(JSceneBuilder))[0:3]
    np.testing.assert_array_equal(srec.rec, jrec)
    # the builder drops the coincident second sphere (first one wins)
    assert srec.kinds == jkinds == ("sphere",) * 3 + ("rect",)
    assert srec.rect_groups == jgroups


@pytest.mark.parametrize("name", ["random_spheres", "two_spheres",
                                  "oracle_spheres", "moving_checker"])
def test_record_parts_equal_jax(name):
    """The unrolled record, its kinds and groups, the dynamic sphere table,
    the cluster table and the flags equal pallas_tracer.build_scene_record's
    field by field."""
    if name in _ORACLE_SCENES:
        scene, jscene = (_ORACLE_SCENES[name](c)
                         for c in (SceneBuilder, JSceneBuilder))
    else:
        scene, jscene = tb.PRESETS[name].build(), jb.PRESETS[name].build()
    srec = tracer.build_scene_record(scene)
    (jrec, jkinds, jgroups, jdyn, n_dyn, _, n_box, jsclus, n_sclus, _, _,
     _, med_kinds, jflags) = pt.build_scene_record(jscene)[:14]
    assert n_box == 0 and med_kinds == ()
    np.testing.assert_array_equal(srec.rec, jrec)
    assert srec.kinds == jkinds and srec.rect_groups == jgroups
    assert srec.dyn_rec.dtype == np.float32
    np.testing.assert_array_equal(srec.dyn_rec, jdyn[:n_dyn])
    np.testing.assert_array_equal(srec.sclus, jsclus)
    assert srec.n_sclus == tuple(n_sclus)
    assert srec.flags == jflags
    if name == "random_spheres":
        # tests/test_pallas_record.py:42-59: four unrolled heroes, 397
        # dynamic spheres in 32 leaves, 311 of them moving
        assert srec.kinds == ("sphere",) * 4 and n_dyn == 397
        assert srec.n_sclus == (32, 4)
        assert int((srec.dyn_rec[:, tracer.R_INV_DT] != 0).sum()) == 311
        assert srec.feats == (tracer.FEAT_SKY | tracer.FEAT_CHECKER
                              | tracer.FEAT_METAL | tracer.FEAT_DIEL
                              | tracer.FEAT_MOVING)
    if name == "moving_checker":
        assert "moving" in srec.kinds and srec.feats & tracer.FEAT_MOVING


def test_walk_table_order():
    """Spheres first in record order, then the rects frame group by frame
    group, each rect tested in its group's first frame."""
    kinds = ("rect", "sphere", "rect", "rect", "sphere")
    walk = tracer.walk_table(kinds, ((0, 3), (2,)))
    np.testing.assert_array_equal(walk, [[1, 4, 0, 3, 2], [-1, -1, 0, 0, 2]])
    assert walk.dtype == np.int32


@pytest.mark.parametrize("name", ["cornell_box", "two_spheres", "final_scene"])
def test_camera_record_equals_jax(name):
    got = tracer.build_camera_record(tb.PRESETS[name].camera())
    want = pt.build_camera_record(jb.PRESETS[name].camera())
    np.testing.assert_array_equal(got, want)


def _image_pixels():
    return np.random.default_rng(3).integers(0, 256, (4, 6, 3), np.uint8)


def _rotated_image_sphere():
    b = SceneBuilder(background=BG_SKY)
    xf = b.transform(rotate_axis="y", angle_deg=30.0)
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(_image_pixels())), xform=xf)
    return b.build()


def _inexact_image():
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(
        np.full((2, 2, 3), 0.3, np.float32))))
    return b.build()


def _many_rects():
    """One more rect than the unroll budget, none of them forming a box."""
    b = SceneBuilder(background=BG_BLACK)
    m = b.lambertian(b.solid(0.5, 0.5, 0.5))
    for i in range(tracer.UNROLL_BUDGET + 1):
        b.rect("xy", 0, 0, 1, 1, float(i), m)
    return b.build()


def _nine_media():
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -100, 0), 99.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    for i in range(tracer.MAX_MEDIA + 1):
        b.medium_sphere((3.0 * i, 0, 0), 1.0, 0.5, b.solid(1, 1, 1))
    return b.build()


@pytest.mark.parametrize("name,why", [
    ("rotated_image_sphere", "image texture on a rotated sphere"),
    ("inexact_image", "not 8-bit exact"),
    ("nine_media", "9 media"),
    ("many_rects", "97 rects that form no box")])
def test_scenes_outside_k1a_raise(name, why):
    """What the kernel does not take, as the JAX kernel does not, raises,
    each with its reason: rotated image spheres, images that are not 8-bit
    exact, more media than the kernel holds, and more rects that form no
    box than the unroll holds (the lattice corners render:
    tests/test_torch_lattice.py)."""
    build = {"rotated_image_sphere": _rotated_image_sphere,
             "inexact_image": _inexact_image, "nine_media": _nine_media,
             "many_rects": _many_rects}[name]
    with pytest.raises(tracer.UnsupportedScene, match=why):
        tracer.build_scene_record(build())


def test_metal_moving_and_too_many_prims_raise():
    """Metal and moving spheres are in the kernel, and so are rects beside
    a dynamic sphere table (the JAX kernel's partition: the rect unrolls,
    and the movers that no longer fit beside it go dynamic); what still
    raises: more than UNROLL_BUDGET rects that form no box, a nested
    checker."""
    with pytest.raises(tracer.UnsupportedScene, match="97 rects"):
        tracer.build_scene_record(_many_rects())
    b = SceneBuilder(background=BG_SKY)
    for i in range(tracer.UNROLL_BUDGET):
        b.moving_sphere((i, 0, 0), (i, 1, 0), 0.0, 1.0, 0.2,
                        b.metal(b.solid(0.5, 0.5, 0.5), 0.1))
    b.rect("xy", 0, 0, 1, 1, -5.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    srec = tracer.build_scene_record(b.build())
    assert srec.kinds == ("rect",) and len(srec.dyn_rec) == 96
    assert srec.flags[5] and srec.feats & tracer.FEAT_MOVING
    b = SceneBuilder(background=BG_BLACK)
    inner = b.checker(b.solid(0, 0, 0), b.solid(1, 1, 1))
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.checker(inner, b.solid(1, 0, 0))))
    with pytest.raises(tracer.UnsupportedScene, match="nested checker"):
        tracer.build_scene_record(b.build())


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's philox4x32_10 known-answer vectors (kat_vectors)."""
    out = rng.philox4x32_10([torch.tensor([c], dtype=torch.int64)
                             for c in ctr], key)
    assert tuple(int(w[0]) for w in out) == want


def test_philox_matches_a_python_int_reference():
    """The 16-bit-split mulhilo against exact Python integers, on random
    counters and a key with both words set."""
    r = np.random.default_rng(1)
    ctr = r.integers(0, 1 << 32, (4, 64), dtype=np.int64)
    key = (0x12345678, 0x9abcdef0)

    def ref(c0, c1, c2, c3, k0, k1):
        for i in range(10):
            if i:
                k0, k1 = (k0 + 0x9E3779B9) & 0xFFFFFFFF, \
                    (k1 + 0xBB67AE85) & 0xFFFFFFFF
            p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
            c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & 0xFFFFFFFF,
                              (p0 >> 32) ^ c3 ^ k1, p0 & 0xFFFFFFFF)
        return c0, c1, c2, c3

    got = rng.philox4x32_10([torch.from_numpy(c) for c in ctr], key)
    for j in range(64):
        want = ref(*(int(c[j]) for c in ctr), *key)
        assert tuple(int(w[j]) for w in got) == want


def test_uniforms_are_24_bit_and_address_the_slots():
    u = rng.draws(7, torch.arange(1000), 3, 2, rng.STREAM_SCATTER)
    for w in u:
        assert w.dtype == torch.float32
        assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
        np.testing.assert_array_equal((w.numpy() * (1 << 24)) % 1, 0)
    other = rng.draws(7, torch.arange(1000), 3, 2, rng.STREAM_CAMERA)
    assert not torch.equal(u[0], other[0])
    np.testing.assert_allclose([float(w.mean()) for w in u], 0.5, atol=0.05)


def test_samplers_match_jax_on_shared_uniforms():
    r = np.random.default_rng(2)
    u = r.random((4096, 3), dtype=np.float32)
    u[0] = 0.0  # the 1-u radius: u=0 must not give the zero vector
    got = rng.in_unit_sphere(torch.from_numpy(u)).numpy()
    want = np.asarray(jrng.in_unit_sphere(u))
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)
    assert np.linalg.norm(got[0]) > 0.99
    assert np.linalg.norm(got, axis=1).max() <= 1.0 + 1e-6
    got = rng.in_unit_disk(torch.from_numpy(u[:, :2])).numpy()
    want = np.asarray(jrng.in_unit_disk(u[:, :2]))
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)


def _plain_image(scene, cam, nx, ny, spp, seed, spp_chunk=None):
    return tracer.render_kernel(scene, cam, nx, ny, spp, device="cpu",
                                seed=seed, max_depth=50, spp_chunk=spp_chunk)


def _stderr_of_mean(img):
    return float(np.std(img)) / np.sqrt(img.shape[0] * img.shape[1])


def _assert_halves_agree(ours, ref, floor):
    """Per image half, |mean difference| < max(6σ, floor): the Monte Carlo
    tolerance of tests/test_e2e_oracle.py, σ the two means' stderr."""
    ny = ours.shape[0]
    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, floor), (
            f"{name} half: port {a.mean():.4f} vs ref {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_cornell_plain_matches_jax_and_mirror_per_half():
    """trace_plain on cornell_box at 48×27, 96 spp, depth 50 against the
    JAX XLA tier and native.ref_trace(0, …), each per image half within
    max(6σ, 0.012) in clamped-linear space (gamma²)."""
    nx, ny, spp = 48, 27, 96
    p = tb.PRESETS["cornell_box"]
    args = (p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
            p.focus_dist, p.time0, p.time1)
    ours = _plain_image(p.build(), tcam.make_camera(*args), nx, ny, spp,
                        seed=5) ** 2
    assert ours.shape == (ny, nx, 3) and np.isfinite(ours).all()

    jax_img = np.asarray(jax_render(
        jb.cornell_box(), jcam.make_camera(*args), nx, ny, spp, seed=5,
        max_depth=50)) ** 2
    _assert_halves_agree(ours, jax_img, 0.012)

    ref, _ = native.ref_trace(0, nx, ny, spp, p.look_from, p.look_at, p.vfov,
                              vup=p.view_up, aperture=p.aperture,
                              focus_dist=p.focus_dist, background=0)
    ref = np.clip(np.sqrt(np.clip(ref, 0.0, None)), 0.0, 1.0) ** 2
    _assert_halves_agree(ours, ref, 0.012)


def test_sphere_scene_plain_matches_jax_per_half():
    nx, ny, spp = 40, 24, 48
    args = (*_SPHERE_VIEW, nx / ny, 0.1, 8.0, 0.0, 1.0)
    ours = _plain_image(_sphere_scene(SceneBuilder), tcam.make_camera(*args),
                        nx, ny, spp, seed=3) ** 2
    ref = np.asarray(jax_render(
        _sphere_scene(JSceneBuilder), jcam.make_camera(*args), nx, ny, spp,
        seed=3, max_depth=50)) ** 2
    assert ours.mean() > 0.02  # the light reaches the image
    _assert_halves_agree(ours, ref, 0.012)


@pytest.mark.parametrize("name", ["two_spheres", "random_spheres"])
def test_sphere_presets_plain_match_jax_per_half(name):
    """trace_plain on the One Weekend sphere presets at 48×27, 16 spp,
    depth 8 (tests/test_scene_stats.py's size) against the JAX XLA tier,
    per image half within max(6σ, 0.012) in linear space: checker, sky,
    metal, glass, moving spheres and random_spheres' dynamic table."""
    nx, ny, spp = 48, 27, 16
    p = tb.PRESETS[name]
    args = (p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
            p.focus_dist, p.time0, p.time1)
    ours = tracer.render_kernel(p.build(), tcam.make_camera(*args), nx, ny,
                                spp, device="cpu", seed=11,
                                max_depth=8) ** 2
    assert ours.shape == (ny, nx, 3) and np.isfinite(ours).all()
    ref = np.asarray(jax_render(jb.PRESETS[name].build(),
                                jcam.make_camera(*args), nx, ny, spp,
                                seed=11, max_depth=8)) ** 2
    _assert_halves_agree(ours, ref, 0.012)


@pytest.mark.parametrize("name,scene_id,seed", [
    ("oracle_spheres", 1, 3), ("moving_checker", 3, 9)])
def test_oracle_scenes_plain_match_mirror_per_half(name, scene_id, seed):
    """trace_plain against native.ref_trace, the f64 C++ mirror of the
    reference, at 64×36, 64 spp, depth 50, per image half within
    max(6σ, 0.01) (tests/test_e2e_oracle.py:49-77, 259-294): lambertian,
    metal and glass under the sky; the checker and a moving sphere."""
    nx, ny, spp = 64, 36, 64
    look_from, look_at, vfov = _SPHERE_VIEW[0], _SPHERE_VIEW[1], 35.0
    cam = tcam.make_camera(look_from, look_at, (0, 1, 0), vfov, nx / ny,
                           0.0, 10.0, 0.0, 1.0)
    ours = _plain_image(_ORACLE_SCENES[name](SceneBuilder), cam, nx, ny, spp,
                        seed=seed) ** 2
    ref, _ = native.ref_trace(scene_id, nx, ny, spp, look_from, look_at,
                              vfov, aperture=0.0, background=1)
    _assert_halves_agree(ours, ref, 0.01)


def _chunked_sums(scene, cam, chunk, *, n=16, spp=8, seed=11):
    ops = tracer.trace_operands(tracer.build_scene_record(scene),
                                tracer.build_camera_record(cam), "cpu")
    sums = torch.zeros((3, n * n), dtype=torch.float64)
    for s0 in range(0, spp, chunk):
        tracer.trace(ops, sums, nx=n, ny=n, seed=seed, sample0=s0,
                     n_samples=min(chunk, spp - s0), max_depth=50)
    return sums


def test_chunking_is_bit_identical():
    """Sums are added in sample order in f64, and a draw is addressed by its
    global sample index, so chunks of 2 and of 8 give the same bits."""
    p = tb.PRESETS["cornell_box"]
    scene, cam = p.build(), tcam.make_camera(
        p.look_from, p.look_at, p.view_up, p.vfov, 1.0, p.aperture,
        p.focus_dist, p.time0, p.time1)
    out = [_chunked_sums(scene, cam, chunk) for chunk in (2, 8)]
    assert torch.equal(out[0], out[1])
    assert float(out[0].sum()) > 0
    img = _plain_image(scene, cam, 16, 16, 8, seed=11, spp_chunk=3)
    np.testing.assert_array_equal(
        img, trender.finalize_image(out[0].T.numpy(), 8, 16, 16))


def test_chunking_with_moving_spheres_is_bit_identical():
    """The shutter time is drawn per (pixel, sample) like the camera ray, so
    a moving sphere keeps the sums independent of the chunking."""
    scene = _moving_checker(SceneBuilder)
    cam = tcam.make_camera(*_SPHERE_VIEW, 1.0, 0.1, 8.0, 0.0, 1.0)
    out = [_chunked_sums(scene, cam, chunk) for chunk in (1, 3, 8)]
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    img = _plain_image(scene, cam, 16, 16, 8, seed=11, spp_chunk=5)
    np.testing.assert_array_equal(
        img, trender.finalize_image(out[0].T.numpy(), 8, 16, 16))


def test_shutter_time_moves_the_sphere():
    """The same draws with a static copy of the mover give other sums: the
    shutter time reaches the moving sphere's center."""
    cam = tcam.make_camera(*_SPHERE_VIEW, 1.0, 0.0, 8.0, 0.0, 1.0)
    moving = _chunked_sums(_moving_checker(SceneBuilder), cam, 8)
    b = SceneBuilder(background=BG_SKY)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.0))
    static = _chunked_sums(b.build(), cam, 8)
    assert not torch.equal(moving, static)


def test_trace_on_cpu_runs_plain_and_launches_nothing():
    ops = tracer.trace_operands(
        tracer.build_scene_record(tb.cornell_box()),
        tracer.build_camera_record(tb.PRESETS["cornell_box"].camera()), "cpu")
    names = ("KERNEL_LAUNCHES", "K1BE_LAUNCHES", "K1C_LAUNCHES",
             "K1D_LAUNCHES", "K1E_BOX_LAUNCHES", "K1D_WALK_LAUNCHES",
             "K1_LATTICE_LAUNCHES", "K1G_LAUNCHES")
    before = [getattr(tracer, n) for n in names]
    a = torch.zeros((3, 64), dtype=torch.float64)
    b = torch.zeros((3, 64), dtype=torch.float64)
    tracer.trace(ops, a, nx=8, ny=8, seed=1, sample0=0, n_samples=2,
                 max_depth=5)
    tracer.trace_plain(ops, b, nx=8, ny=8, seed=1, sample0=0, n_samples=2,
                       max_depth=5)
    assert torch.equal(a, b)
    assert [getattr(tracer, n) for n in names] == before
    with pytest.raises(TypeError):
        tracer.trace(ops, a.float(), nx=8, ny=8, seed=1, sample0=0,
                     n_samples=1, max_depth=5)
    with pytest.raises(ValueError):
        tracer.trace(ops, a, nx=4, ny=8, seed=1, sample0=0, n_samples=1,
                     max_depth=5)


def test_render_kernel_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p = tb.PRESETS["cornell_box"]
    with pytest.raises(RuntimeError, match="cuda"):
        tracer.render_kernel(p.build(), p.camera(), 8, 8, 1, device="cuda")


def test_finalize_and_ppm_byte_identical_to_jax():
    r = np.random.default_rng(4)
    sums = r.normal(0.4, 0.5, (24 * 16, 3)) * 8  # negatives and > spp
    sums[3] = [0.0, 1e-9, 1e9]
    spp = 8
    got = trender.finalize_image(sums, spp, 24, 16)
    want = jax_finalize(sums, spp, 24, 16)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tio.to_ppm(got).encode() == jio.to_ppm(want).encode()
    np.testing.assert_array_equal(tio.quantize(got), jio.quantize(want))
