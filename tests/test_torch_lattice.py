"""The port's lattice corners (textured lights, image rects, flipped image
spheres, textured media) and Russian roulette (K1g) against the JAX
package, on the CPU.

The kernel itself runs only on a CUDA card (tests/test_torch_kernel.py and
chip_smoke.py hold it against `trace_plain` there). Here: the records, the
medium record, the 11 flags, the dense flags and the texel atlas of
`lattice_scene` and of each former hole equal
`pallas_tracer.build_scene_record`'s field by field; rotated image spheres
and nested checkers still raise; a rect's UV, a flipped sphere's UV and
the three textured emissions agree with the JAX XLA tier's
`hit_attributes` and `emitted` on the same rays; `trace_plain` renders the
lattice scene and a fog over textured spheres to the JAX XLA tier's
radiometry per image half; roulette is unbiased, agrees with the JAX
tier's, changes nothing at the depth cap, and keeps the sums independent
of the sample chunking.

Run as a script (`PYTHONPATH=. python tests/test_torch_lattice.py`) it
prints the JAX XLA tier's lattice mean image that chip_smoke.py holds the
port's card render to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import camera as jcam
from raytracing_rust_tpu.ops import intersect as jint
from raytracing_rust_tpu.ops import materials as jmat
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu.render import render as jax_render
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    MAT_DIFFUSE_LIGHT,
                                                    SceneBuilder)
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import tracer
from raytracing_rust_tpu_torch.render import finalize_image
from test_torch_kernel import DOME_VIEW, HOLES, hole_scene, image_dome, texels
from test_torch_tracer import _assert_halves_agree
import torch_threads  # noqa: F401  (one torch thread a process)


def fog_scene(cls=SceneBuilder):
    """A solid-albedo fog over a marble and an image sphere, under the sky
    (tools/tpu_parity.py:205-216): a medium winner must shade with its own
    albedo, not the occluded surface's texture."""
    b = cls(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    b.sphere((-1.2, 1, 0), 1.0, b.lambertian(b.noise(3.0)))
    tex = (np.arange(8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
           % 256) / 255.0
    tex = np.rint(tex * 255) / np.float32(255.0)
    b.sphere((1.2, 1, 0), 1.0, b.lambertian(b.image(tex)))
    b.medium_sphere((0, 1, 0), 4.0, 0.4, b.solid(0.9, 0.9, 0.9))
    return b.build()


FOG_VIEW = ((0, 2, 9), (0, 1, 0), (0, 1, 0), 40.0)


def _jax_scene(name):
    if name == "lattice":
        return jb.lattice_scene()
    return hole_scene(name, JSceneBuilder)


def _port_scene(name):
    if name == "lattice":
        return tb.lattice_scene()
    return hole_scene(name)


@pytest.mark.parametrize("name", ("lattice",) + HOLES
                         + ("medium_beside_image_sphere",))
def test_records_equal_jax(name):
    """Record, kinds, groups, the 11 flags, the medium record with its
    texture fields, the media's dense flags and the texel atlas equal
    pallas_tracer.build_scene_record's."""
    srec = tracer.build_scene_record(_port_scene(name))
    (jrec, jkinds, jgroups, _, n_dyn, _, n_box, _, _, _, _, jmed, jmed_kinds,
     jflags, jimg) = pt.build_scene_record(_jax_scene(name))[:15]
    assert n_dyn == n_box == 0
    np.testing.assert_array_equal(srec.rec, jrec)
    assert srec.kinds == jkinds and srec.rect_groups == jgroups
    assert srec.flags == jflags
    np.testing.assert_array_equal(srec.med_rec, jmed[:len(srec.med_kinds)])
    assert tuple(zip(srec.med_kinds, srec.med_dense)) == jmed_kinds
    if srec.flags[4]:
        rows, w = srec.atlas.shape
        np.testing.assert_array_equal(srec.atlas, jimg[:rows, :w])
        assert not jimg[rows:].any() and not jimg[:, w:].any()
    else:
        assert srec.atlas.size == 0
    emis_tex, uv_carry, img_flip, med_tex = srec.flags[7:]
    want = {"lattice": (True, True, True, True),
            "emissive_checker": (True, False, False, False),
            "emissive_noise": (True, False, False, False),
            "emissive_image": (True, False, False, False),
            "image_rect": (False, True, False, False),
            "image_flipped_sphere": (False, False, True, False),
            "medium_checker": (False, False, False, True),
            "medium_noise": (False, False, False, True),
            "medium_image": (False, True, False, True),
            "medium_beside_image_sphere": (False, False, False, True)}[name]
    assert (emis_tex, uv_carry, img_flip, med_tex) == want
    bits = (tracer.FEAT_EMIS_TEX, tracer.FEAT_UV_CARRY, tracer.FEAT_IMG_FLIP,
            tracer.FEAT_MED_TEX)
    assert tuple(bool(srec.feats & b) for b in bits) == want
    if name == "medium_beside_image_sphere":
        assert srec.flags[4] and not uv_carry


def test_textured_media_never_walk():
    """A dense medium sealed by a glass sphere walks with a solid albedo
    and takes the event path when any medium of the scene is textured
    (pallas_tracer.py:935-940), as in the JAX kernel."""
    def build(cls, textured):
        b = cls(background=BG_BLACK)
        b.sphere((0, -1000, 0), 999.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
        b.sphere((0, 3, 0), 3.0, b.dielectric(1.5))
        b.medium_sphere((0, 3, 0), 3.0, 1.0, b.solid(0.8, 0.9, 0.95))
        b.medium_sphere((5, 1, 0), 1.0, 0.1, b.noise(2.0) if textured
                        else b.solid(0.5, 0.5, 0.5))
        return b.build()
    for textured in (False, True):
        srec = tracer.build_scene_record(build(SceneBuilder, textured))
        jmed_kinds = pt.build_scene_record(build(JSceneBuilder, textured))[12]
        assert tuple(zip(srec.med_kinds, srec.med_dense)) == jmed_kinds
        assert srec.med_dense[0] == (not textured)
        assert bool(srec.feats & tracer.FEAT_DENSE_WALK) == (not textured)


@pytest.mark.parametrize("what,why", [
    ("rotated_image_sphere", "rotated sphere"),
    ("nested_checker", "nested checker"),
    ("nested_medium_checker", r"nested checker \(medium albedo\)")])
def test_what_jax_refuses_still_raises(what, why):
    """An image on a rotated sphere and a nested checker, of a surface or
    of a medium, raise in both packages."""
    def build(cls):
        b = cls(background=BG_SKY)
        inner = b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0))
        if what == "rotated_image_sphere":
            xf = b.transform(rotate_axis="y", angle_deg=30.0)
            b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(texels())),
                     xform=xf)
        elif what == "nested_checker":
            b.sphere((0, 0, 0), 1.0,
                     b.lambertian(b.checker(inner, b.solid(1, 1, 1))))
        else:
            b.sphere((0, -100, 0), 99.0, b.lambertian(b.solid(1, 1, 1)))
            b.medium_sphere((0, 1, 0), 1.0, 0.5,
                            b.checker(inner, b.solid(1, 1, 1)))
        return b.build()
    with pytest.raises(tracer.UnsupportedScene, match=why):
        tracer.build_scene_record(build(SceneBuilder))
    with pytest.raises(pt.UnsupportedScene, match=why):
        pt.build_scene_record(build(JSceneBuilder))


def _jax_hits(jscene, o, d):
    """JAX XLA tier's closest hit and attributes of rays o, d (numpy)."""
    time_ = jnp.zeros(len(o), jnp.float32)
    hit = jint.closest_hit(jscene, jnp.asarray(o), jnp.asarray(d), time_,
                           1e-3)
    p, normal, u, v, mat = jint.hit_attributes(jscene, jnp.asarray(o),
                                               jnp.asarray(d), time_, hit)
    return (np.asarray(hit.mask), np.asarray(hit.t), np.asarray(hit.idx),
            np.asarray(p), np.asarray(normal), np.asarray(u), np.asarray(v),
            mat)


def _rays_at(targets, origin, r):
    o = np.broadcast_to(np.asarray(origin, np.float32),
                        targets.shape).astype(np.float32)
    o = o + r.normal(size=o.shape).astype(np.float32) * 0.05
    return o, (targets - o).astype(np.float32)


def test_rect_uv_matches_jax_hit_attributes():
    """`tracer.rect_uv` of the lattice's rotated, plain and flipped image
    rects at the JAX hit's t against `hit_attributes`' u, v, within 3e-6
    (the two compute the position in another order: o·an + t·(d·an) −
    a_off against (o + t·d)·an − a_off)."""
    jscene = jb.lattice_scene()
    srec = tracer.build_scene_record(tb.lattice_scene())
    rects = [p for p, k in enumerate(srec.kinds)
             if k == "rect" and srec.rec[p, tracer.R_IMG] > 0]
    assert len(rects) == 3
    r = np.random.default_rng(4)
    n = 2048
    for p in rects:
        row = srec.rec[p]
        a = r.uniform(row[tracer.R_A0], row[tracer.R_A1], n)
        b = r.uniform(row[tracer.R_B0], row[tracer.R_B1], n)
        an, bn, kn = (row[c:c + 3] for c in (tracer.R_AN, tracer.R_BN,
                                               tracer.R_KN))
        pts = ((a + row[tracer.R_AOFF])[:, None] * an
               + (b + row[tracer.R_BOFF])[:, None] * bn
               + row[tracer.R_KOFF] * kn).astype(np.float32)
        # from the side where nothing stands before the rect
        for side in (1.0, -1.0):
            o, d = _rays_at(pts, pts.mean(0) + 3.0 * side * kn, r)
            mask, t, idx, _, _, u, v, _ = _jax_hits(jscene, o, d)
            ok = mask & (idx == p)
            if ok.mean() > 0.9:
                break
        assert ok.mean() > 0.9
        rows = torch.from_numpy(srec.rec[idx[ok]])
        uu, vv = tracer.rect_uv([torch.from_numpy(o[ok, a]) for a in range(3)],
                                [torch.from_numpy(d[ok, a]) for a in range(3)],
                                torch.from_numpy(t[ok]), rows)
        np.testing.assert_allclose(uu.numpy(), u[ok], rtol=0, atol=3e-6)
        np.testing.assert_allclose(vv.numpy(), v[ok], rtol=0, atol=3e-6)


def test_flipped_sphere_uv_matches_jax_hit_attributes():
    """The kernel's UV of a flipped image sphere, `sphere_uv` of its
    flipped normal times the flip, against `hit_attributes`' u, v (from the
    pre-flip normal) within 2e-6, rays from outside and from inside."""
    jscene = jb.lattice_scene()
    srec = tracer.build_scene_record(tb.lattice_scene())
    (p,) = [p for p, k in enumerate(srec.kinds)
            if k == "sphere" and srec.rec[p, tracer.R_FLIP] < 0]
    row = srec.rec[p]
    c, rad = row[tracer.R_C0:tracer.R_C0 + 3], row[tracer.R_RADIUS]
    r = np.random.default_rng(5)
    n = 4096
    dirs = r.normal(size=(n, 3))
    pts = (c + 0.98 * rad * dirs / np.linalg.norm(dirs, axis=1,
                                                   keepdims=True))
    o = np.concatenate([np.broadcast_to(c + (0.0, 0.1, 1.5), (n // 2, 3)),
                        np.broadcast_to(c, (n // 2, 3))]).astype(np.float32)
    d = (pts - o).astype(np.float32)
    mask, t, idx, _, normal, u, v, _ = _jax_hits(jscene, o, d)
    ok = mask & (idx == p)
    assert ok.sum() > n // 4
    flip = float(row[tracer.R_FLIP])
    n_flipped = torch.from_numpy(normal[ok])
    uu, vv = tracer.sphere_uv(*(n_flipped * flip).unbind(-1))
    np.testing.assert_allclose(uu.numpy(), u[ok], rtol=0, atol=2e-6)
    np.testing.assert_allclose(vv.numpy(), v[ok], rtol=0, atol=2e-6)


@pytest.mark.parametrize("kind", ["checker", "noise", "image"])
def test_textured_emission_matches_jax_emitted(kind):
    """`tracer.texture_rgb` of the lattice's checker rect light, marble
    sphere light and image sphere light at the JAX hit points against
    `materials.emitted` (the texture's value), within 1e-5; the image's
    texels equal."""
    jscene = jb.lattice_scene()
    srec = tracer.build_scene_record(tb.lattice_scene())
    light = srec.rec[:, tracer.R_MAT] == MAT_DIFFUSE_LIGHT
    col = {"checker": tracer.R_CHECKER, "noise": tracer.R_NOISE,
           "image": tracer.R_IMG}[kind]
    (p,) = np.nonzero(light & (srec.rec[:, col] > 0))[0]
    row = srec.rec[p]
    assert not row[tracer.R_EMIT:tracer.R_EMIT + 3].any()
    r = np.random.default_rng(6)
    n = 4096
    if srec.kinds[p] == "rect":
        a = r.uniform(row[tracer.R_A0], row[tracer.R_A1], n)
        b = r.uniform(row[tracer.R_B0], row[tracer.R_B1], n)
        pts = ((a + row[tracer.R_AOFF])[:, None] * row[tracer.R_AN:
                                                       tracer.R_AN + 3]
               + (b + row[tracer.R_BOFF])[:, None] * row[tracer.R_BN:
                                                         tracer.R_BN + 3]
               + row[tracer.R_KOFF] * row[tracer.R_KN:tracer.R_KN + 3])
        origin = pts.mean(0) - (0.0, 3.0, 0.0)
    else:
        c = row[tracer.R_C0:tracer.R_C0 + 3]
        dirs = r.normal(size=(n, 3))
        pts = c + 0.9 * row[tracer.R_RADIUS] * dirs / np.linalg.norm(
            dirs, axis=1, keepdims=True)
        origin = c + (0.5, 0.5, 4.0)
    o, d = _rays_at(pts.astype(np.float32), origin, r)
    mask, _, idx, hp, normal, u, v, mat = _jax_hits(jscene, o, d)
    ok = mask & (idx == p)
    assert ok.sum() > n // 4
    want = np.asarray(jmat.emitted(jscene, mat, jnp.asarray(u),
                                   jnp.asarray(v), jnp.asarray(hp)))[ok]
    tex = torch.from_numpy(srec.rec[idx[ok], tracer.R_ALB_EVEN:
                                    tracer.R_ALB_EVEN + tracer.TEXW])
    nrm = torch.from_numpy(normal[ok])

    def uv_of(lanes):
        return tracer.sphere_uv(*nrm[lanes].unbind(-1))
    got = tracer.texture_rgb(
        tex, [torch.from_numpy(hp[ok, a]) for a in range(3)],
        torch.ones(int(ok.sum()), dtype=torch.bool), uv_of,
        torch.from_numpy(srec.atlas), srec.perlin_seed, checker=True,
        noise=True, image=True)
    got = torch.stack(got, -1).numpy()
    if kind == "image":
        assert (got == want).all(axis=1).mean() > 0.999
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.max() > 0.1


def _linear(img):
    return img ** 2


@pytest.mark.parametrize("name", ["lattice", "fog_over_textures",
                                  "image_dome"])
def test_plain_matches_jax_per_half(name):
    """trace_plain at 48×27, 32 spp, depth 16 against the JAX XLA tier, per
    image half within max(6σ, 0.012) in linear space: the lattice scene
    (tools/tpu_parity.py's camera), the fog over textured spheres, and a
    flipped image sphere seen from inside (the lattice's flipped image
    prims scatter light only inwards, into their own darkness)."""
    nx, ny, spp = 48, 27, 32
    if name == "lattice":
        scene, jscene = tb.lattice_scene(), jb.lattice_scene()
        cam, jc = tb.lattice_camera(nx, ny), jcam.make_camera(
            (0, 4, 14), (0, 1.5, 0), (0, 1, 0), 45.0, nx / ny, 0.0, 10.0,
            0.0, 1.0)
    else:
        scene, jscene, view, focus = {
            "fog_over_textures": (fog_scene(), fog_scene(JSceneBuilder),
                                  FOG_VIEW, 9.0),
            "image_dome": (image_dome(), image_dome(JSceneBuilder),
                           DOME_VIEW, 6.0)}[name]
        args = (*view, nx / ny, 0.0, focus, 0.0, 1.0)
        cam, jc = tcam.make_camera(*args), jcam.make_camera(*args)
    ours = _linear(tracer.render_kernel(scene, cam, nx, ny, spp,
                                        device="cpu", seed=11, max_depth=16))
    assert np.isfinite(ours).all() and ours.mean() > 0.002
    ref = _linear(np.asarray(jax_render(jscene, jc, nx, ny, spp, seed=11,
                                        max_depth=16)))
    _assert_halves_agree(ours, ref, 0.012)


def test_counts_gather_the_lattice_work():
    """trace_plain's counts on the lattice scene with roulette: textured
    light hits, rect-UV lanes, textured-medium events and roulette draws."""
    nx, ny = 24, 16
    ops = tracer.trace_operands(
        tracer.build_scene_record(tb.lattice_scene()),
        tracer.build_camera_record(tb.lattice_camera(nx, ny)), "cpu",
        rr_depth=2)
    assert ops.feats & tracer.FEAT_RR and ops.feats & tracer.FEAT_LATTICE
    counts = {}
    tracer.trace_plain(ops, torch.zeros((3, nx * ny), dtype=torch.float64),
                       nx=nx, ny=ny, seed=2, sample0=0, n_samples=8,
                       max_depth=16, counts=counts)
    for k in ("emis_tex", "rect_uv", "med_tex", "rr", "noise", "image"):
        assert 0 < counts[k] < counts["segments"], (k, counts)


def _enclosure(cls=SceneBuilder):
    """tests/test_rr.py's high-albedo closed box with a ceiling light."""
    b = cls(background=BG_BLACK)
    white = b.lambertian(b.solid(0.9, 0.9, 0.9))
    b.rect("zx", -5, -5, 5, 5, 0.0, white)
    b.rect("zx", -5, -5, 5, 5, 10.0, white, flip=True)
    b.rect("yz", 0, -5, 10, 5, -5.0, white)
    b.rect("yz", 0, -5, 10, 5, 5.0, white, flip=True)
    b.rect("xy", -5, 0, 5, 10, -5.0, white)
    b.rect("xy", -5, 0, 5, 10, 5.0, white, flip=True)
    b.rect("zx", -1, -1, 1, 1, 9.9, b.diffuse_light(b.solid(4, 4, 4)),
           flip=True)
    return b.build()


ENCLOSURE_VIEW = ((0, 5, 0), (1, 4, -2), (0, 1, 0), 90.0, 1.0, 0.0, 1.0,
                  0.0, 1.0)


def _enclosure_sums(rr_depth, n=32, spp=32, seed=4, chunk=None,
                    max_depth=50):
    ops = tracer.trace_operands(
        tracer.build_scene_record(_enclosure()),
        tracer.build_camera_record(tcam.make_camera(*ENCLOSURE_VIEW)), "cpu",
        rr_depth=rr_depth)
    sums = torch.zeros((3, n * n), dtype=torch.float64)
    chunk = chunk or spp
    for s0 in range(0, spp, chunk):
        tracer.trace(ops, sums, nx=n, ny=n, seed=seed, sample0=s0,
                     n_samples=min(chunk, spp - s0), max_depth=max_depth)
    return sums


def test_roulette_is_unbiased_and_matches_jax():
    """In tests/test_rr.py's enclosure (paths of tens of bounces), 32×32
    pixels × 32 spp: roulette from bounce 3 keeps the mean radiance within
    6% of no roulette (tests/test_rr.py's band) while it ends paths early;
    and the gamma images with roulette of the port and of the JAX XLA tier
    agree in their means within the same band (the same estimator, so the
    same expectation of each pixel's gamma)."""
    off, on = _enclosure_sums(None), _enclosure_sums(3)
    assert float(off.mean()) > 0.05 * 32
    np.testing.assert_allclose(float(on.mean()), float(off.mean()),
                               rtol=0.06)
    n, spp = 32, 32
    # render_kernel's image of the same render (seed 4, depth 50, roulette
    # from 3): its sums are `on`, whatever its chunks
    ours = finalize_image(on.T.numpy(), spp, n, n)
    ref = np.asarray(jax_render(_enclosure(JSceneBuilder),
                                jcam.make_camera(*ENCLOSURE_VIEW), n, n, spp,
                                seed=4, max_depth=50, rr_depth=3))
    np.testing.assert_allclose(ours.mean(), ref.mean(), rtol=0.06)


def test_roulette_at_the_cap_changes_nothing_and_chunking_keeps_bits():
    """rr_depth == max_depth never draws: the sums equal no roulette's bit
    for bit (the survival word has a stream of its own). With roulette on,
    chunks of 1, 3 and 8 samples give the same sums."""
    capped = _enclosure_sums(12, n=16, spp=8, max_depth=12)
    assert torch.equal(capped, _enclosure_sums(None, n=16, spp=8,
                                               max_depth=12))
    out = [_enclosure_sums(2, n=16, spp=8, chunk=c) for c in (1, 3, 8)]
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
    assert not torch.equal(out[0], _enclosure_sums(None, n=16, spp=8))


def test_roulette_turns_the_walk_off_and_operands_are_checked():
    """Roulette clears the dense-medium walk on final_scene (its bounces
    would skip the survival draws); the wrapper refuses FEAT_RR without a
    depth, a depth without FEAT_RR, and the two with the walk."""
    import dataclasses
    srec = tracer.build_scene_record(tb.final_scene())
    cam = tracer.build_camera_record(tb.PRESETS["final_scene"].camera())
    walk = tracer.trace_operands(srec, cam, "cpu")
    rr = tracer.trace_operands(srec, cam, "cpu", rr_depth=5)
    assert walk.feats & tracer.FEAT_DENSE_WALK and walk.rr_depth == -1
    assert rr.feats == (walk.feats | tracer.FEAT_RR) & ~tracer.FEAT_DENSE_WALK
    assert rr.rr_depth == 5 and rr.dense == walk.dense
    sums = torch.zeros((3, 4), dtype=torch.float64)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=1, max_depth=2)
    for bad in (dataclasses.replace(rr, rr_depth=-1),
                dataclasses.replace(walk, rr_depth=3),
                dataclasses.replace(rr, feats=rr.feats
                                    | tracer.FEAT_DENSE_WALK)):
        with pytest.raises(ValueError, match="FEAT_RR"):
            tracer.trace(bad, sums, **kw)
    with pytest.raises(ValueError, match="negative"):
        tracer.trace_operands(srec, cam, "cpu", rr_depth=-2)


# The chip smoke test's reference mean: the JAX XLA tier on the CPU, seed 0,
# depth 50, the lattice scene through tools/tpu_parity.py's camera at
# 128×72, 100 spp.
SMOKE_SIZE = (128, 72, 100)


def jax_lattice_mean(nx, ny, spp):
    """The JAX XLA tier's mean gamma-space image of the lattice scene."""
    cam = jcam.make_camera((0, 4, 14), (0, 1.5, 0), (0, 1, 0), 45.0, nx / ny,
                           0.0, 10.0, 0.0, 1.0)
    return float(np.asarray(jax_render(jb.lattice_scene(), cam, nx, ny, spp,
                                       seed=0, max_depth=50)).mean())


if __name__ == "__main__":
    print(f"lattice {SMOKE_SIZE}: {jax_lattice_mean(*SMOKE_SIZE)!r}")
