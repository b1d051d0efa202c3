"""The port's K1c (noise and image textures) and K1d event path (constant-
density media) against the JAX package, on the CPU.

The kernel itself runs only on a CUDA card (tests/test_torch_kernel.py and
chip_smoke.py hold it against `trace_plain` there). Here: the records, the
medium record, the flags and the texel atlas of the four Next Week presets
equal `pallas_tracer.build_scene_record`'s field by field; the port's
Perlin hash is bit-equal to the JAX package's and its noise and turbulence
agree with `ops/perlin` and the TPU kernel's `_noise3`/`_turb3`; the sphere
UV agrees with `intersect.hit_attributes` and the texel lookup with
`textures.eval_texture`; `trace_plain` renders the presets to the JAX XLA
tier's radiometry and the oracle scenes to the C++ mirror's, per image
half within Monte Carlo tolerance; media keep the sums independent of the
sample chunking.

Run as a script (`PYTHONPATH=. python tests/test_torch_textures.py`) it
prints the JAX XLA tier's mean images that chip_smoke.py holds the port's
CLI renders of the four presets to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_rust_tpu import native
from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import camera as jcam
from raytracing_rust_tpu.ops import intersect as jint
from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu.ops import perlin as jperlin
from raytracing_rust_tpu.ops.textures import eval_texture
from raytracing_rust_tpu.render import render as jax_render
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    SceneBuilder)
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import perlin, tracer
from test_torch_tracer import _assert_halves_agree
import torch_threads  # noqa: F401  (one torch thread a process)

NEXT_WEEK = ["two_perlin_spheres", "simple_light", "earth", "cornell_smoke"]


@pytest.mark.parametrize("name", NEXT_WEEK)
def test_records_atlas_and_media_equal_jax(name):
    """Record, kinds, groups, the 11 flags, the medium record and kinds, and
    the texel atlas equal pallas_tracer.build_scene_record's."""
    srec = tracer.build_scene_record(tb.PRESETS[name].build())
    (jrec, jkinds, jgroups, _, n_dyn, _, n_box, _, _, _, _, jmed, jmed_kinds,
     jflags, jimg) = pt.build_scene_record(jb.PRESETS[name].build())[:15]
    assert n_dyn == n_box == 0
    np.testing.assert_array_equal(srec.rec, jrec)
    assert srec.kinds == jkinds and srec.rect_groups == jgroups
    assert srec.flags == jflags
    assert srec.med_kinds == tuple(k for k, _ in jmed_kinds)
    assert srec.med_rec.dtype == np.float32
    np.testing.assert_array_equal(srec.med_rec, jmed[:len(srec.med_kinds)])
    assert srec.perlin_seed == 0
    if srec.flags[4]:
        rows, w = srec.atlas.shape
        assert srec.atlas.dtype == np.int32 and (rows, w) == (512, 1024)
        np.testing.assert_array_equal(srec.atlas, jimg[:rows, :w])
        assert not jimg[rows:].any() and not jimg[:, w:].any()
        assert srec.atlas.nbytes > 0
    else:
        assert srec.atlas.size == 0
    want = {"two_perlin_spheres": tracer.FEAT_SKY | tracer.FEAT_NOISE,
            "simple_light": tracer.FEAT_NOISE,
            "earth": tracer.FEAT_SKY | tracer.FEAT_IMAGE,
            "cornell_smoke": tracer.FEAT_MEDIA}[name]
    assert srec.feats == want
    if name == "cornell_smoke":
        # two rotated boxes; the white one scatters losslessly, the black
        # one absorbs
        assert srec.med_kinds == ("mbox", "mbox")
        np.testing.assert_array_equal(srec.med_rec[:, tracer.M_ALB],
                                      [1.0, 0.0])
        np.testing.assert_allclose(srec.med_rec[:, tracer.M_INV_RHO], 100.0)


def test_sphere_medium_record_equals_jax():
    """A rotated, offset sphere medium beside a box one (the record's
    sphere branch, r² and the rotation about x)."""
    def build(cls):
        b = cls(background=BG_BLACK)
        b.sphere((0, -100, 0), 100.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
        xf = b.transform(offset=(1, 2, 3), rotate_axis="x", angle_deg=30.0)
        b.medium_sphere((0.5, 1, 0), 2.0, 0.3, b.solid(0.2, 0.4, 0.9),
                        xform=xf)
        b.medium_box((-1, -1, -1), (1, 1, 1), 0.05, b.solid(1, 1, 1))
        return b.build()
    srec = tracer.build_scene_record(build(SceneBuilder))
    out = pt.build_scene_record(build(JSceneBuilder))
    np.testing.assert_array_equal(srec.med_rec, out[11])
    assert srec.med_kinds == ("msphere", "mbox")
    ops = tracer.trace_operands(srec, np.zeros(tracer.CAMREC, np.float32),
                                "cpu")
    assert ops.med_box == 0b10


def _hash_words_np(ci, cj, ck, seed):
    """ops/perlin.py `_gradient`'s hash of the JAX package in numpy uint32."""
    u = np.uint32
    with np.errstate(over="ignore"):
        h = ((ci.astype(u) * u(perlin.HA)) ^ (cj.astype(u) * u(perlin.HB))
             ^ (ck.astype(u) * u(perlin.HC))
             ^ u((seed * perlin.HSEED) & 0xFFFFFFFF))
        h = h ^ (h >> u(13))
        h = h * u(perlin.HM1)
        h = h ^ (h >> u(16))
        g = (h ^ u(perlin.HM2)) * u(perlin.HM3)
        g = g ^ (g >> u(16))
    return h, g


@pytest.mark.parametrize("seed", [0, 7, -3, (1 << 40) + 5])
def test_perlin_hash_bit_equal_and_noise_matches_jax(seed):
    """The int64 hash equals the uint32 one word for word on every corner
    of the 256³ lattice's diagonal planes; the gradient's z component (a
    function of the hash alone) equals JAX `_gradient`'s bit for bit;
    noise and turbulence agree with JAX `perlin.noise`/`turb` and the TPU
    kernel's `_noise3`/`_turb3` within 2e-6, negative coordinates
    included."""
    r = np.random.default_rng(abs(seed) % 1000)
    c = r.integers(0, 256, (3, 4096))
    h, g = perlin.hash_words(*(torch.from_numpy(x) for x in c), seed)
    hn, gn = _hash_words_np(*c, seed)
    np.testing.assert_array_equal(h.numpy(), hn.astype(np.int64))
    np.testing.assert_array_equal(g.numpy(), gn.astype(np.int64))
    got = perlin.gradient(*(torch.from_numpy(x) for x in c), seed)
    want = jperlin._gradient(*(jnp.asarray(x, jnp.int32) for x in c), seed)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)

    pts = r.uniform(-40.0, 40.0, (4096, 3)).astype(np.float32)
    tp = torch.from_numpy(pts)
    cols = [jnp.asarray(pts[:, i]) for i in range(3)]
    n = perlin.noise(tp, seed).numpy()
    np.testing.assert_allclose(n, np.asarray(jperlin.noise(jnp.asarray(pts),
                                                           seed)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(n, np.asarray(pt._noise3(*cols, seed)),
                               rtol=0, atol=2e-6)
    assert np.abs(n).max() <= 1.0 and n.std() > 0.05
    small = pts / 8.0
    t = perlin.turb(torch.from_numpy(small), seed=seed).numpy()
    np.testing.assert_allclose(
        t, np.asarray(jperlin.turb(jnp.asarray(small), seed=seed)),
        rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        t, np.asarray(pt._turb3(*[c / 8.0 for c in cols], seed)),
        rtol=0, atol=2e-6)


@pytest.mark.parametrize("compat", [False, True])
def test_sphere_uv_matches_jax_hit_attributes(compat):
    """`tracer.sphere_uv` of the winner's normal against the JAX XLA tier's
    `hit_attributes` u, v on rays that hit a sphere, within 1e-6, the
    reference's FRAC_2_PI constant on and off."""
    b = JSceneBuilder(background=BG_SKY, compat_uv_bug=compat)
    b.sphere((0.3, -0.2, 0.1), 2.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    scene = b.build()
    r = np.random.default_rng(8)
    n = 4096
    target = r.normal(size=(n, 3))
    target = 1.9 * target / np.linalg.norm(target, axis=1, keepdims=True)
    o = r.normal(size=(n, 3)) * 0.5 + np.array([0.0, 0.0, 12.0])
    o[: n // 2, 2] *= -1.0   # half the rays come from behind
    d = (target + np.array([0.3, -0.2, 0.1]) - o).astype(np.float32)
    o = o.astype(np.float32)
    time_ = jnp.zeros(n, jnp.float32)
    hit = jint.closest_hit(scene, jnp.asarray(o), jnp.asarray(d), time_, 1e-3)
    assert bool(np.asarray(hit.mask).all())
    _, normal, u, v, _ = jint.hit_attributes(scene, jnp.asarray(o),
                                             jnp.asarray(d), time_, hit)
    normal = torch.from_numpy(np.array(normal))
    uu, vv = tracer.sphere_uv(*normal.unbind(-1), compat)
    np.testing.assert_allclose(uu.numpy(), np.asarray(u), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vv.numpy(), np.asarray(v), rtol=0, atol=1e-6)


def test_texel_lookup_equals_jax_eval_texture():
    """Nearest texel with the v flip and the clamps, u and v beyond [0, 1]
    included, equal bit for bit to `textures.eval_texture` on a second,
    smaller image of the atlas (its true size, not the padded one)."""
    r = np.random.default_rng(9)
    big = r.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    small = r.integers(0, 256, (13, 17, 3), dtype=np.uint8)

    def build(cls):
        b = cls(background=BG_SKY)
        b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(big)))
        b.sphere((3, 0, 0), 1.0, b.lambertian(b.image(small)))
        return b.build()
    srec = tracer.build_scene_record(build(SceneBuilder))
    assert srec.atlas.shape == (48, 40)
    jscene = build(JSceneBuilder)
    n = 5000
    uv = r.uniform(-0.2, 1.2, (2, n)).astype(np.float32)
    uv[:, :8] = [[0, 1, 0.5, 1 - 1e-7, 0, 1, 0.999, 1e-8],
                 [0, 1, 0.5, 1e-7, 1, 0, 0.001, 0.999]]
    for p, tex_id in ((0, 0), (1, 1)):
        want = np.asarray(eval_texture(
            jscene, jnp.full(n, tex_id, jnp.int32), jnp.asarray(uv[0]),
            jnp.asarray(uv[1]), jnp.zeros((n, 3), jnp.float32)))
        row = torch.from_numpy(srec.rec[p]).expand(n, tracer.REC)
        got = tracer.texel_rgb(
            torch.from_numpy(srec.atlas), row[:, tracer.R_IMG_BASE],
            row[:, tracer.R_IMG_H], row[:, tracer.R_IMG_W],
            torch.from_numpy(uv[0]), torch.from_numpy(uv[1]))
        np.testing.assert_array_equal(torch.stack(got, -1).numpy(), want)


def _camera_args(p, nx, ny):
    return (p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
            p.focus_dist, p.time0, p.time1)


@pytest.mark.parametrize("name", NEXT_WEEK)
def test_presets_plain_match_jax_per_half(name):
    """trace_plain on each preset at 48×27 (cornell_smoke 32×32), 16 spp,
    depth 8 against the JAX XLA tier, per image half within max(6σ, 0.012)
    in linear space."""
    nx, ny = (32, 32) if name == "cornell_smoke" else (48, 27)
    p = tb.PRESETS[name]
    args = _camera_args(p, nx, ny)
    ours = tracer.render_kernel(p.build(), tcam.make_camera(*args), nx, ny,
                                16, device="cpu", seed=11, max_depth=8) ** 2
    assert ours.shape == (ny, nx, 3) and np.isfinite(ours).all()
    ref = np.asarray(jax_render(jb.PRESETS[name].build(),
                                jcam.make_camera(*args), nx, ny, 16, seed=11,
                                max_depth=8)) ** 2
    _assert_halves_agree(ours, ref, 0.012)


def _earth_image_scene():
    """The C++ mirror's scene 4: a synthetic 32×16 RGB pattern on an r=2
    sphere, under the reference's FRAC_2_PI sphere UV
    (tests/test_e2e_oracle.py:220-256)."""
    w, h = 32, 16
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([(8 * ii + 3 * jj) % 256, (5 * ii + 11 * jj) % 256,
                    (ii * jj) % 256], axis=-1).astype(np.uint8)
    b = SceneBuilder(background=BG_SKY, compat_uv_bug=True)
    b.sphere((0, 0, 0), 2.0, b.lambertian(b.image(pix)))
    return b.build()


def _fog_slab_scene():
    """The C++ mirror's scene 6: a gray 100-unit slab of medium before a
    unit emitter (tests/test_e2e_oracle.py:144-180)."""
    b = SceneBuilder(background=BG_BLACK)
    b.rect("xy", -100.0, -100.0, 100.0, 100.0, -50.0,
           b.diffuse_light(b.solid(1, 1, 1)))
    b.medium_box((-100, -100, 0), (100, 100, 100), 0.01,
                 b.solid(0.3, 0.3, 0.3))
    return b.build()


# scene id → (scene, nx, ny, spp, seed, look_from, look_at, vup, vfov,
# aperture, focus_dist, background, floor), as tests/test_e2e_oracle.py
_SMOKE = tb.PRESETS["cornell_smoke"]
_ORACLE = {
    2: (lambda: _SMOKE.build(), 48, 27, 96, 7, _SMOKE.look_from,
        _SMOKE.look_at, _SMOKE.view_up, _SMOKE.vfov, _SMOKE.aperture,
        _SMOKE.focus_dist, 0, 0.01),
    4: (_earth_image_scene, 64, 36, 64, 11, (13.0, 2.0, 3.0),
        (0.0, 0.0, 0.0), (0, 1, 0), 20.0, 0.1, 10.0, 1, 0.01),
    5: (lambda: tb.PRESETS["simple_light"].build(), 64, 36, 64, 13,
        (13.0, 3.0, 3.0), (0.0, 0.0, 0.0), (0, 1, 0), 50.0, 0.1, 10.0, 0,
        0.01),
    6: (_fog_slab_scene, 48, 27, 64, 17, (0.0, 0.0, 300.0), (0.0, 0.0, 0.0),
        (0, 1, 0), 30.0, 0.0, 10.0, 0, 0.01),
}


@pytest.mark.parametrize("scene_id", sorted(_ORACLE))
def test_oracle_scenes_plain_match_mirror_per_half(scene_id):
    """trace_plain against native.ref_trace, the f64 C++ mirror of the
    reference, per image half within max(6σ, 0.01) in clamped linear space:
    cornell_smoke (2), the image sphere (4), simple_light's noise (5) and
    the density-sensitive fog slab (6)."""
    (build, nx, ny, spp, seed, look_from, look_at, vup, vfov, aperture,
     focus, background, floor) = _ORACLE[scene_id]
    cam = tcam.make_camera(look_from, look_at, vup, vfov, nx / ny, aperture,
                           focus, 0.0, 1.0)
    ours = tracer.render_kernel(build(), cam, nx, ny, spp, device="cpu",
                                seed=seed) ** 2
    ref, _ = native.ref_trace(scene_id, nx, ny, spp, look_from, look_at,
                              vfov, vup=vup, aperture=aperture,
                              focus_dist=focus, background=background)
    ref = np.clip(np.sqrt(np.clip(ref, 0.0, None)), 0.0, 1.0) ** 2
    _assert_halves_agree(ours, ref, floor)


def _sphere_fog_scene():
    """A ground, a marble sphere and a sphere light inside a sphere of
    thin medium (not walk-dense: 4/ρ = 10 > its diameter 8)."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.noise(4.0)))
    b.sphere((0, 4, 1), 1.0, b.diffuse_light(b.solid(5, 5, 5)))
    b.medium_sphere((0, 1, 0), 4.0, 0.4, b.solid(0.9, 0.8, 0.7))
    return b.build()


def test_chunking_with_media_is_bit_identical():
    """The medium draws are addressed by (pixel, sample, bounce, stream), so
    chunks of 1, 3 and 8 samples give the same sums: cornell_smoke's two
    boxes, the fog slab, two_perlin_spheres' marble and a sphere of
    medium. On the CPU the transcendental functions go through
    `rng.lanewise`, so a lane's pow, atan2, sin, cos and log do not depend
    on where the chunk puts it in its tensor."""
    p = tb.PRESETS["cornell_smoke"]
    perlin_p = tb.PRESETS["two_perlin_spheres"]
    fog_cam = tcam.make_camera((0.0, 0.0, 300.0), (0.0, 0.0, 0.0), (0, 1, 0),
                               30.0, 1.0, 0.0, 10.0, 0.0, 1.0)
    for scene, c in ((p.build(), tcam.make_camera(*_camera_args(p, 16, 16))),
                     (_fog_slab_scene(), fog_cam),
                     (perlin_p.build(),
                      tcam.make_camera(*_camera_args(perlin_p, 16, 16))),
                     (_sphere_fog_scene(),
                      tcam.make_camera((0, 2, 9), (0, 1, 0), (0, 1, 0), 40.0,
                                       1.0, 0.1, 9.0, 0.0, 1.0))):
        ops = tracer.trace_operands(tracer.build_scene_record(scene),
                                    tracer.build_camera_record(c), "cpu")
        out = []
        for chunk in (1, 3, 8):
            sums = torch.zeros((3, 256), dtype=torch.float64)
            for s0 in range(0, 8, chunk):
                tracer.trace(ops, sums, nx=16, ny=16, seed=5, sample0=s0,
                             n_samples=min(chunk, 8 - s0), max_depth=50)
            out.append(sums)
        assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])
        assert float(out[0].sum()) > 0


def test_media_scatter_and_absorb():
    """The event path does what a medium does: a dense black box in front
    of a light blocks it, a clear one (density 1e-9) lets it through, and a
    white one scatters light out of the beam."""
    cam = tcam.make_camera((0, 0, 10), (0, 0, 0), (0, 1, 0), 20.0, 1.0, 0.0,
                           10.0, 0.0, 1.0)

    def mean(density, albedo):
        b = SceneBuilder(background=BG_BLACK)
        b.rect("xy", -5, -5, 5, 5, -1.0, b.diffuse_light(b.solid(1, 1, 1)))
        b.medium_box((-3, -3, 0), (3, 3, 2), density, b.solid(*albedo))
        img = tracer.render_kernel(b.build(), cam, 12, 12, 16, device="cpu",
                                   seed=2)
        return float(img.mean())
    assert mean(1e-9, (0, 0, 0)) > 0.99
    assert mean(5.0, (0, 0, 0)) < 0.01
    assert 0.05 < mean(0.3, (1, 1, 1)) < 0.99


def test_counts_gather_the_run_work():
    """trace_plain's counts: lane bounces, noise lanes and image lanes."""
    counts = {}
    p = tb.PRESETS["two_perlin_spheres"]
    ops = tracer.trace_operands(
        tracer.build_scene_record(p.build()),
        tracer.build_camera_record(tcam.make_camera(*_camera_args(p, 8, 8))),
        "cpu")
    sums = torch.zeros((3, 64), dtype=torch.float64)
    tracer.trace_plain(ops, sums, nx=8, ny=8, seed=1, sample0=0, n_samples=2,
                       max_depth=50, counts=counts)
    assert counts["segments"] >= 128 and counts["image"] == 0
    assert 0 < counts["noise"] < counts["segments"]


# The chip smoke test's reference means: the JAX XLA tier on the CPU, seed
# 0, depth 50, each preset's spp at half its width and height.
SMOKE_MEANS = {"two_perlin_spheres": (640, 360, 10),
               "simple_light": (640, 360, 100), "earth": (640, 360, 10),
               "cornell_smoke": (400, 400, 100)}


def jax_preset_mean(name, nx, ny, spp):
    """The JAX XLA tier's mean gamma-space image of a preset."""
    p = jb.PRESETS[name]
    cam = jcam.make_camera(*_camera_args(p, nx, ny))
    return float(np.asarray(jax_render(p.build(), cam, nx, ny, spp, seed=0,
                                       max_depth=50)).mean())


if __name__ == "__main__":
    for name, (nx, ny, spp) in SMOKE_MEANS.items():
        print(f"{name} {nx}x{ny}x{spp}: {jax_preset_mean(name, nx, ny, spp)!r}")
