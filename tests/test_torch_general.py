"""The general wavefront tier in the port (`ops/intersect.py`,
`ops/textures.py`, `ops/materials.py`, `ops/integrator.py`, `render.render`)
against the JAX package's XLA tier, on the CPU, and the engine choice of
the command line.

The module tests feed both packages the same numpy-seeded rays, hits and
uniforms; the JAX functions run op by op (`jax.disable_jit`), as its XLA
tier's jnp code computes each op, since XLA:CPU contracts a·b + c into FMAs
when it compiles a whole function. Whole renders compare within a Monte
Carlo band (the port's Philox draws are not JAX's), and against the
kernel's plain version `trace_plain`, whose draws the general tier shares.
Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import integrator as jint
from raytracing_rust_tpu.ops import intersect as jis
from raytracing_rust_tpu.ops import materials as jmat
from raytracing_rust_tpu.ops import textures as jtex
from raytracing_rust_tpu.render import render as jax_render
from raytracing_rust_tpu_torch import cli
from raytracing_rust_tpu_torch import render as trender
from raytracing_rust_tpu_torch.models.builders import PRESETS
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    SceneBuilder)
from raytracing_rust_tpu_torch.ops import integrator as tint
from raytracing_rust_tpu_torch.ops import intersect as tis
from raytracing_rust_tpu_torch.ops import materials as tmat
from raytracing_rust_tpu_torch.ops import rng, tracer
from raytracing_rust_tpu_torch.ops import textures as ttex
from raytracing_rust_tpu_torch.utils.image_io import read_ppm
import torch_threads  # noqa: F401  (one torch thread a process)


def _mixed(builder_cls):
    """Spheres, a moving sphere, rects in all three planes, a rotated and
    translated box, a flipped rect, a sphere medium and a rotated box
    medium; solid, checker, nested checker, marble and image textures."""
    b = builder_cls(background=BG_SKY, perlin_seed=3)
    img = np.random.default_rng(4).integers(0, 256, (5, 7, 3), np.uint8)
    grey = b.lambertian(b.solid(0.5, 0.5, 0.5))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(
        b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.image(img)))
    b.sphere((4, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.1))
    b.moving_sphere((2, 0.4, 2), (2, 0.9, 2), 0.0, 1.0, 0.4,
                    b.lambertian(b.noise(4.0)))
    b.rect("xy", -1, 0, 1, 2, -3.0, b.diffuse_light(b.solid(4, 4, 4)))
    b.rect("yz", 0, -2, 2, 2, -6.0, grey, flip=True)
    b.rect("zx", -2, -2, 2, 2, 5.0, b.diffuse_light(b.checker(
        b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0)), b.solid(0, 0, 1))))
    b.cube((0, 0, 0), (1, 1.5, 1), grey,
           xform=b.transform(offset=(-2, 0, 3), rotate_axis="y",
                             angle_deg=20.0))
    b.medium_sphere((0, 1, 4), 0.8, 0.7, b.solid(0.9, 0.9, 0.9))
    b.medium_box((0, 0, 0), (1, 1, 1), 0.4, b.solid(0.2, 0.4, 0.9),
                 xform=b.transform(offset=(3, 0, -3), rotate_axis="y",
                                   angle_deg=-30.0))
    return b.build()


def _scene_pair(build):
    return build(JSceneBuilder), build(SceneBuilder)


def _rays(n, seed):
    """Rays from a box around the scene toward its middle (unnormalized,
    |d| ~ 3), and shutter times in [0, 1)."""
    r = np.random.default_rng(seed)
    o = r.uniform([-7, 0.1, -7], [7, 6, 7], (n, 3)).astype(np.float32)
    aim = r.uniform([-4, 0, -4], [4, 2, 4], (n, 3)).astype(np.float32)
    d = ((aim - o) / 3.0).astype(np.float32)
    return o, d, r.random(n).astype(np.float32)


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("chunk", [None, 3])
def test_closest_hit_attributes_and_media_match_jax(chunk):
    """closest_hit (one pass, and in chunks of 3 prims), hit_attributes and
    media_scatter on 4,000 seeded rays through the mixed scene: t, the
    winner, p, the normal and the material equal JAX's bit for bit; u and
    v within 2.4e-7 absolute, two ulps of 1 (atan2 and asin are torch's,
    not XLA's); the media's events and their medium's material equal, the
    event's t within 1e-6 relative (ln is torch's)."""
    js, ts = _scene_pair(_mixed)
    o, d, time = _rays(4000, 1)
    with jax.disable_jit():
        jh = jis.closest_hit(js, _j(o), _j(d), _j(time), 1e-3, chunk=chunk)
        jp, jn, ju, jv, jm = jis.hit_attributes(js, _j(o), _j(d), _j(time),
                                                jh)
        u_med = np.random.default_rng(2).random((4000, 2)).astype(np.float32)
        jt_med, jm_med = jis.media_scatter(js, _j(o), _j(d), 1e-3, jh.t,
                                           _j(u_med))
    th = tis.closest_hit(ts, _t(o), _t(d), _t(time), 1e-3, chunk=chunk)
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(jh.t))
    np.testing.assert_array_equal(th.idx.numpy(), np.asarray(jh.idx))
    hit = th.mask.numpy()
    assert 0.3 < hit.mean() < 1.0
    tp, tn, tu, tv, tm = tis.hit_attributes(ts, _t(o), _t(d), _t(time), th)
    np.testing.assert_array_equal(tm.numpy()[hit], np.asarray(jm)[hit])
    np.testing.assert_array_equal(tp.numpy()[hit], np.asarray(jp)[hit])
    np.testing.assert_array_equal(tn.numpy()[hit], np.asarray(jn)[hit])
    for a, b in [(tu, ju), (tv, jv)]:
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=0, atol=2.4e-7)
    tt_med, tm_med = tis.media_scatter(ts, _t(o), _t(d), 1e-3, th.t,
                                       _t(u_med))
    ev = tt_med.numpy() < tis.BIG
    np.testing.assert_array_equal(ev, np.asarray(jt_med) < tis.BIG)
    assert ev.sum() > 50
    np.testing.assert_allclose(tt_med.numpy()[ev], np.asarray(jt_med)[ev],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tm_med.numpy()[ev], np.asarray(jm_med)[ev])


def test_eval_texture_matches_jax():
    """eval_texture on every texture of the mixed scene (solid, checker,
    the nested checker resolved one level as JAX's general tier resolves
    it, marble, image) at 3,000 seeded points and UVs: within 1e-6
    absolute of JAX's (sin, and the marble's Perlin noise, are torch's)."""
    js, ts = _scene_pair(_mixed)
    r = np.random.default_rng(5)
    n_tex = ts.tex_type.shape[0]
    tex = r.integers(0, n_tex, 3000).astype(np.int32)
    u, v = r.random((2, 3000)).astype(np.float32)
    p = r.uniform(-5, 5, (3000, 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jtex.eval_texture(js, _j(tex), _j(u), _j(v),
                                            _j(p)))
    got = ttex.eval_texture(ts, _t(tex), _t(u), _t(v), _t(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert len(np.unique(got.round(4), axis=0)) > 20


def test_scatter_and_emitted_match_jax():
    """scatter and emitted on 4,000 hits of seeded rays through the mixed
    scene with given uniforms: ok equal, direction and attenuation within
    1e-5 relative (the port's ball sample takes pow(x, 1/3) where JAX
    takes cbrt), emission within 1e-6."""
    js, ts = _scene_pair(_mixed)
    o, d, time = _rays(4000, 6)
    r = np.random.default_rng(7)
    u_sph = r.random((4000, 3)).astype(np.float32)
    u_br = r.random(4000).astype(np.float32)
    with jax.disable_jit():
        jh = jis.closest_hit(js, _j(o), _j(d), _j(time), 1e-3)
        p, n, u, v, m = jis.hit_attributes(js, _j(o), _j(d), _j(time), jh)
        jd, ja, jok = jmat.scatter(js, _j(d), p, n, u, v, m, _j(u_sph),
                                   _j(u_br))
        je = jmat.emitted(js, m, u, v, p)
    args = [_t(np.asarray(x)) for x in (p, n, u, v, m)]
    td, ta, tok = tmat.scatter(ts, _t(d), args[0], args[1], args[2],
                               args[3], args[4], _t(u_sph), _t(u_br))
    te = tmat.emitted(ts, args[4], args[2], args[3], args[0])
    hit = np.asarray(jh.mask)
    np.testing.assert_array_equal(tok.numpy()[hit], np.asarray(jok)[hit])
    np.testing.assert_allclose(td.numpy()[hit], np.asarray(jd)[hit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.numpy()[hit], np.asarray(ja)[hit],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(te.numpy()[hit], np.asarray(je)[hit],
                               rtol=0, atol=1e-6)
    mt = ts.mat_type.numpy()[args[4].numpy()[hit]]
    assert len(set(mt.tolist())) == 4  # lambertian, metal, glass, light


def _preset_pair(name, nx, ny):
    p = dataclasses.replace(PRESETS[name], nx=nx, ny=ny)
    return jb.PRESETS[name].build(), p.build(), p.camera()


@pytest.mark.parametrize("name,rr_depth", [
    ("cornell_smoke", None), ("two_spheres", None), ("cornell_box", 2)])
def test_bounce_matches_jax_on_jax_draws(name, rr_depth):
    """Five bounces of `_bounce` against JAX's `integrator._bounce` (jitted,
    as its tier runs it) from the same 16×16 camera rays, each bounce fed
    JAX's own `_lane_draws` (media
    columns on cornell_smoke, the roulette column under rr_depth 2): after
    every bounce at most 1% of the lanes' alive flags differ (a flip is a
    decision on an ulp: an edge, Schlick's draw, a free flight), and on the
    lanes alive in both o, d, thr and rad agree within 1e-4 of each row's
    largest component (1e-7 where that is below 1e-3)."""
    js, ts, cam = _preset_pair(name, 16, 16)
    n = 256
    pix = torch.arange(n, dtype=torch.int64)
    o, d, time = trender.camera_sample_rays(cam, pix, torch.zeros_like(pix),
                                            0, 16, 16, ts.has_moving)
    state_t = [o, d, torch.ones_like(o), torch.zeros_like(o),
               torch.ones(n, dtype=torch.bool)]
    state_j = [_j(x.numpy()) for x in state_t]
    key = jax.random.key(9)
    rr = rr_depth is not None
    jpack, tpack = jis.pack_prims(js), tis.plan_pack(ts)
    draws = jax.jit(lambda bj: jint._lane_draws(js, key, bj, n, jnp.float32,
                                                None, rr))
    bounce = jax.jit(lambda bj, *st: jint._bounce(
        js, jpack, key, 50, bj, *st[:2], _j(time.numpy()), *st[2:],
        rr_depth=rr_depth))
    flips = []
    for b in range(5):
        bj = jnp.int32(b)
        state_j = list(bounce(bj, *state_j))
        state_t = list(tint._bounce(ts, tpack, _t(draws(bj)), 50, b,
                                    *state_t[:2], time, *state_t[2:],
                                    rr_depth))
        a_t, a_j = state_t[4].numpy(), np.asarray(state_j[4])
        flips.append(int((a_t != a_j).sum()))
        assert flips[-1] <= n // 100, f"bounce {b}: {flips} flips"
        both = a_t & a_j
        for x, y in zip(state_t[:4], state_j[:4]):
            x, y = x.numpy()[both], np.asarray(y)[both]
            scale = np.maximum(np.abs(y).max(axis=1, keepdims=True), 1e-3)
            assert (np.abs(x - y) <= 1e-4 * scale).all(), (
                f"bounce {b}: {np.abs(x - y).max()}")
    assert state_t[3].sum() > 0


def _sums(name, nx, ny, spp, **kw):
    p = dataclasses.replace(PRESETS[name], nx=nx, ny=ny)
    return trender.render_sums(p.build(), p.camera(), nx, ny, spp,
                               device="cpu", **kw)


@pytest.mark.parametrize("name,rr_depth", [("cornell_box", None),
                                           ("cornell_smoke", 3)])
def test_compaction_is_bit_identical_to_full_width(name, rr_depth):
    """The compacted wavefront (gathers at bounces 6, 12 and 24) gives the
    full-width loop's sums bit for bit: a lane keeps its state and its
    draws' keys wherever the gather moves it."""
    kw = dict(seed=4, rr_depth=rr_depth)
    full = _sums(name, 16, 16, 4, compact=False, **kw)
    compact = _sums(name, 16, 16, 4, **kw)
    assert torch.equal(full, compact)
    assert full.sum() > 0


def test_image_is_bit_identical_across_blocks_and_chunks():
    """random_spheres (the sky, the checker, metal, glass, 311 moving
    spheres): the sums are the same bit for bit for every pixel block and
    sample chunk, deterministic per seed, and another seed changes them."""
    kw = dict(max_depth=8)
    ref = _sums("random_spheres", 12, 8, 4, seed=2, **kw)
    for block, chunk in [(96, None), (17, 3), (40, 1)]:
        got = _sums("random_spheres", 12, 8, 4, seed=2, block_pixels=block,
                    spp_chunk=chunk, **kw)
        assert torch.equal(got, ref), (block, chunk)
    assert torch.equal(_sums("random_spheres", 12, 8, 4, seed=2, **kw), ref)
    assert not torch.equal(_sums("random_spheres", 12, 8, 4, seed=3, **kw),
                           ref)


@pytest.mark.parametrize("name,spp,floor", [("cornell_box", 64, 0.006),
                                            ("two_spheres", 16, 0.004)])
def test_mean_matches_jax_render(name, spp, floor):
    """The general tier's image at 32×32, depth 50, against the JAX XLA
    tier's `render.render` at the same size and spp: the means of the two
    gamma-space images within max(6σ, floor), σ from the two images'
    per-pixel spread (their draws differ)."""
    p = dataclasses.replace(PRESETS[name], nx=32, ny=32)
    ours = trender.render(p.build(), p.camera(), 32, 32, spp, device="cpu")
    jp = dataclasses.replace(jb.PRESETS[name], nx=32, ny=32)
    ref = jax_render(jp.build(), jp.camera(), 32, 32, spp, seed=0)
    sigma = np.hypot(ours.std(), ref.std()) / 32
    diff = abs(float(ours.mean()) - float(ref.mean()))
    assert diff < max(6 * sigma, floor), (ours.mean(), ref.mean(), sigma)


# (scene, roulette depth) → (share of pixels within 1e-4 relative, the
# share within 1e-2, channel means' relative difference)
_VS_PLAIN = {
    ("cornell_box", None): (0.99, 1.0, 1e-6),
    ("cornell_box", 3): (0.99, 1.0, 1e-6),
    ("two_spheres", None): (0.99, 1.0, 1e-6),
    ("cornell_smoke", None): (0.99, 1.0, 1e-6),
    ("earth", None): (0.99, 1.0, 1e-6),
    ("random_spheres", None): (0.99, 0.99, 1e-3),
    # the marble amplifies ulps: see the test's docstring
    ("two_perlin_spheres", None): (0.97, 0.99, 1e-5),
}


@pytest.mark.parametrize("name,rr_depth", list(_VS_PLAIN))
def test_general_tier_matches_trace_plain(name, rr_depth):
    """The general tier against the kernel's plain version `trace_plain`
    on the same seed at 32×32×4, depth 50 (on cornell_box also with
    Russian roulette from bounce 3), the dense-medium walk off: they
    share their draws (the kernel's Philox slots), so a pixel's sums differ
    only where float rounding does. K1 takes t with a reciprocal and the
    sphere normal as (oc + t·d)·(1/r) where the JAX tier divides; where
    that flips no decision the sums agree to 1e-4 relative or better:
    100.0% of the pixels on cornell_box, two_spheres, cornell_smoke and
    earth, 99.5% on random_spheres (a glass or metal decision flips in
    4 of 1,024 pixels). On two_perlin_spheres the marble (0.5·(1 +
    sin(4x + 5·turb(p))), seven octaves) turns the ulps of p into up to
    2% of a pixel's albedo: 97.85% within 1e-4, 99.9% within 1e-2 and
    all within 2%, a semantic difference of rounding, not a fault; the
    channel means agree within 1e-5."""
    within4, within2, mean_rel = _VS_PLAIN[name, rr_depth]
    p = dataclasses.replace(PRESETS[name], nx=32, ny=32)
    scene, cam = p.build(), p.camera()
    g = trender.render_sums(scene, cam, 32, 32, 4, device="cpu", seed=0,
                            rr_depth=rr_depth)
    ops = tracer.trace_operands(tracer.build_scene_record(scene),
                                tracer.build_camera_record(cam), "cpu",
                                rr_depth)
    ops = dataclasses.replace(ops, feats=ops.feats & ~tracer.FEAT_DENSE_WALK)
    k = tracer.trace_plain(ops, torch.zeros_like(g), nx=32, ny=32, seed=0,
                           sample0=0, n_samples=4, max_depth=50)
    for rtol, share in [(1e-4, within4), (1e-2, within2)]:
        got = float(torch.isclose(g, k, rtol=rtol, atol=0).all(dim=0)
                    .double().mean())
        assert got >= share, (rtol, got)
    rel = ((g.mean(dim=1) - k.mean(dim=1)).abs() / k.mean(dim=1)).max()
    assert float(rel) <= mean_rel
    if name == "two_perlin_spheres":
        assert bool(torch.isclose(g, k, rtol=0.02, atol=0).all())


def _nine_media(builder_cls=SceneBuilder):
    b = builder_cls(background=BG_BLACK)
    b.sphere((0, -100, 0), 99.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.rect("zx", -20, -20, 20, 20, 12.0, b.diffuse_light(b.solid(3, 3, 3)))
    for i in range(tracer.MAX_MEDIA + 1):
        b.medium_sphere((3.0 * i - 12.0, 0, 0), 1.0, 0.5,
                        b.solid(0.9, 0.5 + 0.05 * i, 0.4))
    return b.build()


def _rotated_image_sphere(builder_cls=SceneBuilder):
    b = builder_cls(background=BG_SKY)
    xf = b.transform(offset=(0, 1, 0), rotate_axis="y", angle_deg=30.0)
    b.sphere((0, -1000, 0), 999.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(
        np.random.default_rng(3).integers(0, 256, (4, 6, 3), np.uint8))),
        xform=xf)
    return b.build()


def _camera(nx, ny):
    from raytracing_rust_tpu_torch.ops.camera import make_camera
    return make_camera((0, 3, 14), (0, 0.5, 0), (0, 1, 0), 40.0, nx / ny,
                       0.0, 10.0)


def test_media_slots_collide_with_nothing(monkeypatch):
    """Medium i < 8 keeps the kernel's slot (word i % 4 of STREAM_MEDIUM +
    i // 4); media 8 and up draw from STREAM_MEDIUM_HI on, so on the
    nine-media scene no medium reads the roulette's stream or any other
    purpose's, and no two media share a word. Checked on the slots and on
    the columns `lane_draws` fills; its one Philox pass over several
    streams (`draws_many`) gives each stream's `draws` bit for bit."""
    used = {rng.STREAM_CAMERA, rng.STREAM_SCATTER, rng.STREAM_TIME,
            rng.STREAM_GRAD, rng.STREAM_ROULETTE}
    slots = [rng.medium_slot(i) for i in range(40)]
    assert slots[:8] == [(rng.STREAM_MEDIUM + i // 4, i % 4)
                         for i in range(8)]
    assert len(set(slots)) == len(slots)
    assert not {s for s, _ in slots} & used
    pix, smp = torch.arange(70), torch.arange(70) % 3
    many = rng.draws_many(5, pix, smp, 2, [1, 4, 7])
    for k, stream in enumerate([1, 4, 7]):
        one = rng.draws(5, pix, smp, 2, stream)
        assert all(torch.equal(many[w][k], one[w]) for w in range(4))
    scene = _nine_media()

    def tagged(seed, pixel, sample, bounce, stream):
        shape = torch.broadcast_shapes(torch.as_tensor(pixel).shape,
                                       torch.as_tensor(stream).shape)
        return tuple((10.0 * torch.as_tensor(stream) + w).expand(shape)
                     for w in range(4))
    monkeypatch.setattr(rng, "draws", tagged)
    u = tint.lane_draws(scene, 0, torch.arange(3), torch.zeros(3), 1, True)
    assert u.shape == (3, 4 + 9 + 1)
    media = [(int(c) // 10, int(c) % 10) for c in u[0, 4:13]]
    assert media == [rng.medium_slot(i) for i in range(9)]
    assert int(u[0, -1]) == 10 * rng.STREAM_ROULETTE
    assert not {s for s, _ in media} & used


def test_k1_media_slots_unchanged():
    """K1's slot layout is the one it had before the general tier took
    media 8 and up: the plain version's sums on cornell_smoke (two media)
    at 24×24×4, seed 3, equal the earlier tree's bit for bit (their
    sha256, and their channel sums)."""
    import hashlib
    p = dataclasses.replace(PRESETS["cornell_smoke"], nx=24, ny=24)
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(p.camera()), "cpu")
    s = tracer.trace_plain(ops, torch.zeros((3, 576), dtype=torch.float64),
                           nx=24, ny=24, seed=3, sample0=0, n_samples=4,
                           max_depth=50)
    assert s.sum(dim=1).tolist() == [1083.1897964589298, 990.6278915035073,
                                     939.4245945316579]
    assert hashlib.sha256(s.numpy().tobytes()).hexdigest() == (
        "19937cdeab06beec93582c7b873fb15dc92ca0ca939d1c06568089ff51d7f289")


@pytest.mark.parametrize("build", [_nine_media, _rotated_image_sphere])
def test_auto_falls_back_on_a_refused_scene(build, capsys):
    """`cli.render_scene` on a scene the kernel refuses (nine media; an
    image on a rotated sphere): "kernel" raises UnsupportedScene, "auto"
    renders it on the general tier with one line on stderr, the image
    equal to "xla"'s bit for bit; a scene the kernel takes stays on it."""
    scene, cam = build(), _camera(12, 8)
    kw = dict(device="cpu", max_depth=6)
    with pytest.raises(tracer.UnsupportedScene):
        cli.render_scene(scene, cam, 12, 8, 2, engine="kernel", **kw)
    capsys.readouterr()
    img, engine = cli.render_scene(scene, cam, 12, 8, 2, engine="auto", **kw)
    err = capsys.readouterr().err
    assert engine == "xla" and err.count("\n") == 1 and "general tier" in err
    ref, _ = cli.render_scene(scene, cam, 12, 8, 2, engine="xla", **kw)
    np.testing.assert_array_equal(img, ref)
    assert np.isfinite(img).all() and img.mean() > 0.01
    p = dataclasses.replace(PRESETS["two_spheres"], nx=12, ny=8)
    _, engine = cli.render_scene(p.build(), p.camera(), 12, 8, 1,
                                 engine="auto", **kw)
    assert engine == "kernel" and capsys.readouterr().err == ""


def test_cli_engine_xla_renders_a_preset(tmp_path, capsys):
    """`render --engine xla --device cpu` renders a preset through the
    general tier and says so; the image agrees with the kernel engine's
    within the two engines' rounding (99% of pixels within 1e-3 after
    gamma and quantization: the PPM's bytes)."""
    outs = {}
    for engine in ("xla", "kernel"):
        outs[engine] = tmp_path / f"{engine}.ppm"
        rc = cli.main(["render", "--scene", "cornell_box", "--nx", "16",
                       "--ny", "16", "--spp", "2", "--device", "cpu",
                       "--engine", engine, "--out", str(outs[engine]),
                       "--timers"])
        assert rc == 0
        assert f"({engine} engine)" in capsys.readouterr().out
    a, b = read_ppm(str(outs["xla"])), read_ppm(str(outs["kernel"]))
    assert a.shape == (16, 16, 3) and 0.0 < a.mean() < 1.0
    assert (np.abs(a - b) <= 1e-3).all(axis=-1).mean() >= 0.99


def test_cli_auto_falls_back_and_kernel_exits_2(tmp_path, capsys,
                                                monkeypatch):
    """Through the command line, on a preset patched to the nine-media
    scene: `--engine kernel` exits 2 with the reason and writes no image;
    `--engine auto` (the default) renders it on the general tier with one
    line on stderr."""
    p = PRESETS["cornell_box"]
    monkeypatch.setitem(PRESETS, "cornell_box", dataclasses.replace(
        p, build=lambda device="cpu": _nine_media().to(device)))
    argv = ["render", "--scene", "cornell_box", "--nx", "12", "--ny", "8",
            "--spp", "1", "--max-depth", "6", "--device", "cpu",
            "--no-progress"]
    out = tmp_path / "k.ppm"
    assert cli.main(argv + ["--engine", "kernel", "--out", str(out)]) == 2
    assert "9 media" in capsys.readouterr().err and not out.exists()
    out = tmp_path / "a.ppm"
    assert cli.main(argv + ["--out", str(out)]) == 0
    cap = capsys.readouterr()
    assert "(xla engine)" in cap.out and cap.err.count("\n") == 1
    assert read_ppm(str(out)).shape == (8, 12, 3)


def test_stacked_turbulence_equals_turb3():
    """The general tier's marble turbulence (`perlin.turb3_stacked`: every
    octave and corner in one stacked batch) equals the kernel's plain model
    `turb3` bit for bit, at 3,000 seeded points of three scales."""
    from raytracing_rust_tpu_torch.ops import perlin
    r = np.random.default_rng(8)
    for scale in (1.0, 40.0, 600.0):
        p = torch.from_numpy((r.uniform(-1, 1, (3, 3000)) * scale)
                             .astype(np.float32))
        assert torch.equal(perlin.turb3_stacked(*p, seed=5),
                           perlin.turb3(*p, seed=5))


def test_general_render_on_cuda_without_cuda_raises():
    """The general tier defaults to the card and raises without CUDA: it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p = dataclasses.replace(PRESETS["cornell_box"], nx=4, ny=4)
    with pytest.raises(RuntimeError, match="cuda"):
        trender.render(p.build(), p.camera(), 4, 4, 1)
