"""The general tier under autograd in the port: `integrator.trace(
differentiable=True)`, `render.train_step`, `benchlib.grad_fd_err` and the
trainer's general-tier modes (`--no-fast`, `--unfused`, `--quick`, the
fallback), on the CPU.

The same scene goes through both packages by the weight carry: the JAX
build's tables, pulled to numpy, become the port's (`SceneTables.
from_numpy`). The port's gradients are held against `jax.grad` of the JAX
XLA tier's `trace(differentiable=True)` on JAX's own `_lane_draws`, fed to
the port through `u`, and against the fused tier's CPU twin (`trace_fast`)
on identical `fast_draws`: radiance within 2e-4, each table's gradient
within 5e-4 of that table's largest |gradient| (tests/test_pallas_grad.py's
`_grads_close`), and no gradient holds a NaN or an Inf. The JAX traces are
small (a few hundred rays, depth 4) to keep its compile cheap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import integrator as jint
from raytracing_rust_tpu_torch import benchlib
from raytracing_rust_tpu_torch import inverse_render as ir
from raytracing_rust_tpu_torch import render as trender
from raytracing_rust_tpu_torch.models.scene import (BG_SKY, SceneBuilder,
                                                    SceneTables)
from raytracing_rust_tpu_torch.ops import grad as tg
from raytracing_rust_tpu_torch.ops import integrator as tint
from raytracing_rust_tpu_torch.ops import intersect as tis
from test_torch_general import _mixed
from test_torch_grad import _jax_example
from test_torch_kernel import probe_scene
import torch_threads  # noqa: F401  (one torch thread a process)

# the float tables a gradient reaches (media densities stay parked)
LEAVES = ("prim_data", "mat_param", "tex_color", "images", "xf_sin",
          "xf_cos", "xf_offset", "tex_scale")


def _fields(tables) -> dict:
    """A JAX build's tables as numpy arrays and Python scalars."""
    tables = jax.device_get(tables)
    return {f.name: (getattr(tables, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(tables, f.name)))
            for f in dataclasses.fields(tables)}


def _carry(jscene) -> SceneTables:
    return SceneTables.from_numpy(_fields(jscene))


def _with_leaves(scene: SceneTables):
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in LEAVES}
    return dataclasses.replace(scene, **leaves), leaves


def _grads(loss, leaves: dict) -> dict:
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: (torch.zeros_like(v) if x is None else x).numpy()
            for (k, v), x in zip(leaves.items(), g)}


def _assert_leaves_close(got: dict, want: dict, what: str):
    """Each table within 5e-4 of want's largest |gradient| (1e-3 at
    least), every entry finite."""
    for k in got:
        g, w = got[k], np.asarray(want[k])
        assert np.isfinite(g).all(), f"{what}: {k} holds a NaN or an Inf"
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4 * scale,
                                   err_msg=f"{what}: gradient of {k}")


def _fd_probe_jax():
    """`benchlib.fd_probe`'s scene built by the JAX SceneBuilder (the JAX
    `grad_fd_err` builds it inside the metric)."""
    rng = np.random.default_rng(5)
    b = JSceneBuilder(background=BG_SKY)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    red = b.lambertian(b.solid(0.65, 0.05, 0.05))
    b.rect("zx", -2, -2, 2, 2, 0.0, white)
    b.rect("yz", 0, -2, 4, 2, -2.0, red)
    b.rect("zx", -1, -1, 1, 1, 4.0,
           b.diffuse_light(b.solid(5.0, 5.0, 5.0)), flip=True)
    b.sphere((0.5, 1.0, 0.5), 0.6, b.metal(b.solid(0.8, 0.8, 0.8), 0.3))
    b.sphere((-0.7, 0.7, -0.3), 0.5, b.dielectric(1.5))
    b.sphere((1.2, 0.6, -1.0), 0.6, b.lambertian(b.image(
        rng.uniform(0.1, 0.9, (8, 16, 3)).astype(np.float32))))
    return b.build()


def _marble(builder_cls):
    """Two marbles (scales 4 and 2.5) under a light and the sky."""
    b = builder_cls(background=BG_SKY, perlin_seed=2)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.noise(4.0)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.noise(2.5)))
    b.rect("zx", -1, -1, 1, 1, 4.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    return b.build()


def _spread(n, origin, lo, hi, seed):
    """n rays from origin with directions (x, y, −1), x and y uniform in
    [lo, hi] (numpy under seed)."""
    r = np.random.default_rng(seed)
    o = np.tile(np.asarray(origin, np.float32), (n, 1))
    d = np.stack([r.uniform(lo[0], hi[0], n), r.uniform(lo[1], hi[1], n),
                  -np.ones(n)], -1).astype(np.float32)
    return o, d


# the marble's tables held to JAX: all but the identity row's sin and cos.
# Turning the whole scene moves every hit point through 7 octaves of noise
# (the finest at 256 cycles a unit, ×5 inside a sine) while the texture
# stays put, so their gradient is f32 rounding amplified: on this test's
# rays xf_cos is 0.114947 in f64 (the port's tier on f64 tables), 0.114812
# in JAX's f32 and 0.114750 in the port's, each further from f64 than from
# the other
MARBLE_LEAVES = tuple(k for k in LEAVES if k not in ("xf_sin", "xf_cos"))


def _case(name):
    """(JAX scene, o, d, rr_depth, the tables held to JAX, the tables whose
    gradient must be live)."""
    if name == "fd_probe":
        _, o, d = benchlib.fd_probe("cpu", 256)
        return (_fd_probe_jax(), o.numpy(), d.numpy(), None, LEAVES,
                ("prim_data", "mat_param", "tex_color", "images"))
    if name.startswith("geometry"):
        # zero tilt: the cube's top and bottom frames equal the light's
        geo = _jax_example().build_geo_scene()
        o, d = _spread(256, (0, 2.2, 8), (-0.35, -0.4), (0.35, 0.1), 4)
        return (geo, o, d, 1 if name.endswith("rr") else None, LEAVES,
                ("prim_data", "tex_color", "xf_sin", "xf_cos", "xf_offset"))
    o, d = _spread(256, (0, 1.5, 6), (-0.6, -0.5), (0.6, 0.1), 6)
    return (_marble(JSceneBuilder), o, d, None, MARBLE_LEAVES,
            ("tex_scale", "xf_offset"))


def test_fd_probe_is_the_jax_metrics_probe():
    """fd_probe's tables equal the JAX build of grad_fd_err's probe."""
    port, _, _ = benchlib.fd_probe("cpu")
    want = _fields(_fd_probe_jax())
    for f in dataclasses.fields(SceneTables):
        got = getattr(port, f.name)
        if f.metadata.get("static"):
            assert got == want[f.name], f.name
        else:
            np.testing.assert_array_equal(got.numpy(), want[f.name],
                                          err_msg=f.name)


@pytest.mark.parametrize("name", ["fd_probe", "geometry", "marble",
                                  "geometry_rr"])
def test_grads_equal_jax_grad(name):
    """∂ mean(w · radiance) / ∂ each float table through the port's
    trace(differentiable=True) against jax.grad through JAX's, depth 4, on
    JAX's `_lane_draws` fed through u (the roulette's column too where
    rr_depth is 1): metal fuzz and the dielectric's index (mat_param),
    texels (images), sphere radii and centres (prim_data), the tilt's rows
    (xf_sin, xf_cos) and the marble's scale (tex_scale); the marble's
    tables as MARBLE_LEAVES says."""
    jscene, o, d, rr_depth, held, live = _case(name)
    n, md = o.shape[0], 4
    key = jax.random.key(3)
    u = np.stack([np.asarray(jint._lane_draws(
        jscene, key, jnp.int32(b), n, jnp.float32, None, rr_depth is not None))
        for b in range(md + 1)])
    w = np.random.default_rng(1).uniform(0.5, 1.5, (n, 3)).astype(np.float32)

    def jloss(s):
        rad = jint.trace(s, jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), key,
                         max_depth=md, differentiable=True, rr_depth=rr_depth)
        return jnp.mean(jnp.asarray(w) * rad), rad

    (_, jrad), jg = jax.value_and_grad(jloss, has_aux=True,
                                       allow_int=True)(jscene)
    scene, leaves = _with_leaves(_carry(jscene))
    rad = tint.trace(scene, torch.from_numpy(o), torch.from_numpy(d),
                     torch.zeros(n), 0, None, None, md, rr_depth,
                     differentiable=True, u=torch.from_numpy(u))
    np.testing.assert_allclose(rad.detach().numpy(), np.asarray(jrad),
                               rtol=2e-4, atol=2e-4)
    got = _grads(torch.mean(torch.from_numpy(w) * rad), leaves)
    assert all(np.isfinite(v).all() for v in got.values())
    _assert_leaves_close({k: got[k] for k in held},
                         {k: getattr(jg, k) for k in held}, name)
    for k in live:
        assert np.abs(got[k]).max() > 0, f"{name}: no gradient reaches {k}"


def _twin_case(name):
    """(scene, o, d) of the fused tier's CPU twin comparison."""
    if name == "inverse":
        scene = ir.build_scene(ir.START_ALBEDO, ir.START_EMIT)
        o, d, _ = ir.step_inputs(ir.camera(), 0, nx=200, ny=200, spp=4,
                                 block=128, max_depth=6, device="cpu")
        return scene, o, d
    o, d = _spread(512, (0, 2, 8), (-0.7, -0.45), (0.7, 0.25), 3)
    return probe_scene(SceneBuilder), torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("name", ["inverse", "probe"])
def test_general_tier_grads_equal_fused_twin(name):
    """The general tier's autograd against the fused tier's CPU twin
    (`trace_fast`: autograd through `trace_tiles_plain`) on identical
    `fast_draws`, depth 6: the default inverse scene at the trainer's start
    and the fused tier's probe scene (metal 0.2, glass 1.5, a rotated cube,
    the sky). Two implementations by different routes: the wavefront in
    eager ops over the tables, and the per-prim record's scalar twin."""
    scene, o, d = _twin_case(name)
    u = tg.fast_draws(7, o.shape[0], 7)
    w = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 1.5, (o.shape[0], 3)).astype(np.float32))
    s_gen, l_gen = _with_leaves(scene)
    rad = tint.trace(s_gen, o, d, torch.zeros(o.shape[0]), 0, None, None, 6,
                     differentiable=True, u=u)
    s_fast, l_fast = _with_leaves(scene)
    rad_f = tg.trace_fast(s_fast, o, d, 0, max_depth=6, u=u)
    np.testing.assert_allclose(rad.detach().numpy(), rad_f.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    got = _grads(torch.mean(w * rad), l_gen)
    want = _grads(torch.mean(w * rad_f), l_fast)
    _assert_leaves_close(got, want, name)
    assert np.abs(got["tex_color"]).max() > 0


def test_plan_hits_differentiates_rotated_rects():
    """Backward runs through the frames of rotated rects (the probe scene's
    cube) into xf_sin and xf_cos, and the hit is the same under autograd:
    without grad `frame` and `frames` are the value-distinct frames of the
    sorted unique; with it the frames split by source where the values
    coincide (the geometry scene at zero tilt: the cube's top and bottom
    and the light), and t, the winner and the attributes stay bit-equal.
    The gradient of t, p and the normal is finite on every lane, misses
    included (u and v carry none in a trace: the image fetch takes integer
    texel indices, the checker and the marble read p)."""
    for scene in (probe_scene(SceneBuilder), ir.build_geo_scene()):
        pl = tis.plan_pack(scene).plan
        rf = pl.rframes.T
        frames, frame = torch.unique(rf, dim=0, return_inverse=True)
        assert torch.equal(pl.frames.T, frames) and torch.equal(pl.frame,
                                                                frame)
        s_g, leaves = _with_leaves(scene)
        pk = tis.plan_pack(s_g)
        assert pk.plan.frames.requires_grad
        o, d = _spread(300, (0, 2, 8), (-0.7, -0.45), (0.7, 0.25), 8)
        o, d, time = torch.from_numpy(o), torch.from_numpy(d), torch.zeros(300)
        want = tis.closest_hit(scene, o, d, time, 1e-3,
                               pack=tis.plan_pack(scene))
        got = tis.closest_hit(s_g, o, d, time, 1e-3, pack=pk)
        assert torch.equal(got.t.detach(), want.t)
        assert torch.equal(got.idx, want.idx)
        a = tis.hit_attributes(s_g, o, d, time, got, pack=pk)
        b = tis.hit_attributes(scene, o, d, time, want,
                               pack=tis.plan_pack(scene))
        for x, y in zip(a, b):
            assert torch.equal(x.detach(), y)
        loss = got.t[got.mask].sum() + a[0].sum() + a[1].sum()
        g = _grads(loss, leaves)
        assert all(np.isfinite(v).all() for v in g.values())
        assert np.abs(g["xf_sin"]).max() > 0 and np.abs(g["xf_cos"]).max() > 0
    # the geometry scene at zero tilt: equal frame values from two rows
    assert pk.plan.frames.shape[1] > tis.plan_pack(scene).plan.frames.shape[1]
    # rays up into the cube's bottom face, whose frame value is the light's:
    # t's gradient reaches the cube's row as with no frame shared at all
    # (a pack without its plan: `plan_hits` with no src)
    o = torch.tensor([0.0, 0.2, 0.0]).expand(64, 3)
    r = np.random.default_rng(2)
    d = torch.from_numpy(np.stack([r.uniform(-1, 1, 64), np.ones(64),
                                   r.uniform(-1, 1, 64)], -1)
                         .astype(np.float32))
    rows = []
    for planned in (True, False):
        s_g, leaves = _with_leaves(scene)
        pack = tis.plan_pack(s_g) if planned else tis.pack_prims(s_g)
        hit = tis.closest_hit(s_g, o, d, torch.zeros(64), 1e-3, pack=pack)
        assert (hit.idx >= 2).all()  # every ray hits the cube
        rows.append(_grads(hit.t.sum(), leaves))
    for k in ("xf_sin", "xf_cos", "xf_offset"):
        np.testing.assert_allclose(rows[0][k], rows[1][k], rtol=1e-6,
                                   atol=0, err_msg=k)
    assert rows[0]["xf_sin"][ir.GEO_XF] != 0


@pytest.mark.parametrize("rr_depth", [None, 2])
def test_checkpointed_and_plain_autograd_are_bit_identical(rr_depth):
    """trace(differentiable=True) (each bounce under torch.utils.checkpoint)
    and plain autograd through trace(differentiable=False) give the same
    radiance and gradients bit for bit, equal to the no-grad trace, on a
    scene of every feature (media, a moving sphere, marble, image,
    nested checker, rotated box and box medium), Philox draws; every
    gradient finite."""
    scene = _mixed(SceneBuilder)
    o, d = _spread(384, (0, 3, 12), (-0.6, -0.45), (0.6, 0.05), 9)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    time = torch.from_numpy(np.random.default_rng(9).random(384)
                            .astype(np.float32))
    pix = torch.arange(384)
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 1.5, (384, 3)).astype(np.float32))
    with torch.no_grad():
        ref = tint.trace(scene, o, d, time, 5, pix, pix % 3, 8, rr_depth)
    out = []
    for diff in (False, True):
        s, leaves = _with_leaves(scene)
        rad = tint.trace(s, o, d, time, 5, pix, pix % 3, 8, rr_depth,
                         differentiable=diff)
        assert torch.equal(rad.detach(), ref)
        out.append(_grads(torch.mean(w * rad), leaves))
    for k in LEAVES:
        assert np.array_equal(out[0][k], out[1][k]), k
        assert np.isfinite(out[1][k]).all(), k
    assert np.abs(out[1]["tex_scale"]).max() > 0
    assert np.abs(out[1]["images"]).max() > 0


def test_draws_layouts_agree():
    """u in the fused tier's [n_bounce, 4, N] and in the column layout
    [n_bounce, N, 4] trace the same radiance; a wrong shape raises."""
    scene = ir.build_scene()
    o, d, u = ir.step_inputs(ir.camera(), 2, nx=50, ny=50, spp=2, block=40,
                             max_depth=3, device="cpu")
    t = torch.zeros(80)
    a = tint.trace(scene, o, d, t, 0, None, None, 3, u=u)
    b = tint.trace(scene, o, d, t, 0, None, None, 3,
                   u=u.transpose(1, 2).contiguous())
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tint.trace(scene, o, d, t, 0, None, None, 3, u=u[:, :, :40])
    with pytest.raises(ValueError):
        tint.trace(scene, o, d, t, 0, None, None, 4, u=u)


def test_train_step_equals_its_loss_by_hand():
    """render.train_step's loss and table gradients equal autograd of the
    same L2 through lane_radiance, and lane_radiance equals trace on
    camera_lane_rays' pixel-major lanes."""
    scene, cam = ir.build_scene(), ir.camera()
    pix = torch.tensor([5, 900, 20000, 39999])
    target = torch.full((4, 3), 0.1)
    loss, g = trender.train_step(scene, cam, pix, 11, target, nx=200,
                                 ny=200, spp=3, max_depth=4,
                                 wrt=("tex_color", "prim_data"))
    s, leaves = _with_leaves(scene)
    pid = pix.repeat_interleave(3)
    o, d, time = trender.camera_lane_rays(cam, pid, 11, 200, 200)
    lane = torch.arange(12)
    rad = tint.trace(s, o, d, time, 11, lane, torch.zeros_like(lane), 4)
    img = rad.reshape(4, 3, 3).sum(dim=1) / 3
    want = torch.mean((img - target) ** 2)
    assert loss.item() == want.item()
    gw = _grads(want, leaves)
    assert np.array_equal(g["tex_color"].numpy(), gw["tex_color"])
    assert np.array_equal(g["prim_data"].numpy(), gw["prim_data"])


def test_grad_fd_err_is_healthy():
    """The port's grad_fd_err (64 rays, depth 8, the JAX metric's
    defaults) stays under the 1e-3 health bar of
    tests/test_bench_grad_metric.py, every sweep contributing."""
    worst, per = benchlib.grad_fd_err(device="cpu", breakdown=True)
    assert worst <= 1e-3, per
    assert set(per) == {"albedo", "emission", "geometry", "mat_param",
                        "texels"}


def _summary(out: str) -> dict:
    """The numbers of the trainer's "recovered" line."""
    line = [ln for ln in out.splitlines() if ln.startswith("recovered")][0]
    got = {"albedo": [float(x) for x in
                      line.split("[")[1].split("]")[0].split()]}
    if "emission" in line:
        got["emit"] = float(line.split("emission")[1].split("(")[0])
    if "tilt" in line:
        got["tilt"] = float(line.split("tilt")[1].split("°")[0])
    return got


@pytest.mark.parametrize("argv", [
    ["--no-fast", "--steps", "4", "--spp", "8", "--block", "512"],
    ["--unfused", "--steps", "4", "--spp", "8", "--block", "512"],
    ["--geometry", "--no-fast", "--steps", "4", "--nx", "48", "--ny", "48",
     "--spp", "8", "--block", "256"]],
    ids=["no_fast", "unfused", "geometry_no_fast"])
def test_general_tier_modes_move_toward_truth(argv, capsys):
    """A few steps of each general-tier mode at the sizes of
    tests/test_inverse_render.py (the geometry mode at the trainer's depth
    6, and 10 steps: it rounds up to whole chunks): the tier is printed,
    the losses finite, the emission rises from its start, and the albedo's
    blue rises and its blue − red spread opens (0 at the start, 0.6 in
    truth; while the light is too dim every channel first rises with the
    emission, so red need not fall in 4 steps) in the default mode, or the
    tilt moves off 0 in the geometry mode."""
    rc = ir.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "differentiable tier: general wavefront tier" in out
    got = _summary(out)
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in out.splitlines() if " loss " in ln]
    assert np.isfinite(got["albedo"]).all() and np.isfinite(losses).all()
    if "--geometry" in argv:
        assert got["emit"] > ir.START_GEO_EMIT and got["tilt"] != 0.0, out
        assert np.isfinite(got["tilt"])
    else:
        a = got["albedo"]
        assert got["emit"] > ir.START_EMIT + 0.05, out
        assert a[2] > 0.5 and a[2] - a[0] > 0.05, out


@pytest.mark.parametrize("geometry", [False, True])
def test_no_fast_follows_the_fused_twin(geometry):
    """On the same steps the general tier and the fused tier's twin
    trace the same paths (`fast_draws`), so --no-fast takes the fused
    trainer's steps: 10 steps at 24×24, block 64, 4 spp, the parameters
    within 1e-4 and the losses within 1e-4 relative."""
    fn = ir.train_geometry if geometry else ir.train
    kw = dict(steps=10, nx=24, ny=24, spp=4, block=64, device="cpu",
              log=lambda *a: None)
    a, b = fn(fast=False, **kw), fn(**kw)
    assert (a["tier"], b["tier"]) == ("general", "fused")
    np.testing.assert_allclose(a["albedo"], b["albedo"], rtol=0, atol=1e-4)
    assert abs(a["emit"] - b["emit"]) <= 1e-4
    if geometry:
        assert abs(a["tilt_deg"] - b["tilt_deg"]) <= 1e-3
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4,
                               atol=1e-8)


def test_refused_scene_falls_back_to_the_general_tier():
    """Depth 17 is beyond the fused kernels' 16: the trainer says so and
    trains on the general tier; a scene with media is refused too."""
    lines = []
    res = ir.train(steps=2, nx=16, ny=16, spp=2, block=32, max_depth=17,
                   device="cpu", log=lines.append)
    assert res["tier"] == "general" and np.isfinite(res["losses"]).all()
    assert any("general wavefront tier" in ln and "depth 17" in ln
               for ln in lines), lines
    tier, line = ir.pick_tier(_mixed(SceneBuilder), 6, torch.device("cpu"))
    assert tier == "general" and "does not take" in line


def test_quick_recovers_the_albedo():
    """`--quick`'s loop (train_quick) on 2,048 of its 8,192 rays: the
    albedo ends within 0.08 of the truth, the green channel (no gradient
    at its start, 0.5 = the truth) stays put."""
    res = ir.train_quick(n_rays=2048, device="cpu", log=lambda *a: None)
    err = np.abs(res["albedo"] - np.asarray(ir.TRUE_ALBEDO))
    assert err.max() < 0.08, res["albedo"]
    assert np.isfinite(res["losses"]).all()


def test_general_entry_points_on_cuda_without_cuda_raise():
    """grad_fd_err, the general-tier trainer and --quick default to the
    card and raise without CUDA: none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for call in (lambda: benchlib.grad_fd_err(n_rays=4, max_depth=1),
                 lambda: ir.train(steps=1, nx=8, ny=8, spp=1, block=4,
                                  fast=False),
                 lambda: ir.train_quick(n_rays=4, steps=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
