"""The port's geometry inverse render (`inverse_render --geometry`) against
the JAX script's `main_geometry`, on the CPU.

The scene, its record and its config equal the JAX `build_geo_scene`'s;
the gradients that reach the scene's leaves through `trace_fast` (the
plain twin and torch autograd on the CPU), the cube's tilt through
`xf_sin` and `xf_cos` among them, equal `jax.grad` through the JAX
`fast_grad_record` and `_trace_tiles`; one geometry step on injected
identical rays and draws equals `jax.value_and_grad` of the JAX geometry
loss; twenty steps of the trainer follow the JAX `main_geometry` step and
its optimizer step by step on the same inputs; a tiny CPU run moves every
group. The twin's primal and vjp on this
scene, and K3's design, are held in tests/test_torch_grad.py (`SCENES`).
Tolerances are stated per test.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracing_rust_tpu.ops import pallas_grad as pg
from raytracing_rust_tpu_torch import inverse_render as ir
from raytracing_rust_tpu_torch.models.scene import SceneTables
from raytracing_rust_tpu_torch.ops import grad as tg
from raytracing_rust_tpu_torch.render import camera_lane_rays
from test_torch_grad import (GRAD_LEAVES, _assert_scale_close, _jax_example,
                             _jax_geo_scene, _jax_trace, _leaves, _probe, _t)
import torch_threads  # noqa: F401  (one torch thread a process)


@pytest.mark.parametrize("tilt", [0.0, ir.TRUE_TILT_DEG])
def test_geo_scene_record_and_rows_equal_jax(tilt):
    """Field by field, the record bit for bit, the config, and the trained
    texture rows (examples/inverse_render.py:482-485)."""
    port = ir.build_geo_scene(ir.START_GEO_ALBEDO, ir.TRUE_GEO_EMIT, tilt)
    ref = jax.device_get(_jax_geo_scene(ir.START_GEO_ALBEDO,
                                        ir.TRUE_GEO_EMIT, tilt))
    for f in dataclasses.fields(SceneTables):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.metadata.get("static"):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    np.testing.assert_array_equal(tg.fast_grad_record(port).numpy(),
                                  np.asarray(pg.fast_grad_record(ref)))
    assert tg.fast_grad_config(port) == pg.fast_grad_config(ref) == (
        ("s",) + ("r",) * 7, frozenset({"light", "sky"}))
    assert tg.supports_fast_grad(port, 6) and pg.supports_fast_grad(ref, 6)
    mat_tex = np.asarray(ref.mat_texture)
    prim_mat = np.asarray(ref.prim_material)
    assert ir.geo_param_rows(port) == (int(mat_tex[prim_mat[1]]),
                                       int(mat_tex[prim_mat[-1]]))
    assert float(port.xf_sin[ir.GEO_XF]) == np.float32(
        math.sin(math.radians(tilt)))


def test_geo_camera_equals_jax():
    """Field by field, bit for bit (examples/inverse_render.py:442-443)."""
    cam, ref = ir.geo_camera(), _jax_example().cam_geo
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(getattr(cam, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def test_geo_scene_leaf_grads_equal_jax():
    """d loss / d scene leaf through trace_fast (TraceFast's CPU backward)
    vs jax.grad through fast_grad_record + _trace_tiles on the geometry
    scene at 1,024 lanes and depth 6: each leaf within 5e-4 of its scale,
    and the tilt's own entries, xf_sin and xf_cos at GEO_XF, each within
    5e-4 of its own magnitude."""
    port = ir.build_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT, 10.0)
    ref = _jax_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT, 10.0)
    md = 6
    o, d, u, _ = _probe(1024, md + 1, seed=5)
    w = np.random.default_rng(1).uniform(0.5, 1.5, (1024, 3)).astype(
        np.float32)
    cfg = pg.fast_grad_config(ref)

    def jloss(s):
        return jnp.mean(w * _jax_trace(pg.fast_grad_record(s), o, d, u, cfg,
                                       md))
    want = jax.grad(jloss, allow_int=True)(ref)
    port = _leaves(port)
    rad = tg.trace_fast(port, _t(o), _t(d), 0, max_depth=md, u=_t(u))
    loss = torch.mean(_t(w) * rad)
    got = torch.autograd.grad(loss, [getattr(port, k) for k in GRAD_LEAVES],
                              allow_unused=True)
    got = {k: (torch.zeros_like(getattr(port, k)) if g is None else g)
           for k, g in zip(GRAD_LEAVES, got)}
    for k in GRAD_LEAVES:
        assert torch.isfinite(got[k]).all(), k
        _assert_scale_close(got[k].numpy(), getattr(want, k), 5e-4, k)
    for k in ("xf_sin", "xf_cos"):
        g = float(got[k][ir.GEO_XF])
        wk = float(np.asarray(getattr(want, k))[ir.GEO_XF])
        assert wk != 0 and abs(g - wk) <= 5e-4 * abs(wk), (k, g, wk)


def _geo_step_inputs(block, spp, md, seed):
    r = np.random.default_rng(seed)
    pid = torch.from_numpy(r.integers(0, 200 * 200, block)).long()
    o, d, _ = camera_lane_rays(ir.geo_camera(), pid.repeat_interleave(spp), 3,
                               200, 200)
    u = r.random((md + 1, 4, block * spp), dtype=np.float32)
    return o, d, u


def test_geometry_step_matches_jax():
    """One path-matched geometry step on injected identical rays and draws
    (64 pixels × 4 spp, depth 6): the loss within 1e-6 relative, the
    albedo, emission and θ gradients within 5e-4 of their scale, against
    jax.value_and_grad of the JAX geometry step's loss (main_geometry:
    tex_color rows, xf_sin/xf_cos at GEO_XF set from θ)."""
    block, spp, md = 64, 4, 6
    o, d, u = _geo_step_inputs(block, spp, md, seed=6)
    target_scene = ir.build_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT,
                                      ir.TRUE_TILT_DEG)
    scene = ir.build_geo_scene()
    light_tex, cube_tex = ir.geo_param_rows(scene)
    cfg = tg.fast_grad_config(scene)
    start = {"albedo": [0.45, 0.55, 0.6], "emit": 3.0, "theta": 0.2}
    albedo = torch.tensor(start["albedo"], requires_grad=True)
    emit = torch.tensor(start["emit"], requires_grad=True)
    theta = torch.tensor(start["theta"], requires_grad=True)
    loss = ir.path_matched_loss(target_scene, scene, light_tex, cube_tex,
                                albedo, emit, o, d, _t(u), block=block,
                                spp=spp, max_depth=md, cfg=cfg, theta=theta)
    loss.backward()

    jt = _jax_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT,
                        ir.TRUE_TILT_DEG)
    js = _jax_geo_scene(ir.START_GEO_ALBEDO, ir.TRUE_GEO_EMIT, 0.0)
    jo, jd = o.numpy(), d.numpy()

    def img(s):
        rad = _jax_trace(pg.fast_grad_record(s), jo, jd, u, cfg, md)
        return rad.reshape(block, spp, 3).sum(axis=1) / spp

    target = jax.lax.stop_gradient(img(jt))

    def loss_fn(p):
        s2 = dataclasses.replace(
            js, tex_color=js.tex_color.at[cube_tex].set(p["albedo"])
            .at[light_tex].set(jnp.broadcast_to(p["emit"], (3,))),
            xf_sin=js.xf_sin.at[ir.GEO_XF].set(jnp.sin(p["theta"])),
            xf_cos=js.xf_cos.at[ir.GEO_XF].set(jnp.cos(p["theta"])))
        return jnp.mean((img(s2) - target) ** 2)

    jl, jg = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v, jnp.float32) for k, v in start.items()})
    assert loss.item() > 0
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for k, g in (("albedo", albedo), ("emit", emit), ("theta", theta)):
        assert float(g.grad.abs().max()) > 0, k
        _assert_scale_close(g.grad.numpy(), jg[k], 5e-4, k)


def _jax_geo_trainer(inputs, *, block, spp, max_depth):
    """The JAX `main_geometry` step (examples/inverse_render.py:513-547:
    the path-matched loss, value_and_grad, optax Adam per group under the
    cosine decay over ceil(steps/10)·10 steps, the clamps) over the given
    (o, d, u) of each step → the parameters before each step and after the
    last, and the losses."""
    total = -(-len(inputs) // 10) * 10
    jt = _jax_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT,
                        ir.TRUE_TILT_DEG)
    js = _jax_geo_scene(ir.START_GEO_ALBEDO, ir.TRUE_GEO_EMIT, 0.0)
    light_tex, cube_tex = ir.geo_param_rows(ir.build_geo_scene())
    cfg = pg.fast_grad_config(js)

    def img(s, o, d, u):
        rad = _jax_trace(pg.fast_grad_record(s), o, d, u, cfg, max_depth)
        return rad.reshape(block, spp, 3).sum(axis=1) / spp

    @jax.jit
    def value_and_grad(p, o, d, u):
        target = jax.lax.stop_gradient(img(jt, o, d, u))

        def loss_fn(p):
            s2 = dataclasses.replace(
                js, tex_color=js.tex_color.at[cube_tex].set(p["albedo"])
                .at[light_tex].set(jnp.broadcast_to(p["emit"], (3,))),
                xf_sin=js.xf_sin.at[ir.GEO_XF].set(jnp.sin(p["theta"])),
                xf_cos=js.xf_cos.at[ir.GEO_XF].set(jnp.cos(p["theta"])))
            return jnp.mean((img(s2, o, d, u) - target) ** 2)
        return jax.value_and_grad(loss_fn)(p)

    sched = lambda lr: optax.cosine_decay_schedule(lr, total, alpha=0.1)
    opt = optax.multi_transform(
        {"albedo": optax.adam(sched(0.05)), "emit": optax.adam(sched(0.2)),
         "theta": optax.adam(sched(0.06))},
        {"albedo": "albedo", "emit": "emit", "theta": "theta"})
    p = {"albedo": jnp.asarray(ir.START_GEO_ALBEDO, jnp.float32),
         "emit": jnp.asarray(ir.START_GEO_EMIT, jnp.float32),
         "theta": jnp.asarray(ir.START_THETA, jnp.float32)}
    state = opt.init(p)
    params, losses = [], []
    for o, d, u in inputs:
        params.append((np.asarray(p["albedo"]), float(p["emit"]),
                       float(p["theta"])))
        loss, g = value_and_grad(p, o.numpy(), d.numpy(), u.numpy())
        updates, state = opt.update(g, state)
        p = optax.apply_updates(p, updates)
        p = {"albedo": jnp.clip(p["albedo"], 0.0, 1.0),
             "emit": jnp.clip(p["emit"], 0.0, 20.0),
             "theta": jnp.clip(p["theta"], -1.2, 1.2)}
        losses.append(float(loss))
    params.append((np.asarray(p["albedo"]), float(p["emit"]),
                   float(p["theta"])))
    return params, losses


def test_geometry_trainers_agree_step_by_step(monkeypatch):
    """10 steps (one chunk) of `train_geometry` on 32 pixels × 4 spp,
    depth 1 (a camera ray's hit, its scatter and the bounce that collects:
    the cube's normal and t reach the sky's radiance, so the tilt's whole
    geometric chain runs; each bounce more doubles the JAX gradient's
    compile time), numpy-seeded pixels and draws shared with the JAX
    `main_geometry` step: the parameters each step starts from (albedo,
    emission, θ) agree within 2e-5, the losses within 1e-4 relative or
    1e-7, the end point within 2e-5 (the default trainer's tolerances,
    tests/test_torch_inverse.py). A failure names the first step where
    they part."""
    steps, block, spp, md = 10, 32, 4, 1
    r = np.random.default_rng(21)
    cam = ir.geo_camera()
    inputs = []
    for i in range(steps):
        pid = torch.from_numpy(r.integers(0, 200 * 200, block)).long()
        o, d, _ = camera_lane_rays(cam, pid.repeat_interleave(spp), 2000 + i,
                                   200, 200)
        u = r.random((md + 1, 4, block * spp), dtype=np.float32)
        inputs.append((o, d, torch.from_numpy(u)))

    ours = []
    loss_fn = ir.path_matched_loss

    def recording_loss(*args, theta=None, **kw):
        ours.append((args[4].detach().numpy().copy(), args[5].item(),
                     theta.item()))
        return loss_fn(*args, theta=theta, **kw)
    monkeypatch.setattr(ir, "step_inputs", lambda cam, i, **kw: inputs[i])
    monkeypatch.setattr(ir, "path_matched_loss", recording_loss)
    res = ir.train_geometry(steps=steps, nx=200, ny=200, spp=spp,
                            block=block, max_depth=md, device="cpu",
                            log=lambda *a: None)
    ours.append((res["albedo"], res["emit"], math.radians(res["tilt_deg"])))

    want, want_losses = _jax_geo_trainer(inputs, block=block, spp=spp,
                                         max_depth=md)
    assert len(ours) == len(want) == steps + 1
    for i, ((a, e, th), (wa, we, wth)) in enumerate(zip(ours, want)):
        assert (np.abs(a - wa).max() <= 2e-5 and abs(e - we) <= 2e-5
                and abs(th - wth) <= 2e-5), (
            f"the trainers part before step {i}: albedo {a} vs {wa}, "
            f"emission {e} vs {we}, θ {th} vs {wth}")
    np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-4,
                               atol=1e-7)
    # the run moved every group
    assert abs(res["tilt_deg"]) > 0.1 and res["emit"] != ir.START_GEO_EMIT


def test_geometry_tiny_cpu_run_moves_all_groups():
    """24×24, block 64, 4 spp, 10 steps of the geometry mode on the CPU (the
    pattern of tests/test_inverse_render.py::test_geometry_mode_moves_all_
    groups): the losses are finite, the emission rises from its start and
    the tilt moves off 0."""
    lines = []
    res = ir.train_geometry(steps=10, nx=24, ny=24, spp=4, block=64,
                            device="cpu", log=lines.append)
    assert len(res["losses"]) == 10 and np.isfinite(res["losses"]).all()
    assert res["emit"] > ir.START_GEO_EMIT
    assert abs(res["tilt_deg"]) > 0.1
    assert np.abs(res["albedo"] - np.asarray(ir.START_GEO_ALBEDO)).max() > 0
    assert sum(ln.startswith("step ") for ln in lines) == 1
    assert "tilt" in lines[-1]


def test_geometry_steps_round_up_to_chunks_of_ten():
    """`main_geometry` runs ceil(steps/10)·10 steps; so does the port."""
    res = ir.train_geometry(steps=11, nx=16, ny=16, spp=1, block=16,
                            device="cpu", log=lambda _: None)
    assert len(res["losses"]) == 20 and len(res["step_walls"]) == 2


def test_main_geometry_prints_the_scripts_summary(capsys):
    rc = ir.main(["--geometry", "--device", "cpu", "--nx", "16", "--ny", "16",
                  "--block", "32", "--spp", "2", "--steps", "3"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "recovered albedo" in out and "tilt" in out and "°" in out
    assert "step time:" in out and "3 groups incl. geometry" in out
