"""The port's inverse-render trainer against the JAX package's, step by
step, on the CPU.

The port's 40-step default run recovers the albedo to within 0.070-0.077
and the emission to within 0.029-0.044 under five seeds, where the JAX
default gives 0.065 and 0.025. Here both trainers take the same pixels,
rays and draws at every step: the port's `inverse_render.train` (with `step_inputs` replaced by
the injected inputs) and the JAX fast step's loss, gradient, optax Adam
with its cosine schedule and the clamps (`examples/inverse_render.py`
`make_fast_step_body`, `main_sharded`). Their parameters stay together at
every step, so the trainers do not part; what differs between the two
runs is the draws, and the JAX default under other keys (below) lands
where the port does.

Run as a script (`PYTHONPATH=. python tests/test_torch_inverse.py 0 1 2 3
4`) it runs the JAX default (`examples/inverse_render.py`, 200×200, block
4,096 × 64 spp, depth 6, 40 steps, on the 8-device CPU mesh) with its two
keys offset by 1000·k for each k given (k = 0 is the default run), and
prints each run's recovered albedo and emission: the JAX spread beside
the port's (`python -m raytracing_rust_tpu_torch.inverse_render --seed k`).
"""

import os
import sys
import torch_threads  # noqa: F401  (one torch thread a process)

if __name__ == "__main__":
    # the JAX default's CPU mesh, set before jax is imported
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from raytracing_rust_tpu.ops import pallas_grad as pg
from raytracing_rust_tpu_torch import inverse_render as ir
from raytracing_rust_tpu_torch.render import camera_lane_rays
from test_torch_grad import _jax_inverse_scene, _jax_trace


def _jax_trainer(inputs, *, block, spp, max_depth):
    """The JAX fast step (examples/inverse_render.py:128-172) with its
    optimizer (346-350) over the given (o, d, u) of each step → the
    parameters before each step and after the last, and the losses."""
    steps = len(inputs)
    jt = _jax_inverse_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT)
    js = _jax_inverse_scene(ir.START_ALBEDO, ir.START_EMIT)
    light_tex, box_tex = ir.param_tex_rows(
        ir.build_scene(ir.START_ALBEDO, ir.START_EMIT))
    cfg = pg.fast_grad_config(js)

    def img(s, o, d, u):
        rad = _jax_trace(pg.fast_grad_record(s), o, d, u, cfg, max_depth)
        return rad.reshape(block, spp, 3).sum(axis=1) / spp

    @jax.jit
    def value_and_grad(p, o, d, u):
        target = jax.lax.stop_gradient(img(jt, o, d, u))

        def loss_fn(p):
            s2 = dataclasses.replace(
                js, tex_color=js.tex_color.at[box_tex].set(p["albedo"])
                .at[light_tex].set(jnp.broadcast_to(p["emit"], (3,))))
            return jnp.mean((img(s2, o, d, u) - target) ** 2)
        return jax.value_and_grad(loss_fn)(p)

    sched = lambda lr: optax.cosine_decay_schedule(lr, steps, alpha=0.1)
    opt = optax.multi_transform(
        {"albedo": optax.adam(sched(0.05)), "emit": optax.adam(sched(0.25))},
        {"albedo": "albedo", "emit": "emit"})
    p = {"albedo": jnp.asarray(ir.START_ALBEDO, jnp.float32),
         "emit": jnp.asarray(ir.START_EMIT, jnp.float32)}
    state = opt.init(p)
    params, losses = [], []
    for o, d, u in inputs:
        params.append((np.asarray(p["albedo"]), float(p["emit"])))
        loss, g = value_and_grad(p, o.numpy(), d.numpy(), u.numpy())
        updates, state = opt.update(g, state)
        p = optax.apply_updates(p, updates)
        p = {"albedo": jnp.clip(p["albedo"], 0.0, 1.0),
             "emit": jnp.clip(p["emit"], 0.0, 20.0)}
        losses.append(float(loss))
    params.append((np.asarray(p["albedo"]), float(p["emit"])))
    return params, losses


def test_trainers_agree_step_by_step(monkeypatch):
    """40 steps (the default schedule's length) of 32 pixels × 4 spp, depth
    2, on numpy-seeded pixels and draws shared by both trainers: the
    parameters each step starts from agree within 2e-5, the losses within
    1e-4 relative or 1e-7 (a loss near the truth is a small difference of
    near-equal images), the end point within 2e-5. A failure names the first
    step where they part."""
    steps, block, spp, md = 40, 32, 4, 2
    r = np.random.default_rng(12)
    cam = ir.camera()
    inputs = []
    for i in range(steps):
        pid = torch.from_numpy(r.integers(0, 200 * 200, block)).long()
        o, d, _ = camera_lane_rays(cam, pid.repeat_interleave(spp), 1000 + i,
                                   200, 200)
        u = r.random((md + 1, 4, block * spp), dtype=np.float32)
        inputs.append((o, d, torch.from_numpy(u)))

    ours = []
    loss_fn = ir.path_matched_loss

    def recording_loss(*args, **kw):
        albedo, emit = args[4], args[5]
        ours.append((albedo.detach().numpy().copy(), emit.item()))
        return loss_fn(*args, **kw)
    monkeypatch.setattr(ir, "step_inputs", lambda cam, i, **kw: inputs[i])
    monkeypatch.setattr(ir, "path_matched_loss", recording_loss)
    res = ir.train(steps=steps, nx=200, ny=200, spp=spp, block=block,
                   max_depth=md, device="cpu", log=lambda *a: None)
    ours.append((res["albedo"], res["emit"]))

    want, want_losses = _jax_trainer(inputs, block=block, spp=spp,
                                     max_depth=md)
    assert len(ours) == len(want) == steps + 1
    for i, ((a, e), (wa, we)) in enumerate(zip(ours, want)):
        assert np.abs(a - wa).max() <= 2e-5 and abs(e - we) <= 2e-5, (
            f"the trainers part before step {i}: albedo {a} vs {wa}, "
            f"emission {e} vs {we}")
    np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-4,
                               atol=1e-7)
    # the run moved: the recovered parameters are not the start
    assert abs(res["emit"] - ir.START_EMIT) > 0.5


def _jax_default_spread(offsets):
    """The JAX default run with its keys offset (see the module
    docstring) → one printed line per offset."""
    import contextlib
    import io
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    import examples.inverse_render as ex
    key = jax.random.key
    for k in offsets:
        # key(0) and key(1) of the step body become key(1000k), key(1000k+1)
        jax.random.key = lambda s, _k=k: key(s + 1000 * _k)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = ex.main_sharded(40)
        finally:
            jax.random.key = key
        last = [ln for ln in out.getvalue().splitlines()
                if ln.startswith("recovered")]
        print(f"key offset {k}: exit {rc}; {last[-1]}", flush=True)


if __name__ == "__main__":
    _jax_default_spread([int(a) for a in sys.argv[1:]] or [0])
