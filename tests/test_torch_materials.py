"""The fused differentiable tier's materials (metal, dielectric and the 3-D
checker, an emissive checker included) in the port, against the JAX
package, on the CPU.

The scenes are tests/test_pallas_grad.py's (built in
tests/test_torch_kernel.py, which the card runs without JAX): `probe_scene` (12 prims: a
floor, a red wall, a flipped light, a metal sphere of fuzz 0.2, a glass
sphere of index 1.5, a lambertian sphere and a rotated, translated cube)
under the sky and under black, the checker scene (a checker floor at
y = 0.37, off the sin = 0 planes, and an emissive checker sphere) and the
glass-interior probe (rays starting inside a glass sphere: the exit, total
internal reflection and Schlick-at-exit branches). Each is built with the
port's SceneBuilder beside the JAX one, and the same numpy-seeded rays,
draws and cotangent go through the plain twin `trace_tiles_plain` and the
JAX `_trace_tiles`. The CUDA kernels K2/K3 are held against the twin on the
card (tests/test_torch_kernel.py, chip_smoke.py); here their design is, by
`_k3_mirror`. Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import pallas_grad as pg
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    TEX_CHECKER, SceneBuilder)
from raytracing_rust_tpu_torch.ops import grad as tg
from test_torch_grad import (GRAD_LEAVES, _assert_cols_close,
                             _assert_scale_close, _jax_trace, _k3_mirror,
                             _leaves, _probe, _replay_tape, _t)
from test_torch_kernel import checker_scene, glass_scene, probe_scene
import torch_threads  # noqa: F401  (one torch thread a process)


def small_scene(builder_cls):
    """tests/test_pallas_grad.py small_scene: 4 prims, every family."""
    b = builder_cls(background=BG_SKY)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    b.sphere((-1.0, 0.8, 0.6), 0.7, b.dielectric(1.5))
    return b.build()


def _interior_rays(n, n_bounce, seed):
    """Rays from inside the glass sphere at a spread of angles (beyond the
    critical one too), draws and a cotangent."""
    _, _, u, ct = _probe(n, n_bounce, seed)
    r = np.random.default_rng(12)
    o = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d, u, ct


# name → (scene, depth, rays, the d_rec columns jax.vjp makes live)
SCENES = {
    "probe_sky": (probe_scene, 6, _probe,
                  set(range(1, 9)) | {15, 22, 26, 27, 28, 29, 30}),
    "probe_black": (lambda B: probe_scene(B, BG_BLACK), 6, _probe,
                    {26, 28, 29, 30}),
    "checker": (checker_scene, 6, _probe,
                set(range(1, 9)) | {22, 26, 28, 29, 30, 31, 32, 33}),
    "interior": (glass_scene, 4, _interior_rays,
                 set(range(1, 9)) | {15, 22, 27, 28, 29, 30}),
}


@pytest.mark.parametrize("name", [*SCENES, "small"])
def test_record_and_config_equal_jax(name):
    """fast_grad_record bit for bit, fast_grad_config equal, both gates
    admit the scene."""
    make = small_scene if name == "small" else SCENES[name][0]
    port, ref = make(SceneBuilder), make(JSceneBuilder)
    np.testing.assert_array_equal(tg.fast_grad_record(port).numpy(),
                                  np.asarray(pg.fast_grad_record(ref)))
    cfg = tg.fast_grad_config(port)
    assert cfg == pg.fast_grad_config(ref)
    assert tg.supports_fast_grad(port, 16) and pg.supports_fast_grad(ref, 16)
    assert set(cfg[1]) & {"metal", "diel", "checker"}


@pytest.fixture(scope="module", params=list(SCENES))
def twin_vs_jax(request):
    """1,024 lanes (the interior at depth 4, the rest at depth 6): the
    twin's primal and vjp, JAX's, and the scene leaves' gradients of
    <ct, radiance> through the JAX fast_grad_record's vjp."""
    make, md, rays, live = SCENES[request.param]
    port, ref = make(SceneBuilder), make(JSceneBuilder)
    o, d, u, ct = rays(1024, md + 1, 3)
    cfg = pg.fast_grad_config(ref)
    jrec, rec_vjp = jax.vjp(pg.fast_grad_record, ref)
    rec = np.asarray(jrec)
    want, vjp = jax.vjp(lambda r, o_, d_: _jax_trace(r, o_, d_, u, cfg, md),
                        jnp.asarray(rec), jnp.asarray(o), jnp.asarray(d))
    want_g = vjp(jnp.asarray(ct))
    want_leaves = rec_vjp(want_g[0])[0]
    got = tg.trace_tiles_plain(_t(rec), _t(o), _t(d), _t(u), cfg, md)
    got_g = tg.trace_tiles_plain_vjp(_t(rec), _t(o), _t(d), _t(u), _t(ct),
                                     cfg, md)
    return dict(name=request.param, port=port, cfg=cfg, md=md,
                rays=(o, d, u, ct), live=live, got=got,
                want=np.asarray(want), got_g=got_g,
                want_g=[np.asarray(g) for g in want_g],
                want_leaves={k: np.asarray(getattr(want_leaves, k))
                             for k in GRAD_LEAVES})


def test_twin_primal_equals_jax(twin_vs_jax):
    """Within 1e-6 (2 ulp at the radiance's scale; exp, log, sin and cos
    round differently in XLA and torch). No lane's checker pick flips: the
    checker surfaces sit off the sin = 0 planes."""
    t = twin_vs_jax
    got = t["got"].numpy()
    assert got.shape == (1024, 3) and np.isfinite(got).all()
    assert got.sum() > 0
    np.testing.assert_allclose(got, t["want"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i,leaf", [(0, "d_rec"), (1, "d_o"), (2, "d_d")])
def test_twin_vjp_equals_jax_vjp(twin_vs_jax, i, leaf):
    """Torch autograd through the twin vs jax.vjp under the same ct: each
    d_rec column within 5e-4 of its own scale (C_PARAM's ~0.2 beside
    C_TEX_E's ~150 on probe_scene), the live columns those jax.vjp makes
    live (fuzz and ref_idx in C_PARAM under the sky, both checker rows);
    d_o and d_d within 5e-4 of their scale, exact zeros under black."""
    t = twin_vs_jax
    got, want = t["got_g"][i].numpy(), t["want_g"][i]
    assert np.isfinite(got).all() and np.isfinite(want).all()
    if i == 0:
        _assert_cols_close(got, want, 5e-4, leaf)
        live = set(np.nonzero(np.abs(want).max(axis=0))[0].tolist())
        assert live == t["live"]
        assert set(np.nonzero(np.abs(got).max(axis=0))[0].tolist()) == live
        assert not live & {tg.C_IS_SPHERE, tg.C_LAMB, tg.C_METAL, tg.C_DIEL,
                           tg.C_CHK}
    elif "sky" in t["cfg"][1]:
        _assert_scale_close(got, want, 5e-4, leaf)
        assert np.abs(got).max() > 0
    else:
        assert not np.abs(got).any() and not np.abs(want).any()


def test_scene_leaf_grads_equal_jax(twin_vs_jax):
    """d <ct, radiance> / d scene leaf through trace_fast (TraceFast's CPU
    backward through fast_grad_record) vs jax.vjp through the JAX
    fast_grad_record and _trace_tiles: each leaf within 5e-4 of its scale;
    fuzz and ref_idx (mat_param) live under the sky, and on the checker
    scene both children's tex_color rows of each checker."""
    t = twin_vs_jax
    o, d, u, ct = t["rays"]
    port = _leaves(t["port"])
    rad = tg.trace_fast(port, _t(o), _t(d), 0, max_depth=t["md"], u=_t(u))
    got = torch.autograd.grad((rad * _t(ct)).sum(),
                              [getattr(port, k) for k in GRAD_LEAVES],
                              allow_unused=True)
    for k, g in zip(GRAD_LEAVES, got):
        g = torch.zeros_like(getattr(port, k)) if g is None else g
        assert torch.isfinite(g).all(), k
        _assert_scale_close(g.numpy(), t["want_leaves"][k], 5e-4, k)
    g = dict(zip(GRAD_LEAVES, got))
    if t["name"] in ("probe_sky", "interior"):
        assert float(g["mat_param"].abs().max()) > 0
    if t["name"] == "checker":
        # every texture row of the two checkers: odd and even children
        child = t["port"].tex_child[t["port"].tex_type == TEX_CHECKER].flatten()
        assert (g["tex_color"][child].abs().amax(dim=1) > 0).all()


@pytest.mark.parametrize("name,md", [("probe_sky", 6), ("probe_black", 6),
                                     ("checker", 6), ("interior", 4),
                                     ("probe_sky", 16)])
def test_k3_design_equals_autograd(name, md):
    """K3's algorithm (the tape with its checker, metal_ok and refract
    bits, stopped one bounce after a path dies; the reverse color, sky,
    material and geometric chains; winner-only routing), mirrored in torch,
    vs autograd through the twin at 2,048 lanes: each d_rec column and each
    of d_o, d_d within 1e-5 of its own scale. At these rays' seed no column
    cancels below its terms' size; at others a column that sums to ~1e-3 of
    its terms (a checker floor's C_KN x) leaves 2e-5 to f32 order, as
    autograd's own sum does against f64."""
    make, _, rays, _ = SCENES[name]
    port = make(SceneBuilder)
    o, d, u, ct = (_t(x) for x in rays(2048, md + 1, 3))
    cfg = tg.fast_grad_config(port)
    rec = tg.fast_grad_record(port).detach()
    want = tg.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, md)
    _, tape = tg.trace_tiles_plain(rec, o, d, u, cfg, md, tape=True)
    # the plain tape is the replaying K3's, bit for bit
    assert torch.equal(tape, _replay_tape(rec, o, d, u, cfg, md))
    got = _k3_mirror(rec, o, d, u, tape, ct, cfg, md)
    _assert_cols_close(got[0].numpy(), want[0].numpy(), 1e-5, "d_rec")
    for g, w, leaf in zip(got[1:], want[1:], ("d_o", "d_d")):
        if "sky" in cfg[1]:
            _assert_scale_close(g.numpy(), w.numpy(), 1e-5, leaf)
        else:
            assert not g.any() and not w.any()


@pytest.mark.parametrize("name", ["probe_sky", "interior"])
def test_plain_counts_of_draws(name):
    """The twin's counts that size the kernels' bytes: every lane runs
    bounce 0 and a lane runs bounce b + 1 iff it scattered at b; glass
    scatters read word 3 only where they can refract. On probe_scene the
    metal absorbs some paths and some rays meet total internal reflection
    inside the glass sphere; the interior rays, whose lines pass within
    0.7 of the centre, almost never do (sin θ < 1/1.5)."""
    make, md, rays, _ = SCENES[name]
    port = make(SceneBuilder)
    cfg = tg.fast_grad_config(port)
    rec = tg.fast_grad_record(port).detach()
    n = 2048
    o, d, u, _ = (_t(x) for x in rays(n, md + 1, 3))
    c = {}
    tg.trace_tiles_plain(rec, o, d, u, cfg, md, counts=c)
    assert c["segments"] == n + c["scatters"]
    assert 0 < c["u3_reads"] <= c["glass_scatters"] <= c["scatters"]
    if name == "interior":
        assert c["metal_absorbs"] == 0
    else:
        assert c["metal_absorbs"] > 0
        assert c["u3_reads"] < c["glass_scatters"]


def test_kernel_plumbing_matches_jax_interpret():
    """The JAX kernels themselves (`_make_traced`, interpret mode) on
    small_scene (every family, the sky) at depth 2 and 1,024 lanes vs the
    port's TraceFast on the CPU: primal within 1e-6, gradients within 5e-4
    of their scale."""
    ref = small_scene(JSceneBuilder)
    md = 2
    n = pg.BLOCK
    o, d, u, ct = _probe(n, md + 1, seed=8)
    kinds, feats = pg.fast_grad_config(ref)
    assert {"metal", "diel", "sky", "light"} <= feats
    traced = pg._make_traced(kinds, feats, md + 1, md, 1, True)
    rec = pg.fast_grad_record(ref)
    od = jnp.asarray(np.concatenate([o.T, d.T]).reshape(6, 1, pg.SUB,
                                                        pg.LANES))
    uu = jnp.asarray(u.reshape(md + 1, 4, 1, pg.SUB, pg.LANES))
    rad, vjp = jax.vjp(traced, rec, od, uu)
    d_rec, d_od, _ = vjp(jnp.asarray(ct.T.reshape(3, 1, pg.SUB, pg.LANES)))
    want = np.asarray(rad).reshape(3, n).T
    want_do = np.asarray(d_od).reshape(6, n)

    rec_t = _t(rec).requires_grad_(True)
    o_t, d_t = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    before = (tg.K2_LAUNCHES, tg.K3_LAUNCHES)
    got = tg.TraceFast.apply(rec_t, o_t, d_t, _t(u), (kinds, feats), md,
                             True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    got.backward(_t(ct))
    assert (tg.K2_LAUNCHES, tg.K3_LAUNCHES) == before  # the CPU launches none
    _assert_cols_close(rec_t.grad.numpy(), np.asarray(d_rec), 5e-4,
                       "d_rec")
    assert float(rec_t.grad[:, tg.C_PARAM].abs().max()) > 0
    _assert_scale_close(o_t.grad.numpy(), want_do[:3].T, 5e-4, "d_o")
    _assert_scale_close(d_t.grad.numpy(), want_do[3:].T, 5e-4, "d_d")
