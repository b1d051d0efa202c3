"""The port's fused differentiable tier (ops/grad.py) and the inverse render
(inverse_render.py) against the JAX package, on the CPU.

The CUDA kernels K2/K3 run only on a card (tests/test_torch_kernel.py and
chip_smoke.py hold them against the plain version there). Here the plain
version, `trace_tiles_plain`, and torch autograd through it are held
against the JAX `_trace_tiles` and `jax.vjp` on identical numpy-seeded
(rec, o, d, u, ct); the kernel plumbing against the JAX `_make_traced` in
interpret mode; and the trainer's step against `jax.value_and_grad` of the
same loss. Tolerances are stated per test.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu.ops import camera as jcam
from raytracing_rust_tpu.ops import pallas_grad as pg
from raytracing_rust_tpu_torch import inverse_render as ir
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    SceneBuilder, SceneTables)
from raytracing_rust_tpu_torch.ops import grad as tg
from raytracing_rust_tpu_torch.ops import rng
from raytracing_rust_tpu_torch.ops.tracer import UnsupportedScene
from raytracing_rust_tpu_torch.render import camera_lane_rays

GRAD_LEAVES = ("prim_data", "mat_param", "tex_color", "xf_offset",
               "xf_sin", "xf_cos")


def _jax_example():
    """examples/inverse_render.py, the JAX script."""
    os.environ["RT_IR_TPU"] = "1"  # stop the example's import-time CPU pin
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    import examples.inverse_render as ex
    return ex


def _jax_inverse_scene(albedo=ir.TRUE_ALBEDO, emit=ir.TRUE_EMIT):
    return _jax_example().build_scene(albedo, emit)


def _jax_geo_scene(albedo=ir.TRUE_GEO_ALBEDO, emit=ir.TRUE_GEO_EMIT,
                   tilt_deg=ir.TRUE_TILT_DEG):
    return _jax_example().build_geo_scene(albedo, emit, tilt_deg)


def _sphere_scene(builder_cls, background=BG_BLACK):
    """Lambertian + light with spheres (one of them a light), a flipped
    rect and a rotated-translated cube."""
    b = builder_cls(background=background)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.73, 0.73, 0.73)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.lambertian(b.solid(0.8, 0.7, 0.6)))
    b.sphere((-1.5, 3.5, 0.0), 0.5, b.diffuse_light(b.solid(3.0, 2.0, 1.0)))
    xf = b.transform(offset=(0.4, 0.0, 0.2), rotate_axis="y", angle_deg=20.0)
    b.cube((-2.4, 0.0, -1.4), (-1.4, 1.6, -0.4),
           b.lambertian(b.solid(0.4, 0.6, 0.3)), xform=xf)
    return b.build()


# the scenes the fused tier is held on: the two inverse renders', and the
# sphere scene under the black background and under the sky
SCENES = ["inverse_render", "spheres", "geometry", "spheres_sky"]


def _scenes(name):
    if name == "inverse_render":
        return ir.build_scene(ir.TRUE_ALBEDO), _jax_inverse_scene(ir.TRUE_ALBEDO)
    if name == "geometry":
        return (ir.build_geo_scene(ir.TRUE_GEO_ALBEDO, ir.TRUE_GEO_EMIT,
                                   ir.TRUE_TILT_DEG), _jax_geo_scene())
    bg = BG_SKY if name == "spheres_sky" else BG_BLACK
    return _sphere_scene(SceneBuilder, bg), _sphere_scene(JSceneBuilder, bg)


def _probe(n, n_bounce, seed):
    """Rays from (0, 2, 8) into the scenes, draws and a cotangent."""
    r = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, 2.0, 8.0], np.float32), (n, 1))
    d = np.stack([r.uniform(-0.7, 0.7, n), r.uniform(-0.45, 0.25, n),
                  -np.ones(n)], -1).astype(np.float32)
    u = r.random((n_bounce, 4, n), dtype=np.float32)
    ct = r.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    return o, d, u, ct


def _jax_trace(rec, o, d, u, cfg, max_depth):
    """The JAX `_trace_tiles` on flat lanes with the draws given."""
    kinds, feats = cfg
    n_bounce = u.shape[0]
    scal = [[rec[p, c] for c in range(pg.REC_C)] for p in range(len(kinds))]
    ul = [[jnp.asarray(u[b, c]) for c in range(4)] for b in range(n_bounce)]
    rr = pg._trace_tiles(scal, tuple(o[:, i] for i in range(3)),
                         tuple(d[:, i] for i in range(3)), ul, kinds, feats,
                         n_bounce, max_depth)
    return jnp.stack(rr, axis=1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_scale_close(got, want, atol_scale, what):
    """|got − want| ≤ atol_scale · max(max|want|, 1e-3): the scale-relative
    tolerance of tests/test_pallas_grad.py."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_scale * scale,
                               err_msg=what)


def _assert_cols_close(got, want, atol_scale, what):
    """Column by column (the last axis): |got − want| ≤ atol_scale · the
    column's max|want|; a column that is exactly zero in want is exactly
    zero in got. One column's scale cannot hide another's error (the ground
    sphere's C_INVR cotangent is ~1e4 where the cube's C_KOFF is ~1e-3)."""
    got, want = np.asarray(got), np.asarray(want)
    g2 = got.reshape(-1, got.shape[-1])
    w2 = want.reshape(-1, want.shape[-1])
    for c in range(w2.shape[1]):
        scale = np.abs(w2[:, c]).max()
        if scale == 0:
            assert not g2[:, c].any(), f"{what}: column {c} is not zero"
        else:
            np.testing.assert_allclose(g2[:, c], w2[:, c], rtol=0,
                                       atol=atol_scale * scale,
                                       err_msg=f"{what}: column {c}")


@pytest.mark.parametrize("name", SCENES)
def test_fast_grad_record_equals_jax(name):
    """Bit-equal: the same pack_prims arithmetic on the same tables."""
    port, ref = _scenes(name)
    got = tg.fast_grad_record(port).numpy()
    want = np.asarray(pg.fast_grad_record(ref))
    assert got.shape == want.shape == (port.num_prims, tg.REC_C)
    np.testing.assert_array_equal(got, want)
    assert tg.fast_grad_config(port) == pg.fast_grad_config(ref)


def test_inverse_render_scene_and_rows_equal_jax():
    port = ir.build_scene((0.5, 0.5, 0.5), 3.0)
    ref = jax.device_get(_jax_inverse_scene((0.5, 0.5, 0.5), 3.0))
    for f in dataclasses.fields(SceneTables):
        got = getattr(port, f.name)
        want = getattr(ref, f.name)
        if f.metadata.get("static"):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    from examples.inverse_render import param_tex_rows
    assert ir.param_tex_rows(port) == param_tex_rows(ref)


@pytest.fixture(scope="module", params=SCENES)
def twin_vs_jax(request):
    """1,024 lanes at depth 6: the twin's primal and vjp, and JAX's."""
    port, ref = _scenes(request.param)
    md = 6
    o, d, u, ct = _probe(1024, md + 1, seed=3)
    cfg = pg.fast_grad_config(ref)
    rec = np.asarray(pg.fast_grad_record(ref))
    want, vjp = jax.vjp(lambda r, o_, d_: _jax_trace(r, o_, d_, u, cfg, md),
                        jnp.asarray(rec), jnp.asarray(o), jnp.asarray(d))
    want_g = vjp(jnp.asarray(ct))
    got = tg.trace_tiles_plain(_t(rec), _t(o), _t(d), _t(u), cfg, md)
    got_g = tg.trace_tiles_plain_vjp(_t(rec), _t(o), _t(d), _t(u), _t(ct),
                                     cfg, md)
    return (got, np.asarray(want), got_g, [np.asarray(g) for g in want_g],
            "sky" in cfg[1])


def test_twin_primal_equals_jax(twin_vs_jax):
    """Op for op in the JAX order: within 1e-6 (2 ulp at the radiance's
    scale; exp, log, sin and cos may round differently in XLA and torch)."""
    got, want, _, _, _ = twin_vs_jax
    assert got.shape == (1024, 3) and float(got.sum()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i,leaf", [(0, "d_rec"), (1, "d_o"), (2, "d_d")])
def test_twin_vjp_equals_jax_vjp(twin_vs_jax, i, leaf):
    """Torch autograd through the twin vs jax.vjp under the same ct, each
    d_rec column and each of d_o, d_d within 5e-4 of its own scale
    (tests/test_pallas_grad.py's tolerance), the same columns live. Under
    the black background only the light and albedo columns carry gradient
    and o, d get exact zeros from both; under the sky the radiance moves
    with every miss direction, and the geometric chain is live."""
    _, _, got_g, want_g, sky = twin_vs_jax
    got = got_g[i].numpy()
    assert np.isfinite(got).all() and np.isfinite(want_g[i]).all()
    if i == 0:
        _assert_cols_close(got, want_g[0], 5e-4, leaf)
        live = set(np.nonzero(np.abs(want_g[0]).max(axis=0))[0].tolist())
        assert set(np.nonzero(np.abs(got).max(axis=0))[0].tolist()) == live
        color = {tg.C_LIGHT, tg.C_TEX_E, tg.C_TEX_E + 1, tg.C_TEX_E + 2}
        assert tg.C_TEX_E in live
        if sky:
            # the comparisons' columns carry nothing; the geometry's do
            assert not live & {tg.C_IS_SPHERE, tg.C_AN, tg.C_BN, tg.C_AOFF,
                               tg.C_A0, tg.C_B1}
            assert {tg.C_KN, tg.C_KOFF, tg.C_FLIP} <= live
        else:
            assert live <= color
    elif sky:
        _assert_scale_close(got, want_g[i], 5e-4, leaf)
        assert np.abs(got).max() > 0
    else:
        assert not np.abs(got).any()


def _leaves(scene: SceneTables) -> SceneTables:
    return dataclasses.replace(scene, **{
        k: getattr(scene, k).clone().requires_grad_(True)
        for k in GRAD_LEAVES})


def test_scene_leaf_grads_equal_jax():
    """d loss / d scene leaf through trace_fast (TraceFast's CPU backward)
    vs jax.grad through fast_grad_record + _trace_tiles, on the sphere
    scene at 1,024 lanes and depth 4, within 5e-4 of each leaf's scale."""
    port, ref = _scenes("spheres")
    md = 4
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
    for k, g in zip(GRAD_LEAVES, got):
        g = torch.zeros_like(getattr(port, k)) if g is None else g
        _assert_scale_close(g.numpy(), getattr(want, k), 5e-4, k)
    assert float(got[GRAD_LEAVES.index("tex_color")].abs().sum()) > 0


def test_kernel_plumbing_matches_jax_interpret():
    """The JAX kernels themselves (`_make_traced`, interpret mode) on a
    4-prim scene at depth 3 and 1,024 lanes vs the port's TraceFast on the
    CPU: primal within 1e-6, gradients within 5e-4 of their scale."""
    b = JSceneBuilder(background=BG_BLACK)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.lambertian(b.solid(0.8, 0.7, 0.6)))
    b.rect("yz", 0, -3, 6, 3, -3.0, b.lambertian(b.solid(0.65, 0.05, 0.05)))
    ref = b.build()
    md = 3
    n = pg.BLOCK
    o, d, u, ct = _probe(n, md + 1, seed=8)
    kinds, feats = pg.fast_grad_config(ref)
    traced = pg._make_traced(kinds, feats, md + 1, md, 1, True)
    rec = pg.fast_grad_record(ref)
    od = jnp.asarray(np.concatenate([o.T, d.T]).reshape(6, 1, pg.SUB,
                                                        pg.LANES))
    uu = jnp.asarray(u.reshape(md + 1, 4, 1, pg.SUB, pg.LANES))
    rad, vjp = jax.vjp(traced, rec, od, uu)
    ct_t = jnp.asarray(ct.T.reshape(3, 1, pg.SUB, pg.LANES))
    d_rec, d_od, _ = vjp(ct_t)
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
    _assert_scale_close(rec_t.grad.numpy(), d_rec, 5e-4, "d_rec")
    _assert_scale_close(o_t.grad.numpy(), want_do[:3].T, 5e-4, "d_o")
    _assert_scale_close(d_t.grad.numpy(), want_do[3:].T, 5e-4, "d_d")


def _replay_tape(rec, o, d, u, cfg, max_depth):
    """The winner tape as the replaying K3 of csrc/grad.cu before the tape
    recomputed it: the twin's trace one bounce at a time from its own
    state, each prim's hit test (`_prim_t`) for the winner, its root and t,
    the bits a bounce's scatter sets (a metal's metal_ok, a glass's
    refract, on a bounce that tried to scatter: alive, a hit, not a light,
    not the last), the checker's odd pick, stopped one bounce after a path
    dies (the ghost entry, which tries no scatter) → i32[n_bounce, 2, N],
    TAPE_NONE and 0 past each lane's last entry."""
    has_light = "light" in cfg[1]
    has_metal = "metal" in cfg[1]
    has_diel = "diel" in cfg[1]
    has_checker = "checker" in cfg[1]
    n, n_bounce = o.shape[0], u.shape[0]
    no = torch.zeros(n, dtype=torch.bool)
    o, d = o.clone(), d.clone()
    alive = torch.ones(n)
    stopped = torch.zeros(n, dtype=torch.bool)
    rows = []
    for b in range(n_bounce):
        ghost = alive == 0
        t_best = torch.full((n,), tg.BIG)
        win = torch.full((n,), -1, dtype=torch.int64)
        far = torch.zeros(n, dtype=torch.bool)
        a_dd = (d * d).sum(dim=1)
        for p, kind in enumerate(cfg[0]):
            t_p, far_p = _prim_t(rec[p], kind, *o.unbind(1), *d.unbind(1),
                                 a_dd)
            better = t_p < t_best
            t_best = torch.where(better, t_p, t_best)
            win = torch.where(better, p, win)
            far = torch.where(better, far_p, far)
        hit = win >= 0
        w = rec[win.clamp(min=0)]
        t = torch.where(hit, t_best, 0.0)[:, None]
        pt = o + t * d
        odd = _use_odd(w, pt) & hit if has_checker else no
        nrm = _normal(w, pt)
        nd, mok, take = _scatter(w, d, nrm, _ball(u[b]), u[b, 3], cfg)
        is_metal = hit & (w[:, tg.C_METAL] > 0.5) if has_metal else no
        is_diel = hit & (w[:, tg.C_DIEL] > 0.5) if has_diel else no
        light = (w[:, tg.C_LIGHT] > 0.5) & hit if has_light else no
        tried = hit & ~ghost & ~light & (b != max_depth)
        code = ((win << tg.TAPE_SHIFT) | far.long() * tg.TAPE_FAR
                | odd.long() * tg.TAPE_ODD
                | (tried & is_metal & mok).long() * tg.TAPE_METAL_OK
                | (tried & is_diel & take).long() * tg.TAPE_REFRACT)
        on = ~stopped & (b <= max_depth)
        code = torch.where(on, torch.where(hit, code, -1), tg.TAPE_NONE)
        tt = torch.where(on, t_best, 0.0).contiguous()
        rows.append(torch.stack([code.to(torch.int32),
                                 tt.view(torch.int32)]))
        stopped = stopped | ghost | (b == max_depth)
        ok = torch.where(is_metal, mok.float(), 1.0)
        if has_light:
            ok = ok * (1.0 - w[:, tg.C_LIGHT])
        keep = (torch.where(hit, alive * ok, 0.0) > 0.5)[:, None]
        o = torch.where(keep, pt, o)
        d = torch.where(keep, nd, d)
        alive = torch.where(hit, alive * ok, 0.0)
    return torch.stack(rows)


def _k3_mirror(rec, o, d, u, tape, ct, cfg, max_depth):
    """csrc/grad.cu K3 in vectorized torch, lane for lane: the forward
    rebuilt from K2's winner tape (`trace_tiles_plain(..., tape=True)`: per
    bounce the winner, its root, t, the checker's odd pick, metal_ok and
    the glass's refract choice; no hit test), keeping the state before each
    bounce (throughput, alive, o, d) up to the ghost entry one bounce after
    a path dies; the reverse sweep carries the cotangents of (o, d,
    throughput, alive) back through the color chain, the sky, the
    materials' scatter (lambertian, metal with fuzz, glass refract or
    reflect; comparisons carry nothing), the normal × flip, the hit point
    and the winner's t, each bounce adding into its winner's row.
    Returns (d_rec, d_o, d_d)."""
    has_light = "light" in cfg[1]
    has_sky = "sky" in cfg[1]
    has_metal = "metal" in cfg[1]
    has_diel = "diel" in cfg[1]
    n, n_bounce = o.shape[0], u.shape[0]
    P = rec.shape[0]
    sky = torch.tensor([0.5, 0.7, 1.0])
    no = torch.zeros(n, dtype=torch.bool)
    codes = tape[:, 0].long()
    t_all = tape[:, 1].contiguous().view(torch.float32)
    # the rebuild: the state before each bounce, from the tape's winners
    steps = []
    o, d = o.clone(), d.clone()
    thr = torch.ones(n, 3)
    alive = torch.ones(n)
    for b in range(n_bounce):
        code, t_best = codes[b], t_all[b]
        on = code != tg.TAPE_NONE
        hit = code >= 0
        win = torch.where(hit, code >> tg.TAPE_SHIFT, -1)
        far = hit & ((code & tg.TAPE_FAR) != 0)
        odd = hit & ((code & tg.TAPE_ODD) != 0)
        mok = hit & ((code & tg.TAPE_METAL_OK) != 0)
        take = hit & ((code & tg.TAPE_REFRACT) != 0)
        steps.append((win, far, odd, mok, take, thr, alive, o, d, t_best,
                      on))
        if b == max_depth:
            break
        w = rec[win.clamp(min=0)]
        t = torch.where(hit, t_best, 0.0)[:, None]
        pt = o + t * d
        nd, _, _ = _scatter(w, d, _normal(w, pt), _ball(u[b]), u[b, 3], cfg)
        is_metal = hit & (w[:, tg.C_METAL] > 0.5) if has_metal else no
        is_diel = hit & (w[:, tg.C_DIEL] > 0.5) if has_diel else no
        ok = torch.where(is_metal, mok.float(), 1.0)
        if has_light:
            ok = ok * (1.0 - w[:, tg.C_LIGHT])
        cont = torch.where(hit, alive * ok, 0.0)
        keep = (cont > 0.5)[:, None]
        at = torch.where(is_diel[:, None], 1.0, _albedo(w, odd))
        thr = torch.where(keep, thr * at, thr)
        o = torch.where(keep, pt, o)
        d = torch.where(keep, nd, d)
        alive = cont

    d_rec = torch.zeros(P, tg.REC_C)
    g_o, g_d, g_thr = torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n, 3)
    g_alive = torch.zeros(n)
    for b in range(len(steps) - 1, -1, -1):
        win, far, odd, mok, take, thr_b, alive_b, o_b, d_b, t_b, on = steps[b]
        hit = (win >= 0) & on
        hitf = hit.float()
        w = rec[win.clamp(min=0)]
        sph = hit & (w[:, tg.C_IS_SPHERE] > 0.5)
        rect = hit & ~sph
        is_metal = hit & (w[:, tg.C_METAL] > 0.5) if has_metal else no
        is_diel = hit & (w[:, tg.C_DIEL] > 0.5) if has_diel else no
        al = torch.where(hit[:, None], _albedo(w, odd), 0.0)
        wl = (torch.where(hit, w[:, tg.C_LIGHT], 0.0) if has_light
              else torch.zeros(n))
        gain = alive_b * hitf
        t = torch.where(hit, t_b, 0.0)
        pt = o_b + t[:, None] * d_b
        nrm = _normal(w, pt)
        # the state's cotangents before this bounce, from those after it
        g_p = torch.zeros(n, 3)
        g_n = torch.zeros(n, 3)
        g_al = torch.zeros(n, 3)
        g_par = torch.zeros(n)
        g_wl = torch.zeros(n)
        g_gain = torch.zeros(n)
        n_o = torch.zeros(n, 3)
        n_d = torch.zeros(n, 3)
        n_thr = torch.zeros(n, 3)
        a_dd = (d_b * d_b).sum(dim=1)
        inv_len = torch.rsqrt(a_dd)
        if b < max_depth:
            # o' = keep ? p : o;  d' = keep ? scatter : d;
            # thr' = keep ? thr · (glass ? 1 : albedo) : thr;
            # alive' = cont = gain · ok_mat · (1 − light)
            ok_mat = torch.where(is_metal, mok.float(), 1.0)
            ok = ok_mat * (1.0 - wl)
            keep = ((gain * ok) > 0.5)[:, None]
            at = torch.where(is_diel[:, None], 1.0, al)
            g_p = torch.where(keep, g_o, 0.0)
            g_nd = torch.where(keep, g_d, 0.0)
            n_o = torch.where(keep, 0.0, g_o)
            n_d = torch.where(keep, 0.0, g_d)
            n_thr = torch.where(keep, g_thr * at, g_thr)
            g_al = torch.where(keep & ~is_diel[:, None], g_thr * thr_b, 0.0)
            g_gain = g_alive * ok
            if has_light:
                g_wl = -(g_alive * gain) * ok_mat
            # the scatter direction: lambertian n + ball
            lamb = (~is_metal & ~is_diel)[:, None]
            g_n = torch.where(lamb, g_nd, 0.0)
            g_u = torch.zeros(n, 3)
            u_b = d_b * inv_len[:, None]
            if has_metal:
                # rf = u − 2(u·n)n + fuzz · ball
                gm = torch.where(is_metal[:, None], g_nd, 0.0)
                g_par = g_par + (gm * _ball(u[b])).sum(dim=1)
                gdn = (gm * nrm).sum(dim=1)[:, None]
                udn = (u_b * nrm).sum(dim=1)[:, None]
                g_u = g_u + gm - 2.0 * gdn * nrm
                g_n = g_n - 2.0 * (udn * gm + gdn * u_b)
            if has_diel:
                ddn = (d_b * nrm).sum(dim=1)[:, None]
                # reflect of the unnormalised d: d − 2(d·n)n
                gr = torch.where((is_diel & ~take)[:, None], g_nd, 0.0)
                grn = (gr * nrm).sum(dim=1)[:, None]
                n_d = n_d + gr - 2.0 * grn * nrm
                g_n = g_n - 2.0 * (ddn * gr + grn * d_b)
                # refract: ni (u − on·uvdt) − on · √disc, on = sgn · n,
                # disc = 1 − ni²(1 − uvdt²), uvdt = u·on,
                # ni = exiting ? ref_idx : 1/ref_idx
                g = torch.where((is_diel & take)[:, None], g_nd, 0.0)
                ref_idx = torch.where(is_diel, w[:, tg.C_PARAM], 1.0)
                exiting = ddn[:, 0] > 0.0
                sgn = torch.where(exiting, -1.0, 1.0)[:, None]
                onv = sgn * nrm
                ni = torch.where(exiting, ref_idx, 1.0 / ref_idx)[:, None]
                uvdt = (u_b * onv).sum(dim=1)[:, None]
                disc = 1.0 - ni * ni * (1.0 - uvdt * uvdt)
                sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
                v = u_b - onv * uvdt
                g_ni = (g * v).sum(dim=1)[:, None]
                g_v = ni * g
                g_on = -g * sq - g_v * uvdt
                g_disc = -(g * onv).sum(dim=1)[:, None] * 0.5 / sq
                g_ni = g_ni - g_disc * 2.0 * ni * (1.0 - uvdt * uvdt)
                g_uvdt = (-(g_v * onv).sum(dim=1)[:, None]
                          + g_disc * (ni * ni) * 2.0 * uvdt)
                g_u = g_u + g_v + g_uvdt * onv
                g_on = g_on + g_uvdt * u_b
                g_n = g_n + sgn * g_on
                g_par = g_par + torch.where(
                    exiting, g_ni[:, 0], -g_ni[:, 0] / (ref_idx * ref_idx))
            # u = d · rsqrt(d·d)
            n_d = (n_d + inv_len[:, None] * g_u
                   - (inv_len ** 3 * (g_u * d_b).sum(dim=1))[:, None] * d_b)
        if has_light:
            # rad += (gl · thr) · albedo, gl = gain · light
            gl = gain * wl
            a = ct * al
            n_thr = n_thr + a * gl[:, None]
            g_al = g_al + ct * (gl[:, None] * thr_b)
            g_gl = (a * thr_b).sum(dim=1)
            g_gain = g_gain + g_gl * wl
            g_wl = g_wl + g_gl * gain
        n_alive = g_gain * hitf
        g_a_dd = torch.zeros(n)
        if has_sky:
            # rad += (miss · thr) · bg, bg = (1 − tt) + tt · sky,
            # tt = 0.5 (dy · rsqrt(a_dd) + 1), miss = alive · (1 − hit)
            miss = torch.where(on, alive_b * (1.0 - hitf), 0.0)
            tt = 0.5 * (d_b[:, 1] * inv_len + 1.0)
            bg = (1.0 - tt)[:, None] + tt[:, None] * sky
            g_mt = ct * bg
            n_thr = n_thr + g_mt * miss[:, None]
            n_alive = n_alive + (g_mt * thr_b).sum(dim=1) * (1.0 - hitf)
            g_tt = 0.5 * ((miss[:, None] * thr_b) * ct * (sky - 1.0)).sum(dim=1)
            n_d[:, 1] = n_d[:, 1] + g_tt * inv_len
            g_inv = g_tt * d_b[:, 1]
            g_a_dd = g_a_dd + g_inv * (-0.5 * inv_len * inv_len * inv_len)
        # n = (sphere: (p − c) · invr; rect: kn) · flip
        c = w[:, tg.C_CX:tg.C_CX + 3]
        kn = w[:, tg.C_KN:tg.C_KN + 3]
        flip = w[:, tg.C_FLIP:tg.C_FLIP + 1]
        invr = w[:, tg.C_INVR:tg.C_INVR + 1]
        q = pt - c
        g_m = g_n * flip
        g_flip = (g_n * torch.where(sph[:, None], q * invr, kn)).sum(dim=1)
        g_invr = torch.where(sph, (g_m * q).sum(dim=1), 0.0)
        g_q = torch.where(sph[:, None], g_m * invr, 0.0)
        g_p = g_p + g_q
        g_c = -g_q
        g_kn = torch.where(rect[:, None], g_m, 0.0)
        # p = o + t · d (t = 0 on a miss)
        n_o = n_o + g_p
        n_d = n_d + t[:, None] * g_p
        g_t = torch.where(hit, (g_p * d_b).sum(dim=1), 0.0)
        # t: the winner's candidate (rect) t = (koff − o·kn) / (d·kn)
        d_kn = (d_b * kn).sum(dim=1)
        g_num = torch.where(rect, g_t / d_kn, 0.0)
        g_den = torch.where(rect, -(g_num * t), 0.0)
        g_koff = g_num
        n_o = n_o - g_num[:, None] * kn
        n_d = n_d + g_den[:, None] * kn
        g_kn = g_kn - g_num[:, None] * o_b + g_den[:, None] * d_b
        # (sphere) t = (−bq ∓ sq) · inv_a, sq = √(bq² − a_dd · cc),
        # bq = oc·d, cc = oc·oc − r2, oc = o − c, inv_a = 1 / a_dd
        oc = o_b - c
        inv_a = 1.0 / a_dd
        bq = (oc * d_b).sum(dim=1)
        cc = (oc * oc).sum(dim=1) - w[:, tg.C_R2]
        sq = torch.sqrt(torch.where(sph, bq * bq - a_dd * cc, 1.0))
        sgn = torch.where(far, 1.0, -1.0)
        g_ts = torch.where(sph, g_t, 0.0)
        g_inv_a = g_ts * (-bq + sgn * sq)
        g_sq = sgn * (g_ts * inv_a)
        g_disc = g_sq * 0.5 / sq
        g_bq = -(g_ts * inv_a) + 2.0 * bq * g_disc
        g_cc = -(a_dd * g_disc)
        g_a_dd = g_a_dd + torch.where(sph, -(cc * g_disc)
                                      - g_inv_a * inv_a * inv_a, 0.0)
        g_oc = g_bq[:, None] * d_b + 2.0 * g_cc[:, None] * oc
        n_d = n_d + torch.where(sph[:, None], g_bq[:, None] * oc, 0.0)
        n_o = n_o + torch.where(sph[:, None], g_oc, 0.0)
        g_c = g_c - torch.where(sph[:, None], g_oc, 0.0)
        g_r2 = torch.where(sph, -g_cc, 0.0)
        n_d = n_d + 2.0 * g_a_dd[:, None] * d_b

        g_o = torch.where(on[:, None], n_o, 0.0)
        g_d = torch.where(on[:, None], n_d, 0.0)
        g_thr = torch.where(on[:, None], n_thr, 0.0)
        g_alive = torch.where(on, n_alive, 0.0)
        rows = win[hit]
        cols = {tg.C_LIGHT: g_wl, tg.C_FLIP: g_flip, tg.C_INVR: g_invr,
                tg.C_R2: g_r2, tg.C_KOFF: g_koff, tg.C_PARAM: g_par}
        for a in range(3):
            cols[tg.C_TEX_E + a] = torch.where(odd, 0.0, g_al[:, a])
            cols[tg.C_TEX_O + a] = torch.where(odd, g_al[:, a], 0.0)
            cols[tg.C_CX + a] = g_c[:, a]
            cols[tg.C_KN + a] = g_kn[:, a]
        for col, g in cols.items():
            d_rec[:, col].index_add_(0, rows, g[hit])
    return d_rec, g_o, g_d


def _use_odd(w, pt):
    """A checker winner's odd pick at hit points pt [N, 3]: the twin's
    sines."""
    px, py, pz = pt.unbind(1)
    sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
             * torch.sin(10.0 * pz))
    return (w[:, tg.C_CHK] > 0.5) & (sines < 0.0)


def _albedo(w, odd):
    return torch.where(odd[:, None], w[:, tg.C_TEX_O:tg.C_TEX_O + 3],
                       w[:, tg.C_TEX_E:tg.C_TEX_E + 3])


def _ball(ub):
    """The unit-ball point of draws ub [4, N] (words 0-2), the twin's."""
    cos_t = 2.0 * ub[0] - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = rng.TWO_PI * ub[1]
    rr3 = torch.exp(torch.log(1.0 - ub[2]) * rng.ONE_THIRD)
    return torch.stack([rr3 * sin_t * torch.cos(phi),
                        rr3 * sin_t * torch.sin(phi), rr3 * cos_t], 1)


def _scatter(w, d, nrm, ss, u3, cfg):
    """The winner's scatter direction, the twin's arithmetic per component
    → (direction [N, 3], metal_ok, take_refract)."""
    dx, dy, dz = d.unbind(1)
    nx, ny, nz = nrm.unbind(1)
    sx, sy, sz = ss.unbind(1)
    nd = [nx + sx, ny + sy, nz + sz]
    a_dd = dx * dx + dy * dy + dz * dz
    inv_len = torch.rsqrt(a_dd)
    ux, uy, uz = dx * inv_len, dy * inv_len, dz * inv_len
    par = w[:, tg.C_PARAM]
    mok = take = torch.zeros_like(dx, dtype=torch.bool)
    if "metal" in cfg[1]:
        udn = ux * nx + uy * ny + uz * nz
        rf = [ux - 2.0 * udn * nx + par * sx, uy - 2.0 * udn * ny + par * sy,
              uz - 2.0 * udn * nz + par * sz]
        mok = rf[0] * nx + rf[1] * ny + rf[2] * nz > 0.0
        is_metal = w[:, tg.C_METAL] > 0.5
        nd = [torch.where(is_metal, a, b) for a, b in zip(rf, nd)]
    if "diel" in cfg[1]:
        is_diel = w[:, tg.C_DIEL] > 0.5
        one = torch.ones(())
        ref_idx = torch.where(is_diel, par, one)
        ddn = dx * nx + dy * ny + dz * nz
        d_len = torch.sqrt(a_dd)
        exiting = ddn > 0.0
        sgn = torch.where(exiting, -one, one)
        onx, ony, onz = sgn * nx, sgn * ny, sgn * nz
        ni = torch.where(exiting, ref_idx, one / ref_idx)
        cosine = torch.where(exiting, ref_idx * ddn / d_len, -ddn / d_len)
        uvdt = ux * onx + uy * ony + uz * onz
        disc = 1.0 - ni * ni * (1.0 - uvdt * uvdt)
        can = disc > 0.0
        sq = torch.sqrt(torch.where(can, disc, one))
        ref = [ni * (ux - onx * uvdt) - onx * sq,
               ni * (uy - ony * uvdt) - ony * sq,
               ni * (uz - onz * uvdt) - onz * sq]
        qq = (1.0 - ref_idx) / (1.0 + ref_idx)
        one_mc = 1.0 - cosine
        x2 = one_mc * one_mc
        schlick = qq * qq + (1.0 - qq * qq) * (one_mc * (x2 * x2))
        take = can & (u3 >= torch.where(can, schlick, one))
        pr = [dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny, dz - 2.0 * ddn * nz]
        nd = [torch.where(is_diel, torch.where(take, a, b), c)
              for a, b, c in zip(ref, pr, nd)]
    return torch.stack(nd, 1), mok, take


def _normal(w, pt):
    """The winner's normal × flip at hit points pt [N, 3] (rows w [N, 35])."""
    sph = (w[:, tg.C_IS_SPHERE] > 0.5)[:, None]
    q = (pt - w[:, tg.C_CX:tg.C_CX + 3]) * w[:, tg.C_INVR:tg.C_INVR + 1]
    return (torch.where(sph, q, w[:, tg.C_KN:tg.C_KN + 3])
            * w[:, tg.C_FLIP:tg.C_FLIP + 1])


def _prim_t(r, kind, ox, oy, oz, dx, dy, dz, a_dd):
    """One prim's hit distance, the twin's (and the kernel's) arithmetic,
    and whether a sphere's far root was taken."""
    one = torch.ones(())
    if kind == "s":
        ocx, ocy, ocz = ox - r[tg.C_CX], oy - r[tg.C_CY], oz - r[tg.C_CZ]
        bq = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r[tg.C_R2]
        disc = bq * bq - a_dd * cc
        pos = disc > 0.0
        sq = torch.sqrt(torch.where(pos, disc, one))
        inv_a = one / a_dd
        t_near, t_far = (-bq - sq) * inv_a, (-bq + sq) * inv_a
        near = pos & (t_near > tg.T_MIN) & (t_near < tg.BIG)
        far = pos & (t_far > tg.T_MIN) & (t_far < tg.BIG)
        return (torch.where(near, t_near, torch.where(far, t_far, tg.BIG)),
                ~near & far)
    kn = r[tg.C_KN:tg.C_KN + 3]
    an, bn = r[tg.C_AN:tg.C_AN + 3], r[tg.C_BN:tg.C_BN + 3]
    o_kn = ox * kn[0] + oy * kn[1] + oz * kn[2]
    d_kn = dx * kn[0] + dy * kn[1] + dz * kn[2]
    par = d_kn == 0.0
    t_r = (r[tg.C_KOFF] - o_kn) / torch.where(par, one, d_kn)
    xx = (ox * an[0] + oy * an[1] + oz * an[2]
          + t_r * (dx * an[0] + dy * an[1] + dz * an[2]) - r[tg.C_AOFF])
    yy = (ox * bn[0] + oy * bn[1] + oz * bn[2]
          + t_r * (dx * bn[0] + dy * bn[1] + dz * bn[2]) - r[tg.C_BOFF])
    ok = ((~par) & (t_r > tg.T_MIN) & (t_r < tg.BIG) & (xx >= r[tg.C_A0])
          & (xx <= r[tg.C_A1]) & (yy >= r[tg.C_B0]) & (yy <= r[tg.C_B1]))
    return torch.where(ok, t_r, tg.BIG), torch.zeros_like(ok)


@pytest.mark.parametrize("name", SCENES)
def test_k3_design_equals_autograd(name):
    """K3's algorithm (the state rebuilt from the plain winner tape up to
    the ghost entry one bounce after a path dies, no hit test; the reverse
    color, sky and geometric chains, winner-only routing), mirrored in
    torch, vs autograd through the twin: each d_rec column and each of d_o,
    d_d within 1e-5 of its own scale (sums in another order). Pins the
    design before the card runs it."""
    port, _ = _scenes(name)
    md = 6
    o, d, u, ct = (_t(x) for x in _probe(2048, md + 1, seed=11))
    cfg = tg.fast_grad_config(port)
    rec = tg.fast_grad_record(port).detach()
    want = tg.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, md)
    _, tape = tg.trace_tiles_plain(rec, o, d, u, cfg, md, tape=True)
    got = _k3_mirror(rec, o, d, u, tape, ct, cfg, md)
    _assert_cols_close(got[0].numpy(), want[0].numpy(), 1e-5, "d_rec")
    for g, w, leaf in zip(got[1:], want[1:], ("d_o", "d_d")):
        if "sky" in cfg[1]:
            _assert_scale_close(g.numpy(), w.numpy(), 1e-5, leaf)
        else:
            assert not g.any() and not w.any()


@pytest.mark.parametrize("name,md,n_bounce", [
    *((name, 6, 7) for name in SCENES), ("spheres_sky", 16, 17),
    ("inverse_render", 2, 3), ("geometry", 6, 4)])
def test_plain_tape_equals_replay(name, md, n_bounce):
    """The plain winner tape, bit for bit, against the winners, roots, t
    and bits that the replaying K3 recomputed (`_replay_tape`: each prim's
    hit test on the twin's state), ghost entries included, TAPE_NONE past
    each lane's last entry; with fewer bounces than depth + 1 the tape ends
    with the draws. The tape leaves the radiance bit for bit as it was."""
    port, _ = _scenes(name)
    o, d, u, _ = (_t(x) for x in _probe(2048, n_bounce, seed=4))
    cfg = tg.fast_grad_config(port)
    rec = tg.fast_grad_record(port).detach()
    rad, tape = tg.trace_tiles_plain(rec, o, d, u, cfg, md, tape=True)
    assert tape.dtype == torch.int32 and tape.shape == (n_bounce, 2, 2048)
    assert torch.equal(rad, tg.trace_tiles_plain(rec, o, d, u, cfg, md))
    want = _replay_tape(rec, o, d, u, cfg, md)
    assert torch.equal(tape[:, 0], want[:, 0]), (
        f"codes differ at {int((tape[:, 0] != want[:, 0]).sum())} entries")
    assert torch.equal(tape[:, 1], want[:, 1])
    codes = tape[:, 0]
    # every lane has bounce 0; the counts size the tape's bytes in K2's and
    # K3's bounds: an entry a segment and a ghost
    assert bool((codes[0] != tg.TAPE_NONE).all())
    c = {}
    tg.trace_tiles_plain(rec, o, d, u, cfg, md, counts=c)
    assert int((codes != tg.TAPE_NONE).sum()) == c["segments"] + c["ghosts"]
    assert (c["ghosts"] > 0) == (n_bounce > 1)


def test_k3_source_runs_no_hit_test():
    """csrc/grad.cu: K3 (`grad_bwd` and what it calls) reads the winner
    tape and never calls `closest_hit`; K2 does."""
    import re
    src = open(os.path.join(os.path.dirname(tg.__file__), "..", "csrc",
                            "grad.cu")).read()
    bodies = {}
    for m in re.finditer(r"\n(?:template <bool MAT>\n)?__global__ void "
                         r"__launch_bounds__\(THREADS\)\n(\w+)\(", src):
        end = src.find("\n}\n", m.end())
        bodies[m.group(1)] = src[m.end():end]
    assert set(bodies) == {"grad_fwd", "grad_bwd"}
    assert "closest_hit" not in bodies["grad_bwd"]
    assert "tape[" in bodies["grad_bwd"]
    assert "trace_lane<MAT>" in bodies["grad_fwd"]
    lane = src[src.find("trace_lane("):src.find("\n}\n",
                                                 src.find("trace_lane("))]
    assert "closest_hit(" in lane


def test_only_a_gradient_trace_asks_for_the_tape(monkeypatch):
    """path_matched_loss traces the target under torch.no_grad (no tape)
    and the candidate with the parameters' gradient (the tape, which the
    backward reads); a trace of tensors that need no gradient asks for
    none either."""
    asked = []
    fwd = tg.grad_fwd

    def spy(*args, tape=False, **kw):
        asked.append(tape)
        return fwd(*args, tape=tape, **kw)
    monkeypatch.setattr(tg, "grad_fwd", spy)
    scene = ir.build_scene(ir.START_ALBEDO, ir.START_EMIT)
    target = ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT)
    light_tex, box_tex = ir.param_tex_rows(scene)
    cfg = tg.fast_grad_config(scene)
    o, d, u = ir.step_inputs(ir.camera(), 0, nx=16, ny=16, spp=2, block=8,
                             max_depth=3, device="cpu")
    albedo = torch.tensor(ir.START_ALBEDO, requires_grad=True)
    emit = torch.tensor(ir.START_EMIT, requires_grad=True)
    loss = ir.path_matched_loss(target, scene, light_tex, box_tex, albedo,
                                emit, o, d, u, block=8, spp=2, max_depth=3,
                                cfg=cfg)
    assert asked == [False, True]
    loss.backward()
    assert albedo.grad is not None and float(albedo.grad.abs().sum()) > 0
    asked.clear()
    tg.trace_fast(target, o, d, 0, max_depth=3, cfg=cfg, u=u)
    assert asked == [False]


@pytest.mark.parametrize("name", ["inverse_render", "spheres_sky"])
def test_wrappers_take_rows_and_the_tape(name):
    """grad_fwd and grad_bwd take o, d, ct f32[N, 3] as the caller holds
    them and give rad, d_o, d_d f32[N, 3] (contiguous) and d_rec f32[P,
    35]; grad_fwd(tape=True) gives the same rad and the tape that grad_bwd
    takes; on the CPU grad_bwd is autograd's with or without it."""
    port, _ = _scenes(name)
    o, d, u, ct = (_t(x) for x in _probe(256, 7, seed=9))
    cfg = tg.fast_grad_config(port)
    rec = tg.fast_grad_record(port).detach()
    rad = tg.grad_fwd(rec, o, d, u, cfg, 6)
    rad_t, tape = tg.grad_fwd(rec, o, d, u, cfg, 6, tape=True)
    assert rad.shape == (256, 3) and rad.is_contiguous()
    assert torch.equal(rad, rad_t) and tape.shape == (7, 2, 256)
    got = tg.grad_bwd(rec, o, d, u, ct, cfg, 6, tape=tape)
    want = tg.grad_bwd(rec, o, d, u, ct, cfg, 6)
    assert got[0].shape == (rec.shape[0], tg.REC_C)
    for a, b in zip(got, want):
        assert a.is_contiguous() and torch.equal(a, b)
    assert got[1].shape == got[2].shape == (256, 3)


@pytest.mark.parametrize("name", SCENES)
def test_plain_counts_add_up(name):
    """The twin's path counts, which size the kernels' bounds: every lane
    runs bounce 0 and a lane runs bounce b + 1 iff it scattered at b, so
    segments = lanes + scatters; a miss never scatters; at depth 0 nothing
    scatters."""
    port, _ = _scenes(name)
    cfg = tg.fast_grad_config(port)
    rec = tg.fast_grad_record(port).detach()
    n = 1024
    o, d, u, _ = _probe(n, 7, seed=5)
    c = {}
    tg.trace_tiles_plain(rec, _t(o), _t(d), _t(u), cfg, 6, counts=c)
    assert c["scatters"] > 0 and c["segments"] == n + c["scatters"]
    assert c["misses"] <= c["segments"] - c["scatters"]
    assert c["sphere_hits"] <= c["segments"] - c["misses"]
    assert (c["sphere_hits"] > 0) == ("s" in cfg[0])
    c0 = {}
    tg.trace_tiles_plain(rec, _t(o), _t(d), _t(u[:1]), cfg, 0, counts=c0)
    assert c0["scatters"] == 0 and c0["segments"] == n


def test_gate_agrees_with_jax_on_presets():
    for name in ("random_spheres", "two_spheres", "two_perlin_spheres",
                 "earth", "simple_light", "cornell_box", "cornell_smoke",
                 "final_scene"):
        port, ref = tb.PRESETS[name].build(), jb.PRESETS[name].build()
        for depth in (6, 16, 17):
            assert (tg.supports_fast_grad(port, depth)
                    == pg.supports_fast_grad(ref, depth)), (name, depth)
        if pg.supports_fast_grad(ref, 6):
            assert tg.fast_grad_config(port) == pg.fast_grad_config(ref)
    assert not tg.supports_fast_grad(ir.build_scene(), 6, rr_depth=3)


def _material_scene(what):
    """A floor, a light and a sphere of `what` (metal, dielectric or a
    checker, under black or the sky)."""
    b = SceneBuilder(background=BG_SKY if what.endswith("sky") else BG_BLACK)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    b.rect("zx", -1, -1, 1, 1, 3.0, b.diffuse_light(b.solid(4.0, 4.0, 4.0)),
           flip=True)
    if what == "metal":
        b.sphere((0, 1, 0), 1.0, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    elif what == "dielectric":
        b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    elif what.startswith("checker"):
        b.sphere((0, 1, 0), 1.0, b.lambertian(b.checker(
            b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))))
    return b.build()


@pytest.mark.parametrize("what,feat", [("metal", "metal"),
                                       ("dielectric", "diel"),
                                       ("checker", "checker"),
                                       ("checker_sky", "checker")])
def test_material_scenes_now_run(what, feat):
    """Metal, dielectric and the checker, once outside the fused kernels,
    run: trace_fast gives finite, nonzero radiance equal to grad_fwd's on
    the same draws, and finite gradients into the scene's tables."""
    scene = _leaves(_material_scene(what))
    cfg = tg.fast_grad_config(scene)
    assert feat in cfg[1] and tg.supports_fast_grad(scene, 6)
    o, d, _, _ = _probe(256, 7, seed=1)
    rad = tg.trace_fast(scene, _t(o), _t(d), 0, max_depth=6)
    assert rad.shape == (256, 3) and torch.isfinite(rad).all()
    assert float(rad.detach().sum()) > 0
    u = tg.fast_draws(0, 256, 7)
    assert torch.equal(rad.detach(), tg.grad_fwd(
        tg.fast_grad_record(scene).detach(), _t(o), _t(d), u, cfg, 6))
    rad.sum().backward()
    assert torch.isfinite(scene.tex_color.grad).all()
    assert float(scene.tex_color.grad.abs().sum()) > 0


def _outside_scope(what):
    """Scenes the fused tier still refuses: a noise texture, a medium, a
    moving sphere, 65 prims (one over MAX_PRIMS); and the depth."""
    b = SceneBuilder(background=BG_SKY)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    mat = b.lambertian(b.solid(0.5, 0.5, 0.5))
    if what == "noise":
        b.sphere((0, 1, 0), 1.0, b.lambertian(b.noise(4.0)))
    elif what == "medium":
        b.medium_sphere((0, 1, 0), 1.0, 0.5, b.solid(1, 1, 1))
    elif what == "moving":
        b.moving_sphere((0, 1, 0), (0, 1.5, 0), 0.0, 1.0, 1.0, mat)
    elif what == "prims65":
        for i in range(64):
            b.sphere((i % 8 - 3.5, 0.3, i // 8 - 3.5), 0.2, mat)
    else:
        b.sphere((0, 1, 0), 1.0, mat)
    return b.build()


@pytest.mark.parametrize("what", ["noise", "medium", "moving", "prims65",
                                  "depth17"])
def test_outside_kernel_scope_raises(what):
    scene = _outside_scope(what)
    depth = 17 if what == "depth17" else 6
    assert not tg.supports_fast_grad(scene, depth)
    o, d, _, _ = _probe(64, depth + 1, seed=1)
    with pytest.raises(UnsupportedScene, match="scope"):
        tg.trace_fast(scene, _t(o), _t(d), 0, max_depth=depth)
    if what == "prims65":
        assert scene.num_prims == tg.MAX_PRIMS + 1
        with pytest.raises(UnsupportedScene, match="65 prims"):
            tg.grad_fwd(tg.fast_grad_record(scene), _t(o), _t(d),
                        torch.rand(7, 4, 64), tg.fast_grad_config(scene), 6)
    if what == "depth17":
        with pytest.raises(UnsupportedScene, match="depth 17"):
            tg.trace_fast(scene, _t(o), _t(d), 0, max_depth=17,
                          cfg=tg.fast_grad_config(scene))


def test_failed_launch_counts_nothing():
    """The K2/K3 launchers raise on a launch error before K2_LAUNCHES or
    K3_LAUNCHES moves, and count a launch that succeeded (a stub stands in
    for the kernel library)."""
    class Lib:
        def __init__(self, err):
            self.err = err

        def rt_grad_fwd(self, *args):
            return self.err

        def rt_grad_bwd(self, *args):
            return self.err

    scene = ir.build_geo_scene()
    cfg = tg.fast_grad_config(scene)
    rec = tg.fast_grad_record(scene)
    o, d, u, ct = (_t(x) for x in _probe(32, 7, seed=2))
    tape = torch.zeros(7, 2, 32, dtype=torch.int32)
    before = (tg.K2_LAUNCHES, tg.K3_LAUNCHES)
    with pytest.raises(RuntimeError, match="K2 launch failed: cudaError 700"):
        tg._launch_fwd(Lib(700), 0, rec, o, d, u, cfg, 6, True)
    with pytest.raises(RuntimeError, match="K3 launch failed: cudaError 700"):
        tg._launch_bwd(Lib(700), 0, rec, o, d, u, ct, tape, cfg, 6)
    assert (tg.K2_LAUNCHES, tg.K3_LAUNCHES) == before
    assert tg._launch_fwd(Lib(0), 0, rec, o, d, u, cfg, 6,
                          False).shape == (32, 3)
    assert len(tg._launch_bwd(Lib(0), 0, rec, o, d, u, ct, tape, cfg, 6)) == 3
    assert (tg.K2_LAUNCHES, tg.K3_LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_wrappers_reject_bad_operands():
    scene = ir.build_scene()
    cfg = tg.fast_grad_config(scene)
    rec = tg.fast_grad_record(scene)
    o, d, u, ct = (_t(x) for x in _probe(32, 7, seed=2))
    with pytest.raises(TypeError):
        tg.grad_fwd(rec, o.double(), d, u, cfg, 6)
    with pytest.raises(ValueError):
        tg.grad_fwd(rec, o, d[:16], u, cfg, 6)
    with pytest.raises(ValueError):
        tg.grad_bwd(rec, o, d, u, ct[:, :2], cfg, 6)
    with pytest.raises(ValueError):
        tg.grad_fwd(rec, o, d, torch.rand(18, 4, 32), cfg, 17)
    with pytest.raises(UnsupportedScene):
        tg.trace_fast(scene, o, d, 0, max_depth=17, cfg=cfg)
    # the winner tape: i32[n_bounce, 2, N]
    with pytest.raises(ValueError):
        tg.grad_bwd(rec, o, d, u, ct, cfg, 6,
                    tape=torch.zeros(7, 2, 16, dtype=torch.int32))
    with pytest.raises(TypeError):
        tg.grad_bwd(rec, o, d, u, ct, cfg, 6, tape=torch.zeros(7, 2, 32))


def test_fast_draws_are_the_grad_stream():
    u = tg.fast_draws(9, 256, 3)
    assert u.shape == (3, 4, 256) and u.dtype == torch.float32
    for b in range(3):
        want = rng.draws(9, torch.arange(256), 0, b, rng.STREAM_GRAD)
        for c in range(4):
            assert torch.equal(u[b, c], want[c])
    assert not torch.equal(u[0, 0], rng.draws(9, torch.arange(256), 0, 0,
                                              rng.STREAM_SCATTER)[0])


def test_camera_lane_rays_match_jax_get_rays():
    """The port's lane rays equal the JAX camera's get_rays on the same
    viewport coordinates and lens uniforms (to 2 ulp of the scene's scale)."""
    nx, ny = 50, 40
    pid = torch.from_numpy(np.random.default_rng(4).integers(
        0, nx * ny, 300)).long()
    cam = ir.camera()
    o, d, _ = camera_lane_rays(cam, pid, 77, nx, ny)
    u0, u1, u2, u3 = (x.numpy() for x in rng.draws(
        77, torch.arange(300), 0, 0, rng.STREAM_CAMERA))
    i = (pid % nx).numpy().astype(np.float32)
    j = (ny - 1 - pid // nx).numpy().astype(np.float32)
    jc = jcam.make_camera((0, 3, 9), (0, 1.5, 0), (0, 1, 0), 45.0, 1.0, 0.0,
                          9.0)
    jo, jd, _ = jcam.get_rays(jc, (i + u0) / nx, (j + u1) / ny,
                              np.stack([u2, u3, np.zeros_like(u2)], -1))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=4e-6)


def test_trainer_step_matches_jax():
    """One path-matched step on injected identical rays and draws (32
    pixels × 4 spp, depth 6): the loss within 1e-6 relative, the albedo and
    emission gradients within 5e-4 of their scale, against
    jax.value_and_grad of the JAX fast step's loss (make_fast_step_body)."""
    block, spp, md = 32, 4, 6
    n = block * spp
    r = np.random.default_rng(6)
    cam = ir.camera()
    pid = torch.from_numpy(r.integers(0, 200 * 200, block)).long()
    o, d, _ = camera_lane_rays(cam, pid.repeat_interleave(spp), 3, 200, 200)
    u = r.random((md + 1, 4, n), dtype=np.float32)
    target_scene = ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT)
    scene = ir.build_scene(ir.START_ALBEDO, ir.START_EMIT)
    light_tex, box_tex = ir.param_tex_rows(scene)
    cfg = tg.fast_grad_config(scene)
    albedo = torch.tensor([0.45, 0.55, 0.6], requires_grad=True)
    emit = torch.tensor(3.5, requires_grad=True)
    loss = ir.path_matched_loss(target_scene, scene, light_tex, box_tex,
                                albedo, emit, o, d, _t(u), block=block,
                                spp=spp, max_depth=md, cfg=cfg)
    loss.backward()

    jt = _jax_inverse_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT)
    js = _jax_inverse_scene(ir.START_ALBEDO, ir.START_EMIT)
    jo, jd = o.numpy(), d.numpy()

    def img(s):
        rad = _jax_trace(pg.fast_grad_record(s), jo, jd, u, cfg, md)
        return rad.reshape(block, spp, 3).sum(axis=1) / spp

    target = jax.lax.stop_gradient(img(jt))

    def loss_fn(p):
        s2 = dataclasses.replace(
            js, tex_color=js.tex_color.at[box_tex].set(p["albedo"])
            .at[light_tex].set(jnp.broadcast_to(p["emit"], (3,))))
        return jnp.mean((img(s2) - target) ** 2)

    jl, jg = jax.value_and_grad(loss_fn)(
        {"albedo": jnp.asarray([0.45, 0.55, 0.6], jnp.float32),
         "emit": jnp.asarray(3.5, jnp.float32)})
    assert loss.item() > 0
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    _assert_scale_close(albedo.grad.numpy(), jg["albedo"], 5e-4, "albedo")
    _assert_scale_close(emit.grad.numpy(), jg["emit"], 5e-4, "emit")


def test_trainer_tiny_cpu_run_moves_toward_target():
    """24×24, block 64, 4 spp, 15 steps on the CPU: the loss falls and both
    groups end nearer the truth than they started."""
    lines = []
    res = ir.train(steps=15, nx=24, ny=24, spp=4, block=64, device="cpu",
                   log=lines.append)
    losses = res["losses"]
    assert len(losses) == 15 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.5 * np.mean(losses[:3])
    start_a = np.abs(np.subtract(ir.START_ALBEDO, ir.TRUE_ALBEDO)).max()
    assert np.abs(res["albedo"] - np.asarray(ir.TRUE_ALBEDO)).max() < start_a
    assert abs(res["emit"] - ir.TRUE_EMIT) < abs(ir.START_EMIT - ir.TRUE_EMIT)
    assert sum(ln.startswith("step ") for ln in lines) == 2  # steps 9, 14


def test_main_prints_the_scripts_summary(capsys):
    rc = ir.main(["--device", "cpu", "--nx", "16", "--ny", "16", "--block",
                  "32", "--spp", "2", "--steps", "3"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert "recovered albedo" in out and "step time:" in out
    with pytest.raises(SystemExit):
        ir.main(["--device", "cpu", "--nx", "4", "--ny", "4", "--block", "32"])


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytracing_rust_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'raytracing_rust_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'raytracing_rust_tpu.')))\n"
        "assert 'raytracing_rust_tpu_torch.inverse_render' in mods, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
