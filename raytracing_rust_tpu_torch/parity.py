"""The parity sweep: K1 against the general tier on the card, scene by
scene, as one record.

Counterpart of `tools/tpu_parity.py`, whose configs, sizes, spp, depths
and tolerances it takes: "pallas" in its record is K1
(`ops/tracer.render_kernel`), "xla" the general tier (`render.render`).

* Every config of `CONFIGS` renders on both engines with independent seeds
  (K1 at seed 0, the general tier at seed 1) and their image means must
  agree within the config's tolerance; `random_spheres_bvh` runs the
  general tier through its BVH. K1 and the general tier draw from the same
  Philox keys, so each config also renders the general tier at K1's seed,
  and the two images must agree pixel by pixel far inside the Monte Carlo
  noise (`PIXEL_NOISE_SHARE`) and in at least `PIXEL_SHARE` of the pixels
  within `PIXEL_ATOL`: the two tracers part only where a decision turns on
  float rounding (a glass or metal branch, a tangent hit, the marble).
* The extra checks: `lattice` (every lattice corner) and
  `fog_over_textures` (a solid medium over noise and image surfaces), each
  also held pixel by pixel against a second general-tier seed's noise;
  `fog_slab_density` (a density-sensitive slab); `balance_scatter` (K1's
  balanced table against its scanline layout on final_scene 192×192: since
  the card's table the sums are equal, so the images must be equal bit for
  bit); `walk_window` (the dense-medium walk's window of final_scene, in the
  linear domain); `split2` (cornell_box through `parallel/sharding.
  render_sharded` on two gloo ranks, meshes (2, 1) and (1, 2), against one
  rank); `fast_grad_tier` (K2/K3 through `ops/grad.trace_fast` against
  autograd through the general tier on the same `fast_draws`) and
  `pallas_checkpoint_resume` (K1 stopped after 2 of 4 chunks and resumed,
  equal bit for bit to an uninterrupted render).

`--quick` cuts each config's spp to max(16, spp / 4) and doubles its
tolerance, as JAX's does; `RT_PARITY_SPP_MULT=N` multiplies every spp by N
and divides the tolerances by √N. A failed render fails its check (there is
no retry). The process exits 1 when a check fails.

    python -m raytracing_rust_tpu_torch.parity [--quick] [--json PATH]
        [--device cuda|cpu] [--only CHECK ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

CONFIGS = {
    # key: (scene, nx, ny, spp, depth, mean rel tolerance, options)
    "two_spheres": ("two_spheres", 96, 54, 64, 12, 0.02, {}),
    "random_spheres": ("random_spheres", 96, 54, 64, 12, 0.02, {}),
    "random_spheres_bvh": ("random_spheres", 48, 27, 48, 10, 0.03,
                           {"use_bvh": True}),
    "two_perlin_spheres": ("two_perlin_spheres", 96, 54, 64, 12, 0.02, {}),
    "simple_light": ("simple_light", 96, 54, 128, 12, 0.04, {}),
    "cornell_box": ("cornell_box", 64, 64, 128, 16, 0.04, {}),
    "cornell_box_rr": ("cornell_box", 64, 64, 128, 16, 0.05,
                       {"rr_depth": 6}),
    "cornell_smoke": ("cornell_smoke", 64, 64, 128, 16, 0.04, {}),
    "earth": ("earth", 96, 54, 64, 12, 0.02, {}),
    "final_scene": ("final_scene", 48, 48, 48, 10, 0.05, {}),
    # roulette turns the dense-medium walk off
    "final_scene_rr": ("final_scene", 48, 48, 48, 10, 0.07,
                       {"rr_depth": 5}),
}

# scenes only the general tier renders, with the mean band of a CPU render
# (48×27, 8 spp, depth 8, seed 11): none, as in JAX, where every scene runs
# on the kernel
XLA_BANDS: dict = {}

EXTRA_CHECKS = ("lattice", "fog_over_textures", "fog_slab_density",
                "balance_scatter", "walk_window", "split2", "fast_grad_tier",
                "pallas_checkpoint_resume")

# the per-pixel gate of K1 against the general tier at K1's seed (the same
# draws): their mean |Δ| a pixel channel at most this share of the Monte
# Carlo noise (the mean |Δ| between the general tier's two seeds) ...
PIXEL_NOISE_SHARE = 0.1
# ... and at least PIXEL_SHARE of the pixels within PIXEL_ATOL in every
# channel of the gamma-space image. A pixel differs where one of its
# samples took another branch on a rounding (K1 takes t with a reciprocal
# and the sphere normal as (oc + t·d)·(1/r)): 0.5% of random_spheres'
# pixels at 4 spp, 2% of two_perlin_spheres' (the marble amplifies ulps),
# and the share grows with spp
PIXEL_ATOL = 1e-3
PIXEL_SHARE = 0.8

RESULTS: list = []


def record(check: str, ok: bool, **fields) -> None:
    """Append a check's row in JAX's record layout (ints as floats)."""
    RESULTS.append({"check": check, "pass": bool(ok),
                    **{k: (bool(v) if isinstance(v, (bool, np.bool_))
                           else float(v) if isinstance(v, (int, float))
                           else v)
                       for k, v in fields.items()}})


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(b, 1e-6)


def _mad(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).mean())


def _pixels(k1, same, other) -> dict:
    """The per-pixel comparison of K1's image against the general tier's
    at the same seed, beside the noise between the general tier's seeds."""
    mad, noise = _mad(k1, same), _mad(other, same)
    within = float((np.abs(np.asarray(k1) - np.asarray(same)).max(axis=-1)
                    <= PIXEL_ATOL).mean())
    return dict(same_seed_mad=mad, mad_noise=noise, pixels_within=within,
                pixels_ok=bool(mad <= PIXEL_NOISE_SHARE * max(noise, 1e-6)
                               and within >= PIXEL_SHARE))


def _fog_scene(device):
    """A solid-albedo medium over noise and image surfaces under the sky
    (tools/tpu_parity.py's fog-over-textures scene)."""
    from .models.scene import BG_SKY, SceneBuilder
    bld = SceneBuilder(background=BG_SKY)
    bld.sphere((0, -1000, 0), 1000.0,
               bld.lambertian(bld.solid(0.7, 0.7, 0.7)))
    bld.sphere((-1.2, 1, 0), 1.0, bld.lambertian(bld.noise(3.0)))
    tex = (np.arange(8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
           % 256) / 255.0
    tex = np.rint(tex * 255) / np.float32(255.0)  # 8-bit exact
    bld.sphere((1.2, 1, 0), 1.0, bld.lambertian(bld.image(tex)))
    bld.medium_sphere((0, 1, 0), 4.0, 0.4, bld.solid(0.9, 0.9, 0.9))
    return bld.build(device)


def _slab_scene(device):
    """A density-sensitive fog slab in front of a light (the e2e oracle's
    fog_slab): its mean is mostly the direct transmission exp(−ρ·L)."""
    from .models.scene import BG_BLACK, SceneBuilder
    bld = SceneBuilder(background=BG_BLACK)
    bld.rect("xy", -100.0, -100.0, 100.0, 100.0, -50.0,
             bld.diffuse_light(bld.solid(1, 1, 1)))
    bld.medium_box((-100, -100, 0), (100, 100, 100), 0.01,
                   bld.solid(0.3, 0.3, 0.3))
    return bld.build(device)


def _grad_scene(device):
    """The fused tier's check scene: a floor, a flipped light, metal, glass
    and a diffuse sphere under the sky."""
    from .models.scene import BG_SKY, SceneBuilder
    bld = SceneBuilder(background=BG_SKY)
    bld.rect("zx", -3, -3, 3, 3, 0.0,
             bld.lambertian(bld.solid(0.73, 0.73, 0.73)))
    bld.rect("zx", -1, -1, 1, 1, 5.0,
             bld.diffuse_light(bld.solid(4.0, 4.0, 4.0)), flip=True)
    bld.sphere((0.9, 1.0, 0.5), 0.8, bld.metal(bld.solid(0.8, 0.7, 0.6), 0.2))
    bld.sphere((-1.0, 0.8, 0.6), 0.7, bld.dielectric(1.5))
    bld.sphere((0.0, 0.6, -1.2), 0.6,
               bld.lambertian(bld.solid(0.2, 0.5, 0.8)))
    return bld.build(device)


def split2_rank(out: str, device: str, spp: int) -> int:
    """One of split2's two gloo ranks: cornell_box 64×64×spp, depth 16,
    seed 3, through `render_sharded` on meshes (2, 1) and (1, 2); rank 0
    saves both images to out (.npz)."""
    import torch.distributed as dist

    from .models.builders import PRESETS
    from .parallel import sharding

    with sharding.process_group(device, "gloo") as dev:
        p = dataclasses.replace(PRESETS["cornell_box"], nx=64, ny=64)
        scene, cam = p.build(device=dev), p.camera(device=dev)
        imgs = {}
        for dp, sp in ((2, 1), (1, 2)):
            mesh = sharding.make_mesh(dp, sp)
            imgs[f"{dp}x{sp}"] = sharding.render_sharded(
                scene, cam, 64, 64, spp, mesh, device=dev, seed=3,
                max_depth=16)
        if dist.get_rank() == 0:
            np.savez(out, **imgs)
    return 0


def run(*, quick: bool = False, mult: int = 1, device="cuda",
        only=None, log=print) -> dict:
    """Run the sweep's checks (all, or those named in only) → the record:
    pass, failures, quick, spp_mult, device, checks (one row a check)."""
    from . import render as trender
    from .models.builders import PRESETS, lattice_camera, lattice_scene
    from .ops import tracer
    from .ops.camera import make_camera

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but "
                           "torch.cuda.is_available() is false")
    shrink = 1.0 / math.sqrt(mult)
    RESULTS.clear()
    failures = 0

    def want(name):
        return only is None or name in only

    def k1(scene, cam, nx, ny, spp, **kw):
        return tracer.render_kernel(scene, cam, nx, ny, spp, device=dev,
                                    **kw)

    def gen(scene, cam, nx, ny, spp, **kw):
        return trender.render(scene, cam, nx, ny, spp, device=dev, **kw)

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    def done(check, ok, text, **fields):
        nonlocal failures
        log(f"{text} {'OK' if ok else 'FAIL'}")
        record(check, ok, **fields)
        failures += 0 if ok else 1

    for key, cfg in CONFIGS.items():
        if not want(key):
            continue
        name, nx, ny, spp, depth, tol, opts = cfg
        if quick:
            spp = max(16, spp // 4)
            tol *= 2
        spp *= mult
        tol *= shrink
        preset = PRESETS[name]
        scene, cam = preset.build(device=dev), preset.camera(device=dev)
        kw = dict(max_depth=depth, rr_depth=opts.get("rr_depth"))
        try:
            a, tp = timed(lambda: k1(scene, cam, nx, ny, spp, seed=0, **kw))
        except tracer.UnsupportedScene as e:
            log(f"{key}: SKIP ({e})")
            record(key, True, skipped=True, reason=str(e))
            continue
        gkw = dict(kw, use_bvh=opts.get("use_bvh"))
        b, tx = timed(lambda: gen(scene, cam, nx, ny, spp, seed=1, **gkw))
        b0 = gen(scene, cam, nx, ny, spp, seed=0, **gkw)
        ma, mb = float(a.mean()), float(b.mean())
        rel = _rel(ma, mb)
        px = _pixels(a, b0, b)
        ok = bool(np.isfinite(a).all() and np.isfinite(b).all()
                  and rel < tol and px["pixels_ok"])
        done(key, ok, f"{key}: pallas={ma:.4f} ({tp:.1f}s) xla={mb:.4f} "
             f"({tx:.1f}s) rel={rel:.3f} tol={tol:.3g} same-seed "
             f"mean|Δpx|={px['same_seed_mad']:.5f} noise="
             f"{px['mad_noise']:.4f} within {PIXEL_ATOL:g}: "
             f"{px['pixels_within']:.4f}",
             pallas_mean=ma, xla_mean=mb, rel=rel, tol=tol, nx=nx, ny=ny,
             spp=spp, depth=depth, pallas_s=tp, xla_s=tx, opts=opts, **px)

    def against_noise(check, scene, cam, nx, ny, spp, depth, tol):
        a, tp = timed(lambda: k1(scene, cam, nx, ny, spp, seed=0,
                                 max_depth=depth))
        b, tx = timed(lambda: gen(scene, cam, nx, ny, spp, seed=1,
                                  max_depth=depth))
        b2 = gen(scene, cam, nx, ny, spp, seed=2, max_depth=depth)
        ma, mb = float(a.mean()), float(b.mean())
        rel = _rel(ma, mb)
        mad, mad0 = _mad(a, b), _mad(b2, b)
        ok = bool(np.isfinite(a).all() and rel < tol
                  and mad < 1.3 * max(mad0, 1e-6))
        done(check, ok, f"{check}: pallas={ma:.4f} ({tp:.1f}s) xla={mb:.4f} "
             f"({tx:.1f}s) rel={rel:.3f} tol={tol:.3g} mean|Δpx|={mad:.4f} "
             f"noise={mad0:.4f}", pallas_mean=ma, xla_mean=mb, rel=rel,
             tol=tol, mad=mad, mad_noise=mad0, nx=nx, ny=ny, spp=spp)

    if want("lattice"):
        lnx, lny = 96, 54
        against_noise("lattice", lattice_scene(dev),
                      lattice_camera(lnx, lny, device=dev), lnx, lny,
                      (64 if quick else 128) * mult, 16, 0.04 * shrink)
    if want("fog_over_textures"):
        against_noise("fog_over_textures", _fog_scene(dev), make_camera(
            (0, 2, 9), (0, 1, 0), (0, 1, 0), 40.0, 96 / 54, 0.0, 9.0, 0.0,
            1.0, device=dev), 96, 54, (64 if quick else 128) * mult, 16,
            0.03 * shrink)

    if want("fog_slab_density"):
        scene = _slab_scene(dev)
        cam = make_camera((0.0, 0.0, 300.0), (0.0, 0.0, 0.0), (0, 1, 0),
                          30.0, 96 / 54, 0.0, 10.0, 0.0, 1.0, device=dev)
        sspp = (128 if quick else 256) * mult
        a, tp = timed(lambda: k1(scene, cam, 96, 54, sspp, seed=0,
                                 max_depth=50))
        b, tx = timed(lambda: gen(scene, cam, 96, 54, sspp, seed=1,
                                  max_depth=50))
        ma, mb = float(a.mean()), float(b.mean())
        rel, stol = _rel(ma, mb), 0.02 * shrink
        done("fog_slab_density", bool(np.isfinite(a).all() and rel < stol),
             f"fog slab density: pallas={ma:.4f} ({tp:.1f}s) xla={mb:.4f} "
             f"({tx:.1f}s) rel={rel:.3f} tol={stol:.3g}", pallas_mean=ma,
             xla_mean=mb, rel=rel, tol=stol, spp=sspp)

    for name, expected in XLA_BANDS.items():
        if not want(f"{name}_xla_band"):
            continue
        preset = PRESETS[name]
        img, tx = timed(lambda: gen(preset.build(device=dev),
                                    preset.camera(device=dev), 48, 27, 8,
                                    seed=11, max_depth=8))
        mean = float(img.mean())
        done(f"{name}_xla_band", bool(np.isfinite(img).all() and 0.8
                                      * expected < mean < 1.2 * expected),
             f"{name} (xla-only): mean={mean:.4f} ({tx:.1f}s)", mean=mean,
             band_lo=0.8 * expected, band_hi=1.2 * expected)

    preset = PRESETS["final_scene"]
    spp_b = (64 if quick else 256) * mult
    if want("balance_scatter") or want("walk_window"):
        scene, cam = preset.build(device=dev), preset.camera(device=dev)
    if want("balance_scatter"):
        # 192×192: more than one tile row of 16×8 tiles in each direction
        a, tp = timed(lambda: k1(scene, cam, 192, 192, spp_b, seed=5,
                                 max_depth=10, balance=True))
        b = k1(scene, cam, 192, 192, spp_b, seed=5, max_depth=10,
               balance=False)
        mad = _mad(a, b)
        ok = bool(np.isfinite(a).all() and np.array_equal(a, b))
        done("balance_scatter", ok, f"balance scatter (final_scene): "
             f"balanced == scanline bit for bit: {np.array_equal(a, b)} "
             f"mean|Δpx|={mad:.4g} ({tp:.1f}s)", mad=mad, bit_equal=ok,
             spp=spp_b)
    if want("walk_window"):
        a_w = k1(scene, cam, 96, 96, spp_b, seed=2, max_depth=24)
        b_w = gen(scene, cam, 96, 96, spp_b, seed=3, max_depth=24)
        # the blue subsurface sphere's window at 96×96, linear domain
        win = (slice(58, 82), slice(16, 40))
        ma = float((a_w[win] ** 2).mean())
        mb = float((b_w[win] ** 2).mean())
        rel, wtol = _rel(ma, mb), 0.15 * shrink
        done("walk_window", rel < wtol, f"walk window (subsurface, linear): "
             f"pallas={ma:.4f} xla={mb:.4f} rel={rel:.3f} tol={wtol:.3g}",
             pallas_mean=ma, xla_mean=mb, rel=rel, tol=wtol)

    if want("split2"):
        from .parallel import multihost_worker
        s2spp = 128 * mult
        p = dataclasses.replace(PRESETS["cornell_box"], nx=64, ny=64)
        one, t1 = timed(lambda: gen(p.build(device=dev),
                                    p.camera(device=dev), 64, 64, s2spp,
                                    seed=3, max_depth=16))
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "split2.npz")
            runs = multihost_worker.launch(
                2, ["-m", "raytracing_rust_tpu_torch.parity", "--split2-rank",
                    out, "--device",
                    dev.type, "--spp", str(s2spp)], one_device=True,
                timeout=600)
            errs = [f"rank {r} exited {rc}: {text[-2000:]}"
                    for r, (rc, text) in enumerate(runs) if rc]
            got = {} if errs else dict(np.load(out))
        t2 = time.perf_counter() - t
        m1 = float(one.mean())
        fields, ok = dict(one_dev=m1, one_s=t1, two_s=t2), not errs
        s2tol = 0.04 * shrink
        for tag, img in got.items():
            ulps = int(np.abs(img.view(np.int32).astype(np.int64)
                              - one.view(np.int32).astype(np.int64)).max())
            rel = _rel(float(img.mean()), m1)
            # (2, 1) splits pixels only: the same sums; (1, 2) adds two
            # ranks' samples in another order: ≤ 1 ulp of the image
            ok &= bool(np.isfinite(img).all() and rel < s2tol
                       and ulps <= (0 if tag == "2x1" else 1))
            fields.update({f"two_dev_{tag}": float(img.mean()),
                           f"rel_{tag}": rel, f"ulps_{tag}": ulps})
        if errs:
            fields["errors"] = errs
        done("split2", ok, "split2 (two gloo ranks, one device): " + " ".join(
            f"{k}={v:.4g}" for k, v in fields.items()
            if isinstance(v, (int, float))), tol=s2tol, **fields)

    if want("fast_grad_tier"):
        from .ops import integrator
        from .ops.grad import fast_draws, fast_grad_config, trace_fast
        scene = _grad_scene(dev)
        fcfg = fast_grad_config(scene)
        gn, depth, seed = 8192, 5, 7
        grng = np.random.default_rng(3)
        go = torch.tensor(np.tile(np.array([0., 2., 8.], np.float32),
                                  (gn, 1)), device=dev)
        gd = torch.tensor(np.stack([grng.uniform(-.7, .7, gn),
                                    grng.uniform(-.45, .25, gn),
                                    -np.ones(gn)], -1).astype(np.float32),
                          device=dev)
        u = fast_draws(seed, gn, depth + 1, device=dev)
        lane = torch.arange(gn, device=dev)
        leaves = ("prim_data", "mat_param", "tex_color")

        def grads(fn):
            ls = {k: getattr(scene, k).detach().requires_grad_(True)
                  for k in leaves}
            rad = fn(dataclasses.replace(scene, **ls))
            g = torch.autograd.grad(rad.mean(), list(ls.values()),
                                    allow_unused=True)
            return rad.detach(), [torch.zeros_like(v) if x is None else x
                                  for v, x in zip(ls.values(), g)]

        want_rad, gx = grads(lambda s: integrator.trace(
            s, go, gd, torch.zeros(gn, device=dev), seed, lane,
            torch.zeros_like(lane), depth, differentiable=True, u=u))
        got_rad, gp = grads(lambda s: trace_fast(s, go, gd, seed,
                                                 max_depth=depth, cfg=fcfg,
                                                 u=u))
        prim_err = float((got_rad - want_rad).abs().max())
        grad_err = max(float((a - b).abs().max())
                       / max(float(a.abs().max()), 1e-3)
                       for a, b in zip(gx, gp))
        ok = bool(torch.isfinite(got_rad).all() and prim_err < 1e-3
                  and grad_err < 1e-3)
        done("fast_grad_tier", ok, f"fused grad tier: primal max|Δ|="
             f"{prim_err:.2e} grad rel max|Δ|={grad_err:.2e}",
             primal_max_abs=prim_err, grad_rel_max=grad_err)

    if want("pallas_checkpoint_resume"):
        preset = PRESETS["cornell_box"]
        scene, cam = preset.build(device=dev), preset.camera(device=dev)
        kw = dict(seed=4, max_depth=12, spp_chunk=16)
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "ck.npz")
            full = k1(scene, cam, 64, 64, 64, **kw)
            k1(scene, cam, 64, 64, 64, checkpoint=ck, _stop_after_chunks=2,
               **kw)
            saved = os.path.exists(ck)
            resumed = k1(scene, cam, 64, 64, 64, checkpoint=ck, **kw)
            equal = bool(np.array_equal(resumed, full))
        done("pallas_checkpoint_resume", saved and equal,
             f"K1 checkpoint/resume: saved={saved} byte-equal={equal}",
             saved=saved)

    log("PARITY PASS" if failures == 0 else f"PARITY FAIL ({failures})")
    return {"pass": failures == 0, "failures": failures, "quick": quick,
            "spp_mult": mult, "device": (torch.cuda.get_device_name(dev)
                                         if dev.type == "cuda" else "cpu"),
            "checks": list(RESULTS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracing_rust_tpu_torch.parity",
        description="K1 against the general tier, config by config")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--only", nargs="+", default=None,
                    choices=[*CONFIGS, *EXTRA_CHECKS,
                             *(f"{n}_xla_band" for n in XLA_BANDS)],
                    help="run only these checks")
    ap.add_argument("--split2-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spp", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.split2_rank:
        return split2_rank(args.split2_rank, args.device, args.spp)
    mult = int(os.environ.get("RT_PARITY_SPP_MULT", "1"))
    if mult != 1:
        print(f"RT_PARITY_SPP_MULT={mult}: spp x{mult}, rel tolerances "
              f"x{1 / math.sqrt(mult):.3f}", flush=True)
    card = "cpu"
    if args.device == "cuda" and torch.cuda.is_available():
        from .kernel_stats import smi
        card = smi("name,power.limit")
    print(card, flush=True)
    art = run(quick=args.quick, mult=mult, device=args.device,
              only=args.only, log=lambda s: print(s, flush=True))
    art["card"] = card
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(art, fh, indent=1)
        print(f"wrote {args.json}", flush=True)
    return 0 if art["pass"] else 1


if __name__ == "__main__":
    from .parallel.multihost_worker import finish
    finish(main())
