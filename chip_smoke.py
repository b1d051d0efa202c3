#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracing_rust_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
version and renders on the card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from csrc/ with nvcc (timed);
  3. the K1a kernel against its plain torch version, on the card, on the
     same records and draws: cornell_box 800×800, 4 spp, depth 50;
  4. sample chunks of 2 and 4 give bit-identical kernel sums;
  5. the render path through the command line, `render --scene
     cornell_box_baseline --device cuda` (800×800, 500 spp, depth 50),
     with K1a's launch count, a check of the image, and the kernel's and
     the plain version's times at 800×800×8 spp;
  6. K2 (csrc/grad.cu) against its plain version `trace_tiles_plain` at
     the training step's full width: the inverse-render scene, 4,096
     pixels × 64 spp = 262,144 lanes, depth 6, the step's own rays and
     draws;
  7. K3 against torch autograd through the plain version, same inputs and
     a seeded cotangent;
  8. the training path, `inverse_render.main(["--device", "cuda",
     "--steps", "40"])` (200×200, block 4,096, 64 spp, depth 6), with K2's
     and K3's launch counts and the recovered albedo and emission;
  9. times by CUDA events at that width: K2, K3, the plain forward, the
     plain forward + backward, one training step; sample-paths/s;
 10. the K1b/K1e instantiations of csrc/tracer.cu against their plain
     version, on each sphere preset the command line renders below, at
     the preset's size, 2 spp, depth 50, under the same gates as phase 3:
     random_spheres 1280×720 (checker, sky, metal, glass, 397 dynamic
     spheres of which 311 move; with the leaf cull on and off) and
     two_spheres 1280×720 (sky and checker, no dynamic table); both
     versions' times;
 11. the render path through the command line, `render --scene
     random_spheres --device cuda` (1280×720, 100 spp, depth 50), with its
     launch count and a check of the image;
 12. the same for `render --scene two_spheres --device cuda` (1280×720,
     10 spp, depth 50).
Then the kernel table and, as the last line, the device summary.

Any failure exits non-zero before the last line. Without CUDA, or run
outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# cornell_box_baseline's mean gamma-space image value as the JAX package's
# XLA tier renders it on the CPU at 80×80, 500 spp, depth 50, seed 0
# (raytracing_rust_tpu.render.render with the preset's camera). The band is
# ±5%: tighter than the ±20% of tests/test_scene_stats.py, which renders
# at 8 spp; at 500 spp the Monte Carlo spread of the mean is far smaller.
CORNELL_MEAN = 0.22455
CORNELL_BAND = (0.95 * CORNELL_MEAN, 1.05 * CORNELL_MEAN)
# the same for random_spheres (128×72, 100 spp, depth 50, seed 0) and
# two_spheres (128×72, 10 spp, depth 50, seed 0), each at its preset's spp
RANDOM_SPHERES_MEAN = 0.5859978795051575
TWO_SPHERES_MEAN = 0.5419976115226746


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls, after one
    warm-up call unless warm is False, by CUDA events."""
    import torch
    if warm:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracing_rust_tpu_torch import cli
    from raytracing_rust_tpu_torch import inverse_render as ir
    from raytracing_rust_tpu_torch.models.builders import PRESETS
    from raytracing_rust_tpu_torch.ops import _build, grad, tracer
    from raytracing_rust_tpu_torch.utils.image_io import read_ppm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def run_cli(scene: str):
        """`render --scene <scene> --device cuda` at the preset's size, with
        every launch count set to 0 just before and read just after →
        (what to emit, the image)."""
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, f"{scene}.ppm")
            argv = ["render", "--scene", scene, "--device", "cuda", "--out",
                    out, "--timers"]
            buf = io.StringIO()
            tracer.KERNEL_LAUNCHES = tracer.K1BE_LAUNCHES = 0
            grad.K2_LAUNCHES = grad.K3_LAUNCHES = 0
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            wall = time.perf_counter() - t
            launches = {"k1a_static_trace": tracer.KERNEL_LAUNCHES,
                        "k1be_sphere_trace": tracer.K1BE_LAUNCHES}
            check(rc == 0, f"cli.main({argv}) returned {rc}")
            img = read_ppm(out)
        text = buf.getvalue()
        rate = re.search(r"\(([0-9.]+)M primary rays/s\)", text)
        timers = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^\s+(\S+)\s+([0-9.]+)s", text, re.M)}
        return dict(argv=argv, wall_seconds=wall,
                    render_primary_rays_per_s=(float(rate.group(1)) * 1e6
                                               if rate else None),
                    timers=timers, launches=launches,
                    image_shape=list(img.shape),
                    mean_luminance=float(img.mean())), img

    # -- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- 2. build
    t = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    ptxas, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            flags = re.search(r"trace_k1I((?:Lb[01]E)+)E", m.group(1))
            fn = (f"trace_k1<{','.join(re.findall('[01]', flags.group(1)))}>"
                  if flags else m.group(1))
        elif fn and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(fn, []).append(ln.split(" : ")[-1].strip())
    emit("build", seconds=time.perf_counter() - t, nvcc=_build._nvcc(),
         library=os.path.relpath(lib_path), ptxas=ptxas)

    # -- 3. kernel vs plain, cornell_box 800×800, 4 spp, depth 50
    p = PRESETS["cornell_box_baseline"]
    nx, ny = p.nx, p.ny
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(p.camera()), dev)

    def sums():
        return torch.zeros((3, nx * ny), dtype=torch.float64, device=dev)

    kw = dict(nx=nx, ny=ny, seed=0, max_depth=50)
    k = tracer.trace(ops, sums(), sample0=0, n_samples=4, **kw)
    pl = tracer.trace_plain(ops, sums(), sample0=0, n_samples=4, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k).all()), "kernel sums are not finite")
    agree = float(torch.isclose(k, pl, rtol=1e-4, atol=0.0)
                  .all(dim=0).double().mean())
    km, pm = k.mean(dim=1), pl.mean(dim=1)
    mean_rel = float(((km - pm).abs() / pm.abs()).max())
    max_abs_err = float((k - pl).abs().max())
    emit("kernel_vs_plain", shape=[ny, nx], spp=4, depth=50,
         pixels_within_rel_1e4=agree, kernel_channel_means=km.tolist(),
         plain_channel_means=pm.tolist(), channel_mean_max_rel=mean_rel,
         max_abs_err=max_abs_err)
    check(agree >= 0.99, f"only {agree:.4%} of pixels agree within 1e-4")
    check(mean_rel <= 1e-4, f"channel means differ by {mean_rel:.2e} rel")

    # -- 4. chunking invariance of the kernel
    chunked = {}
    for chunk in (2, 4):
        s = sums()
        for s0 in range(0, 4, chunk):
            tracer.trace(ops, s, sample0=s0, n_samples=chunk, **kw)
        chunked[chunk] = s
    same = bool(torch.equal(chunked[2], chunked[4]))
    emit("chunking", spp=4, chunks=[2, 4], bit_identical=same,
         equals_phase3=bool(torch.equal(chunked[4], k)))
    check(same, "spp_chunk 2 and 4 give different kernel sums")

    # -- 5. the main path, through the command line
    info, img = run_cli("cornell_box_baseline")
    lum = info["mean_luminance"]
    launches = info["launches"]
    emit("main_path", **info, wall_primary_rays_per_s=nx * ny * p.spp
         / info["wall_seconds"], band=list(CORNELL_BAND))
    check(launches["k1a_static_trace"] > 0,
          f"a kernel of the path never launched: {launches}")
    check(img.shape == (ny, nx, 3) and bool(((img >= 0) & (img <= 1)).all()),
          "image has the wrong shape or range")
    check(CORNELL_BAND[0] < lum < CORNELL_BAND[1],
          f"mean luminance {lum:.4f} outside {CORNELL_BAND}")

    # kernel and plain version at 800×800×8 spp, depth 50
    s8 = sums()
    k_ms_k1a = cuda_ms(lambda: tracer.trace(ops, s8.zero_(), sample0=0,
                                            n_samples=8, **kw), reps=5)
    p_ms = cuda_ms(lambda: tracer.trace_plain(ops, s8.zero_(), sample0=0,
                                              n_samples=8, **kw), reps=2)
    rays = nx * ny * 8
    emit("kernel_vs_plain_time", shape=[ny, nx], spp=8, depth=50,
         kernel_ms=k_ms_k1a, plain_ms=p_ms,
         kernel_primary_rays_per_s=rays / (k_ms_k1a * 1e-3),
         plain_primary_rays_per_s=rays / (p_ms * 1e-3))

    # -- 6. K2 vs plain at the training step's full width
    kw = dict(nx=200, ny=200, spp=64, block=4096, max_depth=6)
    target = ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT, device=dev)
    cfg = grad.fast_grad_config(target)
    rec = grad.fast_grad_record(target).detach()
    o, d, u = ir.step_inputs(ir.camera(dev), 0, device=dev, **kw)
    n = o.shape[0]
    k2 = grad.grad_fwd(rec, o, d, u, cfg, 6)
    p2 = grad.trace_tiles_plain(rec, o, d, u, cfg, 6)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k2).all()), "K2 radiance is not finite")
    agree = float(torch.isclose(k2, p2, rtol=1e-4, atol=0.0)
                  .all(dim=1).double().mean())
    km, pm = k2.mean(dim=0), p2.mean(dim=0)
    mean_rel = float(((km - pm).abs() / pm.abs()).max())
    k2_err = float((k2 - p2).abs().max())
    emit("k2_vs_plain", lanes=n, depth=6, lanes_within_rel_1e4=agree,
         kernel_channel_means=km.tolist(), plain_channel_means=pm.tolist(),
         channel_mean_max_rel=mean_rel, max_abs_err=k2_err)
    check(agree >= 0.99, f"K2: only {agree:.4%} of lanes agree within 1e-4")
    check(mean_rel <= 1e-4, f"K2: channel means differ by {mean_rel:.2e}")

    # -- 7. K3 vs autograd of the plain version, same inputs
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    ct = torch.rand(n, 3, generator=g, device=dev)
    k3 = grad.grad_bwd(rec, o, d, u, ct, cfg, 6)
    p3 = grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, 6)
    torch.cuda.synchronize()
    scale = float(p3[0].abs().max())
    k3_err = float((k3[0] - p3[0]).abs().max())
    lanes_ok = [float(torch.isclose(a, b, rtol=1e-4, atol=0.0)
                      .all(dim=1).double().mean())
                for a, b in zip(k3[1:], p3[1:])]
    emit("k3_vs_autograd", lanes=n, depth=6, d_rec_max_abs_err=k3_err,
         d_rec_scale=scale, d_rec_err_over_scale=k3_err / scale,
         d_o_lanes_within_rel_1e4=lanes_ok[0],
         d_d_lanes_within_rel_1e4=lanes_ok[1],
         d_rec_light_and_albedo=k3[0][:, [grad.C_LIGHT, grad.C_TEX_E,
                                          grad.C_TEX_E + 1,
                                          grad.C_TEX_E + 2]].tolist())
    check(scale > 0 and k3_err <= 1e-4 * scale,
          f"K3: d_rec off by {k3_err:.3e} at scale {scale:.3e}")
    check(min(lanes_ok) >= 0.99, f"K3: d_o/d_d lanes within 1e-4: {lanes_ok}")
    del p3

    # -- 8. the training path
    buf = io.StringIO()
    tracer.KERNEL_LAUNCHES = tracer.K1BE_LAUNCHES = 0
    grad.K2_LAUNCHES = grad.K3_LAUNCHES = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ir.main(["--device", "cuda", "--steps", "40"])
    wall = time.perf_counter() - t
    train_launches = {"k2_grad_fwd": grad.K2_LAUNCHES,
                      "k3_grad_bwd": grad.K3_LAUNCHES}
    text = buf.getvalue()
    rec_line = re.search(r"max abs err ([0-9.]+)\), emission ([0-9.]+) "
                         r"\(err ([0-9.]+)\)", text)
    step_line = re.search(r"step time: ([0-9.]+)s", text)
    emit("train_path", argv=["--device", "cuda", "--steps", "40"], rc=rc,
         wall_seconds=wall, launches=train_launches,
         albedo_max_abs_err=float(rec_line.group(1)) if rec_line else None,
         emission=float(rec_line.group(2)) if rec_line else None,
         emission_err=float(rec_line.group(3)) if rec_line else None,
         median_step_seconds=float(step_line.group(1)) if step_line else None,
         log=text.splitlines())
    check(all(v > 0 for v in train_launches.values()),
          f"a kernel of the training path never launched: {train_launches}")
    check(rc == 0 and rec_line is not None,
          f"inverse_render.main returned {rc}")

    # -- 9. times at the training step's full width
    k2_ms = cuda_ms(lambda: grad.grad_fwd(rec, o, d, u, cfg, 6), reps=20)
    k3_ms = cuda_ms(lambda: grad.grad_bwd(rec, o, d, u, ct, cfg, 6), reps=20)
    p2_ms = cuda_ms(lambda: grad.trace_tiles_plain(rec, o, d, u, cfg, 6),
                    reps=3)
    p3_ms = cuda_ms(lambda: grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg,
                                                       6), reps=3)
    scene = ir.build_scene(ir.START_ALBEDO, ir.START_EMIT, device=dev)
    light_tex, box_tex = ir.param_tex_rows(scene)
    albedo = torch.tensor(ir.START_ALBEDO, device=dev, requires_grad=True)
    emission = torch.tensor(ir.START_EMIT, device=dev, requires_grad=True)

    cam = ir.camera(dev)

    def step():
        oo, dd, uu = ir.step_inputs(cam, 1, device=dev, **kw)
        ir.path_matched_loss(target, scene, light_tex, box_tex, albedo,
                             emission, oo, dd, uu, block=4096, spp=64,
                             max_depth=6, cfg=cfg).backward()
    step_ms = cuda_ms(step, reps=10)
    emit("grad_times", lanes=n, depth=6, k2_ms=k2_ms, k3_ms=k3_ms,
         plain_fwd_ms=p2_ms, plain_fwd_bwd_ms=p3_ms, step_ms=step_ms,
         kernel_fwd_bwd_sample_paths_per_s=n / ((k2_ms + k3_ms) * 1e-3),
         plain_fwd_bwd_sample_paths_per_s=n / (p3_ms * 1e-3),
         step_candidate_sample_paths_per_s=n / (step_ms * 1e-3))

    # -- 10. K1b/K1e vs plain at each sphere preset's size, 2 spp, depth 50
    def within(a, b):
        return float(torch.isclose(a, b, rtol=1e-4, atol=0.0)
                     .all(dim=0).double().mean())

    k1be = {}
    for scene in ("random_spheres", "two_spheres"):
        p = PRESETS[scene]
        nx, ny = p.nx, p.ny
        srec = tracer.build_scene_record(p.build())
        ops = tracer.trace_operands(
            srec, tracer.build_camera_record(p.camera()), dev)
        kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=2, max_depth=50)

        def sums():
            return torch.zeros((3, nx * ny), dtype=torch.float64, device=dev)

        k = tracer.trace(ops, sums(), **kw)
        pl = sums()
        pl_ms = cuda_ms(lambda: tracer.trace_plain(ops, pl.zero_(), **kw),
                        reps=1, warm=False)
        check(bool(torch.isfinite(k).all()),
              f"{scene}: K1b/K1e sums are not finite")
        agree = within(k, pl)
        km, pm = k.mean(dim=1), pl.mean(dim=1)
        mean_rel = float(((km - pm).abs() / pm.abs()).max())
        err = float((k - pl).abs().max())
        s_k = sums()
        k_ms = cuda_ms(lambda: tracer.trace(ops, s_k.zero_(), **kw), reps=3)
        cull = {}
        if ops.leaves.shape[0]:
            flat = dataclasses.replace(ops, leaves=ops.leaves[:0])
            kf = tracer.trace(flat, sums(), **kw)
            cull = dict(
                pixels_within_rel_1e4_without_cull=within(kf, pl),
                pixels_equal_with_and_without_cull=float(
                    (k == kf).all(dim=0).double().mean()),
                kernel_without_cull_ms=cuda_ms(
                    lambda: tracer.trace(flat, s_k.zero_(), **kw), reps=1))
            del kf
        emit("k1be_vs_plain", scene=scene, shape=[ny, nx], spp=2, depth=50,
             feats=ops.feats, unrolled=len(srec.kinds),
             dynamic=int(ops.dyn.shape[0]), leaves=int(ops.leaves.shape[0]),
             pixels_within_rel_1e4=agree, kernel_channel_means=km.tolist(),
             plain_channel_means=pm.tolist(), channel_mean_max_rel=mean_rel,
             max_abs_err=err, kernel_ms=k_ms, plain_ms=pl_ms,
             kernel_primary_rays_per_s=nx * ny * 2 / (k_ms * 1e-3), **cull)
        check(agree >= 0.99, f"{scene}: K1b/K1e: only {agree:.4%} of pixels "
              "agree")
        check(mean_rel <= 1e-4,
              f"{scene}: K1b/K1e: channel means differ by {mean_rel:.2e}")
        k1be[scene] = dict(max_abs_err=err, ms=k_ms, plain_ms=pl_ms)
        del k, pl, s_k

    # -- 11, 12. the sphere scenes' render path, through the command line
    sphere_launches = {}
    for scene, mean in (("random_spheres", RANDOM_SPHERES_MEAN),
                        ("two_spheres", TWO_SPHERES_MEAN)):
        p = PRESETS[scene]
        band = (0.95 * mean, 1.05 * mean)
        info, img = run_cli(scene)
        sphere_launches[scene] = info["launches"]
        lum = info["mean_luminance"]
        emit(f"{scene}_path", **info, spp=p.spp, wall_primary_rays_per_s=(
            p.nx * p.ny * p.spp / info["wall_seconds"]), band=list(band))
        check(info["launches"]["k1be_sphere_trace"] > 0,
              f"{scene}: the K1b/K1e kernel never launched: {info['launches']}")
        check(img.shape == (p.ny, p.nx, 3)
              and bool(((img >= 0) & (img <= 1)).all()),
              f"{scene}: image has the wrong shape or range")
        check(band[0] < lum < band[1],
              f"{scene}: mean luminance {lum:.4f} outside {band}")

    print(json.dumps({"kernels": [{
        "name": "k1a_static_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": launches["k1a_static_trace"],
        "max_abs_err": max_abs_err, "ms": k_ms_k1a, "plain_ms": p_ms}, {
        "name": "k1be_sphere_trace", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/tracer.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_tracer.py:2787",
        "launches": sum(v["k1be_sphere_trace"]
                        for v in sphere_launches.values()),
        "max_abs_err": max(v["max_abs_err"] for v in k1be.values()),
        "ms": k1be["random_spheres"]["ms"],
        "plain_ms": k1be["random_spheres"]["plain_ms"]}, {
        "name": "k2_grad_fwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:557",
        "launches": train_launches["k2_grad_fwd"],
        "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": p2_ms}, {
        "name": "k3_grad_bwd", "route": "cuda",
        "source": "raytracing_rust_tpu_torch/csrc/grad.cu",
        "replaces": "raytracing_rust_tpu/ops/pallas_grad.py:567",
        "launches": train_launches["k3_grad_bwd"],
        "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": p3_ms}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
