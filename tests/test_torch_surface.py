"""The port's tool surface: the logger, the progress bar and its hooks,
`benchlib.run` and its parts, and the five tool modules.

The logger and the bar are held to the JAX package's on the same calls,
with the clock and the terminal fixed; the progress hooks to the same
render without them, bit for bit; `alive_profile` to JAX's `profile`
within binomial error (the draws differ); `bench_scaling` at two gloo
ranks to one rank, bit for bit. The rest runs at a tiny size on the CPU
(its timing means nothing here) and is held to its contract: the keys,
the counts, the files.
"""

import dataclasses
import datetime
import importlib.util
import io
import json
import math
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracing_rust_tpu.utils import logger as jax_logger
from raytracing_rust_tpu.utils import progress as jax_progress
from raytracing_rust_tpu_torch import (alive_profile, bench_scaling,
                                       bench_scenes, benchlib,
                                       inverse_render, make_gallery,
                                       profile_train_step, render)
from raytracing_rust_tpu_torch.models.builders import PRESETS
from raytracing_rust_tpu_torch.ops import tracer
from raytracing_rust_tpu_torch.parallel import sharding
from raytracing_rust_tpu_torch.utils import logger, progress
import torch_threads  # noqa: F401  (one torch thread a process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# `benchlib.run`'s keys (JAX's run's, raytracing_rust_tpu/benchlib.py)
RUN_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline_rays_per_sec",
    "baseline_source", "median_rays_per_sec", "wall_seconds",
    "wall_seconds_all_reps", "engine", "grad_fd_max_abs_err",
    "grad_fd_per_leaf", "grad_samples_per_sec", "grad_samples_per_sec_median",
    "grad_step_seconds", "grad_step_seconds_all_reps", "grad_engine",
    "grad_config", "grad_samples_per_sec_chunk100",
    "grad_step_seconds_chunk100", "grad_samples_per_sec_xla_scan",
    "grad_step_seconds_xla_scan", "device"}
# a tiny training step for `benchlib.run` on the CPU
TINY_GRAD = dict(block=64, spp=4, chunk=2, reps=1)


class _FixedClock:
    """A stand-in for the `datetime` module whose now() is fixed."""

    class datetime:
        @staticmethod
        def now():
            return datetime.datetime(2026, 1, 2, 3, 4, 5)


def _log_calls(mod, path):
    """The same calls on a logger of `mod` → the file's text."""
    lg = mod.Logger(str(path), mod.LogLevel.INFO)
    lg.write("default level")
    lg.write("dropped", mod.LogLevel.DEBUG)
    lg.write("an error", mod.LogLevel.ERROR)
    lg.set_level(mod.LogLevel.WARNING)
    lg.write("dropped too", mod.LogLevel.INFO)
    lg.write("kept", mod.LogLevel.WARNING)
    lg.write("the logger's level now")
    with open(path) as fh:
        return fh.read()


def test_logger_lines_equal_jax(tmp_path, monkeypatch):
    """Same lines as JAX's logger, directories made, levels filtered; with
    the clock fixed, the same bytes; with it running, the same once the
    stamps are stripped."""
    for mod in (logger, jax_logger):
        monkeypatch.setattr(mod, "datetime", _FixedClock)
    ours = _log_calls(logger, tmp_path / "a" / "b" / "port.log")
    want = _log_calls(jax_logger, tmp_path / "jax" / "jax.log")
    assert ours == want
    assert ours.splitlines() == [
        "2026-01-02 03:04:05 [INFO] - default level",
        "2026-01-02 03:04:05 [ERROR] - an error",
        "2026-01-02 03:04:05 [WARNING] - kept",
        "2026-01-02 03:04:05 [WARNING] - the logger's level now"]
    monkeypatch.undo()
    ours = _log_calls(logger, tmp_path / "port2.log").splitlines()
    want = _log_calls(jax_logger, tmp_path / "jax2.log").splitlines()
    assert [ln[19:] for ln in ours] == [ln[19:] for ln in want]


@pytest.mark.parametrize("columns", [20, 80, 200])
def test_progress_bar_equals_jax(monkeypatch, columns):
    """The bar's text equals JAX's for the same calls, at a fixed clock
    and terminal width: the bar, the percentage, the time left, and one
    newline when done reaches total."""
    clock = iter(np.arange(0.0, 100.0, 0.75))
    monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)))
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=None: os.terminal_size((columns, 20)))
    text = {}
    for name, mod in (("port", progress), ("jax", jax_progress)):
        buf = io.StringIO()
        bar = mod.ProgressBar("cornell_box", stream=buf)
        for done in (0, 1, 3, 7, 7):
            bar(done, 7)
        text[name] = buf.getvalue()
    assert text["port"] == text["jax"]
    assert text["port"].count("100.0%") == 2
    assert text["port"].count("\n") == 2


def _renders(engine: str, hook):
    """cornell_box 12×10, 3 spp, depth 6, split into several progress
    units, through `engine` with the hook (or None)."""
    p = dataclasses.replace(PRESETS["cornell_box"], nx=12, ny=10)
    scene, cam = p.build(), p.camera()
    kw = dict(device="cpu", max_depth=6, seed=2, progress=hook)
    if engine == "kernel":
        return tracer.render_kernel(scene, cam, 12, 10, 3, spp_chunk=1, **kw)
    if engine == "xla":
        return render.render(scene, cam, 12, 10, 3, block_pixels=48,
                             spp_chunk=2, **kw)
    with sharding.process_group("cpu"):
        return sharding.render_sharded(scene, cam, 12, 10, 3,
                                       sharding.make_mesh(), **kw)


@pytest.mark.parametrize("engine,units", [("kernel", 3), ("xla", 3 * 2),
                                          ("sharded", 1)])
def test_progress_hook_leaves_the_image_bit_equal(engine, units):
    """A render with a progress hook is the render without it bit for bit;
    the hook is called once per unit of work (a sample chunk; a pixel
    block's sample chunk; rank 0's units at one gloo rank), rising to
    (total, total)."""
    calls = []
    img = _renders(engine, lambda done, total: calls.append((done, total)))
    ref = _renders(engine, None)
    assert np.array_equal(img, ref)
    total = calls[-1][1]
    assert calls == [(i + 1, total) for i in range(units)]
    if engine == "kernel":
        assert total == 3  # samples


def test_reference_baseline_is_jax_file():
    """The port's copy of the C++ mirror's record is JAX's byte for byte,
    and `reference_baseline` reads its rate."""
    with open(benchlib.REF_BASELINE_PATH, "rb") as a, open(os.path.join(
            ROOT, "raytracing_rust_tpu", "native", "ref_baseline.json"),
            "rb") as b:
        ours = a.read()
        assert ours == b.read()
    rate, source = benchlib.reference_baseline()
    assert rate == json.loads(ours)["rays_per_sec"] == 1006571.6
    assert source.startswith("measured (recorded 2026-08-19, ")


def test_run_on_the_cpu_returns_every_key():
    """`benchlib.run(device="cpu")` at 16×16×2 with a tiny training step:
    JAX's keys, the kernel engine's 8 timed reps, the fused tier with its
    100-step-chunk and general-tier keys, and grad_samples_per_sec equal
    to 2·block·spp over grad_step_seconds."""
    res = benchlib.run(nx=16, ny=16, spp=2, device="cpu", grad=TINY_GRAD)
    assert set(res) == RUN_KEYS
    assert json.loads(benchlib.to_json(res)) == res
    assert res["engine"] == "kernel" and res["device"] == "cpu"
    assert len(res["wall_seconds_all_reps"]) == benchlib.KERNEL_REPS
    assert res["wall_seconds"] == min(res["wall_seconds_all_reps"])
    assert res["value"] == pytest.approx(16 * 16 * 2 / res["wall_seconds"],
                                         abs=0.05)
    assert res["metric"] == ("primary rays/sec/chip (cornell_box_baseline "
                             "16x16 2spp)")
    assert res["grad_engine"] == "fused"
    paths = 2 * TINY_GRAD["block"] * TINY_GRAD["spp"]
    assert res["grad_samples_per_sec"] == pytest.approx(
        paths / res["grad_step_seconds"], abs=0.05)
    assert len(res["grad_step_seconds_all_reps"]) == TINY_GRAD["reps"]
    assert 0.0 <= res["grad_fd_max_abs_err"] <= 1e-3
    assert set(res["grad_fd_per_leaf"]) == {
        label for label, *_ in benchlib.FD_SWEEPS}
    for key in ("grad_samples_per_sec_chunk100",
                "grad_samples_per_sec_xla_scan"):
        assert math.isfinite(res[key]) and res[key] > 0


def test_grad_throughput_general_tier():
    """`grad_throughput(engine="xla")` times the general tier's step; the
    chunks are of `chunk` steps after a warm one."""
    res = benchlib.grad_throughput(reps=2, chunk=1, block=32, spp=2,
                                   max_depth=3, engine="xla", device="cpu",
                                   nx=16, ny=16)
    assert res["grad_engine"] == "general"
    assert len(res["grad_step_seconds_all_reps"]) == 2
    assert res["grad_samples_per_sec"] == pytest.approx(
        2 * 32 * 2 / res["grad_step_seconds"], abs=0.05)
    with pytest.raises(ValueError):
        benchlib.grad_throughput(engine="kernel", device="cpu")


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        benchlib.run(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        benchlib.grad_throughput(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        alive_profile.profile("cornell_box", 16)


def _tiny_configs(monkeypatch, mod):
    monkeypatch.setattr(mod, "CONFIGS", [("cornell_box", 8, 8, 2),
                                         ("random_spheres", 16, 9, 8)])


def test_bench_scenes_prints_a_line_a_config(monkeypatch, capsys):
    """A line a config with its seconds and rays/s, then the rows as JSON;
    random_spheres at spp ≥ 8 takes the balanced path (its pixel table)."""
    _tiny_configs(monkeypatch, bench_scenes)
    tables, make = [], tracer.render_table
    monkeypatch.setattr(tracer, "render_table",
                        lambda *a, **k: tables.append(a[1:3]) or make(*a, **k))
    monkeypatch.setattr(tracer, "_PERM_CACHE", {})
    assert bench_scenes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("cornell_box: 8x8x2 best ")
    assert lines[1].startswith("random_spheres: 16x9x8 best ")
    rows = json.loads(lines[2])["rows"]
    assert [r["scene"] for r in rows] == ["cornell_box", "random_spheres"]
    for r in rows:
        assert r["seconds"] == min(r["seconds_all_reps"])
        assert len(r["seconds_all_reps"]) == bench_scenes.REPS
        assert r["primary_rays_per_s"] == pytest.approx(
            r["nx"] * r["ny"] * r["spp"] / r["seconds"])
    assert tables == [(16, 9)]  # the warm render's probe, cached


def test_make_gallery_writes_pngs(monkeypatch, tmp_path, capsys):
    """One PNG a config in the directory named, at its size; the default
    directory is output/gallery, never docs/gallery."""
    from PIL import Image

    _tiny_configs(monkeypatch, make_gallery)
    assert make_gallery.main([str(tmp_path), "--device", "cpu"]) == 0
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"]
    for r in rows:
        with Image.open(tmp_path / f"{r['scene']}.png") as im:
            assert im.size == (r["nx"], r["ny"])
        assert 0.0 < r["mean"] < 1.0
    assert sorted(os.listdir(tmp_path)) == ["cornell_box.png",
                                            "random_spheres.png"]
    assert make_gallery.DEFAULT_OUTDIR == os.path.join("output", "gallery")


@pytest.mark.parametrize("scene", ["cornell_box", "two_spheres"])
def test_alive_profile_agrees_with_jax(scene):
    """The alive fraction at each bounce of 4,096 lanes against JAX's
    `profile` at the same n and depth 50: within 4 binomial standard
    errors, √(p(1−p)/n) of each run added in quadrature (the two runs
    draw their pixels and paths independently); set from the binomial
    model, not from these runs. JAX's bounce runs compiled (`jax.jit`, the
    depth cap static), as JAX's own integrator runs it: op by op it takes
    three times as long."""
    import jax

    spec = importlib.util.spec_from_file_location(
        "jax_alive_profile", os.path.join(ROOT, "tools", "alive_profile.py"))
    jax_alive = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_alive)
    jax_alive._bounce = jax.jit(jax_alive._bounce, static_argnums=(3,))
    n = 4096
    ours = alive_profile.profile(scene, n, device="cpu")
    want = jax_alive.profile(scene, n)
    k = min(len(ours["alive"]), len(want["alive"]))
    assert k >= 30 and ours["alive"][0] == want["alive"][0] == 1.0
    p, q = ours["alive"][:k], want["alive"][:k]
    se = np.sqrt(p * (1 - p) / n + q * (1 - q) / n)
    assert (np.abs(p - q) <= 4 * se).all(), np.abs(p - q) / np.maximum(se,
                                                                       1e-12)
    assert ours["mean_path"] == pytest.approx(ours["alive"].sum())
    assert ours["waste"] == pytest.approx(ours["bounces_run"]
                                          / ours["mean_path"])
    assert alive_profile.line(ours).startswith(f"{scene:20s} bounces_run=")


def test_bench_scaling_two_ranks_split_the_lanes():
    """At two gloo ranks each rank traces half the block's lanes, and the
    block's sums equal one rank's bit for bit (the sharded block render in
    this process, one rank)."""
    n_pix, spp, depth = 256, 4, 4
    res = bench_scaling.run_ranks(2, n_pix=n_pix, spp=spp, depth=depth,
                                  reps=1, timeout=240)
    assert res["ranks"] == 2 and res["lanes"] == [n_pix * spp // 2] * 2
    p = PRESETS[bench_scaling.SCENE]
    ref = sharding.render_block_sharded(
        p.build(), p.camera(), torch.arange(n_pix), bench_scaling.SEED,
        p.nx, p.ny, spp, depth)
    assert np.array_equal(res["sums"], ref.numpy())
    assert not dist.is_initialized()


def test_profile_train_step_parts(capsys):
    """Both tiers' parts at a tiny width: every part timed, the parts that
    partition a step named, the shares of the whole step; the table and
    one JSON line."""
    argv = ["--device", "cpu", "--nx", "16", "--ny", "16", "--block", "32",
            "--spp", "2", "--depth", "3", "--steps", "1"]
    assert profile_train_step.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    tiers = json.loads(lines[-1])["tiers"]
    assert lines[0].startswith("fused tier (")
    fused, general = tiers["fused"], tiers["general"]
    assert set(fused["parts"]) == {"step_inputs", "fwd_bwd", "records",
                                   "kernels", "glue", "adam"}
    assert set(general["parts"]) == {"pixels", "target", "fwd_bwd", "fwd",
                                     "adam"}
    for r in (fused, general):
        assert r["parts_sum"] == pytest.approx(
            sum(r["parts"][k] for k in r["summed"]))
        assert r["parts_over_step"] == pytest.approx(r["parts_sum"]
                                                     / r["step"])
        assert all(v > 0 for k, v in r["parts"].items() if k != "glue")
    assert fused["parts"]["glue"] == pytest.approx(
        fused["parts"]["fwd_bwd"] - fused["parts"]["records"]
        - fused["parts"]["kernels"])
    with pytest.raises(ValueError, match="fused tier does not take"):
        profile_train_step.profile("fused", max_depth=17, nx=16, ny=16,
                                   block=32, spp=2, device="cpu")



# the profile's tiny step: 16×16, a block of 32 pixels × 2 spp, depth 3
TINY_STEP = dict(nx=16, ny=16, block=32, spp=2, max_depth=3, device="cpu")


@pytest.mark.parametrize("tier", ["fused", "general"])
def test_profiled_step_is_the_trainers_step(tier):
    """The split step `profile_train_step` times is the trainer's step with
    its `mark` hook: three steps with the hook give the loss, the leaves'
    .grad and the updated leaves of three steps without it, bit for bit,
    and the hook sees the tier's parts in order, once each a step."""
    runs = [inverse_render.default_run(fast=tier == "fused", **TINY_STEP)
            for _ in range(2)]
    opts = [inverse_render.optimizer(r.groups, 10) for r in runs]
    seen = []
    for i in range(3):
        marks = profile_train_step.Marks(torch.device("cpu"))
        split = inverse_render.update(*opts[0], runs[0].groups, runs[0].step,
                                      i, mark=marks)
        whole = inverse_render.update(*opts[1], runs[1].groups, runs[1].step,
                                      i)
        seen.append(list(marks.parts))
        assert torch.equal(split, whole)
        for a, b in zip(runs[0].groups, runs[1].groups):
            assert torch.equal(a[0].grad, b[0].grad)
            assert torch.equal(a[0], b[0])
    parts = (profile_train_step.FUSED_PARTS if tier == "fused"
             else profile_train_step.GENERAL_PARTS)
    assert runs[0].tier == tier and seen == [list(parts)] * 3


def test_profile_train_step_trace_takes_one_tier(tmp_path, capsys):
    """--trace with both tiers exits 2 (the profiler would record the
    card in the first tier's session alone); with one tier it writes
    DIR/train_step_<tier>.trace.json, naming the step's aten ops."""
    argv = ["--device", "cpu", "--nx", "16", "--ny", "16", "--block", "32",
            "--spp", "2", "--depth", "3", "--steps", "1", "--trace",
            str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        profile_train_step.main(argv)
    assert e.value.code == 2
    assert "--trace takes one tier" in capsys.readouterr().err
    assert profile_train_step.main(argv + ["--tier", "fused"]) == 0
    tiers = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "tiers"]
    path = tmp_path / "train_step_fused.trace.json"
    assert tiers["fused"]["trace"] == str(path)
    with open(path) as fh:
        names = {ev.get("name", "") for ev in json.load(fh)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
