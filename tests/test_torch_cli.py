"""The port's command line: `python -m raytracing_rust_tpu_torch`."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from raytracing_rust_tpu_torch import cli
from raytracing_rust_tpu_torch.models.builders import PRESETS
from raytracing_rust_tpu_torch.models.scene import BG_BLACK, SceneBuilder
from raytracing_rust_tpu_torch.utils.image_io import read_ppm
import torch_threads  # noqa: F401  (one torch thread a process)


def test_scenes_lists_every_preset(capsys):
    assert cli.main(["scenes"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert names == list(PRESETS)


def test_render_cpu_writes_a_valid_p3(tmp_path, capsys):
    out = tmp_path / "cornell.ppm"
    rc = cli.main(["render", "--scene", "cornell_box", "--nx", "32", "--ny",
                   "18", "--spp", "2", "--device", "cpu", "--out", str(out),
                   "--timers"])
    assert rc == 0
    text = out.read_text()
    assert text.startswith("P3\n32 18\n255\n")
    assert len(text.split()) == 4 + 32 * 18 * 3
    img = read_ppm(str(out))
    assert img.shape == (18, 32, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() < 1.0
    printed = capsys.readouterr().out
    assert "primary rays/s" in printed and "trace" in printed


def test_render_cpu_random_spheres(tmp_path):
    """The sky, the checker, metal, glass, moving spheres and the dynamic
    sphere table through the command line (the kernel's plain version)."""
    out = tmp_path / "random_spheres.ppm"
    rc = cli.main(["render", "--scene", "random_spheres", "--nx", "16",
                   "--ny", "9", "--spp", "2", "--max-depth", "8", "--device",
                   "cpu", "--out", str(out)])
    assert rc == 0
    img = read_ppm(str(out))
    assert img.shape == (9, 16, 3) and np.isfinite(img).all()
    assert 0.3 < img.mean() < 0.9


@pytest.mark.parametrize("scene,lo,hi", [
    ("two_perlin_spheres", 0.4, 0.8), ("simple_light", 0.02, 0.4),
    ("earth", 0.5, 0.95), ("cornell_smoke", 0.05, 0.6)])
def test_render_cpu_next_week(tmp_path, scene, lo, hi):
    """The Perlin marble, the image texture and the smoke boxes through the
    command line (the kernel's plain version), at a tiny size."""
    out = tmp_path / f"{scene}.ppm"
    rc = cli.main(["render", "--scene", scene, "--nx", "16", "--ny", "12",
                   "--spp", "4", "--max-depth", "8", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    img = read_ppm(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert lo < img.mean() < hi


def test_render_cpu_final_scene(tmp_path):
    """final_scene's boxes, dynamic spheres, textures, media and the
    dense-medium walk through the command line (the kernel's plain
    version), at a tiny size."""
    out = tmp_path / "final_scene.ppm"
    rc = cli.main(["render", "--scene", "final_scene", "--nx", "10", "--ny",
                   "10", "--spp", "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_ppm(str(out))
    assert img.shape == (10, 10, 3) and np.isfinite(img).all()
    assert 0.02 < img.mean() < 0.8


def _rotated_image_sphere_scene(device="cpu"):
    b = SceneBuilder(background=BG_BLACK)
    xf = b.transform(rotate_axis="y", angle_deg=30.0)
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.image(
        np.random.default_rng(3).integers(0, 256, (4, 6, 3), np.uint8))),
        xform=xf)
    return b.build(device)


def test_render_outside_the_kernel_exits_nonzero(tmp_path, capsys,
                                                 monkeypatch):
    """Every preset renders; on the kernel engine (`--engine kernel`) a
    scene outside the kernel (here a preset patched to an image on a
    rotated sphere, which the JAX kernel refuses too) exits 2 with the
    reason, with no CPU or plain fallback and no image. (`--engine auto`,
    the default, renders it on the general tier:
    tests/test_torch_general.py.)"""
    p = PRESETS["cornell_box"]
    monkeypatch.setitem(PRESETS, "cornell_box", dataclasses.replace(
        p, build=_rotated_image_sphere_scene))
    rc = cli.main(["render", "--scene", "cornell_box", "--nx", "8",
                   "--ny", "8", "--spp", "1", "--device", "cpu",
                   "--engine", "kernel", "--out", str(tmp_path / "x.ppm")])
    assert rc == 2
    assert "rotated sphere" in capsys.readouterr().err
    assert not (tmp_path / "x.ppm").exists()


def test_render_cpu_rr_depth(tmp_path):
    """`render --rr-depth N` (Russian roulette) through the command line
    (the kernel's plain version), and a negative depth exits 2."""
    out = tmp_path / "cornell_rr.ppm"
    rc = cli.main(["render", "--scene", "cornell_box", "--nx", "16", "--ny",
                   "16", "--spp", "4", "--rr-depth", "3", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    img = read_ppm(str(out))
    assert img.shape == (16, 16, 3) and 0.0 < img.mean() < 1.0
    assert cli.main(["render", "--scene", "cornell_box", "--rr-depth", "-1",
                     "--device", "cpu", "--out", str(out)]) == 2


def test_render_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["render", "--scene", "cornell_box", "--nx", "8", "--ny",
                  "8", "--spp", "1", "--out", str(tmp_path / "x.ppm")])


def test_bench_validates_args(capsys):
    """`bench` rejects an unknown scene and a non-positive spp with exit 2
    and JAX's messages (tests/test_cli.py's test_bench_validates_args)."""
    assert cli.main(["bench", "--scene", "nope"]) == 2
    assert "cornell_box" in capsys.readouterr().err
    assert cli.main(["bench", "--scene", "cornell_box", "--spp", "0"]) == 2
    assert "positive" in capsys.readouterr().err


def test_bench_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["bench", "--spp", "1"])


def _small_render(tmp_path, *extra):
    return ["render", "--scene", "cornell_box", "--nx", "32", "--ny", "32",
            "--spp", "2", "--device", "cpu", "--out",
            str(tmp_path / "c.ppm"), *extra]


# JAX's log lines of a render (raytracing_rust_tpu/cli.py), after the stamp
_STAMP = r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d \[DEBUG\] - "


def test_render_log_appends_jax_lines(tmp_path, capsys):
    """`--log PATH` makes its directory and appends JAX's lines: the
    request, the timers' summary under --timers and the result, a render
    after another."""
    log = tmp_path / "logs" / "render.log"
    for _ in range(2):
        assert cli.main(_small_render(tmp_path, "--log", str(log),
                                      "--timers", "--no-progress")) == 0
    lines = log.read_text().splitlines()
    out = str(tmp_path / "c.ppm")
    pats = [_STAMP + "render scene=cornell_box",
            _STAMP + r"timers: \{'scene_build': [0-9.e-]+, .*'encode': "
                     r"[0-9.e-]+\}",
            _STAMP + r"rendered cornell_box in [0-9]+\.[0-9]s -> "
            + re.escape(out)]
    assert len(lines) == 6
    for ln, pat in zip(lines, pats * 2):
        assert re.fullmatch(pat, ln), (ln, pat)
    capsys.readouterr()


def test_render_progress_bar_on_stderr(tmp_path, capsys):
    """The bar goes to stderr by default and ends at 100.0% with a
    newline; `--no-progress` leaves stderr empty."""
    log = str(tmp_path / "l.log")
    assert cli.main(_small_render(tmp_path, "--log", log)) == 0
    err = capsys.readouterr().err
    assert err.startswith("\rcornell_box |") and err.endswith("s\n")
    assert err.count("100.0%") == 1 and err.count("\n") == 1
    assert cli.main(_small_render(tmp_path, "--log", log,
                                  "--no-progress")) == 0
    assert capsys.readouterr().err == ""


def test_render_profile_writes_a_trace(tmp_path, capsys):
    """`--profile DIR` writes a Chrome trace of the render into DIR that
    names torch's ops, logs its path, and leaves the image as it is."""
    log = tmp_path / "l.log"
    prof = tmp_path / "prof"
    assert cli.main(_small_render(tmp_path, "--log", str(log),
                                  "--no-progress", "--profile",
                                  str(prof))) == 0
    img = read_ppm(str(tmp_path / "c.ppm"))
    with open(prof / "cornell_box.trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    said = [ln.split(" - ", 1)[1] for ln in log.read_text().splitlines()]
    assert said[:2] == ["render scene=cornell_box",
                        f"profiler trace -> {prof / 'cornell_box.trace.json'}"]
    assert cli.main(_small_render(tmp_path, "--log", str(log),
                                  "--no-progress")) == 0
    assert np.array_equal(read_ppm(str(tmp_path / "c.ppm")), img)
    capsys.readouterr()


def test_render_log_names_the_fallback(tmp_path, monkeypatch, capsys):
    """`--engine auto` on a scene the kernel refuses logs the fallback to
    the general tier, as JAX's CLI logs its Pallas fallback."""
    p = PRESETS["cornell_box"]
    monkeypatch.setitem(PRESETS, "cornell_box", dataclasses.replace(
        p, build=_rotated_image_sphere_scene))
    log = tmp_path / "l.log"
    assert cli.main(["render", "--scene", "cornell_box", "--nx", "8", "--ny",
                     "8", "--spp", "1", "--device", "cpu", "--out",
                     str(tmp_path / "x.ppm"), "--log", str(log),
                     "--no-progress"]) == 0
    said = [ln.split(" - ", 1)[1] for ln in log.read_text().splitlines()]
    assert said[0] == "render scene=cornell_box"
    assert said[1].startswith("kernel unsupported (") and said[1].endswith(
        "); falling back to xla")
    assert capsys.readouterr().err.count("\n") == 1
