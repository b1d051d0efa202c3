"""The port's command line: `python -m raytracing_rust_tpu_torch`."""

import dataclasses

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
