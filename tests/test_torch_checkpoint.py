"""Checkpoint and resume in the port, on both engines, on the CPU.

A render killed after some chunks (the kernel engine, `render_kernel`) or
pixel blocks (the general tier, `render.render`) through the test hooks
`_stop_after_chunks` / `_stop_after_blocks` (as if the process had died:
the checkpoint on disk is all that is left) and resumed equals an
uninterrupted render byte for byte, its PPM included. The kernel's sums do
not depend on the chunking, so a resume with another spp_chunk equals it
too; the general tier's do not depend on the blocks or chunks. A
checkpoint written for another render (seed, scene, camera, engine) is
reported on stderr and the render starts over, where the JAX package
drops it silently (`tests/test_checkpoint.py` holds JAX's side).
"""

import dataclasses

import numpy as np
import pytest

from raytracing_rust_tpu_torch import checkpoint as ck
from raytracing_rust_tpu_torch import cli
from raytracing_rust_tpu_torch.models.builders import PRESETS
from raytracing_rust_tpu_torch.ops import tracer
from raytracing_rust_tpu_torch.render import render
from raytracing_rust_tpu_torch.utils.image_io import read_ppm, to_ppm
import torch_threads  # noqa: F401  (one torch thread a process)


def _preset(name, nx, ny):
    p = dataclasses.replace(PRESETS[name], nx=nx, ny=ny)
    return p.build(), p.camera()


def _kernel(scene, cam, seed=5, **kw):
    return tracer.render_kernel(scene, cam, 16, 16, 8, device="cpu",
                                seed=seed, **kw)


def _general(scene, cam, seed=5, **kw):
    return render(scene, cam, 16, 16, 4, device="cpu", seed=seed,
                  max_depth=8, **kw)


@pytest.mark.parametrize("resume_chunk", [2, 3])
def test_kernel_resume_is_byte_identical(tmp_path, resume_chunk):
    """The kernel engine (its plain version) on cornell_box 16×16×8: killed
    after 2 of 4 chunks of 2 samples, the checkpoint holds done = 4;
    resumed with spp_chunk 2, or 3, the image and its PPM equal the
    uninterrupted render's."""
    scene, cam = _preset("cornell_box", 16, 16)
    full = _kernel(scene, cam, spp_chunk=2)
    path = str(tmp_path / "k.npz")
    assert _kernel(scene, cam, spp_chunk=2, checkpoint=path,
                   _stop_after_chunks=2) is None
    with np.load(path) as z:
        assert int(z["done"]) == 4 and z["sums"].shape == (3, 256)
    resumed = _kernel(scene, cam, spp_chunk=resume_chunk, checkpoint=path)
    np.testing.assert_array_equal(resumed, full)
    assert to_ppm(resumed) == to_ppm(full)


@pytest.mark.parametrize("block,chunk", [(64, None), (100, 1)])
def test_general_resume_is_byte_identical(tmp_path, block, chunk):
    """The general tier on two_spheres 16×16×4: killed after 2 blocks of 64
    pixels, the checkpoint holds next_pixel = 128; resumed with blocks of
    64, or of 100 pixels and chunks of 1 sample, the image and its PPM
    equal the uninterrupted render's."""
    scene, cam = _preset("two_spheres", 16, 16)
    full = _general(scene, cam)
    path = str(tmp_path / "g.npz")
    assert _general(scene, cam, block_pixels=64, checkpoint=path,
                    _stop_after_blocks=2) is None
    with np.load(path) as z:
        assert int(z["next_pixel"]) == 128
    resumed = _general(scene, cam, block_pixels=block, spp_chunk=chunk,
                       checkpoint=path)
    np.testing.assert_array_equal(resumed, full)
    assert to_ppm(resumed) == to_ppm(full)


@pytest.mark.parametrize("engine", ["kernel", "general"])
@pytest.mark.parametrize("change", ["seed", "scene", "camera", "engine"])
def test_meta_mismatch_warns_and_starts_over(tmp_path, capsys, engine,
                                             change):
    """A checkpoint of another render (another seed, scene, camera, or the
    other engine's) is not merged: the render warns on stderr and its image
    equals a fresh render's."""
    scene, cam = _preset("cornell_box", 16, 16)
    run = _kernel if engine == "kernel" else _general
    other = _general if engine == "kernel" else _kernel
    path = str(tmp_path / "m.npz")
    if change == "engine":
        other(scene, cam, checkpoint=path)
    else:
        s2, c2 = scene, cam
        if change == "scene":
            s2, _ = _preset("cornell_smoke", 16, 16)
        if change == "camera":
            c2 = dataclasses.replace(cam, lens_radius=cam.lens_radius + 1.0)
        run(s2, c2, checkpoint=path, **({"seed": 6} if change == "seed"
                                        else {}))
    capsys.readouterr()
    got = run(scene, cam, checkpoint=path)
    assert "starting over" in capsys.readouterr().err
    np.testing.assert_array_equal(got, run(scene, cam))


def test_meta_keys_on_what_changes_the_image():
    """The meta differs for each field that changes an image and for the
    engine, and holds the scene digest and the camera bytes."""
    base = dict(engine=ck.ENGINE_KERNEL, nx=8, ny=8, spp=4, seed=0,
                max_depth=50, rr_depth=None, digest=b"d" * 32,
                cam_bytes=b"c" * 84)
    ref = ck.meta(**base)
    for k, v in [("engine", ck.ENGINE_GENERAL), ("nx", 9), ("spp", 5),
                 ("seed", 1), ("max_depth", 8), ("rr_depth", 3),
                 ("digest", b"e" * 32), ("cam_bytes", b"x" * 84)]:
        assert not np.array_equal(ck.meta(**{**base, k: v}), ref), k
    a, _ = _preset("earth", 8, 8)
    b = dataclasses.replace(a, compat_uv_bug=True)
    assert ck.scene_digest(a) != ck.scene_digest(b)


@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_cli_checkpoint_round_trips(tmp_path, engine):
    """`render --checkpoint PATH` on either engine writes the checkpoint,
    and a second run from it (nothing left to trace) writes the same PPM
    bytes as the first."""
    path = str(tmp_path / "c.npz")
    outs = []
    for i in range(2):
        out = tmp_path / f"{i}.ppm"
        assert cli.main(["render", "--scene", "two_spheres", "--nx", "16",
                         "--ny", "9", "--spp", "2", "--device", "cpu",
                         "--engine", engine, "--checkpoint", path,
                         "--out", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert read_ppm(str(tmp_path / "0.ppm")).shape == (9, 16, 3)
