"""The port's BVH (`accel/bvh.py`), large scenes and `--bvh` against the JAX
package's, on the CPU.

* `prim_aabbs` and `build_bvh` equal JAX's numpy build array for array, bit
  for bit (float64 boxes, the f32 node bounds rounded outward, children,
  counts and the padded prim order), at leaf sizes 4 and 8, on the
  recipe of tests/test_bvh.py (spheres, moving spheres, rotated cubes),
  random_spheres, final_scene and big_spheres(5000).
* `bvh_closest_hit` picks JAX's prim on every lane of the same rays, with
  JAX's t (tolerance 1e-6 relative). JAX's traversal is taken op by op
  (`jax.disable_jit`): compiled, XLA:CPU contracts a·b + c into FMAs
  inside its loop, and a near-tangent ray's quadratic then picks another
  prim than the same arithmetic rounded op by op, which the port's eager
  ops and the dense scan both do.
* Against the port's dense `closest_hit` on each scene: the same mask and
  prim on every lane, t within 1e-4 relative (JAX's gate).
* A BVH render is bit-equal across pixel blocks and sample chunks, and
  matches the dense render on big_spheres(3000) at JAX's gates of
  test_dense_and_bvh_agree_at_12k_prims (means within 2e-3 relative, under
  0.5% of pixels apart by more than 1e-3).
* `auto_use_bvh` on both devices, `trace(differentiable=True, bvh=)`
  refused, the checkpoint meta telling a BVH render from a dense one, the
  CLI's `--bvh` and its exit codes, and `big_spheres`' tables and camera
  against JAX's.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_rust_tpu.accel import bvh as jbvh
from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.models.scene import SceneBuilder as JSceneBuilder
from raytracing_rust_tpu_torch import bench_large
from raytracing_rust_tpu_torch import checkpoint as ck
from raytracing_rust_tpu_torch import cli
from raytracing_rust_tpu_torch import render as trender
from raytracing_rust_tpu_torch.accel import bvh as tbvh
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import SceneBuilder
from raytracing_rust_tpu_torch.ops import integrator
from raytracing_rust_tpu_torch.ops.intersect import closest_hit
import torch_threads  # noqa: F401  (one torch thread a process)

FIELDS = ("node_min", "node_max", "node_left", "node_count", "prim_order")


def _random_scene(builder, seed=17, n_spheres=60, cubes=3, moving=4):
    """tests/test_bvh.py's `_random_scene` recipe on either package's
    builder, from its own generator."""
    rt = np.random.default_rng(seed)
    b = builder()
    m = b.lambertian(b.solid(1, 1, 1))
    for _ in range(n_spheres):
        b.sphere(rt.normal(0, 5, 3), 0.2 + rt.random(), m)
    for _ in range(moving):
        c = rt.normal(0, 5, 3)
        b.moving_sphere(c, c + rt.normal(0, 0.5, 3), 0.0, 1.0, 0.5, m)
    for i in range(cubes):
        p0 = rt.normal(0, 4, 3)
        kw = {}
        if i % 2:
            kw["xform"] = b.transform(offset=rt.normal(0, 2, 3),
                                      rotate_axis="y",
                                      angle_deg=float(rt.uniform(-90, 90)))
        b.cube(p0, p0 + rt.uniform(0.5, 2.0, 3), m, **kw)
    return b.build()


SCENES = {
    "random": (lambda: _random_scene(SceneBuilder),
               lambda: _random_scene(JSceneBuilder)),
    "random_spheres": (tb.random_spheres, jb.random_spheres),
    "final_scene": (tb.final_scene, jb.final_scene),
    "big_spheres_5000": (lambda: tb.big_spheres(5000),
                         lambda: jb.big_spheres(5000)),
}
# where each scene's rays start: around its middle at this distance
_RAY_CENTER = {"random": (0.0, 0.0, 0.0), "random_spheres": (0.0, 0.5, 0.0),
               "final_scene": (278.0, 278.0, 278.0),
               "big_spheres_5000": (0.0, 0.5, 0.0)}
_RAY_SCALE = {"random": 8.0, "random_spheres": 12.0, "final_scene": 500.0,
              "big_spheres_5000": 40.0}


@pytest.fixture(scope="module")
def scenes():
    """Each scene's port build, JAX build and JAX numpy tree, made once."""
    out = {}
    for name, (port, ref) in SCENES.items():
        js = ref()
        out[name] = (port(), js, jbvh.build_bvh(js, prefer_native=False))
    return out


def _rays(name, n, seed=3):
    """n rays aimed through the scene's middle, with shutter times."""
    rng = np.random.default_rng(seed)
    c = np.asarray(_RAY_CENTER[name], np.float64)
    s = _RAY_SCALE[name]
    o = c + rng.normal(0, s, (n, 3))
    d = (c - o) + rng.normal(0, 0.25 * s, (n, 3))
    return (o.astype(np.float32), d.astype(np.float32),
            rng.random(n).astype(np.float32))


def _camera_rays(name, nx=24, ny=16):
    """The preset's (or big_spheres_camera's) camera rays of an nx×ny image,
    one sample a pixel, as the general tier makes them."""
    if name.startswith("big_spheres"):
        cam = tb.big_spheres_camera(5000, nx, ny)
    else:
        cam = dataclasses.replace(tb.PRESETS[name], nx=nx, ny=ny).camera()
    pix = torch.arange(nx * ny)
    return trender.camera_sample_rays(cam, pix, torch.zeros_like(pix), 0, nx,
                                      ny, True)


@pytest.mark.parametrize("name", list(SCENES))
def test_prim_aabbs_and_build_equal_jax(scenes, name):
    """float64 prim boxes equal to JAX's loop; the tree at leaf sizes 4 and
    8 equal to JAX's numpy build, every array bit for bit; the root holds
    every prim's box."""
    port, js, jt4 = scenes[name]
    lo, hi = tbvh.prim_aabbs(port)
    jlo, jhi = jbvh.prim_aabbs(js)
    assert lo.dtype == np.float64
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    for leaf in (4, 8):
        got = tbvh.build_bvh(port, leaf_size=leaf)
        ref = (jt4 if leaf == 4 else
               jbvh.build_bvh(js, leaf_size=leaf, prefer_native=False))
        assert got.leaf_size == leaf
        for f in FIELDS:
            want = np.asarray(getattr(ref, f))
            g = getattr(got, f).numpy()
            assert g.dtype == want.dtype, f
            np.testing.assert_array_equal(g, want, err_msg=f"{f} L={leaf}")
    t = tbvh.build_bvh(port)
    assert (t.node_min[0].double().numpy() <= lo.min(0)).all()
    assert (t.node_max[0].double().numpy() >= hi.max(0)).all()


def test_closest_hit_picks_jax_prim(scenes):
    """The same rays through the port's traversal and JAX's (op by op, see
    the module docstring) on the rotated-cube recipe: the same mask and prim
    on every lane, t within 1e-6 relative."""
    port, js, jt = scenes["random"]
    o, d, tm = _rays("random", 256)
    with jax.disable_jit():
        ref = jbvh.bvh_closest_hit(js, jt, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tm), 1e-3)
    got = tbvh.bvh_closest_hit(port, tbvh.build_bvh(port), torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(tm), 1e-3)
    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    assert mask.sum() > 64
    np.testing.assert_allclose(got.t.numpy()[mask], np.asarray(ref.t)[mask],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(SCENES))
def test_closest_hit_agrees_with_dense(scenes, name):
    """Random rays through the scene and its camera's rays (the preset's
    or big_spheres_camera's): the traversal against the dense scan, the same
    mask and prim on every lane and t within 1e-4 relative; a tree of
    8-wide leaves traverses all 8 slots."""
    port = scenes[name][0]
    o, d, tm = (torch.from_numpy(x) for x in _rays(name, 1024))
    if name != "random":
        co, cd, ct = _camera_rays(name)
        o, d, tm = torch.cat([o, co]), torch.cat([d, cd]), torch.cat([tm, ct])
    dense = closest_hit(port, o, d, tm, 1e-3)
    for leaf in (4, 8):
        got = tbvh.bvh_closest_hit(port, tbvh.build_bvh(port, leaf), o, d,
                                   tm, 1e-3)
        assert torch.equal(got.mask, dense.mask), leaf
        assert torch.equal(got.idx, dense.idx), leaf
        m = got.mask
        assert int(m.sum()) > 256
        torch.testing.assert_close(got.t[m], dense.t[m], rtol=1e-4, atol=0)


def test_masked_iterations_equal_eager_ones(scenes):
    """The card's CUDA graphs replay masked iterations (every lane's leaf
    rows tested, the crossed leaves' kept; no host sync): on the CPU, those
    iterations give the eager ones' t and prim on every lane."""
    port = scenes["final_scene"][0]
    o, d, tm = (torch.from_numpy(x) for x in _rays("final_scene", 1024))
    tab = tbvh._tables(tbvh.build_bvh(port), tbvh.pack_prims(port), 4)
    out = []
    for masked in (False, True):
        t_out = torch.full((1025,), tbvh.BIG)
        i_out = torch.full((1025,), -1, dtype=torch.int64)
        lanes = tbvh._Lanes(
            lane=torch.arange(1024),
            stack=torch.zeros((1024, tbvh.MAX_STACK), dtype=torch.int32),
            sp=torch.ones(1024, dtype=torch.int64), t_best=t_out[:1024].clone(),
            i_best=i_out[:1024].clone(), o=o, d=d, time=tm, iv=1.0 / d)
        tbvh._run_eager(tab, lanes, 1e-3, t_out, i_out, masked)
        out.append((t_out, i_out))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert int((out[0][1] >= 0).sum()) > 256


def test_bvh_render_bit_equal_across_chunkings():
    """random_spheres (311 moving spheres) through the BVH at depth 7 (the
    compaction at bounce 6 included): the same sums bit for bit in other
    pixel blocks and sample chunks, and without compaction."""
    p = dataclasses.replace(tb.PRESETS["random_spheres"], nx=12, ny=8)
    scene, cam = p.build(), p.camera()

    def sums(**kw):
        return trender.render_sums(scene, cam, 12, 8, 4, device="cpu", seed=2,
                                   max_depth=7, use_bvh=True, **kw)
    ref = sums()
    assert ref.sum() > 0
    for kw in (dict(block_pixels=17, spp_chunk=3), dict(compact=False)):
        assert torch.equal(sums(**kw), ref), kw


def test_bvh_render_matches_dense_on_big_spheres():
    """big_spheres(3000) at 48×27×2, depth 6, on both closest hits: the
    means within 2e-3 relative and under 0.5% of the pixels apart by more
    than 1e-3 (JAX's gates at 12k prims); the BVH's build is a timer
    phase."""
    scene = tb.big_spheres(3000)
    cam = tb.big_spheres_camera(3000, 48, 27)
    kw = dict(device="cpu", max_depth=6)
    timers = trender.Timers()
    a = trender.render(scene, cam, 48, 27, 2, use_bvh=False, **kw)
    b = trender.render(scene, cam, 48, 27, 2, use_bvh=True, timers=timers,
                       **kw)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / a.mean() < 2e-3
    assert (np.abs(a - b).max(-1) > 1e-3).mean() < 0.005
    assert "bvh_build" in timers.summary()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_use_bvh_thresholds(device):
    """auto takes the BVH from the device's measured crossover on (none on
    the card, where the dense scan won at every size: never there), and a
    scene of 304 prims scans densely on both."""
    at = trender._BVH_AUTO_MIN_PRIMS[device]
    if at is None:
        assert device == "cuda"
        assert not trender.auto_use_bvh(
            types.SimpleNamespace(num_prims=10 ** 9), device)
    else:
        assert not trender.auto_use_bvh(
            types.SimpleNamespace(num_prims=at - 1), device)
        assert trender.auto_use_bvh(types.SimpleNamespace(num_prims=at),
                                    device)
    assert not trender.auto_use_bvh(tb.big_spheres(300), device)


def test_bench_large_table_and_crossover():
    """`bench_large` on the CPU at a tiny size: a row a scene size with both
    tiers' rates and equal image means (the same hits), no K1 row off the
    card, and the crossover rule on made-up rows; it refuses the card
    without CUDA."""
    out = bench_large.run([300], nx=8, ny=4, spp=1, depth=2, reps=1,
                          device="cpu", log=lambda s: None)
    (row,) = out["rows"]
    assert row["prims"] == 304 and row["k1_rays_per_s"] is None
    assert row["dense_rays_per_s"] > 0 and row["bvh_rays_per_s"] > 0
    assert row["bvh_mean"] == row["dense_mean"]
    assert row["bvh_build_seconds"] >= 0

    def rows(*wins):
        return [dict(prims=p, dense_rays_per_s=1.0,
                     bvh_rays_per_s=2.0 if w else 0.5)
                for p, w in zip((10, 20, 30), wins)]
    assert bench_large.crossover(rows(False, True, True)) == 20
    assert bench_large.crossover(rows(True, False, True)) == 30
    assert bench_large.crossover(rows(False, False, False)) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench_large.run([300], device="cuda")


def test_differentiable_trace_refuses_bvh():
    """The traversal is forward only, as JAX's lax.while_loop is."""
    scene = tb.two_spheres()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    lane = torch.arange(4)
    with pytest.raises(ValueError, match="forward only"):
        integrator.trace(scene, o, d, torch.zeros(4), 0, lane, lane * 0, 4,
                         differentiable=True, bvh=tbvh.build_bvh(scene))


def test_checkpoint_meta_tells_bvh_from_dense(tmp_path, capsys):
    """A BVH render's checkpoint resumes a BVH render byte for byte and is
    refused (a warning, a fresh start) by a dense one."""
    p = dataclasses.replace(tb.PRESETS["two_spheres"], nx=16, ny=8)
    scene, cam = p.build(), p.camera()
    kw = dict(device="cpu", max_depth=6, block_pixels=32)
    path = str(tmp_path / "ck.npz")
    full = trender.render(scene, cam, 16, 8, 2, use_bvh=True, **kw)
    assert trender.render(scene, cam, 16, 8, 2, use_bvh=True, checkpoint=path,
                          _stop_after_blocks=2, **kw) is None
    with np.load(path) as z:
        assert z["meta"][8] == ck.ENGINE_GENERAL_BVH  # the engine's byte
    resumed = trender.render(scene, cam, 16, 8, 2, use_bvh=True,
                             checkpoint=path, **kw)
    assert np.array_equal(resumed, full)
    capsys.readouterr()
    trender.render(scene, cam, 16, 8, 2, use_bvh=True, checkpoint=path,
                   _stop_after_blocks=1, **kw)
    trender.render(scene, cam, 16, 8, 2, use_bvh=False, checkpoint=path, **kw)
    assert "written for another render" in capsys.readouterr().err


def test_cli_bvh_switch(tmp_path, capsys):
    """`--bvh on` with `--engine kernel` and with `--sharded` exits 2;
    with `--engine auto` it renders on the general tier with one line on
    stderr; `on` and `off` give the same image on a scene without ties."""
    base = ["render", "--scene", "two_spheres", "--nx", "16", "--ny", "8",
            "--spp", "2", "--max-depth", "6", "--device", "cpu",
            "--no-progress"]
    out = {k: str(tmp_path / f"{k}.ppm") for k in ("on", "off")}
    assert cli.main(base + ["--bvh", "on", "--engine", "kernel"]) == 2
    assert cli.main(base + ["--bvh", "on", "--sharded"]) == 2
    assert "--bvh on" in capsys.readouterr().err
    assert cli.main(base + ["--bvh", "on", "--out", out["on"]]) == 0
    text = capsys.readouterr()
    assert "xla engine" in text.out
    assert text.err.strip() == "--bvh on: rendering on the general tier"
    assert cli.main(base + ["--bvh", "off", "--engine", "xla", "--out",
                            out["off"]]) == 0
    with open(out["on"]) as a, open(out["off"]) as b:
        assert a.read() == b.read()


def test_big_spheres_equal_jax():
    """big_spheres' tables field by field, its camera within 1 ulp (as
    tests/test_torch_scene.py holds the presets' cameras)."""
    port = tb.big_spheres(300)
    ref = jax.device_get(jb.big_spheres(300))
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.metadata.get("static"):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
    assert port.num_prims == 304
    cam = tb.big_spheres_camera(300, 64, 36)
    jc = jax.device_get(jb.big_spheres_camera(300, 64, 36))
    for f in dataclasses.fields(cam):
        np.testing.assert_array_max_ulp(getattr(cam, f.name).numpy(),
                                        np.asarray(getattr(jc, f.name)),
                                        maxulp=1)
