"""The port's scene tables and camera against the JAX package's.

Every preset builds tables equal field by field to the JAX build: exact
for the int32 tables, `==` for the f32 ones (both builds run the same numpy
arithmetic). `from_numpy` carries a JAX build across unchanged, and the
camera agrees to 1 ulp.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracing_rust_tpu.models import builders as jb
from raytracing_rust_tpu.ops import camera as jcam
from raytracing_rust_tpu.ops import intersect as jint
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.models.scene import SceneTables
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import intersect as tint
import torch_threads  # noqa: F401  (one torch thread a process)


def _jax_fields(tables) -> dict:
    tables = jax.device_get(tables)
    return {f.name: (getattr(tables, f.name) if f.metadata.get("static")
                     else np.asarray(getattr(tables, f.name)))
            for f in dataclasses.fields(tables)}


def _assert_tables_equal(port: SceneTables, ref: dict):
    for f in dataclasses.fields(SceneTables):
        got = getattr(port, f.name)
        want = ref[f.name]
        if f.metadata.get("static"):
            assert got == want, f.name
            continue
        got = got.cpu().numpy()
        assert got.dtype == want.dtype, (f.name, got.dtype, want.dtype)
        assert got.shape == want.shape, (f.name, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("name", sorted(tb.PRESETS))
def test_preset_tables_equal_jax(name):
    assert sorted(tb.PRESETS) == sorted(jb.PRESETS)
    port = tb.PRESETS[name].build()
    ref = _jax_fields(jb.PRESETS[name].build())
    _assert_tables_equal(port, ref)


def test_from_numpy_round_trips_jax_tables():
    ref = _jax_fields(jb.cornell_smoke())
    tables = SceneTables.from_numpy(ref)
    _assert_tables_equal(tables, ref)
    _assert_tables_equal(tables.to("cpu"), ref)


def test_builder_variants_equal_jax():
    """The compat flags and seeds change the same fields in both builds."""
    pairs = [(tb.final_scene(seed=3, compat_dead_light=True),
              jb.final_scene(seed=3, compat_dead_light=True)),
             (tb.cornell_smoke(compat_front_wall=True),
              jb.cornell_smoke(compat_front_wall=True)),
             (tb.random_spheres(seed=5), jb.random_spheres(seed=5))]
    for port, ref in pairs:
        _assert_tables_equal(port, _jax_fields(ref))


@pytest.mark.parametrize("name", ["cornell_box", "random_spheres",
                                  "final_scene"])
def test_pack_prims_equals_jax(name):
    """World-space prim frames, field by field, bit for bit."""
    port = tint.pack_prims(tb.PRESETS[name].build())
    ref = jax.device_get(jint.pack_prims(jb.PRESETS[name].build()))
    for f in dataclasses.fields(tint.PrimPack):
        np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def test_rotations_equal_jax_and_invert():
    port_scene, ref_scene = tb.cornell_box(), jb.cornell_box()
    r = np.random.default_rng(3)
    v = r.normal(0, 300, (64, 3)).astype(np.float32)
    xf = r.integers(0, port_scene.xf_axis.shape[0], 64).astype(np.int32)
    tv, txf = torch.from_numpy(v), torch.from_numpy(xf)
    for port_fn, ref_fn in ((tint.rot_plus, jint.rot_plus),
                            (tint.rot_minus, jint.rot_minus)):
        np.testing.assert_array_equal(port_fn(port_scene, txf, tv).numpy(),
                                      np.asarray(ref_fn(ref_scene, xf, v)))
    back = tint.rot_minus(port_scene, txf, tint.rot_plus(port_scene, txf, tv))
    np.testing.assert_allclose(back.numpy(), v, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["cornell_box", "two_spheres",
                                  "simple_light", "final_scene"])
def test_make_camera_within_one_ulp(name):
    p = tb.PRESETS[name]
    port = p.camera()
    ref = jax.device_get(jb.PRESETS[name].camera())
    for f in dataclasses.fields(tcam.Camera):
        got = getattr(port, f.name).numpy()
        want = np.asarray(getattr(ref, f.name))
        assert got.dtype == np.float32 and got.shape == want.shape, f.name
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # and the from_numpy route carries the JAX camera exactly
    carried = tcam.Camera.from_numpy(
        {f.name: np.asarray(getattr(ref, f.name))
         for f in dataclasses.fields(tcam.Camera)})
    for f in dataclasses.fields(tcam.Camera):
        np.testing.assert_array_equal(getattr(carried, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))


def test_get_rays_matches_jax_on_shared_uniforms():
    """Batched raygen on the same (s, t, u) agrees to 2 ulps (bit for bit
    on this CPU; sin/cos may round differently across libraries)."""
    r = np.random.default_rng(0)
    s = r.random(256, dtype=np.float32)
    t = r.random(256, dtype=np.float32)
    u = r.random((256, 3), dtype=np.float32)
    args = ((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, 1.0, 0.1, 10.0,
            0.0, 1.0)
    jo, jd, jt = (np.asarray(x) for x in jcam.get_rays(
        jcam.make_camera(*args), s, t, u))
    to, td, tt = (x.numpy() for x in tcam.get_rays(
        tcam.make_camera(*args), torch.from_numpy(s), torch.from_numpy(t),
        torch.from_numpy(u)))
    np.testing.assert_array_max_ulp(to, jo, maxulp=2)
    np.testing.assert_array_max_ulp(td, jd, maxulp=2)
    np.testing.assert_array_equal(tt, jt)
