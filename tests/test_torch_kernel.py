"""The CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (`nvcc`): they build
`raytracing_rust_tpu_torch/csrc/*.cu`, launch K1 (`tracer.cu`: the K1a
instantiation and the K1B ones with their checker, sky, metal, glass,
moving-sphere, dynamic-table, box-table (a grid's strip pass and the
generic loop), noise, image, media, dense-medium walk, lattice-corner and
roulette sections, its two-level cull against the
one-level cull and no cull, and K1f: the stats instantiation with and
without its DDA row, JAX's balanced pixel table and the render's own),
K2/K3 (`grad.cu`: lambertian, light, sky, metal, glass and the checker;
K2's winner tape against the plain tape, K3 on it, run twice),
D3 (`peak.cu`) and D1/D2 (`microbench.cu`), and hold them against `trace_plain`,
`trace_tiles_plain` and autograd through it, `fp32_chain_plain`,
`attr_read_plain` and `member_plain`, run on the same card, the same
records and the same draws. Elsewhere they skip.
Run them on the card with
`python -m pytest tests/test_torch_kernel.py -q --noconftest -m cuda`.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from raytracing_rust_tpu_torch import inverse_render
from raytracing_rust_tpu_torch.models import builders
from raytracing_rust_tpu_torch.models.scene import (BG_BLACK, BG_SKY,
                                                    TEX_CHECKER, SceneBuilder)
from raytracing_rust_tpu_torch.ops import (camera, grad, microbench, peak,
                                           tracer)
from test_torch_k1_instantiations import wide_grid
import torch_threads  # noqa: F401  (one torch thread a process)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(scene, cam, device):
    return tracer.trace_operands(tracer.build_scene_record(scene),
                                 tracer.build_camera_record(cam), device)


def _cornell(nx, ny):
    p = builders.PRESETS["cornell_box"]
    return p.build(), camera.make_camera(
        p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
        p.focus_dist, p.time0, p.time1)


def _spheres(nx, ny):
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.7, 0.3, 0.2)))
    b.sphere((0, 5, 1), 1.5, b.diffuse_light(b.solid(6, 6, 6)))
    b.rect("xy", -3, 0, 3, 3, -2, b.lambertian(b.solid(0.2, 0.6, 0.3)),
           flip=True)
    return b.build(), camera.make_camera((0, 2, 8), (0, 1, 0), (0, 1, 0), 35.0,
                                         nx / ny, 0.1, 8.0, 0.0, 1.0)


def _sky_view(nx, ny):
    return camera.make_camera((0, 2, 8), (0, 1, 0), (0, 1, 0), 35.0, nx / ny,
                              0.0, 10.0, 0.0, 1.0)


def _oracle_spheres(nx, ny):
    """Lambertian, metal and glass spheres under the sky (the C++ mirror's
    scene 1)."""
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.2))
    b.sphere((-2.2, 1, 0), 1.0, b.dielectric(1.5))
    return b.build(), _sky_view(nx, ny)


def _moving_checker(nx, ny):
    """Checker ground, a moving sphere, a sharp metal hero, the sky (the
    C++ mirror's scene 3)."""
    b = SceneBuilder(background=BG_SKY)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.moving_sphere((0, 1, 0), (0, 1.5, 0), 0.0, 1.0, 1.0,
                    b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.0))
    return b.build(), _sky_view(nx, ny)


def _random_spheres(nx, ny):
    p = builders.PRESETS["random_spheres"]
    return p.build(), camera.make_camera(
        p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
        p.focus_dist, p.time0, p.time1)


def _small_spheres(n):
    """n small spheres of every material over a checker ground, half of
    them moving, under the sky: a dynamic table of n rows, far beyond
    shared memory (and the TPU kernel's ~2k-prim SMEM cap)."""
    def make(nx, ny):
        r = np.random.default_rng(5)
        b = SceneBuilder(background=BG_SKY)
        checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
        b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
        mats = [b.lambertian(b.solid(0.8, 0.3, 0.3)),
                b.metal(b.solid(0.7, 0.7, 0.7), 0.1), b.dielectric(1.5)]
        for i in range(n):
            c = r.uniform((-6.0, 0.05, -6.0), (6.0, 3.0, 6.0))
            m = mats[i % 3]
            if i % 2:
                b.moving_sphere(c, c + (0.0, 0.2, 0.0), 0.0, 1.0, 0.05, m)
            else:
                b.sphere(c, 0.05, m)
        return b.build(), _sky_view(nx, ny)
    return make


def _preset(name):
    def make(nx, ny):
        p = builders.PRESETS[name]
        return p.build(), camera.make_camera(
            p.look_from, p.look_at, p.view_up, p.vfov, nx / ny, p.aperture,
            p.focus_dist, p.time0, p.time1)
    make.__name__ = name
    return make


def _image_sphere(h, w, compat=False):
    """An image sphere of random texels (every texel its own colour) under
    the sky: the texel fetch is the K1c path a wrong index shows in."""
    def make(nx, ny):
        pix = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                    np.uint8)
        b = SceneBuilder(background=BG_SKY, compat_uv_bug=compat)
        b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
        b.sphere((0, 1, 0), 1.0, b.lambertian(b.image(pix)))
        return b.build(), _sky_view(nx, ny)
    return make


def _every_feature(nx, ny):
    """Noise, image, checker, metal, glass, a moving sphere, a rect and two
    media (a sphere around the scene and a rotated box) under the sky."""
    pix = np.random.default_rng(2).integers(0, 256, (32, 64, 3), np.uint8)
    b = SceneBuilder(background=BG_SKY, perlin_seed=3)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.noise(4.0)))
    b.sphere((2.2, 1, 0), 1.0, b.lambertian(b.image(pix)))
    b.sphere((-2.2, 1, 0), 1.0, b.dielectric(1.5))
    b.moving_sphere((0, 1, 2), (0, 1.5, 2), 0.0, 1.0, 0.5,
                    b.metal(b.solid(0.7, 0.6, 0.5), 0.1))
    b.rect("xy", -3, 0, 3, 3, -2, b.lambertian(b.solid(0.2, 0.6, 0.3)))
    b.medium_sphere((0, 1, 0), 6.0, 0.02, b.solid(0.9, 0.9, 0.9))
    xf = b.transform(offset=(0, 0, 1), rotate_axis="y", angle_deg=30.0)
    b.medium_box((-0.5, 0, -0.5), (0.5, 1, 0.5), 0.8, b.solid(0.3, 0.5, 0.7),
                 xform=xf)
    return b.build(), _sky_view(nx, ny)


def _textured_crowd(nx, ny):
    """200 small noise and image spheres: textures read from the dynamic
    table's rows in device memory, inside a sphere medium."""
    r = np.random.default_rng(6)
    pix = r.integers(0, 256, (16, 32, 3), np.uint8)
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.noise(2.0)))
    mats = [b.lambertian(b.noise(8.0)), b.lambertian(b.image(pix))]
    for i in range(200):
        b.sphere(r.uniform((-4.0, 0.1, -4.0), (4.0, 2.0, 4.0)), 0.1,
                 mats[i % 2])
    b.medium_sphere((0, 1, 0), 8.0, 0.01, b.solid(1, 1, 1))
    return b.build(), _sky_view(nx, ny)


def _cubes(nx, ny, n=20):
    """20 cubes of three materials under the sky (`builders.cubes_scene`):
    120 rects, merged into 20 boxes, with no unrolled prim and no dynamic
    sphere. They fill a 5×4 grid of pitch 1, so their boxes take the strip
    pass; fewer (n) leave cells empty and take the generic box loop."""
    return builders.cubes_scene(n), builders.cubes_camera(nx, ny)


def _cubes17(nx, ny):
    """17 of `_cubes`: no grid, the generic box loop."""
    return _cubes(nx, ny, n=17)


def _final_inside_box(nx, ny):
    """final_scene through a lens whose centre lies 0.2 above the top of
    the ground box at x, z in [−1000, −900]: a lens radius of 0.5 puts
    part of the camera rays' origins inside the box (they leave through
    its faces: the exit, or the hi z face the strip pass reaches by the
    incremental z plane) and part above it, looking up along +z."""
    p = builders.PRESETS["final_scene"]
    scene = p.build()
    rec = tracer.build_scene_record(scene).box_rec
    top = float(rec[(rec[:, tracer.R_C0] == -1000.0)
                    & (rec[:, tracer.R_C0 + 2] == -1000.0)][0,
                                                            tracer.R_DC + 1])
    y = top + 0.2
    return scene, camera.make_camera(
        (-950.0, y, -950.0), (-950.0, y + 30.0, 0.0), (0, 1, 0), 60.0,
        nx / ny, 1.0, 20.0, 0.0, 1.0)


def _shared_faces(nx, ny):
    """Overlapping boxes of two colours whose top and front faces lie in
    one plane, beside 100 small spheres (so the scene is big enough for
    the box table): a ray through the overlap hits both boxes at exactly
    the same t, and the first in table order must win in both versions,
    with the same face normal."""
    b = SceneBuilder(background=BG_SKY)
    red = b.lambertian(b.solid(0.8, 0.1, 0.1))
    blue = b.lambertian(b.solid(0.1, 0.1, 0.8))
    for i in range(16):
        b.cube((-2.0 + 0.3 * i, 0.0, -1.0), (-1.0 + 0.3 * i, 1.0, 0.0),
               red if i % 2 else blue)
    r = np.random.default_rng(3)
    for _ in range(100):
        b.sphere(r.uniform((-4, 0.05, 1), (4, 0.3, 3)), 0.05, red)
    return b.build(), camera.make_camera((0.5, 3, 4), (0.5, 0.5, -0.5),
                                         (0, 1, 0), 40.0, nx / ny, 0.0, 5.0,
                                         0.0, 1.0)


def _sealed(nx, ny):
    """A glass sphere sealing a coincident medium of ρ 1 (walk-dense) on
    a gray ground under a sphere light."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -1000, 0), 999.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 3, 0), 3.0, b.dielectric(1.5))
    b.medium_sphere((0, 3, 0), 3.0, 1.0, b.solid(0.8, 0.9, 0.95))
    b.sphere((0, 9, 1), 1.5, b.diffuse_light(b.solid(6, 6, 6)))
    return b.build(), camera.make_camera((0, 4, 14), (0, 3, 0), (0, 1, 0),
                                         35.0, nx / ny, 0.0, 10.0, 0.0, 1.0)


def _media_mix(nx, ny):
    """Five media in two groups of four draws: a sphere around the whole
    scene, a rotated box, a rotated sphere, an axis-aligned box and a small
    dense sphere, over a gray ground under a sphere light."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 6, 1), 1.5, b.diffuse_light(b.solid(7, 7, 7)))
    b.medium_sphere((0, 1, 0), 9.0, 0.01, b.solid(0.9, 0.9, 0.9))
    b.medium_box((-0.5, 0, -0.5), (0.5, 1.5, 0.5), 0.5,
                 b.solid(0.3, 0.5, 0.7),
                 xform=b.transform(offset=(-1.5, 0, 0), rotate_axis="y",
                                   angle_deg=30.0))
    b.medium_sphere((0, 0.8, 0), 0.8, 0.3, b.solid(0.8, 0.3, 0.2),
                    xform=b.transform(offset=(1.5, 0, 0.5), rotate_axis="x",
                                      angle_deg=-20.0))
    b.medium_box((-0.4, 0, 1.2), (0.4, 0.6, 2.0), 1.0,
                 b.solid(0.2, 0.8, 0.3))
    b.medium_sphere((0.3, 2.2, -1.0), 0.3, 2.0, b.solid(0.9, 0.9, 0.2))
    return b.build(), camera.make_camera((0, 2, 7), (0, 1, 0), (0, 1, 0),
                                         40.0, nx / ny, 0.0, 7.0, 0.0, 1.0)


HOLES = ("emissive_checker", "emissive_noise", "emissive_image", "image_rect",
         "image_flipped_sphere", "medium_checker", "medium_noise",
         "medium_image")


def texels(seed=3, h=8, w=16):
    """An 8-bit exact random image (tests/test_pallas_tripwire.py
    `_texels`)."""
    r = np.random.default_rng(seed)
    return (np.rint(r.uniform(26, 230, (h, w, 3))).astype(np.float32)
            / 255.0).astype(np.float32)


def hole_scene(name, cls=SceneBuilder, light=False):
    """A former hole of the kernel on a gray ground
    (tests/test_pallas_tripwire.py:300-330), or the medium beside an image
    sphere (333-349). cls: this package's SceneBuilder or the JAX one;
    light adds a sphere light above (the tripwire scenes are black)."""
    b = cls(background=BG_BLACK)
    white = b.lambertian(b.solid(0.5, 0.5, 0.5))
    b.sphere((0, -100, 0), 99.0, white)
    if name == "emissive_checker":
        b.rect("zx", -1, -1, 1, 1, 3.0,
               b.diffuse_light(b.checker(b.solid(4, 4, 4),
                                         b.solid(1, 1, 1))), flip=True)
    elif name == "emissive_noise":
        b.sphere((0, 2, 0), 0.5, b.diffuse_light(b.noise(3.0)))
    elif name == "emissive_image":
        b.sphere((0, 2, 0), 0.5, b.diffuse_light(b.image(texels())))
    elif name == "image_rect":
        b.rect("xy", -1, 0, 1, 2, -2.0, b.lambertian(b.image(texels())))
    elif name == "image_flipped_sphere":
        b.sphere((0, 1, 0), 0.8, b.lambertian(b.image(texels())))
        b._pflip[-1] = -1.0
    elif name == "medium_checker":
        b.medium_sphere((0, 1, 0), 1.0, 0.5,
                        b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0)))
    elif name == "medium_noise":
        b.medium_box((-1, 0, -1), (1, 1, 1), 0.5, b.noise(2.0))
    elif name == "medium_image":
        b.medium_sphere((0, 1, 0), 1.0, 0.5, b.image(texels()))
    elif name == "medium_beside_image_sphere":
        b.sphere((0, 1.5, 0), 0.7, b.lambertian(b.image(texels())))
        b.medium_sphere((0, 1, 0), 2.5, 0.3,
                        b.checker(b.solid(1, 0, 0), b.solid(0, 1, 0)))
    if light:
        b.sphere((0, 6, 2), 1.5, b.diffuse_light(b.solid(5, 5, 5)))
    return b.build()


def _lattice(nx, ny):
    """The feature-lattice scene through tools/tpu_parity.py's camera."""
    return builders.lattice_scene(), builders.lattice_camera(nx, ny)


def _hole(name):
    """A former hole of the kernel (`hole_scene`), lit by a sphere light,
    through a camera on the gray ground's edge."""
    def make(nx, ny):
        return hole_scene(name, light=True), camera.make_camera(
            (0, 2, 6), (0, 1, 0), (0, 1, 0), 40.0, nx / ny, 0.0, 6.0, 0.0,
            1.0)
    make.__name__ = name
    return make


def image_dome(cls=SceneBuilder):
    """A flipped image sphere of radius 8 around a sphere light, a
    checker-light rect and a gray ball, seen from inside (DOME_VIEW): light
    scatters off the dome, so its texels (at the pre-flip normal's UV)
    reach the image. Its red falls with u and its green with v, over
    random texels, so a UV off by the flip (u + ½, 1 − v) shows in each
    image half. cls: this package's SceneBuilder or the JAX one."""
    pix = np.random.default_rng(11).integers(0, 48, (32, 64, 3), np.uint8)
    pix[:, :32, 0] += 200
    pix[:16, :, 1] += 200
    b = cls(background=BG_BLACK)
    b.sphere((0, 0, 0), 8.0, b.lambertian(b.image(pix)))
    b._pflip[-1] = -1.0
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((2, 3, 1), 0.7, b.diffuse_light(b.solid(6, 6, 6)))
    b.rect("xy", -2, -1, 0, 1, -4.0, b.diffuse_light(
        b.checker(b.solid(3, 0.5, 0.5), b.solid(0.5, 3, 0.5))))
    return b.build()


DOME_VIEW = ((0, 1, 6), (0, 0, 0), (0, 1, 0), 70.0)


def _image_dome(nx, ny):
    return image_dome(), camera.make_camera(*DOME_VIEW, nx / ny, 0.0, 6.0,
                                            0.0, 1.0)


_COUNTERS = ("KERNEL_LAUNCHES", "K1BE_LAUNCHES", "K1C_LAUNCHES",
             "K1D_LAUNCHES", "K1E_BOX_LAUNCHES", "K1D_WALK_LAUNCHES",
             "K1_LATTICE_LAUNCHES", "K1G_LAUNCHES")


def _expected_launches(ops):
    """The counts one launch adds: K1a, K1BE, K1C, K1D, K1E boxes, K1D
    walk, the lattice corners, K1g roulette."""
    f, n_dyn, n_box = ops.feats, ops.dyn.shape[0], ops.box.shape[0]
    return ((f == 0 and n_dyn == 0 and n_box == 0),
            bool(f & tracer.K1BE_FEATS or n_dyn),
            bool(f & (tracer.FEAT_NOISE | tracer.FEAT_IMAGE)),
            bool(f & tracer.FEAT_MEDIA), bool(n_box),
            bool(f & tracer.FEAT_DENSE_WALK),
            bool(f & tracer.FEAT_LATTICE), bool(f & tracer.FEAT_RR))


def _expected_instantiation(ops, **kw):
    """The flags (K1B, DYN, LEAF_SMEM, STATS, MED) of the instantiation one
    launch of ops runs, by the host's counterpart of csrc/tracer.cu `pick`
    (`tracer.k1_instantiation`; the CPU tests hold it to the design's
    routes): roulette or media alone, without a table, run K1a's code; any
    other feature bit a K1B one; media a MED one."""
    return tracer.k1_instantiation(ops, **kw)


def _launches():
    return tuple(getattr(tracer, n) for n in _COUNTERS)


def _ran(before):
    """The instantiations launched since `before` (a copy of
    tracer.K1_INSTANTIATION_LAUNCHES), each as its flags (K1B, DYN,
    LEAF_SMEM, STATS, MED)."""
    out = []
    for name, n in (tracer.K1_INSTANTIATION_LAUNCHES - before).items():
        out += [tuple(map(int, name[9:-1].split(",")))] * n
    return out


def _assert_kernel_matches_plain(k, p):
    """Per-pixel sums within 1e-4 relative for ≥ 99% of pixels (a path whose
    hit test lands within an ulp of an edge may take another branch when
    sin/cos or pow round differently), channel means within 1e-4."""
    assert torch.isfinite(k).all() and float(k.sum()) > 0
    close = torch.isclose(k, p, rtol=1e-4, atol=1e-6).all(dim=0)
    assert float(close.double().mean()) >= 0.99
    km, pm = k.mean(dim=1), p.mean(dim=1)
    assert torch.allclose(km, pm, rtol=1e-4, atol=0), (km, pm)


@pytest.mark.parametrize("make", [
    _cornell, _spheres, _oracle_spheres, _moving_checker, _random_spheres,
    _small_spheres(3000), _preset("two_perlin_spheres"),
    _preset("simple_light"), _preset("earth"), _preset("cornell_smoke"),
    _image_sphere(16, 32, compat=True), _every_feature, _textured_crowd,
    _preset("final_scene"), _cubes, _shared_faces, _sealed,
    _preset("two_spheres")])
def test_kernel_matches_plain(cuda, make):
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    kw = dict(nx=nx, ny=ny, seed=3, sample0=0, n_samples=4, max_depth=50)
    before = _launches()
    ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    k = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                      device=cuda), **kw)
    assert _launches() == tuple(b + e for b, e in
                                zip(before, _expected_launches(ops)))
    assert _ran(ran) == [_expected_instantiation(ops)]
    p = tracer.trace_plain(ops, torch.zeros_like(k), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(k, p)


@pytest.mark.parametrize("make", [_lattice, _image_dome] + [
    _hole(h) for h in HOLES + ("medium_beside_image_sphere",)])
def test_kernel_lattice_matches_plain(cuda, make):
    """The lattice corners (textured lights, image rects, flipped image
    spheres, textured media) on the lattice scene, an image dome and each
    former hole: the kernel against the plain version, and the lattice
    launch count."""
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    assert ops.feats & tracer.FEAT_LATTICE
    kw = dict(nx=nx, ny=ny, seed=5, sample0=0, n_samples=4, max_depth=50)
    before = _launches()
    k = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                      device=cuda), **kw)
    assert _launches() == tuple(b + e for b, e in
                                zip(before, _expected_launches(ops)))
    p = tracer.trace_plain(ops, torch.zeros_like(k), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(k, p)


@pytest.mark.parametrize("make,rr_depth", [
    (_cornell, 6), (_preset("final_scene"), 5), (_lattice, 3)])
def test_kernel_roulette_matches_plain(cuda, make, rr_depth):
    """Russian roulette (K1g) against the plain version, with its launch
    count and the instantiation it ran: cornell_box (the static
    instantiation, K1a's, bit for bit equal to plain), final_scene (the
    walk cleared; K1B with its tables) and the lattice scene (K1B); at
    rr_depth == max_depth the kernel's sums equal those without roulette
    bit for bit (cornell_box: both launches in the static
    instantiation)."""
    nx, ny = 96, 64
    scene, cam = make(nx, ny)
    srec = tracer.build_scene_record(scene)
    cam = tracer.build_camera_record(cam)
    ops = tracer.trace_operands(srec, cam, cuda, rr_depth=rr_depth)
    assert ops.feats & tracer.FEAT_RR
    assert not ops.feats & tracer.FEAT_DENSE_WALK
    kw = dict(nx=nx, ny=ny, seed=7, sample0=0, n_samples=4, max_depth=50)
    before = _launches()
    ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    k = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                      device=cuda), **kw)
    assert _launches() == tuple(b + e for b, e in
                                zip(before, _expected_launches(ops)))
    assert _ran(ran) == [_expected_instantiation(ops)]
    p = tracer.trace_plain(ops, torch.zeros_like(k), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(k, p)
    if make is _cornell:
        assert _ran(ran) == [(0, 0, 0, 0, 0)]
        assert torch.equal(k, p)
        kw["max_depth"] = 12
        ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
        capped = tracer.trace(tracer.trace_operands(srec, cam, cuda,
                                                    rr_depth=12),
                              torch.zeros_like(k), **kw)
        off = tracer.trace(tracer.trace_operands(srec, cam, cuda),
                           torch.zeros_like(k), **kw)
        torch.cuda.synchronize()
        assert _ran(ran) == [(0, 0, 0, 0, 0)] * 2
        assert torch.equal(capped, off)


def test_kernel_leaf_cull_keeps_the_winners(cuda):
    """20,000 small spheres: 2,048 leaves, more than shared memory holds
    beside the record, so the kernel reads them from device memory. The
    cull may skip only leaves that cannot hold a closer hit: the sums with
    and without it agree as the kernel and its plain version do."""
    nx, ny = 96, 64
    ops = _operands(*_small_spheres(20000)(nx, ny), cuda)
    assert ops.leaves.shape[0] * tracer.CLUSW * 4 > 48 * 1024
    kw = dict(nx=nx, ny=ny, seed=4, sample0=0, n_samples=2, max_depth=50)
    culled = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                           device=cuda), **kw)
    flat = tracer.trace(dataclasses.replace(ops, leaves=ops.leaves[:0]),
                        torch.zeros_like(culled), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(culled, flat)


@pytest.mark.parametrize("make,nx,ny,spp", [
    (_preset("final_scene"), 800, 800, 1), (_random_spheres, 1280, 720, 2),
    (_small_spheres(20000), 96, 64, 2)],
    ids=["final_scene", "random_spheres", "small_spheres_20000"])
def test_kernel_two_level_cull_is_bit_exact(cuda, make, nx, ny, spp):
    """K1's two-level cull (root, super rows, leaves), its one-level cull
    (the super rows emptied: root and leaves) and no cull (the leaves
    emptied: every member scanned) give the same sums bit for bit: a
    super holds its leaves, so the leaves that survive are tested in the
    same order at the same best hit. The stats launch of the two-level
    cull counts the plain version's segments, sphere and box member tests,
    warp steps and DDA row. final_scene runs with the walk on; the 20,000
    spheres' 2,048 leaves and 256 supers sit in device memory."""
    ops = _operands(*make(nx, ny), cuda)
    assert ops.sups.shape[0] and ops.sups.shape[0] < ops.leaves.shape[0]
    kw = dict(nx=nx, ny=ny, seed=5, sample0=0, n_samples=spp, max_depth=50)

    def sums():
        return torch.zeros((3, nx * ny), dtype=torch.float64, device=cuda)

    two = tracer.trace(ops, sums(), **kw)
    one = tracer.trace(dataclasses.replace(
        ops, sups=ops.sups[:0], bsups=ops.bsups[:0]), sums(), **kw)
    flat = tracer.trace(dataclasses.replace(
        ops, leaves=ops.leaves[:0], bleaves=ops.bleaves[:0]), sums(), **kw)
    sk, sp = (tracer.new_stats(nx, ny, cuda, dda=True) for _ in range(2))
    k = tracer.trace(ops, sums(), stats=sk, dda=True, **kw)
    tracer.trace_plain(ops, sums(), stats=sp, dda=True, **kw)
    torch.cuda.synchronize()
    assert float(two.sum()) > 0
    assert torch.equal(two, one) and torch.equal(two, flat)
    assert torch.equal(k, two)
    assert torch.equal(sk, sp), [
        (name, int(a.sum()), int(b.sum())) for name, a, b in zip(
            ("segments", "sphere tests", "box tests", "warp steps", "dda"),
            (*tracer.stats_rows(sk, nx * ny, dda=True),
             tracer.dda_row(sk, nx * ny)),
            (*tracer.stats_rows(sp, nx * ny, dda=True),
             tracer.dda_row(sp, nx * ny)))]


@pytest.mark.parametrize("make", [_cornell, _moving_checker,
                                  _preset("cornell_smoke"), _every_feature,
                                  _preset("final_scene")])
def test_kernel_chunking_is_bit_identical(cuda, make):
    nx, ny = 64, 64
    ops = _operands(*make(nx, ny), cuda)
    out = []
    for chunk in (2, 4):
        sums = torch.zeros((3, nx * ny), dtype=torch.float64, device=cuda)
        for s0 in range(0, 4, chunk):
            tracer.trace(ops, sums, nx=nx, ny=ny, seed=9, sample0=s0,
                         n_samples=chunk, max_depth=50)
        out.append(sums)
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("make", [_sealed, _preset("final_scene")])
def test_kernel_walk_on_and_off(cuda, make):
    """The dense-medium walk and the event path alone (FEAT_DENSE_WALK
    cleared), each held to the plain version, and to each other bit for
    bit: the walk reads the event path's draws at the same bounces and
    its interior set holds every surface a walking ray reaches first."""
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    assert ops.feats & tracer.FEAT_DENSE_WALK and ops.interior.shape[0]
    event = dataclasses.replace(ops, feats=ops.feats
                                & ~tracer.FEAT_DENSE_WALK)
    kw = dict(nx=nx, ny=ny, seed=6, sample0=0, n_samples=4, max_depth=50)
    out = {}
    for name, o in (("walk", ops), ("event", event)):
        before = tracer.K1D_WALK_LAUNCHES
        k = tracer.trace(o, torch.zeros((3, nx * ny), dtype=torch.float64,
                                        device=cuda), **kw)
        assert tracer.K1D_WALK_LAUNCHES == before + (name == "walk")
        p = tracer.trace_plain(o, torch.zeros_like(k), **kw)
        torch.cuda.synchronize()
        _assert_kernel_matches_plain(k, p)
        out[name] = k
    assert torch.equal(out["walk"], out["event"])


@pytest.mark.parametrize("h,w", [(300, 517), (4096, 1024)])
def test_kernel_texel_fetch_is_exact(cuda, h, w):
    """The GPU counterpart of tests/test_pallas_image.py's `_image_fetch`
    harnesses: on an image of random texels the kernel's one-load fetch
    gives the plain version's gather, pixel by pixel, at an odd size and at
    4096×1024 (a 16 MB atlas, twice the TPU kernel's 8 MB VMEM cap)."""
    nx, ny = 128, 96
    ops = _operands(*_image_sphere(h, w)(nx, ny), cuda)
    assert ops.atlas.shape == (h, w)
    kw = dict(nx=nx, ny=ny, seed=8, sample0=0, n_samples=2, max_depth=50)
    k = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                      device=cuda), **kw)
    p = tracer.trace_plain(ops, torch.zeros_like(k), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(k, p)
    assert float((k == p).all(dim=0).double().mean()) >= 0.99


def test_kernel_wrapper_rejects_bad_operands(cuda):
    ops = _operands(*_cornell(8, 8), cuda)
    sums = torch.zeros((3, 64), dtype=torch.float64, device=cuda)
    kw = dict(nx=8, ny=8, seed=0, sample0=0, n_samples=1, max_depth=1)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(ops, rec=ops.rec.cpu()), sums, **kw)
    with pytest.raises(TypeError):
        tracer.trace(dataclasses.replace(ops, walk=ops.walk.long()), sums,
                     **kw)
    with pytest.raises(ValueError):
        tracer.trace(ops, sums[:, :32], **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(ops, feats=64), sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(ops, feats=tracer.FEAT_ALL + 1),
                     sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(ops, feats=tracer.FEAT_MEDIA), sums,
                     **kw)
    smoke = _operands(*_preset("cornell_smoke")(8, 8), cuda)
    with pytest.raises(TypeError):
        tracer.trace(dataclasses.replace(smoke, med=smoke.med.double()), sums,
                     **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(smoke, med_box=4), sums, **kw)
    final = _operands(*_preset("final_scene")(8, 8), cuda)
    with pytest.raises(ValueError):   # more interior rows than the walk holds
        tracer.trace(dataclasses.replace(final, interior=final.dyn[:25],
                                         interior_kind=torch.zeros(
                                             25, dtype=torch.int32,
                                             device=cuda)), sums, **kw)
    with pytest.raises(ValueError):   # the walk without interior rows
        tracer.trace(dataclasses.replace(final, interior=final.dyn[:0],
                                         interior_kind=final.interior_kind[
                                             :0]), sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(final, box=final.box[:, :40]),
                     sums, **kw)
    with pytest.raises(TypeError):
        tracer.trace(dataclasses.replace(final, bleaves=final.bleaves.int()),
                     sums, **kw)


def test_kernel_wrapper_rejects_bad_super_rows(cuda):
    """Super rows of the wrong dtype, width or device, or whose leaf ranges
    run past the leaves, overlap or come out of order, never reach the
    kernel."""
    final = _operands(*_preset("final_scene")(8, 8), cuda)
    sums = torch.zeros((3, 64), dtype=torch.float64, device=cuda)
    kw = dict(nx=8, ny=8, seed=0, sample0=0, n_samples=1, max_depth=1)
    with pytest.raises(TypeError):
        tracer.trace(dataclasses.replace(final, sups=final.sups.half()),
                     sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(
            final, sups=final.sups[:, :7].contiguous()), sums, **kw)
    with pytest.raises(ValueError):
        tracer.trace(dataclasses.replace(final, bsups=final.bsups.cpu()),
                     sums, **kw)
    past, overlap, swapped = (final.sups.clone() for _ in range(3))
    past[-1, 7] += 1.0
    overlap[2, 6] -= 1.0
    swapped[[0, 1]] = swapped[[1, 0]]
    for bad in (past, overlap, swapped):
        with pytest.raises(ValueError):
            tracer.trace(dataclasses.replace(final, sups=bad), sums, **kw)
            torch.cuda.synchronize()


@pytest.mark.parametrize("make,grid", [
    (_preset("final_scene"), True), (_final_inside_box, True),
    (_cubes, True), (_cubes17, False), (wide_grid, True)],
    ids=["final_scene", "inside_a_box", "cubes_20", "cubes_17",
         "wide_grid"])
def test_kernel_grid_strip_pass(cuda, make, grid):
    """The strip pass over a box grid, bit for bit `trace_plain`'s: the
    sums with the walk on and off (where the scene walks), a stats launch's
    sums and counters (its member tests and DDA row in strip form); a
    launch counts as K1E_GRID exactly where the boxes are a grid, runs a
    box grid's instantiation (DYN 2; the one `tracer.k1_instantiation`
    names: 150 × 32 boxes without their leaves and grid table in shared
    memory), and the generic box loop serves a table that is none."""
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    assert bool(ops.grid) == grid and ops.box.shape[0]
    kw = dict(nx=nx, ny=ny, seed=9, sample0=0, n_samples=4, max_depth=50)

    def sums():
        return torch.zeros((3, nx * ny), dtype=torch.float64, device=cuda)

    forms = [ops]
    if ops.feats & tracer.FEAT_DENSE_WALK:
        forms.append(dataclasses.replace(
            ops, feats=ops.feats & ~tracer.FEAT_DENSE_WALK))
    for o in forms:
        before = tracer.K1E_GRID_LAUNCHES, tracer.K1E_BOX_LAUNCHES
        ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
        k = tracer.trace(o, sums(), **kw)
        assert (tracer.K1E_GRID_LAUNCHES - before[0],
                tracer.K1E_BOX_LAUNCHES - before[1]) == (int(grid), 1)
        assert _ran(ran) == [_expected_instantiation(o)]
        assert (_ran(ran)[0][1] == 2) == grid
        p = tracer.trace_plain(o, sums(), **kw)
        torch.cuda.synchronize()
        assert float(k.sum()) > 0 and torch.equal(k, p), float(
            (k - p).abs().max())
    sk, sp = (tracer.new_stats(nx, ny, cuda, dda=True) for _ in range(2))
    k = tracer.trace(ops, sums(), stats=sk, dda=True, **kw)
    p = tracer.trace_plain(ops, sums(), stats=sp, dda=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and torch.equal(sk, sp)


def test_kernel_refuses_a_bad_grid_spec(cuda):
    """A grid spec that does not describe the box table never reaches the
    kernel: the launch raises, it runs no other form."""
    final = _operands(*_preset("final_scene")(8, 8), cuda)
    sums = torch.zeros((3, 64), dtype=torch.float64, device=cuda)
    kw = dict(nx=8, ny=8, seed=0, sample0=0, n_samples=1, max_depth=1)
    before = tracer.K1E_BOX_LAUNCHES
    bad_x = final.bleaves.clone()
    bad_x[3, 0] += 1.0
    for bad in (dict(grid=(20, 19) + final.grid[2:]),
                dict(grid=final.grid[:2] + (1.0, final.grid[3])),
                dict(grid=final.grid[:3] + (99.0,)),
                dict(bleaves=bad_x)):
        with pytest.raises(ValueError):
            tracer.trace(dataclasses.replace(final, **bad), sums, **kw)
    torch.cuda.synchronize()
    assert tracer.K1E_BOX_LAUNCHES == before


@pytest.mark.parametrize("make", [_cornell, _random_spheres,
                                  _preset("final_scene"), _sealed])
def test_kernel_stats_instantiation(cuda, make):
    """K1f's stats launch: its sums equal the production kernel's bit for
    bit, and its per-pixel segments, member tests and warp steps the plain
    version's; one K1F launch each."""
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    kw = dict(nx=nx, ny=ny, seed=3, sample0=0, n_samples=4, max_depth=50)

    def sums():
        return torch.zeros((3, nx * ny), dtype=torch.float64, device=cuda)

    prod = tracer.trace(ops, sums(), **kw)
    before = (tracer.K1F_LAUNCHES, tracer.K1F_STATS_LAUNCHES)
    sk, sp = (tracer.new_stats(nx, ny, cuda) for _ in range(2))
    k = tracer.trace(ops, sums(), stats=sk, **kw)
    assert (tracer.K1F_LAUNCHES, tracer.K1F_STATS_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    p = tracer.trace_plain(ops, sums(), stats=sp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, prod)
    _assert_kernel_matches_plain(k, p)
    for name, a, b in zip(("segments", "sphere tests", "box tests",
                           "warp steps"), tracer.stats_rows(sk, nx * ny),
                          tracer.stats_rows(sp, nx * ny)):
        assert torch.equal(a, b), (name, int(a.sum()), int(b.sum()))
    busy, _, _, steps = tracer.stats_rows(sk, nx * ny)
    assert int(busy.sum()) <= tracer.WARP * int(steps.sum())


@pytest.mark.parametrize("make", [_random_spheres, _preset("final_scene")])
def test_kernel_balanced_equals_unbalanced(cuda, make):
    """The production kernel on a pixel table (kpix 1 and 4, from the cost
    probe and from a seeded order) gives the scanline sums bit for bit;
    with stats, the plain version's counters on the same table."""
    nx, ny = 96, 64
    n_pix = nx * ny
    ops = _operands(*make(nx, ny), cuda)
    kw = dict(nx=nx, ny=ny, seed=8, sample0=0, n_samples=4, max_depth=50)

    def sums():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=cuda)

    ref = tracer.trace(ops, sums(), **kw)
    probe = tracer.cost_permutation(ops, nx, ny, 50, cuda)
    seeded = np.random.default_rng(4).permutation(n_pix).astype(np.int32)
    for order in (probe, seeded):
        for kpix in (1, 4):
            pix = torch.from_numpy(tracer.balanced_pix_table(
                order, n_pix, kpix)[0]).to(cuda)
            before = tracer.K1F_TABLE_LAUNCHES
            got = tracer.trace(ops, sums(), pix=pix, kpix=kpix, **kw)
            assert tracer.K1F_TABLE_LAUNCHES == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, ref), kpix
    sk, sp = (tracer.new_stats(nx, ny, cuda, pix, 4) for _ in range(2))
    k = tracer.trace(ops, sums(), pix=pix, kpix=4, stats=sk, **kw)
    tracer.trace_plain(ops, sums(), pix=pix, kpix=4, stats=sp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, ref) and torch.equal(sk, sp)


@pytest.mark.parametrize("layout", ["scanline", "kpix4"])
@pytest.mark.parametrize("n_samples", [2, 4])
@pytest.mark.parametrize("make", [_random_spheres, _preset("final_scene")])
def test_kernel_flat_loop_counters_and_sums(cuda, make, n_samples, layout):
    """K1's flat loop: the stats launch's four rows equal the plain
    version's, a warp's steps being the largest among its threads of a
    thread's segments over its banks and samples, on the scanline layout
    and on a kpix-4 table, at 2 and 4 spp; the production sums equal the
    stats launch's, the scanline layout's and the plain version's bit for
    bit."""
    nx, ny = 96, 64
    n_pix = nx * ny
    ops = _operands(*make(nx, ny), cuda)
    pix, kpix = None, 1
    if layout == "kpix4":
        order = np.random.default_rng(9).permutation(n_pix).astype(np.int32)
        pix = torch.from_numpy(tracer.balanced_pix_table(
            order, n_pix, 4)[0]).to(cuda)
        kpix = 4
    kw = dict(nx=nx, ny=ny, seed=11, sample0=0, n_samples=n_samples,
              max_depth=50)

    def sums():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=cuda)

    scan = tracer.trace(ops, sums(), **kw)
    prod = tracer.trace(ops, sums(), pix=pix, kpix=kpix, **kw)
    sk, sp = (tracer.new_stats(nx, ny, cuda, pix, kpix) for _ in range(2))
    k = tracer.trace(ops, sums(), pix=pix, kpix=kpix, stats=sk, **kw)
    p = tracer.trace_plain(ops, sums(), pix=pix, kpix=kpix, stats=sp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, prod) and torch.equal(prod, scan)
    assert torch.equal(prod, p), float((prod == p).all(dim=0).double()
                                       .mean())
    for name, a, b in zip(("segments", "sphere tests", "box tests",
                           "warp steps"), tracer.stats_rows(sk, n_pix),
                          tracer.stats_rows(sp, n_pix)):
        assert torch.equal(a, b), (name, int(a.sum()), int(b.sum()))


@pytest.mark.parametrize("name,n_samples", [("final_scene", 1),
                                              ("random_spheres", 2)])
def test_kernel_render_table_is_bit_exact(cuda, name, n_samples):
    """The production kernel on the render's own table (`render_table`: one
    pixel a thread, a block on a 16×8 tile, the tiles heaviest first, made
    on the card, equal to the same order sorted on the CPU) at the
    preset's full size gives the scanline sums and the plain version's
    bit for bit; its stats launch gives the plain version's four rows on
    the same table and the scanline launch's three per-pixel rows."""
    p = builders.PRESETS[name]
    nx, ny = p.nx, p.ny
    n_pix = nx * ny
    ops = _operands(p.build(), p.camera(), cuda)
    pix = tracer.render_table(ops, nx, ny, 50, cuda)
    assert pix.device == ops.rec.device
    # the order sorted on the card is the plain version's on the CPU
    busy = tracer.cost_probe(ops, nx, ny, 50, cuda).cpu()
    assert torch.equal(pix.cpu(), tracer.block_tile_table(busy, nx, ny))
    kw = dict(nx=nx, ny=ny, seed=0, sample0=0, n_samples=n_samples,
              max_depth=50)

    def sums():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=cuda)

    ss = tracer.new_stats(nx, ny, cuda)
    scan = tracer.trace(ops, sums(), stats=ss, **kw)
    got = tracer.trace(ops, sums(), pix=pix, **kw)
    sk, sp = (tracer.new_stats(nx, ny, cuda, pix) for _ in range(2))
    k = tracer.trace(ops, sums(), pix=pix, stats=sk, **kw)
    pl = tracer.trace_plain(ops, sums(), pix=pix, stats=sp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, scan) and torch.equal(k, got)
    assert torch.equal(got, pl), float((got == pl).all(dim=0).double()
                                       .mean())
    for what, a, b in zip(("segments", "sphere tests", "box tests",
                           "warp steps"), tracer.stats_rows(sk, n_pix),
                          tracer.stats_rows(sp, n_pix)):
        assert torch.equal(a, b), (what, int(a.sum()), int(b.sum()))
    for a, b in zip(tracer.stats_rows(sk, n_pix)[:3],
                    tracer.stats_rows(ss, n_pix)[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,nx,ny", [("random_spheres", 96, 64),
                                         ("final_scene", 128, 128)])
def test_kernel_probe_matches_plain(cuda, name, nx, ny):
    """K1f's cost probe launch (`trace_probe`: compact tiles, the samples
    split over blocks, the segments alone) at every split gives the plain
    version's row and warp steps and the scanline stats launch's row 0 bit
    for bit; the render's table is the one made from that row; a call
    counts one K1F_PROBE and K1F_STATS launch and no K1a."""
    ops = _operands(*_preset(name)(nx, ny), cuda)
    n_pix = nx * ny
    kw = dict(nx=nx, ny=ny, seed=tracer.PROBE_SEED, sample0=0,
              n_samples=tracer.PROBE_SPP, max_depth=50)
    st = tracer.new_stats(nx, ny, cuda)
    tracer.trace(ops, torch.zeros((3, n_pix), dtype=torch.float64,
                                  device=cuda), stats=st, **kw)
    row0 = tracer.stats_rows(st, n_pix)[0]

    def zeros(n):
        return torch.zeros(n, dtype=torch.int64, device=cuda)
    for split in (1, 2, 4):
        names = ("K1F_PROBE_LAUNCHES", "K1F_STATS_LAUNCHES",
                 "KERNEL_LAUNCHES")
        before = [getattr(tracer, n) for n in names]
        busy, steps = zeros(n_pix), zeros(tracer.probe_warps(nx, ny, split))
        tracer.trace_probe(ops, busy, split=split, steps=steps, **kw)
        assert [getattr(tracer, n) - b for n, b in zip(names, before)] == [
            1, 1, 0]
        pb, ps = zeros(n_pix), zeros(steps.numel())
        tracer.probe_plain(ops, pb, split=split, steps=ps, **kw)
        torch.cuda.synchronize()
        assert torch.equal(busy, row0), (split, int(busy.sum()),
                                         int(row0.sum()))
        assert torch.equal(busy, pb) and torch.equal(steps, ps), split
    pix = tracer.render_table(ops, nx, ny, 50, cuda)
    assert torch.equal(pix, tracer.block_tile_table(row0, nx, ny))


@pytest.mark.parametrize("make,walk", [
    (_preset("cornell_smoke"), False), (_media_mix, False),
    (_preset("final_scene"), True), (_preset("final_scene"), False),
    (_lattice, False)],
    ids=["cornell_smoke", "media_mix", "final_scene_walk",
         "final_scene_event", "lattice"])
def test_kernel_media_race_is_bit_exact(cuda, make, walk):
    """K1d's media race, override and isotropic scatter in each
    instantiation with MED give the plain version's sums bit for bit:
    cornell_smoke's two rotated boxes (K1a's code with the media), five box
    and sphere media, rotated and not, whose draws come from two groups
    (K1B), final_scene with the dense-medium walk and on the event path
    alone (K1B and its tables) and the lattice's textured media (K1B); one
    K1D launch each, in the instantiation `pick` names, which has MED."""
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    assert ops.feats & tracer.FEAT_MEDIA
    if not walk:
        ops = dataclasses.replace(ops, feats=ops.feats
                                  & ~tracer.FEAT_DENSE_WALK)
    assert bool(ops.feats & tracer.FEAT_DENSE_WALK) == walk
    kw = dict(nx=nx, ny=ny, seed=11, sample0=0, n_samples=4, max_depth=50)
    before = tracer.K1D_LAUNCHES
    ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    k = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                      device=cuda), **kw)
    assert tracer.K1D_LAUNCHES == before + 1
    assert _ran(ran) == [_expected_instantiation(ops)]
    assert _ran(ran)[0][4] == 1
    p = tracer.trace_plain(ops, torch.zeros_like(k), **kw)
    torch.cuda.synchronize()
    assert float(k.sum()) > 0
    assert torch.equal(k, p), float((k == p).all(dim=0).double().mean())


@pytest.mark.parametrize("make,table", [
    (_cornell, False), (_preset("two_spheres"), False),
    (_preset("simple_light"), False), (_random_spheres, False),
    (_random_spheres, True)],
    ids=["cornell_box", "two_spheres", "simple_light", "random_spheres",
         "random_spheres_table"])
def test_kernel_scene_without_media_runs_without_med(cuda, make, table):
    """A scene without a medium runs an instantiation without MED (none of
    the media's code), the one `pick` names, on the scanline layout and on
    its render table, with sums equal to the plain version's."""
    nx, ny = 96, 64
    ops = _operands(*make(nx, ny), cuda)
    assert not ops.feats & tracer.FEAT_MEDIA
    kw = dict(nx=nx, ny=ny, seed=2, sample0=0, n_samples=2, max_depth=50)
    if table:
        kw["pix"] = tracer.render_table(ops, nx, ny, 50, cuda)
    ran = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    k = tracer.trace(ops, torch.zeros((3, nx * ny), dtype=torch.float64,
                                      device=cuda), **kw)
    assert _ran(ran) == [_expected_instantiation(ops, table=table)]
    assert _ran(ran)[0][4] == 0
    p = tracer.trace_plain(ops, torch.zeros_like(k), **kw)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(k, p)


def test_d3_matches_plain(cuda):
    """D3's accumulators equal its plain chain bit for bit, every k, adds and
    FMAs, and the launch count moves once a launch."""
    for k in peak.KS:
        for fma in (False, True):
            before = peak.D3_LAUNCHES
            got = peak.fp32_chain(k, 64, fma, 4, 128, cuda)
            assert peak.D3_LAUNCHES == before + 1
            want = peak.fp32_chain_plain(k, 64, fma, 4 * 128, cuda)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, fma)
    with pytest.raises(ValueError):
        peak.fp32_chain(3, 64, False, 4, 128, cuda)


@pytest.mark.parametrize("make", [_preset("final_scene"), _cubes])
def test_kernel_dda_row_matches_plain(cuda, make):
    """K1f's DDA row: the stats launch with it gives the production kernel's
    sums bit for bit, its five counters equal the plain version's, and its
    other four equal a stats launch without it; one K1F_DDA launch."""
    nx, ny = 96, 64
    n_pix = nx * ny
    ops = _operands(*make(nx, ny), cuda)
    kw = dict(nx=nx, ny=ny, seed=5, sample0=0, n_samples=4, max_depth=50)

    def sums():
        return torch.zeros((3, n_pix), dtype=torch.float64, device=cuda)

    prod = tracer.trace(ops, sums(), **kw)
    before = tracer.K1F_DDA_LAUNCHES
    sk, sp = (tracer.new_stats(nx, ny, cuda, dda=True) for _ in range(2))
    k = tracer.trace(ops, sums(), stats=sk, dda=True, **kw)
    assert tracer.K1F_DDA_LAUNCHES == before + 1
    tracer.trace_plain(ops, sums(), stats=sp, dda=True, **kw)
    s0 = tracer.new_stats(nx, ny, cuda)
    tracer.trace(ops, sums(), stats=s0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k, prod)
    assert torch.equal(sk, sp), (int(tracer.dda_row(sk, n_pix).sum()),
                                 int(tracer.dda_row(sp, n_pix).sum()))
    for a, b in zip(tracer.stats_rows(s0, n_pix),
                    tracer.stats_rows(sk, n_pix, dda=True)):
        assert torch.equal(a, b)
    row = tracer.dda_row(sk, n_pix)
    assert 0 < int(row.sum()) < int(tracer.stats_rows(sk, n_pix, True)[2]
                                    .sum())


@pytest.mark.parametrize("threads", [8192, 1000])
def test_d1_matches_plain(cuda, threads):
    """D1's accumulator and checksum equal the plain version's bit for bit,
    both variants and band counts, k = 2 and 22, a full and a ragged last
    block; one D1 launch each."""
    col = microbench.attr_cols(threads).to(cuda)
    for n_bands in microbench.BANDS:
        table = microbench.attr_table(n_bands).to(cuda)
        for k in microbench.D1_K:
            want = microbench.attr_read_plain(table, col, k)
            for shared in (False, True):
                before = microbench.D1_LAUNCHES
                got = microbench.attr_read(table, col, k, shared=shared)
                assert microbench.D1_LAUNCHES == before + 1
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (n_bands, k, shared)
                assert torch.equal(got[1], want[1]), (n_bands, k, shared)
            assert (want[0] > 0).all()


@pytest.mark.parametrize("threads", [8192, 96])
def test_d2_matches_plain(cuda, threads):
    """D2's outputs and vote folds equal the plain version's bit for bit, the
    four kinds, k = 64 and 70, on the tool's lanes and on signed ones; one
    D2 launch each."""
    rec = microbench.member_rec().to(cuda)
    signed = torch.from_numpy(np.random.default_rng(5).integers(
        -3000, 1000, threads, dtype=np.int32))
    for x in (microbench.member_x(threads), signed):
        x = x.to(cuda)
        for kind in microbench.KINDS:
            for k in (64, 70):
                before = microbench.D2_LAUNCHES
                got = microbench.member(rec, x, k, kind)
                assert microbench.D2_LAUNCHES == before + 1
                want = microbench.member_plain(rec, x, k, kind)
                torch.cuda.synchronize()
                assert torch.equal(got[0], want[0]), (kind, k)
                assert torch.equal(got[1], want[1]), (kind, k)
    with pytest.raises(ValueError):
        microbench.member(rec, x[:40], 4, "any")


def test_d1_d2_full_wave_match_plain(cuda):
    """At each kernel's own full wave (SMs × the blocks of it an SM holds),
    D1 and D2 equal their plain versions bit for bit; the wave is whole
    blocks on every SM, one block of D1 staged at 4 bands (180,224 B)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = {}
    for n_bands in microbench.BANDS:
        table = microbench.attr_table(n_bands).to(cuda)
        for shared in (False, True):
            n = waves[(n_bands, shared)] = microbench.full_wave(
                "attr_read", n_bands, shared)
            assert n > 0 and n % (sms * 256) == 0
            col = microbench.attr_cols(n).to(cuda)
            got = microbench.attr_read(table, col, 2, shared=shared)
            want = microbench.attr_read_plain(table, col, 2)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (n_bands, shared)
            assert torch.equal(got[1], want[1]), (n_bands, shared)
    assert waves[(4, True)] == sms * 256
    rec = microbench.member_rec().to(cuda)
    for kind in microbench.KINDS:
        n = microbench.full_wave(kind)
        assert n > 0 and n % (sms * 256) == 0
        x = microbench.member_x(n).to(cuda)
        got = microbench.member(rec, x, 64, kind)
        want = microbench.member_plain(rec, x, 64, kind)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), kind
        assert torch.equal(got[1], want[1]), kind


def _grad_spheres(device, background=BG_BLACK):
    """Lambertian + light with a sphere light, a flipped rect and a
    rotated-translated cube: the sphere branch of K2/K3."""
    b = SceneBuilder(background=background)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.73, 0.73, 0.73)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.lambertian(b.solid(0.8, 0.7, 0.6)))
    b.sphere((-1.5, 3.5, 0.0), 0.5, b.diffuse_light(b.solid(3.0, 2.0, 1.0)))
    xf = b.transform(offset=(0.4, 0.0, 0.2), rotate_axis="y", angle_deg=20.0)
    b.cube((-2.4, 0.0, -1.4), (-1.4, 1.6, -0.4),
           b.lambertian(b.solid(0.4, 0.6, 0.3)), xform=xf)
    return b.build(device)


def _geo_scene(device, tilt=inverse_render.TRUE_TILT_DEG):
    return inverse_render.build_geo_scene(
        inverse_render.TRUE_GEO_ALBEDO, inverse_render.TRUE_GEO_EMIT, tilt,
        device=device)


def _grad_operands(scene, device, n=4096, max_depth=6,
                   camera_of=inverse_render.camera):
    cam = camera_of(device)
    g = torch.Generator(device=device)
    g.manual_seed(1)
    pid = torch.randint(0, 200 * 200, (n,), generator=g, device=device)
    o, d, _ = inverse_render.camera_lane_rays(cam, pid, 5, 200, 200)
    u = grad.fast_draws(7, n, max_depth + 1, device)
    ct = torch.rand(n, 3, generator=g, device=device)
    return (grad.fast_grad_record(scene).detach(), o, d, u, ct,
            grad.fast_grad_config(scene))


def _k2_k3(rec, o, d, u, ct, cfg, md):
    """K2 with its winner tape, then K3 on that tape twice → (rad, K3's
    (d_rec, d_o, d_d)); the tape equals the plain tape bit for bit on every
    entry the plain tape defines (TAPE_NONE marks the rest, which K2 does
    not write), and the two K3 launches are bit-identical (d_rec is reduced
    in a fixed order)."""
    k, tape = grad.grad_fwd(rec, o, d, u, cfg, md, tape=True)
    dk = grad.grad_bwd(rec, o, d, u, ct, cfg, md, tape=tape)
    again = grad.grad_bwd(rec, o, d, u, ct, cfg, md, tape=tape)
    _, want = grad.trace_tiles_plain(rec, o, d, u, cfg, md, tape=True)
    torch.cuda.synchronize()
    defined = want[:, 0] != grad.TAPE_NONE
    for row in (0, 1):
        assert torch.equal(tape[:, row][defined], want[:, row][defined])
    for a, b in zip(dk, again):
        assert torch.equal(a, b)
    return k, dk


@pytest.mark.parametrize("make", [
    lambda dev: inverse_render.build_scene(device=dev), _grad_spheres])
def test_k2_matches_twin_and_k3_matches_autograd(cuda, make):
    """K2 vs trace_tiles_plain: ≥ 99% of lanes within 1e-4 relative, channel
    means within 1e-4; its winner tape the plain tape's (`_k2_k3`). K3 on
    that tape vs autograd of the twin: d_rec within 1e-4 of its scale (sums
    in another order), d_o and d_d exact zeros; d_rec the same in two
    launches. One launch a call."""
    rec, o, d, u, ct, cfg = _grad_operands(make(cuda), cuda)
    before = (grad.K2_LAUNCHES, grad.K3_LAUNCHES)
    k, dk = _k2_k3(rec, o, d, u, ct, cfg, 6)
    assert (grad.K2_LAUNCHES, grad.K3_LAUNCHES) == (before[0] + 1,
                                                    before[1] + 2)
    p = grad.trace_tiles_plain(rec, o, d, u, cfg, 6)
    assert torch.isfinite(k).all() and float(k.sum()) > 0
    close = torch.isclose(k, p, rtol=1e-4, atol=1e-6).all(dim=1)
    assert float(close.double().mean()) >= 0.99
    assert torch.allclose(k.mean(dim=0), p.mean(dim=0), rtol=1e-4, atol=0)
    dp = grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, 6)
    scale = float(dp[0].abs().max())
    assert scale > 0
    assert float((dk[0] - dp[0]).abs().max()) <= 1e-4 * scale
    assert not dk[1].any() and not dk[2].any()


def test_trace_fast_on_cuda_backprops_through_k3(cuda):
    scene = inverse_render.build_scene(device=cuda)
    rec, o, d, u, ct, cfg = _grad_operands(scene, cuda, n=1024)
    albedo = torch.tensor([0.3, 0.4, 0.5], device=cuda, requires_grad=True)
    emit = torch.tensor(4.0, device=cuda, requires_grad=True)
    light_tex, box_tex = inverse_render.param_tex_rows(scene)
    s2 = inverse_render.with_params(scene, light_tex, box_tex, albedo, emit)
    before = grad.K3_LAUNCHES
    (grad.trace_fast(s2, o, d, 0, max_depth=6, cfg=cfg, u=u) * ct).sum() \
        .backward()
    assert grad.K3_LAUNCHES == before + 1
    assert torch.isfinite(albedo.grad).all() and float(emit.grad) != 0


def test_fused_kernels_reject_scenes_outside_scope_on_cuda(cuda):
    """A noise texture (outside the JAX tier's scope too) raises on the card,
    as does a depth past MAX_DEPTH: no fallback."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.noise(4.0)))
    scene = b.build(cuda)
    o = torch.zeros(64, 3, device=cuda)
    d = torch.ones(64, 3, device=cuda)
    with pytest.raises(tracer.UnsupportedScene, match="scope"):
        grad.trace_fast(scene, o, d, 0, max_depth=6)
    with pytest.raises(tracer.UnsupportedScene, match="depth 17"):
        grad.trace_fast(probe_scene().to(cuda), o, d, 0, max_depth=17,
                        cfg=grad.fast_grad_config(probe_scene()))


def _assert_cols_close(got, want, atol_scale, what):
    """Column by column: |got − want| ≤ atol_scale · the column's
    max|want|; a column exactly zero in want is exactly zero in got."""
    for c in range(want.shape[-1]):
        g, w = got[..., c], want[..., c]
        scale = float(w.abs().max())
        if scale == 0:
            assert not g.any(), f"{what}: column {c} is not zero"
        else:
            err = float((g - w).abs().max())
            assert err <= atol_scale * scale, (what, c, err, scale)


@pytest.mark.parametrize("make,camera_of", [
    (_geo_scene, inverse_render.geo_camera),
    (lambda dev: _grad_spheres(dev, BG_SKY), inverse_render.camera)])
def test_k2_sky_bit_equal_and_k3_geometric_adjoint(cuda, make, camera_of):
    """Under the sky: K2 equals the twin bit for bit (the twin's op order,
    -fmad=false, rsqrtf for torch.rsqrt), and so does its tape (`_k2_k3`);
    K3's d_rec within 1e-4 of each column's own scale of autograd through
    the twin (sums in another order), the same columns live; d_o and d_d
    within 1e-4 of their scale."""
    rec, o, d, u, ct, cfg = _grad_operands(make(cuda), cuda,
                                           camera_of=camera_of)
    assert "sky" in cfg[1]
    k, dk = _k2_k3(rec, o, d, u, ct, cfg, 6)
    p = grad.trace_tiles_plain(rec, o, d, u, cfg, 6)
    torch.cuda.synchronize()
    assert float(p.sum()) > 0 and torch.equal(k, p)
    dp = grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, 6)
    for g in dk:
        assert torch.isfinite(g).all()
    _assert_cols_close(dk[0], dp[0], 1e-4, "d_rec")
    assert float(dp[0][:, grad.C_KN:grad.C_KN + 3].abs().max()) > 0
    for g, w in zip(dk[1:], dp[1:]):
        scale = float(w.abs().max())
        assert scale > 0 and float((g - w).abs().max()) <= 1e-4 * scale


def test_k3_grazing_probe_is_finite(cuda):
    """Rays aimed at the ground sphere's horizon (a graze of the radius-1000
    sphere, where dt/d disc grows without bound) and at the tilted cube's
    edges: K3's gradients and autograd's through the twin are finite, and
    agree (d_rec per column, d_o and d_d, each 1e-4 of its scale)."""
    scene = _geo_scene(cuda)
    cam = inverse_render.geo_camera(cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    n = 4096
    origin = cam.origin.expand(n, 3)
    # the horizon from (0, 2.2, 8): sin α = √(2h/R) below the horizontal
    dy = -math.sqrt(2 * 2.2 / 1000.0) + 2e-3 * (
        torch.rand(n // 2, generator=g, device=cuda) - 0.5)
    horizon = torch.stack([torch.rand(n // 2, generator=g, device=cuda) - 0.5,
                           dy, -torch.ones(n // 2, device=cuda)], 1)
    # the cube's edges: corners ± 0.9 in two axes, rotated by the tilt
    a = math.radians(inverse_render.TRUE_TILT_DEG)
    edge = (torch.randint(0, 2, (n // 2, 3), generator=g, device=cuda)
            * 1.8 - 0.9)
    edge[:, 0] = (torch.rand(n // 2, generator=g, device=cuda) - 0.5) * 1.8
    edge = edge + 1e-3 * (torch.rand(n // 2, 3, generator=g, device=cuda)
                          - 0.5)
    y = edge[:, 1] * math.cos(a) - edge[:, 2] * math.sin(a) + 1.3
    z = edge[:, 1] * math.sin(a) + edge[:, 2] * math.cos(a)
    cube = torch.stack([edge[:, 0], y, z], 1) - origin[: n // 2]
    o = origin.contiguous()
    d = torch.cat([horizon, cube]).contiguous()
    u = grad.fast_draws(9, n, 7, cuda)
    ct = torch.rand(n, 3, generator=g, device=cuda)
    rec = grad.fast_grad_record(scene).detach()
    cfg = grad.fast_grad_config(scene)
    _, dk = _k2_k3(rec, o, d, u, ct, cfg, 6)
    dp = grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, 6)
    torch.cuda.synchronize()
    for name, g_k, w in zip(("d_rec", "d_o", "d_d"), dk, dp):
        assert torch.isfinite(g_k).all(), f"K3 {name}"
        assert torch.isfinite(w).all(), f"autograd {name}"
    _assert_cols_close(dk[0], dp[0], 1e-4, "d_rec")
    for g_k, w in zip(dk[1:], dp[1:]):
        assert float((g_k - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_trace_fast_on_cuda_reaches_the_tilt(cuda):
    """The geometry step's candidate on the card: the gradient of a
    weighted radiance with respect to θ, through K3, fast_grad_record and
    the transform row's sin and cos, agrees with autograd through the twin
    on the same card within 1e-3 of its size, as do the albedo's and the
    emission's."""
    scene = _geo_scene(cuda, 0.0)
    rec, o, d, u, ct, cfg = _grad_operands(
        scene, cuda, camera_of=inverse_render.geo_camera)
    light_tex, cube_tex = inverse_render.geo_param_rows(scene)
    grads = []
    for fast in (True, False):
        albedo = torch.tensor([0.3, 0.4, 0.5], device=cuda,
                              requires_grad=True)
        emit = torch.tensor(4.0, device=cuda, requires_grad=True)
        theta = torch.tensor(0.3, device=cuda, requires_grad=True)
        s2 = inverse_render.with_params(scene, light_tex, cube_tex, albedo,
                                        emit, theta)
        before = grad.K3_LAUNCHES
        if fast:
            rad = grad.trace_fast(s2, o, d, 0, max_depth=6, cfg=cfg, u=u)
        else:
            rad = grad.trace_tiles_plain(grad.fast_grad_record(s2), o, d, u,
                                         cfg, 6)
        (rad * ct).sum().backward()
        assert grad.K3_LAUNCHES == before + int(fast)
        grads.append([albedo.grad, emit.grad, theta.grad])
    for got, want in zip(*grads):
        assert torch.isfinite(got).all() and float(want.abs().max()) > 0
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())


def probe_scene(builder_cls=SceneBuilder, background=BG_SKY):
    """The JAX fused tier's probe scene (tests/test_pallas_grad.py
    probe_scene): a floor, a red wall, a flipped light, a metal sphere
    (fuzz 0.2), a glass sphere (1.5), a lambertian sphere and a rotated,
    translated cube: 12 prims. builder_cls: this package's SceneBuilder or
    the JAX one."""
    b = builder_cls(background=background)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.73, 0.73, 0.73)))
    b.rect("yz", 0, -3, 6, 3, -3.0, b.lambertian(b.solid(0.65, 0.05, 0.05)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    b.sphere((-1.0, 0.8, 0.6), 0.7, b.dielectric(1.5))
    b.sphere((0.0, 0.6, -1.2), 0.6, b.lambertian(b.solid(0.2, 0.5, 0.8)))
    xf = b.transform(offset=(0.4, 0.0, 0.2), rotate_axis="y", angle_deg=20.0)
    b.cube((-2.4, 0.0, -1.4), (-1.4, 1.6, -0.4),
           b.lambertian(b.solid(0.4, 0.6, 0.3)), xform=xf)
    return b.build()


def checker_scene(builder_cls=SceneBuilder):
    """A checker floor at y = 0.37 (off the sin = 0 planes), an emissive
    checker sphere and a lambertian sphere under the sky
    (tests/test_pallas_grad.py test_checker_matches_xla_tier)."""
    b = builder_cls(background=BG_SKY)
    b.rect("zx", -4, -4, 4, 4, 0.37, b.lambertian(b.checker(
        b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))))
    b.sphere((0.0, 1.37, 0.0), 1.0, b.diffuse_light(b.checker(
        b.solid(3.0, 0.5, 0.5), b.solid(0.5, 3.0, 0.5))))
    b.sphere((2.2, 1.1, 0.3), 0.8, b.lambertian(b.solid(0.3, 0.4, 0.8)))
    return b.build()


def glass_scene(builder_cls=SceneBuilder):
    """A glass sphere (1.5) of radius 1 at the origin over a floor, under
    the sky (tests/test_pallas_grad.py test_dielectric_interior_rays_match_
    xla_tier)."""
    b = builder_cls(background=BG_SKY)
    b.rect("zx", -4, -4, 4, 4, -2.0, b.lambertian(b.solid(0.6, 0.3, 0.2)))
    b.sphere((0.0, 0.0, 0.0), 1.0, b.dielectric(1.5))
    return b.build()


def _probe_rays(n, device, seed=3):
    """Rays from (0, 2, 8) into the scene (tools/tpu_parity.py's fused-tier
    rays), numpy-seeded."""
    r = np.random.default_rng(seed)
    d = np.stack([r.uniform(-0.7, 0.7, n), r.uniform(-0.45, 0.25, n),
                  -np.ones(n)], -1).astype(np.float32)
    o = torch.tensor([0.0, 2.0, 8.0], device=device).expand(n, 3)
    return o.contiguous(), torch.from_numpy(d).to(device)


def _interior_rays(n, device, seed=12):
    """Rays starting inside the glass sphere at a spread of angles."""
    r = np.random.default_rng(seed)
    o = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


MATERIAL_SCENES = {
    "probe_sky": (probe_scene, _probe_rays),
    "probe_black": (lambda: probe_scene(background=BG_BLACK), _probe_rays),
    "checker": (checker_scene, _probe_rays),
    "interior": (glass_scene, _interior_rays),
}


def _hold_k2_k3(rec, o, d, u, ct, cfg, md):
    """K2 bit-equal to the twin; K3's d_rec within 1e-4 of each column's
    own scale of autograd through the twin, the same columns live; d_o and
    d_d within 1e-4 of their scale (exact zeros without the sky); all
    finite; the tape and the repeat as `_k2_k3` holds them. Returns K3's
    d_rec."""
    before = (grad.K2_LAUNCHES, grad.K3_LAUNCHES)
    k, dk = _k2_k3(rec, o, d, u, ct, cfg, md)
    p = grad.trace_tiles_plain(rec, o, d, u, cfg, md)
    torch.cuda.synchronize()
    assert (grad.K2_LAUNCHES, grad.K3_LAUNCHES) == (before[0] + 1,
                                                    before[1] + 2)
    assert float(p.sum()) > 0 and torch.equal(k, p)
    dp = grad.trace_tiles_plain_vjp(rec, o, d, u, ct, cfg, md)
    for name, g_k, w in zip(("d_rec", "d_o", "d_d"), dk, dp):
        assert torch.isfinite(g_k).all(), f"K3 {name}"
        assert torch.isfinite(w).all(), f"autograd {name}"
    _assert_cols_close(dk[0], dp[0], 1e-4, "d_rec")
    live_k = dk[0].abs().amax(dim=0) > 0
    assert torch.equal(live_k, dp[0].abs().amax(dim=0) > 0)
    for g_k, w in zip(dk[1:], dp[1:]):
        if "sky" in cfg[1]:
            scale = float(w.abs().max())
            assert scale > 0 and float((g_k - w).abs().max()) <= 1e-4 * scale
        else:
            assert not g_k.any() and not w.any()
    return dk[0]


@pytest.mark.parametrize("name,md", [
    ("probe_sky", 6), ("probe_black", 6), ("checker", 6), ("interior", 6),
    ("probe_sky", 16)])
def test_k2_k3_materials_match_twin_and_autograd(cuda, name, md):
    """Metal, glass and the checker at 4,096 lanes (probe_scene also at the
    tape's full depth, 16): K2 bit-equal to the twin (its op order,
    -fmad=false, Schlick's multiplies), K3 per column against autograd;
    fuzz and ref_idx reach C_PARAM under the sky, the checker's odd rows
    C_TEX_O."""
    make, rays = MATERIAL_SCENES[name]
    scene = make().to(cuda)
    cfg = grad.fast_grad_config(scene)
    n = 4096
    o, d = rays(n, cuda)
    u = grad.fast_draws(7, n, md + 1, cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    ct = torch.rand(n, 3, generator=g, device=cuda)
    d_rec = _hold_k2_k3(grad.fast_grad_record(scene).detach(), o, d, u, ct,
                        cfg, md)
    if name in ("probe_sky", "interior"):
        assert float(d_rec[:, grad.C_PARAM].abs().max()) > 0
    if name == "checker":
        assert float(d_rec[:, grad.C_TEX_O:grad.C_TEX_O + 3].abs().max()) > 0


def test_trace_fast_on_cuda_reaches_fuzz_ref_idx_and_odd_rows(cuda):
    """The fused tier's hardware check (tools/tpu_parity.py fast_grad_tier)
    on the card: the mean radiance's gradient through trace_fast (K2, K3)
    into the six scene leaves equals autograd through the twin, leaf by
    leaf within 1e-4 of its scale, on probe_scene (fuzz and ref_idx in
    mat_param) and the checker scene (both children's tex_color rows)."""
    leaves = ("prim_data", "mat_param", "tex_color", "xf_offset", "xf_sin",
              "xf_cos")
    for make in (probe_scene, checker_scene):
        scene0 = make().to(cuda)
        cfg = grad.fast_grad_config(scene0)
        o, d = _probe_rays(8192, cuda)
        u = grad.fast_draws(7, 8192, 6, cuda)
        grads = []
        for fast in (True, False):
            scene = dataclasses.replace(scene0, **{
                k: getattr(scene0, k).clone().requires_grad_(True)
                for k in leaves})
            before = grad.K3_LAUNCHES
            if fast:
                rad = grad.trace_fast(scene, o, d, 0, max_depth=5, cfg=cfg,
                                      u=u)
            else:
                rad = grad.trace_tiles_plain(grad.fast_grad_record(scene), o,
                                             d, u, cfg, 5)
            got = torch.autograd.grad(rad.mean(), [getattr(scene, k)
                                                   for k in leaves],
                                      allow_unused=True)
            assert grad.K3_LAUNCHES == before + int(fast)
            grads.append([torch.zeros_like(getattr(scene, k)) if x is None
                          else x for k, x in zip(leaves, got)])
        for k, got, want in zip(leaves, *grads):
            assert torch.isfinite(got).all(), k
            scale = max(float(want.abs().max()), 1e-3)
            assert float((got - want).abs().max()) <= 1e-4 * scale, k
        g = dict(zip(leaves, grads[0]))
        mats = scene0.prim_material.long()
        if make is probe_scene:
            # the metal's fuzz and the glass's index
            assert float(g["mat_param"][mats[3]].abs()) > 0
            assert float(g["mat_param"][mats[4]].abs()) > 0
        else:
            child = scene0.tex_child[scene0.tex_type == TEX_CHECKER].flatten().long()
            assert (g["tex_color"][child].abs().amax(dim=1) > 0).all()


def test_k3_grazing_refraction_probe_is_finite(cuda):
    """Rays aimed at the glass sphere's silhouette from outside (a graze of
    the sphere's own root, where dt/d disc grows without bound) and, from
    inside, at the critical angle (impact parameter 1/1.5 ± 1e-3, where
    d √disc_r / d disc_r grows without bound on the refracted branch): K3's
    gradients and autograd's through the twin are finite and agree (d_rec
    per column, d_o and d_d, each 1e-4 of its scale)."""
    scene = glass_scene().to(cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    n = 4096
    h = n // 2

    def unit(x):
        return x / x.norm(dim=1, keepdim=True)

    # outside: from (0, 0, 8) to tangent points, the line's distance to the
    # centre 1 ± 1e-3
    o_out = torch.tensor([0.0, 0.0, 8.0], device=cuda).expand(h, 3)
    phi = 2 * math.pi * torch.rand(h, generator=g, device=cuda)
    b = 1.0 + 2e-3 * (torch.rand(h, generator=g, device=cuda) - 0.5)
    s = b / 8.0
    d_out = torch.stack([s * torch.cos(phi), s * torch.sin(phi),
                         -torch.sqrt(1 - s * s)], 1)
    # inside: o = b·e ⟂ d, so the ray meets the unit sphere at sin θ = b
    a = unit(torch.randn(h, 3, generator=g, device=cuda))
    e = unit(torch.cross(a, torch.randn(h, 3, generator=g, device=cuda),
                         dim=1))
    bi = 1.0 / 1.5 + 2e-3 * (torch.rand(h, generator=g, device=cuda) - 0.5)
    o = torch.cat([o_out, bi[:, None] * e]).contiguous()
    d = torch.cat([d_out, a]).contiguous()
    u = grad.fast_draws(9, n, 7, cuda)
    ct = torch.rand(n, 3, generator=g, device=cuda)
    cfg = grad.fast_grad_config(scene)
    c = {}
    grad.trace_tiles_plain(grad.fast_grad_record(scene).detach(), o, d, u,
                           cfg, 6, counts=c)
    assert c["refracts"] > 0 and c["u3_reads"] < c["glass_scatters"]
    _hold_k2_k3(grad.fast_grad_record(scene).detach(), o, d, u, ct, cfg, 6)
