"""The eight reference scenes and their render presets (reference
tests/test.rs:89-523).

Counterpart of `raytracing_rust_tpu/models/builders.py`, builder for
builder: the same geometry, materials and seeded numpy draws, so each preset
builds tables equal field by field to the JAX package's. Stochastic scenes
(random_spheres, final_scene) use a seeded numpy generator; the reference's
`thread_rng()` is unseeded, so only the distributions match it.

Documented deviations from the reference (the JAX package's, kept):
* background — the no-light scenes render the book's sky gradient
  (commented out at src/color.rs:18-20) instead of black;
* final_scene's light rect is declared with inverted bounds
  (tests/test.rs:444-452) and could never be hit; it is built with the
  book's intended bounds unless compat_dead_light=True;
* cornell_smoke's XY wall sits at k=555 (the book's back wall) unless
  compat_front_wall=True keeps the reference's k=0 typo.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.image_io import load_image
from .scene import BG_BLACK, BG_SKY, SceneBuilder, SceneTables

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def _earth_pixels() -> np.ndarray:
    return load_image(os.path.join(_ASSET_DIR, "earthmap.jpg"))


def random_spheres(seed: int = 0, device="cpu") -> SceneTables:
    """~404-sphere scene with motion blur (reference tests/test.rs:89-163)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=BG_SKY)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    origin = np.array([4.0, 0.2, 0.0])
    for a in range(-10, 10):
        for c in range(-10, 10):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               c + 0.9 * rng.random()])
            if np.linalg.norm(center - origin) <= 0.9:
                continue
            if choose < 0.8:
                albedo = b.solid(rng.random() * rng.random(),
                                 rng.random() * rng.random(),
                                 rng.random() * rng.random())
                b.moving_sphere(center,
                                center + np.array([0, 0.5 * rng.random(), 0]),
                                0.0, 1.0, 0.2, b.lambertian(albedo))
            elif choose < 0.95:
                albedo = b.solid(0.5 * (1 + rng.random()),
                                 0.5 * (1 + rng.random()),
                                 0.5 * (1 + rng.random()))
                b.sphere(center, 0.2, b.metal(albedo, 0.5 * rng.random()))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.0))
    return b.build(device)


def two_spheres(device="cpu") -> SceneTables:
    """reference tests/test.rs:165-182"""
    b = SceneBuilder(background=BG_SKY)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    lam = b.lambertian(checker)
    b.sphere((0, -10, 0), 10.0, lam)
    b.sphere((0, 10, 0), 10.0, lam)
    return b.build(device)


def two_perlin_spheres(device="cpu") -> SceneTables:
    """reference tests/test.rs:184-198"""
    b = SceneBuilder(background=BG_SKY)
    lam = b.lambertian(b.noise(4.0))
    b.sphere((0, -1000, 0), 1000.0, lam)
    b.sphere((0, 2, 0), 2.0, lam)
    return b.build(device)


def earth(compat_uv_bug: bool = False, device="cpu") -> SceneTables:
    """reference tests/test.rs:200-209. compat_uv_bug=True reproduces the
    reference's sphere-UV constant bug (FRAC_2_PI where the formula wants
    π/2, src/sphere.rs:13)."""
    b = SceneBuilder(background=BG_SKY, compat_uv_bug=compat_uv_bug)
    b.sphere((0, 0, 0), 2.0, b.lambertian(b.image(_earth_pixels())))
    return b.build(device)


def simple_light(device="cpu") -> SceneTables:
    """reference tests/test.rs:211-240"""
    b = SceneBuilder(background=BG_BLACK)
    lam = b.lambertian(b.noise(4.0))
    b.sphere((0, -1000, 0), 1000.0, lam)
    b.sphere((0, 2, 0), 2.0, lam)
    light = b.diffuse_light(b.solid(4, 4, 4))
    b.sphere((0, 7, 0), 2.0, light)
    b.rect("xy", 3.0, 1.0, 5.0, 3.0, -2.0, light)
    return b.build(device)


def _cornell_walls(b: SceneBuilder, light_rect, smoke: bool = False,
                   smoke_compat_front_wall: bool = False):
    red = b.lambertian(b.solid(0.65, 0.05, 0.05))
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    green = b.lambertian(b.solid(0.12, 0.45, 0.15))
    b.rect("yz", 0, 0, 555, 555, 555, green, flip=True)
    b.rect("yz", 0, 0, 555, 555, 0, red)
    light_rect(b)
    if not smoke:
        # cornell_box walls (tests/test.rs:268-295): floor twice (flipped,
        # then not: the builder keeps the unflipped one), ceiling XY k=555
        # flipped
        b.rect("zx", 0, 0, 555, 555, 0, white, flip=True)
        b.rect("zx", 0, 0, 555, 555, 0, white)
        b.rect("xy", 0, 0, 555, 555, 555, white, flip=True)
    else:
        # cornell_smoke walls (tests/test.rs:351-377)
        b.rect("zx", 0, 0, 555, 555, 0, white, flip=True)
        b.rect("zx", 0, 0, 555, 555, 555, white)
        if smoke_compat_front_wall:
            b.rect("xy", 0, 0, 555, 555, 0, white, flip=True)
        else:
            b.rect("xy", 0, 0, 555, 555, 555, white, flip=True)
    return white


def cornell_box(device="cpu") -> SceneTables:
    """reference tests/test.rs:242-323"""
    b = SceneBuilder(background=BG_BLACK)

    def light(b):
        b.rect("zx", 227, 213, 332, 343, 554,
               b.diffuse_light(b.solid(15, 15, 15)))

    white = _cornell_walls(b, light)
    xf1 = b.transform(offset=(130, 0, 65), rotate_axis="y", angle_deg=-18.0)
    b.cube((0, 0, 0), (165, 165, 165), white, xform=xf1)
    xf2 = b.transform(offset=(265, 0, 295), rotate_axis="y", angle_deg=15.0)
    b.cube((0, 0, 0), (165, 330, 165), white, xform=xf2)
    return b.build(device)


def cornell_smoke(compat_front_wall: bool = False, device="cpu") -> SceneTables:
    """reference tests/test.rs:325-417"""
    b = SceneBuilder(background=BG_BLACK)

    def light(b):
        b.rect("zx", 127, 113, 432, 443, 554, b.diffuse_light(b.solid(7, 7, 7)))

    _cornell_walls(b, light, smoke=True,
                   smoke_compat_front_wall=compat_front_wall)
    xf1 = b.transform(offset=(130, 0, 65), rotate_axis="y", angle_deg=-18.0)
    b.medium_box((0, 0, 0), (165, 165, 165), 0.01, b.solid(1, 1, 1), xform=xf1)
    xf2 = b.transform(offset=(265, 0, 295), rotate_axis="y", angle_deg=15.0)
    b.medium_box((0, 0, 0), (165, 330, 165), 0.01, b.solid(0, 0, 0), xform=xf2)
    return b.build(device)


def final_scene(seed: int = 0, compat_dead_light: bool = False,
                device="cpu") -> SceneTables:
    """reference tests/test.rs:419-523 (~3.4k primitives after cube split)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=BG_BLACK)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    ground = b.lambertian(b.solid(0.48, 0.83, 0.53))

    # 20×20 ground cubes of random height (tests/test.rs:424-441)
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = 100.0 * (rng.random() + 0.01)
            b.cube((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    light = b.diffuse_light(b.solid(7, 7, 7))
    if compat_dead_light:
        b.rect("zx", 147, 412, 123, 423, 554, light)
    else:
        b.rect("zx", 147, 123, 412, 423, 554, light)

    center = np.array([400.0, 400.0, 200.0])
    b.moving_sphere(center, center + np.array([30.0, 0, 0]), 0.0, 1.0, 50.0,
                    b.lambertian(b.solid(0.7, 0.3, 0.1)))
    b.sphere((260, 150, 45), 50.0, b.dielectric(1.5))
    b.sphere((0, 150, 145), 50.0, b.metal(b.solid(0.8, 0.8, 0.9), 10.0))

    # glass sphere with an interior blue medium (test.rs:469-483)
    b.sphere((360, 150, 145), 70.0, b.dielectric(1.5))
    b.medium_sphere((360, 150, 145), 70.0, 0.2, b.solid(0.2, 0.4, 0.9))
    # global mist (test.rs:484-489)
    b.medium_sphere((0, 0, 0), 5000.0, 0.0001, b.solid(1, 1, 1))

    b.sphere((400, 200, 400), 100.0, b.lambertian(b.image(_earth_pixels())))
    b.sphere((220, 280, 300), 80.0, b.lambertian(b.noise(0.1)))

    # 1000 white spheres in a rotated+translated cluster (test.rs:503-521)
    xf = b.transform(offset=(-100, 270, 395), rotate_axis="y", angle_deg=15.0)
    for _ in range(1000):
        b.sphere(165.0 * rng.random(3), 10.0, white, xform=xf)
    return b.build(device)


def lattice_scene(device="cpu") -> SceneTables:
    """The feature-lattice scene, not a reference preset (the JAX package's
    `lattice_scene`): every legal texture, material and prim combination
    the reference allows but no reference scene uses. DiffuseLight is
    texture-generic (reference src/material.rs:133-151), image textures go
    on any hittable (src/texture.rs:73-108), and Isotropic medium albedo is
    texture-generic (src/material.rs:153-173): emissive checker, noise and
    image lights, an image on a rotated, a plain and a flipped rect and on
    a flipped sphere, and checker, noise and image medium albedo."""
    def texels(seed, h=8, w=16):
        r = np.random.default_rng(seed)
        return (np.rint(r.uniform(26, 230, (h, w, 3))).astype(np.float32)
                / 255.0).astype(np.float32)

    b = SceneBuilder(background=BG_BLACK)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    b.rect("zx", -6, -6, 6, 6, 0.0, white)                      # floor
    # emissive checker, noise and image lights
    b.rect("zx", -2, -2, 2, 2, 8.0,
           b.diffuse_light(b.checker(b.solid(4, 0.5, 0.5),
                                     b.solid(0.5, 4, 0.5))), flip=True)
    b.sphere((-4, 1.5, 0), 0.8, b.diffuse_light(b.noise(2.0)))
    # (the reference's ImageTexture is u8-backed: emission is capped at 1)
    b.sphere((4, 1.5, 0), 0.8, b.diffuse_light(b.image(texels(5))))
    # an image on rects: a rotated frame, a plain one, a flipped one
    img = b.lambertian(b.image(texels(7)))
    xf = b.transform(offset=(0, 1, -3), rotate_axis="y", angle_deg=30.0)
    b.rect("xy", -1, 0, 1, 2, 0.0, img, xform=xf)
    b.sphere((0, 1, 3), 0.9, img)
    b.rect("xy", -1, 0, 1, 2, 4.0, img, flip=True)
    # a flipped image sphere: its UV comes from the pre-flip normal
    flipped = b.lambertian(b.image(texels(9)))
    b.rect("yz", 0, -1, 2, 1, -5.0, flipped)
    b.sphere((2, 1, -3), 0.7, flipped)
    b._pflip[-1] = -1.0
    # textured media: checker, noise and image (at u = v = 0) albedo
    b.medium_sphere((0, 3, 0), 1.0, 0.4,
                    b.checker(b.solid(1, 0, 0), b.solid(0, 0, 1)))
    b.medium_box((-5, 0, -5), (-3, 1, -3), 0.3, b.noise(1.5))
    b.medium_sphere((3, 3, 3), 0.8, 0.3, b.image(texels(11)))
    return b.build(device)


def big_spheres(n: int = 30000, seed: int = 7, device="cpu") -> SceneTables:
    """The scale scene: random_spheres' recipe (reference
    tests/test.rs:89-163) grown to n small spheres on a ceil(√n)-sided
    grid, static (no motion), lambertian or metal, on the ground sphere with
    the three hero spheres: n + 4 prims, the regime the reference's BVH
    exists for (src/bvh.rs:9-94). The JAX package's `big_spheres`, draw for
    draw."""
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    half = side // 2
    count = 0
    for a in range(-half, side - half):
        for c in range(-half, side - half):
            if count >= n:
                break
            center = (a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random())
            if rng.random() < 0.8:
                albedo = b.solid(rng.random() * rng.random(),
                                 rng.random() * rng.random(),
                                 rng.random() * rng.random())
                b.sphere(center, 0.2, b.lambertian(albedo))
            else:
                albedo = b.solid(0.5 * (1 + rng.random()),
                                 0.5 * (1 + rng.random()),
                                 0.5 * (1 + rng.random()))
                b.sphere(center, 0.2, b.metal(albedo, 0.5 * rng.random()))
            count += 1
        if count >= n:
            break
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.0))
    return b.build(device)


def big_spheres_camera(n: int, nx: int, ny: int, device="cpu"):
    """The camera that sees `big_spheres(n)`'s whole field (random_spheres'
    viewpoint covers a ~20-unit patch of it)."""
    from ..ops.camera import make_camera
    side = int(np.ceil(np.sqrt(n)))
    d = max(13.0, 0.9 * side)
    return make_camera((d, 0.35 * d, d), (0, 0, 0), (0, 1, 0), 30.0, nx / ny,
                       0.0, d * 1.4, 0.0, 1.0, device=device)


def lattice_camera(nx: int, ny: int, device="cpu"):
    """The camera tools/tpu_parity.py renders `lattice_scene` with: from
    (0, 4, 14) at (0, 1.5, 0), 45° vertical field, no lens blur."""
    from ..ops.camera import make_camera
    return make_camera((0, 4, 14), (0, 1.5, 0), (0, 1, 0), 45.0, nx / ny, 0.0,
                       10.0, 0.0, 1.0, device=device)


def cubes_scene(n: int = 20, builder=SceneBuilder) -> SceneTables:
    """A test scene, not a reference preset: n cubes of three materials
    under the sky on a 5-wide grid of pitch 1, heights seeded. 20 fill a
    5×4 grid, so their boxes take the strip pass; fewer leave cells empty
    and take the generic box loop. `builder` is the scene builder class
    (this package's, or another with its interface)."""
    r = np.random.default_rng(1)
    b = builder(background=BG_SKY)
    mats = [b.lambertian(b.solid(0.7, 0.3, 0.3)),
            b.metal(b.solid(0.8, 0.8, 0.8), 0.1),
            b.lambertian(b.solid(0.3, 0.7, 0.3))]
    for k in range(n):
        x, z = k % 5 - 2.5, k // 5 - 2.0
        b.cube((x, 0.0, z), (x + 1.0, float(r.uniform(0.2, 1.5)), z + 1.0),
               mats[k % 3])
    return b.build()


def cubes_camera(nx: int, ny: int, device="cpu"):
    """`cubes_scene`'s view: from (3, 4, 6) at (0, 0.5, 0), 40° vertical
    field, no lens blur."""
    from ..ops.camera import make_camera
    return make_camera((3, 4, 6), (0, 0.5, 0), (0, 1, 0), 40.0, nx / ny, 0.0,
                       6.0, 0.0, 1.0, device=device)


@dataclass
class ScenePreset:
    build: object                 # (device=...) -> SceneTables
    nx: int
    ny: int
    spp: int
    look_from: tuple
    look_at: tuple = (0.0, 0.0, 0.0)
    view_up: tuple = (0.0, 1.0, 0.0)
    vfov: float = 20.0
    focus_dist: float = 10.0
    aperture: float = 0.1
    time0: float = 0.0
    time1: float = 1.0

    def camera(self, device="cpu"):
        from ..ops.camera import make_camera
        return make_camera(self.look_from, self.look_at, self.view_up,
                           self.vfov, self.nx / self.ny, self.aperture,
                           self.focus_dist, self.time0, self.time1,
                           device=device)


# Reference configs (tests/test.rs:525-838); BASELINE.json upgrades noted.
PRESETS = {
    "random_spheres": ScenePreset(random_spheres, 1280, 720, 100,
                                  look_from=(13, 2, 3)),
    "two_spheres": ScenePreset(two_spheres, 1280, 720, 10,
                               look_from=(13, 2, 3)),
    "two_perlin_spheres": ScenePreset(two_perlin_spheres, 1280, 720, 10,
                                      look_from=(13, 2, 3)),
    "earth": ScenePreset(earth, 1280, 720, 10, look_from=(13, 2, 3)),
    "simple_light": ScenePreset(simple_light, 1280, 720, 100,
                                look_from=(13, 3, 3), vfov=50.0),
    "cornell_box": ScenePreset(cornell_box, 800, 800, 100,
                               look_from=(278, 278, -800),
                               look_at=(278, 278, 0), vfov=40.0),
    "cornell_smoke": ScenePreset(cornell_smoke, 800, 800, 100,
                                 look_from=(278, 278, -800),
                                 look_at=(278, 278, 0), vfov=40.0),
    "final_scene": ScenePreset(final_scene, 800, 800, 100,
                               look_from=(478, 278, -600),
                               look_at=(278, 278, 0), vfov=40.0),
    # BASELINE.json spec configs (see BASELINE.md "Targets")
    "two_spheres_baseline": ScenePreset(two_spheres, 400, 225, 100,
                                        look_from=(13, 2, 3)),
    "cornell_box_baseline": ScenePreset(cornell_box, 800, 800, 500,
                                        look_from=(278, 278, -800),
                                        look_at=(278, 278, 0), vfov=40.0),
}
