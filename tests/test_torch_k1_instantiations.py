"""K1's instantiations as the host names them (`tracer.K1_INSTANTIATIONS`,
`instantiation_name`: the code a launch reports, the names ptxas and the
occupancy query give), and the reader of what the kernel compiled to
(`ops/sass.py`, `tracer.k1_sass_loads`), on the CPU: the kernel's table of
instantiations in csrc/tracer.cu, and a made-up SASS listing.
"""

import os
import re

import pytest

from raytracing_rust_tpu_torch.ops import sass, tracer
import torch_threads  # noqa: F401  (one torch thread a process)

_CU = os.path.join(os.path.dirname(tracer.__file__), "..", "csrc",
                   "tracer.cu")


@pytest.mark.parametrize("code, name", [
    (0, "trace_k1<0,0,0,0,0>"),    # cornell_box, with or without roulette
    (32, "trace_k1<0,0,0,0,1>"),   # cornell_smoke: K1a's code with media
    (1, "trace_k1<1,0,0,0,0>"),    # two_spheres: K1B without media
    (33, "trace_k1<1,0,0,0,1>"),   # the lattice: K1B with media
    (7, "trace_k1<1,1,1,0,0>"),    # random_spheres' pixel table
    (39, "trace_k1<1,1,1,0,1>"),   # a pixel table with media, no box grid
    (51, "trace_k1<1,1,0,2,1>"),   # a cost probe, leaves in device memory
    (103, "trace_k1<1,2,1,0,1>"),  # final_scene's pixel table: a box grid
    (119, "trace_k1<1,2,1,2,1>")])  # final_scene's cost probe
def test_instantiation_names_of_known_launches(code, name):
    """The code that csrc/tracer.cu `pick` gives a known launch
    (`Pick::code`: K1B | (DYN > 0) << 1 | LEAF_SMEM << 2 | STATS << 3 |
    MED << 5 | (DYN == 2) << 6) names its instantiation as ptxas and the
    occupancy query name it."""
    assert tracer.instantiation_name(code) == name


def test_instantiations_are_the_kernels_table():
    """K1_INSTANTIATIONS lists each instantiation csrc/tracer.cu makes
    once: eleven production ones, five of them with MED (two of those a box
    grid's, DYN 2, with and without the leaves in shared memory) beside the
    six of four flags, and six for K1f's counters (two of them a box
    grid's), which all have MED; a box grid's all have K1B and MED."""
    with open(_CU) as f:
        cu = f.read()
    made = re.findall(r"inst<(true|false), (\d), (true|false), "
                      r"(\d), (true|false)>\(\)", cu)
    as_flags = [tuple(int(x == "true") if x in ("true", "false") else int(x)
                      for x in m) for m in made]
    assert len(set(as_flags)) == len(as_flags) == 19
    assert set(as_flags) == set(tracer.K1_INSTANTIATIONS)
    production = [f for f in as_flags if f[3] == 0]
    assert len(production) == 11
    assert sum(f[4] for f in production) == 6  # one is a table's fallback
    assert all(f[4] == 1 for f in as_flags if f[3] > 0)
    grid = [f for f in as_flags if f[1] == 2]
    assert len(grid) == 6 and all(f[0] == f[4] == 1 for f in grid)
    for f in as_flags:
        code = (f[0] | (f[1] > 0) << 1 | f[2] << 2 | f[3] << 3 | f[4] << 5
                | (f[1] == 2) << 6)
        assert tracer.instantiation_name(code) == (
            f"trace_k1<{','.join(map(str, f))}>")
    for bad in (-1, 64, 128):
        with pytest.raises(ValueError):
            tracer.instantiation_name(bad)


def _preset_ops(name):
    from raytracing_rust_tpu_torch.models import builders as tb
    if name == "lattice":
        scene, cam = tb.lattice_scene(), tb.lattice_camera(64, 36)
    else:
        p = tb.PRESETS[name]
        scene, cam = p.build(), p.camera()
    return tracer.trace_operands(tracer.build_scene_record(scene),
                                 tracer.build_camera_record(cam), "cpu")


# (K1B, DYN, LEAF_SMEM, STATS, MED) of each preset's launch: media in
# instantiations of their own, cornell_smoke's (media alone, no table) on
# K1a's code
_ROUTES = {"cornell_box": (0, 0, 0, 0, 0), "cornell_smoke": (0, 0, 0, 0, 1),
           "two_spheres": (1, 0, 0, 0, 0), "two_perlin_spheres": (1, 0, 0, 0, 0),
           "simple_light": (1, 0, 0, 0, 0), "earth": (1, 0, 0, 0, 0),
           "random_spheres": (1, 1, 1, 0, 0), "final_scene": (1, 2, 1, 0, 1),
           "lattice": (1, 0, 0, 0, 1)}


@pytest.mark.parametrize("name", sorted(_ROUTES))
def test_pick_sends_each_scene_to_its_instantiation(name):
    """`tracer.k1_instantiation`, the host's counterpart of csrc/tracer.cu
    `pick`, sends each of the eight presets and the lattice to the
    instantiation the design names: a scene with a medium to one with MED,
    a scene without to one without; the same scene with roulette to the
    same one; on a pixel table a DYN one (with MED where its leaves are
    not in shared memory, none or too many); its stats and probe launches
    one with every section; a box grid (final_scene) one of its own."""
    import dataclasses
    ops = _preset_ops(name)
    want = _ROUTES[name]
    got = tracer.k1_instantiation(ops)
    assert got == want
    assert got in tracer.K1_INSTANTIATIONS
    assert bool(got[4]) == bool(ops.feats & tracer.FEAT_MEDIA)
    if not ops.feats & tracer.FEAT_DENSE_WALK:
        rr = dataclasses.replace(ops, feats=ops.feats | tracer.FEAT_RR,
                                 rr_depth=6)
        assert tracer.k1_instantiation(rr) == want
    table = tracer.k1_instantiation(ops, table=True)
    assert table in tracer.K1_INSTANTIATIONS
    assert table[1] == (2 if ops.grid else 1)
    assert table[4] == int(bool(want[4]) or (table[0] and not table[2]))
    assert (got[1] == 2) == bool(ops.grid)
    for stats in (1, 2):
        assert tracer.k1_instantiation(ops, stats=stats) == (
            1, 2 if ops.grid else 1, want[2], stats, 1)


def test_pick_keeps_a_table_in_device_memory_on_every_section():
    """A K1B table whose leaves do not fit in shared memory runs the one
    K1B + DYN instantiation without them there, which has MED, with or
    without a medium: 20,000 small spheres under the sky (2,048 leaves)."""
    import numpy as np
    from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
    from raytracing_rust_tpu_torch.ops import camera
    b = SceneBuilder(background=BG_SKY)
    r = np.random.default_rng(5)
    for _ in range(20000):
        b.sphere(r.uniform((-6.0, 0.05, -6.0), (6.0, 3.0, 6.0)), 0.05,
                 b.lambertian(b.solid(0.8, 0.3, 0.3)))
    cam = camera.make_camera((0, 2, 8), (0, 1, 0), (0, 1, 0), 35.0, 1.5,
                             0.0, 10.0, 0.0, 1.0)
    ops = tracer.trace_operands(tracer.build_scene_record(b.build()),
                                tracer.build_camera_record(cam), "cpu")
    assert ops.leaves.shape[0] * tracer.CLUSW * 4 > tracer.SMEM_BUDGET
    assert not ops.feats & tracer.FEAT_MEDIA
    assert tracer.k1_instantiation(ops) == (1, 1, 0, 0, 1)


def wide_grid(nx=64, ny=64, ni=150, nj=32):
    """ni × nj ground boxes of pitch 1, heights seeded, under the sky, and
    a view over them at nx × ny: a box grid whose leaves and supers (600
    and 75 at the default size) fit in K1's shared memory, and whose
    (y_hi, z_lo) table (38,400 B) does not fit beside them."""
    import numpy as np
    from raytracing_rust_tpu_torch.models.scene import BG_SKY, SceneBuilder
    from raytracing_rust_tpu_torch.ops import camera
    b = SceneBuilder(background=BG_SKY)
    m = b.lambertian(b.solid(0.5, 0.5, 0.5))
    r = np.random.default_rng(2)
    for i in range(ni):
        for j in range(nj):
            b.cube((float(i), 0.0, float(j)),
                   (i + 1.0, float(r.uniform(0.2, 1.5)), j + 1.0), m)
    return b.build(), camera.make_camera(
        (ni / 2, 12, -10), (ni / 2, 0, nj / 2), (0, 1, 0), 60.0, nx / ny,
        0.0, 10.0, 0.0, 1.0)


def test_pick_counts_a_grid_table_in_shared_memory():
    """The grid's (y_hi, z_lo) table, 8 bytes a box, sits in shared memory
    with the leaves or not at all: 150 × 32 boxes, whose leaves and supers
    alone would fit, run the box grid's instantiation without the leaves
    in shared memory; a 20 × 20 grid runs it with them."""
    def ops(**kw):
        scene, cam = wide_grid(**kw)
        return tracer.trace_operands(tracer.build_scene_record(scene),
                                     tracer.build_camera_record(cam), "cpu")
    wide = ops()
    assert wide.grid[:2] == (150, 32)
    leaves = 4 * tracer.CLUSW * (wide.bleaves.shape[0]
                                 + wide.bsups.shape[0])
    assert leaves + 2048 < tracer.SMEM_BUDGET < leaves + 8 * 150 * 32
    assert tracer.k1_instantiation(wide) == (1, 2, 0, 0, 1)
    assert tracer.k1_instantiation(wide, stats=2) == (1, 2, 0, 2, 1)
    small = ops(ni=20, nj=20)
    assert small.grid[:2] == (20, 20)
    assert tracer.k1_instantiation(small) == (1, 2, 1, 0, 1)


def test_launch_counts_the_instantiation_the_kernel_reports():
    """`_launch` counts a launch under the instantiation whose code the
    library writes through its `inst` slot (the argument before the
    stream), and nothing when the launch fails: cornell_box with roulette
    alone reported as the static instantiation, counted as K1g's launch and
    not as K1a's."""
    import ctypes

    import torch
    from raytracing_rust_tpu_torch.models import builders as tb

    class Lib:
        def __init__(self, err, code):
            self.err, self.code = err, code

        def rt_trace_k1(self, *args):
            if self.err == 0:
                ctypes.c_int.from_address(args[-2]).value = self.code
            return self.err

    p = tb.PRESETS["cornell_box"]
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(p.camera()),
                                "cpu", rr_depth=6)
    sums = torch.zeros((3, 4), dtype=torch.float64)
    kw = dict(nx=2, ny=2, seed=0, sample0=0, n_samples=1, max_depth=8,
              stream=None)
    before = tracer.K1_INSTANTIATION_LAUNCHES.copy()
    counts = (tracer.K1G_LAUNCHES, tracer.KERNEL_LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tracer._launch(Lib(700, 0), ops, sums, **kw)
    assert tracer.K1_INSTANTIATION_LAUNCHES == before
    tracer._launch(Lib(0, 0), ops, sums, **kw)
    tracer._launch(Lib(0, 0), ops, sums, **kw)
    assert tracer.K1_INSTANTIATION_LAUNCHES - before == {
        "trace_k1<0,0,0,0,0>": 2}
    # roulette's launches count as K1g's, never as K1a's
    assert (tracer.K1G_LAUNCHES, tracer.KERNEL_LAUNCHES) == (
        counts[0] + 2, counts[1])


_LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_18trace_k1ILb0ELb0ELb0ELi0ELb0EEEvPKfiPKii
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0020*/                   STS [R3], R2 ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/                   ULDC UR6, c[0x0][0x220] ;
        /*0050*/                   LDC R5, c[0x0][R4+0x260] ;
        /*0060*/                   FADD R6, R5, -c[0x0][0x4a54] ;
        /*0070*/                   MUFU.RSQ R7, R6 ;
.L_x_7:
        /*0080*/                   LDS R8, [R9+0x50] ;
        /*0090*/               @P1 BRA `(.L_x_9) ;
        /*00a0*/                   BRA 0x50 ;
.L_x_9:
        /*00b0*/                   IMAD.HI.U32 R2, R3, -0x2daee0ad, RZ ;
        /*00c0*/                   MUFU.RSQ R7, R6 ;
        /*00d0*/                   BRA `(.L_x_9) ;
        /*00e0*/                   MUFU.SIN R1, R1 ;
        /*00f0*/                   MUFU.RSQ R7, R6 ;
        /*0100*/                   BRA 0xe0 ;
		Function : _Z8other_kv
        /*0000*/                   LDS R1, [R2] ;
        /*0010*/                   BRA 0x0 ;
"""


def test_sass_reader_counts_the_row_loops_loads():
    """On a made-up listing: the kernels split apart, labels resolved to
    addresses, the innermost loops found, and of them only the one with a
    square root and no Philox draw, sine or device load counted as a row
    loop, with its loads by where they read."""
    funcs = sass.functions(_LISTING)
    assert set(funcs) == {
        "_ZN12_GLOBAL__N_18trace_k1ILb0ELb0ELb0ELi0ELb0EEEvPKfiPKii",
        "_Z8other_kv"}
    k1 = next(v for k, v in funcs.items() if "trace_k1" in k)
    assert k1[9] == (0x90, "@P1 BRA 0xb0")
    assert sass.opcode(k1[9][1]) == "BRA"
    assert sass.inner_loops(k1) == [(0x10, 0x30), (0x50, 0xa0),
                                    (0xb0, 0xd0), (0xe0, 0x100)]
    assert sass.row_loops(k1) == [dict(
        first="0x50", last="0xa0", instructions=6, lds=1, ldc=1, uldc=0,
        const_operands=1, ldg=0)]
    whole = sass.load_counts([s for _, s in k1])
    assert (whole["lds"], whole["ldc"], whole["uldc"], whole["ldg"]) == (
        1, 2, 1, 1)
    loads = tracer.k1_sass_loads(text=_LISTING)
    assert set(loads) == {"trace_k1<0,0,0,0,0>"}
    assert loads["trace_k1<0,0,0,0,0>"]["row_loops"] == sass.row_loops(k1)
