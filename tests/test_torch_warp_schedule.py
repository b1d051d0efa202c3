"""K1's warp schedules of the dense-medium walk and the marble's turbulence
against the JAX package and the port's plain version, on the CPU.

The kernel itself runs only on a CUDA card (tests/test_torch_kernel.py and
chip_smoke.py hold it against `trace_plain` there). Here:
- `warp_turb`, csrc/tracer.cu's warp-cooperative turbulence, in plain
  torch: the requesting lanes' 56 (octave, corner) terms each, handed out
  over a block of the warp's lanes per owner in rounds and re-added in
  owner order, equal `ops/perlin.turb3` bit for bit on seeded warps of
  every requester count, and agree with the JAX package's `perlin.turb`
  and the TPU kernel's `_turb3`;
- `trace_plain`'s dense-medium walk taken one bounce a step
  (`walk_one_bounce_a_step`), as the kernel's flat loop takes one an
  iteration, gives the nested walk's sums, counts and stats bit for bit on
  final_scene;
- the walk's one known departure from the event path, a ray that
  scatters just outside the sealing sphere.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_rust_tpu.ops import pallas_tracer as pt
from raytracing_rust_tpu.ops import perlin as jperlin
from raytracing_rust_tpu_torch.models import builders as tb
from raytracing_rust_tpu_torch.ops import camera as tcam
from raytracing_rust_tpu_torch.ops import perlin, tracer
from test_torch_final import _final_camera
import torch_threads  # noqa: F401  (one torch thread a process)

WARP = 32
OCTAVES, CORNERS = 7, 8


def warp_turb(need, px, py, pz, seed, shuffle=None):
    """csrc/tracer.cu `warp_turb` on warps of 32 lanes (need bool[W, 32],
    points f32[W, 32]) → turb f32[W, 32], 0 where need is unset. Each of a
    warp's k requesting lanes owns a block of m lanes, m the largest power
    of two with k·m ≤ 32; lane j of the block of rank i computes in round r
    its owner's term t = r·m + j (octave t // 8, corner t % 8) at the
    owner's point times 2^octave, for t < 56. An octave's eight corners are
    added in corner order from 0, an owner's octaves times 0.5^o in octave
    order from 0. shuffle (a torch.Generator): compute the terms in a
    seeded random order of lanes and rounds, which must not change a bit."""
    out = torch.zeros_like(px)
    for w in range(need.shape[0]):
        owners = torch.nonzero(need[w]).squeeze(1)
        k = owners.numel()
        if k == 0:
            continue
        m = WARP >> (k - 1).bit_length()
        assert k * m <= WARP < 2 * k * m or m == WARP
        rounds = -(-OCTAVES * CORNERS // m)
        lane = torch.arange(WARP).repeat(rounds)
        rnd = torch.arange(rounds).repeat_interleave(WARP)
        rank, t = lane // m, rnd * m + lane % m
        keep = (rank < k) & (t < OCTAVES * CORNERS)
        rank, t = rank[keep], t[keep]
        order = (torch.randperm(t.numel(), generator=shuffle)
                 if shuffle is not None else torch.arange(t.numel()))
        rank, t = rank[order], t[order]
        src = owners[rank]
        scale = (2 ** (t // CORNERS)).to(torch.float32)
        c = perlin.cell(px[w, src] * scale, py[w, src] * scale,
                        pz[w, src] * scale)
        terms = torch.full((k, OCTAVES * CORNERS), float("nan"))
        for corner in range(CORNERS):
            at = torch.nonzero(t % CORNERS == corner).squeeze(1)
            terms[rank[at], t[at]] = perlin.corner_term(
                tuple(tuple(x[at] for x in part) for part in c), corner, seed)
        assert not terms.isnan().any()   # every term computed once
        by_corner = terms.view(k, OCTAVES, CORNERS)
        octave_sum = torch.zeros(k, OCTAVES)
        for corner in range(CORNERS):
            octave_sum = octave_sum + by_corner[:, :, corner]
        acc = torch.zeros(k)
        for o in range(OCTAVES):
            acc = acc + 0.5 ** o * octave_sum[:, o]
        out[w, owners] = torch.abs(acc)
    return out


def _points(kind, r, n):
    if kind == "uniform":
        return r.uniform(-40.0, 40.0, (n, 3))
    if kind == "lattice":
        # exact lattice points, and points with one integer coordinate
        p = r.integers(-300, 301, (n, 3)).astype(np.float64)
        half = n // 2
        p[half:, 1] += r.uniform(0.0, 1.0, n - half)
        return p
    # final_scene's coordinates: |p| up to 600, ×64 at octave 6
    return r.uniform(-600.0, 600.0, (n, 3))


@pytest.mark.parametrize("kind,seed", [("uniform", 0), ("lattice", 7),
                                       ("final_scene", 0),
                                       ("final_scene", -3)])
def test_warp_turb_equals_turb3_and_matches_jax(kind, seed):
    """On 40 seeded warps with 1 to 32 requesting lanes at random
    positions: bit-equal to turb3 at the requesting lanes, in the kernel's
    term order and in a shuffled one, 0 elsewhere; within 2e-6 of JAX
    `perlin.turb` and `pallas_tracer._turb3`."""
    r = np.random.default_rng(abs(seed) + 11)
    n_warps = 40
    pts = _points(kind, r, n_warps * WARP).astype(np.float32)
    counts = np.concatenate([[1, 2, 31, 32], r.integers(1, 33, n_warps - 4)])
    need = torch.zeros(n_warps, WARP, dtype=torch.bool)
    for w, k in enumerate(counts):
        need[w, torch.from_numpy(r.permutation(WARP)[:k])] = True
    px, py, pz = (torch.from_numpy(pts[:, a].copy()).view(n_warps, WARP)
                  for a in range(3))
    got = warp_turb(need, px, py, pz, seed)
    shuffled = warp_turb(need, px, py, pz, seed,
                         torch.Generator().manual_seed(abs(seed) + 5))
    want = perlin.turb3(px, py, pz, seed)
    assert torch.equal(got[need], want[need])
    assert torch.equal(shuffled, got)
    assert not got[~need].any()
    assert float(got[need].std()) > 0.05
    flat = need.reshape(-1).numpy()
    ref = np.asarray(jperlin.turb(jnp.asarray(pts), seed=seed))[flat]
    np.testing.assert_allclose(got.reshape(-1).numpy()[flat], ref, rtol=0,
                               atol=2e-6)
    cols = [jnp.asarray(pts[:, a]) for a in range(3)]
    np.testing.assert_allclose(got.reshape(-1).numpy()[flat],
                               np.asarray(pt._turb3(*cols, seed))[flat],
                               rtol=0, atol=2e-6)


class _AskedDense:
    """`tracer._walk`'s dense_of for one call: records the media it is
    asked about, which are the media of the call's scatters, in order."""

    def __init__(self, dense_of):
        self.dense_of, self.asked = dense_of, None

    def __getitem__(self, m):
        self.asked = m
        return self.dense_of[m]


def walk_one_bounce_a_step(walk, order: torch.Generator):
    """`tracer._walk` (passed as walk) in the kernel's flat-loop schedule →
    a function of `_walk`'s signature. Each step, a seeded random half of
    the walking lanes take one walk bounce, the rest wait; a lane's bounce
    is `walk` on its group of lanes at one bounce b with the depth cap
    b + 1, so that it stops after one bounce. A lane walks on while it
    scattered in a dense medium below the real cap, as in `walk`."""
    def flat(med_box, dense_of, med_table, med_dev, interior, int_kind, o,
             d, thr, bnc, skip, time, moving, idx, draws, max_depth, counts,
             steps=None):
        walking = idx
        while walking.numel():
            go = torch.rand(walking.numel(), generator=order) < 0.5
            on, stepping = [walking[~go]], walking[go]
            at = bnc[stepping]
            for b in torch.unique(at).tolist():
                lanes = stepping[at == b]
                asked = _AskedDense(dense_of)
                walk(med_box, asked, med_table, med_dev, interior, int_kind,
                     o, d, thr, bnc, skip, time, moving, lanes, draws, b + 1,
                     counts, steps)
                scattered = lanes[bnc[lanes] == b + 1]
                if b + 1 < max_depth:
                    on.append(scattered[dense_of[asked.asked]])
            walking = torch.cat(on)
    return flat


def test_flat_walk_equals_nested_walk_on_final_scene(monkeypatch):
    """trace_plain with its walk taken one bounce a step, the lanes'
    bounces interleaved in a seeded order (the kernel's flat loop), against
    the nested walk on final_scene at 24×24, 2 spp, depth 50: the sums,
    every count and the stats rows (segments with walk bounces, member
    tests, warp steps) are equal bit for bit."""
    nx = ny = 24
    ops = tracer.trace_operands(
        tracer.build_scene_record(tb.final_scene()),
        tracer.build_camera_record(tcam.make_camera(*_final_camera(nx, ny))),
        "cpu")
    assert ops.feats & tracer.FEAT_DENSE_WALK
    out = {}
    for flat in (False, True):
        if flat:
            monkeypatch.setattr(tracer, "_walk", walk_one_bounce_a_step(
                tracer._walk, torch.Generator().manual_seed(3)))
        sums = torch.zeros((3, nx * ny), dtype=torch.float64)
        counts, stats = {}, tracer.new_stats(nx, ny, "cpu")
        tracer.trace_plain(ops, sums, nx=nx, ny=ny, seed=0, sample0=0,
                           n_samples=2, max_depth=50, counts=counts,
                           stats=stats)
        out[flat] = (sums, counts, stats)
    assert out[False][1]["walk"] > 0
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    assert torch.equal(out[True][2], out[False][2])


def test_walk_differs_from_the_event_path_past_the_sealing_sphere():
    """The walk is not the event path's image on every ray. final_scene at
    800×800, seed 0, sample 1 of pixel 295424: at bounce 32 the path
    leaves the sealing sphere at its surface and scatters in the dense
    medium 0.004 along the way out (the medium's boundary and the sphere
    meet within rounding). Its isotropic direction points out of the
    sphere, so the walk's bounce 33 finds no interior row and races the
    media with no surface cap, through the light that the event path's
    segment hits. With the depth cap at 33 that bounce is not taken and
    the two agree; at 34 and above the walk's sample is black and the
    event path's the light's."""
    p = tb.PRESETS["final_scene"]
    nx, ny = p.nx, p.ny
    ops = tracer.trace_operands(tracer.build_scene_record(p.build()),
                                tracer.build_camera_record(p.camera()),
                                "cpu")
    event = dataclasses.replace(
        ops, feats=ops.feats & ~tracer.FEAT_DENSE_WALK)
    pixel = 295424
    got = {}
    for depth in (33, 34, 50):
        for name, o in (("walk", ops), ("event", event)):
            sums = torch.zeros((3, nx * ny), dtype=torch.float64)
            tracer.trace_plain(o, sums, nx=nx, ny=ny, seed=0, sample0=1,
                               n_samples=1, max_depth=depth,
                               pix=torch.tensor([pixel], dtype=torch.int32))
            got[name, depth] = sums[:, pixel]
    assert torch.equal(got["walk", 33], got["event", 33])
    assert float(got["event", 33][2]) > 0.3
    for depth in (34, 50):
        assert not got["walk", depth].any()
        assert torch.equal(got["event", depth], got["event", 33])
