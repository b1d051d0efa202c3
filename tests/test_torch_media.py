"""K1d's media race in the plain version (`_media_events`), on the CPU.

The kernel's race (csrc/tracer.cu `media_race`) draws a group of four
media's flights at the group's first medium whose interval is open, and
only then: the draws are counter-keyed (pixel, sample, bounce, group), so
the values are the ones the plain version computes, which draws each group
once for every lane and selects the first strict minimum. Here, on seeded
rays and on grazing, face-parallel and corner rays through box and sphere
media, rotated and not, in two groups of draws: the plain race asks for
each group's draw once, in group order, whether or not an interval is
open; its open count (`med_open`, the (segment, medium) pairs a
per-segment gate could not skip) and its winner equal a numpy recount of
the same f32 formulas. The kernel is held to the plain version bit for bit
on the card (`test_kernel_media_race_is_bit_exact`, chip_smoke.py phases
13 and 40).
"""

import numpy as np
import torch

from raytracing_rust_tpu_torch.models.scene import BG_BLACK, SceneBuilder
from raytracing_rust_tpu_torch.ops import rng, tracer
import torch_threads  # noqa: F401  (one torch thread a process)


def _media():
    """Five media: a rotated box, an axis-aligned box, a rotated sphere,
    a sphere and a box about a far offset → (med_box bits, table rows)."""
    b = SceneBuilder(background=BG_BLACK)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    white = b.solid(0.9, 0.9, 0.9)
    b.medium_box((-0.5, 0, -0.5), (0.5, 1.5, 0.5), 0.5, white,
                 xform=b.transform(offset=(-1.5, 0, 0), rotate_axis="y",
                                   angle_deg=30.0))
    b.medium_box((-0.4, 0, 1.2), (0.4, 0.6, 2.0), 1.0, white)
    b.medium_sphere((0, 0.8, 0), 0.8, 0.3, white,
                    xform=b.transform(offset=(1.5, 0, 0.5), rotate_axis="x",
                                      angle_deg=-20.0))
    b.medium_sphere((0.3, 2.2, -1.0), 0.3, 2.0, white)
    b.medium_box((10.0, 0, 10.0), (11.0, 1.0, 11.0), 0.1, white,
                 xform=b.transform(offset=(-10.5, 0.2, -10.5),
                                   rotate_axis="z", angle_deg=45.0))
    srec = tracer.build_scene_record(b.build())
    box = sum(1 << i for i, k in enumerate(srec.med_kinds) if k == "mbox")
    return box, srec.med_rec


def _rays(med):
    """Seeded rays from around the media, and rays that graze, run
    parallel to, or aim at the corners and centres of each medium's
    object-space bounds (mapped to world space)."""
    r = np.random.default_rng(17)
    o = [r.uniform(-4, 4, (600, 3)), np.tile([[0.0, 3.0, 6.0]], (80, 1))]
    d = [r.normal(size=(600, 3)), r.normal(size=(80, 3)) * 0.3
         + [0.0, -0.3, -1.0]]
    for row in med:
        rot = row[tracer.M_ROT:tracer.M_ROT + 9].reshape(3, 3).astype(
            np.float64)
        off = row[tracer.M_OFF:tracer.M_OFF + 3].astype(np.float64)
        lo = row[tracer.M_DATA:tracer.M_DATA + 3].astype(np.float64)
        hi = row[tracer.M_DATA + 3:tracer.M_DATA + 6].astype(np.float64)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        world = corners @ rot + off          # R₋ᵀ maps object → world
        for c in world:
            o.append(c[None] + [[0.0, 0.0, 5.0], [5.0, 0.0, 0.0]])
            d.append(c[None] - o[-1])
        # along each object axis from a face's plane: face-parallel rays
        axes = rot                           # rows: object axes in world
        for k in range(3):
            o.append(world[:1] - 3.0 * axes[k][None])
            d.append(axes[k][None].copy())
            o.append(world[:1] + 1e-3 * axes[(k + 1) % 3][None]
                     - 3.0 * axes[k][None])
            d.append(axes[k][None].copy())
    o = np.concatenate(o).astype(np.float32)
    d = np.concatenate(d).astype(np.float32)
    return o, d


def _recount(med_box, med, o, d, t_cap):
    """The open intervals of each (ray, medium), the race's formulas in
    numpy f32, operation for operation."""
    f = np.float32
    a_dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv_a = f(1.0) / a_dd
    out = []
    for i, m in enumerate(med):
        w = [o[:, k] - m[tracer.M_OFF + k] for k in range(3)]
        rr = m[tracer.M_ROT:tracer.M_ROT + 9]
        o0 = [rr[3 * k] * w[0] + rr[3 * k + 1] * w[1] + rr[3 * k + 2] * w[2]
              for k in range(3)]
        d0 = [rr[3 * k] * d[:, 0] + rr[3 * k + 1] * d[:, 1]
              + rr[3 * k + 2] * d[:, 2] for k in range(3)]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if med_box >> i & 1:
                sd = [np.where(np.abs(c) < f(1e-30), f(1e-30), c) for c in d0]
                lo = [(m[tracer.M_DATA + k] - o0[k]) / sd[k] for k in range(3)]
                hi = [(m[tracer.M_DATA + 3 + k] - o0[k]) / sd[k]
                      for k in range(3)]
                enter = np.maximum(np.maximum(np.minimum(lo[0], hi[0]),
                                              np.minimum(lo[1], hi[1])),
                                   np.minimum(lo[2], hi[2]))
                exit_ = np.minimum(np.minimum(np.maximum(lo[0], hi[0]),
                                              np.maximum(lo[1], hi[1])),
                                   np.maximum(lo[2], hi[2]))
                ok = enter < exit_
            else:
                oc = [o0[k] - m[tracer.M_DATA + k] for k in range(3)]
                bq = oc[0] * d0[0] + oc[1] * d0[1] + oc[2] * d0[2]
                cq = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
                      - m[tracer.M_DATA + 3])
                disc = bq * bq - a_dd * cq
                ok = disc > 0
                sq = np.sqrt(np.where(ok, disc, f(1.0)))
                enter = (-bq - sq) * inv_a
                exit_ = (-bq + sq) * inv_a
        enter = np.maximum(enter, f(tracer.T_MIN))
        exit_ = np.minimum(exit_, t_cap)
        out.append(ok & (enter < exit_))
    return np.stack(out, 1)


def test_media_race_draws_each_group_once_and_counts_open_intervals():
    med_box, med = _media()
    assert med.shape[0] == 5 and med_box == 0b10011
    o, d = _rays(med)
    n = o.shape[0]
    t_cap = np.where(np.arange(n) % 3 == 0, np.float32(tracer.BIG),
                     np.float32(4.0)).astype(np.float32)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    a_dd = dt[:, 0] * dt[:, 0] + dt[:, 1] * dt[:, 1] + dt[:, 2] * dt[:, 2]
    asked = []
    pix = torch.arange(n, dtype=torch.int64)

    def draw(stream):
        asked.append(stream)
        return rng.draws(7, pix, torch.zeros_like(pix), 3, stream)
    counts = {"med_open": 0}
    t_med, m_win = tracer._media_events(
        med_box, med.tolist(), list(ot.unbind(1)), list(dt.unbind(1)), a_dd,
        1.0 / a_dd, torch.from_numpy(t_cap), draw, counts)
    assert asked == [rng.STREAM_MEDIUM, rng.STREAM_MEDIUM + 1]
    open_ = _recount(med_box, med, o, d, t_cap)
    assert counts["med_open"] == int(open_.sum())
    assert 0 < counts["med_open"] < open_.size
    hit = m_win.numpy() >= 0
    assert hit.any() and (~hit).any()
    # a winner's interval is open; a ray with none open has no event
    assert open_[hit, m_win.numpy()[hit]].all()
    assert (t_med.numpy()[~open_.any(1)] == np.float32(tracer.BIG)).all()
    # no ray left: no interval, the draws still come once a group
    asked.clear()
    empty = torch.zeros(0)
    tracer._media_events(med_box, med.tolist(), [empty] * 3,
                         [empty] * 3, empty, empty, empty,
                         lambda s: asked.append(s) or [empty] * 4)
    assert asked == [rng.STREAM_MEDIUM, rng.STREAM_MEDIUM + 1]
