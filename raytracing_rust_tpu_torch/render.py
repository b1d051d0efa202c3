"""The general tier's render loop, the reference's image contract, and
camera rays.

Counterpart of `raytracing_rust_tpu/render.py`: `render` walks pixel
blocks × sample chunks through the wavefront integrator in torch ops
(`ops/integrator.py`) with the compaction schedule (6, 12, 24) and
per-pixel f64 sums; `finalize_image` is the output contract, image row 0
the top scanline, gamma 2.0 via sqrt, clamp to [0,1] (reference
tests/test.rs:72-75); `camera_sample_rays` keys the camera's draws by
(pixel, sample) as the kernel's raygen does, `camera_lane_rays` by batch
lane for the trainer; `lane_radiance` and `train_step` are the one-device
counterparts of `parallel/sharding.py`'s `_lane_radiance` and
`train_step_sharded`: a pixel block's radiance through the general tier
and one differentiable training step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import checkpoint as ck
from .accel.bvh import LEAF_SIZE, MAX_STACK, ROW_FIELDS, build_bvh
from .models.scene import SceneTables
from .ops import rng
from .ops.camera import Camera, get_rays
from .ops.integrator import run_bounces, trace
from .ops.intersect import plan_pack
from .utils.timers import Timers

# re-compaction boundaries (bounce indices), the JAX package's: bounces
# 0-5 run at full width, then the survivors are gathered, and again at
# each later boundary
_COMPACT_SCHEDULE = (6, 12, 24)
# lanes (pixel × sample) of a chunk when the caller names no spp_chunk: on
# the card each eager op's launch costs about what 10⁶ lanes of work do, so
# the chunks are wide there
_CHUNK_LANES = {"cpu": 1 << 22, "cuda": 1 << 24}
# the bytes a lane of a BVH chunk may hold for its traversal, and what it
# holds: its stack (MAX_STACK int32 node ids), its state (sp, best t and
# prim, the inverse direction) and, at a leaf, the leaf's rows
# (`accel/bvh.leaf_rows`: ROW_FIELDS f32 a slot) with the candidate test's
# temporaries (about 24 f32 a slot)
_BVH_BUDGET_BYTES = {"cpu": 1 << 28, "cuda": 1 << 33}
_BVH_LANE_BYTES = 4 * MAX_STACK + 64 + LEAF_SIZE * 4 * (ROW_FIELDS + 24)
# the prim count from which `auto_use_bvh` takes the BVH, per device:
# `bench_large`'s crossover (big_spheres(n) at 64×36, 4 spp, depth 8: the
# first prim count from which the BVH general tier's rays/s beat the dense
# one's at every larger size), or None where the BVH never did
_BVH_AUTO_MIN_PRIMS = {
    # `bench_large --device cpu` on the 8-core CPU of the H100 host
    "cpu": 1004,
    # `bench_large` on an NVIDIA H100 80GB HBM3 at a 700 W power limit: up
    # to 100,004 prims the dense scan is 3.8-7.2× faster at its 9,216 lanes
    "cuda": None,
}


def finalize_image(sums: np.ndarray, spp: int, nx: int, ny: int) -> np.ndarray:
    """Radiance sums [nx·ny, 3] → display image float32 [ny, nx, 3]: the
    reference's gamma √ + clamp (tests/test.rs:72-75)."""
    img = np.sqrt(np.clip(sums / spp, 0.0, None))
    return np.clip(img, 0.0, 1.0).reshape(ny, nx, 3).astype(np.float32)


def camera_lane_rays(cam: Camera, pid: torch.Tensor, seed: int, nx: int,
                     ny: int, lane: torch.Tensor | None = None):
    """Flat pixel id per lane → (o, d, time) camera rays with the
    reference's sub-pixel jitter (tests/test.rs:62-68; row 0 = top via the
    j flip) and lens draws: Philox STREAM_CAMERA under key `seed`, keyed by
    lane (ops/rng.py), so a lane's ray depends on neither the batch split
    nor the device. lane: each lane's id, int64 like pid (default its
    position in the batch); a shard passes its lanes' ids in the whole
    batch, so it draws what the whole batch draws for them."""
    dev = pid.device
    f32 = cam.origin.dtype
    if lane is None:
        lane = torch.arange(pid.shape[0], dtype=torch.int64, device=dev)
    u0, u1, u2, u3 = rng.draws(seed, lane, 0, 0, rng.STREAM_CAMERA)
    i = (pid % nx).to(f32)
    j = (ny - 1 - pid // nx).to(f32)  # reference row order
    # tensor divisors: torch's CUDA division by a Python scalar multiplies
    # by the reciprocal
    s = (i + u0) / torch.tensor(float(nx), device=dev)
    t = (j + u1) / torch.tensor(float(ny), device=dev)
    return get_rays(cam, s, t, torch.stack([u2, u3, torch.zeros_like(u2)],
                                           dim=-1))


def camera_sample_rays(cam: Camera, pix: torch.Tensor, smp: torch.Tensor,
                       seed: int, nx: int, ny: int, moving: bool):
    """Camera rays of (pixel, sample) pairs → (o, d, time), drawn as the
    kernel's raygen draws them (`ops/tracer.trace_plain`): jitter and lens
    from counter (pixel, sample, 0, CAMERA), the shutter time from
    (pixel, sample, 0, TIME) in a scene with moving spheres (else time0)."""
    dev = pix.device
    u0, u1, u2, u3 = rng.draws(seed, pix, smp, 0, rng.STREAM_CAMERA)
    f32 = cam.origin.dtype
    i = (pix % nx).to(f32)
    j = (ny - 1 - pix // nx).to(f32)  # reference row order
    s = (i + u0) / torch.tensor(float(nx), device=dev)
    t = (j + u1) / torch.tensor(float(ny), device=dev)
    ut = (rng.draws(seed, pix, smp, 0, rng.STREAM_TIME)[0] if moving
          else torch.zeros_like(u2))
    return get_rays(cam, s, t, torch.stack([u2, u3, ut], dim=-1))


def auto_use_bvh(scene: SceneTables, device="cuda") -> bool:
    """Whether a general-tier render of scene on device takes the BVH when
    the caller does not say: from the device's measured crossover on
    (`_BVH_AUTO_MIN_PRIMS`), never where the device has none."""
    at = _BVH_AUTO_MIN_PRIMS[torch.device(device).type]
    return at is not None and scene.num_prims >= at


def trace_compact(scene: SceneTables, pack, seed: int, pix, smp, o, d, time,
                  max_depth: int, rr_depth: int | None = None,
                  schedule=_COMPACT_SCHEDULE, bvh=None) -> torch.Tensor:
    """Radiance [N, 3] of a batch of camera rays with wavefront compaction:
    bounces 0 ≤ b < schedule[0] at full width, then at each boundary the
    live lanes are gathered (`torch.nonzero`, an exact count) with their
    state and draw keys and the next segment runs on them alone. A lane's
    state and draws are the full width's, so the radiance equals the full
    width's (`trace`) bit for bit. bvh: as in `integrator.trace`."""
    thr = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    s1 = min(schedule[0], max_depth + 1)
    o, d, thr, rad, alive = run_bounces(scene, pack, seed, pix, smp,
                                        max_depth, 0, s1, o, d, time, thr,
                                        rad, alive, rr_depth, bvh=bvh)
    rad_full, lane = rad, None
    b0 = s1
    for b_end in [b for b in schedule[1:] if b <= max_depth] + [max_depth + 1]:
        if b0 > max_depth:
            break
        keep = torch.nonzero(alive).squeeze(1)
        if keep.numel() == 0:
            break
        if lane is not None:
            rad_full[lane] = rad
        lane = keep if lane is None else lane[keep]
        o, d, time, thr, rad, pix, smp = (
            x[keep] for x in (o, d, time, thr, rad, pix, smp))
        o, d, thr, rad, alive = run_bounces(
            scene, pack, seed, pix, smp, max_depth, b0, b_end, o, d, time,
            thr, rad, torch.ones_like(keep, dtype=torch.bool), rr_depth,
            bvh=bvh)
        b0 = b_end
    if lane is not None:
        rad_full[lane] = rad
    return rad_full


def render_sums(scene: SceneTables, cam: Camera, nx: int, ny: int, spp: int,
                *, device="cuda", seed: int = 0, max_depth: int = 50,
                block_pixels: int = 1 << 16, spp_chunk: int | None = None,
                rr_depth: int | None = None, compact: bool = True,
                checkpoint: str | None = None,
                timers: Timers | None = None,
                pixels: tuple[int, int] | None = None,
                samples: tuple[int, int] | None = None,
                use_bvh: bool | None = None, progress=None,
                _stop_after_blocks: int | None = None):
    """The general tier's per-pixel radiance sums → f64[3, nx·ny] on the
    device, each pixel's samples added in sample order (see `render`), or
    None when `_stop_after_blocks` stopped the render. pixels, samples:
    the ranges [lo, hi) of flat pixel ids and of samples that this call
    traces (default all); the sums of other pixels stay 0, so a shard's
    sums are the whole render's rows for its pixels when it has every
    sample (`parallel/sharding.py`). A range may be empty."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested, but "
                           "torch.cuda.is_available() is false")
    if min(nx, ny, spp, block_pixels) <= 0 or max_depth < 0:
        raise ValueError(f"bad render size {nx}x{ny} spp={spp} "
                         f"depth={max_depth} block={block_pixels}")
    p_lo, p_hi = pixels or (0, nx * ny)
    s_lo, s_hi = samples or (0, spp)
    if not (0 <= p_lo <= p_hi <= nx * ny and 0 <= s_lo <= s_hi <= spp):
        raise ValueError(f"pixels {pixels} or samples {samples} outside "
                         f"{nx * ny} pixels × {spp} samples")
    if checkpoint and (pixels or samples):
        raise ValueError("a checkpoint holds a whole render, not a range")
    if timers is None:
        timers = Timers()
    if use_bvh is None:
        use_bvh = auto_use_bvh(scene, device)
    n_pix = nx * ny
    block_pixels = min(block_pixels, n_pix)
    if spp_chunk is None:
        lanes = _CHUNK_LANES[device.type]
        if use_bvh:
            lanes = min(lanes, _BVH_BUDGET_BYTES[device.type]
                        // _BVH_LANE_BYTES)
        spp_chunk = max(1, min(spp, lanes // block_pixels))
    bvh = None
    if use_bvh:
        with timers.phase("bvh_build"):
            bvh = build_bvh(scene).to(device)
    with timers.phase("upload"):
        scene = scene.to(device)
        cam = cam.to(device)
        pack = plan_pack(scene)
        sums = torch.zeros((3, n_pix), dtype=torch.float64, device=device)

    start = p_lo
    want = None
    if checkpoint:
        # imported here: ops.tracer imports this module
        from .ops.tracer import build_camera_record
        want = ck.meta(ck.ENGINE_GENERAL_BVH if use_bvh else
                       ck.ENGINE_GENERAL, nx, ny, spp, seed, max_depth,
                       rr_depth, ck.scene_digest(scene),
                       build_camera_record(cam).tobytes())
        got = ck.load(checkpoint, want)
        if got is not None:
            sums = torch.from_numpy(got["sums"]).to(device)
            start = int(got["next_pixel"])

    n_chunks = len(range(s_lo, s_hi, spp_chunk))
    total = len(range(p_lo, p_hi, block_pixels)) * n_chunks
    done = len(range(p_lo, start, block_pixels)) * n_chunks
    n_run = 0
    for lo in range(start, p_hi, block_pixels):
        hi = min(lo + block_pixels, p_hi)
        nb = hi - lo
        pix_blk = torch.arange(lo, hi, dtype=torch.int64, device=device)
        for s0 in range(s_lo, s_hi, spp_chunk):
            ns = min(spp_chunk, s_hi - s0)
            with timers.phase("raygen"):
                # lanes sample-major: lane k·nb + i is pixel lo + i's
                # sample s0 + k
                pix = pix_blk.repeat(ns)
                smp = torch.arange(s0, s0 + ns, dtype=torch.int64,
                                   device=device).repeat_interleave(nb)
                o, d, time = camera_sample_rays(cam, pix, smp, seed, nx, ny,
                                                scene.has_moving)
            with timers.phase("trace"):
                if compact:
                    rad = trace_compact(scene, pack, seed, pix, smp, o, d,
                                        time, max_depth, rr_depth, bvh=bvh)
                else:
                    rad = trace(scene, o, d, time, seed, pix, smp, max_depth,
                                rr_depth, pack, bvh=bvh)
            with timers.phase("accumulate"):
                per_sample = rad.double().view(ns, nb, 3)
                for k in range(ns):
                    sums[:, lo:hi] += per_sample[k].T
            done += 1
            if progress is not None:
                progress(done, total)
        n_run += 1
        if checkpoint:
            with timers.phase("checkpoint_io"):
                ck.save(checkpoint, want, sums=sums.cpu().numpy(),
                        next_pixel=hi)
        if _stop_after_blocks is not None and n_run >= _stop_after_blocks:
            return None
    return sums


def lane_radiance(scene: SceneTables, cam: Camera, pix: torch.Tensor,
                  seed: int, nx: int, ny: int, spp: int, max_depth: int,
                  differentiable: bool = False,
                  u: torch.Tensor | None = None,
                  lane: torch.Tensor | None = None) -> torch.Tensor:
    """Radiance sums f32[npix, 3] of an [npix, spp] lane grid through the
    general tier at full width. pix: int64[npix]; the lanes are laid out
    pixel-major (lane k·spp + s is pixel pix[k]'s sample s), and
    `camera_lane_rays` keys their rays by lane under `seed`; the trace's
    draws are `lane_draws` keyed by (lane, 0) under `seed`, or u (see
    `integrator.trace`). differentiable: checkpointed bounces. lane: the
    grid's lane ids int64[npix·spp] in that layout, default its positions;
    a shard of a larger grid passes its lanes' ids in that grid."""
    npix = pix.shape[0]
    pid = pix.repeat_interleave(spp)
    if lane is None:
        lane = torch.arange(pid.shape[0], dtype=torch.int64,
                            device=pid.device)
    o, d, time = camera_lane_rays(cam, pid, seed, nx, ny, lane)
    rad = trace(scene, o, d, time, seed, lane, torch.zeros_like(lane),
                max_depth, differentiable=differentiable, u=u)
    return rad.reshape(npix, spp, 3).sum(dim=1)


def train_step(scene: SceneTables, cam: Camera, pix: torch.Tensor,
               seed: int, target: torch.Tensor, *, nx: int, ny: int,
               spp: int, max_depth: int, wrt=("tex_color",),
               u: torch.Tensor | None = None):
    """One differentiable training step: the L2 photometric loss of the
    block's image (`lane_radiance` / spp) against target f32[npix, 3] →
    (loss, {table: gradient}) for each float table of `SceneTables` named
    in wrt (prim_data, tex_color, mat_param, images, tex_scale, xf_sin,
    xf_cos, xf_offset, …). A table whose gradient is zero everywhere (no
    path reaches it) gets zeros. The gradients are taken with respect to
    the tables as given: a caller whose tables are functions of its own
    parameters chains them on (`torch.autograd.backward`)."""
    leaves = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in wrt}
    s = dataclasses.replace(scene, **leaves)
    with torch.enable_grad():
        img = lane_radiance(s, cam, pix, seed, nx, ny, spp, max_depth,
                            differentiable=True, u=u) / spp
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def render(scene: SceneTables, cam: Camera, nx: int, ny: int, spp: int, *,
           device="cuda", seed: int = 0, max_depth: int = 50,
           block_pixels: int = 1 << 16, spp_chunk: int | None = None,
           rr_depth: int | None = None, compact: bool = True,
           checkpoint: str | None = None, timers: Timers | None = None,
           use_bvh: bool | None = None, progress=None,
           _stop_after_blocks: int | None = None) -> np.ndarray | None:
    """Full image through the general tier → float32 [ny, nx, 3], row 0 at
    the top, with the reference's gamma (sqrt + clamp, tests/test.rs:72-75).

    Every scene the tables hold renders here, the ones the kernel refuses
    included (an image on a rotated sphere, a nested checker, an image that
    is not 8-bit exact, any number of media, any number of rects).
    device: where the tables and the wavefront live ("cuda", the default,
    raises when CUDA is absent; "cpu"). The draws are keyed by (pixel,
    sample, bounce) in the kernel's Philox slots, and each pixel's f64 sums
    are taken in sample order, so the image is the same bit for bit for
    every block_pixels, spp_chunk (default: 2^24 lanes a chunk on the card,
    2^22 on the CPU) and
    compaction (compact=False runs every bounce at full width).
    rr_depth: Russian roulette from this bounce on, or None.
    use_bvh: find each closest hit by a BVH's traversal (`accel/bvh.py`: the
    tree built once a call, the phase bvh_build) or by the dense scan; None
    (the default) takes `auto_use_bvh`'s choice for the device. The two
    give the same image but where a near-tangent ray or an exact tie picks
    another prim; a BVH chunk holds at most _BVH_BUDGET_BYTES of traversal
    state, which also bounds the default spp_chunk.
    checkpoint: an .npz path; the sums are saved after each pixel block and
    a render whose meta matches resumes after the last saved block (a
    mismatch, a BVH render's checkpoint for a dense one included, warns
    and starts over). timers: phases bvh_build, upload, raygen,
    trace, accumulate, checkpoint_io, finalize. progress: called as
    progress(done, total) after each (pixel block, sample chunk), e.g.
    `utils.progress.ProgressBar`; it reads no device value.
    _stop_after_blocks: a test hook that stops the render after that many
    blocks, as if the process had died, and returns None.
    """
    if timers is None:
        timers = Timers()
    sums = render_sums(scene, cam, nx, ny, spp, device=device, seed=seed,
                       max_depth=max_depth, block_pixels=block_pixels,
                       spp_chunk=spp_chunk, rr_depth=rr_depth,
                       compact=compact, checkpoint=checkpoint, timers=timers,
                       use_bvh=use_bvh, progress=progress,
                       _stop_after_blocks=_stop_after_blocks)
    if sums is None:
        return None
    with timers.phase("finalize"):
        return finalize_image(sums.T.cpu().numpy(), spp, nx, ny)
