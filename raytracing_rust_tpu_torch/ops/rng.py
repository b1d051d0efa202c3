"""Counter-based random numbers and closed-form samplers.

Counterpart of `raytracing_rust_tpu/ops/rng.py` (`in_unit_sphere`,
`in_unit_disk`) plus the port's generator. The JAX XLA tier folds keys with
`jax.random`; the TPU kernel seeds its core PRNG per grid step
(`pltpu.prng_seed(seed, pid)`), so its images depend on the tiling. The
port uses Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011) keyed by the seed and addressed by what a draw is
for, so an image depends on neither the launch shape nor the sample chunks.

Slot layout, shared by the CUDA kernel (`csrc/tracer.cu`) and the plain
version (`ops/tracer.trace_plain`):

    key     = (seed & 0xFFFFFFFF, seed >> 32)
    counter = (pixel id, global sample index, bounce, stream)

    stream 0 (CAMERA, bounce word 0): word 0 sub-pixel jitter x,
        word 1 jitter y, word 2 lens radius² (r = sqrt(u)), word 3 lens angle
    stream 1 (SCATTER, at each bounce): word 0 cos θ (2u − 1), word 1 φ,
        word 2 ball radius (cbrt(1 − u)), word 3 the dielectric's
        reflect-or-refract draw
    stream 2 (TIME, bounce word 0): word 0 the shutter time t0 + u·dt
        (scenes with moving spheres); words 1-3 unused
    stream 3 (GRAD, the fused differentiable tier `ops/grad.py`): counter
        (lane, 0, bounce, 3); all four words fill the u tensor
        [bounce, word, lane] of `grad.fast_draws`: word 0 cos θ, word 1 φ,
        word 2 ball radius, word 3 the dielectric's reflect-or-refract
        draw (read by no family the kernels cover yet)
    streams 4, 5 (MEDIUM, at each bounce, scenes with constant-density
        media): medium i (i < 8, the kernel's MAX_MEDIA) draws its free
        flight −(1/ρ)·ln u from word i % 4 of counter (pixel, sample,
        bounce, STREAM_MEDIUM + i // 4)
    stream 6 (ROULETTE, at each bounce from the render's rr_depth on, a
        path that scatters): word 0 the Russian roulette's survival draw
        (the path goes on if u < q); words 1-3 unused. No other draw reads
        this stream, so a render without roulette is the same as before
    streams 7 and up (MEDIUM_HI, the general tier only, which takes any
        number of media): medium i ≥ 8 draws from word i % 4 of counter
        (pixel, sample, bounce, STREAM_MEDIUM_HI + (i − 8) // 4), so no
        medium shares a stream with the roulette or another purpose
        (`medium_slot`)

The general tier (`ops/integrator.py`) reads the same slots as the kernel:
its bounce takes SCATTER words 0-3 as its sphere and branch columns, the
MEDIUM streams as its media columns and ROULETTE word 0 as its roulette
column, and its camera rays take the CAMERA and TIME streams, so where
the math is the same its paths are the kernel's.

`render.camera_lane_rays` keys the camera stream by lane instead of pixel:
counter (lane, 0, 0, 0).

Each 32-bit word becomes a uniform in [0, 1) as the TPU kernel's `_uniform`
does it (`ops/pallas_tracer.py:1028-1036`): `(bits >> 8) · 2⁻²⁴`.
The ball radius is `cbrt(1 − u)` (the XLA tier's form), not the TPU kernel's
max of three uniforms: one Philox call then serves a whole bounce.

`lanewise` evaluates the transcendental functions of the plain versions so
that a lane's result does not depend on where it lies in its tensor (see
there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAM_CAMERA = 0
STREAM_SCATTER = 1
STREAM_TIME = 2
STREAM_GRAD = 3
STREAM_MEDIUM = 4   # and 5: one counter for every four media
STREAM_ROULETTE = 6
STREAM_MEDIUM_HI = 7  # and up: media 8 and up (the general tier)
# media the MEDIUM streams hold (the kernel's MAX_MEDIA)
MEDIA_LO = 8

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF

# f32 constants, written once so every consumer multiplies by the same value
TWO_PI = float(np.float32(2.0 * math.pi))
ONE_THIRD = float(np.float32(1.0) / np.float32(3.0))
U24 = 1.0 / (1 << 24)

# lanewise: pad to a multiple of this many elements, and call the function
# on blocks of at most _LANE_BLOCK elements (a multiple of _LANE_PAD, below
# torch's intra-op grain of 32,768, so no block is split between threads)
_LANE_PAD = 64
_LANE_BLOCK = 1 << 14


def lanewise(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn(*xs) for an elementwise fn of same-shape tensors, computed so that
    an element's result does not depend on its position in the tensor.

    On the CPU, torch runs an elementwise function over a tensor in
    vector-width steps and the last few elements of each thread's range
    with a scalar routine; for some inputs of pow, atan2, sin, cos and log
    the two round apart in the last bit, so the same lane could get other
    bits in another chunk of samples.
    Padding to a multiple of 64 and calling fn on blocks that are
    multiples of 64 below the grain size puts every element on the vector
    path. On other devices fn runs as it is: a CUDA elementwise kernel
    computes every element alike.
    """
    x0 = xs[0]
    if x0.device.type != "cpu" or x0.numel() == 0:
        return fn(*xs)
    n = x0.numel()
    pad = (-n) % _LANE_PAD
    flat = [torch.cat([x.reshape(-1), x.new_ones(pad)]) for x in xs]
    out = torch.cat([fn(*(x[i:i + _LANE_BLOCK] for x in flat))
                     for i in range(0, n + pad, _LANE_BLOCK)])
    return out[:n].reshape(x0.shape)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m·x, for a 32-bit
    constant m and int64 tensor x holding uint32 values. The product fits
    64 bits; int64 multiplication wraps modulo 2^64 on both devices, so its
    bits are the product's, and the high half is read back past the sign
    (>> is arithmetic) by masking."""
    p = x * m
    return (p >> 32) & _MASK32, p & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 values.

    ctr: four broadcastable int64 tensors (c0..c3); key: two Python ints or
    int64 tensors (k0, k1). Returns the four output words as int64 tensors
    of uint32 values.
    """
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) → f32 uniforms in [0, 1) with 24 bits."""
    return (bits >> 8).to(torch.float32) * U24


def draws(seed: int, pixel, sample, bounce, stream):
    """The four f32 uniforms of counter (pixel, sample, bounce, stream)
    (broadcast tensors or ints)."""
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    pixel = torch.as_tensor(pixel, dtype=torch.int64)
    ctr = torch.broadcast_tensors(
        pixel, torch.as_tensor(sample, dtype=torch.int64, device=pixel.device),
        torch.as_tensor(bounce, dtype=torch.int64, device=pixel.device),
        torch.as_tensor(stream, dtype=torch.int64, device=pixel.device))
    return tuple(uniform01(w) for w in philox4x32_10(ctr, key))


def medium_slot(i: int) -> tuple[int, int]:
    """(stream, word) of medium i's free-flight draw: word i % 4 of stream
    STREAM_MEDIUM + i // 4 for the kernel's eight media, of stream
    STREAM_MEDIUM_HI + (i − 8) // 4 beyond them."""
    if i < MEDIA_LO:
        return STREAM_MEDIUM + i // 4, i % 4
    return STREAM_MEDIUM_HI + (i - MEDIA_LO) // 4, i % 4


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on any device, as XLA's is: torch's
    f32 sqrt on an AVX-512 CPU is not correctly rounded, and the root of an
    f32 value taken in f64 and rounded to f32 is. CUDA's f32 sqrt already
    is."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def draws_many(seed: int, pixel, sample, bounce, streams):
    """The four f32 uniforms of counters (pixel, sample, bounce, s) for
    each stream s of `streams`, in one Philox pass → four [len(streams),
    n] tensors; row k equals `draws(..., streams[k])` bit for bit."""
    pixel = torch.as_tensor(pixel, dtype=torch.int64)
    st = torch.tensor(list(streams), dtype=torch.int64,
                      device=pixel.device)[:, None]
    return draws(seed, pixel[None, :], torch.as_tensor(
        sample, dtype=torch.int64, device=pixel.device)[None, :], bounce, st)


def in_unit_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball from uniforms u[..., 3].

    Closed form replacement for the rejection loop at reference
    src/util.rs:4-13: uniform direction (cos-theta inversion) scaled by a
    U^(1/3) radius. The radius is taken from 1−u, not u: the uniforms are
    [0,1) and u=0 (one draw in 2^24) would return the exact zero vector,
    a scatter with a zero direction (misses everything; the sky
    background's normalize emits NaN). 1−u is uniform on (0,1]: the same
    distribution, without the zero.
    """
    cos_t = 2.0 * u[..., 0] - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWO_PI * u[..., 1]
    r = lanewise(lambda x: torch.pow(x, ONE_THIRD), 1.0 - u[..., 2])
    return torch.stack([r * (sin_t * lanewise(torch.cos, phi)),
                        r * (sin_t * lanewise(torch.sin, phi)),
                        r * cos_t], dim=-1)


def in_unit_disk(u: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk (z=0) from uniforms u[..., 2]
    (closed form replacement for reference src/util.rs:15-24)."""
    r = torch.sqrt(u[..., 0])
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * lanewise(torch.cos, phi),
                        r * lanewise(torch.sin, phi),
                        torch.zeros_like(r)], dim=-1)
