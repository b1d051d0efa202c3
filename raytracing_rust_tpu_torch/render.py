"""The reference's image contract, and camera rays per lane.

Counterpart of `finalize_image` and `camera_lane_rays` in
`raytracing_rust_tpu/render.py`: image row 0 is the top scanline, gamma 2.0
via sqrt, clamp to [0,1] (reference tests/test.rs:72-75).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import rng
from .ops.camera import Camera, get_rays


def finalize_image(sums: np.ndarray, spp: int, nx: int, ny: int) -> np.ndarray:
    """Radiance sums [nx·ny, 3] → display image float32 [ny, nx, 3]: the
    reference's gamma √ + clamp (tests/test.rs:72-75)."""
    img = np.sqrt(np.clip(sums / spp, 0.0, None))
    return np.clip(img, 0.0, 1.0).reshape(ny, nx, 3).astype(np.float32)


def camera_lane_rays(cam: Camera, pid: torch.Tensor, seed: int, nx: int,
                     ny: int):
    """Flat pixel id per lane → (o, d, time) camera rays with the
    reference's sub-pixel jitter (tests/test.rs:62-68; row 0 = top via the
    j flip) and lens draws: Philox STREAM_CAMERA under key `seed`, keyed by
    lane (ops/rng.py), so a lane's ray depends on neither the batch split
    nor the device."""
    dev = pid.device
    f32 = cam.origin.dtype
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
