"""Resumable renders: an `.npz` of per-pixel radiance sums and progress.

Counterpart of the checkpoints of `raytracing_rust_tpu/render.py` (per
pixel block) and `ops/pallas_tracer.render_pallas` (per sample chunk). Both
engines of the port save after each unit of work through a temporary file
and `os.replace`, so a render killed at any moment leaves the last
finished unit on disk, and a resumed render equals an uninterrupted one
byte for byte: the port's sums depend on neither the sample chunks, the
pixel blocks, the pixel table nor the device's launch shape, so the meta
keys only on what changes the image. A checkpoint whose meta differs (a
new seed, scene, camera, size or engine) is not merged: the render warns on
stderr and starts over, where the JAX package discards it silently.
"""

from __future__ import annotations

import hashlib
import os
import struct
import sys
from dataclasses import fields

import numpy as np

# bump whenever a code change alters the image for an identical (scene,
# camera, configuration), so a checkpoint of an older build never resumes
CK_LAYOUT_VERSION = 1
ENGINE_KERNEL = 1
ENGINE_GENERAL = 2
# the general tier with its closest hits from a BVH: the same image but
# where a near-tangent ray picks another prim, so a dense render's
# checkpoint never resumes a BVH render, nor the other way round (JAX's
# digest takes use_bvh)
ENGINE_GENERAL_BVH = 3


def scene_digest(scene) -> bytes:
    """A digest of every field of a scene's tables, the static flags
    included (the general tier renders from the tables themselves)."""
    h = hashlib.sha256()
    for f in fields(scene):
        v = getattr(scene, f.name)
        if f.metadata.get("static"):
            h.update(f"{f.name}={v!r};".encode())
        else:
            a = v.detach().cpu().contiguous().numpy()
            h.update(f"{f.name}{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.digest()


def meta(engine: int, nx: int, ny: int, spp: int, seed: int, max_depth: int,
         rr_depth: int | None, digest: bytes, cam_bytes: bytes) -> np.ndarray:
    """The bytes a checkpoint must match to resume: the layout version, the
    engine, the size, spp, seed, depth cap and roulette depth, the scene's
    digest and the camera record's bytes → uint8[...]."""
    head = struct.pack("<9q", CK_LAYOUT_VERSION, engine, nx, ny, spp, seed,
                       max_depth, -1 if rr_depth is None else rr_depth,
                       len(digest))
    return np.frombuffer(head + digest + cam_bytes, np.uint8).copy()


def load(path: str | None, want: np.ndarray):
    """The arrays of the checkpoint at path when its meta equals want, else
    None; a checkpoint with another meta is reported on stderr and left to
    be overwritten."""
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as ck:
        if np.array_equal(ck["meta"], want):
            return {k: ck[k] for k in ck.files}
    print(f"checkpoint {path}: written for another render (scene, camera, "
          "size, seed, depth or engine); starting over", file=sys.stderr)
    return None


def save(path: str, want: np.ndarray, **arrays) -> None:
    """Write the checkpoint through a temporary file and os.replace."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, meta=want, **arrays)
    os.replace(tmp, path)
