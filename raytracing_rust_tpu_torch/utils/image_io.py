"""Image output in the reference's format, in numpy only.

The reference writes ASCII PPM P3: header `P3\\n{nx} {ny}\\n255\\n`, one
`r g b\\n` line per pixel, rows top-first, channels quantized with
`(255.99 * c) as i32` truncation (reference tests/test.rs:58-80).
Counterpart of `raytracing_rust_tpu/utils/image_io.py`, whose output it
matches byte for byte.
"""

from __future__ import annotations

import numpy as np


def quantize(img: np.ndarray) -> np.ndarray:
    """[0,1] float image → int channel values, reference truncation
    (tests/test.rs:76-78)."""
    return (255.99 * np.asarray(img)).astype(np.int32)


# each channel value 0..255 as its decimal digits, right-padded with zero
# bytes to 3, then a zero byte where the separator goes; read as one
# little-endian uint32 per value, and the separators (a space after r and
# g, a newline after b) as the high byte of one
_TOKENS = np.zeros((256, 4), np.uint8)
for _v in range(256):
    _d = str(_v).encode()
    _TOKENS[_v, :len(_d)] = np.frombuffer(_d, np.uint8)
_TOKENS32 = _TOKENS.view("<u4").reshape(256)
_SEPS32 = np.frombuffer(b"  \n", np.uint8).astype("<u4") << 24


def to_ppm(img: np.ndarray) -> str:
    """float [ny, nx, 3] (row 0 = top) → P3 PPM text (tests/test.rs:59,79).
    Clipped to [0, 1] first, so an out-of-range value cannot emit an
    invalid channel.

    Vectorised: every channel becomes its 4-byte token from a lookup
    (digits, zero padding, separator: a space after r and g, a newline
    after b), and deleting the zero padding gives the bytes of the
    reference's `r g b` lines joined by newlines."""
    img = np.clip(np.asarray(img), 0.0, 1.0)
    ny, nx, _ = img.shape
    tok = _TOKENS32[quantize(img).reshape(-1, 3)] | _SEPS32   # [N, 3]
    body = tok.tobytes().translate(None, b"\0").decode("ascii") or "\n"
    return f"P3\n{nx} {ny}\n255\n{body}"


def write_ppm(path: str, img: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(to_ppm(img))


def read_ppm(path: str) -> np.ndarray:
    """Parse P3 PPM → float [ny, nx, 3] in [0,1]."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path}: not a P3 PPM")
    nx, ny, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4:4 + nx * ny * 3], dtype=np.float32)
    return (vals / maxv).reshape(ny, nx, 3)


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image
    arr = np.clip(quantize(img), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to float [H, W, 3] in [0,1] (scene-build time,
    like reference tests/test.rs:201-206 image::open().to_rgb8())."""
    from PIL import Image
    im = Image.open(path).convert("RGB")
    return np.asarray(im, dtype=np.float32) / 255.0
