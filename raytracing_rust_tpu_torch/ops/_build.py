"""Build and bind the package's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` of the package, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, in `_build/` beside the package
(listed in `.gitignore`), named by a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library. It is loaded with
ctypes; every pointer and the stream pass as `c_void_p`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

# No --use_fast_math, and -fmad=false: every multiply and add rounds on its
# own, as torch's elementwise ops do, so a kernel agrees with its plain
# version path by path.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


@functools.cache
def build() -> tuple[str, str]:
    """Compile the kernels if needed → (library path, compiler output; empty
    when the library already existed)."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    lib = os.path.join(_BUILD, f"librt_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    for s, p, out in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(s)} "
                               f"({p.returncode}):\n{out}")
    res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, "".join(logs)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library with its entry points' signatures declared."""
    lib = ctypes.CDLL(build()[0])
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.rt_trace_k1.argtypes = [p, i, p, i, p, i, p, i, p, i, p, i, p, i, i,
                                u, u, i, i, i, p, i, i, p, i, i, u, p, i, p,
                                i, p, i, p, i, p, i, i, p, i, i, p, i, p]
    lib.rt_trace_k1.restype = i
    lib.rt_trace_k1_blocks_per_sm.argtypes = [i, i, i, i, p]
    lib.rt_trace_k1_blocks_per_sm.restype = i
    lib.rt_grad_fwd.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i,
                                i, p, p]
    lib.rt_grad_fwd.restype = i
    lib.rt_grad_bwd.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                i, i, i, i, p, i, p]
    lib.rt_grad_bwd.restype = i
    lib.rt_grad_occupancy.argtypes = [i, p]
    lib.rt_grad_occupancy.restype = i
    f = ctypes.c_float
    lib.rt_fp32_peak.argtypes = [p, i, i, i, f, f, i, i, p]
    lib.rt_fp32_peak.restype = i
    lib.rt_attr_read.argtypes = [p, i, i, p, i, i, i, p, p, p]
    lib.rt_attr_read.restype = i
    lib.rt_member.argtypes = [p, p, i, i, i, p, p, p]
    lib.rt_member.restype = i
    lib.rt_mb_blocks_per_sm.argtypes = [i, i, i, p]
    lib.rt_mb_blocks_per_sm.restype = i
    return lib
