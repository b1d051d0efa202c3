"""D3, the FP32 issue-rate probe (`csrc/peak.cu`), and its plain version.

Counterpart of `tools/kernel_stats.py` `vpu_peak`: k independent f32
accumulators per thread, `iters` trips of UNROLL operations each (adds of
±c, or fused a·m ± c), a runtime trip count; two trip counts timed by CUDA
events and differenced give the card's f32 operation rate with the launch
and the fixed cost cancelled. K1 and K2/K3 are built with -fmad=false, so
their f32 ceiling is the add rate; the FMA rate (an FMA counted as two
operations) is the one the published 67 TFLOP/s counts.

* `fp32_chain` is the wrapper: on CUDA it launches the kernel, on the CPU
  it runs `fp32_chain_plain`, the same chain on a torch tensor.
* `fp32_peak` measures a rate on the card.
"""

from __future__ import annotations

import numpy as np
import torch

UNROLL = 4   # operations per accumulator per trip (csrc/peak.cu UNROLL)
KS = (1, 2, 4, 8, 16, 32)   # the accumulator counts the kernel is built for
# the add chain's step, and the FMA chain's step and factor: the FMA's
# exact a·m ± c fits an f64 (a in [0.5, 2): 48 bits of a·m, c a power of
# two inside them), so the plain version's f64 product and sum, rounded
# once to f32, are the fused operation
ADD_C = float(np.float32(1e-3))
FMA_C = 2.0 ** -10
FMA_M = 1.0 - 2.0 ** -24

# launches of the D3 kernel, counted by `fp32_chain` after a launch succeeds
D3_LAUNCHES = 0


def _check(k: int, iters: int, blocks: int, threads: int) -> None:
    if k not in KS or iters < 0 or blocks <= 0 or not (
            0 < threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"k {k} not in {KS}, or iters {iters}, blocks "
                         f"{blocks}, threads {threads} out of range")


def fp32_chain_plain(k: int, iters: int, fma: bool, n: int,
                     device="cpu") -> torch.Tensor:
    """The kernel's accumulators in plain torch → f32[k, n]: accumulator j
    starts at 1 + 10⁻³·j (f32) in every thread and takes iters × UNROLL
    steps, alternately +c and −c: an f32 add, or with fma the fused
    a·FMA_M ± FMA_C."""
    acc = torch.arange(k, dtype=torch.float32, device=device) \
        * np.float32(1e-3) + 1.0
    for _ in range(iters):
        for u in range(UNROLL):
            if fma:
                c = FMA_C if u % 2 == 0 else -FMA_C
                acc = (acc.double() * FMA_M + c).float()
            else:
                acc = acc + (ADD_C if u % 2 == 0 else -ADD_C)
    return acc[:, None].expand(k, n).contiguous()


def fp32_chain(k: int, iters: int, fma: bool, blocks: int, threads: int,
               device="cuda") -> torch.Tensor:
    """D3's accumulators → f32[k, blocks·threads]. On CUDA it launches
    `csrc/peak.cu` on the current stream (building it at first use) or
    raises; on the CPU it runs `fp32_chain_plain`."""
    global D3_LAUNCHES
    _check(k, iters, blocks, threads)
    device = torch.device(device)
    n = blocks * threads
    if device.type == "cpu":
        return fp32_chain_plain(k, iters, fma, n)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    from ._build import load
    lib = load()
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.rt_fp32_peak(
            out.data_ptr(), k, iters, int(fma), FMA_C if fma else ADD_C,
            FMA_M, blocks, threads, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"D3 launch failed: cudaError {err}")
    D3_LAUNCHES += 1
    return out


def fp32_peak(k: int = 8, fma: bool = False, blocks: int | None = None,
              threads: int = 256, iters: int = 1 << 16) -> dict:
    """D3's rate on the card: `fp32_chain` timed by CUDA events at iters and
    3·iters trips (the best of three each), the difference of operations
    over the difference of times. An add is one operation, an FMA two.
    blocks defaults to 8 a streaming multiprocessor → dict(ops_per_s,
    k, fma, blocks, threads, iters, ms: the longer launch's time)."""
    if not torch.cuda.is_available():
        raise RuntimeError("fp32_peak measures the card: "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    if blocks is None:
        blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count

    def best_ms(n: int) -> float:
        times = []
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fp32_chain(k, n, fma, blocks, threads, dev)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return min(times)

    fp32_chain(k, 16, fma, blocks, threads, dev)   # warm-up
    t1, t2 = best_ms(iters), best_ms(3 * iters)
    ops = 2 * iters * k * UNROLL * (2 if fma else 1) * blocks * threads
    return dict(ops_per_s=ops / (max(t2 - t1, 1e-6) * 1e-3), k=k, fma=fma,
                blocks=blocks, threads=threads, iters=iters, ms=t2)
