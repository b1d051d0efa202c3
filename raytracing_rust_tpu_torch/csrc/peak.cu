// D3: the FP32 issue-rate probe for Hopper (sm_90a).
//
// Replaces tools/kernel_stats.py `vpu_peak` (its Pallas kernel, 128-206):
// back-to-back f32 operations on k independent accumulators, a runtime
// trip count so nothing folds, alternating +c / −c so the chain is no
// constant, and two trip counts timed and differenced on the host
// (ops/peak.py `fp32_peak`) to cancel the launch and the kernel's fixed
// cost. One thread is one lane here: a thread carries its k accumulators
// in registers (the TPU kernel's (8, lanes) tiles become the launch's
// threads), and the grid size takes the place of the lane count in the
// sweep.
//
// What bounds it: issue, nothing else. The accumulators never leave the
// registers (ptxas: k + a few registers, no spill, no local memory) and
// the one store of each at the end is the only memory traffic. K1 and K2/K3
// are built with -fmad=false, so they issue no fused multiply-add: their
// f32 ceiling is the add rate, which the FMA=false variant measures (one
// FADD per operation). The FMA=true variant calls __fmaf_rn explicitly,
// which -fmad=false leaves fused, and measures the rate the published
// 67 TFLOP/s counts (an FMA as two operations).
//
// Numerics: every add rounds on its own, and __fmaf_rn rounds once, so the
// accumulators equal the plain version's (`fp32_chain_plain`) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 4;  // operations per accumulator per trip

template <int K, bool FMA>
__global__ void fp32_peak_k(float* __restrict__ out, int iters, float c,
                            float m) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = gridDim.x * blockDim.x;
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 1.0f + 1e-3f * (float)j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float cu = u % 2 == 0 ? c : -c;
#pragma unroll
      for (int j = 0; j < K; ++j)
        acc[j] = FMA ? __fmaf_rn(acc[j], m, cu) : acc[j] + cu;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) out[(size_t)j * n + tid] = acc[j];
}

using PeakFn = void (*)(float*, int, float, float);

template <int K>
PeakFn pick(bool fma) {
  return fma ? fp32_peak_k<K, true> : fp32_peak_k<K, false>;
}

}  // namespace

// Runs `iters` trips of UNROLL operations on k f32 accumulators in each of
// blocks × threads threads (k in 1, 2, 4, 8, 16, 32): adds of ±c, or with
// fma, fused a·m ± c. Writes accumulator j of thread t to out[j·n + t], n =
// blocks·threads. Launches on `stream`; returns cudaGetLastError() after the
// launch.
extern "C" int rt_fp32_peak(float* out, int k, int iters, int fma, float c,
                            float m, int blocks, int threads, void* stream) {
  PeakFn fn = nullptr;
  switch (k) {
    case 1: fn = pick<1>(fma); break;
    case 2: fn = pick<2>(fma); break;
    case 4: fn = pick<4>(fma); break;
    case 8: fn = pick<8>(fma); break;
    case 16: fn = pick<16>(fma); break;
    case 32: fn = pick<32>(fma); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (iters < 0 || blocks <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  fn<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters, c, m);
  return (int)cudaGetLastError();
}
