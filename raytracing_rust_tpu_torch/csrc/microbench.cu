// D1 and D2: the megakernel's hot building blocks, timed alone, for Hopper
// (sm_90a).
//
// Replaces tools/microbench.py's two Pallas kernels: `gather_kernel_factory`
// (D1, the thin hit path's winner-attribute gather `_attr_gather`) and
// `member_kernel_factory` (D2: one sphere member test, one merged-box slab
// test, `jnp.any` of the tile's mask, the packed 31-bit OR-tree
// `_or_reduce`). Each runs k iterations of its block in a loop with a
// runtime trip count; two trip counts timed and differenced on the host
// (ops/microbench.py `per_call`) give the cost of one iteration with the
// launch and the fixed cost cancelled. One thread is one lane of the TPU's
// (8, 1024) tile, so the default 8,192 threads fill 32 of the card's 132
// SMs, and their per-call figures are latencies; a launch of one full wave
// of each kernel (SMs × the blocks of it an SM holds at once, which
// `rt_mb_blocks_per_sm` asks the runtime for) gives the throughput.
//
// D1, the winner-row read. The TPU kernel resolves a winner's attributes
// through a transposed table (fields on sublanes, primitives on lanes) and
// 128-wide lane gathers, because Mosaic has no per-lane load. The port has
// no such table: K1 reads a winner's row (csrc/tracer.cu, the box and
// dynamic winners' resolve). So D1 is that read: iteration i of a thread
// reads all W = 8 · bands words of row (col + i) mod 1400 of a row-major
// int32 table [1408, W] (the JAX tool's [32, 1408] table transposed), as
// 16-byte vector loads, from device memory through the read-only cache
// (`global`, as K1 reads its tables) or from a copy of the table staged in
// shared memory by every block (`shared`: 180,224 bytes at 4 bands, past
// the 48 KB default, so the launch opts in). It adds word 0, read as an f32, to
// an accumulator and folds every word into an xor checksum, so no load is
// dead; both are outputs. What bounds it: the loads' latency at 8,192
// threads; at a full wave the SM's load path, since the 180 KB table stays
// on chip (L1, L2 or shared memory), never in device memory's rate: an SM
// delivers at most 128 bytes a clock from L1 or shared memory (32 banks of
// 4 bytes), and that rate, not the HBM rate, is D1's floor.
//
// D2, the member tests and the votes. A thread reads record q mod 64 of an
// f32[64, 46] table as K1 reads a dynamic row (one `__ldg` row, the same for
// every thread). `sphere` and `box` copy the JAX tool's bodies operation
// for operation (the box's reciprocal is the tool's unsigned `si`: 1e30
// below |d| = 1e-30) and keep the closest t and its index. On the TPU,
// `any` and `or_tree` reduce over the whole 8,192-lane tile; the card's
// lockstep unit is the warp, so they become `__any_sync` and
// `__reduce_or_sync` over 32 threads (a tile's answer is the OR of its
// warps'), the reductions a warp-vote leaf cull would issue. Their answers
// are added to t_b as in the JAX tool (3e38 + n = 3e38, so the f32 output
// cannot show them), and each thread also writes an int32 fold of its
// votes: for `any` the count of iterations whose vote was true, for
// `or_tree` the xor of the reduced words. What bounds it: issue, the
// record row and the accumulators live in registers and L1.
//
// Numerics: no fast math, -fmad=false, every f32 expression in the JAX
// body's order, so the outputs equal the plain versions' in
// ops/microbench.py bit for bit. D1's words are below 2^20, so as f32 they
// are denormals: the card keeps them (this file is built without
// -ftz=true), as torch does; XLA on a CPU flushes them to zero, and the TPU
// has none, so the JAX tool's own D1 output is 0.0 and no check can use it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // threads a block
constexpr int ROWS_READ = 1400;  // rows (col + i) mod ROWS_READ are read
constexpr int TABLE_ROWS = 1408;  // the table's rows, all staged by shared
constexpr int REC = 46;          // D2's record width (pallas_tracer.py REC)
constexpr int N_REC = 64;        // D2's records
constexpr int KIND_SPHERE = 0, KIND_BOX = 1, KIND_ANY = 2, KIND_OR = 3;

template <bool SHARED, int W>
__global__ void __launch_bounds__(THREADS)
attr_read_k(const int* __restrict__ table, const int* __restrict__ col, int n,
            int k, float* __restrict__ acc_out, int* __restrict__ ck_out) {
  extern __shared__ int4 s_tab[];
  const int4* tab = reinterpret_cast<const int4*>(table);
  if (SHARED) {
    for (int i = threadIdx.x; i < TABLE_ROWS * W / 4; i += blockDim.x)
      s_tab[i] = __ldg(tab + i);
    __syncthreads();
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  // an unsigned index, so any col stays inside the table
  const uint32_t c = (uint32_t)__ldg(col + p);
  float acc = 0.0f;
  int ck = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t row = (c + (uint32_t)i) % (uint32_t)ROWS_READ;
    int word0 = 0;
#pragma unroll
    for (int j = 0; j < W / 4; ++j) {
      const int4 v = SHARED ? s_tab[row * (W / 4) + j]
                            : __ldg(tab + row * (W / 4) + j);
      if (j == 0) word0 = v.x;
      ck ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    acc = acc + __int_as_float(word0);
  }
  acc_out[p] = acc;
  ck_out[p] = ck;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
member_k(const float* __restrict__ rec, const int* __restrict__ x, int n,
         int k, float* __restrict__ out, int* __restrict__ fold_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  // n is a multiple of 32: a warp leaves whole, and the votes see 32 lanes
  if (p >= n) return;
  const float xf = (float)__ldg(x + p) * 1e-3f;
  const float ox = xf, oy = xf, oz = xf;
  const float dx = xf + 0.1f, dy = xf + 0.2f, dz = xf + 0.3f;
  const float a_dd = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a_dd;
  // the box's reciprocals (`si`), computed once: the JAX body computes them
  // in every iteration, but K1 takes a ray's reciprocals once, so this times
  // K1's hoisted form on purpose (nvcc would hoist them out of the loop
  // anyway); D2_OPS counts no `si`
  const float ix = fabsf(dx) < 1e-30f ? 1e30f : 1.0f / dx;
  const float iy = fabsf(dy) < 1e-30f ? 1e30f : 1.0f / dy;
  const float iz = fabsf(dz) < 1e-30f ? 1e30f : 1.0f / dz;
  float t_b = 3e38f, wi = 0.0f;
  int fold = 0;
  for (int q = 0; q < k; ++q) {
    const float* r = rec + (q % N_REC) * REC;
    if (KIND == KIND_SPHERE) {
      const float ocx = ox - __ldg(r), ocy = oy - __ldg(r + 1),
                  ocz = oz - __ldg(r + 2);
      const float bq = ocx * dx + ocy * dy + ocz * dz;
      const float cq = ocx * ocx + ocy * ocy + ocz * ocz - __ldg(r + 3);
      const float disc = bq * bq - a_dd * cq;
      const bool pos = disc > 0.0f;
      const float sq = sqrtf(pos ? disc : 1.0f);
      const float t_near = (-bq - sq) * inv_a;
      const float t_far = (-bq + sq) * inv_a;
      const float t_sel = t_near > 1e-3f ? t_near : t_far;
      const bool ok = pos && t_sel > 1e-3f && t_sel < t_b;
      t_b = ok ? t_sel : t_b;
      wi = ok ? (float)q : wi;
    } else if (KIND == KIND_BOX) {
      float t0 = (__ldg(r) - ox) * ix, t1 = (__ldg(r + 3) - ox) * ix;
      float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
      t0 = (__ldg(r + 1) - oy) * iy;
      t1 = (__ldg(r + 4) - oy) * iy;
      tmn = fmaxf(tmn, fminf(t0, t1));
      tmx = fminf(tmx, fmaxf(t0, t1));
      t0 = (__ldg(r + 2) - oz) * iz;
      t1 = (__ldg(r + 5) - oz) * iz;
      tmn = fmaxf(tmn, fminf(t0, t1));
      tmx = fminf(tmx, fmaxf(t0, t1));
      const float t_sel = tmn > 1e-3f ? tmn : tmx;
      const bool ok = tmx > tmn && t_sel > 1e-3f && t_sel < t_b;
      t_b = ok ? t_sel : t_b;
      wi = ok ? (float)q : wi;
    } else if (KIND == KIND_ANY) {
      const int vote = __any_sync(0xffffffffu, xf + (float)q > 0.5f);
      t_b = t_b + (float)vote;
      fold += vote;
    } else {
      const uint32_t m = (uint32_t)(xf > 0.0f) << (q % 31);
      const int word = (int)__reduce_or_sync(0xffffffffu, m);
      t_b = t_b + (float)word;
      fold ^= word;
    }
  }
  out[p] = t_b + wi;
  fold_out[p] = fold;
}

using AttrFn = void (*)(const int*, const int*, int, int, float*, int*);
using MemberFn = void (*)(const float*, const int*, int, int, float*, int*);

AttrFn attr_fn(int shared, int w) {
  return shared ? (w == 32 ? attr_read_k<true, 32> : attr_read_k<true, 16>)
                : (w == 32 ? attr_read_k<false, 32> : attr_read_k<false, 16>);
}

// D1's dynamic shared memory, opted in past the 48 KB default when staged
cudaError_t attr_smem(AttrFn fn, int shared, int w, size_t* smem) {
  *smem = shared ? sizeof(int) * (size_t)TABLE_ROWS * w : 0;
  if (!shared) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

MemberFn member_fn(int kind) {
  switch (kind) {
    case KIND_SPHERE: return member_k<KIND_SPHERE>;
    case KIND_BOX: return member_k<KIND_BOX>;
    case KIND_ANY: return member_k<KIND_ANY>;
    case KIND_OR: return member_k<KIND_OR>;
    default: return nullptr;
  }
}

}  // namespace

// D1: k iterations of the winner-row read by n threads (see above). table:
// int32[rows, w], row-major, 16-byte aligned, rows ≥ 1,408, w = 16 or 32 (2
// or 4 bands); col: int32[n], read as unsigned; acc: f32[n]; ck: int32[n].
// shared stages rows 0 .. 1,407 in shared memory first. Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int rt_attr_read(const int* table, int rows, int w,
                            const int* col, int n, int k, int shared,
                            float* acc, int* ck, void* stream) {
  if (rows < TABLE_ROWS || (w != 16 && w != 32) || n <= 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  const AttrFn fn = attr_fn(shared, w);
  size_t smem;
  const cudaError_t e = attr_smem(fn, shared, w, &smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<(n + THREADS - 1) / THREADS, THREADS, smem, (cudaStream_t)stream>>>(
      table, col, n, k, acc, ck);
  return (int)cudaGetLastError();
}

// D2: k iterations of one kind (0 sphere, 1 box, 2 any, 3 or_tree) by n
// threads, n a multiple of 32 (see above). rec: f32[64, 46]; x: int32[n];
// out: f32[n] = t_b + wi; fold: int32[n] (0 for sphere and box). Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int rt_member(const float* rec, const int* x, int n, int k,
                         int kind, float* out, int* fold, void* stream) {
  const MemberFn fn = member_fn(kind);
  if (!fn || n <= 0 || n % 32 != 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  fn<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      rec, x, n, k, out, fold);
  return (int)cudaGetLastError();
}

// Blocks of 256 threads an SM holds at once of one kernel → *blocks: D1 at
// w = arg words a row (staged in shared memory if shared), or D2 of kind
// arg. Returns the query's cudaError.
extern "C" int rt_mb_blocks_per_sm(int d2, int arg, int shared, int* blocks) {
  if (d2) {
    const MemberFn fn = member_fn(arg);
    if (!fn) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fn, THREADS, 0);
  }
  if (arg != 16 && arg != 32) return (int)cudaErrorInvalidValue;
  const AttrFn fn = attr_fn(shared, arg);
  size_t smem;
  const cudaError_t e = attr_smem(fn, shared, arg, &smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, THREADS, smem);
}
