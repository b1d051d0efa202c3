// K2 and K3: the fused differentiable trace, forward and backward, for
// Hopper (sm_90a).
//
// K2 `grad_fwd` replaces raytracing_rust_tpu/ops/pallas_grad.py
// `_fwd_kernel` (its pallas_call in `_make_traced`); K3 `grad_bwd` replaces
// `_bwd_kernel` (the second pallas_call there). Their plain version is
// `trace_tiles_plain` in ops/grad.py, a torch twin of `_trace_tiles`, and
// torch autograd through it is K3's. Scope: spheres and rects from the
// per-prim record f32[P, 35] (ops/grad.py C_*), lambertian and
// diffuse-light materials, solid textures, the black background.
//
// Layout: one thread per lane; rays o, d f32[3, N], draws u
// f32[n_bounce, 4, N] and radiance f32[3, N] are lane-major, so a warp reads
// and writes 128 contiguous bytes per row. The record sits in shared memory
// (at most 64 x 35 f32 = 8.75 KB); every lane of a warp walks the same
// prims, so each record read is a broadcast and the sphere/rect branch on
// C_IS_SPHERE is uniform across the warp. The prim loop and the bounce loop
// run at runtime (n_prims, n_bounce, max_depth are arguments).
//
// What bounds them on this card: f32 issue in the closest-hit loop and
// warp divergence (a warp runs until its longest path ends), not bytes:
// per lane K2 reads 6 + 4·n_bounce floats and writes 3.
//
// The adjoint (K3). In this scope the radiance is
//     rad = sum_b  alive_b · hit_b · light_b · thr_b · albedo_b
// where every factor but alive and thr is a record value picked by the
// bounce's winner, and hit, keep and the winner come from comparisons.
// o, d and the geometric columns reach the radiance only through those
// comparisons, so their exact cotangent is zero (jax.vjp of _trace_tiles
// gives the same zeros; tests/test_torch_grad.py holds it): K3 writes
// d_o = d_d = 0 and carries the color chain only. It replays the forward
// and keeps a per-lane tape (winner, throughput, alive) of each bounce, then
// sweeps the bounces in reverse with the masks that carry gradient: alive,
// the light column both as emission gain and as ok = 1 − light, and
// cont = gain · ok. Each bounce adds into one row of d_rec, its winner's:
// lanes of a warp with the same winner are summed by shuffles, then one
// lane adds the sum to the block's shared-memory d_rec; each block writes
// its partial d_rec[blockIdx] and torch sums the partials. The replay stops
// one bounce after a path dies (the "ghost" bounce): a dead path re-hits the
// same prim, whose light column (1 for a light, 0 else) zeroes every later
// cotangent, so the sweep is exact.
//
// Numerics: no fast math, -fmad=false, every f32 expression in the twin's
// (the JAX kernel's) order, so K2 agrees with the twin path by path; the
// float atomics make K3's sums differ from autograd's in order only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// record columns (ops/grad.py C_*)
constexpr int C_IS_SPHERE = 0, C_CX = 1, C_R2 = 4, C_KN = 6, C_AN = 9,
              C_BN = 12, C_KOFF = 15, C_AOFF = 16, C_BOFF = 17, C_A0 = 18,
              C_A1 = 19, C_B0 = 20, C_B1 = 21, C_FLIP = 22, C_INVR = 5,
              C_LIGHT = 26, C_TEX_E = 28, REC_C = 35;
constexpr int MAX_PRIMS = 64;        // ops/grad.py MAX_PRIMS
constexpr int MAX_BOUNCE = 17;       // ops/grad.py MAX_DEPTH + 1
constexpr int THREADS = 128;         // ops/grad.py GRAD_THREADS
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr float BIG = 3.0e38f;
constexpr float T_MIN = 1e-3f;
constexpr float TWO_PI = 6.28318548202514648f;      // f32(2π), rng.TWO_PI
constexpr float ONE_THIRD = 0.333333343267440796f;  // f32(1/3), rng.ONE_THIRD

// Closest hit of ray (o, d) over the record: the first strict minimum of
// the prims' hit distances (pallas_grad.py:263-328). win = -1 on a miss.
__device__ __forceinline__ void closest_hit(const float* s_rec, int n_prims,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float& t_best, int& win) {
  const float a_dd = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a_dd;
  t_best = BIG;
  win = -1;
  for (int p = 0; p < n_prims; ++p) {
    const float* r = s_rec + p * REC_C;
    float t_p;
    if (r[C_IS_SPHERE] > 0.5f) {
      // sphere (reference src/sphere.rs:37-77), oc formed difference-first
      const float ocx = ox - r[C_CX], ocy = oy - r[C_CX + 1],
                  ocz = oz - r[C_CX + 2];
      const float bq = ocx * dx + ocy * dy + ocz * dz;
      const float cc = ocx * ocx + ocy * ocy + ocz * ocz - r[C_R2];
      const float disc = bq * bq - a_dd * cc;
      const bool pos = disc > 0.0f;
      const float sq = sqrtf(pos ? disc : 1.0f);
      const float t_near = (-bq - sq) * inv_a;
      const float t_far = (-bq + sq) * inv_a;
      const bool near_ok = pos && t_near > T_MIN && t_near < BIG;
      const bool far_ok = pos && t_far > T_MIN && t_far < BIG;
      t_p = near_ok ? t_near : (far_ok ? t_far : BIG);
    } else {
      // rect in its world frame (reference src/rect.rs:39-69)
      const float kx = r[C_KN], ky = r[C_KN + 1], kz = r[C_KN + 2];
      const float o_kn = ox * kx + oy * ky + oz * kz;
      const float d_kn = dx * kx + dy * ky + dz * kz;
      const bool par = d_kn == 0.0f;
      const float t_r = (r[C_KOFF] - o_kn) / (par ? 1.0f : d_kn);
      const float xx = ox * r[C_AN] + oy * r[C_AN + 1] + oz * r[C_AN + 2] +
                       t_r * (dx * r[C_AN] + dy * r[C_AN + 1] +
                              dz * r[C_AN + 2]) -
                       r[C_AOFF];
      const float yy = ox * r[C_BN] + oy * r[C_BN + 1] + oz * r[C_BN + 2] +
                       t_r * (dx * r[C_BN] + dy * r[C_BN + 1] +
                              dz * r[C_BN + 2]) -
                       r[C_BOFF];
      const bool ok = !par && t_r > T_MIN && t_r < BIG && xx >= r[C_A0] &&
                      xx <= r[C_A1] && yy >= r[C_B0] && yy <= r[C_B1];
      t_p = ok ? t_r : BIG;
    }
    if (t_p < t_best) {
      t_best = t_p;
      win = p;
    }
  }
}

// One bounce's state change after the hit test: the hit point, the
// winner's normal × flip, and the lambertian direction n + a point in the
// unit ball (reference src/material.rs:49-53; radius exp(log(1 − u)/3)).
// Writes the next origin and direction into o, d.
__device__ __forceinline__ void scatter(const float* w, float t_best,
                                        const float* u, size_t stride,
                                        float& ox, float& oy, float& oz,
                                        float& dx, float& dy, float& dz) {
  const float px = ox + t_best * dx, py = oy + t_best * dy,
              pz = oz + t_best * dz;
  const float flip = w[C_FLIP];
  float nx, ny, nz;
  if (w[C_IS_SPHERE] > 0.5f) {
    nx = (px - w[C_CX]) * w[C_INVR] * flip;
    ny = (py - w[C_CX + 1]) * w[C_INVR] * flip;
    nz = (pz - w[C_CX + 2]) * w[C_INVR] * flip;
  } else {
    nx = w[C_KN] * flip;
    ny = w[C_KN + 1] * flip;
    nz = w[C_KN + 2] * flip;
  }
  const float cos_t = 2.0f * u[0] - 1.0f;
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  const float phi = TWO_PI * u[stride];
  const float rr3 = expf(logf(1.0f - u[2 * stride]) * ONE_THIRD);
  ox = px;
  oy = py;
  oz = pz;
  dx = nx + rr3 * sin_t * cosf(phi);
  dy = ny + rr3 * sin_t * sinf(phi);
  dz = nz + rr3 * cos_t;
}

__device__ __forceinline__ void load_record(float* s_rec, const float* rec,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_rec[i] = rec[i];
}

__global__ void __launch_bounds__(THREADS)
grad_fwd(const float* __restrict__ rec, int n_prims,
         const float* __restrict__ o, const float* __restrict__ d,
         const float* __restrict__ u, float* __restrict__ rad, int n,
         int n_bounce, int max_depth, int has_light) {
  extern __shared__ float s_rec[];
  load_record(s_rec, rec, n_prims * REC_C);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
  float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  float alive = 1.0f;
  for (int b = 0; b < n_bounce; ++b) {
    // a dead path adds gain · ... = +0 at every later bounce and never
    // revives (alive' = alive · hit · ok): stopping leaves rad bit-equal
    if (alive == 0.0f) break;
    float t_best;
    int win;
    closest_hit(s_rec, n_prims, ox, oy, oz, dx, dy, dz, t_best, win);
    if (win < 0) break;  // a miss adds nothing on black, and dies
    const float* w = s_rec + win * REC_C;
    const float wl = has_light ? w[C_LIGHT] : 0.0f;
    const float gain = alive * 1.0f;
    if (has_light) {
      // emitted on every hit (reference src/color.rs:8-15)
      const float gl = gain * wl;
      rad_r = rad_r + gl * thr_r * w[C_TEX_E];
      rad_g = rad_g + gl * thr_g * w[C_TEX_E + 1];
      rad_b = rad_b + gl * thr_b * w[C_TEX_E + 2];
    }
    if (b == max_depth) break;  // the final bounce only collects
    const float cont = gain * (1.0f - wl);  // a light never scatters
    if (cont > 0.5f) {
      thr_r = thr_r * w[C_TEX_E];
      thr_g = thr_g * w[C_TEX_E + 1];
      thr_b = thr_b * w[C_TEX_E + 2];
      scatter(w, t_best, u + (size_t)b * 4 * n + i, (size_t)n, ox, oy, oz,
              dx, dy, dz);
    }
    alive = cont;
  }
  rad[i] = rad_r;
  rad[n + i] = rad_g;
  rad[2 * n + i] = rad_b;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

__global__ void __launch_bounds__(THREADS)
grad_bwd(const float* __restrict__ rec, int n_prims,
         const float* __restrict__ o, const float* __restrict__ d,
         const float* __restrict__ u, const float* __restrict__ ct,
         float* __restrict__ d_o, float* __restrict__ d_d,
         float* __restrict__ d_rec, int n, int n_bounce, int max_depth,
         int has_light) {
  extern __shared__ float smem[];
  float* s_rec = smem;
  float* s_drec = smem + n_prims * REC_C;
  load_record(s_rec, rec, n_prims * REC_C);
  for (int k = threadIdx.x; k < n_prims * REC_C; k += blockDim.x)
    s_drec[k] = 0.0f;
  __syncthreads();

  // every thread of the block stays to the end: the warp shuffles below
  // need all 32 lanes, and the block's partial needs every warp
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const int lane = threadIdx.x & 31;

  // -- forward replay, keeping the tape of each bounce
  int t_win[MAX_BOUNCE];
  float t_thr[MAX_BOUNCE][3], t_alive[MAX_BOUNCE];
  int n_rep = 0;
  float ct_r = 0.0f, ct_g = 0.0f, ct_b = 0.0f;
  if (valid) {
    ct_r = ct[i];
    ct_g = ct[n + i];
    ct_b = ct[2 * n + i];
    float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    float alive = 1.0f;
    for (int b = 0; b < n_bounce; ++b) {
      const bool ghost = alive == 0.0f;
      float t_best;
      int win;
      closest_hit(s_rec, n_prims, ox, oy, oz, dx, dy, dz, t_best, win);
      t_win[b] = win;
      t_thr[b][0] = thr_r;
      t_thr[b][1] = thr_g;
      t_thr[b][2] = thr_b;
      t_alive[b] = alive;
      n_rep = b + 1;
      if (ghost || b == max_depth) break;
      float cont = 0.0f;
      if (win >= 0) {
        const float* w = s_rec + win * REC_C;
        const float ok = has_light ? 1.0f - w[C_LIGHT] : 1.0f;
        cont = alive * 1.0f * ok;
        if (cont > 0.5f) {
          thr_r = thr_r * w[C_TEX_E];
          thr_g = thr_g * w[C_TEX_E + 1];
          thr_b = thr_b * w[C_TEX_E + 2];
          scatter(w, t_best, u + (size_t)b * 4 * n + i, (size_t)n, ox, oy,
                  oz, dx, dy, dz);
        }
      }
      alive = cont;
    }
  }

  // -- reverse sweep over the bounces, warp-uniform so the shuffles see
  // every lane; a lane past its own tape adds zeros
  const int n_max = __reduce_max_sync(FULL, n_rep);
  float g_thr_r = 0.0f, g_thr_g = 0.0f, g_thr_b = 0.0f, g_alive = 0.0f;
  for (int b = n_max - 1; b >= 0; --b) {
    int key = -1;
    float v_light = 0.0f, v_r = 0.0f, v_g = 0.0f, v_b = 0.0f;
    if (b < n_rep) {
      const int win = t_win[b];
      const float thr_r = t_thr[b][0], thr_g = t_thr[b][1],
                  thr_b = t_thr[b][2];
      const float alive = t_alive[b];
      const bool hit = win >= 0;
      const float* w = s_rec + (hit ? win : 0) * REC_C;
      const float al_r = hit ? w[C_TEX_E] : 0.0f;
      const float al_g = hit ? w[C_TEX_E + 1] : 0.0f;
      const float al_b = hit ? w[C_TEX_E + 2] : 0.0f;
      const float wl = (has_light && hit) ? w[C_LIGHT] : 0.0f;
      const float hitf = hit ? 1.0f : 0.0f;
      const float gain = alive * hitf;
      float n_thr_r, n_thr_g, n_thr_b;
      float g_gain = 0.0f, g_wl = 0.0f;
      if (b < max_depth) {
        // thr' = keep ? thr · albedo : thr;  alive' = cont = gain · ok
        const float ok = has_light ? 1.0f - wl : 1.0f;
        const float cont = gain * ok;
        if (cont > 0.5f) {
          n_thr_r = g_thr_r * al_r;
          n_thr_g = g_thr_g * al_g;
          n_thr_b = g_thr_b * al_b;
          v_r = g_thr_r * thr_r;
          v_g = g_thr_g * thr_g;
          v_b = g_thr_b * thr_b;
        } else {
          n_thr_r = g_thr_r;
          n_thr_g = g_thr_g;
          n_thr_b = g_thr_b;
        }
        g_gain = g_alive * ok;
        if (has_light) g_wl = -(g_alive * gain);
      } else {
        n_thr_r = n_thr_g = n_thr_b = 0.0f;
      }
      if (has_light) {
        // rad += (gl · thr) · albedo, gl = gain · light
        const float gl = gain * wl;
        const float a_r = ct_r * al_r, a_g = ct_g * al_g, a_b = ct_b * al_b;
        const float g_gl = a_r * thr_r + a_g * thr_g + a_b * thr_b;
        n_thr_r = n_thr_r + a_r * gl;
        n_thr_g = n_thr_g + a_g * gl;
        n_thr_b = n_thr_b + a_b * gl;
        v_r = v_r + ct_r * (gl * thr_r);
        v_g = v_g + ct_g * (gl * thr_g);
        v_b = v_b + ct_b * (gl * thr_b);
        g_gain = g_gain + g_gl * wl;
        g_wl = g_wl + g_gl * gain;
      }
      v_light = g_wl;
      g_alive = g_gain * hitf;  // gain = alive · hit
      g_thr_r = n_thr_r;
      g_thr_g = n_thr_g;
      g_thr_b = n_thr_b;
      key = hit ? win : -1;
    }
    // one shared-memory add per (winner, column) per warp
    unsigned todo = __ballot_sync(FULL, key >= 0);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const int wk = __shfl_sync(FULL, key, leader);
      const bool mine = key == wk;
      const float s_l = warp_sum(mine ? v_light : 0.0f);
      const float s_r = warp_sum(mine ? v_r : 0.0f);
      const float s_g = warp_sum(mine ? v_g : 0.0f);
      const float s_b = warp_sum(mine ? v_b : 0.0f);
      if (lane == leader) {
        float* row = s_drec + wk * REC_C;
        atomicAdd(row + C_LIGHT, s_l);
        atomicAdd(row + C_TEX_E, s_r);
        atomicAdd(row + C_TEX_E + 1, s_g);
        atomicAdd(row + C_TEX_E + 2, s_b);
      }
      todo &= ~__ballot_sync(FULL, mine);
    }
  }

  if (valid) {
    // geometry reaches the radiance only through comparisons: exact zeros
    for (int c = 0; c < 3; ++c) {
      d_o[c * n + i] = 0.0f;
      d_d[c * n + i] = 0.0f;
    }
  }
  __syncthreads();
  float* out = d_rec + (size_t)blockIdx.x * n_prims * REC_C;
  for (int k = threadIdx.x; k < n_prims * REC_C; k += blockDim.x)
    out[k] = s_drec[k];
}

}  // namespace

// K2: radiance rad f32[3, n] of rays o, d f32[3, n] under draws u
// f32[n_bounce, 4, n]. Launches on `stream`; returns cudaGetLastError().
extern "C" int rt_grad_fwd(const float* rec, int n_prims, const float* o,
                           const float* d, const float* u, float* rad, int n,
                           int n_bounce, int max_depth, int has_light,
                           void* stream) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n <= 0 || n_bounce <= 0 ||
      n_bounce > MAX_BOUNCE || max_depth < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  grad_fwd<<<blocks, THREADS, sizeof(float) * n_prims * REC_C,
             (cudaStream_t)stream>>>(rec, n_prims, o, d, u, rad, n, n_bounce,
                                     max_depth, has_light);
  return (int)cudaGetLastError();
}

// K3: d_o, d_d f32[3, n] and per-block partials d_rec f32[nb, P, 35] of
// <ct, rad> for cotangent ct f32[3, n]; nb must be ceil(n / 128).
extern "C" int rt_grad_bwd(const float* rec, int n_prims, const float* o,
                           const float* d, const float* u, const float* ct,
                           float* d_o, float* d_d, float* d_rec, int n, int nb,
                           int n_bounce, int max_depth, int has_light,
                           void* stream) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS || n <= 0 || n_bounce <= 0 ||
      n_bounce > MAX_BOUNCE || max_depth < 0 ||
      nb != (n + THREADS - 1) / THREADS)
    return (int)cudaErrorInvalidValue;
  grad_bwd<<<nb, THREADS, 2 * sizeof(float) * n_prims * REC_C,
             (cudaStream_t)stream>>>(rec, n_prims, o, d, u, ct, d_o, d_d,
                                     d_rec, n, n_bounce, max_depth, has_light);
  return (int)cudaGetLastError();
}
