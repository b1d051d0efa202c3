// K1: the forward path-tracing megakernel for Hopper (sm_90a): its static
// section (K1a), its materials, checker and sky (K1b) and its dynamic
// sphere loop with moving spheres (the sphere half of K1e).
//
// Replaces raytracing_rust_tpu/ops/pallas_tracer.py `_make_kernel` (its
// body `kernel`, launched by `_trace_call`) for scenes of spheres, moving
// spheres and rects: camera raygen with sub-pixel jitter, a thin lens and
// a shutter time; closest hit over the unrolled spheres and rect
// plane-frame groups, then over the dynamic sphere table in cluster order
// behind a per-leaf AABB cull, carrying only (t, winner) and resolving the
// winner's normal afterwards; emission; a black or sky background;
// lambertian, metal, dielectric and diffuse-light scatter with solid or
// 3-D checker albedo; the depth cap; per-pixel sums over the samples. The
// host side and the plain torch version of the same computation are in
// ops/tracer.py (`trace_plain`).
//
// The kernel is a template over three flags: K1B (any of sky, checker,
// metal, dielectric, moving spheres), DYN (a dynamic table) and LEAF_SMEM
// (its leaf table sits in shared memory). cornell_box runs the
// instantiation with all of them off, which is K1a as it was. Inside the
// K1B instantiations the five features are branches on the launch's
// feature bits, the same for every thread.
//
// What bounds it on this card: f32 ALU issue and warp divergence, not
// bytes. Each thread owns one pixel and carries its ray in registers
// through every sample and bounce. The unrolled record (P ≤ 96 rows × 46
// f32, 17.7 KB), its walk order, the camera record and, when they fit,
// the leaf AABBs sit in shared memory, where the lanes of a warp mostly
// read the same cell (a broadcast). The dynamic sphere table stays in
// device memory, read through the read-only cache, so its size is not
// capped by shared memory (the TPU kernel's ~2k-prim SMEM cap does not
// carry over); a leaf table too big for shared memory is read the same
// way. The leaf cull is a per-thread slab test against the thread's own
// best hit; the TPU kernel's lane-coherent supercluster level and its
// OR-tree have no counterpart here yet (a warp vote is later work).
// Paths end at different bounces and cross different leaves, so a warp
// runs until its longest path ends: this first version takes that cost.
//
// Numerics: no fast math, and compiled with -fmad=false, so every multiply
// and add rounds on its own, as torch's elementwise ops do; each f32
// expression is written in trace_plain's order, and the two agree path by
// path. 1/sqrt is written as a division (rsqrtf is not correctly
// rounded). No tensor cores are touched (TF32 would round geometry).
//
// Random numbers: Philox4x32-10, key = seed, counter = (pixel, sample,
// bounce, stream); ops/rng.py documents which word feeds which draw.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// record columns (ops/tracer.py R_*)
constexpr int R_C0 = 1, R_DC = 4, R_T0 = 7, R_INV_DT = 8, R_RADIUS = 9,
              R_R2 = 10, R_KN = 11, R_AN = 14, R_BN = 17, R_KOFF = 20,
              R_AOFF = 21, R_BOFF = 22, R_A0 = 23, R_A1 = 24, R_B0 = 25,
              R_B1 = 26, R_FLIP = 27, R_MAT = 28, R_PARAM = 29, R_EMIT = 30,
              R_ALB = 33, R_ALB_ODD = 36, R_CHECKER = 39, REC = 46;
// camera columns (ops/tracer.py C_*)
constexpr int C_ORIGIN = 0, C_LL = 3, C_HORIZ = 6, C_VERT = 9, C_U = 12,
              C_V = 15, C_LENS_R = 18, C_TIME0 = 19, C_DTIME = 20,
              CAMREC = 21;
// cluster table row: lo3, hi3, first member, member count (ops/tracer.py
// CLUSW)
constexpr int CLUSW = 8;
// ops/tracer.py UNROLL_BUDGET
constexpr int MAX_PRIMS = 96;
constexpr int THREADS = 128;
// shared memory a launch gets without opting in; the leaf table goes there
// when it fits beside the record
constexpr size_t SMEM_BUDGET = 48 * 1024;

// ops/tracer.py FEAT_*
constexpr int FEAT_SKY = 1, FEAT_CHECKER = 2, FEAT_METAL = 4, FEAT_DIEL = 8,
              FEAT_MOVING = 16, FEAT_ALL = 31;

constexpr float BIG = 3.0e38f;
constexpr float T_MIN = 1e-3f;
constexpr float MAT_METAL = 1.0f, MAT_DIELECTRIC = 2.0f,
                MAT_DIFFUSE_LIGHT = 3.0f;
constexpr float TWO_PI = 6.28318548202514648f;      // f32(2π), rng.TWO_PI
constexpr float ONE_THIRD = 0.333333343267440796f;  // f32(1/3), rng.ONE_THIRD
constexpr float U24 = 5.9604644775390625e-08f;      // 2^-24

constexpr uint32_t STREAM_CAMERA = 0, STREAM_SCATTER = 1, STREAM_TIME = 2;

struct Uniforms { float x, y, z, w; };

__device__ __forceinline__ float u01(uint32_t bits) {
  return (float)(bits >> 8) * U24;
}

// Philox4x32-10 (Salmon et al., SC 2011) → four uniforms in [0, 1).
__device__ __forceinline__ Uniforms philox(uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3,
                                           uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return {u01(c0), u01(c1), u01(c2), u01(c3)};
}

// A sphere's center at the ray's time (reference src/sphere.rs:115-118).
// For a static sphere (dc = 0, inv_dt = 0) the lerp returns c0 exactly, so
// one form serves both.
__device__ __forceinline__ void center(const float* r, bool moving,
                                       float time, float& cx, float& cy,
                                       float& cz) {
  cx = r[R_C0];
  cy = r[R_C0 + 1];
  cz = r[R_C0 + 2];
  if (moving) {
    const float frac = (time - r[R_T0]) * r[R_INV_DT];
    cx = cx + frac * r[R_DC];
    cy = cy + frac * r[R_DC + 1];
    cz = cz + frac * r[R_DC + 2];
  }
}

// Reciprocal direction for slab tests: an exact-zero component gets a
// huge signed inverse so a parallel ray outside a slab misses and one
// inside passes (pallas_tracer.py `_safe_inv`, 1368-1376).
__device__ __forceinline__ float safe_inv(float dc) {
  return fabsf(dc) < 1e-30f ? (dc >= 0.0f ? 1e30f : -1e30f) : 1.0f / dc;
}

template <bool K1B, bool DYN, bool LEAF_SMEM>
__global__ void __launch_bounds__(THREADS)
trace_k1(const float* __restrict__ rec, int n_rec,
         const int* __restrict__ walk, int n_walk,
         const float* __restrict__ dyn, int n_dyn,
         const float* __restrict__ leaves, int n_leaf,
         const float* __restrict__ cam, int feats,
         double* __restrict__ sums, int nx, int ny, uint32_t k0,
         uint32_t k1, int sample0, int n_samples, int max_depth) {
  // the scene's features; all off outside the K1B instantiations
  const bool sky = K1B && (feats & FEAT_SKY),
             checker = K1B && (feats & FEAT_CHECKER),
             metal = K1B && (feats & FEAT_METAL),
             diel = K1B && (feats & FEAT_DIEL),
             moving = K1B && (feats & FEAT_MOVING);
  // dynamic shared memory, sized by the launch: record, camera, leaves
  // (LEAF_SMEM), walk
  extern __shared__ float smem[];
  float* s_rec = smem;
  float* s_cam = s_rec + n_rec * REC;
  float* s_leaf = s_cam + CAMREC;
  int* s_walk = (int*)(s_leaf + (LEAF_SMEM ? n_leaf * CLUSW : 0));
  for (int i = threadIdx.x; i < n_rec * REC; i += blockDim.x)
    s_rec[i] = rec[i];
  for (int i = threadIdx.x; i < 2 * n_walk; i += blockDim.x)
    s_walk[i] = walk[i];
  for (int i = threadIdx.x; i < CAMREC; i += blockDim.x) s_cam[i] = cam[i];
  if (LEAF_SMEM)
    for (int i = threadIdx.x; i < n_leaf * CLUSW; i += blockDim.x)
      s_leaf[i] = leaves[i];
  __syncthreads();
  const float* leaf = LEAF_SMEM ? s_leaf : leaves;

  const int n_pix = nx * ny;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int* order = s_walk;
  const int* lead = s_walk + n_walk;
  // row 0 of the image is the top scanline (reference tests/test.rs:62-64)
  const float icol = (float)(pix % nx);
  const float jflip = (float)(ny - 1 - pix / nx);
  double acc_r = sums[pix], acc_g = sums[n_pix + pix],
         acc_b = sums[2 * n_pix + pix];

  for (int si = 0; si < n_samples; ++si) {
    const uint32_t sample = (uint32_t)(sample0 + si);
    // camera ray (reference src/camera.rs:53-67, jitter tests/test.rs:66-68)
    const Uniforms uc = philox(pix, sample, 0, STREAM_CAMERA, k0, k1);
    const float s = (icol + uc.x) / (float)nx;
    const float t = (jflip + uc.y) / (float)ny;
    const float lr = sqrtf(uc.z);
    const float phi = TWO_PI * uc.w;
    const float rdx = s_cam[C_LENS_R] * (lr * cosf(phi));
    const float rdy = s_cam[C_LENS_R] * (lr * sinf(phi));
    float ox = s_cam[C_ORIGIN] + (rdx * s_cam[C_U] + rdy * s_cam[C_V]);
    float oy = s_cam[C_ORIGIN + 1] +
               (rdx * s_cam[C_U + 1] + rdy * s_cam[C_V + 1]);
    float oz = s_cam[C_ORIGIN + 2] +
               (rdx * s_cam[C_U + 2] + rdy * s_cam[C_V + 2]);
    float dx = s_cam[C_LL] + s * s_cam[C_HORIZ] + t * s_cam[C_VERT] - ox;
    float dy = s_cam[C_LL + 1] + s * s_cam[C_HORIZ + 1] +
               t * s_cam[C_VERT + 1] - oy;
    float dz = s_cam[C_LL + 2] + s * s_cam[C_HORIZ + 2] +
               t * s_cam[C_VERT + 2] - oz;
    // shutter time (pallas_tracer.py:1583-1584)
    float time = 0.0f;
    if (moving)
      time = s_cam[C_TIME0] +
             philox(pix, sample, 0, STREAM_TIME, k0, k1).x * s_cam[C_DTIME];

    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
    for (int bounce = 0;; ++bounce) {
      const float a_dd = dx * dx + dy * dy + dz * dz;
      const float inv_a = 1.0f / a_dd;
      float t_best = BIG, nbx = 0.0f, nby = 0.0f, nbz = 0.0f;
      int win = -1;  // the unrolled winner's record row
      // the current rect group's ray·frame dot products
      int frame = -1;
      bool nonpar = false;
      float o_kn = 0.0f, inv_kn = 0.0f, o_an = 0.0f, d_an = 0.0f,
            o_bn = 0.0f, d_bn = 0.0f;
      for (int k = 0; k < n_walk; ++k) {
        const int p = order[k];
        const float* r = s_rec + p * REC;
        if (lead[k] < 0) {
          // sphere (reference src/sphere.rs:37-77): near root, then far
          float cx, cy, cz;
          center(r, moving, time, cx, cy, cz);
          const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
          const float bq = ocx * dx + ocy * dy + ocz * dz;
          const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r[R_R2];
          const float disc = bq * bq - a_dd * cq;
          if (disc > 0.0f) {
            const float sq = sqrtf(disc);
            const float t_near = (-bq - sq) * inv_a;
            const float t_far = (-bq + sq) * inv_a;
            const float t_p =
                (t_near > T_MIN && t_near < t_best)  ? t_near
                : (t_far > T_MIN && t_far < t_best) ? t_far
                                                     : BIG;
            if (t_p < t_best) {
              const float inv_r = 1.0f / r[R_RADIUS];
              const float flip = r[R_FLIP];
              t_best = t_p;
              win = p;
              nbx = ((ocx + t_p * dx) * inv_r) * flip;
              nby = ((ocy + t_p * dy) * inv_r) * flip;
              nbz = ((ocz + t_p * dz) * inv_r) * flip;
            }
          }
        } else {
          // rect in its group's world frame (reference src/rect.rs:39-69;
          // x = (o+td)·an expands to o·an + t·(d·an))
          const float* f = s_rec + lead[k] * REC;
          if (lead[k] != frame) {
            frame = lead[k];
            const float d_kn = dx * f[R_KN] + dy * f[R_KN + 1] +
                               dz * f[R_KN + 2];
            nonpar = d_kn != 0.0f;
            o_kn = ox * f[R_KN] + oy * f[R_KN + 1] + oz * f[R_KN + 2];
            inv_kn = 1.0f / (nonpar ? d_kn : 1.0f);
            o_an = ox * f[R_AN] + oy * f[R_AN + 1] + oz * f[R_AN + 2];
            d_an = dx * f[R_AN] + dy * f[R_AN + 1] + dz * f[R_AN + 2];
            o_bn = ox * f[R_BN] + oy * f[R_BN + 1] + oz * f[R_BN + 2];
            d_bn = dx * f[R_BN] + dy * f[R_BN + 1] + dz * f[R_BN + 2];
          }
          const float t_p = (r[R_KOFF] - o_kn) * inv_kn;
          const float xa = o_an + t_p * d_an - r[R_AOFF];
          const float yb = o_bn + t_p * d_bn - r[R_BOFF];
          if (nonpar && t_p > T_MIN && t_p < t_best && xa >= r[R_A0] &&
              xa <= r[R_A1] && yb >= r[R_B0] && yb <= r[R_B1]) {
            const float flip = r[R_FLIP];
            t_best = t_p;
            win = p;
            nbx = f[R_KN] * flip;
            nby = f[R_KN + 1] * flip;
            nbz = f[R_KN + 2] * flip;
          }
        }
      }

      const float* w_dyn = nullptr;  // the dynamic winner's row
      if (DYN) {
        // the dynamic sphere table in cluster order, carrying only
        // (t, winner) with its own root select (pallas_tracer.py:
        // 2034-2071); a leaf whose AABB the ray does not cross before its
        // best hit is skipped whole (`_slab`/`_clus_guard`, 1741-1776).
        // With no leaf table the members are scanned flat.
        float t_d = t_best;
        int wd = -1;
        const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
                    inv_dz = safe_inv(dz);
        const int n_groups = n_leaf > 0 ? n_leaf : 1;
        for (int c = 0; c < n_groups; ++c) {
          int start = 0, cnt = n_dyn;
          if (n_leaf > 0) {
            const float* L = leaf + c * CLUSW;
            float t0 = (L[0] - ox) * inv_dx, t1 = (L[3] - ox) * inv_dx;
            float tmn = fminf(t0, t1), tmx = fmaxf(t0, t1);
            t0 = (L[1] - oy) * inv_dy;
            t1 = (L[4] - oy) * inv_dy;
            tmn = fmaxf(tmn, fminf(t0, t1));
            tmx = fminf(tmx, fmaxf(t0, t1));
            t0 = (L[2] - oz) * inv_dz;
            t1 = (L[5] - oz) * inv_dz;
            tmn = fmaxf(tmn, fminf(t0, t1));
            tmx = fminf(tmx, fmaxf(t0, t1));
            if (!(tmx > fmaxf(tmn, T_MIN) && tmn < t_d)) continue;
            start = (int)L[6];
            cnt = (int)L[7];
          }
          for (int q = start; q < start + cnt; ++q) {
            const float* r = dyn + (size_t)q * REC;
            float cx = __ldg(r + R_C0), cy = __ldg(r + R_C0 + 1),
                  cz = __ldg(r + R_C0 + 2);
            if (moving) {
              const float frac =
                  (time - __ldg(r + R_T0)) * __ldg(r + R_INV_DT);
              cx = cx + frac * __ldg(r + R_DC);
              cy = cy + frac * __ldg(r + R_DC + 1);
              cz = cz + frac * __ldg(r + R_DC + 2);
            }
            const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
            const float bq = ocx * dx + ocy * dy + ocz * dz;
            const float cq =
                ocx * ocx + ocy * ocy + ocz * ocz - __ldg(r + R_R2);
            const float disc = bq * bq - a_dd * cq;
            if (disc > 0.0f) {
              const float sq = sqrtf(disc);
              const float t_near = (-bq - sq) * inv_a;
              const float t_far = (-bq + sq) * inv_a;
              const float t_sel = t_near > T_MIN ? t_near : t_far;
              if (t_sel > T_MIN && t_sel < t_d) {
                t_d = t_sel;
                wd = q;
              }
            }
          }
        }
        if (wd >= 0) {
          // winner resolve: normal (o + t·d − c(time))·inv_r, then the flip
          // (pallas_tracer.py:2097-2148)
          const float* r = dyn + (size_t)wd * REC;
          float cx, cy, cz;
          center(r, moving, time, cx, cy, cz);
          const float inv_r = 1.0f / r[R_RADIUS];
          const float flip = r[R_FLIP];
          nbx = (((ox + t_d * dx) - cx) * inv_r) * flip;
          nby = (((oy + t_d * dy) - cy) * inv_r) * flip;
          nbz = (((oz + t_d * dz) - cz) * inv_r) * flip;
          t_best = t_d;
          w_dyn = r;
        }
      }

      if (win < 0 && !(DYN && w_dyn != nullptr)) {
        // a miss adds the background and ends the path (reference
        // src/color.rs:14-22); black adds nothing
        if (sky) {
          const float inv_len = 1.0f / sqrtf(a_dd);
          const float ty = 0.5f * (dy * inv_len + 1.0f);
          rad_r += thr_r * (1.0f - 0.5f * ty);
          rad_g += thr_g * (1.0f - 0.3f * ty);
          rad_b += thr_b;
        }
        break;
      }
      // the winner's record row, in shared (unrolled) or device (dynamic)
      // memory
      const float* w = DYN && w_dyn != nullptr ? w_dyn : s_rec + win * REC;
      // emission (reference src/color.rs:8-22)
      rad_r += thr_r * w[R_EMIT];
      rad_g += thr_g * w[R_EMIT + 1];
      rad_b += thr_b * w[R_EMIT + 2];
      // a light does not scatter; scatter only below the depth cap
      // (src/color.rs:9)
      const float mat = w[R_MAT];
      if (mat == MAT_DIFFUSE_LIGHT || bounce >= max_depth) break;
      const float px = ox + t_best * dx, py = oy + t_best * dy,
                  pz = oz + t_best * dz;
      // lambertian: n + a uniform point in the unit ball
      // (reference src/material.rs:49-53; ops/rng.in_unit_sphere)
      const Uniforms us =
          philox(pix, sample, (uint32_t)bounce, STREAM_SCATTER, k0, k1);
      const float cos_t = 2.0f * us.x - 1.0f;
      const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      const float sphi = TWO_PI * us.y;
      const float ball_r = powf(1.0f - us.z, ONE_THIRD);
      const float bx = ball_r * (sin_t * cosf(sphi));
      const float by = ball_r * (sin_t * sinf(sphi));
      const float bz = ball_r * cos_t;
      float ndx = nbx + bx, ndy = nby + by, ndz = nbz + bz;
      if (metal && mat == MAT_METAL) {
        // reflect(unit(d), n) + fuzz·ball; the path ends when that points
        // into the surface (reference src/material.rs:76-87)
        const float inv_len = 1.0f / sqrtf(a_dd);
        const float udx = dx * inv_len, udy = dy * inv_len,
                    udz = dz * inv_len;
        const float ddn_u = udx * nbx + udy * nby + udz * nbz;
        const float par = w[R_PARAM];
        ndx = udx - 2.0f * ddn_u * nbx + par * bx;
        ndy = udy - 2.0f * ddn_u * nby + par * by;
        ndz = udz - 2.0f * ddn_u * nbz + par * bz;
        if (!(ndx * nbx + ndy * nby + ndz * nbz > 0.0f)) break;
      }
      if (diel && mat == MAT_DIELECTRIC) {
        // dielectric with Schlick's reflect-or-refract draw (scatter word
        // 3), the reference's exit cosine ref_idx·(d·n)/|d| included
        // (reference src/material.rs:105-126)
        const float inv_len = 1.0f / sqrtf(a_dd);
        const float udx = dx * inv_len, udy = dy * inv_len,
                    udz = dz * inv_len;
        const float par = w[R_PARAM];
        const float ddn = dx * nbx + dy * nby + dz * nbz;
        const float d_len = sqrtf(a_dd);
        const bool exiting = ddn > 0.0f;
        const float sgn = exiting ? -1.0f : 1.0f;
        const float onx = sgn * nbx, ony = sgn * nby, onz = sgn * nbz;
        const float eta = exiting ? par : 1.0f / par;
        const float cosine = exiting ? par * ddn / d_len : -ddn / d_len;
        const float dt_u = udx * onx + udy * ony + udz * onz;
        const float disc_r = 1.0f - eta * eta * (1.0f - dt_u * dt_u);
        bool refract = false;
        if (disc_r > 0.0f) {
          float r0 = (1.0f - par) / (1.0f + par);
          r0 = r0 * r0;
          const float one_c = 1.0f - cosine;
          const float one_c2 = one_c * one_c;
          const float schlick = r0 + (1.0f - r0) * one_c2 * one_c2 * one_c;
          refract = us.w >= schlick;
        }
        if (refract) {
          const float sq_r = sqrtf(disc_r);
          ndx = eta * (udx - onx * dt_u) - onx * sq_r;
          ndy = eta * (udy - ony * dt_u) - ony * sq_r;
          ndz = eta * (udz - onz * dt_u) - onz * sq_r;
        } else {
          ndx = dx - 2.0f * ddn * nbx;
          ndy = dy - 2.0f * ddn * nby;
          ndz = dz - 2.0f * ddn * nbz;
        }
      }
      float alb_r = w[R_ALB], alb_g = w[R_ALB + 1], alb_b = w[R_ALB + 2];
      if (checker && w[R_CHECKER] > 0.0f) {
        // checker sign at the hit point (reference src/texture.rs:40-47)
        const float sines =
            sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
        if (sines < 0.0f) {
          alb_r = w[R_ALB_ODD];
          alb_g = w[R_ALB_ODD + 1];
          alb_b = w[R_ALB_ODD + 2];
        }
      }
      if (diel && mat == MAT_DIELECTRIC) alb_r = alb_g = alb_b = 1.0f;
      ox = px;
      oy = py;
      oz = pz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
      thr_r = thr_r * alb_r;
      thr_g = thr_g * alb_g;
      thr_b = thr_b * alb_b;
    }
    acc_r += (double)rad_r;
    acc_g += (double)rad_g;
    acc_b += (double)rad_b;
  }
  sums[pix] = acc_r;
  sums[n_pix + pix] = acc_g;
  sums[2 * n_pix + pix] = acc_b;
}

using TraceFn = void (*)(const float*, int, const int*, int, const float*,
                         int, const float*, int, const float*, int, double*,
                         int, int, uint32_t, uint32_t, int, int, int);

// the instantiations, indexed [K1B][DYN][LEAF_SMEM]; without a dynamic
// table there is no leaf table
const TraceFn KERNELS[2][2][2] = {
    {{trace_k1<false, false, false>, trace_k1<false, false, false>},
     {trace_k1<false, true, false>, trace_k1<false, true, true>}},
    {{trace_k1<true, false, false>, trace_k1<true, false, false>},
     {trace_k1<true, true, false>, trace_k1<true, true, true>}}};

}  // namespace

// Adds the radiance of samples [sample0, sample0 + n_samples) of every
// pixel to sums (f64[3, nx·ny]). feats: ops/tracer.py FEAT_* bits.
// n_leaf = 0 scans the dynamic table without the cull. Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int rt_trace_k1(const float* rec, int n_rec, const int* walk,
                           int n_walk, const float* dyn, int n_dyn,
                           const float* leaves, int n_leaf, const float* cam,
                           int feats, double* sums, int nx, int ny,
                           uint32_t seed_lo, uint32_t seed_hi, int sample0,
                           int n_samples, int max_depth, void* stream) {
  if (n_rec <= 0 || n_rec > MAX_PRIMS || n_walk < 0 || n_walk > n_rec ||
      n_dyn < 0 || n_leaf < 0 || feats < 0 || feats > FEAT_ALL)
    return (int)cudaErrorInvalidValue;
  if (n_dyn == 0) n_leaf = 0;
  const size_t base =
      sizeof(float) * (n_rec * REC + CAMREC) + sizeof(int) * 2 * n_walk;
  const size_t leaf_bytes = sizeof(float) * (size_t)n_leaf * CLUSW;
  const bool leaf_smem = n_leaf > 0 && base + leaf_bytes <= SMEM_BUDGET;
  const size_t smem = base + (leaf_smem ? leaf_bytes : 0);
  const int n_pix = nx * ny;
  const int blocks = (n_pix + THREADS - 1) / THREADS;
  KERNELS[feats != 0][n_dyn > 0][leaf_smem]<<<blocks, THREADS, smem,
                                              (cudaStream_t)stream>>>(
      rec, n_rec, walk, n_walk, dyn, n_dyn, leaves, n_leaf, cam, feats, sums,
      nx, ny, seed_lo, seed_hi, sample0, n_samples, max_depth);
  return (int)cudaGetLastError();
}
