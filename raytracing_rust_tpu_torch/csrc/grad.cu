// K2 and K3: the fused differentiable trace, forward and backward, for
// Hopper (sm_90a).
//
// K2 `grad_fwd` replaces raytracing_rust_tpu/ops/pallas_grad.py
// `_fwd_kernel` (its pallas_call in `_make_traced`); K3 `grad_bwd` replaces
// `_bwd_kernel` (the second pallas_call there). Their plain version is
// `trace_tiles_plain` in ops/grad.py, a torch twin of `_trace_tiles`, and
// torch autograd through it is K3's. Scope, the JAX tier's whole
// (`supports_fast_grad`): spheres and rects from the per-prim record
// f32[P, 35] (ops/grad.py C_*), lambertian, metal (fuzz), dielectric and
// diffuse-light materials, solid and 3-D checker textures (an emissive
// checker too), the black background or the sky. The families are
// launch-uniform flags (has_light, has_sky, has_metal, has_diel,
// has_checker): a branch runs only under its flag, so a scene without a
// family runs none of its code. Each kernel is also a template on MAT (any
// of metal, glass, the checker), which compiles their code out of the
// instantiation the two inverse renders run (with one kernel for every
// family the default inverse render's K3 ran 24% slower on an H100: 69
// registers against 56, fewer resident warps).
//
// Layout: one thread per lane; rays o, d and radiance f32[N, 3] row-major
// as the caller holds them (a warp's 32 lanes read 384 contiguous bytes a
// tensor), draws u f32[n_bounce, 4, N] and the winner tape i32[n_bounce, 2,
// N] lane-major. The record sits in shared memory (at most 64 x 35 f32 =
// 8.75 KB); every lane of a warp walks the same prims, so each record read
// is a broadcast and the sphere/rect branch on C_IS_SPHERE is uniform
// across the warp. The prim loop and the bounce loop run at runtime
// (n_prims, n_bounce, max_depth are arguments).
//
// One launch a call, on a grid of exactly the blocks that are resident at
// once (the occupancy query times the SMs, or fewer for a small call):
// K2's warps take 32-lane groups from a counter (the first group of a warp
// is its own index, so the counter is hit only by the groups beyond the
// grid's warps and by each warp's last poll), K3's blocks take 128-lane
// tiles the same way. A lane's result depends on its lane alone, so which
// warp traces it changes nothing. The last warp (block) to leave resets the
// counters, so the next launch finds them at zero. The other way to one
// wave, a grid of one block per 128 lanes at 16 blocks an SM, needs 32
// registers: on an H100 that build spilled 96-546 B in every kernel and
// ran K2 1.13-1.34× and K3 1.79-2.11× slower (PERF.md §6).
//
// What bounds them on this card: f32 issue in the closest-hit loop and
// warp divergence (a warp runs until its longest path ends), not bytes:
// per lane K2 reads o and d (6 floats), draw words 0-2 of u on each bounce
// that scatters off a lambertian or a metal or that a metal absorbs (the
// ball decides metal_ok), word 3 only on a glass scatter that can refract
// (Schlick's draw), and writes 3 floats, and when the forward needs a
// gradient the winner tape.
//
// The winner tape: K2 writes, for each bounce it runs, code = (winner <<
// 4) | take_refract << 3 | metal_ok << 2 | use_odd << 1 | far root (-1 on
// a miss) and t_best; and one entry more after a path dies (the "ghost"
// bounce, below): the dying ray's winner and t again, with only its
// use_odd and far bits, which is what tracing the unchanged ray once more
// gives. Entries past a lane's last are not written. K3 reads the tape and
// calls no closest_hit: it rebuilds each bounce's state (throughput,
// alive, and with the sky o and d) with `hit_bounce` on the tape's winner
// and t and the same draws, keeping it in a per-lane local tape (7.5-8% of
// the replaying K3's time on an H100, under the 10% that would move it),
// and then sweeps the bounces in reverse carrying the cotangents of the
// state (o, d, throughput, alive) from bounce b+1 back to bounce b:
//   * keep (cont = gain · ok_mat · (1 − light) > 0.5; ok_mat = metal_ok on
//     a metal, else 1): o' = p, d' = the scatter direction, thr' = thr ·
//     albedo (· 1 on glass: no albedo cotangent); otherwise o, d, thr pass
//     their cotangents through; cont feeds gain and the light column,
//     g_light = −g_alive' · gain · ok_mat;
//   * the checker: albedo = use_odd ? C_TEX_O : C_TEX_E, so the albedo and
//     emission cotangents go to that row; nothing goes through the sines;
//   * emission rad += (gain · light · thr) · albedo;
//   * sky, on a miss: rad += (alive · thr) · bg, bg = (1 − tt) + tt · (0.5,
//     0.7, 1), tt = 0.5 (dy · rsqrt(d·d) + 1): into alive, thr and all of d;
//   * the scatter direction (the geometric chain, under the sky):
//     lambertian n + ball into n; metal rf = u − 2(u·n)n + fuzz · s, u = d ·
//     rsqrt(d·d): C_PARAM += g_rf·s, g_u = g_rf − 2(g_rf·n)n, g_n −= 2((u·n)
//     g_rf + (g_rf·n)u), g_d += inv_len · g_u − inv_len³ (g_u·d) d; glass,
//     refracted (ni (u − on·uvdt) − on √disc, on = ±n by exiting, ni =
//     ref_idx or 1/ref_idx by exiting, uvdt = u·on, disc = 1 − ni²(1 −
//     uvdt²)): into C_PARAM through ni, into n through on and into d
//     through u; glass, reflected (d − 2(d·n)n of the unnormalised d): into
//     d and n;
//   * normal × flip: rect kn · flip; sphere (p − c) · invr · flip;
//   * the hit point p = o + t · d, and t of the winner's candidate only
//     (`where(better, ...)` transposes to the winner): a rect's
//     (koff − o·kn) / (d·kn), a sphere's root (−bq ∓ √disc) / (d·d), into
//     the record, o and d.
// Comparisons carry nothing: C_IS_SPHERE, the rect axes, offsets and
// bounds, the flag columns C_LAMB, C_METAL, C_DIEL, C_CHK, and the sines,
// metal_ok, exiting, can_refract and take_refract with all that feeds only
// them (Schlick, r0, the cosine, |d|) get exact zeros, as in JAX. Without
// the sky nothing reaches o or d: the geometric chain and the scatter
// adjoint carry exact zeros, fuzz and ref_idx get none, and K3 keeps no (o,
// d) tape.
// Each bounce adds into one row of d_rec, its winner's, only the columns
// the winner's kind and the launch's families can carry (a sphere 14:
// centre, r², 1/r, flip, light, the even and odd albedo, the material
// parameter; a rect 13: normal, offset, flip, light, albedo, parameter),
// each slot reduced only under its flag: lanes of a warp with the same
// winner are summed by shuffles, then one lane adds each sum to its warp's
// own shared-memory row, and the tile's partial is the four warps' rows
// added in warp order. d_rec is reduced inside the launch in a fixed
// order, so it is bit-identical from run to run: the tiles' partials in
// sets of `set_size` tiles (the block that finishes a set's last tile sums
// the set in tile order), then the sets in set order (the block that
// finishes the last set). d_o and d_d are written per lane. The rebuild
// stops one bounce after a path dies (the ghost bounce), and that is
// exact: a path that dies by a miss has gain = alive · hit = 0 at its last
// bounce, so no cotangent gets past it; a path that dies on a light
// re-traces the same ray into the same light (hit = 1, miss = 0), whose
// light column (ok = 0) zeroes every later cotangent; a path a metal
// absorbs (metal_ok = 0, cont = 0) re-traces the same ray into the same
// metal, which emits nothing, so every later gain, emission and alive
// cotangent is 0. Glass never kills a path (ok = 1).
//
// Numerics: no fast math, -fmad=false, every f32 expression in the twin's
// (the JAX kernel's) order, so K2 agrees with the twin path by path:
// Schlick's powers are the twin's multiplies (x · ((x·x)·(x·x)), q · q),
// because a rounding there flips take_refract. 1/|d| is rsqrtf, which is
// what torch.rsqrt computes on the card; the checker's sines are sinf, as
// torch.sin. K3's sums run in another order than autograd's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// record columns (ops/grad.py C_*)
constexpr int C_IS_SPHERE = 0, C_CX = 1, C_R2 = 4, C_KN = 6, C_AN = 9,
              C_BN = 12, C_KOFF = 15, C_AOFF = 16, C_BOFF = 17, C_A0 = 18,
              C_A1 = 19, C_B0 = 20, C_B1 = 21, C_FLIP = 22, C_INVR = 5,
              C_METAL = 24, C_DIEL = 25, C_LIGHT = 26, C_PARAM = 27,
              C_TEX_E = 28, C_TEX_O = 31, C_CHK = 34, REC_C = 35;
constexpr int MAX_PRIMS = 64;        // ops/grad.py MAX_PRIMS
constexpr int MAX_BOUNCE = 17;       // ops/grad.py MAX_DEPTH + 1
constexpr int THREADS = 128;         // ops/grad.py GRAD_THREADS
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr float BIG = 3.0e38f;
constexpr float T_MIN = 1e-3f;
constexpr float TWO_PI = 6.28318548202514648f;      // f32(2π), rng.TWO_PI
constexpr float ONE_THIRD = 0.333333343267440796f;  // f32(1/3), rng.ONE_THIRD

// the tape's bits beside the winner (t_win = winner << TAPE_SHIFT | bits)
constexpr int TAPE_FAR = 1, TAPE_ODD = 2, TAPE_METAL_OK = 4, TAPE_REFRACT = 8,
              TAPE_SHIFT = 4;

// The launch-uniform families of the scene (ops/grad.py fast_grad_config).
struct Feats {
  bool light, sky, metal, diel, checker;
};

// Closest hit of ray (o, d) over the record: the first strict minimum of
// the prims' hit distances (pallas_grad.py:263-328). win = -1 on a miss;
// far: a sphere winner's far root was taken.
__device__ __forceinline__ void closest_hit(const float* s_rec, int n_prims,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float& t_best, int& win,
                                            bool& far) {
  const float a_dd = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a_dd;
  t_best = BIG;
  win = -1;
  far = false;
  for (int p = 0; p < n_prims; ++p) {
    const float* r = s_rec + p * REC_C;
    float t_p;
    bool far_p = false;
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
      far_p = !near_ok && far_ok;
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
      far = far_p;
    }
  }
}

// The sky at a miss of direction d (pallas_grad.py:373-382): tt = 0.5 ·
// (dy / |d| + 1), bg = (1 − tt) + tt · (0.5, 0.7, 1.0).
__device__ __forceinline__ float sky_tt(float dx, float dy, float dz,
                                        float& inv_len) {
  const float a_dd = dx * dx + dy * dy + dz * dz;
  inv_len = rsqrtf(a_dd);
  return 0.5f * (dy * inv_len + 1.0f);
}

// The winner's normal × flip at hit point p (intersect.py:311-341):
// sphere (p − c) · invr · flip, rect kn · flip.
__device__ __forceinline__ void normal_at(const float* w, float px, float py,
                                          float pz, float& nx, float& ny,
                                          float& nz) {
  const float flip = w[C_FLIP];
  if (w[C_IS_SPHERE] > 0.5f) {
    nx = (px - w[C_CX]) * w[C_INVR] * flip;
    ny = (py - w[C_CX + 1]) * w[C_INVR] * flip;
    nz = (pz - w[C_CX + 2]) * w[C_INVR] * flip;
  } else {
    nx = w[C_KN] * flip;
    ny = w[C_KN + 1] * flip;
    nz = w[C_KN + 2] * flip;
  }
}

// The checker's pick at hit point p (pallas_grad.py:352-358, reference
// src/texture.rs:40-47): the odd color where sin(10x)·sin(10y)·sin(10z) < 0.
__device__ __forceinline__ bool use_odd(const float* w, float px, float py,
                                        float pz, const Feats& f) {
  if (!f.checker || !(w[C_CHK] > 0.5f)) return false;
  const float sines = sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
  return sines < 0.0f;
}

// A point in the unit ball from draw words 0-2 (radius exp(log(1 − u)/3)).
__device__ __forceinline__ void ball(const float* u, size_t stride,
                                     float& sx, float& sy, float& sz) {
  const float cos_t = 2.0f * u[0] - 1.0f;
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  const float phi = TWO_PI * u[stride];
  const float rr3 = expf(logf(1.0f - u[2 * stride]) * ONE_THIRD);
  sx = rr3 * sin_t * cosf(phi);
  sy = rr3 * sin_t * sinf(phi);
  sz = rr3 * cos_t;
}

// The scatter direction of a bounce that does not end on a light
// (pallas_grad.py:389-458; reference src/material.rs): lambertian n + ball,
// metal reflect(unit d) + fuzz · ball, glass refract or reflect by
// Schlick's draw (word 3). Returns ok_mat (0 where a metal absorbs) and
// sets the tape bits TAPE_METAL_OK and TAPE_REFRACT.
__device__ __forceinline__ float scatter_dir(
    const float* w, float dx, float dy, float dz, float nx, float ny,
    float nz, const float* u, size_t stride, const Feats& f, float& ndx,
    float& ndy, float& ndz, int& bits) {
  if (f.diel && w[C_DIEL] > 0.5f) {
    // dielectric (src/material.rs:105-126), the JAX double-wheres
    const float a_dd = dx * dx + dy * dy + dz * dz;
    const float inv_len = rsqrtf(a_dd);
    const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
    const float ref_idx = w[C_PARAM];
    const float ddn = dx * nx + dy * ny + dz * nz;
    const float d_len = sqrtf(a_dd);
    const bool exiting = ddn > 0.0f;
    const float sgn = exiting ? -1.0f : 1.0f;
    const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
    const float ni = exiting ? ref_idx : 1.0f / ref_idx;
    const float cosine = exiting ? ref_idx * ddn / d_len : -ddn / d_len;
    const float uvdt = ux * onx + uy * ony + uz * onz;
    const float disc = 1.0f - ni * ni * (1.0f - uvdt * uvdt);
    const bool can = disc > 0.0f;
    // Schlick: r0 = q·q, (1 − cos)^5 = x · ((x·x)·(x·x)) as lax.integer_pow
    const float q = (1.0f - ref_idx) / (1.0f + ref_idx);
    const float r0 = q * q;
    const float one_mc = 1.0f - cosine;
    const float x2 = one_mc * one_mc;
    const float schlick = r0 + (1.0f - r0) * (one_mc * (x2 * x2));
    const float reflect_prob = can ? schlick : 1.0f;
    if (can && u[3 * stride] >= reflect_prob) {
      const float sq = sqrtf(disc);
      ndx = ni * (ux - onx * uvdt) - onx * sq;
      ndy = ni * (uy - ony * uvdt) - ony * sq;
      ndz = ni * (uz - onz * uvdt) - onz * sq;
      bits |= TAPE_REFRACT;
    } else {
      ndx = dx - 2.0f * ddn * nx;
      ndy = dy - 2.0f * ddn * ny;
      ndz = dz - 2.0f * ddn * nz;
    }
    return 1.0f;
  }
  float sx, sy, sz;
  ball(u, stride, sx, sy, sz);
  if (f.metal && w[C_METAL] > 0.5f) {
    // metal (src/material.rs:76-87)
    const float a_dd = dx * dx + dy * dy + dz * dz;
    const float inv_len = rsqrtf(a_dd);
    const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
    const float udn = ux * nx + uy * ny + uz * nz;
    const float fuzz = w[C_PARAM];
    ndx = ux - 2.0f * udn * nx + fuzz * sx;
    ndy = uy - 2.0f * udn * ny + fuzz * sy;
    ndz = uz - 2.0f * udn * nz + fuzz * sz;
    const bool ok = ndx * nx + ndy * ny + ndz * nz > 0.0f;
    if (ok) bits |= TAPE_METAL_OK;
    return ok ? 1.0f : 0.0f;
  }
  // lambertian: n + ball (src/material.rs:49-53)
  ndx = nx + sx;
  ndy = ny + sy;
  ndz = nz + sz;
  return 1.0f;
}

// One bounce of the forward after a hit of winner w at t_best, shared by K2
// and K3's replay: the checker's pick, the emission into rad, and, unless
// the bounce is the last, the scatter. Updates the state in place and
// returns the tape bits (TAPE_ODD, TAPE_METAL_OK, TAPE_REFRACT).
__device__ __forceinline__ int hit_bounce(
    const float* w, float t_best, const float* u, size_t stride,
    const Feats& f, bool last, float& ox, float& oy, float& oz, float& dx,
    float& dy, float& dz, float& thr_r, float& thr_g, float& thr_b,
    float& rad_r, float& rad_g, float& rad_b, float& alive) {
  const float px = ox + t_best * dx, py = oy + t_best * dy,
              pz = oz + t_best * dz;
  int bits = use_odd(w, px, py, pz, f) ? TAPE_ODD : 0;
  const float* al = w + ((bits & TAPE_ODD) ? C_TEX_O : C_TEX_E);
  const float wl = f.light ? w[C_LIGHT] : 0.0f;
  const float gain = alive * 1.0f;
  if (f.light) {
    // emitted on every hit (reference src/color.rs:8-15)
    const float gl = gain * wl;
    rad_r = rad_r + gl * thr_r * al[0];
    rad_g = rad_g + gl * thr_g * al[1];
    rad_b = rad_b + gl * thr_b * al[2];
  }
  if (last) return bits;  // the final bounce only collects
  const float ok_light = f.light ? 1.0f - wl : 1.0f;  // a light never scatters
  float cont = 0.0f;
  if (gain * ok_light > 0.5f) {
    float nx, ny, nz, ndx, ndy, ndz;
    normal_at(w, px, py, pz, nx, ny, nz);
    const float ok_mat = scatter_dir(w, dx, dy, dz, nx, ny, nz, u, stride,
                                     f, ndx, ndy, ndz, bits);
    cont = gain * (ok_mat * ok_light);
    if (cont > 0.5f) {
      if (!(f.diel && w[C_DIEL] > 0.5f)) {  // glass attenuates by 1
        thr_r = thr_r * al[0];
        thr_g = thr_g * al[1];
        thr_b = thr_b * al[2];
      }
      ox = px;
      oy = py;
      oz = pz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
  }
  alive = cont;
  return bits;
}

__device__ __forceinline__ void load_record(float* s_rec, const float* rec,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_rec[i] = rec[i];
}

// The families an instantiation runs: MAT = false compiles metal, glass
// and the checker out of the kernels the scenes without them run (header).
template <bool MAT>
__device__ __forceinline__ Feats instantiated(const Feats& f) {
  return Feats{f.light, f.sky, MAT && f.metal, MAT && f.diel,
               MAT && f.checker};
}

// The winner tape's entry (code, t) of bounce b for lane i.
__device__ __forceinline__ void tape_put(int* tape, int n, int b, int i,
                                         int code, float t) {
  tape[(size_t)(2 * b) * n + i] = code;
  tape[(size_t)(2 * b + 1) * n + i] = __float_as_int(t);
}

// One lane of K2: radiance of ray (o, d) and, where tape is not null, the
// lane's winner tape (header).
template <bool MAT>
__device__ __forceinline__ void trace_lane(
    const float* s_rec, int n_prims, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ u,
    float* __restrict__ rad, int* __restrict__ tape, int n, int i,
    int n_bounce, int max_depth, const Feats& f) {
  float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  float alive = 1.0f;
  for (int b = 0; b < n_bounce; ++b) {
    // a dead path adds gain · ... = +0 at every later bounce and never
    // revives (alive' = alive · hit · ok): stopping leaves rad bit-equal
    if (alive == 0.0f) break;
    float t_best;
    int win;
    bool far;
    closest_hit(s_rec, n_prims, ox, oy, oz, dx, dy, dz, t_best, win, far);
    // the ghost entry after a death: K3 traces the dying ray once more
    const bool ghost_next = b < max_depth && b + 1 < n_bounce;
    if (win < 0) {
      // a miss adds the background (nothing on black) and dies
      if (f.sky) {
        float inv_len;
        const float tt = sky_tt(dx, dy, dz, inv_len);
        // miss = alive · (1 − hit) = alive
        rad_r = rad_r + alive * thr_r * ((1.0f - tt) + tt * 0.5f);
        rad_g = rad_g + alive * thr_g * ((1.0f - tt) + tt * 0.7f);
        rad_b = rad_b + alive * thr_b * ((1.0f - tt) + tt * 1.0f);
      }
      if (tape) {
        tape_put(tape, n, b, i, -1, t_best);
        if (ghost_next) tape_put(tape, n, b + 1, i, -1, t_best);
      }
      break;
    }
    const int bits = hit_bounce(
        s_rec + win * REC_C, t_best, u + (size_t)b * 4 * n + i, (size_t)n,
        f, b == max_depth, ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b,
        rad_r, rad_g, rad_b, alive);
    if (tape) {
      const int code = (win << TAPE_SHIFT) | bits | (far ? TAPE_FAR : 0);
      tape_put(tape, n, b, i, code, t_best);
      if (alive == 0.0f && ghost_next)
        tape_put(tape, n, b + 1, i, code & ~(TAPE_METAL_OK | TAPE_REFRACT),
                 t_best);
    }
    if (b == max_depth) break;
  }
  rad[3 * i] = rad_r;
  rad[3 * i + 1] = rad_g;
  rad[3 * i + 2] = rad_b;
}

// Counters of a launch in its workspace (ops/grad.py `_workspace`): K2's
// next group and warps gone, then K3's next tile, blocks gone, sets done
// and each set's tiles done. Every launch leaves them at zero.
constexpr int WS_K2_NEXT = 0, WS_K2_GONE = 1, WS_K3_NEXT = 2, WS_K3_GONE = 3,
              WS_K3_SETS = 4, WS_K3_SET0 = 5;

template <bool MAT>
__global__ void __launch_bounds__(THREADS)
grad_fwd(const float* __restrict__ rec, int n_prims,
         const float* __restrict__ o, const float* __restrict__ d,
         const float* __restrict__ u, float* __restrict__ rad,
         int* __restrict__ tape, int n, int n_bounce, int max_depth,
         Feats f_launch, int* ws) {
  const Feats f = instantiated<MAT>(f_launch);
  extern __shared__ float s_rec[];
  load_record(s_rec, rec, n_prims * REC_C);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (THREADS / 32);
  const int n_groups = (n + 31) / 32;
  // a warp's first group is its own index, the rest come from the counter
  int g = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  while (g < n_groups) {
    const int i = g * 32 + lane;
    if (i < n)
      trace_lane<MAT>(s_rec, n_prims, o, d, u, rad, tape, n, i, n_bounce,
                      max_depth, f);
    int next = 0;
    if (lane == 0) next = warps + atomicAdd(ws + WS_K2_NEXT, 1);
    g = __shfl_sync(FULL, next, 0);
  }
  if (lane == 0) {
    // every warp has polled past the end before it counts itself gone
    __threadfence();
    if (atomicAdd(ws + WS_K2_GONE, 1) == warps - 1) {
      atomicExch(ws + WS_K2_NEXT, 0);
      atomicExch(ws + WS_K2_GONE, 0);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

// The d_rec column of reduction slot j for a winner of kind sph: slots 0-2
// the centre (sphere) or plane normal (rect), 3 r² or the plane offset, 4
// 1/r (spheres only), 5 flip, 6 light, 7-9 the even albedo, 10 the material
// parameter (fuzz, ref_idx), 11-13 the odd albedo.
__device__ __forceinline__ int slot_col(bool sph, int j) {
  if (j < 3) return (sph ? C_CX : C_KN) + j;
  if (j == 3) return sph ? C_R2 : C_KOFF;
  if (j == 4) return C_INVR;
  if (j == 5) return C_FLIP;
  if (j == 6) return C_LIGHT;
  if (j < 10) return C_TEX_E + (j - 7);
  if (j == 10) return C_PARAM;
  return C_TEX_O + (j - 11);
}

constexpr int SLOTS = 14;

// The adjoint of the scatter direction of a kept bounce (header): from the
// direction's cotangent g_nd, the cotangents of the normal (g_n, set), of
// d (added to n_d), of |d|² (added to g_a_dd) and of the material
// parameter (returned).
__device__ __forceinline__ float scatter_adjoint(
    const float* w, int code, float dx, float dy, float dz, float a_dd,
    float nx, float ny, float nz, const float* u, size_t stride,
    const Feats& f, float g_ndx, float g_ndy, float g_ndz, float& g_nx,
    float& g_ny, float& g_nz, float& n_dx, float& n_dy, float& n_dz,
    float& g_a_dd) {
  const bool is_metal = f.metal && w[C_METAL] > 0.5f;
  const bool is_diel = f.diel && w[C_DIEL] > 0.5f;
  if (!is_metal && !is_diel) {  // n + ball
    g_nx = g_ndx;
    g_ny = g_ndy;
    g_nz = g_ndz;
    return 0.0f;
  }
  const float inv_len = rsqrtf(a_dd);
  const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
  float g_ux, g_uy, g_uz, g_par;
  if (is_metal) {
    // rf = u − 2(u·n)n + fuzz · s
    float sx, sy, sz;
    ball(u, stride, sx, sy, sz);
    g_par = g_ndx * sx + g_ndy * sy + g_ndz * sz;
    const float udn = ux * nx + uy * ny + uz * nz;
    const float gdn = g_ndx * nx + g_ndy * ny + g_ndz * nz;
    g_ux = g_ndx - 2.0f * gdn * nx;
    g_uy = g_ndy - 2.0f * gdn * ny;
    g_uz = g_ndz - 2.0f * gdn * nz;
    g_nx = -2.0f * (udn * g_ndx + gdn * ux);
    g_ny = -2.0f * (udn * g_ndy + gdn * uy);
    g_nz = -2.0f * (udn * g_ndz + gdn * uz);
  } else if (!(code & TAPE_REFRACT)) {
    // reflect of the unnormalised d: d − 2(d·n)n
    const float ddn = dx * nx + dy * ny + dz * nz;
    const float grn = g_ndx * nx + g_ndy * ny + g_ndz * nz;
    n_dx = n_dx + g_ndx - 2.0f * grn * nx;
    n_dy = n_dy + g_ndy - 2.0f * grn * ny;
    n_dz = n_dz + g_ndz - 2.0f * grn * nz;
    g_nx = -2.0f * (ddn * g_ndx + grn * dx);
    g_ny = -2.0f * (ddn * g_ndy + grn * dy);
    g_nz = -2.0f * (ddn * g_ndz + grn * dz);
    return 0.0f;
  } else {
    // refract: ni (u − on·uvdt) − on · √disc, on = sgn · n,
    // disc = 1 − ni²(1 − uvdt²), uvdt = u·on, ni = exiting ? ref : 1/ref
    const float ref_idx = w[C_PARAM];
    const bool exiting = dx * nx + dy * ny + dz * nz > 0.0f;
    const float sgn = exiting ? -1.0f : 1.0f;
    const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
    const float ni = exiting ? ref_idx : 1.0f / ref_idx;
    const float uvdt = ux * onx + uy * ony + uz * onz;
    const float one_m = 1.0f - uvdt * uvdt;
    const float sq = sqrtf(1.0f - ni * ni * one_m);
    const float vx = ux - onx * uvdt, vy = uy - ony * uvdt,
                vz = uz - onz * uvdt;
    const float g_vx = ni * g_ndx, g_vy = ni * g_ndy, g_vz = ni * g_ndz;
    const float g_disc =
        -(g_ndx * onx + g_ndy * ony + g_ndz * onz) * 0.5f / sq;
    const float g_ni = (g_ndx * vx + g_ndy * vy + g_ndz * vz) -
                       g_disc * 2.0f * ni * one_m;
    const float g_uvdt = -(g_vx * onx + g_vy * ony + g_vz * onz) +
                         g_disc * (ni * ni) * 2.0f * uvdt;
    g_ux = g_vx + g_uvdt * onx;
    g_uy = g_vy + g_uvdt * ony;
    g_uz = g_vz + g_uvdt * onz;
    g_nx = sgn * (-g_ndx * sq - g_vx * uvdt + g_uvdt * ux);
    g_ny = sgn * (-g_ndy * sq - g_vy * uvdt + g_uvdt * uy);
    g_nz = sgn * (-g_ndz * sq - g_vz * uvdt + g_uvdt * uz);
    g_par = exiting ? g_ni : -g_ni / (ref_idx * ref_idx);
  }
  // u = d · rsqrt(a_dd)
  n_dx = n_dx + inv_len * g_ux;
  n_dy = n_dy + inv_len * g_uy;
  n_dz = n_dz + inv_len * g_uz;
  g_a_dd = g_a_dd + (g_ux * dx + g_uy * dy + g_uz * dz) *
                        (-0.5f * inv_len * inv_len * inv_len);
  return g_par;
}

// The column of d_rec that reduction slot j feeds for a winner of kind sph
// (slot_col's inverse), or -1 for a column no slot feeds.
__device__ __forceinline__ int col_slot(bool sph, int c) {
  for (int j = 0; j < SLOTS; ++j) {
    if (j == 4 && !sph) continue;  // 1/r: spheres only
    if (slot_col(sph, j) == c) return j;
  }
  return -1;
}

// f.sky (launch-uniform, as in K2): without the sky nothing reaches o or d,
// no cotangent enters their chain, and it stays exactly zero: the rebuild
// keeps no (o, d) tape and the sweep only the color chain (d_o = d_d = 0).
// One kernel serves both backgrounds: a template with an instantiation per
// background (39 registers and 368 B of stack without the sky, against 55
// and 848 B) ran the default inverse render's K3 5% faster by the medians
// of ten alternating runs on an H100, inside the runs' spread.
//
// One 128-lane tile a block at a time (header); part holds each tile's
// partial row f32[P · SLOTS] and then each set's, set_size tiles a set.
template <bool MAT>
__global__ void __launch_bounds__(THREADS)
grad_bwd(const float* __restrict__ rec, int n_prims,
         const float* __restrict__ o, const float* __restrict__ d,
         const float* __restrict__ u, const int* __restrict__ tape,
         const float* __restrict__ ct, float* __restrict__ d_o,
         float* __restrict__ d_d, float* __restrict__ d_rec,
         float* __restrict__ part, int n, int n_bounce, int max_depth,
         Feats f_launch, int* ws, int set_size) {
  const Feats f = instantiated<MAT>(f_launch);
  const bool sky = f.sky;
  const int row_len = n_prims * SLOTS;
  extern __shared__ float smem[];
  float* s_rec = smem;
  float* s_rows = smem + n_prims * REC_C;  // one row a warp
  __shared__ int s_tile, s_last;
  load_record(s_rec, rec, n_prims * REC_C);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* my_row = s_rows + warp * row_len;
  const int n_tiles = (n + THREADS - 1) / THREADS;
  const int n_sets = (n_tiles + set_size - 1) / set_size;
  float* set_part = part + (size_t)n_tiles * row_len;

  // a block's first tile is its own index, the rest come from the counter
  int tile = blockIdx.x;
  while (tile < n_tiles) {
    for (int k = threadIdx.x; k < 4 * row_len; k += THREADS)
      s_rows[k] = 0.0f;
    __syncthreads();
    // every thread of the block stays to the end: the warp shuffles below
    // need all 32 lanes, and the tile's partial needs every warp
    const int i = tile * THREADS + threadIdx.x;
    const bool valid = i < n;

    // -- the forward rebuilt from the winner tape: per bounce the state
    // before it (throughput, alive, and with the sky o and d)
    float t_thr[MAX_BOUNCE][3], t_alive[MAX_BOUNCE];
    float t_o[MAX_BOUNCE][3], t_d[MAX_BOUNCE][3];
    int n_rep = 0;
    float ct_r = 0.0f, ct_g = 0.0f, ct_b = 0.0f;
    if (valid) {
      ct_r = ct[3 * i];
      ct_g = ct[3 * i + 1];
      ct_b = ct[3 * i + 2];
      float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
      float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
      float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
      float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
      float alive = 1.0f;
      for (int b = 0; b < n_bounce; ++b) {
        const bool ghost = alive == 0.0f;
        const int code = tape[(size_t)(2 * b) * n + i];
        t_thr[b][0] = thr_r;
        t_thr[b][1] = thr_g;
        t_thr[b][2] = thr_b;
        t_alive[b] = alive;
        if (sky) {
          t_o[b][0] = ox;
          t_o[b][1] = oy;
          t_o[b][2] = oz;
          t_d[b][0] = dx;
          t_d[b][1] = dy;
          t_d[b][2] = dz;
        }
        n_rep = b + 1;
        if (code >= 0) {
          // a ghost only re-reads the checker's pick: it scatters nothing
          // (the radiance the rebuild adds is unused)
          const float t_best =
              __int_as_float(tape[(size_t)(2 * b + 1) * n + i]);
          hit_bounce(s_rec + (code >> TAPE_SHIFT) * REC_C, t_best,
                     u + (size_t)b * 4 * n + i, (size_t)n, f,
                     ghost || b == max_depth, ox, oy, oz, dx, dy, dz, thr_r,
                     thr_g, thr_b, rad_r, rad_g, rad_b, alive);
        } else {
          alive = 0.0f;
        }
        if (ghost || b == max_depth) break;
      }
    }

    // -- reverse sweep over the bounces, warp-uniform so the shuffles see
    // every lane; a lane past its own tape adds zeros. g_* are the
    // cotangents of the state after the bounce being swept.
    const int n_max = __reduce_max_sync(FULL, n_rep);
    float g_ox = 0.0f, g_oy = 0.0f, g_oz = 0.0f;
    float g_dx = 0.0f, g_dy = 0.0f, g_dz = 0.0f;
    float g_thr_r = 0.0f, g_thr_g = 0.0f, g_thr_b = 0.0f, g_alive = 0.0f;
    for (int b = n_max - 1; b >= 0; --b) {
      int key = -1;
      float v[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) v[j] = 0.0f;
      if (b < n_rep) {
        const int code = tape[(size_t)(2 * b) * n + i];
        const bool hit = code >= 0;
        const int win = hit ? code >> TAPE_SHIFT : 0;
        const float* w = s_rec + win * REC_C;
        const bool odd = f.checker && hit && (code & TAPE_ODD);
        const bool is_metal = hit && f.metal && w[C_METAL] > 0.5f;
        const bool is_diel = hit && f.diel && w[C_DIEL] > 0.5f;
        const float thr_r = t_thr[b][0], thr_g = t_thr[b][1],
                    thr_b = t_thr[b][2];
        const float alive = t_alive[b];
        const float* alp = w + (odd ? C_TEX_O : C_TEX_E);
        const float al_r = hit ? alp[0] : 0.0f;
        const float al_g = hit ? alp[1] : 0.0f;
        const float al_b = hit ? alp[2] : 0.0f;
        const float wl = (f.light && hit) ? w[C_LIGHT] : 0.0f;
        const float hitf = hit ? 1.0f : 0.0f;
        const float gain = alive * hitf;
        // the cotangents of the state before this bounce (n_*), of the hit
        // point, the scatter direction and the winner's albedo and light
        float n_ox = 0.0f, n_oy = 0.0f, n_oz = 0.0f;
        float n_dx = 0.0f, n_dy = 0.0f, n_dz = 0.0f;
        float n_thr_r = 0.0f, n_thr_g = 0.0f, n_thr_b = 0.0f;
        float g_px = 0.0f, g_py = 0.0f, g_pz = 0.0f;
        float g_ndx = 0.0f, g_ndy = 0.0f, g_ndz = 0.0f;
        float g_al_r = 0.0f, g_al_g = 0.0f, g_al_b = 0.0f;
        float g_gain = 0.0f, g_wl = 0.0f;
        bool kept = false;
        if (b < max_depth) {
          // o' = keep ? p : o;  d' = keep ? scatter : d;
          // thr' = keep ? thr · (glass ? 1 : albedo) : thr;
          // alive' = cont = gain · ok_mat · (1 − light)
          const float ok_mat = (is_metal && !(code & TAPE_METAL_OK)) ? 0.0f
                                                                     : 1.0f;
          const float ok = f.light ? ok_mat * (1.0f - wl) : ok_mat;
          const float cont = gain * ok;
          if (cont > 0.5f) {
            kept = true;
            g_px = g_ox;
            g_py = g_oy;
            g_pz = g_oz;
            g_ndx = g_dx;
            g_ndy = g_dy;
            g_ndz = g_dz;
            if (is_diel) {
              n_thr_r = g_thr_r;
              n_thr_g = g_thr_g;
              n_thr_b = g_thr_b;
            } else {
              n_thr_r = g_thr_r * al_r;
              n_thr_g = g_thr_g * al_g;
              n_thr_b = g_thr_b * al_b;
              g_al_r = g_thr_r * thr_r;
              g_al_g = g_thr_g * thr_g;
              g_al_b = g_thr_b * thr_b;
            }
          } else {
            n_ox = g_ox;
            n_oy = g_oy;
            n_oz = g_oz;
            n_dx = g_dx;
            n_dy = g_dy;
            n_dz = g_dz;
            n_thr_r = g_thr_r;
            n_thr_g = g_thr_g;
            n_thr_b = g_thr_b;
          }
          g_gain = g_alive * ok;
          if (f.light) g_wl = -(g_alive * gain) * ok_mat;
        }
        if (f.light) {
          // rad += (gl · thr) · albedo, gl = gain · light
          const float gl = gain * wl;
          const float a_r = ct_r * al_r, a_g = ct_g * al_g, a_b = ct_b * al_b;
          const float g_gl = a_r * thr_r + a_g * thr_g + a_b * thr_b;
          n_thr_r = n_thr_r + a_r * gl;
          n_thr_g = n_thr_g + a_g * gl;
          n_thr_b = n_thr_b + a_b * gl;
          g_al_r = g_al_r + ct_r * (gl * thr_r);
          g_al_g = g_al_g + ct_g * (gl * thr_g);
          g_al_b = g_al_b + ct_b * (gl * thr_b);
          g_gain = g_gain + g_gl * wl;
          g_wl = g_wl + g_gl * gain;
        }
        v[6] = g_wl;
        // the albedo row the checker picked (selects: v stays in registers)
        v[7] = odd ? 0.0f : g_al_r;
        v[8] = odd ? 0.0f : g_al_g;
        v[9] = odd ? 0.0f : g_al_b;
        v[11] = odd ? g_al_r : 0.0f;
        v[12] = odd ? g_al_g : 0.0f;
        v[13] = odd ? g_al_b : 0.0f;
        float n_alive = g_gain * hitf;  // gain = alive · hit
        if (sky) {
          const float ox = t_o[b][0], oy = t_o[b][1], oz = t_o[b][2];
          const float dx = t_d[b][0], dy = t_d[b][1], dz = t_d[b][2];
          const float a_dd = dx * dx + dy * dy + dz * dz;
          float g_a_dd = 0.0f;
          if (!hit) {
            // rad += (miss · thr) · bg, miss = alive · (1 − hit)
            float inv_len;
            const float tt = sky_tt(dx, dy, dz, inv_len);
            const float bg_r = (1.0f - tt) + tt * 0.5f;
            const float bg_g = (1.0f - tt) + tt * 0.7f;
            const float bg_b = (1.0f - tt) + tt * 1.0f;
            const float miss = alive;
            const float m_r = ct_r * bg_r, m_g = ct_g * bg_g, m_b = ct_b * bg_b;
            n_thr_r = n_thr_r + m_r * miss;
            n_thr_g = n_thr_g + m_g * miss;
            n_thr_b = n_thr_b + m_b * miss;
            n_alive = n_alive + (m_r * thr_r + m_g * thr_g + m_b * thr_b);
            // bg = (1 − tt) + tt · sky, tt = 0.5 · (dy · inv_len + 1)
            const float g_s =
                0.5f * ((miss * thr_r) * ct_r * (0.5f - 1.0f) +
                        (miss * thr_g) * ct_g * (0.7f - 1.0f) +
                        (miss * thr_b) * ct_b * (1.0f - 1.0f));
            n_dy = n_dy + g_s * inv_len;
            g_a_dd = g_a_dd +
                     (g_s * dy) * (-0.5f * inv_len * inv_len * inv_len);
          }
          if (hit) {
            const float t = __int_as_float(tape[(size_t)(2 * b + 1) * n + i]);
            const float flip = w[C_FLIP];
            const bool sph = w[C_IS_SPHERE] > 0.5f;
            const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
            // the scatter direction → the normal, d and the parameter
            float g_nx = 0.0f, g_ny = 0.0f, g_nz = 0.0f;
            if (kept) {
              float nx, ny, nz;
              normal_at(w, px, py, pz, nx, ny, nz);
              v[10] = scatter_adjoint(
                  w, code, dx, dy, dz, a_dd, nx, ny, nz,
                  u + (size_t)b * 4 * n + i, (size_t)n, f, g_ndx, g_ndy, g_ndz,
                  g_nx, g_ny, g_nz, n_dx, n_dy, n_dz, g_a_dd);
            }
            float g_t;
            if (sph) {
              // n = (p − c) · invr · flip
              const float cx = w[C_CX], cy = w[C_CX + 1], cz = w[C_CX + 2];
              const float invr = w[C_INVR];
              const float qx = px - cx, qy = py - cy, qz = pz - cz;
              const float gmx = g_nx * flip, gmy = g_ny * flip,
                          gmz = g_nz * flip;
              v[5] = g_nx * (qx * invr) + g_ny * (qy * invr) +
                     g_nz * (qz * invr);
              v[4] = gmx * qx + gmy * qy + gmz * qz;
              const float gqx = gmx * invr, gqy = gmy * invr, gqz = gmz * invr;
              g_px = g_px + gqx;
              g_py = g_py + gqy;
              g_pz = g_pz + gqz;
              // p = o + t · d
              n_ox = n_ox + g_px;
              n_oy = n_oy + g_py;
              n_oz = n_oz + g_pz;
              n_dx = n_dx + t * g_px;
              n_dy = n_dy + t * g_py;
              n_dz = n_dz + t * g_pz;
              g_t = g_px * dx + g_py * dy + g_pz * dz;
              // t = (−bq ∓ sq) · inv_a: sq = √(bq² − a_dd · cc), bq = oc·d,
              // cc = oc·oc − r², oc = o − c, inv_a = 1 / a_dd
              const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
              const float bq = ocx * dx + ocy * dy + ocz * dz;
              const float cc = ocx * ocx + ocy * ocy + ocz * ocz - w[C_R2];
              const float sq = sqrtf(bq * bq - a_dd * cc);
              const float inv_a = 1.0f / a_dd;
              const float sgn = (code & TAPE_FAR) ? 1.0f : -1.0f;
              const float g_inv_a = g_t * (-bq + sgn * sq);
              const float gti = g_t * inv_a;
              const float g_disc = (sgn * gti) * 0.5f / sq;
              const float g_bq = -gti + 2.0f * bq * g_disc;
              const float g_cc = -(a_dd * g_disc);
              g_a_dd = g_a_dd - cc * g_disc - g_inv_a * inv_a * inv_a;
              const float g_ocx = g_bq * dx + 2.0f * g_cc * ocx;
              const float g_ocy = g_bq * dy + 2.0f * g_cc * ocy;
              const float g_ocz = g_bq * dz + 2.0f * g_cc * ocz;
              n_dx = n_dx + g_bq * ocx;
              n_dy = n_dy + g_bq * ocy;
              n_dz = n_dz + g_bq * ocz;
              n_ox = n_ox + g_ocx;
              n_oy = n_oy + g_ocy;
              n_oz = n_oz + g_ocz;
              v[0] = -gqx - g_ocx;
              v[1] = -gqy - g_ocy;
              v[2] = -gqz - g_ocz;
              v[3] = -g_cc;
            } else {
              // n = kn · flip
              const float kx = w[C_KN], ky = w[C_KN + 1], kz = w[C_KN + 2];
              v[5] = g_nx * kx + g_ny * ky + g_nz * kz;
              // p = o + t · d
              n_ox = n_ox + g_px;
              n_oy = n_oy + g_py;
              n_oz = n_oz + g_pz;
              n_dx = n_dx + t * g_px;
              n_dy = n_dy + t * g_py;
              n_dz = n_dz + t * g_pz;
              g_t = g_px * dx + g_py * dy + g_pz * dz;
              // t = (koff − o·kn) / (d·kn)
              const float g_num = g_t / (dx * kx + dy * ky + dz * kz);
              const float g_den = -(g_num * t);
              n_ox = n_ox - g_num * kx;
              n_oy = n_oy - g_num * ky;
              n_oz = n_oz - g_num * kz;
              n_dx = n_dx + g_den * kx;
              n_dy = n_dy + g_den * ky;
              n_dz = n_dz + g_den * kz;
              v[0] = g_nx * flip - g_num * ox + g_den * dx;
              v[1] = g_ny * flip - g_num * oy + g_den * dy;
              v[2] = g_nz * flip - g_num * oz + g_den * dz;
              v[3] = g_num;
            }
          }
          // a_dd = d·d
          n_dx = n_dx + 2.0f * g_a_dd * dx;
          n_dy = n_dy + 2.0f * g_a_dd * dy;
          n_dz = n_dz + 2.0f * g_a_dd * dz;
        }
        g_ox = n_ox;
        g_oy = n_oy;
        g_oz = n_oz;
        g_dx = n_dx;
        g_dy = n_dy;
        g_dz = n_dz;
        g_thr_r = n_thr_r;
        g_thr_g = n_thr_g;
        g_thr_b = n_thr_b;
        g_alive = n_alive;
        key = hit ? win : -1;
      }
      // one shared-memory add per (winner, column) per warp into the warp's
      // own row: only the columns the winner's kind and the launch's
      // families can carry
      unsigned todo = __ballot_sync(FULL, key >= 0);
      while (todo) {
        const int leader = __ffs(todo) - 1;
        const int wk = __shfl_sync(FULL, key, leader);
        const bool mine = key == wk;
        const bool wsph = s_rec[wk * REC_C + C_IS_SPHERE] > 0.5f;
        float* row = my_row + wk * SLOTS;
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          if (j == 4 && !wsph) continue;  // 1/r: spheres only
          if (j < 6 && !sky) continue;  // the geometric chain: sky only
          if (j == 6 && !f.light) continue;
          if (j == 10 && !(sky && (f.metal || f.diel))) continue;
          if (j > 10 && !f.checker) continue;
          const float s = warp_sum(mine ? v[j] : 0.0f);
          if (lane == leader) row[j] = row[j] + s;
        }
        __syncwarp();
        todo &= ~__ballot_sync(FULL, mine);
      }
    }

    if (valid) {
      d_o[3 * i] = g_ox;
      d_o[3 * i + 1] = g_oy;
      d_o[3 * i + 2] = g_oz;
      d_d[3 * i] = g_dx;
      d_d[3 * i + 1] = g_dy;
      d_d[3 * i + 2] = g_dz;
    }
    __syncthreads();
    // the tile's partial: its four warps' rows in warp order
    float* out = part + (size_t)tile * row_len;
    for (int k = threadIdx.x; k < row_len; k += THREADS)
      out[k] = ((s_rows[k] + s_rows[row_len + k]) + s_rows[2 * row_len + k]) +
               s_rows[3 * row_len + k];
    __threadfence();
    __syncthreads();
    const int set = tile / set_size;
    const int in_set = min(set_size, n_tiles - set * set_size);
    if (threadIdx.x == 0)
      s_last = atomicAdd(ws + WS_K3_SET0 + set, 1) == in_set - 1;
    __syncthreads();
    if (s_last) {
      // the set's last tile: its partials summed in tile order
      __threadfence();
      const float* src = part + (size_t)set * set_size * row_len;
      for (int k = threadIdx.x; k < row_len; k += THREADS) {
        float acc = 0.0f;
        for (int t = 0; t < in_set; ++t)
          acc = acc + __ldcg(src + (size_t)t * row_len + k);
        set_part[(size_t)set * row_len + k] = acc;
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(ws + WS_K3_SETS, 1) == n_sets - 1;
      __syncthreads();
      if (s_last) {
        // the last set: the sets summed in set order into d_rec [P, 35]
        __threadfence();
        for (int k = threadIdx.x; k < n_prims * REC_C; k += THREADS) {
          const int p = k / REC_C;
          const int j = col_slot(s_rec[p * REC_C + C_IS_SPHERE] > 0.5f,
                                 k - p * REC_C);
          float acc = 0.0f;
          if (j >= 0)
            for (int s = 0; s < n_sets; ++s)
              acc = acc + __ldcg(set_part + (size_t)s * row_len +
                                 p * SLOTS + j);
          d_rec[k] = acc;
        }
        for (int s = threadIdx.x; s < n_sets; s += THREADS)
          ws[WS_K3_SET0 + s] = 0;
        if (threadIdx.x == 0) ws[WS_K3_SETS] = 0;
      }
    }
    if (threadIdx.x == 0) {
      const int next = atomicAdd(ws + WS_K3_NEXT, 1);
      s_tile = gridDim.x + next;
    }
    __syncthreads();
    tile = s_tile;
  }
  if (threadIdx.x == 0) {
    // every block has polled past the end before it counts itself gone
    __threadfence();
    if (atomicAdd(ws + WS_K3_GONE, 1) == (int)gridDim.x - 1) {
      atomicExch(ws + WS_K3_NEXT, 0);
      atomicExch(ws + WS_K3_GONE, 0);
    }
  }
}

Feats feats(int has_light, int has_sky, int has_metal, int has_diel,
            int has_checker) {
  return Feats{has_light != 0, has_sky != 0, has_metal != 0, has_diel != 0,
               has_checker != 0};
}

bool any_material(const Feats& f) { return f.metal || f.diel || f.checker; }

// The four instantiations, in the order of rt_grad_occupancy: K2 and K3,
// each without and with MAT, and the shared memory each takes.
const void* kernel_of(int k) {
  static const void* fns[4] = {(const void*)grad_fwd<false>,
                               (const void*)grad_fwd<true>,
                               (const void*)grad_bwd<false>,
                               (const void*)grad_bwd<true>};
  return fns[k];
}

size_t smem_of(int k, int n_prims) {
  return sizeof(float) * n_prims * (k < 2 ? REC_C : REC_C + 4 * SLOTS);
}

// Blocks of kernel k resident at once on the current card (the occupancy
// query times the SMs), kept per device, kernel and record size.
int resident_blocks(int k, int n_prims) {
  constexpr int MAX_DEVICES = 16;
  static int cache[MAX_DEVICES][4][MAX_PRIMS + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  int& slot = cache[dev][k][n_prims];
  if (slot > 0) return slot;
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_of(k), THREADS, smem_of(k, n_prims)) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  slot = per_sm * sms;
  return slot;
}

bool bad_shape(int n_prims, int n, int n_bounce, int max_depth) {
  return n_prims <= 0 || n_prims > MAX_PRIMS || n <= 0 || n_bounce <= 0 ||
         n_bounce > MAX_BOUNCE || max_depth < 0;
}

}  // namespace

// K2: radiance rad f32[n, 3] of rays o, d f32[n, 3] under draws u
// f32[n_bounce, 4, n]; where tape is not null, the winner tape i32[n_bounce,
// 2, n] (header). ws: the zeroed counters (WS_*). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int rt_grad_fwd(const float* rec, int n_prims, const float* o,
                           const float* d, const float* u, float* rad,
                           int* tape, int n, int n_bounce, int max_depth,
                           int has_light, int has_sky, int has_metal,
                           int has_diel, int has_checker, int* ws,
                           void* stream) {
  if (bad_shape(n_prims, n, n_bounce, max_depth))
    return (int)cudaErrorInvalidValue;
  const Feats f = feats(has_light, has_sky, has_metal, has_diel, has_checker);
  const bool mat = any_material(f);
  const int resident = resident_blocks(mat ? 1 : 0, n_prims);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = std::min((n + THREADS - 1) / THREADS, resident);
  (mat ? grad_fwd<true> : grad_fwd<false>)
      <<<blocks, THREADS, smem_of(0, n_prims), (cudaStream_t)stream>>>(
          rec, n_prims, o, d, u, rad, tape, n, n_bounce, max_depth, f, ws);
  return (int)cudaGetLastError();
}

// K3: d_o, d_d f32[n, 3] and d_rec f32[P, 35] of <ct, rad> for cotangent ct
// f32[n, 3], from K2's winner tape of the same operands. part: scratch of
// (ceil(n / 128) + the sets) · P · 14 floats; ws: the zeroed counters, 5 +
// the sets of them (WS_*), set_size tiles a set.
extern "C" int rt_grad_bwd(const float* rec, int n_prims, const float* o,
                           const float* d, const float* u, const int* tape,
                           const float* ct, float* d_o, float* d_d,
                           float* d_rec, float* part, int n, int n_bounce,
                           int max_depth, int has_light, int has_sky,
                           int has_metal, int has_diel, int has_checker,
                           int* ws, int set_size, void* stream) {
  if (bad_shape(n_prims, n, n_bounce, max_depth) || set_size <= 0)
    return (int)cudaErrorInvalidValue;
  const Feats f = feats(has_light, has_sky, has_metal, has_diel, has_checker);
  const bool mat = any_material(f);
  const int resident = resident_blocks(mat ? 3 : 2, n_prims);
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = std::min((n + THREADS - 1) / THREADS, resident);
  (mat ? grad_bwd<true> : grad_bwd<false>)
      <<<blocks, THREADS, smem_of(2, n_prims), (cudaStream_t)stream>>>(
          rec, n_prims, o, d, u, tape, ct, d_o, d_d, d_rec, part, n, n_bounce,
          max_depth, f, ws, set_size);
  return (int)cudaGetLastError();
}

// Per instantiation (grad_fwd<0>, grad_fwd<1>, grad_bwd<0>, grad_bwd<1>):
// out[4k] registers, out[4k + 1] local bytes a thread (the stack frame),
// out[4k + 2] blocks an SM at a record of n_prims rows, out[4k + 3] the
// SMs. Returns a cudaError_t.
extern "C" int rt_grad_occupancy(int n_prims, int* out) {
  if (n_prims <= 0 || n_prims > MAX_PRIMS) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int k = 0; k < 4 && e == cudaSuccess; ++k) {
    cudaFuncAttributes a{};
    int per_sm = 0;
    e = cudaFuncGetAttributes(&a, kernel_of(k));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_of(k), THREADS, smem_of(k, n_prims));
    out[4 * k] = a.numRegs;
    out[4 * k + 1] = (int)a.localSizeBytes;
    out[4 * k + 2] = per_sm;
    out[4 * k + 3] = sms;
  }
  return (int)e;
}
