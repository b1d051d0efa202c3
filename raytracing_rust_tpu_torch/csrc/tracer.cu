// K1: the forward path-tracing megakernel for Hopper (sm_90a): its static
// section (K1a), its materials, checker and sky (K1b), its noise and image
// textures (K1c), its constant-density media on the event path and the
// dense-medium walk (K1d), its dynamic sphere and box loops with moving
// spheres (K1e), the lattice corners (textured lights, the UV of image
// rects and image media, flipped image prims, textured media), Russian
// roulette (K1g), and its cost-balanced pixel table and path-length
// counters (K1f).
//
// Replaces raytracing_rust_tpu/ops/pallas_tracer.py `_make_kernel` (its
// body `kernel`, launched by `_trace_call`): camera raygen with sub-pixel
// jitter, a thin lens and a shutter time; closest hit over the unrolled
// spheres and rect plane-frame groups, then over the box table (`box_thin`:
// one slab test per merged cube, entry face beyond T_MIN else exit face;
// on a regular grid the strip pass's member test, 1947-2024)
// and the dynamic sphere table, each in cluster order behind its
// two-level AABB cull (root, super rows, leaves), carrying only (t,
// winner) and resolving the winner's normal afterwards (a box's face by
// an exact t-match, ties x → y → z); the
// nearest medium scatter event before that hit (`media_events`: sphere or
// slab boundary in object space, free flight −(1/ρ)·ln u), which takes the
// hit over as an isotropic scatter with the medium's solid or textured
// albedo; after a scatter in a dense sealed medium, the walk (2540-2687):
// bounces that test only the medium's interior rows and race the media up
// to the nearest of them, with the main step's draws at the same bounce,
// each an iteration of the flat loop of its own, until a segment has no
// scatter, which the next iteration then traces against the whole scene
// with no medium event; emission, a textured
// light's its texture's value (2359-2369); a black or sky background;
// lambertian, metal, dielectric and diffuse-light scatter with solid, 3-D
// checker, Perlin marble (`_noise3`/`_turb3`, its 56 corner terms spread
// over the whole warp: `warp_turb`) or image albedo (one texel
// read from the packed atlas at the sphere UV of the pre-flip normal, a
// rect's UV in its world frame, or a medium's u = v = 0); the depth cap;
// Russian roulette (2492-2506); per-pixel sums over the samples. K1f
// (1284-1292, 1378-1394, 1534-1600): the pixels a thread renders may come
// from a table, kpix of them one after the other (the JAX kernel's kpix
// banks, built on the host from a cost probe), and a stats launch counts
// each pixel's segments and member tests and each warp's steps (the
// largest segment total among its threads: JAX's per-lane `s_steps`,
// 1547-1550, taken over a warp), and when
// asked (`dda=True`, 1278-1294) the box member tests whose AABB the ray
// crosses: per thread, since a thread walks its own members, where the
// TPU kernel asks whether any lane of its tile crosses (no warp vote here:
// which threads meet at a member of a divergent loop is the scheduler's
// choice, so no plain version could reproduce such a count). The render's
// cost probe has a launch of its own (`probe_split` > 0, the STATS == 2
// instantiations): it counts each pixel's segments alone, the one row the
// render's table reads, and reads and writes no sums, so what only colours
// a path (the marble's noise, the texels) is dead code there; as a mode of
// the STATS == 1 instantiations it ran 1.1-1.2× slower on random_spheres
// and final_scene (PERF.md §6). Its blocks take the compact
// TILE_W × TILE_H tiles in raster order, a pixel a thread, so a warp traces
// 16 × 2 neighbouring pixels where a scanline warp traced a 32 × 1 strip;
// the host splits each pixel's samples over probe_split blocks so that the
// launch fills the card, and the parts add their counts with integer
// atomics: a pixel's segments are keyed by (pixel, sample, bounce), so the
// row is the same in any layout, on any number of threads and in any
// order. The host side and the plain torch
// version of the same computation are in ops/tracer.py (`trace_plain`,
// `trace_probe`, `probe_plain`).
//
// The kernel is a template over five flags: K1B (any feature bit but
// media and roulette: sky, checker, metal, dielectric, moving spheres,
// noise, image, the walk, the lattice corners; media and roulette beside
// any of them or a table), DYN (1: a dynamic sphere table, a box table or
// a pixel table; 2: the same with the box table a regular grid, whose
// members take the strip pass, compiled only there, always with K1B and
// MED, so a table without a grid runs none of its code), LEAF_SMEM (the
// leaf tables sit in shared memory), STATS (0: none; 1: the counters of a
// stats launch; 2: the cost probe's; set only with K1B, DYN and MED, so
// two instantiations of each (and two more for a grid) serve every scene
// and the others keep their registers) and MED (the media: their
// race, the override of the hit, the isotropic scatter and, with K1B, the
// dense-medium walk; compiled only where it is set, so a scene without a
// medium runs none of that code). cornell_box runs the instantiation with
// all of them off, which is K1a, with and without --rr-depth: roulette
// alone is a branch on its feature bit there (K1g's path, which K1B ran
// until then), so it runs K1a's code and registers without the K1B
// branches; cornell_smoke, whose only feature is media, runs K1a's code
// with MED, and so without the K1B branches either. The production
// instantiations with MED serve the scenes that hold a medium; a K1B
// launch with a table whose leaves are not in shared memory (none, or too
// many to fit) runs the one K1B + DYN instantiation without them there,
// which has MED, as the stats instantiations do (no preset's command line
// launches it). Inside the K1B instantiations the features (the compat
// sphere-UV constant counted) are branches on the launch's feature bits,
// the same for every thread; inside DYN the box loop is a runtime loop,
// zero-trip without boxes. The TPU kernel carries a rect winner's UV and
// flip through its closest-hit loop (its frame scalars live in SMEM); here
// the winner's row is read after the loop, so the UV and the pre-flip
// normal are computed there, from t and the row, with no new loop state.
//
// What bounds it on this card: f32 ALU issue and warp divergence, not bytes.
// Each thread owns an ordered list of (pixel, sample) pairs and carries its
// ray in registers; one flat loop, one path segment an iteration, walks the
// list (the JAX kernel's persistent wavefront: a dead lane banks its
// radiance and starts its next pair's camera ray). So a warp does not wait
// at each sample for that sample's longest path: it runs until its busiest
// thread's list is done, the largest of 32 segment totals rather than the
// sum over samples of 32 per-sample maxima, and pays for it with the raygen
// branch, which some thread of the warp takes in most iterations. The
// unrolled record (P ≤ 96 rows × 46 f32, 17.7 KB), its walk order, the
// camera record and, when they fit, the leaf and super AABBs sit in shared
// memory, where the lanes of a warp mostly read the same cell (a broadcast);
// so do the media records (≤ MAX_MEDIA rows of 32 f32) and the walk's
// interior rows (≤ MAX_INTERIOR rows). They are staged once per block, ≤ 48
// KB by plain loads before the loop: against a block's millions of segments
// TMA or cp.async would buy nothing measurable. The dynamic sphere and box
// tables stay in device memory, read through the read-only cache, so their
// size is not capped by shared memory (the TPU kernel's ~2k-prim SMEM cap
// does not carry over); cluster tables too big for shared memory are read
// the same way, and so is the texel atlas, one 4-byte load per textured hit
// (the TPU kernel's 8 MB VMEM cap and its 8×128 gather construction do not
// carry over); the box winner's attributes are read from its row, not
// through the TPU kernel's transposed attribute gather. The 7-octave
// turbulence is ~2k f32 and SFU operations per noise hit: a warp that
// evaluated it thread by thread paid all 56 corner terms whenever one of
// its threads hit a marble, so the warp evaluates it together, at a point
// where it has reconverged, each requesting thread's terms on a block of
// lanes (`warp_turb`: 2 rounds for one thread, 56 for more than 16);
// every thread helps, walking, idle and finished ones too. The cull is
// the TPU kernel's two levels (`cull_table`): a root AABB per table, then
// super rows of SUP_FANOUT leaves, then the leaves, each a per-thread slab
// test against the thread's own best hit, so a segment tests the leaves of
// the supers its ray crosses rather than every leaf. A warp runs a guarded
// branch while any of its threads takes it, so the TPU kernel's OR-tree over
// its lanes has no counterpart here (a warp vote in place of the per-thread
// root and super guards measured the same). A regular box grid
// (`_grid_cluster_rows`: final_scene's 20×20 ground boxes, in strip
// layout) takes the TPU kernel's strip pass in the box members of
// instantiations of its own (DYN 2), so no other table carries its code:
// the leaf guard's x slab stands for its members' (the
// host checks that their x planes are its bits), the shared y_lo plane and
// the z pitch are taken once a segment, and a member reads its y_hi and
// z_lo alone (one 8-byte shared load where the leaves sit in shared
// memory), its z exit the entry plus the pitch. A walk bounce is an
// iteration of its own, so a thread on a dense-medium walk no longer holds
// its warp-mates through a nested loop of bounces: it runs the segment's
// code with the medium's interior rows in place of the scene's closest
// hit, so in one iteration its medium race and isotropic scatter are its
// warp-mates' instructions, a warp whose threads all walk pays for the
// interior rows alone, and a warp's steps (the largest segment total
// among its threads, walk bounces counted) are its iterations. Inside an
// iteration the threads of a warp still diverge (they cross different
// leaves, or some walk while others trace); the STATS counters measure
// what is left of the tail. The flat loop changes when a path runs, never
// its draws or its pixel's f64 sum order, and a pixel table
// changes which pixels share a warp, never those either, so the sums equal
// trace_plain's order bit for bit across chunkings and layouts. No pixel
// queue (an atomic counter over pixels) feeds the loop: the counters would
// then depend on the scheduler, which no plain version could reproduce.
//
// Numerics: no fast math, and compiled with -fmad=false, so every multiply
// and add rounds on its own, as torch's elementwise ops do; each f32
// expression is written in trace_plain's order, and the two agree path by
// path. 1/sqrt is written as a division (rsqrtf is not correctly
// rounded). No tensor cores are touched (TF32 would round geometry). With no
// FMA issued, the f32 ceiling is the card's add rate, about half the
// published FMA peak (D3, csrc/peak.cu, measures it).
//
// Random numbers: Philox4x32-10, key = seed, counter = (pixel, sample,
// bounce, stream); ops/rng.py documents which word feeds which draw.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// record columns (ops/tracer.py R_*)
constexpr int R_IS_SPHERE = 0, R_C0 = 1, R_DC = 4, R_T0 = 7, R_INV_DT = 8,
              R_RADIUS = 9,
              R_R2 = 10, R_KN = 11, R_AN = 14, R_BN = 17, R_KOFF = 20,
              R_AOFF = 21, R_BOFF = 22, R_A0 = 23, R_A1 = 24, R_B0 = 25,
              R_B1 = 26, R_FLIP = 27, R_MAT = 28, R_PARAM = 29, R_EMIT = 30,
              R_ALB = 33, R_ALB_ODD = 36, R_CHECKER = 39, R_NOISE = 40,
              R_NSCALE = 41, R_IMG = 42, R_IMG_BASE = 43, R_IMG_H = 44,
              R_IMG_W = 45, REC = 46;
// medium columns (ops/tracer.py M_*)
constexpr int M_DATA = 0, M_INV_RHO = 6, M_ROT = 7, M_OFF = 16, M_ALB = 19,
              MEDREC = 32;
// a texture's fields from a record row's R_ALB or a medium's M_ALB
// (ops/tracer.py T_*)
constexpr int T_ALB = 0, T_ODD = 3, T_CHK = 6, T_NOISE = 7, T_NSCALE = 8,
              T_IMG = 9, T_IMG_BASE = 10, T_IMG_H = 11, T_IMG_W = 12;
// camera columns (ops/tracer.py C_*)
constexpr int C_ORIGIN = 0, C_LL = 3, C_HORIZ = 6, C_VERT = 9, C_U = 12,
              C_V = 15, C_LENS_R = 18, C_TIME0 = 19, C_DTIME = 20,
              CAMREC = 21;
// cluster table row: lo3, hi3, first member, member count (ops/tracer.py
// CLUSW)
constexpr int CLUSW = 8;
// ops/tracer.py UNROLL_BUDGET
constexpr int MAX_PRIMS = 96;
// ops/tracer.py MAX_MEDIA
constexpr int MAX_MEDIA = 8;
// ops/tracer.py MAX_INTERIOR, and the interior row kinds (INT_*)
constexpr int MAX_INTERIOR = 24;
constexpr int INT_RECT = 1, INT_BOX = 2;
constexpr int THREADS = 128;
// a tile of the pixel table: the JAX kernel's (8, 1024) lanes (ops/tracer.py
// TILE)
constexpr int TILE = 8 * 1024;
// the probe's block: a tile of TILE_W × TILE_H pixels, row by row
// (ops/tracer.py BLOCK_W, BLOCK_H)
constexpr int TILE_W = 16, TILE_H = THREADS / TILE_W;
// shared memory a launch gets without opting in; the leaf table goes there
// when it fits beside the record
constexpr size_t SMEM_BUDGET = 48 * 1024;

// ops/tracer.py FEAT_*
constexpr int FEAT_SKY = 1, FEAT_CHECKER = 2, FEAT_METAL = 4, FEAT_DIEL = 8,
              FEAT_MOVING = 16, FEAT_NOISE = 32, FEAT_IMAGE = 64,
              FEAT_MEDIA = 128, FEAT_COMPAT_UV = 256, FEAT_DENSE_WALK = 512,
              FEAT_EMIS_TEX = 1024, FEAT_UV_CARRY = 2048,
              FEAT_IMG_FLIP = 4096, FEAT_MED_TEX = 8192, FEAT_RR = 16384,
              FEAT_ALL = 32767;

// K1_SOLID_MARBLE: a timing build that `kernel_ab --shares` alone compiles
// (the production build never defines it): the marble skips its turbulence
// and shades with its record's solid-colour fields (zero), so the paths
// and their draws stay the same and only the noise's time goes
#ifdef K1_SOLID_MARBLE
constexpr bool SOLID_MARBLE = true;
#else
constexpr bool SOLID_MARBLE = false;
#endif
// K1_MEDIA_TWICE: a timing build of `kernel_ab --shares` alone: every
// segment runs its media race a second time, into a sink the compiler must
// keep, so the time it adds is the race's
#ifdef K1_MEDIA_TWICE
constexpr bool MEDIA_TWICE = true;
#else
constexpr bool MEDIA_TWICE = false;
#endif

constexpr float BIG = 3.0e38f;
constexpr float T_MIN = 1e-3f;
constexpr float MAT_METAL = 1.0f, MAT_DIELECTRIC = 2.0f,
                MAT_DIFFUSE_LIGHT = 3.0f, MAT_ISOTROPIC = 4.0f;
constexpr float TWO_PI = 6.28318548202514648f;      // f32(2π), rng.TWO_PI
constexpr float ONE_THIRD = 0.333333343267440796f;  // f32(1/3), rng.ONE_THIRD
constexpr float U24 = 5.9604644775390625e-08f;      // 2^-24
// f32 constants of the sphere UV (ops/tracer.py PI, HALF_PI, ...)
constexpr float PI_F = 3.1415927410125732421875f;
constexpr float HALF_PI = 1.57079637050628662109375f;
constexpr float TWO_OVER_PI = 0.636619746685028076171875f;
constexpr float INV_PI = 0.3183098733425140380859375f;
constexpr float INV_2PI = 0.15915493667125701904296875f;

constexpr uint32_t STREAM_CAMERA = 0, STREAM_SCATTER = 1, STREAM_TIME = 2,
                   STREAM_MEDIUM = 4, STREAM_ROULETTE = 6;

// Perlin lattice hash (ops/perlin.py HA.., HM3)
constexpr uint32_t HA = 0x8DA6B343u, HB = 0xD8163841u, HC = 0xCB1AB31Fu,
                   HM1 = 0x9E3779B1u, HM2 = 0x85EBCA6Bu, HM3 = 0xC2B2AE35u;

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

// Hash-gradient Perlin noise (pallas_tracer.py `_noise3`, ops/perlin.py
// `noise3` and `corner_term`, reference src/perlin.rs:58-97) at a point p,
// corner by corner. `Cell` is p's lattice cell: the signed floor, the
// offset in it and its Hermite-smoothed weights (src/perlin.rs:39-41).
struct Cell {
  float ux, uy, uz, sx, sy, sz;
  int ix, iy, iz;
};

__device__ __forceinline__ Cell cell(float px, float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  Cell c;
  c.ux = px - fx;
  c.uy = py - fy;
  c.uz = pz - fz;
  c.ix = (int)fx;
  c.iy = (int)fy;
  c.iz = (int)fz;
  c.sx = c.ux * c.ux * (3.0f - 2.0f * c.ux);
  c.sy = c.uy * c.uy * (3.0f - 2.0f * c.uy);
  c.sz = c.uz * c.uz * (3.0f - 2.0f * c.uz);
  return c;
}

// The term of corner = 4·di + 2·dj + dk: the corner's unit gradient from a
// murmur-style hash of ((i + di) & 255, (j + dj) & 255, (k + dk) & 255) and
// the seed word, its dot product with the offset from the corner, times
// the trilinear weight; noise3's loop body, operation for operation (its
// cosine and sine from one range reduction, sincosf: bit-equal to cosf and
// sinf on every angle a hash word gives).
__device__ __forceinline__ float corner_term(const Cell& c, int corner,
                                             uint32_t seed_word) {
  const int di = corner >> 2, dj = (corner >> 1) & 1, dk = corner & 1;
  const float wu = di ? c.sx : 1.0f - c.sx;
  const float wv = dj ? c.sy : 1.0f - c.sy;
  const float ww = dk ? c.sz : 1.0f - c.sz;
  uint32_t h = ((uint32_t)((c.ix + di) & 255) * HA) ^
               ((uint32_t)((c.iy + dj) & 255) * HB) ^
               ((uint32_t)((c.iz + dk) & 255) * HC) ^ seed_word;
  h = h ^ (h >> 13);
  h = h * HM1;
  h = h ^ (h >> 16);
  uint32_t g = (h ^ HM2) * HM3;
  g = g ^ (g >> 16);
  const float u1 = (float)(h >> 8) * U24;
  const float u2 = (float)(g >> 8) * U24;
  const float gz = 2.0f * u1 - 1.0f;
  const float gs = sqrtf(fmaxf(1.0f - gz * gz, 0.0f));
  float sin_phi, cos_phi;
  sincosf(TWO_PI * u2, &sin_phi, &cos_phi);
  const float gx = gs * cos_phi, gy = gs * sin_phi;
  const float dot = gx * (c.ux - (float)di) + gy * (c.uy - (float)dj) +
                    gz * (c.uz - (float)dk);
  return wu * wv * ww * dot;
}

// The marble's turbulence |Σ_o 0.5^o noise(2^o p)| over 7 octaves
// (`_turb3`, ops/perlin.py `turb3`, reference src/perlin.rs:99-109) at the
// point (px, py, pz) of each thread that sets `need`, evaluated by the
// whole warp together: every thread of the warp calls it, where the warp
// has reconverged, and a thread without `need` (idle, walking, finished,
// or shading something else) computes terms for the others and gets 0.
// A thread alone takes 56 corner terms (7 octaves × 8 corners), and a
// warp paid all 56 whenever any of its threads hit a marble. Here each of
// the k requesting threads owns a block of m lanes, m the largest power of
// two with k·m ≤ 32, whose lanes take its terms m at a time in (octave,
// corner) order: 56 / m rounds (4 for m = 16, 2 for m = 32), which is
// ⌈56k / 32⌉ when k is a power of two and under twice that otherwise: 2
// rounds for one thread, 56 for 17 or more. The lanes that hold one
// octave's corners in a round (m of them, at most 8) hand them to the
// first, which adds them in corner order onto the octave's sum from 0
// (noise3's); the block's first lane adds each finished octave's sum,
// times 0.5^o, in octave order from 0 (turb3's). A term's point is p·2^o,
// exact as turb3's repeated doubling is, so the result is turb3's bit for
// bit. A block of one lane (k > 16) shuffles nothing but its owner's
// point and its result.
__device__ float warp_turb(bool need, float px, float py, float pz,
                           uint32_t seed_word) {
  const uint32_t req = __ballot_sync(0xffffffffu, need);
  if (req == 0u) return 0.0f;
  const int lane = threadIdx.x & 31;
  const int k = __popc(req);
  const int m = 32 >> (32 - __clz(k - 1));  // lanes per owner
  const int j = lane & (m - 1);             // this lane's place in its block
  const int block = lane & ~(m - 1);
  // the owner of this lane's block (blocks past the last owner's take the
  // last owner's terms, which nobody adds): its lane, req's (rank+1)-th
  // set bit, is the largest position with at most rank set bits below it
  const int rank = min(lane / m, k - 1);
  int src = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__popc(req & ((1u << (src + step)) - 1u)) <= rank) src += step;
  const float qx = __shfl_sync(0xffffffffu, px, src),
              qy = __shfl_sync(0xffffffffu, py, src),
              qz = __shfl_sync(0xffffffffu, pz, src);
  float acc = 0.0f;
  if (m <= 8) {
    // a block takes an octave in 8 / m rounds, corner c0 + j in round c0 / m
#pragma unroll 1
    for (int o = 0; o < 7; ++o) {
      const float scale = (float)(1 << o);
      const Cell c = cell(qx * scale, qy * scale, qz * scale);
      float octave_sum = 0.0f;
      if (m == 1) {
#pragma unroll
        for (int corner = 0; corner < 8; ++corner)
          octave_sum = octave_sum + corner_term(c, corner, seed_word);
      } else {
#pragma unroll 1
        for (int c0 = 0; c0 < 8; c0 += m) {
          const float term = corner_term(c, c0 + j, seed_word);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (i < m)
              octave_sum =
                  octave_sum + __shfl_sync(0xffffffffu, term, block + i);
        }
      }
      acc = acc + __int_as_float((127 - o) << 23) * octave_sum;
    }
  } else {
    // a block of 16 or 32 lanes takes 2 or 4 octaves a round, a corner a
    // lane; t ≥ 56, in the last round, is a spare term nobody adds
#pragma unroll 1
    for (int r = 0; r < 56 / m + 1; ++r) {
      const int t = r * m + j;
      const float scale = (float)(1 << min(t >> 3, 6));
      const float term = corner_term(cell(qx * scale, qy * scale, qz * scale),
                                     t & 7, seed_word);
      float octave_sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        octave_sum =
            octave_sum + __shfl_sync(0xffffffffu, term, (lane & ~7) + i);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (8 * i < m) {
          const float v = __shfl_sync(0xffffffffu, octave_sum, block + 8 * i);
          const int o = (r * m + 8 * i) >> 3;
          if (o < 7) acc = acc + __int_as_float((127 - o) << 23) * v;
        }
      }
    }
  }
  const float turb = fabsf(__shfl_sync(
      0xffffffffu, acc, min(__popc(req & ((1u << lane) - 1u)), k - 1) * m));
  return need ? turb : 0.0f;
}

// Reciprocal direction for slab tests: an exact-zero component gets a
// huge signed inverse so a parallel ray outside a slab misses and one
// inside passes (pallas_tracer.py `_safe_inv`, 1368-1376).
__device__ __forceinline__ float safe_inv(float dc) {
  return fabsf(dc) < 1e-30f ? (dc >= 0.0f ? 1e30f : -1e30f) : 1.0f / dc;
}

// Entry and exit t of a ray against the box [lo, hi] (`_slab`, 1741-1754),
// x, then y, then z, and the x slab's (txmn, txmx) alone (dropped where a
// caller leaves them unread).
__device__ __forceinline__ void slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float ox, float oy,
                                     float oz, float inv_dx, float inv_dy,
                                     float inv_dz, float& tmn, float& tmx,
                                     float& txmn, float& txmx) {
  float t0 = (lx - ox) * inv_dx, t1 = (hx - ox) * inv_dx;
  txmn = tmn = fminf(t0, t1);
  txmx = tmx = fmaxf(t0, t1);
  t0 = (ly - oy) * inv_dy;
  t1 = (hy - oy) * inv_dy;
  tmn = fmaxf(tmn, fminf(t0, t1));
  tmx = fminf(tmx, fmaxf(t0, t1));
  t0 = (lz - oz) * inv_dz;
  t1 = (hz - oz) * inv_dz;
  tmn = fmaxf(tmn, fminf(t0, t1));
  tmx = fminf(tmx, fmaxf(t0, t1));
}

// Whether the ray crosses the AABB of a cluster-table row (lo3, hi3)
// inside its window, before its best hit so far (`_clus_guard`,
// 1756-1776): slab entry before t_d, exit beyond both the entry and T_MIN;
// the row's x slab into (txmn, txmx).
__device__ __forceinline__ bool crosses(const float* B, float ox, float oy,
                                        float oz, float inv_dx, float inv_dy,
                                        float inv_dz, float t_d, float& txmn,
                                        float& txmx) {
  float tmn, tmx;
  slab(B[0], B[1], B[2], B[3], B[4], B[5], ox, oy, oz, inv_dx, inv_dy,
       inv_dz, tmn, tmx, txmn, txmx);
  return tmx > fmaxf(tmn, T_MIN) && tmn < t_d;
}

// One dynamic table's two-level cull (pallas_tracer.py:1799-1817,
// 1855-1898): the root AABB (the union of the super rows, or of the
// leaves without supers) guards the whole table, each super row
// (lo3, hi3, first leaf, leaf count) its leaves, each leaf (lo3, hi3,
// first member, member count) its members, which `members(start, count)`
// tests, lowering t_d. Supers go in ascending order and so do a super's
// leaves, which tile [0, n_leaf): a super's AABB is the f32 min/max of its
// leaves', and f32 rounding is monotone, so its slab interval holds each
// of its leaves' on the same ray, and t_d only falls; a leaf the
// one-level cull would test is therefore tested here too, in the same
// order at the same t_d, and the winners, the ties and the counters are
// the one-level cull's. Without leaves the members are scanned flat.
// `members(start, count, txmn, txmx)` gets the x slab of the leaf whose
// guard it passed (unset in a flat scan); `enter()` runs once a segment,
// before the first members, once the root guard passes.
template <typename Members, typename Enter>
__device__ __forceinline__ void cull_table(
    const float* root, const float* sup, int n_sup, const float* leaf,
    int n_leaf, int n_mem, float ox, float oy, float oz, float inv_dx,
    float inv_dy, float inv_dz, const float& t_d, Members members,
    Enter enter) {
  float txmn = 0.0f, txmx = 0.0f;
  if (n_leaf == 0) {
    enter();
    members(0, n_mem, txmn, txmx);
    return;
  }
  if (!crosses(root, ox, oy, oz, inv_dx, inv_dy, inv_dz, t_d, txmn, txmx))
    return;
  enter();
  const int n_top = n_sup > 0 ? n_sup : 1;
  for (int s = 0; s < n_top; ++s) {
    int c0 = 0, c1 = n_leaf;
    if (n_sup > 0) {
      const float* S = sup + s * CLUSW;
      if (!crosses(S, ox, oy, oz, inv_dx, inv_dy, inv_dz, t_d, txmn, txmx))
        continue;
      c0 = (int)S[6];
      c1 = c0 + (int)S[7];
    }
    for (int c = c0; c < c1; ++c) {
      const float* L = leaf + c * CLUSW;
      if (!crosses(L, ox, oy, oz, inv_dx, inv_dy, inv_dz, t_d, txmn, txmx))
        continue;
      members((int)L[6], (int)L[7], txmn, txmx);
    }
  }
}

// A uniform point in the unit ball from a scatter draw (ops/rng.py
// in_unit_sphere): cos θ = 2u₀ − 1, φ = 2πu₁, radius cbrt(1 − u₂).
__device__ __forceinline__ void ball(const Uniforms& us, float& bx,
                                     float& by, float& bz) {
  const float cos_t = 2.0f * us.x - 1.0f;
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float sphi = TWO_PI * us.y;
  const float ball_r = powf(1.0f - us.z, ONE_THIRD);
  bx = ball_r * (sin_t * cosf(sphi));
  by = ball_r * (sin_t * sinf(sphi));
  bz = ball_r * cos_t;
}

// The nearest constant-density medium scatter event on [T_MIN, t_cap]
// (pallas_tracer.py `media_events`, 1431-1525; reference
// src/medium.rs:28-56) → its t (BIG where none), and its medium in m_win.
// Each medium's boundary is entered and left on the ray's line (sphere
// roots, or slabs after the world→object rotation and offset); the free
// flight −(1/ρ)·ln u takes word i % 4 of counter (pixel, sample, bounce,
// MEDIUM + i / 4), drawn only for a medium whose interval is non-empty.
__device__ __forceinline__ float media_race(
    const float* s_med, int n_med, int med_box, float ox, float oy,
    float oz, float dx, float dy, float dz, float a_dd, float inv_a,
    float t_cap, uint32_t pix, uint32_t sample, uint32_t bounce,
    uint32_t k0, uint32_t k1, int& m_win) {
  const float d_len = sqrtf(a_dd);
  const float inv_dlen = 1.0f / d_len;
  float t_med = BIG;
  int group = -1;
  m_win = -1;
  Uniforms um = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n_med; ++i) {
    const float* m = s_med + i * MEDREC;
    // world → object: R₋ (o − offset), R₋ d
    const float wx = ox - m[M_OFF], wy = oy - m[M_OFF + 1],
                wz = oz - m[M_OFF + 2];
    const float o0x = m[M_ROT] * wx + m[M_ROT + 1] * wy + m[M_ROT + 2] * wz;
    const float o0y =
        m[M_ROT + 3] * wx + m[M_ROT + 4] * wy + m[M_ROT + 5] * wz;
    const float o0z =
        m[M_ROT + 6] * wx + m[M_ROT + 7] * wy + m[M_ROT + 8] * wz;
    const float d0x = m[M_ROT] * dx + m[M_ROT + 1] * dy + m[M_ROT + 2] * dz;
    const float d0y =
        m[M_ROT + 3] * dx + m[M_ROT + 4] * dy + m[M_ROT + 5] * dz;
    const float d0z =
        m[M_ROT + 6] * dx + m[M_ROT + 7] * dy + m[M_ROT + 8] * dz;
    float enter, exit_;
    bool ok;
    if ((med_box >> i) & 1) {
      // slabs on the ray's line; a tiny component becomes +1e-30
      const float sx = fabsf(d0x) < 1e-30f ? 1e-30f : d0x;
      const float sy = fabsf(d0y) < 1e-30f ? 1e-30f : d0y;
      const float sz = fabsf(d0z) < 1e-30f ? 1e-30f : d0z;
      const float lx = (m[M_DATA] - o0x) / sx, hx = (m[M_DATA + 3] - o0x) / sx;
      const float ly = (m[M_DATA + 1] - o0y) / sy,
                  hy = (m[M_DATA + 4] - o0y) / sy;
      const float lz = (m[M_DATA + 2] - o0z) / sz,
                  hz = (m[M_DATA + 5] - o0z) / sz;
      enter = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
      exit_ = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
      ok = enter < exit_;
    } else {
      // both sphere roots on the ray's line
      const float ocx = o0x - m[M_DATA], ocy = o0y - m[M_DATA + 1],
                  ocz = o0z - m[M_DATA + 2];
      const float bq = ocx * d0x + ocy * d0y + ocz * d0z;
      const float cq = ocx * ocx + ocy * ocy + ocz * ocz - m[M_DATA + 3];
      const float disc = bq * bq - a_dd * cq;
      ok = disc > 0.0f;
      const float sq = sqrtf(ok ? disc : 1.0f);
      enter = (-bq - sq) * inv_a;
      exit_ = (-bq + sq) * inv_a;
    }
    enter = fmaxf(enter, T_MIN);
    exit_ = fminf(exit_, t_cap);
    if (!(ok && enter < exit_)) continue;
    if (i >> 2 != group) {
      group = i >> 2;
      um = philox(pix, sample, bounce, STREAM_MEDIUM + (uint32_t)group, k0,
                  k1);
    }
    const int wi = i & 3;
    const float u = wi == 0 ? um.x : wi == 1 ? um.y : wi == 2 ? um.z : um.w;
    const float flight = -m[M_INV_RHO] * logf(fmaxf(u, 1e-37f));
    if (!(flight < (exit_ - enter) * d_len)) continue;
    const float t_i = enter + flight * inv_dlen;
    if (t_i < t_med) {
      t_med = t_i;
      m_win = i;
    }
  }
  return t_med;
}

template <bool K1B, int DYN, bool LEAF_SMEM, int STATS, bool MED>
__global__ void __launch_bounds__(THREADS)
trace_k1(const float* __restrict__ rec, int n_rec,
         const int* __restrict__ walk, int n_walk,
         const float* __restrict__ dyn, int n_dyn,
         const float* __restrict__ leaves, int n_leaf,
         const float* __restrict__ cam, int feats,
         double* __restrict__ sums, int nx, int ny, uint32_t k0,
         uint32_t k1, int sample0, int n_samples, int max_depth,
         const float* __restrict__ med, int n_med, int med_box,
         const int* __restrict__ atlas, int atlas_rows, int atlas_w,
         uint32_t perlin_word, const float* __restrict__ box, int n_box,
         const float* __restrict__ bleaves, int n_bleaf,
         const float* __restrict__ interior, int n_int,
         const int* __restrict__ interior_kind, int dense, int rr_depth,
         const int* __restrict__ pix_table, int kpix,
         long long* __restrict__ stats, long long* __restrict__ dda,
         const float* __restrict__ sups, int n_sup,
         const float* __restrict__ bsups, int n_bsup, int probe_split,
         long long* __restrict__ probe_steps, float grid_ylo, float grid_w) {
  // the scene's features; all off outside the K1B instantiations, but
  // roulette, which the static instantiations play too, and media, on
  // wherever MED is; the walk's interior rows (WALK) come with both
  constexpr bool WALK = K1B && MED;
  // the box table is a regular grid (`_grid_cluster_rows`): the strip pass
  constexpr bool GRID = DYN == 2;
  const bool emis_tex = K1B && (feats & FEAT_EMIS_TEX),
             uv_carry = K1B && (feats & FEAT_UV_CARRY),
             img_flip = K1B && (feats & FEAT_IMG_FLIP),
             med_tex = WALK && (feats & FEAT_MED_TEX),
             rr = (K1B || !DYN) && (feats & FEAT_RR);
  const bool sky = K1B && (feats & FEAT_SKY),
             checker = K1B && (feats & FEAT_CHECKER),
             metal = K1B && (feats & FEAT_METAL),
             diel = K1B && (feats & FEAT_DIEL),
             moving = K1B && (feats & FEAT_MOVING),
             noise = K1B && !SOLID_MARBLE && (feats & FEAT_NOISE),
             image = K1B && (feats & FEAT_IMAGE),
             media = MED && (feats & FEAT_MEDIA),
             compat_uv = K1B && (feats & FEAT_COMPAT_UV),
             dense_walk = WALK && (feats & FEAT_DENSE_WALK);
  // dynamic shared memory, sized by the launch: record, the walk's
  // interior rows (WALK: rows n_rec.. of the record), camera, the box and
  // sphere tables' root AABBs (DYN), sphere leaves and supers and box
  // leaves and supers (LEAF_SMEM), media (MED), the row list (order, then
  // lead: the unrolled rows' walk order, then with WALK the interior
  // spheres and rects), the interior rows' kinds (WALK); before them all,
  // a box grid's (y_hi, z_lo) per box (GRID and LEAF_SMEM)
  extern __shared__ float smem[];
  float2* s_grid = (float2*)smem;
  float* s_rec = smem + (GRID && LEAF_SMEM ? 2 * n_box : 0);
  float* s_int = s_rec + n_rec * REC;
  float* s_cam = s_int + (WALK ? n_int * REC : 0);
  float* s_root = s_cam + CAMREC;
  float* s_leaf = s_root + (DYN ? 12 : 0);
  float* s_sup = s_leaf + (LEAF_SMEM ? n_leaf * CLUSW : 0);
  float* s_bleaf = s_sup + (LEAF_SMEM ? n_sup * CLUSW : 0);
  float* s_bsup = s_bleaf + (LEAF_SMEM ? n_bleaf * CLUSW : 0);
  float* s_med = s_bsup + (LEAF_SMEM ? n_bsup * CLUSW : 0);
  int* s_walk = (int*)(s_med + (MED ? n_med * MEDREC : 0));
  // the interior spheres and rects join the row list; the boxes stay
  // apart (a walk bounce tests them after the list)
  int n_int_sr = 0;
  if (WALK)
    for (int i = 0; i < n_int; ++i) n_int_sr += interior_kind[i] != INT_BOX;
  const int n_list = n_walk + (WALK ? n_int_sr : 0);
  int* s_ikind = s_walk + 2 * n_list;
  if (GRID && LEAF_SMEM)
    for (int i = threadIdx.x; i < n_box; i += blockDim.x)
      s_grid[i] = make_float2(box[(size_t)i * REC + R_DC + 1],
                              box[(size_t)i * REC + R_C0 + 2]);
  for (int i = threadIdx.x; i < n_rec * REC; i += blockDim.x)
    s_rec[i] = rec[i];
  for (int i = threadIdx.x; i < 2 * n_walk; i += blockDim.x)
    s_walk[i + (WALK && i >= n_walk ? n_int_sr : 0)] = walk[i];
  for (int i = threadIdx.x; i < CAMREC; i += blockDim.x) s_cam[i] = cam[i];
  if (LEAF_SMEM) {
    for (int i = threadIdx.x; i < n_leaf * CLUSW; i += blockDim.x)
      s_leaf[i] = leaves[i];
    for (int i = threadIdx.x; i < n_sup * CLUSW; i += blockDim.x)
      s_sup[i] = sups[i];
    for (int i = threadIdx.x; i < n_bleaf * CLUSW; i += blockDim.x)
      s_bleaf[i] = bleaves[i];
    for (int i = threadIdx.x; i < n_bsup * CLUSW; i += blockDim.x)
      s_bsup[i] = bsups[i];
  }
  if (DYN && threadIdx.x < 32) {
    // each table's root AABB, folded by warp 0 from its super rows (its
    // leaves without supers): the box table's at s_root[0..5], the
    // sphere table's at s_root[6..11] (pallas_tracer.py:1804-1811)
    const int lane = threadIdx.x;
#pragma unroll 1
    for (int t = 0; t < 2; ++t) {
      const float* rows = t == 0 ? (n_bsup > 0 ? bsups : bleaves)
                                 : (n_sup > 0 ? sups : leaves);
      const int n = t == 0 ? (n_bsup > 0 ? n_bsup : n_bleaf)
                           : (n_sup > 0 ? n_sup : n_leaf);
      float b[6] = {BIG, BIG, BIG, -BIG, -BIG, -BIG};
      for (int i = lane; i < n; i += 32) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          b[a] = fminf(b[a], rows[i * CLUSW + a]);
          b[3 + a] = fmaxf(b[3 + a], rows[i * CLUSW + 3 + a]);
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          b[a] = fminf(b[a], __shfl_xor_sync(0xffffffffu, b[a], m));
          b[3 + a] =
              fmaxf(b[3 + a], __shfl_xor_sync(0xffffffffu, b[3 + a], m));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) s_root[6 * t + a] = b[a];
      }
    }
  }
  if (MED)
    for (int i = threadIdx.x; i < n_med * MEDREC; i += blockDim.x)
      s_med[i] = med[i];
  if (WALK) {
    for (int i = threadIdx.x; i < n_int * REC; i += blockDim.x)
      s_int[i] = interior[i];
    for (int i = threadIdx.x; i < n_int; i += blockDim.x)
      s_ikind[i] = interior_kind[i];
    // the list entries n_walk.. : interior row i (record row n_rec + i) in
    // order, lead -1 for a sphere, its own row (its frame) for a rect
    if (threadIdx.x == 0) {
      for (int i = 0, e = n_walk; i < n_int; ++i) {
        if (interior_kind[i] == INT_BOX) continue;
        s_walk[e] = n_rec + i;
        s_walk[n_list + e] = interior_kind[i] == INT_RECT ? n_rec + i : -1;
        ++e;
      }
    }
  }
  __syncthreads();
  const float* leaf = LEAF_SMEM ? s_leaf : leaves;
  const float* sup = LEAF_SMEM ? s_sup : sups;
  const float* bleaf = LEAF_SMEM ? s_bleaf : bleaves;
  const float* bsup = LEAF_SMEM ? s_bsup : bsups;

  const int n_pix = nx * ny;
  const int* order = s_walk;
  const int* lead = s_walk + n_list;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  // K1f (pallas_tracer.py:1378-1394, 1534-1560): with a pixel table (DYN
  // instantiations only) thread j of tile g renders the pixels
  // table[(g·kpix + b)·TILE + j], b = 0 .. kpix − 1, one after the other,
  // each in sample order into its own sums; a slot outside [0, n_pix)
  // renders nothing (n_pix pads the last tile)
  const bool table = DYN && pix_table != nullptr;
  const int n_banks = table ? kpix : 1;
  // the probe: block b takes tile b % n_tiles of TILE_W × TILE_H pixels
  // (tiles in raster order, a thread on the tile's column t % TILE_W and row
  // t / TILE_W; n_pix past the image's edge) with part b / n_tiles of the
  // samples, n_samples / probe_split of them
  int probe_pix = n_pix;
  if (STATS == 2) {
    const int gx = (nx + TILE_W - 1) / TILE_W;
    const int n_tiles = gx * ((ny + TILE_H - 1) / TILE_H);
    const int tile = blockIdx.x % n_tiles;
    const int x = (tile % gx) * TILE_W + (int)threadIdx.x % TILE_W;
    const int y = (tile / gx) * TILE_H + (int)threadIdx.x / TILE_W;
    if (x < nx && y < ny) probe_pix = y * nx + x;
    n_samples /= probe_split;
    sample0 += (int)(blockIdx.x / n_tiles) * n_samples;
  }
  // A thread's work is an ordered list of (pixel, sample) pairs: its bank
  // 0 pixel with samples sample0 .. sample0 + n_samples − 1, then bank 1's
  // pixel and all its samples, and so on. One flat loop walks the list,
  // one path segment an iteration (the JAX kernel's persistent wavefront,
  // pallas_tracer.py:1527-1592, 2516-2538). (bank, si) is the current
  // pair; si == n_samples: the pixel is done, or none is open yet.
  int bank = -1, pix = 0, si = n_samples;
  double acc_r = 0.0, acc_g = 0.0, acc_b = 0.0;
  // STATS: the current pixel's segments traced (walk bounces too), dynamic
  // sphere and box member tests, and with the DDA row its box member
  // tests whose AABB the ray crosses; the thread's segments over the
  // launch (`total`)
  uint32_t busy = 0, tests_s = 0, tests_b = 0, cross_b = 0, total = 0;
  // the live path: its ray, shutter time, throughput, radiance and bounce,
  // and whether the walk ruled out a medium event on its next segment
  // (`skip_med`)
  bool live = false, skip_med = false;
  // K1B: the path is on a dense-medium walk, its next bounce at `bounce`
  bool walking = false;
  int bounce = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float time = 0.0f;
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  for (;;) {
    if (!live) {
      // the next pair: the pixel's next sample, else the next bank's pixel
      // inside the image, whose sums are read first
      while (si >= n_samples && bank < n_banks - 1) {
        ++bank;
        pix = table ? __ldg(pix_table +
                            ((size_t)(tid / TILE) * kpix + bank) * TILE +
                            tid % TILE)
              : STATS == 2 ? probe_pix
                           : tid;
        if ((unsigned)pix < (unsigned)n_pix) {
          if (STATS != 2) {   // the probe's radiance is not kept
            acc_r = sums[pix];
            acc_g = sums[n_pix + pix];
            acc_b = sums[2 * n_pix + pix];
          }
          busy = tests_s = tests_b = cross_b = 0;
          si = 0;
        }
      }
      if (si < n_samples) {
        // camera ray (reference src/camera.rs:53-67, jitter tests/test.rs:
        // 66-68); row 0 of the image is the top scanline (62-64)
        const uint32_t sample = (uint32_t)(sample0 + si);
        const float icol = (float)(pix % nx);
        const float jflip = (float)(ny - 1 - pix / nx);
        const Uniforms uc = philox(pix, sample, 0, STREAM_CAMERA, k0, k1);
        const float s = (icol + uc.x) / (float)nx;
        const float t = (jflip + uc.y) / (float)ny;
        const float lr = sqrtf(uc.z);
        const float phi = TWO_PI * uc.w;
        const float rdx = s_cam[C_LENS_R] * (lr * cosf(phi));
        const float rdy = s_cam[C_LENS_R] * (lr * sinf(phi));
        ox = s_cam[C_ORIGIN] + (rdx * s_cam[C_U] + rdy * s_cam[C_V]);
        oy = s_cam[C_ORIGIN + 1] +
             (rdx * s_cam[C_U + 1] + rdy * s_cam[C_V + 1]);
        oz = s_cam[C_ORIGIN + 2] +
             (rdx * s_cam[C_U + 2] + rdy * s_cam[C_V + 2]);
        dx = s_cam[C_LL] + s * s_cam[C_HORIZ] + t * s_cam[C_VERT] - ox;
        dy = s_cam[C_LL + 1] + s * s_cam[C_HORIZ + 1] + t * s_cam[C_VERT + 1] -
             oy;
        dz = s_cam[C_LL + 2] + s * s_cam[C_HORIZ + 2] + t * s_cam[C_VERT + 2] -
             oz;
        // shutter time (pallas_tracer.py:1583-1584)
        time = 0.0f;
        if (moving)
          time = s_cam[C_TIME0] +
                 philox(pix, sample, 0, STREAM_TIME, k0, k1).x * s_cam[C_DTIME];
        thr_r = thr_g = thr_b = 1.0f;
        rad_r = rad_g = rad_b = 0.0f;
        bounce = 0;
        skip_med = false;
        live = true;
      }
    }
    // The warp leaves the loop together, once none of its threads has a
    // path left: a thread whose list is done stays, idle, so no thread
    // leaves from inside a divergent branch and the segment below runs
    // with the warp reconverged every iteration (a divergent exit would
    // let the threads that took the raygen branch and those that did not
    // trace their segments apart)
    if (!__any_sync(0xffffffffu, live)) break;
    // A live thread's iteration: one segment of its path at `bounce`, in
    // two parts: its closest hit and nearest medium event (part A), then,
    // once the warp has evaluated the marble's turbulence for the threads
    // that shade with it, its shading and scatter (part B). While the
    // thread walks, the segment is a walk bounce: part A tests the dense
    // medium's interior rows in place of the scene, and part B is the
    // medium event's isotropic scatter, the code every medium event runs.
    bool seg = live;
    float a_dd = 0.0f, inv_a = 0.0f;
    float t_best = BIG, nbx = 0.0f, nby = 0.0f, nbz = 0.0f;
    int win = -1;                  // the unrolled winner's record row
    const float* w_dyn = nullptr;  // the box or dynamic winner's row
    bool med_event = false;
    int m_ev = -1;
    if (live) {
      const uint32_t sample = (uint32_t)(sample0 + si);
      if (STATS) ++busy;
      a_dd = dx * dx + dy * dy + dz * dz;
      inv_a = 1.0f / a_dd;
      // a walk bounce (pallas_tracer.py:2540-2687) takes the medium's
      // interior rows in place of the scene: its spheres and rects in the
      // row loop (list entries n_walk..), then its boxes, each kind's t as
      // the main step computes it, so the least is the walk's nearest
      // interior hit; it skips the tables. Its media race below has the
      // main step's draws at this bounce (MEDIUM for the flights, SCATTER
      // for the direction)
      const bool walk_bounce = dense_walk && walking;
      // the current rect group's ray·frame dot products
      int frame = -1;
      bool nonpar = false;
      float o_kn = 0.0f, inv_kn = 0.0f, o_an = 0.0f, d_an = 0.0f,
            o_bn = 0.0f, d_bn = 0.0f;
      for (int k = walk_bounce ? n_walk : 0;
           k < (walk_bounce ? n_list : n_walk); ++k) {
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

      if (walk_bounce) {
        // the interior boxes: the entry face beyond T_MIN, else the exit
        const float iwx = safe_inv(dx), iwy = safe_inv(dy),
                    iwz = safe_inv(dz);
        for (int j = 0; j < n_int; ++j) {
          if (s_ikind[j] != INT_BOX) continue;
          const float* r = s_int + j * REC;
          float tmn, tmx, txmn, txmx;
          slab(r[R_C0], r[R_C0 + 1], r[R_C0 + 2], r[R_DC], r[R_DC + 1],
               r[R_DC + 2], ox, oy, oz, iwx, iwy, iwz, tmn, tmx, txmn, txmx);
          const float t_p = tmn > T_MIN ? tmn : tmx;
          if (tmx > tmn && t_p > T_MIN && t_p < t_best) t_best = t_p;
        }
      } else if (DYN) {
        // the box table, then the dynamic sphere table, each in cluster
        // order behind its two-level cull (`cull_table`), carrying only
        // (t, winner) (pallas_tracer.py:1906-2071; boxes first, so a box
        // keeps a tie)
        float t_d = t_best;
        const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
                    inv_dz = safe_inv(dz);
        int wb = -1;
        // a member's slab → its hit t: the entry face when beyond T_MIN,
        // else the exit face
        const auto box_hit = [&](int q, float tmn, float tmx) {
          const float t_p = tmn > T_MIN ? tmn : tmx;
          // STATS, the DDA row (pallas_tracer.py:1927-1938): the ray
          // crosses the member's AABB inside its window, before its best
          // hit so far: the visit set of a per-ray grid DDA
          if (STATS == 1 && dda != nullptr && tmx > fmaxf(tmn, T_MIN) &&
              tmn < t_d)
            ++cross_b;
          if (tmx > tmn && t_p > T_MIN && t_p < t_d) {
            t_d = t_p;
            wb = q;
          }
        };
        // a grid's y_lo plane and z pitch, once a segment
        float t_ylo = 0.0f, dwz = 0.0f;
        cull_table(s_root, bsup, n_bsup, bleaf, n_bleaf, n_box, ox, oy, oz,
                   inv_dx, inv_dy, inv_dz, t_d,
                   [&](int start, int cnt, float txmn, float txmx) {
          if (STATS == 1) tests_b += (uint32_t)cnt;
          if (GRID) {
            // the strip pass (pallas_tracer.py:1947-2024): a member of a
            // grid strip takes the leaf's x slab (its own planes' bits; a
            // flat scan reads them from the row), the shared y_lo plane,
            // its y_hi plane, its z entry and the incremental z exit;
            // (y_hi, z_lo) one 8-byte shared load where the grid's table
            // sits in shared memory, else two reads of the row
            for (int q = start; q < start + cnt; ++q) {
              const float* r = box + (size_t)q * REC;
              if (n_bleaf == 0) {
                const float t0 = (__ldg(r + R_C0) - ox) * inv_dx,
                            t1 = (__ldg(r + R_DC) - ox) * inv_dx;
                txmn = fminf(t0, t1);
                txmx = fmaxf(t0, t1);
              }
              const float2 g = LEAF_SMEM
                                   ? s_grid[q]
                                   : make_float2(__ldg(r + R_DC + 1),
                                                 __ldg(r + R_C0 + 2));
              const float th = (g.x - oy) * inv_dy;
              const float tz0 = (g.y - oz) * inv_dz;
              const float tz1 = tz0 + dwz;
              box_hit(q,
                      fmaxf(fmaxf(fminf(t_ylo, th), txmn), fminf(tz0, tz1)),
                      fminf(fminf(fmaxf(t_ylo, th), txmx), fmaxf(tz0, tz1)));
            }
            return;
          }
          for (int q = start; q < start + cnt; ++q) {
            // merged cube (reference src/cube.rs:20-74): one slab test
            const float* r = box + (size_t)q * REC;
            float tmn, tmx, sxmn, sxmx;
            slab(__ldg(r + R_C0), __ldg(r + R_C0 + 1), __ldg(r + R_C0 + 2),
                 __ldg(r + R_DC), __ldg(r + R_DC + 1), __ldg(r + R_DC + 2),
                 ox, oy, oz, inv_dx, inv_dy, inv_dz, tmn, tmx, sxmn, sxmx);
            box_hit(q, tmn, tmx);
          }
        }, [&] {
          if (GRID) {
            t_ylo = (grid_ylo - oy) * inv_dy;
            dwz = grid_w * inv_dz;
          }
        });
        const float t_box = t_d;
        int wd = -1;
        cull_table(s_root + 6, sup, n_sup, leaf, n_leaf, n_dyn, ox, oy, oz,
                   inv_dx, inv_dy, inv_dz, t_d,
                   [&](int start, int cnt, float, float) {
          if (STATS == 1) tests_s += (uint32_t)cnt;
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
        }, [] {});
        if (wd >= 0) {
          // winner resolve: normal (o + t·d − c(time))·inv_r, then the
          // flip (pallas_tracer.py:2097-2148)
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
        } else if (wb >= 0) {
          // box winner resolve: the face whose slab t on the chosen side
          // (entry beyond T_MIN, else exit) equals t, ties x → y → z; the
          // normal +axis like the reference's rects, then the flip
          // (pallas_tracer.py:2110-2150)
          const float* r = box + (size_t)wb * REC;
          const float t0x = (r[R_C0] - ox) * inv_dx,
                      t1x = (r[R_DC] - ox) * inv_dx;
          const float t0y = (r[R_C0 + 1] - oy) * inv_dy,
                      t1y = (r[R_DC + 1] - oy) * inv_dy;
          const float t0z = (r[R_C0 + 2] - oz) * inv_dz,
                      t1z = (r[R_DC + 2] - oz) * inv_dz;
          const bool use_en =
              fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                    fminf(t0z, t1z)) > T_MIN;
          const float tx_c = use_en ? fminf(t0x, t1x) : fmaxf(t0x, t1x);
          const float ty_c = use_en ? fminf(t0y, t1y) : fmaxf(t0y, t1y);
          const bool is_x = t_box == tx_c;
          const bool is_y = t_box == ty_c && t_box != tx_c;
          const float flip = r[R_FLIP];
          nbx = (is_x ? 1.0f : 0.0f) * flip;
          nby = (is_y ? 1.0f : 0.0f) * flip;
          nbz = (is_x || is_y ? 0.0f : 1.0f) * flip;
          t_best = t_box;
          w_dyn = r;
        }
      }

      // the nearest medium scatter event on [T_MIN, closest surface]
      // takes the hit over: isotropic, the medium's albedo, no emission
      // (pallas_tracer.py:2204-2266); none on a segment the walk handed
      // over. A walk bounce takes any event (its cap is the nearest
      // interior row); with none the walk ends, and the next iteration
      // traces the same segment against the whole scene with no medium
      // event
      if (media && !skip_med) {
        const float t_med =
            media_race(s_med, n_med, med_box, ox, oy, oz, dx, dy, dz, a_dd,
                       inv_a, t_best, pix, sample, (uint32_t)bounce, k0, k1,
                       m_ev);
        if (MEDIA_TWICE) {
          // the timing build's second race: its cap passes through an asm
          // the compiler cannot see through, so the race is not merged with
          // the first, and its result into an asm it must keep
          float cap = t_best;
          asm volatile("" : "+f"(cap));
          int m2;
          const float t2 = media_race(s_med, n_med, med_box, ox, oy, oz, dx,
                                      dy, dz, a_dd, inv_a, cap, pix, sample,
                                      (uint32_t)bounce, k0, k1, m2);
          asm volatile("" ::"f"(t2), "r"(m2));
        }
        if (walk_bounce ? t_med < BIG : t_med < t_best) {
          med_event = true;
          t_best = t_med;
        }
      }
      skip_med = false;
      if (walk_bounce && !med_event) {
        skip_med = true;
        walking = false;
        seg = false;
      }
    }
    // K1c: the marble's turbulence, for the threads whose segment shades
    // with it (a marble albedo below the cap, a marble light, a marble
    // medium's event under med_tex: at most one a segment), at the point
    // part B shades, by the whole warp (`warp_turb`)
    float turb = 0.0f;
    if (noise) {
      bool need = false;
      float qx = 0.0f, qy = 0.0f, qz = 0.0f;
      if (seg && (win >= 0 || (DYN && w_dyn != nullptr) || med_event)) {
        qx = ox + t_best * dx;
        qy = oy + t_best * dy;
        qz = oz + t_best * dz;
        if (med_event) {
          need = med_tex && s_med[m_ev * MEDREC + M_ALB + T_NOISE] > 0.0f &&
                 bounce < max_depth;
        } else {
          const float* w = DYN && w_dyn != nullptr ? w_dyn : s_rec + win * REC;
          need = w[R_ALB + T_NOISE] > 0.0f &&
                 (w[R_MAT] == MAT_DIFFUSE_LIGHT ? emis_tex
                                                : bounce < max_depth);
        }
      }
      turb = warp_turb(need, qx, qy, qz, perlin_word);
    }
    if (seg) {
      const uint32_t sample = (uint32_t)(sample0 + si);
      // part B; a break ends the path
      live = false;
      do {
        if (win < 0 && !(DYN && w_dyn != nullptr) && !med_event) {
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
        // the winner's record row, in shared (unrolled) or device (box,
        // dynamic) memory; not read after a medium event
        const float* w = DYN && w_dyn != nullptr ? w_dyn : s_rec + win * REC;
        // the value at the hit point p of the texture whose fields start at
        // t (a record row's R_ALB or a medium's M_ALB: the same T_* columns):
        // its colour; where sin(10x)·sin(10y)·sin(10z) < 0 a checker's odd
        // colour (reference src/texture.rs:40-47); the marble (66-70); the
        // nearest texel (86-108, clamped to the image's true size, v flipped,
        // one read of the packed atlas) at the winner's UV: a medium's
        // u = v = 0 (src/medium.rs:44-50), an image rect's in its world
        // frame from t_best as the closest-hit loop computes its position
        // (pallas_tracer.py:1719-1735), else the sphere UV (src/sphere.rs:
        // 7-15; `_atan2`/`_asin` are the math library's here) of the normal
        // before the flip (2312-2317)
        auto texture = [&](const float* t, float px, float py, float pz,
                           float& r, float& g, float& b) {
          r = t[T_ALB];
          g = t[T_ALB + 1];
          b = t[T_ALB + 2];
          if (checker && t[T_CHK] > 0.0f) {
            const float sines =
                sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
            if (sines < 0.0f) {
              r = t[T_ODD];
              g = t[T_ODD + 1];
              b = t[T_ODD + 2];
            }
          }
          if (noise && t[T_NOISE] > 0.0f) {
            // marble, 0.5·(1 + sin(scale·x + 5·turb(p)))
            r = g = b = 0.5f * (1.0f + sinf(t[T_NSCALE] * px + 5.0f * turb));
          }
          if (image && t[T_IMG] > 0.0f) {
            float uu = 0.0f, vv = 0.0f;
            if (!med_event && uv_carry && w[R_IS_SPHERE] == 0.0f) {
              const float xa = (ox * w[R_AN] + oy * w[R_AN + 1] +
                                oz * w[R_AN + 2]) +
                               t_best * (dx * w[R_AN] + dy * w[R_AN + 1] +
                                         dz * w[R_AN + 2]) -
                               w[R_AOFF];
              const float yb = (ox * w[R_BN] + oy * w[R_BN + 1] +
                                oz * w[R_BN + 2]) +
                               t_best * (dx * w[R_BN] + dy * w[R_BN + 1] +
                                         dz * w[R_BN + 2]) -
                               w[R_BOFF];
              uu = (xa - w[R_A0]) * (1.0f / (w[R_A1] - w[R_A0]));
              vv = (yb - w[R_B0]) * (1.0f / (w[R_B1] - w[R_B0]));
            } else if (!med_event) {
              float nux = nbx, nuy = nby, nuz = nbz;
              if (img_flip) {
                const float fl = w[R_FLIP];
                nux = nbx * fl;
                nuy = nby * fl;
                nuz = nbz * fl;
              }
              const float phi = atan2f(nuz, nux);
              const float theta = asinf(fminf(fmaxf(nuy, -1.0f), 1.0f));
              uu = 1.0f - (phi + PI_F) * INV_2PI;
              vv = (theta + (compat_uv ? TWO_OVER_PI : HALF_PI)) * INV_PI;
            }
            const float iw = t[T_IMG_W], ih = t[T_IMG_H];
            const int ii = min(max((int)(uu * iw), 0), (int)iw - 1);
            const int jj = min(max((int)((1.0f - vv) * ih), 0), (int)ih - 1);
            const int jrow =
                min(max((int)t[T_IMG_BASE] + jj, 0), atlas_rows - 1);
            const int texel = __ldg(atlas + (size_t)jrow * atlas_w +
                                    min(max(ii, 0), atlas_w - 1));
            r = (float)((texel >> 16) & 255) / 255.0f;
            g = (float)((texel >> 8) & 255) / 255.0f;
            b = (float)(texel & 255) / 255.0f;
          }
        };
        float mat = MAT_ISOTROPIC;
        if (!med_event) {
          // emission (reference src/color.rs:8-22): a light's colour, or a
          // textured light's texture value (src/material.rs:133-151); solid
          // lights keep this cheap path
          float er = w[R_EMIT], eg = w[R_EMIT + 1], eb = w[R_EMIT + 2];
          if (emis_tex && w[R_MAT] == MAT_DIFFUSE_LIGHT &&
              (w[R_CHECKER] > 0.0f || w[R_NOISE] > 0.0f || w[R_IMG] > 0.0f))
            texture(w + R_ALB, ox + t_best * dx, oy + t_best * dy,
                    oz + t_best * dz, er, eg, eb);
          rad_r += thr_r * er;
          rad_g += thr_g * eg;
          rad_b += thr_b * eb;
          mat = w[R_MAT];
        }
        // a light does not scatter; scatter only below the depth cap
        // (src/color.rs:9)
        if (mat == MAT_DIFFUSE_LIGHT || bounce >= max_depth) break;
        const float px = ox + t_best * dx, py = oy + t_best * dy,
                    pz = oz + t_best * dz;
        // the albedo: the winner's texture at the hit point, or at a medium
        // event the medium's (pallas_tracer.py:2237-2266): its colour, or
        // under med_tex its texture. K1B takes it here, before the scatter
        // draws (taken after them, ptxas gave K1B 80 registers and final_scene
        // ran 10% slower on an H100); K1a after the scatter, where its SASS
        // has always taken it
        float alb_r, alb_g, alb_b;
        auto albedo = [&]() {
          if (med_event && !med_tex) {
            alb_r = s_med[m_ev * MEDREC + M_ALB];
            alb_g = s_med[m_ev * MEDREC + M_ALB + 1];
            alb_b = s_med[m_ev * MEDREC + M_ALB + 2];
          } else {
            texture(med_event ? s_med + m_ev * MEDREC + M_ALB : w + R_ALB, px,
                    py, pz, alb_r, alb_g, alb_b);
          }
        };
        if (K1B) albedo();
        // lambertian: n + a uniform point in the unit ball
        // (reference src/material.rs:49-53; ops/rng.in_unit_sphere)
        const Uniforms us =
            philox(pix, sample, (uint32_t)bounce, STREAM_SCATTER, k0, k1);
        float bx, by, bz;
        ball(us, bx, by, bz);
        float ndx = nbx + bx, ndy = nby + by, ndz = nbz + bz;
        if (med_event) {
          // isotropic: the bare ball sample (reference src/material.rs:164-168)
          ndx = bx;
          ndy = by;
          ndz = bz;
        }
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
        if (!K1B) albedo();
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
        if (rr && bounce >= rr_depth) {
          // Russian roulette (pallas_tracer.py:2492-2506; not in the
          // reference): the path survives with q = max(thr) clipped to
          // [0.05, 1], word 0 of (pixel, sample, bounce, ROULETTE), and a
          // survivor's throughput is multiplied by 1/q
          const float q =
              fminf(fmaxf(fmaxf(thr_r, fmaxf(thr_g, thr_b)), 0.05f), 1.0f);
          const float u_rr = philox(pix, sample, (uint32_t)bounce,
                                    STREAM_ROULETTE, k0, k1).x;
          if (!(u_rr < q)) break;
          const float inv_q = 1.0f / q;
          thr_r = thr_r * inv_q;
          thr_g = thr_g * inv_q;
          thr_b = thr_b * inv_q;
        }

        // a scatter in a dense sealed medium, below the cap, starts the
        // walk or goes on with it: the next iteration is a walk bounce
        walking = dense_walk && med_event && ((dense >> m_ev) & 1) &&
                  bounce + 1 < max_depth;
        ++bounce;
        live = true;
      } while (false);
      if (!live) {
        // the path ended: its radiance joins the pixel's sums in sample
        // order; after the pixel's last sample they are written
        acc_r += (double)rad_r;
        acc_g += (double)rad_g;
        acc_b += (double)rad_b;
        if (++si == n_samples) {
          if (STATS != 2) {
            sums[pix] = acc_r;
            sums[n_pix + pix] = acc_g;
            sums[2 * n_pix + pix] = acc_b;
          }
          if (STATS == 1) {
            stats[pix] += busy;
            stats[n_pix + pix] += tests_s;
            stats[2 * n_pix + pix] += tests_b;
            if (dda != nullptr) dda[pix] += cross_b;
          }
          if (STATS == 2) {
            // the probe: the pixel's segments, from each of its parts
            atomicAdd((unsigned long long*)(stats + pix),
                      (unsigned long long)busy);
          }
          if (STATS) total += busy;
        }
      }
    }
  }
  // STATS: a thread is live in every iteration until its list is done,
  // and each of those iterations is a segment or a walk bounce, so the
  // warp's iterations are the largest segment total among its 32 threads
  // (walk bounces counted), its steps; a padding thread joins with 0. The
  // probe writes them only when asked (its one pixel a thread: total is
  // that pixel's part of the segments)
  if (STATS) {
    const uint32_t steps = __reduce_max_sync(0xffffffffu, total);
    if ((threadIdx.x & 31) == 0) {
      if (STATS == 1) stats[3 * (size_t)n_pix + tid / 32] += steps;
      if (STATS == 2 && probe_steps != nullptr) probe_steps[tid / 32] += steps;
    }
  }
}

using TraceFn = void (*)(const float*, int, const int*, int, const float*,
                         int, const float*, int, const float*, int, double*,
                         int, int, uint32_t, uint32_t, int, int, int,
                         const float*, int, int, const int*, int, int,
                         uint32_t, const float*, int, const float*, int,
                         const float*, int, const int*, int, int, const int*,
                         int, long long*, long long*, const float*, int,
                         const float*, int, int, long long*, float, float);

// The instantiations a launch may run, each with its code, K1B | (DYN > 0)
// << 1 | LEAF_SMEM << 2 | STATS << 3 | MED << 5 | (DYN == 2) << 6
// (ops/tracer.py `instantiation_name`; `K1_INSTANTIATIONS` lists the same
// flags)
struct Pick {
  TraceFn fn;
  int code;
};

int code(int k1b, int dyn, int leaf_smem, int stats, int med) {
  return k1b | (dyn > 0) << 1 | leaf_smem << 2 | stats << 3 | med << 5 |
         (dyn == 2) << 6;
}

template <bool K1B, int DYN, bool LEAF_SMEM, int STATS, bool MED>
Pick inst() {
  return {trace_k1<K1B, DYN, LEAF_SMEM, STATS, MED>,
          code(K1B, DYN, LEAF_SMEM, STATS, MED)};
}

// Without a dynamic table there is no leaf table. The production
// instantiations: K1a (cornell_box, with or without roulette), K1a's code
// with the media (media alone, no table: cornell_smoke), the tables with no
// feature, K1B without and with the media (no table: two_spheres, earth,
// two_perlin_spheres, simple_light; the lattice), the tables without their
// leaves in shared memory (every section: MED set), the tables with them
// without and with the media (random_spheres; final_scene). K1f's
// counters ride in instantiations of their own, K1B, DYN and MED with
// every section a runtime branch, so they serve every scene and leave the
// production kernels' registers as they were: the stats launch's and the
// cost probe's. A box grid (final_scene) runs DYN 2 with K1B and MED: its
// production launch, with and without its leaves in shared memory, and
// its counters.
const Pick INSTANTIATIONS[] = {
    inst<false, 0, false, 0, false>(), inst<false, 0, false, 0, true>(),
    inst<false, 1, false, 0, false>(), inst<false, 1, true, 0, false>(),
    inst<true, 0, false, 0, false>(),  inst<true, 0, false, 0, true>(),
    inst<true, 1, false, 0, true>(),   inst<true, 1, true, 0, false>(),
    inst<true, 1, true, 0, true>(),    inst<true, 1, false, 1, true>(),
    inst<true, 1, true, 1, true>(),    inst<true, 1, false, 2, true>(),
    inst<true, 1, true, 2, true>(),    inst<true, 2, false, 0, true>(),
    inst<true, 2, true, 0, true>(),    inst<true, 2, false, 1, true>(),
    inst<true, 2, true, 1, true>(),    inst<true, 2, false, 2, true>(),
    inst<true, 2, true, 2, true>()};

// The instantiation a launch runs (fn null where none has the flags): the
// counters run K1B, DYN and MED, and so do a K1B table launch whose leaves
// are not in shared memory and a box grid (dyn 2)
Pick pick(int k1b, int dyn, int leaf_smem, int stats, int med) {
  const bool grid = dyn == 2;
  k1b = k1b != 0 || stats != 0 || grid;
  dyn = grid ? 2 : (dyn != 0 || stats != 0);
  leaf_smem = leaf_smem != 0 && dyn;
  med = med != 0 || stats != 0 || grid || (k1b && dyn && !leaf_smem);
  const int c = code(k1b, dyn, leaf_smem, stats, med);
  for (const Pick& p : INSTANTIATIONS)
    if (p.code == c) return p;
  return {nullptr, c};
}

}  // namespace

// Adds the radiance of samples [sample0, sample0 + n_samples) of every
// pixel to sums (f64[3, nx·ny]). feats: ops/tracer.py FEAT_* bits.
// n_leaf = 0 scans the dynamic sphere table without the cull, n_bleaf = 0
// the box table; sups (f32[n_sup, CLUSW]) and bsups (n_bsup) are the
// tables' super rows, whose leaf ranges tile [0, n_leaf) and [0, n_bleaf)
// in ascending order (ops/tracer.py checks it); n_sup = 0 culls the
// sphere leaves behind the root alone, and so does n_bsup = 0 the box
// leaves. med: f32[n_med, MEDREC], bit i of med_box set for a box
// boundary, bit i of dense for a medium the walk serves; atlas:
// int32[atlas_rows, atlas_w] packed texels; perlin_word: (perlin seed ·
// HSEED) mod 2^32; box: f32[n_box, REC], with grid = 1 a regular grid in
// strip layout (ops/tracer.py `TraceOperands.grid`: one y_lo, grid_ylo,
// and one f32 z width, grid_w), run by the strip pass; interior:
// f32[n_int, REC] with interior_kind int32[n_int] (ops/tracer.py INT_*);
// rr_depth: the first bounce of Russian roulette, ≥ 0 exactly when FEAT_RR
// is set (never with the walk). pix_table: null, and thread i renders
// pixel i; or int32[n_table] (n_table a multiple of kpix·TILE), and thread
// j of tile g renders the pixels pix_table[(g·kpix + b)·TILE + j], b < kpix, a slot outside
// [0, nx·ny) none (K1f); a pixel named twice races with itself. stats:
// null, or int64[3·nx·ny + threads / 32] to which the launch adds per
// pixel its segments, its dynamic sphere member tests and its box member
// tests (three rows), then per warp the largest of its threads' segment
// totals over their banks and samples; threads = n_table / kpix with a
// table, else nx·ny rounded up to THREADS. dda (with stats only): the
// buffer holds nx·ny more entries, to which the launch adds per pixel its
// box member tests whose AABB the ray crosses before its best hit so far.
// probe_split ≥ 1: the cost probe's launch instead (no pix_table, no dda;
// n_samples a multiple of probe_split; sums unread and unwritten, may be
// null): stats is int64[nx·ny], to which it adds each pixel's segments, on
// probe_split × (tiles of TILE_W × TILE_H) blocks; probe_steps, when not
// null, int64[those blocks × THREADS / 32], to which it adds per warp the
// largest of its threads' segments. Launches on `stream`; returns
// cudaGetLastError() after the launch, and when it is 0 and inst is not
// null writes there the instantiation that ran (`Pick::code`).
extern "C" int rt_trace_k1(const float* rec, int n_rec, const int* walk,
                           int n_walk, const float* dyn, int n_dyn,
                           const float* leaves, int n_leaf, const float* sups,
                           int n_sup, const float* cam,
                           int feats, double* sums, int nx, int ny,
                           uint32_t seed_lo, uint32_t seed_hi, int sample0,
                           int n_samples, int max_depth, const float* med,
                           int n_med, int med_box, const int* atlas,
                           int atlas_rows, int atlas_w, uint32_t perlin_word,
                           const float* box, int n_box, const float* bleaves,
                           int n_bleaf, const float* bsups, int n_bsup,
                           int grid, float grid_ylo, float grid_w,
                           const float* interior, int n_int,
                           const int* interior_kind, int dense,
                           int rr_depth, const int* pix_table, int n_table,
                           int kpix, int probe_split, long long* probe_steps,
                           long long* stats, int dda, int* inst,
                           void* stream) {
  const bool probe = probe_split > 0;
  if (n_rec <= 0 || n_rec > MAX_PRIMS || n_walk < 0 || n_walk > n_rec ||
      n_dyn < 0 || n_leaf < 0 || feats < 0 || feats > FEAT_ALL ||
      n_med < 0 || n_med > MAX_MEDIA || ((feats & FEAT_MEDIA) != 0) !=
      (n_med > 0) || ((feats & FEAT_IMAGE) &&
                      (atlas_rows <= 0 || atlas_w <= 0)) ||
      n_box < 0 || n_bleaf < 0 || n_int < 0 || n_int > MAX_INTERIOR ||
      ((feats & FEAT_DENSE_WALK) && (n_int == 0 || dense == 0 ||
                                     !(feats & FEAT_MEDIA))) ||
      ((feats & FEAT_RR) != 0) != (rr_depth >= 0) ||
      ((feats & FEAT_RR) && (feats & FEAT_DENSE_WALK)) || kpix < 1 ||
      (pix_table == nullptr ? kpix != 1
                            : n_table <= 0 || n_table % (kpix * TILE) != 0) ||
      (dda && stats == nullptr) || n_sup < 0 || n_bsup < 0 ||
      grid < 0 || grid > 1 || (grid && (n_box <= 0 || !(grid_w > 0.0f))) ||
      probe_split < 0 ||
      (probe ? pix_table != nullptr || dda || stats == nullptr ||
                   n_samples % probe_split != 0
             : probe_steps != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_dyn == 0) n_leaf = 0;
  if (n_box == 0) n_bleaf = 0;
  if (n_leaf == 0) n_sup = 0;
  if (n_bleaf == 0) n_bsup = 0;
  // a table runs in a DYN instantiation (zero-trip table loops without
  // tables), the counters in their own, media in a MED one; roulette and
  // media with no other feature and no table in a static instantiation
  // (K1a's code)
  const bool dyn_inst = stats != nullptr || n_dyn > 0 || n_box > 0 ||
                        pix_table != nullptr;
  const bool k1b = stats != nullptr ||
                   (feats & ~(FEAT_RR | FEAT_MEDIA)) != 0 ||
                   (feats != 0 && dyn_inst);
  const size_t base =
      sizeof(float) * (n_rec * REC + CAMREC + (dyn_inst ? 12 : 0) +
                       n_med * MEDREC + n_int * REC) +
      sizeof(int) * (2 * n_walk + 3 * n_int);
  // the leaf tables, and a box grid's (y_hi, z_lo) table
  const size_t leaf_bytes =
      sizeof(float) * ((size_t)(n_leaf + n_sup + n_bleaf + n_bsup) * CLUSW +
                       (grid ? 2 * (size_t)n_box : 0));
  const bool leaf_smem = n_leaf + n_bleaf > 0 &&
                         base + leaf_bytes <= SMEM_BUDGET;
  const size_t smem = base + (leaf_smem ? leaf_bytes : 0);
  const int n_pix = nx * ny;
  const int n_tiles =
      ((nx + TILE_W - 1) / TILE_W) * ((ny + TILE_H - 1) / TILE_H);
  const int blocks = probe ? probe_split * n_tiles
                     : pix_table != nullptr ? n_table / kpix / THREADS
                                            : (n_pix + THREADS - 1) / THREADS;
  const Pick k = pick(k1b, grid ? 2 : dyn_inst, leaf_smem,
                      stats == nullptr ? 0 : probe ? 2 : 1, n_med > 0);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  k.fn<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      rec, n_rec, walk, n_walk, dyn, n_dyn, leaves, n_leaf, cam, feats, sums,
      nx, ny, seed_lo, seed_hi, sample0, n_samples, max_depth, med, n_med,
      med_box, atlas, atlas_rows, atlas_w, perlin_word, box, n_box, bleaves,
      n_bleaf, interior, n_int, interior_kind, dense, rr_depth, pix_table,
      kpix, stats,
      dda ? stats + 3 * (size_t)n_pix + (size_t)blocks * THREADS / 32
          : nullptr,
      sups, n_sup, bsups, n_bsup, probe ? probe_split : 1, probe_steps,
      grid_ylo, grid_w);
  const int err = (int)cudaGetLastError();
  if (err == 0 && inst != nullptr) *inst = k.code;
  return err;
}

// The blocks of THREADS threads of one instantiation that an SM holds
// without dynamic shared memory (the records take a few KB of the SM's
// 228 KB, so registers decide), by the runtime's occupancy query, into
// *blocks: the instantiation trace_k1<k1b, dyn, leaf_smem, stats, med>.
// Returns the cudaError (cudaErrorInvalidValue where no instantiation has
// those flags).
extern "C" int rt_trace_k1_blocks_per_sm(int k1b, int dyn, int leaf_smem,
                                         int stats, int med, int* blocks) {
  if (k1b < 0 || k1b > 1 || dyn < 0 || dyn > 2 || leaf_smem < 0 ||
      leaf_smem > 1 || stats < 0 || stats > 2 || med < 0 || med > 1)
    return (int)cudaErrorInvalidValue;
  const Pick k = pick(k1b, dyn, leaf_smem, stats, med);
  if (k.fn == nullptr || k.code != code(k1b, dyn, leaf_smem, stats, med))
    return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k.fn, THREADS, 0);
}
