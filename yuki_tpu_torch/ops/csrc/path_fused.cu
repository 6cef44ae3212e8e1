// Dense path-tracing wave kernels for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/path_fused.py's three Pallas kernels.
//
//   yk_raygen_trace  replaces _raygen_trace_kernel (path_fused.py:517, body
//                    _raygen_values :451): pixel hash + jitter, camera ray,
//                    closest hit over every triangle and sphere, through a
//                    camera sweep of its own (below).
//   yk_bounce        replaces _bounce_kernel (path_fused.py:709, body
//                    _bounce_values :543 + shade_fused._shade_body :360):
//                    one whole bounce, including the NEE occlusion sweeps and
//                    the next ray's closest hit.  Its first port ran one
//                    thread per lane in film order; this is its redesign
//                    for the card (PERF.md §6 records the change and its
//                    measurements).
//   yk_wave          replaces _wave_kernel (path_fused.py:788): raygen and
//                    every bounce of one sample in one launch, writing only
//                    radiance and the ray count.  Its first port kept the
//                    path state in registers, one thread a lane in film
//                    order; this is its redesign for the card (below).
//
// The bodies are device functions that the kernels share: camera_dir and
// camera_sweep (raygen, wave), bounce_lane (bounce, wave) with its
// closest-hit sweep trace_scene, whose bits camera_sweep gives for a
// camera ray; so the one-kernel wave gives the two-kernel wave's bits.
// Each takes a StratifiedSampler's values as planes computed
// beforehand (the TPU kernels' `strat` variants) where the caller passes
// them, else the uniform sampler's hash.
//
// What bounds them on this card: the per-ray sweeps are O(T) triangle tests
// (Cornell: 36 for the closest hit and 36 per light for occlusion) and the
// shading body, all ALU work on registers, issued by the SMs; the state
// round trip of a bounce is 2 x 96 B per ray.  The JAX kernels specialise on
// static scene facts (light types, material families, sigma, clamp,
// textures); these kernels take them at run time and branch per lane, which
// gives the same value on every lane because a lane only ever selects a lobe
// or light type the scene holds.  One thread runs one lane.  The first
// port's bounce kernel read every triangle's 12 floats and every shadow
// test's light id from global memory, and ran the lanes in film order: a
// warp held dead, missed and live lanes of every material, so it paid each
// branch of the shading body and the longest sweep of any of its lanes (at
// bounces 1-4 the same kernel on lanes grouped by material took 0.43-0.63x
// the time).
//
// Design (the redesign).
// - Scene tables in shared memory, staged by every block of all three
//   kernels, which read them the same way: the triangle rows [T, 12] as
//   float4s (48 KB at the wave's gate of 1024 triangles), the spheres' test
//   rows (world_to_obj's first three rows and the radius, four float4s), and
//   the triangles' area-light ids as ints, so a shadow test reads one shared
//   int.  A sweep's lanes read the same triangle at once: a broadcast.  The
//   shading rows stay in global memory (one row a lane).
// - Material-coherent lanes in the bounce kernel: a block of 256 threads
//   takes a tile of TILE = 512 lanes and sorts them with a stable counting
//   sort in shared memory, by class: dead, missed, then the hit's material
//   type (matte, glass, metal, glossy) and surface (triangle or sphere).
//   Thread t then runs lane perm[p] of the tile for its positions p: it
//   loads that lane's state, reads its hash `ph` and its sampler planes at
//   the lane's own index, and writes its outputs there.  Warps of dead
//   lanes skip the sweeps together, and a warp shades one BSDF branch.  A
//   lane's arithmetic is unchanged, so every output plane keeps its bits.
// - The raygen kernel's camera sweep (redesigned after the bounce; PERF.md
//   §6).  Camera rays share their origin (a pinhole), so each block
//   stages the triangles already translated by it (the same c - o
//   subtraction, the same bits) in a copy permuted for each shear frame
//   its rays need (one __syncthreads_or a frame: a block whose rays share
//   a dominant axis stages one copy), and the spheres' object-space origin
//   ro and c = |ro|^2 - r^2, computed once in the same operation order.  A
//   test then makes no translation and no coordinate select, and its
//   divide and t, b0, b1 only where the sign, det and range tests pass
//   (the sweep reads them nowhere else).  A block of CAM_THREADS = 256
//   rays shares one stage (128 to 512 threads and 1 to 4 rays a thread
//   measured within a few percent, 4 rays slower; PERF.md §6).
//   Bound: ALU, ~30 operations a triangle test and ~38 a sphere test,
//   beside the 108 B of state and hash each ray writes.
// - The wave kernel (redesigned after the raygen kernel; PERF.md §6) runs
//   the two kernels' bodies on a tile of WAVE_TILE = 1024 lanes a block of
//   WAVE_THREADS = 256.  The tile's path state lives in shared memory from
//   raygen to its last bounce ([24][WAVE_TILE] floats, as load_state and
//   store_state lay it out, and each lane's ph), so lanes can move between
//   threads: raygen is the camera sweep above, its copies staged where the
//   scene's tables go next (one copy at a time where three would keep a
//   second block off the SM), and each bounce sorts the tile's live lanes
//   by class as the bounce kernel does, dead lanes out of the order, and
//   ends the loop when none is left.  A lane reads its sampler planes at
//   its own index and its arithmetic is unchanged, so every output keeps
//   its bits.  The state never goes through device memory (the two-kernel
//   wave moves 2 x 96 B a lane a bounce).  1024-lane tiles of 256 threads
//   measured fastest of the shapes that fit the gate's tables (128-512
//   threads, 256-2048 lanes; PERF.md §6): at the gate a block takes ~158
//   KB, one an SM, and at Cornell's size ~110 KB, two.
// - Grids: one ray a thread (raygen) and one tile a block (bounce, wave),
//   so the card schedules blocks as they finish.  A persistent grid, which
//   stages the tables once per block, measured slower here: the tables of
//   a Cornell-sized scene take 2 KB, and its blocks' uneven work left SMs
//   idle at the end (PERF.md §6).
// - Registers: __launch_bounds__(256, 2) caps them at 128; the bounce
//   kernel takes 108 and the wave kernel 103, and neither spills (the
//   first port's bounce took 96 with 24 B of spills).  For the bounce
//   kernel, 256 threads and 512-lane tiles measured fastest over
//   bounces 0-4 among 128-384 threads and 384-2048 lanes.
// - In the two-kernel wave, state crosses bounces as [24, N] float planes
//   (plane-major).
//
// Numerics: compiled with -fmad=false and without fast-math, so products,
// sums, divisions and square roots round exactly as in the JAX and PyTorch
// versions; only the transcendentals (logf, sinf, cosf) may differ by ulps.

#include <cuda_runtime.h>

#include <cstdint>

#include "path_fused.cuh"

using namespace yk;

// The block's dynamic shared memory: the staged scene (or the camera
// sweep's copies), then the bounce and wave kernels' tile buffers.
extern __shared__ float4 smem[];

namespace {

constexpr int ST_OX = 0, ST_OY = 1, ST_OZ = 2, ST_DX = 3, ST_DY = 4, ST_DZ = 5;
constexpr int ST_BX = 6, ST_BY = 7, ST_BZ = 8, ST_RX = 9, ST_RY = 10, ST_RZ = 11;
constexpr int ST_ALIVE = 12, ST_SPEC = 13, ST_RC = 14;
constexpr int ST_T = 15, ST_B0 = 16, ST_B1 = 17, ST_PRIM = 18, ST_SPH = 19, ST_HITF = 20;
constexpr int ST_PAD0 = 21, ST_PAD1 = 22, ST_PAD2 = 23;

constexpr int MS_R2C = 0, MS_C2W = 16, MS_CENTER = 32, MS_DIAG = 35, MS_BG = 36, MS_CLAMP = 39;

constexpr int FLAG_SIGMA = 1, FLAG_CLAMP = 2, FLAG_TEX = 4;

constexpr int CAM_THREADS = 256;  // raygen kernel
constexpr int BOUNCE_THREADS = 256;  // bounce kernel
constexpr int BOUNCE_MIN_BLOCKS = 2;  // its blocks per SM: at most 128 registers
constexpr int TILE = 512;  // lanes the bounce kernel sorts together
constexpr int BOUNCE_WARPS = BOUNCE_THREADS / 32;
constexpr int PER_THREAD = TILE / BOUNCE_THREADS;
constexpr int N_CLASSES = 10;  // dead, missed, 4 material types x 2 surfaces
constexpr int WAVE_THREADS = 256;  // wave kernel
constexpr int WAVE_MIN_BLOCKS = 512 / WAVE_THREADS;  // at most 128 registers
constexpr int WAVE_TILE = 1024;  // lanes of a wave block, sorted together each bounce
constexpr int WAVE_PER_THREAD = WAVE_TILE / WAVE_THREADS;
// Shared memory a wave block may take for two of them to fit on an SM: its
// 228 KB less 1 KB reserved a block, halved.
constexpr size_t WAVE_SHARED_TWO = 113 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// The scene's tables in device memory, as the wrapper passes them.
struct SceneSrc {
  const float* __restrict__ tri;  // [T, 12] packed corners
  const float* __restrict__ trs;  // [T, 32] shading rows (column 27: area light)
  int n_tris;
  const float* __restrict__ sp;  // [S, 40] sphere rows
  int n_spheres;
};

// Bytes of shared memory the staged scene takes.
__host__ __device__ inline size_t scene_bytes(int n_tris, int n_spheres) {
  return (size_t)n_tris * 48 + (size_t)n_spheres * 64 + (((size_t)n_tris * 4 + 15) / 16) * 16;
}

// The sweeps' tables, staged in shared memory by stage_scene: the triangle
// rows [T][3] float4s, the sphere test rows [S][4] float4s (world_to_obj
// rows 0-2, then the radius), each triangle's area light [T] ints (-1 for
// none).  The addresses are computed from `smem` and the counts, so they
// take no registers and compile to shared-memory loads.
struct Scene {
  int n_tris, n_spheres;
  __device__ __forceinline__ const float4* tri(int i) const { return smem + 3 * i; }
  __device__ __forceinline__ const float4* sp(int s) const { return smem + 3 * n_tris + 4 * s; }
  __device__ __forceinline__ int light(int i) const {
    return ((const int*)(smem + 3 * n_tris + 4 * n_spheres))[i];
  }
  // The first byte past the tables.
  __device__ __forceinline__ void* end() const { return (char*)smem + scene_bytes(n_tris, n_spheres); }
};

// Stage the scene's tables by all threads of the block, then synchronise.
__device__ __forceinline__ Scene stage_scene(const SceneSrc& src) {
  const int T = src.n_tris, S = src.n_spheres;
  float* tri = (float*)smem;
  float* sp = (float*)(smem + 3 * T);
  int* light = (int*)(smem + 3 * T + 4 * S);
  for (int e = threadIdx.x; e < 12 * T; e += blockDim.x) tri[e] = __ldg(src.tri + e);
  for (int e = threadIdx.x; e < 16 * S; e += blockDim.x) {
    const int s = e >> 4, k = e & 15;
    sp[e] = k < 12 ? __ldg(src.sp + 40 * s + k) : (k == 12 ? __ldg(src.sp + 40 * s + 32) : 0.0f);
  }
  // Area-light ids are whole numbers stored as floats (-1 for none).
  for (int i = threadIdx.x; i < T; i += blockDim.x) light[i] = (int)__ldg(src.trs + 32 * i + 27);
  __syncthreads();
  return {T, S};
}

struct Hit {
  float t, b0, b1, prim, sph, hitf;
};

// Closest hit: triangles in index order (a later one wins only when strictly
// closer), then spheres (a sphere wins only when strictly closer than the
// triangle hit).  path_fused.py:108-207.
__device__ Hit trace_scene(const Scene& sc, V3 o, V3 d, float t_max) {
  Shear sh = make_shear(d);
  float t = t_max, b0 = 0.0f, b1 = 0.0f;
  int prim = -1;
  for (int i = 0; i < sc.n_tris; ++i) {
    float ti, bi0, bi1;
    bool hit = watertight_row(sh, o, t, sc.tri(i), ti, bi0, bi1);
    if (hit && ti < t) {
      t = ti;
      prim = i;
      b0 = bi0;
      b1 = bi1;
    }
  }
  int sph = -1;
  bool any = prim >= 0;
  if (sc.n_spheres > 0) {
    float best_t = YK_F32_MAX;
    int best_i = -1;
    for (int s = 0; s < sc.n_spheres; ++s) {
      bool hit;
      float ts = sphere_t(sc.sp(s), o, d, t_max, hit);
      if (hit && ts < best_t) {
        best_t = ts;
        best_i = s;
      }
    }
    bool sphere_wins = best_i >= 0 && best_t < t;
    any = any || sphere_wins;
    if (sphere_wins) {
      t = best_t;
      prim = -1;
      sph = best_i;
    }
  }
  return {t, b0, b1, (float)prim, (float)sph, any ? 1.0f : 0.0f};
}

// Occlusion: any triangle hit (skipping the area light `skip_id`'s own
// triangles) or any sphere hit.  path_fused.py:210.
__device__ bool occluded(const Scene& sc, int skip_id, V3 o, V3 d, float t_max) {
  Shear sh = make_shear(d);
  for (int i = 0; i < sc.n_tris; ++i) {
    float ti, bi0, bi1;
    bool hit = watertight_row(sh, o, t_max, sc.tri(i), ti, bi0, bi1);
    if (skip_id >= 0) hit = hit && sc.light(i) != skip_id;
    if (hit) return true;
  }
  for (int s = 0; s < sc.n_spheres; ++s) {
    bool hit;
    sphere_t(sc.sp(s), o, d, t_max, hit);
    if (hit) return true;
  }
  return false;
}

// ---- texture index (path_fused.py:424-443) -------------------------------

// float -> int toward zero; NaN -> 0 and the range clamped first, where the
// bare conversion is undefined.  In-range values convert as astype(int32).
__device__ __forceinline__ int trunc_i32(float x) {
  if (x != x) x = 0.0f;
  x = fminf(fmaxf(x, -1e9f), 1e9f);
  return (int)x;
}

// The wave's tables and statics, shared by every bounce (path_fused.py's
// WaveTables).
struct Tables {
  const float* __restrict__ ms;
  SceneSrc src;
  const float* __restrict__ mat;  // [M, 16]
  const float* __restrict__ lt;   // [L, 32]
  int n_lights;
  const float* __restrict__ td;  // [K, 4]
  int n_td;
  const uint8_t* __restrict__ tex;  // [pool_pad, 3]
  int pool_pad;
  int flags;
  int max_depth;
};

__device__ __forceinline__ int tex_index(const Tables& a, float tex0_f, float uv_s, float uv_t) {
  int row = (tex0_f >= 0.0f && tex0_f < (float)a.n_td) ? (int)tex0_f : 0;
  const float* r = a.td + 4 * row;
  float w_f = __ldg(r + 0), h_f = __ldg(r + 1), off_hi = __ldg(r + 2), off_lo = __ldg(r + 3);
  float s = uv_s - floorf(uv_s);
  float t = uv_t - floorf(uv_t);
  t = 1.0f - t;
  float x = s * w_f - 0.5f;
  float y = t * h_f - 0.5f;
  int w_i = (int)w_f;
  int h_i = (int)h_f;
  int xi = min(max(trunc_i32(x), 0), w_i - 1);
  int yi = min(max(trunc_i32(y), 0), h_i - 1);
  int off = (int)off_hi * 4096 + (int)off_lo;
  int idx = off + yi * w_i + xi;
  return min(max(idx, 0), a.pool_pad - 1);
}

// One path's state between bounces: the values of the [24, N] _ST planes.
// Flags stay floats (1 or 0), as in the planes, so that the state in
// registers and the state through memory are the same bits.
struct PathState {
  V3 o, d, beta, rad;
  float alive, spec, rc;
  Hit hit;
};

__device__ __forceinline__ PathState load_state(const float* s, size_t N) {
  PathState p;
  p.o = {s[ST_OX * N], s[ST_OY * N], s[ST_OZ * N]};
  p.d = {s[ST_DX * N], s[ST_DY * N], s[ST_DZ * N]};
  p.beta = {s[ST_BX * N], s[ST_BY * N], s[ST_BZ * N]};
  p.rad = {s[ST_RX * N], s[ST_RY * N], s[ST_RZ * N]};
  p.alive = s[ST_ALIVE * N];
  p.spec = s[ST_SPEC * N];
  p.rc = s[ST_RC * N];
  p.hit = {s[ST_T * N], s[ST_B0 * N], s[ST_B1 * N], s[ST_PRIM * N], s[ST_SPH * N], s[ST_HITF * N]};
  return p;
}

__device__ __forceinline__ void store_state(float* s, size_t N, const PathState& p) {
  s[ST_OX * N] = p.o.x;
  s[ST_OY * N] = p.o.y;
  s[ST_OZ * N] = p.o.z;
  s[ST_DX * N] = p.d.x;
  s[ST_DY * N] = p.d.y;
  s[ST_DZ * N] = p.d.z;
  s[ST_BX * N] = p.beta.x;
  s[ST_BY * N] = p.beta.y;
  s[ST_BZ * N] = p.beta.z;
  s[ST_RX * N] = p.rad.x;
  s[ST_RY * N] = p.rad.y;
  s[ST_RZ * N] = p.rad.z;
  s[ST_ALIVE * N] = p.alive;
  s[ST_SPEC * N] = p.spec;
  s[ST_RC * N] = p.rc;
  s[ST_T * N] = p.hit.t;
  s[ST_B0 * N] = p.hit.b0;
  s[ST_B1 * N] = p.hit.b1;
  s[ST_PRIM * N] = p.hit.prim;
  s[ST_SPH * N] = p.hit.sph;
  s[ST_HITF * N] = p.hit.hitf;
  s[ST_PAD0 * N] = 0.0f;
  s[ST_PAD1 * N] = 0.0f;
  s[ST_PAD2 * N] = 0.0f;
}

// ---- the two bodies: raygen and one bounce --------------------------------

// Pixel hash + jitter and the camera ray's direction (_raygen_values,
// path_fused.py:451).  The jitter is the hash's dimensions 0-1, or, where
// spl is set, the stratified values spl[0] and spl[stride].
#define R2C(r, c) __ldg(ms + MS_R2C + 4 * (r) + (c))
#define C2W(r, c) __ldg(ms + MS_C2W + 4 * (r) + (c))
__device__ __forceinline__ V3 camera_dir(int px, int py, uint32_t sample_index, uint32_t seed,
                                         const float* __restrict__ ms, const float* __restrict__ spl, size_t stride,
                                         uint32_t& ph) {
  uint32_t h = pcg(0x9E3779B9u ^ seed);
  uint32_t key = ((uint32_t)px << 16) | (uint32_t)py;
  ph = pcg(pcg(h ^ key) ^ sample_index);

  float jx = spl ? __ldg(spl) : dim_f32(ph, 0u);
  float jy = spl ? __ldg(spl + stride) : dim_f32(ph, 1u);
  float x = (float)px + jx;
  float y = (float)py + jy;

  float pcx = R2C(0, 0) * x + R2C(0, 1) * y + R2C(0, 3);
  float pcy = R2C(1, 0) * x + R2C(1, 1) * y + R2C(1, 3);
  float pcz = R2C(2, 0) * x + R2C(2, 1) * y + R2C(2, 3);
  float w = R2C(3, 0) * x + R2C(3, 1) * y + R2C(3, 3);
  pcx = pcx / w;
  pcy = pcy / w;
  pcz = pcz / w;
  float l1 = sqrtf(pcx * pcx + pcy * pcy + pcz * pcz);
  pcx = pcx / l1;
  pcy = pcy / l1;
  pcz = pcz / l1;
  float dx = C2W(0, 0) * pcx + C2W(0, 1) * pcy + C2W(0, 2) * pcz;
  float dy = C2W(1, 0) * pcx + C2W(1, 1) * pcy + C2W(1, 2) * pcz;
  float dz = C2W(2, 0) * pcx + C2W(2, 1) * pcy + C2W(2, 2) * pcz;
  float l2 = sqrtf(dx * dx + dy * dy + dz * dz);
  return {dx / l2, dy / l2, dz / l2};
}

// The camera's origin, shared by every ray of a wave (a pinhole).
__device__ __forceinline__ V3 camera_origin(const float* __restrict__ ms) {
  return {C2W(0, 3) + 0.0f, C2W(1, 3) + 0.0f, C2W(2, 3) + 0.0f};
}
#undef R2C
#undef C2W

// A camera ray's path state before its first bounce.
__device__ __forceinline__ PathState camera_state(V3 o, V3 d, const Hit& hit) {
  PathState p;
  p.o = o;
  p.d = d;
  p.beta = {1.0f, 1.0f, 1.0f};
  p.rad = zero3();
  p.alive = 1.0f;
  p.spec = 0.0f;
  p.rc = 1.0f;
  p.hit = hit;
  return p;
}

// ---- the raygen kernel's camera sweep -------------------------------------
// Its tables in shared memory, staged per block by stage_camera_spheres and
// stage_camera_copy: `slots` copies of the triangles' corners less the
// camera origin, each with its coordinates permuted for one shear frame, as
// [T][3] float4s (p0' xyz p1'x | p1'yz p2'xy | p2'z), then the spheres'
// camera rows [S][4] float4s: (ro xyz, c), (m0 m1 m2 m4), (m5 m6 m8 m9),
// (m10).
struct CamScene {
  int n_tris, n_spheres, slots;
  __device__ __forceinline__ float4* copy(int slot) const { return smem + 3 * n_tris * slot; }
  __device__ __forceinline__ float4* sp() const { return smem + 3 * n_tris * slots; }
};

__host__ __device__ inline size_t camera_bytes(int n_tris, int n_spheres, int slots) {
  return (size_t)n_tris * 48 * slots + (size_t)n_spheres * 64;
}

// The shear frame make_shear picks for d: 0 when z is the dominant axis, 1
// for x, 2 for y (the permutations (x, y, z), (y, z, x), (z, x, y)).
__device__ __forceinline__ int shear_frame(V3 d) {
  const float adx = fabsf(d.x), ady = fabsf(d.y), adz = fabsf(d.z);
  const bool x_max = (adx > ady) && (adx > adz);
  return x_max ? 1 : (ady > adz ? 2 : 0);
}

// The spheres' camera rows: ro and c as sphere_t computes them for a ray
// from o, and the rows of world_to_obj that rotate a direction.
__device__ __forceinline__ void stage_camera_spheres(const CamScene& sc, const SceneSrc& src, V3 o) {
  float4* dst = sc.sp();
  for (int s = threadIdx.x; s < sc.n_spheres; s += blockDim.x) {
    const float* m = src.sp + 40 * s;
    const float4 r0 = make_float4(__ldg(m + 0), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3));
    const float4 r1 = make_float4(__ldg(m + 4), __ldg(m + 5), __ldg(m + 6), __ldg(m + 7));
    const float4 r2 = make_float4(__ldg(m + 8), __ldg(m + 9), __ldg(m + 10), __ldg(m + 11));
    const V3 ro = sphere_origin(r0, r1, r2, o);
    dst[4 * s] = make_float4(ro.x, ro.y, ro.z, sphere_c(ro, __ldg(m + 32)));
    dst[4 * s + 1] = make_float4(r0.x, r0.y, r0.z, r1.x);
    dst[4 * s + 2] = make_float4(r1.y, r1.z, r2.x, r2.y);
    dst[4 * s + 3] = make_float4(r2.z, 0.0f, 0.0f, 0.0f);
  }
}

// Copy `slot`: the triangles less o, permuted for shear frame F.  c - o is
// the subtraction watertight9 makes, and the permutation is its selects'
// (permx(c - o) = (c - o) permuted), so the tests see the same values.
template <int F>
__device__ __forceinline__ void stage_camera_copy(const CamScene& sc, const SceneSrc& src, V3 o, int slot) {
  float4* dst = sc.copy(slot);
  const float4* tri = reinterpret_cast<const float4*>(src.tri);
  // Corner k's coordinates in frame F: v[3k + (F + j) % 3], j = 0, 1, 2.
  constexpr int j0 = F, j1 = (F + 1) % 3, j2 = (F + 2) % 3;
  for (int i = threadIdx.x; i < sc.n_tris; i += blockDim.x) {
    const float4 a = __ldg(tri + 3 * i), b = __ldg(tri + 3 * i + 1), c = __ldg(tri + 3 * i + 2);
    const float v[9] = {a.x - o.x, a.y - o.y, a.z - o.z, a.w - o.x, b.x - o.y,
                        b.y - o.z, b.z - o.x, b.w - o.y, c.x - o.z};
    dst[3 * i] = make_float4(v[j0], v[j1], v[j2], v[3 + j0]);
    dst[3 * i + 1] = make_float4(v[3 + j1], v[3 + j2], v[6 + j0], v[6 + j1]);
    dst[3 * i + 2] = make_float4(v[6 + j2], 0.0f, 0.0f, 0.0f);
  }
}

// trace_scene for a camera ray of direction d: the triangle tests on the
// copy of its shear frame, from the translated and permuted corners
// (sweep_take: the divide only on a passing test, b0 and b1 only for a
// closer hit, which is all trace_scene keeps).  Then the spheres from
// their staged ro and c, as sphere_t.
__device__ __forceinline__ Hit camera_sweep(const float4* tri, int n_tris, const float4* sp, int n_spheres, V3 d) {
  const Shear sh = make_shear(d);
  float t = YK_F32_MAX, b0 = 0.0f, b1 = 0.0f;
  int prim = -1;
  for (int i = 0; i < n_tris; ++i) {
    const float4 q0 = tri[3 * i], q1 = tri[3 * i + 1], q2 = tri[3 * i + 2];
    if (sweep_take(sh, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, true, t, b0, b1)) prim = i;
  }
  int sph = -1;
  bool any = prim >= 0;
  if (n_spheres > 0) {
    float best_t = YK_F32_MAX;
    int best_i = -1;
    for (int s = 0; s < n_spheres; ++s) {
      const float4 q0 = sp[4 * s], q1 = sp[4 * s + 1], q2 = sp[4 * s + 2];
      const float m10 = sp[4 * s + 3].x;
      const V3 rd = {q1.x * d.x + q1.y * d.y + q1.z * d.z, q1.w * d.x + q2.x * d.y + q2.y * d.z,
                     q2.z * d.x + q2.w * d.y + m10 * d.z};
      bool hit;
      const float ts = sphere_root(v3(q0.x, q0.y, q0.z), rd, q0.w, YK_F32_MAX, hit);
      if (hit && ts < best_t) {
        best_t = ts;
        best_i = s;
      }
    }
    const bool sphere_wins = best_i >= 0 && best_t < t;
    any = any || sphere_wins;
    if (sphere_wins) {
      t = best_t;
      prim = -1;
      sph = best_i;
    }
  }
  return {t, b0, b1, (float)prim, (float)sph, any ? 1.0f : 0.0f};
}

// The bounce's NEE sink: occlusion sweep per worthwhile light, folded into
// the bounce radiance seeded with the emission term.
struct BounceNee {
  const Scene& sc;
  V3 br;
  __device__ void emit(V3 ne) { br = ne; }
  __device__ void light(int, int skip, bool worth, V3 o_s, V3 d_s, V3 contrib) {
    // A lane that is not worth it traces with t_max = 0, which never hits.
    bool lit = worth && !occluded(sc, skip, o_s, d_s, F(0.9999));
    br = {br.x + (lit ? contrib.x : 0.0f), br.y + (lit ? contrib.y : 0.0f), br.z + (lit ? contrib.z : 0.0f)};
  }
};

// The shading body's tables, in device memory.
__device__ __forceinline__ ShadeTables shade_tables(const Tables& a) {
  ShadeTables tb;
  tb.trs = a.src.trs;
  tb.mat = a.mat;
  tb.lt = a.lt;
  tb.n_lights = a.n_lights;
  tb.sp = a.src.sp;
  tb.n_spheres = a.src.n_spheres;
  tb.center = {__ldg(a.ms + MS_CENTER), __ldg(a.ms + MS_CENTER + 1), __ldg(a.ms + MS_CENTER + 2)};
  tb.diag = __ldg(a.ms + MS_DIAG);
  tb.has_sigma = (a.flags & FLAG_SIGMA) != 0;
  return tb;
}

// One bounce (_bounce_values + the next ray's trace, path_fused.py:543-786):
// shade, NEE occlusion, resolve, next closest hit.
__device__ __forceinline__ PathState bounce_lane(const Tables& a, const Scene& sc, const PathState& s,
                                                 const Draws& urand, int bounce) {
  const bool has_clamp = (a.flags & FLAG_CLAMP) != 0;
  const bool has_tex = (a.flags & FLAG_TEX) != 0;

  ShadeIn in;
  in.o = s.o;
  in.d = s.d;
  in.beta = s.beta;
  V3 rad = s.rad;
  bool alive_in = s.alive > 0.0f;
  in.spec = s.spec;
  in.t_hit = s.hit.t;
  in.b0 = s.hit.b0;
  in.b1 = s.hit.b1;
  bool hitf = s.hit.hitf > 0.0f;

  bool missed = alive_in && !hitf;
  in.alive = alive_in && hitf;

  const ShadeTables tb = shade_tables(a);

  // Table rows; the u8 texel replaces kd where the material binds one.
  Rows r = select_rows(tb, s.hit.prim, s.hit.sph);
  Material mt = material_row(r.mrow);
  if (has_tex) {
    float tex0 = __ldg(r.mrow + 9);
    if (tex0 >= 0.0f) {
      const float* trp = r.trp;
      float b2 = 1.0f - in.b0 - in.b1;
      float uv_s = __ldg(trp + 18) * in.b0 + __ldg(trp + 20) * in.b1 + __ldg(trp + 22) * b2;
      float uv_t = __ldg(trp + 19) * in.b0 + __ldg(trp + 21) * in.b1 + __ldg(trp + 23) * b2;
      int idx = tex_index(a, tex0, uv_s, uv_t);
      const uint8_t* tx = a.tex + 3 * idx;
      mt.kd = {(float)__ldg(tx + 0) / 255.0f, (float)__ldg(tx + 1) / 255.0f, (float)__ldg(tx + 2) / 255.0f};
    }
  }

  BounceNee nee{sc, zero3()};
  ShadeOut so = shade_lane(tb, in, r, mt, urand, bounce, nee);
  V3 br = nee.br;
  const V3 beta = in.beta;

  // ---- resolve (path_fused.py:660-698) ---------------------------------
  if (missed) {
    rad = {rad.x + beta.x * __ldg(a.ms + MS_BG), rad.y + beta.y * __ldg(a.ms + MS_BG + 1),
           rad.z + beta.z * __ldg(a.ms + MS_BG + 2)};
  }
  if (has_clamp && bounce > 0) {
    float cv = __ldg(a.ms + MS_CLAMP);
    br = {jmin(br.x, cv), jmin(br.y, cv), jmin(br.z, cv)};
  }
  if (in.alive) rad = {rad.x + beta.x * br.x, rad.y + beta.y * br.y, rad.z + beta.z * br.z};

  bool not_last = bounce < a.max_depth - 1;
  PathState out;
  out.o = so.o2;
  out.d = so.d2;
  out.beta = so.beta2;
  out.rad = rad;
  out.alive = so.alive2 ? 1.0f : 0.0f;
  out.spec = so.spec2 ? 1.0f : 0.0f;
  out.rc = s.rc + (so.alive2 ? 1.0f : 0.0f) * (not_last ? 1.0f : 0.0f);
  // Next ray's closest hit; a dead lane traces with t_max = 0, which
  // leaves (t, b0, b1, prim, sph, hitf) = (0, 0, 0, -1, -1, 0).
  out.hit = {0.0f, 0.0f, 0.0f, -1.0f, -1.0f, 0.0f};
  if (not_last && so.alive2) out.hit = trace_scene(sc, so.o2, so.d2, YK_F32_MAX);
  return out;
}

// A lane's class for the bounce and wave kernels' sort: 0 dead, 1 missed,
// else 2 + 2 * the hit's material type + 1 on a sphere's surface, from its
// state planes N floats apart in device memory (GLOBAL) or shared memory.
// It orders lanes only; no output depends on it.
template <bool GLOBAL>
__device__ __forceinline__ int lane_class(const Tables& a, const float* s, size_t N) {
  auto at = [&](int plane) {
    if constexpr (GLOBAL) return __ldg(s + plane * N);
    else return s[plane * N];
  };
  if (!(at(ST_ALIVE) > 0.0f)) return 0;
  if (!(at(ST_HITF) > 0.0f)) return 1;
  const Rows r = select_rows(shade_tables(a), at(ST_PRIM), at(ST_SPH));
  const int mtype = min(max((int)__ldg(r.mrow), 0), 3);
  return 2 + 2 * mtype + (r.sph_valid ? 1 : 0);
}

// A stable counting sort of a tile's lanes by class, by all THREADS threads
// of the block: thread t holds in cls the classes of lanes PER t .. PER t +
// PER - 1 (N_CLASSES for a lane left out) and counts each class; warp scans
// and one pass over the warps' sums give every thread, for each class, its
// first position in the sorted tile.  Writes the sorted lanes to perm and
// returns their count, to every thread; warp_sums: N_CLASSES * THREADS / 32
// ints.  Two barriers.
template <int THREADS, int PER>
__device__ __forceinline__ int sort_tile(const int (&cls)[PER], uint16_t* perm, int* warp_sums) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int pos[N_CLASSES];  // this thread's count of each class, then its first position
#pragma unroll
  for (int k = 0; k < N_CLASSES; ++k) pos[k] = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
#pragma unroll
    for (int k = 0; k < N_CLASSES; ++k) pos[k] += cls[j] == k ? 1 : 0;
  }
  // Inclusive warp scans of the counts, then the warps' sums.
#pragma unroll
  for (int k = 0; k < N_CLASSES; ++k) {
    int incl = pos[k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane == 31) warp_sums[k * WARPS + warp] = incl;
    pos[k] = incl - pos[k];  // exclusive, within the warp
  }
  __syncthreads();
  int start = 0;  // the sorted tile's first position of class k
#pragma unroll
  for (int k = 0; k < N_CLASSES; ++k) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int u = warp_sums[k * WARPS + w];
      total += u;
      before += w < warp ? u : 0;
    }
    pos[k] += start + before;
    start += total;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
#pragma unroll
    for (int k = 0; k < N_CLASSES; ++k) {
      if (cls[j] == k) perm[pos[k]++] = (uint16_t)(PER * threadIdx.x + j);
    }
  }
  __syncthreads();  // perm complete; `start` is the sorted lanes' count
  return start;
}

// ---- kernels -------------------------------------------------------------
// Each block stages the scene, then runs one lane a thread (raygen, wave)
// or one tile of TILE lanes (bounce).

// The camera wave, one ray a thread.  A thread makes its ray and notes its
// shear frame; the block finds which frames its rays need (one
// __syncthreads_or a frame) and stages their copies, `slots` at a time (a
// block whose rays share a frame stages one copy), traces the rays whose
// frame is staged, and stages the next frames if any are left.
__global__ void __launch_bounds__(CAM_THREADS)
    raygen_trace_kernel(const int* __restrict__ px_in, const int* __restrict__ py_in, int n, uint32_t sample_index,
                        uint32_t seed, const float* __restrict__ ms, SceneSrc src, int slots,
                        const float* __restrict__ spl, float* __restrict__ st, int* __restrict__ ph_out) {
  const size_t N = (size_t)n;
  const int i = blockIdx.x * CAM_THREADS + threadIdx.x;
  const V3 o = camera_origin(ms);
  V3 d = zero3();
  int frame = -1;
  if (i < n) {
    uint32_t ph;
    d = camera_dir(px_in[i], py_in[i], sample_index, seed, ms, spl ? spl + i : nullptr, N, ph);
    frame = shear_frame(d);
    ph_out[i] = (int)ph;
  }
  int todo = 0;
#pragma unroll
  for (int f = 0; f < 3; ++f) todo |= __syncthreads_or(frame == f) ? 1 << f : 0;
  const CamScene sc = {src.n_tris, src.n_spheres, slots};
  stage_camera_spheres(sc, src, o);
  while (todo) {
    int staged = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if ((todo >> f & 1) && __popc(staged) < slots) {
        if (f == 0) stage_camera_copy<0>(sc, src, o, __popc(staged));
        if (f == 1) stage_camera_copy<1>(sc, src, o, __popc(staged));
        if (f == 2) stage_camera_copy<2>(sc, src, o, __popc(staged));
        staged |= 1 << f;
      }
    }
    __syncthreads();
    if (frame >= 0 && (staged >> frame & 1)) {
      const float4* copy = sc.copy(__popc(staged & ((1 << frame) - 1)));
      store_state(st + i, N, camera_state(o, d, camera_sweep(copy, sc.n_tris, sc.sp(), sc.n_spheres, d)));
    }
    todo &= ~staged;
    if (todo) __syncthreads();  // the copies are staged anew
  }
}

// One bounce of TILE lanes a block.  The tile's lanes are sorted by
// lane_class (sort_tile); then the block runs the tile in that order:
// position p goes to thread p % BOUNCE_THREADS, so each warp takes 32
// neighbours in class order.  Every lane reads and writes its own index.
__global__ void __launch_bounds__(BOUNCE_THREADS, BOUNCE_MIN_BLOCKS)
    bounce_kernel(Tables a, const float* __restrict__ st_in, const int* __restrict__ ph, float* __restrict__ st_out,
                  int n, int dim0, int bounce, const float* __restrict__ spl) {
  const Scene sc = stage_scene(a.src);
  uint16_t* perm = (uint16_t*)sc.end();            // [TILE]
  int* warp_sums = (int*)(perm + TILE);            // [N_CLASSES][BOUNCE_WARPS]
  const size_t N = (size_t)n;
  const int base = blockIdx.x * TILE;
  int cls[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = base + PER_THREAD * threadIdx.x + j;
    cls[j] = i < n ? lane_class<true>(a, st_in + i, N) : N_CLASSES;
  }
  const int count = sort_tile<BOUNCE_THREADS, PER_THREAD>(cls, perm, warp_sums);
  for (int p = threadIdx.x; p < count; p += BOUNCE_THREADS) {
    const int i = base + perm[p];
    const Draws urand{(uint32_t)ph[i], (uint32_t)dim0, spl ? spl + i : nullptr, N};
    store_state(st_out + i, N, bounce_lane(a, sc, load_state(st_in + i, N), urand, bounce));
  }
}

// The bytes of shared memory a wave block takes with `slots` camera copies:
// the scene's tables or the camera sweep's copies, whichever is larger (the
// tables replace the copies after raygen), then the tile's state, ph, perm
// and warp sums.
__host__ __device__ inline size_t wave_scene_bytes(int n_tris, int n_spheres, int slots) {
  const size_t a = scene_bytes(n_tris, n_spheres), b = camera_bytes(n_tris, n_spheres, slots);
  return a > b ? a : b;
}
__host__ __device__ inline size_t wave_bytes(int n_tris, int n_spheres, int slots) {
  return wave_scene_bytes(n_tris, n_spheres, slots) + (size_t)WAVE_TILE * (24 * 4 + 4 + 2) +
         (size_t)N_CLASSES * (WAVE_THREADS / 32) * 4;
}

// The whole path of one sample (_wave_kernel, path_fused.py:788) for a tile
// of WAVE_TILE lanes, writing only radiance rgb and the ray count as [4, N].
// Raygen: thread t makes the camera rays of lanes t + j WAVE_THREADS and
// traces them through the camera sweep (as raygen_trace_kernel, `slots`
// copies at a time), and the state goes to shared memory.  The scene's
// tables are then staged over the copies.  Bounce b: the live lanes are
// sorted by class (sort_tile; a dead lane is out of the order: every later
// bounce would leave its radiance and count as they are, since in.alive =
// alive && hit never revives it), position p runs on thread p %
// WAVE_THREADS with the hash from dimension 2 + b * (2L+3), or the
// stratified planes from that row of spl at the lane's own index, and the
// loop ends after max_depth bounces or when no lane is live.
__global__ void __launch_bounds__(WAVE_THREADS, WAVE_MIN_BLOCKS)
    wave_kernel(Tables a, const int* __restrict__ px_in, const int* __restrict__ py_in, int n, uint32_t sample_index,
                uint32_t seed, int slots, const float* __restrict__ spl, float* __restrict__ out) {
  __shared__ int frames_w[WAVE_THREADS / 32];
  const int T = a.src.n_tris, S = a.src.n_spheres;
  float* st = (float*)((char*)smem + wave_scene_bytes(T, S, slots));  // [24][WAVE_TILE]
  uint32_t* ph = (uint32_t*)(st + 24 * WAVE_TILE);                   // [WAVE_TILE]
  uint16_t* perm = (uint16_t*)(ph + WAVE_TILE);                      // [WAVE_TILE]
  int* warp_sums = (int*)(perm + WAVE_TILE);                         // [N_CLASSES][WAVE_THREADS / 32]
  const size_t N = (size_t)n;
  const int base = blockIdx.x * WAVE_TILE;

  // ---- raygen: the camera sweep -----------------------------------------
  const V3 o = camera_origin(a.ms);
  V3 d[WAVE_PER_THREAD];
  int frame[WAVE_PER_THREAD];
  int bits = 0;
#pragma unroll
  for (int j = 0; j < WAVE_PER_THREAD; ++j) {
    const int l = threadIdx.x + j * WAVE_THREADS, i = base + l;
    d[j] = zero3();
    frame[j] = -1;
    if (i < n) {
      uint32_t h;
      d[j] = camera_dir(px_in[i], py_in[i], sample_index, seed, a.ms, spl ? spl + i : nullptr, N, h);
      frame[j] = shear_frame(d[j]);
      ph[l] = h;
      bits |= 1 << frame[j];
    }
  }
  int todo = block_union<WAVE_THREADS>(bits, frames_w);
  const CamScene cs = {T, S, slots};
  stage_camera_spheres(cs, a.src, o);
  while (todo) {
    int staged = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if ((todo >> f & 1) && __popc(staged) < slots) {
        if (f == 0) stage_camera_copy<0>(cs, a.src, o, __popc(staged));
        if (f == 1) stage_camera_copy<1>(cs, a.src, o, __popc(staged));
        if (f == 2) stage_camera_copy<2>(cs, a.src, o, __popc(staged));
        staged |= 1 << f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < WAVE_PER_THREAD; ++j) {
      if (frame[j] >= 0 && (staged >> frame[j] & 1)) {
        const float4* copy = cs.copy(__popc(staged & ((1 << frame[j]) - 1)));
        store_state(st + threadIdx.x + j * WAVE_THREADS, WAVE_TILE,
                    camera_state(o, d[j], camera_sweep(copy, T, cs.sp(), S, d[j])));
      }
    }
    todo &= ~staged;
    __syncthreads();  // the copies are read: staged anew, or replaced by the tables
  }

  // ---- the bounces, live lanes sorted by class --------------------------
  const Scene sc = stage_scene(a.src);
  const int dims_per_bounce = 2 * a.n_lights + 3;
  for (int b = 0; b < a.max_depth; ++b) {
    int cls[WAVE_PER_THREAD];
#pragma unroll
    for (int j = 0; j < WAVE_PER_THREAD; ++j) {
      const int l = WAVE_PER_THREAD * threadIdx.x + j;
      cls[j] = base + l < n ? lane_class<false>(a, st + l, WAVE_TILE) : N_CLASSES;
      if (cls[j] == 0) cls[j] = N_CLASSES;
    }
    const int live = sort_tile<WAVE_THREADS, WAVE_PER_THREAD>(cls, perm, warp_sums);
    if (live == 0) break;
    const int dim0 = 2 + b * dims_per_bounce;
    for (int p = threadIdx.x; p < live; p += WAVE_THREADS) {
      const int l = perm[p], i = base + l;
      const Draws urand{ph[l], (uint32_t)dim0, spl ? spl + (size_t)dim0 * N + i : nullptr, N};
      store_state(st + l, WAVE_TILE, bounce_lane(a, sc, load_state(st + l, WAVE_TILE), urand, b));
    }
    __syncthreads();  // the tile's state is complete for the next sort
  }
#pragma unroll
  for (int j = 0; j < WAVE_PER_THREAD; ++j) {
    const int l = threadIdx.x + j * WAVE_THREADS, i = base + l;
    if (i < n) {
      out[i] = st[ST_RX * WAVE_TILE + l];
      out[N + i] = st[ST_RY * WAVE_TILE + l];
      out[2 * N + i] = st[ST_RZ * WAVE_TILE + l];
      out[3 * N + i] = st[ST_RC * WAVE_TILE + l];
    }
  }
}

Tables make_tables(const float* ms, const float* tri, int n_tris, const float* trs, const float* mat,
                   const float* lt, int n_lights, const float* sp, int n_spheres, const float* td, int n_td,
                   const unsigned char* tex, int pool_pad, int flags, int max_depth) {
  Tables a;
  a.ms = ms;
  a.src = {tri, trs, n_tris, sp, n_spheres};
  a.mat = mat;
  a.lt = lt;
  a.n_lights = n_lights;
  a.td = td;
  a.n_td = n_td;
  a.tex = tex;
  a.pool_pad = pool_pad;
  a.flags = flags;
  a.max_depth = max_depth;
  return a;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------
// Each entry point makes `device` current, launches on `stream` (PyTorch's
// current stream) and returns cudaGetLastError() as an int.  spl is a
// StratifiedSampler's planes ([2, n] for raygen, the bounce's [2L+3, n],
// the wave's [2 + max_depth * (2L+3), n]) or null for the uniform sampler.

extern "C" int yk_raygen_trace(int device, const int* px, const int* py, int n, unsigned int sample_index,
                               unsigned int seed, const float* ms, const float* tri, int n_tris, const float* trs,
                               const float* sp, int n_spheres, const float* spl, float* st, int* ph, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const SceneSrc src = {tri, trs, n_tris, sp, n_spheres};
  // Three frame copies where they fit beside other blocks on an SM without
  // the opt-in; else one at a time (a block whose rays span frames stages
  // and traces them in turn).
  const int slots = camera_bytes(n_tris, n_spheres, 3) <= 48 * 1024 ? 3 : 1;
  const size_t shmem = camera_bytes(n_tris, n_spheres, slots);
  err = allow_shared((const void*)raygen_trace_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  raygen_trace_kernel<<<(n + CAM_THREADS - 1) / CAM_THREADS, CAM_THREADS, shmem, (cudaStream_t)stream>>>(
      px, py, n, sample_index, seed, ms, src, slots, spl, st, ph);
  return (int)cudaGetLastError();
}

extern "C" int yk_bounce(int device, const float* st_in, const int* ph, float* st_out, int n, int dim0, int bounce,
                         int max_depth, const float* ms, const float* tri, int n_tris, const float* trs,
                         const float* mat, const float* lt, int n_lights, const float* sp, int n_spheres,
                         const float* td, int n_td, const unsigned char* tex, int pool_pad, int flags,
                         const float* spl, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Tables a = make_tables(ms, tri, n_tris, trs, mat, lt, n_lights, sp, n_spheres, td, n_td, tex, pool_pad,
                               flags, max_depth);
  const size_t shmem =
      scene_bytes(n_tris, n_spheres) + TILE * sizeof(uint16_t) + N_CLASSES * BOUNCE_WARPS * sizeof(int);
  err = allow_shared((const void*)bounce_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  bounce_kernel<<<(n + TILE - 1) / TILE, BOUNCE_THREADS, shmem, (cudaStream_t)stream>>>(a, st_in, ph, st_out, n,
                                                                                         dim0, bounce, spl);
  return (int)cudaGetLastError();
}

extern "C" int yk_wave(int device, const int* px, const int* py, int n, unsigned int sample_index,
                       unsigned int seed, int max_depth, const float* ms, const float* tri, int n_tris,
                       const float* trs, const float* mat, const float* lt, int n_lights, const float* sp,
                       int n_spheres, const float* td, int n_td, const unsigned char* tex, int pool_pad, int flags,
                       const float* spl, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Tables a = make_tables(ms, tri, n_tris, trs, mat, lt, n_lights, sp, n_spheres, td, n_td, tex, pool_pad,
                               flags, max_depth);
  // Three camera copies where two blocks still fit on an SM; else one at a
  // time.  A block that does not fit at all is refused, and the wrapper
  // raises.
  const int slots = wave_bytes(n_tris, n_spheres, 3) <= WAVE_SHARED_TWO ? 3 : 1;
  const size_t shmem = wave_bytes(n_tris, n_spheres, slots);
  err = allow_shared((const void*)wave_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  wave_kernel<<<(n + WAVE_TILE - 1) / WAVE_TILE, WAVE_THREADS, shmem, (cudaStream_t)stream>>>(
      a, px, py, n, sample_index, seed, slots, spl, out);
  return (int)cudaGetLastError();
}

extern "C" const char* yk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
