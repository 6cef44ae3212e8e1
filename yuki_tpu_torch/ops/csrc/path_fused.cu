// Dense path-tracing wave kernels for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/path_fused.py's three Pallas kernels.
//
//   yk_raygen_trace  replaces _raygen_trace_kernel (path_fused.py:517, body
//                    _raygen_values :451): pixel hash + jitter, camera ray,
//                    closest hit over every triangle and sphere.
//   yk_bounce        replaces _bounce_kernel (path_fused.py:709, body
//                    _bounce_values :543 + shade_fused._shade_body :360):
//                    one whole bounce, including the NEE occlusion sweeps and
//                    the next ray's closest hit.
//   yk_wave          replaces _wave_kernel (path_fused.py:788): raygen and
//                    every bounce of one sample in one launch, the path
//                    state in registers, writing only radiance and the ray
//                    count.
//
// The bodies are two device functions, raygen_lane and bounce_lane, which
// all three kernels call, so the one-kernel wave gives the two-kernel
// wave's bits.  Each takes a StratifiedSampler's values as planes computed
// beforehand (the TPU kernels' `strat` variants) where the caller passes
// them, else the uniform sampler's hash.
//
// Design.  One thread per ray.  The TPU kernels ran 1024-ray blocks of
// (8,128) planes and replaced every per-lane table read with MXU one-hot
// selects; here each thread reads its rows directly from global memory
// (__ldg: the tables are a few KB and stay in L1/L2).  The JAX kernels
// specialise on static scene facts (light types, material families, sigma,
// clamp, textures); this kernel takes them at run time and branches per
// lane, which gives the same value on every lane because a lane only ever
// selects a lobe or light type the scene holds.  State crosses bounces as
// [24, N] float planes (plane-major, so loads and stores coalesce).
//
// What bounds it: the per-ray sweeps are O(T) triangle tests (Cornell: 36
// for the closest hit and 36 per light for occlusion), all ALU work on
// registers; the state round trip is 2 x 96 B per ray per bounce.  So the
// bounce kernel is compute- and register-bound, not memory-bound.  The
// shading body is long, so __launch_bounds__(128) lets the compiler use up
// to 255 registers per thread; spills show in -Xptxas -v.  Lanes that are
// dead skip the occlusion and next-hit sweeps (their results are fixed),
// but still run the shading maths so every output plane matches the plain
// version bit for bit.
//
// Numerics: compiled with -fmad=false and without fast-math, so products,
// sums, divisions and square roots round exactly as in the JAX and PyTorch
// versions; only the transcendentals (logf, sinf, cosf) may differ by ulps.

#include <cuda_runtime.h>

#include <cstdint>

#include "path_fused.cuh"

using namespace yk;

namespace {

constexpr int ST_OX = 0, ST_OY = 1, ST_OZ = 2, ST_DX = 3, ST_DY = 4, ST_DZ = 5;
constexpr int ST_BX = 6, ST_BY = 7, ST_BZ = 8, ST_RX = 9, ST_RY = 10, ST_RZ = 11;
constexpr int ST_ALIVE = 12, ST_SPEC = 13, ST_RC = 14;
constexpr int ST_T = 15, ST_B0 = 16, ST_B1 = 17, ST_PRIM = 18, ST_SPH = 19, ST_HITF = 20;
constexpr int ST_PAD0 = 21, ST_PAD1 = 22, ST_PAD2 = 23;

constexpr int MS_R2C = 0, MS_C2W = 16, MS_CENTER = 32, MS_DIAG = 35, MS_BG = 36, MS_CLAMP = 39;

constexpr int FLAG_SIGMA = 1, FLAG_CLAMP = 2, FLAG_TEX = 4;

constexpr int THREADS = 128;

struct Scene {
  const float* __restrict__ tri;  // [T, 12]
  int n_tris;
  const float* __restrict__ sp;  // [S, 40]
  int n_spheres;
};

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
    bool hit = watertight(sh, o, t, sc.tri + 12 * i, ti, bi0, bi1);
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
      float ts = sphere_t(sc.sp + 40 * s, o, d, t_max, hit);
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
// triangles, shading row column 27) or any sphere hit.  path_fused.py:210.
__device__ bool occluded(const Scene& sc, const float* __restrict__ trs, int skip_id, V3 o, V3 d, float t_max) {
  Shear sh = make_shear(d);
  for (int i = 0; i < sc.n_tris; ++i) {
    float ti, bi0, bi1;
    bool hit = watertight(sh, o, t_max, sc.tri + 12 * i, ti, bi0, bi1);
    if (skip_id >= 0) hit = hit && (__ldg(trs + 32 * i + 27) != (float)skip_id);
    if (hit) return true;
  }
  for (int s = 0; s < sc.n_spheres; ++s) {
    bool hit;
    sphere_t(sc.sp + 40 * s, o, d, t_max, hit);
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
  Scene sc;
  const float* __restrict__ trs;  // [T, 32]
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

// Pixel hash + jitter, camera ray, closest hit (_raygen_values,
// path_fused.py:451).  The jitter is the hash's dimensions 0-1, or, where
// spl is set, the stratified values spl[0] and spl[stride].
__device__ __forceinline__ PathState raygen_lane(int px, int py, uint32_t sample_index, uint32_t seed,
                                                 const float* __restrict__ ms, const Scene& sc,
                                                 const float* __restrict__ spl, size_t stride, uint32_t& ph) {
  uint32_t h = pcg(0x9E3779B9u ^ seed);
  uint32_t key = ((uint32_t)px << 16) | (uint32_t)py;
  ph = pcg(pcg(h ^ key) ^ sample_index);

  float jx = spl ? __ldg(spl) : dim_f32(ph, 0u);
  float jy = spl ? __ldg(spl + stride) : dim_f32(ph, 1u);
  float x = (float)px + jx;
  float y = (float)py + jy;

#define R2C(r, c) __ldg(ms + MS_R2C + 4 * (r) + (c))
#define C2W(r, c) __ldg(ms + MS_C2W + 4 * (r) + (c))
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
  V3 d = {dx / l2, dy / l2, dz / l2};
  V3 o = {C2W(0, 3) + 0.0f, C2W(1, 3) + 0.0f, C2W(2, 3) + 0.0f};
#undef R2C
#undef C2W

  PathState p;
  p.o = o;
  p.d = d;
  p.beta = {1.0f, 1.0f, 1.0f};
  p.rad = zero3();
  p.alive = 1.0f;
  p.spec = 0.0f;
  p.rc = 1.0f;
  p.hit = trace_scene(sc, o, d, YK_F32_MAX);
  return p;
}

// The bounce's NEE sink: occlusion sweep per worthwhile light, folded into
// the bounce radiance seeded with the emission term.
struct BounceNee {
  const Scene& sc;
  const float* __restrict__ trs;
  V3 br;
  __device__ void emit(V3 ne) { br = ne; }
  __device__ void light(int, int skip, bool worth, V3 o_s, V3 d_s, V3 contrib) {
    // A lane that is not worth it traces with t_max = 0, which never hits.
    bool lit = worth && !occluded(sc, trs, skip, o_s, d_s, F(0.9999));
    br = {br.x + (lit ? contrib.x : 0.0f), br.y + (lit ? contrib.y : 0.0f), br.z + (lit ? contrib.z : 0.0f)};
  }
};

// One bounce (_bounce_values + the next ray's trace, path_fused.py:543-786):
// shade, NEE occlusion, resolve, next closest hit.
__device__ __forceinline__ PathState bounce_lane(const Tables& a, const PathState& s, const Draws& urand,
                                                 int bounce) {
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

  ShadeTables tb;
  tb.trs = a.trs;
  tb.mat = a.mat;
  tb.lt = a.lt;
  tb.n_lights = a.n_lights;
  tb.sp = a.sc.sp;
  tb.n_spheres = a.sc.n_spheres;
  tb.center = {__ldg(a.ms + MS_CENTER), __ldg(a.ms + MS_CENTER + 1), __ldg(a.ms + MS_CENTER + 2)};
  tb.diag = __ldg(a.ms + MS_DIAG);
  tb.has_sigma = (a.flags & FLAG_SIGMA) != 0;

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

  BounceNee nee{a.sc, a.trs, zero3()};
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
  if (not_last && so.alive2) out.hit = trace_scene(a.sc, so.o2, so.d2, YK_F32_MAX);
  return out;
}

// ---- kernels -------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    raygen_trace_kernel(const int* __restrict__ px_in, const int* __restrict__ py_in, int n, uint32_t sample_index,
                        uint32_t seed, const float* __restrict__ ms, Scene sc, const float* __restrict__ spl,
                        float* __restrict__ st, int* __restrict__ ph_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t ph;
  const PathState p = raygen_lane(px_in[i], py_in[i], sample_index, seed, ms, sc, spl ? spl + i : nullptr,
                                  (size_t)n, ph);
  store_state(st + i, (size_t)n, p);
  ph_out[i] = (int)ph;
}

__global__ void __launch_bounds__(THREADS)
    bounce_kernel(Tables a, const float* __restrict__ st_in, const int* __restrict__ ph, float* __restrict__ st_out,
                  int n, int dim0, int bounce, const float* __restrict__ spl) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const Draws urand{(uint32_t)ph[i], (uint32_t)dim0, spl ? spl + i : nullptr, N};
  store_state(st_out + i, N, bounce_lane(a, load_state(st_in + i, N), urand, bounce));
}

// The whole path of one sample (_wave_kernel, path_fused.py:788): raygen,
// then every bounce with the state in registers, writing only radiance rgb
// and the ray count as [4, N].  Bounce b's values are the hash from
// dimension 2 + b * (2L+3), or the stratified planes from that row of spl.
// A lane that is dead after a bounce leaves the loop: every later bounce
// would leave its radiance and count as they are (in.alive = alive && hit
// never revives it).
__global__ void __launch_bounds__(THREADS)
    wave_kernel(Tables a, const int* __restrict__ px_in, const int* __restrict__ py_in, int n, uint32_t sample_index,
                uint32_t seed, const float* __restrict__ spl, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const float* lane_spl = spl ? spl + i : nullptr;
  uint32_t ph;
  PathState p = raygen_lane(px_in[i], py_in[i], sample_index, seed, a.ms, a.sc, lane_spl, N, ph);
  const int dims_per_bounce = 2 * a.n_lights + 3;
  for (int b = 0; b < a.max_depth && p.alive > 0.0f; ++b) {
    const int dim0 = 2 + b * dims_per_bounce;
    const Draws urand{ph, (uint32_t)dim0, lane_spl ? lane_spl + (size_t)dim0 * N : nullptr, N};
    p = bounce_lane(a, p, urand, b);
  }
  out[i] = p.rad.x;
  out[N + i] = p.rad.y;
  out[2 * N + i] = p.rad.z;
  out[3 * N + i] = p.rc;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

Tables make_tables(const float* ms, const float* tri, int n_tris, const float* trs, const float* mat,
                   const float* lt, int n_lights, const float* sp, int n_spheres, const float* td, int n_td,
                   const unsigned char* tex, int pool_pad, int flags, int max_depth) {
  Tables a;
  a.ms = ms;
  a.sc = {tri, n_tris, sp, n_spheres};
  a.trs = trs;
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
                               unsigned int seed, const float* ms, const float* tri, int n_tris, const float* sp,
                               int n_spheres, const float* spl, float* st, int* ph, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Scene sc = {tri, n_tris, sp, n_spheres};
  raygen_trace_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(px, py, n, sample_index, seed, ms, sc,
                                                                           spl, st, ph);
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
  bounce_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(a, st_in, ph, st_out, n, dim0, bounce, spl);
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
  wave_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(a, px, py, n, sample_index, seed, spl, out);
  return (int)cudaGetLastError();
}

extern "C" const char* yk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
