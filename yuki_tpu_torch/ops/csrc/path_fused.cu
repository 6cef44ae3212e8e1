// Dense path-tracing wave kernels for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/path_fused.py's two Pallas kernels.
//
//   yk_raygen_trace  replaces _raygen_trace_kernel (path_fused.py:517, body
//                    _raygen_values :451): pixel hash + jitter, camera ray,
//                    closest hit over every triangle and sphere.
//   yk_bounce        replaces _bounce_kernel (path_fused.py:709, body
//                    _bounce_values :543 + shade_fused._shade_body :360):
//                    one whole bounce, including the NEE occlusion sweeps and
//                    the next ray's closest hit.
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

struct BounceArgs {
  const float* __restrict__ st_in;
  const int* __restrict__ ph;
  float* __restrict__ st_out;
  int n;
  int dim0, bounce, max_depth;
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
};

__device__ __forceinline__ int tex_index(const BounceArgs& a, float tex0_f, float uv_s, float uv_t) {
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

// ---- kernels -------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    raygen_trace_kernel(const int* __restrict__ px_in, const int* __restrict__ py_in, int n, uint32_t sample_index,
                        uint32_t seed, const float* __restrict__ ms, Scene sc, float* __restrict__ st,
                        int* __restrict__ ph_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int px = px_in[i], py = py_in[i];
  uint32_t h = pcg(0x9E3779B9u ^ seed);
  uint32_t key = ((uint32_t)px << 16) | (uint32_t)py;
  uint32_t ph = pcg(pcg(h ^ key) ^ sample_index);

  float jx = dim_f32(ph, 0u);
  float jy = dim_f32(ph, 1u);
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

  Hit hit = trace_scene(sc, o, d, YK_F32_MAX);

  float* s = st + i;
  const size_t N = (size_t)n;
  s[ST_OX * N] = o.x;
  s[ST_OY * N] = o.y;
  s[ST_OZ * N] = o.z;
  s[ST_DX * N] = d.x;
  s[ST_DY * N] = d.y;
  s[ST_DZ * N] = d.z;
  s[ST_BX * N] = 1.0f;
  s[ST_BY * N] = 1.0f;
  s[ST_BZ * N] = 1.0f;
  s[ST_RX * N] = 0.0f;
  s[ST_RY * N] = 0.0f;
  s[ST_RZ * N] = 0.0f;
  s[ST_ALIVE * N] = 1.0f;
  s[ST_SPEC * N] = 0.0f;
  s[ST_RC * N] = 1.0f;
  s[ST_T * N] = hit.t;
  s[ST_B0 * N] = hit.b0;
  s[ST_B1 * N] = hit.b1;
  s[ST_PRIM * N] = hit.prim;
  s[ST_SPH * N] = hit.sph;
  s[ST_HITF * N] = hit.hitf;
  s[ST_PAD0 * N] = 0.0f;
  s[ST_PAD1 * N] = 0.0f;
  s[ST_PAD2 * N] = 0.0f;
  ph_out[i] = (int)ph;
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

__global__ void __launch_bounds__(THREADS) bounce_kernel(BounceArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t N = (size_t)a.n;
  const float* s = a.st_in + i;
  const uint32_t ph = (uint32_t)a.ph[i];
  const bool has_clamp = (a.flags & FLAG_CLAMP) != 0;
  const bool has_tex = (a.flags & FLAG_TEX) != 0;

  ShadeIn in;
  in.o = {s[ST_OX * N], s[ST_OY * N], s[ST_OZ * N]};
  in.d = {s[ST_DX * N], s[ST_DY * N], s[ST_DZ * N]};
  in.beta = {s[ST_BX * N], s[ST_BY * N], s[ST_BZ * N]};
  V3 rad = {s[ST_RX * N], s[ST_RY * N], s[ST_RZ * N]};
  bool alive_in = s[ST_ALIVE * N] > 0.0f;
  in.spec = s[ST_SPEC * N];
  float rc = s[ST_RC * N];
  in.t_hit = s[ST_T * N];
  in.b0 = s[ST_B0 * N];
  in.b1 = s[ST_B1 * N];
  float prim = s[ST_PRIM * N];
  float sph = s[ST_SPH * N];
  bool hitf = s[ST_HITF * N] > 0.0f;

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
  Rows r = select_rows(tb, prim, sph);
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
  ShadeOut so = shade_lane(tb, in, r, mt, ph, (uint32_t)a.dim0, a.bounce, nee);
  V3 br = nee.br;
  const V3 beta = in.beta;

  // ---- resolve (path_fused.py:660-698) ---------------------------------
  if (missed) {
    rad = {rad.x + beta.x * __ldg(a.ms + MS_BG), rad.y + beta.y * __ldg(a.ms + MS_BG + 1),
           rad.z + beta.z * __ldg(a.ms + MS_BG + 2)};
  }
  if (has_clamp && a.bounce > 0) {
    float cv = __ldg(a.ms + MS_CLAMP);
    br = {jmin(br.x, cv), jmin(br.y, cv), jmin(br.z, cv)};
  }
  if (in.alive) rad = {rad.x + beta.x * br.x, rad.y + beta.y * br.y, rad.z + beta.z * br.z};

  bool not_last = a.bounce < a.max_depth - 1;
  float rc2 = rc + (so.alive2 ? 1.0f : 0.0f) * (not_last ? 1.0f : 0.0f);

  // Next ray's closest hit; a dead lane traces with t_max = 0, which
  // leaves (t, prim, b0, b1, sph, hitf) = (0, -1, 0, 0, -1, 0).
  Hit nh = {0.0f, 0.0f, 0.0f, -1.0f, -1.0f, 0.0f};
  if (not_last && so.alive2) nh = trace_scene(a.sc, so.o2, so.d2, YK_F32_MAX);

  float* out = a.st_out + i;
  out[ST_OX * N] = so.o2.x;
  out[ST_OY * N] = so.o2.y;
  out[ST_OZ * N] = so.o2.z;
  out[ST_DX * N] = so.d2.x;
  out[ST_DY * N] = so.d2.y;
  out[ST_DZ * N] = so.d2.z;
  out[ST_BX * N] = so.beta2.x;
  out[ST_BY * N] = so.beta2.y;
  out[ST_BZ * N] = so.beta2.z;
  out[ST_RX * N] = rad.x;
  out[ST_RY * N] = rad.y;
  out[ST_RZ * N] = rad.z;
  out[ST_ALIVE * N] = so.alive2 ? 1.0f : 0.0f;
  out[ST_SPEC * N] = so.spec2 ? 1.0f : 0.0f;
  out[ST_RC * N] = rc2;
  out[ST_T * N] = nh.t;
  out[ST_B0 * N] = nh.b0;
  out[ST_B1 * N] = nh.b1;
  out[ST_PRIM * N] = nh.prim;
  out[ST_SPH * N] = nh.sph;
  out[ST_HITF * N] = nh.hitf;
  out[ST_PAD0 * N] = 0.0f;
  out[ST_PAD1 * N] = 0.0f;
  out[ST_PAD2 * N] = 0.0f;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------
// Each entry point makes `device` current, launches on `stream` (PyTorch's
// current stream) and returns cudaGetLastError() as an int.

extern "C" int yk_raygen_trace(int device, const int* px, const int* py, int n, unsigned int sample_index,
                               unsigned int seed, const float* ms, const float* tri, int n_tris, const float* sp,
                               int n_spheres, float* st, int* ph, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Scene sc = {tri, n_tris, sp, n_spheres};
  raygen_trace_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(px, py, n, sample_index, seed, ms, sc,
                                                                           st, ph);
  return (int)cudaGetLastError();
}

extern "C" int yk_bounce(int device, const float* st_in, const int* ph, float* st_out, int n, int dim0, int bounce,
                         int max_depth, const float* ms, const float* tri, int n_tris, const float* trs,
                         const float* mat, const float* lt, int n_lights, const float* sp, int n_spheres,
                         const float* td, int n_td, const unsigned char* tex, int pool_pad, int flags, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BounceArgs a;
  a.st_in = st_in;
  a.ph = ph;
  a.st_out = st_out;
  a.n = n;
  a.dim0 = dim0;
  a.bounce = bounce;
  a.max_depth = max_depth;
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
  bounce_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* yk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
