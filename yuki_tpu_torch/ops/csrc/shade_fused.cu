// Per-bounce shading and resolve kernels of the treelet path for Hopper
// (sm_90a): the CUDA port of yuki_tpu/ops/shade_fused.py's two Pallas
// kernels.
//
//   yk_shade    replaces _shade_kernel (shade_fused.py:798, body _shade_body
//               :360): surface, material tail, emission, NEE setup and
//               sample_li per light, bsdf_sample, beta and Russian roulette.
//   yk_resolve  replaces _resolve_kernel (shade_fused.py:868): miss
//               background, each lit light's contribution, the indirect
//               clamp past bounce 0, and the radiance update.
//
// Design.  One thread per ray (128-thread blocks; lanes are independent, so
// the TPU's 1024-ray blocks carry no meaning here).  Lanes stay in wave
// order: sorting each tile's lanes by material class, as the dense wave's
// bounce kernel does, measured slower on an H100 at every bounce, sorted
// in place and with the tile's planes staged through shared memory, and
// staging the material, light and sphere rows in shared memory gained
// nothing (PERF.md §6).  The sample values are
// the uniform sampler's hash, or a StratifiedSampler's 2L+3 planes of the
// bounce, computed beforehand by the sampler (the TPU kernel's `strat`
// variant, shade_fused.py:1157-1180).  The shade kernel reads
// the ray/hit/carry planes (_RH layout, plane-major so loads coalesce) and
// does the row gathers itself with __ldg: the triangle shading row
// trs[max(prim, 0)] and the material row with the sphere override; where
// the scene has textures the wrapper resolves kd and sigma in torch (as
// yuki_tpu resolves them in XLA) and passes them as planes.  The shading
// maths is shade_lane in path_fused.cuh, the same body the dense wave's
// bounce kernel runs.  It writes the _OUT planes: next ray, beta, liveness,
// the emission term, and per light the parked shadow ray, its t_max,
// worth and contribution.
//
// What bounds them: the shade kernel is ALU- and register-bound (the
// shading body, ~1-2k float operations per lane) with ~200 B read and
// 64 + 48L B written per ray; the resolve kernel is memory-bound, 64 + 20L
// B read and 16 B written per ray, a few adds each.
//
// Numerics: -fmad=false and no fast-math, so only the transcendentals
// (logf, sinf, cosf) may differ by ulps from the plain version.

#include <cuda_runtime.h>

#include <cstdint>

#include "path_fused.cuh"

using namespace yk;

namespace {

constexpr int THREADS = 128;

// _RH plane indices (shade_fused.py:71-74).
constexpr int RH_OX = 0, RH_OY = 1, RH_OZ = 2, RH_DX = 3, RH_DY = 4, RH_DZ = 5;
constexpr int RH_T = 6, RH_B0 = 7, RH_B1 = 8, RH_SPH = 9, RH_ALIVE = 10;
constexpr int RH_BX = 11, RH_BY = 12, RH_BZ = 13, RH_SPEC = 14;

// _OUT plane indices (shade_fused.py:83-89); light li's 12 planes start at
// N_FIXED_OUT + 12 * li: o_s(3) d_s(3) t_s worth contrib(3) pad.
constexpr int OUT_O2 = 0, OUT_D2 = 3, OUT_B2 = 6, OUT_ALIVE2 = 9, OUT_SPEC2 = 10, OUT_NE = 11;
constexpr int OUT_PAD0 = 14, OUT_PAD1 = 15;
constexpr int N_FIXED_OUT = 16, N_PER_LIGHT = 12;

// Resolve input planes (shade_fused.py:870-875): radiance 0-2, beta 3-5,
// alive 6, missed 7, ne 8-10, background 11-13, clamp 14.
constexpr int RS_RAD = 0, RS_BETA = 3, RS_ALIVE = 6, RS_MISSED = 7, RS_NE = 8, RS_BG = 11, RS_CLAMP = 14;

constexpr int FLAG_SIGMA = 1, FLAG_TEX = 4;

// The shade kernel's NEE sink: the _OUT planes of the emission term and of
// each light, dead lanes parked at the scene centre with t_max 0.
struct ShadeSink {
  float* out;
  size_t N;
  V3 center;
  __device__ void put(int plane, float v) { out[plane * N] = v; }
  __device__ void emit(V3 ne) {
    put(OUT_NE, ne.x);
    put(OUT_NE + 1, ne.y);
    put(OUT_NE + 2, ne.z);
  }
  __device__ void light(int li, int, bool worth, V3 o_s, V3 d_s, V3 contrib) {
    int ob = N_FIXED_OUT + N_PER_LIGHT * li;
    if (!worth) {
      o_s = center;
      d_s = v3(0.0f, 0.0f, 1.0f);
    }
    put(ob + 0, o_s.x);
    put(ob + 1, o_s.y);
    put(ob + 2, o_s.z);
    put(ob + 3, d_s.x);
    put(ob + 4, d_s.y);
    put(ob + 5, d_s.z);
    put(ob + 6, worth ? F(0.9999) : 0.0f);
    put(ob + 7, worth ? 1.0f : 0.0f);
    put(ob + 8, contrib.x);
    put(ob + 9, contrib.y);
    put(ob + 10, contrib.z);
    put(ob + 11, 0.0f);
  }
};

__global__ void __launch_bounds__(THREADS)
    shade_kernel(const float* __restrict__ rh, const int* __restrict__ prim, const int* __restrict__ ph_in,
                 const float* __restrict__ texp, int n, int dim0, int bounce, ShadeTables tb, int flags,
                 const float* __restrict__ spl, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const float* s = rh + i;
  ShadeIn in;
  in.o = {s[RH_OX * N], s[RH_OY * N], s[RH_OZ * N]};
  in.d = {s[RH_DX * N], s[RH_DY * N], s[RH_DZ * N]};
  in.t_hit = s[RH_T * N];
  in.b0 = s[RH_B0 * N];
  in.b1 = s[RH_B1 * N];
  in.alive = s[RH_ALIVE * N] > 0.0f;
  in.beta = {s[RH_BX * N], s[RH_BY * N], s[RH_BZ * N]};
  in.spec = s[RH_SPEC * N];

  Rows r = select_rows(tb, (float)prim[i], s[RH_SPH * N]);
  Material mt = material_row(r.mrow);
  if (flags & FLAG_TEX) {
    mt.kd = {texp[i], texp[N + i], texp[2 * N + i]};
    mt.s0 = texp[3 * N + i];
  }

  ShadeSink sink{out + i, N, tb.center};
  const Draws urand{(uint32_t)ph_in[i], (uint32_t)dim0, spl ? spl + i : nullptr, N};
  ShadeOut so = shade_lane(tb, in, r, mt, urand, bounce, sink);
  sink.put(OUT_O2, so.o2.x);
  sink.put(OUT_O2 + 1, so.o2.y);
  sink.put(OUT_O2 + 2, so.o2.z);
  sink.put(OUT_D2, so.d2.x);
  sink.put(OUT_D2 + 1, so.d2.y);
  sink.put(OUT_D2 + 2, so.d2.z);
  sink.put(OUT_B2, so.beta2.x);
  sink.put(OUT_B2 + 1, so.beta2.y);
  sink.put(OUT_B2 + 2, so.beta2.z);
  sink.put(OUT_ALIVE2, so.alive2 ? 1.0f : 0.0f);
  sink.put(OUT_SPEC2, so.spec2 ? 1.0f : 0.0f);
  sink.put(OUT_PAD0, 0.0f);
  sink.put(OUT_PAD1, 0.0f);
}

// Same select/add order as _resolve_kernel (shade_fused.py:876-923).
__global__ void __launch_bounds__(THREADS)
    resolve_kernel(const float* __restrict__ rh, const float* __restrict__ nee, int n, int n_lights, int bounce,
                   int has_clamp, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t N = (size_t)n;
  const float* s = rh + i;
  V3 rad = {s[(RS_RAD + 0) * N], s[(RS_RAD + 1) * N], s[(RS_RAD + 2) * N]};
  V3 beta = {s[(RS_BETA + 0) * N], s[(RS_BETA + 1) * N], s[(RS_BETA + 2) * N]};
  bool alive = s[RS_ALIVE * N] > 0.0f;
  bool missed = s[RS_MISSED * N] > 0.0f;
  V3 br = {s[(RS_NE + 0) * N], s[(RS_NE + 1) * N], s[(RS_NE + 2) * N]};
  V3 bg = {s[(RS_BG + 0) * N], s[(RS_BG + 1) * N], s[(RS_BG + 2) * N]};
  float clamp_v = s[RS_CLAMP * N];

  if (missed) rad = {rad.x + beta.x * bg.x, rad.y + beta.y * bg.y, rad.z + beta.z * bg.z};
  for (int li = 0; li < n_lights; ++li) {
    const float* e = nee + (size_t)5 * li * N + i;  // occ, cx, cy, cz, worth
    bool lit = e[4 * N] > 0.0f && !(e[0] > 0.0f);
    br = {br.x + (lit ? e[N] : 0.0f), br.y + (lit ? e[2 * N] : 0.0f), br.z + (lit ? e[3 * N] : 0.0f)};
  }
  if (has_clamp && bounce > 0) br = {jmin(br.x, clamp_v), jmin(br.y, clamp_v), jmin(br.z, clamp_v)};
  if (alive) rad = {rad.x + beta.x * br.x, rad.y + beta.y * br.y, rad.z + beta.z * br.z};
  out[i] = rad.x;
  out[N + i] = rad.y;
  out[2 * N + i] = rad.z;
  out[3 * N + i] = 0.0f;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

// (cx, cy, cz): the scene centre; diag: the parking distance of distant-light
// shadow-ray targets; spl: a StratifiedSampler's [2L+3, n] values of the
// bounce, or null for the uniform sampler's hash.
extern "C" int yk_shade(int device, const float* rh, const int* prim, const int* ph, const float* texp, int n,
                        int dim0, int bounce, const float* trs, const float* mat, const float* lt, int n_lights,
                        const float* sp, int n_spheres, float cx, float cy, float cz, float diag, int flags,
                        const float* spl, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ShadeTables tb;
  tb.trs = trs;
  tb.mat = mat;
  tb.lt = lt;
  tb.n_lights = n_lights;
  tb.sp = sp;
  tb.n_spheres = n_spheres;
  tb.center = {cx, cy, cz};
  tb.diag = diag;
  tb.has_sigma = (flags & FLAG_SIGMA) != 0;
  shade_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(rh, prim, ph, texp, n, dim0, bounce, tb, flags,
                                                                    spl, out);
  return (int)cudaGetLastError();
}

extern "C" int yk_resolve(int device, const float* rh, const float* nee, int n, int n_lights, int bounce,
                          int has_clamp, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  resolve_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(rh, nee, n, n_lights, bounce, has_clamp, out);
  return (int)cudaGetLastError();
}
