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

constexpr int MAT_MATTE = 0, MAT_GLASS = 1, MAT_METAL = 2, MAT_GLOSSY = 3;
constexpr int LIGHT_POINT = 0, LIGHT_SPOT = 1, LIGHT_RECT = 2;  // else distant (3)

constexpr int FLAG_SIGMA = 1, FLAG_CLAMP = 2, FLAG_TEX = 4;

constexpr int THREADS = 128;

#define INV_PI ((float)(1.0 / YK_PI))

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

// ---- BSDF lobes (shade_fused.py:202-352) --------------------------------

__device__ float fresnel_dielectric(float ct, float eta_i, float eta_t) {
  float ci = jclip(ct, -1.0f, 1.0f);
  bool entering = ci > 0.0f;
  float ei = entering ? eta_i : eta_t;
  float et = entering ? eta_t : eta_i;
  ci = fabsf(ci);
  float si = sqrtf(jmax(1.0f - ci * ci, 0.0f));
  float st = ei / et * si;
  bool tir = st >= 1.0f;
  float ctt = sqrtf(jmax(1.0f - st * st, 0.0f));
  float r_par = (et * ci - ei * ctt) / jmax(et * ci + ei * ctt, F(1e-30));
  float r_per = (ei * ci - et * ctt) / jmax(ei * ci + et * ctt, F(1e-30));
  float fr = 0.5f * (r_par * r_par + r_per * r_per);
  return tir ? 1.0f : fr;
}

__device__ float conductor1(float ci, float ci2, float si2, float eta, float k) {
  float eta2 = eta * eta;
  float etak2 = k * k;
  float t0 = eta2 - etak2 - si2;
  float a2b2 = sqrtf(jmax(t0 * t0 + 4.0f * eta2 * etak2, 0.0f));
  float t1 = a2b2 + ci2;
  float a = sqrtf(jmax(0.5f * (a2b2 + t0), 0.0f));
  float t2 = 2.0f * a * ci;
  float rs = (t1 - t2) / jmax(t1 + t2, F(1e-30));
  float t3 = ci2 * a2b2 + si2 * si2;
  float t4 = t2 * si2;
  float rp = rs * (t3 - t4) / jmax(t3 + t4, F(1e-30));
  return 0.5f * (rp + rs);
}

__device__ V3 fresnel_conductor3(float ct, V3 eta, V3 k) {
  float ci = jmin(fabsf(ct), 1.0f);
  float ci2 = ci * ci;
  float si2 = 1.0f - ci2;
  return {conductor1(ci, ci2, si2, eta.x, k.x), conductor1(ci, ci2, si2, eta.y, k.y),
          conductor1(ci, ci2, si2, eta.z, k.z)};
}

__device__ V3 fresnel_schlick3(float ct, V3 rs) {
  float ci = jclip(ct, -1.0f, 1.0f);
  float p5 = (1.0f - ci) * (1.0f - ci);
  p5 = p5 * p5 * (1.0f - ci);
  return {rs.x + (1.0f - rs.x) * p5, rs.y + (1.0f - rs.y) * p5, rs.z + (1.0f - rs.z) * p5};
}

__device__ __forceinline__ float cos2(V3 w) { return w.z * w.z; }
__device__ __forceinline__ float sin2(V3 w) { return jmax(1.0f - cos2(w), 0.0f); }
__device__ __forceinline__ float tan2(V3 w) {
  float c2 = cos2(w);
  return sin2(w) / (c2 == 0.0f ? F(1e-30) : c2);
}

__device__ float ggx_d(V3 wh, float alpha) {
  float t2 = tan2(wh);
  float a2 = alpha * alpha;
  float c4 = cos2(wh) * cos2(wh);
  float e = t2 / a2;
  float val = 1.0f / (F(YK_PI) * a2 * c4 * (1.0f + e) * (1.0f + e));
  return (isfinite(t2) && c4 > 0.0f) ? val : 0.0f;
}

__device__ float ggx_lambda(V3 w, float alpha) {
  float abs_tan = sqrtf(jmax(tan2(w), 0.0f));
  float at = alpha * abs_tan;
  float a2t2 = at * at;
  float lam = (-1.0f + sqrtf(1.0f + a2t2)) / 2.0f;
  return isfinite(abs_tan) ? lam : 0.0f;
}

__device__ float ggx_g(V3 wo, V3 wi, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha));
}

// Metal: conductor Fresnel; glossy: Schlick.
__device__ V3 microfacet_fresnel(int mtype, V3 c0, V3 c1, V3 wo_l, V3 wi_l) {
  V3 wh = normalize_safe(add(wi_l, wo_l));
  wh = wh.z < 0.0f ? neg(wh) : wh;
  float ci = dot(wi_l, wh);
  return mtype == MAT_METAL ? fresnel_conductor3(ci, c0, c1) : fresnel_schlick3(ci, c0);
}

__device__ V3 microfacet_f(V3 wo_l, V3 wi_l, float alpha, V3 fr) {
  float cto = fabsf(wo_l.z);
  float cti = fabsf(wi_l.z);
  V3 wh_raw = add(wi_l, wo_l);
  bool wh_ok = (wh_raw.x != 0.0f || wh_raw.y != 0.0f || wh_raw.z != 0.0f) && cto > 0.0f && cti > 0.0f;
  V3 wh = normalize_safe(wh_raw);
  float d = ggx_d(wh, alpha);
  float g = ggx_g(wo_l, wi_l, alpha);
  float denom = jmax(4.0f * cti * cto, F(1e-30));
  float s = d * g / denom;
  return wh_ok ? v3(fr.x * s, fr.y * s, fr.z * s) : zero3();
}

__device__ __forceinline__ float cos_phi(V3 w, float st) {
  return st == 0.0f ? 1.0f : jclip(w.x / (st == 0.0f ? 1.0f : st), -1.0f, 1.0f);
}
__device__ __forceinline__ float sin_phi(V3 w, float st) {
  return st == 0.0f ? 1.0f : jclip(w.y / (st == 0.0f ? 1.0f : st), -1.0f, 1.0f);
}

// Lambert, or Oren-Nayar when the scene has sigma and this material's
// sigma is nonzero.
__device__ V3 matte_f(bool has_sigma, V3 kd, float s0, V3 wo_l, V3 wi_l) {
  V3 lam = scale(kd, INV_PI);
  V3 f = lam;
  if (has_sigma && !(s0 == 0.0f)) {
    float sigma2 = s0 * s0;
    float a = 1.0f - sigma2 / (2.0f * (sigma2 + F(0.33)));
    float b = F(0.45) * sigma2 / (sigma2 + F(0.09));
    float sti = sqrtf(sin2(wo_l));
    float sto = sqrtf(sin2(wi_l));
    bool both = sti > F(1e-4) && sto > F(1e-4);
    float d_cos = cos_phi(wo_l, sti) * cos_phi(wi_l, sto) + sin_phi(wo_l, sti) * sin_phi(wi_l, sto);
    float max_cos = both ? jmax(d_cos, 0.0f) : 0.0f;
    float cti = fabsf(wo_l.z);
    float cto = fabsf(wi_l.z);
    bool first = cti > cto;
    float sin_alpha = first ? sto : sti;
    float tan_beta = first ? sti / jmax(cti, F(1e-30)) : sto / jmax(cto, F(1e-30));
    float on_s = INV_PI * (a + b * max_cos * sin_alpha * tan_beta);
    f = scale(kd, on_s);
  }
  return is_black(kd) ? zero3() : f;
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

__global__ void __launch_bounds__(THREADS) bounce_kernel(BounceArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t N = (size_t)a.n;
  const float* s = a.st_in + i;
  const uint32_t ph = (uint32_t)a.ph[i];
  const bool has_sigma = (a.flags & FLAG_SIGMA) != 0;
  const bool has_clamp = (a.flags & FLAG_CLAMP) != 0;
  const bool has_tex = (a.flags & FLAG_TEX) != 0;
  const uint32_t dim0 = (uint32_t)a.dim0;
  const int n_lights = a.n_lights;

  V3 o = {s[ST_OX * N], s[ST_OY * N], s[ST_OZ * N]};
  V3 d = {s[ST_DX * N], s[ST_DY * N], s[ST_DZ * N]};
  V3 beta = {s[ST_BX * N], s[ST_BY * N], s[ST_BZ * N]};
  V3 rad = {s[ST_RX * N], s[ST_RY * N], s[ST_RZ * N]};
  bool alive_in = s[ST_ALIVE * N] > 0.0f;
  float spec = s[ST_SPEC * N];
  float rc = s[ST_RC * N];
  float t_hit = s[ST_T * N];
  float b0 = s[ST_B0 * N];
  float b1 = s[ST_B1 * N];
  float prim = s[ST_PRIM * N];
  float sph = s[ST_SPH * N];
  bool hitf = s[ST_HITF * N] > 0.0f;

  bool missed = alive_in && !hitf;
  bool alive_h = alive_in && hitf;

  // Triangle shading row and material row; negative ids read row 0.
  const float* trp = a.trs + 32 * (int)jmax(prim, 0.0f);
  float mid = __ldg(trp + 26);
  // A sphere lane shades as sphere `si`; an id naming no sphere keeps the
  // triangle surface (as the JAX per-sphere selects do).
  bool is_sph = sph >= 0.0f;
  int si = (is_sph && sph < (float)a.sc.n_spheres) ? (int)sph : -1;
  bool sph_valid = si >= 0 && (float)si == sph;
  if (sph_valid) mid = __ldg(a.sc.sp + 40 * si + 34);
  const float* mrow = a.mat + 16 * (int)jmax(mid, 0.0f);
  int mtype = (int)__ldg(mrow + 0);
  V3 kd = {__ldg(mrow + 1), __ldg(mrow + 2), __ldg(mrow + 3)};
  V3 c1 = {__ldg(mrow + 4), __ldg(mrow + 5), __ldg(mrow + 6)};
  float s0 = __ldg(mrow + 7);
  bool remap = __ldg(mrow + 8) > 0.5f;
  if (has_tex) {
    float tex0 = __ldg(mrow + 9);
    if (tex0 >= 0.0f) {
      float b2 = 1.0f - b0 - b1;
      float uv_s = __ldg(trp + 18) * b0 + __ldg(trp + 20) * b1 + __ldg(trp + 22) * b2;
      float uv_t = __ldg(trp + 19) * b0 + __ldg(trp + 21) * b1 + __ldg(trp + 23) * b2;
      int idx = tex_index(a, tex0, uv_s, uv_t);
      const uint8_t* tx = a.tex + 3 * idx;
      kd = {(float)__ldg(tx + 0) / 255.0f, (float)__ldg(tx + 1) / 255.0f, (float)__ldg(tx + 2) / 255.0f};
    }
  }

  // ---- surface (surface.make_surface; shade_fused.py:395-509) ----------
  V3 wo = neg(d);
  V3 p, n, ns, ss;
  float area_light;
  if (!sph_valid) {
    V3 p0 = {__ldg(trp + 0), __ldg(trp + 1), __ldg(trp + 2)};
    V3 p1 = {__ldg(trp + 3), __ldg(trp + 4), __ldg(trp + 5)};
    V3 p2 = {__ldg(trp + 6), __ldg(trp + 7), __ldg(trp + 8)};
    V3 n0 = {__ldg(trp + 9), __ldg(trp + 10), __ldg(trp + 11)};
    V3 n1 = {__ldg(trp + 12), __ldg(trp + 13), __ldg(trp + 14)};
    V3 n2 = {__ldg(trp + 15), __ldg(trp + 16), __ldg(trp + 17)};
    float uv0s = __ldg(trp + 18), uv0t = __ldg(trp + 19);
    float uv1s = __ldg(trp + 20), uv1t = __ldg(trp + 21);
    float uv2s = __ldg(trp + 22), uv2t = __ldg(trp + 23);
    bool has_ns = __ldg(trp + 24) > 0.5f;
    bool swaps = __ldg(trp + 25) > 0.5f;
    area_light = __ldg(trp + 27);
    float b2 = 1.0f - b0 - b1;
    p = add(add(scale(p0, b0), scale(p1, b1)), scale(p2, b2));
    V3 dp02 = sub(p0, p2);
    V3 dp12 = sub(p1, p2);
    float duv02s = uv0s - uv2s, duv02t = uv0t - uv2t;
    float duv12s = uv1s - uv2s, duv12t = uv1t - uv2t;
    float uv_det = duv02s * duv12t - duv02t * duv12s;
    bool degen_uv = uv_det == 0.0f;
    float inv_uv_det = 1.0f / (degen_uv ? 1.0f : uv_det);
    V3 dpdu = scale(sub(scale(dp02, duv12t), scale(dp12, duv02t)), inv_uv_det);
    if (degen_uv) dpdu = coordinate_v2(normalize_safe(cross(sub(p2, p0), sub(p1, p0))));
    V3 n_wind = normalize_safe(cross(dp02, dp12));
    if (swaps) n_wind = neg(n_wind);
    V3 ns_raw = add(add(scale(n0, b0), scale(n1, b1)), scale(n2, b2));
    bool ns_ok = dot(ns_raw, ns_raw) > 0.0f;
    V3 ns_auth = ns_ok ? normalize_safe(ns_raw) : n_wind;
    V3 ss0 = normalize_safe(dpdu);
    V3 ts_raw = cross(ss0, ns_auth);
    bool ts_ok = dot(ts_raw, ts_raw) > 0.0f;
    V3 ss_auth = ts_ok ? cross(normalize_safe(ts_raw), ns_auth) : coordinate_v2(ns_auth);
    ns = has_ns ? ns_auth : n_wind;
    ss = has_ns ? ss_auth : ss0;
    n = has_ns ? face_forward(n_wind, ns_auth) : n_wind;
  } else {
    const float* m = a.sc.sp + 40 * si;
#define M(k) __ldg(m + (k))
    V3 ro = {M(0) * o.x + M(1) * o.y + M(2) * o.z + M(3), M(4) * o.x + M(5) * o.y + M(6) * o.z + M(7),
             M(8) * o.x + M(9) * o.y + M(10) * o.z + M(11)};
    V3 rd = {M(0) * d.x + M(1) * d.y + M(2) * d.z, M(4) * d.x + M(5) * d.y + M(6) * d.z,
             M(8) * d.x + M(9) * d.y + M(10) * d.z};
    float radius = M(32);
    V3 p_obj = add(ro, scale(rd, t_hit));
    float scale_fix = radius / jmax(sqrtf(dot(p_obj, p_obj)), F(1e-20));
    p_obj = scale(p_obj, scale_fix);
    bool fix = p_obj.x == 0.0f && p_obj.y == 0.0f;
    float px_ = fix ? F(1e-5) * radius : p_obj.x;
    float py_ = p_obj.y;
    float pz_ = p_obj.z;
    V3 dpdu_o = {-py_ * F(2.0 * YK_PI), px_ * F(2.0 * YK_PI), 0.0f};
    V3 n_obj = normalize_safe(v3(px_, py_, pz_));
    if (M(33) > 0.5f) n_obj = neg(n_obj);
    p = {M(16) * px_ + M(17) * py_ + M(18) * pz_ + M(19), M(20) * px_ + M(21) * py_ + M(22) * pz_ + M(23),
         M(24) * px_ + M(25) * py_ + M(26) * pz_ + M(27)};
    n = normalize_safe(v3(M(0) * n_obj.x + M(4) * n_obj.y + M(8) * n_obj.z,
                          M(1) * n_obj.x + M(5) * n_obj.y + M(9) * n_obj.z,
                          M(2) * n_obj.x + M(6) * n_obj.y + M(10) * n_obj.z));
    V3 dpdu_w = {M(16) * dpdu_o.x + M(17) * dpdu_o.y + M(18) * dpdu_o.z,
                 M(20) * dpdu_o.x + M(21) * dpdu_o.y + M(22) * dpdu_o.z,
                 M(24) * dpdu_o.x + M(25) * dpdu_o.y + M(26) * dpdu_o.z};
#undef M
    ns = n;
    ss = normalize_safe(dpdu_w);
  }
  if (is_sph) area_light = -1.0f;
  V3 ts_frame = cross(ns, ss);

  // ---- materials (alpha resolve) ---------------------------------------
  float lx = logf(jmax(s0, F(1e-3)));
  float r2a = F(1.62142) + F(0.819955) * lx + F(0.1734) * lx * lx + F(0.0171201) * lx * lx * lx +
              F(0.000640711) * lx * lx * lx * lx;
  float rough = remap ? r2a : s0;
  if (mtype == MAT_GLOSSY) rough = rough * rough;
  float alpha = jmax(rough, F(1e-3));

  V3 wo_l = {dot(wo, ss), dot(wo, ts_frame), dot(wo, ns)};
  float wo_n = dot(wo, n);

  const float center_x = __ldg(a.ms + MS_CENTER), center_y = __ldg(a.ms + MS_CENTER + 1),
              center_z = __ldg(a.ms + MS_CENTER + 2);
  const V3 center = {center_x, center_y, center_z};

  // ---- emitted (area_light_radiance) -----------------------------------
  V3 le = zero3();
  if (area_light >= 0.0f && area_light < (float)n_lights) {
    int al = (int)area_light;
    if ((float)al == area_light) {
      const float* lr = a.lt + 32 * al;
      le = {__ldg(lr + 4) + 0.0f, __ldg(lr + 5) + 0.0f, __ldg(lr + 6) + 0.0f};
    }
  }
  bool front_e = dot(n, wo) > 0.0f;
  bool has_al = area_light >= 0.0f;
  V3 emitted = (has_al && front_e) ? le : zero3();
  bool emit_mask = spec > 0.0f || a.bounce == 0;
  V3 br = emit_mask ? v3(beta.x * emitted.x, beta.y * emitted.y, beta.z * emitted.z) : zero3();

  // ---- NEE per light: setup, occlusion, fold into br -------------------
  V3 off = scale(n, F(1e-3));
  for (int li = 0; li < n_lights; ++li) {
    const float* lr = a.lt + 32 * li;
#define LT(k) __ldg(lr + (k))
    int ltype = (int)LT(0);
    float u0 = dim_f32(ph, dim0 + (uint32_t)(2 * li));
    float u1 = dim_f32(ph, dim0 + (uint32_t)(2 * li + 1));
    V3 l_i = {LT(4), LT(5), LT(6)};
    V3 li_v, l_dir, target;
    float pdf = 1.0f;
    if (ltype == LIGHT_POINT) {
      V3 lp = {LT(1), LT(2), LT(3)};
      V3 to_l = sub(lp, p);
      float d2 = jmax(dot(to_l, to_l), F(1e-30));
      li_v = scale(l_i, 1.0f / d2);
      l_dir = scale(to_l, 1.0f / sqrtf(d2));
      target = {lp.x + 0.0f, lp.y + 0.0f, lp.z + 0.0f};
    } else if (ltype == LIGHT_SPOT) {
      V3 lp = {LT(1), LT(2), LT(3)};
      V3 to_l = sub(lp, p);
      float d2 = jmax(dot(to_l, to_l), F(1e-30));
      l_dir = scale(to_l, 1.0f / sqrtf(d2));
      V3 nl = neg(l_dir);
      V3 dl = normalize_safe(v3(LT(7) * nl.x + LT(8) * nl.y + LT(9) * nl.z,
                                LT(11) * nl.x + LT(12) * nl.y + LT(13) * nl.z,
                                LT(15) * nl.x + LT(16) * nl.y + LT(17) * nl.z));
      float ct = dl.z;
      float cos_w = LT(24), cos_f = LT(25);
      float delta = (ct - cos_w) / jmax(cos_f - cos_w, F(1e-30));
      float fall = ct < cos_w ? 0.0f : (ct > cos_f ? 1.0f : (delta * delta) * (delta * delta));
      li_v = scale(l_i, fall / d2);
      target = {lp.x + 0.0f, lp.y + 0.0f, lp.z + 0.0f};
    } else if (ltype == LIGHT_RECT) {
      V3 ps = {LT(7) * u0 + LT(9) * u1 + LT(10), LT(11) * u0 + LT(13) * u1 + LT(14),
               LT(15) * u0 + LT(17) * u1 + LT(18)};
      float nln = sqrtf(jmax(LT(8) * LT(8) + LT(12) * LT(12) + LT(16) * LT(16), F(1e-40)));
      V3 ln = {-LT(8) / nln + 0.0f, -LT(12) / nln + 0.0f, -LT(16) / nln + 0.0f};
      V3 wi_ = normalize_safe(sub(ps, p));
      float ndw = dot(ln, neg(wi_));
      li_v = ndw > 0.0f ? l_i : zero3();
      float d2 = dot(sub(ps, p), sub(ps, p));
      pdf = d2 / jmax(fabsf(ndw) * LT(23), F(1e-30));
      l_dir = wi_;
      target = ps;
    } else {  // distant: SceneBuilder makes no other light type
      li_v = {l_i.x + 0.0f, l_i.y + 0.0f, l_i.z + 0.0f};
      l_dir = {LT(1) + 0.0f, LT(2) + 0.0f, LT(3) + 0.0f};
      target = add(p, scale(l_dir, __ldg(a.ms + MS_DIAG)));
    }

    // bsdf_f(l_dir)
    V3 wi_l = {dot(l_dir, ss), dot(l_dir, ts_frame), dot(l_dir, ns)};
    bool reflect = (dot(l_dir, n) * wo_n) > 0.0f;
    V3 f_nee = zero3();
    if (mtype == MAT_MATTE) {
      f_nee = matte_f(has_sigma, kd, s0, wo_l, wi_l);
    } else if (mtype == MAT_METAL || mtype == MAT_GLOSSY) {
      f_nee = microfacet_f(wo_l, wi_l, alpha, microfacet_fresnel(mtype, kd, c1, wo_l, wi_l));
    }
    if (!reflect) f_nee = zero3();

    float cos_ = jclip(dot(ns, l_dir), 0.0f, 1.0f);
    bool worth = alive_h && !is_black(li_v) && !is_black(f_nee) && cos_ > 0.0f;
    bool side = dot(sub(target, p), n) > 0.0f;
    V3 o_s = side ? add(p, off) : sub(p, off);
    V3 d_s = sub(target, o_s);
    float k_ = cos_ / jmax(pdf, F(1e-30));
    V3 contrib = {f_nee.x * li_v.x * k_, f_nee.y * li_v.y * k_, f_nee.z * li_v.z * k_};
    // A lane that is not worth it traces with t_max = 0, which never hits.
    bool lit = false;
    if (worth) {
      int skip = ltype == LIGHT_RECT ? li : -2;
      lit = !occluded(a.sc, a.trs, skip, o_s, d_s, F(0.9999));
    }
    br = {br.x + (lit ? contrib.x : 0.0f), br.y + (lit ? contrib.y : 0.0f), br.z + (lit ? contrib.z : 0.0f)};
#undef LT
  }

  // ---- bsdf_sample (shade_fused.py:666-778) ----------------------------
  float u0 = dim_f32(ph, dim0 + (uint32_t)(2 * n_lights));
  float u1 = dim_f32(ph, dim0 + (uint32_t)(2 * n_lights + 1));
  V3 wi_l = zero3(), f_s = zero3();
  float pdf = 0.0f;
  if (mtype == MAT_MATTE) {
    float ox_ = u0 * 2.0f - 1.0f;
    float oy_ = u1 * 2.0f - 1.0f;
    bool degen = ox_ == 0.0f && oy_ == 0.0f;
    float ox_s = ox_ == 0.0f ? 1.0f : ox_;
    float oy_s = oy_ == 0.0f ? 1.0f : oy_;
    bool use_x = fabsf(ox_) > fabsf(oy_);
    float theta = use_x ? F(YK_PI / 4.0) * (oy_ / ox_s) : F(YK_PI / 2.0) - F(YK_PI / 4.0) * (ox_ / oy_s);
    float r_ = use_x ? ox_ : oy_;
    float dx_ = degen ? 0.0f : cosf(theta) * r_;
    float dy_ = degen ? 0.0f : sinf(theta) * r_;
    float z_ = sqrtf(jmax(1.0f - dx_ * dx_ - dy_ * dy_, 0.0f));
    wi_l = {dx_, dy_, wo_l.z < 0.0f ? -z_ : z_};
    pdf = fabsf(wi_l.z) * INV_PI;
    f_s = matte_f(has_sigma, kd, s0, wo_l, wi_l);
  } else if (mtype == MAT_GLASS) {
    bool pick_refl = u0 < 0.5f;
    float eta_i = wo_l.z > 0.0f ? 1.0f : s0;
    float eta_t = wo_l.z > 0.0f ? s0 : 1.0f;
    float eta = eta_i / eta_t;
    float n_ff = wo_l.z > 0.0f ? 1.0f : -1.0f;
    float cti = n_ff * wo_l.z;
    float s2ti = jmax(1.0f - cti * cti, 0.0f);
    float s2tt = eta * eta * s2ti;
    bool tir = s2tt >= 1.0f;
    if (pick_refl) {
      V3 wi_re = {-wo_l.x, -wo_l.y, wo_l.z};
      float fr_re = fresnel_dielectric(wi_re.z, 1.0f, s0);
      float sc_re = fr_re / jmax(fabsf(wi_re.z), F(1e-30));
      wi_l = wi_re;
      f_s = scale(kd, sc_re);
    } else {
      float ctt = sqrtf(jmax(1.0f - s2tt, 0.0f));
      float k_ = eta * cti - ctt;
      V3 wi_tr = {-wo_l.x * eta, -wo_l.y * eta, -wo_l.z * eta + n_ff * k_};
      float fr_tr = fresnel_dielectric(wi_tr.z, 1.0f, s0);
      float sc_tr = (1.0f - fr_tr) / jmax(fabsf(wi_tr.z), F(1e-30));
      wi_l = wi_tr;
      f_s = tir ? zero3() : scale(c1, sc_tr);
    }
    pdf = (pick_refl || !tir) ? 0.5f : 0.0f;
  } else {  // metal / glossy: ggx_sample_wh (non-visible-area)
    float tan2t = alpha * alpha * u0 / jmax(1.0f - u0, F(1e-7));
    float ct_h = 1.0f / sqrtf(1.0f + tan2t);
    float phi_h = F(2.0 * YK_PI) * u1;
    float st_h = sqrtf(jmax(1.0f - ct_h * ct_h, 0.0f));
    V3 wh = {st_h * cosf(phi_h), st_h * sinf(phi_h), ct_h};
    if (!(wo_l.z * wh.z > 0.0f)) wh = neg(wh);
    float dwh = dot(wo_l, wh);
    V3 wi_mf = add(neg(wo_l), scale(wh, 2.0f * dwh));
    bool mf_valid = wo_l.z != 0.0f && dwh >= 0.0f && wo_l.z * wi_mf.z > 0.0f;
    float pdf_mf = (ggx_d(wh, alpha) * wh.z) / jmax(4.0f * dwh, F(1e-30));
    V3 f_mf = microfacet_f(wo_l, wi_mf, alpha, microfacet_fresnel(mtype, kd, c1, wo_l, wi_mf));
    wi_l = wi_mf;
    pdf = mf_valid ? pdf_mf : 0.0f;
    f_s = mf_valid ? f_mf : zero3();
  }
  bool spec2 = mtype == MAT_GLASS;

  V3 wi_w = {ss.x * wi_l.x + ts_frame.x * wi_l.y + ns.x * wi_l.z,
             ss.y * wi_l.x + ts_frame.y * wi_l.y + ns.y * wi_l.z,
             ss.z * wi_l.x + ts_frame.z * wi_l.y + ns.z * wi_l.z};

  bool terminated = is_black(f_s) || pdf == 0.0f;
  bool alive2 = alive_h && !terminated;
  float bscale = fabsf(dot(wi_w, ns)) / jmax(pdf, F(1e-30));
  V3 beta2 = {beta.x * f_s.x * bscale, beta.y * f_s.y * bscale, beta.z * f_s.z * bscale};
  bool finite = isfinite(beta2.x) && isfinite(beta2.y) && isfinite(beta2.z);
  alive2 = alive2 && finite;
  if (!finite) beta2 = zero3();

  // spawn_ray + park
  bool side2 = dot(wi_w, n) > 0.0f;
  V3 o2 = side2 ? add(p, off) : sub(p, off);
  if (!alive2) o2 = center;
  V3 d2v = alive2 ? wi_w : v3(0.0f, 0.0f, 1.0f);

  // Russian roulette after bounce 3.
  if (a.bounce > 3) {
    float q = jmax(F(0.05), 1.0f - beta2.y);
    float r_rr = dim_f32(ph, dim0 + (uint32_t)(2 * n_lights + 2));
    alive2 = alive2 && !(r_rr < q);
    float inv_keep = 1.0f / jmax(1.0f - q, F(1e-30));
    beta2 = scale(beta2, inv_keep);
  }

  // ---- resolve (path_fused.py:660-698) ---------------------------------
  if (missed) {
    rad = {rad.x + beta.x * __ldg(a.ms + MS_BG), rad.y + beta.y * __ldg(a.ms + MS_BG + 1),
           rad.z + beta.z * __ldg(a.ms + MS_BG + 2)};
  }
  if (has_clamp && a.bounce > 0) {
    float cv = __ldg(a.ms + MS_CLAMP);
    br = {jmin(br.x, cv), jmin(br.y, cv), jmin(br.z, cv)};
  }
  if (alive_h) rad = {rad.x + beta.x * br.x, rad.y + beta.y * br.y, rad.z + beta.z * br.z};

  bool not_last = a.bounce < a.max_depth - 1;
  float rc2 = rc + (alive2 ? 1.0f : 0.0f) * (not_last ? 1.0f : 0.0f);

  // Next ray's closest hit; a dead lane traces with t_max = 0, which
  // leaves (t, prim, b0, b1, sph, hitf) = (0, -1, 0, 0, -1, 0).
  Hit nh = {0.0f, 0.0f, 0.0f, -1.0f, -1.0f, 0.0f};
  if (not_last && alive2) nh = trace_scene(a.sc, o2, d2v, YK_F32_MAX);

  float* out = a.st_out + i;
  out[ST_OX * N] = o2.x;
  out[ST_OY * N] = o2.y;
  out[ST_OZ * N] = o2.z;
  out[ST_DX * N] = d2v.x;
  out[ST_DY * N] = d2v.y;
  out[ST_DZ * N] = d2v.z;
  out[ST_BX * N] = beta2.x;
  out[ST_BY * N] = beta2.y;
  out[ST_BZ * N] = beta2.z;
  out[ST_RX * N] = rad.x;
  out[ST_RY * N] = rad.y;
  out[ST_RZ * N] = rad.z;
  out[ST_ALIVE * N] = alive2 ? 1.0f : 0.0f;
  out[ST_SPEC * N] = spec2 ? 1.0f : 0.0f;
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
