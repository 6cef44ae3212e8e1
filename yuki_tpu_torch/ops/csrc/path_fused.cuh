// Device maths shared by the port's kernels (path_fused.cu, shade_fused.cu,
// trace_treelets.cu): the sampler hash, SoA vector helpers, the watertight
// triangle test, the object-space sphere test, the BSDF lobes, the
// per-bounce shading body, and the host's shared-memory opt-in.
//
// Every formula keeps yuki_tpu's op order (ops/trace.py, ops/path_fused.py,
// ops/shade_fused.py) and the file is compiled with -fmad=false, so each
// product and sum rounds on its own as in the JAX and PyTorch versions.
// Constants are written F(double literal): a double rounded once to float,
// as a Python float meeting a float32 array is.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#define F(x) ((float)(x))
#define YK_F32_MAX 3.4028235e38f
#define YK_PI 3.14159265358979323846

namespace yk {

// ---- NaN-propagating min/max: jnp.maximum / torch.clamp semantics -------

__device__ __forceinline__ float jmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : (b > a ? b : fmaxf(a, b));
}

__device__ __forceinline__ float jmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : (b < a ? b : fminf(a, b));
}

__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// ---- launch helper (host) -----------------------------------------------

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// opt in); a table too large for the card gives the launch's error.
inline cudaError_t allow_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- counter-based sampler (sampling.py pcg_hash) -----------------------

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

// u32_to_unit_float(pcg(ph ^ dim)): 24 high bits / 2^24.
__device__ __forceinline__ float dim_f32(uint32_t ph, uint32_t dim) {
  uint32_t u = pcg(ph ^ dim);
  return (float)(u >> 8u) * 5.9604644775390625e-08f;
}

// ---- SoA-style 3-vectors ------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel3(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ bool is_black(V3 c) { return c.x == 0.0f && c.y == 0.0f && c.z == 0.0f; }
__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }

// vecmath.normalize_safe: v / max(|v|, 1e-20)
__device__ __forceinline__ V3 normalize_safe(V3 a) {
  float l = sqrtf(dot(a, a));
  float inv = 1.0f / jmax(l, F(1e-20));
  return scale(a, inv);
}

// vecmath.coordinate_system: returns v2; v3 = cross(v1, v2).
__device__ __forceinline__ V3 coordinate_v2(V3 v1) {
  bool use_x = fabsf(v1.x) > fabsf(v1.y);
  float inv_a = 1.0f / sqrtf(jmax(v1.x * v1.x + v1.z * v1.z, F(1e-40)));
  float inv_b = 1.0f / sqrtf(jmax(v1.y * v1.y + v1.z * v1.z, F(1e-40)));
  return {use_x ? -v1.z * inv_a : 0.0f, use_x ? 0.0f : v1.z * inv_b,
          use_x ? v1.x * inv_a : -v1.y * inv_b};
}

__device__ __forceinline__ V3 face_forward(V3 n, V3 v) {
  return dot(n, v) < 0.0f ? neg(n) : n;
}

// ---- watertight triangle test (ops/trace.py:120-173) --------------------

// Per-ray part of the test: the axis permutation and the shear.  It depends
// only on the ray, so it is computed once per sweep; the values are the
// ones the JAX form recomputes per triangle.
struct Shear {
  bool x_max, y_max;
  float sx, sy, inv_dz;
};

__device__ __forceinline__ float permx(const Shear& s, float vx, float vy, float vz) {
  return s.x_max ? vy : (s.y_max ? vz : vx);
}
__device__ __forceinline__ float permy(const Shear& s, float vx, float vy, float vz) {
  return s.x_max ? vz : (s.y_max ? vx : vy);
}
__device__ __forceinline__ float permz(const Shear& s, float vx, float vy, float vz) {
  return s.x_max ? vx : (s.y_max ? vy : vz);
}

__device__ __forceinline__ Shear make_shear(V3 d) {
  Shear s;
  float adx = fabsf(d.x), ady = fabsf(d.y), adz = fabsf(d.z);
  s.x_max = (adx > ady) && (adx > adz);
  s.y_max = (!s.x_max) && (ady > adz);
  float ddx = permx(s, d.x, d.y, d.z);
  float ddy = permy(s, d.x, d.y, d.z);
  float ddz = permz(s, d.x, d.y, d.z);
  s.inv_dz = 1.0f / ddz;
  s.sx = -ddx * s.inv_dz;
  s.sy = -ddy * s.inv_dz;
  return s;
}

// The staged copy a ray's shear frame reads: 0 (z largest), 1 (x), 2 (y).
__device__ __forceinline__ int frame_of(const Shear& sh) { return sh.x_max ? 1 : (sh.y_max ? 2 : 0); }

// The shear frames (bit f: frame f) of the `frame`s of a block of THREADS
// threads, to every thread (frame -1: none); w: THREADS / 32 ints of
// shared memory.  A warp OR and a plain barrier: with one __syncthreads_or
// a frame, ptxas repeated a barrier of the three inside a later staging
// loop whose trip count differs between threads, an illegal instruction
// on the card.
template <int THREADS>
__device__ __forceinline__ int block_frames(int frame, int* w) {
  const int bits = __reduce_or_sync(0xffffffffu, frame >= 0 ? 1 << frame : 0);
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = bits;
  __syncthreads();
  int frames = 0;
#pragma unroll
  for (int k = 0; k < THREADS / 32; ++k) frames |= w[k];
  return frames;
}

// One triangle (corners p0, p1, p2) against one ray.  Returns hit; t
// (F32_MAX on a miss), b0, b1 through the references.
__device__ __forceinline__ bool watertight9(const Shear& s, V3 o, float t_cur, float c0, float c1, float c2,
                                           float c3, float c4, float c5, float c6, float c7, float c8, float& t,
                                           float& b0, float& b1) {
  float a0x = c0 - o.x, a0y = c1 - o.y, a0z = c2 - o.z;
  float a1x = c3 - o.x, a1y = c4 - o.y, a1z = c5 - o.z;
  float a2x = c6 - o.x, a2y = c7 - o.y, a2z = c8 - o.z;
  float p0tx = permx(s, a0x, a0y, a0z), p0ty = permy(s, a0x, a0y, a0z), p0tz = permz(s, a0x, a0y, a0z);
  float p1tx = permx(s, a1x, a1y, a1z), p1ty = permy(s, a1x, a1y, a1z), p1tz = permz(s, a1x, a1y, a1z);
  float p2tx = permx(s, a2x, a2y, a2z), p2ty = permy(s, a2x, a2y, a2z), p2tz = permz(s, a2x, a2y, a2z);
  p0tx = p0tx + s.sx * p0tz;
  p0ty = p0ty + s.sy * p0tz;
  p1tx = p1tx + s.sx * p1tz;
  p1ty = p1ty + s.sy * p1tz;
  p2tx = p2tx + s.sx * p2tz;
  p2ty = p2ty + s.sy * p2tz;

  float e0 = p1tx * p2ty - p1ty * p2tx;
  float e1 = p2tx * p0ty - p2ty * p0tx;
  float e2 = p0tx * p1ty - p0ty * p1tx;

  bool miss_sign = (e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) && (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f);
  float det = e0 + e1 + e2;
  bool miss_det = det == 0.0f;
  float det_safe = miss_det ? 1.0f : det;
  float t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * s.inv_dz;
  bool negd = det < 0.0f;
  float bound = t_cur * det;
  bool miss_range = (negd && (t_scaled >= 0.0f || t_scaled < bound)) ||
                    (!negd && (t_scaled <= 0.0f || t_scaled > bound));
  float inv_det = 1.0f / det_safe;
  bool hit = !(miss_sign || miss_det || miss_range);
  t = hit ? t_scaled * inv_det : YK_F32_MAX;
  b0 = e0 * inv_det;
  b1 = e1 * inv_det;
  return hit;
}

// The same test against one [12]-float triangle row staged in shared
// memory as three float4s (corners p0, p1, p2 in the first nine floats):
// three 16-byte loads, broadcast to the warp when its lanes sweep the same
// triangle.
__device__ __forceinline__ bool watertight_row(const Shear& s, V3 o, float t_cur, const float4* c, float& t,
                                              float& b0, float& b1) {
  const float4 c0 = c[0], c1 = c[1], c2 = c[2];
  return watertight9(s, o, t_cur, c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w, c2.x, t, b0, b1);
}

// One step of a closest sweep (the raygen kernel's camera sweep, the dense
// closest sweep) on a triangle whose corners are already translated to the
// ray's origin and permuted into its shear frame, the values watertight9
// selects: watertight9's operations in its order against the running t,
// the divide only for a test that passes its sign, det and range tests
// (then det != 0, so det_safe = det), and b0, b1 only when ti < t and
// `eligible` take the hit.  Returns whether it took it.
__device__ __forceinline__ bool sweep_take(const Shear& s, float p0tx, float p0ty, float p0tz, float p1tx,
                                           float p1ty, float p1tz, float p2tx, float p2ty, float p2tz,
                                           bool eligible, float& t, float& b0, float& b1) {
  p0tx = p0tx + s.sx * p0tz;
  p0ty = p0ty + s.sy * p0tz;
  p1tx = p1tx + s.sx * p1tz;
  p1ty = p1ty + s.sy * p1tz;
  p2tx = p2tx + s.sx * p2tz;
  p2ty = p2ty + s.sy * p2tz;
  const float e0 = p1tx * p2ty - p1ty * p2tx;
  const float e1 = p2tx * p0ty - p2ty * p0tx;
  const float e2 = p0tx * p1ty - p0ty * p1tx;
  const bool miss_sign = (e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) && (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f);
  const float det = e0 + e1 + e2;
  const float t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * s.inv_dz;
  const bool negd = det < 0.0f;
  const float bound = t * det;
  const bool miss_range = (negd && (t_scaled >= 0.0f || t_scaled < bound)) ||
                          (!negd && (t_scaled <= 0.0f || t_scaled > bound));
  if (miss_sign || det == 0.0f || miss_range) return false;
  const float inv_det = 1.0f / det;
  const float ti = t_scaled * inv_det;
  if (!(ti < t && eligible)) return false;
  t = ti;
  b0 = e0 * inv_det;
  b1 = e1 * inv_det;
  return true;
}

// The occlusion form of sweep_take (the dense occlusion sweep): its
// operations up to the range test against t_max, in its order, and no
// divide; whether the triangle hits within (0, t_max] (trace.py:159-171:
// an occlusion hit needs no t, b0 or b1).  Written out, not shared with
// sweep_take: a shared test with its values as outputs cost the closest
// sweeps 6-29% on an H100 (PERF.md §6).
__device__ __forceinline__ bool sweep_hit(const Shear& s, float p0tx, float p0ty, float p0tz, float p1tx,
                                          float p1ty, float p1tz, float p2tx, float p2ty, float p2tz,
                                          float t_max) {
  p0tx = p0tx + s.sx * p0tz;
  p0ty = p0ty + s.sy * p0tz;
  p1tx = p1tx + s.sx * p1tz;
  p1ty = p1ty + s.sy * p1tz;
  p2tx = p2tx + s.sx * p2tz;
  p2ty = p2ty + s.sy * p2tz;
  const float e0 = p1tx * p2ty - p1ty * p2tx;
  const float e1 = p2tx * p0ty - p2ty * p0tx;
  const float e2 = p0tx * p1ty - p0ty * p1tx;
  const bool miss_sign = (e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) && (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f);
  const float det = e0 + e1 + e2;
  const float t_scaled = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * s.inv_dz;
  const bool negd = det < 0.0f;
  const float bound = t_max * det;
  const bool miss_range = (negd && (t_scaled >= 0.0f || t_scaled < bound)) ||
                          (!negd && (t_scaled <= 0.0f || t_scaled > bound));
  return !(miss_sign || det == 0.0f || miss_range);
}

// ---- object-space sphere test (stable-q quadratic, sphere.rs:37-89) -----

// A ray's object-space origin ro from o and world_to_obj's first three
// rows r0-r2, and c = |ro|^2 - r^2: what a camera wave's rays share
// (path_fused.cu's raygen kernel stages them once a block).
__device__ __forceinline__ V3 sphere_origin(const float4& r0, const float4& r1, const float4& r2, V3 o) {
  return {r0.x * o.x + r0.y * o.y + r0.z * o.z + r0.w, r1.x * o.x + r1.y * o.y + r1.z * o.z + r1.w,
          r2.x * o.x + r2.y * o.y + r2.z * o.z + r2.w};
}
__device__ __forceinline__ float sphere_c(V3 ro, float radius) {
  return ro.x * ro.x + ro.y * ro.y + ro.z * ro.z - radius * radius;
}

// The quadratic of a sphere test from the object-space ray (ro, rd) and
// c = sphere_c(ro, radius): the hit distance or a miss through `hit`.
__device__ __forceinline__ float sphere_root(V3 ro, V3 rd, float c, float t_max, bool& hit) {
  float a = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z;
  float b = 2.0f * (rd.x * ro.x + rd.y * ro.y + rd.z * ro.z);
  float discrim = b * b - 4.0f * a * c;
  bool has_root = discrim >= 0.0f;
  float rt = sqrtf(jmax(discrim, 0.0f));
  float q = b < 0.0f ? -0.5f * (b - rt) : -0.5f * (b + rt);
  float t0 = q / a;
  float t1 = c / (q == 0.0f ? F(1e-30) : q);
  float lo_t = jmin(t0, t1);
  float hi_t = jmax(t0, t1);
  bool miss = (lo_t > t_max) || (hi_t <= 0.0f);
  float t = lo_t <= 0.0f ? hi_t : lo_t;
  miss = miss || (t > t_max) || !has_root;
  hit = !miss;
  return t;
}

// m: one sphere's test row staged in shared memory as four float4s:
// world_to_obj's first three rows (m0..m11), then the radius.  Returns the
// hit distance or a miss through `hit`.
__device__ __forceinline__ float sphere_t(const float4* m, V3 o, V3 d, float t_max, bool& hit) {
  const float4 r0 = m[0], r1 = m[1], r2 = m[2];
  const float m0 = r0.x, m1 = r0.y, m2 = r0.z;
  const float m4 = r1.x, m5 = r1.y, m6 = r1.z;
  const float m8 = r2.x, m9 = r2.y, m10 = r2.z;
  V3 ro = sphere_origin(r0, r1, r2, o);
  V3 rd = {m0 * d.x + m1 * d.y + m2 * d.z, m4 * d.x + m5 * d.y + m6 * d.z, m8 * d.x + m9 * d.y + m10 * d.z};
  return sphere_root(ro, rd, sphere_c(ro, m[3].x), t_max, hit);
}


// ---- the per-bounce shading body (shade_fused._shade_body) ---------------
//
// Shared by the dense wave's bounce kernel (path_fused.cu) and the treelet
// path's shade kernel (shade_fused.cu), so one body serves both.

constexpr int MAT_MATTE = 0, MAT_GLASS = 1, MAT_METAL = 2, MAT_GLOSSY = 3;
constexpr int LIGHT_POINT = 0, LIGHT_SPOT = 1, LIGHT_RECT = 2;  // else distant (3)

#define INV_PI ((float)(1.0 / YK_PI))

// ---- BSDF lobes (shade_fused.py:202-352) --------------------------------

__device__ inline float fresnel_dielectric(float ct, float eta_i, float eta_t) {
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

__device__ inline float conductor1(float ci, float ci2, float si2, float eta, float k) {
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

__device__ inline V3 fresnel_conductor3(float ct, V3 eta, V3 k) {
  float ci = jmin(fabsf(ct), 1.0f);
  float ci2 = ci * ci;
  float si2 = 1.0f - ci2;
  return {conductor1(ci, ci2, si2, eta.x, k.x), conductor1(ci, ci2, si2, eta.y, k.y),
          conductor1(ci, ci2, si2, eta.z, k.z)};
}

__device__ inline V3 fresnel_schlick3(float ct, V3 rs) {
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

__device__ inline float ggx_d(V3 wh, float alpha) {
  float t2 = tan2(wh);
  float a2 = alpha * alpha;
  float c4 = cos2(wh) * cos2(wh);
  float e = t2 / a2;
  float val = 1.0f / (F(YK_PI) * a2 * c4 * (1.0f + e) * (1.0f + e));
  return (isfinite(t2) && c4 > 0.0f) ? val : 0.0f;
}

__device__ inline float ggx_lambda(V3 w, float alpha) {
  float abs_tan = sqrtf(jmax(tan2(w), 0.0f));
  float at = alpha * abs_tan;
  float a2t2 = at * at;
  float lam = (-1.0f + sqrtf(1.0f + a2t2)) / 2.0f;
  return isfinite(abs_tan) ? lam : 0.0f;
}

__device__ inline float ggx_g(V3 wo, V3 wi, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha));
}

// Metal: conductor Fresnel; glossy: Schlick.
__device__ inline V3 microfacet_fresnel(int mtype, V3 c0, V3 c1, V3 wo_l, V3 wi_l) {
  V3 wh = normalize_safe(add(wi_l, wo_l));
  wh = wh.z < 0.0f ? neg(wh) : wh;
  float ci = dot(wi_l, wh);
  return mtype == MAT_METAL ? fresnel_conductor3(ci, c0, c1) : fresnel_schlick3(ci, c0);
}

__device__ inline V3 microfacet_f(V3 wo_l, V3 wi_l, float alpha, V3 fr) {
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
__device__ inline V3 matte_f(bool has_sigma, V3 kd, float s0, V3 wo_l, V3 wi_l) {
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

// The shading tables: triangle shading rows [T,32], material rows [M,16],
// light rows [L,32], sphere rows [S,40] (w2o 0-15, o2w 16-31, radius 32,
// swaps 33, material 34), the scene centre (where dead lanes park) and the
// parking distance of distant-light targets.
struct ShadeTables {
  const float* __restrict__ trs;
  const float* __restrict__ mat;
  const float* __restrict__ lt;
  int n_lights;
  const float* __restrict__ sp;
  int n_spheres;
  V3 center;
  float diag;
  bool has_sigma;
};

// A lane's table rows: its triangle shading row (negative ids read row 0)
// and, when it hit a sphere, the sphere; its material row with the sphere
// override.  An id naming no sphere keeps the triangle surface, as the JAX
// per-sphere selects do.
struct Rows {
  const float* trp;
  const float* mrow;
  int si;
  bool is_sph, sph_valid;
};

__device__ inline Rows select_rows(const ShadeTables& tb, float prim, float sph) {
  Rows r;
  r.trp = tb.trs + 32 * (int)jmax(prim, 0.0f);
  float mid = __ldg(r.trp + 26);
  r.is_sph = sph >= 0.0f;
  r.si = (r.is_sph && sph < (float)tb.n_spheres) ? (int)sph : -1;
  r.sph_valid = r.si >= 0 && (float)r.si == sph;
  if (r.sph_valid) mid = __ldg(tb.sp + 40 * r.si + 34);
  r.mrow = tb.mat + 16 * (int)jmax(mid, 0.0f);
  return r;
}

// Material row, kd/s0 possibly replaced by texture lookups by the caller.
struct Material {
  int mtype;
  V3 kd, c1;
  float s0;
  bool remap;
};

__device__ inline Material material_row(const float* __restrict__ mrow) {
  Material m;
  m.mtype = (int)__ldg(mrow + 0);
  m.kd = {__ldg(mrow + 1), __ldg(mrow + 2), __ldg(mrow + 3)};
  m.c1 = {__ldg(mrow + 4), __ldg(mrow + 5), __ldg(mrow + 6)};
  m.s0 = __ldg(mrow + 7);
  m.remap = __ldg(mrow + 8) > 0.5f;
  return m;
}

// One lane's ray, hit and path carry.
struct ShadeIn {
  V3 o, d;
  float t_hit, b0, b1;
  bool alive;  // alive and hit something
  V3 beta;
  float spec;
};

struct ShadeOut {
  V3 o2, d2, beta2;
  bool alive2, spec2;
};

// A lane's sample values of one bounce, k = 0 .. 2L+2 (2 per light, 2 for
// the BSDF sample, 1 for roulette): the uniform sampler's hash of dimension
// dim0 + k, or, where spl is set, a stratified sampler's value computed
// beforehand (yuki_tpu path_fused.py:1023-1051, shade_fused.py:1157-1180):
// spl points at the lane's value k = 0, the next ones `stride` floats apart.
struct Draws {
  uint32_t ph, dim0;
  const float* __restrict__ spl;
  size_t stride;
  __device__ __forceinline__ float operator()(int k) const {
    return spl ? __ldg(spl + (size_t)k * stride) : dim_f32(ph, dim0 + (uint32_t)k);
  }
};

// The shading chain for one lane: surface, material tail, emission, NEE
// setup for every light, bsdf_sample, beta, Russian roulette.  The sink
// receives the emission term (beta * emitted on first and specular hits)
// through sink.emit(ne), then each light's shadow ray and contribution
// through sink.light(li, skip, worth, o_s, d_s, contrib), in light order;
// o_s/d_s are unparked (the sink parks lanes that are not worth a ray).
template <class Sink>
__device__ inline ShadeOut shade_lane(const ShadeTables& tb, const ShadeIn& in, const Rows& r,
                                      const Material& mt, const Draws& urand, int bounce, Sink& sink) {
  const V3 o = in.o, d = in.d;
  const float b0 = in.b0, b1 = in.b1, t_hit = in.t_hit;
  const V3 beta = in.beta;
  const bool alive = in.alive;
  const int n_lights = tb.n_lights;
  const int mtype = mt.mtype;
  const V3 kd = mt.kd, c1 = mt.c1;
  const float s0 = mt.s0;
  const float* trp = r.trp;

  // ---- surface (surface.make_surface; shade_fused.py:395-509) ----------
  V3 wo = neg(d);
  V3 p, n, ns, ss;
  float area_light;
  if (!r.sph_valid) {
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
    const float* m = tb.sp + 40 * r.si;
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
  if (r.is_sph) area_light = -1.0f;
  V3 ts_frame = cross(ns, ss);

  // ---- materials (alpha resolve) ---------------------------------------
  float lx = logf(jmax(s0, F(1e-3)));
  float r2a = F(1.62142) + F(0.819955) * lx + F(0.1734) * lx * lx + F(0.0171201) * lx * lx * lx +
              F(0.000640711) * lx * lx * lx * lx;
  float rough = mt.remap ? r2a : s0;
  if (mtype == MAT_GLOSSY) rough = rough * rough;
  float alpha = jmax(rough, F(1e-3));

  V3 wo_l = {dot(wo, ss), dot(wo, ts_frame), dot(wo, ns)};
  float wo_n = dot(wo, n);

  // ---- emitted (area_light_radiance) -----------------------------------
  V3 le = zero3();
  if (area_light >= 0.0f && area_light < (float)n_lights) {
    int al = (int)area_light;
    if ((float)al == area_light) {
      const float* lr = tb.lt + 32 * al;
      le = {__ldg(lr + 4) + 0.0f, __ldg(lr + 5) + 0.0f, __ldg(lr + 6) + 0.0f};
    }
  }
  bool front_e = dot(n, wo) > 0.0f;
  bool has_al = area_light >= 0.0f;
  V3 emitted = (has_al && front_e) ? le : zero3();
  bool emit_mask = in.spec > 0.0f || bounce == 0;
  sink.emit(emit_mask ? v3(beta.x * emitted.x, beta.y * emitted.y, beta.z * emitted.z) : zero3());

  // ---- NEE setup per light ---------------------------------------------
  V3 off = scale(n, F(1e-3));
  for (int li = 0; li < n_lights; ++li) {
    const float* lr = tb.lt + 32 * li;
#define LT(k) __ldg(lr + (k))
    int ltype = (int)LT(0);
    float u0 = urand(2 * li);
    float u1 = urand(2 * li + 1);
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
      target = add(p, scale(l_dir, tb.diag));
    }

    // bsdf_f(l_dir)
    V3 wi_l = {dot(l_dir, ss), dot(l_dir, ts_frame), dot(l_dir, ns)};
    bool reflect = (dot(l_dir, n) * wo_n) > 0.0f;
    V3 f_nee = zero3();
    if (mtype == MAT_MATTE) {
      f_nee = matte_f(tb.has_sigma, kd, s0, wo_l, wi_l);
    } else if (mtype == MAT_METAL || mtype == MAT_GLOSSY) {
      f_nee = microfacet_f(wo_l, wi_l, alpha, microfacet_fresnel(mtype, kd, c1, wo_l, wi_l));
    }
    if (!reflect) f_nee = zero3();

    float cos_ = jclip(dot(ns, l_dir), 0.0f, 1.0f);
    bool worth = alive && !is_black(li_v) && !is_black(f_nee) && cos_ > 0.0f;
    bool side = dot(sub(target, p), n) > 0.0f;
    V3 o_s = side ? add(p, off) : sub(p, off);
    V3 d_s = sub(target, o_s);
    float k_ = cos_ / jmax(pdf, F(1e-30));
    V3 contrib = {f_nee.x * li_v.x * k_, f_nee.y * li_v.y * k_, f_nee.z * li_v.z * k_};
    // A rect light's shadow ray skips the light's own triangles; -2 skips
    // nothing (shade_fused.py:1278-1284).
    int skip = ltype == LIGHT_RECT ? li : -2;
    sink.light(li, skip, worth, o_s, d_s, contrib);
#undef LT
  }

  // ---- bsdf_sample (shade_fused.py:666-778) ----------------------------
  float u0 = urand(2 * n_lights);
  float u1 = urand(2 * n_lights + 1);
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
    f_s = matte_f(tb.has_sigma, kd, s0, wo_l, wi_l);
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

  ShadeOut out;
  out.spec2 = mtype == MAT_GLASS;
  V3 wi_w = {ss.x * wi_l.x + ts_frame.x * wi_l.y + ns.x * wi_l.z,
             ss.y * wi_l.x + ts_frame.y * wi_l.y + ns.y * wi_l.z,
             ss.z * wi_l.x + ts_frame.z * wi_l.y + ns.z * wi_l.z};

  bool terminated = is_black(f_s) || pdf == 0.0f;
  bool alive2 = alive && !terminated;
  float bscale = fabsf(dot(wi_w, ns)) / jmax(pdf, F(1e-30));
  V3 beta2 = {beta.x * f_s.x * bscale, beta.y * f_s.y * bscale, beta.z * f_s.z * bscale};
  bool finite = isfinite(beta2.x) && isfinite(beta2.y) && isfinite(beta2.z);
  alive2 = alive2 && finite;
  if (!finite) beta2 = zero3();

  // spawn_ray + park
  bool side2 = dot(wi_w, n) > 0.0f;
  V3 o2 = side2 ? add(p, off) : sub(p, off);
  if (!alive2) o2 = tb.center;
  V3 d2v = alive2 ? wi_w : v3(0.0f, 0.0f, 1.0f);

  // Russian roulette after bounce 3.
  if (bounce > 3) {
    float q = jmax(F(0.05), 1.0f - beta2.y);
    float r_rr = urand(2 * n_lights + 2);
    alive2 = alive2 && !(r_rr < q);
    float inv_keep = 1.0f / jmax(1.0f - q, F(1e-30));
    beta2 = scale(beta2, inv_keep);
  }
  out.o2 = o2;
  out.d2 = d2v;
  out.beta2 = beta2;
  out.alive2 = alive2;
  return out;
}

}  // namespace yk
