// Device maths shared by the dense path-tracing wave kernels
// (path_fused.cu): the sampler hash, SoA vector helpers, the watertight
// triangle test and the object-space sphere test.
//
// Every formula keeps yuki_tpu's op order (ops/trace.py, ops/path_fused.py,
// ops/shade_fused.py) and the file is compiled with -fmad=false, so each
// product and sum rounds on its own as in the JAX and PyTorch versions.
// Constants are written F(double literal): a double rounded once to float,
// as a Python float meeting a float32 array is.
#pragma once

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

// One triangle (c: p0, p1, p2 as 9 floats) against one ray.  Returns hit;
// t (F32_MAX on a miss), b0, b1 through the references.
__device__ __forceinline__ bool watertight(const Shear& s, V3 o, float t_cur, const float* __restrict__ c,
                                          float& t, float& b0, float& b1) {
  float a0x = __ldg(c + 0) - o.x, a0y = __ldg(c + 1) - o.y, a0z = __ldg(c + 2) - o.z;
  float a1x = __ldg(c + 3) - o.x, a1y = __ldg(c + 4) - o.y, a1z = __ldg(c + 5) - o.z;
  float a2x = __ldg(c + 6) - o.x, a2y = __ldg(c + 7) - o.y, a2z = __ldg(c + 8) - o.z;
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

// ---- object-space sphere test (stable-q quadratic, sphere.rs:37-89) -----

// m: one sphere row (world_to_obj 0..15, obj_to_world 16..31, radius 32).
// Returns the hit distance or a miss through `hit`.
__device__ __forceinline__ float sphere_t(const float* __restrict__ m, V3 o, V3 d, float t_max, bool& hit) {
  float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2), m3 = __ldg(m + 3);
  float m4 = __ldg(m + 4), m5 = __ldg(m + 5), m6 = __ldg(m + 6), m7 = __ldg(m + 7);
  float m8 = __ldg(m + 8), m9 = __ldg(m + 9), m10 = __ldg(m + 10), m11 = __ldg(m + 11);
  V3 ro = {m0 * o.x + m1 * o.y + m2 * o.z + m3, m4 * o.x + m5 * o.y + m6 * o.z + m7,
           m8 * o.x + m9 * o.y + m10 * o.z + m11};
  V3 rd = {m0 * d.x + m1 * d.y + m2 * d.z, m4 * d.x + m5 * d.y + m6 * d.z, m8 * d.x + m9 * d.y + m10 * d.z};
  float radius = __ldg(m + 32);
  float a = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z;
  float b = 2.0f * (rd.x * ro.x + rd.y * ro.y + rd.z * ro.z);
  float c = ro.x * ro.x + ro.y * ro.y + ro.z * ro.z - radius * radius;
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

}  // namespace yk
