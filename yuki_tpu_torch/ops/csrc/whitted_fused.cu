// Whitted's tree step for Hopper (sm_90a): two kernels around the scene's
// triangle queries (added, no TPU twin: yuki_tpu runs Whitted's step as XLA
// ops, yuki_tpu/integrators/__init__.py:395-568).
//
//   yk_whitted_shade    the spheres against the triangles' closest hit,
//                       the lane's ray count, the surface, its material
//                       (textures included), each light's shadow ray and
//                       raw contribution f Li cos / pdf, the area-light
//                       emission, the specular children (reflection and
//                       transmission)
//   yk_whitted_resolve  the spheres' occlusion ORed into the triangles'
//                       verdicts, the miss background, the lit
//                       contributions in light order and the radiance, the
//                       transmission child pushed, the stack popped where
//                       no reflection child goes on, the next ray
//
// Design.  One thread a lane, 128-thread blocks, lanes in wave order, as
// the shade kernels (shade_fused.cu): the scene's rows are read with __ldg
// and stay in L1/L2 (Cornell's tables are a few KB).  The step's state is
// torch tensors the wrapper owns (ops/whitted_fused.py): the current ray
// and its carry, the radiance, the ray count, the stack [size, N] in
// whitted_li's layout; resolve rewrites them in place, each thread its own
// lane.  The shadow rays go out light-major, [L*N, 3], the layout the
// occlusion query takes.
//
// Numerics.  The formulas follow the shading chain the twins call
// (surface.make_surface, bsdf.gather_materials / bsdf_f /
// bsdf_sample_specular, lights.sample_li / area_light_radiance,
// integrators._nee_setup / _nee_resolve / _push / _pop, intersect.
// ray_spheres) operation for operation: vecmath's normalize_safe divides
// each component by max(|v|, 1e-20), products by zero stay products, and
// the file is built with -fmad=false and no fast-math.  Of path_fused.cuh's
// lobe helpers, those that normalize nothing (matte_f, the Fresnel terms,
// the GGX terms) are the chain's formulas and are shared; its microfacet_f
// and microfacet_fresnel normalize the half vector by a reciprocal
// multiply, as yuki_tpu's fused shading does, and are written out here
// with the chain's divide (mf_f, mf_fresnel).  The
// transcendentals are logf (roughness), acosf and sinf (a sphere's normal)
// and atan2f (a sphere's uv, computed only in scenes with a texture, the
// one reader of uv).
//
// What bounds them: bytes, each lane counted as if it read and wrote all it
// may (chip_smoke.whitted_bytes): shade reads 66 + 8 L B and writes
// 89 + 40 L B, resolve reads 154 + 41 L B and writes 105 B, L lights.
// Measured against those bounds in PERF.md §6.

#include <cuda_runtime.h>

#include <cstdint>

#include "path_fused.cuh"

using namespace yk;

// whitted_fused._Args, field for field (outside the unnamed namespace: the
// C entry points take it, and a parameter type with internal linkage would
// give them internal linkage too).
struct WhittedArgs {
  // tables: shading rows [T,32], material rows [M,16], light rows [L,32],
  // sphere rows [S,40] (shade_fused layouts), the texel pool [P,3] with
  // each texture's offset, width, height, and consts [8]: the scene
  // centre, the distant lights' parking distance, the background.
  const float *trs, *mat, *lt, *sp, *texels;
  const int *tex_off, *tex_w, *tex_h;
  const float* consts;
  // state
  float *o, *d, *t_max, *scale;
  int* depth;
  uint8_t *spec, *active;
  float* radiance;
  int *ray_count, *sptr;
  uint8_t* pending;
  float *st_o, *st_d, *st_scale;
  int* st_depth;
  uint8_t* st_spec;
  // the triangles' closest hit
  const float* t;
  const int* prim;
  const float *b0, *b1;
  // the step's draws: stratified planes [2L, N], or null and ph
  const float* draws;
  const int* ph;
  // shade's outputs, resolve's inputs
  float *no, *nd, *nt, *nc, *emit, *refl, *trans;
  uint8_t* lane;
  const uint8_t* occ;
  int n, n_lights, n_spheres, flags, depth_cap, size, dim0;
};

namespace {

constexpr int THREADS = 128;

// Lane flags (whitted_fused.py LIVE, MISSED, REFL, TRANS) and table flags.
constexpr uint8_t LANE_LIVE = 1, LANE_MISSED = 2, LANE_REFL = 4, LANE_TRANS = 8;
constexpr int FLAG_SIGMA = 1, FLAG_TEX = 2, FLAG_SIGMA_TEX = 4;

// vecmath.normalize_safe: v / max(|v|, 1e-20), a divide a component.
__device__ __forceinline__ V3 nsafe(V3 a) {
  float l = jmax(sqrtf(dot(a, a)), F(1e-20));
  return {a.x / l, a.y / l, a.z / l};
}

// vecmath.coordinate_system's first vector.
__device__ __forceinline__ V3 coord_v1(V3 v) {
  bool use_x = fabsf(v.x) > fabsf(v.y);
  float inv_a = 1.0f / sqrtf(use_x ? v.x * v.x + v.z * v.z : v.y * v.y + v.z * v.z);
  return use_x ? V3{-v.z * inv_a, 0.0f * inv_a, v.x * inv_a} : V3{0.0f * inv_a, v.z * inv_a, -v.y * inv_a};
}

__device__ __forceinline__ V3 mul3(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 ldg3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

// Rows 0-2 of a [4,4] matrix m (row-major) applied to a point with its
// translation, or to a vector: ((m0 x + m1 y) + m2 z) (+ m3).
__device__ __forceinline__ float row_p(const float* m, int i, float x, float y, float z) {
  return __ldg(m + 4 * i) * x + __ldg(m + 4 * i + 1) * y + __ldg(m + 4 * i + 2) * z + __ldg(m + 4 * i + 3);
}
__device__ __forceinline__ float row_v(const float* m, int i, float x, float y, float z) {
  return __ldg(m + 4 * i) * x + __ldg(m + 4 * i + 1) * y + __ldg(m + 4 * i + 2) * z;
}

// intersect.ray_spheres over every sphere: (hit, t, sphere index), a later
// sphere winning only when strictly closer.
__device__ __forceinline__ int spheres_closest(const float* __restrict__ sp, int n_spheres, V3 o, V3 d,
                                               float t_max, float& best_t) {
  best_t = YK_F32_MAX;
  int best_i = -1;
  for (int s = 0; s < n_spheres; ++s) {
    const float* m = sp + 40 * s;
    V3 ro = {row_p(m, 0, o.x, o.y, o.z), row_p(m, 1, o.x, o.y, o.z), row_p(m, 2, o.x, o.y, o.z)};
    V3 rd = {row_v(m, 0, d.x, d.y, d.z), row_v(m, 1, d.x, d.y, d.z), row_v(m, 2, d.x, d.y, d.z)};
    bool hit;
    float ts = sphere_root(ro, rd, sphere_c(ro, __ldg(m + 32)), t_max, hit);
    if (hit && ts < best_t) {
      best_t = ts;
      best_i = s;
    }
  }
  return best_i;
}

// textures.eval_texture: point-sampled, repeat wrap, y-flip, the -0.5
// texel-centre offset, truncation toward zero, clamped to the image.
__device__ __forceinline__ V3 eval_texture(const WhittedArgs& a, int tid, float u, float v) {
  int w = (int)(float)__ldg(a.tex_w + tid);
  int h = (int)(float)__ldg(a.tex_h + tid);
  int raw = __ldg(a.tex_off + tid);
  int off = (int)(float)(raw >> 12) * 4096 + (int)(float)(raw & 0xFFF);
  float s = u - floorf(u);
  float t = v - floorf(v);
  t = 1.0f - t;
  float x = s * (float)w - 0.5f;
  float y = t * (float)h - 0.5f;
  int xi = min(max((int)x, 0), w - 1);
  int yi = min(max((int)y, 0), h - 1);
  return ldg3(a.texels + 3 * (size_t)(off + yi * w + xi));
}

// A lane's surface (surface.make_surface) and material (gather_materials).
struct Surf {
  V3 p, n, ns, ss, ts;
  int area_light;
  int mtype;
  V3 c0, c1;
  float s0, alpha;
};

__device__ inline Surf make_surf(const WhittedArgs& a, V3 o, V3 d, float t_hit, int prim, int sphere, float b0,
                                 float b1) {
  Surf r;
  const float* trp = a.trs + 32 * (size_t)max(prim, 0);
  float u = 0.0f, v = 0.0f;
  int mid;
  if (sphere < 0) {
    V3 p0 = ldg3(trp), p1 = ldg3(trp + 3), p2 = ldg3(trp + 6);
    V3 n0 = ldg3(trp + 9), n1 = ldg3(trp + 12), n2 = ldg3(trp + 15);
    float uv0s = __ldg(trp + 18), uv0t = __ldg(trp + 19);
    float uv1s = __ldg(trp + 20), uv1t = __ldg(trp + 21);
    float uv2s = __ldg(trp + 22), uv2t = __ldg(trp + 23);
    bool has = __ldg(trp + 24) > 0.5f;
    bool swaps = __ldg(trp + 25) > 0.5f;
    mid = (int)__ldg(trp + 26);
    r.area_light = (int)__ldg(trp + 27);
    float b2 = 1.0f - b0 - b1;
    r.p = add(add(scale(p0, b0), scale(p1, b1)), scale(p2, b2));
    u = uv0s * b0 + uv1s * b1 + uv2s * b2;
    v = uv0t * b0 + uv1t * b1 + uv2t * b2;
    V3 dp02 = sub(p0, p2), dp12 = sub(p1, p2);
    float duv02s = uv0s - uv2s, duv02t = uv0t - uv2t;
    float duv12s = uv1s - uv2s, duv12t = uv1t - uv2t;
    float uv_det = duv02s * duv12t - duv02t * duv12s;
    bool degen = uv_det == 0.0f;
    float inv_uv_det = 1.0f / (degen ? 1.0f : uv_det);
    V3 dpdu = scale(sub(scale(dp02, duv12t), scale(dp12, duv02t)), inv_uv_det);
    if (degen) dpdu = coord_v1(nsafe(cross(sub(p2, p0), sub(p1, p0))));
    V3 n_wind = nsafe(cross(dp02, dp12));
    if (swaps) n_wind = neg(n_wind);
    V3 ns_raw = add(add(scale(n0, b0), scale(n1, b1)), scale(n2, b2));
    V3 ns_auth = dot(ns_raw, ns_raw) > 0.0f ? nsafe(ns_raw) : n_wind;
    V3 ss0 = nsafe(dpdu);
    V3 ts_raw = cross(ss0, ns_auth);
    V3 ss_auth = dot(ts_raw, ts_raw) > 0.0f ? cross(nsafe(ts_raw), ns_auth) : coord_v1(ns_auth);
    r.ns = has ? ns_auth : n_wind;
    r.ss = has ? ss_auth : ss0;
    r.n = has ? face_forward(n_wind, ns_auth) : n_wind;
  } else {  // surface._sphere_lanes
    const float* m = a.sp + 40 * sphere;
    V3 ro = {row_p(m, 0, o.x, o.y, o.z), row_p(m, 1, o.x, o.y, o.z), row_p(m, 2, o.x, o.y, o.z)};
    V3 rd = {row_v(m, 0, d.x, d.y, d.z), row_v(m, 1, d.x, d.y, d.z), row_v(m, 2, d.x, d.y, d.z)};
    float radius = __ldg(m + 32);
    V3 p_obj = add(ro, scale(rd, t_hit));
    p_obj = scale(p_obj, radius / jmax(sqrtf(dot(p_obj, p_obj)), F(1e-20)));
    bool fix = p_obj.x == 0.0f && p_obj.y == 0.0f;
    float px = fix ? F(1e-5) * radius : p_obj.x;
    float py = p_obj.y, pz = p_obj.z;
    float theta = acosf(jclip(pz / radius, -1.0f, 1.0f));
    if (a.flags & (FLAG_TEX | FLAG_SIGMA_TEX)) {
      float phi = atan2f(py, px);
      phi = phi < 0.0f ? phi + F(2.0 * YK_PI) : phi;
      u = phi / F(2.0 * YK_PI);
      v = (theta - F(YK_PI)) / F(-YK_PI);
    }
    const float zero = 0.0f;
    V3 dpdu_o = {F(-2.0 * YK_PI) * py, F(2.0 * YK_PI) * px, zero};
    float inv_zr = 1.0f / jmax(sqrtf(px * px + py * py), F(1e-20));
    V3 dpdv_o = {pz * px * inv_zr * F(-YK_PI), pz * py * inv_zr * F(-YK_PI), -radius * sinf(theta) * F(-YK_PI)};
    V3 n_obj = nsafe(cross(dpdu_o, dpdv_o));
    if (__ldg(m + 33) > 0.5f) n_obj = neg(n_obj);
    const float* w = m + 16;  // obj_to_world
    r.p = {row_p(w, 0, px, py, pz), row_p(w, 1, px, py, pz), row_p(w, 2, px, py, pz)};
    // Normals by world_to_obj transposed: column i of m.
    V3 n_w = {__ldg(m + 0) * n_obj.x + __ldg(m + 4) * n_obj.y + __ldg(m + 8) * n_obj.z,
              __ldg(m + 1) * n_obj.x + __ldg(m + 5) * n_obj.y + __ldg(m + 9) * n_obj.z,
              __ldg(m + 2) * n_obj.x + __ldg(m + 6) * n_obj.y + __ldg(m + 10) * n_obj.z};
    r.n = nsafe(n_w);
    r.ns = r.n;
    r.ss = nsafe(V3{row_v(w, 0, dpdu_o.x, dpdu_o.y, dpdu_o.z), row_v(w, 1, dpdu_o.x, dpdu_o.y, dpdu_o.z),
                    row_v(w, 2, dpdu_o.x, dpdu_o.y, dpdu_o.z)});
    mid = (int)__ldg(m + 34);
    r.area_light = -1;
  }
  r.ts = cross(r.ns, r.ss);

  // bsdf.gather_materials
  const float* mrow = a.mat + 16 * max(mid, 0);
  r.mtype = (int)__ldg(mrow);
  r.c0 = ldg3(mrow + 1);
  r.c1 = ldg3(mrow + 4);
  r.s0 = __ldg(mrow + 7);
  bool remap = __ldg(mrow + 8) > 0.5f;
  if (a.flags & FLAG_TEX) {
    int tex0 = (int)__ldg(mrow + 9);
    if (tex0 >= 0) r.c0 = eval_texture(a, tex0, u, v);
  }
  if (a.flags & FLAG_SIGMA_TEX) {
    int tex1 = (int)__ldg(mrow + 10);
    if (tex1 >= 0) r.s0 = eval_texture(a, tex1, u, v).x;
  }
  float lx = logf(jmax(r.s0, F(1e-3)));
  float r2a = F(1.62142) + F(0.819955) * lx + F(0.1734) * lx * lx + F(0.0171201) * lx * lx * lx +
              F(0.000640711) * lx * lx * lx * lx;
  float rough = remap ? r2a : r.s0;
  if (r.mtype == MAT_GLOSSY) rough = rough * rough;
  r.alpha = jmax(rough, F(1e-3));
  return r;
}

// bsdf._microfacet_fresnel: conductor for metal, Schlick for glossy, at the
// half vector face-forwarded to +z.
__device__ inline V3 mf_fresnel(int mtype, V3 c0, V3 c1, V3 wo_l, V3 wi_l) {
  V3 wh = nsafe(add(wi_l, wo_l));
  wh = wh.z < 0.0f ? neg(wh) : wh;
  float ci = dot(wi_l, wh);
  return mtype == MAT_METAL ? fresnel_conductor3(ci, c0, c1) : fresnel_schlick3(ci, c0);
}

// bsdf._microfacet_f: Torrance-Sparrow times the Fresnel value fr.
__device__ inline V3 mf_f(V3 wo_l, V3 wi_l, float alpha, V3 fr) {
  float cto = fabsf(wo_l.z), cti = fabsf(wi_l.z);
  V3 wh = add(wi_l, wo_l);
  bool wh_ok = (wh.x != 0.0f || wh.y != 0.0f || wh.z != 0.0f) && cto > 0.0f && cti > 0.0f;
  wh = nsafe(wh);
  float dg = ggx_d(wh, alpha) * ggx_g(wo_l, wi_l, alpha);
  return wh_ok ? scale(fr, dg / jmax(4.0f * cti * cto, F(1e-30))) : zero3();
}

__device__ __forceinline__ V3 to_local(const Surf& s, V3 v) { return {dot(v, s.ss), dot(v, s.ts), dot(v, s.ns)}; }
__device__ __forceinline__ V3 to_world(const Surf& s, V3 v) {
  return {s.ss.x * v.x + s.ts.x * v.y + s.ns.x * v.z, s.ss.y * v.x + s.ts.y * v.y + s.ns.y * v.z,
          s.ss.z * v.x + s.ts.z * v.y + s.ns.z * v.z};
}

// surface.spawn_ray / spawn_ray_to's origin: 1e-3 along +-n.
__device__ __forceinline__ V3 offset_origin(const Surf& s, V3 toward) {
  V3 off = scale(s.n, F(1e-3));
  return dot(toward, s.n) > 0.0f ? add(s.p, off) : sub(s.p, off);
}

// A specular child (bsdf_sample_specular and whitted_li's child): o, d and
// scale as a row of nine floats; returns valid.
__device__ inline bool specular_child(const Surf& s, V3 wo_l, bool transmission, V3 cur_scale, float* row) {
  bool glass = s.mtype == MAT_GLASS;
  V3 wi_l, f;
  bool valid;
  if (!transmission) {
    wi_l = {-wo_l.x, -wo_l.y, wo_l.z};
    float k = fresnel_dielectric(wi_l.z, 1.0f, s.s0) / jmax(fabsf(wi_l.z), F(1e-30));
    f = scale(s.c0, k);
    valid = glass;
  } else {  // bsdf._refract_l
    bool entering = wo_l.z > 0.0f;
    float eta_i = entering ? 1.0f : s.s0;
    float eta_t = entering ? s.s0 : 1.0f;
    float eta = eta_i / eta_t;
    float n_ff = entering ? 1.0f : -1.0f;
    float cti = n_ff * wo_l.z;
    float s2tt = eta * eta * jmax(1.0f - cti * cti, 0.0f);
    bool tir = s2tt >= 1.0f;
    float ctt = sqrtf(jmax(1.0f - s2tt, 0.0f));
    float k = eta * cti - ctt;
    const float zero = 0.0f;
    wi_l = {-wo_l.x * eta + zero * k, -wo_l.y * eta + zero * k, -wo_l.z * eta + n_ff * k};
    float fr = fresnel_dielectric(wi_l.z, 1.0f, s.s0);
    f = scale(s.c1, (1.0f - fr) / jmax(fabsf(wi_l.z), F(1e-30)));
    valid = glass && !tir;
  }
  if (!valid) f = zero3();
  V3 wi = to_world(s, wi_l);
  float c = fabsf(dot(wi, s.ns));
  V3 sc = scale(f, c);
  sc = {isfinite(sc.x) ? sc.x : 0.0f, isfinite(sc.y) ? sc.y : 0.0f, isfinite(sc.z) ? sc.z : 0.0f};
  sc = mul3(sc, cur_scale);
  store3(row, offset_origin(s, wi));
  store3(row + 3, wi);
  store3(row + 6, sc);
  return valid;
}

__global__ void __launch_bounds__(THREADS) whitted_shade_kernel(const WhittedArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t N = (size_t)a.n;
  const V3 o = load3(a.o + 3 * i), d = load3(a.d + 3 * i);
  const bool active = a.active[i] != 0;
  const V3 cur_scale = load3(a.scale + 3 * i);
  const int cur_depth = a.depth[i];
  a.ray_count[i] = a.ray_count[i] + (active ? 1 : 0);

  // traverse.intersect's merge of the spheres.
  float t_tri = a.t[i];
  int prim = a.prim[i];
  float t_sph;
  int sph = spheres_closest(a.sp, a.n_spheres, o, d, a.t_max[i], t_sph);
  bool sphere_wins = sph >= 0 && t_sph < t_tri;
  bool hit = prim >= 0 || sphere_wins;
  float t_hit = sphere_wins ? t_sph : t_tri;
  if (sphere_wins) prim = -1;
  int sphere = sphere_wins ? sph : -1;
  bool live = active && hit;
  bool missed = active && !hit;

  const Surf s = make_surf(a, o, d, t_hit, prim, sphere, a.b0[i], a.b1[i]);
  const V3 wo = neg(d);
  const V3 wo_l = to_local(s, wo);
  const float wo_n = dot(wo, s.n);

  // integrators._nee_setup, light-major.
  const V3 center = ldg3(a.consts);
  const float diag = __ldg(a.consts + 3);
  for (int li = 0; li < a.n_lights; ++li) {
    const float* lr = a.lt + 32 * li;
    const float* lm = lr + 7;  // the light's matrix
    int ltype = (int)__ldg(lr);
    float u0, u1;
    if (a.draws) {
      u0 = a.draws[(2 * li) * N + i];
      u1 = a.draws[(2 * li + 1) * N + i];
    } else {
      uint32_t ph = (uint32_t)a.ph[i];
      u0 = dim_f32(ph, (uint32_t)(a.dim0 + 2 * li));
      u1 = dim_f32(ph, (uint32_t)(a.dim0 + 2 * li + 1));
    }
    const V3 l_i = ldg3(lr + 4);
    V3 l, li_v, target;
    float pdf = 1.0f;
    if (ltype == LIGHT_POINT || ltype == LIGHT_SPOT) {
      V3 lp = ldg3(lr + 1);
      V3 to_l = sub(lp, s.p);
      float d2 = jmax(dot(to_l, to_l), F(1e-30));
      float dist = sqrtf(d2);
      l = {to_l.x / dist, to_l.y / dist, to_l.z / dist};
      target = lp;
      if (ltype == LIGHT_POINT) {
        li_v = {l_i.x / d2, l_i.y / d2, l_i.z / d2};
      } else {
        V3 nl = neg(l);
        V3 v = {row_v(lm, 0, nl.x, nl.y, nl.z), row_v(lm, 1, nl.x, nl.y, nl.z), row_v(lm, 2, nl.x, nl.y, nl.z)};
        float ct = v.z / jmax(sqrtf(dot(v, v)), F(1e-20));
        float cos_w = __ldg(lr + 24), cos_f = __ldg(lr + 25);
        float delta = (ct - cos_w) / jmax(cos_f - cos_w, F(1e-30));
        float fall = ct < cos_w ? 0.0f : (ct > cos_f ? 1.0f : (delta * delta) * (delta * delta));
        li_v = scale(l_i, fall / d2);
      }
    } else if (ltype == LIGHT_RECT) {
      const float zero = 0.0f;
      float w = row_p(lm, 3, u0, zero, u1);
      V3 lp = {row_p(lm, 0, u0, zero, u1) / w, row_p(lm, 1, u0, zero, u1) / w, row_p(lm, 2, u0, zero, u1) / w};
      V3 ln = nsafe(V3{row_v(lm, 0, zero, -1.0f, zero), row_v(lm, 1, zero, -1.0f, zero),
                       row_v(lm, 2, zero, -1.0f, zero)});
      V3 wi = nsafe(sub(lp, s.p));
      float ndw = dot(ln, neg(wi));
      li_v = ndw > 0.0f ? l_i : zero3();
      V3 dp = sub(lp, s.p);
      float d2 = dot(dp, dp);
      pdf = d2 / jmax(fabsf(ndw) * __ldg(lr + 23), F(1e-30));
      l = wi;
      target = lp;
    } else {  // distant
      l = ldg3(lr + 1);
      li_v = l_i;
      target = add(s.p, scale(l, diag));
    }

    // bsdf.bsdf_f
    V3 wi_l = to_local(s, l);
    V3 f = zero3();
    if (s.mtype == MAT_MATTE) {
      f = matte_f((a.flags & FLAG_SIGMA) != 0, s.c0, s.s0, wo_l, wi_l);
    } else if (s.mtype == MAT_METAL || s.mtype == MAT_GLOSSY) {
      f = mf_f(wo_l, wi_l, s.alpha, mf_fresnel(s.mtype, s.c0, s.c1, wo_l, wi_l));
    }
    if (!((dot(l, s.n) * wo_n) > 0.0f)) f = zero3();

    float cos_ = jclip(dot(s.ns, l), 0.0f, 1.0f);
    bool worth = live && !is_black(li_v) && !is_black(f) && cos_ > 0.0f;
    V3 o_s = offset_origin(s, sub(target, s.p));
    V3 d_s = sub(target, o_s);
    float k = cos_ / jmax(pdf, F(1e-30));
    V3 c = {f.x * li_v.x * k, f.y * li_v.y * k, f.z * li_v.z * k};
    const size_t b = (size_t)li * N + i;
    store3(a.no + 3 * b, worth ? o_s : center);
    store3(a.nd + 3 * b, worth ? d_s : v3(0.0f, 0.0f, 1.0f));
    a.nt[b] = worth ? F(0.9999) : 0.0f;
    store3(a.nc + 3 * b, worth ? c : zero3());
  }

  // lights.area_light_radiance where cur_spec | depth == 0.
  V3 le = ldg3(a.lt + 32 * max(s.area_light, 0) + 4);
  bool emits = s.area_light >= 0 && dot(s.n, wo) > 0.0f;
  bool emit_mask = a.spec[i] != 0 || cur_depth == 0;
  store3(a.emit + 3 * i, (emit_mask && emits) ? le : zero3());

  bool can_recurse = live && (cur_depth + 1 < a.depth_cap);
  bool r_valid = specular_child(s, wo_l, false, cur_scale, a.refl + 9 * i) && can_recurse;
  bool t_valid = specular_child(s, wo_l, true, cur_scale, a.trans + 9 * i) && can_recurse;
  a.lane[i] = (live ? LANE_LIVE : 0) | (missed ? LANE_MISSED : 0) | (r_valid ? LANE_REFL : 0) |
              (t_valid ? LANE_TRANS : 0);
}

__global__ void __launch_bounds__(THREADS) whitted_resolve_kernel(const WhittedArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t N = (size_t)a.n;
  const uint8_t lane = a.lane[i];
  const bool live = lane & LANE_LIVE, missed = lane & LANE_MISSED;
  const bool r_valid = lane & LANE_REFL, t_valid = lane & LANE_TRANS;

  // _nee_resolve over any_intersect's verdicts, then the emission.
  V3 direct = zero3();
  for (int li = 0; li < a.n_lights; ++li) {
    const size_t b = (size_t)li * N + i;
    float t_s = a.nt[b];
    float best_t;
    bool occ = a.occ[b] != 0 || spheres_closest(a.sp, a.n_spheres, load3(a.no + 3 * b), load3(a.nd + 3 * b), t_s,
                                                best_t) >= 0;
    V3 lit = (t_s > 0.0f && !occ) ? load3(a.nc + 3 * b) : zero3();
    direct = li == 0 ? lit : add(direct, lit);
  }
  direct = add(direct, load3(a.emit + 3 * i));
  const V3 cur_scale = load3(a.scale + 3 * i);
  const V3 bg = ldg3(a.consts + 4);
  V3 rad = load3(a.radiance + 3 * i);
  rad = add(rad, missed ? mul3(cur_scale, bg) : zero3());
  rad = add(rad, live ? mul3(cur_scale, direct) : zero3());
  store3(a.radiance + 3 * i, rad);

  // _push of the transmission child, then _pop where no reflection child.
  const int size = a.size;
  const int child_depth = a.depth[i] + 1;
  int sp = a.sptr[i];
  if (t_valid && sp < size) {
    const float* c = a.trans + 9 * i;
    const size_t e = (size_t)sp * N + i;
    store3(a.st_o + 3 * e, load3(c));
    store3(a.st_d + 3 * e, load3(c + 3));
    store3(a.st_scale + 3 * e, load3(c + 6));
    a.st_depth[e] = child_depth;
    a.st_spec[e] = 1;
  }
  sp += t_valid ? 1 : 0;
  const bool popped = !r_valid && sp > 0;
  const size_t e = (size_t)max(sp - 1, 0) * N + i;
  sp -= popped ? 1 : 0;
  const bool act = r_valid || popped;
  const float* r = a.refl + 9 * i;
  V3 o_n = r_valid ? load3(r) : load3(a.st_o + 3 * e);
  V3 d_n = r_valid ? load3(r + 3) : load3(a.st_d + 3 * e);
  store3(a.o + 3 * i, act ? o_n : ldg3(a.consts));
  store3(a.d + 3 * i, act ? d_n : v3(0.0f, 0.0f, 1.0f));
  store3(a.scale + 3 * i, r_valid ? load3(r + 6) : load3(a.st_scale + 3 * e));
  a.depth[i] = r_valid ? child_depth : a.st_depth[e];
  a.spec[i] = r_valid ? 1 : a.st_spec[e];
  a.active[i] = act ? 1 : 0;
  a.t_max[i] = act ? YK_F32_MAX : 0.0f;
  a.sptr[i] = sp;
  a.pending[i] = (act || sp > 0) ? 1 : 0;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_whitted_shade(int device, const WhittedArgs* args, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  whitted_shade_kernel<<<blocks_for(args->n), THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int yk_whitted_resolve(int device, const WhittedArgs* args, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  whitted_resolve_kernel<<<blocks_for(args->n), THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
