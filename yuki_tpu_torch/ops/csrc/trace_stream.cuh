// Device maths shared by the slot-stream kernels (trace_stream.cu), the
// two-level cull (trace_cull.cu), the row-union walks (trace_rows.cu) and
// the bundle walks (trace_walker.cu): the finite slab reciprocal and axis
// fold of yuki_tpu/ops/trace_stream.py (:94-114) with one-instruction NaN
// folds, the chunk-box slab test on structure-of-arrays tables, a warp's
// broadcast of a ray, and the framed chunk copies: a chunk staged as three
// copies permuted for the three shear frames, the divide-free watertight
// test of yuki_tpu/ops/trace.py (:57-98) on them, and the closest and
// occlusion walks of one chunk on them.
// Compiled with -fmad=false, like path_fused.cuh, so every product and sum
// rounds on its own as in the JAX and PyTorch versions.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "path_fused.cuh"

namespace yk {

// _safe_inv: sign(d) / max(|d|, 1e-30), finite, so (lo - o) * inv is never
// the 0 * inf NaN of a plain 1 / d.
__device__ __forceinline__ float safe_inv(float dc) {
  float s = dc >= 0.0f ? 1.0f : -1.0f;
  return s / jmax(fabsf(dc), F(1e-30));
}

// A ray as the culls see it: origin, finite reciprocal direction, t_max.
struct SlabRay {
  float ox, oy, oz, ix, iy, iz, tm;
};

__device__ __forceinline__ SlabRay slab_ray(const float* __restrict__ o, const float* __restrict__ d,
                                            const float* __restrict__ tmax, int i) {
  return {o[3 * i], o[3 * i + 1], o[3 * i + 2], safe_inv(d[3 * i]), safe_inv(d[3 * i + 1]),
          safe_inv(d[3 * i + 2]), tmax[i]};
}

constexpr unsigned FULL = 0xffffffffu;

// Copy the first six columns of an [n, 8] box table into shared memory as
// [6][stride], zero past n, by all threads of the block (the caller
// synchronises).
__device__ __forceinline__ void stage_soa(float* dst, const float* __restrict__ src, int n, int stride) {
  for (int e = threadIdx.x; e < 6 * stride; e += blockDim.x) {
    const int a = e / stride, j = e - a * stride;
    dst[e] = j < n ? __ldg(src + 8 * j + a) : 0.0f;
  }
}

// PTX's NaN-propagating min and max (sm_80 and later), one instruction
// each where jmin/jmax take several: they give the same value on numbers,
// and a NaN for a NaN operand (the canonical one, where jmin/jmax pass the
// operand's own through).  A fold's only use is tn <= tf, which any NaN
// makes false, so every crossing bit is the same as with jmin/jmax (and
// torch.minimum/maximum in the plain versions).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// _slab_axis: fold one axis into [tn, tf], with those min and max.
__device__ __forceinline__ void slab_axis_nan(float lo, float hi, float o, float inv, float& tn, float& tf) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  tn = max_nan(tn, min_nan(t0, t1));
  tf = min_nan(tf, max_nan(t0, t1));
}

// Box k of a [6][stride] table (lo xyz, hi xyz; in shared or device
// memory) against a ray: the interval starts at [0, t_max] and folds x, y,
// z in that order, as _slab_axis does.
__device__ __forceinline__ bool crosses_soa(const float* __restrict__ t, int stride, int k, const SlabRay& r) {
  float tn = 0.0f, tf = r.tm;
  slab_axis_nan(t[k], t[3 * stride + k], r.ox, r.ix, tn, tf);
  slab_axis_nan(t[stride + k], t[4 * stride + k], r.oy, r.iy, tn, tf);
  slab_axis_nan(t[2 * stride + k], t[5 * stride + k], r.oz, r.iz, tn, tf);
  return tn <= tf;
}

__device__ __forceinline__ SlabRay shfl_ray(const SlabRay& r, int q) {
  return {__shfl_sync(FULL, r.ox, q), __shfl_sync(FULL, r.oy, q), __shfl_sync(FULL, r.oz, q),
          __shfl_sync(FULL, r.ix, q), __shfl_sync(FULL, r.iy, q), __shfl_sync(FULL, r.iz, q),
          __shfl_sync(FULL, r.tm, q)};
}

// ---- framed chunk copies: the slot walks (trace_stream.cu) and the
// row-union closest walk (trace_rows.cu) ------------------------------------

// A staged copy of a chunk: k rows of three float4s, then one float4 of
// padding, so copy p + 1 starts 12k + 4 floats after copy p.
__host__ __device__ constexpr int copy_stride4(int k) { return 3 * k + 1; }

// The three float4s of a triangle row (p0 xyz p1x | p1yz p2xy | p2z light
// pid pad) with each vertex's coordinates reordered by PERM: 0 = (x, y,
// z), 1 = (y, z, x), 2 = (z, x, y), the order permx, permy, permz pick for
// a ray whose largest direction component is z, x or y.
template <int PERM>
__device__ __forceinline__ void permuted_row(const float4& a, const float4& b, const float4& c, float4* dst) {
  if (PERM == 0) {
    dst[0] = a;
    dst[1] = b;
    dst[2] = c;
  } else if (PERM == 1) {
    dst[0] = make_float4(a.y, a.z, a.x, b.x);
    dst[1] = make_float4(b.y, a.w, b.w, c.x);
    dst[2] = make_float4(b.z, c.y, c.z, c.w);
  } else {
    dst[0] = make_float4(a.z, a.x, a.y, b.y);
    dst[1] = make_float4(a.w, b.x, c.x, b.z);
    dst[2] = make_float4(b.w, c.y, c.z, c.w);
  }
}

// _watertight_scaled (yuki_tpu/ops/trace.py), the divide-free test, on a
// row already in the ray's shear frame (corners p0' = a.xyz, p1' = (a.w,
// b.x, b.y), p2' = (b.z, b.w, c.x)) from the origin in the same frame: the
// same operations in the same order.  ts and det come back with det > 0
// (t = ts / det); the result covers the sign test, det != 0 and ts > 0, and
// the caller applies the upper bound by cross-multiplication.
__device__ __forceinline__ bool watertight_framed(const Shear& s, V3 o, const float4& a, const float4& b,
                                                  const float4& c, float& ts, float& det) {
  float p0tx = a.x - o.x, p0ty = a.y - o.y, p0tz = a.z - o.z;
  float p1tx = a.w - o.x, p1ty = b.x - o.y, p1tz = b.y - o.z;
  float p2tx = b.z - o.x, p2ty = b.w - o.y, p2tz = c.x - o.z;
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
  det = e0 + e1 + e2;
  ts = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * s.inv_dz;
  if (det < 0.0f) {
    ts = -ts;
    det = -det;
  }
  return !miss_sign && det != 0.0f && ts > 0.0f;
}

// Row r's three copies (copy_stride4(k) float4s apart), permuted for the
// shear frames whose bit is set in `frames` (bit f: frame f).
__device__ __forceinline__ void framed_store(float4* tri4, int k, int r, int frames, const float4& a,
                                             const float4& b, const float4& c) {
  const int stride = copy_stride4(k);
  if (frames & 1) permuted_row<0>(a, b, c, tri4 + 3 * r);
  if (frames & 2) permuted_row<1>(a, b, c, tri4 + stride + 3 * r);
  if (frames & 4) permuted_row<2>(a, b, c, tri4 + 2 * stride + 3 * r);
}

// The largest of each thread's `last` in a block of THREADS threads, to
// every thread (last_w: THREADS / 32 ints of shared memory); the barrier
// also publishes the block's shared-memory stores before it.
template <int THREADS>
__device__ __forceinline__ int block_max(int last, int* last_w) {
  last = __reduce_max_sync(FULL, last);
  if ((threadIdx.x & 31) == 0) last_w[threadIdx.x >> 5] = last;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) last = max(last, last_w[w]);
  return last;
}

// Stage chunk `chunk`'s k triangle rows, by all THREADS threads of the
// block: thread r loads triangle row r with three 16-byte loads and writes
// it into the copies of `frames`.  Returns, to every thread, one past the
// chunk's last row with prim id >= 0 (0 when it has none).
template <int THREADS>
__device__ __forceinline__ int stage_framed(float4* tri4, int* last_w, const float* __restrict__ rows, int chunk,
                                            int k, int frames) {
  const float4* src = reinterpret_cast<const float4*>(rows) + (size_t)chunk * k * 3;
  int last = 0;
  for (int r = threadIdx.x; r < k; r += THREADS) {
    const float4 a = __ldg(src + 3 * r), b = __ldg(src + 3 * r + 1), c = __ldg(src + 3 * r + 2);
    if (c.z >= 0.0f) last = r + 1;
    framed_store(tri4, k, r, frames, a, b, c);
  }
  return block_max<THREADS>(last, last_w);
}

// The staged copy in a ray's shear frame, and a point in that frame.
__device__ __forceinline__ const float4* framed_copy(const float4* tri4, int k, const Shear& sh) {
  return tri4 + frame_of(sh) * copy_stride4(k);
}
__device__ __forceinline__ V3 framed_origin(const Shear& sh, float x, float y, float z) {
  return v3(permx(sh, x, y, z), permy(sh, x, y, z), permz(sh, x, y, z));
}

// The first row in [0, n) of a lane's framed copy `tri` that occludes it
// (any_walk's hit predicate, yuki_tpu/ops/trace_stream.py:776-804: a hit
// within t_max, a light other than the lane's skip id sk, a real row), or
// n; four rows unrolled.
__device__ __forceinline__ int first_occluder(const Shear& sh, V3 o, const float4* tri, int n, float tm,
                                              float sk) {
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const float4* t = tri + 3 * r;
    const float4 a = t[0], b = t[1], c = t[2];
    float ts, det;
    if (watertight_framed(sh, o, a, b, c, ts, det) && ts <= tm * det && c.y != sk && c.z >= 0.0f) return r;
  }
  return n;
}

// closest_walk (yuki_tpu/ops/trace_stream.py:729-773) for one ray over the
// first n_walk rows (a multiple of 8) of its frame's copy `tri`, from the
// running scaled best (ts, det, prim), t = ts / det.  Triangle r goes to
// carry r % 8, the TPU kernel's sublanes, every carry seeded from the
// running best, and the eight are reduced in _scaled_min8's halving order:
// the cross-multiplied compare is not transitive in floating point, so one
// carry would not give the same bits.  A row with prim id < 0 (padding) is
// never taken, so n_walk may stop at the chunk's last real row rounded up
// to 8.  WITH_SKIP (the kernels' with_skip variant): a triangle whose
// light id equals the ray's skip id `sk` is never taken.
template <bool WITH_SKIP>
__device__ __forceinline__ void closest_framed(const Shear& sh, V3 o, const float4* tri, int n_walk, float& ts,
                                               float& det, float& prim, float sk) {
  float ts_b[8], det_b[8], prim_b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    ts_b[s] = ts;
    det_b[s] = det;
    prim_b[s] = prim;
  }
  for (int g = 0; g < n_walk; g += 8) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float4* t = tri + 3 * (g + s);
      const float4 a = t[0], b = t[1], c = t[2];
      float ts_c, det_c;
      const bool ok = watertight_framed(sh, o, a, b, c, ts_c, det_c);
      if (ok && c.z >= 0.0f && ts_c * det_b[s] < ts_b[s] * det_c && (!WITH_SKIP || c.y != sk)) {
        ts_b[s] = ts_c;
        det_b[s] = det_c;
        prim_b[s] = c.z;
      }
    }
  }
  // _scaled_min8: carry a against carry a + h, h = 4, 2, 1.
#pragma unroll
  for (int h = 4; h >= 1; h /= 2) {
#pragma unroll
    for (int a = 0; a < h; ++a) {
      const float lhs = ts_b[a + h] * det_b[a];
      const float rhs = ts_b[a] * det_b[a + h];
      if (lhs < rhs || (lhs == rhs && prim_b[a + h] < prim_b[a])) {
        ts_b[a] = ts_b[a + h];
        det_b[a] = det_b[a + h];
        prim_b[a] = prim_b[a + h];
      }
    }
  }
  ts = ts_b[0];
  det = det_b[0];
  prim = prim_b[0];
}

}  // namespace yk
