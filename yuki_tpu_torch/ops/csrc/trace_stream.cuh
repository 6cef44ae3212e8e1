// Device maths shared by the slot-stream kernels (trace_stream.cu), the
// two-level cull (trace_cull.cu) and the row-union walks (trace_rows.cu):
// the finite slab reciprocal and axis fold of yuki_tpu/ops/trace_stream.py
// (:94-114), the chunk-box slab test, the divide-free watertight test of
// yuki_tpu/ops/trace.py (:57-98) and the closest walk of one chunk.
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

// _slab_axis: fold one axis into [tn, tf].
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float inv, float& tn, float& tf) {
  float t0 = (lo - o) * inv;
  float t1 = (hi - o) * inv;
  tn = jmax(tn, jmin(t0, t1));
  tf = jmin(tf, jmax(t0, t1));
}

// One box (lo xyz at b[0..2], hi xyz at b[3..5]) against a ray: the
// interval starts at [0, t_max] and folds x, y, z in that order.
__device__ __forceinline__ bool crosses(const float* b, const SlabRay& r) {
  float tn = 0.0f, tf = r.tm;
  slab_axis(b[0], b[3], r.ox, r.ix, tn, tf);
  slab_axis(b[1], b[4], r.oy, r.iy, tn, tf);
  slab_axis(b[2], b[5], r.oz, r.iz, tn, tf);
  return tn <= tf;
}

// Copy the first six columns of an [n, 8] box table into shared memory as
// [n, 6], by all threads of the block (the caller synchronises).
__device__ __forceinline__ void stage_boxes(float* dst, const float* __restrict__ src, int n) {
  for (int j = threadIdx.x; j < n * 6; j += blockDim.x) dst[j] = __ldg(src + (j / 6) * 8 + j % 6);
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// opt in); a table too large for the card gives the launch's error.
inline cudaError_t allow_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// _watertight_scaled: the divide-free test against the ray's shear.  ts and
// det come back with det > 0 (t = ts / det); the result covers the sign
// test, det != 0 and ts > 0, and the caller applies the upper bound by
// cross-multiplication.
__device__ __forceinline__ bool watertight_scaled(const Shear& s, V3 o, const float* c, float& ts, float& det) {
  float a0x = c[0] - o.x, a0y = c[1] - o.y, a0z = c[2] - o.z;
  float a1x = c[3] - o.x, a1y = c[4] - o.y, a1z = c[5] - o.z;
  float a2x = c[6] - o.x, a2y = c[7] - o.y, a2z = c[8] - o.z;
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
  det = e0 + e1 + e2;
  ts = (e0 * p0tz + e1 * p1tz + e2 * p2tz) * s.inv_dz;
  if (det < 0.0f) {
    ts = -ts;
    det = -det;
  }
  return !miss_sign && det != 0.0f && ts > 0.0f;
}

// Copy n floats from device memory into shared memory, by all threads of
// the block (the caller synchronises).
__device__ __forceinline__ void stage_floats(float* dst, const float* __restrict__ src, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = __ldg(src + j);
}

// closest_walk (yuki_tpu/ops/trace_stream.py:729-773) for one ray: walk a
// chunk's k staged triangle rows (12 floats each; column 10 is the prim id,
// negative on padding rows) from the running scaled best (ts, det, prim),
// t = ts / det.  Triangle r goes to carry r % 8, the TPU kernel's sublanes,
// every carry seeded from the running best, and the eight are reduced in
// _scaled_min8's halving order: the cross-multiplied compare is not
// transitive in floating point, so one carry would not give the same bits.
// WITH_SKIP (the kernels' with_skip variant): a triangle whose light id
// (column 9) equals the ray's skip id `sk` is never taken.
template <bool WITH_SKIP>
__device__ __forceinline__ void closest_chunk(const Shear& sh, V3 o, const float* tri, int k, float& ts,
                                              float& det, float& prim, float sk) {
  float ts_b[8], det_b[8], prim_b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    ts_b[s] = ts;
    det_b[s] = det;
    prim_b[s] = prim;
  }
  for (int g = 0; g < k; g += 8) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float* c = tri + 12 * (g + s);
      float ts_c, det_c;
      const bool ok = watertight_scaled(sh, o, c, ts_c, det_c);
      const float pid = c[10];
      if (ok && pid >= 0.0f && ts_c * det_b[s] < ts_b[s] * det_c && (!WITH_SKIP || c[9] != sk)) {
        ts_b[s] = ts_c;
        det_b[s] = det_c;
        prim_b[s] = pid;
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
