// Bundle walks for Hopper (sm_90a): the CUDA port of the two Pallas kernels
// of yuki_tpu/ops/trace_walker.py, the divergent-wave engine behind
// traverse.WALKER_CLOSEST / WALKER_ANY.
//
//   yk_walker_closest  replaces _walker_closest_kernel (trace_walker.py:204)
//                      and the fold after it, _lane_fold_closest (:354);
//                      given skip ids, its with_skip variant
//   yk_walker_any      replaces _walker_any_kernel (:269)
//
// Design.  One 128-thread block per 8-ray bundle.  Thread j is triangle slot
// j of the chunk being walked (chunks of k <= 128 triangles; threads j >= k
// idle as the TPU's padding lanes do) and holds, in registers, its slot's
// carry for the bundle's 8 rays: (ts, det, prim) each for the closest walk,
// 8 bits for occlusion.  This is the TPU kernel's [8, 128] out block laid
// onto threads.  The block walks its bundle's list (ascending chunk ids, -1
// ends it) in order; per chunk:
//
//   - each ray's bound: closest, the minimum over the 128 slots of ts / det
//     (a warp minimum, then one over the four warps in shared memory);
//     occlusion, t_max, and the OR over the slots of the ray's bit;
//   - threads 0-7 test ray r = thread's chunk box (_bounds_recheck: the
//     finite reciprocal, max(tn, 0) <= min(tf, bound)); a ray is live when
//     its t_max > 0, the test passes and (occlusion) it is unoccluded; the
//     chunk is skipped when no ray is live (__syncthreads_or);
//   - the chunk's k triangle rows are staged in shared memory and each slot
//     tests its triangle against the live rays: closest keeps a new hit only
//     on ts_c * det_b < ts_b * det_c (the first in list order wins a tie
//     within a slot; walker_closest_kernel<true>, with_skip, never takes a
//     triangle of the ray's skip light), occlusion sets the ray's bit when
//     the triangle is
//     real, of another light than the ray's skip id, and hit within t_max.
//
// The closest kernel ends with _lane_fold_closest in shared memory: misses
// enter as (F32_MAX, 1, BIG); for h = 64, 32, ..., 1 slot i takes slot i + h
// when ts_b * det_a < ts_a * det_b, or equal with a lower prim id; then one
// IEEE divide per ray.  The scaled compare is not transitive, so the per-slot
// carry and this pairing are kept rather than a running minimum per ray.
//
// What bounds it: ALU work, ~40 operations per live ray and real triangle of
// each walked chunk plus a 24-operation box test per ray and chunk; traffic
// is 28-32 B of ray in and 8 B (4 B) out per ray, 4 B per list entry and the
// 6 KB rows of each walked chunk (served from L2 after the first bundle).
//
// Numerics: -fmad=false and no fast-math, so every product rounds on its own
// as in the PyTorch and JAX versions; min/max propagate NaN (jmin/jmax).

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int SLOTS = 128;  // triangle slots per chunk: threads per block
constexpr int BUN = 8;      // rays per bundle
constexpr int WARPS = SLOTS / 32;
constexpr float BIG = 3.0e38f;

// A bundle's rays, staged once per block.
struct BundleRays {
  V3 o[BUN];
  V3 d[BUN];
  Shear sh[BUN];
  float tm[BUN];
};

__device__ __forceinline__ void load_bundle(BundleRays& R, const float* __restrict__ o,
                                            const float* __restrict__ d, const float* __restrict__ tmax) {
  const int r = threadIdx.x;
  if (r < BUN) {
    const int i = blockIdx.x * BUN + r;
    R.o[r] = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    R.d[r] = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    R.sh[r] = make_shear(R.d[r]);
    R.tm[r] = tmax[i];
  }
}

// _bounds_recheck (trace_walker.py:181-201): chunk box b (lo 0-2, hi 3-5)
// against one ray and its bound, with the finite reciprocal of _safe_inv.
__device__ __forceinline__ bool bounds_recheck(const float* __restrict__ b, V3 o, V3 d, float t_bound) {
  const float ix = safe_inv(d.x), iy = safe_inv(d.y), iz = safe_inv(d.z);
  const float t0x = (__ldg(b + 0) - o.x) * ix;
  const float t1x = (__ldg(b + 3) - o.x) * ix;
  const float t0y = (__ldg(b + 1) - o.y) * iy;
  const float t1y = (__ldg(b + 4) - o.y) * iy;
  const float t0z = (__ldg(b + 2) - o.z) * iz;
  const float t1z = (__ldg(b + 5) - o.z) * iz;
  const float tn = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmin(t0z, t1z));
  const float tf = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmax(t0z, t1z));
  return jmax(tn, 0.0f) <= jmin(tf, t_bound);
}

// fminf, where jnp.min would propagate a NaN: ts / det is never NaN (seeds
// are t_max / 1, kept hits have det != 0 and ts > 0), so jmin's NaN tests
// would only slow the per-chunk bound.
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(SLOTS)
    walker_closest_kernel(const float* __restrict__ cb, const float* __restrict__ rows, int k,
                          const int* __restrict__ lists, int C, const float* __restrict__ o,
                          const float* __restrict__ d, const float* __restrict__ tmax,
                          const float* __restrict__ skip, float* __restrict__ t_out, int* __restrict__ prim_out) {
  __shared__ BundleRays R;
  __shared__ float sk[WITH_SKIP ? BUN : 1];
  __shared__ float tri_s[SLOTS * 12];
  __shared__ float red[WARPS][BUN];
  __shared__ bool live_s[BUN];
  __shared__ float f_ts[BUN][SLOTS], f_det[BUN][SLOTS], f_prim[BUN][SLOTS];
  const int j = threadIdx.x, lane = j % 32, warp = j / 32;
  load_bundle(R, o, d, tmax);
  if constexpr (WITH_SKIP)
    if (j < BUN) sk[j] = skip[blockIdx.x * BUN + j];
  __syncthreads();

  float ts[BUN], det[BUN], prim[BUN];
#pragma unroll
  for (int r = 0; r < BUN; ++r) {
    ts[r] = R.tm[r];
    det[r] = 1.0f;
    prim[r] = -1.0f;
  }
  const int* list = lists + (size_t)blockIdx.x * C;
  for (int q = 0; q < C; ++q) {
    const int tt = __ldg(list + q);
    if (tt < 0) break;
    // Each ray's bound: the minimum over the slots of ts / det.
#pragma unroll
    for (int r = 0; r < BUN; ++r) {
      const float m = warp_min(ts[r] / det[r]);
      if (lane == 0) red[warp][r] = m;
    }
    __syncthreads();
    bool live = false;
    if (j < BUN) {
      float t_cur = red[0][j];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) t_cur = fminf(t_cur, red[w][j]);
      live = R.tm[j] > 0.0f && bounds_recheck(cb + 8 * tt, R.o[j], R.d[j], t_cur);
      live_s[j] = live;
    }
    if (!__syncthreads_or(live)) continue;
    stage_floats(tri_s, rows + (size_t)tt * k * 12, k * 12);
    __syncthreads();
    if (j < k) {
      const float* c = tri_s + 12 * j;
      const float pid = c[10];
      if (pid >= 0.0f) {
#pragma unroll
        for (int r = 0; r < BUN; ++r) {
          if (!live_s[r]) continue;
          if constexpr (WITH_SKIP)
            if (c[9] == sk[r]) continue;
          float ts_c, det_c;
          const bool ok = watertight_scaled(R.sh[r], R.o[r], c, ts_c, det_c);
          if (ok && ts_c * det[r] < ts[r] * det_c) {
            ts[r] = ts_c;
            det[r] = det_c;
            prim[r] = pid;
          }
        }
      }
    }
  }

  // _lane_fold_closest over the 128 slots.
#pragma unroll
  for (int r = 0; r < BUN; ++r) {
    const bool miss = prim[r] < 0.0f;
    f_ts[r][j] = miss ? YK_F32_MAX : ts[r];
    f_det[r][j] = miss ? 1.0f : det[r];
    f_prim[r][j] = miss ? BIG : prim[r];
  }
  __syncthreads();
  for (int h = SLOTS / 2; h >= 1; h /= 2) {
    if (j < h) {
#pragma unroll
      for (int r = 0; r < BUN; ++r) {
        const int a = j, b = j + h;
        const float lhs = f_ts[r][b] * f_det[r][a];
        const float rhs = f_ts[r][a] * f_det[r][b];
        if (lhs < rhs || (lhs == rhs && f_prim[r][b] < f_prim[r][a])) {
          f_ts[r][a] = f_ts[r][b];
          f_det[r][a] = f_det[r][b];
          f_prim[r][a] = f_prim[r][b];
        }
      }
    }
    __syncthreads();
  }
  if (j < BUN) {
    const int i = blockIdx.x * BUN + j;
    const bool hit = f_prim[j][0] < BIG;
    t_out[i] = hit ? f_ts[j][0] / f_det[j][0] : R.tm[j];
    prim_out[i] = hit ? (int)f_prim[j][0] : -1;
  }
}

// The OR over the block of each thread's 8 occlusion bits, for threads
// 0-7 to read as bit r (the caller synchronises before the next use of
// red_or).
__device__ __forceinline__ unsigned block_or(unsigned bits, unsigned* red_or) {
  const unsigned w = __reduce_or_sync(0xffffffffu, bits);
  if (threadIdx.x % 32 == 0) red_or[threadIdx.x / 32] = w;
  __syncthreads();
  unsigned all = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) all |= red_or[k];
  return all;
}

__global__ void __launch_bounds__(SLOTS)
    walker_any_kernel(const float* __restrict__ cb, const float* __restrict__ rows, int k,
                      const int* __restrict__ lists, int C, const float* __restrict__ o,
                      const float* __restrict__ d, const float* __restrict__ tmax, const float* __restrict__ skip,
                      int* __restrict__ occ_out) {
  __shared__ BundleRays R;
  __shared__ float sk[BUN];
  __shared__ float tri_s[SLOTS * 12];
  __shared__ unsigned red_or[WARPS];
  __shared__ bool live_s[BUN];
  const int j = threadIdx.x;
  load_bundle(R, o, d, tmax);
  if (j < BUN) sk[j] = skip[blockIdx.x * BUN + j];
  __syncthreads();

  unsigned occ = 0;  // bit r: this slot occludes ray r
  const int* list = lists + (size_t)blockIdx.x * C;
  for (int q = 0; q < C; ++q) {
    const int tt = __ldg(list + q);
    if (tt < 0) break;
    const unsigned ray_occ = block_or(occ, red_or);
    bool live = false;
    if (j < BUN) {
      live = R.tm[j] > 0.0f && !((ray_occ >> j) & 1u) && bounds_recheck(cb + 8 * tt, R.o[j], R.d[j], R.tm[j]);
      live_s[j] = live;
    }
    if (!__syncthreads_or(live)) continue;
    stage_floats(tri_s, rows + (size_t)tt * k * 12, k * 12);
    __syncthreads();
    if (j < k) {
      const float* c = tri_s + 12 * j;
      if (c[10] >= 0.0f) {
#pragma unroll
        for (int r = 0; r < BUN; ++r) {
          if (!live_s[r] || c[9] == sk[r]) continue;
          float ts_c, det_c;
          const bool ok = watertight_scaled(R.sh[r], R.o[r], c, ts_c, det_c);
          if (ok && ts_c <= R.tm[r] * det_c) occ |= 1u << r;
        }
      }
    }
  }
  const unsigned all = block_or(occ, red_or);
  if (j < BUN) occ_out[blockIdx.x * BUN + j] = (all >> j) & 1u;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

// skip null: the plain walk; given: the with_skip variant.
extern "C" int yk_walker_closest(int device, const float* cb, const float* rows, int leaf_size, const int* lists,
                                 int C, int n_bundles, const float* o, const float* d, const float* tmax,
                                 const float* skip, float* t, int* prim, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (skip != nullptr)
    walker_closest_kernel<true><<<n_bundles, SLOTS, 0, (cudaStream_t)stream>>>(cb, rows, leaf_size, lists, C, o, d,
                                                                               tmax, skip, t, prim);
  else
    walker_closest_kernel<false><<<n_bundles, SLOTS, 0, (cudaStream_t)stream>>>(cb, rows, leaf_size, lists, C, o, d,
                                                                                tmax, skip, t, prim);
  return (int)cudaGetLastError();
}

extern "C" int yk_walker_any(int device, const float* cb, const float* rows, int leaf_size, const int* lists, int C,
                             int n_bundles, const float* o, const float* d, const float* tmax, const float* skip,
                             int* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  walker_any_kernel<<<n_bundles, SLOTS, 0, (cudaStream_t)stream>>>(cb, rows, leaf_size, lists, C, o, d, tmax, skip,
                                                                   occ);
  return (int)cudaGetLastError();
}
