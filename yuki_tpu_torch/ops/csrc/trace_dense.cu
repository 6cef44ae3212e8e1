// Dense trace kernels for Hopper (sm_90a): the CUDA port of two Pallas
// kernels of yuki_tpu/ops/trace.py, the scene queries of dense scenes
// (at most DENSE_TRI_THRESHOLD = 4096 triangles) outside the fused wave.
//
//   yk_dense_closest  replaces _dense_kernel (trace.py:176) and, given
//                     light and skip ids, _dense_skip_kernel (:249)
//   yk_dense_any      replaces _any_kernel (trace.py:221)
//
// Design.  One thread per ray, 256-thread blocks.  The triangles' corners
// (9 floats each) are streamed through shared memory in tiles of TILE
// triangles, so any count fits; every thread reads the same corner at the
// same time (a broadcast).  The closest sweep goes in ascending triangle
// order and takes a triangle when it hits and ti < t; the RUNNING t enters
// the watertight range test (t_cur * det, trace.py:167-169), so the lowest
// index wins an exact tie, as in the TPU kernel.  The skip variant
// (dense_closest_kernel<true>) also stages the tile's light ids and never
// takes a triangle whose id equals the lane's skip id (-2 matches none):
// one sweep serves combined closest + shadow waves.  The occlusion sweep ORs
// hits whose light id differs from the lane's skip id: a lane stops at its
// first occluder and a block once all its lanes are occluded (the result
// is an OR; the TPU kernel, which has no early exit, gives the same bits).
//
// What bounds it: ALU work, 43 operations per watertight test and T tests
// per ray; traffic is 28-32 B of ray in (32-36 B with a skip id), 16 B
// (1 B) out per ray and the 48 B (52 B) triangle rows once per block (from
// L2 after the first block).
//
// Numerics: built with -fmad=false and without fast-math, watertight9 of
// path_fused.cuh (the raygen and bounce kernels' test).

#include <cuda_runtime.h>

#include <cstdint>

#include "path_fused.cuh"

using namespace yk;

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;  // triangles per shared-memory tile: 36 KB of corners

__device__ __forceinline__ void stage_tile(float* tri_s, const float* __restrict__ tris, int base, int m) {
  for (int j = threadIdx.x; j < m * 9; j += THREADS) tri_s[j] = __ldg(tris + (size_t)(base + j / 9) * 12 + j % 9);
}

__device__ __forceinline__ bool hit9(const Shear& sh, V3 o, float t_cur, const float* c, float& t, float& b0,
                                     float& b1) {
  return watertight9(sh, o, t_cur, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], t, b0, b1);
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(THREADS)
    dense_closest_kernel(const float* __restrict__ tris, const int* __restrict__ light, int n_tris,
                         const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                         const int* __restrict__ skip, int n, float* __restrict__ t_out, int* __restrict__ prim_out,
                         float* __restrict__ b0_out, float* __restrict__ b1_out) {
  __shared__ float tri_s[TILE * 9];
  __shared__ int light_s[WITH_SKIP ? TILE : 1];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool valid = i < n;
  const V3 ro = valid ? v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]) : zero3();
  const Shear sh = make_shear(valid ? v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]) : v3(1.0f, 1.0f, 1.0f));
  float t = valid ? tmax[i] : 0.0f;
  float b0 = 0.0f, b1 = 0.0f;
  int prim = -1;
  int sk = -2;
  if constexpr (WITH_SKIP) sk = valid ? skip[i] : -2;
  for (int base = 0; base < n_tris; base += TILE) {
    const int m = min(TILE, n_tris - base);
    __syncthreads();
    stage_tile(tri_s, tris, base, m);
    if constexpr (WITH_SKIP)
      for (int j = threadIdx.x; j < m; j += THREADS) light_s[j] = __ldg(light + base + j);
    __syncthreads();
    for (int r = 0; r < m; ++r) {
      float ti, bi0, bi1;
      if (hit9(sh, ro, t, tri_s + 9 * r, ti, bi0, bi1) && ti < t && (!WITH_SKIP || light_s[r] != sk)) {
        t = ti;
        prim = base + r;
        b0 = bi0;
        b1 = bi1;
      }
    }
  }
  if (!valid) return;
  t_out[i] = t;
  prim_out[i] = prim;
  b0_out[i] = b0;
  b1_out[i] = b1;
}

__global__ void __launch_bounds__(THREADS)
    dense_any_kernel(const float* __restrict__ tris, const int* __restrict__ light, int n_tris,
                     const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                     const int* __restrict__ skip, int n, bool* __restrict__ occ_out) {
  __shared__ float tri_s[TILE * 9];
  __shared__ int light_s[TILE];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool valid = i < n;
  const V3 ro = valid ? v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]) : zero3();
  const Shear sh = make_shear(valid ? v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]) : v3(1.0f, 1.0f, 1.0f));
  const float tm = valid ? tmax[i] : 0.0f;
  const int sk = valid ? skip[i] : -2;
  // A lane with t_max <= 0 can hit nothing (the range test); NaN stays live.
  const bool live = valid && !(tm <= 0.0f);
  bool occ = false;
  for (int base = 0; base < n_tris; base += TILE) {
    // The barrier also orders the reuse of the tile.
    if (!__syncthreads_or(live && !occ)) break;
    const int m = min(TILE, n_tris - base);
    stage_tile(tri_s, tris, base, m);
    for (int j = threadIdx.x; j < m; j += THREADS) light_s[j] = __ldg(light + base + j);
    __syncthreads();
    if (!live || occ) continue;
    for (int r = 0; r < m; ++r) {
      float ti, bi0, bi1;
      if (hit9(sh, ro, tm, tri_s + 9 * r, ti, bi0, bi1) && light_s[r] != sk) {
        occ = true;
        break;
      }
    }
  }
  if (valid) occ_out[i] = occ;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

// light and skip both null: the plain sweep; both given: the skip sweep.
extern "C" int yk_dense_closest(int device, const float* tris, const int* light, int n_tris, const float* o,
                                const float* d, const float* tmax, const int* skip, int n, float* t, int* prim,
                                float* b0, float* b1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (skip != nullptr)
    dense_closest_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tris, light, n_tris, o, d, tmax, skip, n,
                                                                             t, prim, b0, b1);
  else
    dense_closest_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tris, light, n_tris, o, d, tmax, skip,
                                                                              n, t, prim, b0, b1);
  return (int)cudaGetLastError();
}

extern "C" int yk_dense_any(int device, const float* tris, const int* light, int n_tris, const float* o,
                            const float* d, const float* tmax, const int* skip, int n, bool* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dense_any_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(tris, light, n_tris, o, d,
                                                                                     tmax, skip, n, occ);
  return (int)cudaGetLastError();
}
