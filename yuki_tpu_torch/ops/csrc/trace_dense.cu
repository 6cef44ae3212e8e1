// Dense trace kernels for Hopper (sm_90a): the CUDA port of two Pallas
// kernels of yuki_tpu/ops/trace.py, the scene queries of dense scenes
// (at most DENSE_TRI_THRESHOLD = 4096 triangles) outside the fused wave.
//
//   yk_dense_closest  replaces _dense_kernel (trace.py:176) and, given
//                     light and skip ids, _dense_skip_kernel (:249)
//   yk_dense_any      replaces _any_kernel (trace.py:221)
//
// Design.  One thread per ray.  The closest sweep goes in ascending
// triangle order and takes a triangle when it hits and ti < t; the RUNNING
// t enters the watertight range test (t_cur * det, trace.py:167-169), so
// the lowest index wins an exact tie, as in the TPU kernel.  The skip
// variant (dense_closest_kernel<true>) never takes a triangle whose light
// id equals the lane's skip id (-2 matches none): one sweep serves combined
// closest + shadow waves.  The occlusion sweep ORs hits whose light id
// differs from the lane's skip id: a lane stops at its first occluder and
// a block once all its lanes are occluded (the result is an OR; the TPU
// kernel, which has no early exit, gives the same bits).
//
// dense_closest (redesigned for the card; PERF.md §6 records the change
// and its measurements).  The first port staged 1024-triangle tiles of
// corners (36 KB of static shared memory, whatever the scene's size) with
// scalar loads and ran the whole watertight9 in every test: 9 subtracts,
// 18 coordinate selects, an IEEE divide and t, b0, b1, also for the tests
// that miss.  Now, as the raygen kernel's camera sweep (path_fused.cu)
// does, without hoisting the origin (a bounce's rays have their own):
// - the block finds the shear frames its rays need (block_frames) and
//   stages each CLOSEST_TILE-triangle tile as a copy permuted for each
//   of them, copy_stride4 apart (disjoint banks), with
//   16-byte loads of the [T, 12] rows (the skip variant puts the light id
//   in the copy's column 9); the shared memory is sized to the scene
//   (min(T, CLOSEST_TILE) triangles, three copies);
// - a ray tests its frame's copy from its origin in that frame: 9
//   subtracts and no selects (permx(c - o) = permx(c) - permx(o));
// - the reciprocal of det and ti only for a test whose sign, det and
//   range tests pass (then det != 0, so det_safe = det), b0 and b1 only
//   when ti < t takes the hit: the first port computed them on every test
//   and kept them only then.
// The operations each test makes are watertight9's, in its order, so
// every output keeps its bits.
//
// What bounds them: ALU work, 39 operations per closest test plus 2 for a
// passing test's divide and 2 for a taken hit's b0 and b1 (chip_smoke.py
// dense_ops), 43 per occlusion test, T tests per ray; traffic is 28-32 B
// of ray in (32-36 B with a skip id), 16 B (1 B) out per ray and the 48 B
// (52 B) triangle rows once per block (from L2 after the first block).
//
// Numerics: built with -fmad=false and without fast-math; the occlusion
// sweep runs watertight9 of path_fused.cuh (the bounce kernel's test).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 1024;  // dense_any: triangles per shared-memory tile, 36 KB of corners
constexpr int CLOSEST_THREADS = 256;
constexpr int CLOSEST_TILE = 256;  // dense_closest: triangles per stage, three copies of 48 B each
constexpr int CLOSEST_MIN_BLOCKS = 4;  // at most 64 registers: four 256-thread blocks an SM

__device__ __forceinline__ void stage_tile(float* tri_s, const float* __restrict__ tris, int base, int m) {
  for (int j = threadIdx.x; j < m * 9; j += THREADS) tri_s[j] = __ldg(tris + (size_t)(base + j / 9) * 12 + j % 9);
}

__device__ __forceinline__ bool hit9(const Shear& sh, V3 o, float t_cur, const float* c, float& t, float& b0,
                                     float& b1) {
  return watertight9(sh, o, t_cur, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], t, b0, b1);
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(CLOSEST_THREADS, CLOSEST_MIN_BLOCKS)
    dense_closest_kernel(const float* __restrict__ tris, const int* __restrict__ light, int n_tris, int tile,
                         const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                         const int* __restrict__ skip, int n, float* __restrict__ t_out, int* __restrict__ prim_out,
                         float* __restrict__ b0_out, float* __restrict__ b1_out) {
  extern __shared__ float4 tile4[];  // the tile's three framed copies, copy_stride4(tile) float4s apart
  __shared__ int frames_w[CLOSEST_THREADS / 32];
  const int i = blockIdx.x * CLOSEST_THREADS + threadIdx.x;
  const bool valid = i < n;
  const Shear sh = make_shear(valid ? v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]) : v3(1.0f, 1.0f, 1.0f));
  const V3 of = valid ? framed_origin(sh, o[3 * i], o[3 * i + 1], o[3 * i + 2]) : zero3();
  const int frame = valid ? frame_of(sh) : -1;
  const float4* copy = framed_copy(tile4, tile, sh);
  float t = valid ? tmax[i] : 0.0f;
  float b0 = 0.0f, b1 = 0.0f;
  int prim = -1;
  const int sk = WITH_SKIP && valid ? skip[i] : -2;
  const int frames = block_frames<CLOSEST_THREADS>(frame, frames_w);
  const float4* src = reinterpret_cast<const float4*>(tris);
  for (int base = 0; base < n_tris; base += tile) {
    const int m = min(tile, n_tris - base);
    if (base > 0) __syncthreads();  // the last sweep's reads of the copies are done
    for (int j = threadIdx.x; j < m; j += CLOSEST_THREADS) {
      const size_t row = (size_t)(base + j) * 3;
      const float4 a = __ldg(src + row), b = __ldg(src + row + 1);
      float4 c = __ldg(src + row + 2);
      if (WITH_SKIP) c.y = __int_as_float(__ldg(light + base + j));
      framed_store(tile4, tile, j, frames, a, b, c);
    }
    __syncthreads();
    if (!valid) continue;
    for (int r = 0; r < m; ++r) {
      // Row r of the frame's copy: corners in the frame, the light id's bits in q2.y.
      const float4 q0 = copy[3 * r], q1 = copy[3 * r + 1], q2 = copy[3 * r + 2];
      if (sweep_take(sh, q0.x - of.x, q0.y - of.y, q0.z - of.z, q0.w - of.x, q1.x - of.y, q1.y - of.z,
                     q1.z - of.x, q1.w - of.y, q2.x - of.z, !WITH_SKIP || __float_as_int(q2.y) != sk, t, b0, b1))
        prim = base + r;
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
  const int blocks = (n + CLOSEST_THREADS - 1) / CLOSEST_THREADS;
  const int tile = std::max(1, std::min(CLOSEST_TILE, n_tris));
  const size_t shmem = (size_t)3 * copy_stride4(tile) * sizeof(float4);
  const void* kernel =
      skip != nullptr ? (const void*)dense_closest_kernel<true> : (const void*)dense_closest_kernel<false>;
  err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  if (skip != nullptr)
    dense_closest_kernel<true><<<blocks, CLOSEST_THREADS, shmem, (cudaStream_t)stream>>>(
        tris, light, n_tris, tile, o, d, tmax, skip, n, t, prim, b0, b1);
  else
    dense_closest_kernel<false><<<blocks, CLOSEST_THREADS, shmem, (cudaStream_t)stream>>>(
        tris, light, n_tris, tile, o, d, tmax, skip, n, t, prim, b0, b1);
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
