// Block-pair treelet walks for Hopper (sm_90a): the CUDA port of the two
// Pallas kernels of yuki_tpu/ops/trace_pairs.py.
//
//   yk_pairs_closest  replaces _pairs_kernel (trace_pairs.py:176)
//   yk_pairs_any      replaces _pairs_any_kernel (:219)
//
// Design.  One 1024-thread CUDA block per 1024-ray block of the TPU kernel
// and one thread per ray; the block walks its run of (block, treelet)
// pairs, runs[b] .. runs[b + 1] of the pair list, in order, in one launch
// (the TPU walks the list in CHUNK-pair launches and merges them; its
// result does not depend on that).  Rays come from the packed table of
// _pack_rays: plane p of the block's lane i at row 8 b + i / 128, column
// 128 p + i % 128, so neighbouring threads read neighbouring words;
// padding lanes carry the table's origin 0, direction 1, t_max 0, skip -2
// and take part in the block's decisions as on the TPU, but are not
// written.  Per pair:
//
//   - each lane's slab test of the treelet's box against its own running t
//     (closest) or t_max (occlusion; only unoccluded lanes count);
//     __syncthreads_or of the verdicts is the TPU's "any lane alive" branch,
//     so a lane whose own test fails still tests the rows, as there;
//   - the treelet's K rows (K x 12 floats) are staged in shared memory;
//   - closest: rows in order, a row taken when the direct-t watertight test
//     hits within the running t, ti < t and its prim id is >= 0;
//   - occlusion: a row's blocking hit (real row, light id other than the
//     lane's skip id, compared as floats) ORs into the lane; after each row
//     the block leaves the treelet once no lane that crosses its box is
//     unoccluded (__syncthreads_or), as the TPU kernel's while loop does, so
//     lanes that do not cross keep what the walked rows gave them.
//
// What bounds it: ALU work, ~43 operations per lane and row of each visited
// treelet and 24 per box test; traffic is 32-36 B of ray in and 16 B (1 B)
// out per ray, 4 B per pair and the 48 B rows of each visited treelet.
//
// Numerics: -fmad=false and no fast-math; watertight9 of path_fused.cuh and
// the NaN-propagating slab of trace_treelets.cuh, as the treelet walks use.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_treelets.cuh"

using namespace yk;

namespace {

constexpr int ROWS = BLOCK / 128;  // rows of 128 lanes per ray block

// Plane p of this thread's lane in ray block b of a table `planes` planes
// wide.
__device__ __forceinline__ float plane(const float* __restrict__ packed, int planes, int b, int p) {
  const int row = b * ROWS + threadIdx.x / 128;
  return __ldg(packed + ((size_t)row * planes + p) * 128 + threadIdx.x % 128);
}

__device__ __forceinline__ Lane packed_lane(const float* __restrict__ packed, int planes, int b) {
  return make_lane(v3(plane(packed, planes, b, 0), plane(packed, planes, b, 1), plane(packed, planes, b, 2)),
                   v3(plane(packed, planes, b, 3), plane(packed, planes, b, 4), plane(packed, planes, b, 5)));
}

__global__ void __launch_bounds__(BLOCK)
    pairs_closest_kernel(const float* __restrict__ tb, const float* __restrict__ rows, int k,
                         const int* __restrict__ runs, const int* __restrict__ pair_treelet,
                         const float* __restrict__ packed, int n, float* __restrict__ t_out,
                         int* __restrict__ prim_out, float* __restrict__ b0_out, float* __restrict__ b1_out) {
  extern __shared__ float rows_s[];
  const int b = blockIdx.x;
  const int i = b * BLOCK + threadIdx.x;
  const Lane l = packed_lane(packed, 7, b);
  float t = plane(packed, 7, b, 6);
  int prim = -1;
  float b0 = 0.0f, b1 = 0.0f;
  const int q1 = __ldg(runs + b + 1);
  for (int q = __ldg(runs + b); q < q1; ++q) {
    const int tt = __ldg(pair_treelet + q);
    if (!__syncthreads_or(slab(tb + 8 * tt, l, t))) continue;
    stage_rows(rows_s, rows, tt, k);
    for (int r = 0; r < k; ++r) {
      const float* c = rows_s + 12 * r;
      float ti, bi0, bi1;
      const bool hit = watertight9(l.sh, l.o, t, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ti, bi0, bi1);
      const float pid = c[10];
      // pid < 0 marks padding rows, masked by id and not by area.
      if (hit && ti < t && pid >= 0.0f) {
        t = ti;
        prim = (int)pid;
        b0 = bi0;
        b1 = bi1;
      }
    }
  }
  if (i < n) {
    t_out[i] = t;
    prim_out[i] = prim;
    b0_out[i] = b0;
    b1_out[i] = b1;
  }
}

__global__ void __launch_bounds__(BLOCK)
    pairs_any_kernel(const float* __restrict__ tb, const float* __restrict__ rows, int k,
                     const int* __restrict__ runs, const int* __restrict__ pair_treelet,
                     const float* __restrict__ packed, int n, bool* __restrict__ occ_out) {
  extern __shared__ float rows_s[];
  const int b = blockIdx.x;
  const int i = b * BLOCK + threadIdx.x;
  const Lane l = packed_lane(packed, 8, b);
  const float t_max = plane(packed, 8, b, 6);
  const float skip = plane(packed, 8, b, 7);
  bool occ = false;
  const int q1 = __ldg(runs + b + 1);
  for (int q = __ldg(runs + b); q < q1; ++q) {
    const int tt = __ldg(pair_treelet + q);
    const bool crossing = slab(tb + 8 * tt, l, t_max);
    if (!__syncthreads_or(crossing && !occ)) continue;
    stage_rows(rows_s, rows, tt, k);
    for (int r = 0; r < k; ++r) {
      const float* c = rows_s + 12 * r;
      float ti, bi0, bi1;
      const bool hit =
          watertight9(l.sh, l.o, t_max, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ti, bi0, bi1);
      occ = occ || (hit && c[9] != skip && c[10] >= 0.0f);
      // Leave once every lane that crosses the box is occluded.
      if (!__syncthreads_or(crossing && !occ)) break;
    }
  }
  if (i < n) occ_out[i] = occ;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_pairs_closest(int device, const float* tb, const float* rows, int leaf_size, const int* runs,
                                const int* pair_treelet, int n_blocks, const float* packed, int n, float* t,
                                int* prim, float* b0, float* b1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)leaf_size * 12 * sizeof(float);
  pairs_closest_kernel<<<n_blocks, BLOCK, shmem, (cudaStream_t)stream>>>(tb, rows, leaf_size, runs, pair_treelet,
                                                                         packed, n, t, prim, b0, b1);
  return (int)cudaGetLastError();
}

extern "C" int yk_pairs_any(int device, const float* tb, const float* rows, int leaf_size, const int* runs,
                            const int* pair_treelet, int n_blocks, const float* packed, int n, bool* occ,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)leaf_size * 12 * sizeof(float);
  pairs_any_kernel<<<n_blocks, BLOCK, shmem, (cudaStream_t)stream>>>(tb, rows, leaf_size, runs, pair_treelet,
                                                                     packed, n, occ);
  return (int)cudaGetLastError();
}
