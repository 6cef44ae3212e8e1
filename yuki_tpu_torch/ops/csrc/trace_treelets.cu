// Two-level treelet walk kernels for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/trace_treelets.py's two Pallas kernels.
//
//   yk_treelet_closest  replaces _closest_kernel (trace_treelets.py:55)
//   yk_treelet_any      replaces _any_kernel (trace_treelets.py:129)
//
// Design.  One thread per ray and one 1024-thread CUDA block per ray block
// of the TPU kernel (1024 consecutive rays; lanes past the end of the batch
// are the padding rays of treelet_closest's _pack: origin 0, direction
// (1,1,1), t_max 0, skip -2, and are not written).  The block walks the
// supers in order, then a visited super's treelets, then a visited
// treelet's rows in order.  The TPU kernel's scalar branch "does any lane's
// slab test hit this box" is __syncthreads_or of each lane's verdict, made
// with the lane's own current t: every lane therefore tests exactly the
// triangles it tests on the TPU, and the result equals the plain version
// (ops/trace_treelets.py) bit for bit.  A visited treelet's K rows (K*12
// floats) are staged in shared memory, the analogue of the TPU kernel's
// DMA into VMEM (:83-88); the barrier of the next __syncthreads_or orders
// the reuse of the buffer.  The occlusion walk leaves the block once every
// lane is occluded (:145, :178) and compares light ids as floats.
//
// What bounds it: ALU work.  A watertight test is ~45 float operations
// (shear and edge functions) on registers; a block of divergent bounce
// rays visits most treelets, so the walk approaches a dense sweep of the
// subtrees its block spans (a later PR culls per warp or per ray; it must
// then show zero prim flips).  Memory traffic is the 48 B rows once per
// visited treelet per block plus 28-32 B of ray in and 16 B out per ray.
//
// Numerics: built with -fmad=false and without fast-math; the slab test
// uses NaN-propagating min/max (jmin/jmax) as jnp and torch do, so an
// axis-parallel ray's 0 * inf = NaN fails the compare the same way.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_treelets.cuh"

using namespace yk;

namespace {

__device__ __forceinline__ Lane load_lane(const float* __restrict__ o, const float* __restrict__ d, int i,
                                          bool valid) {
  return make_lane(valid ? v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]) : v3(0.0f, 0.0f, 0.0f),
                   valid ? v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]) : v3(1.0f, 1.0f, 1.0f));
}

__global__ void __launch_bounds__(BLOCK)
    treelet_closest_kernel(const float* __restrict__ sb, const int* __restrict__ sr, const float* __restrict__ tb,
                           const float* __restrict__ rows, int n_supers, int k, const float* __restrict__ o,
                           const float* __restrict__ d, const float* __restrict__ tmax, int n,
                           float* __restrict__ t_out, int* __restrict__ prim_out, float* __restrict__ b0_out,
                           float* __restrict__ b1_out) {
  extern __shared__ float rows_s[];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;
  const Lane l = load_lane(o, d, i, valid);
  float t = valid ? tmax[i] : 0.0f;
  int prim = -1;
  float b0 = 0.0f, b1 = 0.0f;

  for (int s = 0; s < n_supers; ++s) {
    if (!__syncthreads_or(slab(sb + 8 * s, l, t))) continue;
    const int t0 = __ldg(sr + 2 * s), tc = __ldg(sr + 2 * s + 1);
    for (int tt = t0; tt < t0 + tc; ++tt) {
      if (!__syncthreads_or(slab(tb + 8 * tt, l, t))) continue;
      stage_rows(rows_s, rows, tt, k);
      for (int r = 0; r < k; ++r) {
        const float* c = rows_s + 12 * r;
        float ti, bi0, bi1;
        bool hit = watertight9(l.sh, l.o, t, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ti, bi0, bi1);
        float pid = c[10];
        // pid < 0 marks padding rows, masked by id and not by area.
        if (hit && ti < t && pid >= 0.0f) {
          t = ti;
          prim = (int)pid;
          b0 = bi0;
          b1 = bi1;
        }
      }
    }
  }
  if (valid) {
    t_out[i] = t;
    prim_out[i] = prim;
    b0_out[i] = b0;
    b1_out[i] = b1;
  }
}

__global__ void __launch_bounds__(BLOCK)
    treelet_any_kernel(const float* __restrict__ sb, const int* __restrict__ sr, const float* __restrict__ tb,
                       const float* __restrict__ rows, int n_supers, int k, const float* __restrict__ o,
                       const float* __restrict__ d, const float* __restrict__ tmax, const int* __restrict__ skip,
                       int n, uint8_t* __restrict__ occ_out) {
  extern __shared__ float rows_s[];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;
  const Lane l = load_lane(o, d, i, valid);
  const float t_max = valid ? tmax[i] : 0.0f;
  const float skip_f = (float)(valid ? skip[i] : -2);
  bool occ = false;

  for (int s = 0; s < n_supers; ++s) {
    // Leave once every lane of the block is occluded (not_done, :178).
    if (!__syncthreads_or(!occ)) break;
    if (!__syncthreads_or(slab(sb + 8 * s, l, t_max))) continue;
    const int t0 = __ldg(sr + 2 * s), tc = __ldg(sr + 2 * s + 1);
    for (int tt = t0; tt < t0 + tc; ++tt) {
      if (!__syncthreads_or(!occ)) break;
      if (!__syncthreads_or(slab(tb + 8 * tt, l, t_max))) continue;
      stage_rows(rows_s, rows, tt, k);
      for (int r = 0; r < k; ++r) {
        const float* c = rows_s + 12 * r;
        float ti, bi0, bi1;
        bool hit =
            watertight9(l.sh, l.o, t_max, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ti, bi0, bi1);
        occ = occ || (hit && c[9] != skip_f && c[10] >= 0.0f);
      }
    }
  }
  if (valid) occ_out[i] = occ ? 1 : 0;
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_treelet_closest(int device, const float* sb, const int* sr, const float* tb, const float* rows,
                                  int n_supers, int leaf_size, const float* o, const float* d, const float* tmax,
                                  int n, float* t, int* prim, float* b0, float* b1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t shmem = (size_t)leaf_size * 12 * sizeof(float);
  treelet_closest_kernel<<<blocks_for(n), BLOCK, shmem, (cudaStream_t)stream>>>(sb, sr, tb, rows, n_supers,
                                                                                leaf_size, o, d, tmax, n, t, prim,
                                                                                b0, b1);
  return (int)cudaGetLastError();
}

extern "C" int yk_treelet_any(int device, const float* sb, const int* sr, const float* tb, const float* rows,
                              int n_supers, int leaf_size, const float* o, const float* d, const float* tmax,
                              const int* skip, int n, unsigned char* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t shmem = (size_t)leaf_size * 12 * sizeof(float);
  treelet_any_kernel<<<blocks_for(n), BLOCK, shmem, (cudaStream_t)stream>>>(sb, sr, tb, rows, n_supers, leaf_size,
                                                                            o, d, tmax, skip, n, occ);
  return (int)cudaGetLastError();
}
