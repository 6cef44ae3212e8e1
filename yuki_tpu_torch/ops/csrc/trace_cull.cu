// Two-level exact cull for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/trace_cull.py's Pallas kernel.
//
//   yk_cull  replaces _cull_kernel (trace_cull.py:60)
//
// Design.  One thread per ray.  The level-1 word boxes (union of each 32
// chunks, pad lo = +inf, hi = -inf) and the chunk boxes are staged in
// shared memory (6 floats each: 35 KB for the colonnade's 1,454 chunks and
// 46 words), as the TPU kernel keeps its tables in VMEM.  A live ray
// (t_max > 0) tests every word box in ascending order; for each of its
// first S crossed words it tests the word's 32 chunks (ids past the last
// chunk are never set, as the TPU kernel masks them by id) and takes the
// crossing bits lowest first, the same order as the TPU kernel's C
// lowest-set-bit extractions over its S compacted words, until C ids are
// written.  The rest of the list is -1.  Overflow is (crossed words > S) |
// (crossed chunks in the first S words > C), as in the TPU kernel (:225).
// The TPU kernel's one-hot MXU gathers of the chunk bounds are exact
// 1.0 * value products, so plain shared-memory loads replace them.
//
// What bounds it: ALU work (W + 32 * crossed words slab tests per ray, 24
// operations each); traffic is 28 B of ray in and 4C + 1 B of list out.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    cull_kernel(const float* __restrict__ wb, int n_words, const float* __restrict__ cb, int n_c, int S, int C,
                const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax, int n,
                int* __restrict__ lists, uint8_t* __restrict__ ov) {
  extern __shared__ float boxes[];  // word boxes [n_words, 6], then chunk boxes [n_c, 6]
  float* word_s = boxes;
  float* chunk_s = boxes + 6 * n_words;
  stage_boxes(word_s, wb, n_words);
  stage_boxes(chunk_s, cb, n_c);
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int* out = lists + (size_t)i * C;
  const SlabRay r = slab_ray(o, d, tmax, i);
  int n_cw = 0;    // crossed words
  int count = 0;   // crossed chunks in the first S crossed words
  int written = 0;
  if (r.tm > 0.0f) {
    for (int w = 0; w < n_words; ++w) {
      if (!crosses(word_s + 6 * w, r)) continue;
      if (++n_cw > S) break;  // an overflow ray; its first S words are done
      const int c0 = 32 * w;
      const int m = min(32, n_c - c0);
      uint32_t bits = 0u;
      for (int j = 0; j < m; ++j)
        if (crosses(chunk_s + 6 * (c0 + j), r)) bits |= 1u << j;
      count += __popc(bits);
      for (; bits != 0u && written < C; bits &= bits - 1u) out[written++] = c0 + __ffs(bits) - 1;
    }
  }
  for (; written < C; ++written) out[written] = -1;
  ov[i] = (n_cw > S || count > C) ? 1 : 0;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_cull(int device, const float* wb, int n_words, const float* cb, int n_c, int S, int C,
                       const float* o, const float* d, const float* tmax, int n, int* lists, unsigned char* ov,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t shmem = (size_t)(n_words + n_c) * 6 * sizeof(float);
  err = allow_shared((const void*)cull_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  cull_kernel<<<(n + THREADS - 1) / THREADS, THREADS, shmem, (cudaStream_t)stream>>>(wb, n_words, cb, n_c, S, C, o,
                                                                                     d, tmax, n, lists, ov);
  return (int)cudaGetLastError();
}
