// Two-level exact cull for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/trace_cull.py's Pallas kernel.
//
//   yk_cull  replaces _cull_kernel (trace_cull.py:60): the redesign for
//            the card of its first port (PERF.md §6 records the change
//            and its measurements)
//
// It computes what the TPU kernel computes: each ray's list of the chunks
// its slab crosses, ascending, -1 pad; level 1 tests the union box of every
// 32-chunk word (pad lo = +inf, hi = -inf), level 2 the 32 chunks of each
// of the ray's first S crossed words (ids past the last chunk are masked by
// id, as the TPU kernel masks them), and the list is the first C crossed
// chunks.  Overflow is (crossed words > S) | (crossed chunks in the first S
// words > C), as in the TPU kernel (:225).  The TPU kernel's one-hot MXU
// gathers of the chunk bounds are exact 1.0 * value products, so plain
// shared-memory loads replace them.
//
// What bounds it on this card: slab tests (24 operations each) issued by the
// SMs; traffic is 28 B of ray in and 4C + 1 B of list out.  The first port
// ran one thread per ray through both levels, so the level-2 loop over a
// word's 32 chunks ran for the whole warp whenever any of its 32 rays
// crossed that word: on incoherent waves a warp paid 32 tests for each word
// of the union of its rays' crossed words (each ray crosses about 5), and
// appended ids with divergent scalar stores.
//
// Design.
// - Tables in shared memory as structure of arrays, staged once per block
//   of a persistent grid: word boxes [6][W], chunk boxes [6][32 W].  Lane j
//   reading chunk 32w + j hits bank j, so the loads are conflict-free.
// - Level 1, one thread per ray: the loop over the word boxes is uniform and
//   reads broadcast values.  The ray's first S crossed word ids go to its
//   warp's slots in shared memory; the count stops at S + 1.
// - Level 2, one lane per chunk: the warp walks its 32 rays in lane order,
//   and each ray's crossed words in ascending order.  The ray arrives by
//   __shfl_sync, lane j tests chunk 32w + j, and __ballot_sync gives the
//   word's 32 crossing bits (the TPU kernel's own layout: chunks on
//   sublanes, packed by a reduction).  Every lane does a real test at every
//   step: a warp's steps are the sum of its rays' crossed words, not 32
//   times their union.  A ray stops once its count passes C (it overflows,
//   and its list is full).
// - The slab folds use PTX's one-instruction NaN-propagating min and max
//   (min_nan, max_nan) in place of jmin/jmax: the same crossing bits.
// - Extraction: the set bits, lowest first, land in the warp's row buffer
//   at the ray's count so far + popc(bits below the lane) until C; then C
//   lanes store the row (-1 pad) as one coalesced 64-B store, and each lane
//   its own ray's overflow byte.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
size_t shared_bytes(int n_words, int S, int C) {
  return (size_t)(6 * n_words + 6 * 32 * n_words + WARPS * C) * 4 + (size_t)WARPS * S * 32 * 2;
}

__global__ void __launch_bounds__(THREADS)
    cull_kernel(const float* __restrict__ wb, int n_words, const float* __restrict__ cb, int n_c, int S, int C,
                const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax, int n,
                int* __restrict__ lists, uint8_t* __restrict__ ov) {
  extern __shared__ float smem[];
  const int n_slots = 32 * n_words;
  float* word_s = smem;                                     // [6][W]
  float* chunk_s = word_s + 6 * n_words;                    // [6][32 W]
  int* rows = (int*)(chunk_s + 6 * n_slots);                // [WARPS][C]
  uint16_t* wids = (uint16_t*)(rows + WARPS * C);           // [WARPS][S][32]
  stage_soa(word_s, wb, n_words, n_words);
  stage_soa(chunk_s, cb, n_c, n_slots);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = rows + warp * C;
  uint16_t* wid = wids + warp * S * 32;
  const int n_tiles = (n + 31) / 32;
  for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles; tile += gridDim.x * WARPS) {
    const int i = tile * 32 + lane;
    SlabRay r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (i < n) r = slab_ray(o, d, tmax, i);

    // Level 1: this lane's ray against every word box.
    int n_cw = 0;  // crossed words, stopped at S + 1
    if (r.tm > 0.0f) {
      for (int w = 0; w < n_words; ++w) {
        if (!crosses_soa(word_s, n_words, w, r)) continue;
        if (n_cw == S) {
          n_cw = S + 1;  // an overflow ray; its first S words are noted
          break;
        }
        wid[n_cw * 32 + lane] = (uint16_t)w;
        ++n_cw;
      }
    }
    __syncwarp();

    // Level 2: the warp's rays one by one, one lane per chunk.
    bool my_ov = n_cw > S;
    const int n_here = min(32, n - tile * 32);
    for (int q = 0; q < n_here; ++q) {
      const int nq = min(__shfl_sync(FULL, n_cw, q), S);
      const SlabRay rq = shfl_ray(r, q);
      int count = 0;  // crossed chunks in the ray's first S words
      for (int k = 0; k < nq && count <= C; ++k) {
        const int c = 32 * (int)wid[k * 32 + q] + lane;
        const bool hit = c < n_c && crosses_soa(chunk_s, n_slots, c, rq);
        const uint32_t bits = __ballot_sync(FULL, hit);
        const int pos = count + __popc(bits & ((1u << lane) - 1u));
        if (hit && pos < C) row[pos] = c;
        count += __popc(bits);
      }
      __syncwarp();
      const int written = min(count, C);
      int* out = lists + (size_t)(tile * 32 + q) * C;
      for (int j = lane; j < C; j += 32) out[j] = j < written ? row[j] : -1;
      __syncwarp();
      if (lane == q && count > C) my_ov = true;
    }
    if (i < n) ov[i] = my_ov ? 1 : 0;
  }
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_cull(int device, const float* wb, int n_words, const float* cb, int n_c, int S, int C,
                       const float* o, const float* d, const float* tmax, int n, int* lists, unsigned char* ov,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // A persistent grid: as many blocks as fit on the card at once (each
  // stages the tables once), none more than the wave needs.  When no block
  // fits, one is launched, and its refusal reports the error.
  const size_t shmem = shared_bytes(n_words, S, C);
  err = allow_shared((const void*)cull_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cull_kernel, THREADS, shmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = std::max(1, std::min((n + THREADS - 1) / THREADS, n_sm * per_sm));
  cull_kernel<<<blocks, THREADS, shmem, (cudaStream_t)stream>>>(wb, n_words, cb, n_c, S, C, o, d, tmax, n, lists,
                                                                ov);
  return (int)cudaGetLastError();
}
