// Slot-stream kernels for Hopper (sm_90a): the CUDA port of three Pallas
// kernels of yuki_tpu/ops/trace_stream.py.
//
//   yk_cross_words  replaces _cross_words_kernel (trace_stream.py:117)
//   yk_slot_closest replaces _closest_kernel (:812), with its with_skip
//                   variant
//   yk_slot_any     replaces _any_kernel (:850)
//
// cross_words: one thread per ray.  The word union boxes and the chunk
// boxes (6 floats each; 35 KB for the colonnade's 1,454 chunks) are staged
// in shared memory.  A ray tests each 32-chunk word's box and, where it
// crosses, the word's chunks; the word box holds every chunk box of its
// word, so a chunk crossing always sits in a crossed word and the words
// equal _cross_words_xla's bit for bit.  Bound: ALU (a ray makes W word
// tests plus 32 per crossed word, 24 operations each); the words it writes
// (4W bytes a ray) are the only traffic that scales.
//
// slot_closest / slot_any: one 128-thread block per slot row and one
// thread per slot, as the TPU kernel has one (1, 128) lane group per row.
// The row's chunk (128 triangle rows x 12 floats, 6 KB) is staged in
// shared memory; each thread reads its slot's ray (8 floats) from the
// packed stream.  A row with no live slot writes the TPU kernel's defaults
// (ts = t, prim -1, det 1; occlusion 0).  The closest walk keeps eight
// scaled (ts, det, prim) carries, triangle k to carry k % 8, exactly the
// TPU kernel's sublanes, and reduces them in _scaled_min8's halving order:
// the cross-multiplied compare is not transitive in floating point, so one
// carry would not give the same bits; slot_closest_kernel<true>
// (with_skip) never takes a triangle whose light id equals the slot's
// float 7 (-2 matches none).  The occlusion walk leaves a slot at
// its first occluder (OR is monotone; the TPU kernel leaves a row when all
// its live slots are occluded).  Bound: ALU, ~40 operations per slot and
// triangle; traffic is the 32 B ray and 12 B (4 B) result per slot plus
// 6 KB of triangles per row.
//
// Numerics: built with -fmad=false and without fast-math; slab min/max are
// NaN-propagating (jmin/jmax) as in jnp and torch.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int ROW = 128;  // slots per row (the TPU's lane count)
constexpr int CROSS_THREADS = 256;

__global__ void __launch_bounds__(CROSS_THREADS)
    cross_words_kernel(const float* __restrict__ wb, int n_words, const float* __restrict__ cb, int n_c,
                       const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                       int n, uint32_t* __restrict__ words) {
  extern __shared__ float boxes[];  // word boxes [n_words, 6], then chunk boxes [n_c, 6]
  float* word_s = boxes;
  float* chunk_s = boxes + 6 * n_words;
  stage_boxes(word_s, wb, n_words);
  stage_boxes(chunk_s, cb, n_c);
  __syncthreads();
  const int i = blockIdx.x * CROSS_THREADS + threadIdx.x;
  if (i >= n) return;
  const SlabRay r = slab_ray(o, d, tmax, i);
  const bool live = r.tm > 0.0f;
  for (int w = 0; w < n_words; ++w) {
    uint32_t bits = 0u;
    if (live && crosses(word_s + 6 * w, r)) {
      const int c0 = 32 * w;
      const int m = min(32, n_c - c0);
      for (int j = 0; j < m; ++j)
        if (crosses(chunk_s + 6 * (c0 + j), r)) bits |= 1u << j;
    }
    words[(size_t)i * n_words + w] = bits;
  }
}

// Stage the slot row's chunk: its k triangle rows, [k, 12] floats.
__device__ __forceinline__ void stage_chunk(float* tri_s, const float* __restrict__ rows,
                                            const int* __restrict__ row_chunk, int k) {
  stage_floats(tri_s, rows + (size_t)__ldg(row_chunk + blockIdx.x) * k * 12, k * 12);
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(ROW)
    slot_closest_kernel(const float* __restrict__ rows, int k, const int* __restrict__ row_chunk,
                        const float* __restrict__ stream, float* __restrict__ out, int n_slots) {
  extern __shared__ float tri_s[];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const float* ray = stream + (size_t)i * 8;
  const V3 o = v3(ray[0], ray[1], ray[2]);
  const V3 dr = v3(ray[3], ray[4], ray[5]);
  const float tm = ray[6];
  stage_chunk(tri_s, rows, row_chunk, k);
  // The barrier also orders the staged rows before their first read.
  if (!__syncthreads_or(tm > 0.0f)) {
    out[i] = tm;
    out[n_slots + i] = -1.0f;
    out[2 * n_slots + i] = 1.0f;
    return;
  }
  float ts = jmax(tm, 0.0f), det = 1.0f, prim = -1.0f;
  closest_chunk<WITH_SKIP>(make_shear(dr), o, tri_s, k, ts, det, prim, WITH_SKIP ? ray[7] : 0.0f);
  out[i] = ts;
  out[n_slots + i] = prim;
  out[2 * n_slots + i] = det;
}

__global__ void __launch_bounds__(ROW)
    slot_any_kernel(const float* __restrict__ rows, int k, const int* __restrict__ row_chunk,
                    const float* __restrict__ stream, int* __restrict__ occ_out) {
  extern __shared__ float tri_s[];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const float* ray = stream + (size_t)i * 8;
  const V3 o = v3(ray[0], ray[1], ray[2]);
  const V3 dr = v3(ray[3], ray[4], ray[5]);
  const float tm = ray[6];
  const float skip = ray[7];
  stage_chunk(tri_s, rows, row_chunk, k);
  __syncthreads();
  int occ = 0;
  if (tm > 0.0f) {
    const Shear sh = make_shear(dr);
    for (int r = 0; r < k; ++r) {
      const float* c = tri_s + 12 * r;
      float ts, det;
      const bool ok = watertight_scaled(sh, o, c, ts, det);
      if (ok && ts <= tm * det && c[9] != skip && c[10] >= 0.0f) {
        occ = 1;
        break;
      }
    }
  }
  occ_out[i] = occ;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_cross_words(int device, const float* wb, int n_words, const float* cb, int n_c, const float* o,
                              const float* d, const float* tmax, int n, unsigned* words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t shmem = (size_t)(n_words + n_c) * 6 * sizeof(float);
  err = allow_shared((const void*)cross_words_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  cross_words_kernel<<<(n + CROSS_THREADS - 1) / CROSS_THREADS, CROSS_THREADS, shmem, (cudaStream_t)stream>>>(
      wb, n_words, cb, n_c, o, d, tmax, n, words);
  return (int)cudaGetLastError();
}

extern "C" int yk_slot_closest(int device, const float* rows, int leaf_size, const int* row_chunk, int n_rows,
                               const float* stream_in, int with_skip, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)leaf_size * 12 * sizeof(float);
  if (with_skip)
    slot_closest_kernel<true><<<n_rows, ROW, shmem, (cudaStream_t)stream>>>(rows, leaf_size, row_chunk, stream_in,
                                                                            out, n_rows * ROW);
  else
    slot_closest_kernel<false><<<n_rows, ROW, shmem, (cudaStream_t)stream>>>(rows, leaf_size, row_chunk, stream_in,
                                                                             out, n_rows * ROW);
  return (int)cudaGetLastError();
}

extern "C" int yk_slot_any(int device, const float* rows, int leaf_size, const int* row_chunk, int n_rows,
                           const float* stream_in, int* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  slot_any_kernel<<<n_rows, ROW, (size_t)leaf_size * 12 * sizeof(float), (cudaStream_t)stream>>>(
      rows, leaf_size, row_chunk, stream_in, occ);
  return (int)cudaGetLastError();
}
