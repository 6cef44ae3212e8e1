// Slot-stream kernels for Hopper (sm_90a): the CUDA port of three Pallas
// kernels of yuki_tpu/ops/trace_stream.py.
//
//   yk_cross_words  replaces _cross_words_kernel (trace_stream.py:117)
//   yk_slot_closest replaces _closest_kernel (:812), with its with_skip
//                   variant
//   yk_slot_any     replaces _any_kernel (:850)
//
// cross_words (redesigned for the card; PERF.md §6 records the change and
// its measurements): one warp per ray, one lane per box.  The first port
// ran one thread per ray, so a warp ran the loop over a word's 32 chunks
// whenever any of its 32 rays crossed that word: on incoherent waves it
// paid 32 tests for each word of the union of its rays' crossed words, and
// a small wave (the cull's overflow rays) filled few SMs with long serial
// chains.  Now lane w tests word box 32p + w (passes p = 0, 1, ... over
// the W words) and __ballot_sync gives the ray's crossed words; for each,
// in ascending order, lane j tests chunk 32w + j, and the ballot is the
// word, kept by lane w % 32, which stores the pass's words as one
// coalesced store, zero-extended to the 64-bit words the wrapper returns
// (no conversion pass after the kernel).  A warp's steps are ceil(W / 32) plus the ray's own
// crossed words.  The grid holds as many blocks as fit on the card (a
// warp takes rays in turn) and no more than one warp a ray.  Tables: word
// boxes [6][W] and chunk boxes [6][32 W] as structure of arrays (lane j
// reads bank j), built once per chunk structure by the wrapper and read
// through L1 (36 KB for the colonnade): no per-block staging.  Pad chunks
// are lo = hi = +inf boxes, tested like real ones as _cross_words_xla and
// the TPU kernel test them (a ray with t_max = +inf and no negative
// direction component crosses them).  The word box holds every chunk box
// of its word, pads included, so a chunk crossing always sits in a crossed
// word and the words equal _cross_words_xla's bit for bit.  The slab folds
// use PTX's one-instruction NaN-propagating min and max (min_nan,
// max_nan): the same crossing bits as jmin/jmax.  Bound: ALU (W word
// tests a live ray plus 32 per crossed word, 24 operations each); the
// words it writes (8W bytes a ray) are the only traffic that scales.
//
// The framed-copy helpers of both slot walks (stage_framed, framed_copy,
// framed_origin, watertight_framed, closest_framed) are in
// trace_stream.cuh, shared with the row-union closest walk.
//
// slot_closest (redesigned for the card): one 128-thread block per slot
// row and one thread per slot, as the TPU kernel has one (1, 128) lane
// group per row.  The first port staged the row's whole chunk (k rows of
// 12 floats) with scalar loads and walked all k rows for every slot.  Now:
// - a row with no live slot (t > 0) writes the TPU kernel's defaults (ts =
//   t, prim -1, det 1) before it stages anything (__syncthreads_or);
// - thread r stages triangle row r with three 16-byte loads, as three
//   copies whose vertex coordinates are permuted for a ray whose largest
//   direction component is z, x or y (the watertight test's shear frame),
//   so a slot reads its copy and makes no per-triangle selects;
//   permx(c - o) = permx(c) - permx(o), so the bits are the same.  The
//   copies lie 12k + 4 floats apart, so one row's 16-byte loads from the
//   three copies fall in disjoint banks;
// - the walk stops at the chunk's last row with prim id >= 0, found while
//   staging (a warp max, then the block's), rounded up to 8 so that
//   triangle r still goes to carry r % 8; padding rows can never be taken,
//   so the bits are the same, and a chunk whose padding is not a tail is
//   still walked whole;
// - a warp whose 32 slots are all dead writes (max(t, 0), -1, 1), what the
//   walk gives a dead slot of a live row, and skips the walk (__any_sync).
// A block's stage overlaps the walks of the other blocks resident on its
// SM.  The walk keeps eight scaled (ts, det, prim) carries, triangle r to
// carry r % 8, exactly the TPU kernel's sublanes, and reduces them in
// _scaled_min8's halving order: the cross-multiplied compare is not
// transitive in floating point, so one carry would not give the same bits;
// slot_closest_kernel<true> (with_skip) never takes a triangle whose light
// id equals the slot's float 7 (-2 matches none).  Bound: ALU, ~40
// operations per live slot and real triangle; traffic is the 32 B ray and
// 12 B result per slot plus 6 KB of triangles per row.
//
// slot_any (redesigned for the card the same way): one 128-thread block
// per slot row and one thread per slot.  The first port staged the chunk
// with scalar loads (also for rows with no live slot), walked all k rows
// for every unoccluded slot and made the 18 coordinate selects of the
// shear frame in every test.  Now a row with no live slot writes
// occlusion 0 before it stages anything; the chunk is staged as
// slot_closest stages it (three copies permuted for the shear frames,
// 16-byte loads), and a slot walks its copy only to the chunk's last real
// row, leaving at its first occluder (OR is monotone: the TPU kernel
// leaves a row when all its live slots are occluded).  Occlusion keeps no
// carries, so the walk needs no rounding to 8; a padding row between real
// rows stays a no-op through the prim id test.  Dead slots skip the walk,
// and with them warps whose slots are all dead.  The hit predicate is the
// first port's: ok, ts <= t * det, light id != the slot's skip id, prim
// id >= 0.  The walk is unrolled by 4 (left to itself, ptxas held the
// kernel to 40 registers and spilled 12 bytes).  Bound: ALU, ~39
// operations per slot and real triangle up to its first occluder; traffic
// is the 32 B ray and 4 B result per slot plus 6 KB of triangles per row.
//
// Numerics: built with -fmad=false and without fast-math.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int ROW = 128;  // slots per row (the TPU's lane count)
constexpr int CROSS_THREADS = 256;
constexpr int CROSS_WARPS = CROSS_THREADS / 32;

// wsoa: word boxes [6][n_words]; csoa: chunk boxes [6][32 n_words], pad
// chunks lo = hi = +inf; words: [n, n_words], each u32 word zero-extended
// to 64 bits (the wrapper's int64 result).
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_words_kernel(const float* __restrict__ wsoa, const float* __restrict__ csoa, int n_words,
                       const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                       int n, uint64_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = 32 * n_words;
  for (int i = blockIdx.x * CROSS_WARPS + (threadIdx.x >> 5); i < n; i += gridDim.x * CROSS_WARPS) {
    const SlabRay r = slab_ray(o, d, tmax, i);
    const bool live = r.tm > 0.0f;
    uint64_t* out = words + (size_t)i * n_words;
    for (int base = 0; base < n_words; base += 32) {
      const int w = base + lane;
      uint32_t crossed = __ballot_sync(FULL, live && w < n_words && crosses_soa(wsoa, n_words, w, r));
      uint32_t mine = 0u;
      while (crossed) {
        const int b = __ffs(crossed) - 1;
        crossed &= crossed - 1u;
        const uint32_t bits = __ballot_sync(FULL, crosses_soa(csoa, n_chunks, 32 * (base + b) + lane, r));
        if (lane == b) mine = bits;
      }
      if (w < n_words) out[w] = mine;
    }
  }
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(ROW)
    slot_closest_kernel(const float* __restrict__ rows, int k, const int* __restrict__ row_chunk,
                        const float* __restrict__ stream, float* __restrict__ out, int n_slots) {
  extern __shared__ float4 tri4[];  // three permuted copies of the chunk
  __shared__ int last_w[ROW / 32];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const float4* ray = reinterpret_cast<const float4*>(stream) + (size_t)i * 2;
  const float4 r0 = __ldg(ray), r1 = __ldg(ray + 1);
  const float tm = r1.z;
  if (!__syncthreads_or(tm > 0.0f)) {
    out[i] = tm;
    out[n_slots + i] = -1.0f;
    out[2 * n_slots + i] = 1.0f;
    return;
  }
  const int last = stage_framed<ROW>(tri4, last_w, rows, __ldg(row_chunk + blockIdx.x), k, 7);

  float ts = jmax(tm, 0.0f), det = 1.0f, prim = -1.0f;
  if (__any_sync(FULL, tm > 0.0f)) {
    const Shear sh = make_shear(v3(r0.w, r1.x, r1.y));
    closest_framed<WITH_SKIP>(sh, framed_origin(sh, r0.x, r0.y, r0.z), framed_copy(tri4, k, sh),
                              (last + 7) & ~7, ts, det, prim, WITH_SKIP ? r1.w : 0.0f);
  }
  out[i] = ts;
  out[n_slots + i] = prim;
  out[2 * n_slots + i] = det;
}

__global__ void __launch_bounds__(ROW)
    slot_any_kernel(const float* __restrict__ rows, int k, const int* __restrict__ row_chunk,
                    const float* __restrict__ stream, int* __restrict__ occ_out) {
  extern __shared__ float4 tri4[];  // three permuted copies of the chunk
  __shared__ int last_w[ROW / 32];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const float4* ray = reinterpret_cast<const float4*>(stream) + (size_t)i * 2;
  const float4 r0 = __ldg(ray), r1 = __ldg(ray + 1);
  const float tm = r1.z;
  if (!__syncthreads_or(tm > 0.0f)) {
    occ_out[i] = 0;
    return;
  }
  const int last = stage_framed<ROW>(tri4, last_w, rows, __ldg(row_chunk + blockIdx.x), k, 7);
  int occ = 0;
  if (tm > 0.0f) {  // a warp whose slots are all dead passes by together
    const Shear sh = make_shear(v3(r0.w, r1.x, r1.y));
    occ = first_occluder(sh, framed_origin(sh, r0.x, r0.y, r0.z), framed_copy(tri4, k, sh), last, tm, r1.w) < last;
  }
  occ_out[i] = occ;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_cross_words(int device, const float* wsoa, const float* csoa, int n_words, const float* o,
                              const float* d, const float* tmax, int n, unsigned long long* words, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // As many blocks as fit on the card at once, none more than one warp a
  // ray needs.
  int n_sm = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cross_words_kernel, CROSS_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int blocks = std::max(1, std::min((n + CROSS_WARPS - 1) / CROSS_WARPS, n_sm * per_sm));
  cross_words_kernel<<<blocks, CROSS_THREADS, 0, (cudaStream_t)stream>>>(wsoa, csoa, n_words, o, d, tmax, n,
                                                                       (uint64_t*)words);
  return (int)cudaGetLastError();
}

extern "C" int yk_slot_closest(int device, const float* rows, int leaf_size, const int* row_chunk, int n_rows,
                               const float* stream_in, int with_skip, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)3 * copy_stride4(leaf_size) * sizeof(float4);
  const void* kernel = with_skip ? (const void*)slot_closest_kernel<true> : (const void*)slot_closest_kernel<false>;
  err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
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
  const size_t shmem = (size_t)3 * copy_stride4(leaf_size) * sizeof(float4);
  err = allow_shared((const void*)slot_any_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  slot_any_kernel<<<n_rows, ROW, shmem, (cudaStream_t)stream>>>(rows, leaf_size, row_chunk, stream_in, occ);
  return (int)cudaGetLastError();
}
