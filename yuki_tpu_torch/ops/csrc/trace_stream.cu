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

// A staged copy of a chunk: k rows of three float4s, then one float4 of
// padding, so copy p + 1 starts 12k + 4 floats after copy p.
__host__ __device__ constexpr int copy_stride4(int k) { return 3 * k + 1; }

// The three float4s of a triangle row (p0 xyz p1x | p1yz p2xy | p2z light
// pid pad) with each vertex's coordinates reordered by PERM: 0 = (x, y,
// z), 1 = (y, z, x), 2 = (z, x, y), the order permx, permy, permz pick for
// a ray whose largest direction component is z, x or y.
template <int PERM>
__device__ __forceinline__ void permuted_row(const float4& a, const float4& b, const float4& c, float4* dst) {
  if (PERM == 0) {
    dst[0] = a;
    dst[1] = b;
    dst[2] = c;
  } else if (PERM == 1) {
    dst[0] = make_float4(a.y, a.z, a.x, b.x);
    dst[1] = make_float4(b.y, a.w, b.w, c.x);
    dst[2] = make_float4(b.z, c.y, c.z, c.w);
  } else {
    dst[0] = make_float4(a.z, a.x, a.y, b.y);
    dst[1] = make_float4(a.w, b.x, c.x, b.z);
    dst[2] = make_float4(b.w, c.y, c.z, c.w);
  }
}

// watertight_scaled on a row already in the ray's shear frame (corners
// p0' = a.xyz, p1' = (a.w, b.x, b.y), p2' = (b.z, b.w, c.x)) from the
// origin in the same frame: the same operations in the same order.
__device__ __forceinline__ bool watertight_framed(const Shear& s, V3 o, const float4& a, const float4& b,
                                                  const float4& c, float& ts, float& det) {
  float p0tx = a.x - o.x, p0ty = a.y - o.y, p0tz = a.z - o.z;
  float p1tx = a.w - o.x, p1ty = b.x - o.y, p1tz = b.y - o.z;
  float p2tx = b.z - o.x, p2ty = b.w - o.y, p2tz = c.x - o.z;
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

// Stage a slot row's chunk, by all threads of the block: thread r loads
// triangle row r with three 16-byte loads and writes it into the three
// copies (copy_stride4(k) float4s apart), permuted for the three shear
// frames.  Returns, to every thread, one past the chunk's last row with
// prim id >= 0 (0 when it has none).  The caller's block has ROW threads.
__device__ __forceinline__ int stage_framed(float4* tri4, int* last_w, const float* __restrict__ rows,
                                            const int* __restrict__ row_chunk, int k) {
  const float4* src = reinterpret_cast<const float4*>(rows) + (size_t)__ldg(row_chunk + blockIdx.x) * k * 3;
  const int stride = copy_stride4(k);
  int last = 0;
  for (int r = threadIdx.x; r < k; r += ROW) {
    const float4 a = __ldg(src + 3 * r), b = __ldg(src + 3 * r + 1), c = __ldg(src + 3 * r + 2);
    if (c.z >= 0.0f) last = r + 1;
    permuted_row<0>(a, b, c, tri4 + 3 * r);
    permuted_row<1>(a, b, c, tri4 + stride + 3 * r);
    permuted_row<2>(a, b, c, tri4 + 2 * stride + 3 * r);
  }
  last = __reduce_max_sync(FULL, last);
  if ((threadIdx.x & 31) == 0) last_w[threadIdx.x >> 5] = last;
  __syncthreads();
  return max(max(last_w[0], last_w[1]), max(last_w[2], last_w[3]));
}

// The staged copy in a ray's shear frame, and the ray's origin (r0.xyz of
// its stream row) in that frame.
__device__ __forceinline__ const float4* framed_copy(const float4* tri4, int k, const Shear& sh) {
  return tri4 + (sh.x_max ? copy_stride4(k) : (sh.y_max ? 2 * copy_stride4(k) : 0));
}
__device__ __forceinline__ V3 framed_origin(const Shear& sh, const float4& r0) {
  return v3(permx(sh, r0.x, r0.y, r0.z), permy(sh, r0.x, r0.y, r0.z), permz(sh, r0.x, r0.y, r0.z));
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
  const int last = stage_framed(tri4, last_w, rows, row_chunk, k);

  float ts = jmax(tm, 0.0f), det = 1.0f, prim = -1.0f;
  if (__any_sync(FULL, tm > 0.0f)) {
    const int n_walk = (last + 7) & ~7;
    const Shear sh = make_shear(v3(r0.w, r1.x, r1.y));
    const V3 o = framed_origin(sh, r0);
    const float4* tri = framed_copy(tri4, k, sh);
    const float sk = WITH_SKIP ? r1.w : 0.0f;
    float ts_b[8], det_b[8], prim_b[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      ts_b[s] = ts;
      det_b[s] = det;
      prim_b[s] = prim;
    }
    for (int g = 0; g < n_walk; g += 8) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float4* t = tri + 3 * (g + s);
        const float4 a = t[0], b = t[1], c = t[2];
        float ts_c, det_c;
        const bool ok = watertight_framed(sh, o, a, b, c, ts_c, det_c);
        if (ok && c.z >= 0.0f && ts_c * det_b[s] < ts_b[s] * det_c && (!WITH_SKIP || c.y != sk)) {
          ts_b[s] = ts_c;
          det_b[s] = det_c;
          prim_b[s] = c.z;
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
  const int last = stage_framed(tri4, last_w, rows, row_chunk, k);
  int occ = 0;
  if (tm > 0.0f) {  // a warp whose slots are all dead passes by together
    const Shear sh = make_shear(v3(r0.w, r1.x, r1.y));
    const V3 o = framed_origin(sh, r0);
    const float4* tri = framed_copy(tri4, k, sh);
    const float sk = r1.w;
#pragma unroll 4
    for (int r = 0; r < last; ++r) {
      const float4* t = tri + 3 * r;
      const float4 a = t[0], b = t[1], c = t[2];
      float ts, det;
      const bool ok = watertight_framed(sh, o, a, b, c, ts, det);
      if (ok && ts <= tm * det && c.y != sk && c.z >= 0.0f) {
        occ = 1;
        break;
      }
    }
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
