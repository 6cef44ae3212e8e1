// Row-union walks for Hopper (sm_90a): the CUDA port of the two Pallas
// kernels of yuki_tpu/ops/trace_rows.py, the treelet dispatch's engine for
// coherent waves.
//
//   yk_rows_closest  replaces _rows_closest_kernel (trace_rows.py:246); given
//                    a skip plane, its with_skip variant
//   yk_rows_any      replaces _rows_any_kernel (:299)
//
// Design.  One 128-thread block per 128-ray row, the rays in their natural
// order, one thread per ray.  The block walks its row's candidate list
// (ascending chunk ids, -1 ends it; the wrapper has already cut it to the
// pairs the TPU's pair budget keeps) in order, and each thread keeps its
// ray's running result in registers across the list, where the TPU kernel
// revisits the row's out block from grid step to grid step.  Per chunk,
// every lane rechecks the chunk's box against its own running best
// (_recheck); the TPU kernel walks the chunk with ALL 128 lanes as soon as
// ANY lane's recheck passes, so the decision is __syncthreads_or of the
// lanes' verdicts, and a lane that failed its own recheck still tests the
// triangles (and may find a hit there).  The decisions are the TPU
// kernel's: each entry in list order, from the running best.
//
// rows_closest (redesigned for the card; PERF.md §6 records the change and
// its measurements).  The first port staged each walked chunk with scalar
// loads, walked all k rows for every lane through the slot walk's device
// code, with the 18 coordinate selects of the shear frame in every test.
// Now, as the closest slot walk (trace_stream.cu) does:
// - a walked chunk is staged as copies permuted for the shear frames the
//   row's lanes need (found once, block_frames), with
//   16-byte loads (stage_framed, framed_store in trace_stream.cuh), and a
//   lane tests its frame's copy from its origin in that frame, with no
//   selects: permx(c - o) = permx(c) - permx(o), so the bits are the same;
// - the walk stops at the chunk's last row with prim id >= 0, found while
//   staging, rounded up to 8 so that triangle r still goes to carry r % 8
//   (closest_framed); padding rows can never be taken, and a chunk whose
//   padding is not a tail is walked to its last real row;
// - a warp whose 32 lanes all have t_max <= 0 or NaN skips the walks: such
//   a lane never takes a hit (its scaled compare is false), so its result
//   stays (t_max, -1, 1).
// Each entry is still rechecked with six scalar loads of its box, and a
// block's stage overlaps only the walks of the other blocks on its SM:
// staging the list and boxes in shared memory and a cp.async copy of the
// next listed chunk while the walk runs measured no gain (PERF.md §6).
// rows_closest_kernel<true> (with_skip) never takes a triangle of the
// lane's skip light (plane 7, an f32 light id; -2 matches none).
//
// rows_any (redesigned for the card as rows_closest was; PERF.md §6).  The
// decisions are still any_walk's (yuki_tpu/ops/trace_stream.py:776-804):
// per chunk, groups of 8 triangles are ORed into every lane's verdict, and
// the row leaves the chunk after the first group at which no lane that
// crosses the chunk is still unoccluded, so a lane that does not cross it
// keeps what the groups walked so far gave it.  That exit has a closed
// form, because OR is monotone.  Let S be the lanes that cross the chunk
// and are unoccluded when the row enters it.  The row leaves after group
// G, the largest over S of the group that holds a lane's first occluder
// (the last group where some lane of S has none); every other live,
// unoccluded lane is occluded if and only if its own first occluder lies
// in groups 0..G.  A lane with t_max <= 0 or NaN is never occluded
// (watertight_framed gives ts > 0 and det > 0, so ts <= t_max * det is
// false), so it walks nothing.  Per chunk:
// - a row with no live lane writes its zeros at once; else the row
//   rechecks its list WINDOW = 32 entries at a time: the entries and their
//   boxes go to shared memory, each lane rechecks every entry of the
//   window against its t_max (which the walk does not change, so the
//   rechecks need not wait for the walks) into a bit mask, and one block
//   OR of the masks leaves the entries that some lane crosses.  The first
//   port paid a dependent list load, box load and barrier per entry, and on
//   the forced shadow wave its rows walk 1 in 110 of their entries;
// - per entry some lane crosses, in list order: a row whose S is empty
//   leaves the chunk before it stages anything (one __syncthreads_or);
// - the chunk is staged as framed copies for the live lanes' frames
//   (block_frames, once) with 16-byte loads, keeping its last real row;
// - every live, unoccluded lane walks its frame's copy up to its first
//   occluder or the last real row, four rows unrolled, with no selects;
//   a warp with no such lane passes by together;
// - one block reduction (block_max) gives G, and a lane keeps its verdict
//   only where its first occluder lies in groups 0..G.
// Three barriers a walked chunk and two a window, where the first port
// paid one an entry and one for every 8 rows walked.  The rechecks' folds
// are one instruction each (recheck6), which the window's 32 rechecks a
// lane made the larger cost.  Walking S first, then the other lanes up to 8
// (G + 1) rows, gives the same bits and measured slower (PERF.md §6).
//
// A row starts from (ts, prim, det) = (t_max, -1, 1), occlusion 0.
//
// What bounds them: ALU work, ~40 operations per live lane and real
// triangle of every walked chunk (rows_any: up to the lane's first
// occluder) plus 24 per recheck; traffic is 28-32 B of
// ray in (32 B for the skip variant) and 12 B (4 B) out per ray, 4 B per
// list entry and 6 KB per walked chunk.
//
// Numerics: built with -fmad=false and without fast-math.  The recheck
// takes a plain 1 / d, as _recheck does (not _safe_inv), and NaN-
// propagating folds: an axis-parallel ray's 0 * inf = NaN fails the
// recheck as it does on the TPU.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int ROW = 128;  // rays per row (the TPU's lane count)

// _recheck (trace_rows.py:223-243): a chunk box (lo xyz, hi xyz) against
// the ray with inv = 1 / d and the running scaled best t = ts / det, the
// upper bound cross-multiplied.  The folds are PTX's one-instruction
// NaN-propagating min and max (trace_stream.cuh): on numbers they give
// jmin's and jmax's values, up to the sign of a zero, and a NaN for a NaN;
// the result feeds only compares, which a zero's sign does not change and
// any NaN makes false, so every verdict is _recheck's.
__device__ __forceinline__ bool recheck6(float lx, float ly, float lz, float hx, float hy, float hz, V3 o, V3 inv,
                                         float ts, float det) {
  const float t0x = (lx - o.x) * inv.x;
  const float t1x = (hx - o.x) * inv.x;
  const float t0y = (ly - o.y) * inv.y;
  const float t1y = (hy - o.y) * inv.y;
  const float t0z = (lz - o.z) * inv.z;
  const float t1z = (hz - o.z) * inv.z;
  float tmin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
  const float tmax_box = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
  tmin = max_nan(tmin, 0.0f);
  return tmin <= tmax_box && tmin * det <= ts;
}

// The same for box b of the [C, 8] box table in device memory.
__device__ __forceinline__ bool recheck(const float* __restrict__ b, V3 o, V3 inv, float ts, float det) {
  return recheck6(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4), __ldg(b + 5), o, inv, ts,
                  det);
}

struct RowRay {
  V3 o, d, inv;
  float tm;
};

__device__ __forceinline__ RowRay load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                           const float* __restrict__ tmax, int i) {
  RowRay r;
  r.o = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  r.d = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  r.inv = v3(1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z);
  r.tm = tmax[i];
  return r;
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(ROW)
    rows_closest_kernel(const float* __restrict__ cb, const float* __restrict__ rows, int k,
                        const int* __restrict__ lists, int C, const float* __restrict__ o,
                        const float* __restrict__ d, const float* __restrict__ tmax, const float* __restrict__ skip,
                        float* __restrict__ out, int n) {
  extern __shared__ float4 tri4[];  // the walked chunk's framed copies, copy_stride4(k) float4s apart
  __shared__ int last_w[ROW / 32], frames_w[ROW / 32];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const RowRay r = load_ray(o, d, tmax, i);
  const Shear sh = make_shear(r.d);
  const V3 of = framed_origin(sh, r.o.x, r.o.y, r.o.z);
  const float4* copy = framed_copy(tri4, k, sh);
  const bool warp_live = __any_sync(FULL, r.tm > 0.0f);
  const float sk = WITH_SKIP ? skip[i] : 0.0f;
  const int frames = block_frames<ROW>(frame_of(sh), frames_w);
  float ts = r.tm, det = 1.0f, prim = -1.0f;
  const int* list = lists + (size_t)blockIdx.x * C;
  for (int j = 0; j < C; ++j) {
    const int tt = __ldg(list + j);
    if (tt < 0) break;
    const bool near = r.tm > 0.0f && recheck(cb + 8 * tt, r.o, r.inv, ts, det);
    // The barrier also ends the last walk's reads of the copies.
    if (!__syncthreads_or(near)) continue;
    const int last = stage_framed<ROW>(tri4, last_w, rows, tt, k, frames);
    if (warp_live) closest_framed<WITH_SKIP>(sh, of, copy, (last + 7) & ~7, ts, det, prim, sk);
  }
  out[i] = ts;
  out[n + i] = prim;
  out[2 * n + i] = det;
}

constexpr int WINDOW = 32;  // list entries rechecked together

__global__ void __launch_bounds__(ROW)
    rows_any_kernel(const float* __restrict__ cb, const float* __restrict__ rows, int k,
                    const int* __restrict__ lists, int C, const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmax, const float* __restrict__ skip, int* __restrict__ occ_out) {
  extern __shared__ float4 tri4[];  // the walked chunk's framed copies, copy_stride4(k) float4s apart
  __shared__ int last_w[ROW / 32], frames_w[ROW / 32], group_w[ROW / 32], window_w[ROW / 32];
  __shared__ int tt_s[WINDOW];
  __shared__ float box_s[WINDOW * 6];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const RowRay r = load_ray(o, d, tmax, i);
  const Shear sh = make_shear(r.d);
  const V3 of = framed_origin(sh, r.o.x, r.o.y, r.o.z);
  const float4* copy = framed_copy(tri4, k, sh);
  const bool live = r.tm > 0.0f;
  const float sk = skip[i];
  const int frames = block_frames<ROW>(live ? frame_of(sh) : -1, frames_w);
  bool occ = false;
  if (frames != 0) {  // else no lane is live: none is occluded
    const int last_group = (k >> 3) - 1;
    const int* list = lists + (size_t)blockIdx.x * C;
    for (int base = 0; base < C; base += WINDOW) {
      // The window's entries and their boxes; the list ends at its first -1.
      if ((int)threadIdx.x < WINDOW) {
        const int tt = base + (int)threadIdx.x < C ? __ldg(list + base + threadIdx.x) : -1;
        tt_s[threadIdx.x] = tt;
        if (tt >= 0) {
#pragma unroll
          for (int c = 0; c < 6; ++c) box_s[6 * threadIdx.x + c] = __ldg(cb + 8 * tt + c);
        }
      }
      __syncthreads();
      int n_on = 0;
      while (n_on < WINDOW && tt_s[n_on] >= 0) ++n_on;
      // A lane's crossings (bit b: entry base + b) against its t_max, which
      // the walk does not change; the window's entries that any lane crosses.
      unsigned crossing = 0u;
      if (live) {
#pragma unroll 4
        for (int b = 0; b < n_on; ++b) {
          const float* x = box_s + 6 * b;
          if (recheck6(x[0], x[1], x[2], x[3], x[4], x[5], r.o, r.inv, r.tm, 1.0f)) crossing |= 1u << b;
        }
      }
      // The barrier also ends the reads of tt_s and box_s before the next
      // window's stage.
      const unsigned crossed = (unsigned)block_union<ROW>((int)crossing, window_w);
      for (unsigned rest = crossed; rest != 0u; rest &= rest - 1u) {
        const int b = __ffs((int)rest) - 1;
        const bool in_s = ((crossing >> b) & 1u) && !occ;
        // The barrier also ends the last walk's reads of the copies.
        if (!__syncthreads_or(in_s)) continue;
        const int last = stage_framed<ROW>(tri4, last_w, rows, tt_s[b], k, frames);
        int rf = last;
        if (live && !occ) rf = first_occluder(sh, of, copy, last, r.tm, sk);
        const int G = block_max<ROW>(in_s ? (rf < last ? rf >> 3 : last_group) : -1, group_w);
        occ = occ || (rf < last && (rf >> 3) <= G);
      }
      if (n_on < WINDOW) break;
    }
  }
  occ_out[i] = occ ? 1 : 0;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

// skip null: the plain walk; given: the with_skip variant.
extern "C" int yk_rows_closest(int device, const float* cb, const float* rows, int leaf_size, const int* lists,
                               int C, int n_rows, const float* o, const float* d, const float* tmax,
                               const float* skip, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)3 * copy_stride4(leaf_size) * sizeof(float4);
  const void* kernel =
      skip != nullptr ? (const void*)rows_closest_kernel<true> : (const void*)rows_closest_kernel<false>;
  err = allow_shared(kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  if (skip != nullptr)
    rows_closest_kernel<true><<<n_rows, ROW, shmem, (cudaStream_t)stream>>>(cb, rows, leaf_size, lists, C, o, d,
                                                                            tmax, skip, out, n_rows * ROW);
  else
    rows_closest_kernel<false><<<n_rows, ROW, shmem, (cudaStream_t)stream>>>(cb, rows, leaf_size, lists, C, o, d,
                                                                             tmax, skip, out, n_rows * ROW);
  return (int)cudaGetLastError();
}

extern "C" int yk_rows_any(int device, const float* cb, const float* rows, int leaf_size, const int* lists, int C,
                           int n_rows, const float* o, const float* d, const float* tmax, const float* skip,
                           int* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)3 * copy_stride4(leaf_size) * sizeof(float4);
  err = allow_shared((const void*)rows_any_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  rows_any_kernel<<<n_rows, ROW, shmem, (cudaStream_t)stream>>>(cb, rows, leaf_size, lists, C, o, d, tmax, skip,
                                                                occ);
  return (int)cudaGetLastError();
}
