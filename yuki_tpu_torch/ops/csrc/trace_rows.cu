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
// rows_any (the first port): per chunk, groups of 8 triangles from the
// chunk staged with scalar loads, each ORed into every lane's verdict
// (any_walk, yuki_tpu/ops/trace_stream.py:776-804); after each group the
// block leaves the chunk once no crossing lane is still unoccluded, so
// lanes that do not cross the chunk keep what the groups walked so far gave
// them.  A per-lane exit would not give the same bits.
//
// A row starts from (ts, prim, det) = (t_max, -1, 1), occlusion 0.
//
// What bounds them: ALU work, ~40 operations per live lane and real
// triangle of every walked chunk plus 24 per recheck; traffic is 28-32 B of
// ray in (32 B for the skip variant) and 12 B (4 B) out per ray, 4 B per
// list entry and 6 KB per walked chunk.
//
// Numerics: built with -fmad=false and without fast-math.  The recheck
// takes a plain 1 / d, as _recheck does (not _safe_inv), and the NaN-
// propagating jmin/jmax: an axis-parallel ray's 0 * inf = NaN fails the
// recheck as it does on the TPU.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int ROW = 128;  // rays per row (the TPU's lane count)

// _recheck (trace_rows.py:223-243): chunk box b (lo xyz, hi xyz of its [8]
// row) against the ray with inv = 1 / d and the running scaled best
// t = ts / det, the upper bound cross-multiplied.
__device__ __forceinline__ bool recheck(const float* __restrict__ b, V3 o, V3 inv, float ts, float det) {
  const float t0x = (__ldg(b + 0) - o.x) * inv.x;
  const float t1x = (__ldg(b + 3) - o.x) * inv.x;
  const float t0y = (__ldg(b + 1) - o.y) * inv.y;
  const float t1y = (__ldg(b + 4) - o.y) * inv.y;
  const float t0z = (__ldg(b + 2) - o.z) * inv.z;
  const float t1z = (__ldg(b + 5) - o.z) * inv.z;
  float tmin = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmin(t0z, t1z));
  const float tmax_box = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmax(t0z, t1z));
  tmin = jmax(tmin, 0.0f);
  return tmin <= tmax_box && tmin * det <= ts;
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

__global__ void __launch_bounds__(ROW)
    rows_any_kernel(const float* __restrict__ cb, const float* __restrict__ rows, int k,
                    const int* __restrict__ lists, int C, const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmax, const float* __restrict__ skip, int* __restrict__ occ_out) {
  extern __shared__ float tri_s[];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const RowRay r = load_ray(o, d, tmax, i);
  const Shear sh = make_shear(r.d);
  const float sk = skip[i];
  bool occ = false;
  const int* list = lists + (size_t)blockIdx.x * C;
  for (int j = 0; j < C; ++j) {
    const int tt = __ldg(list + j);
    if (tt < 0) break;
    const bool crossing = r.tm > 0.0f && recheck(cb + 8 * tt, r.o, r.inv, r.tm, 1.0f);
    if (!__syncthreads_or(crossing && !occ)) continue;
    stage_floats(tri_s, rows + (size_t)tt * k * 12, k * 12);
    __syncthreads();
    for (int g = 0; g < k; g += 8) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float* c = tri_s + 12 * (g + s);
        float ts, det;
        const bool ok = watertight_scaled(sh, r.o, c, ts, det);
        if (ok && ts <= r.tm * det && c[9] != sk && c[10] >= 0.0f) occ = true;
      }
      if (!__syncthreads_or(crossing && !occ)) break;
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
  rows_any_kernel<<<n_rows, ROW, (size_t)leaf_size * 12 * sizeof(float), (cudaStream_t)stream>>>(
      cb, rows, leaf_size, lists, C, o, d, tmax, skip, occ);
  return (int)cudaGetLastError();
}
