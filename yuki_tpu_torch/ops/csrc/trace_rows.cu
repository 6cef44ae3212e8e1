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
// revisits the row's out block from grid step to grid step.  Per chunk:
//
//   - every lane rechecks the chunk's box against its own running best
//     (_recheck); the TPU kernel walks the chunk with ALL 128 lanes as soon
//     as ANY lane's recheck passes, so the decision is __syncthreads_or of
//     the lanes' verdicts, and a lane that failed its own recheck still
//     tests the triangles (and may find a hit there);
//   - the chunk's k triangle rows (k x 12 floats, 6 KB at k = 128) are
//     staged in shared memory; the barrier of the decision orders the reuse
//     of the buffer, a second one its first reads;
//   - closest: closest_chunk (trace_stream.cuh), the slot walk's device
//     code, seeded from the running carry (ts, det, prim), t = ts / det;
//     rows_closest_kernel<true> (with_skip) never takes a triangle of the
//     lane's skip light (plane 7, an f32 light id; -2 matches none);
//   - occlusion: groups of 8 triangles, each ORed into every lane's verdict
//     (any_walk, yuki_tpu/ops/trace_stream.py:776-804); after each group
//     the block leaves the chunk once no crossing lane is still unoccluded,
//     so lanes that do not cross the chunk keep what the groups walked so
//     far gave them.  A per-lane exit would not give the same bits.
//
// A row starts from (ts, prim, det) = (t_max, -1, 1), occlusion 0.
//
// What bounds it: ALU work, ~40 operations per lane and triangle of every
// walked chunk plus 24 per recheck; traffic is 28-32 B of ray in (32 B for
// the skip variant) and 12 B (4 B) out per ray, 4 B per list entry and
// 6 KB per walked chunk.
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

// _recheck (trace_rows.py:223-243): chunk box b (lo 0-2, hi 3-5) against
// the ray with inv = 1 / d and the running scaled best t = ts / det, the
// upper bound cross-multiplied.
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
  extern __shared__ float tri_s[];
  const int i = blockIdx.x * ROW + threadIdx.x;
  const RowRay r = load_ray(o, d, tmax, i);
  const Shear sh = make_shear(r.d);
  const float sk = WITH_SKIP ? skip[i] : 0.0f;
  float ts = r.tm, det = 1.0f, prim = -1.0f;
  const int* list = lists + (size_t)blockIdx.x * C;
  for (int j = 0; j < C; ++j) {
    const int tt = __ldg(list + j);
    if (tt < 0) break;
    const bool near = r.tm > 0.0f && recheck(cb + 8 * tt, r.o, r.inv, ts, det);
    if (!__syncthreads_or(near)) continue;
    stage_floats(tri_s, rows + (size_t)tt * k * 12, k * 12);
    __syncthreads();
    closest_chunk<WITH_SKIP>(sh, r.o, tri_s, k, ts, det, prim, sk);
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
  const size_t shmem = (size_t)leaf_size * 12 * sizeof(float);
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
