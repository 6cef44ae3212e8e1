// Device code shared by the treelet walks (trace_treelets.cu) and the
// block-pair walks (trace_pairs.cu): one thread per ray in 1024-thread
// blocks, the slab test of a box against each lane's own t, and the staging
// of a treelet's rows.  Compiled with -fmad=false, like path_fused.cuh.
#pragma once

#include <cuda_runtime.h>

#include "path_fused.cuh"

namespace yk {

constexpr int BLOCK = 1024;  // rays per block (yuki_tpu BLOCK_ROWS = 8 rows of 128)

// A lane's ray: origin, direction, plain reciprocal (1 / d, as the TPU
// kernels take it) and the watertight test's shear.
struct Lane {
  V3 o, d, inv;
  Shear sh;
};

__device__ __forceinline__ Lane make_lane(V3 o, V3 d) {
  Lane l;
  l.o = o;
  l.d = d;
  l.inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  l.sh = make_shear(d);
  return l;
}

// _slab_any's per-lane verdict (trace_treelets.py:34-52; trace_pairs.py's
// _recheck, :154-172, is the same test) for one box row (lo 0-2, hi 3-5),
// read by every lane of the block.
__device__ __forceinline__ bool slab(const float* __restrict__ box, const Lane& l, float t_cur) {
  float t0x = (__ldg(box + 0) - l.o.x) * l.inv.x;
  float t1x = (__ldg(box + 3) - l.o.x) * l.inv.x;
  float t0y = (__ldg(box + 1) - l.o.y) * l.inv.y;
  float t1y = (__ldg(box + 4) - l.o.y) * l.inv.y;
  float t0z = (__ldg(box + 2) - l.o.z) * l.inv.z;
  float t1z = (__ldg(box + 5) - l.o.z) * l.inv.z;
  float tmin = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)), jmin(t0z, t1z));
  float tmax = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)), jmax(t0z, t1z));
  return jmax(tmin, 0.0f) <= jmin(tmax, t_cur);
}

// Stage treelet tt's K rows ([K,12] floats) into shared memory.  The
// caller's __syncthreads_or has already passed: no lane still reads the
// previous treelet's rows.
__device__ __forceinline__ void stage_rows(float* rows_s, const float* __restrict__ rows, int tt, int k) {
  const float* src = rows + (size_t)tt * k * 12;
  for (int j = threadIdx.x; j < k * 12; j += BLOCK) rows_s[j] = __ldg(src + j);
  __syncthreads();
}

}  // namespace yk
