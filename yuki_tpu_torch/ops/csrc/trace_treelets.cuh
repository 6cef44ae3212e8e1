// Device code shared by the treelet walks (trace_treelets.cu) and the
// block-pair walks (trace_pairs.cu): one thread per ray in 1024-thread
// blocks; a window of boxes staged in shared memory and voted on at once
// (the slab test of each box against each lane's own t, into a bit mask);
// a visited treelet staged as copies permuted for its block's shear
// frames, its last real row, and a lane's first blocking row.  Compiled
// with -fmad=false, like path_fused.cuh.
#pragma once

#include <cuda_runtime.h>

#include "path_fused.cuh"
#include "trace_stream.cuh"

namespace yk {

constexpr int BLOCK = 1024;  // rays per block (yuki_tpu BLOCK_ROWS = 8 rows of 128)
constexpr int WINDOW = 32;   // boxes voted together (one mask word)

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

// _slab_any's per-lane verdict (yuki_tpu/ops/trace_treelets.py:34-52;
// trace_pairs.py's _recheck, :154-172, is the same test) for a box staged
// as two float4s (lo xyz and hi x, hi yz), with PTX's one-instruction
// NaN-propagating min and max: jnp's and torch's verdicts, since any NaN
// (an axis-parallel ray's 0 * inf) fails the compare either way.
__device__ __forceinline__ bool vote(const float4* __restrict__ box, const Lane& l, float t_cur) {
  const float4 p = box[0], q = box[1];
  const float t0x = (p.x - l.o.x) * l.inv.x;
  const float t1x = (p.w - l.o.x) * l.inv.x;
  const float t0y = (p.y - l.o.y) * l.inv.y;
  const float t1y = (q.x - l.o.y) * l.inv.y;
  const float t0z = (p.z - l.o.z) * l.inv.z;
  const float t1z = (q.y - l.o.z) * l.inv.z;
  const float tmin = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
  const float tmax = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
  return max_nan(tmin, 0.0f) <= min_nan(tmax, t_cur);
}

// Row `row` of an [n, 8] box table into slot j of a staged window.
__device__ __forceinline__ void stage_box(float4* box_s, int j, const float* __restrict__ boxes, int row) {
  const float4* bx = reinterpret_cast<const float4*>(boxes) + 2 * row;
  box_s[2 * j] = __ldg(bx);
  box_s[2 * j + 1] = __ldg(bx + 1);
}

// A window of boxes into shared memory by the first n_on threads (the
// caller's barrier publishes them): rows base .. base + n_on - 1 of the
// [n, 8] table `boxes`; with `ids`, the rows ids[base .. base + n_on - 1],
// whose ids go to id_s.
__device__ __forceinline__ void stage_window(float4* box_s, const float* __restrict__ boxes, int base, int n_on) {
  if ((int)threadIdx.x < n_on) stage_box(box_s, threadIdx.x, boxes, base + threadIdx.x);
}
__device__ __forceinline__ void stage_window(int* id_s, float4* box_s, const int* __restrict__ ids,
                                             const float* __restrict__ boxes, int base, int n_on) {
  if ((int)threadIdx.x < n_on) {
    const int id = __ldg(ids + base + threadIdx.x);
    id_s[threadIdx.x] = id;
    stage_box(box_s, threadIdx.x, boxes, id);
  }
}

// A lane's window bits: bit j when its vote for box j passes at t_cur.
__device__ __forceinline__ unsigned window_votes(const float4* box_s, int n_on, const Lane& l, float t_cur) {
  unsigned bits = 0u;
#pragma unroll 4
  for (int j = 0; j < n_on; ++j)
    if (vote(box_s + 2 * j, l, t_cur)) bits |= 1u << j;
  return bits;
}

// Treelet tt's k rows into the copies `dst` of `frames`, thread r loading
// row r (no barrier).
__device__ __forceinline__ void stage_copies(float4* dst, const float* __restrict__ rows, int tt, int k, int frames) {
  const float4* src = reinterpret_cast<const float4*>(rows) + (size_t)tt * k * 3;
  for (int r = threadIdx.x; r < k; r += BLOCK) {
    const float4 a = __ldg(src + 3 * r), b = __ldg(src + 3 * r + 1), c = __ldg(src + 3 * r + 2);
    framed_store(dst, k, r, frames, a, b, c);
  }
}

// One past the last real row (prim id >= 0) of a staged copy `copy`, to
// every lane of the calling warp (all 32 lanes must call it, under a
// condition the warp shares): one ballot per 32 rows from the end.  The
// prim id sits in the third float4's z in every frame.
__device__ __forceinline__ int last_real_row(const float4* copy, int k) {
  const int lane = threadIdx.x & 31;
  for (int top = k; top > 0; top -= 32) {
    const int r = top - 32 + lane;
    const unsigned m = __ballot_sync(FULL, r >= 0 && copy[3 * r + 2].z >= 0.0f);
    if (m != 0u) return top - __clz((int)m);
  }
  return 0;
}

// A row of a framed copy from the lane's framed origin `of`: the nine
// corner coordinates watertight9 selects.
#define YK_FRAMED_CORNERS(a, b, c, of)                                                                      \
  (a).x - (of).x, (a).y - (of).y, (a).z - (of).z, (a).w - (of).x, (b).x - (of).y, (b).y - (of).z, (b).z - (of).x, \
      (b).w - (of).y, (c).x - (of).z

// The first row in [0, n) of the framed copy `tri` that blocks the lane
// (watertight9's hit within t_max, a light other than the skip id sk, a
// real row), or n; four rows unrolled.
__device__ __forceinline__ int first_blocker(const Shear& sh, V3 of, const float4* tri, int n, float tm, float sk) {
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const float4 a = tri[3 * r], b = tri[3 * r + 1], c = tri[3 * r + 2];
    if (sweep_hit(sh, YK_FRAMED_CORNERS(a, b, c, of), tm) && c.y != sk && c.z >= 0.0f) return r;
  }
  return n;
}

// Whether a lane can be blocked at all: t_max > 0 or NaN, or a shear or
// origin that is not finite (a zero direction: every test's det is NaN).
// A lane with t_max <= 0 and a finite shear and origin is never hit
// (short of edge products that overflow, corners beyond ~1e19).
__device__ __forceinline__ bool may_block(const Lane& l, V3 of, float t_max) {
  const float fin = of.x + of.y + of.z + l.sh.sx + l.sh.sy + l.sh.inv_dz;
  return !(t_max <= 0.0f) || !(fin - fin == 0.0f);
}

}  // namespace yk
