// Block-pair treelet walks for Hopper (sm_90a): the CUDA port of the two
// Pallas kernels of yuki_tpu/ops/trace_pairs.py.
//
//   yk_pairs_closest  replaces _pairs_kernel (trace_pairs.py:176)
//   yk_pairs_any      replaces _pairs_any_kernel (:219)
//
// Design.  One 1024-thread CUDA block per 1024-ray block of the TPU kernel
// and one thread per ray; the block walks its run of (block, treelet)
// pairs, runs[b] .. runs[b + 1] of the pair list, in order, in one launch
// (the TPU walks the list in CHUNK-pair launches and merges them; its
// result does not depend on that).  Blocks are launched longest run first
// (`order`, a permutation of the ray blocks), so that a long run does not
// start last and hold the wave; blocks are independent, so no bit moves.
// Rays come from the packed table of _pack_rays: plane p of the block's
// lane i at row 8 b + i / 128, column 128 p + i % 128, so neighbouring
// threads read neighbouring words; padding lanes carry the table's origin
// 0, direction 1, t_max 0, skip -2 and take part in the block's decisions
// as on the TPU, but are not written.
//
// The contract is a block's, not a ray's.  A block visits a pair's treelet
// when SOME lane's slab test of its box passes at that lane's running t
// (closest) or t_max (occlusion, unoccluded lanes only); padding lanes
// vote too.  Once it is visited EVERY lane tests its rows in order, also
// the lanes whose own slab fails (an axis-parallel ray's slab is NaN, so
// it finds its hits only in treelets that other lanes make the block
// visit).  Within that contract (redesigned for the card; PERF.md §6
// records the change and its measurements):
//
// - votes a window at a time: the window's WINDOW = 32 pairs and their
//   boxes go to shared memory, each lane tests every box of the window
//   into a bit mask, and one block OR gives the pairs some lane votes for.
//   A lane's t only falls (closest) and its occlusion only grows, and
//   max(tmin, 0) <= min(tmax, t) can only turn from true to false as t
//   falls (a NaN fails at any t), so a pair that no lane votes for now is
//   never visited later: it is passed over with no barrier, no stage and
//   no walk.  A pair of the mask is voted again at its turn (one
//   __syncthreads_or, which also publishes its stage), each lane from its
//   window bit unless it has taken a hit (closest) since the window was
//   voted; the occlusion vote is its crossing bit and the lane's occlusion;
// - stage ahead: the next pair of the mask is staged into the second of
//   two buffers while the current one is walked; a stage that its vote
//   then discards is harmless;
// - framed copies: a staged treelet is three copies permuted for the shear
//   frames its block's lanes use (block_frames, found once; framed_store
//   in trace_stream.cuh), and a lane tests its frame's copy from its origin
//   in that frame, with no selects: permx(c - o) = permx(c) - permx(o), so
//   the bits are the same;
// - the walk stops at the treelet's last real row (prim id >= 0), which
//   each warp finds from the staged copy with one ballot per 32 rows;
//   padding rows are never taken nor block;
// - closest: watertight9's operations in its order (sweep_take in
//   path_fused.cuh), the divide only for a test that passes its sign, det
//   and range tests, b0 and b1 only on a take; lanes with !(t > 0) never
//   take (the range test fails for t <= 0, and NaN fails ti < t), so they
//   skip the walk, and a warp of them skips it together;
// - occlusion: the block leaves a visited treelet after the first row r*
//   at which no lane that crosses its box is unoccluded, and lanes that do
//   not cross keep what rows 0..r* gave them.  Let S be the lanes that
//   cross and are unoccluded on entry and f_l lane l's first blocking row:
//   r* = max over S of f_l (every row if some lane of S has none), and a
//   lane outside S is occluded iff its first blocker lies in rows 0..r*.
//   So every unoccluded lane walks to its first blocker (sweep_hit, no
//   divide) or the last real row, one block maximum over S gives r*, and
//   a lane outside S keeps its blocker only if it is at most r*: two
//   barriers a visited treelet (vote, maximum) where the first port paid
//   one a row.  (Walking S first and the other lanes only up to r* gives
//   the same bits and measured slower, PERF.md §6.)  The blocking test is
//   watertight9's hit, whose range test is a miss test: with t_max NaN it
//   passes, so a NaN lane (which never crosses, and is never in S) is
//   occluded by a blocker in rows 0..r*.
//   A lane with t_max <= 0 and a finite shear and origin is never hit
//   (short of edge products that overflow, corners beyond ~1e19), so it
//   tests nothing; a block whose lanes are all occluded or such leaves its
//   list at once.
//
// What bounds it: ALU work, ~39 operations per live lane and real row of
// each visited treelet (occlusion: up to the lane's first blocker, or
// r*), 24 per vote; traffic is 32-36 B of ray in and 16 B (1 B) out per
// ray, 4 B and a 32 B box per pair and the 48 B rows of each staged
// treelet.
//
// Numerics: -fmad=false and no fast-math; the vote is vote() of
// trace_treelets.cuh, with PTX's one-instruction NaN-propagating min and
// max (the same verdicts: a NaN fails the compare either way).  The
// window stage and vote, the framed stage, the last real row and the
// first blocker are shared with the treelet walks there.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"
#include "trace_treelets.cuh"

using namespace yk;

namespace {

constexpr int ROWS = BLOCK / 128;  // rows of 128 lanes per ray block

// Plane p of this thread's lane in ray block b of a table `planes` planes
// wide.
__device__ __forceinline__ float plane(const float* __restrict__ packed, int planes, int b, int p) {
  const int row = b * ROWS + threadIdx.x / 128;
  return __ldg(packed + ((size_t)row * planes + p) * 128 + threadIdx.x % 128);
}

__device__ __forceinline__ Lane packed_lane(const float* __restrict__ packed, int planes, int b) {
  return make_lane(v3(plane(packed, planes, b, 0), plane(packed, planes, b, 1), plane(packed, planes, b, 2)),
                   v3(plane(packed, planes, b, 3), plane(packed, planes, b, 4), plane(packed, planes, b, 5)));
}

__global__ void __launch_bounds__(BLOCK)
    pairs_closest_kernel(const float* __restrict__ tb, const float* __restrict__ rows, int k,
                         const int* __restrict__ runs, const int* __restrict__ pair_treelet,
                         const int* __restrict__ order, const float* __restrict__ packed, int n,
                         float* __restrict__ t_out, int* __restrict__ prim_out, float* __restrict__ b0_out,
                         float* __restrict__ b1_out) {
  extern __shared__ float4 tri4[];  // two buffers of framed copies, 3 copy_stride4(k) float4s each
  __shared__ int frames_w[BLOCK / 32], mask_w[BLOCK / 32];
  __shared__ int tt_s[WINDOW];
  __shared__ float4 box_s[2 * WINDOW];
  const int b = __ldg(order + blockIdx.x);
  const Lane l = packed_lane(packed, 7, b);
  float t = plane(packed, 7, b, 6);
  const bool live = t > 0.0f;
  const V3 of = framed_origin(l.sh, l.o.x, l.o.y, l.o.z);
  const int frames = block_frames<BLOCK>(live ? frame_of(l.sh) : -1, frames_w);
  const int buf4 = 3 * copy_stride4(k);
  int prim = -1;
  float b0 = 0.0f, b1 = 0.0f;
  if (frames != 0) {  // else no lane can take a hit
    const bool warp_live = __any_sync(FULL, live);
    const int q1 = __ldg(runs + b + 1);
    for (int base = __ldg(runs + b); base < q1; base += WINDOW) {
      const int n_on = min(WINDOW, q1 - base);
      // No lane reads tt_s or box_s after the last window's final barrier.
      stage_window(tt_s, box_s, pair_treelet, tb, base, n_on);
      __syncthreads();
      const unsigned bits = window_votes(box_s, n_on, l, t);
      unsigned rest = (unsigned)block_union<BLOCK>((int)bits, mask_w);
      if (rest == 0u) continue;
      int j = __ffs((int)rest) - 1;
      rest &= rest - 1u;
      int buf = 0;
      bool took = false;  // since the window's vote
      stage_copies(tri4, rows, tt_s[j], k, frames);
      for (;;) {
        const bool v = took ? vote(box_s + 2 * j, l, t) : ((bits >> j) & 1u) != 0u;
        // Publishes pair j's stage; the last walk's reads of the other
        // buffer are done.
        const bool visit = __syncthreads_or(v);
        const int nj = rest != 0u ? __ffs((int)rest) - 1 : -1;
        rest &= rest - 1u;
        if (nj >= 0) stage_copies(tri4 + (buf ^ 1) * buf4, rows, tt_s[nj], k, frames);
        if (visit && warp_live) {
          const float4* staged = tri4 + buf * buf4;
          const int last = last_real_row(staged + (__ffs(frames) - 1) * copy_stride4(k), k);
          if (live) {
            const float4* copy = framed_copy(staged, k, l.sh);
#pragma unroll 4
            for (int r = 0; r < last; ++r) {
              const float4 a = copy[3 * r], bb = copy[3 * r + 1], c = copy[3 * r + 2];
              if (sweep_take(l.sh, YK_FRAMED_CORNERS(a, bb, c, of), c.z >= 0.0f, t, b0, b1)) {
                prim = (int)c.z;
                took = true;
              }
            }
          }
        }
        if (nj < 0) break;
        j = nj;
        buf ^= 1;
      }
    }
  }
  const int i = b * BLOCK + threadIdx.x;
  if (i < n) {
    t_out[i] = t;
    prim_out[i] = prim;
    b0_out[i] = b0;
    b1_out[i] = b1;
  }
}

__global__ void __launch_bounds__(BLOCK)
    pairs_any_kernel(const float* __restrict__ tb, const float* __restrict__ rows, int k,
                     const int* __restrict__ runs, const int* __restrict__ pair_treelet,
                     const int* __restrict__ order, const float* __restrict__ packed, int n,
                     bool* __restrict__ occ_out) {
  extern __shared__ float4 tri4[];  // two buffers of framed copies, 3 copy_stride4(k) float4s each
  __shared__ int frames_w[BLOCK / 32], mask_w[BLOCK / 32], max_w[BLOCK / 32];
  __shared__ int tt_s[WINDOW];
  __shared__ float4 box_s[2 * WINDOW];
  const int b = __ldg(order + blockIdx.x);
  const Lane l = packed_lane(packed, 8, b);
  const float t_max = plane(packed, 8, b, 6);
  const float skip = plane(packed, 8, b, 7);
  const V3 of = framed_origin(l.sh, l.o.x, l.o.y, l.o.z);
  const bool may = may_block(l, of, t_max);  // a row can block the lane
  const int frames = block_frames<BLOCK>(may ? frame_of(l.sh) : -1, frames_w);
  const int buf4 = 3 * copy_stride4(k);
  bool occ = false;
  if (frames != 0) {  // else no lane can be occluded
    const bool warp_may = __any_sync(FULL, may);
    const int q1 = __ldg(runs + b + 1);
    for (int base = __ldg(runs + b); base < q1; base += WINDOW) {
      const int n_on = min(WINDOW, q1 - base);
      // No lane reads tt_s or box_s after the last window's final barrier;
      // this one publishes them, and leaves the list once no lane can still
      // be occluded.
      stage_window(tt_s, box_s, pair_treelet, tb, base, n_on);
      if (!__syncthreads_or(may && !occ)) break;
      // Crossing at t_max, which the walk does not change.
      const unsigned bits = window_votes(box_s, n_on, l, t_max);
      unsigned rest = (unsigned)block_union<BLOCK>(occ ? 0 : (int)bits, mask_w);
      if (rest == 0u) continue;
      int j = __ffs((int)rest) - 1;
      rest &= rest - 1u;
      int buf = 0;
      stage_copies(tri4, rows, tt_s[j], k, frames);
      for (;;) {
        const bool in_s = ((bits >> j) & 1u) != 0u && !occ;
        // Publishes pair j's stage; the last walk's reads of the other
        // buffer are done.
        const bool visit = __syncthreads_or(in_s);
        const int nj = rest != 0u ? __ffs((int)rest) - 1 : -1;
        rest &= rest - 1u;
        if (nj >= 0) stage_copies(tri4 + (buf ^ 1) * buf4, rows, tt_s[nj], k, frames);
        if (visit) {
          // Every open lane walks to its first blocker (rf; k for none);
          // r* is the largest over S (k: some lane of S has none, so every
          // real row), and a lane outside S keeps its blocker if it lies
          // in rows 0..r*.
          int rf = k;
          if (warp_may) {  // the ballot needs the whole warp
            const float4* staged = tri4 + buf * buf4;
            const int last = last_real_row(staged + (__ffs(frames) - 1) * copy_stride4(k), k);
            if (may && !occ) {
              const int f = first_blocker(l.sh, of, framed_copy(staged, k, l.sh), last, t_max, skip);
              if (f < last) rf = f;
            }
          }
          const int r_star = block_max<BLOCK>(in_s ? rf : -1, max_w);
          occ = occ || (rf < k && rf <= r_star);
        }
        if (nj < 0) break;
        j = nj;
        buf ^= 1;
      }
    }
  }
  const int i = b * BLOCK + threadIdx.x;
  if (i < n) occ_out[i] = occ;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_pairs_closest(int device, const float* tb, const float* rows, int leaf_size, const int* runs,
                                const int* pair_treelet, const int* order, int n_blocks, const float* packed, int n,
                                float* t, int* prim, float* b0, float* b1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)2 * 3 * copy_stride4(leaf_size) * sizeof(float4);
  err = allow_shared((const void*)pairs_closest_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  pairs_closest_kernel<<<n_blocks, BLOCK, shmem, (cudaStream_t)stream>>>(tb, rows, leaf_size, runs, pair_treelet,
                                                                         order, packed, n, t, prim, b0, b1);
  return (int)cudaGetLastError();
}

extern "C" int yk_pairs_any(int device, const float* tb, const float* rows, int leaf_size, const int* runs,
                            const int* pair_treelet, const int* order, int n_blocks, const float* packed, int n,
                            bool* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = (size_t)2 * 3 * copy_stride4(leaf_size) * sizeof(float4);
  err = allow_shared((const void*)pairs_any_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  pairs_any_kernel<<<n_blocks, BLOCK, shmem, (cudaStream_t)stream>>>(tb, rows, leaf_size, runs, pair_treelet,
                                                                     order, packed, n, occ);
  return (int)cudaGetLastError();
}
