// Two-level treelet walk kernels for Hopper (sm_90a): the CUDA port of
// yuki_tpu/ops/trace_treelets.py's two Pallas kernels.
//
//   yk_treelet_closest  replaces _closest_kernel (trace_treelets.py:55)
//   yk_treelet_any      replaces _any_kernel (trace_treelets.py:129)
//   yk_treelet_votes    replaces none: the order of the closest walk's blocks
//
// Design.  One thread per ray and one 1024-thread CUDA block per ray block
// of the TPU kernel (1024 consecutive rays; lanes past the end of the batch
// are the padding rays of treelet_closest's _pack: origin 0, direction
// (1,1,1), t_max 0, skip -2, and are not written).  The closest walk
// launches its blocks most votes first (`order`, a permutation of the ray
// blocks): treelet_votes_kernel counts each block's treelet votes at t_max
// inside the supers it votes for at t_max, an estimate of its walk, so
// that a heavy block does not start last and hold the wave; blocks are
// independent, so no bit moves.  (The occlusion walk's blocks in that
// order gained less than the count's own time: PERF.md §6.)
//
// The contract is a block's, not a ray's.  The block walks the supers in
// order, then a visited super's treelets (the contiguous range sr[s]),
// then a visited treelet's rows in order.  It visits a super or a treelet
// when SOME lane's slab test of its box passes at that lane's running t
// (closest) or t_max (occlusion: every lane, occluded ones too, :145-152);
// padding lanes vote too.  Once a box is visited EVERY lane tests its
// rows, also the lanes whose own slab fails (an axis-parallel ray's slab
// is NaN, so it finds its hits only in boxes that other lanes make the
// block visit); equal t keeps the first hit in walk order.  Within that
// contract (redesigned for the card; PERF.md §6 records the change and its
// measurements):
//
// - votes a window at a time, at both levels: the window's WINDOW = 32
//   super or treelet boxes go to shared memory, each lane tests each box
//   into a bit mask, and one block OR gives the boxes some lane votes for;
//   boxes outside the mask are passed over with no barrier, no stage and
//   no walk.  Closest: a lane's t only falls, and max(tmin, 0) <= min(tmax,
//   t) can only turn from true to false as t falls (a NaN fails at any t),
//   so a box that no lane votes for now is never visited later; a box of
//   the mask is voted again at its turn (one __syncthreads_or, which also
//   publishes the treelet's stage), each lane from its window bit unless it
//   has taken a hit since the window was voted (a take can close a later
//   treelet of the window, or a later super).  Occlusion: t_max is fixed,
//   so the window's votes are final;
// - stage ahead: the next treelet of the mask is staged into the second of
//   two buffers while the current one is walked; a stage that its vote
//   then discards is harmless;
// - framed copies: a staged treelet is three copies permuted for the shear
//   frames its block's lanes use (block_frames, found once), and a lane
//   tests its frame's copy from its origin in that frame, with no selects:
//   permx(c - o) = permx(c) - permx(o), so the bits are the same;
// - the walk stops at the treelet's last real row (prim id >= 0), which
//   each warp finds from the staged copy with one ballot per 32 rows;
//   padding rows are never taken nor block;
// - closest: watertight9's operations in its order (sweep_take), the
//   divide only for a test that passes its sign, det and range tests, b0
//   and b1 only on a take; lanes with !(t > 0) never take (the range test
//   fails for t <= 0, and NaN fails ti < t), so they skip the walk, and a
//   warp of them skips it together; they still vote;
// - occlusion: each lane walks a visited treelet to its first blocker
//   (sweep_hit, no divide) and then stops.  The visited boxes are fixed by
//   the t_max votes, so a lane's verdict is the OR over them whatever it
//   skips after its first blocker.  The blocking test is watertight9's
//   hit, whose range test is a miss test: with t_max NaN it passes, so a
//   NaN lane (which never votes) is occluded by a blocker of a box others
//   open.  A lane with t_max <= 0 and a finite shear and origin is never
//   hit, so it tests nothing, and the block leaves its walk once every
//   other lane is occluded (not_done, :145, :178: the verdicts are final
//   then).
//
// What bounds it: ALU work, ~39 operations per live lane and real row of
// each visited treelet (occlusion: up to the lane's first blocker), 24 per
// vote; traffic is 28-32 B of ray in and 16 B (1 B) out per ray, the 32 B
// boxes once per window and the 48 B rows of each staged treelet.  The
// vote count is 24 operations per lane and box it votes on, 28 B of ray
// in and 4 B out per block.
//
// Numerics: built with -fmad=false and without fast-math; the vote is
// vote() of trace_treelets.cuh, whose NaN-propagating min and max give
// jnp's and torch's verdicts.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_treelets.cuh"

using namespace yk;

namespace {

__device__ __forceinline__ Lane load_lane(const float* __restrict__ o, const float* __restrict__ d, int i,
                                          bool valid) {
  return make_lane(valid ? v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]) : v3(0.0f, 0.0f, 0.0f),
                   valid ? v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]) : v3(1.0f, 1.0f, 1.0f));
}

__global__ void __launch_bounds__(BLOCK)
    treelet_closest_kernel(const float* __restrict__ sb, const int* __restrict__ sr, const float* __restrict__ tb,
                           const float* __restrict__ rows, int n_supers, int k, const int* __restrict__ order,
                           const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ tmax, int n, float* __restrict__ t_out,
                           int* __restrict__ prim_out, float* __restrict__ b0_out, float* __restrict__ b1_out) {
  extern __shared__ float4 tri4[];  // two buffers of framed copies, 3 copy_stride4(k) float4s each
  __shared__ int frames_w[BLOCK / 32], mask_w[BLOCK / 32];
  __shared__ float4 sbox_s[2 * WINDOW], tbox_s[2 * WINDOW];
  const int i = __ldg(order + blockIdx.x) * BLOCK + threadIdx.x;
  const bool valid = i < n;
  const Lane l = load_lane(o, d, i, valid);
  float t = valid ? tmax[i] : 0.0f;
  const bool live = t > 0.0f;
  const V3 of = framed_origin(l.sh, l.o.x, l.o.y, l.o.z);
  const int frames = block_frames<BLOCK>(live ? frame_of(l.sh) : -1, frames_w);
  const int buf4 = 3 * copy_stride4(k);
  int prim = -1;
  float b0 = 0.0f, b1 = 0.0f;
  if (frames != 0) {  // else no lane can take a hit
    const bool warp_live = __any_sync(FULL, live);
    for (int sbase = 0; sbase < n_supers; sbase += WINDOW) {
      const int s_on = min(WINDOW, n_supers - sbase);
      // No lane reads sbox_s after the last window's final barrier.
      stage_window(sbox_s, sb, sbase, s_on);
      __syncthreads();
      const unsigned sbits = window_votes(sbox_s, s_on, l, t);
      unsigned srest = (unsigned)block_union<BLOCK>((int)sbits, mask_w);
      bool took_s = false;  // since the super window's vote
      while (srest != 0u) {
        const int s = __ffs((int)srest) - 1;
        srest &= srest - 1u;
        if (!__syncthreads_or(took_s ? vote(sbox_s + 2 * s, l, t) : ((sbits >> s) & 1u) != 0u)) continue;
        const int t0 = __ldg(sr + 2 * (sbase + s)), t1 = t0 + __ldg(sr + 2 * (sbase + s) + 1);
        for (int base = t0; base < t1; base += WINDOW) {
          const int n_on = min(WINDOW, t1 - base);
          // No lane reads tbox_s or a buffer after the last barrier.
          stage_window(tbox_s, tb, base, n_on);
          __syncthreads();
          const unsigned bits = window_votes(tbox_s, n_on, l, t);
          unsigned rest = (unsigned)block_union<BLOCK>((int)bits, mask_w);
          if (rest == 0u) continue;
          int j = __ffs((int)rest) - 1;
          rest &= rest - 1u;
          int buf = 0;
          bool took = false;  // since the treelet window's vote
          stage_copies(tri4, rows, base + j, k, frames);
          for (;;) {
            const bool v = took ? vote(tbox_s + 2 * j, l, t) : ((bits >> j) & 1u) != 0u;
            // Publishes treelet j's stage; the last walk's reads of the
            // other buffer are done.
            const bool visit = __syncthreads_or(v);
            const int nj = rest != 0u ? __ffs((int)rest) - 1 : -1;
            rest &= rest - 1u;
            if (nj >= 0) stage_copies(tri4 + (buf ^ 1) * buf4, rows, base + nj, k, frames);
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
          took_s = took_s || took;
        }
      }
    }
  }
  if (valid) {
    t_out[i] = t;
    prim_out[i] = prim;
    b0_out[i] = b0;
    b1_out[i] = b1;
  }
}

__global__ void __launch_bounds__(BLOCK)
    treelet_any_kernel(const float* __restrict__ sb, const int* __restrict__ sr, const float* __restrict__ tb,
                       const float* __restrict__ rows, int n_supers, int k, const float* __restrict__ o,
                       const float* __restrict__ d, const float* __restrict__ tmax, const int* __restrict__ skip,
                       int n, uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 tri4[];  // two buffers of framed copies, 3 copy_stride4(k) float4s each
  __shared__ int frames_w[BLOCK / 32], mask_w[BLOCK / 32];
  __shared__ float4 sbox_s[2 * WINDOW], tbox_s[2 * WINDOW];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;
  const Lane l = load_lane(o, d, i, valid);
  const float t_max = valid ? tmax[i] : 0.0f;
  const float skip_f = (float)(valid ? skip[i] : -2);
  const V3 of = framed_origin(l.sh, l.o.x, l.o.y, l.o.z);
  const bool may = may_block(l, of, t_max);  // a row can block the lane
  const int frames = block_frames<BLOCK>(may ? frame_of(l.sh) : -1, frames_w);
  const int buf4 = 3 * copy_stride4(k);
  bool occ = false;
  // open: some lane can still be occluded (the same value in every
  // thread: each barrier that sets it is one of the whole block).
  bool open = frames != 0;
  for (int sbase = 0; open && sbase < n_supers; sbase += WINDOW) {
    const int s_on = min(WINDOW, n_supers - sbase);
    // No lane reads sbox_s after the last window's final barrier; this one
    // publishes it, and leaves once no lane can still be occluded.
    stage_window(sbox_s, sb, sbase, s_on);
    open = __syncthreads_or(may && !occ);
    if (!open) break;
    // Every lane votes at t_max, occluded ones too: the votes are final.
    unsigned srest = (unsigned)block_union<BLOCK>((int)window_votes(sbox_s, s_on, l, t_max), mask_w);
    while (open && srest != 0u) {
      const int s = __ffs((int)srest) - 1;
      srest &= srest - 1u;
      const int t0 = __ldg(sr + 2 * (sbase + s)), t1 = t0 + __ldg(sr + 2 * (sbase + s) + 1);
      for (int base = t0; open && base < t1; base += WINDOW) {
        const int n_on = min(WINDOW, t1 - base);
        stage_window(tbox_s, tb, base, n_on);
        open = __syncthreads_or(may && !occ);
        if (!open) break;
        unsigned rest = (unsigned)block_union<BLOCK>((int)window_votes(tbox_s, n_on, l, t_max), mask_w);
        if (rest == 0u) continue;
        int j = __ffs((int)rest) - 1;
        rest &= rest - 1u;
        int buf = 0;
        stage_copies(tri4, rows, base + j, k, frames);
        for (;;) {
          // Publishes treelet j's stage; the last walk's reads of the other
          // buffer are done.
          open = __syncthreads_or(may && !occ);
          if (!open) break;
          const int nj = rest != 0u ? __ffs((int)rest) - 1 : -1;
          rest &= rest - 1u;
          if (nj >= 0) stage_copies(tri4 + (buf ^ 1) * buf4, rows, base + nj, k, frames);
          if (__any_sync(FULL, may && !occ)) {  // the ballot needs the whole warp
            const float4* staged = tri4 + buf * buf4;
            const int last = last_real_row(staged + (__ffs(frames) - 1) * copy_stride4(k), k);
            if (may && !occ) occ = first_blocker(l.sh, of, framed_copy(staged, k, l.sh), last, t_max, skip_f) < last;
          }
          if (nj < 0) break;
          j = nj;
          buf ^= 1;
        }
      }
    }
  }
  if (valid) occ_out[i] = occ ? 1 : 0;
}

// Block b's treelet votes at t_max inside the supers it votes for at
// t_max (votes[b]): the windows of the walks, with no walk.
__global__ void __launch_bounds__(BLOCK)
    treelet_votes_kernel(const float* __restrict__ sb, const int* __restrict__ sr, const float* __restrict__ tb,
                         int n_supers, const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ tmax, int n, int* __restrict__ votes) {
  __shared__ int mask_w[BLOCK / 32];
  __shared__ float4 sbox_s[2 * WINDOW], tbox_s[2 * WINDOW];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = i < n;
  const Lane l = load_lane(o, d, i, valid);
  const float t_max = valid ? tmax[i] : 0.0f;
  int count = 0;
  for (int sbase = 0; sbase < n_supers; sbase += WINDOW) {
    const int s_on = min(WINDOW, n_supers - sbase);
    // Each window's stage is published by the barrier after it; the last
    // reads of the buffer came before the last block_union's barrier.
    stage_window(sbox_s, sb, sbase, s_on);
    __syncthreads();
    unsigned srest = (unsigned)block_union<BLOCK>((int)window_votes(sbox_s, s_on, l, t_max), mask_w);
    while (srest != 0u) {
      const int s = __ffs((int)srest) - 1;
      srest &= srest - 1u;
      const int t0 = __ldg(sr + 2 * (sbase + s)), t1 = t0 + __ldg(sr + 2 * (sbase + s) + 1);
      for (int base = t0; base < t1; base += WINDOW) {
        const int n_on = min(WINDOW, t1 - base);
        stage_window(tbox_s, tb, base, n_on);
        __syncthreads();
        count += __popc(block_union<BLOCK>((int)window_votes(tbox_s, n_on, l, t_max), mask_w));
      }
    }
  }
  if (threadIdx.x == 0) votes[blockIdx.x] = count;
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

inline size_t shared_bytes(int leaf_size) { return (size_t)2 * 3 * copy_stride4(leaf_size) * sizeof(float4); }

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

extern "C" int yk_treelet_votes(int device, const float* sb, const int* sr, const float* tb, int n_supers,
                                const float* o, const float* d, const float* tmax, int n, int* votes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // n = 0: one block of padding lanes, as the plain version counts it.
  treelet_votes_kernel<<<max(blocks_for(n), 1), BLOCK, 0, (cudaStream_t)stream>>>(sb, sr, tb, n_supers, o, d, tmax,
                                                                                 n, votes);
  return (int)cudaGetLastError();
}

extern "C" int yk_treelet_closest(int device, const float* sb, const int* sr, const float* tb, const float* rows,
                                  int n_supers, int leaf_size, const int* order, const float* o, const float* d,
                                  const float* tmax, int n, float* t, int* prim, float* b0, float* b1,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = shared_bytes(leaf_size);
  err = allow_shared((const void*)treelet_closest_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  treelet_closest_kernel<<<blocks_for(n), BLOCK, shmem, (cudaStream_t)stream>>>(sb, sr, tb, rows, n_supers,
                                                                                leaf_size, order, o, d, tmax, n, t,
                                                                                prim, b0, b1);
  return (int)cudaGetLastError();
}

extern "C" int yk_treelet_any(int device, const float* sb, const int* sr, const float* tb, const float* rows,
                              int n_supers, int leaf_size, const float* o, const float* d, const float* tmax,
                              const int* skip, int n, unsigned char* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = shared_bytes(leaf_size);
  err = allow_shared((const void*)treelet_any_kernel, shmem);
  if (err != cudaSuccess) return (int)err;
  treelet_any_kernel<<<blocks_for(n), BLOCK, shmem, (cudaStream_t)stream>>>(sb, sr, tb, rows, n_supers, leaf_size,
                                                                            o, d, tmax, skip, n, occ);
  return (int)cudaGetLastError();
}
