// Bundle walks for Hopper (sm_90a): the CUDA port of the two Pallas kernels
// of yuki_tpu/ops/trace_walker.py, the divergent-wave engine behind
// traverse.WALKER_CLOSEST / WALKER_ANY.
//
//   yk_walker_closest  replaces _walker_closest_kernel (trace_walker.py:204)
//                      and the fold after it, _lane_fold_closest (:354);
//                      given skip ids, its with_skip variant
//   yk_walker_any      replaces _walker_any_kernel (:269)
//
// Both walk a bundle of 8 consecutive rays over its list of chunks
// (ascending chunk ids, -1 ends it).  Both are redesigned for the card
// (PERF.md §6 records the change and its measurements).  The first port
// ran one 128-thread block per bundle, thread j being triangle slot j of
// the walked chunk, and paid for EVERY list entry, walked or not, a chain
// of the list load, 8 IEEE divides and 8 warp minima per thread (each
// ray's bound, the minimum over the slots of ts / det), a barrier, a box
// recheck by 8 threads while 120 waited, a __syncthreads_or, and for a
// walked entry a stage of the chunk's 6 KB through shared memory with
// scalar loads and one more barrier; every test made the 18 coordinate
// selects of the shear frame.  Now both run one warp per bundle and no
// block barrier at all.
//
// walker_closest_kernel.  The TPU kernel's carry stays: one scaled hit
// (ts, det, prim) per ray and triangle slot j (row j of each walked
// chunk); a slot takes a hit only on ts_c * det_b < ts_b * det_c, so within
// a slot the first entry in list order wins a tie, and <true> (with_skip)
// never takes a triangle of the ray's skip light.  Ray r is live for entry
// q when t_max > 0 and its chunk box passes _bounds_recheck at the bound,
// the minimum over the 128 slots of ts / det after entries 0..q-1, decided
// in list order as before.  What changed:
// - lane l holds slots l, l + 32, l + 64, l + 96; their carries live in
//   shared memory (12 KB a bundle), written only when a slot takes a hit
//   (a bit per slot and ray in the lane's `taken`; an untaken slot is the
//   seed (t_max, 1, -1)), so no per-slot registers limit the bundles an SM
//   holds;
// - no divide and no reduction per entry: the bound changes only when a
//   slot takes a hit, so only after a walk in which one did is it made
//   again (ts / det by the same IEEE divides, the seed's t_max / 1 =
//   t_max, a warp minimum), and only for the rays that took one;
// - rechecks in windows: lane l rechecks ray l % 8 against entries l / 8,
//   + 4, + 8, + 12 of a window of 16 at the current bounds (the folds one
//   instruction each, min_nan/max_nan, the reciprocal made once), and four
//   ballots give every entry's live rays.  The entries before the first
//   live one are passed over with exact decisions; after a walk with a
//   take the rest of the window is rechecked at the new bounds: every
//   entry when some bound rose, else only those that still have a live
//   ray (min(tf, bound) never grows as a bound falls);
// - no stage: a walked chunk's rows come straight into registers with
//   16-byte loads, 32 rows (a slab) at a time with the next slab's loads
//   issued before this one is tested, and only up to the chunk's last
//   real row (`walk`, the table walk_rows keeps on the chunk structure); a
//   padding row between real ones (prim id < 0) tests nothing; for each
//   shear frame of the entry's live rays the row is read in that frame
//   (permuted_row, a renaming of registers) and tested from the ray's
//   origin in the same frame with watertight_framed, with no per-test
//   selects (permx(c - o) = permx(c) - permx(o), so the bits are the
//   same).  The rays are a loop, one copy of the test per frame: unrolled
//   over rays and slabs, the code outgrew the instruction cache and ran
//   several times slower (PERF.md §6);
// - the fold (_lane_fold_closest: misses as (F32_MAX, 1, BIG); for h = 64,
//   32, ..., 1 slot i takes slot i + h when ts_b * det_a < ts_a * det_b,
//   or equal with a lower prim id; then one IEEE divide per ray) does
//   h = 64 and 32 within a lane and h = 16 .. 1 by shuffles.  The scaled
//   compare is not transitive, so the per-slot carry and this pairing are
//   kept rather than a running minimum per ray.
// A bundle with an empty list, or whose 8 rays all have t_max <= 0 or
// NaN, writes (t_max, -1) at once.
//
// walker_any_kernel.  Ray r's bit is the OR, over the listed chunks whose
// box it crosses at its fixed t_max, of "a real triangle of another light
// than its skip id is hit within t_max": no entry order, assignment of
// rays and rows to lanes or per-ray exit changes a bit, and the first
// port's per-entry chain bought nothing.  Now one warp per bundle, 4 a
// block: a bundle with an empty list writes its zeros after one load;
// else lane l rechecks ray l % 8 against entries l / 8, + 4, + 8, + 12 of
// a window of 16 (against t_max, so no recheck waits on a walk); for each
// entry some unoccluded ray crosses, lane l tests rows l, l + 32, ... of
// the chunk up to its last real row (loaded as the closest walk loads
// them) against those rays in their frames, and after each 32 rows a
// warp OR retires the occluded rays; the bundle leaves when none is open.
//
// What bounds them: ALU work, ~40 operations per live ray and real
// triangle of each walked chunk plus a 24-operation box test per ray and
// listed chunk; traffic is 28-32 B of ray in and 8 B (4 B) out per ray,
// 4 B per list entry and the 6 KB rows of each walked chunk (served from
// L2 after the first bundle).  What holds them now is the latency of each
// walked entry's row loads (PERF.md §6: the probe with no test keeps half
// the closest walk's time).
//
// Numerics: -fmad=false and no fast-math, so every product rounds on its own
// as in the PyTorch and JAX versions; the recheck's folds propagate NaN.

#include <cuda_runtime.h>

#include <cstdint>

#include "trace_stream.cuh"

using namespace yk;

namespace {

constexpr int SLOTS = 128;      // triangle slots of a bundle: rows of a chunk, 4 a lane
constexpr int BUN = 8;          // rays per bundle
constexpr int WINDOW = 16;      // list entries rechecked together
constexpr int CL_BUNDLES = 1;   // the closest walk's bundles (warps) a block: 12.5 KB each
constexpr int ANY_BUNDLES = 4;  // the occlusion walk's bundles (warps) a block
constexpr float BIG = 3.0e38f;

// A ray as a bundle's walks read it from shared memory: its origin in its
// shear frame and sx, then sy, inv_dz, t_max and its skip id.
struct WalkRay {
  float4 a, b;
};

__device__ __forceinline__ WalkRay walk_ray(const Shear& sh, V3 o, float tm, float sk) {
  const V3 of = framed_origin(sh, o.x, o.y, o.z);
  return {make_float4(of.x, of.y, of.z, sh.sx), make_float4(sh.sy, sh.inv_dz, tm, sk)};
}

// watertight_framed for ray w against a row already in w's frame.
__device__ __forceinline__ bool framed_test(const WalkRay& w, const float4* p, float& ts, float& det) {
  const Shear sh{false, false, w.a.w, w.b.x, w.b.y};
  return watertight_framed(sh, v3(w.a.x, w.a.y, w.a.z), p[0], p[1], p[2], ts, det);
}

// _bounds_recheck (trace_walker.py:181-201): a chunk box (lo 0-2, hi 3-5)
// against a ray with inv = _safe_inv(d) and its bound.  The folds are
// PTX's NaN-propagating min and max (trace_stream.cuh): jmin's and jmax's
// values on numbers up to the sign of a zero, and a NaN for a NaN, which
// the one compare they feed cannot tell apart.
__device__ __forceinline__ bool crosses(const float* __restrict__ b, V3 o, V3 inv, float t_bound) {
  const float t0x = (__ldg(b + 0) - o.x) * inv.x;
  const float t1x = (__ldg(b + 3) - o.x) * inv.x;
  const float t0y = (__ldg(b + 1) - o.y) * inv.y;
  const float t1y = (__ldg(b + 4) - o.y) * inv.y;
  const float t0z = (__ldg(b + 2) - o.z) * inv.z;
  const float t1z = (__ldg(b + 5) - o.z) * inv.z;
  const float tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
  const float tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
  return max_nan(tn, 0.0f) <= min_nan(tf, t_bound);
}

// A window's ballots: word x holds entries 4x .. 4x + 3, one byte of 8 ray
// bits each.  entry_rays: entry e's rays; entry_bits: bit e set when entry
// e has one.
__device__ __forceinline__ unsigned entry_rays(const unsigned (&w)[4], int e) {
  const int x = e >> 2;
  const unsigned word = x == 0 ? w[0] : (x == 1 ? w[1] : (x == 2 ? w[2] : w[3]));
  return (word >> (8 * (e & 3))) & 0xffu;
}

__device__ __forceinline__ unsigned entry_bits(const unsigned (&w)[4]) {
  unsigned m = 0u;
#pragma unroll
  for (int e = 0; e < WINDOW; ++e)
    if ((w[e >> 2] >> (8 * (e & 3))) & 0xffu) m |= 1u << e;
  return m;
}

// Entry e's value of v, which lane 8 (e & 3) holds as v[e >> 2].
__device__ __forceinline__ int entry_int(const int (&v)[4], int e) {
  const int x = e >> 2;
  return __shfl_sync(FULL, x == 0 ? v[0] : (x == 1 ? v[1] : (x == 2 ? v[2] : v[3])), (e & 3) << 3);
}

// Lanes 0-7 of a warp hold rays 0-7: the rays of each shear frame.
__device__ __forceinline__ void frame_rays(int frame, unsigned (&fr)[3]) {
#pragma unroll
  for (int f = 0; f < 3; ++f) fr[f] = __ballot_sync(FULL, frame == f) & 0xffu;
}

// fminf, where jnp.min would propagate a NaN: a quotient is NaN only for a
// ray with t_max NaN, which is never live.
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s /= 2) v = fminf(v, __shfl_xor_sync(FULL, v, s));
  return v;
}

// A bundle's carries, [ray][slot]: slot j's scaled hit for each ray once it
// has taken one (bit 8s + r of `taken` in lane j % 32, s = j / 32); before
// that the seed (t_max, 1, -1), which no store writes.
struct Carries {
  float ts[BUN][SLOTS], det[BUN][SLOTS], prim[BUN][SLOTS];
};

// A row (a, b, c; prim id >= 0) in the lane's slot `slot` (its bits from
// `sbit`) against the rays m of frame F: take a strictly closer hit (scaled
// compare).  The rays are a loop, not unrolled: the carries live in shared
// memory, and one copy of the test per frame keeps the code small.
template <bool WITH_SKIP, int F>
__device__ __forceinline__ void closest_row(unsigned m, const WalkRay* ray, const float4& a, const float4& b,
                                            const float4& c, Carries& cr, int slot, int sbit, unsigned& taken,
                                            unsigned& took) {
  float4 p[3];
  permuted_row<F>(a, b, c, p);
#pragma unroll 1
  for (; m != 0u; m &= m - 1u) {
    const int r = __ffs((int)m) - 1;
    const WalkRay w = ray[r];
    if (WITH_SKIP && c.y == w.b.w) continue;
    float ts_c, det_c;
    if (!framed_test(w, p, ts_c, det_c)) continue;
    const unsigned bit = 1u << (sbit + r);
    const bool had = (taken & bit) != 0u;
    const float ts_b = had ? cr.ts[r][slot] : w.b.z;
    const float det_b = had ? cr.det[r][slot] : 1.0f;
    if (ts_c * det_b < ts_b * det_c) {
      cr.ts[r][slot] = ts_c;
      cr.det[r][slot] = det_c;
      cr.prim[r][slot] = c.z;
      taken |= bit;
      took |= 1u << r;
    }
  }
}

// The carry of the lane's slot of slab S for ray r, a miss as the fold
// enters it: (F32_MAX, 1, BIG).
template <int S>
__device__ __forceinline__ void fold_entry(const Carries& cr, unsigned taken, int r, int lane, float& ts, float& det,
                                           float& prim) {
  const bool had = (taken >> (8 * S + r)) & 1u;
  ts = had ? cr.ts[r][32 * S + lane] : YK_F32_MAX;
  det = had ? cr.det[r][32 * S + lane] : 1.0f;
  prim = had ? cr.prim[r][32 * S + lane] : BIG;
}

// The lane's minimum over its 4 slots of ts / det for ray r (t_max for an
// untaken slot: the seed's t_max / 1).
__device__ __forceinline__ float slots_min(const Carries& cr, unsigned taken, int r, int lane, float tm_r) {
  float v = 0.0f;
#pragma unroll
  for (int s = 0; s < SLOTS / 32; ++s) {
    const float q = (taken >> (8 * s + r)) & 1u ? cr.ts[r][32 * s + lane] / cr.det[r][32 * s + lane] : tm_r;
    v = s == 0 ? q : fminf(v, q);
  }
  return v;
}

// Slot a takes slot b: _lane_fold_closest's step.
__device__ __forceinline__ void fold_take(float& ts_a, float& det_a, float& pr_a, float ts_b, float det_b,
                                          float pr_b) {
  const float lhs = ts_b * det_a;
  const float rhs = ts_a * det_b;
  if (lhs < rhs || (lhs == rhs && pr_b < pr_a)) {
    ts_a = ts_b;
    det_a = det_b;
    pr_a = pr_b;
  }
}

template <bool WITH_SKIP>
__global__ void __launch_bounds__(32 * CL_BUNDLES)
    walker_closest_kernel(const float* __restrict__ cb, const float* __restrict__ rows,
                          const int* __restrict__ walk, int k, const int* __restrict__ lists, int C,
                          const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                          const float* __restrict__ skip, float* __restrict__ t_out, int* __restrict__ prim_out,
                          int n_bundles) {
  __shared__ WalkRay ray_s[CL_BUNDLES][BUN];
  __shared__ Carries carry_s[CL_BUNDLES];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int bundle = blockIdx.x * CL_BUNDLES + wb;
  if (bundle >= n_bundles) return;
  // Lane l rechecks ray rr against entries e0 + 4s (s = 0..3) of each window.
  const int rr = lane & 7, e0 = lane >> 3;
  const int i = bundle * BUN + rr;
  const int* list = lists + (size_t)bundle * C;
  const int first = C > 0 ? __ldg(list) : -1;
  const float tm = tmax[i];
  if ((__ballot_sync(FULL, tm > 0.0f) & 0xffu) == 0u || first < 0) {
    // Every ray misses: what the walk and the fold give.
    if (lane < BUN) {
      t_out[i] = tm;
      prim_out[i] = -1;
    }
    return;
  }
  const V3 ro = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const V3 rd = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
  const Shear sh = make_shear(rd);
  unsigned fr[3];
  frame_rays(frame_of(sh), fr);
  if (lane < BUN) ray_s[wb][lane] = walk_ray(sh, ro, tm, WITH_SKIP ? skip[i] : 0.0f);
  __syncwarp();
  const WalkRay* ray = ray_s[wb];
  Carries& cr = carry_s[wb];
  unsigned taken = 0u;  // bit 8s + r: slot 32s + lane holds a hit for ray r
  float bound = tm;     // ray rr's minimum over the slots of ts / det
  const float4* rows4 = reinterpret_cast<const float4*>(rows) + 3 * lane;  // row lane of chunk 0
  const float4 none = make_float4(0.0f, 0.0f, -1.0f, 0.0f);
  for (int base = 0; base < C; base += WINDOW) {
    int tt[4], nr[4];
    unsigned w[4], ends[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int qe = base + e0 + 4 * s;
      tt[s] = qe < C ? __ldg(list + qe) : -1;
      nr[s] = tt[s] >= 0 ? __ldg(walk + tt[s]) : 0;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      w[s] = __ballot_sync(FULL, tt[s] >= 0 && tm > 0.0f && crosses(cb + 8 * tt[s], ro, inv, bound));
      ends[s] = __ballot_sync(FULL, tt[s] < 0);
    }
    const unsigned end_bits = entry_bits(ends);
    const int n_on = end_bits ? __ffs((int)end_bits) - 1 : WINDOW;  // the list ends at its first -1
    const unsigned on_mask = (1u << n_on) - 1u;
    unsigned todo = entry_bits(w) & on_mask;
    while (todo != 0u) {
      const int eb = __ffs((int)todo) - 1;
      todo &= todo - 1u;
      const unsigned m = entry_rays(w, eb);
      // The lane's rows lane, lane + 32, ... up to the chunk's last real
      // one, the next slab's loads issued before this one is tested.
      const int n_e = entry_int(nr, eb), slabs = (n_e + 31) >> 5;
      const float4* src = rows4 + (size_t)entry_int(tt, eb) * k * 3;
      float4 a = none, b = none, c = none;
      if (lane < n_e) {
        a = __ldg(src);
        b = __ldg(src + 1);
        c = __ldg(src + 2);
      }
      unsigned took = 0u;
#pragma unroll 1
      for (int s = 0; s < slabs; ++s) {
        float4 na = none, nb = none, nc = none;
        if (32 * (s + 1) + lane < n_e) {
          na = __ldg(src + 96 * (s + 1));
          nb = __ldg(src + 96 * (s + 1) + 1);
          nc = __ldg(src + 96 * (s + 1) + 2);
        }
        if (c.z >= 0.0f) {
          const int slot = 32 * s + lane;
          if (m & fr[0]) closest_row<WITH_SKIP, 0>(m & fr[0], ray, a, b, c, cr, slot, 8 * s, taken, took);
          if (m & fr[1]) closest_row<WITH_SKIP, 1>(m & fr[1], ray, a, b, c, cr, slot, 8 * s, taken, took);
          if (m & fr[2]) closest_row<WITH_SKIP, 2>(m & fr[2], ray, a, b, c, cr, slot, 8 * s, taken, took);
        }
        a = na;
        b = nb;
        c = nc;
      }
      const unsigned tk = __reduce_or_sync(FULL, took);
      if (tk == 0u) continue;
      // The bounds of the rays some slot took a hit for, then the rest of
      // the window rechecked at them.  min(tf, bound) never grows as a
      // bound falls, so when no bound rose only the entries that still
      // have a live ray can change.
      float fresh = bound;
#pragma unroll
      for (int r = 0; r < BUN; ++r) {
        if (!((tk >> r) & 1u)) continue;
        const float mq = warp_min(slots_min(cr, taken, r, lane, ray[r].b.z));
        if (rr == r) fresh = mq;
      }
      const bool rose = __any_sync(FULL, fresh > bound);
      bound = fresh;
      const unsigned cand = rose ? on_mask & ~((2u << eb) - 1u) : todo;
      if (cand == 0u) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int e = e0 + 4 * s;
        w[s] = __ballot_sync(FULL, ((cand >> e) & 1u) && tm > 0.0f && crosses(cb + 8 * tt[s], ro, inv, bound));
      }
      todo = entry_bits(w);
    }
    if (n_on < WINDOW) break;
  }

  // _lane_fold_closest over the 128 slots, ray by ray: h = 64 and 32
  // within the lane (slots lane, + 32, + 64, + 96), h = 16 .. 1 by
  // shuffles; lane r keeps ray r's winner.
  float f_ts = 0.0f, f_det = 1.0f, f_prim = BIG;
#pragma unroll
  for (int r = 0; r < BUN; ++r) {
    float ts[4], det[4], pr[4];
    fold_entry<0>(cr, taken, r, lane, ts[0], det[0], pr[0]);
    fold_entry<1>(cr, taken, r, lane, ts[1], det[1], pr[1]);
    fold_entry<2>(cr, taken, r, lane, ts[2], det[2], pr[2]);
    fold_entry<3>(cr, taken, r, lane, ts[3], det[3], pr[3]);
    fold_take(ts[0], det[0], pr[0], ts[2], det[2], pr[2]);
    fold_take(ts[1], det[1], pr[1], ts[3], det[3], pr[3]);
    fold_take(ts[0], det[0], pr[0], ts[1], det[1], pr[1]);
    // Lane i takes lane i + h; lanes past h carry values no later step reads.
#pragma unroll
    for (int h = 16; h >= 1; h /= 2) {
      const float ts_b = __shfl_down_sync(FULL, ts[0], h);
      const float det_b = __shfl_down_sync(FULL, det[0], h);
      const float pr_b = __shfl_down_sync(FULL, pr[0], h);
      fold_take(ts[0], det[0], pr[0], ts_b, det_b, pr_b);
    }
    const float a = __shfl_sync(FULL, ts[0], 0), b = __shfl_sync(FULL, det[0], 0),
                c = __shfl_sync(FULL, pr[0], 0);
    if (lane == r) {
      f_ts = a;
      f_det = b;
      f_prim = c;
    }
  }
  if (lane < BUN) {
    const bool hit = f_prim < BIG;
    t_out[i] = hit ? f_ts / f_det : tm;
    prim_out[i] = hit ? (int)f_prim : -1;
  }
}

// One row (a, b, c; prim id >= 0) against the rays m of frame F: the rays
// it occludes (hit within t_max, another light than the ray's skip id); a
// loop over the rays, as closest_row's.
template <int F>
__device__ __forceinline__ unsigned occluded_by(unsigned m, const WalkRay* ray, const float4& a, const float4& b,
                                                const float4& c) {
  float4 p[3];
  permuted_row<F>(a, b, c, p);
  unsigned hit = 0u;
#pragma unroll 1
  for (; m != 0u; m &= m - 1u) {
    const int r = __ffs((int)m) - 1;
    const WalkRay w = ray[r];
    if (c.y == w.b.w) continue;
    float ts, det;
    if (framed_test(w, p, ts, det) && ts <= w.b.z * det) hit |= 1u << r;
  }
  return hit;
}

__global__ void __launch_bounds__(32 * ANY_BUNDLES)
    walker_any_kernel(const float* __restrict__ cb, const float* __restrict__ rows,
                      const int* __restrict__ walk, int k, const int* __restrict__ lists, int C,
                      const float* __restrict__ o, const float* __restrict__ d, const float* __restrict__ tmax,
                      const float* __restrict__ skip,
                      int* __restrict__ occ_out, int n_bundles) {
  __shared__ WalkRay ray_s[ANY_BUNDLES][BUN];
  const int lane = threadIdx.x & 31, wb = threadIdx.x >> 5;
  const int bundle = blockIdx.x * ANY_BUNDLES + wb;
  if (bundle >= n_bundles) return;
  const int rr = lane & 7, e0 = lane >> 3;
  const int i = bundle * BUN + rr;
  const int* list = lists + (size_t)bundle * C;
  const int first = C > 0 ? __ldg(list) : -1;
  const float tm = tmax[i];
  unsigned open = __ballot_sync(FULL, tm > 0.0f) & 0xffu;  // rays neither dead nor occluded
  unsigned occ = 0u;
  if (open != 0u && first >= 0) {
    const V3 ro = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const V3 rd = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const V3 inv = v3(safe_inv(rd.x), safe_inv(rd.y), safe_inv(rd.z));
    const Shear sh = make_shear(rd);
    unsigned fr[3];
    frame_rays(frame_of(sh), fr);
    if (lane < BUN) ray_s[wb][lane] = walk_ray(sh, ro, tm, skip[i]);
    __syncwarp();
    const float4* rows4 = reinterpret_cast<const float4*>(rows) + 3 * lane;  // row lane of chunk 0
    const float4 none = make_float4(0.0f, 0.0f, -1.0f, 0.0f);
    for (int base = 0; base < C && open != 0u; base += WINDOW) {
      // Lane l: ray rr against entries base + e0 + 4s, at its t_max.
      int tt[4], nr[4];
      unsigned w[4], ends[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int qe = base + e0 + 4 * s;
        tt[s] = qe < C ? __ldg(list + qe) : -1;
        nr[s] = tt[s] >= 0 ? __ldg(walk + tt[s]) : 0;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        w[s] = __ballot_sync(FULL, tt[s] >= 0 && ((open >> rr) & 1u) && crosses(cb + 8 * tt[s], ro, inv, tm));
        ends[s] = __ballot_sync(FULL, tt[s] < 0);
      }
      const unsigned end_bits = entry_bits(ends);
      const int n_on = end_bits ? __ffs((int)end_bits) - 1 : WINDOW;
      unsigned todo = entry_bits(w) & ((1u << n_on) - 1u);
      while (todo != 0u && open != 0u) {
        const int eb = __ffs((int)todo) - 1;
        todo &= todo - 1u;
        unsigned m = entry_rays(w, eb) & open;
        if (m == 0u) continue;
        // The lane's rows lane, lane + 32, ... up to the chunk's last real
        // one, the next slab's loads issued before this one is tested; a
        // ray leaves at its first occluder, the walk when none is left.
        const int n_e = entry_int(nr, eb), slabs = (n_e + 31) >> 5;
        const float4* src = rows4 + (size_t)entry_int(tt, eb) * k * 3;
        float4 a = none, b = none, c = none;
        if (lane < n_e) {
          a = __ldg(src);
          b = __ldg(src + 1);
          c = __ldg(src + 2);
        }
#pragma unroll 1
        for (int g = 0; g < slabs && m != 0u; ++g) {
          float4 na = none, nb = none, nc = none;
          if (32 * (g + 1) + lane < n_e) {
            na = __ldg(src + 96 * (g + 1));
            nb = __ldg(src + 96 * (g + 1) + 1);
            nc = __ldg(src + 96 * (g + 1) + 2);
          }
          unsigned hit = 0u;
          if (c.z >= 0.0f) {
            if (m & fr[0]) hit |= occluded_by<0>(m & fr[0], ray_s[wb], a, b, c);
            if (m & fr[1]) hit |= occluded_by<1>(m & fr[1], ray_s[wb], a, b, c);
            if (m & fr[2]) hit |= occluded_by<2>(m & fr[2], ray_s[wb], a, b, c);
          }
          const unsigned now = __reduce_or_sync(FULL, hit);
          occ |= now;
          open &= ~now;
          m &= ~now;
          a = na;
          b = nb;
          c = nc;
        }
      }
      if (n_on < WINDOW) break;
    }
  }
  if (lane < BUN) occ_out[i] = (occ >> lane) & 1u;
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------

// skip null: the plain walk; given: the with_skip variant.
extern "C" int yk_walker_closest(int device, const float* cb, const float* rows, const int* walk, int leaf_size,
                                 const int* lists, int C, int n_bundles, const float* o, const float* d,
                                 const float* tmax, const float* skip, float* t, int* prim, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_bundles + CL_BUNDLES - 1) / CL_BUNDLES;
  if (skip != nullptr)
    walker_closest_kernel<true><<<blocks, 32 * CL_BUNDLES, 0, (cudaStream_t)stream>>>(
        cb, rows, walk, leaf_size, lists, C, o, d, tmax, skip, t, prim, n_bundles);
  else
    walker_closest_kernel<false><<<blocks, 32 * CL_BUNDLES, 0, (cudaStream_t)stream>>>(
        cb, rows, walk, leaf_size, lists, C, o, d, tmax, skip, t, prim, n_bundles);
  return (int)cudaGetLastError();
}

extern "C" int yk_walker_any(int device, const float* cb, const float* rows, const int* walk, int leaf_size,
                             const int* lists, int C, int n_bundles, const float* o, const float* d,
                             const float* tmax, const float* skip, int* occ, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_bundles + ANY_BUNDLES - 1) / ANY_BUNDLES;
  walker_any_kernel<<<blocks, 32 * ANY_BUNDLES, 0, (cudaStream_t)stream>>>(cb, rows, walk, leaf_size, lists, C, o, d,
                                                                           tmax, skip, occ, n_bundles);
  return (int)cudaGetLastError();
}
