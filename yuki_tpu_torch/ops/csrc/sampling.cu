// The stratified sampler's draws for Hopper (sm_90a).
//
//   yk_strat_draws  added, no TPU twin: yuki_tpu computes these values as
//                   XLA ops (sampling.py StratifiedSampler), and the port
//                   ran them as ~245 int64 torch ops a draw with a host read
//                   for Kensler's rejection check
//
// It computes what sampling.py's StratifiedSampler.get_1d / get_2d compute,
// bit for bit, for a list of draws at once: each draw is a dimension and a
// kind (1-D: one plane, 2-D: two), and the planes land in the caller's
// order.  Per lane:
//
//   ph      = pcg(pcg(GOLDEN ^ seed) ^ (px << 16 | py))     pixel_hash
//   jit     = pcg(ph ^ sample_index)                        _dim_u32's base
//   stratum = permutation_element(sample_index, spp, pcg(pcg(GOLDEN ^ ph) ^ dim))
//   delta   = (pcg(jit ^ dim) >> 8) / 2^24, or 0.5 without jitter
//   1-D:    (stratum + delta) / spp
//   2-D:    (stratum % psx + delta(dim)) / psx, (stratum / psy + delta(dim + 1)) / psy
//
// (the reference's y index divides by pixel_samples_y, stratified.rs:131-133;
// kept).  The u32 arithmetic wraps natively, where the torch version holds
// each u32 in an int64 and splits the full-word multipliers into 16-bit
// halves.  Kensler's rejection runs per lane until the value lands in
// [0, spp): the torch version runs rejected lanes' rounds in batches, and an
// extra round never changes an accepted lane, so both give the same value
// (permutation_element bounds the walk where the torch version never ends).
// Divides are IEEE (__fdiv_rn; the build has no fast-math), as the torch
// version's tensor divisor is.
//
// What bounds it on this card: integer ALU work (four pcg hashes and one
// permutation round of ~45 operations a draw, a modulo or two) against
// 4 bytes a plane stored and 8 read a lane; pixel_hash and its two derived
// keys are computed once a lane for every draw.  One thread a lane, the
// draw loop uniform across the warp, each plane's store coalesced.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "path_fused.cuh"

using namespace yk;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DRAWS = 256;  // ops/strat_draws.py MAX_DRAWS
constexpr uint32_t GOLDEN = 0x9E3779B9u;

// The draw list, passed by value: code = dim << 1 | (1 for a 2-D draw).
struct DrawList {
  int n;
  uint32_t code[MAX_DRAWS];
};

// One round of Kensler's hashed permutation (sampling.py round_fn).
__device__ __forceinline__ uint32_t perm_round(uint32_t i, uint32_t p, uint32_t w, uint32_t mult) {
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= mult;
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCB303u;
  i ^= (i & w) >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  return i ^ (i >> 5);
}

// permutation_element(i, l, p): rounds until the value lands in [0, l).
// A round permutes [0, w], so a lane accepts within w + 1 rounds of its
// first, or never: a sample index at or past l can start on a cycle with
// no value below l, where the torch version never returns.  Such a lane
// stops after w + 2 rounds instead of hanging the card.
__device__ __forceinline__ uint32_t permutation_element(uint32_t i, uint32_t l, uint32_t w, uint32_t p) {
  const uint32_t mult = 1u | (p >> 27);
  for (uint32_t r = 0; r < w + 2u; ++r) {
    i = perm_round(i, p, w, mult);
    if (i < l) break;
  }
  return (i + p) % l;
}

__device__ __forceinline__ float jitter_of(bool jitter, uint32_t jit, uint32_t dim) {
  return jitter ? dim_f32(jit, dim) : 0.5f;
}

// out[plane * n + lane]: the planes [planes, n] in the draw list's order.
__global__ void __launch_bounds__(THREADS)
    strat_draws_kernel(const int* __restrict__ px, const int* __restrict__ py, int n, uint32_t sample_index,
                       uint32_t seed, uint32_t psx, uint32_t psy, uint32_t w, int jitter,
                       const __grid_constant__ DrawList draws,
                       float* __restrict__ out) {
  const uint32_t spp = psx * psy;
  const float f_spp = (float)spp, f_psx = (float)psx, f_psy = (float)psy;
  for (int k = blockIdx.x * THREADS + threadIdx.x; k < n; k += gridDim.x * THREADS) {
    const uint32_t key = ((uint32_t)px[k] << 16) | (uint32_t)py[k];
    const uint32_t ph = pcg(pcg(GOLDEN ^ seed) ^ key);
    const uint32_t jit = pcg(ph ^ sample_index);
    const uint32_t hk = pcg(GOLDEN ^ ph);
    float* o = out + k;
    for (int d = 0; d < draws.n; ++d) {
      const uint32_t dim = draws.code[d] >> 1;
      const uint32_t stratum = permutation_element(sample_index, spp, w, pcg(hk ^ dim));
      if (draws.code[d] & 1u) {
        const float x = (float)(stratum % psx) + jitter_of(jitter, jit, dim);
        const float y = (float)(stratum / psy) + jitter_of(jitter, jit, dim + 1u);
        o[0] = __fdiv_rn(x, f_psx);
        o[n] = __fdiv_rn(y, f_psy);
        o += 2 * (long long)n;
      } else {
        o[0] = __fdiv_rn((float)stratum + jitter_of(jitter, jit, dim), f_spp);
        o += n;
      }
    }
  }
}

}  // namespace

// ---- plain C interface, loaded with ctypes ---------------------------------
// codes: the host's draw list (dim << 1 | 2-D), n_draws of them; launched
// MAX_DRAWS at a time on `stream`.  Returns cudaGetLastError() as an int.

extern "C" int yk_strat_draws(int device, const int* px, const int* py, int n, unsigned int sample_index,
                              unsigned int seed, int psx, int psy, int jitter, const unsigned int* codes,
                              int n_draws, float* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  uint32_t w = (uint32_t)(psx * psy) - 1u;
  for (int s = 1; s <= 16; s *= 2) w |= w >> s;
  // One thread a lane; past 2^20 blocks the grid strides.
  const int blocks = std::min((n + THREADS - 1) / THREADS, 1 << 20);
  for (int d0 = 0; d0 < n_draws; d0 += MAX_DRAWS) {
    DrawList draws;
    draws.n = n_draws - d0 < MAX_DRAWS ? n_draws - d0 : MAX_DRAWS;
    for (int d = 0; d < draws.n; ++d) draws.code[d] = codes[d0 + d];
    strat_draws_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        px, py, n, sample_index, seed, (uint32_t)psx, (uint32_t)psy, w, jitter, draws, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int planes = 0;
    for (int d = 0; d < draws.n; ++d) planes += (codes[d0 + d] & 1u) ? 2 : 1;
    out += (long long)planes * n;
  }
  return 0;
}
