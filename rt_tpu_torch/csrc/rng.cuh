// Counter-based RNG of the megakernels, in uint32.
//
// Replaces: rt_tpu/ops/pallas_mega.py `_shr/_tri32/_fold/_key/_uniform/
// _unit_ball` (:591-696) and its QMC twin (`_revbits`,
// `_nested_scramble`, `_sobol_bits`, `_uniform(..., qmc=True)`
// :618-677), which run in int32 with logical shifts. A draw is a pure
// hash of (seed, pixel, sample, bounce, purpose): bit-identical to
// rt_tpu_torch/ops/rng.py (`key`, `uniform`) and, under the sampler
// "qmc", to ops/qmc.py (`uniform`), which the tests check. The unit
// ball uses the megakernel's radius exp(log(u1) / 3)
// (pallas_mega.py:682-686), as does its plain twin
// ops/mega_plain.unit_ball.
//
// A lane's draws at one bounce share a prefix (`Draw::pre`): the hash
// of (seed, pixel, sample, bounce) for "rng", and of (seed, pixel,
// kQmcTag, bounce) for "qmc" (the kernels' kQmc instantiation), whose
// draws take the sample as the Sobol' index (`Draw::sample`) and the
// purpose's site and dimension
// (qmc.py _SITE): a site key fold(pre, 0x100 + site), an index
// scrambled by its fold with 1 and a Sobol' point scrambled by its fold
// with 2 + dim (the nested scramble: bit reversal, four Laine-Karras
// multiplies, bit reversal).
#pragma once

#include <cstdint>

namespace rtt {

// draw purposes (rt_tpu/ops/rng.py:30-42)
constexpr uint32_t kPixelU = 1, kPixelV = 2, kLensU1 = 3, kLensU2 = 4;
constexpr uint32_t kScatU1 = 5, kScatU2 = 6, kScatU3 = 7;
constexpr uint32_t kDielRefl = 8, kRR = 9;
constexpr uint32_t kNeePick = 11, kNeeU1 = 12, kNeeU2 = 13;

__device__ __forceinline__ uint32_t triple32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// absorb one 32-bit word (0x9E3779B9: the Weyl increment of key words)
__device__ __forceinline__ uint32_t fold(uint32_t state, uint32_t word) {
  return triple32(state + word * 0x9E3779B9u);
}

// The hash state after (seed, pixel, sample, bounce); one more fold with
// the purpose gives a draw's key. A lane folds its coordinates once per
// bounce and each of its draws once more.
__device__ __forceinline__ uint32_t prefix(uint32_t seed, uint32_t pixel,
                                           uint32_t sample, uint32_t bounce) {
  return fold(fold(fold(seed, pixel), sample), bounce);
}

// U[0,1): the key's 24 high bits, exact in float32
__device__ __forceinline__ float uniform(uint32_t pre, uint32_t purpose) {
  return static_cast<float>(fold(pre, purpose) >> 8) * (1.0f / 16777216.0f);
}

// the word in the sample's slot of a QMC prefix (ops/qmc.py QMC_TAG)
constexpr uint32_t kQmcTag = 0x51D0B07u;
// site ids lie above every rng purpose id (ops/qmc.py _SITE_BASE)
constexpr uint32_t kSiteBase = 0x100u;

// Direction vectors of Sobol' dimensions 1 and 2 (ops/qmc.py DIRS;
// dimension 0 is the bit reversal)
__constant__ uint32_t kSobolDirs[2][32] = {
    {0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u, 0x88000000u,
     0xCC000000u, 0xAA000000u, 0xFF000000u, 0x80800000u, 0xC0C00000u,
     0xA0A00000u, 0xF0F00000u, 0x88880000u, 0xCCCC0000u, 0xAAAA0000u,
     0xFFFF0000u, 0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u,
     0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u, 0x80808080u,
     0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u, 0x88888888u, 0xCCCCCCCCu,
     0xAAAAAAAAu, 0xFFFFFFFFu},
    {0x80000000u, 0xC0000000u, 0x60000000u, 0x90000000u, 0xE8000000u,
     0x5C000000u, 0x8E000000u, 0xC5000000u, 0x68800000u, 0x9CC00000u,
     0xEE600000u, 0x55900000u, 0x80680000u, 0xC09C0000u, 0x60EE0000u,
     0x90550000u, 0xE8808000u, 0x5CC0C000u, 0x8E606000u, 0xC5909000u,
     0x6868E800u, 0x9C9C5C00u, 0xEEEE8E00u, 0x5555C500u, 0x8000E880u,
     0xC0005CC0u, 0x60008E60u, 0x9000C590u, 0xE8006868u, 0x5C009C9Cu,
     0x8E00EEEEu, 0xC5005555u}};

// Owen scramble of a word's digits (ops/qmc.py nested_scramble)
__device__ __forceinline__ uint32_t nested_scramble(uint32_t x,
                                                    uint32_t seed) {
  x = __brev(x) + seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return __brev(x);
}

// The Sobol' point (a word) of index idx in dimension 0-2: the XOR of
// the direction vectors of idx's set bits, taken lowest first (a loop,
// not 32 unrolled steps, keeps each draw site's code short)
__device__ __forceinline__ uint32_t sobol_bits(uint32_t idx, int dim) {
  if (dim == 0) return __brev(idx);
  uint32_t acc = 0u;
  while (idx) {
    acc ^= kSobolDirs[dim - 1][__ffs(idx) - 1];
    idx &= idx - 1u;
  }
  return acc;
}

// U[0,1) of a QMC site (ops/qmc.py uniform): qpre is the lane's QMC
// prefix at this bounce, sample the Sobol' index.
__device__ __forceinline__ float qmc_uniform(uint32_t qpre, uint32_t sample,
                                             int site, int dim) {
  const uint32_t sk = fold(qpre, kSiteBase + static_cast<uint32_t>(site));
  const uint32_t idx = nested_scramble(sample, fold(sk, 1u));
  const uint32_t bits = nested_scramble(
      sobol_bits(idx, dim), fold(sk, 2u + static_cast<uint32_t>(dim)));
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// The (site, dim) of a draw purpose (ops/qmc.py _SITE); every purpose a
// kernel draws has one.
__device__ __forceinline__ int qmc_site(uint32_t purpose) {
  return purpose <= kPixelV   ? 0
         : purpose <= kLensU2 ? 1
         : purpose <= kScatU3 ? 2
         : purpose == kDielRefl ? 3
         : purpose == kRR       ? 4
                                : 6;
}
__device__ __forceinline__ int qmc_dim(uint32_t purpose) {
  return purpose == kPixelU || purpose == kLensU1 || purpose == kScatU1 ||
                 purpose == kDielRefl || purpose == kRR ||
                 purpose == kNeePick
             ? 0
         : purpose == kScatU3 || purpose == kNeeU2 ? 2
                                                   : 1;
}

// A lane's draws at one bounce: the prefix (rng's or QMC's, see above)
// and the sample.
struct Draw {
  uint32_t pre, sample;
};

// The prefix of (seed, pixel, sample) that a lane folds each bounce
// into: the sample, or kQmcTag under QMC.
__device__ __forceinline__ uint32_t lane_key(uint32_t seed, uint32_t pixel,
                                             uint32_t sample, bool qmc) {
  return fold(fold(seed, pixel), qmc ? kQmcTag : sample);
}

__device__ __forceinline__ Draw draw_at(uint32_t key, uint32_t sample,
                                        uint32_t bounce) {
  return Draw{fold(key, bounce), sample};
}

// One U[0,1) draw of a purpose at a lane's bounce, from the sampler
// kQmc selects
template <bool kQmc>
__device__ __forceinline__ float uniform(const Draw& d, uint32_t purpose) {
  if constexpr (kQmc)
    return qmc_uniform(d.pre, d.sample, qmc_site(purpose), qmc_dim(purpose));
  else
    return uniform(d.pre, purpose);
}

template <bool kQmc>
__device__ __forceinline__ void unit_ball(const Draw& d, float& x, float& y,
                                          float& z) {
  const float u1 = uniform<kQmc>(d, kScatU1);
  const float u2 = uniform<kQmc>(d, kScatU2);
  const float u3 = uniform<kQmc>(d, kScatU3);
  const float r =
      u1 > 0.0f ? expf(logf(fmaxf(u1, 1e-38f)) * (1.0f / 3.0f)) : 0.0f;
  const float cos_t = 1.0f - 2.0f * u2;
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  const float phi = 6.28318530717958647692f * u3;
  x = r * sin_t * cosf(phi);
  y = r * sin_t * sinf(phi);
  z = r * cos_t;
}

}  // namespace rtt
