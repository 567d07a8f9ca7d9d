// Counter-based RNG of the megakernels, in uint32.
//
// Replaces: rt_tpu/ops/pallas_mega.py `_shr/_tri32/_fold/_key/_uniform/
// _unit_ball` (:591-696, the non-QMC branch), which run the triple32
// mixer in int32 with logical shifts. A draw is a pure hash of
// (seed, pixel, sample, bounce, purpose): bit-identical to
// rt_tpu_torch/ops/rng.py (`key`, `uniform`), which the tests check.
// The unit ball uses the megakernel's radius exp(log(u1) / 3)
// (pallas_mega.py:682-686), as does its plain twin
// ops/mega_plain.unit_ball.
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

__device__ __forceinline__ void unit_ball(uint32_t pre, float& x, float& y,
                                          float& z) {
  const float u1 = uniform(pre, kScatU1);
  const float u2 = uniform(pre, kScatU2);
  const float u3 = uniform(pre, kScatU3);
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
