// The camera ray of one (pixel, sample), made in a kernel.
//
// Replaces: the in-kernel `camera_ray` of rt_tpu/ops/pallas_mega.py
// `_regen_kernel` (:2361-2381), the thin-lens camera of
// gpu-version/camera.cuh:31-39 with the CPU versions' defocus. It must
// give rt_tpu_torch/ops/camera.generate_rays's bits on the card, so it
// takes the same draws, at bounce 0 of the sampler kQmc selects (rng.cuh
// Draw: "rng" or "qmc"), and repeats
// its float32 expressions in their order: s = (px + ru) / ((w-1) or 1),
// the lens disk r = sqrt(u1), phi = 2pi * u2, the offset
// u * (lr * (r cos phi)) + v * (lr * (r sin phi)), and the direction
// ((ll + s hor) + t ver - origin) - offset. That holds only when the
// including library is built without FMA contraction (--fmad=false: a
// fused ll + s * hor rounds once where torch's mul and add round
// twice), with IEEE division and sqrt (nvcc's defaults; no
// --use_fast_math).
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace rtt {

// The camera frame (ops/camera.camera_vec's 19 floats) and the frame's
// size, passed to a kernel by value.
struct Camera {
  float org[3], ll[3], hor[3], ver[3], u[3], v[3];
  float lens_radius;
  float w_den, h_den;  // float((width - 1) or 1), float((height - 1) or 1)
  int width;
  int defocus;
};

__host__ inline Camera make_camera(const float* vec, int width, int height,
                                   int defocus) {
  Camera c;
  for (int j = 0; j < 3; ++j) {
    c.org[j] = vec[j];
    c.ll[j] = vec[3 + j];
    c.hor[j] = vec[6 + j];
    c.ver[j] = vec[9 + j];
    c.u[j] = vec[12 + j];
    c.v[j] = vec[15 + j];
  }
  c.lens_radius = vec[18];
  c.w_den = static_cast<float>(width > 1 ? width - 1 : 1);
  c.h_den = static_cast<float>(height > 1 ? height - 1 : 1);
  c.width = width;
  c.defocus = defocus;
  return c;
}

// Origin and direction of the camera ray through pixel (px, py), whose
// id is `pixel` (py * width + px), for sample `sample`.
template <bool kQmc>
__device__ __forceinline__ void camera_ray(const Camera& c, uint32_t seed,
                                           uint32_t pixel, int px, int py,
                                           uint32_t sample, float ro[3],
                                           float rd[3]) {
  const Draw pre = draw_at(lane_key(seed, pixel, sample, kQmc), sample, 0u);
  const float s =
      (static_cast<float>(px) + uniform<kQmc>(pre, kPixelU)) / c.w_den;
  const float t =
      (static_cast<float>(py) + uniform<kQmc>(pre, kPixelV)) / c.h_den;
  float off[3] = {0.0f, 0.0f, 0.0f};
  if (c.defocus) {
    const float r = sqrtf(uniform<kQmc>(pre, kLensU1));
    const float phi = 6.28318530717958647692f * uniform<kQmc>(pre, kLensU2);
    const float rl0 = c.lens_radius * (r * cosf(phi));
    const float rl1 = c.lens_radius * (r * sinf(phi));
    for (int j = 0; j < 3; ++j) off[j] = c.u[j] * rl0 + c.v[j] * rl1;
  }
  for (int j = 0; j < 3; ++j) {
    ro[j] = c.org[j] + off[j];
    rd[j] = (((c.ll[j] + s * c.hor[j]) + t * c.ver[j]) - c.org[j]) - off[j];
  }
}

}  // namespace rtt
