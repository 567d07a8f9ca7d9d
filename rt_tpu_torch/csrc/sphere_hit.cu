// Closest sphere hit per ray, by hand for Hopper (sm_90a).
//
// Replaces: rt_tpu/ops/pallas_intersect.py::_sphere_kernel (:42-96), the
// Pallas TPU kernel launched by sphere_closest_hit (:99-150). Contract
// kept from it: inputs are a packed sphere table and per-ray origin and
// direction; outputs are t [B] (inf on a miss) and pid [B]; the math is
// the same expanded half-b quadratic
//     hb     = rd.ro - c.rd
//     c_term = |ro|^2 - 2 c.ro + (|c|^2 - r^2)     (c2r precomputed)
//     disc   = hb^2 - a c_term,  a = |rd|^2
// taking the near root if it is >= t_min, else the far root; pad rows
// and disc < 0 give inf; equal t goes to the LARGER sphere index
// (pallas_intersect.py:84-88, object.cuh:23-37), and a ray that hits
// nothing reports pid = N-1, as the TPU kernel's chunk reduction does.
//
// What bounds it: arithmetic. Each (ray, sphere) pair costs 22 FP32
// operations (FMA counted as two) and one sqrt, 23 in all, against 32
// bytes of device memory per ray (ro, rd in; t, pid out) and a table read
// once per block from L2. At N = 512 that is ~370 operations per byte,
// far above the H100's FP32 ridge (67 TFLOP/s / 3.35 TB/s = 20).
//
// What the design does about it: one thread per ray keeps its ray and
// its running (t_best, id_best) in registers; the block stages the
// sphere table in shared memory, up to 1024 rows x 5 floats (20 KB) per
// chunk, and every thread of a warp reads the same row at once, which
// shared memory broadcasts without bank conflicts. So the inner loop is
// pure FP32 arithmetic on registers plus one broadcast load per field.
// It does no AABB culling and no table sorting (the TPU megakernel's
// cull_chunks is not part of this kernel's contract). FMA contraction
// is left on: t agrees with the unfused plain version to a few ulps,
// within the rtol 2e-4 / atol 1e-4 the tests state (ROADMAP C-4).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;   // sphere rows per shared-memory stage
constexpr int kCols = 5;       // cx, cy, cz, c2r, live

__global__ void __launch_bounds__(kThreads)
sphere_hit_kernel(const float* __restrict__ table, int n,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  int b, float t_min, float* __restrict__ t_out,
                  int* __restrict__ pid_out) {
  __shared__ float tab[kChunk * kCols];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < b;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (active) {
    ox = ro[3 * i]; oy = ro[3 * i + 1]; oz = ro[3 * i + 2];
    dx = rd[3 * i]; dy = rd[3 * i + 1]; dz = rd[3 * i + 2];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float rd_dot_ro = dx * ox + dy * oy + dz * oz;
  const float ro_sq = ox * ox + oy * oy + oz * oz;
  const float inv_a = 1.0f / a;

  float t_best = CUDART_INF_F;
  int id_best = 0;
  for (int base = 0; base < n; base += kChunk) {
    const int rows = min(kChunk, n - base);
    __syncthreads();  // the previous chunk is no longer being read
    for (int k = threadIdx.x; k < rows * kCols; k += blockDim.x)
      tab[k] = table[base * kCols + k];
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float* s = tab + j * kCols;
      const float cx = s[0], cy = s[1], cz = s[2], c2r = s[3], live = s[4];
      const float hb = rd_dot_ro - (cx * dx + cy * dy + cz * dz);
      const float c_term = ro_sq - 2.0f * (cx * ox + cy * oy + cz * oz) + c2r;
      const float disc = hb * hb - a * c_term;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float r1 = (-hb - sq) * inv_a;
      const float r2 = (-hb + sq) * inv_a;
      float t = r1 >= t_min ? r1 : (r2 >= t_min ? r2 : CUDART_INF_F);
      if (!(disc >= 0.0f && live > 0.0f)) t = CUDART_INF_F;
      // rows arrive in ascending order, so `<=` is "t < best, or equal
      // t and a larger index": the reference's later-wins tie-break
      if (t <= t_best) {
        t_best = t;
        id_best = base + j;
      }
    }
  }
  if (active) {
    t_out[i] = t_best;
    pid_out[i] = id_best;
  }
}

}  // namespace

// table [n, 5] f32 (cx, cy, cz, |c|^2 - r^2, live 1/0), ro/rd [b, 3] f32,
// t_out [b] f32, pid_out [b] i32, all contiguous on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int sphere_closest_hit_launch(const float* table, int n,
                                         const float* ro, const float* rd,
                                         int b, float t_min, float* t_out,
                                         int* pid_out, void* stream) {
  const int blocks = (b + kThreads - 1) / kThreads;
  sphere_hit_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      table, n, ro, rd, b, t_min, t_out, pid_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sphere_hit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
