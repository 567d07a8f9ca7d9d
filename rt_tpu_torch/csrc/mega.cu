// The forward megakernel, by hand for Hopper (sm_90a): one segment of a
// full-path trace.
//
// Replaces: rt_tpu/ops/pallas_mega.py::_mega_kernel (:1899-1976), the
// Pallas TPU kernel launched by mega_segment (:2460, pallas_call :2524),
// for spheres with solid and checker textures, no NEE, sampler "rng".
// Contract kept from it: the 13-word ray state in and out (origin,
// direction, throughput, radiance, alive), per-lane pixel and sample
// ids, a start bounce that offsets the RNG's bounce coordinate, at most
// max_depth bounces, and the sky credited to lanes still alive when the
// segment is the last (exhaust_bg). The TPU loops a 2048-lane tile while
// any lane of it is alive; here each thread loops its own lane while it
// is alive, which gives every lane the same result.
//
// What bounds it: FP32 operations, 23 per (lane, table row) pair of the
// hit loop plus the winner's shading (bounce.cuh), against 13 words of
// state read and written per lane per segment.
//
// Design: one thread per lane (the state, the running closest hit and
// the RNG prefix in registers); the block stages the table's
// intersection columns in shared memory once (20 B a row, 10 KB for the
// 512-row cover scene), then each thread traces its lane to the end of
// the segment. No culling, no Morton sort: rows are in scene order.
// Dead lanes exit at once, so the trace around the kernel
// (ops/cuda_mega.mega_trace) groups live lanes between segments and
// launches only the live prefix.

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
mega_kernel(rtt::Scene scene, float* __restrict__ state, long long stride,
            int n, const int* __restrict__ pixel,
            const int* __restrict__ sample, int sample_scalar,
            int start_bounce, int max_depth, int* __restrict__ depth) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* s = state + i;
  rtt::Lane L;
  L.alive = s[12 * stride];
  if (!(L.alive > 0.0f)) return;  // dead lanes are left as they are
  L.ox = s[0];
  L.oy = s[stride];
  L.oz = s[2 * stride];
  L.dx = s[3 * stride];
  L.dy = s[4 * stride];
  L.dz = s[5 * stride];
  L.tpr = s[6 * stride];
  L.tpg = s[7 * stride];
  L.tpb = s[8 * stride];
  L.cr = s[9 * stride];
  L.cg = s[10 * stride];
  L.cb = s[11 * stride];

  const uint32_t pix = static_cast<uint32_t>(pixel[i]);
  const uint32_t smp =
      static_cast<uint32_t>(sample ? sample[i] : sample_scalar);
  const uint32_t lane_key = rtt::fold(rtt::fold(scene.seed, pix), smp);
  int b = 0;
  while (b < max_depth && L.alive > 0.0f) {
    rtt::do_bounce(scene, L,
                   rtt::fold(lane_key, static_cast<uint32_t>(start_bounce + b)));
    ++b;
  }
  if (scene.exhaust_bg && L.alive > 0.0f) rtt::exhaust(scene, L);

  s[0] = L.ox;
  s[stride] = L.oy;
  s[2 * stride] = L.oz;
  s[3 * stride] = L.dx;
  s[4 * stride] = L.dy;
  s[5 * stride] = L.dz;
  s[6 * stride] = L.tpr;
  s[7 * stride] = L.tpg;
  s[8 * stride] = L.tpb;
  s[9 * stride] = L.cr;
  s[10 * stride] = L.cg;
  s[11 * stride] = L.cb;
  s[12 * stride] = L.alive;
  if (depth) depth[i] += b;
}

}  // namespace

// table [rows, 17] f32 (ops/mega_tables.py); state [13, stride] f32, of
// which lanes [0, n) are traced in place; pixel [>= n] i32; sample
// [>= n] i32 or null (then every lane uses sample_scalar); depth
// [>= n] i32 or null (else each lane's bounce count is added to it).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mega_segment_launch(const float* table, int rows,
                                   float* state, long long stride, int n,
                                   const int* pixel, const int* sample,
                                   int sample_scalar, int start_bounce,
                                   int max_depth, RTT_SCENE_ARGS,
                                   int* depth, int threads, void* stream) {
  const rtt::Scene scene = rtt::make_scene(
      table, rows, seed, t_min, p_rr, rr_comp, grad_bg, bg_r, bg_g, bg_b,
      exhaust_bg);
  const size_t smem = rtt::table_smem_bytes(rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + threads - 1) / threads;
  mega_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, state, stride, n, pixel, sample, sample_scalar, start_bounce,
      max_depth, depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
