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
// intersection columns in shared memory once (20 B a row, 9.8 KB for
// the 488 live rows of the cover scene; rows past bounce.cuh's
// kStageRows are read from global memory), then each thread traces its
// lane to the end of the segment. No culling, no Morton sort: rows are in scene order.
// Dead lanes exit at once, so the trace around the kernel
// (ops/cuda_mega.mega_trace) groups live lanes between segments and
// launches only the live prefix.

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <bool kTail>
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
  if (!(s[12 * stride] > 0.0f)) return;  // dead lanes are left as they are
  rtt::Lane L;
  rtt::load_lane(s, stride, L);

  const uint32_t pix = static_cast<uint32_t>(pixel[i]);
  const uint32_t smp =
      static_cast<uint32_t>(sample ? sample[i] : sample_scalar);
  const uint32_t lane_key = rtt::fold(rtt::fold(scene.seed, pix), smp);
  int b = 0;
  while (b < max_depth && L.alive > 0.0f) {
    rtt::do_bounce<false, kTail>(
        scene, L, rtt::fold(lane_key, static_cast<uint32_t>(start_bounce + b)),
        rtt::Adj{});
    ++b;
  }
  if (scene.exhaust_bg && L.alive > 0.0f) rtt::exhaust(scene, L);

  rtt::store_lane(s, stride, L);
  if (depth) depth[i] += b;
}

}  // namespace

// table [rows, 18] f32 (ops/mega_tables.py); state [13, stride] f32, of
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
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  const int blocks = (n + threads - 1) / threads;
  const auto kernel =
      rtt::has_tail(rows) ? mega_kernel<true> : mega_kernel<false>;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, state, stride, n, pixel, sample, sample_scalar, start_bounce,
      max_depth, depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
