// The persistent ray queue, by hand for Hopper (sm_90a).
//
// Replaces: rt_tpu/ops/pallas_queue.py::_queue_kernel (:122) with its
// survivor repack _pack_into (:75), the Pallas TPU kernel launched by
// queue_launch (:310, pallas_call :378) and driven by queue_trace
// (:404), for spheres with solid and checker textures, no NEE, sampler
// "rng". Contract kept from it: every primary ray (ro, rd, pixel,
// sample) is traced to its end through the same bounce body as the
// megakernel (bounce.cuh), one bounce per step, with the lane's own
// bounce counter as the RNG's bounce coordinate; depth exhaustion
// credits the sky per lane (exhaust_bg); the result is the [B, 3]
// radiance per input lane, equal to the megakernel's per lane and the
// same bits whatever the step budget per launch.
//
// What bounds it: FP32 operations, as the megakernel (23 per lane-bounce
// and table row plus the shading), against one read of each primary ray
// and one write of its radiance.
//
// Design: persistent threads (the loop is queue.cuh's, shared with the
// adjoint B6). The grid is what the card holds at once (SMs x resident
// blocks); each thread owns one pool lane and loops: when its lane is
// empty it takes the next fresh ray, and it advances its lane one bounce
// per step. The refill is the GPU form of the TPU's order-preserving
// pack: __ballot_sync finds the warp's empty lanes, one atomicAdd per
// warp claims that many fresh indices from a global cursor (in index
// order, so fresh work stays screen-coherent), and __popc of the lower
// lanes' mask ranks each lane. A finished lane
// writes its radiance straight to out[slot]: the TPU's completion ring
// and slot sort exist only because a TPU scatter was slow
// (pallas_queue.py:28-31). A launch stops after `budget` steps (0: when
// the cursor is spent and the warp is empty); in-flight lanes are then
// saved to the pool in global memory and the next launch resumes them.
// The host relaunches until the done counter equals B.

#include <cuda_runtime.h>

#include "queue.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTail>
__global__ void __launch_bounds__(kThreads)
queue_kernel(rtt::Scene scene, const float* __restrict__ ro,
             const float* __restrict__ rd, const int* __restrict__ pixel,
             const int* __restrict__ sample, int sample_scalar, int b,
             float* __restrict__ pool_f, int* __restrict__ pool_i,
             int pool_lanes, unsigned* __restrict__ counters,
             float* __restrict__ out, int* __restrict__ depth,
             int* __restrict__ written, int max_depth, int budget) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  __syncthreads();
  rtt::queue_loop<false, kTail>(scene, ro, rd, pixel, sample, sample_scalar,
                                nullptr, nullptr, b, pool_f, pool_i,
                                pool_lanes, counters, out, nullptr, 0, depth,
                                written, max_depth, budget);
}

}  // namespace

// Blocks of `threads` threads the card holds at once with the table's
// shared memory: the persistent grid (negative: minus a CUDA error).
extern "C" int queue_grid_blocks(int rows, int threads) {
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  int per_sm = 0, dev = 0, sms = 0;
  const auto kernel =
      rtt::has_tail(rows) ? queue_kernel<true> : queue_kernel<false>;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// table [rows, 18] f32; ro, rd [b, 3] f32; pixel [b] i32; sample [b] i32
// or null (then sample_scalar); pool_f [13, blocks*threads] f32 and
// pool_i [4, blocks*threads] i32 (pool_i row 0 = -1 before the first
// launch); counters [2] u32 (fresh-ray cursor, lanes done; 0 before the
// first launch); out [b, 3] f32; depth [b] i32 or null (each lane's
// bounce count); written [b] i32 or null (+1 per completion, a check
// that every lane completes once). budget: steps per launch, 0 = until
// drained. Launches on `stream`; returns cudaGetLastError().
extern "C" int queue_launch(const float* table, int rows, const float* ro,
                            const float* rd, const int* pixel,
                            const int* sample, int sample_scalar, int b,
                            float* pool_f, int* pool_i, unsigned* counters,
                            float* out, int* depth, int* written,
                            int max_depth, int budget, RTT_SCENE_ARGS,
                            int blocks, int threads, void* stream) {
  const rtt::Scene scene = rtt::make_scene(
      table, rows, seed, t_min, p_rr, rr_comp, grad_bg, bg_r, bg_g, bg_b,
      exhaust_bg);
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  const auto kernel =
      rtt::has_tail(rows) ? queue_kernel<true> : queue_kernel<false>;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, ro, rd, pixel, sample, sample_scalar, b, pool_f, pool_i,
      blocks * threads, counters, out, depth, written, max_depth, budget);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* queue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
