// The persistent queue's adjoint B6, by hand for Hopper (sm_90a).
//
// Replaces: rt_tpu/ops/pallas_queue.py::_queue_adjoint_kernel (:543),
// the Pallas TPU kernel launched by queue_adjoint_launch (:736,
// pallas_call :801) and driven by queue_trace_adjoint (:829), for
// spheres with solid and checker textures, no NEE, sampler "rng", no
// image atlas. Contract kept from it: the adjoint megakernel's replay
// (mega_adjoint.cu: do_bounce<true> of bounce.cuh, the same cotangents
// into the same [8, n_slots] gradient block) inside the persistent ray
// queue of queue.cu. The pool carries each lane's L and g besides its
// state; its bounce counter is its RNG coordinate, so a lane's path and
// cotangents do not depend on which thread ran it or on the step budget.
// There is no radiance output; the gradient block persists across
// relaunches. With exhaust_bg, a lane alive at max_depth adds g * P to
// the background.
//
// What bounds it: as the adjoint megakernel, FP32 operations (23 per
// lane-bounce and table row plus the shading and cotangents), against
// one read of each primary ray, its L and g.
//
// Design: queue.cu's persistent threads and warp refill (queue.cuh's
// loop, with kAdjoint: ballot, one atomicAdd per warp on the fresh-ray
// cursor, popc ranks; the pool carries L and g in rows 13-18), with the
// per-block accumulators of mega_adjoint.cu in shared memory, zeroed at
// the start of every launch and added to the global block at its end
// (or, when they do not fit, the global block directly). Float atomics
// sum in no fixed order: the gradients agree with the plain version and
// across step budgets within float rounding.

#include <cuda_runtime.h>

#include "queue.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTail>
__global__ void __launch_bounds__(kThreads)
queue_adjoint_kernel(rtt::Scene scene, const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const int* __restrict__ pixel,
                     const int* __restrict__ sample, int sample_scalar,
                     const float* __restrict__ lin,
                     const float* __restrict__ gin, int b,
                     float* __restrict__ pool_f, int* __restrict__ pool_i,
                     int pool_lanes, unsigned* __restrict__ counters,
                     float* grad, int n_slots, int shared_acc,
                     int* __restrict__ depth, int* __restrict__ written,
                     int max_depth, int budget) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  const int n_acc = rtt::kBgRow * n_slots + 3;
  float* acc = grad;
  if (shared_acc) {
    acc = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                   rtt::after_table_bytes(scene.n));
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) acc[k] = 0.0f;
  }
  __syncthreads();
  rtt::queue_loop<true, kTail>(scene, ro, rd, pixel, sample, sample_scalar,
                               lin, gin, b, pool_f, pool_i, pool_lanes,
                               counters, nullptr, acc, n_slots, depth,
                               written, max_depth, budget);
  if (shared_acc) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
      const float v = acc[k];
      if (v != 0.0f) atomicAdd(grad + k, v);
    }
  }
}

size_t smem_bytes(int rows, int n_slots, int shared_acc) {
  return shared_acc ? rtt::after_table_bytes(rows) +
                          (rtt::kBgRow * static_cast<size_t>(n_slots) + 3) *
                              sizeof(float)
                    : rtt::table_smem_bytes(rows);
}

using Kernel = decltype(&queue_adjoint_kernel<false>);

Kernel pick(int rows) {
  return rtt::has_tail(rows) ? queue_adjoint_kernel<true>
                             : queue_adjoint_kernel<false>;
}

cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Blocks of `threads` threads the card holds at once with the kernel's
// shared memory (the staged table, and the accumulators when
// shared_acc): the persistent grid (negative: minus a CUDA error).
extern "C" int queue_adjoint_grid_blocks(int rows, int n_slots,
                                         int shared_acc, int threads) {
  const size_t smem = smem_bytes(rows, n_slots, shared_acc);
  const Kernel kernel = pick(rows);
  cudaError_t err = allow_smem(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// table [rows, 18] f32; ro, rd, lin (L), gin (g) [b, 3] f32; pixel [b]
// i32; sample [b] i32 or null (then sample_scalar); pool_f [19,
// blocks*threads] f32 and pool_i [4, blocks*threads] i32 (pool_i row 0
// = -1 before the first launch); counters [2] u32 (fresh-ray cursor,
// lanes done; 0 before the first launch); grad [8, n_slots] f32, added
// to; shared_acc: the block's accumulators in shared memory; depth [b]
// i32 or null (each lane's bounce count); written [b] i32 or null (+1
// per completion). budget: steps per launch, 0 = until drained.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int queue_adjoint_launch(
    const float* table, int rows, const float* ro, const float* rd,
    const int* pixel, const int* sample, int sample_scalar, const float* lin,
    const float* gin, int b, float* pool_f, int* pool_i, unsigned* counters,
    float* grad, int n_slots, int shared_acc, int* depth, int* written,
    int max_depth, int budget, RTT_SCENE_ARGS, int blocks, int threads,
    void* stream) {
  const rtt::Scene scene = rtt::make_scene(
      table, rows, seed, t_min, p_rr, rr_comp, grad_bg, bg_r, bg_g, bg_b,
      exhaust_bg);
  const size_t smem = smem_bytes(rows, n_slots, shared_acc);
  const Kernel kernel = pick(rows);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, ro, rd, pixel, sample, sample_scalar, lin, gin, b, pool_f,
      pool_i, blocks * threads, counters, grad, n_slots, shared_acc, depth,
      written, max_depth, budget);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* queue_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
