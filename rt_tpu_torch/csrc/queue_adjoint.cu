// The persistent queue's adjoint B6, by hand for Hopper (sm_90a).
//
// Replaces: rt_tpu/ops/pallas_queue.py::_queue_adjoint_kernel (:543),
// the Pallas TPU kernel launched by queue_adjoint_launch (:736,
// pallas_call :801) and driven by queue_trace_adjoint (:829), for
// spheres, rects, cylinders and triangles with solid, checker and image
// textures (kImages), NEE without MIS or glossy (kNee, as the
// reference's kernel, :564), the samplers "rng" and "qmc", chunk
// culling. Contract kept from it: the
// adjoint megakernel's replay
// (mega_adjoint.cu: do_bounce<true> of bounce.cuh, the same cotangents
// into the same [8, n_slots] gradient block and atlas gradient) inside
// the persistent ray
// queue of queue.cu. The pool carries each lane's L and g besides its
// state; its bounce counter is its RNG coordinate, so a lane's path and
// cotangents do not depend on which thread ran it or on the step budget.
// There is no radiance output; the gradient block persists across
// relaunches. With exhaust_bg, a lane alive at max_depth adds g * P to
// the background.
//
// What bounds it: as the forward B3 (queue.cu), the issue of the hit
// loop's instructions: per (lane, row) pair 23 FP32 operations for a
// sphere, 36 for a rect, 62 for a cylinder, 71 for a triangle (plus the
// shading and cotangents), issued without FMA contraction as about 55
// instructions a sphere row and 134 a triangle row, against one read of
// each primary ray, its L and g; under culling, on top, the rows a warp
// runs for the union of its lanes' chunks with most lanes masked.
//
// Design: queue.cu's persistent threads, warp refill and warp-cooperative
// closest hit (queue.cuh's loop, with kAdjoint: ballot, one atomicAdd per
// warp on the fresh-ray cursor, popc ranks; the pool carries L and g in
// rows 13-18; a chunk at most kDenseMax lanes need is tested by the whole
// warp, one needing ray at a time, bounce.cuh warp_hit), with the
// per-block accumulators of mega_adjoint.cu in shared memory, zeroed at
// the start of every launch and added to the global block at its end
// (or, when they do not fit, the global block directly); the family
// rows are read from global memory (kFamilies), so they take none of the
// shared memory the staged rows and the accumulators share. Float atomics
// sum in no fixed order: the gradients agree with the plain version and
// across step budgets within float rounding.

#include <cuda_runtime.h>

#include "queue.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTail, bool kFamilies, bool kNee, bool kImages, bool kQmc>
__global__ void __launch_bounds__(kThreads)
queue_adjoint_kernel(rtt::SceneOf<kImages> scene, const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const int* __restrict__ pixel,
                     const int* __restrict__ sample, int sample_scalar,
                     const float* __restrict__ lin,
                     const float* __restrict__ gin, int b,
                     float* __restrict__ pool_f, int* __restrict__ pool_i,
                     int pool_lanes, unsigned* __restrict__ counters,
                     float* grad, int n_slots, int shared_acc,
                     float* gimg, int* __restrict__ depth,
                     int* __restrict__ written, int max_depth, int budget) {
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
  rtt::queue_loop<true, kTail, kFamilies, kNee, kImages, kQmc>(
      scene, ro, rd, pixel, sample, sample_scalar, lin, gin, b, pool_f,
      pool_i, pool_lanes, counters, nullptr, acc, n_slots, gimg, depth,
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

// The instantiation a scene of `rows` sphere rows, with or without
// rect / cylinder / triangle rows and light sampling, runs, with image
// textures (kImages) or without, under the sampler kQmc selects.
template <bool kImages, bool kQmc>
auto pick(int rows, bool families, bool nee) {
  return RTT_PICK(queue_adjoint_kernel, rtt::has_tail(rows), families, nee,
                  kImages, kQmc);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Blocks of `threads` threads the card holds at once with the kernel's
// shared memory (the staged table, and the accumulators when
// shared_acc) and the registers of the instantiation the scene runs:
// the persistent grid (negative: minus a CUDA error).
extern "C" int queue_adjoint_grid_blocks(int rows, int families, int nee,
                                         int images, int qmc, int n_slots,
                                         int shared_acc, int threads) {
  const size_t smem = smem_bytes(rows, n_slots, shared_acc);
  int per_sm = 0, dev = 0, sms = 0;
  const auto occupancy = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    return e;
  };
  const bool f = families != 0, e = nee != 0;
  cudaError_t err =
      images ? (qmc ? occupancy(pick<true, true>(rows, f, e))
                    : occupancy(pick<true, false>(rows, f, e)))
             : (qmc ? occupancy(pick<false, true>(rows, f, e))
                    : occupancy(pick<false, false>(rows, f, e)));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// table [rows, 18] f32; rect, cyl, tri [n_*, 32] f32 or null with 0
// rows; atlas [Ni, img_th, img_tw, 3] f32 and uv_rect, uv_cyl, uv_tri
// [n_*, 17] f32, or null (no image textures); lights [n_lights, 33] f32
// or null (no NEE); qmc, sbnd, tbnd, sph_rows, tri_rows as mega.cu's;
// ro, rd, lin (L),
// gin (g) [b, 3] f32; pixel [b]
// i32; sample [b] i32 or null (then sample_scalar); pool_f [19,
// blocks*threads] f32 and pool_i [4, blocks*threads] i32 (pool_i row 0
// = -1 before the first launch); counters [2] u32 (fresh-ray cursor,
// lanes done; 0 before the first launch); grad [8, n_slots] f32, added
// to; shared_acc: the block's accumulators in shared memory; gimg [Ni *
// img_th * img_tw * 3] f32, added to, or null (no image textures); depth [b]
// i32 or null (each lane's bounce count); written [b] i32 or null (+1
// per completion). budget: steps per launch, 0 = until drained.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int queue_adjoint_launch(
    const float* table, int rows, RTT_FAMILY_ARGS, RTT_IMG_ARGS,
    const float* ro, const float* rd,
    const int* pixel, const int* sample, int sample_scalar, const float* lin,
    const float* gin, int b, float* pool_f, int* pool_i, unsigned* counters,
    float* grad, int n_slots, int shared_acc, float* gimg, int* depth,
    int* written, int max_depth, int budget, RTT_SCENE_ARGS, RTT_SORT_ARGS,
    const float* lights, int n_lights, int blocks, int threads,
    void* stream) {
  const rtt::Scene scene = rtt::with_nee(
      rtt::with_sort(
          rtt::with_families(
              rtt::make_scene(table, rows, seed, t_min, p_rr, rr_comp,
                              grad_bg, bg_r, bg_g, bg_b, exhaust_bg),
              rect, n_rect, cyl, n_cyl, tri, n_tri),
          qmc, sbnd, tbnd, sph_rows, tri_rows),
      lights, n_lights, 0, 0);
  const size_t smem = smem_bytes(rows, n_slots, shared_acc);
  const bool fam = rtt::has_families(scene), nee = rtt::has_nee(scene);
  const auto launch = [&](const auto& sc, auto kernel) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        sc, ro, rd, pixel, sample, sample_scalar, lin, gin, b, pool_f,
        pool_i, blocks * threads, counters, grad, n_slots, shared_acc, gimg,
        depth, written, max_depth, budget);
    return static_cast<int>(cudaGetLastError());
  };
  if (atlas) {
    const auto sc = rtt::with_images(scene, atlas, img_th, img_tw, uv_rect,
                                     uv_cyl, uv_tri);
    return qmc ? launch(sc, pick<true, true>(rows, fam, nee))
               : launch(sc, pick<true, false>(rows, fam, nee));
  }
  return qmc ? launch(scene, pick<false, true>(rows, fam, nee))
             : launch(scene, pick<false, false>(rows, fam, nee));
}

extern "C" const char* queue_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
