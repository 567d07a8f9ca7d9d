// The persistent ray queue, by hand for Hopper (sm_90a).
//
// Replaces: rt_tpu/ops/pallas_queue.py::_queue_kernel (:122) with its
// survivor repack _pack_into (:75), the Pallas TPU kernel launched by
// queue_launch (:310, pallas_call :378) and driven by queue_trace
// (:404), for spheres, rects, cylinders and triangles with solid,
// checker and image textures (kImages), NEE / MIS / glossy light
// sampling (kNee), the samplers "rng" and "qmc", chunk culling.
// Contract kept from it:
// every primary ray (ro, rd, pixel, sample) is traced to its end
// through the same bounce body as the megakernel (bounce.cuh), one
// bounce per step, with the lane's own
// bounce counter as the RNG's bounce coordinate; depth exhaustion
// credits the sky per lane (exhaust_bg); the result is the [B, 3]
// radiance per input lane, equal to the megakernel's per lane and the
// same bits whatever the step budget per launch.
//
// What bounds it: the issue of the hit loop's instructions. Its FP32
// operations per (lane, row) pair, the bound chip_smoke.py reports, are
// 23 for a sphere, 36 for a rect, 62 for a cylinder and 71 for a
// triangle (FMA counted as two; plus the shading), against one read of
// each primary ray and one write of its radiance. Built without FMA
// contraction (bit-equal to the plain version) and with IEEE sqrt and
// division, a sphere row issues 55.5 instructions and a triangle row 134
// in the per-lane loops (cuobjdump -sass of this library, the
// instantiation with families: branches and the sqrt's range test
// included), so the issue rate alone puts a sphere row 4.8x above its
// FP32 bound. Under chunk culling the schedule costs more on top: a lane
// skips the chunks its ray misses, but a warp runs the union of its
// lanes' chunks with the others masked off, and after the first bounce a
// queue warp's lanes hold unrelated rays; on cover about half of that
// row loop ran masked (mega_plain.closest_hit.need, PERF.md).
//
// Design: persistent threads (the loop is queue.cuh's, shared with the
// adjoint B6), and a warp-cooperative closest hit (bounce.cuh warp_hit):
// every lane of a warp enters each step's hit together, and for each
// culled chunk the warp ballots the lanes whose ray needs it. When at
// most kDenseMax (16) lanes do, thread l holds row c + l and the warp
// takes the needing rays one after another, each tested against all 32
// rows at once: the ray's words shuffled from its lane, one row test per
// thread, __reduce_min_sync on the t's order key, a ballot for the last
// equal row and the winner's t shuffled back (77 instructions per (ray,
// chunk) for spheres, 128 for triangles). Above kDenseMax, as on most
// primary bounces, the needing lanes run the rows in turn. Both give the
// per-lane loop's bits: each (ray, row) t is the same expression, and
// "least t, ties to the last row, then `<=` against the running best" is
// the sequential `<=` loop. kDenseMax is a compile-time constant
// (RTT_DENSE_MAX) chosen on the card, where 16 beat 8, 24 and 32 on the
// default frame (PERF.md).
//
// The queue itself: the grid is what the card holds at once (SMs x
// resident blocks); each thread owns one pool lane and loops: when its
// lane is empty it takes the next fresh ray, and it advances its lane one
// bounce per step. The refill is the GPU form of the TPU's order-preserving
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

template <bool kTail, bool kFamilies, bool kNee, bool kImages, bool kQmc>
__global__ void __launch_bounds__(kThreads)
queue_kernel(rtt::SceneOf<kImages> scene, const float* __restrict__ ro,
             const float* __restrict__ rd, const int* __restrict__ pixel,
             const int* __restrict__ sample, int sample_scalar, int b,
             float* __restrict__ pool_f, int* __restrict__ pool_i,
             int pool_lanes, unsigned* __restrict__ counters,
             float* __restrict__ out, int* __restrict__ depth,
             int* __restrict__ written, int max_depth, int budget) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  __syncthreads();
  rtt::queue_loop<false, kTail, kFamilies, kNee, kImages, kQmc>(
      scene, ro, rd, pixel, sample, sample_scalar, nullptr, nullptr, b,
      pool_f, pool_i, pool_lanes, counters, out, nullptr, 0, nullptr, depth,
      written, max_depth, budget);
}

}  // namespace

// The instantiation a scene of `rows` sphere rows, with or without
// rect / cylinder / triangle rows and light sampling, runs, with image
// textures (kImages) or without, under the sampler kQmc selects.
template <bool kImages, bool kQmc>
static auto pick_kernel(int rows, bool families, bool nee) {
  return RTT_PICK(queue_kernel, rtt::has_tail(rows), families, nee, kImages,
                  kQmc);
}

// Blocks of `threads` threads the card holds at once with the table's
// shared memory: the persistent grid (negative: minus a CUDA error).
extern "C" int queue_grid_blocks(int rows, int families, int nee, int images,
                                 int qmc, int threads) {
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  int per_sm = 0, dev = 0, sms = 0;
  const auto occupancy = [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem);
  };
  const bool f = families != 0, e = nee != 0;
  cudaError_t err =
      images ? (qmc ? occupancy(pick_kernel<true, true>(rows, f, e))
                    : occupancy(pick_kernel<true, false>(rows, f, e)))
             : (qmc ? occupancy(pick_kernel<false, true>(rows, f, e))
                    : occupancy(pick_kernel<false, false>(rows, f, e)));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// table [rows, 18] f32; rect, cyl, tri [n_*, 32] f32 or null with 0
// rows; atlas [Ni, img_th, img_tw, 3] f32 and uv_rect, uv_cyl, uv_tri
// [n_*, 17] f32, or null (no image textures); lights [n_lights, 33] f32
// or null (no NEE), mis and glossy 0 / 1; qmc, sbnd, tbnd, sph_rows,
// tri_rows as mega.cu's; ro, rd [b, 3] f32; pixel [b]
// i32; sample [b] i32 or null (then sample_scalar); pool_f [13,
// blocks*threads] f32 and pool_i [4, blocks*threads] i32 (pool_i row 0 =
// -1 before the first launch); counters [2] u32 (fresh-ray cursor,
// lanes done; 0 before the first launch); out [b, 3] f32; depth [b] i32 or null (each lane's
// bounce count); written [b] i32 or null (+1 per completion, a check
// that every lane completes once). budget: steps per launch, 0 = until
// drained. Launches on `stream`; returns cudaGetLastError().
extern "C" int queue_launch(const float* table, int rows, RTT_FAMILY_ARGS,
                            RTT_IMG_ARGS, const float* ro, const float* rd,
                            const int* pixel,
                            const int* sample, int sample_scalar, int b,
                            float* pool_f, int* pool_i, unsigned* counters,
                            float* out, int* depth, int* written,
                            int max_depth, int budget, RTT_SCENE_ARGS,
                            RTT_SORT_ARGS, RTT_NEE_ARGS, int blocks,
                            int threads,
                            void* stream) {
  const rtt::Scene scene = rtt::with_nee(
      rtt::with_sort(
          rtt::with_families(
              rtt::make_scene(table, rows, seed, t_min, p_rr, rr_comp,
                              grad_bg, bg_r, bg_g, bg_b, exhaust_bg),
              rect, n_rect, cyl, n_cyl, tri, n_tri),
          qmc, sbnd, tbnd, sph_rows, tri_rows),
      lights, n_lights, mis, glossy);
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  const bool fam = rtt::has_families(scene), nee = rtt::has_nee(scene);
  const auto launch = [&](const auto& sc, auto kernel) {
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        sc, ro, rd, pixel, sample, sample_scalar, b, pool_f, pool_i,
        blocks * threads, counters, out, depth, written, max_depth, budget);
    return static_cast<int>(cudaGetLastError());
  };
  if (atlas) {
    const auto sc = rtt::with_images(scene, atlas, img_th, img_tw, uv_rect,
                                     uv_cyl, uv_tri);
    return qmc ? launch(sc, pick_kernel<true, true>(rows, fam, nee))
               : launch(sc, pick_kernel<true, false>(rows, fam, nee));
  }
  return qmc ? launch(scene, pick_kernel<false, true>(rows, fam, nee))
             : launch(scene, pick_kernel<false, false>(rows, fam, nee));
}

extern "C" const char* queue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
