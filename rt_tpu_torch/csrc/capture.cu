// The tape-capture megakernel B4, by hand for Hopper (sm_90a): one
// full-path trace of fresh camera rays that records, per bounce, the
// closest-hit winner's tape code and, per lane, its death count. No
// radiance leaves the kernel: the capture is integer-valued and feeds the
// differentiable tape replay (diff/tape.py).
//
// Replaces: rt_tpu/ops/pallas_mega.py::_capture_kernel (:1978-2053), the
// Pallas TPU kernel launched by capture_segment (:2056, pallas_call
// :2097) and driven by mega_capture (:2144), for spheres, rects,
// cylinders and triangles with solid, checker and image textures, no
// NEE, the samplers "rng" and "qmc", and chunk culling. No code or death
// depends on a texel (a scatter's direction and its absorption read no
// albedo), so the kernel reads no atlas: it takes textured tables as they
// are. Contract kept from it: the 13-word state of fresh primary rays,
// per-lane pixel ids, one sample index, max_depth bounces from bounce 0;
// out codes [max_depth, B] int32 and death [B] int32, the number of
// bounces after which the lane is still alive (a lane runs bounce b iff
// death >= b). The code of a hit is `family << 24 | row` (family 0
// sphere, 1 rect, 2 cylinder, 3 triangle; row: the winner's SceneTables
// row, through bounce.cuh scene_row when the rows are Morton-sorted),
// -1 on a miss and at every bounce after the lane's death; the format
// needs row < 2^24 in every family (ops/cuda_mega.mega_capture raises
// above it). A lane that the roulette stops at bounce b still records
// that bounce's winner, as the TPU kernel evaluates the hit on every
// lane. The TPU loops a 2048-lane tile while any lane of it is alive;
// here a warp loops while any of its lanes is, which gives every lane
// the same codes.
//
// What bounds it: FP32 operations, as B2 (mega.cu): per (lane, table
// row) pair of the hit loop 23 for a sphere, 36 for a rect, 62 for a
// cylinder, 71 for a triangle, plus the ray setup and the winner's
// shading per ray-bounce; the writes are max_depth x B x 4 bytes of
// codes. Under culling the issue of the hit loop is the limit.
//
// Design: B2's warp loop. One thread per lane (the state, the running
// closest hit and the RNG prefix in registers); the block stages the
// table's intersection columns in shared memory once; the family rows
// are read through the read-only cache (kFamilies). The hit is the
// warp-cooperative one (do_bounce<..., kCapture, ...>, bounce.cuh
// warp_hit): a chunk that at most kDenseMax lanes of a warp need is
// tested by the whole warp, one needing ray at a time, with the per-lane
// loop's bits. So every thread of a warp enters every bounce's hit: a
// thread past n loads and stores nothing and only helps; a lane that
// dies (a miss, the roulette) stops advancing and helps until no lane of
// its warp is alive or the warp reaches max_depth. The lane that the
// roulette stops enters that bounce's hit as an active lane, writes its
// code and only then dies (bounce.cuh kCapture). The wrapper refuses a
// block that is not whole warps.
//
// Code stores: every lane of a warp that advances in an iteration is at
// the same bounce, the iteration's, so in iteration b every thread with
// a lane (i < n) writes row b: its code, or -1 once its lane is dead,
// and after the loop the rows [b, max_depth) with -1. Every store of a
// warp is then one 128-byte segment of one row, and each element of
// codes is written once, so the wrapper allocates codes with
// torch.empty. (Filling each lane's rows from its own death on, after
// the loop, would start the lanes of a warp at different rows and split
// each store over as many segments.)

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <bool kTail, bool kFamilies, bool kQmc>
__global__ void __launch_bounds__(kMaxThreads)
capture_kernel(rtt::Scene scene, const float* __restrict__ state,
               long long stride, int n, const int* __restrict__ pixel,
               int sample, int max_depth, int* __restrict__ codes,
               int* __restrict__ death) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  __syncthreads();

  // every thread of a warp stays to the end: one past n loads and stores
  // nothing and only helps with the hit
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = i < n;
  rtt::Lane L{};
  const uint32_t smp = static_cast<uint32_t>(sample);
  uint32_t lane_key = 0;
  if (mine) {
    rtt::load_lane(state + i, stride, L);
    lane_key = rtt::lane_key(scene.seed, static_cast<uint32_t>(pixel[i]),
                             smp, kQmc);
  }
  int* out = codes + i;
  // iteration b is bounce b of every lane that advances in it
  int b = 0, alive_after = 0;
  for (; b < max_depth; ++b) {
    const bool go = mine && L.alive > 0.0f;
    if (!__any_sync(rtt::kFull, go)) break;
    int code = -1;
    rtt::do_bounce<false, kTail, true, kFamilies, false, false, kQmc>(
        scene, L, rtt::draw_at(lane_key, smp, static_cast<uint32_t>(b)),
        rtt::Adj{}, &code, go);
    if (mine) out[static_cast<long long>(b) * stride] = code;
    if (go && L.alive > 0.0f) ++alive_after;
  }
  if (!mine) return;
  for (; b < max_depth; ++b) out[static_cast<long long>(b) * stride] = -1;
  death[i] = alive_after;
}

}  // namespace

// table [rows, 18] f32 (ops/mega_tables.py); rect, cyl, tri [n_*, 32]
// f32 or null with 0 rows; state [13, stride] f32 of
// fresh rays (read only), of which lanes [0, n) are traced; pixel [>= n]
// i32; one sample index for every lane; qmc, sbnd, tbnd, sph_rows,
// tri_rows as mega.cu's (a code names the SceneTables row); codes
// [max_depth, stride] i32
// and death [>= n] i32, written whole for lanes [0, n); threads a
// multiple of 32 (the wrapper checks). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int capture_launch(const float* table, int rows,
                              RTT_FAMILY_ARGS, const float* state,
                              long long stride, int n,
                              const int* pixel, int sample, int max_depth,
                              RTT_SCENE_ARGS, RTT_SORT_ARGS, int* codes,
                              int* death,
                              int threads, void* stream) {
  const rtt::Scene scene = rtt::with_sort(
      rtt::with_families(
          rtt::make_scene(table, rows, seed, t_min, p_rr, rr_comp, grad_bg,
                          bg_r, bg_g, bg_b, exhaust_bg),
          rect, n_rect, cyl, n_cyl, tri, n_tri),
      qmc, sbnd, tbnd, sph_rows, tri_rows);
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  const int blocks = (n + threads - 1) / threads;
  const bool fam = rtt::has_families(scene);
  const auto pick = [&](auto qmc_tag) {
    constexpr bool kQmc = decltype(qmc_tag)::value;
    return rtt::has_tail(rows)
               ? (fam ? capture_kernel<true, true, kQmc>
                      : capture_kernel<true, false, kQmc>)
               : (fam ? capture_kernel<false, true, kQmc>
                      : capture_kernel<false, false, kQmc>);
  };
  const auto kernel = qmc ? pick(std::true_type{}) : pick(std::false_type{});
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, state, stride, n, pixel, sample, max_depth, codes, death);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* capture_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
