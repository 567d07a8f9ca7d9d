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
// NEE, the samplers "rng" and "qmc", chunk culling. No code or death
// depends on a texel (a scatter's direction and its absorption read no
// albedo), so the kernel reads no
// atlas: it takes textured tables as they are. Contract kept from it: the
// 13-word state of fresh primary rays, per-lane pixel ids, one sample
// index, max_depth bounces from bounce 0; out codes [max_depth, B] int32
// (`ptype << 24 | pid`, -1 on a miss) and death [B] int32, the number of
// bounces after which the lane is still alive (a lane runs bounce b iff
// death >= b). A lane that roulette stops at bounce b still records that
// bounce's winner (do_bounce<..., kCapture> runs the hit pass before the
// roulette), as the TPU kernel evaluates the hit on every lane.
//
// The code of a hit is `family << 24 | row` (family 0 sphere, 1 rect, 2
// cylinder, 3 triangle; row: the winner's row in its family's packed
// table). That row is the pid only because the port keeps every table in
// scene order, with no Morton sort (ROADMAP C-3); when chunk culling is
// ported the code needs a column of its own, as the reference's code
// tables. The format needs row < 2^24 in every family
// (ops/cuda_mega.mega_capture raises above it);
// the TPU's float32 extraction bound on the ids (pallas_mega.py:1499,
// ROADMAP C-2) does not apply: ids are int32 here.
//
// Fill: the kernel writes every row of codes, -1 for each bounce after
// the lane's death, so the wrapper allocates codes with torch.empty.
//
// What bounds it: FP32 operations, as B2 (mega.cu): per (lane, table
// row) pair of the hit loop 23 for a sphere, 36 for a rect, 62 for a
// cylinder, 71 for a triangle, plus the ray setup and the winner's
// shading per ray-bounce; the writes are max_depth x B x 4 bytes of
// codes.
//
// Design: one thread per lane, its state and RNG prefix in registers, the
// table's intersection columns staged in shared memory by the block once
// (bounce.cuh), the family rows read through the read-only cache
// (kFamilies, only for scenes that have them); each thread traces its
// lane with do_bounce<false, kTail, true, kFamilies> and writes its code
// at each bounce as codes[b * B + i], so a warp's 32 stores are one
// coalesced 128-byte row segment.

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

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rtt::Lane L;
  rtt::load_lane(state + i, stride, L);

  const uint32_t smp = static_cast<uint32_t>(sample);
  const uint32_t lane_key = rtt::lane_key(
      scene.seed, static_cast<uint32_t>(pixel[i]), smp, kQmc);
  int* out = codes + i;
  int b = 0, alive_after = 0;
  while (b < max_depth && L.alive > 0.0f) {
    int code = -1;
    rtt::do_bounce<false, kTail, true, kFamilies, false, false, kQmc>(
        scene, L, rtt::draw_at(lane_key, smp, static_cast<uint32_t>(b)),
        rtt::Adj{}, &code);
    out[static_cast<long long>(b) * stride] = code;
    if (L.alive > 0.0f) ++alive_after;
    ++b;
  }
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
// and death [>= n] i32, written whole for lanes [0, n). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
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
