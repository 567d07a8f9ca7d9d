// The forward megakernel, by hand for Hopper (sm_90a): one segment of a
// full-path trace.
//
// Replaces: rt_tpu/ops/pallas_mega.py::_mega_kernel (:1899-1976), the
// Pallas TPU kernel launched by mega_segment (:2460, pallas_call :2524),
// for spheres, rects, cylinders and triangles with solid, checker and
// image textures (kImages), NEE / MIS / glossy light sampling (kNee),
// the samplers "rng" and "qmc", and chunk culling.
// Contract kept from it: the 13-word ray state in and out (origin,
// direction, throughput, radiance, alive), per-lane pixel and sample
// ids, a start bounce that offsets the RNG's bounce coordinate, at most
// max_depth bounces, and the sky credited to lanes still alive when the
// segment is the last (exhaust_bg). The TPU loops a 2048-lane tile while
// any lane of it is alive; here a warp loops while any of its lanes has a
// bounce to go, and each lane advances only its own, which gives every
// lane the same result.
//
// What bounds it: FP32 operations, per (lane, table row) pair of the
// hit loop 23 for a sphere, 36 for a rect, 62 for a cylinder, 71 for a
// triangle, plus the winner's shading (bounce.cuh), against 13 words of
// state read and written per lane per segment. Under culling the issue
// of the hit loop is the limit: a warp runs the union of its lanes'
// chunks, with the lanes that skip a chunk masked off.
//
// Design: one thread per lane (the state, the running closest hit and
// the RNG prefix in registers); the block stages the table's
// intersection columns in shared memory once (20 B a row, 9.8 KB for
// the 488 live rows of the cover scene; rows past bounce.cuh's
// kStageRows are read from global memory); the rect, cylinder and
// triangle rows are read through the read-only cache (kFamilies, only
// for scenes that have them). With culling the rows are Morton-sorted
// and each lane skips the chunks its ray misses (bounce.cuh). The hit
// is the queue kernels' warp-cooperative one (do_bounce, bounce.cuh
// warp_hit): a chunk that at most kDenseMax lanes of a warp
// need is tested by the whole warp, one needing ray at a time, each
// thread against its own row, with the per-lane loop's bits. So every
// thread of a warp enters every bounce's hit: a thread past n, or whose
// lane is dead on entry, loads and stores nothing and only helps; a
// lane that dies (a miss, the roulette) or reaches max_depth stops
// advancing and helps until no lane of its warp has a bounce to go.
// The wrapper refuses a block that is not whole warps. A warp whose
// lanes are all dead costs nothing, so the trace around the kernel
// (ops/cuda_mega.mega_trace) groups live lanes between segments and
// launches only the live prefix.
//
// The families instantiations keep the dense triangle rows, though
// their 17 registers take them from 48 to 64: with only the sphere
// chunks dense, B2 was 14% slower on the mesh (PERF.md).

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <bool kTail, bool kFamilies, bool kNee, bool kImages, bool kQmc>
__global__ void __launch_bounds__(kMaxThreads)
mega_kernel(rtt::SceneOf<kImages> scene, float* __restrict__ state,
            long long stride,
            int n, const int* __restrict__ pixel,
            const int* __restrict__ sample, int sample_scalar,
            int start_bounce, int max_depth, int* __restrict__ depth) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  __syncthreads();

  // every thread of a warp stays to the end: one past n or with a dead
  // lane loads and stores nothing and only helps with the hit
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float* s = state + i;
  const bool mine = i < n && s[12 * stride] > 0.0f;
  rtt::Lane L{};
  uint32_t smp = 0, lane_key = 0;
  if (mine) {
    rtt::load_lane(s, stride, L);
    const uint32_t pix = static_cast<uint32_t>(pixel[i]);
    smp = static_cast<uint32_t>(sample ? sample[i] : sample_scalar);
    lane_key = rtt::lane_key(scene.seed, pix, smp, kQmc);
  }
  int b = 0;
  for (;;) {
    const bool go = mine && b < max_depth && L.alive > 0.0f;
    if (!__any_sync(rtt::kFull, go)) break;
    rtt::do_bounce<false, kTail, false, kFamilies, kNee, kImages, kQmc>(
        scene, L,
        rtt::draw_at(lane_key, smp, static_cast<uint32_t>(start_bounce + b)),
        rtt::Adj{}, nullptr, go);
    if (go) ++b;
  }
  if (!mine) return;
  if (scene.exhaust_bg && L.alive > 0.0f) rtt::exhaust(scene, L);

  rtt::store_lane(s, stride, L);
  if (depth) depth[i] += b;
}

}  // namespace

// table [rows, 18] f32 (ops/mega_tables.py); rect, cyl, tri
// [n_*, 32] f32 or null with 0 rows; atlas [Ni, img_th, img_tw, 3] f32
// and uv_rect, uv_cyl, uv_tri [n_*, 17] f32, or null (no image
// textures); lights [n_lights, 33] f32 or null (no NEE), mis and glossy
// 0 / 1; qmc 0 / 1, sbnd / tbnd [ceil(rows / 32), 8] and [ceil(n_tri /
// 32), 8] f32 chunk boxes and sph_rows [rows] / tri_rows [n_tri] i32, or
// null (that family unsorted); state [13, stride] f32, of
// which lanes [0, n) are traced in place; pixel [>= n] i32; sample
// [>= n] i32 or null (then every lane uses sample_scalar); depth
// [>= n] i32 or null (else each lane's bounce count is added to it).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mega_segment_launch(const float* table, int rows,
                                   RTT_FAMILY_ARGS, RTT_IMG_ARGS,
                                   float* state,
                                   long long stride, int n,
                                   const int* pixel, const int* sample,
                                   int sample_scalar, int start_bounce,
                                   int max_depth, RTT_SCENE_ARGS,
                                   RTT_SORT_ARGS, RTT_NEE_ARGS, int* depth,
                                   int threads, void* stream) {
  const rtt::Scene scene = rtt::with_nee(
      rtt::with_sort(
          rtt::with_families(
              rtt::make_scene(table, rows, seed, t_min, p_rr, rr_comp,
                              grad_bg, bg_r, bg_g, bg_b, exhaust_bg),
              rect, n_rect, cyl, n_cyl, tri, n_tri),
          qmc, sbnd, tbnd, sph_rows, tri_rows),
      lights, n_lights, mis, glossy);
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  const int blocks = (n + threads - 1) / threads;
  const bool tail = rtt::has_tail(rows), fam = rtt::has_families(scene),
             nee = rtt::has_nee(scene);
  const auto launch = [&](const auto& sc, auto kernel) {
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        sc, state, stride, n, pixel, sample, sample_scalar, start_bounce,
        max_depth, depth);
    return static_cast<int>(cudaGetLastError());
  };
  if (atlas) {
    const auto sc = rtt::with_images(scene, atlas, img_th, img_tw, uv_rect,
                                     uv_cyl, uv_tri);
    return qmc ? launch(sc, RTT_PICK(mega_kernel, tail, fam, nee, true,
                                     true))
               : launch(sc, RTT_PICK(mega_kernel, tail, fam, nee, true,
                                     false));
  }
  return qmc ? launch(scene, RTT_PICK(mega_kernel, tail, fam, nee, false,
                                      true))
             : launch(scene, RTT_PICK(mega_kernel, tail, fam, nee, false,
                                      false));
}

extern "C" const char* mega_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
