// The sample-regeneration megakernel, by hand for Hopper (sm_90a): the
// whole spp loop of a pixel batch in one launch.
//
// Replaces: rt_tpu/ops/pallas_mega.py::_regen_kernel (:2288-2458), the
// Pallas TPU kernel launched by mega_regen (:3226, pallas_call :3276),
// for spheres, rects, cylinders and triangles with solid, checker and
// image textures (kImages), no NEE, the samplers "rng" and "qmc" (also
// for the camera rays), chunk culling.
// Contract kept from it: each lane owns one pixel and owes the samples
// [sample_base, sample_base + spp); it carries its sample and bounce
// counters (samp, bvec) beside the 13-word ray state, and each of at
// most seg_iters iterations, while the lane is pending (alive, or a
// sample still owed), does in this order: (1) a lane alive at bounce
// max_depth is retired, with the sky credited when exhaust_bg; (2) a
// dead lane that owes a sample starts the next one: samp + 1, bvec 0,
// its camera ray (camera.cuh), throughput 1, alive; (3) one bounce at
// RNG coordinates (seed, pixel, samp, bvec), then bvec + 1. The radiance
// rows sum every sample's path in sample order, as the per-sample
// launches of mega.cu summed by the renderer do: a path adds at most one
// non-zero term (a miss, a light, or the exhausted sky), so the sums
// round alike. With `init`, segment 0 makes sample_base's camera rays
// here; later segments resume the state, samp and bvec they are given,
// so a capped segment resumed later equals one uncapped run. The TPU
// loops a 2048-lane tile while any lane of it is pending; here a warp
// loops while any of its lanes is, and each lane advances only while it
// is pending itself, which gives every lane the same state, samp and
// bvec (a finished lane's bvec stops counting, as the plain version's).
//
// What bounds it: FP32 operations, as mega.cu: per (lane, table row)
// pair of the hit loop 23 for a sphere, 36 for a rect, 62 for a
// cylinder, 71 for a triangle, 16 of ray setup and the winner's shading
// per ray-bounce, plus one camera ray per sample; 13 state words and four
// ints per lane are read and written once per segment.
//
// Design: one thread per lane; the block stages the table's hit columns
// in shared memory (bounce.cuh) and the warp runs mega.cu's loop around
// its bounce, do_bounce<false, kTail, false, kFamilies, ...>,
// with the camera ray made in registers. Each iteration every thread of
// the warp computes whether its lane is pending, the warp leaves when
// none is (__any_sync), the pending lanes take steps (1) and (2) each
// for itself, and then every thread enters the bounce, whose closest
// hit is warp-cooperative (bounce.cuh warp_hit: a culled chunk that at
// most kDenseMax lanes need is tested by the whole warp, one needing ray
// at a time, with the per-lane loop's bits); a lane that is alive after
// step (2) advances, the others only help. So no thread leaves before
// the loop ends: a thread past n, or whose lane is not pending on entry,
// loads and stores nothing and only helps. A warp runs to its slowest
// lane over spp samples rather than over one, so its lanes stay busy
// until the last sample's tail. The wrapper refuses a block that is not
// whole warps. The trace around it (ops/cuda_mega.mega_trace_regen) may
// cap segments by seg_iters and group pending lanes between them.

#include <cuda_runtime.h>

#include "bounce.cuh"
#include "camera.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <bool kTail, bool kFamilies, bool kImages, bool kQmc>
__global__ void __launch_bounds__(kMaxThreads)
regen_kernel(rtt::SceneOf<kImages> scene, rtt::Camera cam,
             float* __restrict__ state,
             long long stride, int n, const int* __restrict__ pixel,
             const int* __restrict__ py, int* __restrict__ samp,
             int* __restrict__ bvec, int sample_base, int spp, int seg_iters,
             int max_depth, int init, int* __restrict__ depth) {
  extern __shared__ float4 smem[];
  rtt::stage_table(scene, smem);
  __syncthreads();

  // every thread of a warp stays to the end: one past n, or whose lane is
  // not pending on entry, loads and stores nothing and only helps
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float* s = state + i;
  const int end = sample_base + spp;  // the first sample not owed
  rtt::Lane L{};
  int sm = 0, bv = 0, x = 0, y = 0;
  uint32_t pix = 0;
  float ro[3], rd[3];
  bool mine = i < n;
  if (mine) {
    pix = static_cast<uint32_t>(pixel[i]);
    y = py[i];
    x = pixel[i] - y * cam.width;
    if (init) {
      sm = sample_base;
      rtt::camera_ray<kQmc>(cam, scene.seed, pix, x, y,
                            static_cast<uint32_t>(sm), ro, rd);
      L = rtt::Lane{ro[0], ro[1], ro[2], rd[0], rd[1], rd[2], 1.0f, 1.0f,
                    1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    } else {
      sm = samp[i];
      bv = bvec[i];
      mine = s[12 * stride] > 0.0f || sm + 1 < end;  // pending on entry
      if (mine) rtt::load_lane(s, stride, L);
    }
  }

  int bounces = 0;
  for (int it = 0; it < seg_iters; ++it) {  // seg_iters: warp-uniform
    const bool pending = mine && (L.alive > 0.0f || sm + 1 < end);
    if (!__any_sync(rtt::kFull, pending)) break;
    if (pending) {
      if (L.alive > 0.0f && bv >= max_depth) {  // (1) depth ran out
        if (scene.exhaust_bg) rtt::exhaust(scene, L);
        L.alive = 0.0f;
      }
      if (L.alive == 0.0f && sm + 1 < end) {  // (2) the next sample
        ++sm;
        bv = 0;
        rtt::camera_ray<kQmc>(cam, scene.seed, pix, x, y,
                              static_cast<uint32_t>(sm), ro, rd);
        L.ox = ro[0];
        L.oy = ro[1];
        L.oz = ro[2];
        L.dx = rd[0];
        L.dy = rd[1];
        L.dz = rd[2];
        L.tpr = L.tpg = L.tpb = 1.0f;
        L.alive = 1.0f;
      }
    }
    // (3) one bounce: every thread of the warp enters it
    const bool go = pending && L.alive > 0.0f;
    rtt::do_bounce<false, kTail, false, kFamilies, false, kImages, kQmc>(
        scene, L,
        rtt::draw_at(rtt::lane_key(scene.seed, pix,
                                   static_cast<uint32_t>(sm), kQmc),
                     static_cast<uint32_t>(sm), static_cast<uint32_t>(bv)),
        rtt::Adj{}, nullptr, go);
    if (go) ++bounces;
    if (pending) ++bv;  // only a lane pending at the top counts
  }
  if (!mine) return;

  rtt::store_lane(s, stride, L);
  samp[i] = sm;
  bvec[i] = bv;
  if (depth) depth[i] += bounces;
}

}  // namespace

// table [rows, 18] f32 (ops/mega_tables.py); rect, cyl, tri [n_*, 32]
// f32 or null with 0 rows; atlas [Ni, img_th, img_tw, 3] f32 and
// uv_rect, uv_cyl, uv_tri [n_*, 17] f32, or null (no image textures);
// qmc, sbnd, tbnd, sph_rows, tri_rows as mega.cu's (qmc also for the
// camera rays); cam: 19 host floats
// (ops/camera.camera_vec), read before the launch; state [13, stride]
// f32, of which lanes [0, n) advance in place; pixel, py [>= n] i32;
// samp, bvec [>= n] i32, read unless init and written; depth [>= n] i32
// or null (else each lane's bounce count is added to it). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mega_regen_launch(const float* table, int rows,
                                 RTT_FAMILY_ARGS, RTT_IMG_ARGS,
                                 const float* cam,
                                 float* state, long long stride, int n,
                                 const int* pixel, const int* py,
                                 int* samp, int* bvec, int sample_base,
                                 int spp, int seg_iters,
                                 int max_depth, int init, int width,
                                 int height, int defocus, RTT_SCENE_ARGS,
                                 RTT_SORT_ARGS,
                                 int* depth, int threads, void* stream) {
  const rtt::Scene scene = rtt::with_sort(
      rtt::with_families(
          rtt::make_scene(table, rows, seed, t_min, p_rr, rr_comp, grad_bg,
                          bg_r, bg_g, bg_b, exhaust_bg),
          rect, n_rect, cyl, n_cyl, tri, n_tri),
      qmc, sbnd, tbnd, sph_rows, tri_rows);
  const rtt::Camera camera = rtt::make_camera(cam, width, height, defocus);
  const size_t smem = rtt::table_smem_bytes(rows);  // <= 40 KB
  const int blocks = (n + threads - 1) / threads;
  const bool tail = rtt::has_tail(rows), fam = rtt::has_families(scene);
  const auto launch = [&](const auto& sc, auto kernel) {
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        sc, camera, state, stride, n, pixel, py, samp, bvec, sample_base,
        spp, seg_iters, max_depth, init, depth);
    return static_cast<int>(cudaGetLastError());
  };
  // the instantiation of the scene's tail, families, images and sampler
  const auto pick = [&](auto img_tag, auto qmc_tag) {
    constexpr bool kImg = decltype(img_tag)::value;
    constexpr bool kQ = decltype(qmc_tag)::value;
    return tail ? (fam ? regen_kernel<true, true, kImg, kQ>
                       : regen_kernel<true, false, kImg, kQ>)
                : (fam ? regen_kernel<false, true, kImg, kQ>
                       : regen_kernel<false, false, kImg, kQ>);
  };
  if (atlas) {
    const auto sc = rtt::with_images(scene, atlas, img_th, img_tw, uv_rect,
                                     uv_cyl, uv_tri);
    return qmc ? launch(sc, pick(std::true_type{}, std::true_type{}))
               : launch(sc, pick(std::true_type{}, std::false_type{}));
  }
  return qmc ? launch(scene, pick(std::false_type{}, std::true_type{}))
             : launch(scene, pick(std::false_type{}, std::false_type{}));
}

extern "C" const char* mega_regen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
