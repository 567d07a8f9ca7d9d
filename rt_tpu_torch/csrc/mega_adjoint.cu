// The adjoint megakernel B5, by hand for Hopper (sm_90a): one segment of
// the path-replay backward.
//
// Replaces: rt_tpu/ops/pallas_mega.py::_adjoint_kernel (:2183), the
// Pallas TPU kernel launched by adjoint_segment (:2568, pallas_call
// :2620) and driven by mega_trace_adjoint (:3079), for spheres, rects,
// cylinders and triangles with solid, checker and image textures
// (kImages), NEE without MIS or glossy (kNee; the reference's kernel
// takes nee and n_lights only, :2203-2204), the samplers "rng" and
// "qmc", chunk culling.
// Contract kept from it: the forward megakernel's segment (mega.cu) with
// two more per-lane inputs, the sample's radiance L and its loss
// cotangent g, replayed bounce by bounce from the counter RNG with
// do_bounce<true> (bounce.cuh), which adds each bounce's suffix-identity
// cotangents to the winner's gradient slot (a sphere row's column 17, a
// family row's column 31); the output is the [8,
// n_slots] gradient block (rows 0-2 the primary colour, 3-5 the checker
// odd colour, row 6 columns 0-2 the constant background), summed over
// the blocks and the segments, and with image textures the atlas
// gradient [Ni, TH, TW, 3]: a texel-sampled winner's or light's
// cotangents go to its texel, not to its slot (:1741-1790). With
// exhaust_bg (the last segment of an exact replay), a lane alive at the
// end adds g * P to the background.
//
// What bounds it: FP32 operations, as the forward (per lane-bounce and
// table row 23 for a sphere, 36 for a rect, 62 for a cylinder, 71 for a
// triangle, bounce.cuh) plus a few per bounce for the cotangents,
// against 19 words of lane state read and 13 written per segment; the
// cotangent sums are float atomics on a few hot addresses (on the cover
// scene about half the lanes hit the ground's checker).
//
// Design: one thread per lane and mega.cu's warp loop, with the family
// rows read through the read-only cache (kFamilies). A warp loops while
// any of its lanes has a bounce to go, and every thread of it enters
// each bounce, do_bounce<true, ...>, whose closest hit is
// warp-cooperative (bounce.cuh warp_hit, as in B6): a culled chunk that
// at most kDenseMax lanes need is tested by the whole warp, one needing
// ray at a time. A thread past n, or whose lane is dead on entry, or
// that died or reached max_depth, only helps with the hit: do_bounce
// returns for it before the shading, so it adds nothing to the
// accumulators, and it loads and stores nothing. The wrapper refuses a
// block that is not whole warps. Each block keeps its own
// accumulators in shared memory (6 * n_slots + 3 floats, 24 KB for the
// cover scene's 1,024 slots), zeroed before the trace and added to the
// global block once at the end, non-zero entries only: the per-bounce
// atomics then stay on the SM. When the accumulators do not fit in the
// shared memory the wrapper allows (shared_acc = 0), the lanes add to
// the global block directly. The atlas gradient is added to in global
// memory, one atomicAdd per channel of a texel-sampled hit, whatever the
// atlas's size; many lanes of a magnified texture contend for one texel.
// The order of the float additions changes
// from run to run, so the sums agree with the plain version
// (ops/adjoint_plain.py) within float rounding, not bit for bit; every
// lane's path and cotangents are the plain version's bits (built with
// --fmad=false, as the forward).

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <bool kTail, bool kFamilies, bool kNee, bool kImages, bool kQmc>
__global__ void __launch_bounds__(kMaxThreads)
mega_adjoint_kernel(rtt::SceneOf<kImages> scene, float* __restrict__ state,
                    long long stride, int n, const int* __restrict__ pixel,
                    const int* __restrict__ sample, int sample_scalar,
                    int start_bounce, int max_depth, float* grad,
                    int n_slots, int shared_acc, float* gimg,
                    int* __restrict__ depth) {
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

  // every thread of a warp runs the loop and every thread of the block
  // reaches the flush's __syncthreads: one past n or with a dead lane
  // loads, credits and stores nothing and only helps with the hit
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float* s = state + i;
  const bool mine = i < n && s[12 * stride] > 0.0f;
  rtt::Lane L{};
  rtt::Adj adj{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, acc, n_slots, gimg};
  uint32_t smp = 0, lane_key = 0;
  if (mine) {
    rtt::load_lane(s, stride, L);
    rtt::load_lg(s, stride, adj);
    const uint32_t pix = static_cast<uint32_t>(pixel[i]);
    smp = static_cast<uint32_t>(sample ? sample[i] : sample_scalar);
    lane_key = rtt::lane_key(scene.seed, pix, smp, kQmc);
  }
  int b = 0;
  for (;;) {
    const bool go = mine && b < max_depth && L.alive > 0.0f;
    if (!__any_sync(rtt::kFull, go)) break;
    rtt::do_bounce<true, kTail, false, kFamilies, kNee, kImages, kQmc>(
        scene, L,
        rtt::draw_at(lane_key, smp, static_cast<uint32_t>(start_bounce + b)),
        adj, nullptr, go);
    if (go) ++b;
  }
  if (mine) {
    if (scene.exhaust_bg && L.alive > 0.0f) {
      rtt::credit_bg(scene, L, adj);
      rtt::exhaust(scene, L);
    }
    rtt::store_lane(s, stride, L);
    if (depth) depth[i] += b;
  }

  if (shared_acc) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
      const float v = acc[k];
      if (v != 0.0f) atomicAdd(grad + k, v);
    }
  }
}

}  // namespace

// table [rows, 18] f32 (ops/mega_tables.py); rect, cyl, tri [n_*, 32]
// f32 or null with 0 rows; atlas [Ni, img_th, img_tw, 3] f32 and uv_rect,
// uv_cyl, uv_tri [n_*, 17] f32, or null (no image textures); qmc, sbnd,
// tbnd, sph_rows, tri_rows as mega_segment_launch's; lights
// [n_lights, 33] f32 or null (no NEE); state [19, stride] f32 (the
// forward's 13 rows, then L and g), of which lanes [0, n) are replayed
// in place; pixel [>= n] i32; sample [>= n] i32 or null (then
// sample_scalar); grad [8, n_slots] f32, added to; shared_acc: keep the
// block's accumulators in shared memory (6 * n_slots + 3 floats beside
// the staged table); gimg [Ni * img_th * img_tw * 3] f32, added to, or
// null (no image textures); depth [>= n] i32 or null (each lane's bounce
// count is added to it). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mega_adjoint_launch(const float* table, int rows,
                                   RTT_FAMILY_ARGS, RTT_IMG_ARGS,
                                   float* state,
                                   long long stride, int n,
                                   const int* pixel, const int* sample,
                                   int sample_scalar, int start_bounce,
                                   int max_depth, RTT_SCENE_ARGS,
                                   RTT_SORT_ARGS,
                                   const float* lights, int n_lights,
                                   float* grad, int n_slots, int shared_acc,
                                   float* gimg, int* depth, int threads,
                                   void* stream) {
  const rtt::Scene scene = rtt::with_nee(
      rtt::with_sort(
          rtt::with_families(
              rtt::make_scene(table, rows, seed, t_min, p_rr, rr_comp,
                              grad_bg, bg_r, bg_g, bg_b, exhaust_bg),
              rect, n_rect, cyl, n_cyl, tri, n_tri),
          qmc, sbnd, tbnd, sph_rows, tri_rows),
      lights, n_lights, 0, 0);
  const size_t smem =
      shared_acc ? rtt::after_table_bytes(rows) +
                       (rtt::kBgRow * static_cast<size_t>(n_slots) + 3) *
                           sizeof(float)
                 : rtt::table_smem_bytes(rows);
  const int blocks = (n + threads - 1) / threads;
  const bool tail = rtt::has_tail(rows), fam = rtt::has_families(scene),
             nee = rtt::has_nee(scene);
  const auto launch = [&](const auto& sc, auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        sc, state, stride, n, pixel, sample, sample_scalar, start_bounce,
        max_depth, grad, n_slots, shared_acc, gimg, depth);
    return static_cast<int>(cudaGetLastError());
  };
  if (atlas) {
    const auto sc = rtt::with_images(scene, atlas, img_th, img_tw, uv_rect,
                                     uv_cyl, uv_tri);
    return qmc ? launch(sc, RTT_PICK(mega_adjoint_kernel, tail, fam, nee,
                                     true, true))
               : launch(sc, RTT_PICK(mega_adjoint_kernel, tail, fam, nee,
                                     true, false));
  }
  return qmc ? launch(scene, RTT_PICK(mega_adjoint_kernel, tail, fam, nee,
                                      false, true))
             : launch(scene, RTT_PICK(mega_adjoint_kernel, tail, fam, nee,
                                      false, false));
}

extern "C" const char* mega_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
