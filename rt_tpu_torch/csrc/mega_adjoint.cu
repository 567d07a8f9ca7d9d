// The adjoint megakernel B5, by hand for Hopper (sm_90a): one segment of
// the path-replay backward.
//
// Replaces: rt_tpu/ops/pallas_mega.py::_adjoint_kernel (:2183), the
// Pallas TPU kernel launched by adjoint_segment (:2568, pallas_call
// :2620) and driven by mega_trace_adjoint (:3079), for spheres with
// solid and checker textures, no NEE, sampler "rng", no image atlas.
// Contract kept from it: the forward megakernel's segment (mega.cu) with
// two more per-lane inputs, the sample's radiance L and its loss
// cotangent g, replayed bounce by bounce from the counter RNG with
// do_bounce<true> (bounce.cuh), which adds each bounce's suffix-identity
// cotangents to the winner's gradient slot; the output is the [8,
// n_slots] gradient block (rows 0-2 the primary colour, 3-5 the checker
// odd colour, row 6 columns 0-2 the constant background), summed over
// the blocks and the segments. With exhaust_bg (the last segment of an
// exact replay), a lane alive at the end adds g * P to the background.
//
// What bounds it: FP32 operations, as the forward (23 per lane-bounce
// and table row, bounce.cuh) plus a few per bounce for the cotangents,
// against 19 words of lane state read and 13 written per segment; the
// cotangent sums are float atomics on a few hot addresses (on the cover
// scene about half the lanes hit the ground's checker).
//
// Design: one thread per lane, as mega.cu. Each block keeps its own
// accumulators in shared memory (6 * n_slots + 3 floats, 24 KB for the
// cover scene's 1,024 slots), zeroed before the trace and added to the
// global block once at the end, non-zero entries only: the per-bounce
// atomics then stay on the SM. When the accumulators do not fit in the
// shared memory the wrapper allows (shared_acc = 0), the lanes add to
// the global block directly. The order of the float additions changes
// from run to run, so the sums agree with the plain version
// (ops/adjoint_plain.py) within float rounding, not bit for bit; every
// lane's path and cotangents are the plain version's bits (built with
// --fmad=false, as the forward).

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <bool kTail>
__global__ void __launch_bounds__(kMaxThreads)
mega_adjoint_kernel(rtt::Scene scene, float* __restrict__ state,
                    long long stride, int n, const int* __restrict__ pixel,
                    const int* __restrict__ sample, int sample_scalar,
                    int start_bounce, int max_depth, float* grad,
                    int n_slots, int shared_acc, int* __restrict__ depth) {
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

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float* s = state + i;
  // dead lanes and lanes past n trace nothing, but every thread reaches
  // the flush's __syncthreads
  if (i < n && s[12 * stride] > 0.0f) {
    rtt::Lane L;
    rtt::load_lane(s, stride, L);
    rtt::Adj adj{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, acc, n_slots};
    rtt::load_lg(s, stride, adj);

    const uint32_t pix = static_cast<uint32_t>(pixel[i]);
    const uint32_t smp =
        static_cast<uint32_t>(sample ? sample[i] : sample_scalar);
    const uint32_t lane_key = rtt::fold(rtt::fold(scene.seed, pix), smp);
    int b = 0;
    while (b < max_depth && L.alive > 0.0f) {
      rtt::do_bounce<true, kTail>(
          scene, L, rtt::fold(lane_key, static_cast<uint32_t>(start_bounce + b)),
          adj);
      ++b;
    }
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

// table [rows, 18] f32 (ops/mega_tables.py); state [19, stride] f32 (the
// forward's 13 rows, then L and g), of which lanes [0, n) are replayed
// in place; pixel [>= n] i32; sample [>= n] i32 or null (then
// sample_scalar); grad [8, n_slots] f32, added to; shared_acc: keep the
// block's accumulators in shared memory (6 * n_slots + 3 floats beside
// the staged table); depth [>= n] i32 or null (each lane's bounce count
// is added to it). Launches on `stream` and returns cudaGetLastError().
extern "C" int mega_adjoint_launch(const float* table, int rows,
                                   float* state, long long stride, int n,
                                   const int* pixel, const int* sample,
                                   int sample_scalar, int start_bounce,
                                   int max_depth, RTT_SCENE_ARGS,
                                   float* grad, int n_slots, int shared_acc,
                                   int* depth, int threads, void* stream) {
  const rtt::Scene scene = rtt::make_scene(
      table, rows, seed, t_min, p_rr, rr_comp, grad_bg, bg_r, bg_g, bg_b,
      exhaust_bg);
  const size_t smem =
      shared_acc ? rtt::after_table_bytes(rows) +
                       (rtt::kBgRow * static_cast<size_t>(n_slots) + 3) *
                           sizeof(float)
                 : rtt::table_smem_bytes(rows);
  const auto kernel = rtt::has_tail(rows) ? mega_adjoint_kernel<true>
                                          : mega_adjoint_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, state, stride, n, pixel, sample, sample_scalar, start_bounce,
      max_depth, grad, n_slots, shared_acc, depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mega_adjoint_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
