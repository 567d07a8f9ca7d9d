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
// Design: persistent threads. The grid is what the card holds at once
// (SMs x resident blocks); each thread owns one pool lane and loops:
// when its lane is empty it takes the next fresh ray, and it advances
// its lane one bounce per step. The refill is the GPU form of the TPU's
// order-preserving pack: __ballot_sync finds the warp's empty lanes, one
// atomicAdd per warp claims that many fresh indices from a global
// cursor (in index order, so fresh work stays screen-coherent), and
// __popc of the lower lanes' mask ranks each lane. A finished lane
// writes its radiance straight to out[slot]: the TPU's completion ring
// and slot sort exist only because a TPU scatter was slow
// (pallas_queue.py:28-31). A launch stops after `budget` steps (0: when
// the cursor is spent and the warp is empty); in-flight lanes are then
// saved to the pool in global memory and the next launch resumes them.
// The host relaunches until the done counter equals B.

#include <cuda_runtime.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The pool holds, per lane, 13 f32 state rows (pool_f) and 4 i32 rows
// (pool_i: slot or -1 for an empty lane, pixel, sample, bounce).

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

  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const long long P = pool_lanes;
  rtt::Lane L;
  int slot = pool_i[tid];
  uint32_t lane_key = 0;
  int bounce = 0;
  if (slot >= 0) {  // resume the lane a previous launch saved
    L.ox = pool_f[tid];
    L.oy = pool_f[P + tid];
    L.oz = pool_f[2 * P + tid];
    L.dx = pool_f[3 * P + tid];
    L.dy = pool_f[4 * P + tid];
    L.dz = pool_f[5 * P + tid];
    L.tpr = pool_f[6 * P + tid];
    L.tpg = pool_f[7 * P + tid];
    L.tpb = pool_f[8 * P + tid];
    L.cr = pool_f[9 * P + tid];
    L.cg = pool_f[10 * P + tid];
    L.cb = pool_f[11 * P + tid];
    L.alive = pool_f[12 * P + tid];
    lane_key = rtt::fold(rtt::fold(scene.seed, static_cast<uint32_t>(
                                                   pool_i[P + tid])),
                         static_cast<uint32_t>(pool_i[2 * P + tid]));
    bounce = pool_i[3 * P + tid];
  }
  int pix = slot >= 0 ? pool_i[P + tid] : 0;
  int smp = slot >= 0 ? pool_i[2 * P + tid] : 0;

  bool drained = false;  // warp-uniform: the cursor has passed b
  unsigned completed = 0;
  for (int step = 0; budget <= 0 || step < budget; ++step) {
    // ---- refill the warp's empty lanes in index order ----
    const unsigned empty = __ballot_sync(kFull, slot < 0);
    if (empty && !drained) {
      const int leader = __ffs(empty) - 1;
      unsigned base = 0;
      if (static_cast<int>(lane) == leader) {
        // once the cursor has passed b it stays put: no claim overshoots
        // it by more than one warp's lanes per launch
        base = *reinterpret_cast<volatile unsigned*>(&counters[0]);
        if (base < static_cast<unsigned>(b))
          base = atomicAdd(&counters[0], static_cast<unsigned>(__popc(empty)));
      }
      base = __shfl_sync(kFull, base, leader);
      if (base + static_cast<unsigned>(__popc(empty)) >=
          static_cast<unsigned>(b))
        drained = true;
      if (slot < 0) {
        const unsigned idx = base + __popc(empty & ((1u << lane) - 1u));
        if (idx < static_cast<unsigned>(b)) {
          slot = static_cast<int>(idx);
          const size_t k = 3 * static_cast<size_t>(idx);
          L.ox = ro[k];
          L.oy = ro[k + 1];
          L.oz = ro[k + 2];
          L.dx = rd[k];
          L.dy = rd[k + 1];
          L.dz = rd[k + 2];
          L.tpr = L.tpg = L.tpb = 1.0f;
          L.cr = L.cg = L.cb = 0.0f;
          L.alive = 1.0f;
          pix = pixel[idx];
          smp = sample ? sample[idx] : sample_scalar;
          lane_key = rtt::fold(rtt::fold(scene.seed, static_cast<uint32_t>(pix)),
                               static_cast<uint32_t>(smp));
          bounce = 0;
        }
      }
    }
    if (!__any_sync(kFull, slot >= 0)) break;  // warp empty, cursor spent

    if (slot >= 0) {
      // ---- one bounce; then exhaustion and retirement ----
      if (bounce < max_depth && L.alive > 0.0f) {
        rtt::do_bounce(scene, L,
                       rtt::fold(lane_key, static_cast<uint32_t>(bounce)));
        ++bounce;
      }
      if (L.alive > 0.0f && bounce >= max_depth) {
        if (scene.exhaust_bg) rtt::exhaust(scene, L);
        L.alive = 0.0f;
      }
      if (!(L.alive > 0.0f)) {
        const size_t k = 3 * static_cast<size_t>(slot);
        out[k] = L.cr;
        out[k + 1] = L.cg;
        out[k + 2] = L.cb;
        if (depth) depth[slot] = bounce;
        if (written) atomicAdd(&written[slot], 1);
        ++completed;
        slot = -1;
      }
    }
  }

  // ---- save the lane for the next launch ----
  pool_i[tid] = slot;
  if (slot >= 0) {
    pool_f[tid] = L.ox;
    pool_f[P + tid] = L.oy;
    pool_f[2 * P + tid] = L.oz;
    pool_f[3 * P + tid] = L.dx;
    pool_f[4 * P + tid] = L.dy;
    pool_f[5 * P + tid] = L.dz;
    pool_f[6 * P + tid] = L.tpr;
    pool_f[7 * P + tid] = L.tpg;
    pool_f[8 * P + tid] = L.tpb;
    pool_f[9 * P + tid] = L.cr;
    pool_f[10 * P + tid] = L.cg;
    pool_f[11 * P + tid] = L.cb;
    pool_f[12 * P + tid] = L.alive;
    pool_i[P + tid] = pix;
    pool_i[2 * P + tid] = smp;
    pool_i[3 * P + tid] = bounce;
  }
  for (int off = 16; off > 0; off >>= 1)
    completed += __shfl_down_sync(kFull, completed, off);
  if (lane == 0 && completed) atomicAdd(&counters[1], completed);
}

}  // namespace

// Blocks of `threads` threads the card holds at once with the table's
// shared memory: the persistent grid (negative: minus a CUDA error).
extern "C" int queue_grid_blocks(int rows, int threads) {
  const size_t smem = rtt::table_smem_bytes(rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, queue_kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// table [rows, 17] f32; ro, rd [b, 3] f32; pixel [b] i32; sample [b] i32
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
  const size_t smem = rtt::table_smem_bytes(rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  queue_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      scene, ro, rd, pixel, sample, sample_scalar, b, pool_f, pool_i,
      blocks * threads, counters, out, depth, written, max_depth, budget);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* queue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
