// The persistent ray queue's loop, shared by the forward queue kernel
// (queue.cu, B3) and its adjoint (queue_adjoint.cu, B6); see queue.cu for
// the design.
//
// Each thread owns one pool lane and loops: when its lane is empty it
// takes the next fresh ray, and it advances its lane one bounce per
// step. The refill is the GPU form of the TPU's order-preserving pack:
// __ballot_sync finds the warp's empty lanes, one atomicAdd per warp
// claims that many fresh indices from a global cursor (in index order,
// so fresh work stays screen-coherent), and __popc of the lower lanes'
// mask ranks each lane. A launch stops after `budget` steps (0: when the
// cursor is spent and the warp is empty); in-flight lanes are then saved
// to the pool and the next launch resumes them.
//
// The pool holds, per lane, the 13 state rows (kAdjoint: then L and g,
// 19 rows; the alive word as it is, NEE's 0.5 and 2 + p included) in
// pool_f and 4 int32 rows in pool_i (slot or -1 for an
// empty lane, pixel, sample, bounce). The forward writes each finished
// lane's radiance to out[slot]; the adjoint adds cotangents to `acc` and,
// with image textures, to the atlas gradient `gimg` (bounce.cuh, Adj)
// and writes nothing per lane.
#pragma once

#include "bounce.cuh"

namespace rtt {

template <bool kAdjoint, bool kTail, bool kFamilies = false,
          bool kNee = false, bool kImages = false, bool kQmc = false>
__device__ __forceinline__ void queue_loop(
    const SceneOf<kImages>& scene, const float* __restrict__ ro,
    const float* __restrict__ rd, const int* __restrict__ pixel,
    const int* __restrict__ sample, int sample_scalar,
    const float* __restrict__ lin, const float* __restrict__ gin, int b,
    float* __restrict__ pool_f, int* __restrict__ pool_i, int pool_lanes,
    unsigned* __restrict__ counters, float* __restrict__ out, float* acc,
    int n_slots, float* gimg, int* __restrict__ depth,
    int* __restrict__ written, int max_depth, int budget) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const long long P = pool_lanes;
  Lane L{};  // a lane that never takes a ray still helps with the hit
  Adj adj{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, acc, n_slots, gimg};
  int slot = pool_i[tid];
  uint32_t lane_key = 0;
  int bounce = 0;
  if (slot >= 0) {  // resume the lane a previous launch saved
    load_lane(pool_f + tid, P, L);
    if (kAdjoint) load_lg(pool_f + tid, P, adj);
    lane_key = rtt::lane_key(scene.seed,
                             static_cast<uint32_t>(pool_i[P + tid]),
                             static_cast<uint32_t>(pool_i[2 * P + tid]),
                             kQmc);
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
          if (kAdjoint) {
            adj.Lr = lin[k];
            adj.Lg = lin[k + 1];
            adj.Lb = lin[k + 2];
            adj.gr = gin[k];
            adj.gg = gin[k + 1];
            adj.gb = gin[k + 2];
          }
          pix = pixel[idx];
          smp = sample ? sample[idx] : sample_scalar;
          lane_key = rtt::lane_key(scene.seed, static_cast<uint32_t>(pix),
                                   static_cast<uint32_t>(smp), kQmc);
          bounce = 0;
        }
      }
    }
    if (!__any_sync(kFull, slot >= 0)) break;  // warp empty, cursor spent

    // ---- one bounce: every lane of the warp enters it together (its
    // closest hit is warp-cooperative, bounce.cuh warp_hit); a lane
    // with a live ray below max_depth advances, the others help ----
    const bool go = slot >= 0 && bounce < max_depth && L.alive > 0.0f;
    do_bounce<kAdjoint, kTail, false, kFamilies, kNee, kImages, kQmc>(
        scene, L,
        draw_at(lane_key, static_cast<uint32_t>(smp),
                static_cast<uint32_t>(bounce)),
        adj, nullptr, go);
    if (go) ++bounce;
    if (slot >= 0) {
      // ---- exhaustion and retirement ----
      if (L.alive > 0.0f && bounce >= max_depth) {
        if (scene.exhaust_bg) {
          if (kAdjoint)
            credit_bg(scene, L, adj);
          else
            exhaust(scene, L);
        }
        L.alive = 0.0f;
      }
      if (!(L.alive > 0.0f)) {
        if (!kAdjoint) {
          const size_t k = 3 * static_cast<size_t>(slot);
          out[k] = L.cr;
          out[k + 1] = L.cg;
          out[k + 2] = L.cb;
        }
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
    store_lane(pool_f + tid, P, L);
    if (kAdjoint) store_lg(pool_f + tid, P, adj);
    pool_i[P + tid] = pix;
    pool_i[2 * P + tid] = smp;
    pool_i[3 * P + tid] = bounce;
  }
  for (int off = 16; off > 0; off >>= 1)
    completed += __shfl_down_sync(kFull, completed, off);
  if (lane == 0 && completed) atomicAdd(&counters[1], completed);
}

}  // namespace rtt
