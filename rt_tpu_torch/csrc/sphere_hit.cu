// Closest sphere hit per ray, by hand for Hopper (sm_90a).
//
// Replaces: rt_tpu/ops/pallas_intersect.py::_sphere_kernel (:42-96), the
// Pallas TPU kernel launched by sphere_closest_hit (:99-150). Contract
// kept from it: inputs are a packed sphere table and per-ray origin and
// direction; outputs are t [B] (inf on a miss) and pid [B]; the math is
// the same expanded half-b quadratic
//     hb     = rd.ro - c.rd
//     c_term = |ro|^2 - 2 c.ro + (|c|^2 - r^2)     (c2r precomputed)
//     disc   = hb^2 - a c_term,  a = |rd|^2
// taking the near root if it is >= t_min, else the far root; pad rows
// and disc < 0 give inf; equal t goes to the LARGER sphere index
// (pallas_intersect.py:84-88, object.cuh:23-37), and a ray that hits
// nothing reports pid = N-1, as the TPU kernel's chunk reduction does.
//
// What bounds it: issued instructions. Each (ray, sphere) pair costs 17
// FP32 operations up to the discriminant (FMA counted as two) and 6 more
// (max, sqrt, the two roots) where disc >= 0, against 32 bytes of device
// memory per ray (ro, rd in; t, pid out). At N = 512 that is ~300
// operations per byte, far above the H100's FP32 ridge (67 TFLOP/s /
// 3.35 TB/s = 20). The FP32 pipes are not the limit, though: a pair is
// 11 FP32 instructions and a compare, and each costs an issue slot of
// one of the SM's four schedulers whatever its operation count.
//
// What the design does about it, per pair:
// - One 16-byte row per sphere (cx, cy, cz, c2r), packed by the wrapper
//   with c2r = +inf for a pad row: its c_term is +inf, so disc is -inf
//   (or NaN where a = 0) and fails `disc >= 0` as disc < 0 does. A live
//   row computes what it did with the separate `live` column, bit for
//   bit. The block stages the rows in shared memory as float4s; every
//   thread of a warp reads the same row at once, one broadcast LDS.128.
// - kRays = 4 rays a thread: each row loaded serves every ray the thread
//   holds. A block's tile is kThreads * kRays rays, thread t taking rays
//   t, t + kThreads, ..., so each of the kRays loads of a warp stays
//   coalesced; rays past B are dummies never stored. 2, 4 and 8 rays
//   took 0.745, 0.606 and 0.596 ms on the 1080p primary rays (PERF.md);
//   4 keeps twice the blocks of 8 for a smaller batch.
// - Discriminant first: every ray's disc for the row, then one branch,
//   taken when some ray's disc >= 0, to the square root, the roots and
//   the root choice; a warp skips it when no lane needs it (most (warp,
//   row) pairs of the cover scene's small spheres). A skipped pair never
//   folds its inf, so the rule "a ray that hits nothing ends on row
//   N-1", which the `<=` over inf rows gave, is applied once at the end:
//   pid = N-1 where t_best is inf. A row with disc >= 0 whose roots are
//   both below t_min folds inf as before, so t and pid are the per-row
//   loop's wherever t is finite.
// - The table is staged once per block: a grid of a few blocks per SM
//   (as many as fit, in waves of equal size) strides over the tiles.
//   Tables of more than kChunk rows are staged in chunks per tile, in
//   ascending order, so `<=` keeps the later-index tie rule across them.
// So the miss path of a pair is 14.5 issued instructions (cuobjdump
// -sass), where the one-ray-a-thread loop spent ~50 on every pair.
// The expressions are the per-row loop's, in its order, with their
// roundings pinned to its FMA contraction (dot3 below): t and pid are its
// bits, and agree with the unfused plain version to a few ulps, within
// the rtol 2e-4 / atol 1e-4 the tests state (ROADMAP C-5). No AABB
// culling and no table sorting (the TPU megakernel's cull_chunks is not
// part of this kernel's contract).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 4;                 // rays a thread holds
constexpr int kTile = kThreads * kRays;  // rays a block takes at a time
constexpr int kChunk = 2048;             // rows per shared stage (32 KB)

// The per-ray and per-pair terms with their roundings pinned: products
// and sums as the kernel's earlier build (one thread a ray, FMA
// contraction on) contracted them, per its SASS, so t and pid keep its
// bits. A dot product fuses its first product into the second term:
// fma(z, z', fma(x, x', y * y')); |ro|^2 fuses the y term instead.
__device__ __forceinline__ float dot3(float x, float y, float z, float x2,
                                      float y2, float z2) {
  return __fmaf_rn(z, z2, __fmaf_rn(x, x2, __fmul_rn(y, y2)));
}

__global__ void __launch_bounds__(kThreads)
sphere_hit_kernel(const float4* __restrict__ table, int n,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  int b, float t_min, float* __restrict__ t_out,
                  int* __restrict__ pid_out) {
  extern __shared__ float4 tab[];
  const bool resident = n <= kChunk;  // one stage serves every tile
  if (resident) {
    for (int k = threadIdx.x; k < n; k += kThreads) tab[k] = table[k];
    __syncthreads();
  }

  // every thread of the block runs the same tiles (the `for` depends on
  // blockIdx only), so the chunked stage's __syncthreads are met by all
  for (int tile = blockIdx.x * kTile; tile < b; tile += gridDim.x * kTile) {
    float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
    float a[kRays], rd_dot_ro[kRays], ro_sq[kRays], inv_a[kRays];
    float t_best[kRays];
    int id_best[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const int i = tile + r * kThreads + threadIdx.x;
      ox[r] = oy[r] = oz[r] = dx[r] = dy[r] = 0.0f;
      dz[r] = 1.0f;
      if (i < b) {
        ox[r] = ro[3 * i]; oy[r] = ro[3 * i + 1]; oz[r] = ro[3 * i + 2];
        dx[r] = rd[3 * i]; dy[r] = rd[3 * i + 1]; dz[r] = rd[3 * i + 2];
      }
      a[r] = dot3(dx[r], dy[r], dz[r], dx[r], dy[r], dz[r]);
      rd_dot_ro[r] = dot3(dx[r], dy[r], dz[r], ox[r], oy[r], oz[r]);
      ro_sq[r] = __fmaf_rn(oz[r], oz[r],
                           __fmaf_rn(oy[r], oy[r], __fmul_rn(ox[r], ox[r])));
      inv_a[r] = 1.0f / a[r];
      // an empty asm that "writes" them keeps the compiler from
      // recomputing the three dot products in the row loop (it did, from
      // the PTX on: 23.25 issued instructions a pair on the miss path
      // instead of 14.5; PERF.md)
      asm("" : "+f"(a[r]), "+f"(rd_dot_ro[r]), "+f"(ro_sq[r]),
          "+f"(inv_a[r]));
      t_best[r] = CUDART_INF_F;
      id_best[r] = 0;
    }

    for (int base = 0; base < n; base += kChunk) {
      const int rows = min(kChunk, n - base);
      if (!resident) {
        __syncthreads();  // the previous chunk is no longer being read
        for (int k = threadIdx.x; k < rows; k += kThreads)
          tab[k] = table[base + k];
        __syncthreads();
      }
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const float4 c = tab[j];
        // the discriminant of every ray first: kRays independent chains
        // and one branch a row, taken where some ray's disc >= 0
        float hb[kRays], disc[kRays];
        bool any = false;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          hb[r] = __fsub_rn(rd_dot_ro[r], dot3(c.x, c.y, c.z, dx[r], dy[r],
                                               dz[r]));
          // |ro|^2 - 2 c.ro + c2r: the product by 2 is exact, so one
          // fma rounds as (|ro|^2 - (x + x)) did
          const float c_term = __fadd_rn(
              __fmaf_rn(-2.0f, dot3(c.x, c.y, c.z, ox[r], oy[r], oz[r]),
                        ro_sq[r]),
              c.w);
          disc[r] = __fmaf_rn(hb[r], hb[r], -__fmul_rn(a[r], c_term));
          any |= disc[r] >= 0.0f;
        }
        if (!any) continue;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          if (!(disc[r] >= 0.0f)) continue;
          const float sq = sqrtf(fmaxf(disc[r], 0.0f));
          const float r1 = __fmul_rn(__fsub_rn(-hb[r], sq), inv_a[r]);
          const float r2 = __fmul_rn(__fadd_rn(-hb[r], sq), inv_a[r]);
          const float t =
              r1 >= t_min ? r1 : (r2 >= t_min ? r2 : CUDART_INF_F);
          // rows arrive in ascending order, so `<=` is "t < best, or
          // equal t and a larger index": the reference's later-wins
          // tie-break
          if (t <= t_best[r]) {
            t_best[r] = t;
            id_best[r] = base + j;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const int i = tile + r * kThreads + threadIdx.x;
      if (i < b) {
        t_out[i] = t_best[r];
        // no finite hit: the last row, where the per-row `<=` over the
        // inf candidates ends
        pid_out[i] =
            t_best[r] < CUDART_INF_F ? id_best[r] : (n > 0 ? n - 1 : 0);
      }
    }
  }
}

// Blocks of the grid: as many as are resident on the card at once, in
// waves of equal size, and no more than the tiles.
int grid_blocks(int b, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sphere_hit_kernel,
                                                kThreads, smem);
  const long long tiles = (static_cast<long long>(b) + kTile - 1) / kTile;
  const long long resident = static_cast<long long>(sms) *
                             (per_sm > 0 ? per_sm : 1);
  const long long waves = (tiles + resident - 1) / resident;
  return static_cast<int>((tiles + waves - 1) / waves);
}

}  // namespace

// table [n, 4] f32 (cx, cy, cz, |c|^2 - r^2, the last +inf for a pad
// row), ro/rd [b, 3] f32, t_out [b] f32, pid_out [b] i32, all contiguous
// on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int sphere_closest_hit_launch(const float* table, int n,
                                         const float* ro, const float* rd,
                                         int b, float t_min, float* t_out,
                                         int* pid_out, void* stream) {
  const size_t smem =
      static_cast<size_t>(n < kChunk ? n : kChunk) * sizeof(float4);
  sphere_hit_kernel<<<grid_blocks(b, smem), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), n, ro, rd, b, t_min, t_out,
      pid_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sphere_hit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
