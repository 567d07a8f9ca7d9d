// One bounce of one lane: the body shared by the megakernel (mega.cu),
// the persistent ray queue (queue.cu), their adjoints
// (mega_adjoint.cu, queue_adjoint.cu) and the tape capture (capture.cu).
//
// Replaces: rt_tpu/ops/pallas_mega.py `do_bounce` (:1011-1896) of
// `_make_do_bounce`, restricted to this slice: Russian roulette
// (:1016-1019), the sphere closest hit without MXU or chunk culling
// (`_sph_chunk_math` :1067-1097), the winner's attributes and normal
// (:1290-1317), the checker texture (:1319-1324), the scatter
// (:1420-1486) and the non-NEE accumulation (:1488-1527); and
// `_make_background` (:774). The expressions are the reference's, in its
// order; ops/mega_plain.do_bounce_plain is the plain twin. The adjoint
// variant, do_bounce<true> (the reference's `adjoint=True` block
// :1700-1800), runs the same expressions and adds the suffix-identity
// cotangents to the winner's gradient slot; its plain twin is
// ops/adjoint_plain.py.
//
// On the GPU one thread owns one lane, and the lane's state lives in
// registers. The block stages the five intersection columns of the
// first kStageRows rows of the sphere table (cx, cy, cz, |c|^2 - r^2,
// valid: 20 B a row) in shared memory once; every thread of a warp reads
// the same row at once, a broadcast. Rows past kStageRows are read from
// global memory through the read-only cache, in the same ascending
// order, so a table of any size traces (no block-wide chunked stage: the
// persistent queue's divergent lanes cannot meet at a __syncthreads).
// The winner's other columns are read from global memory by its row
// index, where the TPU extracted them with one-hot MXU products.
// Each material computes only its own scatter (the TPU computes every
// material's and selects); the draws are pure hashes of their
// coordinates, so skipping the unused ones changes nothing.
//
// What bounds it: FP32 operations, 23 per (lane, row) pair in the hit
// loop (FMA counted as two, the sqrt as one), plus 16 of ray setup (a,
// d.o, |o|^2, 1/a) and the winner's shading per ray-bounce. The shading
// depends on the material hit (none for a miss, the most for a
// refracting dielectric); chip_smoke.py's bound leaves it out.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "rng.cuh"

namespace rtt {

// packed sphere table columns (ops/mega_tables.py, pallas_mega.py:85-140)
constexpr int kCols = 18;
constexpr int kV = 0, kRad = 3, kDirect = 4, kMtype = 5, kChecker = 6,
              kParam = 7, kAlb = 8, kAlb2 = 11, kC2r = 15, kValid = 16,
              kSlot = 17;
// rows staged in shared memory (40 KB); the rest are read from global
constexpr int kStageRows = 2048;
static_assert(kStageRows * 20 <= 48 * 1024,
              "the staged rows fit the default dynamic shared memory");
// the adjoint accumulators (ops/adjoint_plain.py): rows 0-2 the primary
// colour and 3-5 the checker odd colour, n_slots each, then the
// background's 3 at row 6 of the [8, n_slots] output
constexpr int kBgRow = 6;
// material type codes (scene/types.py)
constexpr float kLambertian = 0.0f, kMetal = 1.0f, kDielectric = 2.0f,
                kDiffuseLight = 3.0f;

struct Lane {
  float ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, cr, cg, cb, alive;
};

struct Scene {
  const float* table;    // [n, kCols] in global memory
  const float4* hit4;    // [n_smem] shared: cx, cy, cz, c2r
  const float* valid;    // [n_smem] shared
  int n, n_smem;
  float t_min, p_rr, rr_comp;
  int grad_bg;
  float bg_r, bg_g, bg_b;
  int exhaust_bg;
  uint32_t seed;
};

// The launchers' scalar arguments, in their C order (cuda_mega._scalars).
#define RTT_SCENE_ARGS                                                  \
  uint32_t seed, float t_min, float p_rr, float rr_comp, int grad_bg,  \
      float bg_r, float bg_g, float bg_b, int exhaust_bg

__host__ inline Scene make_scene(const float* table, int n,
                                 RTT_SCENE_ARGS) {
  Scene s;
  s.table = table;
  s.hit4 = nullptr;
  s.valid = nullptr;
  s.n = n;
  s.n_smem = n < kStageRows ? n : kStageRows;
  s.t_min = t_min;
  s.p_rr = p_rr;
  s.rr_comp = rr_comp;
  s.grad_bg = grad_bg;
  s.bg_r = bg_r;
  s.bg_g = bg_g;
  s.bg_b = bg_b;
  s.exhaust_bg = exhaust_bg;
  s.seed = seed;
  return s;
}

// Shared memory the staged rows take, and their staging (all threads of
// the block, before any of them traces; the caller then
// __syncthreads()).
__host__ __device__ inline size_t table_smem_bytes(int n) {
  const int staged = n < kStageRows ? n : kStageRows;
  return static_cast<size_t>(staged) * (sizeof(float4) + sizeof(float));
}

__device__ __forceinline__ void stage_table(Scene& s, float4* smem) {
  float4* hit4 = smem;
  float* valid = reinterpret_cast<float*>(smem + s.n_smem);
  for (int k = threadIdx.x; k < s.n_smem; k += blockDim.x) {
    const float* r = s.table + k * kCols;
    hit4[k] = make_float4(r[kV], r[kV + 1], r[kV + 2], r[kC2r]);
    valid[k] = r[kValid];
  }
  s.hit4 = hit4;
  s.valid = valid;
}

// Whether a table of n rows has rows past the staged ones (the kernels'
// kTail instantiation).
__host__ inline bool has_tail(int n) { return n > kStageRows; }

// Where a kernel's own block-local data (the adjoint accumulators)
// starts in shared memory: after the staged rows, 16-byte aligned.
__host__ __device__ inline size_t after_table_bytes(int n) {
  return (table_smem_bytes(n) + 15) & ~static_cast<size_t>(15);
}

// One (lane, row) pair of the closest-hit loop; `valid` is read only
// where the discriminant is not negative, as the loop did before the
// rows were split between shared and global memory.
__device__ __forceinline__ void hit_row(float4 c, const float* valid, int j,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float a, float rd_dot_ro,
                                        float ro_sq, float inv_a,
                                        float t_min, float& t_best,
                                        int& id_best) {
  const float hb = rd_dot_ro - (c.x * dx + c.y * dy + c.z * dz);
  const float c_term = ro_sq - 2.0f * (c.x * ox + c.y * oy + c.z * oz) + c.w;
  const float disc = hb * hb - a * c_term;
  const float sqrtd = sqrtf(fmaxf(disc, 0.0f));
  const float root1 = (-hb - sqrtd) * inv_a;
  const float root2 = (-hb + sqrtd) * inv_a;
  float t = root1 >= t_min ? root1 : (root2 >= t_min ? root2 : CUDART_INF_F);
  if (!(disc >= 0.0f && *valid > 0.0f)) t = CUDART_INF_F;
  // rows arrive in ascending order, so `<=` is "t < best, or equal t
  // and a larger row": the reference's later-wins tie-break
  if (t <= t_best) {
    t_best = t;
    id_best = j;
  }
}

// What the adjoint bounce reads besides the lane: the sample's radiance
// L and its cotangent g, and the accumulators it adds to (shared or
// global memory: [kBgRow * n_slots + 3] floats, see kBgRow).
struct Adj {
  float Lr, Lg, Lb, gr, gg, gb;
  float* acc;
  int n_slots;
};

// A lane's 13 state words in rows [0, 13) of an array with row stride
// `stride` (p points at the lane's column: a [13+, B] state or a pool).
__device__ __forceinline__ void load_lane(const float* p, long long stride,
                                          Lane& L) {
  L.ox = p[0];
  L.oy = p[stride];
  L.oz = p[2 * stride];
  L.dx = p[3 * stride];
  L.dy = p[4 * stride];
  L.dz = p[5 * stride];
  L.tpr = p[6 * stride];
  L.tpg = p[7 * stride];
  L.tpb = p[8 * stride];
  L.cr = p[9 * stride];
  L.cg = p[10 * stride];
  L.cb = p[11 * stride];
  L.alive = p[12 * stride];
}

__device__ __forceinline__ void store_lane(float* p, long long stride,
                                           const Lane& L) {
  p[0] = L.ox;
  p[stride] = L.oy;
  p[2 * stride] = L.oz;
  p[3 * stride] = L.dx;
  p[4 * stride] = L.dy;
  p[5 * stride] = L.dz;
  p[6 * stride] = L.tpr;
  p[7 * stride] = L.tpg;
  p[8 * stride] = L.tpb;
  p[9 * stride] = L.cr;
  p[10 * stride] = L.cg;
  p[11 * stride] = L.cb;
  p[12 * stride] = L.alive;
}

// An adjoint lane's L and g in rows [13, 19), after its state.
__device__ __forceinline__ void load_lg(const float* p, long long stride,
                                        Adj& a) {
  a.Lr = p[13 * stride];
  a.Lg = p[14 * stride];
  a.Lb = p[15 * stride];
  a.gr = p[16 * stride];
  a.gg = p[17 * stride];
  a.gb = p[18 * stride];
}

__device__ __forceinline__ void store_lg(float* p, long long stride,
                                         const Adj& a) {
  p[13 * stride] = a.Lr;
  p[14 * stride] = a.Lg;
  p[15 * stride] = a.Lb;
  p[16 * stride] = a.gr;
  p[17 * stride] = a.gg;
  p[18 * stride] = a.gb;
}

__device__ __forceinline__ void background(const Scene& s, float dx,
                                           float dy, float dz, float& r,
                                           float& g, float& b) {
  if (!s.grad_bg) {
    r = s.bg_r;
    g = s.bg_g;
    b = s.bg_b;
    return;
  }
  const float inv = rsqrtf(dx * dx + dy * dy + dz * dz);
  const float t = 0.5f * (dy * inv + 1.0f);
  r = (1.0f - t) + t * 0.5f;
  g = (1.0f - t) + t * 0.7f;
  b = 1.0f;
}

// Credit the sky to a lane whose depth ran out while alive (the
// reference's exhaust_bg epilogue); the caller then retires the lane.
__device__ __forceinline__ void exhaust(const Scene& s, Lane& L) {
  float bgr, bgg, bgb;
  background(s, L.dx, L.dy, L.dz, bgr, bgg, bgb);
  L.cr = L.cr + L.tpr * bgr;
  L.cg = L.cg + L.tpg * bgg;
  L.cb = L.cb + L.tpb * bgb;
}

// Add g * P to the background's accumulators (a miss, or an exhausted
// lane), when the sky is the constant colour.
__device__ __forceinline__ void credit_bg(const Scene& s, const Lane& L,
                                          const Adj& adj) {
  if (s.grad_bg) return;
  float* bg = adj.acc + kBgRow * adj.n_slots;
  atomicAdd(bg, adj.gr * L.tpr);
  atomicAdd(bg + 1, adj.gg * L.tpg);
  atomicAdd(bg + 2, adj.gb * L.tpb);
}

// Add one cotangent per channel to the winner's slot: the primary
// colour's rows, or the checker odd colour's when `odd`.
__device__ __forceinline__ void credit_slot(const Adj& adj, int slot,
                                            bool odd, float cr, float cg,
                                            float cb) {
  float* row = adj.acc + (odd ? 3 : 0) * adj.n_slots + slot;
  if (cr != 0.0f) atomicAdd(row, cr);
  if (cg != 0.0f) atomicAdd(row + adj.n_slots, cg);
  if (cb != 0.0f) atomicAdd(row + 2 * adj.n_slots, cb);
}

// g * (L - C_after) / att where att != 0 (the reference's `_cot`)
__device__ __forceinline__ float att_cot(float g, float Lk, float c,
                                         float att) {
  return att != 0.0f ? g * (Lk - c) / att : 0.0f;
}

// Advance a live lane (alive > 0) one bounce at RNG coordinate `pre`
// (rng.cuh prefix of seed, pixel, sample, bounce). A lane that does
// not scatter leaves with alive = 0. kAdjoint also adds the bounce's
// cotangents to adj's accumulators (see ops/adjoint_plain.py); the lane
// advances exactly as in the forward. kTail (a table of more than
// kStageRows rows) compiles the loop over the rows in global memory:
// its mere presence slowed the megakernel by 9% on tables that do not
// need it (PERF.md, PR 6), so the kernels instantiate both and the
// launchers choose (has_tail). kCapture (the tape capture, capture.cu)
// also reports the winner's row in *code, or -1 on a miss: it runs the
// hit pass before it applies the roulette, so that a lane the roulette
// stops still records this bounce's winner, as the reference's kernel
// does (it evaluates the hit on every lane). Without kCapture the
// roulette returns first and the code is as it was before the flag.
template <bool kAdjoint, bool kTail, bool kCapture = false>
__device__ __forceinline__ void do_bounce(const Scene& s, Lane& L,
                                          uint32_t pre, const Adj& adj,
                                          int* code = nullptr) {
  bool rr_stop = false;
  if (s.p_rr > 0.0f && !(uniform(pre, kRR) <= s.p_rr)) {
    if constexpr (!kCapture) {
      L.alive = 0.0f;  // roulette: the lane stops and adds nothing
      return;
    } else {
      rr_stop = true;
    }
  }
  const float ox = L.ox, oy = L.oy, oz = L.oz;
  const float dx = L.dx, dy = L.dy, dz = L.dz;

  // ---- closest hit over the staged table ----
  const float a = dx * dx + dy * dy + dz * dz;
  const float rd_dot_ro = dx * ox + dy * oy + dz * oz;
  const float ro_sq = ox * ox + oy * oy + oz * oz;
  const float inv_a = 1.0f / a;
  float t_best = CUDART_INF_F;
  int id_best = 0;
  for (int j = 0; j < s.n_smem; ++j)
    hit_row(s.hit4[j], s.valid + j, j, ox, oy, oz, dx, dy, dz, a, rd_dot_ro,
            ro_sq, inv_a, s.t_min, t_best, id_best);
  if (kTail) {
    for (int j = s.n_smem; j < s.n; ++j) {
      const float* r = s.table + static_cast<size_t>(j) * kCols;
      hit_row(make_float4(__ldg(r + kV), __ldg(r + kV + 1),
                          __ldg(r + kV + 2), __ldg(r + kC2r)),
              r + kValid, j, ox, oy, oz, dx, dy, dz, a, rd_dot_ro, ro_sq,
              inv_a, s.t_min, t_best, id_best);
    }
  }

  if constexpr (kCapture) {
    *code = t_best < CUDART_INF_F ? id_best : -1;
    if (rr_stop) {
      L.alive = 0.0f;
      return;
    }
  }

  float bgr, bgg, bgb;
  // t is never NaN (a NaN root fails both `>=` tests), so a finite
  // t_best is one below infinity
  if (!(t_best < CUDART_INF_F)) {  // miss: the sky, and the path ends
    if (kAdjoint) credit_bg(s, L, adj);
    background(s, dx, dy, dz, bgr, bgg, bgb);
    L.cr = L.cr + L.tpr * bgr;
    L.cg = L.cg + L.tpg * bgg;
    L.cb = L.cb + L.tpb * bgb;
    L.alive = 0.0f;
    return;
  }

  // ---- the winner's attributes, by its row ----
  const float* w = s.table + id_best * kCols;
  const float v0 = w[kV], v1 = w[kV + 1], v2 = w[kV + 2], v3 = w[kRad];
  const bool direct = w[kDirect] > 0.0f;
  const float mtype = w[kMtype];
  const float param = w[kParam];

  const float px = ox + t_best * dx;
  const float py = oy + t_best * dy;
  const float pz = oz + t_best * dz;

  // outward normal (p - center) / radius; a negative radius flips it
  // (hollow glass)
  const float inv_rad = 1.0f / (v3 == 0.0f ? 1.0f : v3);
  float nx = direct ? v0 : (px - v0) * inv_rad;
  float ny = direct ? v1 : (py - v1) * inv_rad;
  float nz = direct ? v2 : (pz - v2) * inv_rad;

  // set_face_normal (hittable.cuh:16-23)
  const float d_dot_n = dx * nx + dy * ny + dz * nz;
  const bool front = d_dot_n < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;

  // checker texture (texture.cuh:44-52)
  float alb_r = w[kAlb], alb_g = w[kAlb + 1], alb_b = w[kAlb + 2];
  bool use2 = false;
  if (w[kChecker] > 0.0f) {
    const float sines =
        sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
    if (sines < 0.0f) {
      use2 = true;
      alb_r = w[kAlb2];
      alb_g = w[kAlb2 + 1];
      alb_b = w[kAlb2 + 2];
    }
  }

  if (mtype == kDiffuseLight) {  // emits and stops
    if (kAdjoint)  // d(g.L)/d(emission) = g * P
      credit_slot(adj, static_cast<int>(w[kSlot]), use2, adj.gr * L.tpr,
                  adj.gg * L.tpg, adj.gb * L.tpb);
    L.cr = L.cr + L.tpr * alb_r;
    L.cg = L.cg + L.tpg * alb_g;
    L.cb = L.cb + L.tpb * alb_b;
    L.alive = 0.0f;
    return;
  }

  // ---- scatter ----
  float new_dx, new_dy, new_dz;
  if (mtype == kLambertian) {
    float bx, by, bz;
    unit_ball(pre, bx, by, bz);
    new_dx = nx + bx;
    new_dy = ny + by;
    new_dz = nz + bz;
    if (fabsf(new_dx) < 1e-8f && fabsf(new_dy) < 1e-8f &&
        fabsf(new_dz) < 1e-8f) {
      new_dx = nx;
      new_dy = ny;
      new_dz = nz;
    }
  } else {
    const float inv_len = rsqrtf(a);
    const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
    const float u_dot_n = ux * nx + uy * ny + uz * nz;
    const float ref_x = ux - 2.0f * u_dot_n * nx;
    const float ref_y = uy - 2.0f * u_dot_n * ny;
    const float ref_z = uz - 2.0f * u_dot_n * nz;
    if (mtype == kMetal) {
      float bx, by, bz;
      unit_ball(pre, bx, by, bz);
      const float fuzz = param;
      new_dx = ref_x + fuzz * bx;
      new_dy = ref_y + fuzz * by;
      new_dz = ref_z + fuzz * bz;
      if (!((new_dx * nx + new_dy * ny + new_dz * nz) > 0.0f)) {
        L.alive = 0.0f;  // absorbed below the horizon
        return;
      }
    } else {  // dielectric
      const float ior = param;
      const float ratio = front ? 1.0f / (ior == 0.0f ? 1.0f : ior) : ior;
      const float cos_theta = fminf(-u_dot_n, 1.0f);
      const float sin_theta = sqrtf(fmaxf(0.0f, 1.0f - cos_theta * cos_theta));
      const bool cannot = ratio * sin_theta > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float one_mc = 1.0f - cos_theta;
      const float om2 = one_mc * one_mc;
      const float schlick = r0 + (1.0f - r0) * om2 * om2 * one_mc;
      if (cannot || schlick > uniform(pre, kDielRefl)) {
        new_dx = ref_x;
        new_dy = ref_y;
        new_dz = ref_z;
      } else {  // refract (vec3.cuh:125-131)
        const float rp_x = ratio * (ux + cos_theta * nx);
        const float rp_y = ratio * (uy + cos_theta * ny);
        const float rp_z = ratio * (uz + cos_theta * nz);
        const float rp_l2 = rp_x * rp_x + rp_y * rp_y + rp_z * rp_z;
        const float par = -sqrtf(fabsf(1.0f - rp_l2));
        new_dx = rp_x + par * nx;
        new_dy = rp_y + par * ny;
        new_dz = rp_z + par * nz;
      }
      alb_r = alb_g = alb_b = 1.0f;
    }
  }

  // d(g.L)/d(att) = g * (L - C_after) / att; C_after is the radiance
  // so far, which a scattering bounce does not change. A dielectric's
  // attenuation is the constant 1 and takes none.
  if (kAdjoint && mtype != kDielectric)
    credit_slot(adj, static_cast<int>(w[kSlot]), use2,
                att_cot(adj.gr, adj.Lr, L.cr, alb_r),
                att_cot(adj.gg, adj.Lg, L.cg, alb_g),
                att_cot(adj.gb, adj.Lb, L.cb, alb_b));

  L.tpr = L.tpr * alb_r * s.rr_comp;
  L.tpg = L.tpg * alb_g * s.rr_comp;
  L.tpb = L.tpb * alb_b * s.rr_comp;
  L.ox = px;
  L.oy = py;
  L.oz = pz;
  L.dx = new_dx;
  L.dy = new_dy;
  L.dz = new_dz;
  L.alive = 1.0f;
}

}  // namespace rtt
