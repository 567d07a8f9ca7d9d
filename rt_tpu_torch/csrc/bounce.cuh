// One bounce of one lane: the body shared by the megakernel (mega.cu),
// the persistent ray queue (queue.cu), their adjoints
// (mega_adjoint.cu, queue_adjoint.cu) and the tape capture (capture.cu).
//
// Replaces: rt_tpu/ops/pallas_mega.py `do_bounce` (:1011-1896) of
// `_make_do_bounce`, restricted to what the port carries: Russian
// roulette (:1016-1019), the closest hit without MXU over the spheres
// (`_sph_chunk_math` :1067-1097), rects (`rect_body`
// :1141-1163), cylinders (`cyl_body` :1165-1222) and triangles
// (`_tri_chunk_math` :1224-1267) in that order, merged as `_merge`
// (:753-763) does, the winner's attributes and normal (:1290-1317), the
// checker texture (:1319-1324), the scatter (:1420-1486), the
// accumulation (:1488-1527) and, with kNee, next-event estimation: the
// emission weight under NEE / MIS (:1487-1527), the light sample and its
// weights (:1529-1698) with the shadow any-hit `_shadow_occluded`
// (:831-1009), and the alive encodings (:1838-1875); with kImages, image
// textures: the winner's UV (:1327-1390) and texel (:1392-1410), an
// image-textured light's texel at the light point's UV (`nee_img`
// :1623-1664) and, in the adjoint, the atlas gradient (:1741-1790); and
// `_make_background` (:774); the sampler "qmc" (rng.cuh Draw) and chunk
// culling (`chunk_visible` :1099-1140, `box_visible` :845-868). The
// expressions are the reference's, in its order;
// ops/mega_plain.do_bounce_plain is the plain twin. The adjoint
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
// The rect, cylinder and triangle rows (kFamilies) are read from global
// memory through the read-only cache (__ldg), in ascending order after
// the spheres: the staged spheres take 40 KB of the 48 KB of default
// dynamic shared memory, and 800 triangle rows of 128 B would not fit
// beside them. A sphere-only scene runs the instantiation without the
// family loops, which is the code it ran before they existed.
//
// What bounds it: FP32 operations per (lane, row) pair in the hit loop
// (FMA counted as two, a division, sqrt, rsqrt, min or max as one,
// comparisons and selects not counted): 23 for a sphere, 36 for a rect,
// 62 for a cylinder, 71 for a triangle (each counted from its hit
// function below); plus 16 of ray setup (a, d.o, |o|^2, 1/a) and the
// winner's shading per ray-bounce (a cylinder's normal adds 41). The
// shading depends on the material hit (none for a miss, the most for a
// refracting dielectric); chip_smoke.py's bound leaves it out. A NEE
// shadow ray costs per row 23 for a sphere (its any-hit test), as many
// as the closest-hit test for the other families, and 17 of setup (a,
// w.s, |s|^2, the max and 1/a); the light sample's own arithmetic is
// left out of the bound, as the shading is.
//
// Chunk culling (cfg.cull_chunks; Scene::sbnd / tbnd not null): the
// Morton-sorted sphere rows, and triangle rows, come in chunks of
// kChunk with a box each (ops/mega_tables.Cull), and a lane skips a
// chunk whose box its ray does not meet at t >= t_min, or meets only
// beyond its closest hit so far (beyond kTHi for a shadow ray), or that
// is empty (a chunk of pad rows). The TPU takes that decision once for
// a tile of 2048 lanes (a chunk is skipped when no live lane of the
// tile needs it); here each lane takes it for itself, and its plain twin
// (mega_plain._culled_best) takes the same decision in the same order,
// so kernel and plain agree on every lane. Every kernel that runs
// do_bounce (B2-B7: the queue kernels, the megakernel, its adjoint, the
// tape capture and the regeneration kernel) tests a chunk that few lanes
// need with the whole warp, one needing ray at a time (warp_hit); the
// decisions and winners stay each lane's. A sorted row names its SceneTables row through
// Scene::sph_rows / tri_rows, which B4's tape codes and MIS's emitter
// match use (scene_row). Culling is a runtime flag of the scene,
// uniform over a launch, not a template parameter: its branch left the
// cull-off code's time within the noise of the A/B runs (PERF.md, PR
// 13). The sampler is the template flag kQmc: as a runtime flag its
// branch at each draw site cost the "rng" code 3-7% (B3, B2), so every
// kernel instantiates both samplers and the launchers pick.
//
// NEE (kNee, a scene with lights and cfg.nee): the light rows
// (ops/mega_tables.light_table, a handful) are read through __ldg. The
// shadow ray's any-hit scans the staged spheres, the tail and the family
// rows in the closest-hit loop's order and returns at the first
// occluder: its answer is an OR, so it equals the reference's full scan
// bit for bit. MIS and glossy are runtime flags of the scene, uniform
// over a launch. Without kNee every kernel compiles to the code it had
// before NEE.
//
// Image textures (kImages, a scene whose primitives sample an image):
// the winner's (u, v) is computed once per hit from its family and row
// (a sphere's from its centre and radius, the others' from their UV
// table rows, read through __ldg) with libdevice atan2f / acosf, which
// torch.atan2 / torch.acos call on the card (the TPU kernel has
// polynomials: Mosaic lacks them), and the texel is one indexed read of
// a float3 of the [Ni, TH, TW, 3] atlas through __ldg, where the TPU
// contracts two one-hot masks on its MXU. The adjoint adds a
// texel-sampled hit's cotangent with one atomicAdd per channel into a
// global [Ni, TH, TW, 3] gradient, at any atlas size (the TPU keeps
// per-tile planes in VMEM). What it adds to the bound: per texel-sampled
// hit a 32-byte sector of the atlas (and in the adjoint one atomic),
// and the UV's FP32 operations, counted from winner_uv with atan2f and
// acosf as one each: sphere 11, rect 14, cylinder 23, triangle 53, and
// 10 for the texel's index (texel_of). The image tables ride in
// ImageScene, the kImages instantiations' scene parameter; every other
// instantiation takes the Scene it took before image textures and
// compiles to the code it had then.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "rng.cuh"

namespace rtt {

// packed sphere table columns (ops/mega_tables.py, pallas_mega.py:85-140)
constexpr int kCols = 18;
constexpr int kV = 0, kRad = 3, kDirect = 4, kMtype = 5, kChecker = 6,
              kParam = 7, kAlb = 8, kAlb2 = 11, kImgId = 14, kC2r = 15,
              kValid = 16, kSlot = 17;
// the rect / cylinder / triangle tables (ops/mega_tables.py,
// pallas_mega.py:98-116): 32 columns, 0..14 the attribute block above
constexpr int kFCols = 32;
constexpr int kRK = 15, kRLo0 = 16, kRLo1 = 17, kRHi0 = 18, kRHi1 = 19,
              kRValid = 20, kRF1 = 21, kRF2 = 24;
constexpr int kYR = 15, kYT = 24, kYRad2 = 27, kYZmin = 28, kYZmax = 29,
              kYValid = 30;
constexpr int kTV1 = 15, kTE1 = 18, kTE2 = 21, kTE3 = 24, kTD0 = 27,
              kTValid = 28;
// a family row's gradient slot (the reference's `_SLOT_COL`, :140)
constexpr int kFSlot = 31;
// the winner's family (ops/intersect.py PTYPE_*)
constexpr int kFamSphere = 0, kFamRect = 1, kFamCyl = 2, kFamTri = 3;
// the UV tables of the rect, cylinder and triangle rows (ops/mega_tables
// rect_uv_table, ..., pallas_mega.py:145-151): 17 columns
constexpr int kUCols = 17;
// the light table (ops/mega_tables.py light_table): family, area, Le
// even / odd, checker flag, the sampling block at 9..23, the gradient
// slot, the row in its family's table, the emission's image id, a
// triangle light's uv1, uv2, uv3
constexpr int kLCols = 33;
constexpr int kLFam = 0, kLArea = 1, kLLe = 2, kLLe2 = 5, kLChecker = 8,
              kLSlot = 24, kLRow = 25, kLImg = 26, kLUv = 27;
// the shadow segment's end, 1 - 1e-3 in units of |w| (float32)
constexpr float kTHi = 0.999f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float k2Pi = 6.28318530717958647692f;
constexpr float k2OverPi = static_cast<float>(2.0 / 3.14159265358979323846);
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);
constexpr float kInv2Pi =
    static_cast<float>(1.0 / (2.0 * 3.14159265358979323846));
constexpr float kInv4Pi =
    static_cast<float>(1.0 / (4.0 * 3.14159265358979323846));
// rows per culled chunk (ops/mega_tables.SPH_CHUNK) and the floats of a
// chunk's box (bmin3, bmax3, 2 pad)
constexpr int kChunk = 32;
constexpr int kBoxCols = 8;
// the slab test's stand-in for an unbounded axis (mega_plain.BIG)
constexpr float kBig = 3.0e38f;
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
  // the other families' tables, [n_*, kFCols] in global memory (null
  // and 0 rows when the scene has none): read only by kFamilies
  const float* rect;
  const float* cyl;
  const float* tri;
  int n_rect, n_cyl, n_tri;
  float t_min, p_rr, rr_comp;
  int grad_bg;
  float bg_r, bg_g, bg_b;
  int exhaust_bg;
  uint32_t seed;
  // NEE's light table, [n_lights, kLCols] in global memory (null and 0
  // rows without NEE): read only by kNee; mis and glossy as
  // RenderConfig's, nee_w the float32 of 2 n_lights / pi
  const float* lights;
  int n_lights;
  int mis, glossy;
  float nee_w;
  // the sampler (1: "qmc", which the launchers turn into the kQmc
  // instantiation) and chunk culling: the [K, kBoxCols] chunk
  // boxes of the sorted sphere / triangle rows (null: that family is in
  // scene order) and each sorted row's SceneTables row (null: the row
  // is its own)
  int qmc;
  const float* sbnd;
  const float* tbnd;
  const int* sph_rows;
  const int* tri_rows;
};

// The scene of a kImages instantiation: the image atlas [Ni, img_th,
// img_tw, 3] and the rect, cylinder and triangle UV tables ([n_*,
// kUCols]), in global memory, beside the Scene.
struct ImageScene : Scene {
  const float* atlas;
  int img_th, img_tw;
  const float* uv_rect;
  const float* uv_cyl;
  const float* uv_tri;
};

// The scene parameter of an instantiation with or without kImages.
template <bool kImages>
using SceneOf = typename std::conditional<kImages, ImageScene, Scene>::type;

// The launchers' scalar arguments, in their C order (cuda_mega._scalars).
#define RTT_SCENE_ARGS                                                  \
  uint32_t seed, float t_min, float p_rr, float rr_comp, int grad_bg,  \
      float bg_r, float bg_g, float bg_b, int exhaust_bg
// Every launcher's family tables, after the sphere table
// (ops/cuda_mega.family_args).
#define RTT_FAMILY_ARGS                                                  \
  const float *rect, int n_rect, const float *cyl, int n_cyl,           \
      const float *tri, int n_tri
// Every launcher's sampler and chunk culling, right after its scalars
// (ops/cuda_mega.sort_args); the pointers null without culling.
#define RTT_SORT_ARGS                                                   \
  int qmc, const float *sbnd, const float *tbnd, const int *sph_rows,   \
      const int *tri_rows
// Every launcher's light table and NEE flags, after its scalars
// (ops/cuda_mega.nee_args); lights null and n_lights 0 without NEE.
#define RTT_NEE_ARGS const float *lights, int n_lights, int mis, int glossy
// Every launcher's image atlas and UV tables but the capture's, after its
// family tables (ops/cuda_mega.image_args); atlas null without image
// textures.
#define RTT_IMG_ARGS                                                     \
  const float *atlas, int img_th, int img_tw, const float *uv_rect,     \
      const float *uv_cyl, const float *uv_tri

// The instantiation K<kTail, kFamilies, kNee, I, Q> of a kernel
// template that a scene runs, I (kImages) and Q (kQmc) constants: the
// instantiations with and without images take different scene types.
#define RTT_PICK(K, tail, fam, nee, I, Q)                                  \
  ((tail) ? ((fam) ? ((nee) ? K<true, true, true, I, Q>                    \
                            : K<true, true, false, I, Q>)                  \
                   : ((nee) ? K<true, false, true, I, Q>                   \
                            : K<true, false, false, I, Q>))                \
          : ((fam) ? ((nee) ? K<false, true, true, I, Q>                   \
                            : K<false, true, false, I, Q>)                 \
                   : ((nee) ? K<false, false, true, I, Q>                  \
                            : K<false, false, false, I, Q>)))

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
  s.rect = s.cyl = s.tri = nullptr;
  s.n_rect = s.n_cyl = s.n_tri = 0;
  s.lights = nullptr;
  s.n_lights = 0;
  s.mis = s.glossy = 0;
  s.nee_w = 0.0f;
  s.qmc = 0;
  s.sbnd = s.tbnd = nullptr;
  s.sph_rows = s.tri_rows = nullptr;
  return s;
}

// A scene with a launcher's sampler and chunk culling.
__host__ inline Scene with_sort(Scene s, RTT_SORT_ARGS) {
  s.qmc = qmc;
  s.sbnd = sbnd;
  s.tbnd = tbnd;
  s.sph_rows = sph_rows;
  s.tri_rows = tri_rows;
  return s;
}

// A scene with the family tables of a launcher.
__host__ inline Scene with_families(Scene s, RTT_FAMILY_ARGS) {
  s.rect = rect;
  s.n_rect = n_rect;
  s.cyl = cyl;
  s.n_cyl = n_cyl;
  s.tri = tri;
  s.n_tri = n_tri;
  return s;
}

// A scene with a launcher's light table and NEE flags.
__host__ inline Scene with_nee(Scene s, RTT_NEE_ARGS) {
  s.lights = lights;
  s.n_lights = lights ? n_lights : 0;
  s.mis = mis;
  s.glossy = glossy;
  s.nee_w = static_cast<float>(2.0 * s.n_lights / 3.14159265358979323846);
  return s;
}

// A scene with a launcher's image atlas and UV tables (kImages).
__host__ inline ImageScene with_images(const Scene& base, RTT_IMG_ARGS) {
  ImageScene s;
  static_cast<Scene&>(s) = base;
  s.atlas = atlas;
  s.img_th = img_th;
  s.img_tw = img_tw;
  s.uv_rect = uv_rect;
  s.uv_cyl = uv_cyl;
  s.uv_tri = uv_tri;
  return s;
}

// Whether a scene samples lights (the kernels' kNee instantiation).
__host__ inline bool has_nee(const Scene& s) { return s.n_lights > 0; }


// Whether a scene has rect, cylinder or triangle rows (the kernels'
// kFamilies instantiation).
__host__ inline bool has_families(const Scene& s) {
  return s.n_rect + s.n_cyl + s.n_tri > 0;
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
__device__ __forceinline__ float sphere_t(float4 c, const float* valid,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float a, float rd_dot_ro,
                                          float ro_sq, float inv_a,
                                          float t_min) {
  const float hb = rd_dot_ro - (c.x * dx + c.y * dy + c.z * dz);
  const float c_term = ro_sq - 2.0f * (c.x * ox + c.y * oy + c.z * oz) + c.w;
  const float disc = hb * hb - a * c_term;
  const float sqrtd = sqrtf(fmaxf(disc, 0.0f));
  const float root1 = (-hb - sqrtd) * inv_a;
  const float root2 = (-hb + sqrtd) * inv_a;
  float t = root1 >= t_min ? root1 : (root2 >= t_min ? root2 : CUDART_INF_F);
  if (!(disc >= 0.0f && *valid > 0.0f)) t = CUDART_INF_F;
  return t;
}

__device__ __forceinline__ void hit_row(float4 c, const float* valid, int j,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float a, float rd_dot_ro,
                                        float ro_sq, float inv_a,
                                        float t_min, float& t_best,
                                        int& id_best) {
  const float t = sphere_t(c, valid, ox, oy, oz, dx, dy, dz, a, rd_dot_ro,
                           ro_sq, inv_a, t_min);
  // rows arrive in ascending order, so `<=` is "t < best, or equal t
  // and a larger row": the reference's later-wins tie-break
  if (t <= t_best) {
    t_best = t;
    id_best = j;
  }
}

// Fold one candidate of family `fam`, row j, into the running winner:
// rows and families arrive in ascending order, so `<=` gives an equal t
// to the later row within a family and to the later family across them
// (`_merge`: an equal finite t goes to the later chunk or table).
__device__ __forceinline__ void take(float t, int fam, int j, float& t_best,
                                     int& fam_best, int& id_best) {
  if (t <= t_best) {
    t_best = t;
    fam_best = fam;
    id_best = j;
  }
}

// The reference's `odot`: (r[k] x + r[k+1] y) + r[k+2] z.
__device__ __forceinline__ float odot(const float* r, int k, float x,
                                      float y, float z) {
  return __ldg(r + k) * x + __ldg(r + k + 1) * y + __ldg(r + k + 2) * z;
}

// One (lane, rect) pair (`rect_body` :1141-1163): the constant axis's
// one-hot (columns 0..2) and the free axes' (kRF1, kRF2) pick the
// coordinates. 36 FP32 operations: 2 x 5 for ro_k and rd_k, 2 for t,
// 2 x 12 for x and y.
__device__ __forceinline__ float hit_rect(const float* r, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float t_min) {
  const float ro_k = odot(r, kV, ox, oy, oz);
  const float rd_k = odot(r, kV, dx, dy, dz);
  const bool rd_ok = rd_k != 0.0f;
  const float t = (__ldg(r + kRK) - ro_k) / (rd_ok ? rd_k : 1.0f);
  const float x = odot(r, kRF1, ox, oy, oz) + t * odot(r, kRF1, dx, dy, dz);
  const float y = odot(r, kRF2, ox, oy, oz) + t * odot(r, kRF2, dx, dy, dz);
  const bool valid = rd_ok && t >= t_min && x >= __ldg(r + kRLo0) &&
                     x <= __ldg(r + kRHi0) && y >= __ldg(r + kRLo1) &&
                     y <= __ldg(r + kRHi1) && __ldg(r + kRValid) > 0.0f;
  return valid ? t : CUDART_INF_F;
}

// min / max that carry a NaN through, as torch.minimum / maximum and
// jnp.minimum / maximum do (fminf / fmaxf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// (near, far) of the slab lo <= o + t d <= hi along one axis
// (`axis_slab` :1112-1122): an axis the ray does not move along is all
// of t or none of it.
__device__ __forceinline__ void slab(float o, float d, float lo, float hi,
                                     float& near, float& far) {
  if (d != 0.0f) {
    const float inv = 1.0f / d;
    const float n0 = (lo - o) * inv, f0 = (hi - o) * inv;
    near = nan_min(n0, f0);
    far = nan_max(n0, f0);
  } else {
    const bool inside = o >= lo && o <= hi;
    near = inside ? -kBig : kBig;
    far = inside ? kBig : -kBig;
  }
}

// Whether a lane visits the chunk whose box is `box` (kBoxCols floats):
// the box holds a row, and the ray o + t d meets it at some t >= t_min
// from an entry no later than t_hi (its closest hit so far, or kTHi for
// a shadow ray): `chunk_visible` :1099-1140 and `box_visible` :845-868
// for one lane, mega_plain.box_span's arithmetic. 26 FP32 operations:
// 3 divisions, 6 subtractions, 6 multiplies, 11 min / max.
__device__ __forceinline__ bool box_visible(const float* box, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float t_min,
                                            float t_hi) {
  const float lo0 = __ldg(box), hi0 = __ldg(box + 3);
  if (!(lo0 <= hi0)) return false;  // the empty box of a pad chunk
  float n1, f1, n2, f2, n3, f3;
  slab(ox, dx, lo0, hi0, n1, f1);
  slab(oy, dy, __ldg(box + 1), __ldg(box + 4), n2, f2);
  slab(oz, dz, __ldg(box + 2), __ldg(box + 5), n3, f3);
  const float tn = nan_max(nan_max(n1, n2), n3);
  const float tf = nan_min(nan_min(f1, f2), f3);
  return tf >= nan_max(tn, t_min) && tn <= t_hi;
}

// The SceneTables row of row `row` of family `fam`'s table: itself, or
// for a Morton-sorted family the row it was sorted from
// (mega_plain.scene_rows).
__device__ __forceinline__ int scene_row(const Scene& s, int fam, int row) {
  if (fam == kFamSphere && s.sph_rows) return __ldg(s.sph_rows + row);
  if (fam == kFamTri && s.tri_rows) return __ldg(s.tri_rows + row);
  return row;
}

// One (lane, cylinder) pair (`cyl_body` :1165-1200): the ray in object
// space through the w2o rows, the radial quadratic, the nearer root in
// the z window first. 62 FP32 operations: 33 for the object-space ray,
// 15 for the quadratic's a, b, c and discriminant, 2 for its sqrt, 2
// for 1/2a, 4 for the roots, 2 for their order, 4 for their z.
__device__ __forceinline__ float hit_cyl(const float* r, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float t_min) {
  const float oox = odot(r, kYR, ox, oy, oz) + __ldg(r + kYT);
  const float ooy = odot(r, kYR + 3, ox, oy, oz) + __ldg(r + kYT + 1);
  const float ooz = odot(r, kYR + 6, ox, oy, oz) + __ldg(r + kYT + 2);
  const float odx = odot(r, kYR, dx, dy, dz);
  const float ody = odot(r, kYR + 3, dx, dy, dz);
  const float odz = odot(r, kYR + 6, dx, dy, dz);
  const float ac = odx * odx + ody * ody;
  const float bc = 2.0f * (odx * oox + ody * ooy);
  const float cc = oox * oox + ooy * ooy - __ldg(r + kYRad2);
  const float delta = bc * bc - 4.0f * ac * cc;
  const float sq = sqrtf(fmaxf(delta, 0.0f));
  const bool a_ok = ac != 0.0f;
  const float inv2a = 1.0f / (a_ok ? 2.0f * ac : 1.0f);
  const float r0 = -(bc - sq) * inv2a;
  const float r1 = -(bc + sq) * inv2a;
  const float t0 = nan_min(r0, r1), t1 = nan_max(r0, r1);
  const float zmin = __ldg(r + kYZmin), zmax = __ldg(r + kYZmax);
  const float z0 = ooz + t0 * odz;
  const float z1 = ooz + t1 * odz;
  const bool ok0 = t0 >= t_min && z0 >= zmin && z0 <= zmax && a_ok;
  const bool ok1 = t1 >= t_min && z1 >= zmin && z1 <= zmax && a_ok;
  const float t = ok0 ? t0 : (ok1 ? t1 : CUDART_INF_F);
  return (delta >= 0.0f && __ldg(r + kYValid) > 0.0f) ? t : CUDART_INF_F;
}

// cross(e, w) . n for the triangle's edge at column k (the inside test);
// col(k) reads column k of the row
template <class Col>
__device__ __forceinline__ float edge_dot(const Col& col, int k, float wx,
                                          float wy, float wz) {
  const float ex = col(k), ey = col(k + 1), ez = col(k + 2);
  const float cxp = ey * wz - ez * wy;
  const float cyp = ez * wx - ex * wz;
  const float czp = ex * wy - ey * wx;
  return cxp * col(kV) + cyp * col(kV + 1) + czp * col(kV + 2);
}

// One (lane, triangle) pair (`_tri_chunk_math` :1224-1267): the plane
// distance signed toward the origin's side, the three edge tests
// (strict, one sign), and only rays heading into the plane. 71 FP32
// operations: 6 for oc_n, 6 for d_n, 1 for oc_n's sign, 1 for t, 9 for
// r - v1, 14 + 17 + 17 for the three edge tests. col(k) reads column k
// of the row: from global memory (hit_tri) or from registers (the
// queue's warp-cooperative hit, TriRow).
template <class Col>
__device__ __forceinline__ float tri_t(const Col& col, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float t_min) {
  const float oc_n =
      (col(kV) * ox + col(kV + 1) * oy + col(kV + 2) * oz) - col(kTD0);
  const float sign = oc_n < 0.0f ? -1.0f : 1.0f;
  const float d_n = (col(kV) * dx + col(kV + 1) * dy + col(kV + 2) * dz) *
                    sign;
  const float oc_ns = oc_n * sign;
  const float t = -oc_ns / (d_n != 0.0f ? d_n : 1.0f);
  const float rx = ox + t * dx - col(kTV1);
  const float ry = oy + t * dy - col(kTV1 + 1);
  const float rz = oz + t * dz - col(kTV1 + 2);
  const float s1 = edge_dot(col, kTE1, rx, ry, rz);
  const float s2 = edge_dot(col, kTE2, rx - col(kTE1), ry - col(kTE1 + 1),
                            rz - col(kTE1 + 2));
  const float s3 = edge_dot(col, kTE3, rx + col(kTE3), ry + col(kTE3 + 1),
                            rz + col(kTE3 + 2));
  const bool inside = (s1 > 0.0f && s2 > 0.0f && s3 > 0.0f) ||
                      (s1 < 0.0f && s2 < 0.0f && s3 < 0.0f);
  const bool valid = d_n < 0.0f && inside && t >= t_min && col(kTValid) > 0.0f;
  return valid ? t : CUDART_INF_F;
}

__device__ __forceinline__ float hit_tri(const float* r, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float t_min) {
  return tri_t([r](int k) { return __ldg(r + k); }, ox, oy, oz, dx, dy, dz,
               t_min);
}

// Whether the shadow segment s + t w, t in [t_min, kTHi], meets one
// sphere (`sph_shadow_math` :864-880): the expanded quadratic with
// 1 / max(a, 1e-20) multiplied in, either root in the segment. 23 FP32
// operations, as the closest-hit test.
__device__ __forceinline__ bool shadow_sphere(float4 c, const float* valid,
                                              float sx, float sy, float sz,
                                              float wx, float wy, float wz,
                                              float a_s, float rd_ro,
                                              float ro_sq, float inv_a,
                                              float t_min) {
  const float hb = rd_ro - (c.x * wx + c.y * wy + c.z * wz);
  const float c_term = ro_sq - 2.0f * (c.x * sx + c.y * sy + c.z * sz) + c.w;
  const float disc = hb * hb - a_s * c_term;
  const float sqrtd = sqrtf(fmaxf(disc, 0.0f));
  const float r1 = (-hb - sqrtd) * inv_a;
  const float r2 = (-hb + sqrtd) * inv_a;
  return disc >= 0.0f && *valid > 0.0f &&
         ((r1 >= t_min && r1 <= kTHi) || (r2 >= t_min && r2 <= kTHi));
}

// The NEE shadow ray's any-hit (`_shadow_occluded` :831-1009): whether
// anything lies on s + t w, t in [t_min, kTHi]. A rect, cylinder or
// triangle occludes exactly when its closest-hit candidate t is at most
// kTHi (the reference's any-hit tests are the candidate tests with that
// bound added). It returns at the first occluder.
template <bool kTail, bool kFamilies>
__device__ __forceinline__ bool shadow_any_hit(const Scene& s, float sx,
                                            float sy, float sz, float wx,
                                            float wy, float wz) {
  const float a_s = wx * wx + wy * wy + wz * wz;
  const float rd_ro = wx * sx + wy * sy + wz * sz;
  const float ro_sq = sx * sx + sy * sy + sz * sz;
  const float inv_a = 1.0f / fmaxf(a_s, 1e-20f);
  // rows [j0, j1) of the sphere table, staged or (kTail) in global memory
  const auto spheres = [&](int j0, int j1) {
    const int staged = j1 < s.n_smem ? j1 : s.n_smem;
    for (int j = j0; j < staged; ++j)
      if (shadow_sphere(s.hit4[j], s.valid + j, sx, sy, sz, wx, wy, wz, a_s,
                        rd_ro, ro_sq, inv_a, s.t_min))
        return true;
    if (kTail) {
      for (int j = j0 > s.n_smem ? j0 : s.n_smem; j < j1; ++j) {
        const float* r = s.table + static_cast<size_t>(j) * kCols;
        if (shadow_sphere(make_float4(__ldg(r + kV), __ldg(r + kV + 1),
                                      __ldg(r + kV + 2), __ldg(r + kC2r)),
                          r + kValid, sx, sy, sz, wx, wy, wz, a_s, rd_ro,
                          ro_sq, inv_a, s.t_min))
          return true;
      }
    }
    return false;
  };
  if (s.sbnd) {
    for (int c = 0; c < s.n; c += kChunk)
      if (box_visible(s.sbnd + (c / kChunk) * kBoxCols, sx, sy, sz, wx, wy,
                      wz, s.t_min, kTHi) &&
          spheres(c, c + kChunk < s.n ? c + kChunk : s.n))
        return true;
  } else if (spheres(0, s.n)) {
    return true;
  }
  if constexpr (kFamilies) {
    for (int j = 0; j < s.n_rect; ++j)
      if (hit_rect(s.rect + static_cast<size_t>(j) * kFCols, sx, sy, sz, wx,
                   wy, wz, s.t_min) <= kTHi)
        return true;
    for (int j = 0; j < s.n_cyl; ++j)
      if (hit_cyl(s.cyl + static_cast<size_t>(j) * kFCols, sx, sy, sz, wx,
                  wy, wz, s.t_min) <= kTHi)
        return true;
    for (int c = 0; c < s.n_tri; c += kChunk) {
      if (s.tbnd && !box_visible(s.tbnd + (c / kChunk) * kBoxCols, sx, sy, sz,
                                 wx, wy, wz, s.t_min, kTHi))
        continue;
      const int end = c + kChunk < s.n_tri ? c + kChunk : s.n_tri;
      for (int j = c; j < end; ++j)
        if (hit_tri(s.tri + static_cast<size_t>(j) * kFCols, sx, sy, sz, wx,
                    wy, wz, s.t_min) <= kTHi)
          return true;
    }
  }
  return false;
}

// x clamped to [-1, 1]; a NaN stays NaN, as torch.clamp keeps it
__device__ __forceinline__ float clamp1(float x) {
  return x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
}

// (u, v) of the unit outward offset (ux, uy, uz) of a sphere point
// (object.cuh:87-93, pallas_mega.py:1336-1344): the azimuth about y from
// -z and the polar angle from -y, scaled to [0, 1].
__device__ __forceinline__ void sphere_uv(float ux, float uy, float uz,
                                          float& u, float& v) {
  const bool az = uz == 0.0f && ux == 0.0f;
  u = (atan2f(-uz, az ? 1.0f : ux) + kPi) * kInv2Pi;
  v = acosf(clamp1(-uy)) * kInvPi;
}

// The winner's (u, v) at the hit p (pallas_mega.py:1327-1390): a
// sphere's from its centre c and 1 / radius (11 FP32 operations, atan2f
// and acosf counted as one each), a rect's (14), a cylinder's (23) or a
// triangle's (53: the standard barycentric weights; Taichi's swapped ones
// come from the tables, SceneDef.taichi_tri_uv) from its UV table row.
template <bool kFamilies>
__device__ __forceinline__ void winner_uv(const ImageScene& s, int fam,
                                          int row,
                                          float cx, float cy, float cz,
                                          float inv_rad, float px, float py,
                                          float pz, float& u, float& v) {
  if (!kFamilies || fam == kFamSphere) {
    sphere_uv((px - cx) * inv_rad, (py - cy) * inv_rad, (pz - cz) * inv_rad,
              u, v);
    return;
  }
  const float* r =
      (fam == kFamRect ? s.uv_rect : (fam == kFamCyl ? s.uv_cyl : s.uv_tri)) +
      static_cast<size_t>(row) * kUCols;
  if (fam == kFamRect) {
    u = (odot(r, 0, px, py, pz) - __ldg(r + 6)) * __ldg(r + 8);
    v = (odot(r, 3, px, py, pz) - __ldg(r + 7)) * __ldg(r + 9);
  } else if (fam == kFamCyl) {
    const float cpx = odot(r, 0, px, py, pz) + __ldg(r + 9);
    const float cpy = odot(r, 3, px, py, pz) + __ldg(r + 10);
    const float cpz = odot(r, 6, px, py, pz) + __ldg(r + 11);
    const bool deg = cpy == 0.0f && cpx == 0.0f;
    u = (atan2f(cpy, deg ? 1.0f : cpx) + k2Pi) * kInv4Pi;
    v = (cpz - __ldg(r + 12)) * __ldg(r + 13);
  } else {
    const float a1x = __ldg(r + 3) - px, a1y = __ldg(r + 4) - py,
                a1z = __ldg(r + 5) - pz;  // v2 - p
    const float a2x = __ldg(r + 6) - px, a2y = __ldg(r + 7) - py,
                a2z = __ldg(r + 8) - pz;  // v3 - p
    const float a3x = __ldg(r + 0) - px, a3y = __ldg(r + 1) - py,
                a3z = __ldg(r + 2) - pz;  // v1 - p
    const float cx1 = a1y * a2z - a1z * a2y;
    const float cy1 = a1z * a2x - a1x * a2z;
    const float cz1 = a1x * a2y - a1y * a2x;
    const float l1 = sqrtf(cx1 * cx1 + cy1 * cy1 + cz1 * cz1) * __ldg(r + 9);
    const float cx2 = a2y * a3z - a2z * a3y;
    const float cy2 = a2z * a3x - a2x * a3z;
    const float cz2 = a2x * a3y - a2y * a3x;
    const float l2 = sqrtf(cx2 * cx2 + cy2 * cy2 + cz2 * cz2) * __ldg(r + 9);
    float l3 = 1.0f - l1 - l2;
    l3 = l3 > 0.0f ? l3 : 0.0f;
    u = __ldg(r + 10) * l1 + __ldg(r + 12) * l2 + __ldg(r + 14) * l3;
    v = __ldg(r + 11) * l1 + __ldg(r + 13) * l2 + __ldg(r + 15) * l3;
  }
}

// The nearest texel of u along an axis of n texels: u wrapped to [0, 1),
// times n, clamped to [0, n - 1] (fmaxf puts a NaN on 0) and truncated.
__device__ __forceinline__ int texel_axis(float u, int n) {
  const float f = (u - floorf(u)) * static_cast<float>(n);
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

// The texel of image img at (u, v), a float3 index into the atlas: u
// picks the row of the image's img_th, v the column of its img_tw
// (taichi material.py:137-144).
__device__ __forceinline__ int texel_of(const ImageScene& s, int img, float u,
                                        float v) {
  return (img * s.img_th + texel_axis(u, s.img_th)) * s.img_tw +
         texel_axis(v, s.img_tw);
}

// The colour of a texel, one float3 read through the read-only cache.
__device__ __forceinline__ void texel_rgb(const ImageScene& s, int texel,
                                          float& r, float& g, float& b) {
  const float* t = s.atlas + 3 * static_cast<size_t>(texel);
  r = __ldg(t);
  g = __ldg(t + 1);
  b = __ldg(t + 2);
}

// The metal's fuzz-ball density about the mirror direction
// (pallas_mega.py:1675-1684, :1853-1861): fuzz^3 as fuzz * (fuzz * fuzz).
__device__ __forceinline__ float glossy_density(float cosr, float fuzz) {
  const float s2 = fuzz * fuzz - (1.0f - cosr * cosr);
  if (!(cosr > 0.0f && s2 > 0.0f && fuzz > 0.0f)) return 0.0f;
  const float sq = sqrtf(fmaxf(s2, 0.0f));
  const float f = fmaxf(fuzz, 1e-8f);
  return sq * (3.0f * cosr * cosr + s2) / (k2Pi * (f * (f * f)));
}

// The weight of the emission a bounce under NEE adds (:1487-1527): under
// MIS the balance heuristic against the previous bounce's density
// (alive = 2 + p_prev; p_prev 0: weight 1), the hit emitter's area from
// its light row, matched by family and SceneTables row; without MIS 0
// after a light-sampled bounce (alive 0.5), else 1.
__device__ __forceinline__ float emission_weight(
    const Scene& s, float alive, int fam, int row, float px, float py,
    float pz, float ox, float oy, float oz, float nx, float ny, float nz) {
  if (!s.mis) return alive == 0.5f ? 0.0f : 1.0f;
  float area_h = 0.0f;
  const float srow = static_cast<float>(scene_row(s, fam, row));
  for (int k = 0; k < s.n_lights; ++k) {
    const float* l = s.lights + static_cast<size_t>(k) * kLCols;
    if (__ldg(l + kLFam) == static_cast<float>(fam) &&
        __ldg(l + kLRow) == srow) {
      area_h = __ldg(l + kLArea);
      break;
    }
  }
  const float vx = px - ox, vy = py - oy, vz = pz - oz;
  const float d2h = fmaxf(vx * vx + vy * vy + vz * vz, 1e-8f);
  const float cos_lh = fabsf(nx * vx + ny * vy + nz * vz) / sqrtf(d2h);
  const float p_nh =
      d2h / (fmaxf(area_h * static_cast<float>(s.n_lights), 1e-8f) *
             fmaxf(cos_lh, 1e-6f));
  const float p_prev = fmaxf(alive - 2.0f, 0.0f);
  return p_prev > 0.0f ? p_prev / (p_prev + p_nh + 1e-20f) : 1.0f;
}

// The direct-light sample of a light-sampling bounce (:1529-1698): one
// light picked uniformly, a point on it from its sampling block, the
// shadow ray from the hit point p, and the weight okl (0 below the
// horizon or occluded) of the term tp * albedo * Le * okl; Le is the
// light's colour by its checker parity at the sample point. lslot and
// lodd: the light's gradient slot and that parity (the adjoint's credit
// to the light). ref: the mirror direction (glossy metal lanes). With
// kImages an image-textured light's Le is the atlas texel at the light
// point's (u, v), in its family's hit convention (`nee_img`
// :1623-1664), and ltexel is that texel (-1: none).
struct NeeSample {
  float okl, ler, leg, leb;
  int lslot;
  bool lodd;
  int ltexel;
};

template <bool kTail, bool kFamilies, bool kImages = false,
          bool kQmc = false>
__device__ __forceinline__ NeeSample nee_sample(
    const SceneOf<kImages>& s, const Draw& pre, float px, float py, float pz,
    float nx, float ny, float nz, bool is_met, float fuzz, float ref_x,
    float ref_y, float ref_z) {
  NeeSample out{0.0f, 0.0f, 0.0f, 0.0f, 0, false, -1};
  const float u_pick = uniform<kQmc>(pre, kNeePick);
  const float u1 = uniform<kQmc>(pre, kNeeU1);
  const float u2 = uniform<kQmc>(pre, kNeeU2);
  int li = static_cast<int>(u_pick * static_cast<float>(s.n_lights));
  if (li > s.n_lights - 1) li = s.n_lights - 1;
  const float* lt = s.lights + static_cast<size_t>(li) * kLCols;
  const float fam_l = __ldg(lt + kLFam);
  const float phi = k2Pi * u2;
  const float cphi = cosf(phi), sphi = sinf(phi);
  float lpx, lpy, lpz, lnx, lny, lnz;
  float lu = 0.0f, lv = 0.0f;  // the light point's (u, v), with kImages
  if (fam_l == static_cast<float>(kFamSphere)) {
    const float zs = 1.0f - 2.0f * u1;
    const float sts = sqrtf(fmaxf(0.0f, 1.0f - zs * zs));
    lnx = sts * cphi;
    lny = sts * sphi;
    lnz = zs;
    lpx = __ldg(lt + 9) + __ldg(lt + 12) * lnx;
    lpy = __ldg(lt + 10) + __ldg(lt + 12) * lny;
    lpz = __ldg(lt + 11) + __ldg(lt + 12) * lnz;
    if constexpr (kImages) sphere_uv(lnx, lny, lnz, lu, lv);
  } else if (fam_l == static_cast<float>(kFamRect)) {
    const float ra = __ldg(lt + 18) + u1 * __ldg(lt + 20);
    const float rb = __ldg(lt + 19) + u2 * __ldg(lt + 21);
    const float k = __ldg(lt + 22);
    lpx = __ldg(lt + 9) * k + __ldg(lt + 12) * ra + __ldg(lt + 15) * rb;
    lpy = __ldg(lt + 10) * k + __ldg(lt + 13) * ra + __ldg(lt + 16) * rb;
    lpz = __ldg(lt + 11) * k + __ldg(lt + 14) * ra + __ldg(lt + 17) * rb;
    lnx = __ldg(lt + 9);
    lny = __ldg(lt + 10);
    lnz = __ldg(lt + 11);
    lu = u1;
    lv = u2;
  } else if (fam_l == static_cast<float>(kFamCyl)) {
    const float zc = __ldg(lt + 22) + u1 * __ldg(lt + 23);
    const float cox = __ldg(lt + 21) * cphi;
    const float coy = __ldg(lt + 21) * sphi;
    lpx = __ldg(lt + 9) * cox + __ldg(lt + 10) * coy + __ldg(lt + 11) * zc +
          __ldg(lt + 18);
    lpy = __ldg(lt + 12) * cox + __ldg(lt + 13) * coy + __ldg(lt + 14) * zc +
          __ldg(lt + 19);
    lpz = __ldg(lt + 15) * cox + __ldg(lt + 16) * coy + __ldg(lt + 17) * zc +
          __ldg(lt + 20);
    lnx = __ldg(lt + 9) * cphi + __ldg(lt + 10) * sphi;
    lny = __ldg(lt + 12) * cphi + __ldg(lt + 13) * sphi;
    lnz = __ldg(lt + 15) * cphi + __ldg(lt + 16) * sphi;
    if constexpr (kImages) lu = (atan2f(sphi, cphi) + k2Pi) * kInv4Pi;
    lv = u1;
  } else {  // triangle: v1 + b2 e1 + b3 e2, the sqrt barycentric warp
    const float sqt = sqrtf(u1);
    const float b2t = sqt * (1.0f - u2);
    const float b3t = sqt * u2;
    lpx = __ldg(lt + 9) + b2t * __ldg(lt + 12) + b3t * __ldg(lt + 15);
    lpy = __ldg(lt + 10) + b2t * __ldg(lt + 13) + b3t * __ldg(lt + 16);
    lpz = __ldg(lt + 11) + b2t * __ldg(lt + 14) + b3t * __ldg(lt + 17);
    lnx = __ldg(lt + 18);
    lny = __ldg(lt + 19);
    lnz = __ldg(lt + 20);
    if constexpr (kImages) {
      const float b1t = 1.0f - sqt;
      lu = b1t * __ldg(lt + kLUv) + b2t * __ldg(lt + kLUv + 2) +
           b3t * __ldg(lt + kLUv + 4);
      lv = b1t * __ldg(lt + kLUv + 1) + b2t * __ldg(lt + kLUv + 3) +
           b3t * __ldg(lt + kLUv + 5);
    }
  }
  const float wix = lpx - px, wiy = lpy - py, wiz = lpz - pz;
  const float d2l = fmaxf(wix * wix + wiy * wiy + wiz * wiz, 1e-8f);
  const float distl = sqrtf(d2l);
  const float cos_s = (nx * wix + ny * wiy + nz * wiz) / distl;
  if (!(cos_s > 0.0f)) return out;  // below the horizon
  if (shadow_any_hit<kTail, kFamilies>(s, px, py, pz, wix, wiy, wiz))
    return out;
  const float cos_lg = fabsf(lnx * wix + lny * wiy + lnz * wiz) / distl;
  const float sin_l = sinf(10.0f * lpx) * sinf(10.0f * lpy) * sinf(10.0f * lpz);
  out.lodd = __ldg(lt + kLChecker) > 0.0f && sin_l < 0.0f;
  const int le = out.lodd ? kLLe2 : kLLe;
  out.ler = __ldg(lt + le);
  out.leg = __ldg(lt + le + 1);
  out.leb = __ldg(lt + le + 2);
  if constexpr (kImages) {
    const float limg = __ldg(lt + kLImg);
    if (limg >= 0.0f) {
      out.ltexel = texel_of(s, static_cast<int>(limg), lu, lv);
      texel_rgb(s, out.ltexel, out.ler, out.leg, out.leb);
    }
  }
  out.lslot = static_cast<int>(__ldg(lt + kLSlot));
  const float area_l = __ldg(lt + kLArea);
  const float cs = fmaxf(cos_s, 0.0f);
  if (s.mis || s.glossy) {
    float p_bl = k2OverPi * cs * cs * cs;
    if (s.glossy && is_met)
      p_bl = glossy_density(
          (ref_x * wix + ref_y * wiy + ref_z * wiz) / distl, fuzz);
    const float p_nl =
        d2l / (fmaxf(area_l * static_cast<float>(s.n_lights), 1e-8f) *
               fmaxf(cos_lg, 1e-6f));
    out.okl = s.mis ? p_bl / (p_nl + p_bl + 1e-20f)
                    : p_bl / fmaxf(p_nl, 1e-20f);
  } else {
    out.okl = (cs * cs * cs * cos_lg / d2l) * area_l * s.nee_w;
  }
  return out;
}

// What the adjoint bounce reads besides the lane: the sample's radiance
// L and its cotangent g, and the accumulators it adds to (shared or
// global memory: [kBgRow * n_slots + 3] floats, see kBgRow).
struct Adj {
  float Lr, Lg, Lb, gr, gg, gb;
  float* acc;
  int n_slots;
  float* gimg;  // the atlas gradient [Ni * TH * TW * 3] (kImages), global
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

// Add one cotangent per channel to a texel's row of the atlas gradient.
__device__ __forceinline__ void credit_texel(const Adj& adj, int texel,
                                             float cr, float cg, float cb) {
  float* t = adj.gimg + 3 * static_cast<size_t>(texel);
  if (cr != 0.0f) atomicAdd(t, cr);
  if (cg != 0.0f) atomicAdd(t + 1, cg);
  if (cb != 0.0f) atomicAdd(t + 2, cb);
}

// Add a cotangent to what its colour came from: with kImages the texel
// (texel >= 0, an image texture), else the slot, as credit_slot (without
// kImages the code is credit_slot's).
template <bool kImages>
__device__ __forceinline__ void credit_winner(const Adj& adj, int texel,
                                              int slot, bool odd, float cr,
                                              float cg, float cb) {
  if constexpr (kImages) {
    if (texel >= 0) {
      credit_texel(adj, texel, cr, cg, cb);
      return;
    }
  }
  credit_slot(adj, slot, odd, cr, cg, cb);
}

// The winner's gradient slot, the row of the adjoint accumulators its
// cotangents go to: column kSlot of a sphere row, kFSlot of a family row.
template <bool kFamilies>
__device__ __forceinline__ int winner_slot(const float* w, int fam) {
  return static_cast<int>(
      w[kFamilies && fam != kFamSphere ? kFSlot : kSlot]);
}

// g * (L - C_after) / att where att != 0 (the reference's `_cot`)
__device__ __forceinline__ float att_cot(float g, float Lk, float c,
                                         float att) {
  return att != 0.0f ? g * (Lk - c) / att : 0.0f;
}

// ---- the warp-cooperative closest hit (B2-B7) ----
//
// Under culling a lane skips the chunks its ray misses, but a warp runs
// the union of its lanes' chunks: 32 rows in turn, with the lanes that
// skip the chunk masked off. After the first bounce a queue warp's lanes
// hold unrelated rays, and a megakernel warp's lanes die one by one, so
// few of them need each chunk and much of the row loop runs masked.
// When at most kDenseMax lanes need a chunk the warp tests it densely
// instead: thread l holds row c + l, and for each
// needing ray in turn (its origin, direction and constants shuffled from
// its lane) every thread tests that ray against its own row, and the
// warp reduces to the closest row. Above kDenseMax the needing lanes run
// the per-lane row loop, which then wastes little.

constexpr unsigned kFull = 0xFFFFFFFFu;

// Needing lanes at or below which the warp tests a chunk densely: a
// compile-time constant (chip_smoke.py builds scratch libraries with
// -DRTT_DENSE_MAX=0, the per-lane schedule, and 32, always dense).
#ifndef RTT_DENSE_MAX
#define RTT_DENSE_MAX 16
#endif
constexpr int kDenseMax = RTT_DENSE_MAX;
static_assert(kDenseMax >= 0 && kDenseMax <= 32, "kDenseMax in [0, 32]");

// The smallest candidate t of the warp's 32 rows and, among equal t, the
// largest row whose bit is set in `rows` (the rows the chunk holds): the
// row a sequential `<=` loop over the rows in ascending order ends on,
// and the t it holds (the winner's own bits, returned in t_win). Every
// lane of the warp calls it. t is >= t_min or +inf and never NaN, so the
// order key below orders the candidates as floats do; -0.0f (t_min 0)
// first becomes +0.0f, since the float compare holds -0 and +0 equal and
// the key would not.
__device__ __forceinline__ int warp_last_min(float t, unsigned rows,
                                             float& t_win) {
  const unsigned bits = __float_as_uint(t + 0.0f);
  // a float's order as an unsigned integer (negatives flipped)
  const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned least = __reduce_min_sync(kFull, key);
  const int last = 31 - __clz(__ballot_sync(kFull, key == least) & rows);
  t_win = __shfl_sync(kFull, t, last);
  return last;
}

// The hit columns of one triangle row, held in registers by the thread
// that tests it (tri_t reads them through the accessor below).
struct TriRow {
  float v[kTValid + 1];
  __device__ __forceinline__ float operator()(int k) const { return v[k]; }
};

__device__ __forceinline__ TriRow load_tri(const float* r) {
  TriRow row;
#pragma unroll
  for (int k = 0; k < 3; ++k) row.v[kV + k] = __ldg(r + kV + k);
#pragma unroll
  for (int k = kTV1; k <= kTValid; ++k) row.v[k] = __ldg(r + k);
  return row;
}

// The mask of the rows [c, end) of a chunk, bit l for row c + l.
__device__ __forceinline__ unsigned chunk_rows(int c, int end) {
  return end - c >= 32 ? kFull : (1u << (end - c)) - 1u;
}

// The closest hit of do_bounce (see above): every lane of
// the warp calls it, `active` those with a ray; the others help. It folds
// each family into (t_best, fam_best, id_best) in do_bounce's order and
// with its `<=` rule: the sorted spheres chunk by chunk (densely when at
// most kDenseMax lanes need a chunk, else do_bounce's per-lane loop
// `spheres(j0, j1)`), then per lane the rects and cylinders
// (`rects_cyls()`), then the triangles (`tris(j0, j1)` per lane, by
// chunks as the spheres when sorted). Without culling every lane with a
// ray needs every row, so the per-lane loops run.
template <bool kTail, bool kFamilies, class Spheres, class RectsCyls,
          class Tris>
__device__ __forceinline__ void warp_hit(
    const Scene& s, bool active, const Spheres& spheres,
    const RectsCyls& rects_cyls, const Tris& tris, float ox, float oy,
    float oz, float dx, float dy, float dz, float a, float rd_dot_ro,
    float ro_sq, float inv_a, float& t_best, int& fam_best, int& id_best) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  if (s.sbnd) {
    for (int c = 0; c < s.n; c += kChunk) {
      const int end = c + kChunk < s.n ? c + kChunk : s.n;
      const bool need =
          active && box_visible(s.sbnd + (c / kChunk) * kBoxCols, ox, oy, oz,
                                dx, dy, dz, s.t_min, t_best);
      const unsigned needs = __ballot_sync(kFull, need);
      if (needs == 0u) continue;
      if (__popc(needs) > kDenseMax) {
        if (need) spheres(c, end);
        continue;
      }
      // thread `lane` holds row c + lane (past the table: no hit)
      const int j = c + lane;
      float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float v = 0.0f;
      if (j < s.n_smem) {
        h = s.hit4[j];
        v = s.valid[j];
      } else if (kTail && j < end) {
        const float* r = s.table + static_cast<size_t>(j) * kCols;
        h = make_float4(__ldg(r + kV), __ldg(r + kV + 1), __ldg(r + kV + 2),
                        __ldg(r + kC2r));
        v = __ldg(r + kValid);
      }
      const unsigned rows = chunk_rows(c, end);
      for (unsigned m = needs; m; m &= m - 1u) {
        const int src = __ffs(m) - 1;
        const float t = sphere_t(
            h, &v, __shfl_sync(kFull, ox, src), __shfl_sync(kFull, oy, src),
            __shfl_sync(kFull, oz, src), __shfl_sync(kFull, dx, src),
            __shfl_sync(kFull, dy, src), __shfl_sync(kFull, dz, src),
            __shfl_sync(kFull, a, src), __shfl_sync(kFull, rd_dot_ro, src),
            __shfl_sync(kFull, ro_sq, src), __shfl_sync(kFull, inv_a, src),
            s.t_min);
        float tw;
        const int row = c + warp_last_min(t, rows, tw);
        if (lane == src && tw <= t_best) {
          t_best = tw;
          id_best = row;
        }
      }
    }
  } else if (active) {
    spheres(0, s.n);
  }

  if constexpr (kFamilies) {
    if (active) rects_cyls();
    if (!s.tbnd) {
      if (active) tris(0, s.n_tri);
      return;
    }
    for (int c = 0; c < s.n_tri; c += kChunk) {
      const int end = c + kChunk < s.n_tri ? c + kChunk : s.n_tri;
      const bool need =
          active && box_visible(s.tbnd + (c / kChunk) * kBoxCols, ox, oy, oz,
                                dx, dy, dz, s.t_min, t_best);
      const unsigned needs = __ballot_sync(kFull, need);
      if (needs == 0u) continue;
      if (__popc(needs) > kDenseMax) {
        if (need) tris(c, end);
        continue;
      }
      const int j = c + lane;
      TriRow tri{};  // past the table: all zero, so no hit
      if (j < end) tri = load_tri(s.tri + static_cast<size_t>(j) * kFCols);
      const unsigned rows = chunk_rows(c, end);
      for (unsigned m = needs; m; m &= m - 1u) {
        const int src = __ffs(m) - 1;
        const float t = tri_t(
            tri, __shfl_sync(kFull, ox, src), __shfl_sync(kFull, oy, src),
            __shfl_sync(kFull, oz, src), __shfl_sync(kFull, dx, src),
            __shfl_sync(kFull, dy, src), __shfl_sync(kFull, dz, src),
            s.t_min);
        float tw;
        const int row = c + warp_last_min(t, rows, tw);
        if (lane == src && tw <= t_best) {  // take()'s rule
          t_best = tw;
          fam_best = kFamTri;
          id_best = row;
        }
      }
    }
  }
}

// Advance a live lane (alive > 0) one bounce at RNG coordinate `pre`
// (rng.cuh Draw of seed, pixel, sample, bounce under the scene's
// sampler). Every lane of the warp calls it together (warp_hit), those
// with a lane to advance with `active`; the others only help with the
// hit and leave L as it is. A lane that does
// not scatter leaves with alive = 0. kAdjoint also adds the bounce's
// cotangents to adj's accumulators (see ops/adjoint_plain.py); the lane
// advances exactly as in the forward. kTail (a table of more than
// kStageRows rows) compiles the loop over the rows in global memory:
// its mere presence slowed the megakernel by 9% on tables that do not
// need it (PERF.md, PR 6), so the kernels instantiate both and the
// launchers choose (has_tail). kCapture (the tape capture, capture.cu)
// also reports the winner's tape code in *code, `family << 24 | row`
// with its SceneTables row (scene_row; pallas_mega.py:1882-1892), or
// -1 on a miss: it runs the hit pass
// before it applies the roulette, so that a lane the roulette stops
// still records this bounce's winner, as the reference's kernel does
// (it evaluates the hit on every lane): such a lane enters warp_hit as
// an active lane with its own chunk decisions, writes its code and only
// then stops. Without kCapture a lane that the roulette stops leaves the
// hit to the others. kFamilies
// (a scene with rect, cylinder or triangle rows, has_families) compiles
// their hit loops after the spheres' and the winner's reads from its
// family's table, its gradient slot from column kFSlot (a sphere's is
// kSlot); every kernel instantiates it beside the sphere-only code,
// where the family is the constant kFamSphere and the code compiles as
// it did before the families, and the launchers choose. kNee (a scene
// with lights under cfg.nee, has_nee) weights a hit emitter's emission
// (emission_weight), adds a light-sampling bounce's direct term
// (nee_sample: lambertian lanes, and with s.glossy metal lanes of fuzz >
// 0) and marks the lane's alive word for the next bounce (0.5, or under
// MIS 2 + the density of the direction drawn); with kAdjoint it also
// credits the direct term to the winner's slot and to the light's.
// kImages (a scene whose primitives sample image textures; s is then an
// ImageScene)
// gives a winner whose column kImgId holds an image id the atlas texel at
// its (u, v) as its albedo, and under kNee an image-textured light its
// texel at the light point; with kAdjoint such a winner's or light's
// cotangents go to the texel's row of the atlas gradient, not to its
// slot. kQmc draws from the scrambled Sobol' sequence (rng.cuh), `pre`
// then keyed on kQmcTag.
template <bool kAdjoint, bool kTail, bool kCapture = false,
          bool kFamilies = false, bool kNee = false, bool kImages = false,
          bool kQmc = false>
__device__ __forceinline__ void do_bounce(const SceneOf<kImages>& s, Lane& L,
                                          const Draw& pre, const Adj& adj,
                                          int* code, bool active) {
  // every lane of the warp is here; those without a ray to advance only
  // help with the hit and leave L as it is
  bool rr_stop = false;
  if (active && s.p_rr > 0.0f && !(uniform<kQmc>(pre, kRR) <= s.p_rr)) {
    if constexpr (!kCapture) {
      L.alive = 0.0f;  // roulette: the lane stops and adds nothing
      active = false;
    } else {
      rr_stop = true;  // it still takes its part in the hit, below
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
  int fam_best = kFamSphere;
  // rows [j0, j1) of the sphere table, staged or (kTail) in global memory
  const auto spheres = [&](int j0, int j1) {
    const int staged = j1 < s.n_smem ? j1 : s.n_smem;
    for (int j = j0; j < staged; ++j)
      hit_row(s.hit4[j], s.valid + j, j, ox, oy, oz, dx, dy, dz, a,
              rd_dot_ro, ro_sq, inv_a, s.t_min, t_best, id_best);
    if (kTail) {
      for (int j = j0 > s.n_smem ? j0 : s.n_smem; j < j1; ++j) {
        const float* r = s.table + static_cast<size_t>(j) * kCols;
        hit_row(make_float4(__ldg(r + kV), __ldg(r + kV + 1),
                            __ldg(r + kV + 2), __ldg(r + kC2r)),
                r + kValid, j, ox, oy, oz, dx, dy, dz, a, rd_dot_ro, ro_sq,
                inv_a, s.t_min, t_best, id_best);
      }
    }
  };
  // the rects and cylinders, then triangle rows [j0, j1) (kFamilies)
  const auto rects_cyls = [&]() {
    for (int j = 0; j < s.n_rect; ++j)
      take(hit_rect(s.rect + static_cast<size_t>(j) * kFCols, ox, oy, oz, dx,
                    dy, dz, s.t_min),
           kFamRect, j, t_best, fam_best, id_best);
    for (int j = 0; j < s.n_cyl; ++j)
      take(hit_cyl(s.cyl + static_cast<size_t>(j) * kFCols, ox, oy, oz, dx,
                   dy, dz, s.t_min),
           kFamCyl, j, t_best, fam_best, id_best);
  };
  const auto tris = [&](int j0, int j1) {
    for (int j = j0; j < j1; ++j)
      take(hit_tri(s.tri + static_cast<size_t>(j) * kFCols, ox, oy, oz, dx,
                   dy, dz, s.t_min),
           kFamTri, j, t_best, fam_best, id_best);
  };
  warp_hit<kTail, kFamilies>(s, active, spheres, rects_cyls, tris, ox, oy,
                             oz, dx, dy, dz, a, rd_dot_ro, ro_sq, inv_a,
                             t_best, fam_best, id_best);
  if (!active) return;

  if constexpr (kCapture) {
    *code = t_best < CUDART_INF_F
                ? (fam_best << 24) | scene_row(s, fam_best, id_best)
                : -1;
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

  // ---- the winner's attributes, by its family and row ----
  const float* w = s.table + id_best * kCols;
  if (kFamilies && fam_best != kFamSphere)
    w = (fam_best == kFamRect ? s.rect
                              : (fam_best == kFamCyl ? s.cyl : s.tri)) +
        static_cast<size_t>(id_best) * kFCols;
  float v0 = w[kV], v1 = w[kV + 1], v2 = w[kV + 2];
  const float v3 = w[kRad];
  if (kFamilies && fam_best == kFamCyl) {
    // the world normal at the hit (`cyl_body` :1201-1212): the
    // object-space radial direction, normalised by rsqrt (torch.rsqrt
    // on the card is the same rsqrtf), through the w2o rows transposed
    const float oox = odot(w, kYR, ox, oy, oz) + w[kYT];
    const float ooy = odot(w, kYR + 3, ox, oy, oz) + w[kYT + 1];
    const float odx = odot(w, kYR, dx, dy, dz);
    const float ody = odot(w, kYR + 3, dx, dy, dz);
    const float opx = oox + t_best * odx;
    const float opy = ooy + t_best * ody;
    const float ln2 = opx * opx + opy * opy;
    const float inv_ln = rsqrtf(ln2 > 0.0f ? ln2 : 1.0f);
    const float nox = opx * inv_ln;
    const float noy = opy * inv_ln;
    v0 = w[kYR] * nox + w[kYR + 3] * noy;
    v1 = w[kYR + 1] * nox + w[kYR + 4] * noy;
    v2 = w[kYR + 2] * nox + w[kYR + 5] * noy;
  }
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

  // image texture: the atlas texel at the winner's (u, v)
  int texel = -1;
  if constexpr (kImages) {
    const float img = w[kImgId];
    if (img >= 0.0f) {
      float u, v;
      winner_uv<kFamilies>(s, fam_best, id_best, v0, v1, v2, inv_rad, px, py,
                           pz, u, v);
      texel = texel_of(s, static_cast<int>(img), u, v);
      texel_rgb(s, texel, alb_r, alb_g, alb_b);
    }
  }

  if (mtype == kDiffuseLight) {  // emits and stops
    if constexpr (kNee) {
      const float em = emission_weight(s, L.alive, fam_best, id_best, px, py,
                                       pz, ox, oy, oz, nx, ny, nz);
      if (kAdjoint && em != 0.0f)  // d(g.L)/d(emission) = g * P * em
        credit_winner<kImages>(adj, texel,
                               winner_slot<kFamilies>(w, fam_best), use2,
                               adj.gr * L.tpr * em, adj.gg * L.tpg * em,
                               adj.gb * L.tpb * em);
      L.cr = L.cr + L.tpr * (em * alb_r);
      L.cg = L.cg + L.tpg * (em * alb_g);
      L.cb = L.cb + L.tpb * (em * alb_b);
    } else {
      if (kAdjoint)  // d(g.L)/d(emission) = g * P
        credit_winner<kImages>(adj, texel,
                               winner_slot<kFamilies>(w, fam_best), use2,
                               adj.gr * L.tpr, adj.gg * L.tpg,
                               adj.gb * L.tpb);
      L.cr = L.cr + L.tpr * alb_r;
      L.cg = L.cg + L.tpg * alb_g;
      L.cb = L.cb + L.tpb * alb_b;
    }
    L.alive = 0.0f;
    return;
  }

  // ---- scatter ----
  float new_dx, new_dy, new_dz;
  float ref_x = 0.0f, ref_y = 0.0f, ref_z = 0.0f;  // mirror (not lambertian)
  if (mtype == kLambertian) {
    float bx, by, bz;
    unit_ball<kQmc>(pre, bx, by, bz);
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
    ref_x = ux - 2.0f * u_dot_n * nx;
    ref_y = uy - 2.0f * u_dot_n * ny;
    ref_z = uz - 2.0f * u_dot_n * nz;
    if (mtype == kMetal) {
      float bx, by, bz;
      unit_ball<kQmc>(pre, bx, by, bz);
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
      if (cannot || schlick > uniform<kQmc>(pre, kDielRefl)) {
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

  // ---- next-event estimation: the direct term of a light-sampling
  // bounce (lambertian; with glossy, metal of fuzz > 0) ----
  bool sampled = false;
  NeeSample ns{0.0f, 0.0f, 0.0f, 0.0f, 0, false, -1};
  if constexpr (kNee) {
    sampled = mtype == kLambertian ||
              (s.glossy && mtype == kMetal && param > 0.0f);
    if (sampled) {
      ns = nee_sample<kTail, kFamilies, kImages, kQmc>(
          s, pre, px, py, pz, nx, ny, nz, mtype == kMetal, param, ref_x,
          ref_y, ref_z);
      if (ns.okl != 0.0f) {
        L.cr = L.cr + L.tpr * alb_r * ns.ler * ns.okl;
        L.cg = L.cg + L.tpg * alb_g * ns.leg * ns.okl;
        L.cb = L.cb + L.tpb * alb_b * ns.leb * ns.okl;
      }
    }
  }

  // d(g.L)/d(att) = g * (L - C_after) / att; C_after is the radiance
  // so far, which a scattering bounce changes only by its direct term.
  // A dielectric's attenuation is the constant 1 and takes none. Under
  // NEE the direct term tp * alb * Le * okl adds g * tp * Le * okl to
  // the winner's slot and g * tp * alb * okl to the light's
  // (pallas_mega.py:1725-1760).
  if (kAdjoint && mtype != kDielectric) {
    float c_r = att_cot(adj.gr, adj.Lr, L.cr, alb_r);
    float c_g = att_cot(adj.gg, adj.Lg, L.cg, alb_g);
    float c_b = att_cot(adj.gb, adj.Lb, L.cb, alb_b);
    if constexpr (kNee) {
      c_r = c_r + adj.gr * L.tpr * ns.ler * ns.okl;
      c_g = c_g + adj.gg * L.tpg * ns.leg * ns.okl;
      c_b = c_b + adj.gb * L.tpb * ns.leb * ns.okl;
    }
    credit_winner<kImages>(adj, texel, winner_slot<kFamilies>(w, fam_best),
                           use2, c_r, c_g, c_b);
    if constexpr (kNee) {
      if (ns.okl != 0.0f)
        credit_winner<kImages>(adj, ns.ltexel, ns.lslot, ns.lodd,
                               adj.gr * L.tpr * alb_r * ns.okl,
                               adj.gg * L.tpg * alb_g * ns.okl,
                               adj.gb * L.tpb * alb_b * ns.okl);
    }
  }

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
  if constexpr (kNee) {
    if (sampled && !s.mis) {
      L.alive = 0.5f;
    } else if (sampled) {  // 2 + the density of the direction drawn
      const float ndl =
          sqrtf(new_dx * new_dx + new_dy * new_dy + new_dz * new_dz);
      const float inl = 1.0f / fmaxf(ndl, 1e-12f);
      const float csd =
          fmaxf((nx * new_dx + ny * new_dy + nz * new_dz) * inl, 0.0f);
      float pb = k2OverPi * csd * csd * csd;
      if (mtype == kMetal)  // sampled: glossy, fuzz > 0
        pb = glossy_density(
            (ref_x * new_dx + ref_y * new_dy + ref_z * new_dz) * inl, param);
      L.alive = 2.0f + pb;
    }
  }
}

}  // namespace rtt
