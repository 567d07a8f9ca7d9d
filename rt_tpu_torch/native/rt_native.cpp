// rt_native: host-side native components for rt_tpu_torch.
//
// A copy of the JAX package's rt_tpu/native/rt_native.cpp with the same C
// ABI, so the port builds and loads it without reading the other package:
// the ASCII PPM writer of gpu-version/color.cuh and the (Taichi-side) BVH
// builder of taichi-version/bvh.py. These are the pieces that belong on
// the host CPU, where C++ beats Python by 1-2 orders of magnitude (an
// 11M-line ASCII PPM at 1440p, or a 100k-primitive BVH build per
// animation frame).
//
// Exposed via a plain C ABI consumed with ctypes (rt_tpu_torch/io/
// native.py, which builds it with g++ into rt_tpu_torch/_build/); no
// pybind11 dependency.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PPM writer: P3 ASCII, rows top-down, "r g b\n" per pixel — byte-compatible
// with write_color/output_image (gpu-version/color.cuh:70-95, main.cu:359).
// ---------------------------------------------------------------------------
int rt_write_ppm(const char* path, int width, int height,
                 const uint8_t* rgb /* [h][w][3] top-down */) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P3\n%d %d\n255\n", width, height);
  // worst case "255 255 255\n" = 12 bytes per pixel
  std::vector<char> buf;
  buf.reserve(static_cast<size_t>(width) * 12 + 16);
  for (int y = 0; y < height; ++y) {
    buf.clear();
    const uint8_t* row = rgb + static_cast<size_t>(y) * width * 3;
    char tmp[16];
    for (int x = 0; x < width; ++x) {
      int n = snprintf(tmp, sizeof tmp, "%d %d %d\n", row[x * 3],
                       row[x * 3 + 1], row[x * 3 + 2]);
      buf.insert(buf.end(), tmp, tmp + n);
    }
    if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
      fclose(f);
      return -2;
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// BVH builder: median-split on the longest-extent axis with threaded
// escape ("next") links for stackless traversal — the exact semantics of
// taichi-version/bvh.py:24-162 (BVHNode build + save_bvh flattening),
// reimplemented iteratively in C++.
//
// Outputs, per flattened node i (pre-order):
//   obj_id[i]  : primitive id for leaves, -1 for inner nodes
//   left_id[i] : first child (== i+1) or -1
//   right_id[i]: second child or -1
//   next_id[i] : escape link — node to visit when skipping this subtree
//   bmin/bmax  : node AABB
// Node count is exactly 2*n-1 for n primitives.
// ---------------------------------------------------------------------------
struct BuildItem {
  int first, count;   // range into the index array
  int parent_next;    // escape link
  int out_slot;       // where this node lands in the flat arrays
};

int rt_build_bvh(int n, const float* bmin_in /* [n][3] */,
                 const float* bmax_in /* [n][3] */, int32_t* obj_id,
                 int32_t* left_id, int32_t* right_id, int32_t* next_id,
                 float* bmin_out /* [2n-1][3] */, float* bmax_out) {
  if (n <= 0) return -1;
  std::vector<int> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::vector<float> cx(n), cy(n), cz(n);
  for (int i = 0; i < n; ++i) {
    cx[i] = 0.5f * (bmin_in[i * 3] + bmax_in[i * 3]);
    cy[i] = 0.5f * (bmin_in[i * 3 + 1] + bmax_in[i * 3 + 1]);
    cz[i] = 0.5f * (bmin_in[i * 3 + 2] + bmax_in[i * 3 + 2]);
  }

  std::vector<BuildItem> stack;
  stack.push_back({0, n, -1, 0});
  // pre-order DFS; children of a node occupy slots allocated when popped
  while (!stack.empty()) {
    BuildItem it = stack.back();
    stack.pop_back();
    int s = it.out_slot;

    // node AABB over the range
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int k = it.first; k < it.first + it.count; ++k) {
      int p = idx[k];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], bmin_in[p * 3 + a]);
        mx[a] = std::max(mx[a], bmax_in[p * 3 + a]);
      }
    }
    memcpy(bmin_out + s * 3, mn, sizeof mn);
    memcpy(bmax_out + s * 3, mx, sizeof mx);
    next_id[s] = it.parent_next;

    if (it.count == 1) {
      obj_id[s] = idx[it.first];
      left_id[s] = right_id[s] = -1;
      continue;
    }

    // longest axis of the CENTROID spread (bvh.py:58-74 sorts centers)
    float cmn[3] = {1e30f, 1e30f, 1e30f}, cmx[3] = {-1e30f, -1e30f, -1e30f};
    for (int k = it.first; k < it.first + it.count; ++k) {
      int p = idx[k];
      float c[3] = {cx[p], cy[p], cz[p]};
      for (int a = 0; a < 3; ++a) {
        cmn[a] = std::min(cmn[a], c[a]);
        cmx[a] = std::max(cmx[a], c[a]);
      }
    }
    int axis = 0;
    float span = cmx[0] - cmn[0];
    for (int a = 1; a < 3; ++a)
      if (cmx[a] - cmn[a] > span) span = cmx[a] - cmn[a], axis = a;

    const float* cc = axis == 0 ? cx.data() : axis == 1 ? cy.data() : cz.data();
    int half = it.count / 2;
    std::nth_element(idx.begin() + it.first, idx.begin() + it.first + half,
                     idx.begin() + it.first + it.count,
                     [cc](int a, int b) { return cc[a] < cc[b]; });

    obj_id[s] = -1;
    // pre-order layout: left subtree at s+1 (size 2*half-1), right after
    int left_slot = s + 1;
    int right_slot = s + 1 + (2 * half - 1);
    left_id[s] = left_slot;
    right_id[s] = right_slot;
    // push right first so left is processed next (pre-order)
    stack.push_back({it.first + half, it.count - half, it.parent_next,
                     right_slot});
    stack.push_back({it.first, half, right_slot, left_slot});
  }
  return 2 * n - 1;
}

}  // extern "C"
