// Native BVH builder: median-split over primitive AABBs.
//
// Host-side counterpart of models/bvh.py::build_bvh_numpy with IDENTICAL
// semantics (largest-extent centroid axis, stable sort by box-min on the
// axis, median split, preorder flatten with root at node 0, leaf encoded
// as left == -1 / right == primitive id). The Python builder is the
// correctness oracle for this one (tests/test_native.py); this one exists
// because large scenes (millions of primitives) make the per-node numpy
// argsort loop the scene-build bottleneck.
//
// Semantics derive from the reference's builder (bvh.h:55-95: sort by AABB
// minimum via boxCompare bvh.h:34-41, median split, preorder DFS emission
// bvh.h:112-148) with the random split axis replaced by largest-extent —
// the same deliberate divergence the Python builder documents.
//
// C ABI only; loaded via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct BuildTask {
  int64_t begin, end;  // range into the shared prim-index array
  int64_t parent;      // node id or -1
  int which;           // 0 = left child slot, 1 = right
};

}  // namespace

extern "C" {

// pmin/pmax: [n,3] row-major primitive boxes.
// node_min/node_max: [2n-1,3] outputs; left/right: [2n-1] outputs.
// Returns the number of nodes written, or -1 on invalid input.
int64_t srt_build_bvh(const float* pmin, const float* pmax, int64_t n,
                      float* node_min, float* node_max, int32_t* left,
                      int32_t* right) {
  if (n <= 0) return -1;
  const int64_t n_nodes = 2 * n - 1;

  std::vector<float> cent(3 * n);
  for (int64_t i = 0; i < n; i++)
    for (int c = 0; c < 3; c++)
      cent[3 * i + c] = 0.5f * (pmin[3 * i + c] + pmax[3 * i + c]);

  std::vector<int64_t> prims(n);
  std::iota(prims.begin(), prims.end(), 0);

  std::vector<BuildTask> stack;
  stack.push_back({0, n, -1, 0});
  int64_t next_node = 0;

  while (!stack.empty()) {
    BuildTask task = stack.back();
    stack.pop_back();
    const int64_t node = next_node++;
    if (task.parent >= 0) {
      if (task.which == 0)
        left[task.parent] = static_cast<int32_t>(node);
      else
        right[task.parent] = static_cast<int32_t>(node);
    }

    // node bounds + centroid extent
    float bmin[3] = {3e38f, 3e38f, 3e38f};
    float bmax[3] = {-3e38f, -3e38f, -3e38f};
    float cmin[3] = {3e38f, 3e38f, 3e38f};
    float cmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t k = task.begin; k < task.end; k++) {
      const int64_t p = prims[k];
      for (int c = 0; c < 3; c++) {
        bmin[c] = std::min(bmin[c], pmin[3 * p + c]);
        bmax[c] = std::max(bmax[c], pmax[3 * p + c]);
        cmin[c] = std::min(cmin[c], cent[3 * p + c]);
        cmax[c] = std::max(cmax[c], cent[3 * p + c]);
      }
    }
    for (int c = 0; c < 3; c++) {
      node_min[3 * node + c] = bmin[c];
      node_max[3 * node + c] = bmax[c];
    }

    const int64_t count = task.end - task.begin;
    if (count == 1) {
      left[node] = -1;
      right[node] = static_cast<int32_t>(prims[task.begin]);
      continue;
    }

    int axis = 0;
    float best_ext = cmax[0] - cmin[0];
    for (int c = 1; c < 3; c++) {
      const float ext = cmax[c] - cmin[c];
      if (ext > best_ext) {
        best_ext = ext;
        axis = c;
      }
    }

    std::stable_sort(
        prims.begin() + task.begin, prims.begin() + task.end,
        [&](int64_t a, int64_t b) {
          return pmin[3 * a + axis] < pmin[3 * b + axis];
        });

    const int64_t mid = task.begin + count / 2;
    // push right first so left is emitted first (preorder)
    stack.push_back({mid, task.end, node, 1});
    stack.push_back({task.begin, mid, node, 0});
  }

  return next_node == n_nodes ? n_nodes : -1;
}

}  // extern "C"
