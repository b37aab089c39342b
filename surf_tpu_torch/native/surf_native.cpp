// Binned-SAH BVH build and refit for surf_tpu_torch (a copy of surf_tpu's
// native builder).
//
// Host-side BVH construction as in the reference (bvh.cpp:255-465 BLAS):
// the build is sequential, recursive host work, so it stays native C++;
// its output is a flattened SoA node pool that accel/wide.py packs into
// the leaf tables the traversal reads.
//
// The caller passes per-primitive AABBs plus a binning key per primitive
// (for a BLAS the triangle centroid (v0+v1+v2) * 0.333f, mesh.cpp:20).
//
// Node layout (bvh.h:36-46): leftFirst/count + AABB; children adjacent
// (left = leftFirst, right = leftFirst + 1); node 1 unused; pool size 2N.
//
// Build and refit: exposed with C linkage for ctypes.  No dependencies.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <limits>
#include <vector>

namespace {

constexpr uint32_t kBinCount = 8;                 // bvh.cpp:14
constexpr uint32_t kPlaneCount = kBinCount - 1;   // bvh.cpp:15
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {a.x < b.x ? a.x : b.x, a.y < b.y ? a.y : b.y, a.z < b.z ? a.z : b.z};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {a.x > b.x ? a.x : b.x, a.y > b.y ? a.y : b.y, a.z > b.z ? a.z : b.z};
}

struct Box {
  Vec3 lo{kInf, kInf, kInf};
  Vec3 hi{-kInf, -kInf, -kInf};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  float area() const {
    // AABB::area (bvh.cpp:29-33)
    float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
    return ex * ey + ey * ez + ez * ex;
  }
};

struct Builder {
  const float* prim_lo;   // [n,3]
  const float* prim_hi;   // [n,3]
  const float* key;       // [n,3] binning key
  uint32_t n;
  uint32_t* indices;      // [n]
  float* node_lo;         // [2n,3]
  float* node_hi;         // [2n,3]
  uint32_t* left_first;   // [2n]
  uint32_t* count;        // [2n]
  uint32_t min_leaf = 1;  // stop subdividing at/below this count
  uint32_t nodes_used = 2;

  Box prim_box(uint32_t p) const {
    return Box{{prim_lo[3 * p], prim_lo[3 * p + 1], prim_lo[3 * p + 2]},
               {prim_hi[3 * p], prim_hi[3 * p + 1], prim_hi[3 * p + 2]}};
  }
  Vec3 prim_key(uint32_t p) const {
    return {key[3 * p], key[3 * p + 1], key[3 * p + 2]};
  }

  void store_box(uint32_t node, const Box& b) {
    node_lo[3 * node] = b.lo.x;
    node_lo[3 * node + 1] = b.lo.y;
    node_lo[3 * node + 2] = b.lo.z;
    node_hi[3 * node] = b.hi.x;
    node_hi[3 * node + 1] = b.hi.y;
    node_hi[3 * node + 2] = b.hi.z;
  }

  void update_node_bounds(uint32_t node) {
    // updateNodeBounds (bvh.cpp:403-416)
    Box b;
    for (uint32_t i = 0; i < count[node]; i++)
      b.grow(prim_box(indices[left_first[node] + i]));
    store_box(node, b);
  }

  float node_cost(uint32_t node) const {
    Box b{{node_lo[3 * node], node_lo[3 * node + 1], node_lo[3 * node + 2]},
          {node_hi[3 * node], node_hi[3 * node + 1], node_hi[3 * node + 2]}};
    return static_cast<float>(count[node]) * b.area();
  }

  // findSplitPlane (bvh.cpp:294-377): 3 axes x 8 bins x 7 planes.
  float find_split(uint32_t node, float& best_cost, uint32_t& best_axis) const {
    best_cost = kInf;
    float best_split = 0.0f;
    best_axis = 0;
    for (uint32_t axis = 0; axis < 3; axis++) {
      float lo = std::numeric_limits<float>::max();
      float hi = std::numeric_limits<float>::min();  // FLT_MIN quirk (bvh.cpp:303)
      for (uint32_t i = 0; i < count[node]; i++) {
        float c = prim_key(indices[left_first[node] + i])[axis];
        lo = c < lo ? c : lo;
        hi = c > hi ? c : hi;
      }
      if (lo == hi) continue;

      const float bin_scale = static_cast<float>(kBinCount) / (hi - lo);
      Box bin_box[kBinCount];
      uint32_t bin_count[kBinCount] = {};
      for (uint32_t i = 0; i < count[node]; i++) {
        uint32_t p = indices[left_first[node] + i];
        float c = prim_key(p)[axis];
        // size_t cast truncation, then clamp (bvh.cpp:322-323)
        uint64_t section = static_cast<uint64_t>((c - lo) * bin_scale);
        uint64_t bin = section < kBinCount - 1 ? section : kBinCount - 1;
        bin_count[bin]++;
        bin_box[bin].grow(prim_box(p));
      }

      float left_area[kPlaneCount], right_area[kPlaneCount];
      uint32_t left_cnt[kPlaneCount], right_cnt[kPlaneCount];
      Box lbox, rbox;
      uint32_t lsum = 0, rsum = 0;
      for (uint32_t plane = 0; plane < kPlaneCount; plane++) {
        lsum += bin_count[plane];
        left_cnt[plane] = lsum;
        lbox.grow(bin_box[plane]);
        left_area[plane] = lbox.area();
        uint32_t rbin = kBinCount - 1 - plane;
        rsum += bin_count[rbin];
        right_cnt[rbin - 1] = rsum;
        rbox.grow(bin_box[rbin]);
        right_area[rbin - 1] = rbox.area();
      }

      float bin_extent = (hi - lo) / static_cast<float>(kBinCount);
      for (uint32_t plane = 0; plane < kPlaneCount; plane++) {
        float cost = left_cnt[plane] * left_area[plane] +
                     right_cnt[plane] * right_area[plane];
        if (cost < best_cost) {
          best_cost = cost;
          best_split = lo + bin_extent * (plane + 1);
          best_axis = axis;
        }
      }
    }
    return best_split;
  }

  // partitionNode (bvh.cpp:379-401): in-place two-pointer partition.
  uint32_t partition(uint32_t node, float split, uint32_t axis) {
    int64_t pivot = left_first[node];
    int64_t last = pivot + (count[node] - 1);
    while (pivot <= last) {
      if (prim_key(indices[pivot])[axis] < split) {
        pivot++;
      } else {
        uint32_t tmp = indices[pivot];
        indices[pivot] = indices[last];
        indices[last] = tmp;
        last--;
      }
    }
    return static_cast<uint32_t>(pivot);
  }

  // subdivide (bvh.cpp:418-465), iterative left-first DFS to match the
  // reference's node allocation order.
  void subdivide_all() {
    std::vector<uint32_t> stack;
    stack.push_back(0);
    while (!stack.empty()) {
      uint32_t node = stack.back();
      stack.pop_back();
      if (count[node] <= min_leaf) continue;

      float cost;
      uint32_t axis;
      float split = find_split(node, cost, axis);
      if (cost >= node_cost(node)) continue;

      uint32_t pivot = partition(node, split, axis);
      uint32_t left_count = pivot - left_first[node];
      if (left_count == 0 || left_count == count[node]) continue;

      uint32_t li = nodes_used;
      uint32_t ri = nodes_used + 1;
      nodes_used += 2;

      left_first[li] = left_first[node];
      count[li] = left_count;
      left_first[ri] = pivot;
      count[ri] = count[node] - left_count;
      left_first[node] = li;
      count[node] = 0;

      update_node_bounds(li);
      update_node_bounds(ri);
      stack.push_back(ri);  // pushed first -> popped after left subtree
      stack.push_back(li);
    }
  }
};

}  // namespace

extern "C" {

// Builds a BVH; returns nodes_used. All output arrays caller-allocated:
// indices [n], node_lo/node_hi [2n,3], left_first/count [2n].
uint32_t surf_bvh_build(const float* prim_lo, const float* prim_hi,
                        const float* key, uint32_t n, uint32_t* indices,
                        float* node_lo, float* node_hi, uint32_t* left_first,
                        uint32_t* count, uint32_t min_leaf) {
  Builder b{prim_lo, prim_hi, key, n, indices, node_lo, node_hi, left_first,
            count, min_leaf};
  for (uint32_t i = 0; i < n; i++) indices[i] = i;
  std::memset(left_first, 0, sizeof(uint32_t) * 2 * n);
  std::memset(count, 0, sizeof(uint32_t) * 2 * n);
  left_first[0] = 0;
  count[0] = n;
  b.update_node_bounds(0);
  b.subdivide_all();
  return b.nodes_used;
}

// refit (bvh.cpp:268-287): leaf-up AABB recompute over existing topology.
void surf_bvh_refit(const float* prim_lo, const float* prim_hi,
                    const uint32_t* indices, float* node_lo, float* node_hi,
                    const uint32_t* left_first, const uint32_t* count,
                    uint32_t nodes_used) {
  for (int64_t i = static_cast<int64_t>(nodes_used) - 1; i >= 0; i--) {
    if (i == 1) continue;
    if (count[i] != 0) {  // leaf
      Box b;
      for (uint32_t k = 0; k < count[i]; k++) {
        uint32_t p = indices[left_first[i] + k];
        b.grow(Box{{prim_lo[3 * p], prim_lo[3 * p + 1], prim_lo[3 * p + 2]},
                   {prim_hi[3 * p], prim_hi[3 * p + 1], prim_hi[3 * p + 2]}});
      }
      node_lo[3 * i] = b.lo.x; node_lo[3 * i + 1] = b.lo.y; node_lo[3 * i + 2] = b.lo.z;
      node_hi[3 * i] = b.hi.x; node_hi[3 * i + 1] = b.hi.y; node_hi[3 * i + 2] = b.hi.z;
      continue;
    }
    uint32_t l = left_first[i], r = left_first[i] + 1;
    for (int a = 0; a < 3; a++) {
      node_lo[3 * i + a] =
          node_lo[3 * l + a] < node_lo[3 * r + a] ? node_lo[3 * l + a] : node_lo[3 * r + a];
      node_hi[3 * i + a] =
          node_hi[3 * l + a] > node_hi[3 * r + a] ? node_hi[3 * l + a] : node_hi[3 * r + a];
    }
  }
}

}  // extern "C"
