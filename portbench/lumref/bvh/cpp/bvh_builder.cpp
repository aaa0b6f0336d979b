// Native 16-wide BVH builder (lum_build_wide).
//
// Copy of the JAX package's native builder, cut to its direct 16-wide
// build: the port's scene pack calls nothing else, and its node rows must
// equal the reference's word for word. Loaded through ctypes by
// luminary_tpu_torch/bvh/native.py, which builds it with
//   g++ -O3 -shared -fPIC -o libbvh.so bvh_builder.cpp
//
// Exported ABI:
//   int lum_build_wide(const float* corners /* [T,3,3] */, int num_tris,
//                      int flat_tris, float* node_rows /* [cap,128] */,
//                      int* tri_order /* [order_cap] */,
//                      int node_cap, int order_cap, int* out_num_nodes,
//                      int* out_num_blocks, int* out_depth);
// Returns 0 on success, <0 on error (-1 capacity, -2 args).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int32_t kInvalid = 0x7FFFFFFF;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{std::numeric_limits<float>::infinity(),
        std::numeric_limits<float>::infinity(),
        std::numeric_limits<float>::infinity()};
  V3 hi{-std::numeric_limits<float>::infinity(),
        -std::numeric_limits<float>::infinity(),
        -std::numeric_limits<float>::infinity()};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const V3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

// ---------------------------------------------------------------------------
// Direct 16-wide build (lum_build_wide): BVH2 over index RANGES + a
// quality-aware collapse that fixes the thin-node pathology of the greedy
// python collapse (measured on the 127k-tri bench scene: mean 4.2 children
// per 16-slot node, 73% leaf occupancy — every traversal step paid a full
// 16x16 slab test for ~4 real children). Two rules change that:
//   * any wide node whose whole subtree holds <= flat_tris triangles is
//     FLATTENED: its contiguous index range is chunked into balanced <=14-tri
//     blocks emitted as direct leaf children (one row fetch covers what used
//     to be a 2-3 level descent of thin nodes);
//   * after area-greedy expansion, sparse BVH2-leaf entries of a full node
//     are POOLED and re-chunked so blocks leave ~100% occupied.
// The node-row layout matches bvh/wide.py exactly (the traversal consumes
// either producer).
// ---------------------------------------------------------------------------

constexpr int kBranch = 16;
constexpr int kWideLeaf = 14;
constexpr int kNodeCols = 128;

struct WideBuilder {
  const float* corners;
  int num_tris;
  float* node_rows;
  int32_t* tri_order;
  int node_cap, order_cap, flat_tris;
  int num_nodes = 0, num_blocks = 0, depth = 1;
  bool overflow = false;

  std::vector<AABB> tri_box;
  std::vector<V3> centroid;
  std::vector<int32_t> index;

  // BVH2 phase --------------------------------------------------------------
  struct Node2 {
    int32_t code[2];  // >= 0 interior id, -1 leaf, kInvalid absent
    AABB box[2];
    int begin[2], count[2];
  };
  std::vector<Node2> n2;

  void init() {
    tri_box.resize(num_tris);
    centroid.resize(num_tris);
    index.resize(num_tris);
    for (int i = 0; i < num_tris; ++i) {
      const float* c = corners + size_t(i) * 9;
      AABB b;
      for (int k = 0; k < 3; ++k)
        b.grow(V3{c[3 * k], c[3 * k + 1], c[3 * k + 2]});
      tri_box[i] = b;
      centroid[i] = {0.5f * (b.lo.x + b.hi.x), 0.5f * (b.lo.y + b.hi.y),
                     0.5f * (b.lo.z + b.hi.z)};
      index[i] = i;
    }
  }

  int split_mid(int begin, int count) {
    AABB cb;
    for (int i = begin; i < begin + count; ++i) cb.grow(centroid[index[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) return begin + count / 2;
    const int B = 16;
    int cnt[B];
    AABB bb[B];
    std::memset(cnt, 0, sizeof(cnt));
    float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    float scale = B * (1.f - 1e-6f) / ext[axis];
    auto bin_of = [&](int tri) {
      const V3& c = centroid[tri];
      float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
      int b = int((v - lo) * scale);
      return std::min(std::max(b, 0), B - 1);
    };
    for (int i = begin; i < begin + count; ++i) {
      int b = bin_of(index[i]);
      cnt[b]++;
      bb[b].grow(tri_box[index[i]]);
    }
    float right_sa[B];
    int right_cnt[B];
    AABB acc;
    int rc = 0;
    for (int b = B - 1; b >= 1; --b) {
      acc.grow(bb[b]);
      rc += cnt[b];
      right_sa[b] = acc.area();
      right_cnt[b] = rc;
    }
    acc = AABB{};
    int lc = 0;
    float best = std::numeric_limits<float>::infinity();
    int best_bin = -1;
    for (int b = 0; b < B - 1; ++b) {
      acc.grow(bb[b]);
      lc += cnt[b];
      if (lc == 0 || right_cnt[b + 1] == 0) continue;
      float cost = acc.area() * lc + right_sa[b + 1] * right_cnt[b + 1];
      if (cost < best) {
        best = cost;
        best_bin = b;
      }
    }
    int mid;
    if (best_bin < 0) {
      mid = begin + count / 2;
      std::nth_element(index.begin() + begin, index.begin() + mid,
                       index.begin() + begin + count, [&](int a, int b) {
                         const V3 &ca = centroid[a], &cb2 = centroid[b];
                         float va = axis == 0 ? ca.x
                                              : (axis == 1 ? ca.y : ca.z);
                         float vb = axis == 0 ? cb2.x
                                              : (axis == 1 ? cb2.y : cb2.z);
                         return va < vb;
                       });
    } else {
      auto it = std::partition(index.begin() + begin,
                               index.begin() + begin + count,
                               [&](int t) { return bin_of(t) <= best_bin; });
      mid = int(it - index.begin());
    }
    if (mid == begin || mid == begin + count) mid = begin + count / 2;
    return mid;
  }

  // Build the BVH2 over index[begin, begin+count). Returns the child code
  // (>=0 interior id, -1 pure leaf range) and fills bounds.
  int32_t build2(int begin, int count, AABB& bounds) {
    bounds = AABB{};
    for (int i = begin; i < begin + count; ++i) bounds.grow(tri_box[index[i]]);
    if (count <= kWideLeaf) return -1;
    int mid = split_mid(begin, count);
    int id = int(n2.size());
    n2.push_back(Node2{});
    AABB lb, rb;
    int32_t lc = build2(begin, mid - begin, lb);
    int32_t rc = build2(mid, begin + count - mid, rb);
    Node2& nd = n2[id];
    nd.code[0] = lc;
    nd.code[1] = rc;
    nd.box[0] = lb;
    nd.box[1] = rb;
    nd.begin[0] = begin;
    nd.count[0] = mid - begin;
    nd.begin[1] = mid;
    nd.count[1] = begin + count - mid;
    return id;
  }

  // Wide collapse phase -----------------------------------------------------
  struct WEntry {
    int32_t code2;  // >= 0 bvh2 interior, -1 leaf range
    AABB box;
    int begin, count;
  };

  int32_t emit_block(const int32_t* ids, int count, AABB& bounds) {
    bounds = AABB{};
    if ((num_blocks + 1) * kWideLeaf > order_cap) {
      overflow = true;
      return ~0;
    }
    int block = num_blocks++;
    for (int k = 0; k < kWideLeaf; ++k) {
      int32_t t = (k < count) ? ids[k] : -1;
      tri_order[block * kWideLeaf + k] = t;
      if (t >= 0) bounds.grow(tri_box[t]);
    }
    return ~block;
  }

  int alloc_wide() {
    if (num_nodes >= node_cap) {
      overflow = true;
      return 0;
    }
    float* row = node_rows + size_t(num_nodes) * kNodeCols;
    std::memset(row, 0, sizeof(float) * kNodeCols);
    for (int k = 0; k < 6 * kBranch; ++k)
      row[k] = std::numeric_limits<float>::infinity();
    int32_t inv = kInvalid;
    for (int k = 0; k < kBranch; ++k)
      std::memcpy(row + 6 * kBranch + k, &inv, 4);
    return num_nodes++;
  }

  // Collect the SAH leaf ranges of a subtree in DFS (= index) order.
  void collect_leaves(int32_t code2, int begin, int count,
                      std::vector<std::pair<int, int>>& out) {
    if (code2 < 0) {
      if (count > 0) out.emplace_back(begin, count);
      return;
    }
    const Node2& nd = n2[code2];
    for (int s = 0; s < 2; ++s)
      if (nd.count[s] > 0)
        collect_leaves(nd.code[s], nd.begin[s], nd.count[s], out);
  }

  // Greedy merge of CONSECUTIVE leaf ranges into <=14-tri chunks. Chunks cut
  // only at SAH leaf boundaries, so their AABBs stay SAH-tight (arbitrary
  // balanced cuts were measured to cost ~30% extra traversal visits from
  // overlapping chunk boxes).
  void merge_ranges(const std::vector<std::pair<int, int>>& ranges,
                    std::vector<std::pair<int, int>>& chunks) {
    chunks.clear();
    int cb = -1, cc = 0;
    for (auto& r : ranges) {
      if (cc > 0 && cc + r.second <= kWideLeaf && cb + cc == r.first) {
        cc += r.second;
      } else {
        if (cc > 0) chunks.emplace_back(cb, cc);
        cb = r.first;
        cc = r.second;
      }
    }
    if (cc > 0) chunks.emplace_back(cb, cc);
  }

  struct Work {
    int wide_id;
    int32_t code2;
    int begin, count;
  };

  void run() {
    std::vector<Work> stack;
    std::vector<int> depth_of;
    AABB rb;
    int32_t root2 = num_tris ? build2(0, num_tris, rb) : -1;
    int root = alloc_wide();
    depth_of.push_back(1);
    stack.push_back(Work{root, root2, 0, num_tris});

    std::vector<WEntry> entries;
    while (!stack.empty() && !overflow) {
      Work w = stack.back();
      stack.pop_back();
      entries.clear();
      // final wide child codes + boxes for the row
      int32_t codes[kBranch];
      AABB boxes[kBranch];
      int n_out = 0;

      if (w.count <= 0) {
        // empty scene: leave the root all-invalid
        continue;
      }
      bool flattened = false;
      if (w.count <= flat_tris || w.code2 < 0) {
        // FLATTEN: emit the subtree's SAH leaves (greedy-merged at leaf
        // boundaries) directly as this node's children — one row fetch
        // replaces a 2-3 level descent of thin nodes.
        std::vector<std::pair<int, int>> ranges, chunks;
        collect_leaves(w.code2, w.begin, w.count, ranges);
        merge_ranges(ranges, chunks);
        if (int(chunks.size()) <= kBranch) {
          flattened = true;
          for (auto& c : chunks) {
            AABB bb;
            int32_t code = emit_block(index.data() + c.first, c.second, bb);
            codes[n_out] = code;
            boxes[n_out] = bb;
            ++n_out;
          }
        }
      }
      if (!flattened) {
        // expansion: children of code2, split largest-area interiors
        const Node2& nd = n2[w.code2];
        for (int s = 0; s < 2; ++s) {
          if (nd.count[s] <= 0) continue;
          entries.push_back(
              WEntry{nd.code[s], nd.box[s], nd.begin[s], nd.count[s]});
        }
        while (int(entries.size()) < kBranch) {
          // Expand only entries too big to flatten: a <= flat_tris entry is
          // a perfect future one-node flatten — splitting it here would
          // yield under-filled descendants (the thin-node tail).
          int best = -1;
          float best_a = -1.f;
          for (int i = 0; i < int(entries.size()); ++i) {
            if (entries[i].code2 >= 0 && entries[i].count > flat_tris) {
              float a = entries[i].box.area();
              if (a > best_a) {
                best_a = a;
                best = i;
              }
            }
          }
          if (best < 0) break;
          WEntry e = entries[best];
          entries.erase(entries.begin() + best);
          const Node2& c = n2[e.code2];
          for (int s = 0; s < 2; ++s) {
            if (c.count[s] <= 0) continue;
            entries.push_back(
                WEntry{c.code[s], c.box[s], c.begin[s], c.count[s]});
          }
        }
        // merge leaf entries that are ADJACENT in index order into fuller
        // blocks (boundary-preserving: AABBs stay SAH-tight)
        std::vector<std::pair<int, int>> lranges, lchunks;
        for (auto& e : entries)
          if (e.code2 < 0) lranges.emplace_back(e.begin, e.count);
        std::sort(lranges.begin(), lranges.end());
        merge_ranges(lranges, lchunks);
        for (auto& e : entries) {
          if (n_out >= kBranch) break;
          if (e.code2 >= 0) {
            int child_id = alloc_wide();
            if (overflow) break;
            depth_of.push_back(depth_of[w.wide_id] + 1);
            if (depth_of.back() > depth) depth = depth_of.back();
            stack.push_back(Work{child_id, e.code2, e.begin, e.count});
            codes[n_out] = child_id;
            boxes[n_out] = e.box;
            ++n_out;
          }
        }
        for (auto& c : lchunks) {
          if (n_out >= kBranch) break;
          AABB bb;
          int32_t code = emit_block(index.data() + c.first, c.second, bb);
          codes[n_out] = code;
          boxes[n_out] = bb;
          ++n_out;
        }
      }
      // write the row
      float* row = node_rows + size_t(w.wide_id) * kNodeCols;
      for (int k = 0; k < n_out; ++k) {
        row[0 * kBranch + k] = boxes[k].lo.x;
        row[1 * kBranch + k] = boxes[k].hi.x;
        row[2 * kBranch + k] = boxes[k].lo.y;
        row[3 * kBranch + k] = boxes[k].hi.y;
        row[4 * kBranch + k] = boxes[k].lo.z;
        row[5 * kBranch + k] = boxes[k].hi.z;
        std::memcpy(row + 6 * kBranch + k, &codes[k], 4);
      }
    }
  }
};

}  // namespace

extern "C" int lum_build_wide(
    const float* corners, int num_tris, int flat_tris,
    float* node_rows, int32_t* tri_order,
    int node_cap, int order_cap,
    int* out_num_nodes, int* out_num_blocks, int* out_depth) {
  if (!corners || !node_rows || !tri_order || num_tris < 0 || node_cap < 1)
    return -2;
  WideBuilder b;
  b.corners = corners;
  b.num_tris = num_tris;
  b.node_rows = node_rows;
  b.tri_order = tri_order;
  b.node_cap = node_cap;
  b.order_cap = order_cap;
  // a flattened node's chunks must fit its 16 child slots
  b.flat_tris =
      std::min(std::max(flat_tris, kWideLeaf), kBranch * kWideLeaf);
  if (num_tris == 0) {
    b.alloc_wide();
    if (order_cap >= kWideLeaf) {
      for (int k = 0; k < kWideLeaf; ++k) tri_order[k] = -1;
      b.num_blocks = 1;
    }
    *out_num_nodes = 1;
    *out_num_blocks = 1;
    *out_depth = 1;
    return 0;
  }
  b.init();
  b.run();
  if (b.overflow) return -1;
  *out_num_nodes = b.num_nodes;
  *out_num_blocks = std::max(b.num_blocks, 1);
  *out_depth = b.depth;
  return 0;
}
