// traverse_wide: the 16-wide BVH walk, one thread per ray.
//
// Replaces luminary_tpu/ops/traverse_pallas.py (_make_body_kernel, launched
// by _run_body and driven by traverse_wide_pallas from ops/traverse.py
// trace_closest / trace_occluded). On the TPU each launch ran ONE iteration
// of a lockstep walk over 16-ray packets, with the row gather at XLA level,
// packet compaction between launches and a post-loop re-intersection of the
// winning leaf. None of that is carried over: a GPU thread keeps its own
// stack and gathers its own rows, so one launch walks the whole tree.
//
// Table layout (luminary_tpu_torch/bvh/wide.py), f32 [num_nodes + B, 128]:
//   node row: cols 0:16 lo.x | 16:32 hi.x | 32:48 lo.y | 48:64 hi.y |
//             64:80 lo.z | 80:96 hi.z | 96:112 child codes (i32 bits)
//             code >= 0 interior node, < 0 leaf at row num_nodes + ~code,
//             0x7FFFFFFF absent
//   leaf row: 14 triangles, cols 0:42 v0 (x|y|z), 42:84 e1, 84:126 e2
//
// Numerics follow the plain walk (ops/traverse.py traverse_wide_plain):
// t_min 1e-4, 1/d with |d| < 1e-20 clamped to +-1e-20, the same slab and
// Moller-Trumbore arithmetic in the same order, built with -fmad=false.
// The closest-hit variant returns t, slot, u, v of the nearest triangle
// (the winning leaf's triangle is known in-loop: no re-intersection); the
// any-hit variant stops at the first hit below t_max. Visit order differs
// from the packet walk, so exact-t ties may resolve to another slot.
//
// Bound on an H100: operations against the table bytes. The table of the
// 127k-triangle bench scene (~6.5 MB) stays in the 50 MB L2, so a visit
// costs slab or triangle tests (fp32, no tensor cores) plus L2 reads of one
// 512-byte row. This first version keeps the per-thread stack in local
// memory and reads rows through L1/L2 without shared-memory staging;
// divergence between neighbouring rays is its main loss.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BRANCH 16
#define WIDE_LEAF 14
#define MAX_STACK 64
#define INVALID_CHILD 0x7FFFFFFF
#define MISS_DIST 3.0e38f
#define T_MIN 1e-4f

__device__ __forceinline__ float safe_inv(float c) {
  float d = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
  return 1.0f / d;
}

// One ray row, [N, 8] 32-bit words, packed from the SoA lanes by the
// unplanar kernel (csrc/gather_soa.cu): ox oy oz t_max | dx dy dz active.
// Two 16-byte loads per ray.
//
// STATS instantiations also add each ray's slab tests (children tested at
// the nodes it visits) and triangle tests (14 per leaf it visits) into
// counters[0] and counters[1]: the work this per-ray walk does on a run's
// data, from which its operation bound is computed.
template <bool ANY_HIT, bool STATS>
__global__ void traverse_wide_kernel(
    const float* __restrict__ rows, int num_nodes,
    const float4* __restrict__ rays, long long n, float* __restrict__ t_out,
    int32_t* __restrict__ slot_out, float* __restrict__ u_out,
    float* __restrict__ v_out, uint8_t* __restrict__ found_out,
    unsigned long long* __restrict__ counters) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 ra = rays[2 * i];
  const float4 rb = rays[2 * i + 1];
  if (__float_as_int(rb.w) == 0) {
    if (ANY_HIT) {
      found_out[i] = 0;
    } else {
      t_out[i] = MISS_DIST;
      slot_out[i] = -1;
      u_out[i] = 0.0f;
      v_out[i] = 0.0f;
    }
    return;
  }
  const float ox = ra.x, oy = ra.y, oz = ra.z;
  const float dx = rb.x, dy = rb.y, dz = rb.z;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float t_best = ra.w;
  long long best_leaf = -1;
  int best_k = 0;
  float best_u = 0.0f, best_v = 0.0f;
  bool found = false;
  unsigned long long slab_tests = 0, tri_tests = 0;

  int stack_node[MAX_STACK];
  int stack_mask[MAX_STACK];
  int sp = 0;
  int node = 0;
  int mask = (1 << BRANCH) - 1;
  float pend_dist[BRANCH];
  int pend_code[BRANCH];

  while (true) {
    // --- node: slab-test the children named by `mask` ---
    const float* row = rows + (long long)node * 128;
    const int32_t* codes = reinterpret_cast<const int32_t*>(row + 96);
#pragma unroll
    for (int k = 0; k < BRANCH; ++k) {
      int code = codes[k];
      pend_code[k] = code;
      float dist = INFINITY;
      if (((mask >> k) & 1) && code != INVALID_CHILD) {
        if (STATS) ++slab_tests;
        float t1x = (row[k] - ox) * ix;
        float t2x = (row[16 + k] - ox) * ix;
        float t1y = (row[32 + k] - oy) * iy;
        float t2y = (row[48 + k] - oy) * iy;
        float t1z = (row[64 + k] - oz) * iz;
        float t2z = (row[80 + k] - oz) * iz;
        float enter = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                            fmaxf(fminf(t1z, t2z), T_MIN));
        float leave = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                            fminf(fmaxf(t1z, t2z), t_best));
        if (enter <= leave) dist = ANY_HIT ? 0.0f : enter;
      }
      pend_dist[k] = dist;
    }

    // --- select pending children nearest-first until one is interior ---
    bool descended = false;
    while (true) {
      int sel = -1;
      float sel_dist = INFINITY;
#pragma unroll
      for (int k = 0; k < BRANCH; ++k) {
        if (pend_dist[k] < sel_dist) {
          sel_dist = pend_dist[k];
          sel = k;
        }
      }
      if (sel < 0) break;
      pend_dist[sel] = INFINITY;
      int code = pend_code[sel];
      if (code < 0) {
        // --- leaf: 14 Moller-Trumbore tests on its row ---
        long long leaf = (long long)num_nodes + (long long)(~code);
        const float* lr = rows + leaf * 128;
        if (STATS) tri_tests += WIDE_LEAF;
        for (int k = 0; k < WIDE_LEAF; ++k) {
          float v0x = lr[k], v0y = lr[14 + k], v0z = lr[28 + k];
          float e1x = lr[42 + k], e1y = lr[56 + k], e1z = lr[70 + k];
          float e2x = lr[84 + k], e2y = lr[98 + k], e2z = lr[112 + k];
          float px = dy * e2z - dz * e2y;
          float py = dz * e2x - dx * e2z;
          float pz = dx * e2y - dy * e2x;
          float det = e1x * px + e1y * py + e1z * pz;
          bool parallel = fabsf(det) < 1e-12f;
          float inv_det = 1.0f / (parallel ? 1.0f : det);
          float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          float u = (tx * px + ty * py + tz * pz) * inv_det;
          float qx = ty * e1z - tz * e1y;
          float qy = tz * e1x - tx * e1z;
          float qz = tx * e1y - ty * e1x;
          float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          bool hit = !parallel && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                     t > T_MIN;
          if (hit && t < t_best) {
            t_best = t;
            best_leaf = leaf;
            best_k = k;
            best_u = u;
            best_v = v;
            found = true;
          }
        }
        if (ANY_HIT && found) break;
        if (!ANY_HIT) {
#pragma unroll
          for (int k = 0; k < BRANCH; ++k)
            if (pend_dist[k] > t_best) pend_dist[k] = INFINITY;
        }
        continue;
      }
      // --- interior: push the remaining pending set, descend ---
      int remaining = 0;
#pragma unroll
      for (int k = 0; k < BRANCH; ++k)
        if (pend_dist[k] < INFINITY) remaining |= 1 << k;
      if (remaining != 0) {
        stack_node[sp] = node;
        stack_mask[sp] = remaining;
        ++sp;
      }
      node = code;
      mask = (1 << BRANCH) - 1;
      descended = true;
      break;
    }
    if (ANY_HIT && found) break;
    if (descended) continue;
    if (sp == 0) break;
    --sp;
    node = stack_node[sp];
    mask = stack_mask[sp];
  }

  if (STATS) {
    atomicAdd(&counters[0], slab_tests);
    atomicAdd(&counters[1], tri_tests);
  }
  if (ANY_HIT) {
    found_out[i] = found ? 1 : 0;
  } else if (best_leaf >= 0) {
    t_out[i] = t_best;
    slot_out[i] = (int32_t)((best_leaf - num_nodes) * WIDE_LEAF + best_k);
    u_out[i] = best_u;
    v_out[i] = best_v;
  } else {
    t_out[i] = MISS_DIST;
    slot_out[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
  }
}

template <bool STATS>
static void launch(const void* rows, int num_nodes, const void* rays,
                   long long n, int any_hit, void* t_out, void* slot_out,
                   void* u_out, void* v_out, void* found_out, void* counters,
                   cudaStream_t s) {
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (any_hit) {
    traverse_wide_kernel<true, STATS><<<blocks, threads, 0, s>>>(
        (const float*)rows, num_nodes, (const float4*)rays, n, nullptr,
        nullptr, nullptr, nullptr, (uint8_t*)found_out,
        (unsigned long long*)counters);
  } else {
    traverse_wide_kernel<false, STATS><<<blocks, threads, 0, s>>>(
        (const float*)rows, num_nodes, (const float4*)rays, n,
        (float*)t_out, (int32_t*)slot_out, (float*)u_out, (float*)v_out,
        nullptr, (unsigned long long*)counters);
  }
}

// counters: null, or two zeroed u64 words on the device that receive the
// slab and triangle test counts of this launch.
extern "C" int lum_traverse_wide(const void* rows, int num_nodes, int depth,
                                 const void* rays, long long n, int any_hit,
                                 void* t_out, void* slot_out, void* u_out,
                                 void* v_out, void* found_out, void* counters,
                                 void* stream) {
  if (depth > MAX_STACK) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (counters)
      launch<true>(rows, num_nodes, rays, n, any_hit, t_out, slot_out, u_out,
                   v_out, found_out, counters, s);
    else
      launch<false>(rows, num_nodes, rays, n, any_hit, t_out, slot_out, u_out,
                    v_out, found_out, nullptr, s);
  }
  return (int)cudaGetLastError();
}
