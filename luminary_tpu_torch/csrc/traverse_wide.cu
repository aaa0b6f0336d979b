// traverse_wide: the 16-wide BVH walk as a packet walk, 32 rays per warp.
//
// Replaces luminary_tpu/ops/traverse_pallas.py (_make_body_kernel, launched
// by _run_body and driven by traverse_wide_pallas from ops/traverse.py
// trace_closest / trace_occluded). On the TPU each launch ran ONE iteration
// of a lockstep walk over 16-ray packets, with the row gather at XLA level,
// packet compaction between launches and a post-loop re-intersection of the
// winning leaf. Here a warp walks one packet of 32 consecutive rays through
// the whole tree in one launch; the XLA row fetch, the compaction and the
// re-intersection have no counterpart.
//
// Table layout (luminary_tpu_torch/bvh/wide.py), f32 [num_nodes + B, 128]:
//   node row: cols 0:16 lo.x | 16:32 hi.x | 32:48 lo.y | 48:64 hi.y |
//             64:80 lo.z | 80:96 hi.z | 96:112 child codes (i32 bits)
//             code >= 0 interior node, < 0 leaf at row num_nodes + ~code,
//             0x7FFFFFFF absent
//   leaf row: 14 triangles, cols 0:42 v0 (x|y|z), 42:84 e1, 84:126 e2
//
// Bound on an H100: operations. The table of the 127k-triangle bench scene
// (~6.5 MB) stays in the 50 MB L2, so a visit costs slab or triangle tests
// (fp32, no tensor cores) plus L1/L2 reads of one 512-byte row.
//
// What held the first version back (one thread per ray, 55 registers and a
// 640-byte local frame): the stack and the 16 pending distances lived in
// local memory, nearest-first selection rescanned 16 entries for every
// child taken, every thread read its own rows with scalar loads, and the 32
// rays of a warp diverged: each warp-wide step served only the rays that
// happened to be at the same node and in the same phase.
//
// Layout now: the 32 lanes of a warp are 32 consecutive rays (neighbouring
// pixels for camera rays, so mostly the same path through the tree), and
// the warp walks their packet in lockstep, as the JAX walk does:
//   - one row per step for the whole packet, read with 16-byte (node) and
//     8-byte (leaf) vector loads that every lane issues at the same address;
//   - a node step slab-tests every live ray against the 16 children; the
//     packet keeps child k if any ray admits it, at the smallest entry
//     distance among those rays (__reduce_min_sync), and lane k holds that
//     pending distance and child k's code; absent children and children
//     outside the mask restored from the stack are skipped by the whole warp;
//   - a leaf step runs every live ray's 14 Moller-Trumbore tests (padding
//     slots skipped warp-wide); a closest-hit ray keeps its nearest t and
//     the triangle's u, v, and the packet then drops pending children beyond
//     every ray's hit; an any-hit ray stops being live once it is occluded
//     and the packet stops when no ray is live;
//   - the nearest pending child (lowest k among equal distances) is a
//     min-reduce over lanes 0-15; the (node, pending mask) stack, one per
//     packet, lives in shared memory and is written and read by lane 0.
// A warp never diverges, so a step costs the same whether one or 32 rays
// need it; with neighbouring rays that waste is smaller than the first
// version's divergence (PERF.md). The launch bounds cap registers at 64
// (closest hit) and 56 (any hit), which was fastest on the H100. Half a
// warp per ray, 8 lanes x 2 children, one lane per ray and 16-ray packets
// all measured slower (PERF.md) and are not kept.
//
// Numerics follow the plain walk (ops/traverse.py traverse_wide_plain, the
// same packet walk with 16 rays): t_min 1e-4, 1/d with |d| < 1e-20 clamped
// to +-1e-20, the same slab and Moller-Trumbore arithmetic in the same
// order, built with -fmad=false. One deliberate difference: the box test is
// conservative (Ize, "Robust BVH Ray Traversal", JCGT 2(2), 2013). The far
// distance is multiplied by ROBUST_FAR >= 1 + 2*gamma(3) before it is
// compared with the near one, so the rounding of a slab test cannot turn a
// ray away from a box that holds a triangle it hits (ops/traverse.py
// slab_admits is its mirror). Its packets hold the plain walk's 16-ray
// packets and its box test admits whatever the plain one admits, so where
// the two differ it finds a nearer (closest hit) or an extra (any hit)
// triangle; chip_smoke.py holds it to that on every lane it compares.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BRANCH 16
#define WIDE_LEAF 14
#define MAX_STACK 64
#define INVALID_CHILD 0x7FFFFFFF
#define MISS_DIST 3.0e38f
#define T_MIN 1e-4f
// 1 + 2^-21: the float32 value at or above 1 + 2*gamma(3), gamma(n) =
// n*2^-24 / (1 - n*2^-24), with room for the rounding of the product
#define ROBUST_FAR 1.000000476837158203125f
#define THREADS 128
#define PACKETS (THREADS / 32)
#define NO_KEY 0xFFFFFFFFu
#define NO_INDEX 0xFFFFu

__device__ __forceinline__ float safe_inv(float c) {
  float d = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
  return 1.0f / d;
}

// One ray row, [N, 8] 32-bit words, packed from the SoA lanes by the
// unplanar kernel (csrc/gather_soa.cu): ox oy oz t_max | dx dy dz active.
// Two 16-byte loads per ray.
//
// STATS instantiations also add the packet walk's slab tests (live rays x
// children tested, per node step) and triangle tests (live rays x 14, per
// leaf step) into counters[0] and counters[1], as traverse_wide_plain
// counts them: the work this walk does on a run's data. With one active ray
// per warp they are that ray's own tests, a per-ray walk's: chip_smoke.py
// computes the operation bound from those.
template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(THREADS, ANY_HIT ? 9 : 8) traverse_wide_kernel(
    const float* __restrict__ rows, int num_nodes, int depth,
    const float4* __restrict__ rays, long long n, float* __restrict__ t_out,
    int32_t* __restrict__ slot_out, float* __restrict__ u_out,
    float* __restrict__ v_out, uint8_t* __restrict__ found_out,
    unsigned long long* __restrict__ counters) {
  extern __shared__ int2 smem[];
  const int j = threadIdx.x & 31;
  const unsigned gm = ~0u;
  int2* stack = smem + (threadIdx.x / 32) * depth;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  float4 ra = make_float4(0.0f, 0.0f, 0.0f, 0.0f), rb = ra;
  if (i < n) {
    ra = rays[2 * i];
    rb = rays[2 * i + 1];
  }
  const bool on = i < n && __float_as_int(rb.w) != 0;
  const float ox = ra.x, oy = ra.y, oz = ra.z;
  const float dx = rb.x, dy = rb.y, dz = rb.z;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  // per ray (lane)
  float t_best = ra.w;
  long long best_leaf = -1;
  int best_k = 0;
  float best_u = 0.0f, best_v = 0.0f;
  bool found = false;
  // per packet (the same in all lanes), except pend_dist / pend_code
  unsigned long long slab_tests = 0, tri_tests = 0;
  long long fetch = 0;
  bool fetch_leaf = false;
  unsigned restore = (1u << BRANCH) - 1;
  int cur_node = 0, sp = 0;
  float pend_dist = INFINITY;
  int pend_code = 0;
  bool done = !__any_sync(gm, on);

  while (!done) {
    const float* row = rows + fetch * 128;
    // a ray is live while it is on and, for any hit, has found nothing
    const bool live = on && !(ANY_HIT && found);
    if (!fetch_leaf) {
      // --- node step: every live ray against the 16 children ---
      // a child absent or outside the restored mask is skipped by the
      // whole packet (the same branch in every lane)
      float mine = INFINITY;
#pragma unroll
      for (int k0 = 0; k0 < BRANCH; k0 += 4) {
        int4 cd = *reinterpret_cast<const int4*>(row + 96 + k0);
        float4 lx = *reinterpret_cast<const float4*>(row + k0);
        float4 hx = *reinterpret_cast<const float4*>(row + 16 + k0);
        float4 ly = *reinterpret_cast<const float4*>(row + 32 + k0);
        float4 hy = *reinterpret_cast<const float4*>(row + 48 + k0);
        float4 lz = *reinterpret_cast<const float4*>(row + 64 + k0);
        float4 hz = *reinterpret_cast<const float4*>(row + 80 + k0);
        const int* acd = &cd.x;
        const float* alx = &lx.x; const float* ahx = &hx.x;
        const float* aly = &ly.x; const float* ahy = &hy.x;
        const float* alz = &lz.x; const float* ahz = &hz.x;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (!((restore >> (k0 + g)) & 1) || acd[g] == INVALID_CHILD) continue;
          float t1x = (alx[g] - ox) * ix;
          float t2x = (ahx[g] - ox) * ix;
          float t1y = (aly[g] - oy) * iy;
          float t2y = (ahy[g] - oy) * iy;
          float t1z = (alz[g] - oz) * iz;
          float t2z = (ahz[g] - oz) * iz;
          float enter = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                              fmaxf(fminf(t1z, t2z), T_MIN));
          float leave = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                              fminf(fmaxf(t1z, t2z), t_best));
          const bool ok = live && enter <= leave * ROBUST_FAR;
          float d16;
          if (ANY_HIT) {
            d16 = __any_sync(gm, ok) ? 0.0f : INFINITY;
          } else {
            // entry distances are > 0, so their bits order like integers
            d16 = __uint_as_float(__reduce_min_sync(
                gm, ok ? __float_as_uint(enter) : __float_as_uint(INFINITY)));
          }
          if (j == k0 + g) mine = d16;
        }
      }
      const int code = j < BRANCH ? reinterpret_cast<const int32_t*>(row)[96 + j]
                                  : INVALID_CHILD;
      const bool valid = j < BRANCH && ((restore >> j) & 1) && code != INVALID_CHILD;
      if (STATS)
        slab_tests += (unsigned long long)__popc(__ballot_sync(gm, live)) *
                      __popc(__ballot_sync(gm, valid));
      pend_dist = valid ? mine : INFINITY;
      pend_code = code;
      cur_node = (int)fetch;
    } else {
      // --- leaf step: every live ray's 14 Moller-Trumbore tests ---
      float t14 = INFINITY, hu = 0.0f, hv = 0.0f;
      int k14 = 0;
      bool occluded = false;
#pragma unroll
      for (int k0 = 0; k0 < WIDE_LEAF; k0 += 2) {
        float2 ax = *reinterpret_cast<const float2*>(row + k0);
        float2 ay = *reinterpret_cast<const float2*>(row + 14 + k0);
        float2 az = *reinterpret_cast<const float2*>(row + 28 + k0);
        float2 bx = *reinterpret_cast<const float2*>(row + 42 + k0);
        float2 by = *reinterpret_cast<const float2*>(row + 56 + k0);
        float2 bz = *reinterpret_cast<const float2*>(row + 70 + k0);
        float2 cx = *reinterpret_cast<const float2*>(row + 84 + k0);
        float2 cy = *reinterpret_cast<const float2*>(row + 98 + k0);
        float2 cz = *reinterpret_cast<const float2*>(row + 112 + k0);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const float v0x = g ? ax.y : ax.x, v0y = g ? ay.y : ay.x, v0z = g ? az.y : az.x;
          const float e1x = g ? bx.y : bx.x, e1y = g ? by.y : by.x, e1z = g ? bz.y : bz.x;
          const float e2x = g ? cx.y : cx.x, e2y = g ? cy.y : cy.x, e2z = g ? cz.y : cz.x;
          // a padding slot (both edges zero) never hits: the whole packet
          // skips it
          if (e1x == 0.0f && e1y == 0.0f && e1z == 0.0f && e2x == 0.0f &&
              e2y == 0.0f && e2z == 0.0f)
            continue;
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
          if (ANY_HIT) {
            occluded = occluded || (hit && t < t_best);
          } else if (hit && t < t14) {  // the first of equal t wins
            t14 = t;
            k14 = k0 + g;
            hu = u;
            hv = v;
          }
        }
      }
      if (STATS)
        tri_tests += (unsigned long long)__popc(__ballot_sync(gm, live)) * WIDE_LEAF;
      if (ANY_HIT) {
        found = found || (live && occluded);
        if (!__any_sync(gm, on && !found)) break;
      } else {
        if (live && t14 < t_best) {
          t_best = t14;
          best_leaf = fetch;
          best_k = k14;
          best_u = hu;
          best_v = hv;
        }
        // drop pending children that start beyond every live ray's hit
        float t_pack = __uint_as_float(__reduce_max_sync(
            gm, live ? __float_as_uint(t_best) : 0u));
        if (pend_dist > t_pack * ROBUST_FAR) pend_dist = INFINITY;
      }
    }
    // --- select the nearest pending child (lowest k among equal) ---
    unsigned key = (j < BRANCH && pend_dist < INFINITY) ? __float_as_uint(pend_dist) : NO_KEY;
    unsigned lo = __reduce_min_sync(gm, key);
    if (lo != NO_KEY) {
      int sel = (int)__reduce_min_sync(gm, key == lo ? (unsigned)j : NO_INDEX);
      if (j == sel) pend_dist = INFINITY;
      const int code = __shfl_sync(gm, pend_code, sel);
      const unsigned remaining =
          __ballot_sync(gm, j < BRANCH && pend_dist < INFINITY) & 0xFFFFu;
      if (code < 0) {
        fetch = (long long)num_nodes + (long long)(~code);
        fetch_leaf = true;
      } else {
        if (remaining != 0) {
          if (j == 0) stack[sp] = make_int2(cur_node, (int)remaining);
          ++sp;
        }
        fetch = code;
        fetch_leaf = false;
      }
      restore = (1u << BRANCH) - 1;
    } else if (sp > 0) {
      --sp;
      int2 top = make_int2(0, 0);
      if (j == 0) top = stack[sp];
      fetch = __shfl_sync(gm, top.x, 0);
      restore = (unsigned)__shfl_sync(gm, top.y, 0);
      fetch_leaf = false;
    } else {
      done = true;
    }
  }

  if (STATS && j == 0) {
    atomicAdd(&counters[0], slab_tests);
    atomicAdd(&counters[1], tri_tests);
  }
  if (i >= n) return;
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

template <bool ANY_HIT, bool STATS>
static int launch(const void* rows, int num_nodes, int depth,
                  const void* rays, long long n, void* t_out, void* slot_out,
                  void* u_out, void* v_out, void* found_out, void* counters,
                  cudaStream_t s) {
  const size_t smem = (size_t)PACKETS * depth * sizeof(int2);
  unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  traverse_wide_kernel<ANY_HIT, STATS><<<blocks, THREADS, smem, s>>>(
      (const float*)rows, num_nodes, depth, (const float4*)rays, n,
      (float*)t_out, (int32_t*)slot_out, (float*)u_out, (float*)v_out,
      (uint8_t*)found_out, (unsigned long long*)counters);
  return (int)cudaGetLastError();
}

// counters: null, or two zeroed u64 words on the device that receive the
// slab and triangle test counts of this launch.
extern "C" int lum_traverse_wide(const void* rows, int num_nodes, int depth,
                                 const void* rays, long long n, int any_hit,
                                 void* t_out, void* slot_out, void* u_out,
                                 void* v_out, void* found_out, void* counters,
                                 void* stream) {
  if (depth > MAX_STACK) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (depth < 1) depth = 1;
  cudaStream_t s = (cudaStream_t)stream;
#define LUM_LAUNCH(A, S)                                                    \
  launch<A, S>(rows, num_nodes, depth, rays, n, t_out, slot_out, u_out,    \
               v_out, found_out, counters, s)
  if (any_hit)
    return counters ? LUM_LAUNCH(true, true) : LUM_LAUNCH(true, false);
  return counters ? LUM_LAUNCH(false, true) : LUM_LAUNCH(false, false);
#undef LUM_LAUNCH
}
