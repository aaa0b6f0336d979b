// light_tree_descend: the whole stochastic light-tree descent, four lanes
// per shading point.
//
// Replaces luminary_tpu/ops/light_tree_pallas.py (_make_level_kernel,
// launched once per level by _run_level and driven by descend_pallas from
// ops/light_tree.py sample_light_tree). On the TPU each launch ran ONE level
// over lanes-major blocks, after an XLA-level row gather, an XLA-level f16
// decode of the cone axes and normals (decode_ext_rows) and a root
// broadcast. Here one launch runs every level: a point's lanes read its node
// row by the id they picked, decode the f16 octahedral axes themselves and
// walk on.
//
// Tree table (luminary_tpu_torch/ops/light_tree.py build_light_tree),
// f32 [num_nodes + B, 128]:
//   node row: cols 0:48 child centre x|y|z, 48:64 radius, 64:80 power,
//             80:96 child code (i32 bits; >= 0 node, < 0 leaf ~code,
//             0x7FFFFFFF absent), 96:112 cone axis (oct uv, 2 x f16),
//             112:128 cos of the cone half-angle
//   leaf row: cols 0:14 light index (i32 bits, -1 pad), 14:28 power,
//             28:70 centroid x|y|z, 70:84 face normal (oct uv, 2 x f16)
//
// Randoms: the wrapper draws the levels+1 uniforms with the port's random_1d
// (RandomTarget.LIGHT_TREE_LEVEL, sub-stream dk*8+lvl) and passes them as
// [levels+1, N] f32, so the picks depend on no generator in here.
//
// Bound on an H100: operations, ~48 per child and ~26 per light, since the
// tree of the bench scene (~0.5k rows) is L2-resident and the bytes that
// must come from device memory are the positions, uniforms and outputs.
// Under -fmad=false with IEEE square roots and divisions, the arithmetic of
// the 16 child weights is most of the instructions.
//
// What held the first version back: one thread walked one shading point,
// read its 512-byte row one float at a time (from level 1 on the 32 threads
// of a warp sat on up to 32 rows) and kept the 16 weights and prefix sums in
// arrays indexed at run time (a 128-byte local frame), so every level went
// through local memory.
//
// Layout now: LANES = 4 lanes take one shading point, lane j the children
// j, j+4, j+8, j+12 (at a leaf the lights j, j+4, ...; lanes past the 14th
// light hold importance 0). Each column group of a row is read by the
// point's lanes as one 16-byte run per 4 children, so a warp serves its 8
// points with 16-byte pieces of at most 8 rows. Every lane then gathers the
// 16 (14) importances by shuffle and adds them in child order 0, 1, ..., so
// the prefix sums and the level total are bit for bit the sequential sums
// of the plain version (ops/light_tree.py light_tree_descend_plain); pick =
// the number of prefix sums <= r * total, clamped to 15 (13), as there. Four
// lanes measured faster than 16 (the half-warp layout: its ordered sums and
// pick are repeated in 16 lanes for one point), 8 or 1 on the H100
// (PERF.md). Built with -fmad=false and IEEE sqrt and division,
// picks can differ from the plain version only on lanes whose uniform lies
// within rounding of a CDF edge.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BRANCH 16
#define TREE_LEAF 14
#define INVALID 0x7FFFFFFF
#define CONE_EPS 0.01f
#define THREADS 128
#define LANES 4  // lanes per shading point

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}

__device__ __forceinline__ void unpack_oct_f16(float col, float* x, float* y,
                                               float* z) {
  uint32_t bits = __float_as_uint(col);
  float u = __half2float(__ushort_as_half((unsigned short)(bits & 0xFFFF)));
  float v = __half2float(__ushort_as_half((unsigned short)(bits >> 16)));
  float yy = 1.0f - fabsf(u) - fabsf(v);
  bool neg = yy < 0.0f;
  float sx = u >= 0.0f ? 1.0f : -1.0f;
  float sz = v >= 0.0f ? 1.0f : -1.0f;
  float xx = neg ? (1.0f - fabsf(v)) * sx : u;
  float zz = neg ? (1.0f - fabsf(u)) * sz : v;
  float inv = rsqrt_ieee(fmaxf(xx * xx + yy * yy + zz * zz, 1e-12f));
  *x = xx * inv;
  *y = yy * inv;
  *z = zz * inv;
}

// Importance of a node's child seen from (px, py, pz).
__device__ __forceinline__ float child_weight(float cx, float cy, float cz,
                                              float rad, float pw, float axis,
                                              float cos_cone, float px,
                                              float py, float pz) {
  float dx = cx - px;
  float dy = cy - py;
  float dz = cz - pz;
  float d2 = dx * dx + dy * dy + dz * dz;
  float w = pw / fmaxf(d2, fmaxf(rad * rad, 1e-8f));
  float ax, ay, az;
  unpack_oct_f16(axis, &ax, &ay, &az);
  float inv_d = rsqrt_ieee(fmaxf(d2, 1e-12f));
  float cos_t = -(ax * dx + ay * dy + az * dz) * inv_d;
  cos_t = clampf(cos_t, -1.0f, 1.0f);
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float cos_o = clampf(cos_cone, -1.0f, 1.0f);
  float sin_o = sqrtf(fmaxf(1.0f - cos_o * cos_o, 0.0f));
  float c1 = cos_t >= cos_o ? 1.0f : cos_t * cos_o + sin_t * sin_o;
  float s1 = sqrtf(fmaxf(1.0f - c1 * c1, 0.0f));
  float sin_u = fminf(rad * inv_d, 1.0f);
  float cos_u = sqrtf(fmaxf(1.0f - sin_u * sin_u, 0.0f));
  float c2 = c1 >= cos_u ? 1.0f : c1 * cos_u + s1 * sin_u;
  return w * fmaxf(c2, CONE_EPS);
}

// Importance of a leaf's light seen from (px, py, pz); 0 for a pad.
__device__ __forceinline__ float light_weight(int lslot, float pw, float cx,
                                              float cy, float cz, float nrm,
                                              float px, float py, float pz) {
  float ldx = cx - px;
  float ldy = cy - py;
  float ldz = cz - pz;
  float ld2 = ldx * ldx + ldy * ldy + ldz * ldz;
  float lnx, lny, lnz;
  unpack_oct_f16(nrm, &lnx, &lny, &lnz);
  float l_inv_d = rsqrt_ieee(fmaxf(ld2, 1e-12f));
  float l_cos = -(lnx * ldx + lny * ldy + lnz * ldz) * l_inv_d;
  float l_face = fmaxf(l_cos, CONE_EPS);
  return lslot >= 0 ? pw * l_face / fmaxf(ld2, 1e-8f) : 0.0f;
}

// The pick of one level: every lane gathers the COUNT importances in child
// order (lane j holds children j, j + LANES, ...), adds them one after
// another, and counts the prefix sums <= r * total, clamped to COUNT - 1.
// Returns the pick; *total and *imp_pick are the level total and the
// picked importance (the same in every lane of the point).
template <int COUNT, int N>
__device__ __forceinline__ int ordered_pick(unsigned gm, const float (&imp)[N],
                                            float r, float* total,
                                            float* imp_pick) {
  float all[COUNT];
#pragma unroll
  for (int c = 0; c < COUNT; ++c)
    all[c] = __shfl_sync(gm, imp[c / LANES], c % LANES, LANES);
  float cum = 0.0f;
  float cums[COUNT];
#pragma unroll
  for (int c = 0; c < COUNT; ++c) {
    cum = cum + all[c];
    cums[c] = cum;
  }
  *total = cum;
  const float rt = r * cum;
  int pick = 0;
#pragma unroll
  for (int c = 0; c < COUNT; ++c) pick += cums[c] <= rt ? 1 : 0;
  pick = min(pick, COUNT - 1);
  float ip = all[0];
#pragma unroll
  for (int c = 1; c < COUNT; ++c)
    if (c == pick) ip = all[c];
  *imp_pick = ip;
  return pick;
}

// The word the owner of child `pick` holds in v (lane pick % LANES, entry
// pick / LANES), in every lane of the point.
template <int N>
__device__ __forceinline__ int owner_word(unsigned gm, const int (&v)[N], int pick) {
  int mine = v[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (pick / LANES == q) mine = v[q];
  return __shfl_sync(gm, mine, pick % LANES, LANES);
}

__global__ void __launch_bounds__(THREADS) light_tree_descend_kernel(
    const float* __restrict__ rows, int num_nodes, int levels,
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ pz_, const float* __restrict__ rnd, long long n,
    int32_t* __restrict__ slot_out, float* __restrict__ pdf_out,
    uint8_t* __restrict__ valid_out) {
  constexpr int CPL = BRANCH / LANES;                   // children per lane
  constexpr int LPL = (TREE_LEAF + LANES - 1) / LANES;  // lights per lane
  const int lane = threadIdx.x & 31;
  const int j = lane % LANES;
  const unsigned gm = ((1u << LANES) - 1) << (lane - j);
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) / LANES;
  if (i >= n) return;  // a point's lanes leave together
  const float px = px_[i], py = py_[i], pz = pz_[i];
  long long node = 0;
  float pdf = 1.0f;
  int slot = -1;
  bool at_leaf = false;
  for (int lvl = 0; lvl <= levels; ++lvl) {
    const float* row = rows + node * 128;
    const float r = rnd[(long long)lvl * n + i];
    if (!at_leaf) {
      float imp[CPL];
      int code[CPL];
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        // child k = j + q * LANES: column group c is read at row[c * 16 + k]
        const float* col = row + j + q * LANES;
        code[q] = __float_as_int(col[80]);
        float w = child_weight(col[0], col[16], col[32], col[48], col[64],
                               col[96], col[112], px, py, pz);
        imp[q] = code[q] == INVALID ? 0.0f : w;
      }
      float tot, imp_pick;
      int pick = ordered_pick<BRANCH>(gm, imp, r, &tot, &imp_pick);
      if (!(tot > 0.0f)) break;  // dead end: no contributing child
      int code_pick = owner_word(gm, code, pick);
      pdf = pdf * (imp_pick / fmaxf(tot, 1e-30f));
      if (code_pick < 0) {
        node = (long long)num_nodes + (long long)(~code_pick);
        at_leaf = true;
      } else {
        node = code_pick;
      }
    } else {
      // lanes past the 14th light read the row's next columns and hold
      // importance 0
      float limp[LPL];
      int lslot[LPL];
#pragma unroll
      for (int q = 0; q < LPL; ++q) {
        // light k = j + q * LANES: column group c is read at row[c * 14 + k]
        const float* col = row + j + q * LANES;
        const bool is_light = j + q * LANES < TREE_LEAF;
        lslot[q] = is_light ? __float_as_int(col[0]) : -1;
        limp[q] = is_light ? light_weight(lslot[q], col[14], col[28], col[42],
                                          col[56], col[70], px, py, pz)
                           : 0.0f;
      }
      float ltot, imp_pick;
      int lpick = ordered_pick<TREE_LEAF>(gm, limp, r, &ltot, &imp_pick);
      int s_pick = owner_word(gm, lslot, lpick);
      if (ltot > 0.0f) {
        pdf = pdf * (imp_pick / fmaxf(ltot, 1e-30f));
        slot = s_pick;
      }
      break;  // a leaf step always ends the descent
    }
  }
  if (j == 0) {
    slot_out[i] = slot;
    pdf_out[i] = pdf;
    valid_out[i] = (slot >= 0 && pdf > 0.0f) ? 1 : 0;
  }
}

extern "C" int lum_light_tree_descend(const void* rows, int num_nodes,
                                      int levels, const void* px,
                                      const void* py, const void* pz,
                                      const void* rnd, long long n,
                                      void* slot_out, void* pdf_out,
                                      void* valid_out, void* stream) {
  if (n > 0) {
    const long long per_block = THREADS / LANES;
    unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    light_tree_descend_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rows, num_nodes, levels, (const float*)px,
        (const float*)py, (const float*)pz, (const float*)rnd, n,
        (int32_t*)slot_out, (float*)pdf_out, (uint8_t*)valid_out);
  }
  return (int)cudaGetLastError();
}
