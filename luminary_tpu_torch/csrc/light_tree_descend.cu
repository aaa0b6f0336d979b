// light_tree_descend: the whole stochastic light-tree descent, one thread
// per shading point.
//
// Replaces luminary_tpu/ops/light_tree_pallas.py (_make_level_kernel,
// launched once per level by _run_level and driven by descend_pallas from
// ops/light_tree.py sample_light_tree). On the TPU each launch ran ONE level
// over lanes-major blocks, after an XLA-level row gather, an XLA-level f16
// decode of the cone axes and normals (decode_ext_rows) and a root
// broadcast. Here one launch runs every level: the thread reads its node row
// by the id it picked, decodes the f16 octahedral axes itself and walks on.
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
// Order of sums: the CDF over the 16 children (14 lights) is a sequential
// prefix sum, and the level's total is its last entry; the plain version
// (ops/light_tree.py light_tree_descend_plain) sums in the same order. With
// -fmad=false and IEEE sqrt and division, picks can differ from it only on
// lanes whose uniform lies within rounding of a CDF edge.
//
// Bound on an H100: bytes, one 512-byte row read per lane and level (the
// tree of the bench scene, ~0.5k rows, is L2-resident), plus ~30 flops per
// child. The design keeps the walk in registers; neighbouring lanes diverge
// only in which row they read.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BRANCH 16
#define TREE_LEAF 14
#define INVALID 0x7FFFFFFF
#define CONE_EPS 0.01f

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

__global__ void light_tree_descend_kernel(
    const float* __restrict__ rows, int num_nodes, int levels,
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ pz_, const float* __restrict__ rnd, long long n,
    int32_t* __restrict__ slot_out, float* __restrict__ pdf_out,
    uint8_t* __restrict__ valid_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = px_[i], py = py_[i], pz = pz_[i];
  long long node = 0;
  float pdf = 1.0f;
  int slot = -1;
  bool at_leaf = false;
  for (int lvl = 0; lvl <= levels; ++lvl) {
    const float* row = rows + node * 128;
    const float r = rnd[(long long)lvl * n + i];
    if (!at_leaf) {
      const int32_t* code16 = reinterpret_cast<const int32_t*>(row + 80);
      float imp[BRANCH];
#pragma unroll
      for (int k = 0; k < BRANCH; ++k) {
        float dx = row[k] - px;
        float dy = row[16 + k] - py;
        float dz = row[32 + k] - pz;
        float rad = row[48 + k];
        float pw = row[64 + k];
        float d2 = dx * dx + dy * dy + dz * dz;
        float w = pw / fmaxf(d2, fmaxf(rad * rad, 1e-8f));
        float ax, ay, az;
        unpack_oct_f16(row[96 + k], &ax, &ay, &az);
        float inv_d = rsqrt_ieee(fmaxf(d2, 1e-12f));
        float cos_t = -(ax * dx + ay * dy + az * dz) * inv_d;
        cos_t = clampf(cos_t, -1.0f, 1.0f);
        float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
        float cos_o = clampf(row[112 + k], -1.0f, 1.0f);
        float sin_o = sqrtf(fmaxf(1.0f - cos_o * cos_o, 0.0f));
        float c1 = cos_t >= cos_o ? 1.0f : cos_t * cos_o + sin_t * sin_o;
        float s1 = sqrtf(fmaxf(1.0f - c1 * c1, 0.0f));
        float sin_u = fminf(rad * inv_d, 1.0f);
        float cos_u = sqrtf(fmaxf(1.0f - sin_u * sin_u, 0.0f));
        float c2 = c1 >= cos_u ? 1.0f : c1 * cos_u + s1 * sin_u;
        w = w * fmaxf(c2, CONE_EPS);
        imp[k] = code16[k] == INVALID ? 0.0f : w;
      }
      float cum = 0.0f;
      float cums[BRANCH];
#pragma unroll
      for (int k = 0; k < BRANCH; ++k) {
        cum = cum + imp[k];
        cums[k] = cum;
      }
      float tot = cum;
      if (!(tot > 0.0f)) break;  // dead end: no contributing child
      float rt = r * tot;
      int pick = 0;
#pragma unroll
      for (int k = 0; k < BRANCH; ++k) pick += cums[k] <= rt ? 1 : 0;
      pick = pick < BRANCH - 1 ? pick : BRANCH - 1;
      float p_c = imp[pick] / fmaxf(tot, 1e-30f);
      pdf = pdf * p_c;
      int code = code16[pick];
      if (code < 0) {
        node = (long long)num_nodes + (long long)(~code);
        at_leaf = true;
      } else {
        node = code;
      }
    } else {
      const int32_t* lslot = reinterpret_cast<const int32_t*>(row);
      float limp[TREE_LEAF];
#pragma unroll
      for (int k = 0; k < TREE_LEAF; ++k) {
        float ldx = row[28 + k] - px;
        float ldy = row[42 + k] - py;
        float ldz = row[56 + k] - pz;
        float ld2 = ldx * ldx + ldy * ldy + ldz * ldz;
        float lnx, lny, lnz;
        unpack_oct_f16(row[70 + k], &lnx, &lny, &lnz);
        float l_inv_d = rsqrt_ieee(fmaxf(ld2, 1e-12f));
        float l_cos = -(lnx * ldx + lny * ldy + lnz * ldz) * l_inv_d;
        float l_face = fmaxf(l_cos, CONE_EPS);
        limp[k] = lslot[k] >= 0 ? row[14 + k] * l_face / fmaxf(ld2, 1e-8f)
                                : 0.0f;
      }
      float cum = 0.0f;
      float cums[TREE_LEAF];
#pragma unroll
      for (int k = 0; k < TREE_LEAF; ++k) {
        cum = cum + limp[k];
        cums[k] = cum;
      }
      float ltot = cum;
      if (ltot > 0.0f) {
        float lrt = r * ltot;
        int lpick = 0;
#pragma unroll
        for (int k = 0; k < TREE_LEAF; ++k) lpick += cums[k] <= lrt ? 1 : 0;
        lpick = lpick < TREE_LEAF - 1 ? lpick : TREE_LEAF - 1;
        pdf = pdf * (limp[lpick] / fmaxf(ltot, 1e-30f));
        slot = lslot[lpick];
      }
      break;  // a leaf step always ends the descent
    }
  }
  slot_out[i] = slot;
  pdf_out[i] = pdf;
  valid_out[i] = (slot >= 0 && pdf > 0.0f) ? 1 : 0;
}

extern "C" int lum_light_tree_descend(const void* rows, int num_nodes,
                                      int levels, const void* px,
                                      const void* py, const void* pz,
                                      const void* rnd, long long n,
                                      void* slot_out, void* pdf_out,
                                      void* valid_out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    light_tree_descend_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)rows, num_nodes, levels, (const float*)px,
        (const float*)py, (const float*)pz, (const float*)rnd, n,
        (int32_t*)slot_out, (float*)pdf_out, (uint8_t*)valid_out);
  }
  return (int)cudaGetLastError();
}
