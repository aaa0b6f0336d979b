// gather_sum (kernel E): K row fetches summed per column, and a chain of
// dependent row fetches.
//
// Replaces the two scalar-loop Pallas prototypes:
//   tools/proto_pallas_gather.py  e2_scalar_loop (:96, pallas_call :112):
//     out[c] = sum over i < K of tab[idx[i], c], added i = 0, 1, ..., K - 1;
//   tools/proto_pallas_gather2.py e2c_scalar_loop (:40, pallas_call :64):
//     a chain of `steps` fetches in which each row chooses the next index:
//       idx_0     = floormod(int32(f32(seed) * 1e6), S)
//       acc      += tab[idx_j]
//       idx_{j+1} = floormod(floormod(int32(f32(idx_j) + row[0] * 0 + 1), S)
//                            + (row[1] > 2), S)
//     with int32() truncating toward zero and floormod taking the sign of S,
//     as jnp's `%` does, so a negative seed works.
// A scalar index outside [0, S) wraps once (k + S) and then clamps into
// [0, S - 1], as the prototype's tab_ref[idx, :] does in Pallas's interpret
// mode.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W (3.35 TB/s, 67 TFLOP/s
// fp32): latency, not bytes or operations. The prototype's
// K = 2048 rows of 512 B are 1 MB (0.31 us at 3.35 TB/s) and the chain's
// 4096 rows 2 MB (0.63 us), but the sum is taken in index order, so that it
// equals the sequential plain version bit for bit, and each step of the
// chain needs the row before it. Design: one warp does the whole call, each
// lane one float4 (4 columns) of a row of at most 128 columns.
// gather_sum loads 32 indices at once (one a lane), broadcasts them by
// shuffle and issues UNROLL row loads before the adds that consume them, so
// UNROLL rows are in flight while the adds keep their order. gather_chain
// cannot look ahead: the lane that holds columns 0-3 computes the next index
// and broadcasts it, one L2 or memory round trip per step.

#include <cuda_runtime.h>
#include <stdint.h>

#define UNROLL 16
#define FULL 0xffffffffu

__device__ __forceinline__ long long clamp_row(long long k, long long rows) {
  if (k < 0) k += rows;
  return k < 0 ? 0 : (k >= rows ? rows - 1 : k);
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__global__ void gather_sum_kernel(const float4* __restrict__ tab,
                                  long long rows, int cols4,
                                  const int32_t* __restrict__ idx,
                                  long long k_n, float4* __restrict__ out) {
  const int lane = threadIdx.x;
  const bool mine = lane < cols4;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long base = 0; base < k_n; base += 32) {
    const int m = k_n - base < 32 ? (int)(k_n - base) : 32;
    const int my = lane < m ? idx[base + lane] : 0;
    for (int j = 0; j < m; j += UNROLL) {
      float4 r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = __shfl_sync(FULL, my, (j + u) & 31);
        if (mine && j + u < m) r[u] = tab[clamp_row(k, rows) * cols4 + lane];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (mine && j + u < m) add4(acc, r[u]);
      }
    }
  }
  if (mine) out[lane] = acc;
}

__global__ void gather_chain_kernel(const float4* __restrict__ tab, int rows,
                                    int cols4, const float* __restrict__ seed,
                                    int steps, float4* __restrict__ out) {
  const int lane = threadIdx.x;
  const bool mine = lane < cols4;
  int idx = floor_mod((int)(seed[0] * 1e6f), rows);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < steps; ++j) {
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (mine) {
      r = tab[(long long)idx * cols4 + lane];
      add4(acc, r);
    }
    int nidx = 0;
    if (lane == 0) {
      const float f = ((float)idx + r.x * 0.0f) + 1.0f;
      nidx = floor_mod((int)f, rows);
      nidx = floor_mod(nidx + (r.y > 2.0f ? 1 : 0), rows);
    }
    idx = __shfl_sync(FULL, nidx, 0);
  }
  if (mine) out[lane] = acc;
}

extern "C" int lum_gather_sum(const void* tab, long long rows, int cols,
                              const void* idx, long long k_n, void* out,
                              void* stream) {
  if (cols <= 0 || cols > 128 || (cols & 3) != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  gather_sum_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float4*)tab, rows, cols >> 2, (const int32_t*)idx, k_n,
      (float4*)out);
  return (int)cudaGetLastError();
}

extern "C" int lum_gather_chain(const void* tab, int rows, int cols,
                                const void* seed, int steps, void* out,
                                void* stream) {
  if (cols <= 0 || cols > 128 || (cols & 3) != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  gather_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float4*)tab, rows, cols >> 2, (const float*)seed, steps,
      (float4*)out);
  return (int)cudaGetLastError();
}
