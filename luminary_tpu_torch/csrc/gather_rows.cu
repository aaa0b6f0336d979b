// gather_rows (kernel D): per-lane row gather, out[i, :] = tab[r(idx[i]), :].
//
// Replaces the row-gather Pallas prototypes of tools/proto_pallas_gather.py:
//   e1_take           (:41, pallas_call :52)   jnp.take(tab, idx, axis=0)
//   e1b_takealong     (:68, pallas_call :80)   take_along_axis, idx [N, 1]
//   e3_onehot         (:128, pallas_call :143) onehot(idx) @ bf16(tab), f32 sum
//   e4_dyn_slice_vec  (:159, pallas_call :169) tab_ref[idx_vec, :]
// All four compute the same rows. They differ on an index outside [0, S),
// where S is the table's row count, and the one-hot product rounds every
// value to bf16. The index rule is the `mode` argument; each is what its
// prototype does in Pallas's interpret mode:
//   MODE_FILL_NAN (take, take_along_axis): a negative index wraps once
//     (k + S); an index still outside [0, S) gives a row of NaN;
//   MODE_CLAMP (ref[idx]): wraps once, then clamps into [0, S - 1];
//   MODE_ZERO (one-hot): no wrap; an index outside [0, S) matches no row
//     and gives a row of zeros.
// With round_bf16 every value is rounded to bf16 (to nearest, ties to even;
// a NaN stays a NaN) and widened back. A one-hot row times a bf16 table,
// summed in f32, is exactly that, so no matrix product is run.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W (3.35 TB/s, 67 TFLOP/s
// fp32): bytes; there is no arithmetic. At the prototype's
// shape (65,536 rows of 128 f32 from an 8192-row table) it writes 33.6 MB,
// reads 4.2 MB of table and 0.26 MB of indices: ~11.4 us at 3.35 TB/s.
// Design: one warp per output row, each lane one 16-byte float4 of it, so
// a warp reads a table row and writes an output row as whole 512-byte runs,
// neighbouring lanes on neighbouring addresses. Rows that repeat come from
// L2 (the 4 MB table fits in its 50 MB).

#include <cuda_runtime.h>
#include <stdint.h>

#define MODE_FILL_NAN 0
#define MODE_CLAMP 1
#define MODE_ZERO 2
#define ROWS_PER_BLOCK 8

__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__global__ void gather_rows_kernel(const float4* __restrict__ tab,
                                   long long rows, int cols4,
                                   const int32_t* __restrict__ idx, long long n,
                                   int mode, int round,
                                   float4* __restrict__ out) {
  const long long i =
      (long long)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  long long k = idx[i];
  bool fill = false;
  if (mode != MODE_ZERO && k < 0) k += rows;
  if (k < 0 || k >= rows) {
    if (mode == MODE_CLAMP) {
      k = k < 0 ? 0 : rows - 1;
    } else {
      fill = true;
      k = 0;
    }
  }
  const float f = mode == MODE_FILL_NAN ? __uint_as_float(0x7fc00000u) : 0.0f;
  const float4* src = tab + k * cols4;
  float4* dst = out + i * cols4;
  for (int c = lane; c < cols4; c += 32) {
    float4 v;
    if (fill) {
      v = make_float4(f, f, f, f);
    } else {
      v = src[c];
      if (round) {
        v.x = round_bf16(v.x);
        v.y = round_bf16(v.y);
        v.z = round_bf16(v.z);
        v.w = round_bf16(v.w);
      }
    }
    dst[c] = v;
  }
}

extern "C" int lum_gather_rows(const void* tab, long long rows, int cols,
                               const void* idx, long long n, int mode,
                               int round_bf16, void* out, void* stream) {
  if (cols <= 0 || (cols & 3) != 0 || rows <= 0 || mode < MODE_FILL_NAN ||
      mode > MODE_ZERO)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    gather_rows_kernel<<<(unsigned)blocks, 32 * ROWS_PER_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const float4*)tab, rows, cols >> 2, (const int32_t*)idx, n, mode,
        round_bf16, (float4*)out);
  }
  return (int)cudaGetLastError();
}
