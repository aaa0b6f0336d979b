// gather_soa: row gather handed out as structure-of-arrays columns.
//
// Replaces two Pallas kernels of the JAX package:
//   luminary_tpu/ops/rowops.py  gather_packed_planar (_make_select_kernel):
//     packed shade rows, 8 slots per row, 8 -> 1 sub-slot select;
//   luminary_tpu/ops/rowops.py  planar / gather_planar (_transpose_kernel):
//     [N, C] -> [C, N] block transpose after a row gather.
// On the TPU the gather ran at XLA level and the Pallas kernels only
// transposed and selected; here one kernel does the whole function:
//
//   out[c, i] = table[k // s, c * s + k % s]   k = idx[i], s = sub_stride,
//                                               c < n_cols
//
// with floor division, a negative row normalised by adding the row count and
// then clamped into range (what JAX's table[idx] does), so masked lanes agree
// with the reference too. The table holds 32-bit words; the kernel moves bits.
//
// Bound on an H100: bytes. Each lane reads its index and its columns of one
// row and writes n_cols words; there is no arithmetic to speak of. The design
// gives one lane to a thread: a warp covers 32 lanes, each thread reads its
// own row (16-byte vector loads when the row is a plain run of 4-word groups,
// sub_stride 1) and the writes of each column are coalesced across the warp.
// Rows of neighbouring lanes are scattered, so reads are the cost; caching
// of hot rows is left to L2 (the tables on the main path are a few MB).
//
// unplanar_kernel replaces the third Pallas kernel of that file:
//   luminary_tpu/ops/rowops.py  unplanar (_transpose_kernel):
//     [C, N] -> [N, C] block transpose,
//
//   out[i * C + c] = col_c[i]                   i < N, c < C <= UNPLANAR_MAX_COLS
//
// where col_c are C planar [N] columns of 32-bit words (the rows of a [C, N]
// array, or C separate lane tensors). The port uses it to pack the SoA ray
// lanes into the [N, 8] ray rows that traverse_wide reads with two 16-byte
// loads. Bound: bytes, N * C words read and written once. A block stages
// UNPLANAR_LANES lanes in shared memory: each column is read coalesced into
// a lane-major tile (row stride C rounded up to odd, so the column writes
// into the tile hit distinct banks), then the block's contiguous run of
// N_blk * C output words is written coalesced from the tile.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_soa_kernel(const uint32_t* __restrict__ table,
                                  long long rows, int cols,
                                  const int32_t* __restrict__ idx, long long n,
                                  int sub, int n_cols,
                                  uint32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long k = idx[i];
  long long r = k / sub;
  long long s = k - r * sub;
  if (s < 0) {  // floor semantics for negative k
    s += sub;
    r -= 1;
  }
  if (r < 0) r += rows;
  if (r < 0) r = 0;
  if (r > rows - 1) r = rows - 1;
  const uint32_t* row = table + r * (long long)cols;
  int c = 0;
  if (sub == 1 && (cols & 3) == 0) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (; c + 4 <= n_cols; c += 4) {
      uint4 w = row4[c >> 2];
      out[(long long)(c + 0) * n + i] = w.x;
      out[(long long)(c + 1) * n + i] = w.y;
      out[(long long)(c + 2) * n + i] = w.z;
      out[(long long)(c + 3) * n + i] = w.w;
    }
  }
  for (; c < n_cols; ++c) {
    out[(long long)c * n + i] = row[(long long)c * sub + s];
  }
}

extern "C" int lum_gather_soa(const void* table, long long rows, int cols,
                              const void* idx, long long n, int sub,
                              int n_cols, void* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    gather_soa_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)table, rows, cols, (const int32_t*)idx, n, sub,
        n_cols, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

#define UNPLANAR_MAX_COLS 32
#define UNPLANAR_LANES 256

struct UnplanarCols {
  const uint32_t* p[UNPLANAR_MAX_COLS];
};

__global__ void unplanar_kernel(UnplanarCols cols, int c_n, long long n,
                                uint32_t* __restrict__ out) {
  extern __shared__ uint32_t tile[];  // [UNPLANAR_LANES][stride]
  const int stride = c_n | 1;
  const long long base = (long long)blockIdx.x * UNPLANAR_LANES;
  const long long left = n - base;
  const int lanes = left < UNPLANAR_LANES ? (int)left : UNPLANAR_LANES;
  const int t = threadIdx.x;
  if (t < lanes) {
    for (int c = 0; c < c_n; ++c) tile[t * stride + c] = cols.p[c][base + t];
  }
  __syncthreads();
  uint32_t* dst = out + base * c_n;
  const int words = lanes * c_n;
  for (int w = t; w < words; w += UNPLANAR_LANES) {
    const int lane = w / c_n;
    dst[w] = tile[lane * stride + (w - lane * c_n)];
  }
}

extern "C" int lum_unplanar(const void* const* cols, int c_n, long long n,
                            void* out, void* stream) {
  if (c_n < 1 || c_n > UNPLANAR_MAX_COLS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    UnplanarCols p;
    for (int c = 0; c < UNPLANAR_MAX_COLS; ++c)
      p.p[c] = c < c_n ? (const uint32_t*)cols[c] : nullptr;
    long long blocks = (n + UNPLANAR_LANES - 1) / UNPLANAR_LANES;
    size_t smem = (size_t)UNPLANAR_LANES * (c_n | 1) * sizeof(uint32_t);
    unplanar_kernel<<<(unsigned)blocks, UNPLANAR_LANES, smem,
                      (cudaStream_t)stream>>>(p, c_n, n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
