// transpose (kernel T): [n, c] -> [c, n] of 32-bit words.
//
// Replaces tools/microbench_colext.py pallas_T (:76, pallas_call :78, block
// kernel _tkern :73): the transpose of a gathered [N, 48] f32 array into
// planar [48, N] columns, a grid over 2048-row blocks that needs N to be a
// multiple of 2048. Here any n and c are taken: the edge tiles are masked.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W (3.35 TB/s, 67 TFLOP/s
// fp32): bytes, n * c words read once and written once (805 MB
// for [2^21, 48]: 0.24 ms at 3.35 TB/s). Design: the tiled transpose. A
// block of 32 x 8 threads moves one 32 x 32 tile through shared memory
// whose row stride is 33 words, so a warp reads 32 neighbouring words of an
// input row, writes 32 neighbouring words of an output row, and its
// transposed reads from the tile hit 32 distinct banks. One block a tile;
// tiles run along n first, so neighbouring blocks read neighbouring rows.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 32
#define TROWS 8

__global__ void transpose_kernel(const uint32_t* __restrict__ in, long long n,
                                 int c, long long tiles_n,
                                 uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[TILE][TILE + 1];
  const long long r0 = (long long)(blockIdx.x % tiles_n) * TILE;
  const int c0 = (int)(blockIdx.x / tiles_n) * TILE;
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  for (int j = ty; j < TILE; j += TROWS) {
    const long long r = r0 + j;
    if (r < n && c0 + tx < c) tile[j][tx] = in[r * c + c0 + tx];
  }
  __syncthreads();
  for (int j = ty; j < TILE; j += TROWS) {
    const long long r = r0 + tx;
    if (c0 + j < c && r < n) out[(long long)(c0 + j) * n + r] = tile[tx][j];
  }
}

extern "C" int lum_transpose(const void* in, long long n, int c, void* out,
                             void* stream) {
  if (c <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long tiles_n = (n + TILE - 1) / TILE;
    const long long blocks = tiles_n * ((c + TILE - 1) / TILE);
    transpose_kernel<<<(unsigned)blocks, TILE * TROWS, 0,
                       (cudaStream_t)stream>>>((const uint32_t*)in, n, c,
                                               tiles_n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
