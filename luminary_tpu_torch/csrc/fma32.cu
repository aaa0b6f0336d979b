// fma32: the float32 fused multiply-add a * b + c, rounded once.
//
// Replaces no TPU kernel. The reference's compiled CPU code contracts a
// float32 product that has one use into the add that consumes it, and the
// port rounds those sites alike (luminary_tpu_torch/ops/vec.py fma32, whose
// float64 PyTorch version is this kernel's plain version). On the card the
// camera, hit point and bounce sites run inside csrc/shading.cu; this
// kernel serves the cloud hash, one launch a site in place of the plain
// version's ~10: __fmaf_rn, the card's own fused multiply-add.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W: bytes, up to 3 x 4 B read
// and 4 B written an element. Each operand is a full array (stride 1) or a
// scalar: a pointer with stride 0, or a value when the pointer is null.

#include <cuda_runtime.h>

__global__ void fma32_kernel(const float* __restrict__ a, long long sa, float va,
                             const float* __restrict__ b, long long sb, float vb,
                             const float* __restrict__ c, long long sc, float vc,
                             float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a ? a[i * sa] : va;
  const float y = b ? b[i * sb] : vb;
  const float z = c ? c[i * sc] : vc;
  out[i] = __fmaf_rn(x, y, z);
}

extern "C" int lum_fma32(const void* a, long long sa, float va, const void* b,
                         long long sb, float vb, const void* c, long long sc,
                         float vc, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fma32_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, sa, va, (const float*)b, sb, vb, (const float*)c, sc, vc,
      (float*)out, n);
  return (int)cudaGetLastError();
}
