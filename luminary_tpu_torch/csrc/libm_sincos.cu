// libm_sincos: glibc's float32 sinf / cosf on the card.
//
// Replaces no TPU kernel. The reference's compiled CPU code calls the C
// library for a float32 sine or cosine (glibc's sinf / cosf, its FMA build),
// and the port copies those bits where an ulp moves a path (here the cloud
// hash; the bounce's samples call the same device function inside
// csrc/shading.cu; luminary_tpu_torch/ops/libm.py glibc_exact, in float64
// PyTorch, is this kernel's plain version). On the card that plain
// version is some 60 elementwise launches over every hashed corner; this
// kernel is one, glibc_sincosf.cuh over each element.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W: bytes, 4 B read and 4 B
// written an element (0.0048 ms for 2M at 3.35 TB/s); ~20 double operations
// an element are far below the fp64 rate. Design: one thread an element.

#include <cuda_runtime.h>

#include "glibc_sincosf.cuh"

__global__ void libm_sincos_kernel(const float* __restrict__ y,
                                   float* __restrict__ out, long long n,
                                   int want_cos) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = glibc_sincosf(y[i], want_cos);
}

extern "C" int lum_libm_sincos(const void* y, void* out, long long n,
                               int want_cos, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  libm_sincos_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)y, (float*)out, n, want_cos);
  return (int)cudaGetLastError();
}
