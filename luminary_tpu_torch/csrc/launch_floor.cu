// An empty kernel: the card's floor for one launch. It replaces no TPU
// kernel and the package never calls it. chip_smoke.py times it as it times
// the kernels (device time from CUDA-graph replays), so that a kernel whose
// bound is far below that floor (F slab_body, D's zero rule) is read against
// the least time any launch takes, not only against its bytes.

#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int lum_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
