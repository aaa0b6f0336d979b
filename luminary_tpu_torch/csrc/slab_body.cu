// slab_body (kernel F): the traversal-body-shaped prototype, G packets of
// 16 children tested against 8 rays.
//
// Replaces tools/proto_pallas_gather2.py e5_slab_body (:81, pallas_call
// :126). Packet g takes one 128-column row: tab[g] (fetch mode "none") or
// tab[fetch[g]] ("scalarloop"; the index wraps once and clamps, as the
// prototype's tab_ref[fetch_ref[g, 0], :] does in interpret mode). Columns
// 0:16 | 16:32 hold the lo | hi x of its 16 children, 32:64 the y and 64:96
// the z the same way. With ray origins o_j = ox[j, g] + seed (j < 8; one
// origin for all three axes, as the prototype has it):
//   t1 = (lo - o) * k, t2 = (hi - o) * k     k = 1.7 (x), 0.3 (y), 1.1 (z)
//   enter = max(max(min(t1x, t2x), min(t1y, t2y)), min(t1z, t2z))
//   leave = min(min(max(t1x, t2x), max(t1y, t2y)), max(t1z, t2z))
//   dist16[c] = min over j of (enter <= leave ? enter : inf)
//   out[g] = min_c dist16[c] + argmin_c dist16[c]
// with ties to the first child, so a packet that misses everywhere gives
// inf + 0, as jnp.argmin does. Built with -fmad=false, the products and
// compares are those of the plain version bit for bit (finite inputs; min
// and max here do not propagate NaN). The prototype's [128, G] transpose of
// the rows is a TPU layout step and is not ported: each thread reads its
// child's six columns straight from the row.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W (3.35 TB/s, 67 TFLOP/s
// fp32): neither, at the prototype's G = 1024. It does ~3.3M
// fp32 operations (25 per child and ray; 0.049 us at 67 TFLOP/s) and moves
// ~0.44 MB (96 of each row's 128 columns, the origins, the fetch indices,
// the output; 0.13 us at 3.35 TB/s), so one launch costs its launch
// latency. Design: one thread per (packet, child), 16 lanes a packet, two
// packets a warp; the six column reads of a packet's 16 lanes are 64-byte
// runs, and the packet's minimum and its first argmin come from a 4-step
// shuffle reduction over the 16 lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CHILDREN 16
#define RAYS 8
#define THREADS 256
#define FULL 0xffffffffu

__global__ void slab_body_kernel(const float* __restrict__ tab, int rows,
                                 int cols, const float* __restrict__ ox,
                                 const int32_t* __restrict__ fetch,
                                 const float* __restrict__ seed, int g_n,
                                 float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int c = threadIdx.x & (CHILDREN - 1);
  const long long g = t / CHILDREN;
  const bool live = g < g_n;
  const long long gs = live ? g : 0;
  long long r = gs;
  if (fetch != nullptr) {
    r = fetch[gs];
    if (r < 0) r += rows;
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
  }
  const float* row = tab + r * cols;
  const float lo_x = row[c], hi_x = row[16 + c];
  const float lo_y = row[32 + c], hi_y = row[48 + c];
  const float lo_z = row[64 + c], hi_z = row[80 + c];
  const float s = seed[0];
  float dist = INFINITY;
  for (int j = 0; j < RAYS; ++j) {
    const float o = ox[(long long)j * g_n + gs] + s;
    const float t1x = (lo_x - o) * 1.7f, t2x = (hi_x - o) * 1.7f;
    const float t1y = (lo_y - o) * 0.3f, t2y = (hi_y - o) * 0.3f;
    const float t1z = (lo_z - o) * 1.1f, t2z = (hi_z - o) * 1.1f;
    const float enter = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                              fminf(t1z, t2z));
    const float leave = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                              fmaxf(t1z, t2z));
    dist = fminf(dist, enter <= leave ? enter : INFINITY);
  }
  int arg = c;
  for (int off = CHILDREN / 2; off > 0; off >>= 1) {
    const float d2 = __shfl_sync(FULL, dist, c ^ off, CHILDREN);
    const int a2 = __shfl_sync(FULL, arg, c ^ off, CHILDREN);
    if (d2 < dist || (d2 == dist && a2 < arg)) {
      dist = d2;
      arg = a2;
    }
  }
  if (live && c == 0) out[g] = dist + (float)arg;
}

extern "C" int lum_slab_body(const void* tab, int rows, int cols,
                             const void* ox, const void* fetch,
                             const void* seed, int g_n, void* out,
                             void* stream) {
  if (cols < 96 || rows <= 0 || (fetch == nullptr && g_n > rows))
    return (int)cudaErrorInvalidValue;
  if (g_n > 0) {
    long long blocks = ((long long)g_n * CHILDREN + THREADS - 1) / THREADS;
    slab_body_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tab, rows, cols, (const float*)ox,
        (const int32_t*)fetch, (const float*)seed, g_n, (float*)out);
  }
  return (int)cudaGetLastError();
}
