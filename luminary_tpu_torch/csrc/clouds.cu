// clouds: the cloud march of one layer and the cloud shadows, one thread a
// lane, with the value-noise density evaluated in registers.
//
// Replaces no TPU kernel. It is the redesign of csrc/libm_sincos.cu (glibc's
// sinf, there one launch over every hashed corner) together with the hash's
// csrc/fma32.cu sites: the march of luminary_tpu_torch/ops/clouds.py ran as
// stacked elementwise launches, several hundred a density evaluation, each
// writing its intermediate to device memory and reading it back. Here one
// thread walks a lane's whole march (every step, and every shadow step of a
// step with density), and the 72 corner hashes of a density evaluation (9
// octaves of 8 corners) never leave registers. The plain versions, which
// the kernels equal bit for bit:
//   lum_cloud_march   ops/clouds.py _march_one_layer (one layer, and its
//                     compositing into the running totals of cloud_march)
//   lum_cloud_shadow  ops/clouds.py _cloud_sun_transmittance_plain
// The code follows them op for op: __fmaf_rn where the plain hash calls
// fma32 (the step's density, with the flat rule where the lattice y is 0),
// every other product and sum rounded alone under -fmad=false, IEEE
// division where the plain version takes sdiv, glibc's sinf
// (glibc_sincosf.cuh), torch.remainder as fmod plus the divisor for a
// negative remainder, torch.clamp (a NaN passes), and the plain version's
// order of every sum and lerp. The per-lane setup of a march (the layer's
// span, the step length, the phase, the lanes that cross the layer) stays
// in PyTorch and is handed in, so the kernel takes exactly the plain
// version's inputs.
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W: operations. A density
// evaluation is 72 glibc sines (13 float64 flops each, an FMA counted as 2)
// and ~1,530 float32 flops: 27.5 ps at 34 TFLOP/s fp64 against 23 ps at 67
// TFLOP/s fp32, so the bound is the density evaluations the lanes need times
// the fp64 time; the bytes (~90 B a lane) are far below it. Design: no
// intermediate in device memory, one launch a layer (the march) or a call
// (the shadows, every layer in the thread), 128 threads a block; the march
// takes only the lanes that cross the layer, so no thread of a warp idles
// on a dead lane. Fusing the layers into one launch, or spreading a lane's
// steps over a warp, is later work.

#include <cuda_runtime.h>
#include <math.h>

#include "glibc_sincosf.cuh"

#ifndef THREADS
#define THREADS 128  // (the CPU emulation tests build it smaller)
#endif
#define MAX_SHADOW 8
#define SIGMA 0.004f

// ops/clouds.py DeviceClouds as float32; the noise scales are the products
// the plain version forms on the host (0.0004, 0.0015 and 0.009 times the
// scene's scales), height_span is max(height_max - height_min, 1e-3)
struct Clouds {
  float height_min[3], height_max[3], height_span[3];
  float coverage[3], coverage_min[3];
  float density, offset_x, offset_z, seed;
  float weather_scale, shape_scale, detail_scale;
};

// torch.clamp: a NaN passes, a tie keeps the argument
__device__ __forceinline__ float cmax(float a, float lo) { return a < lo ? lo : a; }
__device__ __forceinline__ float cmin(float a, float hi) { return hi < a ? hi : a; }
__device__ __forceinline__ float cl01(float a) { return cmin(cmax(a, 0.0f), 1.0f); }
// torch.minimum / torch.maximum: a NaN wins
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// _hash3: fract(sin(h) * 43758.5453) of h = px 127.1 + py 311.7 + pz 74.7,
// fused as the compiled reference's march step rounds it (FUSED), with the
// y term folded away where the lattice y is the constant 0 (FLAT)
template <bool FUSED, bool FLAT>
__device__ __forceinline__ float hash3(float px, float py, float pz) {
  float h;
  if (FUSED) {
    h = __fmaf_rn(pz, 74.7f, __fmaf_rn(px, 127.1f, py * 311.7f));
    if (FLAT && py == 0.0f) h = __fmaf_rn(px, 127.1f, pz * 74.7f);
  } else {
    h = (px * 127.1f + py * 311.7f) + pz * 74.7f;
  }
  const float s = glibc_sincosf(h, 0) * 43758.5453f;
  // torch.remainder(s, 1): fmod, plus the divisor where it is negative
  float m = fmodf(s, 1.0f);
  if (m != 0.0f && m < 0.0f) m = m + 1.0f;
  return fabsf(m);
}

// value_noise3: trilinear value noise, the corners in the plain order
template <bool FUSED, bool FLAT>
__device__ __forceinline__ float value_noise3(float x, float y, float z) {
  const float ix = floorf(x), iy = floorf(y), iz = floorf(z);
  const float fx = x - ix, fy = y - iy, fz = z - iz;
  const float wx = (fx * fx) * (3.0f - 2.0f * fx);
  const float wy = (fy * fy) * (3.0f - 2.0f * fy);
  const float wz = (fz * fz) * (3.0f - 2.0f * fz);
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    c[k] = hash3<FUSED, FLAT>(ix + (float)(k & 1), iy + (float)((k >> 1) & 1),
                              iz + (float)(k >> 2));
  const float x00 = c[0] + (c[1] - c[0]) * wx;
  const float x10 = c[2] + (c[3] - c[2]) * wx;
  const float x01 = c[4] + (c[5] - c[4]) * wx;
  const float x11 = c[6] + (c[7] - c[6]) * wx;
  const float y0 = x00 + (x10 - x00) * wy;
  const float y1 = x01 + (x11 - x01) * wy;
  return y0 + (y1 - y0) * wz;
}

// fbm3 over OCTAVES octaves; FLAT: y is the constant 0 (the weather FBM),
// which folds the hash's y term in the first octave
template <int OCTAVES, bool FUSED, bool FLAT>
__device__ __forceinline__ float fbm3(float x, float y, float z) {
  float total = 0.0f, amp = 0.5f;
  double norm = 0.0;
#pragma unroll
  for (int o = 0; o < OCTAVES; ++o) {
    const float s = (float)(1 << o), b = (float)(17.31 * o);
    const float v = amp * (o == 0 ? value_noise3<FUSED, FLAT>(x * s + b, y * s + b,
                                                             z * s + b)
                                   : value_noise3<FUSED, false>(x * s + b, y * s + b,
                                                                z * s + b));
    total = o == 0 ? v : total + v;
    norm += amp;
    amp *= 0.5f;
  }
  return total / (float)norm;
}

// cloud_density: the coverage, height-gradient and erosion stack of three
// FBMs at one position in layer `layer`
template <bool FUSED>
__device__ float cloud_density(const Clouds& cl, int layer, float x, float y,
                               float z) {
  const float h01 = cl01((y - cl.height_min[layer]) / cl.height_span[layer]);
  const float grad = cl01(h01 * 4.0f) * cl01((1.0f - h01) * 2.5f);
  const float px = x + cl.offset_x, py = y + cl.seed, pz = z + cl.offset_z;
  const float ws = cl.weather_scale, ss = cl.shape_scale, ds = cl.detail_scale;
  const float weather = fbm3<3, FUSED, true>(px * ws, 0.0f, pz * ws);
  const float base = fbm3<4, FUSED, false>(px * ss, py * ss, pz * ss);
  const float detail = fbm3<2, FUSED, false>(px * ds, py * ds, pz * ds);
  const float coverage =
      cmin(cmax(weather * cl.coverage[layer], cl.coverage_min[layer]), 2.0f);
  float d = (base * grad) * coverage - 0.55f;
  d = d - detail * 0.15f;
  return cl01(d * 4.0f) * cl.density;
}

// a lane operand: a pointer and a stride in elements (0: shared by all lanes)
struct Ins {
  const void* p[20];
  long long s[20];
};
__device__ __forceinline__ float ld(const Ins& in, int k, long long i) {
  return ((const float*)in.p[k])[i * in.s[k]];
}

// march operands, in the wrapper's order
enum { M_IDX, M_OX, M_OY, M_OZ, M_DX, M_DY, M_DZ, M_T0, M_DT, M_PHASE, M_AR,
       M_AG, M_AB, M_SX, M_SY, M_SZ, M_RR, M_RG, M_RB, M_N };

struct March {
  int layer, steps, shadow_steps;
  float c_sh;               // shadow_len / shadow_steps
  float offs[MAX_SHADOW];   // the shadow steps' offsets along the sun
};

// one thread a crossing lane: _march_one_layer, then its compositing into
// the totals of cloud_march (out: r, g, b, transmittance, at lane idx[j])
__global__ void __launch_bounds__(THREADS)
cloud_march_kernel(Clouds cl, March m, Ins in, float* __restrict__ tot_r,
                   float* __restrict__ tot_g, float* __restrict__ tot_b,
                   float* __restrict__ tot_t, long long n) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long long i = ((const long long*)in.p[M_IDX])[j];
  const float ox = ld(in, M_OX, i), oy = ld(in, M_OY, i), oz = ld(in, M_OZ, i);
  const float dx = ld(in, M_DX, i), dy = ld(in, M_DY, i), dz = ld(in, M_DZ, i);
  const float t0 = ld(in, M_T0, i), dt = ld(in, M_DT, i);
  const float phase = ld(in, M_PHASE, i);
  const float ar = ld(in, M_AR, i), ag = ld(in, M_AG, i), ab = ld(in, M_AB, i);
  const float sx = ld(in, M_SX, i), sy = ld(in, M_SY, i), sz = ld(in, M_SZ, i);
  const float rr = ld(in, M_RR, i), rg = ld(in, M_RG, i), rb = ld(in, M_RB, i);
  float lr = 0.0f, lg = 0.0f, lb = 0.0f, tr = 1.0f;
  for (int s = 0; s < m.steps; ++s) {
    const float t = __fmaf_rn((float)s + 0.5f, dt, t0);
    const float x = __fmaf_rn(dx, t, ox), y = __fmaf_rn(dy, t, oy),
                z = __fmaf_rn(dz, t, oz);
    const float dens = cloud_density<true>(cl, m.layer, x, y, z);
    float tau = 0.0f;
    if (dens > 0.0f)
      for (int k = 0; k < m.shadow_steps; ++k)
        tau = tau + cloud_density<false>(cl, m.layer, x + sx * m.offs[k],
                                         y + sy * m.offs[k], z + sz * m.offs[k]);
    const float ext = (dens * SIGMA) * dt;
    const float sun_t = expf((-tau * SIGMA) * m.c_sh);
    const float powder = 1.0f - expf(-dens * 2.0f);
    const float lit = (phase * sun_t) * powder;
    const float w = tr * ext;
    lr = lr + (rr * lit + ar * 0.3f) * w;
    lg = lg + (rg * lit + ag * 0.3f) * w;
    lb = lb + (rb * lit + ab * 0.3f) * w;
    tr = tr * expf(-ext);
  }
  const float tt = tot_t[i];
  tot_r[i] = tot_r[i] + tt * lr;
  tot_g[i] = tot_g[i] + tt * lg;
  tot_b[i] = tot_b[i] + tt * lb;
  tot_t[i] = tt * tr;
}

// shadow operands
enum { S_PX, S_PY, S_PZ, S_SX, S_SY, S_SZ, S_N };

struct Shadow {
  int layers[3], n_layers, steps;
};

// one thread a point: the sun transmittance through the layers, each a
// fixed-step density march along the sun (_cloud_sun_transmittance_plain)
__global__ void __launch_bounds__(THREADS)
cloud_shadow_kernel(Clouds cl, Shadow sh, Ins in, float* __restrict__ out,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = ld(in, S_PX, i), py = ld(in, S_PY, i), pz = ld(in, S_PZ, i);
  const float sx = ld(in, S_SX, i), sy = ld(in, S_SY, i), sz = ld(in, S_SZ, i);
  float trans = 1.0f;
  for (int l = 0; l < sh.n_layers; ++l) {
    const int layer = sh.layers[l];
    // _layer_span
    const float dy = fabsf(sy) < 1e-7f ? 1e-7f : sy;
    const float t_lo = (cl.height_min[layer] - py) / dy;
    const float t_hi = (cl.height_max[layer] - py) / dy;
    const float t0 = cmax(tmin(t_lo, t_hi), 0.0f);
    const float t1 = tmax(tmax(t_lo, t_hi), t0);
    const float dt = cmax(t1 - t0, 0.0f) / (float)sh.steps;
    float tau = 0.0f;
    for (int s = 0; s < sh.steps; ++s) {
      const float t = t0 + ((float)s + 0.5f) * dt;
      tau = tau + cloud_density<false>(cl, layer, px + sx * t, py + sy * t,
                                       pz + sz * t);
    }
    trans = trans * expf((-tau * SIGMA) * dt);
  }
  out[i] = trans;
}

static Ins ins_of(const void* const* ptrs, const long long* strides, int n) {
  Ins in = {};
  for (int k = 0; k < n && k < 20; ++k) {
    in.p[k] = ptrs[k];
    in.s[k] = strides[k];
  }
  return in;
}

// the march of one layer over n crossing lanes; ptrs / strides: the M_*
// operands (M_IDX an int64 array of the lanes); tot: r, g, b, transmittance
extern "C" int lum_cloud_march(const Clouds* cl, int layer, int steps,
                               int shadow_steps, const float* offs, float c_sh,
                               const void* const* ptrs, const long long* strides,
                               int n_ptrs, void* const* tot, long long n,
                               void* stream) {
  if (n_ptrs != M_N || shadow_steps < 0 || shadow_steps > MAX_SHADOW ||
      layer < 0 || layer > 2)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  March m = {};
  m.layer = layer;
  m.steps = steps;
  m.shadow_steps = shadow_steps;
  m.c_sh = c_sh;
  for (int k = 0; k < shadow_steps; ++k) m.offs[k] = offs[k];
  const long long blocks = (n + THREADS - 1) / THREADS;
  cloud_march_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *cl, m, ins_of(ptrs, strides, n_ptrs), (float*)tot[0], (float*)tot[1],
      (float*)tot[2], (float*)tot[3], n);
  return (int)cudaGetLastError();
}

// the cloud shadows of n points through `n_layers` layers
extern "C" int lum_cloud_shadow(const Clouds* cl, const int* layers, int n_layers,
                                int steps, const void* const* ptrs,
                                const long long* strides, int n_ptrs, void* out,
                                long long n, void* stream) {
  if (n_ptrs != S_N || n_layers < 0 || n_layers > 3) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Shadow sh = {};
  for (int l = 0; l < n_layers; ++l) {
    if (layers[l] < 0 || layers[l] > 2) return (int)cudaErrorInvalidValue;
    sh.layers[l] = layers[l];
  }
  sh.n_layers = n_layers;
  sh.steps = steps;
  const long long blocks = (n + THREADS - 1) / THREADS;
  cloud_shadow_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *cl, sh, ins_of(ptrs, strides, n_ptrs), (float*)out, n);
  return (int)cudaGetLastError();
}
