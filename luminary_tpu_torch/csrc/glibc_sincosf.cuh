// glibc_sincosf.cuh: glibc's float32 sinf / cosf as a device function,
// shared by csrc/libm_sincos.cu and csrc/shading.cu. glibc's algorithm as
// written (sysdeps/ieee754/flt-32 s_sinf.c, s_cosf.c, sincosf.h): the
// argument reduced by pi/2 with one multiply-subtract below 120, else by an
// integer multiply against 4/pi's bits; a polynomial in double with glibc's
// coefficients; its fused multiply-adds where the FMA build contracts them
// (fma() here, everything else rounded op by op under -fmad=false). Its
// plain version is luminary_tpu_torch/ops/libm.py glibc_exact.

#pragma once
#include <stdint.h>
#include <string.h>

// c0, c1, s1, c2, s2, c3, s3, c4 of glibc's __sincosf_table; the second row
// negates the cosine's coefficients
__device__ const double SINCOS_T[2][8] = {
    {0x1p0, -0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, 0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, -0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     0x1.99343027bf8c3p-16},
    {-0x1p0, 0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, -0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, 0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     -0x1.99343027bf8c3p-16},
};
// 4 / pi in a sliding window of 32-bit words (glibc's __inv_pio4)
__device__ const uint32_t INV_PIO4[24] = {
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

__device__ __forceinline__ uint32_t as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

__device__ __forceinline__ float as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

__device__ __forceinline__ uint32_t abstop12(float x) {
  return (as_uint(x) >> 20) & 0x7ff;
}

// sinf_poly: the sine (n even) or the cosine (n odd) of x in [-pi/4, pi/4]
__device__ __forceinline__ float sincos_poly(double x, double x2,
                                             const double* p, int n) {
  if ((n & 1) == 0) {
    const double x3 = x * x2;
    const double s1 = fma(x2, p[6], p[4]);
    const double x7 = x3 * x2;
    const double s = fma(x3, p[2], x);
    return (float)fma(x7, s1, s);
  }
  const double x4 = x2 * x2;
  const double c2 = fma(x2, p[7], p[5]);
  const double c1 = fma(x2, p[1], p[0]);
  const double x6 = x4 * x2;
  const double c = fma(x4, p[3], c1);
  return (float)fma(x6, c2, c);
}

// reduce_large: |y| mod pi/2 from the bits of 4/pi; the quadrant in *np
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &INV_PIO4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = xi * arr[0];
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return (double)(int64_t)res0 * 0x1.921fb54442d18p-62;
}

__device__ float glibc_sincosf(float y, int want_cos) {
  double x = y;
  int n = 0;
  if (abstop12(y) < abstop12(0x1.921fb6p-1f)) {  // pi / 4
    if (abstop12(y) < abstop12(0x1p-12f)) return want_cos ? 1.0f : y;
    return sincos_poly(x, x * x, SINCOS_T[0], want_cos);
  }
  int q;
  if (abstop12(y) < abstop12(120.0f)) {
    // hpi_inv is prescaled by 2^24: the quadrant lands in bits 24..31
    const double r = x * 0x1.45f306dc9c883p+23;
    n = ((int32_t)r + 0x800000) >> 24;
    x = fma(-(double)n, 0x1.921fb54442d18p+0, x);
    q = n;
  } else if (abstop12(y) < abstop12(as_float(0x7f800000))) {  // finite
    const uint32_t xi = as_uint(y);
    x = reduce_large(xi, &n);
    q = n + (int)(xi >> 31);
  } else {
    return as_float(0x7fc00000);
  }
  const double s = ((q & 3) == 1 || (q & 3) == 2) ? -1.0 : 1.0;
  return sincos_poly(x * s, x * x, SINCOS_T[(q >> 1) & 1], n ^ want_cos);
}
