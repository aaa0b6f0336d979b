// shading: the camera ray, the hit point, the shading frame, the BSDF's
// evaluation and its sample, each one kernel, rounded as the reference's
// compiled CPU code rounds them.
//
// Replaces no TPU kernel. XLA's CPU back end contracts each float32 product
// that has one use into the add or subtract that consumes it (a fused
// multiply-add, rounded once), and calls glibc's sinf / cosf; the port rounds
// those sites alike so that its renders part from the reference's no sooner
// than they must (ROADMAP.md queue 3). The plain versions are the port's
// PyTorch functions, with ops/vec.py fma32_plain for each contracted site:
//   lum_camera_ray      ops/camera.py _camera_ray_plain
//   lum_ray_point       ops/vec.py ray_point_plain
//   lum_make_frame      ops/material.py _make_frame_plain
//   lum_frame_eval      ops/material.py _frame_eval_plain
//   lum_material_sample ops/material.py _material_sample_plain
//   lum_stars           ops/sky.py _stars_radiance_plain (the lane's grid
//                       cell and its hash, the star and its glow)
// On the card a plain version is ~25-300 elementwise launches (about 1,000
// a tree-1080p sample in all); each kernel here is one. The code follows
// its plain version op for op: __fmaf_rn where the plain version calls
// fma32, everything else rounded op by op under -fmad=false, IEEE division
// and square root, glibc's sinf / cosf (glibc_sincosf.cuh), and PyTorch's
// clamp (NaN passes, a tie keeps the argument).
//
// Bound on an NVIDIA H100 80GB HBM3 at 700.00 W: bytes, each lane's
// operands read once and its results written once (4 B a float, 1 B a
// mask); the float work, ~30-400 operations a lane, is far below the rate.
// Design: one thread a lane, 256 a block. A lane operand is a pointer and a
// stride in elements (0 for a value shared by every lane); the entry points
// take arrays of them, so the wrappers pass views and broadcasts uncopied.

#include <cuda_runtime.h>
#include <math.h>

#include "glibc_sincosf.cuh"

#define MAX_IN 40
#define MAX_OUT 24
#ifndef THREADS
#define THREADS 256  // (the CPU emulation tests build it smaller)
#endif

struct Ins {
  const void* p[MAX_IN];
  long long s[MAX_IN];
  float c[8];  // host constants
};
struct Outs {
  void* p[MAX_OUT];
};

__device__ __forceinline__ float ld(const Ins& in, int k, long long i) {
  return ((const float*)in.p[k])[i * in.s[k]];
}
__device__ __forceinline__ bool ldb(const Ins& in, int k, long long i) {
  return ((const unsigned char*)in.p[k])[i * in.s[k]] != 0;
}
__device__ __forceinline__ int ldi(const Ins& in, int k, long long i) {
  return ((const int*)in.p[k])[i * in.s[k]];
}
__device__ __forceinline__ void st(const Outs& o, int k, long long i, float v) {
  ((float*)o.p[k])[i] = v;
}

struct V3 {
  float x, y, z;
};

// torch.clamp: a NaN passes, a tie keeps the argument
__device__ __forceinline__ float cmax(float a, float lo) { return a < lo ? lo : a; }
__device__ __forceinline__ float cmin(float a, float hi) { return hi < a ? hi : a; }
__device__ __forceinline__ float cl(float a, float lo, float hi) {
  return cmin(cmax(a, lo), hi);
}
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float rcp(float a) { return 1.0f / a; }

// ops/vec.py normalize_fused
__device__ __forceinline__ V3 normalize_fused(V3 v) {
  const float d = fma32(v.z, v.z, fma32(v.x, v.x, v.y * v.y));
  const float inv = rcp(cmax(sqrtf(cmax(d, 0.0f)), 1e-20f));
  return {v.x * inv, v.y * inv, v.z * inv};
}

// ops/vec.py dot (plain)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// ops/material.py _dot_fused
__device__ __forceinline__ float dot_fused(V3 a, V3 b) {
  return fma32(a.z, b.z, fma32(a.x, b.x, a.y * b.y));
}

// ops/material.py _reflect_fused
__device__ __forceinline__ V3 reflect_fused(V3 v, V3 n) {
  const float d = 2.0f * fma32(v.z, n.z, fma32(v.y, n.y, v.x * n.x));
  return {fma32(-d, n.x, v.x), fma32(-d, n.y, v.y), fma32(-d, n.z, v.z)};
}

#define F32_PI 3.14159265358979323846f
#define F32_2PI 6.28318530717958647692f
#define F32_INV_PI 0.318309886183790671538f
#define F32_THIRD 0.333333333333333333333f

// ---- ops/ggx.py ----

__device__ __forceinline__ float ggx_ndf(float alpha, float cos_h) {
  const float a2 = alpha * alpha;
  const float c2 = cos_h * cos_h;
  const float d = fma32(c2, a2 - 1.0f, 1.0f);
  return a2 / cmax((F32_PI * d) * d, 1e-12f);
}

__device__ __forceinline__ float smith_lambda(float alpha, float cos_t) {
  const float c2 = cl(cos_t * cos_t, 1e-8f, 1.0f);
  const float t2 = (1.0f - c2) / c2;
  return 0.5f * (sqrtf(fma32(alpha * alpha, t2, 1.0f)) - 1.0f);
}

__device__ __forceinline__ float smith_g1(float alpha, float cos_t) {
  return rcp(1.0f + smith_lambda(alpha, cos_t));
}

__device__ __forceinline__ float smith_g2(float alpha, float cos_o, float cos_i) {
  return rcp((1.0f + smith_lambda(alpha, cos_o)) + smith_lambda(alpha, cos_i));
}

__device__ __forceinline__ V3 sample_vndf_bounded(V3 wo, float alpha, float r0,
                                                  float r1) {
  const V3 wo_std = normalize_fused({wo.x * alpha, wo.y * alpha, wo.z});
  const float alpha_c = cmin(alpha, 1.0f);
  const float s = 1.0f + sqrtf(cmax(fma32(wo.x, wo.x, wo.y * wo.y), 0.0f));
  const float a2 = alpha_c * alpha_c;
  const float s2 = s * s;
  const float k = ((1.0f - a2) * s2) / fma32(a2 * wo.z, wo.z, s2);
  const float b = wo.z > 0.0f ? k * wo_std.z : wo_std.z;
  const float phi = F32_2PI * r0;
  const float z = fma32(1.0f - r1, 1.0f + b, -b);
  const float sin_t = sqrtf(cl(fma32(-z, z, 1.0f), 0.0f, 1.0f));
  const float cx = fma32(sin_t, glibc_sincosf(phi, 1), wo_std.x);
  const float cy = fma32(sin_t, glibc_sincosf(phi, 0), wo_std.y);
  const float cz = z + wo_std.z;
  return normalize_fused({cx * alpha, cy * alpha, cmax(cz, 0.0f)});
}

__device__ __forceinline__ V3 sample_vndf(V3 wo, float alpha, float r0, float r1) {
  const V3 v = normalize_fused({wo.x * alpha, wo.y * alpha, wo.z});
  const float lensq = fma32(v.x, v.x, v.y * v.y);
  // the plain version's rsqrt in float64: 1 / sqrt, each rounded once
  const float inv = (float)(1.0 / sqrt((double)cmax(lensq, 1e-20f)));
  const bool big = lensq > 1e-12f;
  const V3 t1 = {big ? -v.y * inv : 1.0f, big ? v.x * inv : 0.0f, 0.0f};
  const V3 t2 = {fma32(v.y, t1.z, -(v.z * t1.y)), fma32(v.z, t1.x, -(v.x * t1.z)),
                 fma32(v.x, t1.y, -(v.y * t1.x))};
  const float r = sqrtf(cl(r0, 0.0f, 1.0f));
  const float phi = F32_2PI * r1;
  const float p1 = r * glibc_sincosf(phi, 1);
  float p2 = r * glibc_sincosf(phi, 0);
  const float s = 0.5f * (1.0f + v.z);
  const float q = fma32(-p1, p1, 1.0f);
  p2 = fma32(1.0f - s, sqrtf(cmax(q, 0.0f)), s * p2);
  const float pz = sqrtf(cmax(fma32(-p2, p2, q), 0.0f));
  const V3 nh = {fma32(pz, v.x, fma32(p1, t1.x, p2 * t2.x)),
                 fma32(pz, v.y, fma32(p1, t1.y, p2 * t2.y)),
                 fma32(pz, v.z, fma32(p1, t1.z, p2 * t2.z))};
  return normalize_fused({nh.x * alpha, nh.y * alpha, cmax(nh.z, 1e-6f)});
}

// vndf_bounded_pdf with h = normalize_fused(wo + wi) given
__device__ __forceinline__ float vndf_bounded_pdf(V3 wo, V3 h, float alpha) {
  const float a2_ = alpha * alpha;
  const float d = fma32(h.z * h.z, a2_ - 1.0f, 1.0f);
  const float den = cmax((F32_PI * d) * d, 1e-12f);
  const float aix = alpha * wo.x;
  const float aiy = alpha * wo.y;
  const float len2 = fma32(aix, aix, aiy * aiy);
  const float t = sqrtf(fma32(wo.z, wo.z, len2));
  const float alpha_c = cmin(alpha, 1.0f);
  const float s = 1.0f + sqrtf(cmax(fma32(wo.x, wo.x, wo.y * wo.y), 0.0f));
  const float a2 = alpha_c * alpha_c;
  const float s2 = s * s;
  const float k = ((1.0f - a2) * s2) / fma32(a2 * wo.z, wo.z, s2);
  const float upper = a2_ / (den * (2.0f * fma32(k, wo.z, t)));
  const float lower = ((a2_ / den) * (t - wo.z)) / fma32(2.0f, len2, 1e-12f);
  return wo.z >= 0.0f ? upper : lower;
}

__device__ __forceinline__ float fresnel_schlick(float f0, float c) {
  const float m = cl(1.0f - c, 0.0f, 1.0f);
  const float m5 = ((m * m) * (m * m)) * m;
  return fma32(1.0f - f0, m5, f0);
}

__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = cl(cos_i, 0.0f, 1.0f);
  const float sin2_t = fma32(-cos_i, cos_i, 1.0f) / cmax(eta * eta, 1e-8f);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(cl(1.0f - sin2_t, 0.0f, 1.0f));
  const float rs = fma32(-eta, cos_t, cos_i) / cmax(fma32(eta, cos_t, cos_i), 1e-8f);
  const float rp = fma32(eta, cos_i, -cos_t) / cmax(fma32(eta, cos_i, cos_t), 1e-8f);
  const float f = 0.5f * fma32(rs, rs, rp * rp);
  return tir ? 1.0f : f;
}

#define LUT_RES 32
#define INV_098 0x1.053978p+0f  // float32(1) / float32(0.98)

// energy_compensation_gain, reading the quad rows [RES * RES, 4] itself
__device__ __forceinline__ float energy_gain(const float* quad, float cos_o,
                                             float roughness) {
  const float mu_i = cl((cos_o - 0.02f) * INV_098, 0.0f, 1.0f) * (float)(LUT_RES - 1);
  const float r_i = cl(roughness, 0.0f, 1.0f) * (float)(LUT_RES - 1);
  // float to int32 truncates; NaN (0 on the card, INT_MIN on a CPU) clamps
  // to 0 either way
  int i0 = isnan(mu_i) ? 0 : (int)mu_i;
  int j0 = isnan(r_i) ? 0 : (int)r_i;
  i0 = i0 < 0 ? 0 : (i0 > LUT_RES - 2 ? LUT_RES - 2 : i0);
  j0 = j0 < 0 ? 0 : (j0 > LUT_RES - 2 ? LUT_RES - 2 : j0);
  const float fi = mu_i - (float)i0;
  const float fj = r_i - (float)j0;
  const float* q = quad + 4 * (i0 * LUT_RES + j0);
  const float e = fma32(q[3] * fi, fj, fma32(q[2] * (1.0f - fi), fj,
                        fma32(q[1] * fi, 1.0f - fj,
                              (q[0] * (1.0f - fi)) * (1.0f - fj))));
  return (1.0f - e) / e;
}

// ---- ops/material.py ----

struct Frame {
  V3 t, b, n, wo_l;
  float alpha, f0[3], kd[3], p_spec;
};

// the frame's operands at k, k+1, ...: t, b, n, wo_l (3 each), alpha,
// f0 (3), kd (3), p_spec: 20 in all
#define FRAME_IN 20
__device__ __forceinline__ Frame ld_frame(const Ins& in, int k, long long i) {
  Frame f;
  f.t = {ld(in, k, i), ld(in, k + 1, i), ld(in, k + 2, i)};
  f.b = {ld(in, k + 3, i), ld(in, k + 4, i), ld(in, k + 5, i)};
  f.n = {ld(in, k + 6, i), ld(in, k + 7, i), ld(in, k + 8, i)};
  f.wo_l = {ld(in, k + 9, i), ld(in, k + 10, i), ld(in, k + 11, i)};
  f.alpha = ld(in, k + 12, i);
  for (int c = 0; c < 3; ++c) {
    f.f0[c] = ld(in, k + 13 + c, i);
    f.kd[c] = ld(in, k + 16 + c, i);
  }
  f.p_spec = ld(in, k + 19, i);
  return f;
}

// _opaque_eval: the GGX coat over Lambert, (r, g, b) value x cos and pdf
__device__ __forceinline__ void opaque_eval(const Frame& fr, const float* quad,
                                            V3 wi_l, float roughness, float f[3],
                                            float* pdf) {
  const V3 wo = fr.wo_l;
  const float cos_o = wo.z;
  const float cos_i = wi_l.z;
  const bool valid = (cos_o > 0.0f) && (cos_i > 0.0f);
  const V3 h = normalize_fused({wo.x + wi_l.x, wo.y + wi_l.y, wo.z + wi_l.z});
  const float cos_h = cl(h.z, 0.0f, 1.0f);
  const float cos_oh = cl(fma32(wo.z, h.z, fma32(wo.x, h.x, wo.y * h.y)), 0.0f, 1.0f);
  const float d = ggx_ndf(fr.alpha, cos_h);
  const float g2 = smith_g2(fr.alpha, cos_o, cos_i);
  const float base = (d * g2) / cmax(4.0f * cos_o, 1e-8f);
  const float f0_avg = ((fr.f0[0] + fr.f0[1]) + fr.f0[2]) * F32_THIRD;
  const float gain = energy_gain(quad, cos_o, roughness);
  const float comp = fma32(f0_avg, gain, 1.0f);
  const float scale = valid ? base * comp : 0.0f;
  const float pdf_spec = valid ? vndf_bounded_pdf(wo, h, fr.alpha) : 0.0f;
  // diffuse_eval
  const float w = cmax(wi_l.z, 0.0f) * F32_INV_PI;
  for (int c = 0; c < 3; ++c)
    f[c] = fma32(fr.kd[c], w, fresnel_schlick(fr.f0[c], cos_oh) * scale);
  *pdf = fma32(1.0f - fr.p_spec, w, fr.p_spec * pdf_spec);
}

// ---- kernels ----

// ins: px, py (int32), jx, jy, fov, object_distance, qw, qx, qy, qz,
// camera_scale, pos x, y, z, aperture x, y, z; c: width, height,
// 1 / CAMERA_COMMON_SCALE, CAMERA_COMMON_SCALE
// outs: origin x, y, z, direction x, y, z
__global__ void camera_ray_kernel(Ins in, Outs o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float jx = ld(in, 2, i), jy = ld(in, 3, i), fov = ld(in, 4, i);
  const float qw = ld(in, 6, i), qx = ld(in, 7, i), qy = ld(in, 8, i),
              qz = ld(in, 9, i);
  const V3 ap = {ld(in, 14, i), ld(in, 15, i), ld(in, 16, i)};
  const float step = (2.0f * fov) / in.c[0];
  const float vfov = (step * in.c[1]) * 0.5f;
  const float sx = fma32(-step, (float)ldi(in, 0, i) + jx, fov);
  const float sy = fma32(step, (float)ldi(in, 1, i) + jy, -vfov);
  const V3 to_focal = normalize_fused({-sx, -sy, -1.0f});
  const float focal_len = cmax(ld(in, 5, i) * in.c[2], 0.01f);
  const float scale = -focal_len / to_focal.z;
  V3 dir = normalize_fused({fma32(to_focal.x, scale, -ap.x),
                            fma32(to_focal.y, scale, -ap.y),
                            to_focal.z * scale - ap.z});
  // the origin: quaternion_apply_v, unfused
  {
    const V3 u = {qx, qy, qz};
    const float dot_uv = dot(u, ap);
    const float dot_uu = (qx * qx + qy * qy) + qz * qz;
    const V3 c = {qy * ap.z - qz * ap.y, qz * ap.x - qx * ap.z,
                  qx * ap.y - qy * ap.x};
    const float k1 = 2.0f * dot_uv, k2 = qw * qw - dot_uu, k3 = 2.0f * qw;
    const float s = ld(in, 10, i) * in.c[3];
    st(o, 0, i, ((u.x * k1 + ap.x * k2) + c.x * k3) * s + ld(in, 11, i));
    st(o, 1, i, ((u.y * k1 + ap.y * k2) + c.y * k3) * s + ld(in, 12, i));
    st(o, 2, i, ((u.z * k1 + ap.z * k2) + c.z * k3) * s + ld(in, 13, i));
  }
  // the direction: _rotate_fused
  const float dot_uv = fma32(qz, dir.z, fma32(qx, dir.x, qy * dir.y));
  const float k2 = fma32(qw, qw, -fma32(qz, qz, fma32(qx, qx, qy * qy)));
  const float k3 = 2.0f * qw;
  const V3 c = {fma32(qy, dir.z, -(qz * dir.y)), fma32(qz, dir.x, -(qx * dir.z)),
                fma32(qx, dir.y, -(qy * dir.x))};
  st(o, 3, i, fma32(k3, c.x, fma32(k2, dir.x, (2.0f * qx) * dot_uv)));
  st(o, 4, i, fma32(k3, c.y, fma32(k2, dir.y, (2.0f * qy) * dot_uv)));
  st(o, 5, i, fma32(k3, c.z, fma32(k2, dir.z, (2.0f * qz) * dot_uv)));
}

// ins: origin x, y, z, direction x, y, z, t; outs: point x, y, z
__global__ void ray_point_kernel(Ins in, Outs o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t = ld(in, 6, i);
  for (int c = 0; c < 3; ++c) st(o, c, i, fma32(ld(in, 3 + c, i), t, ld(in, c, i)));
}

// ins: ns x, y, z, wo x, y, z, albedo r, g, b, metallic, ior, roughness
// outs: t (3), b (3), wo_l (3), alpha, f0 (3), kd (3), p_spec
__global__ void make_frame_kernel(Ins in, Outs o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 ns = {ld(in, 0, i), ld(in, 1, i), ld(in, 2, i)};
  const V3 wo = {ld(in, 3, i), ld(in, 4, i), ld(in, 5, i)};
  const float alb[3] = {ld(in, 6, i), ld(in, 7, i), ld(in, 8, i)};
  const float metallic = ld(in, 9, i), ior = ld(in, 10, i);
  // _basis_fused
  const float s = ns.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -rcp(s + ns.z);
  const float b = (ns.x * ns.y) * a;
  const V3 t = {fma32((s * ns.x) * ns.x, a, 1.0f), s * b, -s * ns.x};
  const V3 bt = {b, fma32(ns.y * ns.y, a, s), -ns.y};
  const V3 wo_l = {dot_fused(wo, t), dot_fused(wo, bt), dot_fused(wo, ns)};
  // _f0_from_ior
  const float r = (ior - 1.0f) / (ior + 1.0f);
  const float f0d = r * r;
  const bool is_metal = metallic > 0.5f;
  const float km = 1.0f - metallic;
  float f0[3], kd[3];
  for (int c = 0; c < 3; ++c) {
    f0[c] = is_metal ? alb[c] : f0d;
    kd[c] = alb[c] * km;
  }
  const float cos_o = cl(wo_l.z, 0.0f, 1.0f);
  const float m = 1.0f - cos_o;
  const float m5 = ((m * m) * (m * m)) * m;
  const float f_avg = ((f0[0] + f0[1]) + f0[2]) * F32_THIRD;
  const float fres = fma32(1.0f - f_avg, m5, f_avg);
  const float kd_lum = ((kd[0] + kd[1]) + kd[2]) * F32_THIRD;
  const float p = fres / cmax(fma32(kd_lum, 1.0f - fres, fres), 1e-6f);
  const float p_spec = is_metal ? 1.0f : cl(p, 0.05f, 0.95f);
  // roughness_to_alpha
  const float rr = cmax(ld(in, 11, i), 0.025f);
  const float out[17] = {t.x, t.y, t.z, bt.x, bt.y, bt.z, wo_l.x, wo_l.y, wo_l.z,
                         rr * rr, f0[0], f0[1], f0[2], kd[0], kd[1], kd[2], p_spec};
  for (int k = 0; k < 17; ++k) st(o, k, i, out[k]);
}

// ins: translucent (mask), frame (FRAME_IN), roughness, wi x, y, z, quad
// outs: f r, g, b, pdf
__global__ void frame_eval_kernel(Ins in, Outs o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Frame fr = ld_frame(in, 1, i);
  const int k = 1 + FRAME_IN;
  const V3 wi = {ld(in, k + 1, i), ld(in, k + 2, i), ld(in, k + 3, i)};
  // _to_local, unfused
  const V3 wi_l = {dot(wi, fr.t), dot(wi, fr.b), dot(wi, fr.n)};
  float f[3], pdf;
  opaque_eval(fr, (const float*)in.p[k + 4], wi_l, ld(in, k, i), f, &pdf);
  const bool live = !ldb(in, 0, i);
  for (int c = 0; c < 3; ++c) st(o, c, i, live ? f[c] : 0.0f);
  st(o, 3, i, live ? pdf : 0.0f);
}

// ins: r_choice, r2 x, r2 y, frame (FRAME_IN), roughness, albedo r, g, b,
// translucent, thin_walled (masks), eta, quad
// outs: wi x, y, z, weight r, g, b, pdf, transmitted (mask)
__global__ void material_sample_kernel(Ins in, Outs o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float r_choice = ld(in, 0, i), r0 = ld(in, 1, i), r1 = ld(in, 2, i);
  const Frame fr = ld_frame(in, 3, i);
  const int k = 3 + FRAME_IN;
  const float roughness = ld(in, k, i);
  const float alb[3] = {ld(in, k + 1, i), ld(in, k + 2, i), ld(in, k + 3, i)};
  const bool translucent = ldb(in, k + 4, i), thin = ldb(in, k + 5, i);
  const float eta = ld(in, k + 6, i);
  const float* quad = (const float*)in.p[k + 7];
  const V3 wo_l = fr.wo_l;
  const V3 mwo = {-wo_l.x, -wo_l.y, -wo_l.z};

  // opaque: specular or diffuse
  const bool choose_spec = r_choice < fr.p_spec;
  const V3 h = sample_vndf_bounded(wo_l, fr.alpha, r0, r1);
  const V3 wi_spec = reflect_fused(mwo, h);
  const float phi = F32_2PI * r0;
  const float sr = sqrtf(cl(r1, 0.0f, 1.0f));
  const V3 wi_diff = {glibc_sincosf(phi, 1) * sr, glibc_sincosf(phi, 0) * sr,
                      sqrtf(cmax(1.0f - r1, 0.0f))};
  V3 wi_l = choose_spec ? wi_spec : wi_diff;
  float f[3], pdf;
  opaque_eval(fr, quad, wi_l, roughness, f, &pdf);
  const bool ok = (wi_l.z > 0.0f) && (pdf > 1e-10f);
  const float inv_pdf = ok ? rcp(cmax(pdf, 1e-10f)) : 0.0f;

  // translucent: rough dielectric
  const V3 ht = sample_vndf(wo_l, fr.alpha, r0, r1);
  const float cos_oh = cl(dot_fused(wo_l, ht), 1e-6f, 1.0f);
  float fres = fresnel_dielectric(cos_oh, eta);
  if (thin) fres = (2.0f * fres) / (1.0f + fres);
  bool choose_reflect = r_choice < fres;
  const V3 wi_refl = reflect_fused(mwo, ht);
  const float inv_eta = rcp(cmax(eta, 1e-6f));
  const float sin2_t = (inv_eta * inv_eta) * cmax(fma32(-cos_oh, cos_oh, 1.0f), 0.0f);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(cl(1.0f - sin2_t, 0.0f, 1.0f));
  const float bend = fma32(inv_eta, cos_oh, -cos_t);
  V3 wi_refr = {fma32(mwo.x, inv_eta, bend * ht.x), fma32(mwo.y, inv_eta, bend * ht.y),
                fma32(mwo.z, inv_eta, bend * ht.z)};
  if (thin) wi_refr = mwo;
  choose_reflect = choose_reflect || (tir && !thin);
  const V3 wi_trans = choose_reflect ? wi_refl : wi_refr;
  const float g_ratio = smith_g2(fr.alpha, fabsf(wo_l.z), fabsf(wi_trans.z)) /
                        cmax(smith_g1(fr.alpha, fabsf(wo_l.z)), 1e-6f);

  float weight[3];
  for (int c = 0; c < 3; ++c)
    weight[c] = translucent ? (choose_reflect ? g_ratio : alb[c] * g_ratio)
                            : f[c] * inv_pdf;
  if (translucent) wi_l = wi_trans;
  const float wl2 = (wi_l.x * wi_l.x + wi_l.y * wi_l.y) + wi_l.z * wi_l.z;
  if (wl2 < 1e-16f) wi_l = {0.0f, 0.0f, 1.0f};
  const V3 v = normalize_fused(wi_l);
  // _to_world_fused
  st(o, 0, i, fma32(fr.n.x, v.z, fma32(fr.t.x, v.x, fr.b.x * v.y)));
  st(o, 1, i, fma32(fr.n.y, v.z, fma32(fr.t.y, v.x, fr.b.y * v.y)));
  st(o, 2, i, fma32(fr.n.z, v.z, fma32(fr.t.z, v.x, fr.b.z * v.y)));
  for (int c = 0; c < 3; ++c) st(o, 3 + c, i, weight[c]);
  st(o, 6, i, translucent ? 0.0f : pdf);
  ((unsigned char*)o.p[7])[i] = translucent && !choose_reflect && !thin;
}

template <class K>
static int launch(K kernel, const void* const* ptrs, const long long* strides,
                  int n_in, const float* consts, int n_const, void* const* outs,
                  int n_out, long long n, void* stream) {
  if (n_in > MAX_IN || n_out > MAX_OUT || n_const > 8) return -1;
  if (n <= 0) return 0;
  Ins in;
  Outs o;
  for (int k = 0; k < n_in; ++k) {
    in.p[k] = ptrs[k];
    in.s[k] = strides[k];
  }
  for (int k = 0; k < n_const; ++k) in.c[k] = consts[k];
  for (int k = 0; k < n_out; ++k) o.p[k] = outs[k];
  const long long blocks = (n + THREADS - 1) / THREADS;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(in, o, n);
  return (int)cudaGetLastError();
}

// ---- ops/sky.py ----

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float hash01(uint32_t x) {
  return (float)hash_u32(x) * 0x1p-32f;
}

// ops/sky.py _star_cell, in its order: u and v from CUDA's atan2f and acosf
// (ATen's atan2 and arccos on the card call the same functions, whose bits
// do not depend on -fmad), each scaled by the float32 rounding of PyTorch's
// scalar operand, float32(0.5 / pi) = 0x1.45f306p-3 and float32(1 / pi) =
// 0x1.45f306p-2; the cell's index truncated toward zero (as .to(int32)) and
// clamped; its hash of cell * 0x9E3779B9 + seed, wrapping in 32 bits
__device__ __forceinline__ uint32_t star_cell(const V3& d, uint32_t seed, int& gx,
                                              int& gy) {
  const float u = atan2f(d.z, d.x) * 0x1.45f306p-3f + 0.5f;
  const float v = acosf(cl(d.y, -1.0f, 1.0f)) * 0x1.45f306p-2f;
  gx = min(max((int)(u * 64.0f), 0), 63);
  gy = min(max((int)(v * 64.0f), 0), 63);
  return hash_u32((uint32_t)(gy * 64 + gx) * 0x9E3779B9u + seed);
}

// _stars_radiance_plain: in dx, dy, dz, the intensity (a broadcast scalar);
// c[0] the probability of a star in a cell, c[1] 1 for the fused dot (else op
// by op), c[2] and c[3] the low and high 16 bits of the seed; out r, g, b
__global__ void stars_kernel(Ins in, Outs o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 d = {ld(in, 0, i), ld(in, 1, i), ld(in, 2, i)};
  const float intensity = ld(in, 3, i);
  const uint32_t seed = (uint32_t)in.c[2] | ((uint32_t)in.c[3] << 16);
  int gx, gy;
  const uint32_t h0 = star_cell(d, seed, gx, gy);
  const bool present = hash01(h0) < in.c[0];
  const float su = ((float)gx + hash01(h0 + 1u)) / 64.0f;
  const float sv = ((float)gy + hash01(h0 + 2u)) / 64.0f;
  const float phi = (su - 0.5f) * F32_2PI;
  const float theta = sv * F32_PI;
  const float sin_t = glibc_sincosf(theta, 0);
  const V3 sd = {glibc_sincosf(phi, 1) * sin_t, glibc_sincosf(theta, 1),
                 glibc_sincosf(phi, 0) * sin_t};
  const float cos_d = cl(in.c[1] != 0.0f ? fma32(d.z, sd.z, fma32(d.y, sd.y, d.x * sd.x))
                                         : dot(d, sd),
                         -1.0f, 1.0f);
  const float ang = sqrtf(cmax(2.0f * (1.0f - cos_d), 0.0f));
  const float radius = 3e-4f * (0.5f + hash01(h0 + 3u));
  const float glow = expf(-(ang * ang) / cmax((2.0f * radius) * radius, 1e-12f));
  const float h4 = hash01(h0 + 4u);
  const float h4sq = h4 * h4;
  const float brightness = (0.2f + 0.8f * (h4sq * h4sq)) * intensity;
  const float v = present ? glow * brightness : 0.0f;
  const float warm = hash01(h0 + 5u);
  st(o, 0, i, v * (0.8f + 0.4f * warm));
  st(o, 1, i, v);
  st(o, 2, i, v * (1.2f - 0.4f * warm));
}

#define ENTRY(name)                                                            \
  extern "C" int lum_##name(const void* const* ptrs, const long long* strides, \
                            int n_in, const float* consts, int n_const,        \
                            void* const* outs, int n_out, long long n,         \
                            void* stream) {                                    \
    return launch(name##_kernel, ptrs, strides, n_in, consts, n_const, outs,   \
                  n_out, n, stream);                                           \
  }

ENTRY(camera_ray)
ENTRY(ray_point)
ENTRY(make_frame)
ENTRY(frame_eval)
ENTRY(material_sample)
ENTRY(stars)
