"""Kernels B and C's CUDA sources (``luminary_tpu_torch/csrc``) run on the CPU:
kernel B against the JAX package's walk and brute force, kernel C against
its plain PyTorch version.

The sources are compiled for the host by g++ against a small emulation of the
CUDA built-ins they use (``_EMU`` below). The lanes of one warp group -- a
32-ray packet of kernel B, the 4 lanes of one shading point of kernel C --
run as threads that meet at every warp collective (ballot, vote, shuffle,
min/max reduce), so the kernels' own code, lane layout and packet bookkeeping
included, runs here. Kernels whose blocks are wider than a warp (kernel E)
run through ``emu_launch``: a block's threads are one group that meets at
``__syncthreads``, its dynamic shared memory is a buffer of the launch's
size, and ``cp.async`` is a plain copy, complete when it is issued. It does
not stand in for the card: what nvcc makes of the sources, and the card's
arithmetic, are checked by ``chip_smoke.py``.

Tolerances: kernel B's rules are those ``chip_smoke.py`` holds it to (see the
test); g++ is told not to contract multiply-adds, as nvcc is by
``-fmad=false``, so its float32 arithmetic is the port's ``ray_triangle``.
Kernel C's picks are equal and its pdf lies within rtol 1e-5 of the plain
version, the tolerance of ``tests/test_torch_light_tree.py``: the host's
square root, division and f16 decoding may round a child weight otherwise
than PyTorch's CPU kernels in the last place.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminary_tpu.ops.traverse import _traverse_wide as j_traverse_wide
from luminary_tpu_torch.ops import light_tree as LT
from luminary_tpu_torch.ops.intersect import ray_triangle
from luminary_tpu_torch.ops.rowops import unplanar_plain
from luminary_tpu_torch.ops.vec import Vec3

from test_torch_light_tree import _random_lights
from test_torch_traverse import (_edge_lanes, _grazing_rays, _jv,  # noqa: F401
                                 _tie_lanes, _tv, scene600)

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "luminary_tpu_torch", "csrc")

_EMU = r"""
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x; };
thread_local dim3 threadIdx, blockIdx;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
using std::min;
using std::max;

// the lanes of one warp group, each a thread; a collective is two barriers
struct Group {
  std::mutex m;
  std::condition_variable cv;
  int size, count = 0, gen = 0;
  unsigned long long vals[32];
  void wait() {
    std::unique_lock<std::mutex> l(m);
    int g = gen;
    if (++count == size) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return g != gen; });
  }
};
thread_local Group* tl_group;
thread_local int tl_lane;  // lane within the group
template <class F> unsigned long long collective(unsigned long long v, F f) {
  tl_group->vals[tl_lane] = v;
  tl_group->wait();
  unsigned long long r = f(tl_group->vals, tl_group->size);
  tl_group->wait();
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  unsigned long long bits = 0;
  memcpy(&bits, &v, sizeof(T));
  unsigned long long r = collective(bits, [&](unsigned long long* a, int) {
    return a[(tl_lane / width) * width + src % width]; });
  T out;
  memcpy(&out, &r, sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  unsigned long long b = collective(p, [](unsigned long long* a, int n) {
    unsigned long long r = 0;
    for (int k = 0; k < n; ++k) r |= (a[k] ? 1ull : 0ull) << k;
    return r; });
  return (unsigned)(b << ((threadIdx.x & 31) - tl_lane));
}
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return (unsigned)collective(v, [](unsigned long long* a, int n) {
    unsigned long long r = a[0];
    for (int k = 1; k < n; ++k) r = std::min(r, a[k]);
    return r; });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return (unsigned)collective(v, [](unsigned long long* a, int n) {
    unsigned long long r = 0;
    for (int k = 0; k < n; ++k) r += a[k];
    return r; });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return (unsigned)collective(v, [](unsigned long long* a, int n) {
    unsigned long long r = a[0];
    for (int k = 1; k < n; ++k) r = std::max(r, a[k]);
    return r; });
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4); return i; }
inline float __uint_as_float(unsigned i) { float f; memcpy(&f, &i, 4); return f; }
std::mutex g_atomic;
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  std::lock_guard<std::mutex> l(g_atomic);
  return *a += v;
}
struct __half { unsigned short s; };
inline __half __ushort_as_half(unsigned short s) { return {s}; }
inline float __half2float(__half h) {
  int e = (h.s >> 10) & 31, m = h.s & 1023;
  float v = e == 0 ? std::ldexp((float)m, -24)
          : e == 31 ? (m ? NAN : INFINITY)
          : std::ldexp((float)(m | 1024), e - 25);
  return (h.s >> 15) ? -v : v;
}
int2 emu_smem[1 << 16];

// every block, and in it every group of `size` lanes, one after another:
// `size` threads run the groups in turn and meet after each
template <class F> void run_groups(long long blocks, int threads, int size, F body) {
  Group grp;
  grp.size = size;
  std::vector<std::thread> lanes;
  for (int j = 0; j < size; ++j)
    lanes.emplace_back([&, j] {
      tl_group = &grp;
      tl_lane = j;
      for (long long b = 0; b < blocks; ++b)
        for (int g = 0; g < threads / size; ++g) {
          blockIdx.x = (unsigned)b;
          threadIdx.x = (unsigned)(g * size + j);
          body();
          grp.wait();
        }
    });
  for (auto& t : lanes) t.join();
}

// a whole block's barrier, for launches whose group is the block
inline void __syncthreads() { tl_group->wait(); }

// a launch run by emu_launch: its blocks one after another, each block's
// threads as one group, its dynamic shared memory in emu_dyn_smem
std::vector<float4> emu_dyn;
void* emu_dyn_smem;
dim3 blockDim;
template <class F>
void emu_launch(long long grid, int block, size_t smem, cudaStream_t, F body) {
  emu_dyn.assign(smem / sizeof(float4) + 1, float4{});
  emu_dyn_smem = emu_dyn.data();
  blockDim.x = (unsigned)block;
  run_groups(grid, block, block, body);
}
#ifndef EMU_SMEM_OPTIN
#define EMU_SMEM_OPTIN 232448
#endif
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMEM_OPTIN;
  return 0;
}
template <class T> int cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
// cp.async: a plain copy, done when it is issued
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) { memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline void __pipeline_wait_prior(size_t) {}
"""

_TRAVERSE_ENTRY = r"""
extern "C" void emu_traverse(const float* rows, int num_nodes, int depth,
                             const float4* rays, long long n, int any_hit,
                             float* t, int32_t* slot, float* u, float* v,
                             uint8_t* found, unsigned long long* counters) {
  run_groups((n + THREADS - 1) / THREADS, THREADS, 32, [&] {
    if (any_hit)
      traverse_wide_kernel<true, true>(rows, num_nodes, depth, rays, n, t,
                                       slot, u, v, found, counters);
    else
      traverse_wide_kernel<false, true>(rows, num_nodes, depth, rays, n, t,
                                        slot, u, v, found, counters);
  });
}
"""

_DESCEND_ENTRY = r"""
extern "C" void emu_descend(const float* rows, int num_nodes, int levels,
                            const float* px, const float* py, const float* pz,
                            const float* rnd, long long n, int32_t* slot,
                            float* pdf, uint8_t* valid) {
  run_groups((n * LANES + THREADS - 1) / THREADS, THREADS, LANES, [&] {
    light_tree_descend_kernel(rows, num_nodes, levels, px, py, pz, rnd, n,
                              slot, pdf, valid);
  });
}
"""


def _host_build(name, entry, tmp):
    """csrc/<name>.cu with the emulation in place of the CUDA headers and
    without its launch configurations, plus an entry function → ctypes
    library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine to build the kernel emulation")
    with open(os.path.join(_CSRC, name + ".cu")) as f:
        src = f.read()
    src = re.sub(r"#include <cuda_(runtime|fp16)\.h>\n", "", src)
    src = re.sub(r"<<<[^>]*>>>", "", src)
    src = src.replace("extern __shared__ int2 smem[];", "int2* smem = emu_smem;")
    path = os.path.join(tmp, name + ".cpp")
    with open(path, "w") as f:
        f.write(_EMU + src + entry)
    lib = os.path.join(tmp, "lib%s_emu.so" % name)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-w", "-o", lib, path], check=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("kernel_emulation"))
    p = ctypes.c_void_p
    b = _host_build("traverse_wide", _TRAVERSE_ENTRY, tmp)
    b.emu_traverse.argtypes = [p, ctypes.c_int, ctypes.c_int, p, ctypes.c_longlong,
                               ctypes.c_int, p, p, p, p, p, p]
    c = _host_build("light_tree_descend", _DESCEND_ENTRY, tmp)
    c.emu_descend.argtypes = [p, ctypes.c_int, ctypes.c_int, p, p, p, p,
                              ctypes.c_longlong, p, p, p]
    return b, c


def _rays_512(s):
    """The grazing rays of tests/test_torch_traverse.py (336 lanes) followed
    by the fixture's random rays, 512 lanes, every third with t_max 4."""
    o, d, act = _grazing_rays(s)
    k = int(act.sum())
    o[k:], d[k:], act[k:] = s["origins"][k:], s["dirs"][k:], s["act"][k:]
    t_max = np.where(np.arange(512) % 3 == 0, 4.0, 3e38).astype(np.float32)
    return o[:512], d[:512], t_max, act[:512]


def _emu_traverse(lib, bvh, o, d, t_max, act, any_hit, lone=False):
    """Kernel B's source on the CPU → (t, slot, u, v, found, counters). With
    ``lone``, each ray walks alone in a packet of 32 lanes (the others
    inactive), so the counters hold each ray's own tests."""
    if lone:
        def spread(a, fill):
            out = np.full((a.shape[0] * 32,) + a.shape[1:], fill, a.dtype)
            out[::32] = a
            return out

        *res, counters = _emu_traverse(lib, bvh, spread(o, 0), spread(d, 1),
                                       spread(t_max, 0), spread(act, False),
                                       any_hit)
        return (*(x[::32] for x in res), counters)
    n = o.shape[0]
    rays = unplanar_plain([*_tv(o)[:3], torch.as_tensor(t_max), *_tv(d)[:3],
                           torch.as_tensor(act.astype(np.int32)).view(torch.float32)])
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    slot = torch.empty(n, dtype=torch.int32)
    found = torch.empty(n, dtype=torch.uint8)
    counters = torch.zeros(2, dtype=torch.int64)
    lib.emu_traverse(bvh.rows.data_ptr(), bvh.num_nodes, bvh.depth,
                     rays.contiguous().data_ptr(), n, int(any_hit),
                     t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(),
                     found.data_ptr(), counters.data_ptr())
    return t, slot, u, v, found.bool(), counters.tolist()


def _brute_force(tris, o, d):
    """Float32 Möller-Trumbore of every ray against every slot, with the
    kernel's arithmetic (the port's ``ray_triangle``): (t, hit), each
    [rays, slots]."""
    v0, e1, e2 = (Vec3(*(torch.as_tensor(np.ascontiguousarray(a[None, :, i]))
                         for i in range(3))) for a in tris)
    o_t, d_t = _tv(o), _tv(d)
    t, _u, _v, hit = ray_triangle(Vec3(*(c[:, None] for c in o_t)),
                                  Vec3(*(c[:, None] for c in d_t)), v0, e1, e2)
    return t.numpy(), hit.numpy()


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("lone", [False, True], ids=["packets", "lone"])
def test_kernel_b_source_matches_jax_walk(scene600, emu, any_hit, lone):  # noqa: F811
    """Kernel B against the JAX walk (16-ray packets, no box-test margin) on
    grazing and random rays: 512 rays in 32-ray packets, or 64 rays each
    alone in its packet. On every lane whose verdict no triangle border
    decides (``_edge_lanes``; there XLA's fused multiply-adds round
    otherwise): closest slots equal up to exact-t ties (``_tie_lanes``) or
    the kernel's hit is nearer; t within rtol 1e-5 and u, v within 1e-5 where
    the slots agree; any-hit flags equal, or the kernel alone finds an
    occluder. On every lane, each hit the kernel reports is one that brute
    force over all slots confirms (closest: its slot at its t within 1e-6;
    any hit: some triangle in range), so where it differs from the reference
    it has found a real triangle, never lost one. Test counts are positive,
    and a ray alone in its packet runs fewer than the packets of the same
    rays."""
    s = scene600
    bvh = s["bvh"]
    o, d, t_max, act = _rays_512(s)
    # the reference at the same shape either way (one XLA compile)
    ref = j_traverse_wide(s["j_bvh"], _jv(o), _jv(d), jnp.asarray(t_max),
                          any_hit=any_hit, active=jnp.asarray(act))
    n = 64 if lone else 512
    o, d, t_max, act = o[:n], d[:n], t_max[:n], act[:n]
    ref = type(ref)(*(np.asarray(x)[:n] for x in ref))
    t, slot, u, v, found, counts = _emu_traverse(emu[0], bvh, o, d, t_max, act,
                                                 any_hit, lone)
    assert counts[0] > 0 and counts[1] > 0
    if lone:
        packed = _emu_traverse(emu[0], bvh, o, d, t_max, act, any_hit)[5]
        assert counts[0] < packed[0] and counts[1] <= packed[1]
    clear = act & ~_edge_lanes(s["tris"], o, d)
    assert clear.sum() >= act.sum() // 3
    bf_t, bf_hit = _brute_force(s["tris"], o, d)
    if any_hit:
        got, want = found.numpy(), np.asarray(ref.slot) >= 0
        assert not (got & ~act).any()
        assert (bf_hit & (bf_t < t_max[:, None])).any(axis=1)[got].all()
        assert not (want & ~got)[clear].any()
        assert 0 < int(got.sum()) < int(act.sum())
        return
    slot, ref_slot = slot.numpy(), np.asarray(ref.slot)
    t, ref_t = t.numpy(), np.asarray(ref.t)
    hit = slot >= 0
    assert not (hit & ~act).any() and int(hit.sum()) > 10
    k = np.where(hit, slot, 0)
    t_bf = bf_t[np.arange(n), k]
    assert (bf_hit[np.arange(n), k] & (np.abs(t_bf - t) <= 1e-6 * np.abs(t)))[hit].all()
    ties = _tie_lanes(s["tris"], o, d)
    same = slot == ref_slot
    nearer = hit & ((ref_slot < 0) | (t < ref_t))
    assert (same | ties | nearer)[clear].all()
    keep = clear & same & hit & ~ties
    np.testing.assert_allclose(t[keep], ref_t[keep], rtol=1e-5)
    np.testing.assert_allclose(u.numpy()[keep], np.asarray(ref.u)[keep], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[keep], np.asarray(ref.v)[keep], atol=1e-5)


def test_kernel_c_source_matches_plain_descent(emu):
    tree = LT.build_light_tree(*_random_lights())
    rows = torch.as_tensor(tree.rows)
    rng = np.random.default_rng(21)
    n = 512
    pos = [torch.as_tensor(rng.uniform(lo, hi, n).astype(np.float32))
           for lo, hi in ((-20, 20), (-2, 8), (-20, 20))]
    rnd = torch.as_tensor(rng.random((tree.levels + 1, n)).astype(np.float32))
    slot = torch.empty(n, dtype=torch.int32)
    pdf = torch.empty(n)
    valid = torch.empty(n, dtype=torch.uint8)
    emu[1].emu_descend(rows.data_ptr(), tree.num_nodes, tree.levels,
                       *(x.data_ptr() for x in pos), rnd.data_ptr(), n,
                       slot.data_ptr(), pdf.data_ptr(), valid.data_ptr())
    ref_slot, ref_pdf, ref_valid = LT.light_tree_descend_plain(
        rows, tree.num_nodes, tree.levels, Vec3(*pos), rnd)
    assert torch.equal(slot, ref_slot)
    assert torch.equal(valid.bool(), ref_valid) and bool(ref_valid.all())
    np.testing.assert_allclose(pdf.numpy(), ref_pdf.numpy(), rtol=1e-5)
