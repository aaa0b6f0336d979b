#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``luminary_tpu_torch``) on one card.

    python3 chip_smoke.py [--compare DIR]

Phases, one or more lines each; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``luminary_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
3. kernels against their plain PyTorch versions at main-path shapes, on real
   inputs from ``benchmark_scene(1920, 1080, 4)`` packed on the card: kernel B
   (closest and any-hit; every lane where it and the plain packet walk differ
   must be a hit of the kernel that a brute-force test over all triangles
   confirms, never one that only the plain walk finds), the unplanar ray
   pack, kernel A (every table width and sub-stride the path uses), kernel
   C, the rounding kernels (``libm_sincos`` and ``fma32``; ``csrc/shading.cu``'s
   camera ray, hit point, frame, BSDF evaluation and sample against their
   plain versions run on the CPU, and its stars against theirs on the card,
   whose ``atan2``, ``arccos`` and ``exp`` are the kernel's, at the main
   path's lanes and at ~126,000 lanes whose grid coordinate lies within 4
   ulps of a cell edge, both roundings of the dot, one device kernel a
   call; each timed out of L2 over 40 launches with their median), and the
   random streams (card against CPU),
   each with its time, bound, plain time and, for kernel A and unplanar, a
   library yardstick and graph-replay device times beside the eager ones. With
   ``--compare DIR`` (a directory holding an earlier version's
   ``traverse_wide.cu``, ``light_tree_descend.cu`` or ``gather_sum.cu``),
   that build is timed in turns with the port's kernels B and C on the same
   inputs (this, earlier, earlier, this), with its ptxas figures, its slab
   and triangle test counts and, for kernel B, where it differs from the
   plain walk (kernel E's turns are in 3b);
3b. prototype kernels: kernel D (row gather; the fill-NaN, clamp and
   zero-with-bf16 index rules), kernel E (ordered row sum and dependent
   fetch chain), kernel F (slab body, both fetch modes) and kernel T
   (transpose) against their plain versions at the shapes of the Pallas
   prototypes in ``tools/``, with time, bound, plain time and a library
   yardstick where one exists, after the launch floor (an empty kernel,
   ``csrc/launch_floor.cu``, timed the same way), and D's and F's bounds
   with the floor in them: max(bytes, operations, floor). Kernel E is also
   held bit
   for bit at the contract's other shapes (K and steps 0, 1 and across
   stages, 4 to 128 columns, chains that cycle, a table too large for its
   shared-memory tables, NaN in column 0), beside the floor of its ordered
   adds (4 cycles each at the SM clock ``nvidia-smi`` reads) and, with an
   earlier ``gather_sum.cu`` in ``--compare``'s DIR, in turns with that
   build, ptxas for both; then the port's three tool entry points
   (``luminary_tpu_torch.tools``: ``proto_gather all``, ``proto_gather2
   all``, ``microbench_colext`` main and main2) on the card, with the launch
   counts of D, E, F and T from 0;
4. main path: the tree-tier bench scene at 1080p, depth 4, through the
   Renderer, with launch counts of every kernel and Mrays/s;
4b. the profile of one more sample of it (``utils/profiling.py``
   ``profile_renderer``): device time by the integrator's stages, the
   percentages summing to 100, the device's busy share over the profiled
   window, and kernels A, B (closest and any hit) and C each under its
   stage;
5. dense tier: ``cornell_scene(512, 512, 4)`` Mrays/s;
6. correctness: 64-spp renders of golden scenes on the card against
   ``tests/golden`` (RMSE/scale < 0.02, the bound of tests/test_golden.py):
   cornell_32, sun_plane_32, glass_sphere_32 and fog_bridges_32;
   textured_32's figure is reported (the JAX package's own render reads
   0.049 against it) and the card is held to the plain CPU path there, at
   the same bound;
7. product path on ``benchmark_scene(1920, 1080, 4)``, each part with the
   launch counts of kernels A, unplanar, B and C from 0: the ``Host`` with
   no device argument (a 4-sample request polled to its image, which must
   equal within one level the plain ``_generate_image`` run on the CPU over
   the card's accumulators; picking at the centre must hit an instance;
   ``get_image`` timed), the asynchronous ``Host`` on an explicit
   ``"cuda"`` (its device worker thread answers a 2-sample request; a
   worker's error would be raised by the poll), checkpoint/resume (2
   samples, save, load into a fresh renderer, 2 more: bit-equal to 4
   unbroken samples), adaptive sampling (a budget of 8 samples, the last 6
   all in stages: a non-uniform sample map, finite radiance, kernels B and C
   launched on the stage subsets; then at 32x18 the card's stages against
   the plain CPU path's from the same accumulators: the sample maps equal,
   the radiance within RMSE/scale 0.02) and the CLI (``python -m luminary_tpu_torch`` on the scene
   written as OBJ/MTL and ``.lum``: ``-s 4 -o out.png``, then ``-b 2``; each
   run in a subprocess through runpy, which prints that process's launch
   counts when it exits; the ``-b`` ladder compared rung by rung with the
   ``-s 4`` image by ``tools/compare.py``); and one ``PropertyPanel`` edit
   through the card Host, which must restart accumulation, the next frame
   drawn to the viewer's half-blocks;
8. scene content at full width, ``content_scene(1920, 1080, 4)`` (the bench
   field with albedo, roughness, metallic, normal and luminance maps, 200
   alpha-textured cards, fog with 2-vertex bridges): the pack seconds and
   table sizes; kernel A bit-equal to its plain version on the aux table,
   the micro weights and the 69-column light rows; kernel B any-hit on the
   shadow table (a lane where kernel and plain walk differ must be a hit of
   the kernel that brute force over the opaque triangles confirms); the
   transmission pass's time and peak memory; Mrays/s over a block of
   samples, the peak memory of a sample and the launch counts from 0 of A
   (by table), unplanar, B (closest on the main table, any-hit on each
   table) and C; then the same scene at 64x36, 2 samples, on the card
   against the plain CPU path (RMSE/scale < 1e-3);
9. sky and sea at full width, ``outdoor_scene(1920, 1080, 4)`` (the bench
   field at sea: the analytic ocean with water scattering and sun
   caustics, the low and mid cloud layers), (a) under the DEFAULT sky with
   the cloud march and cloud shadows, (b) under the HDRI sky baked at 2048
   x 1024 with the clouds in the map and env NEE: the pack and HDRI bake
   seconds, the peak memory of a sample, Mrays/s beside tree-1080p's, the
   launches from 0 of A, unplanar, B closest and any-hit and C, the rays of
   each any-hit launch, the time per call of the ocean march, the cloud
   march and the caustic connection; ``csrc/clouds.cu`` bit for bit against
   its plain versions on the card, each launch timed beside its operations
   bound (the density evaluations the lanes need): the march at (a)'s miss
   lanes and at the HDRI bake's 2048 x 1024 lanes, the cloud shadows at
   (a)'s sun candidates, with the march's ms a call and the bake's seconds;
   kernel B any-hit on (b)'s 5-segment
   shadow batch and its first 3 segments under phase 3's rule; the card
   against the plain CPU path at 64x36 on the same sky tables (the card's
   own sky bake held against the CPU's off the stars' texels, RMSE/scale
   < 1e-4): RMSE/scale over all pixels reported, at most 2 pixels with
   another decision (over 1e-2 of the scale apart), the rest within
   RMSE/scale 1e-3 with clouds off, 1e-2 with clouds on; ``clouds_32`` at
   64 spp against its golden (RMSE/scale < 0.02 over the whole image, at
   most 5 pixels more than 1e-2 of the scale apart, as
   ``tests/test_torch_golden_sky.py`` holds it) and against the plain CPU
   path (at most 8 pixels another decision, the rest within 1e-2);
10. optics at full width, ``optics_scene(1920, 1080, 4)`` (the bench field
   with a moving particle field at the reference's defaults, 8,192 quads in
   a 10 m tile; spectral rendering under the DEFAULT sky's 8-band bake; the
   physical camera's achromat), (a) as it is and (b) with the wavefront
   sort: the pack seconds and the 8-band bake's, the peak memory of a
   sample, Mrays/s beside tree-1080p's, the launches from 0 of A (the
   8-band env rows apart), unplanar, B closest (the particle table apart),
   B any-hit and C, the time per call of the particle tile walk, of each of
   its kernel-B launches, of the lens trace and of the spectral resolve;
   kernel B closest on the particle BVH against its plain walk under phase
   3's rule, its bound from each ray's own walk; kernel A at C32 on the
   8-band env rows bit for bit, its bytes bound; the card against the plain
   CPU path at 64x36 on the same sky tables in both variants (at most 8
   pixels another decision, the rest within RMSE/scale 1e-3; the card's
   own 8-band bake within 1e-4 of the CPU's), the lens lanes that decided
   otherwise counted.
11. multi-device rendering (``parallel/mesh.py`` through the Renderer) on
   ``benchmark_scene(1920, 1080, 4)``: a 4-shard sample mesh of the card
   (one step, sample ids 0-3) and a 2x2 grid mesh (two steps, each over two
   pixel blocks) against the serial Renderer over ids 0-3 (RMSE/scale and
   the largest absolute difference, within rtol 2e-4 and atol 1e-5); every
   shard render's launches of kernels A, B and C and the current device
   it ran under (each must launch all three, under its own device); the
   seconds a sample of the serial and the 4-shard renderer in turns
   (serial, mesh, mesh, serial); shard 0 disabled and 3 samples on the
   re-formed mesh against a fresh 3-shard mesh (atol 1e-6); with two or
   more cards, a sample mesh over the distinct cards against the serial
   Renderer.

Then the rows whose bound the launch floor raises, one JSON line of kernel
results, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Without a CUDA device it exits with 2 and
prints no result.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
ADD_CYCLES = 4              # latency of a dependent fp32 add (kernel E's floor)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
FP64_FLOPS = 34e12          # H100 SXM fp64 outside the tensor cores
# operations of one cloud density evaluation in csrc/clouds.cu: 72 glibc
# sines of 13 float64 flops each (an FMA counted as 2), and ~1,530 float32
# flops (72 hashes of ~15, 9 octaves of ~47, ~30 for the height stack)
DENSITY_FP64 = 72 * 13
DENSITY_FP32 = 1530
# operations of one child slab test and one Moller-Trumbore test, as written
# in csrc/traverse_wide.cu (adds, multiplies, min/max, compares, 1 divide)
SLAB_OPS = 25
TRI_OPS = 50
# operations of one child (16 per node level) / light (14 per leaf level)
# weight in csrc/light_tree_descend.cu
NODE_CHILD_OPS = 48
LEAF_LIGHT_OPS = 26
# operations of one (packet, child, ray) of csrc/slab_body.cu: 6 subtracts,
# 6 multiplies, 10 min/max, a compare, a select and the min over rays
SLAB_BODY_OPS = 25


_T0 = time.monotonic()


def log(msg):
    """Print a line (or lines), the seconds since the start after it."""
    print("%s  [%.1f s]" % (msg, time.monotonic() - _T0), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(out: str) -> dict:
    """-Xptxas -v output → {kernel entry: "R registers, F B stack frame,
    S B spill stores, L B spill loads"} (template flags kept as digits)."""
    res, cur, frame = {}, None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = re.sub(r"^_Z\d+", "", m.group(1)).split("P")[0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            frame = "%s B stack frame, %s B spill stores, %s B spill loads" % m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            res[cur] = "%s registers, %s" % (m.group(1), frame)
            cur, frame = None, ""
    return res


def build_libs(kernels, jobs) -> dict:
    """Build [(key, source, extra nvcc flags, library path)] in parallel with
    the port's flags → {key: (ctypes library, ptxas summary)}."""
    procs = {}
    for key, src, flags, lib in jobs:
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        procs[key] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-Xptxas", "-v",
             "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (key, out))
        libs[key] = (ctypes.CDLL(lib), ptxas_summary(out))
    return libs


def same_bits(a, b) -> bool:
    """Equal bit for bit, except that any NaN equals any NaN."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def prototype_kernels(dev, cuda_ms, bound, smi, floor_lib, alts=(),
                      with_lib=None, this_ptxas=None, alt_ptxas=None) -> list:
    """Kernels D, E (sum and chain), F and T against their plain versions
    at the prototypes' shapes, each with its time, bound, plain time and,
    where one PyTorch call computes the same function, that call's time;
    kernel E also at the contract's other shapes, beside the floor of its
    ordered adds and, with an earlier build of it among ``alts``, in turns
    with that build. ``floor_lib`` holds the empty kernel whose time is the
    launch floor. Returns their entries of the kernels line (launches set by
    the caller)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from luminary_tpu_torch import kernels
    from luminary_tpu_torch.tools import launch_ms
    from luminary_tpu_torch.tools import microbench_colext as CX
    from luminary_tpu_torch.tools import proto_gather as PG
    from luminary_tpu_torch.tools import proto_gather2 as PG2

    # the kernels' and libraries' device time per launch, from CUDA-graph
    # replays (launch_ms): timed over eager calls, the small launches here
    # would time the host's cost of each call instead
    def dev_ms(fn):
        return launch_ms(fn, dev)

    out = []
    rng = np.random.default_rng(4)
    rows, cols = PG.S, PG.COLS
    tab = torch.as_tensor(rng.random((rows, cols), dtype=np.float32)).to(dev)
    tab_bf16 = tab.to(torch.bfloat16).to(torch.float32)
    edge = torch.tensor([0, -1, rows, rows + 5, -rows - 3, 7], dtype=torch.int32)

    def rand_idx(n):
        idx = torch.as_tensor(rng.integers(0, rows, n, dtype=np.int32)).to(dev)
        idx[:6] = edge.to(dev)
        return idx

    # the card's floor for one launch: an empty kernel, timed like the rest,
    # first. One launch is the least any of these functions takes, so beside
    # each bound (bytes or operations) stands the bound with the floor,
    # max(bytes, operations, floor), and the share of that
    floor_fn = floor_lib.lum_launch_floor
    floor_fn.argtypes, floor_fn.restype = [ctypes.c_void_p], ctypes.c_int
    floor_ms = dev_ms(lambda: kernels.check(floor_fn(kernels.stream_handle(dev)),
                                            "launch_floor"))
    log("[launch floor] an empty kernel: %.4f ms a launch (device time from "
        "CUDA-graph replays) | %s" % (floor_ms, smi))

    def with_floor(b_ms, ms):
        """(the bound with the launch floor, the share of it that ms is)."""
        fb = max(b_ms, floor_ms)
        return fb, 100.0 * fb / ms

    # kernel D: E1 / E1b (fill_nan), E4 (clamp) at 65,536 rows, E3 (zero,
    # bf16) at 512 rows; edge indices lead each index vector
    d_rows = []
    for label, n, mode, bf16 in (("e1 take fill_nan", PG.N, "fill_nan", False),
                                 ("e4 ref[idx] clamp", PG.N, "clamp", False),
                                 ("e3 one-hot zero bf16", PG.G, "zero", True)):
        idx = rand_idx(n)
        got = PG.gather_rows(tab, idx, mode, bf16)
        ref = PG.gather_rows_plain(tab, idx, mode, bf16)
        assert same_bits(got, ref), label
        ms = dev_ms(lambda: PG.gather_rows(tab, idx, mode, bf16))
        call_ms = cuda_ms(lambda: PG.gather_rows(tab, idx, mode, bf16), iters=20)
        plain_ms = cuda_ms(lambda: PG.gather_rows_plain(tab, idx, mode, bf16))
        src = tab_bf16 if bf16 else tab
        idx_c = idx.long().clamp(0, rows - 1)
        lib_ms = dev_ms(lambda: src.index_select(0, idx_c))
        k = idx.long()
        k = torch.where(k < 0, k + rows, k) if mode != "zero" else k
        used = torch.unique(k[(k >= 0) & (k < rows)]).numel()
        b_ms, b_by = bound(used * cols * 4 + n * 4 + n * cols * 4, 0)
        fb_ms, f_share = with_floor(b_ms, ms)
        log("[kernel D %s] %d rows x %d: equal (NaN rows alike); %.4f ms a launch "
            "(one eager call %.4f ms), plain %.4f ms, library %.4f ms "
            "(index_select%s), bound %.5f ms (%s; %.0f %%), with the launch "
            "floor %.4f ms (%.0f %%) | %s" % (
                label, n, cols, ms, call_ms, plain_ms, lib_ms,
                " on the bf16-rounded table" if bf16 else "", b_ms, b_by,
                100.0 * b_ms / ms, fb_ms, f_share, smi))
        d_rows.append(dict(case=label, rows=n, ms=ms, call_ms=call_ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by, bound_with_floor_ms=fb_ms,
                           launch_floor_ms=floor_ms))
    out.append(dict(
        name="gather_rows", route="cuda",
        source="luminary_tpu_torch/csrc/gather_rows.cu",
        replaces="tools/proto_pallas_gather.py:52",
        also_replaces=["tools/proto_pallas_gather.py:80",
                       "tools/proto_pallas_gather.py:143",
                       "tools/proto_pallas_gather.py:169"],
        max_abs_err=0.0, **{k: d_rows[0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=d_rows[0]["case"], cases=d_rows))

    out[-1]["launch_floor_ms"] = floor_ms

    # kernel E against an earlier build of csrc/gather_sum.cu (--compare), in
    # turns (this, earlier, earlier, this) on the same inputs
    e_alts = [(label, lib) for name, label, lib in alts if name == "gather_sum"]

    def e_turns(fn, check):
        res = {}
        for label, lib in e_alts:
            with_lib("gather_sum", lib, check)
            t = {"this": [], label: []}
            for who in ("this", label, label, "this"):
                t[who].append(dev_ms(fn) if who == "this" else
                              with_lib("gather_sum", lib, lambda: dev_ms(fn)))
            res[label] = dict(ms=sum(t[label]) / 2, turns=t[label],
                              this_ms=sum(t["this"]) / 2, this_turns=t["this"],
                              ptxas=alt_ptxas.get("gather_sum " + label, {}))
            log("[compare %s] %s: %.4f ms, this: %.4f ms (turns %s / %s); "
                "ptxas this %s; %s %s | %s" % (
                    fn.__name__, label, res[label]["ms"], res[label]["this_ms"],
                    ", ".join("%.4f" % x for x in t[label]),
                    ", ".join("%.4f" % x for x in t["this"]),
                    {k: v for k, v in this_ptxas.items() if fn.__name__ in k},
                    label, {k: v for k, v in res[label]["ptxas"].items()
                            if fn.__name__ in k}, smi))
        return res

    def same_as(fn, want):
        def check():
            assert torch.equal(fn(), want), "the earlier %s differs" % fn.__name__
        return check

    def clock_mhz():
        q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, check=True, timeout=60).stdout
        return [float(v) for v in q.strip().splitlines()[0].split(",")]

    # kernel E, gather_sum: E2's 2048 fetches, summed in order
    idx = rand_idx(PG.K)
    got = PG.gather_sum(tab, idx)
    ref = PG.gather_sum_plain(tab, idx)
    assert torch.equal(got, ref)

    def gather_sum():
        return PG.gather_sum(tab, idx)

    ms = dev_ms(gather_sum)
    sm_mhz, max_mhz = clock_mhz()
    call_ms = cuda_ms(gather_sum, iters=20)
    plain_ms = cuda_ms(lambda: PG.gather_sum_plain(tab, idx), iters=3)
    idx_c = idx.long()
    idx_c = torch.where(idx_c < 0, idx_c + rows, idx_c).clamp(0, rows - 1)[None]
    lib_ms = dev_ms(lambda: F.embedding_bag(idx_c, tab, mode="sum"))
    lib_err = float((F.embedding_bag(idx_c, tab, mode="sum") - ref).abs().max())
    used = torch.unique(idx_c).numel()
    b_ms, b_by = bound(used * cols * 4 + PG.K * 4 + cols * 4, PG.K * cols)
    # the ordered sum's own floor: K dependent float adds of ~4 cycles
    order_ms = PG.K * ADD_CYCLES / (sm_mhz * 1e3)
    cmp_sum = e_turns(gather_sum, same_as(gather_sum, ref))
    log("[kernel E gather_sum] %d fetches x %d: exact; %.4f ms a launch (%.1f "
        "ns/row; one eager call %.4f ms), plain %.3f ms, library %.4f ms "
        "(embedding_bag sum, max abs diff %.3g: its own order), bound %.5f ms "
        "(%s), ordered-add floor %.4f ms (%d adds x %d cycles at the %.0f MHz "
        "SM clock read after it; max %.0f MHz), launch floor %.4f ms | %s" % (
            PG.K, cols, ms, ms / PG.K * 1e6, call_ms, plain_ms, lib_ms, lib_err,
            b_ms, b_by, order_ms, PG.K, ADD_CYCLES, sm_mhz, max_mhz, floor_ms, smi))
    out.append(dict(
        name="gather_sum", route="cuda", source="luminary_tpu_torch/csrc/gather_sum.cu",
        replaces="tools/proto_pallas_gather.py:112", max_abs_err=0.0, ms=ms,
        call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, ns_per_row=ms / PG.K * 1e6, order_floor_ms=order_ms,
        sm_clock_mhz=sm_mhz, max_sm_clock_mhz=max_mhz, launch_floor_ms=floor_ms,
        compare=cmp_sum))

    # kernel E, gather_chain: E2c's 4096 fetches on a 2 * randn table (the
    # row[1] > 2 branch taken) from a negative seed
    tab2_np = (2.0 * rng.standard_normal((rows, cols))).astype(np.float32)
    tab2 = torch.as_tensor(tab2_np).to(dev)
    seed = -0.0123
    steps = PG2.ROWS_PER_CALL
    got = PG2.gather_chain(tab2, seed, steps)
    ref2 = PG2.gather_chain_plain(tab2, seed, steps)
    assert torch.equal(got, ref2)
    path = PG2.chain_rows(tab2_np, seed, steps)
    branch = int((tab2_np[path, 1] > 2).sum())
    assert branch > 0
    seed_t = torch.tensor([seed], dtype=torch.float32, device=dev)

    def gather_chain():
        return PG2.gather_chain(tab2, seed_t, steps)

    ms = dev_ms(gather_chain)
    sm_mhz, max_mhz = clock_mhz()
    plain_ms = cuda_ms(lambda: PG2.gather_chain_plain(tab2, seed_t, steps), iters=2,
                       warmup=1)
    b_ms, b_by = bound(np.unique(path).size * cols * 4 + 4 + cols * 4,
                       steps * (cols + 6))
    order_ms = steps * ADD_CYCLES / (sm_mhz * 1e3)
    cmp_chain = e_turns(gather_chain, same_as(gather_chain, ref2))
    log("[kernel E gather_chain] %d steps x %d (%d through the row[1] > 2 "
        "branch): exact; %.4f ms (%.1f ns/step), plain %.1f ms, bound %.5f ms "
        "(%s), ordered-add floor %.4f ms (%d adds x %d cycles at %.0f MHz; max "
        "%.0f MHz), launch floor %.4f ms | %s" % (
            steps, cols, branch, ms, ms / steps * 1e6, plain_ms, b_ms, b_by,
            order_ms, steps, ADD_CYCLES, sm_mhz, max_mhz, floor_ms, smi))
    out.append(dict(
        name="gather_chain", route="cuda", source="luminary_tpu_torch/csrc/gather_sum.cu",
        replaces="tools/proto_pallas_gather2.py:64", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ns_per_row=ms / steps * 1e6, order_floor_ms=order_ms, sm_clock_mhz=sm_mhz,
        max_sm_clock_mhz=max_mhz, launch_floor_ms=floor_ms, compare=cmp_chain))

    # kernel E at the contract's other shapes, each bit for bit: K inside a
    # stage, across stages, 0 and 1; 4, 12 and 64 columns; indices negative
    # and out of range; chains of 0 and 1 steps, round a 40-row cycle, longer
    # than one listing pass, on a table too large for the shared-memory
    # tables (walked instead), and with NaN in column 0 of every 7th row
    extra = []
    for c_x, k in ((12, 77), (4, 5), (128, 1), (64, 0), (128, 3000)):
        t_x = torch.as_tensor(rng.standard_normal((rows, c_x)).astype(np.float32)).to(dev)
        i_x = torch.as_tensor(rng.integers(-2 * rows, 2 * rows, k).astype(np.int32)).to(dev)
        assert torch.equal(PG.gather_sum(t_x, i_x), PG.gather_sum_plain(t_x, i_x)), (c_x, k)
        extra.append("gather_sum %d cols K %d" % (c_x, k))
    for s_x, c_x, n_x, seed_x, nan in ((rows, 12, 0, seed, False),
                                       (rows, 12, 1, seed, False),
                                       (40, 12, 5000, seed, False),
                                       (40, 4, 30, 0.0004567, False),
                                       (rows, 128, 10000, 0.0004567, False),
                                       (40000, 12, 300, seed, False),
                                       (rows, 12, 500, 0.0004567, True)):
        t_np = (2.0 * rng.standard_normal((s_x, c_x))).astype(np.float32)
        if nan:
            t_np[::7, 0] = np.nan
        t_x = torch.as_tensor(t_np).to(dev)
        got_x = PG2.gather_chain(t_x, seed_x, n_x)
        ref_x = PG2.gather_chain_plain(t_x, seed_x, n_x)
        assert (same_bits(got_x, ref_x) if nan else torch.equal(got_x, ref_x)), (
            s_x, c_x, n_x, nan)
        extra.append("gather_chain S %d, %d cols, %d steps%s" % (
            s_x, c_x, n_x, ", NaN in column 0" if nan else ""))
    log("[kernel E extra shapes] equal to the plain versions bit for bit: %s"
        % "; ".join(extra))
    out[-1]["extra_shapes"] = out[-2]["extra_shapes"] = extra

    # kernel F: E5's 1024 packets, rows resident and fetched
    g = PG2.SLAB_G
    ox = torch.as_tensor(rng.random((8, g), dtype=np.float32)).to(dev)
    fetch = rand_idx(g)[:, None]
    seed_s = torch.tensor([PG2.SLAB_SEED], dtype=torch.float32, device=dev)
    f_rows = []
    for mode in PG2.FETCH_MODES:
        f = fetch if mode == "scalarloop" else None
        got = PG2.slab_body(tab, ox, PG2.SLAB_SEED, f)
        ref = PG2.slab_body_plain(tab, ox, PG2.SLAB_SEED, f)
        assert torch.equal(got, ref), mode
        ms = dev_ms(lambda: PG2.slab_body(tab, ox, seed_s, f))
        call_ms = cuda_ms(lambda: PG2.slab_body(tab, ox, seed_s, f), iters=20)
        plain_ms = cuda_ms(lambda: PG2.slab_body_plain(tab, ox, seed_s, f))
        if f is None:
            read = g * 96 * 4
        else:
            k = f.long()[:, 0]
            k = torch.where(k < 0, k + rows, k).clamp(0, rows - 1)
            read = torch.unique(k).numel() * 96 * 4 + g * 4
        b_ms, b_by = bound(read + 8 * g * 4 + 4 + g * 4,
                           g * (16 * 8 * SLAB_BODY_OPS + 8))
        fb_ms, f_share = with_floor(b_ms, ms)
        log("[kernel F slab_body %s] %d packets x 16 children x 8 rays: exact "
            "(%d all-miss packets); %.4f ms a launch (one eager call %.4f ms), "
            "plain %.3f ms, bound %.5f ms (%s; %.0f %%; 64 blocks: launch and "
            "one wave's latency set the time), with the launch floor %.4f ms "
            "(%.0f %%) | %s" % (
                mode, g, int(torch.isinf(got).sum()), ms, call_ms, plain_ms, b_ms,
                b_by, 100.0 * b_ms / ms, fb_ms, f_share, smi))
        f_rows.append(dict(case=mode, packets=g, ms=ms, call_ms=call_ms,
                           plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                           bound_by=b_by, bound_with_floor_ms=fb_ms,
                           launch_floor_ms=floor_ms))
    out.append(dict(
        name="slab_body", route="cuda", source="luminary_tpu_torch/csrc/slab_body.cu",
        replaces="tools/proto_pallas_gather2.py:126", max_abs_err=0.0,
        **{k: f_rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        shape="fetch none", cases=f_rows, launch_floor_ms=floor_ms))

    # kernel T: colext's [2^21, 48] gather output to planar [48, 2^21]
    x = torch.randn((CX.N, 48), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    got = CX.transpose(x)
    assert torch.equal(got, CX.transpose_plain(x))
    ms = dev_ms(lambda: CX.transpose(x))
    plain_ms = cuda_ms(lambda: CX.transpose_plain(x), iters=3)
    lib_ms = dev_ms(lambda: x.t().contiguous())
    b_ms, b_by = bound(2 * x.numel() * 4, 0)
    log("[kernel T transpose] [%d, 48] -> [48, %d]: exact; %.4f ms, plain %.3f ms, "
        "library %.4f ms (t().contiguous()), bound %.4f ms (%s) | %s" % (
            CX.N, CX.N, ms, plain_ms, lib_ms, b_ms, b_by, smi))
    out.append(dict(
        name="transpose", route="cuda", source="luminary_tpu_torch/csrc/transpose.cu",
        replaces="tools/microbench_colext.py:78", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    return out


def per_ray_tests(rows, num_nodes, depth, o, d, t_max, active, any_hit,
                  chunk=1 << 20):
    """Kernel B's slab and triangle test counts on the table ``rows`` with
    every ray alone in its 32-lane packet: each ray's own walk, nearest child
    first, the work the function needs on this run's data. The counts of the
    ordinary launch are those of its 32-ray packets."""
    import torch

    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.vec import Vec3

    dev = rows.device
    total = dict(node_tests=0, tri_tests=0)
    for a in range(0, o.x.shape[0], chunk):
        b = min(a + chunk, o.x.shape[0])

        def spread(x, fill):
            out = torch.full((32 * (b - a),), fill, dtype=x.dtype, device=dev)
            out[::32] = x[a:b]
            return out

        st = {}
        TR.traverse_wide(rows, num_nodes, depth,
                         Vec3(*(spread(c, 0.0) for c in o)),
                         Vec3(*(spread(c, 1.0) for c in d)),
                         spread(t_max, 0.0), spread(active, False), any_hit,
                         stats=st)
        for k in total:
            total[k] += st[k]
    assert 0 < total["node_tests"] and 0 < total["tri_tests"], total
    return total


def kernel_a_case(label, table, idx, n_cols, s, dev, cuda_ms, bound, smi) -> dict:
    """Kernel A on one table of a path, against its plain version bit for
    bit: eager and graph-replay ms, plain ms, the library yardstick
    (``index_select`` + transpose, sub-stride 1) and the bytes bound."""
    import torch

    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.tools import launch_ms

    n = idx.shape[0]
    got = RO.gather_soa(table, idx, n_cols, s)
    ref = RO.gather_soa_plain(table, idx, n_cols, s)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), label
    ms = cuda_ms(lambda: RO.gather_soa(table, idx, n_cols, s))
    graph_ms = launch_ms(lambda: RO.gather_soa(table, idx, n_cols, s), dev)
    plain_ms = cuda_ms(lambda: RO.gather_soa_plain(table, idx, n_cols, s), iters=3)
    lib_ms = lib_graph_ms = None
    if s == 1:
        idx_c = idx.long().clamp(0, table.shape[0] - 1)

        def lib():
            return table[:, :n_cols].index_select(0, idx_c).t().contiguous()

        lib_ms = cuda_ms(lib)
        lib_graph_ms = launch_ms(lib, dev)
    # bytes the function must move: n_cols words of each distinct slot this
    # run selects, every lane's index, every output word
    k = idx.long()
    r0 = torch.div(k, s, rounding_mode="floor")
    r0 = torch.where(r0 < 0, r0 + table.shape[0], r0).clamp(0, table.shape[0] - 1)
    slots = torch.unique(r0 * s + (k - torch.div(k, s, rounding_mode="floor") * s))
    b_ms, b_by = bound(slots.numel() * n_cols * 4 + n * 4 + n * n_cols * 4, 0)
    log("[kernel A %s] %d lanes: exact; %.3f ms (graph replay %.4f ms), plain "
        "%.3f ms, library %s ms (graph replay %s ms), bound %.4f ms (%s) | %s" % (
            label, n, ms, graph_ms, plain_ms,
            "%.3f" % lib_ms if lib_ms is not None else "n/a",
            "%.4f" % lib_graph_ms if lib_graph_ms is not None else "n/a",
            b_ms, b_by, smi))
    return dict(case=label, lanes=n, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_graph_ms=lib_graph_ms, bound_ms=b_ms,
                bound_by=b_by)


def cold_launch_times(fn, dev, reps=20) -> list:
    """Device milliseconds of ``reps`` calls of ``fn()``, each with its
    operands out of L2: before each call a 1 GB write evicts the 50 MB L2,
    and CUDA events bracket the call alone (the write keeps the card busy
    while the host enqueues it)."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.int32, device=dev)
    fn()
    torch.cuda.synchronize(dev)
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize(dev)
    return [s.elapsed_time(e) for s, e in ev]


def cold_launch_ms(fn, dev, reps=20) -> float:
    """The mean of :func:`cold_launch_times`."""
    t = cold_launch_times(fn, dev, reps)
    return sum(t) / len(t)


# csrc/shading.cu's kernels: (the public wrapper, the bytes a lane reads and
# writes, fp32 operations a lane counted from the source; glibc's sine and
# cosine count ~25 float64 operations each, as 2 fp32 ones). The stars read
# d and write r, g, b (the intensity is a broadcast scalar); their cell adds
# CUDA's atan2f (a division and a degree-8 polynomial, ~35 operations) and
# acosf (a square root and a polynomial, ~25) to the star's ~100
SHADING = {
    "camera_ray": (44, 90),
    "ray_point": (40, 6),
    "make_frame": (116, 70),
    "frame_eval": (113, 160),
    "material_sample": (143, 520),
    "stars": (24, 160),
}


def shading_kernels(dev, smi, r, bound, cuda_ms) -> list:
    """csrc/shading.cu at the main path's width (the tree-1080p renderer's
    lanes): each kernel through its wrapper on the card against its plain
    PyTorch version run on the CPU on the same inputs (equal values: any NaN
    equals any NaN, and +0 equals -0), timed out of L2, its plain version
    timed on the card (whose fused multiply-adds and sines go through fma32
    and libm_sincos there)."""
    import numpy as np
    import torch

    from luminary_tpu_torch.ops import camera as C
    from luminary_tpu_torch.ops import material as M
    from luminary_tpu_torch.ops import random as R
    from luminary_tpu_torch.ops import vec as V
    from luminary_tpu_torch.ops.vec import Vec3

    cfg, cam = r.config, r.device_camera
    px, py = r._px, r._py
    n = px.shape[0]
    rng = np.random.default_rng(9)
    f32 = np.float32

    def lanes(a):
        return torch.as_tensor(np.ascontiguousarray(a, f32), device=dev)

    def unit(k):
        v = rng.standard_normal((n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return Vec3(*(lanes(v[:, i]) for i in range(3)))

    def cpu(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        if isinstance(v, tuple):
            return type(v)(*(cpu(x) for x in v)) if hasattr(v, "_fields") \
                else tuple(cpu(x) for x in v)
        return v

    def flat(v):
        out = []
        for x in v:
            out += flat(x) if isinstance(x, tuple) else [x]
        return out

    def compare(got, want):
        err, nd = 0.0, 0
        for a, b in zip(flat(got), flat(want)):
            a = a.cpu()
            if a.dtype == torch.bool:
                nd += int((a != b).sum())
                continue
            nan = torch.isnan(a)
            nd += int((nan != torch.isnan(b)).sum())
            ok = ~nan & ~torch.isnan(b)
            d = (a[ok] - b[ok]).abs()
            nd += int((d != 0).sum())
            if d.numel():
                err = max(err, float(d.max()))
        return err, nd

    ns, wo, wi = unit(0), unit(1), unit(2)
    trans = rng.random(n) < 0.3
    mat = M.LaneMaterial(
        albedo_r=lanes(rng.random(n)), albedo_g=lanes(rng.random(n)),
        albedo_b=lanes(rng.random(n)), roughness=lanes(rng.random(n)),
        metallic=lanes(rng.random(n) < 0.3), ior=lanes(rng.uniform(1.0, 2.5, n)),
        translucent=torch.as_tensor(trans, device=dev),
        opacity=lanes(np.ones(n)),
        thin_walled=torch.as_tensor(trans & (rng.random(n) < 0.3), device=dev))
    quad = r.device_scene.ggx_quad
    fr = M.make_frame(mat, ns, wo, quad)
    r_choice, r2 = lanes(rng.random(n)), lanes(rng.random((n, 2)))
    eta = lanes(rng.uniform(0.5, 2.0, n))
    t = lanes(rng.random(n) * 10.0 ** rng.integers(-2, 3, n))
    sid = torch.tensor(3, dtype=torch.int64, device=dev)
    pid = (py.long() * cfg.width + px.long()) & 0xFFFFFFFF
    jitter = R.quasi_2d(R.RandomTarget.CAMERA_JITTER,
                        torch.zeros((1,), dtype=torch.int64, device=dev),
                        sid).reshape(-1)
    ap = C._sample_aperture(cam, pid, sid, bn=R.blue_base(px, py))
    w, h = cfg.width, cfg.height
    cases = {
        "camera_ray": (
            lambda: C._camera_ray_kernel(cam, w, h, px, py, jitter, ap),
            lambda d: C._camera_ray_plain(*d),
            (cam, w, h, px, py, jitter, ap)),
        "ray_point": (lambda: V.ray_point(ns, wo, t),
                      lambda d: V.ray_point_plain(*d), (ns, wo, t)),
        "make_frame": (lambda: M.make_frame(mat, ns, wo, quad),
                       lambda d: M._make_frame_plain(*d), (mat, ns, wo, quad)),
        "frame_eval": (lambda: M.frame_eval(mat, fr, mat.roughness, wi),
                       lambda d: M._frame_eval_plain(*d),
                       (mat, fr, mat.roughness, wi)),
        "material_sample": (
            lambda: M._material_sample_kernel(mat, fr, r_choice, r2, eta),
            lambda d: M._material_sample_plain(*d), (mat, fr, r_choice, r2, eta)),
    }
    rows = []
    for name, (kern, plain, args) in cases.items():
        got = kern()
        t0 = time.monotonic()
        want = plain(tuple(cpu(a) for a in args))
        cpu_s = time.monotonic() - t0
        if name == "material_sample":
            got, want = got[:3] + got[4:], want[:3] + want[4:]
        err, nd = compare(got, want)
        times = cold_launch_times(kern, dev, reps=40)
        ms = sum(times) / len(times)
        med = float(np.median(times))
        plain_ms = cuda_ms(lambda: plain(args), iters=3, warmup=1)
        b_bytes, b_ops = SHADING[name]
        b_ms, b_by = bound(b_bytes * n, b_ops * n)
        log("[shading %s] %d lanes against the plain version on the CPU (%.1f s):"
            " %d values differ, max abs err %.3g; %.4f ms a launch (out of L2; "
            "the mean of %d, median %.4f, min %.4f, max %.4f), plain on the card "
            "%.3f ms, bound %.4f ms (%s) | %s" % (
                name, n, cpu_s, nd, err, ms, len(times), med, min(times),
                max(times), plain_ms, b_ms, b_by, smi))
        assert nd == 0, (name, nd, err)
        rows.append(dict(
            name=name, route="cuda", source="luminary_tpu_torch/csrc/shading.cu",
            replaces="none: the float32 rounding of the reference's compiled CPU "
                     "code (fused multiply-adds, glibc's sinf / cosf) at %s" % {
                         "camera_ray": "luminary_tpu/ops/camera.py:136",
                         "ray_point": "luminary_tpu/render/wavefront.py:557",
                         "make_frame": "luminary_tpu/ops/material.py:113",
                         "frame_eval": "luminary_tpu/ops/material.py:150",
                         "material_sample": "luminary_tpu/ops/material.py:171",
                     }[name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, lanes=n, plain_cpu_s=cpu_s,
            cold_median_ms=med, cold_ms=times))

    # the stars (lum_stars), at the deferred sky's width: half the lanes
    # within ~2e-4 rad of a star, where one ulp of the cosine moves the glow
    # by ~30 %, half uniform; and lanes whose grid coordinate u or v lies
    # within 4 ulps of a cell edge k/64, where an ulp of atan2 or arccos
    # moves a lane to the next cell (and a whole star appears or vanishes).
    # Against the plain version on the card, whose atan2, arccos and exp are
    # ATen's (the same functions as the kernel's: atan2f, acosf, expf), for
    # both roundings of the dot, bit for bit
    from luminary_tpu_torch.ops import sky as S
    from luminary_tpu_torch.testing import star_edge_directions
    from torch.profiler import ProfilerActivity, profile

    sky = r.device_scene.sky
    g = S.STARS_GRID
    cells = torch.as_tensor(rng.integers(0, g * g, n // 2))
    h0 = S._hash_u32(((cells * 0x9E3779B9) + (int(sky.stars_seed) & 0xFFFFFFFF))
                     & 0xFFFFFFFF)
    su = ((cells % g).double() + S._hash01((h0 + 1) & 0xFFFFFFFF).double()) / g
    sv = ((cells // g).double() + S._hash01((h0 + 2) & 0xFFFFFFFF).double()) / g
    phi, theta = (su - 0.5) * 2.0 * np.pi, sv * np.pi
    near = torch.stack([torch.cos(phi) * torch.sin(theta), torch.cos(theta),
                        torch.sin(phi) * torch.sin(theta)], -1).numpy()
    near = near + rng.standard_normal(near.shape) * 2e-4
    far = rng.standard_normal((n - n // 2, 3))
    dirs = np.concatenate([near, far])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = Vec3(*(lanes(dirs[:, i]) for i in range(3)))
    edges = star_edge_directions(per_edge=1000, seed=13)
    de = Vec3(*(lanes(edges[:, i]) for i in range(3)))
    # the edge lanes' u and v as the plain version computes them on the card
    u = torch.atan2(de.z, de.x) * (0.5 / np.pi) + 0.5
    v = torch.arccos(torch.clamp(de.y, -1.0, 1.0)) * (1.0 / np.pi)

    def near_edge(c):
        k = torch.round(c.double() * g)
        ulp = torch.as_tensor(np.spacing(np.maximum(
            (k / g).float().cpu().numpy(), np.float32(1.0 / g))), device=dev)
        return (c.double() - k / g).abs() <= 4 * ulp.double()

    n_edge = int((near_edge(u) | near_edge(v)).sum())
    both = Vec3(*(torch.cat([a, b]) for a, b in zip(d, de)))
    err, nd = 0.0, 0
    for fused in (True, False):
        got = S.stars_radiance(sky, both, fused)
        want = tuple(w.cpu() for w in S._stars_radiance_plain(sky, both, fused))
        e_, n_ = compare(got, want)
        err, nd = max(err, e_), nd + n_
        if fused:
            lit = int((want[1][:n] > 1e-3).sum())
            edge_lit = int((want[1][n:] > 0).sum())
    # one launch a call, no PyTorch op before it
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        S.stars_radiance(sky, d)
        torch.cuda.synchronize(dev)
    launched = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    times = cold_launch_times(lambda: S.stars_radiance(sky, d), dev, reps=40)
    ms, med = sum(times) / len(times), float(np.median(times))
    plain_ms = cuda_ms(lambda: S._stars_radiance_plain(sky, d), iters=3, warmup=1)
    b_bytes, b_ops = SHADING["stars"]
    b_ms, b_by = bound(b_bytes * n, b_ops * n)
    log("[shading stars] %d lanes (%d in a star's glow) and %d cell-edge lanes "
        "(%d of them within 4 ulps of an edge in u or v on the card, %d lit), "
        "fused and op-by-op dot, against the plain version on the card: %d "
        "values differ, max abs err %.3g; device kernels in one call: %s; "
        "%.4f ms a call (one launch, out of L2; median of %d %.4f, min %.4f, "
        "max %.4f; %.0f %% of the bound at the median), plain %.3f ms, bound "
        "%.4f ms (%s, %d B a lane) | %s" % (
            n, lit, len(edges), n_edge, edge_lit, nd, err, launched, ms,
            len(times), med, min(times), max(times), 100.0 * b_ms / med,
            plain_ms, b_ms, b_by, b_bytes, smi))
    assert nd == 0 and lit > n // 4, (nd, err, lit)
    assert n_edge >= 100_000, n_edge
    assert len(launched) == 1 and "stars_kernel" in launched[0], launched
    rows.append(dict(
        name="stars", route="cuda", source="luminary_tpu_torch/csrc/shading.cu",
        replaces="none: the float32 rounding of the reference's compiled CPU "
                 "code (glibc's sinf / cosf, a fused dot) at "
                 "luminary_tpu/ops/sky.py:131",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, lanes=n, glow_lanes=lit, edge_lanes=len(edges),
        edge_lanes_within_4_ulps=n_edge, cold_median_ms=med, cold_ms=times,
        device_kernels_a_call=launched))
    return rows


def _path_counts(zero=False) -> dict:
    """The launch counts of the main path's kernels (set to 0 first when
    ``zero``)."""
    from luminary_tpu_torch.ops import clouds as CL
    from luminary_tpu_torch.ops import libm
    from luminary_tpu_torch.ops import light_tree as LT
    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.ops import sky as S
    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops import camera as C
    from luminary_tpu_torch.ops import material as M
    from luminary_tpu_torch.ops import vec as V
    from luminary_tpu_torch.ops.vec import fma32

    counted = dict(camera_ray=C.generate_camera_rays, ray_point=V.ray_point,
                   make_frame=M.make_frame, frame_eval=M.frame_eval,
                   material_sample=M.material_sample, stars=S.stars_radiance,
                   cloud_march=CL.cloud_march,
                   cloud_shadow=CL.cloud_sun_transmittance)
    if zero:
        for fn in counted.values():
            fn.launches = 0
        fma32.launches = 0
        libm.libm_sincos.launches = 0
        RO.gather_soa.launches = 0
        RO.gather_soa.table_launches.clear()
        RO.unplanar.launches = 0
        TR.traverse_wide.launches = 0
        TR.traverse_wide.variant_launches.update(closest=0, any_hit=0)
        TR.traverse_wide.table_launches.clear()
        LT.light_tree_descend.launches = 0
    return {
        "gather_soa": RO.gather_soa.launches,
        "unplanar": RO.unplanar.launches,
        "traverse_wide.closest": TR.traverse_wide.variant_launches["closest"],
        "traverse_wide.any_hit": TR.traverse_wide.variant_launches["any_hit"],
        "light_tree_descend": LT.light_tree_descend.launches,
        "libm_sincos": libm.libm_sincos.launches,
        "fma32": fma32.launches,
        **{k: fn.launches for k, fn in counted.items()},
    }


# kernels that no render path launches: they stay in the package, held
# against their plain versions in phase 3, and the plain cloud march and
# star field run them on the card
NO_RENDER = ("fma32", "libm_sincos")
# the kernels of the cloud march and the cloud shadows: a path without
# clouds runs them no time
CLOUDS = ("cloud_march", "cloud_shadow")


def _assert_ran(counts, idle=CLOUDS, label=""):
    """Every kernel of the path was launched, but those in ``idle``, which
    this path does not run; those in NO_RENDER were launched no time."""
    missing = [k for k, v in counts.items()
               if v == 0 and k not in idle and k not in NO_RENDER]
    assert not missing, (label, missing, counts)
    ran = [k for k in NO_RENDER if counts[k]]
    assert not ran, (label, "launched on a render path", ran, counts)


# the stages under which the profile of a tree-1080p sample must find kernels
# A (the shade rows), B (closest and any hit) and C (the light tree)
PROFILE_KERNELS = (("gather_soa_kernel", "shade-row fetch"),
                   ("traverse_wide_kernel", "closest walk"),
                   ("traverse_wide_kernel", "shadow walk"),
                   ("light_tree_descend_kernel", "light NEE (RIS, light tree)"))


def profile_phase(r, smi) -> dict:
    """Phase 4b: utils/profiling.py profile_renderer on the tree-1080p
    renderer for one sample: the breakdown by stage, the device busy share
    (the kernels' device time summed over the profiled window's wall time,
    the profiler on), kernels A, B and C each under their stage."""
    import collections
    import shutil
    import tempfile

    from luminary_tpu_torch.utils import profiling as P

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    trace_dir = tempfile.mkdtemp(prefix="lum_profile_", dir=build)
    t0 = time.monotonic()
    rows = P.profile_renderer(r, samples=1, trace_dir=trace_dir)
    wall_s = time.monotonic() - t0
    events = P.stage_events(trace_dir)
    with open(os.path.join(trace_dir, P.TRACE_FILE)) as f:
        trace = json.load(f)["traceEvents"]
    window_ms = [e["dur"] / 1e3 for e in trace
                 if e.get("ph") == "X" and e.get("name") == P.WINDOW
                 and e.get("cat") == "user_annotation"][0]
    trace_mb = os.path.getsize(os.path.join(trace_dir, P.TRACE_FILE)) / 1e6
    shutil.rmtree(trace_dir, ignore_errors=True)
    device_ms = sum(ms for *_, ms, on_dev in events if on_dev)
    n_device = sum(1 for *_, on_dev in events if on_dev)
    by_stage = collections.defaultdict(collections.Counter)
    for stage, name, ms, on_dev in events:
        if on_dev:
            by_stage[stage or "other"][re.split(r"[(<]", name)[0].split(" ")[-1]] += ms
    total_pct = sum(p for _, _, p in rows)
    placed = {"%s under %s" % (k, st): round(by_stage[st][k], 4)
              for k, st in PROFILE_KERNELS}
    log("[profile] tree-1080p, 1 sample under torch.profiler (CPU and CUDA "
        "activity; %.1f s with the trace's export and summary, a %.1f MB "
        "trace): %d device kernels and copies, %.2f ms of a %.2f ms window, "
        "device busy %.1f %%; "
        "percentages sum to %.3f; kernels under their stage (ms) %s | %s\n%s"
        % (wall_s, trace_mb, n_device, device_ms, window_ms,
           100.0 * device_ms / window_ms,
           total_pct, placed, smi, P.format_breakdown(rows)))
    assert rows and abs(total_pct - 100.0) <= 1.0, total_pct
    missing = [k for k, v in placed.items() if v <= 0.0]
    assert not missing, (missing, {k: dict(v) for k, v in by_stage.items()})
    return dict(rows=rows, device_ms=device_ms, device_events=n_device,
                window_ms=window_ms,
                busy_share=device_ms / window_ms, wall_s=wall_s,
                trace_mb=trace_mb, kernels_by_stage={
                    k: dict(v.most_common(12)) for k, v in by_stage.items()})


# `python -m luminary_tpu_torch ARGS` as runpy runs it, printing the kernel
# launch counts of the process (from 0 at its start) when it exits
CLI_RUNNER = (
    "import atexit, json, runpy, sys\n"
    "import chip_smoke\n"
    "atexit.register(lambda: print('KERNEL_LAUNCHES ' + json.dumps("
    "chip_smoke._path_counts()), flush=True))\n"
    "sys.argv[0] = 'luminary_tpu_torch'\n"
    "runpy.run_module('luminary_tpu_torch', run_name='__main__', "
    "alter_sys=True)\n")


def product_path(repo, dev, smi, tree) -> dict:
    """Phase 7: the user-facing path on the tree-tier bench scene at 1080p.
    Every failed check raises."""
    import shutil

    import numpy as np
    import torch

    from luminary_tpu_torch.host.host import OUTPUT_HANDLE_INVALID, Host
    from luminary_tpu_torch.io.png import read_png
    from luminary_tpu_torch.io.wavefront import read_obj_file
    from luminary_tpu_torch.render.renderer import (
        AccumState,
        Renderer,
        _generate_image,
    )
    from luminary_tpu_torch.testing import benchmark_scene, write_obj_scene

    W, H = 1920, 1080
    out = {}
    work = os.path.join(repo, "build", "smoke_product")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # -- Host, no device argument: the card --
    host = Host()
    host.scene = benchmark_scene(W, H, max_depth=4)
    t0 = time.monotonic()
    r = host.renderer
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    assert r.device.type == "cuda", r.device
    _path_counts(zero=True)
    t0 = time.monotonic()
    promise = host.request_output(4)
    handle, polls = OUTPUT_HANDLE_INVALID, 0
    while handle == OUTPUT_HANDLE_INVALID:
        handle = host.try_await_output(promise)
        polls += 1
    host_s = time.monotonic() - t0
    counts = _path_counts()
    img = host.get_image(handle)
    assert img.dtype == np.uint8 and img.shape == (H, W, 3), (img.dtype, img.shape)
    assert int(img.max()) > 0, "the Host's image is black"
    assert host.get_image_meta(handle)["sample_count"] == 4
    acc_cpu = AccumState(*(t.cpu() for t in r.accum))
    plain = _generate_image(acc_cpu, *r.image_args()).numpy()
    diff = np.abs(img.astype(np.int16) - plain.astype(np.int16))
    assert int(diff.max()) <= 1, int(diff.max())
    img_ms = []
    for _ in range(5):
        t0 = time.monotonic()
        r.get_image()
        img_ms.append((time.monotonic() - t0) * 1e3)
    info = host.get_pixel_info(W // 2, H // 2)
    assert info is not None and info["pixel_query_is_valid"] and \
        info["instance_id"] >= 0, info
    dev_info = host.get_device_info(0)
    host_sps = host_s / 4
    log("[host] Host() on %s: pack %.2f s; request_output(4) in %d polls, "
        "%.3f s: %.4f s/sample (Renderer.render_samples in phase 4: %.4f "
        "s/sample); launches %s; image uint8 %s, mean %.2f, within one "
        "level of the plain CPU image (%d values differ by 1); pick (%d, %d) "
        "-> instance %d at depth %.3f | %s" % (
            dev_info["name"], pack_s, polls, host_s, host_sps,
            tree["seconds"] / tree["samples"], counts, img.shape,
            float(img.mean()), int((diff == 1).sum()), W // 2, H // 2,
            info["instance_id"], info["depth"], smi))
    log("[get_image] 1080p on the card: %.3f ms median of 5 (min %.3f), "
        "host copy included | %s" % (float(np.median(img_ms)), min(img_ms),
                                     smi))
    _assert_ran(counts)
    out["host"] = dict(pack_s=pack_s, seconds=host_s, s_per_sample=host_sps,
                       renderer_s_per_sample=tree["seconds"] / tree["samples"],
                       polls=polls, launches=counts,
                       image_mean=float(img.mean()),
                       off_by_one=int((diff == 1).sum()),
                       get_image_ms=img_ms, pick=info)

    # -- the property panel: one edit through the Host (camera pos.x + 0.5)
    # restarts accumulation; the next frame drawn to the viewer's
    # half-blocks --
    from luminary_tpu_torch.frontend.properties import PropertyPanel
    from luminary_tpu_torch.frontend.viewer import _image_to_halfblocks

    panel = PropertyPanel()
    x0 = host.get_camera().pos[0]
    assert panel.handle_key("e", host) and panel.handle_key(".", host)
    assert abs(host.get_camera().pos[0] - (x0 + 0.5)) < 1e-6
    promise = host.request_output(1)
    handle = OUTPUT_HANDLE_INVALID
    while handle == OUTPUT_HANDLE_INVALID:
        handle = host.try_await_output(promise)
    edit_samples = host.get_image_meta(handle)["sample_count"]
    frame = _image_to_halfblocks(host.get_image(handle), 96, 40)
    panel_lines = panel.render(host)
    assert edit_samples == 1 and r.sample_count == 1, (edit_samples, r.sample_count)
    assert frame.count("\n") == 39 and frame.count("\u2580") == 96 * 40
    log("[panel] PropertyPanel edit camera pos.x %.3f -> %.3f on the card Host: "
        "accumulation restarted (the next output holds %d sample, the "
        "renderer %d); one frame drawn to 96 x 40 half-blocks (%d characters), "
        "the panel %d lines | %s" % (x0, host.get_camera().pos[0], edit_samples,
                                     r.sample_count, len(frame),
                                     len(panel_lines), smi))
    out["panel"] = dict(samples_after_edit=edit_samples, frame_chars=len(frame),
                        panel_lines=len(panel_lines))
    host.destroy()
    del host, r, acc_cpu
    torch.cuda.empty_cache()

    # -- the asynchronous Host on an explicit "cuda": its device worker
    # thread renders the preview pyramid, then the samples --
    host = Host(device="cuda", asynchronous=True)
    host.scene = benchmark_scene(W, H, max_depth=4)
    _path_counts(zero=True)
    t0 = time.monotonic()
    promise = host.request_output(2)
    handle, polls = OUTPUT_HANDLE_INVALID, 0
    while handle == OUTPUT_HANDLE_INVALID:
        assert time.monotonic() - t0 < 300, "the asynchronous Host gave no image"
        handle = host.try_await_output(promise)  # raises a worker's error
        polls += 1
        time.sleep(0.01)
    async_s = time.monotonic() - t0
    counts = _path_counts()
    host.check_errors()
    r = host.renderer
    img = host.get_image(handle)
    n_async = host.get_image_meta(handle)["sample_count"]
    assert r.device == torch.device("cuda", torch.cuda.current_device()), \
        r.device
    assert img.dtype == np.uint8 and img.shape == (H, W, 3), (img.dtype, img.shape)
    assert int(img.max()) > 0 and n_async >= 2, n_async
    _assert_ran(counts)
    log("[host async] Host(device='cuda', asynchronous=True): "
        "request_output(2) answered by the device worker in %.3f s (pack and "
        "preview pyramid included, %d polls), %d samples, image mean %.2f; "
        "launches %s | %s" % (async_s, polls, n_async, float(img.mean()),
                              counts, smi))
    out["host_async"] = dict(seconds=async_s, polls=polls, samples=n_async,
                             image_mean=float(img.mean()), launches=counts)
    host.destroy()
    del host, r
    torch.cuda.empty_cache()

    # -- checkpoint / resume, bit for bit --
    ckpt = os.path.join(work, "ckpt.npz")
    ra = Renderer(benchmark_scene(W, H, max_depth=4), device=dev)
    ra.render_samples(2)
    ra.save_checkpoint(ckpt)
    ra.render_samples(2)
    rb = Renderer(benchmark_scene(W, H, max_depth=4), device=dev)
    rb.load_checkpoint(ckpt)
    _path_counts(zero=True)
    rb.render_samples(2)
    counts = _path_counts()
    same = all(torch.equal(a, b) for a, b in zip(ra.accum, rb.accum))
    log("[checkpoint] 2 samples, save, load into a fresh renderer, 2 more: "
        "accumulators bit-equal to 4 unbroken samples: %s; launches %s | %s"
        % (same, counts, smi))
    assert same, "a resumed render differs from an unbroken one"
    _assert_ran(counts)
    out["checkpoint"] = dict(bit_equal=same, launches=counts)
    del rb
    torch.cuda.empty_cache()

    # -- adaptive sampling: 2 uniform samples, then 6 in stages --
    st = ra.scene.get_entity("settings")
    st.enable_adaptive_sampling = True
    ra.scene.set_entity("settings", st)
    ra.render_samples(2)
    _path_counts(zero=True)
    t0 = time.monotonic()
    ra.render_samples(6)
    dt = time.monotonic() - t0
    counts = _path_counts()
    cnt = ra.accum.sample_count[: W * H].cpu().numpy()
    finite = bool(torch.isfinite(ra.accum.radiance).all())
    levels = np.unique(cnt)
    mrays = ra._last_rays_traced / dt / 1e6
    log("[adaptive] budget 2 + 6 samples at 1080p: stages in %.3f s, %.3f "
        "Mrays/s (%.0f rays); sample counts %d..%d over %d levels, mean %.3f; "
        "finite=%s; launches on the stage subsets %s | %s" % (
            dt, mrays, ra._last_rays_traced, int(cnt.min()), int(cnt.max()),
            len(levels), float(cnt.mean()), finite, counts, smi))
    assert len(levels) > 1, "adaptive sampling left a uniform sample map"
    assert finite
    assert counts["traverse_wide.closest"] > 0 and \
        counts["traverse_wide.any_hit"] > 0 and \
        counts["light_tree_descend"] > 0, counts
    out["adaptive"] = dict(seconds=dt, mrays=mrays,
                           rays=ra._last_rays_traced, launches=counts,
                           count_min=int(cnt.min()), count_max=int(cnt.max()),
                           count_mean=float(cnt.mean()), levels=len(levels))
    del ra
    torch.cuda.empty_cache()

    # -- adaptive stages on the card against the plain CPU path: the same
    # 2-sample accumulators, then a budget of 6 samples each, at 32x18 (a
    # 144-lane stage subset: kernel B's last packet is partly filled) --
    def small():
        sc = benchmark_scene(32, 18, max_depth=4)
        st = sc.get_entity("settings")
        st.enable_adaptive_sampling = True
        sc.set_entity("settings", st)
        return sc

    rg = Renderer(small(), device=dev)
    rg.render_samples(2)
    rp = Renderer(small(), device="cpu")
    rp.accum = AccumState(*(t.cpu() for t in rg.accum))
    _path_counts(zero=True)
    rg.render_samples(6)
    counts = _path_counts()
    t0 = time.monotonic()
    rp.render_samples(6)
    cpu_s = time.monotonic() - t0
    cnt_g = rg.accum.sample_count[: 32 * 18].cpu().numpy()
    cnt_p = rp.accum.sample_count[: 32 * 18].numpy()
    rad_g, rad_p = rg.get_radiance(), rp.get_radiance()
    rel = float(np.sqrt(np.mean((rad_g - rad_p) ** 2))
                / (np.abs(rad_p).mean() + 1e-6))
    map_diff = int((cnt_g != cnt_p).sum())
    log("[adaptive vs cpu] 32x18, 2 samples then a budget of 6 in stages: "
        "sample maps differ on %d of %d pixels (%d levels on the card); "
        "radiance RMSE/scale %.3g (bound 0.02); the plain CPU stages took "
        "%.2f s; card launches %s | %s" % (
            map_diff, cnt_g.size, len(np.unique(cnt_g)), rel, cpu_s, counts,
            smi))
    assert len(np.unique(cnt_g)) > 1, "adaptive sampling left a uniform map"
    assert map_diff == 0, "the card's adaptive sample map differs from the CPU's"
    assert np.isfinite(rad_g).all() and rel < 0.02, rel
    assert counts["traverse_wide.closest"] > 0 and \
        counts["traverse_wide.any_hit"] > 0 and \
        counts["light_tree_descend"] > 0, counts
    out["adaptive_vs_cpu"] = dict(map_diff=map_diff, rmse_over_scale=rel,
                                  levels=len(np.unique(cnt_g)), cpu_s=cpu_s,
                                  launches=counts)
    del rg, rp

    # -- the CLI on the scene written as OBJ/MTL + .lum --
    t0 = time.monotonic()
    lum = write_obj_scene(benchmark_scene(W, H, max_depth=4), work, "bench")
    written = read_obj_file(os.path.join(work, "bench.obj"))
    emitters = {i for i, m in enumerate(written.materials) if m.emission_active}
    n_tris = written.mesh.num_triangles
    n_emit = int(np.isin(written.mesh.material_ids, list(emitters)).sum())
    write_s = time.monotonic() - t0
    assert n_tris > 128 and n_emit >= 64, (n_tris, n_emit)
    env = dict(os.environ, PYTHONPATH=repo)
    runs = {}
    for label, args in (("render", ["-s", "4", "-o", "out.png"]),
                        ("bench", ["-b", "2", "smoke"])):
        t0 = time.monotonic()
        cp = subprocess.run([sys.executable, "-c", CLI_RUNNER, lum] + args,
                            cwd=work, env=env, capture_output=True, text=True,
                            timeout=600)
        wall = time.monotonic() - t0
        m = re.search(r"^KERNEL_LAUNCHES (.*)$", cp.stdout, re.M)
        counts = json.loads(m.group(1)) if m else {}
        runs[label] = dict(rc=cp.returncode, wall_s=wall, launches=counts,
                           stdout=cp.stdout[-2000:], stderr=cp.stderr[-4000:])
        assert cp.returncode == 0, (label, cp.returncode, cp.stderr[-4000:])
        assert counts, label
        _assert_ran(counts, label=label)
    png = read_png(os.path.join(work, "out.png"))
    assert png.shape[:2] == (H, W) and int(png.max()) > 0, png.shape
    m = re.search(r"rendered 4 spp in ([0-9.]+) s", runs["render"]["stdout"])
    render_s = float(m.group(1)) if m else float("nan")
    ladder = [os.path.exists(os.path.join(work, "Bench-%d-smoke.png" % k))
              for k in (1, 2, 3, 4)]
    csv = os.path.join(work, "BenchResults-smoke.txt")
    assert all(ladder) and os.path.exists(csv), (ladder, os.path.exists(csv))
    with open(csv) as f:
        rows = f.read().split()
    log("[cli] scene as OBJ/MTL + .lum (%d triangles, %d emitter "
        "triangles) in %.2f s; `-s 4 -o out.png`: rc 0, wall %.2f s, "
        "render %.3f s (%.4f s/sample; the renderer's pack included), PNG "
        "%dx%d mean %.2f, launches %s; `-b 2 smoke`: rc 0, wall %.2f s, "
        "ladder %s, launches %s | %s" % (
            n_tris, n_emit, write_s, runs["render"]["wall_s"], render_s,
            render_s / 4, png.shape[1], png.shape[0], float(png.mean()),
            runs["render"]["launches"], runs["bench"]["wall_s"], rows[1:],
            runs["bench"]["launches"], smi))
    out["cli"] = dict(runs=runs, triangles=n_tris, emitter_triangles=n_emit,
                      render_s=render_s, s_per_sample=render_s / 4,
                      ladder=rows[1:])

    # -- tools/compare.py over the ladder, against the 4-spp render --
    from luminary_tpu_torch.tools.compare import compare_ladder, format_row

    conv = compare_ladder(os.path.join(work, "out.png"), work, "smoke")
    log("[compare] the `-b 2 smoke` ladder against `-s 4`'s out.png "
        "(Convergence-smoke.csv):\n%s" % "\n".join(format_row(c) for c in conv))
    assert [c["spp"] for c in conv] == [1, 2, 3, 4], conv
    assert all(np.isfinite(c[k]) for c in conv
               for k in ("seconds", "rmse", "relmse", "flip_approx")), conv
    assert conv[0]["rmse"] > conv[-1]["rmse"], conv
    out["compare"] = conv
    shutil.rmtree(work, ignore_errors=True)
    return out


def content_path(dev, smi, cuda_ms, bound) -> dict:
    """Phase 8: scene content at full width (``content_scene(1920, 1080,
    4)``: textures, cutout cards, fog with 2-vertex bridges). Kernel A on the
    aux, micro-weight and 69-column light tables and kernel B any-hit on the
    shadow table against their plain versions; the transmission pass's time
    and memory; Mrays/s, the peak memory of a sample and the launches by
    table; the card against the plain CPU path at 64x36. Every failed check
    raises."""
    import numpy as np
    import torch

    from luminary_tpu_torch.ops import light_tree as LT
    from luminary_tpu_torch.ops import random as R
    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.camera import generate_camera_rays
    from luminary_tpu_torch.ops.intersect import MISS_DIST, ray_triangle
    from luminary_tpu_torch.ops.vec import Vec3, dot, normalize
    from luminary_tpu_torch.render.device_scene import (
        LSR_FUSED_MICRO_COLS,
        SHA_COLS,
        SHP_COLS,
        SHP_FACE,
        unpack_oct_snorm16,
    )
    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import content_scene

    W, H = 1920, 1080
    out = {}
    t0 = time.monotonic()
    r = Renderer(content_scene(W, H, 4), device=dev)
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    ds, cam, cfg = r.device_scene, r.device_camera, r.config
    bvh, lights, lrows = ds.geo.bvh, ds.lights, ds.light_slot_rows
    assert cfg.use_textures and cfg.use_aux_textures and cfg.use_bridges
    assert cfg.bridge_vertices == 2 and ds.fog.on and bvh.has_cutouts
    assert lights.has_micro and lights.has_tree
    assert lrows.shape[1] == LSR_FUSED_MICRO_COLS and bvh.cut_tris.shape[1] == 44
    tables = {"bvh rows": bvh.rows, "rows_shadow": bvh.rows_shadow,
              "cut_tris": bvh.cut_tris, "shade_hot": ds.shade_hot,
              "shade_aux": ds.shade_aux, "shade_micro": ds.shade_micro,
              "light_slot_rows": lrows, "micro_rows": lights.micro_rows,
              "texture rows": ds.textures.rows}
    sizes = {k: v.numel() * v.element_size() / 1e6 for k, v in tables.items()}
    n_cut = int((bvh.cut_tris[:, 9] < 1.0).sum())
    log("[content pack] %dx%d depth 4: %.2f s; %d slots, %d cutout triangles, "
        "%d lights (light rows C%d), %d texture pages; tables (MB) %s | %s" % (
            W, H, pack_s, bvh.tri_v0.x.shape[0], n_cut, lights.num_lights,
            lrows.shape[1], ds.textures.num_pages,
            ", ".join("%s %.2f" % kv for kv in sizes.items()), smi))
    out.update(pack_s=pack_s, table_mb=sizes, cutout_triangles=n_cut)

    # inputs: first-depth camera rays, their hits and shadow rays
    px, py = r._px, r._py
    n = px.shape[0]
    pixel_id = (py.long() * cfg.width + px.long()) & 0xFFFFFFFF
    sid = torch.tensor(0, dtype=torch.int64, device=dev)
    bn = R.blue_base(px, py)
    origin, direction = generate_camera_rays(cam, cfg.width, cfg.height, px, py,
                                             pixel_id, sid, bn=bn)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    tmax = torch.full((n,), MISS_DIST, device=dev)
    hit = TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth, origin,
                           direction, tmax, ones, False)
    valid = hit.slot >= 0
    slot = torch.where(valid, hit.slot, 0).int()

    # kernel A on the three new tables
    g = torch.Generator(device=dev).manual_seed(8)
    light_idx = torch.randint(0, lrows.shape[0], (n,), generator=g, device=dev,
                              dtype=torch.int32)
    a_rows = [kernel_a_case(label, table, idx, n_cols, 1, dev, cuda_ms, bound,
                            smi)
              for label, table, idx, n_cols in (
                  ("content aux rows C16", ds.shade_aux, slot, SHA_COLS),
                  ("content micro weights C16", ds.shade_micro, slot, 16),
                  ("content fused light rows C69", lrows, light_idx,
                   LSR_FUSED_MICRO_COLS))]
    out["kernel_a"] = a_rows

    # kernel B any-hit on the shadow table: sun and light shadow rays of the
    # camera hits
    t_safe = torch.where(valid, hit.t, 1.0)
    pos = Vec3(*(o + d * t_safe for o, d in zip(origin, direction)))
    srow = RO.gather_soa_plain(ds.shade_hot, slot, SHP_COLS)
    fx, fy, fz = unpack_oct_snorm16(srow[SHP_FACE])
    s_g = torch.where(fx * direction.x + fy * direction.y + fz * direction.z > 0,
                      -1.0, 1.0)
    so = Vec3(pos.x + fx * s_g * 1e-3, pos.y + fy * s_g * 1e-3,
              pos.z + fz * s_g * 1e-3)
    li = (pixel_id % lrows.shape[0]).long()
    tgt = Vec3(*(lrows[li, c] + (lrows[li, 3 + c] + lrows[li, 6 + c]) / 3.0
                 for c in range(3)))
    to_l = Vec3(tgt.x - so.x, tgt.y - so.y, tgt.z - so.z)
    dist = torch.sqrt(dot(to_l, to_l))
    l_dir = normalize(to_l)
    sun = ds.sky.sun_dir
    sh_o = Vec3(*(torch.cat([c, c]) for c in so))
    sh_d = Vec3(torch.cat([sun[0].expand(n), l_dir.x]),
                torch.cat([sun[1].expand(n), l_dir.y]),
                torch.cat([sun[2].expand(n), l_dir.z]))
    sh_t = torch.cat([tmax, dist - 2e-3])
    sh_a = torch.cat([valid, valid])
    rs = bvh.rows_shadow
    occ = TR.traverse_wide(rs, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t, sh_a,
                           True)
    ix2 = torch.arange(0, 2 * n, 7, device=dev)

    def sub(v, ix):
        return Vec3(*(c[ix] for c in v))

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    occ_ref = TR.traverse_wide_plain(rs, bvh.num_nodes, bvh.depth, sub(sh_o, ix2),
                                     sub(sh_d, ix2), sh_t[ix2], sh_a[ix2], True)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    kernel_only = ix2[torch.nonzero(occ[ix2] & ~occ_ref).flatten()]
    plain_only = ix2[torch.nonzero(~occ[ix2] & occ_ref).flatten()]
    # the opaque slots: those whose triangle the shadow table keeps
    leaf = rs[bvh.num_nodes:, 42:126].reshape(-1, 6, TR.WIDE_LEAF)
    opaque = (leaf != 0).any(dim=1).reshape(-1)
    op = torch.nonzero(opaque).flatten()
    tris = [Vec3(*(c[op][None] for c in v))
            for v in (bvh.tri_v0, bvh.tri_e1, bvh.tri_e2)]
    confirmed = 0
    for a in range(0, kernel_only.numel(), 32):
        lanes = kernel_only[a:a + 32]
        t, _u, _v, h = ray_triangle(Vec3(*(c[lanes, None] for c in sh_o)),
                                    Vec3(*(c[lanes, None] for c in sh_d)), *tris)
        confirmed += int((h & (t < sh_t[lanes, None])).any(dim=1).sum())
    log("[kernel B any-hit, shadow table] %d lanes vs plain: %d only the kernel "
        "finds occluded (%d confirmed by brute force over the %d opaque "
        "triangles), %d only the plain walk; %d occluded" % (
            ix2.numel(), kernel_only.numel(), confirmed, op.numel(),
            plain_only.numel(), int(occ_ref.sum())))
    assert plain_only.numel() == 0 and confirmed == kernel_only.numel(), (
        int(plain_only.numel()), int(kernel_only.numel()), confirmed)
    ms = cuda_ms(lambda: TR.traverse_wide(rs, bvh.num_nodes, bvh.depth, sh_o,
                                          sh_d, sh_t, sh_a, True))
    stats = {}
    TR.traverse_wide(rs, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t, sh_a, True,
                     stats=stats)
    own = per_ray_tests(rs, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t, sh_a,
                        True)
    b_ms, b_by = bound(2 * n * 32 + 2 * n + rs.numel() * 4,
                       own["node_tests"] * SLAB_OPS + own["tri_tests"] * TRI_OPS)
    log("[kernel B any-hit, shadow table] %d rays: %.3f ms, plain %.3f ms on "
        "%d of them, bound %.4f ms (%s; the rays' own walks %d slab + %d "
        "triangle tests, the 32-ray packets %d + %d) | %s" % (
            2 * n, ms, plain_ms, ix2.numel(), b_ms, b_by, own["node_tests"],
            own["tri_tests"], stats["node_tests"], stats["tri_tests"], smi))
    out["kernel_b_any_hit_shadow"] = dict(
        rays=2 * n, ms=ms, plain_ms=plain_ms, plain_lanes=int(ix2.numel()),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        kernel_only_confirmed_lanes=confirmed, checked_lanes=int(ix2.numel()),
        tests=own, packet_tests=stats)

    # the transmission pass (plain PyTorch) at this shape: time (after one
    # call that grows the allocator) and memory
    tr_act = sh_a & ~occ
    TR.trace_transmission(bvh, sh_o, sh_d, sh_t, active=tr_act)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    trans = TR.trace_transmission(bvh, sh_o, sh_d, sh_t, active=tr_act)
    torch.cuda.synchronize()
    tr_s = time.monotonic() - t0
    tr_peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    log("[transmission] %d cutout triangles x %d active shadow lanes in blocks "
        "of %d elements: %.3f s, peak %.1f MB above the %.1f MB in use; %d lanes "
        "partly transparent | %s" % (
            bvh.cut_tris.shape[0], int(tr_act.sum()), TR.TRANSMISSION_BLOCK, tr_s,
            tr_peak, base / 1e6, int(((trans > 0) & (trans < 1)).sum()), smi))
    out["transmission"] = dict(seconds=tr_s, peak_mb=tr_peak, base_mb=base / 1e6,
                               block=TR.TRANSMISSION_BLOCK)
    del hit, occ, occ_ref, trans, sh_o, sh_d, sh_t, sh_a, srow, tr_act, pos, so
    torch.cuda.empty_cache()

    # the path: Mrays/s over a block, the peak memory of a sample, launches
    r.render_samples(1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r.render_samples(1)
    peak = torch.cuda.max_memory_allocated()
    _path_counts(zero=True)
    block = 3
    t0 = time.monotonic()
    r.render_samples(block)
    dt = time.monotonic() - t0
    counts = _path_counts()
    names = {ds.shade_hot.data_ptr(): "shade_hot C16",
             ds.shade_aux.data_ptr(): "shade_aux C16",
             ds.shade_micro.data_ptr(): "shade_micro C16",
             lrows.data_ptr(): "light rows C69 (and its 18-col block)",
             lights.micro_rows.data_ptr(): "micro_rows C16",
             ds.sky.aerial_rows.data_ptr(): "aerial C128",
             ds.sky.env_rows.data_ptr(): "env C16",
             ds.ggx_quad.data_ptr(): "ggx quad C4"}
    by_table = {names.get(k, "other"): v
                for (_, k), v in RO.gather_soa.table_launches.items()}
    b_names = {("closest", dev, bvh.rows.data_ptr()): "closest, main table",
               ("any_hit", dev, bvh.rows.data_ptr()): "any-hit, main table",
               ("any_hit", dev, rs.data_ptr()): "any-hit, shadow table"}
    b_by_table = {v: TR.traverse_wide.table_launches.get(k, 0)
                  for k, v in b_names.items()}
    mrays = r._last_rays_traced / dt / 1e6
    acc = r.accum.radiance[:W * H]
    finite = bool(torch.isfinite(acc).all())
    log("[content path] %dx%d depth 4, fog + 2-vertex bridges, cutouts, "
        "textures: %d samples in %.3f s: %.3f Mrays/s (%.0f rays); peak memory "
        "of a sample %.1f MB (%.1f MB above the %.1f MB before it); launches "
        "%s; kernel A by table %s; kernel B %s; finite=%s | %s" % (
            W, H, block, dt, mrays, r._last_rays_traced, peak / 1e6,
            (peak - base) / 1e6, base / 1e6, counts, by_table, b_by_table,
            finite, smi))
    assert finite and float(acc.sum()) > 0.0
    assert counts["unplanar"] > 0 and counts["light_tree_descend"] > 0, counts
    for k in ("shade_hot C16", "shade_aux C16", "shade_micro C16",
              "light rows C69 (and its 18-col block)"):
        assert by_table.get(k, 0) > 0, (k, by_table)
    assert b_by_table["closest, main table"] > 0, b_by_table
    assert b_by_table["any-hit, shadow table"] > 0, b_by_table
    out["path"] = dict(samples=block, seconds=dt, mrays=mrays,
                       rays=r._last_rays_traced, peak_mb=peak / 1e6,
                       peak_above_mb=(peak - base) / 1e6, launches=counts,
                       kernel_a_by_table=by_table, kernel_b_by_table=b_by_table)
    del r, acc
    torch.cuda.empty_cache()

    # the card against the plain CPU path: 64x36, depth 4, 2 samples
    imgs = {}
    for d in (dev, "cpu"):
        rr = Renderer(content_scene(64, 36, 4), device=d)
        t0 = time.monotonic()
        rr.render_samples(2)
        imgs[str(d)] = (rr.get_radiance(), time.monotonic() - t0)
    (img_g, _), (img_c, cpu_s) = imgs[str(dev)], imgs["cpu"]
    rel = float(np.sqrt(np.mean((img_g - img_c) ** 2)) / (np.abs(img_c).mean() + 1e-6))
    log("[content vs cpu] 64x36 depth 4, 2 samples: card against the plain CPU "
        "path RMSE/scale %.3g (bound 1e-3), max abs %.3g; the CPU took %.1f s "
        "| %s" % (rel, float(np.abs(img_g - img_c).max()), cpu_s, smi))
    assert np.isfinite(img_g).all() and rel < 1e-3, rel
    out["card_vs_cpu"] = dict(rmse_over_scale=rel, cpu_s=cpu_s)
    return out


def _density_bound_ms(evals) -> float:
    """The least time for ``evals`` cloud density evaluations: their float64
    flops at the fp64 rate or their float32 flops at the fp32 rate, the
    larger (the two pipes run side by side); the bytes are far below."""
    return max(evals * DENSITY_FP64 / FP64_FLOPS,
               evals * DENSITY_FP32 / FP32_FLOPS) * 1e3


class _LaunchTimes:
    """CUDA events around each launch of the kernel entry points ``names``
    (``kernels.entry``'s functions, wrapped while the block runs)."""

    def __init__(self, names):
        self.rec = {n: [] for n in names}

    def __enter__(self):
        import torch

        from luminary_tpu_torch import kernels

        self.orig = orig = kernels.entry

        def entry(name, fn, argtypes):
            f = orig(name, fn, argtypes)
            if fn not in self.rec:
                return f

            def timed(*a):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                rc = f(*a)
                e1.record()
                self.rec[fn].append((e0, e1))
                return rc
            return timed
        kernels.entry = entry
        return self

    def __exit__(self, *exc):
        from luminary_tpu_torch import kernels

        kernels.entry = self.orig

    def ms(self, name):
        import torch

        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.rec[name]]


class _Capture:
    """The arguments of the first call of each of ``ops/clouds.py``'s kernel
    wrappers while the block runs (the launch counters stay on the public
    functions)."""

    NAMES = ("_cloud_march_kernel", "_cloud_sun_transmittance_kernel")

    def __enter__(self):
        from luminary_tpu_torch.ops import clouds as CL

        self.args, self.orig = {}, {n: getattr(CL, n) for n in self.NAMES}
        for n, fn in self.orig.items():
            def wrap(*a, _n=n, _fn=fn):
                self.args.setdefault(_n, a)
                return _fn(*a)
            setattr(CL, n, wrap)
        return self

    def __exit__(self, *exc):
        from luminary_tpu_torch.ops import clouds as CL

        for n, fn in self.orig.items():
            setattr(CL, n, fn)


def _cloud_kernel_check(label, name, args, smi) -> dict:
    """One call of a cloud kernel wrapper (``name``: march or shadow) on the
    captured arguments against its plain version on the card, bit for bit:
    the kernel's launches timed alone (CUDA events), the plain call timed,
    the density evaluations the plain version makes (the kernel makes the
    same) counted for the bound."""
    import torch

    from luminary_tpu_torch.ops import clouds as CL

    march = name == "cloud_march"
    kern = CL._cloud_march_kernel if march else CL._cloud_sun_transmittance_kernel
    plain = CL._cloud_march_plain if march else CL._cloud_sun_transmittance_plain
    entry = "lum_cloud_march" if march else "lum_cloud_shadow"
    lanes = args[1].x.shape[0]
    kern(*args)  # warm (the build, the first launch)
    with _LaunchTimes([entry]) as lt:
        got = kern(*args)
        launch_ms = lt.ms(entry)
    evals, density = {}, CL.cloud_density

    def counted(cl, pos, layer=0, fused=False):
        evals[layer] = evals.get(layer, 0) + pos.x.numel()
        return density(cl, pos, layer, fused)

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    CL.cloud_density = counted
    try:
        e0.record()
        want = plain(*args)
        e1.record()
        torch.cuda.synchronize()
    finally:
        CL.cloud_density = density
    plain_ms = e0.elapsed_time(e1)
    flat = lambda v: [*v[0], v[1]] if march else [v]  # noqa: E731
    exact = all(same_bits(a, b) for a, b in zip(flat(got), flat(want)))
    n_evals = sum(evals.values())
    b_ms = _density_bound_ms(n_evals)
    ms = sum(launch_ms)
    layers = sorted(evals)
    per_layer = ", ".join(
        "layer %d %.3f ms against its bound %.3f (%d evaluations)" % (
            ly, t, _density_bound_ms(evals[ly]), evals[ly])
        for ly, t in zip(layers, launch_ms)) if march else ""
    log("[%s %s] %d lanes: %d launches, %.3f ms (%s%s), %.0f %% of the "
        "operations bound %.3f ms (%d density evaluations); plain on the card "
        "%.1f ms; bit for bit: %s | %s" % (
            name, label, lanes, len(launch_ms), ms,
            " + ".join("%.3f" % t for t in launch_ms),
            "; " + per_layer if per_layer else "", 100.0 * b_ms / ms, b_ms,
            n_evals, plain_ms, exact, smi))
    assert exact, (name, label)
    return dict(case=label, lanes=lanes, launches=len(launch_ms),
                launch_ms=launch_ms, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="operations", density_evals=n_evals,
                density_evals_by_layer=evals)


def sky_sea_path(dev, smi, cuda_ms, bound, tree) -> dict:
    """Phase 9: sky and sea at full width (``outdoor_scene(1920, 1080, 4)``:
    the bench field at sea, the analytic ocean with water scattering and
    sun caustics, the low and mid cloud layers), in two variants: (a) the
    DEFAULT sky with the cloud march on the miss side and cloud shadows,
    (b) the HDRI sky baked at 2048 x 1024 with the clouds in the map and env
    NEE (the shadow batch at its full 5 segments). For each: the pack (and
    for (b) the HDRI bake) seconds, the peak memory of a sample, Mrays/s over
    a block beside tree-1080p's, the launches from 0 of A, unplanar, B
    closest, B any-hit and C, the rays of each any-hit launch and the time of
    each call of the ocean march, the cloud march and the caustic
    connection. Kernel B any-hit on (b)'s 5-segment batch (and its first 3
    segments) against its plain version under phase 3's rule; the card
    against the plain CPU path at 64x36 (clouds off within 1e-3, on within
    1e-2); the ``clouds_32`` golden. Every failed check raises."""
    import numpy as np
    import torch

    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.sky import stars_radiance
    from luminary_tpu_torch.ops.vec import Vec3
    from luminary_tpu_torch.render import device_scene as D
    from luminary_tpu_torch.render import wavefront as WF
    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import clouds_scene, outdoor_scene

    W, H = 1920, 1080
    out = {}
    marches = ("ocean_intersect", "ocean_crosses", "cloud_march",
               "cloud_sun_transmittance", "sample_caustic_connection")

    def instrumented_sample(r, capture):
        """One sample with each march's calls timed by CUDA events and the
        rays of each any-hit launch recorded (``capture``: the largest
        any-hit batch's inputs are kept)."""
        calls, sizes, saved = {}, [], {}
        orig = {m: getattr(WF, m) for m in marches}
        orig_launch = TR._launch

        def timed(name, fn):
            def wrap(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                res = fn(*a, **k)
                e1.record()
                torch.cuda.synchronize()
                calls.setdefault(name, []).append(e0.elapsed_time(e1))
                return res
            return wrap

        def launch(rows, num_nodes, depth, origin, direction, t_max, active,
                   any_hit, stats):
            if any_hit and stats is None:
                n_ = origin.x.shape[0]
                sizes.append(n_)
                if capture and n_ > saved.get("n", 0):
                    saved.update(n=n_, rows=rows, o=origin, d=direction,
                                 t=t_max, a=active)
            return orig_launch(rows, num_nodes, depth, origin, direction,
                               t_max, active, any_hit, stats)

        for m in marches:
            setattr(WF, m, timed(m, orig[m]))
        TR._launch = launch
        try:
            r.render_samples(1)
            torch.cuda.synchronize()
        finally:
            for m in marches:
                setattr(WF, m, orig[m])
            TR._launch = orig_launch
        return calls, sizes, saved

    for label, mode in (("a", 0), ("b", 1)):
        v = {}
        scene = outdoor_scene(W, H, 4, sky_mode=mode)
        if mode == 1:
            _path_counts(zero=True)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with _Capture() as bake:
                D.pack_sky(scene, dev)
                torch.cuda.synchronize()
            v["hdri_bake_s"] = time.monotonic() - t0
            v["hdri_bake_launches"] = bc = _path_counts()
            log("[sky-sea b] the HDRI bake at %d x %d: %.3f s (the cloud "
                "march's plain version alone takes seconds: see the next "
                "line); launches %s | %s" % (
                    bake.args["_cloud_march_kernel"][1].x.shape[0] // 1024, 1024,
                    v["hdri_bake_s"], {k: c for k, c in bc.items() if c}, smi))
            assert bc["cloud_march"] == 2 and bc["stars"] == 1, bc
            v["bake_march"] = _cloud_kernel_check(
                "HDRI bake", "cloud_march", bake.args["_cloud_march_kernel"], smi)
            del bake
        t0 = time.monotonic()
        r = Renderer(scene, device=dev)
        torch.cuda.synchronize()
        v["pack_s"] = time.monotonic() - t0
        ds, cfg = r.device_scene, r.config
        assert cfg.analytic_ocean and cfg.water_scatter and cfg.ocean_caustics
        assert cfg.cloud_layers == (0, 1)
        assert cfg.use_clouds == (mode == 0) and cfg.env_nee == (mode == 1)
        segs = 2 + (mode == 1) + 2
        r.render_samples(1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r.render_samples(1)
        v["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        v["peak_above_mb"] = v["peak_mb"] - base / 1e6
        _path_counts(zero=True)
        block = 3
        t0 = time.monotonic()
        r.render_samples(block)
        dt = time.monotonic() - t0
        counts = _path_counts()
        v.update(samples=block, seconds=dt, rays=r._last_rays_traced,
                 mrays=r._last_rays_traced / dt / 1e6, launches=counts,
                 rays_per_sample=r._last_rays_per_sample)
        # the clouds are marched, and the stars lit, in sky mode 0 only
        _assert_ran(counts, idle=() if cfg.use_clouds else CLOUDS + ("stars",),
                    label=label)
        with _Capture() as cap:
            calls, sizes, saved = instrumented_sample(r, capture=mode == 1)
        if cfg.use_clouds:
            ms = calls["cloud_march"][0]
            log("[sky-sea a] the miss-side cloud march: %.1f ms a call, the "
                "PyTorch setup of each layer's launch included | %s" % (ms, smi))
            v["march"] = _cloud_kernel_check(
                "outdoor-1080p (a) misses", "cloud_march",
                cap.args["_cloud_march_kernel"], smi)
            v["shadow"] = _cloud_kernel_check(
                "outdoor-1080p (a) sun candidates", "cloud_shadow",
                cap.args["_cloud_sun_transmittance_kernel"], smi)
        del cap
        v["march_ms"] = {m: dict(calls=len(c), ms_per_call=float(np.mean(c)),
                                 ms=[float(x) for x in c])
                         for m, c in calls.items()}
        v["rays_per_any_hit_launch"] = sizes
        n = r._px.shape[0]
        assert sizes and max(sizes) == segs * n, (sizes, segs, n)
        acc = r.accum.radiance[:W * H]
        finite = bool(torch.isfinite(acc).all())
        assert finite and float(acc.sum()) > 0.0
        log("[sky-sea %s] %dx%d depth 4, %s sky, ocean + caustics + clouds "
            "low/mid: pack %.2f s%s; peak memory of a sample %.1f MB (%.1f MB "
            "above the %.1f MB before it); %d samples in %.3f s: %.3f Mrays/s "
            "(tree-1080p %.3f in this run; %.0f rays/sample); launches %s; "
            "rays per any-hit launch %s | %s" % (
                label, W, H, "DEFAULT" if mode == 0 else "HDRI 2048x1024",
                v["pack_s"], (", HDRI bake %.2f s" % v["hdri_bake_s"])
                if mode == 1 else "", v["peak_mb"], v["peak_above_mb"],
                base / 1e6, block, dt, v["mrays"], tree["mrays"],
                v["rays_per_sample"], counts, sizes, smi))
        log("[sky-sea %s marches] ms per call (calls in one sample): %s | %s" % (
            label, ", ".join("%s %.3f (%d)" % (m, c["ms_per_call"], c["calls"])
                             for m, c in v["march_ms"].items()), smi))
        if mode == 1:
            v["kernel_b"] = _any_hit_on_batch(saved, n, ds, cuda_ms, bound, smi)
        out[label] = v
        del r, acc, saved
        torch.cuda.empty_cache()

    # the card against the plain CPU path: 64x36, depth 4, 2 samples, on the
    # same sky tables (packed on the CPU and carried to the card: with env
    # NEE the alias table of a map baked apart decides other cells). The
    # card's own bake is held against the CPU's apart, off the stars' texels
    # (the stars are a 3e-4 rad Gaussian in float32, whose texels differ):
    # RMSE/scale under 1e-4 (1.03e-5 to 1.06e-5 measured on an H100). A
    # pixel more than 1e-2 of the scale apart took another decision on the
    # card (a miss direction at the solar disc's edge, from ulps of the
    # sampling's transcendentals; one such pixel of 2304 measured in (a), a
    # lane traced to it): at most 2 may, and the bound holds on the rest.
    out["card_vs_cpu"] = {}
    for mode in (0, 1):
        for clouds in (False, True):
            def make():
                return outdoor_scene(64, 36, 4, sky_mode=mode, clouds=clouds,
                                     hdri_dim=256)
            sky_c = D.pack_sky(make(), "cpu")
            sky_g = D.pack_sky(make(), dev)
            env_c = sky_c.env_rows[:, :3].numpy()  # each texel's own rgb
            env_g = sky_g.env_rows[:, :3].cpu().numpy()
            bake_rel = float(np.sqrt(np.mean((env_g - env_c) ** 2))
                             / (np.abs(env_c).mean() + 1e-12))
            # the same off the stars' texels (HDRI maps hold the stars)
            dirs = torch.as_tensor(D._latlong_dirs(sky_c.env_h, sky_c.env_w))
            star = (stars_radiance(sky_c, Vec3(*dirs.unbind(1)))[1] > 0.0).numpy()
            bake_rel_off = float(np.sqrt(np.mean((env_g - env_c)[~star] ** 2))
                                 / (np.abs(env_c).mean() + 1e-12))
            imgs = {}
            for d in (dev, "cpu"):
                rr = Renderer(make(), device=d)
                rr.device_scene = rr.device_scene._replace(sky=dataclasses.replace(
                    sky_c, **{f.name: getattr(sky_c, f.name).to(d)
                              for f in dataclasses.fields(sky_c)
                              if isinstance(getattr(sky_c, f.name), torch.Tensor)}))
                t0 = time.monotonic()
                rr.render_samples(2)
                imgs[str(d)] = (rr.get_radiance(), time.monotonic() - t0)
            (img_g, _), (img_c, cpu_s) = imgs[str(dev)], imgs["cpu"]
            key = "%s clouds %s" % ("a" if mode == 0 else "b",
                                    "on" if clouds else "off")
            v = _card_vs_cpu(img_g, img_c, 1e-2 if clouds else 1e-3, 2)
            v.update(cpu_s=cpu_s, sky_bake_rmse_over_scale=bake_rel,
                     sky_bake_off_stars=bake_rel_off, sky_bake_bound=1e-4)
            v["ok"] = v["ok"] and bake_rel_off < 1e-4
            log("[sky-sea vs cpu] %s, 64x36 depth 4, 2 samples: card against "
                "the plain CPU path RMSE/scale %.3g over all pixels, %d of %d "
                "pixels another decision (over 1e-2 of the scale apart, at most "
                "%d), %.3g over the rest (bound %g); max abs %.3g; the card's "
                "sky bake against the CPU's RMSE/scale %.3g (%.3g off the "
                "stars' texels, bound 1e-4); the CPU took %.1f s | %s" % (
                    key, v["rmse_over_scale"], v["other_decision_pixels"],
                    v["pixels"], v["max_other"], v["rest_rmse_over_scale"],
                    v["bound"],
                    v["max_abs"], bake_rel, bake_rel_off, cpu_s, smi))
            assert np.isfinite(img_g).all() and v["ok"], (key, v)
            out["card_vs_cpu"][key] = v

    # the clouds_32 golden on the card, under tests/test_torch_golden_sky.py's
    # rule: RMSE/scale < 0.02 over the whole image and at most 5 pixels more
    # than 1e-2 of the scale apart (3 on an x86 CPU, where the march parts
    # from the reference's in 37 of 65,536 lanes on equal inputs). And the
    # card against the plain CPU path, at most 8 pixels another decision
    # (3 measured on an H100 before the port took the reference's rounding).
    repo = os.path.dirname(os.path.abspath(__file__))
    ref = np.load(os.path.join(repo, "tests", "golden", "clouds_32_64spp.npy"))
    rg = Renderer(clouds_scene(), device=dev)
    rg.render_samples(64)
    img = rg.get_radiance()
    scale = float(np.abs(ref).mean()) + 1e-6
    rel = float(np.sqrt(np.mean((img - ref) ** 2)) / scale)
    apart = np.abs(img - ref).max(axis=-1) > 1e-2 * scale
    rc = Renderer(clouds_scene(), device="cpu")
    rc.render_samples(64)
    v = _card_vs_cpu(img, rc.get_radiance(), 1e-2, 8)
    log("[golden] clouds_32 at 64 spp on the card: RMSE/scale %.4g against "
        "the golden over the image (bound 0.02), %d of %d pixels more than "
        "1e-2 of the scale apart (at most 5); the card against the plain CPU "
        "path RMSE/scale %.3g over all pixels, %d pixels another decision (at "
        "most 8), %.3g over the rest (bound 1e-2) | %s" % (
            rel, int(apart.sum()), apart.size, v["rmse_over_scale"],
            v["other_decision_pixels"], v["rest_rmse_over_scale"], smi))
    assert np.isfinite(img).all() and rel < 0.02 and apart.sum() <= 5, (
        rel, int(apart.sum()))
    assert v["ok"], v
    out["clouds_32"] = dict(rmse_over_scale=rel, apart_pixels=int(apart.sum()),
                            card_vs_cpu=v)
    return out


def optics_path(dev, smi, cuda_ms, bound, tree, size=(1920, 1080)) -> dict:
    """Phase 10: the optics slice at full width (``optics_scene(1920, 1080,
    4)``: the bench field with a moving particle field at the reference's
    defaults, spectral rendering under the DEFAULT sky's 8-band bake, the
    physical lens camera), (a) as it is and (b) with the wavefront sort on.
    For each: the pack seconds (the 8-band bake timed apart, once), the
    peak memory of a sample, Mrays/s over a block beside tree-1080p's, the
    launches from 0 of A (the 32-column 8-band env rows apart), unplanar, B
    closest (the particle table apart), B any-hit and C, and the time of
    each call of the particle tile walk, each of its kernel-B launches, the
    lens trace and the spectral resolve. Kernel B closest on the particle
    BVH against its plain walk under phase 3's rule, with its bound from
    each ray's own walk; kernel A at C32 on the 8-band env rows bit for bit
    with its bytes bound; the card against the plain CPU path at 64x36 on
    the same tables, with the lanes whose lens trace decided otherwise
    counted. Every failed check raises."""
    import numpy as np
    import torch

    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.camera_physical import (
        generate_physical_camera_rays,
    )
    from luminary_tpu_torch.ops.procedural import PARTICLES_INSTANCE_ID
    from luminary_tpu_torch.render import device_scene as D
    from luminary_tpu_torch.render import wavefront as WF
    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import optics_scene

    W, H = size
    out = {}
    timed_fns = ("_particle_tier", "generate_physical_camera_rays",
                 "resolve_to_rgb")

    def instrumented_sample(r, ptable, spec_table):
        """One sample with each call of the timed functions and each
        particle-table launch of kernel B timed by CUDA events; the inputs
        of depth 0's three particle launches and of each 8-band row fetch
        kept."""
        calls, saved = {}, {}
        orig = {f: getattr(WF, f) for f in timed_fns}
        orig_launch, orig_a = TR._launch, RO._launch

        def events():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            return e0, e1

        def timed(name, fn):
            def wrap(*a, **k):
                e0, e1 = events()
                res = fn(*a, **k)
                e1.record()
                torch.cuda.synchronize()
                calls.setdefault(name, []).append(e0.elapsed_time(e1))
                return res
            return wrap

        def launch(rows, num_nodes, depth, origin, direction, t_max, active,
                   any_hit, stats):
            if rows.data_ptr() != ptable or any_hit or stats is not None:
                return orig_launch(rows, num_nodes, depth, origin, direction,
                                   t_max, active, any_hit, stats)
            if len(saved.setdefault("b", [])) < 3:  # depth 0's segments
                saved["b"].append(dict(o=origin, d=direction, t=t_max,
                                       a=active))
            e0, e1 = events()
            res = orig_launch(rows, num_nodes, depth, origin, direction, t_max,
                              active, any_hit, stats)
            e1.record()
            torch.cuda.synchronize()
            calls.setdefault("kernel B particle launch", []).append(
                e0.elapsed_time(e1))
            return res

        def launch_a(table, idx, n_cols, sub_stride):
            if table.data_ptr() == spec_table:
                saved.setdefault("a", []).append(idx)
            return orig_a(table, idx, n_cols, sub_stride)

        for f in timed_fns:
            setattr(WF, f, timed(f, orig[f]))
        TR._launch, RO._launch = launch, launch_a
        try:
            r.render_samples(1)
            torch.cuda.synchronize()
        finally:
            for f in timed_fns:
                setattr(WF, f, orig[f])
            TR._launch, RO._launch = orig_launch, orig_a
        return calls, saved

    for label, sort in (("a", False), ("b", True)):
        v = {}
        scene = optics_scene(W, H, 4, sort=sort)
        if not sort:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            D.bake_sky_spectral(scene, max(128, min(1024, 2 * W)), dev)
            torch.cuda.synchronize()
            v["spectral_bake_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        r = Renderer(scene, device=dev)
        torch.cuda.synchronize()
        v["pack_s"] = time.monotonic() - t0
        ds, cfg = r.device_scene, r.config
        pt = ds.particles
        assert cfg.use_particles and cfg.spectral and cfg.use_physical_camera
        assert cfg.sort_wavefront == sort and cfg.shading_mode == 0
        assert pt.bvh.tri_v0.x.shape[0] >= 2 * 8192 and ds.sky.env_spec_rows.shape[1] == 32
        ptable, spec_table = pt.bvh.rows.data_ptr(), ds.sky.env_spec_rows.data_ptr()
        r.render_samples(1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r.render_samples(1)
        v["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
        v["peak_above_mb"] = v["peak_mb"] - base / 1e6
        _path_counts(zero=True)
        block = 3
        t0 = time.monotonic()
        r.render_samples(block)
        dt = time.monotonic() - t0
        counts = _path_counts()
        counts["traverse_wide.closest particle table"] = \
            TR.traverse_wide.table_launches.get(("closest", dev, ptable), 0)
        counts["gather_soa env_spec_rows C32"] = \
            RO.gather_soa.table_launches.get((dev, spec_table), 0)
        v.update(samples=block, seconds=dt, rays=r._last_rays_traced,
                 mrays=r._last_rays_traced / dt / 1e6, launches=counts,
                 rays_per_sample=r._last_rays_per_sample)
        # the lens camera traces its own primary rays (no camera_ray)
        _assert_ran(counts, idle=CLOUDS + ("camera_ray",), label=label)
        calls, saved = instrumented_sample(r, ptable, spec_table)
        v["ms_per_call"] = {f: dict(calls=len(c), ms_per_call=float(np.mean(c)),
                                    ms=[float(x) for x in c])
                            for f, c in calls.items()}
        acc = r.accum.radiance[:W * H]
        ids = r.gbuffer.instance_id[:W * H]
        v["particle_pixels"] = int((ids == PARTICLES_INSTANCE_ID).sum())
        assert bool(torch.isfinite(acc).all()) and float(acc.sum()) > 0.0
        assert v["particle_pixels"] > 0
        log("[optics %s] %dx%d depth 4, particles (8,192 quads) + spectral "
            "(8-band DEFAULT sky) + physical camera%s: pack %.2f s%s; peak "
            "memory of a sample %.1f MB (%.1f MB above the %.1f MB before it); "
            "%d samples in %.3f s: %.3f Mrays/s (tree-1080p %.3f in this run; "
            "%.0f rays/sample); %d primary pixels on a particle; launches %s "
            "| %s" % (
                label, W, H, " + wavefront sort" if sort else "", v["pack_s"],
                ", the 8-band bake %.3f s" % v["spectral_bake_s"] if not sort
                else "", v["peak_mb"], v["peak_above_mb"], base / 1e6, block,
                dt, v["mrays"], tree["mrays"], v["rays_per_sample"],
                v["particle_pixels"], counts, smi))
        log("[optics %s calls] ms per call (calls in one sample): %s | %s" % (
            label, ", ".join("%s %.3f (%d)" % (f, c["ms_per_call"], c["calls"])
                             for f, c in v["ms_per_call"].items()), smi))
        if not sort:
            v["kernel_b"] = _closest_on_particles(pt.bvh, saved["b"], cuda_ms,
                                                  bound, smi)
            idx = torch.cat(saved["a"])
            v["kernel_a"] = kernel_a_case(
                "8-band env rows C32", ds.sky.env_spec_rows, idx, 32, 1, dev,
                cuda_ms, bound, smi)
        out[label] = v
        del r, acc, saved
        torch.cuda.empty_cache()

    # the card against the plain CPU path: 64x36, depth 4, 2 samples, both
    # variants, on the same sky tables (packed on the CPU, the 8-band bake
    # included, and carried to the card); the card's own 8-band bake held
    # against the CPU's apart (RMSE/scale < 1e-4); the lanes of the two
    # samples whose lens trace decided otherwise (alive on one device only)
    # counted. A pixel more than 1e-2 of the scale apart took another
    # decision in one of its samples: at most 8 may, and the rest is held
    # within RMSE/scale 1e-3.
    out["card_vs_cpu"] = {}
    for label, sort in (("a", False), ("b", True)):
        def make():
            return optics_scene(64, 36, 4, sort=sort)
        sky_c = D.pack_sky(make(), "cpu")
        sky_g = D.pack_sky(make(), dev)
        e_c = sky_c.env_spec_rows[:, :8].numpy()
        e_g = sky_g.env_spec_rows[:, :8].cpu().numpy()
        bake_rel = float(np.sqrt(np.mean((e_g - e_c) ** 2))
                         / (np.abs(e_c).mean() + 1e-12))
        imgs, lens = {}, {}
        for d in (dev, "cpu"):
            rr = Renderer(make(), device=d)
            rr.device_scene = rr.device_scene._replace(sky=dataclasses.replace(
                sky_c, **{f.name: getattr(sky_c, f.name).to(d)
                          for f in dataclasses.fields(sky_c)
                          if isinstance(getattr(sky_c, f.name), torch.Tensor)}))
            cam, c = rr.device_camera, rr.config
            alive = []
            for s in range(2):
                px, py = rr._px, rr._py
                pid = (py.long() * c.width + px.long()) & 0xFFFFFFFF
                w = generate_physical_camera_rays(
                    cam, cam.phys, c.width, c.height, px, py, pid,
                    torch.tensor(s, device=px.device))[2]
                # a lane the lens killed weighs 0 in every channel
                alive.append((sum(x.abs() for x in w) > 0).cpu())
            lens[str(d)] = torch.cat(alive)
            t0 = time.monotonic()
            rr.render_samples(2)
            imgs[str(d)] = (rr.get_radiance(), time.monotonic() - t0)
        (img_g, _), (img_c, cpu_s) = imgs[str(dev)], imgs["cpu"]
        lens_other = int((lens[str(dev)] != lens["cpu"]).sum())
        v = _card_vs_cpu(img_g, img_c, 1e-3, 8)
        v.update(cpu_s=cpu_s, spectral_bake_rmse_over_scale=bake_rel,
                 spectral_bake_bound=1e-4, lens_other_decision_lanes=lens_other,
                 lens_lanes=int(lens["cpu"].numel()),
                 lens_alive_share=float(lens["cpu"].float().mean()))
        v["ok"] = v["ok"] and bake_rel < 1e-4
        log("[optics vs cpu] %s, 64x36 depth 4, 2 samples: card against the "
            "plain CPU path RMSE/scale %.3g over all pixels, %d of %d pixels "
            "another decision (over 1e-2 of the scale apart, at most %d), %.3g "
            "over the rest (bound %g); max abs %.3g; %d of %d lens lanes "
            "decided otherwise (alive share %.4f); the card's 8-band bake "
            "against the CPU's RMSE/scale %.3g (bound 1e-4); the CPU took "
            "%.1f s | %s" % (
                label, v["rmse_over_scale"], v["other_decision_pixels"],
                v["pixels"], v["max_other"], v["rest_rmse_over_scale"],
                v["bound"], v["max_abs"], lens_other, v["lens_lanes"],
                v["lens_alive_share"], bake_rel, cpu_s, smi))
        assert np.isfinite(img_g).all() and v["ok"], (label, v)
        out["card_vs_cpu"][label] = v
    return out


def _closest_on_particles(pbvh, launches, cuda_ms, bound, smi) -> dict:
    """Kernel B closest on the particle BVH: a sample's three tile segments
    at depth 0 (the wrapped origins of each), against the plain walk on
    every 7th lane of the three, under phase 3's rule: the same slot, an
    exact-t tie, or a nearer hit of the kernel that its triangle tested
    alone confirms (brute force); hit distances and barycentrics within
    1e-5. Time, plain time (on those lanes) and bound (each ray's own walk)
    of the first segment's launch, as the path makes it."""
    import torch

    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.intersect import ray_triangle
    from luminary_tpu_torch.ops.vec import Vec3

    o = Vec3(*(torch.cat([s["o"][c] for s in launches]) for c in range(3)))
    d = Vec3(*(torch.cat([s["d"][c] for s in launches]) for c in range(3)))
    t = torch.cat([s["t"] for s in launches])
    a = torch.cat([s["a"] for s in launches])
    n = o.x.shape[0]
    rows = pbvh.rows
    hit = TR.traverse_wide(rows, pbvh.num_nodes, pbvh.depth, o, d, t, a, False)
    ix = torch.arange(0, n, 7, device=t.device)
    m = ix.numel()

    def sub(v, i):
        return Vec3(*(c[i] for c in v))

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    ref = TR.traverse_wide_plain(rows, pbvh.num_nodes, pbvh.depth, sub(o, ix),
                                 sub(d, ix), t[ix], a[ix], False)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    got = TR.Hit(*(f[ix] for f in hit))
    same = got.slot == ref.slot
    both = (got.slot >= 0) & (ref.slot >= 0)
    tie = ~same & both & ((got.t - ref.t).abs() <= 1e-6 * ref.t.abs())
    other = torch.nonzero(~same & ~tie).flatten()
    n_tie, n_other = int(tie.sum()), int(other.numel())
    confirmed = 0
    if n_other:
        lanes = ix[other]
        g_slot = got.slot[other].clamp(min=0).long()
        t_bf, _u, _v, h_bf = ray_triangle(
            sub(o, lanes), sub(d, lanes), sub(pbvh.tri_v0, g_slot),
            sub(pbvh.tri_e1, g_slot), sub(pbvh.tri_e2, g_slot))
        nearer = (got.slot[other] >= 0) & ((ref.slot[other] < 0)
                                           | (got.t[other] < ref.t[other]))
        real = h_bf & ((t_bf - got.t[other]).abs() <= 1e-6 * got.t[other])
        confirmed = int((nearer & real).sum())
    keep = same & (got.slot >= 0)
    n_hits = int(keep.sum())
    err = 0.0
    if n_hits:
        err = float(torch.maximum((got.t - ref.t).abs(),
                                  torch.maximum((got.u - ref.u).abs(),
                                                (got.v - ref.v).abs()))[keep].max())
    log("[kernel B closest, particle BVH] %d of %d lanes of depth 0's %d "
        "segments vs plain (%s active): %d slots equal (%d hits), %d exact-t "
        "ties, %d other differences (%d a nearer kernel hit confirmed by "
        "brute force); max abs err of t, u, v %.3g" % (
            m, n, len(launches), [int(s["a"].sum()) for s in launches],
            int(same.sum()), n_hits, n_tie, n_other, confirmed, err))
    assert err <= 1e-5 and n_tie <= max(1e-4 * m, 1) and confirmed == n_other, (
        err, n_tie, n_other, confirmed)
    assert n_hits > 0
    # time and bound: the first segment's launch
    o, d, t, a = (launches[0][k] for k in "odta")
    n = o.x.shape[0]
    ms = cuda_ms(lambda: TR.traverse_wide(rows, pbvh.num_nodes, pbvh.depth, o,
                                          d, t, a, False))
    stats = {}
    TR.traverse_wide(rows, pbvh.num_nodes, pbvh.depth, o, d, t, a, False,
                     stats=stats)
    own = per_ray_tests(rows, pbvh.num_nodes, pbvh.depth, o, d, t, a, False)
    n_active = int(a.sum())
    # bytes: the 32-byte row of each active ray, its 16-byte hit, the active
    # flag of every ray and the table; operations: each ray's own walk
    b_ms, b_by = bound(n_active * 48 + n + rows.numel() * 4,
                       own["node_tests"] * SLAB_OPS + own["tri_tests"] * TRI_OPS)
    log("[kernel B closest, particle BVH] the first segment's launch, %d rays "
        "(%d active): %.3f ms (plain %.3f ms on the %d checked lanes of the "
        "three segments), bound %.4f ms (%s; the rays' own walks %d slab + %d "
        "triangle tests, the 32-ray packets %d + %d) | %s" % (
            n, n_active, ms, plain_ms, m, b_ms, b_by, own["node_tests"],
            own["tri_tests"], stats["node_tests"], stats["tri_tests"], smi))
    return dict(rays=n, active_rays=n_active, ms=ms, plain_ms=plain_ms,
                plain_lanes=m, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err, differing_lanes=n_tie + n_other,
                nearer_confirmed_lanes=confirmed, checked_lanes=m, tests=own,
                packet_tests=stats)


def _card_vs_cpu(img_g, img_c, bound, max_other) -> dict:
    """The card's image against the plain CPU path's: RMSE/scale over all
    pixels; the pixels more than 1e-2 of the scale apart (another decision
    on the card in one of their samples), at most ``max_other`` of them;
    RMSE/scale over the rest within ``bound``."""
    import numpy as np

    scale = float(np.abs(img_c).mean()) + 1e-6
    d = np.abs(img_g - img_c).max(axis=-1)
    other = d > 1e-2 * scale
    rest = float(np.sqrt(np.mean((img_g - img_c)[~other] ** 2)) / scale)
    return dict(
        rmse_over_scale=float(np.sqrt(np.mean((img_g - img_c) ** 2)) / scale),
        max_abs=float(d.max()), pixels=int(d.size),
        other_decision_pixels=int(other.sum()), max_other=max_other,
        rest_rmse_over_scale=rest, bound=bound,
        ok=bool(other.sum() <= max_other and rest < bound))


def _any_hit_on_batch(saved, n, ds, cuda_ms, bound, smi) -> dict:
    """Kernel B any-hit on a sample's 5-segment shadow batch (sun, light,
    env, caustic x→P, caustic P→sun; the largest any-hit launch of the
    sample) and on its first 3 segments, against the plain walk on every
    7th lane: a lane where they differ must be a kernel hit that brute force
    over all triangles confirms; no lane may be occluded only in the plain
    walk. Time, plain time (on those lanes), bound (each ray's own walk)."""
    import torch

    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.intersect import ray_triangle
    from luminary_tpu_torch.ops.vec import Vec3

    bvh = ds.geo.bvh
    rows = saved["rows"]
    res = {}
    for segs in (5, 3):
        m = segs * n
        o = Vec3(*(c[:m] for c in saved["o"]))
        d = Vec3(*(c[:m] for c in saved["d"]))
        t, a = saved["t"][:m], saved["a"][:m]
        occ = TR.traverse_wide(rows, bvh.num_nodes, bvh.depth, o, d, t, a, True)
        ix = torch.arange(0, m, 7, device=t.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        ref = TR.traverse_wide_plain(rows, bvh.num_nodes, bvh.depth,
                                     Vec3(*(c[ix] for c in o)),
                                     Vec3(*(c[ix] for c in d)), t[ix], a[ix],
                                     True)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        kernel_only = ix[torch.nonzero(occ[ix] & ~ref).flatten()]
        plain_only = ix[torch.nonzero(~occ[ix] & ref).flatten()]
        tris = [Vec3(*(c[None] for c in v))
                for v in (bvh.tri_v0, bvh.tri_e1, bvh.tri_e2)]
        confirmed = 0
        for s in range(0, kernel_only.numel(), 32):
            lanes = kernel_only[s:s + 32]
            tt, _u, _v, hit = ray_triangle(Vec3(*(c[lanes, None] for c in o)),
                                           Vec3(*(c[lanes, None] for c in d)),
                                           *tris)
            confirmed += int((hit & (tt < t[lanes, None])).any(dim=1).sum())
        per_seg = [int(a[k * n:(k + 1) * n].sum()) for k in range(segs)]
        log("[kernel B any-hit, %d-segment batch] %d lanes vs plain: %d only "
            "the kernel finds occluded (%d confirmed by brute force), %d only "
            "the plain walk; %d occluded; active rays per segment %s" % (
                segs, ix.numel(), kernel_only.numel(), confirmed,
                plain_only.numel(), int(ref.sum()), per_seg))
        assert plain_only.numel() == 0 and confirmed == kernel_only.numel(), (
            segs, int(plain_only.numel()), int(kernel_only.numel()), confirmed)
        ms = cuda_ms(lambda: TR.traverse_wide(rows, bvh.num_nodes, bvh.depth, o,
                                              d, t, a, True), iters=5)
        stats = {}
        TR.traverse_wide(rows, bvh.num_nodes, bvh.depth, o, d, t, a, True,
                         stats=stats)
        own = per_ray_tests(rows, bvh.num_nodes, bvh.depth, o, d, t, a, True)
        # bytes: the 32-byte row of each active ray (an inactive ray's row
        # need not be read), the active flag and the result byte of every
        # ray, and the table
        n_active = int(a.sum())
        b_ms, b_by = bound(n_active * 32 + 2 * m + rows.numel() * 4,
                           own["node_tests"] * SLAB_OPS + own["tri_tests"] * TRI_OPS)
        log("[kernel B any-hit, %d-segment batch] %d rays: %.3f ms, plain %.3f "
            "ms on %d of them, bound %.4f ms (%s; the rays' own walks %d slab "
            "+ %d triangle tests, the 32-ray packets %d + %d) | %s" % (
                segs, m, ms, plain_ms, ix.numel(), b_ms, b_by,
                own["node_tests"], own["tri_tests"], stats["node_tests"],
                stats["tri_tests"], smi))
        res["%d_segments" % segs] = dict(
            rays=m, active_rays=n_active, active_per_segment=per_seg, ms=ms,
            plain_ms=plain_ms,
            plain_lanes=int(ix.numel()), bound_ms=b_ms, bound_by=b_by,
            library_ms=None, kernel_only_confirmed_lanes=confirmed,
            checked_lanes=int(ix.numel()), tests=own, packet_tests=stats)
    return res


def mesh_path(dev, smi, size=(1920, 1080)) -> dict:
    """Phase 11: multi-device rendering (``parallel/mesh.py`` through the
    Renderer) on tree-1080p against the serial Renderer over the same sample
    ids. Every failed check raises."""
    import numpy as np
    import torch

    from luminary_tpu_torch.ops import light_tree as LT
    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.parallel import mesh as PM
    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import benchmark_scene

    W, H = size
    n = W * H
    out = {}

    def abc():
        return dict(A=RO.gather_soa.launches, B=TR.traverse_wide.launches,
                    C=LT.light_tree_descend.launches)

    # each shard's render: the launches of A, B and C it made and the current
    # device it ran under
    shards = []
    real_render = PM.render_sample

    def counted(*a, **k):
        before = abc()
        res = real_render(*a, **k)
        after = abc()
        shards.append(dict(device=str(a[3].device),
                           current=torch.cuda.current_device(),
                           **{x: after[x] - before[x] for x in after}))
        return res

    def compare(label, got, ref, rtol, atol):
        a, b = got.accum.radiance[:n].cpu().numpy(), ref[:n]
        scale = float(np.abs(b).mean()) + 1e-6
        res = dict(rmse_over_scale=float(np.sqrt(np.mean((a - b) ** 2)) / scale),
                   max_abs=float(np.abs(a - b).max()), rtol=rtol, atol=atol,
                   ok=bool(np.allclose(a, b, rtol=rtol, atol=atol)))
        log("[mesh] %s against the serial Renderer over the same ids: "
            "RMSE/scale %.3g, max abs %.3g (rtol %g, atol %g) | %s" % (
                label, res["rmse_over_scale"], res["max_abs"], rtol, atol, smi))
        assert res["ok"], (label, res)
        out[label] = res

    def run(label, r, samples):
        """Render through the mesh with each shard recorded; check that every
        shard launched A, B and C under its own device."""
        shards.clear()
        PM.render_sample = counted
        try:
            t0 = time.monotonic()
            r.render_samples(samples)
            dt = time.monotonic() - t0
        finally:
            PM.render_sample = real_render
        bad = [s for s in shards if min(s["A"], s["B"], s["C"]) == 0
               or torch.device(s["device"]).index != s["current"]]
        assert len(shards) == r.mesh.size * samples // r._n_axis and not bad, \
            (label, shards)
        log("[mesh] %s: %d shard renders in %.3f s; launches of A, B, C and "
            "the current device by shard: %s | %s" % (
                label, len(shards), dt,
                ["%s %d/%d/%d cur %s" % (s["device"], s["A"], s["B"], s["C"],
                                        s["current"]) for s in shards], smi))
        out[label + "_shards"] = list(shards)

    serial = Renderer(benchmark_scene(W, H, max_depth=4), device=dev)
    serial.render_samples(4)
    ref = serial.accum.radiance.cpu().numpy()

    # -- a 4-shard sample mesh of the card: one step, sample ids 0-3 --
    r4 = Renderer(benchmark_scene(W, H, max_depth=4),
                  mesh=PM.make_sample_mesh([dev] * 4))
    run("sample_mesh_4", r4, 4)
    assert r4.sample_count == 4 and r4._last_rays_per_sample > 0
    compare("sample_mesh_4", r4, ref, 2e-4, 1e-5)
    # seconds a sample of both renderers, in turns (4 samples a turn)
    turns = []
    for r, name in ((serial, "serial"), (r4, "mesh"), (r4, "mesh"),
                    (serial, "serial")):
        t0 = time.monotonic()
        r.render_samples(4)
        turns.append((name, (time.monotonic() - t0) / 4))
    sps = {k: float(np.mean([t for m, t in turns if m == k]))
           for k in ("serial", "mesh")}
    log("[mesh] s/sample in turns (serial, mesh, mesh, serial): %s; means "
        "serial %.4f, 4-shard mesh %.4f | %s" % (
            ["%s %.4f" % t for t in turns], sps["serial"], sps["mesh"], smi))
    out["turns"] = turns
    out["s_per_sample"] = sps

    # -- a 2x2 grid mesh: 2 samples a step over 2 pixel blocks, ids 0-3 --
    del serial
    rg = Renderer(benchmark_scene(W, H, max_depth=4),
                  mesh=PM.make_grid_mesh(2, 2, [dev] * 4))
    run("grid_mesh_2x2", rg, 4)
    compare("grid_mesh_2x2", rg, ref, 2e-4, 1e-5)
    del rg

    # -- elasticity: shard 0 disabled, 3 samples on the re-formed mesh
    # against a fresh 3-shard mesh --
    r4.set_device_enable(0, False)
    assert r4.sample_count == 0 and r4.mesh.size == 3
    assert r4.device_states() == ["disabled", "enabled", "enabled", "enabled"]
    run("reformed_3", r4, 3)
    r3 = Renderer(benchmark_scene(W, H, max_depth=4),
                  mesh=PM.make_sample_mesh([dev] * 3))
    r3.render_samples(3)
    a, b = r4.get_radiance(), r3.get_radiance()
    out["reformed_3"] = dict(max_abs=float(np.abs(a - b).max()), atol=1e-6)
    log("[mesh] shard 0 disabled: 3 samples on the re-formed mesh against a "
        "fresh 3-shard mesh: max abs %.3g (atol 1e-6) | %s"
        % (out["reformed_3"]["max_abs"], smi))
    assert np.allclose(a, b, atol=1e-6), out["reformed_3"]
    del r3, r4

    # -- the distinct cards, where the machine has more than one --
    cards = torch.cuda.device_count()
    if cards >= 2:
        devs = [torch.device("cuda", i) for i in range(min(cards, 4))]
        rs = Renderer(benchmark_scene(W, H, max_depth=4), device=dev)
        rs.render_samples(len(devs))
        rc = Renderer(benchmark_scene(W, H, max_depth=4),
                      mesh=PM.make_sample_mesh(devs))
        run("cards_%d" % len(devs), rc, len(devs))
        compare("cards_%d" % len(devs), rc,
                rs.accum.radiance.cpu().numpy(), 2e-4, 1e-5)
        del rs, rc
    else:
        log("[mesh] one card visible: only shards of one card ran | %s" % smi)
    out["cards"] = cards
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", metavar="DIR",
                    help="time an earlier version of kernels B, C and E, built "
                         "from whichever of traverse_wide.cu, "
                         "light_tree_descend.cu and gather_sum.cu DIR holds, "
                         "against this one")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np

    from luminary_tpu_torch import kernels
    from luminary_tpu_torch.ops import light_tree as LT
    from luminary_tpu_torch.ops import random as R
    from luminary_tpu_torch.ops import rowops as RO
    from luminary_tpu_torch.ops import traverse as TR
    from luminary_tpu_torch.ops.camera import generate_camera_rays
    from luminary_tpu_torch.ops.intersect import MISS_DIST, ray_triangle
    from luminary_tpu_torch.ops.vec import Vec3, dot, normalize
    from luminary_tpu_torch.render.device_scene import SHP_COLS, SHP_FACE, unpack_oct_snorm16
    from luminary_tpu_torch.render.renderer import Renderer
    from luminary_tpu_torch.testing import (
        benchmark_scene,
        cornell_scene,
        fog_bridges_scene,
        glass_sphere_scene,
        sun_plane_scene,
        textured_scene,
    )
    from luminary_tpu_torch.tools import launch_ms

    out_dir = os.path.join(repo, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("[device] %s | nvidia-smi: %s | torch %s cuda %s" % (
        name, smi, torch.__version__, torch.version.cuda))
    report["device"] = {"name": name, "nvidia_smi": smi}

    # ---- 2. build ----
    t0 = time.monotonic()
    built = kernels.build_all()
    build_s = time.monotonic() - t0
    log("[build] %d kernel libraries in %.2f s (parallel nvcc, sm_90a)" % (
        len(built), build_s))
    ptxas = {}
    for k, v in built.items():
        ptxas.update(ptxas_summary(v[1]))
    for entry, summary in sorted(ptxas.items()):
        log("[ptxas] %s: %s" % (entry, summary))
    report["build"] = {"seconds": build_s, "ptxas": ptxas,
                       "nvcc": {k: v[1] for k, v in built.items()}}
    for k in kernels.SOURCES:
        kernels.load(k)
    # (kernel library name, label, ctypes library) of the earlier builds
    # timed in turns with the port's own
    alts = []
    jobs = [(("launch_floor", "this"),
             os.path.join(repo, "luminary_tpu_torch", "csrc", "launch_floor.cu"), [],
             os.path.join(kernels._BUILD, "liblaunch_floor.so"))]
    if args.compare:
        for k in ("traverse_wide", "light_tree_descend", "gather_sum"):
            src = os.path.join(args.compare, k + ".cu")
            if os.path.exists(src):
                jobs.append(((k, "earlier"), src, [],
                             os.path.join(args.compare, "lib%s.so" % k)))
    built_alt = build_libs(kernels, jobs)
    floor_lib = built_alt.pop(("launch_floor", "this"))[0]
    for (name, label), (lib, summary) in built_alt.items():
        alts.append((name, label, lib))
        for entry, line in sorted(summary.items()):
            log("[ptxas %s] %s: %s" % (label, entry, line))
        report.setdefault("alt_ptxas", {})["%s %s" % (name, label)] = summary

    def with_lib(name, lib, fn):
        """Run fn with `lib` in place of the port's build of kernel `name`
        (the same C interface, so the wrapper is unchanged)."""
        cur = kernels.load(name)
        entry = "lum_" + name
        getattr(lib, entry).argtypes = getattr(cur, entry).argtypes
        getattr(lib, entry).restype = getattr(cur, entry).restype
        kernels._libs[name] = lib
        try:
            return fn()
        finally:
            kernels._libs[name] = cur

    def cuda_ms(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def bound(bytes_, ops):
        t_b = bytes_ / HBM_BYTES_PER_S * 1e3
        t_o = ops / FP32_FLOPS * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    # ---- 3. kernels against their plain versions ----
    t0 = time.monotonic()
    r = Renderer(benchmark_scene(1920, 1080, max_depth=4), device=dev)
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    ds, cam, cfg = r.device_scene, r.device_camera, r.config
    bvh = ds.geo.bvh
    log("[pack] tree-1080p: %.2f s; %d slots, %d wide nodes, depth %d, "
        "%d lights, tree levels %d, lanes %d" % (
            pack_s, bvh.tri_v0.x.shape[0], bvh.num_nodes, bvh.depth,
            ds.lights.num_lights, ds.lights.tree_levels, r._px.shape[0]))
    report["pack_s"] = pack_s
    px, py = r._px, r._py
    n = px.shape[0]
    pixel_id = (py.long() * cfg.width + px.long()) & 0xFFFFFFFF
    sid = torch.tensor(0, dtype=torch.int64, device=dev)
    bn = R.blue_base(px, py)
    origin, direction = generate_camera_rays(
        cam, cfg.width, cfg.height, px, py, pixel_id, sid, bn=bn)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    tmax = torch.full((n,), MISS_DIST, device=dev)
    kern = []

    def sub(v, ix):
        return Vec3(*(c[ix] for c in v))

    # Where kernel B (32-ray packets, a conservative box test) and its plain
    # version (16-ray packets, as the JAX walk) disagree, the difference must
    # be a triangle the kernel finds through a box the plain walk turned
    # away; a triangle that only the plain walk finds would be a leak. Lanes
    # are checked by brute force over all slots and by walking up the tree.
    # parent maps: node/leaf -> (parent node, child k).
    m_nodes = bvh.num_nodes
    codes = bvh.rows.view(torch.int32)[:m_nodes, 96:112].long()
    m_of = torch.arange(m_nodes, device=dev)[:, None].expand(-1, TR.BRANCH)
    k_of = torch.arange(TR.BRANCH, device=dev)[None, :].expand(m_nodes, -1)
    n_leaves = bvh.rows.shape[0] - m_nodes
    node_par = torch.full((m_nodes,), -1, dtype=torch.long, device=dev)
    node_park = node_par.clone()
    leaf_par = torch.full((n_leaves,), -1, dtype=torch.long, device=dev)
    leaf_park = leaf_par.clone()
    inner = (codes >= 0) & (codes != TR.INVALID_CHILD)
    node_par[codes[inner]] = m_of[inner]
    node_park[codes[inner]] = k_of[inner]
    leafc = codes < 0
    leaf_par[~codes[leafc]] = m_of[leafc]
    leaf_park[~codes[leafc]] = k_of[leafc]

    def own_path_admits(o, d, t_max, slot):
        """Per lane: does the kernel's box test (``TR.slab_admits``, t in
        [1e-4, t_max]) admit every box from the root to slot's leaf?"""
        inv = TR._safe_inv(d)
        node = leaf_par[slot.long() // TR.WIDE_LEAF]
        k = leaf_park[slot.long() // TR.WIDE_LEAF]
        ok = torch.ones_like(t_max, dtype=torch.bool)
        for _ in range(bvh.depth + 2):
            live = node >= 0
            r = bvh.rows[node.clamp(min=0)]
            kk = k.clamp(min=0)[:, None]

            def col(base):
                return r.gather(1, kk + base)[:, 0]

            box = TR.slab_admits(Vec3(col(0), col(32), col(64)),
                                 Vec3(col(16), col(48), col(80)), o, inv, t_max)
            ok &= ~live | box
            nn = node.clamp(min=0)
            node = torch.where(live, node_par[nn], -1)
            k = torch.where(live, node_park[nn], -1)
        return ok

    def occluders_hidden_from_ray(o, d, t_max):
        """Per lane, by brute force over all slots: (number of triangles the
        ray hits in (1e-4, t_max), whether the kernel's box test rejects the
        path to every one)."""
        n_hit = torch.zeros(o.x.shape[0], dtype=torch.long, device=dev)
        hidden = torch.ones(o.x.shape[0], dtype=torch.bool, device=dev)
        tv0, te1, te2 = bvh.tri_v0, bvh.tri_e1, bvh.tri_e2
        for a in range(0, o.x.shape[0], 32):
            b = min(a + 32, o.x.shape[0])
            t, _u, _v, h = ray_triangle(
                Vec3(*(c[a:b, None] for c in o)), Vec3(*(c[a:b, None] for c in d)),
                Vec3(*(c[None] for c in tv0)), Vec3(*(c[None] for c in te1)),
                Vec3(*(c[None] for c in te2)))
            lane, slot = torch.nonzero(h & (t < t_max[a:b, None]), as_tuple=True)
            n_hit[a:b] = torch.bincount(lane, minlength=b - a)
            adm = own_path_admits(sub(o, a + lane), sub(d, a + lane),
                                  t_max[a + lane], slot)
            hidden[a:b] &= torch.bincount(lane[adm], minlength=b - a) == 0
        return n_hit, hidden

    def true_hits_f64(o, d, t_max):
        """Per lane: the number of triangles the ray hits in (1e-4, t_max)
        when the Moller-Trumbore test runs in float64 on the same data."""
        n_hit = torch.zeros(o.x.shape[0], dtype=torch.long, device=dev)
        tris = [Vec3(*(c.double()[None] for c in v))
                for v in (bvh.tri_v0, bvh.tri_e1, bvh.tri_e2)]
        for a in range(0, o.x.shape[0], 32):
            b = min(a + 32, o.x.shape[0])
            t, _u, _v, h = ray_triangle(Vec3(*(c[a:b, None].double() for c in o)),
                                        Vec3(*(c[a:b, None].double() for c in d)),
                                        *tris)
            n_hit[a:b] = (h & (t < t_max[a:b, None].double())).sum(dim=1)
        return n_hit

    # kernel B, closest hit: first-depth camera rays
    hit = TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth, origin,
                           direction, tmax, ones, False)
    ix = torch.arange(0, n, 7, device=dev)  # >= 256k lanes spread over the frame
    m = ix.shape[0]
    ref = TR.traverse_wide_plain(bvh.rows, bvh.num_nodes, bvh.depth,
                                 sub(origin, ix), sub(direction, ix), tmax[ix],
                                 ones[ix], False)
    got = TR.Hit(*(f[ix] for f in hit))
    same = got.slot == ref.slot
    both = (got.slot >= 0) & (ref.slot >= 0)
    tie = ~same & both & ((got.t - ref.t).abs() <= 1e-6 * ref.t.abs())
    other = torch.nonzero(~same & ~tie).flatten()
    n_tie, n_other = int(tie.sum()), int(other.numel())
    # a non-tie difference must be a nearer hit of the kernel: its slot's
    # triangle, tested alone, is hit at the kernel's t
    confirmed_c = 0
    if n_other:
        lanes = ix[other]
        g_slot = got.slot[other].clamp(min=0).long()
        t_bf, _u, _v, h_bf = ray_triangle(
            sub(origin, lanes), sub(direction, lanes), sub(bvh.tri_v0, g_slot),
            sub(bvh.tri_e1, g_slot), sub(bvh.tri_e2, g_slot))
        nearer = (got.slot[other] >= 0) & ((ref.slot[other] < 0)
                                           | (got.t[other] < ref.t[other]))
        real = h_bf & ((t_bf - got.t[other]).abs() <= 1e-6 * got.t[other])
        confirmed_c = int((nearer & real).sum())
    keep = same & (got.slot >= 0)
    t_rel = float(((got.t - ref.t).abs() / ref.t.abs().clamp(min=1e-30))[keep].max())
    uv_err = float(torch.maximum((got.u - ref.u).abs(), (got.v - ref.v).abs())[keep].max())
    err_b = float(torch.maximum((got.t - ref.t).abs(),
                                torch.maximum((got.u - ref.u).abs(),
                                              (got.v - ref.v).abs()))[keep].max())
    log("[kernel B closest] %d lanes vs plain: %d slots equal, %d exact-t ties, "
        "%d other differences (%d of them a nearer hit of the kernel that a "
        "brute-force test confirms); t max rel err %.3g, u/v max abs err %.3g" % (
            m, int(same.sum()), n_tie, n_other, confirmed_c, t_rel, uv_err))
    # tolerances of tests/test_torch_traverse.py; ties held to 1e-4 of all
    # lanes; every other difference must be a confirmed nearer kernel hit
    assert t_rel <= 1e-5 and uv_err <= 1e-5, (t_rel, uv_err)
    assert n_tie <= 1e-4 * m and confirmed_c == n_other, (n_tie, n_other, confirmed_c)
    ms = cuda_ms(lambda: TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth,
                                          origin, direction, tmax, ones, False))
    stats, pstats = {}, {}
    TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth, origin, direction,
                     tmax, ones, False, stats=stats)
    own = per_ray_tests(bvh.rows, bvh.num_nodes, bvh.depth, origin, direction,
                        tmax, ones, False)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    TR.traverse_wide_plain(bvh.rows, bvh.num_nodes, bvh.depth, origin, direction,
                           tmax, ones, False, stats=pstats)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    table_bytes = bvh.rows.numel() * 4
    # bytes: ray rows in (8 words), hits out (4 words), the table once;
    # operations: each ray's own slab and triangle tests, the work the
    # function needs; the tests the 32-ray packets add are their overhead
    b_ms, b_by = bound(n * 32 + n * 16 + table_bytes,
                       own["node_tests"] * SLAB_OPS + own["tri_tests"] * TRI_OPS)
    log("[kernel B closest] %d rays: %.3f ms, plain %.3f ms, bound %.4f ms (%s; "
        "the rays' own walks %d slab + %d triangle tests; the kernel's 32-ray "
        "packets ran %d + %d, the plain walk's 16-ray packets %d + %d)" % (
            n, ms, plain_ms, b_ms, b_by, own["node_tests"], own["tri_tests"],
            stats["node_tests"], stats["tri_tests"], pstats["node_tests"],
            pstats["tri_tests"]))
    report["kernel_b_closest_tests"] = dict(per_ray=own, kernel_packet=stats,
                                            plain_packet=pstats)
    kern.append(dict(
        name="traverse_wide.closest", route="cuda",
        source="luminary_tpu_torch/csrc/traverse_wide.cu",
        replaces="luminary_tpu/ops/traverse_pallas.py:120",
        variant="closest", max_abs_err=err_b, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        differing_lanes=n_tie + n_other, nearer_confirmed_lanes=confirmed_c,
        checked_lanes=m, tests=own, packet_tests=stats))

    ref_b = ref  # the plain walk's closest hits on the lanes ix
    # kernel B, any hit: the batched shadow rays of those hits (sun + light)
    valid = hit.slot >= 0
    t_safe = torch.where(valid, hit.t, 1.0)
    pos = Vec3(*(o + d * t_safe for o, d in zip(origin, direction)))
    srow = RO.gather_soa_plain(ds.shade_hot, torch.where(valid, hit.slot, 0), SHP_COLS)
    fx, fy, fz = unpack_oct_snorm16(srow[SHP_FACE])
    s_g = torch.where(fx * direction.x + fy * direction.y + fz * direction.z > 0, -1.0, 1.0)
    so = Vec3(pos.x + fx * s_g * 1e-3, pos.y + fy * s_g * 1e-3, pos.z + fz * s_g * 1e-3)
    lrows = ds.light_slot_rows
    li = (pixel_id % lrows.shape[0]).long()
    tgt = Vec3(*(lrows[li, c] + (lrows[li, 3 + c] + lrows[li, 6 + c]) / 3.0
                 for c in range(3)))
    to_l = Vec3(tgt.x - so.x, tgt.y - so.y, tgt.z - so.z)
    dist = torch.sqrt(dot(to_l, to_l))
    l_dir = normalize(to_l)
    sun = ds.sky.sun_dir
    sh_o = Vec3(*(torch.cat([c, c]) for c in so))
    sh_d = Vec3(torch.cat([sun[0].expand(n), l_dir.x]),
                torch.cat([sun[1].expand(n), l_dir.y]),
                torch.cat([sun[2].expand(n), l_dir.z]))
    sh_t = torch.cat([tmax, dist - 2e-3])
    sh_a = torch.cat([valid, valid])
    occ = TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t,
                           sh_a, True)
    ix2 = torch.arange(0, 2 * n, 7, device=dev)
    occ_ref = TR.traverse_wide_plain(bvh.rows, bvh.num_nodes, bvh.depth,
                                     sub(sh_o, ix2), sub(sh_d, ix2), sh_t[ix2],
                                     sh_a[ix2], True)
    kernel_only = torch.nonzero(occ[ix2] & ~occ_ref).flatten()
    plain_only = torch.nonzero(~occ[ix2] & occ_ref).flatten()
    n_diff = int(kernel_only.numel()) + int(plain_only.numel())
    # a lane only the kernel finds occluded must hit a triangle in range
    # (brute force over all slots, the same arithmetic): the kernel found it
    # through a box the plain walk's rounded test turned away, its own or a
    # packet mate's
    lanes = ix2[kernel_only]
    n_hit, hidden = occluders_hidden_from_ray(sub(sh_o, lanes), sub(sh_d, lanes),
                                              sh_t[lanes])
    confirmed = int((n_hit > 0).sum())
    # a lane only the plain walk finds occluded would be a leak of the kernel
    lanes_p = ix2[plain_only]
    p_hit, p_hidden = occluders_hidden_from_ray(sub(sh_o, lanes_p),
                                                sub(sh_d, lanes_p), sh_t[lanes_p])
    log("[kernel B any-hit] %d lanes vs plain: %d flags differ (%d only the "
        "kernel finds occluded, %d of them confirmed by brute force, %d through "
        "a path the ray's own box tests admit; %d only the plain walk finds "
        "occluded, %d of them behind a box the kernel's test rejects, %d hit "
        "in float64; %d occluded)" % (
            ix2.shape[0], n_diff, int(kernel_only.numel()), confirmed,
            int(((n_hit > 0) & ~hidden).sum()), int(plain_only.numel()),
            int(((p_hit > 0) & p_hidden).sum()),
            int((true_hits_f64(sub(sh_o, lanes_p), sub(sh_d, lanes_p),
                               sh_t[lanes_p]) > 0).sum()),
            int(occ_ref.sum())))
    if plain_only.numel():
        torch.save(dict(origin=torch.stack(list(sub(sh_o, lanes_p))).cpu(),
                        direction=torch.stack(list(sub(sh_d, lanes_p))).cpu(),
                        t_max=sh_t[lanes_p].cpu(), lanes=lanes_p.cpu()),
                   os.path.join(out_dir, "kernel_b_plain_only_lanes.pt"))
    assert plain_only.numel() == 0 and confirmed == kernel_only.numel(), (
        int(plain_only.numel()), int(kernel_only.numel()), confirmed)
    ms = cuda_ms(lambda: TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth,
                                          sh_o, sh_d, sh_t, sh_a, True))
    stats, pstats = {}, {}
    TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t,
                     sh_a, True, stats=stats)
    own = per_ray_tests(bvh.rows, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t,
                        sh_a, True)
    torch.cuda.synchronize()
    e0.record()
    TR.traverse_wide_plain(bvh.rows, bvh.num_nodes, bvh.depth, sh_o, sh_d, sh_t,
                           sh_a, True, stats=pstats)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    b_ms, b_by = bound(2 * n * 32 + 2 * n + table_bytes,
                       own["node_tests"] * SLAB_OPS + own["tri_tests"] * TRI_OPS)
    log("[kernel B any-hit] %d rays: %.3f ms, plain %.3f ms, bound %.4f ms (%s; "
        "the rays' own walks %d slab + %d triangle tests; the kernel's 32-ray "
        "packets ran %d + %d, the plain walk's 16-ray packets %d + %d)" % (
            2 * n, ms, plain_ms, b_ms, b_by, own["node_tests"], own["tri_tests"],
            stats["node_tests"], stats["tri_tests"], pstats["node_tests"],
            pstats["tri_tests"]))
    report["kernel_b_any_hit_tests"] = dict(per_ray=own, kernel_packet=stats,
                                            plain_packet=pstats)
    kern.append(dict(
        name="traverse_wide.any_hit", route="cuda",
        source="luminary_tpu_torch/csrc/traverse_wide.cu",
        replaces="luminary_tpu/ops/traverse_pallas.py:120",
        variant="any_hit", max_abs_err=1.0 if n_diff else 0.0, ms=ms,
        plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        differing_lanes=n_diff, kernel_only_confirmed_lanes=confirmed,
        checked_lanes=int(ix2.shape[0]), tests=own, packet_tests=stats))

    # unplanar: the [C, N] -> [N, C] pack of the ray lanes kernel B reads,
    # at the camera-ray and shadow-ray shapes
    u_rows = []
    for label, cols in (
            ("camera rays C8", [*origin[:3], tmax, *direction[:3], ones.int()]),
            ("shadow rays C8", [*sh_o, sh_t, *sh_d, sh_a.int()])):
        got_u = RO.unplanar(cols)
        ref_u = RO.unplanar_plain(cols)
        assert torch.equal(got_u, ref_u), label
        nl = cols[0].shape[0]
        ms = cuda_ms(lambda: RO.unplanar(cols))
        graph_ms = launch_ms(lambda: RO.unplanar(cols), dev)
        plain_ms = cuda_ms(lambda: RO.unplanar_plain(cols), iters=3)
        cols_i = [c.view(torch.int32) for c in cols]
        lib_ms = cuda_ms(lambda: torch.stack(cols_i, dim=1))
        lib_graph_ms = launch_ms(lambda: torch.stack(cols_i, dim=1), dev)
        b_ms, b_by = bound(2 * nl * len(cols) * 4, 0)
        log("[unplanar %s] %d lanes: exact; %.3f ms (graph replay %.4f ms), "
            "plain %.3f ms, library %.3f ms (torch.stack; graph replay %.4f "
            "ms), bound %.4f ms (%s) | %s" % (
                label, nl, ms, graph_ms, plain_ms, lib_ms, lib_graph_ms, b_ms,
                b_by, smi))
        u_rows.append(dict(case=label, lanes=nl, ms=ms, graph_ms=graph_ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           library_graph_ms=lib_graph_ms, bound_ms=b_ms,
                           bound_by=b_by))
    kern.append(dict(
        name="unplanar", route="cuda",
        source="luminary_tpu_torch/csrc/gather_soa.cu",
        replaces="luminary_tpu/ops/rowops.py:71",
        max_abs_err=0.0, ms=u_rows[0]["ms"], plain_ms=u_rows[0]["plain_ms"],
        bound_ms=u_rows[0]["bound_ms"], bound_by=u_rows[0]["bound_by"],
        library_ms=u_rows[0]["library_ms"], shape=u_rows[0]["case"],
        cases=u_rows))

    # kernel A: every table the main path gathers from, at N lanes
    g = torch.Generator(device=dev).manual_seed(1)

    def rand_idx(rows):
        return torch.randint(0, rows, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    p = ds.shade_hot.shape[0]
    inter = torch.zeros(((p + 7) // 8 * 8, SHP_COLS), dtype=torch.int32, device=dev)
    inter[:p] = ds.shade_hot
    inter = inter.reshape(-1, 8, SHP_COLS).transpose(1, 2).reshape(-1, SHP_COLS * 8).contiguous()
    cases = [
        ("shade rows C16 s1", ds.shade_hot, hit.slot.int(), SHP_COLS, 1),
        ("fused light rows C37", lrows, rand_idx(lrows.shape[0]), 37, 1),
        ("tree candidate C37->18", lrows, rand_idx(lrows.shape[0]), 18, 1),
        ("aerial rows C128", ds.sky.aerial_rows, rand_idx(ds.sky.aerial_rows.shape[0]), 128, 1),
        ("env rows C16", ds.sky.env_rows, rand_idx(ds.sky.env_rows.shape[0]), 16, 1),
        ("ggx quad C4", ds.ggx_quad, rand_idx(ds.ggx_quad.shape[0]), 4, 1),
        ("reference layout C128 s8", inter, hit.slot.int(), SHP_COLS, 8),
    ]
    a_rows = [kernel_a_case(label, table, idx, n_cols, s, dev, cuda_ms, bound,
                            smi) for label, table, idx, n_cols, s in cases]
    main_a = a_rows[0]
    kern.append(dict(
        name="gather_soa", route="cuda",
        source="luminary_tpu_torch/csrc/gather_soa.cu",
        replaces="luminary_tpu/ops/rowops.py:93",
        also_replaces="luminary_tpu/ops/rowops.py:40",
        max_abs_err=0.0, ms=main_a["ms"], plain_ms=main_a["plain_ms"],
        bound_ms=main_a["bound_ms"], bound_by=main_a["bound_by"],
        library_ms=main_a["library_ms"], shape=main_a["case"], cases=a_rows))

    # kernel C: descents from the first-depth shading points
    lights = ds.lights
    rnd = LT.level_randoms(lights.tree_levels, pixel_id, sid, 0, n, bn=bn)
    got = LT.light_tree_descend(lights.tree_rows, lights.tree_num_nodes,
                                lights.tree_levels, so, rnd)
    ref = LT.light_tree_descend_plain(lights.tree_rows, lights.tree_num_nodes,
                                      lights.tree_levels, so, rnd)
    diff = (got[0] != ref[0]) | (got[2] != ref[2])
    bad = torch.nonzero(diff).flatten()
    edge = 0
    if bad.numel():
        # a differing pick must flip in the plain version when some level's
        # uniform moves by 1e-6: the lane sits on a CDF edge
        sub_pos = sub(so, bad)
        flips = torch.zeros(bad.numel(), dtype=torch.bool, device=dev)
        for lvl in range(lights.tree_levels + 1):
            for delta in (-1e-6, 1e-6):
                rr = rnd[:, bad].clone()
                rr[lvl] = (rr[lvl] + delta).clamp(0.0, 0.99999994)
                alt = LT.light_tree_descend_plain(
                    lights.tree_rows, lights.tree_num_nodes, lights.tree_levels,
                    sub_pos, rr)
                flips |= alt[0] == got[0][bad]
        edge = int(flips.sum())
        assert bool(flips.all()), "light-tree picks differ off a CDF edge"
    ok = ~diff & got[2]
    pdf_rel = float(((got[1] - ref[1]).abs() / ref[1].abs().clamp(min=1e-30))[ok].max())
    pdf_abs = float((got[1] - ref[1]).abs()[ok].max())
    log("[kernel C] %d lanes vs plain: %d picks differ, all %d within 1e-6 of a "
        "CDF edge; pdf max rel err %.3g" % (n, int(bad.numel()), edge, pdf_rel))
    assert bad.numel() <= 1e-4 * n and pdf_rel <= 1e-5
    ms = cuda_ms(lambda: LT.light_tree_descend(
        lights.tree_rows, lights.tree_num_nodes, lights.tree_levels, so, rnd))
    plain_ms = cuda_ms(lambda: LT.light_tree_descend_plain(
        lights.tree_rows, lights.tree_num_nodes, lights.tree_levels, so, rnd), iters=3)
    lv = lights.tree_levels + 1
    # inputs once (tree table, positions, uniforms), outputs once; the
    # per-lane row reads (n * levels * 512 B) come from L2, not HBM
    b_ms, b_by = bound(lights.tree_rows.numel() * 4 + n * (12 + 4 * lv) + n * 9,
                       n * (lights.tree_levels * 16 * NODE_CHILD_OPS
                            + 14 * LEAF_LIGHT_OPS))
    log("[kernel C] %d descents x %d levels: %.3f ms, plain %.3f ms, bound %.4f ms "
        "(%s); per-lane row traffic %.3f ms at HBM rate" % (
            n, lv, ms, plain_ms, b_ms, b_by, n * lv * 512 / HBM_BYTES_PER_S * 1e3))
    kern.append(dict(
        name="light_tree_descend", route="cuda",
        source="luminary_tpu_torch/csrc/light_tree_descend.cu",
        replaces="luminary_tpu/ops/light_tree_pallas.py:88",
        max_abs_err=pdf_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, differing_lanes=int(bad.numel())))

    # an earlier version of kernels B and C (--compare) against the port's,
    # in turns (this, earlier, earlier, this)
    by_name = {k["name"]: k for k in kern}
    for kname, lib_name, fn, args_b in (
            ("traverse_wide.closest", "traverse_wide",
             lambda: TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth,
                                      origin, direction, tmax, ones, False),
             (origin, direction, tmax, ones)),
            ("traverse_wide.any_hit", "traverse_wide",
             lambda: TR.traverse_wide(bvh.rows, bvh.num_nodes, bvh.depth,
                                      sh_o, sh_d, sh_t, sh_a, True),
             (sh_o, sh_d, sh_t, sh_a)),
            ("light_tree_descend", "light_tree_descend",
             lambda: LT.light_tree_descend(
                 lights.tree_rows, lights.tree_num_nodes,
                 lights.tree_levels, so, rnd), None)):
        others = [(label, lib) for name, label, lib in alts if name == lib_name]
        if not others:
            continue
        order = [("this", None)] + others
        turns = {label: [] for label, _ in order}
        for label, lib in order + order[::-1]:
            turns[label].append(cuda_ms(fn) if lib is None
                                else with_lib(lib_name, lib, lambda: cuda_ms(fn)))
        lines = {}
        for label, lib in others:
            line = dict(ms=sum(turns[label]) / 2, turns=turns[label])
            if args_b is not None:
                # the other build's test counts, and where its flags differ
                # from the plain walk's on the compared lanes
                any_hit = kname.endswith("any_hit")
                line["tests"] = {}
                out = with_lib(lib_name, lib, lambda: TR.traverse_wide(
                    bvh.rows, bvh.num_nodes, bvh.depth, *args_b, any_hit,
                    stats=line["tests"]))
                if any_hit:
                    p_only = ix2[torch.nonzero(~out[ix2] & occ_ref).flatten()]
                    line["plain_only_lanes"] = int(p_only.numel())
                    line["plain_only_true_f64"] = int((true_hits_f64(
                        sub(sh_o, p_only), sub(sh_d, p_only), sh_t[p_only]) > 0).sum())
                    line["kernel_only_lanes"] = int((out[ix2] & ~occ_ref).sum())
                else:
                    line["slots_differ"] = int((out.slot[ix] != ref_b.slot).sum())
            lines[label] = line
            log("[compare %s] %s: %.3f ms, this: %.3f ms (turns %s / %s)%s | %s" % (
                kname, label, line["ms"], sum(turns["this"]) / 2,
                ", ".join("%.3f" % t for t in turns[label]),
                ", ".join("%.3f" % t for t in turns["this"]),
                "" if args_b is None else "; %d slab + %d triangle tests%s" % (
                    line["tests"]["node_tests"], line["tests"]["tri_tests"],
                    "; against the plain walk %d lanes occluded by the plain walk "
                    "only (%d of them hit a triangle in range in float64), %d by "
                    "this build only" % (line["plain_only_lanes"],
                                         line["plain_only_true_f64"],
                                         line["kernel_only_lanes"])
                    if "plain_only_lanes" in line
                    else "; %d slots differ from the plain walk" % line["slots_differ"]),
                smi))
        by_name[kname]["compare"] = dict(this_ms=sum(turns["this"]) / 2,
                                         this_turns=turns["this"], others=lines)
    del occ, occ_ref, sh_o, sh_d, sh_t, sh_a

    # glibc's sinf / cosf (csrc/libm_sincos.cu) against its plain float64
    # version on the card: the bounce's 2,073,600 angles in [0, 2 pi) and a
    # block of 8 x 2^20 cloud-hash arguments (most above 120, the integer
    # reduction), bit for bit
    from luminary_tpu_torch.ops import libm

    gen = torch.Generator(device=dev).manual_seed(6)
    angles = torch.rand(n, generator=gen, device=dev) * (2.0 * np.pi)
    hashes = (torch.rand(8 << 20, generator=gen, device=dev) - 0.5) * 2e5
    l_rows = []
    for label, y in (("bounce angles", angles), ("cloud-hash arguments", hashes)):
        for want_cos in (False, True):
            got = libm.libm_sincos(y, want_cos)
            assert same_bits(got, libm.glibc_exact(y, want_cos)), (
                label, want_cos)
        ms = cold_launch_ms(lambda: libm.libm_sincos(y, False), dev)
        plain_ms = cuda_ms(lambda: libm.glibc_exact(y, False), iters=3)
        b_ms, b_by = bound(8 * y.numel(), 0)
        log("[libm_sincos %s] %d elements, sinf and cosf: exact; %.4f ms a "
            "launch (out of L2), plain %.3f ms, bound %.4f ms (%s) | %s" % (
                label, y.numel(), ms, plain_ms, b_ms, b_by, smi))
        l_rows.append(dict(case=label, elements=y.numel(), ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None))
    kern.append(dict(
        name="libm_sincos", route="cuda",
        source="luminary_tpu_torch/csrc/libm_sincos.cu",
        replaces="none: glibc's sinf/cosf, which the reference's compiled CPU "
                 "code calls (luminary_tpu/ops/material.py:194, "
                 "luminary_tpu/ops/clouds.py:72)",
        max_abs_err=0.0, **{k: l_rows[0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        shape=l_rows[0]["case"], cases=l_rows))
    del angles, hashes

    # fma32 (csrc/fma32.cu) against its plain float64 version at the path's
    # width, full operands and scalar ones (by value and as a 0-d tensor)
    from luminary_tpu_torch.ops.vec import fma32, fma32_plain

    fa, fb = (torch.randn(n, generator=gen, device=dev) for _ in "ab")
    fc = torch.randn(n, generator=gen, device=dev) * 2.0 ** torch.randint(
        -30, 30, (n,), generator=gen, device=dev)
    for args in ((fa, fb, fc), (fa, 1.5, fc),
                 (fa, fb, torch.tensor(-0.25, device=dev)),
                 (fa[::2], fb[:n // 2], fc[1::2]),
                 (fa[:64, None], fb[:128], fc[:64, None])):
        assert same_bits(fma32(*args), fma32_plain(*args))
    ms = cold_launch_ms(lambda: fma32(fa, fb, fc), dev)
    plain_ms = cuda_ms(lambda: fma32_plain(fa, fb, fc))
    b_ms, b_by = bound(16 * n, 2 * n)
    log("[fma32] %d lanes, full, broadcast and scalar operands: exact; %.4f ms "
        "a launch (out of L2), plain %.3f ms, bound %.4f ms (%s) | %s" % (
            n, ms, plain_ms, b_ms, b_by, smi))
    kern.append(dict(
        name="fma32", route="cuda", source="luminary_tpu_torch/csrc/fma32.cu",
        replaces="none: the float32 multiply-adds that the reference's "
                 "compiled CPU code contracts (luminary_tpu/ops/camera.py:136)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None))
    del fa, fb, fc

    # csrc/shading.cu: the camera ray, the hit point, the frame, the BSDF's
    # evaluation and sample, each against its plain version
    kern += shading_kernels(dev, smi, r, bound, cuda_ms)

    # random streams: card against CPU, 10^6 lanes
    rng = np.random.default_rng(3)
    pid = torch.as_tensor(rng.integers(0, 2**32, 10**6, dtype=np.uint64).astype(np.int64))
    sids = torch.as_tensor(rng.integers(0, 2**32, 10**6, dtype=np.uint64).astype(np.int64))
    qx = torch.as_tensor(rng.integers(0, 1920, 10**6).astype(np.int32))
    qy = torch.as_tensor(rng.integers(0, 1080, 10**6).astype(np.int32))
    bn_c, bn_d = R.blue_base(qx, qy), R.blue_base(qx.to(dev), qy.to(dev))
    n_rand = 0
    for target in (R.RandomTarget.BSDF_CHOICE, R.RandomTarget.LIGHT_TREE_LEVEL,
                   R.RandomTarget.LIGHT_SUN):
        for depth in (0, 3):
            for fn in (R.random_1d, R.random_2d):
                for use_bn in (False, True):
                    a = fn(target, pid, sids, depth, bn=bn_c if use_bn else None)
                    b = fn(target, pid.to(dev), sids.to(dev), depth,
                           bn=bn_d if use_bn else None)
                    assert torch.equal(a, b.cpu()), (fn.__name__, target, depth, use_bn)
                    n_rand += 1
    log("[random] random_1d/random_2d on the card equal the CPU bit for bit "
        "(%d streams x 10^6 lanes)" % n_rand)
    del hit, ref, got, rnd, pos, so, srow, inter
    torch.cuda.empty_cache()

    # ---- 3b. prototype kernels (tools/proto_pallas_gather*.py,
    # tools/microbench_colext.py) at the prototypes' shapes ----
    tool_kern = prototype_kernels(dev, cuda_ms, bound, smi, floor_lib, alts,
                                  with_lib, ptxas, report.get("alt_ptxas", {}))
    kern += tool_kern
    # the port's three tool entry points, each kernel's count from 0
    from luminary_tpu_torch.tools import microbench_colext as CX
    from luminary_tpu_torch.tools import proto_gather as PG
    from luminary_tpu_torch.tools import proto_gather2 as PG2

    tool_wrappers = {"gather_rows": PG.gather_rows, "gather_sum": PG.gather_sum,
                     "gather_chain": PG2.gather_chain, "slab_body": PG2.slab_body,
                     "transpose": CX.transpose}
    for w in tool_wrappers.values():
        w.launches = 0
    t0 = time.monotonic()
    PG.main("all", device=dev)
    PG2.main("all", device=dev)
    CX.main(device=dev)
    CX.main2(device=dev)
    tool_launches = {k: w.launches for k, w in tool_wrappers.items()}
    log("[tools] proto_gather all, proto_gather2 all, microbench_colext main + "
        "main2 in %.1f s; launches %s | %s" % (time.monotonic() - t0,
                                               tool_launches, smi))
    assert all(v > 0 for v in tool_launches.values()), tool_launches
    for k in tool_kern:
        k["launches"] = tool_launches[k["name"]]
    report["tool_launches"] = tool_launches
    torch.cuda.empty_cache()

    # ---- 4. main path: tree-1080p through the Renderer ----
    warm, timed = 2, 6
    r.render_samples(warm)
    _path_counts(zero=True)
    t0 = time.monotonic()
    r.render_samples(timed)
    dt = time.monotonic() - t0
    launches = _path_counts()
    rays = r._last_rays_per_sample
    mrays = rays * timed / dt / 1e6
    npix = 1920 * 1080
    acc = r.accum.radiance[:npix]
    finite = bool(torch.isfinite(acc).all())
    total = float(acc.sum())
    log("[main path] tree-1080p depth 4: %d samples in %.3f s: %.3f Mrays/s, "
        "%.3f spp/s (%.0f rays/sample); launches %s; accumulation finite=%s "
        "sum=%.6g | %s" % (timed, dt, mrays, timed / dt, rays, launches, finite,
                           total, smi))
    _assert_ran(launches)
    assert finite and total > 0.0
    report["tree_1080p"] = dict(samples=timed, seconds=dt, mrays=mrays,
                                spp_per_s=timed / dt, rays_per_sample=rays,
                                launches=launches, pack_s=pack_s)
    for k in kern:
        if k["name"] in launches:
            k["launches"] = launches[k["name"]]
    del acc
    # ---- 4b. the profile of a tree-1080p sample by stage ----
    report["profile_tree_1080p"] = profile_phase(r, smi)
    del r
    torch.cuda.empty_cache()

    # ---- 5. dense tier: cornell-512 ----
    t0 = time.monotonic()
    rc = Renderer(cornell_scene(512, 512, max_depth=4), device=dev)
    c_pack = time.monotonic() - t0
    rc.render_samples(2)
    t0 = time.monotonic()
    rc.render_samples(16)
    dt = time.monotonic() - t0
    c_mrays = rc._last_rays_per_sample * 16 / dt / 1e6
    c_acc = rc.accum.radiance
    assert bool(torch.isfinite(c_acc).all()) and float(c_acc.sum()) > 0
    log("[dense tier] cornell-512 depth 4: pack %.2f s, 16 samples in %.3f s: "
        "%.3f Mrays/s, %.3f spp/s | %s" % (c_pack, dt, c_mrays, 16 / dt, smi))
    report["cornell_512"] = dict(samples=16, seconds=dt, mrays=c_mrays,
                                 spp_per_s=16 / dt, pack_s=c_pack)
    del rc, c_acc

    # ---- 6. correctness on the card against the repository's goldens ----
    golden = {}

    def golden_rel(gname, img):
        ref = np.load(os.path.join(repo, "tests", "golden", gname + "_64spp.npy"))
        return float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).mean() + 1e-6))

    for gname, scene in (("cornell_32", cornell_scene(32, 32, max_depth=4)),
                         ("sun_plane_32", sun_plane_scene(32, 32)),
                         ("glass_sphere_32", glass_sphere_scene()),
                         ("fog_bridges_32", fog_bridges_scene())):
        rg = Renderer(scene, device=dev)
        rg.render_samples(64)
        img = rg.get_radiance()
        rel = golden_rel(gname, img)
        golden[gname] = rel
        log("[golden] %s at 64 spp on the card: RMSE/scale %.3g (bound 0.02)"
            % (gname, rel))
        assert np.isfinite(img).all() and rel < 0.02, (gname, rel)
    # textured_32: the JAX package's own render reads 0.049 against this
    # golden, so its figure is reported and the card is held to the plain
    # CPU path at the golden bound instead (8 samples)
    rg = Renderer(textured_scene(), device=dev)
    rg.render_samples(64)
    img = rg.get_radiance()
    golden["textured_32"] = golden_rel("textured_32", img)
    rg8 = Renderer(textured_scene(), device=dev)
    rg8.render_samples(8)
    rc8 = Renderer(textured_scene(), device="cpu")
    rc8.render_samples(8)
    a, b = rg8.get_radiance(), rc8.get_radiance()
    tex_rel = float(np.sqrt(np.mean((a - b) ** 2)) / (np.abs(b).mean() + 1e-6))
    log("[golden] textured_32 at 64 spp on the card: RMSE/scale %.3g against "
        "the golden (the JAX package's own render reads 0.049); at 8 spp the "
        "card against the plain CPU path: %.3g (bound 0.02)"
        % (golden["textured_32"], tex_rel))
    assert np.isfinite(img).all() and tex_rel < 0.02, tex_rel
    golden["textured_32_card_vs_cpu_8spp"] = tex_rel
    report["golden_rmse_over_scale"] = golden

    # ---- 7. product path: Host, checkpoint, adaptive, CLI at 1080p ----
    product = product_path(repo, dev, smi, report["tree_1080p"])
    report["product_path"] = product

    # ---- 8. scene content at full width ----
    content = content_path(dev, smi, cuda_ms, bound)
    report["content"] = content
    by_name = {k["name"]: k for k in kern}
    by_name["gather_soa"]["cases"] += content["kernel_a"]
    by_name["gather_soa"]["content_launches"] = content["path"]["kernel_a_by_table"]
    by_name["traverse_wide.any_hit"]["shadow_table"] = content["kernel_b_any_hit_shadow"]
    for k in kern:
        if k["name"] in content["path"]["launches"]:
            k["content_launches"] = content["path"]["launches"][k["name"]]

    # ---- 9. sky and sea at full width ----
    sky_sea = sky_sea_path(dev, smi, cuda_ms, bound, report["tree_1080p"])
    report["sky_sea"] = sky_sea
    by_name["traverse_wide.any_hit"]["sky_sea_batches"] = sky_sea["b"]["kernel_b"]
    for name, key, ref in (("cloud_march", "march", "luminary_tpu/ops/clouds.py:188"),
                           ("cloud_shadow", "shadow", "luminary_tpu/ops/clouds.py:251")):
        c = sky_sea["a"][key]
        cases = [c] + ([sky_sea["b"]["bake_march"]] if key == "march" else [])
        kern.append(dict(
            name=name, route="cuda", source="luminary_tpu_torch/csrc/clouds.cu",
            replaces="none: libm_sincos (csrc/libm_sincos.cu) and the cloud "
                     "hash's fma32 sites redesigned as the loop that called "
                     "them (%s)" % ref,
            max_abs_err=0.0, ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
            cases=cases))
    for k in kern:
        for v in ("a", "b"):
            if k["name"] in sky_sea[v]["launches"]:
                k["sky_sea_%s_launches" % v] = sky_sea[v]["launches"][k["name"]]
        if k["name"] in CLOUDS:  # their path is outdoor-1080p (a)'s
            k["launches"] = k["sky_sea_a_launches"]

    # ---- 10. optics at full width: particles, spectral, the lens, sort ----
    optics = optics_path(dev, smi, cuda_ms, bound, report["tree_1080p"])
    report["optics"] = optics
    by_name["traverse_wide.closest"]["particle_table"] = optics["a"]["kernel_b"]
    by_name["gather_soa"]["cases"].append(optics["a"]["kernel_a"])
    for k in kern:
        for v in ("a", "b"):
            if k["name"] in optics[v]["launches"]:
                k["optics_%s_launches" % v] = optics[v]["launches"][k["name"]]

    # ---- 11. multi-device: sample and grid meshes, device elasticity ----
    report["mesh"] = mesh_path(dev, smi)
    report["kernels"] = kern

    # the launch floor in every row's bound: max(bytes, operations, floor)
    floor_ms = by_name["gather_rows"]["launch_floor_ms"]
    raised = []
    for k in kern:
        for c in [k] + [c for c in k.get("cases", []) if isinstance(c, dict)]:
            if c.get("bound_ms") is not None and c["bound_ms"] < floor_ms:
                raised.append("%s %s" % (k["name"], c.get("case", c.get("shape", ""))))
        k["bound_with_floor_ms"] = max(k["bound_ms"], floor_ms)
    log("[launch floor] %.4f ms: the rows whose bound it raises: %s | %s" % (
        floor_ms, raised, smi))

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys} for kr in kern]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
