"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under the repository's gitignored
``build/kernels/`` directory, and loaded with ``ctypes``. Sources include no
PyTorch header, so a build takes seconds. :func:`build_all` starts one
``nvcc`` per source at once (``chip_smoke.py`` calls it up front).

Every kernel is built with ``-fmad=false``: the plain PyTorch versions that
the kernels are held against round every multiply and add separately, and a
fused multiply-add would move hit distances and light-tree CDF edges by an
ulp. Making the kernels fast, FMA included, is later work.

Nothing here runs at import time: this module imports on machines without
``nvcc`` or a card, as the CPU tests need.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

SOURCES = ("gather_soa", "traverse_wide", "light_tree_descend", "gather_rows",
           "gather_sum", "slab_body", "transpose", "libm_sincos", "fma32",
           "shading", "clouds")

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(_CSRC, name + ".cu"),
            os.path.join(_BUILD, "lib%s.so" % name))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    # a source's own headers (csrc/*.cuh) count as the source
    newest = max([os.path.getmtime(src)] + [
        os.path.getmtime(os.path.join(_CSRC, f)) for f in os.listdir(_CSRC)
        if f.endswith(".cuh")])
    return os.path.getmtime(lib) < newest


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    src, lib = _paths(name)
    os.makedirs(_BUILD, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc: subprocess.Popen, tmp: str, lib: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s.cu:\n%s" % (name, out))
    os.replace(tmp, lib)
    return out


def build_all(names=SOURCES) -> dict:
    """Compile every stale kernel library in parallel. Returns
    {name: (seconds, nvcc output)}; raises if any build fails."""
    t0 = time.monotonic()
    with _lock:
        started = {n: _start(n) for n in names if _stale(n)}
        report = {}
        for n, (proc, tmp, lib) in started.items():
            out = _finish(n, proc, tmp, lib)
            report[n] = (time.monotonic() - t0, out)
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(_paths(name)[1])
        _libs[name] = lib
        return lib


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``fn`` of kernel library ``name`` (built first if needed)
    with its signature set; it returns the launch's ``cudaGetLastError()``."""
    f = getattr(load(name), fn)
    f.restype = ctypes.c_int
    f.argtypes = argtypes
    return f


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch (cudaError %d)"
                           % (name, rc))


def launch_lanes(name: str, fn: str, ins, outs, n: int, device, consts=()) -> None:
    """Launch entry ``fn`` of kernel library ``name`` (the lane entry points
    of ``csrc/shading.cu``) over ``n`` lanes. ``ins``: tensors on the card,
    each 0-d or broadcastable to ``[n]`` (passed as a pointer and a stride
    in elements, so views and broadcasts are not copied), or a raw device
    pointer (an ``int``, for a table the kernel indexes itself); ``outs``:
    contiguous ``[n]`` tensors; ``consts``: host floats."""
    ptrs, strides = [], []
    for v in ins:
        if isinstance(v, int):
            ptrs.append(v)
            strides.append(0)
            continue
        if v.dim() > 0:
            v = v.expand(n)
        if v.device != device:
            raise RuntimeError("%s: operand on %s, launch on %s" % (fn, v.device,
                                                                    device))
        ptrs.append(v.data_ptr())
        strides.append(v.stride(0) if v.dim() else 0)
    p = ctypes.c_void_p
    f = entry(name, fn, [p, p, ctypes.c_int, p, ctypes.c_int, p, ctypes.c_int,
                         ctypes.c_longlong, p])
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_consts = (ctypes.c_float * max(len(consts), 1))(*consts)
    c_outs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    # (a CPU device only where the tests run a source on the emulation)
    stream = stream_handle(device) if device.type == "cuda" else None
    check(f(c_ptrs, c_strides, len(ptrs), c_consts, len(consts), c_outs,
            len(outs), n, stream), fn)


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
