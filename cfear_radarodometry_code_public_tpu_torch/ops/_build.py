"""Build and bind the port's CUDA kernels (nvcc + ctypes).

At first use, every `csrc/*.cu` is compiled for Hopper, one nvcc process
per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -DCFEAR_UNROLLED_MASK=0x56
         -DCFEAR_UNROLLED_S_MASK=0x12 -c

(the first define is the set of target tile counts kernel D2 is
instantiated for, bit n for n tiles, made from `cuda_assoc.UNROLLED_M`:
512, 1024, 2048, 3072 -> 1, 2, 4, 6; the second the keyframe counts of
kernel B2, bit n for S = n, from `cuda_assoc.UNROLLED_S`: 1, 4)

and the objects are linked into one shared library in `<package>/_build/`
(git-ignored), under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded. The
library has a plain C interface (no PyTorch headers), so the build takes
seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from cfear_radarodometry_code_public_tpu_torch.ops.cuda_assoc import (
    TT_SPARSE, UNROLLED_M, UNROLLED_S)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DCFEAR_UNROLLED_MASK={sum(1 << (m // TT_SPARSE) for m in UNROLLED_M):#x}",
    f"-DCFEAR_UNROLLED_S_MASK={sum(1 << s for s in UNROLLED_S):#x}",
    "-c")
LINK_FLAGS = ARCH + ("-shared",)

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # nvcc commands, seconds and -Xptxas -v report of the build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(path: str) -> None:
    """Compile every source in parallel, then link them into `path`."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR,
                           f"{os.path.splitext(os.path.basename(src))[0]}.{tag}.o")
        cmd = [nvcc, *COMPILE_FLAGS, "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failed = [], []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        reports.append(err.strip())
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{path}.{tag}"
        link = [nvcc, *LINK_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    build_info.update(cmd="\n".join(" ".join(c) for c, _, _ in jobs)
                      + "\n" + " ".join(link),
                      seconds=time.perf_counter() - t0,
                      report="\n".join(r for r in reports if r))


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = os.path.join(BUILD_DIR, f"libcfear_kernels_{_digest()}.so")
        if not os.path.exists(path):
            _build(path)
        else:
            build_info.update(cmd=None, seconds=0.0, report="cached: " + path)
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cfear_nn_min.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.cfear_nn_min.restype = i
        for name in ("cfear_nn_min_multi", "cfear_nn_min_multi_unrolled"):
            getattr(lib, name).argtypes = [p, p, p, i, i, i, i, i, p, p, p]
            getattr(lib, name).restype = i
        lib.cfear_nn_min_sparse.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                            p, p, p]
        lib.cfear_nn_min_sparse.restype = i
        for name in ("cfear_nn_min_sparse_multi",
                     "cfear_nn_min_sparse_unrolled"):
            getattr(lib, name).argtypes = lib.cfear_nn_min_sparse.argtypes
            getattr(lib, name).restype = i
        lib.cfear_nn_min_sparse_attrs.argtypes = [p, p, p, p, p, p, p, i, i,
                                                  i, i, i, p, p, p, p]
        lib.cfear_nn_min_sparse_attrs.restype = i
        lib.cfear_lm_solve_fused.argtypes = [p, p, i, i, i, i, f, i, f, i,
                                             i, i, p, p]
        lib.cfear_lm_solve_fused.restype = i
        lib.cfear_moment_accumulate.argtypes = [p, p, i, i, i, i, i, p, p,
                                                p, p]
        lib.cfear_moment_accumulate.restype = i
        _lib = lib
        return lib
