"""Build and bind the port's CUDA kernels (nvcc + ctypes).

At first use, `csrc/nn_assoc.cu` is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into `<package>/_build/` (git-ignored), under a name that carries a hash of
the source and flags, so an edited source is rebuilt and a stale library is
never loaded. The library has a plain C interface (no PyTorch headers), so
the build takes seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "nn_assoc.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # nvcc command, seconds and -Xptxas -v report of the build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libnn_assoc_{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, path)
            build_info.update(cmd=" ".join(cmd),
                              seconds=time.perf_counter() - t0,
                              report=proc.stderr.strip())
        else:
            build_info.update(cmd=None, seconds=0.0, report="cached: " + path)
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cfear_nn_min.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.cfear_nn_min.restype = i
        lib.cfear_nn_min_sparse.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                            p, p, p]
        lib.cfear_nn_min_sparse.restype = i
        _lib = lib
        return lib
