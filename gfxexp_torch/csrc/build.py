"""Build the CUDA kernels in this directory with nvcc into shared libraries
with a plain C interface, and load them with ctypes.

Each `<name>.cu` becomes build/gfxexp_torch/lib<name>.so at first use (or
when the source is newer than the library). Built for Hopper (`sm_90a`) with
`--fmad=false`, so each kernel rounds every multiply and add on its own, as
its plain PyTorch version does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "gfxexp_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict = {}
# per kernel: seconds nvcc took in this process (0.0 when an up-to-date
# library was reused) and nvcc's -Xptxas -v report (registers, spills)
build_seconds: dict = {}
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _declare(name: str, lib: ctypes.CDLL):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "widerow_traverse":
        lib.widerow_max_stack.restype = ci
        lib.widerow_max_stack.argtypes = []
        lib.widerow_walk_launch.restype = ci
        lib.widerow_walk_launch.argtypes = [
            ci, ci, vp, ci, ci, ci, ci,          # any_hit .. n
            vp, vp, vp, vp,                      # o, d, tmin, tmax
            vp, vp, vp, vp, vp,                  # t, u, v, tri, hit
            vp,                                  # stream
        ]
    else:
        raise KeyError(f"no C interface declared for {name!r}")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu. Raises when nvcc is
    missing or the build fails."""
    if name in _libs:
        return _libs[name]
    src = os.path.join(_DIR, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    build_seconds[name] = 0.0
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.time()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        build_seconds[name] = time.time() - t0
        build_log[name] = proc.stderr
    lib = ctypes.CDLL(so)
    _declare(name, lib)
    _libs[name] = lib
    return lib
