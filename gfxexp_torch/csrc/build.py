"""Build the CUDA kernels in this directory with nvcc into shared libraries
with a plain C interface, load them with ctypes, and launch them.

Each `<name>.cu` becomes lib<name>.so in `build_dir()` at first use, or
when the source or any header in this directory (`*.cuh`) is newer than
the library. Built for Hopper (`sm_90a`) with `--fmad=false`, so each kernel
rounds every multiply and add on its own, as its plain PyTorch version does.
`load_libraries` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_DIR))
# set by build_dir() at first use, or by enable_compile_cache(path)
BUILD_DIR: str | None = None
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict = {}
# (library, kernel): its `<kernel>_launch`, declared once its argument
# struct's size was checked
_launchers: dict = {}
# per kernel: seconds nvcc took in this process (0.0 when an up-to-date
# library was reused) and nvcc's -Xptxas -v report (registers, spills)
build_seconds: dict = {}
build_log: dict = {}


def _host_tag() -> str:
    """Short hash of the host CPU's feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith("flags")][:1]
        blob = flags[0] if flags else "unknown"
    except OSError:
        blob = "unknown"
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


def _device_tag() -> str:
    import torch

    if not torch.cuda.is_available():
        return "nocuda"
    major, minor = torch.cuda.get_device_capability(0)
    return f"sm{major}{minor}"


def build_dir() -> str:
    """The one directory the port's native libraries (the CUDA walks and
    accel/native.py's libbvh.so) build into and load from:
    `.cache/torch-<host>-<device>` in the repository. A library built on one
    host can fault on another with a different instruction set (libbvh.so
    is built with -march=native), so the directory is keyed by the host's
    CPU flags, and by the compute capability of the first CUDA device
    ("nocuda" without one). utils/runtime.enable_compile_cache(path) names
    another directory."""
    global BUILD_DIR
    if BUILD_DIR is None:
        BUILD_DIR = os.path.join(_REPO, ".cache",
                                 f"torch-{_host_tag()}-{_device_tag()}")
    return BUILD_DIR


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(src: str, so: str) -> bool:
    if not os.path.exists(so):
        return True
    newest = max(os.path.getmtime(p) for p in
                 [src, *glob.glob(os.path.join(_DIR, "*.cuh"))])
    return os.path.getmtime(so) < newest


def load_libraries(names) -> dict:
    """Build (where needed) and load csrc/<name>.cu for every name, running
    one nvcc per stale source in parallel. Raises when nvcc is missing or a
    build fails."""
    pending = {}
    out_dir = build_dir()
    try:
        for name in names:
            if name in _libs or name in pending:
                continue
            src = os.path.join(_DIR, name + ".cu")
            so = os.path.join(out_dir, f"lib{name}.so")
            build_seconds[name] = 0.0
            if not _stale(src, so):
                continue
            nvcc = _nvcc()
            os.makedirs(out_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            pending[name] = (proc, tmp, so, src, time.time())
        for name, (proc, tmp, so, src, t0) in pending.items():
            _, err = proc.communicate()
            build_seconds[name] = time.time() - t0
            build_log[name] = err
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{err}")
            os.replace(tmp, so)
    finally:
        for proc, tmp, *_ in pending.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
    return {name: _libs[name] for name in names}


@functools.cache
def header_constant(name: str, header: str = "widerow_walk.cuh") -> int:
    """N of `constexpr int <name> = N;` in csrc/<header>, read once per
    process: the walks' stack bounds (kMaxStack, kQMaxStack) and the
    nearest-first pick's kPick (keys a ray keeps in registers) and kSpill
    (keys it keeps in local memory), for the wrappers, the tests and the
    chip report."""
    with open(os.path.join(_DIR, header)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    if m is None:
        raise KeyError(f"{name} is not a constexpr int of {header}")
    return int(m.group(1))


def int32_bits(x: int) -> int:
    """The uint32 bits of x as a C int."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def tensor_arg(kernel: str, name: str, x, dtype, shape, dev):
    """The address of `kernel`'s argument `name`, the tensor x (None: a
    null pointer), after checking that the kernel takes it: contiguous,
    of `dtype`, on `dev` and, unless `shape` is None, of that shape."""
    if x is None:
        return None
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                         f"tensor on {dev}, got {x.dtype} on {x.device} "
                         f"(contiguous: {x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    return x.data_ptr()


def launch(library: str, kernel: str, args_type, fields: dict,
           tensors: dict, dev) -> None:
    """Launch `<kernel>_launch` of csrc/<library>.cu on the current stream
    of `dev` with its one argument struct, `args_type` (a ctypes Structure
    mirroring the kernel's): the plain fields from `fields` (numbers, or
    addresses the caller has checked), the pointers from `tensors` ({name:
    (tensor or None, dtype, shape)}, each checked by tensor_arg). Raises
    when the struct's size differs from the kernel's (`<kernel>_args_size`,
    asked at the kernel's first launch in the process), on a tensor the
    kernel does not take, or when the launch fails."""
    import torch

    fn = _launchers.get((library, kernel))
    if fn is None:
        lib = load_library(library)
        size = getattr(lib, f"{kernel}_args_size")
        size.restype, size.argtypes = ctypes.c_int, []
        if size() != ctypes.sizeof(args_type):
            raise RuntimeError(f"{kernel}: the argument struct differs from "
                               f"the kernel's")
        fn = getattr(lib, f"{kernel}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]  # args, stream
        _launchers[library, kernel] = fn
    args = args_type(**fields)
    for k, (x, dtype, shape) in tensors.items():
        setattr(args, k, tensor_arg(kernel, k, x, dtype, shape, dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    return load_libraries([name])[name]
