"""ctypes binding for the native C++ BVH builder (native/bvh_builder.cpp,
shared with gfxexp_tpu). Compiled with g++ at first use into libbvh.so in
the per-host build directory (csrc/build.py `build_dir()`); when the
compiler is missing the caller falls back to the numpy builder, and the
loader says so on stderr."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np

from gfxexp_torch.csrc import build

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "bvh_builder.cpp")

_lib = None
_load_failed = False


class _BvhResult(ctypes.Structure):
    _fields_ = [
        ("child_min", ctypes.POINTER(ctypes.c_float)),
        ("child_max", ctypes.POINTER(ctypes.c_float)),
        ("child_idx", ctypes.POINTER(ctypes.c_int32)),
        ("child_count", ctypes.POINTER(ctypes.c_int32)),
        ("perm", ctypes.POINTER(ctypes.c_int32)),
        ("n_nodes", ctypes.c_int32),
        ("max_depth", ctypes.c_int32),
        ("n_perm", ctypes.c_int32),
    ]


def _compile(so: str):
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # build beside the target and rename: concurrent test workers may race
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-std=c++17", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _ensure_lib():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    so = os.path.join(build.build_dir(), "libbvh.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(_SRC)):
            _compile(so)
        lib = ctypes.CDLL(so)
        lib.bvh_build.restype = ctypes.c_int
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(_BvhResult),
        ]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.POINTER(_BvhResult)]
        fp = ctypes.POINTER(ctypes.c_float)
        lib.bvh_build_sbvh.restype = ctypes.c_int
        lib.bvh_build_sbvh.argtypes = [
            fp, fp, fp, fp, fp, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(_BvhResult),
        ]
        _lib = lib
    except (subprocess.CalledProcessError, OSError) as e:
        print(f"[gfxexp_torch] native BVH builder unavailable ({e}); "
              "using the numpy builder", file=sys.stderr)
        _load_failed = True
    return _lib


def native_available() -> bool:
    """Build (if needed) and load the native builder; False when g++ or the
    library is unavailable."""
    return _ensure_lib() is not None


def build_bvh_arrays_native(
    tri_min: np.ndarray, tri_max: np.ndarray, arity: int = 4,
    max_leaf: int = 4,
) -> Optional[Tuple[np.ndarray, ...]]:
    """Same contract as bvh_build.build_bvh_arrays; None if the library is
    unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    if tri_min.shape != tri_max.shape or tri_min.shape[1:] != (3,):
        raise ValueError(f"bad box arrays {tri_min.shape} {tri_max.shape}")
    n = tri_min.shape[0]
    res = _BvhResult()
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.bvh_build(tri_min.ctypes.data_as(fp), tri_max.ctypes.data_as(fp),
                       n, arity, max_leaf, ctypes.byref(res))
    if rc != 0:
        raise RuntimeError(f"bvh_build failed with code {rc}")
    return _take_result(lib, res, arity, n)


def _take_result(lib, res: _BvhResult, arity: int, n_perm: int):
    """Copy the builder's arrays out and free them: (child_min, child_max,
    child_idx, child_count, perm (int64, n_perm long), max_depth)."""
    try:
        nn = res.n_nodes
        cmin = np.ctypeslib.as_array(res.child_min, (nn, arity, 3)).copy()
        cmax = np.ctypeslib.as_array(res.child_max, (nn, arity, 3)).copy()
        cidx = np.ctypeslib.as_array(res.child_idx, (nn, arity)).copy()
        ccnt = np.ctypeslib.as_array(res.child_count, (nn, arity)).copy()
        perm = np.ctypeslib.as_array(res.perm, (n_perm,)).copy()
        return (cmin, cmax, cidx, ccnt, perm.astype(np.int64),
                int(res.max_depth))
    finally:
        lib.bvh_free(ctypes.byref(res))


def build_bvh_arrays_native_sbvh(
    tri_min: np.ndarray, tri_max: np.ndarray, verts, arity: int = 4,
    max_leaf: int = 4, budget_frac: float = 0.3, alpha: float = 1e-5,
) -> Optional[Tuple[np.ndarray, ...]]:
    """Native SBVH (spatial splits with reference duplication), the
    contract of bvh_build.build_bvh_arrays(verts=...): the perm may hold
    duplicate triangle ids and is `n_perm` long. None if the library is
    unavailable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in verts)
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    n = tri_min.shape[0]
    for a in (v0, v1, v2, tri_min, tri_max):
        if a.shape != (n, 3):
            raise ValueError(f"bad triangle arrays: {a.shape}, want "
                             f"({n}, 3)")
    res = _BvhResult()
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.bvh_build_sbvh(
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        tri_min.ctypes.data_as(fp), tri_max.ctypes.data_as(fp), n, arity,
        max_leaf, ctypes.c_float(budget_frac), ctypes.c_float(alpha),
        ctypes.byref(res))
    if rc != 0:
        raise RuntimeError(f"bvh_build_sbvh failed with code {rc}")
    return _take_result(lib, res, arity, res.n_perm)
