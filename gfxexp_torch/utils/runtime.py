"""Runtime bootstrap (port of gfxexp_tpu/utils/runtime.py): the cache of the
port's built artifacts.

The port builds two kinds of native code at first use: the CUDA walks
(csrc/build.py, one shared library per .cu, compiled for the card's
architecture) and the BVH builder (accel/native.py, libbvh.so, compiled
with -march=native). Both go to the one directory csrc/build.py
`build_dir()` names, keyed by the host's CPU features, as the JAX package
keys its compile cache, and by the compute capability of the first CUDA
device.
"""

from __future__ import annotations

import os


def enable_compile_cache(path: str | None = None) -> str:
    """Create the directory the port's native libraries build into and load
    from, and return its absolute path: `.cache/torch-<host>-<device>` in
    the repository, or `path` when given. Call before the first render or
    build; libraries already loaded stay loaded."""
    from gfxexp_torch.csrc import build

    if path is not None:
        build.BUILD_DIR = os.path.abspath(path)
    path = build.build_dir()
    os.makedirs(path, exist_ok=True)
    return path
