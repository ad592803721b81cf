"""gfxexp_torch — the PyTorch and CUDA port of gfxexp_tpu.

The JAX package `gfxexp_tpu` is the reference; every module here has its
counterpart at the same path there. This package imports `torch` and never
`jax`.

Subpackages:
  core    RNG, vector math, sampling distributions
  scene   scene data model (dataclasses of tensors), host builder, lights
  accel   host BVH build (numpy + native C++), wide-row table, traversal
  csrc    hand-written CUDA kernels and their nvcc build
  render  camera, BSDFs, wavefront path tracer
  utils   image output

Entry point: `python -m gfxexp_torch.bench` (needs a CUDA device).
"""

__version__ = "0.1.0"
