"""gfxexp_torch — the PyTorch and CUDA port of gfxexp_tpu.

The JAX package `gfxexp_tpu` is the reference; every module here has its
counterpart at the same path there. This package imports `torch` and never
`jax`.

Subpackages:
  core    RNG, vector math, sampling distributions
  scene   scene data model (dataclasses of tensors), host builder, mesh
          loaders, lights, textures, animation
  accel   host BVH build (numpy + native C++), wide-row table, traversal
  csrc    hand-written CUDA kernels and their nvcc build
  render  camera, BSDFs, wavefront path tracer, G-buffer
  techniques  SVGF, ReSTIR DI, ReGIR, NRC, TFDM
  apps    the technique CLIs and their shared DSL
  utils   image I/O, checkpoints

Entry point: `python -m gfxexp_torch.bench` (needs a CUDA device).
"""

__version__ = "0.1.0"
