"""hmtpu_torch: the hmtpu HEVC encoder in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

The JAX package `hmtpu` is the reference this package is held against,
module by module; the layout and names follow it.  This package imports
neither `jax` nor `hmtpu`: what it needs from there is copied.
"""
