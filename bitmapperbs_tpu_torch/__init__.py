"""PyTorch + CUDA port of the bitmapperbs_tpu single-end mapping path.

The JAX package `bitmapperbs_tpu` is the reference: every module here
reproduces its counterpart's outputs bit for bit (same (best, second)
tuples, same SAM bytes).  The jax-free reference modules (index build, io,
oracle, finalize, config, constants) are imported as they are; nothing in
this package imports jax.

On a CUDA device the two verification loops run as hand-written kernels
(csrc/verify.cu, bound in ops/kernels.py); on the CPU the same wrappers run
their plain PyTorch versions, which the CPU tests hold to the JAX reference.
"""
