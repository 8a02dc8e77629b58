"""PyTorch + CUDA port of the bitmapperbs_tpu single-end and paired-end
mapping paths.

The JAX package `bitmapperbs_tpu` is the reference: every module here sits
at its counterpart's relative path and reproduces its outputs bit for bit
(same (best, second) tuples, same SAM bytes, same index artifact bytes).
The package stands alone: it imports torch and numpy, never jax and nothing
of the reference package; the numpy-only modules (constants, config, index
build, io, oracle, finalize, pool) are its own copies.  What the two
packages share is the on-disk formats (index artifact v4, genome-plane
cache, SAM/BAM).

On a CUDA device the verification loops and the table row gathers run as
hand-written kernels (csrc/verify.cu, csrc/gather.cu, bound in
ops/kernels.py); on CPU tensors the same wrappers run their plain PyTorch
versions, which the CPU tests hold to the JAX reference.
"""
