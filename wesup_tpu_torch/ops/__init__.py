"""Tensor ops of the port: colour space, SLIC, resizes, cell-grid pooling,
label vote, CLAHE, augmentation and the CUDA kernels' wrappers (K1-K4
``cellpool``, K5 and its backward ``pooling``, K6 and its backward K8
``adjoint``, K7 ``pool``, the tile cut and stitch ``tile``, the pixel
head's upsample ``hypercol`` and its tail after fc2 ``pixhead``), which
launch them through ``kernels``."""

from .kernels import launch_counts, reset_launches

__all__ = ["launch_counts", "reset_launches"]
