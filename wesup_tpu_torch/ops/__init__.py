"""Tensor ops of the port: colour space, SLIC, resizes, cell-grid pooling,
label vote, CLAHE, augmentation and the CUDA kernels' wrappers (K1-K4
``cellpool``, K5 and its backward ``pooling``, K6 and its backward K8
``adjoint``, K7 ``pool``)."""


def _kernel_modules():
    from . import adjoint, cellpool, pool, pooling

    return (cellpool, pooling, adjoint, pool)


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launches`, by name."""
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.LAUNCHES)
    return counts


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _kernel_modules():
        mod.reset_launches()
