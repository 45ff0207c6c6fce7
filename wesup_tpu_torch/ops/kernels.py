"""The seam between the port and its hand-written CUDA kernels.

Every kernel is declared once, in :data:`KERNELS`: the name its launches
are counted under, the C function of ``wesup_tpu_torch/csrc/*.cu`` that
launches it and that function's argument types.  :func:`launch` is the one
place that calls the library: it guards the tensors' card, appends the
current stream, raises ``RuntimeError`` naming the kernel on a nonzero
CUDA error code and, after a success, adds one to the tracer's counter
``launches.<name>`` (read by :func:`launch_counts`).  The wrappers
(``cellpool``, ``pooling``, ``adjoint``, ``pool``, ``tile``, ``hypercol``,
``pixhead``) keep their argument checks, their CPU branch to the plain
version, their output allocation and one :func:`launch` per kernel call.

The library is built on first use by :func:`wesup_tpu_torch.native.load`:
each ``.cu`` source by its own nvcc process (``$CUDA_HOME/bin/nvcc`` where
none is on ``PATH``), all started together, for ``sm_90a``, then one link.
The kernels have a plain C interface (pointers and the stream as
``void*``), so the build needs no PyTorch headers and takes seconds.
Nothing here builds at import time.

Adding a kernel takes its ``.cu``, one :data:`KERNELS` line, its wrapper
and its tests.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import NamedTuple

import torch

from .. import native, tracing

SOURCE_DIR = native.CSRC
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Kernel(NamedTuple):
    """One kernel: the C function that launches it, that function's
    argument types before the stream (which :func:`launch` appends), and
    the tracer's counter of its launches."""

    symbol: str
    argtypes: tuple
    counter: str


def _kernel(name: str, symbol: str, argtypes: list):
    return name, Kernel(symbol, tuple(argtypes), "launches." + name)


# every kernel, in launch_counts() order
KERNELS = dict((
    # K1, K2 and their backward bodies K3, K4 (csrc/cellpool.cu)
    _kernel("cell_pool0", "wesup_cell_pool0", [_P] * 7 + [_I] * 7),
    _kernel("cell_pool_stage", "wesup_cell_pool_stage", [_P] * 9 + [_I] * 11),
    _kernel("cell_pool0_bwd", "wesup_cell_pool0_bwd", [_P] * 3 + [_I] * 6),
    _kernel("cell_pool_stage_bwd", "wesup_cell_pool_stage_bwd",
            [_P] * 5 + [_I] * 11),
    # K5 (csrc/pooling.cu); its backward runs K3's body over a flat pixel axis
    _kernel("segment_sum", "wesup_segment_sum", [_P] * 4 + [_I] * 5),
    _kernel("segment_sum_bwd", "wesup_cell_pool0_bwd", [_P] * 3 + [_I] * 6),
    # K6 and its backward K8 (csrc/adjoint.cu)
    _kernel("adjoint_pool_stage", "wesup_adjoint_pool_stage",
            [_P] * 3 + [_L] * 4 + [_P] * 4 + [_I] * 6),
    _kernel("adjoint_pool_stage_bwd", "wesup_adjoint_pool_stage_bwd",
            [_P] * 2 + [_L] * 3 + [_P] * 6 + [_I] * 8),
    # K7 (csrc/pool.cu)
    _kernel("fused_relu_pool_pad", "wesup_fused_relu_pool_pad",
            [_P] * 2 + [_I] * 6),
    # the tile cut and stitch (csrc/tile.cu)
    _kernel("tile_cut", "wesup_tile_cut", [_P] * 4 + [_I] * 9),
    _kernel("tile_stitch", "wesup_tile_stitch", [_P] * 4 + [_I] * 8),
    # the pixel head's upsample (csrc/hypercol.cu)
    _kernel("hypercol_upsample", "wesup_hypercol_upsample",
            [_P] * 11 + [_I] * 14),
    # the pixel head after fc2 (csrc/pixhead.cu)
    _kernel("pixel_head", "wesup_pixel_head", [_P] * 7 + [_L] + [_I] * 4),
))

_SIGNATURES = {k.symbol: (ctypes.c_int, [*k.argtypes, _P])
               for k in KERNELS.values()}

# the kernels' codes of the tensors' dtypes
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def recipe():
    """What :func:`library` builds: nvcc, its flags, the ``.cu`` sources
    and the headers they include."""
    return ([_nvcc()], list(NVCC_FLAGS), sorted(SOURCE_DIR.glob("*.cu")),
            sorted(SOURCE_DIR.glob("*.cuh")))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return native.load("wesup_cuda", _SIGNATURES, recipe)


def launch(name: str, device, *args) -> None:
    """Launch the kernel ``name`` with ``args`` on ``device``'s current
    stream; raise ``RuntimeError`` if its launch function returns a CUDA
    error, else count the launch."""
    kernel = KERNELS[name]
    fn = getattr(library(), kernel.symbol)
    with torch.cuda.device(device):   # launch on the tensors' card
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    tracing.count(kernel.counter)


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launches`, by name."""
    counters = tracing.counters()
    return {name: counters.get(k.counter, 0) for name, k in KERNELS.items()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    tracing.reset(k.counter for k in KERNELS.values())


def check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    """Raise unless tensor ``name`` is on ``device``, of one of ``dtypes``,
    of ``shape`` and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_const_cache: dict = {}


def device_const(key, build):
    """Per-device copy of a numpy constant, built once.

    Built outside inference mode even when the first caller runs under
    ``torch.inference_mode`` (the predict steps): a cached inference tensor
    would raise later when a train step's autograd saves it."""
    got = _const_cache.get(key)
    if got is None:
        with torch.inference_mode(False):
            got = build()
        _const_cache[key] = got
    return got
