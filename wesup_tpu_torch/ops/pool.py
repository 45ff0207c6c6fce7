"""Fused ReLU + 2x2/2 max pool + channel zero-pad, kernel K7.

Port of ``wesup_tpu/ops/pool_pallas.py::fused_relu_pool_pad``: the VGG16
stage-1 pool reads conv1_2's PRE-ReLU output once and writes the pooled
tensor straight in the width conv2_1 reads,

    out[b, i, j, c] = relu(max of pre[b, 2i:2i+2, 2j:2j+2, c])   c <  C
    out[b, i, j, c] = 0                                          c >= C

(relu commutes with max; VALID pooling, so an odd last row or column is
dropped, as ``max_pool2d`` drops it).  ``pre`` is (B, H, W, C) NHWC, the
layout of the backbone's taps (the NHWC view of a channels_last conv
output); the result is a contiguous (B, H/2, W/2, out_channels) NHWC
tensor, so its NCHW view is channels_last.

:func:`fused_relu_pool_pad` is a ``torch.autograd.Function``: on a CUDA
tensor its forward launches the hand-written kernel in ``csrc/pool.cu`` (or
raises); on a CPU tensor it runs :func:`reference`, the plain composition
relu -> ``max_pool2d`` -> pad.  Its backward replays :func:`reference`
under autograd, as the JAX custom VJP replays it with ``jax.vjp``, so the
gradient routes through ``max_pool2d`` exactly as the unfused path's does.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import tracing
from .cellpool import _DTYPE_CODE, _check, _raise_on_error, _stream_ptr

# kernel launches since the last reset_launches(), by kernel name: a view
# of the tracer's counters launches.<kernel>
LAUNCHES = tracing.CounterView("launches.", ("fused_relu_pool_pad",))


def reset_launches() -> None:
    LAUNCHES.reset()


def reference(pre: torch.Tensor, out_channels: int) -> torch.Tensor:
    """The plain composition K7 replaces (and its backward replays)."""
    x = F.max_pool2d(F.relu(pre).permute(0, 3, 1, 2), 2, 2)
    x = x.permute(0, 2, 3, 1)
    C = pre.shape[-1]
    if out_channels > C:
        x = F.pad(x, (0, out_channels - C))
    return x


def _kernel(pre: torch.Tensor, out_channels: int) -> torch.Tensor:
    B, H, W, C = pre.shape
    _check("pre", pre, (B, H, W, C), _DTYPE_CODE, pre.device)
    from ._build import library

    lib = library()
    out = torch.empty((B, H // 2, W // 2, out_channels), dtype=pre.dtype,
                      device=pre.device)
    with torch.cuda.device(pre.device):   # launch on the tensors' card
        err = lib.wesup_fused_relu_pool_pad(
            pre.data_ptr(), out.data_ptr(), B, H, W, C, out_channels,
            _DTYPE_CODE[pre.dtype], _stream_ptr(pre.device))
    _raise_on_error("fused_relu_pool_pad", err)
    tracing.count("launches.fused_relu_pool_pad")
    return out


class _FusedPoolFn(torch.autograd.Function):
    """K7 forward; the backward replays :func:`reference`."""

    @staticmethod
    def forward(ctx, pre, out_channels):
        ctx.out_channels = out_channels
        ctx.save_for_backward(pre)
        if pre.device.type == "cpu":
            return reference(pre, out_channels)
        if pre.device.type != "cuda":
            raise ValueError(f"fused_relu_pool_pad: unsupported device "
                             f"{pre.device}")
        return _kernel(pre, out_channels)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (pre,) = ctx.saved_tensors
        with torch.enable_grad():
            p = pre.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(reference(p, ctx.out_channels), p,
                                       grad)
        return g, None


def fused_relu_pool_pad(pre: torch.Tensor, out_channels: int) -> torch.Tensor:
    """relu -> 2x2/2 max pool -> zero-pad channels to ``out_channels``.

    ``pre`` is a (B, H, W, C) NHWC pre-activation (contiguous in that
    layout on the card; f32 or bf16 there, any float dtype on the CPU);
    returns (B, H // 2, W // 2, out_channels) with channels C: zero."""
    if int(out_channels) < pre.shape[-1]:
        raise ValueError(f"out_channels={out_channels} is below the input's "
                         f"{pre.shape[-1]} channels")
    return _FusedPoolFn.apply(pre, int(out_channels))
