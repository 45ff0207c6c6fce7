"""``conv_roofline.<train|predict|tile>``: the VGG16 convolutions' share
of the bf16 peak in the traced stretch (%).

FLOPs from shapes: each of the 13 3x3 convolutions at its stage's
resolution, ``2 * h * w * c_in * c_out * 9`` per image of the content
size (the padding the program adds to a multiple of 32 is not useful
work); a train step counts three times its forward (the forward, the
input gradient and the weight gradient).  Device time: every kernel
whose name matches :data:`PATTERN` (cuDNN's and CUTLASS's implicit-GEMM
convolution kernels, forward and both gradients).
"""

from __future__ import annotations

import re

from ..gen.weights import VGG16_CFG
from .peaks import BF16_FLOPS

PATTERN = re.compile(r"fprop|dgrad|wgrad|implicit_gemm|implicit_convolve|"
                     r"conv2d|convolution|winograd", re.I)
PASSES = {"train": 3}


def conv_flops(h: float, w: float) -> float:
    """Forward FLOPs of VGG16's 13 convolutions on one h x w image."""
    total, c_in, scale = 0.0, 3, 1
    for c in VGG16_CFG:
        if c == "M":
            scale *= 2
            continue
        total += 2.0 * (h / scale) * (w / scale) * c_in * c * 9
        c_in = c
    return total


def work_conv_flops(work) -> float:
    return sum(PASSES.get(r["kind"], 1) * conv_flops(h, w)
               for r in work for h, w in r["content"])


def kernel_seconds(op_s: dict, pattern=PATTERN) -> float:
    return sum(s for name, s in op_s.items() if pattern.search(name))


def read(name, ctx):
    t = kernel_seconds(ctx["trace"]["op_s"])
    flops = work_conv_flops(ctx["traced_work"])
    if t <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (t * BF16_FLOPS)
