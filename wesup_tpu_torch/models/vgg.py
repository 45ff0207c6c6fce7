"""VGG16 feature backbone returning the 13 pre-ReLU conv outputs.

Port of ``wesup_tpu.models.vgg``: torchvision's ``vgg16().features`` layout
(conv modules at the same ``backbone.{i}`` indices, so a reference
checkpoint loads as it is), built here because the card's machine has no
torchvision.  The hypercolumn taps are the conv outputs BEFORE the ReLU, as
the reference's forward hooks see them.

The convolutions run in ``channels_last``, so the NHWC view of each tap
(``permute(0, 2, 3, 1)``) is contiguous without a copy, which is the layout
the pooling kernels read.

``WESUP_FUSED_POOL1=1`` (read at call time, default off, as in the JAX
package) replaces the stage-1 relu + max pool by kernel K7
(:func:`wesup_tpu_torch.ops.pool.fused_relu_pool_pad`), which writes the
pooled tensor zero-padded to 128 channels; conv2_1's weight gets zero input
channels to match, which leaves its output unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool import fused_relu_pool_pad
from ..tracing import span

# torchvision vgg16 'D' configuration
VGG16_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                    512, 512, 512, "M", 512, 512, 512, "M")

# output channels of the 13 convs, in order
CONV_CHANNELS: List[int] = [c for c in VGG16_CFG if c != "M"]

# index of the torchvision `features` module for each conv
TORCH_CONV_INDICES: List[int] = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

# number of pooling layers *before* each conv -> its resolution level (0..4)
CONV_STAGE: List[int] = [0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4]

# hypercolumn channel count after halving side convs: sum(c // 2) == 2112
FM_CHANNELS_SUM: int = sum(c // 2 for c in CONV_CHANNELS)


def make_backbone() -> nn.Sequential:
    """torchvision's vgg16 ``features`` module layout (conv, ReLU, pool)."""
    layers, in_ch = [], 3
    for c in VGG16_CFG:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, c, 3, padding=1), nn.ReLU(inplace=True)]
            in_ch = c
    return nn.Sequential(*layers)


@torch.no_grad()
def init_backbone_(backbone: nn.Sequential, generator: torch.Generator) -> None:
    """He-normal weights and zero biases, as ``wesup_tpu.models.vgg``."""
    for layer in backbone:
        if isinstance(layer, nn.Conv2d):
            fan_in = 9 * layer.in_channels
            layer.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                 generator=generator)
            layer.bias.zero_()


def _fused_pool1_ok(pre: torch.Tensor) -> bool:
    """Use kernel K7 for the stage-1 pool (64 -> 128 channels)?

    Off unless ``WESUP_FUSED_POOL1=1``, as in the JAX package.  Where the
    JAX gate also needs a single TPU device, this one takes a CUDA tensor
    (K7 itself) or a CPU tensor (its plain version)."""
    if os.environ.get("WESUP_FUSED_POOL1", "0") != "1":
        return False
    return pre.shape[-1] == 64 and pre.device.type in ("cuda", "cpu")


def backbone_features(backbone: nn.Sequential, img: torch.Tensor,
                      compute_dtype=torch.float32) -> List[torch.Tensor]:
    """Run VGG16 features on (B, H, W, 3) input in [0, 1].

    Returns the 13 pre-ReLU conv outputs, each a (B, Hs, Ws, Cs) NHWC view
    in ``compute_dtype``.  As in the reference, the image is not
    ImageNet-normalized.  Each conv adds its bias after the convolution has
    been rounded to ``compute_dtype``, as the JAX package does.  K7 runs
    in a ``wesup.step.k7`` span.
    """
    x = img.permute(0, 3, 1, 2).to(compute_dtype).contiguous(
        memory_format=torch.channels_last)
    taps, pre = [], None     # x is None while the last conv's relu is due
    for layer in backbone:
        if isinstance(layer, nn.Conv2d):
            if x is None:
                x = F.relu(pre)
            w = layer.weight.to(compute_dtype)
            if w.shape[1] != x.shape[1]:
                # input widened with zero channels by K7: widen the kernel
                # with zero input channels to match (same output)
                w = F.pad(w, (0, 0, 0, 0, 0, x.shape[1] - w.shape[1]))
            w = w.contiguous(memory_format=torch.channels_last)
            pre = F.conv2d(x, w, padding=1)
            pre = pre + layer.bias.to(compute_dtype)[:, None, None]
            taps.append(pre.permute(0, 2, 3, 1))
            x = None
        elif isinstance(layer, nn.MaxPool2d):
            if _fused_pool1_ok(taps[-1]):
                # one pass over the PRE-ReLU tap: relu + pool + zero-pad to
                # conv2_1's 128-channel input; its NCHW view is channels_last
                with span("wesup.step.k7"):
                    x = fused_relu_pool_pad(taps[-1], 128).permute(0, 3, 1, 2)
            else:
                x = F.max_pool2d(F.relu(pre), 2, 2)
    return taps
