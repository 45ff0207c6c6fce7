"""VGG16 feature backbone returning the 13 pre-ReLU conv outputs.

Port of ``wesup_tpu.models.vgg``: torchvision's ``vgg16().features`` layout
(conv modules at the same ``backbone.{i}`` indices, so a reference
checkpoint loads as it is), built here because the card's machine has no
torchvision.  The hypercolumn taps are the conv outputs BEFORE the ReLU, as
the reference's forward hooks see them.

The convolutions run in ``channels_last``, so the NHWC view of each tap
(``permute(0, 2, 3, 1)``) is contiguous without a copy, which is the layout
the pooling kernels read.
"""

from __future__ import annotations

from typing import List, Tuple

import math

import torch
import torch.nn.functional as F
from torch import nn

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


def backbone_features(backbone: nn.Sequential, img: torch.Tensor,
                      compute_dtype=torch.float32) -> List[torch.Tensor]:
    """Run VGG16 features on (B, H, W, 3) input in [0, 1].

    Returns the 13 pre-ReLU conv outputs, each a (B, Hs, Ws, Cs) NHWC view
    in ``compute_dtype``.  As in the reference, the image is not
    ImageNet-normalized.  Each conv adds its bias after the convolution has
    been rounded to ``compute_dtype``, as the JAX package does.
    """
    x = img.permute(0, 3, 1, 2).to(compute_dtype).contiguous(
        memory_format=torch.channels_last)
    taps = []
    for layer in backbone:
        if isinstance(layer, nn.Conv2d):
            w = layer.weight.to(compute_dtype).contiguous(
                memory_format=torch.channels_last)
            pre = F.conv2d(x, w, padding=1)
            pre = pre + layer.bias.to(compute_dtype)[:, None, None]
            taps.append(pre.permute(0, 2, 3, 1))
            x = F.relu(pre)
        elif isinstance(layer, nn.MaxPool2d):
            x = F.max_pool2d(x, 2, 2)
    return taps
