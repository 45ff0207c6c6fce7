"""WESUP weights made from the seed on the device, in a few large draws.

The names and shapes are the reference WESUP's (torchvision's VGG16
``features`` at ``backbone.{i}``, thirteen 1x1 side convs
``side_conv{cum}`` that halve each tap, ``fc_layers.{0,2,4}`` and
``classifier.0``), written out here so that the reference in
``portbench/reference`` builds the same state without the program.
Scales follow the published initialisation: He-normal conv weights with
zero biases, ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for the side convs
and the linear layers.  The parameters are float32, the type the
program keeps them in (it casts to the compute dtype per forward).
"""

from __future__ import annotations

import math

import torch

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
CONV_CHANNELS = [c for c in VGG16_CFG if c != "M"]
# torchvision's module index of each conv in ``features``
CONV_INDICES = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
# pooling layers before each conv: its resolution stage
CONV_STAGE = [0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4]
HYPER_CHANNELS = sum(c // 2 for c in CONV_CHANNELS)      # 2112


def side_names() -> list:
    names, cum = [], 0
    for c in CONV_CHANNELS:
        names.append(f"side_conv{cum}")
        cum += c // 2
    return names


def layout(fc_width: int = 1024, D: int = 32, n_classes: int = 2) -> list:
    """``(name, shape, kind, scale)`` of every tensor: kind ``normal``
    (times scale), ``uniform`` (in [-scale, scale]) or ``zero``."""
    out, cin = [], 3
    for idx, c in zip(CONV_INDICES, CONV_CHANNELS):
        out.append((f"backbone.{idx}.weight", (c, cin, 3, 3), "normal",
                    math.sqrt(2.0 / (9 * cin))))
        out.append((f"backbone.{idx}.bias", (c,), "zero", 0.0))
        cin = c
    linears = [(n, (c // 2, c, 1, 1)) for n, c in zip(side_names(),
                                                      CONV_CHANNELS)]
    linears += [("fc_layers.0", (fc_width, HYPER_CHANNELS)),
                ("fc_layers.2", (fc_width, fc_width)),
                ("fc_layers.4", (D, fc_width)),
                ("classifier.0", (n_classes, D))]
    for name, shape in linears:
        bound = 1.0 / math.sqrt(math.prod(shape[1:]))
        out.append((f"{name}.weight", shape, "uniform", bound))
        out.append((f"{name}.bias", (shape[0],), "uniform", bound))
    return out


def make_state(seed: int, device, fc_width: int = 1024, D: int = 32,
               n_classes: int = 2) -> dict:
    """The state dict for ``seed``: one normal and one uniform draw from a
    generator on ``device``, cut into the tensors and scaled."""
    items = layout(fc_width, D, n_classes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_norm = sum(math.prod(s) for _, s, k, _ in items if k == "normal")
    n_unif = sum(math.prod(s) for _, s, k, _ in items if k == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device).mul_(2).sub_(1)
    state, pos = {}, {"normal": 0, "uniform": 0}
    for name, shape, kind, scale in items:
        n = math.prod(shape)
        if kind == "zero":
            state[name] = torch.zeros(shape, device=device)
            continue
        src = normal if kind == "normal" else unif
        state[name] = src[pos[kind]:pos[kind] + n].view(shape) * scale
        pos[kind] += n
    return state
