"""The plain WESUP forward in float32, written from the published model.

VGG16's 13 convolutions (3x3, padding 1) with ReLU and 2x2 max pools;
each pre-ReLU conv output through its 1x1 side conv (half its channels),
upsampled bilinearly (align_corners=True) to the input's size and
concatenated into the 2112-channel hypercolumn of every pixel; then the
head fc1 (2112 -> 1024) -> ReLU -> fc2 -> ReLU -> fc3 (-> 32, the
propagation features) -> ReLU -> classifier -> softmax.  The superpixel
forward averages each superpixel's hypercolumns over its valid pixels
before the head; the pixel forward runs the head on every pixel.  No
kernel, no fusion, no batching beyond one image: the straightforward
form of the equations.  The image is not normalised, as in the model.

``quant``, where given (``fp8``), rounds the input and the weight of
every convolution and linear layer before it runs and the gradient that
reaches its output (the control: the same reference in a lower
precision).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..gen.weights import CONV_CHANNELS, CONV_INDICES, VGG16_CFG, side_names

FP8_MAX = 448.0          # e4m3's largest finite value
FP8_GRAD_MAX = 57344.0   # e5m2's


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to the 8-bit float ``dtype`` with one scale for the
    tensor (its largest magnitude at the format's largest value)."""
    s = x.abs().amax().clamp_min(1e-30) / largest
    return (x / s).to(dtype).to(torch.float32) * s


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_GRAD_MAX)


class Fp8:
    """The precision below bfloat16, as an 8-bit float pipeline computes:
    every convolution's and linear layer's input and weight rounded to
    e4m3 (``__call__``, a straight-through rounding) and the gradient
    that reaches its output rounded to e5m2 (``out``), each with one
    scale per tensor; the arithmetic in between is float32."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        q = _round(x.detach(), torch.float8_e4m3fn, FP8_MAX)
        return x + (q - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y) if y.requires_grad else y


fp8 = Fp8()


def _q(quant, x):
    return x if quant is None else quant(x)


def _conv(x, w, b, quant, padding):
    y = F.conv2d(_q(quant, x), _q(quant, w), b, padding=padding)
    return y if quant is None else quant.out(y)


def _linear(x, w, b, quant):
    y = F.linear(_q(quant, x), _q(quant, w), b)
    return y if quant is None else quant.out(y)


def hypercolumn(state: dict, img: torch.Tensor, quant=None) -> torch.Tensor:
    """(H, W, 3) image in [0, 1] -> (2112, H, W) hypercolumns."""
    H, W = img.shape[:2]
    x = img.permute(2, 0, 1)[None].float()
    taps, convs = [], iter(zip(CONV_INDICES, side_names(), CONV_CHANNELS))
    for c in VGG16_CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        idx, side, _ = next(convs)
        pre = _conv(x, state[f"backbone.{idx}.weight"],
                    state[f"backbone.{idx}.bias"], quant, 1)
        s = _conv(pre, state[f"{side}.weight"], state[f"{side}.bias"], quant,
                  0)
        taps.append(F.interpolate(s, size=(H, W), mode="bilinear",
                                  align_corners=True))
        x = F.relu(pre)
    return torch.cat(taps, 1)[0]


def head(state: dict, x: torch.Tensor, quant=None):
    """(N, 2112) -> (softmax probabilities (N, C), fc3 features (N, D))."""
    h = F.relu(_linear(x, state["fc_layers.0.weight"],
                       state["fc_layers.0.bias"], quant))
    h = F.relu(_linear(h, state["fc_layers.2.weight"],
                       state["fc_layers.2.bias"], quant))
    feats = F.relu(_linear(h, state["fc_layers.4.weight"],
                           state["fc_layers.4.bias"], quant))
    logits = _linear(feats, state["classifier.0.weight"],
                     state["classifier.0.bias"], quant)
    return torch.softmax(logits, -1), feats


def superpixel_forward(state, img, seg, valid, K: int, quant=None):
    """One image: (H, W, 3), (H, W) ids in [0, K), (H, W) bool ->
    (probabilities (K, C), features (K, D)).  A superpixel without a
    valid pixel gets the head of a zero mean."""
    hyper = hypercolumn(state, img, quant)
    C = hyper.shape[0]
    ids = seg.reshape(-1).long()
    keep = valid.reshape(-1)
    flat = hyper.reshape(C, -1)[:, keep].t()
    sums = torch.zeros((K, C), device=img.device).index_add(0, ids[keep],
                                                            flat)
    counts = torch.zeros(K, device=img.device).index_add(
        0, ids[keep], torch.ones(int(keep.sum()), device=img.device))
    return head(state, sums / counts.clamp_min(1.0)[:, None], quant)


def pixel_forward(state, img, quant=None) -> torch.Tensor:
    """One image (H, W, 3) -> (H, W) foreground probability of every
    pixel."""
    hyper = hypercolumn(state, img, quant)
    C, H, W = hyper.shape
    probs, _ = head(state, hyper.reshape(C, -1).t(), quant)
    return probs[:, 1].reshape(H, W)
