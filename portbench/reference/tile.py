"""Plain tiled pixel-wise inference of one slide.

The patches' top-left corners are ``np.linspace``-spaced over the slide
(as the original ``infer_tile``); each patch, in [0, 1], is padded by
repeating its last column and row up to a multiple of 32 (the padding
the program documents for its forward), run through the plain pixel
forward, cropped back, and the overlapping patches are averaged
(a sum and a count per pixel).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .model import pixel_forward


@contextlib.contextmanager
def plain_precision():
    """Float32 matmuls and convolutions without TF32, under no_grad."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def corners(height: int, width: int, patch: int) -> list:
    tops = np.linspace(0, height - patch, math.ceil(height / patch), dtype=int)
    lefts = np.linspace(0, width - patch, math.ceil(width / patch), dtype=int)
    return [(int(t), int(l)) for t in tops for l in lefts]


def stitched(state: dict, slide: np.ndarray, patch: int,
             quant=None) -> np.ndarray:
    """(H, W, 3) uint8 slide -> (H, W) float64 foreground probability."""
    dev = next(iter(state.values())).device
    H, W = slide.shape[:2]
    img = torch.from_numpy(slide).to(dev).float() / 255.0
    total = torch.zeros((H, W), dtype=torch.float64, device=dev)
    count = torch.zeros((H, W), dtype=torch.float64, device=dev)
    pad = (-patch) % 32
    for t, l in corners(H, W, patch):
        x = img[t:t + patch, l:l + patch].permute(2, 0, 1)[None]
        x = F.pad(x, (0, pad, 0, pad), mode="replicate")[0].permute(1, 2, 0)
        prob = pixel_forward(state, x, quant)[:patch, :patch]
        total[t:t + patch, l:l + patch] += prob.double()
        count[t:t + patch, l:l + patch] += 1
    return (total / count).cpu().numpy()
