"""Frozen copy of ``wesup_tpu_torch/ops/clahe.py``, the plain math the
reference shares with the program's preprocessing; it stays as it is
when the program changes.  The original's text follows.

CLAHE (contrast-limited adaptive histogram equalization) on the device.

Port of ``wesup_tpu.ops.clahe``, batched: clip limit 4.0, an 8x8 tile grid,
on the L channel of LAB, as the reference's albumentations CLAHE.  The
design is the JAX one: a (B, H, W, 256) f32 one-hot of the rounded L
values, tile histograms by two 0/1 binning matmuls, clipped histograms with
the excess spread uniformly, per-tile LUTs bilinearly interpolated to every
pixel, and each pixel's LUT entry picked by its bin.  The pick is a gather
here (the JAX version contracts the one-hot); it selects the same value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .colorspace import rgb2lab
from .resize import resize_bilinear

_BINS = 256


@functools.lru_cache(maxsize=None)
def _tile_binning(size: int, tiles: int) -> np.ndarray:
    """(tiles, size) 0/1 matrix assigning each row/col to its tile."""
    idx = np.minimum((np.arange(size) * tiles) // size, tiles - 1)
    B = np.zeros((tiles, size), np.float32)
    B[idx, np.arange(size)] = 1.0
    return B


def clahe_plane(x: torch.Tensor, clip_limit: float = 4.0,
                tiles: int = 8) -> torch.Tensor:
    """CLAHE on (B, H, W) planes of uint8-valued floats in [0, 255]."""
    H, W = x.shape[-2:]
    dev = x.device
    v = torch.clamp(torch.round(x), 0, 255).to(torch.int64)
    bins = torch.arange(_BINS, dtype=torch.int64, device=dev)
    onehot = (v[..., None] == bins).to(torch.float32)        # (B, H, W, 256)

    Bh = torch.as_tensor(_tile_binning(H, tiles), device=dev)
    Bw = torch.as_tensor(_tile_binning(W, tiles), device=dev)
    hist = torch.einsum("th,bhwk->btwk", Bh, onehot)
    hist = torch.einsum("sw,btwk->btsk", Bw, hist)     # (B, tiles, tiles, 256)

    tile_area = Bh.sum(1)[:, None, None] * Bw.sum(1)[None, :, None]
    limit = torch.clamp_min(clip_limit * tile_area / _BINS, 1.0)
    clipped = torch.minimum(hist, limit)
    excess = (hist - clipped).sum(-1, keepdim=True)
    clipped = clipped + excess / _BINS

    cdf = torch.cumsum(clipped, -1)
    lut = torch.clamp(torch.round(cdf * (255.0 / tile_area)), 0, 255)

    # per-pixel LUT by bilinear interpolation of the tile LUTs, then each
    # pixel's entry at its own bin
    lut_pix = resize_bilinear(lut, (H, W), align_corners=False)
    return torch.gather(lut_pix, -1, v[..., None])[..., 0]


def clahe_rgb(img: torch.Tensor, clip_limit: float = 4.0,
              tiles: int = 8) -> torch.Tensor:
    """CLAHE on the L channel of LAB for (B, H, W, 3) RGB images in [0, 1].

    The LAB -> RGB return trip is approximated, as in the JAX package, by
    scaling RGB with the luminance ratio (hue is kept exactly)."""
    lab = rgb2lab(torch.clamp(img, 0.0, 1.0))
    L = lab[..., 0] * (255.0 / 100.0)
    L_eq = clahe_plane(L, clip_limit, tiles) * (100.0 / 255.0)
    ratio = (L_eq + 1e-6) / (lab[..., 0] + 1e-6)
    return torch.clamp(img * ratio[..., None], 0.0, 1.0)
