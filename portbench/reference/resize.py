"""Frozen copy of ``wesup_tpu_torch/ops/resize.py``, the plain math the
reference shares with the program's preprocessing; it stays as it is
when the program changes.  The original's text follows.

Bilinear/nearest resizes with exact ``F.interpolate`` semantics.

Port of ``wesup_tpu.ops.resize``: the resize is a pair of separable
products with dense 1-D interpolation matrices, ``out = A_h @ img @ A_w^T``
per channel, on channel-last (..., H, W, C) tensors.  The matrices are the
numpy constants of the JAX package, copied here, so the two packages resize
with the same weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) 1-D linear interpolation matrix."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        A[:, 0] = 1.0
        return A
    if align_corners:
        if out_size == 1:
            # torch samples position 0 when out==1 with align_corners=True
            A[0, 0] = 1.0
            return A
        pos = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        pos = (np.arange(out_size) + 0.5) * scale - 0.5
        pos = np.clip(pos, 0.0, in_size - 1)
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = pos - lo
    A[np.arange(out_size), lo] = 1.0 - frac
    A[np.arange(out_size), lo + 1] = frac
    return A


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Index map matching torch F.interpolate(mode='nearest')."""
    # torch 'nearest' uses floor(out_idx * in/out)
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_bilinear(img: torch.Tensor, out_hw,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of a (..., H, W, C) tensor to (..., H', W', C), in
    ``img``'s dtype.

    W is contracted first, then H, as in the JAX package."""
    H, W = img.shape[-3], img.shape[-2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    x = img
    if out_w != W:
        A_w = torch.as_tensor(_interp_matrix(W, out_w, align_corners),
                              dtype=img.dtype, device=img.device)
        x = torch.einsum("pw,...hwc->...hpc", A_w, x)
    if out_h != H:
        A_h = torch.as_tensor(_interp_matrix(H, out_h, align_corners),
                              dtype=img.dtype, device=img.device)
        x = torch.einsum("oh,...hpc->...opc", A_h, x)
    return x


def resize_w_only(img: torch.Tensor, out_w: int,
                  align_corners: bool = True) -> torch.Tensor:
    """Resize only the W axis of (B, H, W, C), in ``img``'s dtype."""
    W = img.shape[-2]
    if W == int(out_w):
        return img
    A_w = torch.as_tensor(_interp_matrix(W, int(out_w), align_corners),
                          dtype=img.dtype, device=img.device)
    return torch.einsum("pw,bhwc->bhpc", A_w, img)


def fused_upsample_sum(stage_maps, out_h: int,
                       align_corners: bool = True) -> torch.Tensor:
    """Sum of the H-upsampled (B, Hs_i, W, C) maps as ONE contraction
    against the column-concatenated interpolation matrices, in the maps'
    dtype: one full-resolution output instead of one per map plus a sum."""
    dt, dev = stage_maps[0].dtype, stage_maps[0].device
    A_cat = np.concatenate(
        [_interp_matrix(int(m.shape[1]), int(out_h), align_corners)
         for m in stage_maps], axis=1)                       # (out_h, sum Hs)
    cat = torch.cat(stage_maps, dim=1)                       # (B, sum Hs, W, C)
    B, Hsum, W, C = cat.shape
    out = torch.matmul(torch.as_tensor(A_cat, dtype=dt, device=dev),
                       cat.reshape(B, Hsum, W * C))
    return out.reshape(B, int(out_h), W, C)


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of (..., H, W, C) matching torch semantics."""
    H, W = img.shape[-3], img.shape[-2]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if (H, W) == (out_h, out_w):
        return img
    iy = torch.as_tensor(_nearest_index(H, out_h), device=img.device)
    ix = torch.as_tensor(_nearest_index(W, out_w), device=img.device)
    return img[..., iy[:, None], ix[None, :], :]
