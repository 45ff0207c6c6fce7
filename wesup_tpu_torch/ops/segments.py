"""Superpixel label vote, one-hot mean pooling and painting.

Port of ``wesup_tpu.ops.segments`` (``one_hot_assignment``,
``superpixel_stats``, ``segment_mean``, ``paint``), batched over images: the JAX functions take one
image and are vmapped, these take a leading batch dimension.  With a
``SlicPlan`` the sums come from the exact cell-grid pooling
(:func:`wesup_tpu_torch.ops.cellgrid.cell_pool`); without one, from the
dense (B, H*W, K) one-hot.  Both give the same integer sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cellgrid import cell_pool


class SuperpixelStats(NamedTuple):
    labels: torch.Tensor     # (B, K, C) float quantized one/multi-hot labels
    labeled: torch.Tensor    # (B, K) bool: has >=1 annotated pixel
    real: torch.Tensor       # (B, K) bool: has >=1 valid pixel
    counts: torch.Tensor     # (B, K) float valid-pixel counts


def one_hot_assignment(seg: torch.Tensor, K: int, valid=None,
                       dtype=torch.float32) -> torch.Tensor:
    """(B, H*W, K) one-hot matrix of (B, H, W) ``seg`` (0 for invalid px)."""
    B = seg.shape[0]
    ids = torch.arange(K, dtype=seg.dtype, device=seg.device)
    oh = (seg.reshape(B, -1, 1) == ids).to(dtype)
    if valid is not None:
        oh = oh * valid.reshape(B, -1, 1).to(dtype)
    return oh


def superpixel_stats(seg: torch.Tensor, K: int,
                     mask_onehot: torch.Tensor | None,
                     valid: torch.Tensor | None = None,
                     plan=None) -> SuperpixelStats:
    """Majority-vote labels per superpixel.

    Args:
        seg: (B, H, W) int32 assignments in [0, K).
        mask_onehot: (B, H, W, C) 0/1 annotation (point or pixel mask), or
            None for "no supervision".
        valid: (B, H, W) bool canvas-validity mask.
        plan: optional ``SlicPlan`` matching ``seg``; when given the sums use
            the exact cell-grid pooling instead of the one-hot.

    A superpixel is labeled iff it holds an annotated pixel; its label is
    the class-count vector quantized by ``== max`` (ties give multi-hot
    rows, as in the reference).
    """
    B = seg.shape[0]
    C = 0 if mask_onehot is None else mask_onehot.shape[-1]
    if plan is not None:
        if plan.n_clusters != K:
            raise ValueError(f"plan has {plan.n_clusters} clusters, K={K}")
        ones = torch.ones(seg.shape + (1,), dtype=torch.float32,
                          device=seg.device)
        x = (ones if mask_onehot is None else
             torch.cat([mask_onehot.to(torch.float32), ones], -1))
        pooled = cell_pool(plan, seg, x, valid)               # (B, K, C + 1)
        sums, counts = pooled[..., :C], pooled[..., C]
    else:
        oh = one_hot_assignment(seg, K, valid)                # (B, HW, K)
        counts = oh.sum(1)
        sums = (None if mask_onehot is None else oh.transpose(1, 2)
                @ mask_onehot.reshape(B, -1, C).to(torch.float32))
    real = counts > 0

    if mask_onehot is None:
        labels = torch.zeros((B, K, 0), dtype=torch.float32, device=seg.device)
        labeled = torch.zeros((B, K), dtype=torch.bool, device=seg.device)
        return SuperpixelStats(labels, labeled, real, counts)

    labeled = sums.sum(-1) > 0
    quant = (sums == sums.amax(-1, keepdim=True)).to(torch.float32)
    labels = quant * labeled[..., None].to(torch.float32)
    return SuperpixelStats(labels, labeled, real, counts)


def segment_mean(features: torch.Tensor, assignment: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """Mean-pool (B, P, C) features into (B, K, C) through the (B, P, K)
    :func:`one_hot_assignment`, in the features' dtype with f32 sums."""
    pooled = torch.einsum("bpk,bpc->bkc",
                          assignment.to(features.dtype).to(torch.float32),
                          features.to(torch.float32))
    return pooled / counts[..., None].clamp_min(1.0)


def paint(seg: torch.Tensor, sp_values: torch.Tensor) -> torch.Tensor:
    """Per-superpixel values (B, K) or (B, K, C) painted back to the
    (B, H, W) ids in [0, K): ``sp_values[b, seg[b, h, w]]``, a gather."""
    B, H, W = seg.shape
    idx = seg.reshape(B, H * W).long()
    if sp_values.ndim == 2:
        return torch.gather(sp_values, 1, idx).reshape(B, H, W)
    C = sp_values.shape[-1]
    out = torch.gather(sp_values, 1, idx[..., None].expand(B, H * W, C))
    return out.reshape(B, H, W, C)
