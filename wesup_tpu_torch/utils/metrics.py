"""Batched segmentation metrics computed on the device.

Port of the device part of ``wesup_tpu.utils.metrics`` (``device_accuracy``
and ``device_dice``), which the train and eval steps accumulate without
leaving the device.  The host-side GlaS metrics are not ported
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import torch


def device_accuracy(pred: torch.Tensor, target: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Masked accuracy per image; pred/target/valid (B, H, W) -> (B,)."""
    v = valid.to(torch.float32)
    hit = (pred == target).to(torch.float32) * v
    return hit.sum((1, 2)) / v.sum((1, 2)).clamp_min(1.0)


def device_dice(pred: torch.Tensor, target: torch.Tensor,
                valid: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """Masked Dice per image; pred/target/valid (B, H, W) -> (B,)."""
    v = valid.to(torch.float32)
    S = pred.to(torch.float32) * v
    G = target.to(torch.float32) * v
    inter = (S * G).sum((1, 2))
    return 2 * inter / (S.sum((1, 2)) + G.sum((1, 2)) + epsilon)
