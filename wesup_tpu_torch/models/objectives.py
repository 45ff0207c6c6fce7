"""WESUP training objectives: semi-supervised CE + similarity propagation.

Port of ``wesup_tpu.models.objectives``, batched: every function takes a
leading batch dimension where the JAX one takes one image (and is vmapped),
and returns per-image values.  The math is the same, masked over a fixed K
instead of reordering labeled superpixels first as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def semi_cross_entropy(y_hat: torch.Tensor, y_true: torch.Tensor,
                       class_weights=None,
                       epsilon: float = 1e-7) -> torch.Tensor:
    """Cross entropy over rows that have a (possibly multi-hot) label.

    Args:
        y_hat: (B, N, C) predicted probabilities.
        y_true: (B, N, C) labels; all-zero rows are excluded.
        class_weights: optional (C,) weights.

    Returns (B,) ``sum(-w * y * log(clip(y_hat))) / #labeled_rows``, or 0
    for an image with no labeled row.
    """
    y_hat = torch.clamp(y_hat, epsilon, 1.0 - epsilon)
    labeled = y_true.sum(-1) > 0
    n_labeled = labeled.to(torch.float32).sum(-1)
    ce = -y_true * torch.log(y_hat)
    if class_weights is not None:
        ce = ce * torch.as_tensor(class_weights, dtype=ce.dtype,
                                  device=ce.device)
    total = ce.sum((-2, -1))
    return torch.where(n_labeled > 0, total / n_labeled.clamp_min(1.0),
                       torch.zeros_like(total))


class Propagation(NamedTuple):
    pseudo_labels: torch.Tensor  # (B, K, C): zeros for non-propagated rows
    n_propagated: torch.Tensor   # (B,) count


def label_propagate(features: torch.Tensor, labels: torch.Tensor,
                    labeled: torch.Tensor, candidate: torch.Tensor,
                    threshold: float = 0.95) -> Propagation:
    """Similarity-graph label propagation (reference models/wesup.py:99-139).

    Each candidate (unlabeled, real) superpixel takes the label of the
    labeled superpixel with the largest affinity ``exp(-||f_i - f_j||^2)``
    iff that affinity exceeds ``threshold``; ties go to the first index.
    Features and labels are detached, as the reference detaches them.

    Args:
        features: (B, K, D) propagation features (fc3 outputs).
        labels: (B, K, C) quantized labels (zero rows where unlabeled).
        labeled: (B, K) bool mask of labeled superpixels.
        candidate: (B, K) bool mask of rows eligible to receive a label.
    """
    f = features.detach().to(torch.float32)
    labels = labels.detach()

    sq = (f * f).sum(-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (f @ f.transpose(-1, -2))
    d2 = d2.clamp_min(0.0)
    sim = torch.exp(-d2)                                      # (B, K, K)

    # only labeled columns are valid sources
    sim = sim.masked_fill(~labeled[..., None, :], float("-inf"))
    max_sim = sim.amax(-1)
    src = torch.argmax(sim, -1)                               # first maximum

    receive = candidate & (max_sim > threshold)
    got = torch.gather(labels, 1, src[..., None].expand(-1, -1,
                                                        labels.shape[-1]))
    pseudo = torch.where(receive[..., None], got, torch.zeros_like(got))
    return Propagation(pseudo, receive.to(torch.float32).sum(-1))


class WESUPLoss(NamedTuple):
    loss: torch.Tensor               # (B,)
    ce_loss: torch.Tensor
    propagate_loss: torch.Tensor
    labeled_sp_ratio: torch.Tensor
    propagated_labels: torch.Tensor


def wesup_loss(sp_pred: torch.Tensor, sp_features: torch.Tensor,
               sp_labels: torch.Tensor, labeled: torch.Tensor,
               real: torch.Tensor, *, class_weights=None,
               enable_propagation: bool = True,
               propagate_threshold: float = 0.8,
               propagate_weight: float = 0.5,
               epsilon: float = 1e-7) -> WESUPLoss:
    """Full WESUP objective per image:
    ``CE(labeled) + propagate_weight * CE(propagated unlabeled)``
    (reference WESUPTrainer.compute_loss, models/wesup.py:492-531).

    ``class_weights`` defaults to None because the reference's trainer
    binds its CE weight-free (models/wesup.py:434)."""
    ce = semi_cross_entropy(sp_pred, sp_labels, class_weights, epsilon)

    if enable_propagation:
        prop = label_propagate(sp_features, sp_labels, labeled,
                               candidate=(~labeled) & real,
                               threshold=propagate_threshold)
        prop_ce = semi_cross_entropy(sp_pred, prop.pseudo_labels,
                                     class_weights, epsilon)
        loss = ce + propagate_weight * prop_ce
        n_prop = prop.pseudo_labels.sum((-2, -1))
    else:
        prop_ce = torch.zeros_like(ce)
        n_prop = torch.zeros_like(ce)
        loss = ce

    n_real = real.to(torch.float32).sum(-1).clamp_min(1.0)
    ratio = (labeled & real).to(torch.float32).sum(-1) / n_real
    return WESUPLoss(loss, ce, prop_ce, ratio, n_prop)
