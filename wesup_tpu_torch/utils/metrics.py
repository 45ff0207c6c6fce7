"""Segmentation metrics: batched ones on the device, the GlaS contest ones
on the host.

Port of ``wesup_tpu.utils.metrics``.  ``device_accuracy`` and
``device_dice`` run inside the train and eval steps and accumulate
without leaving the device.  The contest metrics (detection F1, object
Dice, [object] Hausdorff) follow the GlaS evaluation protocol as the
reference implements it (utils/metrics.py:49-281, adapted from the GlaS
contest kit); they are irregular per-connected-component computations and
run on the host in numpy, labelling and measuring through the port's
native library (``wesup_tpu_torch.native``).  Kept from the JAX package:
skimage.measure.label is the 8-connected labelling of the binarised mask,
scipy.stats.mode is a bincount argmax (the smallest label wins a tie), a
Hausdorff distance with one empty side is ``inf``, and a component that
meets no component of the other side takes the ``min`` over all of them.

:data:`HOST_METRICS` names the metrics a trainer's ``metrics=`` option
may ask for.  torch is imported by the device metrics only, so the
evaluation scripts and their worker processes do not load it.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _to_numpy(x):
    return np.asarray(x)


def _label(mask: np.ndarray) -> np.ndarray:
    return native.label8(mask)


def _mode_positive(values: np.ndarray) -> int:
    """Most frequent positive value (scipy.stats.mode on the intersect)."""
    counts = np.bincount(values)
    return int(np.argmax(counts))


# ---------------------------------------------------------------------------
# Pixel metrics (on the device too, see device_accuracy / device_dice)
# ---------------------------------------------------------------------------

def accuracy(P, G):
    """Classification accuracy (reference utils/metrics.py:31-45)."""
    P, G = _to_numpy(P), _to_numpy(G)
    return float((P == G).mean())


def dice(S, G, epsilon: float = 1e-7):
    """Dice index (reference utils/metrics.py:112-135)."""
    S, G = _to_numpy(S).astype(np.float64), _to_numpy(G).astype(np.float64)
    S = S[None] if S.ndim == 2 else S
    G = G[None] if G.ndim == 2 else G
    score = 2 * (G * S).sum(axis=(1, 2)) / (
        G.sum(axis=(1, 2)) + S.sum(axis=(1, 2)) + epsilon)
    return float(score.mean())


# ---------------------------------------------------------------------------
# GlaS contest object metrics
# ---------------------------------------------------------------------------

def detection_f1(S, G, overlap_threshold: float = 0.5, epsilon: float = 1e-7):
    """Object detection F1 with >=50% overlap TP matching
    (reference utils/metrics.py:49-109)."""
    S, G = _label(S), _label(G)
    num_S, num_G = S.max(), G.max()

    if num_S == 0 and num_G == 0:
        return 1.0
    if num_S == 0 or num_G == 0:
        return 0.0

    tp = 0
    for seg_idx in range(1, num_S + 1):
        seg_obj = S == seg_idx
        intersect = G[seg_obj]
        intersect = intersect[intersect > 0]
        if intersect.size == 0:
            continue
        gt_label = _mode_positive(intersect)
        gt_obj = G == gt_label
        overlap = np.logical_and(seg_obj, gt_obj)
        if overlap.sum() / gt_obj.sum() > overlap_threshold:
            tp += 1

    TP = tp
    FP = num_S - tp
    FN = num_G - TP
    precision = TP / (TP + FP)
    recall = TP / (TP + FN)
    return float((2 * precision * recall) / (precision + recall + epsilon))


def object_dice(S, G):
    """Object-level Dice (reference utils/metrics.py:139-195)."""
    S, G = _label(S), _label(G)
    S_labels = np.unique(S)
    S_labels = S_labels[S_labels > 0]
    G_labels = np.unique(G)
    G_labels = G_labels[G_labels > 0]

    if len(S_labels) == 0 and len(G_labels) == 0:
        return 1.0
    if len(S_labels) == 0 or len(G_labels) == 0:
        return 0.0

    def one_direction(A, B, labels_A, total_A):
        score = 0.0
        for idx in labels_A:
            Ai = A == idx
            intersect = B[Ai]
            intersect = intersect[intersect > 0]
            Bi = ((B == _mode_positive(intersect)) if intersect.size
                  else np.zeros_like(B, bool))
            omega = Ai.sum() / total_A
            score += omega * dice(Ai, Bi)
        return score

    s_side = one_direction(S, G, S_labels, (S > 0).sum())
    g_side = one_direction(G, S, G_labels, (G > 0).sum())
    return float((s_side + g_side) / 2)


def hausdorff(S, G):
    """Symmetric Hausdorff distance (reference utils/metrics.py:199-221),
    by the native library's two EDTs (O(N)) instead of scipy's pairwise
    point-set scan."""
    return native.hausdorff(_to_numpy(S), _to_numpy(G))


def object_hausdorff(S, G):
    """Object-level Hausdorff (reference utils/metrics.py:224-281)."""
    S, G = _label(S), _label(G)
    S_total = (S > 0).sum()
    G_total = (G > 0).sum()
    S_labels = np.unique(S)
    S_labels = S_labels[S_labels > 0]
    G_labels = np.unique(G)
    G_labels = G_labels[G_labels > 0]

    def one_direction(A, B, labels_A, labels_B, total_A):
        total = 0.0
        for idx in labels_A:
            Ai = A == idx
            omega = Ai.sum() / total_A
            intersect = B[Ai]
            intersect = intersect[intersect > 0]
            if intersect.size > 0:
                Bi = B == _mode_positive(intersect)
                total += omega * hausdorff(Ai, Bi)
            elif len(labels_B) > 0:
                total += omega * min(hausdorff(Ai, B == bidx)
                                     for bidx in labels_B)
        return total

    s_side = one_direction(S, G, S_labels, G_labels, S_total)
    g_side = one_direction(G, S, G_labels, S_labels, G_total)
    return float((s_side + g_side) / 2)


HOST_METRICS = {fn.__name__: fn for fn in (
    accuracy, dice, detection_f1, object_dice, hausdorff, object_hausdorff)}


# ---------------------------------------------------------------------------
# Device-side batched metrics (used in the train and eval steps)
# ---------------------------------------------------------------------------

def device_accuracy(pred, target, valid):
    """Masked accuracy per image; pred/target/valid (B, H, W) -> (B,)."""
    import torch

    v = valid.to(torch.float32)
    hit = (pred == target).to(torch.float32) * v
    return hit.sum((1, 2)) / v.sum((1, 2)).clamp_min(1.0)


def device_dice(pred, target, valid, epsilon: float = 1e-7):
    """Masked Dice per image; pred/target/valid (B, H, W) -> (B,)."""
    import torch

    v = valid.to(torch.float32)
    S = pred.to(torch.float32) * v
    G = target.to(torch.float32) * v
    inter = (S * G).sum((1, 2))
    return 2 * inter / (S.sum((1, 2)) + G.sum((1, 2)) + epsilon)
