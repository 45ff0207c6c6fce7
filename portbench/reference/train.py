"""Plain replay of the first training steps.

Given the initial weights, the full-resolution images and masks, the
trainer's seed and the batch plan of the first steps (which images, at
which content size, on which canvas, with which points), it works out
each step again:

- the cv2-exact resize of each image and mask onto the canvas, the key
  chain and the augmentation draws, the augmentation, the point
  rasterisation and SLIC, with the frozen copies of the program's plain
  preprocessing (same batches, so the same arithmetic);
- per image, the plain float32 superpixel forward (``model.py``), each
  superpixel's majority label over its valid pixels, the cross entropy
  over the labeled superpixels and the label propagation's cross entropy
  (``loss``), the mean over the batch's valid images;
- the gradient by autograd and ``torch.optim.SGD`` with the configured
  learning rate, momentum and weight decay.

It starts from given weights and, for steps inside a run, SGD's momentum
buffers.  It returns each step's loss, each leaf's first gradient and
each leaf after the last step.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import prng
from .model import superpixel_forward
from .preprocess import _extent_valid, _preprocess_sample, batch_key, \
    sample_augmentation
from .slic import n_clusters
from .tile import plain_precision
from .train_resize import resize_linear, resize_nearest, resize_vectors


def superpixel_labels(seg, K: int, sup, valid):
    """One image: (labels (K, C) quantised majority over the valid
    pixels, labeled (K,), real (K,))."""
    ids = seg.reshape(-1).long()[valid.reshape(-1)]
    C = sup.shape[-1]
    counts = torch.zeros(K, device=seg.device).index_add(
        0, ids, torch.ones(len(ids), device=seg.device))
    sums = torch.zeros((K, C), device=seg.device).index_add(
        0, ids, sup.reshape(-1, C)[valid.reshape(-1)].float())
    labeled = sums.sum(-1) > 0
    labels = (sums == sums.amax(-1, keepdim=True)).float() * labeled[:, None]
    return labels, labeled, counts > 0


def semi_ce(probs, labels, eps):
    """Cross entropy over the rows with a label, per labeled row."""
    n = (labels.sum(-1) > 0).sum()
    if n == 0:
        return probs.sum() * 0.0
    return (-labels * torch.log(probs.clamp(eps, 1 - eps))).sum() / n


def loss(probs, feats, labels, labeled, real, cfg):
    """(loss, labels propagated): CE over the labeled superpixels plus
    ``propagate_weight`` times the CE of the unlabeled real ones that take
    the label of their most similar labeled one, where
    exp(-|f_i - f_j|^2) exceeds the threshold."""
    ce = semi_ce(probs, labels, cfg.epsilon)
    if not cfg.enable_propagation:
        return ce, 0.0
    f = feats.detach()
    sim = torch.exp(-((f[:, None, :] - f[None, :, :]) ** 2).sum(-1))
    sim = sim.masked_fill(~labeled[None, :], float("-inf"))
    best, src = sim.max(-1)
    receive = (~labeled) & real & (best > cfg.propagate_threshold)
    pseudo = torch.where(receive[:, None], labels[src],
                         torch.zeros_like(labels))
    return (ce + cfg.propagate_weight * semi_ce(probs, pseudo, cfg.epsilon),
            float(pseudo.sum()))


def replay(state0: dict, images: np.ndarray, masks: np.ndarray,
           batches: list, model_cfg: dict, seed: int, quant=None,
           fault=None, momentum=None) -> dict:
    """``{"loss": [per step], "prop": [labels propagated per step],
    "grad_t": {leaf: first gradient}, "param_t": {leaf: after the last
    step}, "p0": the initial weights}``.

    ``momentum`` holds SGD's momentum buffers at the start, by leaf (none:
    the first step of a training run).  ``fault="half"`` leaves out the
    second half of each batch's valid images and takes the mean over the
    rest (a planted fault)."""
    cfg = SimpleNamespace(**model_cfg)
    dev = next(iter(state0.values())).device
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state0.items()}
    opt = torch.optim.SGD(list(params.values()), lr=cfg.lr,
                          momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    for n, buf in (momentum or {}).items():
        opt.state[params[n]]["momentum_buffer"] = buf.detach().clone()
    cache_img = torch.from_numpy(images).to(dev)
    cache_mask = torch.from_numpy(masks.astype(np.int8)).to(dev)
    H0, W0 = images.shape[1:3]
    base = prng.PRNGKey(seed + 1)
    out = {"loss": [], "prop": [], "p0": state0}
    with plain_precision(), torch.enable_grad():
        for k, b in enumerate(batches):
            H, W = len(b["rsz_iy"][0]), len(b["rsz_ix"][0])
            B = len(b["sample_valid"])
            vec = [resize_vectors((H0, W0), hw, (H, W)) if hw[0] else
                   resize_vectors((1, 1), (0, 0), (H, W))
                   for hw in b["content_hw"]]
            v = {key: torch.from_numpy(np.stack([x[key] for x in vec])).to(
                dev) for key in vec[0]}
            idx = torch.from_numpy(b["img_idx"]).to(dev)
            img = resize_linear(cache_img, idx, v["rsz_iy"], v["rsz_iy1"],
                                v["rsz_b0"], v["rsz_b1"], v["rsz_ix"],
                                v["rsz_ix1"], v["rsz_a0"], v["rsz_a1"])
            content = torch.from_numpy(b["content_hw"]).to(dev)
            valid = _extent_valid(content, H, W)
            mask = resize_nearest(cache_mask, idx, v["rsz_ny"],
                                  v["rsz_nx"]).to(torch.int32)
            mask = torch.where(valid, mask, -1)
            key = batch_key(base, int(b["rng_idx"][0]), 0, int(b["rng_idx"][1]))
            aug = sample_augmentation(cfg, B, (H, W), True, key, dev)
            t = lambda name: torch.from_numpy(np.asarray(b[name])).to(dev)  # noqa: E731
            with torch.no_grad():
                prep = _preprocess_sample(
                    aug, img, valid, mask, t("points"), t("point_valid"),
                    t("use_mask_as_points"), config=cfg, train=True,
                    point_mode=True)
            K = n_clusters(H, W, cfg.sp_area)
            rows = np.flatnonzero(b["sample_valid"])
            if fault == "half":
                rows = rows[:max(1, len(rows) // 2)]
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            total = prop = 0.0
            for i in rows:
                labels, labeled, real = superpixel_labels(
                    prep.seg[i], K, prep.sup_mask[i], prep.valid[i])
                probs, feats = superpixel_forward(
                    params, prep.image[i], prep.seg[i], prep.valid[i], K,
                    quant)
                li, n_prop = loss(probs, feats, labels, labeled, real, cfg)
                li = li / len(rows)
                li.backward()
                total += float(li.detach())
                prop += n_prop
            out["loss"].append(total)
            out["prop"].append(prop)
            if k == 0:
                out["grad_t"] = {n: p.grad.detach().clone()
                                 for n, p in params.items()}
            opt.step()
            opt.zero_grad(set_to_none=True)
    out["param_t"] = {n: p.detach() for n, p in params.items()}
    return out
