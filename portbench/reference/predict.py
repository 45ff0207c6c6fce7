"""Plain multi-scale superpixel inference of a folder of images.

Per scale and chunk (the same chunks as the folder run, so that the
frozen resize and SLIC see the same batches): the bilinear resize of the
[0, 1] images to ``ceil(scale * size)`` (align_corners=False), the edge
padding to a multiple of 32, SLIC, then per image the plain superpixel
forward, each pixel painted with its superpixel's foreground
probability, rounded, and resized back by nearest neighbour; the mean
over the scales, rounded.  Only one scale is supported (the mask of
several scales is opened with a cross, which this file leaves out).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import superpixel_forward
from .resize import _nearest_index, resize_bilinear
from .slic import n_clusters, slic
from .tile import plain_precision


def run(state, images, scales, max_batch: int, model_cfg: dict, quant=None):
    """[(mask (H, W) float 0/1, probability (H, W) resized back,
    superpixel foreground probabilities (K,), superpixels with a valid
    pixel (K,) bool)] per image."""
    if len(scales) != 1:
        raise ValueError("the plain multi-scale path takes one scale")
    dev = next(iter(state.values())).device
    H0, W0 = images[0].shape[:2]
    s = scales[0]
    th, tw = math.ceil(H0 * s), math.ceil(W0 * s)
    Hs, Ws = -(-th // 32) * 32, -(-tw // 32) * 32
    Hc, Wc = -(-H0 // 32) * 32, -(-W0 // 32) * 32
    K = n_clusters(Hs, Ws, model_cfg["sp_area"])
    iy = torch.arange(Hs, device=dev).clamp_max(th - 1)
    ix = torch.arange(Ws, device=dev).clamp_max(tw - 1)
    ny = torch.as_tensor(_nearest_index(th, H0), device=dev)
    nx = torch.as_tensor(_nearest_index(tw, W0), device=dev)
    out = []
    with plain_precision():
        for start in range(0, len(images), max_batch):
            chunk = images[start:start + max_batch]
            canvas = np.zeros((len(chunk), Hc, Wc, 3), np.uint8)
            for j, img in enumerate(chunk):
                canvas[j, :H0, :W0] = img
            x = torch.from_numpy(canvas).to(dev)[:, :H0, :W0]
            x = x.to(torch.float32) / 255.0
            scaled = resize_bilinear(x, (th, tw), align_corners=False)
            scaled = scaled[:, iy][:, :, ix]
            valid = torch.zeros(scaled.shape[:3], dtype=torch.bool,
                                device=dev)
            valid[:, :th, :tw] = True
            seg = slic(scaled, valid, sp_area=model_cfg["sp_area"],
                       compactness=model_cfg["sp_compactness"],
                       n_iters=model_cfg["slic_iters"],
                       update_stride=model_cfg["slic_update_stride"])
            for j in range(len(chunk)):
                probs, _ = superpixel_forward(state, scaled[j], seg[j],
                                              valid[j], K, quant)
                real = torch.zeros(K, dtype=torch.bool, device=dev)
                real[seg[j][valid[j]].long()] = True
                painted = probs[:, 1][seg[j].long()][:th, :tw]
                up = painted[ny[:, None], nx[None, :]]
                out.append((torch.round(up).cpu().numpy(), up.cpu().numpy(),
                            probs[:, 1].cpu().numpy(), real.cpu().numpy()))
    return out


def prob_gap(sp_probs, ref) -> float:
    """The widest gap between superpixel foreground probabilities and the
    reference's, over every image's superpixels that hold a valid
    pixel; infinite unless every image has its probabilities."""
    if len(sp_probs) != len(ref) or not ref:
        return float("inf")
    return max(float(np.abs(np.asarray(p) - r[2])[r[3]].max())
               for p, r in zip(sp_probs, ref))


def decisive_flips(masks, ref, margin: float) -> float:
    """Pixels where ``masks`` and the reference's masks differ although
    the reference's probability lies more than ``margin`` from 0.5;
    infinite unless every image has its mask."""
    if len(masks) != len(ref) or not ref:
        return float("inf")
    return int(sum(((np.asarray(m) != r[0]) & (np.abs(r[1] - 0.5) > margin))
                   .sum() for m, r in zip(masks, ref)))
