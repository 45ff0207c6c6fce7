"""Synthetic H&E-like gland images with their masks, made on the device.

The scene follows the repository's hard synthetic generator (textured
eosin background, stromal nuclei, lobed glands with a bright lumen and a
dark epithelial rim, a per-image stain shift), drawn with whole-image
tensor operations from a ``torch.Generator`` so that a GlaS- or
CRAG-sized set takes milliseconds.  The same seed and device give the
same images; every seed gives the same sizes and gland counts' bounds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MAX_GLANDS = 8


def _normal(gen, shape, mean, std, device):
    return torch.randn(shape, generator=gen, device=device) * std + mean


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def make_images(n: int, h: int, w: int, gen: torch.Generator, device,
                chunk: int = 4):
    """(n, h, w, 3) uint8 RGB images and (n, h, w) uint8 masks (1 inside a
    gland), both on ``device``."""
    imgs, masks = [], []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        img, mask = _draw(m, h, w, gen, device)
        imgs.append(img)
        masks.append(mask)
    return torch.cat(imgs), torch.cat(masks)


def _draw(n, h, w, gen, device):
    dev = device
    t = lambda *v: torch.tensor(v, device=dev)  # noqa: E731
    stain = _normal(gen, (n, 1, 1, 3), t(228.0, 205.0, 218.0), 6.0, dev)
    coarse = torch.randn((n, 1, h // 32 + 2, w // 32 + 2), generator=gen,
                         device=dev)
    field = F.interpolate(coarse, size=(h, w), mode="bicubic",
                          align_corners=False)[:, 0, ..., None]
    amp = _uniform(gen, (n, 1, 1, 1), 6.0, 14.0, dev)
    img = stain + field * amp + _normal(gen, (n, h, w, 3), 0.0, 5.0, dev)

    # stromal nuclei: about one per 500 pixels, radius 1-2
    seeds = torch.rand((n, 1, h, w), generator=gen, device=dev) < 1.0 / 500
    big = torch.rand((n, 1, h, w), generator=gen, device=dev) < 0.5
    nuc = F.max_pool2d((seeds & ~big).float(), 3, 1, 1) > 0
    nuc |= F.max_pool2d((seeds & big).float(), 5, 1, 2) > 0
    nuc_col = _normal(gen, (n, 1, 1, 3), t(150.0, 105.0, 165.0), 6.0, dev)
    img = torch.where(nuc[:, 0, ..., None],
                      nuc_col + _normal(gen, (n, h, w, 3), 0.0, 8.0, dev), img)

    # glands: lobed outlines r(theta) = r (1 + sum a_k sin(k theta + p_k))
    G = MAX_GLANDS
    n_glands = torch.randint(4, G + 1, (n, 1), generator=gen, device=dev)
    active = torch.arange(G, device=dev)[None] < n_glands         # (n, G)
    cy = _uniform(gen, (n, G), 0.0, h, dev)
    cx = _uniform(gen, (n, G), 0.0, w, dev)
    side = min(h, w)
    r = _uniform(gen, (n, G), side / 12, side / 5, dev)
    a = _uniform(gen, (n, G, 3), 0.06, 0.22, dev)
    p = _uniform(gen, (n, G, 3), 0.0, 2 * math.pi, dev)
    lum_s = _uniform(gen, (n, G), 0.35, 0.55, dev)
    inner = _normal(gen, (n, 1, 1, 3), t(168.0, 120.0, 175.0), 6.0, dev)
    lumen = _normal(gen, (n, 1, 1, 3), t(232.0, 215.0, 230.0), 5.0, dev)
    rim = _normal(gen, (n, 1, 1, 3), t(118.0, 72.0, 135.0), 6.0, dev)
    ks = torch.tensor([2.0, 3.0, 5.0], device=dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    mask = torch.zeros((n, h, w), dtype=torch.bool, device=dev)
    in_lumen = torch.zeros_like(mask)
    on_rim = torch.zeros_like(mask)
    for g in range(G):
        dy = yy[None] - cy[:, g, None, None]
        dx = xx[None] - cx[:, g, None, None]
        dist = torch.sqrt(dy * dy + dx * dx)
        theta = torch.atan2(dy, dx)
        mod = 1 + (a[:, g, :, None, None] * torch.sin(
            ks[None, :, None, None] * theta[:, None]
            + p[:, g, :, None, None])).sum(1)
        edge = r[:, g, None, None] * mod
        on = active[:, g, None, None]
        inside = (dist < edge) & on
        mask |= inside
        in_lumen = (in_lumen & ~inside) | (inside & (dist < lum_s[:, g, None,
                                                                  None] * edge))
        thick = torch.clamp(r[:, g] / 12, min=2.0)[:, None, None]
        on_rim = (on_rim & ~inside) | (on & ((dist - edge).abs() < thick / 2))
    noise7 = _normal(gen, (n, h, w, 3), 0.0, 7.0, dev)
    img = torch.where(mask[..., None], inner + noise7, img)
    img = torch.where(in_lumen[..., None], lumen + noise7 * (6.0 / 7.0), img)
    img = torch.where(on_rim[..., None], rim + noise7 * (6.0 / 7.0), img)
    img = img.clamp(0, 255).round().to(torch.uint8)
    return img, mask.to(torch.uint8)


def sample_points(mask: torch.Tensor, p: float, gen: torch.Generator):
    """About ``p`` of each (h, w) mask's pixels, drawn uniformly: a list
    of (P, 3) int64 (x, y, class) arrays on the host, as the points
    generator of the protocol writes them (``generate_points -p``)."""
    n, h, w = mask.shape
    k = max(1, int(round(p * h * w)))
    flat = torch.randint(0, h * w, (n, k), generator=gen, device=mask.device)
    cls = torch.gather(mask.reshape(n, -1).long(), 1, flat)
    pts = torch.stack([flat % w, flat // w, cls], -1).cpu().numpy()
    return list(pts)
