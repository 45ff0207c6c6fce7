"""Colour spaces: sRGB -> CIELAB (SLIC, CLAHE) and RGB <-> HSV (augmentation).

Port of ``wesup_tpu.ops.colorspace``: sRGB -> linear RGB -> XYZ (D65) ->
CIELAB with skimage's constants, and the HSV conversions of the
augmentation stack.
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB -> XYZ (D65) matrix, same constants as skimage.color
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)

# D65 reference white
_XYZ_REF = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)


def srgb_to_linear(rgb: torch.Tensor) -> torch.Tensor:
    rgb = rgb.float()
    return torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                       rgb / 12.92)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """Convert (..., 3) sRGB in [0, 1] to CIELAB (L in [0,100], a/b ~[-128,127])."""
    lin = srgb_to_linear(rgb)
    m = torch.as_tensor(_RGB2XYZ.T, device=lin.device)
    xyz = lin @ m
    xyz = xyz / torch.as_tensor(_XYZ_REF, device=lin.device)

    eps = 0.008856451679035631  # (6/29)^3
    kappa = 903.2962962962963  # (29/3)^3
    # xyz > eps > 0 on the cube-root branch, so pow(1/3) is the real root
    f = torch.where(xyz > eps, xyz.clamp_min(eps) ** (1.0 / 3.0),
                    (kappa * xyz + 16.0) / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV with H in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), zero)
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV (H in [0, 1)) -> RGB."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = torch.remainder(h, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        # vals[k] where i == k (exactly one k holds)
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)
