"""Device-side data augmentation, batched over images.

Port of ``wesup_tpu.ops.augment``: HSV shift, brightness/contrast, CLAHE and
a 3x3 box blur (appearance); horizontal/vertical flips and
shift-scale-rotate as one affine warp, with point annotations transformed
as coordinates (position); a coarse-field elastic deformation (the
mask-supervised path).

Each random transform is split in two.  Its parameters are drawn for a
batch on the host, in numpy, from JAX's threefry keys (``utils/prng.py``)
with JAX's splits and in its order, so that they are bitwise the
parameters the JAX function draws from the same key
(:func:`appearance_params`, :func:`affine_draws`, :func:`draw_elastic`;
``models.steps.draw_augmentation`` holds the key chain); the apply
function (``random_appearance``, ``warp``, ``random_elastic``...) takes
them as tensors on the device and is deterministic.

The resampling is the JAX design: the cascade ``warp`` factors the affine
into two axis-aligned shears, each a shared banded stride-resample matrix
plus a per-row integer shift applied as a binary cascade of selects and one
fractional lerp; ``warp_exact`` samples every pixel at its true source
position; the elastic field is applied as two 1-D banded resamples.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import prng
from .clahe import clahe_rgb
from .colorspace import hsv_to_rgb, rgb_to_hsv
from .resize import resize_bilinear


class AppearanceConfig(NamedTuple):
    # albumentations HueSaturationValue limits, uint8 scale
    hue_shift_limit: float = 20.0
    sat_shift_limit: float = 30.0
    val_shift_limit: float = 20.0
    # RandomBrightnessContrast limits
    brightness_limit: float = 0.3
    contrast_limit: float = 0.3
    clahe_p: float = 0.5
    blur_p: float = 0.5


class PositionConfig(NamedTuple):
    hflip_p: float = 0.5
    vflip_p: float = 0.5
    ssr_p: float = 1.0
    shift_limit: float = 0.0625
    scale_limit: float = 0.1
    rotate_limit: float = 45.0  # degrees


class AppearanceParams(NamedTuple):
    """Per-image appearance draws, each (B,)."""

    dh: torch.Tensor          # hue shift, as a fraction of the circle
    ds: torch.Tensor          # saturation shift, [0, 1] scale
    dv: torch.Tensor          # value shift, [0, 1] scale
    contrast: torch.Tensor
    brightness: torch.Tensor
    clahe: torch.Tensor | None  # bool; None when CLAHE is off (p = 0)
    blur: torch.Tensor        # bool


class AffineDraws(NamedTuple):
    """Per-image position draws, each (B,), before they become a matrix."""

    hflip: torch.Tensor       # bool
    vflip: torch.Tensor       # bool
    ssr: torch.Tensor         # bool: shift-scale-rotate applies
    angle: torch.Tensor       # degrees
    scale: torch.Tensor       # scale - 1
    shift_x: torch.Tensor     # fraction of the width
    shift_y: torch.Tensor     # fraction of the height


# each transform's draws in JAX's key order: (minval, maxval) of every
# uniform, (0, 1) where a bernoulli compares its uniform against p


def appearance_limits(cfg: AppearanceConfig = AppearanceConfig()):
    """(lo, hi) of the draws of ``random_appearance``'s 7 keys: h, s, v,
    brightness, contrast, CLAHE, blur."""
    lim = np.array([cfg.hue_shift_limit, cfg.sat_shift_limit,
                    cfg.val_shift_limit, cfg.brightness_limit,
                    cfg.contrast_limit], np.float32)
    return (np.concatenate([-lim, np.zeros(2, np.float32)]),
            np.concatenate([lim, np.ones(2, np.float32)]))


def appearance_params(u, cfg: AppearanceConfig = AppearanceConfig()
                      ) -> AppearanceParams:
    """:class:`AppearanceParams` (numpy) from the (B, 7) draws of
    :func:`appearance_limits`' keys.  XLA compiles a division by a
    constant into a product with its f32 reciprocal, and so does this;
    cv2's uint8 hue spans 0..180."""
    scale = np.float32(1.0) / np.array([180.0, 255.0, 255.0], np.float32)
    return AppearanceParams(
        dh=u[:, 0] * scale[0], ds=u[:, 1] * scale[1], dv=u[:, 2] * scale[2],
        contrast=u[:, 4], brightness=u[:, 3],
        clahe=u[:, 5] < np.float32(cfg.clahe_p) if cfg.clahe_p > 0 else None,
        blur=u[:, 6] < np.float32(cfg.blur_p))


def _per_image(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dims in all."""
    return x.reshape(x.shape + (1,) * (ndim - 1))


def random_appearance(img: torch.Tensor,
                      params: AppearanceParams) -> torch.Tensor:
    """HSV shift + brightness/contrast + CLAHE + 3x3 blur of (B, H, W, 3)
    images in [0, 1], in the reference's order, with drawn ``params``."""
    hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    hsv = torch.stack([
        torch.remainder(hsv[..., 0] + _per_image(params.dh, 3), 1.0),
        torch.clamp(hsv[..., 1] + _per_image(params.ds, 3), 0.0, 1.0),
        torch.clamp(hsv[..., 2] + _per_image(params.dv, 3), 0.0, 1.0),
    ], dim=-1)
    img = hsv_to_rgb(hsv)

    # brightness/contrast: out = img * (1 + c) + b  (brightness_by_max=True)
    c = _per_image(params.contrast, 4)
    b = _per_image(params.brightness, 4)
    img = torch.clamp(img * (1.0 + c) + b, 0.0, 1.0)

    # CLAHE after brightness/contrast, before blur (utils/data.py:119-130)
    if params.clahe is not None:
        img = torch.where(_per_image(params.clahe, 4), clahe_rgb(img), img)

    return torch.where(_per_image(params.blur, 4), _box_blur3(img), img)


def _box_blur3(img: torch.Tensor) -> torch.Tensor:
    """3x3 box blur of (B, H, W, C) with edge replication."""
    H, W = img.shape[1:3]
    iy = torch.arange(-1, H + 1, device=img.device).clamp(0, H - 1)
    ix = torch.arange(-1, W + 1, device=img.device).clamp(0, W - 1)
    pad = img[:, iy][:, :, ix]
    out = torch.zeros_like(img)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = out + pad[:, dy:dy + H, dx:dx + W]
    return out / 9.0


def affine_limits(cfg: PositionConfig = PositionConfig()):
    """(lo, hi) of the draws of ``random_affine``'s 7 keys: h, v,
    shift-scale-rotate, angle, scale, shift x, shift y."""
    lim = np.array([cfg.rotate_limit, cfg.scale_limit, cfg.shift_limit,
                    cfg.shift_limit], np.float32)
    return (np.concatenate([np.zeros(3, np.float32), -lim]),
            np.concatenate([np.ones(3, np.float32), lim]))


def affine_draws(u, cfg: PositionConfig = PositionConfig()) -> AffineDraws:
    """:class:`AffineDraws` (numpy) from the (B, 7) draws of
    :func:`affine_limits`' keys."""
    p = np.array([cfg.hflip_p, cfg.vflip_p, cfg.ssr_p], np.float32)
    flags = u[:, :3] < p
    return AffineDraws(hflip=flags[:, 0], vflip=flags[:, 1], ssr=flags[:, 2],
                       angle=u[:, 3], scale=u[:, 4], shift_x=u[:, 5],
                       shift_y=u[:, 6])


def random_affine(draws: AffineDraws, hw) -> torch.Tensor:
    """(B, 3, 3) forward affine matrices (dst <- A @ src, xy homogeneous)
    from drawn flips and shift-scale-rotate, composed about the image
    centre as the reference's position transformer (utils/data.py:315-319).
    """
    H, W = hw
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    ssr = draws.ssr
    zero = torch.zeros_like(draws.angle)
    ang = torch.where(ssr, draws.angle * (math.pi / 180.0), zero)
    scale = torch.where(ssr, 1.0 + draws.scale, zero + 1.0)
    tx = torch.where(ssr, draws.shift_x * W, zero)
    ty = torch.where(ssr, draws.shift_y * H, zero)
    fx = torch.where(draws.hflip, zero - 1.0, zero + 1.0)
    fy = torch.where(draws.vflip, zero - 1.0, zero + 1.0)

    cos, sin = torch.cos(ang) * scale, torch.sin(ang) * scale
    # translate(-c) -> flip -> rotate/scale -> translate(c) -> shift
    a00 = cos * fx
    a01 = -sin * fy
    a10 = sin * fx
    a11 = cos * fy
    b0 = cx - a00 * cx - a01 * cy + tx
    b1 = cy - a10 * cx - a11 * cy + ty
    return torch.stack([torch.stack([a00, a01, b0], -1),
                        torch.stack([a10, a11, b1], -1),
                        torch.stack([zero, zero, zero + 1.0], -1)], -2)


def _inverse(A: torch.Tensor) -> torch.Tensor:
    # inv_ex: no host sync to check for singular matrices (an affine with
    # scale >= 0.9 never is)
    return torch.linalg.inv_ex(A)[0]


def warp(img: torch.Tensor, A: torch.Tensor, *, order: int,
         fill=0.0) -> torch.Tensor:
    """Inverse-warp (B, H, W, C) or (B, H, W) by the forward affines A
    (B, 3, 3), through two axis-aligned shear passes.

    ``fill`` may be a scalar or a (C,) per-channel fill; channels sharing
    one warp share all the resampling work.  Sub-pixel values differ from a
    direct bilinear warp by one lerp composition; flips and the identity
    are exact.  The factoring needs |m11| away from 0 (the +-45 degree
    limit guarantees it; a guard covers other configs)."""
    squeeze = img.ndim == 3
    x = img[..., None] if squeeze else img
    H, W = x.shape[1:3]
    dev = x.device

    Ainv = _inverse(A)
    m00, m01, m02 = Ainv[:, 0, 0], Ainv[:, 0, 1], Ainv[:, 0, 2]
    m10, m11, m12 = Ainv[:, 1, 0], Ainv[:, 1, 1], Ainv[:, 1, 2]

    # src = M dst + t as pass 1 (x within rows) then pass 2 (y within cols)
    guard = torch.where(m11 < 0, m11.new_tensor(-1e-3), m11.new_tensor(1e-3))
    m11 = torch.where(m11.abs() < 1e-3, guard, m11)
    b = m01 / m11
    a = m00 - b * m10
    c = m02 - b * m12

    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)

    # an exact-coverage channel travels through both passes, so the fill is
    # applied once at the end
    x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)

    # pass 1: tmp[y, x] = in[y, a*x + (b*y + c)]
    tmp = _shear(x, a, b[:, None] * ys + c[:, None], order, axis=1,
                 range_max=int(1.2 * H) + 2)
    # pass 2: out[y, x] = tmp[m11*y + (m10*x + m12), x]
    out = _shear(tmp, m11, m10[:, None] * xs + m12[:, None], order, axis=0,
                 range_max=int(1.2 * W) + 2)

    cov = out[..., -1:]
    fill = torch.as_tensor(fill, dtype=x.dtype, device=dev)
    # the second pass leaves a transposed layout; hand back a contiguous one
    out = (out[..., :-1] + (1.0 - cov) * fill).contiguous()
    return out[..., 0] if squeeze else out


def warp_exact(img: torch.Tensor, A: torch.Tensor, *, order: int,
               fill=0.0) -> torch.Tensor:
    """Exact one-pass inverse warp (bilinear or nearest) of (B, H, W, C) or
    (B, H, W): every pixel sampled at its true source position, as
    ``jax.scipy.ndimage.map_coordinates`` samples it (the ablation
    reference of ``warp_method="exact"``)."""
    squeeze = img.ndim == 3
    x = img[..., None] if squeeze else img
    B, H, W, C = x.shape
    dev = x.device

    Ainv = _inverse(A)[:, :, :, None, None]
    ys = (torch.arange(H, dtype=torch.float32, device=dev)[:, None]
          * torch.ones((1, W), dtype=torch.float32, device=dev))
    xs = (torch.ones((H, 1), dtype=torch.float32, device=dev)
          * torch.arange(W, dtype=torch.float32, device=dev)[None, :])
    sx = Ainv[:, 0, 0] * xs + Ainv[:, 0, 1] * ys + Ainv[:, 0, 2]
    sy = Ainv[:, 1, 0] * xs + Ainv[:, 1, 1] * ys + Ainv[:, 1, 2]
    inb = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    cy, cx = sy.clamp(0, H - 1), sx.clamp(0, W - 1)

    flat = x.reshape(B, H * W, C)

    def tap(iy, ix):
        # x[b, iy, ix] with map_coordinates' constant mode: 0 off the image
        ok = (iy < H) & (ix < W)
        idx = (iy.clamp_max(H - 1) * W + ix.clamp_max(W - 1)).reshape(B, -1)
        got = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return got.reshape(B, H, W, C) * ok[..., None]

    if order == 0:
        # round half away from zero (the coordinates are >= 0)
        ry = torch.floor(cy) + (cy - torch.floor(cy) >= 0.5)
        rx = torch.floor(cx) + (cx - torch.floor(cx) >= 0.5)
        out = tap(ry.to(torch.int64), rx.to(torch.int64))
    elif order == 1:
        y0, x0 = torch.floor(cy), torch.floor(cx)
        wy1, wx1 = (cy - y0)[..., None], (cx - x0)[..., None]
        wy0, wx0 = 1 - wy1, 1 - wx1
        y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
        # map_coordinates' order of products and sums
        out = wy0 * wx0 * tap(y0, x0)
        out = out + wy0 * wx1 * tap(y0, x0 + 1)
        out = out + wy1 * wx0 * tap(y0 + 1, x0)
        out = out + wy1 * wx1 * tap(y0 + 1, x0 + 1)
    else:
        raise NotImplementedError("warp_exact takes order 0 or 1")
    fill = torch.broadcast_to(torch.as_tensor(fill, dtype=x.dtype, device=dev),
                              (C,))
    out = torch.where(inb[..., None], out, fill)
    return out[..., 0] if squeeze else out


def _shear(img: torch.Tensor, stride: torch.Tensor, offs: torch.Tensor,
           order: int, *, axis: int, range_max: int) -> torch.Tensor:
    """out[b, .., t, ..] = img[b, .., stride[b]*t + offs[b, r], ..] along
    ``axis`` (1 or 0 of the image), where ``offs`` varies over the other
    spatial axis (r).

    r[t'] = img[stride*t' + p0] through one banded (L + range_max, L)
    matrix per image, then out[r, t] = r[r, t + s_r] with
    s_r = (offs[r] - p0) / stride >= 0 split into a binary shift cascade and
    one fractional lerp; p0 (min or max of offs, by the stride's sign) makes
    every shift non-negative."""
    if axis == 0:  # rows: transpose to the axis=1 layout and back
        return _shear(img.transpose(1, 2), stride, offs, order, axis=1,
                      range_max=range_max).transpose(1, 2)

    L = img.shape[2]
    R = range_max
    p0 = torch.where(stride > 0, offs.amin(1), offs.amax(1))        # (B,)
    s_raw = (offs - p0[:, None]) / stride[:, None]                   # (B, r)
    s = s_raw.clamp(0.0, float(R))
    # rows whose true shift exceeds the static headroom would alias; zero
    # them so the coverage channel degrades to fill
    row_ok = ((s_raw >= 0.0) & (s_raw <= float(R)))[:, :, None, None]

    if order == 0:
        k = torch.floor(s + 0.5).to(torch.int32)
        f = None
    else:
        k = torch.floor(s).to(torch.int32)
        f = (s - k)[:, :, None, None]

    Lr = L + R + 2
    posr = (stride[:, None] * torch.arange(Lr, dtype=torch.float32,
                                           device=img.device)
            + p0[:, None])
    M = _band_weights(posr, L, order)                                # (B, Lr, L)
    r = torch.einsum("bxj,bhjc->bhxc", M, img)                   # (B, r, Lr, C)

    # per-row integer shift as a binary cascade of whole-tensor selects
    for i in range((R + 1).bit_length()):
        sh = 1 << i
        shifted = torch.cat([r[:, :, sh:], torch.zeros_like(r[:, :, :sh])],
                            dim=2)
        bit = ((k >> i) & 1).to(torch.bool)[:, :, None, None]
        r = torch.where(bit, shifted, r)

    if order == 0:
        return r[:, :, :L] * row_ok
    return ((1.0 - f) * r[:, :, :L] + f * r[:, :, 1:L + 1]) * row_ok


def _band_weights(pos: torch.Tensor, size: int, order: int) -> torch.Tensor:
    """(..., size) interpolation weights for continuous positions ``pos``:
    the linear kernel (order 1) or the nearest one-hot (order 0, ties to the
    lower index).  Positions outside [0, size - 1] get all-zero rows."""
    j = torch.arange(size, dtype=torch.float32, device=pos.device)
    d = pos[..., None] - j
    if order == 0:
        w = (d.abs() <= 0.5).to(torch.float32)
        w = w * (torch.cumsum(w, dim=-1) == 1)
    else:
        w = torch.clamp_min(1.0 - d.abs(), 0.0)
    inb = (pos >= 0) & (pos <= size - 1)
    return w * inb[..., None]


def _resample_x(img: torch.Tensor, pos: torch.Tensor, order: int,
                fill: float) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C), out[b, y, x] = in[b, y, pos[b, y, x]]."""
    W = img.shape[2]
    S = _band_weights(pos, W, order)                   # (B, H, W_out, W_in)
    out = torch.einsum("bhxj,bhjc->bhxc", S, img)
    cov = S.sum(-1)                                    # 0 outside
    return out + (1.0 - cov[..., None]) * fill


def _resample_y(img: torch.Tensor, pos: torch.Tensor, order: int,
                fill: float) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C), out[b, y, x] = in[b, pos[b, y, x], x]."""
    H = img.shape[1]
    S = _band_weights(pos, H, order)                   # (B, H_out, W, H_in)
    out = torch.einsum("bywj,bjwc->bywc", S, img)
    cov = S.sum(-1)
    return out + (1.0 - cov[..., None]) * fill


def transform_points(points_xy: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Forward-transform (B, P, 2) xy point coordinates by A (B, 3, 3)."""
    ones = torch.ones(points_xy.shape[:-1] + (1,), dtype=points_xy.dtype,
                      device=points_xy.device)
    hom = torch.cat([points_xy, ones], dim=-1)
    return hom @ A[:, :2].transpose(1, 2)


class ElasticParams(NamedTuple):
    apply: torch.Tensor       # (B,) bool
    coarse: torch.Tensor      # (B, grid, grid, 2) displacement, pixels


def draw_elastic(keys, hw, p: float, alpha: float = 34.0,
                 grid: int = 8) -> ElasticParams:
    """:class:`ElasticParams` of numpy arrays for the keys ``keys`` (B, 2)
    of the elastic transform: whether each image is deformed,
    ``bernoulli(fold_in(key, 0), p)`` (``wesup_tpu/models/steps.py``), and
    its coarse field, the normal draw of ``split(key)[0]`` times
    ``alpha / max(H, W) * min(H, W)``, which the compiled JAX step folds
    into one f32 constant, ``alpha * (min * (1 / max))``."""
    H, W = hw
    f = np.float32
    apply = prng.bernoulli(prng.fold_in(keys, 0), p)
    scale = f(alpha) * (f(min(H, W)) * (f(1) / f(max(H, W))))
    return ElasticParams(apply, prng.normal(prng.split(keys)[:, 0],
                                            (grid, grid, 2), scale))


def random_elastic(img: torch.Tensor, mask: torch.Tensor | None,
                   coarse: torch.Tensor):
    """Coarse-field elastic deformation of (B, H, W, C) images (bilinear)
    and (B, H, W) masks (nearest) by the drawn (B, g, g, 2) field, as two
    axis-aligned 1-D resampling passes."""
    H, W = img.shape[1:3]
    disp = resize_bilinear(coarse, (H, W), align_corners=False)
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    pos_x = torch.clamp(xs + disp[..., 1], 0.0, W - 1)
    pos_y = torch.clamp(ys + disp[..., 0], 0.0, H - 1)

    def apply(ch_img, order):
        out = _resample_x(ch_img, pos_x, order, 0.0)
        return _resample_y(out, pos_y, order, 0.0)

    out_img = apply(img, 1)
    out_mask = None if mask is None else apply(mask[..., None], 0)[..., 0]
    return out_img, out_mask
