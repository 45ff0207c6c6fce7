"""Frozen copy of the per-batch preprocessing of
``wesup_tpu_torch/models/steps.py`` (the train step's key chain,
augmentation draws, augmentation, point rasterisation and SLIC), which
the reference shares with the program; it stays as it is when the
program changes.  The original's text follows, cut to these functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import augment as aug
from . import prng
from .slic import slic

def _slic(config, img, valid):
    return slic(img, valid, sp_area=config.sp_area,
                compactness=config.sp_compactness, n_iters=config.slic_iters,
                update_stride=config.slic_update_stride)


def _rasterize_points(points, point_valid, hw, n_classes):
    """Scatter (B, P, 3) xy-class points into (B, H, W, C) one-hot masks.

    Equivalent to the reference's cv2.circle(radius=0) rasterization;
    out-of-bounds or padded points are dropped (routed to pixel (0, 0) with
    value 0, a no-op under max)."""
    H, W = hw
    B = points.shape[0]
    xs, ys = points[..., 0], points[..., 1]
    cs = points[..., 2].clamp(0, n_classes - 1)
    ok = point_valid & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    ys = torch.where(ok, ys, torch.zeros_like(ys))
    xs = torch.where(ok, xs, torch.zeros_like(xs))
    flat = ((ys * W + xs) * n_classes + cs).to(torch.int64)
    mask = torch.zeros((B, H * W * n_classes), dtype=torch.float32,
                       device=points.device)
    mask.scatter_reduce_(1, flat, ok.to(torch.float32), reduce="amax")
    return mask.reshape(B, H, W, n_classes)


class Preprocessed(NamedTuple):
    image: torch.Tensor       # (B, H, W, 3) float
    valid: torch.Tensor       # (B, H, W) bool
    target: torch.Tensor      # (B, H, W) int32 class idx (-1 where absent)
    seg: torch.Tensor         # (B, H, W) int32 superpixel ids
    sup_mask: torch.Tensor    # (B, H, W, C) supervision one-hot


class AugParams(NamedTuple):
    """One batch's drawn augmentation (see :func:`sample_augmentation`)."""

    appearance: aug.AppearanceParams
    affine: torch.Tensor                  # (B, 3, 3) forward affines
    elastic: aug.ElasticParams | None     # mask-supervised path only


def _aug_configs(point_mode: bool):
    if point_mode:
        # albumentations defaults
        return aug.AppearanceConfig(), aug.PositionConfig(ssr_p=1.0)
    # SegmentationDataset path: milder appearance, SSR p=0.8, elastic
    return (aug.AppearanceConfig(hue_shift_limit=10, sat_shift_limit=10,
                                 val_shift_limit=10, brightness_limit=0.1,
                                 contrast_limit=0.1),
            aug.PositionConfig(ssr_p=0.8))


def draw_augmentation(config, B: int, hw, point_mode: bool, key,
                      rows: slice | None = None):
    """One batch's augmentation parameters on the host, as numpy arrays:
    ``(appearance, affine draws, elastic or None)``, bitwise what
    ``wesup_tpu.models.steps.make_train_step`` draws from ``key``: the key
    split per image, each image's key split in 3 (appearance, affine,
    elastic), the elastic draws only for mask supervision with
    ``elastic_p > 0``.  ``rows`` keeps those of a data shard's rows of the
    B-image global batch (JAX's split is prefix-stable, so a batch padded
    with blanks draws its real images' parameters unchanged)."""
    app_cfg, pos_cfg = _aug_configs(point_mode)
    k = prng.split(prng.split(key, B)[rows or slice(None)], 3)
    # the appearance's and the affine's 7 draws in one hash of 14 keys
    limits = zip(aug.appearance_limits(app_cfg), aug.affine_limits(pos_cfg))
    u = prng.uniform(prng.split(k[:, :2], 7), (), *map(np.stack, limits))
    elastic = None
    if not point_mode and config.elastic_p > 0:
        elastic = aug.draw_elastic(k[:, 2], hw, config.elastic_p)
    return (aug.appearance_params(u[:, 0], app_cfg),
            aug.affine_draws(u[:, 1], pos_cfg), elastic)


def sample_augmentation(config, B: int, hw, point_mode: bool, key,
                        device, rows: slice | None = None) -> AugParams:
    """:func:`draw_augmentation`'s parameters on ``device``: packed into
    one f32 array, copied from pinned memory without blocking (nothing is
    read back), and unpacked there."""
    dev = torch.device(device)
    app, affine, elastic = draw_augmentation(config, B, hw, point_mode, key,
                                             rows)
    B = len(affine.hflip)   # the rows drawn
    cols = {f"app.{f}": v for f, v in app._asdict().items() if v is not None}
    cols.update({f"aff.{f}": v for f, v in affine._asdict().items()})
    blocks = []
    if elastic is not None:
        cols["apply"] = elastic.apply
        blocks.append(elastic.coarse.reshape(B, -1))
    host = torch.from_numpy(np.concatenate(
        [np.stack(list(cols.values()), axis=1).astype(np.float32)] + blocks,
        axis=1))
    if dev.type == "cuda":
        host = host.pin_memory()
    packed = host.to(dev, non_blocking=True)
    # the flags travel as 0.0 / 1.0
    t = {k: packed[:, i] != 0 if v.dtype == bool else packed[:, i]
         for i, (k, v) in enumerate(cols.items())}
    appearance = aug.AppearanceParams(
        **{f: t.get(f"app.{f}") for f in aug.AppearanceParams._fields})
    A = aug.random_affine(aug.AffineDraws(
        **{f: t[f"aff.{f}"] for f in aug.AffineDraws._fields}), hw)
    if elastic is not None:
        elastic = aug.ElasticParams(t["apply"], packed[:, len(cols):].reshape(
            elastic.coarse.shape))
    return AugParams(appearance, A, elastic)


def _preprocess_sample(params: AugParams | None, image_u8, valid, pixel_mask,
                       points, point_valid, use_mask_as_points, *, config,
                       train: bool, point_mode: bool,
                       mark=None) -> Preprocessed:
    """Augment + rasterize + SLIC for a batch (the JAX function's vmap).

    ``params`` are the drawn augmentation parameters (unused unless
    ``train``).  ``mark`` is called with ``"augment"`` before SLIC and
    ``"slic"`` after it."""
    mark = mark or (lambda name: None)
    H, W = image_u8.shape[1:3]
    C = config.n_classes
    img = image_u8.to(torch.float32) / 255.0
    pts_xy = points[..., :2].to(torch.float32)

    if train:
        img = aug.random_appearance(img, params.appearance)
        if params.elastic is not None:
            el_img, el_mask = aug.random_elastic(
                img, pixel_mask.to(torch.float32), params.elastic.coarse)
            do = params.elastic.apply
            img = torch.where(do[:, None, None, None], el_img, img)
            pixel_mask = torch.where(do[:, None, None],
                                     el_mask.to(torch.int32), pixel_mask)
        A = params.affine
        warp_fn = aug.warp_exact if config.warp_method == "exact" else aug.warp
        img = warp_fn(img, A, order=1)
        # mask and valid share the order-0 warp (two channels, per-channel
        # fill)
        aux = torch.stack([pixel_mask.to(torch.float32),
                           valid.to(torch.float32)], dim=-1)
        aux = warp_fn(aux, A, order=0, fill=[-1.0, 0.0])
        pixel_mask = aux[..., 0].to(torch.int32)
        valid = aux[..., 1] > 0.5
        pts_xy = aug.transform_points(pts_xy, A)

    pts_int = torch.cat([torch.floor(pts_xy + 0.5).to(torch.int32),
                         points[..., 2:3].to(torch.int32)], dim=-1)
    point_mask = _rasterize_points(pts_int, point_valid, (H, W), C)

    classes = torch.arange(C, dtype=pixel_mask.dtype, device=img.device)
    pixel_onehot = ((pixel_mask[..., None] == classes)
                    & (pixel_mask[..., None] >= 0)).to(torch.float32)

    # supervision (reference preprocess, models/wesup.py:480-485): point
    # mask if present, else pixel mask, else nothing
    per_image = (slice(None), None, None, None)
    point_sup = torch.where(use_mask_as_points[per_image], pixel_onehot,
                            point_mask)
    has_points = point_valid.any(-1) | use_mask_as_points
    has_pixel = (pixel_mask >= 0).flatten(1).any(-1)
    sup = torch.where(has_points[per_image], point_sup,
                      torch.where(has_pixel[per_image], pixel_onehot,
                                  torch.zeros_like(pixel_onehot)))
    # annotations only count on valid canvas pixels
    sup = sup * valid[..., None].to(torch.float32)

    img = torch.clamp(img, 0.0, 1.0)
    mark("augment")
    seg = _slic(config, img, valid)
    mark("slic")
    return Preprocessed(img, valid, pixel_mask, seg, sup)


def _extent_valid(content_hw, H, W):
    """(B, H, W) top-left rectangle masks from (B, 2) content extents."""
    hs, ws = content_hw[:, 0], content_hw[:, 1]
    dev = content_hw.device
    return ((torch.arange(H, device=dev)[None, :, None] < hs[:, None, None])
            & (torch.arange(W, device=dev)[None, None, :]
               < ws[:, None, None]))


def batch_key(base_key, epoch: int, phase: int, batch_idx: int):
    """One batch's key: the epoch, the phase (:data:`PHASE_IDS`) and the
    batch index folded into the base key, in that order
    (``wesup_tpu.models.steps._batch_rng_key``).  A batch's draws depend
    on nothing but these four (not on how many batches another phase
    emitted), so a resumed epoch draws what the straight run drew; the
    chain is host arithmetic, with nothing read back from the device."""
    key = prng.fold_in(base_key, epoch)
    return prng.fold_in(prng.fold_in(key, phase), batch_idx)

