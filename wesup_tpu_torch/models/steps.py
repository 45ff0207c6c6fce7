"""Train, eval and predict steps: the whole per-batch pipeline on the card.

Port of ``wesup_tpu.models.steps``:

- ``make_train_step``: augmentation -> point rasterization -> SLIC ->
  superpixel stats -> hypercolumn forward (pooling kernels K1, K2 for
  "local"; K5, K6 for "adjoint"; K5 for "fullres") -> WESUP loss ->
  backward (K3, K4; K5's backward on K3's kernel and K8; cuDNN) -> SGD
  update -> metrics accumulated on the device;
- ``make_eval_step``: the same without augmentation and gradients;
- ``make_predict_step`` and ``make_scaled_predict_step``: in superpixel
  mode uint8 (or float) canvas -> SLIC -> forward -> painted foreground;
  in pixel mode canvas -> the pixel head's foreground probability.

Every step takes every ``config.pooling`` ("local", "adjoint",
"fullres").  All steps honour ``WESUP_FUSED_POOL1`` (kernel K7 in the
backbone, whose backward replays the plain composition).

PyTorch runs eagerly, so a "step" is a plain function closed over the
static shapes and plans; it takes the model as its first argument, as the
JAX step takes params.  The train step updates the model and the optimizer
IN PLACE (the JAX step returns new ones) and returns the metric
accumulator.  Randomness comes from an explicit ``torch.Generator`` on the
step's device: the augmentation parameters are drawn from it
(:func:`sample_augmentation`) and then applied.  The trainer's batches
carry ``rng_idx`` (epoch, batch index) instead, and the step seeds the
batch's generator from them (:func:`batch_seed`); device-resize batches
carry ``img_idx`` and resize vectors, and the step builds their canvases
from the cache it is given (``ops.train_resize``).

The step factories run on ``cuda`` unless ``device`` says otherwise, and raise
when no CUDA device is present and none was given.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import augment as aug
from ..ops import train_resize
from ..ops.resize import resize_bilinear, resize_nearest
from ..ops.segments import superpixel_stats
from ..ops.slic import make_plan, n_clusters, slic
from ..runtime import compute_dtype as _compute_dtype
from ..runtime import resolve_device
from ..utils.metrics import device_accuracy, device_dice
from . import wesup
from .objectives import wesup_loss


def _check_mode(mode: str) -> None:
    if mode not in ("superpixel", "pixel"):
        raise ValueError(f"unknown predict mode: {mode}")


def _check_model(model, device) -> None:
    p = next(model.parameters())
    if p.device.type != device.type:
        raise ValueError(f"model is on {p.device}, the step runs on {device}")


def _to_float(image: torch.Tensor) -> torch.Tensor:
    """uint8 (0..255, the dataset convention) or float (0..1) -> f32."""
    if image.dtype == torch.uint8:
        return image.to(torch.float32) / 255.0
    return image.to(torch.float32)


def _slic(config, img, valid):
    return slic(img, valid, sp_area=config.sp_area,
                compactness=config.sp_compactness, n_iters=config.slic_iters,
                update_stride=config.slic_update_stride)


def make_predict_step(config, canvas_hw, mode: str = "superpixel",
                      device=None):
    """Prediction step for a (H, W) canvas.

    Returns ``step(model, image, valid, mark=None) -> (B, H, W) f32`` fg
    probability; ``image`` is (B, H, W, 3) uint8 or float, ``valid``
    (B, H, W) bool (tensors or arrays; they are moved to the device).
    ``mode="superpixel"`` runs SLIC and :func:`wesup.forward_superpixel`
    (reference WESUP.forward); ``mode="pixel"`` runs
    :func:`wesup.forward_pixel` (reference WESUPPixelInference), which
    takes no SLIC and no ``valid``.  ``mark`` is passed on to the forward
    (after a ``"slic"`` mark of its own in superpixel mode) for phase
    timing; the phases it marks depend on the mode and
    ``config.pooling``.
    """
    _check_mode(mode)
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    cdtype = _compute_dtype(config)
    if mode == "pixel":
        @torch.inference_mode()
        def pixel_step(model, image, valid, mark=None):
            _check_model(model, dev)
            img = _to_float(torch.as_tensor(image, device=dev))
            return wesup.forward_pixel(model, img, cdtype, mark=mark)[..., 1]

        return pixel_step
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)

    @torch.inference_mode()
    def step(model, image, valid, mark=None):
        _check_model(model, dev)
        img = _to_float(torch.as_tensor(image, device=dev))
        valid = torch.as_tensor(valid, device=dev)
        seg = _slic(config, img, valid)
        if mark is not None:
            mark("slic")
        out = wesup.forward_superpixel(model, img, seg, K, valid, cdtype,
                                       pooling=config.pooling, plan=plan,
                                       mark=mark)
        return out.pred

    return step


def make_scaled_predict_step(config, content_hw, target_hw, canvas_hw,
                             mode: str = "superpixel", device=None):
    """One multi-scale-inference stage, fully on the device.

    Takes (B, Hc, Wc, 3) images at ORIGINAL resolution placed on
    ``canvas_hw``, resizes the (Ho, Wo) content to ``target_hw``
    (bilinear; align_corners=False in superpixel mode, as the reference's
    F.interpolate, True in pixel mode, as pixel_infer.py) and pads it up to
    a 32-aligned compute canvas by edge replication.  Superpixel mode runs
    SLIC and the superpixel forward, rounds the prediction and
    nearest-resizes it back: (B, Ho, Wo) uint8 in {0, 1}.  Pixel mode runs
    the pixel head and resizes the f32 foreground probability back
    (bilinear, align_corners=True), unrounded: (B, Ho, Wo) f32.
    """
    _check_mode(mode)
    dev = resolve_device(device)
    Ho, Wo = int(content_hw[0]), int(content_hw[1])
    th, tw = int(target_hw[0]), int(target_hw[1])
    # scaled content padded up to a 32-aligned compute canvas
    Hs = -(-th // 32) * 32
    Ws = -(-tw // 32) * 32
    sp_mode = mode == "superpixel"
    if sp_mode:
        K = n_clusters(Hs, Ws, config.sp_area)
        plan = make_plan(Hs, Ws, config.sp_area)
    cdtype = _compute_dtype(config)
    # edge padding as index clamps (exact copies of the last row / column)
    iy = torch.arange(Hs, device=dev).clamp_max(th - 1)
    ix = torch.arange(Ws, device=dev).clamp_max(tw - 1)

    @torch.inference_mode()
    def step(model, image):
        _check_model(model, dev)
        image = torch.as_tensor(image, device=dev)
        img = _to_float(image[:, :Ho, :Wo])
        scaled = resize_bilinear(img, (th, tw), align_corners=not sp_mode)
        scaled = scaled[:, iy][:, :, ix]
        if not sp_mode:
            prob = wesup.forward_pixel(model, scaled, cdtype)[:, :th, :tw, 1]
            return resize_bilinear(prob[..., None], (Ho, Wo),
                                   align_corners=True)[..., 0]
        B = scaled.shape[0]
        valid = torch.zeros((B, Hs, Ws), dtype=torch.bool, device=dev)
        valid[:, :th, :tw] = True
        seg = _slic(config, scaled, valid)
        out = wesup.forward_superpixel(model, scaled, seg, K, valid, cdtype,
                                       pooling=config.pooling, plan=plan)
        pred = torch.round(out.pred[:, :th, :tw])
        up = resize_nearest(pred[..., None], (Ho, Wo))[..., 0]
        return up.to(torch.uint8)

    return step


# ---------------------------------------------------------------------------
# Optimizer: torch.optim.SGD(lr, momentum, weight_decay), the reference's
# optimizer (models/wesup.py:445-455)
# ---------------------------------------------------------------------------

def make_optimizer(config, model) -> torch.optim.SGD:
    """SGD over the model's trainable parameters.

    Equal to the JAX package's ``add_decayed_weights -> trace -> scale(-lr)``
    chain: both add ``weight_decay * p`` to the gradient, keep the momentum
    buffer ``m = g + momentum * m`` (the first step's buffer is ``g``) and
    step by ``-lr * m``.  Under ``freeze_backbone`` the backbone's
    parameters are left out, so they never move, as optax's
    ``set_to_zero`` leaves them."""
    params = [p for name, p in model.named_parameters()
              if not (config.freeze_backbone and name.startswith("backbone."))]
    return torch.optim.SGD(params, lr=config.lr, momentum=config.momentum,
                           weight_decay=config.weight_decay)


# ---------------------------------------------------------------------------
# Per-batch device preprocessing
# ---------------------------------------------------------------------------

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


def sample_augmentation(config, B: int, hw, point_mode: bool,
                        generator: torch.Generator, device) -> AugParams:
    """Draw one batch's augmentation parameters from ``generator``."""
    app_cfg, pos_cfg = _aug_configs(point_mode)
    appearance = aug.sample_appearance(generator, B, app_cfg, device)
    A = aug.random_affine(aug.sample_affine(generator, B, pos_cfg, device),
                          hw)
    elastic = None
    if not point_mode and config.elastic_p > 0:
        elastic = aug.sample_elastic(generator, B, hw, config.elastic_p,
                                     device)
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


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------

def _forward_and_loss(model, prep: Preprocessed, K, config, sample_valid,
                      plan=None, mark=None):
    """Forward + mean WESUP loss over the valid samples.

    Returns ``(loss, (out, losses))`` with ``losses`` per image."""
    mark = mark or (lambda name: None)
    out = wesup.forward_superpixel(model, prep.image, prep.seg, K, prep.valid,
                                   _compute_dtype(config),
                                   pooling=config.pooling, plan=plan)
    mark("forward")
    stats = superpixel_stats(prep.seg, K, prep.sup_mask, prep.valid,
                             plan=plan)
    losses = wesup_loss(
        out.sp_pred, out.sp_features, stats.labels, stats.labeled, stats.real,
        # the reference never applies its class_weights config
        class_weights=(config.class_weights
                       if config.apply_class_weights else None),
        enable_propagation=config.enable_propagation,
        propagate_threshold=config.propagate_threshold,
        propagate_weight=config.propagate_weight,
        epsilon=config.epsilon)
    w = sample_valid.to(torch.float32)
    loss = (losses.loss * w).sum() / w.sum().clamp_min(1.0)
    mark("loss")
    return loss, (out, losses)


TRAIN_METRIC_KEYS = ("loss", "accuracy", "dice", "labeled_sp_ratio",
                     "propagated_labels", "propagate_loss")
EVAL_METRIC_KEYS = ("accuracy", "dice")


def _extent_valid(content_hw, H, W):
    """(B, H, W) top-left rectangle masks from (B, 2) content extents."""
    hs, ws = content_hw[:, 0], content_hw[:, 1]
    dev = content_hw.device
    return ((torch.arange(H, device=dev)[None, :, None] < hs[:, None, None])
            & (torch.arange(W, device=dev)[None, None, :]
               < ws[:, None, None]))


def _batch_valid_and_mask(batch, H, W):
    """(valid, int32 pixel_mask) from a batch in either wire format: an
    explicit (B, H, W) ``valid`` mask or (B, 2) ``content_hw`` extents."""
    if "content_hw" in batch:
        valid = _extent_valid(batch["content_hw"], H, W)
    else:
        valid = batch["valid"]
    return valid, batch["pixel_mask"].to(torch.int32)


def _batch_inputs(batch, cache, H, W):
    """(image_u8, valid, pixel_mask) in any wire format.

    A device-resize batch (``img_idx`` and the vectors of
    ``ops.train_resize.resize_vectors``) materializes its uint8 canvas and
    int mask HERE from ``cache``, bit for bit what the host path would have
    sent; otherwise they come with the batch."""
    if "img_idx" in batch:
        if cache is None:
            raise ValueError("a batch with img_idx needs the device-resize "
                             "cache (cache=)")
        image, pixel_mask = train_resize.apply_resize(cache, batch)
        return image, _extent_valid(batch["content_hw"], H, W), pixel_mask
    valid, pixel_mask = _batch_valid_and_mask(batch, H, W)
    return batch["image"], valid, pixel_mask


def _batch_on(batch, dev) -> dict:
    """The batch's tensors on ``dev``; ``rng_idx`` stays on the host."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "rng_idx"}


# ---------------------------------------------------------------------------
# Per-batch generators
# ---------------------------------------------------------------------------

PHASE_IDS = {"train": 0, "val": 1}
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def batch_seed(base_seed: int, epoch: int, phase: int, batch_idx: int) -> int:
    """Seed of one batch's ``torch.Generator``: the base seed, then the
    epoch, the phase (:data:`PHASE_IDS`) and the batch index, each xored
    into the state and mixed by splitmix64; the top 63 bits.

    The JAX package folds the same (epoch, phase, batch) into a threefry
    key; torch cannot draw JAX's bits, so the port keeps the properties
    instead: a batch's draws depend on nothing but these four integers
    (not on how many batches another phase emitted), a resumed epoch
    draws what the straight run drew, and the seed is host integer
    arithmetic, with nothing read back from the device."""
    s = _splitmix64(int(base_seed) & _MASK64)
    for v in (epoch, phase, batch_idx):
        s = _splitmix64(s ^ (int(v) & _MASK64))
    return s >> 1


def _rng_idx(value) -> tuple:
    """(epoch, batch_idx) of a batch's ``rng_idx``: a host pair, or the
    JAX wire format's (B, 2) rows (all equal)."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        raise ValueError("rng_idx must stay on the host: reading it back "
                         "from the device would sync every batch")
    pair = np.asarray(value).reshape(-1, 2)[0]
    return int(pair[0]), int(pair[1])


def batch_generator(rng, batch, phase: str, device) -> torch.Generator:
    """The generator a step draws from.  With ``rng_idx`` in the batch,
    ``rng`` is the int base seed and the batch's generator is seeded with
    :func:`batch_seed`; without it, ``rng`` is that generator."""
    if "rng_idx" not in batch:
        return rng
    if isinstance(rng, bool) or not isinstance(rng, (int, np.integer)):
        raise TypeError(
            f"a batch with rng_idx takes the int base seed as rng, not "
            f"{type(rng).__name__}")
    epoch, idx = _rng_idx(batch["rng_idx"])
    seed = batch_seed(rng, epoch, PHASE_IDS[phase], idx)
    return torch.Generator(device=device).manual_seed(seed)


def init_metric_acc(keys=TRAIN_METRIC_KEYS, device=None) -> dict:
    """Metric accumulator on the device: per-metric sums, the sample count
    and a NaN flag.  Steps add to it without a host sync; read it once per
    phase."""
    dev = resolve_device(device)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {"sums": {k: zero.clone() for k in keys}, "count": zero.clone(),
            "nan": torch.zeros((), dtype=torch.bool, device=dev)}


def _accumulate(acc, per_image: dict, sample_valid):
    w = sample_valid.to(torch.float32)
    sums = dict(acc["sums"])
    nan = acc["nan"]
    for k, v in per_image.items():
        v = v.to(torch.float32)
        sums[k] = sums[k] + (v * w).sum()
        nan = nan | (torch.isnan(v) & (w > 0)).any()
    return {"sums": sums, "count": acc["count"] + w.sum(), "nan": nan}


def _mask_metrics(out, prep: Preprocessed) -> dict:
    pred = torch.round(out.pred).to(torch.int32)
    mvalid = prep.valid & (prep.target >= 0)
    return {"accuracy": device_accuracy(pred, prep.target, mvalid),
            "dice": device_dice(pred, prep.target, mvalid)}


def _train_metrics(out, losses, prep: Preprocessed) -> dict:
    m = _mask_metrics(out, prep)
    return {"loss": losses.loss, "accuracy": m["accuracy"],
            "dice": m["dice"], "labeled_sp_ratio": losses.labeled_sp_ratio,
            "propagated_labels": losses.propagated_labels,
            "propagate_loss": losses.propagate_loss}


def make_train_step(config, canvas_hw, *, point_mode: bool, device=None):
    """Train step for a (H, W) canvas.

    Returns ``step(model, optimizer, acc, batch, rng, mark=None,
    cache=None) -> acc``.  It updates ``model`` and ``optimizer`` (from
    :func:`make_optimizer`) in place and returns the new metric
    accumulator (:func:`init_metric_acc`); nothing leaves the device.
    ``batch`` holds ``image`` (B, H, W, 3) uint8, ``valid`` (B, H, W) bool
    or ``content_hw`` (B, 2), ``pixel_mask`` (B, H, W) int (-1 where
    unannotated), ``points`` (B, P, 3) xy-class, ``point_valid`` (B, P),
    ``use_mask_as_points`` (B,) and ``sample_valid`` (B,); in the
    device-resize wire format ``img_idx`` and the resize vectors take the
    place of ``image`` and ``pixel_mask``, and ``cache`` holds the
    dataset's full-resolution tensors (``ops.train_resize``).  ``rng`` is a
    ``torch.Generator`` on the step's device, from which the batch's
    augmentation is drawn, or, when the batch carries ``rng_idx`` (epoch,
    batch index; host integers), the int base seed of
    :func:`batch_generator`.  ``mark(name)`` is called after each phase:
    augment, slic, forward, loss, backward, optimizer.
    """
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)

    def step(model, optimizer, acc, batch, rng, mark=None, cache=None):
        _check_model(model, dev)
        mark = mark or (lambda name: None)
        generator = batch_generator(rng, batch, "train", dev)
        b = _batch_on(batch, dev)
        image, valid, pixel_mask = _batch_inputs(b, cache, H, W)
        B = b["sample_valid"].shape[0]
        params = sample_augmentation(config, B, (H, W), point_mode,
                                     generator, dev)
        prep = _preprocess_sample(
            params, image, valid, pixel_mask, b["points"],
            b["point_valid"], b["use_mask_as_points"], config=config,
            train=True, point_mode=point_mode, mark=mark)

        model.zero_grad(set_to_none=True)
        loss, (out, losses) = _forward_and_loss(
            model, prep, K, config, b["sample_valid"], plan, mark=mark)
        loss.backward()
        mark("backward")
        optimizer.step()
        mark("optimizer")
        with torch.no_grad():
            return _accumulate(acc, _train_metrics(out, losses, prep),
                               b["sample_valid"])

    return step


def make_eval_step(config, canvas_hw, device=None):
    """Validation step: no augmentation, no gradients.

    Returns ``step(model, acc, batch, cache=None) -> (pred, acc)`` with
    ``pred`` the (B, H, W) f32 foreground probability and ``acc`` the
    accumulator of :data:`EVAL_METRIC_KEYS`; ``batch`` and ``cache`` as for
    :func:`make_train_step` (an ``rng_idx`` is accepted and unused: the
    step draws nothing)."""
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)
    cdtype = _compute_dtype(config)

    @torch.inference_mode()
    def step(model, acc, batch, cache=None):
        _check_model(model, dev)
        b = _batch_on(batch, dev)
        image, valid, pixel_mask = _batch_inputs(b, cache, H, W)
        prep = _preprocess_sample(
            None, image, valid, pixel_mask, b["points"],
            b["point_valid"], b["use_mask_as_points"], config=config,
            train=False, point_mode=False)
        out = wesup.forward_superpixel(model, prep.image, prep.seg, K,
                                       prep.valid, cdtype,
                                       pooling=config.pooling, plan=plan)
        acc = _accumulate(acc, _mask_metrics(out, prep), b["sample_valid"])
        return out.pred, acc

    return step
