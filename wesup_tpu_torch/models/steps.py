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
accumulator.  Randomness comes from JAX's threefry keys, drawn on the
host (``utils/prng.py``): the train step takes a key, draws the batch's
augmentation parameters from it as the JAX step does, bit for bit
(:func:`sample_augmentation`), copies them to the device in one
non-blocking transfer and applies them.  The trainer's batches carry
``rng_idx`` (epoch, batch index) and the step folds them into the base
key it is given (:func:`batch_key`), as the JAX step does; device-resize
batches carry ``img_idx`` and resize vectors, and the step builds their
canvases from the cache it is given (``ops.train_resize``).

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
from ..parallel import collectives
from ..runtime import compute_dtype as _compute_dtype
from ..runtime import resolve_device
from ..tracing import span
from ..utils import prng
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
    with span("wesup.step.slic"):
        return slic(img, valid, sp_area=config.sp_area,
                    compactness=config.sp_compactness,
                    n_iters=config.slic_iters,
                    update_stride=config.slic_update_stride)


def make_predict_step(config, canvas_hw, mode: str = "superpixel",
                      device=None):
    """Prediction step for a (H, W) canvas.

    Returns ``step(model, image, valid) -> (B, H, W) f32`` fg
    probability; ``image`` is (B, H, W, 3) uint8 or float, ``valid``
    (B, H, W) bool (tensors or arrays; they are moved to the device).
    ``mode="superpixel"`` runs SLIC and :func:`wesup.forward_superpixel`
    (reference WESUP.forward); ``mode="pixel"`` runs
    :func:`wesup.forward_pixel` (reference WESUPPixelInference), which
    takes no SLIC and no ``valid``.  A call is a ``wesup.step.predict``
    span around the phases' spans (``wesup.step.slic`` and the forward's,
    which depend on the mode and ``config.pooling``).
    """
    _check_mode(mode)
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    cdtype = _compute_dtype(config)
    if mode == "pixel":
        @span("wesup.step.predict")
        @torch.inference_mode()
        def pixel_step(model, image, valid):
            _check_model(model, dev)
            img = _to_float(torch.as_tensor(image, device=dev))
            return wesup.forward_pixel(model, img, cdtype)[..., 1]

        return pixel_step
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)

    @span("wesup.step.predict")
    @torch.inference_mode()
    def step(model, image, valid):
        _check_model(model, dev)
        img = _to_float(torch.as_tensor(image, device=dev))
        valid = torch.as_tensor(valid, device=dev)
        seg = _slic(config, img, valid)
        out = wesup.forward_superpixel(model, img, seg, K, valid, cdtype,
                                       pooling=config.pooling, plan=plan)
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
    (bilinear, align_corners=True), unrounded: (B, Ho, Wo) f32.  A call
    is a ``wesup.step.predict`` span; the resizes run in
    ``wesup.step.resize`` spans.
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

    @span("wesup.step.predict")
    @torch.inference_mode()
    def step(model, image):
        _check_model(model, dev)
        with span("wesup.step.resize"):
            image = torch.as_tensor(image, device=dev)
            img = _to_float(image[:, :Ho, :Wo])
            scaled = resize_bilinear(img, (th, tw), align_corners=not sp_mode)
            scaled = scaled[:, iy][:, :, ix]
        if not sp_mode:
            prob = wesup.forward_pixel(model, scaled, cdtype)[:, :th, :tw, 1]
            with span("wesup.step.resize"):
                return resize_bilinear(prob[..., None], (Ho, Wo),
                                       align_corners=True)[..., 0]
        B = scaled.shape[0]
        valid = torch.zeros((B, Hs, Ws), dtype=torch.bool, device=dev)
        valid[:, :th, :tw] = True
        seg = _slic(config, scaled, valid)
        out = wesup.forward_superpixel(model, scaled, seg, K, valid, cdtype,
                                       pooling=config.pooling, plan=plan)
        with span("wesup.step.resize"):
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
    with span("wesup.step.rng"):
        app, affine, elastic = draw_augmentation(config, B, hw, point_mode,
                                                 key, rows)
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
                       train: bool, point_mode: bool) -> Preprocessed:
    """Augment + rasterize + SLIC for a batch (the JAX function's vmap).

    ``params`` are the drawn augmentation parameters (unused unless
    ``train``).  The augmentation and rasterisation run in a
    ``wesup.step.augment`` span, SLIC in ``wesup.step.slic``."""
    with span("wesup.step.augment"):
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
            warp_fn = (aug.warp_exact if config.warp_method == "exact"
                       else aug.warp)
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
    seg = _slic(config, img, valid)
    return Preprocessed(img, valid, pixel_mask, seg, sup)


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------

def _forward_and_loss(model, prep: Preprocessed, K, config, sample_valid,
                      plan=None, normalise: bool = True):
    """Forward + mean WESUP loss over the valid samples (their sum when
    not ``normalise``: a data shard's gradients are divided by the global
    count after the sum over the shards), in ``wesup.step.forward`` and
    ``wesup.step.loss`` spans.

    Returns ``(loss, (out, losses))`` with ``losses`` per image."""
    with span("wesup.step.forward"):
        out = wesup.forward_superpixel(model, prep.image, prep.seg, K,
                                       prep.valid, _compute_dtype(config),
                                       pooling=config.pooling, plan=plan)
    with span("wesup.step.loss"):
        stats = superpixel_stats(prep.seg, K, prep.sup_mask, prep.valid,
                                 plan=plan)
        losses = wesup_loss(
            out.sp_pred, out.sp_features, stats.labels, stats.labeled,
            stats.real,
            # the reference never applies its class_weights config
            class_weights=(config.class_weights
                           if config.apply_class_weights else None),
            enable_propagation=config.enable_propagation,
            propagate_threshold=config.propagate_threshold,
            propagate_weight=config.propagate_weight,
            epsilon=config.epsilon)
        w = sample_valid.to(torch.float32)
        loss = (losses.loss * w).sum()
        if normalise:
            loss = loss / w.sum().clamp_min(1.0)
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


class FailedBatch(dict):
    """A batch whose copy to the device raised (the trainer's staging
    thread).  It holds only ``sample_valid``; a step given one raises a
    ``RuntimeError`` from ``error`` on every rank, after the ranks agree
    (:func:`_agreed`), so that every rank counts the batch failed and none
    waits in a collective its peers skipped."""

    def __init__(self, error: BaseException, sample_valid):
        super().__init__(sample_valid=sample_valid)
        self.error = error


def _check_staged(batch) -> None:
    if isinstance(batch, FailedBatch):
        raise RuntimeError("the batch's copy to the device failed: "
                           f"{batch.error}") from batch.error


def _batch_on(batch, dev) -> dict:
    """The batch's tensors on ``dev``; ``rng_idx`` stays on the host."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if k != "rng_idx"}


# ---------------------------------------------------------------------------
# Per-batch keys
# ---------------------------------------------------------------------------

PHASE_IDS = {"train": 0, "val": 1}


def batch_key(base_key, epoch: int, phase: int, batch_idx: int):
    """One batch's key: the epoch, the phase (:data:`PHASE_IDS`) and the
    batch index folded into the base key, in that order
    (``wesup_tpu.models.steps._batch_rng_key``).  A batch's draws depend
    on nothing but these four (not on how many batches another phase
    emitted), so a resumed epoch draws what the straight run drew; the
    chain is host arithmetic, with nothing read back from the device."""
    key = prng.fold_in(base_key, epoch)
    return prng.fold_in(prng.fold_in(key, phase), batch_idx)


def _rng_idx(value) -> tuple:
    """(epoch, batch_idx) of a batch's ``rng_idx``: a host pair, or the
    JAX wire format's (B, 2) rows (all equal)."""
    if isinstance(value, torch.Tensor) and value.device.type != "cpu":
        raise ValueError("rng_idx must stay on the host: reading it back "
                         "from the device would sync every batch")
    pair = np.asarray(value).reshape(-1, 2)[0]
    return int(pair[0]), int(pair[1])


def _trace_id(batch, phase: str):
    """A staged batch's trace id: (``phase``, epoch, batch index) from its
    ``rng_idx``, or None (the step's span starts a trace of its own)."""
    if "rng_idx" not in batch:
        return None
    return (phase,) + _rng_idx(batch["rng_idx"])


def step_key(rng, batch, phase: str):
    """The key a step draws from.  With ``rng_idx`` in the batch, ``rng``
    is the base key and the batch's key is :func:`batch_key`; without it,
    ``rng`` is the batch's key, used as it is (as the JAX step's direct
    callers pass one).  A key is a (2,) uint32 array
    (``utils.prng.PRNGKey``; ``np.asarray`` of a JAX key is one)."""
    key = np.asarray(rng)
    if key.shape != (2,) or key.dtype.kind not in "ui":
        raise TypeError(f"rng must be a key, (2,) uint32 as "
                        f"prng.PRNGKey(seed) gives, not "
                        f"{type(rng).__name__}")
    if "rng_idx" not in batch:
        return key
    epoch, idx = _rng_idx(batch["rng_idx"])
    return batch_key(key, epoch, PHASE_IDS[phase], idx)


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


def _sync_gradients(model, mesh, count) -> None:
    """Sum every gradient over the data axis (one flat all-reduce) and
    divide by the global count of valid samples: the gradient of JAX's
    global-batch loss, a sum over the images divided by their count."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    collectives.all_reduce_flat(grads, mesh.data_group)
    torch._foreach_div_(grads, count.clamp_min(1.0))


def _agree_on_failure(failed, values, mesh, dev):
    """One all-reduce over the job of a failure flag and ``values``;
    raises on every rank if any rank's step raised, so that all of them
    skip the batch and none waits in a collective the others left."""
    agreed = collectives.agree([failed is not None] + list(values), mesh,
                               dev)
    if agreed[0].item():
        raise RuntimeError(f"the step failed on {int(agreed[0].item())} "
                           "rank(s)") from failed
    return agreed[1:]


def _agreed(prepare, run, mesh, dev, values=()):
    """``run(prepare())`` on every rank of ``mesh``'s job or on none: a
    ``RuntimeError`` in either part on any rank raises on every rank.

    The ranks agree on a failure flag, and sum ``values``, in one small
    all-reduce after ``run`` (before a train step's gradient
    all-reduce).  Where the model axis splits the head they also agree
    between the parts: the forward then holds the head's model
    collectives, and a rank whose ``prepare`` (augmentation, SLIC) raised
    must not leave its model peers waiting in one.  (A rank that raises
    inside that forward still stalls its peers until the process group's
    timeout.)  Returns ``(prepared, result, summed values)``."""
    failed = prepared = result = None
    try:
        prepared = prepare()
    except RuntimeError as ex:
        failed = ex
    if mesh.model_group is not None:
        _agree_on_failure(failed, [], mesh, dev)
    if failed is None:
        try:
            result = run(prepared)
        except RuntimeError as ex:
            failed = ex
    return prepared, result, _agree_on_failure(failed, values, mesh, dev)


def make_train_step(config, canvas_hw, *, point_mode: bool, device=None,
                    mesh=None):
    """Train step for a (H, W) canvas.

    Returns ``step(model, optimizer, acc, batch, rng, cache=None) ->
    acc``.  It updates ``model`` and ``optimizer`` (from
    :func:`make_optimizer`) in place and returns the new metric
    accumulator (:func:`init_metric_acc`); nothing leaves the device.
    ``batch`` holds ``image`` (B, H, W, 3) uint8, ``valid`` (B, H, W) bool
    or ``content_hw`` (B, 2), ``pixel_mask`` (B, H, W) int (-1 where
    unannotated), ``points`` (B, P, 3) xy-class, ``point_valid`` (B, P),
    ``use_mask_as_points`` (B,) and ``sample_valid`` (B,); in the
    device-resize wire format ``img_idx`` and the resize vectors take the
    place of ``image`` and ``pixel_mask``, and ``cache`` holds the
    dataset's full-resolution tensors (``ops.train_resize``).  ``rng`` is
    a key (``utils.prng.PRNGKey``) from which the batch's augmentation is
    drawn, or, when the batch carries ``rng_idx`` (epoch, batch index;
    host integers), the base key of :func:`batch_key` (:func:`step_key`).
    A call is a ``wesup.step.train`` span (trace id ``("train",)`` and
    the batch's ``rng_idx``) around one span per phase:
    ``wesup.step.augment`` (twice: the batch's tensors, device resize, key
    and draws; then :func:`_preprocess_sample`'s augmentation), ``.slic``,
    ``.forward``, ``.loss``, ``.backward``, (``.allreduce``,)
    ``.optimizer``.

    With a ``mesh`` of a process group (``parallel.make_mesh``) the batch
    is this rank's rows of the global batch (``mesh.data_rows``) and the
    step is JAX's global-batch step: the augmentation is drawn for the
    whole global batch and the rank keeps its rows; the loss is the sum
    over the rank's images; one all-reduce over the job agrees on a
    failure flag and sums the valid samples (under a split head a second
    one agrees before the forward, :func:`_agreed`); one flat all-reduce
    over the data axis sums the gradients, which are then divided by the
    global count (``DistributedDataParallel`` would average them
    instead).  A ``RuntimeError`` on any rank raises on every rank,
    before the update.
    """
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)
    distributed = mesh is not None and mesh.distributed

    def prepare(batch, rng, cache):
        with span("wesup.step.augment"):
            _check_staged(batch)
            with span("wesup.step.rng"):
                key = step_key(rng, batch, "train")
            b = _batch_on(batch, dev)
            image, valid, pixel_mask = _batch_inputs(b, cache, H, W)
            B = b["sample_valid"].shape[0]
            shard = {}   # the rank's rows of the global batch's draws
            if distributed:
                B *= mesh.shape["data"]
                shard["rows"] = mesh.data_rows(B)
            params = sample_augmentation(config, B, (H, W), point_mode, key,
                                         dev, **shard)
        return b, _preprocess_sample(
            params, image, valid, pixel_mask, b["points"],
            b["point_valid"], b["use_mask_as_points"], config=config,
            train=True, point_mode=point_mode)

    def forward_backward(model, b, prep):
        model.zero_grad(set_to_none=True)
        loss, (out, losses) = _forward_and_loss(
            model, prep, K, config, b["sample_valid"], plan,
            normalise=not distributed)
        with span("wesup.step.backward"):
            loss.backward()
        return out, losses

    def step(model, optimizer, acc, batch, rng, cache=None):
        with span("wesup.step.train", trace=_trace_id(batch, "train")):
            _check_model(model, dev)
            if not distributed:
                b, prep = prepare(batch, rng, cache)
                out, losses = forward_backward(model, b, prep)
            else:
                (b, prep), (out, losses), (count,) = _agreed(
                    lambda: prepare(batch, rng, cache),
                    lambda bp: forward_backward(model, *bp), mesh, dev,
                    [torch.as_tensor(batch["sample_valid"]).sum()])
                # each data row's count was summed once per model column
                with span("wesup.step.allreduce"):
                    _sync_gradients(model, mesh, count / mesh.shape["model"])
            with span("wesup.step.optimizer"):
                optimizer.step()
            with torch.no_grad():
                return _accumulate(acc, _train_metrics(out, losses, prep),
                                   b["sample_valid"])

    return step


def make_eval_step(config, canvas_hw, device=None, mesh=None):
    """Validation step: no augmentation, no gradients.

    Returns ``step(model, acc, batch, cache=None) -> (pred, acc)`` with
    ``pred`` the (B, H, W) f32 foreground probability and ``acc`` the
    accumulator of :data:`EVAL_METRIC_KEYS`; ``batch`` and ``cache`` as for
    :func:`make_train_step` (an ``rng_idx`` is accepted and unused: the
    step draws nothing).  With a ``mesh`` of a process group the batch is
    this rank's rows, and the ranks agree on a failure flag as the train
    step's do (the accumulator is summed over the data axis at the end
    of the phase, by the trainer).  A call is a ``wesup.step.eval`` span
    (trace id ``("val",)`` and the batch's ``rng_idx``) around the
    augmentation's, SLIC's and the forward's."""
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)
    cdtype = _compute_dtype(config)

    @torch.inference_mode()
    def step(model, acc, batch, cache=None):
        with span("wesup.step.eval", trace=_trace_id(batch, "val")):
            _check_model(model, dev)
            if mesh is None or not mesh.distributed:
                return predict(model, acc, *prepare(batch, cache))
            return _agreed(lambda: prepare(batch, cache),
                           lambda bp: predict(model, acc, *bp), mesh,
                           dev)[1]

    def prepare(batch, cache):
        _check_staged(batch)
        b = _batch_on(batch, dev)
        image, valid, pixel_mask = _batch_inputs(b, cache, H, W)
        return b, _preprocess_sample(
            None, image, valid, pixel_mask, b["points"],
            b["point_valid"], b["use_mask_as_points"], config=config,
            train=False, point_mode=False)

    def predict(model, acc, b, prep):
        out = wesup.forward_superpixel(model, prep.image, prep.seg, K,
                                       prep.valid, cdtype,
                                       pooling=config.pooling, plan=plan)
        acc = _accumulate(acc, _mask_metrics(out, prep), b["sample_valid"])
        return out.pred, acc

    return step
