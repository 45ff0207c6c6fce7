"""Predict steps: the whole per-batch inference pipeline on the card.

Port of ``wesup_tpu.models.steps.make_predict_step`` and
``make_scaled_predict_step`` in superpixel mode: uint8 (or float) canvas ->
float, per-image SLIC, VGG16 taps, superpixel pooling (kernels K1 and K2),
fused projection, MLP head, painted foreground map.  PyTorch runs eagerly,
so a "step" is a plain function closed over the static shapes and plans;
it takes the model as its first argument, as the JAX step takes params.

The step factories run on ``cuda`` unless ``device`` says otherwise, and raise
when no CUDA device is present and none was given.
"""

from __future__ import annotations

import torch

from ..ops.resize import resize_bilinear, resize_nearest
from ..ops.slic import make_plan, n_clusters, slic
from ..runtime import compute_dtype as _compute_dtype
from ..runtime import resolve_device
from . import wesup

_PIXEL_LATER = ("mode='pixel' (the pixel-wise head) is not ported yet: it "
                "comes with the port's inference-and-pixel-head slice")


def _check_mode(mode: str) -> None:
    if mode == "pixel":
        raise NotImplementedError(_PIXEL_LATER)
    if mode != "superpixel":
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
    ``mark`` is passed on to :func:`wesup.forward_superpixel` (after a
    ``"slic"`` mark of its own) for phase timing.
    """
    _check_mode(mode)
    dev = resolve_device(device)
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    K = n_clusters(H, W, config.sp_area)
    plan = make_plan(H, W, config.sp_area)
    cdtype = _compute_dtype(config)

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
    (bilinear, align_corners=False, as the reference's F.interpolate),
    pads it up to a 32-aligned compute canvas by edge replication, runs
    SLIC and the superpixel forward, rounds the prediction and
    nearest-resizes it back.  Returns (B, Ho, Wo) uint8 in {0, 1}.
    """
    _check_mode(mode)
    dev = resolve_device(device)
    Ho, Wo = int(content_hw[0]), int(content_hw[1])
    th, tw = int(target_hw[0]), int(target_hw[1])
    # scaled content padded up to a 32-aligned compute canvas
    Hs = -(-th // 32) * 32
    Ws = -(-tw // 32) * 32
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
        scaled = resize_bilinear(img, (th, tw), align_corners=False)
        scaled = scaled[:, iy][:, :, ix]
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
