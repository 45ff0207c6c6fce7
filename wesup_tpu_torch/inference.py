"""Inference engine: whole-image multi-scale superpixel prediction.

Port of ``wesup_tpu.inference`` (``Predictor``, ``predict_multiscale``,
``predict_multiscale_batch``, ``host_resize_*``) without a device mesh:
the port targets one card.  Per scale, the image is resized, segmented and
classified on the device, the prediction is rounded and nearest-resized
back (reference infer.py:24-97); scales are averaged, rounded, and with
more than one scale opened with the reference's off-center 9x9 cross.
The tiled path and the pixel-wise head come in a later slice.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .models import steps
from .ops.morphology import opening, reference_cross_selem
from .ops.resize import _interp_matrix, _nearest_index
from .runtime import resolve_device


def _round_up(x, m=32):
    return ((x + m - 1) // m) * m


def host_resize_bilinear(img: np.ndarray, out_hw, align_corners=False):
    """(H, W, C) or (H, W) float resize, exact torch parity, on host."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[:2]
    A_h = _interp_matrix(H, int(out_hw[0]), align_corners)
    A_w = _interp_matrix(W, int(out_hw[1]), align_corners)
    out = np.einsum("oh,hwc->owc", A_h, img.astype(np.float32))
    out = np.einsum("pw,owc->opc", A_w, out)
    return out[..., 0] if squeeze else out


def host_resize_nearest(img: np.ndarray, out_hw):
    iy = _nearest_index(img.shape[0], int(out_hw[0]))
    ix = _nearest_index(img.shape[1], int(out_hw[1]))
    return img[iy[:, None], ix[None, :]]


class Predictor:
    """Caches scaled predict steps per shape for one model on one device.

    ``device=None`` means the card (it raises without one); the model is
    moved there and put in eval mode."""

    def __init__(self, model, config, mode: str = "superpixel", device=None):
        steps._check_mode(mode)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.mode = mode
        self._scaled_cache = {}

    def predict_step(self, canvas_hw):
        """The cached :func:`steps.make_predict_step` for a (H, W) canvas:
        ``step(model, image, valid) -> (B, H, W)`` probabilities."""
        key = ("predict", tuple(canvas_hw))
        if key not in self._scaled_cache:
            self._scaled_cache[key] = steps.make_predict_step(
                self.config, canvas_hw, self.mode, device=self.device)
        return self._scaled_cache[key]

    def _scaled_step(self, content_hw, target_hw, canvas_hw):
        key = (content_hw, target_hw, canvas_hw)
        if key not in self._scaled_cache:
            self._scaled_cache[key] = steps.make_scaled_predict_step(
                self.config, content_hw, target_hw, canvas_hw, self.mode,
                device=self.device)
        return self._scaled_cache[key]


def predict_multiscale(predictor: Predictor, img_u8: np.ndarray,
                       scales=(0.5,), input_size=None) -> np.ndarray:
    """Whole-image multi-scale prediction for one (H0, W0, 3) uint8 image.

    Returns the binarized (H0, W0) float mask (values 0/1)."""
    return predict_multiscale_batch(predictor, [img_u8], scales=scales,
                                    input_size=input_size)[0]


def predict_multiscale_batch(predictor: Predictor, imgs_u8, scales=(0.5,),
                             input_size=None, max_batch: int | None = None):
    """Multi-scale prediction over a list of images.

    Same-shaped images are grouped and pushed through the device in batches
    of up to ``max_batch``; the output is identical to the per-image path
    and does not depend on the chunk size.  ``max_batch=None`` reads
    ``WESUP_INFER_MAX_BATCH`` (default 8), so a caller can rerun an
    inference with other batch shapes.  Each chunk's forwards are enqueued
    before the previous chunk's results are copied back, so host
    preparation overlaps device work.
    """
    if max_batch is None:
        max_batch = int(os.environ.get("WESUP_INFER_MAX_BATCH", "8"))
    results = [None] * len(imgs_u8)
    groups = {}
    for idx, img in enumerate(imgs_u8):
        groups.setdefault(img.shape[:2], []).append(idx)

    for (H0, W0), idxs in groups.items():
        if input_size is not None:
            sizes = [tuple(input_size)]
        else:
            # reference superpixel path ceils (infer.py:73)
            sizes = [(math.ceil(H0 * s), math.ceil(W0 * s)) for s in scales]
        Hc, Wc = _round_up(H0), _round_up(W0)
        acc = [None] * len(idxs)

        def dispatch(start):
            chunk = idxs[start:start + max_batch]
            canvas = np.zeros((len(chunk), Hc, Wc, 3), np.uint8)
            for j, i in enumerate(chunk):
                canvas[j, :H0, :W0] = imgs_u8[i]
            canvas = torch.from_numpy(canvas).to(predictor.device)
            return start, len(chunk), [
                predictor._scaled_step((H0, W0), sz, (Hc, Wc))(
                    predictor.model, canvas) for sz in sizes]

        def drain(start, n_real, outs):
            for out in outs:
                out = out.cpu().numpy()
                for j in range(n_real):
                    pos = start + j
                    acc[pos] = (out[j] if acc[pos] is None
                                else acc[pos] + out[j])

        in_flight = None
        for start in range(0, len(idxs), max_batch):
            dispatched = dispatch(start)
            if in_flight is not None:
                drain(*in_flight)
            in_flight = dispatched
        if in_flight is not None:
            drain(*in_flight)

        for pos, i in enumerate(idxs):
            fused = acc[pos] / len(sizes)
            if input_size is None:
                fused = np.round(fused)
                if len(scales) > 1:
                    fused = opening(fused, reference_cross_selem(9))
            results[i] = fused
    return results
