"""Inference engine: multi-scale and tiled prediction.

Port of ``wesup_tpu.inference``, with the four reference strategies, on
one card or sharded over a mesh (``Predictor(mesh=)``):

- superpixel-wise whole image (reference infer.py:24-97): per scale,
  bilinear resize, SLIC + forward, per-scale ROUND, nearest resize back,
  mean over scales, round, and with more than one scale an opening with
  the reference's off-center 9x9 cross;
- pixel-wise whole image (reference pixel_infer.py:40-56): per scale
  (sizes floored, not ceiled), the pixel head, the f32 PROBABILITY map
  resized back bilinearly (align_corners=True), mean, round; no per-scale
  rounding and no opening;
- tiled variants (reference infer_tile.py:23-91): np.linspace-spaced
  overlapping tiles, running-average stitching with an overlap counter;
  tiles go to the device in chunks, one chunk in flight.

With a mesh (``parallel.make_mesh``) every batch (a padded chunk, a
multi-scale group, a chunk of tiles) is padded with blank rows to a
multiple of the data size; each data shard runs its rows and the rows
are gathered (``parallel.collectives``), so every rank returns the whole
result, as JAX's global arrays read.  A model axis above 1 keeps fc1 and
fc2 split (``parallel.shard_params``).  Every rank of the job calls the
same functions with the same inputs.
"""

from __future__ import annotations

import copy
import math
import os
from itertools import count, product

import numpy as np
import torch

from .models import steps
from .ops.morphology import opening, reference_cross_selem
from .ops.resize import _interp_matrix, _nearest_index
from .parallel import collectives, shard_params
from .parallel.mesh import is_sharded
from .runtime import resolve_device
from .tracing import span

# numbers predict_multiscale_batch's shape groups, for its chunks' trace ids
_groups = count()


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
    """Caches predict steps per shape for one model on one device, in
    ``mode`` "superpixel" or "pixel".

    ``device=None`` means the card (it raises without one); the model is
    moved there and put in eval mode.  ``mesh`` shards every batch over
    its data axis; under a model axis above 1 a whole model is split (a
    copy; a trainer's split model is used as it is)."""

    def __init__(self, model, config, mode: str = "superpixel", device=None,
                 mesh=None):
        steps._check_mode(mode)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if (self.mesh is not None and self.mesh.shape["model"] > 1
                and not is_sharded(model)):
            model = shard_params(copy.deepcopy(model), self.mesh)
        self.model = model.to(self.device).eval()
        self.config = config
        self.mode = mode
        self._scaled_cache = {}

    @property
    def data_shards(self) -> int:
        return self.mesh.shape["data"] if self.mesh is not None else 1

    def own_rows(self, array: np.ndarray):
        """This shard's rows of a host batch (its batch dim a multiple of
        :attr:`data_shards`), on the device."""
        if self.mesh is not None:
            array = np.ascontiguousarray(
                array[self.mesh.data_rows(array.shape[0])])
        return self._to_device(array)

    def gather(self, out):
        """The whole batch's output on the device from every shard's."""
        if self.mesh is None:
            return out
        return collectives.gather_rows(out, self.mesh)

    def run_rows(self, step, *arrays):
        """``step(model, *rows)`` on this shard's rows of host ``arrays``,
        gathered."""
        return self.gather(step(self.model, *map(self.own_rows, arrays)))

    def predict_canvas(self, image: np.ndarray, valid: np.ndarray):
        """(B, H, W, 3) uint8 or float canvases and their (B, H, W) valid
        masks -> (B, H, W) f32 probabilities, on the host."""
        B = image.shape[0]
        Bp = _round_up(B, self.data_shards)
        pad = ((0, Bp - B),)
        image = np.pad(image, pad + ((0, 0),) * 3)
        valid = np.pad(valid, pad + ((0, 0),) * 2)
        pred = self.run_rows(self.predict_step(image.shape[1:3]), image,
                             valid)
        return pred[:B].cpu().numpy()

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

    def _to_device(self, array: np.ndarray):
        """A host array on the predictor's device; to the card through
        pinned memory without blocking, so the copy queues behind the work
        in flight instead of waiting for it."""
        t = torch.from_numpy(array)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def dispatch_padded(self, images_f: np.ndarray):
        """Enqueue a padded forward of (B, h, w, 3) float [0, 1] images;
        returns (device pred, B, h, w) WITHOUT copying it back, so a caller
        can keep a chunk in flight.

        The float32 canvas is (B, H, W) rounded up to multiples of 32, the
        content repeated into the pad (last column, then last row), with
        ``valid`` over the content; it is made in a ``wesup.tile.cut``
        span."""
        B, h, w = images_f.shape[:3]
        H, W = _round_up(h), _round_up(w)
        Bp = _round_up(B, self.data_shards)   # blank rows shard evenly
        with span("wesup.tile.cut"):
            canvas = np.zeros((Bp, H, W, 3), np.float32)
            canvas[:B, :h, :w] = images_f
            if w < W:
                canvas[:B, :h, w:] = images_f[:, :, w - 1:w]
            if h < H:
                canvas[:B, h:, :] = canvas[:B, h - 1:h, :]
            valid = np.zeros((Bp, H, W), bool)
            valid[:B, :h, :w] = True
        pred = self.run_rows(self.predict_step((H, W)), canvas, valid)
        return pred, B, h, w

    def predict_padded(self, images_f: np.ndarray) -> np.ndarray:
        """(B, h, w, 3) float [0, 1] -> (B, h, w) f32 fg probability.

        Floats go to the step as they are (no uint8 re-quantization; the
        reference keeps float images after F.interpolate, infer.py:74)."""
        pred, B, h, w = self.dispatch_padded(images_f)
        return pred[:B, :h, :w].cpu().numpy()


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
    preparation overlaps device work.  The predictor's mode picks the
    strategy (module docstring).

    Spans, each chunk's trace id ``("chunk", g, start)`` (``g`` numbers
    the shape groups of every call in the process, ``start`` is the
    chunk's first position in its group): a chunk's
    ``wesup.predict.dispatch`` (its ``wesup.predict.fill``, the canvas
    fill, pinning and copy, and its steps), its ``wesup.predict.drain``
    (the copy back and the accumulation) and each image's
    ``wesup.predict.fuse`` (the rounding and opening).
    """
    if max_batch is None:
        max_batch = int(os.environ.get("WESUP_INFER_MAX_BATCH", "8"))
    sp_mode = predictor.mode == "superpixel"
    results = [None] * len(imgs_u8)
    groups = {}
    for idx, img in enumerate(imgs_u8):
        groups.setdefault(img.shape[:2], []).append(idx)

    for (H0, W0), idxs in groups.items():
        if input_size is not None:
            sizes = [tuple(input_size)]
        elif sp_mode:
            # reference superpixel path ceils (infer.py:73)
            sizes = [(math.ceil(H0 * s), math.ceil(W0 * s)) for s in scales]
        else:
            # reference pixel path floors (pixel_infer.py:44-45)
            sizes = [(int(H0 * s), int(W0 * s)) for s in scales]
        Hc, Wc = _round_up(H0), _round_up(W0)
        acc = [None] * len(idxs)
        group = next(_groups)

        def dispatch(start):
            chunk = idxs[start:start + max_batch]
            with span("wesup.predict.dispatch",
                      trace=("chunk", group, start)):
                with span("wesup.predict.fill"):
                    n = _round_up(len(chunk), predictor.data_shards)
                    canvas = np.zeros((n, Hc, Wc, 3), np.uint8)
                    for j, i in enumerate(chunk):
                        canvas[j, :H0, :W0] = imgs_u8[i]
                    rows = predictor.own_rows(canvas)
                return start, len(chunk), [predictor.gather(
                    predictor._scaled_step((H0, W0), sz, (Hc, Wc))(
                        predictor.model, rows)) for sz in sizes]

        def drain(start, n_real, outs):
            with span("wesup.predict.drain",
                      trace=("chunk", group, start)):
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
            with span("wesup.predict.fuse",
                      trace=("chunk", group, pos - pos % max_batch)):
                fused = acc[pos] / len(sizes)
                if not sp_mode:
                    fused = np.round(fused)
                elif input_size is None:
                    fused = np.round(fused)
                    if len(scales) > 1:
                        fused = opening(fused, reference_cross_selem(9))
            results[i] = fused
    return results


# ---------------------------------------------------------------------------
# Tiling (math parity with reference infer_tile.py:23-91)
# ---------------------------------------------------------------------------

def get_top_left_coordinates(height, width, patch_size):
    n_h = math.ceil(height / patch_size)
    n_w = math.ceil(width / patch_size)
    tops = np.linspace(0, height - patch_size, n_h, dtype=int)
    lefts = np.linspace(0, width - patch_size, n_w, dtype=int)
    return list(product(tops, lefts))


def divide_image_to_patches(img: np.ndarray, patch_size: int) -> np.ndarray:
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    coords = get_top_left_coordinates(img.shape[0], img.shape[1], patch_size)
    return np.stack([img[t:t + patch_size, l:l + patch_size]
                     for t, l in coords]).astype("uint8")


def combine_patches_to_image(patches: np.ndarray, target_height: int,
                             target_width: int) -> np.ndarray:
    """Running-average stitch with an overlap counter channel
    (reference infer_tile.py:59-91)."""
    patch_size = patches.shape[1]
    coords = get_top_left_coordinates(target_height, target_width, patch_size)
    if patches.ndim == 3:
        patches = patches[..., None]
    combined = np.zeros((target_height, target_width, patches.shape[-1] + 1))
    for counter, (top, left) in enumerate(coords):
        sl = np.s_[top:top + patch_size, left:left + patch_size]
        patch = combined[sl][..., :-1]
        overlaps = combined[sl][..., -1:]
        combined[sl][..., :-1] = (patch * overlaps + patches[counter]) / (
            overlaps + 1)
        combined[sl][..., -1:] = overlaps + 1
    return np.squeeze(combined[..., :-1])


@span("wesup.tile.slide")
def predict_tiled(predictor: Predictor, img_u8: np.ndarray, patch_size: int,
                  chunk: int = 8, round_patches: bool = True) -> np.ndarray:
    """Tiled prediction of one (H0, W0, 3) uint8 image: patches in chunks
    of ``chunk`` through :meth:`Predictor.dispatch_padded`, one chunk in
    flight (chunk i is copied back while chunk i + 1 runs), then the
    overlap-averaged stitch, (H0, W0) float64.

    ``round_patches=True`` rounds each patch before stitching, as the
    superpixel tile path does (infer_tile.py:108-110); the pixel tile path
    stitches raw probabilities (pixel_infer_tile.py:52-57).

    A call is a ``wesup.tile.slide`` span (a trace of its own) around the
    patch cut and each chunk's float conversion and canvas
    (``wesup.tile.cut``), the chunks' copies back (``wesup.tile.drain``)
    and the stitch (``wesup.tile.stitch``)."""
    H0, W0 = img_u8.shape[:2]
    with span("wesup.tile.cut"):
        patches = divide_image_to_patches(img_u8, patch_size)
    outs = []

    def drain(pred, n, h, w):
        with span("wesup.tile.drain"):
            prob = pred[:n, :h, :w].cpu().numpy()
            outs.append(np.round(prob) if round_patches else prob)

    in_flight = None
    for i in range(0, len(patches), chunk):
        with span("wesup.tile.cut"):
            block = patches[i:i + chunk].astype(np.float32) / 255.0
        dispatched = predictor.dispatch_padded(block)
        if in_flight is not None:
            drain(*in_flight)
        in_flight = dispatched
    if in_flight is not None:
        drain(*in_flight)
    with span("wesup.tile.stitch"):
        return combine_patches_to_image(np.concatenate(outs, axis=0), H0, W0)
