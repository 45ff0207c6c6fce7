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
  the slide goes to the device once, is cut there chunk by chunk and
  stitched there (``ops.tile``), and its map comes back once.

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
from .ops import tile
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
        self._tile_cache = {}

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

    def upload_rows(self, images, n_rows: int):
        """This shard's rows of an (n_rows, H, W, 3) uint8 batch, on the
        device: row ``r`` is ``images[r]`` (each (H, W, 3)), the rows past
        them are blank.  Each row is copied once (by torch, on all cores),
        straight into a pinned host buffer (the caching host allocator's,
        reused once the copies queued from it are done), and goes to the
        card without blocking."""
        rows = (self.mesh.data_rows(n_rows) if self.mesh is not None
                else slice(0, n_rows))
        buf = torch.empty((rows.stop - rows.start, *images[0].shape[:2], 3),
                          dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        for j, r in enumerate(range(rows.start, rows.stop)):
            if r < len(images):
                buf[j].copy_(torch.from_numpy(np.ascontiguousarray(images[r])))
            else:
                buf[j].zero_()
        return buf.to(self.device, non_blocking=True)

    def to_host(self, outs):
        """Host copies of device tensors, started without blocking, and
        the event to wait on before reading them: on the card each copy
        goes to pinned memory and queues behind the work that makes it;
        on the CPU the tensors themselves and no event."""
        if self.device.type != "cuda":
            return outs, None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(
            o, non_blocking=True) for o in outs]
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def predict_padded(self, images_f: np.ndarray) -> np.ndarray:
        """(B, h, w, 3) float [0, 1] -> (B, h, w) f32 fg probability.

        The float32 canvas is (B, H, W) rounded up to multiples of 32, the
        content repeated into the pad (last column, then last row), with
        ``valid`` over the content.  Floats go to the step as they are (no
        uint8 re-quantization; the reference keeps float images after
        F.interpolate, infer.py:74)."""
        B, h, w = images_f.shape[:3]
        H, W = _round_up(h), _round_up(w)
        Bp = _round_up(B, self.data_shards)   # blank rows shard evenly
        canvas = np.zeros((Bp, H, W, 3), np.float32)
        canvas[:B, :h, :w] = images_f
        if w < W:
            canvas[:B, :h, w:] = images_f[:, :, w - 1:w]
        if h < H:
            canvas[:B, h:, :] = canvas[:B, h - 1:h, :]
        valid = np.zeros((Bp, H, W), bool)
        valid[:B, :h, :w] = True
        pred = self.run_rows(self.predict_step((H, W)), canvas, valid)
        return pred[:B, :h, :w].cpu().numpy()

    def tile_grid(self, hw, patch_size: int):
        """The patch grid of a (H0, W0) slide (:func:`patch_grid`) on the
        device, cached per shape: ``(tops, lefts, (h, w))``, int32 tensors
        and the patches' size."""
        key = ("grid", tuple(hw), int(patch_size))
        if key not in self._tile_cache:
            tops, lefts = patch_grid(*hw, patch_size)
            self._tile_cache[key] = (
                *(torch.from_numpy(a.astype(np.int32)).to(self.device)
                  for a in (tops, lefts)),
                (min(patch_size, hw[0]), min(patch_size, hw[1])))
        return self._tile_cache[key]

    def _tile_valid(self, n_rows, n_real, patch_hw, canvas_hw):
        """The superpixel step's ``valid`` for a chunk's canvas: the
        first ``n_real`` rows' patches; cached per shape."""
        key = ("valid", n_rows, n_real, tuple(patch_hw), tuple(canvas_hw))
        if key not in self._tile_cache:
            valid = torch.zeros((n_rows, *canvas_hw), dtype=torch.bool,
                                device=self.device)
            valid[:n_real, :patch_hw[0], :patch_hw[1]] = True
            self._tile_cache[key] = valid
        return self._tile_cache[key]

    def dispatch_tiles(self, slide: torch.Tensor, grid, first: int, n: int):
        """Enqueue the padded forward of the patches ``first`` .. ``first
        + n - 1`` of a (H0, W0, 3) uint8 slide on the device, on
        :meth:`tile_grid`'s ``grid``; returns the gathered (Bp, H, W)
        device prediction WITHOUT copying it back.

        The canvas is :meth:`predict_padded`'s, cut on the device
        (:func:`ops.tile.cut`) for this shard's rows only, in a
        ``wesup.tile.cut`` span."""
        tops, lefts, (h, w) = grid
        H, W = _round_up(h), _round_up(w)
        Bp = _round_up(n, self.data_shards)   # blank rows shard evenly
        rows = (self.mesh.data_rows(Bp) if self.mesh is not None
                else slice(0, Bp))
        n_rows = rows.stop - rows.start
        n_real = max(0, min(rows.stop, n) - rows.start)
        with span("wesup.tile.cut"):
            canvas = tile.cut(slide, tops, lefts, first + rows.start, n_real,
                              n_rows, (h, w), (H, W))
            valid = (None if self.mode == "pixel" else
                     self._tile_valid(n_rows, n_real, (h, w), (H, W)))
        return self.gather(self.predict_step((H, W))(self.model, canvas,
                                                     valid))


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
    inference with other batch shapes.  The predictor's mode picks the
    strategy (module docstring).

    Each chunk's images go up from pinned memory at their own shape (the
    steps read only the content), and its result comes back into pinned
    memory right behind its steps: in superpixel mode one uint8 map an
    image, summed over the scales on the device (the sum is exact).  A
    chunk's results are finished on the host after the next chunk is
    dispatched: at one scale in superpixel mode the painted 0/1 map,
    converted to float64 by torch on all cores (the mean over one scale
    and its rounding change nothing); otherwise the mean over the
    scales (pixel mode: the f32 sum in scale order), rounded, and in
    superpixel mode opened.  Every result is a new array.

    Spans, each chunk's trace id ``("chunk", g, start)`` (``g`` numbers
    the shape groups of every call in the process, ``start`` is the
    chunk's first position in its group): a chunk's
    ``wesup.predict.dispatch`` (its ``wesup.predict.fill``, the images'
    copy into pinned memory and the upload, then its steps and the copy
    back's launch), its ``wesup.predict.drain`` (the wait for that copy,
    and in pixel mode the sum over the scales) and each of its images'
    ``wesup.predict.fuse`` (the finishing above).
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
        group = next(_groups)

        def dispatch(start):
            chunk = idxs[start:start + max_batch]
            with span("wesup.predict.dispatch",
                      trace=("chunk", group, start)):
                with span("wesup.predict.fill"):
                    rows = predictor.upload_rows(
                        [imgs_u8[i] for i in chunk],
                        _round_up(len(chunk), predictor.data_shards))
                outs = [predictor.gather(
                    predictor._scaled_step((H0, W0), sz, (H0, W0))(
                        predictor.model, rows)) for sz in sizes]
                if sp_mode:
                    outs = [sum(outs[1:], outs[0])]
                return (start, chunk, *predictor.to_host(outs))

        def drain(start, chunk, host, done):
            trace = ("chunk", group, start)
            with span("wesup.predict.drain", trace=trace):
                if done is not None:
                    done.synchronize()
                acc = host[0].numpy()
                for out in host[1:]:
                    acc = acc + out.numpy()
            for j, i in enumerate(chunk):
                with span("wesup.predict.fuse", trace=trace):
                    if sp_mode and len(sizes) == 1:
                        results[i] = host[0][j].to(torch.float64).numpy()
                    else:
                        fused = np.round(acc[j] / len(sizes))
                        results[i] = (opening(fused, reference_cross_selem(9))
                                      if sp_mode else fused)

        in_flight = None
        for start in range(0, len(idxs), max_batch):
            dispatched = dispatch(start)
            if in_flight is not None:
                drain(*in_flight)
            in_flight = dispatched
        if in_flight is not None:
            drain(*in_flight)
    return results


# ---------------------------------------------------------------------------
# Tiling (math parity with reference infer_tile.py:23-91)
# ---------------------------------------------------------------------------

def patch_grid(height, width, patch_size):
    """The patches' tops and lefts; the patches are their product, row
    by row."""
    n_h = math.ceil(height / patch_size)
    n_w = math.ceil(width / patch_size)
    tops = np.linspace(0, height - patch_size, n_h, dtype=int)
    lefts = np.linspace(0, width - patch_size, n_w, dtype=int)
    return tops, lefts


def get_top_left_coordinates(height, width, patch_size):
    return list(product(*patch_grid(height, width, patch_size)))


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
    """Tiled prediction of one (H0, W0, 3) uint8 image: the slide goes to
    the device once; its patches are cut there in chunks of ``chunk``
    (:meth:`Predictor.dispatch_tiles`), each chunk's forward queued behind
    the last with nothing copied back; the overlap-averaged stitch runs
    there too (:func:`ops.tile.stitch`), and the (H0, W0) float64 map is
    copied back once.  Bitwise :func:`combine_patches_to_image` over
    :meth:`Predictor.predict_padded` of :func:`divide_image_to_patches`.

    ``round_patches=True`` rounds each patch before stitching, as the
    superpixel tile path does (infer_tile.py:108-110); the pixel tile path
    stitches raw probabilities (pixel_infer_tile.py:52-57).

    A call is a ``wesup.tile.slide`` span (a trace of its own) around the
    slide's upload and each chunk's cut (``wesup.tile.cut``), the chunks'
    steps, the stitch's launch (``wesup.tile.stitch``) and the copy back
    of the map, which waits for the device (``wesup.tile.drain``)."""
    if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img_u8.shape}")
    H0, W0 = img_u8.shape[:2]
    grid = predictor.tile_grid((H0, W0), patch_size)
    tops, lefts, (h, w) = grid
    n = tops.shape[0] * lefts.shape[0]
    with span("wesup.tile.cut"):
        slide = predictor._to_device(np.ascontiguousarray(img_u8, np.uint8))
    probs = None
    for first in range(0, n, chunk):
        m = min(chunk, n - first)
        pred = predictor.dispatch_tiles(slide, grid, first, m)
        if probs is None:
            probs = torch.empty((n, h, w), dtype=pred.dtype,
                                device=pred.device)
        probs[first:first + m] = pred[:m, :h, :w]
    with span("wesup.tile.stitch"):
        out = tile.stitch(probs, tops, lefts, (H0, W0), round_patches)
    with span("wesup.tile.drain"):
        return out.cpu().numpy()
