"""Canvas batching and prefetching host loader: a port of
``wesup_tpu.data.loader``.

The steps build one program per canvas shape; GlaS/CRAG images are
variably sized and the
reference trains at a random 0.3-0.4x scale per image (utils/data.py:98-101).
We therefore pad every sample onto a fixed per-dataset canvas:

- image: edge-replicated into the padding (keeps on-device SLIC clusters
  from bleeding toward black borders);
- ``valid`` mask marks real-content pixels; all downstream ops (superpixel
  stats, loss, metrics) are masked by it;
- point annotations ride along as fixed-size coordinate arrays, rasterized
  on device AFTER the geometric augmentation.

This replaces the reference's ``DataLoader(num_workers=os.cpu_count())``
(models/base.py:288-300): a single prefetch thread decodes and places the
next batch (numpy only) while the card computes the current one.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class CanvasSpec:
    height: int
    width: int
    max_points: int = 256
    n_classes: int = 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def infer_canvas(dataset, pad_multiple: int = 32,
                 max_points: int = 256, n_classes: int = 2) -> CanvasSpec:
    """Derive a static canvas from a dataset's image sizes and scale policy."""
    from .codec import image_size

    max_h = max_w = 0
    for p in dataset.img_paths:
        size = image_size(p)
        if size is None:
            continue
        h, w = size
        if dataset.target_size is not None:
            h, w = dataset.target_size
        elif dataset.multiscale_range is not None:
            s = max(dataset.multiscale_range)
            h, w = int(np.ceil(s * h)), int(np.ceil(s * w))
        elif dataset.rescale_factor is not None:
            h = int(np.ceil(dataset.rescale_factor * h))
            w = int(np.ceil(dataset.rescale_factor * w))
        max_h, max_w = max(max_h, h), max(max_w, w)
    return CanvasSpec(_round_up(max_h, pad_multiple), _round_up(max_w, pad_multiple),
                      max_points, n_classes)


def _points_arrays(sample: dict, spec: CanvasSpec):
    points = np.zeros((spec.max_points, 3), np.int32)
    point_valid = np.zeros((spec.max_points,), bool)
    pts = sample.get("points")
    if pts is not None and len(pts) > 0:
        pts = np.asarray(pts, np.int32)
        n = min(len(pts), spec.max_points)
        points[:n] = pts[:n]
        point_valid[:n] = True
    return points, point_valid


def place_meta_on_canvas(sample: dict, spec: CanvasSpec) -> dict:
    """Device-resize wire item: the image/mask stay in the device cache;
    only the cache index + cv2-exact resize vectors + points travel
    (~10 KB vs ~2.3 MB per B=8 batch)."""
    from ..ops.train_resize import resize_vectors

    th, tw = sample["target_hw"]
    if th > spec.height or tw > spec.width:
        raise ValueError(f"target ({th}x{tw}) exceeds canvas "
                         f"({spec.height}x{spec.width})")
    item = resize_vectors(sample["full_hw"], (th, tw),
                          (spec.height, spec.width))
    item["img_idx"] = np.int32(sample["img_idx"])
    item["content_hw"] = np.array([th, tw], np.int32)
    item["points"], item["point_valid"] = _points_arrays(sample, spec)
    item["use_mask_as_points"] = np.bool_(
        sample.get("use_mask_as_points", False))
    item["sample_valid"] = np.bool_(True)
    return item


def _blank_meta_item(spec: CanvasSpec) -> dict:
    """Batch-padding item for the device-resize wire format: all-zero
    vectors resize cache image 0 to an all-zero canvas (matching
    ``_blank_item``'s zeros) and content (0, 0) masks everything out."""
    from ..ops.train_resize import resize_vectors

    item = resize_vectors((1, 1), (0, 0), (spec.height, spec.width))
    item["img_idx"] = np.int32(0)
    item["content_hw"] = np.zeros((2,), np.int32)
    item["points"] = np.zeros((spec.max_points, 3), np.int32)
    item["point_valid"] = np.zeros((spec.max_points,), bool)
    item["use_mask_as_points"] = np.bool_(False)
    item["sample_valid"] = np.bool_(False)
    return item


def place_on_canvas(sample: dict, spec: CanvasSpec) -> dict:
    """Pad one dataset sample onto the canvas; returns fixed-shape arrays."""
    if sample.get("device_resize"):
        return place_meta_on_canvas(sample, spec)
    img = sample["image"]
    h, w = img.shape[:2]
    H, W = spec.height, spec.width
    if h > H or w > W:
        raise ValueError(f"sample ({h}x{w}) exceeds canvas ({H}x{W})")

    canvas = np.empty((H, W, 3), np.uint8)
    canvas[:h, :w] = img
    # edge-replicate padding
    if w < W:
        canvas[:h, w:] = img[:, w - 1:w]
    if h < H:
        canvas[h:, :] = canvas[h - 1:h, :]

    valid = np.zeros((H, W), bool)
    valid[:h, :w] = True

    # masks are class indices (< 128 for every supported dataset), so they
    # are BORN int8 here: the wire format ships int8 (a quarter of the
    # host-to-device bytes) and this skips the per-batch
    # int32 -> int8 range-check + downcast pass in trainer._put_batch.
    # Raw masks with values > 127 (e.g. 0/255) keep int32, and a mixed batch
    # promotes back to int32 at np.stack — the downcast stays lossless.
    src = sample.get("pixel_mask")
    if src is not None:
        src = np.asarray(src)
        dtype = (np.int8 if src.size == 0
                 or (src.min() >= -128 and src.max() <= 127) else np.int32)
    else:
        dtype = np.int8
    pixel_mask = np.full((H, W), -1, dtype)
    if src is not None:
        pixel_mask[:h, :w] = src

    points, point_valid = _points_arrays(sample, spec)

    return {
        "image": canvas,
        "valid": valid,
        # content extents (h, w): valid is by construction the top-left
        # rectangle they describe, so only these 8 bytes need to travel to
        # the device (trainer._put_batch strips the bool mask from the wire
        # and the step rebuilds it)
        "content_hw": np.array([h, w], np.int32),
        "pixel_mask": pixel_mask,
        "points": points,
        "point_valid": point_valid,
        "use_mask_as_points": np.bool_(sample.get("use_mask_as_points", False)),
        "sample_valid": np.bool_(True),
    }


def _blank_item(spec: CanvasSpec) -> dict:
    """Batch-padding item: contributes nothing to loss or metrics."""
    return {
        "image": np.zeros((spec.height, spec.width, 3), np.uint8),
        "valid": np.zeros((spec.height, spec.width), bool),
        "content_hw": np.zeros((2,), np.int32),
        "pixel_mask": np.full((spec.height, spec.width), -1, np.int8),
        "points": np.zeros((spec.max_points, 3), np.int32),
        "point_valid": np.zeros((spec.max_points,), bool),
        "use_mask_as_points": np.bool_(False),
        "sample_valid": np.bool_(False),
    }


def _stack(items) -> dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class CanvasBatcher:
    """Iterates fixed-shape batches with one background prefetch thread.

    Two modes:
    - fixed (default): every sample lands on ``spec``'s canvas; one step
      (and one set of plan constants) per phase.
    - bucketed (``bucket=True``): each sample gets the smallest 32-aligned
      canvas that fits its content (capped by ``spec``), and batches form
      within equal-shape groups.  The reference pays zero padding (it
      processes exact sizes one by one); a single max-scale canvas wastes
      ~25% of compute at multiscale (0.3, 0.4) — buckets cut that to <10%
      for a handful of extra compilations.

    Batches are padded with blank items (``sample_valid=False``) so shapes
    stay static: the last batch of each shape group up to ``batch_size``,
    and EVERY batch up to a multiple of ``shard_multiple`` — set it to the
    mesh's data-shard count and any batch size shards cleanly over the mesh
    (blanks contribute nothing to loss or metrics).

    With ``shard`` (a data shard's index, below ``shard_multiple``) the
    batcher emits only that shard's rows of each global batch (``rows``
    of ``effective_batch_size``), and loads only the samples in them: the
    global batches, their order and their padding are the unsharded
    batcher's.

    The dataset is one of ``data.datasets``: the batcher draws each
    sample's size with ``draw_target`` (from the file's header) to pick
    its canvas, and ``load``s the sample only when its batch is emitted,
    so a shard decodes no other shard's images.
    """

    def __init__(self, dataset, spec: CanvasSpec, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False, bucket: bool = False,
                 shard_multiple: int = 1, shard: int | None = None):
        self.dataset = dataset
        self.spec = spec
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.bucket = bucket
        self.shard_multiple = max(1, int(shard_multiple))
        if shard is not None and not 0 <= shard < self.shard_multiple:
            raise ValueError(f"shard {shard} of {self.shard_multiple}")
        self.shard = shard
        self._epoch = 0
        self._last_len = None

    @property
    def effective_batch_size(self) -> int:
        """Global batch dim: batch_size rounded up to the shard multiple."""
        return _round_up(self.batch_size, self.shard_multiple)

    @property
    def rows(self) -> int:
        """Emitted batch dim: the global one, or a shard's part of it."""
        eff = self.effective_batch_size
        return eff if self.shard is None else eff // self.shard_multiple

    def __len__(self):
        """Batch count.  Exact in fixed mode; in bucket mode the per-epoch
        count depends on the random multiscale draw (per-bucket remainders),
        so this returns the previous epoch's actual count once one epoch has
        run, else the fixed-mode lower bound."""
        if self.bucket and self._last_len is not None:
            return self._last_len
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _spec_for(self, h, w) -> CanvasSpec:
        """The canvas of a sample whose (target) size is (h, w)."""
        if not self.bucket:
            return self.spec
        return CanvasSpec(min(_round_up(h, 32), self.spec.height),
                          min(_round_up(w, 32), self.spec.width),
                          self.spec.max_points, self.spec.n_classes)

    def __iter__(self) -> Iterator[dict]:
        it = self.epoch_iter(self._epoch)
        self._epoch += 1
        return it

    def epoch_iter(self, epoch: int) -> Iterator[dict]:
        """One epoch's batches with an EXPLICIT shuffle-epoch index.

        ``__iter__`` delegates here with an internal counter (unchanged
        behavior); the trainer's cross-epoch lookahead pipeline addresses
        epochs explicitly instead so that pre-building epoch e+1's batches
        while e trains neither consumes nor disturbs the counter.

        A generator: its producer thread starts at the first ``next()``,
        which the trainer's staging thread calls as soon as it starts a
        chain (for epoch e+1, at the end of epoch e's train phase), and
        keeps ``prefetch`` batches built ahead.  Closing the generator (a
        cancelled chain) stops the producer after the batch it is
        building, and waits for it."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        SENTINEL = object()
        eff_bs = self.effective_batch_size
        rows = range(eff_bs)
        if self.shard is not None:
            rows = rows[self.shard * self.rows:(self.shard + 1) * self.rows]
        blank = (_blank_meta_item
                 if getattr(self.dataset, "device_resize", False)
                 else _blank_item)

        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def emit(spec, batch) -> bool:
            items = []
            for r in rows:
                if r >= len(batch):
                    items.append(blank(spec))
                    continue
                items.append(place_on_canvas(self.dataset.load(*batch[r]),
                                             spec))
            return put(_stack(items))

        def producer():
            try:
                pending = {}  # (H, W) -> (spec, [(idx, target)])
                for idx in order:
                    target = self.dataset.draw_target(int(idx))
                    spec = self._spec_for(*target[0])
                    key = (spec.height, spec.width)
                    spec, batch = pending.setdefault(key, (spec, []))
                    batch.append((int(idx), target))
                    if len(batch) == self.batch_size:
                        if not emit(spec, batch):
                            return
                        pending[key] = (spec, [])
                for spec, batch in pending.values():
                    if batch and not self.drop_last:
                        if not emit(spec, batch):
                            return
            except Exception as exc:  # surface loader errors to the consumer
                put(exc)
            finally:
                put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True,
                             name=f"wesup-loader-{epoch}")
        t.start()
        count = 0
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                if isinstance(item, Exception):
                    raise item
                count += 1
                yield item
            self._last_len = count
        finally:
            stop.set()
            t.join()
