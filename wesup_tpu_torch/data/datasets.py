"""Host-side datasets (numpy in, numpy out): a port of
``wesup_tpu.data.datasets``.

API parity with the reference's ``utils/data.py`` — same directory
conventions (``images/``, ``masks/``, ``points/*.csv``, ``area.csv``,
``spl-masks/``), same proportion subsampling (seeded shuffle then sort,
utils/data.py:84-89), same resize semantics and point-coordinate rescaling
(floor(points * rescaler), utils/data.py:352-355), same negative-image
convention for DigestPath (utils/data.py:483-499).

Differences by design (device-first):
- samples are returned as numpy dicts; geometric/appearance augmentation
  happens ON DEVICE in the train step (wesup_tpu_torch.ops.augment), so
  points are returned as raw coordinates, not rasterized masks;
- the full appearance chain including CLAHE runs on device
  (ops.augment / ops.clahe), in the reference's transform order;
- skimage.io/transform are replaced by the port's own decode
  (``data.codec``, byte-equal to the JAX package's cv2.imread) and its
  cv2-exact resize (``ops.train_resize``); no module here imports cv2,
  pandas or matplotlib.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..ops.train_resize import resize_img, resize_mask
from .codec import imread_mask, imread_rgb


class _DecodeCache:
    """Bounded in-RAM cache of decoded images.

    The reference re-decodes every image in DataLoader workers each epoch
    (utils/data.py:156-159) — fine with many CPU cores, a bottleneck on a
    host with few cores feeding the card.  Histopathology training sets are
    small (GlaS: 85 images ~100 MB decoded), so decoded full-resolution
    images are cached; per-epoch multiscale resizing still happens per
    access.
    """

    def __init__(self, max_bytes: int | None = None):
        if max_bytes is None:
            # default: 8 GB capped at a quarter of physical RAM, so small
            # VMs don't get squeezed (override via WESUP_DECODE_CACHE_BYTES)
            import os

            env = os.environ.get("WESUP_DECODE_CACHE_BYTES")
            if env is not None:
                max_bytes = int(env)
            else:
                try:
                    total = (os.sysconf("SC_PAGE_SIZE")
                             * os.sysconf("SC_PHYS_PAGES"))
                except (ValueError, OSError, AttributeError):
                    total = 32 << 30
                max_bytes = min(8 << 30, total // 4)
        self.max_bytes = max_bytes
        self.used = 0
        self.store = {}

    def get(self, path, reader):
        key = str(path)
        if key in self.store:
            return self.store[key]
        arr = reader(path)
        if self.used + arr.nbytes <= self.max_bytes:
            arr.setflags(write=False)
            self.store[key] = arr
            self.used += arr.nbytes
        return arr


_decode_cache = _DecodeCache()


def mask_contour(mask: np.ndarray, n_classes: int) -> np.ndarray:
    """Class-boundary contours (reference utils/data.py:138-151).

    Reference math: ``dilation(find_boundaries(mask))`` — thick boundaries
    (a pixel differing from any 4-neighbor is marked on BOTH sides), dilated
    by the 3x3 cross — then one-hot ``cont == i`` per class.  Note the
    reference one-hots the BOOLEAN boundary image, so channel 0 is the
    complement, channel 1 the boundary, and channels >= 2 are always empty;
    quirk kept.  skimage is unavailable here, so both steps are vectorized
    shifts.  Returns (H, W, C) int32 (the reference returns CHW long).
    """
    m = np.asarray(mask)
    b = np.zeros(m.shape, bool)
    b[:-1] |= m[:-1] != m[1:]
    b[1:] |= m[1:] != m[:-1]
    b[:, :-1] |= m[:, :-1] != m[:, 1:]
    b[:, 1:] |= m[:, 1:] != m[:, :-1]
    d = b.copy()
    d[:-1] |= b[1:]
    d[1:] |= b[:-1]
    d[:, :-1] |= b[:, 1:]
    d[:, 1:] |= b[:, :-1]
    cont = d.astype(np.int64)
    return np.stack([cont == i for i in range(n_classes)],
                    axis=-1).astype(np.int32)


class SegmentationDataset:
    """Images + optional pixel masks (reference utils/data.py:33-185).

    ``__getitem__`` returns a dict:
        image: (H, W, 3) uint8
        pixel_mask: (H, W) int32 class indices, or None
        points: (P, 3) int32 (x, y, class) or None
        use_mask_as_points: bool (DigestPath negative-image convention)
        contour: (H, W, C) int32 boundary one-hot, only when ``contour=True``
            (reference utils/data.py:39, :138-151)
    """

    def __init__(self, root_dir, mode=None, contour=False, target_size=None,
                 rescale_factor=None, multiscale_range=None, train=True,
                 proportion=1, n_classes=2, seed=0):
        self.root_dir = Path(root_dir).expanduser()
        self.img_paths = sorted((self.root_dir / "images").iterdir())

        self.mask_paths = None
        if (self.root_dir / "masks").exists():
            self.mask_paths = sorted((self.root_dir / "masks").iterdir())

        self.mode = mode or ("mask" if self.mask_paths is not None else None)
        if self.mode != "mask" and contour:
            raise ValueError("mask is required for providing contours")

        self.contour = contour
        self.target_size = target_size
        self.rescale_factor = rescale_factor
        self.train = train
        self.proportion = proportion
        self.n_classes = n_classes
        self.multiscale_range = multiscale_range

        # proportion subsampling: seeded shuffle, slice, sort
        # (reference utils/data.py:84-89)
        self.picked = np.arange(len(self.img_paths))
        if self.proportion < 1:
            np.random.seed(seed)
            np.random.shuffle(self.picked)
            self.picked = self.picked[:len(self)]
            self.picked.sort()

        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return int(self.proportion * len(self.img_paths))

    def _pick_target_size(self, height, width):
        """Returns ((target_h, target_w), rescale_factor_or_None)."""
        if self.target_size is not None:
            return tuple(self.target_size), None
        if self.multiscale_range is not None:
            factor = self._rng.uniform(*self.multiscale_range)
            return (int(np.ceil(factor * height)),
                    int(np.ceil(factor * width))), factor
        if self.rescale_factor is not None:
            return (int(np.ceil(self.rescale_factor * height)),
                    int(np.ceil(self.rescale_factor * width))), self.rescale_factor
        return (height, width), 1.0

    # Set True by the WESUP trainer when the full-res decode lives on the
    # device and the per-epoch cv2-exact resize runs INSIDE the step
    # (ops/train_resize.py).  The multiscale draw still happens here —
    # same self._rng call order — so histories stay byte-identical.
    device_resize = False

    def _resize(self, img, mask):
        h, w = img.shape[:2]
        target, factor = self._pick_target_size(h, w)
        if self.device_resize:
            return img, mask, target, factor  # resize happens on device
        img = resize_img(img, target)
        if mask is not None:
            mask = resize_mask(mask, target)
        return img, mask, target, factor

    def full_res_item(self, i):
        """Full-resolution decode for the device resize cache (position
        ``i`` AFTER proportion subsampling, matching ``__getitem__``)."""
        idx = self.picked[i]
        img = _decode_cache.get(self.img_paths[idx], imread_rgb)
        return {"image": img, "pixel_mask": self._load_mask(idx)}

    def _meta_sample(self, i, sample, full_hw, target_hw):
        """Rewrite a sample for the device-resize wire format: the image and
        mask stay on the device (cache index + resize vectors travel
        instead); points and flags ride along unchanged."""
        sample = dict(sample)
        sample.pop("image")
        sample.pop("pixel_mask")
        sample.update(img_idx=i, full_hw=tuple(int(v) for v in full_hw),
                      target_hw=tuple(int(v) for v in target_hw),
                      device_resize=True)
        return sample

    def _load_mask(self, idx):
        if self.mask_paths is None:
            return None
        m = _decode_cache.get(self.mask_paths[idx], imread_mask)
        return m.astype(np.int32)

    def __getitem__(self, idx):
        i = idx
        idx = self.picked[idx]
        img = _decode_cache.get(self.img_paths[idx], imread_rgb)
        mask = self._load_mask(idx)
        full_hw = img.shape[:2]
        img, mask, target_hw, _ = self._resize(img, mask)
        sample = {
            "image": img,
            "pixel_mask": mask,
            "points": None,
            "use_mask_as_points": False,
        }
        if self.device_resize:
            return self._meta_sample(i, sample, full_hw, target_hw)
        if self.contour:
            # reference computes contours whenever contour=True and a mask
            # exists (utils/data.py:138-151; with no mask it crashes on an
            # unbound local — here the constructor already rejected that)
            sample["contour"] = mask_contour(mask, self.n_classes)
        return sample

    def summary(self, logger=None):
        lines = [
            f"Segmentation dataset ({'training' if self.train else 'inference'}) ",
            f"initialized with {len(self)} images from {self.root_dir}.",
        ]
        if self.mode is not None:
            lines.append(f"Supervision mode: {self.mode}")
        else:
            lines.append("No supervision provided.")
        text = "\n".join(lines)
        if logger is not None:
            logger.info(text)
        else:
            print(text)


class PointSupervisionDataset(SegmentationDataset):
    """Adds ``points/*.csv`` sparse annotations (utils/data.py:279-373).

    CSV rows are (x, y, class); coordinates are rescaled with the image and
    floored (utils/data.py:352-355).
    """

    def __init__(self, root_dir, target_size=None, rescale_factor=None,
                 multiscale_range=None, radius=0, train=True, proportion=1,
                 seed=0):
        super().__init__(root_dir, mode="point", target_size=target_size,
                         rescale_factor=rescale_factor, train=train,
                         proportion=proportion, multiscale_range=multiscale_range,
                         seed=seed)
        self.point_root = self.root_dir / "points"
        self.point_paths = sorted(self.point_root.glob("*.csv"))
        self.radius = radius

    def _read_points(self, idx, orig_hw, target_hw, factor):
        with open(self.point_paths[idx]) as fp:
            rows = [[int(v) for v in row] for row in csv.reader(fp) if row]
        if not rows:
            return np.zeros((0, 3), np.int32)
        points = np.asarray(rows, np.int64)
        oh, ow = orig_hw
        th, tw = target_hw
        # reference rescales by the sampled factor when one exists, else by
        # the target/original ratio (utils/data.py:342-355)
        if factor is not None:
            rescaler = np.array([[factor, factor, 1]])
        else:
            rescaler = np.array([[tw / ow, th / oh, 1]])
        return np.floor(points * rescaler).astype(np.int32)

    def __getitem__(self, idx):
        i = idx
        idx = self.picked[idx]
        img = _decode_cache.get(self.img_paths[idx], imread_rgb)
        mask = self._load_mask(idx)
        orig_hw = img.shape[:2]
        img, mask, target_hw, factor = self._resize(img, mask)
        points = self._read_points(idx, orig_hw, target_hw, factor)
        sample = {
            "image": img,
            "pixel_mask": mask,
            "points": points,
            "use_mask_as_points": False,
        }
        if self.device_resize:
            return self._meta_sample(i, sample, orig_hw, target_hw)
        return sample


class Digest2019PointDataset(PointSupervisionDataset):
    """Near-duplicate of PointSupervisionDataset with the negative-image
    convention (utils/data.py:409-512): files named ``negative*`` get a
    synthetic (0, 0, 0) point and their *pixel mask* is used as the point
    mask (utils/data.py:483-484, 498-499)."""

    def __getitem__(self, idx):
        pidx = self.picked[idx]
        is_negative = self.img_paths[pidx].name.startswith("negative")
        if not is_negative:
            return super().__getitem__(idx)

        img = imread_rgb(self.img_paths[pidx])
        mask = self._load_mask(pidx)
        full_hw = img.shape[:2]
        img, mask, target_hw, _ = self._resize(img, mask)
        sample = {
            "image": img,
            "pixel_mask": mask,
            "points": np.array([[0, 0, 0]], np.int32),
            "use_mask_as_points": True,
        }
        if self.device_resize:
            return self._meta_sample(idx, sample, full_hw, target_hw)
        return sample


class AreaConstraintDataset(SegmentationDataset):
    """Mask + per-image area bound from ``area.csv`` (utils/data.py:188-276).

    Kept for the CWDS-MIL baseline workflows; returns an extra
    ``area`` = (lower, upper) vector.
    """

    def __init__(self, root_dir, target_size=None, rescale_factor=None,
                 area_type="decimal", constraint="equality", margin=0.1,
                 train=True, proportion=1.0, seed=0):
        super().__init__(root_dir, mode="area", target_size=target_size,
                         rescale_factor=rescale_factor, train=train,
                         proportion=proportion, seed=seed)
        with open(self.root_dir / "area.csv") as fp:
            self.areas = [float(row["area"]) for row in csv.DictReader(fp)]
        self.area_type = area_type
        self.constraint = constraint
        self.margin = margin

    def __getitem__(self, idx):
        sample = super().__getitem__(idx)
        pidx = self.picked[idx]
        if self.area_type == "decimal":
            area = self.areas[pidx]
        else:
            area = float((sample["pixel_mask"] == 1).sum())

        if self.constraint == "equality":
            bounds = np.array([area, area], np.float32)
        elif self.constraint == "individual":
            bounds = np.array([area * (1 - self.margin),
                               area * (1 + self.margin)], np.float32)
        else:  # common
            lower = min(self.areas)
            upper = max(self.areas)
            if self.area_type == "integer" and self.target_size is not None:
                lower = int(lower * np.prod(self.target_size))
                upper = int(upper * np.prod(self.target_size))
            bounds = np.array([lower, upper], np.float32)
        sample["area"] = bounds
        return sample


class WESUPV2Dataset(SegmentationDataset):
    """Precomputed superpixel-label masks from ``spl-masks/*.npy``
    (utils/data.py:376-406) plus normalized coordinate grids."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if (self.root_dir / "spl-masks").exists():
            self.spl_paths = sorted((self.root_dir / "spl-masks").iterdir())
        else:
            self.spl_paths = None

    def __getitem__(self, idx):
        pidx = self.picked[idx]
        img = _decode_cache.get(self.img_paths[pidx], imread_rgb)
        spl = np.load(self.spl_paths[pidx]) if self.spl_paths else None
        h, w = img.shape[:2]
        target, _ = self._pick_target_size(h, w)
        img = resize_img(img, target)
        if spl is not None:
            spl = np.stack([resize_mask(spl[..., c], target)
                            for c in range(spl.shape[-1])], axis=-1)
        ys = np.linspace(0, 1, img.shape[0], dtype=np.float32)
        xs = np.linspace(0, 1, img.shape[1], dtype=np.float32)
        coords = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1)
        return {"image": img, "spl_mask": spl, "coords": coords,
                "pixel_mask": None, "points": None,
                "use_mask_as_points": False}


class CompoundDataset:
    """Zip multiple datasets by index (utils/data.py:515-528)."""

    def __init__(self, *datasets):
        self.datasets = datasets

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        return tuple(ds[idx] for ds in self.datasets)

    def summary(self, logger=None):
        for ds in self.datasets:
            ds.summary(logger=logger)
