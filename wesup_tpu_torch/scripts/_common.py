"""Shared helpers of the port's offline tools.

Copy of ``scripts/_common.py``'s image helpers on ``data/codec.py`` (PNG,
BMP and JPEG, as ``cv2.imread`` / ``cv2.imwrite`` read and write them) and its scipy ``label8`` and ``mark_boundaries``, plus
:func:`pool_map`, the process pool that takes joblib's place.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from ..data import codec


def list_images(path):
    """Glob all images within a directory, sorted."""
    path = Path(path)
    images = []
    for ext in ("jpg", "jpeg", "png", "bmp"):
        images.extend(path.glob(f"*.{ext}"))
    return sorted(images)


def imread_rgb(path):
    """(H, W, 3) RGB uint8."""
    return codec.imread_rgb(path)


def imread_gray(path):
    """(H, W) uint8, as ``cv2.imread(IMREAD_GRAYSCALE)``."""
    return codec.imread_mask(path)


def imsave(path, img):
    """Write an (H, W) gray or (H, W, 3) RGB uint8 image as its suffix
    (``.png``, ``.bmp``, ``.jpg`` or ``.jpeg``) names."""
    codec.imwrite(path, np.asarray(img))


def label8(mask):
    """Connected components with skimage-default 8-connectivity."""
    from scipy import ndimage

    lab, _ = ndimage.label(np.asarray(mask) > 0, structure=np.ones((3, 3)))
    return lab


def mark_boundaries(img, mask, color=(255, 255, 0)):
    """Thick-boundary overlay (skimage.segmentation.mark_boundaries
    stand-in)."""
    from scipy import ndimage

    mask = np.asarray(mask)
    dil = ndimage.grey_dilation(mask, size=(3, 3))
    ero = ndimage.grey_erosion(mask, size=(3, 3))
    boundary = dil != ero
    out = img.copy()
    out[boundary] = color
    return out


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def pool_map(fn, arg_tuples) -> list:
    """``[fn(*args) for args in arg_tuples]``, in order, over a pool of
    ``os.cpu_count()`` processes (the reference's
    ``Parallel(n_jobs=os.cpu_count())``).  The workers are forked, unless
    this process has initialised CUDA: a forked child must not touch the
    device, so they are spawned then.  Each worker seeds numpy's global
    generator afresh, as joblib's fresh worker processes start, so that
    forked workers do not all draw the stream they inherited."""
    arg_tuples = list(arg_tuples)
    jobs = min(os.cpu_count() or 1, len(arg_tuples))
    if jobs <= 1:
        return [fn(*args) for args in arg_tuples]
    method = "spawn" if _cuda_initialized() else "fork"
    with ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context(method),
            initializer=np.random.seed) as pool:
        return list(pool.map(fn, *zip(*arg_tuples)))
