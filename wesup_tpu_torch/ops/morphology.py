"""Host-side binary morphology used by inference post-processing.

Copy of ``wesup_tpu.ops.morphology``, on scipy.ndimage (skimage is not a
dependency): the opening of the inference CLIs and the region flipping
of the evaluation scripts.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def reference_cross_selem(size: int = 9) -> np.ndarray:
    """The reference's off-center cross structuring element (infer.py:84-91).

    Note the quirk: ``center = (size + 1) // 2`` puts the cross at row/col 5
    of a 9x9 element whose true center is 4 — reproduced exactly.
    """
    assert size % 2 == 1
    selem = np.zeros((size, size))
    center = int((size + 1) / 2)
    selem[center, :] = 1
    selem[:, center] = 1
    return selem


def opening(arr: np.ndarray, selem: np.ndarray) -> np.ndarray:
    """Morphological opening (erosion then dilation), skimage semantics."""
    arr = np.asarray(arr, dtype=np.float64)
    fp = selem > 0
    eroded = ndimage.grey_erosion(arr, footprint=fp, mode="reflect")
    return ndimage.grey_dilation(eroded, footprint=fp, mode="reflect")


def flip_small_regions(pred: np.ndarray, threshold: int) -> np.ndarray:
    """Remove small foreground islands then fill small holes
    (reference scripts/evaluate_glas.py:29-42; threshold 2000 for GlaS,
    5000 for CRAG).  Returns a copy of ``pred`` in its own dtype."""
    eight = np.ones((3, 3), dtype=np.int32)  # skimage label connectivity=2
    pred = np.asarray(pred).copy()
    regions, n = ndimage.label(pred > 0, structure=eight)
    sizes = ndimage.sum_labels(np.ones_like(pred, dtype=np.int64), regions,
                               index=np.arange(1, n + 1))
    for idx in np.where(sizes < threshold)[0]:
        pred[regions == idx + 1] = 0

    inv, n = ndimage.label(pred == 0, structure=eight)
    sizes = ndimage.sum_labels(np.ones_like(pred, dtype=np.int64), inv,
                               index=np.arange(1, n + 1))
    for idx in np.where(sizes < threshold)[0]:
        pred[inv == idx + 1] = 1
    return pred
