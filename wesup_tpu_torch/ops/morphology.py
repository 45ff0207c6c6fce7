"""Host-side binary morphology used by inference post-processing.

Copy of ``wesup_tpu.ops.morphology``'s opening, on scipy.ndimage (skimage
is not a dependency).
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
