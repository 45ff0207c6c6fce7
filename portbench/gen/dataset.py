"""Write a generated set in the layout the trainer reads for point
supervision: ``train/images/*.bmp``, ``train/masks/*.bmp`` and
``train/points/*.csv`` (x, y, class rows), as ``prepare_glas`` and
``generate_points`` leave a GlaS directory.

Images are 24-bit BMPs (bottom-up BGR rows padded to 4 bytes), masks
8-bit BMPs with a grey palette, so that a colour read gives RGB and a
grey read gives the class index.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def bmp_bytes(arr: np.ndarray) -> bytes:
    """An (h, w, 3) RGB or (h, w) grey uint8 array as BMP file bytes."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    grey = arr.ndim == 2
    bpp = 8 if grey else 24
    row = (w * bpp // 8 + 3) & ~3
    palette = (np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
               * np.array([1, 1, 1, 0], np.uint8)).tobytes() if grey else b""
    offset = 14 + 40 + len(palette)
    pix = np.zeros((h, row), np.uint8)
    body = arr if grey else arr[..., ::-1]
    pix[:, :w * bpp // 8] = body.reshape(h, -1)
    data = pix[::-1].tobytes()
    header = struct.pack("<2sIHHI", b"BM", offset + len(data), 0, 0, offset)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, len(data), 2835,
                      2835, 256 if grey else 0, 0)
    return header + dib + palette + data


def write_point_set(root, images: np.ndarray, masks: np.ndarray,
                    points) -> Path:
    """``root/train`` with one image, mask and point CSV per sample."""
    split = Path(root) / "train"
    for sub in ("images", "masks", "points"):
        (split / sub).mkdir(parents=True, exist_ok=True)
    for i, (img, mask, pts) in enumerate(zip(images, masks, points)):
        name = f"train_{i:03d}"
        (split / "images" / f"{name}.bmp").write_bytes(bmp_bytes(img))
        (split / "masks" / f"{name}.bmp").write_bytes(bmp_bytes(mask))
        (split / "points" / f"{name}.csv").write_text(
            "".join(f"{x},{y},{c}\n" for x, y, c in pts))
    return split
