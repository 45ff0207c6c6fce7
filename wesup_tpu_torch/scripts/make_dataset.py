"""Synthetic GlaS-style dataset generator (a port of
``tests/make_dataset.py`` that needs no OpenCV).

Layout matches the reference's expectations (README.md data layout):
    root/train/{images,masks,points}/..., root/val/{images,masks}/...
Point CSVs are (x, y, class) rows, like scripts/generate_points.py output.

The same seed draws the same numbers in the same order as the
repository's generator.  The hard generator draws with ``data/draw.py``
in place of ``cv2.circle``, ``cv2.fillPoly``, ``cv2.polylines`` and
``cv2.resize``, whose rasters it reproduces, so masks and point CSVs are
equal to the repository's; images are written with ``data/codec.py``
(the PNG bytes differ from OpenCV's encoder, the decoded samples do not,
up to the float rounding of the cubic field and the border pixels of a
thick outline that leaves the image; ``tests/test_torch_port_draw.py``).

Usage:
    python -m wesup_tpu_torch.scripts.make_dataset [root]
"""

from pathlib import Path

import numpy as np

from wesup_tpu_torch.data import draw
from wesup_tpu_torch.data.codec import write_png


def make_image(rng, h, w):
    img = np.clip(rng.normal(215, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(rng.integers(2, 5)):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(min(h, w) // 8, min(h, w) // 4)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        mask[blob] = 1
        color = rng.normal([160, 110, 170], 8)
        img[blob] = np.clip(color + rng.normal(0, 6, (blob.sum(), 3)), 0, 255)
    return img, mask


def _lobed_polygon(rng, cy, cx, r, n_pts=48):
    """Gland outline: circle radius modulated by low-order harmonics."""
    th = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
    amp = np.ones(n_pts)
    for k in (2, 3, 5):
        amp += rng.uniform(0.06, 0.22) * np.sin(k * th + rng.uniform(0, 2 * np.pi))
    ys = cy + r * amp * np.sin(th)
    xs = cx + r * amp * np.cos(th)
    return np.stack([xs, ys], -1).astype(np.int32)


def make_image_hard(rng, h, w):
    """Harder H&E-like image: textured eosin background with stromal-nucleus
    distractors, lobed glands that may touch/merge, bright lumina, dark
    epithelial rims, per-image stain shift.  Unlike :func:`make_image`, the
    foreground is not separable by a constant color rule — segmenting it
    needs the gland structure (rim + lumen + interior), so the quality
    protocol keeps headroom to discriminate (val Dice does not saturate)."""
    stain = rng.normal([228, 205, 218], 6)
    field = draw.resize_cubic(
        rng.normal(0, 1, (h // 32 + 2, w // 32 + 2)).astype(np.float32),
        (w, h))
    img = (stain + field[..., None] * rng.uniform(6, 14)
           + rng.normal(0, 5, (h, w, 3))).astype(np.float32)
    # scattered stromal nuclei: same hue family as gland epithelium; the
    # draws keep the repository's order, the discs are painted at once
    nuc = rng.normal([150, 105, 165], 6)
    centers, radii, colors = [], [], []
    for _ in range(int(h * w / 500)):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        radii.append(int(rng.integers(1, 3)))
        colors.append(nuc + rng.normal(0, 8, 3))
        centers.append((x, y))
    if centers:
        draw.circles(img, centers, radii, colors)
    mask = np.zeros((h, w), np.uint8)
    inner = rng.normal([168, 120, 175], 6)
    lumen = rng.normal([232, 215, 230], 5)
    rim = rng.normal([118, 72, 135], 6)
    for _ in range(int(rng.integers(4, 9))):
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(min(h, w) // 12, min(h, w) // 5))
        poly = _lobed_polygon(rng, cy, cx, r)
        sel = draw.fill_poly_mask(h, w, poly)
        mask[sel] = 1
        img[sel] = inner + rng.normal(0, 7, (int(sel.sum()), 3))
        lum_poly = ((poly - [cx, cy]) * rng.uniform(0.35, 0.55)
                    + [cx, cy]).astype(np.int32)
        sel = draw.fill_poly_mask(h, w, lum_poly) & sel
        img[sel] = lumen + rng.normal(0, 6, (int(sel.sum()), 3))
        draw.polylines(img, poly, rim, thickness=max(2, r // 12))
    return np.clip(img, 0, 255).astype(np.uint8), mask


def sample_points(rng, mask, per_class=3):
    rows = []
    for cls in (0, 1):
        ys, xs = np.where(mask == cls)
        if len(ys) == 0:
            continue
        take = rng.choice(len(ys), size=min(per_class, len(ys)), replace=False)
        for i in take:
            rows.append((int(xs[i]), int(ys[i]), cls))
    return rows


def make_dataset(root, n_train=4, n_val=2, hw=(96, 128), seed=0,
                 with_points=True, hard=False, n_testA=0, n_testB=0):
    """``hw`` may be one (H, W) or a list of sizes cycled over the images
    (for multi-size/bucketed-loader tests).  ``hard=True`` uses the
    non-color-separable gland generator; ``n_testA``/``n_testB`` add
    held-out GlaS-protocol test splits (images + masks, no points)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    gen = make_image_hard if hard else make_image
    sizes = list(hw) if isinstance(hw[0], (tuple, list)) else [hw]
    for split, n in [("train", n_train), ("val", n_val),
                     ("testA", n_testA), ("testB", n_testB)]:
        if n == 0:
            continue
        img_dir = root / split / "images"
        mask_dir = root / split / "masks"
        img_dir.mkdir(parents=True, exist_ok=True)
        mask_dir.mkdir(parents=True, exist_ok=True)
        point_dir = None
        if with_points and split == "train":
            point_dir = root / split / "points"
            point_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img, mask = gen(rng, *sizes[i % len(sizes)])
            name = f"{split}_{i:02d}"
            write_png(img_dir / f"{name}.png", img)
            write_png(mask_dir / f"{name}.png", mask)
            if point_dir is not None:
                rows = sample_points(rng, mask)
                with open(point_dir / f"{name}.csv", "w") as fp:
                    for x, y, c in rows:
                        fp.write(f"{x},{y},{c}\n")
    return root


if __name__ == "__main__":
    import sys
    import tempfile

    make_dataset(sys.argv[1] if len(sys.argv) > 1
                 else Path(tempfile.gettempdir()) / "torch_wesup_synth")
