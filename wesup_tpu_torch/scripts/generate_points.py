"""Weak-label generator: sample sparse point annotations from full masks.

Port of ``scripts/generate_points.py`` (same plan, jitter, seeds and CSV;
a process pool in place of joblib):
- per foreground class, per connected region, sample max(1, area*point_ratio)
  points; single-sample regions jitter around the centroid within +-5 with
  <=5 retries (reference generate_points.py:22-45);
- background sampled at area*ratio over the whole class mask
  (reference generate_points.py:56-62);
- output CSV rows are (x, y, class) — the reference swaps its (row, col)
  samples into xy order at generate_points.py:107;
- every mask draws from ``np.random.default_rng(seed)``, as the
  repository's script does (``--seed`` None by default: unseeded).

Usage:
    python -m wesup_tpu_torch.scripts.generate_points <root_dir> [-p 1e-4]
        [--seed S]

writes ``<root_dir>/points-<p>/<mask stem>.csv`` for each mask of
``<root_dir>/masks``; the trainer reads them from ``<root_dir>/points``.
"""

import argparse
import csv
import os
import sys
from pathlib import Path

import numpy as np

from wesup_tpu_torch.scripts._common import imread_gray, label8, pool_map


def _sampling_plan(mask, point_ratio):
    """Yield (bool submask, class_label, n_points) work items.

    Background (class 0) is one item over the whole class mask at
    area*ratio; each foreground connected region is its own item with at
    least one point (reference generate_points.py:48-78)."""
    for class_label in np.unique(mask):
        class_mask = mask == class_label
        if class_label == 0:
            yield class_mask, 0, int(class_mask.sum() * point_ratio)
            continue
        regions = label8(class_mask)
        for idx in np.unique(regions[regions > 0]):
            region = regions == idx
            yield region, int(class_label), max(1, int(region.sum() * point_ratio))


def _jittered_centroid(rng, region_mask):
    """Centroid +-5 jitter, <=6 draws, landing inside the region — or None
    (falls back to a uniform draw, reference generate_points.py:22-45)."""
    rr, cc = np.where(region_mask)
    r0, c0 = int(np.round(rr.mean())), int(np.round(cc.mean()))
    H, W = region_mask.shape
    for _ in range(6):
        r = r0 + rng.integers(-5, 6)
        c = c0 + rng.integers(-5, 6)
        if 0 <= r < H and 0 <= c < W and region_mask[r, c]:
            return r, c
    return None


def generate_points(mask, point_ratio=1e-4, rng=None):
    """(N, 3) rows of (row, col, class) sampled points."""
    rng = rng or np.random.default_rng()
    rows = []
    for region, class_label, n in _sampling_plan(mask, point_ratio):
        if n == 1:
            hit = _jittered_centroid(rng, region)
            if hit is not None:
                rows.append((hit[0], hit[1], class_label))
                continue
        rr, cc = np.where(region)
        for i in rng.permutation(len(rr))[:n]:
            rows.append((int(rr[i]), int(cc[i]), class_label))
    return np.array(rows, int).reshape(-1, 3)


def _annotate_one(mask_path, out_path, point_ratio, seed):
    rng = np.random.default_rng(seed)
    mask = np.asarray(imread_gray(mask_path))
    points = generate_points(mask, point_ratio=point_ratio, rng=rng)
    with open(out_path, "w") as fp:
        # xy order on disk (reference swaps columns at generate_points.py:107)
        csv.writer(fp).writerows(
            [(int(c), int(r), int(k)) for r, c, k in points])
    return len(points)


def main(argv=None):
    parser = argparse.ArgumentParser("Dot annotation generator.")
    parser.add_argument("root_dir",
                        help="Path to data root directory with masks")
    parser.add_argument("-p", "--point-ratio", type=float, default=1e-4,
                        help="Percentage of labeled pixels for each class")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    mask_dir = Path(args.root_dir) / "masks"
    if not mask_dir.exists():
        print("Cannot generate dot annotation without masks.")
        sys.exit(1)

    label_dir = Path(args.root_dir) / f"points-{str(args.point_ratio)}"
    label_dir.mkdir(exist_ok=True)
    print("Generating point annotation ...")

    jobs = [(mask_dir / f, label_dir / f"{Path(f).stem}.csv",
             args.point_ratio, args.seed)
            for f in sorted(os.listdir(mask_dir))]
    counts = pool_map(_annotate_one, jobs)
    print(f"Average number of points: {np.mean(counts)}.")
    return counts


if __name__ == "__main__":
    main()
