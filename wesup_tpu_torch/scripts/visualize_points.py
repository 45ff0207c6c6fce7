"""Visualize point annotations as colored circles over (boundary-marked)
images.

Port of ``scripts/visualize_points.py`` (reference
scripts/visualize_points.py:41-62): ``cv2.circle`` is
``data/draw.circles`` (OpenCV's filled midpoint circle), the images are
read and written by ``data/codec.py`` and joblib's pool is
``_common.pool_map``; no OpenCV.

Usage:
    python -m wesup_tpu_torch.scripts.visualize_points <point_root>
        [-r 5] [-o DIR]
"""

import argparse
import csv
import os
from pathlib import Path

from wesup_tpu_torch.data import draw
from wesup_tpu_torch.scripts._common import (imread_gray, imread_rgb, imsave,
                                             mark_boundaries, pool_map)

COLORS = (
    (0, 255, 0),
    (255, 0, 0),
)


def visualize(img_name, point_root, output_dir, radius):
    """Paint one image's points (and its mask's boundaries, where there
    is a mask) to ``output_dir``."""
    img_dir = point_root.parent / "images"
    mask_dir = point_root.parent / "masks"
    basename = os.path.splitext(img_name)[0]
    img = imread_rgb(img_dir / img_name)
    if mask_dir.exists():
        img = mark_boundaries(img, imread_gray(mask_dir / img_name))
    with open(point_root / f"{basename}.csv") as fp:
        points = [[int(d) for d in point] for point in csv.reader(fp)]
    if points:
        draw.circles(img, [p[:2] for p in points], [radius] * len(points),
                     [COLORS[p[2]] for p in points])
    imsave(output_dir / img_name, img)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("point_root", help="Path to point labels directory")
    parser.add_argument("-r", "--radius", type=int, default=5)
    parser.add_argument("-o", "--output")
    args = parser.parse_args(argv)

    point_root = Path(args.point_root)
    output_dir = Path(args.output) if args.output else point_root / "viz"
    output_dir.mkdir(exist_ok=True)

    img_dir = point_root.parent / "images"
    print(f"Generating dot annotation visualization to {output_dir} ...")
    pool_map(visualize, [(name, point_root, output_dir, args.radius)
                         for name in sorted(os.listdir(img_dir))])


if __name__ == "__main__":
    main()
