"""Precompute superpixel-label masks for WESUPV2 training.

Port of ``scripts/generate_spl_masks.py`` (reference
scripts/generate_spl_masks.py:12-56): for every ``points*`` directory,
run SLIC per image (the port's ``ops/slic``, on the card unless
``--device`` says otherwise) and set the whole superpixel containing each
annotated point to the point's class; save to ``spl-masks*/<img>.npy``.

Usage:
    python -m wesup_tpu_torch.scripts.generate_spl_masks <data_root>
        [--n-classes 2] [--sp-area 200] [--compactness 40] [--device cpu]
"""

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from wesup_tpu_torch.ops.slic import slic
from wesup_tpu_torch.runtime import resolve_device
from wesup_tpu_torch.scripts._common import imread_rgb


def generate_spl_mask(img_u8, points, n_classes, sp_area, compactness,
                      device=None):
    h, w = img_u8.shape[:2]
    rgb = torch.as_tensor(img_u8, device=resolve_device(device))
    seg = slic((rgb.to(torch.float32) / 255.0)[None], sp_area=sp_area,
               compactness=compactness)[0].cpu().numpy()
    mask = np.zeros((h, w, n_classes), dtype="uint8")
    for point in points:
        y, x, class_ = point  # reference indexes segments[x, y] with xy csv
        if 0 <= x < h and 0 <= y < w:
            mask[seg == seg[x, y], class_] = 1
    return mask


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_root")
    parser.add_argument("--n-classes", type=int, default=2)
    parser.add_argument("--sp-area", type=int, default=200)
    parser.add_argument("--compactness", type=int, default=40)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)

    data_root = Path(args.data_root).expanduser()
    img_dir = data_root / "images"

    for point_dir in sorted(data_root.glob("points*")):
        if not point_dir.is_dir():
            continue
        print(f"Processing {point_dir} ...")
        img_paths = sorted(img_dir.iterdir())
        point_paths = sorted(point_dir.iterdir())
        output_dir = data_root / point_dir.name.replace("points", "spl-masks")
        output_dir.mkdir(exist_ok=True)

        for img_path, point_path in zip(img_paths, point_paths):
            img = imread_rgb(img_path)
            with open(point_path) as fp:
                points = np.array([[int(d) for d in row]
                                   for row in csv.reader(fp) if row])
            spl = generate_spl_mask(img, points, args.n_classes,
                                    args.sp_area, args.compactness,
                                    args.device)
            np.save(output_dir / img_path.name.replace(img_path.suffix, ".npy"),
                    spl)
        print(f"Saved to {output_dir}.")


if __name__ == "__main__":
    main()
