"""Random fixed-size patch cropper for training-set construction.

Port of ``scripts/generate_patches.py`` (reference
scripts/generate_patches.py: 12 random patches per image, from numpy's
global generator; mask values divided by 255): the images are read and
written by ``data/codec.py``, byte for byte what ``cv2.imwrite`` writes,
and joblib's pool is ``_common.pool_map``; no OpenCV.

Usage:
    python -m wesup_tpu_torch.scripts.generate_patches <dataset_path>
        -o OUT [-p 464]
"""

import argparse
import os
from pathlib import Path

import numpy as np

from wesup_tpu_torch.scripts._common import (imread_gray, imread_rgb, imsave,
                                             pool_map)


def process_img_and_mask(img_path, mask_path, target_img_dir, target_mask_dir,
                         patch_size, n_patches=12):
    img = imread_rgb(img_path)
    mask = imread_gray(mask_path)
    h, w = img.shape[:2]
    suffix = img_path.suffix
    for n in range(n_patches):
        i = int(np.random.randint(0, h - patch_size))
        j = int(np.random.randint(0, w - patch_size))
        patch_name = img_path.name.replace(suffix, f"_{n}{suffix}")
        imsave(target_img_dir / patch_name,
               img[i:i + patch_size, j:j + patch_size])
        imsave(target_mask_dir / patch_name,
               (mask[i:i + patch_size, j:j + patch_size] / 255).astype("uint8"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_path")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-p", "--patch-size", type=int, default=464)
    args = parser.parse_args(argv)

    train_dir = Path(args.dataset_path).expanduser()
    output_dir = Path(args.output).expanduser()
    target_img_dir = output_dir / "images"
    target_mask_dir = output_dir / "masks"
    for d in (output_dir, target_img_dir, target_mask_dir):
        d.mkdir(exist_ok=True, parents=True)

    img_paths = sorted((train_dir / "images").iterdir())
    mask_paths = sorted((train_dir / "masks").iterdir())
    print("\nSplitting into patches ...")
    pool_map(process_img_and_mask,
             [(ip, mp, target_img_dir, target_mask_dir, args.patch_size)
              for ip, mp in zip(img_paths, mask_paths)])


if __name__ == "__main__":
    main()
