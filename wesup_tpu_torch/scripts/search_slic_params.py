"""Grid-search SLIC parameters by superpixel-oracle accuracy.

Port of ``scripts/search_slic_params.py`` (reference
scripts/search_slic_params.py:30-69): for each (sp_area, compactness)
pair, compute the accuracy an oracle would reach by painting every
superpixel with its mask majority vote.  The clustering runs through the
port's ``ops/slic`` on the card (``--device`` for another); the images
are read by ``data/codec.py`` and rescaled by ``ops/train_resize``'s
cv2-exact INTER_LINEAR and INTER_NEAREST, so no OpenCV is needed.

Usage:
    python -m wesup_tpu_torch.scripts.search_slic_params <dataset_path>
        [-r 0.5] [-a 50,60,...] [-c 10,20,...] [--device cpu]
"""

import argparse
from itertools import product
from pathlib import Path

import numpy as np
import torch

from wesup_tpu_torch.ops.slic import n_clusters, slic
from wesup_tpu_torch.ops.train_resize import resize_img, resize_mask
from wesup_tpu_torch.runtime import resolve_device
from wesup_tpu_torch.scripts._common import (imread_gray, imread_rgb,
                                             list_images)


def oracle_accuracy(img_u8, mask, sp_area, compactness, device=None):
    h, w = img_u8.shape[:2]
    rgb = torch.as_tensor(img_u8, device=resolve_device(device))
    seg = slic((rgb.to(torch.float32) / 255.0)[None], sp_area=int(sp_area),
               compactness=float(compactness))[0].cpu().numpy()
    K = n_clusters(h, w, int(sp_area))
    flat_seg = seg.reshape(-1)
    flat_mask = mask.reshape(-1).astype(np.float64)
    sums = np.bincount(flat_seg, weights=flat_mask, minlength=K)
    cnts = np.bincount(flat_seg, minlength=K)
    votes = np.round(sums / np.maximum(cnts, 1))
    oracle = votes[flat_seg]
    return float((oracle == flat_mask).mean())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_path", help="Path with images/ and masks/")
    parser.add_argument("-r", "--rescale-factor", type=float, default=0.5)
    parser.add_argument("-a", "--area", default="50,60,70,80,90,100")
    parser.add_argument("-c", "--compactness", default="10,20,30,40,50")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)

    print("Reading images and masks ...")
    imgs, masks = [], []
    for ip, mp in zip(list_images(Path(args.dataset_path) / "images"),
                      list_images(Path(args.dataset_path) / "masks")):
        img = imread_rgb(ip)
        tw = int(img.shape[1] * args.rescale_factor)
        th = int(img.shape[0] * args.rescale_factor)
        imgs.append(resize_img(img, (th, tw)))
        masks.append(resize_mask(imread_gray(mp), (th, tw)))

    areas = [int(n) for n in str(args.area).split(",")]
    compactnesses = [int(n) for n in str(args.compactness).split(",")]
    results = []
    for area, compactness in product(areas, compactnesses):
        accs = [oracle_accuracy(img, mask, area, compactness, args.device)
                for img, mask in zip(imgs, masks)]
        results.append((area, compactness, float(np.mean(accs))))
        print(f"# Segments = {area}, Compactness = {compactness}, "
              f"Acc = {np.mean(accs):.4f}")
    return results


if __name__ == "__main__":
    main()
