"""DigestPath2019 pipeline of the port (parity with the repository's
test_dp2019_pipeline.py): pad and split whole slides into a grid of
patches with an ``info.csv``, infer each patch (superpixel at
``input_size=(400, 400)``, or pixel-wise at scale 0.4), stitch the
patches back, then report the positive and negative slides' overall
accuracy and Dice.

Usage:
    python -m wesup_tpu_torch.test_dp2019_pipeline <data_root> -c <ckpt>
        [-m wesup] [--pixel] [--skip-infer] [-p 1000] [--device cpu]

``data_root`` holds ``images/`` (``.jpg`` or ``.png`` slides) and
``masks/`` (``.png``), slides named ``positive-*`` and ``negative-*``.
Patches go to ``<data_root>-patches/{images,masks}/`` as
``{slide index}-{x}-{y}.jpg`` / ``.png``, written by ``data/codec.py``
byte for byte as ``cv2.imwrite`` writes them; the masks inferred to
``<record dir>/results-for-<ckpt name>/`` and the stitched ones to
``<record dir>/combined-results[-pixel]-for-<ckpt name>/``.  As in the
repository's script, a grid ends at the padded slide: no empty patch is
written when a side is a multiple of the patch size.  ``-m`` other than
``wesup`` fails where the model is built, as the repository's
``initialize_trainer`` fails.  ``--device`` as ``device=`` in
``infer.py``: the card by default, ``cpu`` for the host.
"""

import argparse
import csv
import math
from itertools import product
from pathlib import Path
from shutil import rmtree

import numpy as np

from wesup_tpu_torch.data import codec
from wesup_tpu_torch.scripts._common import pool_map


def split_patches(data_root, patch_size):
    """Tile whole slides into a zero-padded patch grid (rows of
    ``info.csv``: ``(stem, original_height, original_width)``)."""
    output_dir = data_root.parent / f"{data_root.name}-patches"
    if output_dir.exists():
        print(f"{output_dir} found. Skipping.")
        return output_dir
    for sub in ("images", "masks"):
        (output_dir / sub).mkdir(parents=True, exist_ok=True)

    img_paths = sorted(list((data_root / "images").glob("*.jpg"))
                       + list((data_root / "images").glob("*.png")))
    mask_paths = sorted((data_root / "masks").glob("*.png"))

    rows = []
    for index, (img_path, mask_path) in enumerate(zip(img_paths, mask_paths)):
        img = codec.imread_rgb(img_path)
        mask = codec.imread_mask(mask_path)
        h, w = mask.shape
        img = np.pad(img, ((0, -h % patch_size), (0, -w % patch_size),
                           (0, 0)))
        mask = np.pad(mask, ((0, -h % patch_size), (0, -w % patch_size)))
        for gy, gx in product(range(img.shape[0] // patch_size),
                              range(img.shape[1] // patch_size)):
            y, x = gy * patch_size, gx * patch_size
            cell = (slice(y, y + patch_size), slice(x, x + patch_size))
            codec.imwrite(output_dir / "images" / f"{index}-{x}-{y}.jpg",
                          img[cell])
            codec.imwrite(output_dir / "masks" / f"{index}-{x}-{y}.png",
                          mask[cell])
        rows.append((img_path.stem, h, w))

    with open(output_dir / "info.csv", "w") as fp:
        csv.writer(fp).writerows(rows)
    return output_dir


def oa(P, G):
    return (P == G).mean()


def dice(S, G, epsilon=1e-7):
    S, G = S > 0, G > 0
    return 2 * (G * S).sum() / (G.sum() + S.sum() + epsilon)


def combine_single(patches, original_size):
    """The float64 canvas of a slide's patch masks, cropped to its size."""
    height, width = original_size
    patch_size = codec.imread_mask(patches[0]).shape[0]
    ext_height = math.ceil(height / patch_size) * patch_size
    ext_width = math.ceil(width / patch_size) * patch_size
    final = np.zeros((ext_height, ext_width))
    for patch_path in patches:
        patch = codec.imread_mask(patch_path)
        _, x, y = patch_path.name.replace(patch_path.suffix, "").split("-")
        final[int(y):int(y) + patch_size, int(x):int(x) + patch_size] = patch
    return final[:height, :width]


def as_written(canvas):
    """``canvas`` as ``cv2.imwrite`` stores a float64 image: each value
    rounded half to even and saturated to uint8."""
    return np.clip(np.rint(canvas), 0, 255).astype(np.uint8)


def compute_metrics(predictions, gts, negative=False):
    if negative:
        predictions = [(255 - p) for p in predictions]
        gts = [(255 - g) for g in gts]
    pairs = list(zip(predictions, gts))
    print("Accuracy:", np.mean(pool_map(oa, pairs)))
    print("Dice:", np.mean(pool_map(dice, pairs)))


def _read_masks(paths):
    return pool_map(codec.imread_mask, [(p,) for p in paths])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_root")
    parser.add_argument("-m", "--model", default="wesup",
                        choices=["fcn", "cdws", "wesup", "sizeloss"])
    parser.add_argument("--pixel", action="store_true", default=False)
    parser.add_argument("--skip-infer", action="store_true", default=False)
    parser.add_argument("-p", "--patch-size", type=int, default=1000)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs on the host")
    args = parser.parse_args(argv)
    print(args)

    data_root = Path(args.data_root).expanduser()
    print("\nSplitting patches ...")
    patch_dir = split_patches(data_root, args.patch_size)

    ckpt_path = Path(args.checkpoint).expanduser()
    results_dir = ckpt_path.parent.parent / f"results-for-{ckpt_path.name}"

    if not args.skip_infer:
        if results_dir.exists():
            rmtree(str(results_dir))
        results_dir.mkdir(exist_ok=True)
        print("\nMaking inference ...")
        if args.model == "wesup" and args.pixel:
            from wesup_tpu_torch.pixel_infer import main as pixel_infer

            pixel_infer(str(patch_dir), checkpoint=str(ckpt_path),
                        scales=(0.4,), output=str(results_dir),
                        device=args.device)
        else:
            from wesup_tpu_torch.infer import main as infer_main

            infer_main(str(patch_dir), model_type=args.model,
                       checkpoint=str(ckpt_path), input_size=(400, 400),
                       output_dir=str(results_dir), device=args.device)

    tag = "combined-results-pixel" if args.pixel else "combined-results"
    output_dir = results_dir.parent / f"{tag}-for-{ckpt_path.name}"
    output_dir.mkdir(exist_ok=True)

    with open(patch_dir / "info.csv") as fp:
        info = [(stem, int(h), int(w)) for stem, h, w in csv.reader(fp)]

    print("\nCombining predictions ...")
    for index, (stem, height, width) in enumerate(info):
        patches = list(results_dir.glob(f"{index}-*"))
        combined = combine_single(patches, (height, width))
        codec.imwrite(output_dir / f"{stem}.png", as_written(combined))
    print(f"Combined results saved to {output_dir}.")

    gt_dir = data_root / "masks"

    print("\nEvaluating positive OA and Dice ...")
    pos = _read_masks(sorted(output_dir.glob("positive-*.png")))
    pos_gts = _read_masks(sorted(gt_dir.glob("positive-*.png")))
    compute_metrics(pos, pos_gts, negative=False)

    print("\nEvaluating negative OA and Dice ...")
    neg = _read_masks(sorted(output_dir.glob("negative-*.png")))
    neg_gts = _read_masks(sorted(gt_dir.glob("negative-*.png")))
    compute_metrics(neg, neg_gts, negative=True)
    return output_dir


if __name__ == "__main__":
    main()
