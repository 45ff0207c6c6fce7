"""Offline GlaS evaluation: postprocess + contest metrics, per-image CSV.

Port of ``scripts/evaluate_glas.py`` (parity with reference
scripts/evaluate_glas.py): flip foreground regions and holes smaller than
2000 px (evaluate_glas.py:29-42), evaluate accuracy / Dice / detection
F1 / object Dice / object Hausdorff per image on testA/testB, print the
five means, write ``<pred_root>/testA.csv`` and ``testB.csv`` in pandas'
``to_csv`` layout (an unnamed index column of file names, then
``detection_f1``, ``object_dice``, ``object_hausdorff``) with the ``csv``
module, and save the postprocessed predictions to ``<pred_root>-new/``.
A process pool takes joblib's place; each worker scores one image.

Usage:
    python -m wesup_tpu_torch.scripts.evaluate_glas <pred_root>
        [--gt-root ~/data/GLAS_all] [--threshold 2000] [--ext bmp]

Predictions are ``<pred_root>/{testA,testB}/*.<ext>`` (``*.png`` when
there is none), ground truth ``<gt_root>/{testA,testB}/masks/*``, paired
in sorted order.
"""

import argparse
import csv
from pathlib import Path

import numpy as np

from wesup_tpu_torch.ops.morphology import flip_small_regions
from wesup_tpu_torch.scripts._common import imread_gray, imsave, pool_map
from wesup_tpu_torch.utils.metrics import (accuracy, detection_f1, dice,
                                           object_dice, object_hausdorff)

METRICS = (("Accuracy", accuracy), ("Dice", dice),
           ("Detection F1", detection_f1), ("Object Dice", object_dice),
           ("Object Hausdorff", object_hausdorff))
CSV_COLUMNS = ("detection_f1", "object_dice", "object_hausdorff")


def postprocess(pred, threshold=2000):
    return flip_small_regions(pred, threshold)


def read_prediction(path, threshold):
    """A prediction file as the postprocessed float mask in {0, 1}."""
    return postprocess(imread_gray(path) / 255, threshold)


def score(pred, gt):
    """The five metrics of one (prediction, ground truth) pair, in
    :data:`METRICS` order."""
    return [func(pred, gt) for _, func in METRICS]


def report(scores):
    """Print each metric's mean over the images (reference format)."""
    for j, (name, _) in enumerate(METRICS):
        print(f"{name}:", np.mean([s[j] for s in scores]))


def write_csv(path, names, scores):
    """pandas' ``DataFrame.to_csv`` layout of the object metrics."""
    cols = [j for j, (_, f) in enumerate(METRICS)
            if f.__name__ in CSV_COLUMNS]
    with open(path, "w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow(["", *CSV_COLUMNS])
        for name, s in zip(names, scores):
            writer.writerow([name, *(repr(float(s[j])) for j in cols)])


def evaluate_split(pred_dir, gt_dir, new_dir, threshold, ext):
    """Postprocess, save and score one split; returns (names, scores)."""
    new_dir.mkdir(parents=True, exist_ok=True)
    pred_paths = sorted(pred_dir.glob(f"*.{ext}"))
    if not pred_paths:
        pred_paths = sorted(pred_dir.glob("*.png"))
    print("\nReading predictions and gts ...")
    predictions = pool_map(read_prediction,
                           [(p, threshold) for p in pred_paths])
    gts = [imread_gray(g) for g in sorted(gt_dir.iterdir())]

    print("Saving new predictions ...")
    for pred, pred_path in zip(predictions, pred_paths):
        imsave(new_dir / pred_path.name, (pred * 255).astype("uint8"))

    scores = pool_map(score, list(zip(predictions, gts)))
    report(scores)
    return [p.name for p in pred_paths], scores


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("pred_root")
    parser.add_argument("--gt-root", default=str(Path("~/data/GLAS_all")))
    parser.add_argument("--threshold", type=int, default=2000)
    parser.add_argument("--ext", default="bmp")
    args = parser.parse_args(argv)

    glas_root = Path(args.gt_root).expanduser()
    pred_root = Path(args.pred_root).expanduser()
    new_pred_root = pred_root.parent / (pred_root.name + "-new")

    for split in ("testA", "testB"):
        print(f"\n{split}")
        names, scores = evaluate_split(
            pred_root / split, glas_root / split / "masks",
            new_pred_root / split, args.threshold, args.ext)
        write_csv(pred_root / f"{split}.csv", names, scores)


if __name__ == "__main__":
    main()
