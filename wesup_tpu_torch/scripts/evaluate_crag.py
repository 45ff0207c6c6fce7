"""Offline CRAG evaluation.

Port of ``scripts/evaluate_crag.py`` (parity with reference
scripts/evaluate_crag.py): the GlaS postprocess with a 5000 px
region-flip threshold (evaluate_crag.py:29-42) over ``<pred_root>/*.png``,
the postprocessed predictions saved to ``<pred_root>-new/``, and the five
metrics' means printed.  The reference hardcodes its author's GT path
(evaluate_crag.py:65); here it defaults to ~/data/CRAG/test/masks and is
overridable.

Usage:
    python -m wesup_tpu_torch.scripts.evaluate_crag <pred_root>
        [--gt-root ~/data/CRAG/test/masks] [--threshold 5000]
"""

import argparse
from pathlib import Path

from wesup_tpu_torch.scripts._common import imread_gray, imsave, pool_map
from wesup_tpu_torch.scripts.evaluate_glas import (read_prediction, report,
                                                   score)


def main(argv=None, default_gt_root="~/data/CRAG/test/masks"):
    parser = argparse.ArgumentParser()
    parser.add_argument("pred_root")
    parser.add_argument("--gt-root", default=str(Path(default_gt_root)))
    parser.add_argument("--threshold", type=int, default=5000)
    args = parser.parse_args(argv)

    pred_root = Path(args.pred_root).expanduser()
    new_pred_root = Path(str(pred_root) + "-new")
    new_pred_root.mkdir(exist_ok=True)

    print("Reading predictions and gts ...")
    pred_paths = sorted(pred_root.glob("*.png"))
    predictions = pool_map(read_prediction,
                           [(p, args.threshold) for p in pred_paths])
    gts = [imread_gray(g) for g in
           sorted(Path(args.gt_root).expanduser().glob("*.png"))]

    print("Saving new predictions ...")
    for pred, pred_path in zip(predictions, pred_paths):
        imsave(new_pred_root / pred_path.name, (pred * 255).astype("uint8"))

    report(pool_map(score, list(zip(predictions, gts))))


if __name__ == "__main__":
    main()
