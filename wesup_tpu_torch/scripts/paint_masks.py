"""Instance-colored prediction-vs-GT paintings.

Port of ``scripts/paint_masks.py`` (same CLI, files and printed lines;
images read and written by ``data/codec.py``, no OpenCV).  Behavioral
parity with the reference tool (scripts/paint_masks.py there):
a predicted object inherits the instance id (and therefore the color) of
the largest ground-truth object covering >0.5 of that GT object's area;
unmatched predictions get fresh ids past ``max(pred.max(), gt.max())``.
The color table is the same 98-entry palette (5 levels per channel,
background-like colors filtered out, seed-42 shuffle) so paintings are
comparable side by side with reference output.

Implementation is vectorized: the full pred-instance x gt-instance overlap
matrix comes from ONE bincount pass over the joint label image instead of a
per-pair boolean scan, and painting is a palette LUT, so whole-slide masks
paint in milliseconds.
"""

import argparse
from pathlib import Path

import numpy as np

from wesup_tpu_torch.scripts._common import (imread_gray, imsave, label8,
                                             list_images)


def make_palette():
    """The reference's color table: 5^3 RGB grid, keep 192 < sum < 765,
    shuffled under seed 42 (same MT19937 stream -> identical order)."""
    levels = np.array([0, 64, 128, 192, 255], np.int64)
    grid = np.stack(np.meshgrid(levels, levels, levels,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    sums = grid.sum(axis=1)
    table = grid[(sums > 192) & (sums < 765)]
    np.random.RandomState(42).shuffle(table)
    return table.astype(np.uint8)


PALETTE = make_palette()


def overlap_matrix(a, b):
    """(a.max()+1, b.max()+1) pixel-overlap counts of two label images."""
    nb = int(b.max()) + 1
    joint = a.astype(np.int64) * nb + b.astype(np.int64)
    counts = np.bincount(joint.ravel(),
                         minlength=(int(a.max()) + 1) * nb)
    return counts.reshape(-1, nb)


def match_pred_to_gt(pred_lab, gt_lab):
    """Relabel predicted instances onto GT ids.

    For each predicted instance, GT instances with overlap > 0.5 of the GT
    area are candidates; the largest candidate's id wins.  Predictions with
    no candidate get ``max_id + own_id`` (fresh colors), matching the
    reference's matching rule exactly.
    """
    ov = overlap_matrix(pred_lab, gt_lab)  # (P+1, G+1)
    gt_area = np.bincount(gt_lab.ravel(), minlength=ov.shape[1])
    frac = ov / np.maximum(gt_area, 1)[None, :]
    candidate = frac > 0.5
    candidate[:, 0] = False  # background is never a match
    candidate[0, :] = False

    # winner per pred = candidate GT with the largest area
    score = np.where(candidate, gt_area[None, :], -1)
    winner = score.argmax(axis=1)
    has_match = candidate.any(axis=1)

    max_id = max(int(pred_lab.max()), int(gt_lab.max()))
    pred_ids = np.arange(ov.shape[0])
    lut = np.where(has_match, winner, max_id + pred_ids)
    lut[0] = 0
    return lut[pred_lab]


def paint(mask):
    """Map instance ids to palette colors (id 0 = black background; ids past
    the palette get random colors, as in the reference)."""
    max_id = int(mask.max())
    lut = np.zeros((max_id + 1, 3), np.uint8)
    n = min(max_id + 1, len(PALETTE))
    lut[1:n] = PALETTE[1:n]
    for rid in np.unique(mask):
        if rid >= len(PALETTE):
            lut[rid] = np.random.randint(0, 256, size=(3,), dtype="uint8")
    return lut[mask]


def paint_pred_and_gt(pred, gt):
    pred_lab, gt_lab = label8(pred), label8(gt)
    return paint(match_pred_to_gt(pred_lab, gt_lab)), paint(gt_lab)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("pred_path", help="directory of predicted masks")
    parser.add_argument("gt_path", help="directory of ground-truth masks")
    parser.add_argument("-m", "--model", help="model name used in filenames")
    parser.add_argument("-o", "--output", help="output directory")
    args = parser.parse_args(argv)

    out_dir = (Path(args.output) if args.output
               else Path(args.pred_path).parent / "paintings")
    out_dir.mkdir(exist_ok=True)
    tag = args.model or "pred"

    gt_by_stem = {p.stem: p for p in list_images(Path(args.gt_path))}
    for pred_path in list_images(Path(args.pred_path)):
        gt_path = gt_by_stem.get(pred_path.stem)
        if gt_path is None:
            print(f"skip {pred_path.name}: no matching GT")
            continue
        pred_img, gt_img = paint_pred_and_gt(imread_gray(pred_path),
                                             imread_gray(gt_path))
        imsave(out_dir / f"{pred_path.stem}.{tag}.png", pred_img)
        imsave(out_dir / f"{pred_path.stem}.gt.png", gt_img)
        print(f"painted {pred_path.stem}")
    print("Done")


if __name__ == "__main__":
    main()
