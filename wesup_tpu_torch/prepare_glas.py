"""Shuffle the MICCAI 2015 GlaS dataset into train/val/testA/testB layout.

Port of the repository's ``prepare_glas.py`` (parity with reference
prepare_glas.py) without pandas, sklearn or OpenCV:

- ``Grade.csv`` is read with the ``csv`` module; as in the reference its
  second and third columns are dropped, the rest is (name, grade), and the
  grades of the ``train_`` rows are coded in order of first appearance
  (``pd.factorize``);
- the val split is stratified on that grade as
  ``sklearn.model_selection.train_test_split(test_size=val_size,
  stratify=grade)`` allocates it (:func:`stratified_split`), drawing from
  ``np.random.default_rng(seed)``; ``--seed`` is None by default, unseeded
  as the reference is;
- images are copied, and masks binarised (``mask > 0``) and written as
  8-bit BMPs byte-equal to ``cv2.imwrite``'s (``data/codec.py``).

Usage:
    python -m wesup_tpu_torch.prepare_glas <GlaS dir> [-o data]
        [--val-size 0.1] [--seed S]
"""

import argparse
import csv
import math
import os
from pathlib import Path
from shutil import copyfile

import numpy as np

from wesup_tpu_torch.data import codec


def _approximate_mode(class_counts, n_draws, rng):
    """Draws per class: the floored shares, then one more for the largest
    remainders, ties broken at random (sklearn's ``_approximate_mode``)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y, test_size, rng):
    """(train indices, test indices) of a stratified shuffle split of the
    labels ``y``, allocated per class as sklearn's
    ``StratifiedShuffleSplit`` allocates a float ``test_size``."""
    y = np.asarray(y)
    n = len(y)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("the least populated grade has only 1 member")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"{n_train} train and {n_test} val images cannot "
                         f"hold {len(classes)} grades each")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]))
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def read_grades(orig_path):
    """(names, grade) rows of ``Grade.csv`` without its 2nd and 3rd
    columns (reference prepare_glas.py:18-19)."""
    with open(Path(orig_path) / "Grade.csv", newline="") as fp:
        rows = list(csv.reader(fp))
    kept = [[r[0], *r[3:]] for r in rows[1:] if r]
    if any(len(r) != 2 for r in kept):
        raise ValueError("Grade.csv must have 4 columns: name, patient ID, "
                         "and two grades")
    return kept


def split_train_val_test(orig_path, val_size=0.1, seed=None):
    rows = read_grades(orig_path)
    testA_set = [n for n, _ in rows if n.startswith("testA_")]
    testB_set = [n for n, _ in rows if n.startswith("testB_")]
    train_rows = [(n, g) for n, g in rows if n.startswith("train_")]

    codes = {}  # pd.factorize: codes in order of first appearance
    y = [codes.setdefault(g, len(codes)) for _, g in train_rows]
    train_idx, val_idx = stratified_split(y, val_size,
                                          np.random.default_rng(seed))
    names = [n for n, _ in train_rows]
    return ([names[i] for i in train_idx], [names[i] for i in val_idx],
            testA_set, testB_set)


def prepare_images(orig_path, dst_path, names):
    dst_path = Path(dst_path)
    dst_img_dir = dst_path / "images"
    dst_mask_dir = dst_path / "masks"
    for d in (dst_path, dst_img_dir, dst_mask_dir):
        d.mkdir(parents=True, exist_ok=True)

    for name in names:
        img_name = f"{name}.bmp"
        mask_name = f"{name}_anno.bmp"
        copyfile(Path(orig_path) / img_name, dst_img_dir / img_name)
        mask = codec.imread_mask(Path(orig_path) / mask_name)
        codec.write_bmp(dst_mask_dir / img_name, (mask > 0).astype("uint8"))


def main(argv=None):
    parser = argparse.ArgumentParser("Dataset generator for GlaS challenge.")
    parser.add_argument("dataset_path",
                        help="Path to original MICCAI 2015 GlaS dataset.")
    parser.add_argument("--val-size", type=float, default=0.1)
    parser.add_argument("-o", "--output", default="data")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the split (default: unseeded)")
    args = parser.parse_args(argv)

    splits = split_train_val_test(args.dataset_path, args.val_size,
                                  args.seed)
    os.makedirs(args.output, exist_ok=True)
    for subdir, names in zip(("train", "val", "testA", "testB"), splits):
        prepare_images(args.dataset_path, Path(args.output) / subdir, names)
        print(f"{subdir} data is done.")
    return dict(zip(("train", "val", "testA", "testB"), splits))


if __name__ == "__main__":
    main()
