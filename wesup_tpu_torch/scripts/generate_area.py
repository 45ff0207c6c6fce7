"""Generate area.csv (mean mask value per mask) for CWDS-MIL workflows.

Port of ``scripts/generate_area.py``: the same on-disk layout as the
pandas ``DataFrame({"img", "area"}).to_csv`` it writes (an unnamed index
column, then ``img`` and ``area``), written with the ``csv`` module.

Usage:
    python -m wesup_tpu_torch.scripts.generate_area <root_dir>
"""

import argparse
import csv
import os
import sys
from pathlib import Path

import numpy as np

from wesup_tpu_torch.scripts._common import imread_gray


def measure_areas(mask_dir: Path):
    """(names, means): per-mask mean pixel value, one per file (sorted)."""
    names = sorted(os.listdir(mask_dir))
    means = [float(imread_gray(Path(mask_dir) / n).mean()) for n in names]
    return names, means


def write_area_csv(path, names, means):
    with open(path, "w", newline="") as fp:
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow(["", "img", "area"])
        for i, (name, mean) in enumerate(zip(names, means)):
            writer.writerow([i, name, str(np.float64(mean))])


def main(argv=None):
    parser = argparse.ArgumentParser("Area information generator.")
    parser.add_argument("root_dir")
    args = parser.parse_args(argv)

    root = Path(args.root_dir)
    if not (root / "masks").exists():
        print("Cannot generate area information without masks.")
        sys.exit(1)

    out = root / "area.csv"
    write_area_csv(out, *measure_areas(root / "masks"))
    print(f"Area information saved to {out}.")


if __name__ == "__main__":
    main()
