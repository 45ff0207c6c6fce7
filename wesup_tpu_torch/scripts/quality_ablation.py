"""Augmentation-divergence ablation over the full quality protocol, on
the card.

Port of ``scripts/quality_ablation.py``: the same variants, rows and
markdown table, with ``history.csv`` read by the ``csv`` module.  It runs
the training protocol (synthetic GlaS-scale dataset from
``scripts.make_dataset``, point supervision — the flagship weak-label
method) once per variant and compares val Dice:

  point-mode variants (reference stack: utils/data.py:302-327 — no elastic):
    * baseline        — production defaults (cascade warp, SLIC stride 3)
    * warp_exact      — one-pass warp (no cascade lerp composition)
    * slic_stride1    — exact full-grid SLIC k-means (no update
                        subsampling)
    * slic_stride3    — SLIC update stride 3

  mask-mode variants (reference stack: utils/data.py:116-133 — elastic
  p=0.5, approximated by a coarse-field displacement):
    * mask_baseline   — elastic_p=0.5 (reference probability)
    * mask_no_elastic — elastic_p=0

Each run: identical data, identical seed, the full trainer (augmentation,
SLIC, forward, loss and SGD on the device), N epochs, per-epoch val Dice
from history.csv.  Output: a markdown table + JSON with final/best/
breakthrough epoch per variant (on the card each row also holds ``card``,
the card's name and power limit).

``--root`` and ``--out`` default to the temporary directory (``$TMPDIR``).

Usage:
    python -m wesup_tpu_torch.scripts.quality_ablation [--epochs 120]
        [--out FILE.json] [--device cpu]
"""

import argparse
import csv
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

POINT_VARIANTS = {
    "baseline": {},
    "warp_exact": {"warp_method": "exact"},
    "slic_stride1": {"slic_update_stride": 1},
    "slic_stride3": {"slic_update_stride": 3},
}
MASK_VARIANTS = {
    "mask_baseline": {"elastic_p": 0.5},
    "mask_no_elastic": {"elastic_p": 0.0},
}


def summarize(name, history, wall_s):
    """One table row from a variant's ``history.csv``."""
    with open(history, newline="") as fp:
        dice = [float(row["val_dice"]) for row in csv.DictReader(fp)]
    breakthrough = next((e + 1 for e, d in enumerate(dice) if d > 0.9), None)
    return {
        "variant": name,
        "final_dice": dice[-1],
        "best_dice": max(dice),
        "mean_last10": float(np.mean(dice[-10:])),
        "breakthrough_epoch": breakthrough,
        "wall_s": wall_s,
    }


def run_variant(name, overrides, data_root, epochs, record_root,
                device=None):
    from wesup_tpu_torch.models import initialize_trainer
    from wesup_tpu_torch.scripts.quality_protocol import card_line

    os.environ["RECORD_ROOT"] = str(Path(record_root) / name)
    t0 = time.time()
    trainer = initialize_trainer("wesup", device=device, epochs=epochs,
                                 seed=0, checkpoint_period=0, **overrides)
    trainer.train(str(data_root), epochs=epochs)
    row = summarize(name, trainer.record_dir / "history.csv",
                    round(time.time() - t0, 1))
    if trainer.device.type == "cuda":
        row["card"] = card_line()
    print(f"[ablation] {name}: {row}", file=sys.stderr, flush=True)
    return row


def table(rows):
    """The markdown table of the rows."""
    lines = ["| variant | final val Dice | best | mean(last 10) | "
             "breakthrough epoch | wall s |", "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['variant']} | {r['final_dice']:.4f} | "
                     f"{r['best_dice']:.4f} | {r['mean_last10']:.4f} | "
                     f"{r['breakthrough_epoch']} | {r['wall_s']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--n-train", type=int, default=20)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--hw", type=int, nargs=2, default=(522, 775),
                    help="raw image size; trainer rescales by 0.5")
    tmp = Path(tempfile.gettempdir())
    ap.add_argument("--root", default=str(tmp / "torch_quality_ablation"))
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to run")
    ap.add_argument("--out", default=str(tmp / "torch_quality_ablation.json"))
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs on the host")
    args = ap.parse_args(argv)

    from wesup_tpu_torch.scripts.make_dataset import make_dataset

    root = Path(args.root)
    point_ds = root / "point_ds"
    mask_ds = root / "mask_ds"
    if not (point_ds / "train" / "images").exists():
        make_dataset(point_ds, n_train=args.n_train, n_val=args.n_val,
                     hw=tuple(args.hw), seed=0)
    if not (mask_ds / "train" / "images").exists():
        make_dataset(mask_ds, n_train=args.n_train, n_val=args.n_val,
                     hw=tuple(args.hw), seed=0, with_points=False)

    only = set(args.only.split(",")) if args.only else None
    rows = []
    for variants, ds in ((POINT_VARIANTS, point_ds), (MASK_VARIANTS, mask_ds)):
        for name, ov in variants.items():
            if only is None or name in only:
                rows.append(run_variant(name, ov, ds, args.epochs,
                                        root / "records", args.device))

    print(table(rows))
    Path(args.out).write_text(json.dumps(rows, indent=2))
    print(f"-> {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
