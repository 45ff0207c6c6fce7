"""Full GlaS-protocol quality run on synthetic data (easy or hard), on the
card.

Port of ``scripts/quality_protocol.py``, with the same flags, defaults,
scales and summary.  One run:

  1. build a synthetic GlaS-scale dataset (``scripts.make_dataset``, drawn
     without OpenCV) with held-out testA/testB splits — ``--hard`` uses the
     non-color-separable gland generator (lobed touching glands, lumina,
     dark rims, stromal nucleus distractors);
  2. generate reference-protocol point annotations over the train masks
     (``python -m wesup_tpu_torch.scripts.generate_points``, point_ratio
     1e-4 — the reference README's default weak-label density);
  3. train the full weak-label method (SLIC + propagation loss on the
     device) for --epochs (``models.initialize_trainer``);
  4. run the complete GlaS test protocol: ``test_glas.test`` 5-scale
     superpixel inference + morphological opening, then ``python -m
     wesup_tpu_torch.scripts.evaluate_glas`` (<2000 px region flip +
     contest metrics);
  5. print per-split mean Accuracy / Dice / Detection F1 / Object Dice /
     Object Hausdorff and write a JSON summary.

The summary holds the JAX script's keys (``variant``, ``epochs``,
``best_val_dice``, ``final_val_dice``, ``splits``, ``wall_s``,
``record_dir``) and, on the card, ``card``: the card's name and power
limit as ``nvidia-smi`` reports them.  ``history.csv`` is read with the
``csv`` module.  Each step's seconds (dataset and points, train, test
and scoring) go to standard error.  ``--root`` and ``--out`` default to
``torch_quality_protocol_{easy,hard}`` in the temporary directory
(``$TMPDIR``); ``--reuse-record auto`` only takes a record that the same
sources of the port trained (``code_digest`` in the record).

Usage:
    python -m wesup_tpu_torch.scripts.quality_protocol [--hard]
        [--epochs 150] [--out F] [--device cpu]
"""

import argparse
import csv
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

SCALES = (0.6, 0.55, 0.5, 0.45, 0.4)

# the file in a record that names the code that trained it
CODE_DIGEST = "code_digest"


def _module(args, **kwargs):
    """``python -m <args>`` from the repository root."""
    return subprocess.run([sys.executable, "-m", *map(str, args)], cwd=REPO,
                          check=True, **kwargs)


def build_dataset(args):
    from wesup_tpu_torch.scripts.make_dataset import make_dataset

    root = Path(args.root)
    if not (root / "train" / "images").exists():
        make_dataset(root, n_train=args.n_train, n_val=args.n_val,
                     hw=tuple(args.hw), seed=args.seed, with_points=False,
                     hard=args.hard, n_testA=args.n_test, n_testB=args.n_test)
        _module(["wesup_tpu_torch.scripts.generate_points",
                 root / "train", "--seed", args.seed])
        (root / "train" / "points-0.0001").rename(root / "train" / "points")
    return root


def val_dice(history):
    """(best, final) ``val_dice`` of a ``history.csv``."""
    with open(history, newline="") as fp:
        dice = [float(row["val_dice"]) for row in csv.DictReader(fp)]
    return max(dice), dice[-1]


def train(root, args, overrides):
    from wesup_tpu_torch.models import initialize_trainer

    os.environ["RECORD_ROOT"] = str(Path(args.root) / "records")
    # only the final checkpoint is needed for the test protocol
    kwargs = dict(epochs=args.epochs, seed=0, checkpoint_period=args.epochs)
    kwargs.update(overrides)  # lets --set seed=1 override the pinned default
    trainer = initialize_trainer("wesup", device=args.device, **kwargs)
    trainer.train(str(root), epochs=args.epochs)
    (trainer.record_dir / CODE_DIGEST).write_text(code_digest())
    return (trainer.record_dir,) + val_dice(trainer.record_dir / "history.csv")


def code_digest():
    """SHA-256 of the port's sources (every ``.py``, ``.cu``, ``.cpp`` and
    ``.h`` under ``wesup_tpu_torch/``, with their paths)."""
    pkg = REPO / "wesup_tpu_torch"
    h = hashlib.sha256()
    for f in sorted(pkg.rglob("*")):
        if f.suffix in (".py", ".cu", ".cpp", ".h") and f.is_file():
            h.update(f.relative_to(pkg).as_posix().encode() + b"\0")
            h.update(f.read_bytes())
    return h.hexdigest()


def _jsonable(v):
    # params/<n>.json round-trips tuples as lists (record.save_params)
    return list(v) if isinstance(v, tuple) else v


def find_reusable_record(args, overrides):
    """Newest record under --root whose params snapshot equals the config
    this invocation would train with, whose final checkpoint exists AND
    that this code trained (its ``code_digest`` equals
    :func:`code_digest`) — lets an interrupted sweep resume without
    re-running its training, and never scores a model that other code
    trained."""
    from wesup_tpu_torch.config import WESUPConfig

    want = {k: _jsonable(v) for k, v in asdict(WESUPConfig()).items()}
    want.update({"epochs": args.epochs, "seed": 0,
                 "checkpoint_period": args.epochs})
    want.update({k: _jsonable(v) for k, v in overrides.items()})
    digest = code_digest()
    records = Path(args.root) / "records"
    for d in sorted(records.glob("*"), reverse=True) if records.exists() else []:
        pj, hist = d / "params" / "0.json", d / "history.csv"
        ck = d / "checkpoints" / f"ckpt.{args.epochs:04d}.pth"
        stamp = d / CODE_DIGEST
        if not (pj.exists() and ck.exists() and hist.exists()
                and stamp.exists() and stamp.read_text() == digest):
            continue
        got = json.loads(pj.read_text())
        if ({k: got.get(k) for k in want} == want
                and sum(1 for _ in open(hist)) >= args.epochs + 1):
            return d
    return None


def run_test_protocol(record_dir, root, device=None):
    from wesup_tpu_torch.test_glas import test

    ckpt = sorted((record_dir / "checkpoints").glob("ckpt.*"))[-1]
    test(str(ckpt), scales=SCALES, data_root=str(root), device=device)
    out = _module(["wesup_tpu_torch.scripts.evaluate_glas",
                   record_dir / f"results-{len(SCALES)}scale",
                   "--gt-root", root, "--ext", "png"],
                  capture_output=True, text=True)
    print(out.stdout)
    results = {}
    split = None
    for line in out.stdout.splitlines():
        if line.strip() in ("testA", "testB"):
            split = line.strip()
            results[split] = {}
        m = re.match(r"(Accuracy|Dice|Detection F1|Object Dice|"
                     r"Object Hausdorff): ([\d.nan]+)", line.strip())
        if m and split:
            results[split][m.group(1)] = float(m.group(2))
    return results


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hard", action="store_true")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--n-train", type=int, default=20)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--n-test", type=int, default=6)
    ap.add_argument("--hw", type=int, nargs=2, default=(522, 775))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config override, e.g. --set slic_update_stride=3 "
                         "(value parsed as JSON)")
    ap.add_argument("--reuse-record", default=None,
                    help="skip training: run the test protocol against this "
                         "existing record dir (its history.csv supplies the "
                         "val-dice fields); 'auto' finds a record whose "
                         "params match this invocation's config")
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs on the host")
    args = ap.parse_args(argv)
    variant = "hard" if args.hard else "easy"
    if args.root is None:
        args.root = str(Path(tempfile.gettempdir())
                        / f"torch_quality_protocol_{variant}")
    if args.out is None:
        args.out = str(Path(tempfile.gettempdir())
                       / f"torch_quality_protocol_{variant}.json")
    return args


def run(args):
    """(summary, seconds per step) of one protocol run."""
    from wesup_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    variant = "hard" if args.hard else "easy"
    t0 = time.time()
    seconds = {}
    t1 = time.perf_counter()
    root = build_dataset(args)
    seconds["dataset"] = time.perf_counter() - t1
    overrides = {}
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v)
    if args.reuse_record == "auto":
        args.reuse_record = find_reusable_record(args, overrides)
        if args.reuse_record is None:
            print("[protocol] no reusable record found; training",
                  file=sys.stderr)
    if args.reuse_record:
        record_dir = Path(args.reuse_record)
        best_val, final_val = val_dice(record_dir / "history.csv")
        print(f"[protocol] reusing trained record {record_dir}: best val "
              f"Dice {best_val:.4f}, final {final_val:.4f}", file=sys.stderr)
    else:
        t1 = time.perf_counter()
        record_dir, best_val, final_val = train(root, args, overrides)
        seconds["train"] = time.perf_counter() - t1
        print(f"[protocol] trained {args.epochs} epochs: best val Dice "
              f"{best_val:.4f}, final {final_val:.4f} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr)
    t1 = time.perf_counter()
    results = run_test_protocol(record_dir, root, args.device)
    seconds["test"] = time.perf_counter() - t1

    summary = {"variant": variant, "epochs": args.epochs,
               "best_val_dice": best_val, "final_val_dice": final_val,
               "splits": results, "wall_s": round(time.time() - t0, 1),
               "record_dir": str(record_dir)}
    if device.type == "cuda":
        summary["card"] = card_line()
    print("[protocol] seconds per step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items()), file=sys.stderr)
    return summary, seconds


def main(argv=None):
    args = parse_args(argv)
    summary, _ = run(args)
    Path(args.out).write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
