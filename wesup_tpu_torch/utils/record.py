"""Experiment record directories (reference: utils/record.py); a copy of
``wesup_tpu.utils.record``, which the port cannot import without jax.

Layout parity with the reference (documented user-facing in its README):
``$RECORD_ROOT or ~/records / <timestamp>/ {checkpoints/, params/<n>.json,
source/, curves/, history.csv, train.log}``.
"""

from __future__ import annotations

import glob
import json
import os
from datetime import datetime
from pathlib import Path
from shutil import copyfile, copytree, rmtree


def prepare_record_dir() -> Path:
    """Create a new timestamped record directory (utils/record.py:19-38)."""
    record_root = Path.home() / "records"
    if os.environ.get("RECORD_ROOT"):
        record_root = Path(os.environ["RECORD_ROOT"]).expanduser()
    record_root.mkdir(parents=True, exist_ok=True)

    record_dir = record_root / datetime.now().strftime("%Y%m%d-%I%M-%p")
    record_dir.mkdir(exist_ok=True)
    (record_dir / "checkpoints").mkdir(exist_ok=True)
    return record_dir


def save_params(record_dir: Path, params: dict):
    """Snapshot run parameters to params/<n>.json (utils/record.py:41-52)."""
    params_dir = Path(record_dir) / "params"
    params_dir.mkdir(exist_ok=True)
    num_of_runs = len(list(params_dir.iterdir()))
    with open(params_dir / f"{num_of_runs}.json", "w") as fp:
        json.dump(params, fp, indent=4, default=str)


def copy_source_files(record_dir: Path):
    """Snapshot the framework source for reproduction (utils/record.py:55-68)."""
    source_dir = Path(record_dir) / "source"
    if source_dir.exists():
        rmtree(source_dir)
    source_dir.mkdir()

    pkg_root = Path(__file__).resolve().parent.parent  # wesup_tpu_torch/
    repo_root = pkg_root.parent
    # the kernels' build directory holds binaries, not source
    copytree(pkg_root, source_dir / "wesup_tpu_torch",
             ignore=lambda d, names: [n for n in names
                                      if n in ("__pycache__", "_build")])
    for source_file in glob.glob(str(repo_root / "*.py")):
        copyfile(source_file, source_dir / os.path.basename(source_file))


def _curve_specs(columns):
    """Map history.csv columns to curve files: one PNG per metric.

    A train-phase column ``m`` yields ``m.png`` with Train(+Val) series; a
    validation-only column ``val_m`` yields ``val_m.png`` with its single
    series (same files the reference emits, utils/record.py:81-107).  The
    ``lr`` column is NOT special-cased: the reference's loop plots it too
    (its ``val_lr`` KeyError fires after the lr line is already drawn and is
    swallowed), so a record dir contains ``lr.png`` with a single series and
    the usual two-label legend (matplotlib applies 'Train' to the one line,
    exactly as the reference renders it)."""
    cols = set(columns)
    specs = []
    for key in columns:
        if key.startswith("val_"):
            metric = key[len("val_"):]
            if metric not in cols:  # metric computed only on the val phase
                specs.append((f"{key}.png", metric, [key], None))
        else:
            series = [key] + ([f"val_{key}"] if f"val_{key}" in cols else [])
            specs.append((f"{key}.png", key, series, ["Train", "Val"]))
    return specs


def plot_learning_curves(history_path: Path):
    """Per-metric learning-curve PNGs from history.csv (utils/record.py:71-107).

    Needs matplotlib and pandas, imported here and not with the module:
    where they are missing the ImportError reaches the trainer's record
    worker, which logs it as a warning and goes on training."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    history_path = Path(history_path)
    history = pd.read_csv(history_path)
    curves_dir = history_path.parent / "curves"
    curves_dir.mkdir(exist_ok=True)

    for fname, metric, series, legend in _curve_specs(list(history.columns)):
        fig, ax = plt.subplots(dpi=200)
        for col in series:
            ax.plot(history[col])
        ax.set(title=f"Model {metric}", xlabel="Epoch",
               ylabel=metric.capitalize())
        if legend is not None:
            ax.legend(legend)
        ax.grid(True)
        fig.savefig(curves_dir / fname)
        plt.close(fig)
