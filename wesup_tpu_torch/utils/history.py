"""Per-epoch metric accumulation and CSV history (a copy of
``wesup_tpu.utils.history``, which the port cannot import without jax).

The OUTPUT format is byte-pinned to the reference's ``HistoryTracker``
(utils/history.py there): ``val_``-prefixed eval keys, sorted-key CSV with a
trailing ``lr`` column, "average k = v" log lines and the fixed-width
last-epochs report — downstream tooling greps these files.  The internals
are organized differently: metrics are kept per phase and prefixed only at
the output boundary, and the report is computed with the csv module (no
pandas import on the training path).
"""

from __future__ import annotations

import csv
import os

from . import underline

_PHASES = ("train", "val")


def _prefixed(phase: str, name: str) -> str:
    return name if phase == "train" else f"val_{name}"


class HistoryTracker:
    """Accumulates per-step metrics for one epoch and appends epoch means
    to a history CSV."""

    def __init__(self, save_path=None):
        self.save_path = save_path
        self.learning_rate = None
        self._phase = "train"
        self._values = {p: {} for p in _PHASES}

    # -- phase control ----------------------------------------------------

    def start_new_epoch(self, lr):
        self._values = {p: {} for p in _PHASES}
        self.learning_rate = lr

    def train(self):
        self._phase = "train"

    def eval(self):
        self._phase = "val"

    @property
    def is_train(self):
        return self._phase == "train"

    @property
    def history(self):
        """Prefixed-key view of all recorded values (reference layout)."""
        return {_prefixed(p, k): v
                for p in _PHASES for k, v in self._values[p].items()}

    # -- recording ----------------------------------------------------------

    def step(self, metrics: dict) -> str:
        """Record one step's metrics; returns the formatted report line."""
        bucket = self._values[self._phase]
        parts = []
        for name, value in metrics.items():
            bucket.setdefault(name, []).append(float(value))
            parts.append(
                f"{_prefixed(self._phase, name)} = {float(value):.4f}")
        return ", ".join(parts)

    def _epoch_means(self, phase=None) -> dict:
        phases = _PHASES if phase is None else (phase,)
        return {
            _prefixed(p, k): sum(v) / len(v) if v else 0
            for p in phases for k, v in self._values[p].items()
        }

    def log(self) -> str:
        """Mean-so-far summary line for the CURRENT phase."""
        means = self._epoch_means(self._phase)
        return ", ".join(f"average {k} = {v:.4f}"
                         for k, v in sorted(means.items())).capitalize()

    # -- persistence --------------------------------------------------------

    def save(self):
        """Append this epoch's means (sorted keys + trailing lr column)."""
        if self.save_path is None:
            raise RuntimeError("cannot save history without setting save_path.")
        means = dict(sorted(self._epoch_means().items()))
        fresh = not os.path.exists(self.save_path)
        with open(self.save_path, "w" if fresh else "a") as fp:
            writer = csv.writer(fp)
            if fresh:
                writer.writerow(list(means) + ["lr"])
            writer.writerow(list(means.values()) + [self.learning_rate])

    def report(self, last_n_epochs: int = 5) -> str:
        """Mean of each metric over the last N epochs of the CSV.

        (The title always says "last 5 epochs" — reference quirk kept.)
        """
        with open(self.save_path) as fp:
            rows = list(csv.DictReader(fp))
        tail = rows[-last_n_epochs:]
        lines = []
        for key in rows[0]:
            if key in ("lr", "loss", "val_loss"):
                continue
            mean = sum(float(r[key]) for r in tail) / len(tail)
            lines.append(f"{key:20s} {mean:.4f}")
        return (underline("\nTraining Summary (Avg over last 5 epochs)",
                          style="=") + "\n" + "\n".join(lines))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("csv_path", help="Path to history csv file")
    parser.add_argument("-l", "--last-n-epochs", type=int, default=5)
    args = parser.parse_args()
    print(HistoryTracker(args.csv_path).report(args.last_n_epochs))
