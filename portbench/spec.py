"""Find a cell's configuration, traffic, driver and metrics by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything
that belongs to one configuration, traffic mix or metric family sits in
a file of its own, found here by that name:

- ``configs/<config>.json``: the model and protocol sizes;
- ``traffic/<traffic>.json``: the traffic parameters and the ``driver``;
- ``cells/<cell>.json``: the cell's own limits of the comparison that
  decides ``correct``;
- ``drivers/<driver>.py``: the entry the measured window drives;
- ``metrics/<family>.py``: the reader of every per-layer metric whose
  name starts with ``<family>`` (the part before the first dot).
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root=None) -> dict:
    root = Path(root) if root is not None else HERE.parent
    with open(root / "BENCHMARK.json") as fp:
        return json.load(fp)


def _named(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, cell: str, base=HERE) -> dict:
    """Everything a run of ``cell`` needs: its entry, configuration,
    traffic, driver module and the metrics it reports."""
    entry = _named(bench["workloads"], cell, "workload")
    with open(Path(base) / "configs" / f"{entry['config']}.json") as fp:
        config = json.load(fp)
    with open(Path(base) / "traffic" / f"{entry['traffic']}.json") as fp:
        traffic = json.load(fp)
    with open(Path(base) / "cells" / f"{cell}.json") as fp:
        limits = json.load(fp)["limits"]
    return {
        "entry": entry,
        "limits": limits,
        "config": config,
        "traffic": traffic,
        "driver": importlib.import_module(
            f"portbench.drivers.{traffic['driver']}"),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, cell)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, cell)],
    }


def metric_reader(name: str):
    """The ``read(name, ctx)`` function of a per-layer metric's family."""
    family = name.split(".", 1)[0]
    return importlib.import_module(f"portbench.metrics.{family}").read
