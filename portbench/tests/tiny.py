"""Tiny versions of the benchmark's cells for the CPU tests: the same
files, drivers and references, at sizes a test run holds (float32, a
64-wide head, 3 SLIC iterations)."""

from __future__ import annotations

import copy

from portbench import spec

MODEL = dict(fc_width=64, compute_dtype="float32", slic_iters=3, sp_area=100)
PROTOCOL = dict(image_hw=[48, 64], n_train=5, n_test=3, slide_hw=[70, 90],
                patch_size=48, points_p=0.01)
TRAFFIC = dict(batch_size=2, warm_epochs=1, check_steps=2, max_batch=2,
               pool=1, chunk=2, check_slides=1)


def cell(name: str) -> dict:
    """The resolved cell ``name`` of ``BENCHMARK.json``, cut to a tiny
    size."""
    c = spec.resolve(spec.load_benchmark(), name)
    c = dict(c, config=copy.deepcopy(c["config"]),
             traffic=copy.deepcopy(c["traffic"]))
    c["config"]["model"].update(MODEL)
    c["config"]["protocol"].update(PROTOCOL)
    c["traffic"].update(TRAFFIC)
    return c


def driver(name: str, seed: int = 2**31 + 11):
    c = cell(name)
    return c["driver"].Driver(c["config"], c["traffic"], seed, "cpu",
                              c["limits"])
