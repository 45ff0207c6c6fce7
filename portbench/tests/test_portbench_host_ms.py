"""``host_ms``: the program's spans read over a tiny traced stretch of
each cell's driver on the CPU, and nothing read from a program without
the tracer."""

from __future__ import annotations

import sys

import pytest
import torch

from portbench import run
from portbench.metrics import host_ms
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["crag_train", "glas_predict",
                                  "crag_pixel_tile"])
def test_host_ms_reads_the_spans(name):
    cell = tiny.cell(name)
    want = {m["name"] for m in cell["per_layer"]
            if m["name"].startswith("host_ms.")}
    res = run.run_cell(cell, 2**31 + 7, 0.1, True, torch.device("cpu"))
    got = {k: v for k, v in res["metrics"].items()
           if k.startswith("host_ms.")}
    assert set(got) == want and len(want) >= 2
    for v in got.values():
        assert v["value"] > 0 and v["unit"] in ("ms/img", "ms/slide")


def test_host_ms_reads_nothing_without_the_tracer(monkeypatch):
    import wesup_tpu_torch

    # as in a checkout of the program from before the tracer
    monkeypatch.delattr(wesup_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "wesup_tpu_torch.tracing", None)
    assert host_ms.read("host_ms.tile_stitch", {"traced_units": 3}) is None
