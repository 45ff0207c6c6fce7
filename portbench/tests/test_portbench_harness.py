"""The harness: cells, configurations, drivers and metrics found by
name; the result line's schema; the refusal without a card."""

from __future__ import annotations

import json

import pytest
import torch

import portbench.drivers
import portbench.metrics
from portbench import run, spec
from portbench.tests import tiny


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        for m in cell["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))
        assert hasattr(cell["driver"], "Driver")
        for m in cell["end_to_end"]:
            assert m["name"] == "setup_s" or \
                m["name"] in cell["traffic"]["end_to_end"]


def test_a_cell_added_only_as_files(tmp_path, monkeypatch):
    """A new configuration, traffic, cell, driver and metric family, each
    only a file, are found by the names in BENCHMARK.json."""
    bench = spec.load_benchmark()
    for sub in ("configs", "traffic", "cells"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps(
        {"model": {}, "protocol": {"n": 3}}))
    (tmp_path / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"driver": "toy_driver", "end_to_end": {"toy_rate": "rate"}}))
    (tmp_path / "cells" / "toy_cell.json").write_text(json.dumps(
        {"limits": {"gap": 0.5}}))
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "toy_driver.py").write_text(
        "from portbench.drivers.common import DriverBase, check\n"
        "class Driver(DriverBase):\n"
        "    def setup(self):\n        self.n = 0\n"
        "    def unit(self):\n"
        "        self.attempted += 1\n"
        "        self.log_work(kind='toy', content=[])\n        return 1\n"
        "    def check(self):\n"
        "        return {'gap': check(0.25, self.limits['gap'])}\n")
    (pkg / "toyfam.py").write_text(
        "def read(name, ctx):\n    return 42.0 if name.endswith('.a') "
        "else None\n")
    monkeypatch.setattr(portbench.drivers, "__path__",
                        list(portbench.drivers.__path__) + [str(pkg)])
    monkeypatch.setattr(portbench.metrics, "__path__",
                        list(portbench.metrics.__path__) + [str(pkg)])
    bench["configs"].append({"name": "toy"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy",
                               "traffic": "toy_mix", "chips": 1})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "1/s",
                                "workloads": ["toy_cell"]})
    bench["per_layer"] += [
        {"name": "toyfam.a", "unit": "%", "workloads": ["toy_cell"]},
        {"name": "toyfam.b", "unit": "%", "workloads": ["toy_cell"]}]
    cell = spec.resolve(bench, "toy_cell", base=tmp_path)
    assert {m["name"] for m in cell["end_to_end"]} == {"toy_rate", "setup_s"}
    res = run.run_cell(cell, 5, 0.05, False, torch.device("cpu"))
    assert res["correct"] and res["metrics"]["toy_rate"]["value"] > 0
    res = run.run_cell(cell, 5, 0.05, True, torch.device("cpu"))
    assert res["metrics"] == {"toyfam.a": {"value": 42.0, "unit": "%"}}


def test_result_line_schema():
    res = run.run_cell(tiny.cell("crag_pixel_tile"), 3, 0.2, False,
                       torch.device("cpu"))
    assert list(res)[-1] == "checks"
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"slide_ms", "slide_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_line_schema():
    res = run.run_cell(tiny.cell("glas_predict"), 3, 0.1, True,
                       torch.device("cpu"))
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU trace has no device operations: no device metric is read
    assert "device_idle.predict" not in res["metrics"]
    assert "mfu.predict" in res["metrics"]


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "glas_predict", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "wesup_tpu_torch_x", types.ModuleType(
        "wesup_tpu_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib"]


@pytest.mark.parametrize("name", ["glas_predict", "crag_pixel_tile",
                                  "crag_train"])
def test_cells_have_limits(name):
    cell = spec.resolve(spec.load_benchmark(), name)
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    assert any(v > 0 for v in cell["limits"].values())
