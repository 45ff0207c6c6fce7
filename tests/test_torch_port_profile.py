"""The port's profiling tools on the CPU.

- ``profile_ops`` on a hand-written Chrome trace whose kernels, overlaps
  and gaps are known: the per-name table, the busy and idle shares and
  the longest gaps (with the host op around each) equal the counts made
  by hand; on a trace that ``torch.profiler`` writes on the CPU it sums
  the top-level CPU ops and says so in its header;
- ``profile_train_step`` in train, predict and pixel modes and
  ``WESUP_PROF_SCAN=1``, and ``profile_epoch``, at a tiny size on the CPU:
  their tables, launch lines and JSON (with the JAX tools' keys).
"""

import json
import sys
import threading
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from torch_threads import worker_threads  # noqa: E402,F401
from wesup_tpu_torch.scripts import (profile_epoch, profile_ops,  # noqa: E402
                                     profile_train_step)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


# two steps of kernels on a 1000 us window: "gemm" 3 launches of 100 us,
# "relu" 2 of 50 us, one "copy" of 200 us overlapping the second gemm by
# 50 us; busy = 100 + 250 + 100 + 50 + 50 = 550 us (the union), span
# 0..1000 us; gaps (us): 100-200 (100), 450-600 (150), 700-800 (100),
# 850-950 (100)
KERNELS = [("gemm", 0, 100), ("copy", 200, 200), ("gemm", 350, 100),
           ("gemm", 600, 100), ("relu", 800, 50), ("relu", 950, 50)]
HOST = [("aten::step", 0, 1000), ("aten::mm", 420, 100),
        ("aten::slic", 590, 5)]


@pytest.fixture
def trace(tmp_path):
    events = ([_ev(n, "kernel", t, d) for n, t, d in KERNELS]
              + [_ev(n, "cpu_op", t, d) for n, t, d in HOST]
              + [{"ph": "i", "name": "marker", "ts": 5}])
    path = tmp_path / "logdir" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_report_of_a_known_trace(trace, capsys):
    events = profile_ops.load_trace(trace.parent)
    kern, source = profile_ops.device_events(events)
    assert source == "device kernels" and len(kern) == 6
    assert profile_ops.op_table(kern) == {
        "gemm": [300.0, 3], "copy": [200.0, 1], "relu": [100.0, 2]}
    assert profile_ops.busy_share(kern) == (6, 550.0, 1000.0)
    host = [e for e in events if e["cat"] == "cpu_op"]
    assert profile_ops.idle_gaps(kern, host, 3) == [
        (150.0, 450.0, "aten::mm"), (100.0, 850.0, "aten::step"),
        (100.0, 700.0, "aten::step")]
    profile_ops.main([str(trace.parent), "2", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("total device kernels time: 0.300 ms/step (3 "
                        "distinct ops, 3 launches/step)")
    assert lines[1] == "   0.150 ms      1.5x   50.0%  gemm"
    assert lines[2] == "   0.100 ms      0.5x   33.3%  copy"
    assert lines[3] == ("busy 0.275 ms/step of a 0.500 ms/step span: busy "
                        "share 0.550, idle share 0.450")
    assert lines[4].startswith("idle gap    0.150 ms at +0.450 ms during "
                               "aten::mm")
    assert len(lines) == 4 + 5 - 1   # 4 gaps between 5 busy intervals


def test_a_cpu_trace_sums_the_cpu_ops(tmp_path, capsys):
    x = torch.randn(64, 64)
    events = profile_ops.profile(lambda: torch.relu(x @ x).sum(), n=3,
                                 cuda=False, path=tmp_path / "t.json")
    kern, source = profile_ops.device_events(events)
    assert source.startswith("CPU ops") and kern
    names = set(profile_ops.op_table(kern))
    assert {"aten::matmul", "aten::relu", "aten::sum"} <= names
    # only the outermost ops: aten::mm runs inside aten::matmul
    assert "aten::mm" not in names
    profile_ops.main([str(tmp_path / "t.json"), "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("total CPU ops (the trace has no device "
                             "kernels) time:")
    assert out[-1].startswith("busy ") and "idle share" in out[-1]


@pytest.mark.parametrize("mode", ["train", "predict", "pixel"])
def test_profile_train_step_on_cpu(mode, monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("WESUP_PROF_MODE", mode)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    out = profile_train_step.main(["1", "32", "64", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"{mode.upper()} B=1 32x64:"
    assert lines[1].startswith("total CPU ops (the trace has no device "
                               "kernels) time:")
    assert lines[-2].startswith("busy ")
    assert lines[-1] == ("launches/step: K1 0, K2 0, K3 0, K4 0, K5 0, "
                         "K5-bwd 0, K6 0, K7 0, K8 0")
    assert len(lines) == 1 + 1 + 5 + 1 + 1
    assert Path(out["trace"]).is_file() and out["ms"] > 0


def test_profile_train_step_scan_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("WESUP_PROF_SCAN", "1")
    monkeypatch.setenv("WESUP_PROF_STEPS", "3")
    monkeypatch.setenv("WESUP_PROF_MODE", "predict")
    out = profile_train_step.main(["2", "32", "32", "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("TIMED predict step: ") and "(median of 3)" in line
    assert out["ms"] > 0


def test_profile_epoch_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    report = profile_epoch.profile(2, 2, 4, "fixed", "both", "auto", "cpu",
                                   hw=(64, 80), canvas=(64, 96))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(report))
    assert set(report) == {"batch", "n_images", "mode", "resize", "epochs",
                           "step_only", "wall_over_step"}
    assert [(e["epoch"], e["loop"]) for e in report["epochs"]] == [
        (1, "instrument"), (1, "pipeline"), (2, "instrument"),
        (2, "pipeline")]
    inst = report["epochs"][2]
    assert {"wait_host", "rng", "put", "dispatch", "drain", "batches",
            "wall_s", "img_per_s", "rng_ms_per_batch"} <= set(inst)
    assert inst["batches"] == 2 and inst["rng"] > 0
    assert report["step_only"]["canvas"] == [64, 96]
    assert (tmp_path / "wesup_glas85" / "4_64x80" / ".complete").exists()
    # the production loop's last pre-warmed staging chain is cancelled
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(("wesup-stage-", "wesup-loader-"))]
