"""Aggregate a ``torch.profiler`` trace into a per-op time table.

Port of ``scripts/profile_ops.py``, which read the ``xplane.pb`` of
``jax.profiler``.  This one reads the Chrome trace that
``torch.profiler``'s ``export_chrome_trace`` writes (JSON, with the
standard library: no protobuf, no tensorflow) and prints:

- the device kernels summed by name: ms/step (total over ``n_steps``),
  launches and share of the device time, the top ``top_n``;
- the device's busy and idle share over the traced window, from the first
  kernel's start to the last one's end (busy: the union of the kernels'
  intervals);
- the longest idle gaps between kernels, each with the host op that was
  running when it began (the innermost ``cpu_op`` or annotation around
  its start).

A trace taken on the CPU has no device kernels; the table then sums the
CPU ops (``cpu_op``) in their place and its header says so: that is the
tool's input on the CPU, not a fallback of the device.  The program's
spans (``wesup.*``, ``wesup_tpu_torch/tracing.py``) are CPU ranges
around the ops, not ops: the table leaves them out, the idle gaps name
them.

The same functions take a profiler object still in memory
(:func:`events_from_profiler`), so that ``chip_smoke.py``'s busy shares
and top-kernel lines come from this code.

Usage:
    python -m wesup_tpu_torch.scripts.profile_ops <logdir|trace.json>
        [n_steps] [top_n]

``<logdir>`` is a directory holding traces (the newest ``*.json`` is
read, as the JAX tool reads the newest ``xplane.pb``) or a trace file.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

KERNEL = "kernel"
HOST = ("cpu_op", "user_annotation")
SPANS = "wesup."       # the program's spans' names


def load_trace(path) -> list:
    """The events (dicts with ``name``, ``cat``, ``ts``, ``dur`` in us) of
    a Chrome trace file, or of the newest ``*.json`` under a directory."""
    path = Path(path)
    if path.is_dir():
        traces = sorted(path.rglob("*.json"), key=lambda p: p.stat().st_mtime)
        if not traces:
            raise SystemExit(f"no trace (*.json) under {path}")
        path = traces[-1]
    with open(path) as fp:
        doc = json.load(fp)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def events_from_profiler(prof) -> list:
    """The events of a finished ``torch.profiler.profile`` in the trace's
    form: device kernels as ``kernel``, host ops as ``cpu_op``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        cat = KERNEL if e.device_type == DeviceType.CUDA else "cpu_op"
        out.append({"name": e.name, "cat": cat, "ts": start,
                    "dur": end - start})
    return out


def device_events(events) -> tuple:
    """(events, source): the device kernels, or, when the trace holds
    none (a CPU run), the top-level CPU ops, with ``source`` saying
    which."""
    kern = [e for e in events if e.get("cat") == KERNEL]
    if kern:
        return kern, "device kernels"
    return _outermost([e for e in events if e.get("cat") == "cpu_op"
                       and not e["name"].startswith(SPANS)]), \
        "CPU ops (the trace has no device kernels)"


def _outermost(events) -> list:
    """The events that no earlier event of the list contains."""
    out, end = [], float("-inf")
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] + e["dur"] > end:
            out.append(e)
            end = e["ts"] + e["dur"]
    return out


def _intervals(events) -> list:
    """The union of the events' [ts, ts + dur) intervals, sorted."""
    merged = []
    for e in sorted(events, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_share(events) -> tuple:
    """(count, busy us, span us) of ``events``: the span runs from the
    first one's start to the last one's end; busy is the union of their
    intervals (the sum of their durations where none overlap)."""
    if not events:
        return 0, 0.0, 0.0
    merged = _intervals(events)
    busy = sum(b - a for a, b in merged)
    return len(events), float(busy), float(merged[-1][1] - merged[0][0])


def op_table(events) -> dict:
    """{name: [total us, count]}, largest total first."""
    table = {}
    for e in events:
        row = table.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    return dict(sorted(table.items(), key=lambda kv: -kv[1][0]))


def idle_gaps(kernels, host, top=5) -> list:
    """The ``top`` longest gaps between the kernels' busy intervals:
    (gap us, its start in us after the first kernel's, the name of the
    innermost host op that contains its start, or ``"-"``)."""
    merged = _intervals(kernels)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:top]
    out = []
    for gap, t in gaps:
        around = [e for e in host if e["ts"] <= t < e["ts"] + e["dur"]]
        inner = max(around, key=lambda e: e["ts"])["name"] if around else "-"
        out.append((float(gap), float(t - merged[0][0]), inner))
    return out


def profile(run, n=5, cuda=True, path=None) -> list:
    """The events of ``n`` calls of ``run`` under ``torch.profiler``,
    after one call outside it, the device drained before and after (host
    work under the profiler is slower than without it, so the idle share
    it gives is an upper bound).  With ``path`` the trace is written there
    as a Chrome trace and the events are read back from it."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run()
    sync()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        for _ in range(n):
            run()
        sync()
    if path is None:
        return events_from_profiler(prof)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return load_trace(path)


def report(events, n_steps=1, top_n=30, gaps=5) -> list:
    """The printed table's lines."""
    n_steps = max(1, n_steps)
    dev, source = device_events(events)
    lines = []
    if not dev:
        return [f"no events in the trace: {source}"]
    table = op_table(dev)
    grand = sum(v[0] for v in table.values())
    count, busy, span = busy_share(dev)
    lines.append(f"total {source} time: {grand / 1e3 / n_steps:.3f} ms/step "
                 f"({len(table)} distinct ops, {count / n_steps:.0f} "
                 "launches/step)")
    for name, (us, n) in list(table.items())[:top_n]:
        lines.append(f"{us / 1e3 / n_steps:8.3f} ms  {n / n_steps:7.1f}x  "
                     f"{100.0 * us / grand:5.1f}%  {name[:100]}")
    lines.append(f"busy {busy / 1e3 / n_steps:.3f} ms/step of a "
                 f"{span / 1e3 / n_steps:.3f} ms/step span: busy share "
                 f"{busy / span if span else 0.0:.3f}, idle share "
                 f"{1 - busy / span if span else 0.0:.3f}")
    if source == "device kernels":
        host = [e for e in events if e.get("cat") in HOST]
        for gap, t, name in idle_gaps(dev, host, gaps):
            lines.append(f"idle gap {gap / 1e3:8.3f} ms at +{t / 1e3:.3f} ms "
                         f"during {name[:90]}")
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    n_steps = int(argv[1]) if len(argv) > 1 else 1
    top_n = int(argv[2]) if len(argv) > 2 else 30
    for line in report(load_trace(argv[0]), n_steps, top_n):
        print(line)


if __name__ == "__main__":
    main()
