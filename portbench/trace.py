"""The device trace of a short stretch of work, reduced to numbers.

The arithmetic is ``wesup_tpu_torch/scripts/profile_ops.py``'s, copied
(busy time as the union of the device operations' intervals, idle gaps
with the innermost host op running at their start), with one change: the
window is the wall-clock stretch itself (a ``record_function`` around
it, which ends after the device has drained), not the span from the
first kernel to the last, so idle time at either end counts.
"""

from __future__ import annotations

STRETCH = "portbench.stretch"
# host calls that put work on the device's queue
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def capture(run, device):
    """``run()`` under ``torch.profiler`` (CPU and, on a card, CUDA
    activities), the device drained inside the traced stretch; returns
    the events as dicts with ``name``, ``dev`` (True for device
    operations), ``ts`` and ``dur`` in microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            run()
            sync()
    out = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        out.append({"name": e.name, "dev": e.device_type == DeviceType.CUDA,
                    "ts": float(start), "dur": float(end - start)})
    return out


def _intervals(spans) -> list:
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events, top: int = 10) -> dict:
    """``window_s``, ``busy_s``, ``launches``, the device time of each
    operation by name (``op_s``), the top device operations and the
    longest idle gaps with the host op at their start."""
    marks = [e for e in events if not e["dev"] and e["name"] == STRETCH]
    if not marks:
        raise ValueError("the trace has no stretch annotation")
    w0 = marks[0]["ts"]
    w1 = w0 + marks[0]["dur"]
    # the stretch's annotation has a device-side twin: not an operation
    dev = [e for e in events if e["dev"] and e["name"] != STRETCH]
    spans = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    merged = _intervals([s for s in spans if s[1] > s[0]])
    busy = sum(b - a for a, b in merged)
    ops = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] * 1e-6
    host = [e for e in events if not e["dev"] and e["name"] != STRETCH]
    launches = sum(1 for e in host if e["name"] in LAUNCHES
                   and w0 <= e["ts"] <= w1)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    idle = []
    for gap, t in gaps:
        around = [e for e in host if e["ts"] <= t < e["ts"] + e["dur"]]
        name = max(around, key=lambda e: e["ts"])["name"] if around else "-"
        idle.append([name, gap * 1e-6])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "launches": launches, "op_s": ops,
            "breakdown": {"device_ops": [[k, v] for k, v in top_ops],
                          "idle_gaps": idle}}
