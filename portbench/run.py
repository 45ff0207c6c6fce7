"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; the traffic file names the driver (``portbench/drivers``) whose
window is measured.  The run:

1. refuses to run (exit 2, no result) without enough CUDA devices;
2. sets up the driver (inputs and weights from ``--seed``, every shape
   the traffic uses warmed up) and reports that as ``setup_s``;
3. drives whole units of work (an epoch, a pass over a folder, a slide)
   back to back until ``--seconds`` have passed, and computes the
   end-to-end metrics over all of them and all of that time;
4. with ``--trace 1`` also traces a short stretch of units with
   ``torch.profiler`` and reports the per-layer metrics instead, read by
   ``portbench/metrics/<family>.py``;
5. reads the device's memory peak, frees the program's state and checks
   what the window produced against the plain reference
   (``portbench/reference``), printing every number compared beside its
   limit on standard error and under ``checks`` in the result line;
6. refuses to print a result (exit 3) if JAX or the JAX package was
   loaded.

Caches of the program's builds stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# build caches at fixed paths inside the checkout, before torch loads
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "wesup_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def end_to_end(metrics, traffic, stats, setup_s) -> dict:
    """The cell's end-to-end metrics from the window's counters: each
    metric's formula is named in the traffic file."""
    out = {}
    for m in metrics:
        kind = traffic["end_to_end"][m["name"]] if m["name"] != "setup_s" \
            else "setup"
        if kind == "setup":
            v = setup_s
        elif kind == "rate":
            v = stats["units"] / stats["seconds"]
        elif kind == "period_ms":
            v = 1e3 * stats["seconds"] / stats["units"]
        elif kind == "p95_ms":
            lat = stats["latencies"]
            v = 1e3 * (statistics.quantiles(lat, n=20)[18] if len(lat) > 1
                       else lat[0])
        else:
            raise ValueError(f"unknown end-to-end formula {kind!r}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def window(drv, seconds: float) -> dict:
    """Whole units back to back until ``seconds`` have passed."""
    units, lat, done = 0, [], []
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        n = drv.unit()
        units += n
        now = time.perf_counter()
        lat.append(now - t)
        done.append((now - start, n))
        if now - start >= seconds:
            break
    return {"units": units, "seconds": now - start, "latencies": lat,
            "done": done}


def host_probe() -> float:
    """Milliseconds of a fixed piece of pure-Python work: the host's
    speed at the time, printed beside the window's rate."""
    t = time.perf_counter()
    sum(i * i for i in range(300_000))
    return 1e3 * (time.perf_counter() - t)


def thirds(stats) -> list:
    """Units completed in each third of the window, per second."""
    third = stats["seconds"] / 3
    out = [0.0, 0.0, 0.0]
    for t, n in stats["done"]:
        out[min(2, int(t / third))] += n
    return [u / third for u in out]


def per_layer(metrics, drv, stats, device) -> tuple:
    """Trace a stretch of ``trace_units`` units and read each per-layer
    metric (those whose reader finds nothing are left out)."""
    from . import spec, trace

    n = int(drv.traffic.get("trace_units", 1))
    drv.reset_work()
    done = []
    events = trace.capture(lambda: done.extend(drv.unit() for _ in range(n)),
                           device)
    red = trace.reduce(events)
    ctx = {"trace": red, "traced_units": sum(done),
           "traced_work": drv.take_work(), "window": stats,
           "window_work": drv.window_work}
    out = {}
    for m in metrics:
        v = spec.metric_reader(m["name"])(m["name"], ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out, red


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device) -> dict:
    """One run of a resolved cell (``spec.resolve``) on ``device``: the
    result line's object, ``checks`` last."""
    import torch

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    drv = cell["driver"].Driver(cell["config"], cell["traffic"], seed,
                                device, cell["limits"])
    try:
        drv.setup()
        sync()
        setup_s = time.perf_counter() - T_START
        marks = [("imports", T_START)] + drv.phases
        print("setup " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
            file=sys.stderr)
        drv.reset_work()
        probe0 = host_probe()
        stats = window(drv, seconds)
        probe1 = host_probe()
        lat = sorted(stats["latencies"])
        print(f"window {stats['units']} units in {stats['seconds']:.3f} s; "
              f"unit s min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} "
              f"max {lat[-1]:.4f} over {len(lat)}; units/s by third "
              + " ".join(f"{r:.3f}" for r in thirds(stats))
              + f"; host probe ms {probe0:.2f} -> {probe1:.2f}",
              file=sys.stderr)
        drv.window_work = drv.take_work()
        if traced:
            metrics, red = per_layer(cell["per_layer"], drv, stats, device)
        else:
            metrics = end_to_end(cell["end_to_end"], cell["traffic"], stats,
                                 setup_s)
        sync()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        drv.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = drv.check()
    finally:
        drv.close()
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": int(cell["entry"]["chips"]),
            "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": info}
    if traced:
        info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = red["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
