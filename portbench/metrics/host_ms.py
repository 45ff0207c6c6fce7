"""``host_ms.<span>``: the host's milliseconds per unit inside one of the
program's spans over the traced stretch: the durations of the newest
tracing session's spans of that name on the main thread
(``wesup_tpu_torch.tracing.spans()``; the stretch's ``torch.profiler``
session is that session), summed, over the units the stretch completed.
A program without the tracer, or a stretch without the span, reads
nothing."""

from __future__ import annotations

import threading

# metric suffix -> the program's span
SPANS = {
    "stage_wait": "wesup.stage.wait",
    "train_step": "wesup.step.train",
    "predict_fill": "wesup.predict.fill",
    "predict_drain": "wesup.predict.drain",
    "tile_cut": "wesup.tile.cut",
    "tile_drain": "wesup.tile.drain",
    "tile_stitch": "wesup.tile.stitch",
}


def read(name, ctx):
    try:
        from wesup_tpu_torch import tracing
    except ImportError:
        return None
    span = SPANS[name.split(".", 1)[1]]
    main = threading.main_thread().ident
    ns = [s.end_ns - s.start_ns for s in tracing.spans()
          if s.name == span and s.thread == main and s.end_ns is not None]
    if not ns or ctx["traced_units"] <= 0:
        return None
    return 1e-6 * sum(ns) / ctx["traced_units"]
