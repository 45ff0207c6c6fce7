"""Spans and counters of the port.

A span is one piece of work at a layer boundary: its name, the span that
encloses it on the same thread (``parent``), a trace id shared by every
span of one unit of work, its thread, and its start and end.  A unit's
root span names its trace id, namespaced by the kind of unit (a training
batch's ``("train", epoch, i)``, a validation batch's ``("val", epoch,
i)``, an inference chunk's ``("chunk", group, start)``); a span given
none takes its parent's, and a root given none starts a trace of its own,
``(name, n)``.  A span's self time is its duration less its children's.

Spans are recorded exactly while a torch profiler records: a
``torch.profiler`` session (:func:`profiled` writes one as a Chrome
trace), or ``torch.autograd.profiler.emit_itt``, which records no op and
so slows the host least.
:func:`span` then keeps each span in memory and, on the thread the
profiler follows, mirrors it as a profiler range of its name (a
``RecordFunction`` recorded as a CPU op; ``record_function``'s user
annotations would have device-side twins, which a device trace counts as
device work), so that it lies on the device trace's timeline; there a
step's span and its phases' (``wesup.step.*``) also record, on a CUDA
device, a CUDA event pair on the current stream around them (read, with a
synchronisation, only when :attr:`Span.device_ms` is asked for).  On
other threads (the trainer's staging worker) spans are kept in memory
only.  With the profiler off, :func:`span` reads one flag and returns a
shared no-op context: nothing is recorded and no ``RecordFunction`` is
entered.  A session begins at the first span that finds the profiler on
after a span or a reader (:func:`spans`) found it off; :func:`spans`
returns the spans of the newest session until the next one begins.

The clock is ``time.time_ns()``.  The profiler converts its own clock to
Unix nanoseconds, so a span's interval holds its mirror's within a few
microseconds: the start is read before the mirror opens, the end after it
closes (the first mirror on a thread in each session is preceded by a
throwaway ``wesup.session`` range, which takes the profiler's first-call
cost).

Counters are always on, plain integer adds (:func:`count`): each CUDA
kernel's launches (``launches.<kernel>``, counted by
``ops.kernels.launch`` and read as ``ops.launch_counts()``).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_counters: dict = {}
_spans: list = []
_on = False      # whether the newest span or reader found the profiler on
_session = 0
_session_lock = threading.Lock()
_local = threading.local()
_trace_ids = itertools.count()
# the spans that time the device: a step and its phases
DEVICE_SPANS = "wesup.step."


class Span:
    """One recorded span; times are Unix nanoseconds (the profiler's
    clock), ``end_ns`` is None while it is open."""

    __slots__ = ("name", "trace", "parent", "thread", "start_ns", "end_ns",
                 "child_ns", "_mirror", "_events")

    def __init__(self, name: str, trace):
        self.name = name
        self.trace = trace
        self.parent = None
        self.thread = None
        self.start_ns = self.end_ns = None
        self.child_ns = 0
        self._mirror = self._events = None

    @property
    def duration_ns(self) -> int | None:
        if self.end_ns is None:
            return None
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int | None:
        """The duration less the children's (on the same thread)."""
        d = self.duration_ns
        return None if d is None else d - self.child_ns

    @property
    def device_ms(self) -> float | None:
        """Milliseconds of the current stream between the span's CUDA
        events (waits for the second); None without events."""
        if self._events is None or self.end_ns is None:
            return None
        first, last = self._events
        last.synchronize()
        return first.elapsed_time(last)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.trace is None:
            self.trace = (parent.trace if parent is not None
                          else (self.name, next(_trace_ids)))
        self.thread = threading.get_ident()
        # the profiler follows this thread (it started there)
        followed = torch._C._autograd._profiler_enabled()
        if followed:
            if getattr(_local, "warm", None) != _session:
                _local.warm = _session
                with _RecordFunctionFast("wesup.session"):
                    pass
            self._mirror = _RecordFunctionFast(self.name)
        self.start_ns = time.time_ns()
        if followed:
            self._mirror.__enter__()
            if (self.name.startswith(DEVICE_SPANS)
                    and torch.cuda.is_initialized()):
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        stack.append(self)
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        self.end_ns = time.time_ns()
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end_ns - self.start_ns
        return False

    def __call__(self, func):
        return _decorate(self.name, func)

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace!r}, "
                f"duration_ns={self.duration_ns})")


class _Off:
    """The no-op context of a span while the profiler is off."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, func):
        return _decorate(self.name, func)


_OFF: dict = {}      # the shared no-op context of each name


def _off(name: str) -> _Off:
    return _OFF.setdefault(name, _Off(name))


def _decorate(name: str, func):
    @functools.wraps(func)
    def traced(*args, **kwargs):
        with span(name):
            return func(*args, **kwargs)
    return traced


def _begin_session() -> None:
    global _on, _spans, _session
    with _session_lock:
        if not _on:
            _spans = []
            _session += 1
            _on = True


def span(name: str, trace=None):
    """A context manager (or decorator) that records ``name`` as a span
    while a profiler records; ``trace`` is the unit's trace id (default:
    the parent's)."""
    global _on
    if not _profiler._is_profiler_enabled:
        _on = False
        return _OFF.get(name) or _off(name)
    if not _on:
        _begin_session()
    return Span(name, trace)


def profiled(run, path, device):
    """``run()`` under a ``torch.profiler`` session (the CPU, and the card
    where ``device`` is one), its spans and device operations written to
    ``path`` as a Chrome trace; returns what ``run()`` returns."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = run()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return out


def spans() -> list:
    """The spans of the newest profiling session, in the order they
    began; read with the profiler off, it ends the session."""
    global _on
    if not _profiler._is_profiler_enabled:
        _on = False
    return list(_spans)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """Every counter's value."""
    return dict(_counters)


def reset(names) -> None:
    """Set the counters ``names`` to 0."""
    for name in names:
        _counters.pop(name, None)
