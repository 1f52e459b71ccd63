"""Timed, nested tracing spans with per-trace ids, exported as JSONL.

The JAX package's ``obs/trace.py``, with what the card needs:

    with trace.span("engine.score", batch=32):
        ...

Spans nest via a thread-local stack: the first span on a thread roots a
new trace (fresh ``trace_id``); children inherit it and record their
parent's ``span_id``, so the JSONL stream reconstructs the tree. A root
can also be opened with an explicit ``trace_id`` (the serving loop tags
every batch's trace onto its responses). Each record has its start
(``start_s``, on ``time.perf_counter()``) beside its duration (``dur_s``),
so a span's self time and its place among its children can be computed.

While a torch.profiler records, each span is also a
``torch.profiler.record_function`` of its name: it lands in the profiler's
trace as a ``user_annotation`` on the kernels' clock. ``span(name,
device_time=True)`` also records a timing CUDA event on the current
stream at entry and at exit, when CUDA is initialised; the record gets
``dev_s``, the card's time between the two, when it is written out (the
exit event is waited for then, never inside the span).

An attribute may be a one-element tensor on the card (``moe.route``'s
``max_load``): it is read when the record is written out, never inside
the span, so it costs the path no host read.

Records are held in memory and written out in batches (``events.
JsonlSink.defer``): when the sink holds ``events.BUFFER``, on ``flush()``,
on ``configure(...)`` and at interpreter exit.

Export goes to the span sink: ``$REPRO_TRACE_FILE`` when set, else the
shared event sink (``events.py``), else nowhere. Disabled tracing costs
one ``None`` check per ``span()`` call — the serving hot path stays
unperturbed when observability is off (<2% is the budgeted regression;
a no-op singleton context manager keeps it far below that). torch is
read from ``sys.modules``, never imported here.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Optional

from . import events

ENV_VAR = "REPRO_TRACE_FILE"

_LOCAL = threading.local()
_LOCK = threading.Lock()
_SINK: Optional[events.JsonlSink] = None
_SINK_RESOLVED = False


def configure(path: Optional[str]) -> None:
    """Send spans to ``path`` (None: fall back to the event sink); the
    spans held so far are written to the sink they were recorded for."""
    global _SINK, _SINK_RESOLVED
    with _LOCK:
        shared = events.get_sink()
        if _SINK is not None:
            _SINK.close()
        elif shared is not None:
            shared.flush()
        _SINK = events.JsonlSink(path) if path else None
        _SINK_RESOLVED = path is not None


def _sink() -> Optional[events.JsonlSink]:
    global _SINK, _SINK_RESOLVED
    if not _SINK_RESOLVED:
        with _LOCK:
            if not _SINK_RESOLVED:
                path = os.environ.get(ENV_VAR)
                if path:
                    _SINK = events.JsonlSink(path)
                _SINK_RESOLVED = True
    if _SINK is not None:
        return _SINK
    return events.get_sink()


def enabled() -> bool:
    return _sink() is not None


def flush() -> None:
    """Write out the spans held for the current sink."""
    sink = _sink()
    if sink is not None:
        sink.flush()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


# ids: a random prefix drawn once a process (again in a forked child), then
# a count, so a span makes no system call for its ids (a ``getrandom`` a
# span slowed the finetunes' dispatch loop by ~3 % on an H100's host)
_PREFIX: Optional[str] = None
_IDS = itertools.count()


def _new_prefix() -> None:
    global _PREFIX
    _PREFIX = None


os.register_at_fork(after_in_child=_new_prefix)


def new_trace_id() -> str:
    """16 hex digits: this process's random prefix, then a count."""
    global _PREFIX
    if _PREFIX is None:
        _PREFIX = os.urandom(4).hex()
    return f"{_PREFIX}{next(_IDS) & 0xFFFFFFFF:08x}"


def current_trace_id() -> Optional[str]:
    st = _stack()
    return st[-1].trace_id if st else None


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _DeviceTime:
    """A span's entry and exit events on the card, read at write-out."""

    __slots__ = ("start", "end")

    def __init__(self, torch):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def ready(self) -> bool:
        return self.end.query()

    def finish(self, rec: dict) -> None:
        self.end.synchronize()
        rec["dev_s"] = self.start.elapsed_time(self.end) / 1e3


class Span:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "_t0", "_sink", "_device_time", "_dev", "_mark")

    def __init__(self, name: str, attrs: dict, sink: events.JsonlSink,
                 trace_id: Optional[str], device_time: bool = False):
        self.name = name
        self.attrs = attrs
        self._sink = sink
        st = _stack()
        parent = st[-1] if st else None
        self.parent_id = parent.span_id if parent else None
        self.trace_id = (trace_id or (parent.trace_id if parent else None)
                         or new_trace_id())
        self.span_id = new_trace_id()
        self._t0 = 0.0
        self._device_time = device_time
        self._dev = self._mark = None

    def set(self, **attrs):
        """Attach attributes mid-span (recorded at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        _stack().append(self)
        torch = sys.modules.get("torch")
        if torch is not None:
            if torch.autograd._profiler_enabled():
                self._mark = torch.profiler.record_function(self.name)
                self._mark.__enter__()
            if self._device_time and torch.cuda.is_initialized():
                self._dev = _DeviceTime(torch)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if self._dev is not None:
            self._dev.end.record()
        if self._mark is not None:
            self._mark.__exit__(exc_type, exc, tb)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        rec = {"ts": time.time(), "kind": "span", "name": self.name,
               "trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id, "start_s": self._t0,
               "dur_s": dur, "thread": threading.current_thread().name}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        self._sink.defer(rec, self._dev)
        return False


def span(name: str, trace_id: Optional[str] = None,
         device_time: bool = False, **attrs):
    """Open a timed span; returns a no-op when tracing is disabled.
    ``device_time`` also times the span's extent on the card."""
    sink = _sink()
    if sink is None:
        return _NOOP
    return Span(name, attrs, sink, trace_id, device_time)


def emit_span(name: str, dur_s: float, trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, **attrs) -> None:
    """Record an already-elapsed interval, ending now, as a span (no-op
    when disabled).

    For durations measured outside a ``with`` block — e.g. a request's
    queue wait, which has already passed by the time the batch forms.
    Inherits the enclosing span's trace/parent when not given explicitly.
    """
    sink = _sink()
    if sink is None:
        return
    st = _stack()
    parent = st[-1] if st else None
    rec = {"ts": time.time(), "kind": "span", "name": name,
           "trace_id": (trace_id or (parent.trace_id if parent else None)
                        or new_trace_id()),
           "span_id": new_trace_id(),
           "parent_id": parent_id or (parent.span_id if parent else None),
           "start_s": time.perf_counter() - float(dur_s),
           "dur_s": float(dur_s),
           "thread": threading.current_thread().name}
    if attrs:
        rec["attrs"] = attrs
    sink.defer(rec)
