"""Timed, nested tracing spans with per-trace ids, exported as JSONL.

A copy of the JAX package's ``obs/trace.py``.

    with trace.span("engine.score", batch=32):
        ...

Spans nest via a thread-local stack: the first span on a thread roots a
new trace (fresh ``trace_id``); children inherit it and record their
parent's ``span_id``, so the JSONL stream reconstructs the tree. A root
can also be opened with an explicit ``trace_id`` (the serving loop tags
every batch's trace onto its responses).

Export goes to the span sink: ``$REPRO_TRACE_FILE`` when set, else the
shared event sink (``events.py``), else nowhere. Disabled tracing costs
one ``None`` check per ``span()`` call — the serving hot path stays
unperturbed when observability is off (<2% is the budgeted regression;
a no-op singleton context manager keeps it far below that).
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

from . import events

ENV_VAR = "REPRO_TRACE_FILE"

_LOCAL = threading.local()
_LOCK = threading.Lock()
_SINK: Optional[events.JsonlSink] = None
_SINK_RESOLVED = False


def configure(path: Optional[str]) -> None:
    """Send spans to ``path`` (None: fall back to the event sink)."""
    global _SINK, _SINK_RESOLVED
    with _LOCK:
        if _SINK is not None:
            _SINK.close()
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


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


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


class Span:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "_t0", "_sink")

    def __init__(self, name: str, attrs: dict, sink: events.JsonlSink,
                 trace_id: Optional[str]):
        self.name = name
        self.attrs = attrs
        self._sink = sink
        st = _stack()
        parent = st[-1] if st else None
        self.parent_id = parent.span_id if parent else None
        self.trace_id = (trace_id or (parent.trace_id if parent else None)
                         or new_trace_id())
        self.span_id = uuid.uuid4().hex[:16]
        self._t0 = 0.0

    def set(self, **attrs):
        """Attach attributes mid-span (recorded at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        _stack().append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        rec = {"name": self.name, "trace_id": self.trace_id,
               "span_id": self.span_id, "parent_id": self.parent_id,
               "dur_s": dur, "thread": threading.current_thread().name}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        self._sink.emit("span", **rec)
        return False


def span(name: str, trace_id: Optional[str] = None, **attrs):
    """Open a timed span; returns a no-op when tracing is disabled."""
    sink = _sink()
    if sink is None:
        return _NOOP
    return Span(name, attrs, sink, trace_id)


def emit_span(name: str, dur_s: float, trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, **attrs) -> None:
    """Record an already-elapsed interval as a span (no-op when disabled).

    For durations measured outside a ``with`` block — e.g. a request's
    queue wait, which has already passed by the time the batch forms.
    Inherits the enclosing span's trace/parent when not given explicitly.
    """
    sink = _sink()
    if sink is None:
        return
    st = _stack()
    parent = st[-1] if st else None
    rec = {"name": name,
           "trace_id": (trace_id or (parent.trace_id if parent else None)
                        or new_trace_id()),
           "span_id": uuid.uuid4().hex[:16],
           "parent_id": parent_id or (parent.span_id if parent else None),
           "dur_s": float(dur_s),
           "thread": threading.current_thread().name}
    if attrs:
        rec["attrs"] = attrs
    sink.emit("span", **rec)
