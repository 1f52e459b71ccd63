"""JSONL event sink — the durable half of the telemetry subsystem.

A copy of the JAX package's ``obs/events.py``.

One event per line: ``{"ts": <unix seconds>, "kind": "<dotted.name>",
...fields}``. Spans (``trace.py``), solver iterations (``solver.py``),
engine compile events, and the runtime env snapshot all flow through
here, so a single file replays a run end to end.

Disabled by default and free when disabled: ``emit()`` is a ``None``
check. Enable by pointing ``$REPRO_EVENTS_FILE`` at a path before import
(or any time, via ``configure(path)``); ``configure(None)`` turns it
back off. Writes are line-buffered and serialized under a lock, so
concurrent emitters (the serving threads) never interleave partial
lines.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import IO, Optional

ENV_VAR = "REPRO_EVENTS_FILE"


class JsonlSink:
    """Append-only, thread-safe JSONL writer."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: IO[str] = open(path, "a")
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _jsonable(o):
    """Last-resort coercion so numpy scalars etc. never kill an emit."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


_LOCK = threading.Lock()
_SINK: Optional[JsonlSink] = None
_ENV_CHECKED = False


def configure(path: Optional[str]) -> Optional[JsonlSink]:
    """Point the global sink at ``path`` (None disables)."""
    global _SINK, _ENV_CHECKED
    with _LOCK:
        if _SINK is not None:
            _SINK.close()
        _SINK = JsonlSink(path) if path else None
        _ENV_CHECKED = True   # explicit configure wins over the env var
        return _SINK


def get_sink() -> Optional[JsonlSink]:
    """The global sink, lazily picking up ``$REPRO_EVENTS_FILE`` once."""
    global _SINK, _ENV_CHECKED
    if _SINK is None and not _ENV_CHECKED:
        with _LOCK:
            if _SINK is None and not _ENV_CHECKED:
                path = os.environ.get(ENV_VAR)
                if path:
                    _SINK = JsonlSink(path)
                _ENV_CHECKED = True
    return _SINK


def emit(kind: str, **fields) -> None:
    """Emit one event to the global sink; no-op when disabled."""
    sink = get_sink()
    if sink is not None:
        sink.emit(kind, **fields)


def enabled() -> bool:
    return get_sink() is not None


def read_jsonl(path: str):
    """Parse a JSONL file, skipping blank/corrupt lines (analysis helper)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
