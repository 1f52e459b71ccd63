"""JSONL event sink — the durable half of the telemetry subsystem.

A copy of the JAX package's ``obs/events.py``.

One event per line: ``{"ts": <unix seconds>, "kind": "<dotted.name>",
...fields}``. Spans (``trace.py``), solver iterations (``solver.py``),
engine compile events, and the runtime env snapshot all flow through
here, so a single file replays a run end to end.

Disabled by default and free when disabled: ``emit()`` is a ``None``
check. Enable by pointing ``$REPRO_EVENTS_FILE`` at a path before import
(or any time, via ``configure(path)``); ``configure(None)`` turns it
back off. Writes are serialized under a lock, so concurrent emitters
(the serving threads) never interleave partial lines. ``emit`` writes
its line at once; spans are held in memory (``JsonlSink.defer``) and
written in batches, so a file holds every span only once its sink is
flushed or closed.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time
import weakref
from typing import IO, Optional

ENV_VAR = "REPRO_EVENTS_FILE"
# records a sink holds before ``defer`` writes them out
BUFFER = 4096


class JsonlSink:
    """Append-only, thread-safe JSONL writer.

    ``emit`` writes one line at once. ``defer`` holds a finished record in
    memory; ``flush`` writes the held records in one locked write, and
    runs when ``BUFFER`` are held (only those whose ``pending`` is ready,
    unless twice that many are held), on ``close`` and at interpreter
    exit. A record's ``pending``, when given, has ``ready()`` and
    ``finish(rec)``, which completes the record just before it is written
    (a span's device time, ``trace.py``)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: IO[str] = open(path, "a")
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._held: collections.deque = collections.deque()
        _OPEN.add(self)

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update(fields)
        line = _ENCODE(rec)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def defer(self, rec: dict, pending=None) -> None:
        """Hold ``rec`` (its ``ts`` and ``kind`` set) for the next flush."""
        self._held.append((rec, pending))
        if len(self._held) >= BUFFER:
            self.flush(wait=len(self._held) >= 2 * BUFFER)

    def flush(self, wait: bool = True) -> None:
        """Write the held records; with ``wait`` False, only those up to
        the first whose ``pending`` is not ready yet."""
        with self._flush_lock:
            out = []
            while self._held:
                rec, pending = self._held[0]
                if pending is not None:
                    if not wait and not pending.ready():
                        break
                    pending.finish(rec)
                self._held.popleft()
                out.append(_ENCODE(rec))
            if not out:
                return
            with self._lock:
                if not self._f.closed:
                    self._f.write("\n".join(out) + "\n")
                    self._f.flush()

    def close(self) -> None:
        self.flush()
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _jsonable(o):
    """Last-resort coercion so numpy scalars etc. never kill an emit; a
    torch tensor of one element (a span attribute left on the card) is
    read here, when its record is written out."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(o, torch.Tensor):
        return o.item()
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


_ENCODE = json.JSONEncoder(default=_jsonable).encode

# every sink made, for the flush at exit and the drop after a fork
_OPEN: "weakref.WeakSet[JsonlSink]" = weakref.WeakSet()


def _flush_open() -> None:
    for sink in list(_OPEN):
        sink.flush()


def _drop_held() -> None:
    """A forked child writes none of its parent's held records."""
    for sink in list(_OPEN):
        sink._held.clear()


atexit.register(_flush_open)
os.register_at_fork(after_in_child=_drop_held)

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
