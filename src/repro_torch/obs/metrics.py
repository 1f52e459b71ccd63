"""Process-local metrics: counters, gauges, histograms.

A copy of the JAX package's ``obs/metrics.py``: the port imports nothing
of that package.

Dependency-free (stdlib, plus numpy in the vectorized ``observe_many``
batch path). A ``Registry`` owns named metrics; metric updates are
thread-safe (one lock per metric family) and cheap enough for the
serving hot path: single observations bucket via C-speed ``bisect``, and
the serving loop records a whole micro-batch of latencies under one lock
with ``observe_many``. Two export surfaces:

  * ``Registry.to_prometheus()`` — the Prometheus text exposition format
    (``# HELP`` / ``# TYPE`` headers, ``_bucket``/``_sum``/``_count``
    histogram series with cumulative ``le`` labels), servable via
    ``serve_metrics()``'s stdlib HTTP endpoint;
  * ``Registry.snapshot()`` — a JSON-able dict of every family.

``REGISTRY`` is the process-global default; subsystems accept an
injectable registry for test isolation but fall back to it.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

# serving latencies land in 100us..10s; seconds, Prometheus-style ladder
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# power-of-two ladder for batch/bucket-size histograms
POW2_BUCKETS: Tuple[float, ...] = tuple(float(1 << i) for i in range(13))

LabelValues = Tuple[str, ...]


def _label_key(label_names: Sequence[str], labels: Dict[str, str]) -> LabelValues:
    if not labels:                     # hot-path: labelless metric
        if label_names:
            raise ValueError(f"expected labels {tuple(label_names)}, got ()")
        return ()
    if set(labels) != set(label_names):
        raise ValueError(
            f"expected labels {tuple(label_names)}, got {tuple(labels)}")
    return tuple(str(labels[k]) for k in label_names)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing count, optionally labelled."""

    kind = "counter"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def _series(self):
        with self._lock:
            return dict(self._values)


class Gauge(_Metric):
    """A value that can go up and down (queue depth, active threads)."""

    kind = "gauge"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[LabelValues, float] = {}
        self._fn = None

    def set_fn(self, fn) -> None:
        """Labelless callback gauge: ``fn()`` is evaluated at
        export/snapshot time, so the instrumented hot path pays nothing
        (the serving queue-depth idiom). Overrides stored values."""
        if self.label_names:
            raise ValueError("callback gauges must be labelless")
        self._fn = fn

    def set(self, value: float, **labels: str) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set_state(self, state: str, states: Sequence[str]) -> None:
        """One-hot enum gauge (the Prometheus state-set idiom): the
        current state's series reads 1, every other known state 0 — so a
        scrape always sees exactly one active state and dashboards can
        alert on e.g. ``service_health_state{state="down"} == 1``.
        Requires exactly one label naming the state dimension."""
        if len(self.label_names) != 1:
            raise ValueError("state gauges need exactly one label")
        name = self.label_names[0]
        with self._lock:
            for s in states:
                self._values[(str(s),)] = 1.0 if s == state else 0.0

    def value(self, **labels: str) -> float:
        if self._fn is not None and not labels:
            return float(self._fn())
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def _series(self):
        if self._fn is not None:
            try:
                return {(): float(self._fn())}
            except Exception:
                return {}
        with self._lock:
            return dict(self._values)


class Histogram(_Metric):
    """Fixed-boundary histogram (per-bucket counts + sum + count).

    Boundaries are upper bounds of non-cumulative bins; the export adds
    the implicit ``+Inf`` bucket and emits cumulative counts as
    Prometheus requires.
    """

    kind = "histogram"

    def __init__(self, name, help="", label_names=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b
        self._bucket_arr = np.asarray(b)       # searchsorted fast path
        self._counts: Dict[LabelValues, list] = {}
        self._sum: Dict[LabelValues, float] = {}
        self._n: Dict[LabelValues, int] = {}

    def _bins(self, key):
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = np.zeros(len(self.buckets) + 1,
                                                  dtype=np.int64)
            self._sum[key] = 0.0
            self._n[key] = 0
        return counts

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(self.label_names, labels)
        v = float(value)
        # bisect_left: index of the first bucket with v <= ub, or the
        # implicit +Inf bin at len(buckets) — C-speed, hot-path safe
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._bins(key)[i] += 1
            self._sum[key] += v
            self._n[key] += 1

    def observe_many(self, values: Iterable[float], **labels: str) -> None:
        """Record a batch of observations under one lock acquisition —
        the serving loop's per-micro-batch path. Vectorized (numpy
        searchsorted + bincount), so cost is ~flat in batch size."""
        key = _label_key(self.label_names, labels)
        vs = np.asarray(values if isinstance(values, np.ndarray)
                        else list(values), dtype=float)
        if vs.size == 0:
            return
        binc = np.bincount(np.searchsorted(self._bucket_arr, vs,
                                           side="left"),
                           minlength=len(self.buckets) + 1)
        total, n = float(vs.sum()), int(vs.size)
        with self._lock:
            counts = self._bins(key)
            counts += binc
            self._sum[key] += total
            self._n[key] += n

    def count(self, **labels: str) -> int:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._n.get(key, 0)

    def sum(self, **labels: str) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._sum.get(key, 0.0)

    def _series(self):
        with self._lock:
            return {k: {"counts": [int(c) for c in cs],
                        "sum": self._sum[k], "count": self._n[k]}
                    for k, cs in self._counts.items()}


class Registry:
    """Named metric families; get-or-create, never duplicate."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, label_names, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, label_names, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls) or m.label_names != tuple(label_names):
                raise ValueError(
                    f"metric {name!r} re-registered with a different "
                    f"type/labels")
            return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, label_names, buckets=buckets)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Drop all metric families (test isolation)."""
        with self._lock:
            self._metrics.clear()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able state of every family."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            series = m._series()
            if isinstance(m, Histogram):
                out["histograms"][m.name] = {
                    "buckets": list(m.buckets),
                    "series": {_fmt_labels(m.label_names, k) or "": v
                               for k, v in series.items()},
                }
            else:
                group = "counters" if isinstance(m, Counter) else "gauges"
                out[group][m.name] = {
                    _fmt_labels(m.label_names, k) or "": v
                    for k, v in series.items()}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            series = m._series()
            if isinstance(m, Histogram):
                for key, s in sorted(series.items()):
                    cum = 0
                    for ub, c in zip(m.buckets + (float("inf"),),
                                     s["counts"]):
                        cum += c
                        le = "+Inf" if ub == float("inf") else _fmt_num(ub)
                        lbl = _fmt_labels(m.label_names + ("le",),
                                          key + (le,))
                        lines.append(f"{m.name}_bucket{{{lbl}}} {cum}")
                    base = _fmt_labels(m.label_names, key)
                    brace = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}_sum{brace} {_fmt_num(s['sum'])}")
                    lines.append(f"{m.name}_count{brace} {s['count']}")
            else:
                for key, v in sorted(series.items()):
                    base = _fmt_labels(m.label_names, key)
                    brace = f"{{{base}}}" if base else ""
                    lines.append(f"{m.name}{brace} {_fmt_num(v)}")
        return "\n".join(lines) + "\n"


def _fmt_labels(names: Sequence[str], values: LabelValues) -> str:
    return ",".join(f'{n}="{v}"' for n, v in zip(names, values))


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v) == int(v) else repr(float(v))


# the process-global default registry
REGISTRY = Registry()


def serve_metrics(port: int = 0, registry: Optional[Registry] = None,
                  host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text) on a daemon thread.

    Returns the ``HTTPServer``; ``server.server_address[1]`` is the bound
    port (useful with ``port=0``), ``server.shutdown()`` stops it.
    """
    from http.server import BaseHTTPRequestHandler, HTTPServer

    reg = registry if registry is not None else REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = reg.to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # keep stdout clean
            pass

    server = HTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
