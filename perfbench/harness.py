"""The benchmark's shared machinery: finding a cell's files by name, the
timed window, the traced window's device trace, the checks against the
plain references, and the one-line result.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

    configs/<config>.json      sizes and dtype of a configuration
    traffic/<traffic>.json     a traffic mix: its driver and parameters
    workloads/<cell>.json      its configuration and traffic, the traced
                               window's length, the checks' limits
    drivers/<driver>.py        set-up, the timed window, the checks
    metrics/<metric>.py        ``read(ctx)`` of one per-layer metric
    roofline/<name>.py         operations and bytes counted from shapes

This module imports neither the program nor torch at import time.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no benchmark process may hold: JAX and the
# JAX package that the port was made from (compared whole: the port's own
# name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "repro")


# -- finding files by name ----------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE):
    return _load_module(base / "drivers" / f"{name}.py",
                        f"perfbench_driver_{name}")


def metric_reader(name: str, base: Path = HERE):
    return _load_module(base / "metrics" / f"{name}.py",
                        "perfbench_metric_" + name.replace(".", "_"))


def roofline(name: str, base: Path = HERE):
    return _load_module(base / "roofline" / f"{name}.py",
                        f"perfbench_roofline_{name}")


def peaks(base: Path = HERE) -> dict:
    return load_json(base / "roofline" / "h100.json")


@dataclasses.dataclass
class Cell:
    """One cell as a driver sees it: the workload file, its configuration's
    and its traffic's files, the run's seed and device, and whether the
    run is traced."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: str = "cuda"
    trace: bool = False
    base: Path = HERE       # the benchmark folder its files came from

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def cell(name: str, seed: int, device: str = "cuda", trace: bool = False,
         base: Path = HERE) -> Cell:
    wl = load_json(base / "workloads" / f"{name}.json")
    return Cell(name=name, workload=wl,
                config=load_json(base / "configs" / f"{wl['config']}.json"),
                traffic=load_json(base / "traffic" / f"{wl['traffic']}.json"),
                seed=int(seed), device=device, trace=trace, base=base)


def cell_metrics(bench: dict, name: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``name`` reports: those without ``workloads`` and those listing
    it."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


# the control's precision by the configuration's: the next one below
CONTROL = {"float32": "bfloat16", "bfloat16": "float8"}


def control_dtype(c: Cell):
    """The precision the control computes in, as a reference takes it: a
    torch dtype, or ``"float8"`` (projections in float8 e4m3)."""
    import torch

    low = CONTROL[c.config["dtype"]]
    return low if low == "float8" else getattr(torch, low)


# -- seeds ---------------------------------------------------------------------

def seed_words(seed: int, *salt: int) -> List[int]:
    """A seed of any size as a numpy ``SeedSequence`` entropy list."""
    return [int(seed) % (1 << 64), *salt]


def torch_seed(seed: int, salt: int = 0) -> int:
    """One 63-bit generator seed from ``seed`` and ``salt``."""
    import numpy as np

    return int(np.random.SeedSequence(seed_words(seed, salt))
               .generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


# -- the timed window ----------------------------------------------------------

def units_window(unit: Callable[[int], None], seconds: float):
    """Run whole units back to back until ``seconds`` have passed; the unit
    that crosses the line is finished. Each unit ends in a host read, so
    the host clock covers its device work. Returns (window s, units, each
    unit's s)."""
    t0 = last = time.perf_counter()
    each: List[float] = []
    while True:
        unit(len(each))
        now = time.perf_counter()
        each.append(now - last)
        last = now
        if now - t0 >= seconds:
            return now - t0, len(each), each


# -- the traced window's device trace ----------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host operators that say what the host was doing (launch calls say
# nothing more than that a launch was made)
HOST_CATS = ("cpu_op", "user_annotation")


def read_chrome_trace(path: str):
    """(device events, host events) of a torch.profiler Chrome trace, each
    a list of (start us, end us, name)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((a, b, e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((a, b, e.get("name", "")))
    dev.sort()
    host.sort()
    return dev, host


def busy_us(dev) -> float:
    """Length of the union of the device's intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(dev, t0: float, t1: float):
    """Idle intervals of the device between ``t0`` and ``t1`` (us)."""
    gaps, end = [], t0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
    if end < t1:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


def _innermost(host, t: float) -> str:
    """Name of the shortest host event that covers time ``t``."""
    import bisect

    i = bisect.bisect_right(host, (t, float("inf"), ""))
    best, best_len = "python, no operator", float("inf")
    # host events are sorted by start; look back over those that began
    # before t (a bounded window: operators nest only a few deep)
    for a, b, name in reversed(host[max(0, i - 16):i]):
        if a <= t < b and b - a < best_len:
            best, best_len = name, b - a
    return best


def breakdown(dev, host, t0: float, t1: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing at each gap's middle, in seconds."""
    ops: Dict[str, float] = {}
    for a, b, name in dev:
        ops[_short(name)] = ops.get(_short(name), 0.0) + (b - a) / 1e6
    idle: Dict[str, float] = {}
    for a, b in idle_gaps(dev, t0, t1):
        what = _short(_innermost(host, (a + b) / 2))
        idle[what] = idle.get(what, 0.0) + (b - a) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(ops)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}


def _short(name: str) -> str:
    """A kernel's name without its argument list and template noise."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def kernel_seconds(dev, needles: Sequence[str]) -> float:
    """Device seconds of the kernels whose names contain any needle."""
    return sum(b - a for a, b, name in dev
               if any(s in name for s in needles)) / 1e6


class Profile:
    """torch.profiler over the traced window, read back as intervals."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.dev = self.host = None
        self.window_us = (0.0, 0.0)

    def __enter__(self):
        self._prof.__enter__()
        self._mark = self._torch.profiler.record_function("perfbench.window")
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.dev, host = read_chrome_trace(path)
        finally:
            os.unlink(path)
        marks = [(a, b) for a, b, n in host if n == "perfbench.window"]
        self.host = [h for h in host if h[2] != "perfbench.window"]
        if not marks:
            raise RuntimeError("the profiler's trace lost the window mark")
        self.window_us = marks[0]
        # only what ran inside the window
        t0, t1 = self.window_us
        self.dev = [(max(a, t0), min(b, t1), n) for a, b, n in self.dev
                    if b > t0 and a < t1]
        return False

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_us(self.dev) / 1e6

    def breakdown(self) -> dict:
        return breakdown(self.dev, self.host, *self.window_us)


# -- spans ---------------------------------------------------------------------

def read_spans(path: str) -> List[dict]:
    """The span records of a JSONL span file."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                if rec.get("kind") == "span":
                    out.append(rec)
    return out


# -- checks --------------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes, and a
    value that is not a finite number fails."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel_gap(a, b, floor: float = 0.0) -> float:
    """max |a - b| / max(max |b|, floor), over whole arrays."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    scale = max(float(np.max(np.abs(b))) if b.size else 0.0, floor)
    if scale == 0.0:
        return float(np.max(np.abs(a - b))) if a.size else 0.0
    return float(np.max(np.abs(a - b))) / scale


def checks_line(checks: Sequence[Check]) -> dict:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


# -- the card ------------------------------------------------------------------

def card_info() -> dict:
    """Name and power limit of card 0 by nvidia-smi, or what is known."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        name, limit = [s.strip() for s in out[0].split(",")]
        return {"smi_name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.TimeoutExpired):
        return {"smi_name": None, "power_limit": None}


def banned_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is banned."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED})



# -- what a per-layer metric reads -------------------------------------------

class Window:
    """One window of a traced run: the driver's account of it (its length
    and the work it did), the program's spans and kernel launch counts
    over it, and, for the profiled window, its device trace."""

    def __init__(self, window: dict, spans: Sequence[dict] = (),
                 launches: Optional[dict] = None, profile=None):
        self.window = window
        self.work = window.get("work", {})
        self.window_s = window["window_s"]
        self.spans = list(spans)
        self.launches = launches or {}
        self.profile = profile

    def spans_named(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name]

    def kernel_s(self, *needles: str) -> float:
        return 0.0 if self.profile is None else kernel_seconds(
            self.profile.dev, needles)

    def idle_pct(self) -> Optional[float]:
        if self.profile is None or self.profile.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.profile.busy_s / self.profile.window_s)


class Context:
    """What a per-layer metric's ``read(ctx)`` gets from a traced run: the
    cell; ``main``, the window of ``--seconds`` with the program's spans
    on and no profiler, for what the host clock and the spans measure;
    ``traced``, the shorter window that follows under torch.profiler, for
    what the device trace measures (with its own spans and launch
    counts); the card's peaks; and the roofline counts by name."""

    def __init__(self, cell: Cell, main: Window,
                 traced: Optional[Window] = None, base: Path = HERE):
        self.cell = cell
        self.main = main
        self.traced = traced or Window({"window_s": 0.0})
        self.peaks = peaks(base)
        self._base = base

    def roofline(self, name: str):
        return roofline(name, self._base)
