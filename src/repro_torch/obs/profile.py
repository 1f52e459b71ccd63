"""Optional ``torch.profiler`` capture, gated by ``$REPRO_PROFILE_DIR``.

The PyTorch counterpart of the JAX package's ``obs/profile.py``:

    with profile.maybe_profile("serve"):
        ... scoring calls ...

When the env var is unset this is a no-op (one dict lookup). When set,
the block runs under ``torch.profiler.profile`` (the CPU, and the CUDA
device where there is one) and its Chrome trace is written to
``$REPRO_PROFILE_DIR/<name>/trace.json``; a ``profile.capture`` event
records where it landed. Profiler failures (a profiler that will not
start, a concurrent capture, a trace that cannot be written) degrade to a
``profile.error`` event, never an exception — a profiling flag must not
take down the run it profiles.
"""
from __future__ import annotations

import contextlib
import os
import re

from . import events

ENV_VAR = "REPRO_PROFILE_DIR"
TRACE_FILE = "trace.json"


def profile_dir():
    return os.environ.get(ENV_VAR) or None


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-/]", "_", name).strip("/")


@contextlib.contextmanager
def maybe_profile(name: str):
    """Profile the block iff ``$REPRO_PROFILE_DIR`` is set."""
    base = profile_dir()
    if not base:
        yield
        return
    target = os.path.join(base, _safe(name))
    try:
        import torch
        from torch.profiler import ProfilerActivity

        os.makedirs(target, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:   # profiler unavailable: degrade, don't die
        events.emit("profile.error", name=name, error=repr(e))
        yield
        return
    try:
        yield
    finally:
        path = os.path.join(target, TRACE_FILE)
        try:
            prof.stop()
            prof.export_chrome_trace(path)
        except Exception as e:   # the block's own outcome stands
            events.emit("profile.error", name=name, error=repr(e))
        else:
            events.emit("profile.capture", name=name, dir=target, file=path)
