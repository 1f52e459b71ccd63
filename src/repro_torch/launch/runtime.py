"""Runtime launch policy: environment defaults and a snapshot of the
runtime a run used.

The PyTorch port's counterpart of the JAX package's ``launch/runtime.py``.
``apply()`` setdefaults the policy into ``os.environ`` (a tcmalloc
``LD_PRELOAD`` must come from the shell that starts the process; ``apply``
only reports whether one is available). ``describe()`` and ``log()`` record
the effective environment, so every benchmark is attributable to a
concrete runtime configuration.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)

ENV_DEFAULTS: Dict[str, str] = {
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

# large-n scale-out knobs: how many data shards the scoring engine spreads
# a batch over (0 = auto: one shard per local card), and the row count of
# one streaming-fit chunk (the working-set bound of fit_stream)
DATA_SHARDS_ENV = "REPRO_DATA_SHARDS"
STREAM_CHUNK_ENV = "REPRO_STREAM_CHUNK"
STREAM_CHUNK_DEFAULT = 65536


def data_shards() -> int:
    """``$REPRO_DATA_SHARDS`` as an int; 0 means auto (per card)."""
    try:
        return max(int(os.environ.get(DATA_SHARDS_ENV, "0")), 0)
    except ValueError:
        return 0


def stream_chunk() -> int:
    """``$REPRO_STREAM_CHUNK`` rows per streaming-fit chunk (>= 1)."""
    try:
        return max(int(os.environ.get(STREAM_CHUNK_ENV,
                                      str(STREAM_CHUNK_DEFAULT))), 1)
    except ValueError:
        return STREAM_CHUNK_DEFAULT


def find_tcmalloc() -> Optional[str]:
    for p in TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def tcmalloc_active() -> bool:
    return "tcmalloc" in os.environ.get("LD_PRELOAD", "")


def apply(extra_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Setdefault the runtime policy into the environment; returns the
    keys actually set (existing values are never overridden)."""
    applied: Dict[str, str] = {}
    for k, v in {**ENV_DEFAULTS, **(extra_env or {})}.items():
        if k not in os.environ:
            os.environ[k] = v
            applied[k] = v
    return applied


def describe() -> Dict[str, object]:
    """The effective runtime environment: torch's and CUDA's versions, the
    cards' name and count, the allocator and the scale-out knobs."""
    import torch

    tc = find_tcmalloc()
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "",
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "ld_preload": os.environ.get("LD_PRELOAD", ""),
        "tcmalloc": ("active" if tcmalloc_active()
                     else f"available:{tc}" if tc else "absent"),
        "env": {k: os.environ.get(k, "") for k in ENV_DEFAULTS},
        "data_shards": data_shards() or "(auto)",
        "stream_chunk": stream_chunk(),
    }


def log(prefix: str = "[runtime]") -> Dict[str, object]:
    """Print and return the effective environment, one line per field, and
    emit it as a ``runtime.env`` event to the JSONL sink (when one is
    configured), so a recorded stream opens with its runtime."""
    from ..obs import events as obs_events

    d = describe()
    for k, v in d.items():
        print(f"{prefix} {k}={v}", flush=True)
    if not tcmalloc_active() and find_tcmalloc():
        print(f"{prefix} note: tcmalloc present but not preloaded",
              flush=True)
    obs_events.emit("runtime.env", **d)
    return d
