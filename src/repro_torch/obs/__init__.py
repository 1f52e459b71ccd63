"""Telemetry: metrics registry, JSONL events and timed spans (stdlib and
numpy only; copies of the JAX package's modules)."""
from . import events, metrics, trace  # noqa: F401
from .metrics import REGISTRY, Registry  # noqa: F401
from .trace import span  # noqa: F401
