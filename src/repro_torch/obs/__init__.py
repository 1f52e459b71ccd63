"""Telemetry: metrics registry, JSONL events, timed spans (stdlib and numpy
only; copies of the JAX package's modules) and the solver convergence
recorder."""
from . import events, metrics, solver, trace  # noqa: F401
from .metrics import REGISTRY, Registry  # noqa: F401
from .solver import TelemetryCallback  # noqa: F401
from .trace import span  # noqa: F401
