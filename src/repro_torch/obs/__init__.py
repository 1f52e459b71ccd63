"""Telemetry: metrics registry, JSONL events, timed spans (stdlib and numpy
only; copies of the JAX package's modules), the solver convergence
recorder and ``torch.profiler`` capture under ``$REPRO_PROFILE_DIR``."""
from . import events, metrics, profile, solver, trace  # noqa: F401
from .metrics import REGISTRY, Registry, serve_metrics  # noqa: F401
from .solver import TelemetryCallback, emit_iter  # noqa: F401
from .trace import span  # noqa: F401
