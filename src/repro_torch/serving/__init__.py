"""Serving: the Breslow/Efron SurvivalModel artifact, the batched
ScoringEngine, and the front end over it — ``RiskService`` (continuous
micro-batching, two priority classes, shed-low-first admission,
server-side deadlines, retries and health), ``ModelRegistry``
(checksum-verified load, background prewarm, zero-drop hot swap) and the
``chaos`` fault injectors, as in the JAX package's ``serving/``."""
from .artifacts import (ArtifactCorrupt, SurvivalModel,  # noqa: F401
                        fit_survival_model)
from .chaos import ChaosEngine, EngineFault, corrupt_artifact  # noqa: F401
from .engine import ScoringEngine  # noqa: F401
from .registry import ModelEntry, ModelRegistry  # noqa: F401
from .service import (HEALTH_STATES, Priority, QueueFull,  # noqa: F401
                      RiskService, ScoreRequest, ScoreResponse,
                      ScoreTimeout)
