"""Serving: the Breslow/Efron SurvivalModel artifact and the batched
ScoringEngine."""
from .artifacts import (ArtifactCorrupt, SurvivalModel,  # noqa: F401
                        fit_survival_model)
from .engine import ScoringEngine  # noqa: F401
