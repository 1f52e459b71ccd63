"""FastCPH-style deep survival: zoo backbone -> exact CPH head -> paper
solver refit -> serving artifact.

The PyTorch port's counterpart of the JAX package's ``survival/deep.py``:

  1. **Train** a backbone from the architecture registry (default the
     reduced mamba2-130m config) under ``survival/head.cox_loss``, the
     exact Breslow partial likelihood in eta-space, so the gradient into
     the backbone is the (w*A - delta) eta-gradient the paper analyzes
     (``train_backbone``).
  2. **Freeze + featurize**: mean-pooled final hidden states become the
     feature matrix of a linear CPH problem (``make_featurizer``,
     ``collect_features``).
  3. **Sparse refit** with the paper's surrogate/beam-search coordinate
     descent (``head.sparse_refit``): an interpretable k-sparse head on the
     learned representation.
  4. **Export** a ``serving.SurvivalModel`` artifact: the sparse beta plus
     a Breslow baseline cumulative hazard fit on the refit's features, so
     the artifact loads through ``serving.ModelRegistry`` and scores
     through ``RiskService`` exactly like a linear model. Request features
     are pooled embeddings, produced by ``make_featurizer``.

``run()`` chains all four and reports held-out c-indexes for both the
deep head (backbone risk scores) and the sparse refit head. Everything
runs on the model's device, a card unless built on ``"cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..configs.base import ModelConfig, TrainConfig
from ..core.beam import BeamResult
from ..data.pipeline import SurvivalTextStream, put_batch
from ..models import build_model
from ..models.model import Model
from ..obs import trace
from ..serving.artifacts import SurvivalModel, fit_survival_model
from ..train.loop import run_loop
from ..train.optimizer import init_opt_state
from ..train.trainer import TrainState, make_train_step
from . import metrics
from .head import init_cox_head, pooled_features, sparse_refit


@dataclasses.dataclass
class DeepSurvivalConfig:
    """Knobs for the train -> refit -> export pipeline, each at the
    reference's default. The held-out batches start after ``steps``
    training steps of ``batch`` sequences."""

    arch: str = "mamba2-130m"
    full: bool = False           # ~100M config instead of the CPU-sized one
    steps: int = 150
    batch: int = 32
    seq: int = 48
    learning_rate: float = 2e-3
    warmup_steps: int = 20
    seed: int = 0
    k: int = 8                   # sparse-head support size (<= d_model)
    beam_width: int = 4
    refit_batches: int = 4       # held-out batches for refit + eval
    grid_size: int = 64          # artifact time-grid resolution
    log_every: int = 25


@dataclasses.dataclass
class DeepSurvivalResult:
    """Everything the pipeline produced, ready for serving or analysis."""

    cfg: ModelConfig
    state: TrainState            # the trained backbone, Cox head, moments
    losses: List[float]
    features: np.ndarray         # (n_eval, d_model) frozen pooled features
    times: np.ndarray
    events: np.ndarray
    risks_deep: np.ndarray       # backbone head risk on the eval batches
    beam: BeamResult
    beta: np.ndarray             # (d_model,) dense sparse-refit coefficients
    artifact: SurvivalModel
    cindex_deep: float
    cindex_sparse: float

    @property
    def nnz(self) -> int:
        return int((np.abs(self.beta) > 1e-8).sum())


def model_config(dcfg: DeepSurvivalConfig) -> ModelConfig:
    """Resolve the backbone config: registry entry at full scale, or the
    CPU-sized reduction (the shape every test/smoke path runs)."""
    cfg = get_config(dcfg.arch)
    if dcfg.full:
        return cfg.scaled(n_layers=12, vocab_size=2048)
    cfg = reduced_config(cfg)
    if cfg.family in ("ssm", "hybrid"):
        cfg = cfg.scaled(n_layers=4, d_model=128, vocab_size=512,
                         ssm_state=32)
    return cfg


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def init_state(model: Model, rng_seed: int = 0) -> TrainState:
    """Backbone params drawn from a generator seeded ``rng_seed`` and a CPH
    head from ``rng_seed + 1``, both on the model's device, wrapped in a
    fresh optimizer state."""
    model.reset_parameters(_generator(model.device, rng_seed))
    model.cox_head = init_cox_head(_generator(model.device, rng_seed + 1),
                                   model.cfg.d_model, model.device)
    return TrainState(model=model, opt=init_opt_state(model))


def train_backbone(model: Model, dcfg: DeepSurvivalConfig,
                   stream: Optional[SurvivalTextStream] = None,
                   state: Optional[TrainState] = None,
                   on_step: Optional[Callable[[int, dict], None]] = None,
                   ) -> Tuple[TrainState, List[float], SurvivalTextStream]:
    """Step 1: fit the backbone under the exact CPH objective, on the
    model's device. ``on_step(step, metrics)`` fires after every step
    (``run_loop``'s)."""
    cfg = model.cfg
    if stream is None:
        stream = SurvivalTextStream(cfg.vocab_size, dcfg.seq, dcfg.batch,
                                    seed=dcfg.seed)
    if state is None:
        state = init_state(model, dcfg.seed)
    tcfg = TrainConfig(learning_rate=dcfg.learning_rate,
                       warmup_steps=dcfg.warmup_steps,
                       total_steps=dcfg.steps)
    step_fn = make_train_step(model, tcfg, objective="cox")
    state, losses = run_loop(step_fn, state, stream, dcfg.steps,
                             log_every=dcfg.log_every,
                             log_prefix="[deep]", on_step=on_step)
    return state, losses, stream


def make_featurizer(model: Model) -> Callable:
    """``batch -> (risk (b,), features (b, d_model))``, float32 tensors on
    the model's device: the request-time transform that turns raw
    sequences (a host batch with ``tokens``) into the feature vectors a
    deep ``SurvivalModel`` artifact scores. One backbone pass gives both:
    the risk is the Cox head on the pooled features, as
    ``Model.risk_scores`` computes it. A batch is one span,
    ``featurize.batch``, with its ``tokens`` and the card's time."""

    @torch.inference_mode()
    def featurize(batch):
        tokens = batch["tokens"]
        with trace.span("featurize.batch", device_time=True,
                        tokens=math.prod(tokens.shape)):
            b = put_batch({"tokens": tokens}, model.device)
            feats = pooled_features(model, b)
            return model.risk_from_pooled(feats), feats

    return featurize


def collect_features(model: Model, stream: SurvivalTextStream,
                     start_step: int, n_batches: int) -> Dict[str, np.ndarray]:
    """Step 2: frozen pooled features + labels over held-out batches."""
    featurize = make_featurizer(model)
    feats, times, events, risks = [], [], [], []
    for step in range(start_step, start_step + n_batches):
        b = stream.batch_for_step(step)
        r, f = featurize(b)
        risks.append(r.cpu().numpy())
        feats.append(f.cpu().numpy())
        times.append(b["time"])
        events.append(b["event"])
    return {"features": np.concatenate(feats),
            "time": np.concatenate(times),
            "event": np.concatenate(events),
            "risk_deep": np.concatenate(risks)}


def refit_and_export(features: np.ndarray, t: np.ndarray, e: np.ndarray,
                     *, k: int, beam_width: int = 4, grid_size: int = 64,
                     device="cuda") -> Tuple[BeamResult, np.ndarray,
                                             SurvivalModel]:
    """Steps 3+4 on ``device`` (a card unless ``"cpu"``): beam-search
    sparse head on frozen features, then the serving artifact (sparse beta
    + Breslow baseline on those features).

    ``fit_survival_model`` detects the sparse support itself, so the
    artifact carries the O(k) fast-path fields the engine uses.
    """
    beam = sparse_refit(features, t, e, k=k, beam_width=beam_width,
                        device=device)
    beta = np.asarray(beam.betas[-1], np.float32)
    artifact = fit_survival_model(features, t, e, beta, grid_size=grid_size,
                                  device=device)
    return beam, beta, artifact


def run(dcfg: Optional[DeepSurvivalConfig] = None, *, device="cuda",
        on_step: Optional[Callable[[int, dict], None]] = None,
        **overrides: Any) -> DeepSurvivalResult:
    """The whole pipeline on ``device`` (a card unless ``"cpu"``);
    ``overrides`` patch ``DeepSurvivalConfig``, ``on_step`` goes to
    ``train_backbone``."""
    if dcfg is None:
        dcfg = DeepSurvivalConfig(**overrides)
    elif overrides:
        dcfg = dataclasses.replace(dcfg, **overrides)
    cfg = model_config(dcfg)
    model = build_model(cfg, device=device)
    state, losses, stream = train_backbone(model, dcfg, on_step=on_step)
    held = collect_features(model, stream, dcfg.steps, dcfg.refit_batches)
    k = min(dcfg.k, max(cfg.d_model // 4, 1))
    beam, beta, artifact = refit_and_export(
        held["features"], held["time"], held["event"],
        k=k, beam_width=dcfg.beam_width, grid_size=dcfg.grid_size,
        device=model.device)
    ci_deep = metrics.cindex(held["time"], held["event"],
                             held["risk_deep"])
    ci_sparse = metrics.cindex(held["time"], held["event"],
                               held["features"] @ beta)
    return DeepSurvivalResult(
        cfg=cfg, state=state, losses=losses,
        features=held["features"], times=held["time"],
        events=held["event"], risks_deep=held["risk_deep"],
        beam=beam, beta=beta, artifact=artifact,
        cindex_deep=float(ci_deep), cindex_sparse=float(ci_sparse))
