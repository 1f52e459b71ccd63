"""Batches of token sequences through a zoo backbone's featurizer,
``repro_torch.survival.deep.make_featurizer``: one forward pass gives the
mean-pooled final hidden state and the Cox head's risk, both read to the
host every batch, as ``collect_features`` reads them. A unit is a batch.

The model is built through ``repro_torch.models.build_model`` from the
configuration's sizes, and its weights (and the Cox head) are the
benchmark's own, made on the device from the seed
(``data/mamba2_weights.py``) and copied in. Tokens are made on the host
per batch from (seed, batch index) (``data/survival_text.py``).

Traffic keys: batch, seq, checked (batches compared). Checked against
``reference/mamba2.py`` in float32 with TF32 off, over a seeded sample of
the window's batches: ``feature_gap``, the pooled features' widest gap
over their largest magnitude; ``risk_gap``, the widest gap of a risk
over |w| |f|, the Cox head's weight and that sequence's features."""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np

from perfbench import harness
from perfbench.data import mamba2_weights, survival_text
from perfbench.reference import mamba2 as ref

# index of the warm-up batch: no window reaches it
WARM = 1 << 40


@dataclasses.dataclass
class State:
    cell: Any
    weights: Any
    model: Any = None
    featurize: Any = None
    feats: Any = dataclasses.field(default_factory=dict)
    risks: Any = dataclasses.field(default_factory=dict)
    batches: int = 0


def model_config(cfg: dict):
    """The program's model configuration at the sizes of ``cfg``."""
    from repro_torch.configs import get_config

    return get_config(cfg["program_arch"]).scaled(
        n_layers=int(cfg["n_layer"]), d_model=int(cfg["d_model"]),
        vocab_size=int(cfg["vocab_size"]), ssm_state=int(cfg["d_state"]),
        ssm_head_dim=int(cfg["headdim"]), ssm_expand=int(cfg["expand"]),
        dtype=cfg["dtype"])


def build(cell, weights):
    """The program's model holding ``weights``."""
    import torch
    from repro_torch.models import build_model

    model = build_model(model_config(cell.config), device=cell.device)
    model.cox_head = torch.nn.ParameterDict({
        "w": torch.nn.Parameter(weights["cox_head.w"].clone()),
        "b": torch.nn.Parameter(weights["cox_head.b"].clone())})
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: the program holds {tuple(p.shape)}"
                                 f", the benchmark made {weights[name].shape}")
            p.copy_(weights[name])
    return model.eval()


def tokens(cell, index: int) -> np.ndarray:
    tr = cell.traffic
    return survival_text.batch(cell.seed, index, int(tr["batch"]),
                               int(tr["seq"]), int(cell.config["vocab_size"]))


def setup(cell) -> State:
    from repro_torch.survival import deep

    w = mamba2_weights.make(cell.config, harness.torch_seed(cell.seed),
                            cell.device)
    st = State(cell=cell, weights=w)
    st.model = build(cell, w)
    st.featurize = deep.make_featurizer(st.model)
    _batch(st, WARM)                         # warm up the one shape
    st.feats.clear()
    st.risks.clear()
    return st


def _batch(st: State, index: int) -> None:
    risk, feats = st.featurize({"tokens": tokens(st.cell, index)})
    st.risks[index] = risk.cpu().numpy()
    st.feats[index] = feats.cpu().numpy()


def window(st: State, seconds: float) -> dict:
    tr = st.cell.traffic
    window_s, n, each = harness.units_window(lambda i: _batch(st, i),
                                             seconds)
    st.batches = n
    toks = n * int(tr["batch"]) * int(tr["seq"])
    return {"window_s": window_s, "units": n, "unit_s": each,
            "attempted": n, "failed": 0,
            "e2e": {"tokens_per_s": toks / window_s},
            "work": {"tokens": toks, "batches": n}}


def outputs(st: State) -> dict:
    rng = np.random.default_rng(harness.seed_words(st.cell.seed, 31))
    k = min(st.batches, int(st.cell.traffic["checked"]))
    idx = sorted(int(i) for i in rng.choice(st.batches, size=k,
                                            replace=False))
    return {"batches": idx, "feats": [st.feats[i] for i in idx],
            "risk": [st.risks[i] for i in idx]}


def release(st: State) -> None:
    st.model = st.featurize = None


def reference(st: State, dtype=None, program: dict = None) -> dict:
    """Features and risk of ``program``'s batches by the reference
    (float32), or by the control (``dtype`` float8: its projections)."""
    import torch

    mm = ref.fp8_matmul if dtype is not None else torch.matmul
    feats, risk = [], []
    for i in program["batches"]:
        toks = torch.as_tensor(tokens(st.cell, i), device=st.cell.device)
        f, r = ref.features(st.weights, toks, st.cell.config, matmul=mm)
        feats.append(f.double().cpu().numpy())
        risk.append(r.double().cpu().numpy())
    return {"batches": program["batches"], "feats": feats, "risk": risk}


def check(st: State, out: dict, ref_out: dict) -> List[harness.Check]:
    lim = st.cell.limits
    if not out["batches"]:
        return [harness.Check("batches", float("inf"), 0.0)]
    feat_gap = max(harness.rel_gap(a, b)
                   for a, b in zip(out["feats"], ref_out["feats"]))
    # a risk's gap over the largest the head can give from features of
    # that size, |w| |f|: the risk's own size (the bias and the features'
    # common mean) varies too much from seed to seed to scale it
    w = np.linalg.norm(st.weights["cox_head.w"].double().cpu().numpy())
    risk_gap = max(
        float(np.max(np.abs(a - b) / (w * np.linalg.norm(f, axis=1))))
        for a, b, f in zip(out["risk"], ref_out["risk"], ref_out["feats"]))
    return [harness.Check("feature_gap", feat_gap, lim["feature_gap"]),
            harness.Check("risk_gap", risk_gap, lim["risk_gap"])]
