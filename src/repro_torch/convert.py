"""Carry the JAX package's state across to the port.

Both packages speak numpy at their edges, so state moves as numpy arrays:
data into a time-sorted ``CoxData``, a reference artifact's arrays into the
port's ``SurvivalModel``, coefficients onto a device, a backbone's param
tree into the port's ``Model`` state, and a whole training state (params,
AdamW moments and step) into the port's ``TrainState``, so a run can move
from the reference to the port in mid-training.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.cox import CoxData, prepare
from .models.model import Model
from .serving.artifacts import ARRAY_FIELDS, SurvivalModel
from .train.optimizer import OptState
from .train.trainer import TrainState


def cox_data_from_numpy(x: np.ndarray, t: np.ndarray, delta: np.ndarray,
                        device="cuda") -> CoxData:
    """Time-sorted ``CoxData`` from numpy arrays, keeping ``x``'s float type
    (float64 stays float64, as the reference does under x64)."""
    return prepare(torch.from_numpy(np.ascontiguousarray(x)),
                   torch.from_numpy(np.ascontiguousarray(t)),
                   torch.from_numpy(np.ascontiguousarray(delta)),
                   device=device)


def model_from_reference(arrays: Dict[str, np.ndarray],
                         ties: str) -> SurvivalModel:
    """The port's ``SurvivalModel`` from the reference's ``beta``,
    ``time_grid``, ``base_cumhaz`` and, where present, ``support``,
    ``beta_support`` and ``strata_labels`` arrays, unchanged."""
    unknown = set(arrays) - set(ARRAY_FIELDS)
    if unknown:
        raise ValueError(f"unknown artifact arrays: {sorted(unknown)}")
    return SurvivalModel(ties=ties, **{
        name: np.asarray(arrays[name]) for name in ARRAY_FIELDS
        if arrays.get(name) is not None})


def beta_to_device(beta: np.ndarray, device="cuda") -> torch.Tensor:
    """Coefficients as a tensor on ``device``, in their own float type."""
    return torch.as_tensor(np.asarray(beta), device=device)


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _leaves(value, name + ".")
        else:
            yield name, value


def _tensor(a) -> torch.Tensor:
    """A host array as a tensor of the same type and shape (a copy);
    bfloat16 (numpy's ``ml_dtypes`` type, which torch cannot read) passes
    through float32, exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


# the reference's stacked (L, ...) subtrees, and the config field giving L
STACKED = {"layers": "n_layers", "enc_layers": "encoder_layers"}


def _rename(cfg: ModelConfig, tree: Mapping[str, Any], dtype=None
            ) -> Dict[str, torch.Tensor]:
    """The reference's tree of the model's shape as the port's state dict;
    every leaf in the port's dtype, or in ``dtype`` when given."""
    want = Model(cfg, device="meta").state_dict()
    if "cox_head" in tree:
        want.update({"cox_head.w": torch.empty(cfg.d_model, 1,
                                               device="meta"),
                     "cox_head.b": torch.empty((), device="meta")})
    state: Dict[str, torch.Tensor] = {}
    unused = []
    for name, leaf in _leaves(tree):
        t = _tensor(leaf)
        top, _, rest = name.partition(".")
        if top in STACKED:
            n = getattr(cfg, STACKED[top])
            if t.shape[0] != n:
                raise ValueError(f"{name}: leading axis {t.shape[0]}, the "
                                 f"config has {n} {top}")
            names = [f"{top}.{i}.{rest}" for i in range(n)]
            parts = list(t)
        else:
            names, parts = [name], [t]
        for key, part in zip(names, parts):
            if key not in want:
                unused.append(key)
                continue
            ref = want[key]
            ref_dtype = ref.dtype if dtype is None else dtype
            if part.shape != ref.shape or part.dtype != ref_dtype:
                raise ValueError(
                    f"{key}: {tuple(part.shape)} {part.dtype} in the tree, "
                    f"{tuple(ref.shape)} {ref_dtype} in the port")
            state[key] = part.contiguous()
    missing = sorted(set(want) - set(state))
    if unused or missing:
        raise ValueError(f"leaves left unused: {sorted(unused)}; parameters "
                         f"left unfilled: {missing}")
    return state


def model_params_from_jax(cfg: ModelConfig, params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The port's ``Model`` state (``load_state_dict``'s argument, host
    tensors) from the reference's param tree as numpy arrays.

    The reference stacks its layers on a leading axis L (``params["layers"]``
    and an encoder-decoder's ``params["enc_layers"]``, scanned); each layer
    i becomes ``layers.{i}.<name>`` (``enc_layers.{i}.<name>``). Unstacked
    subtrees (zamba2's ``shared`` block, ``enc_norm``) keep their names.
    A ``cox_head`` in
    the tree (``deep.init_state`` puts it there) maps to the model's Cox
    head, which the port's model must have attached before loading. Raises
    on any leaf this leaves unused, any parameter it leaves unfilled, and
    any shape or dtype that differs from the port's."""
    return _rename(cfg, params)


def train_state_from_jax(cfg: ModelConfig, params: Mapping[str, Any], opt,
                         device="cuda") -> TrainState:
    """The port's ``TrainState`` on ``device`` (a card unless ``"cpu"``)
    from the reference's param tree and ``OptState`` (numpy leaves): the
    model built for ``cfg`` (with a Cox head when the tree has one) holding
    ``params``, the float32 moments ``m`` and ``v`` renamed as the params
    are, and the step."""
    from .survival.head import init_cox_head

    model = Model(cfg, device=device)
    if "cox_head" in params:
        model.cox_head = init_cox_head(torch.Generator(model.device),
                                       cfg.d_model, model.device)
    model.load_state_dict(model_params_from_jax(cfg, params))
    m = _rename(cfg, opt.m, torch.float32)
    v = _rename(cfg, opt.v, torch.float32)
    return TrainState(model=model, opt=OptState(
        m={k: t.to(model.device) for k, t in m.items()},
        v={k: t.to(model.device) for k, t in v.items()},
        step=int(np.asarray(opt.step))))
