"""Batches of token sequences through NVIDIA-Nemotron-3-Nano-30B-A3B's
featurizer, ``repro_torch.survival.deep.make_featurizer``, under the
contract of ``drivers/featurize.py`` (whose window, outputs and checks
this driver shares): one forward pass gives the mean-pooled final hidden
state and the Cox head's risk, both read to the host every batch. A unit
is a batch.

The model is the program's registry entry (the configuration's
``program_arch``) at the file's sizes, built through
``repro_torch.models.build_model`` with its weights unfilled; each
parameter is then drawn in place from (seed, its name)
(``data/nemotron_weights.py``): the 63 GB of weights do not fit on one
card twice. Tokens are made on the host per batch from (seed, batch
index) (``data/survival_text.py``).

Traffic keys: batch, seq, checked (batches compared). Checked against
``reference/nemotron_h.py`` in float32 with TF32 off, after the program
is released: every checked sequence goes through a layer before the next
layer's weights are drawn again. A top-k choice flips where rounding
moves a near tie, and a flip changes a token's output by a whole expert;
so the checked batches are run through the program once more before it
is released, recording each expert layer's choices (``supports``, as
the beam cell's supports), and the reference recomputes everything else
at those choices:
- ``feature_gap`` and ``risk_gap`` as in ``drivers/featurize.py``;
- ``route_gap``: how far the program's choices stand below the
  reference's own top k, in biased sigmoid scores (``reference/
  nemotron_h.py``);
- ``replay_gap``: the largest gap between the second run's features and
  the window's (0: the choices are the window's own).
The control, the reference in float8, makes its own choices, and the
reference recomputes at those."""
from __future__ import annotations

import numpy as np

from perfbench import harness
from perfbench.data import nemotron_weights
from perfbench.drivers import featurize as fz
from perfbench.reference import nemotron_h as ref

# the file's published sizes by the program's names
SIZES = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "vocab_size": "vocab_size", "hybrid_override_pattern": "layer_pattern",
    "mamba_num_heads": "ssm_heads", "mamba_head_dim": "ssm_head_dim",
    "n_groups": "ssm_groups", "ssm_state_size": "ssm_state",
    "chunk_size": "ssm_chunk", "n_routed_experts": "n_experts",
    "num_experts_per_tok": "n_experts_per_tok",
    "moe_intermediate_size": "d_ff",
    "moe_shared_expert_intermediate_size": "shared_d_ff",
    "routed_scaling_factor": "routed_scaling",
    "norm_topk_prob": "norm_topk_prob", "n_group": "router_groups",
    "topk_group": "router_topk_groups",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "layer_norm_epsilon": "rms_eps",
    "dtype": "dtype",
}
# the program's Mamba2 conv is four taps wide
CONV_KERNEL = 4

window, release = fz.window, fz.release


def model_config(cfg: dict):
    """The program's model configuration at the sizes of ``cfg``."""
    from repro_torch.configs import get_config

    if int(cfg["conv_kernel"]) != CONV_KERNEL:
        raise ValueError(f"conv_kernel {cfg['conv_kernel']}: the program's "
                         f"conv is {CONV_KERNEL} wide")
    return get_config(cfg["program_arch"]).scaled(
        **{ours: cfg[theirs] for theirs, ours in SIZES.items()})


def setup(cell) -> fz.State:
    from repro_torch.models import build_model
    from repro_torch.survival import deep

    model = build_model(model_config(cell.config), device=cell.device)
    head = nemotron_weights.fill(model, cell.config, cell.seed)
    st = fz.State(cell=cell, weights=head, model=model.eval())
    st.featurize = deep.make_featurizer(st.model)
    fz._batch(st, fz.WARM)                   # warm up the one shape
    st.feats.clear()
    st.risks.clear()
    return st


def _replay(st: fz.State, index: int):
    """Batch ``index`` through the program again: (its features, each
    expert layer's choices (B S, k) on the host)."""
    from repro_torch.models import moe

    routes = []
    real = moe.route_sigmoid

    def recording(*args, **kwargs):
        topv, topi = real(*args, **kwargs)
        routes.append(topi)
        return topv, topi

    moe.route_sigmoid = recording
    try:
        _, feats = st.featurize({"tokens": fz.tokens(st.cell, index)})
    finally:
        moe.route_sigmoid = real
    return feats.cpu().numpy(), [r.cpu() for r in routes]


def outputs(st: fz.State) -> dict:
    """``drivers/featurize.py``'s outputs, and the checked batches'
    choices from a second run (one (checked B S, k) tensor an expert
    layer, batch after batch) with its gap to the window's features."""
    import torch

    out = fz.outputs(st)
    gaps, routes = [0.0], []
    for i, feats in zip(out["batches"], out["feats"]):
        again, r = _replay(st, i)
        gaps.append(float(np.max(np.abs(again - feats))))
        routes.append(r)
    out["supports"] = [torch.cat(layer) for layer in zip(*routes)]
    out["replay_gap"] = max(gaps)
    return out


def reference(st: fz.State, dtype=None, program: dict = None) -> dict:
    """Features, risk and choices of ``program``'s batches by the reference
    (float32) at ``program``'s choices, or by the control (``dtype``:
    float8 projections and experts) at its own."""
    import torch

    cell = st.cell
    mm = ref.fp8_matmul if dtype is not None else torch.matmul
    routes = program.get("supports") if dtype is None else None
    rows = int(cell.traffic["batch"])
    toks = torch.cat([torch.as_tensor(fz.tokens(cell, i), device=cell.device)
                      for i in program["batches"]])
    feats, risk, chosen, route_gap = ref.features(
        lambda name: nemotron_weights.draw(cell.config, cell.seed, name,
                                           cell.device),
        toks, cell.config, matmul=mm, routes=routes)
    feats = feats.double().cpu().numpy()
    risk = risk.double().cpu().numpy()
    return {"batches": program["batches"],
            "feats": [feats[j:j + rows] for j in range(0, len(feats), rows)],
            "risk": [risk[j:j + rows] for j in range(0, len(risk), rows)],
            "supports": [c.cpu() for c in chosen], "route_gap": route_gap}


def check(st: fz.State, out: dict, ref_out: dict) -> list:
    lim = st.cell.limits
    return fz.check(st, out, ref_out) + [
        harness.Check("route_gap", ref_out["route_gap"], lim["route_gap"]),
        harness.Check("replay_gap", out.get("replay_gap", 0.0),
                      lim["replay_gap"])]
