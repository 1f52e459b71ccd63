"""Batches of token sequences through Kimi-Linear-48B-A3B's featurizer,
``repro_torch.survival.deep.make_featurizer``, under the contract of
``drivers/featurize.py`` (whose window this driver shares) with the routing
replay of ``drivers/featurize_nemotron.py`` (whose outputs and checks it
shares): one forward pass gives the mean-pooled final hidden state and the
Cox head's risk, both read to the host every batch. A unit is a batch.

The model is the program's registry entry (the configuration's
``program_arch``) at the file's sizes and with its held share of the
experts (``experts_held`` of ``num_experts_published``), built through
``repro_torch.models.build_model`` with its weights unfilled; each
parameter is then drawn in place from (seed, its name)
(``data/kimi_weights.py``). Tokens are made on the host per batch from
(seed, batch index) (``data/survival_text.py``).

Traffic keys: batch, seq, checked (batches compared). Checked against
``reference/kimi_linear.py`` in float32 with TF32 off, after the program
is released, at the program's own expert choices, recorded by a second
run of the checked batches: ``feature_gap``, ``risk_gap``, ``route_gap``
and ``replay_gap`` as ``drivers/featurize_nemotron.py`` defines them. The
control, the reference in float8, makes its own choices, and the
reference recomputes at those."""
from __future__ import annotations

from perfbench.data import kimi_weights
from perfbench.drivers import featurize as fz
from perfbench.drivers import featurize_nemotron as fzn
from perfbench.reference import kimi_linear as ref

# the file's published sizes by the program's names
SIZES = {
    "hidden_size": "d_model", "vocab_size": "vocab_size",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "dense_d_ff",
    "moe_intermediate_size": "d_ff",
    "num_experts_published": "n_experts",
    "num_experts_per_token": "n_experts_per_tok",
    "routed_scaling_factor": "routed_scaling",
    "moe_renormalize": "norm_topk_prob", "num_expert_group": "router_groups",
    "topk_group": "router_topk_groups", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "rms_norm_eps": "rms_eps", "kda_chunk": "kda_chunk", "dtype": "dtype",
}
LINEAR = {"num_heads": "kda_heads", "head_dim": "kda_head_dim",
          "short_conv_kernel_size": "kda_conv"}
# what the program computes: a file that says otherwise is refused
FIXED = {"hidden_act": "silu", "moe_router_activation_func": "sigmoid",
         "mla_use_nope": True, "q_lora_rank": None, "moe_layer_freq": 1,
         "num_shared_experts": 1, "tie_word_embeddings": False}

window, release, outputs, check = fz.window, fz.release, fzn.outputs, \
    fzn.check


def model_config(cfg: dict):
    """The program's model configuration at the sizes of ``cfg``: one
    pattern character a sublayer (``reference/kimi_linear.py::pattern``)
    and the held share."""
    from repro_torch.configs import get_config

    for key, want in FIXED.items():
        if cfg[key] != want:
            raise ValueError(f"{key} {cfg[key]!r}: the program computes "
                             f"{want!r}")
    first, stop = (int(i) for i in cfg["experts_held"])
    if stop - first != int(cfg["num_experts"]):
        raise ValueError("num_experts is the count of experts_held")
    layers = ref.pattern(cfg)
    return get_config(cfg["program_arch"]).scaled(
        layer_pattern=layers, n_layers=len(layers),
        experts_held=range(first, stop),
        shared_d_ff=int(cfg["moe_intermediate_size"]),
        **{ours: cfg[theirs] for theirs, ours in SIZES.items()},
        **{ours: cfg["linear_attn_config"][theirs]
           for theirs, ours in LINEAR.items()})


def setup(cell) -> fz.State:
    from repro_torch.models import build_model
    from repro_torch.survival import deep

    model = build_model(model_config(cell.config), device=cell.device)
    head = kimi_weights.fill(model, cell.config, cell.seed)
    st = fz.State(cell=cell, weights=head, model=model.eval())
    st.featurize = deep.make_featurizer(st.model)
    fz._batch(st, fz.WARM)                   # warm up the one shape
    st.feats.clear()
    st.risks.clear()
    return st


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
        lambda name: kimi_weights.draw(cell.config, cell.seed, name,
                                       cell.device),
        toks, cell.config, matmul=mm, routes=routes)
    feats = feats.double().cpu().numpy()
    risk = risk.double().cpu().numpy()
    return {"batches": program["batches"],
            "feats": [feats[j:j + rows] for j in range(0, len(feats), rows)],
            "risk": [risk[j:j + rows] for j in range(0, len(risk), rows)],
            "supports": [c.cpu() for c in chosen], "route_gap": route_gap}
