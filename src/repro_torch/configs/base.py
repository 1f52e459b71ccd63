"""Config dataclasses: architectures, shapes, mesh, training."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6
    sliding_window: int = 0         # >0: SWA width on every layer
    local_global_ratio: int = 0     # gemma3: 5 local : 1 global
    local_window: int = 1024
    n_experts: int = 0
    n_experts_per_tok: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_every: int = 0      # zamba2: shared attn block period
    encoder_layers: int = 0         # >0 -> encoder-decoder
    mrope_sections: Tuple[int, ...] = ()
    rms_eps: float = 1e-6
    frontend: str = "none"          # none | audio | vision (stubbed embeds)
    tie_embeddings: bool = False
    q_chunk: int = 1024
    kv_chunk: int = 1024
    scan_unroll: int = 1   # >1 only in dry-run accounting probes
    dtype: str = "bfloat16"
    # long_500k applicability (sub-quadratic serving path exists)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to 256 so logits shard 16-way cleanly."""
        return _round_up(self.vocab_size, 256)

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced variant for smoke tests (same family/topology)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PatternConfig(ModelConfig):
    """A stack laid out by ``layer_pattern``, one pre-norm residual layer a
    character, each one mixer (Nemotron-H's ``hybrid_override_pattern``):
    ``M`` a Mamba2 mixer of ``ssm_heads`` x ``ssm_head_dim`` channels with
    ``ssm_groups`` groups of B and C; ``E`` a sparse-expert MLP with a
    sigmoid router (``n_experts``, ``n_experts_per_tok``, experts of width
    ``d_ff``, relu^2 or, with ``gated_experts``, SwiGLU, one shared expert
    of ``shared_d_ff``); ``*`` GQA attention alone; ``K`` Kimi Delta
    Attention (``kda_heads`` x ``kda_head_dim``, a causal conv of
    ``kda_conv`` taps, chunks of ``kda_chunk``); ``L`` latent attention
    (MLA: ``kv_lora_rank``, query and key heads of ``qk_nope_head_dim`` +
    ``qk_rope_head_dim``, value heads of ``v_head_dim``, ``n_heads`` of
    each); ``-`` a dense SwiGLU MLP of ``dense_d_ff``. ``experts_held``: the
    ids of the experts whose weights this card holds and computes, one
    contiguous range (an expert-parallel share; None: all of them); the
    router scores all ``n_experts``. The port's own fields, which the JAX
    package's ``ModelConfig`` lacks: such a config lives in the port's own
    registry (``configs.PORT_REGISTRY``)."""

    layer_pattern: str = ""
    ssm_heads: int = 0
    ssm_groups: int = 1
    shared_d_ff: int = 0
    routed_scaling: float = 1.0
    norm_topk_prob: bool = True
    router_groups: int = 1          # group-limited routing (n_group,
    router_topk_groups: int = 1     # topk_group): only one group of all
    gated_experts: bool = False
    experts_held: Optional[range] = None
    kda_heads: int = 0
    kda_head_dim: int = 128
    kda_conv: int = 4
    kda_chunk: int = 64
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    dense_d_ff: int = 0

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_pattern) != self.n_layers \
                or set(self.layer_pattern) - set("ME*KL-"):
            raise ValueError(f"layer_pattern {self.layer_pattern!r}: one of "
                             f"M, E, *, K, L, - for each of {self.n_layers} "
                             f"layers")
        if (self.router_groups, self.router_topk_groups) != (1, 1):
            raise ValueError("group-limited routing is not implemented: "
                             "router_groups and router_topk_groups are 1")
        held = self.experts_held
        if held is not None and not (
                isinstance(held, range) and len(held) and held.step == 1
                and 0 <= held.start and held.stop <= self.n_experts):
            raise ValueError(f"experts_held {held!r}: a non-empty range of "
                             f"step 1 within the {self.n_experts} experts")

    @property
    def experts_here(self) -> range:
        """The ids of the experts this card computes."""
        return self.experts_held or range(self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    microbatch: int = 0             # 0 = no gradient accumulation
    remat: object = True   # False | True/"nothing" | "dots"
    moe_aux_weight: float = 0.01
    # distributed-optimization toggles (§Perf / fault_tolerance)
    grad_compression: str = "none"  # none | int8
    zero1: bool = True              # shard optimizer state over data axis
