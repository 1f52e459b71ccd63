"""Config dataclasses: architectures, shapes, mesh, training."""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
