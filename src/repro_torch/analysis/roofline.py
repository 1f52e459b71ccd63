"""Three-term roofline model of one step on one NVIDIA H100.

    compute term    = FLOPs / (devices * peak FLOP/s)
    memory term     = bytes / (devices * HBM bandwidth)
    collective term = bytes moved between cards / link bandwidth

The PyTorch port's counterpart of the JAX package's
``analysis/roofline.py``, with the H100's figures in place of the TPU's.
FLOPs come from ``torch.utils.flop_counter``'s formulas on the meta
device (``launch/dryrun.py``), which counts no bytes: the dry run hands in
a floor, the state a step must read and write once. One card moves no
collective bytes, so its term is 0. On a mesh the dry run records each
collective that DTensor issues (its op, output bytes and group size) under
``CommDebugMode``, and ``collectives_from_comm_counts`` turns them into
``CollectiveStats`` by the reference's ring-model byte rules: the
counterpart of the reference's ``parse_collectives``, which reads XLA's
HLO text.

The serving kernels' analytic cost models, the tuned-block registry that
``kernels/autotune.py`` fills, ``model_flops_for`` and ``active_params``
are the reference's.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity) at 700 W
BF16_OPS_PER_S = 989.4e12     # bfloat16 tensor cores
FP32_OPS_PER_S = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
LINK_BYTES_PER_S = 900e9      # NVLink 4, both directions together
# InfiniBand NDR, 400 Gb/s per GPU (NVIDIA DGX H100 data sheet: one
# ConnectX-7 port a GPU): every axis of a 16 x 16 mesh of eight-card
# nodes crosses nodes, the counterpart of the reference's DCN_BW
CROSS_NODE_BYTES_PER_S = 50e9
PEAK_FLOPS = BF16_OPS_PER_S
HBM_BW = HBM_BYTES_PER_S


@dataclasses.dataclass
class CollectiveStats:
    op_bytes: Dict[str, float]         # logical output bytes by op kind
    moved_bytes: float                 # per-device bytes moved
    n_ops: int

    def to_json(self):
        return dataclasses.asdict(self)


NO_COLLECTIVES = CollectiveStats(op_bytes={}, moved_bytes=0.0, n_ops=0)

# torch's collective ops (functional, native functional, c10d) by the
# reference's HLO kind names
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}


def collectives_from_comm_counts(records) -> CollectiveStats:
    """``CollectiveStats`` of the collectives one device issues, each a
    (op, output bytes, group size) record as ``launch/dryrun.py`` takes it
    under ``CommDebugMode``; op is torch's name (``all_gather_into_tensor``,
    any namespace) or the reference's kind (``all-gather``). Bytes moved a
    device, as the reference's ``parse_collectives`` counts them (n the
    group size, at least 2):
      all-reduce 2 s (n-1)/n; all-gather s (n-1)/n (s the gathered
      output); reduce-scatter s (n-1) (s the scattered output shard);
      all-to-all s (n-1)/n; collective-permute s."""
    op_bytes: Dict[str, float] = {}
    moved = 0.0
    n_ops = 0
    for op, size, n in records:
        name = str(op).rsplit(".", 1)[-1]
        kind = COLLECTIVE_KINDS.get(name, name)
        n = max(int(n), 2)
        if kind == "all-reduce":
            b = 2.0 * size * (n - 1) / n
        elif kind in ("all-gather", "all-to-all"):
            b = size * (n - 1) / n
        elif kind == "reduce-scatter":
            b = size * (n - 1)
        elif kind == "collective-permute":
            b = size
        else:
            raise ValueError(f"not a collective: {op!r}")
        op_bytes[kind] = op_bytes.get(kind, 0.0) + size
        moved += b
        n_ops += 1
    return CollectiveStats(op_bytes=op_bytes, moved_bytes=moved, n_ops=n_ops)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6*N*D useful flops (per device share)
    useful_flops_ratio: float

    def to_json(self):
        return dataclasses.asdict(self)


def compute_roofline(flops: float, bytes_accessed: float,
                     coll: CollectiveStats, n_devices: int,
                     model_flops_global: float,
                     link_bw: float = LINK_BYTES_PER_S) -> Roofline:
    """All inputs per-device except model_flops_global (whole step)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll.moved_bytes / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_global / n_devices
    return Roofline(
        flops_per_device=flops, bytes_per_device=bytes_accessed,
        collective_bytes=coll.moved_bytes, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, bottleneck=bottleneck,
        model_flops=mf,
        useful_flops_ratio=(mf / flops) if flops else 0.0)


# ---------------------------------------------------------------------------
# Serving scoring kernels (kernels/survival_curves.py + engine matvecs):
# analytic per-call cost models so report.py covers the inference hot path.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelRoofline:
    name: str
    flops: float
    bytes_accessed: float
    compute_s: float
    memory_s: float
    intensity: float             # flops / byte
    bottleneck: str

    def to_json(self):
        return dataclasses.asdict(self)


def _cost_survival_curves(batch: int, grid: int) -> Dict[str, float]:
    """Fused S(t|x) panel: rank-1 outer product + exp, one HBM write of
    the (b, g) output; exp counted as one flop."""
    return {"flops": 2.0 * batch * grid + batch,
            "bytes": 4.0 * (batch + grid + batch * grid)}


def _cost_risk_dense(batch: int, p: int) -> Dict[str, float]:
    """eta = X beta + exp: streams the (b, p) feature panel once."""
    return {"flops": 2.0 * batch * p + batch,
            "bytes": 4.0 * (batch * p + p + batch)}


def _cost_risk_sparse(batch: int, k: int) -> Dict[str, float]:
    """Support-gathered matvec: O(k) per request on the beam-search path."""
    return {"flops": 2.0 * batch * k + batch,
            "bytes": 4.0 * (batch * k + k + batch)}


SERVING_KERNELS = {
    "survival_curves": _cost_survival_curves,
    "risk_dense": _cost_risk_dense,
    "risk_sparse": _cost_risk_sparse,
}


def kernel_roofline(name: str, **shape) -> KernelRoofline:
    """Roofline terms for one registered serving kernel at a shape. The
    kernels compute in float32 outside the tensor cores."""
    cost = SERVING_KERNELS[name](**shape)
    flops, nbytes = cost["flops"], cost["bytes"]
    compute_s = flops / FP32_OPS_PER_S
    memory_s = nbytes / HBM_BW
    return KernelRoofline(
        name=name, flops=flops, bytes_accessed=nbytes, compute_s=compute_s,
        memory_s=memory_s, intensity=flops / nbytes if nbytes else 0.0,
        bottleneck="compute" if compute_s >= memory_s else "memory")


# ---------------------------------------------------------------------------
# Tuned-block registry: the autotuner (kernels/autotune.py) registers each
# winner here, and report.py renders the tuned-vs-default table from it.
# Keys are "backend/kernel/bucket" — the same keys as the JSON tune cache.
# ---------------------------------------------------------------------------

TUNED_KERNELS: Dict[str, dict] = {}


def register_tuned(key: str, entry: dict) -> None:
    """Record one autotune winner: ``entry`` carries at least ``config``;
    timed entries also carry ``us``, ``default_config``, ``default_us``."""
    TUNED_KERNELS[key] = dict(entry)


def load_tuned(path: str) -> Dict[str, dict]:
    """Populate the registry from a tuned_blocks.json cache file (no-op on
    a missing/corrupt file — the registry just stays as-is)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return TUNED_KERNELS
    for key, entry in (data.get("entries") or {}).items():
        if isinstance(entry, dict):
            register_tuned(key, entry)
    return TUNED_KERNELS


def model_flops_for(cfg, shape, n_params_active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference) with N = active
    params; D = tokens processed this step."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    return 2.0 * n_params_active * shape.global_batch  # decode: 1 tok/seq


def active_params(cfg) -> int:
    """Active (per-token) parameter count — MoE counts top-k experts only."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd, h, kh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (h + 2 * kh) + h * hd * d
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        conv_c = d_in + 2 * cfg.ssm_state
        m = (d * (2 * d_in + 2 * cfg.ssm_state + nh)   # in_proj
             + 4 * conv_c + d_in * d)                  # conv + out_proj
        per_layer = m
        total = L * per_layer
        if cfg.family == "hybrid":
            shared = attn + 3 * d * ff
            total += (L // cfg.shared_attn_every) * shared
    elif cfg.n_experts > 0:
        ffn = cfg.n_experts_per_tok * 3 * d * ff + d * cfg.n_experts
        total = L * (attn + ffn)
    else:
        total = L * (attn + 3 * d * ff)
        if cfg.family == "encdec":
            total += cfg.encoder_layers * (attn + 3 * d * ff) \
                + L * (attn)  # cross attention
    total += cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    return int(total)
