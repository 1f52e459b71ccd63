"""Model dispatch: one ``nn.Module`` over every backbone family of the
pool: ``dense``, ``moe`` and ``vlm`` (decoder-only transformers), ``ssm``
(Mamba2 stacks), ``hybrid`` (Zamba2: Mamba2 groups with one shared
transformer block), ``encdec`` (encoder-decoder with cross attention) and
``pattern`` (Nemotron-H and Kimi Linear: one mixer a layer, Mamba2,
sparse experts, attention, KDA, latent attention or a dense MLP, as
``PatternConfig.layer_pattern`` lays them out; the port's own family,
which the JAX package lacks, with no decode cache yet).

The PyTorch port's counterpart of the JAX package's ``models/model.py``.
The module holds the parameters under the reference's names, one entry per
layer where the reference stacks them on a leading (L, ...) axis
(``convert.model_params_from_jax`` carries a reference param tree across).
It is built on an explicit device, a card unless ``"cpu"``, with its
weights unfilled until ``reset_parameters`` draws them from an explicit
``torch.Generator`` (``build_model(generator=)`` or ``deep.init_state``)
or ``load_state_dict`` carries them in. The objectives take their
gradients through ``torch.autograd`` (``train/trainer.py``); ``remat``
recomputes each layer in the backward pass, as the reference's
``jax.checkpoint`` of its scanned layer body does. ``prefill`` and
``decode_step`` serve (``launch/serve.py``): the cache is a NamedTuple of
tensors of the reference's shapes, which ``decode_step`` writes in place.
On a mesh (the parameters DTensors, ``launch.sharding.shard_model``) the
forward keeps the reference's activation anchors (``pspec.constrain``) and
runs the work that is independent over batch and heads (attention, the
SSD scan, the conv, the MoE's routes and experts) on local shards; on plain
tensors every function computes what it does without a mesh.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as _ckpt

from .. import device as _device
from ..configs.base import ModelConfig
from . import kda, layers, moe, pspec, ssm, transformer as tf

Tensor = torch.Tensor

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec", "pattern")
DECODERS = ("dense", "moe", "vlm")
CONV_TAIL = 3   # mamba2's conv_width - 1 pre-conv inputs a cache carries
_META = torch.device("meta")


class SSMCache(NamedTuple):
    conv: Tensor    # (L, B, W-1, C)
    state: Tensor   # (L, B, H, hd, N) float32
    length: Tensor  # (B,) int32


class HybridCache(NamedTuple):
    conv: Tensor    # (L, B, W-1, C)
    state: Tensor   # (L, B, H, hd, N) float32
    k: Tensor       # (G, B, S, KH, hd): one per shared-block application
    v: Tensor
    length: Tensor


class EncDecCache(NamedTuple):
    k: Tensor       # (L, B, S_dec, KH, hd) decoder self-attention
    v: Tensor
    xk: Tensor      # (L, B, S_src, KH, hd) precomputed cross K/V
    xv: Tensor
    length: Tensor


_MATMULS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "bmm", "addmm", "baddbmm"))


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep matmul outputs, recompute the rest (the
    reference's ``jax.checkpoint_policies.dots_saveable``)."""
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(body: Callable, remat) -> Callable:
    """remat: False | True/"nothing" (recompute all) | "dots" (save matmul
    outputs). Without grad there is nothing to save, so nothing changes."""
    if remat is False or remat is None or not torch.is_grad_enabled():
        return body
    if remat == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(_ckpt.checkpoint, body, use_reentrant=False,
                                 context_fn=ctx)
    if remat is True or remat == "nothing":
        return functools.partial(_ckpt.checkpoint, body, use_reentrant=False)
    raise ValueError(f"remat {remat!r}: False, True, 'nothing' or 'dots'")


def _vocab_parallel_terms(logits: Tensor, labels: Tensor):
    """(logsumexp, the labels' logits) over the last dim of a DTensor
    whose vocab dim may be sharded, from reductions that stay on their
    shards (max, sum of exponentials, the masked label logit) and are then
    summed across them: DTensor's ``logsumexp`` and ``gather`` would
    gather the whole (B, S, V) panel on every device first."""
    keep = pspec.grad_as_input
    m = logits.detach().amax(dim=-1, keepdim=True)
    e = keep(torch.exp(logits - m))
    lse = keep(torch.log(pspec.constrain(e.sum(dim=-1), "dp", None))
               + m[..., 0])
    vocab = pspec.lift(torch.arange(logits.shape[-1], device=labels.device),
                       logits)
    hit = keep(torch.where(labels[..., None] == vocab, logits, 0.0))
    return lse, keep(pspec.constrain(hit.sum(dim=-1), "dp", None))


class Model(nn.Module):
    """Backbone, final norm and LM head, and, once ``deep.init_state`` has
    attached it, the Cox head ``cox_head`` ({"w": (D, 1), "b": ()})."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; have "
                             f"{FAMILIES}")
        dev = _device.resolve(device)
        self.cfg = cfg
        self.dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.embed = layers.normal((cfg.vocab_padded, cfg.d_model), 0.02,
                                   self.dt, dev)
        self.final_norm = layers.init_rmsnorm(cfg.d_model, self.dt, dev)
        self.lm_head = None if cfg.tie_embeddings else layers.normal(
            (cfg.d_model, cfg.vocab_padded), cfg.d_model ** -0.5, self.dt,
            dev)
        self.layers = nn.ModuleList(
            [self._init_layer(dev, i) for i in range(cfg.n_layers)])
        self.cox_head: Optional[nn.ParameterDict] = None
        # zamba2's one shared block; the encoder of an encoder-decoder
        self.shared = tf.init_block(cfg, self.dt, dev) \
            if cfg.family == "hybrid" else None
        self.enc_layers = nn.ModuleList(
            [tf.init_block(cfg, self.dt, dev)
             for _ in range(cfg.encoder_layers)]) \
            if cfg.family == "encdec" else None
        self.enc_norm = layers.init_rmsnorm(cfg.d_model, self.dt, dev) \
            if cfg.family == "encdec" else None
        self.windows, self.thetas = tf.attention_pattern(cfg, cfg.n_layers)
        if generator is not None:
            self.reset_parameters(generator)

    def _init_layer(self, dev, i: int) -> nn.ModuleDict:
        cfg = self.cfg
        if cfg.family in DECODERS or cfg.family == "encdec":
            return tf.init_block(cfg, self.dt, dev,
                                 cross_attn=cfg.family == "encdec")
        if cfg.family == "pattern":
            return self._init_pattern_layer(dev, cfg.layer_pattern[i])
        return nn.ModuleDict({
            "ln": layers.init_rmsnorm(cfg.d_model, self.dt, dev),
            "mamba": ssm.init_mamba2(cfg.d_model, cfg.ssm_state,
                                     cfg.ssm_head_dim, cfg.ssm_expand,
                                     dtype=self.dt, device=dev)})

    def _init_pattern_layer(self, dev, kind: str) -> nn.ModuleDict:
        """A pre-norm and one mixer: ``mamba`` (M), ``moe`` (E), ``attn``
        (*), ``kda`` (K), ``mla`` (L) or ``mlp`` (-)."""
        cfg, dt = self.cfg, self.dt
        if kind == "M":
            name, mixer = "mamba", ssm.init_mamba2(
                cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim, dtype=dt,
                device=dev, n_heads=cfg.ssm_heads, n_groups=cfg.ssm_groups)
        elif kind == "E":
            name, mixer = "moe", moe.init_sparse_moe(
                cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.shared_d_ff, dt,
                dev, held=len(cfg.experts_here), gated=cfg.gated_experts)
        elif kind == "K":
            name, mixer = "kda", kda.init_kda(
                cfg.d_model, cfg.kda_heads, cfg.kda_head_dim, cfg.kda_conv,
                dt, dev)
        elif kind == "L":
            name, mixer = "mla", layers.init_mla(
                cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                dt, dev)
        elif kind == "-":
            name, mixer = "mlp", layers.init_mlp(cfg.d_model, cfg.dense_d_ff,
                                                 dt, dev)
        else:
            name, mixer = "attn", layers.init_attention(
                cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.qkv_bias, dt, dev)
        return nn.ModuleDict({
            "ln": layers.init_rmsnorm(cfg.d_model, dt, dev), name: mixer})

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw every backbone weight in place from ``gen`` (on the model's
        device) with the reference's scales (embeddings 0.02, the LM head
        d_model^-0.5, each layer's as its ``init_*`` sets them), in float32
        and then rounded to the model dtype, and restore the norms, biases
        and the SSM's decay and skip terms to their constants."""
        for p in self.parameters():
            scale = getattr(p, "init_scale", None)
            if scale is not None:
                p.copy_(torch.randn(p.shape, generator=gen,
                                    dtype=torch.float32, device=p.device)
                        * scale)
            elif hasattr(p, "init_value"):
                p.copy_(p.init_value)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # Embedding / logits
    # ------------------------------------------------------------------
    def _scale_embeds(self, x: Tensor) -> Tensor:
        if self.cfg.name.startswith("gemma"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dt,
                                 device=x.device)
        return x

    def _embed_in(self, batch) -> Tensor:
        """The stub frontend's ``embeds`` (B, S, D) when the batch has
        them, else the embedded ``tokens``."""
        if "embeds" in batch:
            x = self._scale_embeds(batch["embeds"].to(self.dt))
        else:
            x = self._scale_embeds(self._lookup(batch["tokens"]))
        return pspec.constrain(x, "dp", None, None)

    def _lookup(self, tokens: Tensor) -> Tensor:
        """Rows of the token embedding. A DTensor table is first gathered
        whole, as ZeRO-3 gathers a weight before its use, and each device
        looks up its own tokens (its gradient comes back as a partial sum
        over the batch's shards)."""
        if isinstance(self.embed, DTensor):
            return F.embedding(tokens.long(),
                               pspec.constrain(self.embed, None, None))
        return self.embed[tokens.long()]

    def _logits(self, hidden: Tensor) -> Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        logits = hidden @ head
        logits = pspec.constrain(logits, "dp", *[None] * (logits.ndim - 2),
                                 "model")
        v = self.cfg.vocab_size
        if self.cfg.vocab_padded != v:
            pad = pspec.lift(torch.arange(self.cfg.vocab_padded,
                                          device=logits.device) >= v, logits)
            logits = torch.where(pad, -1e30, logits.float())
        return logits

    @staticmethod
    def _positions(batch, x: Tensor) -> Tensor:
        """The batch's ``positions`` ((B, S), or (3, B, S) for M-RoPE),
        else 0..S-1 for every row."""
        if "positions" in batch:
            return batch["positions"]
        b, s = x.shape[:2]
        return torch.arange(s, device=x.device)[None, :].expand(b, s)

    # ------------------------------------------------------------------
    # Hidden-state stacks (train / prefill)
    # ------------------------------------------------------------------
    def _block(self, p_l, window: int, theta: float, want_kv: bool,
               x: Tensor, pos: Tensor, enc: Optional[Tensor] = None,
               causal: bool = True):
        return tf.block_forward(p_l, self.cfg, x, pos, window, theta,
                                causal=causal, enc_out=enc, want_kv=want_kv)

    def _ssm_layer(self, p_l, want_state: bool, x: Tensor):
        cfg = self.cfg
        y = ssm.mamba2_forward(
            p_l["mamba"], layers.rmsnorm(p_l["ln"], x, cfg.rms_eps),
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand, chunk=cfg.ssm_chunk,
            return_state=want_state, eps=cfg.rms_eps)
        if want_state:
            y, st = y
            return pspec.constrain(x + y, "dp", None, None), st
        return pspec.constrain(x + y, "dp", None, None), None

    def _decoder_stack(self, x, pos, want_kv: bool, remat):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = []
        for p_l, w_l, th_l in zip(self.layers, self.windows, self.thetas):
            body = functools.partial(self._block, p_l, int(w_l),
                                     float(th_l), want_kv)
            x, a, kv = _maybe_remat(body, remat)(x, pos)
            aux = aux + a
            kvs.append(kv)
        return x, aux, kvs

    def _ssm_stack(self, x, want_state: bool, remat):
        states = []
        for p_l in self.layers:
            x, st = _maybe_remat(functools.partial(
                self._ssm_layer, p_l, want_state), remat)(x)
            states.append(st)
        return x, states

    def _hybrid_stack(self, x, pos, want_kv: bool, remat):
        """Zamba2: groups of ``shared_attn_every`` mamba layers, with the
        SHARED transformer block (one param set) applied after each
        group."""
        cfg = self.cfg
        states, kvs = [], []
        shared = functools.partial(self._block, self.shared, -1,
                                   cfg.rope_theta, want_kv)
        for i, p_l in enumerate(self.layers):
            x, st = _maybe_remat(functools.partial(
                self._ssm_layer, p_l, want_kv), remat)(x)
            states.append(st)
            if (i + 1) % cfg.shared_attn_every == 0:
                x, _, kv = _maybe_remat(shared, remat)(x, pos)
                kvs.append(kv)
        return x, (kvs, states)

    def _pattern_layer(self, kind: str, p_l, x: Tensor) -> Tensor:
        """x + mixer(norm(x)), the mixer of ``kind`` (M, E, *, K, L or -)."""
        cfg = self.cfg
        h = layers.rmsnorm(p_l["ln"], x, cfg.rms_eps)
        if kind == "M":
            y = ssm.mamba2_forward(
                p_l["mamba"], h, d_state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                n_heads=cfg.ssm_heads, n_groups=cfg.ssm_groups,
                eps=cfg.rms_eps)
        elif kind == "E":
            y = moe.sparse_moe(p_l["moe"], h, cfg.n_experts_per_tok,
                               cfg.routed_scaling, cfg.norm_topk_prob,
                               first=cfg.experts_here.start)
        elif kind == "K":
            y = kda.kda_forward(p_l["kda"], h, n_heads=cfg.kda_heads,
                                head_dim=cfg.kda_head_dim,
                                chunk=cfg.kda_chunk, eps=cfg.rms_eps)
        elif kind == "L":
            y = tf.mla_mixer(p_l["mla"], cfg, h)
        elif kind == "-":
            y = layers.mlp(p_l["mlp"], h)
        else:
            y = tf.attention_mixer(p_l["attn"], cfg, h)
        return x + y

    def _pattern_stack(self, x, remat):
        for kind, p_l in zip(self.cfg.layer_pattern, self.layers):
            x = _maybe_remat(functools.partial(self._pattern_layer, kind,
                                               p_l), remat)(x)
        return x

    def _no_cache(self) -> None:
        if self.cfg.family == "pattern":
            raise NotImplementedError(
                f"{self.cfg.name}: the pattern family has no decode cache "
                "yet (SSM state beside KV); hidden_states, loss_lm and "
                "risk_scores run it")

    def _encoder(self, src: Tensor, remat) -> Tensor:
        cfg = self.cfg
        h = src.to(self.dt)
        pos = self._positions({}, h)
        for p_l in self.enc_layers:
            body = functools.partial(self._block, p_l, -1, cfg.rope_theta,
                                     False, causal=False)
            h, _, _ = _maybe_remat(body, remat)(h, pos)
        return layers.rmsnorm(self.enc_norm, h, cfg.rms_eps)

    def _decoder_cross_stack(self, x, enc, want_kv: bool, remat):
        pos = self._positions({}, x)
        kvs = []
        for p_l in self.layers:
            body = functools.partial(self._block, p_l, -1,
                                     self.cfg.rope_theta, want_kv)
            x, _, kv = _maybe_remat(body, remat)(x, pos, enc)
            kvs.append(kv)
        return x, kvs

    def _stack(self, batch, remat, want_cache: bool):
        """(x (B, S, D) before the final norm, aux, cache parts)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "encdec":
            enc = self._encoder(batch["src_embeds"], remat)
            x = self._lookup(batch["tokens"])
            x, kvs = self._decoder_cross_stack(x, enc, want_cache, remat)
            return x, aux, (kvs, enc)
        x = self._embed_in(batch)
        if cfg.family in DECODERS:
            return self._decoder_stack(x, self._positions(batch, x),
                                       want_cache, remat)
        if cfg.family == "ssm":
            x, states = self._ssm_stack(x, want_cache, remat)
            return x, aux, states
        if cfg.family == "pattern":
            # the sigmoid router has no aux loss
            return self._pattern_stack(x, remat), aux, None
        x, parts = self._hybrid_stack(x, self._positions(batch, x),
                                      want_cache, remat)
        return x, aux, parts

    def hidden_states(self, batch: Dict[str, Tensor],
                      remat=True) -> Tuple[Tensor, Tensor]:
        """(hidden (B, S, D) after the final norm, aux) for a batch on the
        model's device: ``tokens`` (B, S), or the stub frontend's
        ``embeds`` (B, S, D) with optional ``positions``; an
        encoder-decoder's ``src_embeds`` (B, S_src, D) and ``tokens``.
        aux is the MoE load-balancing loss summed over the layers (0
        without experts); ``remat`` as ``_maybe_remat`` reads it, per
        layer."""
        x, aux, _ = self._stack(batch, remat, want_cache=False)
        return layers.rmsnorm(self.final_norm, x, self.cfg.rms_eps), aux

    # ------------------------------------------------------------------
    # Objectives
    # ------------------------------------------------------------------
    def loss_lm(self, batch: Dict[str, Tensor], remat=True):
        hidden, aux = self.hidden_states(batch, remat=remat)
        logits = self._logits(hidden).float()
        labels = batch["labels"].long()
        if isinstance(logits, DTensor):
            lse, gold = _vocab_parallel_terms(logits, labels)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = (lse - gold).mean()
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def risk_from_pooled(self, pooled: Tensor) -> Tensor:
        """The Cox head on mean-pooled float32 features (B, D) -> (B,)."""
        if self.cox_head is None:
            raise ValueError("the model has no Cox head: deep.init_state "
                             "attaches one")
        return pooled @ self.cox_head["w"][:, 0] + self.cox_head["b"]

    def risk_scores(self, batch: Dict[str, Tensor], remat=True):
        """Deep-survival head: mean-pool every position of the final hidden
        state (no mask) -> risk (B,), and aux."""
        hidden, aux = self.hidden_states(batch, remat=remat)
        return self.risk_from_pooled(hidden.mean(dim=1).float()), aux

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, src_len: int = 0):
        """A zeroed decode cache, length 0, for ``batch`` sequences of up
        to ``max_len`` positions (a sliding-window cache holds at most the
        window) and, for an encoder-decoder, ``src_len`` source frames
        (``max_len`` when 0): the reference's ``init_cache_specs`` shapes.
        A model whose parameters are DTensors gets its cache on their mesh,
        placed by ``launch.sharding.cache_spec``."""
        self._no_cache()
        cache = self._cache(batch, max_len, src_len or max_len, self.device)
        if isinstance(self.embed, DTensor):
            from ..launch import sharding
            cache = sharding.shard_cache(cache, self.embed.device_mesh)
        return cache

    def _cache(self, batch: int, max_len: int, src_len: int, dev):
        cfg, dt = self.cfg, self.dt
        if cfg.family in DECODERS:
            return tf.init_kv_cache(cfg, cfg.n_layers, batch, max_len, dt,
                                    dev)
        length = torch.zeros(batch, dtype=torch.int32, device=dev)
        kv = (batch, tf.cache_slots(cfg, max_len), cfg.n_kv_heads,
              cfg.head_dim)
        if cfg.family == "encdec":
            xkv = (cfg.n_layers, batch, src_len, cfg.n_kv_heads,
                   cfg.head_dim)
            return EncDecCache(
                *(torch.zeros((cfg.n_layers,) + kv, dtype=dt, device=dev)
                  for _ in range(2)),
                *(torch.zeros(xkv, dtype=dt, device=dev) for _ in range(2)),
                length)
        conv, state = self._conv_spec(batch), self._state_spec(batch)
        conv = torch.zeros(conv.shape, dtype=conv.dtype, device=dev)
        state = torch.zeros(state.shape, dtype=state.dtype, device=dev)
        if cfg.family == "ssm":
            return SSMCache(conv, state, length)
        g = cfg.n_layers // cfg.shared_attn_every
        return HybridCache(conv, state, *(
            torch.zeros((g,) + kv, dtype=dt, device=dev) for _ in range(2)),
            length)

    # ------------------------------------------------------------------
    # Cache + input specs (for the dry run): tensors on the meta device,
    # shapes and dtypes without storage
    # ------------------------------------------------------------------
    def init_cache_specs(self, batch: int, max_len: int):
        """The decode cache of ``init_cache(batch, max_len)`` on the meta
        device: the reference's ``init_cache_specs`` shapes and dtypes (an
        encoder-decoder's source as long as ``max_len``)."""
        self._no_cache()
        return self._cache(batch, max_len, self._src_len(max_len), _META)

    def _conv_spec(self, batch: int) -> Tensor:
        cfg = self.cfg
        d_inner = cfg.ssm_expand * cfg.d_model
        return torch.empty(cfg.n_layers, batch, CONV_TAIL,
                           d_inner + 2 * cfg.ssm_state, dtype=self.dt,
                           device=_META)

    def _state_spec(self, batch: int) -> Tensor:
        """The SSM state, float32 whatever the model's dtype."""
        cfg = self.cfg
        d_inner = cfg.ssm_expand * cfg.d_model
        return torch.empty(cfg.n_layers, batch, d_inner // cfg.ssm_head_dim,
                           cfg.ssm_head_dim, cfg.ssm_state,
                           dtype=torch.float32, device=_META)

    @staticmethod
    def _src_len(tgt_len: int) -> int:
        return tgt_len  # encdec shapes: source frames match target length

    def make_input_specs(self, shape) -> Dict[str, Tensor]:
        """A batch of meta tensors for a ``ShapeSpec`` cell (no storage):
        tokens (B, 1) for decode; else tokens, or the stub frontend's
        embeds (B, S, D) (and (3, B, S) M-RoPE positions), or an
        encoder-decoder's source frames and tokens; labels for train."""
        cfg, dt = self.cfg, self.dt
        b, s = shape.global_batch, shape.seq_len

        def spec(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device=_META)

        if shape.kind == "decode":
            return {"tokens": spec(b, 1)}
        batch: Dict[str, Tensor] = {}
        if cfg.family == "encdec":
            batch["src_embeds"] = spec(b, s, cfg.d_model, dtype=dt)
            batch["tokens"] = spec(b, s)
        elif cfg.frontend in ("audio", "vision"):
            batch["embeds"] = spec(b, s, cfg.d_model, dtype=dt)
            if cfg.mrope_sections:
                batch["positions"] = spec(3, b, s)
        else:
            batch["tokens"] = spec(b, s)
        if shape.kind == "train":
            batch["labels"] = spec(b, s)
        return batch

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Tensor], max_len: int = 0):
        """Full-sequence forward that also builds the decode cache: (the
        last position's logits (B, V_pad), cache).

        ``max_len``: cache capacity (room for decode); S + 128 when 0, never
        less than S. A sliding-window cache holds min(capacity, window)
        slots, whatever the prompt's length."""
        self._no_cache()
        cfg = self.cfg
        x, _, parts = self._stack(batch, False, want_cache=True)
        hidden = layers.rmsnorm(self.final_norm, x, cfg.rms_eps)
        logits = self._logits(hidden[:, -1])
        b, s = hidden.shape[:2]
        cap = max(max_len if max_len > 0 else s + 128, s)
        kvs, states, enc = [], [], None
        if cfg.family in DECODERS:
            kvs = parts
        elif cfg.family == "ssm":
            states = parts
        elif cfg.family == "hybrid":
            kvs, states = parts
        else:
            kvs, enc = parts
        cache = self.init_cache(b, cap, src_len=0 if enc is None
                                else enc.shape[1])
        if enc is not None:
            for l, p_l in enumerate(self.layers):
                xk, xv = tf.cross_kv(p_l, cfg, enc)
                cache.xk[l].copy_(xk)
                cache.xv[l].copy_(xv)
        for l, (k, v) in enumerate(kvs):
            tf.prefill_cache_kv(cache.k[l], cache.v[l], k, v)
        for l, st in enumerate(states):
            cache.conv[l].copy_(st.conv)
            cache.state[l].copy_(st.ssm)
        cache.length.fill_(s)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: Tensor):
        """One token for every sequence. tokens: (B, 1). Writes the cache
        in place and returns (logits (B, V_pad), the cache with length + 1);
        the cache passed in is spent."""
        self._no_cache()
        cfg = self.cfg
        x = self._scale_embeds(self._lookup(tokens))
        cur = cache.length
        if cfg.family in DECODERS:
            for l, (p_l, w_l, th_l) in enumerate(
                    zip(self.layers, self.windows, self.thetas)):
                x = tf.block_decode(p_l, cfg, x, cur, int(w_l), float(th_l),
                                    cache.k[l], cache.v[l])
        elif cfg.family == "encdec":
            for l, p_l in enumerate(self.layers):
                x = tf.block_decode(p_l, cfg, x, cur, -1, cfg.rope_theta,
                                    cache.k[l], cache.v[l],
                                    enc_kv=(cache.xk[l], cache.xv[l]))
        else:
            for l, p_l in enumerate(self.layers):
                y, st = ssm.mamba2_decode_step(
                    p_l["mamba"], layers.rmsnorm(p_l["ln"], x, cfg.rms_eps),
                    ssm.SSMState(conv=cache.conv[l], ssm=cache.state[l]),
                    d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                    expand=cfg.ssm_expand, eps=cfg.rms_eps)
                x = x + y
                cache.conv[l].copy_(st.conv)
                cache.state[l].copy_(st.ssm)
                if cfg.family == "hybrid" \
                        and (l + 1) % cfg.shared_attn_every == 0:
                    g = l // cfg.shared_attn_every
                    x = tf.block_decode(self.shared, cfg, x, cur, -1,
                                        cfg.rope_theta, cache.k[g],
                                        cache.v[g])
        hidden = layers.rmsnorm(self.final_norm, x, cfg.rms_eps)
        return self._logits(hidden[:, 0]), cache._replace(length=cur + 1)


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> Model:
    return Model(cfg, device=device, generator=generator)
