"""Model dispatch: one ``nn.Module`` over the backbone families of the
pool that the port runs so far, ``dense`` (decoder-only transformers) and
``ssm`` (Mamba2 stacks).

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
``jax.checkpoint`` of its scanned layer body does. Not yet ported (ROADMAP
A8b): the ``moe``, ``hybrid``, ``encdec`` and ``vlm`` families, in
training too, and ``prefill`` and ``decode_step`` with their caches.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from .. import device as _device
from ..configs.base import ModelConfig
from . import layers, ssm, transformer as tf

Tensor = torch.Tensor

FAMILIES = ("dense", "ssm")
NOT_PORTED = "not ported yet: ROADMAP A8b"


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


class Model(nn.Module):
    """Backbone, final norm and LM head, and, once ``deep.init_state`` has
    attached it, the Cox head ``cox_head`` ({"w": (D, 1), "b": ()})."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is {NOT_PORTED}")
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
            [self._init_layer(dev) for _ in range(cfg.n_layers)])
        self.cox_head: Optional[nn.ParameterDict] = None
        self.windows, self.thetas = tf.attention_pattern(cfg, cfg.n_layers)
        if generator is not None:
            self.reset_parameters(generator)

    def _init_layer(self, dev) -> nn.ModuleDict:
        cfg = self.cfg
        if cfg.family == "dense":
            return tf.init_block(cfg, self.dt, dev)
        return nn.ModuleDict({
            "ln": layers.init_rmsnorm(cfg.d_model, self.dt, dev),
            "mamba": ssm.init_mamba2(cfg.d_model, cfg.ssm_state,
                                     cfg.ssm_head_dim, cfg.ssm_expand,
                                     dtype=self.dt, device=dev)})

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
    def _embed_in(self, batch) -> Tensor:
        x = self.embed[batch["tokens"].long()]
        if self.cfg.name.startswith("gemma"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dt,
                                 device=x.device)
        return x

    def _logits(self, hidden: Tensor) -> Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        logits = hidden @ head
        v = self.cfg.vocab_size
        if self.cfg.vocab_padded != v:
            pad = torch.arange(self.cfg.vocab_padded,
                               device=logits.device) >= v
            logits = torch.where(pad, -1e30, logits.float())
        return logits

    # ------------------------------------------------------------------
    # Hidden states
    # ------------------------------------------------------------------
    def _dense_layer(self, p_l, window: int, theta: float, x: Tensor,
                     pos: Tensor):
        return tf.block_forward(p_l, self.cfg, x, pos, window, theta)

    def _ssm_layer(self, p_l, x: Tensor) -> Tensor:
        cfg = self.cfg
        return x + ssm.mamba2_forward(
            p_l["mamba"], layers.rmsnorm(p_l["ln"], x, cfg.rms_eps),
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand, chunk=cfg.ssm_chunk)

    def hidden_states(self, batch: Dict[str, Tensor],
                      remat=True) -> Tuple[Tensor, Tensor]:
        """(hidden (B, S, D) after the final norm, aux) for a batch of
        ``tokens`` (B, S) on the model's device; ``remat`` as
        ``_maybe_remat`` reads it, per layer."""
        cfg = self.cfg
        x = self._embed_in(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "dense":
            b, s = x.shape[:2]
            pos = torch.arange(s, device=x.device)[None, :].expand(b, s)
            for p_l, w_l, th_l in zip(self.layers, self.windows, self.thetas):
                body = _maybe_remat(functools.partial(
                    self._dense_layer, p_l, int(w_l), float(th_l)), remat)
                x, a = body(x, pos)
                aux = aux + a
        else:
            for p_l in self.layers:
                x = _maybe_remat(functools.partial(self._ssm_layer, p_l),
                                 remat)(x)
        return layers.rmsnorm(self.final_norm, x, cfg.rms_eps), aux

    # ------------------------------------------------------------------
    # Objectives
    # ------------------------------------------------------------------
    def loss_lm(self, batch: Dict[str, Tensor], remat=True):
        hidden, aux = self.hidden_states(batch, remat=remat)
        logits = self._logits(hidden).float()
        labels = batch["labels"].long()
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

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(f"prefill is {NOT_PORTED}")

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError(f"decode_step is {NOT_PORTED}")


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None) -> Model:
    return Model(cfg, device=device, generator=generator)
