"""Deterministic, restart-safe data pipeline.

The PyTorch port's counterpart of the JAX package's ``data/pipeline.py``.
Batches are generated per step on the host, in numpy, from a seed derived
via ``fault_tolerance.DataSkipper``, so a restarted run reproduces the exact
stream and both packages draw the same arrays. ``put_batch`` moves a host
batch onto the model's device, or shards it over a mesh. Synthetic token
streams and survival-labelled sequence tasks stand in for corpora (no
external data offline).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..train.fault_tolerance import DataSkipper


class TokenTaskStream:
    """Synthetic autoregressive task: integer sequences with learnable
    structure (a noisy modular-progression) — loss decreases measurably
    within a few hundred steps on a ~100M model."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = batch
        self.skipper = DataSkipper(seed)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.skipper.seed_for_step(step))
        start = rng.integers(0, self.vocab, size=(self.batch, 1))
        stride = rng.integers(0, 4, size=(self.batch, 1))
        pos = np.arange(self.seq + 1)[None, :]
        toks = (start + stride * pos) % self.vocab
        noise = rng.integers(0, self.vocab, size=toks.shape)
        mask = rng.random(toks.shape) < 0.02
        toks = np.where(mask, noise, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class SurvivalTextStream:
    """Synthetic deep-survival task: token sequences whose (hidden) hazard
    depends on the frequency of a few marker tokens — the backbone must
    learn to count them; the CPH head turns that into risk."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 n_markers: int = 4):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = batch
        self.markers = np.arange(1, 1 + n_markers)
        self.weights = np.linspace(1.0, 2.0, n_markers)
        self.skipper = DataSkipper(seed + 77)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.skipper.seed_for_step(step))
        toks = rng.integers(0, self.vocab, size=(self.batch, self.seq))
        # plant markers with per-sample intensity
        intensity = rng.random((self.batch, 1)) * 0.2
        plant = rng.random(toks.shape) < intensity
        which = rng.integers(0, len(self.markers), size=toks.shape)
        toks = np.where(plant, self.markers[which], toks).astype(np.int32)
        counts = np.stack([(toks == m).mean(axis=1) for m in self.markers],
                          axis=1)
        risk = counts @ self.weights * 40.0 - 2.0
        v = rng.uniform(1e-9, 1.0, size=self.batch)
        t_event = (-np.log(v) / np.exp(np.clip(risk, -20, 20))) ** 0.3
        c = rng.uniform(0, np.quantile(t_event, 0.85), size=self.batch)
        event = (t_event <= c).astype(np.float32)
        t_obs = np.minimum(t_event, c).astype(np.float32)
        return {"tokens": toks, "time": t_obs, "event": event}


def put_batch(batch: Dict[str, np.ndarray],
              mesh_or_device) -> Dict[str, torch.Tensor]:
    """The host batch as tensors, each keeping its dtype: on a device (the
    model's), or on a ``DeviceMesh`` as DTensors with the batch dim over
    the data axes (``launch.sharding.batch_spec``); every rank passes the
    whole batch and keeps its own rows."""
    if isinstance(mesh_or_device, (str, torch.device)):
        return {k: torch.as_tensor(v, device=mesh_or_device)
                for k, v in batch.items()}
    from ..launch import sharding

    shardings = sharding.batch_shardings(batch, mesh_or_device)
    return {k: v if isinstance(v, sharding.DTensor) else
            sharding.distribute(torch.as_tensor(v), shardings[k])
            for k, v in batch.items()}
