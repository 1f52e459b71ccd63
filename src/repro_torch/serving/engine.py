"""Batched scoring engine over a SurvivalModel artifact.

The PyTorch counterpart of the JAX package's ``serving/engine.py``. Three
query types over model state kept on the device:

  * ``risk_scores``      exp(x beta)                       -> (b,)
  * ``survival_curves``  exp(-H0(t) exp(x beta))           -> (b, g)
  * ``median_survival``  first grid time with S(t|x) <= .5 -> (b,)

plus the fused ``score`` query (risk and median, and the curves when asked,
from one transfer and one curve panel per batch).

Sparse fast path: a model with support size k gathers only the k support
columns on the host and scores with ``beta_support``: O(b k) moved and
computed instead of O(b p).

Shape bucketing: batches are zero-padded up to the next power of two, so
each query kind sees at most log2(max_batch) shapes. The engine keeps one
built query callable per (kind, bucket, feature width) and counts each
build in ``compiles``, as the reference counts its jit compilations; here a
build is a Python closure, since PyTorch runs eagerly.

The curve panel of a single-stratum model runs through the
``survival_curves`` kernel. A stratified model keeps its (s, g) baseline
table on the device and runs through ``survival_curves_stratified``,
which reads each request's row inside the kernel; stratum indices are
padded with zeros to the bucket and checked on the host. ``x @ beta``
stays ``torch.matmul``.

Data-parallel scoring: ``shard=k`` (or ``"auto"``: ``$REPRO_DATA_SHARDS``,
else one shard per local card) splits every bucketed batch's rows over
the cards ``cuda:0`` .. ``cuda:k-1`` (clamped to the cards present; the CPU
is one shard), each holding the model state and running its rows through
the curve kernel; bucketing becomes per shard (bucket = shards *
next_pow2(ceil(b / shards))), so each shard sees a power-of-two block.
``shard=None`` (the default) scores on ``device`` alone.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from .. import device as _device
from ..kernels import ops
from ..launch import mesh as launch_mesh
from ..launch import runtime as launch_runtime
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs import trace
from .artifacts import SurvivalModel

_ETA_CLIP = 30.0

# shared across engines: build blowups (a bucketing regression) show up
# as a climbing counter, bucket skew as a lopsided histogram
_M_COMPILES = obs_metrics.REGISTRY.counter(
    "engine_jit_compiles_total", "query callables built", ("kind",))
_M_CALLS = obs_metrics.REGISTRY.counter(
    "engine_calls_total", "scoring calls", ("kind",))
_M_BUCKET = obs_metrics.REGISTRY.histogram(
    "engine_bucket_size", "padded power-of-two batch buckets hit",
    buckets=obs_metrics.POW2_BUCKETS)

def _next_pow2(b: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(b, 1)))), 0)


class ScoringEngine:
    """Batched scorer with shape-bucketed query callables."""

    def __init__(self, model: SurvivalModel, *,
                 use_sparse: Optional[bool] = None, max_sparse_k: int = 64,
                 shard: Union[int, str, None] = None, device="cuda"):
        self.device = _device.resolve(device)
        self.model = model
        if use_sparse is None:
            use_sparse = (model.is_sparse
                          and model.k is not None and model.k <= max_sparse_k)
        self.use_sparse = bool(use_sparse and model.is_sparse)
        # None -> one device; "auto" -> $REPRO_DATA_SHARDS or one shard per
        # local card; int -> explicit; both clamped to the cards present
        if shard is None:
            self._devices = [self.device]
        else:
            n = (launch_runtime.data_shards() or torch.cuda.device_count()
                 if shard == "auto" else int(shard))
            self._devices = launch_mesh.make_data_shards(n, self.device)
        self.shard = len(self._devices)
        self._support = (np.asarray(model.support)
                         if model.support is not None else None)
        beta = model.beta_support if self.use_sparse else model.beta
        # (beta, h0 (s, g), grid) on each shard's device
        self._state = [tuple(self._put(a, dev) for a in
                             (beta, model.base_cumhaz, model.time_grid))
                       for dev in self._devices]
        self._beta, self._h0, self._grid = self._state[0]
        self._cache: dict = {}
        self.compiles = 0
        self.calls = 0

    @staticmethod
    def _put(a, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # -- feature handling --------------------------------------------------

    @property
    def feature_dim(self) -> int:
        """Columns the matvec consumes (k on the sparse path)."""
        return len(self._support) if self.use_sparse else self.model.p

    def _gather(self, x: np.ndarray) -> np.ndarray:
        """Host-side support gather: accepts (b, p) full features or
        (b, k) pre-gathered ones on the sparse path."""
        x = np.atleast_2d(np.asarray(x, np.float32))
        if self.use_sparse and x.shape[1] == self.model.p:
            x = x[:, self._support]
        if x.shape[1] != self.feature_dim:
            raise ValueError(
                f"expected {self.feature_dim} or {self.model.p} features, "
                f"got {x.shape[1]}")
        return x

    def _pad(self, x: np.ndarray):
        b = x.shape[0]
        # per-shard pow-2 bucketing: every shard sees a power-of-two block
        bucket = self.shard * _next_pow2(-(-b // self.shard))
        if bucket != b:
            x = np.pad(x, ((0, bucket - b), (0, 0)))
        return x, b, bucket

    def _fn(self, kind: str, bucket: int):
        key = (kind, bucket, self.feature_dim)
        fn = self._cache.get(key)
        if fn is None:
            self.compiles += 1
            _M_COMPILES.inc(kind=kind)
            obs_events.emit("engine.compile", query=kind, bucket=bucket,
                            feature_dim=self.feature_dim,
                            cache_entries=len(self._cache))
            fn = [self._build(kind, h0, grid)
                  for _, h0, grid in self._state]
            self._cache[key] = fn
        return fn

    # -- query bodies --------------------------------------------------------

    def _build(self, kind: str, h0: torch.Tensor, grid: torch.Tensor):
        stratified = h0.shape[0] > 1

        def eta_of(xb, beta):
            return torch.clamp(xb @ beta, -_ETA_CLIP, _ETA_CLIP)

        def curves(xb, beta, strata):
            if stratified:
                return ops.survival_curves_stratified(xb @ beta, h0, strata)
            return ops.survival_curves(xb @ beta, h0[0])

        def median_of(s):
            below = s <= 0.5
            hit = torch.any(below, dim=1)
            idx = torch.argmax(below.to(torch.uint8), dim=1)
            return torch.where(hit, grid[idx], torch.inf)

        if kind == "risk":
            def fn(xb, beta, strata):
                return torch.exp(eta_of(xb, beta))
        elif kind == "curves":
            fn = curves
        elif kind == "median":
            def fn(xb, beta, strata):
                return median_of(curves(xb, beta, strata))
        elif kind in ("score", "score_curves"):
            def fn(xb, beta, strata):
                s = curves(xb, beta, strata)
                out = (torch.exp(eta_of(xb, beta)), median_of(s))
                return out + ((s,) if kind == "score_curves" else ())
        else:
            raise ValueError(kind)
        return fn

    def _run(self, kind: str, x, strata):
        with trace.span("engine.score", device_time=True,
                        kind=kind) as sp_span:
            xp, b, bucket = self._pad(self._gather(x))
            sp = np.zeros(bucket, np.int32)
            if strata is not None:
                s = np.asarray(strata, np.int32)
                if s.size and (s.min() < 0 or s.max() >= self.model.n_strata):
                    # the kernel reads h0[strata] unchecked on the device
                    raise ValueError(
                        f"stratum indices must be in [0, {self.model.n_strata})"
                        f", got range [{s.min()}, {s.max()}]")
                sp[:b] = s
            self.calls += 1
            _M_CALLS.inc(kind=kind)
            _M_BUCKET.observe(bucket)
            sp_span.set(b=b, bucket=bucket)
            fns = self._fn(kind, bucket)
            rows = bucket // self.shard
            outs = []
            # every shard launches before any result is read back
            for i, (dev, fn, (beta, _, _)) in enumerate(
                    zip(self._devices, fns, self._state)):
                with torch.cuda.device(dev) if dev.type == "cuda" \
                        else contextlib.nullcontext():
                    xb = torch.as_tensor(xp[i * rows:(i + 1) * rows],
                                         device=dev)
                    # a single-stratum model reads no strata: nothing to
                    # move
                    st = (torch.as_tensor(sp[i * rows:(i + 1) * rows],
                                          device=dev)
                          if self.model.n_strata > 1 else None)
                    out = fn(xb, beta, st)
                outs.append(out if isinstance(out, tuple) else (out,))
            got = tuple(np.concatenate([o[j].cpu().numpy() for o in outs])[:b]
                        for j in range(len(outs[0])))
            return got if isinstance(out, tuple) else got[0]

    # -- public API --------------------------------------------------------

    def risk_scores(self, x: np.ndarray) -> np.ndarray:
        """exp(x beta) for a (b, p) or pre-gathered (b, k) batch."""
        return self._run("risk", x, None)

    def survival_curves(self, x: np.ndarray,
                        strata: Optional[np.ndarray] = None) -> np.ndarray:
        """(b, g) S(t|x) on the model grid. ``strata`` are baseline row
        indices (positions in model.strata_labels), default stratum 0."""
        return self._run("curves", x, strata)

    def median_survival(self, x: np.ndarray,
                        strata: Optional[np.ndarray] = None) -> np.ndarray:
        """First grid time where S(t|x) drops to 1/2 (inf if never)."""
        return self._run("median", x, strata)

    def score(self, x: np.ndarray, strata: Optional[np.ndarray] = None,
              with_curves: bool = False):
        """Fused service query: (risk, median[, curves]) from one call —
        one host->device transfer and one curve panel per batch."""
        return self._run("score_curves" if with_curves else "score",
                         x, strata)

    def prewarm(self, batch_sizes=(1, 64), kinds=("score",),
                strata: bool = False) -> int:
        """Build (and run once, on zeros) the buckets a service will hit,
        so the first live request never pays the build. ``batch_sizes`` are
        rounded up to their pow-2 buckets; duplicates build once. With
        ``strata`` a stratified model runs with stratum indices, as its
        requests will. Returns the number of fresh builds."""
        before = self.compiles
        seen = set()
        for b in batch_sizes:
            _, _, bucket = self._pad(np.zeros((int(b), 1), np.float32))
            if bucket in seen:
                continue
            seen.add(bucket)
            x = np.zeros((bucket, self.feature_dim), np.float32)
            s = (np.zeros(bucket, np.int32)
                 if strata and self.model.n_strata > 1 else None)
            for kind in kinds:
                self._run(kind, x, s)
        return self.compiles - before

    def cache_info(self) -> dict:
        return {"entries": len(self._cache), "compiles": self.compiles,
                "calls": self.calls, "shard": self.shard}
