"""SurvivalModel serving artifact: coefficients + baseline cumulative hazard.

The PyTorch counterpart of the JAX package's ``serving/artifacts.py``.
Turns a fitted CPH ``beta`` into everything a scoring engine needs:

  * ``beta`` (p,) plus, when the model is sparse, the support indices and
    the gathered ``beta_support`` (k,) for the O(k) fast path;
  * the Breslow (or Efron) cumulative baseline hazard evaluated on a fixed
    ``time_grid`` (g,), stored per stratum as ``base_cumhaz`` (n_strata, g)
    so ``S(t|x, s) = exp(-H0_s(t) * exp(x beta))`` is a gather + exp.

The baseline comes from the same O(n) suffix scans as training: with
w = exp(eta - m) and S0 at each sample's Breslow risk_start, the
per-sample cumulative hazard is ``cumsum(delta / S0) * exp(-m)``. Efron
replaces S0 by the tie-corrected ``S0 - (j/d) W_d`` within each tie group.
Like the reference, the artifact is computed in float32.

Persistence is the reference's format 2, byte for byte: one ``.npy`` per
array field plus a ``manifest.json`` carrying a sha256 per leaf, written
to a tmp dir that is atomically renamed. ``load`` verifies the checksums,
so a truncated or bit-flipped leaf raises ``ArtifactCorrupt``; format-1
manifests (no checksums) still load. Artifacts move between the two
packages both ways.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..core import cox

ARRAY_FIELDS = ("beta", "time_grid", "base_cumhaz", "support",
                "beta_support", "strata_labels")
_MANIFEST = "manifest.json"


class ArtifactCorrupt(RuntimeError):
    """A persisted SurvivalModel failed integrity checks on load."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class SurvivalModel:
    """Host-side serving artifact (numpy; the engine moves it to the card)."""

    beta: np.ndarray                       # (p,) dense coefficients
    time_grid: np.ndarray                  # (g,) fixed evaluation grid
    base_cumhaz: np.ndarray                # (n_strata, g) H0 per stratum
    ties: str = "breslow"                  # "breslow" | "efron"
    support: Optional[np.ndarray] = None   # (k,) int32 nonzero indices
    beta_support: Optional[np.ndarray] = None  # (k,) gathered coefficients
    strata_labels: Optional[np.ndarray] = None  # (n_strata,) original labels

    @property
    def p(self) -> int:
        return self.beta.shape[0]

    @property
    def n_grid(self) -> int:
        return self.time_grid.shape[0]

    @property
    def n_strata(self) -> int:
        return self.base_cumhaz.shape[0]

    @property
    def k(self) -> Optional[int]:
        return None if self.support is None else int(self.support.shape[0])

    @property
    def is_sparse(self) -> bool:
        return self.support is not None

    # -- persistence (npy-per-leaf, atomic rename) --------------------------

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"format": 2, "ties": self.ties, "arrays": {}}
        for name in ARRAY_FIELDS:
            arr = getattr(self, name)
            if arr is None:
                continue
            arr = np.asarray(arr)
            leaf = os.path.join(tmp, f"{name}.npy")
            np.save(leaf, arr)
            manifest["arrays"][name] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "sha256": _sha256_file(leaf)}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        # overwrite by renaming the live artifact aside first: a crash at
        # any point leaves either the old or the new dir fully intact
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        return path

    @classmethod
    def load(cls, path: str, verify: bool = True) -> "SurvivalModel":
        """Load an artifact, verifying per-leaf sha256 checksums when the
        manifest carries them (format >= 2). A missing, truncated, or
        bit-flipped leaf raises ``ArtifactCorrupt`` naming the leaf."""
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise ArtifactCorrupt(
                f"artifact {path!r}: unreadable manifest ({e})") from e
        arrays = {}
        for name, spec in manifest["arrays"].items():
            leaf = os.path.join(path, f"{name}.npy")
            if not os.path.exists(leaf):
                raise ArtifactCorrupt(
                    f"artifact {path!r}: missing leaf {name}.npy")
            want = spec.get("sha256") if isinstance(spec, dict) else None
            if verify and want is not None:
                got = _sha256_file(leaf)
                if got != want:
                    raise ArtifactCorrupt(
                        f"artifact {path!r}: checksum mismatch on "
                        f"{name}.npy (manifest {want[:12]}..., file "
                        f"{got[:12]}...) — truncated or corrupted leaf")
            try:
                arrays[name] = np.load(leaf)
            except (OSError, ValueError) as e:
                raise ArtifactCorrupt(
                    f"artifact {path!r}: unreadable leaf {name}.npy "
                    f"({e})") from e
        return cls(ties=manifest["ties"], **arrays)


# ---------------------------------------------------------------------------
# Baseline hazard estimation (O(n) suffix scans on the device)
# ---------------------------------------------------------------------------

def _cumhaz_samples(ts: torch.Tensor, delta: torch.Tensor, eta: torch.Tensor,
                    ties: str) -> torch.Tensor:
    """Per-sample cumulative baseline hazard on *time-sorted* data:
    H0_k = sum_{i <= k} delta_i / S0_i (Breslow) with the stabilized-w
    bookkeeping of cox.risk_stats. Returns (n,)."""
    m = torch.max(eta)
    w = torch.exp(eta - m)
    rc0 = cox.revcumsum(w)
    first = torch.searchsorted(ts, ts, side="left")
    s0 = rc0[first]
    if ties == "breslow":
        inc = delta / s0
    elif ties == "efron":
        # tie groups are contiguous on the sorted axis, so the per-group
        # quantities are O(n) segment sums via cumsum gathers at each
        # group's first/last index (no (n, n) tie matrix):
        #   j_rank = events strictly before me within my group
        #   wd     = group's event-hazard sum,  d_cnt = group's event count
        last = torch.searchsorted(ts, ts, side="right") - 1
        cd = torch.cumsum(delta, 0)
        cwd = torch.cumsum(delta * w, 0)
        j_rank = (cd - delta) - (cd[first] - delta[first])
        wd = cwd[last] - (cwd[first] - (delta * w)[first])
        d_cnt = torch.clamp(cd[last] - (cd[first] - delta[first]), min=1.0)
        s0_eff = s0 - (j_rank / d_cnt) * wd
        inc = delta / torch.clamp(s0_eff, min=1e-30)
    else:
        raise ValueError(f"unknown tie handling: {ties!r}")
    return torch.cumsum(inc, 0) * torch.exp(-m)


def _cumhaz_on_grid(t: np.ndarray, delta: np.ndarray, eta: np.ndarray,
                    grid: np.ndarray, ties: str,
                    dev: torch.device) -> np.ndarray:
    """H0 evaluated at each grid point (right-continuous step function)."""
    order = np.argsort(t, kind="stable")
    h_samples = _cumhaz_samples(
        torch.as_tensor(t[order], device=dev),
        torch.as_tensor(delta[order], device=dev),
        torch.as_tensor(eta[order], device=dev), ties).cpu().numpy()
    ts_np = np.asarray(t[order], np.float64)
    idx = np.searchsorted(ts_np, np.asarray(grid, np.float64),
                          side="right") - 1
    return np.where(idx >= 0, h_samples[np.clip(idx, 0, len(ts_np) - 1)],
                    0.0).astype(np.float32)


def fit_survival_model(x: np.ndarray, t: np.ndarray, delta: np.ndarray,
                       beta: np.ndarray, *,
                       strata: Optional[np.ndarray] = None,
                       time_grid: Optional[np.ndarray] = None,
                       grid_size: int = 128, ties: str = "breslow",
                       support_tol: float = 1e-8,
                       device="cuda") -> SurvivalModel:
    """Build the serving artifact from training data and a fitted beta.

    ``strata`` (n,) int labels produce one baseline row per stratum (risk
    sets never cross strata). The default ``time_grid`` spans the observed
    times with ``grid_size`` points. The scans run on ``device``, a card
    unless it is ``"cpu"``."""
    dev = _device.resolve(device)
    x = np.asarray(x, np.float32)
    t = np.asarray(t, np.float32)
    delta = np.asarray(delta, np.float32)
    beta = np.asarray(beta, np.float32)
    eta = (torch.as_tensor(x, device=dev)
           @ torch.as_tensor(beta, device=dev)).cpu().numpy()
    if time_grid is None:
        time_grid = np.linspace(float(t.min()), float(t.max()),
                                grid_size, dtype=np.float32)
    else:
        time_grid = np.asarray(time_grid, np.float32)

    strata_labels = None
    if strata is None:
        base = _cumhaz_on_grid(t, delta, eta, time_grid, ties, dev)[None, :]
    else:
        strata = np.asarray(strata)
        strata_labels = np.unique(strata)
        base = np.stack([
            _cumhaz_on_grid(t[strata == s], delta[strata == s],
                            eta[strata == s], time_grid, ties, dev)
            for s in strata_labels], axis=0)

    nz = np.flatnonzero(np.abs(beta) > support_tol)
    support = beta_support = None
    if len(nz) < beta.shape[0]:
        support = nz.astype(np.int32)
        beta_support = beta[nz]
    return SurvivalModel(beta=beta, time_grid=time_grid,
                         base_cumhaz=base.astype(np.float32), ties=ties,
                         support=support, beta_support=beta_support,
                         strata_labels=strata_labels)
