"""Back-to-back cardinality-constrained searches:
``repro_torch.core.beam.beam_search`` on one cohort. A unit is one whole
search over support sizes 1..k (its host reads end it).

Traffic keys: k, beam_width, n_expand, lam2, score_steps,
finetune_sweeps. Checked, for each support size of the last search:
- ``loss_gap``: its loss against the reference's best loss of that size,
  counted only where the program's is higher (a worse support chosen);
- ``finetune_gap``: its loss against the reference's finetune of the
  program's own support;
- ``beta_gap``: its beta against that finetune's beta;
the reference being ``reference/cox.py``'s beam search in float64."""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np

from perfbench import harness
from perfbench.data import appc
from perfbench.reference import cox as ref


@dataclasses.dataclass
class State:
    cell: Any
    cohort: Any
    data: Any = None
    result: Any = None


def _search(st: State, k: int):
    from repro_torch.core import beam

    tr = st.cell.traffic
    st.result = beam.beam_search(
        st.data, k=k, beam_width=tr["beam_width"], n_expand=tr["n_expand"],
        lam2=tr["lam2"], score_steps=tr["score_steps"],
        finetune_sweeps=tr["finetune_sweeps"], device=st.cell.device)


def setup(cell) -> State:
    from repro_torch.core import cox

    co = appc.make(cell.config, harness.torch_seed(cell.seed), cell.device)
    st = State(cell=cell, cohort=co)
    st.data = cox.prepare(co.x, co.t, co.delta, device=cell.device)
    _warm(st)
    return st


def _warm(st: State) -> None:
    """One pass of each piece a search runs, at its shapes: the constants,
    one beam's scoring (every panel, since each beam walks the same column
    blocks) and a one-sweep finetune of each support size."""
    import torch
    from repro_torch.core import beam, solvers

    tr = st.cell.traffic
    k, d = int(tr["k"]), st.data
    l2c, _, groups = solvers.constants(d, True)
    zero = torch.zeros(d.n, dtype=d.x.dtype, device=d.device)
    dec, _ = beam.score_candidates(d, zero, l2c, tr["lam2"],
                                   np.zeros(d.p, dtype=bool),
                                   steps=tr["score_steps"])
    dec.cpu()
    for size in range(1, k + 1):
        idx = np.zeros(k, dtype=np.int32)
        msk = np.zeros(k, dtype=np.float32)
        idx[:size] = np.arange(size)
        msk[:size] = 1.0
        _, _, loss = beam.finetune(d, idx, msk, tr["lam2"], k, n_sweeps=1,
                                   groups=groups)
        float(loss)


def window(st: State, seconds: float) -> dict:
    window_s, n, each = harness.units_window(
        lambda i: _search(st, int(st.cell.traffic["k"])), seconds)
    return {"window_s": window_s, "units": n, "unit_s": each,
            "attempted": n, "failed": 0,
            "e2e": {"search_s": window_s / n},
            "work": {"n": st.data.n, "p": st.data.p, "searches": n}}


def outputs(st: State) -> dict:
    r = st.result
    return {"supports": [tuple(int(i) for i in s) for s in r.supports],
            "betas": [np.asarray(b, np.float64) for b in r.betas],
            "losses": [float(v) for v in r.losses]}


def release(st: State) -> None:
    st.data = st.result = None


def reference(st: State, dtype=None, program: dict = None) -> dict:
    """The reference's search (float64), or the control's (``dtype``); with
    ``program``'s outputs also the reference's finetune of each of its
    supports."""
    import torch

    dtype = dtype or torch.float64
    tr = st.cell.traffic
    d = ref.prepare(st.cohort.x, st.cohort.t, st.cohort.delta, dtype)
    supports, betas, losses = ref.beam_search(
        d, int(tr["k"]), tr["beam_width"], tr["n_expand"], tr["lam2"],
        tr["score_steps"], tr["finetune_sweeps"])
    out = {"supports": supports, "betas": [b.numpy() for b in betas],
           "losses": losses}
    if program is not None:
        l2 = ref.lipschitz_l2(d)
        ft_b, ft_l = [], []
        for supp in program["supports"]:
            b, _, l_ = ref.finetune(d, [tuple(supp)], l2, tr["lam2"],
                                    tr["finetune_sweeps"])
            dense = np.zeros(d.xT.shape[0])
            dense[list(supp)] = b[0].double().cpu().numpy()
            ft_b.append(dense)
            ft_l.append(float(l_[0]))
        out["finetune_betas"], out["finetune_losses"] = ft_b, ft_l
    return out


def check(st: State, out: dict, ref_out: dict) -> List[harness.Check]:
    lim = st.cell.limits
    k = int(st.cell.traffic["k"])
    if len(out["losses"]) != k:
        return [harness.Check("sizes", float("inf"), 0.0)]
    loss_gap = max(max(a - b, 0.0) / abs(b)
                   for a, b in zip(out["losses"], ref_out["losses"]))
    ft_gap = max(abs(a - b) / abs(b) for a, b in
                 zip(out["losses"], ref_out["finetune_losses"]))
    beta_gap = max(harness.rel_gap(a, b) for a, b in
                   zip(out["betas"], ref_out["finetune_betas"]))
    return [harness.Check("loss_gap", loss_gap, lim["loss_gap"]),
            harness.Check("finetune_gap", ft_gap, lim["finetune_gap"]),
            harness.Check("beta_gap", beta_gap, lim["beta_gap"])]
