"""The ``cox_coord`` kernel's candidate axis and its fused surrogate step
on a CUDA card, against single calls of the same kernel and the eager
step; every test here skips without a card (a CUDA kernel has no CPU
mode). Run them on a card with

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_kernels_card.py

This file imports no JAX: the card's machine has none.

- the batched ``cox_coord`` over C in {1, 3, 40} candidates equals C
  single calls bit for bit, on tied and tie-free data, with n not a
  multiple of the 1,024-sample tile;
- the fused step's g equals a single call's on the same eta, its step
  ``surrogate.quad_min`` of that g within 1 ulp, and the pending eta
  update the eager ``addcmul_`` within 1 ulp;
- a batched call adds C to ``launch_counts()["cox_coord"]``;
- the batched finetune on the card equals per-candidate plain finetunes
  on the card within float32 tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import beam, cox, surrogate  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival,
                                        make_tied_survival)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cox_coord import cox_coord  # noqa: E402

pytestmark = pytest.mark.card

# not multiples of the kernel's 1,024-sample tile
N_TIED, N_FREE = 9_000, 70_001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(kind, card):
    if kind == "tied":
        x, t, delta = make_tied_survival(n=N_TIED, p=48, n_times=40, seed=5)
    else:
        x, t, delta, _ = make_correlated_survival(
            SyntheticSpec(n=N_FREE, p=48, k=4, rho=0.9, seed=2))
    return cox.prepare(x.astype(np.float32), t, delta, device=card)


def _etas(c, n, card, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (0.8 * torch.randn(c, n, generator=g)).to(card)


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
@pytest.mark.parametrize("c", [1, 3, 40])
@pytest.mark.parametrize("order", [2, 3])
def test_candidates_equal_single_calls_bit_for_bit(card, kind, c, order):
    data = _data(kind, card)
    groups = ops.group_events(data.delta, data.risk_start)
    eta = _etas(c, data.n, card)
    x = data.xT[torch.arange(c, device=card) % data.p].contiguous()
    got = cox_coord(eta, x, data.delta, data.risk_start, order,
                    groups).clone()
    assert got.shape == (c, 3)
    for r in range(c):
        one = cox_coord(eta[r], x[r], data.delta, data.risk_start, order,
                        groups)
        assert torch.equal(got[r], one), (r, got[r], one)


def _ulps(a, b):
    a, b = (t.double().cpu() for t in (a, b))
    return ((a - b).abs() / torch.finfo(torch.float32).eps
            / b.abs().clamp(min=1e-30)).max().item()


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
def test_fused_step_is_the_eager_step(card, kind):
    data = _data(kind, card)
    groups = ops.group_events(data.delta, data.risk_start)
    c, s, lam2 = 5, 3, 1e-3
    cols = torch.randperm(data.p, generator=torch.Generator().manual_seed(1)
                          )[: c * s].view(c, s).to(card)
    rows = data.xT[cols]
    curv = (torch.rand(c, s, generator=torch.Generator().manual_seed(2))
            + 0.5).to(card)
    eta = _etas(c, data.n, card, seed=3)
    beta = (0.1 * torch.randn(c, s, generator=torch.Generator()
                              .manual_seed(4))).to(card)
    step = torch.zeros(c, device=card)
    for j, prev in ((0, None), (1, 0), (2, 1), (0, 2)):
        eta0, beta0, step0 = eta.clone(), beta.clone(), step.clone()
        out = ops.cox_coord_step(eta, rows, j, prev, beta, curv, step,
                                 data.delta, groups, lam2).clone()
        if prev is not None:
            want_eta = eta0.addcmul(rows[:, prev], step0[:, None])
            assert _ulps(eta, want_eta) <= 1.0
        else:
            assert torch.equal(eta, eta0)
        for r in range(c):
            one = cox_coord(eta[r], rows[r, j], data.delta,
                            data.risk_start, 2, groups)
            assert torch.equal(out[r], one), (j, r)
            d = surrogate.quad_min(out[r, 0] + 2.0 * lam2 * beta0[r, j],
                                   curv[r, j])
            assert _ulps(step[r], d) <= 1.0, (j, r, step[r], d)
            assert _ulps(beta[r, j], beta0[r, j] + d) <= 1.0
        others = [q for q in range(s) if q != j]
        assert torch.equal(beta[:, others], beta0[:, others])


@pytest.mark.parametrize("c", [1, 3, 40])
def test_a_batched_call_counts_c_launches(card, c):
    data = _data("tied", card)
    groups = ops.group_events(data.delta, data.risk_start)
    eta = _etas(c, data.n, card)
    rows = data.xT[torch.arange(2 * c, device=card) % data.p].view(
        c, 2, data.n).contiguous()
    ops.reset_launch_counts()
    cox_coord(eta, rows[:, 0].contiguous(), data.delta, data.risk_start, 2,
              groups)
    assert ops.launch_counts()["cox_coord"] == c
    ops.cox_coord_step(eta, rows, 1, 0, torch.zeros(c, 2, device=card),
                       torch.ones(c, 2, device=card),
                       torch.zeros(c, device=card), data.delta, groups,
                       1e-3)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cox_coord"] == 2 * c


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
def test_batched_finetune_matches_plain_finetunes(card, kind):
    data = _data(kind, card)
    supports = np.array([[0, 3, 7], [1, 3, 9], [2, 5, 40], [0, 1, 2]])
    betas, etas, losses = beam.finetune_batch(data, supports, 1e-3,
                                              n_sweeps=20)
    for r, supp in enumerate(supports):
        b, e, loss = beam.finetune(data, supp, np.ones(3), 1e-3, 3,
                                   n_sweeps=20, use_kernel=False)
        np.testing.assert_allclose(losses[r].item(), loss.item(),
                                   rtol=2e-5)
        np.testing.assert_allclose(betas[r].cpu(), b.cpu(), rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(etas[r].cpu(), e.cpu(), rtol=1e-3,
                                   atol=1e-4)
