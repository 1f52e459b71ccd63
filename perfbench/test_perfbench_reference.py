"""Each plain reference against the program's plain path on the CPU, at
tiny sizes: the Cox references in float64 (tied times included) and the
Mamba2 featurizer in float32."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402
from perfbench.data import appc, mamba2_weights, survival_text  # noqa: E402
from perfbench.drivers import featurize  # noqa: E402
from perfbench.reference import cox as ref, mamba2  # noqa: E402

CFG = {"n": 500, "p": 10, "k": 2, "rho": 0.9, "s": 0.1, "censor_scale": 1.0}


@pytest.fixture(scope="module")
def cohort():
    co = appc.make(CFG, harness.torch_seed(11), "cpu")
    # coarse times: many ties
    t = torch.round(co.t * 50) / 50
    return co._replace(t=t)


def _program_data(co):
    from repro_torch.core import cox

    return cox.prepare(co.x.double(), co.t, co.delta, device="cpu")


def test_constants(cohort):
    from repro_torch.core import cox

    d = ref.prepare(cohort.x, cohort.t, cohort.delta, torch.float64)
    data = _program_data(cohort)
    l2, _ = cox.lipschitz_constants(data)
    assert torch.allclose(ref.lipschitz_l2(d, block=3), l2, rtol=1e-12)


def test_beam_search_against_the_program(cohort):
    from repro_torch.core import beam

    d = ref.prepare(cohort.x, cohort.t, cohort.delta, torch.float64)
    supports, betas, losses = ref.beam_search(d, 3, 3, 4, 1e-3, 4, 20)
    res = beam.beam_search(_program_data(cohort), k=3, beam_width=3,
                           n_expand=4, lam2=1e-3, score_steps=4,
                           finetune_sweeps=20, use_kernel=False,
                           device="cpu")
    assert [tuple(s) for s in res.supports] == supports
    np.testing.assert_allclose(res.losses, losses, rtol=1e-12)
    for a, b in zip(res.betas, betas):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)


def test_mamba2_against_the_program():
    cfg = {"name": "mamba2-130m", "program_arch": "mamba2-130m",
           "d_model": 64, "n_layer": 2, "expand": 2, "d_state": 16,
           "headdim": 16, "ngroups": 1, "d_conv": 4, "vocab_size": 300,
           "rms_norm_eps": 1e-6,
           "dtype": "float32"}
    cell = harness.Cell(name="t", workload={}, config=cfg,
                        traffic={"batch": 3, "seq": 40}, seed=5,
                        device="cpu")
    w = mamba2_weights.make(cfg, 5, "cpu")
    model = featurize.build(cell, w)
    toks = survival_text.batch(5, 0, 3, 40, 300)
    from repro_torch.survival import deep

    risk, feats = deep.make_featurizer(model)({"tokens": toks})
    f_ref, r_ref = mamba2.features(w, torch.as_tensor(toks), cfg, block=2)
    torch.testing.assert_close(feats, f_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(risk, r_ref, rtol=1e-4, atol=1e-5)
