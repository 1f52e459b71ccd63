"""The seeded input makers: the same seed gives the same inputs, another
seed others, and seeds past 32 bits work."""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness  # noqa: E402
from perfbench.data import appc, mamba2_weights, survival_text  # noqa: E402

BIG = 2 ** 31 + 12345
CFG = {"n": 2000, "p": 30, "k": 3, "rho": 0.9, "s": 0.1,
       "censor_scale": 1.0}


def test_appc_repeats_by_seed():
    a = appc.make(CFG, harness.torch_seed(BIG), "cpu")
    b = appc.make(CFG, harness.torch_seed(BIG), "cpu")
    c = appc.make(CFG, harness.torch_seed(BIG + 1), "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.x, c.x)
    assert a.x.shape == (2000, 30) and a.x.dtype == torch.float32
    assert a.beta_star.sum() == 3 and a.beta_star[9] == 1.0
    # AR(1) columns: neighbours correlate at about rho
    r = np.corrcoef(a.x[:, 4].numpy(), a.x[:, 5].numpy())[0, 1]
    assert 0.85 < r < 0.95
    assert 0.0 < float(a.delta.mean()) < 1.0


def test_appc_times_keep_ties():
    co = appc.make({**CFG, "n": 262144, "p": 2}, harness.torch_seed(3),
                   "cpu")
    ties = co.t.numel() - torch.unique(co.t).numel()
    assert ties > 100


def test_tokens_repeat_by_seed_and_index():
    a = survival_text.batch(BIG, 3, 4, 64, 500)
    assert np.array_equal(a, survival_text.batch(BIG, 3, 4, 64, 500))
    assert not np.array_equal(a, survival_text.batch(BIG, 4, 4, 64, 500))
    assert not np.array_equal(a, survival_text.batch(BIG + 1, 3, 4, 64,
                                                     500))
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 500


def test_mamba2_weights_repeat_by_seed():
    cfg = {"d_model": 32, "n_layer": 2, "expand": 2, "d_state": 8,
           "headdim": 16, "ngroups": 1, "d_conv": 4, "vocab_size": 300,
           "dtype": "bfloat16"}
    a = mamba2_weights.make(cfg, harness.torch_seed(BIG), "cpu")
    b = mamba2_weights.make(cfg, harness.torch_seed(BIG), "cpu")
    c = mamba2_weights.make(cfg, harness.torch_seed(BIG + 1), "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].shape == (512, 32) and a["embed"].dtype == torch.bfloat16
    assert a["layers.1.mamba.a_log"].dtype == torch.float32
