"""``correct`` on the CPU at sizes a test run holds, with the cells'
limits: a sound run comes out correct; the control (the reference put in
the program's place, one precision lower) and each fault a cell can
have, planted in the program under a whole run, come out not correct."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, tiny  # noqa: E402

CELLS = ("mamba2-featurize-512", "appc-select-beam")


@pytest.fixture(scope="module")
def run():
    return tiny.run_module()


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(run, bench, name):
    line = run.execute(tiny.cell(name), 0.3, bench)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference computed one precision below the configuration's in
    the program's place fails one of the cell's numbers."""
    c = tiny.cell(name)
    drv = harness.driver(c.traffic["driver"])
    st = drv.setup(c)
    drv.window(st, 0.3)
    out = drv.outputs(st)
    drv.release(st)
    ctrl = drv.reference(st, dtype=harness.control_dtype(c), program=out)
    ref = drv.reference(st, program=ctrl)
    checks = drv.check(st, ctrl, ref)
    assert not all(ch.ok for ch in checks), checks


def _no_gradient(data, eta, xl, groups):
    z = torch.zeros((), dtype=eta.dtype)
    return z, z


def _search_altered(search):
    def wrapped(*args, **kwargs):
        res = search(*args, **kwargs)
        res.losses[-1] *= 1.0 + 1e-4
        return res
    return wrapped


def _half_pooled(model, batch):
    hidden, _ = model.hidden_states(batch, remat=False)
    return hidden[:, : hidden.shape[1] // 2].mean(dim=1).float()


def _faults():
    from repro_torch.core import beam, solvers
    from repro_torch.models.model import Model
    from repro_torch.survival import deep

    risk = Model.risk_from_pooled
    return [
        # a step that returns its state unchanged
        ("appc-select-beam", solvers, "coord_grad_hess", _no_gradient),
        # an answer altered where it is produced
        ("appc-select-beam", beam, "beam_search",
         _search_altered(beam.beam_search)),
        ("mamba2-featurize-512", Model, "risk_from_pooled",
         lambda self, pooled: 1.5 * risk(self, pooled)),
        # half of the batch left out, the mean taken over the rest
        ("mamba2-featurize-512", deep, "pooled_features", _half_pooled),
    ]


@pytest.mark.parametrize("i", range(4))
def test_fault_is_not_correct(run, bench, monkeypatch, i):
    name, owner, attr, fake = _faults()[i]
    monkeypatch.setattr(owner, attr, fake)
    line = run.execute(tiny.cell(name), 0.3, bench)
    assert not line["correct"], line["checks"]
