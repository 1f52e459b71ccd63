"""The user's entry points: the twins in ``examples_torch/``, each run with
``--device cpu`` and held against the reference's example in
``examples/`` (run in float32, as it runs on its own):

- ``quickstart``: every method's final objective within rtol 1e-4 (float32
  fits of 60 iterations; observed 7e-8), the CIndex and the l1 fit's
  support and F1 as printed (4 and 3 decimals);
- ``serve_risk_api``: the beam search's support and loss as printed, every
  one of the 120 requests terminal and scored, the last 20 (submitted
  after the hot swap) at the reference's risks, the first 100 each at the
  reference's risk under either model (a queued request scores on
  whichever engine is live when it is drained: the retrained model's
  risk is the champion's to the power 0.95), all within rtol 1e-5; the
  latency table with its ``service.step`` rows;
- ``serve_batched`` at the reference's (already tiny) sizes and
  ``train_survival_lm`` at a tiny ``--steps/--batch/--seq`` (their
  weights are drawn by each package from its own generator, so their
  outputs are checked for shape and self-consistency, not against the
  reference's).

``sparse_selection`` is held in tests/test_torch_examples_selection.py.
With the default device and no card, every twin raises.
"""
import importlib.util
import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch import configs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "sparse_selection", "serve_risk_api",
            "serve_batched", "train_survival_lm")
OBJ_RTOL = 1e-4
RISK_RTOL = 1e-5


def load_example(folder: str, name: str):
    """The example ``folder/name.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, *args):
    """The reference's example, in float32 whatever the process's x64
    setting, with the environment it sets at import undone after."""
    env = dict(os.environ)
    try:
        with jax.enable_x64(False):
            return load_example("examples", name).main(*args)
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these small fits gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_matches_the_reference(capsys):
    run_reference("quickstart")
    ref = capsys.readouterr().out
    want = {m: float(v) for m, v in re.findall(
        r"^\s*(\w+): final objective ([-\d.]+)", ref, re.M)}
    got = load_example("examples_torch", "quickstart").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(want) == sorted(m for m in got if m in want) and want
    for method, obj in want.items():
        np.testing.assert_allclose(got[method], obj, rtol=OBJ_RTOL,
                                   err_msg=method)
    for pattern in (r"CIndex ([\d.]+)", r"l1 fit: support (\d+), F1 vs "
                    r"true support ([\d.]+)", r"n=\d+ p=\d+ events=\d+"):
        assert re.search(pattern, out).groups() == \
            re.search(pattern, ref).groups(), pattern
    assert f"{got['cindex']:.4f}" in out


def test_serve_risk_api_matches_the_reference(tmp_path, monkeypatch,
                                              capsys):
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_TRACE_FILE", raising=False)
    try:
        ref_resps = run_reference("serve_risk_api")
    finally:
        jtrace.configure(None)
    ref = capsys.readouterr().out
    resps = load_example("examples_torch", "serve_risk_api").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert trace._SINK is None            # the twin closed its sink

    fit = r"\[fit\] support=(\[[\d, ]+\]) loss=([-\d.]+)"
    assert re.search(fit, out).groups() == re.search(fit, ref).groups()
    assert len(resps) == len(ref_resps) == 120
    assert [r.rid for r in resps] == sorted({r.rid for r in resps})
    assert all(r.ok for r in resps) and all(r.ok for r in ref_resps)
    got = np.array([r.risk for r in resps])
    want = np.array([r.risk for r in ref_resps])
    # after the swap: the retrained model in both
    np.testing.assert_allclose(got[100:], want[100:], rtol=RISK_RTOL)
    # before it: either model in each, retrained = champion ** 0.95
    for g, w in zip(got[:100], want[:100]):
        options = (w, w ** 0.95, w ** (1 / 0.95))
        assert min(abs(g - o) / o for o in options) <= RISK_RTOL, (g, w)
    assert "120/120 scored ok" in out
    assert (tmp_path / "serve_risk_api_trace.jsonl").is_file()
    table = out.split("Per-stage latency breakdown")[1]
    step = re.search(r"^\| service\.step \| (\d+) ", table, re.M)
    assert step and int(step.group(1)) >= 1
    assert re.search(r"^\| service\.request \| 120 ", table, re.M)


def test_serve_batched_runs_on_the_cpu(capsys):
    reqs = load_example("examples_torch", "serve_batched").main(
        ["--device", "cpu"])
    vocab = configs.reduced_config(
        configs.get_config("mixtral-8x7b")).vocab_size
    assert [len(r.out) for r in reqs] == [12] * 8
    assert [len(r.prompt) for r in reqs] == [20] * 8
    assert all(0 <= t < vocab for r in reqs for t in r.out)
    assert "[serve] 8 requests, 96 tokens" in capsys.readouterr().out


def test_train_survival_lm_runs_on_the_cpu(tmp_path, capsys):
    export = tmp_path / "artifact"
    res = load_example("examples_torch", "train_survival_lm").main(
        ["--device", "cpu", "--steps", "3", "--batch", "8", "--seq", "16",
         "--export", str(export)])
    out = capsys.readouterr().out
    assert len(res.losses) == 3 and np.all(np.isfinite(res.losses))
    assert res.state.model.device.type == "cpu"
    assert export.is_dir() and res.nnz > 0
    assert "served 16 requests through ModelRegistry/RiskService (gen 1)" \
        in out
    assert 0.0 <= res.cindex_sparse <= 1.0


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_raises_without_a_card(name, tmp_path, monkeypatch):
    """No fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(tmp_path)
    main = load_example("examples_torch", name).main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
    assert list(tmp_path.iterdir()) == []
