"""The port's autotuner (``kernels/autotune.py``) for the curve kernels'
one launch knob, ``blocks_per_sm``: the ports of tests/test_autotune.py
that need no timing (bucket edges, keys, pruned candidates, the cache
round trip without re-timing, lookup fallback and winner, registration
into the roofline), with the card's timer stubbed; the other backends'
entries kept by a save; the wrappers reading the cache on dispatch; every
candidate's plan covering the panel and its call agreeing with the
reference's plain version (rtol = atol = 2e-5, as tests/test_autotune.py
holds a tuned call); and ``autotune`` refusing the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.analysis import report, roofline  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import survival_curves as curves  # noqa: E402

KERNELS = sorted(autotune.DEFAULT_CONFIGS)
SMS = autotune.H100_SMS


@pytest.fixture(autouse=True)
def _fresh_cache(tmp_path, monkeypatch):
    """Every test reads its own cache file, and leaves no winners behind."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "default.json"))
    autotune._LOADED.clear()
    autotune._KNOBS.clear()
    saved = dict(roofline.TUNED_KERNELS)
    yield
    autotune._LOADED.clear()
    autotune._KNOBS.clear()
    roofline.TUNED_KERNELS.clear()
    roofline.TUNED_KERNELS.update(saved)


@pytest.fixture
def stub_card(monkeypatch):
    """The CPU stands in for the card and the timer answers from a table:
    blocks_per_sm v takes TIMES[v] us in every round; returns the calls."""
    times = {1: 3.0, 2: 2.0, 4: 1.5, 8: 2.5}
    calls = []

    def fake_time(kernel, inputs, configs, reps, rounds):
        calls.append((kernel, [c[autotune.KNOB] for c in configs]))
        return {autotune._cfg_key(c): [times[c[autotune.KNOB]]] * rounds
                for c in configs}

    monkeypatch.setattr(autotune, "_card",
                        lambda device: (torch.device("cpu"), SMS, "stub"))
    monkeypatch.setattr(autotune, "_time_candidates", fake_time)
    return calls


# -- shape buckets ----------------------------------------------------------

def test_bucket_edges():
    assert autotune.bucket(1) == 1
    assert autotune.bucket(2) == 2
    assert autotune.bucket(3) == 4
    assert autotune.bucket(512) == 512
    assert autotune.bucket(513) == 1024
    assert autotune.bucket(0) == 1   # degenerate guard
    for v in range(0, 5000, 7):
        assert autotune.bucket(v) == jautotune.bucket(v), v


@pytest.mark.parametrize("kernel", KERNELS)
def test_bucket_key_shape_and_backend(kernel):
    k = autotune.bucket_key(kernel, {"b": 1000, "g": 3})
    assert k == f"cuda/{kernel}/b=1024,g=4"
    # every b in (512, 1024] lands in the same bucket
    assert autotune.bucket_key(kernel, {"b": 600, "g": 4}) == k
    assert autotune.bucket_key(kernel, {"b": 1000, "g": 3},
                               backend="cpu") != k
    # the reference's key for the same kernel, shape and backend
    assert k == jautotune.bucket_key(kernel, {"b": 1000, "g": 3},
                                     backend="cuda")


def test_default_is_the_plan_default():
    for kernel in KERNELS:
        assert autotune.DEFAULT_CONFIGS[kernel] == {
            autotune.KNOB: curves.BLOCKS_PER_SM}
        assert autotune.DEFAULT_CONFIGS[kernel] in autotune.CANDIDATES[kernel]


@pytest.mark.parametrize("kernel", KERNELS)
def test_candidates_pruned_to_distinct_plans_but_default_kept(kernel):
    default = autotune.DEFAULT_CONFIGS[kernel]
    # a batch too small to fill the card: every value gives one grid
    assert autotune.candidates_for(kernel, {"b": 1, "g": 128}) == [default]
    assert autotune.candidates_for(kernel, {"b": 64, "g": 128}) == [default]
    big = autotune.candidates_for(kernel, {"b": 4096, "g": 128})
    assert big[0] == default
    assert sorted(c[autotune.KNOB] for c in big) == [1, 2, 4, 8]
    for b in (256, 1024, 3000, 4096):
        cands = autotune.candidates_for(kernel, {"b": b, "g": 128})
        assert cands[0] == default
        plans = [autotune._plan(kernel, {"b": b, "g": 128}, SMS, c)
                 for c in cands]
        assert len(set(plans)) == len(plans)
        # every candidate left out launches a grid already kept
        for c in autotune.CANDIDATES[kernel]:
            assert autotune._plan(kernel, {"b": b, "g": 128}, SMS, c) \
                in plans


# -- cache round trip -------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_cache_roundtrip_no_retiming(tmp_path, monkeypatch, stub_card,
                                     kernel):
    path = str(tmp_path / "tuned.json")
    shape = {"b": 4000, "g": 100}
    cfg = autotune.autotune(kernel, shape, cache_file=path, reps=1,
                            rounds=3)
    assert cfg == {autotune.KNOB: 4}
    assert stub_card == [(kernel, [2, 1, 4, 8])]
    with open(path) as f:
        data = json.load(f)
    assert data["version"] == autotune.CACHE_VERSION
    assert len(data["entries"]) == 1
    (entry,) = data["entries"].values()
    assert entry["config"] == cfg and entry["us"] == 1.5
    assert entry["default_config"] == autotune.DEFAULT_CONFIGS[kernel]
    assert entry["default_us"] == 2.0
    assert entry["us"] <= entry["default_us"]
    assert entry["spread_us"] == 0.0 and entry["rounds"] == 3
    assert entry["candidates"] == {"blocks_per_sm=1": 3.0,
                                   "blocks_per_sm=2": 2.0,
                                   "blocks_per_sm=4": 1.5,
                                   "blocks_per_sm=8": 2.5}

    def boom(*a, **k):
        raise AssertionError("cached bucket was re-timed")

    monkeypatch.setattr(autotune, "_time_candidates", boom)
    # same bucket (b=2049 -> 4096, g=65 -> 128): cache hit
    assert autotune.autotune(kernel, {"b": 2049, "g": 65},
                             cache_file=path) == cfg
    # a fresh process state reloads the same winners from disk
    autotune._LOADED.clear()
    assert autotune.autotune(kernel, shape, cache_file=path) == cfg


def test_lookup_falls_back_to_default(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "missing.json"))
    autotune._LOADED.clear()
    for kernel, default in autotune.DEFAULT_CONFIGS.items():
        assert autotune.lookup(kernel, b=64, g=64) == default
        assert autotune.lookup_tagged(kernel, b=64, g=64) == (default,
                                                              "default")
        assert autotune.knob(kernel, 64, 64) == curves.BLOCKS_PER_SM


def test_lookup_returns_tuned_winner(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv(autotune.CACHE_ENV, path)
    key = autotune.bucket_key("survival_curves", {"b": 100, "g": 128})
    autotune.save_cache({key: {"config": {autotune.KNOB: 8}}}, path)
    assert autotune.lookup("survival_curves", b=100, g=128) == {
        autotune.KNOB: 8}
    assert autotune.lookup_tagged("survival_curves", b=100, g=128)[1] == \
        "tuned"
    assert autotune.knob("survival_curves", 100, 128) == 8
    # a different bucket, or the other kernel, still falls back
    assert autotune.lookup("survival_curves", b=100_000, g=128) == \
        autotune.DEFAULT_CONFIGS["survival_curves"]
    assert autotune.knob("survival_curves_strat", 100, 128) == \
        curves.BLOCKS_PER_SM
    # a later save is seen by the next dispatch read
    autotune.save_cache({key: {"config": {autotune.KNOB: 1}}}, path)
    assert autotune.knob("survival_curves", 100, 128) == 1


def test_save_keeps_other_backends_entries(tmp_path, stub_card):
    """The reference's TPU and CPU winners in the same file survive a
    tuning run on the card, and never answer a cuda lookup."""
    path = str(tmp_path / "tuned.json")
    others = {
        "tpu/survival_curves/b=4096,g=128": {
            "config": {"block_b": 256, "block_g": 128}},
        "cpu/revcumsum/n=1024,m=4": {"config": {"block_n": 512}}}
    autotune.save_cache(dict(others), path)
    autotune._LOADED.clear()
    autotune.autotune("survival_curves", {"b": 4096, "g": 128},
                      cache_file=path, reps=1, rounds=2)
    with open(path) as f:
        entries = json.load(f)["entries"]
    for key, entry in others.items():
        assert entries[key] == entry
    assert entries["cuda/survival_curves/b=4096,g=128"]["config"] == {
        autotune.KNOB: 4}
    assert autotune.lookup("survival_curves", cache_file=path, b=4096,
                           g=128) == {autotune.KNOB: 4}


def test_autotune_registers_into_roofline(tmp_path, stub_card):
    path = str(tmp_path / "tuned.json")
    shape = {"b": 1024, "g": 128}
    winners = autotune.sweep([("survival_curves_strat", shape)],
                             cache_file=path, reps=1, rounds=1)
    key = autotune.bucket_key("survival_curves_strat", shape)
    assert winners == {key: {autotune.KNOB: 2}}    # of 2 and 1 at b = 1024
    assert key in roofline.TUNED_KERNELS
    assert "default_us" in roofline.TUNED_KERNELS[key]
    table = report.tuned_blocks_table(path)
    row = [r for r in table.splitlines() if "survival_curves_strat" in r]
    assert row and "b=1024,g=128" in row[0] and "1.00x" in row[0]


def test_autotune_refuses_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="card"):
        autotune.autotune("survival_curves", {"b": 64, "g": 128},
                          cache_file=str(tmp_path / "t.json"),
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            autotune.autotune("survival_curves", {"b": 64, "g": 128},
                              cache_file=str(tmp_path / "t.json"))
    assert not (tmp_path / "t.json").exists()


# -- the wrappers read the cache on dispatch --------------------------------

class _FakeLib:
    """Records the launch arguments of both curve entry points."""

    def __init__(self):
        self.launches = []

    def repro_survival_curves(self, eta, h0, b, g, blocks, slab, vec, tail,
                              out, stream):
        self.launches.append((blocks, slab))
        return 0

    def repro_survival_curves_stratified(self, eta, h0, strata, b, g, s,
                                         blocks, slab, vec, tail, staged,
                                         out, stream):
        self.launches.append((blocks, slab))
        return 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_read_the_tuned_cache(tmp_path, monkeypatch, kernel):
    """The launch a wrapper issues on the card, with the library faked on
    the CPU: the default plan untuned, the cached winner's plan tuned, an
    explicit knob over both."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "require", lambda *a: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    monkeypatch.setattr(curves, "_sms", lambda device: SMS)
    b, g = 4096, 128
    inputs = autotune._build_inputs(kernel, {"b": b, "g": g}, device="cpu")
    fn = (curves.survival_curves if kernel == "survival_curves"
          else curves.survival_curves_stratified)
    strat = kernel == "survival_curves_strat"

    def planned(v):
        pl = curves.plan(b, g, SMS, autotune.STRATA if strat else 1,
                         stratified=strat,
                         aligned=inputs[1].data_ptr() % 16 == 0,
                         blocks_per_sm=v)
        return pl.blocks, pl.slab

    counts = _build.LAUNCHES.read([fn.__name__])
    fn(*inputs)
    path = str(tmp_path / "default.json")
    autotune.save_cache({autotune.bucket_key(kernel, {"b": b, "g": g}): {
        "config": {autotune.KNOB: 8}}}, path)
    fn(*inputs)
    fn(*inputs, blocks_per_sm=1)
    assert lib.launches == [planned(curves.BLOCKS_PER_SM), planned(8),
                            planned(1)]
    assert len(set(lib.launches)) == 3
    assert _build.LAUNCHES.read([fn.__name__])[fn.__name__] == \
        counts[fn.__name__] + 3


# -- every candidate: the plan covers the panel, the call is right ----------

RAGGED = ({"b": 77, "g": 33}, {"b": 4097, "g": 129}, {"b": 1000, "g": 128})


@pytest.mark.parametrize("shape", RAGGED, ids=str)
@pytest.mark.parametrize("kernel", KERNELS)
def test_every_candidate_plan_covers_the_panel_once(kernel, shape):
    """Each candidate's plan at a ragged shape: every (row, column) written
    once by the row walk of csrc/curves.cuh (the model of
    tests/test_torch_curves.py)."""
    b, g = shape["b"], shape["g"]
    strat = kernel == "survival_curves_strat"
    for cfg in autotune.CANDIDATES[kernel]:
        pl = curves.plan(b, g, SMS, autotune.STRATA if strat else 1,
                         stratified=strat, blocks_per_sm=cfg[autotune.KNOB])
        hits = np.zeros((b, g), np.int32)
        stride = pl.blocks * curves.WARPS * pl.slab
        for cy in range(pl.chunks):
            width = pl.tail if cy == pl.chunks - 1 else 32 * pl.vec
            cols = cy * 32 * pl.vec + np.arange(width)
            for w in range(pl.blocks * curves.WARPS):
                for r0 in range(w * pl.slab, b, stride):
                    rows = np.arange(r0, min(r0 + pl.slab, b))
                    np.add.at(hits, (rows[:, None], cols[None, :]), 1)
        assert np.all(hits == 1), (cfg, pl)


@pytest.mark.parametrize("shape", RAGGED, ids=str)
@pytest.mark.parametrize("kernel", KERNELS)
def test_every_candidate_matches_the_reference(kernel, shape):
    """run_config at every candidate against the reference's plain version
    on the same numpy inputs (on the CPU each call is the port's plain
    version: the knob is the card's)."""
    inputs = autotune._build_inputs(kernel, shape, seed=3, device="cpu")
    j_inputs = [jnp.asarray(t.numpy()) for t in inputs]
    want = np.asarray(
        jref.survival_curves_ref(*j_inputs) if kernel == "survival_curves"
        else jref.survival_curves_stratified_ref(*j_inputs))
    for cfg in autotune.CANDIDATES[kernel]:
        got = autotune.run_config(kernel, inputs, cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{kernel} {cfg}")
