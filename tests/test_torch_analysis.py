"""The port's analysis tools held against the JAX package: the latency
table (the port of tests/test_obs.py's), the roofline with one H100's
figures (the ports of tests/test_analysis_and_launchers.py's checks), the
serving kernels' cost models, ``Model.make_input_specs`` and
``init_cache_specs`` on the meta device, and the dry run on two reduced
architectures.

Shapes, dtypes, parameter counts, FLOP and byte counts are integers or
exact products and are held equal; the roofline's terms are quotients of
them, held at rtol 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import roofline as jrl  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import report, roofline as rl  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs import events, trace  # noqa: E402

ARCHS = sorted(jconfigs.REGISTRY)
KINDS = ("train", "prefill", "decode")
RTOL = 1e-12


@pytest.fixture
def sinks_off():
    """Both global sinks off for the test, and after it."""
    events.configure(None)
    trace.configure(None)
    yield
    events.configure(None)
    trace.configure(None)


# ---------------------------------------------------------------------------
# the latency table (tests/test_obs.py::test_latency_breakdown_table_renders)
# ---------------------------------------------------------------------------

def test_latency_breakdown_table_renders(tmp_path, sinks_off):
    path = str(tmp_path / "trace.jsonl")
    trace.configure(path)
    try:
        with trace.span("service.step"):
            with trace.span("service.dispatch"):
                pass
            with trace.span("service.dispatch"):
                pass
    finally:
        trace.configure(None)
    table = report.latency_breakdown_table(path)
    lines = table.splitlines()
    assert lines[0].startswith("| stage ")
    assert any(ln.startswith("| service.step | 1 ") for ln in lines)
    assert any(ln.startswith("| service.dispatch | 2 ") for ln in lines)
    # empty file degrades to a hint row, not a crash
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    assert "no spans" in report.latency_breakdown_table(empty)


def test_latency_table_equals_the_reference_on_one_trace(tmp_path,
                                                         sinks_off):
    """Both packages' tables of the same span file, row for row."""
    from repro.analysis.report import latency_breakdown_table as jtable

    path = str(tmp_path / "trace.jsonl")
    rng = np.random.default_rng(0)
    trace.configure(path)
    try:
        for _ in range(5):
            with trace.span("service.step"):
                for _ in range(int(rng.integers(1, 4))):
                    trace.emit_span("service.dispatch",
                                    float(rng.uniform(1e-4, 1e-2)))
    finally:
        trace.configure(None)
    assert report.latency_breakdown_table(path) == jtable(path)


# ---------------------------------------------------------------------------
# the roofline (tests/test_analysis_and_launchers.py)
# ---------------------------------------------------------------------------

def test_h100_figures():
    assert rl.PEAK_FLOPS == rl.BF16_OPS_PER_S == 989.4e12
    assert rl.FP32_OPS_PER_S == 67e12
    assert rl.HBM_BW == rl.HBM_BYTES_PER_S == 3.35e12


def test_roofline_terms_and_bottleneck():
    coll = rl.CollectiveStats(op_bytes={}, moved_bytes=rl.LINK_BYTES_PER_S,
                              n_ops=1)
    r = rl.compute_roofline(rl.PEAK_FLOPS, rl.HBM_BW, coll, 1,
                            rl.PEAK_FLOPS * 0.5)
    assert abs(r.compute_s - 1.0) < 1e-6
    assert abs(r.memory_s - 1.0) < 1e-6
    assert abs(r.collective_s - 1.0) < 1e-6
    assert r.useful_flops_ratio == 0.5
    coll2 = rl.CollectiveStats(op_bytes={}, moved_bytes=500e9, n_ops=1)
    r2 = rl.compute_roofline(1e12, 1e9, coll2, 1, 1e12)
    assert r2.bottleneck == "collective"
    # one card: no collective term
    r3 = rl.compute_roofline(1e15, 1e9, rl.NO_COLLECTIVES, 1, 5e14)
    assert r3.collective_s == 0.0 and r3.bottleneck == "compute"
    assert r3.useful_flops_ratio == 0.5
    r4 = rl.compute_roofline(1e9, 1e12, rl.NO_COLLECTIVES, 1, 1e9)
    assert r4.bottleneck == "memory"


def test_active_params_sane():
    # deepseek-67b ~ 67B params
    n = rl.active_params(configs.get_config("deepseek-67b"))
    assert 6.0e10 < n < 7.5e10, n
    # mixtral-8x7b active (top-2 of 8): ~13B
    n = rl.active_params(configs.get_config("mixtral-8x7b"))
    assert 1.0e10 < n < 1.6e10, n
    # mamba2-130m ~ 130-180M (incl. untied embeddings)
    n = rl.active_params(configs.get_config("mamba2-130m"))
    assert 1.0e8 < n < 2.2e8, n


@pytest.mark.parametrize("name", ARCHS)
def test_active_params_and_model_flops_equal_the_reference(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert rl.active_params(cfg) == jrl.active_params(jcfg)
    n = rl.active_params(cfg)
    for s in configs.SHAPES:
        assert rl.model_flops_for(cfg, configs.SHAPES[s], n) == \
            jrl.model_flops_for(jcfg, jconfigs.SHAPES[s], n)


SERVING_SHAPES = [("survival_curves", {"batch": 64, "grid": 128}),
                  ("survival_curves", {"batch": 1024, "grid": 128}),
                  ("risk_dense", {"batch": 64, "p": 10000}),
                  ("risk_sparse", {"batch": 64, "k": 10}),
                  ("risk_sparse", {"batch": 1024, "k": 10})]


@pytest.mark.parametrize("name,shape", SERVING_SHAPES,
                         ids=lambda v: str(v))
def test_serving_kernels_equal_the_reference_in_flops_and_bytes(name,
                                                                 shape):
    k, jk = rl.kernel_roofline(name, **shape), jrl.kernel_roofline(name,
                                                                   **shape)
    assert (k.flops, k.bytes_accessed, k.intensity) == \
        (jk.flops, jk.bytes_accessed, jk.intensity)
    # the scoring kernels compute in float32 outside the tensor cores
    np.testing.assert_allclose(k.compute_s, k.flops / rl.FP32_OPS_PER_S,
                               rtol=RTOL)
    np.testing.assert_allclose(k.memory_s, k.bytes_accessed / rl.HBM_BW,
                               rtol=RTOL)
    assert k.bottleneck == "memory"


def test_serving_kernel_table_rows():
    rows = report.serving_kernel_table().splitlines()[2:]
    assert len(rows) == len(SERVING_SHAPES)
    for row, (name, shape) in zip(rows, SERVING_SHAPES):
        k = jrl.kernel_roofline(name, **shape)
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert cells[0] == name
        assert float(cells[2]) == float(f"{k.flops:.2e}")
        assert float(cells[3]) == float(f"{k.bytes_accessed:.2e}")


# ---------------------------------------------------------------------------
# Model.make_input_specs / init_cache_specs on the meta device
# ---------------------------------------------------------------------------

def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCHS)
def test_make_input_specs_equal_the_reference(name, kind):
    cfg = configs.reduced_config(configs.get_config(name))
    jm = jbuild(jconfigs.reduced_config(jconfigs.get_config(name)))
    shape = configs.ShapeSpec("t", 24, 3, kind)
    want = jm.make_input_specs(jconfigs.ShapeSpec("t", 24, 3, kind))
    got = Model(cfg, device="meta").make_input_specs(shape)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == spec.shape, k
        assert _dtype(got[k]) == str(spec.dtype), k


@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_specs_equal_the_reference_and_init_cache(name):
    """Meta tensors of the reference's init_cache_specs shapes and dtypes
    (a sliding window capped, the SSM state float32, an encoder-decoder's
    source as long as max_len), and of init_cache's."""
    cfg = configs.reduced_config(configs.get_config(name))
    jm = jbuild(jconfigs.reduced_config(jconfigs.get_config(name)))
    meta, cpu = Model(cfg, device="meta"), Model(cfg, device="cpu")
    for batch, max_len in ((2, 40), (3, 9)):
        want = jm.init_cache_specs(batch, max_len)
        got = meta.init_cache_specs(batch, max_len)
        real = cpu.init_cache(batch, max_len)
        assert type(got).__name__ == type(want).__name__ \
            == type(real).__name__
        for f in want._fields:
            g, w, r = getattr(got, f), getattr(want, f), getattr(real, f)
            assert g.device.type == "meta", f
            assert tuple(g.shape) == w.shape == tuple(r.shape), f
            assert _dtype(g) == str(w.dtype) == _dtype(r), f


def test_specs_of_a_full_width_model_take_no_storage():
    """The dry run's shapes: a 67B model's decode cache at 32k on meta."""
    cfg = configs.get_config("deepseek-67b")
    m = Model(cfg, device="meta")
    shape = configs.SHAPES["decode_32k"]
    cache = m.init_cache_specs(shape.global_batch, shape.seq_len)
    assert all(t.device.type == "meta" for t in cache)
    assert cache.k.shape == (cfg.n_layers, 128, 32768, cfg.n_kv_heads,
                             cfg.head_dim)
    assert m.make_input_specs(shape)["tokens"].shape == (128, 1)


# ---------------------------------------------------------------------------
# the dry run on the meta device
# ---------------------------------------------------------------------------

DRY_ARCHS = ("qwen2.5-3b", "mixtral-8x7b")   # one dense, one MoE
DRY_LAYERS = 4


def _dry_cfg(name):
    """The reduced config at DRY_LAYERS layers, so that depth 1 and 2
    extrapolate to a depth neither probe ran."""
    return configs.reduced_config(configs.get_config(name)).scaled(
        n_layers=DRY_LAYERS)


@pytest.mark.parametrize("shape_name", list(configs.SHAPES))
@pytest.mark.parametrize("name", DRY_ARCHS)
def test_dryrun_extrapolation_equals_the_full_depth_count(name, shape_name,
                                                          tmp_path):
    cfg = _dry_cfg(name)
    shape = configs.SHAPES[shape_name]
    rec = dryrun.run_cell(name, shape_name, str(tmp_path), cfg_override=cfg)
    reason = dict((s.name, r) for s, r in configs.applicable_shapes(cfg))[
        shape_name]
    if reason is not None:
        assert rec["status"] == "skipped" and rec["reason"] == reason
        return
    assert rec["status"] == "ok", rec.get("traceback")
    full = dryrun.count_flops(
        dryrun.analysis_config(cfg, shape, DRY_LAYERS), shape)
    assert rec["flops"] == full > 0
    assert rec["probe_flops"]["1"] < rec["probe_flops"]["2"] < full
    b = rec["bytes"]
    n = sum(p.numel() for p in Model(cfg, device="meta").parameters())
    assert b["n_params"] == n and b["params"] == 4 * n   # float32
    assert b["state"] == b["params"] + b["opt"] + b["cache"] + b["inputs"]
    if shape.kind == "train":
        assert b["grads"] == b["params"] and b["moments"] == 8 * n
        assert b["cache"] == 0
        assert rec["memory_floor_bytes"] == 2 * (
            b["params"] + b["grads"] + b["moments"]) + b["inputs"]
    else:
        assert b["opt"] == 0 and b["cache"] > 0
        assert rec["memory_floor_bytes"] == b["params"] + b["cache"] \
            + b["inputs"]
    assert rec["fits"] == (b["state"] <= rec["card_bytes"])
    ro = rec["roofline"]
    assert ro["collective_s"] == 0.0
    np.testing.assert_allclose(ro["compute_s"], full / rl.PEAK_FLOPS,
                               rtol=RTOL)
    np.testing.assert_allclose(ro["memory_s"],
                               rec["memory_floor_bytes"] / rl.HBM_BW,
                               rtol=RTOL)
    jcfg = jconfigs.reduced_config(jconfigs.get_config(name)).scaled(
        n_layers=DRY_LAYERS)
    assert ro["model_flops"] == jrl.model_flops_for(
        jcfg, jconfigs.SHAPES[shape_name], jrl.active_params(jcfg))


def test_dryrun_records_read_back_by_the_tables(tmp_path):
    out = str(tmp_path)
    for name in DRY_ARCHS:
        for shape_name in configs.SHAPES:
            dryrun.run_cell(name, shape_name, out,
                            cfg_override=_dry_cfg(name))
    recs = report.load(out)
    assert len(recs) == len(DRY_ARCHS) * len(configs.SHAPES)
    rows = report.dryrun_table(recs).splitlines()[2:]
    assert len(rows) == len(recs)
    for row, rec in zip(rows, recs):
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert cells[:2] == [rec["arch"], rec["shape"]]
        if rec["status"] == "ok":
            assert cells[2] == "ok" and cells[-1] == "yes"
            assert float(cells[3]) == float(
                f"{rec['bytes']['params'] / 1e9:.2f}")
        else:
            assert cells[2].startswith("skipped")
    roof = report.roofline_table(recs).splitlines()[2:]
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(roof) == len(ok)
    for row, rec in zip(roof, ok):
        assert row.split("|")[6].strip() == rec["roofline"]["bottleneck"]


def test_dryrun_cli_skips_done_cells(tmp_path, capsys):
    out = str(tmp_path)
    args = ["--arch", "mamba2-130m", "--shape", "long_500k", "--out", out]
    first = dryrun.main(args)
    assert [r["status"] for r in first] == ["ok"]
    again = dryrun.main(args + ["--skip-done"])
    assert again == first
    assert "cached" in capsys.readouterr().out
