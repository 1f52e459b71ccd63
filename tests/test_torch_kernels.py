"""Port's kernel wrappers and plain versions against the JAX package.

The CUDA kernels need a card and nvcc; here every wrapper takes its plain
version, because its tensors lie on the CPU, and that plain version is held
against the JAX Pallas kernel (interpret mode, as tests/test_kernels.py runs
it) on tie-free data and against the JAX package's Breslow definitions in
core/cox.py on tied data. chip_smoke.py holds the kernels against the same
plain versions on the card.

Tolerances: float32 against the Pallas kernels, 2e-5 (g, h) and 2e-4 (c3,
a third moment) as in tests/test_kernels.py, 1e-4 for the Lipschitz
constants, 1e-5 for the curve panel; float64 against core/cox.py, 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cox_coord import cox_coord as j_cox_coord  # noqa: E402
from repro.kernels.survival_curves import \
    survival_curves as j_survival_curves  # noqa: E402
from repro_torch.core import cox  # noqa: E402
from repro_torch.data.synthetic import make_tied_survival  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.cox_coord import cox_coord  # noqa: E402
from repro_torch.kernels.lipschitz import lipschitz  # noqa: E402
from repro_torch.kernels.survival_curves import survival_curves  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _tie_free(n, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)).astype(np.float32)
    # distinct-by-construction times (f32 uniform draws collide at n=2000)
    t = rng.permutation(1.0 + np.arange(n) / n).astype(np.float32)
    delta = (rng.uniform(size=n) < 0.6).astype(np.float32)
    return x, t, delta


# ---------------------------------------------------------------------------
# cox_coord
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 64, 257, 1024, 2000])
@pytest.mark.parametrize("order", [2, 3])
def test_cox_coord_matches_pallas_tie_free(n, order):
    rng = np.random.default_rng(n + order)
    eta = (rng.standard_normal(n) * 0.8).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    d = (rng.uniform(size=n) < 0.7).astype(np.float32)
    want = j_cox_coord(jnp.asarray(eta), jnp.asarray(x), jnp.asarray(d),
                       order=order, block=128, interpret=True)
    got = cox_coord(_t(eta), _t(x), _t(d),
                    torch.arange(n, dtype=torch.int32), order=order)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=2e-5)
    if order == 3:
        np.testing.assert_allclose(got[2], want[2], rtol=2e-4, atol=2e-4)
    else:
        assert float(got[2]) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", [2, 3])
def test_cox_coord_matches_breslow_on_ties(seed, order):
    x, t, delta = make_tied_survival(n=300, p=5, n_times=12, seed=seed)
    x = x.astype(np.float64)
    beta = np.random.default_rng(seed).standard_normal(5) * 0.4
    with jax.enable_x64(True):
        jd = jcox.prepare(x, t, delta)
        eta = jd.x @ jnp.asarray(beta)
        want = [np.asarray(jcox.coord_derivs(jd, eta, jd.x[:, l],
                                             order=order))
                for l in range(5)]
        eta_np = np.asarray(eta)
    td = cox.prepare(x, t, delta, device="cpu")
    assert not torch.equal(td.risk_start, torch.arange(300, dtype=torch.int32))
    for l in range(5):
        got = cox_coord(_t(eta_np), td.xT[l], td.delta, td.risk_start,
                        order=order)
        np.testing.assert_allclose(got.numpy(), want[l], rtol=1e-8,
                                   atol=1e-10)


def test_ops_cox_coord_entry_points():
    x, t, delta = make_tied_survival(n=120, p=3, seed=5)
    td = cox.prepare(x, t, delta, device="cpu")
    eta = td.x @ torch.tensor([0.3, -0.2, 0.1])
    g, h = ops.cox_coord_grad_hess(eta, td.xT[1], td.delta, td.risk_start)
    g3, h3, c3 = ops.cox_coord_all(eta, td.xT[1], td.delta, td.risk_start)
    want = cox.coord_derivs(td, eta, td.xT[1], order=3)
    for a, b in ((g, want[0]), (h, want[1]), (g3, want[0]), (h3, want[1]),
                 (c3, want[2])):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# lipschitz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 1), (50, 4), (513, 8), (2000, 16)])
def test_lipschitz_matches_pallas_tie_free(n, m):
    x, t, delta = _tie_free(n, m, seed=n + m)
    with jax.enable_x64(False):
        jd = jcox.prepare(x, t, delta)
        l2_w, l3_w = jops.lipschitz_constants(jd.x, jd.delta, block_n=256)
    td = cox.prepare(x, t, delta, device="cpu")
    l2, l3 = lipschitz(td.x, td.delta, td.risk_start)
    np.testing.assert_allclose(l2, l2_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l3, l3_w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lipschitz_matches_breslow_on_ties(seed):
    x, t, delta = make_tied_survival(n=400, p=7, n_times=10, seed=seed)
    x = x.astype(np.float64)
    with jax.enable_x64(True):
        want = [np.asarray(v) for v in
                jcox.lipschitz_constants(jcox.prepare(x, t, delta))]
    td = cox.prepare(x, t, delta, device="cpu")
    got = ops.lipschitz_constants(td.x, td.delta, td.risk_start)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------------------
# survival_curves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,g", [(1, 1), (7, 33), (256, 128), (300, 130)])
def test_survival_curves_matches_pallas(b, g):
    rng = np.random.default_rng(b + g)
    eta = (rng.standard_normal(b) * 2.0).astype(np.float32)
    h0 = np.sort(rng.uniform(0, 3, g)).astype(np.float32)
    want = j_survival_curves(jnp.asarray(eta), jnp.asarray(h0), block_b=128,
                             block_g=64, interpret=True)
    got = survival_curves(_t(eta), _t(h0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_survival_curves_extreme_eta_saturates():
    eta = torch.tensor([-80.0, 80.0, -50.0, 50.0])
    h0 = torch.tensor([0.5, 1.0])
    out = ops.survival_curves(eta, h0)
    assert torch.all(torch.isfinite(out))
    np.testing.assert_allclose(out[0], 1.0, atol=1e-6)   # ~zero risk
    np.testing.assert_allclose(out[1], 0.0, atol=1e-6)   # huge risk
    want = jref.survival_curves_ref(jnp.asarray(eta.numpy()),
                                    jnp.asarray(h0.numpy()))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The six oracles mirror the JAX package's kernels/ref.py
# ---------------------------------------------------------------------------

def _oracle_inputs():
    rng = np.random.default_rng(21)
    n, p, b, s, g = 200, 6, 9, 3, 17
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    eta, x, xm = f(n) * 0.5, f(n), f(n, p)
    d = (rng.uniform(size=n) < 0.7).astype(np.float32)
    w = np.exp(eta - eta.max())
    inv_s0 = (1.0 / np.cumsum(w[::-1])[::-1]).astype(np.float32)
    wa = (w * np.cumsum(d * inv_s0)).astype(np.float32)
    return {
        "revcumsum_ref": (xm,),
        "cox_coord_ref": (eta, x, d),
        "cox_batch_ref": (xm, w, wa - d, wa, d, inv_s0),
        "survival_curves_ref": (f(b), np.sort(rng.uniform(0, 2, g))
                                .astype(np.float32)),
        "survival_curves_stratified_ref": (
            f(b), np.cumsum(rng.uniform(0, 0.1, (s, g)), axis=1)
            .astype(np.float32), rng.integers(0, s, b).astype(np.int32)),
        "lipschitz_ref": (xm, d),
    }


@pytest.mark.parametrize("name", sorted(_oracle_inputs()))
def test_oracles_mirror_reference(name):
    args = _oracle_inputs()[name]
    with jax.enable_x64(False):
        want = getattr(jref, name)(*(jnp.asarray(a) for a in args))
    got = getattr(ref, name)(*(_t(np.asarray(a)) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(np.asarray(g_, np.float32),
                                   np.asarray(w_, np.float32),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Wrapper contracts
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    counter = ops._M_DISPATCH
    before = counter.value(kernel="cox_coord", route="plain")
    x, t, delta = make_tied_survival(n=64, p=4, seed=2)
    td = cox.prepare(x, t, delta, device="cpu")
    eta = torch.zeros(64)
    ops.cox_coord_grad_hess(eta, td.xT[0], td.delta, td.risk_start)
    ops.lipschitz_constants(td.x, td.delta, td.risk_start)
    ops.survival_curves(eta[:5], torch.linspace(0, 1, 8))
    assert ops.launch_counts() == {"cox_coord": 0, "lipschitz": 0,
                                   "survival_curves": 0}
    assert counter.value(kernel="cox_coord", route="plain") == before + 1


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "order",
                                  "device", "empty"])
def test_wrappers_validate_arguments(case):
    n = 16
    eta, x, d = torch.zeros(n), torch.ones(n), torch.ones(n)
    rs = torch.arange(n, dtype=torch.int32)
    if case == "dtype":
        with pytest.raises(TypeError):
            cox_coord(eta, x, d, rs.float())
        with pytest.raises(TypeError):
            survival_curves(torch.zeros(3, dtype=torch.int64), torch.ones(4))
    elif case == "shape":
        with pytest.raises(ValueError):
            cox_coord(eta, x[:-1], d, rs)
        with pytest.raises(ValueError):
            lipschitz(torch.ones(n, 3), d[:-2], rs)
    elif case == "contiguity":
        with pytest.raises(ValueError):
            lipschitz(torch.ones(3, n).T, d, rs)
    elif case == "order":
        with pytest.raises(ValueError):
            cox_coord(eta, x, d, rs, order=4)
    elif case == "device":
        with pytest.raises(ValueError, match="not supported"):
            cox_coord(eta.to("meta"), x.to("meta"), d.to("meta"),
                      rs.to("meta"))
    else:
        with pytest.raises(ValueError):
            cox_coord(eta[:0], x[:0], d[:0], rs[:0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back."""
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.library()
    assert not (tmp_path / "kernels").exists()


def test_build_digest_covers_every_source():
    names = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"cox_coord.cu", "lipschitz.cu", "survival_curves.cu",
            "common.cuh"} <= names
    assert set(_build._SIGNATURES) >= {"repro_cox_coord", "repro_lipschitz",
                                       "repro_survival_curves"}
    assert _build._digest() == _build._digest()
