"""Port's core/distributed.py, train/compression.compressed_psum,
launch/mesh.py and launch/runtime.py, and ScoringEngine(shard=).

The checks of tests/test_distributed.py run on ``gloo`` worlds of 1 (the
one-rank ``mesh.data_group()``), 2 and 4 ranks, each rank a subprocess with
its own time limit, at n = 509 (prime: every world over 1 has a remainder
shard), p = 32. Each rank's results are held against the JAX package's
replicated ``cox.*`` values on the same numpy inputs, with
tests/test_distributed.py's tolerances (2e-5 for the suffix sums, 2e-4 for
the risk statistics and derivatives, 1e-2 relative for the CD objective);
every rank must return the same bits. ``compressed_psum`` is held against
the reference's inside ``shard_map`` on a host mesh of as many devices (a
JAX subprocess), bit for bit, and against the exact sum within the
reference's 2 % normalized RMSE. The engine's shard resolution and
per-shard bucketing follow tests/test_streaming.py."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cox as jcox  # noqa: E402
from repro.core import solvers as jsolvers  # noqa: E402
from repro_torch.launch import mesh, runtime  # noqa: E402
from repro_torch.serving import ScoringEngine  # noqa: E402
from repro_torch.serving.artifacts import fit_survival_model  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N, P, SWEEPS, LAM2 = 509, 32, 12, 0.5
RANK_TIMEOUT = 240

DATA = r"""
import numpy as np
rng = np.random.default_rng(0)
n, p = {n}, {p}
x = rng.standard_normal((n, p)).astype(np.float32)
t = rng.uniform(1.0, 2.0, size=n).astype(np.float32)  # continuous: no ties
delta = (rng.uniform(size=n) < 0.7).astype(np.float32)
beta = rng.standard_normal(p).astype(np.float32) * 0.3
v = rng.standard_normal(n).astype(np.float32)
v2 = rng.standard_normal((n, 4)).astype(np.float32)
y = rng.standard_normal(({world}, 256)).astype(np.float32)
""".strip()

RANK = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
from repro_torch.launch import mesh
if world == 1:
    group = mesh.data_group("cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
else:
    dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                            rank=rank, world_size=world)
    group = mesh.data_group("cpu")
from repro_torch.core import cox, distributed
from repro_torch.train.compression import compressed_psum
{data}
data = cox.prepare(x, t, delta, device="cpu")
eta = data.x @ torch.from_numpy(beta)
res = {{}}
res["revcumsum"] = distributed.shard_revcumsum(torch.from_numpy(v))
res["revcumsum_2d"] = distributed.shard_revcumsum_2d(torch.from_numpy(v2))
res["w"], res["s0"], res["a"] = distributed.sharded_risk_stats(data, eta)
res["grad"], res["hess"] = distributed.sharded_grad_hess_all(data, eta)
l2c, _ = cox.lipschitz_constants(data)
beta_sh, eta_out = distributed.fit_cd_sharded(data, l2c, lam2={lam2},
                                              n_sweeps={sweeps})
res["beta_sh"], res["eta_sh"] = beta_sh, eta_out
res["f_sh"] = (cox.loss_from_eta(data, eta_out)
               + {lam2} * torch.sum(beta_sh * beta_sh)).reshape(1)
mine = torch.from_numpy(y[rank:rank + 1])
res["cpsum"] = compressed_psum(mine, group)
exact = mine.clone()
dist.all_reduce(exact, group=group)
res["psum"] = exact
np.savez(os.path.join(out, f"rank{{rank}}.npz"),
         **{{k: v.numpy() for k, v in res.items()}})
print("RANK_SAVED", flush=True)
# Every rank has finished its collectives once the barrier returns. The
# rank then leaves without tearing gloo down: a 4-rank world's teardown
# (destroy_process_group or the interpreter's exit) has aborted a rank
# with "terminate called without an active exception" after its results
# were written.
dist.barrier(group=group)
print("RANK_OK", flush=True)
os._exit(0)
"""

JAX_PSUM = r"""
import os, sys
world = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={{world}}"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import _make_mesh, shard_map_compat
from repro.train.compression import compressed_psum
{data}
mesh = _make_mesh((world,), ("data",))
out = shard_map_compat(lambda a: compressed_psum(a, "data"), mesh=mesh,
                       in_specs=P("data"), out_specs=P("data"))(y)
np.save(sys.argv[2], np.asarray(out))
print("JAX_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("XLA_FLAGS", None)
    return env


def _inputs(world):
    scope = {}
    exec(DATA.format(n=N, p=P, world=world), scope)
    return scope


_RUNS = {}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    """Every rank's results (a list of dicts) and the world size."""
    return _run_world(request.param, tmp_path_factory)


def _run_world(w, tmp_path_factory):
    """Run the ranks of a world of ``w`` once per module."""
    if w in _RUNS:
        return _RUNS[w]
    out = tmp_path_factory.mktemp(f"world{w}")
    code = RANK.format(data=DATA.format(n=N, p=P, world=w), lam2=LAM2,
                       sweeps=SWEEPS)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(w), str(out),
         str(out / "store")], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(w)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=RANK_TIMEOUT)
            logs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (rc, so, se) in enumerate(logs):
        assert rc == 0 and "RANK_OK" in so, (f"rank {r} of {w}: rc {rc}\n"
                                            + so + "\n---\n" + se)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(w)]
    _RUNS[w] = (w, ranks, out)
    return _RUNS[w]


@pytest.fixture(scope="module")
def reference():
    """The reference's replicated values on the same inputs."""
    s = _inputs(1)
    data = jcox.prepare(s["x"], s["t"], s["delta"])
    eta = data.x @ jnp.asarray(s["beta"])
    w, s0, a, _ = jcox.risk_stats(data, eta)
    g, h = jcox.grad_hess_all(data, eta)
    res = jsolvers.fit_cd(data, lam2=LAM2, n_iters=SWEEPS)
    return {"revcumsum": np.asarray(jax.lax.cumsum(jnp.asarray(s["v"]),
                                                   reverse=True)),
            "revcumsum_2d": np.asarray(jax.lax.cumsum(
                jnp.asarray(s["v2"]), axis=0, reverse=True)),
            "s0": np.asarray(s0), "a": np.asarray(a), "grad": np.asarray(g),
            "hess": np.asarray(h), "f_ref": float(res.objective[-1])}


def test_every_rank_returns_the_same_bits(world):
    w, ranks, _ = world
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("key", ["revcumsum", "revcumsum_2d"])
def test_shard_revcumsum_matches(world, reference, key):
    _, ranks, _ = world
    np.testing.assert_allclose(ranks[0][key], reference[key], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("key", ["s0", "a"])
def test_sharded_risk_stats_match(world, reference, key):
    _, ranks, _ = world
    np.testing.assert_allclose(ranks[0][key], reference[key], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("key", ["grad", "hess"])
def test_sharded_grad_hess_all_matches(world, reference, key):
    _, ranks, _ = world
    np.testing.assert_allclose(ranks[0][key], reference[key], rtol=2e-4,
                               atol=2e-4)


def test_fit_cd_sharded_reaches_the_replicated_objective(world, reference):
    _, ranks, _ = world
    f_sh, f_ref = float(ranks[0]["f_sh"][0]), reference["f_ref"]
    assert abs(f_sh - f_ref) < 1e-2 * max(1.0, abs(f_ref)), (f_sh, f_ref)
    assert ranks[0]["eta_sh"].shape == (N,)
    assert ranks[0]["beta_sh"].shape == (P,)


def test_fit_cd_sharded_matches_the_ports_fit_cd(world):
    """The sharded fit's beta within float32 round-off of the port's
    one-process ``fit_cd`` (cd_quad) on the same tie-free data: the same
    coordinate steps, their sums in another order."""
    from repro_torch.core import cox, solvers

    _, ranks, _ = world
    s = _inputs(1)
    data = cox.prepare(s["x"], s["t"], s["delta"], device="cpu")
    res = solvers.fit_cd(data, lam2=LAM2, n_iters=SWEEPS, device="cpu")
    np.testing.assert_allclose(ranks[0]["beta_sh"], res.beta.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_compressed_psum_is_close_to_psum(world):
    _, ranks, _ = world
    approx, exact = ranks[0]["cpsum"], ranks[0]["psum"]
    rel = float(np.sqrt(np.mean((approx - exact) ** 2))
                / np.sqrt(np.mean(exact ** 2)))
    assert rel < 0.02, rel


def test_compressed_psum_matches_reference(world, tmp_path):
    w, ranks, _ = world
    code = JAX_PSUM.format(data=DATA.format(n=N, p=P, world=w))
    dest = tmp_path / "jax.npy"
    res = subprocess.run([sys.executable, "-c", code, str(w), str(dest)],
                         env=_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=RANK_TIMEOUT)
    assert "JAX_OK" in res.stdout, res.stdout + "\n---\n" + res.stderr
    want = np.load(dest)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["cpsum"][0], want[r])


def test_compressed_psum_one_rank_is_the_int8_round_trip(tmp_path_factory):
    """With one rank the all-reduce is the quantize-dequantize round trip
    of compress_decompress with a zero residual."""
    from repro_torch.train import compression

    _, ranks, _ = _run_world(1, tmp_path_factory)
    y = torch.from_numpy(_inputs(1)["y"])
    want, _ = compression.compress_decompress({"y": y},
                                              {"y": torch.zeros_like(y)})
    np.testing.assert_array_equal(ranks[0]["cpsum"], want["y"].numpy())


# ---------------------------------------------------------------------------
# launch/mesh.py and launch/runtime.py
# ---------------------------------------------------------------------------

def test_make_data_shards_on_the_cpu_is_one_shard():
    assert mesh.make_data_shards(4, "cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.make_data_shards(1)


def test_runtime_knobs(monkeypatch):
    monkeypatch.delenv(runtime.DATA_SHARDS_ENV, raising=False)
    monkeypatch.delenv(runtime.STREAM_CHUNK_ENV, raising=False)
    assert runtime.data_shards() == 0
    assert runtime.stream_chunk() == runtime.STREAM_CHUNK_DEFAULT == 65536
    monkeypatch.setenv(runtime.DATA_SHARDS_ENV, "3")
    monkeypatch.setenv(runtime.STREAM_CHUNK_ENV, "0")
    assert runtime.data_shards() == 3 and runtime.stream_chunk() == 1
    monkeypatch.setenv(runtime.DATA_SHARDS_ENV, "x")
    monkeypatch.setenv(runtime.STREAM_CHUNK_ENV, "y")
    assert runtime.data_shards() == 0
    assert runtime.stream_chunk() == runtime.STREAM_CHUNK_DEFAULT


def test_runtime_matches_the_reference_knobs():
    from repro.launch import runtime as jruntime

    for name in ("DATA_SHARDS_ENV", "STREAM_CHUNK_ENV",
                 "STREAM_CHUNK_DEFAULT", "TCMALLOC_PATHS"):
        assert getattr(runtime, name) == getattr(jruntime, name)
    assert not any(k.startswith(("JAX", "XLA", "TF_"))
                   for k in runtime.ENV_DEFAULTS)


def test_runtime_apply_never_overrides(monkeypatch):
    key = next(iter(runtime.ENV_DEFAULTS))
    monkeypatch.setenv(key, "mine")
    monkeypatch.delenv("REPRO_TEST_EXTRA", raising=False)
    applied = runtime.apply({"REPRO_TEST_EXTRA": "1"})
    assert applied == {"REPRO_TEST_EXTRA": "1"}
    assert os.environ[key] == "mine"


def test_runtime_describe_and_log(tmp_path, capsys):
    from repro_torch.obs import events

    d = runtime.describe()
    assert d["torch_version"] == torch.__version__
    assert d["device_count"] == (torch.cuda.device_count()
                                 if torch.cuda.is_available() else 0)
    assert not any("jax" in k or "xla" in k for k in d)
    path = str(tmp_path / "ev.jsonl")
    events.configure(path)
    try:
        runtime.log()
    finally:
        events.configure(None)
    assert "[runtime] torch_version=" in capsys.readouterr().out
    recs = [r for r in events.read_jsonl(path) if r["kind"] == "runtime.env"]
    assert len(recs) == 1


# ---------------------------------------------------------------------------
# ScoringEngine(shard=) (tests/test_streaming.py on the port)
# ---------------------------------------------------------------------------

def _model(n=100, p=4, seed=11, strata=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    t = rng.exponential(size=n).astype(np.float32)
    d = (rng.uniform(size=n) < 0.6).astype(np.float32)
    beta = rng.standard_normal(p).astype(np.float32) * 0.2
    s = rng.integers(0, strata, n) if strata else None
    return fit_survival_model(x, t, d, beta, strata=s, device="cpu")


def test_engine_shard_resolution_and_bucketing(monkeypatch):
    model = _model()
    e = ScoringEngine(model, device="cpu")
    assert e.shard == 1 and e._devices == [torch.device("cpu")]
    assert e._pad(np.zeros((37, 4), np.float32))[2] == 64
    # explicit shard counts clamp to the cards present (the CPU is one)
    assert ScoringEngine(model, shard=4, device="cpu").shard == 1
    monkeypatch.setenv("REPRO_DATA_SHARDS", "1")
    assert ScoringEngine(model, shard="auto", device="cpu").shard == 1
    monkeypatch.delenv("REPRO_DATA_SHARDS")
    auto = ScoringEngine(model, shard="auto", device="cpu")
    assert auto.shard == 1 and auto.cache_info()["shard"] == 1


def test_engine_per_shard_bucketing_math():
    # bucket = shards * next_pow2(ceil(b / shards)); checked without
    # devices by faking the resolved shard count
    e = ScoringEngine(_model(50, 3, 12), device="cpu")
    e.shard = 2
    for b, want in [(1, 2), (2, 2), (3, 4), (37, 64), (64, 64), (65, 128)]:
        assert e._pad(np.zeros((b, 3), np.float32))[2] == want, b


def _two_shards(model):
    """An engine whose rows split over two shards, both on the CPU."""
    e = ScoringEngine(model, device="cpu")
    e._devices = [torch.device("cpu")] * 2
    e._state = e._state * 2
    e.shard = 2
    return e


@pytest.mark.parametrize("strata", [None, 3])
def test_sharded_scoring_parity(strata):
    """Two shards score as one engine does, bit for bit (the split, the
    per-shard buckets and the concatenation)."""
    model = _model(300, 6, 0, strata)
    e1, e2 = ScoringEngine(model, device="cpu"), _two_shards(model)
    rng = np.random.default_rng(1)
    xq = rng.standard_normal((41, 6)).astype(np.float32)
    sq = rng.integers(0, strata, 41) if strata else None
    np.testing.assert_array_equal(e1.risk_scores(xq), e2.risk_scores(xq))
    np.testing.assert_array_equal(e1.survival_curves(xq, sq),
                                  e2.survival_curves(xq, sq))
    np.testing.assert_array_equal(e1.median_survival(xq, sq),
                                  e2.median_survival(xq, sq))
    for a, b in zip(e1.score(xq, sq, with_curves=True),
                    e2.score(xq, sq, with_curves=True)):
        np.testing.assert_array_equal(a, b)
    assert e2.prewarm(batch_sizes=(1, 2, 3, 64)) == 3  # buckets 2, 4, 64
