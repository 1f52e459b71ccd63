"""Port's train/checkpoint.py, fault_tolerance.resume_or_init and
launch/train.py: save / restore / latest_step / keep, the async
checkpointer, resume into a fresh model, restore onto another device (the
port's elastic case: a target on the meta device restored onto the CPU, as
tests/test_optimality_elastic.py restores onto another mesh), checkpoints
written by the JAX package read by the port (float32 and bfloat16 leaves,
ROADMAP C8), and the launcher end to end with resume on the CPU.

Every restore is exact: the bits saved are the bits restored, bfloat16
included; a resumed step's loss equals the uninterrupted run's within the
reference's rtol 1e-6 (tests/test_runtime.py)."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import TokenTaskStream  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train import optimizer, trainer  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, and these small models' ops gain
    nothing from more threads than that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch="qwen2.5-3b", dtype="float32"):
    return configs.reduced_config(configs.get_config(arch)).scaled(
        vocab_size=128, dtype=dtype)


def _tiny(arch="qwen2.5-3b", dtype="float32", seed=0, device="cpu"):
    cfg = _cfg(arch, dtype)
    st = trainer.init_train_state(Model(cfg, device=device),
                                  torch.Generator().manual_seed(seed))
    tc = configs.TrainConfig(learning_rate=3e-3, warmup_steps=5,
                             total_steps=200)
    return cfg, st, trainer.make_train_step(st.model, tc)


def _fresh(cfg, device="cpu"):
    return trainer.TrainState(model=Model(cfg, device=device),
                              opt=optimizer.init_opt_state(
                                  Model(cfg, device=device)))


def _assert_same_state(a, b):
    sa, sb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
        assert torch.equal(a.opt.m[k], b.opt.m[k]), k
        assert torch.equal(a.opt.v[k], b.opt.v[k]), k
    assert a.opt.step == b.opt.step


# ---------------------------------------------------------------------------
# tests/test_runtime.py's checkpoint checks on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [("qwen2.5-3b", "float32"),
                                        ("mamba2-130m", "bfloat16")])
def test_checkpoint_roundtrip_and_resume(tmp_path, arch, dtype):
    cfg, state, step_fn = _tiny(arch, dtype)
    stream = TokenTaskStream(cfg.vocab_size, 32, 8, seed=0)
    for i in range(3):
        state, _ = step_fn(state, stream.batch_for_step(i))
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 3, state)
    assert ckpt.latest_step(d) == 3
    restored, start = ft.resume_or_init(d, lambda: _fresh(cfg))
    assert start == 3
    _assert_same_state(state, restored)
    # continue from the restored state: the same next loss
    _, m_res = step_fn(restored, stream.batch_for_step(3))
    _, m_direct = step_fn(state, stream.batch_for_step(3))
    np.testing.assert_allclose(float(m_direct["loss"]), float(m_res["loss"]),
                               rtol=1e-6)
    _assert_same_state(state, restored)


def test_async_checkpointer(tmp_path):
    cfg, state, _ = _tiny()
    d = str(tmp_path / "ckpt")
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ac.save(s, state)
    ac.wait()
    assert ckpt.latest_step(d) == 3
    steps = sorted(os.listdir(d))
    assert len([x for x in steps if x.startswith("step_")]) == 2  # keep=2


def test_async_save_copies_before_returning(tmp_path, monkeypatch):
    """The leaves go to the host on the calling thread: a step taken right
    after ``save`` returns does not reach the checkpoint. The writer is held
    until that step has written the parameters in place, so the check does
    not depend on which thread runs first."""
    cfg, state, step_fn = _tiny()
    stepped = threading.Event()
    write = ckpt._write

    def held_write(*args):
        assert stepped.wait(60)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", held_write)
    d = str(tmp_path / "ckpt")
    ac = ckpt.AsyncCheckpointer(d)
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    ac.save(1, state)
    state, _ = step_fn(state, TokenTaskStream(cfg.vocab_size, 16, 4)
                       .batch_for_step(0))
    stepped.set()
    ac.wait()
    after = dict(state.model.named_parameters())
    assert any(not torch.equal(after[k], before[k]) for k in before)
    got = ckpt.restore(d, {"params": before}, step=1)
    assert all(torch.equal(got["params"][k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# layout, keep, trees
# ---------------------------------------------------------------------------

def test_layout_manifest_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "inner": {"b": torch.ones(4, dtype=torch.bfloat16),
                      "s": torch.tensor(2.5), "h": torch.tensor(
                          -1.5, dtype=torch.bfloat16)}, "n": 7}
    for s in (5, 10, 15, 20):
        path = ckpt.save(d, s, tree, keep=3)
    assert path == os.path.join(d, "step_000000020")
    assert sorted(os.listdir(d)) == ["step_000000010", "step_000000015",
                                     "step_000000020"]
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 20
    assert man["leaves"]["w"]["dtype"] == "float32"
    assert man["leaves"]["w"]["shape"] == [2, 3]
    assert man["leaves"]["inner###b"]["dtype"] == "bfloat16"
    raw = np.load(os.path.join(path, man["leaves"]["inner###b"]["file"]))
    assert raw.dtype == np.uint16 and raw[0] == 0x3F80   # 1.0 in bfloat16
    assert man["leaves"]["n"]["dtype"] == "int32"
    got = ckpt.restore(d, tree)
    assert torch.equal(got["w"], tree["w"]) and got["n"] == 7
    for k in ("b", "s", "h"):
        assert got["inner"][k].dtype == tree["inner"][k].dtype
        assert got["inner"][k].shape == tree["inner"][k].shape
        assert torch.equal(got["inner"][k], tree["inner"][k])
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(str(d), 3, {"w": torch.zeros(2)})
    (d / "step_000000009.tmp").mkdir()
    assert ckpt.latest_step(str(d)) == 3


def test_restore_checks_shape_and_dtype(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="stored"):
        ckpt.restore(d, {"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="stored"):
        ckpt.restore(d, {"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    with pytest.raises(KeyError):
        ckpt.restore(d, {"v": torch.zeros(2, 3)})


def test_bfloat16_bits_survive(tmp_path):
    """Every bfloat16 bit pattern (the finite ones) round-trips."""
    bits = torch.arange(-32768, 32767, dtype=torch.int32).to(torch.int16)
    w = bits.view(torch.bfloat16)
    w = w[torch.isfinite(w)]
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": w})
    got = ckpt.restore(d, {"w": w})["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), w.view(torch.int16))


# ---------------------------------------------------------------------------
# restore onto another device; resume_or_init
# ---------------------------------------------------------------------------

def test_elastic_restore_onto_another_device(tmp_path):
    """A state saved from the CPU restores into a model built on the meta
    device (shapes only), materialized on the CPU by ``device=``; and a
    tree of meta tensors restores onto the CPU."""
    cfg, state, step_fn = _tiny("mamba2-130m", "bfloat16")
    state, _ = step_fn(state, TokenTaskStream(cfg.vocab_size, 16, 4)
                       .batch_for_step(0))
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, state)
    target = trainer.TrainState(model=Model(cfg, device="meta"),
                                opt=optimizer.init_opt_state(
                                    Model(cfg, device="meta")))
    restored = ckpt.restore(d, target, step=5, device="cpu")
    assert restored.model.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in restored.opt.m.values())
    _assert_same_state(state, restored)
    tree = {"w": torch.empty(8, 8, device="meta"),
            "b": torch.empty(8, device="meta")}
    ckpt.save(d, 6, {"w": torch.arange(64.).reshape(8, 8),
                     "b": torch.ones(8)})
    got = ckpt.restore(d, tree, step=6, device="cpu")
    assert got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(64).reshape(8, 8))


def test_restore_into_a_meta_model_needs_a_device(tmp_path):
    """A model on the meta device holds no storage: restoring into it
    without ``device=`` raises rather than returning a state of no data."""
    cfg, state, _ = _tiny()
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, state)
    target = trainer.TrainState(model=Model(cfg, device="meta"),
                                opt=optimizer.init_opt_state(
                                    Model(cfg, device="meta")))
    with pytest.raises(ValueError, match="meta"):
        ckpt.restore(d, target)
    with pytest.raises(ValueError, match="meta"):
        ft.resume_or_init(d, lambda: pytest.fail("init_fn called"),
                          target_shape=target)


def test_resume_or_init_without_a_checkpoint(tmp_path):
    cfg = _cfg()
    made = []

    def init():
        made.append(1)
        return _fresh(cfg)

    state, start = ft.resume_or_init(str(tmp_path / "empty"), init)
    assert start == 0 and len(made) == 1 and state.opt.step == 0


def test_resume_or_init_onto_a_target_shape(tmp_path):
    cfg, state, _ = _tiny()
    d = str(tmp_path / "ck")
    ckpt.save(d, 4, state)
    target = trainer.TrainState(model=Model(cfg, device="meta"),
                                opt=optimizer.init_opt_state(
                                    Model(cfg, device="meta")))
    restored, start = ft.resume_or_init(
        d, lambda: pytest.fail("init_fn called"), target_shape=target,
        device="cpu")
    assert start == 4
    _assert_same_state(state, restored)


# ---------------------------------------------------------------------------
# checkpoints written by the JAX package (ROADMAP C8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_with_its_dtype(tmp_path, dtype):
    """The reference's ``save`` of a float32 or bfloat16 leaf; its own
    ``restore`` gives a bfloat16 leaf back as raw 2-byte voids (C8), the
    port's gives it back as bfloat16, bit for bit."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tree = {"w": jnp.asarray(w).astype(jdt), "v": jnp.ones(3, jnp.float32),
            "step": jnp.int32(9)}
    d = str(tmp_path / "ck")
    jckpt.save(d, 9, tree)
    back = jckpt.restore(d, tree, step=9)
    if dtype == "bfloat16":
        assert back["w"].dtype.kind == "V"          # C8: the dtype is lost
    target = {"w": torch.zeros(3, 5, dtype=getattr(torch, dtype)),
              "v": torch.zeros(3), "step": 0}
    got = ckpt.restore(d, target)
    assert got["w"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(tree["w"], np.float32))
    np.testing.assert_array_equal(got["v"].numpy(), np.ones(3, np.float32))
    assert got["step"] == 9


def test_reference_train_state_restores_into_the_port(tmp_path):
    """A reference TrainState checkpoint (bfloat16 params, float32
    moments) read leaf by leaf into the port's tensors."""
    from repro.configs import get_config as jget, reduced_config as jred
    from repro.models import build_model as jbuild
    from repro.train import optimizer as jopt

    jcfg = jred(jget("mamba2-130m")).scaled(dtype="bfloat16")
    params = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    opt = jopt.init_opt_state(params)
    d = str(tmp_path / "ck")
    jckpt.save(d, 2, {"params": params, "opt": opt})
    w = np.asarray(params["layers"]["mamba"]["w_in"], np.float32)
    target = {"params": {"layers": {"mamba": {
        "w_in": torch.zeros(w.shape, dtype=torch.bfloat16)}}}}
    with open(os.path.join(d, "step_000000002", "manifest.json")) as f:
        keys = json.load(f)["leaves"]
    assert keys["params###layers###mamba###w_in"]["dtype"] == "bfloat16"
    assert keys["opt###m###embed"]["dtype"] == "float32"
    got = ckpt.restore(d, target)
    np.testing.assert_array_equal(
        got["params"]["layers"]["mamba"]["w_in"].float().numpy(), w)


# ---------------------------------------------------------------------------
# the launcher (tests/test_analysis_and_launchers.py on the port)
# ---------------------------------------------------------------------------

def test_train_launcher_e2e_with_resume(tmp_path):
    from repro_torch.launch import train as train_cli

    d = str(tmp_path / "ck")
    state, losses = train_cli.main([
        "--arch", "qwen2.5-3b", "--reduced", "--steps", "12",
        "--batch", "4", "--seq", "16", "--ckpt-dir", d,
        "--ckpt-every", "5", "--log-every", "50", "--device", "cpu"])
    assert len(losses) == 12
    assert np.all(np.isfinite(losses))
    assert state.opt.step == 12 and ckpt.latest_step(d) == 12
    # resume: starts from the saved step, runs the remainder only
    state2, losses2 = train_cli.main([
        "--arch", "qwen2.5-3b", "--reduced", "--steps", "14",
        "--batch", "4", "--seq", "16", "--ckpt-dir", d,
        "--ckpt-every", "50", "--log-every", "50", "--device", "cpu"])
    assert len(losses2) == 2  # resumed at 12
    assert state2.opt.step == 14


def test_train_launcher_cox_objective_and_steps(tmp_path):
    from repro_torch.launch import train as train_cli

    seen = []
    state, losses = train_cli.main([
        "--arch", "mamba2-130m", "--reduced", "--objective", "cox",
        "--steps", "3", "--batch", "8", "--seq", "12", "--log-every", "1",
        "--device", "cpu", "--microbatch", "2"],
        on_step=lambda s, m: seen.append(s))
    assert seen == [0, 1, 2] and len(losses) == 3
    assert state.model.cox_head is not None
    head = state.model.cox_head["w"]
    assert head.dtype == torch.float32 and head.shape == (64, 1)


def test_train_launcher_build_state_head_seed():
    """The Cox head is drawn from a generator seeded 7, whatever --seed."""
    from repro_torch.launch import train as train_cli
    from repro_torch.survival.head import init_cox_head

    cfg = _cfg("mamba2-130m")
    st = train_cli.build_state(Model(cfg, device="cpu"), "cox",
                               torch.Generator().manual_seed(3))
    want = init_cox_head(torch.Generator().manual_seed(7), cfg.d_model,
                         "cpu")
    assert torch.equal(st.model.cox_head["w"], want["w"])
    assert sorted(st.opt.m) == sorted(dict(st.model.named_parameters()))


def test_train_launcher_rejects_the_production_mesh(capsys):
    """On a world of one rank, --production-mesh fails naming the 256
    ranks its 16 x 16 mesh needs, and makes no process group."""
    import torch.distributed as dist

    from repro_torch.launch import train as train_cli

    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "qwen2.5-3b", "--reduced",
                        "--production-mesh", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "needs a world of 256 ranks; this one has 1" in err
    assert not dist.is_initialized()


def test_train_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch import train as train_cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "1"])


def test_train_launcher_runs_as_a_module(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "TMPDIR": str(tmp_path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "8", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] done" in res.stdout
    assert (tmp_path / "repro_torch" / "heartbeat.json").is_file()
