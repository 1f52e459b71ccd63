"""The port's microbatched and other families' sharded steps on a (data,
model) mesh: a ``gloo`` world of 4 ranks on the CPU as a (2, 2)
``DeviceMesh``, each rank a subprocess.

Microbatching (``TrainConfig(microbatch=2)``): reduced dense (qwen2.5-3b)
under ``lm`` and mamba2 under ``cox``, widened where the placement rules
need 1,024 columns to shard, are drawn from one seed on every rank,
sharded in train mode and stepped three times by
``trainer.make_train_step`` under ``mesh_context``; a copy of the same
state takes the same microbatched steps beside them as plain tensors.
Each microbatch is rows i*B/k .. (i+1)*B/k - 1 of the batch, as the
reference's, and is itself split over ``data``: the step's every loss
call is read for its batch's placements. A microbatch that does not split
over the data ranks raises.

The moe, hybrid, encdec and vlm families (mixtral-8x7b, zamba2-2.7b,
seamless-m4t-large-v2, qwen2-vl-7b; reduced, d_ff and vocab 1,024) take
three sharded AdamW steps against the same steps of the plain port.

Losses are held within LOSS_RTOL of the plain port's (float32; the sums
run in another order) and the parameters after three steps within
PARAM_TOL of the model's max |p|; the Cox head's bias within 2 lr a step
(its exact gradient is 0, tests/test_torch_mesh_train.py). A rank leaves
by ``os._exit(0)`` after a barrier, as in tests/test_torch_distributed.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RANK_TIMEOUT = 300
LOSS_RTOL = 2e-5
PARAM_TOL = 1e-4
MICRO = ("dense", "cox")
FAMILIES = ("mixtral-8x7b", "zamba2-2.7b", "seamless-m4t-large-v2",
            "qwen2-vl-7b")

RANK = r"""
import copy, json, os, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
torch.set_num_threads(1)
from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.data.pipeline import SurvivalTextStream, TokenTaskStream
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.launch.train import build_state
from repro_torch.models.model import Model
from repro_torch.train import trainer
from repro_torch.train.optimizer import init_opt_state, lr_schedule

CASES = {"dense": ("qwen2.5-3b", "lm", dict(d_ff=1024, vocab_size=1024)),
         "cox": ("mamba2-130m", "cox", dict(d_model=512, vocab_size=1024))}
FAMILIES = ("mixtral-8x7b", "zamba2-2.7b", "seamless-m4t-large-v2",
            "qwen2-vl-7b")
BATCH, SEQ, STEPS, K = 8, 8, 3, 2

rank, out = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        rank=rank, world_size=4)
mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
SPLIT = (Shard(0), Replicate())


def full(t):
    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()


def steps(state, plain, tcfg, objective, batches):
    step_s = trainer.make_train_step(state.model, tcfg, objective)
    step_p = trainer.make_train_step(plain.model, tcfg, objective)
    r = {"loss": [], "loss_plain": []}
    for batch in batches:
        with mesh_lib.mesh_context(mesh):
            state, ms = step_s(state, batch)
        plain, mp = step_p(plain, batch)
        r["loss"].append(float(ms["loss"]))
        r["loss_plain"].append(float(mp["loss"]))
    want = dict(plain.model.named_parameters())
    r["param_err"] = {n: float(np.abs(full(p) - full(want[n])).max())
                      for n, p in state.model.named_parameters()}
    r["param_max"] = max(float(np.abs(full(p)).max())
                         for p in want.values())
    r["lr"] = [float(lr_schedule(i + 1, tcfg)) for i in range(STEPS)]
    r["n_sharded"] = sum(any(isinstance(s, Shard) for s in p.placements)
                         for p in state.model.parameters())
    return r


def sharded_copy(state):
    plain = copy.deepcopy(state)
    sharding.shard_model(state.model, mesh, "train")
    state.opt = init_opt_state(state.model)
    return state, plain


def micro(case):
    # three microbatched (k = 2) steps; every loss call's batch read
    arch, objective, scale = CASES[case]
    cfg = reduced_config(get_config(arch)).scaled(**scale)
    state, plain = sharded_copy(build_state(
        Model(cfg, device="cpu"), objective,
        torch.Generator().manual_seed(0)))
    stream = (TokenTaskStream if objective == "lm" else SurvivalTextStream)(
        cfg.vocab_size, SEQ, BATCH, seed=0)
    batches = [stream.batch_for_step(i) for i in range(STEPS)]
    seen = []
    inner = getattr(state.model, "loss_lm" if objective == "lm"
                    else "risk_scores")

    def spy(batch, *a, **kw):
        seen.append({n: [tuple(v.placements) == SPLIT,
                         int(v.to_local().shape[0]), int(v.shape[0])]
                     for n, v in batch.items()})
        return inner(batch, *a, **kw)

    setattr(state.model, inner.__name__, spy)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       microbatch=K)
    r = steps(state, plain, tcfg, objective, batches)
    r["seen"] = seen
    # the microbatches take the reference's rows: i*B/k .. (i+1)*B/k - 1
    mbs = trainer._microbatches(batches[0], K, mesh)
    r["rows"] = all(np.array_equal(full(mb[n]), v[i * BATCH // K:
                                                 (i + 1) * BATCH // K])
                    for i, mb in enumerate(mbs)
                    for n, v in batches[0].items())
    return r


def uneven():
    # a microbatch of one row cannot split over data = 2
    batch = TokenTaskStream(1024, SEQ, BATCH, seed=0).batch_for_step(0)
    try:
        trainer._microbatches(batch, BATCH, mesh)
    except ValueError as e:
        return str(e)
    return "no error"


def family(arch, rng):
    # three AdamW steps of one of the other families
    cfg = reduced_config(get_config(arch)).scaled(d_ff=1024,
                                                  vocab_size=1024)
    state, plain = sharded_copy(build_state(
        Model(cfg, device="cpu"), "lm", torch.Generator().manual_seed(0)))
    batches = []
    for _ in range(STEPS):
        batch = {"labels": rng.integers(0, 1024, (BATCH, SEQ)).astype(
            np.int32)}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal(
                (BATCH, SEQ, cfg.d_model)).astype(np.float32)
            batch["tokens"] = rng.integers(0, 1024, (BATCH, SEQ)).astype(
                np.int32)
        elif cfg.frontend in ("audio", "vision"):
            batch["embeds"] = rng.standard_normal(
                (BATCH, SEQ, cfg.d_model)).astype(np.float32)
            batch["positions"] = np.ascontiguousarray(np.broadcast_to(
                np.arange(SEQ, dtype=np.int32), (3, BATCH, SEQ)))
        else:
            batch["tokens"] = rng.integers(0, 1024, (BATCH, SEQ)).astype(
                np.int32)
        batches.append(batch)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    return steps(state, plain, tcfg, "lm", batches)


# a case that raises fails its own tests only (every rank raises alike)
rng = np.random.default_rng(1)
jobs = [(case, lambda case=case: micro(case)) for case in CASES]
jobs += [("uneven", uneven)]
jobs += [(arch, lambda arch=arch: family(arch, rng)) for arch in FAMILIES]
res = {}
for name, job in jobs:
    try:
        res[name] = job()
    except Exception:
        res[name] = {"error": traceback.format_exc()}
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.barrier()
print("RANK_OK", flush=True)
os._exit(0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the (2, 2) world."""
    out = tmp_path_factory.mktemp("steps")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(out), str(out / "store")],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0 and "RANK_OK" in so, (
                f"rank {r} of 4: rc {p.returncode}\n{so}\n---\n{se}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for r in range(4):
        with open(out / f"rank{r}.json") as f:
            got.append(json.load(f))
    return got


def _hold(ranks, case):
    r = ranks[0][case]
    assert "error" not in r, r["error"]
    assert r["n_sharded"] > 0
    np.testing.assert_allclose(r["loss"], r["loss_plain"], rtol=LOSS_RTOL)
    for name, err in r["param_err"].items():
        tol = 2 * sum(r["lr"]) if name == "cox_head.b" \
            else PARAM_TOL * r["param_max"]
        assert err <= tol, (name, err, tol)
    for other in ranks[1:]:
        assert other[case]["loss"] == r["loss"]


@pytest.mark.parametrize("case", MICRO)
def test_microbatched_steps_match_the_plain_port(ranks, case):
    """Three microbatched (k = 2) AdamW steps on the (2, 2) mesh against
    the plain port's microbatched steps from the same state."""
    _hold(ranks, case)


@pytest.mark.parametrize("case", MICRO)
def test_each_microbatch_is_split_over_data(ranks, case):
    """Every loss call of the microbatched steps gets a batch whose leaves
    are ``Shard(0)`` over ``data`` and replicated over ``model``, half of
    the microbatch's B/k rows on each rank, and the microbatches are the
    reference's row blocks."""
    for r in ranks:
        assert "error" not in r[case], r[case]["error"]
        seen = r[case]["seen"]
        assert len(seen) == 3 * 2
        for batch in seen:
            for leaf in batch.values():
                assert leaf == [True, 2, 4], batch
        assert r[case]["rows"]


def test_a_microbatch_that_does_not_split_over_data_raises(ranks):
    msg = ranks[0]["uneven"]
    assert isinstance(msg, str), msg
    assert "1 rows" in msg and "2 data-parallel ranks" in msg, msg


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_steps_match_the_plain_port(ranks, arch):
    """Three sharded AdamW steps of the moe, hybrid, encdec and vlm
    families against the plain port's."""
    _hold(ranks, arch)
