"""The port's sharded training on a (data, model) mesh: a ``gloo`` world of 4
ranks on the CPU as a (2, 2) ``DeviceMesh``, each rank a subprocess.

Reduced dense (qwen2.5-3b) and mamba2 models, widened where the placement
rules need 1,024 columns to shard (d_ff, vocab; mamba2's d_model 512), are
drawn from one seed on every rank, sharded by ``launch.sharding.shard_model``
in train mode (FSDP over ``data``, TP over ``model``), and stepped three
times by ``trainer.make_train_step`` with AdamW under ``mesh_context``; a
copy of the same state steps beside them as plain tensors. The first
step's gradients hold the plain ones within GRAD_TOL of the largest, the
sharded losses within LOSS_RTOL (float32; the sums run in another order),
and the parameters after three steps within PARAM_TOL of the model's max
|p|. The Cox objective's risk set spans the whole batch,
which ``put_batch`` splits over ``data``. A checkpoint saved on the (2, 2)
mesh restores bit for bit onto (4, 1) in the same world (into a sharded
target, and into a plain one through ``shardings=``) and onto (1, 1) in a
world of one rank. The moe, hybrid, encdec and vlm families hold one
sharded loss and its gradients against the plain port. A rank leaves by
``os._exit(0)`` after a barrier, as in tests/test_torch_distributed.py.
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
GRAD_TOL = 1e-5

COMMON = r"""
import copy, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
torch.set_num_threads(1)
from repro_torch.configs import TrainConfig, get_config, reduced_config
from repro_torch.data.pipeline import (SurvivalTextStream, TokenTaskStream,
                                       put_batch)
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.launch.train import build_state
from repro_torch.models import pspec
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import init_opt_state, lr_schedule
from repro_torch.train.trainer import make_loss_fn, make_train_step
CASES = {"dense": ("qwen2.5-3b", "lm", dict(d_ff=1024, vocab_size=1024)),
         "mamba2": ("mamba2-130m", "lm", dict(d_model=512, vocab_size=1024)),
         "cox": ("mamba2-130m", "cox", dict(d_model=512, vocab_size=1024))}
FAMILIES = ("mixtral-8x7b", "zamba2-2.7b", "seamless-m4t-large-v2",
            "qwen2-vl-7b")
BATCH, SEQ, STEPS = 8, 8, 3


def fresh(case, seed):
    arch, objective, scale = CASES[case]
    cfg = reduced_config(get_config(arch)).scaled(**scale)
    return build_state(Model(cfg, device="cpu"), objective,
                       torch.Generator().manual_seed(seed)), objective


def shard(state, mesh):
    sharding.shard_model(state.model, mesh, "train")
    state.opt = init_opt_state(state.model)
    return state


def full(t):
    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()


def bits_equal(state, want):
    got = {"params": {n: full(p) for n, p in
                      state.model.named_parameters()},
           "m": {n: full(t) for n, t in state.opt.m.items()},
           "v": {n: full(t) for n, t in state.opt.v.items()}}
    return all(np.array_equal(got[k][n], want[k][n])
               for k in want for n in want[k]) and state.opt.step == STEPS


def placed(state, mesh):
    return all(tuple(p.placements) == sharding.param_spec(n, p.shape, mesh)
               and tuple(state.opt.m[n].placements) == tuple(p.placements)
               for n, p in state.model.named_parameters())
"""

RANK = COMMON + r"""
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                        rank=rank, world_size=world)
mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
res = {}
for case in CASES:
    state, objective = fresh(case, 0)
    plain = copy.deepcopy(state)
    shard(state, mesh)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    stream = (TokenTaskStream if objective == "lm" else SurvivalTextStream)(
        state.model.cfg.vocab_size, SEQ, BATCH, seed=0)
    step_s = make_train_step(state.model, tcfg, objective)
    step_p = make_train_step(plain.model, tcfg, objective)
    rows = put_batch(stream.batch_for_step(0), mesh)
    grads = {}
    for kind, st, where in (("sharded", state, mesh), ("plain", plain, "cpu")):
        with mesh_lib.mesh_context(mesh if kind == "sharded" else None):
            loss, _ = make_loss_fn(st.model, objective)(
                put_batch(stream.batch_for_step(0), where))
            params = list(st.model.parameters())
            got = torch.autograd.grad(pspec.whole(loss), params,
                                      allow_unused=True)
            # a parameter the objective does not reach (the Cox loss
            # leaves the LM head) has no gradient in either
            grads[kind] = [None if g is None else full(g) for g in got]
    r = {"loss": [], "loss_plain": [], "gnorm": [], "gnorm_plain": [],
         "local_rows": [int(t.to_local().shape[0]) for t in rows.values()],
         "n_sharded": sum(any(isinstance(s, Shard)
                              for s in p.placements)
                          for p in state.model.parameters()),
         "placed": placed(state, mesh)}
    with mesh_lib.mesh_context(mesh):
        for i in range(STEPS):
            batch = stream.batch_for_step(i)
            state, ms = step_s(state, batch)
            plain, mp = step_p(plain, batch)
            r["loss"].append(float(ms["loss"]))
            r["loss_plain"].append(float(mp["loss"]))
            r["gnorm"].append(float(ms["grad_norm"]))
            r["gnorm_plain"].append(float(mp["grad_norm"]))
    pairs = list(zip(grads["sharded"], grads["plain"]))
    assert all((a is None) == (b is None) for a, b in pairs)
    r["grad_err"] = max(float(np.abs(a - b).max()) for a, b in pairs
                        if b is not None)
    r["grad_max"] = max(float(np.abs(b).max()) for _, b in pairs
                        if b is not None)
    want = dict(plain.model.named_parameters())
    r["param_err"] = {n: float(np.abs(full(p) - full(want[n])).max())
                      for n, p in state.model.named_parameters()}
    r["lr"] = [float(lr_schedule(i + 1, tcfg)) for i in range(STEPS)]
    r["param_max"] = max(float(np.abs(full(p)).max())
                         for p in want.values())
    res[case] = r
    if case == "dense":
        saved = state
# the other families: one step's loss and gradients, sharded and plain
rng = np.random.default_rng(1)
for arch in FAMILIES:
    cfg = reduced_config(get_config(arch)).scaled(d_ff=1024,
                                                  vocab_size=1024)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    plain = copy.deepcopy(model)
    sharding.shard_model(model, mesh, "train")
    batch = {"labels": rng.integers(0, 1024, (BATCH, SEQ)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(0, 1024, (BATCH, SEQ)).astype(np.int32)
    elif cfg.frontend in ("audio", "vision"):
        batch["embeds"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(SEQ, dtype=np.int32), (3, BATCH, SEQ)))
    else:
        batch["tokens"] = rng.integers(0, 1024, (BATCH, SEQ)).astype(np.int32)
    r = {}
    for kind, m, where in (("sharded", model, mesh), ("plain", plain, "cpu")):
        with mesh_lib.mesh_context(mesh if kind == "sharded" else None):
            loss, _ = make_loss_fn(m, "lm")(put_batch(batch, where))
            loss = pspec.whole(loss)
            got = torch.autograd.grad(loss, list(m.parameters()),
                                      allow_unused=True)
        r[kind] = (float(loss), [None if g is None else full(g)
                                 for g in got])
    pairs = list(zip(r["sharded"][1], r["plain"][1]))
    assert all((a is None) == (b is None) for a, b in pairs)
    res[arch] = {"loss": r["sharded"][0], "loss_plain": r["plain"][0],
                 "grad_err": max(float(np.abs(a - b).max())
                                 for a, b in pairs if b is not None),
                 "grad_max": max(float(np.abs(b).max())
                                 for _, b in pairs if b is not None),
                 "n_sharded": sum(any(isinstance(s, Shard)
                                      for s in p.placements)
                                  for p in model.parameters())}
# the (2, 2) checkpoint, restored onto (4, 1) in this world
path = ckpt_lib.save(os.path.join(out, "ckpt"), STEPS, saved)
want = {"params": {n: full(p) for n, p in saved.model.named_parameters()},
        "m": {n: full(t) for n, t in saved.opt.m.items()},
        "v": {n: full(t) for n, t in saved.opt.v.items()}}
if rank == 0:
    np.savez(os.path.join(out, "want.npz"), **{
        f"{k}/{n}": a for k in want for n, a in want[k].items()})
dist.barrier()
mesh41 = mesh_lib.make_mesh((4, 1), ("data", "model"), "cpu")
target = shard(fresh("dense", 1)[0], mesh41)
ckpt_lib.restore(os.path.join(out, "ckpt"), target)
res["restore_4x1"] = {"bits": bits_equal(target, want),
                      "placed": placed(target, mesh41)}
plain_target = fresh("dense", 2)[0]
ckpt_lib.restore(os.path.join(out, "ckpt"), plain_target,
                 shardings=sharding.state_shardings(plain_target.model,
                                                    mesh41))
res["restore_4x1_shardings"] = {"bits": bits_equal(plain_target, want),
                                "placed": placed(plain_target, mesh41)}
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
print("RANK_SAVED", flush=True)
dist.barrier()
print("RANK_OK", flush=True)
os._exit(0)
"""

ONE = COMMON + r"""
out = sys.argv[1]
mesh = mesh_lib.make_host_mesh("cpu")
arrays = np.load(os.path.join(out, "want.npz"))
want = {}
for key in arrays.files:
    k, n = key.split("/", 1)
    want.setdefault(k, {})[n] = arrays[key]
target = shard(fresh("dense", 1)[0], mesh)
ckpt_lib.restore(os.path.join(out, "ckpt"), target)
res = {"bits": bits_equal(target, want), "placed": placed(target, mesh),
       "world": dist.get_world_size(), "mesh": list(mesh.shape)}
with open(os.path.join(out, "one.json"), "w") as f:
    json.dump(res, f)
print("RANK_OK", flush=True)
os._exit(0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("XLA_FLAGS", None)
    return env


def _check(proc, what, timeout=RANK_TIMEOUT):
    try:
        so, se = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "RANK_OK" in so, (
        f"{what}: rc {proc.returncode}\n{so}\n---\n{se}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results of the (2, 2) world, and the one-rank
    restore's."""
    out = tmp_path_factory.mktemp("mesh")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "4", str(out),
         str(out / "store")], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        for r, p in enumerate(procs):
            _check(p, f"rank {r} of 4")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    one = subprocess.Popen([sys.executable, "-c", ONE, str(out)], env=_env(),
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    _check(one, "the one-rank restore")
    ranks = []
    for r in range(4):
        with open(out / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    with open(out / "one.json") as f:
        return ranks, json.load(f)


@pytest.mark.parametrize("case", ["dense", "mamba2", "cox"])
def test_sharded_steps_match_the_plain_port(world, case):
    """Three AdamW steps on the (2, 2) mesh against the same steps on
    plain tensors: the first step's every gradient within GRAD_TOL of the
    largest, the losses and global gradient norms within LOSS_RTOL, the
    parameters within PARAM_TOL of max |p|, on every rank alike. The Cox
    head's bias is the exception: its exact gradient is 0 (the partial
    likelihood does not change when one constant is added to every risk
    score), so AdamW moves it by +-lr on the round-off of the two sums; it
    is held within 2 lr a step."""
    ranks, _ = world
    r = ranks[0][case]
    assert r["n_sharded"] > 0 and r["placed"]
    assert r["grad_err"] <= GRAD_TOL * r["grad_max"], r
    np.testing.assert_allclose(r["loss"], r["loss_plain"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["gnorm"], r["gnorm_plain"], rtol=LOSS_RTOL)
    for name, err in r["param_err"].items():
        tol = 2 * sum(r["lr"]) if name == "cox_head.b" \
            else PARAM_TOL * r["param_max"]
        assert err <= tol, (name, err, tol)
    for other in ranks[1:]:
        assert other[case]["loss"] == r["loss"]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2", "qwen2-vl-7b"])
def test_other_families_match_the_plain_port(world, arch):
    """The moe, hybrid, encdec and vlm families (reduced, d_ff 1,024 and
    vocab 1,024 so that the rules shard): one sharded loss within
    LOSS_RTOL and its every gradient within GRAD_TOL of the largest, held
    against the plain port (the MoE's routes and capacity are the whole
    batch's: its experts run on the gathered routes)."""
    ranks, _ = world
    r = ranks[0][arch]
    assert r["n_sharded"] > 0
    np.testing.assert_allclose(r["loss"], r["loss_plain"], rtol=LOSS_RTOL)
    assert r["grad_err"] <= GRAD_TOL * r["grad_max"], r


def test_the_batch_is_split_over_data(world):
    """Each rank holds half the rows of every batch leaf (data = 2): the
    Cox risk set is gathered whole before its sort, or the losses above
    would differ."""
    ranks, _ = world
    for case in ("dense", "cox"):
        assert set(ranks[0][case]["local_rows"]) == {4}


@pytest.mark.parametrize("how", ["restore_4x1", "restore_4x1_shardings"])
def test_checkpoint_restores_onto_4x1(world, how):
    """Saved on (2, 2), restored onto (4, 1): parameters and moments bit
    for bit, placed by (4, 1)'s rules."""
    ranks, _ = world
    for r in ranks:
        assert r[how] == {"bits": True, "placed": True}, how


def test_checkpoint_restores_onto_1x1(world):
    _, one = world
    assert one == {"bits": True, "placed": True, "world": 1,
                   "mesh": [1, 1]}
