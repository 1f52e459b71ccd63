"""The port's sharded serving on a (data, model) mesh: a ``gloo`` world of 4
ranks on the CPU, each rank a subprocess.

Every architecture, reduced and widened to d_ff and vocab 1,024 (float32),
is drawn from one seed on every rank, sharded by
``launch.sharding.shard_model`` in "serve" mode (TP only) on a (2, 2) mesh,
and runs ``prefill`` and 4 decode steps under ``mesh_context`` beside a
plain copy fed the same prompts and tokens. The decode cache keeps the
reference's placements (``cache_spec``: batch over ``data``, a K/V
cache's slots over ``model``, the flash-decode layout), so every K/V
write lands in slots split over ``model``: the rolling sliding-window
cache (mixtral, with a prompt shorter than its window and one longer),
gemma3's local windows, the hybrid's attention and SSM caches and the
encoder-decoder's cross-attention cache. qwen2.5-3b and mixtral-8x7b also
run on (1, 4), which splits the slots four ways and the batch not at all.
Prefill logits, every cache leaf and each decode step's logits are held
within TOL x max(1, max |value|) of the plain port's. ``serve_batch`` on
the sharded model gives the plain model's greedy tokens. A rank leaves by
``os._exit(0)`` after a barrier, as in tests/test_torch_distributed.py.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RANK_TIMEOUT = 300
TOL = 1e-5
ARCHS = ("qwen2.5-3b", "qwen1.5-4b", "gemma3-12b", "deepseek-67b",
         "seamless-m4t-large-v2", "mixtral-8x7b", "mixtral-8x22b",
         "qwen2-vl-7b", "mamba2-130m", "zamba2-2.7b")
# (case, arch, mesh, prompt length, cache capacity): mixtral's reduced
# window is 16 slots, gemma3's local window 8 positions
CASES = [(f"2x2-{a}", a, (2, 2), 12, 20) for a in ARCHS] + [
    ("2x2-mixtral-8x7b-past-window", "mixtral-8x7b", (2, 2), 19, 28),
    ("1x4-qwen2.5-3b", "qwen2.5-3b", (1, 4), 12, 20),
    ("1x4-mixtral-8x7b", "mixtral-8x7b", (1, 4), 20, 28)]
SERVED = ("qwen2.5-3b", "mixtral-8x7b", "seamless-m4t-large-v2")

RANK = r"""
import copy, json, os, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import put_batch
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.models.model import Model

CASES, SERVED = json.loads(sys.argv[4]), json.loads(sys.argv[5])
B, STEPS = 4, 4
rank, out = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        rank=rank, world_size=4)
meshes = {}


def full(t):
    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).float().numpy()


def err(a, b):
    a, b = full(a), full(b)
    return [float(np.abs(a - b).max()), float(np.abs(b).max())]


def models(arch, mesh):
    cfg = reduced_config(get_config(arch)).scaled(d_ff=1024,
                                                  vocab_size=1024)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    plain = copy.deepcopy(model)
    sharding.shard_model(model, mesh, "serve")
    return cfg, model, plain


def run(case, arch, shape, plen, cap):
    mesh = meshes.get(tuple(shape))
    if mesh is None:
        mesh = meshes[tuple(shape)] = mesh_lib.make_mesh(
            shape, ("data", "model"), "cpu")
    cfg, model, plain = models(arch, mesh)
    rng = np.random.default_rng(0)
    batch = {}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (B, plen, cfg.d_model)).astype(np.float32)
    if cfg.frontend in ("audio", "vision") and cfg.family != "encdec":
        batch["embeds"] = rng.standard_normal(
            (B, plen, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, 1024, (B, plen)).astype(np.int32)
    toks = rng.integers(0, 1024, (STEPS, B, 1)).astype(np.int32)
    with mesh_lib.mesh_context(mesh):
        ls, cs = model.prefill(put_batch(batch, mesh), max_len=cap)
    lp, cp = plain.prefill(put_batch(batch, "cpu"), max_len=cap)
    r = {"prefill": err(ls, lp),
         "cache": {n: err(a, b) for n, a, b in zip(cs._fields, cs, cp)},
         "placed": all(tuple(t.placements) == sharding.cache_spec(
             n, tuple(t.shape), mesh) for n, t in zip(cs._fields, cs)),
         "slots": int(cs.k.shape[2]) if "k" in cs._fields else 0,
         "decode": []}
    for i in range(STEPS):
        with mesh_lib.mesh_context(mesh):
            ls, cs = model.decode_step(cs, put_batch({"t": toks[i]},
                                                     mesh)["t"])
        lp, cp = plain.decode_step(cp, torch.as_tensor(toks[i]))
        r["decode"].append(err(ls, lp))
    r["cache_after"] = {n: err(a, b) for n, a, b in zip(cs._fields, cs, cp)}
    return r


def served(arch):
    # serve_batch's greedy tokens on the sharded model and the plain
    mesh = meshes[(2, 2)]
    cfg, model, plain = models(arch, mesh)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 7, 9)]
    src = rng.standard_normal((4, 9, cfg.d_model)).astype(np.float32) \
        if cfg.family == "encdec" else None
    outs = []
    for m, ctx in ((model, mesh), (plain, None)):
        reqs = [Request(rid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        with mesh_lib.mesh_context(ctx):
            outs.append([r.out for r in serve_batch(m, reqs,
                                                    src_embeds=src)])
    return outs


# a case that raises fails its own tests only (every rank raises alike)
res = {}
for case in CASES:
    try:
        res[case[0]] = run(*case)
    except Exception:
        res[case[0]] = {"error": traceback.format_exc()}
for arch in SERVED:
    try:
        res[f"served-{arch}"] = served(arch)
    except Exception:
        res[f"served-{arch}"] = {"error": traceback.format_exc()}
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
    """Every rank's results of the 4-rank world."""
    out = tmp_path_factory.mktemp("serve")
    args = [json.dumps(CASES), json.dumps(SERVED)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(out), str(out / "store"),
         *args], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
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


def _close(what, pair):
    diff, scale = pair
    assert diff <= TOL * max(1.0, scale), (what, diff, scale)


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("case", NAMES)
def test_sharded_prefill_matches_the_plain_port(ranks, case):
    """The last position's logits and every cache leaf the sharded
    prefill writes, against the plain prefill's; the cache on
    ``cache_spec``'s placements."""
    for r in ranks:
        got = r[case]
        assert "error" not in got, got["error"]
        assert got["placed"]
        _close("logits", got["prefill"])
        for name, pair in got["cache"].items():
            _close(name, pair)


@pytest.mark.parametrize("case", NAMES)
def test_sharded_decode_matches_the_plain_port(ranks, case):
    """Each of 4 decode steps' logits, and every cache leaf after them,
    against the plain port's."""
    for r in ranks:
        got = r[case]
        assert "error" not in got, got["error"]
        for i, pair in enumerate(got["decode"]):
            _close(f"decode step {i + 1}", pair)
        for name, pair in got["cache_after"].items():
            _close(name, pair)


def test_the_cases_split_the_slots_over_model(ranks):
    """Each attention case's K/V cache has slots that its mesh's
    ``model`` size splits into shards of more than one slot, so the
    writes above land in split slots; mixtral's long prompts are longer
    than its window, so its cache rolls."""
    for case, arch, shape, plen, cap in CASES:
        assert "error" not in ranks[0][case], ranks[0][case]["error"]
        slots = ranks[0][case]["slots"]
        if arch == "mamba2-130m":
            assert slots == 0
            continue
        assert slots % shape[1] == 0 and slots // shape[1] > 1, case
        if arch.startswith("mixtral") and plen > 16:
            assert plen > slots == 16, case


@pytest.mark.parametrize("arch", SERVED)
def test_serve_batch_on_the_mesh(ranks, arch):
    """``serve_batch`` of a model sharded in serve mode gives the plain
    model's greedy tokens on every rank."""
    for r in ranks:
        got = r[f"served-{arch}"]
        assert "error" not in got, got["error"]
        sharded, plain = got
        assert sharded == plain
        assert [len(o) for o in plain] == [6] * 4
