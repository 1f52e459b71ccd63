"""The port's mesh, placement rules and activation anchors held against the
JAX package: ``models/pspec.py::resolve_spec`` on the cases of
tests/test_pspec.py, and ``launch/sharding.py``'s placements of every
parameter, batch and decode-cache leaf of every architecture at full width,
in train and serve modes, on both production meshes, against the
reference's PartitionSpecs; the mesh dry run's per-device state bytes of
every cell against the same sums over the reference's leaves and specs,
its records on one architecture, and ``collectives_from_comm_counts``
against the reference's ``parse_collectives``.

The reference's side is abstract: ``jax.eval_shape`` of each model's
parameters and ``jax.sharding.AbstractMesh`` for the meshes, so no JAX
mesh is entered (ROADMAP C2). The port's side is the meta device and the
meshes' geometry (names and sizes), with no world of 256 ranks, except in
the subprocesses that make the dry run's fake worlds. Placements and byte
counts are structural and held equal.
"""
import json
import os
import subprocess
import sys
import types

import jax
import pytest

torch = pytest.importorskip("torch")
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import build_model as jbuild, pspec as jpspec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, sharding  # noqa: E402
from repro_torch.models import pspec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = sorted(jconfigs.REGISTRY)
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

NAMES = ("data", "model")
SIZES = (("data", 4), ("model", 2))
POD_NAMES = ("pod", "data", "model")
POD_SIZES = (("pod", 2), ("data", 4), ("model", 2))

# tests/test_pspec.py's resolve_spec cases: (spec, shape, names, sizes,
# dp_include_model)
RESOLVE_CASES = {
    "dp_without_pod": (("dp", None, "model"), (8, 16, 64), NAMES, SIZES,
                       None),
    "dp_with_pod": (("dp", None, "model"), (8, 16, 64), POD_NAMES,
                    POD_SIZES, None),
    "dp_include_model": (("dp",), (16,), NAMES, SIZES, True),
    "divisibility_fallback": (("dp", None, "model"), (6, 16, 65), POD_NAMES,
                              POD_SIZES, None),
    "unknown_axis": (("expert",), (8,), NAMES, SIZES, None),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_spec_matches_reference(case):
    spec, shape, names, sizes, knob = RESOLVE_CASES[case]
    kw = {} if knob is None else {"dp_include_model": knob}
    assert pspec.resolve_spec(spec, shape, names, sizes, **kw) \
        == jpspec.resolve_spec(spec, shape, names, sizes, **kw)


def test_placements_of_a_resolved_spec():
    """A dim over ("pod", "data") is Shard(d) on both mesh dims; a mesh dim
    that shards nothing replicates."""
    assert pspec.placements((("pod", "data"), None, "model"), POD_NAMES) \
        == (Shard(0), Shard(0), Shard(2))
    assert pspec.placements((None, "model"), NAMES) == (Replicate(),
                                                        Shard(1))
    assert pspec.placements((None,), NAMES) == (Replicate(), Replicate())


def test_constrain_and_lift_leave_plain_tensors_alone():
    x = torch.ones(4, 8)
    assert pspec.constrain(x, "dp", None) is x
    with mesh_lib.mesh_context(_geometry("pod16x16")):
        assert pspec.constrain(x, "dp", "model") is x
    assert mesh_lib.current_mesh() is None
    assert pspec.lift(x, torch.zeros(2)) is x


def test_production_mesh_names_the_world_it_needs():
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        mesh_lib.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")


def _geometry(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _abstract(name):
    shape, axes = MESHES[name]
    return jax.sharding.AbstractMesh(shape, axes)


def _ref_placements(spec, axes):
    """A reference PartitionSpec as placements, written out here apart from
    the port's ``pspec.placements``."""
    out = []
    for a in axes:
        dims = [d for d, s in enumerate(tuple(spec))
                if s == a or (isinstance(s, tuple) and a in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _ref_leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_reference(arch, mesh_name):
    """Every parameter of the port's model (one per layer) takes the
    reference's spec of its stacked leaf with the leading L dropped, in
    both modes; the moments take the train-mode spec (ZeRO-1)."""
    jcfg = jconfigs.get_config(arch)
    pshape = jax.eval_shape(jbuild(jcfg).init_params, jax.random.PRNGKey(0))
    amesh, geo = _abstract(mesh_name), _geometry(mesh_name)
    axes = MESHES[mesh_name][1]
    model = Model(configs.get_config(arch), device="meta")
    n_sharded = 0
    for name, p in model.named_parameters():
        keys, stacked = sharding._stacked(name)
        leaf = _ref_leaf(pshape, keys)
        want_shape = leaf.shape[1:] if stacked else leaf.shape
        assert tuple(p.shape) == tuple(want_shape), name
        path = tuple(jax.tree_util.DictKey(k) for k in keys)
        for mode in ("train", "serve"):
            ref = tuple(jsh.param_spec(path, leaf.shape, amesh, mode))
            ref += (None,) * (len(leaf.shape) - len(ref))
            if stacked:
                assert ref[0] is None, (name, ref)
                ref = ref[1:]
            got = sharding.param_spec(name, p.shape, geo, mode)
            assert got == _ref_placements(ref, axes), (name, mode, ref, got)
            n_sharded += any(isinstance(s, Shard) for s in got)
        assert sharding.opt_spec(name, p.shape, geo) == \
            sharding.param_spec(name, p.shape, geo, "train")
    assert n_sharded > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_placements_match_reference(arch, mesh_name):
    """Every batch leaf of every shape cell, and every decode-cache leaf of
    the decode cells, against the reference's specs."""
    jmodel = jbuild(jconfigs.get_config(arch))
    model = Model(configs.get_config(arch), device="meta")
    amesh, geo = _abstract(mesh_name), _geometry(mesh_name)
    axes = MESHES[mesh_name][1]
    for shape in configs.SHAPES.values():
        jbatch = jmodel.make_input_specs(shape)
        batch = model.make_input_specs(shape)
        assert sorted(jbatch) == sorted(batch)
        got = sharding.batch_shardings(batch, geo)
        for k, leaf in jbatch.items():
            ref = jsh.batch_spec((jax.tree_util.DictKey(k),), leaf.shape,
                                 amesh)
            ref = tuple(ref) + (None,) * (len(leaf.shape) - len(ref))
            assert got[k].placements == _ref_placements(ref, axes), (
                shape.name, k)
        if shape.kind != "decode":
            continue
        jcache = jmodel.init_cache_specs(shape.global_batch, shape.seq_len)
        cache = model.init_cache_specs(shape.global_batch, shape.seq_len)
        got = sharding.cache_shardings(cache, geo)
        for field, sh in zip(cache._fields, got):
            leaf = getattr(jcache, field)
            ref = jsh.cache_spec((jax.tree_util.GetAttrKey(field),),
                                 leaf.shape, amesh)
            ref = tuple(ref) + (None,) * (len(leaf.shape) - len(ref))
            assert sh.placements == _ref_placements(ref, axes), (
                shape.name, field, ref)


# -- the mesh dry run's per-device bytes and collectives --------------------

STATE_BYTES = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs import REGISTRY, applicable_shapes, get_config
from repro_torch.launch import dryrun, mesh as mesh_lib
out = {}
for multi, n in ((False, 256), (True, 512)):
    dryrun.fake_world(n)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi, device_type="cpu")
    for arch in sorted(REGISTRY):
        cfg = get_config(arch)
        for shape, reason in applicable_shapes(cfg):
            if reason is None:
                out[f"{arch} {shape.name} {dryrun.MESH_NAMES[multi]}"] = \
                    dryrun.mesh_state_bytes(cfg, shape, mesh)
    dist.destroy_process_group()
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("STATE_OK")
"""

MESH_RECORDS = r"""
import sys
from repro_torch.launch import dryrun
recs = dryrun.main(["--mesh", "single", "--arch", "mamba2-130m",
                    "--out", sys.argv[1]])
print("MESH_OK", len(recs))
"""


def _run(code, *args, marker):
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         env=env, cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert marker in res.stdout, res.stdout + "\n---\n" + res.stderr


def _local(shape, spec, sizes) -> int:
    """Elements of one device's shard of ``shape`` under a reference
    spec."""
    n = 1
    for d, s in enumerate(tuple(shape)):
        ax = tuple(spec)[d] if d < len(tuple(spec)) else None
        div = 1
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            div *= sizes[a]
        n *= s // div
    return n


def _itemsize(leaf) -> int:
    return jax.numpy.dtype(leaf.dtype).itemsize


def _reference_state(arch, shape, mesh_name) -> dict:
    """One device's state bytes by the reference's specs."""
    jmodel = jbuild(jconfigs.get_config(arch))
    amesh = _abstract(mesh_name)
    sizes = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    mode = "train" if shape.kind == "train" else "serve"
    pshape = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves_with_path(pshape)
    local = [(_local(leaf.shape, jsh.param_spec(path, leaf.shape, amesh,
                                                mode), sizes), leaf)
             for path, leaf in leaves]
    out = {"params": sum(n * _itemsize(leaf) for n, leaf in local),
           "grads": 0, "moments": 0, "cache": 0}
    if shape.kind == "train":
        out["grads"] = out["params"]
        out["moments"] = 2 * 4 * sum(n for n, _ in local)
    else:
        cache = jmodel.init_cache_specs(shape.global_batch, shape.seq_len)
        out["cache"] = sum(
            _local(leaf.shape, jsh.cache_spec(path, leaf.shape, amesh),
                   sizes) * _itemsize(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache))
    batch = jmodel.make_input_specs(shape)
    out["inputs"] = sum(
        _local(leaf.shape, jsh.batch_spec((jax.tree_util.DictKey(k),),
                                          leaf.shape, amesh), sizes)
        * _itemsize(leaf) for k, leaf in batch.items())
    return out


@pytest.fixture(scope="module")
def mesh_state(tmp_path_factory):
    """The dry run's per-device state bytes of every cell on both meshes,
    from a process that made fake worlds of 256 and 512 ranks."""
    path = tmp_path_factory.mktemp("state") / "state.json"
    _run(STATE_BYTES, path, marker="STATE_OK")
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_state_bytes_match_reference_specs(mesh_state, arch):
    """Every cell's per-device bytes (local shards of parameters,
    gradients, moments, cache, inputs) equal the sum over the reference's
    leaves of their shards under the reference's specs."""
    cfg = jconfigs.get_config(arch)
    cells = 0
    for shape, reason in jconfigs.applicable_shapes(cfg):
        if reason is not None:
            continue
        for mesh_name in MESHES:
            got = mesh_state[f"{arch} {shape.name} {mesh_name}"]
            want = _reference_state(arch, shape, mesh_name)
            assert {k: got[k] for k in want} == want, (shape.name,
                                                       mesh_name)
            cells += 1
    assert cells >= 6


def test_mesh_dry_run_writes_records(tmp_path):
    """``dryrun.main(["--mesh", "single"])`` on mamba2-130m's four cells:
    each ``ok`` with per-device bytes, ``fits`` against one card,
    collective bytes from its depth-1 and depth-2 probes and a bottleneck,
    in ``{arch}_{shape}_pod16x16.json``; the report renders them."""
    from repro_torch.analysis import report

    _run(MESH_RECORDS, tmp_path, marker="MESH_OK 4")
    recs = report.load(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"mamba2-130m_{s}_pod16x16.json" for s in configs.SHAPES)
    for r in recs:
        assert r["status"] == "ok", r.get("traceback")
        assert r["target"] == "H100 x256" and r["fits"] is True
        assert 0 < r["bytes"]["state"] <= r["card_bytes"]
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
        assert r["collectives"]["n_ops"] > 0
        assert r["roofline"]["collective_s"] > 0
    table = report.mesh_table(recs)
    assert table.count("| mamba2-130m |") == 4
    assert report.one_card(recs) == []


def test_mesh_dry_run_names_a_missing_fake_world(monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        dryrun.fake_world(256)


def test_collectives_from_comm_counts_matches_parse_collectives():
    """The ops of tests/test_analysis_and_launchers.py's HLO as (op,
    output bytes, group size) records: the same op bytes, bytes moved and
    count as the reference's ``parse_collectives`` of the HLO."""
    from repro.analysis import roofline as jrl
    from repro_torch.analysis import roofline as rl

    hlo = """
  %ag = f32[128,256] all-gather(%x), replica_groups={{0,1,2,3}}, dims={0}
  %ar.1 = bf16[1024] all-reduce(%y), replica_groups=[16,16]<=[256], to_apply=%add
  %rs = f32[64] reduce-scatter(%z), replica_groups={{0,1}}, dimensions={0}
  %cp = f32[32,32] collective-permute(%w), source_target_pairs={{0,1}}
  %a2a = bf16[8,8] all-to-all(%v), replica_groups={{0,1,2,3}}
  %ar-start = f32[10] all-reduce-start(%q), replica_groups={{0,1}}
  %ar-done = f32[10] all-reduce-done(%ar-start)
"""
    records = [
        ("_c10d_functional.all_gather_into_tensor", 128 * 256 * 4, 4),
        ("_c10d_functional.all_reduce", 1024 * 2, 16),
        ("_c10d_functional.reduce_scatter_tensor", 64 * 4, 2),
        ("collective-permute", 32 * 32 * 4, 2),
        ("_c10d_functional.all_to_all_single", 8 * 8 * 2, 4),
        ("c10d.allreduce_", 10 * 4, 2),
    ]
    want = jrl.parse_collectives(hlo)
    got = rl.collectives_from_comm_counts(records)
    assert got.n_ops == want.n_ops == 6
    assert got.op_bytes == pytest.approx(want.op_bytes, rel=1e-12)
    assert got.moved_bytes == pytest.approx(want.moved_bytes, rel=1e-12)
    with pytest.raises(ValueError, match="not a collective"):
        rl.collectives_from_comm_counts([("aten.mm", 4, 2)])
