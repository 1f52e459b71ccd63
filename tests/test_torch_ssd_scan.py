"""The SSD scan kernel's wrapper and its dispatch on the CPU.

``ops.ssd_scan`` on CPU tensors is its plain version,
``kernels/ref.py::ssd_scan_ref`` (the chunked scan plus the skip term,
rounded to x's dtype), bit for bit; its kernel takes only a bfloat16
tensor on a card that needs no gradient (``ssd_scan.takes_kernel``).
``mamba2_forward`` sends a scan on the CPU or one the kernel takes to
``ops.ssd_scan``, runs the plain version itself for DTensors and for the
card's training and float32 models, and marks the ``ssm.scan`` span with
the path taken. The kernel itself is held against the plain version on a
card in
``tests/test_torch_kernels_card.py``.
"""
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _x(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _inputs(b, s, h, hd, g, n, dtype, seed=0):
    """x, B and C as views of one (B, S, channels) conv output, as the
    mixer hands them over; dt, A and D float32."""
    xbc = _x((b, s, h * hd + 2 * g * n), seed).to(dtype)
    xh = xbc[..., :h * hd].reshape(b, s, h, hd)
    bb, cc = xbc[..., h * hd:h * hd + g * n], xbc[..., h * hd + g * n:]
    dt = torch.nn.functional.softplus(_x((b, s, h), seed + 1) - 1.0)
    a = -torch.exp(torch.linspace(0.0, 2.0, h))
    d_skip = 1.0 + 0.1 * _x((h,), seed + 2)
    return xh, dt, a, bb, cc, d_skip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups,s", [(1, 48), (2, 48), (1, 37), (2, 37)])
def test_plain_version_is_the_eager_form_bit_for_bit(dtype, groups, s):
    """``ops.ssd_scan`` on the CPU is ``ref.ssd_scan_ref``, one group or
    two; S = 37 pads the last chunk of 16. Unrounded, the plain version is
    the float32 scan plus the skip term."""
    dt_ = getattr(torch, dtype)
    xh, dt, a, bb, cc, d_skip = _inputs(2, s, 4, 8, groups, 6, dt_)
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(xh, dt, a, bb, cc, d_skip, 16, groups)
    want_y, want_st = ref.ssd_scan_ref(xh, dt, a, bb, cc, d_skip, 16,
                                       groups)
    y32, st32 = ref.ssd_scan_ref(xh.float(), dt, a, bb.float(), cc.float(),
                                 d_skip, 16, groups)
    assert torch.equal(y32.to(dt_), want_y) and torch.equal(st32, want_st)
    assert y.dtype == dt_ and y.shape == xh.shape
    assert torch.equal(y, want_y)
    assert torch.equal(st, want_st)
    assert ops.launch_counts()["ssd_scan"] == 0


def test_wrapper_validates_shapes():
    xh, dt, a, bb, cc, d_skip = _inputs(2, 20, 4, 8, 2, 6, torch.float32)
    with pytest.raises(ValueError):
        ops.ssd_scan(xh, dt[:, :-1], a, bb, cc, d_skip, 16, 2)
    with pytest.raises(ValueError):
        ops.ssd_scan(xh, dt, a, bb, cc, d_skip, 16, 3)
    with pytest.raises(ValueError):
        ops.ssd_scan(xh, dt, a[:-1], bb, cc, d_skip, 16, 2)


def _stand_in(is_cuda=True, dtype=torch.bfloat16, requires_grad=False):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("case,grad,want", [
    ("card", True, True), ("card", False, True),
    ("cpu", False, False), ("float32", False, False),
    ("x_requires_grad", True, False), ("x_requires_grad", False, True),
    ("param_requires_grad", True, False),
    ("param_requires_grad", False, True)])
def test_dispatch_reads_the_inputs(case, grad, want):
    """A bfloat16 card tensor takes the kernel unless a gradient is needed:
    grad mode on and some input requiring one (the skip parameter
    included); the CPU and float32 take the plain version."""
    xh = _stand_in(is_cuda=case != "cpu",
                   dtype=torch.float32 if case == "float32"
                   else torch.bfloat16,
                   requires_grad=case == "x_requires_grad")
    others = [_stand_in(), _stand_in(
        requires_grad=case == "param_requires_grad")]
    with torch.set_grad_enabled(grad):
        assert ssd_mod.takes_kernel(xh, *others) is want


def _params(d_model=32, d_state=16, head_dim=16, dtype=torch.bfloat16):
    p = ssm.init_mamba2(d_model, d_state, head_dim, dtype=dtype,
                        device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name in sorted(p):
            if getattr(p[name], "init_scale", None) is not None:
                p[name].copy_(torch.randn(p[name].shape, generator=gen)
                              * p[name].init_scale)
    return p


def _scan_paths(tmp_path, fn):
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    try:
        out = fn()
    finally:
        trace.configure(None)
    recs = [json.loads(s) for s in path.read_text().splitlines()]
    return out, [r["attrs"]["path"] for r in recs if r["name"] == "ssm.scan"]


@pytest.mark.parametrize("grad", [False, True])
def test_forward_on_the_cpu_takes_the_eager_path(tmp_path, grad):
    p = _params()
    x = _x((2, 40, 32), 4).to(torch.bfloat16)
    ops.reset_launch_counts()
    plain = ops._M_DISPATCH.value(kernel="ssd_scan", route="plain")
    with torch.set_grad_enabled(grad):
        (y, st), paths = _scan_paths(tmp_path, lambda: ssm.mamba2_forward(
            p, x, d_state=16, head_dim=16, chunk=16, return_state=True))
    assert paths == ["eager"]
    assert ops.launch_counts()["ssd_scan"] == 0
    assert ops._M_DISPATCH.value(kernel="ssd_scan",
                                 route="plain") == plain + 1
    assert y.requires_grad is grad
    assert y.shape == x.shape and st.ssm.shape == (2, 4, 16, 16)


DTENSOR = r"""
import json, os, sys, tempfile
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ssm
from repro_torch.obs import trace

dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        rank=0, world_size=1)
mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
gen = torch.Generator().manual_seed(3)
p = ssm.init_mamba2(32, 16, 16, dtype=torch.bfloat16, device="cpu")
with torch.no_grad():
    for name in sorted(p):
        if getattr(p[name], "init_scale", None) is not None:
            p[name].copy_(torch.randn(p[name].shape, generator=gen) * 0.2)
x = torch.randn(2, 40, 32, generator=gen).to(torch.bfloat16)
dp = {k: distribute_tensor(v.detach(), mesh, [Replicate(), Replicate()])
      for k, v in p.items()}
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
path = os.path.join(tempfile.mkdtemp(), "spans.jsonl")
trace.configure(path)
ops.reset_launch_counts()
with torch.no_grad(), mesh_lib.mesh_context(mesh):
    y = ssm.mamba2_forward(dp, xd, d_state=16, head_dim=16, chunk=16)
    plain = ssm.mamba2_forward({k: v.detach() for k, v in p.items()}, x,
                               d_state=16, head_dim=16, chunk=16)
trace.configure(None)
recs = [json.loads(s) for s in open(path)]
print(json.dumps({
    "paths": [r["attrs"]["path"] for r in recs if r["name"] == "ssm.scan"],
    "launches": ops.launch_counts()["ssd_scan"],
    "dtensor": type(y).__name__,
    "equal": bool(torch.equal(y.full_tensor(), plain))}))
sys.stdout.flush()
os._exit(0)
"""


def test_forward_on_a_dtensor_takes_the_eager_path(tmp_path):
    """A one-rank ``gloo`` world in a subprocess (a process group is never
    left in the test process): the scan of a DTensor is eager, and equals
    the plain tensor's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", DTENSOR,
                          str(tmp_path / "store")], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"paths": ["eager", "eager"], "launches": 0,
                   "dtensor": "DTensor", "equal": True}, got
