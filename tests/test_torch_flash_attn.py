"""The flash-attention kernel's wrapper and its dispatch on the CPU.

``kernels/ref.py::flash_attention_ref`` is the streaming softmax that
``models/layers.py::flash_attention`` ran itself before the kernel came,
bit for bit (SHA-256 digests of its output and of q, k and v's gradients,
taken from that code): causal and not, a sliding window, ``kv_len``, G =
1, 4 and 16 query heads a KV head, whole and ragged chunks, float32,
bfloat16 and float64. ``flash_attention`` on the CPU runs it and launches
nothing, and Nemotron-H's attention layer labels its span "eager", on
plain tensors and on DTensors; ``flash_attn.takes_kernel`` reads only what
the inputs show; the plain path of every architecture keeps its bits
(``scripts/plain_path_digest.py``'s digests from before the kernel, in
``tests/plain_path_digests.json``). The kernel itself is held against the
plain version on a card in ``tests/test_torch_kernels_card.py``.
"""
import hashlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attn as fa_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _x(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _sha(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:32]


# (B, Sq, Skv, KH, G, hd, causal, window, kv_len, q_chunk, kv_chunk)
CASES = {
    "causal-g1-whole": (2, 64, 64, 2, 1, 16, True, -1, None, 32, 32),
    "causal-g4-ragged": (2, 45, 45, 2, 4, 16, True, -1, None, 16, 16),
    "cross-g16-ragged": (2, 20, 37, 1, 16, 8, False, -1, None, 16, 16),
    "window-g4": (2, 50, 50, 2, 4, 16, True, 7, None, 16, 16),
    "kvlen-causal-g1": (2, 45, 45, 2, 1, 16, True, -1, [30, 45], 16, 16),
    "kvlen-full-g4": (2, 24, 40, 2, 4, 16, False, -1, [17, 40], 1024, 1024),
}

# taken from models/layers.py::flash_attention before its body moved
DIGESTS = [
    ("causal-g1-whole", "float32", "aa03aaea8615f06c12aa6e0eeb33df19"),
    ("causal-g1-whole", "bfloat16", "5ee7d9767b0dee5ba59cd9231c50387e"),
    ("causal-g1-whole", "float64", "6c3115fa698aba07041dd1aa4febe19e"),
    ("causal-g4-ragged", "float32", "7ca452390063b8210d9c5c9cb0d41686"),
    ("causal-g4-ragged", "bfloat16", "6a0c25b4fda7544bf3796ce2880e63fd"),
    ("causal-g4-ragged", "float64", "501836f6eb9f03efe995b5b081a2bd18"),
    ("cross-g16-ragged", "float32", "d0e77d33dc934b641c23b0cb70c26804"),
    ("cross-g16-ragged", "bfloat16", "c4aeadb16c8c26091b34178cc462a520"),
    ("cross-g16-ragged", "float64", "df9136b26c934b3d03790244440228bd"),
    ("window-g4", "float32", "99b185a1ff9b8109000fd488684c822c"),
    ("window-g4", "bfloat16", "3d564297afe8f7f249a60e0a4015ba06"),
    ("window-g4", "float64", "568384b6fa47afcb8510074215255c42"),
    ("kvlen-causal-g1", "float32", "85d55de86d5676c08f6a8003ee900212"),
    ("kvlen-causal-g1", "bfloat16", "bc9aa30f44811f5e7d2dee5b7bb0f9e6"),
    ("kvlen-causal-g1", "float64", "9572e77af91404f6211a4e30a0b57a91"),
    ("kvlen-full-g4", "float32", "029e49027e54c8a8aaaa52445be8c6f4"),
    ("kvlen-full-g4", "bfloat16", "1520d0bd4516ce81243adad92c23c6ce"),
    ("kvlen-full-g4", "float64", "f31a8da021501b8bebe0dc7c16347901"),
]


def _qkv(case, dtype):
    b, sq, skv, kh, g, hd = CASES[case][:6]
    dt = getattr(torch, dtype)
    return (_x((b, sq, kh * g, hd), 1).to(dt).requires_grad_(),
            _x((b, skv, kh, hd), 2).to(dt).requires_grad_(),
            _x((b, skv, kh, hd), 3).to(dt).requires_grad_())


@pytest.mark.parametrize("fn", ["ref", "layers"])
@pytest.mark.parametrize("case,dtype,digest", DIGESTS)
def test_plain_attention_keeps_its_bits(fn, case, dtype, digest):
    """o and the gradients of q, k and v, from ``ref.flash_attention_ref``
    and from ``layers.flash_attention`` on the CPU (which runs it)."""
    *_, causal, window, kv_len, qc, kc = CASES[case]
    q, k, v = _qkv(case, dtype)
    attend = ref.flash_attention_ref if fn == "ref" else \
        layers.flash_attention
    ops.reset_launch_counts()
    o = attend(q, k, v, causal=causal, window=window, q_chunk=qc,
               kv_chunk=kc,
               kv_len=None if kv_len is None else torch.tensor(kv_len))
    loss = (o.double() * _x(o.shape, 4).double()).sum()
    assert _sha(o, *torch.autograd.grad(loss, (q, k, v))) == digest
    assert ops.launch_counts()["flash_attn"] == 0


@pytest.mark.parametrize("causal,g,chunk", [(True, 1, 16), (True, 2, 1024),
                                             (False, 2, 16)])
def test_value_heads_narrower_than_query_heads(causal, g, chunk):
    """Latent attention's shapes: q and k heads of 192, v heads of 128; the
    output takes v's head dim and the scale q's, as an explicit softmax
    (float64 against float32 blocks: the same sums in other orders). The
    kernel's predicate takes them on a card in the layout ``mla_mixer``
    hands over: v a strided view of the (B, S, KH 256) KV expansion."""
    b, s, kh, hd, dv = 2, 45, 2, 192, 128
    q, k, v = (_x((b, s, kh * g, hd), 5), _x((b, s, kh, hd), 6),
               _x((b, s, kh, dv), 7))
    for attend in (ref.flash_attention_ref, layers.flash_attention):
        o = attend(q, k, v, causal=causal, q_chunk=chunk, kv_chunk=chunk)
        assert o.shape == (b, s, kh * g, dv) and o.dtype == torch.float32
        kk, vv = (t.double().repeat_interleave(g, 2) for t in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) * hd ** -0.5
        if causal:
            sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                                -torch.inf)
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)
        torch.testing.assert_close(o.double(), want, rtol=1e-5, atol=1e-6)
    q, k, v = _latent(b, s, kh * g, kh)
    assert v.stride() == (s * kh * 256, kh * 256, 256, 1)
    assert fa_mod.takes_kernel(*map(_OnCard, (q, k, v)), causal=True,
                               window=-1, kv_len=None)


def test_plain_path_digests_equal_the_parents():
    """Every architecture's prefill, decode, loss, gradients and train
    steps in float32 and bfloat16 on the CPU: the 140 digests of
    ``scripts/plain_path_digest.py`` as they were before the kernel."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "plain_path_digest.py"),
         "--src", os.path.join(ROOT, "src")], capture_output=True, text=True,
        env=env, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "tests", "plain_path_digests.json")) as f:
        want = json.load(f)
    assert len(want) == 140
    assert {k: v for k, v in got.items() if want.get(k) != v} == {}
    assert set(got) == set(want)


class _OnCard:
    """A CPU tensor that reports itself on a card, for the predicate."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape
        self.requires_grad = t.requires_grad

    def dim(self):
        return self.t.dim()

    def stride(self, *dim):
        return self.t.stride(*dim)

    def data_ptr(self):
        return self.t.data_ptr()


def _latent(b=2, s=48, h=32, kh=32, dn=128, dr=64, dv=128, v_at=None,
            grad=False):
    """q, k and v as ``mla_mixer`` hands them over: q a (B, S, H, dn + dr)
    view of its projection, k the (B, S, KH, dn + dr) concatenation of the
    KV expansion's key part and the shared part, and v a strided view of
    the (B, S, KH (dn + dv)) expansion, from element ``v_at`` (dn) of each
    head's row."""
    v_at = dn if v_at is None else v_at
    q = torch.zeros(b, s, h * (dn + dr), dtype=torch.bfloat16).reshape(
        b, s, h, dn + dr)
    kv = torch.zeros(b, s, kh * (dn + dv), dtype=torch.bfloat16,
                     requires_grad=grad).reshape(b, s, kh, dn + dv)
    pe = torch.zeros(b, s, 1, dr, dtype=torch.bfloat16).expand(b, s, kh, dr)
    return q, torch.cat([kv[..., :dn], pe], -1), kv[..., v_at:v_at + dv]


def _projected(b=2, s=48, h=32, kh=2, hd=128, dtype=torch.bfloat16):
    """q, k and v as the projections hand them over: (B, S, n, hd) views
    of (B, S, n hd) products."""
    return tuple(torch.zeros(b, s, n * hd, dtype=dtype).reshape(b, s, n, hd)
                 for n in (h, kh, kh))


@pytest.mark.parametrize("case,grad,want", [
    ("nemotron", False, True), ("nemotron", True, True),
    ("head_dim_64", False, True), ("one_kv_head_each", False, True),
    ("head_dim_80", False, False), ("float32", False, False),
    ("cpu", False, False), ("window", False, False),
    ("kv_len", False, False), ("not_causal", False, False),
    ("q_requires_grad", True, False), ("q_requires_grad", False, True),
    ("v_requires_grad", True, False), ("heads_not_grouped", False, False),
    ("cross_lengths", False, False), ("misaligned", False, False),
    ("inner_stride", False, False), ("too_long", False, False),
    ("mla", False, True), ("mla", True, True),
    ("mla_v_requires_grad", True, False), ("mla_192_192", False, False),
    ("mla_128_64", False, False), ("mla_v_misaligned", False, False),
    ("mla_v_other_length", False, False),
    ("mla_v_other_batch", False, False)])
def test_dispatch_reads_the_inputs(case, grad, want):
    """A causal bfloat16 card input with no window, no ``kv_len``, an
    instantiated (q and k, v) head-dim pair, H a multiple of KH, one
    length for q and k (and one batch and length for k and v) and aligned
    rows takes the kernel unless a gradient is needed; everything else
    runs the plain version. "mla": latent attention's 32 heads of 192 / 128
    as ``mla_mixer`` hands them over."""
    kw = dict(causal=True, window=-1, kv_len=None)
    shape = dict(head_dim_64={"hd": 64}, one_kv_head_each={"kh": 32},
                 head_dim_80={"hd": 80}, float32={"dtype": torch.float32},
                 heads_not_grouped={"h": 30, "kh": 4}).get(case, {})
    latent = dict(mla={}, mla_v_requires_grad={"grad": True},
                  mla_192_192={"dv": 192}, mla_128_64={"dn": 64, "dv": 64},
                  mla_v_misaligned={"v_at": 124}, mla_v_other_length={},
                  mla_v_other_batch={})
    if case in latent:
        q, k, v = _latent(**latent[case])
    else:
        q, k, v = _projected(**shape)
    if case == "window":
        kw["window"] = 16
    elif case == "kv_len":
        kw["kv_len"] = torch.full((2,), 48)
    elif case == "not_causal":
        kw["causal"] = False
    elif case == "q_requires_grad":
        q.requires_grad_()
    elif case == "v_requires_grad":
        v.requires_grad_()
    elif case == "cross_lengths":
        k, v = k[:, :40], v[:, :40]
    elif case == "mla_v_other_length":
        v = v[:, :40]
    elif case == "mla_v_other_batch":
        v = v[:1]
    elif case == "misaligned":
        q = torch.zeros(2 * 48 * 32 * 128 + 1, dtype=torch.bfloat16)[1:] \
            .reshape(2, 48, 32, 128)
    elif case == "inner_stride":
        q = torch.zeros(2, 48, 32, 256, dtype=torch.bfloat16)[..., ::2]
    elif case == "too_long":  # past the launch grid's S / 64 <= 65,535
        q, k, v = (torch.zeros(1, 1, 1, 128, dtype=torch.bfloat16).expand(
            1, fa_mod.MAX_LEN + 1, n, 128) for n in (32, 2, 2))
    wrap = (lambda t: t) if case == "cpu" else _OnCard
    with torch.set_grad_enabled(grad):
        assert fa_mod.takes_kernel(wrap(q), wrap(k), wrap(v), **kw) is want


@pytest.mark.parametrize("dn,dr,dv", [(128, 64, 64), (64, 32, 128),
                                      (128, 64, 192), (16, 8, 16)])
def test_the_wrapper_raises_on_a_pair_it_does_not_instantiate(dn, dr, dv):
    """``ops.flash_attn`` on card inputs whose (q and k, v) head dims are
    not in ``HEAD_DIMS`` raises ``ValueError`` before it builds or
    launches anything."""
    assert (dn + dr, dv) not in fa_mod.HEAD_DIMS
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="not instantiated"):
        ops.flash_attn(*map(_OnCard, _latent(h=4, kh=4, dn=dn, dr=dr,
                                             dv=dv)))
    assert ops.launch_counts()["flash_attn"] == 0


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    """``ops.flash_attn`` on CPU tensors is ``ref.flash_attention_ref``
    (causal, its default chunks), bit for bit, counted as a plain dispatch
    and no launch."""
    q, k, v = (t.detach() for t in _qkv("causal-g4-ragged", "bfloat16"))
    ops.reset_launch_counts()
    plain = ops._M_DISPATCH.value(kernel="flash_attn", route="plain")
    got = ops.flash_attn(q, k, v)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert ops._M_DISPATCH.value(kernel="flash_attn",
                                 route="plain") == plain + 1
    assert ops.launch_counts()["flash_attn"] == 0
    assert "flash_attn" in ops.KERNELS and fa_mod.KERNELS_PER_CALL == 1


@pytest.mark.parametrize("grad", [False, True])
def test_attention_mixer_on_the_cpu_takes_the_eager_path(tmp_path, grad):
    """Nemotron-H's attention layer at ``reduced_config``'s size, bfloat16:
    one ``attn.mix`` span with ``path="eager"``, no launch, and the output
    of the plain version."""
    cfg = configs.reduced_config(configs.get_config(
        "nemotron3-nano-30b-a3b")).scaled(dtype="bfloat16")
    p = layers.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, False, torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name in sorted(p):
            p[name].copy_(torch.randn(p[name].shape, generator=gen)
                          * p[name].init_scale)
    h = _x((2, 40, cfg.d_model), 5).to(torch.bfloat16)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    ops.reset_launch_counts()
    try:
        with torch.set_grad_enabled(grad):
            got = tf.attention_mixer(p, cfg, h)
    finally:
        trace.configure(None)
    recs = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["attrs"]["path"] for r in recs
            if r["name"] == "attn.mix"] == ["eager"]
    assert ops.launch_counts()["flash_attn"] == 0
    assert got.requires_grad is grad
    q, k, v = layers.qkv_project(p, h, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim)
    o = ref.flash_attention_ref(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
    assert torch.equal(got, o.reshape(2, 40, -1) @ p["wo"])


DTENSOR = r"""
import json, os, sys, tempfile
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.obs import trace

dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                        rank=0, world_size=1)
mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
cfg = configs.reduced_config(configs.get_config(
    "nemotron3-nano-30b-a3b")).scaled(dtype="bfloat16")
p = layers.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, False, torch.bfloat16, "cpu")
gen = torch.Generator().manual_seed(3)
with torch.no_grad():
    for name in sorted(p):
        p[name].copy_(torch.randn(p[name].shape, generator=gen) * 0.2)
h = torch.randn(2, 40, cfg.d_model, generator=gen).to(torch.bfloat16)
dp = {k: distribute_tensor(v.detach(), mesh, [Replicate(), Replicate()])
      for k, v in p.items()}
hd = distribute_tensor(h, mesh, [Shard(0), Replicate()])
path = os.path.join(tempfile.mkdtemp(), "spans.jsonl")
trace.configure(path)
ops.reset_launch_counts()
with torch.no_grad(), mesh_lib.mesh_context(mesh):
    got = tf.attention_mixer(dp, cfg, hd)
    plain = tf.attention_mixer({k: v.detach() for k, v in p.items()}, cfg, h)
trace.configure(None)
recs = [json.loads(s) for s in open(path)]
print(json.dumps({
    "paths": [r["attrs"]["path"] for r in recs if r["name"] == "attn.mix"],
    "launches": ops.launch_counts()["flash_attn"],
    "dtensor": type(got).__name__,
    "equal": bool(torch.equal(got.full_tensor(), plain))}))
sys.stdout.flush()
os._exit(0)
"""


def test_attention_mixer_on_a_dtensor(tmp_path):
    """A one-rank ``gloo`` world in a subprocess (a process group is never
    left in the test process): Nemotron-H's attention layer on DTensors is
    labelled by its local shards ("eager" on the CPU) and equals the plain
    tensors' layer."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", DTENSOR,
                          str(tmp_path / "store")], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"paths": ["eager", "eager"], "launches": 0,
                   "dtensor": "DTensor", "equal": True}, got
