"""The ``cox_coord`` kernel's candidate axis and its fused surrogate step
on a CUDA card, against single calls of the same kernel and the eager
step; every test here skips without a card (a CUDA kernel has no CPU
mode). Run them on a card with

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_kernels_card.py

This file imports no JAX: the card's machine has none.

- the batched ``cox_coord`` over C in {1, 3, 40} candidates equals C
  single calls bit for bit, on tied and tie-free data, with n not a
  multiple of the 1,024-sample tile;
- the fused step's g equals a single call's on the same eta, its step
  ``surrogate.quad_min`` of that g within 1 ulp, and the pending eta
  update the eager ``addcmul_`` within 1 ulp;
- a batched call adds C to ``launch_counts()["cox_coord"]``;
- the batched finetune on the card equals per-candidate plain finetunes
  on the card within float32 tolerances;
- the SSD scan kernel (``ssd_scan``) against its plain version
  (``ref.ssd_scan_ref``, the eager form), on the card at mamba2-130m's
  widths, at a Nemotron-H M layer (8 groups, S 4,096), at zamba2's and
  the reduced configs' shapes, with ragged S and the final state; one
  launch per Mamba2 layer of a forward, none with gradients; float32 or
  gradient-needing card inputs refused by the wrapper;
- the causal GQA flash-attention kernel (``flash_attn``) against its
  plain version (``ref.flash_attention_ref``) at Nemotron-H's attention
  shape and at ragged S over G = 1, 4 and 16 and both head dims, the same
  bits twice; one launch and ``path="kernel"`` a Nemotron-H attention
  layer; what ``takes_kernel`` refuses runs the plain version without a
  launch, and the wrapper raises on it; the (128, 128) and (64, 64)
  instantiations keep the bits they had before the (192, 128) one came
  (SHA-256 digests of fixed inputs' outputs);
- the same kernel at latent attention's heads (q and k 192, v 128), with
  v a strided view of the KV expansion as ``mla_mixer`` hands it over: at
  Kimi Linear's shape (2 x 8,192 tokens, 32 heads) and at ragged S, the
  same bits twice, one launch; ``mla_mixer`` runs it, ``path="kernel"``.
"""
import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import beam, cox, surrogate  # noqa: E402
from repro_torch.data.synthetic import (SyntheticSpec,  # noqa: E402
                                        make_correlated_survival,
                                        make_tied_survival)
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.cox_coord import cox_coord  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

pytestmark = pytest.mark.card

# not multiples of the kernel's 1,024-sample tile
N_TIED, N_FREE = 9_000, 70_001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(kind, card):
    if kind == "tied":
        x, t, delta = make_tied_survival(n=N_TIED, p=48, n_times=40, seed=5)
    else:
        x, t, delta, _ = make_correlated_survival(
            SyntheticSpec(n=N_FREE, p=48, k=4, rho=0.9, seed=2))
    return cox.prepare(x.astype(np.float32), t, delta, device=card)


def _etas(c, n, card, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (0.8 * torch.randn(c, n, generator=g)).to(card)


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
@pytest.mark.parametrize("c", [1, 3, 40])
@pytest.mark.parametrize("order", [2, 3])
def test_candidates_equal_single_calls_bit_for_bit(card, kind, c, order):
    data = _data(kind, card)
    groups = ops.group_events(data.delta, data.risk_start)
    eta = _etas(c, data.n, card)
    x = data.xT[torch.arange(c, device=card) % data.p].contiguous()
    got = cox_coord(eta, x, data.delta, data.risk_start, order,
                    groups).clone()
    assert got.shape == (c, 3)
    for r in range(c):
        one = cox_coord(eta[r], x[r], data.delta, data.risk_start, order,
                        groups)
        assert torch.equal(got[r], one), (r, got[r], one)


def _ulps(a, b):
    a, b = (t.double().cpu() for t in (a, b))
    return ((a - b).abs() / torch.finfo(torch.float32).eps
            / b.abs().clamp(min=1e-30)).max().item()


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
def test_fused_step_is_the_eager_step(card, kind):
    data = _data(kind, card)
    groups = ops.group_events(data.delta, data.risk_start)
    c, s, lam2 = 5, 3, 1e-3
    cols = torch.randperm(data.p, generator=torch.Generator().manual_seed(1)
                          )[: c * s].view(c, s).to(card)
    rows = data.xT[cols]
    curv = (torch.rand(c, s, generator=torch.Generator().manual_seed(2))
            + 0.5).to(card)
    eta = _etas(c, data.n, card, seed=3)
    beta = (0.1 * torch.randn(c, s, generator=torch.Generator()
                              .manual_seed(4))).to(card)
    step = torch.zeros(c, device=card)
    for j, prev in ((0, None), (1, 0), (2, 1), (0, 2)):
        eta0, beta0, step0 = eta.clone(), beta.clone(), step.clone()
        out = ops.cox_coord_step(eta, rows, j, prev, beta, curv, step,
                                 data.delta, groups, lam2).clone()
        if prev is not None:
            want_eta = eta0.addcmul(rows[:, prev], step0[:, None])
            assert _ulps(eta, want_eta) <= 1.0
        else:
            assert torch.equal(eta, eta0)
        for r in range(c):
            one = cox_coord(eta[r], rows[r, j], data.delta,
                            data.risk_start, 2, groups)
            assert torch.equal(out[r], one), (j, r)
            d = surrogate.quad_min(out[r, 0] + 2.0 * lam2 * beta0[r, j],
                                   curv[r, j])
            assert _ulps(step[r], d) <= 1.0, (j, r, step[r], d)
            assert _ulps(beta[r, j], beta0[r, j] + d) <= 1.0
        others = [q for q in range(s) if q != j]
        assert torch.equal(beta[:, others], beta0[:, others])


@pytest.mark.parametrize("c", [1, 3, 40])
def test_a_batched_call_counts_c_launches(card, c):
    data = _data("tied", card)
    groups = ops.group_events(data.delta, data.risk_start)
    eta = _etas(c, data.n, card)
    rows = data.xT[torch.arange(2 * c, device=card) % data.p].view(
        c, 2, data.n).contiguous()
    ops.reset_launch_counts()
    cox_coord(eta, rows[:, 0].contiguous(), data.delta, data.risk_start, 2,
              groups)
    assert ops.launch_counts()["cox_coord"] == c
    ops.cox_coord_step(eta, rows, 1, 0, torch.zeros(c, 2, device=card),
                       torch.ones(c, 2, device=card),
                       torch.zeros(c, device=card), data.delta, groups,
                       1e-3)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cox_coord"] == 2 * c


@pytest.mark.parametrize("kind", ["tied", "tie_free"])
def test_batched_finetune_matches_plain_finetunes(card, kind):
    data = _data(kind, card)
    supports = np.array([[0, 3, 7], [1, 3, 9], [2, 5, 40], [0, 1, 2]])
    betas, etas, losses = beam.finetune_batch(data, supports, 1e-3,
                                              n_sweeps=20)
    for r, supp in enumerate(supports):
        b, e, loss = beam.finetune(data, supp, np.ones(3), 1e-3, 3,
                                   n_sweeps=20, use_kernel=False)
        np.testing.assert_allclose(losses[r].item(), loss.item(),
                                   rtol=2e-5)
        np.testing.assert_allclose(betas[r].cpu(), b.cpu(), rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(etas[r].cpu(), e.cpu(), rtol=1e-3,
                                   atol=1e-4)


# -- the SSD scan ------------------------------------------------------------

# y against the plain version's float32 y (TF32 off) before its rounding:
# the kernel's own rounding to bfloat16 (2^-9 relative, 2^-8 allowing the
# float32 values to straddle a rounding edge), and float32 sums in another
# order with float32 operands split into bfloat16 halves (~2^-17 relative
# a term), at most SSD_ATOL of the output's largest value
SSD_ATOL = 1e-4
# the final state (float32 both) against the plain state, of its largest
# value: L = cumsum(dt A) reaches |L| ~ 600, where a float32 ulp is 6e-5,
# and exp(L_Q - L_s) carries that error in either summation order (6.2e-5
# measured at mamba2-130m's widths)
SSD_STATE_TOL = 5e-4


def _ssd_inputs(b, s, h, hd, g, n, card, seed=0):
    """x, B and C as strided views of one bfloat16 (B, S, channels) conv
    output, as the mixer hands them over; dt as softplus gives it, A and
    D as the mixer's parameters make them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    xbc = torch.randn(b, s, h * hd + 2 * g * n, generator=gen).to(
        card, torch.bfloat16)
    xh = xbc[..., :h * hd].reshape(b, s, h, hd)
    bb, cc = xbc[..., h * hd:h * hd + g * n], xbc[..., h * hd + g * n:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen) - 1.0).to(card)
    a = -torch.linspace(1.0, 16.0, h, device=card)
    d_skip = (1.0 + 0.1 * torch.randn(h, generator=gen)).to(card)
    return xh, dt, a, bb, cc, d_skip


@pytest.mark.parametrize("b,s,h,hd,g,n,q", [
    (4, 512, 24, 64, 1, 128, 128),    # mamba2-130m
    (2, 4096, 64, 64, 8, 128, 128),   # a Nemotron-H M layer
    (3, 300, 24, 64, 1, 128, 128),    # ragged: pads the last chunk
    (2, 200, 16, 64, 1, 64, 64),      # zamba2-2.7b, ragged
    (2, 37, 6, 16, 2, 16, 16)])       # the reduced configs, 2 groups
def test_ssd_scan_against_the_eager_form(card, b, s, h, hd, g, n, q):
    xh, dt, a, bb, cc, d_skip = _ssd_inputs(b, s, h, hd, g, n, card)
    y, st = ops.ssd_scan(xh, dt, a, bb, cc, d_skip, q, g, return_state=True)
    y0, st0 = ops.ssd_scan(xh, dt, a, bb, cc, d_skip, q, g)
    # the plain version given float32 x, B and C keeps y unrounded
    y32, want_st = ref.ssd_scan_ref(xh.float(), dt, a, bb.float(),
                                    cc.float(), d_skip, q, g)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, hd)
    assert st0 is None and torch.equal(y0, y)
    scale = y32.abs().max().item()
    err = (y.float() - y32).abs() - 2.0 ** -8 * y32.abs()
    assert err.max().item() <= SSD_ATOL * scale, err.max().item() / scale
    # the plain version's own rounding of the same values
    plain, _ = ref.ssd_scan_ref(xh, dt, a, bb, cc, d_skip, q, g)
    assert ((y.float() - plain.float()).abs()
            <= 2.0 ** -7 * plain.float().abs() + SSD_ATOL * scale).all()
    assert st.shape == (b, h, hd, n) and st.dtype == torch.float32
    st_err = (st - want_st).abs().max().item()
    assert st_err <= SSD_STATE_TOL * want_st.abs().max().item(), st_err


def test_ssd_scan_repeats_its_bits(card):
    xh, dt, a, bb, cc, d_skip = _ssd_inputs(2, 1000, 24, 64, 1, 128, card)
    y1, s1 = ops.ssd_scan(xh, dt, a, bb, cc, d_skip, 128, 1, True)
    y2, s2 = ops.ssd_scan(xh, dt, a, bb, cc, d_skip, 128, 1, True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_scan_refuses_a_shape_it_does_not_instantiate(card):
    xh, dt, a, bb, cc, d_skip = _ssd_inputs(1, 64, 4, 32, 1, 128, card)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="not instantiated"):
        ops.ssd_scan(xh, dt, a, bb, cc, d_skip, 128, 1)
    xh, dt, a, bb, cc, d_skip = _ssd_inputs(1, 64, 4, 64, 1, 128, card)
    with pytest.raises(TypeError):
        ops.ssd_scan(xh.float(), dt, a, bb.float(), cc.float(), d_skip, 128,
                     1)
    with pytest.raises(TypeError):
        ops.ssd_scan(xh, dt, a, bb.float(), cc.float(), d_skip, 128, 1)
    # the kernel has no backward: a gradient-needing input is refused
    with pytest.raises(TypeError):
        ops.ssd_scan(xh, dt, a, bb, cc, d_skip.clone().requires_grad_(),
                     128, 1)
    assert ops.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 2),
                                         ("nemotron3-nano-30b-a3b", 0)])
def test_a_forward_launches_once_a_mamba2_layer(card, arch, layers):
    """mamba2-130m at full width cut to 2 layers, and the reduced Nemotron-H
    (MEM*E: two M layers of 2 groups), in bfloat16 under inference mode:
    one launch a Mamba2 layer; with gradients on, none."""
    cfg = configs.get_config(arch)
    if layers:
        cfg = cfg.scaled(n_layers=layers, vocab_size=1024)
    else:
        cfg = configs.reduced_config(cfg).scaled(dtype="bfloat16")
    n_ssm = (cfg.layer_pattern.count("M") if cfg.family == "pattern"
             else cfg.n_layers)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 160), device=card)
    ops.reset_launch_counts()
    with torch.inference_mode():
        h_kernel, _ = model.hidden_states({"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == n_ssm
    ops.reset_launch_counts()
    h_eager, _ = model.hidden_states({"tokens": tokens})
    assert h_eager.requires_grad
    assert ops.launch_counts()["ssd_scan"] == 0
    if cfg.family == "pattern":
        return  # a top-k flip moves a token by O(1): values held above
    rel = (torch.linalg.norm(h_kernel.float() - h_eager.detach().float())
           / torch.linalg.norm(h_eager.detach().float())).item()
    # bfloat16 activations rounded in the same places; the scans' sums in
    # other orders flip a rounding here and there, compounded over layers
    assert rel < 2e-2, rel


# o against the plain version given float32 q, k and v (its o unrounded),
# beyond the kernel's one rounding of o to bfloat16 (2^-8 |o|, the values
# straddling a rounding edge), of max |v|: P is rounded to bfloat16 for the
# P V product, each weight by at most 2^-9 of itself, which moves o by at
# most 2^-9 sum_s p_s |v_s| / l <= 2^-9 max |v|; the float32 sums in
# another order and exp2 for exp add ~1e-6
FA_ATOL = 2.0 ** -9 * 1.05


def _fa_inputs(b, s, h, kh, hd, card, fused=True, seed=0):
    """q (B, S, H, hd) and k, v (B, S, KH, hd) bfloat16: strided views of
    one (B, S, (H + 2 KH) hd) projection, or three tensors as Nemotron-H's
    separate projections give them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if not fused:
        return tuple(torch.randn(b, s, n, hd, generator=gen).to(
            card, torch.bfloat16) for n in (h, kh, kh))
    qkv = torch.randn(b, s, (h + 2 * kh) * hd, generator=gen).to(
        card, torch.bfloat16)
    return (qkv[..., :h * hd].reshape(b, s, h, hd),
            qkv[..., h * hd:(h + kh) * hd].reshape(b, s, kh, hd),
            qkv[..., (h + kh) * hd:].reshape(b, s, kh, hd))


def _mla_inputs(b, s, h, card, seed=0):
    """q (B, S, H, 192), k (B, S, H, 192) and v (B, S, H, 128) bfloat16 as
    ``mla_mixer`` hands them over: q a view of its projection, k the
    concatenation of the KV expansion's 128-wide key part and a 64-wide
    part shared by the heads, v a strided view of the (B, S, H 256)
    expansion (offset 128, row stride 256)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, s, h * 192, device=card, generator=gen).to(
        torch.bfloat16).reshape(b, s, h, 192)
    kv = torch.randn(b, s, h * 256, device=card, generator=gen).to(
        torch.bfloat16).reshape(b, s, h, 256)
    pe = torch.randn(b, s, 1, 64, device=card, generator=gen).to(
        torch.bfloat16).expand(b, s, h, 64)
    return q, torch.cat([kv[..., :128], pe], -1), kv[..., 128:]


def _fa_check(q, k, v):
    o = ops.flash_attn(q, k, v)
    o32 = ref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape[:3] + v.shape[3:]
    assert o.is_contiguous()
    vmax = v.float().abs().max().item()
    err = (o.float() - o32).abs() - 2.0 ** -8 * o32.abs()
    assert err.max().item() <= FA_ATOL * vmax, err.max().item() / vmax
    # the plain version's own rounding of the same values
    plain = ref.flash_attention_ref(q, k, v).float()
    assert ((o.float() - plain).abs()
            <= 2.0 ** -7 * plain.abs() + FA_ATOL * vmax).all()
    return o


def test_flash_attn_at_nemotrons_shape(card):
    """4 x 4,096 tokens, 32 query heads of 128 over 2 KV heads."""
    ops.reset_launch_counts()
    _fa_check(*_fa_inputs(4, 4096, 32, 2, 128, card, fused=False))
    assert ops.launch_counts()["flash_attn"] == 1


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("s", [1, 127, 1000, 4097])
def test_flash_attn_at_ragged_lengths(card, s, g, hd):
    """S not a multiple of the 128-row or 64-key tiles, G query heads a
    KV head, q, k and v strided views of one projection."""
    _fa_check(*_fa_inputs(2, s, 16, 16 // g, hd, card))


def test_flash_attn_repeats_its_bits(card):
    q, k, v = _fa_inputs(2, 1000, 32, 2, 128, card)
    assert torch.equal(ops.flash_attn(q, k, v), ops.flash_attn(q, k, v))


# SHA-256 (first 32 hex digits) of the kernel's output bits on fixed
# inputs (``_fa_inputs(*shape, fused=False)``), from the build before the
# (192, 128) instantiation came: Nemotron-H's attention shape at (128,
# 128), and a ragged G = 4 shape at (64, 64)
FA_DIGESTS = [((4, 4096, 32, 2, 128), "2dbf1024f4479fead7934b6c89774740"),
              ((2, 1000, 16, 4, 64), "ba54acb32e4c052efd35996fdd53f318")]


@pytest.mark.parametrize("shape,digest", FA_DIGESTS)
def test_flash_attn_keeps_its_bits(card, shape, digest):
    with torch.inference_mode():
        o = ops.flash_attn(*_fa_inputs(*shape, card, fused=False))
    got = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes())
    assert got.hexdigest()[:32] == digest


def test_flash_attn_at_kimis_latent_attention_shape(card):
    """2 x 8,192 tokens, 32 heads of q and k 192 and v 128, v a view of
    the KV expansion; the scale is 192^-1/2."""
    ops.reset_launch_counts()
    _fa_check(*_mla_inputs(2, 8192, 32, card))
    assert ops.launch_counts()["flash_attn"] == 1


@pytest.mark.parametrize("s", [1, 63, 127, 1000, 4097])
def test_flash_attn_latent_heads_at_ragged_lengths(card, s):
    """S not a multiple of the 64-row or 64-key tiles, (192, 128) heads."""
    _fa_check(*_mla_inputs(2, s, 16, card, seed=s))


def test_flash_attn_latent_heads_repeat_their_bits(card):
    q, k, v = _mla_inputs(2, 1000, 32, card)
    ops.reset_launch_counts()
    assert torch.equal(ops.flash_attn(q, k, v), ops.flash_attn(q, k, v))
    assert ops.launch_counts()["flash_attn"] == 2


def test_mla_mixer_runs_the_kernel(card, tmp_path, monkeypatch):
    """Kimi Linear's latent-attention layer at the reduced config's widths
    with the published heads (128 + 64 for q and k, 128 for v) under
    inference mode: one launch and one ``mla.mix`` span with
    ``path="kernel"`` a call; its output that of the plain version within
    1 % through the output projection."""
    cfg = configs.reduced_config(configs.get_config(
        "kimi-linear-48b-a3b")).scaled(dtype="bfloat16", qk_nope_head_dim=128,
                                       qk_rope_head_dim=64, v_head_dim=128)
    p = layers.init_mla(cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                        cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim, torch.bfloat16, card)
    gen = torch.Generator(device="cpu").manual_seed(3)
    with torch.no_grad():
        for name in sorted(p):
            if hasattr(p[name], "init_scale"):  # kv_norm stays ones
                p[name].copy_(torch.randn(p[name].shape, generator=gen)
                              * p[name].init_scale)
    h = torch.randn(2, 300, cfg.d_model, generator=gen).to(
        card, torch.bfloat16)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    ops.reset_launch_counts()
    try:
        with torch.inference_mode():
            got = [tf.mla_mixer(p, cfg, h) for _ in range(2)]
    finally:
        trace.configure(None)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attn"] == 2
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["attrs"]["path"] for r in recs
            if r["name"] == "mla.mix"] == ["kernel", "kernel"]
    assert torch.equal(got[0], got[1])
    # the plain version in the kernel's place
    monkeypatch.setattr(tf, "flash_attention", ref.flash_attention_ref)
    with torch.inference_mode():
        want = tf.mla_mixer(p, cfg, h)
    rel = (torch.linalg.norm(got[0].float() - want.float())
           / torch.linalg.norm(want.float())).item()
    assert rel < 1e-2, rel


def _nemotron_attention(card, head_dim):
    cfg = configs.reduced_config(configs.get_config(
        "nemotron3-nano-30b-a3b")).scaled(dtype="bfloat16",
                                          head_dim=head_dim)
    p = layers.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, False, torch.bfloat16, card)
    gen = torch.Generator(device="cpu").manual_seed(3)
    with torch.no_grad():
        for name in sorted(p):
            p[name].copy_(torch.randn(p[name].shape, generator=gen)
                          * p[name].init_scale)
    h = torch.randn(2, 300, cfg.d_model, generator=gen).to(
        card, torch.bfloat16)
    return cfg, p, h


@pytest.mark.parametrize("head_dim", [64, 128])
def test_attention_mixer_launches_once(card, tmp_path, head_dim):
    """Nemotron-H's attention layer (reduced widths, head_dim 64 or 128)
    under inference mode: one launch and one ``attn.mix`` span with
    ``path="kernel"``; its output the plain version's within the bounds
    above, through the output projection."""
    cfg, p, h = _nemotron_attention(card, head_dim)
    path = tmp_path / "spans.jsonl"
    trace.configure(str(path))
    ops.reset_launch_counts()
    try:
        with torch.inference_mode():
            got = tf.attention_mixer(p, cfg, h)
    finally:
        trace.configure(None)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attn"] == 1
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["attrs"]["path"] for r in recs
            if r["name"] == "attn.mix"] == ["kernel"]
    with torch.inference_mode():
        q, k, v = layers.qkv_project(p, h, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim)
        _fa_check(q, k, v)
        want = ref.flash_attention_ref(q, k, v).reshape(2, 300, -1) @ p["wo"]
    rel = (torch.linalg.norm(got.float() - want.float())
           / torch.linalg.norm(want.float())).item()
    assert rel < 1e-2, rel


@pytest.mark.parametrize("case", ["head_dim_80", "window", "kv_len",
                                  "requires_grad", "float32"])
def test_refused_attention_runs_the_plain_version(card, case):
    """What ``takes_kernel`` refuses runs ``ref.flash_attention_ref``
    through ``layers.flash_attention``, with no launch and no exception;
    called directly, the wrapper raises on it."""
    q, k, v = _fa_inputs(2, 200, 8, 2, 80 if case == "head_dim_80" else 128,
                         card)
    kw = dict(causal=True, window=-1, q_chunk=64, kv_chunk=64, kv_len=None)
    if case == "window":
        kw["window"] = 50
    elif case == "kv_len":
        kw["kv_len"] = torch.tensor([150, 200], device=card)
    elif case == "requires_grad":
        q = q.detach().requires_grad_()
    elif case == "float32":
        q, k, v = q.float(), k.float(), v.float()
    ops.reset_launch_counts()
    got = layers.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attn"] == 0
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, **kw))
    if case in ("window", "kv_len"):
        return  # the wrapper has no such arguments: it is causal alone
    with pytest.raises(ValueError if case == "head_dim_80" else TypeError):
        ops.flash_attn(q, k, v)
    assert ops.launch_counts()["flash_attn"] == 0
