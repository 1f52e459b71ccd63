"""Port's models/moe.py held against the JAX package's on the same numpy
inputs and weights, with the torch ports of tests/test_moe.py.

Tolerances, measured as max |port - ref| against max |ref|: float32 within
F32_RTOL = 1e-5 (the same products summed in another order), bfloat16
within BF16_RTOL = 3e-2 (a half-ulp of bfloat16 is 2^-9 ~ 2e-3, and the
reference's compiler fuses elementwise bfloat16 chains in float32 where the
port rounds after each op), as tests/test_torch_models.py holds the
backbones. The aux loss within F32_RTOL in both: it is formed from float32
router probabilities. The dense all-experts check keeps the reference's
own rtol = atol = 2e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

F32_RTOL = 1e-5
BF16_RTOL = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_RTOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_RTOL)}


def assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= rtol, f"max |port - ref| / max |ref| = {err:.3e}"


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _params(d, f, e, seed, dtype="float32"):
    """The reference's init_moe, and the same weights as torch tensors."""
    jdt, tdt, _ = DTYPES[dtype]
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, dtype=jdt)
    tp = {k: _t(np.asarray(v, np.float32),
                tdt if v.dtype == jdt else torch.float32)
          for k, v in jp.items()}
    return jp, tp


def _x(shape, seed, dtype="float32"):
    jdt, tdt, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    return xj, _t(np.asarray(xj, np.float32), tdt)


def dense_reference(params, x, k):
    """Every expert on every token, combined by the renormalized top-k
    weights: equal to the dispatch when no expert overflows."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt.float() @ params["router"], -1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    h = (torch.nn.functional.silu(torch.einsum("td,edf->tef", xt,
                                               params["w_gate"]))
         * torch.einsum("td,edf->tef", xt, params["w_up"]))
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"])
    gate = torch.zeros_like(probs).scatter(1, topi, topv)
    return torch.einsum("ted,te->td", y_all, gate).reshape(b, s, d)


def _dropped(jparams, x, k, capacity_factor):
    """(token, choice) pairs the reference's FCFS dispatch drops, from its
    own routing in numpy."""
    xt = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.asarray(xt) @ jparams["router"], axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    flat = np.asarray(topi).reshape(-1)
    e = jparams["w_gate"].shape[0]
    cap = max(int(capacity_factor * xt.shape[0] * k / e), 8)
    seen = np.zeros(e, int)
    dropped = 0
    for ex in flat:
        dropped += seen[ex] >= cap
        seen[ex] += 1
    return dropped


def test_moe_matches_dense_when_capacity_loose():
    _, params = _params(32, 64, 4, 0)
    _, x = _x((2, 16, 32), 1)
    with torch.no_grad():
        out, aux = moe.moe_ffn(params, x, 2, capacity_factor=8.0)
        ref = dense_reference(params, x, 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(aux) > 0.5  # ~1 for balanced routing


def test_moe_drops_overflow_tokens_gracefully():
    jp, params = _params(16, 32, 2, 2)
    xj, x = _x((1, 64, 16), 3)
    assert _dropped(jp, xj, 2, 0.25) > 0
    with torch.no_grad():
        out, _ = moe.moe_ffn(params, x, 2, capacity_factor=0.25)
        out_loose, _ = moe.moe_ffn(params, x, 2, capacity_factor=8.0)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    # dropped tokens give a strictly smaller output norm than loose capacity
    assert float(out.norm()) < float(out_loose.norm())


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype, capacity_factor):
    """Output and aux loss against the reference's moe_ffn: at 0.25 many
    (token, choice) pairs overflow to the trash slot, at 8 none, so the
    dropped set is compared through the outputs."""
    jp, tp = _params(32, 48, 4, 4, dtype)
    xj, x = _x((3, 40, 32), 5, dtype)
    dropped = _dropped(jp, xj, 2, capacity_factor)
    assert (dropped > 0) == (capacity_factor < 1), dropped
    want, want_aux = jmoe.moe_ffn(jp, xj, 2, capacity_factor)
    with torch.no_grad():
        got, aux = moe.moe_ffn(tp, x, 2, capacity_factor)
    assert got.dtype == DTYPES[dtype][1]
    assert_close(got.float().numpy(), np.asarray(want, np.float32),
                 DTYPES[dtype][2])
    assert_close(float(aux), float(want_aux), F32_RTOL)


def test_trash_slot_reads_zeros_and_takes_no_gradient():
    """At a capacity of 8 slots an expert, every token past the eighth of
    its expert gets nothing from it; the gradient through a dropped
    (token, choice) pair is zero, as the reference's dropping scatter."""
    _, params = _params(16, 32, 2, 6)
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = _x((1, 64, 16), 7)[1].requires_grad_()
    out, _ = moe.moe_ffn(params, x, 1, capacity_factor=0.01)
    # k = 1, 2 experts, 8 slots each: at most 16 tokens are served
    served = out.detach().abs().sum(-1)[0] > 0
    assert int(served.sum()) <= 16
    out.sum().backward()
    assert bool((x.grad[0, ~served] == 0).all())
