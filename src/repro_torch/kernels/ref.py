"""Plain-PyTorch versions of every kernel but the fused coordinate step
(``core/solvers.py::coord_step``): each wrapper takes its own for a tensor
on the CPU, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against these. They mirror the JAX package's oracles
(``repro/kernels/ref.py``) and compute in float32, or in float64 when
given float64; ``ssd_scan_ref``, ``flash_attention_ref`` and
``kda_scan_ref``, with no oracle there, in float32. ``kda_scan_ref`` has
no kernel yet: the KDA mixer calls it directly.

``cox_coord_ref`` and ``lipschitz_ref`` also take ``risk_start``, the first
index of each sample's tie group, and read each risk set there, as the
Breslow definitions in ``core/cox.py`` do; ``risk_start=None`` is the
tie-free case (every sample's risk set is its own suffix).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
INV_6_SQRT3 = 1.0 / (6.0 * math.sqrt(3.0))


def _work(t: Tensor) -> Tensor:
    """``t`` in float32, or in its own type when that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _suffix(v: Tensor) -> Tensor:
    return torch.flip(torch.cumsum(torch.flip(v, (0,)), 0), (0,))


def _at(v: Tensor, risk_start: Optional[Tensor]) -> Tensor:
    return v if risk_start is None else v[risk_start.long()]


def group_events(delta: Tensor, risk_start: Tensor) -> Tensor:
    """D (n,): D[s] is the summed delta of the tie group that starts at s,
    0 where no group starts, in delta's working type (float32, or float64
    when given float64). The ``cox_coord`` and ``lipschitz`` kernels take
    it in place of ``risk_start``; a fit makes it once for both.

    ``risk_start`` is each sample's first index of its tie group, so it is
    nondecreasing; D needs no scatter: a group ends where the next sample
    starts another, and its sum is a difference of one float64 cumulative
    sum, the same bits on every run and device."""
    rs = risk_start.long()
    n = rs.shape[0]
    cs = torch.cumsum(delta.double(), 0)
    before = cs - delta.double()                   # sum of delta over k < i
    end = torch.searchsorted(rs, rs, right=True) - 1  # last index of group
    starts = rs == torch.arange(n, device=rs.device)
    d = torch.where(starts, cs[end] - before, torch.zeros_like(cs))
    return d.to(_work(delta).dtype)


def revcumsum_ref(x: Tensor) -> Tensor:
    return _suffix(_work(x)).to(x.dtype)


def cox_coord_ref(eta: Tensor, x: Tensor, delta: Tensor,
                  risk_start: Optional[Tensor] = None,
                  order: int = 2) -> Tuple[Tensor, Tensor, Tensor]:
    """(g, h, c3) of one coordinate; c3 is 0 unless ``order`` is 3.

    s0 is clamped at 1e-30 as the kernels do, so a risk set whose hazards
    all underflow gives finite, delta-masked terms."""
    eta, x, delta = _work(eta), _work(x), _work(delta)
    w = torch.exp(eta - torch.max(eta))
    s0 = torch.clamp(_at(_suffix(w), risk_start), min=1e-30)
    m1 = _at(_suffix(w * x), risk_start) / s0
    m2 = _at(_suffix(w * x * x), risk_start) / s0
    g = torch.sum(delta * (m1 - x))
    h = torch.sum(delta * (m2 - m1 * m1))
    if order < 3:
        return g, h, torch.zeros_like(g)
    m3 = _at(_suffix(w * x * x * x), risk_start) / s0
    c3 = torch.sum(delta * (m3 + 2.0 * m1 ** 3 - 3.0 * m2 * m1))
    return g, h, c3


def cox_coord_groups_ref(eta: Tensor, x: Tensor, delta: Tensor,
                         group_events: Tensor, order: int = 2
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """``cox_coord_ref`` in the group-start form the kernel computes:
    sum_i delta_i f(m(risk_start_i)) = sum_s D[s] f(m(s)), where D[s]
    (``group_events``) is the event count of the tie group starting at s,
    so every term is read at its own index."""
    eta, x, delta = _work(eta), _work(x), _work(delta)
    d = _work(group_events)
    w = torch.exp(eta - torch.max(eta))
    s0 = torch.clamp(_suffix(w), min=1e-30)
    m1 = _suffix(w * x) / s0
    m2 = _suffix(w * x * x) / s0
    g = torch.sum(d * m1) - torch.sum(delta * x)
    h = torch.sum(d * (m2 - m1 * m1))
    if order < 3:
        return g, h, torch.zeros_like(g)
    m3 = _suffix(w * x * x * x) / s0
    c3 = torch.sum(d * (m3 + 2.0 * m1 ** 3 - 3.0 * m2 * m1))
    return g, h, c3


def cox_batch_ref(x: Tensor, w: Tensor, r: Tensor, wa: Tensor,
                  delta: Tensor, inv_s0: Tensor) -> Tuple[Tensor, Tensor]:
    """All-coordinate (grad, hess_diag) from precomputed vectors."""
    x = _work(x)
    g = x.T @ _work(r)
    term1 = (x * x).T @ _work(wa)
    s1 = _suffix(_work(w)[:, None] * x)
    m = s1 * _work(inv_s0)[:, None]
    term2 = (_work(delta)[:, None] * m * m).sum(dim=0)
    return g, term1 - term2


def survival_curves_ref(eta: Tensor, h0: Tensor) -> Tensor:
    """(b, g) S(t_g|x_b) = exp(-H0_g * exp(eta_b)), eta clipped to +/-30."""
    risk = torch.exp(torch.clamp(_work(eta), -30.0, 30.0))
    return torch.exp(-risk[:, None] * _work(h0)[None, :])


def survival_curves_stratified_ref(eta: Tensor, h0: Tensor,
                                   strata: Tensor) -> Tensor:
    """(b, g) S = exp(-H0[strata_b, g] * exp(eta_b)); h0 is (s, g)."""
    risk = torch.exp(torch.clamp(_work(eta), -30.0, 30.0))
    return torch.exp(-_work(h0)[strata.long()] * risk[:, None])


def lipschitz_ref(x: Tensor, delta: Tensor,
                  risk_start: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """(L2, L3) Theorem-3.4 constants of a time-sorted panel."""
    x = _work(x)
    smax = torch.flip(torch.cummax(torch.flip(x, (0,)), 0).values, (0,))
    smin = torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))
    rng = _at(smax, risk_start) - _at(smin, risk_start)
    d = _work(delta)[:, None]
    l2 = 0.25 * torch.sum(d * rng * rng, dim=0)
    l3 = INV_6_SQRT3 * torch.sum(d * rng * rng * rng, dim=0)
    return l2, l3


def ssd_scan_ref(xh: Tensor, dt: Tensor, a: Tensor, bb: Tensor, cc: Tensor,
                 d_skip: Tensor, chunk: int, n_groups: int
                 ) -> Tuple[Tensor, Tensor]:
    """The Mamba2 mixer's chunked SSD plus its skip term D x: (y (B, S, H,
    hd) in xh's dtype, the final state (B, H, hd, N) float32). dt (B, S, H)
    float32; a, d_skip (H,); bb, cc (B, S, G N), head h reading group
    h // (H / G), so every group runs in the same passes. S is padded to
    whole chunks with dt = 0, so pad rows neither decay nor feed the
    state."""
    b, s, h, hd = xh.shape
    g, n, q = n_groups, bb.shape[-1] // n_groups, chunk
    nc = -(-s // q)
    pad = nc * q - s
    skip = d_skip[None, None, :, None] * xh.float()
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
    xc = xh.reshape(b, nc, q, g, h // g, hd).float()
    dtc = dt.reshape(b, nc, q, g, h // g)
    bc = bb.reshape(b, nc, q, g, n).float()
    ccx = cc.reshape(b, nc, q, g, n).float()
    # L_t, the log decay summed within the chunk
    cum = torch.cumsum(dtc * a.reshape(g, h // g), dim=2)   # (B,nc,q,G,J)
    total = cum[:, :, -1:]
    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s exp(L_t - L_s) dt_s x_s
    idx = torch.arange(q, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None, None]
    dec = torch.exp(torch.clamp(cum[:, :, :, None] - cum[:, :, None],
                                -60.0, 0.0))             # (B,nc,q,q,G,J)
    cb = torch.einsum("bcqgn,bcsgn->bcqsg", ccx, bc)
    w_ = cb[..., None] * dec * dtc[:, :, None] * causal
    y_intra = torch.einsum("bcqsgj,bcsgjd->bcqgjd", w_, xc)
    # chunk-level input state: sum_s exp(L_Q - L_s) dt_s x_s B_s^T
    decq = torch.exp(torch.clamp(total - cum, -60.0, 0.0))
    sin = torch.einsum("bcqgj,bcqgjd,bcqgn->bcgjdn", decq * dtc, xc, bc)
    # chunk states: st_c = exp(L_Q_c) st_{c-1} + sin_c; chunk c reads the
    # state coming IN to it
    chunk_decay = torch.exp(torch.clamp(total[:, :, 0], min=-60.0))
    st = torch.zeros(b, g, h // g, hd, n, dtype=torch.float32,
                     device=xh.device)
    st_in = []
    for c in range(nc):
        st_in.append(st)
        st = st * chunk_decay[:, c, :, :, None, None] + sin[:, c]
    st_in = torch.stack(st_in, dim=1)                   # (B,nc,G,J,hd,N)
    # inter-chunk: y[t] += C_t (exp(L_t) st_in)
    y_inter = torch.einsum("bcqgn,bcqgj,bcgjdn->bcqgjd", ccx,
                           torch.exp(torch.clamp(cum, -60.0, 0.0)), st_in)
    y = (y_intra + y_inter).reshape(b, nc * q, h, hd)[:, :s] + skip
    return y.to(xh.dtype), st.reshape(b, h, hd, n)


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = -1,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        kv_len: Optional[Tensor] = None) -> Tensor:
    """Chunked streaming-softmax attention, in float32.

    q, k: (B, Sq, H, hd), (B, Skv, KH, hd); v: (B, Skv, KH, dv), with H = KH
    * G (GQA: query head h reads KV head h // G); the output is (B, Sq, H,
    dv), the scale hd^-1/2 (latent attention's value heads are narrower than
    its query and key heads). window: -1/0 => full; w > 0 => keys with
    qpos - kpos >= w are masked (sliding window). kv_len: optional (B,)
    valid KV length. Masked scores are -1e30 and the output divides by
    max(l, 1e-30), as the reference's. Blocks start at multiples of the
    chunks, as the reference's do; the last block of each axis is ragged
    where the reference pads it (its padded rows are masked or dropped, so
    no value changes), and a chunk longer than the sequence is one block.
    Memory: O(q_chunk * kv_chunk) scores per step instead of O(Sq * Skv).
    """
    b, sq, h, hd = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    limit = (torch.full((1, 1), skv, device=dev) if kv_len is None
             else kv_len.to(dev)[:, None])                  # (B or 1, 1)
    out = torch.empty(b, sq, kh, g, dv, dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        qi = qf[:, q0:q0 + q_chunk]
        qpos = torch.arange(q0, q0 + qi.shape[1], device=dev)
        m = torch.full(qi.shape[:-1], -torch.inf, device=dev)
        l = torch.zeros(qi.shape[:-1], device=dev)
        acc = torch.zeros(*qi.shape[:-1], dv, device=dev)
        for k0 in range(0, skv, kv_chunk):
            kj, vj = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            kpos = torch.arange(k0, k0 + kj.shape[1], device=dev)
            s_ = torch.einsum("bqkgd,bckd->bqkgc", qi, kj) * scale
            mask = (kpos[None, :] < limit)[:, None, None, None, :]
            if causal:
                cm = kpos[None, :] <= qpos[:, None]           # (cq, ck)
                if window > 0:
                    cm = cm & (qpos[:, None] - kpos[None, :] < window)
                mask = mask & cm[None, :, None, None, :]
            s_ = torch.where(mask, s_, -1e30)
            m_new = torch.maximum(m, s_.amax(dim=-1))
            p = torch.exp(s_ - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p, vj)
            m = m_new
        out[:, q0:q0 + q_chunk] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, h, dv).to(q.dtype)


# sub-chunks of a KDA chunk (``kda_scan_ref``), and the bytes of the pairwise
# decay terms that one group of chunks may hold at once
KDA_SUB = 16
KDA_GROUP_BYTES = 512 << 20


def kda_scan_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor, beta: Tensor,
                 chunk: int) -> Tuple[Tensor, Tensor]:
    """Kimi Delta Attention's gated delta rule in chunks, in float32: (o
    (B, S, H, dv), the final state (B, H, dk, dv)). Per head, with a decay
    exp(g_t) for each key channel,

        S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T,
        o_t = S_t^T q_t dk^-1/2,

    from S_0 = 0. q, k (B, S, H, dk), L2-normalised by the caller; v (B, S,
    H, dv); g (B, S, H, dk), log decays <= 0; beta (B, S, H).

    In a chunk of C steps, with G the log decay summed from the chunk's
    start (step t included) and S_0 the state coming in, the delta rule's
    corrections D = U - W S_0 solve one unit lower-triangular system (the
    WY form), and

        (I + Diag(beta) A) [U | W] = Diag(beta) [V | exp(G) * K],
        O = (exp(G) * Q) S_0 + P D,
        S_C = Diag(exp(G_C)) S_0 + (exp(G_C - G) * K)^T D,

    where A_ti = sum_c k_tc k_ic exp(G_tc - G_ic) for i < t and P_ti the
    same with q_t for i <= t. exp(-G_i) alone overflows float32 within a
    chunk at strong decays, so the pairwise decays are taken within
    sub-chunks of KDA_SUB, and between sub-chunks factorised at the later
    one's first step r, exp(G_t - G_r) exp(G_r - G_i): no exponent
    anywhere is positive. S is padded to whole chunks with q = k = v = g =
    beta = 0, which neither decays nor feeds the state.

    Both lines are affine in S_0: S_C = M S_0 + K'^T U with M =
    Diag(exp(G_C)) - K'^T W (K' = exp(G_C - G) * K), and O = Q' S_0 + P U
    with Q' = exp(G) * Q - P W. The chunks' parts (M, K'^T U, Q', P U) are
    made for groups of chunks whose pairwise terms stay within
    KDA_GROUP_BYTES; then the state runs through the group's chunks in
    order, one batched product a chunk, and the group's outputs follow
    from the states entering its chunks in one more."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunked(t: Tensor) -> Tensor:
        """(B, S, H, ...) -> (nc, B H, C, ...) float32, padded: each
        chunk's rows of every batch row and head contiguous."""
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, nc, chunk, h, *t.shape[3:]).movedim(3, 2)
        return t.movedim(0, 1).reshape(nc, b * h, chunk, *t.shape[4:])

    qc, kc, vc, gc, bc = (chunked(t) for t in (q, k, v, g, beta))
    qc = qc * dk ** -0.5
    sub = math.gcd(chunk, KDA_SUB)
    # the pairwise decays (two C x sub x dk terms) and the factorised ones
    # (two C x C / sub x dk) of one chunk of every batch row and head
    per_chunk = 4 * b * h * dk * chunk * 2 * (sub + chunk // sub)
    step = max(1, KDA_GROUP_BYTES // per_chunk)
    state = torch.zeros(b * h, dk, dv, dtype=torch.float32, device=q.device)
    out = []
    for c0 in range(0, nc, step):
        c1 = min(c0 + step, nc)
        m, ku, qm, pu = _kda_chunks(qc[c0:c1], kc[c0:c1], vc[c0:c1],
                                    gc[c0:c1], bc[c0:c1], sub)
        ins = []                    # the states entering the group's chunks
        for m_j, ku_j in zip(m.unbind(0), ku.unbind(0)):
            ins.append(state)
            state = torch.baddbmm(ku_j, m_j, state)
        out.append(pu + qm @ torch.stack(ins))
    o = torch.cat(out).reshape(nc, b, h, chunk, dv).permute(1, 0, 3, 2, 4)
    return o.reshape(b, nc * chunk, h, dv)[:, :s], state.reshape(b, h, dk,
                                                                  dv)


def _kda_chunks(q: Tensor, k: Tensor, v: Tensor, g: Tensor, beta: Tensor,
                sub: int):
    """What ``kda_scan_ref`` needs of chunks (N, B H, C, ...) before the
    state, each chunk's two affine maps of the state coming in: M (N, B H,
    dk, dk) and K'^T U (N, B H, dk, dv), for the state going out; Q' (N, B
    H, C, dk) and P U (N, B H, C, dv), for the outputs."""
    gam = torch.cumsum(g, dim=-2)
    a, p = _kda_pairs(q, k, gam, sub)
    last = gam[..., -1:, :]
    eg = torch.exp(gam)
    rhs = beta[..., None] * torch.cat([v, eg * k], dim=-1)
    # I + Diag(beta) A: A is strictly lower, the unit diagonal implied
    uw = torch.linalg.solve_triangular(beta[..., None] * a, rhs, upper=False,
                                       unitriangular=True)
    u, w = uw.split([v.shape[-1], k.shape[-1]], dim=-1)
    kt = (torch.exp(last - gam) * k).transpose(-1, -2)
    m = torch.diag_embed(torch.exp(last[..., 0, :])).sub_(kt @ w)
    return m, kt @ u, (eg * q).sub_(p @ w), p @ u


def _kda_pairs(q: Tensor, k: Tensor, gam: Tensor, sub: int):
    """A (strictly lower) and P (lower) of chunks (..., C, dk), each (...,
    C, C): sum_c x_tc k_ic exp(G_tc - G_ic) for x = k and q."""
    *lead, c, dk = k.shape
    ns = c // sub
    ks, qs, gs = (t.reshape(*lead, ns, sub, dk) for t in (k, q, gam))
    idx = torch.arange(sub, device=k.device)
    # within a sub-chunk: exp(G_t - G_i) for i <= t, 0 above
    lower = (idx[:, None] >= idx[None, :])[:, :, None]
    dec = torch.exp(torch.where(lower, gs[..., :, None, :] - gs[..., None, :, :],
                                -torch.inf))
    dec.mul_(ks[..., None, :, :])                     # (.., ns, t, i, dk)
    a_in = torch.einsum("...tc,...tic->...ti", ks, dec)
    p_in = torch.einsum("...tc,...tic->...ti", qs, dec)
    del dec
    a_in = a_in * (idx[:, None] > idx[None, :])         # i < t for A
    # sub-chunk x before sub-chunk y, factorised at y's first step r;
    # the exponent clamped where x is not before y (those blocks are 0)
    first = gs[..., :1, :]                               # (.., ns, 1, dk)
    right = ks[..., None, :, :, :] * torch.exp(torch.clamp(
        first[..., :, None, :, :] - gs[..., None, :, :, :], max=0.0))
    fall = torch.exp(gs - first)                         # (.., ns, sub, dk)
    a_x = torch.einsum("...ytc,...yxic->...yxti", ks * fall, right)
    p_x = torch.einsum("...ytc,...yxic->...yxti", qs * fall, right)
    blocks = torch.arange(ns, device=k.device)
    before = (blocks[:, None] > blocks[None, :])[:, :, None, None]
    out = []
    for x_, inside in ((a_x, a_in), (p_x, p_in)):
        x_ = torch.where(before, x_, 0.0)
        x_.diagonal(0, -4, -3).copy_(inside.movedim(-3, -1))
        out.append(x_.transpose(-3, -2).reshape(*lead, c, c))
    return out
