"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, strictly sequential).

The port of the JAX package's ``models/xlstm.py``, glue as there (plain
array code, no kernel).  The mLSTM runs in chunkwise form for train and
prefill: within a chunk the gated outer-product recurrence is masked
matmuls, and a Python loop over the chunks carries the stabilized (C, n,
m) state in fp32 (``torch.cummax`` for ``lax.cummax``).  The chunk-end
update of C is one batched product (w k)^T v, never a (B, H, L, dk, dv)
tensor.  Decode is the sequential recurrence (``mlstm_seq``, also the
oracle).  The sLSTM is a loop over the sequence: its recurrent weights are
cast to fp32 once a call (the reference casts them in every step, to the
same values), the four gates' recurrent products are one batched product
a step, and each step's pre-activations are the step's slice of the input
projections laid out head-major once a call.  Its backward is written out
(``_SLSTMScan``): about 21 kernels a step in reverse, where autograd's
graph of the loop's small ops runs about 60 and costs the host as much
again to build.

Two rules differ from the reference, which fails there (ROADMAP §3):

* Within a chunk the decay matrix is ``exp`` of the masked exponent, with
  ``-inf`` above the diagonal, where the reference masks ``exp`` of the
  whole exponent afterwards.  The values are the same; but above the
  diagonal the exponent reaches hundreds at chunk 256, so the reference's
  ``exp`` overflows there and its gradient is 0 x inf = NaN.
* A sequence shorter than ``conv1d_width - 1`` hands off a conv tail of
  ``K - 1`` rows, left-padded with zeros (the causal conv's own padding),
  so a prompt of one or two tokens can be decoded (as ``models/rglru.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.rglru import _causal_conv

NEG = -1e30


# ===========================================================================
# mLSTM
# ===========================================================================
def mlstm_spec(cfg) -> dict:
    """Param layout of one mLSTM block: name -> (shape, init, dtype
    override), the reference's leaves and layouts."""
    d = cfg.d_model
    f = int(cfg.mlstm_proj_factor * d)
    qk = f // 2
    H = cfg.num_heads
    return {
        "w_up": ((d, 2 * f), "normal", None),            # [x_m | z-gate]
        "conv_w": ((cfg.conv1d_width, f), "normal", None),
        "conv_b": ((f,), "zeros", None),
        "w_q": ((f, qk), "normal", None),
        "w_k": ((f, qk), "normal", None),
        "w_v": ((f, f), "normal", None),
        "w_gates": ((f, 2 * H), "normal", None),         # [i | f] per head
        "gate_b": ((2 * H,), "zeros", "float32"),
        "out_norm": ((f,), "zeros", "float32"),
        "w_down": ((f, d), "out_proj", None),
    }


def mlstm_dims(cfg):
    d = cfg.d_model
    f = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    return f, f // 2, H, (f // 2) // H, f // H      # f, qk, H, dk, dv


def _headnorm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm over the last dim, then the learned scale over the
    flat dim.  x: (B, S, H, dv) -> (B, S, H * dv) fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return y.reshape(y.shape[:-2] + (-1,)) * (1.0 + scale)


def mlstm_seq(q, k, v, i_pre, f_pre, state):
    """The sequential recurrence (the oracle; decode at S = 1).  q, k: (B,
    S, H, dk); v: (B, S, H, dv); gates (B, S, H); the fp32 state (C (B, H,
    dk, dv), n (B, H, dk), m (B, H)) -> (h (B, S, H, dv) fp32, state)."""
    S, dk = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    q, k, v, i_pre, f_pre = (t.float() for t in (q, k, v, i_pre, f_pre))
    C, n, m = state
    hs = []
    for t in range(S):
        qt, kt, vt, it = q[:, t], k[:, t], v[:, t], i_pre[:, t]
        logf = F.logsigmoid(f_pre[:, t])
        m_new = torch.maximum(logf + m, it)
        fw = torch.exp(logf + m - m_new)[..., None]
        iw = torch.exp(it - m_new)[..., None]
        C = C * fw[..., None] + iw[..., None] * (kt[..., :, None]
                                                 * vt[..., None, :])
        n = n * fw + iw * kt
        qs = qt * scale
        num = (qs[..., None, :] @ C)[..., 0, :]           # bhd,bhdv->bhv
        qn = torch.abs((qs * n).sum(-1))                  # bhd,bhd->bh
        hs.append(num / torch.maximum(qn, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk: int = 256):
    """Chunkwise-parallel stabilized mLSTM, the same math as ``mlstm_seq``:
    masked matmuls within a chunk, the (C, n, m) state carried across
    chunks in fp32.  S must be a multiple of ``min(chunk, S)``."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    nc = S // L
    scale = 1.0 / math.sqrt(dk)

    def cview(x, dlast):
        # (B, S, H, d) -> (nc, B, H, L, d)
        return x.reshape(B, nc, L, H, dlast).permute(1, 0, 3, 2, 4).float()

    qs = cview(q, dk) * scale
    ks = cview(k, dk)
    vs = cview(v, dv)
    gi = i_pre.reshape(B, nc, L, H).permute(1, 0, 3, 2).float()
    gf = F.logsigmoid(f_pre.reshape(B, nc, L, H).permute(1, 0, 3, 2).float())
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    C0, n0, m0 = state
    hs = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qs[c], ks[c], vs[c], gi[c], gf[c]
        b = torch.cumsum(fb, dim=-1)
        u = ib - b
        m_i = torch.maximum(m0[..., None] + b,
                            b + torch.cummax(u, dim=-1).values)
        # D_ij = exp(b_i - m_i + u_j) for j <= i, 0 above: exp(-inf)
        D = torch.exp(torch.where(
            causal, b[..., :, None] - m_i[..., :, None] + u[..., None, :],
            -math.inf))
        s = (qb @ kb.transpose(-1, -2)) * D
        inter_w = torch.exp(b + m0[..., None] - m_i)       # (B, H, L)
        num = s @ vb + (qb @ C0) * inter_w[..., None]
        qn = s.sum(-1) + (qb @ n0[..., None])[..., 0] * inter_w
        hs.append(num / torch.maximum(torch.abs(qn),
                                      torch.exp(-m_i))[..., None])
        # chunk-end state: C1 = decay C0 + (w k)^T v
        bL = b[..., -1:]
        mL = m_i[..., -1]
        wk = torch.exp(bL - mL[..., None] + u)[..., None] * kb   # (B,H,L,dk)
        decay = torch.exp(bL[..., 0] + m0 - mL)
        C0 = C0 * decay[..., None, None] + wk.transpose(-1, -2) @ vb
        n0 = n0 * decay[..., None] + wk.sum(dim=-2)
        m0 = mL
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, S, H, dv)
    return h, (C0, n0, m0)


def mlstm_fresh_state(B, H, dk, dv, device=None):
    return (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((B, H, dk), dtype=torch.float32, device=device),
            torch.full((B, H), NEG, dtype=torch.float32, device=device))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op for op in x's dtype: x (1 / (1 + exp(-x))), each
    op rounded (``F.silu`` rounds once, from fp32; in bf16 the two differ
    by a step on a third of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _conv_tail(x: torch.Tensor, K: int, conv0=None) -> torch.Tensor:
    """The last K - 1 rows of the conv's input (after ``conv0`` when
    given), left-padded with zeros when there are fewer."""
    if conv0 is not None:
        x = torch.cat([conv0.to(x.dtype), x], dim=1)
    return F.pad(x, (0, 0, max(0, K - 1 - x.shape[1]), 0))[:, -(K - 1):, :]


def _conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               conv0=None) -> torch.Tensor:
    """silu of the causal conv over x (after ``conv0``'s rows when given),
    in x's dtype."""
    if conv0 is not None:
        cat = torch.cat([conv0.to(x.dtype), x], dim=1)
        c = _causal_conv(cat, w, b)[:, conv0.shape[1]:]
    else:
        c = _causal_conv(x, w, b)
    return _silu(c.to(x.dtype))


def _window_silu(window: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """silu of one step of the conv: window (B, K, W) -> (B, W)."""
    c = torch.einsum("bkw,kw->bw", window, w) + b
    return _silu(c)


def _mlstm_qkvg(cfg, p, x, conv0=None):
    f, qk, H, dk, dv = mlstm_dims(cfg)
    B, S, _ = x.shape
    xm, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    c = _conv_silu(xm, p["conv_w"], p["conv_b"], conv0)
    q = (c @ p["w_q"]).reshape(B, S, H, dk)
    k = (c @ p["w_k"]).reshape(B, S, H, dk)
    v = (xm @ p["w_v"]).reshape(B, S, H, dv)
    gates = (xm @ p["w_gates"]).float() + p["gate_b"]
    i_pre, f_pre = gates[..., :H], gates[..., H:]
    return q, k, v, i_pre, f_pre, z, _conv_tail(xm, cfg.conv1d_width, conv0)


def mlstm_apply_train(cfg, p, x, state=None, conv0=None):
    """x: (B, S, d) -> (y, (state, conv_tail)).  Chunks of 256 where S is a
    multiple of 256, else one chunk of S rows (the reference's rule)."""
    f, qk, H, dk, dv = mlstm_dims(cfg)
    B, S, _ = x.shape
    q, k, v, i_pre, f_pre, z, conv_tail = _mlstm_qkvg(cfg, p, x, conv0)
    if state is None:
        state = mlstm_fresh_state(B, H, dk, dv, device=x.device)
    chunk = 256 if S % 256 == 0 else S
    h, state = mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk=chunk)
    y = _headnorm(p["out_norm"], h).to(x.dtype)
    y = y * _silu(z)
    return y @ p["w_down"], (state, conv_tail)


def mlstm_apply_decode(cfg, p, x_t, state, conv_buf):
    """x_t: (B, 1, d); conv_buf: (B, K - 1, f) -> (y (B, 1, d), state, the
    new conv_buf)."""
    f, qk, H, dk, dv = mlstm_dims(cfg)
    B = x_t.shape[0]
    xm, z = torch.chunk(x_t @ p["w_up"], 2, dim=-1)
    window = torch.cat([conv_buf.to(xm.dtype), xm], dim=1)
    c = _window_silu(window, p["conv_w"], p["conv_b"])
    q = (c @ p["w_q"]).reshape(B, 1, H, dk)
    k = (c @ p["w_k"]).reshape(B, 1, H, dk)
    v = (xm[:, 0] @ p["w_v"]).reshape(B, 1, H, dv)
    gates = (xm[:, 0] @ p["w_gates"]).float() + p["gate_b"]
    h, state = mlstm_seq(q, k, v, gates[:, None, :H], gates[:, None, H:],
                         state)
    y = _headnorm(p["out_norm"], h).to(x_t.dtype)
    y = y * _silu(z)
    return y @ p["w_down"], state, window[:, 1:, :].to(conv_buf.dtype)


# ===========================================================================
# sLSTM
# ===========================================================================
def slstm_spec(cfg) -> dict:
    """Param layout of one sLSTM block (the reference's leaves)."""
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    fs = int(cfg.slstm_proj_factor * d)
    return {
        "conv_w": ((cfg.conv1d_width, d), "normal", None),
        "conv_b": ((d,), "zeros", None),
        "w_zifo": ((d, 4 * d), "normal", None),
        "r_zifo": ((4, H, dh, dh), "normal", None),
        "b_zifo": ((4 * d,), "zeros", "float32"),
        "out_norm": ((d,), "zeros", "float32"),
        "w_up": ((d, 2 * fs), "normal", None),
        "w_down": ((fs, d), "out_proj", None),
    }


def _cell_parts(z_pre, i_pre, f_pre, o_pre, c, n, m):
    """The stabilized sLSTM update on fp32 pre-activations -> ((c, n, m,
    h), (logf + m, fw, iw, tanh z, sigmoid o)), each of the state's shape:
    the new state and the values its gradient reads.  15 kernels: logf + m
    once, the two multiply-adds fused."""
    logf_m = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(logf_m, i_pre)
    fw = torch.exp(logf_m - m_new)
    iw = torch.exp(i_pre - m_new)
    zt = torch.tanh(z_pre)
    c_new = torch.addcmul(fw * c, iw, zt)
    n_new = torch.addcmul(iw, fw, n)
    og = torch.sigmoid(o_pre)
    h_new = og * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), (logf_m, fw, iw, zt, og)


def _slstm_cell(p, wx_t, state):
    """One recurrence step (decode).  wx_t: (B, 4d) fp32, W x + b; state =
    (c, n, m, h), each (B, d) fp32 -> (state, h)."""
    c, n, m, h = state
    r = p["r_zifo"].float()
    H, dh = r.shape[1], r.shape[2]
    d = c.shape[-1]
    rh = torch.einsum("bhi,ghij->gbhj", h.reshape(-1, H, dh), r)
    rh = rh.reshape(4, -1, d)
    pre = [wx_t[..., j * d:(j + 1) * d] + rh[j] for j in range(4)]
    state = _cell_parts(*pre, c, n, m)[0]
    return state, state[3]


def slstm_fresh_state(B, d, device=None):
    z = torch.zeros((B, d), dtype=torch.float32, device=device)
    return (z, z, torch.full((B, d), NEG, dtype=torch.float32,
                             device=device), z)


def _scan_steps(rk, xs, state):
    """The loop of ``_slstm_scan`` on head-major operands: rk (H, dh, 4 dh),
    xs (S, H, B, 4 dh), state (c, n, m, h) each (H, B, dh) -> (the h of
    each step, the last state, and each step's pre-activations, (logf + m,
    fw, iw, tanh z, sigmoid o), c and n: the values the backward reads)."""
    dh = rk.shape[1]
    c, n, m, h = state
    hs, kept = [], [[] for _ in range(8)]
    for t in range(xs.shape[0]):
        pre = torch.baddbmm(xs[t], h, rk)
        (c, n, m, h), parts = _cell_parts(
            pre[..., :dh], pre[..., dh:2 * dh], pre[..., 2 * dh:3 * dh],
            pre[..., 3 * dh:], c, n, m)
        hs.append(h)
        for store, v in zip(kept, (pre, *parts, c, n)):
            store.append(v)
    return hs, (c, n, m, h), kept


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM loop with its backward written out: the forward keeps each
    step's values (no autograd graph of 2048 steps of small ops), the
    backward walks the steps in reverse carrying the state's gradients,
    about 21 kernels a step where autograd's graph runs about 60, and
    forms the recurrent weights' gradient in one product at the end.
    Inputs: rk (H, dh, 4 dh), xs (S, H, B, 4 dh), c0, n0, m0, h0 (H, B,
    dh); outputs: h of every step (S, H, B, dh) and the last c, n, m, h."""

    @staticmethod
    def forward(ctx, rk, xs, c0, n0, m0, h0):
        hs, last, kept = _scan_steps(rk, xs, (c0, n0, m0, h0))
        hs = torch.stack(hs)
        ctx.save_for_backward(rk, c0, n0, h0, hs,
                              *(torch.stack(v) for v in kept))
        return (hs, *last)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm, dh):
        (rk, c0, n0, h0, hs, pre, logf_m, fw, iw, zt, og, cs,
         ns) = ctx.saved_tensors
        H, dhd = rk.shape[0], rk.shape[1]
        dc, dn, dm, dh = (torch.zeros_like(h0) if g is None else g
                          for g in (dc, dn, dm, dh))
        if dhs is None:
            dhs = torch.zeros_like(hs)
        i_pre, f_pre = pre[..., dhd:2 * dhd], pre[..., 2 * dhd:3 * dhd]
        # m = max(logf + m_prev, i): torch.maximum's gradient, split at ties
        sel_a = (logf_m > i_pre).float() + 0.5 * (logf_m == i_pre).float()
        sel_i = 1.0 - sel_a
        sig_nf = torch.sigmoid(-f_pre)              # d logsigmoid(f) / df
        dsig = og * (1.0 - og)
        iw_dtanh = iw * (1.0 - zt * zt)
        den = torch.clamp(ns, min=1e-6)
        h_live = hs * (ns >= 1e-6)                  # clamp's gradient mask
        cprev = torch.cat([c0[None], cs[:-1]])
        nprev = torch.cat([n0[None], ns[:-1]])
        dpre = torch.empty_like(pre)
        rk_t = rk.transpose(1, 2)
        for t in range(pre.shape[0] - 1, -1, -1):
            dz, di, df, do = (dpre[t][..., k * dhd:(k + 1) * dhd]
                              for k in range(4))
            q = (dhs[t] + dh) / den[t]              # h = og c / den
            torch.mul(q * cs[t], dsig[t], out=do)
            dc_t = torch.addcmul(dc, q, og[t])
            dn_t = torch.addcmul(dn, q, h_live[t], value=-1.0)
            dfw = torch.addcmul(dc_t * cprev[t], dn_t, nprev[t])
            diw = torch.addcmul(dn_t, dc_t, zt[t])
            torch.mul(dc_t, iw_dtanh[t], out=dz)
            dc, dn = dc_t * fw[t], dn_t * fw[t]
            e_f, e_i = dfw * fw[t], diw * iw[t]     # through the two exps
            dm_t = dm - e_f - e_i
            dm = torch.addcmul(e_f, dm_t, sel_a[t])  # d(logf + m_prev)
            torch.addcmul(e_i, dm_t, sel_i[t], out=di)
            torch.mul(dm, sig_nf[t], out=df)
            dh = torch.bmm(dpre[t], rk_t)
        hprev = torch.cat([h0[None], hs[:-1]])
        drk = torch.bmm(hprev.permute(1, 3, 0, 2).reshape(H, dhd, -1),
                        dpre.permute(1, 0, 2, 3).reshape(H, -1, 4 * dhd))
        return drk, dpre, dc, dn, dm, dh


def _slstm_scan(r: torch.Tensor, wx: torch.Tensor, state):
    """The recurrence over a whole sequence.  r: ``r_zifo`` (4, H, dh, dh)
    fp32; wx: (B, S, 4d) fp32; state (c, n, m, h), each (B, d) fp32 ->
    (h (B, S, d) fp32, state).  Head-major inside the loop: each step is
    one batched product of h (H, B, dh) with r as (H, dh, 4 dh) added to
    the step's pre-activations, then the update on (H, B, dh) slices
    (``_SLSTMScan``)."""
    B, S, _ = wx.shape
    G, H, dh, _ = r.shape
    d = H * dh
    rk = r.permute(1, 2, 0, 3).reshape(H, dh, G * dh)
    # (B, S, [z i f o], H, dh) -> (S, H, B, [z i f o] dh)
    xs = wx.reshape(B, S, G, H, dh).permute(1, 3, 0, 2, 4) \
        .reshape(S, H, B, G * dh)
    # (B, d) -> (H, B, dh)
    init = tuple(t.reshape(B, H, dh).transpose(0, 1) for t in state)
    hs, *last = _SLSTMScan.apply(rk, xs, *init)
    out = hs.permute(2, 0, 1, 3).reshape(B, S, d)
    return out, tuple(t.transpose(0, 1).reshape(B, d) for t in last)


def _slstm_ffn(cfg, p, h: torch.Tensor, dtype) -> torch.Tensor:
    """The per-head norm and the gated FFN: h (B, S, d) fp32 -> (B, S, d)."""
    B, S, d = h.shape
    H = cfg.num_heads
    y = _headnorm(p["out_norm"], h.reshape(B, S, H, d // H)).to(dtype)
    g, u = torch.chunk(y @ p["w_up"], 2, dim=-1)
    return (_silu(g) * u) @ p["w_down"]


def _zifo_inputs(p, x, c) -> torch.Tensor:
    """W x + b (..., 4d) fp32: z and o see the raw input, i and f the conv
    features (the official layout)."""
    d = x.shape[-1]
    w = p["w_zifo"]
    return torch.cat([x @ w[:, :d], c @ w[:, d:2 * d], c @ w[:, 2 * d:3 * d],
                      x @ w[:, 3 * d:]], dim=-1).float() + p["b_zifo"]


def slstm_apply_train(cfg, p, x, state=None, conv0=None):
    """x: (B, S, d) -> (y, (state, conv_tail)), sequential over S."""
    B, S, d = x.shape
    c = _conv_silu(x, p["conv_w"], p["conv_b"], conv0)
    wx = _zifo_inputs(p, x, c)
    if state is None:
        state = slstm_fresh_state(B, d, device=x.device)
    h, state = _slstm_scan(p["r_zifo"].float(), wx, state)
    return _slstm_ffn(cfg, p, h, x.dtype), (
        state, _conv_tail(x, cfg.conv1d_width, conv0))


def slstm_apply_decode(cfg, p, x_t, state, conv_buf):
    """x_t: (B, 1, d) -> (y (B, 1, d), state, the new conv_buf)."""
    window = torch.cat([conv_buf.to(x_t.dtype), x_t], dim=1)
    c = _window_silu(window, p["conv_w"], p["conv_b"])
    state, h = _slstm_cell(p, _zifo_inputs(p, x_t[:, 0], c), state)
    y = _slstm_ffn(cfg, p, h[:, None, :], x_t.dtype)
    return y, state, window[:, 1:, :].to(conv_buf.dtype)
