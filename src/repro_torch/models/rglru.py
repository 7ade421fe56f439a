"""Griffin recurrent block: fused input projections, a causal depthwise conv
and the RG-LRU gated linear recurrence (arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py``, glue as there (plain
array code, no kernel).  The recurrence h_t = a_t * h_{t-1} + b_t over a
whole sequence is the same parallel scan the reference runs
(``jax.lax.associative_scan``): combine adjacent pairs, scan the halved
sequence, fill in the even positions; log2(S) levels of elementwise ops on
(B, S, W) that autograd runs through, the fp32 products and sums in the
reference's order.  (A closed form through ``exp(cumsum(log a))``
overflows: log a reaches about -2.5 a step.)  Decode is the single-step
update.  Gates and h are fp32, y is cast back to the model dtype.  The
gate branch's GELU rounds op for op as the reference's
(``layers.gelu_tanh``), as the MLP's does.

One rule differs from the reference, which fails there: a sequence shorter
than ``conv1d_width - 1`` hands off a conv tail of ``K - 1`` rows, left-
padded with zeros (the causal conv's own padding), so a prompt of one or
two tokens can be decoded.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

C_EXP = 8.0  # RG-LRU exponent constant


def spec(cfg) -> dict:
    """Param layout of one recurrent block: name -> (shape, init, dtype
    override), the reference's ``rglru.spec`` leaves and layouts."""
    d = cfg.d_model
    w = cfg.lru_width or d
    H = cfg.num_heads
    bd = w // H                      # block-diagonal gate blocks (per head)
    return {
        "w_in": ((d, 2 * w), "normal", None),         # [gate | recurrent]
        "conv_w": ((cfg.conv1d_width, w), "normal", None),
        "conv_b": ((w,), "zeros", None),
        "gate_a": ((H, bd, bd), "normal", None),
        "gate_a_b": ((w,), "zeros", None),
        "gate_x": ((H, bd, bd), "normal", None),
        "gate_x_b": ((w,), "zeros", None),
        "lam": ((w,), "ones", "float32"),
        "w_out": ((w, d), "out_proj", None),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (..., W) with W = H * bd; w: (H, bd, bd) -> (..., W) fp32.  The
    product rounds to x's dtype; the bias is added in fp32, as the
    compiled reference adds it (XLA keeps the sum's excess precision into
    the fp32 cast that follows)."""
    H, bd, _ = w.shape
    xh = x.reshape(x.shape[:-1] + (H, bd))
    y = torch.einsum("...hi,hij->...hj", xh, w)
    return y.reshape(x.shape).float() + b.float()


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, W), w: (K, W) -> (B, S, W) fp32:
    each product and sum rounded to x's dtype, the bias added in fp32 (so
    ``.to(x.dtype)`` of it is the conv in x's dtype)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i: i + S, :] * w[i] for i in range(K))
    return y.float() + b.float()


def _gates(p: dict, rec: torch.Tensor):
    """RG-LRU gate math. rec: (B, S, W) -> (log_a fp32, gated_in fp32).
    rec is the conv output in the model dtype, or in fp32 before its last
    rounding (from ``apply_train`` and ``apply_decode``): the gates'
    products read it rounded to the weights' dtype, the gated input reads
    it unrounded, as the compiled reference does (XLA's excess
    precision)."""
    rq = rec.to(p["gate_a"].dtype)
    r = torch.sigmoid(_block_diag(rq, p["gate_a"], p["gate_a_b"]))
    i = torch.sigmoid(_block_diag(rq, p["gate_x"], p["gate_x_b"]))
    # a = sigmoid(lam) ** (c r)  =>  log_a = -c r softplus(-lam), softplus
    # as jax.nn.softplus: logaddexp(x, 0)
    lam = p["lam"]
    log_a = -C_EXP * r * torch.logaddexp(-lam, torch.zeros_like(lam))
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-6)) * (i * rec.float())
    return log_a, gated


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Positions 0, 2, 4, ... from ``even`` and 1, 3, ... from ``odd``
    along dim 1 (``even`` has as many entries as ``odd`` or one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) under (a1, b1) . (a2, b2) = (a2 a1, a2 b1 +
    b2) along dim 1, as ``jax.lax.associative_scan`` evaluates it."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a0, b0 = a[:, 0:-1:2], b[:, 0:-1:2]
    a1, b1 = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _assoc_scan(a1 * a0, a1 * b0 + b1)
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    a2, b2 = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], a2 * pa], dim=1)
    even_b = torch.cat([b[:, :1], a2 * pb + b2], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rg_lru_scan(p: dict, rec: torch.Tensor, h0=None):
    """Full-sequence RG-LRU by the parallel scan.  rec: (B, S, W) as
    ``_gates``'s; h0: (B, W) initial state -> (y (B, S, W) in rec's dtype,
    h_last (B, W) fp32)."""
    log_a, b = _gates(p, rec)
    a = torch.exp(log_a)
    if h0 is not None:
        # fold the initial state into the first step: b_0 += a_0 h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    _, h = _assoc_scan(a, b)
    return h.to(rec.dtype), h[:, -1, :]


def rg_lru_step(p: dict, rec_t: torch.Tensor, h_prev: torch.Tensor):
    """Single decode step. rec_t: (B, W) as ``_gates``'s; h_prev: (B, W)
    fp32 -> (y_t in rec_t's dtype, h fp32)."""
    log_a, b = _gates(p, rec_t[:, None, :])
    h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
    return h.to(rec_t.dtype), h


def apply_train(cfg, p: dict, x: torch.Tensor, h0=None, conv0=None):
    """Full block, full sequence.  x: (B, S, d).  Returns (y (B, S, d),
    (h_last (B, W) fp32, conv_tail (B, K - 1, W))) for the prefill
    handoff; a sequence shorter than K - 1 has its tail left-padded with
    zeros."""
    gate_in, rec_in = torch.chunk(x @ p["w_in"], 2, dim=-1)
    gate = layers.gelu_tanh(gate_in)
    if conv0 is not None:
        rec_cat = torch.cat([conv0.to(rec_in.dtype), rec_in], dim=1)
        rec = _causal_conv(rec_cat, p["conv_w"], p["conv_b"]
                           )[:, conv0.shape[1]:]
    else:
        rec = _causal_conv(rec_in, p["conv_w"], p["conv_b"])
    y, h_last = rg_lru_scan(p, rec, h0)        # rec fp32: see _gates
    y = y.to(rec_in.dtype)
    K = cfg.conv1d_width
    conv_tail = F.pad(rec_in, (0, 0, max(0, K - 1 - rec_in.shape[1]), 0)
                      )[:, -(K - 1):, :]
    return (y * gate) @ p["w_out"], (h_last, conv_tail)


def apply_decode(cfg, p: dict, x_t: torch.Tensor, h_prev: torch.Tensor,
                 conv_buf: torch.Tensor):
    """One step.  x_t: (B, 1, d); h_prev: (B, W) fp32; conv_buf: (B, K - 1,
    W) -> (out (B, 1, d), h_new (B, W) fp32, new conv_buf)."""
    gate_in, rec_in = torch.chunk(x_t @ p["w_in"], 2, dim=-1)
    gate = layers.gelu_tanh(gate_in[:, 0])
    window = torch.cat([conv_buf.to(rec_in.dtype), rec_in], dim=1)  # (B,K,W)
    rec_t = torch.einsum("bkw,kw->bw", window, p["conv_w"]).float() \
        + p["conv_b"].float()
    y_t, h_new = rg_lru_step(p, rec_t, h_prev)   # rec_t fp32: see _gates
    y_t = y_t.to(rec_in.dtype)
    new_buf = window[:, 1:, :].to(conv_buf.dtype)
    out = ((y_t * gate) @ p["w_out"])[:, None, :]
    return out, h_new, new_buf
