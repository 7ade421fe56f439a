"""Mixture-of-Experts FFN: top-k routing, capacity-based sort dispatch, the
grouped expert FFN, shared experts.

The port of the JAX package's ``models/moe.py`` for one device: the token
grouping ``G`` is always 1 and there are no sharding constraints.  The
grouped expert FFN is horizontal fusion at tensor granularity: E
independent expert FFNs in one batched product.  On the executed decode
step it runs as the hand-written ``moe_gmm`` bundle member
(``kernels/moe_gmm.py``); here, for the chunk rows, it is plain PyTorch,
as the reference leaves it to XLA.

Dispatch keeps the reference's drop semantics exactly.  Tokens beyond an
expert's capacity are dropped (dispatch marker ``T``), and the reference's
scatter writes the marker of every dropped token to the expert's row 0, the
last write winning, so an expert that overflows also loses the token in its
first slot.  ``route_from_logits`` reproduces that outcome without relying
on the write order of a scatter with repeated indices, and ``combine``
adds each token's expert outputs in expert-major order by a gather, never
by atomics, so the result does not depend on the order the card runs in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers


class RouteResult(NamedTuple):
    dispatch_idx: torch.Tensor  # (E, C) int32 token ids (or T = drop marker)
    combine_w: torch.Tensor     # (E, C) fp32 routing weights (0 for dropped)
    aux_loss: torch.Tensor      # scalar load-balancing loss
    # the same routing seen from the tokens (the combine's gather tables)
    expert: torch.Tensor        # (T, K) expert of each of a token's k picks
    slot: torch.Tensor          # (T, K) its row in that expert's buffer,
    #                             C when the token was dropped
    weight: torch.Tensor        # (T, K) fp32 renormalised routing weight


def spec(cfg) -> dict:
    """Param layout of one MoE FFN: name -> (shape, init, dtype override),
    the reference's ``moe.spec`` leaves and layouts."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    gated = cfg.activation in ("silu", "gelu")
    fin = 2 * f if gated else f
    out = {"router": ((d, E), "normal", "float32"),
           "w_in": ((E, d, fin), "normal", None),
           "w_out": ((E, f, d), "out_proj", None)}
    if m.num_shared_experts:
        fs = m.d_ff_shared
        out["shared_w_in"] = ((d, 2 * fs if gated else fs), "normal", None)
        out["shared_w_out"] = ((fs, d), "out_proj", None)
    return out


def capacity(cfg, n_tokens: int, block: int = 8) -> int:
    """Per-expert capacity for ``n_tokens`` routed tokens, floored at one
    token, aligned up to ``block`` (the grouped FFN's token block)."""
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.num_experts * m.capacity_factor)
    c = max(1, c)
    return -(-c // block) * block


def route_from_logits(cfg, logits: torch.Tensor) -> RouteResult:
    """Top-k routing with sort-based capacity dispatch from router logits
    (T, E) fp32.  Top-k is a stable descending sort, so ties go to the
    lower expert index, as ``jax.lax.top_k`` breaks them."""
    m = cfg.moe
    T = logits.shape[0]
    E, K = m.num_experts, m.top_k
    C = capacity(cfg, T)
    dev = logits.device

    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # aux load-balancing loss (Switch): E * mean(frac_tokens * frac_prob)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)

    # sort (token, pick) pairs by expert; position within the expert group
    e_flat = top_e.reshape(-1)
    w_flat = top_p.reshape(-1)
    t_flat = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(e_flat, stable=True)
    e_s, w_s, t_s = e_flat[order], w_flat[order], t_flat[order]
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=dev) - starts[e_s]
    keep = pos_in_e < C

    dispatch = torch.full((E, C), T, dtype=torch.int32, device=dev)
    combine = torch.zeros((E, C), dtype=torch.float32, device=dev)
    dispatch[e_s[keep], pos_in_e[keep]] = t_s[keep].to(torch.int32)
    combine[e_s[keep], pos_in_e[keep]] = w_s[keep]
    # the reference's dropped writes land on row 0 after the kept one
    over = counts > C
    dispatch[over, 0] = T
    combine[over, 0] = 0.0

    slot = torch.empty_like(pos_in_e)
    slot[order] = pos_in_e
    slot = slot.reshape(T, K)
    lost = (slot >= C) | ((slot == 0) & over[top_e])
    slot = torch.where(lost, torch.full_like(slot, C), slot)
    return RouteResult(dispatch, combine, aux, top_e, slot, top_p)


def route(cfg, router_w: torch.Tensor, x2d: torch.Tensor) -> RouteResult:
    """Top-k routing from activations: x2d (T, d) widened to fp32 @
    router_w, then ``route_from_logits``."""
    return route_from_logits(cfg, x2d.float() @ router_w)


def dispatch(r: RouteResult, x2d: torch.Tensor) -> torch.Tensor:
    """The capacity buffers (E, C, d): each expert's tokens, zero rows for
    empty slots."""
    x_pad = torch.cat([x2d, x2d.new_zeros((1, x2d.shape[1]))])
    return x_pad[r.dispatch_idx.long()]


def combine(r: RouteResult, ye: torch.Tensor) -> torch.Tensor:
    """(E, C, d) expert outputs -> (T, d): each token's picks weighted by
    their routing weights (cast to ``ye``'s dtype) and added to zero in
    expert-major order, as the reference's scatter-add adds them."""
    E, C, d = ye.shape
    T, K = r.expert.shape
    exp_, idx = torch.sort(r.expert, dim=-1, stable=True)
    slot = torch.gather(r.slot, 1, idx)
    w = torch.gather(r.weight, 1, idx)
    rows = (exp_ * C + slot.clamp(max=C - 1)).reshape(-1)
    y = ye.reshape(E * C, d)[rows].reshape(T, K, d) \
        * w[..., None].to(ye.dtype)
    keep = (slot < C)[..., None]
    out = ye.new_zeros((T, d))
    for j in range(K):
        out = out + torch.where(keep[:, j], y[:, j], torch.zeros_like(y[:, j]))
    return out


def _act(cfg, h: torch.Tensor) -> torch.Tensor:
    if cfg.activation in ("silu", "gelu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        g = F.silu(gate) if cfg.activation == "silu" \
            else layers.gelu_tanh(gate)
        return g * up
    return layers.gelu_tanh(h)


def expert_ffn(cfg, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Grouped expert FFN in plain PyTorch: xe (E, C, d) -> (E, C, d)."""
    return torch.bmm(_act(cfg, torch.bmm(xe, p["w_in"])), p["w_out"])


def shared_ffn(cfg, p: dict, x2d: torch.Tensor) -> torch.Tensor:
    """The shared experts, dense on every token: (T, d) -> (T, d)."""
    return _act(cfg, x2d @ p["shared_w_in"]) @ p["shared_w_out"]


def apply(cfg, p: dict, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux_loss): route, dispatch, the
    grouped expert FFN, combine, plus the shared experts."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    r = route(cfg, p["router"], x2d)
    out = combine(r, expert_ffn(cfg, p, dispatch(r, x2d)))
    if cfg.moe.num_shared_experts:
        out = out + shared_ffn(cfg, p, x2d)
    return out.reshape(B, S, d), r.aux_loss
