"""Transformer layers the served and trained steps need, in PyTorch.

Mirrors the JAX package's ``models/layers.py`` op for op (same rounding
points, same layouts): RMSNorm with ``(1 + scale)``, LayerNorm with
``scale`` and ``bias``, RoPE in fp32 with a cast back, the embedding row
lookup times sqrt(d) (the scale rounded to the table's dtype first, as
JAX's weakly typed scalar is), the tied
unembedding with fp32 accumulation, the fused-QKV projection, the gated
MLP (its GELU op for op as ``jax.nn.gelu``), flash-style blockwise attention and banded local attention (the
reference computes both in plain ``jnp``, not in a kernel) and the fp32
cross entropy with z-loss.  A JAX product with ``preferred_element_type=float32`` becomes a
product of the operands upcast to fp32: the same bf16 values, summed in
fp32.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's LayerNorm, glue as there (plain ``jnp``): mean and
    the centred values' variance in fp32, ``x scale + bias`` in fp32, one
    cast back.  Written as that formula rather than ``F.layer_norm`` so
    the bf16 rounding is the reference's."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                            device=x.device) / half)
    ang = positions[..., None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """fp32 ``[sin, cos]`` of positions (int or float, any leading shape)
    over ``d // 2`` frequencies 10000^(-i / half): (..., 2 * (d // 2))."""
    half = d // 2
    freqs = torch.pow(10_000.0, -torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sqrt_d(d_model: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), math.sqrt(d_model), dtype=like.dtype,
                      device=like.device)


def embed(p, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    emb = p["embedding"]
    return emb[tokens.long()] * _sqrt_d(d_model, emb)


def embed_onehot(p, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """The reference's decode-path one_hot @ table is an exact row lookup,
    so the port looks the row up."""
    return embed(p, tokens, d_model)


def unembed(p, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    logits = torch.matmul(x.float(), p["embedding"].float().t())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------------------
# Train / full-sequence path
# ---------------------------------------------------------------------------
def qkv_project(cfg, p, x: torch.Tensor):
    """x (B, S, d) @ the fused w_qkv -> q (B,S,H,D), k, v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qkv = x @ p["w_qkv"]
    q = qkv[..., :H * D].reshape(B, S, H, D)
    k = qkv[..., H * D:(H + Hkv) * D].reshape(B, S, Hkv, D)
    v = qkv[..., (H + Hkv) * D:].reshape(B, S, Hkv, D)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """v rounded to dtype, as a Python float (a host computation)."""
    return torch.tensor(v, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) op for op in x's dtype: x^3, the
    constants rounded to that dtype, each product and sum rounded, as the
    reference's bf16 computes it (``F.gelu`` rounds once, from fp32, and
    differs on about 40% of bf16 values).  The constants are Python
    floats, so the card sees no host copy."""
    c3 = _rounded(0.044715, x.dtype)
    cs = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    inner = cs * (x + c3 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    act = cfg.activation
    h = x @ p["w_in"]
    if act in ("silu", "gelu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        g = F.silu(gate) if act == "silu" else gelu_tanh(gate)
        h = g * up
    elif act == "gelu_mlp":
        h = gelu_tanh(h)
    elif act == "relu2_mlp":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(act)
    return h @ p["w_out"]


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        chunk_q: int = 1024, chunk_k: int = 1024):
    """Flash-style attention: a loop over KV chunks with a running (max,
    sum, acc), never materialising (Sq, Sk).  q (B,Sq,H,D); k, v
    (B,Sk,Hkv,D) -> (B,Sq,H,Dv) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // Hkv
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"blockwise_attention: Sq={Sq} % {cq} and "
                         f"Sk={Sk} % {ck} must be 0")
    nq, nk = Sq // cq, Sk // ck
    dev = q.device
    qg = q.reshape(B, nq, cq, Hkv, rep, D).float()
    kc = k.reshape(B, nk, ck, Hkv, D)
    vc = v.reshape(B, nk, ck, Hkv, Dv)
    qpos = q_offset + torch.arange(Sq, device=dev).reshape(nq, cq)
    m = torch.full((B, Hkv, rep, nq, cq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, rep, nq, cq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, rep, nq, cq, Dv), dtype=torch.float32,
                      device=dev)
    for ik in range(nk):
        kb, vb = kc[:, ik], vc[:, ik]
        s = torch.einsum("bnqhrd,bkhd->bhrnqk", qg, kb.float()) / math.sqrt(D)
        if causal:
            kpos = ik * ck + torch.arange(ck, device=dev)
            mask = qpos[:, :, None] >= kpos[None, None, :]      # (nq,cq,ck)
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * scale + p.sum(dim=-1)
        pv = torch.einsum("bhrnqk,bkhd->bhrnqd", p.to(vb.dtype), vb)
        acc = acc * scale[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 4, 1, 2, 5).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


def local_attention(q, k, v, window: int, *, q_offset=0):
    """Sliding-window causal attention, banded blockwise: S padded with
    zeros to a multiple of the chunk ``W = min(window, S)``, query chunk i
    attends key chunks {i - 1, i} (chunk 0 has no previous chunk), each
    query the W keys up to itself.  Scores in fp32, the softmax weights
    cast to v's dtype for the value product.  q (B,S,H,D); k, v
    (B,S,Hkv,D) -> (B,S,H,D) in q's dtype.  ``q_offset`` is accepted and
    unused, as in the reference."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    W = min(window, S)
    pad = (-S) % W
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    Sp = q.shape[1]
    n = Sp // W
    dev = q.device
    qc = q.reshape(B, n, W, Hkv, rep, D)
    kc = k.reshape(B, n, W, Hkv, D)
    vc = v.reshape(B, n, W, Hkv, D)
    kk = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1),
                    kc], 2)                                # (B,n,2W,Hkv,D)
    vv = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1),
                    vc], 2)
    s = torch.einsum("bnqhrd,bnkhd->bnhrqk", qc.float(),
                     kk.float()) / math.sqrt(D)
    # key j (relative to the chunk start) is seen by query i iff
    # i - W < j <= i; chunk 0's previous-chunk keys are padding
    qi = torch.arange(W, device=dev)[:, None]
    kj = torch.arange(2 * W, device=dev)[None, :] - W
    mask = (kj <= qi) & (kj > qi - W)
    first = (torch.arange(n, device=dev) == 0)[:, None, None]
    full = torch.where(first, mask & (kj >= 0), mask)       # (n, W, 2W)
    s = torch.where(full[None, :, None, None], s,
                    torch.full((), NEG_INF, device=dev))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bnhrqk,bnkhd->bnqhrd", w.to(vv.dtype), vv)
    return o.reshape(B, Sp, H, D)[:, :S].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len) -> torch.Tensor:
    """One new token per row against its cache: q (B,1,H,D); k_cache,
    v_cache (B,Smax,Hkv,D); ``cur_len`` the valid prefix, an int or a
    0-d tensor.  Scores in fp32, softmax weights cast to the cache's dtype
    for the value product (the reference's plain ``jnp`` order)."""
    B, _, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhrd,bkhd->bhrk", qg.float(),
                     k_cache.float()) / math.sqrt(D)
    valid = torch.arange(Smax, device=q.device) < cur_len
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", w.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, D).to(q.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross entropy in fp32 with z-loss; labels < 0 are
    ignored."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask
    denom = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, torch.zeros((), device=nll.device)
                       ).sum() / denom
