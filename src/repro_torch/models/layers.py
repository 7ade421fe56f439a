"""Transformer layers the served step needs, in PyTorch.

Mirrors the JAX package's ``models/layers.py`` op for op (same rounding
points, same layouts): RMSNorm with ``(1 + scale)``, RoPE in fp32 with a
cast back, the embedding row lookup times sqrt(d) (the scale rounded to the
table's dtype first, as JAX's weakly typed scalar is), and the tied
unembedding with fp32 accumulation.
"""
from __future__ import annotations

import math

import torch


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])).to(x.dtype)


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r}: the port serves "
                                  "RMSNorm configs so far (ROADMAP)")
    return rmsnorm(p, x)


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
