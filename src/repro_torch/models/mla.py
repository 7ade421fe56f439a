"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), in PyTorch.

The port of the JAX package's ``models/mla.py``, op for op (the reference
computes it in plain ``jnp``, not in a kernel, so it is glue here too).
Two paths:

  * train / prefill, *expanded*: the latent is up-projected to per-head k
    and v and fed through ``layers.blockwise_attention`` (Dqk 192, Dv 128
    at full width).
  * decode, *absorbed*: W_UK is folded into the query and W_UV into the
    output, so the new token attends directly to the (kv_lora + rope)
    latent cache: (B, S, 512 + 64) instead of (B, S, H, 192 + 128).

Rounding follows the reference: every projection rounds to the model dtype,
the absorbed query ``q_lat`` included; the absorbed scores are bf16 products
summed in fp32 (``preferred_element_type``) plus the rope term in fp32; the
softmax weights are cast to the cache dtype for the latent readout.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers


def spec(cfg) -> dict:
    """Param layout of one MLA block: name -> (shape, init, dtype override),
    ``q_norm`` and ``kv_norm`` nested as ``{"scale": ...}`` (fp32 RMSNorm
    scales); the reference's leaves, layouts and init kinds."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_q_a": ((d, m.q_lora_rank), "normal", None),
        "q_norm": {"scale": ((m.q_lora_rank,), "zeros", "float32")},
        "w_q_b": ((m.q_lora_rank, H * qk), "normal", None),
        "w_kv_a": ((d, m.kv_lora_rank + m.qk_rope_head_dim), "normal", None),
        "kv_norm": {"scale": ((m.kv_lora_rank,), "zeros", "float32")},
        "w_k_b": ((m.kv_lora_rank, H * m.qk_nope_head_dim), "normal", None),
        "w_v_b": ((m.kv_lora_rank, H * m.v_head_dim), "normal", None),
        "w_o": ((H * m.v_head_dim, d), "out_proj", None),
    }


def _project_q(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope) after
    RoPE."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = layers.rmsnorm(p["q_norm"], x @ p["w_q_a"]) @ p["w_q_b"]
    q = q.reshape(B, S, H, qk)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, layers.rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d) -> the normed latent (B, S, kv_lora) and the one shared
    rope key head (B, S, rope) after RoPE at full fraction."""
    m = cfg.mla
    kv = x @ p["w_kv_a"]
    latent = layers.rmsnorm(p["kv_norm"], kv[..., :m.kv_lora_rank])
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]
    k_rope = layers.rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return latent, k_rope


def attend_full(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """Expanded path (train / prefill): x (B, S, d) -> (out (B, S, d),
    (latent (B, S, kv_lora), k_rope (B, S, rope))), the pair the cache
    keeps."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    latent, k_rope = _project_kv_latent(cfg, p, x, positions)
    k_nope = (latent @ p["w_k_b"]).reshape(B, S, H, m.qk_nope_head_dim)
    v = (latent @ p["w_v_b"]).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = layers.blockwise_attention(q, k, v, causal=True)
    return o.reshape(B, S, H * m.v_head_dim) @ p["w_o"], (latent, k_rope)


def attend_absorbed(cfg, p, x: torch.Tensor, latent_cache: torch.Tensor,
                    rope_cache: torch.Tensor, pos, positions: torch.Tensor):
    """Absorbed decode path: x (B, 1, d); latent_cache (B, Smax, kv_lora)
    and rope_cache (B, Smax, rope), written in place: the new latent and
    rope rows land at ``pos`` (clamped to the last row, as the reference's
    ``dynamic_update_slice`` clamps) *before* attending, so the token
    attends to itself; ``pos`` an int or a 0-d tensor, ``positions`` (B, 1).
    Returns (out (B, 1, d), latent_cache, rope_cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    q_nope, q_rope = _project_q(cfg, p, x, positions)        # (B,1,H,.)
    latent_t, rope_t = _project_kv_latent(cfg, p, x, positions)
    Smax = latent_cache.shape[1]
    row = torch.as_tensor(pos, device=x.device).reshape(1).long() \
        .clamp(max=Smax - 1)
    latent_cache.index_copy_(1, row, latent_t.to(latent_cache.dtype))
    rope_cache.index_copy_(1, row, rope_t.to(rope_cache.dtype))

    w_k_b = p["w_k_b"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    # absorb W_UK into q, rounded to the model dtype: (B,1,H,n) x (k,H,n)
    q_lat = torch.einsum("bshn,khn->bhk", q_nope, w_k_b)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bhk,bsk->bhs", q_lat.float(), latent_cache.float())
         + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                        rope_cache.float())) * scale
    valid = torch.arange(Smax, device=x.device) < torch.as_tensor(
        pos, device=x.device) + 1
    s = torch.where(valid, s, torch.full((), layers.NEG_INF,
                                         device=x.device))
    w = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhs,bsk->bhk", w.to(latent_cache.dtype),
                           latent_cache)
    w_v_b = p["w_v_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bhk,khv->bhv", ctx_lat, w_v_b).reshape(
        B, 1, H * m.v_head_dim)
    return o @ p["w_o"], latent_cache, rope_cache
