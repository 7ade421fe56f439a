"""Flash attention (train/prefill): online softmax over kv tiles, causal or
not, on (BH, S, D) as the reference's kernel takes it, and on (B, S, H, D)
with GQA as ``kernels/ops.py`` takes it.

CUDA source: ``csrc/flash_attention.cuh``.  It replaces the TPU kernel
``src/repro/kernels/flash_attention.py:54`` (flash_attention, body
``:21``).  Bound on the card: operations (68.7 GFLOP causal at
granite-3-2b's train shapes against 67 MB: 0.069 ms at the bf16 tensor-core
peak).  Design: one CTA per (batch, KV head, tile of rows) runs the kv loop
the reference spreads over its sequential grid, with every query head of
the group in the CTA, so each staged k/v tile serves them all; a causal CTA
stops at its last query position (exact: a wholly masked tile adds nothing
once position 0 is seen).  The kernel reads (B, S, H, D) with KV head
``h // rep`` directly, where the reference repeats the KV heads and
transposes first.  Two routes, by dtype, each documented and tested; no
CUDA tensor falls back to the plain version:

  mma  bf16: ``csrc/attention_mma.cuh``, QK^T and P.V on the tensor cores
       (``mma.sync``, fp32 accumulation; P as two bf16 terms), the online
       softmax in fp32 registers, 128 rows a CTA.
  fma  fp32: ``flash_f32_kernel``, fp32 FMAs on the CUDA cores, as the
       reference multiplies fp32 in fp32: register tiles of 8 rows x 8 (D
       > 64: 4) keys and 8 rows x 8 output columns a thread, 256 rows a CTA
       (D > 64: 128), K and V tiles through a ``cp.async`` ring.

Beside the kernel: ``FLASH``, its launch record (bumped right after each
launch), and ``plain_flash_attention``, the plain PyTorch version: the
reference's own tile loop in fp32, so it never holds an S x S score matrix
(``plain_flash_attention_bshd`` takes it to (B, S, H, D) with GQA).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda

FLASH = cuda.Kernel("flash_attention",
                    "src/repro_torch/csrc/flash_attention.cuh",
                    "src/repro/kernels/flash_attention.py:54")
NEG_INF = -1e30
MAX_HEAD_DIM = 128


def _tiles(S: int, bq: int, bk: int) -> tuple[int, int]:
    """The reference's tiles and its refusal of an S they do not divide."""
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"flash_attention: S={S} is not a multiple of the "
                         f"tiles ({bq}, {bk})")
    return bq, bk


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bq: int = 512,
                          bk: int = 512) -> torch.Tensor:
    """q, k, v (BH, S, D) -> (BH, S, D) in q's dtype: the reference's
    (q tile, kv tile) loop with its fp32 online softmax, -1e30 mask and
    1e-30 floor on l."""
    BH, S, D = q.shape
    bq, bk = _tiles(S, bq, bk)
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    for i in range(S // bq):
        qi = q[:, i * bq:(i + 1) * bq].float() * scale
        m = torch.full((BH, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((BH, bq, 1), device=q.device)
        acc = torch.zeros((BH, bq, D), device=q.device)
        qpos = i * bq + torch.arange(bq, device=q.device)[:, None]
        for j in range(S // bk):
            s = qi @ k[:, j * bk:(j + 1) * bk].float().transpose(1, 2)
            if causal:
                kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ v[:, j * bk:(j + 1) * bk].float()
            m = m_new
        out[:, i * bq:(i + 1) * bq] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """One launch on q (B,S,H,D), k, v (B,S,Hkv,D); raises on what the
    kernel does not take."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: the kernel takes bf16 or fp32, "
                         f"got {q.dtype}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes head dims that "
                         f"are multiples of 8 up to {MAX_HEAD_DIM}, got {D}")
    cuda.check(q, "flash q", (B, S, H, D), q.dtype)
    cuda.check(k, "flash k", (B, S, Hkv, D), q.dtype)
    cuda.check(v, "flash v", (B, S, Hkv, D), q.dtype)
    o = torch.empty_like(q)
    cuda.flash_attention(q, k, v, o, causal, 1.0 / math.sqrt(D))
    FLASH.launches += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """q, k, v (BH, S, D) -> (BH, S, D) in q's dtype: the kernel for CUDA
    tensors, ``plain_flash_attention`` for CPU tensors.  ``bq, bk`` are the
    reference's tiles (checked as it checks them); the CUDA tiles are the
    card's own."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"flash_attention: q, k, v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _tiles(q.shape[1], bq, bk)
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None],
                   causal)[:, :, 0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q (B,S,H,D), k, v (B,S,Hkv,D) -> (B,S,H,D), query head h reading KV
    head h // (H // Hkv), at the reference's default tiles.  CPU tensors
    take ``plain_flash_attention_bshd``."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or \
            k.shape[3] != D or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k, v "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _tiles(S, 512, 512)
    if q.device.type != "cpu":
        return _launch(q, k, v, causal)
    return plain_flash_attention_bshd(q, k, v, causal=causal)


def plain_flash_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *,
                               causal: bool = True) -> torch.Tensor:
    """The plain version of ``flash_attention_bshd``, on the reference's
    route: KV heads repeated to H, (batch, head) flattened,
    ``plain_flash_attention``, back to (B, S, H, D)."""
    B, S, H, D = q.shape

    def heads_first(t):
        return t.repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2) \
            .reshape(B * H, S, D)

    o = plain_flash_attention(heads_first(q), heads_first(k), heads_first(v),
                              causal=causal)
    return o.reshape(B, H, S, D).transpose(1, 2)
