"""Decode attention: one new query token per slot against that slot's
contiguous KV cache, GQA, per-slot valid length.

CUDA source: ``csrc/decode_attention.cuh`` (on ``csrc/attention_core.cuh``).
It replaces the TPU kernel ``src/repro/kernels/decode_attention.py:44``
(decode_attention_op, contiguous form, ``dynamic_length=True``).  Bound on
the card: bytes — it streams each slot's valid cache prefix and does O(D)
flops per byte.  Design: one CTA per (slot, KV head) carries all rep = H/Hkv
query heads of the group, so each cached row is read once; the kv loop (the
reference's grid-order carry, made a loop inside the CTA) stops at the
slot's own length.  Split-KV across CTAs is later work.

Beside the kernel: ``DECODE``, its launch record, and
``plain_decode_attention``, the plain PyTorch version.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import cuda

DECODE = cuda.Kernel("decode_attention",
                     "src/repro_torch/csrc/decode_attention.cuh",
                     "src/repro/kernels/decode_attention.py:44")
NEG_INF = -1e30


def plain_decode_attention(length: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor):
    """length (B,1) i32; q (B,H,D); k, v (B,S,Hkv,D) -> o (B,H,D) fp32
    normalised, m, l (B,H,1) fp32; position p of slot b is valid iff
    p < length[b]."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bkhd->bhrk", qg, k.float())
    kpos = torch.arange(S, device=q.device)
    valid = kpos.view(1, 1, 1, S) < length.view(B, 1, 1, 1)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrk,bkhd->bhrd", p, v.float()) / l.clamp_min(1e-30)
    return (o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1))


@dataclass(frozen=True)
class DecodeAttentionMember:
    B: int
    S: int
    H: int
    Hkv: int
    D: int
    kernel: ClassVar[cuda.Kernel] = DECODE

    @property
    def ctas(self) -> int:
        return self.B * self.Hkv

    def pack(self, md, ins, outs) -> None:
        B, S, H, Hkv, D = self.B, self.S, self.H, self.Hkv, self.D
        if H % Hkv or D % 8:
            raise ValueError(f"decode attention takes H % Hkv == 0 and "
                             f"D % 8 == 0, got H={H} Hkv={Hkv} D={D}")
        bf, f32 = torch.bfloat16, torch.float32
        md.kind = cuda.DECODE_ATTN
        md.i[0], md.i[1], md.i[2], md.i[3], md.i[4] = B, S, H, Hkv, D
        md.f[0] = 1.0 / math.sqrt(D)
        length, q, k, v = ins
        md.inp[0] = cuda.check(length, "decode len", (B, 1), torch.int32)
        md.inp[1] = cuda.check(q, "decode q", (B, H, D), bf)
        md.inp[2] = cuda.check(k, "decode k", (B, S, Hkv, D), bf)
        md.inp[3] = cuda.check(v, "decode v", (B, S, Hkv, D), bf)
        for j, (t, shape) in enumerate(zip(outs, ((B, H, D), (B, H, 1),
                                                  (B, H, 1)))):
            md.out[j] = cuda.check(t, f"decode out{j}", shape, f32)


def decode_attention_op(B: int, S: int, H: int, Hkv: int, D: int,
                        dtype=torch.bfloat16, ck: int = 1024,
                        length=None, dynamic_length: bool = False,
                        block_table=None) -> OpSpec:
    """q (B,H,D); cache k, v (B,S,Hkv,D); len (B,1) i32 -> o (B,H,D) fp32,
    m, l (B,H,1) fp32.  Grid, blocks, names and costs are the reference's
    (``B * S // ck`` batch-major steps).  The port's member takes the
    per-slot length operand only."""
    if block_table is not None:
        raise NotImplementedError("paged KV (block_table=) is not ported "
                                  "yet (ROADMAP: paged KV)")
    if not dynamic_length or length is not None:
        raise NotImplementedError("the decode attention member takes the "
                                  "per-slot (B, 1) length operand: pass "
                                  "dynamic_length=True")
    if S % ck or H % Hkv:
        raise ValueError(f"decode_attention_op: S={S} % ck={ck} and "
                         f"H={H} % Hkv={Hkv} must be 0")
    nk = S // ck
    isz = itemsize(dtype)
    f32 = torch.float32
    return OpSpec(
        name=f"decode_attn_B{B}_S{S}_H{H}kv{Hkv}",
        grid=B * nk,
        member=DecodeAttentionMember(B, S, H, Hkv, D),
        plain=plain_decode_attention,
        inputs=(Operand((B, 1), torch.int32, (1, 1), lambda s: (s // nk, 0)),
                Operand((B, H, D), dtype, (1, H, D),
                        lambda s: (s // nk, 0, 0)),
                Operand((B, S, Hkv, D), dtype, (1, ck, Hkv, D),
                        lambda s: (s // nk, s % nk, 0, 0)),
                Operand((B, S, Hkv, D), dtype, (1, ck, Hkv, D),
                        lambda s: (s // nk, s % nk, 0, 0))),
        outputs=(Operand((B, H, D), f32, (1, H, D), lambda s: (s // nk, 0, 0)),
                 Operand((B, H, 1), f32, (1, H, 1), lambda s: (s // nk, 0, 0)),
                 Operand((B, H, 1), f32, (1, H, 1),
                         lambda s: (s // nk, 0, 0))),
        flops=2.0 * B * H * S * D * 2,
        hbm_bytes=2.0 * B * S * Hkv * D * isz + 2.0 * B * H * D * isz,
        tag="framework:decode_attention",
        in_names=("len", "q", "k", "v"), out_names=("o", "m", "l"))
