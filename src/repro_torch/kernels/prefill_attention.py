"""Chunked prefill attention: one prompt chunk of ONE slot (C query rows at
absolute offset ``off``) against that slot's KV cache, causal
(``kpos <= off + r``), GQA; the cache contiguous or paged in the shared
block arena.  The chunk's own k/v are in the cache before the launch, so
the kernel only reads it.

CUDA source: ``csrc/prefill_attention.cuh`` (on
``csrc/attention_mma.cuh``).  It replaces the TPU kernel
``src/repro/kernels/prefill_attention.py:40`` (prefill_attention_op,
contiguous and ``block_table=`` forms; the paged form looks each kv row up
in the slot's table row, as the decode member does).  Bound on the card:
operations — a 512-row chunk does O(C) flops per cache byte.  Design: the
tensor-core tile loop (``mma.sync``, fp32 accumulation, P as two bf16
terms, the online softmax in fp32 registers); one CTA per (tile of
``ROWS_PER_CTA`` rows, KV head), the rows being the chunk's query
positions times the rep heads of the group, so each staged k/v tile
serves them all; the kv loop stops at the tile's last causal position.

Beside the kernel: ``PREFILL``, its launch record, and
``plain_prefill_attention`` and ``plain_paged_prefill_attention``, the
plain PyTorch versions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from repro_torch.core.op_spec import MIN_BLOCK_ROWS, Operand, OpSpec, itemsize
from repro_torch.kernels import cuda
from repro_torch.kernels.decode_attention import gather_pages
from repro_torch.kernels.flash_attention import MAX_HEAD_DIM

PREFILL = cuda.Kernel("prefill_attention",
                      "src/repro_torch/csrc/prefill_attention.cuh",
                      "src/repro/kernels/prefill_attention.py:40")
NEG_INF = -1e30
# rows (query positions x the group's rep heads) a CTA: 4 row groups of 16,
# two kv parts each (csrc/prefill_attention.cuh).  The tile loop splits its 8
# warps into RT / 16 row groups, so it takes RT in ROWS_TAKEN only.
ROWS_PER_CTA = 64
ROWS_TAKEN = (16, 32, 64, 128)


def plain_prefill_attention(off: torch.Tensor, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor):
    """off (1,1) i32; q (C,H,D); k, v (S,Hkv,D) -> o (C,H,D) fp32
    normalised, m, l (C,H,1) fp32; query row r admits position p iff
    p <= off + r."""
    C, H, D = q.shape
    S, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(C, Hkv, rep, D)
    s = torch.einsum("chrd,khd->chrk", qg, k.float())
    kpos = torch.arange(S, device=q.device).view(1, 1, 1, S)
    qpos = (off.reshape(1).to(torch.int64)
            + torch.arange(C, device=q.device)).view(C, 1, 1, 1)
    s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("chrk,khd->chrd", p, v.float()) / l.clamp_min(1e-30)
    return (o.reshape(C, H, D), m.reshape(C, H, 1), l.reshape(C, H, 1))


def plain_paged_prefill_attention(off: torch.Tensor, bt: torch.Tensor,
                                  q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor):
    """off (1,1); bt (1, max_blocks) i32, the slot's table row; q (C,H,D);
    k, v the arena (num_blocks, bs, Hkv, D): gather the pages, then the
    contiguous plain version."""
    return plain_prefill_attention(off, q, gather_pages(k, bt)[0],
                                   gather_pages(v, bt)[0])


@dataclass(frozen=True)
class PrefillAttentionMember:
    C: int
    S: int
    H: int
    Hkv: int
    D: int
    bs: int = 0                 # page rows (0: contiguous cache)
    num_blocks: int = 0         # arena blocks (paged)
    kernel: ClassVar[cuda.Kernel] = PREFILL

    @property
    def ctas(self) -> int:
        """One CTA per (tile of ROWS_PER_CTA of the group's C * rep rows,
        KV head)."""
        rep = self.H // self.Hkv
        return math.ceil(self.C * rep / ROWS_PER_CTA) * self.Hkv

    def pack(self, md, ins, outs) -> None:
        C, S, H, Hkv, D = self.C, self.S, self.H, self.Hkv, self.D
        if H % Hkv or D % 8 or not 8 <= D <= MAX_HEAD_DIM:
            raise ValueError(f"prefill attention takes H % Hkv == 0 and "
                             f"head dims that are multiples of 8 up to "
                             f"{MAX_HEAD_DIM}, got H={H} Hkv={Hkv} D={D}")
        if ROWS_PER_CTA not in ROWS_TAKEN:
            raise ValueError(f"prefill attention takes {ROWS_TAKEN} rows a "
                             f"CTA, got {ROWS_PER_CTA}")
        bf, f32 = torch.bfloat16, torch.float32
        md.kind = cuda.PREFILL_ATTN
        md.i[0], md.i[1], md.i[2], md.i[3], md.i[4] = C, S, H, Hkv, D
        md.i[5] = ROWS_PER_CTA
        md.f[0] = 1.0 / math.sqrt(D)
        kv_shape = (S, Hkv, D)
        if self.bs:
            off, bt, q, k, v = ins
            md.i[6], md.i[7] = self.bs, S // self.bs
            md.inp[4] = cuda.check(bt, "prefill bt", (1, S // self.bs),
                                   torch.int32)
            kv_shape = (self.num_blocks, self.bs, Hkv, D)
        else:
            off, q, k, v = ins
        md.inp[0] = cuda.check(off, "prefill off", (1, 1), torch.int32)
        md.inp[1] = cuda.check(q, "prefill q", (C, H, D), bf)
        md.inp[2] = cuda.check(k, "prefill k", kv_shape, bf)
        md.inp[3] = cuda.check(v, "prefill v", kv_shape, bf)
        for j, (t, shape) in enumerate(zip(outs, ((C, H, D), (C, H, 1),
                                                  (C, H, 1)))):
            md.out[j] = cuda.check(t, f"prefill out{j}", shape, f32)


def prefill_attention_op(C: int, S: int, H: int, Hkv: int, D: int,
                         dtype=torch.bfloat16, ck: int = 1024,
                         name: str | None = None,
                         block_table=None) -> OpSpec:
    """off (1,1) i32; q (C,H,D); k, v (S,Hkv,D) -> o (C,H,D), m, l (C,H,1)
    fp32.  Grid ``S // ck`` kv-chunk steps, the explicit shrink factory
    (smaller ``ck``) and the operand order are the reference's; the member
    ignores ``ck``.

    ``block_table=(num_blocks, block_size)``: the paged form.  k, v are the
    shared arena (num_blocks, block_size, Hkv, D), ``S`` is the slot's
    logical capacity, and a (1, S // block_size) int32 operand "bt" (after
    "off"), the slot's table row, maps its pages to arena blocks;
    ``ck % block_size == 0``."""
    if S % ck or H % Hkv:
        raise ValueError(f"prefill_attention_op: S={S} % ck={ck} and "
                         f"H={H} % Hkv={Hkv} must be 0")
    nk = S // ck
    paged = block_table is not None
    if paged:
        num_blocks, bs = block_table
        if ck % bs or S % bs:
            raise ValueError(f"prefill_attention_op: ck={ck} and S={S} must "
                             f"be multiples of the block size {bs}")
    resolved = name or (f"prefill_attn_C{C}_S{S}_H{H}kv{Hkv}"
                        + (f"_pg{bs}" if paged else ""))

    def shrink(factor: int):
        sck = ck // factor
        if ck % factor or sck < MIN_BLOCK_ROWS or (paged and sck % bs):
            return None
        return prefill_attention_op(C, S, H, Hkv, D, dtype=dtype, ck=sck,
                                    name=resolved, block_table=block_table)

    isz = itemsize(dtype)
    f32 = torch.float32
    const3 = lambda s: (0, 0, 0)            # noqa: E731
    if paged:
        bt_in = (Operand((1, S // bs), torch.int32, (1, S // bs),
                         lambda s: (0, 0)),)
        kv = tuple(Operand((num_blocks, bs, Hkv, D), dtype,
                           (num_blocks, bs, Hkv, D), lambda s: (0, 0, 0, 0))
                   for _ in range(2))
        bt_name, plain = ("bt",), plain_paged_prefill_attention
        member = PrefillAttentionMember(C, S, H, Hkv, D, bs, num_blocks)
    else:
        bt_in, bt_name, plain = (), (), plain_prefill_attention
        kv = tuple(Operand((S, Hkv, D), dtype, (ck, Hkv, D),
                           lambda s: (s, 0, 0)) for _ in range(2))
        member = PrefillAttentionMember(C, S, H, Hkv, D)
    return OpSpec(
        name=resolved, grid=nk,
        member=member,
        plain=plain,
        inputs=(Operand((1, 1), torch.int32, (1, 1), lambda s: (0, 0)),)
        + bt_in + (Operand((C, H, D), dtype, (C, H, D), const3),) + kv,
        outputs=(Operand((C, H, D), f32, (C, H, D), const3),
                 Operand((C, H, 1), f32, (C, H, 1), const3),
                 Operand((C, H, 1), f32, (C, H, 1), const3)),
        flops=2.0 * C * H * S * D * 2,
        hbm_bytes=2.0 * S * Hkv * D * isz + C * H * D * (isz + 4.0)
        + 4.0 * C * H * 2,
        shrink=shrink,
        tag="framework:prefill_attention",
        in_names=("off",) + bt_name + ("q", "k", "v"),
        out_names=("o", "m", "l"))
