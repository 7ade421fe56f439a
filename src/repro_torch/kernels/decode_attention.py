"""Decode attention: one new query token per slot against that slot's KV
cache, GQA, per-slot valid length; the cache either contiguous per slot or
paged in a block arena shared by the slots.

CUDA source: ``csrc/decode_attention.cuh``.  It replaces the TPU kernel
``src/repro/kernels/decode_attention.py:44`` (decode_attention_op: the
per-slot ``dynamic_length=True`` form and the static forms, a fixed
``length`` or the whole cache, whose valid length is a launch constant;
contiguous and ``block_table=`` forms; the paged
form's page gather, ``:35`` ``gather_pages``, becomes a table lookup per kv
row inside the staging loop).  Bound on the card: bytes — it streams each
slot's valid cache prefix and does O(D) flops per byte.  Design: split-KV.
The positions are cut into ranges of ``kv_split(bs)`` (256) positions, one
CTA per (slot, KV head, range), each carrying all rep = H/Hkv query heads
of the group so a cached row is read once; a range past its slot's length
exits at once, and the (slot, head)'s last CTA combines the live ranges in
range order (no float atomics: any launch gives the same bits).  Inside a
CTA each warp streams its own tiles by ``cp.async`` and reduces dot
products by shuffles.  The paged form reads position p from arena row
``bt[b, p // bs] * bs + p % bs`` and does the contiguous form's math on
it, so the two are bitwise equal on equal logical content.

Beside the kernel: ``DECODE``, its launch record, ``plain_decode_attention``
and ``plain_paged_decode_attention``, the plain PyTorch versions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from repro_torch.core.op_spec import MIN_BLOCK_ROWS, Operand, OpSpec, itemsize
from repro_torch.kernels import cuda

DECODE = cuda.Kernel("decode_attention",
                     "src/repro_torch/csrc/decode_attention.cuh",
                     "src/repro/kernels/decode_attention.py:44, "
                     "src/repro/kernels/decode_attention.py:35")
NEG_INF = -1e30
KV_SPLIT = 256      # cache positions per CTA (csrc/decode_attention.cuh)
MAX_HEAD_DIM = 256  # 8 elements a lane, at most 32 lanes a cached row


def kv_split(bs: int = 0) -> int:
    """Positions per split: ``KV_SPLIT``, or the least multiple of it that
    holds whole pages of ``bs`` rows.  Never the live lengths: a planned
    launch's CTA count is static."""
    return math.lcm(KV_SPLIT, bs) if bs else KV_SPLIT


def n_splits(S: int, bs: int = 0) -> int:
    """CTAs per (slot, KV head): the splits that cover S positions."""
    return -(-S // kv_split(bs))


def plain_decode_attention(length, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor):
    """length (B,1) i32, or one int for every slot; q (B,H,D); k, v
    (B,S,Hkv,D) -> o (B,H,D) fp32 normalised, m, l (B,H,1) fp32; position
    p of slot b is valid iff p < length[b]."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, Hkv, rep, D)
    s = torch.einsum("bhrd,bkhd->bhrk", qg, k.float())
    kpos = torch.arange(S, device=q.device)
    lim = length.view(B, 1, 1, 1) if torch.is_tensor(length) else length
    valid = kpos.view(1, 1, 1, S) < lim
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhrk,bkhd->bhrd", p, v.float()) / l.clamp_min(1e-30)
    return (o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1))


def gather_pages(arena: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The logical caches (R, max_blocks * bs, Hkv, D) that block-table rows
    bt (R, max_blocks) map into the arena (num_blocks, bs, Hkv, D)."""
    R, nb = bt.shape
    return arena[bt.long()].reshape(R, nb * arena.shape[1], *arena.shape[2:])


def plain_paged_decode_attention(bt: torch.Tensor, length,
                                 q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor):
    """bt (B, max_blocks) i32; length (B,1) or an int; q (B,H,D); k, v the
    arena
    (num_blocks, bs, Hkv, D): gather the pages, then the contiguous plain
    version."""
    return plain_decode_attention(length, q, gather_pages(k, bt),
                                  gather_pages(v, bt))


def _static_plain(length: int, paged: bool):
    """The plain version of a static form: the operands without "len"."""
    if paged:
        def plain(bt, q, k, v):
            return plain_paged_decode_attention(bt, length, q, k, v)
    else:
        def plain(q, k, v):
            return plain_decode_attention(length, q, k, v)
    return plain


@dataclass(frozen=True)
class DecodeAttentionMember:
    B: int
    S: int
    H: int
    Hkv: int
    D: int
    bs: int = 0                 # page rows (0: contiguous cache)
    num_blocks: int = 0         # arena blocks (paged)
    length: int = 0             # static forms: every slot's valid length
    #                             (0: the per-slot "len" operand)
    kernel: ClassVar[cuda.Kernel] = DECODE

    @property
    def ctas(self) -> int:
        return self.B * self.Hkv * n_splits(self.S, self.bs)

    def pack(self, md, ins, outs):
        """Describe, check and bind one launch; returns the workspace,
        alive until the launch is queued."""
        B, S, H, Hkv, D = self.B, self.S, self.H, self.Hkv, self.D
        if H % Hkv or D % 8 or D > MAX_HEAD_DIM:
            raise ValueError(f"decode attention takes H % Hkv == 0 and "
                             f"D % 8 == 0 up to {MAX_HEAD_DIM}, got H={H} "
                             f"Hkv={Hkv} D={D}")
        bf, f32 = torch.bfloat16, torch.float32
        md.kind = cuda.DECODE_ATTN
        md.i[0], md.i[1], md.i[2], md.i[3], md.i[4] = B, S, H, Hkv, D
        md.i[7] = kv_split(self.bs)
        md.f[0] = 1.0 / math.sqrt(D)
        kv_shape = (B, S, Hkv, D)
        if self.bs:
            bt, *ins = ins
            md.i[5], md.i[6] = self.bs, S // self.bs
            md.inp[4] = cuda.check(bt, "decode bt", (B, S // self.bs),
                                   torch.int32)
            kv_shape = (self.num_blocks, self.bs, Hkv, D)
        if self.length:
            q, k, v = ins
            md.inp[0], md.i[8] = None, self.length
        else:
            length, q, k, v = ins
            md.inp[0] = cuda.check(length, "decode len", (B, 1), torch.int32)
        md.inp[1] = cuda.check(q, "decode q", (B, H, D), bf)
        md.inp[2] = cuda.check(k, "decode k", kv_shape, bf)
        md.inp[3] = cuda.check(v, "decode v", kv_shape, bf)
        for j, (t, shape) in enumerate(zip(outs, ((B, H, D), (B, H, 1),
                                                  (B, H, 1)))):
            md.out[j] = cuda.check(t, f"decode out{j}", shape, f32)
        ws = self.workspace(q.device)
        md.out[3] = ws.data_ptr()
        return ws

    def workspace(self, device) -> torch.Tensor:
        """A launch's workspace: B * Hkv int tickets, zeroed (padded to 16
        bytes), then the fp32 partials, (o, m, l) of each query row of each
        (slot, head, split)."""
        B, H, Hkv, D = self.B, self.H, self.Hkv, self.D
        tickets = -(-B * Hkv // 4) * 4
        ws = torch.empty(tickets + B * Hkv * n_splits(self.S, self.bs)
                         * (H // Hkv) * (D + 2), dtype=torch.int32,
                         device=device)
        ws[:B * Hkv].zero_()
        return ws


def decode_attention_op(B: int, S: int, H: int, Hkv: int, D: int,
                        dtype=torch.bfloat16, ck: int = 1024,
                        length=None, dynamic_length: bool = False,
                        block_table=None) -> OpSpec:
    """q (B,H,D); cache k, v (B,S,Hkv,D) -> o (B,H,D) fp32, m, l (B,H,1)
    fp32.  Grid, blocks, names, costs and operand order are the
    reference's (``B * S // ck`` batch-major steps).  ``length`` (static)
    masks the valid cache prefix of every slot, None the whole cache; both
    static forms are a launch constant of the member.
    ``dynamic_length=True`` instead adds the (B, 1) int32 operand "len"
    (before q) holding each slot's valid prefix.

    ``block_table=(num_blocks, block_size)``: the paged form.  k, v are the
    shared arena (num_blocks, block_size, Hkv, D), ``S`` is a slot's
    logical capacity, and a (B, S // block_size) int32 operand "bt" (first)
    maps each slot's pages to arena blocks; ``ck % block_size == 0``."""
    if dynamic_length and length is not None:
        raise ValueError("decode_attention_op: pass length or "
                         "dynamic_length=True, not both")
    if S % ck or H % Hkv:
        raise ValueError(f"decode_attention_op: S={S} % ck={ck} and "
                         f"H={H} % Hkv={Hkv} must be 0")
    valid_len = S if length is None else int(length)
    if not dynamic_length and not 1 <= valid_len <= S:
        raise ValueError(f"decode_attention_op: length {valid_len} must "
                         f"lie in [1, S={S}]")
    static = 0 if dynamic_length else valid_len
    nk = S // ck
    isz = itemsize(dtype)
    f32 = torch.float32
    if block_table is not None:
        num_blocks, bs = block_table
        if ck % bs or S % bs:
            raise ValueError(f"decode_attention_op: ck={ck} and S={S} must "
                             f"be multiples of the block size {bs}")
        bt_in = (Operand((B, S // bs), torch.int32, (1, S // bs),
                         lambda s: (s // nk, 0)),)
        kv = tuple(Operand((num_blocks, bs, Hkv, D), dtype,
                           (num_blocks, bs, Hkv, D), lambda s: (0, 0, 0, 0))
                   for _ in range(2))
        suffix, bt_name, plain = f"_pg{bs}", ("bt",), \
            plain_paged_decode_attention
        member = DecodeAttentionMember(B, S, H, Hkv, D, bs, num_blocks,
                                       static)

        def shrink(factor: int):
            sck = ck // factor
            if ck % factor or sck % bs or sck < MIN_BLOCK_ROWS:
                return None
            return decode_attention_op(B, S, H, Hkv, D, dtype=dtype, ck=sck,
                                       length=length,
                                       dynamic_length=dynamic_length,
                                       block_table=block_table)
    else:
        bt_in, suffix, bt_name, shrink = (), "", (), None
        kv = tuple(Operand((B, S, Hkv, D), dtype, (1, ck, Hkv, D),
                           lambda s: (s // nk, s % nk, 0, 0))
                   for _ in range(2))
        plain, member = plain_decode_attention, \
            DecodeAttentionMember(B, S, H, Hkv, D, length=static)
    len_in = ((Operand((B, 1), torch.int32, (1, 1), lambda s: (s // nk, 0)),)
              if dynamic_length else ())
    if not dynamic_length:
        plain = _static_plain(valid_len, block_table is not None)
    return OpSpec(
        name=f"decode_attn_B{B}_S{S}_H{H}kv{Hkv}{suffix}",
        grid=B * nk,
        member=member,
        plain=plain,
        inputs=bt_in + len_in
        + (Operand((B, H, D), dtype, (1, H, D), lambda s: (s // nk, 0, 0)),)
        + kv,
        outputs=(Operand((B, H, D), f32, (1, H, D), lambda s: (s // nk, 0, 0)),
                 Operand((B, H, 1), f32, (1, H, 1), lambda s: (s // nk, 0, 0)),
                 Operand((B, H, 1), f32, (1, H, 1),
                         lambda s: (s // nk, 0, 0))),
        flops=2.0 * B * H * valid_len * D * 2,
        hbm_bytes=2.0 * B * valid_len * Hkv * D * isz + 2.0 * B * H * D * isz,
        shrink=shrink,
        tag="framework:decode_attention",
        in_names=bt_name + (("len",) if dynamic_length else ())
        + ("q", "k", "v"),
        out_names=("o", "m", "l"))
