"""Horizontally fused AdamW: the optimizer step as bundle members.

The optimizer step is N independent, memory-bound per-tensor updates: the
paper's optimizer scenario.  Each tensor is laid out as a flat (R, 128)
buffer; ``adamw_op`` is the fusible update of one buffer, ``adamw_flat``
one launch of it and ``multi_tensor_adamw`` one N-way bundle of them.

CUDA source: ``csrc/adamw_member.cuh``, a member of the bundle launcher.  It
replaces the TPU kernels ``src/repro/kernels/adam.py:67`` (adamw_op), ``:42``
(adamw_flat) and ``:117`` (multi_tensor_adamw).  Bound on the card: bytes —
22 bytes per bf16 parameter for about a dozen flops.  Design: one CTA per
(bm, 128) block, 16-byte vector loads and stores, p, m and v written in
place (``OpSpec.aliases``), so the update needs no second copy of the
optimizer state.

Chained: the update is also the consumer of a stitched chain
(``core/stitch.py``): a dW GEMM or a row-wise member hands it the gradient
in the same launch, through ``kernels/row.RowChain``, whose CUDA body calls
this member's per-element update (``csrc/adamw_member.cuh``
``adamw_update``).

Memory: ``_flatten_leaf`` hands back a *view* of a leaf whose element count
fills its padded rows exactly (every stacked layer leaf of granite-3-2b) and
copies only a leaf that needs padding (its embedding).

Beside the kernel: ``ADAMW``, its launch record, and ``plain_adamw``, the
plain PyTorch version, op for op the kernel's arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from repro_torch import tree as tree_mod
from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import cuda

LANES = 128

ADAMW = cuda.Kernel("adamw_member", "src/repro_torch/csrc/adamw_member.cuh",
                    "src/repro/kernels/adam.py:67, src/repro/kernels/adam.py"
                    ":117, src/repro/kernels/adam.py:42")


def plain_adamw(scalars, p, g, m, v, *, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """The reference's ``_adam_kernel`` over whole tensors: scalars (1, 128)
    fp32 = [lr, bc1, bc2, ...]; p, g in the param dtype; m, v fp32.
    Returns (new_p, new_m, new_v)."""
    lr, bc1, bc2 = scalars[0, 0], scalars[0, 1], scalars[0, 2]
    pf = p.float()
    gf = g.float()
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * gf * gf
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * pf
    return (pf - lr * step).to(p.dtype), m2, v2


_PDTYPES = {torch.bfloat16: 0, torch.float32: 1}


@dataclass(frozen=True)
class AdamwMember:
    """One (R, 128) buffer's update, ``R // bm`` CTAs of ``bm`` rows."""
    R: int
    bm: int
    dtype: torch.dtype
    b1: float
    b2: float
    eps: float
    wd: float
    kernel: ClassVar[cuda.Kernel] = ADAMW

    @property
    def ctas(self) -> int:
        return self.R // self.bm

    def describe(self, md) -> None:
        """The update's constants, f[0..5] (a row chain's AdamW stage
        reads them too)."""
        if self.dtype not in _PDTYPES:
            raise ValueError(f"adamw member takes bf16 or fp32 params, got "
                             f"{self.dtype}")
        # 1-b1 and 1-b2 rounded from double, as a Python scalar reaches an
        # fp32 tensor op in the plain version
        for j, x in enumerate((self.b1, 1 - self.b1, self.b2, 1 - self.b2,
                               self.eps, self.wd)):
            md.f[j] = x

    def pack(self, md, ins, outs) -> None:
        self.describe(md)
        R, f32 = self.R, torch.float32
        md.kind = cuda.ADAMW
        md.i[0], md.i[1], md.i[2] = R, self.bm, _PDTYPES[self.dtype]
        sc, p, g, m, v = ins
        md.inp[0] = cuda.check(sc, "adamw scalars", (1, LANES), f32)
        md.inp[1] = cuda.check(p, "adamw p", (R, LANES), self.dtype)
        md.inp[2] = cuda.check(g, "adamw g", (R, LANES), self.dtype)
        md.inp[3] = cuda.check(m, "adamw m", (R, LANES), f32)
        md.inp[4] = cuda.check(v, "adamw v", (R, LANES), f32)
        for j, (t, dt) in enumerate(zip(outs, (self.dtype, f32, f32))):
            md.out[j] = cuda.check(t, f"adamw out{j}", (R, LANES), dt)


def adamw_op(R: int, dtype=torch.bfloat16, bm: int = 1024, b1=0.9, b2=0.95,
             eps=1e-8, wd=0.1, name: str | None = None) -> OpSpec:
    """Fusible form of the flat update (grid over row blocks); grid,
    blocks, costs and names are the reference's.  p, m and v are updated
    in place."""
    if R % bm:
        raise ValueError(f"adamw_op: R={R} is not a multiple of bm={bm}")
    blk = lambda s: (s, 0)          # noqa: E731
    const = lambda s: (0, 0)        # noqa: E731
    C, f32 = LANES, torch.float32
    isz = itemsize(dtype)

    def plain(scalars, p, g, m, v):
        return plain_adamw(scalars, p, g, m, v, b1=b1, b2=b2, eps=eps, wd=wd)

    return OpSpec(
        name=name or f"adamw_{R}x{C}", grid=R // bm,
        member=AdamwMember(R, bm, dtype, b1, b2, eps, wd),
        plain=plain,
        inputs=(Operand((1, C), f32, (1, C), const),
                Operand((R, C), dtype, (bm, C), blk),
                Operand((R, C), dtype, (bm, C), blk),
                Operand((R, C), f32, (bm, C), blk),
                Operand((R, C), f32, (bm, C), blk)),
        outputs=(Operand((R, C), dtype, (bm, C), blk),
                 Operand((R, C), f32, (bm, C), blk),
                 Operand((R, C), f32, (bm, C), blk)),
        flops=12.0 * R * C,
        hbm_bytes=R * C * (2 * isz + 3 * 4 + isz + 2 * 4),
        tag="framework:adamw",
        in_names=("scalars", "p", "g", "m", "v"),
        out_names=("p", "m", "v"),
        aliases=((0, 1), (1, 3), (2, 4)))


def adamw_flat(p, g, m, v, scalars, *, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
               bm: int = 1024, plain: bool = False):
    """p, g: (R, 128) param dtype; m, v: (R, 128) fp32; scalars (1, 128)
    fp32 = [lr, bc1, bc2, ...].  One launch; p, m, v are updated in place
    and returned as (new_p, new_m, new_v)."""
    from repro_torch.core import hfuse

    R, C = p.shape
    if C != LANES:
        raise ValueError(f"adamw_flat takes (R, {LANES}) buffers, got "
                         f"{tuple(p.shape)}")
    bm = min(bm, R)
    op = adamw_op(R, p.dtype, bm, b1, b2, eps, wd)
    return hfuse.run_single(op, plain=plain)(scalars, p, g, m, v)


# ---------------------------------------------------------------------------
# Per-leaf layout: flat (R, 128) views where no padding is needed
# ---------------------------------------------------------------------------
def _flatten_leaf(x: torch.Tensor, row_multiple: int = 1):
    """One leaf -> (R, 128) buffer, R a multiple of ``row_multiple``, zero
    padded; a view of ``x`` when it needs no padding.  Returns (buf, n)."""
    n = x.numel()
    R = math.ceil(n / LANES)
    R = math.ceil(R / row_multiple) * row_multiple
    if R * LANES == n and x.is_contiguous():
        return x.view(R, LANES), n
    flat = torch.zeros(R * LANES, dtype=x.dtype, device=x.device)
    flat[:n] = x.reshape(-1)
    return flat.view(R, LANES), n


def _unflatten_leaf(flat2d: torch.Tensor, n: int, like: torch.Tensor):
    return flat2d.reshape(-1)[:n].reshape(like.shape).to(like.dtype)


def _write_back(flat2d: torch.Tensor, n: int, leaf: torch.Tensor) -> None:
    """Land an updated buffer in its leaf (nothing to do for a view)."""
    if flat2d.data_ptr() != leaf.data_ptr() or flat2d.dtype != leaf.dtype:
        leaf.copy_(_unflatten_leaf(flat2d, n, leaf))


def multi_tensor_adamw(params, grads, m, v, scalars, *, b1=0.9, b2=0.95,
                       eps=1e-8, wd=0.1, bm: int = 1024,
                       plain: bool = False):
    """All per-tensor updates as ONE N-way bundle launch (``Schedule((1,) *
    N)``), one ``adamw_op`` per leaf.  The leaves of params, m and v are
    updated in place; returns the trees (params, m, v).  The bundle
    launcher carries at most ``cuda.MAX_MEMBERS`` members."""
    from repro_torch.core import hfuse
    from repro_torch.core.cost_model import Schedule

    lp, lg = tree_mod.leaves(params), tree_mod.leaves(grads)
    lm, lv = tree_mod.leaves(m), tree_mod.leaves(v)
    ops, operands, bufs = [], [], []
    for i, (p_, g_, m_, v_) in enumerate(zip(lp, lg, lm, lv)):
        # big leaves keep a bm-row block, a small one is one block
        bm_i = min(bm, math.ceil(p_.numel() / LANES))
        p2, n = _flatten_leaf(p_, bm_i)
        g2, _ = _flatten_leaf(g_.to(p_.dtype), bm_i)
        m2, _ = _flatten_leaf(m_.float(), bm_i)
        v2, _ = _flatten_leaf(v_.float(), bm_i)
        R = p2.shape[0]
        ops.append(adamw_op(R, p_.dtype, bm_i, b1, b2, eps, wd,
                            name=f"adamw_t{i}_{R}x{LANES}"))
        operands += [scalars, p2, g2, m2, v2]
        bufs.append((n, p2, m2, v2))
    hfuse.generate(ops, Schedule((1,) * len(ops)), plain=plain)(*operands)
    for (n, p2, m2, v2), p_, m_, v_ in zip(bufs, lp, lm, lv):
        _write_back(p2, n, p_)
        _write_back(m2, n, m_)
        _write_back(v2, n, v_)
    return params, m, v


# ---------------------------------------------------------------------------
# Whole-tree concatenation (the single-buffer form)
# ---------------------------------------------------------------------------
def flatten_for_adam(tree):
    """Concatenate all leaves into one zero-padded (R, 128) buffer of the
    first leaf's dtype.  Returns (buf, n)."""
    leaves = tree_mod.leaves(tree)
    flat = torch.cat([leaf.reshape(-1).to(leaves[0].dtype)
                      for leaf in leaves])
    n = flat.numel()
    R = math.ceil(n / LANES)
    if R * LANES != n:
        flat = torch.cat([flat, flat.new_zeros(R * LANES - n)])
    return flat.view(R, LANES), n


def unflatten_from_adam(flat2d, n, tree):
    """Split a ``flatten_for_adam`` buffer back into ``tree``'s leaves."""
    flat = flat2d.reshape(-1)[:n]
    out, off = [], 0
    for leaf in tree_mod.leaves(tree):
        k = leaf.numel()
        out.append(flat[off:off + k].reshape(leaf.shape).to(leaf.dtype))
        off += k
    return tree_mod.unflatten(tree, out)
