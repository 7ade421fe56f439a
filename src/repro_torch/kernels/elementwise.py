"""Row-wise activation and residual add as fusible ops — members of the row
family (``kernels/row.py``, CUDA source ``csrc/row_member.cuh``), replacing
the TPU kernels ``src/repro/kernels/elementwise.py:20`` (activation_op) and
``:69`` (residual_add_op).  Standalone each is a pure device-memory round
trip; its point is to be stitched onto the member that produces its input
(``core/stitch.py``): the activation and the residual add become epilogues
of the row GEMM, or the second stage of a row-wise chain."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import row
from repro_torch.kernels.row import (gelu_gate, gelu_plain,  # noqa: F401
                                     plain_residual_add, relu2, silu_gate)


def activation_op(R: int, F_in: int, F_out: int, fn: Callable,
                  dtype=torch.bfloat16, bm: int = 256,
                  name: str | None = None) -> OpSpec:
    """out = fn(h) row-wise; h (R, F_in) -> out (R, F_out).  ``fn`` is one
    of ``silu_gate``, ``gelu_gate``, ``gelu_plain``, ``relu2``; the CUDA
    member takes bf16 or fp32."""
    act = row.act_name(fn)
    bm = min(bm, R)
    if R % bm:
        raise ValueError(f"activation_op: R={R} is not a multiple of bm={bm}")

    def plain(h):
        return (fn(h).to(dtype),)

    return OpSpec(
        name=name or f"act_{R}x{F_in}", grid=R // bm,
        member=row.RowMember("act", M=R, K=F_in, N=F_out, act=act,
                             fp32=dtype == torch.float32),
        plain=plain,
        inputs=(Operand((R, F_in), dtype, (bm, F_in), lambda s: (s, 0)),),
        outputs=(Operand((R, F_out), dtype, (bm, F_out), lambda s: (s, 0)),),
        flops=8.0 * R * F_in,
        hbm_bytes=float(R * (F_in + F_out)) * itemsize(dtype),
        tag="framework:activation",
        in_names=("h",), out_names=("out",))


def residual_add_op(R: int, F: int, dtype=torch.bfloat16, bm: int = 256,
                    name: str | None = None) -> OpSpec:
    """out = h + res row-wise, computed in fp32 and cast to ``dtype``: the
    matmul->residual-add epilogue.  Grid, blocks, costs, tag and names are
    the reference's; the CUDA member takes bf16 or fp32."""
    bm = min(bm, R)
    if R % bm:
        raise ValueError(f"residual_add_op: R={R} is not a multiple of "
                         f"bm={bm}")
    blk = lambda s: (s, 0)   # noqa: E731

    def plain(h, res):
        return (plain_residual_add(h, res, dtype),)

    return OpSpec(
        name=name or f"resadd_{R}x{F}", grid=R // bm,
        member=row.RowMember("resadd", M=R, K=F, N=F,
                             fp32=dtype == torch.float32),
        plain=plain,
        inputs=(Operand((R, F), dtype, (bm, F), blk),
                Operand((R, F), dtype, (bm, F), blk)),
        outputs=(Operand((R, F), dtype, (bm, F), blk),),
        flops=1.0 * R * F,
        hbm_bytes=3.0 * R * F * itemsize(dtype),
        tag="framework:residual_add",
        in_names=("h", "res"), out_names=("out",))
