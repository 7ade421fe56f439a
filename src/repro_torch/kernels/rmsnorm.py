"""RMSNorm as a fusible op — a member of the row family (``kernels/row.py``,
CUDA source ``csrc/row_member.cuh``), replacing the TPU kernel
``src/repro/kernels/rmsnorm.py:38`` (rmsnorm_op)."""
from __future__ import annotations

import torch

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import row


def rmsnorm_op(R: int, d: int, dtype=torch.bfloat16, bm: int = 256,
               eps: float = 1e-6) -> OpSpec:
    """x (R, d), scale (1, d) fp32 -> (R, d).  Grid, blocks and costs are
    the reference's."""
    if R % bm:
        raise ValueError(f"rmsnorm_op: R={R} is not a multiple of bm={bm}")

    def plain(x, scale):
        return (row.plain_rmsnorm(x, scale, eps),)

    return OpSpec(
        name=f"rmsnorm_{R}x{d}", grid=R // bm,
        member=row.RowMember("rmsnorm", M=R, K=d, N=d, eps=eps),
        plain=plain,
        inputs=(Operand((R, d), dtype, (bm, d), lambda s: (s, 0)),
                Operand((1, d), torch.float32, (1, d), lambda s: (0, 0))),
        outputs=(Operand((R, d), dtype, (bm, d), lambda s: (s, 0)),),
        flops=4.0 * R * d,
        hbm_bytes=2.0 * R * d * itemsize(dtype),
        tag="framework:rmsnorm",
        in_names=("x", "scale"), out_names=("out",))
