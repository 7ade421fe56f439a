"""RMSNorm — a member of the row family (``kernels/row.py``, CUDA source
``csrc/row_member.cuh``), as a fusible op and launched alone.  It replaces
the TPU kernels ``src/repro/kernels/rmsnorm.py:38`` (rmsnorm_op) and
``:20`` (rmsnorm): the reference runs one body in both, and so does the
port, ``rmsnorm`` being ``rmsnorm_op`` launched by ``hfuse.run_single``."""
from __future__ import annotations

import torch

from repro_torch.core import hfuse
from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import row


def rmsnorm_op(R: int, d: int, dtype=torch.bfloat16, bm: int = 256,
               eps: float = 1e-6) -> OpSpec:
    """x (R, d), scale (1, d) fp32 -> (R, d).  Grid, blocks and costs are
    the reference's; the CUDA member takes bf16 or fp32 rows."""
    if R % bm:
        raise ValueError(f"rmsnorm_op: R={R} is not a multiple of bm={bm}")

    def plain(x, scale):
        return (row.plain_rmsnorm(x, scale, eps),)

    return OpSpec(
        name=f"rmsnorm_{R}x{d}", grid=R // bm,
        member=row.RowMember("rmsnorm", M=R, K=d, N=d, eps=eps,
                             fp32=dtype == torch.float32),
        plain=plain,
        inputs=(Operand((R, d), dtype, (bm, d), lambda s: (s, 0)),
                Operand((1, d), torch.float32, (1, d), lambda s: (0, 0))),
        outputs=(Operand((R, d), dtype, (bm, d), lambda s: (s, 0)),),
        flops=4.0 * R * d,
        hbm_bytes=2.0 * R * d * itemsize(dtype),
        tag="framework:rmsnorm",
        in_names=("x", "scale"), out_names=("out",))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            bm: int = 256) -> torch.Tensor:
    """x (R, d); scale (d,) fp32 -> (R, d) in x's dtype: one launch of the
    rmsnorm member for CUDA tensors, its plain version for CPU tensors.
    Refuses what the reference refuses: R not a multiple of min(bm, R)."""
    R, d = x.shape
    bm = min(bm, R)
    if R % bm:
        raise ValueError(f"rmsnorm: R={R} is not a multiple of bm={bm}")
    op = rmsnorm_op(R, d, x.dtype, bm, eps)
    return hfuse.run_single(op)(x, scale.reshape(1, d))[0]
