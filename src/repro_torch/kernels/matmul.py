"""Row matmul as a fusible op — the GEMM member of the row family
(``kernels/row.py``, CUDA source ``csrc/row_member.cuh``), replacing the
TPU kernel ``src/repro/kernels/matmul.py:64`` (matmul_1d_op)."""
from __future__ import annotations

import torch

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import row


def matmul_1d_op(M: int, K: int, N: int, dtype=torch.bfloat16,
                 bm: int = 256) -> OpSpec:
    """(M, K) @ (K, N) -> (M, N), fp32 accumulation, cast to ``dtype``.
    Grid over M row blocks with the weight resident, as the reference plans
    it; the CUDA member tiles the weight's columns instead, in bf16 or, for
    ``dtype=float32`` (the MoE router), in fp32."""
    if M % bm:
        raise ValueError(f"matmul_1d_op: M={M} is not a multiple of bm={bm}")

    def plain(x, w):
        return (row.plain_gemm(x, w, dtype),)

    return OpSpec(
        name=f"matmul_{M}x{K}x{N}", grid=M // bm,
        member=row.RowMember("gemm", M=M, K=K, N=N,
                             fp32=dtype == torch.float32),
        plain=plain,
        inputs=(Operand((M, K), dtype, (bm, K), lambda s: (s, 0)),
                Operand((K, N), dtype, (K, N), lambda s: (0, 0))),
        outputs=(Operand((M, N), dtype, (bm, N), lambda s: (s, 0)),),
        flops=2.0 * M * K * N,
        hbm_bytes=(M * K + K * N + M * N) * itemsize(dtype),
        tag="framework:matmul",
        in_names=("x", "w"), out_names=("out",))
