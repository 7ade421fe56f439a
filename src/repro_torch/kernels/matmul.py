"""Matmul: the row GEMM as a fusible op and the standalone tiled matmul.

  * ``matmul_1d_op`` — the GEMM member of the row family
    (``kernels/row.py``, CUDA source ``csrc/row_member.cuh``), replacing
    the TPU kernel ``src/repro/kernels/matmul.py:64`` (matmul_1d_op).
  * ``matmul`` — its own CUDA kernel (``csrc/tiled_matmul.cuh``), replacing
    the TPU kernel ``src/repro/kernels/matmul.py:38`` (matmul).  Bound on
    the card: operations at the shapes ``kernels/ops.py`` serves (a 8192 x
    2048 @ 2048 x 3072 product does 103 GFLOP against 59 MB).  bf16: a
    persistent CTA per SM walks 128 x 256 output tiles, a producer warp
    bringing x and w by TMA into a 4-stage ring and two consumer
    warpgroups running ``wgmma`` (w fed as the MN-major operand, no
    transposed copy), K a loop inside the CTA (no split-K: two calls are
    bitwise equal); fp32 on the CUDA cores (no TF32), bound by the FMA
    rate: 128 x 128 tiles of four warps, 16 x 8 outputs a thread, 16-deep
    k slabs through a 3-stage ``cp.async`` ring (x transposed on the way
    in, so both operands' fragments are float4 reads), groups of 16 row
    blocks walked row block fastest, each output one fmaf chain in k
    order.
    ``TILED_MATMUL`` is its launch record, bumped by ``matmul`` right after
    each launch; its plain version is ``row.plain_gemm``.
"""
from __future__ import annotations

import torch

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import cuda, row

TILED_MATMUL = cuda.Kernel("tiled_matmul",
                           "src/repro_torch/csrc/tiled_matmul.cuh",
                           "src/repro/kernels/matmul.py:38")
# element alignment the kernel's 16-byte loads need of K and N
_ALIGN = {torch.bfloat16: 8, torch.float32: 4}


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


def matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 512,
           bn: int = 512, bk: int = 512) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, fp32 accumulation: one
    launch of the tiled matmul for CUDA tensors, ``row.plain_gemm`` for CPU
    tensors.  ``bm, bn, bk`` are the reference's tiles: a shape they do not
    divide is refused, as the reference refuses it; the CUDA tiles are the
    card's own.  On the card x and w are both bf16 or both fp32, K and N
    multiples of 8 (bf16) or 4 (fp32); anything else raises."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"matmul: x is {M}x{K} but w is {K2}x{N}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"matmul: tiles ({bm}, {bn}, {bk}) do not divide "
                         f"({M}, {N}, {K})")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return row.plain_gemm(x, w, x.dtype)
    align = _ALIGN.get(x.dtype)
    if align is None:
        raise ValueError(f"matmul: the kernel takes bf16 or fp32, got "
                         f"{x.dtype}")
    if K % align or N % align:
        raise ValueError(f"matmul: the {x.dtype} kernel takes K and N "
                         f"multiples of {align}, got K={K} N={N}")
    cuda.check(x, "matmul x", (M, K), x.dtype)
    cuda.check(w, "matmul w", (K, N), x.dtype)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    cuda.matmul(x, w, out)
    TILED_MATMUL.launches += 1
    return out
