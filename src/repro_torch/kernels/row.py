"""Row member family: RMSNorm, the row GEMM (with an optional RMSNorm
prologue and an optional activation or residual-add epilogue), the
activation alone and the residual add alone.

CUDA source: ``csrc/row_member.cuh``.  It replaces the TPU kernels
``src/repro/kernels/rmsnorm.py:38`` (rmsnorm_op) and ``:20`` (rmsnorm, the
same body launched alone), ``src/repro/kernels/matmul.py:64``
(matmul_1d_op), ``src/repro/kernels/elementwise.py:20`` (activation_op) and
``:69`` (residual_add_op), and the chain body of
``src/repro/core/stitch.py:177`` for the pairs rmsnorm->matmul,
matmul->activation and matmul->residual_add.  Bound on the card: bytes —
at decode batch the GEMM streams its weight once and does 2*M flops per
weight element; a CTA owns a 64-column weight tile for all rows, streams it
in 16-byte vectors with x in shared memory, and the chains keep the
intermediate out of device memory (see the source's header for the bitwise
contract).  The GEMM also has an fp32 form
(x, w, out fp32, no prologue or activation, partial column tiles masked, K
split over CTAs with a fixed-order last-CTA combine, the residual added in
that combine): the MoE router's ``matmul_1d_op(dtype=float32)``.  RMSNorm
and the residual add take bf16 or fp32 rows; the activation bf16 only.

Beside the kernel: ``ROW``, its launch record, and the plain PyTorch
versions (``plain_rmsnorm``, ``plain_gemm``, ``plain_residual_add``, the
activations), which run for CPU tensors and are the reference on the
card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import ClassVar, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda

ROW = cuda.Kernel(
    "row_member", "src/repro_torch/csrc/row_member.cuh",
    "src/repro/kernels/rmsnorm.py:38, :20, src/repro/kernels/matmul.py:64, "
    "src/repro/kernels/elementwise.py:20, :69, src/repro/core/stitch.py:177")

GEMM_TN = 64          # weight columns per CTA (csrc/row_member.cuh)
F32_K_SLICE = 64      # K rows per CTA of the fp32 GEMM
ACT_COLS = 2048       # output columns per CTA of the standalone activation
RESADD_BYTES = 16384  # bytes of each operand per CTA of the residual add
#                       (csrc/row_member.cuh: HF_THREADS x RESADD_VECS x 16)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def plain_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale) in fp32, cast to x's
    dtype; ``scale`` is fp32, shape (1, d) or (d,)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def plain_gemm(x: torch.Tensor, w: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation, cast to ``dtype``."""
    return torch.matmul(x.float(), w.float()).to(dtype)


def plain_residual_add(h: torch.Tensor, res: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """h + res in fp32, cast to ``dtype``."""
    return (h.float() + res.float()).to(dtype)


def silu_gate(h: torch.Tensor) -> torch.Tensor:
    """SwiGLU: h = [a | b] -> silu(a) * b, fp32."""
    f = h.shape[-1] // 2
    a = h[..., :f].float()
    return (a * torch.sigmoid(a)) * h[..., f:].float()


def gelu_gate(h: torch.Tensor) -> torch.Tensor:
    """GeGLU with the tanh-approximate GELU (jax.nn.gelu's default)."""
    f = h.shape[-1] // 2
    return (F.gelu(h[..., :f].float(), approximate="tanh")
            * h[..., f:].float())


def gelu_plain(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h.float(), approximate="tanh")


def relu2(h: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(h.float()))


# activation name -> (plain fn, id in csrc/row_member.cuh, gated)
ACTIVATIONS = {"silu_gate": (silu_gate, 0, True),
               "gelu_gate": (gelu_gate, 1, True),
               "gelu_plain": (gelu_plain, 2, False),
               "relu2": (relu2, 3, False)}


def act_name(fn) -> str:
    """The kernel's name for an activation function; raises for a function
    the CUDA member does not implement."""
    for name, (f, _id, _g) in ACTIVATIONS.items():
        if f is fn:
            return name
    raise ValueError(f"activation {fn!r} has no CUDA member "
                     f"(supported: {sorted(ACTIVATIONS)})")


# ---------------------------------------------------------------------------
# Member descriptor
# ---------------------------------------------------------------------------
_SUB = {"rmsnorm": 0, "gemm": 1, "act": 2, "resadd": 3}


@dataclass(frozen=True)
class RowMember:
    """One row-family member: ``sub`` is "rmsnorm" (x (M,K) -> (M,K)),
    "gemm" (x (M,K) @ w (K,N), optionally normalised first, and activated
    or added to a residual (M,N) after), "act" (h (M,K) -> (M,N)) or
    "resadd" (h + res, both (M,K)).  The dims are the whole op's, so the
    member computes the same function whatever block shape planned it."""
    sub: str
    M: int
    K: int
    N: int
    prologue: bool = False
    act: Optional[str] = None
    residual: bool = False      # gemm: the residual-add epilogue
    eps: float = 1e-6
    fp32: bool = False          # rmsnorm, gemm, resadd: fp32 operands
    kernel: ClassVar[cuda.Kernel] = ROW

    @property
    def out_cols(self) -> int:
        if self.sub in ("rmsnorm", "resadd"):
            return self.K
        if self.act is not None and ACTIVATIONS[self.act][2]:
            return self.N // 2
        return self.N

    @property
    def k_slices(self) -> int:
        """CTAs along K: the fp32 GEMM splits K in slices of F32_K_SLICE."""
        return math.ceil(self.K / F32_K_SLICE) if self.fp32 else 1

    @property
    def ctas(self) -> int:
        if self.sub == "rmsnorm":
            return self.M
        if self.sub == "gemm":
            return math.ceil(self.N / GEMM_TN) * self.k_slices
        if self.sub == "resadd":
            return math.ceil(self.M * self.K * (4 if self.fp32 else 2)
                             / RESADD_BYTES)
        return self.M * math.ceil(self.N / ACT_COLS)

    def pack(self, md, ins, outs):
        """Describe, check and bind one launch; returns the fp32 GEMM's
        workspace (alive until the launch is queued), else None."""
        bf, f32 = torch.bfloat16, torch.float32
        dt = f32 if self.fp32 else bf
        md.kind = cuda.ROW
        md.i[0] = _SUB[self.sub]
        md.i[1], md.i[2], md.i[3] = self.M, self.K, self.N
        md.i[4] = int(self.prologue)
        md.i[5] = -1 if self.act is None else ACTIVATIONS[self.act][1]
        md.i[6] = int(self.fp32)
        md.i[8] = int(self.residual)
        md.f[0] = self.eps
        M, K, N = self.M, self.K, self.N
        if self.sub == "rmsnorm":
            md.inp[0] = cuda.check(ins[0], "rmsnorm x", (M, K), dt)
            md.inp[1] = cuda.check(ins[1], "rmsnorm scale", (1, K), f32)
            md.out[0] = cuda.check(outs[0], "rmsnorm out", (M, K), dt)
            return
        if self.sub == "resadd":
            md.inp[0] = cuda.check(ins[0], "resadd h", (M, K), dt)
            md.inp[1] = cuda.check(ins[1], "resadd res", (M, K), dt)
            md.out[0] = cuda.check(outs[0], "resadd out", (M, K), dt)
            return
        if self.sub == "act":
            md.inp[0] = cuda.check(ins[0], "act h", (M, K), bf)
            md.out[0] = cuda.check(outs[0], "act out", (M, N), bf)
            return
        if self.residual:
            md.inp[3] = cuda.check(ins[-1], "gemm res", (M, N), dt)
        if self.fp32:
            if self.prologue or self.act is not None or N % 4:
                raise ValueError("the fp32 row GEMM takes no prologue or "
                                 f"activation and N % 4 == 0, got N={N}")
            md.i[7] = self.k_slices
            md.inp[0] = cuda.check(ins[0], "gemm x", (M, K), f32)
            md.inp[2] = cuda.check(ins[1], "gemm w", (K, N), f32)
            md.out[0] = cuda.check(outs[0], "gemm out", (M, N), f32)
            # per-launch workspace: the K slices' partials, zeroed tickets
            dev = outs[0].device
            ws = (torch.empty(self.k_slices * M * N, dtype=f32, device=dev),
                  torch.zeros(math.ceil(N / GEMM_TN), dtype=torch.int32,
                              device=dev))
            md.out[1], md.out[2] = ws[0].data_ptr(), ws[1].data_ptr()
            return ws
        if N % GEMM_TN or K % 8:
            raise ValueError(f"row GEMM takes N % {GEMM_TN} == 0 and "
                             f"K % 8 == 0, got K={K} N={N}")
        x, *rest = ins
        md.inp[0] = cuda.check(x, "gemm x", (M, K), bf)
        if self.prologue:
            md.inp[1] = cuda.check(rest.pop(0), "gemm norm scale", (1, K),
                                   torch.float32)
        md.inp[2] = cuda.check(rest[0], "gemm w", (K, N), bf)
        md.out[0] = cuda.check(outs[0], "gemm out", (M, self.out_cols), bf)


def chain_reason(producer, consumer) -> Optional[str]:
    """None iff the row kernel implements ``producer`` -> ``consumer`` as
    one member (rmsnorm -> gemm as a prologue, gemm -> act and gemm ->
    resadd as epilogues); otherwise why not."""
    p, c = producer, consumer
    if not (isinstance(p, RowMember) and isinstance(c, RowMember)):
        return "no fused kernel: only row-family members chain"
    if p.sub == "rmsnorm" and c.sub == "gemm" and not c.prologue:
        if (p.M, p.K) != (c.M, c.K):
            return f"rmsnorm {p.M}x{p.K} does not feed gemm {c.M}x{c.K}"
        return None
    if (p.sub == "gemm" and c.sub in ("act", "resadd") and p.act is None
            and not p.residual):
        if (p.M, p.N) != (c.M, c.K):
            return f"gemm {p.M}x{p.N} does not feed {c.sub} {c.M}x{c.K}"
        return None
    return f"no fused kernel for {p.sub}->{c.sub}"


def chain(producer: RowMember, consumer: RowMember) -> RowMember:
    """The one member that computes producer then consumer."""
    reason = chain_reason(producer, consumer)
    if reason is not None:
        raise ValueError(reason)
    if producer.sub == "rmsnorm":
        return replace(consumer, prologue=True, eps=producer.eps)
    if consumer.sub == "resadd":
        return replace(producer, residual=True)
    return replace(producer, act=consumer.act)
