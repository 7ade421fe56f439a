"""Grouped expert FFN (MoE): E expert FFNs in one launch, the framework's own
instance of the paper's horizontal fusion.

CUDA source: ``csrc/moe_gmm_member.cuh``.  It replaces the TPU kernels
``src/repro/kernels/moe_gmm.py:54`` (moe_gmm_op, the fusible form the
decode step plans beside the router) and ``:34`` (moe_gmm, the same member
launched alone).  Bound on the card: bytes — at decode every expert's
weights stream once for C = 8 rows (2.52 GB at phi3.5-moe, 0.752 ms at
3.35 TB/s).  Design: a CTA per (expert, f-tile of ``f_tile(f)`` hidden
columns), both products on the tensor cores (``mma.sync``, weights on the
16-row side, tokens on the 8-column side), the weights through a ring of
``cp.async`` stages, each slice applied to all ``pass_rows(C)`` token rows
of a pass, so each weight byte streams once a launch at C <= 40.  Each CTA
writes (C, d) fp32 partials into a per-launch workspace, and the last CTA
of each (expert, pass, 256-column chunk) sums them in tile order (no float
atomics, so a fused launch is bitwise equal to the member alone).

Beside the kernel: ``MOE_GMM``, its launch record, and ``plain_moe_gmm``,
the plain PyTorch version of ``_gmm_kernel`` (``:21-31``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch
import torch.nn.functional as F

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.kernels import cuda

MOE_GMM = cuda.Kernel("moe_gmm", "src/repro_torch/csrc/moe_gmm_member.cuh",
                      "src/repro/kernels/moe_gmm.py:54, "
                      "src/repro/kernels/moe_gmm.py:34")
# activation ids of csrc/row_member.cuh act_apply
_ACT_IDS = {("silu", True): 0, ("gelu", True): 1, ("gelu", False): 2}


PASS_ROWS = 40      # token rows a pass holds
KERNEL_PASS_ROWS = 40   # the most the kernel is compiled for (moe_gmm_mma<1..5>)
FT_MAX = 640        # hidden columns a CTA: 160 CTAs at phi3.5-moe
CHUNK = 256         # output columns per combine ticket (csrc GMM_JC)


def pass_rows(C: int) -> int:
    """Token rows of a pass: C in ceil(C / PASS_ROWS) passes as even as
    multiples of 8 allow (each pass streams the CTA's weights once)."""
    per = -(-C // -(-C // PASS_ROWS))
    return -(-per // 8) * 8


def f_tile(f: int) -> int:
    """Hidden columns per CTA: the largest multiple of 32 dividing f, at
    most FT_MAX (the h tile of a pass, 40 x 648 bf16, then fits beside a
    3-stage ring in the member's 112 KB)."""
    for ft in range(min(f, FT_MAX) // 32 * 32, 0, -32):
        if f % ft == 0:
            return ft
    raise ValueError(f"moe_gmm member: d_ff_expert {f} is not a multiple "
                     "of 32")


def plain_moe_gmm(xe: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                  act: str = "silu", gated: bool = True) -> torch.Tensor:
    """xe (E,C,d); w_in (E,d,2f|f); w_out (E,f,d) -> (E,C,d) in xe's dtype:
    fp32 products, the activation in fp32, h rounded to xe's dtype before
    the second product (the reference's ``_gmm_kernel``)."""
    h = torch.bmm(xe.float(), w_in.float())
    if gated:
        g, u = torch.chunk(h, 2, dim=-1)
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h.to(xe.dtype).float(), w_out.float()).to(xe.dtype)


@dataclass(frozen=True)
class MoeGmmMember:
    E: int
    C: int
    d: int
    f: int
    act: str
    gated: bool
    kernel: ClassVar[cuda.Kernel] = MOE_GMM

    @property
    def ctas(self) -> int:
        return self.E * (self.f // f_tile(self.f))

    def pack(self, md, ins, outs):
        """Describe, check and bind one launch; returns the workspace
        (partials, zeroed tickets), alive until the launch is queued."""
        E, C, d, f = self.E, self.C, self.d, self.f
        ft, rows = f_tile(f), pass_rows(C)
        if rows % 8 or rows > KERNEL_PASS_ROWS:
            raise ValueError(f"moe_gmm member: passes of {rows} token rows; "
                             "the kernel takes multiples of 8 up to "
                             f"{KERNEL_PASS_ROWS}")
        if d % 8:
            raise ValueError(f"moe_gmm member: d={d} is not a multiple of 8")
        key = (self.act, self.gated)
        if key not in _ACT_IDS:
            raise ValueError(f"moe_gmm member: activation {key} has no "
                             "CUDA form")
        bf = torch.bfloat16
        fin = 2 * f if self.gated else f
        md.kind = cuda.MOE_GMM
        md.i[0], md.i[1], md.i[2], md.i[3] = E, C, d, f
        md.i[4], md.i[5], md.i[6] = ft, _ACT_IDS[key], rows
        xe, w_in, w_out = ins
        md.inp[0] = cuda.check(xe, "moe_gmm xe", (E, C, d), bf)
        md.inp[1] = cuda.check(w_in, "moe_gmm w_in", (E, d, fin), bf)
        md.inp[2] = cuda.check(w_out, "moe_gmm w_out", (E, f, d), bf)
        md.inp[3] = cuda.gmm_tensor_maps(w_in, w_out, E, d, f, fin)
        md.out[0] = cuda.check(outs[0], "moe_gmm ye", (E, C, d), bf)
        dev = outs[0].device
        ws = (torch.empty(E * (f // ft) * C * d, dtype=torch.float32,
                          device=dev),
              torch.zeros(E * -(-C // rows) * -(-d // CHUNK),
                          dtype=torch.int32, device=dev))
        md.out[1], md.out[2] = ws[0].data_ptr(), ws[1].data_ptr()
        return ws


def moe_gmm_op(E: int, C: int, d: int, f: int, dtype=torch.bfloat16,
               bc: int = 128, act: str = "silu",
               gated: bool = True) -> OpSpec:
    """xe (E,C,d), w_in (E,d,2f|f), w_out (E,f,d) -> ye (E,C,d).  The
    reference's planning metadata: ``bc`` clamped to C and rounded down to
    a divisor of C, a 1-D grid over (expert, row block), its blocks, costs,
    tag and names."""
    bc = min(bc, C)
    while C % bc:
        bc -= 1
    nc = C // bc
    fin = 2 * f if gated else f

    def plain(xe, w_in, w_out):
        return (plain_moe_gmm(xe, w_in, w_out, act=act, gated=gated),)

    isz = itemsize(dtype)
    return OpSpec(
        name=f"moe_gmm_E{E}_C{C}", grid=E * nc,
        member=MoeGmmMember(E, C, d, f, act, gated),
        plain=plain,
        inputs=(Operand((E, C, d), dtype, (1, bc, d),
                        lambda s: (s // nc, s % nc, 0)),
                Operand((E, d, fin), dtype, (1, d, fin),
                        lambda s: (s // nc, 0, 0)),
                Operand((E, f, d), dtype, (1, f, d),
                        lambda s: (s // nc, 0, 0))),
        outputs=(Operand((E, C, d), dtype, (1, bc, d),
                         lambda s: (s // nc, s % nc, 0)),),
        flops=2.0 * E * C * d * (fin + f),
        hbm_bytes=(2 * E * C * d + E * d * fin + E * f * d) * isz,
        tag="framework:moe_gmm",
        in_names=("xe", "w_in", "w_out"), out_names=("ye",))


def moe_gmm(xe: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, *,
            act: str = "silu", bc: int = 128) -> torch.Tensor:
    """xe (E,C,d); w_in (E,d,2f|f); w_out (E,f,d) -> (E,C,d): one launch of
    the member (the plain version for CPU tensors).  Gated iff w_in is
    twice w_out's hidden width, as the reference decides; refuses a C that
    min(bc, C) does not divide, as the reference does."""
    from repro_torch.core import hfuse
    E, C, d = xe.shape
    f = w_out.shape[1]
    if C % min(bc, C):
        raise ValueError(f"moe_gmm: C={C} is not a multiple of "
                         f"bc={min(bc, C)}")
    gated = w_in.shape[-1] == 2 * f
    op = moe_gmm_op(E, C, d, f, dtype=xe.dtype, bc=bc,
                    act=act if gated else "gelu", gated=gated)
    return hfuse.run_single(op)(xe, w_in, w_out)[0]
