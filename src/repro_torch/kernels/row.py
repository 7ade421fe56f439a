"""Row member family: RMSNorm, the row GEMM, the activation and the residual
add, each alone, and every chain of two of them, or of one of them and the
AdamW update, that ``core/stitch.py`` builds.

CUDA source: ``csrc/row_member.cuh``.  It replaces the TPU kernels
``src/repro/kernels/rmsnorm.py:38`` (rmsnorm_op) and ``:20`` (rmsnorm, the
same body launched alone), ``src/repro/kernels/matmul.py:64``
(matmul_1d_op), ``src/repro/kernels/elementwise.py:20`` (activation_op) and
``:69`` (residual_add_op), and the chain body of
``src/repro/core/stitch.py:177`` for every pair of them and for the dW
GEMM -> AdamW update.  Bound on the card: bytes — at decode batch the GEMM
streams its weight once and does 2*M flops per weight element.  The bf16
GEMM's CTA owns a ``GEMM_BN``-column weight tile of a row block of
``gemm_rows(M)`` rows and one K slice of ``RowMember.k_slice`` rows (at least
``GEMM_MIN_CTAS`` CTAs in all, so every SM streams), runs ``mma.sync`` on
the tensor cores over a ``cp.async`` ring, and the tile's last CTA sums the
slices in slice order.  The GEMM also has an fp32 form (x, w, out fp32,
``fmaf`` on the CUDA cores: the MoE router's ``matmul_1d_op(dtype=float32)``
and the fp32 chains): a CTA owns a ``GEMM_TN``-column tile and one K slice
of ``RowMember.k_slice`` rows (whole ``F32_KT``-row stages, the fewest
slices that reach ``GEMM_MIN_CTAS``), streams it once through a ``cp.async``
ring applied to every row of a pass (up to 128 rows), and the tile's last
CTA sums the slices in slice order.  Both forms keep their partials and
tickets in a workspace that persists across launches (``cuda.workspace``).
RMSNorm, the activation and the residual add take bf16 or fp32 rows.
RMSNorm reduces each row with one warp, in one order shared by the member
and every chain (``csrc/row_member.cuh``), ``norm_rows(M)`` rows a CTA.

``RowChain`` is the one descriptor of every chain: producer, consumer (a
``RowMember`` or ``kernels/adam.AdamwMember``) and the stitched operand's
slot.  Its ``pack`` picks the kernel path from the pair (see the source's
header): a row-wise pair runs in one CTA per segment with the intermediate
in shared memory; a row-wise producer fills the GEMM's x staging; the GEMM
hands its stored product to an activation, a residual add or the AdamW
update in its epilogue, and to an RMSNorm (or an fp32 activation) through a
per-launch workspace and a last-CTA pass.  Each chain is bitwise equal to
its two members run separately.

Beside the kernel: ``ROW``, its launch record, and the plain PyTorch
versions (``plain_rmsnorm``, ``plain_gemm``, ``plain_residual_add``, the
activations), which run for CPU tensors and are the reference on the
card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda

ROW = cuda.Kernel(
    "row_member", "src/repro_torch/csrc/row_member.cuh",
    "src/repro/kernels/rmsnorm.py:38, :20, src/repro/kernels/matmul.py:64, "
    "src/repro/kernels/elementwise.py:20, :69, src/repro/core/stitch.py:177")

GEMM_TN = 64          # weight columns per CTA of the fp32 GEMM
#                       (csrc/row_member.cuh); the bf16 GEMM takes N % 64 == 0
GEMM_BN = 128         # weight columns per CTA of the bf16 GEMM (a gated tile:
#                       64 gate columns and their 64 up columns)
GEMM_KT = 64          # K rows of a bf16 GEMM ring stage; slices are whole
#                       stages
GEMM_MIN_CTAS = 132   # CTAs a GEMM's K split reaches where its tiles
#                       alone do not: one an SM on the H100 (one streams as
#                       fast as two there, and each slice more costs a
#                       partial and the combine)
F32_KT = 64           # K rows of an fp32 GEMM ring stage (16 KB of a 64-column
#                       tile); its slices are whole stages
ACT_COLS = 2048       # output columns per CTA of the standalone activation
RESADD_BYTES = 16384  # bytes of each operand per CTA of the residual add
#                       (csrc/row_member.cuh: HF_THREADS x RESADD_VECS x 16)
NORM_ROWS = 8         # rows a CTA of RMSNorm past NORM_PACK_M rows, one a
#                       warp (8192 rows: 1024 CTAs, about 4 waves at 2 CTAs
#                       an SM)
NORM_PACK_M = 256     # from this many rows RMSNorm packs NORM_ROWS rows a
#                       CTA; below it (decode batches) one row a CTA, so
#                       the CTA count, which the bundle grid and the
#                       interpret proxy read, stays M there.  The reduction
#                       order is per row (one warp), so results do not
#                       depend on it


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


def norm_rows(M: int) -> int:
    """Rows a CTA of the RMSNorm member takes, one a warp
    (csrc/row_member.cuh row_norm): 1 below NORM_PACK_M rows, else
    NORM_ROWS."""
    return 1 if M < NORM_PACK_M else NORM_ROWS


def gemm_rows(M: int) -> int:
    """Rows of a bf16 GEMM CTA's row block (csrc/row_member.cuh gemm_nt):
    8, 16, 32 or 64, each weight stage applied to all of them."""
    return 8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64


# ---------------------------------------------------------------------------
# Member descriptors
# ---------------------------------------------------------------------------
# csrc/row_member.cuh: sub-kinds, the AdamW consumer stage, GEMM epilogues
_SUB = {"rmsnorm": 0, "gemm": 1, "act": 2, "resadd": 3}
_CHAIN, _ADAMW = 4, 5
_EPI_ROWS, _EPI_ADAMW = 1, 2
_N_INPUTS = {"rmsnorm": 2, "gemm": 2, "act": 1, "resadd": 2}
# largest shared-memory segment of a row-wise chain (the card's 227 KB)
_SEGMENT_BYTES = 224 * 1024


@dataclass(frozen=True)
class RowMember:
    """One row-family member: ``sub`` is "rmsnorm" (x (M,K) -> (M,K)),
    "gemm" (x (M,K) @ w (K,N)), "act" (h (M,K) -> (M,N)) or "resadd"
    (h + res, both (M,K)).  The dims are the whole op's, so the member
    computes the same function whatever block shape planned it."""
    sub: str
    M: int
    K: int
    N: int
    act: Optional[str] = None   # act: the activation's name
    eps: float = 1e-6
    fp32: bool = False          # fp32 operands (else bf16)
    kernel: ClassVar[cuda.Kernel] = ROW

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32 if self.fp32 else torch.bfloat16

    @property
    def out_cols(self) -> int:
        if self.sub in ("rmsnorm", "resadd"):
            return self.K
        return self.N

    @property
    def col_tiles(self) -> int:
        """Weight column tiles of the GEMM: GEMM_TN columns (fp32) or
        GEMM_BN (bf16), the last one part."""
        return math.ceil(self.N / (GEMM_TN if self.fp32 else GEMM_BN))

    @property
    def row_blocks(self) -> int:
        """Row blocks of the GEMM: the bf16 GEMM's of ``gemm_rows(M)`` rows;
        the fp32 GEMM keeps all rows in each CTA."""
        return 1 if self.fp32 else math.ceil(self.M / gemm_rows(self.M))

    @property
    def k_slice(self) -> int:
        """K rows per GEMM CTA: whole ring stages (GEMM_KT rows bf16,
        F32_KT fp32), the fewest slices that bring column tiles x row
        blocks x slices to GEMM_MIN_CTAS (K whole where the tiles alone
        reach it, one stage a slice at most).  It depends on (M, K, N)
        alone, so a chain through the GEMM sums in the same order as the
        GEMM launched alone."""
        kt = F32_KT if self.fp32 else GEMM_KT
        base = self.col_tiles * self.row_blocks
        want = math.ceil(GEMM_MIN_CTAS / base)
        ksl = math.ceil(self.K / want / kt) * kt
        while ksl > kt and base * math.ceil(self.K / ksl) < GEMM_MIN_CTAS:
            ksl -= kt
        return ksl

    @property
    def k_slices(self) -> int:
        """CTAs along K."""
        return math.ceil(self.K / self.k_slice)

    @property
    def ctas(self) -> int:
        if self.sub == "rmsnorm":
            return math.ceil(self.M / norm_rows(self.M))
        if self.sub == "gemm":
            return self.col_tiles * self.row_blocks * self.k_slices
        if self.sub == "resadd":
            return math.ceil(self.M * self.K * (4 if self.fp32 else 2)
                             / RESADD_BYTES)
        return self.M * math.ceil(self.N / ACT_COLS)

    def pack(self, md, ins, outs):
        """Describe, check and bind one launch; returns the GEMM's
        workspace (alive until the launch is queued), else None."""
        dt, M, K, N = self.dtype, self.M, self.K, self.N
        if self.sub == "gemm":
            _gemm_fields(md, self)
            md.inp[0] = cuda.check(ins[0], "gemm x", (M, K), dt)
            md.inp[2] = cuda.check(ins[1], "gemm w", (K, N), dt)
            md.out[0] = cuda.check(outs[0], "gemm out", (M, N), dt)
            return _workspace(md, self, outs[0].device, rows=False)
        md.kind = cuda.ROW
        md.i[0] = _SUB[self.sub]
        md.i[1], md.i[2], md.i[3] = M, K, N
        md.i[5] = _act_id(self)
        md.i[6] = int(self.fp32)
        md.f[0] = self.eps
        if self.sub == "rmsnorm":
            md.i[4] = norm_rows(M)
            md.inp[0] = cuda.check(ins[0], "rmsnorm x", (M, K), dt)
            md.inp[1] = cuda.check(ins[1], "rmsnorm scale", (1, K),
                                   torch.float32)
        else:
            md.inp[0] = cuda.check(ins[0], f"{self.sub} h", (M, K), dt)
            if self.sub == "resadd":
                md.inp[1] = cuda.check(ins[1], "resadd res", (M, K), dt)
        md.out[0] = cuda.check(outs[0], f"{self.sub} out",
                               (M, self.out_cols), dt)


def _gemm_fields(md, g: RowMember) -> None:
    """The GEMM's own fields (i[0..7]) and its shape limits."""
    md.kind = cuda.ROW
    md.i[0] = _SUB["gemm"]
    md.i[1], md.i[2], md.i[3] = g.M, g.K, g.N
    md.i[5] = -1
    md.i[6] = int(g.fp32)
    if g.fp32 and g.N % 4:
        raise ValueError(f"the fp32 row GEMM takes N % 4 == 0, got N={g.N}")
    if not g.fp32 and (g.N % GEMM_TN or g.K % 8):
        raise ValueError(f"row GEMM takes N % {GEMM_TN} == 0 and "
                         f"K % 8 == 0, got K={g.K} N={g.N}")
    md.i[4], md.i[7] = g.k_slice, g.k_slices


def gemm_workspace_sizes(g: RowMember, rows: bool) -> tuple[int, int, int]:
    """Elements of the GEMM's workspace: the K slices' fp32 partials (bf16:
    one (gemm_rows, tile columns) tile per slice, row block and column
    tile; fp32: one (M, N) product per slice; none without a split), the
    tickets (one per row block and column tile, one more for the EPI_ROWS
    pass) and, with ``rows`` (the EPI_ROWS epilogue), the product a row
    consumer reads, in the GEMM's dtype; all 0 when the launch needs
    none."""
    tiles = g.col_tiles * g.row_blocks
    per_slice = g.M * g.N if g.fp32 else tiles * gemm_rows(g.M) * GEMM_BN
    parts = g.k_slices * per_slice if g.k_slices > 1 else 0
    if not parts and not rows:
        return 0, 0, 0
    return parts, tiles + 1, g.M * g.N if rows else 0


def _workspace(md, g: RowMember, dev, rows: bool):
    """The GEMM's workspace (out[1..3]); returns it (alive until the launch
    is queued), or None when the launch needs none.  It persists per
    device, stream and shape (``cuda.workspace``): its tickets are zeroed
    once and reset by the CTA that draws the last, so a launch allocates
    nothing."""
    parts, tickets, prod = gemm_workspace_sizes(g, rows)
    if not tickets:
        return None
    held = cuda.workspace(dev, ("row_gemm_f32" if g.fp32 else "row_gemm",
                               g.M, g.K, g.N, rows),
                          ((parts, torch.float32), (tickets, torch.int32),
                           (prod, g.dtype)))
    md.out[1], md.out[2], md.out[3] = (t.data_ptr() for t in held)
    return held


def _act_id(m: RowMember) -> int:
    return -1 if m.act is None else ACTIVATIONS[m.act][1]


def _producer_stage(md, p: RowMember, pins) -> None:
    """The row-wise producer stage: i[9..11], in[0..1], f[6]."""
    dt = p.dtype
    md.i[9], md.i[10], md.i[11] = _SUB[p.sub] + 1, _act_id(p), p.K
    md.inp[0] = cuda.check(pins[0], f"{p.sub} input", (p.M, p.K), dt)
    if p.sub == "rmsnorm":
        md.inp[1] = cuda.check(pins[1], "rmsnorm scale", (1, p.K),
                               torch.float32)
        md.f[6] = p.eps
    elif p.sub == "resadd":
        md.inp[1] = cuda.check(pins[1], "resadd res", (p.M, p.K), dt)


def _consumer_stage(md, c, cins, outs, dt) -> None:
    """The consumer stage: i[13..15], in[3..5], f[0..6], out[0]."""
    from repro_torch.kernels.adam import LANES, AdamwMember

    if isinstance(c, AdamwMember):
        c.describe(md)                 # f[0..5], AdamW's constants
        md.i[13], md.i[14], md.i[15] = _ADAMW, -1, LANES
        shape = (c.R, LANES)
        md.inp[3] = cuda.check(cins[0], "adamw scalars", (1, LANES),
                               torch.float32)
        md.out[0] = cuda.check(outs[0], "adamw p", shape, dt)
        md.inp[4] = cuda.check(outs[1], "adamw m", shape, torch.float32)
        md.inp[5] = cuda.check(outs[2], "adamw v", shape, torch.float32)
        for t, o in zip(cins[1:], outs):
            if t.data_ptr() != o.data_ptr():
                raise ValueError("the AdamW stage updates p, m, v in place")
        return
    md.i[13], md.i[14], md.i[15] = _SUB[c.sub], _act_id(c), c.K
    if c.sub == "rmsnorm":
        md.inp[3] = cuda.check(cins[0], "rmsnorm scale", (1, c.K),
                               torch.float32)
        md.f[6] = c.eps
    elif c.sub == "resadd":
        md.inp[3] = cuda.check(cins[0], "resadd operand", (c.M, c.K), dt)
    md.out[0] = cuda.check(outs[0], f"{c.sub} out", (c.M, c.out_cols), dt)


@dataclass(frozen=True)
class RowChain:
    """The one member of a stitched producer -> consumer chain: the
    producer (a ``RowMember``), the consumer (a ``RowMember`` or
    ``kernels/adam.AdamwMember``) and ``slot``, the stitched operand's index
    among the consumer's inputs.  The launch's operands are the producer's
    inputs, then the consumer's minus the stitched one; its outputs are
    the consumer's (AdamW: p, m, v in place)."""
    producer: RowMember
    consumer: object
    slot: int
    kernel: ClassVar[cuda.Kernel] = ROW

    @property
    def _gemm_consumer(self) -> bool:
        c = self.consumer
        return isinstance(c, RowMember) and c.sub == "gemm"

    @property
    def segment(self) -> int:
        """Elements of the intermediate per CTA of a row-wise pair: one
        consumer row (its norm or gated activation needs it whole), or one
        producer row when the consumer is AdamW's (R, 128) update."""
        c = self.consumer
        return self.producer.out_cols if not isinstance(c, RowMember) \
            else c.K

    @property
    def ctas(self) -> int:
        p = self.producer
        if p.sub == "gemm":
            return p.ctas
        if self._gemm_consumer:
            return self.consumer.ctas
        return p.M * p.out_cols // self.segment

    def pack(self, md, ins, outs):
        p, c = self.producer, self.consumer
        dt = p.dtype
        n_pi = _N_INPUTS[p.sub]
        pins, cins = ins[:n_pi], ins[n_pi:]
        dev = outs[0].device
        if p.sub == "gemm":
            _gemm_fields(md, p)
            md.inp[0] = cuda.check(pins[0], "gemm x", (p.M, p.K), dt)
            md.inp[2] = cuda.check(pins[1], "gemm w", (p.K, p.N), dt)
            rows = False
            if isinstance(c, RowMember) and c.sub == "resadd":
                # the residual epilogue (flat: any row-stream reshape)
                md.i[8] = 1
                md.inp[3] = cuda.check(cins[0], "resadd operand",
                                       (c.M, c.K), dt)
                md.out[0] = cuda.check(outs[0], "resadd out", (c.M, c.K), dt)
            elif (isinstance(c, RowMember) and c.sub == "act" and not p.fp32
                  and c.K == p.N):
                md.i[5] = _act_id(c)       # the activation epilogue
                md.out[0] = cuda.check(outs[0], "act out", (c.M, c.N), dt)
            else:
                rows = isinstance(c, RowMember)
                md.i[12] = _EPI_ROWS if rows else _EPI_ADAMW
                _consumer_stage(md, c, cins, outs, dt)
            return _workspace(md, p, dev, rows)
        if self._gemm_consumer:
            _gemm_fields(md, c)
            md.inp[2] = cuda.check(cins[0], "gemm w", (c.K, c.N), dt)
            md.out[0] = cuda.check(outs[0], "gemm out", (c.M, c.N), dt)
            _producer_stage(md, p, pins)
            return _workspace(md, c, dev, rows=False)
        seg = self.segment
        if seg * (4 if p.fp32 else 2) > _SEGMENT_BYTES:
            raise ValueError(f"row chain {p.sub}->{_name(c)}: a segment of "
                             f"{seg} elements exceeds shared memory")
        md.kind = cuda.ROW
        md.i[0], md.i[1], md.i[6] = _CHAIN, seg, int(p.fp32)
        _producer_stage(md, p, pins)
        _consumer_stage(md, c, cins, outs, dt)


def _name(m) -> str:
    return m.sub if isinstance(m, RowMember) else "adamw"


def chain_reason(producer, consumer, slot: int) -> Optional[str]:
    """None iff the row kernel computes ``producer`` -> ``consumer``
    (stitched into the consumer's input ``slot``) as one member; otherwise
    why not.  ``core/stitch.can_stitch`` has checked the reference's
    contract (grids, dtypes, element counts, row streams, names) first."""
    from repro_torch.kernels.adam import LANES, AdamwMember

    p, c = producer, consumer
    if not isinstance(p, RowMember):
        return "no fused kernel: a chain's producer is a row-family member"
    if isinstance(c, AdamwMember):
        if slot != 2:
            return "only the AdamW update's gradient takes a producer"
        if p.M * p.out_cols != c.R * LANES:
            return (f"{p.sub} {p.M}x{p.out_cols} does not fill the update's "
                    f"{c.R}x{LANES} gradient")
        return None
    if not isinstance(c, RowMember):
        return ("no fused kernel: a chain's consumer is a row-family member "
                "or the AdamW update")
    if c.sub == "gemm" and slot != 0:
        return ("the row GEMM streams its weight through every CTA: only x "
                "takes a producer")
    if c.sub == "rmsnorm" and slot != 0:
        return "every row of the norm reads its scale whole: only x chains"
    if p.sub == "gemm" and c.sub == "gemm":
        return "no fused kernel for gemm->gemm"
    if p.M * p.out_cols != c.M * c.K:
        return (f"{p.sub} {p.M}x{p.out_cols} does not feed {c.sub} "
                f"{c.M}x{c.K}")
    return None


def chain(producer: RowMember, consumer, slot: int) -> RowChain:
    """The one member that computes producer then consumer."""
    reason = chain_reason(producer, consumer, slot)
    if reason is not None:
        raise ValueError(reason)
    return RowChain(producer, consumer, slot)
