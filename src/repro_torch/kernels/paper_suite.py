"""The paper's nine benchmark kernels (Fig. 8) as fusible OpSpecs.

The reference's analogues (``src/repro/kernels/paper_suite.py``) keep the
paper's resource profiles: five memory-bound deep-learning atoms (maxpool,
bnstats, upsample, im2col, hist), one memory-hard stream (ethash_like) and
three compute-bound hash analogues (sha/blake/blake2b_like, iterated mixing
matmuls).  Each factory here has the reference's signature and defaults and
returns ``(OpSpec, make_inputs, plain_fn)``; the planning metadata (name,
``grid``, blocks, index maps, ``flops``, ``hbm_bytes``, ``tag``) is exactly
the reference's, so the planner makes the reference's decisions on these
ops.  ``make_inputs(generator, device)`` draws from an explicit
``torch.Generator``; ``inputs_from_numpy`` takes the tests' numpy arrays.

CUDA source: ``csrc/paper_member.cuh``, seven members of the bundle
launcher (sha, blake and blake2b are one body with a ``rounds``
parameter).  They replace the TPU kernels ``src/repro/kernels/
paper_suite.py:49`` (maxpool), ``:67`` (upsample), ``:86`` (bnstats),
``:108`` (im2col), ``:159`` (hist), ``:129`` (ethash_like) and ``:186``
(hash_like).  Bounds on the card: the five DL atoms by bytes, the hash
kernels by fp32 operations, ethash_like by its three TF32 products on the
tensor cores (see the source's header for the CTA geometry and the carries).
The carries' partials and tickets live in workspaces that persist across
launches (``cuda.workspace``); each kernel leaves its tickets (and hist its
counts) at zero, so a launch allocates nothing.

Beside the kernels: one launch record per body and the plain PyTorch
versions (``maxpool`` ... ``hash_like``, the port of
``src/repro/kernels/ref.py:16-57``, in the reference's operation order),
which run for CPU tensors and are the reference on the card.  Only the
members of fp32 and, for maxpool, upsample, im2col, bnstats and hist, bf16
have a kernel; the others raise on bf16 when launched.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.op_spec import Operand, OpSpec, itemsize
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda

LANES = 128
CTAS_PER_STEP = 16          # CTAs per TPU grid step of a streaming member
BN_CTAS_PER_STEP = 8        # bnstats: CTAs per grid step (one wave)
BN_GROUP = 16               # bnstats: CTAs a first-level combine sums
HIST_CTAS_PER_STEP = 4      # hist: CTAs per grid step (one wave)
WARPS = 8                   # warps of a CTA (csrc/common.cuh HF_WARPS)
# hist keeps a copy of the bins per warp in shared memory: at most 96 KB a
# CTA (ethash_like's), so a paper launch still fits two CTAs an SM
HIST_MAX_BINS = 96 * 1024 // (WARPS * 4)
TILE_R = 32                 # rows of a matmul tile (csrc/paper_member.cuh)
THREADS = 256               # threads of a CTA (csrc/common.cuh HF_THREADS)

_SRC = "src/repro_torch/csrc/paper_member.cuh"
_REF = "src/repro/kernels/paper_suite.py"
KERNELS = {
    body: cuda.Kernel(body, _SRC, f"{_REF}:{line}")
    for body, line in (("maxpool", 49), ("upsample", 67), ("bnstats", 86),
                       ("im2col", 108), ("hist", 159), ("ethash_like", 129),
                       ("hash_like", 186))}
_KIND = {"maxpool": cuda.MAXPOOL, "upsample": cuda.UPSAMPLE,
         "bnstats": cuda.BNSTATS, "im2col": cuda.IM2COL, "hist": cuda.HIST,
         "ethash_like": cuda.ETHASH, "hash_like": cuda.HASH}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_BF16_BODIES = ("maxpool", "upsample", "im2col", "bnstats", "hist")

# Kernel vs plain version, |got - want| <= tol * (1 + |want|) (the
# reference's assert_allclose with rtol = atol = tol).  0: bitwise (data
# movement, an exact max, integer counts).  bnstats 1e-3 and ethash_like 1e-4
# are the reference's own (tests/test_kernels_paper_suite.py:39, :62): fp32
# sums of the same terms in another order.  hash_like 1e-5: fp32 against an
# fp64 computation at the defaults drifts by at most 6.1e-7 over 24 rounds
# (|s| <= 0.61; tanh keeps the state bounded, so errors do not compound), so
# two fp32 summation orders differ by about 1.2e-6.
TOLERANCE = {"maxpool": 0.0, "upsample": 0.0, "im2col": 0.0, "hist": 0.0,
             "bnstats": 1e-3, "ethash_like": 1e-4, "hash_like": 1e-5}


def max_error(got: torch.Tensor, want: torch.Tensor, body: str) -> float:
    """max |got - want|, raising if it exceeds the body's tolerance (any
    difference at all for the bitwise bodies)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{body}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    diff = (got.float() - want.float()).abs()
    tol = TOLERANCE[body]
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{body}: non-finite output")
    if tol == 0.0 and not torch.equal(got, want):
        raise AssertionError(f"{body}: not bitwise equal (max|diff| "
                             f"{diff.max().item():.3g})")
    if bool((diff > tol * (1.0 + want.float().abs())).any()):
        raise AssertionError(f"{body}: max|diff| {diff.max().item():.3g} "
                             f"over the tolerance {tol}")
    return diff.max().item() if diff.numel() else 0.0


def _bytes(*shapes_dtypes) -> int:
    return sum(math.prod(shape) * itemsize(dt) for shape, dt in shapes_dtypes)


def _per_step(bm: int, want: int, multiple: int = 1) -> int:
    """CTAs per grid step: the largest d <= want that splits a ``bm``-row
    block into whole pieces of a multiple of ``multiple`` rows."""
    for d in range(max(1, min(want, bm)), 0, -1):
        if bm % d == 0 and (bm // d) % multiple == 0:
            return d
    raise ValueError(f"block of {bm} rows cannot be split")


# ---------------------------------------------------------------------------
# Plain versions (the reference's ref.py, in its operation order)
# ---------------------------------------------------------------------------
def maxpool(x: torch.Tensor) -> torch.Tensor:
    """The max of each row pair as the reference computes it: a NaN in
    either row propagates, and +0 wins over -0 in either order
    (``torch.amax`` keeps -0 for some orders and widths)."""
    R, C = x.shape
    a, b = x[0::2], x[1::2]
    return torch.where(a.isnan() | (a > b) | ((a == b) & b.signbit()), a, b)


def upsample(x: torch.Tensor) -> torch.Tensor:
    R, C = x.shape
    return x[:, None, :].expand(R, 2, C).reshape(2 * R, C)


def bnstats(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.stack([xf.sum(0), (xf * xf).sum(0)])


def im2col(x: torch.Tensor, K: int = 4) -> torch.Tensor:
    return torch.cat([torch.cat([x[:, k:], x[:, :k]], dim=1)
                      for k in range(K)], dim=1)


def hist(x: torch.Tensor, bins: int = LANES) -> torch.Tensor:
    """Counts of trunc(clip((x + 4) * bins/8, 0, bins-1)), binned in fp32;
    a NaN counts in bin 0, as the reference's cast of it to int32 gives."""
    b = torch.clip((x.float() + 4.0) * (bins / 8.0), 0, bins - 1)
    b = torch.nan_to_num(b, nan=0.0)
    counts = torch.bincount(b.to(torch.int32).reshape(-1), minlength=bins)
    return counts.to(torch.float32).reshape(1, bins)


def ethash_like(dag: torch.Tensor, x: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """sum_s tanh((x + dag_s) @ w) over the DAG's bm-row blocks: the add in
    the input dtype, then fp32; the blocks summed in order."""
    bm, C = x.shape
    mix = (dag.reshape(-1, bm, C) + x).float()
    t = torch.tanh(mix @ w.float())
    out = torch.zeros((bm, C), dtype=torch.float32, device=x.device)
    for s in range(t.shape[0]):
        out = out + t[s]
    return out


def hash_like(x: torch.Tensor, w: torch.Tensor, rounds: int = 16
              ) -> torch.Tensor:
    s = x.float()
    wf = w.float()
    for _ in range(rounds):
        s = torch.tanh(s @ wf)
    return s.to(x.dtype)


# ---------------------------------------------------------------------------
# Member descriptor
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PaperMember:
    """One paper body at the op's whole shape: ``R`` input rows (the DAG's
    for ethash_like) of ``C`` columns, ``rows`` rows per CTA (all C columns
    of them for bnstats, the 32-row tile for the matmul bodies) and
    ``param`` (im2col K, hist bins, hash rounds, ethash seed rows).
    ``ctas`` is the card's launch geometry, separate from the op's TPU
    ``grid``."""
    body: str
    R: int
    C: int
    dtype: torch.dtype
    rows: int
    param: int = 0
    runs: int = 1               # ethash_like: DAG runs per output slice

    @property
    def kernel(self) -> cuda.Kernel:
        return KERNELS[self.body]

    @property
    def ctas(self) -> int:
        if self.body == "ethash_like":
            return self.param // TILE_R * self.runs
        return self.R // self.rows

    @property
    def ops(self) -> float:
        """Operations the card's kernel does (for its bound): one max per
        output element, none to move data, add, multiply and add per
        bnstats element, one bin computation and one shared-memory atomic
        per hist element, the reference's count for the matmul bodies."""
        R, C, p = self.R, self.C, self.param
        return {"maxpool": R // 2 * C, "upsample": 0.0, "im2col": 0.0,
                "bnstats": 3.0 * R * C, "hist": 2.0 * R * C,
                "ethash_like": 2.0 * R * C * C + 3.0 * R * C,
                "hash_like": p * (2.0 * R * C * C + 2.0 * R * C)}[self.body]

    def workspace_sizes(self) -> tuple[tuple[int, torch.dtype], ...]:
        """(elements, dtype) of the carry's workspace: bnstats the CTAs' and
        the groups' (2, C) partials and a ticket per group plus the last
        level's; ethash_like a 32 x 128 partial per CTA and a ticket per
        slice; hist its int counts and one ticket; () for the others."""
        f32, i32 = torch.float32, torch.int32
        if self.body == "bnstats":
            groups = -(-self.ctas // BN_GROUP)
            return (((self.ctas + groups) * 2 * self.C, f32),
                    (groups + 1, i32))
        if self.body == "ethash_like":
            return ((self.ctas * TILE_R * LANES, f32),
                    (self.param // TILE_R, i32))
        if self.body == "hist":
            return ((self.param, i32), (1, i32))
        return ()

    def workspace(self, device) -> tuple[torch.Tensor, ...]:
        """The carry's workspace on ``device``, kept across launches
        (``cuda.workspace``: made zeroed once; the kernel leaves its tickets,
        and hist its counts, at zero), or () for the bodies without one."""
        sizes = self.workspace_sizes()
        return cuda.workspace(device, ("paper", self.body), sizes) \
            if sizes else ()

    def io(self) -> tuple[list, list]:
        """((shape, dtype) of each input, of each output) the kernel takes."""
        R, C, dt, p, f32 = self.R, self.C, self.dtype, self.param, torch.float32
        return {
            "maxpool": ([((R, C), dt)], [((R // 2, C), dt)]),
            "upsample": ([((R, C), dt)], [((2 * R, C), dt)]),
            "im2col": ([((R, C), dt)], [((R, p * C), dt)]),
            "bnstats": ([((R, C), dt)], [((2, C), f32)]),
            "hist": ([((R, C), dt)], [((1, p), f32)]),
            "ethash_like": ([((R, C), dt), ((p, C), dt), ((C, C), f32)],
                            [((p, C), f32)]),
            "hash_like": ([((R, C), dt), ((C, C), f32)], [((R, C), dt)]),
        }[self.body]

    def describe(self, md) -> None:
        """Kind and dims into a ``cuda.MemberDesc`` (no pointers); raises
        for what the kernel does not take."""
        ok = (torch.float32,) + ((torch.bfloat16,)
                                 if self.body in _BF16_BODIES else ())
        if self.dtype not in ok:
            raise ValueError(f"{self.body} member takes {ok}, got "
                             f"{self.dtype}")
        R, C = self.R, self.C
        bad = C % (16 // itemsize(self.dtype)) or R % self.rows
        if self.body == "bnstats":        # a 16-byte vector a thread a row
            bad = bad or C // (16 // itemsize(self.dtype)) > THREADS
        elif self.body == "hash_like":
            bad = bad or C != LANES
        elif self.body == "ethash_like":
            bad = (bad or C != LANES or self.param % TILE_R or R % self.param
                   or (R // self.param) % self.runs)
        elif self.body == "maxpool":
            bad = bad or self.rows % 2
        elif self.body == "hist":         # a copy of the bins a warp
            bad = bad or not 1 <= self.param <= HIST_MAX_BINS
        if bad:
            raise ValueError(f"{self.body} member: shape R={R} C={C} "
                             f"rows={self.rows} param={self.param} "
                             "unsupported")
        md.kind = _KIND[self.body]
        md.i[0], md.i[1], md.i[2] = R, C, _DTYPES[self.dtype]
        md.i[3], md.i[4] = self.rows, self.param
        if self.body == "ethash_like":
            md.i[5] = self.runs
        elif self.body == "hist":
            md.f[0] = self.param / 8.0

    def pack(self, md, ins, outs):
        """Describe, check and bind one launch's operands; returns the
        workspace, which must stay alive until the launch is queued."""
        self.describe(md)
        want_in, want_out = self.io()
        for j, (t, (shape, dt)) in enumerate(zip(ins, want_in)):
            md.inp[j] = cuda.check(t, f"{self.body} in{j}", shape, dt)
        shape, dt = want_out[0]
        md.out[0] = cuda.check(outs[0], f"{self.body} out", shape, dt)
        ws = self.workspace(outs[0].device)
        for j, t in enumerate(ws, start=1):
            md.out[j] = t.data_ptr()
        return ws


def _op(name, grid, member, plain, inputs, outputs, flops, hbm_bytes, tag,
        in_names, out_names) -> OpSpec:
    return OpSpec(name=name, grid=grid, member=member,
                  plain=lambda *xs: (plain(*xs),), inputs=inputs,
                  outputs=outputs, flops=flops, hbm_bytes=hbm_bytes, tag=tag,
                  in_names=in_names, out_names=out_names)


def _randn(gen, shape, dtype, device, scale=None):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if scale is not None:
        t = t * scale
    return t.to(dtype)


def _blk(s):
    return (s, 0)


def _const(s):
    return (0, 0)


# ---------------------------------------------------------------------------
# Memory-bound atoms
# ---------------------------------------------------------------------------
def make_maxpool(R=8192, C=512, dtype=torch.float32, bm=256):
    if R % bm or bm % 2:
        raise ValueError(f"maxpool: R={R}, bm={bm}")
    rows = bm // _per_step(bm, CTAS_PER_STEP, 2)
    op = _op("maxpool", R // bm, PaperMember("maxpool", R, C, dtype, rows),
             maxpool,
             (Operand((R, C), dtype, (bm, C), _blk),),
             (Operand((R // 2, C), dtype, (bm // 2, C), _blk),),
             1.0 * R * C, _bytes(((R, C), dtype), ((R // 2, C), dtype)),
             "paper:Maxpool", ("x",), ("out",))
    return op, lambda gen, device: (_randn(gen, (R, C), dtype, device),), \
        maxpool


def make_upsample(R=4096, C=512, dtype=torch.float32, bm=256):
    if R % bm:
        raise ValueError(f"upsample: R={R}, bm={bm}")
    rows = bm // _per_step(bm, CTAS_PER_STEP)
    op = _op("upsample", R // bm, PaperMember("upsample", R, C, dtype, rows),
             upsample,
             (Operand((R, C), dtype, (bm, C), _blk),),
             (Operand((2 * R, C), dtype, (2 * bm, C), _blk),),
             0.5 * R * C, _bytes(((R, C), dtype), ((2 * R, C), dtype)),
             "paper:Upsample", ("x",), ("out",))
    return op, lambda gen, device: (_randn(gen, (R, C), dtype, device),), \
        upsample


def make_bnstats(R=16384, C=512, dtype=torch.float32, bm=512):
    if R % bm:
        raise ValueError(f"bnstats: R={R}, bm={bm}")
    rows = bm // _per_step(bm, BN_CTAS_PER_STEP)
    op = _op("bnstats", R // bm,
             PaperMember("bnstats", R, C, dtype, rows), bnstats,
             (Operand((R, C), dtype, (bm, C), _blk),),
             (Operand((2, C), torch.float32, (2, C), _const),),
             3.0 * R * C, _bytes(((R, C), dtype), ((2, C), torch.float32)),
             "paper:Batchnorm", ("x",), ("stats",))
    return op, lambda gen, device: (_randn(gen, (R, C), dtype, device),), \
        bnstats


def make_im2col(R=4096, C=512, dtype=torch.float32, bm=256, K=4):
    if R % bm:
        raise ValueError(f"im2col: R={R}, bm={bm}")
    rows = bm // _per_step(bm, CTAS_PER_STEP)

    def plain(x):
        return im2col(x, K=K)

    op = _op("im2col", R // bm,
             PaperMember("im2col", R, C, dtype, rows, K), plain,
             (Operand((R, C), dtype, (bm, C), _blk),),
             (Operand((R, K * C), dtype, (bm, K * C), _blk),),
             0.5 * R * C * K, _bytes(((R, C), dtype), ((R, K * C), dtype)),
             "paper:Im2Col", ("x",), ("out",))
    return op, lambda gen, device: (_randn(gen, (R, C), dtype, device),), \
        plain


def make_ethash_like(R_dag=65536, C=LANES, dtype=torch.float32, bm=512,
                     seed_rows=512):
    """Memory-hard: stream a large DAG, tiny mixing matmul per block.  As in
    the reference, the seed block is ``bm`` rows (``seed_rows`` is unused)
    and ``hbm_bytes`` counts the seed twice and the output not at all."""
    blocks = R_dag // bm
    runs = _per_step(blocks, max(1, 128 // max(1, bm // TILE_R)))

    def plain(dag, x, w):
        return ethash_like(dag, x, w)

    op = _op("ethash_like", R_dag // bm,
             PaperMember("ethash_like", R_dag, C, dtype, TILE_R, bm, runs),
             plain,
             (Operand((R_dag, C), dtype, (bm, C), _blk),
              Operand((bm, C), dtype, (bm, C), _const),
              Operand((C, C), torch.float32, (C, C), _const)),
             (Operand((bm, C), torch.float32, (bm, C), _const),),
             2.0 * R_dag * C * C + 3.0 * R_dag * C,
             _bytes(((R_dag, C), dtype)) + _bytes(((bm, C), dtype)) * 2,
             "paper:Ethash", ("dag", "x", "w"), ("out",))

    def mk(gen, device):
        return (_randn(gen, (R_dag, C), dtype, device, 0.1),
                _randn(gen, (bm, C), dtype, device, 0.1),
                _randn(gen, (C, C), torch.float32, device, 1 / math.sqrt(C)))
    return op, mk, plain


def make_hist(R=2048, C=256, dtype=torch.float32, bm=64, bins=LANES):
    if R % bm:
        raise ValueError(f"hist: R={R}, bm={bm}")
    rows = bm // _per_step(bm, HIST_CTAS_PER_STEP)

    def plain(x):
        return hist(x, bins=bins)

    op = _op("hist", R // bm, PaperMember("hist", R, C, dtype, rows, bins),
             plain,
             (Operand((R, C), dtype, (bm, C), _blk),),
             (Operand((1, bins), torch.float32, (1, bins), _const),),
             2.0 * R * C * bins,
             _bytes(((R, C), dtype), ((1, bins), torch.float32)),
             "paper:Hist", ("x",), ("counts",))
    return op, lambda gen, device: (_randn(gen, (R, C), dtype, device),), \
        plain


# ---------------------------------------------------------------------------
# Compute-bound atoms (hash-kernel analogues: iterated mixing matmuls)
# ---------------------------------------------------------------------------
def _make_hash_like(name: str, rounds: int, R=4096, C=LANES,
                    dtype=torch.float32, bm=512):
    if R % bm:
        raise ValueError(f"{name}: R={R}, bm={bm}")

    def plain(x, w):
        return hash_like(x, w, rounds=rounds)

    op = _op(name, R // bm,
             PaperMember("hash_like", R, C, dtype, TILE_R, rounds), plain,
             (Operand((R, C), dtype, (bm, C), _blk),
              Operand((C, C), torch.float32, (C, C), _const)),
             (Operand((R, C), dtype, (bm, C), _blk),),
             rounds * 2.0 * R * C * C + rounds * 2.0 * R * C,
             _bytes(((R, C), dtype)) * 2, f"paper:{name}", ("x", "w"),
             ("out",))

    def mk(gen, device):
        return (_randn(gen, (R, C), dtype, device, 0.1),
                _randn(gen, (C, C), torch.float32, device, 1 / math.sqrt(C)))
    return op, mk, plain


def make_sha_like(**kw):
    return _make_hash_like("sha_like", rounds=16, **kw)


def make_blake_like(**kw):
    return _make_hash_like("blake_like", rounds=24, **kw)


def make_blake2b_like(**kw):
    return _make_hash_like("blake2b_like", rounds=20, **kw)


# ---------------------------------------------------------------------------
# Registry (the paper's benchmark sets)
# ---------------------------------------------------------------------------
DL_KERNELS = {
    "maxpool": make_maxpool,
    "bnstats": make_bnstats,
    "upsample": make_upsample,
    "im2col": make_im2col,
    "hist": make_hist,
}
CRYPTO_KERNELS = {
    "ethash_like": make_ethash_like,
    "sha_like": make_sha_like,
    "blake_like": make_blake_like,
    "blake2b_like": make_blake2b_like,
}
ALL_KERNELS = {**DL_KERNELS, **CRYPTO_KERNELS}


def paper_pairs() -> list[tuple[str, str]]:
    """The 16 benchmark pairs: C(5,2)=10 DL + C(4,2)=6 crypto."""
    dl = list(DL_KERNELS)
    cr = list(CRYPTO_KERNELS)
    pairs = [(a, b) for i, a in enumerate(dl) for b in dl[i + 1:]]
    pairs += [(a, b) for i, a in enumerate(cr) for b in cr[i + 1:]]
    return pairs


def paper_triples() -> list[tuple[str, str, str]]:
    """The N-way extension of Fig. 7: two memory-bound streams sharing one
    compute-bound partner (and the converse), and the all-compute negative
    control the planner should reject."""
    return [
        ("maxpool", "upsample", "sha_like"),
        ("ethash_like", "hist", "blake_like"),
        ("bnstats", "im2col", "blake2b_like"),
        ("sha_like", "blake_like", "blake2b_like"),
    ]


# reduced-size kwargs of the reference's tests and smoke checks
SMALL_KW = dict(
    maxpool=dict(R=256, C=128, bm=64), bnstats=dict(R=256, C=128, bm=64),
    upsample=dict(R=256, C=128, bm=64), im2col=dict(R=256, C=128, bm=64),
    hist=dict(R=256, C=128, bm=32), ethash_like=dict(R_dag=512, bm=128),
    sha_like=dict(R=256, bm=64), blake_like=dict(R=256, bm=64),
    blake2b_like=dict(R=256, bm=64),
)


def make_bundle(names, small: bool = False):
    """Instantiate a named bundle: ([OpSpec], [make_inputs], [plain_fn])."""
    ops, mks, plains = [], [], []
    for n in names:
        op, mk, pf = ALL_KERNELS[n](**(SMALL_KW[n] if small else {}))
        ops.append(op)
        mks.append(mk)
        plains.append(pf)
    return ops, mks, plains


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bf16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def inputs_from_numpy(name: str, arrays, device=None, **kw
                      ) -> tuple[torch.Tensor, ...]:
    """The inputs of ``ALL_KERNELS[name](**kw)`` from numpy arrays (the
    tests' bridge to the JAX package): each checked against its operand's
    shape and cast to its dtype, on ``device`` (the card unless asked for
    the CPU)."""
    dev = resolve_device(device)
    op = ALL_KERNELS[name](**kw)[0]
    if len(arrays) != len(op.inputs):
        raise ValueError(f"{name} takes {len(op.inputs)} inputs, got "
                         f"{len(arrays)}")
    out = []
    for a, o in zip(arrays, op.inputs):
        t = _tensor(a)
        if tuple(t.shape) != o.shape:
            raise ValueError(f"{name}: input shape {tuple(t.shape)}, op "
                             f"takes {o.shape}")
        out.append(t.to(device=dev, dtype=o.dtype))
    return tuple(out)
