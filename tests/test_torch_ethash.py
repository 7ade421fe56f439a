"""The ethash_like member's 3xTF32 product, on the CPU.

The member (``csrc/paper_member.cuh`` ethash_member) multiplies A = x + dag
by w on the tensor cores in TF32: each fp32 operand is split into hi =
cvt.rna.tf32(v) (round to nearest, ties away from zero, to TF32's 10
mantissa bits) and lo = cvt.rna.tf32(v - hi), and three products, lo.hi,
hi.lo and hi.hi, are summed in fp32.  Here that split is done with integer
operations on the fp32 bits, the three products summed in fp32 by PyTorch,
tanh applied, each run's blocks summed in block order and the runs' partials
in run order (the member's carry), and the result held against the
reference's ``ethash_like`` in interpret mode on the same numpy inputs: at
``SMALL_KW``, at the defaults (65536-row DAG, 128 blocks), at the card
tests' ``R_dag=4096, bm=256`` with 1 and 8 runs, and with the DAG scaled
x10.  That checks the function the split computes, not the tensor cores'
order of summation, which no CPU model reproduces; the card tests hold the
kernel to its plain version and fused launches bitwise to the member alone.
One TF32 product (hi.hi alone) is also modelled, to show the tolerance
tells the two apart: at the defaults it misses by far.

Tolerance: ``paper_suite.TOLERANCE["ethash_like"]`` (1e-4 relative and
absolute), the kernel's own against its plain version.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hfuse as jhfuse
from repro.kernels import paper_suite as jps
from repro_torch.kernels import paper_suite as ps


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna.tf32.f32: add half a TF32 unit in the last
    place to the magnitude bits (a carry moves into the exponent), then
    clear the 13 bits TF32 drops; ties round away from zero."""
    b = v.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def product_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w from TF32 parts: lo.hi + hi.lo + hi.hi, summed in fp32."""
    (ah, al), (wh, wl) = split(a), split(w)
    return al @ wh + ah @ wl + ah @ wh


def product_1xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(w)


def member_model(dag, x, w, runs: int, product) -> torch.Tensor:
    """The member's function: per DAG block tanh(product(x + dag_s, w)),
    each run's blocks summed in order from 0, the runs' sums in run order."""
    bm, C = x.shape
    blocks = dag.reshape(-1, bm, C)
    per_run = blocks.shape[0] // runs
    out = torch.zeros((bm, C), dtype=torch.float32)
    for r in range(runs):
        tot = torch.zeros((bm, C), dtype=torch.float32)
        for s in range(r * per_run, (r + 1) * per_run):
            tot = tot + torch.tanh(product((x + blocks[s]).float(), w))
        out = out + tot
    return out


def _inputs(R_dag, bm, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    C = ps.LANES
    dag = (rng.standard_normal((R_dag, C)) * 0.1 * scale).astype(np.float32)
    x = (rng.standard_normal((bm, C)) * 0.1).astype(np.float32)
    w = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    return dag, x, w


def _reference(R_dag, bm, arrays):
    jop = jps.make_ethash_like(R_dag=R_dag, bm=bm)[0]
    (want,) = jhfuse.run_single(jop, interpret=True)(
        *(jnp.asarray(a) for a in arrays))
    return torch.from_numpy(np.asarray(want, np.float32).copy())


# (R_dag, bm, runs (None: the member's), DAG scale)
CASES = [
    (ps.SMALL_KW["ethash_like"]["R_dag"], ps.SMALL_KW["ethash_like"]["bm"],
     None, 1.0),
    (65536, 512, None, 1.0),
    (4096, 256, 1, 1.0),
    (4096, 256, 8, 1.0),
    (4096, 256, None, 10.0),
]


@pytest.mark.parametrize("R_dag,bm,runs,scale", CASES, ids=lambda v: str(v))
def test_3xtf32_matches_reference(R_dag, bm, runs, scale):
    member = ps.make_ethash_like(R_dag=R_dag, bm=bm)[0].member
    runs = member.runs if runs is None else runs
    assert (R_dag // bm) % runs == 0
    arrays = _inputs(R_dag, bm, R_dag + runs, scale)
    want = _reference(R_dag, bm, arrays)
    dag, x, w = (torch.from_numpy(a) for a in arrays)
    got = member_model(dag, x, w, runs, product_3xtf32)
    err = ps.max_error(got, want, "ethash_like")
    assert err <= ps.TOLERANCE["ethash_like"] * (1 + float(want.abs().max()))
    if scale > 1.0:
        assert float(want.abs().max()) > 0.5 * (R_dag // bm)   # tanh saturates


def test_one_tf32_product_misses_the_tolerance():
    """At the defaults hi.hi alone is off by far more than 1e-4 of 1 +
    |want|: the tolerance asks for the three products."""
    arrays = _inputs(65536, 512, 7)
    want = _reference(65536, 512, arrays)
    dag, x, w = (torch.from_numpy(a) for a in arrays)
    got = member_model(dag, x, w, 8, product_1xtf32)
    with pytest.raises(AssertionError, match="tolerance"):
        ps.max_error(got, want, "ethash_like")


@pytest.mark.parametrize("v,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # below the tie: down
    (2.0 - 2.0 ** -23, 2.0),                     # carry into the exponent
    (0.1, 0.0999755859375),                      # 0x3dcccccd -> 0x3dccc000
])
def test_tf32_rounding(v, want):
    got = tf32_rna(torch.tensor([v], dtype=torch.float32))
    assert got.item() == want
    x = torch.tensor([v], dtype=torch.float32)
    hi, lo = split(x)
    assert abs((hi.double() + lo.double() - x.double()).item()) <= \
        abs(v) * 2.0 ** -21
