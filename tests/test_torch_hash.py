"""The hash members' summation order, on the CPU.

The hash_like member (``csrc/paper_member.cuh`` hash_member; sha, blake and
blake2b are one body with 16, 24 and 20 rounds) holds w in registers: each
lane owns a 32-deep k group (a quarter of w's 128 rows) of two columns,
sums it in k order with one rounding a step (fmaf, from 0), and the CTA
adds each output's four group partials in group order, rounding each add,
before tanh.  Here that order, done in PyTorch round by round, is held
against the reference's ``hash_like`` in interpret mode on the same numpy
inputs: at ``SMALL_KW`` for the three variants, at the defaults with 1, 16
and 24 rounds, and with x scaled x10 (one round then saturates tanh; the
later rounds of a state of +-1 stay near the unit range, since w is scaled
by 1/sqrt(128)).  That checks the function the order computes, not the
order itself: another fp32 summation order moves the results by about 1e-7,
far inside the tolerance; the card tests hold fused launches bitwise to the
member alone.  The body's geometry (k groups, columns a lane, rows a step,
shared memory), computed from ``csrc/paper_member.cuh``'s own constants as
``hash_rounds`` computes it, is checked for the member's groups and the
16-deep ones of ``scripts/member_variants.py``; its CTA geometry (32 rows a
CTA, 16 CTAs a TPU grid step) is pinned by ``tests/test_torch_paper.py``.

Tolerance: ``paper_suite.TOLERANCE["hash_like"]`` (1e-5 relative and
absolute), the kernel's own against its plain version.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hfuse as jhfuse
from repro.kernels import paper_suite as jps
from repro_torch.kernels import paper_suite as ps

_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _defines(name: str) -> dict[str, int]:
    """The integer ``#define``s of a kernel source."""
    text = (_SRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


CUH = {**_defines("common.cuh"), **_defines("paper_member.cuh")}
HS_KG = CUH["HS_KG"]    # k rows of a lane's slice of w (the member's KG)


def group_order_hash(x: torch.Tensor, w: torch.Tensor,
                     rounds: int) -> torch.Tensor:
    """``rounds`` x s = tanh(s @ w) in the member's order: each k group's
    partial (HS_KG rows) in k order, one rounding a step (the fp64 product
    is exact and the fp64 sum rounded to fp32 is the fmaf's result but for
    rare double roundings, far inside the tolerance), the groups added in
    order in fp32, then tanh."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _group_order_hash(x, w, rounds)
    finally:
        torch.set_num_threads(threads)


def _group_order_hash(x: torch.Tensor, w: torch.Tensor,
                      rounds: int) -> torch.Tensor:
    # On the calling thread alone: in a process that has run JAX, one
    # worker of torch's intra-op pool was seen to round its chunk (32 rows)
    # differently, 1.5e-5 off after 16 rounds, in about one run in 30.
    s = x.float()
    R, C = s.shape
    ng = C // HS_KG
    wg = w.double().reshape(ng, HS_KG, C)
    for _ in range(rounds):
        sg = s.double().reshape(R, ng, HS_KG).permute(1, 0, 2)
        p = torch.zeros((ng, R, C), dtype=torch.float64)
        for k in range(HS_KG):
            p = (sg[:, :, k, None] * wg[:, k, None, :] + p).float().double()
        t = p[0].float()
        for j in range(1, ng):
            t = t + p[j].float()
        s = torch.tanh(t)
    return s


CASES = [
    *[(name, "small", None, 1.0) for name in ("sha_like", "blake_like",
                                             "blake2b_like")],
    *[("sha_like", "default", rounds, 1.0) for rounds in (1, 16, 24)],
    ("sha_like", "default", 1, 10.0),
    ("blake_like", "small", None, 10.0),
]


@pytest.mark.parametrize("name,size,rounds,scale", CASES,
                         ids=lambda v: str(v))
def test_group_order_matches_reference(name, size, rounds, scale):
    kw = dict(ps.SMALL_KW[name]) if size == "small" else {}
    if rounds is None:
        jop, _, _ = jps.ALL_KERNELS[name](**kw)
        rounds = ps.ALL_KERNELS[name](**kw)[0].member.param
    else:
        jop, _, _ = jps._make_hash_like(name, rounds, **kw)
    R, C = jop.inputs[0].shape
    rng = np.random.default_rng(rounds)
    x = (rng.normal(size=(R, C)) * 0.1 * scale).astype(np.float32)
    w = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)
    (want,) = jhfuse.run_single(jop, interpret=True)(jnp.asarray(x),
                                                     jnp.asarray(w))
    got = group_order_hash(torch.from_numpy(x), torch.from_numpy(w),
                           rounds)
    ref = torch.from_numpy(np.asarray(want, np.float32).copy())
    err = ps.max_error(got, ref, "hash_like")
    if scale > 1.0 and rounds == 1:
        assert float(ref.abs().max()) > 0.999    # tanh saturates
    assert err <= ps.TOLERANCE["hash_like"]


@pytest.mark.parametrize("kg", [HS_KG, 16])
def test_groups_cover_the_tile(kg):
    """As ``hash_rounds<KG>`` lays out its CTA: G = 128 / KG k groups cover
    w's rows; a lane holds KG x NC = 64 of w (NC = 64 / KG columns); warps
    are G groups x CG = 8 / G column groups whose lanes' NC columns cover
    128; a step's RS = 128 / G rows divide the 32 of a CTA (32 / RS steps a
    round: one for the member's quarters, two for eighths); the one partial
    buffer (G x RS x 128 fp32 = 64 KB) and the state (32 x 128 fp32) are the
    member's 80 KB a CTA (``paper_smem_bytes``), and the combine's 16-byte
    vectors split evenly over the threads."""
    C, TR = CUH["PS_TILE_C"], CUH["PS_TILE_R"]
    threads, warps = CUH["HF_THREADS"], CUH["HF_THREADS"] // 32
    assert (C, TR) == (ps.LANES, ps.TILE_R)
    G, NC = C // kg, 64 // kg
    CG, RS = warps // G, 128 // G
    RV = RS * C // 4
    assert G * kg == C and kg * NC == 64
    assert CG * 32 * NC == C                      # the static_assert's terms
    assert TR % RS == 0 and RV % threads == 0
    assert TR // RS == {32: 1, 16: 2}[kg]
    parts = G * RS * C * 4
    assert parts == 64 * 1024
    assert parts + TR * C * 4 == (C + TR) * C * 4 == 80 * 1024
