"""RMSNorm's reduction order and CTA geometry, on the CPU.

The RMSNorm member (``csrc/row_member.cuh``) reduces each row with one
warp: element k belongs to lane (k // V) % 32, V = 16 // itemsize (8 bf16,
4 fp32, the elements of a 16-byte vector); each lane adds the squares of its
elements in k order with one rounding a step (fmaf); ``warp_sum`` adds the
32 lanes' sums in its butterfly (xor 16, 8, 4, 2, 1); and 1/rms =
rsqrt(sum / d + eps).  The chains' norm stages and the GEMM prologues use
the same order, so chains stay bitwise equal to their members.  Here that
order, done in PyTorch, is held against the reference's ``rmsnorm_op`` in
interpret mode on the same numpy inputs, at aligned and unaligned widths
(100), at the register width (2048 fp32, 4096 bf16) and past it.  The
member's CTA count is ``M`` below ``row.NORM_PACK_M`` rows (decode
geometry, one row a CTA) and ``ceil(M / row.NORM_ROWS)`` from there on.

Tolerances are ``tests/test_torch_kernels.py``'s: fp32 inputs 1e-5
relative and absolute, bf16 inputs 2e-2 of the largest reference value.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hfuse as jhfuse
from repro.kernels.rmsnorm import rmsnorm_op as jrmsnorm
from repro_torch.kernels import row
from repro_torch.kernels.rmsnorm import rmsnorm_op

DTYPES = {"float32": (jnp.float32, np.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, ml_dtypes.bfloat16, 2e-2)}


def _both(rng, shape, np_dtype, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np_dtype)
    if np_dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def lane_sums(x: torch.Tensor) -> torch.Tensor:
    """(R, 32) fp32: each lane's sum of squares of its elements of each
    row, in k order, one rounding a step (the fp64 product is exact, and
    the fp64 sum rounded to fp32 is the fmaf's result but for rare double
    roundings, far inside the tolerance)."""
    R, d = x.shape
    V = 16 // x.element_size()
    k = torch.arange(d)
    lanes = [k[(k // V) % 32 == lane] for lane in range(32)]
    steps = max(len(c) for c in lanes)
    xf = x.float()
    ss = torch.zeros((R, 32), dtype=torch.float32)
    for s in range(steps):
        v = torch.stack([xf[:, c[s]] if s < len(c) else torch.zeros(R)
                         for c in lanes], dim=1).double()
        ss = (v * v + ss.double()).float()
    return ss


def warp_sum(v: torch.Tensor) -> torch.Tensor:
    """``warp_sum``'s butterfly over the last dim (32 lanes): every lane
    ends with the same fp32 total."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v


def lane_order_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the member's reduction order, in PyTorch."""
    tot = warp_sum(lane_sums(x))
    assert bool((tot == tot[:, :1]).all())
    inv = torch.rsqrt(tot[:, :1] / x.shape[1] + eps)
    return (x.float() * inv * (1.0 + scale)).to(x.dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", [1, 8, 37])
@pytest.mark.parametrize("d", [64, 100, 2048, 4096])
def test_lane_order_matches_reference(d, rows, dtype):
    jdt, np_dt, tol = DTYPES[dtype]
    rng = np.random.default_rng(d + rows)
    jx, tx = _both(rng, (rows, d), np_dt)
    js, ts = _both(rng, (1, d), np.float32, 0.5)
    (want,) = jhfuse.run_single(jrmsnorm(rows, d, jdt, bm=rows),
                                interpret=True)(jx, js)
    got = lane_order_rmsnorm(tx, ts).float().numpy()
    ref = np.asarray(want, np.float32)
    if tol >= 1e-3:
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("M", [1, 8, 37, row.NORM_PACK_M - 1,
                               row.NORM_PACK_M, row.NORM_PACK_M + 1, 8192,
                               8193])
def test_rmsnorm_ctas(M):
    """One row a CTA below the threshold (the CTA count the bundle grid and
    the interpret proxy read stays M at decode sizes), NORM_ROWS rows a CTA
    from it on, the last CTA part at a ragged M."""
    member = rmsnorm_op(M, 2048, torch.bfloat16, bm=M).member
    if M < row.NORM_PACK_M:
        assert row.norm_rows(M) == 1 and member.ctas == M
    else:
        assert row.norm_rows(M) == row.NORM_ROWS
        assert member.ctas == math.ceil(M / row.NORM_ROWS)
    assert (member.ctas - 1) * row.norm_rows(M) < M <= (
        member.ctas * row.norm_rows(M))
