"""The hist body's order (``csrc/paper_member.cuh`` hist_cta), done in
PyTorch, against the reference's hist in interpret mode, on the CPU.

The model follows the kernel: CTA c owns rows [c rows, (c + 1) rows); thread
t of its 256 takes the 16-byte vectors t, t + 256, ... of the CTA's rows (4
fp32 or 8 bf16 values each), bins each value in fp32 (trunc(fmin(fmax((x +
4) * bins/8, 0), bins - 1)): fmax takes a NaN to bin 0) and counts it in its
warp's copy of the bins (warp t // 32); the 8 warp copies are summed in warp
order, each CTA's sums are added into the global counts, and the last CTA
reads them out.  The counts are integers, so no order changes them: the model checks the geometry (every value counted once,
by the CTA and warp the kernel gives it) and the binning, bitwise against the
reference at the defaults, at SMALL_KW, with bf16 input and on skewed data.
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

HI_UNROLL = int(re.search(
    r"^#define HI_UNROLL (\d+)", (Path(__file__).resolve().parents[1] / "src"
                                   / "repro_torch" / "csrc"
                                   / "paper_member.cuh").read_text(),
    re.M).group(1))


def hist_model(x: torch.Tensor, member: ps.PaperMember) -> torch.Tensor:
    """(1, bins) fp32 counts, computed in the kernel's geometry and order."""
    R, C, rows, bins = member.R, member.C, member.rows, member.param
    vec = 16 // x.element_size()
    ctas = member.ctas
    assert rows * ctas == R and C % vec == 0
    t = torch.fmax((x.float() + 4.0) * (bins / 8.0),
                   torch.tensor(0.0))
    b = torch.fmin(t, torch.tensor(float(bins - 1))).to(torch.int64)
    b = b.reshape(ctas, rows * C)                    # a CTA's values in order
    e = torch.arange(rows * C)
    warp = (e // vec) % ps.THREADS // 32             # the thread's warp
    per_warp = torch.zeros(ctas, ps.WARPS, bins, dtype=torch.int64)
    per_warp.view(ctas, -1).scatter_add_(
        1, warp[None, :] * bins + b, torch.ones_like(b))
    cta_counts = per_warp[:, 0].clone()
    for w in range(1, ps.WARPS):                     # warp order
        cta_counts += per_warp[:, w]
    out = torch.zeros(bins, dtype=torch.int64)
    for c in range(ctas):                            # any order: atomics
        out += cta_counts[c]
    return out.to(torch.float32).reshape(1, bins)


def _case(kind: str):
    """(kw, numpy fp32 input) of a test case."""
    kw = {"small": dict(jps.SMALL_KW["hist"]), "defaults": {},
          "bf16": dict(jps.SMALL_KW["hist"]),
          "one_bin": dict(jps.SMALL_KW["hist"]),
          "clipped": dict(jps.SMALL_KW["hist"]),
          "odd_bins": dict(R=192, C=264, bm=48, bins=100)}[kind]
    op = jps.make_hist(**kw)[0]
    shape = op.inputs[0].shape
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    if kind == "one_bin":                 # every value in one bin (bin 65)
        x[:] = 0.1
    elif kind == "clipped":               # every value clipped, both ends
        x[:] = np.where(x > 0, 40.0, -40.0)
    return kw, x


@pytest.mark.parametrize("kind", ["defaults", "small", "bf16", "one_bin",
                                  "clipped", "odd_bins"])
def test_hist_model_matches_reference_interpret(kind):
    kw, x = _case(kind)
    jdt, tdt = jnp.float32, torch.float32
    if kind == "bf16":
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    jop = jps.make_hist(**kw, dtype=jdt)[0]
    op, _mk, plain = ps.make_hist(**kw, dtype=tdt)
    assert op.member.rows * op.member.ctas == op.member.R
    xt = ps.inputs_from_numpy("hist", [x], "cpu", **kw, dtype=tdt)[0]
    (want,) = jhfuse.run_single(jop, interpret=True)(
        jnp.asarray(x).astype(jdt))
    want = torch.from_numpy(np.array(want))
    got = hist_model(xt, op.member)
    assert torch.equal(got, want)
    assert torch.equal(plain(xt), want)
    assert float(got.sum()) == x.size
    if kind == "one_bin":
        assert int((got > 0).sum()) == 1
    if kind == "clipped":
        assert float(got[0, 0] + got[0, -1]) == x.size


def test_hist_geometry_covers_every_vector():
    """At the defaults each CTA's 16 rows x 256 fp32 are 1024 16-byte
    vectors: 4 a thread, all in flight at once (HI_UNROLL 8), and 512 bf16
    ones (2 a thread); the 128 CTAs are one wave on the card's 132 SMs."""
    for dtype, per_thread in ((torch.float32, 4), (torch.bfloat16, 2)):
        m = ps.make_hist(dtype=dtype)[0].member
        vectors = m.rows * m.C * torch.tensor([], dtype=dtype).element_size()
        assert vectors // 16 == per_thread * ps.THREADS
        assert per_thread <= HI_UNROLL
        assert m.ctas == 128
