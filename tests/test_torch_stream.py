"""The upsample and im2col bodies' geometry and order
(``csrc/paper_member.cuh`` upsample_member, im2col_rows), done in PyTorch,
against the reference's kernels in interpret mode, on the CPU.

The models follow the kernels.  upsample: CTA c owns input rows [c rows,
(c + 1) rows); thread t of its 256 loads the CTA's 16-byte vectors t, t +
256, ... (up to UP_UNROLL a trip, all before its first store), then stores
each into output rows 2r and 2r + 1, r and the column c walked by HF_THREADS
/ cv rows and HF_THREADS % cv columns a vector (one more row where c
wraps), as the kernel walks them without dividing.  im2col: the CTA's
output vector v (ov = K C / VEC a row) is row r = v / ov, elements e = (v %
ov) VEC .. + VEC of it, block k = e / C, column c = e % C; element j is
row[c + s + j] with s = k if k < C else 0, wrapped once (c + s + j < 2C:
checked, so no read leaves the row).  Both models record where every store
goes: each output element is written exactly once.  The result must be
bitwise equal to the reference's Pallas kernel in interpret mode at the
defaults, at SMALL_KW, in bf16, on ragged row counts (3 rows a CTA, 17 or
34 vectors a row) and, for im2col, at K = C - 1, C, C + 1 and 2C + 3.
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

_DEFINES = {k: int(v) for k, v in re.findall(
    r"^#define (\w+) (\d+)\b",
    "".join((Path(__file__).resolve().parents[1] / "src" / "repro_torch"
             / "csrc" / f).read_text()
            for f in ("common.cuh", "paper_member.cuh")), re.M)}
THREADS = _DEFINES["HF_THREADS"]
UP_UNROLL = _DEFINES["UP_UNROLL"]
M32 = 0xFFFFFFFF


def _vectors(x: torch.Tensor) -> torch.Tensor:
    """(R, cv, 4) int64: each row's 16-byte vectors as 4 little-endian
    32-bit words."""
    R = x.shape[0]
    w = x.contiguous().view(torch.int32).reshape(R, -1, 4) \
        if x.element_size() == 4 else \
        x.contiguous().view(torch.int16).reshape(R, -1, 8)
    if x.element_size() == 2:
        lo = w[..., 0::2].to(torch.int64) & 0xFFFF
        hi = w[..., 1::2].to(torch.int64) & 0xFFFF
        return lo | (hi << 16)
    return w.to(torch.int64) & M32


def _from_vectors(v: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of ``_vectors``: (R, n, 4) words -> (R, n * 16 bytes)."""
    R = v.shape[0]
    if dtype == torch.float32:
        w = torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)
        return w.reshape(R, -1).view(torch.float32)
    lo, hi = v & 0xFFFF, v >> 16
    h = torch.stack([lo, hi], -1).reshape(R, -1)
    return torch.where(h > 0x7FFF, h - (1 << 16), h).to(torch.int16).view(
        torch.bfloat16)


def _walk(n: int, cv: int, trip: int) -> list[tuple[torch.Tensor, ...]]:
    """Each trip of the kernels' loop: (v, r, c) of every thread's vectors
    u = 0 .. trip - 1, r and c walked as the kernel walks them (start at v0
    / cv and v0 % cv, then HF_THREADS / cv rows and HF_THREADS % cv columns
    a vector, one more row where the column wraps); v = -1 past the end."""
    t = torch.arange(THREADS)
    dr, dc = THREADS // cv, THREADS % cv
    trips = []
    for v0 in range(0, n, trip * THREADS):
        r, c = (v0 + t) // cv, (v0 + t) % cv
        vs, rs, cs = [], [], []
        for u in range(trip):
            v = v0 + t + u * THREADS
            vs.append(torch.where(v < n, v, -1))
            rs.append(r.clone())
            cs.append(c.clone())
            r, c = r + dr, c + dc
            r, c = torch.where(c >= cv, r + 1, r), torch.where(c >= cv,
                                                               c - cv, c)
        trips.append((torch.stack(vs), torch.stack(rs), torch.stack(cs)))
    return trips


def upsample_model(x: torch.Tensor, m: ps.PaperMember) -> torch.Tensor:
    cv = m.C * x.element_size() // 16
    n = m.rows * cv
    xv = _vectors(x).reshape(m.ctas, n, 4)
    out = torch.full((m.ctas, 2 * n, 4), -1, dtype=torch.int64)
    writes = torch.zeros(m.ctas, 2 * n, dtype=torch.int64)
    for v, r, c in _walk(n, cv, UP_UNROLL):
        ok = v >= 0
        assert torch.equal((r * cv + c)[ok], v[ok])      # the walk is v
        loaded = xv[:, v[ok]]                             # all loads first
        for at in (2 * r * cv + c, (2 * r + 1) * cv + c):
            out[:, at[ok]] = loaded
            writes[:, at[ok]] += 1
    assert bool((writes == 1).all())                      # each once
    return _from_vectors(out.reshape(m.ctas * 2 * m.rows, cv, 4), x.dtype)


def im2col_model(x: torch.Tensor, m: ps.PaperMember) -> torch.Tensor:
    vec, C, K = 16 // x.element_size(), m.C, m.param
    ov = K * C // vec                                     # vectors a row
    xe = x.contiguous().view(torch.int16 if vec == 8 else torch.int32)
    xe = xe.reshape(m.ctas, m.rows, C)
    out = torch.zeros((m.ctas, m.rows, K * C), dtype=xe.dtype)
    writes = torch.zeros((m.rows, K * C), dtype=torch.int64)
    v = torch.arange(m.rows * ov)              # thread v % 256 builds it
    r, e = v // ov, v % ov * vec
    k, c = e // C, e % C
    src = (c + torch.where(k < C, k, 0))[:, None] + torch.arange(vec)
    assert bool((src < 2 * C).all())                       # one wrap
    src = torch.where(src < C, src, src - C)
    at = e[:, None] + torch.arange(vec)
    out[:, r[:, None], at] = xe[:, r[:, None], src]
    writes.index_put_((r[:, None].expand_as(at), at),
                      torch.ones_like(at), accumulate=True)
    assert bool((writes == 1).all())                       # each once
    return out.reshape(m.R, K * C).view(x.dtype)


MODELS = {"upsample": upsample_model, "im2col": im2col_model}

# (body, kw of the factory, dtype)
CASES = (
    [(b, {}, d) for b in MODELS for d in ("float32", "bfloat16")]
    + [(b, dict(jps.SMALL_KW[b]), d) for b in MODELS
       for d in ("float32", "bfloat16")]
    # ragged: 3 rows a CTA, 34 (fp32) or 17 (bf16) vectors a row
    + [(b, dict(R=96, C=136, bm=48), d) for b in MODELS
       for d in ("float32", "bfloat16")]
    # 1 row a CTA of one vector
    + [("upsample", dict(R=32, C=8, bm=16), "bfloat16"),
       ("im2col", dict(R=32, C=4, bm=16, K=3), "float32")]
    # K around C and past 2C: blocks from C on are the row itself
    + [("im2col", dict(R=64, C=C, bm=64, K=K), d)
       for C, d in ((4, "float32"), (8, "bfloat16"))
       for K in (C - 1, C, C + 1, 2 * C + 3)]
    + [("im2col", dict(R=48, C=24, bm=48, K=K), "bfloat16") for K in (9, 30)])


def _ids(v):
    if isinstance(v, dict):
        return "-".join(f"{k}{x}" for k, x in v.items()) or "default"
    return v


@pytest.mark.parametrize("body,kw,dtype", CASES, ids=_ids)
def test_model_matches_reference_interpret(body, kw, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jop = jps.ALL_KERNELS[body](**kw, dtype=jdt)[0]
    op, _mk, plain = ps.ALL_KERNELS[body](**kw, dtype=tdt)
    m = op.member
    m.describe(ps.cuda.MemberDesc())                     # the kernel takes it
    x = np.random.default_rng(7).standard_normal(
        op.inputs[0].shape).astype(np.float32)
    xt = ps.inputs_from_numpy(body, [x], "cpu", **kw, dtype=tdt)[0]
    (want,) = jhfuse.run_single(jop, interpret=True)(
        jnp.asarray(x).astype(jdt))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(tdt)
    got = MODELS[body](xt, m)
    assert torch.equal(got, want)
    assert torch.equal(plain(xt), want)


def test_stream_geometry():
    """At the defaults upsample and im2col run 16 rows a CTA, 256 CTAs: one
    wave at two CTAs an SM of the card's 132.  upsample's thread holds all
    of its CTA's vectors in flight at once (8 fp32, 4 bf16: UP_UNROLL 8)."""
    for body in MODELS:
        for dtype, per_thread in ((torch.float32, 8), (torch.bfloat16, 4)):
            m = ps.ALL_KERNELS[body](dtype=dtype)[0].member
            assert (m.rows, m.ctas) == (16, 256) and m.ctas <= 2 * 132
            isz = torch.tensor([], dtype=dtype).element_size()
            assert m.rows * m.C * isz // 16 == per_thread * THREADS
            assert per_thread <= UP_UNROLL
