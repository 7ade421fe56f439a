"""The split layouts of the two redesigned members, on the CPU.

Decode attention (``kernels/decode_attention.py``) cuts each slot's cache
into fixed ranges of positions, one CTA each, and combines the ranges' (o,
m, l) in range order; the grouped expert FFN (``kernels/moe_gmm.py``)
picks an f-tile and the token rows a pass holds.  Here: the ranges are
whole pages and whole warp tiles and cover the cache; the combine's
arithmetic, done in PyTorch on the plain version's per-range results
exactly as the kernel orders it, against the reference's
``decode_attention_op`` in interpret mode on the same numpy inputs; and the
FFN's f-tiles, passes and CTA counts.

Tolerances are ``tests/test_torch_kernels.py``'s: fp32 inputs 1e-5
relative and absolute, bf16 inputs 2e-2 of the largest reference value.
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hfuse as jhfuse
from repro.kernels.decode_attention import decode_attention_op as jdecode
from repro_torch.kernels.decode_attention import (
    KV_SPLIT, decode_attention_op, kv_split, n_splits,
    plain_decode_attention)
from repro_torch.kernels.moe_gmm import MoeGmmMember, f_tile, pass_rows

DTYPES = {"float32": (jnp.float32, np.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, ml_dtypes.bfloat16, 2e-2)}


def _both(rng, shape, np_dtype):
    a = rng.normal(size=shape).astype(np_dtype)
    if np_dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def warp_tile(D):
    """Positions a warp of csrc/decode_attention.cuh stages at once: DEC_J
    (4) for each of its 32 / LPP lane groups (dec_lpp: 8, 16 or 32 lanes a
    cached row at D <= 64, 128, 256)."""
    return 4 * 32 // (8 if D <= 64 else 16 if D <= 128 else 32)


@pytest.mark.parametrize("bs", [0, 4, 16, 64, 128, 48])
@pytest.mark.parametrize("S", [64, 256, 2048, 3000])
def test_splits_are_whole_pages_and_tiles_and_cover_s(S, bs):
    ks = kv_split(bs)
    assert ks % KV_SPLIT == 0
    if bs:
        assert ks % bs == 0
    for D in (8, 64, 72, 128, 256):
        assert ks % warp_tile(D) == 0
    n = n_splits(S, bs)
    assert (n - 1) * ks < S <= n * ks


def test_decode_cta_counts():
    """One CTA per (slot, KV head, split): 8 x 8 x 8 at B 8, S 2048, Hkv 8,
    the paged form (16-row pages, the engine's arena) the same; a cache
    shorter than a split gives one CTA per (slot, head)."""
    bf = torch.bfloat16
    assert decode_attention_op(8, 2048, 32, 8, 64, bf,
                               dynamic_length=True).ctas == 512
    assert decode_attention_op(8, 2048, 32, 8, 128, bf, dynamic_length=True,
                               block_table=(8 * 128 + 8, 16)).ctas == 512
    assert decode_attention_op(2, 128, 4, 4, 16, bf, ck=128,
                               dynamic_length=True).ctas == 8


def split_decode(length, q, k, v, ks):
    """Decode attention as the kernel composes it: each live range of ks
    positions through the plain version (o unnormalised), then the
    ranges combined in range order.  A slot of length <= 0 masks every
    score in every range, as the reference does."""
    B, H, D = q.shape
    S = k.shape[1]
    o = torch.empty(B, H, D)
    m = torch.empty(B, H, 1)
    l = torch.empty(B, H, 1)
    for b in range(B):
        L = int(length[b, 0])
        n_kv = S if L <= 0 else min(L, S)
        parts = []
        for i in range(-(-n_kv // ks)):
            lo, hi = i * ks, min((i + 1) * ks, n_kv)
            sub = torch.tensor([[0 if L <= 0 else hi - lo]], dtype=torch.int32)
            oi, mi, li = plain_decode_attention(sub, q[b:b + 1],
                                                k[b:b + 1, lo:hi],
                                                v[b:b + 1, lo:hi])
            parts.append((oi[0] * li[0], mi[0], li[0]))
        mx = torch.stack([p[1] for p in parts]).amax(0)
        lsum = torch.zeros_like(mx)
        osum = torch.zeros(H, D)
        for oi, mi, li in parts:
            fac = torch.exp(mi - mx)
            lsum = lsum + li * fac
            osum = osum + oi * fac
        o[b], m[b], l[b] = osum / lsum.clamp_min(1e-30), mx, lsum
    return o, m, l


@pytest.mark.parametrize("lens", [(0, 1, 63), (64, 65, 256)])
@pytest.mark.parametrize("D", [16, 72])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_combine_matches_reference(dtype, D, lens):
    """B 3, S 256, ranges of 64 positions: lengths 0 (every score masked),
    1, one short of a range, a range, one past it, and S."""
    jdt, np_dt, tol = DTYPES[dtype]
    B, S, H, Hkv, ks = 3, 256, 4, 2, 64
    rng = np.random.default_rng(D + lens[0])
    length = np.asarray(lens, np.int32).reshape(B, 1)
    jq, tq = _both(rng, (B, H, D), np_dt)
    jk, tk = _both(rng, (B, S, Hkv, D), np_dt)
    jv, tv = _both(rng, (B, S, Hkv, D), np_dt)
    want = jhfuse.run_single(
        jdecode(B, S, H, Hkv, D, jdt, ck=64, dynamic_length=True),
        interpret=True)(jnp.asarray(length), jq, jk, jv)
    got = split_decode(torch.from_numpy(length.copy()), tq, tk, tv, ks)
    for a, b in zip(want, got):
        ref = np.asarray(a, np.float32)
        out = b.numpy()
        assert out.shape == ref.shape
        if tol >= 1e-3:
            assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(),
                                                         1e-6)
        else:
            np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("C,rows,passes", [
    (8, 8, 1), (16, 16, 1), (32, 32, 1), (80, 40, 2), (128, 32, 4)])
def test_moe_gmm_tiles_and_passes(C, rows, passes):
    """phi3.5-moe's experts (E 16, d 4096, f 6400): the token rows of a
    pass and the passes (each streams the weights once: once a launch up to
    C 40, never more than ceil(C / 32) times), and the CTAs: f-tiles of 640,
    160 CTAs whatever C, at least the H100's 132 SMs and all resident at
    once (2 a SM)."""
    assert pass_rows(C) == rows
    assert -(-C // rows) == passes <= -(-C // 32)
    assert rows % 8 == 0 and rows <= 40
    assert f_tile(6400) == 640
    assert MoeGmmMember(16, C, 4096, 6400, "silu", True).ctas == 160


@pytest.mark.parametrize("f,ft", [(64, 64), (96, 96), (1024, 512),
                                  (14336, 512), (1536, 512), (6400, 640)])
def test_moe_gmm_f_tile_divides_f(f, ft):
    """Other widths: the largest multiple of 32 dividing f, at most 640."""
    assert f_tile(f) == ft
    assert f % ft == 0 and ft % 32 == 0


@pytest.mark.parametrize("pass_max", [8, 40, 48, 64])
def test_moe_gmm_pass_rows_taken(monkeypatch, pass_max):
    """The kernel is compiled for passes of 8..40 token rows (one body per
    8-row group count), so the member refuses a larger pass before it reads
    an operand (here CPU tensors, refused next).  C = PASS_ROWS: one pass
    of all the rows."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels import moe_gmm as mg
    monkeypatch.setattr(mg, "PASS_ROWS", pass_max)
    op = mg.moe_gmm_op(2, pass_max, 16, 64, torch.bfloat16)
    assert mg.pass_rows(pass_max) == pass_max
    ins = [torch.zeros(o.shape, dtype=o.dtype) for o in op.inputs]
    outs = [torch.zeros(o.shape, dtype=o.dtype) for o in op.outputs]
    want = ("expected a CUDA tensor" if pass_max <= mg.KERNEL_PASS_ROWS
            else "token rows")
    with pytest.raises(ValueError, match=want):
        op.member.pack(cuda.MemberDesc(), ins, outs)
