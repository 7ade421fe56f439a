"""The split layouts of the redesigned members, on the CPU.

Decode attention (``kernels/decode_attention.py``) cuts each slot's cache
into fixed ranges of positions, one CTA each, and combines the ranges' (o,
m, l) in range order; the grouped expert FFN (``kernels/moe_gmm.py``)
picks an f-tile and the token rows a pass holds; the bf16 row GEMM
(``kernels/row.py``) cuts K into slices of whole ring stages, one CTA per
(column tile, row block, slice), and sums the slices in slice order.
Here: the ranges are whole pages and whole warp tiles and cover the cache;
the combine's arithmetic, done in PyTorch on the plain version's per-range
results exactly as the kernel orders it, against the reference's
``decode_attention_op`` in interpret mode on the same numpy inputs; the
FFN's f-tiles, passes and CTA counts; the GEMM's slices, CTAs and
workspace, and its slice sum against the reference's ``matmul_1d_op``, in
both its bf16 and its fp32 form (slices of whole 64-row stages, one (M, N)
fp32 partial per slice).

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
from repro.kernels.matmul import matmul_1d_op as jmatmul_1d
from repro_torch.kernels import cuda, row
from repro_torch.kernels.decode_attention import (
    KV_SPLIT, decode_attention_op, kv_split, n_splits,
    plain_decode_attention)
from repro_torch.kernels.matmul import matmul_1d_op
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


# (M, K, N): (rows a block, blocks, K slice, slices, CTAs) of the bf16 row
# GEMM: granite-3-2b's decode GEMMs (qkv_proj, W_o, gate+up, down), a
# layer's W_o dW (2048 rows, K whole: its 512 tiles alone pass the target),
# the card tests' edges (a part tile, K not a multiple of a stage, 40 rows)
GEMM_GEOMETRY = {
    (8, 2048, 3072): (8, 1, 384, 6, 144),
    (8, 2048, 2048): (8, 1, 192, 11, 176),
    (8, 2048, 16384): (8, 1, 1024, 2, 256),
    (8, 8192, 2048): (8, 1, 960, 9, 144),
    (2048, 8192, 2048): (64, 32, 8192, 1, 512),
    (8, 2048, 64): (8, 1, 64, 32, 32),
    (16, 2056, 192): (16, 1, 64, 33, 66),
    (40, 512, 256): (64, 1, 64, 8, 16),
    (256, 520, 128): (64, 4, 64, 9, 36),
}


@pytest.mark.parametrize("MKN", sorted(GEMM_GEOMETRY))
def test_row_gemm_slices_ctas_and_workspace(MKN):
    """The bf16 row GEMM's geometry: slices of whole 64-row ring stages
    that cover K (the last one part), CTAs = 128-column tiles x row blocks
    x slices, at least the H100's 132 SMs wherever K has stages enough
    (qkv_proj and W_o at decode among them), K whole where the tiles alone
    reach 132; the descriptor's slice fields; and the workspace: one fp32
    (rows, 128) partial per slice, row block and tile (none unsplit), a
    ticket per (row block, tile) and one more, the EPI_ROWS product M x
    N."""
    M, K, N = MKN
    rows, blocks, ksl, ks, ctas = GEMM_GEOMETRY[MKN]
    g = matmul_1d_op(M, K, N, bm=M).member
    assert (row.gemm_rows(M), g.row_blocks, g.k_slice, g.k_slices,
            g.ctas) == (rows, blocks, ksl, ks, ctas)
    bn, kt = row.GEMM_BN, row.GEMM_KT
    assert ksl % kt == 0 and (ks - 1) * ksl < K <= ks * ksl
    tiles = -(-N // bn) * blocks
    assert ctas == tiles * ks
    assert ctas >= row.GEMM_MIN_CTAS or ksl == kt
    if tiles >= row.GEMM_MIN_CTAS:
        assert ks == 1
    if (M, K) == (8, 2048) and N in (2048, 3072):
        assert ctas >= 132
    md = cuda.MemberDesc()
    row._gemm_fields(md, g)
    assert (md.i[4], md.i[7]) == (ksl, ks)
    parts = ks * tiles * rows * bn if ks > 1 else 0
    assert row.gemm_workspace_sizes(g, False) == (
        (parts, tiles + 1, 0) if ks > 1 else (0, 0, 0))
    assert row.gemm_workspace_sizes(g, True) == (parts, tiles + 1, M * N)


@pytest.mark.parametrize("MKN", [(8, 2048, 64), (16, 200, 128),
                                 (40, 520, 64)])
def test_row_gemm_slice_sum_matches_reference(MKN):
    """The split's arithmetic in PyTorch as the kernel orders it: each K
    slice's product in fp32, the slices summed in slice order, rounded to
    bf16, against the reference's matmul_1d_op in interpret mode on the
    same numpy inputs (bf16 tolerance)."""
    M, K, N = MKN
    g = matmul_1d_op(M, K, N, bm=M).member
    assert g.k_slices > 1
    rng = np.random.default_rng(7)
    jx, tx = _both(rng, (M, K), ml_dtypes.bfloat16)
    jw, tw = _both(rng, (K, N), ml_dtypes.bfloat16)
    (want,) = jhfuse.run_single(jmatmul_1d(M, K, N, jnp.bfloat16, bm=M),
                                interpret=True)(jx, jw)
    parts = [tx[:, k:k + g.k_slice].float() @ tw[k:k + g.k_slice].float()
             for k in range(0, K, g.k_slice)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    got = total.to(torch.bfloat16).float().numpy()
    ref = np.asarray(want, np.float32)
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


# (M, K, N) -> (K slice, slices, CTAs) of the fp32 row GEMM: W_o and down
# at decode, the router, gate+up at decode (K whole: its 256 tiles fill the
# card), the stacked norm scales' dW, a narrow N under one tile, a part
# tile with K off the stage, K whole at exactly 132 tiles, and rows past
# one pass
F32_GEMM_GEOMETRY = {
    (8, 2048, 2048): (448, 5, 160),
    (8, 8192, 2048): (1664, 5, 160),
    (8, 4096, 16): (64, 64, 64),
    (8, 2048, 16384): (2048, 1, 256),
    (40, 8192, 2048): (1664, 5, 160),
    (3, 200, 12): (64, 4, 4),
    (40, 1000, 72): (64, 16, 32),
    (8, 520, 8448): (576, 1, 132),
    (136, 520, 128): (64, 9, 18),
}


@pytest.mark.parametrize("MKN", sorted(F32_GEMM_GEOMETRY))
def test_row_gemm_f32_slices_ctas_and_workspace(MKN):
    """The fp32 row GEMM's geometry: slices of whole 64-row ring stages
    that cover K (the last one part), the fewest that bring 64-column tiles
    x slices to the H100's 132 SMs where K has stages enough, K whole where
    the tiles alone reach 132; CTAs = tiles x slices; the descriptor's
    slice fields; and the persistent workspace: one fp32 (M, N) partial per
    slice (none unsplit), a ticket per tile and one more, the EPI_ROWS
    product M x N in fp32."""
    M, K, N = MKN
    ksl, ks, ctas = F32_GEMM_GEOMETRY[MKN]
    g = matmul_1d_op(M, K, N, torch.float32, bm=M).member
    assert (g.row_blocks, g.k_slice, g.k_slices, g.ctas) == (1, ksl, ks,
                                                             ctas)
    kt = row.F32_KT
    assert ksl % kt == 0 and (ks - 1) * ksl < K <= ks * ksl
    tiles = -(-N // row.GEMM_TN)
    assert ctas == tiles * ks
    assert ctas >= row.GEMM_MIN_CTAS or ksl == kt
    assert (ks == 1) == (tiles >= row.GEMM_MIN_CTAS or K <= kt)
    md = cuda.MemberDesc()
    row._gemm_fields(md, g)
    assert (md.i[4], md.i[6], md.i[7]) == (ksl, 1, ks)
    parts = ks * M * N if ks > 1 else 0
    assert row.gemm_workspace_sizes(g, False) == (
        (parts, tiles + 1, 0) if ks > 1 else (0, 0, 0))
    assert row.gemm_workspace_sizes(g, True) == (parts, tiles + 1, M * N)


@pytest.mark.parametrize("MKN", [(8, 2048, 64), (3, 200, 12),
                                 (40, 1000, 72), (8, 4096, 16)])
def test_row_gemm_f32_slice_sum_matches_reference(MKN):
    """The fp32 split's arithmetic in PyTorch as the kernel orders it: each
    K slice's product in fp32, the slices summed in slice order, against
    the reference's matmul_1d_op(dtype=float32) in interpret mode on the
    same numpy inputs (fp32 tolerance; the weight at 1/sqrt(K), as the
    card tests draw it)."""
    M, K, N = MKN
    g = matmul_1d_op(M, K, N, torch.float32, bm=M).member
    assert g.k_slices > 1
    rng = np.random.default_rng(11)
    jx, tx = _both(rng, (M, K), np.float32)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    (want,) = jhfuse.run_single(jmatmul_1d(M, K, N, jnp.float32, bm=M),
                                interpret=True)(jx, jw)
    total = None
    for k in range(0, K, g.k_slice):
        part = tx[:, k:k + g.k_slice] @ tw[k:k + g.k_slice]
        total = part if total is None else total + part
    ref = np.asarray(want, np.float32)
    np.testing.assert_allclose(total.numpy(), ref, rtol=1e-5, atol=1e-5)
