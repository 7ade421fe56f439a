"""The port's kernel modules against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through the JAX op (its Pallas
body in interpret mode, ``hfuse.run_single(op, interpret=True)``) and the
port's op (which, for CPU tensors, runs its kernel's plain PyTorch
version).  Both packages' OpSpecs must also carry identical planning
metadata (grid, blocks, flops, bytes), since the planner reads it.

Tolerances: fp32 inputs 1e-5 relative and absolute (same math, other
summation order); bf16 inputs 2e-2 of the largest reference value (bf16
rounds at other points in the two frameworks).
"""
from __future__ import annotations

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hfuse as jhfuse
from repro.core import op_spec as jop_spec
from repro.core import stitch as jstitch
from repro.core.cost_model import Schedule as JSchedule
from repro.kernels import elementwise as jel
from repro.kernels.decode_attention import decode_attention_op as jdecode
from repro.kernels.matmul import matmul_1d_op as jmatmul
from repro.kernels.prefill_attention import prefill_attention_op as jprefill
from repro.kernels.rmsnorm import rmsnorm_op as jrmsnorm
from repro_torch.core import hfuse, op_spec, stitch
from repro_torch.core.cost_model import Schedule
from repro_torch.kernels import elementwise as tel
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.kernels.matmul import matmul_1d_op
from repro_torch.kernels.prefill_attention import prefill_attention_op
from repro_torch.kernels.rmsnorm import rmsnorm_op

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _arrays(rng, shape, np_dtype, scale=1.0):
    """One numpy array, handed to JAX and torch bit-identically."""
    a = (rng.normal(size=shape) * scale).astype(np_dtype)
    if np_dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.float32


def _assert_match(j_outs, t_outs, tol):
    assert len(j_outs) == len(t_outs)
    for a, b in zip(j_outs, t_outs):
        ref = np.asarray(a, np.float32)
        got = b.float().numpy()
        assert got.shape == ref.shape
        if tol >= 1e-3:             # bf16: relative to the largest value
            scale = max(np.abs(ref).max(), 1e-6)
            assert np.abs(got - ref).max() <= tol * scale
        else:
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _planning(op):
    """The metadata the planner reads, framework-neutral."""
    return {"name": op.name, "grid": op.grid, "flops": op.flops,
            "hbm_bytes": op.hbm_bytes, "vmem_bytes": op.vmem_bytes,
            "blocks": [(tuple(o.shape), tuple(o.block_shape),
                        tuple(int(c) for c in o.index_map(op.grid - 1)))
                       for o in (*op.inputs, *op.outputs)],
            "names": (op.in_names, op.out_names), "bound": op.bound,
            "chain": op.chain}


def _run_both(jop, top, j_ins, t_ins):
    j_outs = jhfuse.run_single(jop, interpret=True)(*j_ins)
    t_outs = hfuse.run_single(top)(*t_ins)
    assert _planning(jop) == _planning(top)
    return j_outs, t_outs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_op(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    jx, tx = _arrays(rng, (16, 64), _np_dtype(dtype))
    js, ts = _arrays(rng, (1, 64), np.float32, 0.5)
    _assert_match(*_run_both(jrmsnorm(16, 64, jdt, bm=8),
                             rmsnorm_op(16, 64, tdt, bm=8),
                             (jx, js), (tx, ts)), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_1d_op(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    jx, tx = _arrays(rng, (16, 64), _np_dtype(dtype))
    jw, tw = _arrays(rng, (64, 192), _np_dtype(dtype), 1 / 8)
    _assert_match(*_run_both(jmatmul(16, 64, 192, jdt, bm=8),
                             matmul_1d_op(16, 64, 192, tdt, bm=8),
                             (jx, jw), (tx, tw)), tol)


@pytest.mark.parametrize("act", ["silu_gate", "gelu_gate", "gelu_plain",
                                 "relu2"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_activation_op(dtype, act):
    jdt, tdt, tol = DTYPES[dtype]
    gated = act.endswith("_gate")
    f_in, f_out = (256, 128) if gated else (128, 128)
    rng = np.random.default_rng(2)
    jh, th = _arrays(rng, (8, f_in), _np_dtype(dtype), 2.0)
    _assert_match(*_run_both(
        jel.activation_op(8, f_in, f_out, getattr(jel, act), jdt, bm=8),
        tel.activation_op(8, f_in, f_out, getattr(tel, act), tdt, bm=8),
        (jh,), (th,)), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_norm_matmul_chain(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    jx, tx = _arrays(rng, (8, 64), _np_dtype(dtype))
    js, ts = _arrays(rng, (1, 64), np.float32, 0.5)
    jw, tw = _arrays(rng, (64, 192), _np_dtype(dtype), 1 / 8)
    jc = jstitch.stitch(jrmsnorm(8, 64, jdt, bm=8),
                        jmatmul(8, 64, 192, jdt, bm=8), "x")
    tc = stitch.stitch(rmsnorm_op(8, 64, tdt, bm=8),
                       matmul_1d_op(8, 64, 192, tdt, bm=8), "x")
    assert (tc.member.producer.sub, tc.member.consumer.sub) == ("rmsnorm",
                                                                "gemm")
    _assert_match(*_run_both(jc, tc, (jx, js, jw), (tx, ts, tw)), tol)


@pytest.mark.parametrize("act", ["silu_gate", "relu2"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_activation_chain(dtype, act):
    jdt, tdt, tol = DTYPES[dtype]
    gated = act == "silu_gate"
    n = 256 if gated else 128
    rng = np.random.default_rng(4)
    jx, tx = _arrays(rng, (8, 64), _np_dtype(dtype))
    jw, tw = _arrays(rng, (64, n), _np_dtype(dtype), 1 / 8)
    jc = jstitch.stitch(jmatmul(8, 64, n, jdt, bm=8),
                        jel.activation_op(8, n, 128, getattr(jel, act), jdt,
                                          bm=8), "h")
    tc = stitch.stitch(matmul_1d_op(8, 64, n, tdt, bm=8),
                       tel.activation_op(8, n, 128, getattr(tel, act), tdt,
                                         bm=8), "h")
    assert tc.member.consumer.act == act
    _assert_match(*_run_both(jc, tc, (jx, jw), (tx, tw)), tol)


def test_unsupported_chain_raises():
    """rmsnorm->activation stitches, as in the reference, and matches the
    reference chain in both dtypes; a pair the reference refuses (a grid
    mismatch) still raises, with the reference's reason."""
    for dtype, (jdt, tdt, tol) in sorted(DTYPES.items()):
        rng = np.random.default_rng(5)
        jx, tx = _arrays(rng, (8, 64), _np_dtype(dtype))
        js, ts = _arrays(rng, (1, 64), np.float32, 0.5)
        jc = jstitch.stitch(jrmsnorm(8, 64, jdt, bm=8),
                            jel.activation_op(8, 64, 64, jel.relu2, jdt,
                                              bm=8, name="act"), "h")
        norm = rmsnorm_op(8, 64, tdt, bm=8)
        act = tel.activation_op(8, 64, 64, tel.relu2, tdt, bm=8, name="act")
        assert stitch.can_stitch(norm, act, "h") is None
        tc = stitch.stitch(norm, act, "h")
        assert (tc.member.producer.sub, tc.member.consumer.sub) == (
            "rmsnorm", "act")
        _assert_match(*_run_both(jc, tc, (jx, js), (tx, ts)), tol)
        act4 = tel.activation_op(8, 64, 64, tel.relu2, tdt, bm=4,
                                 name="act")
        jact4 = jel.activation_op(8, 64, 64, jel.relu2, jdt, bm=4,
                                  name="act")
        reason = stitch.can_stitch(norm, act4, "h")
        assert reason == jstitch.can_stitch(jrmsnorm(8, 64, jdt, bm=8),
                                            jact4, "h")
        with pytest.raises(ValueError, match="grid mismatch"):
            stitch.stitch(norm, act4, "h")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_op(dtype, seed):
    """Per-slot lengths 1..S (one slot at each end and one between)."""
    jdt, tdt, tol = DTYPES[dtype]
    B, S, H, Hkv, D, ck = 3, 64, 4, 2, 16, 16
    rng = np.random.default_rng(10 + seed)
    lens = np.asarray([[1], [rng.integers(2, S)], [S]], np.int32)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens.copy())
    jq, tq = _arrays(rng, (B, H, D), _np_dtype(dtype))
    jk, tk = _arrays(rng, (B, S, Hkv, D), _np_dtype(dtype))
    jv, tv = _arrays(rng, (B, S, Hkv, D), _np_dtype(dtype))
    _assert_match(*_run_both(
        jdecode(B, S, H, Hkv, D, jdt, ck=ck, dynamic_length=True),
        decode_attention_op(B, S, H, Hkv, D, tdt, ck=ck, dynamic_length=True),
        (jl, jq, jk, jv), (tl, tq, tk, tv)), max(tol, 1e-5))


@pytest.mark.parametrize("C,off", [(8, 0), (8, 23), (5, 40)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_attention_op(dtype, C, off):
    """off = 0, off > 0 mid-prefix, and a partial chunk (C=5)."""
    jdt, tdt, tol = DTYPES[dtype]
    S, H, Hkv, D, ck = 64, 4, 2, 16, 16
    rng = np.random.default_rng(20 + off)
    offa = np.full((1, 1), off, np.int32)
    jq, tq = _arrays(rng, (C, H, D), _np_dtype(dtype))
    jk, tk = _arrays(rng, (S, Hkv, D), _np_dtype(dtype))
    jv, tv = _arrays(rng, (S, Hkv, D), _np_dtype(dtype))
    _assert_match(*_run_both(
        jprefill(C, S, H, Hkv, D, jdt, ck=ck),
        prefill_attention_op(C, S, H, Hkv, D, tdt, ck=ck),
        (jnp.asarray(offa), jq, jk, jv),
        (torch.from_numpy(offa.copy()), tq, tk, tv)), max(tol, 1e-5))


def test_shrink_variants_match_reference():
    """Block shrinking (the autotuner's variants) gives the reference's
    grids and blocks, and the port's result does not change with them."""
    f32 = torch.float32
    pairs = [(jrmsnorm(16, 64, jnp.float32, bm=16),
              rmsnorm_op(16, 64, f32, bm=16)),
             (jmatmul(16, 64, 128, jnp.float32, bm=16),
              matmul_1d_op(16, 64, 128, f32, bm=16)),
             (jprefill(8, 128, 4, 2, 16, jnp.float32, ck=64),
              prefill_attention_op(8, 128, 4, 2, 16, f32, ck=64)),
             (jdecode(2, 128, 4, 2, 16, jnp.float32, ck=64,
                      dynamic_length=True),
              decode_attention_op(2, 128, 4, 2, 16, f32, ck=64,
                                  dynamic_length=True))]
    for jop, top in pairs:
        js, ts = jop_spec.shrink_blocks(jop, 2), op_spec.shrink_blocks(top, 2)
        assert (js is None) == (ts is None)
        if js is not None:
            assert _planning(js) == _planning(ts)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    big = matmul_1d_op(16, 64, 128, f32, bm=16)
    small = op_spec.shrink_blocks(big, 2)
    assert small.grid == 2 * big.grid
    assert torch.equal(hfuse.run_single(small)(x, w)[0],
                       hfuse.run_single(big)(x, w)[0])


@pytest.mark.parametrize("ratios", [(1, 1), (2, 1), (1, 3)])
def test_fused_bundle_matches_reference(ratios):
    """decode attention + prefill attention + the FFN chain as one bundle:
    the port's fused call equals the JAX fused Pallas call."""
    B, S, H, Hkv, D, ck, C = 2, 64, 4, 2, 16, 16, 8
    f32 = jnp.float32
    rng = np.random.default_rng(30)
    lens = np.asarray([[5], [S]], np.int32)
    dec_j, dec_t = zip(*[(jnp.asarray(lens), torch.from_numpy(lens.copy())),
                         _arrays(rng, (B, H, D), np.float32),
                         _arrays(rng, (B, S, Hkv, D), np.float32),
                         _arrays(rng, (B, S, Hkv, D), np.float32)])
    offa = np.full((1, 1), 16, np.int32)
    pf_j, pf_t = zip(*[(jnp.asarray(offa), torch.from_numpy(offa.copy())),
                       _arrays(rng, (C, H, D), np.float32),
                       _arrays(rng, (S, Hkv, D), np.float32),
                       _arrays(rng, (S, Hkv, D), np.float32)])
    jops = (jdecode(B, S, H, Hkv, D, f32, ck=ck, dynamic_length=True),
            jprefill(C, S, H, Hkv, D, f32, ck=ck))
    tops = (decode_attention_op(B, S, H, Hkv, D, torch.float32, ck=ck,
                                dynamic_length=True),
            prefill_attention_op(C, S, H, Hkv, D, torch.float32, ck=ck))
    j_outs = jhfuse.generate(jops, JSchedule(ratios), interpret=True)(
        *dec_j, *pf_j)
    t_outs = hfuse.generate(tops, Schedule(ratios))(*dec_t, *pf_t)
    _assert_match(j_outs, t_outs, 1e-5)
    native = hfuse.run_native(tops)(*dec_t, *pf_t)
    assert all(torch.equal(a, b) for a, b in zip(t_outs, native))


def test_member_geometry():
    """CTAs per member at the full-width shapes: qkv 3072/128 column
    tiles x 6 K slices of 384 rows (the last 128), the gated FFN chain
    8192/64 column pairs (64 gate, 64 up) x 2 K slices, one CTA per (slot,
    KV head, 256-position split) for decode, contiguous and paged, and per
    (64 rows of the group's 512 query rows x 4 heads, KV head) for prefill
    on the tensor cores."""
    bf = torch.bfloat16
    assert matmul_1d_op(8, 2048, 3072, bf, bm=8).ctas == 144
    ffn = stitch.stitch(matmul_1d_op(8, 2048, 16384, bf, bm=8),
                        tel.activation_op(8, 16384, 8192, tel.silu_gate, bf,
                                          bm=8), "h")
    assert ffn.ctas == 256
    assert rmsnorm_op(8, 2048, bf, bm=8).ctas == 8
    assert decode_attention_op(8, 2048, 32, 8, 64, bf,
                               dynamic_length=True).ctas == 512
    assert decode_attention_op(8, 2048, 32, 8, 64, bf, dynamic_length=True,
                               block_table=(8 * 128 + 8, 16)).ctas == 512
    assert prefill_attention_op(512, 2048, 32, 8, 64, bf).ctas == 256
    # a part last tile: 100 positions x rep 3 = 300 rows, 5 tiles of 64
    assert prefill_attention_op(100, 256, 6, 2, 72, bf, ck=256).ctas == 10


@pytest.mark.parametrize("rows", [16, 32, 48, 64, 128, 256])
def test_prefill_rows_per_cta_taken(monkeypatch, rows):
    """The tile loop splits its 8 warps into rows / 16 row groups, so the
    member packs 16, 32, 64 or 128 rows a CTA and refuses any other count
    before it reads an operand (here CPU tensors, refused next)."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels import prefill_attention as pa
    monkeypatch.setattr(pa, "ROWS_PER_CTA", rows)
    op = prefill_attention_op(64, 256, 4, 2, 16, torch.bfloat16, ck=256)
    ins = [torch.zeros(o.shape, dtype=o.dtype) for o in op.inputs]
    outs = [torch.zeros(o.shape, dtype=o.dtype) for o in op.outputs]
    want = ("expected a CUDA tensor" if rows in pa.ROWS_TAKEN
            else "rows a CTA")
    with pytest.raises(ValueError, match=want):
        op.member.pack(cuda.MemberDesc(), ins, outs)


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9hf_bundleILb0EEv10BundleDesc' for 'sm_90a'
ptxas info    : Function properties for _Z11prefill_mmaILi64EEvRK10MemberDesci
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Z9hf_bundleILb0EEv10BundleDesc
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z16flash_mma_kernelILi64EEvPK13__nv_bfloat16S2_S2_PS0_iiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_mma_kernelILi64EEvPK13__nv_bfloat16S2_S2_PS0_iiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9hf_bundleILb1EEv10BundleDesc' for 'sm_90a'
ptxas info    : Function properties for _Z11prefill_mmaILi64EEvRK10MemberDesci
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Function properties for _Z9hf_bundleILb1EEv10BundleDesc
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers
"""


def test_parse_ptxas():
    """The build report's registers, stack and spills per function (the
    bundle instances', the flash kernels' and the non-inlined members'; a
    member compiled into both instances keeps its larger figures)."""
    from repro_torch.kernels import cuda
    got = cuda.parse_ptxas(PTXAS_REPORT)
    assert got["_Z9hf_bundleILb0EEv10BundleDesc"] == dict(
        stack=8, spill_stores=4, spill_loads=8, registers=128)
    assert got["_Z11prefill_mmaILi64EEvRK10MemberDesci"] == dict(
        stack=16, spill_stores=4, spill_loads=4)
    assert got["_Z9hf_bundleILb1EEv10BundleDesc"] == dict(
        stack=0, spill_stores=0, spill_loads=0, registers=126)
    flash = [v for k, v in got.items() if "flash_mma_kernel" in k]
    assert flash == [dict(stack=0, spill_stores=0, spill_loads=0,
                          registers=110)]
