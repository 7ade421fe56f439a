"""The port's public kernel entry points (``repro_torch.kernels.ops``) and
the residual-add op with its matmul chain, against the JAX package's, on
the CPU.

The same inputs, made from a numpy seed, go through ``repro.kernels.ops``
in interpret mode (``ops.force("interpret")``, restored by a fixture) and
through the port's ``ops``, which for CPU tensors runs each kernel's plain
PyTorch version.  The cases are the shapes of
``tests/test_kernels_framework.py``; beside them the reference's shape
refusals, the residual-add op's planning metadata and its matmul chain
(``can_stitch`` decisions and outputs), and a reduced-width granite layer
built from the ops in both packages.

Tolerances: fp32 1e-5 relative and absolute (same math, other summation
order); bf16 2e-2 of the largest reference value (bf16 rounds at other
points in the two frameworks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hfuse as jhfuse
from repro.core import stitch as jstitch
from repro.kernels import elementwise as jel
from repro.kernels import ops as jops
from repro.kernels.matmul import matmul_1d_op as jmatmul_op
from repro_torch import tree
from repro_torch.core import hfuse, stitch
from repro_torch.kernels import elementwise as tel
from repro_torch.kernels import ops
from repro_torch.kernels.matmul import matmul_1d_op

DTYPES = {"float32": (jnp.float32, torch.float32, np.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16,
                       2e-2)}


@pytest.fixture(autouse=True)
def interpret_mode():
    jops.force("interpret")
    yield
    jops.force(None)


def _both(a: np.ndarray):
    """One numpy array as a JAX array and a torch tensor, bit-identical."""
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _normal(rng, shape, np_dtype=np.float32, scale=1.0):
    return _both((rng.normal(size=shape) * scale).astype(np_dtype))


def _assert_match(want, got, tol):
    ref = np.asarray(want, np.float32)
    out = got.float().numpy()
    assert out.shape == ref.shape
    if tol >= 1e-3:                 # bf16: relative to the largest value
        assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1e-6)
    else:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (256, 128, 128, 128, 128, 128),
    (512, 256, 384, 256, 128, 128),
    (128, 512, 256, 128, 256, 256),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul(M, K, N, bm, bn, bk, dtype):
    _jdt, _tdt, np_dt, tol = DTYPES[dtype]
    rng = np.random.default_rng(M + K + N)
    jx, tx = _normal(rng, (M, K), np_dt)
    jw, tw = _normal(rng, (K, N), np_dt, K ** -0.5)
    got = ops.matmul(tx, tw, bm=bm, bn=bn, bk=bk)
    assert got.dtype == tx.dtype
    _assert_match(jops.matmul(jx, jw, bm=bm, bn=bn, bk=bk), got, tol)


@pytest.mark.parametrize("R,d", [(256, 128), (512, 512), (128, 384)])
def test_rmsnorm(R, d):
    rng = np.random.default_rng(R + d)
    jx, tx = _normal(rng, (R, d))
    js, ts = _normal(rng, (d,), scale=0.1)
    _assert_match(jops.rmsnorm(jx, js), ops.rmsnorm(tx, ts), 1e-5)


@pytest.mark.parametrize("S,H,Hkv,D", [(128, 4, 4, 64), (256, 4, 2, 64),
                                       (256, 8, 1, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(S, H, Hkv, D, causal):
    B = 2
    rng = np.random.default_rng(S + H + Hkv + D)
    jq, tq = _normal(rng, (B, S, H, D))
    jk, tk = _normal(rng, (B, S, Hkv, D))
    jv, tv = _normal(rng, (B, S, Hkv, D))
    _assert_match(jops.flash_attention(jq, jk, jv, causal=causal),
                  ops.flash_attention(tq, tk, tv, causal=causal), 1e-5)


@pytest.mark.parametrize("E,C,d,f,act", [(4, 256, 64, 32, "silu"),
                                         (8, 128, 128, 64, "gelu")])
def test_moe_gmm(E, C, d, f, act):
    rng = np.random.default_rng(E + C)
    jx, tx = _normal(rng, (E, C, d))
    jwi, twi = _normal(rng, (E, d, 2 * f), scale=0.1)
    jwo, two = _normal(rng, (E, f, d), scale=0.1)
    _assert_match(jops.moe_gmm(jx, jwi, jwo, act=act),
                  ops.moe_gmm(tx, twi, two, act=act), 1e-5)


@pytest.mark.parametrize("shapes", [
    {"w1": (37, 11), "w2": {"a": (130,)}},           # the reference's tree
    {f"l{i}": (3 + i, 7) for i in range(10)},        # > one bundle's leaves
], ids=["2-leaves", "10-leaves"])
def test_hfused_adamw(shapes):
    """The update equals the reference's; the port updates in place and
    returns its own trees."""
    rng = np.random.default_rng(5)

    def tree_of(fn, t):
        return {k: tree_of(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}

    p = tree_of(lambda s: _normal(rng, s), shapes)
    pick = [lambda pair: pair[0], lambda pair: pair[1]]
    jp, tp = (tree_of(f, p) for f in pick)
    jg = tree_of(lambda x: x * 0.03 + 0.01, jp)
    tg = tree_of(lambda x: x * 0.03 + 0.01, tp)
    jm = tree_of(lambda x: jnp.full_like(x, 0.05), jp)
    tm = tree_of(lambda x: torch.full_like(x, 0.05), tp)
    jv = tree_of(lambda x: jnp.full_like(x, 0.02), jp)
    tv = tree_of(lambda x: torch.full_like(x, 0.02), tp)
    kw = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, bc1=0.1, bc2=0.05)
    want = jops.hfused_adamw(jp, jg, jm, jv, **kw)
    got = ops.hfused_adamw(tp, tg, tm, tv, **kw)
    assert got[0] is tp and got[1] is tm and got[2] is tv
    for w_tree, g_tree in zip(want, got):
        for a, b in zip(jax.tree.leaves(w_tree), tree.leaves(g_tree)):
            _assert_match(a, b, 1e-5)


def test_shape_refusals():
    """What the reference refuses (its tile asserts), the port refuses."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    cases = [
        (lambda o, a: o.matmul(a[0], a[1]),
         [(600, 64), (64, 128)]),                    # 600 % 512
        (lambda o, a: o.matmul(a[0], a[1], bm=128, bn=128, bk=64),
         [(256, 96), (96, 128)]),                    # 96 % 64
        (lambda o, a: o.matmul(a[0], a[1]), [(256, 64), (32, 128)]),  # K
        (lambda o, a: o.rmsnorm(a[0], a[1]), [(384, 128), (128,)]),   # % 256
        (lambda o, a: o.flash_attention(a[0], a[1], a[2]),
         [(1, 768, 2, 64), (1, 768, 2, 64), (1, 768, 2, 64)]),        # % 512
        (lambda o, a: o.moe_gmm(a[0], a[1], a[2]),
         [(2, 200, 32), (2, 32, 64), (2, 32, 32)]),                   # % 128
    ]
    for call, shapes in cases:
        arrays = [_normal(rng, s, f32) for s in shapes]
        with pytest.raises((AssertionError, TypeError, ValueError)):
            call(jops, [j for j, _ in arrays])
        with pytest.raises(ValueError):
            call(ops, [t for _, t in arrays])


# ---------------------------------------------------------------------------
# residual_add_op and the matmul -> residual_add chain
# ---------------------------------------------------------------------------
def _planning(op):
    """The metadata the planner reads, framework-neutral."""
    return {"name": op.name, "grid": op.grid, "flops": op.flops,
            "hbm_bytes": op.hbm_bytes, "vmem_bytes": op.vmem_bytes,
            "tag": op.tag, "chain": op.chain,
            "blocks": [(tuple(o.shape), tuple(o.block_shape),
                        tuple(int(c) for c in o.index_map(op.grid - 1)))
                       for o in (*op.inputs, *op.outputs)],
            "names": (op.in_names, op.out_names), "bound": op.bound}


@pytest.mark.parametrize("R,F,bm", [(32, 128, 16), (8, 64, 256),
                                    (512, 2048, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_residual_add_op(dtype, R, F, bm):
    jdt, tdt, np_dt, tol = DTYPES[dtype]
    jop, top = jel.residual_add_op(R, F, jdt, bm), tel.residual_add_op(
        R, F, tdt, bm)
    assert _planning(jop) == _planning(top)
    rng = np.random.default_rng(R)
    jh, th = _normal(rng, (R, F), np_dt)
    jr, tr = _normal(rng, (R, F), np_dt)
    (want,) = jhfuse.run_single(jop, interpret=True)(jh, jr)
    (got,) = hfuse.run_single(top)(th, tr)
    assert got.dtype == tdt
    _assert_match(want, got, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_residual_add_chain(dtype):
    """At tests/test_stitch.py's shapes: the chain's metadata is the
    reference chain's, its output equals the two ops run separately bit for
    bit and matches the reference chain."""
    jdt, tdt, np_dt, tol = DTYPES[dtype]
    R, K, N, bm = 32, 64, 128, 16
    jc = jstitch.stitch(jmatmul_op(R, K, N, jdt, bm=bm),
                        jel.residual_add_op(R, N, jdt, bm=bm), "h")
    mm = matmul_1d_op(R, K, N, tdt, bm=bm)
    add = tel.residual_add_op(R, N, tdt, bm=bm)
    tc = stitch.stitch(mm, add, "h")
    assert _planning(jc) == _planning(tc)
    assert (tc.member.producer.sub, tc.member.consumer.sub) == ("gemm",
                                                                "resadd")
    assert tc.member.producer.fp32 == (tdt == torch.float32)
    rng = np.random.default_rng(7)
    jx, tx = _normal(rng, (R, K), np_dt)
    jw, tw = _normal(rng, (K, N), np_dt)
    jr, tr = _normal(rng, (R, N), np_dt)
    (got,) = hfuse.run_single(tc)(tx, tw, tr)
    (h,) = hfuse.run_single(mm)(tx, tw)
    assert torch.equal(got, hfuse.run_single(add)(h, tr)[0])
    _assert_match(jhfuse.run_single(jc, interpret=True)(jx, jw, jr)[0], got,
                  tol)


def test_can_stitch_matmul_residual_add_like_reference():
    """The port accepts and refuses the matmul -> residual_add pairs the
    reference does, for the same reason."""
    f32, bf16 = (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)
    R, K, N = 32, 64, 128
    pairs = [  # (matmul dtype, bm), (resadd F, dtype, bm), operand
        ((f32, 16), (N, f32, 16), "h"),              # accepted
        ((bf16, 16), (N, bf16, 16), "h"),            # accepted
        ((f32, 16), (N, f32, 8), "h"),               # grid mismatch
        ((f32, 16), (N, bf16, 16), "h"),             # dtype mismatch
        ((f32, 16), (2 * N, f32, 16), "h"),          # element count
        ((f32, 16), (N, f32, 16), "res"),            # operand name clash
        ((f32, 16), (N, f32, 16), "nope"),           # no such input
    ]
    seen = set()
    for (mdt, mbm), (F, adt, abm), operand in pairs:
        j = jstitch.can_stitch(jmatmul_op(R, K, N, mdt[0], bm=mbm),
                               jel.residual_add_op(R, F, adt[0], bm=abm),
                               operand)
        t = stitch.can_stitch(matmul_1d_op(R, K, N, mdt[1], bm=mbm),
                              tel.residual_add_op(R, F, adt[1], bm=abm),
                              operand)
        assert (j is None) == (t is None), (j, t)
        if j is not None:
            assert j.split(":")[0] == t.split(":")[0], (j, t)
        seen.add(j is None)
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# A granite layer built from the ops, at reduced width
# ---------------------------------------------------------------------------
def _layer(o, resadd, glue, x, p, B, S, H, Hkv, D):
    """rmsnorm -> QKV -> flash attention -> W_o -> residual add -> rmsnorm
    -> gate+up -> SwiGLU -> down -> residual add, through ``o`` (either
    package's ops); ``glue`` holds the package's reshape/split helpers."""
    R, d = x.shape
    qkv = o.matmul(o.rmsnorm(x, p["s1"]), p["w_qkv"])
    q = glue["cols"](qkv, 0, H * D).reshape(B, S, H, D)
    k = glue["cols"](qkv, H * D, (H + Hkv) * D).reshape(B, S, Hkv, D)
    v = glue["cols"](qkv, (H + Hkv) * D, (H + 2 * Hkv) * D).reshape(
        B, S, Hkv, D)
    a = o.flash_attention(q, k, v, causal=True).reshape(R, H * D)
    x2 = resadd(o.matmul(a, p["w_o"]), x)
    h = glue["silu_gate"](o.matmul(o.rmsnorm(x2, p["s2"]), p["w_in"]))
    return resadd(o.matmul(h, p["w_out"]), x2)


def test_ops_layer_matches_reference():
    B, S, d, H, Hkv, D, f = 2, 128, 64, 4, 2, 16, 128
    R = B * S
    rng = np.random.default_rng(11)
    shapes = {"s1": ((d,), 0.1), "s2": ((d,), 0.1),
              "w_qkv": ((d, (H + 2 * Hkv) * D), d ** -0.5),
              "w_o": ((H * D, d), (H * D) ** -0.5),
              "w_in": ((d, 2 * f), d ** -0.5), "w_out": ((f, d), f ** -0.5)}
    pairs = {k: _normal(rng, s, scale=sc) for k, (s, sc) in shapes.items()}
    jx, tx = _normal(rng, (R, d))

    def jresadd(h, res):
        op = jel.residual_add_op(R, d, jnp.float32)
        return jhfuse.run_single(op, interpret=True)(h, res)[0]

    def tresadd(h, res):
        return hfuse.run_single(tel.residual_add_op(R, d, torch.float32))(
            h, res)[0]

    jglue = {"cols": lambda t, a, b: t[:, a:b],
             "silu_gate": lambda h: jel.silu_gate(h).astype(h.dtype)}
    tglue = {"cols": lambda t, a, b: t[:, a:b].contiguous(),
             "silu_gate": lambda h: tel.silu_gate(h).to(h.dtype)}
    dims = (B, S, H, Hkv, D)
    want = _layer(jops, jresadd, jglue, jx,
                  {k: j for k, (j, _) in pairs.items()}, *dims)
    got = _layer(ops, tresadd, tglue, tx,
                 {k: t for k, (_, t) in pairs.items()}, *dims)
    _assert_match(want, got, 1e-5)
