"""The port's stitching contract against the JAX package's, on the CPU.

  * The sweep: 100 producer -> consumer.operand pairs over the library ops
    at R 64, d 256, bm 64 — bf16 rmsnorm, activation (silu_gate 2d->d and
    gelu_plain d->d), residual add, ``matmul_1d_op`` d->d and d->2d, each
    producer into every operand of every consumer (60 pairs), and their
    fp32 forms (rmsnorm, residual add, both matmuls) into the fp32
    consumers and ``adamw_op``'s g and p (40 pairs).  ``can_stitch`` accepts
    exactly the pairs the reference accepts and gives the reference's
    reason for the others, and ``planner.plan`` over the two-op graph that
    declares the pair gives the reference's members.
  * Every accepted pair's chain (its plain route, the CPU side of the row
    kernel's chain member) against the reference chain in interpret mode on
    the same numpy inputs: bitwise in fp32 where both members compute
    element by element in one order (the activation, the residual add);
    within 1e-5 relative and absolute in fp32 where the frameworks round
    apart (the norm's mean square and the GEMM's K-sum are summed in other
    orders, AdamW's constants are folded differently); within 2e-2
    of the largest reference value in bf16 (bf16 rounds at other points in
    the two frameworks).  Each chain also equals its two ops run
    separately, bit for bit.
  * The reduced-width ``plan_update_fusion`` program (granite-3-2b, tokens
    64: five dW->adamw chains and three updates, in bf16 and in fp32)
    compiled with each package's ``executor.compile_plan`` and run on the
    same inputs: equal p, m and v within the tolerances above.  In bf16 the
    params are drawn at 0.01, where the update (about 3e-3 at these
    scalars) moves each by tens of bf16 steps, and p is held through its
    change p_out - p_in against the reference's change, to 2e-2 of the
    largest reference change: drawn at 1, one bf16 step of p (2^-7) is
    larger than the update, and p itself would hide a missing update.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import executor as jexecutor
from repro.core import hfuse as jhfuse
from repro.core import planner as jplanner
from repro.core import stitch as jstitch
from repro.kernels import adam as jadam
from repro.kernels import elementwise as jel
from repro.kernels.matmul import matmul_1d_op as jmatmul
from repro.kernels.rmsnorm import rmsnorm_op as jrmsnorm
from repro.models import lm as jlm
from repro.train import train_loop as jtl
from repro_torch.configs import get_config
from repro_torch.core import executor, hfuse, planner, stitch
from repro_torch.kernels import adam
from repro_torch.kernels import elementwise as tel
from repro_torch.kernels import row
from repro_torch.kernels.matmul import matmul_1d_op
from repro_torch.kernels.rmsnorm import rmsnorm_op
from repro_torch.models import lm
from repro_torch.train import train_loop as tl

R, D, BM = 64, 256, 64
BF = (jnp.bfloat16, torch.bfloat16)
F32 = (jnp.float32, torch.float32)


def _ops(dt, jax_side: bool) -> dict:
    """The sweep's ops of one dtype, built by one package."""
    j = 0 if jax_side else 1
    rms, mm = (jrmsnorm, rmsnorm_op)[j], (jmatmul, matmul_1d_op)[j]
    el = (jel, tel)[j]
    d = dt[j]
    ops = {"rmsnorm": rms(R, D, d, bm=BM),
           "resadd": el.residual_add_op(R, D, d, bm=BM, name="resadd"),
           "mm_dd": mm(R, D, D, d, bm=BM),
           "mm_d2d": mm(R, D, 2 * D, d, bm=BM)}
    if dt is BF:
        ops["act_silu"] = el.activation_op(R, 2 * D, D, el.silu_gate, d,
                                           bm=BM, name="act_silu")
        ops["act_gelu"] = el.activation_op(R, D, D, el.gelu_plain, d,
                                           bm=BM, name="act_gelu")
    else:
        ops["adamw"] = (jadam, adam)[j].adamw_op(R * D // 128, d,
                                                  bm=R * D // 128,
                                                  name="adamw")
    return {k: dataclasses.replace(o, name=k) for k, o in ops.items()}


def _pairs():
    out = []
    for tag, dt in (("bf16", BF), ("fp32", F32)):
        ops = _ops(dt, jax_side=False)
        producers = [k for k in ops if k != "adamw"]
        for p in producers:
            for c, cop in ops.items():
                names = ("g", "p") if c == "adamw" else cop.in_names
                out.extend((tag, p, c, n) for n in names)
    return out


PAIRS = _pairs()
SWEEP_IDS = [f"{t}-{p}-{c}.{n}" for t, p, c, n in PAIRS]
DTYPE_OF = {"bf16": BF, "fp32": F32}


def _sweep_ops(tag, p, c, _operand=None):
    """((jax producer, jax consumer), (port producer, port consumer)); the
    consumer renamed when the pair is an op into itself."""
    dt = DTYPE_OF[tag]
    out = []
    for jax_side in (True, False):
        ops = _ops(dt, jax_side)
        cons = ops[c] if c != p else dataclasses.replace(ops[c],
                                                         name=f"{c}_2")
        out.append((ops[p], cons))
    return out


def test_sweep_has_100_pairs():
    assert len(PAIRS) == 100
    accepted = [pr for pr in PAIRS
                if stitch.can_stitch(*_sweep_ops(*pr)[1], pr[3]) is None]
    # 11 pairs of the three decode-era bodies (rmsnorm->gemm, gemm->act,
    # gemm->resadd) and the dW-shaped gemm->adamw; 26 the general chain
    # member runs
    assert len(accepted) == 37


@pytest.mark.parametrize("pair", PAIRS, ids=SWEEP_IDS)
def test_can_stitch_matches_reference(pair):
    (jp, jc), (tp, tc) = _sweep_ops(*pair)
    want = jstitch.can_stitch(jp, jc, pair[3])
    got = stitch.can_stitch(tp, tc, pair[3])
    assert (got is None) == (want is None), (got, want)
    if want is not None:        # the same check refuses (dtypes print apart)
        assert got.split(":")[0] == want.split(":")[0]


def _graph(mod, p, c, operand):
    prod = dataclasses.replace(p, epilogue=(c.name, operand))
    return [mod.GraphOp(prod), mod.GraphOp(c, deps=frozenset({p.name}))]


@pytest.mark.parametrize("pair", PAIRS, ids=SWEEP_IDS)
def test_plan_matches_reference(pair):
    (jp, jc), (tp, tc) = _sweep_ops(*pair)
    want = jplanner.plan(_graph(jplanner, jp, jc, pair[3]))
    got = planner.plan(_graph(planner, tp, tc, pair[3]))
    assert [r["members"] for r in got.summary()] == \
        [r["members"] for r in want.summary()]
    assert got.singles == want.singles


# ---------------------------------------------------------------------------
# every accepted chain against the reference chain
# ---------------------------------------------------------------------------
ACCEPTED = [pr for pr in PAIRS
            if stitch.can_stitch(*_sweep_ops(*pr)[1], pr[3]) is None]
# ops whose fp32 result the two frameworks round apart: a sum in another
# order (the norm's mean square, the GEMM's K-sum) or AdamW's constants
# (folded into the reference's kernel, runtime values in the port's)
APART = ("rmsnorm", "mm_dd", "mm_d2d", "adamw")


def _inputs(op, rng, tag):
    """Numpy inputs of an OpSpec by operand name, in the op's dtypes."""
    out = []
    for name, o in zip(op.in_names, op.inputs):
        shape = tuple(o.shape)
        if name == "scalars":
            a = np.zeros(shape)
            a[0, :3] = (1e-3, 0.1, 0.05)
        elif name == "v":
            a = rng.uniform(size=shape)
        elif name == "scale":
            a = rng.normal(size=shape) * 0.3
        elif name == "w":
            a = rng.normal(size=shape) * shape[0] ** -0.5
        else:
            a = rng.normal(size=shape)
        np_dt = np.float32 if (name in ("scale", "scalars", "m", "v")
                               or tag == "fp32") else ml_dtypes.bfloat16
        out.append(a.astype(np_dt))
    return out


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("pair", ACCEPTED,
                         ids=[f"{t}-{p}-{c}.{n}" for t, p, c, n in ACCEPTED])
def test_chain_matches_reference(pair):
    tag, p, c, operand = pair
    (jp, jc), (tp, tc) = _sweep_ops(*pair)
    jchain = jstitch.stitch(jp, jc, operand)
    tchain = stitch.stitch(tp, tc, operand)
    assert isinstance(tchain.member, row.RowChain)
    assert tchain.in_names == jchain.in_names
    rng = np.random.default_rng(PAIRS.index(pair))
    arrs = _inputs(tchain, rng, tag)
    want = jhfuse.run_single(jchain, interpret=True)(
        *[jnp.asarray(a) for a in arrs])
    got = hfuse.run_single(tchain)(*[_torch(a) for a in arrs])
    for w, g in zip(want, got):
        ref, out = np.asarray(w, np.float32), g.float().numpy()
        assert out.shape == ref.shape
        if tag == "bf16":
            assert np.abs(out - ref).max() <= 2e-2 * max(np.abs(ref).max(),
                                                         1e-6)
        elif p in APART or c in APART:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        else:
            assert np.array_equal(out, ref)
    # the chain equals its two ops run separately, bit for bit
    n_pi = len(tp.inputs)
    ins = [_torch(a) for a in arrs]
    sep = list(hfuse.run_single(tp)(*ins[:n_pi]))
    sidx = tc.in_names.index(operand)
    cins = ins[n_pi:]
    mid = sep[0].reshape(tc.inputs[sidx].shape)
    sep = hfuse.run_single(tc)(*cins[:sidx], mid, *cins[sidx:])
    got2 = hfuse.run_single(tchain)(*[_torch(a) for a in arrs])
    assert all(torch.equal(a, b) for a, b in zip(got2, sep))


# ---------------------------------------------------------------------------
# the reduced-width update program with its dW -> adamw chains
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_update_program_with_dw_chains_matches_reference(dtype):
    jcfg, tcfg = (dataclasses.replace(get("granite-3-2b").reduced(),
                                      dtype=dtype)
                  for get in (jget_config, get_config))
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(tcfg)
    jplan = jtl.plan_update_fusion(ja, tokens=64)
    tplan = tl.plan_update_fusion(ta, tokens=64)
    chains = [m for m in tplan.singles if "→" in m]
    assert len(chains) == 5
    assert [r["members"] for r in tplan.summary()] == \
        [r["members"] for r in jplan.summary()]
    jprog = jexecutor.compile_plan(jplan, interpret=True)
    tprog = executor.compile_plan(tplan)
    assert tprog.describe() == jprog.describe()
    # one state for both: every operand of every op, by the default keys
    tag = "bf16" if dtype == "bfloat16" else "fp32"
    rng = np.random.default_rng(16)
    state = {f"{g.op.name}.{n}": a for g in tplan.graph
             for n, a in zip(g.op.in_names, _inputs(g.op, rng, tag))}
    if tag == "bf16":
        for k, a in state.items():
            if k.endswith(".p"):
                state[k] = (a.astype(np.float32) * 0.01).astype(a.dtype)
    jout = jprog({k: jnp.asarray(a) for k, a in state.items()})
    tout = tprog({k: _torch(a) for k, a in state.items()})
    outs = [f"{g.op.name}.{n}" for g in tplan.graph for n in g.op.out_names]
    assert len(outs) == 3 * len(tplan.graph)
    for k in outs:
        ref, got = np.asarray(jout[k], np.float32), tout[k].float().numpy()
        if tag == "bf16" and k.endswith(".p"):
            p_in = state[k].astype(np.float32)
            ref, got = ref - p_in, got - p_in
            assert np.abs(ref).max() >= 16 * 2.0 ** -7 * np.abs(p_in).max(), k
        if tag == "bf16":
            assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max(), k
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
