"""The port's MoE serve path against the JAX package's, on the CPU.

  * Kernel ops: ``moe_gmm_op`` (and ``moe_gmm``, the same member launched
    alone) and the fp32 router ``matmul_1d_op`` run their plain versions
    here; they are held against the reference's Pallas bodies in interpret
    mode on the same numpy inputs, with equal planning metadata.
  * Routing: ``route_from_logits`` gives the reference's dispatch tables
    exactly, capacity overflow (the drop marker) included; ``capacity``;
    ``moe.apply`` against the reference's.
  * Serve: reduced ``phi3.5-moe-rms`` in fp32, batch 3, ``PrefillBudget(
    chunk_rows=8)``: token for token with the JAX engine, with equal
    ``ServeStats.describe()`` (expert hits included) and mid-batch EOS; the
    ``eload`` policy sheds under a skewed router as the reference's does.
  * Launch tables equal the reference's at reduced and full width (8 of
    the 32 layers, planning needs no weights).

Tolerances: fp32 1e-5, or 2e-5 where softmax weights enter (the two
frameworks' fp32 exp differ in the last bits); bf16 2e-2 of the largest
reference value.
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
from repro.core import hfuse as jhfuse
from repro.kernels.matmul import matmul_1d_op as jmatmul
from repro.kernels.moe_gmm import moe_gmm as jmoe_gmm
from repro.kernels.moe_gmm import moe_gmm_op as jmoe_gmm_op
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.core import hfuse
from repro_torch.kernels.matmul import matmul_1d_op
from repro_torch.kernels.moe_gmm import MoeGmmMember, moe_gmm, moe_gmm_op
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.serve import engine
from test_torch_kernels import _assert_match, _planning
from test_torch_serve import _numpy_params

DTYPES = {"float32": (jnp.float32, torch.float32, np.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16,
                       2e-2)}


def _both(a):
    t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16) \
        if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _cfgs(**over):
    return tuple(dataclasses.replace(get("phi3.5-moe-rms").reduced(),
                                     dtype="float32", **over)
                 for get in (jget_config, get_config))


# ---------------------------------------------------------------------------
# Kernel ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_gmm_op_matches_reference(dtype, act, gated):
    jdt, tdt, np_dt, tol = DTYPES[dtype]
    E, C, d, f = 4, 8, 32, 64
    fin = 2 * f if gated else f
    rng = np.random.default_rng(0)
    ins = [_both(a) for a in (
        rng.normal(size=(E, C, d)).astype(np_dt),
        (rng.normal(size=(E, d, fin)) * d ** -0.5).astype(np_dt),
        (rng.normal(size=(E, f, d)) * f ** -0.5).astype(np_dt))]
    jop = jmoe_gmm_op(E, C, d, f, dtype=jdt, act=act, gated=gated)
    top = moe_gmm_op(E, C, d, f, dtype=tdt, act=act, gated=gated)
    assert _planning(jop) == _planning(top)
    assert top.member.ctas == E * (64 // 64)          # one f-tile each
    want = jhfuse.run_single(jop, interpret=True)(*(j for j, _ in ins))
    got = hfuse.run_single(top)(*(t for _, t in ins))
    _assert_match(want, got, tol)
    if gated:
        _assert_match((jmoe_gmm(*(j for j, _ in ins), act=act,
                                interpret=True),),
                      (moe_gmm(*(t for _, t in ins), act=act),), tol)


@pytest.mark.parametrize("E,C,bc", [(4, 8, 128), (2, 12, 8), (16, 80, 128),
                                    (16, 8, 128)])
def test_moe_gmm_op_planning_matches_reference(E, C, bc):
    """The bc clamp-and-round, grid, blocks, costs and names, here at
    phi3.5-moe's full width (d 4096, f 6400) for the two serve shapes."""
    d, f = (4096, 6400) if E == 16 else (32, 16)
    jop = jmoe_gmm_op(E, C, d, f, dtype=jnp.bfloat16, bc=bc)
    top = moe_gmm_op(E, C, d, f, dtype=torch.bfloat16, bc=bc)
    assert _planning(jop) == _planning(top)
    assert (jop.tag, jop.in_names, jop.out_names) == (top.tag, top.in_names,
                                                      top.out_names)
    if E == 16:          # 10 f-tiles of 640 per expert: 160 CTAs
        assert top.member.ctas == 160
        assert top.hbm_bytes / 3.35e12 * 1e3 == pytest.approx(
            0.752 if C == 8 else 0.757, abs=1e-3)


def test_moe_gmm_member_refuses_unsupported_shapes():
    with pytest.raises(ValueError, match="not a multiple of 32"):
        MoeGmmMember(2, 8, 32, 48, "silu", True).ctas


@pytest.mark.parametrize("N", [4, 16, 72])
def test_fp32_router_op_matches_reference(N):
    """matmul_1d_op(M=B, K=d, N=E, dtype=float32): the router's form."""
    M, K = 8, 64
    rng = np.random.default_rng(N)
    ins = [_both(a) for a in (rng.normal(size=(M, K)).astype(np.float32),
                              (rng.normal(size=(K, N)) / 8)
                              .astype(np.float32))]
    jop = jmatmul(M, K, N, jnp.float32, bm=M)
    top = matmul_1d_op(M, K, N, torch.float32, bm=M)
    assert _planning(jop) == _planning(top) and top.member.fp32
    want = jhfuse.run_single(jop, interpret=True)(*(j for j, _ in ins))
    got = hfuse.run_single(top)(*(t for _, t in ins))
    _assert_match(want, got, 1e-5)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,skew", [(1, 0.0), (8, 0.0), (16, 3.0),
                                    (64, 3.0), (512, 1.0)])
def test_route_from_logits_matches_reference(T, skew):
    """Equal dispatch tables, drops from capacity overflow included (the
    reference's marker T, the overflowing expert's row 0 too)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(T)
    lg = rng.normal(size=(T, 4)).astype(np.float32)
    lg[:, 0] += skew
    jr = jmoe.route_from_logits(jcfg, jnp.asarray(lg))
    tr = moe.route_from_logits(tcfg, torch.from_numpy(lg))
    assert np.array_equal(np.asarray(jr.dispatch_idx),
                          tr.dispatch_idx.numpy())
    np.testing.assert_allclose(tr.combine_w.numpy(),
                               np.asarray(jr.combine_w), atol=2e-7)
    np.testing.assert_allclose(float(tr.aux_loss), float(jr.aux_loss),
                               rtol=1e-5)
    if skew:
        assert (tr.dispatch_idx == T).sum() > 0       # real drops
    # the combine (a gather) equals the reference's scatter-add
    C = tr.dispatch_idx.shape[1]
    ye = rng.normal(size=(4, C, 8)).astype(np.float32)
    want = (jnp.zeros((T + 1, 8)).at[jr.dispatch_idx.reshape(-1)].add(
        (jnp.asarray(ye) * jr.combine_w[..., None]).reshape(-1, 8)))[:T]
    got = moe.combine(tr, torch.from_numpy(ye))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_route_ties_go_to_the_lower_expert():
    _jcfg, tcfg = _cfgs()
    r = moe.route_from_logits(tcfg, torch.zeros((5, 4)))
    assert r.expert.tolist() == [[0, 1]] * 5


@pytest.mark.parametrize("n", [1, 3, 8, 16, 512, 2048])
def test_capacity_matches_reference(n):
    for cfg in (dataclasses.replace(jget_config("phi3.5-moe-rms")),
                jget_config("phi3.5-moe-rms").reduced()):
        tcfg = dataclasses.replace(get_config("phi3.5-moe-rms"))
        if cfg.name.endswith("-smoke"):
            tcfg = tcfg.reduced()
        assert moe.capacity(tcfg, n) == jmoe.capacity(cfg, n)
        assert moe.capacity(tcfg, n, block=1) == jmoe.capacity(cfg, n,
                                                                block=1)


def test_moe_apply_matches_reference():
    jcfg, tcfg = _cfgs()
    tree = _numpy_params(jcfg)
    run = jlm.layer_runs(jcfg)[0].name
    p = tree[run]["moe"]
    x = np.random.default_rng(4).normal(size=(2, 8, 64)).astype(np.float32)
    jy, jaux = jmoe.apply(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x))
    ty, taux = moe.apply(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    tree = _numpy_params(jcfg)
    return (jcfg, tcfg, tree, jax.tree_util.tree_map(jnp.asarray, tree),
            lm.params_from_numpy(tcfg, tree, device="cpu"))


def _pair(weights, batch=3, budget=None, tree=None):
    jcfg, tcfg, tree0, jp, tp = weights
    if tree is not None:
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        tp = lm.params_from_numpy(tcfg, tree, device="cpu")
    budget = budget or dict(chunk_rows=8, max_coresident_chunks=2)
    je = jengine.ServeEngine(jcfg, jp, batch=batch, max_len=48,
                             plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget))
    te = engine.ServeEngine(tcfg, tp, batch=batch, max_len=48, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget))
    return je, te


def _requests(mod, vocab, lens, buds, eos=None, seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m, eos_token=eos)
            for i, (L, m) in enumerate(zip(lens, buds))]


def _serve(je, te, vocab, lens, buds, **kw):
    rj = _requests(jengine, vocab, lens, buds, **kw)
    rt = _requests(engine, vocab, lens, buds, **kw)
    je.run(rj)
    te.run(rt)
    assert [r.out_tokens for r in rt] == [r.out_tokens for r in rj]
    assert te.stats.describe() == je.stats.describe()
    assert te.stats.expert_hits == je.stats.expert_hits
    assert (te.stats.admissions, te.stats.retirements) == (
        je.stats.admissions, je.stats.retirements)
    return rt


def test_moe_serve_matches_reference_token_for_token(weights):
    je, te = _pair(weights)
    vocab = weights[0].vocab_size
    cfg = weights[1]
    for lens, buds in (((6, 9, 7, 12), (3, 5, 2, 4)),
                       ((10, 5, 20, 6, 9, 7), (4, 4, 1, 6, 2, 3))):
        _serve(je, te, vocab, lens, buds)
        st = te.stats
        # every decoding slot routes to top_k experts per layer-step (the
        # capacity holds B * top_k at this scale, so nothing drops)
        assert sum(st.expert_hits) == cfg.moe.top_k * st.slot_steps
        assert st.fused_prefill_chunks > 0
    prog = te.build_decode_program(prefill_chunks=2)
    assert any(any(m.startswith("moe_gmm") for m in ms) and len(ms) > 1
               for ms in prog.fused_members)
    # mid-batch EOS
    probe = _requests(engine, vocab, (6, 9, 7, 12), (6, 6, 6, 6))
    te.run(probe)
    _serve(je, te, vocab, (6, 9, 7, 12), (6, 6, 6, 6),
           eos=probe[1].out_tokens[1])
    assert any(r == "eos" for _s, _r, r in te.stats.retirements)


def test_moe_eload_sheds_under_skew_like_reference(weights):
    """A zero router ties every token to experts 0 and 1 (skew E / K =
    2.0 >= 1.5): eload sheds coresident chunks, tokens still equal."""
    tree = jax.tree_util.tree_map(np.copy, weights[2])
    run = jlm.layer_runs(weights[0])[0].name
    tree[run]["moe"]["router"] = np.zeros_like(tree[run]["moe"]["router"])
    budget = dict(chunk_rows=4, max_coresident_chunks=2, policy="eload",
                  skew_threshold=1.5)
    je, te = _pair(weights, batch=4, budget=budget, tree=tree)
    _serve(je, te, weights[0].vocab_size, (8,) * 6, (4,) * 6)
    st = te.stats
    E, K = weights[1].moe.num_experts, weights[1].moe.top_k
    assert st.expert_hits[2:] == [0] * (E - 2)
    assert st.expert_skew == pytest.approx(E / K)
    assert st.load_shed_steps >= 1


def test_eload_budget_validation():
    for mod in (jengine, engine):
        assert mod.PrefillBudget(policy="eload").skew_threshold == 1.5
        with pytest.raises(ValueError):
            mod.PrefillBudget(policy="eload", skew_threshold=0.5)
        with pytest.raises(ValueError):
            mod.PrefillBudget(policy="nope")


def test_moe_support_matches_reference(capsys, monkeypatch):
    """The faithful (LayerNorm) phi3.5 is refused by the executed program
    only: on the CPU a planned engine prints the reference's notice and
    stays hand-wired; on the card it refuses and names the opt-in."""
    assert engine.executable_decode_supported(_cfgs()[1]) is None
    for get, mod in ((jget_config, jengine), (get_config, engine)):
        ln = get("phi3.5-moe-42b-a6.6b").reduced()
        assert "rmsnorm" in mod.executable_decode_supported(ln)
    jengine.ServeEngine(jget_config("phi3.5-moe-42b-a6.6b").reduced(), None,
                        batch=2, max_len=48, plan_fusion=True)
    want = capsys.readouterr().out
    te = engine.ServeEngine(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                            None, batch=2, max_len=48, device="cpu")
    assert capsys.readouterr().out == want
    assert "stays hand-wired: norm 'layernorm' (rmsnorm only)" in want
    assert not te.executed and te.cache_len == 48
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match=r"rmsnorm only\) — pass "
                       r"plan_fusion=False \(serve CLI: --hand-wired\)"):
        engine.ServeEngine(get_config("phi3.5-moe-42b-a6.6b").reduced(),
                           None, batch=2, max_len=48, device="cuda")


# ---------------------------------------------------------------------------
# Launch tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 2])
def test_moe_launch_tables_match_reference(n):
    jc, tc = _cfgs()
    budget = dict(chunk_rows=8, max_coresident_chunks=2)
    je = jengine.ServeEngine(jc, None, batch=3, max_len=48, plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget))
    te = engine.ServeEngine(tc, None, batch=3, max_len=48, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget))
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())
    budget = dict(chunk_rows=512, max_coresident_chunks=2, policy="eload")
    jc = dataclasses.replace(jget_config("phi3.5-moe-rms"), num_layers=8)
    tc = dataclasses.replace(get_config("phi3.5-moe-rms"), num_layers=8)
    je = jengine.ServeEngine(jc, None, batch=8, max_len=2048,
                             plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget))
    te = engine.ServeEngine(tc, None, batch=8, max_len=2048, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget))
    got = te.build_decode_program(prefill_chunks=n).describe()
    assert got == je.build_decode_program(prefill_chunks=n).describe()
    assert {"members": "moe_gmm_E16_C8", "kind": "single",
            "schedule": None} in got
