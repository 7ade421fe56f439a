"""The port's served slice against the JAX package's ServeEngine, on the CPU.

  * Plan parity: the executed decode program's launch table
    (``build_decode_program(prefill_chunks=n).describe()``) equals the
    reference's for n = 0, 1, 2 — reduced granite-3-2b, and full-width
    granite-3-2b at batch 8, max_len 2048, chunk 512 (planning needs no
    weights).
  * Serve parity: reduced granite-3-2b in fp32, single-layer and a 2-layer
    stacked variant, batch 2, max_len 48, PrefillBudget(chunk_rows=8,
    max_coresident_chunks=2): token for token with the JAX ServeEngine,
    mid-batch EOS included, with equal ServeStats counters.
  * Step parity: one mixed step (a decoding slot plus a partial prefill
    chunk) on the same cache; logits within 1e-4 relative L2 in fp32 and
    2e-2 in bf16 (bf16 rounds at other points in the two frameworks).

Both packages get the same weights: a numpy tree made from a seed, handed
to JAX as arrays and to the port through ``lm.params_from_numpy``.
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
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import engine

BUDGET = dict(chunk_rows=8, max_coresident_chunks=2)
LENS, BUDGETS = (6, 15, 41), (3, 4, 3)


def _cfgs(layers: int, dtype: str):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get("granite-3-2b").reduced(), dtype=dtype)
        if layers > 1:
            c = dataclasses.replace(c, num_layers=layers,
                                    block_pattern=("attn",) * layers)
        out.append(c)
    return out


def _numpy_params(jcfg, seed=0):
    """A full parameter tree in the JAX layout from a numpy seed: weights
    at the reference's init scale, norm scales N(0, 0.3) so the norms are
    exercised (the reference inits them to zero), and a small embedding
    (std 0.005) so the tied head does not just echo the input token."""
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = rng.normal(size=sd.shape) * 0.3
        else:
            fan_in = sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[-1]
            a = rng.normal(size=sd.shape) * (
                0.005 if name == "embedding" else fan_in ** -0.5)
        dt = (ml_dtypes.bfloat16 if sd.dtype == jnp.bfloat16
              else np.dtype(sd.dtype))
        return a.astype(dt)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _engines(layers, dtype, params=True, budget=BUDGET, **kw):
    jcfg, tcfg = _cfgs(layers, dtype)
    tree = _numpy_params(jcfg) if params else None
    jp = jax.tree_util.tree_map(jnp.asarray, tree) if params else None
    tp = lm.params_from_numpy(tcfg, tree, device="cpu") if params else None
    je = jengine.ServeEngine(jcfg, jp, batch=2, max_len=48, plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget),
                             **kw)
    te = engine.ServeEngine(tcfg, tp, batch=2, max_len=48,
                            prefill_budget=engine.PrefillBudget(**budget),
                            device="cpu", **kw)
    return jcfg, je, te


def _requests(mod, vocab, eos=None, seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m, eos_token=eos)
            for i, (L, m) in enumerate(zip(LENS, BUDGETS))]


# ---------------------------------------------------------------------------
# Plan parity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def full_width_engines():
    budget = dict(chunk_rows=512, max_coresident_chunks=2)
    je = jengine.ServeEngine(jget_config("granite-3-2b"), None, batch=8,
                             max_len=2048, plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget))
    te = engine.ServeEngine(get_config("granite-3-2b"), None, batch=8,
                            max_len=2048, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget))
    return je, te


@pytest.mark.parametrize("n", [0, 1, 2])
def test_full_width_launch_table_matches_reference(full_width_engines, n):
    je, te = full_width_engines
    want = je.build_decode_program(prefill_chunks=n).describe()
    got = te.build_decode_program(prefill_chunks=n)
    assert got.describe() == want
    if n == 2:      # the pairing the issue is about, at full width
        assert [s.schedule for s in got.steps if s.fused] == ["8:1", "1:8"]


@pytest.mark.parametrize("stitched", [True, False])
@pytest.mark.parametrize("n", [0, 1, 2])
def test_reduced_launch_table_matches_reference(n, stitched):
    _c, je, te = _engines(1, "float32", params=False,
                          stitch_epilogues=stitched)
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())
    assert te.fusion_plan.summary() == je.fusion_plan.summary()


# ---------------------------------------------------------------------------
# Serve parity
# ---------------------------------------------------------------------------
def _check_stats(jstats, tstats):
    want = jstats.describe()
    got = tstats.describe()
    assert got == {k: want[k] for k in got}
    assert (tstats.admissions, tstats.retirements,
            tstats.admission_latencies) == (jstats.admissions,
                                            jstats.retirements,
                                            jstats.admission_latencies)


@pytest.mark.parametrize("layers", [1, 2])
def test_serve_matches_reference_token_for_token(layers):
    jcfg, je, te = _engines(layers, "float32")
    rj = _requests(jengine, jcfg.vocab_size)
    rt = _requests(engine, jcfg.vocab_size)
    je.run(rj)
    te.run(rt)
    assert [r.out_tokens for r in rt] == [r.out_tokens for r in rj]
    _check_stats(je.stats, te.stats)
    assert te.stats.fused_prefill_chunks > 0
    # the eos run: request 1 stops at its second token, mid-batch
    eos = rt[1].out_tokens[1]
    rj = _requests(jengine, jcfg.vocab_size, eos=eos)
    rt = _requests(engine, jcfg.vocab_size, eos=eos)
    je.run(rj)
    te.run(rt)
    assert [r.out_tokens for r in rt] == [r.out_tokens for r in rj]
    assert any(reason == "eos" for _s, _r, reason in te.stats.retirements)
    _check_stats(je.stats, te.stats)


@pytest.mark.parametrize("policy", ["fifo", "srpf"])
def test_chunk_policy_matches_reference(policy):
    """One chunk per step, a 6-chunk prompt queued before a 1-chunk one:
    the policy decides which chunks first; tokens and admission latencies
    equal the reference's under either policy."""
    budget = dict(chunk_rows=8, max_coresident_chunks=1, policy=policy)
    jcfg, je, te = _engines(1, "float32", budget=budget)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, L).astype(np.int32)
               for L in (41, 6)]
    rj = [jengine.Request(rid=i, prompt=p, max_new_tokens=3)
          for i, p in enumerate(prompts)]
    rt = [engine.Request(rid=i, prompt=p, max_new_tokens=3)
          for i, p in enumerate(prompts)]
    je.run(rj)
    te.run(rt)
    assert [r.out_tokens for r in rt] == [r.out_tokens for r in rj]
    _check_stats(je.stats, te.stats)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_mixed_step_logits_match_reference(dtype, tol):
    """Slot 0 decodes at position 20 over a filled cache while slot 1
    prefills a partial chunk (6 of 8 rows) at offset 8."""
    jcfg, je, te = _engines(2, dtype)
    rng = np.random.default_rng(7)
    jcache = je._init_slot_cache()
    run = jlm.layer_runs(jcfg)[0].name
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    kv = {k: rng.normal(size=jcache[run][k].shape).astype(np_dt)
          for k in ("k", "v")}
    pos = np.asarray([20, 8], np.int32)
    jcache = {"pos": jnp.asarray(pos), run: {k: jnp.asarray(a)
                                             for k, a in kv.items()}}
    tcache = {"pos": torch.from_numpy(pos.copy()),
              run: {k: lm._from_numpy(a).clone() for k, a in kv.items()}}
    tokens = np.asarray([17, 3], np.int32)
    active = np.asarray([True, False])
    ch_tok = np.zeros((1, 8), np.int32)
    ch_tok[0, :6] = rng.integers(1, jcfg.vocab_size, 6)
    jl, _jc, jpf = je._cb_step(1)(
        je.params, jcache, jnp.asarray(tokens), jnp.asarray(active),
        ch_slots=jnp.asarray([1], jnp.int32),
        ch_offs=jnp.asarray([8], jnp.int32),
        ch_valid=jnp.asarray([6], jnp.int32), ch_tokens=jnp.asarray(ch_tok))
    tl, tc, tpf = te._cb_step(1)(
        te.params, tcache, torch.from_numpy(tokens), torch.from_numpy(active),
        ch_slots=[1], ch_offs=[8], ch_valid=[6],
        ch_tokens=torch.from_numpy(ch_tok))
    for want, got in ((jl[:1], tl[:1]), (jpf, tpf)):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
    assert tc["pos"].tolist() == [21, 14]
