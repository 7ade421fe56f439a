"""The hand-wired decode, the wavefront scheduler and the hand-wired
continuous fallback of the port, against the JAX package on the CPU.

  * ``lm.prefill`` and ``lm.decode_step`` on reduced granite-3-2b (one layer
    and a two-layer stacked run) and reduced phi3.5-moe-rms, fp32: logits
    within rtol 1e-4, atol 2e-5 of the reference's, caches within 1e-5,
    over three decode steps; and prefill + decode equals the port's own
    full-sequence forward.
  * Wavefront, hand-wired and executed (``plan_fusion=True``: the first
    step of a wave carries the next wave's ``prefill_ffn``), token for token
    with the reference's engines on ``tests/test_serve_continuous.py``'s
    prompt sets; the executed step equals ``lm.decode_step``; the mixed
    program's launch table is the reference's.
  * The continuous fallback (``plan_fusion=False``) token for token with
    the reference's vmapped fallback, with equal ``ServeStats.describe()``,
    admissions and retirements: the prompt sets, a mid-batch EOS, a full
    cache, late arrivals, a stacked run and MoE.
  * The port's own differential: executed continuous == wavefront.
  * The refusals and notices, with the reference's texts (on the card a
    planned stacked or MoE wavefront engine refuses instead), and the
    deprecated keywords' warnings.

Both packages get the same weights (``test_torch_serve._numpy_params``);
engines are shared through module fixtures, since each reference engine
compiles its steps on first use.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve import engine
from test_torch_serve import _numpy_params

# tests/test_serve_continuous.py's prompt sets: (lengths, token budgets)
PROMPT_SETS = [
    ((6, 9, 7, 12), (3, 5, 2, 4)),
    ((8, 8, 8, 8, 8), (2, 6, 3, 3, 5)),
    ((10, 5, 12, 6, 9, 7), (4, 4, 1, 6, 2, 3)),
]
SET_IDS = ["mixed", "same-length", "ragged"]
MAX_LEN = 48


def _cfgs(arch="granite-3-2b", layers=1):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(arch).reduced(), dtype="float32")
        if layers > 1:
            c = dataclasses.replace(c, num_layers=layers,
                                    block_pattern=("attn",) * layers)
        out.append(c)
    return out


def _model(arch="granite-3-2b", layers=1):
    jcfg, tcfg = _cfgs(arch, layers)
    tree = _numpy_params(jcfg)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            lm.params_from_numpy(tcfg, tree, device="cpu"))


def _requests(mod, vocab, lens, budgets, eos=None, seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m, eos_token=eos)
            for i, (L, m) in enumerate(zip(lens, budgets))]


def _pair(model, max_len=MAX_LEN, **kw):
    """The reference's engine and the port's, same options."""
    jcfg, jp, tcfg, tp = model
    kw.setdefault("plan_fusion", False)
    return (jengine.ServeEngine(jcfg, jp, batch=2, max_len=max_len, **kw),
            engine.ServeEngine(tcfg, tp, batch=2, max_len=max_len,
                               device="cpu", **kw))


def _serve_both(je, te, lens, budgets, eos=None):
    vocab = te.cfg.vocab_size
    rj = _requests(jengine, vocab, lens, budgets, eos)
    rt = _requests(engine, vocab, lens, budgets, eos)
    je.run(rj)
    te.run(rt)
    return [r.out_tokens for r in rj], [r.out_tokens for r in rt]


@pytest.fixture(scope="module")
def dense():
    return _model()


@pytest.fixture(scope="module")
def engines(dense):
    return {"wave": _pair(dense, scheduling="wavefront"),
            "wave_exec": _pair(dense, scheduling="wavefront",
                               plan_fusion=True),
            "fallback": _pair(dense, scheduling="continuous")}


# ---------------------------------------------------------------------------
# lm.prefill / lm.decode_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,layers", [("granite-3-2b", 1),
                                         ("granite-3-2b", 2),
                                         ("phi3.5-moe-rms", 1)],
                         ids=["granite", "granite-stacked", "phi-moe"])
def test_prefill_and_decode_step_match_reference(arch, layers):
    jcfg, jp, tcfg, tp = _model(arch, layers)
    toks = np.stack([np.arange(1, 9), np.arange(3, 11)]).astype(np.int32)
    jc, jl = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=40)
    tc, tl = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=40)
    run = lm.layer_runs(tcfg)[0].name
    for _ in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=2e-5)
        assert int(tc["pos"]) == int(jc["pos"])
        for k in ("k", "v"):
            assert tc[run][k].shape == jc[run][k].shape
            np.testing.assert_allclose(tc[run][k].numpy(),
                                       np.asarray(jc[run][k]), rtol=1e-5,
                                       atol=1e-5)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert torch.equal(lm.greedy_sample(tcfg, tl),
                           torch.from_numpy(cur))
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(cur))
        tl, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(cur))


def test_prefill_then_decode_equals_forward(dense):
    """The last position of a full-sequence forward equals prefill of all
    but the last token, then one decode step of it; serve_step_greedy
    picks its argmax (tests/test_models_decode.py)."""
    _jcfg, _jp, cfg, params = dense
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 11)).astype(np.int32))
    full, _aux, _m = lm.forward(cfg, params, {"tokens": toks})
    cache, _ = lm.prefill(cfg, params, {"tokens": toks[:, :-1]}, max_len=16)
    logits, _ = lm.decode_step(cfg, params, cache, toks[:, -1])
    torch.testing.assert_close(logits, full[:, -1], rtol=1e-4, atol=2e-5)
    cache, _ = lm.prefill(cfg, params, {"tokens": toks[:, :-1]}, max_len=16)
    tok, cache = lm.serve_step_greedy(cfg, params, cache, toks[:, -1])
    assert torch.equal(tok, full[:, -1].argmax(-1).to(torch.int32))
    assert int(cache["pos"]) == 11


# ---------------------------------------------------------------------------
# Wavefront
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lens,budgets", PROMPT_SETS, ids=SET_IDS)
@pytest.mark.parametrize("kind", ["wave", "wave_exec"])
def test_wavefront_matches_reference(engines, kind, lens, budgets):
    je, te = engines[kind]
    assert te.executed == je.executed == (kind == "wave_exec")
    want, got = _serve_both(je, te, lens, budgets)
    assert got == want
    if kind == "wave_exec" and len(set(lens)) > 1:
        assert te._mixed_steps, "co-prefill path never exercised"


def test_wavefront_eos_matches_reference(engines):
    je, te = engines["wave_exec"]
    lens, budgets = PROMPT_SETS[0]
    probe, _ = _serve_both(je, te, lens, budgets)
    want, got = _serve_both(je, te, lens, budgets, eos=probe[1][1])
    assert got == want and len(got[1]) < budgets[1]


def test_executed_decode_step_matches_lm_decode(engines):
    """The planned norm -> attention -> FFN program, with the model glue in
    the binding slots, equals lm.decode_step (tests/test_executor.py's
    tolerance)."""
    _je, te = engines["wave_exec"]
    cfg, params = te.cfg, te.params
    toks = torch.stack([torch.arange(1, 9, dtype=torch.int32),
                        torch.arange(3, 11, dtype=torch.int32)])
    cache, logits = lm.prefill(cfg, params, {"tokens": toks},
                               max_len=te.cache_len)
    run = lm.layer_runs(cfg)[0].name
    cur = logits.argmax(-1)
    for _ in range(3):
        ref_cache = {"pos": cache["pos"],
                     run: {k: t.clone() for k, t in cache[run].items()}}
        out_ref, ref_cache = lm.decode_step(cfg, params, ref_cache, cur)
        out_exe, cache = te._decode(params, cache, cur)
        torch.testing.assert_close(out_exe, out_ref, rtol=1e-4, atol=2e-5)
        for k in ("k", "v"):
            torch.testing.assert_close(cache[run][k], ref_cache[run][k],
                                       rtol=1e-5, atol=1e-5)
        assert int(cache["pos"]) == int(ref_cache["pos"])
        cur = out_exe.argmax(-1)


@pytest.mark.parametrize("rows", [128, 16, 24])
def test_mixed_program_launch_table_matches_reference(engines, rows):
    """build_decode_program(ffn_rows=) fuses prefill_ffn with decode
    attention, as the reference's does, and binds every member."""
    je, te = engines["wave_exec"]
    got = te.build_decode_program(ffn_rows=rows)
    assert got.describe() == je.build_decode_program(
        ffn_rows=rows).describe()
    fused = [m for s in got.steps if s.fused for m in s.members]
    assert "prefill_ffn" in fused
    assert any(m.startswith("decode_attn") for m in fused)


def test_full_width_mixed_program_matches_reference():
    """granite-3-2b at full width cut to one layer, B 8, max_len 2048, the
    second wave's 8 x 512 rows riding (prefill_ffn M 4096): the reference's
    plan, which launches prefill_ffn alone at this shape."""
    cfgs = [dataclasses.replace(get("granite-3-2b"), num_layers=1,
                                block_pattern=None)
            for get in (jget_config, get_config)]
    je = jengine.ServeEngine(cfgs[0], None, batch=8, max_len=2048,
                             plan_fusion=True, scheduling="wavefront")
    te = engine.ServeEngine(cfgs[1], None, batch=8, max_len=2048,
                            device="cpu", scheduling="wavefront")
    want = je.build_decode_program(ffn_rows=4096).describe()
    assert te.build_decode_program(ffn_rows=4096).describe() == want
    ops = {g.op.name: g.op for g in te.decode_graph(ffn_rows=4096)}
    pf = ops["prefill_ffn"]
    assert (pf.member.M, pf.member.K, pf.member.N) == (4096, 2048, 16384)
    assert pf.flops == 2.0 * 4096 * 2048 * 16384


# ---------------------------------------------------------------------------
# The hand-wired continuous fallback
# ---------------------------------------------------------------------------
def _stats(eng):
    st = eng.stats
    return st.describe(), st.admissions, st.retirements


@pytest.mark.parametrize("lens,budgets", PROMPT_SETS, ids=SET_IDS)
def test_fallback_matches_reference(engines, lens, budgets):
    je, te = engines["fallback"]
    assert not (te.executed or je.executed)
    want, got = _serve_both(je, te, lens, budgets)
    assert got == want
    assert _stats(te) == _stats(je)
    assert te.stats.prefill_chunks == 0 and te.stats.mixed_steps > 0


def test_fallback_eos_and_delayed_arrivals_match_reference(engines):
    je, te = engines["fallback"]
    lens, budgets = PROMPT_SETS[0]
    probe, _ = _serve_both(je, te, lens, budgets)
    want, got = _serve_both(je, te, lens, budgets, eos=probe[1][1])
    assert got == want and _stats(te) == _stats(je)
    assert any(r == "eos" for _s, _i, r in te.stats.retirements)
    vocab = te.cfg.vocab_size
    rj = _requests(jengine, vocab, (6, 9), (3, 3))
    rt = _requests(engine, vocab, (6, 9), (3, 3))
    rj[1].arrival = rt[1].arrival = 4
    je.run(rj)
    te.run(rt)
    assert [r.out_tokens for r in rt] == [r.out_tokens for r in rj]
    assert _stats(te) == _stats(je)


def test_fallback_cache_full_matches_reference(dense):
    je, te = _pair(dense, max_len=12)
    want, got = _serve_both(je, te, (10, 4), (8, 3))
    assert got == want and _stats(te) == _stats(je)
    assert len(got[0]) == 12 - 10 + 1
    assert any(r == "max_len" for _s, _i, r in te.stats.retirements)


@pytest.mark.parametrize("arch,layers", [("granite-3-2b", 2),
                                         ("phi3.5-moe-rms", 1)],
                         ids=["granite-stacked", "phi-moe"])
def test_fallback_stacked_and_moe_match_reference(arch, layers):
    je, te = _pair(_model(arch, layers))
    lens, budgets = PROMPT_SETS[0]
    want, got = _serve_both(je, te, lens, budgets)
    assert got == want and _stats(te) == _stats(je)


@pytest.mark.parametrize("lens,budgets", PROMPT_SETS, ids=SET_IDS)
def test_executed_continuous_matches_wavefront(dense, engines, lens,
                                               budgets):
    """The port's own differential: the executed continuous engine (chunked
    prefill in fused launches) == the hand-wired wavefront oracle."""
    _jcfg, _jp, tcfg, tp = dense
    cont = engine.ServeEngine(tcfg, tp, batch=2, max_len=MAX_LEN,
                              device="cpu")
    assert cont.executed
    _je, wave = engines["wave"]
    rc = _requests(engine, tcfg.vocab_size, lens, budgets)
    rw = _requests(engine, tcfg.vocab_size, lens, budgets)
    cont.run(rc)
    wave.run(rw)
    assert [r.out_tokens for r in rc] == [r.out_tokens for r in rw]
    assert cont.stats.fused_mixed_steps == cont.stats.mixed_steps > 0


# ---------------------------------------------------------------------------
# Refusals, notices and deprecated keywords
# ---------------------------------------------------------------------------
# (arch, layers, scheduling): the stacked and MoE configs stay hand-wired
# on wavefront only; a LayerNorm config on either scheduling
HAND_WIRED = [("granite-3-2b", 2, "wavefront"),
              ("phi3.5-moe-rms", 1, "wavefront"),
              ("stablelm-3b", 1, "wavefront"),
              ("stablelm-3b", 1, "continuous"),
              ("phi3.5-moe-42b-a6.6b", 1, "wavefront"),
              ("phi3.5-moe-42b-a6.6b", 1, "continuous")]
HAND_WIRED_IDS = ["stacked", "moe", "layernorm-wavefront",
                  "layernorm-continuous", "layernorm-moe-wavefront",
                  "layernorm-moe-continuous"]


@pytest.mark.parametrize("arch,layers,scheduling", HAND_WIRED,
                         ids=HAND_WIRED_IDS)
def test_wavefront_stays_hand_wired_with_the_reference_notice(
        arch, layers, scheduling, capsys):
    jcfg, tcfg = _cfgs(arch, layers)
    je = jengine.ServeEngine(jcfg, None, batch=2, max_len=MAX_LEN,
                             plan_fusion=True, scheduling=scheduling)
    want = capsys.readouterr().out
    te = engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                            device="cpu", scheduling=scheduling)
    got = capsys.readouterr().out
    assert not (je.executed or te.executed)
    assert got == want and "decode step stays hand-wired" in got
    assert te.fusion_plan is not None and te.cache_len == MAX_LEN


@pytest.mark.parametrize("arch,layers,scheduling", HAND_WIRED,
                         ids=HAND_WIRED_IDS)
def test_planned_wavefront_refuses_on_the_card(arch, layers, scheduling,
                                               monkeypatch):
    """On the card a planned engine does not give way to the hand-wired
    step: it refuses and names the explicit opt-in."""
    _, tcfg = _cfgs(arch, layers)
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match=r"plan_fusion=False \(serve CLI: "
                                         r"--hand-wired\)"):
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cuda", scheduling=scheduling)


@pytest.mark.parametrize("kw", [dict(scheduling="wavefront"),
                                dict(plan_fusion=False)])
def test_paged_refuses_the_hand_wired_paths_with_the_reference_text(kw):
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jcfg, None, batch=2, max_len=MAX_LEN,
                            paged_kv=True, **{"plan_fusion": True, **kw})
    with pytest.raises(ValueError) as got:
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cpu", paged_kv=True, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="continuous or wavefront"):
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cpu", scheduling="lockstep")


def test_deprecated_keywords_warn_and_alias(engines):
    je, te = engines["wave_exec"]
    with pytest.warns(DeprecationWarning, match="pad_prefill_rows"):
        assert engine.pad_prefill_rows(130) == 256
    with pytest.warns(DeprecationWarning, match="prefill_rows"):
        old = te.decode_graph(prefill_rows=24)
    assert [g.op.name for g in old] == \
        [g.op.name for g in te.decode_graph(ffn_rows=24)]
    with pytest.warns(DeprecationWarning, match="prefill_rows"):
        prog = te.build_decode_program(prefill_rows=24)
    assert prog.describe() == te.build_decode_program(ffn_rows=24).describe()
    with pytest.warns(DeprecationWarning, match="prefill_chunk"):
        plan = te.plan_decode_fusion(prefill_chunk=64)
    budget = dataclasses.replace(te.prefill_budget, chunk_rows=64)
    assert plan.summary() == te.plan_decode_fusion(budget=budget).summary()
    with pytest.warns(DeprecationWarning):
        want = je.plan_decode_fusion(prefill_chunk=64)
    assert [r["members"] for r in plan.summary()] == \
        [r["members"] for r in want.summary()]


def test_static_length_decode_graph_matches_reference(engines):
    je, te = engines["wave_exec"]
    for dyn in (True, False):
        want = {g.op.name: g.op for g in je.decode_graph(
            dynamic_length=dyn)}
        got = {g.op.name: g.op for g in te.decode_graph(dynamic_length=dyn)}
        assert list(got) == list(want)
        att = next(n for n in got if n.startswith("decode_attn"))
        assert got[att].in_names == want[att].in_names
        assert (got[att].flops, got[att].hbm_bytes, got[att].grid) == \
            (want[att].flops, want[att].hbm_bytes, want[att].grid)
