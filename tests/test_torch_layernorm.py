"""The four LayerNorm configs of the port against the JAX package, on the
CPU: stablelm-3b (MHA, head dim 80, partial RoPE 25%), starcoder2-7b (GQA
36/4, ``gelu_mlp``), minitron-8b (``relu2_mlp``, a 256000-word vocabulary)
and the faithful phi3.5-moe-42b-a6.6b (LayerNorm MoE).

Both packages get the same weights: numpy trees made from a seed (LayerNorm
scales 1 + N(0, 0.3), biases N(0, 0.1), so both terms are exercised),
handed to JAX as arrays and to the port through ``lm.params_from_numpy``.
Each config's ``reduced()`` runs in fp32 and in bf16.

Tolerances.  fp32: ``layers.layernorm`` to 1e-5 relative; logits and the
loss to 1e-5 relative; gradients, every bias leaf included, to 1e-4
relative plus 1e-6 absolute; one train step's params, m and v to the
reference's bounds for its executed step (rtol 2e-5, atol 2e-6);
``lm.prefill`` / ``lm.decode_step`` to 1e-4 relative plus 2e-5 absolute,
and to the port's own ``forward(S + 1)`` likewise
(``tests/test_torch_train.py``, ``tests/test_torch_wavefront.py``).
bf16: ``layers.layernorm`` to one bf16 step (2**-7 relative); logits, the
gradients of each leaf and the train step's params to 2e-2 relative L2,
the loss to 1e-3 relative, and m and v to 2e-2 relative L2.  bf16 rounds
the FFN activations at other points in the two frameworks
(``jax.nn.silu`` and ``jax.nn.gelu`` round their inner terms to bf16), the
serve tests' 2e-2 (``tests/test_torch_serve.py``).  Served tokens and
``ServeStats`` are equal; plans and launch tables are equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import shape_applicable as jshape_applicable
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import tree as tree_mod
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs import shape_applicable
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers, lm
from repro_torch.models import moe as moe_mod
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop as tl

ARCHS = ["stablelm-3b", "starcoder2-7b", "minitron-8b",
         "phi3.5-moe-42b-a6.6b"]
IDS = ["stablelm", "starcoder2", "minitron", "phi-moe"]
DTYPES = ["float32", "bfloat16"]
BF16_STEP = 2.0 ** -7
BF16_REL_L2 = 2e-2
SEQ, BATCH, MAX_LEN = 16, 2, 48


def _cfgs(arch, dtype="float32", **kw):
    return [dataclasses.replace(get(arch).reduced(), dtype=dtype, **kw)
            for get in (jget_config, get_config)]


def _numpy_tree(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = 1.0 + rng.normal(size=sd.shape) * 0.3
        elif name == "bias":
            a = rng.normal(size=sd.shape) * 0.1
        else:
            fan_in = sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[-1]
            a = rng.normal(size=sd.shape) * (
                0.02 if name == "embedding" else fan_in ** -0.5)
        dt = (ml_dtypes.bfloat16 if sd.dtype == jnp.bfloat16
              else np.dtype(sd.dtype))
        return a.astype(dt)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.cache
def _shared(arch, dtype, kw):
    jcfg, tcfg = _cfgs(arch, dtype, **dict(kw))
    tree = _numpy_tree(jcfg)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, tree


def _model(arch, dtype="float32", **kw):
    """(jcfg, jax params, tcfg, port params); the weights are made once
    per config, the port's params afresh each call (the update program
    writes them in place)."""
    jcfg, jp, tcfg, tree = _shared(arch, dtype, tuple(sorted(kw.items())))
    return jcfg, jp, tcfg, lm.params_from_numpy(tcfg, tree, device="cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy().astype(np.float32)
    return np.asarray(a, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, rtol, atol):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2


def _trees_close(jtree, ttree, dtype, rtol, atol):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tlv = tree_mod.flatten_with_paths(ttree)
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tlv]
    for (path, a), (_p, b) in zip(jl, tlv):
        try:
            _close(b, a, dtype, rtol, atol)
        except AssertionError as e:
            raise AssertionError(f"{'/'.join(_p)}: {e}") from None


def _batch(cfg):
    nb = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH)).batch_at(0)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


# ---------------------------------------------------------------------------
# layers: LayerNorm, partial RoPE, the non-gated FFNs, 9 heads per KV head
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    # rows of unit spread, and rows whose variance (~1e-5) is eps's size,
    # where eps 1e-5 against RMSNorm's 1e-6 shows
    x = np.concatenate([rng.normal(size=(3, 37, 100)) * 2 + 0.5,
                        rng.normal(size=(1, 37, 100)) * 3e-3 + 0.1]
                       ).astype(np_dt)
    p = {"scale": (1 + rng.normal(size=100) * 0.3).astype(np.float32),
         "bias": (rng.normal(size=100) * 0.1).astype(np.float32)}
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           lm._from_numpy(x))
    assert got.dtype == lm.torch_dtype(dtype)
    rtol = 1e-5 if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(_f32(got[:3]), _f32(want[:3]), rtol=rtol,
                               atol=1e-6)
    # near-constant rows: the fp32 mean's last bit (another summation
    # order) shows 1e3-fold in the centred values; eps 1e-6 would move
    # them by 38%
    np.testing.assert_allclose(_f32(got[3:]), _f32(want[3:]),
                               rtol=max(rtol, 1e-3), atol=1e-4)
    # the centred variance, not E[x^2] - E[x]^2: a large mean cancels
    big = torch.full((1, 64), 1e4) + torch.arange(64.0) * 1e-2
    ln = layers.layernorm({"scale": torch.ones(64), "bias": torch.zeros(64)},
                          big)
    assert torch.isfinite(ln).all() and float(ln.std()) > 0.9


@pytest.mark.parametrize("D,fraction", [(80, 0.25), (16, 0.25), (128, 1.0)])
def test_partial_rope_matches_reference(D, fraction):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, D)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 50, 700, 4000]] * 2, np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                        fraction)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
                      fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    rot = int(D * fraction) // 2 * 2
    assert torch.equal(got[..., rot:], torch.from_numpy(x)[..., rot:])


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp", "relu2_mlp"])
def test_mlp_and_ffn_width_match_reference(act):
    jcfg, tcfg = _cfgs("starcoder2-7b", activation=act)
    assert engine._ffn_in_width(tcfg) == jengine._ffn_in_width(jcfg)
    rng = np.random.default_rng(3)
    d, f = tcfg.d_model, tcfg.d_ff
    p = {"w_in": rng.normal(size=(d, engine._ffn_in_width(tcfg)))
         .astype(np.float32) * d ** -0.5,
         "w_out": rng.normal(size=(f, d)).astype(np.float32) * f ** -0.5}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = jlayers.mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = layers.mlp(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_nine_query_heads_per_kv_head_match_reference():
    """starcoder2-7b's 36/4 heads, which ``reduced()`` cuts to 4/4: the
    blockwise and decode attention at head dim 16, then a one-layer model
    with those heads through prefill and three decode steps."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 32, 36, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    want = jlayers.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), chunk_q=8, chunk_k=8)
    got = layers.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                     chunk_q=8, chunk_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    want = jlayers.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                    jnp.asarray(v), 19)
    got = layers.decode_attention(torch.from_numpy(q[:, :1]),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    _prefill_decode_check("starcoder2-7b", "float32", num_heads=36,
                          num_kv_heads=4)


# ---------------------------------------------------------------------------
# model: forward, loss, gradients, one train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_forward_loss_and_grads_match_reference(arch, dtype):
    jcfg, jp, tcfg, tp = _model(arch, dtype)
    jb, tb = _batch(tcfg)

    def reference(p):
        return (jlm.forward(jcfg, p, jb)[0], jax.value_and_grad(
            lambda q: jlm.loss_fn(jcfg, q, jb, remat=True)[0])(p))
    jlogits, (jloss, jg) = jax.jit(reference)(jp)
    tlogits, _aux, _m = lm.forward(tcfg, tp, tb)
    _close(tlogits, jlogits, dtype, 1e-5, 1e-5)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    tloss, _ = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                          remat=True)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    _trees_close(jg, grads, dtype, 1e-4, 1e-6)
    biases = [(p, g) for p, g in tree_mod.flatten_with_paths(grads)
              if p[-1] == "bias"]
    assert len(biases) == 3 and all(bool(g.abs().max() > 0)
                                    for _p, g in biases)


def _moments(jp):
    rng = np.random.default_rng(1)
    leaves = jax.tree_util.tree_leaves(jp)
    m = [(rng.normal(size=a.shape) * 1e-3).astype(np.float32) for a in leaves]
    v = [(rng.random(size=a.shape) * 1e-5).astype(np.float32) for a in leaves]
    treedef = jax.tree_util.tree_structure(jp)
    return tuple(jax.tree_util.tree_unflatten(treedef, t) for t in (m, v))


@functools.cache
def _reference_step(arch, dtype):
    """The reference's train step from the shared moments, once per
    config (both of the port's routes are held against it)."""
    jcfg, jp, tcfg, _tree = _shared(arch, dtype, ())
    jb, _tb = _batch(tcfg)
    m, v = (jax.tree_util.tree_map(jnp.asarray, t) for t in _moments(jp))
    jstep = jax.jit(jtl.make_train_step(jcfg, jtl.TrainConfig(
        optimizer=jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        remat=False)))
    return jstep(jp, jopt.OptState(m, v, jnp.asarray(2, jnp.int32)), jb,
                 jnp.asarray(0))


@pytest.mark.parametrize("dtype,route", [("float32", "plain"),
                                         ("float32", "program"),
                                         ("bfloat16", "plain")])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_train_step_matches_reference(arch, dtype, route):
    _jcfg, jp, tcfg, tp = _model(arch, dtype)
    _jb, tb = _batch(tcfg)
    m, v = _moments(jp)
    ocfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    prog = (tl.build_update_program(lm.abstract_params(tcfg), ocfg)
            if route == "program" else None)
    step = tl.make_train_step(tcfg, tl.TrainConfig(optimizer=ocfg,
                                                   remat=False),
                              update_program=prog)
    new_p, new_s, met = step(tp, opt_mod.opt_state_from_numpy(m, v, 2, tp),
                             tb, 0)
    jp2, js2, jmet = _reference_step(arch, dtype)
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=rtol)
    _trees_close(jp2, new_p, dtype, 2e-5, 2e-6)
    _trees_close(js2.m, new_s.m, dtype, 2e-5, 2e-6)
    _trees_close(js2.v, new_s.v, dtype, 2e-5, 2e-6)
    # every bias leaf moved off its start: its gradient and update are real
    start = [a for _p, a in jax.tree_util.tree_flatten_with_path(jp)[0]]
    moved = [not np.array_equal(_f32(b), _f32(a)) for a, (path, b)
             in zip(start, tree_mod.flatten_with_paths(new_p))
             if path[-1] == "bias"]
    assert len(moved) == 3 and all(moved)
    if route == "program":
        assert new_p is tp              # the program updates in place
        assert sum(1 for _n, p, *_ in prog.layout if p[-1] == "bias") == 3


def test_faithful_moe_routes_as_the_rms_variant():
    """The faithful phi3.5's MoE FFN is phi3.5-moe-rms's: the same route,
    the same output, and the reference's within 1e-5."""
    jcfg, jp, tcfg, tp = _model("phi3.5-moe-42b-a6.6b")
    rms = dataclasses.replace(tcfg, norm="rmsnorm")
    run = lm.layer_runs(tcfg)[0].name
    x = np.random.default_rng(6).normal(size=(2, 9, tcfg.d_model)) \
        .astype(np.float32)
    got, aux = moe_mod.apply(tcfg, tp[run]["moe"], torch.from_numpy(x))
    got_rms, aux_rms = moe_mod.apply(rms, tp[run]["moe"],
                                     torch.from_numpy(x))
    assert torch.equal(got, got_rms) and torch.equal(aux, aux_rms)
    want, jaux = jax.jit(lambda p, h: jmoe.apply(jcfg, p, h))(
        jp[run]["moe"], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the hand-wired serve path
# ---------------------------------------------------------------------------
def _prefill_decode_check(arch, dtype, **kw):
    jcfg, jp, tcfg, tp = _model(arch, dtype, **kw)
    toks = np.random.default_rng(8).integers(
        1, tcfg.vocab_size, (2, 9)).astype(np.int32)
    jc, jl = jax.jit(lambda b: jlm.prefill(jcfg, jp, b, max_len=40))(
        {"tokens": jnp.asarray(toks[:, :8])})
    tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :8])}, max_len=40)
    run = lm.layer_runs(tcfg)[0].name
    decode = jax.jit(lambda c, t: jlm.decode_step(jcfg, jp, c, t))
    for i in range(4):
        _close(tlog, jl, dtype, 1e-4, 2e-5)
        for k in ("k", "v"):
            _close(tc[run][k], jc[run][k], dtype, 1e-5, 1e-5)
        assert int(tc["pos"]) == int(jc["pos"]) == 8 + i
        cur = toks[:, 8] if i == 0 else np.asarray(
            jnp.argmax(jl, -1)).astype(np.int32)
        if i == 0:
            # prefill of S tokens then one decode step == forward(S + 1)
            full = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})[0]
        jl, jc = decode(jc, jnp.asarray(cur))
        tlog, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(cur))
        if i == 0:
            _close(tlog, full[:, -1], dtype, 1e-4, 2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_prefill_and_decode_step_match_reference(arch, dtype):
    _prefill_decode_check(arch, dtype)


def _requests(mod, vocab, lens=(8, 8, 8, 8), budgets=(3, 5, 2, 4),
              seed=11):
    # one prompt length: the reference compiles its prefill once; the
    # budgets still retire and refill the slots at other steps
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m)
            for i, (L, m) in enumerate(zip(lens, budgets))]


def _stats(eng):
    st = eng.stats
    return st.describe(), st.admissions, st.retirements


@pytest.mark.parametrize("scheduling", ["continuous", "wavefront"])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_hand_wired_engines_match_reference(arch, scheduling):
    """The continuous fallback and the hand-wired wavefront, token for
    token with the reference's engines and with equal stats; a planned
    engine on the CPU stays hand-wired and serves the same tokens."""
    jcfg, jp, tcfg, tp = _model(arch)
    kw = dict(batch=2, max_len=MAX_LEN, scheduling=scheduling)
    je = jengine.ServeEngine(jcfg, jp, plan_fusion=False, **kw)
    te = engine.ServeEngine(tcfg, tp, plan_fusion=False, device="cpu", **kw)
    rj, rt = (_requests(m, tcfg.vocab_size) for m in (jengine, engine))
    je.run(rj)
    te.run(rt)
    want = [r.out_tokens for r in rj]
    assert [r.out_tokens for r in rt] == want
    assert _stats(te) == _stats(je)
    with contextlib.redirect_stdout(io.StringIO()):
        planned = engine.ServeEngine(tcfg, tp, device="cpu", **kw)
    rp = _requests(engine, tcfg.vocab_size)
    planned.run(rp)
    assert not planned.executed
    assert [r.out_tokens for r in rp] == want
    assert _stats(planned) == _stats(te)


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_planned_engine_notice_plan_and_launch_table(arch, n, capsys):
    """A planned engine over a LayerNorm config prints the reference's
    notice, stays hand-wired at cache_len == max_len, and plans the
    reference's fallback graph: the same plan and launch table."""
    jcfg, tcfg = _cfgs(arch)
    budget = dict(chunk_rows=8, max_coresident_chunks=2)
    for scheduling in ("continuous", "wavefront"):
        je = jengine.ServeEngine(
            jcfg, None, batch=3, max_len=MAX_LEN, plan_fusion=True,
            scheduling=scheduling,
            prefill_budget=jengine.PrefillBudget(**budget))
        want = capsys.readouterr().out
        te = engine.ServeEngine(
            tcfg, None, batch=3, max_len=MAX_LEN, device="cpu",
            scheduling=scheduling,
            prefill_budget=engine.PrefillBudget(**budget))
        got = capsys.readouterr().out
        assert got == want == ("[plan-fusion] decode step stays hand-wired: "
                               "norm 'layernorm' (rmsnorm only)\n")
        assert not (te.executed or je.executed)
        assert te.cache_len == je.cache_len == MAX_LEN
        assert te.fusion_plan.summary() == je.fusion_plan.summary()
    graph = te.decode_graph(prefill_chunks=n)
    deps = {g.op.name: g.deps for g in graph}
    proj = "moe_router" if tcfg.moe is not None else "ffn_proj"
    assert deps["decode_norm2"] == {"decode_norm1",
                                    next(k for k in deps
                                         if k.startswith("decode_attn"))}
    assert deps[proj] == {"decode_norm2"} and "qkv_proj" not in deps
    assert [(g.op.name, g.deps) for g in graph] == \
        [(g.op.name, g.deps) for g in je.decode_graph(prefill_chunks=n)]
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_paged_kv_refuses_with_the_reference_text(arch):
    jcfg, tcfg = _cfgs(arch)
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jcfg, None, batch=2, max_len=MAX_LEN,
                            plan_fusion=True, paged_kv=True)
    with pytest.raises(ValueError) as got:
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cpu", paged_kv=True)
    assert str(got.value) == str(want.value)
    assert "norm 'layernorm' (rmsnorm only)" in str(got.value)


def test_support_questions_differ_for_layernorm():
    """lm.supported builds LayerNorm; the executed program refuses it with
    the reference's text.  A frontend is built by lm.supported too, and the
    engines refuse its prompts when they run (token prompts only); what no
    config of the reference has, a frontend or block kind of a later
    family, is refused by lm.supported and by the engine."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        assert lm.supported(tcfg) is None
        assert (engine.executable_decode_supported(tcfg)
                == jengine.executable_decode_supported(jcfg)
                == "norm 'layernorm' (rmsnorm only)")
    for frontend in ("vision_stub", "audio_stub"):
        framed = dataclasses.replace(get_config("granite-3-2b").reduced(),
                                     frontend=frontend, num_codebooks=4)
        assert lm.supported(framed) is None
        eng = engine.ServeEngine(framed, None, batch=2, max_len=MAX_LEN,
                                 device="cpu", plan_fusion=False)
        with pytest.raises(NotImplementedError,
                           match="the engines take token prompts only"):
            eng.run([])
    base = get_config("granite-3-2b").reduced()
    for later in (dataclasses.replace(base, frontend="video_stub"),
                  dataclasses.replace(base, block_pattern=("hyena",))):
        assert lm.supported(later) is not None
        with pytest.raises(NotImplementedError,
                           match="does not serve it yet"):
            engine.ServeEngine(later, None, batch=2, max_len=MAX_LEN,
                               device="cpu", plan_fusion=False)


# ---------------------------------------------------------------------------
# configs: parameter counts, the exact dims, the shape table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(set(list_archs())
                                        & set(jlist_archs())))
def test_count_params_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert lm.count_params(tcfg) == jlm.count_params(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    red = (tcfg.reduced(), jcfg.reduced())
    assert lm.count_params(red[0]) == jlm.count_params(red[1])


def test_faithful_moe_active_params():
    tcfg = get_config("phi3.5-moe-42b-a6.6b")
    jcfg = jget_config("phi3.5-moe-42b-a6.6b")
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.active_param_count() < tcfg.param_count() / 5


# tests/test_models_smoke.py's table: (layers, d, heads, kv, d_ff, vocab)
EXACT_DIMS = {
    "stablelm-3b": (32, 2560, 32, 32, 6912, 50_304),
    "starcoder2-7b": (32, 4608, 36, 4, 18432, 49_152),
    "minitron-8b": (32, 4096, 32, 8, 16384, 256_000),
    "granite-3-2b": (40, 2048, 32, 8, 8192, 49_155),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32_064),
    "phi3.5-moe-rms": (32, 4096, 32, 8, 6400, 32_064),
}


@pytest.mark.parametrize("arch", sorted(EXACT_DIMS))
def test_exact_dims_and_shape_table(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == EXACT_DIMS[arch]
    assert cfg.supports_long_context == jcfg.supports_long_context is False
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            JSHAPES[name])
        assert shape_applicable(cfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name])
    ok, why = shape_applicable(cfg, SHAPES["long_500k"])
    assert not ok and why.startswith("full-attention arch")


def test_list_archs_holds_the_six():
    """The six configs above, recurrentgemma-2b, deepseek-v2-236b,
    xlstm-1.3b, internvl2-1b and musicgen-medium: eleven in all, the
    reference's (their dims: tests/test_torch_recurrent.py,
    tests/test_torch_mla.py, tests/test_torch_xlstm_lm.py,
    tests/test_torch_vision.py and tests/test_torch_audio.py)."""
    assert list_archs() == sorted(set(EXACT_DIMS) | {
        "recurrentgemma-2b", "deepseek-v2-236b", "xlstm-1.3b",
        "internvl2-1b", "musicgen-medium"})
    assert list_archs() == jlist_archs()
    assert len(list_archs()) == 11


# ---------------------------------------------------------------------------
# the update plan over a LayerNorm tree, full width, abstract parameters
# ---------------------------------------------------------------------------
def _abstract_full(arch="stablelm-3b"):
    jc, tc = jget_config(arch), get_config(arch)
    return (jax.eval_shape(lambda: jlm.init(jc, jax.random.PRNGKey(0))),
            lm.abstract_params(tc))


def _plan_rows(plan):
    return [(r["members"], r["schedule"], r["vmem_cap"],
             r["predicted_speedup_pct"], r["measured_speedup_pct"])
            for r in plan.summary()]


def test_full_width_update_plan_matches_reference():
    """stablelm-3b's four stacked (32, 2560) norm leaves tie in size; the
    plan keeps the same two of them as the reference's (a stable sort on
    the sorted-key flatten order)."""
    ja, ta = _abstract_full()
    jgraph, jlayout = jtl.update_graph(ja, tokens=4096)
    tgraph, tlayout = tl.update_graph(ta, tokens=4096)
    assert [g.op.name for g in tgraph] == [g.op.name for g in jgraph]
    assert [n for n, *_ in tlayout] == [n for n, *_ in jlayout]
    norms = [n for n, *_ in tlayout if "norm" in n]
    assert len(norms) == 2
    assert _plan_rows(tl.plan_update_fusion(ta, tokens=4096)) == \
        _plan_rows(jtl.plan_update_fusion(ja, tokens=4096))


def test_full_width_update_program_matches_reference():
    ja, ta = _abstract_full()
    jprog = jtl.build_update_program(ja)
    tprog = tl.build_update_program(ta)
    assert tprog.describe() == jprog.describe()
    assert _plan_rows(tprog.plan) == _plan_rows(jprog.plan)
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
    assert sum(1 for _n, p, *_ in tprog.layout if p[-1] == "bias") == 3
