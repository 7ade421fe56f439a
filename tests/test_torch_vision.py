"""internvl2-1b (the image stub: ``pixel_embeds`` in place of the first
n token rows, the loss masked there, a tied head) in the port's model,
trainer and engines against the JAX package, on the CPU.

Two forms: ``reduced()`` (one attention layer, 8 image rows) and a
two-layer form whose layers stack into one run (stacked params and cache
leaves).  Both packages get the same weights: numpy trees made from a seed
(RMSNorm scales N(0, 0.3), every weight N(0, 1/fan_in), the embedding
N(0, 0.02)), handed to JAX as arrays and to the port through
``lm.params_from_numpy``; the batches are the port's data pipeline's (Zipf
tokens, seeded fp32 ``pixel_embeds``, labels -1 on the image rows).  Each
form runs in fp32 and in bf16.

Tolerances.  fp32: the logits, each leaf's gradient, the train step's
params, m and v, and every cache leaf within 1e-5 relative L2 of the
reference's; the loss to 1e-5 relative (``ce`` equal in fp32 to 1e-6), the
grad norm to 1e-5.  bf16, the rule of ``tests/test_torch_recurrent.py``:
2e-2 relative L2 of the reference's, or 1.5 times the reference's own
distance from its fp32 twin (the bf16 weights cast up) where that is
larger; the loss to 1e-3 relative.  Prefill + decode against the forward:
fp32 1e-4 relative plus 2e-5 absolute; bf16 2e-2 relative L2.  Greedy
tokens are equal step for step; masks, cache positions, plans, op shapes,
notices and launch tables are equal.
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
from repro.configs import shape_applicable as jshape_applicable
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import tree as tree_mod
from repro_torch.configs import ATTN, SHAPES, get_config, shape_applicable
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import lm
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop as tl

ARCH = "internvl2-1b"
FORMS = ["reduced", "two"]
DTYPES = ["float32", "bfloat16"]
BF16_REL_L2 = 2e-2
BF16_ACCURACY = 1.5
FP32_REL_L2 = 1e-5
SEQ, BATCH, MAX_LEN = 16, 2, 48
N_IMAGE = 8                         # reduced()'s num_image_tokens


def _cfgs(form="reduced", dtype="float32"):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
        if form == "two":
            c = dataclasses.replace(c, num_layers=2, block_pattern=(ATTN,) * 2)
        out.append(c)
    return out


def _numpy_tree(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = rng.normal(size=sd.shape) * 0.3
        else:
            fan_in = sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[-1]
            a = rng.normal(size=sd.shape) * (
                0.02 if name == "embedding" else fan_in ** -0.5)
        dt = (ml_dtypes.bfloat16 if sd.dtype == jnp.bfloat16
              else np.dtype(sd.dtype))
        return a.astype(dt)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.cache
def _shared(form, dtype):
    jcfg, tcfg = _cfgs(form, dtype)
    tree = _numpy_tree(jcfg)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, tree


@functools.cache
def _twin(form):
    """The reference in fp32 over the bf16 weights."""
    jcfg, jp, _tcfg, _tree = _shared(form, "bfloat16")
    return (dataclasses.replace(jcfg, dtype="float32"),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp))


def _model(form="reduced", dtype="float32"):
    """(jcfg, jax params, tcfg, port params afresh)."""
    jcfg, jp, tcfg, tree = _shared(form, dtype)
    return jcfg, jp, tcfg, lm.params_from_numpy(tcfg, tree, device="cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, want32=None):
    err = _rel_l2(got, want)
    if dtype == "float32":
        assert err <= FP32_REL_L2, f"rel L2 {err}"
        return
    ref_err = 0.0 if want32 is None else _rel_l2(want, want32)
    assert err <= max(BF16_REL_L2, BF16_ACCURACY * ref_err), \
        f"rel L2 {err}; the reference's bf16 from fp32 {ref_err}"


def _flat(tree):
    return [(tuple(k.key for k in p), a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _trees_close(jtree, ttree, dtype, jtree32=None):
    jl = _flat(jtree)
    j32 = [a for _p, a in _flat(jtree32)] if jtree32 is not None \
        else [None] * len(jl)
    tlv = tree_mod.flatten_with_paths(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tlv]
    for (_path, a), a32, (p, b) in zip(jl, j32, tlv):
        try:
            _close(b, a, dtype, a32)
        except AssertionError as e:
            raise AssertionError(f"{'/'.join(p)}: {e}") from None


def _abstract_rows(jcfg, tcfg):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = [(tuple(k.key for k in p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_mod.flatten_with_paths(lm.abstract_params(tcfg))]
    return got, want


# ---------------------------------------------------------------------------
# the config and the parameter tree
# ---------------------------------------------------------------------------
def test_config_counts_and_support():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.reduced().num_image_tokens == N_IMAGE
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.num_image_tokens) == \
        (24, 896, 14, 2, 4864, 151_655, 256)
    assert cfg.tie_embeddings and cfg.rope_theta == 1e6
    assert lm.count_params(cfg) == jlm.count_params(jcfg) == 493_753_344
    assert lm.count_params(cfg.reduced()) == jlm.count_params(jcfg.reduced())
    assert lm.supported(cfg) is None and lm.supported(cfg.reduced()) is None
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name])
    assert (engine.executable_decode_supported(cfg)
            == jengine.executable_decode_supported(jcfg)
            == "frontend 'vision_stub' (token frontend only)")


def test_param_trees_match_reference():
    """Both forms and full width: every path, shape and dtype; no head
    (tied)."""
    for jcfg, tcfg in (_cfgs("reduced"), _cfgs("two"),
                       (jget_config(ARCH), get_config(ARCH))):
        got, want = _abstract_rows(jcfg, tcfg)
        assert got == want
        assert "head" not in lm.param_layout(tcfg)
    assert [(r.name, r.count) for r in lm.layer_runs(_cfgs("two")[1])] == \
        [("run00_attn", 2)]


def test_params_from_numpy_keeps_the_weights():
    for form in FORMS:
        for dtype in DTYPES:
            _jcfg, _jp, tcfg, tree = _shared(form, dtype)
            tp = lm.params_from_numpy(tcfg, tree, device="cpu")
            for (path, a), (tpath, b) in zip(
                    _flat(tree), tree_mod.flatten_with_paths(tp)):
                assert path == tpath
                np.testing.assert_array_equal(_f32(b), _f32(a))


# ---------------------------------------------------------------------------
# the model: embedding, forward, loss, gradients, one train step
# ---------------------------------------------------------------------------
def _batch(cfg, batch=BATCH, seq=SEQ, step=0):
    nb = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        num_image_tokens=cfg.num_image_tokens,
        d_model=cfg.d_model)).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


@pytest.mark.parametrize("S", [4, N_IMAGE, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_inputs_match_reference(dtype, S):
    """The image rows replace the first n rows (S below n gives n rows),
    bitwise; the mask is the reference's."""
    jcfg, jp, tcfg, tp = _model("reduced", dtype)
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(1, 512, (2, S)).astype(np.int32),
         "pixel_embeds": rng.standard_normal((2, N_IMAGE, 64)).astype(
             np.float32)}
    jx, jm = jlm._embed_inputs(jcfg, jp, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    tx, tm = lm._embed_inputs(tcfg, tp, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    assert tx.shape == jx.shape == (2, max(S, N_IMAGE), 64)
    assert tx.dtype == lm.torch_dtype(dtype)
    np.testing.assert_array_equal(_f32(tx), _f32(jx))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_forward_loss_and_grads_match_reference(form, dtype):
    """Logits, the mask, ce (the pipeline's -1 labels and the mask both
    apply) and every gradient."""
    jcfg, jp, tcfg, tp = _model(form, dtype)
    jb, tb = _batch(tcfg)
    assert (np.asarray(jb["labels"])[:, :N_IMAGE] == -1).all()

    def reference(c, p):
        logits, _aux, mask = jlm.forward(c, p, jb)
        (loss, met), g = jax.value_and_grad(
            lambda q: jlm.loss_fn(c, q, jb, remat=True), has_aux=True)(p)
        return logits, mask, loss, met["ce"], g
    jlogits, jmask, jloss, jce, jg = jax.jit(
        functools.partial(reference, jcfg))(jp)
    jl32 = jg32 = None
    if dtype == "bfloat16":
        c32, p32 = _twin(form)
        jl32, _m, _l, _c, jg32 = jax.jit(functools.partial(reference,
                                                           c32))(p32)
    tlogits, _aux, tmask = lm.forward(tcfg, tp, tb)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _close(tlogits, jlogits, dtype, jl32)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    tloss, met = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                            remat=True)
    tloss.backward()
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jce),
                               rtol=1e-6 if dtype == "float32" else 1e-3)
    _trees_close(jg, grads, dtype, jg32)
    # the image rows' labels do not reach the loss
    tb2 = dict(tb, labels=tb["labels"].clone())
    tb2["labels"][:, :N_IMAGE] = 7
    assert lm.loss_fn(tcfg, tp, tb2)[1]["ce"].item() == \
        pytest.approx(float(met["ce"].detach()), rel=1e-6)


def _moments(jp):
    rng = np.random.default_rng(1)
    leaves = jax.tree_util.tree_leaves(jp)
    m = [(rng.normal(size=a.shape) * 1e-3).astype(np.float32) for a in leaves]
    v = [(rng.random(size=a.shape) * 1e-5).astype(np.float32) for a in leaves]
    treedef = jax.tree_util.tree_structure(jp)
    return tuple(jax.tree_util.tree_unflatten(treedef, t) for t in (m, v))


OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@functools.cache
def _reference_step(form, dtype, accum=1, twin=False):
    jcfg, jp, tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
    jb, _tb = _batch(tcfg, batch=2 * accum)
    m, v = (jax.tree_util.tree_map(jnp.asarray, t) for t in _moments(jp))
    jstep = jax.jit(jtl.make_train_step(jcfg, jtl.TrainConfig(
        optimizer=jopt.AdamWConfig(**OCFG), remat=False, grad_accum=accum)))
    return jstep(jp, jopt.OptState(m, v, jnp.asarray(2, jnp.int32)), jb,
                 jnp.asarray(0))


@pytest.mark.parametrize("dtype,route", [("float32", "plain"),
                                         ("float32", "program"),
                                         ("float32", "accum2"),
                                         ("bfloat16", "plain")])
@pytest.mark.parametrize("form", FORMS)
def test_train_step_matches_reference(form, dtype, route):
    """One step on both update routes (the planned program updates in
    place) and in two micro-batches (the batch's ``pixel_embeds`` split
    with its tokens); the tied embedding moves."""
    _jcfg, jp, tcfg, tp = _model(form, dtype)
    accum = 2 if route == "accum2" else 1
    _jb, tb = _batch(tcfg, batch=2 * accum)
    m, v = _moments(jp)
    ocfg = opt_mod.AdamWConfig(**OCFG)
    prog = (tl.build_update_program(lm.abstract_params(tcfg), ocfg)
            if route == "program" else None)
    step = tl.make_train_step(tcfg, tl.TrainConfig(
        optimizer=ocfg, remat=False, grad_accum=accum), update_program=prog)
    emb0 = tp["embed"]["embedding"].clone()
    new_p, new_s, met = step(tp, opt_mod.opt_state_from_numpy(m, v, 2, tp),
                             tb, 0)
    jp2, js2, jmet = _reference_step(form, dtype, accum)
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=FP32_REL_L2 if dtype == "float32"
                               else BF16_REL_L2)
    p32 = m32 = v32 = None
    if dtype == "bfloat16":
        p32, s32, _ = _reference_step(form, dtype, twin=True)
        m32, v32 = s32.m, s32.v
    _trees_close(jp2, new_p, dtype, p32)
    _trees_close(js2.m, new_s.m, dtype, m32)
    _trees_close(js2.v, new_s.v, dtype, v32)
    assert not torch.equal(new_p["embed"]["embedding"], emb0)
    if route == "program":
        assert new_p is tp


# ---------------------------------------------------------------------------
# the hand-wired serve path
# ---------------------------------------------------------------------------
@functools.cache
def _reference_decode(form, dtype, twin=False):
    jcfg, jp, _tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
    return (jax.jit(lambda b: jlm.prefill(jcfg, jp, b, max_len=40)),
            jax.jit(lambda c, t: jlm.decode_step(jcfg, jp, c, t)))


def _cache_close(tc, jc, dtype, jc32=None):
    assert set(tc) == set(jc)
    assert int(tc["pos"]) == int(jc["pos"])
    for run, leaves in tc.items():
        if run == "pos":
            continue
        assert set(leaves) == set(jc[run])
        for k, t in leaves.items():
            assert t.shape == jc[run][k].shape and \
                t.dtype == lm.torch_dtype(str(jc[run][k].dtype)), (run, k)
            _close(t, jc[run][k], dtype,
                   None if jc32 is None else jc32[run][k])


def _prompt(S, seed=8):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, 512, (2, S)).astype(np.int32),
            "pixel_embeds": rng.standard_normal((2, N_IMAGE, 64)).astype(
                np.float32)}


@pytest.mark.parametrize("dtype,S", [("float32", 4), ("float32", N_IMAGE),
                                     ("float32", 13), ("bfloat16", 4),
                                     ("bfloat16", 13)])
@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_step_match_reference(form, dtype, S):
    """An image prompt below, at and past its n = 8 image rows: the
    prefill's logits and cache (``pos`` max(S, n)), then four decode
    steps, each side fed its own greedy tokens: the tokens equal step for
    step, the logits and every cache leaf within tolerance."""
    b = _prompt(S)
    jcfg = _cfgs(form, dtype)[0]
    prefill, decode = _reference_decode(form, dtype)
    jc, jl = prefill({k: jnp.asarray(v) for k, v in b.items()})
    jc32 = jl32 = None
    if dtype == "bfloat16":
        prefill32, decode32 = _reference_decode(form, dtype, True)
        jc32, jl32 = prefill32({k: jnp.asarray(v) for k, v in b.items()})
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    tc, tlog = lm.prefill(tcfg, tp, {k: torch.from_numpy(v)
                                     for k, v in b.items()}, max_len=40)
    assert int(tc["pos"]) == int(jc["pos"]) == max(S, N_IMAGE)
    for _ in range(4):
        _close(tlog, jl, dtype, jl32)
        _cache_close(tc, jc, dtype, jc32)
        jt = np.asarray(jlm.greedy_sample(jcfg, jl))
        tt = lm.greedy_sample(tcfg, tlog)
        np.testing.assert_array_equal(tt.numpy(), jt)
        jl, jc = decode(jc, jnp.asarray(jt))
        if jc32 is not None:
            jl32, jc32 = decode32(jc32, jnp.asarray(jt))
        tlog, tc = lm.decode_step(tcfg, tp, tc, tt)
    _close(tlog, jl, dtype, jl32)
    _cache_close(tc, jc, dtype, jc32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_match_forward(form, dtype):
    """prefill(S) and 4 decode steps against the forward of S + 4 at the
    same positions (S past the image rows, and S at them)."""
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    for S in (N_IMAGE, 12):
        b = {k: torch.from_numpy(v) for k, v in _prompt(S + 4, 9).items()}
        full = lm.forward(tcfg, tp, b)[0]
        cache, logits = lm.prefill(
            tcfg, tp, dict(b, tokens=b["tokens"][:, :S]), max_len=S + 4)
        got = [logits]
        for i in range(4):
            logits, cache = lm.decode_step(tcfg, tp, cache,
                                           b["tokens"][:, S + i])
            got.append(logits)
        for i, g in enumerate(got):
            want = full[:, S - 1 + i]
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), want.numpy(),
                                           rtol=1e-4, atol=2e-5)
            else:
                assert _rel_l2(g, want) <= BF16_REL_L2, (S, i)


def test_greedy_serve_step_matches_reference():
    """lm.serve_step_greedy: (B,) tokens, the reference's, for 4 steps
    after a prompt below the image block."""
    jcfg, jp, tcfg, tp = _model("two")
    b = _prompt(5, 10)
    jc, jl = jlm.prefill(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()},
                         max_len=16)
    tc, tlog = lm.prefill(tcfg, tp, {k: torch.from_numpy(v)
                                     for k, v in b.items()}, max_len=16)
    jt, tt = jlm.greedy_sample(jcfg, jl), lm.greedy_sample(tcfg, tlog)
    step = jax.jit(lambda c, t: jlm.serve_step_greedy(jcfg, jp, c, t))
    for _ in range(4):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tt.shape == (2,) and tt.dtype == torch.int32
        jt, jc = step(jc, jt)
        tt, tc = lm.serve_step_greedy(tcfg, tp, tc, tt)
    assert int(tc["pos"]) == int(jc["pos"]) == N_IMAGE + 4


# ---------------------------------------------------------------------------
# the engines and the CLIs
# ---------------------------------------------------------------------------
NOTICE = ("[plan-fusion] decode step stays hand-wired: frontend "
          "'vision_stub' (token frontend only)\n")


@pytest.mark.parametrize("scheduling", ["continuous", "wavefront"])
def test_planned_engine_notice_and_plan(scheduling, capsys):
    """The reference's notice, plan and launch tables (the op shapes:
    tests/test_torch_fallback_graph.py); on the card the planned engine
    refuses and names --hand-wired."""
    jcfg, tcfg = _cfgs("two")
    budget = dict(chunk_rows=8, max_coresident_chunks=2)
    je = jengine.ServeEngine(jcfg, None, batch=3, max_len=MAX_LEN,
                             plan_fusion=True, scheduling=scheduling,
                             prefill_budget=jengine.PrefillBudget(**budget))
    want = capsys.readouterr().out
    te = engine.ServeEngine(tcfg, None, batch=3, max_len=MAX_LEN,
                            device="cpu", scheduling=scheduling,
                            prefill_budget=engine.PrefillBudget(**budget))
    assert capsys.readouterr().out == want == NOTICE
    assert not (te.executed or je.executed)
    assert te.fusion_plan.summary() == je.fusion_plan.summary()
    for n in (0, 1, 2):
        assert (te.build_decode_program(prefill_chunks=n).describe()
                == je.build_decode_program(prefill_chunks=n).describe())


def test_planned_engine_refuses_on_the_card(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match=r"frontend 'vision_stub' \(token "
                       r"frontend only\) — pass plan_fusion=False \(serve "
                       r"CLI: --hand-wired\)"):
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cuda")


@pytest.mark.parametrize("plan_fusion", [False, True])
def test_engine_run_refuses_image_prompts(plan_fusion):
    """The engines take token prompts only: ``run`` raises before any
    step, where the reference's fails inside ``lm.prefill`` (no
    ``pixel_embeds``; ROADMAP §3)."""
    jcfg, jp, tcfg, tp = _model()
    with contextlib.redirect_stdout(io.StringIO()):
        te = engine.ServeEngine(tcfg, tp, batch=2, max_len=MAX_LEN,
                                device="cpu", plan_fusion=plan_fusion)
    req = [engine.Request(rid=0, prompt=np.arange(1, 13, dtype=np.int32),
                          max_new_tokens=2)]
    with pytest.raises(NotImplementedError,
                       match="the engines take token prompts only; frontend "
                       "'vision_stub' needs pixel_embeds"):
        te.run(req)
    assert req[0].out_tokens == []
    je = jengine.ServeEngine(jcfg, jp, batch=2, max_len=MAX_LEN,
                             plan_fusion=False)
    with pytest.raises(KeyError, match="pixel_embeds"):
        je.run([jengine.Request(rid=0, prompt=np.arange(1, 13,
                                                        dtype=np.int32),
                                max_new_tokens=2)])


def test_serve_cli_refuses():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="the engines take token prompts "
                       "only"):
        serve.main(["--arch", ARCH, "--scale", "smoke", "--device", "cpu",
                    "--hand-wired"])


def test_train_cli_smoke(capsys):
    """--scale smoke on the CPU trains on the pipeline's image batches
    (the launcher builds its DataConfig as the reference's)."""
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--scale", "smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16", "--plan-fusion"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "executed update program" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the update plan and program
# ---------------------------------------------------------------------------
def _plan_rows(plan):
    return [(r["members"], r["schedule"], r["vmem_cap"],
             r["predicted_speedup_pct"], r["measured_speedup_pct"])
            for r in plan.summary()]


def test_full_width_update_plan_matches_reference():
    """At 8192 tokens: two fp32 dW->AdamW chains (the stacked norm
    scales) and six AdamW singles, the tied (151655, 896) embedding among
    them."""
    jc, tc = jget_config(ARCH), get_config(ARCH)
    ja = jax.eval_shape(lambda: jlm.init(jc, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(tc)
    jgraph, jlayout = jtl.update_graph(ja, tokens=8192)
    tgraph, tlayout = tl.update_graph(ta, tokens=8192)
    assert [(g.op.name, g.deps) for g in tgraph] == \
        [(g.op.name, g.deps) for g in jgraph]
    assert [n for n, *_ in tlayout] == [n for n, *_ in jlayout]
    plan = tl.plan_update_fusion(ta, tokens=8192)
    assert _plan_rows(plan) == _plan_rows(jtl.plan_update_fusion(
        ja, tokens=8192))
    chains = [g.op for g in plan.graph if g.op.chain]
    assert sorted(c.name for c in chains) == [
        f"dW_run00_attn____{n}____scale→adamw_run00_attn____{n}____scale"
        for n in ("norm1", "norm2")]
    singles = {g.op.name: g.op for g in plan.graph if not g.op.chain}
    assert len(singles) == 6
    emb = singles["adamw_embed____embedding"].member   # padded to bm rows
    assert emb.R % emb.bm == 0
    assert 0 <= emb.R * 128 - 151_655 * 896 < emb.bm * 128


@pytest.mark.parametrize("form", FORMS)
def test_update_program_matches_reference(form):
    jcfg, tcfg = _cfgs(form)
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    jprog = jtl.build_update_program(ja)
    tprog = tl.build_update_program(lm.abstract_params(tcfg))
    assert tprog.describe() == jprog.describe()
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
