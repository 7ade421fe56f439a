"""xlstm-1.3b (mLSTM and sLSTM runs, blocks without an FFN) in the port's
model and engines against the JAX package, on the CPU.

Two forms: ``reduced()`` (one mLSTM layer, one sLSTM layer) and a
four-layer ``(MLSTM, MLSTM, SLSTM, SLSTM)`` form, where both kinds are
stacked runs with stacked cache leaves.  Both packages get the same
weights: numpy trees made from a seed (LayerNorm scales N(1, 0.3) and
biases N(0, 0.1), gate, conv and zifo biases and the head norms' scales
N(0, 0.1), every weight N(0, 1/fan_in), the embedding N(0, 0.02)), handed
to JAX as arrays and to the port through ``lm.params_from_numpy``.  Each
form runs in fp32 and in bf16.

Tolerances.  fp32: the logits, each leaf's gradient, the train step's
params, m and v, and every cache leaf within 1e-4 relative L2 of the
reference's; the loss to 1e-5 relative, the grad norm to 1e-4.  The
mLSTM divides by |q n|, which magnifies fp32 rounding where that is
small, so element by element the reference is not even within 1e-5 of
itself: jitted and op by op it differs by 4.6e-5 on the reduced form's
logits (up to 4.4) and by 3.1e-5 relative L2 on a gradient leaf, and the
port lies 1.7e-6..4.8e-6 from it on the logits and up to 5.6e-5 on a
gradient leaf (each block alone 2e-7..1.2e-6).  bf16, the rule of
``tests/test_torch_recurrent.py``: logits, each leaf's gradient, the train
step's params, m and v, the cache leaves to 2e-2 relative L2 of the
reference's, or 1.5 times the reference's own distance from its fp32 twin
(the bf16 weights cast up) where that is larger; the loss to 1e-3
relative, the grad norm to 2e-2.  Prefill + decode against the forward:
fp32 1e-4 relative plus 2e-5 absolute; bf16 2e-2 relative L2, or 1.5 times
the reference's own distance between its decode and its forward (4.1e-2
against 3.5e-2 on the four-layer form).  Served tokens and
``ServeStats`` are equal; plans, op shapes and launch tables are equal.

The model's sequences are 16 tokens (one mLSTM chunk): at chunks of 256
the reference's gate gradients are NaN (``tests/test_torch_xlstm.py``).
The engines are compared at prompt lengths of 3 tokens or more, where the
reference can decode; shorter prompts are held against the reference's
forward.
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
from repro_torch.configs import (MLSTM, SHAPES, SLSTM, get_config,
                                 shape_applicable)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import lm, xlstm
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop as tl

ARCH = "xlstm-1.3b"
FOUR = (MLSTM, MLSTM, SLSTM, SLSTM)
FORMS = ["reduced", "four"]
DTYPES = ["float32", "bfloat16"]
BF16_REL_L2 = 2e-2
BF16_ACCURACY = 1.5
FP32_REL_L2 = 1e-4
SEQ, BATCH, MAX_LEN = 16, 2, 48
REC_LEAVES = ("gate_b", "b_zifo", "r_zifo", "out_norm", "conv_w", "conv_b")


def _cfgs(form="reduced", dtype="float32"):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
        if form == "four":
            c = dataclasses.replace(c, num_layers=4, block_pattern=FOUR)
        out.append(c)
    return out


def _numpy_tree(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = 1.0 + rng.normal(size=sd.shape) * 0.3
        elif name in ("bias", "conv_b", "gate_b", "b_zifo", "out_norm"):
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
def _shared(form, dtype):
    jcfg, tcfg = _cfgs(form, dtype)
    tree = _numpy_tree(jcfg)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, tree


@functools.cache
def _twin(form):
    """The reference in fp32 over the bf16 weights: what a bf16 run
    approximates."""
    jcfg, jp, _tcfg, _tree = _shared(form, "bfloat16")
    return (dataclasses.replace(jcfg, dtype="float32"),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp))


def _model(form="reduced", dtype="float32"):
    """(jcfg, jax params, tcfg, port params); the port's params afresh
    each call (the update program writes them in place)."""
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
    """fp32: within FP32_REL_L2.  bf16: within BF16_REL_L2 of the
    reference's result, or BF16_ACCURACY times that result's own distance
    from ``want32`` where that is larger."""
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


# ---------------------------------------------------------------------------
# the config and the parameter tree
# ---------------------------------------------------------------------------
def test_supported_and_blocks_without_an_ffn():
    """lm.supported builds xlstm-1.3b; its blocks have no norm2 and no
    mlp; d_ff 0 leaves the FFN out of an attention block too, as in the
    reference."""
    cfg = get_config(ARCH)
    assert lm.supported(cfg) is None and lm.supported(cfg.reduced()) is None
    layout = lm.param_layout(cfg.reduced())
    for run in lm.layer_runs(cfg.reduced()):
        assert set(layout[run.name]) == {"norm1", "rec"}
    jcfg, tcfg = (dataclasses.replace(get(
        "granite-3-2b").reduced(), d_ff=0, dtype="float32")
        for get in (jget_config, get_config))
    assert lm.supported(tcfg) is None
    tree = _numpy_tree(jcfg)
    assert set(tree["run00_attn"]) == {"norm1", "attn"}
    tp = lm.params_from_numpy(tcfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(1, 512, (2, 8)).astype(np.int32)
    want = jlm.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                       {"tokens": jnp.asarray(toks)})[0]
    got = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_param_tree_matches_reference():
    for form in FORMS:
        jcfg, tcfg = _cfgs(form)
        shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
        want = [(tuple(k.key for k in p), tuple(s.shape), str(s.dtype))
                for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
        got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for p, t in tree_mod.flatten_with_paths(
                   lm.abstract_params(tcfg))]
        assert got == want
    assert [(r.name, r.count) for r in lm.layer_runs(tcfg)] == [
        ("run00_mlstm", 2), ("run02_slstm", 2)]


def test_params_from_numpy_keeps_the_weights():
    """The reference's params as numpy arrays, no change beyond the
    layout: every leaf bitwise, on both forms and both dtypes."""
    for form in FORMS:
        for dtype in DTYPES:
            _jcfg, _jp, tcfg, tree = _shared(form, dtype)
            tp = lm.params_from_numpy(tcfg, tree, device="cpu")
            for (path, a), (tpath, b) in zip(
                    _flat(tree), tree_mod.flatten_with_paths(tp)):
                assert path == tpath
                np.testing.assert_array_equal(_f32(b), _f32(a))


def test_full_width_abstract_params_match_reference():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = [(tuple(k.key for k in p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_mod.flatten_with_paths(lm.abstract_params(tcfg))]
    assert got == want
    assert lm.count_params(tcfg) == jlm.count_params(jcfg) == 2_901_496_144
    runs = lm.layer_runs(tcfg)
    assert len(runs) == 12 and [r.count for r in runs] == [7, 1] * 6
    assert runs[1].name == "run07_slstm"


def test_count_params_dims_and_long_context():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (48, 2048, 4, 4, 512, 0, 50_304)
    assert cfg.pattern == ((MLSTM,) * 7 + (SLSTM,)) * 6
    assert cfg.supports_long_context and jcfg.supports_long_context
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name]) == (True, "")
    assert engine.executable_decode_supported(cfg) == \
        jengine.executable_decode_supported(jcfg)


@pytest.mark.parametrize("form", FORMS)
def test_init_cache_matches_reference(form):
    """Every leaf's shape, dtype and fill: zeros, and NEG in every m."""
    jcfg, tcfg = _cfgs(form)
    want = jlm.init_cache(jcfg, 3, MAX_LEN)
    got = lm.init_cache(tcfg, 3, MAX_LEN, device="cpu")
    for run in lm.layer_runs(tcfg):
        assert set(got[run.name]) == set(want[run.name])
        for k, t in got[run.name].items():
            w = want[run.name][k]
            assert tuple(t.shape) == w.shape
            assert t.dtype == lm.torch_dtype(str(w.dtype))
            np.testing.assert_array_equal(_f32(t), _f32(w))
    assert bool((got["run00_mlstm"]["m"] == xlstm.NEG).all())


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients, one train step
# ---------------------------------------------------------------------------
def _batch(cfg):
    nb = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH)).batch_at(0)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_forward_loss_and_grads_match_reference(form, dtype):
    jcfg, jp, tcfg, tp = _model(form, dtype)
    jb, tb = _batch(tcfg)

    def reference(c, p):
        return (jlm.forward(c, p, jb)[0], jax.value_and_grad(
            lambda q: jlm.loss_fn(c, q, jb, remat=True)[0])(p))
    jlogits, (jloss, jg) = jax.jit(functools.partial(reference, jcfg))(jp)
    jl32 = jg32 = None
    if dtype == "bfloat16":
        c32, p32 = _twin(form)
        jl32, (_, jg32) = jax.jit(functools.partial(reference, c32))(p32)
    tlogits, _aux, _m = lm.forward(tcfg, tp, tb)
    _close(tlogits, jlogits, dtype, jl32)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    tloss, _ = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                          remat=True)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    _trees_close(jg, grads, dtype, jg32)
    # every recurrent leaf of every layer has a gradient
    count = {r.name: r.count for r in lm.layer_runs(tcfg)}
    for path, g in tree_mod.flatten_with_paths(grads):
        if "rec" in path:
            per_layer = g.reshape(count[path[0]], -1)
            assert bool((per_layer != 0).any(dim=1).all()), path


def _moments(jp):
    rng = np.random.default_rng(1)
    leaves = jax.tree_util.tree_leaves(jp)
    m = [(rng.normal(size=a.shape) * 1e-3).astype(np.float32) for a in leaves]
    v = [(rng.random(size=a.shape) * 1e-5).astype(np.float32) for a in leaves]
    treedef = jax.tree_util.tree_structure(jp)
    return tuple(jax.tree_util.tree_unflatten(treedef, t) for t in (m, v))


@functools.cache
def _reference_step(form, dtype, twin=False):
    jcfg, jp, tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
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
@pytest.mark.parametrize("form", FORMS)
def test_train_step_matches_reference(form, dtype, route):
    _jcfg, jp, tcfg, tp = _model(form, dtype)
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
    jp2, js2, jmet = _reference_step(form, dtype)
    p32 = m32 = v32 = None
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=FP32_REL_L2 if dtype == "float32"
                               else BF16_REL_L2)
    if dtype == "bfloat16":
        p32, s32, _ = _reference_step(form, dtype, twin=True)
        m32, v32 = s32.m, s32.v
    _trees_close(jp2, new_p, dtype, p32)
    _trees_close(js2.m, new_s.m, dtype, m32)
    _trees_close(js2.v, new_s.v, dtype, v32)
    start = dict(tree_mod.flatten_with_paths(
        lm.params_from_numpy(tcfg, _shared(form, dtype)[3], device="cpu")))
    moved = set()
    for path, b in tree_mod.flatten_with_paths(new_p):
        if path[-1] in REC_LEAVES:
            assert not torch.equal(b, start[path]), path
            moved.add(path[-1])
    assert moved == set(REC_LEAVES)
    if route == "program":
        assert new_p is tp              # the program updates in place
        assert {p[-1] for _n, p, *_ in prog.layout} >= set(REC_LEAVES)


# ---------------------------------------------------------------------------
# the hand-wired serve path
# ---------------------------------------------------------------------------
@functools.cache
def _reference_decode(form, dtype, twin=False):
    """The reference's jitted prefill (max_len 40), decode step and
    forward over the shared weights (``twin``: the bf16 weights in
    fp32)."""
    jcfg, jp, _tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
    return (jax.jit(lambda b: jlm.prefill(jcfg, jp, b, max_len=40)),
            jax.jit(lambda c, t: jlm.decode_step(jcfg, jp, c, t)),
            jax.jit(lambda b: jlm.forward(jcfg, jp, b)[0]))


def _cache_close(tc, jc, dtype, jc32=None):
    for run, leaves in tc.items():
        if run == "pos":
            assert int(leaves) == int(jc["pos"])
            continue
        assert set(leaves) == set(jc[run])
        for k, t in leaves.items():
            assert t.shape == jc[run][k].shape and \
                t.dtype == lm.torch_dtype(str(jc[run][k].dtype)), (run, k)
            _close(t, jc[run][k], dtype,
                   None if jc32 is None else jc32[run][k])


@pytest.mark.parametrize("dtype,S", [("float32", 3), ("float32", 13),
                                     ("bfloat16", 13)])
@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_step_match_reference(form, dtype, S):
    """Prefill of S tokens and four decode steps, logits and every cache
    leaf (each layer's state and conv window) against the reference's;
    and prefill + one decode == forward(S + 1)."""
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    toks = np.random.default_rng(8).integers(
        1, tcfg.vocab_size, (2, S + 1)).astype(np.int32)
    prefill, decode, fwd = _reference_decode(form, dtype)
    jc, jl = prefill({"tokens": jnp.asarray(toks[:, :S])})
    jc32 = jl32 = None
    if dtype == "bfloat16":
        prefill32, decode32, _fwd32 = _reference_decode(form, dtype, True)
        jc32, jl32 = prefill32({"tokens": jnp.asarray(toks[:, :S])})
    tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=40)
    full = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})[0]
    for i in range(4):
        _close(tlog, jl, dtype, jl32)
        _cache_close(tc, jc, dtype, jc32)
        cur = toks[:, S] if i == 0 else np.asarray(
            jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode(jc, jnp.asarray(cur))
        if jc32 is not None:
            jl32, jc32 = decode32(jc32, jnp.asarray(cur))
        tlog, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(cur))
        if i > 0:
            continue
        if dtype == "float32":
            np.testing.assert_allclose(tlog.numpy(), full[:, -1].numpy(),
                                       rtol=1e-4, atol=2e-5)
        else:
            own = _rel_l2(jl, fwd({"tokens": jnp.asarray(toks)})[:, -1])
            err = _rel_l2(tlog, full[:, -1])
            assert err <= max(BF16_REL_L2, BF16_ACCURACY * own), (err, own)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_decodes_and_matches_forward(S):
    """A prompt shorter than the conv's K - 1 = 3 rows: the conv tails are
    left-padded with zeros, so decode runs and matches the reference's
    forward of S + 4 (the reference's own decode raises there)."""
    jcfg, jp, tcfg, tp = _model("four", "float32")
    toks = np.random.default_rng(9).integers(
        1, tcfg.vocab_size, (2, S + 4)).astype(np.int32)
    want = np.asarray(_reference_decode("four", "float32")[2](
        {"tokens": jnp.asarray(toks)}))
    cache, logits = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=16)
    got = [logits]
    for i in range(3):
        logits, cache = lm.decode_step(tcfg, tp, cache,
                                       torch.from_numpy(toks[:, S + i]))
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), want[:, S - 1 + i], rtol=1e-4,
                                   atol=2e-5, err_msg=f"position {S - 1 + i}")
    jc, _ = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=16)
    with pytest.raises(Exception):
        jlm.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, S]))


def test_decode_state_matches_a_longer_prefill():
    """Prefill of 11 tokens and 4 decode steps hand on the state and conv
    windows that prefill of all 15 does (the chip's invariant), every leaf
    of every layer to 1e-4 relative plus 2e-5 absolute."""
    _jcfg, _jp, tcfg, tp = _model("four", "float32")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        1, tcfg.vocab_size, (2, 15)).astype(np.int32))
    cache, _ = lm.prefill(tcfg, tp, {"tokens": toks[:, :11]}, max_len=15)
    for t in range(11, 15):
        _, cache = lm.decode_step(tcfg, tp, cache, toks[:, t])
    want, _ = lm.prefill(tcfg, tp, {"tokens": toks}, max_len=15)
    assert int(cache["pos"]) == int(want["pos"]) == 15
    for (_r, a), (_w, b) in zip(lm.layer_params(tcfg, cache),
                                lm.layer_params(tcfg, want)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=1e-4, atol=2e-5, err_msg=k)


def _requests(mod, vocab, lens=(8, 32, 12, 3), budgets=(3, 5, 2, 4),
              seed=11):
    # prompts of 3 tokens or more: the reference decodes there
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m)
            for i, (L, m) in enumerate(zip(lens, budgets))]


def _stats(eng):
    st = eng.stats
    return st.describe(), st.admissions, st.retirements


@pytest.mark.parametrize("scheduling", ["continuous", "wavefront"])
@pytest.mark.parametrize("form", FORMS)
def test_hand_wired_engines_match_reference(form, scheduling):
    """The continuous fallback and the hand-wired wavefront, token for
    token with the reference's engines and with equal stats; a planned
    engine on the CPU stays hand-wired and serves the same tokens."""
    jcfg, jp, tcfg, tp = _model(form)
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


NOTICE = ("[plan-fusion] decode step stays hand-wired: needs a single "
          "global-attention layer run\n")


def _op_shapes(graph):
    def operands(ops):
        return tuple(tuple(o.shape) for o in ops)
    return [(g.op.name, g.deps, g.op.grid, operands(g.op.inputs),
             operands(g.op.outputs)) for g in graph]


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_planned_engine_notice_plan_and_op_shapes(form, n, capsys):
    """A planned engine prints the reference's notice, stays hand-wired at
    cache_len == max_len, and plans the reference's fallback graph: the
    same plan, op shapes (the projection d_model wide: no FFN) and launch
    table."""
    jcfg, tcfg = _cfgs(form)
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
        assert got == want == NOTICE
        assert not (te.executed or je.executed)
        assert te.cache_len == je.cache_len == MAX_LEN
        assert te.fusion_plan.summary() == je.fusion_plan.summary()
    graph = te.decode_graph(prefill_chunks=n)
    assert _op_shapes(graph) == _op_shapes(je.decode_graph(prefill_chunks=n))
    proj = next(g.op for g in graph if g.op.name == "ffn_proj")
    assert tuple(proj.outputs[0].shape) == (3, tcfg.d_model)
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())


def test_planned_engine_at_full_width_plans_the_reference_graph(capsys):
    """Batch 4, max_len 1024, PrefillBudget(512, 2): decode attention H 4,
    D 512 beside an ffn_proj of N d_model, fused with the two prefill
    chunks as the reference plans them."""
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    budget = dict(chunk_rows=512, max_coresident_chunks=2)
    je = jengine.ServeEngine(jcfg, None, batch=4, max_len=1024,
                             plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget))
    te = engine.ServeEngine(tcfg, None, batch=4, max_len=1024, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget))
    assert capsys.readouterr().out == NOTICE * 2
    members = [r["members"] for r in te.fusion_plan.summary()]
    assert members == [r["members"] for r in je.fusion_plan.summary()] == [
        "decode_attn_B4_S1024_H4kv4+prefill_attn0_C512_S1024_H4kv4",
        "ffn_proj+prefill_attn1_C512_S1024_H4kv4", "decode_norm1",
        "decode_norm2"]
    assert _op_shapes(te.decode_graph(prefill_chunks=2)) == \
        _op_shapes(je.decode_graph(prefill_chunks=2))
    assert (te.build_decode_program(prefill_chunks=2).describe()
            == je.build_decode_program(prefill_chunks=2).describe())


def test_planned_engine_refuses_on_the_card(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    for scheduling in ("continuous", "wavefront"):
        with pytest.raises(ValueError, match=r"needs a single global-"
                           r"attention layer run — pass plan_fusion=False "
                           r"\(serve CLI: --hand-wired\)"):
            engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                               device="cuda", scheduling=scheduling)


def test_paged_kv_refuses_with_the_reference_text():
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jcfg, None, batch=2, max_len=MAX_LEN,
                            plan_fusion=True, paged_kv=True)
    with pytest.raises(ValueError) as got:
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cpu", paged_kv=True)
    assert str(got.value) == str(want.value)


def test_serve_cli_smoke(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "8",
                "--max-new", "4", "--batch", "2", "--hand-wired",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out


def test_train_cli_smoke(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--plan-fusion"])
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
    """At 8192 tokens the reference plans eight AdamW singles, the w_up
    and w_v leaves of runs 00, 08, 16 and 24, and no dW chain."""
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
    assert sorted(g.op.name for g in plan.graph) == sorted(
        f"adamw_run{r:02d}_mlstm____rec____{w}"
        for r in (0, 8, 16, 24) for w in ("w_up", "w_v"))
    assert not any(g.op.chain for g in plan.graph)


@pytest.mark.parametrize("form", FORMS)
def test_update_program_matches_reference(form):
    """The executed update program over every leaf is the reference's,
    launch for launch."""
    jcfg, tcfg = _cfgs(form)
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(tcfg)
    jprog, tprog = jtl.build_update_program(ja), tl.build_update_program(ta)
    assert tprog.describe() == jprog.describe()
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
    assert {p[-1] for _n, p, *_ in tprog.layout} >= set(REC_LEAVES)
