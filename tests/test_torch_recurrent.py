"""recurrentgemma-2b (RG-LRU blocks and local attention in runs) in the
port against the JAX package, on the CPU.

Two forms: ``reduced()`` (one RG-LRU layer, one local-attention layer) and
a five-layer ``(RGLRU, RGLRU, LOCAL_ATTN, RGLRU, RGLRU)`` form, whose runs
stack.  Both packages get the same weights: numpy trees made from a seed
(RMSNorm scales N(0, 0.3), gate and conv biases N(0, 0.1), ``lam`` uniform
on [0.5, 6] so some channels remember long and some forget fast), handed
to JAX as arrays and to the port through ``lm.params_from_numpy``.  Each
form runs in fp32 and in bf16.

Tolerances, those of ``tests/test_torch_layernorm.py``.  fp32: the scan,
the step, the block and local attention to 1e-5 relative (plus 1e-6
absolute); logits and the loss to 1e-5 relative; gradients to 1e-4
relative plus 1e-6 absolute; one train step's params, m and v to rtol
2e-5, atol 2e-6; ``lm.prefill`` / ``lm.decode_step`` to 1e-4 relative plus
2e-5 absolute.  bf16: the block's outputs and state, local attention,
logits, each leaf's gradient, the train step's params, m and v to 2e-2
relative L2 of the reference's, the loss to 1e-3 relative, the grad norm
to 2e-2 (two gradients' norms differ by at most their L2 distance).  Where
the reference's own bf16 result lies further from the same computation in
fp32 (its fp32 twin: the bf16 weights cast up), the bound is 1.5 times
that distance: two bf16 roundings of one computation lie about sqrt(2)
times one's noise apart.  At two to five layers of random weights the
gradients' bf16 noise is 2-6.5e-2 in rel L2, and the compiled reference
(XLA keeps some bf16 sums in fp32) differs from itself run op by op by as
much.  Served
tokens and ``ServeStats`` are equal; plans and launch tables are equal.

The engines are compared at prompt lengths where the reference is right:
S < W or S % W == 0 for the local-attention ring, S >= 3 for the conv
window (ROADMAP §3).  Two tests hold the port's repairs there against the
reference's own full-sequence forward.
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
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import tree as tree_mod
from repro_torch.configs import LOCAL_ATTN, RGLRU, SHAPES, get_config
from repro_torch.configs import shape_applicable
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers, lm
from repro_torch.models import rglru
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop as tl

ARCH = "recurrentgemma-2b"
FIVE = (RGLRU, RGLRU, LOCAL_ATTN, RGLRU, RGLRU)
FORMS = ["reduced", "five"]
DTYPES = ["float32", "bfloat16"]
BF16_REL_L2 = 2e-2
BF16_ACCURACY = 1.5
SEQ, BATCH, MAX_LEN = 16, 2, 48


def _cfgs(form="reduced", dtype="float32"):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
        if form == "five":
            c = dataclasses.replace(c, num_layers=5, block_pattern=FIVE)
        out.append(c)
    return out


def _numpy_tree(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = rng.normal(size=sd.shape) * 0.3
        elif name in ("conv_b", "gate_a_b", "gate_x_b"):
            a = rng.normal(size=sd.shape) * 0.1
        elif name == "lam":
            a = rng.uniform(0.5, 6.0, size=sd.shape)
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
    """The reference in fp32 over the bf16 weights (each exactly
    representable in fp32): what a bf16 run approximates."""
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
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy().astype(np.float32)
    return np.asarray(a, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, rtol, atol, want32=None):
    """fp32: allclose.  bf16: within BF16_REL_L2 of the reference's bf16
    result, or of BF16_ACCURACY times that result's own distance from its
    fp32 twin ``want32`` where that is larger."""
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)
        return
    err = _rel_l2(got, want)
    ref_err = 0.0 if want32 is None else _rel_l2(want, want32)
    assert err <= max(BF16_REL_L2, BF16_ACCURACY * ref_err), \
        f"rel L2 {err}; the reference's bf16 from fp32 {ref_err}"


def _flat(tree):
    return [(tuple(k.key for k in p), a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _trees_close(jtree, ttree, dtype, rtol, atol, jtree32=None):
    jl = _flat(jtree)
    j32 = [a for _p, a in _flat(jtree32)] if jtree32 is not None \
        else [None] * len(jl)
    tlv = tree_mod.flatten_with_paths(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tlv]
    for (path, a), a32, (_p, b) in zip(jl, j32, tlv):
        try:
            _close(b, a, dtype, rtol, atol, a32)
        except AssertionError as e:
            raise AssertionError(f"{'/'.join(_p)}: {e}") from None


def _np(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _rec_params(dtype, seed=1):
    """One recurrent block's params (the reduced width) as numpy arrays."""
    jcfg, _ = _cfgs("reduced", dtype)
    tree = _numpy_tree(jcfg, seed)
    return jcfg, {k: np.asarray(v) for k, v in tree["run00_rglru"]["rec"]
                  .items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: lm._from_numpy(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# models/rglru.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rg_lru_scan_matches_reference(dtype, with_h0):
    """The parallel scan at a length that is not a power of two (odd
    levels on the way down) and with an initial state folded into step
    0; h_last stays fp32, y takes rec's dtype."""
    _jcfg, p = _rec_params(dtype)
    jp, tp = _both(p)
    rng = np.random.default_rng(2)
    rec = rng.normal(size=(2, 37, 64)).astype(_np(dtype))
    h0 = rng.normal(size=(2, 64)).astype(np.float32) if with_h0 else None
    jy, jh = jax.jit(jrglru.rg_lru_scan)(
        jp, jnp.asarray(rec), None if h0 is None else jnp.asarray(h0))
    ty, th = rglru.rg_lru_scan(tp, lm._from_numpy(rec),
                               None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == lm.torch_dtype(dtype) and th.dtype == torch.float32
    _close(th, jh, dtype, 1e-5, 1e-6)
    _close(ty, jy, dtype, 1e-5, 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rg_lru_step_and_decode_match_reference(dtype):
    """``rg_lru_step`` and the whole block's ``apply_decode``: output,
    state and conv window."""
    jcfg, p = _rec_params(dtype)
    tcfg = _cfgs("reduced", dtype)[1]
    jp, tp = _both(p)
    rng = np.random.default_rng(3)
    rec_t = rng.normal(size=(3, 64)).astype(_np(dtype))
    h = rng.normal(size=(3, 64)).astype(np.float32)
    jy, jh = jrglru.rg_lru_step(jp, jnp.asarray(rec_t), jnp.asarray(h))
    ty, th = rglru.rg_lru_step(tp, lm._from_numpy(rec_t), torch.from_numpy(h))
    _close(th, jh, dtype, 1e-5, 1e-6)
    _close(ty, jy, dtype, 1e-5, 1e-6)
    x = (rng.normal(size=(3, 1, 64))).astype(_np(dtype))
    buf = rng.normal(size=(3, 3, 64)).astype(_np(dtype))
    want = jax.jit(lambda *a: jrglru.apply_decode(jcfg, *a))(
        jp, jnp.asarray(x), jnp.asarray(h), jnp.asarray(buf))
    got = rglru.apply_decode(tcfg, tp, lm._from_numpy(x), torch.from_numpy(h),
                             lm._from_numpy(buf))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, dtype, 1e-5, 1e-6)
    assert torch.equal(got[2][:, :2], lm._from_numpy(buf[:, 1:]))


@pytest.mark.parametrize("S", [1, 2, 3, 11])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_train_matches_reference(dtype, S):
    """The whole block over a sequence and its handoff.  The conv tail is
    always K - 1 = 3 rows: at S >= 3 the reference's; below, the
    reference's S rows left-padded with zeros."""
    jcfg, p = _rec_params(dtype)
    tcfg = _cfgs("reduced", dtype)[1]
    jp, tp = _both(p)
    x = np.random.default_rng(4).normal(size=(2, S, 64)).astype(_np(dtype))
    jy, (jh, jtail) = jax.jit(lambda *a: jrglru.apply_train(jcfg, *a))(
        jp, jnp.asarray(x))
    ty, (th, ttail) = rglru.apply_train(tcfg, tp, lm._from_numpy(x))
    _close(ty, jy, dtype, 1e-5, 1e-6)
    _close(th, jh, dtype, 1e-5, 1e-6)
    assert ttail.shape == (2, 3, 64) and jtail.shape == (2, min(S, 3), 64)
    _close(ttail[:, 3 - min(S, 3):], jtail, dtype, 1e-5, 1e-6)
    assert not ttail[:, :3 - min(S, 3)].any()


def test_rglru_scan_equals_steps():
    """``tests/test_models_xlstm.py::test_rglru_scan_equals_steps`` in the
    port: the scan over 8 steps equals 8 single steps from a zero state."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = {k: (torch.zeros(shape) if kind == "zeros" else torch.ones(shape)
             if kind == "ones" else torch.randn(shape, generator=gen)
             * shape[-2 if len(shape) >= 2 else -1] ** -0.5)
         for k, (shape, kind, _dt) in rglru.spec(cfg).items()}
    B, S, W = 2, 8, cfg.lru_width
    rec = torch.randn((B, S, W), generator=gen)
    y_scan, h_last = rglru.rg_lru_scan(p, rec)
    h = torch.zeros((B, W))
    outs = []
    for t in range(S):
        y_t, h = rglru.rg_lru_step(p, rec[:, t], h)
        outs.append(y_t)
    np.testing.assert_allclose(y_scan.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), h.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_local_attention_matches_reference(dtype):
    """S = 2.5 W: padded to 3 chunks, each query chunk over its own and
    the previous chunk (the band), chunk 0 alone; 4 query heads a KV
    head.  Also the window past S (one chunk, plain causal)."""
    rng = np.random.default_rng(5)
    W, S = 16, 40
    q, k, v = (rng.normal(size=(2, S, h, 16)).astype(_np(dtype))
               for h in (8, 2, 2))
    got = {}
    for window in (W, 64):
        want = jax.jit(jlayers.local_attention, static_argnums=3)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window)
        got[window] = layers.local_attention(
            lm._from_numpy(q), lm._from_numpy(k), lm._from_numpy(v), window)
        assert got[window].dtype == lm.torch_dtype(dtype)
        _close(got[window], want, dtype, 1e-5, 1e-6)
    if dtype == "float32":
        # query 39 sees keys 24..39 and nothing else
        qt, kt, vt = map(torch.from_numpy, (q[:1, -1:], k[:1], v[:1]))
        ref = layers.decode_attention(qt, kt[:, 24:], vt[:, 24:], 16)
        np.testing.assert_allclose(got[W][:1, -1:].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model: forward, loss, gradients, one train step
# ---------------------------------------------------------------------------
def _batch(cfg):
    nb = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH)).batch_at(0)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


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
    assert [r.name for r in lm.layer_runs(tcfg)] == [
        "run00_rglru", "run02_local", "run03_rglru"]
    full = [r.name for r in lm.layer_runs(get_config(ARCH))]
    assert full[:3] == ["run00_rglru", "run02_local", "run03_rglru"]
    assert full[-1] == "run24_rglru" and len(full) == 17


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_forward_loss_and_grads_match_reference(form, dtype):
    jcfg, jp, tcfg, tp = _model(form, dtype)
    jb, tb = _batch(tcfg)

    def reference(c, p):
        return (jlm.forward(c, p, jb)[0], jax.value_and_grad(
            lambda q: jlm.loss_fn(c, q, jb, remat=True)[0])(p))
    jlogits, (jloss, jg) = jax.jit(functools.partial(reference, jcfg))(jp)
    jg32 = None
    if dtype == "bfloat16":
        c32, p32 = _twin(form)
        jg32 = jax.jit(functools.partial(reference, c32))(p32)[1][1]
    tlogits, _aux, _m = lm.forward(tcfg, tp, tb)
    _close(tlogits, jlogits, dtype, 1e-5, 1e-5)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    tloss, _ = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                          remat=True)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    _trees_close(jg, grads, dtype, 1e-4, 1e-6, jg32)
    # every recurrent leaf of every layer has a gradient
    count = {r.name: r.count for r in lm.layer_runs(tcfg)}
    for path, g in tree_mod.flatten_with_paths(grads):
        if "rec" in path:
            per_layer = g.reshape(count[path[0]], -1) if count[path[0]] > 1 \
                else g.reshape(1, -1)
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
    # bf16: the norms of two gradients differ by at most the gradients'
    # L2 distance, which the bf16 rule bounds
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=rtol if dtype == "float32"
                               else BF16_REL_L2)
    if dtype == "bfloat16":
        p32, s32, _ = _reference_step(form, dtype, twin=True)
        m32, v32 = s32.m, s32.v
    _trees_close(jp2, new_p, dtype, 2e-5, 2e-6, p32)
    _trees_close(js2.m, new_s.m, dtype, 2e-5, 2e-6, m32)
    _trees_close(js2.v, new_s.v, dtype, 2e-5, 2e-6, v32)
    start = dict((p, a) for p, a in tree_mod.flatten_with_paths(
        lm.params_from_numpy(tcfg, _shared(form, dtype)[3], device="cpu")))
    for path, b in tree_mod.flatten_with_paths(new_p):
        if path[-1] in ("lam", "gate_a", "conv_w", "conv_b"):
            assert not torch.equal(b, start[path]), path
    if route == "program":
        assert new_p is tp              # the program updates in place
        assert {p[-1] for _n, p, *_ in prog.layout} >= {
            "lam", "gate_a", "gate_x", "conv_w", "conv_b"}


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
            _close(t, jc[run][k], dtype, 1e-4, 2e-5,
                   None if jc32 is None else jc32[run][k])


@pytest.mark.parametrize("dtype,S", [("float32", 8), ("float32", 32),
                                     ("bfloat16", 8)])
@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_step_match_reference(form, dtype, S):
    """Prefill of S tokens (S < W: the ring's identity; S == W: its
    aligned wrap) and four decode steps, logits and every cache leaf
    against the reference's; and prefill + one decode == forward(S + 1)."""
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    toks = np.random.default_rng(8).integers(
        1, tcfg.vocab_size, (2, S + 1)).astype(np.int32)
    prefill, decode, _fwd = _reference_decode(form, dtype)
    jc, jl = prefill({"tokens": jnp.asarray(toks[:, :S])})
    jc32 = jl32 = None
    if dtype == "bfloat16":
        prefill32, decode32, _fwd32 = _reference_decode(form, dtype, True)
        jc32, jl32 = prefill32({"tokens": jnp.asarray(toks[:, :S])})
    tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=40)
    full = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})[0]
    for i in range(4):
        _close(tlog, jl, dtype, 1e-4, 2e-5, jl32)
        _cache_close(tc, jc, dtype, jc32)
        cur = toks[:, S] if i == 0 else np.asarray(
            jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = decode(jc, jnp.asarray(cur))
        if jc32 is not None:
            jl32, jc32 = decode32(jc32, jnp.asarray(cur))
        tlog, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(cur))
        if i == 0:
            _close(tlog, full[:, -1], dtype, 1e-4, 2e-5)


def _prefill_then_decode_vs_reference_forward(form, S, k=3):
    """The port's prefill of S tokens and k decode steps against the
    reference's ``lm.forward`` of S + k tokens at positions S - 1 ..
    S + k - 1, fp32."""
    jcfg, jp, tcfg, tp = _model(form, "float32")
    toks = np.random.default_rng(9).integers(
        1, tcfg.vocab_size, (2, S + k)).astype(np.int32)
    want = np.asarray(_reference_decode(form, "float32")[2](
        {"tokens": jnp.asarray(toks)}))
    cache, logits = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=128)
    got = [logits]
    for i in range(k - 1):
        logits, cache = lm.decode_step(tcfg, tp, cache,
                                       torch.from_numpy(toks[:, S + i]))
        got.append(logits)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), want[:, S - 1 + i], rtol=1e-4,
                                   atol=2e-5, err_msg=f"position {S - 1 + i}")


@pytest.mark.parametrize("S", [40, 70])
def test_ring_handoff_past_a_misaligned_prompt_matches_forward(S):
    """W 32, S % W != 0: the handoff puts position p at slot p % W, so
    decode overwrites the oldest key and attends exactly the last W.  (The
    reference's handoff, the last W rows at slots 0..W-1, is 2.6e-3 /
    6.0e-3 off at S 40 / 70 in rel L2.)"""
    _prefill_then_decode_vs_reference_forward("reduced", S, k=4)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_decodes_and_matches_forward(S):
    """A prompt shorter than the conv's K - 1 = 3 rows: the conv tail is
    left-padded with zeros, so decode runs and matches the forward (the
    reference's decode raises there)."""
    _prefill_then_decode_vs_reference_forward("five", S, k=4)


def test_ring_rows_put_each_position_at_its_slot():
    t = torch.arange(11.0).reshape(1, 11, 1, 1)
    assert lm.ring_rows(t, 4).flatten().tolist() == [8, 9, 10, 7]
    assert lm.ring_rows(t, 11).flatten().tolist() == list(range(11))
    assert lm.ring_rows(t[:, :3], 4).flatten().tolist() == [0, 1, 2, 0]


def _requests(mod, vocab, lens=(8, 32, 12, 32), budgets=(3, 5, 2, 4),
              seed=11):
    # lengths below the ring's 32 rows, or a whole ring: the reference's
    # handoff is right there; the 32-token prompts wrap the ring on their
    # first decode step
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


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_planned_engine_notice_plan_and_launch_table(form, n, capsys):
    """A planned engine prints the reference's notice, stays hand-wired at
    cache_len == max_len, and plans the reference's fallback graph (head
    dim 16, one KV head): the same plan and launch table."""
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
    assert [(g.op.name, g.deps) for g in graph] == \
        [(g.op.name, g.deps) for g in je.decode_graph(prefill_chunks=n)]
    assert "qkv_proj" not in {g.op.name for g in graph}
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())


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
    assert "needs a single global-attention layer run" in str(got.value)


def test_unsupported_config_falls_back_to_handwired():
    """``tests/test_executor.py::test_unsupported_config_falls_back_to_
    handwired`` in the port."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    assert engine.executable_decode_supported(cfg) is not None
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        eng = engine.ServeEngine(cfg, params, batch=2, max_len=32,
                                 plan_fusion=True, device="cpu")
    assert not eng.executed
    reqs = [engine.Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                           max_new_tokens=2)]
    eng.run(reqs)
    assert len(reqs[0].out_tokens) == 2


def test_serve_cli_smoke(capsys):
    """``tests/test_system.py::test_serve_cli_smoke`` in the port, on the
    CPU."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--requests", "3", "--prompt-len", "8",
                "--max-new", "4", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "is hand-wired" in out


def test_train_cli_smoke(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--plan-fusion"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "executed update program" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the config: parameter count, exact dims, the shape table, the update plan
# ---------------------------------------------------------------------------
def test_count_params_dims_and_long_context():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (26, 2560, 10, 1, 256, 7680, 256_000)
    assert (cfg.local_window, cfg.lru_width, cfg.conv1d_width,
            cfg.logit_softcap, cfg.tie_embeddings) == (2048, 2560, 4, 30.0,
                                                       True)
    assert cfg.pattern == (RGLRU, RGLRU, LOCAL_ATTN) * 8 + (RGLRU, RGLRU)
    n = lm.count_params(cfg)
    assert n == jlm.count_params(jcfg) and abs(n / 2.68e9 - 1) < 0.08
    assert cfg.supports_long_context and jcfg.supports_long_context
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name]) == (True, "")
    assert lm.supported(cfg) is None
    assert engine.executable_decode_supported(cfg) == \
        jengine.executable_decode_supported(jcfg)


def _abstract_full():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    return (jax.eval_shape(lambda: jlm.init(jc, jax.random.PRNGKey(0))),
            lm.abstract_params(tc))


def _plan_rows(plan):
    return [(r["members"], r["schedule"], r["vmem_cap"],
             r["predicted_speedup_pct"], r["measured_speedup_pct"])
            for r in plan.summary()]


def test_full_width_update_plan_matches_reference():
    """At full width the 4-D stacked gate leaves get no dW op, and the
    largest eight leaves (equal-sized run leaves tie: the stable sort on
    the sorted-key flatten order breaks it) and the plan are the
    reference's."""
    ja, ta = _abstract_full()
    jgraph, jlayout = jtl.update_graph(ja, tokens=8192)
    tgraph, tlayout = tl.update_graph(ta, tokens=8192)
    assert [(g.op.name, g.deps) for g in tgraph] == \
        [(g.op.name, g.deps) for g in jgraph]
    assert [n for n, *_ in tlayout] == [n for n, *_ in jlayout]
    assert _plan_rows(tl.plan_update_fusion(ta, tokens=8192)) == \
        _plan_rows(jtl.plan_update_fusion(ja, tokens=8192))
    gates = [p for _n, p, *_ in tlayout if p[-1] == "gate_a"]
    assert not gates            # the largest eight: no gate among them
    names = [g.op.name for g in tl.update_graph(ta, max_tensors=None)[0]]
    # one a run: 8 stacked pairs and the last
    assert sum(n.startswith("adamw_") and n.endswith("gate_a")
               for n in names) == 9


@pytest.mark.parametrize("form", FORMS)
def test_update_program_matches_reference(form):
    """The executed update program over every leaf (the stacked 4-D gate
    leaves included) is the reference's, launch for launch.  (At full
    width the reference's plan takes 12 s and the port's 20 s on the CPU;
    chip_smoke builds that one.)"""
    jcfg, tcfg = _cfgs(form)
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(tcfg)
    jprog, tprog = jtl.build_update_program(ja), tl.build_update_program(ta)
    assert tprog.describe() == jprog.describe()
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
    assert {p[-1] for _n, p, *_ in tprog.layout} >= {
        "lam", "gate_a", "gate_x", "conv_w", "conv_b"}
