"""deepseek-v2-236b (multi-head latent attention, a dense first layer, an
MoE FFN with shared experts) in the port against the JAX package, on the
CPU.

Three forms: ``reduced()`` (one MLA layer, dense: the override of layer 0,
FFN width ``dense_d_ff_first``); a three-layer form ``(MLA,) * 3``, a dense
run and then a stacked MoE run of 2 (top-2 of 4 experts and one shared
expert), which ``reduced()`` never builds; and that form with top-6 of 8
experts.  Both packages get the same weights: numpy trees made from a seed
(RMSNorm scales N(0, 0.3), the fp32 router and every weight
N(0, 1/fan_in), the embedding N(0, 0.02)), handed to JAX as arrays and to
the port through ``lm.params_from_numpy``.  Each form runs in fp32 and in
bf16.

Tolerances, those of ``tests/test_torch_recurrent.py``.  fp32: MLA's two
paths, logits and the loss to 1e-5 relative (plus 1e-5 absolute);
gradients to 1e-4 relative plus 5e-6 absolute (the embedding's gradient,
whose elements reach 0.7, sums every token's path through three layers:
fp32 sums in another order leave up to 1.4e-6); one train step's params, m
and v to rtol 2e-5, atol 2e-6; ``lm.prefill`` / ``lm.decode_step``
(logits and every cache leaf) to 1e-4 relative plus 2e-5 absolute; the
absorbed decode against the expanded path at the same position to 1e-5
relative L2.  bf16: outputs, logits, each leaf's gradient, the train
step's params, m and v, the cache leaves to 2e-2 relative L2 of the
reference's, or 1.5 times the reference's own distance from its fp32 twin
(the bf16 weights cast up) where that is larger: two bf16 roundings of one
computation lie about sqrt(2) times one's noise apart; the loss to 1e-3
relative, the grad norm to 2e-2.  The absorbed decode rounds ``q_lat`` to
bf16 as the reference does, so in bf16 it lies further from the expanded
path than in fp32 (the reference's own distance; it is not held here).
Served tokens and ``ServeStats`` are equal; plans and launch tables are
equal.
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
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import tree as tree_mod
from repro_torch.configs import MLA, SHAPES, get_config, shape_applicable
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import lm, mla, moe
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop as tl

ARCH = "deepseek-v2-236b"
FORMS = ["reduced", "three", "top6"]
DTYPES = ["float32", "bfloat16"]
BF16_REL_L2 = 2e-2
BF16_ACCURACY = 1.5
SEQ, BATCH, MAX_LEN = 16, 2, 48


def _cfgs(form="reduced", dtype="float32"):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
        if form in ("three", "top6"):
            c = dataclasses.replace(c, num_layers=3, block_pattern=(MLA,) * 3)
        if form == "top6":
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, num_experts=8, top_k=6))
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


# ---------------------------------------------------------------------------
# models/mla.py
# ---------------------------------------------------------------------------
def _attn_params(dtype, seed=1):
    """One MLA block's params (the reduced width) in both packages."""
    jcfg, tcfg = _cfgs("reduced", dtype)
    tree = _numpy_tree(jcfg, seed)["run00_mla"]["attn"]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tree_mod.map_tree(lm._from_numpy, tree)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_full_matches_reference(dtype):
    """The expanded path (Dqk 24, Dv 16 at the reduced width) and the pair
    it hands the cache: the latent and the one shared rope head."""
    jcfg, tcfg, jp, tp = _attn_params(dtype)
    x = np.random.default_rng(2).normal(size=(2, 11, 64)).astype(_np(dtype))
    pos = np.arange(11)[None, :]
    jo, (jlat, jrope) = jax.jit(lambda *a: jmla.attend_full(jcfg, *a))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    to, (tlat, trope) = mla.attend_full(tcfg, tp, lm._from_numpy(x),
                                        torch.from_numpy(pos))
    assert to.dtype == tlat.dtype == trope.dtype == lm.torch_dtype(dtype)
    assert tlat.shape == (2, 11, 32) and trope.shape == (2, 11, 8)
    for g, w in ((to, jo), (tlat, jlat), (trope, jrope)):
        _close(g, w, dtype, 1e-5, 1e-5)


@pytest.mark.parametrize("pos", [0, 6, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_absorbed_matches_reference(dtype, pos):
    """The absorbed decode on random caches: the output, and the caches
    written at ``pos`` alone (in place), before attending; ``pos`` 12 is
    the last row."""
    jcfg, tcfg, jp, tp = _attn_params(dtype)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, 64)).astype(_np(dtype))
    lat = rng.normal(size=(2, 13, 32)).astype(_np(dtype))
    rope = rng.normal(size=(2, 13, 8)).astype(_np(dtype))
    positions = np.full((2, 1), pos, np.int32)
    jo, jlat, jrope = jax.jit(
        lambda *a: jmla.attend_absorbed(jcfg, *a))(
        jp, jnp.asarray(x), jnp.asarray(lat), jnp.asarray(rope),
        jnp.asarray(pos, jnp.int32), jnp.asarray(positions))
    tlat, trope = lm._from_numpy(lat), lm._from_numpy(rope)
    to, lc, rc = mla.attend_absorbed(tcfg, tp, lm._from_numpy(x), tlat,
                                     trope, torch.tensor(pos),
                                     torch.from_numpy(positions))
    assert lc is tlat and rc is trope
    _close(to, jo, dtype, 1e-5, 1e-5)
    _close(tlat, jlat, dtype, 1e-5, 1e-5)
    _close(trope, jrope, dtype, 1e-5, 1e-5)
    keep = np.arange(13) != pos
    assert np.array_equal(_f32(tlat)[:, keep], _f32(lat)[:, keep])
    assert np.array_equal(_f32(trope)[:, keep], _f32(rope)[:, keep])


def test_absorbed_decode_equals_expanded_path():
    """fp32: the expanded path over S tokens, and the absorbed path for
    the last token against the first S - 1 tokens' latent and rope rows:
    the same attention output at position S - 1."""
    _jcfg, tcfg, _jp, tp = _attn_params("float32")
    S = 9
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, S, 64)).astype(np.float32))
    full, (lat, rope) = mla.attend_full(tcfg, tp, x,
                                        torch.arange(S)[None, :])
    lc = torch.zeros((2, 16, 32))
    rc = torch.zeros((2, 16, 8))
    lc[:, :S - 1], rc[:, :S - 1] = lat[:, :S - 1], rope[:, :S - 1]
    out, lc, rc = mla.attend_absorbed(
        tcfg, tp, x[:, -1:], lc, rc, S - 1, torch.full((2, 1), S - 1))
    assert _rel_l2(out[:, 0], full[:, -1]) <= 1e-5
    assert _rel_l2(lc[:, S - 1], lat[:, -1]) <= 1e-6
    assert torch.equal(rc[:, S - 1], rope[:, -1])


@pytest.mark.parametrize("T", [7, 300])
def test_route_at_160_experts_top_6_matches_reference(T):
    """``route_from_logits`` at the full width's E 160 and top-6: dispatch
    and combine tables equal the reference's (capacity 8 at T = 7, 16
    at T = 300, with overflow at T = 300: logits skewed towards low
    experts)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    rng = np.random.default_rng(T)
    logits = (rng.normal(size=(T, 160)) - np.linspace(0, 3, 160)) \
        .astype(np.float32)
    jr = jax.jit(lambda lg: jmoe.route_from_logits(jcfg, lg))(
        jnp.asarray(logits))
    tr = moe.route_from_logits(cfg, torch.from_numpy(logits))
    assert tr.dispatch_idx.shape == (160, moe.capacity(cfg, T))
    np.testing.assert_array_equal(tr.dispatch_idx.numpy(),
                                  np.asarray(jr.dispatch_idx))
    np.testing.assert_allclose(tr.combine_w.numpy(),
                               np.asarray(jr.combine_w), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(tr.aux_loss), float(jr.aux_loss),
                               rtol=1e-5)
    if T == 300:
        assert bool((tr.slot == moe.capacity(cfg, T)).any())


# ---------------------------------------------------------------------------
# the model: layout, forward, loss, gradients, one train step
# ---------------------------------------------------------------------------
def _batch(cfg):
    nb = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH)).batch_at(0)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


@pytest.mark.parametrize("form", FORMS)
def test_param_tree_and_cache_match_reference(form):
    """Leaves, shapes and dtypes of the params (the dense first layer at
    ``dense_d_ff_first``, the MoE run's stacked 4-D expert leaves) and of
    the cache (the latent and rope leaves)."""
    jcfg, tcfg = _cfgs(form, "bfloat16")
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = [(tuple(k.key for k in p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_mod.flatten_with_paths(lm.abstract_params(tcfg))]
    assert got == want
    jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, 3, 40))
    want = [(tuple(k.key for k in p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(jc)[0]]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_mod.flatten_with_paths(
               lm.init_cache(tcfg, 3, 40, device="cpu"))]
    assert got == want
    names = [r.name for r in lm.layer_runs(tcfg)]
    assert names == (["run00_mla"] if form == "reduced"
                     else ["run00_mla", "run01_mla_moe"])
    assert lm.abstract_params(tcfg)["run00_mla"]["mlp"]["w_out"].shape == \
        (tcfg.dense_d_ff_first, tcfg.d_model)


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
        jl32, (_l, jg32) = jax.jit(functools.partial(reference, c32))(p32)
    tlogits, _aux, _m = lm.forward(tcfg, tp, tb)
    _close(tlogits, jlogits, dtype, 1e-5, 1e-5, jl32)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    tloss, _ = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                          remat=True)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    _trees_close(jg, grads, dtype, 1e-4, 5e-6, jg32)
    # every MLA leaf of every layer has a gradient
    count = {r.name: r.count for r in lm.layer_runs(tcfg)}
    for path, g in tree_mod.flatten_with_paths(grads):
        if "attn" in path or "shared_w_in" in path:
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


WATCHED = ("w_q_a", "w_kv_a", "w_k_b", "w_v_b", "shared_w_in",
           "shared_w_out")


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
                               rtol=rtol if dtype == "float32"
                               else BF16_REL_L2)
    if dtype == "bfloat16":
        p32, s32, _ = _reference_step(form, dtype, twin=True)
        m32, v32 = s32.m, s32.v
    _trees_close(jp2, new_p, dtype, 2e-5, 2e-6, p32)
    _trees_close(js2.m, new_s.m, dtype, 2e-5, 2e-6, m32)
    _trees_close(js2.v, new_s.v, dtype, 2e-5, 2e-6, v32)
    start = dict(tree_mod.flatten_with_paths(
        lm.params_from_numpy(tcfg, _shared(form, dtype)[3], device="cpu")))
    for path, b in tree_mod.flatten_with_paths(new_p):
        if path[-1] in WATCHED or path[-2:-1] in (("q_norm",), ("kv_norm",)):
            assert not torch.equal(b, start[path]), path
    if route == "program":
        assert new_p is tp              # the program updates in place
        assert {p[-2] for _n, p, *_ in prog.layout} >= {"q_norm", "kv_norm"}


# ---------------------------------------------------------------------------
# the hand-wired serve path
# ---------------------------------------------------------------------------
@functools.cache
def _reference_decode(form, dtype, twin=False):
    """The reference's jitted prefill (max_len MAX_LEN), decode step and
    forward over the shared weights (``twin``: the bf16 weights in
    fp32)."""
    jcfg, jp, _tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
    return (jax.jit(lambda b: jlm.prefill(jcfg, jp, b, max_len=MAX_LEN)),
            jax.jit(lambda c, t: jlm.decode_step(jcfg, jp, c, t)),
            jax.jit(lambda b: jlm.forward(jcfg, jp, b)[0]))


def _cache_close(tc, jc, dtype, jc32=None):
    for run, leaves in tc.items():
        if run == "pos":
            assert int(leaves) == int(jc["pos"])
            continue
        assert set(leaves) == set(jc[run]) == {"latent", "rope"}
        for k, t in leaves.items():
            assert t.shape == jc[run][k].shape and \
                t.dtype == lm.torch_dtype(str(jc[run][k].dtype)), (run, k)
            _close(t, jc[run][k], dtype, 1e-4, 2e-5,
                   None if jc32 is None else jc32[run][k])


@pytest.mark.parametrize("form,dtype,S", [
    *(("three", "float32", S) for S in (1, 5, 16, 40)),
    *((form, "float32", S) for form in ("reduced", "top6") for S in (1, 40)),
    *((form, "bfloat16", 16) for form in FORMS)])
def test_prefill_and_decode_step_match_reference(form, dtype, S):
    """Prefill of S tokens and four decode steps, the logits and every
    cache leaf against the reference's after each; and (fp32) the four
    decode steps against the port's forward of S + 4 tokens, both at a
    capacity no token overflows (``_no_drop``).  S 1, 5, 16 and 40 on the
    three-layer form, the ends on the other two, bf16 at 16."""
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    toks = np.random.default_rng(8).integers(
        1, tcfg.vocab_size, (2, S + 4)).astype(np.int32)
    prefill, decode, _fwd = _reference_decode(form, dtype)
    jc, jl = prefill({"tokens": jnp.asarray(toks[:, :S])})
    jc32 = jl32 = None
    if dtype == "bfloat16":
        prefill32, decode32, _fwd32 = _reference_decode(form, dtype, True)
        jc32, jl32 = prefill32({"tokens": jnp.asarray(toks[:, :S])})
    tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S])}, max_len=MAX_LEN)
    for i in range(4):
        _close(tlog, jl, dtype, 1e-4, 2e-5, jl32)
        _cache_close(tc, jc, dtype, jc32)
        cur = toks[:, S + i]
        jl, jc = decode(jc, jnp.asarray(cur))
        if jc32 is not None:
            jl32, jc32 = decode32(jc32, jnp.asarray(cur))
        tlog, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(cur))
    _close(tlog, jl, dtype, 1e-4, 2e-5, jl32)
    _cache_close(tc, jc, dtype, jc32)
    if dtype == "float32":
        nd = _no_drop(tcfg)
        full = lm.forward(nd, tp, {"tokens": torch.from_numpy(toks)})[0]
        tc, tlog = lm.prefill(nd, tp, {"tokens": torch.from_numpy(
            toks[:, :S])}, max_len=MAX_LEN)
        for i in range(5):
            np.testing.assert_allclose(tlog.numpy(),
                                       full[:, S - 1 + i].numpy(),
                                       rtol=1e-4, atol=2e-5,
                                       err_msg=f"position {S - 1 + i}")
            if i < 4:
                tlog, tc = lm.decode_step(nd, tp, tc,
                                          torch.from_numpy(toks[:, S + i]))


def _no_drop(cfg):
    """``cfg`` at capacity factor E / top_k: every expert's capacity is
    the batch's token count, so no (token, choice) pair is dropped.  The
    sort dispatch keeps each expert's first C pairs in token order, so a
    forward of S + 4 tokens drops other pairs than a prefill of S (a
    batch's last positions first), which confounds prefill + decode ==
    forward; the weights are the same."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def test_capacity_drops_confound_the_forward():
    """The confound ``_no_drop`` removes: at capacity factor 1.25 the
    top-6 form's forward of 2 x 9 tokens drops pairs (capacity 16 a
    batch of 18 tokens, 13.5 pairs an expert on average) and moves the
    last position's logits, at E / top_k none drop."""
    _jcfg, _jp, tcfg, tp = _model("top6")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, tcfg.vocab_size, (2, 9)).astype(np.int32))
    lost = []
    orig = moe.route_from_logits

    def counting(cfg, logits):
        r = orig(cfg, logits)
        lost.append(int((r.slot == r.dispatch_idx.shape[1]).sum()))
        return r
    moe.route_from_logits = counting
    try:
        drop = lm.forward(tcfg, tp, {"tokens": toks})[0]
        n_drop, lost[:] = sum(lost), []
        full = lm.forward(_no_drop(tcfg), tp, {"tokens": toks})[0]
    finally:
        moe.route_from_logits = orig
    assert n_drop > 0 and sum(lost) == 0
    assert _rel_l2(drop, full) > 1e-3


def test_decode_past_the_cache_end_writes_the_last_row():
    """The reference's clamped update: a decode step at pos == max_len
    writes the last latent and rope rows, as global attention's does."""
    _jcfg, _jp, tcfg, tp = _model("three")
    toks = np.random.default_rng(12).integers(
        1, tcfg.vocab_size, (2, 9)).astype(np.int32)
    prefill, decode, _fwd = _reference_decode("three", "float32")
    jc, _ = prefill({"tokens": jnp.asarray(toks[:, :8])})
    tc, _ = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :8])},
                       max_len=MAX_LEN)
    jc["pos"] = jnp.asarray(MAX_LEN, jnp.int32)
    tc["pos"] = torch.tensor(MAX_LEN, dtype=torch.int32)
    before = tc["run01_mla_moe"]["latent"].clone()
    jl, jc = decode(jc, jnp.asarray(toks[:, 8]))
    tlog, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, 8]))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=2e-5)
    _cache_close(tc, jc, "float32")
    after = tc["run01_mla_moe"]["latent"]
    assert torch.equal(after[:, :, :-1], before[:, :, :-1])
    assert not torch.equal(after[:, :, -1], before[:, :, -1])


def _requests(mod, vocab, lens=(8, 30, 8, 5), budgets=(3, 5, 2, 4),
              seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m)
            for i, (L, m) in enumerate(zip(lens, budgets))]


def _stats(eng):
    st = eng.stats
    return st.describe(), st.admissions, st.retirements


@pytest.mark.parametrize("form,scheduling", [
    *((form, "continuous") for form in FORMS), ("three", "wavefront")])
def test_hand_wired_engines_match_reference(form, scheduling):
    """The continuous fallback (every form) and the hand-wired wavefront
    (the three-layer form), token for token with the reference's engines
    and with equal stats; a planned engine on the CPU stays hand-wired and
    serves the same tokens."""
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


def _planned_pair(jcfg, tcfg, capsys, batch, max_len, scheduling, budget):
    je = jengine.ServeEngine(
        jcfg, None, batch=batch, max_len=max_len, plan_fusion=True,
        scheduling=scheduling, prefill_budget=jengine.PrefillBudget(**budget))
    want = capsys.readouterr().out
    te = engine.ServeEngine(
        tcfg, None, batch=batch, max_len=max_len, device="cpu",
        scheduling=scheduling, prefill_budget=engine.PrefillBudget(**budget))
    got = capsys.readouterr().out
    assert got == want == NOTICE
    assert not (te.executed or je.executed)
    assert te.cache_len == je.cache_len == max_len
    assert te.fusion_plan.summary() == je.fusion_plan.summary()
    return je, te


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_planned_engine_notice_plan_and_launch_table(form, n, capsys):
    """A planned engine prints the reference's notice, stays hand-wired at
    cache_len == max_len, and plans the reference's fallback graph (head
    dim 16 from the config's ``head_dim``): the same plan and launch
    table."""
    jcfg, tcfg = _cfgs(form)
    budget = dict(chunk_rows=8, max_coresident_chunks=2)
    for scheduling in ("continuous", "wavefront"):
        je, te = _planned_pair(jcfg, tcfg, capsys, 3, MAX_LEN, scheduling,
                               budget)
    graph = te.decode_graph(prefill_chunks=n)
    assert [(g.op.name, g.deps) for g in graph] == \
        [(g.op.name, g.deps) for g in je.decode_graph(prefill_chunks=n)]
    assert "qkv_proj" not in {g.op.name for g in graph}
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())


def test_planned_engine_at_full_width_plans_the_reference_graph(capsys):
    """At full width the fallback graph's decode attention is H 128, Hkv
    128, D 192 (planned without packing, so D past the member's 128
    plans) beside the moe_router projection: the reference's plan and
    launch table."""
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    budget = dict(chunk_rows=512, max_coresident_chunks=2)
    je, te = _planned_pair(jcfg, tcfg, capsys, 4, 1024, "continuous",
                           budget)
    graph = te.decode_graph(prefill_chunks=2)
    names = [g.op.name for g in graph]
    assert names == [g.op.name for g in je.decode_graph(prefill_chunks=2)]
    assert "decode_attn_B4_S1024_H128kv128" in names and \
        "moe_router" in names
    assert (te.build_decode_program(prefill_chunks=2).describe()
            == je.build_decode_program(prefill_chunks=2).describe())


def test_planned_engine_refuses_on_the_card(monkeypatch):
    _, tcfg = _cfgs("three")
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    for scheduling in ("continuous", "wavefront"):
        with pytest.raises(ValueError, match=r"needs a single global-"
                           r"attention layer run — pass plan_fusion=False "
                           r"\(serve CLI: --hand-wired\)"):
            engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                               device="cuda", scheduling=scheduling)


def test_paged_kv_refuses_with_the_reference_text():
    jcfg, tcfg = _cfgs("three")
    with pytest.raises(ValueError) as want:
        jengine.ServeEngine(jcfg, None, batch=2, max_len=MAX_LEN,
                            plan_fusion=True, paged_kv=True)
    with pytest.raises(ValueError) as got:
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cpu", paged_kv=True)
    assert str(got.value) == str(want.value)
    assert "needs a single global-attention layer run" in str(got.value)


def test_serve_cli_smoke(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--scale", "smoke", "--requests", "3",
                "--prompt-len", "8", "--max-new", "4", "--batch", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "is hand-wired" in out


def test_serve_cli_cut_keeps_the_pattern():
    """``--layers 8`` (``serve.cut_depth``) keeps MLA blocks and the dense
    first layer: a dense run, then a stacked run of 7 MoE layers, 29.19 B
    parameters; ``block_pattern=None`` would make every layer global
    attention."""
    from repro_torch.launch import serve
    cfg = serve.cut_depth(get_config(ARCH), 8)
    assert cfg.pattern == (MLA,) * 8
    assert [(r.name, r.count) for r in lm.layer_runs(cfg)] == [
        ("run00_mla", 1), ("run01_mla_moe", 7)]
    assert lm.count_params(cfg) == 29_191_377_920
    assert lm.abstract_params(cfg)["run01_mla_moe"]["moe"]["w_in"].shape \
        == (7, 160, 5120, 3072)
    assert lm.count_params(serve.cut_depth(get_config(ARCH), 2)) == \
        5_358_679_040


def test_train_cli_smoke(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--scale", "smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16", "--plan-fusion"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "executed update program" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the config: parameter count, exact dims, the shape table, init, plans
# ---------------------------------------------------------------------------
def test_count_params_dims_and_long_context():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (60, 5120, 128, 128, 1536, 102_400)
    # tests/test_models_smoke.py::test_moe_assignments' fields
    assert cfg.moe.num_experts == 160 and cfg.moe.top_k == 6
    assert cfg.moe.num_shared_experts == 2 and cfg.moe.d_ff_shared == 3072
    assert cfg.mla.kv_lora_rank == 512 and cfg.mla.q_lora_rank == 1536
    assert cfg.moe_layer_overrides == {0: "dense"}
    assert cfg.dense_d_ff_first == 12288 and not cfg.tie_embeddings
    n = lm.count_params(cfg)
    assert n == jlm.count_params(jcfg) == 235_741_434_880
    assert abs(n / 236e9 - 1) < 0.08
    active = lm.count_params(cfg, active_only=True)
    assert active == jlm.count_params(jcfg, active_only=True)
    assert cfg.active_param_count() == active < n / 10
    assert not cfg.supports_long_context
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name])
    ok, why = shape_applicable(cfg, SHAPES["long_500k"])
    assert not ok and why.startswith("full-attention arch")
    assert lm.supported(cfg) is None
    assert engine.executable_decode_supported(cfg) == \
        jengine.executable_decode_supported(jcfg) == \
        "needs a single global-attention layer run"


def test_reduced_matches_reference_field_for_field():
    for form in FORMS:
        jcfg, tcfg = _cfgs(form)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert lm.count_params(tcfg) == jlm.count_params(jcfg)
        assert lm.count_params(tcfg, True) == jlm.count_params(jcfg, True)


def test_init_draws_a_large_leaf_in_chunks(monkeypatch):
    """A leaf past ``lm.INIT_WHOLE_MAX`` elements is drawn ``INIT_CHUNK``
    elements at a time into its leaf: the stacked expert leaves of the
    three-layer form with the limits cut to 2**14 and 2**12 elements.  The
    leaf keeps its shape and dtype, every chunk is drawn (no zero left,
    no two chunks alike) at 1/sqrt(fan_in) (1/sqrt(2 fan_in) for w_out);
    a leaf under the limit draws what it drew before."""
    cfg = dataclasses.replace(_cfgs("three", "bfloat16")[1],
                              moe=dataclasses.replace(
                                  _cfgs("three")[1].moe, num_experts=16))
    gen = torch.Generator()
    gen.manual_seed(0)
    whole = lm.init(cfg, gen, device="cpu")
    monkeypatch.setattr(lm, "INIT_WHOLE_MAX", 2 ** 14)
    monkeypatch.setattr(lm, "INIT_CHUNK", 2 ** 12)
    gen.manual_seed(0)
    chunked = lm.init(cfg, gen, device="cpu")
    moe_p = chunked["run01_mla_moe"]["moe"]
    for name, fan_in, scale in (("w_in", 64, 1.0), ("w_out", 64, 0.5)):
        leaf = moe_p[name]
        want = lm.abstract_params(cfg)["run01_mla_moe"]["moe"][name]
        assert leaf.shape == want.shape and leaf.dtype == torch.bfloat16
        assert leaf.numel() > 2 ** 14
        flat = leaf.float().reshape(-1)
        assert bool((flat != 0).all())
        chunks = flat.split(2 ** 12)
        assert len({tuple(c[:8].tolist()) for c in chunks}) == len(chunks)
        std = float(flat.std())
        assert abs(std * (fan_in ** 0.5) / scale ** 0.5 - 1) < 0.02, std
        assert abs(float(flat.mean())) < 0.02 * std
    small = chunked["run00_mla"]["attn"]["w_q_a"]
    assert small.numel() <= 2 ** 14
    assert torch.equal(whole["embed"]["embedding"],
                       chunked["embed"]["embedding"])


def _abstract_full():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    return (jax.eval_shape(lambda: jlm.init(jc, jax.random.PRNGKey(0))),
            lm.abstract_params(tc))


def _plan_rows(plan):
    return [(r["members"], r["schedule"], r["vmem_cap"],
             r["predicted_speedup_pct"], r["measured_speedup_pct"])
            for r in plan.summary()]


def test_full_width_update_plan_matches_reference():
    """At full width (abstract params, 60 layers) the largest eight leaves
    and the plan are the reference's: the stacked 4-D and 5-D MoE and MLA
    leaves get no dW op; the embedding and the head (102400 x 5120) do."""
    ja, ta = _abstract_full()
    jgraph, jlayout = jtl.update_graph(ja, tokens=8192)
    tgraph, tlayout = tl.update_graph(ta, tokens=8192)
    assert [(g.op.name, g.deps) for g in tgraph] == \
        [(g.op.name, g.deps) for g in jgraph]
    assert [n for n, *_ in tlayout] == [n for n, *_ in jlayout]
    assert _plan_rows(tl.plan_update_fusion(ta, tokens=8192)) == \
        _plan_rows(jtl.plan_update_fusion(ja, tokens=8192))
    dws = [g.op.name for g in tgraph if g.op.name.startswith("dW_")]
    assert dws == ["dW_embed____embedding", "dW_head____w"]
    expert = [p for _n, p, *_ in tlayout if p[-1] == "w_in" and "moe" in p]
    assert expert and lm.abstract_params(get_config(ARCH))[
        "run01_mla_moe"]["moe"]["w_in"].ndim == 4


@pytest.mark.parametrize("form", FORMS)
def test_update_program_matches_reference(form):
    """The executed update program over every leaf (the stacked MoE and
    MLA leaves, the fp32 norm scales and router included) is the
    reference's, launch for launch."""
    jcfg, tcfg = _cfgs(form)
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(tcfg)
    jprog, tprog = jtl.build_update_program(ja), tl.build_update_program(ta)
    assert tprog.describe() == jprog.describe()
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
